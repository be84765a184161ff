"""PyTorch/CUDA port of ``iadmm_tpu`` for NVIDIA Hopper.

The package mirrors the JAX package's module names.  It imports neither
JAX nor the JAX package.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

from .types import QPBatch, IterState, ScalingState, init_state, make_eq_mask

__all__ = ["QPBatch", "IterState", "ScalingState", "init_state",
           "make_eq_mask"]
