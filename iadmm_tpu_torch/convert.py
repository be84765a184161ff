"""Parameters of the JAX package as PyTorch tensors.

The JAX package keeps LSTM parameters as a dict of arrays with keys
``W U b W_h b_h rho alpha``.  The port uses the same keys and shapes, so
conversion is a copy per key.  The argument is a dict of numpy arrays
(``{k: np.asarray(v)}`` of a JAX parameter dict), so this module needs no
JAX.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

PARAM_KEYS = ("W", "U", "b", "W_h", "b_h", "rho", "alpha")


def params_from_jax(np_params: Dict[str, np.ndarray], device="cuda",
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Copy the LSTM parameter arrays to ``device`` as ``dtype``."""
    missing = [k for k in PARAM_KEYS if k not in np_params]
    if missing:
        raise KeyError(f"parameter dict lacks {missing}")
    return {k: torch.as_tensor(np.array(np_params[k]), dtype=dtype,
                               device=device)
            for k in PARAM_KEYS}
