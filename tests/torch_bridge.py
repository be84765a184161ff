"""Moves batches, states and parameters between numpy, JAX and PyTorch.

Shared by the ``test_torch_*.py`` files, which hold the PyTorch port
(``iadmm_tpu_torch``) against the JAX package.  It lives under ``tests/`` so
that the port itself never imports JAX.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from iadmm_tpu import types as jt
from iadmm_tpu_torch import types as tt
from iadmm_tpu_torch.convert import params_from_jax

_TO_TORCH = {jt.QPBatch: tt.QPBatch, jt.IterState: tt.IterState,
             jt.ScalingState: tt.ScalingState}
_TO_JAX = {v: k for k, v in _TO_TORCH.items()}


def to_numpy(a):
    """numpy copy of a JAX array or torch tensor (bf16 widened to f32)."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.to(torch.float32)
        return a.numpy()
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        a = a.astype(np.float32)
    return a


def _map_fields(obj, cls, fn):
    return cls(**{f.name: fn(getattr(obj, f.name))
                  for f in dataclasses.fields(obj)})


def to_torch(obj, device="cpu", dtype=None):
    """A JAX ``QPBatch``/``IterState``/``ScalingState`` or array as torch;
    float leaves are cast to ``dtype`` when given, bool leaves kept."""
    def conv(a):
        if a is None:
            return None
        t = torch.as_tensor(np.array(to_numpy(a)), device=device)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t
    if type(obj) in _TO_TORCH:
        return _map_fields(obj, _TO_TORCH[type(obj)], conv)
    return conv(obj)


def to_jax(obj, dtype=None):
    """A torch ``QPBatch``/``IterState``/``ScalingState`` or tensor as JAX."""
    def conv(a):
        if a is None:
            return None
        a = to_numpy(a)
        if dtype is not None and np.issubdtype(a.dtype, np.floating):
            a = a.astype(dtype)
        return jnp.asarray(a)
    if type(obj) in _TO_JAX:
        return _map_fields(obj, _TO_JAX[type(obj)], conv)
    return conv(obj)


def params_to_torch(jax_params, dtype=torch.float64, device="cpu",
                    model_name="lstm"):
    """JAX parameters of cell ``model_name`` as the port's dict, through
    numpy."""
    return params_from_jax({k: np.asarray(v) for k, v in jax_params.items()},
                           device=device, dtype=dtype, model_name=model_name)


def jax_lstm_params(seed: int, hidden: int, length: int, dtype=jnp.float32):
    from iadmm_tpu.solvers.cells import lstm_init
    return lstm_init(jax.random.PRNGKey(seed), 2, hidden, length, dtype)


def assert_close(a, b, rtol, atol, err_msg=""):
    np.testing.assert_allclose(to_numpy(a), to_numpy(b), rtol=rtol,
                               atol=atol, err_msg=err_msg)
