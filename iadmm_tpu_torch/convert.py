"""Parameters of the JAX package as PyTorch tensors.

The JAX package keeps each cell's parameters as a dict of arrays; the port
uses the same keys and shapes, so conversion is a copy per key.  The key
set is the cell's own (:data:`iadmm_tpu_torch.solvers.step.CELL_REGISTRY`):
``W U b W_h b_h rho alpha`` for ``lstm`` and ``indirect_lstm``, the same
with 3h gates for ``gru``, no ``alpha`` for ``safeguard_lstm``, no
schedules for ``multi_layer_lstm``, and ``lr rho alpha`` for ``gd``, whose
``lr`` is 0-d.  The argument is a dict of numpy arrays (``{k:
np.asarray(v)}`` of a JAX parameter dict), so this module needs no JAX.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _registry_keys() -> Dict[str, Tuple[str, ...]]:
    """Each registered cell's parameter keys, as its init makes them (a
    tiny init on the CPU, once, when this module is imported)."""
    from .solvers.step import CELL_REGISTRY
    return {name: tuple(spec.init(torch.Generator().manual_seed(0), 2, 1, 1,
                                  device="cpu"))
            for name, spec in CELL_REGISTRY.items()}


_KEYS = _registry_keys()


def param_keys(model_name: str = "lstm") -> Tuple[str, ...]:
    """The parameter keys of a cell, as its registry init makes them."""
    key = model_name.lower()
    if key not in _KEYS:
        raise ValueError(f"unknown solver cell {model_name!r}; "
                         f"available: {sorted(_KEYS)}")
    return _KEYS[key]


def params_from_jax(np_params: Dict[str, np.ndarray], device="cuda",
                    dtype=torch.float32,
                    model_name: str = "lstm") -> Dict[str, torch.Tensor]:
    """Copy the parameter arrays of cell ``model_name`` to ``device`` as
    ``dtype``; a 0-d array stays 0-d.  Raises ``KeyError`` unless the
    dict holds exactly the cell's keys."""
    keys = param_keys(model_name)
    missing = [k for k in keys if k not in np_params]
    extra = sorted(set(np_params) - set(keys))
    if missing or extra:
        raise KeyError(f"a {model_name!r} parameter dict holds {keys}; "
                       f"this one lacks {missing} and has extra {extra}")
    return {k: torch.as_tensor(np.array(np_params[k]), dtype=dtype,
                               device=device)
            for k in keys}
