"""Checkpoints in the JAX package's pickle format.

Counterpart of ``iadmm_tpu/train/checkpoint.py`` on its ``.pkl`` route: a
pickled dict holding ``params`` (a dict of numpy arrays), ``opt_state``,
and the ``epoch``/``best``/``config`` metadata.  The JAX package's
``load_checkpoint`` reads what this module writes, and this module reads a
``.pkl`` the JAX package writes.

The optimizer state is the port's own (:meth:`harness.ClippedAdam.state_arrays`,
numpy arrays).  A JAX checkpoint's ``opt_state`` holds optax's state
classes; they are read without importing optax or JAX, as tuples of
:class:`ForeignState`, which the harness does not resume from.  Orbax
checkpoint directories are not read.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import torch

_FOREIGN_PACKAGES = ("jax", "jaxlib", "optax", "orbax", "flax", "chex",
                     "iadmm_tpu")


class ForeignState(tuple):
    """Stand-in for a class of the JAX stack found in a pickle (an optax
    state namedtuple): its fields as a plain tuple."""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)


def _foreign_class(module: str, name: str):
    return type(name, (ForeignState,), {"__module__": module})


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _FOREIGN_PACKAGES:
            return _foreign_class(module, name)
        return super().find_class(module, name)


def to_numpy(tree):
    """Tensors of a nested dict/list/tuple as numpy arrays (bf16 widened)."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, ForeignState):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    """Pickle ``payload`` ({'params', 'opt_state', 'epoch', 'best',
    'config'}) to ``path`` with every tensor as a numpy array.  The file is
    written under a temporary name and renamed."""
    if not path.endswith(".pkl"):
        raise ValueError(f"{path}: the port writes .pkl checkpoints only")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(to_numpy(dict(payload)), f)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The dict a ``.pkl`` checkpoint holds (either package's)."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is an Orbax checkpoint directory; the "
                         f"port reads only .pkl checkpoints")
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def checkpoint_path(save_dir: str, model_name: str, run_name: str) -> str:
    """``<save_dir>/<model_name>/params/<run_name>.pkl``, the JAX package's
    pickle path."""
    return os.path.join(save_dir, model_name, "params", run_name + ".pkl")


def latest_path(path: str) -> str:
    """The ``_latest`` sibling of a checkpoint path, keeping ``.pkl``."""
    return os.path.splitext(path)[0] + "_latest.pkl"

