"""K-step learned rollouts.

Counterpart of ``rollout``, ``chunk_loss`` and ``unscale_state`` in
``iadmm_tpu/solvers/rollouts.py``; the loop is a Python loop (PyTorch runs
eagerly).  The ``eval_rollout``/``eval_stage2`` traces are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..evaluation import metrics
from ..types import IterState, QPBatch, ScalingState

StepFn = Callable  # step(params, t, state, data, sigma) -> IterState


def rollout(step_fn: StepFn, params, state: IterState, data: QPBatch,
            sigma, num_iters: int, t0: int = 0) -> IterState:
    """Roll ``num_iters`` learned steps; returns the final state."""
    for t in range(t0, t0 + num_iters):
        state = step_fn(params, t, state, data, sigma)
    return state


def chunk_loss(step_fn: StepFn, params, state: IterState, data: QPBatch,
               sigma, chunk_len: int, outer_T: int, t0: int,
               remat: bool = False) -> Tuple[torch.Tensor, IterState]:
    """TBPTT chunk objective: the sum over the chunk's ``chunk_len`` steps
    of mean_batch(primal + dual residual), over ``outer_T``.

    ``remat=True`` recomputes each step in the backward pass
    (``torch.utils.checkpoint``): activation memory drops from one step's
    worth per step of the chunk to one step's."""
    fields = [f.name for f in dataclasses.fields(IterState)]

    def body(t, *tensors):
        st = step_fn(params, t, IterState(*tensors), data, sigma)
        _, _, loss = metrics.primal_dual_loss(st.x, st.y, st.z, data)
        return (*(getattr(st, f) for f in fields), loss.mean())

    tensors = tuple(getattr(state, f) for f in fields)
    losses = []
    for t in range(int(t0), int(t0) + chunk_len):
        if remat:
            out = checkpoint(body, t, *tensors, use_reentrant=False)
        else:
            out = body(t, *tensors)
        tensors, loss = out[:-1], out[-1]
        losses.append(loss)
    return torch.stack(losses).sum() / outer_T, IterState(*tensors)


def unscale_state(state: IterState, scaling: ScalingState) -> IterState:
    """Map iterates back to the original space before Stage II."""
    return IterState(x=scaling.unscale_x(state.x),
                     y=scaling.unscale_y(state.y),
                     z=scaling.unscale_z(state.z),
                     xv=state.xv, H=state.H, C=state.C)
