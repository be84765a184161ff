"""K-step learned rollouts.

Counterpart of ``rollout`` and ``unscale_state`` in
``iadmm_tpu/solvers/rollouts.py``; the loop is a Python loop (PyTorch runs
eagerly).  ``chunk_loss`` and the ``eval_rollout``/``eval_stage2`` traces
are not ported yet.
"""

from __future__ import annotations

from typing import Callable

from ..types import IterState, QPBatch, ScalingState

StepFn = Callable  # step(params, t, state, data, sigma) -> IterState


def rollout(step_fn: StepFn, params, state: IterState, data: QPBatch,
            sigma, num_iters: int, t0: int = 0) -> IterState:
    """Roll ``num_iters`` learned steps; returns the final state."""
    for t in range(t0, t0 + num_iters):
        state = step_fn(params, t, state, data, sigma)
    return state


def unscale_state(state: IterState, scaling: ScalingState) -> IterState:
    """Map iterates back to the original space before Stage II."""
    return IterState(x=scaling.unscale_x(state.x),
                     y=scaling.unscale_y(state.y),
                     z=scaling.unscale_z(state.z),
                     xv=state.xv, H=state.H, C=state.C)
