"""Faults planted under a run's timed path, to see ``correct`` come out
false.  Each is a context manager that patches the port in this process
and restores it.  Serving (``serve``) and training (``train``) each have:

- ``unchanged``: a step that returns its state unchanged (the rollout
  returns the zero state it starts from; the optimizer step moves nothing);
- ``half_batch``: half of the batch left out, the rest standing for it (the
  rollout's first half copied over the second; the chunk loss's mean taken
  over the first half's residuals alone);
- ``altered``: an answer altered where it is produced (one entry of the
  polished x moved by max|x|; one instance's primal residuals doubled).
"""

from __future__ import annotations

import contextlib
import functools

import torch


def _half(t):
    k = t.shape[0] // 2
    return torch.cat([t[:k], t[:k], t[2 * k:]], 0)


@contextlib.contextmanager
def _patch(obj, name, new):
    old = getattr(obj, name)
    setattr(obj, name, new)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _serve(name):
    from iadmm_tpu_torch.kernels import rollout_kernel, stage2_kernel
    real_rollout = rollout_kernel.fused_rollout
    real_stage2 = stage2_kernel.fused_stage2
    if name == "unchanged":
        @functools.wraps(real_rollout)
        def rollout(params, data, **kw):
            x, y, z = real_rollout(params, data, **kw)
            return torch.zeros_like(x), torch.zeros_like(y), torch.zeros_like(z)
        return _patch(rollout_kernel, "fused_rollout", rollout)
    if name == "half_batch":
        @functools.wraps(real_rollout)
        def rollout(params, data, **kw):
            return tuple(_half(t) for t in real_rollout(params, data, **kw))
        return _patch(rollout_kernel, "fused_rollout", rollout)
    if name == "altered":
        def stage2(state, data, rho_vec, **kw):
            st, pr, dr = real_stage2(state, data, rho_vec, **kw)
            x = st.x.clone()
            x[0, 0] += x.abs().max()
            return type(st)(x=x, y=st.y, z=st.z, xv=st.xv, H=st.H,
                            C=st.C), pr, dr
        return _patch(stage2_kernel, "fused_stage2", stage2)
    raise KeyError(name)


def _train(name):
    """On the fused pair's residuals, the output of ``_TrainChunk``, (B,)
    a step."""
    from iadmm_tpu_torch.kernels import train_rollout
    from iadmm_tpu_torch.train import harness
    if name == "unchanged":
        return _patch(harness.ClippedAdam, "step", lambda self: None)
    if name not in ("half_batch", "altered"):
        raise KeyError(name)

    def spoil(pr, dr):
        if name == "half_batch":
            return _half(pr), _half(dr)
        pr = pr.clone()
        pr[0] = 2.0 * pr[0]
        return pr, dr

    real = train_rollout._TrainChunk

    class Faulty:
        @staticmethod
        def apply(*args):
            pr, dr, *rest = real.apply(*args)
            return (*spoil(pr, dr), *rest)

    return _patch(train_rollout, "_TrainChunk", Faulty)


def planted(kind: str, name: str):
    """The fault ``name`` under the traffic kind ``kind`` ('serve_closed' or
    'train_chunks'); 'none' plants nothing."""
    if name == "none":
        return contextlib.nullcontext()
    return (_serve if kind == "serve_closed" else _train)(name)
