"""The port's training kernels (``kernels/train_rollout.py``) on the CPU.

The plain pair (:func:`train_fwd_plain`, :func:`train_bwd_plain`), reached
through ``make_fused_chunk_loss`` on CPU tensors, is held against the JAX
package's ``make_fused_chunk_loss(interpret=True, stream=True)`` on the
same numpy-made inputs, with the JAX package's own tolerances
(tests/test_train_rollout.py): loss rtol 1e-5; final state rtol 2e-4,
atol 2e-5; gradients per leaf, normalised by the leaf's max, atol 5e-5
(float32) and 2e-2 (bfloat16).  The hand-derived backward is also held
against torch.autograd of the plain forward in float64 to 1e-10, which
checks it without JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iadmm_tpu import types as jtypes
from iadmm_tpu.kernels.train_rollout import (
    make_fused_chunk_loss as j_make_fused)

from iadmm_tpu_torch import types as ttypes
from iadmm_tpu_torch.kernels import train_rollout as ttr
from iadmm_tpu_torch.solvers.step import rho_vector

from torch_bridge import to_numpy

B, N, M, H = 2, 8, 8, 16
J, OUTER_T, K_TOTAL, SIGMA = 4, 8, 8, 1e-3
KEYS = ("W", "U", "b", "W_h", "b_h", "rho", "alpha")


def make_inputs(seed=0, B=B, n=N, m=M, h=H, K=K_TOTAL):
    """numpy arrays: a QP batch (half the rows equalities), LSTM parameters
    with gates of order 1, and a non-zero start state."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(f)

    Mx = normal(B, n, n)
    Q = (np.einsum("bij,bkj->bik", Mx, Mx) / n + np.eye(n)).astype(f)
    A0 = normal(B, m, n, scale=1 / np.sqrt(n))
    p = normal(B, n)
    zl = (-np.abs(normal(B, m)) - 0.5).astype(f)
    zu = (np.abs(normal(B, m)) + 0.5).astype(f)
    eq = np.broadcast_to(np.arange(m) < m // 2, (B, m))
    beq = normal(B, m, scale=0.3)
    zl, zu = np.where(eq, beq, zl), np.where(eq, beq, zu)
    data = dict(Q=Q, p=p, A0=A0, zl=zl, zu=zu, eq_mask=eq.copy())
    params = dict(W=normal(2, 4 * h, scale=0.3), U=normal(h, 4 * h, scale=0.2),
                  b=normal(4 * h, scale=0.1), W_h=normal(h, 1, scale=0.2),
                  b_h=normal(1, scale=0.1), rho=normal(K), alpha=normal(K))
    state = dict(x=normal(B, n, scale=0.1), y=normal(B, m, scale=0.1),
                 z=normal(B, m, scale=0.1), xv=normal(B, n + m, scale=0.1),
                 H=normal(B, n + m, h, scale=0.3),
                 C=normal(B, n + m, h, scale=0.3))
    return data, params, state


def jax_side(data, params, state, t0, dtype, chunk=J, **route):
    """The JAX package's fused chunk loss in interpret mode: the stream
    pair, or the route ``route`` names (``stream``, ``seg``)."""
    import jax
    fused = j_make_fused(num_var=N, num_constr=M, batch=B, hidden=H,
                         sigma=SIGMA, chunk_len=chunk, outer_T=OUTER_T,
                         K_total=K_TOTAL, interpret=True,
                         compute_dtype=dtype, **(route or dict(stream=True)))
    jd = jtypes.QPBatch(**{k: jnp.asarray(v) for k, v in data.items()})
    js = jtypes.IterState(**{k: jnp.asarray(v) for k, v in state.items()})
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    (loss, st), g = jax.value_and_grad(
        lambda p: fused(p, js, jd, jnp.asarray(t0, jnp.int32)),
        has_aux=True)(jp)
    return float(loss), st, g


def torch_side(data, params, state, t0, dtype, chunk=J, wd=torch.float32,
               **route):
    td = ttypes.QPBatch(**{k: torch.as_tensor(v) if k == "eq_mask"
                           else torch.as_tensor(v, dtype=wd)
                           for k, v in data.items()})
    ts = ttypes.IterState(**{k: torch.as_tensor(v, dtype=wd)
                             for k, v in state.items()})
    tp = {k: torch.as_tensor(v, dtype=wd).requires_grad_(True)
          for k, v in params.items()}
    fused = ttr.make_fused_chunk_loss(
        num_var=N, num_constr=M, batch=B, hidden=H, sigma=SIGMA,
        chunk_len=chunk, outer_T=OUTER_T, K_total=K_TOTAL,
        compute_dtype=dtype, **route)
    loss, st = fused(tp, ts, td, t0)
    loss.backward()
    return loss, st, {k: v.grad for k, v in tp.items()}


@pytest.mark.parametrize("t0", [0, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_pair_matches_jax_stream_kernels(t0, dtype):
    data, params, state = make_inputs(seed=t0)
    jl, jst, jg = jax_side(data, params, state, t0, dtype)
    tl, tst, tg = torch_side(data, params, state, t0, dtype)
    assert np.isfinite(float(tl.detach()))
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=1e-5)
    for f in ("x", "y", "z", "xv", "H", "C"):
        np.testing.assert_allclose(to_numpy(getattr(tst, f)),
                                   np.asarray(getattr(jst, f)), rtol=2e-4,
                                   atol=2e-5, err_msg=f"state.{f}")
    atol = 5e-5 if dtype == "float32" else 2e-2
    for k in KEYS:
        a, b = to_numpy(tg[k]), np.asarray(jg[k])
        assert a.shape == b.shape, k
        denom = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / denom, b / denom, rtol=0, atol=atol,
                                   err_msg=f"grad[{k}]")


def _tensors(data, params, state, wd):
    weights = tuple(torch.as_tensor(params[k], dtype=wd) for k in KEYS)
    st = tuple(torch.as_tensor(state[k], dtype=wd)
               for k in ("x", "y", "z", "xv", "H", "C"))
    eq = torch.as_tensor(data["eq_mask"])
    dd = tuple(torch.as_tensor(data[k], dtype=wd)
               for k in ("Q", "A0", "p", "zl", "zu")) + (
        rho_vector(1.0, eq).to(wd),)
    return weights, st, dd


@pytest.mark.parametrize("t0", [0, 4])
def test_hand_derived_backward_matches_autograd_f64(t0):
    """train_bwd_plain is the exact adjoint of train_fwd_plain: float64,
    compute_dtype float32 (no rounding), every parameter and the start
    state, with non-zero cotangents on the losses and the final state."""
    f64 = torch.float64
    data, params, state = make_inputs(seed=10 + t0)
    weights, st, dd = _tensors(data, params, state, f64)
    weights = tuple(w.requires_grad_(True) for w in weights)
    st = tuple(s.requires_grad_(True) for s in st)
    kw = dict(t0=t0, J=J, sigma=SIGMA, compute_dtype="float32")
    pr, dr, final, streams = ttr.train_fwd_plain(weights, st, dd, **kw)
    g = torch.Generator().manual_seed(t0)
    dpr = torch.rand(pr.shape, generator=g, dtype=f64)
    ddr = torch.rand(dr.shape, generator=g, dtype=f64)
    dfinal = tuple(0.1 * torch.randn(f.shape, generator=g, dtype=f64)
                   for f in final)
    outs = (pr, dr) + tuple(final)
    auto = torch.autograd.grad(outs, weights + st, (dpr, ddr) + dfinal)
    (dW, dU, db, dWh, dbh, drho, dalpha), dstate = ttr.train_bwd_plain(
        tuple(w.detach() for w in weights), dd,
        tuple(s.detach() for s in streams), dfinal, dpr, ddr, **kw)
    full = []
    for k, gr in zip(("rho", "alpha"), (drho, dalpha)):
        z = torch.zeros(K_TOTAL, dtype=f64)
        z[t0:t0 + J] = gr
        full.append(z)
    mine = (dW, dU, db, dWh, dbh, *full) + tuple(dstate)
    names = KEYS + ("x", "y", "z", "xv", "H", "C")
    for name, a, b in zip(names, mine, auto):
        torch.testing.assert_close(a.reshape(b.shape), b, rtol=1e-10,
                                   atol=1e-10, msg=f"d{name}")


def test_rho_alpha_grads_land_at_t0():
    data, params, state = make_inputs(seed=3)
    t0 = 4
    _, _, g = torch_side(data, params, state, t0, "bfloat16", chunk=2)
    for k in ("rho", "alpha"):
        v = g[k].numpy()
        assert v.shape == (K_TOTAL,)
        assert np.all(v[:t0] == 0) and np.all(v[t0 + 2:] == 0)
        assert np.any(v[t0:t0 + 2] != 0)


def test_unported_routes_raise(monkeypatch):
    """Only data parallelism (``mesh``) is left unported: an explicit
    ``seg``, ``stream=False`` and streams over the budget take the segment
    route."""
    kw = dict(num_var=N, num_constr=M, batch=B, hidden=H, sigma=SIGMA,
              chunk_len=J, outer_T=OUTER_T, K_total=K_TOTAL)
    auto = ttr.make_fused_chunk_loss(**kw)
    assert auto.stream and auto.segment_len == J
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttr.make_fused_chunk_loss(**kw, mesh=object())
    for opt, seg_len in ((dict(seg=2), 2), (dict(stream=False), J)):
        fn = ttr.make_fused_chunk_loss(**kw, **opt)
        assert (fn.stream, fn.segment_len) == (False, seg_len)
    monkeypatch.setenv("IADMM_STREAM_HBM", "1")   # nothing fits
    fn = ttr.make_fused_chunk_loss(**kw)
    assert (fn.stream, fn.segment_len) == (False, J)


def test_cuda_wrappers_check_before_launch():
    """The CUDA wrappers refuse an unknown compute dtype, bad shapes,
    streams of the wrong dtype and loss columns outside the chunk before
    any CUDA call, for both compute dtypes, so this holds on the CPU."""
    data, params, state = make_inputs()
    weights, st, dd = _tensors(data, params, state, torch.float32)
    kw = dict(t0=0, J=J, sigma=SIGMA)
    with pytest.raises(ValueError, match="compute_dtype"):
        ttr.train_fwd_cuda(weights, st, dd, compute_dtype="float16", **kw)
    wrong_hs = {"bfloat16": torch.float32, "float32": torch.bfloat16}
    for cdt, other in wrong_hs.items():
        kwd = dict(kw, compute_dtype=cdt)
        bad = (weights[0][:, :-1],) + weights[1:]
        with pytest.raises(ValueError, match="W"):
            ttr.train_fwd_cuda(bad, st, dd, **kwd)
        with pytest.raises(ValueError, match="rho"):
            ttr.train_fwd_cuda(weights, st, dd, **dict(kwd, t0=6))
        pr, dr, final, streams = ttr.train_fwd_plain(weights, st, dd, **kwd)
        bad = (streams[0], streams[1].to(torch.bfloat16)) + streams[2:]
        with pytest.raises(ValueError, match="cs"):
            ttr.train_bwd_cuda(weights, dd, bad, final, pr, dr, **kwd)
        # the H stream in the other compute dtype's type
        bad = (streams[0].to(other),) + streams[1:]
        with pytest.raises(ValueError, match="hs"):
            ttr.train_bwd_cuda(weights, dd, bad, final, pr, dr, **kwd)
        # the segment pair: loss columns outside the chunk's, accumulators
        # and cotangents of the wrong shape
        with pytest.raises(ValueError, match="columns"):
            ttr.train_fwd_seg_cuda(weights, st, dd, losses=(pr, dr), col=1,
                                   **kwd)
        with pytest.raises(ValueError, match="columns"):
            ttr.train_bwd_seg_cuda(weights, st, dd, final, pr, dr, col=2,
                                   **kwd)
        acc = ttr._zero_grads(H, J + 1, torch.float32, "cpu")
        with pytest.raises(ValueError, match="drho"):
            ttr.train_bwd_seg_cuda(weights, st, dd, final, pr, dr, acc=acc,
                                   **kwd)
        with pytest.raises(ValueError, match="dH"):
            ttr.train_bwd_seg_cuda(weights, st, dd, final[:4] + (
                final[4][:, :-1], final[5]), pr, dr, **kwd)


def test_segment_forward_refuses_a_pending_loss_before_column_0():
    """The segment forward takes a pending loss (the previous segment's
    last, column col − 1) only where there is such a column; refused
    before any CUDA call, so this holds on the CPU."""
    data, params, state = make_inputs()
    weights, st, dd = _tensors(data, params, state, torch.float32)
    losses = tuple(torch.zeros((B, J)) for _ in range(2))
    for cdt in ("bfloat16", "float32"):
        with pytest.raises(ValueError, match="pending"):
            ttr.train_fwd_seg_cuda(weights, st, dd, t0=0, J=2, sigma=SIGMA,
                                   compute_dtype=cdt, losses=losses, col=0,
                                   pending=True)
