"""The port's tile-sparse (BSR) route against the JAX package, on the CPU.

Host tiling (equal arrays), the BSR matvec's plain version against the
Pallas kernel in interpret mode (rtol 1e-5, atol 1e-5·max|ref|) and its
gradient against ``jax.grad``, the sparse learned step, evaluation rollout
and chunk loss with its gradient (rtol 1e-4, atol 1e-5, the tolerance of
``tests/test_sparse.py``), chunk updates against the JAX harness, the sparse
train cache and ``train()`` on the BSR route.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iadmm_tpu as jit_
from iadmm_tpu.kernels import sparse as jsp
from iadmm_tpu.kernels import sparse_matvec as jsm
from iadmm_tpu.problems import generators as jgen, io as jio
from iadmm_tpu.scaling import scale_batch as jscale
from iadmm_tpu.train import harness as jharness

from iadmm_tpu_torch import config as tconfig
from iadmm_tpu_torch.kernels import sparse as tsp
from iadmm_tpu_torch.kernels import sparse_matvec as tsm
from iadmm_tpu_torch.problems import io as tio
from iadmm_tpu_torch.scaling import scale_batch as tscale
from iadmm_tpu_torch.solvers import step as tstep
from iadmm_tpu_torch.train import harness as tharness
from iadmm_tpu_torch.train import preload as tpre

from torch_bridge import (assert_close, jax_lstm_params, params_to_torch,
                          to_torch)

RTOL, ATOL = 1e-4, 1e-5   # tests/test_sparse.py:103-105


def _banded(rng, B, m, n, w):
    rows = (np.arange(m) * n) // m
    mask = np.abs(rows[:, None] - np.arange(n)[None, :]) <= w
    return (rng.standard_normal((B, m, n)) * mask).astype(np.float32)


def _block_sparse(rng, B, m, n, tile=16, frac=0.3):
    M = np.zeros((B, m, n), np.float32)
    for b in range(B):
        mask = rng.random((m // tile, n // tile)) < frac
        for r, c in zip(*np.nonzero(mask)):
            M[b, r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] = \
                rng.standard_normal((tile, tile))
    return M


def _ragged(rng, B, m, n):
    return (rng.standard_normal((B, m, n))
            * (rng.random((B, m, n)) < 0.1)).astype(np.float32)


MATRICES = {
    "banded": lambda rng: _banded(rng, 3, 200, 300, 9),
    "block": lambda rng: _block_sparse(rng, 3, 96, 160),
    "ragged": lambda rng: _ragged(rng, 2, 37, 141),
}


# ------------------------------------------------------------ host tiling

@pytest.mark.parametrize("kind", sorted(MATRICES))
@pytest.mark.parametrize("tile", [(8, 128), (16, 32)])
def test_host_tiling_matches_jax(kind, tile):
    M = MATRICES[kind](np.random.default_rng(0))
    jv, jc = jsm.bsr_tiles_host(M, tile)
    tv, tc = tsm.bsr_tiles_host(M, tile)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc)
    K = jv.shape[2] + 3
    for a, b in zip(tsm.bsr_pad_k(tv, tc, K), jsm.bsr_pad_k(jv, jc, K)):
        np.testing.assert_array_equal(a, b)
    jb = jsm.bsr_from_dense(M, tile, min_k=2)
    tb = tsm.bsr_from_dense(M, tile, min_k=2, device="cpu")
    np.testing.assert_array_equal(tb.vals.numpy(), np.asarray(jb.vals))
    np.testing.assert_array_equal(tb.cols.numpy(), np.asarray(jb.cols))
    assert tb.shape == jb.shape and tb.occupancy == jb.occupancy


def test_bsr_matrix_rejects_bad_indices_and_kernel_shapes():
    M = _banded(np.random.default_rng(1), 2, 40, 300, 4)
    b = tsm.bsr_from_dense(M, (8, 128), device="cpu")
    bad = b.cols.clone()
    bad[0, 0, 0] = 3   # ceil(300 / 128) = 3 column tiles: 3 is past the end
    with pytest.raises(ValueError, match="column-tile index"):
        tsm.BSRMatrix(b.vals, bad, b.shape)
    with pytest.raises(TypeError, match="int32"):
        tsm.BSRMatrix(b.vals, b.cols.long(), b.shape)
    v = torch.zeros((2, 300))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsm.bsr_matvec_cuda(b, v)
    odd = tsm.bsr_from_dense(M, (16, 32), device="cpu")
    with pytest.raises(ValueError, match="TM in"):
        tsm.check_kernel_shapes(odd, v)
    before = tsm.bsr_matvec.launches
    tsm.bsr_matvec(b, v)   # CPU tensor: the plain version, no launch
    assert tsm.bsr_matvec.launches == before


# ------------------------------------------------------------- the matvec

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("tm", [8, 128])
@pytest.mark.parametrize("kind", ["banded", "ragged"])
def test_bsr_matvec_plain_matches_jax_kernel(dtype, tm, kind):
    rng = np.random.default_rng(2)
    M = MATRICES[kind](rng)
    v = rng.standard_normal((M.shape[0], M.shape[2])).astype(np.float32)
    jb = jsm.bsr_from_dense(M, (tm, 128), getattr(jnp, dtype))
    tb = tsm.bsr_from_dense(M, (tm, 128), getattr(torch, dtype),
                            device="cpu")
    ref = np.asarray(jsm.bsr_matvec(jb, jnp.asarray(v), interpret=True))
    out = tsm.bsr_matvec(tb, torch.as_tensor(v))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert_close(out, ref, 1e-5, 1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bsr_matvec_ad_gradient_matches_jax(dtype):
    rng = np.random.default_rng(3)
    M = _banded(rng, 2, 200, 300, 9)
    v = rng.standard_normal((2, 300)).astype(np.float32)
    w = rng.standard_normal((2, 200)).astype(np.float32)
    jM, jMT = jsm.bsr_pair_from_dense(M, (8, 128), getattr(jnp, dtype))

    def f(vv):
        return (jnp.asarray(w) * jsm.bsr_matvec_ad(jM, jMT, vv, True)).sum()

    jg = np.asarray(jax.grad(f)(jnp.asarray(v)))
    tM, tMT = tsm.bsr_pair_from_dense(M, (8, 128), getattr(torch, dtype),
                                      device="cpu")
    tv = torch.as_tensor(v).requires_grad_(True)
    (torch.as_tensor(w) * tsm.bsr_matvec_ad(tM, tMT, tv)).sum().backward()
    assert_close(tv.grad, jg, 1e-5, 1e-5 * np.abs(jg).max())


# --------------------------------------------------- step, rollout, loss

def _problem(prob_type="Sparse_QP", B=2, n=24, mi=12, h=8, K=4, seed=5,
             scaled=True):
    ds = jgen.generate(prob_type, num_var=n, num_ineq=mi, data_size=B,
                       seed=seed, bandwidth=3)
    jdata = jio.to_qp_batch(ds)
    jsc = None
    if scaled:
        jscaled, jsc = jscale(jdata)
    else:
        jscaled = jdata
    jp = jax_lstm_params(seed, h, K)
    jp = {k: (v * 20 if k == "U" else v) for k, v in jp.items()}
    return ds, jdata, jscaled, jsc, jp


def _both_bsr(jscaled, dtype="float32"):
    jb = jsp.from_dense(jscaled, fmt="bsr", tile=(8, 128),
                        dtype=getattr(jnp, dtype), interpret=True)
    tb = tsp.from_dense(to_torch(jscaled), fmt="bsr", tile=(8, 128),
                        dtype=getattr(torch, dtype))
    return jb, tb


@pytest.mark.parametrize("prob_type", ["Sparse_QP", "Random_QP"])
def test_sparse_lstm_step_matches_jax(prob_type):
    _, _, jscaled, _, jp = _problem(prob_type)
    jb, tb = _both_bsr(jscaled)
    assert (tb.num_var, tb.num_constr) == (jb.num_var, jb.num_constr)
    tp = params_to_torch(jp, dtype=torch.float32)
    jst = jit_.init_state(2, jb.num_var, jb.num_constr, 8)
    tst = to_torch(jst)
    sigma = 6e-6
    for t in range(3):
        jst = jsp.sparse_lstm_step(jp, t, jst, jb, jnp.float32(sigma))
        tst = tsp.sparse_lstm_step(tp, t, tst, tb, sigma)
        for f in ("x", "y", "z", "xv", "H", "C"):
            assert_close(getattr(tst, f), getattr(jst, f), RTOL, ATOL,
                         f"{f} t={t}")
        tst = to_torch(jst)   # the next step from the same state


def test_eval_rollout_sparse_matches_jax():
    _, jdata, jscaled, jsc, jp = _problem(K=5)
    jb, tb = _both_bsr(jscaled)
    tp = params_to_torch(jp, dtype=torch.float32)
    jst0 = jit_.init_state(2, jb.num_var, jb.num_constr, 8)
    jfin, jtr = jsp.eval_rollout_sparse(jp, jst0, jb, jdata, jsc,
                                        jnp.float32(6e-6), 5)
    tfin, ttr = tsp.eval_rollout_sparse(tp, to_torch(jst0), tb,
                                        to_torch(jdata), to_torch(jsc),
                                        6e-6, 5)
    for f in ("obj", "primal_res", "dual_res", "ls_res"):
        assert_close(getattr(ttr, f), getattr(jtr, f), RTOL, ATOL, f)
    assert set(ttr.violations) == set(jtr.violations)
    for k in jtr.violations:
        assert_close(ttr.violations[k], jtr.violations[k], RTOL, ATOL, k)
    assert_close(tfin.x, jfin.x, RTOL, ATOL, "final x")


@pytest.mark.parametrize("remat", [False, True])
def test_chunk_loss_sparse_and_gradient_match_jax(remat):
    _, _, jscaled, _, jp = _problem(K=6)
    jb, tb = _both_bsr(jscaled, "bfloat16")
    jst = jit_.init_state(2, jb.num_var, jb.num_constr, 8)
    t0, chunk, outer_T, sigma = 2, 3, 6, 6e-6

    def jloss(p):
        return jsp.chunk_loss_sparse(p, jst, jb, jnp.float32(sigma), chunk,
                                     outer_T, t0)

    (jl, jfin), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = {k: v.requires_grad_(True)
          for k, v in params_to_torch(jp, dtype=torch.float32).items()}
    tl, tfin = tsp.chunk_loss_sparse(tp, to_torch(jst), tb, sigma, chunk,
                                     outer_T, t0, remat=remat)
    tl.backward()
    assert_close(tl.detach(), jl, RTOL, 0, "loss")
    assert_close(tfin.x, jfin.x, RTOL, ATOL, "final x")
    for k in jg:
        g = np.asarray(jg[k])
        assert_close(tp[k].grad, g, 1e-4, 1e-4 * np.abs(g).max(), k)


def test_sparse_chunk_updates_match_jax_harness():
    """Two chunk updates (t0 = 0, 3) with the sparse loss from the same
    params: the port's make_train_chunk against the JAX harness's.  Params
    to 5% of one Adam step (see test_torch_train.py's fused-update test)."""
    _, _, jscaled, _, jp = _problem(K=6)
    jb, tb = _both_bsr(jscaled, "bfloat16")
    chunk, outer_T, sigma, lr = 3, 6, 6e-6, 1e-3
    jopt = jharness.make_optimizer(lr)
    jchunk = jharness.make_train_chunk(
        None, jopt, outer_T, chunk, sigma,
        loss_fn=jsp.make_sparse_chunk_loss(sigma, chunk, outer_T))
    tp = {k: v.requires_grad_(True)
          for k, v in params_to_torch(jp, dtype=torch.float32).items()}
    tchunk = tharness.make_train_chunk(
        None, tharness.make_optimizer(tp, lr), outer_T, chunk, sigma,
        loss_fn=tsp.make_sparse_chunk_loss(sigma, chunk, outer_T))
    jparams, jstate = dict(jp), jopt.init(jp)
    jst = jit_.init_state(2, jb.num_var, jb.num_constr, 8)
    tst = to_torch(jst)
    for t0 in (0, chunk):
        jparams, jstate, jst, jl = jchunk(jparams, jstate, jst, jb,
                                          jnp.asarray(t0, jnp.int32))
        tst, tl = tchunk(tp, tst, tb, t0)
        assert_close(tl, jl, 1e-5, 1e-7, f"loss t0={t0}")
        for k in jparams:
            assert_close(tp[k].detach(), jparams[k], 0, 5e-2 * lr,
                         f"{k} t0={t0}")
        assert_close(tst.x, jst.x, 2e-4, 2e-5, f"state t0={t0}")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsp.make_sparse_chunk_loss(sigma, chunk, outer_T, mesh=object())


def test_from_dense_bcoo_raises():
    """The BCOO format is ported (tests/test_torch_bcoo.py holds it); an
    unknown format still raises."""
    _, _, jscaled, _, _ = _problem()
    assert isinstance(tsp.from_dense(to_torch(jscaled), fmt="bcoo"),
                      tsp.SparseQPBatch)
    with pytest.raises(ValueError, match="unknown"):
        tsp.from_dense(to_torch(jscaled), fmt="csr")


# ------------------------------------------------- cache, config, train

def _train_cfg(tmp_path, **kw):
    base = dict(prob_type="Sparse_QP", num_var=24, num_ineq=12,
                data_size=10, hidden_dim=8, outer_T=4, truncated_length=2,
                batch_size=2, lr=5e-3, num_epoch=2, val_frac=0.2,
                test_frac=0.0, eq_tol=1e9, scaling=True, sparse=True,
                sparse_format="bsr", matvec_mode="bf16",
                save_dir=str(tmp_path))
    base.update(kw)
    return tconfig.ExperimentConfig(**base)


def test_sparse_cache_pads_to_one_shape_and_matches_per_batch(tmp_path):
    ds = jgen.generate("Sparse_QP", num_var=300, num_ineq=40, data_size=6,
                       seed=2, bandwidth=2)
    cfg = _train_cfg(tmp_path, num_var=300, num_ineq=40, data_size=6)
    ids = np.arange(6)
    cache = tpre.preload_sparse_cache(ds, ids, 3, 2, cfg, tscale,
                                      device="cpu")
    Ks = {tuple(op.cols.shape[2] for op in (b.Q, b.A0, b.A0T))
          for b, _ in cache}
    assert len(Ks) == 1
    assert tpre.sparse_cache_bytes(cache) > 0
    for bi, (b, cost) in enumerate(cache):
        data, sc = tscale(tio.to_qp_batch(ds, ids[2 * bi:2 * bi + 2],
                                          device="cpu"))
        ref = tsp.from_dense(data, fmt="bsr", dtype=torch.bfloat16)
        assert b.Q.vals.dtype == torch.bfloat16
        assert torch.equal(cost, sc.cost)
        g = torch.Generator().manual_seed(bi)
        for op, width in (("Qv", 300), ("Av", 300), ("ATv", 40)):
            v = torch.randn((2, width), generator=g)
            assert torch.equal(getattr(b, op)(v), getattr(ref, op)(v))
    bcoo = tpre.preload_sparse_cache(
        ds, ids, 3, 2, dataclasses.replace(cfg, sparse_format="bcoo"),
        tscale, device="cpu")
    assert len({(b.Q.nse, b.A0.nse) for b, _ in bcoo}) == 1
    with pytest.raises(ValueError, match="unknown"):
        tpre.preload_sparse_cache(
            ds, ids, 3, 2, dataclasses.replace(cfg, sparse_format="csr"),
            tscale, device="cpu")


def test_check_ported_sparse_formats_and_theory():
    """Both sparse formats and the theory traces are ported; the mesh
    routes are not."""
    for kw in (dict(sparse=True, sparse_format="bsr"), dict(sparse=True),
               dict(sparse=True, sparse_format="bcoo"), dict(theory=True),
               dict(model_name="gru", inner_T=7)):
        tconfig.ExperimentConfig(**kw).check_ported()
    for kw in (dict(num_devices=2, sparse=True), dict(model_devices=2,
                                                      theory=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tconfig.ExperimentConfig(**kw).check_ported()


@pytest.mark.parametrize("preload", ["auto", "never"])
def test_train_on_the_bsr_route(tmp_path, preload):
    ds = jgen.generate("Sparse_QP", num_var=24, num_ineq=12, data_size=10,
                       seed=3, bandwidth=3)
    cfg = _train_cfg(tmp_path, preload=preload)
    p0 = tharness.get_cell("lstm").init(torch.Generator().manual_seed(17),
                                        2, 8, 4, device="cpu")
    res = tharness.train(cfg, ds, verbose=False, device="cpu")
    losses = [h["train_loss"] for h in res.history]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(np.isfinite(h["train_obj"]) for h in res.history)
    assert max(float((res.params[k] - p0[k]).abs().max()) for k in p0) > 0
    with pytest.raises(ValueError, match="fused"):
        tharness.train(dataclasses.replace(cfg, train_backend="fused"), ds,
                       verbose=False, device="cpu")


def test_train_epoch_matches_jax_harness_on_the_bsr_route(tmp_path,
                                                         monkeypatch):
    """One epoch of the JAX harness and of the port from the same initial
    params (the JAX initialiser's, swapped into the port's ``init``): the
    final params agree to 5% of one Adam step per element."""
    ds = jgen.generate("Sparse_QP", num_var=24, num_ineq=12, data_size=10,
                       seed=3, bandwidth=3)
    kw = dict(prob_type="Sparse_QP", num_var=24, num_ineq=12, data_size=10,
              hidden_dim=8, outer_T=4, truncated_length=2, batch_size=2,
              lr=1e-3, num_epoch=1, val_frac=0.2, test_frac=0.0,
              eq_tol=1e9, scaling=True, sparse=True, sparse_format="bsr",
              matvec_mode="bf16", num_devices=1, spike_rollback_factor=0.0)
    jres = jharness.train(jit_.ExperimentConfig(
        save_dir=str(tmp_path / "j"), **kw), ds, verbose=False)
    jp0 = jax_lstm_params(17, 8, 4)   # the JAX harness's init (seed 17)
    spec = dataclasses.replace(
        tstep.CELL_REGISTRY["lstm"],
        init=lambda *a, device="cpu", **k: params_to_torch(
            jp0, dtype=torch.float32, device=device))
    monkeypatch.setitem(tstep.CELL_REGISTRY, "lstm", spec)
    tres = tharness.train(tconfig.ExperimentConfig(
        save_dir=str(tmp_path / "t"), **kw), ds, verbose=False,
        device="cpu")
    assert_close(tres.history[0]["train_loss"], jres.history[0]["train_loss"],
                 1e-4, 0, "loss")
    for k in jp0:
        assert_close(tres.params[k], jres.params[k], 0, 5e-2 * kw["lr"], k)
