"""The port's BCOO sparse route against the JAX package, on the CPU.

``from_dense(fmt='bcoo')`` (nse, entries and their order equal to the JAX
package's ``BCOO.fromdense``), the matvecs ``Qv``/``Av``/``ATv`` and their
VJPs against ``bcoo_dot_general`` with the JAX package's explicit VJP
(float64 to 1e-12; float32 and bf16 values to 1e-6 of max|ref|: the sums
run in another order), two calls bitwise equal, the sparse chunk loss and
its gradients (float64, 1e-9), one BCOO epoch of ``harness.train`` against
the JAX harness, the preloaded BCOO cache bitwise equal to per-batch
conversion with the JAX cache's nse, and ``run_test`` on the BCOO route
against the port's BSR and dense routes at the same cell precision.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse

import iadmm_tpu as jit_
from iadmm_tpu.kernels import sparse as jsp
from iadmm_tpu.problems import generators as jgen, io as jio
from iadmm_tpu.scaling import scale_batch as jscale
from iadmm_tpu.train import harness as jharness

from iadmm_tpu_torch import config as tconfig
from iadmm_tpu_torch.evaluation import driver as tdriver
from iadmm_tpu_torch.kernels import bcoo as tbcoo, sparse as tsp
from iadmm_tpu_torch.problems import io as tio
from iadmm_tpu_torch.scaling import scale_batch as tscale
from iadmm_tpu_torch.solvers import step as tstep
from iadmm_tpu_torch.train import harness as tharness
from iadmm_tpu_torch.train import preload as tpre

from torch_bridge import (assert_close, jax_lstm_params, params_to_torch,
                          to_torch)

F64_TOL = 1e-12          # float64 sums in another order
F32_TOL = 1e-6           # of max|ref|: float32 sums in another order


def _ragged(rng, B, m, n, density):
    return (rng.standard_normal((B, m, n))
            * (rng.random((B, m, n)) < density)).astype(np.float32)


MATRICES = {
    "ragged": lambda rng: _ragged(rng, 3, 37, 141, 0.3),
    "dense": lambda rng: _ragged(rng, 2, 9, 11, 1.0),     # nse = m·n cap
    "empty-row": lambda rng: _ragged(rng, 2, 40, 30, 0.02),
}


def _jax_bcoo(M, nse_pad=1024, floor=0):
    """The JAX package's from_dense BCOO conversion of one operand."""
    data = jit_.QPBatch(Q=jnp.asarray(M[:, :M.shape[2], :]),
                        p=jnp.zeros(M.shape[::2]), A0=jnp.asarray(M),
                        zl=jnp.zeros(M.shape[:2]), zu=jnp.zeros(M.shape[:2]),
                        eq_mask=jnp.zeros(M.shape[:2], bool))
    return jsp.from_dense(data, nse_pad=nse_pad, fmt="bcoo",
                          min_nse=(0, floor)).A0


@pytest.mark.parametrize("kind", sorted(MATRICES))
@pytest.mark.parametrize("nse_pad,floor", [(1024, 0), (7, 0), (7, 3000)])
def test_from_dense_entries_match_jax(kind, nse_pad, floor):
    M = MATRICES[kind](np.random.default_rng(0))
    jm = _jax_bcoo(M, nse_pad, floor)
    tm = tbcoo.bcoo_from_dense(torch.as_tensor(M), nse_pad, floor)
    assert tm.nse == jm.data.shape[1]
    assert tm.shape == tuple(jm.shape[1:])
    np.testing.assert_array_equal(tm.data.numpy(), np.asarray(jm.data))
    np.testing.assert_array_equal(tm.indices.numpy(), np.asarray(jm.indices))
    assert tm.indices.dtype == torch.int32
    assert torch.equal(tm.todense(), torch.as_tensor(M))


def test_from_dense_keeps_the_batch_dtype_as_jax_does():
    """The JAX BCOO branch takes no dtype: a bf16 matvec profile stores the
    float32 values (the BSR branch stores bf16 tiles)."""
    ds = jgen.generate("Sparse_QP", num_var=24, num_ineq=12, data_size=2,
                       seed=1, bandwidth=3)
    jdata, _ = jscale(jio.to_qp_batch(ds))
    jb = jsp.from_dense(jdata, fmt="bcoo", dtype=jnp.bfloat16)
    tb = tsp.from_dense(to_torch(jdata), fmt="bcoo", dtype=torch.bfloat16)
    assert isinstance(tb, tsp.SparseQPBatch)
    assert jb.Q.data.dtype == jnp.float32 and tb.Q.data.dtype == torch.float32
    assert (tb.Q.nse, tb.A0.nse) == (jb.Q.data.shape[1], jb.A0.data.shape[1])
    assert (tb.num_var, tb.num_constr) == (jb.num_var, jb.num_constr)
    with pytest.raises(ValueError, match="unknown"):
        tsp.from_dense(to_torch(jdata), fmt="csr")


@pytest.mark.parametrize("kind", sorted(MATRICES))
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_matvecs_and_vjps_match_jax(kind, dtype):
    rng = np.random.default_rng(1)
    M = MATRICES[kind](rng)
    B, m, n = M.shape
    vec_dt = np.float64 if dtype == "float64" else np.float32
    v = rng.standard_normal((B, n)).astype(vec_dt)
    w = rng.standard_normal((B, m)).astype(vec_dt)
    jm = _jax_bcoo(M.astype(vec_dt))
    jm = jsparse.BCOO((jm.data.astype(getattr(jnp, dtype)), jm.indices),
                      shape=jm.shape)
    tm = tbcoo.bcoo_from_dense(torch.as_tensor(M.astype(vec_dt)))
    tm = tbcoo.BCOOMatrix(tm.data.to(getattr(torch, dtype)), tm.indices,
                          tm.shape)
    tol = F64_TOL if dtype == "float64" else F32_TOL

    def check(t, j, what):
        j = np.array(j)
        assert t.dtype == torch.from_numpy(j).dtype, what
        assert_close(t, j, 0, tol * max(1.0, np.abs(j).max()), what)

    jv, jw = jnp.asarray(v), jnp.asarray(w)
    tv = torch.as_tensor(v).requires_grad_(True)
    tw = torch.as_tensor(w).requires_grad_(True)
    y = tbcoo.bcoo_matvec(tm, tv)
    yt = tbcoo.bcoo_matvec_t(tm, tw)
    check(y.detach(), jsp._bmv(jm, jv), "M v")
    check(yt.detach(), jsp._bmv_t(jm, jw), "Mᵀ w")
    assert torch.equal(y, tbcoo.bcoo_matvec(tm, tv))   # repeats bitwise
    # VJPs: dv = Mᵀ ȳ and dw = M ȳ, the JAX package's custom VJP
    (y * torch.as_tensor(w)).sum().backward()
    (yt * torch.as_tensor(v)).sum().backward()
    check(tv.grad, jax.grad(lambda a: (jsp._bmv(jm, a) * jw).sum())(jv),
          "dv")
    check(tw.grad, jax.grad(lambda a: (jsp._bmv_t(jm, a) * jv).sum())(jw),
          "dw")


# ----------------------------------------------------- step, loss, grads

def _problem(B=2, n=24, mi=12, h=8, K=6, seed=5, dtype=jnp.float64):
    ds = jgen.generate("Sparse_QP", num_var=n, num_ineq=mi, data_size=B,
                       seed=seed, bandwidth=3)
    jdata = jio.to_qp_batch(ds, dtype=dtype)
    jscaled, jsc = jscale(jdata)
    jp = jax_lstm_params(seed, h, K, dtype=dtype)
    jp = {k: (v * 20 if k == "U" else v) for k, v in jp.items()}
    return ds, jdata, jscaled, jsc, jp


def _both_bcoo(jscaled, dtype=torch.float64):
    jb = jsp.from_dense(jscaled, fmt="bcoo")
    tb = tsp.from_dense(to_torch(jscaled, dtype=dtype), fmt="bcoo")
    return jb, tb


def test_batch_matvecs_match_jax():
    _, _, jscaled, _, _ = _problem()
    jb, tb = _both_bcoo(jscaled)
    rng = np.random.default_rng(2)
    v = rng.standard_normal((2, 24))
    w = rng.standard_normal((2, 12))
    for op, x in (("Qv", v), ("Av", v), ("ATv", w)):
        assert_close(getattr(tb, op)(torch.as_tensor(x)),
                     getattr(jb, op)(jnp.asarray(x)), 0, F64_TOL, op)


@pytest.mark.parametrize("remat", [False, True])
def test_chunk_loss_sparse_and_gradients_match_jax_f64(remat):
    _, _, jscaled, _, jp = _problem()
    jb, tb = _both_bcoo(jscaled)
    jst = jit_.init_state(2, jb.num_var, jb.num_constr, 8, dtype=jnp.float64)
    t0, chunk, outer_T, sigma = 2, 3, 6, 6e-6

    def jloss(p):
        return jsp.chunk_loss_sparse(p, jst, jb, sigma, chunk, outer_T, t0)

    (jl, jfin), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = {k: v.requires_grad_(True)
          for k, v in params_to_torch(jp, dtype=torch.float64).items()}
    tl, tfin = tsp.chunk_loss_sparse(tp, to_torch(jst, dtype=torch.float64),
                                     tb, sigma, chunk, outer_T, t0,
                                     remat=remat)
    tl.backward()
    assert_close(tl.detach(), jl, 1e-10, 1e-12, "loss")
    for f in ("x", "y", "z", "xv", "H", "C"):
        assert_close(getattr(tfin, f), getattr(jfin, f), 1e-10, 1e-12, f)
    for k in jg:
        assert_close(tp[k].grad, jg[k], 1e-9, 1e-11, k)


def test_eval_rollout_sparse_matches_jax():
    _, jdata, jscaled, jsc, jp = _problem(K=5, dtype=jnp.float32)
    jb, tb = _both_bcoo(jscaled, torch.float32)
    tp = params_to_torch(jp, dtype=torch.float32)
    jst0 = jit_.init_state(2, jb.num_var, jb.num_constr, 8)
    jfin, jtr = jsp.eval_rollout_sparse(jp, jst0, jb, jdata, jsc,
                                        jnp.float32(6e-6), 5)
    tfin, ttr = tsp.eval_rollout_sparse(tp, to_torch(jst0), tb,
                                        to_torch(jdata), to_torch(jsc),
                                        6e-6, 5)
    for f in ("obj", "primal_res", "dual_res", "ls_res"):
        assert_close(getattr(ttr, f), getattr(jtr, f), 1e-4, 1e-5, f)
    assert_close(tfin.x, jfin.x, 1e-4, 1e-5, "final x")


# ------------------------------------------------- cache, epoch, routes

def _train_kw(**kw):
    base = dict(prob_type="Sparse_QP", num_var=24, num_ineq=12,
                data_size=10, hidden_dim=8, outer_T=4, truncated_length=2,
                batch_size=2, lr=1e-3, num_epoch=1, val_frac=0.2,
                test_frac=0.0, eq_tol=1e9, scaling=True, sparse=True,
                sparse_format="bcoo", matvec_mode="bf16", num_devices=1,
                spike_rollback_factor=0.0)
    base.update(kw)
    return base


def test_cache_is_bitwise_the_per_batch_conversion():
    ds = jgen.generate("Sparse_QP", num_var=300, num_ineq=40, data_size=6,
                       seed=2, bandwidth=2)
    kw = _train_kw(num_var=300, num_ineq=40, data_size=6)
    ids = np.arange(6)
    cache = tpre.preload_sparse_cache(ds, ids, 3, 2,
                                      tconfig.ExperimentConfig(**kw),
                                      tscale, device="cpu")
    jcache = jharness.preload_sparse_cache(
        ds, ids, 3, 2, jit_.ExperimentConfig(**kw),
        jax.jit(partial(jscale, iters=10)))
    assert tpre.sparse_cache_bytes(cache) > 0
    for bi, ((b, cost), (jb, _)) in enumerate(zip(cache, jcache)):
        # one nse per operand over the split, the JAX cache's
        assert (b.Q.nse, b.A0.nse) == (jb.Q.data.shape[1],
                                       jb.A0.data.shape[1])
        data, sc = tscale(tio.to_qp_batch(ds, ids[2 * bi:2 * bi + 2],
                                          device="cpu"))
        ref = tsp.from_dense(data, fmt="bcoo")
        assert torch.equal(cost, sc.cost)
        assert b.Q.data.dtype == torch.float32
        for op in ("Q", "A0"):
            assert torch.equal(getattr(b, op).todense(),
                               getattr(ref, op).todense())
        g = torch.Generator().manual_seed(bi)
        for op, width in (("Qv", 300), ("Av", 300), ("ATv", 40)):
            v = torch.randn((2, width), generator=g)
            assert torch.equal(getattr(b, op)(v), getattr(ref, op)(v)), op


@pytest.mark.parametrize("preload", ["auto", "never"])
def test_train_epoch_matches_jax_harness_on_the_bcoo_route(tmp_path,
                                                           monkeypatch,
                                                           preload):
    """One epoch of the JAX harness and of the port from the same initial
    params: the loss to 1e-4 and the final params to 5% of one Adam step
    per element, as the BSR route's test holds them."""
    ds = jgen.generate("Sparse_QP", num_var=24, num_ineq=12, data_size=10,
                       seed=3, bandwidth=3)
    kw = _train_kw(preload=preload)
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
    assert np.isclose(tres.history[0]["train_obj"],
                      jres.history[0]["train_obj"], rtol=1e-4)
    for k in jp0:
        assert_close(tres.params[k], jres.params[k], 0, 5e-2 * kw["lr"], k)


def test_bcoo_route_matches_bsr_and_dense_routes(tmp_path):
    """Sparse_QP 64/16: ``run_test`` on the BCOO route against the BSR
    route (float32 tiles) and the dense route, all with the plain float32
    cell: every trace to 1e-4 relative, 1e-6 absolute (the three differ
    only in the order of the matvec sums)."""
    ds = jgen.generate("Sparse_QP", num_var=64, num_ineq=16, data_size=8,
                       seed=9, bandwidth=3)
    p = {k: np.asarray(v) for k, v in jax_lstm_params(4, 8, 6).items()}
    kw = dict(prob_type="Sparse_QP", num_var=64, num_ineq=16, data_size=8,
              hidden_dim=8, outer_T=6, test_outer_T=6, test_batch_size=2,
              val_frac=0.25, test_frac=0.5, eq_tol=1e9, scaling=True,
              feas_rest=True, feas_rest_num=5, save_dir=str(tmp_path))
    reps = {name: tdriver.run_test(tconfig.ExperimentConfig(**kw, **route),
                                   ds, p, verbose=False, device="cpu")
            for name, route in (
                ("bcoo", dict(sparse=True)),
                ("bsr", dict(sparse=True, sparse_format="bsr")),
                ("dense", dict()))}
    again = tdriver.run_test(tconfig.ExperimentConfig(sparse=True, **kw), ds,
                             p, verbose=False, device="cpu")
    b = reps["bcoo"]
    assert np.array_equal(b.x_final, again.x_final)   # repeats bitwise
    for other in ("bsr", "dense"):
        o = reps[other]
        for f in ("obj", "primal_res", "dual_res", "ls_res"):
            np.testing.assert_allclose(getattr(b, f), getattr(o, f),
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{other} {f}")
            np.testing.assert_allclose(getattr(b.stage2, f),
                                       getattr(o.stage2, f), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{other} s2 {f}")
        np.testing.assert_allclose(b.x_final, o.x_final, rtol=1e-4,
                                   atol=1e-6)
