"""The PyTorch port's plain modules against the JAX package, on the CPU.

Same inputs (numpy, fixed seeds) and the same parameters (the JAX
initialiser, converted) go through both packages.  Float64 comparisons hold
the algorithm to 1e-10 (1e-9 over multi-step rollouts, where rounding
compounds); bf16 profiles to the bf16 rounding level.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iadmm_tpu.problems import generators as jgen, io as jio
from iadmm_tpu.scaling import scale_batch as j_scale_batch
from iadmm_tpu.solvers import cells as jcells, step as jstep, \
    rollouts as jroll, exact as jexact
from iadmm_tpu.evaluation import metrics as jmetrics
from iadmm_tpu import types as jtypes

from iadmm_tpu_torch.problems import generators as tgen, io as tio
from iadmm_tpu_torch.scaling import scale_batch as t_scale_batch
from iadmm_tpu_torch.solvers import cells as tcells, step as tstep, \
    rollouts as troll, exact as texact
from iadmm_tpu_torch.evaluation import metrics as tmetrics
from iadmm_tpu_torch import types as ttypes

from torch_bridge import (assert_close, jax_lstm_params, params_to_torch,
                          to_jax, to_torch)

F64 = torch.float64
SIGMA = 6e-6
B, N_VAR, MI, ME, HID = 3, 20, 10, 10, 16


@pytest.fixture(scope="module")
def ds():
    return jgen.generate("QP", num_var=N_VAR, num_ineq=MI, num_eq=ME,
                         data_size=B, seed=5)


@pytest.fixture(scope="module")
def jdata(ds):
    return jio.to_qp_batch(ds, dtype=jnp.float64)


@pytest.fixture(scope="module")
def tdata(jdata):
    return to_torch(jdata, dtype=F64)


@pytest.fixture(scope="module")
def params64():
    jp = jax_lstm_params(7, HID, 8, dtype=jnp.float64)
    # non-zero biases so that b and b_h are exercised
    rng = np.random.default_rng(1)
    jp = dict(jp, b=jnp.asarray(0.1 * rng.standard_normal(4 * HID)),
              b_h=jnp.asarray([0.05]))
    return jp, params_to_torch(jp, dtype=F64)


@pytest.fixture(scope="module")
def state64():
    rng = np.random.default_rng(2)
    m, nm = MI + ME, N_VAR + MI + ME
    arrs = dict(x=rng.standard_normal((B, N_VAR)),
                y=rng.standard_normal((B, m)),
                z=rng.standard_normal((B, m)),
                xv=rng.standard_normal((B, nm)),
                H=0.5 * rng.standard_normal((B, nm, HID)),
                C=0.5 * rng.standard_normal((B, nm, HID)))
    js = jtypes.IterState(**{k: jnp.asarray(v) for k, v in arrs.items()})
    return js, to_torch(js, dtype=F64)


@pytest.mark.parametrize("family,kw", [
    ("QP", dict(num_ineq=6, num_eq=4)),
    ("QP_RHS", dict(num_ineq=6, num_eq=4)),
    ("Random_QP", dict(num_ineq=6)),
    ("SVM", dict(num_ineq=6)),
])
def test_generate_bitwise_equal(family, kw):
    a = jgen.generate(family, num_var=12, data_size=3, seed=9, **kw)
    b = tgen.generate(family, num_var=12, data_size=3, seed=9, **kw)
    for f in ("Q", "p", "A0", "zl", "zu", "G", "c", "A", "b", "lb", "ub"):
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            assert va.dtype == vb.dtype and np.array_equal(va, vb), f


def test_bridge_round_trip(jdata, state64):
    back = to_jax(to_torch(jdata))
    for f in ("Q", "p", "A0", "zl", "zu", "eq_mask", "G", "c", "A", "b"):
        a, b = getattr(back, f), getattr(jdata, f)
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a),
                                                     np.asarray(b)), f
    js, ts = state64
    assert isinstance(ts, ttypes.IterState)
    assert np.array_equal(np.asarray(to_jax(ts).H), np.asarray(js.H))


def test_to_qp_batch_matches(ds, jdata):
    t = tio.to_qp_batch(ds, dtype=F64, device="cpu")
    for f in ("Q", "p", "A0", "zl", "zu", "G", "c", "A", "b"):
        assert_close(getattr(t, f), getattr(jdata, f), 1e-10, 0, f)
    assert np.array_equal(t.eq_mask.numpy(), np.asarray(jdata.eq_mask))
    assert int(t.eq_mask.sum()) == B * ME


def test_scale_batch_matches(jdata, tdata):
    js, jsc = j_scale_batch(jdata, iters=10)
    ts, tsc = t_scale_batch(tdata, iters=10)
    for f in ("Q", "p", "A0", "zl", "zu"):
        assert_close(getattr(ts, f), getattr(js, f), 1e-10, 1e-14, f)
    for f in ("d", "e", "cost"):
        assert_close(getattr(tsc, f), getattr(jsc, f), 1e-10, 0, f)


@pytest.mark.parametrize("gate_dtype,tol", [(None, 1e-10),
                                            ("bfloat16", 1e-2)])
def test_lstm_apply_matches(params64, state64, gate_dtype, tol):
    jp, tp = params64
    js, ts = state64
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, N_VAR + MI + ME, 2))
    if gate_dtype is None:
        jx, jH, jC = jnp.asarray(x), js.H, js.C
        tx, tH, tC, tpp = torch.as_tensor(x), ts.H, ts.C, tp
    else:  # the bf16 profile runs on float32 data and weights
        jp = {k: v.astype(jnp.float32) for k, v in jp.items()}
        jx, jH, jC = (jnp.asarray(a, jnp.float32)
                      for a in (x, js.H, js.C))
        tx, tH, tC = (to_torch(a) for a in (jx, jH, jC))
        tpp = params_to_torch(jp, dtype=torch.float32)
    jd, jHn, jCn = jcells.lstm_apply(jp, jx, jH, jC, gate_dtype=gate_dtype)
    td, tHn, tCn = tcells.lstm_apply(tpp, tx, tH, tC, gate_dtype=gate_dtype)
    assert_close(td, jd, tol, tol, "delta")
    assert_close(tHn, jHn, tol, tol, "H")
    assert_close(tCn, jCn, tol, tol, "C")


def test_lstm_init_shapes_and_scale():
    g = torch.Generator().manual_seed(0)
    p = tcells.lstm_init(g, 2, 64, 10, device="cpu")
    assert p["W"].shape == (2, 256) and p["U"].shape == (64, 256)
    assert p["W_h"].shape == (64, 1) and p["rho"].shape == (10,)
    assert float(p["b"].abs().max()) == 0.0
    assert 0.008 < float(p["U"].std()) < 0.012


@pytest.mark.parametrize("mode,tol", [(None, 1e-10), ("bf16", 1e-5)])
def test_kkt_feature_matches(jdata, tdata, state64, mode, tol):
    js, ts = state64
    jrho = jstep.rho_vector(jnp.float64(0.3), jdata.eq_mask)
    trho = tstep.rho_vector(torch.tensor(0.3, dtype=F64), tdata.eq_mask)
    assert_close(trho, jrho, 1e-12, 0, "rho_vec")
    jg = jstep.kkt_feature(jdata, js.xv, js.x, js.y, js.z, SIGMA, jrho, mode)
    tg = tstep.kkt_feature(tdata, ts.xv, ts.x, ts.y, ts.z, SIGMA, trho, mode)
    scale = float(np.abs(np.asarray(jg)).max())
    assert_close(tg, jg, tol, tol * scale, "g")


@pytest.mark.parametrize("relax_z", [False, True])
def test_admm_update_matches(jdata, tdata, state64, relax_z):
    js, ts = state64
    jrho = jstep.rho_vector(jnp.float64(0.3), jdata.eq_mask)
    trho = to_torch(jrho)
    jo = jstep.admm_update(jdata, js.xv, js.x, js.y, js.z, jrho, 1.3,
                           relax_z)
    to = tstep.admm_update(tdata, ts.xv, ts.x, ts.y, ts.z, trho, 1.3,
                           relax_z)
    for name, a, b in zip("xyz", to, jo):
        assert_close(a, b, 1e-10, 1e-12, name)


def test_lstm_step_matches(jdata, tdata, params64, state64):
    jp, tp = params64
    js, ts = state64
    jo = jstep.lstm_step(jp, 2, js, jdata, SIGMA)
    to = tstep.lstm_step(tp, 2, ts, tdata, SIGMA)
    for f in ("x", "y", "z", "xv", "H", "C"):
        assert_close(getattr(to, f), getattr(jo, f), 1e-9, 1e-11, f)


def test_rollout_k6_matches(jdata, tdata, params64):
    jp, tp = params64
    K = 6
    js0 = jtypes.init_state(B, N_VAR, MI + ME, HID, dtype=jnp.float64)
    ts0 = ttypes.init_state(B, N_VAR, MI + ME, HID, dtype=F64,
                            device="cpu")
    jo = jroll.rollout(jstep.lstm_step, jp, js0, jdata, SIGMA, K)
    to = troll.rollout(tstep.lstm_step, tp, ts0, tdata, SIGMA, K)
    for f in ("x", "y", "z", "xv", "H", "C"):
        assert_close(getattr(to, f), getattr(jo, f), 1e-9, 1e-11, f)


def test_feasibility_restoration_matches(jdata, tdata, state64):
    js, ts = state64
    jrho = jstep.rho_vector(jnp.float64(0.2), jdata.eq_mask)
    trho = to_torch(jrho)
    jo = jexact.feasibility_restoration(js, jdata, 1e-4, jrho, 12)
    to = texact.feasibility_restoration(ts, tdata, 1e-4, trho, 12)
    for f in ("x", "y", "z", "xv"):
        assert_close(getattr(to, f), getattr(jo, f), 1e-9, 1e-11, f)


def test_unscale_and_metrics_match(jdata, tdata, state64):
    js, ts = state64
    _, jsc = j_scale_batch(jdata)
    _, tsc = t_scale_batch(tdata)
    ju = jroll.unscale_state(js, jsc)
    tu = troll.unscale_state(ts, tsc)
    for f in ("x", "y", "z"):
        assert_close(getattr(tu, f), getattr(ju, f), 1e-10, 0, f)
    for mode in (None, "default"):
        jpr, jdr = jmetrics.primal_dual_residual(
            ju.x, ju.y, ju.z, jdata.Q, jdata.p, jdata.A0, mode)
        tpr, tdr = tmetrics.primal_dual_residual(
            tu.x, tu.y, tu.z, tdata.Q, tdata.p, tdata.A0, mode)
        assert_close(tpr, jpr, 1e-10, 0, "pr")
        assert_close(tdr, jdr, 1e-10, 0, "dr")
        assert_close(tmetrics.obj_fn(tu.x, tdata.Q, tdata.p, mode),
                     jmetrics.obj_fn(ju.x, jdata.Q, jdata.p, mode),
                     1e-10, 0, "obj")
    jl = jmetrics.primal_dual_loss(ju.x, ju.y, ju.z, jdata)[2]
    tl = tmetrics.primal_dual_loss(tu.x, tu.y, tu.z, tdata)[2]
    assert_close(tl, jl, 1e-10, 0, "loss")


def test_diagonal_storage_matvec(tdata, state64):
    _, ts = state64
    Qd = torch.diagonal(tdata.Q, dim1=-2, dim2=-1)
    x = ts.x
    assert torch.allclose(tstep.bmv(Qd, x), tstep.bmv(tdata.Q, x),
                          rtol=1e-12, atol=0)
    assert torch.allclose(tstep.bmv_t(Qd, x), tstep.bmv_t(tdata.Q, x),
                          rtol=1e-12, atol=0)


def test_schedule_and_cell_errors(params64):
    _, tp = params64
    with pytest.raises(ValueError, match="test_outer_T"):
        tstep.check_schedule_len(tp, 9)
    tstep.check_schedule_len(tp, 8)
    assert tstep.get_cell("gru").step is tstep.gru_step
    with pytest.raises(ValueError, match="unknown solver cell"):
        tstep.get_cell("nope")
    assert tstep.get_cell("LSTM").step is tstep.lstm_step
