"""The port's ghost cells against the JAX package, on the CPU.

For each of ``gru``, ``safeguard_lstm``, ``multi_layer_lstm``, ``gd`` and
``indirect_lstm``, starting from the JAX package's initial parameters
(converted with ``params_from_jax``): one step and a K=6 rollout in
float64 against the JAX step (1e-10 relative), the port's float32 rollout
against the JAX float64 one (F32_K6_RTOL: the limit ``chip_smoke.py``'s
phase (s) holds the card's float32 step to, against the port's float64
step there), the chunk loss and the gradient of every parameter against
``jax.value_and_grad`` (float64, 1e-9), two epochs of ``harness.train``
against the JAX harness's history, the reference naming round trip, and a
``.pkl`` checkpoint written by each package and read by the other.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iadmm_tpu as jit_
from iadmm_tpu.config import ExperimentConfig as JConfig
from iadmm_tpu.problems import generators as jgen, io as jio
from iadmm_tpu.scaling import scale_batch as jscale
from iadmm_tpu.solvers import cells as jcells, rollouts as jroll, \
    step as jstep
from iadmm_tpu.train import checkpoint as jckpt, harness as jharness

from iadmm_tpu_torch import config as tconfig
from iadmm_tpu_torch.api import make_solver
from iadmm_tpu_torch.convert import param_keys, params_from_jax
from iadmm_tpu_torch.solvers import cells as tcells, rollouts as troll, \
    step as tstep
from iadmm_tpu_torch.train import checkpoint as tckpt, harness as tharness

from torch_bridge import assert_close, to_torch

GHOSTS = ("gru", "safeguard_lstm", "multi_layer_lstm", "gd", "indirect_lstm")
N, MI, ME, H, K = 12, 6, 6, 8, 6
SIGMA = 6e-6
# float64 port vs float64 JAX: the same sums in another order
F64_RTOL, F64_ATOL = 1e-10, 1e-12
# The port's float32 K=6 rollout vs the float64 one, each state field to
# F32_K6_RTOL x max(1, max|ref|).  Measured at most 1.5e-5 here (y: the
# equality rows' rho_eq = 1e3 rho carries the rounding into y).  The card's
# float32 step is held to its float64 step at the flagship width with this
# limit as the floor (chip_smoke.py phase (s)); there indirect_lstm's float32
# rollout is ill-conditioned (its feature carries rho_eq·A0ᵀA0 twice: 1.9e-2
# on H measured on the CPU at QP 1000/500/500, h=800, B=2), and the phase
# also allows 4x the rollout's own gap under a hidden-unit permutation.
F32_K6_RTOL = 5e-4
FIELDS = ("x", "y", "z", "xv", "H", "C")


def _jax_init(name, h=H, length=K, seed=1, dtype=jnp.float64):
    spec = jstep.get_cell(name)
    p = spec.init(jax.random.PRNGKey(seed), 2, h, length,
                  **({"inner_T": 50} if name == "multi_layer_lstm" else {}))
    if name != "gd":   # gd's lr scales the step: keep it, widen the rest
        p = {k: v * 20 if k == "U" else v for k, v in p.items()}
    return {k: jnp.asarray(v, dtype) for k, v in p.items()}


def _np(p):
    return {k: np.asarray(v) for k, v in p.items()}


def _problem(seed=0, B=3):
    ds = jgen.generate("QP", num_var=N, num_ineq=MI, num_eq=ME, data_size=B,
                       seed=seed)
    jdata, _ = jscale(jio.to_qp_batch(ds, dtype=jnp.float64))
    return jdata, to_torch(jdata, dtype=torch.float64)


def _state(jdata, h=H, seed=0):
    B, n = jdata.p.shape
    S = n + jdata.zl.shape[-1]
    rng = np.random.default_rng(seed)
    return jit_.IterState(*(jnp.asarray(0.1 * rng.standard_normal(s))
                            for s in ((B, n), (B, S - n), (B, S - n),
                                      (B, S), (B, S, h), (B, S, h))))


def _close_state(tst, jst, rtol, atol, what):
    for f in FIELDS:
        assert_close(getattr(tst, f), getattr(jst, f), rtol, atol,
                     f"{what} {f}")


# ------------------------------------------------------------- registry

def test_registry_has_the_jax_cells_and_their_keys():
    assert set(tstep.CELL_REGISTRY) == set(jstep.CELL_REGISTRY)
    for name in jstep.CELL_REGISTRY:
        assert set(param_keys(name)) == set(_jax_init(name)), name
        assert tstep.get_cell(name.upper()).step is \
            tstep.CELL_REGISTRY[name].step
    p = tstep.get_cell("gd").init(torch.Generator().manual_seed(0), 2, H, K,
                                  device="cpu")
    assert p["lr"].dim() == 0 and float(p["lr"]) == pytest.approx(1e-3)
    for name, shapes in (("gru", dict(W=(2, 3 * H), U=(H, 3 * H))),
                         ("multi_layer_lstm", dict(U=(H, 4 * H)))):
        p = tstep.get_cell(name).init(torch.Generator().manual_seed(0), 2,
                                      H, K, device="cpu")
        for k, s in shapes.items():
            assert tuple(p[k].shape) == s, (name, k)
    with pytest.raises(KeyError, match="lacks"):
        params_from_jax(_np(_jax_init("lstm")), device="cpu",
                        model_name="safeguard_lstm")


def test_default_schedules_are_the_jax_package_values():
    """ρ = 0.1 without ``rho``, α = 1.6 without ``alpha``, both float32."""
    jdata, tdata = _problem()
    jr, ja = jstep._schedules({}, 0, jdata.eq_mask)
    tr, ta = tstep._schedules({}, 0, tdata.eq_mask)
    assert tr.dtype == ta.dtype == torch.float32
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert float(ta) == float(ja)


# --------------------------------------------------------- step, rollout

@pytest.mark.parametrize("name", GHOSTS)
def test_step_and_rollout_match_jax(name):
    jdata, tdata = _problem()
    jp = _jax_init(name)
    tp = params_from_jax(_np(jp), device="cpu", dtype=torch.float64,
                         model_name=name)
    jst = _state(jdata)
    tst = to_torch(jst, dtype=torch.float64)
    jstep_fn, tstep_fn = jstep.get_cell(name).step, tstep.get_cell(name).step
    _close_state(tstep_fn(tp, 0, tst, tdata, SIGMA),
                 jstep_fn(jp, 0, jst, jdata, SIGMA), F64_RTOL, F64_ATOL,
                 "one step")
    jfin = jroll.rollout(jstep_fn, jp, jst, jdata, SIGMA, K)
    tfin = troll.rollout(tstep_fn, tp, tst, tdata, SIGMA, K)
    _close_state(tfin, jfin, F64_RTOL, F64_ATOL, f"K={K}")
    # the float32 port against the float64 JAX rollout
    p32 = params_from_jax(_np(jp), device="cpu", dtype=torch.float32,
                          model_name=name)
    f32 = troll.rollout(tstep_fn, p32, to_torch(jst, dtype=torch.float32),
                        to_torch(jdata, dtype=torch.float32), SIGMA, K)
    for f in FIELDS:
        ref = np.asarray(getattr(jfin, f))
        gap = np.abs(getattr(f32, f).double().numpy() - ref).max()
        assert gap <= F32_K6_RTOL * max(1.0, np.abs(ref).max()), (f, gap)
    if name == "indirect_lstm":   # only the n variable tokens move
        for f in ("xv", "H", "C"):
            np.testing.assert_array_equal(getattr(tfin, f)[:, N:].numpy(),
                                          np.asarray(getattr(jst, f))[:, N:])
    if name == "gd":
        assert torch.equal(tfin.H, tst.H) and torch.equal(tfin.C, tst.C)


@pytest.mark.parametrize("name", GHOSTS)
def test_chunk_loss_and_gradients_match_jax(name):
    jdata, tdata = _problem(seed=2, B=2)
    jp = _jax_init(name, seed=3)
    jst = _state(jdata, seed=4)
    t0, chunk, outer_T = 2, 3, K
    jfn = jstep.get_cell(name).step

    def jloss(p):
        return jroll.chunk_loss(jfn, p, jst, jdata, SIGMA, chunk, outer_T, t0)

    (jl, jfinal), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = {k: v.requires_grad_(True)
          for k, v in params_from_jax(_np(jp), device="cpu",
                                      dtype=torch.float64,
                                      model_name=name).items()}
    tl, tfinal = troll.chunk_loss(tstep.get_cell(name).step, tp,
                                  to_torch(jst, dtype=torch.float64), tdata,
                                  SIGMA, chunk, outer_T, t0)
    tl.backward()
    assert_close(tl.detach(), jl, F64_RTOL, F64_ATOL, "loss")
    _close_state(tfinal, jfinal, F64_RTOL, F64_ATOL, "final")
    assert set(jg) == set(tp)
    for k in jg:
        assert tp[k].grad is not None, k
        assert tp[k].grad.shape == tp[k].shape, k
        assert_close(tp[k].grad, jg[k], 1e-9, 1e-11, f"d{k}")


# --------------------------------------------------------------- harness

def _cfg(cls, name, **kw):
    base = dict(prob_type="QP", num_var=N, num_ineq=MI, num_eq=ME,
                data_size=20, hidden_dim=H, outer_T=4, truncated_length=2,
                batch_size=2, lr=1e-3, num_epoch=2, val_frac=0.1,
                test_frac=0.1, eq_tol=1e9, log_every=100, num_devices=1,
                epoch_scan=False, model_name=name)
    base.update(kw)
    return cls(**base)


# Two epochs from the same float32 parameters: 8 batches of 2 chunk updates,
# float32 sums in another order grown over 32 Adam steps.  Measured: the
# loss within 1.6e-5 (relative) for every cell; the objectives within 1e-5
# for the ghosts, and within 5.3e-4 for 'lstm' and 'safeguard_lstm', whose
# objective (-0.15) cancels terms of order 3.  HIST_OBJ_RTOL is 4x the live
# 'lstm' cell's own gap, held here beside the ghosts.
HIST_LOSS_RTOL, HIST_OBJ_RTOL = 5e-5, 2e-3


@pytest.mark.parametrize("name", ("lstm",) + GHOSTS)
def test_two_epochs_match_jax_harness(monkeypatch, tmp_path, name):
    """Both harnesses start from the JAX init cast to float32 (under the
    tests' float64 mode the JAX ``gd`` init draws float64 schedules, which
    the JAX harness's float32 scan carry rejects)."""
    ds = jgen.generate("QP", num_var=N, num_ineq=MI, num_eq=ME, data_size=20,
                       seed=5)
    jspec, tspec = jstep.get_cell(name), tstep.get_cell(name)
    jp0 = {k: jnp.asarray(v, jnp.float32) for k, v in jspec.init(
        jax.random.PRNGKey(17), 2, H, 4).items()}

    def tinit(gen, input_dim, h, T, device="cpu", **kw):
        return {k: torch.as_tensor(np.array(v), device=device)
                for k, v in jp0.items()}

    monkeypatch.setattr(jharness, "get_cell", lambda n: dataclasses.replace(
        jspec, init=lambda *a, **kw: dict(jp0)))
    monkeypatch.setattr(tharness, "get_cell",
                        lambda n: dataclasses.replace(tspec, init=tinit))
    jres = jharness.train(_cfg(JConfig, name, save_dir=str(tmp_path / "j")),
                          ds, verbose=False)
    tres = tharness.train(_cfg(tconfig.ExperimentConfig, name,
                               save_dir=str(tmp_path / "t")), ds,
                          verbose=False, device="cpu")
    assert len(tres.history) == len(jres.history) == 2
    for a, b in zip(tres.history, jres.history):
        assert np.isclose(a["train_loss"], b["train_loss"],
                          rtol=HIST_LOSS_RTOL, atol=0), (a, b)
        for k in ("train_obj", "val_obj"):
            assert np.isclose(a[k], b[k], rtol=HIST_OBJ_RTOL, atol=0), \
                (k, a, b)
    assert tres.history[1]["train_loss"] != tres.history[0]["train_loss"]


def test_fused_backend_and_fused_rollout_stay_lstm_only(tmp_path):
    ds = jgen.generate("QP", num_var=N, num_ineq=MI, num_eq=ME, data_size=20,
                       seed=5)
    with pytest.raises(ValueError, match="lstm"):
        tharness.train(_cfg(tconfig.ExperimentConfig, "gru",
                            train_backend="fused",
                            save_dir=str(tmp_path)), ds, verbose=False,
                       device="cpu")
    _, tdata = _problem()
    data = dataclasses.replace(tdata, **{
        f.name: getattr(tdata, f.name).float()
        for f in dataclasses.fields(tdata)
        if getattr(tdata, f.name) is not None
        and getattr(tdata, f.name).is_floating_point()})
    kw = dict(hidden_dim=H, num_iters=K, rollout_impl="fused")
    for name in ("gru", "safeguard_lstm", "multi_layer_lstm", "gd"):
        p = params_from_jax(_np(_jax_init(name)), device="cpu",
                            model_name=name)
        with pytest.raises(ValueError):
            make_solver(p, model_name=name, **kw)(data)
    # indirect_lstm carries the LSTM's keys: the fused rollout runs the LSTM
    # algorithm on them, as the JAX package's does
    p = params_from_jax(_np(_jax_init("indirect_lstm")), device="cpu",
                        model_name="indirect_lstm")
    a = make_solver(p, model_name="indirect_lstm", **kw)(data)
    b = make_solver(p, model_name="lstm", **kw)(data)
    assert torch.equal(a.x, b.x)


@pytest.mark.parametrize("name", GHOSTS)
def test_make_solver_step_route_matches_jax(name):
    """``make_solver(model_name=...)`` on the step route (the cell's own
    step, LU Stage II), float32 in both packages: every output to 1e-3 of
    its max|ref| (float32 sums in another order; measured at most 1.1e-4,
    on gru's y, where rho_eq = 1e3 rho meets the rounding, and 5.6e-5 for
    the lstm cell's own y)."""
    from iadmm_tpu import api as japi
    from iadmm_tpu_torch import api as tapi
    ds = jgen.generate("QP", num_var=N, num_ineq=MI, num_eq=ME, data_size=3,
                       seed=21)
    jdata = jio.to_qp_batch(ds)
    jp = _jax_init(name, dtype=jnp.float32)
    kw = dict(hidden_dim=H, num_iters=K, feas_rest_num=5, model_name=name,
              rollout_impl="step", stage2_impl="lu")
    jr = japi.make_solver(jp, **kw)(jdata)
    tr = tapi.make_solver(params_from_jax(_np(jp), device="cpu",
                                          model_name=name), **kw)(
        to_torch(jdata, dtype=torch.float32))
    for f in ("x", "y", "z", "primal_res", "dual_res", "obj"):
        assert torch.isfinite(getattr(tr, f)).all(), f
        ref = np.asarray(getattr(jr, f))
        assert_close(getattr(tr, f), ref, 0, 1e-3 * np.abs(ref).max(), f)


# ------------------------------------------------ naming and checkpoints

@pytest.mark.parametrize("name", ("lstm", "gru", "safeguard_lstm",
                                  "multi_layer_lstm"))
def test_reference_naming_round_trip(name):
    jp = _jax_init(name)
    tp = params_from_jax(_np(jp), device="cpu", dtype=torch.float64,
                         model_name=name)
    jref = jcells.to_reference_naming(jp, name)
    tref = tcells.to_reference_naming(tp, name)
    assert set(tref) == set(jref)
    for k in jref:
        np.testing.assert_array_equal(tref[k].numpy(), np.asarray(jref[k]))
    back = tcells.from_reference_naming(tref, name)
    assert set(back) == set(tp)
    for k in tp:
        assert torch.equal(back[k], tp[k]), k
    jback = jcells.from_reference_naming(
        {k: v.numpy() for k, v in tref.items()}, name)
    for k in tp:
        np.testing.assert_array_equal(np.asarray(jback[k]), tp[k].numpy())


@pytest.mark.parametrize("name", GHOSTS)
def test_pkl_checkpoints_cross_both_packages(tmp_path, name):
    jp = _jax_init(name, dtype=jnp.float32)
    jpath = str(tmp_path / "jax.pkl")
    jckpt.save_checkpoint(jpath, {"params": jp, "epoch": 2,
                                  "opt_state": jharness.make_optimizer(
                                      1e-3).init(jp)})
    got = tckpt.load_checkpoint(jpath)["params"]
    tp = params_from_jax(got, device="cpu", model_name=name)
    for k in jp:
        assert tp[k].shape == jp[k].shape, k
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    if name == "gd":
        assert tp["lr"].dim() == 0
    ppath = str(tmp_path / "port.pkl")
    opt = tharness.make_optimizer(
        {k: v.clone().requires_grad_(True) for k, v in tp.items()}, 1e-3)
    tckpt.save_checkpoint(ppath, {"params": tp, "epoch": 3,
                                  "opt_state": opt.state_arrays()})
    back = jckpt.load_checkpoint(ppath)["params"]
    assert set(back) == set(jp)
    for k in jp:
        assert np.shape(back[k]) == jp[k].shape, k
        np.testing.assert_array_equal(back[k], np.asarray(jp[k]))
