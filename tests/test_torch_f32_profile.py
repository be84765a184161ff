"""The float32 precision profile of the shipped flagship config, on the CPU.

``configs/qp_1000_500_500.yaml`` sets ``use_pallas: true`` and keeps the
defaults ``gate_dtype='float32'``, ``matvec_mode='highest'`` and
``train_backend='step'``: the fused cell with float32 gates, float32
matvecs.  Here that profile goes through the port (its kernels' plain
versions, on CPU tensors) and through the JAX package (its Pallas cell in
interpret mode) at a tiny size, on the same numpy-made inputs:

- ``run_test`` with Stage II: every trace to rtol 1e-4 (the tolerance of
  ``test_torch_eval.py``);
- ``make_solver(use_pallas=True)`` with the default gate: outputs to rtol
  1e-3, atol 1e-4 (float32 sums in another order; Stage II multiplies the
  rounding of A0·x − z by ρ_eq = 1e3·ρ on the equality rows);
- two step-backend chunk updates of the harness's chunk from the same
  params: loss rtol 1e-5, params to 5% of one Adam step, as
  ``test_torch_train.py`` holds the fused backend;
- the float32-gate cell with bf16 H/C against the Pallas cell: delta
  (float32) to 1e-5, the bf16 H' and C' to one bf16 ulp (2^-7 relative:
  the same float32 value, differing in its last bits, may round either
  way).
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import iadmm_tpu as jit_
from iadmm_tpu import api as japi
from iadmm_tpu.evaluation import driver as jdriver
from iadmm_tpu.kernels.lstm_cell import fused_lstm_cell as j_cell
from iadmm_tpu.problems import generators as jgen, io as jio
from iadmm_tpu.solvers import step as jstep
from iadmm_tpu.train import harness as jharness

from iadmm_tpu_torch import api as tapi
from iadmm_tpu_torch import config as tconfig
from iadmm_tpu_torch.evaluation import driver as tdriver
from iadmm_tpu_torch.kernels import lstm_cell as tcell
from iadmm_tpu_torch.solvers import step as tstep
from iadmm_tpu_torch.train import harness as tharness

from torch_bridge import (assert_close, jax_lstm_params, params_to_torch,
                          to_torch)

FLAGSHIP = Path(__file__).resolve().parents[1] / "configs" / \
    "qp_1000_500_500.yaml"
PRECISION = ("use_pallas", "gate_dtype", "matvec_mode", "train_backend")
# the flagship config cut to a tiny size; the precision fields stay its own
TINY = dict(num_var=12, num_ineq=6, num_eq=6, data_size=8, hidden_dim=8,
            outer_T=6, truncated_length=3, test_outer_T=6, batch_size=2,
            test_batch_size=2, val_frac=0.25, test_frac=0.5, eq_tol=1e9,
            feas_rest=True, feas_rest_num=5, num_devices=1)


def _flagship(tmp_path, **kw):
    """Both packages' configs: the flagship YAML with the tiny overrides."""
    over = dict(TINY, save_dir=str(tmp_path), **kw)
    return (jit_.ExperimentConfig.from_yaml(str(FLAGSHIP), **over),
            tconfig.ExperimentConfig.from_yaml(str(FLAGSHIP), **over))


def _params(h=8, K=6, seed=4):
    jp = jax_lstm_params(seed, h, K)
    return {k: (v * 20 if k == "U" else v) for k, v in jp.items()}


def _step_fn(pkg, cfg):
    """The step ``harness.train`` builds from ``cfg`` (both packages)."""
    return pkg.make_lstm_step(
        use_pallas=cfg.use_pallas, gate_dtype=cfg.gate_dtype,
        matvec_mode=None if cfg.matvec_mode == "highest"
        else cfg.matvec_mode)


def test_flagship_config_is_ported_at_float32():
    cfg = tconfig.ExperimentConfig.from_yaml(str(FLAGSHIP))
    cfg.check_ported()
    assert {k: getattr(cfg, k) for k in PRECISION} == dict(
        use_pallas=True, gate_dtype="float32", matvec_mode="highest",
        train_backend="step")
    fused = dataclasses.replace(cfg, train_backend="fused")
    fused.check_ported()


def test_run_test_float32_cell_matches_jax(tmp_path):
    jcfg, tcfg = _flagship(tmp_path)
    ds = jgen.generate("QP", num_var=12, num_ineq=6, num_eq=6, data_size=8,
                       seed=3)
    jp = _params()
    with pltpu.force_tpu_interpret_mode():
        jrep = jdriver.run_test(jcfg, ds, jp, verbose=False)
    trep = tdriver.run_test(tcfg, ds, {k: np.asarray(v)
                                       for k, v in jp.items()},
                            verbose=False, device="cpu")
    assert trep.test_size == jrep.test_size == 4
    for rep_t, rep_j, what in ((trep, jrep, ""),
                               (trep.stage2, jrep.stage2, "stage2 ")):
        for f in ("obj", "primal_res", "dual_res", "ls_res"):
            assert_close(getattr(rep_t, f), getattr(rep_j, f), 1e-4, 1e-6,
                         what + f)
    assert_close(trep.x_final, jrep.x_final, 1e-4, 1e-5, "x_final")


@pytest.mark.parametrize("stage2_impl", ["fused", "lu"])
def test_make_solver_default_gate_matches_jax(stage2_impl):
    B, n, mi, me, h, K = 3, 20, 10, 10, 16, 6
    ds = jgen.generate("QP", num_var=n, num_ineq=mi, num_eq=me, data_size=B,
                       seed=21)
    jdata = jio.to_qp_batch(ds)
    jp = jax_lstm_params(4, h, K)
    kw = dict(hidden_dim=h, num_iters=K, use_pallas=True, feas_rest_num=10,
              stage2_impl=stage2_impl)
    with pltpu.force_tpu_interpret_mode():
        jr = japi.make_solver(jp, **kw)(jdata)
    tr = tapi.make_solver(params_to_torch(jp, dtype=torch.float32), **kw)(
        to_torch(jdata, dtype=torch.float32))
    for f in ("x", "y", "z", "primal_res", "dual_res", "obj"):
        a = getattr(tr, f)
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), f
        assert_close(a, getattr(jr, f), 1e-3, 1e-4, f)


def test_step_chunk_updates_match_jax_harness(tmp_path):
    """Two chunk updates (t0 = 0, 3) of the step backend from the same
    params, over the flagship config's step (the fused float32-gate cell,
    float32 matvecs): the port's ``make_train_chunk`` against the JAX
    harness's."""
    jcfg, tcfg = _flagship(tmp_path)
    B, h, chunk, T = tcfg.batch_size, tcfg.hidden_dim, \
        tcfg.truncated_length, tcfg.outer_T
    lr = 1e-3
    ds = jgen.generate("QP", num_var=12, num_ineq=6, num_eq=6, data_size=B,
                       seed=9)
    jdata = jio.to_qp_batch(ds)
    jp = _params(h, T, seed=5)
    jopt = jharness.make_optimizer(lr)
    jchunk = jharness.make_train_chunk(_step_fn(jstep, jcfg), jopt, T, chunk,
                                       jcfg.sigma)
    tp = {k: v.requires_grad_(True)
          for k, v in params_to_torch(jp, dtype=torch.float32).items()}
    tchunk = tharness.make_train_chunk(
        _step_fn(tstep, tcfg), tharness.make_optimizer(tp, lr), T, chunk,
        tcfg.sigma)
    jparams, jstate = dict(jp), jopt.init(jp)
    jst = jit_.init_state(B, jdata.num_var, jdata.num_constr, h)
    tst = to_torch(jst)
    tdata = to_torch(jdata, dtype=torch.float32)
    for t0 in (0, chunk):
        with pltpu.force_tpu_interpret_mode():
            jparams, jstate, jst, jl = jchunk(jparams, jstate, jst, jdata,
                                              jnp.asarray(t0, jnp.int32))
        tst, tl = tchunk(tp, tst, tdata, t0)
        assert_close(tl, jl, 1e-5, 1e-7, f"loss t0={t0}")
        for k in jparams:
            assert_close(tp[k].detach(), jparams[k], 0, 5e-2 * lr,
                         f"{k} t0={t0}")
        assert_close(tst.x, jst.x, 2e-4, 2e-5, f"state t0={t0}")


def test_float32_cell_with_bf16_state_matches_pallas():
    """Float32 gates over a bf16 H/C carry (``cell_cuda`` takes either
    state dtype with either gate): H' and C' come back in bf16."""
    h = 16
    params = jax_lstm_params(0, h, 4)
    rng = np.random.default_rng(1)
    x, H, C = (jnp.asarray(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 40, 2), (2, 40, h), (2, 40, h)))
    H, C = H.astype(jnp.bfloat16), C.astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        jd, jH, jC = j_cell(params, x, H, C, "float32")
    bf = torch.bfloat16
    td, tH, tC = tcell.fused_lstm_cell(
        params_to_torch(params, dtype=torch.float32), to_torch(x),
        to_torch(H).to(bf), to_torch(C).to(bf), "float32")
    assert tH.dtype == tC.dtype == torch.bfloat16
    assert_close(td, jd, 1e-5, 1e-6, "delta")
    assert_close(tH, jH, 2 ** -7, 1e-6, "H")
    assert_close(tC, jC, 2 ** -7, 1e-6, "C")
