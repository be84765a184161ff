"""The port's evaluation slice against the JAX package, on the CPU.

``eval_rollout`` and ``eval_stage2`` traces, ``run_test`` on the dense and
the BSR route with Stage II (rtol 1e-4 on every trace), the port's BSR
traces against its dense ones (as ``tests/test_sparse.py`` holds the JAX
package's), ``export_traces`` keys and values, and ``cli/test.py`` end to
end on a checkpoint.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

import iadmm_tpu as jit_
from iadmm_tpu.evaluation import driver as jdriver
from iadmm_tpu.problems import generators as jgen, io as jio
from iadmm_tpu.scaling import scale_batch as jscale
from iadmm_tpu.solvers import rollouts as jroll, step as jstep

from iadmm_tpu_torch import config as tconfig
from iadmm_tpu_torch.cli import test as tcli
from iadmm_tpu_torch.evaluation import driver as tdriver
from iadmm_tpu_torch.solvers import rollouts as troll, step as tstep
from iadmm_tpu_torch.train import checkpoint as tckpt

from torch_bridge import (assert_close, jax_lstm_params, params_to_torch,
                          to_torch)

RTOL, ATOL = 1e-4, 1e-6
TRACE_KEYS = ("obj", "primal_res", "dual_res", "ls_res")


def _assert_traces(t, j, rtol=RTOL, atol=ATOL, what=""):
    for f in TRACE_KEYS:
        assert_close(getattr(t, f), getattr(j, f), rtol, atol, what + f)
    assert set(t.violations) == set(j.violations)
    for k in j.violations:
        assert_close(t.violations[k], j.violations[k], rtol, atol, what + k)


def _params(h=8, K=6, seed=4):
    jp = jax_lstm_params(seed, h, K)
    return {k: (v * 20 if k == "U" else v) for k, v in jp.items()}


@pytest.mark.parametrize("prob_type,n,mi,me", [("QP", 12, 6, 6),
                                               ("SVM", 10, 6, 0)])
def test_eval_rollout_and_stage2_match_jax(prob_type, n, mi, me):
    ds = jgen.generate(prob_type, num_var=n, num_ineq=mi, num_eq=me,
                       data_size=3, seed=2)
    jdata = jio.to_qp_batch(ds)
    jscaled, jsc = jscale(jdata)
    jp = _params()
    tp = params_to_torch(jp, dtype=torch.float32)
    sigma, T = 6e-6, 6
    jst0 = jit_.init_state(3, jdata.num_var, jdata.num_constr, 8)
    jfin, jtr = jroll.eval_rollout(jstep.lstm_step, jp, jst0, jscaled, jdata,
                                   jsc, jnp.float32(sigma), T)
    tdata, tsc = to_torch(jdata), to_torch(jsc)
    tfin, ttr = troll.eval_rollout(tstep.lstm_step, tp, to_torch(jst0),
                                   to_torch(jscaled), tdata, tsc, sigma, T)
    _assert_traces(ttr, jtr, what="learned ")
    assert ttr.obj.shape == (T,)
    rho_vec, _ = jstep._schedules(jp, T - 1, jdata.eq_mask)
    jst = jroll.unscale_state(jfin, jsc)
    _, j2 = jroll.eval_stage2(jst, jdata, jdata, None, jnp.float32(sigma),
                              rho_vec, 8)
    _, t2 = troll.eval_stage2(to_torch(jst), tdata, tdata, None, sigma,
                              to_torch(rho_vec), 8)
    _assert_traces(t2, j2, rtol=1e-4, atol=1e-5, what="stage2 ")


def _cfg(tmp_path, **kw):
    base = dict(prob_type="Sparse_QP", num_var=24, num_ineq=12, data_size=8,
                hidden_dim=8, outer_T=6, truncated_length=3, batch_size=2,
                val_frac=0.25, test_frac=0.5, eq_tol=1e9, num_devices=1,
                scaling=True, test_outer_T=6, test_batch_size=2,
                feas_rest=True, feas_rest_num=5, save_dir=str(tmp_path))
    base.update(kw)
    return base


def _sparse_ds():
    return jgen.generate("Sparse_QP", num_var=24, num_ineq=12, data_size=8,
                         seed=9, bandwidth=3)


@pytest.mark.parametrize("route", [
    dict(),
    dict(sparse=True, sparse_format="bsr"),
    dict(sparse=True, sparse_format="bsr", matvec_mode="bf16")])
def test_run_test_matches_jax(tmp_path, route):
    ds = _sparse_ds()
    kw = _cfg(tmp_path, **route)
    jp = _params()
    jrep = jdriver.run_test(jit_.ExperimentConfig(**kw), ds, jp,
                            verbose=False)
    trep = tdriver.run_test(tconfig.ExperimentConfig(**kw), ds,
                            {k: np.asarray(v) for k, v in jp.items()},
                            verbose=False, device="cpu")
    assert trep.test_size == jrep.test_size == 4
    _assert_traces(trep, jrep)
    _assert_traces(trep.stage2, jrep.stage2, rtol=1e-4, atol=1e-5,
                   what="stage2 ")
    assert_close(trep.x_final, jrep.x_final, 1e-4, 1e-5, "x_final")
    assert trep.total_time > 0 and trep.stage2.total_time > 0
    assert trep.parallel_time == pytest.approx(trep.total_time / 4)
    assert trep.oracle_gap is None and jrep.oracle_gap is None


def test_run_test_bsr_matches_dense(tmp_path, capsys):
    """The port's BSR traces against its own dense ones (the JAX package's
    tests/test_sparse.py check), with the per-iteration table printed."""
    ds = _sparse_ds()
    jp = {k: np.asarray(v) for k, v in _params().items()}
    kw = _cfg(tmp_path, feas_rest=False)
    dense = tdriver.run_test(tconfig.ExperimentConfig(**kw), ds, jp,
                             device="cpu")
    out = capsys.readouterr().out
    assert "Parallel Time" in out and dense.table().splitlines()[0] in out
    bsr = tdriver.run_test(tconfig.ExperimentConfig(
        sparse=True, sparse_format="bsr", **kw), ds, jp, verbose=False,
        device="cpu")
    for f in ("primal_res", "dual_res", "obj"):
        np.testing.assert_allclose(getattr(bsr, f), getattr(dense, f),
                                   rtol=1e-4, atol=1e-6, err_msg=f)
    assert dense.stage2 is None and bsr.x_final.shape == (4, 24)


def test_run_test_rejects_unported(tmp_path):
    """Only the mesh routes are left unported; the theory traces and the
    BCOO route (sparse=True's default format) run."""
    ds = _sparse_ds()
    jp = {k: np.asarray(v) for k, v in _params().items()}
    for extra in (dict(num_devices=2), dict(model_devices=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tdriver.run_test(tconfig.ExperimentConfig(**_cfg(tmp_path,
                                                             **extra)),
                             ds, jp, verbose=False, device="cpu")
    for extra in (dict(theory=True), dict(sparse=True)):
        rep = tdriver.run_test(tconfig.ExperimentConfig(**_cfg(tmp_path,
                                                               **extra)),
                               ds, jp, verbose=False, device="cpu")
        assert np.isfinite(rep.primal_res).all()
        assert (rep.theory is not None) == ("theory" in extra)


@pytest.mark.parametrize("ext", [".npz", ".mat"])
def test_export_traces_matches_jax(tmp_path, ext):
    ds = _sparse_ds()
    kw = _cfg(tmp_path)
    jp = _params()
    jrep = jdriver.run_test(jit_.ExperimentConfig(**kw), ds, jp,
                            verbose=False)
    trep = tdriver.run_test(tconfig.ExperimentConfig(**kw), ds,
                            {k: np.asarray(v) for k, v in jp.items()},
                            verbose=False, device="cpu")
    jpath, tpath = str(tmp_path / ("j" + ext)), str(tmp_path / ("t" + ext))
    jdriver.export_traces(jrep, jpath)
    tdriver.export_traces(trep, tpath)
    if ext == ".mat":
        j, t = scipy.io.loadmat(jpath), scipy.io.loadmat(tpath)
    else:
        j, t = dict(np.load(jpath)), dict(np.load(tpath))
    keys = {k for k in j if not k.startswith("__")}
    assert keys == {k for k in t if not k.startswith("__")}
    assert {"x", "objs", "stage2_primal_res", "vio_ineq_max"} <= keys
    for k in keys - {"time", "total_time"}:
        assert np.shape(t[k]) == np.shape(j[k]), k
        if np.size(j[k]):
            assert_close(t[k], j[k], 1e-4, 1e-5, k)


def test_cli_test_runs_on_a_checkpoint(tmp_path, capsys):
    ds = _sparse_ds()
    root = str(tmp_path / "data")
    jio.save_npz(ds, jio.dataset_path(root, "Sparse_QP", 24, 12))
    kw = _cfg(tmp_path / "out", sparse=True, sparse_format="bsr")
    cfg = tconfig.ExperimentConfig(**kw)
    path = tckpt.checkpoint_path(cfg.save_dir, cfg.model_name, cfg.run_name())
    tckpt.save_checkpoint(path, {"params": params_to_torch(_params()),
                                 "epoch": 0})
    args = ["--prob_type", "Sparse_QP", "--num_var", "24", "--num_ineq",
            "12", "--data_size", "8", "--hidden_dim", "8", "--outer_T", "6",
            "--val_frac", "0.25", "--test_frac", "0.5", "--num_devices", "1",
            "--test_outer_T", "6", "--test_batch_size", "2", "--feas_rest",
            "--feas_rest_num", "5", "--sparse", "--sparse_format", "bsr",
            "--data_root", root, "--save_dir", cfg.save_dir,
            "--device", "cpu"]
    out = str(tmp_path / "traces.npz")
    assert tcli.main(args + ["--export", out]) == 0
    printed = capsys.readouterr().out
    assert "Stage II" in printed and f"traces -> {out}" in printed
    with np.load(out) as f:
        assert f["objs"].shape == (6,) and f["stage2_obj"].shape == (5,)
    assert tcli.main(args + ["--baseline", "osqp"]) == 0
    assert "OSQP-baseline (native batch): 4/4 solved" in \
        capsys.readouterr().out


def test_trace_shapes_follow_the_iteration_count(tmp_path):
    ds = _sparse_ds()
    jp = {k: np.asarray(v) for k, v in _params().items()}
    kw = _cfg(tmp_path, test_outer_T=4, feas_rest_num=3)
    rep = tdriver.run_test(tconfig.ExperimentConfig(**kw), ds, jp,
                           verbose=False, device="cpu")
    assert rep.obj.shape == (4,) and rep.stage2.obj.shape == (3,)
    assert all(v.shape == (4,) for v in rep.violations.values())
    short = dataclasses.replace(tconfig.ExperimentConfig(**kw),
                                test_outer_T=7)
    with pytest.raises(ValueError, match="schedule"):
        tdriver.run_test(short, ds, jp, verbose=False, device="cpu")
