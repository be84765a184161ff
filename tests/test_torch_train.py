"""The port's training slice against the JAX package, on the CPU.

Config, dataset files and the split, violation metrics, the step-route
chunk loss (float64, to 1e-10), the optimizer (three steps against optax,
to 1e-6), the chunk update with the fused loss (the JAX harness with its
Pallas kernels in interpret mode, float32 compute), early stopping,
checkpoints in both directions, and ``train()`` end to end on both
backends at the size of ``test_harness_fused_backend_trains``.
"""

import dataclasses
import glob
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import iadmm_tpu as jit_
from iadmm_tpu import config as jconfig
from iadmm_tpu.evaluation import metrics as jmetrics
from iadmm_tpu.kernels.train_rollout import make_fused_chunk_loss as j_fused
from iadmm_tpu.problems import generators as jgen, io as jio
from iadmm_tpu.solvers import rollouts as jroll, step as jstep
from iadmm_tpu.train import checkpoint as jckpt, harness as jharness
from iadmm_tpu.train.early_stopping import EarlyStopping as JEarly

from iadmm_tpu_torch import config as tconfig
from iadmm_tpu_torch.api import make_solver
from iadmm_tpu_torch.cli import train as tcli
from iadmm_tpu_torch.evaluation import metrics as tmetrics
from iadmm_tpu_torch.kernels.train_rollout import make_fused_chunk_loss
from iadmm_tpu_torch.problems import io as tio
from iadmm_tpu_torch.solvers import rollouts as troll, step as tstep
from iadmm_tpu_torch.train import checkpoint as tckpt, harness as tharness
from iadmm_tpu_torch.train.early_stopping import EarlyStopping

from torch_bridge import (assert_close, jax_lstm_params, params_to_torch,
                          to_torch)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILY_CASES = [("QP", 12, 6, 6), ("QP_RHS", 12, 6, 6), ("Random_QP", 12, 8, 0),
                ("Equality_QP", 12, 0, 6), ("SVM", 12, 6, 0),
                ("Portfolio", 12, 4, 0)]


# ----------------------------------------------------------------- config

def test_config_is_strict_and_has_the_jax_fields():
    with pytest.raises(ValueError, match="typo"):
        tconfig.ExperimentConfig.from_dict({"typo": 1})
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.ExperimentConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.ExperimentConfig)}
    assert jf == tf


@pytest.mark.parametrize("prob_type", ["QP", "QP_RHS", "Random_QP",
                                       "Equality_QP", "SVM", "QPLIB",
                                       "Portfolio", "MM_HS35", "Sparse_QP"])
def test_run_name_matches_jax(prob_type):
    kw = dict(prob_type=prob_type, num_var=30, num_ineq=7, num_eq=5,
              qplib_num=8790, outer_T=40, hidden_dim=24)
    assert (tconfig.ExperimentConfig(**kw).run_name()
            == jconfig.ExperimentConfig(**kw).run_name())


@pytest.mark.parametrize("path", sorted(glob.glob(str(ROOT / "configs" / "*.yaml"))),
                         ids=lambda p: pathlib.Path(p).name)
def test_yaml_configs_load_equal(path):
    a = tconfig.ExperimentConfig.from_yaml(path).to_dict()
    b = jconfig.ExperimentConfig.from_yaml(path).to_dict()
    assert a == b


def test_unported_config_values_raise():
    for kw in (dict(num_devices=2), dict(model_devices=2),
               dict(num_devices=2, sparse=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tconfig.ExperimentConfig(**kw).check_ported()
    # the BCOO route, the theory traces and the ghost cells are ported
    for kw in (dict(sparse=True), dict(theory=True),
               dict(model_name="indirect_lstm")):
        tconfig.ExperimentConfig(**kw).check_ported()
    # dispatch and placement only: accepted
    tconfig.ExperimentConfig(epoch_scan=False, preload="always").check_ported()
    # the bf16 train stack is ported; an unknown storage dtype is an error
    tconfig.ExperimentConfig(preload_dtype="bfloat16").check_ported()
    with pytest.raises(ValueError, match="preload_dtype"):
        tconfig.ExperimentConfig(preload_dtype="float16").check_ported()


# ------------------------------------------------------------- data layer

@pytest.mark.parametrize("args", [(1000, 0.01, 0.05, 17), (16, 0.125, 0.0, 3),
                                  (37, 0.2, 0.1, 5)])
def test_split_ids_match_jax(args):
    for a, b in zip(tio.split_ids(*args), jio.split_ids(*args)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("prob_type,n,mi,me", [FAMILY_CASES[0],
                                               FAMILY_CASES[4]])
def test_npz_files_read_by_both_packages(tmp_path, prob_type, n, mi, me):
    ds = jgen.generate(prob_type, num_var=n, num_ineq=mi, num_eq=me,
                       data_size=3, seed=4)
    pj = tio.dataset_path(str(tmp_path / "j"), prob_type, n, mi, me)
    assert pj == jio.dataset_path(str(tmp_path / "j"), prob_type, n, mi, me)
    jio.save_npz(ds, pj)
    pt = tio.dataset_path(str(tmp_path / "t"), prob_type, n, mi, me)
    tio.save_npz(ds, pt)
    for a, b in ((tio.load_dataset(str(tmp_path / "j"), prob_type, n, mi, me),
                  jio.load_npz(pt)),):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                assert x == y, f.name
    with pytest.raises(FileNotFoundError):   # no QPLIB_1 directory here
        tio.load_dataset(str(tmp_path), "QPLIB", qplib_num=1)


@pytest.mark.parametrize("prob_type,n,mi,me", FAMILY_CASES)
def test_violation_stats_match_jax(prob_type, n, mi, me):
    ds = jgen.generate(prob_type, num_var=n, num_ineq=mi, num_eq=me,
                       data_size=3, seed=7)
    jdata = jio.to_qp_batch(ds)
    tdata = tio.to_qp_batch(ds, device="cpu")
    x = np.random.default_rng(1).standard_normal(
        (3, jdata.num_var)).astype(np.float32)
    jv = jmetrics.violation_stats(jnp.asarray(x), jdata)
    tv = tmetrics.violation_stats(torch.as_tensor(x), tdata)
    assert set(jv) == set(tv)
    for k in jv:
        assert_close(tv[k], jv[k], 1e-5, 1e-6, k)


# ---------------------------------------------------------------- training

def _f64_problem(seed=0, B=2, n=8, mi=4, me=4, h=6, K=6):
    ds = jgen.generate("QP", num_var=n, num_ineq=mi, num_eq=me, data_size=B,
                       seed=seed)
    jdata = jio.to_qp_batch(ds, dtype=jnp.float64)
    tdata = to_torch(jdata, dtype=torch.float64)
    jp = jax_lstm_params(seed, h, K, dtype=jnp.float64)
    jp = {k: (v * 20 if k == "U" else v) for k, v in jp.items()}
    rng = np.random.default_rng(seed)
    S = n + mi + me
    st = jit_.IterState(*(jnp.asarray(0.1 * rng.standard_normal(s))
                          for s in ((B, n), (B, mi + me), (B, mi + me),
                                    (B, S), (B, S, h), (B, S, h))))
    return jdata, tdata, jp, st


@pytest.mark.parametrize("remat", [False, True])
def test_chunk_loss_matches_jax_f64(remat):
    jdata, tdata, jp, jst = _f64_problem()
    t0, chunk, outer_T, sigma = 2, 3, 6, 1e-3

    def jloss(p):
        return jroll.chunk_loss(jstep.lstm_step, p, jst, jdata, sigma, chunk,
                                outer_T, t0)

    (jl, jfinal), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tp = {k: v.requires_grad_(True)
          for k, v in params_to_torch(jp, dtype=torch.float64).items()}
    tl, tfinal = troll.chunk_loss(tstep.lstm_step, tp,
                                  to_torch(jst, dtype=torch.float64), tdata,
                                  sigma, chunk, outer_T, t0, remat=remat)
    tl.backward()
    assert_close(tl.detach(), jl, 1e-10, 1e-12, "loss")
    assert_close(tfinal.x, jfinal.x, 1e-10, 1e-12, "x")
    for k in jg:
        assert_close(tp[k].grad, jg[k], 1e-9, 1e-11, k)


def test_optimizer_matches_optax():
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in (("W", (2, 8)), ("U", (2, 8)), ("rho", (5,)))}
    grads = [{k: (3.0 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jopt = jharness.make_optimizer(1e-2, weight_decay=1e-2,
                                   clip_grad_norm=4.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = jopt.init(jp)
    tp = {k: torch.as_tensor(v).requires_grad_(True)
          for k, v in params.items()}
    topt = tharness.make_optimizer(tp, 1e-2, weight_decay=1e-2,
                                   clip_grad_norm=4.0)
    for g in grads:
        upd, state = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                 state, jp)
        jp = optax.apply_updates(jp, upd)
        topt.zero_grad()
        for k, p in tp.items():
            p.grad = torch.as_tensor(g[k])
        topt.step()
    for k in params:
        assert_close(tp[k].detach(), jp[k], 0, 1e-6, k)


def _tiny_train_problem(B=2, n=12, mi=6, me=6, h=8, K=6):
    ds = jgen.generate("QP", num_var=n, num_ineq=mi, num_eq=me, data_size=B,
                       seed=9)
    jdata = jio.to_qp_batch(ds)
    jp = jax_lstm_params(5, h, K)
    jp = {k: (v * 20 if k == "U" else v) for k, v in jp.items()}
    return ds, jdata, jp


def test_fused_chunk_updates_match_jax_harness():
    """Two chunk updates (t0 = 0, 3) with the fused loss from the same
    params: the port's make_train_chunk against the JAX harness's, float32
    compute.  Params after each update to 5% of one Adam step (lr): Adam
    divides each gradient element by its own magnitude, so an element whose
    gradient is near zero turns float32 rounding into a visible part of
    its step."""
    B, n, m, h, chunk, outer_T, sigma, lr = 2, 12, 12, 8, 3, 6, 6e-6, 1e-3
    ds, jdata, jp = _tiny_train_problem(B, n, 6, 6, h, outer_T)
    kw = dict(num_var=n, num_constr=m, batch=B, hidden=h, sigma=sigma,
              chunk_len=chunk, outer_T=outer_T, K_total=outer_T,
              compute_dtype="float32")
    jopt = jharness.make_optimizer(lr)
    jchunk = jharness.make_train_chunk(None, jopt, outer_T, chunk, sigma,
                                       loss_fn=j_fused(interpret=True,
                                                       stream=True, **kw))
    tp = {k: v.requires_grad_(True)
          for k, v in params_to_torch(jp, dtype=torch.float32).items()}
    tchunk = tharness.make_train_chunk(None, tharness.make_optimizer(tp, lr),
                                       outer_T, chunk, sigma,
                                       loss_fn=make_fused_chunk_loss(**kw))
    jparams, jstate = dict(jp), jopt.init(jp)
    jst = jit_.init_state(B, n, m, h)
    tst = to_torch(jst)
    tdata = to_torch(jdata, dtype=torch.float32)
    for t0 in (0, chunk):
        jparams, jstate, jst, jl = jchunk(jparams, jstate, jst, jdata,
                                          jnp.asarray(t0, jnp.int32))
        tst, tl = tchunk(tp, tst, tdata, t0)
        assert_close(tl, jl, 1e-5, 1e-7, f"loss t0={t0}")
        for k in jparams:
            assert_close(tp[k].detach(), jparams[k], 0, 5e-2 * lr,
                         f"{k} t0={t0}")
        assert_close(tst.x, jst.x, 2e-4, 2e-5, f"state t0={t0}")


def test_early_stopping_decisions_match_jax():
    rng = np.random.default_rng(2)
    seq = [(float(rng.normal()), [float(abs(rng.normal())) * 0.3])
           for _ in range(30)]
    saves = {"j": 0, "t": 0}
    j = JEarly(patience=4, save_fn=lambda: saves.__setitem__("j", saves["j"] + 1))
    t = EarlyStopping(patience=4,
                      save_fn=lambda: saves.__setitem__("t", saves["t"] + 1))
    for mode in ("min", "max"):
        for loss, vios in seq:
            assert j.step(loss, mode, 0.2, vios) == t.step(loss, mode, 0.2,
                                                           vios)
            assert (j.best_loss, j.counter) == (t.best_loss, t.counter)
    assert saves["j"] == saves["t"] > 0


def test_checkpoints_cross_both_packages_and_serve(tmp_path):
    ds, jdata, jp = _tiny_train_problem()
    # JAX writes (optax state inside), the port reads and serves
    jpath = str(tmp_path / "jax.pkl")
    jckpt.save_checkpoint(jpath, {
        "params": jp, "opt_state": jharness.make_optimizer(1e-3).init(jp),
        "epoch": 3, "best": {"val_obj": 1.5, "counter": 0},
        "config": {"hidden_dim": 8}})
    got = tckpt.load_checkpoint(jpath)
    assert got["epoch"] == 3 and got["best"]["val_obj"] == 1.5
    tp = {k: torch.as_tensor(got["params"][k]) for k in jp}
    # the port writes, JAX reads
    ppath = str(tmp_path / "port.pkl")
    opt = tharness.make_optimizer(
        {k: v.clone().requires_grad_(True) for k, v in tp.items()}, 1e-3)
    tckpt.save_checkpoint(ppath, {"params": tp,
                                  "opt_state": opt.state_arrays(),
                                  "epoch": 4, "config": {"hidden_dim": 8}})
    back = jckpt.load_checkpoint(ppath)
    assert back["epoch"] == 4
    for k in jp:
        np.testing.assert_array_equal(back["params"][k], np.asarray(jp[k]))
    with pytest.raises(ValueError, match="pkl"):
        tckpt.load_checkpoint(str(tmp_path))
    kw = dict(hidden_dim=8, num_iters=6, feas_rest_num=5)
    tdata = to_torch(jdata, dtype=torch.float32)
    served = make_solver(tp, **kw)(tdata)
    direct = make_solver(params_to_torch(jp, dtype=torch.float32), **kw)(tdata)
    assert torch.isfinite(served.x).all()
    assert torch.equal(served.x, direct.x)


def test_loading_a_jax_checkpoint_imports_no_jax(tmp_path):
    _, _, jp = _tiny_train_problem()
    path = str(tmp_path / "jax.pkl")
    jckpt.save_checkpoint(path, {"params": jp, "epoch": 1,
                                 "opt_state": optax.adam(1e-3).init(jp)})
    code = ("import sys\nbefore = set(sys.modules)\n"
            "from iadmm_tpu_torch.train.checkpoint import load_checkpoint\n"
            f"d = load_checkpoint({path!r})\n"
            "assert d['epoch'] == 1 and 'U' in d['params']\n"
            "new = set(sys.modules) - before\n"
            "bad = sorted(m for m in new if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'iadmm_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _train_cfg(tmp_path, backend, **kw):
    base = dict(prob_type="QP", num_var=12, num_ineq=6, num_eq=6,
                data_size=8, hidden_dim=8, outer_T=6, truncated_length=3,
                batch_size=2, lr=5e-3, num_epoch=3, val_frac=0.25,
                test_frac=0.0, eq_tol=1e9, num_devices=1, scaling=False,
                preload="never", train_backend=backend, matvec_mode="bf16",
                save_dir=str(tmp_path))
    base.update(kw)
    return tconfig.ExperimentConfig(**base)


@pytest.mark.parametrize("backend", ["fused", "step"])
def test_train_end_to_end_and_resume(tmp_path, backend):
    ds = jgen.generate("QP", num_var=12, num_ineq=6, num_eq=6, data_size=8,
                       seed=3)
    cfg = _train_cfg(tmp_path, backend)
    res = tharness.train(cfg, ds, verbose=False, device="cpu")
    losses = [h["train_loss"] for h in res.history]
    assert all(np.isfinite(l) for l in losses)
    assert losses[-1] < losses[0]
    assert res.checkpoint_path and pathlib.Path(res.checkpoint_path).exists()
    latest = tckpt.latest_path(res.checkpoint_path)
    assert tckpt.load_checkpoint(latest)["epoch"] == 2
    cfg2 = dataclasses.replace(cfg, resume=True, num_epoch=5)
    res2 = tharness.train(cfg2, ds, verbose=False, device="cpu")
    assert [h["epoch"] for h in res2.history] == [3, 4]
    assert all(np.isfinite(h["train_loss"]) for h in res2.history)


def test_cli_trains_from_a_jax_written_npz(tmp_path, capsys):
    ds = jgen.generate("QP", num_var=12, num_ineq=6, num_eq=6, data_size=8,
                       seed=3)
    root = str(tmp_path / "data")
    jio.save_npz(ds, jio.dataset_path(root, "QP", 12, 6, 6))
    args = ["--prob_type", "QP", "--num_var", "12", "--num_ineq", "6",
            "--num_eq", "6", "--data_size", "8", "--hidden_dim", "8",
            "--outer_T", "6", "--truncated_length", "3", "--num_epoch", "2",
            "--val_frac", "0.25", "--test_frac", "0", "--eq_tol", "1e9",
            "--train_backend", "fused", "--gate_dtype", "bfloat16",
            "--matvec_mode", "bf16", "--data_root", root,
            "--save_dir", str(tmp_path / "out"), "--device", "cpu"]
    assert tcli.main(args) == 0
    assert "done: 2 epochs" in capsys.readouterr().out
    # --generate leaves an existing dataset alone
    assert tcli.main(args + ["--generate"]) == 0
    out = capsys.readouterr().out
    assert "done: 2 epochs" in out and "oracle" not in out


def _recovery_cfg(tmp_path, **kw):
    """The JAX package's tests/test_harness_recovery.py configuration."""
    base = dict(prob_type="QP", num_var=12, num_ineq=6, num_eq=6,
                data_size=20, hidden_dim=8, outer_T=4, truncated_length=2,
                batch_size=2, lr=2e-3, num_epoch=3, val_frac=0.1,
                test_frac=0.0, eq_tol=1e9, num_devices=1, scaling=True,
                save_dir=str(tmp_path))
    base.update(kw)
    return tconfig.ExperimentConfig(**base)


def test_loss_spike_rolls_back_to_gated_checkpoint(tmp_path):
    ds = jgen.generate("QP", num_var=12, num_ineq=6, num_eq=6, data_size=20,
                       seed=3)
    # a factor of 1e-6: every epoch after the first gated one is a "spike"
    cfg = _recovery_cfg(tmp_path, num_epoch=4, spike_rollback_factor=1e-6)
    res = tharness.train(cfg, ds, verbose=False, device="cpu")
    log = pathlib.Path(tmp_path, cfg.model_name, cfg.run_name() + ".log.jsonl")
    assert '"spike_rollback"' in log.read_text()
    assert any(h.get("rollback") for h in res.history)
    assert res.epochs_run == cfg.num_epoch
    assert all(np.isfinite(h["train_loss"]) for h in res.history)


def test_latest_checkpoint_resume_without_a_gated_one(tmp_path):
    ds = jgen.generate("QP", num_var=12, num_ineq=6, num_eq=6, data_size=20,
                       seed=3)
    cfg = _recovery_cfg(tmp_path, num_epoch=2, eq_tol=0.0)  # never gated
    assert tharness.train(cfg, ds, verbose=False,
                          device="cpu").checkpoint_path is None
    cfg2 = _recovery_cfg(tmp_path, num_epoch=4, eq_tol=0.0, resume=True)
    res = tharness.train(cfg2, ds, verbose=False, device="cpu")
    assert [h["epoch"] for h in res.history] == [2, 3]
    assert res.epochs_run == 4
