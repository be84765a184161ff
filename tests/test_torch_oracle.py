"""The port's QP oracle and dataset generation against the JAX package, on
the CPU.

The native solver (the same C++ source built with the same flags: equal
arrays expected and asserted), the Python ``solve_qp`` (the same numpy
code: equal arrays), ``label_dataset`` on each backend (the same solved
ids and labels), the library build (atomic under concurrent builds),
``cli/generate_data`` (an ``.npz`` that the JAX ``load_npz`` reads equal to
the JAX CLI's), ``cli/train --generate`` and ``run_osqp_baseline`` on both
routes, including ``cli/test --baseline osqp``.
"""

import ctypes
import os
import pathlib
import threading

import numpy as np
import pytest
import torch

import iadmm_tpu as jit_
from iadmm_tpu import native as jnative
from iadmm_tpu.cli import generate_data as jgen_cli
from iadmm_tpu.evaluation import driver as jdriver
from iadmm_tpu.problems import generators as jgen, io as jio
from iadmm_tpu.problems import oracle as joracle

from iadmm_tpu_torch import config as tconfig
from iadmm_tpu_torch import native as tnative
from iadmm_tpu_torch.cli import generate_data as tgen_cli
from iadmm_tpu_torch.cli import test as ttest_cli, train as ttrain_cli
from iadmm_tpu_torch.evaluation import driver as tdriver
from iadmm_tpu_torch.problems import io as tio
from iadmm_tpu_torch.problems import oracle as toracle
from iadmm_tpu_torch.train import checkpoint as tckpt

from torch_bridge import jax_lstm_params, params_to_torch


def _ds(prob_type="QP", size=6, seed=1, n=20, mi=10, me=10):
    return jgen.generate(prob_type, num_var=n, num_ineq=mi, num_eq=me,
                         data_size=size, seed=seed)


def _equal(a, b):
    for u, v in zip(a, b):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_native_library_builds_into_the_port():
    assert tnative.available()
    path = tnative.lib_path()
    assert path.parent.name == "_build" and path.parent.parent.name == \
        "iadmm_tpu_torch"
    assert path.exists()


@pytest.mark.parametrize("prob_type,n,mi,me", [
    ("QP", 20, 10, 10), ("QP_RHS", 20, 10, 10), ("Random_QP", 16, 12, 0),
    ("SVM", 12, 8, 0)])
def test_native_solver_equals_jax_native(prob_type, n, mi, me):
    ds = _ds(prob_type, size=5, seed=2, n=n, mi=mi, me=me)
    if ds.Q.shape[0] == 1:   # shared matrices, per-instance bounds
        args = (np.asarray(ds.Q[0], np.float64) * 2.0, ds.p[0], ds.A0[0],
                ds.zl, ds.zu)
    else:
        args = (ds.Q.astype(np.float64) * 2.0, ds.p, ds.A0, ds.zl, ds.zu)
    t = tnative.solve_qp_batch(*args, eps_abs=1e-5, eps_rel=1e-5)
    j = jnative.solve_qp_batch(*args, eps_abs=1e-5, eps_rel=1e-5)
    _equal(t, j)
    assert (t[3] == 0).all()


def test_native_solver_rejects_mismatched_shapes():
    ds = _ds(size=3)
    with pytest.raises(ValueError, match="A has shape"):
        tnative.solve_qp_batch(ds.Q * 2.0, ds.p, ds.A0[:2], ds.zl, ds.zu)


def test_python_solve_qp_equals_jax():
    ds = _ds(size=2, seed=3)
    for i in range(2):
        args = (ds.Q[i] * 2.0, ds.p[i], ds.A0[i], ds.zl[i], ds.zu[i])
        t = toracle.solve_qp(*args, eps_abs=1e-5, eps_rel=1e-5)
        j = joracle.solve_qp(*args, eps_abs=1e-5, eps_rel=1e-5)
        assert t.solved and j.solved and t.iters == j.iters
        _equal((t.x, t.y, t.pri_res, t.dua_res),
               (j.x, j.y, j.pri_res, j.dua_res))
    warm = toracle.solve_qp(*args, x0=t.x, y0=t.y)
    assert warm.solved and warm.iters < t.iters


@pytest.mark.parametrize("backend", ["native", "python", "auto"])
def test_label_dataset_matches_jax(backend):
    ds_t, ds_j = _ds(size=5, seed=4), _ds(size=5, seed=4)
    ids_t = toracle.label_dataset(ds_t, eps=1e-4, backend=backend)
    ids_j = joracle.label_dataset(ds_j, eps=1e-4, backend=backend)
    np.testing.assert_array_equal(ids_t, ids_j)
    assert len(ids_t) == 5
    _equal((ds_t.x_opt, ds_t.y_opt), (ds_j.x_opt, ds_j.y_opt))


def test_auto_backend_without_the_native_library(monkeypatch):
    """'auto' falls back to osqp where it is installed, else to python."""
    monkeypatch.setattr(tnative, "available", lambda: False)
    ds_a, ds_b = _ds(size=3, seed=8), _ds(size=3, seed=8)
    ids_a = toracle.label_dataset(ds_a, eps=1e-4, backend="auto")
    ids_b = toracle.label_dataset(
        ds_b, eps=1e-4, backend="osqp" if toracle.HAVE_OSQP else "python")
    np.testing.assert_array_equal(ids_a, ids_b)
    _equal((ds_a.x_opt, ds_a.y_opt), (ds_b.x_opt, ds_b.y_opt))


def test_library_name_keys_the_host(monkeypatch):
    """A library built for one CPU (``-march=native``) is never loaded on
    another: the name hashes what ``-march=native`` selects here."""
    here = tnative.lib_path()
    monkeypatch.setattr(tnative, "_host_target",
                        lambda: b"-march= another-cpu")
    other = tnative.lib_path()
    assert other.parent == here.parent and other.name != here.name
    assert other.name.startswith("libqp_oracle-")


def test_concurrent_builds_are_atomic(tmp_path, monkeypatch):
    """Test workers can build at once: each compiles to its own temporary
    name and renames it into place, so a reader finds no partial file."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    path = tnative.lib_path()
    errors = []

    def build():
        try:
            tnative._build(path)
        except Exception as e:   # collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors
    assert sorted(os.listdir(path.parent)) == [path.name]
    assert ctypes.CDLL(str(path)).iadmm_native_version() == 2


def test_generate_data_cli_matches_jax(tmp_path, capsys):
    args = ["--prob_type", "QP", "--num_var", "20", "--num_ineq", "10",
            "--num_eq", "10", "--data_size", "6", "--seed", "5"]
    assert tgen_cli.main(args + ["--data_root", str(tmp_path / "t")]) == 0
    assert jgen_cli.main(args + ["--data_root", str(tmp_path / "j")]) == 0
    assert "native oracle: 6/6 solved" in capsys.readouterr().out
    t = jio.load_npz(jio.dataset_path(str(tmp_path / "t"), "QP", 20, 10, 10))
    j = jio.load_npz(jio.dataset_path(str(tmp_path / "j"), "QP", 20, 10, 10))
    for f in ("Q", "p", "A0", "zl", "zu", "G", "c", "A", "b", "x_opt",
              "y_opt"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)


def _cli_args(root, save_dir):
    return ["--prob_type", "QP", "--num_var", "12", "--num_ineq", "6",
            "--num_eq", "6", "--data_size", "10", "--hidden_dim", "8",
            "--outer_T", "4", "--truncated_length", "2", "--num_epoch", "1",
            "--val_frac", "0.2", "--test_frac", "0.2", "--eq_tol", "1e9",
            "--test_outer_T", "4", "--test_batch_size", "2",
            "--matvec_mode", "bf16", "--preload_dtype", "bfloat16",
            "--data_root", root, "--save_dir", save_dir, "--device", "cpu"]


def test_train_cli_generates_then_test_cli_baseline(tmp_path, capsys):
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    args = _cli_args(root, out)
    assert ttrain_cli.main(args + ["--generate"]) == 0
    printed = capsys.readouterr().out
    assert "native oracle: 10/10 solved" in printed
    assert "(diagonal-Q storage)" in printed and "done: 1 epochs" in printed
    ds = tio.load_npz(tio.dataset_path(root, "QP", 12, 6, 6))
    assert ds.size == 10 and ds.x_opt.shape == (10, 12)
    assert ttest_cli.main(args + ["--baseline", "osqp"]) == 0
    printed = capsys.readouterr().out
    assert "Parallel Time" in printed
    assert "OSQP-baseline (native batch): 2/2 solved" in printed


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("prob_type", ["QP", "QP_RHS"])
def test_osqp_baseline_matches_jax(backend, prob_type):
    ds = _ds(prob_type, size=10, seed=6, n=12, mi=6, me=6)
    kw = dict(prob_type=prob_type, num_var=12, num_ineq=6, num_eq=6,
              data_size=10, val_frac=0.2, test_frac=0.3)
    t = tdriver.run_osqp_baseline(tconfig.ExperimentConfig(**kw), ds,
                                  verbose=False, backend=backend)
    j = jdriver.run_osqp_baseline(jit_.ExperimentConfig(**kw), ds,
                                  verbose=False, backend=backend)
    assert set(t) == set(j)
    assert t["total"] == j["total"] == 3 and t["solved"] == j["solved"] == 3
    for k in ("mean_iters", "mean_obj"):
        assert t[k] == j[k], k
    assert t["mean_time"] > 0
    assert t.get("backend") == j.get("backend")


def test_baseline_after_a_trained_checkpoint(tmp_path, capsys):
    """``cli/test.py --baseline osqp`` on a JAX-written checkpoint: the
    learned route's table, then the baseline on the same test split."""
    ds = _ds(size=10, seed=7, n=12, mi=6, me=6)
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    tio.save_npz(ds, tio.dataset_path(root, "QP", 12, 6, 6))
    cfg = tconfig.ExperimentConfig(prob_type="QP", num_var=12, num_ineq=6,
                                   num_eq=6, outer_T=4, hidden_dim=8,
                                   save_dir=out)
    path = tckpt.checkpoint_path(out, cfg.model_name, cfg.run_name())
    tckpt.save_checkpoint(path, {"params": params_to_torch(
        jax_lstm_params(1, 8, 4), dtype=torch.float32), "epoch": 0})
    assert ttest_cli.main(_cli_args(root, out) + [
        "--baseline", "osqp", "--feas_rest", "--feas_rest_num", "3"]) == 0
    printed = capsys.readouterr().out
    assert "Stage II" in printed and "OSQP-baseline" in printed
    assert pathlib.Path(path).exists()
