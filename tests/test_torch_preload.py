"""The port's dense train-stack preload against the JAX package, on the CPU.

The stack leaf by leaf (QP dense and diagonal-Q, each in float32 and
bfloat16, and QP_RHS's shared leaves) against ``preload_train_stack`` of
the JAX package; ``dataset_q_is_diagonal``, ``train_stack_bytes`` and
``_index_batch``; one or two epochs of ``train()`` against the JAX harness
from the same initial parameters; and the port's preload against its own
per-batch route (``preload='never'``), as ``tests/test_preload.py`` holds
the JAX package.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iadmm_tpu.config import ExperimentConfig as JConfig
from iadmm_tpu.problems import generators as jgen
from iadmm_tpu.scaling import scale_batch as jscale
from iadmm_tpu.train import harness as jharness

from iadmm_tpu_torch import config as tconfig
from iadmm_tpu_torch.scaling import scale_batch as tscale
from iadmm_tpu_torch.solvers import step as tstep
from iadmm_tpu_torch.train import harness as tharness
from iadmm_tpu_torch.train import preload as tpre

from torch_bridge import assert_close, jax_lstm_params, params_to_torch

# Port vs JAX on the same scaled leaf: the two Ruiz implementations round
# alike to 1e-6; a bf16 leaf may round the other way at a tie, one bf16 ulp
# (2^-8 of the value).
F32_RTOL, BF16_RTOL = 1e-5, 2.0 ** -8
LEAVES = ("Q", "p", "A0", "zl", "zu", "eq_mask")


def _ds(prob_type="QP", size=16, seed=7, n=12, mi=6, me=6):
    return jgen.generate(prob_type, num_var=n, num_ineq=mi, num_eq=me,
                         data_size=size, seed=seed)


def _cfg(cls, **kw):
    base = dict(prob_type="QP", num_var=12, num_ineq=6, num_eq=6,
                data_size=44, hidden_dim=8, outer_T=4, truncated_length=2,
                batch_size=2, lr=1e-3, num_epoch=1, val_frac=0.1,
                test_frac=0.1, eq_tol=1e9, log_every=100, num_devices=1,
                epoch_scan=False)
    base.update(kw)
    return cls(**base)


def _stacks(ds, cfg_kw, diag_q, n_batches=8, B=2):
    ids = np.arange(n_batches * B)[::-1].copy()
    jcfg, tcfg = _cfg(JConfig, **cfg_kw), _cfg(tconfig.ExperimentConfig,
                                               **cfg_kw)
    jst, jcost = jharness.preload_train_stack(
        ds, ids, n_batches, B, jcfg,
        jax.jit(partial(jscale, iters=jcfg.scaling_ites)), diag_q=diag_q)
    tst, tcost = tpre.preload_train_stack(
        ds, ids, n_batches, B, tcfg, partial(tscale,
                                             iters=tcfg.scaling_ites),
        device="cpu", diag_q=diag_q)
    return jst, jcost, tst, tcost


@pytest.mark.parametrize("diag_q", [False, True], ids=["dense", "diag"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stack_matches_jax_leaf_by_leaf(dtype, diag_q):
    ds = _ds(size=20)
    jst, jcost, tst, tcost = _stacks(ds, dict(preload_dtype=dtype), diag_q)
    store = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for k in LEAVES:
        j, t = getattr(jst, k), getattr(tst, k)
        assert tuple(t.shape) == tuple(j.shape), k
        want = (torch.float32 if k == "Q" and diag_q else store) \
            if k in ("Q", "A0") else (torch.bool if k == "eq_mask"
                                      else torch.float32)
        assert t.dtype == want, (k, t.dtype)
        if k == "eq_mask":
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            continue
        rtol = BF16_RTOL if t.dtype == torch.bfloat16 else F32_RTOL
        assert_close(t, j, rtol, 1e-7, k)
    assert tst.Q.dim() == (3 if diag_q else 4)
    assert tuple(tcost.shape) == (8, 2)
    assert_close(tcost, jcost, F32_RTOL, 0, "cost")


def test_stack_shared_qp_rhs_matches_jax():
    ds = _ds("QP_RHS", size=20)
    assert ds.Q.shape[0] == 1
    for dtype in ("float32", "bfloat16"):
        jst, jcost, tst, tcost = _stacks(
            ds, dict(prob_type="QP_RHS", preload_dtype=dtype), True)
        for k in ("Q", "p", "A0"):   # the shared leaves stay (1, 1, ...)
            assert tuple(getattr(tst, k).shape[:2]) == (1, 1), k
        for k in LEAVES:
            t = getattr(tst, k)
            assert tuple(t.shape) == tuple(getattr(jst, k).shape), k
            rtol = BF16_RTOL if t.dtype == torch.bfloat16 else F32_RTOL
            assert_close(t.to(torch.float32), getattr(jst, k), rtol, 1e-7, k)
        assert tuple(tcost.shape) == (1, 1)
        assert_close(tcost, jcost, F32_RTOL, 0, "cost")
        # the shared leaves broadcast to the batch as views, not copies
        batch, cost = tpre.index_stack(tst, tcost, 3, 2)
        assert batch.Q.shape == (2, 12) and batch.Q.stride(0) == 0
        assert batch.A0.stride(0) == 0 and tuple(cost.shape) == (2,)


def test_diagonal_detection_and_bytes_match_jax():
    qp, rqp, rhs = _ds(), _ds("Random_QP", size=4, mi=20, me=0), \
        _ds("QP_RHS")
    for ds in (qp, rqp, rhs):
        assert (tpre.dataset_q_is_diagonal(ds)
                == jharness.dataset_q_is_diagonal(ds))
        for n_used, db, diag in ((16, 4, False), (16, 2, False),
                                 (10, 4, True), (16, 2, True)):
            assert (tpre.train_stack_bytes(ds, n_used, db, diag_q=diag)
                    == jharness.train_stack_bytes(ds, n_used, db,
                                                  diag_q=diag))
    assert tpre.dataset_q_is_diagonal(qp)
    assert not tpre.dataset_q_is_diagonal(rqp)


def test_index_batch_matches_jax():
    rng = np.random.default_rng(0)
    for shape in ((5, 3, 4), (1, 1, 4), (1, 1, 2, 3), (5, 3)):
        a = rng.standard_normal(shape).astype(np.float32)
        for bi in (0, 2):
            if shape[0] == 1 or bi < shape[0]:
                j = jharness._index_batch(jnp.asarray(a), bi, 3)
                t = tpre._index_batch(torch.as_tensor(a), bi, 3)
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_budget_env_and_cpu_fallback(monkeypatch):
    monkeypatch.setenv("IADMM_HBM_BYTES", "1e9")
    assert tpre.device_memory_budget("cpu") == 0.6e9
    monkeypatch.delenv("IADMM_HBM_BYTES")
    assert tpre.device_memory_budget("cpu") == jharness.device_memory_budget()


def _jax_init(monkeypatch, hidden, outer_T, seed=17):
    """Start the port's train() from the JAX harness's initial
    parameters (the two packages draw them from different generators)."""
    jp = jax_lstm_params(seed, hidden, outer_T)
    spec = tstep.get_cell("lstm")

    def init(gen, input_dim, h, T, device="cpu"):
        return params_to_torch(jp, dtype=torch.float32, device=device)

    monkeypatch.setattr(tharness, "get_cell",
                        lambda name: dataclasses.replace(spec, init=init))


def _train_both(monkeypatch, tmp_path, ds, **kw):
    jres = jharness.train(_cfg(JConfig, save_dir=str(tmp_path / "j"), **kw),
                          ds, verbose=False)
    _jax_init(monkeypatch, 8, 4)
    tres = tharness.train(_cfg(tconfig.ExperimentConfig,
                               save_dir=str(tmp_path / "t"), **kw), ds,
                          verbose=False, device="cpu")
    return jres.history, tres.history


# One epoch from the same parameters: 18 batches of 2 chunk updates in
# float32; the two packages' sums differ in order, so the histories agree
# to float32 rounding grown over 36 Adam steps (measured: at most 4.1e-6 of
# the loss; 7.0e-5 of the objectives, where the untrained QP objective
# cancels to 2.5e-4, 1.8e-8 absolute).
LOSS_RTOL, OBJ_RTOL, OBJ_ATOL = 2e-5, 1e-4, 1e-7


@pytest.mark.parametrize("family", ["QP", "Random_QP"],
                         ids=["diag-step", "dense-always"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_epoch_matches_jax_harness(monkeypatch, tmp_path, dtype, family):
    kw = dict(preload_dtype=dtype,
              matvec_mode="bf16" if dtype == "bfloat16" else "highest")
    if family == "QP":
        ds = _ds(size=44, seed=8)
        kw.update(preload="auto")   # diagonal-Q storage
    else:
        ds = _ds("Random_QP", size=44, seed=8, mi=10, me=0)
        kw.update(prob_type="Random_QP", num_ineq=10, num_eq=0,
                  preload="always")
    jh, th = _train_both(monkeypatch, tmp_path, ds, **kw)
    for a, b in zip(th, jh):
        assert np.isclose(a["train_loss"], b["train_loss"], rtol=LOSS_RTOL,
                          atol=0), (a, b)
        for k in ("train_obj", "val_obj"):
            assert np.isclose(a[k], b[k], rtol=OBJ_RTOL, atol=OBJ_ATOL), \
                (k, a, b)


def test_diag_q_auto_route_matches_jax_default(monkeypatch, tmp_path):
    """The JAX harness's default ('auto', step backend) preloads a QP
    dataset with diagonal-Q storage, whose matvec multiplies the float32
    diagonal with no bf16 rounding; under matvec_mode='bf16' the per-batch
    route rounds Q and the vector to bf16 in every matvec.  Before the
    port had the preload, it ran the per-batch route here.  With lr=0 the
    parameters stay at the JAX harness's initial ones, so the histories
    differ only by the route: 2 epochs of QP 12/6/6, h=8, outer_T=4, B=2
    gave a train objective 5.4e-4 (relative) from the JAX default on the
    parent commit, 3.4e-7 with the preload.  Held at 1e-5.  (With
    lr=1e-3, training amplifies both packages' float32 rounding to 1e-5
    by the second epoch, the size of the route's own gap there: 3.3e-5 in
    loss on the parent, 3.5e-6 with the preload, without JAX's float64
    mode.)"""
    ds = _ds(size=44, seed=3)
    jh, th = _train_both(monkeypatch, tmp_path, ds, num_epoch=2, lr=0.0,
                         matvec_mode="bf16", preload="auto")
    assert len(th) == len(jh) == 2
    for a, b in zip(th, jh):
        for k in ("train_obj", "train_loss", "val_obj"):
            assert np.isclose(a[k], b[k], rtol=1e-5, atol=0), (k, a, b)


def _port_train(tmp_path, ds, **kw):
    return tharness.train(_cfg(tconfig.ExperimentConfig,
                               save_dir=str(tmp_path), num_epoch=2, **kw),
                          ds, verbose=False, device="cpu").history


@pytest.mark.parametrize("family,rtol", [("QP", 1e-4), ("QP_RHS", 5e-3)])
def test_preload_matches_the_per_batch_route(tmp_path, family, rtol):
    """tests/test_preload.py's limits: 1e-4 for QP (the diagonal product
    against the dense one with exact zeros); 5e-3 for QP_RHS, whose stack
    applies the accumulated e vector to zl/zu once where the per-batch
    route scales them every Ruiz sweep."""
    ds = _ds(family, size=44, seed=4)
    kw = dict(prob_type=family)
    never = _port_train(tmp_path / "a", ds, preload="never", **kw)
    pre = _port_train(tmp_path / "b", ds, preload="always", **kw)
    assert len(pre) == len(never) == 2
    for a, b in zip(pre, never):
        for k in ("train_loss", "val_obj", "train_obj"):
            assert np.isclose(a[k], b[k], rtol=rtol), (k, a, b)


def test_preload_decision_and_record(tmp_path, capsys, monkeypatch):
    ds = _ds(size=44, seed=5)
    cfg = _cfg(tconfig.ExperimentConfig, save_dir=str(tmp_path),
               preload_dtype="bfloat16", matvec_mode="bf16")
    tharness.train(cfg, ds, verbose=True, device="cpu")
    out = capsys.readouterr().out
    assert "(diagonal-Q storage)" in out and "preloaded train split" in out
    # a budget below the stack's bytes sends 'auto' to the per-batch route
    monkeypatch.setenv("IADMM_HBM_BYTES", "10")
    cfg2 = dataclasses.replace(cfg, save_dir=str(tmp_path / "b"))
    tharness.train(cfg2, ds, verbose=True, device="cpu")
    out = capsys.readouterr().out
    assert "preloaded train split" not in out
    assert "over the preload budget: per-batch route" in out
    # the fused route keeps dense storage
    cfg3 = dataclasses.replace(cfg, save_dir=str(tmp_path / "c"),
                               train_backend="fused", preload="always")
    tharness.train(cfg3, ds, verbose=True, device="cpu")
    out = capsys.readouterr().out
    assert "preloaded train split" in out and "diagonal-Q" not in out
