"""The port's theory-condition traces against the JAX package, on the CPU.

``run_test(theory=True)`` against the JAX ``run_test`` on the same split
(every ``COND_KEYS`` trace, its shape, its t=0 NaN; tests/test_theory.py is
the model), with and without Ruiz scaling, the extreme eigenvalues, the
sparse route that skips the traces, ``aug_lagr`` alone (float64, 1e-12),
``export_traces``'s ``.mat`` keys and shapes against the JAX export, and
the theory rollout's iterates equal to the evaluation rollout's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

import iadmm_tpu as jit_
from iadmm_tpu.evaluation import driver as jdriver, metrics as jmetrics
from iadmm_tpu.evaluation.theory import COND_KEYS as J_COND_KEYS, \
    PER_INSTANCE_KEYS as J_PER_INSTANCE_KEYS
from iadmm_tpu.problems import generators as jgen, io as jio

from iadmm_tpu_torch import config as tconfig
from iadmm_tpu_torch.evaluation import driver as tdriver, \
    metrics as tmetrics, theory as ttheory
from iadmm_tpu_torch.problems import io as tio
from iadmm_tpu_torch.scaling import scale_batch as tscale
from iadmm_tpu_torch.solvers import rollouts as troll, step as tstep
from iadmm_tpu_torch.types import init_state

from torch_bridge import assert_close, jax_lstm_params, to_torch

T, H = 6, 8
# Port vs JAX, both float32: the traces are sums of augmented-Lagrangian
# terms in another order; RTOL of each value, ATOL of the trace's largest
# magnitude (x_cond_1 and z_cond_1 scale with 1/sigma_AA_min)
RTOL, ATOL_OF_MAX = 1e-4, 1e-5
# z_cond_2_left zeroes the z-gradient where the unscaled z equals zl or zu
# exactly.  The two packages' Ruiz vectors differ at float32 rounding, so
# through run_test with scaling the equality flips on some rows (an 11% gap
# measured); the key is held on identical scaled inputs instead
# (test_theory_rollout_matches_jax).
EXACT_EQ_KEYS = ("z_cond_2_left",)
# x_cond_1_left scales with 1/sigma_AA_min and z_cond_1_left with
# 1/sigma_AA_min^2.  The smallest eigenvalue of A0ᵀA0 comes from each
# package's own float32 product and eigensolver (2.5e-4 apart, relative,
# on one batch here); these two keys get RTOL plus twice that eigenvalue's relative
# gap between the packages, measured on the same matrix.
EIG_KEYS = ("x_cond_1_left", "z_cond_1_left")


def _sigma_aa_gap(jdata0):
    """Relative gap of sigma_AA_min between the packages on instance 0."""
    A00 = jnp.asarray(jdata0.A0[0], jnp.float32)
    j = float(jnp.linalg.eigvalsh(A00.T @ A00)[0])
    t = float(ttheory.extreme_eigs(to_torch(jdata0))[1])
    return abs(t - j) / abs(j)


def _assert_trace(t, j, k, eig_gap):
    rtol = RTOL + (2 * eig_gap if k in EIG_KEYS else 0.0)
    np.testing.assert_allclose(t, j, rtol=rtol,
                               atol=ATOL_OF_MAX * np.abs(j).max(), err_msg=k)


def _ds():
    return jgen.generate("QP", num_var=10, num_ineq=5, num_eq=5,
                         data_size=10, seed=4)


def _cfg(tmp_path, **kw):
    base = dict(prob_type="QP", num_var=10, num_ineq=5, num_eq=5,
                data_size=10, hidden_dim=H, outer_T=T, test_outer_T=T,
                test_batch_size=2, val_frac=0.1, test_frac=0.4, eq_tol=1e9,
                num_devices=1, scaling=True, theory=True,
                save_dir=str(tmp_path))
    base.update(kw)
    return base


def _params():
    return {k: np.asarray(v) for k, v in jax_lstm_params(0, H, T).items()}


def _test_ids(cfg):
    return jio.split_ids(cfg["data_size"], cfg["val_frac"], cfg["test_frac"],
                         cfg["seed"] if "seed" in cfg else 17)[2]


def _both(tmp_path, **kw):
    """(JAX report, port report, the sigma_AA_min gap over the test
    batches' first instances)."""
    ds, p = _ds(), _params()
    cfg = _cfg(tmp_path, **kw)
    jrep = jdriver.run_test(jit_.ExperimentConfig(**cfg), ds, p,
                            verbose=False)
    trep = tdriver.run_test(tconfig.ExperimentConfig(**cfg), ds, p,
                            verbose=False, device="cpu")
    ids = _test_ids(cfg)
    bs = cfg["test_batch_size"]
    gap = max(_sigma_aa_gap(jio.to_qp_batch(ds, ids[i:i + bs]))
              for i in range(0, len(ids) - bs + 1, bs))
    return jrep, trep, gap


def test_cond_keys_match_jax():
    assert ttheory.COND_KEYS == J_COND_KEYS
    assert ttheory.PER_INSTANCE_KEYS == J_PER_INSTANCE_KEYS


@pytest.mark.parametrize("scaling", [True, False])
def test_run_test_theory_matches_jax(tmp_path, scaling):
    jrep, trep, gap = _both(tmp_path, scaling=scaling)
    assert trep.theory is not None and jrep.theory is not None
    assert set(trep.theory) == set(jrep.theory) == set(ttheory.COND_KEYS)
    for k in ttheory.COND_KEYS:
        t, j = trep.theory[k], np.asarray(jrep.theory[k])
        want = (T, 4) if k in ttheory.PER_INSTANCE_KEYS else (T,)
        assert t.shape == j.shape == want, k
        assert np.isnan(t[0]).all(), f"{k}[0] is not NaN"
        assert np.isfinite(t[1:]).all(), k
        if scaling and k in EXACT_EQ_KEYS:
            continue
        _assert_trace(t[1:], j[1:], k, gap)


def test_extreme_eigs_match_jax():
    ds = _ds()
    jdata = jio.to_qp_batch(ds, np.arange(2))
    q, aa = ttheory.extreme_eigs(to_torch(jdata))
    Q0 = jdata.Q[0].astype(jnp.float32)
    A00 = jdata.A0[0].astype(jnp.float32)
    np.testing.assert_allclose(float(q), float(jnp.linalg.eigvalsh(Q0)[-1]),
                               rtol=1e-5)
    np.testing.assert_allclose(
        float(aa), float(jnp.linalg.eigvalsh(A00.T @ A00)[0]), rtol=1e-3,
        atol=1e-6 * float(jnp.linalg.eigvalsh(A00.T @ A00)[-1]))


def test_sparse_route_skips_theory(tmp_path):
    """As the JAX driver: the theory traces run on the dense route only."""
    ds = jgen.generate("Sparse_QP", num_var=24, num_ineq=12, data_size=10,
                       seed=9, bandwidth=3)
    kw = _cfg(tmp_path, prob_type="Sparse_QP", num_var=24, num_ineq=12,
              num_eq=0, sparse=True)
    trep = tdriver.run_test(tconfig.ExperimentConfig(**kw), ds, _params(),
                            verbose=False, device="cpu")
    assert trep.theory is None
    assert np.isfinite(trep.primal_res).all()


def test_aug_lagr_matches_jax_f64():
    rng = np.random.default_rng(3)
    B, n, m = 3, 7, 5
    Q = rng.standard_normal((B, n, n))
    Q = Q @ Q.transpose(0, 2, 1)
    args = (rng.standard_normal((B, n)), rng.standard_normal((B, m)),
            rng.standard_normal((B, m)), Q, rng.standard_normal((B, n)),
            rng.standard_normal((B, m, n)), rng.random((B, m)) + 0.1)
    j = jmetrics.aug_lagr(*(jnp.asarray(a) for a in args))
    t = tmetrics.aug_lagr(*(torch.as_tensor(a) for a in args))
    assert t.shape == (B,)
    assert_close(t, j, 1e-12, 1e-12, "aug_lagr")
    # diagonal Q storage: the same value as the dense diagonal matrix
    qd = np.abs(rng.standard_normal((B, n)))
    dense = list(args)
    dense[3] = np.stack([np.diag(r) for r in qd])
    diag = list(args)
    diag[3] = qd
    assert_close(tmetrics.aug_lagr(*(torch.as_tensor(a) for a in diag)),
                 tmetrics.aug_lagr(*(torch.as_tensor(a) for a in dense)),
                 1e-12, 1e-12, "aug_lagr diag")


def test_export_traces_mat_matches_jax(tmp_path):
    jrep, trep, gap = _both(tmp_path, scaling=False)
    jp, tp = str(tmp_path / "j.mat"), str(tmp_path / "t.mat")
    jdriver.export_traces(jrep, jp)
    tdriver.export_traces(trep, tp)
    jm, tm = scipy.io.loadmat(jp), scipy.io.loadmat(tp)
    keys = {k for k in jm if not k.startswith("__")}
    assert {k for k in tm if not k.startswith("__")} == keys
    for k in keys:
        assert tm[k].shape == jm[k].shape, k
    assert tm["x_cond_2_left"].shape == (T, 4)
    assert tm["x_cond_1_left"].shape == (1, T)
    assert tm["x_cond_1_right"].size == 0   # never produced: schema only
    for k in ttheory.COND_KEYS:   # t > 0: rows of (T, B), columns of (1, T)
        a, b = ((tm[k][1:], jm[k][1:]) if k in ttheory.PER_INSTANCE_KEYS
                else (tm[k][:, 1:], jm[k][:, 1:]))
        _assert_trace(a, b, k, gap)


@pytest.mark.parametrize("scaling", [True, False])
def test_theory_rollout_matches_jax(scaling):
    """Every trace, z_cond_2_left included, on the JAX package's scaled
    batch and Ruiz vectors."""
    from iadmm_tpu.evaluation.theory import theory_rollout as j_theory
    from iadmm_tpu.scaling import scale_batch as jscale
    from iadmm_tpu.solvers import step as jstep
    ds = _ds()
    jdata = jio.to_qp_batch(ds, np.arange(3))
    jscaled, jsc = jscale(jdata) if scaling else (jdata, None)
    jp = jax_lstm_params(0, H, T)
    jst = jit_.init_state(3, jdata.num_var, jdata.num_constr, H)
    jys = j_theory(jstep.lstm_step, jp, jst, jscaled, jdata, jsc,
                   jnp.float32(6e-6), T)
    tys = ttheory.theory_rollout(
        tstep.lstm_step, {k: torch.as_tensor(np.array(v))
                          for k, v in jp.items()},
        to_torch(jst), to_torch(jscaled), to_torch(jdata),
        to_torch(jsc) if scaling else None, 6e-6, T)
    for k in ttheory.COND_KEYS:
        t, j = tys[k].numpy(), np.asarray(jys[k])
        assert t.shape == j.shape, k
        assert np.isnan(t[0]).all() and np.isfinite(t[1:]).all(), k
        _assert_trace(t[1:], j[1:], k, _sigma_aa_gap(jdata))


def test_theory_rollout_iterates_equal_the_evaluation_rollout():
    """The theory rollout runs the evaluation's step on the same inputs:
    its iterates are the evaluation rollout's, bitwise."""
    ds = _ds()
    data = tio.to_qp_batch(ds, np.arange(3), device="cpu")
    scaled, sc = tscale(data)
    params = {k: torch.as_tensor(np.array(v)) for k, v in _params().items()}

    def recording(out):
        def step(*a):
            st = tstep.lstm_step(*a)
            out.append(st)
            return st
        return step

    ev, th = [], []
    st0 = init_state(3, data.num_var, data.num_constr, H, device="cpu")
    troll.eval_rollout(recording(ev), params, st0, scaled, data, sc, 6e-6, T)
    ys = ttheory.theory_rollout(recording(th), params, st0, scaled, data, sc,
                                6e-6, T)
    assert len(ev) == len(th) == T
    for a, b in zip(ev, th):
        for f in ("x", "y", "z", "xv", "H", "C"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert all(v.shape[0] == T for v in ys.values())
