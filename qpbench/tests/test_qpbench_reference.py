"""The plain reference against the port's plain twins at tiny sizes, and
the device generators against what they copy."""

import pytest
import torch

from qpbench.gen import qp as gen_qp, weights as gen_weights
from qpbench.reference import (adam, chunk, precision, residuals, rollout,
                               ruiz, serve, stage2)


def _data(seed=0, n=10, mi=4, me=3, count=3, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    d = gen_qp.pool(n, mi, me, count, g, "cpu")
    return {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in d.items()}


def _params(seed=1, h=6, K=5):
    return gen_weights.lstm(torch.Generator().manual_seed(seed), 2, h, K,
                            "cpu")


def _batch(d):
    from iadmm_tpu_torch.types import QPBatch
    return QPBatch(**{k: d[k] for k in ("Q", "p", "A0", "zl", "zu",
                                        "eq_mask")})


def test_weights_are_lstm_init_draws():
    from iadmm_tpu_torch.solvers.cells import lstm_init
    a = gen_weights.lstm(torch.Generator().manual_seed(3), 2, 8, 5, "cpu")
    b = lstm_init(torch.Generator().manual_seed(3), 2, 8, 5, device="cpu")
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_qp_pool_is_the_qp_family():
    d = _data(count=4, dtype=torch.float64)
    n, mi, me = 10, 4, 3
    Q = d["Q"]
    assert torch.equal(Q, torch.diag_embed(torch.diagonal(Q, 0, 1, 2)))
    assert float(Q.diagonal(0, 1, 2).min()) >= 0.0
    assert float(Q.diagonal(0, 1, 2).max()) < 1.0
    assert int(d["eq_mask"].sum()) == 4 * me
    # the feasibility trick: x = pinv(A)·b satisfies G x <= c
    G, A = d["A0"][:, :mi], d["A0"][:, mi:]
    b, c = d["zl"][:, mi:], d["zu"][:, :mi]
    x = torch.linalg.pinv(A) @ b[..., None]
    assert bool(((G @ x)[..., 0] <= c + 1e-9).all())


def test_ruiz_matches_the_port():
    from iadmm_tpu_torch.scaling import scale_batch
    d = _data(dtype=torch.float64)
    scaled, sc = scale_batch(_batch(d), iters=10)
    Q, p, A0, zl, zu, dd, e, cost = ruiz.scale(
        d["Q"], d["p"], d["A0"], d["zl"], d["zu"], 10)
    for a, b in ((Q, scaled.Q), (p, scaled.p), (A0, scaled.A0),
                 (zu, scaled.zu), (dd, sc.d), (e, sc.e), (cost, sc.cost)):
        assert torch.equal(a, b)


def test_rollout_matches_the_port_plain_rollout():
    from iadmm_tpu_torch.kernels.rollout_kernel import rollout_plain
    from iadmm_tpu_torch.scaling import scale_batch
    d, prm = _data(), _params()
    scaled, _ = scale_batch(_batch(d))
    want = rollout_plain(prm, scaled, hidden=6, K=5, sigma=6e-6)
    got = rollout.rollout(prm, scaled.Q, scaled.p, scaled.A0, scaled.zl,
                          scaled.zu, scaled.eq_mask, K=5, sigma=6e-6,
                          low=precision.bf16)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_stage2_matches_the_port_lu_route():
    from iadmm_tpu_torch.solvers import exact
    from iadmm_tpu_torch.types import IterState
    d = _data(dtype=torch.float64)
    g = torch.Generator().manual_seed(4)
    B, n, m = 3, 10, 7
    x, y, z = (torch.randn(s, generator=g, dtype=torch.float64)
               for s in ((B, n), (B, m), (B, m)))
    rho = torch.where(d["eq_mask"], 1e3, 1.0).double() * 0.4
    st = IterState(x=x, y=y, z=z, xv=torch.zeros(B, n + m, dtype=x.dtype),
                   H=torch.zeros(B, 1, 1), C=torch.zeros(B, 1, 1))
    want = exact.feasibility_restoration(st, _batch(d), 6e-6, rho, 5)
    got = stage2.polish(x, y, z, d["Q"], d["p"], d["A0"], d["zl"], d["zu"],
                        rho, N=5, sigma=6e-6)
    for a, b in zip(got, (want.x, want.y, want.z)):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


def test_residuals_match_the_port_metrics():
    from iadmm_tpu_torch.evaluation import metrics
    d = _data(dtype=torch.float64)
    g = torch.Generator().manual_seed(5)
    x, y, z = (torch.randn(s, generator=g, dtype=torch.float64)
               for s in ((3, 10), (3, 7), (3, 7)))
    pr, dr = metrics.primal_dual_residual(x, y, z, d["Q"], d["p"], d["A0"])
    obj = metrics.obj_fn(x, d["Q"], d["p"])
    got = residuals.residuals(x, y, z, d["Q"], d["p"], d["A0"],
                              dtype=torch.float64)
    for a, b in zip(got, (pr, dr, obj)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_chunk_loss_and_gradients_match_the_port_plain_pair():
    from iadmm_tpu_torch.kernels.train_rollout import make_fused_chunk_loss
    from iadmm_tpu_torch.scaling import scale_batch
    from iadmm_tpu_torch.types import init_state
    d, prm = _data(count=2), _params(K=4)
    scaled, _ = scale_batch(_batch(d))
    B, n, m, h = 2, 10, 7, 6
    fused = make_fused_chunk_loss(num_var=n, num_constr=m, batch=B, hidden=h,
                                  sigma=6e-6, chunk_len=4, outer_T=4,
                                  K_total=4, compute_dtype="bfloat16")
    p1 = {k: v.clone().requires_grad_(True) for k, v in prm.items()}
    L1, _ = fused(p1, init_state(B, n, m, h, device="cpu"), scaled, 0)
    L1.backward()
    p2 = {k: v.clone().requires_grad_(True) for k, v in prm.items()}
    L2 = chunk.loss(p2, precision.bf16(scaled.Q), scaled.p,
                    precision.bf16(scaled.A0), scaled.zl, scaled.zu,
                    scaled.eq_mask, J=4, K=4, t0=0, sigma=6e-6,
                    low=precision.bf16)
    L2.backward()
    assert float(L2.detach()) == pytest.approx(float(L1.detach()), rel=1e-5)
    for k in prm:
        torch.testing.assert_close(p2[k].grad, p1[k].grad, rtol=2e-2,
                                   atol=1e-4 * float(p1[k].grad.abs().max())
                                   + 1e-12)


def test_adam_matches_clipped_adam():
    from iadmm_tpu_torch.train.harness import ClippedAdam
    prm = _params()
    a = {k: v.clone().requires_grad_(True) for k, v in prm.items()}
    b = {k: v.clone().requires_grad_(True) for k, v in prm.items()}
    ours, port = adam.Adam(a, 1e-2, 0.05), ClippedAdam(b, 1e-2,
                                                       clip_grad_norm=0.05)
    g = torch.Generator().manual_seed(6)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in prm.items()}
        for k in prm:
            a[k].grad, b[k].grad = grads[k].clone(), grads[k].clone()
        ours.step()
        port.step()
    for k in prm:
        torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-7)


def test_serve_pipeline_matches_the_port_solver_lu_route():
    from iadmm_tpu_torch.api import make_solver
    d, prm = _data(), _params()
    res = make_solver(prm, hidden_dim=6, num_iters=5, feas_rest_num=4,
                      use_pallas=False, gate_dtype="bfloat16",
                      matvec_mode="bf16", rollout_impl="fused",
                      stage2_impl="lu")(_batch(d))
    want = serve.solve(prm, d["Q"], d["p"], d["A0"], d["zl"], d["zu"],
                       d["eq_mask"], K=5, N=4, sigma=6e-6, scaling_iters=10,
                       prec=precision.profile("reference"))
    torch.testing.assert_close(want["x"], res.x, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(want["obj"], res.obj, rtol=1e-4, atol=1e-5)


def test_rounding_of_the_profiles():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.14159])
    assert precision.tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9,
                                          -3.140625]
    assert precision.bf16(x).tolist()[3] == -3.140625
    a = torch.linspace(-5, 5, 101)
    r = precision.fp8(a)
    assert float((r - a).abs().max()) <= 5 / 448 * 16   # 3 mantissa bits
    assert bool(torch.isfinite(precision.fp8(torch.zeros(3))).all())
