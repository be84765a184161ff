"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  Skips without a CUDA device.  Imports no JAX, so that it runs where
only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: bf16 outputs to 2e-2 (a few bf16 ulps after other summation
orders); float32 Stage II to 1e-4 relative.
"""

import pytest
import torch

from iadmm_tpu_torch.kernels import lstm_cell as tcell
from iadmm_tpu_torch.kernels import rollout_kernel as troll
from iadmm_tpu_torch.kernels import stage2_kernel as ts2
from iadmm_tpu_torch.problems import generate, to_qp_batch
from iadmm_tpu_torch.solvers.cells import lstm_init
from iadmm_tpu_torch.solvers.step import rho_vector
from iadmm_tpu_torch.types import IterState

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _params(seed, h, K=6):
    g = torch.Generator().manual_seed(seed)
    p = lstm_init(g, 2, h, K, device="cpu")
    p["U"] = p["U"] * 20  # gates of order 1
    p["b"] = 0.1 * torch.randn(p["b"].shape, generator=g)
    return p, g


@pytest.mark.parametrize("h,S,hc", [(16, 40, torch.bfloat16),
                                    (20, 37, torch.float32),
                                    (64, 300, torch.bfloat16)])
def test_cell_matches_plain(dev, h, S, hc):
    p, g = _params(h, h)
    keys = [p[k].to(dev) for k in tcell.CELL_KEYS]
    x = torch.randn((2, S, 2), generator=g).to(dev)
    H = torch.tanh(torch.randn((2, S, h), generator=g)).to(dev, hc)
    C = torch.randn((2, S, h), generator=g).to(dev, hc)
    before = tcell.fused_lstm_cell.launches
    out = tcell.cell_forward(*keys, x, H, C, "bfloat16")
    assert tcell.fused_lstm_cell.launches == before + 1
    ref = tcell.cell_plain(*keys, x, H, C, "bfloat16")
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                   atol=2e-2)


def _qp(dev, B=2, n=20, mi=12, me=10):
    ds = generate("QP", num_var=n, num_ineq=mi, num_eq=me, data_size=B,
                  seed=11)
    return to_qp_batch(ds, device=dev)


def test_rollout_matches_plain(dev):
    data = _qp(dev)
    p, _ = _params(3, 16)
    p = {k: v.to(dev) for k, v in p.items()}
    before = troll.fused_rollout.launches
    out = troll.fused_rollout(p, data, hidden=16, K=6)
    assert troll.fused_rollout.launches == before + 6
    ref = troll.rollout_plain(p, data, hidden=16, K=6)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("refine", [0, 1])
def test_stage2_matches_plain(dev, refine):
    data = _qp(dev)
    B, n, m = data.batch, data.num_var, data.num_constr
    g = torch.Generator().manual_seed(0)
    st = IterState(*(0.1 * torch.randn(s, generator=g).to(dev)
                     for s in ((B, n), (B, m), (B, m), (B, n + m))),
                   H=torch.zeros((B, 1, 1), device=dev),
                   C=torch.zeros((B, 1, 1), device=dev))
    rho = rho_vector(torch.tensor(0.1), data.eq_mask)
    Ainv = ts2.kkt_inverse(data, rho, 1e-4)
    out = ts2.stage2_cuda(st, data, rho, Ainv, num_iters=10, sigma=1e-4,
                           refine=refine)
    ref = ts2.stage2_plain(st, data, rho, Ainv, num_iters=10, sigma=1e-4,
                           refine=refine)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def _train_inputs(dev, B=2, n=20, mi=12, me=10, h=24, K=8, seed=5):
    from iadmm_tpu_torch.kernels.lstm_cell import CELL_KEYS
    data = _qp(dev, B, n, mi, me)
    p, g = _params(seed, h, K)
    weights = tuple(p[k].to(dev) for k in CELL_KEYS + ("rho", "alpha"))
    S = n + mi + me
    st = tuple((0.1 * torch.randn(s, generator=g)).to(dev)
               for s in ((B, n), (B, mi + me), (B, mi + me), (B, S),
                         (B, S, h), (B, S, h)))
    dd = (data.Q, data.A0, data.p, data.zl, data.zu,
          rho_vector(1.0, data.eq_mask).float())
    return weights, st, dd, g


def _leaf_gap(a, b):
    return float((a.reshape(b.shape) - b).abs().max()) / max(
        float(b.abs().max()), 1e-6)


@pytest.mark.parametrize("t0", [0, 2])
def test_train_kernels_match_plain(dev, t0):
    """Forward: losses and final state to 2e-2.  Backward on the plain
    forward's streams: every gradient leaf to 1e-3 of its max.  End to end:
    every leaf to 2e-2 of its max, or, for a leaf that is a cancelling sum
    (b_h here: per-step terms of about 12 summing to about 0.3), to within
    2x the gap the plain backward shows when fed the kernel's streams.  The
    backward twice: bitwise equal (fixed-order sums)."""
    from iadmm_tpu_torch.kernels import train_rollout as ttr
    J = 6
    weights, st, dd, g = _train_inputs(dev)
    kw = dict(t0=t0, J=J, sigma=1e-3, compute_dtype="bfloat16")
    before = ttr.train_fwd_cuda.launches
    pr, dr, final, streams = ttr.train_fwd_cuda(weights, st, dd, **kw)
    assert ttr.train_fwd_cuda.launches == before + J
    rpr, rdr, rfinal, rstreams = ttr.train_fwd_plain(weights, st, dd, **kw)
    for a, b in zip((pr, dr, *final), (rpr, rdr, *rfinal)):
        torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2)
    dpr = torch.rand(pr.shape, generator=g).to(dev)
    ddr = torch.rand(dr.shape, generator=g).to(dev)
    # cotangents on the final state too (zero in training, where the loss
    # does not read it), so the carries' starting values are checked
    dfin = tuple((0.1 * torch.randn(f.shape, generator=g)).to(dev)
                 for f in final)
    before = ttr.train_bwd_cuda.launches
    grads, dst = ttr.train_bwd_cuda(weights, dd, streams, dfin, dpr, ddr,
                                    **kw)
    assert ttr.train_bwd_cuda.launches == before + J
    again, _ = ttr.train_bwd_cuda(weights, dd, streams, dfin, dpr, ddr, **kw)
    same, sst = ttr.train_bwd_cuda(weights, dd, rstreams, dfin, dpr, ddr,
                                   **kw)
    own, _ = ttr.train_bwd_plain(weights, dd, streams, dfin, dpr, ddr, **kw)
    ref, rst = ttr.train_bwd_plain(weights, dd, rstreams, dfin, dpr, ddr,
                                   **kw)
    for k, a, a2, s, o, b in zip("W U b W_h b_h rho alpha".split(), grads,
                                 again, same, own, ref):
        assert torch.equal(a, a2), k
        assert _leaf_gap(s, b) <= 1e-3, k
        gap = _leaf_gap(a, b)
        assert gap <= 2e-2 or gap <= 2 * _leaf_gap(o, b), (k, gap)
    for k, s, b in zip("x y z xv H C".split(), sst, rst):
        assert _leaf_gap(s, b) <= 1e-3, f"d{k}"
