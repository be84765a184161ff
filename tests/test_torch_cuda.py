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
