"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  Skips without a CUDA device.  Imports no JAX, so that it runs where
only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerances: bf16 outputs to 2e-2 (a few bf16 ulps after other summation
orders); float32 Stage II to 1e-4 relative ('kkt'; 'direct' and 'cg'
at short runs, the 'cg' one with masking and across warm-started steps),
and over longer runs of the condensed solvers to 4x
the plain twin's own gap under reorderings of the variables and rows (the
system's conditioning amplifies float32 rounding); the float32 cell to 1e-5 of
max|ref| (a bf16 H'/C' to one bf16 ulp) and the float32 training pair to
1e-4 of each leaf's max|ref| at J=6 (float32 sums in another order, then
6 steps of the recurrence), with TF32 off in the plain versions.
"""

import dataclasses

import pytest
import torch

from chip_smoke import permuted_polish, update_of
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


@pytest.fixture
def no_tf32(dev):
    """The plain versions' float32 products in full float32."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield dev
    torch.backends.cuda.matmul.allow_tf32 = saved


def _params(seed, h, K=6):
    g = torch.Generator().manual_seed(seed)
    p = lstm_init(g, 2, h, K, device="cpu")
    p["U"] = p["U"] * 20  # gates of order 1
    p["b"] = 0.1 * torch.randn(p["b"].shape, generator=g)
    return p, g


@pytest.mark.parametrize("h,S,hc", [(16, 40, torch.bfloat16),
                                    (20, 37, torch.float32),
                                    (64, 300, torch.bfloat16),
                                    (44, 133, torch.bfloat16),
                                    (808, 37, torch.bfloat16)])
def test_cell_matches_plain(dev, h, S, hc):
    """bf16 gates, ragged shapes included: B·S not a multiple of the
    core's 128 rows, h not a multiple of its 32 units (44 and 20 not of 8
    either: H loaded by the core's producer threads); two calls bitwise
    equal."""
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
    again = tcell.cell_forward(*keys, x, H, C, "bfloat16")
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("h,S,hc", [(16, 40, torch.float32),
                                    (20, 37, torch.float32),
                                    (64, 300, torch.bfloat16),
                                    (44, 133, torch.bfloat16),
                                    (21, 37, torch.bfloat16),
                                    (27, 37, torch.float32),
                                    (808, 37, torch.float32)])
def test_float32_cell_matches_plain(no_tf32, h, S, hc):
    """Float32 gates, float32 or bf16 H/C, ragged h = 20 included (a bf16 H
    copied in 16-byte pieces at h = 64, in 4-byte words at h = 44 and at
    the odd h = 21, whose rows start mid-word; U's columns 4 bytes at a time
    at h = 27); two calls bitwise equal."""
    dev = no_tf32
    p, g = _params(h, h)
    keys = [p[k].to(dev) for k in tcell.CELL_KEYS]
    x = torch.randn((2, S, 2), generator=g).to(dev)
    H = torch.tanh(torch.randn((2, S, h), generator=g)).to(dev, hc)
    C = torch.randn((2, S, h), generator=g).to(dev, hc)
    before = tcell.fused_lstm_cell.launches_f32
    out = tcell.cell_forward(*keys, x, H, C, "float32")
    assert tcell.fused_lstm_cell.launches_f32 == before + 1
    ref = tcell.cell_plain(*keys, x, H, C, "float32")
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype
        torch.testing.assert_close(
            a.float(), b.float(),
            rtol=2 ** -7 if a.dtype == torch.bfloat16 else 0.0,
            atol=1e-5 * float(b.float().abs().max()))
    again = tcell.cell_forward(*keys, x, H, C, "float32")
    assert all(torch.equal(a, b) for a, b in zip(out, again))


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


@pytest.mark.parametrize("h,n,mi,me", [(20, 37, 21, 20), (72, 90, 40, 47),
                                        (212, 60, 30, 37)])
def test_rollout_wide_tile_matches_plain(dev, h, n, mi, me):
    """The rollout's own cell tile (64 units of four gates, persistent
    CTAs, a cluster of 2 on neighbouring row bands) at ragged shapes:
    B·(n+m) not a multiple of the 128-row band (a cluster's second band
    partly or wholly past it), the last unit tile partly masked, and h = 20
    and 212, whose bf16 H rows are padded to 16 bytes for the TMA.  Two
    calls bitwise equal."""
    data = _qp(dev, B=3, n=n, mi=mi, me=me)
    p, _ = _params(5, h)
    p = {k: v.to(dev) for k, v in p.items()}
    out = troll.fused_rollout(p, data, hidden=h, K=6)
    again = troll.fused_rollout(p, data, hidden=h, K=6)
    ref = troll.rollout_plain(p, data, hidden=h, K=6)
    for a, a2, b in zip(out, again, ref):
        assert torch.equal(a, a2)
        torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2)


def test_rollout_calls_independent(dev):
    """A rollout call does not depend on the calls before it: shape A, then
    shape B (another batch, n, m and h), then A at another K and sigma, then
    A again; the two A calls at K=6 are bitwise equal and every call
    matches rollout_plain."""
    shapes = dict(a=(dict(B=3, n=37, mi=21, me=20), 72),
                  b=(dict(B=2, n=90, mi=40, me=47), 20))
    outs = []
    for key, K, sigma in (("a", 6, 6e-6), ("b", 6, 6e-6), ("a", 4, 1e-4),
                          ("a", 6, 6e-6)):
        shape, h = shapes[key]
        data = _qp(dev, **shape)
        p, _ = _params(5, h)
        p = {k: v.to(dev) for k, v in p.items()}
        out = troll.fused_rollout(p, data, hidden=h, K=K, sigma=sigma)
        ref = troll.rollout_plain(p, data, hidden=h, K=K, sigma=sigma)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2)
        outs.append(out)
    for a, a2 in zip(outs[0], outs[3]):
        assert torch.equal(a, a2)


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


def _stage2_inputs(dev, seed=0, **shape):
    data = _qp(dev, **shape)
    B, n, m = data.batch, data.num_var, data.num_constr
    g = torch.Generator().manual_seed(seed)
    st = IterState(*(0.1 * torch.randn(s, generator=g).to(dev)
                     for s in ((B, n), (B, m), (B, m), (B, n + m))),
                   H=torch.zeros((B, 1, 1), device=dev),
                   C=torch.zeros((B, 1, 1), device=dev))
    rho = rho_vector(torch.tensor(0.1), data.eq_mask).float()
    return data, st, rho


def _tight(kernel, plain, data, st, rho, op, **kw):
    """A short run: every output to 1e-4 of max(1, max|ref|)."""
    out = kernel(st, data, rho, op, **kw)
    ref = plain(st, data, rho, op, **kw)
    for a, b in zip(out[:6], ref[:6]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * max(1.0, float(b.abs().max())))
    return out, ref


def _held_to_plain(kernel, plain, data, st, rho, op, full):
    """The ``full`` run: each output to within 4x the plain twin's own gap
    under two reorderings of the variables and rows (float32 rounding that
    the condensed system's conditioning amplifies), at least 4 float32 ulps
    of its max|ref|; two calls bitwise equal."""
    out = kernel(st, data, rho, op, **full)
    ref = plain(st, data, rho, op, **full)
    perms = [permuted_polish(plain, data, st, rho, op, seed, **full)
             for seed in (3, 5)]
    for k, (a, b) in enumerate(zip(out[:6], ref[:6])):
        scale = max(float(b.abs().max()), 1e-30)
        own = max(float((p[k] - b).abs().max()) for p in perms) / scale
        gap = float((a - b).abs().max()) / scale
        assert gap <= max(4 * own, 4 * 2.0 ** -23), (k, gap, own)
    again = kernel(st, data, rho, op, **full)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    return out, ref


def test_stage2_direct_matches_plain(no_tf32):
    """'direct': tight at N=1 with refine 0 and 2 (and the plain update of
    the kernel's own xt), relative at N=6, refine 2; one launch a polish
    step."""
    data, st, rho = _stage2_inputs(no_tf32)
    P = ts2.direct_inverse(data, rho, 1e-4)
    before = ts2.fused_stage2.launches_direct
    for refine in (0, 2):
        out, _ = _tight(ts2.stage2_direct_cuda, ts2.stage2_direct_plain,
                        data, st, rho, P, num_iters=1, sigma=1e-4,
                        refine=refine)
        upd = update_of(out[3], data, st, rho, torch.float32)
        for a, b in zip(out[:6], upd):
            torch.testing.assert_close(
                a, b, rtol=0, atol=1e-4 * max(1.0, float(b.abs().max())))
    _held_to_plain(ts2.stage2_direct_cuda, ts2.stage2_direct_plain, data, st,
                   rho, P, dict(num_iters=6, sigma=1e-4, refine=2))
    assert ts2.fused_stage2.launches_direct == before + 2 + 2 * 6


def test_stage2_cg_matches_plain(no_tf32):
    """'cg': tight at N=1 and N=3 with 3 CG iterations (the warm start
    across steps) and at N=1 with tol 0.1, where the two instances stop at
    different iterations (6 and 7 in the plain twin); relative at N=4 with
    30; the unmasked-iteration counts equal; one launch a polish step."""
    data, st, rho = _stage2_inputs(no_tf32)
    d = ts2.cg_diag(data, rho, 1e-4)
    kern, plain = ts2.stage2_cg_cuda, ts2.stage2_cg_plain
    before = ts2.fused_stage2.launches_cg
    for N, iters, tol in ((1, 3, 1e-8), (3, 3, 1e-8), (1, 30, 0.1)):
        out, ref = _tight(kern, plain, data, st, rho, d, num_iters=N,
                          sigma=1e-4, cg_iters=iters, tol=tol)
        assert torch.equal(out[6], ref[6])
    its = out[6].tolist()
    assert len(set(its)) == 2 and max(its) < 30, its
    out, ref = _held_to_plain(kern, plain, data, st, rho, d,
                              dict(num_iters=4, cg_iters=30, sigma=1e-4,
                                   tol=1e-8))
    assert ts2.fused_stage2.launches_cg == before + 5 + 2 * 4
    assert torch.equal(out[6], ref[6])


# (B, n, mi, me): n not a multiple of 4 (37, 70) or of 32 (132), m below
# 32 (15), B = 1
STAGE2_RAGGED = [(1, 37, 9, 6), (3, 70, 20, 13), (2, 132, 40, 30)]


@pytest.mark.parametrize("solver", ["kkt", "direct", "cg"])
@pytest.mark.parametrize("B,n,mi,me", STAGE2_RAGGED)
def test_stage2_ragged_shapes(no_tf32, solver, B, n, mi, me):
    """Each solver at ragged shapes against its plain twin at a short run
    (1e-4 of max(1, max|ref|); 'cg' with equal unmasked-iteration counts);
    two calls bitwise equal; one count a polish step."""
    data, st, rho = _stage2_inputs(no_tf32, B=B, n=n, mi=mi, me=me)
    if solver == "kkt":
        op = ts2.kkt_inverse(data, rho, 1e-4)
        kern, plain = ts2.stage2_cuda, ts2.stage2_plain
        kw, counter = dict(num_iters=3, sigma=1e-4, refine=1), "launches"
    elif solver == "direct":
        op = ts2.direct_inverse(data, rho, 1e-4)
        kern, plain = ts2.stage2_direct_cuda, ts2.stage2_direct_plain
        kw, counter = dict(num_iters=1, sigma=1e-4, refine=2), \
            "launches_direct"
    else:
        op = ts2.cg_diag(data, rho, 1e-4)
        kern, plain = ts2.stage2_cg_cuda, ts2.stage2_cg_plain
        kw, counter = dict(num_iters=2, sigma=1e-4, cg_iters=4,
                           tol=1e-8), "launches_cg"
    before = getattr(ts2.fused_stage2, counter)
    out, ref = _tight(kern, plain, data, st, rho, op, **kw)
    assert getattr(ts2.fused_stage2, counter) == before + kw["num_iters"]
    if solver == "cg":
        assert torch.equal(out[6], ref[6])
    again = kern(st, data, rho, op, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.parametrize("solver", ["direct", "cg"])
def test_stage2_condensed_n_limit(no_tf32, solver):
    """'direct' and 'cg' raise a ValueError naming the largest n above it,
    before any launch."""
    limit = ts2.condensed_max_n(no_tf32)
    assert 1000 < limit < 10 ** 6
    data, st, rho = _stage2_inputs(no_tf32, B=1)
    n = limit + 1
    big = dataclasses.replace(
        data, Q=torch.empty((1, n, n), device=no_tf32),
        p=torch.zeros((1, n), device=no_tf32),
        A0=torch.empty((1, data.num_constr, n), device=no_tf32))
    op = (torch.empty((1, n, n), device=no_tf32) if solver == "direct"
          else torch.ones((1, n), device=no_tf32))
    run = dict(direct=ts2.stage2_direct_cuda, cg=ts2.stage2_cg_cuda)[solver]
    kw = (dict(refine=2) if solver == "direct"
          else dict(cg_iters=2, tol=1e-8))
    with pytest.raises(ValueError, match=f"largest n .* {limit}"):
        run(st, big, rho, op, num_iters=1, sigma=1e-4, **kw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tm,m,n", [(8, 200, 300), (128, 37, 141),
                                    (8, 8, 128)])
def test_bsr_matvec_matches_plain(dev, dtype, tm, m, n):
    """Forward and backward to 1e-5 (bf16 tiles) or 1e-6 (float32 tiles)
    of max|ref|; two calls bitwise equal.  Covers ragged m and n and K=1
    (the last case).  The grouped launch (M·v, Mᵀ·w, M·v again): one
    launch, each output bitwise the single-product kernel's, held to the
    plain version; its backward one launch."""
    from iadmm_tpu_torch.kernels import sparse_matvec as tsm
    g = torch.Generator().manual_seed(m + n)
    M = torch.randn((3, m, n), generator=g)
    M = M * (torch.rand((3, m, n), generator=g) < 0.1)
    Mb, MTb = tsm.bsr_pair_from_dense(M.numpy(), (tm, 128), dtype,
                                      device=dev)
    v = torch.randn((3, n), generator=g).to(dev).requires_grad_(True)
    w = torch.randn((3, m), generator=g).to(dev)
    tol = 1e-5 if dtype == torch.bfloat16 else 1e-6
    before = tsm.bsr_matvec.launches
    out = tsm.bsr_matvec_ad(Mb, MTb, v)
    (out * w).sum().backward()
    assert tsm.bsr_matvec.launches == before + 2
    ref = tsm.bsr_matvec_plain(Mb, v.detach())
    torch.testing.assert_close(out.detach(), ref, rtol=0,
                               atol=tol * float(ref.abs().max()))
    gref = tsm.bsr_matvec_plain(MTb, w)
    torch.testing.assert_close(v.grad, gref, rtol=0,
                               atol=tol * float(gref.abs().max()))
    assert torch.equal(tsm.bsr_matvec(Mb, v.detach()), out.detach())
    # slices of one tensor, as the step takes u and ν from xv: the wrapper
    # copies each before the one launch
    xv = torch.randn((3, 2 * n + m), generator=g).to(dev)
    v1, w1, v2 = xv[:, :n], xv[:, n:n + m], xv[:, n + m:]
    before = tsm.bsr_matvec.launches
    outs = tsm.bsr_matvec_group([Mb, MTb, Mb], [v1, w1, v2])
    assert tsm.bsr_matvec.launches == before + 1
    for o, (M, x) in zip(outs, [(Mb, v1), (MTb, w1), (Mb, v2)]):
        assert torch.equal(o, tsm.bsr_matvec_cuda(M, x))
        ref = tsm.bsr_matvec_plain(M, x)
        torch.testing.assert_close(o, ref, rtol=0,
                                   atol=tol * float(ref.abs().max()))
    vg = v.detach().clone().requires_grad_(True)
    wg = w.clone().requires_grad_(True)
    before = tsm.bsr_matvec.launches
    a, b = tsm.bsr_matvec_group_ad([(Mb, MTb), (MTb, Mb)], [vg, wg])
    (a * w).sum().add((b * v2).sum()).backward()
    assert tsm.bsr_matvec.launches == before + 2
    assert torch.equal(vg.grad, tsm.bsr_matvec_cuda(MTb, w))
    assert torch.equal(wg.grad, tsm.bsr_matvec_cuda(Mb, v2))


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


@pytest.mark.parametrize("t0,h", [(0, 24), (2, 24), (0, 36), (0, 40)])
def test_train_kernels_match_plain(dev, t0, h):
    """Forward: losses and final state to 2e-2.  Backward on the plain
    forward's streams: every gradient leaf to 1e-3 of its max.  End to end:
    every leaf to 2e-2 of its max, or, for a leaf that is a cancelling sum
    (b_h here: per-step terms of about 12 summing to about 0.3), to within
    2x the gap the plain backward shows when fed the kernel's streams.  The
    backward twice: bitwise equal (fixed-order sums).  B·S = 84 rows, less
    than one 128-row tile; h = 36 and 40 are ragged for the bf16 cores (not
    multiples of their 32 units; 36 not of 8 either: H and the dU operands
    go through the core's producer threads)."""
    from iadmm_tpu_torch.kernels import train_rollout as ttr
    J = 6
    weights, st, dd, g = _train_inputs(dev, h=h)
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


@pytest.mark.parametrize("M,h", [(200, 24), (200, 20), (1037, 808),
                                 (4000, 800)])
def test_bf16_gemm_matches_plain(no_tf32, M, h):
    """The training backward's bf16 GEMM core alone: dH = dpre·Uᵀ and dU +=
    H_kᵀ·dpre against the float32 product of the same bf16 operands, to
    1e-4 of max|ref| (exact products summed in another order); ragged M and
    h, and h = 20 whose H rows the TMA cannot address; two calls bitwise
    equal."""
    from iadmm_tpu_torch.kernels import train_rollout as ttr
    g = torch.Generator().manual_seed(M + h)
    bf = torch.bfloat16
    dpre = torch.randn((M, 4 * h), generator=g).to(no_tf32, bf)
    U = torch.randn((h, 4 * h), generator=g).to(no_tf32, bf)
    H = torch.randn((M, h), generator=g).to(no_tf32, bf)
    dU0 = torch.randn((h, 4 * h), generator=g).to(no_tf32)
    dH = torch.empty((M, h), device=no_tf32)
    ttr.bf16_gemm(dpre, U, dH, a_col=False, b_col=True, accumulate=False)
    ref = dpre.float() @ U.float().T
    torch.testing.assert_close(dH, ref, rtol=0,
                               atol=1e-4 * float(ref.abs().max()))
    dU, again = dU0.clone(), dU0.clone()
    for out in (dU, again):
        ttr.bf16_gemm(H, dpre, out, a_col=True, b_col=False, accumulate=True)
    ref = dU0 + H.float().T @ dpre.float()
    torch.testing.assert_close(dU, ref, rtol=0,
                               atol=1e-4 * float(ref.abs().max()))
    assert torch.equal(dU, again)


def _f32(shape, g, dev, offset):
    """A contiguous float32 tensor of ``shape`` whose data starts
    ``offset`` elements into its storage (offset 1: off 16 bytes)."""
    n = 1
    for s in shape:
        n *= s
    buf = torch.empty(n + offset, device=dev)
    out = buf[offset:].view(shape)
    out.copy_(torch.randn(shape, generator=g))
    return out


@pytest.mark.parametrize("M,h,offset", [(2 * 1037, 20, 0),
                                        (2 * 1037, 44, 1),
                                        (2 * 1037, 212, 0),
                                        (2 * 1037, 808, 1),
                                        (2 * 1037, 27, 0),
                                        (4000, 800, 0)])
def test_f32_gemm_matches_float64(no_tf32, M, h, offset):
    """The float32 FFMA GEMM core alone, as the float32 backward runs it:
    dH = (dpreᵀ)ᵀ·Uᵀ from the transposed copies and dU += H_kᵀ·dpre,
    against the float64 product of the same operands, to 1e-5 of max|ref|
    (float32 sums over K = 4h or M); ragged M and h, h = 27 (leading
    dimensions of H and dH not a multiple of 4), operands and results off
    16 bytes (offset 1); two calls bitwise equal."""
    from iadmm_tpu_torch.kernels import train_rollout as ttr
    dev = no_tf32
    g = torch.Generator().manual_seed(M + h)
    dpreT = _f32((4 * h, M), g, dev, offset)
    UT = _f32((4 * h, h), g, dev, offset)
    H = _f32((M, h), g, dev, offset)
    dpre = _f32((M, 4 * h), g, dev, offset)
    dpre.copy_(dpreT.T)
    dU0 = _f32((h, 4 * h), g, dev, 0)
    dH, dH2 = _f32((M, h), g, dev, offset), torch.empty((M, h), device=dev)
    for out in (dH, dH2):
        ttr.f32_gemm(dpreT, UT, out, a_col=True, b_col=False,
                     accumulate=False)
    ref = dpreT.double().T @ UT.double()
    torch.testing.assert_close(dH.double(), ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    assert torch.equal(dH, dH2)
    dU, again = _f32((h, 4 * h), g, dev, offset), dU0.clone()
    dU.copy_(dU0)
    for out in (dU, again):
        ttr.f32_gemm(H, dpre, out, a_col=True, b_col=False, accumulate=True)
    ref = dU0.double() + H.double().T @ dpre.double()
    torch.testing.assert_close(dU.double(), ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    assert torch.equal(dU, again)


def test_float32_train_kernels_match_plain(no_tf32):
    """compute_dtype='float32' at J=6: the losses, the final state and every
    gradient leaf from the backward on the plain forward's streams to 1e-4
    of the leaf's max|ref|; end to end every leaf to 1e-4, or, for a leaf
    that is a cancelling sum (b_h), to within 2x the gap the plain backward
    shows when fed the kernel's streams, as the bf16 test holds it; the H
    stream is float32; the backward twice, bitwise equal."""
    from iadmm_tpu_torch.kernels import train_rollout as ttr
    dev, J = no_tf32, 6
    weights, st, dd, g = _train_inputs(dev)
    kw = dict(t0=1, J=J, sigma=1e-3, compute_dtype="float32")
    f0 = ttr.train_fwd_cuda.launches_f32
    b0 = ttr.train_bwd_cuda.launches_f32
    pr, dr, final, streams = ttr.train_fwd_cuda(weights, st, dd, **kw)
    assert streams[0].dtype == torch.float32
    rpr, rdr, rfinal, rstreams = ttr.train_fwd_plain(weights, st, dd, **kw)
    for a, b in zip((pr, dr, *final), (rpr, rdr, *rfinal)):
        assert _leaf_gap(a, b) <= 1e-4
    dpr = torch.rand(pr.shape, generator=g).to(dev)
    ddr = torch.rand(dr.shape, generator=g).to(dev)
    dfin = tuple((0.1 * torch.randn(f.shape, generator=g)).to(dev)
                 for f in final)
    grads, dst = ttr.train_bwd_cuda(weights, dd, streams, dfin, dpr, ddr,
                                    **kw)
    again, _ = ttr.train_bwd_cuda(weights, dd, streams, dfin, dpr, ddr, **kw)
    same, sst = ttr.train_bwd_cuda(weights, dd, rstreams, dfin, dpr, ddr,
                                   **kw)
    assert ttr.train_fwd_cuda.launches_f32 == f0 + J
    assert ttr.train_bwd_cuda.launches_f32 == b0 + 3 * J
    own, ost = ttr.train_bwd_plain(weights, dd, streams, dfin, dpr, ddr,
                                   **kw)
    ref, rst = ttr.train_bwd_plain(weights, dd, rstreams, dfin, dpr, ddr,
                                   **kw)
    for k, a, a2, s, o, b in zip("W U b W_h b_h rho alpha".split(), grads,
                                 again, same, own, ref):
        assert torch.equal(a, a2), k
        assert _leaf_gap(s, b) <= 1e-4, k
        gap = _leaf_gap(a, b)
        assert gap <= 1e-4 or gap <= 2 * _leaf_gap(o, b), (k, gap)
    for k, a, s, o, b in zip("x y z xv H C".split(), dst, sst, ost, rst):
        assert _leaf_gap(s, b) <= 1e-4, f"d{k}"
        gap = _leaf_gap(a, b)
        assert gap <= 1e-4 or gap <= 2 * _leaf_gap(o, b), (f"d{k}", gap)


def _segments(ttr, weights, st, dd, dfin, dpr, ddr, seg, J, t0, cdt,
              fold=True):
    """The segment pair over a chunk of J steps, as make_fused_chunk_loss
    runs it (``fold``: each call takes the loss its previous call left;
    else each takes its own): losses, final state, gradients, start-state
    cotangents."""
    kw = dict(sigma=1e-3, compute_dtype=cdt)
    B = st[0].shape[0]
    losses = tuple(torch.empty((B, J), device=st[0].device)
                   for _ in range(2))
    ckpts, cur = [], st
    n_segs = J // seg
    for s in range(n_segs):
        ckpts.append(cur)
        order = (dict(pending=s > 0, close=s == n_segs - 1) if fold
                 else {})
        *_, cur = ttr.train_fwd_seg_cuda(weights, cur, dd, t0=t0 + s * seg,
                                         J=seg, losses=losses, col=s * seg,
                                         **order, **kw)
    acc, dst = None, dfin
    for s in reversed(range(J // seg)):
        acc, dst = ttr.train_bwd_seg_cuda(weights, ckpts[s], dd, dst, dpr,
                                          ddr, t0=t0 + s * seg, J=seg,
                                          col=s * seg, acc=acc, **kw)
    return (*losses, *cur), acc, dst


@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
@pytest.mark.parametrize("seg", [1, 2, 3])
def test_segment_kernels_match_the_stream_kernels(no_tf32, seg, cdt):
    """The segment pair over a J=6 chunk: losses, final state, every
    gradient leaf and the start state's cotangents bitwise equal to the
    stream pair's (the same launches, sums in the same order), with the
    loss pass folded across the segments' calls or not; the forward
    against the plain segment forward at the stream tests' tolerances; the
    segment backward twice bitwise equal; one launch a segment each."""
    from iadmm_tpu_torch.kernels import train_rollout as ttr
    dev, J, t0 = no_tf32, 6, 1
    weights, st, dd, g = _train_inputs(dev)
    kw = dict(sigma=1e-3, compute_dtype=cdt)
    pr, dr, final, streams = ttr.train_fwd_cuda(weights, st, dd, t0=t0, J=J,
                                                **kw)
    dpr = torch.rand(pr.shape, generator=g).to(dev)
    ddr = torch.rand(dr.shape, generator=g).to(dev)
    dfin = tuple((0.1 * torch.randn(f.shape, generator=g)).to(dev)
                 for f in final)
    grads, dst = ttr.train_bwd_cuda(weights, dd, streams, dfin, dpr, ddr,
                                    t0=t0, J=J, **kw)
    ctr = "launches" if cdt == "bfloat16" else "launches_f32"
    f0 = getattr(ttr.train_fwd_seg_cuda, ctr)
    b0 = getattr(ttr.train_bwd_seg_cuda, ctr)
    outs, sgrads, sdst = _segments(ttr, weights, st, dd, dfin, dpr, ddr, seg,
                                   J, t0, cdt)
    assert getattr(ttr.train_fwd_seg_cuda, ctr) == f0 + J // seg
    assert getattr(ttr.train_bwd_seg_cuda, ctr) == b0 + J // seg
    names = ("pr", "dr", "x", "y", "z", "xv", "H", "C")
    for k, a, b in zip(names, outs, (pr, dr, *final)):
        assert torch.equal(a, b), k
    for k, a, b in zip("W U b W_h b_h rho alpha".split(), sgrads, grads):
        assert torch.equal(a, b), k
    for k, a, b in zip("x y z xv H C".split(), sdst, dst):
        assert torch.equal(a, b), f"d{k}"
    again = _segments(ttr, weights, st, dd, dfin, dpr, ddr, seg, J, t0, cdt)
    assert all(torch.equal(a, b) for a, b in zip(again[1], sgrads))
    # each call closing its own losses: the same bits
    own = _segments(ttr, weights, st, dd, dfin, dpr, ddr, seg, J, t0, cdt,
                    fold=False)
    for k, a, b in zip(names, own[0], outs):
        assert torch.equal(a, b), k
    ppr, pdr, pfin = ttr.train_fwd_seg_plain(weights, st, dd, t0=t0, J=J,
                                             **kw)
    for a, b in zip(outs, (ppr, pdr, *pfin)):
        if cdt == "bfloat16":
            torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2)
        else:
            assert _leaf_gap(a, b) <= 1e-4


@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
def test_forward_folds_the_loss_pass_bitwise_at_J100(no_tf32, cdt):
    """J=100: the stream forward (one call; each step's loss pass shares
    the next step's read of [Q; A0]), the segment forward in segments of 2
    with the loss folded across calls (the chunk loss's order) and with
    each call taking its own: losses and final states bitwise equal, the
    losses finite; J steps counted, one call."""
    from iadmm_tpu_torch.kernels import train_rollout as ttr
    dev, J, seg = no_tf32, 100, 2
    weights, st, dd, g = _train_inputs(dev, K=J)
    kw = dict(sigma=1e-3, compute_dtype=cdt)
    ctr = "launches" if cdt == "bfloat16" else "launches_f32"
    f0 = getattr(ttr.train_fwd_cuda, ctr)
    pr, dr, final, _ = ttr.train_fwd_cuda(weights, st, dd, t0=0, J=J, **kw)
    assert getattr(ttr.train_fwd_cuda, ctr) == f0 + J
    assert bool(torch.isfinite(pr).all() and torch.isfinite(dr).all())
    B = st[0].shape[0]
    for fold in (True, False):
        losses = tuple(torch.empty((B, J), device=dev) for _ in range(2))
        cur = st
        for s in range(J // seg):
            order = (dict(pending=s > 0, close=s == J // seg - 1) if fold
                     else {})
            *_, cur = ttr.train_fwd_seg_cuda(weights, cur, dd, t0=s * seg,
                                             J=seg, losses=losses,
                                             col=s * seg, **order, **kw)
        for k, a, b in zip(("pr", "dr", "x", "y", "z", "xv", "H", "C"),
                           (*losses, *cur), (pr, dr, *final)):
            assert torch.equal(a, b), (fold, k)


@pytest.mark.parametrize("nv", [1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,n,m", [(1, 37, 21), (3, 37, 21), (1, 64, 32),
                                   (3, 64, 32), (1, 130, 70), (3, 130, 70),
                                   (2, 1000, 1000), (16, 1000, 1000)])
def test_kkt_pass_matches_plain(no_tf32, B, n, m, dtype, nv):
    """The KKT pass (kernels/kkt_pass.py) against its plain version: the
    chunk partials and row dots to 1e-5 of max|ref| (float32 sums in
    another order; bf16 data with the vectors rounded to bf16); with two
    right-hand sides each output bitwise what a one-vector call gives; two
    calls bitwise equal; one launch a call."""
    from iadmm_tpu_torch.kernels.kkt_pass import kkt_pass, kkt_pass_plain
    dev = no_tf32
    g = torch.Generator().manual_seed(n + m + B)
    Q = torch.randn((B, n, n), generator=g)
    Q = (0.5 * (Q + Q.transpose(1, 2))).to(dev, dtype)
    A0 = torch.randn((B, m, n), generator=g).to(dev, dtype)
    vecs = [torch.randn(s, generator=g).to(dev)
            for s in ((B, n), (B, m), (B, n), (B, m))][:2 * nv]
    before = kkt_pass.launches
    outs = kkt_pass(Q, A0, *vecs)
    assert kkt_pass.launches == before + 1
    again = kkt_pass(Q, A0, *vecs)
    for k, (p, r) in enumerate(outs):
        wt, wb = vecs[2 * k:2 * k + 2]
        rp, rr = kkt_pass_plain(Q, A0, wt, wb)
        for a, b in ((p, rp), (r, rr)):
            torch.testing.assert_close(a, b, rtol=0,
                                       atol=1e-5 * float(b.abs().max()))
        assert torch.equal(p, again[k][0]) and torch.equal(r, again[k][1])
        if nv == 2:
            ap, ar = kkt_pass(Q, A0, wt, wb)[0]
            assert torch.equal(p, ap) and torch.equal(r, ar)


@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
def test_segment_route_through_the_chunk_loss(no_tf32, cdt):
    """make_fused_chunk_loss on CUDA tensors: seg=2 and the stream route
    give bitwise-equal losses, final states and parameter gradients."""
    from iadmm_tpu_torch.kernels import train_rollout as ttr
    from iadmm_tpu_torch.types import IterState
    dev = no_tf32
    weights, st, _, _ = _train_inputs(dev)
    data = _qp(dev)   # the batch _train_inputs made
    res = {}
    for name, route in (("segment", dict(seg=2)), ("stream", {})):
        params = {k: w.clone().requires_grad_(True) for k, w in
                  zip("W U b W_h b_h rho alpha".split(), weights)}
        fn = ttr.make_fused_chunk_loss(num_var=20, num_constr=22, batch=2,
                                       hidden=24, sigma=1e-3, chunk_len=6,
                                       outer_T=8, K_total=8,
                                       compute_dtype=cdt, **route)
        assert fn.stream == (name == "stream")
        loss, out = fn(params, IterState(*st), data, 2)
        loss.backward()
        res[name] = (loss, out, {k: p.grad for k, p in params.items()})
    (sl, so, sg), (rl, ro, rg) = res["segment"], res["stream"]
    assert torch.isfinite(sl) and torch.equal(sl, rl)
    for f in ("x", "y", "z", "xv", "H", "C"):
        assert torch.equal(getattr(so, f), getattr(ro, f)), f
    assert all(torch.equal(sg[k], rg[k]) for k in rg)
