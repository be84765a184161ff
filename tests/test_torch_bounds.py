"""The port's kernel bounds (iadmm_tpu_torch.kernels.bounds)."""

import numpy as np
import pytest

from iadmm_tpu_torch.kernels import bounds
from iadmm_tpu_torch.kernels.sparse_matvec import bsr_tiles_host


def test_bound_takes_the_larger_limit():
    ms, by = bounds.bound_ms(3.35e9)
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = bounds.bound_ms(1e3, bf16_ops=989e9)
    assert ms == pytest.approx(1.0) and by == "operations"
    ms, by = bounds.bound_ms(3.35e9, bf16_ops=989e9, f32_ops=67e9)
    assert ms == pytest.approx(2.0) and by == "operations"


@pytest.mark.parametrize("nb,w,tm,tn", [(1000, 0, 8, 128), (1000, 8, 8, 128),
                                        (1000, 256, 8, 128), (37, 3, 4, 8)])
def test_bsr_bound_counts_the_stored_tiles(nb, w, tm, tn):
    """A tile is stored when its rows and columns hold a band entry, i.e.
    the distance between its row range and its column range is <= w; the
    bound reads those tiles (bf16) and their indices once, the vector in
    and out in float32."""
    count = 0
    for r0 in range(0, nb, tm):
        r1 = min(r0 + tm, nb) - 1
        for c0 in range(0, nb, tn):
            c1 = min(c0 + tn, nb) - 1
            gap = max(c0 - r1, r0 - c1, 0)
            count += gap <= w
    idx = np.arange(nb)
    band = (np.abs(idx[:, None] - idx[None, :]) <= w).astype(np.float32)
    vals, _ = bsr_tiles_host(np.stack([band, 2 * band]), (tm, tn))
    tiles = bounds.stored_tiles(vals)
    assert tiles == 2 * count
    ms, by = bounds.bsr_matvec(tiles, 2, nb, nb, tm, tn)
    nbytes = tiles * (tm * tn * 2 + 4) + 2 * 2 * nb * 4
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_bsr_group_bound_sums_its_products():
    """A grouped launch moves its products' tiles, indices and vectors and
    does their operations: the bound of the sums, not the sum of the
    bounds (bytes bind each product here, so the two agree)."""
    Q = (1024, 2, 4096, 4096, 8, 128, 2)        # K = 1 .. 2 stored tiles
    A = (512, 2, 1024, 4096, 8, 128, 2)
    AT = (512, 2, 4096, 1024, 8, 128, 2)
    ms, by = bounds.bsr_matvec_group([A, AT, Q])
    parts = [bounds.bsr_matvec(*p) for p in (A, AT, Q)]
    assert by == "bytes" and all(b == "bytes" for _, b in parts)
    assert ms == pytest.approx(sum(t for t, _ in parts))
    nbytes = sum(t * (8 * 128 * 2 + 4) + 2 * (n + m) * 4
                 for t, _, m, n, *_ in (A, AT, Q))
    assert ms == pytest.approx(nbytes / 3.35e12 * 1e3)
    f32 = (1024, 2, 4096, 4096, 8, 128, 4)
    assert bounds.bsr_matvec_group([f32]) == bounds.bsr_matvec(*f32)
    with pytest.raises(ValueError, match="one tile dtype"):
        bounds.bsr_matvec_group([Q, f32])


def test_segment_pair_bounds_at_the_flagship():
    """The segment forward's bound is the stream forward's (one gate GEMM
    a step: J·2·B·S·h·4h = 2.05 TFLOP) with checkpoints for streams; the
    segment backward has four GEMMs a step, one more than the stream
    backward; 2.246 / 8.809 ms at B=2 in bf16, 8x that at B=16."""
    for dtype, rate in (("bfloat16", 989e12), ("float32", 67e12)):
        kw = dict(B=2, J=100, n=1000, m=1000, h=800, K=100, dtype=dtype)
        fwd, by_f = bounds.train_fwd_seg(seg=2, **kw)
        bwd, by_b = bounds.train_bwd_seg(seg=2, **kw)
        gemm_ms = 100 * 2.0 * 4000 * 800 * 3200 / rate * 1e3
        assert by_f == by_b == "operations"
        assert fwd == pytest.approx(bounds.train_fwd(**kw)[0])
        assert gemm_ms < fwd < 1.2 * gemm_ms
        assert 4 * gemm_ms < bwd < 4.5 * gemm_ms
        assert bwd > bounds.train_bwd(**kw)[0] + gemm_ms
        if dtype == "bfloat16":
            assert (fwd, bwd) == (pytest.approx(2.246, abs=1e-3),
                                  pytest.approx(8.809, abs=1e-3))
        big = bounds.train_bwd_seg(seg=2, **dict(kw, B=16))[0]
        assert big == pytest.approx(8 * bwd, rel=1e-3)


def test_segment_bounds_count_the_checkpoints():
    """Bytes: the forward writes one state (H, C float32) a segment plus
    the final one, the backward reads them back; at a size where the bytes
    bound, halving the segments halves those bytes."""
    kw = dict(B=64, J=8, n=8, m=8, h=4, K=8)
    st = bounds._state_bytes(64, 8, 8, 4)
    f1 = bounds.train_fwd_seg(seg=1, **kw)
    f2 = bounds.train_fwd_seg(seg=2, **kw)
    b1 = bounds.train_bwd_seg(seg=1, **kw)
    b2 = bounds.train_bwd_seg(seg=2, **kw)
    assert f1[1] == f2[1] == b1[1] == b2[1] == "bytes"
    assert (f1[0] - f2[0]) == pytest.approx(4 * st / 3.35e12 * 1e3)
    assert (b1[0] - b2[0]) == pytest.approx(4 * st / 3.35e12 * 1e3)


@pytest.mark.parametrize("solver", ["kkt", "direct", "cg"])
def test_stage2_bounds_at_the_serving_shape(solver):
    """B=8, N=20, n=m=1000: 'kkt' reads the (n+m)² inverse (bytes bound,
    0.0574 ms); 'direct' the n² one and runs two refinement passes; 'cg'
    101 matvecs of M a step (operations bound).  Every solver is ported:
    unported() is empty."""
    ms, by = bounds.stage2(8, 20, 1000, 1000, solver)
    want = {"kkt": (0.0574, "bytes"), "direct": (0.0670, "operations"),
            "cg": (1.4736, "operations")}[solver]
    assert (round(ms, 4), by) == want
    assert bounds.unported() == {}
    with pytest.raises(ValueError, match="solver"):
        bounds.stage2(8, 20, 1000, 1000, "lu")


@pytest.mark.parametrize("gate,rate", [("bfloat16", 989e12),
                                       ("float32", 67e12)])
def test_cell_bound_is_the_gate_gemm(gate, rate):
    """At B=8, S=2000, h=800 the H·U GEMM (82 GFLOP) sets the bound: 83 µs
    at the bf16 rate, 1.22 ms at the float32 rate (plus the float32
    epilogue), far above the 77–205 MB of traffic."""
    M, h = 8 * 2000, 800
    ms, by = bounds.cell(M, h, gate, state_bytes=4)
    gemm_ms = 2.0 * M * h * 4 * h / rate * 1e3
    epilogue_ms = (2.0 * M * 2 * 4 * h + 20.0 * M * h) / 67e12 * 1e3
    assert by == "operations"
    assert ms == pytest.approx(gemm_ms + epilogue_ms)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_train_pair_bounds_at_the_flagship(dtype):
    """Forward: one gate GEMM a step (2.07 ms bf16, 30.6 ms float32 over
    J=100); backward: three (6.2 ms, 91.7 ms); the float32 streams take 8
    bytes an element, the bf16 ones 6."""
    kw = dict(B=2, J=100, n=1000, m=1000, h=800, K=100, dtype=dtype)
    fwd, by_f = bounds.train_fwd(**kw)
    bwd, by_b = bounds.train_bwd(**kw)
    rate = 989e12 if dtype == "bfloat16" else 67e12
    gemm_ms = 100 * 2.0 * 4000 * 800 * 3200 / rate * 1e3
    assert by_f == by_b == "operations"
    assert gemm_ms < fwd < 1.15 * gemm_ms
    assert 3 * gemm_ms < bwd < 3.3 * gemm_ms
    data, streams, _, _ = bounds._chunk(**kw)
    assert streams == 100 * 4000 * 800 * (6 if dtype == "bfloat16" else 8)
    with pytest.raises(ValueError, match="dtype"):
        bounds.train_fwd(**dict(kw, dtype="float16"))


@pytest.mark.parametrize("dtype,cb", [("bfloat16", 2), ("float32", 4)])
def test_kkt_pass_bound_is_one_read_of_the_matrix(dtype, cb):
    """One read of [Q; A0] ((n+m)·n elements an instance, shared by both
    right-hand sides) plus each side's float32 vectors, partials and row
    dots: bytes bound it; 8 MB of bf16 at B=2, n = m = 1000 read in
    2.39 µs."""
    B, n, m = 2, 1000, 1000
    one, by = bounds.kkt_pass(B, n, m, dtype)
    two, by2 = bounds.kkt_pass(B, n, m, dtype, nv=2)
    side = B * 4 * ((n + m) + 63 * n + m)
    read = B * (n + m) * n * cb
    assert by == by2 == "bytes"
    assert one == pytest.approx((read + side) / 3.35e12 * 1e3)
    assert two - one == pytest.approx(side / 3.35e12 * 1e3)
    if dtype == "bfloat16":
        assert read / 3.35e12 * 1e6 == pytest.approx(2.388, abs=1e-3)
    assert bounds.kkt_pass(16, n, m, dtype)[0] == pytest.approx(8 * one)
