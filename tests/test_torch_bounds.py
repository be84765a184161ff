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


def test_segment_pair_bounds_at_the_flagship():
    """The forward's bound is the gate GEMM's: J·2·B·S·h·4h = 2.05 TFLOP
    plus the KKT matvecs and the float32 epilogue; the backward's has four
    GEMMs a step."""
    out = bounds.segment_pair()
    fwd, by_f = out["fwd_seg (train_rollout.py:147)"]
    bwd, by_b = out["bwd_seg (train_rollout.py:664)"]
    gemm_ms = 100 * 2.0 * 4000 * 800 * 3200 / 989e12 * 1e3
    assert by_f == by_b == "operations"
    assert gemm_ms < fwd < 1.2 * gemm_ms
    assert 4 * gemm_ms < bwd < 4.5 * gemm_ms


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
