"""The port's kernel bounds (iadmm_tpu_torch.kernels.bounds)."""

import pytest

from iadmm_tpu_torch.kernels import bounds


def test_bound_takes_the_larger_limit():
    ms, by = bounds.bound_ms(3.35e9)
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = bounds.bound_ms(1e3, bf16_ops=989e9)
    assert ms == pytest.approx(1.0) and by == "operations"
    ms, by = bounds.bound_ms(3.35e9, bf16_ops=989e9, f32_ops=67e9)
    assert ms == pytest.approx(2.0) and by == "operations"


@pytest.mark.parametrize("nb,w,tm,tn", [(1000, 0, 8, 128), (1000, 8, 8, 128),
                                        (1000, 256, 8, 128), (37, 3, 4, 8)])
def test_bsr_tiles_match_a_direct_count(nb, w, tm, tn):
    """A tile is stored when its rows and columns hold a band entry, i.e.
    the distance between its row range and its column range is <= w."""
    count = 0
    for r0 in range(0, nb, tm):
        r1 = min(r0 + tm, nb) - 1
        for c0 in range(0, nb, tn):
            c1 = min(c0 + tn, nb) - 1
            gap = max(c0 - r1, r0 - c1, 0)
            count += gap <= w
    assert bounds.bsr_tiles(nb, w, tm, tn) == count


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
