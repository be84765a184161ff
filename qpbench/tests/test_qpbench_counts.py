"""Each work count at a tiny shape against a hand computation, and the
frozen copies against the port's ``kernels/bounds.py`` they were copied
from."""

import pytest

from qpbench.lib import roofline, spec


def test_bound_ms_is_the_larger_time():
    ms, by = roofline.bound_ms(3.35e12, bf16_ops=0.0, f32_ops=67e9)
    assert ms == pytest.approx(1000.0) and by == "bytes"
    ms, by = roofline.bound_ms(0.0, bf16_ops=989e12 * 2)
    assert ms == pytest.approx(2000.0) and by == "operations"


def test_rollout_count_by_hand():
    w = spec.count("rollout", dict(B=1, n=2, m=1, h=1, K=1))
    # Q 4 + A0 2 bf16, p/zl/zu/mult 2+3 f32, weights (8+4+1) bf16, b 4 f32,
    # schedules 2 f32, x y z out 2+2 f32
    assert w["bytes"] == 6 * 2 + 5 * 4 + 13 * 2 + 4 * 4 + 2 * 4 + 4 * 4
    assert w["bf16_ops"] == 2 * 3 * 1 * 4 + 4 * (4 + 4)
    assert w["f32_ops"] == 3 * (16 + 20)


def test_stage2_count_by_hand():
    # n=2, m=1: LU 2/3·27 = 18 against 2·1·4 + 8/3 = 10.67 → the cheaper
    w = spec.count("stage2", dict(B=1, n=2, m=1, N=1))
    step = 4 * 4 + 2 * 2 * 4 + 2 * 4 + 20 * 3
    assert w["f32_ops"] == pytest.approx(2 * 1 * 4 + 8 / 3 + step)
    assert w["bytes"] == 4 * (4 + 2 + 4 + 4 + (4 + 2 + 2))


def test_frozen_copies_match_the_port_bounds():
    from iadmm_tpu_torch.kernels import bounds
    s = dict(B=2, J=5, n=7, m=3, h=4, K=9)
    for dt in ("bfloat16", "float32"):
        for k, fn in (("train_fwd", bounds.train_fwd),
                      ("train_bwd", bounds.train_bwd)):
            w = spec.count(k, dict(s, dtype=dt))
            want, _ = fn(s["B"], s["J"], s["n"], s["m"], s["h"], s["K"], dt)
            got, _ = roofline.bound_ms(w["bytes"], w["bf16_ops"],
                                       w["f32_ops"])
            assert got == pytest.approx(want, rel=1e-12)


def test_train_fwd_count_by_hand():
    w = spec.count("train_fwd", dict(B=1, J=1, n=1, m=1, h=1, K=1,
                                     dtype="float32"))
    data = (1 + 1) * 4 + (1 + 3) * 4 + (8 + 4 + 1) * 4 + 5 * 4 + 8
    assert w["bytes"] == data + 2 * 1 * 8 + 8
    assert w["f32_ops"] == (2 * 2 * 4 + 3 * 2 * 3) + 2 * (16 + 20)
