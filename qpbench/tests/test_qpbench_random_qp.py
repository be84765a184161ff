"""The ``Random_QP`` cell, ``rqp2000-serve-polish``: its generator's laws,
the KKT pass's work count by hand, its two readers on a synthetic trace,
and tiny runs on the CPU through ``run.main`` with the program, with the
control and with each serving fault (``faults.py``), held to the cell's
own limits.  Its own tiny sizes: m = 2n two-sided rows, K = 40."""

import types

import pytest
import torch

from qpbench import faults
from qpbench.gen import random_qp
from qpbench.lib import roofline, spec
from qpbench.lib.trace_run import TraceRun
from qpbench.tests import tiny

CELL = "rqp2000-serve-polish"
CONFIG = dict(num_var=12, num_ineq=24, num_eq=0, hidden_dim=20, outer_T=40,
              truncated_length=10, batch_size=2)
SIZES = dict(pool=8, batch=2, feas_rest_num=4, warmup=1, trace_solves=2,
             check_solves=2)


def _pool(seed, n=16, m=32, count=6):
    return random_qp.pool(n, m, count, torch.Generator().manual_seed(seed),
                          "cpu", chunk=4)


def test_pool_follows_the_family_laws():
    d = _pool(3)
    Q, A0 = d["Q"], d["A0"]
    assert torch.equal(Q, Q.transpose(1, 2))
    assert float(torch.linalg.eigvalsh(Q.double()).min()) >= 0.01 * (1 - 1e-4)
    # M and A0 kept where U(0,1) < 0.6; Q = MMᵀ + 0.01·I is dense
    assert abs(float((A0 != 0).float().mean()) - 0.6) < 0.03
    off = Q - torch.diag_embed(Q.diagonal(0, 1, 2))
    assert float((off != 0).float().mean()) > 0.9
    assert bool((d["zl"] < 0).all()) and bool((d["zu"] > 0).all())
    assert bool((d["zl"] >= -1).all()) and bool((d["zu"] <= 1).all())
    assert d["eq_mask"].shape == (6, 32) and not bool(d["eq_mask"].any())
    assert all(v.dtype == torch.float32 for k, v in d.items()
               if k != "eq_mask")


def test_same_seed_same_pool():
    a, b, c = _pool(5), _pool(5), _pool(6)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["A0"], c["A0"])


def test_kkt_pass_count_by_hand():
    # B=1, n=2, m=1, K=1: S=3, one chunk of 32 rows
    w = spec.count("kkt_pass", dict(B=1, n=2, m=1, K=1))
    sweep = 2 * 3 * 2                       # [Q; A0] in bf16, once
    a_pass = 4 * (3 + 2 * 1 * 2 + 2 * 1 + 3)  # w, partials, rowdot, out
    b_tilde = 4 * (2 * 2 + 3 * 1)           # x, p; z, y, multipliers
    assert w["bytes"] == sweep + 2 * a_pass + b_tilde
    assert w["bf16_ops"] == 2 * (2 * 3 * 2 + 2 * 1 * 2)
    assert w["f32_ops"] == 2 * 6 * 3


def _synthetic(kernels):
    """A traced run of two solves whose profile holds one ``solve/rollout``
    span and the device operations ``kernels`` ((name, start, dur))."""
    ctx = types.SimpleNamespace(config={}, cell={})
    run = TraceRun(ctx, dict(B=8, n=1000, m=2000, h=200, K=600, N=20))
    run.records = sorted(
        [("user_annotation", "solve/rollout", 0.0, 1.0)]
        + [("kernel", k, a, d) for k, a, d in kernels], key=lambda r: r[2])
    run.calls = [{"phases": {}}, {"phases": {}}]
    return run


def test_kkt_readers_on_a_synthetic_trace():
    run = _synthetic([
        ("void iadmm::kkt::colpass_kernel<__nv_bfloat16, true, 1, true>",
         0.1, 2e-3),
        ("iadmm::admm::finish_kernel(int, float const*)", 0.2, 1e-3),
        ("iadmm::cell::rollout_cell_kernel(CUtensorMap)", 0.3, 0.5),
        ("iadmm::admm::update_kernel(float const*)", 0.9, 1e-3),
        # outside the span: not the rollout's
        ("void iadmm::kkt::colpass_kernel<float, false, 1, true>", 1.5, 0.1),
    ])
    ms = spec.metric_reader("serve.rollout_kkt_ms").read(run)
    assert ms == pytest.approx(1.5)   # 3 ms over two solves
    w = spec.count("kkt_pass", run.shape)
    least, by = roofline.bound_ms(w["bytes"], w["bf16_ops"], w["f32_ops"])
    assert by == "bytes"
    pct = spec.metric_reader("kkt_pass_roofline").read(run)
    assert pct == pytest.approx(100.0 * least / 1.5)


def test_kkt_readers_read_nothing_without_the_kernels():
    run = _synthetic([("iadmm::cell::rollout_cell_kernel", 0.3, 0.5)])
    for name in ("serve.rollout_kkt_ms", "kkt_pass_roofline"):
        assert spec.metric_reader(name).read(run) is None


def _run(capsys, seed=21, trace=0, program="port"):
    import json
    from qpbench import run as R
    rc = R.main(["--workload", CELL, "--seed", str(seed), "--seconds", "0.3",
                 "--trace", str(trace)], device="cpu", program=program,
                config_override=CONFIG, cell_override=SIZES,
                bench=tiny.BENCH)
    out = capsys.readouterr()
    return rc, json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_is_correct(capsys, trace):
    rc, line, err = _run(capsys, trace=trace)
    assert rc == 0 and line["correct"] is True, err
    assert set(line["checks"]) == set(spec.load_json(
        spec.PKG / "workloads" / f"{CELL}.json")["limits"])


def test_tiny_control_is_not_correct(capsys):
    rc, line, err = _run(capsys, program="control")
    assert rc == 0 and line["correct"] is False, err


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_serving_fault_makes_the_run_not_correct(capsys, fault):
    # faults.planted picks the serving faults by the kind's name
    # (serve_closed); this kind takes them by name from the same module
    with faults._serve(fault):
        rc, line, err = _run(capsys)
    assert rc == 0 and line["correct"] is False, err
