"""The readers of the program's own spans inside a stage or an update:
Stage II's ``stage2/factor`` and ``stage2/polish`` (serving), and the chunk
update's ``chunk/forward`` and ``chunk/backward`` (training)."""

import time

import pytest

from qpbench.lib import profile, spec
from qpbench.lib.context import RunContext
from qpbench.tests import tiny

SERVE, TRAIN = "qp1000-serve-polish", "qp1000-train-fused"
TRAIN_READERS = ("train.forward_ms", "train.backward_ms",
                 "train.backward_idle_ms")


def _read(name, run):
    return spec.metric_reader(name).read(run)


def test_tiny_traced_serving_reports_stage2_factor_and_polish(capsys):
    rc, line, _ = tiny.run(capsys, SERVE, trace=1)
    assert rc == 0 and line["correct"] is True
    got = {k: v["value"] for k, v in line["metrics"].items()}
    parts = ("serve.stage2_factor_ms", "serve.stage2_polish_ms")
    assert all(got[k] > 0 for k in parts)
    # medians of phases that nest in stage2: each below it
    assert all(got[k] <= got["serve.stage2_ms"] for k in parts)


def _traced_train():
    """The tiny training cell's traced window on the CPU (no device
    operations: the profile holds the host's spans only)."""
    cfg = {**spec.config(tiny.BENCH, spec.cell(tiny.BENCH, TRAIN)["config"]),
           **tiny.CONFIG}
    cell = {**spec.cell(tiny.BENCH, TRAIN), **tiny.CELL[TRAIN]}
    ctx = RunContext(config=cfg, cell=cell, seed=5, seconds=0.3, trace=True,
                     device="cpu", t_start=time.perf_counter())
    return spec.traffic(cell["kind"]).run(ctx)["trace"]


@pytest.fixture(scope="module")
def train_run():
    return _traced_train()


def test_chunk_spans_nest_in_each_traced_update(train_run):
    updates = profile.spans(train_run.records, "bench/call")
    assert len(updates) == len(train_run.calls)
    fwd = profile.spans(train_run.records, "chunk/forward")
    bwd = profile.spans(train_run.records, "chunk/backward")
    assert len(fwd) == len(bwd) == len(updates)
    for (lo, hi), (a, b), (c, d) in zip(updates, fwd, bwd):
        assert lo <= a <= b <= c <= d <= hi
    # the benchmark's own forward sits inside the program's, never the same
    # name inside itself; its optimizer step comes after the backward
    for (a, b), (lo, hi) in zip(profile.spans(train_run.records,
                                              "train/forward"), fwd):
        assert lo <= a <= b <= hi
    for (a, _), (_, d) in zip(profile.spans(train_run.records,
                                            "train/optimizer"), bwd):
        assert d <= a


def test_training_readers_on_planted_device_operations(train_run):
    """Device operations planted in the CPU profile: a quarter of each
    backward interval busy (two overlapping kernels), a 1 ms kernel at the
    start of each forward; the readers give those times an update."""
    run = train_run
    n = len(run.calls)
    bwd = profile.spans(run.records, "chunk/backward")
    fwd = profile.spans(run.records, "chunk/forward")
    assert not profile.device_ops(run.records)
    planted = []
    for a, b in bwd:
        q = (b - a) / 4
        planted += [("kernel", "k_bwd", a, q), ("kernel", "k_bwd2", a, q / 2)]
    for a, _ in fwd:
        planted.append(("kernel", "k_fwd", a, 1e-3))
    saved = run.records
    run.records = sorted(saved + planted, key=lambda r: r[2])
    try:
        walls = sum(b - a for a, b in bwd)
        assert _read("train.backward_ms", run) == pytest.approx(
            1e3 * 0.375 * walls / n)
        assert _read("train.backward_idle_ms", run) == pytest.approx(
            1e3 * 0.75 * walls / n)
        assert _read("train.forward_ms", run) == pytest.approx(1.0)
    finally:
        run.records = saved


@pytest.mark.parametrize("name", TRAIN_READERS)
def test_training_readers_give_nothing_without_the_spans(train_run, name):
    """A program without the chunk spans (the parent's) reads nothing, and
    nothing raises."""
    saved = train_run.records
    train_run.records = [r for r in saved if not r[1].startswith("chunk/")]
    try:
        assert _read(name, train_run) is None
    finally:
        train_run.records = saved


@pytest.mark.parametrize("name", ("serve.stage2_factor_ms",
                                  "serve.stage2_polish_ms"))
def test_serving_readers_give_nothing_without_the_phases(name):
    class Run:
        calls = [{"phases": {"scaling": 1e-3, "stage2": 5e-3}}]
    assert _read(name, Run) is None
