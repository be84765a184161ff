"""The port's timing and profiling utilities, ``best_lstm_step`` and the
package's public surface, beside their JAX twins, on the CPU.

Mirrors ``tests/test_profiling.py`` (the compile watchdog fires after its
budget and is silent when cancelled; ``StepTimer`` sums its phases), and
holds ``StepTimer``'s summary keys and counts to the JAX one's on the same
phases; ``Timer``, ``block_tree`` and ``fetch_barrier`` on CPU tensors;
``trace`` writes a Chrome trace that holds an ``annotate`` span.
``best_lstm_step(device='cpu')``'s step against the JAX
``best_lstm_step()``'s in float64.  Every name of every JAX ``__all__``
imports from the port, apart from ``NO_COUNTERPART``.
"""

import importlib
import json
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import iadmm_tpu as jit_
from iadmm_tpu import solvers as jsolvers
from iadmm_tpu.problems import generators as jgen, io as jio
from iadmm_tpu.utils import profiling as jprof

import iadmm_tpu_torch as it
from iadmm_tpu_torch import solvers as tsolvers
from iadmm_tpu_torch.utils import profiling as tprof, timing as ttiming

from torch_bridge import assert_close, jax_lstm_params, params_to_torch, \
    to_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
SUBPACKAGES = ("problems", "scaling", "solvers", "train", "dist",
               "evaluation", "kernels", "utils")


# ------------------------------------------------------------ watchdog

def test_compile_watchdog_fires_after_budget(capsys):
    cancel = tprof.start_compile_watchdog("probe", budget_s=0.05)
    time.sleep(0.3)
    cancel()
    out = capsys.readouterr().out
    assert "[compile-watchdog] probe" in out
    assert "nvcc" in out and "use_pallas=false" in out


def test_compile_watchdog_cancelled_is_silent(capsys):
    with tprof.compile_watchdog("quiet", budget_s=5.0):
        pass
    time.sleep(0.1)
    assert "[compile-watchdog]" not in capsys.readouterr().out


def test_harness_and_run_test_start_the_watchdog(monkeypatch):
    """Both first dispatches are watched, and each watch is cancelled."""
    from iadmm_tpu_torch.config import ExperimentConfig
    from iadmm_tpu_torch.evaluation import driver
    from iadmm_tpu_torch.solvers.cells import lstm_init
    from iadmm_tpu_torch.train import harness
    labels, cancelled = [], []

    def watch(label, budget_s=120.0, hint=""):
        labels.append(label)
        return lambda: cancelled.append(label)

    monkeypatch.setattr(harness, "start_compile_watchdog", watch)
    monkeypatch.setattr(driver, "start_compile_watchdog", watch)
    ds = jgen.generate("QP", num_var=12, num_ineq=6, num_eq=6, data_size=10,
                       seed=2)
    cfg = ExperimentConfig(prob_type="QP", num_var=12, num_ineq=6, num_eq=6,
                           data_size=10, hidden_dim=8, outer_T=4,
                           truncated_length=2, batch_size=2, num_epoch=2,
                           val_frac=0.2, test_frac=0.2, eq_tol=1e9,
                           test_batch_size=2, test_outer_T=4,
                           log_every=100)
    harness.train(cfg, ds, verbose=False, device="cpu")
    p = lstm_init(torch.Generator().manual_seed(0), 2, 8, 4, device="cpu")
    driver.run_test(cfg, ds, {k: v.numpy() for k, v in p.items()},
                    verbose=False, device="cpu")
    assert labels == cancelled == ["train chunk", "run_test warm-up"]


# ------------------------------------------------------------ timers

def _phases(timer_cls, tree):
    t = timer_cls()
    for name, reps in (("a", 2), ("b", 1)):
        for _ in range(reps):
            with t.phase(name, result_tree=tree):
                time.sleep(0.01)
    with t.phase("c") as box:
        box["result"] = tree
    return t.summary()


def test_step_timer_summary_matches_jax():
    tsum = _phases(tprof.StepTimer, {"x": torch.ones(3)})
    jsum = _phases(jprof.StepTimer, {"x": jnp.ones(3)})
    assert tsum.keys() == jsum.keys() == {"a", "b", "c"}
    for k in tsum:
        assert tsum[k].keys() == jsum[k].keys() == {"total", "count",
                                                     "mean"}
        assert tsum[k]["count"] == jsum[k]["count"]
    assert tsum["a"]["count"] == 2 and tsum["a"]["total"] >= 0.02
    assert tsum["a"]["mean"] == pytest.approx(tsum["a"]["total"] / 2)


def test_timer_block_tree_and_fetch_barrier_on_cpu_tensors():
    tree = {"a": [torch.ones(2), (torch.zeros(1), 3)], "b": None,
            "c": np.ones(2)}
    assert ttiming.block_tree(tree) is tree
    assert ttiming.cuda_devices(tree) == []
    tprof.fetch_barrier(tree)   # no CUDA leaf: nothing to wait for
    with ttiming.Timer(tree) as t:
        time.sleep(0.02)
    assert t.elapsed >= 0.02
    with jit_.utils.Timer() as jt:
        time.sleep(0.02)
    assert jt.elapsed >= 0.02   # the same contract, no tree given
    leaves = ttiming.tree_leaves(tree)
    assert len(leaves) == 5 and leaves[2] == 3


def test_trace_writes_a_chrome_trace_with_the_annotate_span(tmp_path):
    with tprof.trace(str(tmp_path)):
        with tprof.annotate("iadmm/probe_span"):
            (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "iadmm/probe_span" for e in events)


def test_enable_nan_checks_toggles_anomaly_detection():
    try:
        tprof.enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0 - 1).sum().backward()
    finally:
        tprof.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


def test_make_solver_stages_are_spans_and_timed_phases(tmp_path):
    """A solve under ``trace`` with a ``StepTimer``: every stage is a
    ``solve/<stage>`` span and a timed phase, the phases sum to at most
    the call's wall time, and the result is bitwise the untimed solve's."""
    ds = jgen.generate("QP", num_var=12, num_ineq=6, num_eq=6, data_size=3,
                       seed=4)
    from iadmm_tpu_torch.problems import to_qp_batch
    data = to_qp_batch(ds, device="cpu")
    p = {k: torch.as_tensor(np.asarray(v))
         for k, v in jax_lstm_params(5, 8, 4).items()}
    kw = dict(hidden_dim=8, num_iters=4, feas_rest_num=2)
    timer = tprof.StepTimer()
    with tprof.trace(str(tmp_path)):
        with ttiming.Timer() as wall:
            got = it.make_solver(p, timer=timer, **kw)(data)
    ref = it.make_solver(p, **kw)(data)
    for f in ("x", "y", "z", "primal_res", "dual_res", "obj"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    stages = {"scaling", "rollout", "unscale", "stage2", "residuals"}
    sub = {"stage2/factor", "stage2/polish"}   # nested in stage2
    summary = timer.summary()
    assert set(summary) == stages | sub
    assert all(v["count"] == 1 for v in summary.values())
    assert sum(summary[s]["total"] for s in stages) <= wall.elapsed
    (trace_file,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in
             json.loads(trace_file.read_text())["traceEvents"]}
    assert {f"solve/{s}" for s in stages} | sub <= names


# ------------------------------------------------------------ spans

def _span_events(trace_dir):
    """{name: [(start, end), ...]} of the user spans of the one trace."""
    (trace_file,) = trace_dir.glob("trace_*.json")
    out = {}
    for e in json.loads(trace_file.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            out.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))))
    return out


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_span_off_neither_syncs_nor_reads_a_clock(monkeypatch):
    """With no profiler and no active timer a span records nothing, reads
    no clock, waits for nothing and drops what the block sets."""
    def boom(*a, **k):
        raise AssertionError("a span with tracing off did work")

    class NoClock:
        perf_counter = staticmethod(boom)

    monkeypatch.setattr(tprof, "time", NoClock)
    monkeypatch.setattr(tprof, "fetch_barrier", boom)
    monkeypatch.setattr(tprof, "annotate", boom)
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    first = tprof.span("a")
    with first as box:
        with tprof.span("a/b", key="b") as inner:
            inner["result"] = torch.ones(2)
        box["result"] = torch.ones(2)
    assert "result" not in box and "result" not in inner
    assert tprof.span("c") is first   # nothing made a call


def test_span_names_nest_under_trace(tmp_path):
    with tprof.trace(str(tmp_path)):
        with tprof.span("outer") as box:
            with tprof.span("outer/inner"):
                (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
            box["result"] = torch.ones(1)
    spans = _span_events(tmp_path)
    (outer,), (inner,) = spans["outer"], spans["outer/inner"]
    assert _inside(inner, outer)


def test_span_phases_under_active_timer():
    """Spans are phases of the active timer under their keys, nested ones
    under their path names; outside ``active()`` nothing is timed."""
    timer = tprof.StepTimer()
    with tprof.span("before"):
        pass
    with timer.active():
        with tprof.span("solve/outer", key="outer") as box:
            with tprof.span("outer/inner") as inner:
                time.sleep(0.01)
                inner["result"] = torch.ones(2)
            box["result"] = torch.ones(2)
    with tprof.span("after"):
        pass
    summary = timer.summary()
    assert set(summary) == {"outer", "outer/inner"}
    assert all(v["count"] == 1 for v in summary.values())
    assert 0.01 <= summary["outer/inner"]["total"] <= \
        summary["outer"]["total"]


def _solve_data():
    ds = jgen.generate("QP", num_var=12, num_ineq=6, num_eq=6, data_size=3,
                       seed=4)
    from iadmm_tpu_torch.problems import to_qp_batch
    data = to_qp_batch(ds, device="cpu")
    p = {k: torch.as_tensor(np.asarray(v))
         for k, v in jax_lstm_params(5, 8, 4).items()}
    return data, p


@pytest.mark.parametrize("impl", ["lu", "fused", "fused-direct", "cg"])
def test_stage2_routes_open_factor_and_polish_spans(impl):
    """Every Stage II route of ``make_solver`` times ``stage2/polish``, and
    each route that forms an operand ``stage2/factor`` (the matrix-free
    'cg' forms none); each sub-phase lies within ``stage2``, and the
    result is bitwise the untimed solve's."""
    data, p = _solve_data()
    kw = dict(hidden_dim=8, num_iters=4, feas_rest_num=2, stage2_impl=impl)
    timer = tprof.StepTimer()
    got = it.make_solver(p, timer=timer, **kw)(data)
    ref = it.make_solver(p, **kw)(data)
    for f in ("x", "y", "z", "primal_res", "dual_res", "obj"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    summary = timer.summary()
    sub = {"stage2/polish"} | ({"stage2/factor"} if impl != "cg" else set())
    assert {k for k in summary if k.startswith("stage2/")} == sub
    assert all(summary[k]["count"] == 1 for k in sub)
    assert sum(summary[k]["total"] for k in sub) <= \
        summary["stage2"]["total"]


def test_chunk_body_spans_nest_and_leave_the_update_bitwise(tmp_path):
    """Under ``trace`` one update opens ``chunk/forward`` and then
    ``chunk/backward``, once each, and its parameters, state and loss are
    bitwise those of the same update untraced."""
    from iadmm_tpu_torch.problems import to_qp_batch
    from iadmm_tpu_torch.scaling import scale_batch
    from iadmm_tpu_torch.solvers.step import lstm_step
    from iadmm_tpu_torch.train import harness
    from iadmm_tpu_torch.types import init_state
    ds = jgen.generate("QP", num_var=12, num_ineq=6, num_eq=6, data_size=2,
                       seed=3)
    data = scale_batch(to_qp_batch(ds, dtype=torch.float32,
                                   device="cpu"))[0]
    base = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32)
            for k, v in jax_lstm_params(2, 8, 4).items()}

    def update():
        params = {k: v.clone().requires_grad_(True) for k, v in base.items()}
        body = harness.make_chunk_body(
            lstm_step, harness.make_optimizer(params, 1e-3), 4, 2, 6e-6)
        st, loss = body(params, init_state(2, 12, 12, 8, device="cpu"),
                        data, 0)
        return params, st, loss

    with tprof.trace(str(tmp_path)):
        got = update()
    ref = update()
    for k in base:
        assert torch.equal(got[0][k], ref[0][k]), k
    assert torch.equal(got[1].x, ref[1].x) and torch.equal(got[2], ref[2])
    spans = _span_events(tmp_path)
    assert {k for k in spans if k.startswith("chunk/")} == \
        {"chunk/forward", "chunk/backward"}
    (fwd,), (bwd,) = spans["chunk/forward"], spans["chunk/backward"]
    assert fwd[0] <= fwd[1] <= bwd[0] <= bwd[1]


# ------------------------------------------------------------ best step

def test_best_lstm_step_cpu_matches_jax():
    """The port on the CPU takes the plain step; the JAX package on the
    CPU takes its XLA step (its probe of the Pallas cell fails there).
    Both steps on the same float64 inputs: 1e-10 relative."""
    tstep_fn, tname = tsolvers.best_lstm_step(device="cpu")
    jstep_fn, jname = jsolvers.best_lstm_step()
    assert tname == "torch-float32" and jname == "xla-float32"
    ds = jgen.generate("QP", num_var=12, num_ineq=6, num_eq=6, data_size=3,
                       seed=4)
    jdata = jio.to_qp_batch(ds, dtype=jnp.float64)
    jp = {k: jnp.asarray(v, jnp.float64)
          for k, v in jax_lstm_params(5, 8, 4).items()}
    rng = np.random.default_rng(1)
    shapes = ((3, 12), (3, 12), (3, 12), (3, 24), (3, 24, 8), (3, 24, 8))
    jst = jit_.IterState(*(jnp.asarray(0.1 * rng.standard_normal(s))
                           for s in shapes))
    jout = jstep_fn(jp, 1, jst, jdata, 6e-6)
    tout = tstep_fn(params_to_torch(jp), 1, to_torch(jst),
                    to_torch(jdata, dtype=torch.float64), 6e-6)
    for f in ("x", "y", "z", "xv", "H", "C"):
        assert_close(getattr(tout, f), getattr(jout, f), 1e-10, 1e-12, f)


def test_best_lstm_step_has_no_fallback():
    """Where the cell kernel cannot be built or launched (here: no CUDA),
    ``best_lstm_step()`` raises; the JAX package's falls back to its XLA
    step on the same failure."""
    if torch.cuda.is_available():
        pytest.skip("holds the step where the kernel cannot launch")
    with pytest.raises((RuntimeError, AssertionError)):
        tsolvers.best_lstm_step()
    with pytest.raises(ValueError, match="no step"):
        tsolvers.best_lstm_step(device="meta")


# ------------------------------------------------------------ surface

def _jax_surface():
    out = [("", n) for n in jit_.__all__]
    for sub in SUBPACKAGES:
        mod = importlib.import_module(f"iadmm_tpu.{sub}")
        out += [(sub, n) for n in mod.__all__]
    return out


def test_every_jax_name_imports_from_the_port():
    missing = []
    for sub, name in _jax_surface():
        key = f"{sub}.{name}" if sub else name
        if key in it.NO_COUNTERPART:
            continue
        mod = importlib.import_module(
            "iadmm_tpu_torch" + (f".{sub}" if sub else ""))
        if not hasattr(mod, name) or name not in mod.__all__:
            missing.append(key)
    assert not missing, f"the port lacks {missing}"
    # each listed exception is a JAX name the port really lacks
    jax_keys = {f"{s}.{n}" if s else n for s, n in _jax_surface()}
    for key, reason in it.NO_COUNTERPART.items():
        assert key in jax_keys and reason
        sub, name = key.split(".")
        assert not hasattr(importlib.import_module(
            f"iadmm_tpu_torch.{sub}"), name)


def test_public_surface_is_the_ports_own():
    assert it.make_solver.__module__ == "iadmm_tpu_torch.api"
    assert it.train.train.__module__ == "iadmm_tpu_torch.train.harness"
    assert it.evaluation.run_test.__module__ == \
        "iadmm_tpu_torch.evaluation.driver"
    assert it.utils.Timer is ttiming.Timer
    assert it.solvers.best_lstm_step is tsolvers.best_lstm_step


def test_importing_the_package_builds_nothing_and_loads_no_jax():
    code = (
        "import sys\n"
        "import iadmm_tpu_torch as it\n"
        "from iadmm_tpu_torch import *\n"
        "from iadmm_tpu_torch.kernels import _build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'orbax', 'optax', 'triton', 'tensorstore', "
        "'iadmm_tpu'))\n"
        "print(bad, _build._libs)\n"
        "sys.exit(1 if bad or _build._libs else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
