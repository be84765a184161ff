"""Profiling and debug helpers.

Counterpart of ``iadmm_tpu/utils/profiling.py``:

  * :func:`trace` — a ``torch.profiler`` region (CPU and CUDA activities)
    that writes a Chrome trace under its directory;
  * :func:`annotate` — a named span in that trace;
  * :func:`span` — a named span of the program where the work happens:
    in the trace while a profiler records, a phase of the active
    :class:`StepTimer` while one is active, nothing otherwise;
  * :func:`enable_nan_checks` — autograd's anomaly detection;
  * :func:`fetch_barrier` — a one-element device-to-host copy of every
    CUDA leaf of a tree, a completion barrier;
  * :class:`StepTimer` — wall-clock a phase, summed over its calls, each
    ended by :func:`fetch_barrier`;
  * :func:`start_compile_watchdog` / :func:`compile_watchdog` — a message
    when a first dispatch runs past its budget; purely observational.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from .timing import tree_leaves

_logged_once: set = set()


def log_once(key: str, msg: str) -> None:
    """Print ``msg`` at most once per process."""
    if key not in _logged_once:
        _logged_once.add(key)
        print(msg, flush=True)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a region: ``with trace(logdir): run(...)`` records the host
    ops and, where CUDA is available, the kernels, and writes a Chrome
    trace (``trace_<pid>_<ns>.json``, loadable in chrome://tracing or
    Perfetto) under ``logdir``.  Yields the profiler, so the caller can
    also read ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named span in the :func:`trace` timeline (a context manager): the
    bare span, with no wait for the device and no timer."""
    return torch.profiler.record_function(name)


# The StepTimer that spans time, set by StepTimer.active() (per thread and
# per task, so nothing is threaded through the call chain)
_ACTIVE_TIMER: contextvars.ContextVar = contextvars.ContextVar(
    "iadmm_active_step_timer", default=None)
_profiling = torch._C._autograd._profiler_enabled


class _DropBox(dict):
    """The box of a span that records nothing: what the block sets in it is
    dropped, so the shared box holds no tensor."""
    __slots__ = ()

    def __setitem__(self, key, value):
        pass


_OFF = contextlib.nullcontext(_DropBox())


def span(name: str, key: Optional[str] = None):
    """A named span of the program (a context manager yielding ``box``, as
    :meth:`StepTimer.phase` does: the block may set ``box['result']``).

    - While a profiler records (:func:`trace`, ``torch.profiler``), it is
      :func:`annotate` ``(name)``, and it waits for the device before it
      ends (``torch.cuda.synchronize``), so that a device operation is
      attributed to the span in which it starts.  Nested spans nest in the
      trace.
    - While a :class:`StepTimer` is active (:meth:`StepTimer.active`), it
      is also a phase of that timer under ``key`` (default ``name``),
      ended by :func:`fetch_barrier` of ``box['result']``.  Names are
      paths (``stage2/factor`` inside ``solve/stage2``), so the phases of
      nested spans keep apart.
    - Otherwise it does nothing: no record, no clock read, no wait, no
      allocation."""
    timer = _ACTIVE_TIMER.get()
    if timer is None and not _profiling():
        return _OFF
    return _recorded(name, key or name, timer)


@contextlib.contextmanager
def _recorded(name: str, key: str, timer):
    profiled = _profiling()
    with annotate(name) if profiled else contextlib.nullcontext():
        # the phase first, so that it times what StepTimer.phase times
        with timer.phase(key) if timer is not None \
                else contextlib.nullcontext({}) as box:
            yield box
        if profiled and torch.cuda.is_initialized():
            torch.cuda.synchronize()


def enable_nan_checks(on: bool = True) -> None:
    """Turn autograd's anomaly detection on or off.  Unlike the JAX
    package's ``jax_debug_nans``, which stops at the first primitive whose
    forward output holds a NaN, this checks the backward pass: a NaN
    produced by a backward function raises, naming the forward op that
    created it.  A NaN in a forward pass without a backward (serving) is
    not caught, and the check slows every backward."""
    torch.autograd.set_detect_anomaly(on)


_WATCHDOG_HINT = (
    "On the card this window includes the first build of the port's CUDA "
    "kernels by nvcc (one process per iadmm_tpu_torch/kernels/csrc/*.cu, "
    "cached in iadmm_tpu_torch/_build/ for later runs); knobs: CUDA_HOME "
    "names the toolkit, kernels._build.build_all() builds ahead of time, "
    "use_pallas=false runs the plain cell and train_backend='step' the "
    "step route.")


def start_compile_watchdog(label: str, budget_s: float = 120.0,
                           hint: str = ""):
    """Print one message if a first-dispatch region runs past
    ``budget_s``; returns a zero-argument ``cancel`` to call after the
    region.  Purely observational: it never stops the region.  The
    port's first dispatch builds the CUDA kernels it launches (see the
    message)."""
    done = threading.Event()

    def _warn():
        if not done.wait(budget_s):
            print(f"[compile-watchdog] {label}: first dispatch still "
                  f"running after {budget_s:.0f}s. "
                  + (hint or _WATCHDOG_HINT), flush=True)

    threading.Thread(target=_warn, daemon=True).start()
    return done.set


@contextlib.contextmanager
def compile_watchdog(label: str, budget_s: float = 120.0, hint: str = ""):
    """Context-manager form of :func:`start_compile_watchdog`."""
    cancel = start_compile_watchdog(label, budget_s, hint)
    try:
        yield
    finally:
        cancel()


def fetch_barrier(tree) -> None:
    """Wait for every CUDA tensor of ``tree`` by copying one of its
    elements to the host (the copy waits for the work queued before it on
    the current stream).  Other leaves need no wait."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            leaf.detach().reshape(-1)[:1].cpu()


class StepTimer:
    """Per-phase wall clock, each phase's end waiting for the device.

    timer = StepTimer()
    with timer.phase('scaling', result_tree=scaled): ...
    timer.summary() -> {'scaling': {'total': s, 'count': k, 'mean': s/k}}

    The block may instead set ``box['result']`` on the dict it is given.
    ``with timer.active(): ...`` makes the timer the one that every
    :func:`span` inside the block times.
    """

    def __init__(self):
        self._acc: Dict[str, list] = collections.defaultdict(list)

    @contextlib.contextmanager
    def active(self):
        token = _ACTIVE_TIMER.set(self)
        try:
            yield self
        finally:
            _ACTIVE_TIMER.reset(token)

    @contextlib.contextmanager
    def phase(self, name: str, result_tree=None):
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            sync = box.get("result", result_tree)
            if sync is not None:
                fetch_barrier(sync)
            self._acc[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: dict(total=float(np.sum(v)), count=len(v),
                        mean=float(np.mean(v)))
                for k, v in self._acc.items()}
