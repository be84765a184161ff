"""Shared arithmetic of the per-layer readers."""

from __future__ import annotations

import statistics

from qpbench.lib import roofline

# PyTorch's own kernels (aten) are not the port's hand-written ones
ATEN = ("at::", "aten::")


def phase_ms(run, name):
    """The median over the traced calls of a program span's wall time, in
    ms (``StepTimer``), or None where no call has it."""
    vals = [c["phases"][name] for c in run.calls if name in c["phases"]]
    return 1e3 * statistics.median(vals) if vals else None


def roofline_pct(work: dict, device_s: float, calls: int):
    """Least time of ``work`` over the device time a call, in %."""
    if not calls or device_s <= 0:
        return None
    bound, _ = roofline.bound_ms(work["bytes"], work["bf16_ops"],
                                 work["f32_ops"])
    return 100.0 * bound / (1e3 * device_s / calls)


def mfu_pct(works, run):
    """Least time of the operations of ``works`` at the published peaks
    over the traced window's time a call, in %."""
    if not run.calls or run.window_s <= 0:
        return None
    ops = sum(roofline.ops_ms(w["bf16_ops"], w["f32_ops"]) for w in works)
    return 100.0 * ops / (1e3 * run.window_s / len(run.calls))


def idle_pct(run):
    if run.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s() / run.window_s)
