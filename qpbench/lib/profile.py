"""The traced run's records: ``torch.profiler`` over the traced window.

The profile is written as a Chrome trace into a temporary directory (under
``TMPDIR``), read back into plain records and deleted.  A record is
``(cat, name, start_s, dur_s)``: ``cat`` is the trace's category
(``kernel``, ``gpu_memcpy``, ``gpu_memset`` on the device;
``user_annotation`` for a ``record_function`` span, ``cpu_op`` for an
operator on the host).  Times are seconds on the profile's clock.

Device time is attributed to a span by time: a device operation belongs to
a span when it starts inside one of the span's intervals.  That holds where
the span ends with a device synchronisation (the traced run's spans do).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")

Record = Tuple[str, str, float, float]


class Profile:
    """``with Profile(cuda) as prof: ...`` then ``prof.records``."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.records: List[Record] = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        with tempfile.TemporaryDirectory(prefix="qpbench-trace-") as d:
            path = os.path.join(d, "trace.json")
            self._prof.export_chrome_trace(path)
            self.records = read_chrome_trace(path)
        self._prof = None
        return False


def read_chrome_trace(path: str) -> List[Record]:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    out = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS or cat in HOST_CATS:
            out.append((cat, str(e.get("name", "")),
                        float(e["ts"]) * 1e-6, float(e.get("dur", 0)) * 1e-6))
    out.sort(key=lambda r: r[2])
    return out


def device_ops(records: List[Record]) -> List[Record]:
    return [r for r in records if r[0] in DEVICE_CATS]


def spans(records: List[Record], name: str) -> List[Tuple[float, float]]:
    """The intervals of the ``record_function`` span ``name``."""
    return sorted((r[2], r[2] + r[3]) for r in records
                  if r[0] == "user_annotation" and r[1] == name)


def ops_in(records: List[Record], span_name: str) -> List[Record]:
    """The device operations that start inside a ``span_name`` interval."""
    ivals = spans(records, span_name)
    starts = [a for a, _ in ivals]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ivals[i][1]
    return [r for r in device_ops(records) if inside(r[2])]


def union_s(ivals: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``ivals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(ivals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def window(records: List[Record], name: str = "bench/window"
           ) -> Tuple[float, float]:
    iv = spans(records, name)
    if not iv:
        raise ValueError(f"no {name!r} span in the profile")
    return iv[0][0], iv[-1][1]


def busy_s(records: List[Record], lo: float, hi: float) -> float:
    return union_s([(r[2], r[2] + r[3]) for r in device_ops(records)], lo, hi)


def _host_label(host: List[Record], starts: List[float], t: float) -> str:
    """``<span> > <operator>``: the innermost span and the innermost
    operator inside it that run at ``t`` (scanning back from the last
    record that starts before ``t``: the first that covers it is the
    innermost)."""
    i = bisect.bisect_right(starts, t) - 1
    span = op = None
    while i >= 0:
        cat, name, a, d = host[i]
        if span is not None and a < span[2]:
            break
        if a + d >= t:
            if cat == "user_annotation":
                span = host[i]
            elif op is None:
                op = host[i]
        i -= 1
    if span is None:
        return op[1] if op else "(host idle)"
    return span[1] + (" > " + op[1] if op else "")


def breakdown(records: List[Record], lo: float, hi: float,
              top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle gaps of the
    device summed by what the host was doing when each began."""
    ops: Dict[str, float] = {}
    dev = sorted((r for r in device_ops(records) if lo <= r[2] <= hi),
                 key=lambda r: r[2])
    for _, name, _, d in dev:
        ops[name[:160]] = ops.get(name[:160], 0.0) + d
    host = [r for r in records if r[0] in HOST_CATS]
    starts = [r[2] for r in host]
    gaps: Dict[str, float] = {}
    end = lo
    for _, _, a, d in dev + [("", "", hi, 0.0)]:
        if a > end:
            label = _host_label(host, starts, end)[:160]
            gaps[label] = gaps.get(label, 0.0) + (a - end)
        end = max(end, a + d)
    return {
        "device_ops": [[k, v] for k, v in sorted(
            ops.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[k, v] for k, v in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:top]],
    }
