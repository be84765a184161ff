"""train.backward_idle_ms: the time an update in which the device waits on
the host inside the backward: the wall time of the program's
``chunk/backward`` intervals less the union of the device operations
inside them, ms; nothing where the program has no such span."""

from qpbench.lib import profile


def read(run):
    ivals = profile.spans(run.records, "chunk/backward")
    if not run.calls or not ivals:
        return None
    ops = [(r[2], r[2] + r[3]) for r in profile.device_ops(run.records)]
    idle = sum((b - a) - profile.union_s(ops, a, b) for a, b in ivals)
    return 1e3 * idle / len(run.calls)
