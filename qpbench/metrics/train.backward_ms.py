"""train.backward_ms: the device time of the chunk loss's backward an
update (the program's ``chunk/backward`` span around ``loss.backward()``
in ``harness.make_chunk_body``, ended by a device synchronisation under
the profiler), ms; nothing where the program has no such span."""

from qpbench.lib import profile


def read(run):
    if not run.calls or not profile.spans(run.records, "chunk/backward"):
        return None
    return 1e3 * run.device_s("chunk/backward") / len(run.calls)
