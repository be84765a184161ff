"""train.forward_ms: the device time of the chunk loss's forward an update
(the program's ``chunk/forward`` span in ``harness.make_chunk_body``,
ended by a device synchronisation under the profiler), ms; nothing where
the program has no such span."""

from qpbench.lib import profile


def read(run):
    if not run.calls or not profile.spans(run.records, "chunk/forward"):
        return None
    return 1e3 * run.device_s("chunk/forward") / len(run.calls)
