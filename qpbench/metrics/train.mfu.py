"""train.mfu: the least time of a chunk update's operations at the
published peaks (the forward and backward of ``counts/``, and the
optimizer) over the traced window's time an update, %."""

from qpbench.metrics._util import mfu_pct


def read(run):
    return mfu_pct([run.count(k) for k in run.shape["update_counts"]], run)
