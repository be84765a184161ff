"""train.device_idle: the share of the traced window in which no operation
ran on the device (profiler), %."""

from qpbench.metrics._util import idle_pct


def read(run):
    return idle_pct(run)
