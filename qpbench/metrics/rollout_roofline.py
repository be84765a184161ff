"""rollout_roofline: the rollout's least time (``counts/rollout``,
K iterations at the cell's shape) over the device time of the operations in
the ``solve/rollout`` spans a solve, %."""

from qpbench.metrics._util import roofline_pct


def read(run):
    return roofline_pct(run.count("rollout"), run.device_s("solve/rollout"),
                        len(run.calls))
