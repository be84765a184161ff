"""stage2_roofline: the least time of the work Stage II needs
(``counts/stage2``: one factorization by the cheaper route and N polish
steps) over the device time of every operation in the ``solve/stage2``
spans a solve (the operand's formation included), %."""

from qpbench.metrics._util import roofline_pct


def read(run):
    return roofline_pct(run.count("stage2"), run.device_s("solve/stage2"),
                        len(run.calls))
