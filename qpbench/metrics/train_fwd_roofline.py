"""train_fwd_roofline: the training forward's least time
(``counts/train_fwd``) over the device time of the port's kernels (not
PyTorch's own) in the ``train/forward`` spans an update, %."""

from qpbench.metrics._util import ATEN, roofline_pct


def read(run):
    return roofline_pct(run.count("train_fwd"),
                        run.device_s("train/forward", skip=ATEN),
                        len(run.calls))
