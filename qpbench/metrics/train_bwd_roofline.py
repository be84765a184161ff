"""train_bwd_roofline: the training backward's least time
(``counts/train_bwd``) over the device time of the port's kernels (not
PyTorch's own) an update outside the ``train/forward`` and
``train/optimizer`` spans (the backward runs between them), %."""

from qpbench.metrics._util import ATEN, roofline_pct


def read(run):
    return roofline_pct(run.count("train_bwd"),
                        run.device_s("bench/call", skip=ATEN,
                                     exclude=("train/forward",
                                              "train/optimizer")),
                        len(run.calls))
