"""serve.mfu: the least time of a solve's operations at the published
peaks (Ruiz, the rollout's K iterations, Stage II's work, the residuals;
``counts/``) over the traced window's time a solve, %."""

from qpbench.metrics._util import mfu_pct


def read(run):
    return mfu_pct([run.count(k) for k in ("ruiz", "rollout", "stage2",
                                           "residuals")], run)
