"""kkt_pass_roofline: the rollout's KKT pass's least time
(``counts/kkt_pass``: one memory sweep of bf16 [Q; A0] a learned
iteration, with the partials and vectors the pass writes and reads back)
over the device time a solve of its kernels, ``iadmm::kkt::colpass*`` and
``iadmm::admm::finish*`` inside the ``solve/rollout`` spans, %; nothing
where the trace holds none of them."""

from qpbench.metrics._util import roofline_pct


def read(run):
    return roofline_pct(run.count("kkt_pass"),
                        run.device_s("solve/rollout",
                                     only=("iadmm::kkt::colpass",
                                           "iadmm::admm::finish")),
                        len(run.calls))
