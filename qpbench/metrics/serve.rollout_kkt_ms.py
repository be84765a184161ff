"""serve.rollout_kkt_ms: the device time a solve of the rollout's KKT
pass, the kernels ``iadmm::kkt::colpass*`` and ``iadmm::admm::finish*``
(two of each a learned iteration) inside the ``solve/rollout`` spans, ms;
nothing where the trace holds none of them."""


def read(run):
    if not run.calls:
        return None
    s = run.device_s("solve/rollout",
                     only=("iadmm::kkt::colpass", "iadmm::admm::finish"))
    return 1e3 * s / len(run.calls) if s > 0 else None
