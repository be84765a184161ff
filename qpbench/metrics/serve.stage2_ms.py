"""serve.stage2_ms: the wall time of a solve's ``solve/stage2`` stage
(``StepTimer`` phase of ``api.make_solver``, ended by a fetch barrier),
median over the traced solves, ms."""

from qpbench.metrics._util import phase_ms


def read(run):
    return phase_ms(run, "stage2")
