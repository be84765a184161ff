"""serve.scaling_ms: the wall time of a solve's ``solve/scaling`` stage
(``StepTimer`` phase of ``api.make_solver``, ended by a fetch barrier),
median over the traced solves, ms."""

from qpbench.metrics._util import phase_ms


def read(run):
    return phase_ms(run, "scaling")
