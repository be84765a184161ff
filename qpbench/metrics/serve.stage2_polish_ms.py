"""serve.stage2_polish_ms: the wall time of Stage II's N polish steps in a
solve (the program's ``stage2/polish`` span inside ``solve/stage2``; a
``StepTimer`` phase ended by a fetch barrier), median over the traced
solves, ms; nothing where the program has no such span."""

from qpbench.metrics._util import phase_ms


def read(run):
    return phase_ms(run, "stage2/polish")
