"""serve.stage2_factor_ms: the wall time of forming Stage II's operand in a
solve (the program's ``stage2/factor`` span inside ``solve/stage2``: Ã⁻¹
on the 'fused' route; a ``StepTimer`` phase ended by a fetch barrier),
median over the traced solves, ms; nothing where the program has no such
span."""

from qpbench.metrics._util import phase_ms


def read(run):
    return phase_ms(run, "stage2/factor")
