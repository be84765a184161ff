"""The run's result: the numbers compared, the guard on loaded modules, and
the last line."""

from __future__ import annotations

import json
import statistics
import sys
from typing import Dict, List, Optional

# Top-level module names that may not be loaded in the process that prints
# the result: JAX and the JAX package.  Compared whole: ``iadmm_tpu_torch``
# is the port and passes.
FORBIDDEN = ("jax", "jaxlib", "flax", "iadmm_tpu")


def forbidden_loaded(modules=None) -> List[str]:
    mods = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in list(mods)}
    return sorted(t for t in tops if t in FORBIDDEN)


def p95(values: List[float]) -> float:
    """The 95th percentile, linear between order statistics (Python's
    ``statistics.quantiles(n=20, method='inclusive')``)."""
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=20, method="inclusive")[18])


class Check:
    """One number compared with its limit: ``ok`` when ``value <= limit``
    and the value is a number."""

    def __init__(self, name: str, value: Optional[float], limit: float):
        self.name, self.limit = name, float(limit)
        self.value = None if value is None else float(value)

    @property
    def ok(self) -> bool:
        return self.value is not None and self.value == self.value \
            and self.value <= self.limit

    def line(self) -> str:
        return (f"check {self.name}: {self.value!r} limit {self.limit!r} "
                f"{'ok' if self.ok else 'FAILED'}")

    def entry(self) -> Dict:
        return {"value": self.value, "limit": self.limit}


def judge(numbers: Dict[str, Optional[float]], limits: Dict[str, float]
          ) -> List[Check]:
    """A Check for each limited number; a number the run could not read is
    ``None`` and fails."""
    return [Check(k, numbers.get(k), lim) for k, lim in limits.items()]


def line(correct: bool, attempted: int, failed: int, metrics: Dict,
         device: Dict, checks: List[Check],
         breakdown: Optional[Dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: c.entry() for c in checks}
    return json.dumps(out)
