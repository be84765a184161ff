"""Run logging, timing and profiling."""

from .timing import Timer, block_tree
from .profiling import (trace, annotate, span, enable_nan_checks,
                        fetch_barrier, StepTimer)
from .logging import RunLog

__all__ = ["Timer", "block_tree", "trace", "annotate", "span",
           "enable_nan_checks", "fetch_barrier", "StepTimer", "RunLog"]
