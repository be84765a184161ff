"""Profiling and debug helpers.

Counterpart of ``iadmm_tpu/utils/profiling.py``, in part: only
:func:`log_once`, the one helper the port calls.  The rest of the JAX
module (its trace, annotation, NaN-check, fetch-barrier and step-timer
helpers, and the compile watchdog, which keys on the TPU backend) waits
for a ported caller.
"""

from __future__ import annotations

_logged_once: set = set()


def log_once(key: str, msg: str) -> None:
    """Print ``msg`` at most once per process."""
    if key not in _logged_once:
        _logged_once.add(key)
        print(msg, flush=True)
