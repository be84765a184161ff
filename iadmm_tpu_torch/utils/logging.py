"""Structured run logging.

Counterpart of ``iadmm_tpu/utils/logging.py``: every epoch or evaluation
record can be appended to a JSONL run log keyed by the run name, so
training curves survive the process and can be compared across runs.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class RunLog:
    """Append-only JSONL logger: one record per event."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)

    def log(self, kind: str, **record) -> None:
        if not self.path:
            return
        record = {"ts": time.time(), "kind": kind, **record}
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")

    def read(self):
        if not self.path or not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
