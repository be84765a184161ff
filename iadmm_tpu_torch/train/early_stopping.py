"""Tolerance-gated early stopping.

Counterpart of ``iadmm_tpu/train/early_stopping.py``, the same logic: a
candidate counts only when every max violation is within tolerance (one
tolerance for every constraint class).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence


class EarlyStopping:
    def __init__(self, patience: int = 100,
                 save_fn: Optional[Callable] = None):
        self.patience = patience
        self.save_fn = save_fn
        self.counter = 0
        self.best_loss: Optional[float] = None
        self.early_stop = False

    def step(self, loss: float, mode: str, tol: float,
             violations: Sequence[float]) -> bool:
        improved = False
        if all(v <= tol for v in violations):
            if self.best_loss is None:
                improved = True
            elif mode == "min" and loss <= self.best_loss:
                improved = True
            elif mode == "max" and loss >= self.best_loss:
                improved = True

        if improved:
            self.best_loss = loss if self.best_loss is None else (
                min(loss, self.best_loss) if mode == "min"
                else max(loss, self.best_loss))
            self.counter = 0
            if self.save_fn is not None:
                self.save_fn()
        else:
            self.counter += 1

        if self.counter >= self.patience:
            self.early_stop = True
        return self.early_stop
