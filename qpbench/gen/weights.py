"""Untrained LSTM solver weights from a ``torch.Generator`` on the device.

The draws of ``iadmm_tpu_torch/solvers/cells.py::lstm_init`` (commit
cc8fe97): W (in, 4h), U (h, 4h), W_h (h, 1) and the raw rho / alpha
schedules (K,) are N(0, 0.01²), in that order; b (4h,) and b_h (1,) are
zero.  ``scale`` multiplies named leaves after the draws, which stay the
same.  The benchmark makes them and hands a copy to each side."""

from __future__ import annotations

import torch


def lstm(g: torch.Generator, input_dim: int, h: int, K: int, device,
         scale: dict | None = None) -> dict:
    def normal(shape):
        return 0.01 * torch.randn(shape, generator=g, device=device)

    W, U = normal((input_dim, 4 * h)), normal((h, 4 * h))
    b = torch.zeros((4 * h,), device=device)
    W_h = normal((h, 1))
    b_h = torch.zeros((1,), device=device)
    out = dict(W=W, U=U, b=b, W_h=W_h, b_h=b_h, rho=normal((K,)),
               alpha=normal((K,)))
    for k, f in (scale or {}).items():
        out[k] = f * out[k]
    return out
