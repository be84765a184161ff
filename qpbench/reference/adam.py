"""The training optimizer's arithmetic: optax's ``clip_by_global_norm``
then Adam (β = 0.9, 0.999, ε = 1e-8 outside the square root, bias
corrected), as ``iadmm_tpu_torch/train/harness.py::ClippedAdam`` states it
(commit cc8fe97), written anew: every gradient becomes g·c/‖g‖ when the
global norm ‖g‖ reaches c, and stays as it is below."""

from __future__ import annotations

import math

import torch


class Adam:
    def __init__(self, params: dict, lr: float, clip: float):
        self.params, self.lr, self.clip = params, lr, clip
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> dict:
        """One update; returns the gradients as the moments take them."""
        g = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in self.params.items()}
        if self.clip:
            norm = torch.sqrt(sum((v * v).sum() for v in g.values()))
            if float(norm) >= self.clip:
                g = {k: v / norm * self.clip for k, v in g.items()}
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for k, p in self.params.items():
            self.m[k] = 0.9 * self.m[k] + 0.1 * g[k]
            self.v[k] = 0.999 * self.v[k] + 0.001 * g[k] * g[k]
            denom = self.v[k].sqrt() / math.sqrt(c2) + 1e-8
            p -= (self.lr / c1) * self.m[k] / denom
            p.grad = None
        return g
