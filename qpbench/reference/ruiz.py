"""Modified Ruiz equilibration of the KKT matrix with cost normalisation.

The same mathematics as ``iadmm_tpu_torch/scaling/ruiz.py`` (commit
cc8fe97), written anew: column infinity norms of [[Q, A0ᵀ], [A0, 0]],
clamped to [1e-4, 1e4] with entries clamped to the floor reset to 1, and a
cost factor 1 / max(mean column norm of Q, ‖p‖∞) each sweep.  Returns the
scaled data and the factors (d, e, cost): x = d·x̄, z = z̄ / e,
y = (e / cost)·ȳ.
"""

from __future__ import annotations

import torch


def _limit(v):
    c = v.clamp(1e-4, 1e4)
    return torch.where(c == 1e-4, torch.ones_like(c), c)


def scale(Q, p, A0, zl, zu, iters: int = 10):
    B, n = p.shape
    m = A0.shape[1]
    d = Q.new_ones((B, n))
    e = Q.new_ones((B, m))
    cost = Q.new_ones((B,))
    for _ in range(iters):
        col = torch.maximum(Q.abs().amax(1), A0.abs().amax(1))
        row = A0.abs().amax(2)
        s = 1.0 / torch.sqrt(_limit(torch.cat([col, row], 1)))
        dt, et = s[:, :n], s[:, n:]
        Q = Q * dt[:, :, None] * dt[:, None, :]
        A0 = A0 * et[:, :, None] * dt[:, None, :]
        p, zl, zu = p * dt, zl * et, zu * et
        d, e = d * dt, e * et
        c = 1.0 / _limit(torch.maximum(_limit(p.abs().amax(1)),
                                       Q.abs().amax(1).mean(1)))
        Q, p, cost = Q * c[:, None, None], p * c[:, None], cost * c
    return Q, p, A0, zl, zu, d, e, cost
