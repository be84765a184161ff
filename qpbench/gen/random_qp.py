"""The ``Random_QP`` family (dense PSD Q, masked Gaussian rows, two-sided
bounds on every row) made on the device from a ``torch.Generator``.

The distributions of ``iadmm_tpu_torch/problems/generators.py::
generate_random_qp`` (the reference's generate_data.py:96-134), rewritten
in torch: M ~ N(0,1) (n, n) and A0 ~ N(0,1) (m, n), each kept where an
independent U(0,1) is below 0.6; the half Hessian (MMᵀ + 0.01·I)/2, so the
solver form Q is MMᵀ + 0.01·I (twice it, as ``gen/qp.py`` keeps it);
p ~ N(0,1); zl = −U(0,1), zu = U(0,1) on every row: no equality rows.
MMᵀ is a float32 product with no TF32, made symmetric bit for bit by
averaging it with its transpose.  The instances are made in chunks of
``chunk`` (M, A0 and their masks, in that order, a chunk at a time), then
p, zl and zu as one draw each over the pool.
"""

from __future__ import annotations

import torch

from qpbench.reference.precision import no_tf32

DENSITY = 0.6      # the reference's sparsity mask: U(0,1) < 0.6 keeps
DIAG = 0.01        # Q's ridge: a floor under its eigenvalues


def pool(n: int, m: int, count: int, g: torch.Generator, device,
         chunk: int = 64) -> dict:
    """``count`` instances: Q (count, n, n) (solver form), p, A0
    (count, m, n), zl, zu, eq_mask (all False); float32."""
    kw = dict(generator=g, device=device, dtype=torch.float32)
    Q = torch.empty((count, n, n), device=device)
    A0 = torch.empty((count, m, n), device=device)
    eye = DIAG * torch.eye(n, device=device)
    with no_tf32():
        for s in range(0, count, chunk):
            k = min(chunk, count - s)
            M = torch.randn((k, n, n), **kw)
            M *= torch.rand((k, n, n), **kw) < DENSITY
            G = M @ M.transpose(1, 2)
            Q[s:s + k] = 0.5 * (G + G.transpose(1, 2)) + eye
            del M, G
            A0[s:s + k].normal_(generator=g)
            A0[s:s + k] *= torch.rand((k, m, n), **kw) < DENSITY
    p = torch.randn((count, n), **kw)
    zl = -torch.rand((count, m), **kw)
    zu = torch.rand((count, m), **kw)
    return dict(Q=Q, p=p, A0=A0, zl=zl, zu=zu,
                eq_mask=torch.zeros((count, m), dtype=torch.bool,
                                    device=device))
