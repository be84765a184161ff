"""Batched BCOO matrices and their matvecs, gather-based and deterministic.

Counterpart of the BCOO half of ``iadmm_tpu/kernels/sparse.py``, where the
matrices are ``jax.experimental.sparse.BCOO`` with one batch dimension and
the matvecs are ``bcoo_dot_general`` with an explicit VJP.  A
:class:`BCOOMatrix` keeps the JAX layout (``data`` (B, nse), ``indices``
(B, nse, 2) int32 row/column, padding entries out of range at (m, n) with
value 0, as ``BCOO.fromdense`` pads) and, built once with it, two gather
plans: each row's entries and each column's entries in entry order, padded
to the longest line with a zero value at the index one past the end.

A matvec gathers the vector at each line's indices (the vector extended by
one zero, which the pad indices read), multiplies by the stored values and
sums each line: no atomic scatter, so every sum repeats bitwise from run to
run, on the CPU and on CUDA.  The transposed matvec reads the column plan.
:func:`bcoo_matvec` / :func:`bcoo_matvec_t` are differentiable in the
vector with the JAX package's VJP (dv = Mᵀ·ȳ, resp. M·ȳ; no gradient to the
matrix).

Dtypes follow ``bcoo_dot_general``: the product is taken in the promoted
dtype of the values and the vector, so bf16 values meet a float32 vector
widened (exactly) to float32 and are summed in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


def _line_plan(vals: torch.Tensor, major: torch.Tensor, minor: torch.Tensor,
               n_major: int, n_minor: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values (B, n_major, L), minor indices (B, n_major, L))``: the
    entries of each major line (row or column) in entry order, padded to the
    longest line L with value 0 at minor index ``n_minor``.  Entries with an
    index out of range are padding and left out."""
    B, nse = vals.shape
    dev = vals.device
    major, minor = major.long(), minor.long()
    valid = (major >= 0) & (major < n_major) & (minor >= 0) & (minor < n_minor)
    inst = torch.arange(B, device=dev)[:, None].expand(B, nse)
    line = (inst * n_major + major)[valid]      # (instance, entry) order
    mn, vv = minor[valid], vals[valid]
    order = torch.sort(line, stable=True).indices   # entry order per line
    line, mn, vv = line[order], mn[order], vv[order]
    counts = torch.bincount(line, minlength=B * n_major)
    width = max(int(counts.max()) if line.numel() else 0, 1)
    slot = (torch.arange(line.numel(), device=dev)
            - (torch.cumsum(counts, 0) - counts)[line])
    out_v = torch.zeros((B * n_major, width), dtype=vals.dtype, device=dev)
    out_i = torch.full((B * n_major, width), n_minor, dtype=torch.int64,
                       device=dev)
    out_v[line, slot] = vv
    out_i[line, slot] = mn
    return out_v.view(B, n_major, width), out_i.view(B, n_major, width)


@dataclasses.dataclass(frozen=True)
class BCOOMatrix:
    """A batch of (m, n) sparse matrices in BCOO form, with the row and
    column gather plans of its matvecs (built at construction)."""

    data: torch.Tensor      # (B, nse)
    indices: torch.Tensor   # (B, nse, 2) int32: (row, column)
    shape: Tuple[int, int]  # (m, n) of one instance
    rows: Tuple[torch.Tensor, torch.Tensor] = dataclasses.field(
        init=False, repr=False)
    cols: Tuple[torch.Tensor, torch.Tensor] = dataclasses.field(
        init=False, repr=False)

    def __post_init__(self):
        if self.data.dim() != 2 or self.indices.shape != (
                *self.data.shape, 2):
            raise ValueError(f"BCOO data must be (B, nse) and indices "
                             f"(B, nse, 2); got {tuple(self.data.shape)} "
                             f"and {tuple(self.indices.shape)}")
        m, n = self.shape
        r, c = self.indices[..., 0], self.indices[..., 1]
        object.__setattr__(self, "rows", _line_plan(self.data, r, c, m, n))
        object.__setattr__(self, "cols", _line_plan(self.data, c, r, n, m))

    @property
    def nse(self) -> int:
        return self.data.shape[1]

    def todense(self) -> torch.Tensor:
        """(B, m, n) dense copy (padding entries dropped)."""
        vals, idx = self.rows
        B, m, _ = vals.shape
        out = torch.zeros((B, m, self.shape[1] + 1), dtype=vals.dtype,
                          device=vals.device)
        out.scatter_(2, idx, vals)   # the pads all land in column n, as 0
        return out[..., :-1]


def bcoo_nse(M: torch.Tensor, nse_pad: int = 1024, floor: int = 0) -> int:
    """The JAX package's nse of a dense (B, m, n) batch: the largest
    nonzero count over the batch, rounded up to a multiple of ``nse_pad``,
    at least ``floor`` (and 1), at most m·n."""
    nse = int((M != 0).sum(dim=(-2, -1)).max())
    nse = max(((nse + nse_pad - 1) // nse_pad) * nse_pad, 1, floor)
    return min(nse, M.shape[-2] * M.shape[-1])


def bcoo_entries(M: torch.Tensor, nse: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(data (B, nse), indices (B, nse, 2) int32)`` of a dense batch:
    each instance's nonzeros in row-major order, then padding at (m, n)
    with value 0.  ``nse`` must hold the largest nonzero count."""
    B, m, n = M.shape
    nz = M != 0
    counts = nz.reshape(B, -1).sum(-1)
    if int(counts.max()) > nse:
        raise ValueError(f"nse={nse} is below the largest nonzero count "
                         f"{int(counts.max())}")
    b, r, c = torch.nonzero(nz, as_tuple=True)     # row-major per instance
    slot = (torch.arange(b.numel(), device=M.device)
            - (torch.cumsum(counts, 0) - counts)[b])
    data = torch.zeros((B, nse), dtype=M.dtype, device=M.device)
    idx = torch.empty((B, nse, 2), dtype=torch.int32, device=M.device)
    idx[..., 0], idx[..., 1] = m, n
    data[b, slot] = M[b, r, c]
    idx[b, slot, 0] = r.to(torch.int32)
    idx[b, slot, 1] = c.to(torch.int32)
    return data, idx


def bcoo_pad(data: torch.Tensor, idx: torch.Tensor, nse: int,
             shape: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """BCOO arrays padded to ``nse`` entries (value 0 at (m, n))."""
    B, k = data.shape
    if k >= nse:
        return data, idx
    pad_i = torch.empty((B, nse - k, 2), dtype=idx.dtype, device=idx.device)
    pad_i[..., 0], pad_i[..., 1] = shape
    return (torch.cat([data, data.new_zeros((B, nse - k))], 1),
            torch.cat([idx, pad_i], 1))


def bcoo_from_dense(M: torch.Tensor, nse_pad: int = 1024,
                    floor: int = 0) -> BCOOMatrix:
    """Dense (B, m, n) batch -> :class:`BCOOMatrix` with the JAX package's
    nse (:func:`bcoo_nse`), on M's device, in M's dtype."""
    data, idx = bcoo_entries(M, bcoo_nse(M, nse_pad, floor))
    return BCOOMatrix(data, idx, tuple(M.shape[-2:]))


def _line_matvec(plan: Tuple[torch.Tensor, torch.Tensor],
                 v: torch.Tensor) -> torch.Tensor:
    """Σ over each line of value × v[index], (B, n_minor) -> (B, n_major)."""
    vals, idx = plan
    B, lines, width = vals.shape
    dt = torch.promote_types(vals.dtype, v.dtype)
    v_ext = torch.cat([v.to(dt), v.new_zeros((B, 1), dtype=dt)], 1)
    got = torch.gather(v_ext, 1, idx.view(B, lines * width))
    return (vals.to(dt) * got.view(B, lines, width)).sum(-1)


class _BCOOMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v, fwd, bwd):
        ctx.bwd = bwd
        return _line_matvec(fwd, v)

    @staticmethod
    def backward(ctx, g):
        return _line_matvec(ctx.bwd, g), None, None


def bcoo_matvec(M: BCOOMatrix, v: torch.Tensor) -> torch.Tensor:
    """y = M·v batched, (B, n) -> (B, m); VJP dv = Mᵀ·ȳ."""
    return _BCOOMatvec.apply(v, M.rows, M.cols)


def bcoo_matvec_t(M: BCOOMatrix, v: torch.Tensor) -> torch.Tensor:
    """y = Mᵀ·v batched, (B, m) -> (B, n); VJP dv = M·ȳ."""
    return _BCOOMatvec.apply(v, M.cols, M.rows)
