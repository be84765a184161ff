"""Fused LSTM token cell: CUDA kernel, plain version and autograd wrapper.

Replaces ``iadmm_tpu/kernels/lstm_cell.py::_cell_kernel``.  The kernel
(``csrc/lstm_cell.cu`` over ``csrc/cell_gemm.cuh``) computes the gate GEMM
with the i/f/o/u columns of the same hidden units in one tile, so the
activations, C' and H' are finished in the epilogue and the 4h gate
pre-activations never reach device memory.  Both gate dtypes of the TPU
kernel: ``'bfloat16'`` on the tensor cores (``wgmma`` fed by TMA,
``csrc/hopper.cuh``, over U re-laid by :func:`relaid_u`; bound: the H·U
GEMM at the bf16 tensor-core rate) and ``'float32'`` (the TPU kernel's
``Precision.HIGHEST``: float32 operands, nothing rounded, no TF32) on the
CUDA cores in FFMA (bound: the same GEMM at the float32 rate); see the
header of ``csrc/cell_gemm.cuh``.  Launches are counted per gate dtype:
``fused_lstm_cell.launches`` (bf16) and ``fused_lstm_cell.launches_f32``.

:func:`fused_lstm_cell` is a ``torch.autograd.Function`` whose backward
recomputes the cell with the plain :func:`cells.lstm_apply` at the same gate
dtype, as the JAX package's ``_bwd`` does.  On CPU tensors the forward runs
the plain version; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..solvers import cells
from . import _build

CELL_KEYS = ("W", "U", "b", "W_h", "b_h")
_STATE_DTYPES = (torch.bfloat16, torch.float32)
_GATE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def cell_plain(W, U, b, W_h, b_h, inputs, H, C, gate_dtype_name: str):
    """Plain PyTorch version of the kernel: the same function."""
    params = dict(W=W, U=U, b=b, W_h=W_h, b_h=b_h)
    gate = "bfloat16" if gate_dtype_name == "bfloat16" else None
    return cells.lstm_apply(params, inputs, H, C, gate_dtype=gate)


def check_cell_weights(W, U, b, W_h, b_h, h: int) -> None:
    """Raise unless the cell weights have the shapes the kernels take for
    hidden width ``h`` (input width 2)."""
    want = dict(W=(2, 4 * h), U=(h, 4 * h), b=(4 * h,), W_h=(h, 1),
                b_h=(1,))
    got = dict(W=W, U=U, b=b, W_h=W_h, b_h=b_h)
    bad = {k: tuple(got[k].shape) for k in want
           if tuple(got[k].shape) != want[k]}
    if bad:
        raise ValueError(f"cell weight shapes {bad} do not fit h={h}: "
                         f"expected {want}")


def relaid_u(U: torch.Tensor, h: int,
             hb: int = _build.CELL_HB["bfloat16"]) -> torch.Tensor:
    """U (h, 4h) re-laid for a bf16 cell GEMM tile of ``hb`` units
    (``cell_gemm.cuh``; the per-step cell's ``_build.CELL_HB['bfloat16']``,
    or the rollout's ``_build.ROLLOUT_HB``): row ``t·4·hb + g·hb + j`` holds
    column ``g·h + t·hb + j`` of U (gate g of hidden unit t·hb + j), so one
    unit tile's i, f, o, u columns are 4·hb consecutive rows; units past h
    are zero rows, and each row is zero-padded to a multiple of
    ``_build.UT_ALIGN`` (the TMA's 16-byte row rule).  Shape
    (cell_tiles(h, hb=hb)·4·hb, ut_ld(h)), in U's dtype (the kernels take
    bf16)."""
    nt = _build.cell_tiles(h, hb=hb)
    ld = _build.ut_ld(h)
    out = torch.zeros((ld, 4, nt * hb), dtype=U.dtype, device=U.device)
    out[:h, :, :h] = U.reshape(h, 4, h)
    return (out.reshape(ld, 4, nt, hb).permute(2, 1, 3, 0)
            .reshape(nt * 4 * hb, ld).contiguous())


def cell_scratch(M: int, h: int, dev) -> torch.Tensor:
    """The kernel's delta partials: one float32 row of M per
    ``_build.DELTA_HB`` hidden units."""
    return torch.empty((_build.delta_partials(h), M), dtype=torch.float32,
                       device=dev)


def cell_cuda(W, U, b, W_h, b_h, inputs, H, C, gate_dtype_name: str):
    """The kernel on CUDA tensors; same contract as :func:`cell_plain`."""
    if gate_dtype_name not in _GATE_DTYPES:
        raise ValueError(f"unknown gate dtype {gate_dtype_name!r}; the "
                         f"cell kernel takes {sorted(_GATE_DTYPES)}")
    if H.dtype not in _STATE_DTYPES or C.dtype not in _STATE_DTYPES:
        raise TypeError(f"H/C dtypes {H.dtype}/{C.dtype} not in "
                        f"{_STATE_DTYPES}")
    B, S, in_dim = inputs.shape
    h = H.shape[-1]
    if in_dim != 2 or H.shape != (B, S, h) or C.shape != (B, S, h):
        raise ValueError(f"bad cell shapes: inputs {tuple(inputs.shape)}, "
                         f"H {tuple(H.shape)}, C {tuple(C.shape)}")
    check_cell_weights(W, U, b, W_h, b_h, h)
    dev = H.device
    for t in (inputs, C, W, U, b, W_h, b_h):
        if t.device != dev:
            raise ValueError("all cell tensors must be on one device")
    M = B * S
    bf, f32 = torch.bfloat16, torch.float32
    wdt = _GATE_DTYPES[gate_dtype_name]
    x = inputs.to(f32).contiguous()
    Hc, Cc = _build.aligned(H), C.contiguous()
    Wc = W.to(wdt).contiguous()
    Uc = _build.aligned(U.to(wdt))
    # the bf16 GEMM reads U re-laid (one pass over 5 MB at h = 800), the
    # float32 one U itself
    Ut = Uc if wdt == f32 else relaid_u(Uc, h)
    bb = b.to(f32).contiguous()
    Whc = W_h.reshape(-1).to(wdt).contiguous()
    bhb = b_h.reshape(-1).to(f32).contiguous()
    H_out = torch.empty_like(Hc)
    C_out = torch.empty_like(Cc)
    partial = cell_scratch(M, h, dev)
    delta = torch.empty((B, S), dtype=f32, device=dev)
    fn = _build.function("lstm_cell", "iadmm_cell_forward",
                         [_build.P] * 12 + [_build.I] * 5 + [_build.P])
    code = fn(x.data_ptr(), Hc.data_ptr(), Cc.data_ptr(), Wc.data_ptr(),
              Ut.data_ptr(), bb.data_ptr(), Whc.data_ptr(),
              bhb.data_ptr(), H_out.data_ptr(), C_out.data_ptr(),
              partial.data_ptr(), delta.data_ptr(), M, h,
              int(H.dtype == bf), int(C.dtype == bf), int(wdt == f32),
              _build.stream_ptr(dev))
    _build.check(code, "iadmm_cell_forward")
    if wdt == f32:
        fused_lstm_cell.launches_f32 += 1
    else:
        fused_lstm_cell.launches += 1
    return delta, H_out, C_out


def cell_forward(W, U, b, W_h, b_h, inputs, H, C, gate_dtype_name: str):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if H.is_cuda:
        return cell_cuda(W, U, b, W_h, b_h, inputs, H, C, gate_dtype_name)
    return cell_plain(W, U, b, W_h, b_h, inputs, H, C, gate_dtype_name)


class _FusedLSTMCell(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gate_dtype_name, inputs, H, C, W, U, b, W_h, b_h):
        ctx.gate_dtype_name = gate_dtype_name
        ctx.save_for_backward(inputs, H, C, W, U, b, W_h, b_h)
        return cell_forward(W, U, b, W_h, b_h, inputs, H, C,
                            gate_dtype_name)

    @staticmethod
    def backward(ctx, d_delta, d_H, d_C):
        saved = [t.detach().requires_grad_(t.is_floating_point())
                 for t in ctx.saved_tensors]
        inputs, H, C, W, U, b, W_h, b_h = saved
        with torch.enable_grad():
            outs = cell_plain(W, U, b, W_h, b_h, inputs, H, C,
                              ctx.gate_dtype_name)
        grads = torch.autograd.grad(outs, saved, (d_delta, d_H, d_C),
                                    allow_unused=True)
        return (None,) + tuple(grads)


def fused_lstm_cell(params: Dict, inputs, H, C,
                    gate_dtype_name: str = "float32"):
    """Fused LSTM token cell; drop-in for :func:`cells.lstm_apply` (same
    (delta, H', C') contract)."""
    return _FusedLSTMCell.apply(gate_dtype_name, inputs, H, C,
                                *(params[k] for k in CELL_KEYS))


fused_lstm_cell.launches = 0      # bf16-gate launches, counted by cell_cuda
fused_lstm_cell.launches_f32 = 0  # float32-gate launches


def make_pallas_lstm_apply(gate_dtype: str = "float32"):
    """cell_apply-compatible callable backed by the fused cell (the name
    of the JAX package's factory, kept)."""
    def apply(params, inputs, H, C):
        return fused_lstm_cell(params, inputs, H, C, gate_dtype)
    return apply
