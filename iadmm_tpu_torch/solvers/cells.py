"""The learned LSTM token cell: parameter initialisation and recurrence.

Counterpart of the LSTM part of ``iadmm_tpu/solvers/cells.py``.
Parameters are a plain dict of tensors.  The four gate projections are
stored fused as ``(in, 4h)`` / ``(h, 4h)`` matrices in gate order
``[i, f, o, u]``.  Entries are iid N(0, 0.01²), biases zero.  The ghost
cells (GRU, multi-layer, safeguard, GD, indirect) are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


def lstm_init(generator: torch.Generator, input_dim: int, hidden_dim: int,
              length: int, dtype=torch.float32, device="cuda") -> Params:
    """Gate weights N(0, 0.01²), zero biases, per-iteration raw rho/alpha
    schedules.  Draws on the generator's device, then moves to ``device``."""
    gdev = generator.device

    def normal(shape):
        return (0.01 * torch.randn(shape, generator=generator, dtype=dtype,
                                   device=gdev)).to(device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "W": normal((input_dim, 4 * hidden_dim)),
        "U": normal((hidden_dim, 4 * hidden_dim)),
        "b": zeros((4 * hidden_dim,)),
        "W_h": normal((hidden_dim, 1)),
        "b_h": zeros((1,)),
        "rho": normal((length,)),
        "alpha": normal((length,)),
    }


def bf16_round(a: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and widen to float32.  A product of two such values
    is exact in float32, so a float32 matmul of rounded operands is a bf16
    product with float32 accumulation."""
    return a.to(torch.bfloat16).to(torch.float32)


def lstm_apply(params: Params, inputs: torch.Tensor, H: torch.Tensor,
               C: torch.Tensor, gate_dtype: Optional[str] = None):
    """One shared-weight LSTM cell over the (n+m) token axis.

    inputs: (B, nm, in_dim); H, C: (B, nm, h).  Returns (delta (B, nm), H', C')
    with H', C' in the dtypes of H and C.  ``gate_dtype='bfloat16'`` rounds
    the inputs, H, H' and the weights to bf16 before every product and sums
    in float32.
    """
    h = H.shape[-1]
    if gate_dtype == "bfloat16":
        cast = bf16_round
    else:
        wdt = params["U"].dtype

        def cast(a):
            return a.to(wdt)
    gates = (cast(inputs) @ cast(params["W"]) + cast(H) @ cast(params["U"])
             + params["b"])
    i_t = torch.sigmoid(gates[..., 0 * h:1 * h])
    f_t = torch.sigmoid(gates[..., 1 * h:2 * h])
    o_t = torch.sigmoid(gates[..., 2 * h:3 * h])
    u_t = torch.tanh(gates[..., 3 * h:4 * h])
    C_new = i_t * u_t + f_t * C.to(gates.dtype)
    H_new = o_t * torch.tanh(C_new)
    delta = (cast(H_new) @ cast(params["W_h"]) + params["b_h"])[..., 0]
    return delta, H_new.to(H.dtype), C_new.to(C.dtype)
