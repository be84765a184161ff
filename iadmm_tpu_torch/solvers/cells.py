"""Learned solver cells: parameter initialisation and recurrences.

Counterpart of ``iadmm_tpu/solvers/cells.py``.  Parameters are a plain
dict of tensors.  The LSTM's four gate projections are stored fused as
``(in, 4h)`` / ``(h, 4h)`` matrices in gate order ``[i, f, o, u]``, the
GRU's three as ``(in, 3h)`` / ``(h, 3h)`` in order ``[z, r, u]``.  Entries
are iid N(0, 0.01²), biases zero.

Cells: ``lstm`` (the live model), and the reference's ablations ``gru``,
``safeguard_lstm`` (no learned alpha) and ``multi_layer_lstm`` (no learned
schedules); ``gd`` and ``indirect_lstm`` reuse these inits
(:data:`iadmm_tpu_torch.solvers.step.CELL_REGISTRY`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

Params = Dict[str, torch.Tensor]


def _gate_init(generator: torch.Generator, input_dim: int, hidden_dim: int,
               gates: int, schedule_len: int, dtype, device) -> Params:
    """``gates`` fused gate projections N(0, 0.01²), zero biases, the output
    head, and (``schedule_len > 0``) per-iteration raw rho/alpha schedules.
    Draws on the generator's device, then moves to ``device``."""
    gdev = generator.device

    def normal(shape):
        return (0.01 * torch.randn(shape, generator=generator, dtype=dtype,
                                   device=gdev)).to(device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    p = {
        "W": normal((input_dim, gates * hidden_dim)),
        "U": normal((hidden_dim, gates * hidden_dim)),
        "b": zeros((gates * hidden_dim,)),
        "W_h": normal((hidden_dim, 1)),
        "b_h": zeros((1,)),
    }
    if schedule_len:
        p["rho"] = normal((schedule_len,))
        p["alpha"] = normal((schedule_len,))
    return p


def lstm_init(generator: torch.Generator, input_dim: int, hidden_dim: int,
              length: int, dtype=torch.float32, device="cuda") -> Params:
    """Gate weights N(0, 0.01²), zero biases, per-iteration raw rho/alpha
    schedules."""
    return _gate_init(generator, input_dim, hidden_dim, 4, length, dtype,
                      device)


def gru_init(generator: torch.Generator, input_dim: int, hidden_dim: int,
             length: int, dtype=torch.float32, device="cuda") -> Params:
    """The GRU's gates fused in order [z, r, u] (update, reset,
    candidate), with the LSTM's output head and schedules."""
    return _gate_init(generator, input_dim, hidden_dim, 3, length, dtype,
                      device)


def safeguard_lstm_init(generator: torch.Generator, input_dim: int,
                        hidden_dim: int, length: int, dtype=torch.float32,
                        device="cuda") -> Params:
    """The LSTM's set without ``alpha``: the relaxation stays fixed."""
    p = lstm_init(generator, input_dim, hidden_dim, length, dtype, device)
    del p["alpha"]
    return p


def multi_layer_lstm_init(generator: torch.Generator, input_dim: int,
                          hidden_dim: int, inner_T: int, dtype=torch.float32,
                          device="cuda") -> Params:
    """The LSTM's weights without learned schedules.  ``inner_T`` is
    accepted and unused, as in the JAX package: the step runs its own
    default number of inner refinements."""
    return _gate_init(generator, input_dim, hidden_dim, 4, 0, dtype, device)


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


def gru_apply(params: Params, inputs: torch.Tensor, H: torch.Tensor,
              C: torch.Tensor):
    """Standard GRU recurrence over the tokens, in the weights' dtype; C is
    carried untouched, so the state layout is the LSTM's.  Returns
    (delta (B, nm), H' in H's dtype, C)."""
    h = H.shape[-1]
    W, U, b = params["W"], params["U"], params["b"]
    Hw = H.to(U.dtype)
    xw = inputs.to(W.dtype) @ W
    hu = Hw @ U[:, :2 * h]
    z_t = torch.sigmoid(xw[..., :h] + hu[..., :h] + b[:h])
    r_t = torch.sigmoid(xw[..., h:2 * h] + hu[..., h:2 * h] + b[h:2 * h])
    u_t = torch.tanh(xw[..., 2 * h:] + b[2 * h:] + (r_t * Hw) @ U[:, 2 * h:])
    H_new = (1.0 - z_t) * Hw + z_t * u_t
    delta = (H_new @ params["W_h"] + params["b_h"])[..., 0]
    return delta, H_new.to(H.dtype), C


# ---------------------------------------------------------------------------
# Reference <-> fused parameter layout
# ---------------------------------------------------------------------------

_LSTM_GATES = ("i", "f", "o", "u")
_GRU_GATES = ("z", "r", "u")


def _gates(kind: str):
    return _LSTM_GATES if kind in ("lstm", "safeguard_lstm",
                                   "multi_layer_lstm") else _GRU_GATES


def to_reference_naming(params: Params, kind: str = "lstm") -> Params:
    """Split the fused W/U/b into the reference's per-gate tensors
    (``W_i``, ``U_i``, ``b_i``, ...), schedules as ``(length, 1)``."""
    h = params["W_h"].shape[0]
    out = {}
    for gi, g in enumerate(_gates(kind)):
        out[f"W_{g}"] = params["W"][:, gi * h:(gi + 1) * h]
        out[f"U_{g}"] = params["U"][:, gi * h:(gi + 1) * h]
        out[f"b_{g}"] = params["b"][gi * h:(gi + 1) * h]
    out["W_h"] = params["W_h"]
    out["b_h"] = params["b_h"]
    for k in ("rho", "alpha"):
        if k in params:
            out[k] = params[k][:, None]
    return out


def from_reference_naming(ref: Params, kind: str = "lstm") -> Params:
    """The inverse of :func:`to_reference_naming`."""
    gates = _gates(kind)

    def cat(w):
        return torch.cat([torch.as_tensor(ref[f"{w}_{g}"]) for g in gates],
                         -1)

    out = {"W": cat("W"), "U": cat("U"), "b": cat("b"),
           "W_h": torch.as_tensor(ref["W_h"]),
           "b_h": torch.as_tensor(ref["b_h"])}
    for k in ("rho", "alpha"):
        if k in ref:
            out[k] = torch.as_tensor(ref[k]).reshape(-1)
    return out
