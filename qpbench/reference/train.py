"""The first training steps, as the reference computes them: each batch is
Ruiz-scaled, stored in the profile's precision (the train stack's
``preload_dtype``), and its chunk loss differentiated; then one optimizer
step.  Returns each step's loss, the first step's clipped gradients and the
parameters' change over the steps."""

from __future__ import annotations

from . import adam, chunk, precision, ruiz


def cell_rounding(prec, cell_dtype: str):
    """The cell's rounding: the bf16 one where the configuration runs its
    cell in bf16, else the float32 one."""
    return prec.low if cell_dtype == "bfloat16" else prec.f32


def first_steps(weights: dict, batches, *, K: int, J: int, sigma: float,
                lr: float, clip: float, scaling_iters: int, prec,
                cell_dtype: str = "bfloat16") -> dict:
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items()}
    opt = adam.Adam(params, lr, clip)
    losses, grad1 = [], None
    with precision.no_tf32():
        for Q, p, A0, zl, zu, eq in batches:
            Qs, ps, As, zls, zus, *_ = ruiz.scale(Q, p, A0, zl, zu,
                                                  scaling_iters)
            L = chunk.loss(params, prec.low(Qs), ps, prec.low(As), zls, zus,
                           eq, J=J, K=K, t0=0, sigma=sigma, low=prec.low,
                           cell=cell_rounding(prec, cell_dtype))
            L.backward()
            losses.append(float(L.detach()))
            g = opt.step()
            if grad1 is None:
                grad1 = g
    return dict(losses=losses, grad1=grad1,
                change={k: (params[k] - weights[k]).detach()
                        for k in params})
