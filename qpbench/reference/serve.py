"""The serving pipeline of a polished solve, as the reference computes it:
Ruiz scaling, the learned rollout in the scaled space, unscaling, Stage II
in the original space and the residuals of the answer.  ``prec`` is
:func:`.precision.profile` ('reference' or 'control')."""

from __future__ import annotations

from . import precision, residuals, rollout, ruiz, stage2


def scale(Q, p, A0, zl, zu, *, scaling_iters: int):
    """(Q, p, A0, zl, zu) scaled and the factors (d, e, cost)."""
    with precision.no_tf32():
        *scaled, d, e, cost = ruiz.scale(Q, p, A0, zl, zu, scaling_iters)
    return tuple(scaled), (d, e, cost)


def learned(params, scaled, eq_mask, *, K: int, sigma: float, prec):
    """The K learned iterations from zero in the scaled space: (x, y, z)."""
    with precision.no_tf32():
        return rollout.rollout(params, *scaled, eq_mask, K=K, sigma=sigma,
                               low=prec.low)


def finish(params, xyz, factors, Q, p, A0, zl, zu, eq_mask, *, K: int,
           N: int, sigma: float, prec) -> dict:
    """Unscale the rollout's (x, y, z), polish with Stage II at the last
    learned ρ, and the answer's residuals."""
    import torch
    x, y, z = xyz
    d, e, cost = factors
    rho = torch.sigmoid(params["rho"][K - 1].float()) * torch.where(
        eq_mask, 1e3, 1.0).to(torch.float32)
    with precision.no_tf32():
        x, y, z = d * x, (e / cost[:, None]) * y, z / e
        if N:
            x, y, z = stage2.polish(x, y, z, Q, p, A0, zl, zu, rho, N=N,
                                    sigma=sigma, f32=prec.f32)
        pr, dr, obj = residuals.residuals(x, y, z, Q, p, A0, f32=prec.f32)
    return dict(x=x, y=y, z=z, primal_res=pr, dual_res=dr, obj=obj)


def solve(params, Q, p, A0, zl, zu, eq_mask, *, K: int, N: int,
          sigma: float, scaling_iters: int, prec) -> dict:
    """The whole solve; the answer also carries its ``trail``: the scaled
    data and the rollout's (x, y, z)."""
    scaled, factors = scale(Q, p, A0, zl, zu, scaling_iters=scaling_iters)
    xyz = learned(params, scaled, eq_mask, K=K, sigma=sigma, prec=prec)
    out = finish(params, xyz, factors, Q, p, A0, zl, zu, eq_mask, K=K, N=N,
                 sigma=sigma, prec=prec)
    out["trail"] = dict(scaled=scaled, rollout=xyz)
    return out
