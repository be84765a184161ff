"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
side runs its Pallas kernel in interpret mode.  Tolerances are those of the
JAX package's own kernel tests: 1e-5 forward and 1e-4 gradients for the
float32 cell, 2e-2 for the bf16 rollout, and for the float32 Stage II
rtol 3e-4 / atol 3e-5 ('kkt'), 1e-3 / 1e-4 ('direct') and 5e-3 / 5e-4
('cg', whose float32 CG drifts with the summation order).
``test_torch_cuda.py`` holds each CUDA kernel against its plain version on
the card.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from iadmm_tpu.kernels.lstm_cell import fused_lstm_cell as j_cell
from iadmm_tpu.kernels.rollout_kernel import fused_rollout as j_rollout
from iadmm_tpu.kernels.stage2_kernel import fused_stage2 as j_stage2
from iadmm_tpu.problems import generators, io as jio
from iadmm_tpu.solvers.step import rho_vector as j_rho_vector
from iadmm_tpu import types as jtypes

from iadmm_tpu_torch.kernels import lstm_cell as tcell
from iadmm_tpu_torch.kernels import rollout_kernel as troll
from iadmm_tpu_torch.kernels import stage2_kernel as ts2
from iadmm_tpu_torch.solvers.step import rho_vector as t_rho_vector

from torch_bridge import (assert_close, jax_lstm_params, params_to_torch,
                          to_torch)

F32 = torch.float32


def _cell_inputs(B=2, S=40, h=16, seed=0):
    params = jax_lstm_params(seed, h, 4)
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, 2), (B, S, h), (B, S, h))]
    return params, [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("gate,tol", [("float32", 1e-5),
                                      ("bfloat16", 1e-2)])
def test_cell_forward_matches_pallas(gate, tol):
    params, (x, H, C) = _cell_inputs()
    with pltpu.force_tpu_interpret_mode():
        jd, jH, jC = j_cell(params, x, H, C, gate)
    tp = params_to_torch(params, dtype=F32)
    td, tH, tC = tcell.fused_lstm_cell(tp, to_torch(x), to_torch(H),
                                       to_torch(C), gate)
    assert_close(td, jd, tol, tol / 10, "delta")
    assert_close(tH, jH, tol, tol / 10, "H")
    assert_close(tC, jC, tol, tol / 10, "C")


def test_cell_gradients_match_pallas():
    params, (x, H, C) = _cell_inputs()

    def jloss(p, i, h, c):
        d, H2, C2 = j_cell(p, i, h, c, "float32")
        return (d ** 2).sum() + (H2 * C2).sum()

    with pltpu.force_tpu_interpret_mode():
        jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(params, x, H, C)
    tp = {k: v.requires_grad_(True)
          for k, v in params_to_torch(params, dtype=F32).items()}
    tx, tH, tC = (to_torch(a).requires_grad_(True) for a in (x, H, C))
    d, H2, C2 = tcell.fused_lstm_cell(tp, tx, tH, tC, "float32")
    ((d ** 2).sum() + (H2 * C2).sum()).backward()
    for k in tcell.CELL_KEYS:
        assert_close(tp[k].grad, jg[0][k], 1e-4, 1e-5, k)
    for name, t, g in zip(("inputs", "H", "C"), (tx, tH, tC), jg[1:]):
        assert_close(t.grad, g, 1e-4, 1e-5, name)


def test_cell_cuda_rejects_float32_gates():
    """A float32-gate call the kernel cannot take is rejected before any
    CUDA call (an unknown gate dtype, a state dtype it does not take, bad
    shapes), so this holds on the CPU."""
    params, (x, H, C) = _cell_inputs()
    tp = params_to_torch(params, dtype=F32)
    keys = [tp[k] for k in tcell.CELL_KEYS]
    tx, tH, tC = to_torch(x), to_torch(H), to_torch(C)
    with pytest.raises(ValueError, match="gate dtype"):
        tcell.cell_cuda(*keys, tx, tH, tC, "float16")
    with pytest.raises(TypeError, match="H/C dtypes"):
        tcell.cell_cuda(*keys, tx, tH.double(), tC, "float32")
    bad = dict(tp, U=tp["U"][:, :-4])
    with pytest.raises(ValueError, match="'U'"):
        tcell.cell_cuda(*(bad[k] for k in tcell.CELL_KEYS), tx, tH, tC,
                        "float32")
    with pytest.raises(ValueError, match="bad cell shapes"):
        tcell.cell_cuda(*keys, tx, tH[:, :-1], tC, "float32")


def test_cuda_wrappers_reject_bad_shapes():
    """The shape checks run before any CUDA call, so they hold on the CPU."""
    params, (x, H, C) = _cell_inputs()
    tp = params_to_torch(params, dtype=F32)
    bad = dict(tp, W_h=tp["W_h"][:-1])
    with pytest.raises(ValueError, match="W_h"):
        tcell.cell_cuda(*(bad[k] for k in tcell.CELL_KEYS), to_torch(x),
                         to_torch(H), to_torch(C), "bfloat16")
    _, tdata = _qp(2, 8, 4, 4, 3)
    with pytest.raises(ValueError, match="'b'"):
        troll.prepare_rollout(dict(tp, b=tp["b"][:-1]), hidden=16, K=2)
    with pytest.raises(ValueError, match="'b'"):
        troll.fused_rollout(dict(tp, b=tp["b"][:-1]), tdata, hidden=16, K=2)
    rho = torch.ones((2, 8))
    state = to_torch(jtypes.init_state(2, 8, 8, 1))
    with pytest.raises(ValueError, match="Ainv"):
        ts2.stage2_cuda(state, tdata, rho, torch.eye(15).expand(2, 15, 15),
                        num_iters=2, sigma=1e-4, refine=0)


def _qp(B, n, mi, me, seed):
    ds = generators.generate("QP", num_var=n, num_ineq=mi, num_eq=me,
                             data_size=B, seed=seed)
    jdata = jio.to_qp_batch(ds)
    return jdata, to_torch(jdata, dtype=F32)


def test_rollout_matches_pallas():
    B, n, mi, me, h, K = 3, 20, 10, 10, 16, 6
    jdata, tdata = _qp(B, n, mi, me, 11)
    params = jax_lstm_params(2, h, K)
    with pltpu.force_tpu_interpret_mode():
        jx, jy, jz = j_rollout(params, jdata, hidden=h, K=K, sigma=6e-6)
    tx, ty, tz = troll.fused_rollout(params_to_torch(params, dtype=F32),
                                     tdata, hidden=h, K=K, sigma=6e-6)
    assert_close(tx, jx, 2e-2, 2e-2, "x")
    assert_close(ty, jy, 2e-2, 2e-2, "y")
    assert_close(tz, jz, 2e-2, 2e-2, "z")


def _stage2_setup(B=2, n=20, mi=12, me=10):
    jdata, tdata = _qp(B, n, mi, me, 11)
    rng = np.random.default_rng(0)
    m = mi + me
    st = jtypes.IterState(
        x=jnp.asarray(rng.standard_normal((B, n)) * 0.1, jnp.float32),
        y=jnp.asarray(rng.standard_normal((B, m)) * 0.1, jnp.float32),
        z=jnp.asarray(rng.standard_normal((B, m)) * 0.1, jnp.float32),
        xv=jnp.asarray(rng.standard_normal((B, n + m)) * 0.1, jnp.float32),
        H=jnp.zeros((B, 1, 1), jnp.float32),
        C=jnp.zeros((B, 1, 1), jnp.float32))
    rho = j_rho_vector(jnp.float32(0.1), jdata.eq_mask)
    return jdata, tdata, st, to_torch(st), rho, to_torch(rho)


@pytest.mark.parametrize("refine", [0, 1])
def test_stage2_kkt_matches_pallas(refine):
    jdata, tdata, jst, tst, jrho, trho = _stage2_setup()
    N = 15
    jo, jpr, jdr = j_stage2(jst, jdata, jrho, num_iters=N, sigma=1e-4,
                            solver="kkt", refine=refine, interpret=True)
    to, tpr, tdr = ts2.fused_stage2(tst, tdata, trho, num_iters=N,
                                    sigma=1e-4, solver="kkt", refine=refine)
    n = tdata.num_var
    for f in ("x", "y", "z"):
        assert_close(getattr(to, f), getattr(jo, f), 3e-4, 3e-5, f)
    assert_close(to.xv[:, :n], jo.xv[:, :n], 3e-4, 3e-5, "xt")
    # ν = ρ∘(A0·xt − z) + y multiplies float32 rounding in A0·xt − z by
    # ρ_eq = 1e3·ρ = 100 on the equality rows
    assert_close(to.xv[:, n:], jo.xv[:, n:], 3e-4, 3e-3, "nu")
    assert tpr.shape == (2, N) and tdr.shape == (2, N)
    assert_close(tpr, jpr, 3e-4, 3e-5, "pr trace")
    assert_close(tdr, jdr, 3e-4, 3e-5, "dr trace")


def _held_to(to, tpr, tdr, jo, jpr, jdr, n, rtol, atol):
    for f in ("x", "y", "z"):
        assert_close(getattr(to, f), getattr(jo, f), rtol, atol, f)
    assert_close(to.xv[:, :n], jo.xv[:, :n], rtol, atol, "xt")
    assert_close(tpr, jpr, rtol, atol, "pr trace")
    assert_close(tdr, jdr, rtol, atol, "dr trace")


def _lu64_polish(jst, jdata, jrho, sigma, N):
    """The float64 LU polish of the same start (the exact solve the
    Stage-II solvers approximate): final x, y, z and the (B, N) traces."""
    from iadmm_tpu_torch.solvers import exact
    d64 = to_torch(jdata, dtype=torch.float64)
    rho = to_torch(jrho).double()
    st = to_torch(jst, dtype=torch.float64)
    lu, piv = exact.lu_factorize(d64, sigma, rho)
    prs, drs = [], []
    for _ in range(N):
        st = exact.exact_step(lu, piv, rho, st, d64, sigma)
        prs.append(torch.linalg.vector_norm(
            torch.einsum("bij,bj->bi", d64.A0, st.x) - st.z, dim=-1))
        drs.append(torch.linalg.vector_norm(
            torch.einsum("bij,bj->bi", d64.Q, st.x) + d64.p
            + torch.einsum("bij,bi->bj", d64.A0, st.y), dim=-1))
    return dict(x=st.x, y=st.y, z=st.z, pr=torch.stack(prs, 1),
                dr=torch.stack(drs, 1))


def _jax_direct_operand(jdata, jrho, sigma):
    """The JAX wrapper's float32 M⁻¹ (``iadmm_tpu/kernels/stage2_kernel.py``
    forms it so outside its Pallas call), as the port's operand (M⁻¹)ᵀ."""
    hi = jax.lax.Precision.HIGHEST
    n = jdata.num_var
    A0 = jdata.A0.astype(jnp.float32)
    rho = jrho * jnp.ones(jdata.zl.shape, jnp.float32)
    M = (jdata.Q.astype(jnp.float32) + sigma * jnp.eye(n, dtype=jnp.float32)
         + jnp.einsum("bmn,bmk->bnk", A0 * rho[..., None], A0, precision=hi))
    eye = jnp.broadcast_to(jnp.eye(n, dtype=jnp.float32), M.shape)
    Minv = jax.scipy.linalg.cho_solve((jnp.linalg.cholesky(M), True), eye)
    return torch.as_tensor(np.array(Minv)).transpose(1, 2).contiguous()


def _bar_gap(t, j):
    """max(|t − j| − 1e-3·|j|): at most 1e-4 meets the JAX package's
    direct bar (rtol 1e-3, atol 1e-4)."""
    t, j = np.asarray(t), np.asarray(j)
    return float((np.abs(t - j) - 1e-3 * np.abs(j)).max())


@pytest.mark.parametrize("refine", [0, 2])
def test_stage2_direct_matches_pallas(refine):
    """The JAX package's direct bar, rtol 1e-3 / atol 1e-4, which its own
    test sets at refine 2 against the LU route.

    Refine 2 (the default, ``make_solver('fused-direct')``'s route): the
    port's ``fused_stage2`` holds x, y, z and xt to that bar against the
    JAX kernel, and the pr/dr traces to it against the JAX kernel or, where
    further, against the float64 LU polish of the same start (late in the
    trace pr ~ 0.1 is a cancelling ‖A0x − z‖, and each package's trace sits
    ~2e-4 from the exact one).

    Refine 0: each package's float32 M⁻¹ is ~5e-5 (relative) from the exact
    inverse at cond(M) ~ 1e4, which moves z past the bar after one step, so
    the step semantics are held on the JAX kernel's own operand: the port's
    plain twin holds x, z and xt to the bar; y and the traces to the bar
    or, where further, to within 4x the JAX result's own gap to the float64
    LU polish (ν = ρ(A0·xt − z) + y multiplies xt's rounding by ρ_eq = 100,
    y's gap reaches 1.5e-2, and pr and dr carry it).  The port's own
    ``fused_stage2`` at refine 0 is held, field by field, to that own-gap
    rule."""
    jdata, tdata, jst, tst, jrho, trho = _stage2_setup()
    N, sigma = 15, 1e-4
    n = tdata.num_var
    jo, jpr, jdr = j_stage2(jst, jdata, jrho, num_iters=N, sigma=sigma,
                            solver="direct", refine=refine, interpret=True)
    want = dict(x=jo.x, y=jo.y, z=jo.z, xt=jo.xv[:, :n], pr=jpr, dr=jdr)
    lu = _lu64_polish(jst, jdata, jrho, sigma, N)
    to, tpr, tdr = ts2.fused_stage2(tst, tdata, trho, num_iters=N,
                                    sigma=sigma, solver="direct",
                                    refine=refine)
    assert tpr.shape == (2, N) and tdr.shape == (2, N)
    got = dict(x=to.x, y=to.y, z=to.z, xt=to.xv[:, :n], pr=tpr, dr=tdr)

    def own_gap(f):
        return float(np.abs(np.asarray(want[f]) - lu[f].numpy()).max())

    if refine == 2:
        for f in ("x", "y", "z", "xt"):
            assert _bar_gap(got[f], want[f]) <= 1e-4, (f, _bar_gap(
                got[f], want[f]))
        for f in ("pr", "dr"):
            to_jax = _bar_gap(got[f], want[f])
            to_lu = _bar_gap(got[f], lu[f].numpy())
            assert min(to_jax, to_lu) <= 1e-4, (
                f"{f}: beyond the bar by {to_jax:.3e} from JAX and "
                f"{to_lu:.3e} from the float64 LU polish")
        return
    rho = trho.float() * torch.ones_like(tdata.zl)
    twin = dict(zip(("x", "y", "z", "xt", "pr", "dr"), ts2.stage2_direct_plain(
        tst, tdata, rho, _jax_direct_operand(jdata, jrho, sigma),
        num_iters=N, sigma=sigma, refine=0)))
    for f in ("x", "z", "xt"):
        assert _bar_gap(twin[f], want[f]) <= 1e-4, (f, _bar_gap(
            twin[f], want[f]))
    for f in ("y", "pr", "dr"):
        gap = float(np.abs(twin[f].numpy() - np.asarray(want[f])).max())
        assert _bar_gap(twin[f], want[f]) <= 1e-4 or gap <= 4 * own_gap(f), (
            f"{f}: max gap to JAX {gap:.3e}, JAX's own gap to the float64 "
            f"LU polish {own_gap(f):.3e}")
    for f in ("x", "y", "z", "pr", "dr"):
        gap = float(np.abs(got[f].numpy() - np.asarray(want[f])).max())
        assert gap <= 4 * own_gap(f), (
            f"{f}: max gap to JAX {gap:.3e}, JAX's own gap to the float64 "
            f"LU polish {own_gap(f):.3e}")


def test_stage2_cg_matches_pallas():
    """The Jacobi-CG mode at the JAX package's own cg setting (N=12, 60 CG
    iterations) and bar, rtol 5e-3 / atol 5e-4."""
    jdata, tdata, jst, tst, jrho, trho = _stage2_setup()
    N = 12
    jo, jpr, jdr = j_stage2(jst, jdata, jrho, num_iters=N, cg_iters=60,
                            sigma=1e-4, solver="cg", interpret=True)
    to, tpr, tdr = ts2.fused_stage2(tst, tdata, trho, num_iters=N,
                                    cg_iters=60, sigma=1e-4, solver="cg")
    assert tpr.shape == (2, N) and tdr.shape == (2, N)
    _held_to(to, tpr, tdr, jo, jpr, jdr, tdata.num_var, 5e-3, 5e-4)
    assert float(tpr[:, -1].mean()) < float(tpr[:, 0].mean())


@pytest.mark.parametrize("solver,rtol,atol", [("kkt", 3e-4, 3e-5),
                                              ("direct", 1e-3, 1e-4),
                                              ("cg", 5e-3, 5e-4)])
def test_stage2_defaults_match_the_reference(solver, rtol, atol):
    """``fused_stage2``'s keyword defaults are the JAX package's
    (cg_iters=100, sigma=6e-6, tol=1e-8, refine None: 0 for 'kkt', 2
    otherwise); with them left out both packages agree at the solver's bar,
    and the port's result is that of the explicit default refine."""
    want = {k: v.default for k, v in
            inspect.signature(j_stage2).parameters.items()
            if k in ("num_iters", "cg_iters", "sigma", "tol", "solver",
                     "refine")}
    got = {k: v.default for k, v in
           inspect.signature(ts2.fused_stage2).parameters.items()
           if k in want}
    assert got == want
    jdata, tdata, jst, tst, jrho, trho = _stage2_setup()
    N = 4
    jo, jpr, jdr = j_stage2(jst, jdata, jrho, num_iters=N, solver=solver,
                            interpret=True)
    to, tpr, tdr = ts2.fused_stage2(tst, tdata, trho, num_iters=N,
                                    solver=solver)
    _held_to(to, tpr, tdr, jo, jpr, jdr, tdata.num_var, rtol, atol)
    refine = 0 if solver == "kkt" else 2
    explicit, _, _ = ts2.fused_stage2(tst, tdata, trho, num_iters=N,
                                      solver=solver, refine=refine)
    assert torch.equal(to.x, explicit.x) and torch.equal(to.xv, explicit.xv)
    if solver == "direct":
        unrefined, _, _ = ts2.fused_stage2(tst, tdata, trho, num_iters=N,
                                           solver=solver, refine=0)
        assert not torch.equal(to.x, unrefined.x)


@pytest.mark.parametrize("solver", ["kkt", "direct", "cg"])
def test_stage2_solver_names(solver):
    _, tdata, _, tst, _, trho = _stage2_setup(B=1, n=8, mi=4, me=4)
    st, pr, dr = ts2.fused_stage2(tst, tdata, trho, num_iters=2,
                                  solver=solver)
    assert pr.shape == dr.shape == (1, 2)
    assert st.xv.shape == (1, 16) and bool(torch.isfinite(st.xv).all())
    with pytest.raises(ValueError, match="unknown stage2 solver"):
        ts2.fused_stage2(tst, tdata, trho, num_iters=2, solver="qr")


def test_kkt_inverse_is_row_major():
    """The 'kkt' kernel reads Ã⁻¹ by rows: the operand is formed row-major
    (``torch.linalg.inv`` returns it column-major), with the same values."""
    _, tdata, _, _, _, trho = _stage2_setup(B=2, n=8, mi=4, me=4)
    rho = trho.float() * torch.ones_like(tdata.zl)
    Ainv = ts2.kkt_inverse(tdata, rho, 1e-4)
    assert Ainv.is_contiguous() and Ainv.shape == (2, 16, 16)
    Q, A0 = tdata.Q.float(), tdata.A0.float()
    top = torch.cat([Q + 1e-4 * torch.eye(8), A0.mT], -1)
    bot = torch.cat([A0, torch.diag_embed(-1.0 / rho)], -1)
    assert torch.equal(Ainv, torch.linalg.inv(torch.cat([top, bot], 1)))


def _kkt_case(B, n, mi, me, zero_rows=0):
    """A float32 QP batch and its per-row ρ; the first ``zero_rows`` rows
    and columns of Q zeroed (σ = 0 then leaves Ã's leading entries zero, so
    the first pivots must come from the A0 rows)."""
    _, tdata = _qp(B, n, mi, me, 7)
    if zero_rows:
        Q = tdata.Q.clone()
        Q[:, :zero_rows, :] = 0
        Q[:, :, :zero_rows] = 0
        tdata = dataclasses.replace(tdata, Q=Q)
    rho = t_rho_vector(torch.tensor(0.1), tdata.eq_mask)
    return tdata, (rho * torch.ones_like(tdata.zl)).float()


def _rel_err(X, ref):
    """max |X − ref| over max |ref|, the largest over the batch."""
    scale = ref.abs().amax(dim=(1, 2))
    return float(((X.double() - ref).abs().amax(dim=(1, 2)) / scale).max())


# (B, n, mi, me, nb, sigma, zero_rows): nb dividing S (16 / 4) and not
# (37 / 8, 50 / 7), one panel wider than S (80 / 128), the swap-forcing case
KINV_PLAIN_CASES = [(2, 8, 4, 4, 4, 1e-4, 0), (3, 20, 9, 8, 8, 6e-6, 0),
                    (2, 30, 10, 10, 7, 6e-6, 0), (1, 40, 20, 20, 128, 6e-6, 0),
                    (2, 40, 15, 15, 16, 0.0, 8)]


@pytest.mark.parametrize("B,n,mi,me,nb,sigma,zero_rows", KINV_PLAIN_CASES)
def test_kkt_inverse_plain_matches_float64(B, n, mi, me, nb, sigma,
                                           zero_rows):
    """kkt_inverse_plain (the kernel's blocked Gauss–Jordan, float32)
    against float64 ``torch.linalg.inv`` of the same Ã: its max error over
    max|Ã⁻¹| at most twice float32 ``torch.linalg.inv``'s (both are row
    pivoted float32 eliminations; the bound is the card test's); with
    σ = 0 and Q's first rows zero, Ã[0, 0] = 0 and the pivots come from
    A0."""
    tdata, rho = _kkt_case(B, n, mi, me, zero_rows)
    A = ts2._kkt_matrix(tdata, rho, sigma)
    if zero_rows:
        assert bool((A[:, 0, 0] == 0).all())
    ref = torch.linalg.inv(A.double())
    X = ts2.kkt_inverse_plain(tdata, rho, sigma, nb=nb)
    assert X.shape == A.shape and X.dtype == torch.float32
    assert _rel_err(X, ref) <= 2 * _rel_err(torch.linalg.inv(A), ref)


# (nb, sb): panels that divide S = 24 (3 … 24) and that do not (5, 7, 10,
# 40 > S), each cut into sub-panels that divide it and that do not
KINV_SPLITS = [(3, 3), (4, 2), (6, 4), (8, 3), (12, 5), (5, 5), (7, 2),
               (10, 4), (24, 7), (40, 32)]


@pytest.mark.parametrize("nb,sb", KINV_SPLITS)
def test_kkt_inverse_plain_panel_widths(nb, sb):
    """The panel splitting: at panel and sub-panel widths that divide S = 24
    and that do not, the result agrees with the unsplit elimination (one
    panel, one sub-panel) within 4x the larger of the two's own error
    against float64 (the splits change where rounding falls, not the
    pivots on this well-separated case), and is as accurate as float32
    ``torch.linalg.inv`` within 2x."""
    tdata, rho = _kkt_case(2, 12, 6, 6)
    A = ts2._kkt_matrix(tdata, rho, 1e-4)
    ref = torch.linalg.inv(A.double())
    X = ts2.kkt_inverse_plain(tdata, rho, 1e-4, nb=nb, sb=sb)
    one = ts2.kkt_inverse_plain(tdata, rho, 1e-4, nb=24, sb=24)
    own = max(_rel_err(X, ref), _rel_err(one, ref))
    assert _rel_err(X, one.double()) <= 4 * own
    assert _rel_err(X, ref) <= 2 * _rel_err(torch.linalg.inv(A), ref)


def test_kkt_inverse_cuda_rejects_bad_shapes():
    """The inverse kernel's wrapper checks Q, A0 and ρ against B, n, m
    before any CUDA call, so the check holds on the CPU."""
    tdata, rho = _kkt_case(2, 8, 4, 4)
    with pytest.raises(ValueError, match="kkt_inverse: .* do not fit"):
        ts2.kkt_inverse_cuda(tdata, rho[:, :-1], 1e-4)
    with pytest.raises(ValueError, match="kkt_inverse: .* do not fit"):
        ts2.kkt_inverse_cuda(dataclasses.replace(tdata, Q=tdata.Q[:1]), rho,
                             1e-4)
