"""The port's matrix-free Stage II (``iadmm_tpu_torch/solvers/cg.py``)
against the JAX package's (``iadmm_tpu/solvers/cg.py``).

Float64 on the CPU (``conftest.py`` puts JAX on x64), on the sizes of
``tests/test_cg.py`` (B=4, n=14, 7 + 7 rows): the same algorithm in another
framework, so every function is held to rtol 1e-9 / atol 1e-12.

Two properties of the algorithm shape the cases.  Past about six
iterations on these sizes, float64 CG amplifies a last-bit difference
between the two frameworks' sums by 1e2–1e3 an iteration until it has
converged; and where an instance stops at ‖r‖/‖b‖ ≤ tol, the two answers
differ by up to about tol·cond(M) (cond(M) ≈ 2e4 here).  So the cases that
converge inside ``maxiter`` (and are then masked) use tol = 1e-13, which
float64 CG reaches on all four instances, and the multi-step polish
(``feasibility_restoration_cg``, whose tol is fixed at 1e-8) runs a few CG
iterations a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iadmm_tpu.problems import generators, io as jio
from iadmm_tpu.solvers import cg as jcg
from iadmm_tpu.solvers.step import rho_vector as j_rho_vector
from iadmm_tpu import types as jtypes

from iadmm_tpu_torch.solvers import cg as tcg

from torch_bridge import assert_close, to_torch

F64 = torch.float64
SIGMA = 1e-6
RTOL, ATOL = 1e-9, 1e-12


def _setup(seed):
    ds = generators.generate("QP", num_var=14, num_ineq=7, num_eq=7,
                             data_size=4, seed=seed)
    jdata = jio.to_qp_batch(ds, dtype=jnp.float64)
    jrho = j_rho_vector(jnp.float64(0.2), jdata.eq_mask)
    rng = np.random.default_rng(seed)
    n, m = 14, 14
    st = jtypes.IterState(
        x=jnp.asarray(rng.standard_normal((4, n))),
        y=jnp.asarray(rng.standard_normal((4, m))),
        z=jnp.asarray(rng.standard_normal((4, m))),
        xv=jnp.asarray(rng.standard_normal((4, n + m))),
        H=jnp.zeros((4, 1, 1)), C=jnp.zeros((4, 1, 1)))
    return (jdata, to_torch(jdata, dtype=F64), jrho, to_torch(jrho),
            st, to_torch(st, dtype=F64))


@pytest.fixture(scope="module")
def case():
    return _setup(3)


def test_condensed_pieces_match(case):
    jdata, tdata, jrho, trho, js, ts = case
    v = np.random.default_rng(7).standard_normal((4, 14))
    assert_close(tcg.condensed_matvec(tdata, torch.as_tensor(v), SIGMA, trho),
                 jcg.condensed_matvec(jdata, jnp.asarray(v), SIGMA, jrho),
                 RTOL, ATOL, "M·v")
    assert_close(tcg.condensed_rhs(tdata, ts.x, ts.y, ts.z, SIGMA, trho),
                 jcg.condensed_rhs(jdata, js.x, js.y, js.z, SIGMA, jrho),
                 RTOL, ATOL, "b")
    assert_close(tcg.jacobi_diag(tdata, SIGMA, trho),
                 jcg.jacobi_diag(jdata, SIGMA, jrho), RTOL, ATOL, "diag")


@pytest.mark.parametrize("maxiter,tol", [(5, 1e-8), (100, 1e-13)])
def test_batched_cg_matches(case, maxiter, tol):
    """A few iterations (every instance unmasked throughout) and a run
    long enough that every instance converges and is masked.  The port's
    count of unmasked iterations is exact: an instance that ran k of them
    holds the x of a run of k iterations that masks nothing."""
    jdata, tdata, jrho, trho, js, ts = case
    b = np.random.default_rng(8).standard_normal((4, 14))
    jx, jres = jcg.batched_cg(
        lambda v: jcg.condensed_matvec(jdata, v, SIGMA, jrho),
        jnp.asarray(b), js.xv[:, :14], jcg.jacobi_diag(jdata, SIGMA, jrho),
        maxiter, tol)

    def run(k, t):
        return tcg.batched_cg(
            lambda v: tcg.condensed_matvec(tdata, v, SIGMA, trho),
            torch.as_tensor(b), ts.xv[:, :14],
            tcg.jacobi_diag(tdata, SIGMA, trho), k, t)

    tx, tres, iters = run(maxiter, tol)
    assert_close(tx, jx, RTOL, ATOL, "x")
    assert_close(tres, jres, RTOL, 1e-12 * float(np.linalg.norm(b)), "res")
    assert iters.dtype == torch.int32 and iters.shape == (4,)
    if maxiter == 5:
        assert iters.tolist() == [5] * 4
        return
    # converged and masked, at different iterations: more iterations
    # change nothing
    assert float((tres / torch.linalg.vector_norm(
        torch.as_tensor(b), dim=-1)).max()) <= tol
    assert int(iters.max()) < maxiter and len(set(iters.tolist())) > 1
    tx2, _, iters2 = run(maxiter + 50, tol)
    assert torch.equal(tx, tx2) and torch.equal(iters, iters2)
    for i, k in enumerate(iters.tolist()):
        assert torch.equal(run(k, 0.0)[0][i], tx[i])


@pytest.mark.parametrize("maxiter,tol", [(5, 1e-8), (100, 1e-13)])
def test_exact_step_cg_matches(case, maxiter, tol):
    jdata, tdata, jrho, trho, js, ts = case
    jo = jcg.exact_step_cg(jrho, js, jdata, SIGMA, maxiter=maxiter, tol=tol)
    to = tcg.exact_step_cg(trho, ts, tdata, SIGMA, maxiter=maxiter, tol=tol)
    for f in ("x", "y", "z", "xv"):
        assert_close(getattr(to, f), getattr(jo, f), RTOL, ATOL, f)


@pytest.mark.parametrize("seed,num_iters,cg_iters", [(5, 6, 5), (0, 3, 4)])
def test_feasibility_restoration_cg_matches(seed, num_iters, cg_iters):
    """Several polish steps, each CG warm-started from the last x̃."""
    jdata, tdata, jrho, trho, js, ts = _setup(seed)
    jo = jax.jit(jcg.feasibility_restoration_cg,
                 static_argnums=(4, 5))(js, jdata, SIGMA, jrho, num_iters,
                                        cg_iters)
    to = tcg.feasibility_restoration_cg(ts, tdata, SIGMA, trho, num_iters,
                                        cg_iters)
    for f in ("x", "y", "z", "xv"):
        assert_close(getattr(to, f), getattr(jo, f), RTOL, ATOL, f)
    assert to.H is ts.H and to.C is ts.C
