"""The port's serving slice (``make_solver``) against the JAX package's.

Ruiz scaling → learned rollout → unscale → Stage-II polish → residuals, on
the CPU: the port runs its kernels' plain versions, the JAX package its
Pallas kernels in interpret mode.  The bf16 profile is compared to 2e-2,
the bf16 rounding level the JAX package's rollout-kernel test uses.
"""

import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from iadmm_tpu import api as japi
from iadmm_tpu.problems import generators, io as jio

from iadmm_tpu_torch import api as tapi

from torch_bridge import (assert_close, jax_lstm_params, params_to_torch,
                          to_torch)

B, N_VAR, MI, ME, HID, K = 3, 20, 10, 10, 16, 6
FAST = dict(use_pallas=True, gate_dtype="bfloat16", matvec_mode="bf16",
            feas_rest_num=10)


@pytest.fixture(scope="module")
def problem():
    ds = generators.generate("QP", num_var=N_VAR, num_ineq=MI, num_eq=ME,
                             data_size=B, seed=21)
    jdata = jio.to_qp_batch(ds)
    params = jax_lstm_params(4, HID, K)
    return (jdata, to_torch(jdata, dtype=torch.float32), params,
            params_to_torch(params, dtype=torch.float32))


@pytest.mark.parametrize("rollout_impl,stage2_impl", [("fused", "fused"),
                                                      ("step", "lu"),
                                                      ("fused", "fused-direct"),
                                                      ("fused", "cg")])
def test_make_solver_matches_jax(problem, rollout_impl, stage2_impl):
    jdata, tdata, jp, tp = problem
    kw = dict(FAST, hidden_dim=HID, num_iters=K, rollout_impl=rollout_impl,
              stage2_impl=stage2_impl)
    with pltpu.force_tpu_interpret_mode():
        jr = japi.make_solver(jp, **kw)(jdata)
    tr = tapi.make_solver(tp, **kw)(tdata)
    for f in ("x", "y", "z", "primal_res", "dual_res", "obj"):
        a = getattr(tr, f)
        assert torch.isfinite(a).all(), f
        assert_close(a, getattr(jr, f), 2e-2, 2e-2, f)


def test_solve_qp_batch_auto_is_lu_on_cpu(problem):
    _, tdata, _, tp = problem
    kw = dict(FAST, hidden_dim=HID, num_iters=K, rollout_impl="fused")
    auto = tapi.solve_qp_batch(tdata, tp, stage2_impl="auto", **kw)
    lu = tapi.solve_qp_batch(tdata, tp, stage2_impl="lu", **kw)
    assert torch.equal(auto.x, lu.x) and torch.equal(auto.z, lu.z)


def test_make_solver_rejects_unported_routes(problem):
    """Every Stage-II route is ported; an unknown one and a rollout longer
    than the learned schedules are rejected."""
    _, _, _, tp = problem
    with pytest.raises(ValueError, match="unknown stage2_impl"):
        tapi.make_solver(tp, hidden_dim=HID, num_iters=K, stage2_impl="qr")
    with pytest.raises(ValueError, match="test_outer_T"):
        tapi.make_solver(tp, hidden_dim=HID, num_iters=K + 1)
