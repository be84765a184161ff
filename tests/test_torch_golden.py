"""The port against the repository's golden trace,
``tests/golden/qp_rollout_trace.npz``.

Rebuilds ``tests/test_golden_trace.py::_compute_trace`` with the port's
``generate``, ``to_qp_batch``, ``scale_batch`` and ``eval_rollout`` in
float64 on the CPU, with the parameters of the JAX ``lstm_init`` at
``PRNGKey(42)`` carried across.  Each of the four traces (primal, dual,
objective, linear-system residual) is held to rtol 1e-9 / atol 1e-10: the
same float64 algorithm in another framework.  The file is only read.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iadmm_tpu.solvers.cells import lstm_init

from iadmm_tpu_torch.problems import generate, to_qp_batch
from iadmm_tpu_torch.scaling import scale_batch
from iadmm_tpu_torch.solvers import rollouts
from iadmm_tpu_torch.solvers.step import lstm_step
from iadmm_tpu_torch.types import init_state

from torch_bridge import params_to_torch

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "qp_rollout_trace.npz")
F64 = torch.float64


@pytest.fixture(scope="module")
def traces():
    ds = generate("QP", num_var=12, num_ineq=6, num_eq=6, data_size=4,
                  seed=21)
    data = to_qp_batch(ds, dtype=F64, device="cpu")
    scaled, sc = scale_batch(data, iters=10)
    params = params_to_torch(
        lstm_init(jax.random.PRNGKey(42), 2, 8, 6, dtype=jnp.float64),
        dtype=F64)
    st = init_state(4, 12, 12, 8, dtype=F64, device="cpu")
    _, tr = rollouts.eval_rollout(lstm_step, params, st, scaled, data, sc,
                                  1e-6, 6, metrics_mode="highest")
    return dict(primal=tr.primal_res, dual=tr.dual_res, obj=tr.obj,
                ls=tr.ls_res)


@pytest.mark.parametrize("key", ["primal", "dual", "obj", "ls"])
def test_rollout_matches_golden(traces, key):
    with np.load(GOLDEN) as ref:
        want = ref[key]
    got = traces[key].numpy()
    assert got.shape == want.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10,
                               err_msg=key)
