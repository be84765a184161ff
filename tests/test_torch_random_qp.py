"""The port on the ``Random_QP`` family (dense PSD Q, m = 2n rows, every row
two-sided, no equality rows) against the benchmark's plain reference,
``qpbench/reference/serve.py``, which imports nothing of the port.

On the CPU ``make_solver``'s fused routes run their plain twins: the
rollout's bf16 rounding points in plain PyTorch and Stage II's explicit
inverse of Ã.  The reference rounds at the same points and polishes by
LU.  Tiny batches (B = 3, n = 12, m = 24), K = 40 learned iterations and
N = 5 polish steps, at h = 20 and 72 (neither a multiple of the rollout
tile's 64 units nor of the delta partials' 16), three seeds each, with
the serving mix's weights (W_h drawn at a hundredth).

Tolerances, each relative to max|reference| over an instance:

- the rollout's (x, y, z): 1e-5.  Both sides round the same operands to
  bf16 and sum in float32 in other orders; over these seeds the rollouts
  come out equal, and other orders of the same sums differ by rounding
  (4e-8 at W_h drawn at a tenth).  The reference one precision step lower
  (fp8 for bf16, TF32 for float32) differs by 3.8e-2 or more.
- the answer's (x, y, z): 5e-5.  Stage II by an explicit inverse against
  LU: at most 2.9e-6 here; the lower precision moves x by 8.3e-4 or more.
- the answer's residuals and objective: 2e-4 (at most 1.4e-5 here; the
  lower precision moves the primal residual by 1.4e-3 or more).

Each case also holds the lower-precision reference to failing the answer's
tolerance, so that the comparison can tell the stated precision from the
one below it.

The ``cuda`` case runs on the card (``python -m pytest
tests/test_torch_random_qp.py -q --noconftest -m cuda``): the fused
rollout kernel at h = 200 and m = 2n against ``rollout_plain``.
"""

import pytest
import torch

from iadmm_tpu_torch.api import make_solver
from iadmm_tpu_torch.kernels import rollout_kernel as troll
from iadmm_tpu_torch.scaling import scale_batch
from iadmm_tpu_torch.types import QPBatch
from qpbench.gen import random_qp, weights as gen_weights
from qpbench.reference import precision, serve

K, N, SIGMA, SCALING = 40, 5, 6e-6, 10
DATA = ("Q", "p", "A0", "zl", "zu")
ROLLOUT_TOL, ANSWER_TOL, RESIDUAL_TOL = 1e-5, 5e-5, 2e-4


def _case(seed, h, n=12, B=3, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    w = gen_weights.lstm(g, 2, h, K, device, scale={"W_h": 0.01})
    pool = random_qp.pool(n, 2 * n, B, g, device)
    return w, pool, QPBatch(**pool)


def _rel(a, r):
    """Largest over instances of max|a − r| / max|r|, (B, k) tensors."""
    return float(((a.float() - r).abs().amax(1)
                  / r.abs().amax(1).clamp_min(1e-30)).max())


def _ref_solve(w, pool, name):
    return serve.solve(w, *(pool[k] for k in DATA), pool["eq_mask"], K=K,
                       N=N, sigma=SIGMA, scaling_iters=SCALING,
                       prec=precision.profile(name))


def test_random_qp_pool_is_the_family():
    _, pool, data = _case(7, 20, n=12, B=4)
    Q, A0 = pool["Q"], pool["A0"]
    assert torch.equal(Q, Q.transpose(1, 2))
    assert not bool(data.eq_mask.any()) and data.num_constr == 24
    assert bool((pool["zl"] < 0).all()) and bool((pool["zu"] > 0).all())
    ev = torch.linalg.eigvalsh(Q.double())
    assert float(ev.min()) >= 0.01 * (1 - 1e-4)
    assert abs(float((A0 != 0).float().mean()) - 0.6) < 0.06
    assert bool((Q - torch.diag_embed(Q.diagonal(0, 1, 2)) != 0).any())


@pytest.mark.parametrize("h", [20, 72])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_make_solver_matches_the_reference(seed, h):
    w, pool, data = _case(seed, h)
    solve = make_solver(w, hidden_dim=h, num_iters=K, sigma=SIGMA,
                        scaling_iters=SCALING, feas_rest_num=N,
                        use_pallas=True, gate_dtype="bfloat16",
                        matvec_mode="bf16", rollout_impl="fused",
                        stage2_impl="fused")
    out = solve(data)
    ref = _ref_solve(w, pool, "reference")

    scaled, _ = scale_batch(data, iters=SCALING)
    own = troll.fused_rollout(w, scaled, hidden=h, K=K, sigma=SIGMA)
    for a, r in zip(own, ref["trail"]["rollout"]):
        assert _rel(a, r) <= ROLLOUT_TOL
    for f in ("x", "y", "z"):
        assert _rel(getattr(out, f), ref[f]) <= ANSWER_TOL, f
    for f in ("primal_res", "dual_res", "obj"):
        a, r = getattr(out, f), ref[f]
        assert float(((a - r).abs() / r.abs()).max()) <= RESIDUAL_TOL, f

    low = _ref_solve(w, pool, "control")
    assert _rel(low["x"], ref["x"]) > ANSWER_TOL


@pytest.mark.cuda
def test_fused_rollout_at_h200_two_sided_rows():
    """The rollout kernel on its wide tile at h = 200 (four 64-unit tiles,
    the last one 56 units of padding) with m = 2n two-sided rows: against
    ``rollout_plain`` to 2e-2 (bf16 outputs after other summation orders,
    as ``tests/test_torch_cuda.py`` holds the rollout), two calls bitwise
    equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    w, _, data = _case(11, 200, n=100, B=3, device=dev)
    w["U"] = 20 * w["U"]   # gates of order 1
    out = troll.fused_rollout(w, data, hidden=200, K=6, sigma=SIGMA)
    again = troll.fused_rollout(w, data, hidden=200, K=6, sigma=SIGMA)
    ref = troll.rollout_plain(w, data, hidden=200, K=6, sigma=SIGMA)
    for a, a2, r in zip(out, again, ref):
        assert torch.equal(a, a2)
        torch.testing.assert_close(a, r, rtol=2e-2, atol=2e-2)
