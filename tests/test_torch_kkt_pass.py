"""The KKT pass alone (``iadmm_tpu_torch/kernels/kkt_pass.py``) on the CPU.

``kkt_pass_plain`` is held against the JAX package's in-kernel products
(``iadmm_tpu/kernels/train_rollout.py::_mv_maker``: ``mv_q``, ``mv_a0``,
``mv_a0t``) on the same numpy inputs made from a seed:

- bf16 data: Q, A0 and the vectors rounded to bf16 on both sides, float32
  sums in another order, so to 1e-5 of max|ref|;
- float32 data: the port's plain version in float64 on float64 inputs.
  ``_mv_maker`` returns float32 whatever its inputs
  (``preferred_element_type``), so against it the gap is that output's
  rounding, held to 1e-6 of max|ref|; against numpy's float64 products to
  1e-12.

The chunk partials are also held one by one against numpy, and the wrapper
on CPU tensors is its plain version (no launch); the kernel itself runs on
the card (``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iadmm_tpu.kernels.train_rollout import _mv_maker

from iadmm_tpu_torch.kernels import _build
from iadmm_tpu_torch.kernels.kkt_pass import (kkt_pass, kkt_pass_plain,
                                              n_chunks)

SHAPES = [(37, 21), (64, 32), (130, 70)]


def _inputs(seed, B, n, m):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, n, n))
    Q = 0.5 * (X + X.transpose(0, 2, 1))
    A0 = rng.standard_normal((B, m, n))
    sides = [(rng.standard_normal((B, n)), rng.standard_normal((B, m)))
             for _ in range(2)]
    return Q, A0, sides


def _jax_products(Q, A0, wt, wb, cdt):
    """Per instance: mv_q(wt) + mv_a0t(wb) and mv_a0(wt), as float64."""
    tops, bots = [], []
    for b in range(Q.shape[0]):
        mv_q, mv_a0, mv_a0t = _mv_maker(jnp.asarray(Q[b]).astype(cdt),
                                        jnp.asarray(A0[b]).astype(cdt), cdt)
        top = mv_q(jnp.asarray(wt[b:b + 1])) + mv_a0t(jnp.asarray(wb[b:b + 1]))
        tops.append(np.asarray(top, np.float64)[0])
        bots.append(np.asarray(mv_a0(jnp.asarray(wt[b:b + 1])),
                               np.float64)[0])
    return np.stack(tops), np.stack(bots)


def _close(out, ref, rel):
    out = out.double().numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("nv", [1, 2])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n,m", SHAPES)
@pytest.mark.parametrize("cdt", ["bfloat16", "float32"])
def test_plain_pass_matches_the_jax_products(cdt, n, m, B, nv):
    Q, A0, sides = _inputs(n + 7 * m + B, B, n, m)
    sides = sides[:nv]
    if cdt == "bfloat16":
        data = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
                for a in (Q, A0)]
        vecs = [torch.from_numpy(v.astype(np.float32)) for s in sides
                for v in s]
        rel, jcdt = 1e-5, jnp.bfloat16
        jin = [(np.asarray(wt, np.float32), np.asarray(wb, np.float32))
               for wt, wb in sides]
        jmat = (Q.astype(np.float32), A0.astype(np.float32))
    else:
        data = [torch.from_numpy(a) for a in (Q, A0)]
        vecs = [torch.from_numpy(v) for s in sides for v in s]
        rel, jcdt = 1e-6, jnp.float64
        jin, jmat = sides, (Q, A0)
    outs = kkt_pass(*data, *vecs)
    assert len(outs) == nv
    for (partial, rowdot), (wt, wb), (jwt, jwb) in zip(outs, sides, jin):
        assert tuple(partial.shape) == (B, n_chunks(n, m), n)
        assert tuple(rowdot.shape) == (B, m)
        top, bot = _jax_products(*jmat, jwt, jwb, jcdt)
        _close(partial.sum(1), top, rel)
        _close(rowdot, bot, rel)
        if cdt == "float32":   # float64 all through: numpy's products
            _close(partial.sum(1), np.einsum("bi,bij->bj", wt, Q)
                   + np.einsum("bi,bij->bj", wb, A0), 1e-12)
            _close(rowdot, np.einsum("bij,bj->bi", A0, wt), 1e-12)


@pytest.mark.parametrize("n,m", SHAPES)
def test_plain_partials_are_the_chunk_sums(n, m):
    """partial[b, c] sums rows [32c, 32c + 32) of [Q; A0] weighted by
    [wt; wb] (the last chunk ragged), in float64 to 1e-12."""
    B = 2
    Q, A0, ((wt, wb), _) = _inputs(5, B, n, m)
    partial, _ = kkt_pass_plain(*(torch.from_numpy(a)
                                  for a in (Q, A0, wt, wb)))
    mat = np.concatenate([Q, A0], axis=1)
    w = np.concatenate([wt, wb], axis=1)
    rows = _build.KKT_ROWS
    for c in range(n_chunks(n, m)):
        sl = slice(c * rows, min((c + 1) * rows, n + m))
        ref = np.einsum("bi,bij->bj", w[:, sl], mat[:, sl])
        _close(partial[:, c], ref, 1e-12)


def test_wrapper_takes_the_plain_version_on_cpu_tensors():
    Q, A0, sides = _inputs(3, 2, 37, 21)
    data = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
            for a in (Q, A0)]
    vecs = [torch.from_numpy(v.astype(np.float32)) for s in sides
            for v in s]
    before = kkt_pass.launches
    outs = kkt_pass(*data, *vecs)
    assert kkt_pass.launches == before
    for (p, r), (wt, wb) in zip(outs, (vecs[:2], vecs[2:])):
        rp, rr = kkt_pass_plain(*data, wt, wb)
        assert torch.equal(p, rp) and torch.equal(r, rr)
        assert p.dtype == r.dtype == torch.float32


@pytest.mark.parametrize("bad", ["Q", "A0", "wt", "wb", "wt2", "half"])
def test_wrapper_rejects_mismatched_shapes(bad):
    B, n, m = 2, 8, 5
    args = dict(Q=torch.zeros(B, n, n), A0=torch.zeros(B, m, n),
                wt=torch.zeros(B, n), wb=torch.zeros(B, m),
                wt2=torch.zeros(B, n), wb2=torch.zeros(B, m))
    if bad == "half":
        del args["wb2"]
    else:
        t = args[bad]
        args[bad] = torch.zeros(*t.shape[:-1], t.shape[-1] + 1)
    with pytest.raises(ValueError, match="kkt_pass"):
        kkt_pass(**args)
