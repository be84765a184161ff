"""The grouped BSR launch on the CPU: its plain version against single
products, and the BSR route with grouped products against the same route
with one matvec a product (the route as it was before grouping), bitwise:
loss, final state, every gradient and the evaluation traces.  No JAX.

A grouped product sums nothing differently, so the forward is bitwise by
construction; the gradients are bitwise only if autograd sums a vector's
contributions in the same order, which the order of the products within a
group decides (``kernels/sparse.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from iadmm_tpu_torch.kernels import sparse as tsp
from iadmm_tpu_torch.kernels import sparse_matvec as tsm
from iadmm_tpu_torch.problems import generate, to_qp_batch
from iadmm_tpu_torch.scaling import scale_batch
from iadmm_tpu_torch.solvers.cells import lstm_init
from iadmm_tpu_torch.types import IterState, init_state

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _band(g, B, m, n, w):
    M = torch.randn((B, m, n), generator=g)
    band = (torch.arange(m)[:, None] * n // m
            - torch.arange(n)[None, :]).abs() <= w
    return (M * band).numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("tm,m,n,w", [(8, 200, 300, 9), (128, 200, 300, 9),
                                      (128, 1000, 1500, 40)])
def test_group_plain_is_single_plain_calls(dtype, tm, m, n, w):
    """bsr_matvec_group_plain (and bsr_matvec_group on CPU tensors) is
    bitwise bsr_matvec_plain on each pair: products of different shapes
    and stored-tile counts (M, Mᵀ, M with another vector)."""
    g = torch.Generator().manual_seed(m + tm)
    M, MT = tsm.bsr_pair_from_dense(_band(g, 2, m, n, w), (tm, 128),
                                    DTYPES[dtype], device="cpu")
    mats = [M, MT, M]
    vs = [torch.randn((2, n), generator=g), torch.randn((2, m), generator=g),
          torch.randn((2, n), generator=g)]
    for fn in (tsm.bsr_matvec_group_plain, tsm.bsr_matvec_group):
        outs = fn(mats, vs)
        assert len(outs) == 3
        for o, Mi, v in zip(outs, mats, vs):
            assert torch.equal(o, tsm.bsr_matvec_plain(Mi, v))


def test_group_rejects_what_the_kernel_does_not_take():
    g = torch.Generator().manual_seed(0)
    M, MT = tsm.bsr_pair_from_dense(_band(g, 2, 40, 300, 4), (8, 128),
                                    device="cpu")
    Mb = tsm.bsr_from_dense(_band(g, 2, 40, 300, 4), (8, 128),
                            torch.bfloat16, device="cpu")
    v, w = torch.zeros((2, 300)), torch.zeros((2, 40))
    with pytest.raises(ValueError, match="1 to 3"):
        tsm.bsr_matvec_group_cuda([M] * 4, [v] * 4)
    with pytest.raises(ValueError, match="1 to 3"):
        tsm.bsr_matvec_group_cuda([M, MT], [v])
    with pytest.raises(TypeError, match="one tile dtype"):
        tsm.bsr_matvec_group_cuda([M, Mb], [v, v])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsm.bsr_matvec_group_cuda([M, MT], [v, w])
    before = tsm.bsr_matvec.launches
    tsm.bsr_matvec_group([M, MT], [v, w])   # CPU: plain version, no launch
    assert tsm.bsr_matvec.launches == before


def test_group_ad_gradient_is_single_products():
    """bsr_matvec_group_ad's VJP: each vector's gradient bitwise
    bsr_matvec_ad's; a vector given to two products gets the sum of their
    VJPs; no gradient where none is needed."""
    g = torch.Generator().manual_seed(4)
    M, MT = tsm.bsr_pair_from_dense(_band(g, 2, 200, 300, 9), (8, 128),
                                    device="cpu")
    u = torch.randn((2, 300), generator=g).requires_grad_(True)
    y = torch.randn((2, 200), generator=g)
    wa, wb = torch.randn((2, 200), generator=g), torch.randn((2, 300),
                                                             generator=g)
    a, b = tsm.bsr_matvec_group_ad([(M, MT), (MT, M)], [u, y])
    ((a * wa).sum() + (b * wb).sum()).backward()
    assert torch.equal(u.grad, tsm.bsr_matvec_plain(MT, wa))
    u2 = u.detach().clone().requires_grad_(True)
    a, c = tsm.bsr_matvec_group_ad([(M, MT), (M, MT)], [u2, u2])
    ((a * wa).sum() + (c * wa).sum()).backward()
    gu = tsm.bsr_matvec_plain(MT, wa)
    assert torch.equal(u2.grad, gu + gu)


class _Ungrouped:
    """A BSR batch seen through its single products only (``Qv``, ``Av``,
    ``ATv``, one matvec each): the route before grouping."""

    def __init__(self, batch):
        self._batch = batch

    def __getattr__(self, name):
        return getattr(self._batch, name)


def _route_inputs(dtype, B=2, n=300, mi=150, h=16, K=8, seed=5):
    ds = generate("Sparse_QP", num_var=n, num_ineq=mi, data_size=B,
                  seed=seed)
    data = to_qp_batch(ds, np.arange(B), device="cpu")
    scaled, sc = scale_batch(data)
    bsr = tsp.from_dense(scaled, fmt="bsr", tile=(8, 128),
                         dtype=DTYPES[dtype])
    p = lstm_init(torch.Generator().manual_seed(1), 2, h, K, device="cpu")
    p = {k: v * 20 if k == "U" else v for k, v in p.items()}
    return data, sc, bsr, p


def _state(bsr, h, t0):
    st = init_state(bsr.p.shape[0], bsr.num_var, bsr.num_constr, h,
                    device="cpu")
    if t0 == 0:
        return st
    g = torch.Generator().manual_seed(2)
    return IterState(*[0.1 * torch.randn(getattr(st, f.name).shape,
                                         generator=g)
                       for f in dataclasses.fields(st)])


def _fields(st):
    return [getattr(st, f.name) for f in dataclasses.fields(st)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("t0", [0, 2])
def test_grouped_chunk_loss_is_bitwise_the_ungrouped_route(dtype, remat, t0):
    """chunk_loss_sparse on the grouped BSR route: loss, final state and
    every gradient torch.equal to the route with one matvec a product,
    from the zero start (t0 = 0: the start state needs no gradient) and
    from a random one."""
    _, _, bsr, p0 = _route_inputs(dtype)
    runs = []
    for data in (bsr, _Ungrouped(bsr)):
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        loss, fin = tsp.chunk_loss_sparse(p, _state(bsr, 16, t0), data,
                                          6e-6, 4, 8, t0, remat=remat)
        loss.backward()
        runs.append((loss.detach(), _fields(fin), p))
    (la, fa, pa), (lb, fb, pb) = runs
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(fa, fb))
    for k in pa:
        assert torch.equal(pa[k].grad, pb[k].grad), k


def test_grouped_kkt_feature_and_eval_rollout_are_the_ungrouped_route():
    """kkt_feature_sparse (value and its VJP in xv, x, y, z) and the
    eval_rollout_sparse traces and final state, torch.equal to the route
    with one matvec a product."""
    data, sc, bsr, p = _route_inputs("bfloat16")
    g = torch.Generator().manual_seed(6)
    n, m = bsr.num_var, bsr.num_constr
    base = [torch.randn((2, k), generator=g) for k in (n + m, n, m, m)]
    rho = torch.sigmoid(torch.randn((m,), generator=g))
    w = torch.randn((2, n + m), generator=g)
    outs = []
    for route in (bsr, _Ungrouped(bsr)):
        args = [t.clone().requires_grad_(True) for t in base]
        f = tsp.kkt_feature_sparse(route, *args, 6e-6, rho)
        (f * w).sum().backward()
        outs.append([f.detach()] + [a.grad for a in args])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    st0 = init_state(2, n, m, 16, device="cpu")
    (fa, ta), (fb, tb) = (
        tsp.eval_rollout_sparse(p, st0, route, data, sc, 6e-6, 5)
        for route in (bsr, _Ungrouped(bsr)))
    assert all(torch.equal(a, b) for a, b in zip(_fields(fa), _fields(fb)))
    for f in ("obj", "primal_res", "dual_res", "ls_res"):
        assert torch.equal(getattr(ta, f), getattr(tb, f)), f


def test_grouped_route_products_per_chunk(monkeypatch):
    """The grouped launches of a chunk of J steps: three a step forward,
    three a step backward except at a zero start, where only A0ᵀ·r2 and
    the residual group need one (6J − 1 in all; 18J − 5 single products
    before grouping)."""
    calls = []
    plain = tsm.bsr_matvec_group_plain

    def spy(mats, vs):
        calls.append(len(mats))
        return plain(mats, vs)

    monkeypatch.setattr(tsm, "bsr_matvec_group_plain", spy)
    _, _, bsr, p = _route_inputs("bfloat16")
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    J = 4
    loss, _ = tsp.chunk_loss_sparse(p, _state(bsr, 16, 0), bsr, 6e-6, J, 8,
                                    0)
    assert len(calls) == 3 * J and sum(calls) == 9 * J
    del calls[:]
    loss.backward()
    assert len(calls) == 3 * J - 1 and sum(calls) == 9 * J - 5
