"""Ruiz scaling's kernel route on the CPU: the summation order of the cost
norm's mean that ``csrc/ruiz.cu`` takes (``ruiz_kernel.kernel_order_mean``)
against a scalar walk of the kernel's loop, its block width against ATen's
reduction rule, the kernel's plain version against the plain function,
and the wrapper's argument checks, none of which builds a kernel.  Imports
no JAX.  The kernel itself is held on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from iadmm_tpu_torch.kernels import _build, ruiz_kernel as rk
from iadmm_tpu_torch.problems import generate, to_qp_batch
from iadmm_tpu_torch.scaling.ruiz import ruiz_scale, ruiz_scale_plain


@pytest.fixture
def no_nvcc(monkeypatch):
    """Any attempt to build or load a kernel fails the test."""
    def refuse(*_a, **_k):
        raise AssertionError("a CPU call reached the kernel build")
    monkeypatch.setattr(_build, "build_all", refuse)
    monkeypatch.setattr(_build, "library", refuse)


def outputs(r):
    """The eight outputs of ``ruiz_scale``: Q, p, A0, zl, zu, d, e, cost."""
    return (*r[:5], r[5].d, r[5].e, r[5].cost)


def _kernel_loop_mean(v):
    """The kernel's ``torch_order_sum`` walked thread by thread in float32
    scalars, times float(B)/float(B·n)."""
    B, n = v.shape
    W = rk.mean_width(B, n)
    f = np.float32
    out = []
    for row in v.numpy().astype(np.float32):
        sums = []
        for x in range(W):
            acc = [f(0)] * 4
            for q in range(x, n // 4, W):
                for i in range(4):
                    acc[i] = f(acc[i] + row[4 * q + i])
            if x < n % 4:
                acc[0] = f(acc[0] + row[4 * (n // 4) + x])
            sums.append(f(f(f(acc[0] + acc[1]) + acc[2]) + acc[3]))
        off = W // 2
        while off >= 32:
            sums = [f(sums[x] + sums[x + off]) for x in range(off)]
            off //= 2
        for off in (16, 8, 4, 2, 1):
            sums = [f(sums[x] + sums[x + off]) if x + off < 32 else sums[x]
                    for x in range(32)]
        out.append(f(sums[0] * f(f(B) / f(B * n))))
    return torch.tensor(out)


@pytest.mark.parametrize("B,n", [(8, 1000), (1, 1000), (3, 37), (2, 130),
                                 (5, 1001), (16, 515)])
def test_kernel_order_mean_is_the_kernels_loop(B, n):
    """Bitwise the kernel's loop, thread by thread; within float32
    rounding of the float64 mean."""
    g = torch.Generator().manual_seed(n)
    v = torch.rand((B, n), generator=g) * torch.logspace(-3, 3, n)
    got = rk.kernel_order_mean(v)
    assert torch.equal(got, _kernel_loop_mean(v))
    ref = v.double().mean(dim=-1)
    assert float(((got.double() - ref).abs() / ref).max()) < 1e-5


@pytest.mark.parametrize("B,n,W", [(8, 1000, 64), (1, 1000, 128),
                                   (16, 4096, 32), (2, 4096, 256),
                                   (64, 1000, 32), (1, 100000, 512),
                                   (8, 37, 32)])
def test_mean_width_follows_the_reduce_config(B, n, W):
    """ATen's ReduceConfig at 512 threads: block.x up to a warp, block.y
    over the outputs up to 512 / 32, block.x widened into the rest."""
    assert rk.mean_width(B, n) == W


@pytest.mark.parametrize("iters", [0, 1, 10])
def test_ruiz_plain_is_the_plain_function_up_to_the_mean(no_nvcc, iters):
    """The kernel's plain version differs from the plain function only in
    the mean's order: within float32 rounding, on every output."""
    data = to_qp_batch(generate("QP", num_var=40, num_ineq=20, num_eq=20,
                                data_size=3, seed=9), device="cpu")
    args = (data.Q, data.p, data.A0, data.zl, data.zu)
    got = rk.ruiz_plain(*args, iters=iters)
    ref = ruiz_scale_plain(*args, iters=iters)
    for a, b in zip(outputs(got), outputs(ref)):
        fin = torch.isfinite(b)
        assert torch.equal(a[~fin], b[~fin])
        scale = b[fin].abs().max().clamp_min(1e-30)
        assert float((a[fin] - b[fin]).abs().max() / scale) < 1e-5


def test_ruiz_scale_cuda_rejects_bad_inputs(no_nvcc):
    """CPU tensors and mismatched shapes raise before any build."""
    data = to_qp_batch(generate("QP", num_var=10, num_ineq=5, num_eq=5,
                                data_size=2, seed=1), device="cpu")
    args = [data.Q, data.p, data.A0, data.zl, data.zu]
    with pytest.raises(ValueError, match="float32 CUDA"):
        rk.ruiz_scale_cuda(*args)
    bad = list(args)
    bad[3] = data.zl[:, :4]
    with pytest.raises(ValueError, match="do not fit"):
        rk.ruiz_scale_cuda(*bad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("iters", [0, 1, 10])
def test_ruiz_scale_on_cpu_is_the_plain_function(no_nvcc, dtype, iters):
    """CPU data take the plain function, bit for bit, build nothing and
    launch nothing."""
    data = to_qp_batch(generate("QP", num_var=30, num_ineq=15, num_eq=15,
                                data_size=2, seed=4), dtype=dtype,
                       device="cpu")
    args = (data.Q, data.p, data.A0, data.zl, data.zu)
    before = rk.ruiz_scale_cuda.launches
    got = ruiz_scale(*args, iters=iters)
    ref = ruiz_scale_plain(*args, iters=iters)
    for a, b in zip(outputs(got), outputs(ref)):
        assert a.dtype == dtype and torch.equal(a, b)
    assert rk.ruiz_scale_cuda.launches == before == 0
