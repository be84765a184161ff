"""The segment-recompute training route of ``kernels/train_rollout.py`` on
the CPU.

The route's plain pair (:func:`train_fwd_seg_plain`,
:func:`train_bwd_seg_plain`), reached through ``make_fused_chunk_loss``
with ``seg``, is held against the JAX package's
``make_fused_chunk_loss(interpret=True, stream=False, seg=s)`` on the same
numpy-made inputs, at the tolerances of ``test_torch_train_kernels.py``
(loss rtol 1e-5; final state rtol 2e-4, atol 2e-5; gradients per leaf,
normalised by the leaf's max, atol 5e-5 in float32 and 2e-2 in bfloat16).
In float64 it is held to the port's own stream route to 1e-12: loss, final
state, every gradient leaf and the start state's cotangents.  Both
packages must pick the same kernel pair and segment length.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from iadmm_tpu.kernels.train_rollout import (
    make_fused_chunk_loss as j_make_fused)
from iadmm_tpu.problems import generators as jgen

from iadmm_tpu_torch import config as tconfig
from iadmm_tpu_torch.kernels import train_rollout as ttr
from iadmm_tpu_torch.train import harness as tharness

from test_torch_train_kernels import (B, H, J, K_TOTAL, KEYS, M, N, SIGMA,
                                      _tensors, jax_side, make_inputs,
                                      torch_side)
from torch_bridge import to_numpy

STATE = ("x", "y", "z", "xv", "H", "C")


@pytest.mark.parametrize("t0", [0, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seg", [1, 2, J])
def test_segment_route_matches_jax_segment_kernels(seg, dtype, t0):
    data, params, state = make_inputs(seed=20 + t0)
    route = dict(stream=False, seg=seg)
    jl, jst, jg = jax_side(data, params, state, t0, dtype, **route)
    tl, tst, tg = torch_side(data, params, state, t0, dtype, **route)
    assert np.isfinite(float(tl.detach()))
    np.testing.assert_allclose(float(tl.detach()), jl, rtol=1e-5)
    for f in STATE:
        np.testing.assert_allclose(to_numpy(getattr(tst, f)),
                                   np.asarray(getattr(jst, f)), rtol=2e-4,
                                   atol=2e-5, err_msg=f"state.{f}")
    atol = 5e-5 if dtype == "float32" else 2e-2
    for k in KEYS:
        a, b = to_numpy(tg[k]), np.asarray(jg[k])
        assert a.shape == b.shape, k
        denom = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / denom, b / denom, rtol=0, atol=atol,
                                   err_msg=f"grad[{k}]")


@pytest.mark.parametrize("seg", [1, 2, J])
def test_segment_route_matches_stream_route_f64(seg):
    """Float64, no rounding: through ``make_fused_chunk_loss`` the loss,
    final state and gradients of both routes; through the segment pair
    itself, with non-zero cotangents on the losses and the final state, the
    gradients and the start state's cotangents against one sweep of the
    stream pair."""
    f64, t0 = torch.float64, 2
    data, params, state = make_inputs(seed=30 + seg)
    sl, sst, sg = torch_side(data, params, state, t0, "float32", wd=f64,
                             stream=False, seg=seg)
    rl, rst, rg = torch_side(data, params, state, t0, "float32", wd=f64)
    close = dict(rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(sl, rl, **close)
    for f in STATE:
        torch.testing.assert_close(getattr(sst, f), getattr(rst, f),
                                   msg=f"state.{f}", **close)
    for k in KEYS:
        torch.testing.assert_close(sg[k], rg[k], msg=f"grad[{k}]", **close)

    weights, st, dd = _tensors(data, params, state, f64)
    kw = dict(sigma=SIGMA, compute_dtype="float32")
    g = torch.Generator().manual_seed(seg)
    dpr = torch.rand((B, J), generator=g, dtype=f64)
    ddr = torch.rand((B, J), generator=g, dtype=f64)
    pr, dr, final, streams = ttr.train_fwd_plain(weights, st, dd, t0=t0, J=J,
                                                 **kw)
    dfinal = tuple(0.1 * torch.randn(f.shape, generator=g, dtype=f64)
                   for f in final)
    ref, ref_d = ttr.train_bwd_plain(weights, dd, streams, dfinal, dpr, ddr,
                                     t0=t0, J=J, **kw)
    ckpts, cur, prs = [], st, []
    for s in range(J // seg):
        ckpts.append(cur)
        p_, _, cur = ttr.train_fwd_seg_plain(weights, cur, dd,
                                             t0=t0 + s * seg, J=seg, **kw)
        prs.append(p_)
    torch.testing.assert_close(torch.cat(prs, 1), pr, **close)
    acc, dst = None, dfinal
    for s in reversed(range(J // seg)):
        acc, dst = ttr.train_bwd_seg_plain(weights, ckpts[s], dd, dst, dpr,
                                           ddr, t0=t0 + s * seg, J=seg,
                                           col=s * seg, acc=acc, **kw)
    for k, a, b in zip(KEYS, acc, ref):
        torch.testing.assert_close(a, b, msg=f"d{k}", **close)
    for k, a, b in zip(STATE, dst, ref_d):
        torch.testing.assert_close(a, b, msg=f"d{k} (start state)", **close)


@pytest.mark.parametrize("seg", [3, 5])
def test_seg_must_divide_the_chunk(seg):
    with pytest.raises(ValueError, match="divide"):
        ttr.make_fused_chunk_loss(num_var=N, num_constr=M, batch=B, hidden=H,
                                  sigma=SIGMA, chunk_len=J, outer_T=J,
                                  K_total=K_TOTAL, seg=seg)


FLAGSHIP = dict(num_var=1000, num_constr=1000, hidden=800, chunk_len=100)
SMALL = dict(num_var=100, num_constr=100, hidden=128, chunk_len=50)
RAGGED = dict(num_var=13, num_constr=7, hidden=20, chunk_len=18)
ROUTE_CASES = (
    [dict(FLAGSHIP, batch=b) for b in range(7, 13)]
    + [dict(SMALL, batch=2), dict(SMALL, batch=1000),
       dict(RAGGED, batch=3), dict(RAGGED, batch=3, budget=1e5),
       dict(FLAGSHIP, batch=2, seg=2), dict(FLAGSHIP, batch=2, stream=False),
       dict(FLAGSHIP, batch=16, stream=True),
       dict(SMALL, batch=2, seg=5, stream=True),
       dict(RAGGED, batch=3, seg=6)])


@pytest.mark.parametrize("case", ROUTE_CASES,
                         ids=lambda c: "-".join(f"{k}{v}" for k, v in
                                                c.items()))
def test_both_packages_pick_the_same_pair(case, monkeypatch):
    """The JAX side is built in interpret mode and never called."""
    case = dict(case)
    if "budget" in case:
        monkeypatch.setenv("IADMM_STREAM_HBM", str(case.pop("budget")))
    else:
        monkeypatch.delenv("IADMM_STREAM_HBM", raising=False)
    kw = dict(case, sigma=SIGMA, outer_T=case["chunk_len"],
              K_total=case["chunk_len"])
    jfn = j_make_fused(interpret=True, **kw)
    tfn = ttr.make_fused_chunk_loss(**kw)
    assert (tfn.stream, tfn.segment_len) == (jfn.stream, jfn.segment_len)
    if case["chunk_len"] == 100 and case["batch"] >= 9 and "stream" not in \
            case and "seg" not in case:
        assert (tfn.stream, tfn.segment_len) == (False, 2)


def test_harness_epoch_on_the_segment_route_matches_the_stream_route(
        tmp_path, monkeypatch):
    """One ``harness.train`` epoch with train_backend='fused' at a batch
    that the rule sends to the segment route (``IADMM_STREAM_HBM`` set below
    its streams), against the same epoch on the stream route: the same
    losses and parameters (the same float32 sums in the same order)."""
    ds = jgen.generate("QP", num_var=12, num_ineq=6, num_eq=6, data_size=8,
                       seed=3)
    runs = {}
    for name, budget in (("segment", "1e5"), ("stream", "1e10")):
        monkeypatch.setenv("IADMM_STREAM_HBM", budget)
        cfg = tconfig.ExperimentConfig(
            prob_type="QP", num_var=12, num_ineq=6, num_eq=6, data_size=8,
            hidden_dim=8, outer_T=18, truncated_length=18, batch_size=2,
            lr=5e-3, num_epoch=1, val_frac=0.25, test_frac=0.0, eq_tol=1e9,
            num_devices=1, scaling=False, preload="never",
            train_backend="fused", matvec_mode="bf16",
            save_dir=str(tmp_path / name))
        res = tharness.train(cfg, ds, verbose=False, device="cpu")
        log = pathlib.Path(cfg.save_dir, cfg.model_name,
                           cfg.run_name() + ".log.jsonl").read_text()
        route = [json.loads(ln) for ln in log.splitlines()
                 if '"fused_route"' in ln]
        runs[name] = (res, route)
    assert [(r["stream"], r["segment_len"]) for r in runs["segment"][1]] \
        == [(False, 9)]
    assert [(r["stream"], r["segment_len"]) for r in runs["stream"][1]] \
        == [(True, 18)]
    seg, ref = runs["segment"][0], runs["stream"][0]
    assert [h["train_loss"] for h in seg.history] == \
        [h["train_loss"] for h in ref.history]
    assert np.isfinite(seg.history[0]["train_loss"])
    for k in ref.params:
        assert torch.equal(seg.params[k], ref.params[k]), k
