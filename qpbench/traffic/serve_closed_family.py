"""Closed-loop serving of the problem family the configuration names.

The kind ``serve_closed`` with two differences: the pool comes from the
generator of the configuration's ``prob_type`` (``QP``: ``gen/qp.py``,
``Random_QP``: ``gen/random_qp.py``), where ``serve_closed`` makes the
``QP`` family alone; and the comparison adds one number,
``rollout_state_gap`` (:func:`compare_family`).  The program, the control,
the sample of solves kept for the check and the rest of the comparison are
``serve_closed``'s, imported from it; so are the cell parameters (its
docstring lists them).
"""

from __future__ import annotations

import numpy as np
import torch

from qpbench.gen import qp as gen_qp, random_qp as gen_random_qp, \
    weights as gen_weights
from qpbench.lib.result import p95
from qpbench.lib.trace_run import TraceRun
from qpbench.reference import precision, rollout, serve as ref
from qpbench.traffic.serve_closed import (DATA, FIELDS, HOOK, _Control,
                                          _Port, _Reservoir, _shape, compare)


def family_pool(cfg: dict, count: int, g: torch.Generator, device) -> dict:
    """``count`` instances of the configuration's ``prob_type``."""
    n, mi, me = cfg["num_var"], cfg["num_ineq"], cfg["num_eq"]
    kind = cfg["prob_type"]
    if kind == "QP":
        return gen_qp.pool(n, mi, me, count, g, device)
    if kind == "Random_QP":
        if me:
            raise ValueError("Random_QP has no equality rows (num_eq 0)")
        return gen_random_qp.pool(n, mi, count, g, device)
    raise ValueError(f"no generator for prob_type {kind!r}")


def run(ctx):
    from iadmm_tpu_torch.types import QPBatch
    from iadmm_tpu_torch.utils.profiling import annotate
    cfg, cell, dev = ctx.config, ctx.cell, ctx.device
    B, P = cell["batch"], cell["pool"]
    g = ctx.generator()
    weights = gen_weights.lstm(g, cfg["input_dim"], cfg["hidden_dim"],
                               cfg["outer_T"], dev,
                               scale=cell.get("weight_scale"))
    pool = family_pool(cfg, P, g, dev)
    params = {k: v.clone() for k, v in weights.items()}
    prog = (_Control if ctx.program == "control" else _Port)(ctx, params)
    draws = np.random.default_rng(ctx.seed)
    sample = _Reservoir(cell["check_solves"], ctx.seed)

    def next_batch():
        ids = np.sort(draws.choice(P, B, replace=False))
        idx = torch.as_tensor(ids, device=dev)
        return ids, QPBatch(**{k: pool[k].index_select(0, idx)
                               for k in DATA + ("eq_mask",)})

    def one(i):
        """Solve ``i``: (its latency, whether its answer is not finite)."""
        ids, data = next_batch()
        slot = sample.slot(i)
        prog.keep = slot is not None
        ctx.sync()
        t0 = ctx.now()
        out = prog.solve(data)
        ctx.sync()
        t1 = ctx.now()
        if slot is not None:
            sample.put(slot, (ids, out))
        bad = not all(bool(torch.isfinite(out[f]).all()) for f in FIELDS)
        return t1 - t0, bad

    with prog.recording():
        for w in range(cell["warmup"]):
            prog.keep = w == 0
            if prog.solve(next_batch()[1]).get("trail", {}) is None:
                raise RuntimeError(HOOK)
        prog.keep = False
        ctx.sync()
        ctx.mark_setup()

        lat, failed = [], 0
        trace = None
        if ctx.trace:
            trace = TraceRun(ctx, _shape(cfg, cell))
            timer = prog.timer
            with trace.window():
                for i in range(cell["trace_solves"]):
                    before = timer.summary() if timer else {}
                    with annotate("bench/call"):
                        _, bad = one(i)
                    after = timer.summary() if timer else {}
                    trace.calls.append({"phases": {
                        k: v["total"] - before.get(k, {}).get("total", 0.0)
                        for k, v in after.items()}})
                    failed += bad
            attempted = cell["trace_solves"]
        else:
            t_open = ctx.now()
            while True:
                dt, bad = one(len(lat))
                lat.append(dt)
                failed += bad
                if ctx.now() - t_open >= ctx.seconds:
                    break
            span = ctx.now() - t_open
            attempted = len(lat)
    mem = ctx.memory_peak()
    ctx.free()

    numbers = compare_family(ctx, prog, weights, pool, sample.items)
    e2e = {}
    if not ctx.trace:
        e2e = {"solve_ms_p95": 1e3 * p95(lat),
               "solve_inst_per_s": B * len(lat) / span}
    return dict(attempted=attempted, failed=failed, e2e=e2e,
                numbers=numbers, memory_peak_bytes=mem, trace=trace)


def _state_rel(a, r):
    """Per instance: max|a − r| over x, y and z together, over max|r| over
    them together; (B, k) tensors."""
    num = torch.stack([(u.float() - v).abs().amax(1) for u, v in zip(a, r)])
    den = torch.stack([v.abs().amax(1) for v in r])
    return num.amax(0) / den.amax(0).clamp_min(1e-30)


def compare_family(ctx, prog, weights, pool, kept) -> dict:
    """``serve_closed.compare``'s numbers and ``rollout_state_gap``: the
    rollout kernel's output in the window against the reference's rollout
    from the same weights and raw instances, all K iterations, each
    instance's (x, y, z) weighed by the largest entry of the three, widest
    over the kept solves' instances.  ``compare``'s ``rollout_gap`` weighs
    each vector by its own largest entry: a vector that stays near zero (y,
    where few rows reach their bounds in the learned iterations) then reads
    its rounding as a large share, and that number's median spreads from
    4e-5 to 2e-2 over sound runs of the ``Random_QP`` cell.  With the cell
    parameter ``own_gap``, ``rollout_state_gap_own``: the reference against
    itself with its hidden units permuted (``compare``'s permutation).  A
    solve that left no trail reads infinity."""
    cfg = ctx.config
    numbers = compare(ctx, prog, weights, pool, kept)
    if not kept or any(out.get("trail") is None for _, out in kept):
        numbers["rollout_state_gap"] = float("inf")
        return numbers
    kw = dict(K=cfg["outer_T"], sigma=cfg["sigma"],
              prec=precision.profile("reference"))
    per, own = [], []
    for ids, out in kept:
        idx = torch.as_tensor(ids, device=ctx.device)
        d = {k: pool[k].index_select(0, idx) for k in DATA + ("eq_mask",)}
        scaled, _ = ref.scale(*(d[k] for k in DATA),
                              scaling_iters=cfg["scaling_ites"])
        learned = ref.learned(weights, scaled, d["eq_mask"], **kw)
        per += _state_rel(out["trail"]["rollout"], learned).tolist()
        if ctx.cell.get("own_gap"):
            perm = torch.randperm(weights["U"].shape[0], device=ctx.device,
                                  generator=ctx.generator())
            twin = ref.learned(rollout.permute_hidden(weights, perm), scaled,
                               d["eq_mask"], **kw)
            own += _state_rel(twin, learned).tolist()
    numbers["rollout_state_gap"] = max(per)
    if own:
        numbers["rollout_state_gap_own"] = max(own)
    return numbers
