"""Closed-loop serving: one caller solves batches back to back.

Set-up makes a pool of instances and the untrained weights from the seed
on the device, builds ``iadmm_tpu_torch.api.make_solver`` with the cell's
routes and the configuration's profile, and warms it up.  Each solve takes
``batch`` instances drawn at random from the pool (the same draws for the
same seed); its latency runs from the call of ``solve(batch)`` to its
synchronised result.

A sample of ``check_solves`` solves, drawn from the seed as the window runs
(a reservoir), keeps what the timed path produced: the answer, and the
rollout kernel's output on the way to it, which a wrapper around
``iadmm_tpu_torch.kernels.rollout_kernel.fused_rollout`` holds by
reference (no device work; see :meth:`_Port.recording`).  After the window
the reference judges those solves from the raw instances (see
:func:`compare`), the K learned iterations included: the mix's
``weight_scale`` draws the weights at a scale where the untrained
recurrence is tame enough for the reference to follow it to its end.

Cell parameters: ``pool``, ``batch``, ``feas_rest_num``, ``rollout_impl``,
``stage2_impl``, ``weight_scale`` (a factor for each named leaf of the
drawn weights), ``warmup`` (solves in set-up), ``trace_solves`` (solves in
the traced window), ``check_solves`` (solves compared), ``limits``.
"""

from __future__ import annotations

import contextlib
import functools
import sys

import numpy as np
import torch

from qpbench.gen import qp as gen_qp, weights as gen_weights
from qpbench.lib.result import p95
from qpbench.lib.trace_run import TraceRun
from qpbench.reference import precision, residuals as ref_res, rollout, \
    serve as ref

FIELDS = ("x", "y", "z", "primal_res", "dual_res", "obj")
DATA = ("Q", "p", "A0", "zl", "zu")


def _shape(cfg, cell):
    return dict(B=cell["batch"], n=cfg["num_var"],
                m=cfg["num_ineq"] + cfg["num_eq"], h=cfg["hidden_dim"],
                K=cfg["outer_T"], N=cell["feas_rest_num"],
                scaling_iters=cfg["scaling_ites"])


HOOK = ("no rollout output was captured: the benchmark reads it by "
        "wrapping iadmm_tpu_torch.kernels.rollout_kernel.fused_rollout, "
        "which api.make_solver's solve looks up in that module at each "
        "call (api.py, solve's _rollout); a program that imports it "
        "elsewhere, renames it or fuses it into another stage needs a new "
        "capture point in qpbench/traffic/serve_closed.py")


class _Port:
    """The system under test: the port's ``make_solver``.  ``solve(data)``
    returns the answer; while ``keep`` is set, the rollout kernel's output
    in that solve is kept as its ``trail``."""

    def __init__(self, ctx, params):
        from iadmm_tpu_torch.api import make_solver
        from iadmm_tpu_torch.utils.profiling import StepTimer
        cfg, cell = ctx.config, ctx.cell
        self.ctx, self.params = ctx, params
        self.timer = StepTimer() if ctx.trace else None
        self._solve = make_solver(
            params, hidden_dim=cfg["hidden_dim"], num_iters=cfg["outer_T"],
            sigma=cfg["sigma"], scaling_iters=cfg["scaling_ites"],
            feas_rest_num=cell["feas_rest_num"],
            use_pallas=cfg["use_pallas"], gate_dtype=cfg["gate_dtype"],
            matvec_mode=cfg["matvec_mode"],
            rollout_impl=cell["rollout_impl"],
            stage2_impl=cell["stage2_impl"], timer=self.timer)
        self.keep = False
        self._trail = None

    @contextlib.contextmanager
    def recording(self):
        """Wrap the rollout kernel's entry for the run, then restore it.
        ``make_solver``'s solve imports ``fused_rollout`` from its module
        at each call, so the wrapper sees every call of the timed path."""
        from iadmm_tpu_torch.kernels import rollout_kernel as rk
        real = rk.fused_rollout

        @functools.wraps(real)   # its launch counter too
        def fused_rollout(params, data, **kw):
            out = real(params, data, **kw)
            if self.keep:
                self._trail = dict(rollout=out)
            return out
        rk.fused_rollout = fused_rollout
        try:
            yield
        finally:
            rk.fused_rollout = real
            if hasattr(fused_rollout, "launches"):
                real.launches = fused_rollout.launches

    def solve(self, data):
        self._trail = None
        res = self._solve(data)
        out = {f: getattr(res, f) for f in FIELDS}
        if self.keep:
            out["trail"] = self._trail
        return out


class _Control:
    """The reference at the control precision in the program's place."""

    def __init__(self, ctx, params):
        self.ctx, self.params, self.timer = ctx, params, None
        self.prec = precision.profile("control")
        self.keep = False

    def recording(self):
        return contextlib.nullcontext()

    def solve(self, data):
        cfg, cell = self.ctx.config, self.ctx.cell
        return ref.solve(self.params, *(getattr(data, k) for k in DATA),
                         data.eq_mask, K=cfg["outer_T"],
                         N=cell["feas_rest_num"], sigma=cfg["sigma"],
                         scaling_iters=cfg["scaling_ites"], prec=self.prec)


class _Reservoir:
    """A uniform sample of ``k`` of the solves, drawn from the seed as they
    come: ``slot(i)`` is where solve ``i`` goes, or None."""

    def __init__(self, k, seed):
        self.k, self.rng, self.items = k, np.random.default_rng([seed, 7]), []

    def slot(self, i):
        if i < self.k:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else None

    def put(self, slot, item):
        if slot == len(self.items):
            self.items.append(item)
        else:
            self.items[slot] = item


def run(ctx):
    from iadmm_tpu_torch.types import QPBatch
    from iadmm_tpu_torch.utils.profiling import annotate
    cfg, cell, dev = ctx.config, ctx.cell, ctx.device
    n, mi, me = cfg["num_var"], cfg["num_ineq"], cfg["num_eq"]
    B, P = cell["batch"], cell["pool"]
    g = ctx.generator()
    weights = gen_weights.lstm(g, cfg["input_dim"], cfg["hidden_dim"],
                               cfg["outer_T"], dev,
                               scale=cell.get("weight_scale"))
    pool = gen_qp.pool(n, mi, me, P, g, dev)
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

    numbers = compare(ctx, prog, weights, pool, sample.items)
    e2e = {}
    if not ctx.trace:
        e2e = {"solve_ms_p95": 1e3 * p95(lat),
               "solve_inst_per_s": B * len(lat) / span}
    return dict(attempted=attempted, failed=failed, e2e=e2e,
                numbers=numbers, memory_peak_bytes=mem, trace=trace)


def _rel(a, r):
    """Per instance: max|a − r| / max|r| over the rows of (B, k) tensors."""
    return ((a.float() - r).abs().amax(1)
            / r.abs().amax(1).clamp_min(1e-30))


def compare(ctx, prog, weights, pool, kept) -> dict:
    """The numbers that decide ``correct`` (those the cell's ``limits``
    name), each the widest over the kept solves' instances, against the
    reference from the same weights and raw instances:

    - ``x_gap``: the answer's x against the reference's whole solve (its
      own Ruiz, K learned iterations from zero, unscale, Stage II), which
      holds the window's rollout through the answer; max|·−ref| / max|ref|;
    - ``polish_gap``: everything after the rollout, from the program's own
      rollout output in the window: the reference unscales it with its own
      factors and runs Stage II, against the program's answer x;
    - ``claim_gap``: what an answer says of itself against what it is: its
      residuals and objective against the same recomputed in float64 from
      its x, y, z, relative;
    - ``rollout_gap``: the rollout kernel's output in the window, all K
      iterations, against the reference's rollout, over x, y, z; and
      ``rollout_gap_median``, ``x_gap_median``: the median instance's.
    With the cell parameter ``own_gap`` (studies only), ``x_gap_own`` and
    ``rollout_gap_own``: the reference against itself with its hidden
    units permuted, which differs by rounding alone.  An answer that is
    not finite, or a solve that left no trail, reads infinity."""
    cfg, cell = ctx.config, ctx.cell
    K, N, sigma = cfg["outer_T"], cell["feas_rest_num"], cfg["sigma"]
    prec = precision.profile("reference")
    per = {k: [] for k in ("rollout_gap", "polish_gap", "claim_gap",
                           "x_gap")}
    inf = {k: float("inf") for k in per}
    if not kept:
        return inf
    for ids, out in kept:
        trail = out.get("trail")
        if trail is None:
            print(f"qpbench: {HOOK}", file=sys.stderr, flush=True)
            return inf
        if not all(bool(torch.isfinite(out[f]).all()) for f in FIELDS):
            return inf
        idx = torch.as_tensor(ids, device=ctx.device)
        d = {k: pool[k].index_select(0, idx) for k in DATA + ("eq_mask",)}
        raw = tuple(d[k] for k in DATA)
        scaled, factors = ref.scale(*raw, scaling_iters=cfg["scaling_ites"])
        learned = ref.learned(weights, scaled, d["eq_mask"], K=K,
                              sigma=sigma, prec=prec)
        own = tuple(t.float() for t in trail["rollout"])
        per["rollout_gap"] += torch.stack([_rel(a, r) for a, r in
                                           zip(own, learned)]).amax(0).tolist()
        polished = ref.finish(weights, own, factors, *raw, d["eq_mask"], K=K,
                              N=N, sigma=sigma, prec=prec)
        per["polish_gap"] += _rel(out["x"], polished["x"]).tolist()
        pr, dr, obj = ref_res.residuals(out["x"], out["y"], out["z"],
                                        d["Q"], d["p"], d["A0"],
                                        dtype=torch.float64)
        per["claim_gap"] += torch.stack([
            (out[f].double() - v).abs() / v.abs().clamp_min(1e-30)
            for f, v in (("primal_res", pr), ("dual_res", dr),
                         ("obj", obj))]).amax(0).tolist()
        whole = ref.finish(weights, learned, factors, *raw, d["eq_mask"],
                           K=K, N=N, sigma=sigma, prec=prec)
        per["x_gap"] += _rel(out["x"], whole["x"]).tolist()
        if cell.get("own_gap"):
            # the reference against itself with its hidden units permuted
            perm = torch.randperm(weights["U"].shape[0], device=ctx.device,
                                  generator=ctx.generator())
            twin_learned = ref.learned(rollout.permute_hidden(weights, perm),
                                       scaled, d["eq_mask"], K=K,
                                       sigma=sigma, prec=prec)
            twin = ref.finish(weights, twin_learned, factors, *raw,
                              d["eq_mask"], K=K, N=N, sigma=sigma, prec=prec)
            per.setdefault("rollout_gap_own", []).extend(torch.stack([
                _rel(a, r) for a, r in zip(twin_learned, learned)
            ]).amax(0).tolist())
            per.setdefault("x_gap_own", []).extend(
                _rel(twin["x"], whole["x"]).tolist())
    gaps = {k: max(v) for k, v in per.items()}
    gaps["x_gap_median"] = float(np.median(per["x_gap"]))
    gaps["rollout_gap_median"] = float(np.median(per["rollout_gap"]))
    return gaps
