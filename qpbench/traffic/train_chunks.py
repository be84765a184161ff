"""TBPTT training: chunk updates back to back over the preloaded train stack.

Set-up makes ``data_size`` instances and the untrained weights from the
seed on the device, hands the instances to the port as its own data entry
(a host ``RawDataset``) through ``train.preload.preload_train_stack`` (Ruiz
once, Q and A0 in ``preload_dtype``), builds the chunk update the harness
dispatches (``harness.make_chunk_body`` with the cell's chunk loss and
``ClippedAdam``) and drives that same object through the first
``first_steps`` updates, on batches that all differ.  Those steps are the
warm-up, and the reference follows them: each step's loss, the first
gradient as the optimizer holds it after one step, and the parameters'
change over the steps.  The window then runs updates over the following
batches, epoch after epoch over the stack in the order of the seed's
shuffle; each update starts a batch from the zero state (K = J: one chunk
a batch).

Cell parameters: ``data_size``, ``first_steps``, ``trace_updates``
(updates in the traced window), ``limits``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from qpbench.gen import qp as gen_qp, weights as gen_weights
from qpbench.lib.trace_run import TraceRun
from qpbench.reference import precision, train as ref_train

LEAVES = ("W", "U", "b", "W_h", "b_h", "rho", "alpha")


def _sizes(cfg):
    n, m = cfg["num_var"], cfg["num_ineq"] + cfg["num_eq"]
    K, J = cfg["outer_T"], cfg["truncated_length"]
    if K != J:
        raise ValueError("this traffic kind runs one chunk a batch (outer_T == "
                         "truncated_length)")
    return n, m, cfg["hidden_dim"], K, J, cfg["batch_size"]


def _raw_dataset(raw, prob_type):
    """The port's host data entry: half Hessian, as the generators store
    it (the loader doubles it)."""
    from iadmm_tpu_torch.problems.generators import RawDataset
    return RawDataset(prob_type, Q=(0.5 * raw["Q"]).cpu().numpy(),
                      p=raw["p"].cpu().numpy(), A0=raw["A0"].cpu().numpy(),
                      zl=raw["zl"].cpu().numpy(), zu=raw["zu"].cpu().numpy())


class _Program:
    """The system under test: the port's chunk update over its preloaded
    train data: the dense scaled stack and the fused training kernels."""

    def __init__(self, ctx, weights, raw, order):
        from iadmm_tpu_torch.config import ExperimentConfig
        from iadmm_tpu_torch.scaling import scale_batch
        from iadmm_tpu_torch.train import harness, preload
        from iadmm_tpu_torch.utils.profiling import annotate
        from iadmm_tpu_torch.kernels.train_rollout import \
            make_fused_chunk_loss
        cfg, dev = ctx.config, ctx.device
        n, m, h, K, J, B = _sizes(cfg)
        self.ctx, self.B, self.n, self.m, self.h = ctx, B, n, m, h
        pcfg = ExperimentConfig(
            prob_type=cfg["prob_type"], num_var=n, num_ineq=cfg["num_ineq"],
            num_eq=cfg["num_eq"], data_size=len(order), hidden_dim=h,
            sigma=cfg["sigma"], scaling=True, scaling_ites=cfg["scaling_ites"],
            outer_T=K, truncated_length=J, batch_size=B, lr=cfg["lr"],
            clip_grad_norm=cfg["clip_grad_norm"], use_pallas=cfg["use_pallas"],
            gate_dtype=cfg["gate_dtype"], matvec_mode=cfg["matvec_mode"],
            preload_dtype=cfg["preload_dtype"], train_backend="fused")
        self.n_batches = len(order) // B
        ds = _raw_dataset(raw, cfg["prob_type"])
        scale = functools.partial(scale_batch, iters=cfg["scaling_ites"])
        ids = order[:self.n_batches * B]
        stack, cost = preload.preload_train_stack(
            ds, ids, self.n_batches, B, pcfg, scale, device=dev)
        self.cache = _Stack(stack, cost, B)
        loss = make_fused_chunk_loss(
            num_var=n, num_constr=m, batch=B, hidden=h, sigma=cfg["sigma"],
            chunk_len=J, outer_T=K, K_total=K,
            compute_dtype="bfloat16" if cfg["matvec_mode"] == "bf16"
            else "float32")
        del ds
        self.params = {k: v.clone().requires_grad_(True)
                       for k, v in weights.items()}
        self.optimizer = harness.make_optimizer(
            self.params, cfg["lr"], 0.0, cfg["clip_grad_norm"])
        opt = self.optimizer
        if ctx.trace:
            # traced run only: each part ends with a device sync, so the
            # profile attributes its device time by span
            def loss_fn(p, st, data, t0):
                with annotate("train/forward"):
                    out = loss(p, st, data, t0)
                    ctx.sync()
                return out
            opt = _SpannedOptimizer(self.optimizer, ctx, annotate)
        else:
            loss_fn = loss
        self.body = harness.make_chunk_body(None, opt, K, J, cfg["sigma"],
                                            loss_fn=loss_fn)

    def update(self, bi):
        from iadmm_tpu_torch.types import init_state
        data, _ = self.cache[bi]
        st = init_state(self.B, self.n, self.m, self.h,
                        device=self.ctx.device)
        _, loss = self.body(self.params, st, data, 0)
        return loss

    def first_grads(self):
        """The first gradient as the optimizer holds it after one step:
        Adam's first moment is (1 − β1)·g."""
        ea = self.optimizer.state_arrays()["exp_avg"]
        return {k: (torch.as_tensor(ea[k]) / 0.1 if k in ea
                    else torch.zeros_like(v.detach().cpu()))
                for k, v in self.params.items()}


class _Stack:
    """Batch ``bi`` of the dense stack, as the harness indexes it."""

    def __init__(self, stack, cost, B):
        self.stack, self.cost, self.B = stack, cost, B

    def __getitem__(self, bi):
        from iadmm_tpu_torch.train.preload import index_stack
        return index_stack(self.stack, self.cost, bi, self.B)


class _Control:
    """The reference at the control precision in the program's place, with
    the program's interface: it scales each batch of the raw instances
    itself and steps its own Adam."""

    def __init__(self, ctx, weights, raw, order):
        from qpbench.reference import adam
        cfg = ctx.config
        self.ctx, self.raw, self.order = ctx, raw, order
        self.B = cfg["batch_size"]
        self.n_batches = len(order) // self.B
        self.prec = precision.profile("control")
        self.params = {k: v.clone().requires_grad_(True)
                       for k, v in weights.items()}
        self.opt = adam.Adam(self.params, cfg["lr"], cfg["clip_grad_norm"])
        self.grad1 = None

    def update(self, bi):
        from qpbench.reference import chunk, ruiz
        cfg, prec, B = self.ctx.config, self.prec, self.B
        idx = torch.as_tensor(self.order[bi * B:(bi + 1) * B],
                              device=self.ctx.device)
        d = {k: v.index_select(0, idx) for k, v in self.raw.items()}
        with precision.no_tf32():
            Qs, ps, As, zls, zus, *_ = ruiz.scale(
                d["Q"], d["p"], d["A0"], d["zl"], d["zu"],
                cfg["scaling_ites"])
            L = chunk.loss(self.params, prec.low(Qs), ps, prec.low(As), zls,
                           zus, d["eq_mask"], J=cfg["truncated_length"],
                           K=cfg["outer_T"], t0=0, sigma=cfg["sigma"],
                           low=prec.low,
                           cell=ref_train.cell_rounding(prec,
                                                        cfg["cell_dtype"]))
            L.backward()
            g = self.opt.step()
        if self.grad1 is None:
            self.grad1 = {k: v.detach().clone() for k, v in g.items()}
        return L.detach()

    def first_grads(self):
        return self.grad1


class _SpannedOptimizer:
    """``ClippedAdam`` with the traced run's span around its step."""

    def __init__(self, inner, ctx, annotate):
        self.inner, self.ctx, self.annotate = inner, ctx, annotate

    def zero_grad(self):
        self.inner.zero_grad()

    def step(self):
        self.ctx.sync()          # the backward has run
        with self.annotate("train/optimizer"):
            self.inner.step()
            self.ctx.sync()


def run(ctx):
    from iadmm_tpu_torch.utils.profiling import annotate
    cfg, cell, dev = ctx.config, ctx.cell, ctx.device
    n, m, h, K, J, B = _sizes(cfg)
    size = cell["data_size"]
    g = ctx.generator()
    weights = gen_weights.lstm(g, cfg["input_dim"], h, K, dev)
    raw = gen_qp.pool(n, cfg["num_ineq"], cfg["num_eq"], size, g, dev)
    order = np.random.default_rng(ctx.seed).permutation(size)
    steps = cell["first_steps"]
    # the reference's copy of the first steps' instances, as generated
    first = torch.as_tensor(order[:steps * B], device=dev)
    kept = {k: v.index_select(0, first) for k, v in raw.items()}
    prog = (_Control if ctx.program == "control" else _Program)(
        ctx, weights, raw, order)
    del raw
    ctx.free()

    start = {k: v.detach().clone() for k, v in prog.params.items()}
    losses, grad1 = [], None
    for s in range(steps):
        losses.append(float(prog.update(s)))
        if s == 0:
            grad1 = prog.first_grads()
    change = {k: (prog.params[k].detach() - start[k]) for k in LEAVES}
    ctx.sync()
    ctx.mark_setup()

    window_losses = []
    bi = steps
    trace = None
    if ctx.trace:
        shape = dict(B=B, J=J, n=n, m=m, h=h, K=K,
                     dtype="bfloat16" if cfg["matvec_mode"] == "bf16"
                     else "float32",
                     params=sum(v.numel() for v in weights.values()),
                     update_counts=("train_fwd", "train_bwd", "adam"))
        trace = TraceRun(ctx, shape)
        with trace.window():
            for _ in range(cell["trace_updates"]):
                with annotate("bench/call"):
                    window_losses.append(prog.update(bi % prog.n_batches))
                    ctx.sync()
                trace.calls.append({})
                bi += 1
    else:
        t_open = ctx.now()
        while ctx.now() - t_open < ctx.seconds:
            window_losses.append(prog.update(bi % prog.n_batches))
            bi += 1
        ctx.sync()
        span = ctx.now() - t_open
    mem = ctx.memory_peak()
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    del prog
    ctx.free()

    numbers = compare(ctx, weights, kept, losses, grad1, change)
    e2e = {}
    if not ctx.trace:
        e2e = {"train_inst_iters_per_s": B * J * len(window_losses) / span}
    return dict(attempted=len(window_losses), failed=failed, e2e=e2e,
                numbers=numbers, memory_peak_bytes=mem, trace=trace)


def leaf_gaps(prog: dict, ref: dict) -> list:
    """Each leaf's gap of norms, |‖a‖ − ‖r‖| over the larger of ‖r‖ and
    the median leaf's ‖r‖; leaves whose reference gradient is nought to
    rounding are left out by the caller."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double()))
             for k in ref}
    med = float(np.median(list(norms.values())))
    return [abs(float(torch.linalg.vector_norm(prog[k].double()))
                - norms[k]) / max(norms[k], med, 1e-30) for k in ref]


def compare(ctx, weights, kept, losses, grad1, change) -> dict:
    """The numbers that decide ``correct``, against the reference's first
    steps from the same weights and instances:

    - ``loss_gap``: each step's loss, |L − L_ref| / |L_ref|, the widest;
    - ``grad_gap``: the first clipped gradient, worst leaf (``leaf_gap``);
    - ``change_gap``: the parameters' change over the steps, worst leaf;
    and the steadier ``loss1_gap`` (the first step's loss alone),
    ``grad_gap_median`` and ``change_gap_median`` (the median leaf's).
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of both (their change is round-off alone).
    A non-finite reading is infinity."""
    cfg, cell = ctx.config, ctx.cell
    B = cfg["batch_size"]
    batches = [tuple(kept[k][s * B:(s + 1) * B]
                     for k in ("Q", "p", "A0", "zl", "zu", "eq_mask"))
               for s in range(cell["first_steps"])]
    ref = ref_train.first_steps(
        weights, batches, K=cfg["outer_T"], J=cfg["truncated_length"],
        sigma=cfg["sigma"], lr=cfg["lr"], clip=cfg["clip_grad_norm"],
        scaling_iters=cfg["scaling_ites"], prec=precision.profile("reference"),
        cell_dtype=cfg["cell_dtype"])
    gn = {k: float(torch.linalg.vector_norm(v)) for k, v in
          ref["grad1"].items()}
    med = float(np.median(list(gn.values())))
    counted = [k for k in LEAVES if gn[k] >= 1e-3 * med]
    g_ref = {k: ref["grad1"][k].cpu() for k in counted}
    c_ref = {k: ref["change"][k].cpu() for k in counted}
    loss = [abs(a - r) / abs(r) for a, r in zip(losses, ref["losses"])]
    grad = leaf_gaps({k: grad1[k].cpu() for k in counted}, g_ref)
    chg = leaf_gaps({k: change[k].cpu() for k in counted}, c_ref)
    out = {"loss_gap": max(loss), "grad_gap": max(grad),
           "change_gap": max(chg), "loss1_gap": loss[0],
           "grad_gap_median": float(np.median(grad)),
           "change_gap_median": float(np.median(chg))}
    return {k: (v if np.isfinite(v) else float("inf")) for k, v in out.items()}
