"""Training harness: TBPTT over unrolled ADMM iterations.

Counterpart of ``iadmm_tpu/train/harness.py`` on its per-batch route: each
batch is converted with ``to_qp_batch``, Ruiz-scaled, and rolled out in
``outer_T // truncated_length`` chunks from a zero state (float32 H/C);
each chunk is one loss evaluation, one ``backward()`` and one optimizer
step, with the state detached between chunks and gradients taken with
respect to the parameters only.  Validation is one full rollout over the
validation split, with the objective and violations in the original space
recovered from the Ruiz vectors.  Around that: the tolerance-gated
``EarlyStopping`` with a best checkpoint, ``train_hours``, ``resume``
(the best or the ``_latest`` checkpoint, whichever is newer), the loss-spike
rollback, a ``_latest`` checkpoint every 10 epochs and at exit, and a JSONL
``RunLog``.

``train_backend='step'`` differentiates ``chunk_loss`` over the learned
step (the cell kernel with ``use_pallas``); ``'fused'`` uses the training
kernels of :mod:`iadmm_tpu_torch.kernels.train_rollout`.

Dense data is preloaded as the JAX package preloads it
(:mod:`iadmm_tpu_torch.train.preload`): ``preload='always'``, or
``'auto'`` when one copy of the scaled train split fits
:func:`~iadmm_tpu_torch.train.preload.device_memory_budget`, scales the
train split once into a device stack (Q and A0 in ``preload_dtype``; Q as
its float32 diagonal when every Hessian is diagonal, the route is not
``'fused'`` and preload is not ``'never'``), and each batch is an index
into it; ``'never'`` converts and scales each batch when it is used.
``epoch_scan=True`` dispatches batch by batch over the stack: the JAX
package's whole-epoch scan steps the optimizer once a chunk as well, so
the updates are the same.  ``sparse=True`` trains over sparse problem
data (:mod:`iadmm_tpu_torch.kernels.sparse`): ``sparse_format='bsr'``
through the BSR matvec kernel, ``'bcoo'`` (the default) through the
gather-based BCOO matvecs; the train split is scaled and converted once
into a device cache, or per batch with ``preload='never'``; validation
stays dense.  ``model_name`` selects the cell
(:data:`~iadmm_tpu_torch.solvers.step.CELL_REGISTRY`); the cell kernel and
the precision profile apply to ``'lstm'`` only, as in the JAX package.

Under a process group (:mod:`iadmm_tpu_torch.dist`, one process a device)
``num_devices``/``model_devices`` build the JAX harness's mesh
(:func:`~iadmm_tpu_torch.dist.mesh_for`).  Each rank trains on its
``batch_size / dp`` rows of every batch (its rows of the preloaded stack
or sparse cache; on the per-batch route the batch is converted whole and
sharded), and after the local ``backward()`` the gradients are averaged
over 'data' (one all-reduce) before the clipping, whose global norm sums
the tensor-parallel leaves' squares over 'model'.  ``model_devices > 1``
runs the plain cell of ``model_name`` on the tensor-parallel layout, split
by hidden unit (:func:`~iadmm_tpu_torch.solvers.step.make_cell_step`;
``gd`` replicated).  Every host decision is rank 0's (``train_hours``, and
the reduced loss, objective and validation that the early stopping and the
spike rollback read), only rank 0 prints and writes the checkpoints (full
JAX layout) and the ``RunLog``, and every rank reads on ``resume``.  The
first chunk update runs under the compile watchdog (it includes the
kernels' first build).  Not ported: the TPU-worker crash recovery (see
:mod:`iadmm_tpu_torch.train.recovery`).
"""

from __future__ import annotations

import dataclasses
import os
import time
from functools import partial
from typing import Dict, Optional

import numpy as np
import torch

from .. import dist
from ..config import ExperimentConfig
from ..evaluation import metrics
from ..kernels import sparse as sparse_mod
from ..problems.generators import RawDataset
from ..problems.io import split_ids, to_qp_batch
from ..scaling import scale_batch
from ..solvers.rollouts import chunk_loss, rollout
from ..solvers.cells import gate_count
from ..solvers.step import (check_schedule_len, get_cell, make_cell_step,
                            make_lstm_step)
from ..types import IterState, init_state
from ..utils.logging import RunLog
from ..utils.profiling import span, start_compile_watchdog
from . import checkpoint as ckpt
from .early_stopping import EarlyStopping
from .recovery import restore_snapshot, snapshot
from .preload import (dataset_q_is_diagonal, device_memory_budget,
                      index_stack, preload_sparse_cache, preload_train_stack,
                      train_stack_bytes)


def clip_by_global_norm_(grads, max_norm: float, mesh=None,
                         sharded=None) -> None:
    """optax's ``clip_by_global_norm``: every gradient becomes
    ``g / ‖g‖ · max_norm`` when the global norm ‖g‖ reaches ``max_norm``,
    and stays unchanged below it (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``).  Under a 'model' axis the
    squares of the grads flagged in ``sharded`` (one flag a grad) are
    summed over it."""
    if mesh is not None and mesh.tensor_parallel:
        sq = [(g * g).sum() for g in grads]
        norm_sq = sum(s for s, f in zip(sq, sharded) if not f)
        if any(sharded):   # gd has no sharded leaf
            sq_sh = torch.stack([s for s, f in zip(sq, sharded) if f]).sum()
            norm_sq = dist.all_reduce_(sq_sh.reshape(1), mesh,
                                       "model")[0] + norm_sq
        norm = torch.sqrt(norm_sq)
    else:
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


class ClippedAdam:
    """Adam over a dict of parameter tensors, as the JAX package's optax
    chain computes it: global-norm clipping first (when
    ``clip_grad_norm > 0``), then L2 decay added to the gradient before the
    moments (``weight_decay``), then Adam with betas (0.9, 0.999) and
    eps 1e-8 outside the square root.  With a ``mesh`` the gradients are
    first averaged over 'data' (:func:`~iadmm_tpu_torch.dist.
    average_grads_`), the clipping norm spans the tensor-parallel shards,
    and :meth:`state_arrays` gathers the moments (of a cell with ``gates``
    gate blocks) to the full layout."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 weight_decay: float = 0.0, clip_grad_norm: float = 0.0,
                 mesh=None, gates: int = 4):
        self.params = params
        self.mesh = mesh
        self.gates = gates
        self.clip = clip_grad_norm
        self.adam = torch.optim.Adam(list(params.values()), lr=lr,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.mesh is not None:
            dist.average_grads_(self.params, self.mesh)
        if self.clip:
            clip_by_global_norm_([p.grad for p in self.params.values()],
                                 self.clip, self.mesh,
                                 [k in dist.mesh.TP_KEYS
                                  for k in self.params])
        self.adam.step()

    def state_arrays(self) -> Dict:
        """The moments and step count as numpy arrays (checkpoint form, the
        full layout: under a 'model' axis a collective of the model
        ranks)."""
        moments = {"exp_avg": {}, "exp_avg_sq": {}}
        step = np.zeros((), np.int64)
        for k, p in self.params.items():
            st = self.adam.state.get(p)
            if not st:
                continue
            moments["exp_avg"][k] = st["exp_avg"]
            moments["exp_avg_sq"][k] = st["exp_avg_sq"]
            step = np.asarray(int(st["step"]), np.int64)
        if self.mesh is not None and self.mesh.tensor_parallel:
            moments = dist.tp_gather_params(moments, self.mesh, self.gates)
        return {**ckpt.to_numpy(moments), "step": step}

    def load_state_arrays(self, arrays: Dict) -> None:
        step = int(arrays["step"])
        for k, p in self.params.items():
            if k not in arrays["exp_avg"]:
                continue
            self.adam.state[p] = {
                "step": torch.tensor(float(step)),
                "exp_avg": torch.as_tensor(arrays["exp_avg"][k]).to(p),
                "exp_avg_sq": torch.as_tensor(arrays["exp_avg_sq"][k]).to(p)}


def make_optimizer(params: Dict[str, torch.Tensor], lr: float,
                   weight_decay: float = 0.0, clip_grad_norm: float = 0.0,
                   mesh=None, gates: int = 4) -> ClippedAdam:
    """The training optimizer over ``params`` (see :class:`ClippedAdam`)."""
    return ClippedAdam(params, lr, weight_decay, clip_grad_norm, mesh, gates)


def _detach(st: IterState) -> IterState:
    return IterState(*(getattr(st, f.name).detach()
                       for f in dataclasses.fields(IterState)))


def make_chunk_body(step_fn, optimizer: ClippedAdam, outer_T: int,
                    chunk_len: int, sigma: float, remat: bool = False,
                    loss_fn=None, mesh=None):
    """The TBPTT chunk update: ``body(params, state, data, t0) ->
    (state', loss)`` takes the gradient of the chunk loss with respect to
    ``params`` and updates them in place with one optimizer step.
    ``loss_fn(params, state, data, t0) -> (loss, state')`` replaces the
    chunk loss over ``step_fn`` (the fused training kernels; under a mesh
    it returns the mean over 'data', as the step route's does with
    ``mesh``).

    An update opens the spans ``chunk/forward`` (the ``loss_fn`` call) and
    ``chunk/backward`` (``loss.backward()``) (:func:`~iadmm_tpu_torch.
    utils.profiling.span`): under a profiler each ends with a device
    synchronisation, under an active ``StepTimer`` each is a phase ended by
    a fetch barrier, and otherwise they do nothing."""
    if loss_fn is None:
        def loss_fn(p, state, data, t0):
            loss, final = chunk_loss(step_fn, p, state, data, sigma,
                                     chunk_len, outer_T, t0, remat=remat)
            return dist.data_mean(loss, mesh), final

    def chunk_body(params, state: IterState, data, t0):
        optimizer.zero_grad()
        with span("chunk/forward") as box:
            loss, new_state = loss_fn(params, _detach(state), data, t0)
            box["result"] = loss
        with span("chunk/backward") as box:
            loss.backward()
            # a copy of any tensor waits for the backward queued before it
            box["result"] = loss
        optimizer.step()
        return _detach(new_state), loss.detach()

    return chunk_body


make_train_chunk = make_chunk_body  # the per-batch route's chunk update


def make_val_fn(step_fn, outer_T: int, sigma: float, hidden_dim: int):
    """Full-rollout validation: ``val_fn(params, data_scaled, scaling) ->
    (mean objective, violations dict)`` in the original space."""

    @torch.no_grad()
    def val_fn(params, data_scaled, scaling):
        B = data_scaled.p.shape[0]
        st = init_state(B, data_scaled.num_var, data_scaled.num_constr,
                        hidden_dim, dtype=data_scaled.p.dtype,
                        device=data_scaled.p.device)
        st = rollout(step_fn, params, st, data_scaled, sigma, outer_T)
        obj = metrics.obj_fn(st.x, data_scaled.Q, data_scaled.p)
        x = st.x
        if scaling is not None:
            obj = obj / scaling.cost
            x = scaling.d * st.x
        return obj.mean(), metrics.violation_stats(x, data_scaled)

    return val_fn


@dataclasses.dataclass
class TrainResult:
    params: Dict
    history: list
    best_val_obj: Optional[float]
    epochs_run: int
    checkpoint_path: Optional[str]


def _restore_(params, optimizer: ClippedAdam, payload: Dict,
              mesh=None) -> bool:
    """Load a checkpoint's params, and its optimizer state when it is the
    port's own, in the run's layout (:func:`~iadmm_tpu_torch.train.
    recovery.restore_snapshot`); returns whether the optimizer state was
    loaded."""
    opt = payload.get("opt_state")
    own = isinstance(opt, dict) and "exp_avg" in opt
    dev = next(iter(params.values())).device
    arrays, opt = restore_snapshot(
        ({k: payload["params"][k] for k in params}, opt if own else None),
        mesh, device=dev, gates=optimizer.gates)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(arrays[k].to(p))
    if own:
        optimizer.load_state_arrays(opt)
    return own


def train(cfg: ExperimentConfig, ds: RawDataset, verbose: bool = True,
          device="cuda") -> TrainResult:
    """End-to-end training of ``cfg`` on ``ds`` (see the module docstring)."""
    cfg.check_ported()
    mesh = dist.mesh_for(cfg.num_devices, cfg.batch_size, cfg.model_devices)
    lead = mesh is None or mesh.rank == 0
    verbose = verbose and lead
    dp = mesh.size("data") if mesh is not None else 1
    mp = mesh.size("model") if mesh is not None else 1
    B = cfg.batch_size // dp          # this rank's rows of a batch
    hidden = cfg.hidden_dim // mp     # this rank's hidden units
    runlog = RunLog(os.path.join(cfg.save_dir, cfg.model_name,
                                 cfg.run_name() + ".log.jsonl")
                    if cfg.save_dir and lead else None)
    runlog.log("config", **cfg.to_dict())
    if verbose and mesh is not None:
        print(f"mesh: data={dp} x model={mp}" if mp > 1 else
              f"data-parallel over {dp} devices", flush=True)
    train_ids, val_ids, _ = split_ids(cfg.data_size, cfg.val_frac,
                                      cfg.test_frac, cfg.seed)
    cell = get_cell(cfg.model_name)
    # cfg.inner_T reaches only the multi-layer init, which ignores it, as in
    # the JAX package: the step runs its default inner_T
    init = cell.init(torch.Generator().manual_seed(cfg.seed),
                     cfg.input_dim, cfg.hidden_dim, cfg.outer_T,
                     device=device,
                     **({"inner_T": cfg.inner_T}
                        if cfg.model_name == "multi_layer_lstm" else {}))

    step_fn = cell.step
    gates = gate_count(cfg.model_name)
    if cfg.model_name == "lstm" and (
            mp > 1 or cfg.use_pallas or cfg.matvec_mode != "highest"):
        step_fn = make_lstm_step(
            use_pallas=cfg.use_pallas, gate_dtype=cfg.gate_dtype,
            matvec_mode=None if cfg.matvec_mode == "highest"
            else cfg.matvec_mode, mesh=mesh)
    elif mp > 1:   # the cell split by hidden unit over 'model'
        step_fn = make_cell_step(cfg.model_name, mesh)

    fused_loss = None
    if cfg.sparse and cfg.train_backend == "fused":
        raise ValueError("train_backend='fused' is a dense-data kernel; "
                         "use the step path with sparse=True")
    if cfg.train_backend == "fused":
        if cfg.model_name != "lstm":
            raise ValueError("train_backend='fused' supports the lstm cell")
        from ..kernels.train_rollout import make_fused_chunk_loss
        fused_loss = make_fused_chunk_loss(
            num_var=ds.Q.shape[-1], num_constr=ds.A0.shape[-2],
            batch=B, hidden=cfg.hidden_dim, sigma=cfg.sigma,
            chunk_len=cfg.truncated_length, outer_T=cfg.outer_T,
            K_total=cfg.outer_T,
            compute_dtype="bfloat16" if cfg.matvec_mode == "bf16"
            else "float32", mesh=mesh)
        route = dict(stream=fused_loss.stream,
                     segment_len=fused_loss.segment_len)
        runlog.log("fused_route", **route)
        if verbose:
            print(f"fused training kernels: stream={route['stream']}, "
                  f"segment_len={route['segment_len']}", flush=True)

    loss_override = fused_loss
    if cfg.sparse:
        loss_override = sparse_mod.make_sparse_chunk_loss(
            cfg.sigma, cfg.truncated_length, cfg.outer_T, remat=cfg.remat,
            mesh=mesh)

    val_fn = make_val_fn(step_fn, cfg.outer_T, cfg.sigma, hidden)
    scale = partial(scale_batch, iters=cfg.scaling_ites)

    val_scaled = to_qp_batch(ds, val_ids, device=device)
    val_sc = None
    if cfg.scaling:
        val_scaled, val_sc = scale(val_scaled)

    ckpt_path = ckpt.checkpoint_path(cfg.save_dir, cfg.model_name,
                                     cfg.run_name())
    latest_path = ckpt.latest_path(ckpt_path)
    best: Dict = {}

    # Every rank reads the checkpoint; the parameters and the optimizer
    # state go from the full layout to the run's (replicated from rank 0,
    # or this rank's tensor-parallel shard).
    start_epoch = 0
    resumed_best = None
    payload = None
    if cfg.resume:
        best_epoch = -1
        if os.path.exists(ckpt_path):
            payload = ckpt.load_checkpoint(ckpt_path)
            best_epoch = int(payload.get("epoch", 0))
            resumed_best = payload.get("best")
        if os.path.exists(latest_path):
            latest = ckpt.load_checkpoint(latest_path)
            if int(latest.get("epoch", 0)) > best_epoch:
                payload = dict(latest)
                # keep the gated best's stopper state, so a later in-gate
                # epoch cannot overwrite a strictly better checkpoint
                if resumed_best is not None:
                    payload["best"] = resumed_best
    placed, _ = restore_snapshot((init, None), mesh, device=device,
                                 gates=gates)
    params = {k: v.to(init[k].dtype).requires_grad_(True)
              for k, v in placed.items()}
    optimizer = make_optimizer(params, cfg.lr, cfg.weight_decay,
                               cfg.clip_grad_norm, mesh=mesh, gates=gates)
    train_chunk = make_train_chunk(step_fn, optimizer, cfg.outer_T,
                                   cfg.truncated_length, cfg.sigma,
                                   remat=cfg.remat, loss_fn=loss_override,
                                   mesh=mesh)
    if payload is not None:
        with_opt = _restore_(params, optimizer, payload, mesh)
        start_epoch = int(payload.get("epoch", 0)) + 1
        resumed_best = payload.get("best")
        if verbose:
            print(f"resumed at epoch {start_epoch} (gated best epoch: "
                  f"{best_epoch}; optimizer state "
                  f"{'restored' if with_opt else 'fresh'})")
    check_schedule_len(params, cfg.outer_T)

    def full_params():
        return snapshot(params, None, mesh, gates)[0]

    def save(path, payload):
        # the collectives (the tensor-parallel gathers) ran on every rank
        # before this; only rank 0 writes
        if lead:
            ckpt.save_checkpoint(path, payload)

    def save_best():
        best["params"] = full_params()
        save(ckpt_path, {
            "params": best["params"], "opt_state": optimizer.state_arrays(),
            "epoch": best.get("epoch", 0),
            "best": {"val_obj": stopper.best_loss,
                     "counter": stopper.counter},
            "config": cfg.to_dict()})

    stopper = EarlyStopping(patience=cfg.patience, save_fn=save_best)
    if resumed_best:
        stopper.best_loss = resumed_best.get("val_obj")
        stopper.counter = int(resumed_best.get("counter", 0))
    n_batches = len(train_ids) // cfg.batch_size
    n_chunks = cfg.outer_T // cfg.truncated_length
    history = []
    epochs_run = 0

    # Dense route: scale the train split once into a device stack (see the
    # module docstring); preload='never' scales each batch when it is used.
    # Under a mesh the stack holds this rank's rows and the budget is the
    # rank's.
    n_used = n_batches * cfg.batch_size
    stacked = cost_stack = None
    dtype_bytes = 2 if cfg.preload_dtype == "bfloat16" else 4
    # Diagonal-Hessian families store Q as its diagonal; the fused training
    # kernels read a dense Q, so that route keeps dense storage.
    diag_q = (not cfg.sparse and cfg.preload != "never"
              and cfg.train_backend != "fused"
              and dataset_q_is_diagonal(ds))
    train_bytes = train_stack_bytes(ds, n_batches * B, dtype_bytes,
                                    diag_q=diag_q)
    auto = not cfg.sparse and cfg.preload == "auto"
    fits = auto and train_bytes < device_memory_budget(device)
    if auto and not fits and verbose:
        print(f"train split ({train_bytes / 1e9:.4f} GB scaled) over the "
              f"preload budget: per-batch route", flush=True)
    if not cfg.sparse and (cfg.preload == "always" or fits):
        stacked, cost_stack = preload_train_stack(
            ds, train_ids[:n_used], n_batches, cfg.batch_size, cfg, scale,
            device=device, diag_q=diag_q, mesh=mesh)
        runlog.log("preload", bytes=train_bytes, diag_q=diag_q,
                   dtype=cfg.preload_dtype)
        if verbose:
            print(f"preloaded train split: {train_bytes / 1e9:.4f} GB "
                  f"scaled-only on {device}"
                  + (" (diagonal-Q storage)" if diag_q else "")
                  + (" a rank" if mesh is not None else ""), flush=True)

    # Sparse route: scale and tile the train split once into a device
    # cache; preload='never' converts each batch when it is used.
    sparse_cache = None
    if cfg.sparse and cfg.preload != "never":
        sparse_cache = preload_sparse_cache(
            ds, train_ids[:n_used], n_batches, cfg.batch_size, cfg, scale,
            device=device, verbose=verbose, mesh=mesh)

    t_begin = time.time()
    epoch = start_epoch
    first_dispatch = True
    while epoch < cfg.num_epoch:
        # rank 0's clock decides for every rank
        out_of_time = bool(dist.agree(
            [bool(cfg.train_hours) and (time.time() - t_begin)
             > cfg.train_hours * 3600], mesh)[0])
        if out_of_time:
            if verbose:
                print(f"wall-clock budget ({cfg.train_hours}h) reached at "
                      f"epoch {epoch}")
            break
        t_start = time.time()
        last = None
        for bi in range(n_batches):
            if sparse_cache is not None:
                data, cost = sparse_cache[bi]
                chunk_data = data
            elif stacked is not None:
                data, cost = index_stack(stacked, cost_stack, bi, B)
                chunk_data = data
            else:
                # the whole batch, then this rank's rows: a sparse batch
                # keeps the batch's tile count and nse
                ids = train_ids[bi * cfg.batch_size:
                                (bi + 1) * cfg.batch_size]
                data = to_qp_batch(ds, ids, device=device)
                cost = None
                if cfg.scaling:
                    data, sc = scale(data)
                    cost = sc.cost
                chunk_data = (sparse_mod.from_dense(
                    data, fmt=cfg.sparse_format,
                    dtype=sparse_mod.tile_dtype(cfg.matvec_mode))
                    if cfg.sparse else data)
                if mesh is not None:
                    data, cost, chunk_data = (
                        dist.shard_batch(v, mesh)
                        for v in (data, cost, chunk_data))
            st = init_state(B, data.num_var, data.num_constr, hidden,
                            device=device)
            for ci in range(n_chunks):
                cancel_watchdog = (start_compile_watchdog("train chunk")
                                   if first_dispatch else None)
                st, loss = train_chunk(params, st, chunk_data,
                                       ci * cfg.truncated_length)
                if first_dispatch:
                    float(loss)   # the first chunk has run
                    cancel_watchdog()
                    first_dispatch = False
            last = (data, st, cost, loss)
        data, st, cost, loss = last
        if sparse_cache is not None:
            train_obj = sparse_mod.obj_fn_sparse(st.x, data)
        else:
            train_obj = metrics.obj_fn(st.x, data.Q, data.p)
        if cost is not None:
            train_obj = train_obj / cost
        train_obj = float(train_obj.mean())
        loss = float(loss)
        if mesh is not None:
            train_obj = float(dist.host_reduce([train_obj], mesh,
                                               op="mean")[0])
        t_train = time.time() - t_start

        t_v = time.time()
        val_obj, vios = val_fn(params, val_scaled, val_sc)
        vios = {k: float(v) for k, v in vios.items()}
        # rank 0's numbers decide the rollback and the early stop
        loss, train_obj, val_obj, *vals = (float(v) for v in dist.agree(
            [loss, train_obj, float(val_obj), *vios.values()], mesh))
        vios = dict(zip(vios, vals))
        t_val = time.time() - t_v
        vio_maxes = [v for k, v in vios.items() if k.endswith("_max")]

        # Loss-spike guard: an epoch loss above spike_rollback_factor x the
        # recent median restores the gated checkpoint's params and optimizer
        # state instead of riding the divergence.
        spiked = False
        if (cfg.spike_rollback_factor and history
                and best.get("params") is not None):
            ref_loss = float(np.median([h["train_loss"]
                                        for h in history[-5:]]))
            if np.isfinite(ref_loss) and (
                    not np.isfinite(loss)
                    or loss > cfg.spike_rollback_factor * abs(ref_loss)):
                spiked = True
                runlog.log("spike_rollback", epoch=epoch, loss=loss,
                           ref_loss=ref_loss)
                if lead:
                    print(f"Epoch {epoch}: loss spike {ref_loss:.2f} -> "
                          f"{loss:.2f}; rolling back to the gated "
                          f"checkpoint", flush=True)
                dist.sync_hosts("spike rollback")   # rank 0 has written
                _restore_(params, optimizer, ckpt.load_checkpoint(ckpt_path),
                          mesh)

        best["epoch"] = epoch
        early = False
        if not spiked:
            early = stopper.step(val_obj, cfg.early_stop_mode, cfg.eq_tol,
                                 vio_maxes)
        rec = dict(epoch=epoch, train_obj=train_obj, val_obj=val_obj,
                   train_loss=loss, train_time=t_train, val_time=t_val,
                   **({"rollback": True} if spiked else {}), **vios)
        history.append(rec)
        runlog.log("epoch", **rec)
        if verbose and epoch % cfg.log_every == 0:
            vio_str = " | ".join(f"{k}: {v:.4f}" for k, v in vios.items())
            print(f"Epoch {epoch} | Train_Obj {train_obj:.3f} | "
                  f"Val_Obj {val_obj:.3f} | Loss {loss:.4f} | "
                  f"Train_Time {t_train:.2f}s | Val_Time {t_val:.2f}s | "
                  f"{vio_str}")
        epochs_run = epoch + 1
        epoch += 1

        def save_latest():
            payload = {
                "params": full_params(),
                "opt_state": optimizer.state_arrays(),
                "epoch": epochs_run - 1,
                "best": ({"val_obj": stopper.best_loss,
                          "counter": stopper.counter}
                         if stopper.best_loss is not None else None),
                "config": cfg.to_dict()}
            try:
                save(latest_path, payload)
            except Exception as e:  # bookkeeping never ends the run
                print(f"latest-checkpoint save failed: {e!r}", flush=True)

        if epochs_run > start_epoch and (epoch - start_epoch) % 10 == 0:
            save_latest()
        if early:
            break

    if epochs_run > start_epoch:
        save_latest()

    final = best.get("params")
    final_params = {k: torch.as_tensor(v, device=device) for k, v in (
        final if final is not None else full_params()).items()}
    dist.sync_hosts("train end")   # rank 0's files are written
    return TrainResult(params=final_params, history=history,
                       best_val_obj=stopper.best_loss,
                       epochs_run=epochs_run,
                       checkpoint_path=ckpt_path if final is not None
                       else None)
