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
kernels of :mod:`iadmm_tpu_torch.kernels.train_rollout`.  Not ported: the
whole-epoch scan and the preloaded train stack (``epoch_scan`` and
``preload`` are accepted and the per-batch route runs), the TPU-worker crash
recovery, the sparse routes and the mesh paths (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import os
import time
from functools import partial
from typing import Dict, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..evaluation import metrics
from ..problems.generators import RawDataset
from ..problems.io import split_ids, to_qp_batch
from ..scaling import scale_batch
from ..solvers.rollouts import chunk_loss, rollout
from ..solvers.step import check_schedule_len, get_cell, make_lstm_step
from ..types import IterState, init_state
from ..utils.logging import RunLog
from . import checkpoint as ckpt
from .early_stopping import EarlyStopping


def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax's ``clip_by_global_norm``: every gradient becomes
    ``g / ‖g‖ · max_norm`` when the global norm ‖g‖ reaches ``max_norm``,
    and stays unchanged below it (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``)."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


class ClippedAdam:
    """Adam over a dict of parameter tensors, as the JAX package's optax
    chain computes it: global-norm clipping first (when
    ``clip_grad_norm > 0``), then L2 decay added to the gradient before the
    moments (``weight_decay``), then Adam with betas (0.9, 0.999) and
    eps 1e-8 outside the square root."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 weight_decay: float = 0.0, clip_grad_norm: float = 0.0):
        self.params = params
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
        if self.clip:
            clip_by_global_norm_([p.grad for p in self.params.values()],
                                 self.clip)
        self.adam.step()

    def state_arrays(self) -> Dict:
        """The moments and step count as numpy arrays (checkpoint form)."""
        out = {"exp_avg": {}, "exp_avg_sq": {}, "step": np.zeros((), np.int64)}
        for k, p in self.params.items():
            st = self.adam.state.get(p)
            if not st:
                continue
            out["exp_avg"][k] = ckpt.to_numpy(st["exp_avg"])
            out["exp_avg_sq"][k] = ckpt.to_numpy(st["exp_avg_sq"])
            out["step"] = np.asarray(int(st["step"]), np.int64)
        return out

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
                   weight_decay: float = 0.0,
                   clip_grad_norm: float = 0.0) -> ClippedAdam:
    """The training optimizer over ``params`` (see :class:`ClippedAdam`)."""
    return ClippedAdam(params, lr, weight_decay, clip_grad_norm)


def _detach(st: IterState) -> IterState:
    return IterState(*(getattr(st, f.name).detach()
                       for f in dataclasses.fields(IterState)))


def make_chunk_body(step_fn, optimizer: ClippedAdam, outer_T: int,
                    chunk_len: int, sigma: float, remat: bool = False,
                    loss_fn=None):
    """The TBPTT chunk update: ``body(params, state, data, t0) ->
    (state', loss)`` takes the gradient of the chunk loss with respect to
    ``params`` and updates them in place with one optimizer step.
    ``loss_fn(params, state, data, t0) -> (loss, state')`` replaces the
    chunk loss over ``step_fn`` (the fused training kernels)."""
    if loss_fn is None:
        def loss_fn(p, state, data, t0):
            return chunk_loss(step_fn, p, state, data, sigma, chunk_len,
                              outer_T, t0, remat=remat)

    def chunk_body(params, state: IterState, data, t0):
        optimizer.zero_grad()
        loss, new_state = loss_fn(params, _detach(state), data, t0)
        loss.backward()
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


def _load_params_(params: Dict[str, torch.Tensor], arrays: Dict) -> None:
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(torch.as_tensor(np.asarray(arrays[k])).to(p))


def _restore_(params, optimizer: ClippedAdam, payload: Dict) -> bool:
    """Load a checkpoint's params, and its optimizer state when it is the
    port's own; returns whether the optimizer state was loaded."""
    _load_params_(params, payload["params"])
    opt = payload.get("opt_state")
    if isinstance(opt, dict) and "exp_avg" in opt:
        optimizer.load_state_arrays(opt)
        return True
    return False


def train(cfg: ExperimentConfig, ds: RawDataset, verbose: bool = True,
          device="cuda") -> TrainResult:
    """End-to-end training of ``cfg`` on ``ds`` (see the module docstring)."""
    cfg.check_ported()
    runlog = RunLog(os.path.join(cfg.save_dir, cfg.model_name,
                                 cfg.run_name() + ".log.jsonl")
                    if cfg.save_dir else None)
    runlog.log("config", **cfg.to_dict())
    train_ids, val_ids, _ = split_ids(cfg.data_size, cfg.val_frac,
                                      cfg.test_frac, cfg.seed)
    cell = get_cell(cfg.model_name)
    params = cell.init(torch.Generator().manual_seed(cfg.seed),
                       cfg.input_dim, cfg.hidden_dim, cfg.outer_T,
                       device=device)
    for p in params.values():
        p.requires_grad_(True)
    optimizer = make_optimizer(params, cfg.lr, cfg.weight_decay,
                               cfg.clip_grad_norm)

    step_fn = cell.step
    if cfg.model_name == "lstm" and (cfg.use_pallas
                                     or cfg.matvec_mode != "highest"):
        step_fn = make_lstm_step(
            use_pallas=cfg.use_pallas, gate_dtype=cfg.gate_dtype,
            matvec_mode=None if cfg.matvec_mode == "highest"
            else cfg.matvec_mode)

    fused_loss = None
    if cfg.train_backend == "fused":
        if cfg.model_name != "lstm":
            raise ValueError("train_backend='fused' supports the lstm cell")
        from ..kernels.train_rollout import make_fused_chunk_loss
        fused_loss = make_fused_chunk_loss(
            num_var=ds.Q.shape[-1], num_constr=ds.A0.shape[-2],
            batch=cfg.batch_size, hidden=cfg.hidden_dim, sigma=cfg.sigma,
            chunk_len=cfg.truncated_length, outer_T=cfg.outer_T,
            K_total=cfg.outer_T,
            compute_dtype="bfloat16" if cfg.matvec_mode == "bf16"
            else "float32")

    train_chunk = make_train_chunk(step_fn, optimizer, cfg.outer_T,
                                   cfg.truncated_length, cfg.sigma,
                                   remat=cfg.remat, loss_fn=fused_loss)
    val_fn = make_val_fn(step_fn, cfg.outer_T, cfg.sigma, cfg.hidden_dim)
    scale = partial(scale_batch, iters=cfg.scaling_ites)

    val_scaled = to_qp_batch(ds, val_ids, device=device)
    val_sc = None
    if cfg.scaling:
        val_scaled, val_sc = scale(val_scaled)

    ckpt_path = ckpt.checkpoint_path(cfg.save_dir, cfg.model_name,
                                     cfg.run_name())
    latest_path = ckpt.latest_path(ckpt_path)
    best: Dict = {}

    start_epoch = 0
    resumed_best = None
    if cfg.resume:
        payload = None
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
        if payload is not None:
            with_opt = _restore_(params, optimizer, payload)
            start_epoch = int(payload.get("epoch", 0)) + 1
            resumed_best = payload.get("best")
            if verbose:
                print(f"resumed at epoch {start_epoch} (gated best epoch: "
                      f"{best_epoch}; optimizer state "
                      f"{'restored' if with_opt else 'fresh'})")
    check_schedule_len(params, cfg.outer_T)

    def save_best():
        best["params"] = ckpt.to_numpy(params)
        ckpt.save_checkpoint(ckpt_path, {
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

    t_begin = time.time()
    epoch = start_epoch
    while epoch < cfg.num_epoch:
        if cfg.train_hours and (time.time() - t_begin) > cfg.train_hours * 3600:
            if verbose:
                print(f"wall-clock budget ({cfg.train_hours}h) reached at "
                      f"epoch {epoch}")
            break
        t_start = time.time()
        last = None
        for bi in range(n_batches):
            ids = train_ids[bi * cfg.batch_size:(bi + 1) * cfg.batch_size]
            data = to_qp_batch(ds, ids, device=device)
            cost = None
            if cfg.scaling:
                data, sc = scale(data)
                cost = sc.cost
            st = init_state(cfg.batch_size, data.num_var, data.num_constr,
                            cfg.hidden_dim, device=device)
            for ci in range(n_chunks):
                st, loss = train_chunk(params, st, data,
                                       ci * cfg.truncated_length)
            last = (data, st, cost, loss)
        data, st, cost, loss = last
        train_obj = metrics.obj_fn(st.x, data.Q, data.p)
        if cost is not None:
            train_obj = train_obj / cost
        train_obj = float(train_obj.mean())
        loss = float(loss)
        t_train = time.time() - t_start

        t_v = time.time()
        val_obj, vios = val_fn(params, val_scaled, val_sc)
        val_obj = float(val_obj)
        t_val = time.time() - t_v
        vio_maxes = [float(v) for k, v in vios.items() if k.endswith("_max")]

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
                print(f"Epoch {epoch}: loss spike {ref_loss:.2f} -> "
                      f"{loss:.2f}; rolling back to the gated checkpoint",
                      flush=True)
                _restore_(params, optimizer, ckpt.load_checkpoint(ckpt_path))

        best["epoch"] = epoch
        early = False
        if not spiked:
            early = stopper.step(val_obj, cfg.early_stop_mode, cfg.eq_tol,
                                 vio_maxes)
        rec = dict(epoch=epoch, train_obj=train_obj, val_obj=val_obj,
                   train_loss=loss, train_time=t_train, val_time=t_val,
                   **({"rollback": True} if spiked else {}),
                   **{k: float(v) for k, v in vios.items()})
        history.append(rec)
        runlog.log("epoch", **rec)
        if verbose and epoch % cfg.log_every == 0:
            vio_str = " | ".join(f"{k}: {float(v):.4f}"
                                 for k, v in vios.items())
            print(f"Epoch {epoch} | Train_Obj {train_obj:.3f} | "
                  f"Val_Obj {val_obj:.3f} | Loss {loss:.4f} | "
                  f"Train_Time {t_train:.2f}s | Val_Time {t_val:.2f}s | "
                  f"{vio_str}")
        epochs_run = epoch + 1
        epoch += 1

        def save_latest():
            try:
                ckpt.save_checkpoint(latest_path, {
                    "params": ckpt.to_numpy(params),
                    "opt_state": optimizer.state_arrays(),
                    "epoch": epochs_run - 1,
                    "best": ({"val_obj": stopper.best_loss,
                              "counter": stopper.counter}
                             if stopper.best_loss is not None else None),
                    "config": cfg.to_dict()})
            except Exception as e:  # bookkeeping never ends the run
                print(f"latest-checkpoint save failed: {e!r}", flush=True)

        if epochs_run > start_epoch and (epoch - start_epoch) % 10 == 0:
            save_latest()
        if early:
            break

    if epochs_run > start_epoch:
        save_latest()

    final = best.get("params")
    final_params = ({k: torch.as_tensor(v, device=device)
                     for k, v in final.items()} if final is not None
                    else {k: v.detach() for k, v in params.items()})
    return TrainResult(params=final_params, history=history,
                       best_val_obj=stopper.best_loss,
                       epochs_run=epochs_run,
                       checkpoint_path=ckpt_path if final is not None
                       else None)
