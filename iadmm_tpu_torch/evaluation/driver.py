"""Test / inference driver: timed evaluation of the test split.

Counterpart of ``TestReport``, ``run_test`` and ``export_traces`` in
``iadmm_tpu/evaluation/driver.py``:

  * per batch: Ruiz scaling, ``test_outer_T`` learned iterations with
    per-iteration metrics in the original space, and, with ``feas_rest``,
    the Stage-II LU polish with its own traces.  Traces stay on the device
    and are fetched once per batch;
  * "Parallel Time" = (scaling + learned steps + Stage II) wall-clock
    summed over the batches, over the test size.  Each timed region ends
    in ``torch.cuda.synchronize()`` on the card; the first batch runs once
    untimed first (warm-up: kernel builds and library initialisation);
  * the dense route runs the step of ``cfg.model_name`` (for ``'lstm'``,
    the step of ``make_lstm_step``: the cell kernel with ``use_pallas``);
    ``sparse=True`` runs the sparse route
    (:mod:`iadmm_tpu_torch.kernels.sparse`, BSR tiles or BCOO entries by
    ``sparse_format``), whose conversion happens outside the timed region;
  * ``cfg.theory`` adds the theory-condition traces
    (:mod:`iadmm_tpu_torch.evaluation.theory`), untimed, on the dense
    route: a second rollout of the same step per batch;
  * ``export_traces`` writes the JAX package's keys, ``.mat`` (scipy) or
    ``.npz``;
  * ``run_osqp_baseline`` solves the test split with the QP oracle on the
    host (the classical-solver baseline).

Not ported: the multi-device mesh (see ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ExperimentConfig
from ..kernels import sparse as sparse_mod
from ..problems.generators import RawDataset
from ..problems.io import split_ids, to_qp_batch
from ..scaling import scale_batch
from ..solvers import rollouts as R
from ..solvers.step import (_schedules, check_schedule_len, get_cell,
                            make_lstm_step, rho_vector)
from ..types import init_state
from . import theory as theory_mod


def _sync(device) -> None:
    """Completion barrier of a timed region."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class TestReport:
    """Per-iteration traces averaged over the test batches, plus timing."""
    obj: np.ndarray          # (T,)
    ls_res: np.ndarray       # (T,)
    primal_res: np.ndarray   # (T,)
    dual_res: np.ndarray     # (T,)
    violations: Dict[str, np.ndarray]   # each (T,)
    stage2: Optional["TestReport"]
    total_time: float
    parallel_time: float     # total_time / test_size
    test_size: int
    x_final: np.ndarray      # (N, n) final unscaled iterates
    baseline: Optional[Dict] = None
    oracle_gap: Optional[Dict] = None  # vs stored ground-truth solutions
    theory: Optional[Dict] = None

    def table(self, every: int = 1) -> str:
        """Per-iteration report table."""
        lines = ["  t |       obj |    ls_res | primal_res |  dual_res | " +
                 " | ".join(f"{k:>9}" for k in sorted(self.violations))]
        T = len(self.obj)
        for t in range(0, T, every):
            lines.append(self.row(t))
        return "\n".join(lines)

    def row(self, t: int) -> str:
        """Row ``t`` of :meth:`table`."""
        vio = " | ".join(f"{self.violations[k][t]:9.4f}"
                         for k in sorted(self.violations))
        return (f"{t:3d} | {self.obj[t]:9.3f} | {self.ls_res[t]:9.4f} | "
                f"{self.primal_res[t]:10.4f} | {self.dual_res[t]:9.4f} | "
                f"{vio}")


def _trace_to_numpy(trace: R.EvalTrace) -> Dict[str, np.ndarray]:
    def host(t):
        return t.detach().cpu().numpy()
    return dict(obj=host(trace.obj), ls_res=host(trace.ls_res),
                primal_res=host(trace.primal_res),
                dual_res=host(trace.dual_res),
                violations={k: host(v) for k, v in trace.violations.items()})


def _device_params(params, device) -> Dict[str, torch.Tensor]:
    """A parameter dict (tensors or numpy arrays) as float32 tensors on
    ``device``; tensors keep their dtype."""
    return {k: (v.detach().to(device) if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.array(v), dtype=torch.float32,
                                     device=device))
            for k, v in params.items()}


@torch.no_grad()
def run_test(cfg: ExperimentConfig, ds: RawDataset, params,
             test_ids: Optional[np.ndarray] = None, verbose: bool = True,
             device="cuda") -> TestReport:
    """Batched timed evaluation over the test split (``test_ids``, by
    default the split of ``cfg``)."""
    cfg.check_ported()
    if test_ids is None:
        _, _, test_ids = split_ids(cfg.data_size, cfg.val_frac,
                                   cfg.test_frac, cfg.seed)
    params = _device_params(params, device)
    cell = get_cell(cfg.model_name)
    check_schedule_len(params, cfg.test_outer_T)
    step_fn = cell.step
    if cfg.model_name == "lstm" and (cfg.use_pallas
                                     or cfg.matvec_mode != "highest"):
        step_fn = make_lstm_step(
            use_pallas=cfg.use_pallas, gate_dtype=cfg.gate_dtype,
            matvec_mode=None if cfg.matvec_mode == "highest"
            else cfg.matvec_mode)
    sigma = cfg.sigma
    T = cfg.test_outer_T
    bs = cfg.test_batch_size
    n_batches = max(len(test_ids) // bs, 1)
    test_ids = test_ids[:n_batches * bs]
    scale = partial(scale_batch, iters=cfg.scaling_ites)

    def eval_batch(data_scaled, data_orig, scaling):
        st = init_state(data_orig.batch, data_orig.num_var,
                        data_orig.num_constr, cfg.hidden_dim, device=device)
        if cfg.sparse:
            return sparse_mod.eval_rollout_sparse(
                params, st, data_scaled, data_orig, scaling, sigma, T)
        return R.eval_rollout(step_fn, params, st, data_scaled, data_orig,
                              scaling, sigma, T)

    def prep(data_orig):
        """Scaled, and on the sparse route tiled, solver-path data.  The
        tiling is a storage-format step, outside the timed region."""
        if cfg.scaling:
            data_scaled, sc = scale(data_orig)
        else:
            data_scaled, sc = data_orig, None
        if cfg.sparse:
            data_scaled = sparse_mod.from_dense(
                data_scaled, fmt=cfg.sparse_format,
                dtype=sparse_mod.tile_dtype(cfg.matvec_mode))
        return data_scaled, sc

    def theory_batch(data_scaled, data_orig, scaling):
        st = init_state(data_orig.batch, data_orig.num_var,
                        data_orig.num_constr, cfg.hidden_dim, device=device)
        return theory_mod.theory_rollout(step_fn, params, st, data_scaled,
                                         data_orig, scaling, sigma, T)

    def stage2_batch(st, data_orig, scaling):
        # Stage II runs in the original space with the last learned rho
        # (or a fixed stage2_rho > 0).
        if cfg.stage2_rho > 0:
            rho_vec = rho_vector(torch.tensor(cfg.stage2_rho,
                                              dtype=torch.float32),
                                 data_orig.eq_mask)
        else:
            rho_vec, _ = _schedules(params, T - 1, data_orig.eq_mask)
        if scaling is not None:
            st = R.unscale_state(st, scaling)
        return R.eval_stage2(st, data_orig, data_orig, None, sigma, rho_vec,
                             cfg.feas_rest_num)

    # Warm-up on the first batch, untimed: the kernels build at their
    # first launch and the solver libraries initialise at their first call.
    warm = to_qp_batch(ds, test_ids[:bs], device=device)
    if verbose:
        print(f"run_test: warm-up batch (B={bs}, T={T}) ...", flush=True)
    w_scaled, w_sc = prep(warm)
    w_st, _ = eval_batch(w_scaled, warm, w_sc)
    if cfg.feas_rest:
        stage2_batch(w_st, warm, w_sc)
    _sync(device)
    if verbose:
        print(f"run_test: warm-up done; {n_batches} timed batches",
              flush=True)

    traces: List[Dict] = []
    s2_traces: List[Dict] = []
    theory_traces: List[Dict] = []
    xs: List[np.ndarray] = []
    total_time = 0.0
    s2_time = 0.0
    for bi in range(n_batches):
        ids = test_ids[bi * bs:(bi + 1) * bs]
        data_orig = to_qp_batch(ds, ids, device=device)
        _sync(device)  # the host-to-device copy stays out of the timing
        if cfg.sparse:
            data_sp, sc = prep(data_orig)  # format conversion untimed
            _sync(device)
            t0 = time.perf_counter()
            st, trace = eval_batch(data_sp, data_orig, sc)
        else:
            t0 = time.perf_counter()
            data_scaled, sc = prep(data_orig)
            st, trace = eval_batch(data_scaled, data_orig, sc)
        _sync(device)
        total_time += time.perf_counter() - t0
        if verbose:
            print(f"run_test: batch {bi + 1}/{n_batches} "
                  f"({total_time:.2f}s cumulative)", flush=True)
        traces.append(_trace_to_numpy(trace))
        if cfg.theory and not cfg.sparse:
            # diagnostics, untimed
            th = theory_batch(data_scaled, data_orig, sc)
            theory_traces.append({k: v.cpu().numpy() for k, v in th.items()})
        if cfg.feas_rest:
            # Stage II is inside the timed region: its wall-clock counts
            # toward total_time and is reported on its own as well.
            t1 = time.perf_counter()
            st2, tr2 = stage2_batch(st, data_orig, sc)
            _sync(device)
            dt = time.perf_counter() - t1
            s2_time += dt
            total_time += dt
            s2_traces.append(_trace_to_numpy(tr2))
            xs.append(st2.x.cpu().numpy())
        else:
            x = st.x if sc is None else sc.unscale_x(st.x)
            xs.append(x.cpu().numpy())

    def avg(stack: List[Dict]) -> Dict:
        out = {k: np.mean([t[k] for t in stack], axis=0)
               for k in ("obj", "ls_res", "primal_res", "dual_res")}
        out["violations"] = {k: np.mean([t["violations"][k] for t in stack],
                                        axis=0)
                             for k in stack[0]["violations"]}
        return out

    x_fin = np.concatenate(xs)
    oracle_gap = None
    if ds.x_opt is not None:
        oracle_gap = _oracle_gap(ds, test_ids, x_fin)

    stage2 = None
    if s2_traces:
        stage2 = TestReport(**avg(s2_traces), stage2=None,
                            total_time=s2_time,
                            parallel_time=s2_time / len(test_ids),
                            test_size=len(test_ids), x_final=x_fin)
    theory = None
    if theory_traces:
        # per-instance keys concatenate over the batches, (T, test size);
        # the rest average over them (t=0 is NaN in every batch)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            theory = {k: (np.concatenate([t[k] for t in theory_traces],
                                         axis=1)
                          if k in theory_mod.PER_INSTANCE_KEYS else
                          np.nanmean(np.stack([t[k] for t in theory_traces]),
                                     axis=0))
                      for k in theory_traces[0]}
    report = TestReport(**avg(traces), stage2=stage2, total_time=total_time,
                        parallel_time=total_time / len(test_ids),
                        test_size=len(test_ids), x_final=x_fin,
                        oracle_gap=oracle_gap, theory=theory)
    if verbose:
        print(report.table(every=max(T // 20, 1)))
        if oracle_gap is not None:
            print(f"Oracle gap: |x-x*| {oracle_gap['x_dist_mean']:.4f} | "
                  f"obj gap {oracle_gap['obj_gap_mean']:.4f} "
                  f"({oracle_gap['obj_gap_rel'] * 100:.2f}% rel)")
        print(f"Total Time {total_time:.4f}s | "
              f"Parallel Time {report.parallel_time:.6f}s/instance | "
              f"test size {len(test_ids)}")
        if stage2 is not None:
            print(f"--- Stage II (feasibility restoration) — "
                  f"{s2_time:.4f}s ({stage2.parallel_time:.6f}s/instance) ---")
            print(stage2.table())
    return report


def _oracle_gap(ds: RawDataset, idx: np.ndarray, x_fin: np.ndarray) -> Dict:
    """Final iterates against the stored ground-truth solutions."""
    x_star = ds.x_opt[idx]
    Q2 = (ds.Q[idx] if ds.Q.shape[0] > 1 else ds.Q).astype(np.float64) * 2.0
    Q2 = np.broadcast_to(Q2, (len(idx),) + Q2.shape[1:])
    p_ = ds.p[idx] if ds.p.shape[0] > 1 else ds.p

    def obj(x):
        return 0.5 * np.einsum("bi,bij,bj->b", x, Q2, x) \
            + np.einsum("bi,bi->b", np.broadcast_to(p_, x.shape), x)

    gap = np.abs(obj(x_fin) - obj(x_star))
    return dict(
        x_dist_mean=float(np.linalg.norm(x_fin - x_star, axis=-1).mean()),
        obj_gap_mean=float(gap.mean()),
        obj_gap_rel=float((gap / np.maximum(np.abs(obj(x_star)), 1e-9))
                          .mean()))


def export_traces(report: TestReport, path: str) -> None:
    """Save the full traces: ``.mat`` (scipy, the JAX package's keys) or
    anything else as ``.npz``.  The ``.mat`` file holds the
    theory-condition traces: the per-instance keys ``(T, test size)``, the
    rest as ``(1, T)`` rows, and every key of the schema the run did not
    produce as an empty ``(1, 0)`` array."""
    flat = dict(time=report.parallel_time, total_time=report.total_time,
                x=report.x_final, objs=report.obj, ls_res=report.ls_res,
                primal_res=report.primal_res, dual_res=report.dual_res)
    for k, v in report.violations.items():
        flat[f"vio_{k}"] = v
    if report.stage2 is not None:
        for k in ("obj", "ls_res", "primal_res", "dual_res"):
            flat[f"stage2_{k}"] = getattr(report.stage2, k)
    if path.endswith(".mat"):
        import scipy.io
        for k, v in (report.theory or {}).items():
            v = np.asarray(v)
            flat[k] = (v if k in theory_mod.PER_INSTANCE_KEYS
                       else v.reshape(1, -1))
        for base in ("x_cond_1", "x_cond_2", "z_cond_1", "z_cond_2",
                     "alpha_cond"):
            for side in ("left", "right"):
                flat.setdefault(f"{base}_{side}", np.zeros((1, 0)))
        scipy.io.savemat(path, flat)
    else:
        np.savez(path, **flat)


def run_osqp_baseline(cfg: ExperimentConfig, ds: RawDataset,
                      test_ids: Optional[np.ndarray] = None,
                      warm_start: bool = True, eps: float = 1e-4,
                      verbose: bool = True, backend: str = "auto") -> Dict:
    """Classical-solver baseline: solve each test instance with the
    OSQP-algorithm oracle on the host, reporting mean solve time, iteration
    count, solved count and mean objective (the JAX package's keys).

    ``backend='native'`` (the 'auto' default when the C++ library builds)
    runs the whole test set through the native OpenMP batch solver
    (``native/qp_oracle.cpp``), all host cores in one call; ``'python'``
    solves the instances one after another with :func:`solve_qp`, each
    warm-started from the previous solution when ``warm_start``."""
    from ..problems import oracle
    if test_ids is None:
        _, _, test_ids = split_ids(cfg.data_size, cfg.val_frac,
                                   cfg.test_frac, cfg.seed)
    if backend == "auto":
        from .. import native
        backend = "native" if native.available() else "python"
    if backend == "native":
        sub = ds.slice(np.asarray(test_ids))
        t0 = time.perf_counter()
        x, y, iters, status = oracle.solve_native(sub, eps)
        wall = time.perf_counter() - t0
        Q2 = 2.0 * (sub.Q if sub.Q.shape[0] > 1
                    else np.repeat(sub.Q, sub.size, 0))
        p_ = sub.p if sub.p.shape[0] > 1 else np.repeat(sub.p, sub.size, 0)
        objs = 0.5 * np.einsum("bi,bij,bj->b", x, Q2, x) \
            + np.einsum("bi,bi->b", p_, x)
        out = dict(mean_time=wall / sub.size,
                   mean_iters=float(np.mean(iters)),
                   solved=int((np.asarray(status) == 0).sum()),
                   total=int(sub.size), mean_obj=float(np.mean(objs)),
                   backend="native-openmp-batch")
        if verbose:
            print(f"OSQP-baseline (native batch): {out['solved']}/"
                  f"{out['total']} solved | mean {out['mean_iters']:.1f} "
                  f"iters | mean {out['mean_time'] * 1e3:.2f} ms/instance "
                  f"| mean obj {out['mean_obj']:.4f}")
        return out
    times, iters, objs, solved = [], [], [], 0
    x0 = y0 = None

    def sh(a, i):  # dim-1 leading axis = shared data (QP_RHS family)
        return a[i if a.shape[0] > 1 else 0]

    for i in test_ids:
        P = sh(ds.Q, i) * 2.0
        t0 = time.perf_counter()
        r = oracle.solve_qp(P, sh(ds.p, i), sh(ds.A0, i), ds.zl[i],
                            ds.zu[i], eps_abs=eps, eps_rel=eps,
                            x0=x0 if warm_start else None,
                            y0=y0 if warm_start else None)
        times.append(time.perf_counter() - t0)
        iters.append(r.iters)
        solved += int(r.solved)
        objs.append(0.5 * r.x @ P @ r.x + sh(ds.p, i) @ r.x)
        if warm_start:
            x0, y0 = r.x, r.y
    out = dict(mean_time=float(np.mean(times)), mean_iters=float(np.mean(iters)),
               solved=solved, total=len(test_ids), mean_obj=float(np.mean(objs)))
    if verbose:
        print(f"OSQP-baseline: {solved}/{len(test_ids)} solved | "
              f"mean {out['mean_iters']:.1f} iters | "
              f"mean {out['mean_time'] * 1e3:.2f} ms/instance | "
              f"mean obj {out['mean_obj']:.4f}")
    return out
