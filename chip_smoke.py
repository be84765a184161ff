#!/usr/bin/env python3
"""Drive the PyTorch port (``iadmm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``iadmm_tpu_torch/kernels/csrc`` (first use),
then runs eight phases at the flagship shape QP_1000_500_500 / h=800, two
at Sparse_QP_Large (n=4096, 1024 box rows, h=128, K=50), four at the
flagship's float32 precision profile (``configs/qp_1000_500_500.yaml``:
float32 gates, float32 matvecs), two on the segment-recompute training
route, which the shipped config takes from ``--batch_size 9``, one on
Stage II's condensed-system solvers, one on the canonical QP workload
of ``scripts/run_workload.py`` and three on the remaining single-device
routes (the ghost cells, the theory traces, the BCOO sparse route):

  (a) the cell kernel against its plain version (B=8, S=2000, h=800, bf16),
      on a ragged small case and on a ragged one at the flagship's width
      (B=2, S=1037, h=808), two calls bitwise equal, with the H·U TFLOP/s
      of the whole cell call beside torch.matmul of H·U alone;
  (b) the rollout kernel against its plain version (B=8): held to the
      plain version after K_CHECK=6 steps, and after K=100 to within
      MAX_GAP_OVER_ROUNDING times the gap between the plain version and
      itself with permuted hidden units (its own rounding, amplified by
      the untrained recurrence); timed at K=100, with its cell tile and
      cluster, a call's device µs by part (cell, colpass, finish, update)
      and busy share, beside K x torch.matmul of H·U in bf16 (the cell's
      GEMM alone, a yardstick the port never calls);
  (c) the Stage-II 'kkt' kernel against its plain version (B=8, N=20),
      timed beside N x torch.bmm of Ã⁻¹ by b̃;
  (d) serving: ``make_solver`` with the fast profile answers 3 requests of
      B=8 fresh instances (rollout_impl='fused', Stage II 'fused');
  (e) the same with rollout_impl='step', whose cell goes through the cell
      kernel;
  (f) the training kernels (forward and backward of a TBPTT chunk) against
      their plain versions at B=2: at J=6 the forward's outputs, the
      backward on the same streams and every gradient leaf end to end; at
      J=100 the backward on the same streams, tightly, and end to end each
      output and gradient leaf relative to that leaf's own rounding gap in
      the plain pair (the largest under three permutations of the hidden
      units); the backward twice, bitwise equal; timed at J=100; then the
      pair at J=6 on ragged shapes (B·S = 1174, h = 212 and 808), and the
      backward's GEMM cores alone (dH, dU at B=2 and 16): the bf16 core
      against the float32 product of its operands, the float32 FFMA core
      against the float64 product at F32_GEMM_TOL, each timed (TFLOP/s)
      beside torch.matmul in its dtype (TF32 off); the forward's device
      time by kernel and its busy share (device time over wall time); then
      [kkt pass], the KKT pass that every iteration runs, alone at n = m =
      1000 at B = 2, 8, 16 in bf16 and float32, with one and two
      right-hand sides: against its plain version, its device time beside
      one read of [Q; A0] from memory, its bound and torch.bmm;
  (g) training: ``harness.train`` with train_backend='fused' and the fast
      profile, 2 epochs on a generated QP_1000_500_500 dataset (16
      instances, B=2, J = outer_T = 100), then ``make_solver`` serves one
      B=8 request from the reloaded checkpoint;
  (h) one chunk update on each backend from the same params ('step' runs
      the cell kernel): times, and the loss and per-leaf gradient gaps
      between them, each held to a limit;
  (i) the BSR matvec kernel against its plain version on the scaled
      Sparse_QP_Large operands Q, A0, A0ᵀ at B=2 and B=10, bf16 and
      float32 (8, 128) tiles, and on a ragged (128, 128)-tile case: forward
      and backward to 1e-5 (bf16) or 1e-6 (float32) of max|ref|, two calls
      bitwise equal; its device time (launches queued behind a sleep, so
      the Python wrapper's cost is hidden), warm (back to back) and cold
      (each launch after an L2 flush), beside its bound, the plain version
      and ``torch.bmm`` of the densified bf16 matrix; then the grouped
      launch (``bsr_matvec_group``) on the step's first group (A0·u, A0ᵀ·ν,
      Q·u, u and ν sliced from one xv) at the same points and on the
      ragged case: one launch, each output bitwise the single-product
      kernel's and held to the plain version, two calls bitwise equal,
      timed (warm, cold, paced) beside its bound (the sum of its products')
      and the same products as three single launches;
  (j) ``harness.train`` on the BSR route (22 generated instances: 10
      train, 2 val, 10 test; 2 epochs at B=2, J = outer_T = 50,
      train_backend='step'), then ``run_test`` of the reloaded checkpoint
      on the BSR and the dense route at B=10 with Stage II, the traces held
      to the dense route at the BSR route's cell precision (the first 6
      steps to 1e-3; K=50 to 4x the dense route's own gap under a
      hidden-unit permutation, at least 4 float32 ulps) and to the dense
      profile, whose cell is the
      bf16-gate cell kernel (the first 6 steps to 1e-2); a profiled chunk
      update gives the device's busy share; the BSR launches are counted:
      three grouped launches a step forward and three backward (6·J − 1 a
      chunk: at step 0 only A0ᵀ·r2 and the residuals need a gradient), and
      three a step in each ``run_test`` rollout;
  (k) the float32-gate cell kernel against its plain version (B=8,
      S=2000, h=800, float32 and bf16 H/C, and a ragged small case): delta,
      H', C' to F32_CELL_TOL of max|ref| (a bf16 H'/C' to one bf16 ulp
      more), two calls bitwise equal; timed beside its bound, the plain
      version and ``torch.matmul`` of H·U in float32;
  (l) the float32 training kernels against their plain pair at B=2, as
      (f): at J=6 every output and gradient leaf to F32_LEAF_TOL of its
      max|ref|; at J=100 the backward on the plain streams to F32_LEAF_TOL
      per leaf, each leaf end to end within 4x its own permuted-plain gap,
      the backward twice bitwise equal; timed at J=100;
  (m) the shipped config through the CLIs: a 16-instance dataset written
      with ``save_npz``; ``cli.train`` on the step backend (the float32
      cell kernel), 2 epochs; ``cli.test --feas_rest`` on its checkpoint,
      the traces held to ``run_test`` with ``use_pallas=False`` (the plain
      float32 cell: the first 6 steps to F32_LEAF_TOL, K=100 to 4x the
      plain route's own gap under a permutation); ``cli.train
      --train_backend fused`` (the float32 training kernels), 1 epoch; then
      one chunk update on each backend from the same params, gated as (h);
  (n) serving at the float32 profile: ``make_solver(params,
      use_pallas=True, ...)`` with the default gate answers 3 requests of
      B=8 (the step route over the float32 cell kernel, Stage II
      'fused'), held to the LU Stage-II route as (d)/(e), or, where it is
      further from that, to the float64 LU polish of the same iterates
      within 4x the float32 LU route's own gap to it; the polish as in (d);
  (o) the segment training kernels at both profiles: over a J=6 chunk in
      segments of 1, 2 and 3 steps at B=2 and of 2 at B=16, bitwise equal to
      the stream pair (losses, final state, every gradient leaf, the start
      state's cotangents), the backward twice bitwise equal, and held to the
      plain segment pair at (f)/(l)'s limits; timed at J=100 in segments of
      2, at B=2 and B=16, beside the stream pair, with the segment
      forward's device time by kernel and busy share;
  (p) the shipped config through ``cli.train --train_backend fused
      --batch_size 16`` (40 generated instances: 32 train, 2 chunk
      updates), at its float32 profile and at the fast one: the run must
      report the segment route (stream=False, segment_len=2), launch only the
      segment kernels of the training pair, finish with finite losses and
      moved parameters; then one chunk update at B=16 on each route from the
      same params, bitwise equal, with each route's time and peak memory;
  (q) Stage II's 'direct' (explicit M⁻¹, refine 2) and 'cg' (Jacobi CG,
      100 iterations a step) kernels against their plain twins at the
      serving shape (B=8, N=20) from (b)'s rollout iterates: short runs
      ('direct': one polish step at refine 0 and at refine 2; 'cg': one
      step and three steps of 3 iterations, and one step of 10 at a
      tolerance, taken from the plain twin's residuals, that stops some
      instances inside it and not others) to 1e-4
      of max(1, max|ref|) per output, the 'cg' unmasked-iteration counts
      equal, and each one-step run's outputs to 1e-4 of the float32
      update of the kernel's own xt; the 'direct' y and dual residual,
      which carry ν = ρ(A0·xt − z) + y (ρ_eq = 1e3·ρ meets the rounding of
      xt and of A0·xt), are held instead to the float64 update of the
      kernel's xt within 4x the float32 update's own gap, and to 4x the
      twin's own gap under reorderings; at N=20 each output and trace within
      MAX_GAP_OVER_ROUNDING x the twin's own gap under three reorderings of
      the variables and the constraint rows (cond(M) ~ 2e5 amplifies
      float32 rounding), at least 4 float32 ulps; two calls bitwise equal;
      timed beside the operand (M⁻¹ / the diagonal), the twin, the bound
      and a cuBLAS yardstick ('cg': solvers/cg.py's plain-torch polish);
      then the public ``fused_stage2(solver='cg')`` on the same iterates,
      and ``make_solver`` with 'fused-direct' (held to the LU route at
      1e-4 + 1e-3·|LU| or, where further, to the float64 LU polish as (n))
      and with 'cg' (no Stage-II kernel; every instance below its first
      polish step's primal residual) answering 3 requests of B=8 each;
  (r) the canonical QP workload (``scripts/run_workload.py`` "QP": h=800,
      K = J = 100, B=2, bf16 gates, matvecs and preload) through the CLIs:
      ``cli.generate_data`` writes 24 instances labelled by the native
      oracle at 1e-4 (the phase fails on any other backend), one epoch of
      ``cli.train`` on each backend over the preloaded train stack
      (diagonal-Q storage on 'step', dense bf16 on 'fused'), ``cli.test
      --baseline osqp``; then the same epochs at ``--preload never``: the
      first-epoch loss of each route within CANON_LOSS_RTOL (bitwise on
      'fused' where the stack equals the per-batch scaled batches
      bitwise, which is reported); the labelling time, the host CPU, the
      stack's bytes and the budget, each epoch's seconds and peak device
      memory are printed;
  (s) the ghost cells (gru, safeguard_lstm, multi_layer_lstm, gd,
      indirect_lstm) at QP 1000/500/500, h=800, float32: for each, one
      epoch of ``harness.train`` (4 chunk updates of B=2 at J=100;
      multi_layer_lstm, 5 cells a step, at J=20), ``run_test`` at K=100,
      B=10, every loss and trace finite; the float32 K=6 rollout against
      the float64 one on the card (GHOST_F32_RTOL, or 4x the rollout's
      own gap under a hidden-unit permutation where that is larger), and
      two controls (GHOST_FAULTS) that must miss that limit;
  (t) ``cli.test --theory --export`` on (r)'s dataset and step checkpoint
      at the canonical bf16 profile (K=100): the exported traces' shapes,
      t=0 NaN and finiteness, the cell kernel launched for the evaluation
      and the theory rollouts, the theory rollout's iterates bitwise the
      evaluation rollout's, sigma_Q_max and sigma_AA_min against float64
      numpy with cond(A0ᵀA0) reported;
  (u) the BCOO route at ``scripts/run_workload.py``'s Sparse_QP (n=1000,
      500 box rows, h=400, K=100, B=2, test B=10, bf16 matvecs):
      ``cli.train`` (one epoch) and ``cli.test``, twice, bitwise equal,
      no kernel launched; ``run_test`` on the BSR route (float32 tiles:
      the first 6 steps to 1e-3, K=100 to 4x the BCOO route's own
      permuted gap; bf16 tiles: 1e-2); each BCOO matvec's device time
      beside the BSR kernel's; the device's busy share of a chunk update
      and of a test rollout.

Each phase prints its errors, tolerance, times and launch counts; any
failure exits non-zero.  Launch counters are zeroed just before each main
path and read just after it: (d) and (e) (serving), (g) (training), (j)'s
training and its ``run_test`` on the two routes (the sparse path), (m)'s
three CLI runs (the shipped config), (n) (float32 serving) and each of
(p)'s two CLI runs (the segment route), (q)'s ``fused_stage2(solver='cg')``
and its two ``make_solver`` runs (the condensed Stage II), (r)'s
generation, two preloaded epochs and ``cli.test`` (the canonical
workload), (t)'s ``cli.test --theory`` and (u)'s CLI runs.  The
second-to-last line is the per-kernel JSON, the last line ``{"ok": true,
"device": {...}}``.  Weights are random from a seed (no trained checkpoint
is in the repository).  Exits non-zero without a CUDA device.  Longer
output (ptxas reports, ``report.json``, the CLI's output) goes to
``chiprun_out/chip_smoke/``; the training runs' checkpoints and datasets go
to ``results/chip_smoke*/`` and are removed at the end.

Two checkouts can be held bitwise equal (a kernel change that must not
move a result): the bf16-gate cell at six shapes and the float32-gate
cell at five (the flagship shape with both state dtypes, ragged ones), the
serving rollout's (x, y, z) at B=8 (K=6 and K=100) and at B=2 on two
ragged shapes (S = 1037 with h = 808; h = 212), a J=6 bf16 training
forward at B=2, the float32 stream pair and segment
pair (segments of 2) at J=6 with every gradient and start-state
cotangent, the J=100 forward at B=2 at both profiles, one bf16 segment
call at B=16, (d)'s first request with its LU and pre-polish references,
a float32 ``make_solver`` solve, Stage II's three solvers at B=8, N=20
on the serving rollout's iterates ('kkt' also at refine 1, 'direct' also
at refine 0; 'cg' with its unmasked-iteration counts), and the BSR route
at Sparse_QP_Large (each single product and its VJP at B=2, bf16 and
float32 tiles, TM 8 and 128; a J=6 chunk loss with its final state and
every gradient; the (x, y, z) and traces of a K=6 ``eval_rollout_sparse``
at B=10), in one file per checkout (copy this script into an older
checkout first):

    python3 chip_smoke.py --snapshot a.pt
    python3 chip_smoke.py --compare a.pt b.pt

and the rows of PERF.md §6 (both profiles, with a chunk update and a
solve of each, the 'fused' solve by stage, the rollout's, the forward's
and each Stage-II solver's device breakdown and busy share, 'kkt' also on a row-major operand and 'cg' also with its
CUDA graph captured anew each call) timed on one card, the checkouts in
turns:

    python3 chip_smoke.py --time-rows a.json

(with row 8 and the BSR route: a Q product and the step's first group,
warm at B=2 and cold at B=10, from the profiler's kernel times, and
paced; a chunk update's ms, device ms by kernel, busy share and BSR
launches; ``run_test``'s Parallel Time and BSR launches), the serving
rollout alone (row 2, with a batch shape that changes from call to call)
and row 8 with the BSR route alone, the same way:

    python3 chip_smoke.py --time-rollout a.json
    python3 chip_smoke.py --time-bsr a.json
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
TRAIN_DIR = os.path.join(ROOT, "results", "chip_smoke")
SPARSE_DIR = os.path.join(ROOT, "results", "chip_smoke_sparse")
FLAGSHIP_DIR = os.path.join(ROOT, "results", "chip_smoke_flagship")
FLAGSHIP_CONFIG = os.path.join(ROOT, "configs", "qp_1000_500_500.yaml")

N_VAR, N_INEQ, N_EQ, HIDDEN, K_ITERS = 1000, 500, 500, 800, 100
SERVE_BATCH, POLISH_STEPS = 8, 20
SIGMA = 6e-6
K_CHECK = 6
MAX_POLISH_RATIO = 1e-2
MAX_GAP_OVER_ROUNDING = 4.0
TRAIN_BATCH, TRAIN_DATA, TRAIN_EPOCHS = 2, 16, 2
# The ragged cases of (a) and (f): M not a multiple of the cores' 128-row
# tile, h not a multiple of the bf16 cell's 32-unit tile (808: TMA-loaded
# H; 212: not a multiple of 8 either, so the core's producer threads load
# H and the dU operands)
RAGGED_S, RAGGED_H = 1037, 808
RAGGED_TRAIN = ((300, 150, 137, 212), (300, 150, 137, 808))  # n, mi, me, h
# The rollout's ragged shapes (B=2): S = 1037 with h = 808, and h = 212
ROLLOUT_RAGGED = ((537, 250, 250, RAGGED_H), (300, 150, 137, 212))
# The rollout's device time by part: CUDA kernel names holding these
ROLLOUT_PARTS = (("cell", ("rollout_cell_kernel", "bf16_kernel")),
                 ("colpass", ("colpass",)), ("finish", ("finish_kernel",)),
                 ("update", ("update_kernel",)))
MAX_LEAF_GAP = 2e-2   # per-leaf normalised gradient gap (JAX bf16 test)
MAX_LEAF_GAP_J100 = 2e-3   # the same, bwd on the same streams at J=100
                           # (<= 3.3e-4 measured on an H100)
MAX_LOSS_GAP = 1e-3   # step vs fused chunk loss (2.1e-5 measured on an H100)
MAX_STEP_GRAD_GAP = 0.1   # step vs fused, per leaf (<= 3.3% on an H100)
GRAD_KEYS = ("W", "U", "b", "W_h", "b_h", "rho", "alpha")
J100_LEAVES = ("pr", "dr", "x", "y", "z", "xv") + GRAD_KEYS
PERMUTATIONS = (3, 4, 5)   # seeds of the hidden-unit permutations (f)
# Sparse_QP_Large (scripts/run_workload.py): banded n=4096, 1024 box rows
SP_N, SP_MI, SP_H, SP_K = 4096, 1024, 128, 50
SP_TRAIN_B, SP_TEST_B, SP_DATA = 2, 10, 22   # 10 train, 2 val, 10 test
SP_TILE = (8, 128)
BSR_TOL_BF16, BSR_TOL_F32 = 1e-5, 1e-6   # of max|ref|, kernel vs plain
ROUTE_RTOL_6 = 1e-3     # BSR vs dense route, first K_CHECK steps
PROFILE_RTOL_6 = 1e-2   # BSR vs dense profile (bf16-gate cell kernel)
# Floor of the K=50 route gate: 4 float32 ulps of a trace's largest value.
# A hidden-unit permutation can leave a trace bit-for-bit the same (the
# dual residual on an H100), while two routes still differ there by an ulp.
ROUTE_FLOOR_K = MAX_GAP_OVER_ROUNDING * 2.0 ** -23
FLUSH_BYTES = 256 << 20   # read between cold launches: 5x the 50 MB L2
# The float32 profile (k)-(n): kernel vs plain, float32 sums in another
# order (of max|ref|)
F32_CELL_TOL = 1e-5
F32_LEAF_TOL = 1e-4
F32_GEMM_TOL = 1e-5   # the float32 GEMM core alone vs the float64 product
# (m): 16 instances; val and test fractions raised to 2 and 4 instances, as
# scripts/run_workload.py raises them for small datasets (the config's 0.01
# would leave no validation instance)
FLAGSHIP_DATA, FLAGSHIP_VAL, FLAGSHIP_TEST = 16, 2 / 16, 4 / 16
DEV = "cuda"


class PhaseError(RuntimeError):
    pass


def cuda_ms(fn, reps=3, warmup=1):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def warm_ms(fn, long_s=1.0):
    """(ms, timed calls) of a plain version: one warm-up call, then two
    timed calls, or one where the warm-up took longer than ``long_s``."""
    import torch
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = 1 if time.perf_counter() - t0 > long_s else 2
    return cuda_ms(fn, reps=reps, warmup=0), reps


def queued_ms(fn, reps=50, sleep_ms=50.0, flush=None):
    """Device ms per call of ``fn`` without its host launch cost: a sleep
    kernel holds the stream while the host queues ``reps`` calls behind
    it, so they run back to back on the device.  With ``flush``, each call
    follows a ``flush()`` (a read larger than the L2 cache, so ``fn`` finds
    its operands cold) and is timed alone between its own events.  Raises
    if the host took longer to queue them than the sleep lasted."""
    import torch

    def event():
        return torch.cuda.Event(enable_timing=True)
    fn()
    s, e = event(), event()
    torch.cuda.synchronize()
    s.record()
    torch.cuda._sleep(1_000_000)
    e.record()
    e.synchronize()
    cycles = int(1_000_000 * sleep_ms / s.elapsed_time(e))
    torch.cuda._sleep(cycles)
    t0 = time.perf_counter()
    if flush is None:
        pairs = [(s, e)]
        s.record()
        for _ in range(reps):
            fn()
        e.record()
    else:
        pairs = [(event(), event()) for _ in range(reps)]
        for a, b in pairs:
            flush()
            a.record()
            fn()
            b.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    pairs[-1][1].synchronize()
    if host_ms >= sleep_ms:
        raise PhaseError(f"queued_ms: queuing took {host_ms:.2f} ms, longer "
                         f"than the {sleep_ms} ms sleep")
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def compare(name, out, ref, atol, rtol):
    """(max |out − ref|, that over max |ref|); raises unless
    |out − ref| <= atol + rtol·|ref| everywhere."""
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape:
        raise PhaseError(f"{name}: shape {tuple(out.shape)} vs "
                         f"{tuple(ref.shape)}")
    if not bool(out.isfinite().all()):
        raise PhaseError(f"{name}: non-finite output")
    err = (out - ref).abs()
    max_abs = float(err.max())
    max_rel = max_abs / max(float(ref.abs().max()), 1e-30)
    worst = float((err - rtol * ref.abs()).max())
    if worst > atol:
        raise PhaseError(f"{name}: max_abs_err {max_abs:.3e} exceeds "
                         f"atol {atol:g} + rtol {rtol:g}·|ref|")
    return max_abs, max_rel


def say(tag, **kw):
    print(f"[{tag}] " + json.dumps(kw), flush=True)


def qp_batch(B, seed, n=N_VAR, mi=N_INEQ, me=N_EQ):
    from iadmm_tpu_torch.problems import generate, to_qp_batch
    ds = generate("QP", num_var=n, num_ineq=mi, num_eq=me, data_size=B,
                  seed=seed)
    return to_qp_batch(ds, device=DEV)


def cell_case(params, B, S, h, hc, g):
    """Weights, inputs and state of one cell case: the flagship weights
    (U x5: gates of order 1) at h=HIDDEN, else small random ones of width
    h (cut from the flagship's shapes where h is narrower)."""
    import torch
    from iadmm_tpu_torch.kernels import lstm_cell as lc
    if h == HIDDEN:
        p = dict(params)
        p["U"] = params["U"] * 5.0
    elif h < HIDDEN:
        p = {k: (0.05 * torch.randn(v.shape, generator=g)).cuda()
             for k, v in params.items()}
        p["U"] = p["U"][:h, :4 * h].contiguous()
        p["W"] = p["W"][:, :4 * h].contiguous()
        p["b"] = p["b"][:4 * h].contiguous()
        p["W_h"] = p["W_h"][:h].contiguous()
    else:
        shapes = dict(W=(2, 4 * h), U=(h, 4 * h), b=(4 * h,), W_h=(h, 1),
                      b_h=(1,))
        p = {k: (0.05 * torch.randn(v, generator=g)).cuda()
             for k, v in shapes.items()}
    x = torch.randn((B, S, 2), generator=g).cuda()
    H = (0.9 * torch.tanh(torch.randn((B, S, h), generator=g))).to(
        "cuda", hc)
    C = torch.randn((B, S, h), generator=g).to("cuda", hc)
    return [p[k] for k in lc.CELL_KEYS], x, H, C


def phase_cell(params, report):
    """(a): the bf16-gate cell kernel against its plain version: the
    serving shape, a small ragged case with a float32 state (the core's
    producer threads round H as they load it) and a ragged one at the
    flagship's width (M not a multiple of 128, h not one of 32); two calls
    bitwise equal; the H·U FLOPs over the whole cell call (U's re-laying,
    the epilogue and the delta pass included) beside torch.matmul of H·U
    alone."""
    import torch
    from iadmm_tpu_torch.kernels import bounds
    from iadmm_tpu_torch.kernels import lstm_cell as lc
    g = torch.Generator().manual_seed(11)
    for B, S, h, hc in ((SERVE_BATCH, N_VAR + N_INEQ + N_EQ, HIDDEN,
                         torch.bfloat16),
                        (2, 37, 20, torch.float32),
                        (2, RAGGED_S, RAGGED_H, torch.bfloat16)):
        keys, x, H, C = cell_case(params, B, S, h, hc, g)
        keys = [k.to(torch.bfloat16) if i in (0, 1, 3) else k
                for i, k in enumerate(keys)]
        before = lc.fused_lstm_cell.launches
        out = lc.cell_forward(*keys, x, H, C, "bfloat16")
        torch.cuda.synchronize()
        if lc.fused_lstm_cell.launches != before + 1:
            raise PhaseError("cell: wrapper did not launch the kernel")
        ref = lc.cell_plain(*keys, x, H, C, "bfloat16")
        errs = [compare("cell delta", out[0], ref[0], 1e-3, 1e-2),
                compare("cell H'", out[1], ref[1], 1e-5, 2 ** -7),
                compare("cell C'", out[2], ref[2], 1e-5, 2 ** -7)]
        max_abs = max(e[0] for e in errs)
        max_rel = max(e[1] for e in errs)
        again = lc.cell_forward(*keys, x, H, C, "bfloat16")
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise PhaseError("cell: two calls gave different outputs")
        k_ms = cuda_ms(lambda: lc.cell_forward(*keys, x, H, C, "bfloat16"),
                       reps=10)
        p_ms = cuda_ms(lambda: lc.cell_plain(*keys, x, H, C, "bfloat16"),
                       reps=3)
        M = B * S
        b_ms, b_by = bounds.cell(M, h, "bfloat16", H.element_size())
        flop = 2.0 * M * h * 4 * h
        row = dict(shape=dict(B=B, S=S, h=h, state=str(hc)),
                   max_abs_err=max_abs, max_rel_err=max_rel,
                   tol="delta: 1e-3 + 1e-2|ref|; H', C': 1e-5 + 2^-7|ref| "
                       "(2 bf16 ulps)",
                   bitwise_repeat=True,
                   kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                   bound_by=b_by, launches=1,
                   cell_tflops=flop / k_ms / 1e9)
        if S >= RAGGED_S:
            U = keys[1]
            H2 = H.reshape(M, h).to(torch.bfloat16)
            row["library_ms"] = cuda_ms(lambda: torch.matmul(H2, U),
                                        reps=10)
            row["library_tflops"] = flop / row["library_ms"] / 1e9
            row["library_note"] = ("torch.matmul of the H·U GEMM alone "
                                   "(bf16): a yardstick of the GEMM, not "
                                   "of the cell")
        if h == HIDDEN:
            report["cell"] = row
        say("a cell", **row)


def phase_cell_f32(params, report):
    """(k): the float32-gate cell kernel against its plain version, at the
    flagship shape with float32 and with bf16 H/C, and a ragged case."""
    import torch
    from iadmm_tpu_torch.kernels import bounds
    from iadmm_tpu_torch.kernels import lstm_cell as lc
    g = torch.Generator().manual_seed(13)
    S0 = N_VAR + N_INEQ + N_EQ
    rows = []
    for B, S, h, hc in ((SERVE_BATCH, S0, HIDDEN, torch.float32),
                        (SERVE_BATCH, S0, HIDDEN, torch.bfloat16),
                        (2, 37, 20, torch.float32)):
        keys, x, H, C = cell_case(params, B, S, h, hc, g)

        def kernel():
            return lc.cell_forward(*keys, x, H, C, "float32")

        before = lc.fused_lstm_cell.launches_f32
        out = kernel()
        torch.cuda.synchronize()
        if lc.fused_lstm_cell.launches_f32 != before + 1:
            raise PhaseError("k cell: wrapper did not launch the kernel")
        ref = lc.cell_plain(*keys, x, H, C, "float32")
        # a bf16 H'/C' may round the same float32 value the other way
        ulp = 2 ** -7 if hc == torch.bfloat16 else 0.0
        errs = [compare(f"k cell {nm}", a, b,
                        F32_CELL_TOL * float(b.float().abs().max()),
                        ulp if nm != "delta" else 0.0)
                for nm, a, b in zip(("delta", "H'", "C'"), out, ref)]
        if not all(torch.equal(a, b) for a, b in zip(out, kernel())):
            raise PhaseError("k cell: two calls gave different outputs")
        M = B * S
        b_ms, b_by = bounds.cell(M, h, "float32", H.element_size())
        row = dict(shape=dict(B=B, S=S, h=h, state=str(hc)),
                   max_abs_err=max(e[0] for e in errs),
                   max_rel_err=max(e[1] for e in errs),
                   tol=(f"delta, H', C': {F32_CELL_TOL:g}·max|ref| (+ "
                        f"2^-7|ref|, one bf16 ulp, on a bf16 H'/C')"),
                   bitwise_repeat=True, bound_ms=b_ms, bound_by=b_by,
                   launches=1)
        if h == HIDDEN:
            H2 = H.reshape(M, h).float()
            row.update(
                kernel_ms=cuda_ms(kernel, reps=10),
                plain_ms=cuda_ms(lambda: lc.cell_plain(*keys, x, H, C,
                                                       "float32"), reps=3),
                library_ms=cuda_ms(lambda: torch.matmul(H2, keys[1]),
                                   reps=10),
                library_note=("torch.matmul of the H·U GEMM alone in "
                              "float32, TF32 off: a yardstick of the GEMM, "
                              "not of the cell"))
        say("k cell float32", **row)
        rows.append(row)
    report["cell_f32"] = dict(rows[0], cases=rows)


def permute_hidden(params, perm):
    """The same network with its hidden units reordered by ``perm``: its
    outputs are equal in exact arithmetic; only float32 sums over the
    hidden units run in another order."""
    import torch
    h = len(perm)
    cols = torch.cat([g * h + perm
                      for g in range(params["W"].shape[1] // h)])
    return dict(params, W=params["W"][:, cols],
                U=params["U"][perm][:, cols], b=params["b"][cols],
                W_h=params["W_h"][perm])


def rel_gap(outs, refs):
    """max over outputs of max |out − ref| / max |ref|."""
    return max(float((a - b).abs().max()) / float(b.abs().max())
               for a, b in zip(outs, refs))


def phase_rollout(params, data, report):
    import torch
    from iadmm_tpu_torch.kernels import _build
    from iadmm_tpu_torch.kernels import rollout_kernel as rk
    from iadmm_tpu_torch.kernels.bounds import bound_ms
    from iadmm_tpu_torch.scaling import scale_batch
    scaled, sc = scale_batch(data)
    # Over K_ITERS the untrained recurrence amplifies rounding, so the
    # tight check is at K_CHECK and the one at K_ITERS is relative to the
    # plain version's own rounding gap (permute_hidden).
    before = rk.fused_rollout.launches
    out = rk.fused_rollout(params, scaled, hidden=HIDDEN, K=K_CHECK,
                           sigma=SIGMA)
    torch.cuda.synchronize()
    if rk.fused_rollout.launches != before + K_CHECK:
        raise PhaseError("rollout: wrapper did not launch K iterations")
    ref = rk.rollout_plain(params, scaled, hidden=HIDDEN, K=K_CHECK,
                           sigma=SIGMA)
    errs = [compare(f"rollout {nm}", a, b, 1e-2 * float(b.abs().max()),
                    2e-2) for nm, a, b in zip("xyz", out, ref)]
    xyz = rk.fused_rollout(params, scaled, hidden=HIDDEN, K=K_ITERS,
                           sigma=SIGMA)
    ref_k = rk.rollout_plain(params, scaled, hidden=HIDDEN, K=K_ITERS,
                             sigma=SIGMA)
    perm = torch.randperm(HIDDEN, generator=torch.Generator().manual_seed(3))
    ref_perm = rk.rollout_plain(permute_hidden(params, perm.cuda()), scaled,
                                hidden=HIDDEN, K=K_ITERS, sigma=SIGMA)
    gap_k, plain_gap_k = rel_gap(xyz, ref_k), rel_gap(ref_perm, ref_k)
    if gap_k > MAX_GAP_OVER_ROUNDING * plain_gap_k:
        raise PhaseError(f"rollout: gap {gap_k:.3e} after {K_ITERS} steps "
                         f"exceeds {MAX_GAP_OVER_ROUNDING}x the plain "
                         f"version's own rounding gap {plain_gap_k:.3e}")
    k_ms = cuda_ms(lambda: rk.fused_rollout(params, scaled, hidden=HIDDEN,
                                            K=K_ITERS, sigma=SIGMA), reps=2)
    p_ms = cuda_ms(lambda: rk.rollout_plain(params, scaled, hidden=HIDDEN,
                                            K=K_ITERS, sigma=SIGMA),
                   reps=1, warmup=0)
    B, n = data.p.shape
    m = data.num_constr
    S, h, K = n + m, HIDDEN, K_ITERS
    # where a call's device time goes, and the device's busy share
    parts = rollout_breakdown(lambda: rk.fused_rollout(
        params, scaled, hidden=HIDDEN, K=K_ITERS, sigma=SIGMA))
    # yardstick: K x torch.matmul of H·U in bf16, the cell's GEMM alone
    Hb = torch.rand((B * S, h), generator=torch.Generator().manual_seed(9))
    Hb, Ub = Hb.to(DEV, torch.bfloat16), params["U"].to(torch.bfloat16)
    lib_ms = cuda_ms(lambda: [torch.matmul(Hb, Ub) for _ in range(K)],
                     reps=2)
    del Hb
    nbytes = (B * (n * n + m * n) * 2 + B * (n + 3 * m) * 4
              + (2 * 4 * h + h * 4 * h + h) * 2 + 4 * h * 4 + 2 * K * 4
              + B * (n + 2 * m) * 4)
    b_ms, b_by = bound_ms(
        nbytes, bf16_ops=K * (2.0 * B * S * h * 4 * h
                              + 4.0 * B * (n * n + 2 * m * n)),
        f32_ops=K * B * S * (2.0 * 2 * 4 * h + 20.0 * h))
    row = dict(shape=dict(B=B, n=n, m=m, h=h, K=K),
               max_abs_err=max(e[0] for e in errs),
               max_rel_err=max(e[1] for e in errs),
               checked_at_K=K_CHECK,
               tol="1e-2·max|ref| + 2e-2|ref| per output after K_CHECK "
                   "steps (bf16 operands, other summation order)",
               rel_gap_at_K100=gap_k,
               plain_vs_permuted_plain_rel_gap_at_K100=plain_gap_k,
               kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
               launches=K, library_ms=lib_ms,
               library_note="yardstick: K x torch.matmul of H·U (bf16), the "
                            "cell's GEMM alone; the port never calls it",
               instance_iters_per_s=B * K / (k_ms / 1e3),
               cell_tile=dict(rows=_build.CELL_BM, units=_build.ROLLOUT_HB,
                              gate_columns=4 * _build.ROLLOUT_HB,
                              ctas="persistent, one an SM",
                              cluster_ctas=_build.ROLLOUT_CLUSTER,
                              cluster="neighbouring row bands; each Ut "
                                      "stage by one TMA multicast"),
               device_us_by_part=parts["device_us_by_part"],
               cell_us_per_iteration=parts["device_us_by_part"]["cell"] / K,
               device_ms=parts["device_ms"], wall_ms=parts["wall_ms"],
               busy_share=parts["busy_share"])
    say("b rollout", **row)
    report["rollout"] = row
    return scaled, sc, xyz


def phase_stage2(params, data, sc, xyz, report):
    import torch
    from iadmm_tpu_torch.kernels import bounds, stage2_kernel as s2
    from iadmm_tpu_torch.solvers.step import _schedules
    from iadmm_tpu_torch.types import IterState
    x, y, z = xyz
    B, n = data.p.shape
    m = data.num_constr
    N = POLISH_STEPS
    st = IterState(x=sc.unscale_x(x), y=sc.unscale_y(y),
                   z=sc.unscale_z(z), xv=torch.cat([x, y], -1),
                   H=x.new_zeros((B, 1, 1)), C=x.new_zeros((B, 1, 1)))
    rho_vec, _ = _schedules(params, K_ITERS - 1, data.eq_mask)
    rho = rho_vec.float() * torch.ones_like(data.zl)
    Ainv = s2.kkt_inverse(data, rho, SIGMA)
    # timed after that first call, which also initialises the solver library
    inv_ms = cuda_ms(lambda: s2.kkt_inverse(data, rho, SIGMA), reps=1,
                     warmup=0)
    before = s2.fused_stage2.launches
    out = s2.stage2_cuda(st, data, rho, Ainv, num_iters=N, sigma=SIGMA,
                          refine=0)
    torch.cuda.synchronize()
    if s2.fused_stage2.launches != before + N:
        raise PhaseError("stage2: wrapper did not launch N steps")
    ref = s2.stage2_plain(st, data, rho, Ainv, num_iters=N, sigma=SIGMA,
                          refine=0)
    errs = [compare(f"stage2 {nm}", a, b,
                    1e-3 * max(1.0, float(b.abs().max())), 1e-3)
            for nm, a, b in zip(("x", "y", "z", "xt", "pr", "dr"), out, ref)]
    k_ms = cuda_ms(lambda: s2.stage2_cuda(st, data, rho, Ainv, num_iters=N,
                                           sigma=SIGMA, refine=0), reps=3)
    p_ms = cuda_ms(lambda: s2.stage2_plain(st, data, rho, Ainv, num_iters=N,
                                           sigma=SIGMA, refine=0), reps=3)
    # yardstick: the N solves alone on cuBLAS, Ã⁻¹·b̃ with b̃ of the first
    # step (each polish step's product; the kernel also forms b̃, the
    # update and the residuals)
    bt = torch.cat([SIGMA * st.x - data.p, st.z - st.y / rho], dim=-1)
    lib_ms = cuda_ms(lambda: [torch.bmm(Ainv, bt[..., None])
                              for _ in range(N)], reps=3)
    b_ms, b_by = bounds.stage2(B, N, n, m, "kkt")
    row = dict(shape=dict(B=B, n=n, m=m, N=N),
               max_abs_err=max(e[0] for e in errs),
               max_rel_err=max(e[1] for e in errs),
               tol="1e-3·max(1, max|ref|) + 1e-3|ref| per output (float32, "
                   "other summation order)",
               tf32="torch.backends.cuda.matmul.allow_tf32=False, "
                    "torch.backends.cudnn.allow_tf32=False",
               kernel_ms=k_ms, plain_ms=p_ms, inverse_ms=inv_ms,
               bound_ms=b_ms, bound_by=b_by, launches=N, library_ms=lib_ms,
               library_note="yardstick: N x torch.bmm of Ã⁻¹ by b̃ "
                            "(float32), the solves alone",
               final_primal_res=[float(v) for v in out[4][:, -1]])
    say("c stage2", **row)
    report["stage2"] = row


def _counted():
    """{name: (wrapper, attribute)} of every launch counter."""
    from iadmm_tpu_torch.kernels import lstm_cell, rollout_kernel, \
        sparse_matvec, stage2_kernel, train_rollout as tr
    cell = lstm_cell.fused_lstm_cell
    return dict(cell=(cell, "launches"), cell_f32=(cell, "launches_f32"),
                rollout=(rollout_kernel.fused_rollout, "launches"),
                stage2=(stage2_kernel.fused_stage2, "launches"),
                stage2_direct=(stage2_kernel.fused_stage2, "launches_direct"),
                stage2_cg=(stage2_kernel.fused_stage2, "launches_cg"),
                train_fwd=(tr.train_fwd_cuda, "launches"),
                train_fwd_f32=(tr.train_fwd_cuda, "launches_f32"),
                train_bwd=(tr.train_bwd_cuda, "launches"),
                train_bwd_f32=(tr.train_bwd_cuda, "launches_f32"),
                bsr=(sparse_matvec.bsr_matvec, "launches"),
                train_fwd_seg=(tr.train_fwd_seg_cuda, "launches"),
                train_fwd_seg_f32=(tr.train_fwd_seg_cuda, "launches_f32"),
                train_bwd_seg=(tr.train_bwd_seg_cuda, "launches"),
                train_bwd_seg_f32=(tr.train_bwd_seg_cuda, "launches_f32"))


def zero_counts():
    """Every kernel's launch count to 0, just before a main path."""
    for fn, attr in _counted().values():
        setattr(fn, attr, 0)


def launch_counts():
    """{kernel: launches since zero_counts()}."""
    return {k: getattr(fn, attr) for k, (fn, attr) in _counted().items()}


def data_as(data, dtype):
    """``data`` with its floating-point tensors in ``dtype``."""
    import dataclasses
    import torch
    return dataclasses.replace(data, **{
        f.name: v.to(dtype) for f in dataclasses.fields(data)
        if isinstance(v := getattr(data, f.name), torch.Tensor)
        and v.is_floating_point()})


def lu64_polish(params, data, start):
    """Primal residuals after the LU Stage II in float64 from the float32
    pipeline's pre-polish iterates ``start`` (a SolveResult)."""
    import dataclasses
    import torch
    from iadmm_tpu_torch.evaluation import metrics
    from iadmm_tpu_torch.solvers.exact import feasibility_restoration
    from iadmm_tpu_torch.solvers.step import _schedules
    from iadmm_tpu_torch.types import IterState
    f64 = torch.float64
    d64 = data_as(data, f64)
    rho, _ = _schedules(params, K_ITERS - 1, data.eq_mask)
    x, y, z = (getattr(start, k).to(f64) for k in "xyz")
    st = IterState(x=x, y=y, z=z, xv=torch.cat([x, y], -1),
                   H=x.new_zeros((data.batch, 1, 1)),
                   C=x.new_zeros((data.batch, 1, 1)))
    st = feasibility_restoration(st, d64, SIGMA, rho.to(f64), POLISH_STEPS)
    pr, _ = metrics.primal_dual_residual(st.x, st.y, st.z, d64.Q, d64.p,
                                         d64.A0, "default")
    return pr


def phase_serve(tag, params, requests, report, need, lu64=False,
                rtol=1e-2, forbid=(), **profile):
    """Answer the requests with ``make_solver(params, **profile)`` (the
    flagship's K, h and polish steps); check each residual against the
    'lu' Stage-II route and the polish against no polish.  ``need``: the
    kernels the route must launch; ``forbid``: those it must not.  ``lu64``:
    where the fused Stage II is more than 1e-4 + rtol·|LU| from the float32
    LU route, hold it instead to the float64 LU polish from the same
    iterates, within MAX_GAP_OVER_ROUNDING x the float32 LU route's own gap
    to it, + 1e-2·|LU64| (both float32 routes' errors grow with the
    pre-polish iterates and the conditioning of the KKT matrix)."""
    import torch
    from iadmm_tpu_torch.api import make_solver
    kw = dict(hidden_dim=HIDDEN, num_iters=K_ITERS,
              feas_rest_num=POLISH_STEPS, **profile)
    solve = make_solver(params, **kw)
    zero_counts()   # main path: counted from 0
    times, prs = [], []
    for data in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(data)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        for f in ("x", "y", "z", "primal_res", "dual_res", "obj"):
            if not bool(getattr(res, f).isfinite().all()):
                raise PhaseError(f"{tag}: non-finite {f}")
        prs.append(res.primal_res)
    delta = launch_counts()
    # References on request 0: the same pipeline with the LU Stage II
    # (torch.linalg), and without Stage II.
    lu = make_solver(params, **dict(kw, stage2_impl="lu"))(requests[0])
    kw0 = dict(kw, feas_rest_num=0)
    start = make_solver(params, **kw0)(requests[0])
    pr_before = start.primal_res
    pr_fused = prs[0]
    pr_lu = lu.primal_res
    gap = float(((pr_fused - pr_lu).abs() - rtol * pr_lu.abs()).max())
    ratio = float((pr_fused / pr_before).max())
    gap64 = None
    if lu64:
        pr64 = lu64_polish(params, requests[0], start)
        own = (pr_lu.double() - pr64).abs()
        gap64 = float(((pr_fused.double() - pr64).abs()
                       - MAX_GAP_OVER_ROUNDING * own
                       - 1e-2 * pr64.abs()).max())
    row = dict(profile={k: v for k, v in profile.items() if k != "sigma"},
               batch=int(requests[0].batch), ms_per_solve=times,
               launches={k: v for k, v in delta.items() if v},
               final_primal_res_max=float(torch.stack(prs).max()),
               primal_res_req0=[float(v) for v in pr_fused],
               primal_res_req0_lu=[float(v) for v in pr_lu],
               primal_res_req0_before_stage2=[float(v) for v in pr_before],
               max_ratio_after_over_before=ratio,
               **{f"gap_to_lu_minus_{rtol:g}_rel": gap})
    if lu64:
        row.update(primal_res_req0_lu_float64=[float(v) for v in pr64],
                   gap_to_lu64_minus_own_and_1e2_rel=gap64)
    say(tag, **row)
    for k in need:
        if delta[k] <= 0:
            raise PhaseError(f"{tag}: the {k} kernel was not launched")
    for k in forbid:
        if delta[k]:
            raise PhaseError(f"{tag}: the {k} kernel was launched")
    if gap > 1e-4 and not (lu64 and gap64 <= 1e-4):
        raise PhaseError(f"{tag}: primal residual differs from the LU "
                         f"route by more than 1e-4 + {rtol:g}·|LU|")
    # Threshold: the polish steps must bring every instance's primal
    # residual below MAX_POLISH_RATIO of the learned rollout's own (weights
    # are untrained, so no absolute level is meaningful).
    if not ratio < MAX_POLISH_RATIO:
        raise PhaseError(f"{tag}: Stage II left a primal residual above "
                         f"{MAX_POLISH_RATIO:g} of the rollout's own "
                         f"(max ratio {ratio:.3e})")
    report[tag] = row
    return delta


def serve_breakdown(params, data, solver="kkt"):
    """Host-clock time of each stage of the fused serving route with the
    Stage-II ``solver``: 'kkt' or 'direct' (operand, then kernel) or 'cg'
    (``make_solver('cg')``'s plain-torch polish)."""
    import torch
    from iadmm_tpu_torch.evaluation import metrics
    from iadmm_tpu_torch.kernels import rollout_kernel as rk, \
        stage2_kernel as s2
    from iadmm_tpu_torch.scaling import scale_batch
    from iadmm_tpu_torch.solvers.cg import feasibility_restoration_cg
    from iadmm_tpu_torch.solvers.step import _schedules
    from iadmm_tpu_torch.types import IterState
    t = {}

    def mark(name, t0):
        torch.cuda.synchronize()
        t[name] = (time.perf_counter() - t0) * 1e3
        return time.perf_counter()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scaled, sc = scale_batch(data)
    t0 = mark("ruiz_ms", t0)
    x, y, z = rk.fused_rollout(params, scaled, hidden=HIDDEN, K=K_ITERS,
                               sigma=SIGMA)
    t0 = mark("rollout_ms", t0)
    B = data.batch
    st = IterState(x=sc.unscale_x(x), y=sc.unscale_y(y), z=sc.unscale_z(z),
                   xv=torch.cat([x, y], -1), H=x.new_zeros((B, 1, 1)),
                   C=x.new_zeros((B, 1, 1)))
    rho_vec, _ = _schedules(params, K_ITERS - 1, data.eq_mask)
    rho = rho_vec.float() * torch.ones_like(data.zl)
    if solver == "cg":
        st = feasibility_restoration_cg(st, data, SIGMA, rho_vec,
                                        POLISH_STEPS)
        t0 = mark("stage2_cg_plain_torch_ms", t0)
        out = (st.x, st.y, st.z)
    else:
        form, run, refine = ((s2.kkt_inverse, s2.stage2_cuda, 0)
                             if solver == "kkt" else
                             (s2.direct_inverse, s2.stage2_direct_cuda, 2))
        op = form(data, rho, SIGMA)
        t0 = mark(f"{solver}_inverse_ms", t0)
        out = run(st, data, rho, op, num_iters=POLISH_STEPS, sigma=SIGMA,
                  refine=refine)
        t0 = mark("stage2_kernel_ms", t0)
        s2.finish_state(st, data, rho, *out[:4])
    metrics.primal_dual_residual(out[0], out[1], out[2], data.Q, data.p,
                                 data.A0, "default")
    mark("finish_and_metrics_ms", t0)
    say(f"{'d' if solver == 'kkt' else 'q'} breakdown {solver}", batch=B,
        **t)
    return t


def small_reference_check():
    """The serving slice on the card against the same slice on the CPU
    (the plain paths the CPU tests hold against the JAX package)."""
    import torch
    from iadmm_tpu_torch.api import make_solver
    from iadmm_tpu_torch.problems import generate, to_qp_batch
    from iadmm_tpu_torch.solvers.cells import lstm_init
    ds = generate("QP", num_var=20, num_ineq=10, num_eq=10, data_size=2,
                  seed=5)
    p_cpu = lstm_init(torch.Generator().manual_seed(4), 2, 16, 6,
                      device="cpu")
    p_gpu = {k: v.cuda() for k, v in p_cpu.items()}
    errs = {}
    for impl in ("fused", "step"):
        kw = dict(hidden_dim=16, num_iters=6, feas_rest_num=10,
                  use_pallas=True, gate_dtype="bfloat16",
                  matvec_mode="bf16", rollout_impl=impl)
        g = make_solver(p_gpu, stage2_impl="fused", **kw)(
            to_qp_batch(ds, device="cuda"))
        c = make_solver(p_cpu, stage2_impl="fused", **kw)(
            to_qp_batch(ds, device="cpu"))
        errs[impl] = max(
            compare(f"small {impl} {f}", getattr(g, f).cpu(),
                    getattr(c, f), 2e-2, 2e-2)[0]
            for f in ("x", "y", "z", "primal_res", "dual_res", "obj"))
    say("d0 small reference", max_abs_err=errs, tol="2e-2 + 2e-2|ref|")


def leaf_gaps(outs, refs):
    """max |out − ref| / max |ref| of each pair (shapes of ref)."""
    return [float((a.reshape(b.shape).float() - b.float()).abs().max())
            / max(float(b.abs().max()), 1e-30) for a, b in zip(outs, refs)]


def train_inputs(params, data, h=HIDDEN):
    """(weights, start state, data) tuples of the training kernels for a
    chunk from the zero state, as the harness starts each batch."""
    import torch
    from iadmm_tpu_torch.solvers.step import rho_vector
    from iadmm_tpu_torch.types import init_state
    st = init_state(data.batch, data.num_var, data.num_constr, h,
                    device=DEV)
    state = (st.x, st.y, st.z, st.xv, st.H, st.C)
    dd = (data.Q, data.A0, data.p, data.zl, data.zu,
          rho_vector(1.0, data.eq_mask).to(torch.float32))
    return tuple(params[k] for k in GRAD_KEYS), state, dd


def unpermute_grads(grads, perm):
    import torch
    h = len(perm)
    inv = torch.argsort(perm)
    icols = torch.argsort(torch.cat([g * h + perm for g in range(4)]))
    dW, dU, db, dWh, dbh, drho, dalpha = grads
    return (dW[:, icols], dU[inv][:, icols], db[icols], dWh[inv], dbh, drho,
            dalpha)


def device_time_by_kernel(fn, top=12):
    """({CUDA kernel name: device ms} of the ``top`` kernels, largest first
    (the breakdown of PERF.md §5), device ms summed over every kernel) of
    one call of ``fn`` under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    agg = {}   # names cut to 60 characters can collide: sum them
    for ev in prof.key_averages():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and ev.device_time_total):
            row = agg.setdefault(ev.key[:60], dict(ms=0.0, calls=0))
            row["ms"] += ev.device_time_total / 1e3
            row["calls"] += ev.count
    rows = sorted(agg.items(), key=lambda kv: -kv[1]["ms"])
    return dict(rows[:top]), sum(r["ms"] for r in agg.values())


def busy_share(fn, top=12):
    """One call of ``fn`` on the device: {device ms by CUDA kernel (the
    ``top`` largest), device ms of all kernels, host wall ms of a call
    ending in a synchronize (timed apart from the profiled one), busy
    share = device ms / wall ms}."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    by_kernel, device = device_time_by_kernel(fn, top)
    return dict(device_ms_by_kernel=by_kernel, device_ms=device,
                wall_ms=wall, busy_share=device / wall)


def rollout_breakdown(fn):
    """busy_share of one rollout call, with its device µs summed by part
    (ROLLOUT_PARTS: the cell GEMM, the KKT colpasses, the finish and update
    kernels; "other": U's re-laying, the state's zeroing)."""
    b = busy_share(fn, top=64)
    parts = dict.fromkeys([p for p, _ in ROLLOUT_PARTS] + ["other"], 0.0)
    for name, row in b["device_ms_by_kernel"].items():
        part = next((p for p, keys in ROLLOUT_PARTS
                     if any(k in name for k in keys)), "other")
        parts[part] += row["ms"] * 1e3
    b["device_us_by_part"] = parts
    return b


# The training kernels' phases: (f) the fast profile, (l) the float32 one.
# fwd: (atol over max|ref|, rtol) of each forward output at J=6; leaf: each
# gradient leaf's gap at J=6; leaf_j100: the backward on the plain streams
# at J=100, per leaf.  f64: the J=6 limits of (l) widen to
# MAX_GAP_OVER_ROUNDING x the plain pair's own gap to its float64 run where
# that is larger: y copies ν (y' = ν + ρ(z − zl) on the equality rows), and
# the KKT feature that moves ν subtracts terms scaled by 1/ρ and ρ_eq, so a
# float32 summation order shows there at the 1e-4 level after 6 steps.
TRAIN_PROFILES = {
    "bfloat16": dict(tag="f train kernels", key="train_kernels",
                     fwd=(1e-2, 2e-2), leaf=MAX_LEAF_GAP,
                     leaf_j100=MAX_LEAF_GAP_J100, f64=False),
    "float32": dict(tag="l train kernels float32", key="train_kernels_f32",
                    fwd=(F32_LEAF_TOL, 0.0), leaf=F32_LEAF_TOL,
                    leaf_j100=F32_LEAF_TOL, f64=True),
}
FWD_OUTPUTS = ("pr", "dr", "x", "y", "z", "xv", "H", "C")


def phase_train_kernels(params, data, report, cdt="bfloat16"):
    """(f), (l): the training kernels against their plain versions at
    compute dtype ``cdt``."""
    import torch
    from iadmm_tpu_torch.kernels import bounds
    from iadmm_tpu_torch.kernels import train_rollout as tr
    prof = TRAIN_PROFILES[cdt]
    counter = "launches" if cdt == "bfloat16" else "launches_f32"
    weights, state, dd = train_inputs(params, data)
    B, n = data.p.shape
    m = data.num_constr
    S, h, M = n + m, HIDDEN, B * (n + m)
    torch.cuda.reset_peak_memory_stats()

    def run(fwd, bwd, w, J, st=state, data=dd):
        kw = dict(t0=0, J=J, sigma=SIGMA, compute_dtype=cdt)
        pr, dr, final, streams = fwd(w, st, data, **kw)
        d = torch.full((B, J), 1.0 / (B * K_ITERS), device=DEV,
                       dtype=pr.dtype)
        grads, _ = bwd(w, data, streams, tuple(torch.zeros_like(f)
                                               for f in final), d, d, **kw)
        return pr, dr, final, streams, grads, d

    kernel = (tr.train_fwd_cuda, tr.train_bwd_cuda)
    plain = (tr.train_fwd_plain, tr.train_bwd_plain)
    # J = K_CHECK: the forward outputs; every gradient leaf, from the
    # backward kernel on the plain forward's streams and end to end
    J = K_CHECK
    f0 = getattr(tr.train_fwd_cuda, counter)
    b0 = getattr(tr.train_bwd_cuda, counter)
    kpr, kdr, kfin, kstr, kg, d = run(*kernel, weights, J)
    torch.cuda.synchronize()
    if (getattr(tr.train_fwd_cuda, counter) != f0 + J
            or getattr(tr.train_bwd_cuda, counter) != b0 + J):
        raise PhaseError(f"{prof['tag']}: the wrappers did not launch J "
                         f"steps")
    ppr, pdr, pfin, pstr, pg, _ = run(*plain, weights, J)
    fa, fr = prof["fwd"]
    own64 = dict(fwd=[0.0] * len(FWD_OUTPUTS), grads=[0.0] * len(GRAD_KEYS))
    if prof["f64"]:   # the plain pair's own float32 error, against float64
        f64 = torch.float64
        qpr, qdr, qfin, _, qg, _ = run(
            *plain, tuple(t.to(f64) for t in weights), J,
            tuple(t.to(f64) for t in state), tuple(t.to(f64) for t in dd))
        own64 = dict(fwd=leaf_gaps((ppr, pdr, *pfin), (qpr, qdr, *qfin)),
                     grads=leaf_gaps(pg, qg))
        del qfin, qg
    errs = [compare(f"train fwd {nm}", a, b, max(
                fa, MAX_GAP_OVER_ROUNDING * own) * float(b.abs().max()), fr)
            for nm, a, b, own in zip(FWD_OUTPUTS, (kpr, kdr, *kfin),
                                     (ppr, pdr, *pfin), own64["fwd"])]
    kw = dict(t0=0, J=J, sigma=SIGMA, compute_dtype=cdt)
    zero = tuple(torch.zeros_like(f) for f in kfin)
    ks_g, _ = tr.train_bwd_cuda(weights, dd, pstr, zero, d, d, **kw)
    same = leaf_gaps(ks_g, pg)
    e2e = leaf_gaps(kg, pg)
    for k, gap in zip(GRAD_KEYS, same):
        if not gap <= prof["leaf"]:
            raise PhaseError(f"train bwd on the plain streams: grad[{k}] gap "
                             f"{gap:.3e} > {prof['leaf']}")
    for k, gap, own in zip(GRAD_KEYS, e2e, own64["grads"]):
        lim = max(prof["leaf"], MAX_GAP_OVER_ROUNDING * own)
        if not gap <= lim:
            raise PhaseError(f"train bwd end to end: grad[{k}] gap "
                             f"{gap:.3e} > {lim:.3e}")
    del kstr, pstr
    grad_abs = max(float((a.reshape(b.shape) - b).abs().max())
                   for a, b in zip(kg, pg))
    # J = K_ITERS: each output and gradient leaf relative to that leaf's own
    # rounding gap in the plain pair.  That gap differs from one summation
    # order to the next (by up to 5x on the losses at J=100), so the
    # yardstick of a leaf is its largest gap under PERMUTATIONS orders.
    J = K_ITERS
    kw = dict(t0=0, J=J, sigma=SIGMA, compute_dtype=cdt)
    kpr, kdr, kfin, kstr, kg, d = run(*kernel, weights, J)
    ppr, pdr, pfin, pstr, pg, _ = run(*plain, weights, J)
    zero = tuple(torch.zeros_like(f) for f in kfin)
    # On the same streams the reverse sweep stays tight over J=100 steps:
    # no forward runs in between to amplify rounding.
    ks_g, _ = tr.train_bwd_cuda(weights, dd, pstr, zero, d, d, **kw)
    same_j = leaf_gaps(ks_g, pg)
    del pstr, ks_g
    for k, gap in zip(GRAD_KEYS, same_j):
        if not gap <= prof["leaf_j100"]:
            raise PhaseError(f"train bwd on the plain streams, J={J}: "
                             f"grad[{k}] gap {gap:.3e} > "
                             f"{prof['leaf_j100']}")
    ref_out = (ppr, pdr, *pfin[:4], *pg)
    gap_k = leaf_gaps((kpr, kdr, *kfin[:4], *kg), ref_out)
    gap_p = [0.0] * len(gap_k)
    for seed in PERMUTATIONS:
        perm = torch.randperm(HIDDEN,
                              generator=torch.Generator().manual_seed(seed))
        pw = tuple(permute_hidden(params, perm.to(DEV))[k]
                   for k in GRAD_KEYS)
        qpr, qdr, qfin, _, qg, _ = run(*plain, pw, J)
        qg = unpermute_grads(qg, perm.to(DEV))
        gap_p = [max(a, b) for a, b in zip(
            gap_p, leaf_gaps((qpr, qdr, *qfin[:4], *qg), ref_out))]
        del qfin, qg
    for k, gk, gp in zip(J100_LEAVES, gap_k, gap_p):
        if not gk <= MAX_GAP_OVER_ROUNDING * gp:
            raise PhaseError(f"train: {k} gap {gk:.3e} after {J} steps "
                             f"exceeds {MAX_GAP_OVER_ROUNDING}x the plain "
                             f"pair's own rounding gap {gp:.3e}")
    again, _ = tr.train_bwd_cuda(weights, dd, kstr, zero, d, d, **kw)
    if not all(torch.equal(a, b) for a, b in zip(kg, again)):
        raise PhaseError("train bwd: two runs gave different gradients")
    del pfin
    fwd_ms = cuda_ms(lambda: tr.train_fwd_cuda(weights, state, dd, **kw),
                     reps=2)
    bwd_ms = cuda_ms(lambda: tr.train_bwd_cuda(weights, dd, kstr, zero, d, d,
                                               **kw), reps=2)
    fwd_plain_ms, fwd_plain_reps = warm_ms(
        lambda: tr.train_fwd_plain(weights, state, dd, **kw))
    pstr = tr.train_fwd_plain(weights, state, dd, **kw)[3]
    bwd_plain_ms, bwd_plain_reps = warm_ms(
        lambda: tr.train_bwd_plain(weights, dd, pstr, zero, d, d, **kw))
    del pstr
    breakdown, _ = device_time_by_kernel(
        lambda: tr.train_bwd_cuda(weights, dd, kstr, zero, d, d, **kw))
    fwd_busy = busy_share(lambda: tr.train_fwd_cuda(weights, state, dd,
                                                    **kw))
    # library yardsticks: one step's GEMMs in the compute dtype, J times
    wdt = kstr[0].dtype
    Hk = kstr[0][0].reshape(M, h)
    Uc = params["U"].to(wdt)
    dpre = torch.randn((M, 4 * h), device=DEV).to(wdt)
    lib_fwd = cuda_ms(lambda: torch.matmul(Hk, Uc), reps=10)
    lib_step = cuda_ms(lambda: (torch.matmul(Hk, Uc),
                                torch.matmul(dpre, Uc.T),
                                torch.matmul(Hk.T, dpre)), reps=10)
    peak = torch.cuda.max_memory_allocated()
    fb, fby = bounds.train_fwd(B, J, n, m, h, K_ITERS, cdt)
    bb, bby = bounds.train_bwd(B, J, n, m, h, K_ITERS, cdt)
    row = dict(shape=dict(B=B, n=n, m=m, h=h, J_check=K_CHECK, J=J),
               compute_dtype=cdt,
               max_abs_err_fwd=max(e[0] for e in errs),
               max_rel_err_fwd=max(e[1] for e in errs),
               max_abs_err_grad=grad_abs,
               tol=(f"fwd: {fa:g}·max|ref| + {fr:g}|ref| per output at J=6; "
                    f"grads at J=6: per-leaf max|Δ|/max|ref| <= "
                    f"{prof['leaf']:g}, bwd on the plain streams and end to "
                    f"end" + (f" (at J=6 the fwd and end-to-end limits "
                              f"widen to {MAX_GAP_OVER_ROUNDING:g}x the plain "
                              f"pair's own gap to its float64 run where "
                              f"larger)" if prof["f64"] else "")
                    + f"; J=100: bwd on the plain streams per leaf <= "
                    f"{prof['leaf_j100']:g}, and per leaf (losses, final x, "
                    f"y, z, xv, each gradient) gap <= 4x that leaf's largest "
                    f"plain-pair gap under {len(PERMUTATIONS)} hidden-unit "
                    f"permutations"),
               fwd_rel_gap=dict(zip(FWD_OUTPUTS, (e[1] for e in errs))),
               grad_gap_same_streams=dict(zip(GRAD_KEYS, same)),
               grad_gap_end_to_end=dict(zip(GRAD_KEYS, e2e)),
               **({} if not prof["f64"] else dict(
                   plain_vs_float64_fwd_gap=dict(zip(FWD_OUTPUTS,
                                                     own64["fwd"])),
                   plain_vs_float64_grad_gap=dict(zip(GRAD_KEYS,
                                                      own64["grads"])))),
               grad_gap_same_streams_at_J100=dict(zip(GRAD_KEYS, same_j)),
               rel_gap_at_J100=dict(zip(J100_LEAVES, gap_k)),
               plain_vs_permuted_plain_rel_gap_at_J100=dict(
                   zip(J100_LEAVES, gap_p)),
               bitwise_repeat=True,
               fwd_ms=fwd_ms, bwd_ms=bwd_ms, fwd_plain_ms=fwd_plain_ms,
               bwd_plain_ms=bwd_plain_ms,
               plain_timing=(f"1 warm-up, then {fwd_plain_reps} (fwd) / "
                             f"{bwd_plain_reps} (bwd) timed calls"),
               fwd_bound_ms=fb, fwd_bound_by=fby,
               bwd_bound_ms=bb, bwd_bound_by=bby,
               fwd_library_ms=J * lib_fwd, bwd_library_ms=J * lib_step,
               library_note=(f"J x torch.matmul in {cdt} (TF32 off) of one "
                             f"step's GEMMs: H_k·U (fwd); H_k·U, dpre·Uᵀ, "
                             f"H_kᵀ·dpre (bwd): a yardstick of the GEMMs, "
                             f"not of the kernels"),
               max_memory_allocated_bytes=peak,
               bwd_device_ms_by_kernel=breakdown,
               fwd_device_ms_by_kernel=fwd_busy["device_ms_by_kernel"],
               fwd_device_ms=fwd_busy["device_ms"],
               fwd_wall_ms=fwd_busy["wall_ms"],
               fwd_busy_share=fwd_busy["busy_share"])
    say(prof["tag"], **row)
    report[prof["key"]] = row


def phase_train_ragged(report):
    """(f): the bf16 training pair on ragged shapes (RAGGED_TRAIN: B·S not
    a multiple of 128, h not one of 32) at J=K_CHECK against its plain
    pair, with (f)'s J=6 limits: each forward output, every gradient leaf
    from the backward on the plain streams, and end to end (a leaf that is
    a cancelling sum, b_h, may instead be within 2x the gap the plain
    backward shows on the kernel's streams, as tests/test_torch_cuda.py
    holds it); the backward twice, bitwise equal."""
    import torch
    from iadmm_tpu_torch.kernels import train_rollout as tr
    from iadmm_tpu_torch.scaling import scale_batch
    from iadmm_tpu_torch.solvers.cells import lstm_init
    rows = []
    for n, mi, me, h in RAGGED_TRAIN:
        data, _ = scale_batch(qp_batch(TRAIN_BATCH, seed=7, n=n, mi=mi,
                                       me=me))
        p = lstm_init(torch.Generator().manual_seed(h), 2, h, K_CHECK,
                      device=DEV)
        weights, state, dd = train_inputs(p, data, h)
        B, J = TRAIN_BATCH, K_CHECK
        kw = dict(t0=0, J=J, sigma=SIGMA, compute_dtype="bfloat16")
        kpr, kdr, kfin, kstr = tr.train_fwd_cuda(weights, state, dd, **kw)
        ppr, pdr, pfin, pstr = tr.train_fwd_plain(weights, state, dd, **kw)
        errs = [compare(f"ragged train fwd {nm}", a, b,
                        1e-2 * float(b.abs().max()), 2e-2)
                for nm, a, b in zip(FWD_OUTPUTS, (kpr, kdr, *kfin),
                                    (ppr, pdr, *pfin))]
        d = torch.full((B, J), 1.0 / (B * K_ITERS), device=DEV)
        zero = tuple(torch.zeros_like(f) for f in kfin)
        kg, _ = tr.train_bwd_cuda(weights, dd, kstr, zero, d, d, **kw)
        again, _ = tr.train_bwd_cuda(weights, dd, kstr, zero, d, d, **kw)
        if not all(torch.equal(a, b) for a, b in zip(kg, again)):
            raise PhaseError("ragged train bwd: two runs gave different "
                             "gradients")
        ks_g, _ = tr.train_bwd_cuda(weights, dd, pstr, zero, d, d, **kw)
        pg, _ = tr.train_bwd_plain(weights, dd, pstr, zero, d, d, **kw)
        own, _ = tr.train_bwd_plain(weights, dd, kstr, zero, d, d, **kw)
        same, e2e = leaf_gaps(ks_g, pg), leaf_gaps(kg, pg)
        own_gap = leaf_gaps(own, pg)
        for k, gs, ge, go in zip(GRAD_KEYS, same, e2e, own_gap):
            if not gs <= MAX_LEAF_GAP:
                raise PhaseError(f"ragged train bwd on the plain streams "
                                 f"(h={h}): grad[{k}] gap {gs:.3e} > "
                                 f"{MAX_LEAF_GAP}")
            if not (ge <= MAX_LEAF_GAP or ge <= 2 * go):
                raise PhaseError(f"ragged train bwd end to end (h={h}): "
                                 f"grad[{k}] gap {ge:.3e} > {MAX_LEAF_GAP} "
                                 f"and > 2x {go:.3e}")
        rows.append(dict(shape=dict(B=B, n=n, m=mi + me, h=h, J=J,
                                    M=B * (n + mi + me)),
                         max_abs_err_fwd=max(e[0] for e in errs),
                         fwd_rel_gap=dict(zip(FWD_OUTPUTS,
                                              (e[1] for e in errs))),
                         grad_gap_same_streams=dict(zip(GRAD_KEYS, same)),
                         grad_gap_end_to_end=dict(zip(GRAD_KEYS, e2e)),
                         plain_bwd_on_kernel_streams_gap=dict(
                             zip(GRAD_KEYS, own_gap)),
                         bitwise_repeat=True))
        del kstr, pstr
    row = dict(cases=rows,
               tol=f"fwd 1e-2·max|ref| + 2e-2|ref|; grads per leaf "
                   f"max|Δ|/max|ref| <= {MAX_LEAF_GAP:g} (end to end: or "
                   f"<= 2x the plain backward's gap on the kernel's "
                   f"streams)")
    say("f train kernels ragged", **row)
    report["train_kernels_ragged"] = row


def phase_gemm_cores(report):
    """(f): the backward's GEMM cores alone at its flagship shapes (B·S =
    4,000 and 32,000 rows, h = 800), dH = dpre·Uᵀ and dU += H_kᵀ·dpre,
    each core's achieved TFLOP/s beside torch.matmul of the same operands:
    the bf16 core (``train_rollout.bf16_gemm``) against the float32 product
    of the same bf16 operands (1e-4 of max|ref|: the same exact products
    summed in another order); the float32 FFMA core
    (``train_rollout.f32_gemm``, dH from the transposed copies dpreᵀ and Uᵀ
    the float32 backward keeps) against the float64 product of the same
    operands (F32_GEMM_TOL of max|ref|: float32 sums over K = 4h or B·S),
    beside torch.matmul at float32 with TF32 off."""
    import torch
    from iadmm_tpu_torch.kernels import train_rollout as tr
    h, S = HIDDEN, N_VAR + N_INEQ + N_EQ
    rows = {}
    for B in (TRAIN_BATCH, SEG_BATCH):
        M = B * S
        flop = 2.0 * M * h * 4 * h
        for dt in (torch.bfloat16, torch.float32):
            g = torch.Generator().manual_seed(B)
            dpre = torch.randn((M, 4 * h), generator=g).to(DEV, dt)
            U = (0.05 * torch.randn((h, 4 * h), generator=g)).to(DEV, dt)
            H = torch.tanh(torch.randn((M, h), generator=g)).to(DEV, dt)
            dH = torch.empty((M, h), device=DEV)
            dU = torch.zeros((h, 4 * h), device=DEV)
            if dt == torch.bfloat16:
                tol, ref_dt, name = 1e-4, torch.float32, f"B{B}"

                def fdH():
                    tr.bf16_gemm(dpre, U, dH, a_col=False, b_col=True,
                                 accumulate=False)
            else:
                tol, ref_dt, name = F32_GEMM_TOL, torch.float64, f"B{B}_f32"
                dpreT, UT = dpre.T.contiguous(), U.T.contiguous()

                def fdH():
                    tr.f32_gemm(dpreT, UT, dH, a_col=True, b_col=False,
                                accumulate=False)

            def fdU():
                (tr.bf16_gemm if dt == torch.bfloat16 else tr.f32_gemm)(
                    H, dpre, dU, a_col=True, b_col=False, accumulate=True)
            fdH()
            fdU()
            refH = dpre.to(ref_dt) @ U.to(ref_dt).T
            eH = compare(f"gemm dH {dt}", dH, refH,
                         tol * float(refH.abs().max()), 0.0)
            del refH
            refU = H.to(ref_dt).T @ dpre.to(ref_dt)
            eU = compare(f"gemm dU {dt}", dU, refU,
                         tol * float(refU.abs().max()), 0.0)
            del refU
            ms = dict(
                dH=cuda_ms(fdH, reps=10), dU=cuda_ms(fdU, reps=10),
                dH_matmul=cuda_ms(lambda: torch.matmul(dpre, U.T), reps=10),
                dU_matmul=cuda_ms(lambda: torch.matmul(H.T, dpre), reps=10))
            rows[name] = dict(
                shape=dict(M=M, h=h, K_dH=4 * h, K_dU=M), dtype=str(dt),
                tol=f"{tol:g}·max|ref|", max_rel_err=dict(dH=eH[1],
                                                          dU=eU[1]),
                ms=ms, tflops={k: flop / v / 1e9 for k, v in ms.items()})
            del dpre, U, H, dH, dU
            if dt == torch.float32:
                del dpreT, UT
            torch.cuda.empty_cache()
    say("f gemm cores", **rows)
    report["gemm_cores"] = rows


# The KKT pass alone: the (dtype, B) points of its predictions (PERF.md)
KKT_POINTS = (("bfloat16", 2), ("bfloat16", 8), ("bfloat16", 16),
              ("float32", 2), ("float32", 8), ("float32", 16))
KKT_TOL = 1e-5   # of max|ref|: float32 sums in another order


def phase_kkt_pass(report):
    """[kkt pass]: the KKT pass every iteration runs (kernels/kkt_pass.py)
    at n = 1000, m = 1000, at KKT_POINTS, with one and two right-hand
    sides: against its plain version to KKT_TOL of max|ref|, two sides
    bitwise what one gives; its device time (launches queued behind a
    sleep: the wrapper's host cost hidden) beside the time of one read of
    [Q; A0] from memory, its bound, its plain version and a torch.bmm
    yardstick (the stacked product [wt; wb]ᵀ·[Q; A0] and A0·wt, two bmm
    in the data's dtype)."""
    import torch
    from iadmm_tpu_torch.kernels import bounds
    from iadmm_tpu_torch.kernels.kkt_pass import kkt_pass, kkt_pass_plain
    n, m = N_VAR, N_INEQ + N_EQ
    launches0 = kkt_pass.launches
    rows, err = [], 0.0
    g = torch.Generator(device=DEV).manual_seed(21)
    for dtype, B in KKT_POINTS:
        dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        Q = torch.randn((B, n, n), device=DEV, generator=g)
        Q = (0.5 * (Q + Q.transpose(1, 2))).to(dt)
        A0 = torch.randn((B, m, n), device=DEV, generator=g).to(dt)
        vecs = [torch.randn(sh, device=DEV, generator=g)
                for sh in ((B, n), (B, m), (B, n), (B, m))]
        two = kkt_pass(Q, A0, *vecs)
        one = [kkt_pass(Q, A0, *vecs[2 * k:2 * k + 2])[0] for k in range(2)]
        for k, (p, r) in enumerate(two):
            rp, rr = kkt_pass_plain(Q, A0, *vecs[2 * k:2 * k + 2])
            for nm, a, b in (("partial", p, rp), ("rowdot", r, rr)):
                err = max(err, compare(f"kkt pass {dtype} B={B} {nm}", a, b,
                                       KKT_TOL * float(b.abs().max()),
                                       0.0)[0])
            if not (torch.equal(p, one[k][0]) and torch.equal(r, one[k][1])):
                raise PhaseError(f"kkt pass {dtype} B={B}: side {k} of a "
                                 f"two-sided pass differs from a one-sided")
        del two, one
        us_one = 1e3 * queued_ms(lambda: kkt_pass(Q, A0, *vecs[:2]))
        us_two = 1e3 * queued_ms(lambda: kkt_pass(Q, A0, *vecs))
        plain_us = 1e3 * cuda_ms(lambda: kkt_pass_plain(Q, A0, *vecs[:2]),
                                 reps=5)
        stacked = torch.cat([Q, A0], 1)
        w = torch.cat(vecs[:2], 1).to(dt)[:, None, :]
        wt = vecs[0].to(dt)[..., None]
        lib_us = 1e3 * queued_ms(lambda: (torch.bmm(w, stacked),
                                          torch.bmm(A0, wt)))
        del stacked
        b1, by1 = bounds.kkt_pass(B, n, m, dtype)
        b2, _ = bounds.kkt_pass(B, n, m, dtype, nv=2)
        cb = 2 if dtype == "bfloat16" else 4
        rows.append(dict(dtype=dtype, B=B, us=us_one, two_sides_us=us_two,
                         two_over_one=us_two / us_one,
                         one_read_hbm_us=B * (n + m) * n * cb / 3.35e12 * 1e6,
                         bound_us=1e3 * b1, two_sides_bound_us=1e3 * b2,
                         bound_by=by1, plain_us=plain_us,
                         library_us=lib_us,
                         l2_resident=B * (n + m) * n * cb < 50e6))
        del Q, A0, vecs
    torch.cuda.empty_cache()
    row = dict(shape=dict(n=n, m=m), points=rows, max_abs_err=err,
               tol=(f"{KKT_TOL:g}·max|ref| per output (partials, row dots) "
                    f"against kkt_pass_plain, one and two sides; a two-sided "
                    f"pass bitwise two one-sided ones"),
               launches=kkt_pass.launches - launches0,
               timing=("device µs a pass, 50 launches queued behind a "
                       "sleep; where the data fit the 50 MB L2 "
                       "(l2_resident) the pass may beat one read from "
                       "memory"),
               library_note=("yardstick: torch.bmm of [wt; wb]ᵀ by the "
                             "stacked [Q; A0] and of A0 by wt, in the data's "
                             "dtype (no chunk partials)"))
    say("kkt pass", **row)
    report["kkt_pass"] = row


def phase_train(report):
    """(g): harness.train on the fused backend, then serve from the
    checkpoint."""
    import numpy as np
    import torch
    from iadmm_tpu_torch.api import make_solver
    from iadmm_tpu_torch.config import ExperimentConfig
    from iadmm_tpu_torch.convert import params_from_jax
    from iadmm_tpu_torch.problems import generate
    from iadmm_tpu_torch.solvers.cells import lstm_init
    from iadmm_tpu_torch.train import checkpoint as ckpt
    from iadmm_tpu_torch.train.harness import train
    t0 = time.perf_counter()
    ds = generate("QP", num_var=N_VAR, num_ineq=N_INEQ, num_eq=N_EQ,
                  data_size=TRAIN_DATA, seed=7)
    gen_s = time.perf_counter() - t0
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    cfg = ExperimentConfig.from_dict(dict(
        prob_type="QP", num_var=N_VAR, num_ineq=N_INEQ, num_eq=N_EQ,
        data_size=TRAIN_DATA, hidden_dim=HIDDEN, sigma=SIGMA,
        outer_T=K_ITERS, truncated_length=K_ITERS, batch_size=TRAIN_BATCH,
        lr=5e-5, num_epoch=TRAIN_EPOCHS, val_frac=0.125, test_frac=0.0,
        eq_tol=1e9, use_pallas=True, gate_dtype="bfloat16",
        matvec_mode="bf16", train_backend="fused", save_dir=TRAIN_DIR))
    p0 = lstm_init(torch.Generator().manual_seed(cfg.seed), 2, HIDDEN,
                   K_ITERS, device=DEV)
    zero_counts()   # the training path, counted from 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train(cfg, ds, verbose=True, device=DEV)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_batches = int(TRAIN_DATA * (1 - cfg.val_frac)) // TRAIN_BATCH
    chunks = TRAIN_EPOCHS * n_batches * (cfg.outer_T // cfg.truncated_length)
    losses = [h["train_loss"] for h in res.history]
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_EPOCHS:
        raise PhaseError(f"g train: losses {losses}")
    for k in ("train_fwd", "train_bwd"):
        if launches[k] != chunks * cfg.truncated_length:
            raise PhaseError(f"g train: {k} launched {launches[k]} steps, "
                             f"expected {chunks} chunks x "
                             f"{cfg.truncated_length}")
    moved = max(float((res.params[k] - p0[k]).abs().max()) for k in p0)
    if not moved > 0:
        raise PhaseError("g train: the parameters did not change")
    payload = ckpt.load_checkpoint(res.checkpoint_path)
    loaded = params_from_jax(payload["params"], device=DEV)
    solve = make_solver(loaded, hidden_dim=HIDDEN, num_iters=K_ITERS,
                        sigma=SIGMA, feas_rest_num=POLISH_STEPS,
                        use_pallas=True, gate_dtype="bfloat16",
                        matvec_mode="bf16", rollout_impl="fused",
                        stage2_impl="fused")
    out = solve(qp_batch(SERVE_BATCH, seed=300))
    for f in ("x", "y", "z", "primal_res", "dual_res", "obj"):
        if not bool(getattr(out, f).isfinite().all()):
            raise PhaseError(f"g serve from checkpoint: non-finite {f}")
    row = dict(config="QP_1000_500_500 h=800, B=2, J=outer_T=100, fast "
                      "profile, train_backend='fused'",
               dataset_s=gen_s, train_s=train_s,
               epochs=[{k: h[k] for k in ("epoch", "train_loss", "val_obj",
                                          "train_time", "val_time")}
                       for h in res.history],
               chunks=chunks,
               launches={k: v for k, v in launches.items() if v},
               max_param_change=moved, checkpoint=os.path.relpath(
                   res.checkpoint_path, ROOT),
               served_primal_res_max=float(out.primal_res.max()),
               max_memory_allocated_bytes=peak)
    say("g train", **row)
    report["train"] = row
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return launches


def phase_step_vs_fused(params, data, report, cdt="bfloat16"):
    """(h), (m): one chunk update on each backend from the same params, at
    the fast profile (bf16) or the float32 one."""
    import torch
    from iadmm_tpu_torch.kernels import lstm_cell
    from iadmm_tpu_torch.kernels.train_rollout import make_fused_chunk_loss
    from iadmm_tpu_torch.solvers.rollouts import chunk_loss
    from iadmm_tpu_torch.solvers.step import make_lstm_step
    from iadmm_tpu_torch.train.harness import make_optimizer, \
        make_train_chunk
    from iadmm_tpu_torch.types import init_state
    B, n = data.p.shape
    m = data.num_constr
    fast = cdt == "bfloat16"
    step_fn = make_lstm_step(use_pallas=True, gate_dtype=cdt,
                             matvec_mode="bf16" if fast else None)
    fused = make_fused_chunk_loss(num_var=n, num_constr=m, batch=B,
                                  hidden=HIDDEN, sigma=SIGMA,
                                  chunk_len=K_ITERS, outer_T=K_ITERS,
                                  K_total=K_ITERS, compute_dtype=cdt)
    cell = "launches" if fast else "launches_f32"

    def step_loss(p, st, dat, t0):
        return chunk_loss(step_fn, p, st, dat, SIGMA, K_ITERS, K_ITERS, t0)

    rows = {}
    for name, loss_fn in (("fused", fused), ("step", step_loss)):
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        st = init_state(B, n, m, HIDDEN, device=DEV)
        loss, _ = loss_fn(p, st, data, 0)
        loss.backward()
        grads = [p[k].grad.detach().clone() for k in GRAD_KEYS]
        body = make_train_chunk(None, make_optimizer(p, 5e-5), K_ITERS,
                                K_ITERS, SIGMA, loss_fn=loss_fn)
        before = getattr(lstm_cell.fused_lstm_cell, cell)
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            body(p, st, data, 0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        rows[name] = dict(loss=float(loss.detach()), grads=grads, ms=times,
                          cell_launches=(getattr(lstm_cell.fused_lstm_cell,
                                                 cell) - before) // 2)
    gaps = leaf_gaps(rows["step"]["grads"], rows["fused"]["grads"])
    ms = {k: min(r["ms"]) for k, r in rows.items()}
    row = dict(batch=B, J=K_ITERS, profile=cdt,
               chunk_update_ms={k: r["ms"] for k, r in rows.items()},
               instance_iters_per_s={k: B * K_ITERS / (v / 1e3)
                                     for k, v in ms.items()},
               loss={k: r["loss"] for k, r in rows.items()},
               loss_rel_gap=abs(rows["step"]["loss"] - rows["fused"]["loss"])
               / abs(rows["fused"]["loss"]),
               grad_gap_step_vs_fused=dict(zip(GRAD_KEYS, gaps)),
               step_cell_launches_per_update=rows["step"]["cell_launches"],
               loss_gate=MAX_LOSS_GAP, grad_gate=MAX_STEP_GRAD_GAP,
               note=("the step route's loss uses float32 residual matvecs "
                     "and float32 H/C carries through the cell, the fused "
                     "route bf16 residual matvecs and a bf16 H stream, so "
                     "b and b_h (cancelling sums) differ by about 3%"
                     if fast else "both routes compute the same float32 "
                     "function in other summation orders"))
    tag = "h step vs fused" if fast else "m step vs fused float32"
    say(tag, **row)
    if not row["loss_rel_gap"] <= MAX_LOSS_GAP:
        raise PhaseError(f"{tag}: the two backends' chunk losses differ "
                         f"by {row['loss_rel_gap']:.3e} > {MAX_LOSS_GAP}")
    for k, gap in zip(GRAD_KEYS, gaps):
        if not gap <= MAX_STEP_GRAD_GAP:
            raise PhaseError(f"{tag}: grad[{k}] differs between the backends "
                             f"by {gap:.3e} > {MAX_STEP_GRAD_GAP}")
    report["step_vs_fused" if fast else "step_vs_fused_f32"] = row


def sparse_dataset():
    """The Sparse_QP_Large dataset of (i) and (j), generated on the host
    (the port's numpy generators) from a fresh seed."""
    from iadmm_tpu_torch.problems import generate
    t0 = time.perf_counter()
    ds = generate("Sparse_QP", num_var=SP_N, num_ineq=SP_MI,
                  data_size=SP_DATA, seed=23)
    gen_s = time.perf_counter() - t0
    say("sparse dataset", family="Sparse_QP", n=SP_N, m=SP_MI,
        instances=SP_DATA, host_generation_s=gen_s)
    return ds, gen_s


def bsr_case(name, M, MT, dense, B, m, n, tol, timed, rows):
    """The BSR kernel against its plain version on one operand: forward,
    backward through ``bsr_matvec_ad``, a bitwise repeat and, if ``timed``,
    times beside the bound and the dense ``torch.bmm`` yardstick."""
    import torch
    from iadmm_tpu_torch.kernels import sparse_matvec as tsm
    from iadmm_tpu_torch.kernels.bounds import bsr_matvec as bsr_bound, \
        stored_tiles
    g = torch.Generator().manual_seed(B * 7 + m)
    v = torch.randn((B, n), generator=g).to(DEV)
    w = torch.randn((B, m), generator=g).to(DEV)
    before = tsm.bsr_matvec.launches
    out = tsm.bsr_matvec(M, v)
    torch.cuda.synchronize()
    if tsm.bsr_matvec.launches != before + 1:
        raise PhaseError(f"{name}: the wrapper did not launch the kernel")
    ref = tsm.bsr_matvec_plain(M, v)
    scale = float(ref.abs().max())
    err = compare(f"{name} forward", out, ref, tol * scale, 0.0)
    if not torch.equal(tsm.bsr_matvec(M, v), out):
        raise PhaseError(f"{name}: two calls gave different outputs")
    vg = v.clone().requires_grad_(True)
    (tsm.bsr_matvec_ad(M, MT, vg) * w).sum().backward()
    gref = tsm.bsr_matvec_plain(MT, w)
    gerr = compare(f"{name} backward", vg.grad, gref,
                   tol * float(gref.abs().max()), 0.0)
    TM, TN = M.tile
    row = dict(case=name, B=B, m=m, n=n, tile=[TM, TN],
               dtype=str(M.vals.dtype).replace("torch.", ""),
               K=int(M.cols.shape[2]), occupancy=M.occupancy,
               max_abs_err=err[0], max_rel_err=err[1],
               bwd_max_abs_err=gerr[0], bwd_max_rel_err=gerr[1])
    if timed:
        tiles = stored_tiles(M.vals)
        b_ms, b_by = bsr_bound(tiles, B, m, n, TM, TN,
                               M.vals.element_size())
        vb = v.to(torch.bfloat16)[..., None]
        buf = torch.ones(FLUSH_BYTES // 4, device=DEV)

        def flush():
            buf.sum()
        # device times (launches queued behind a sleep): warm, back to back
        # on the same operands, and cold, each call after an L2 flush;
        # paced_ms is the kernel as Python launches it back to back,
        # wrapper included
        row.update(
            stored_tiles=tiles,
            kernel_ms=queued_ms(lambda: tsm.bsr_matvec(M, v)),
            kernel_cold_ms=queued_ms(lambda: tsm.bsr_matvec(M, v),
                                     flush=flush),
            paced_ms=cuda_ms(lambda: tsm.bsr_matvec(M, v), reps=50,
                             warmup=5),
            plain_ms=queued_ms(lambda: tsm.bsr_matvec_plain(M, v), reps=20),
            library_ms=queued_ms(lambda: torch.bmm(dense, vb)),
            library_cold_ms=queued_ms(lambda: torch.bmm(dense, vb),
                                      flush=flush),
            bound_ms=b_ms, bound_by=b_by)
    rows.append(row)
    say("i bsr", **row)
    return row


def bsr_group_case(name, mats, vs, tol, timed, rows):
    """One grouped launch of the products ``mats[i]·vs[i]``: launched once
    (the counter moves by one), each output bitwise the single-product
    kernel's and held to the plain version, a bitwise repeat and, if
    ``timed``, its times beside its bound (the sum of its products' bytes)
    and beside the same products as single launches."""
    import torch
    from iadmm_tpu_torch.kernels import sparse_matvec as tsm
    from iadmm_tpu_torch.kernels.bounds import bsr_matvec_group as bound, \
        stored_tiles
    before = tsm.bsr_matvec.launches
    outs = tsm.bsr_matvec_group(mats, vs)
    torch.cuda.synchronize()
    if tsm.bsr_matvec.launches != before + 1:
        raise PhaseError(f"{name}: the grouped call was not one launch")
    errs = []
    for i, (M, v, out) in enumerate(zip(mats, vs, outs)):
        if not torch.equal(out, tsm.bsr_matvec(M, v)):
            raise PhaseError(f"{name}: product {i} is not bitwise the "
                             f"single-product kernel's")
        ref = tsm.bsr_matvec_plain(M, v)
        errs.append(compare(f"{name} product {i}", out, ref,
                            tol * float(ref.abs().max()), 0.0))
    if not all(torch.equal(a, b)
               for a, b in zip(tsm.bsr_matvec_group(mats, vs), outs)):
        raise PhaseError(f"{name}: two grouped calls gave different outputs")
    B = vs[0].shape[0]
    row = dict(case=name, B=B, grouped=True,
               dtype=str(mats[0].vals.dtype).replace("torch.", ""),
               products=[dict(shape=list(M.shape), tile=list(M.tile),
                              K=int(M.cols.shape[2])) for M in mats],
               max_abs_err=max(e[0] for e in errs),
               max_rel_err=max(e[1] for e in errs))
    if timed:
        # timed on contiguous vectors: the launch alone, no input copies
        vs = [v.contiguous() for v in vs]
        b_ms, b_by = bound([(stored_tiles(M.vals), B, *M.shape, *M.tile,
                             M.vals.element_size()) for M in mats])
        buf = torch.ones(FLUSH_BYTES // 4, device=DEV)

        def flush():
            buf.sum()

        def singles():
            return [tsm.bsr_matvec(M, v) for M, v in zip(mats, vs)]
        row.update(
            kernel_ms=queued_ms(lambda: tsm.bsr_matvec_group(mats, vs)),
            kernel_cold_ms=queued_ms(lambda: tsm.bsr_matvec_group(mats, vs),
                                     flush=flush),
            paced_ms=cuda_ms(lambda: tsm.bsr_matvec_group(mats, vs),
                             reps=50, warmup=5),
            singles_ms=queued_ms(singles),
            singles_cold_ms=queued_ms(singles, flush=flush),
            singles_paced_ms=cuda_ms(singles, reps=50, warmup=5),
            plain_ms=queued_ms(
                lambda: tsm.bsr_matvec_group_plain(mats, vs), reps=20),
            bound_ms=b_ms, bound_by=b_by)
    rows.append(row)
    say("i bsr group", **row)
    return row


def phase_bsr(ds, report):
    """(i): the BSR kernel against its plain version on the scaled
    Sparse_QP_Large operands (Q, A0, A0ᵀ) at B=2 and B=10, bf16 and
    float32 tiles, and on a ragged (128, 128)-tile case; then the grouped
    launch on the route's groups (A0·u, A0ᵀ·ν, Q·u) at the same points and
    (M·v, Mᵀ·w, M·v') on the ragged case."""
    import numpy as np
    import torch
    from iadmm_tpu_torch.kernels.sparse_matvec import bsr_from_dense, \
        bsr_pair_from_dense
    from iadmm_tpu_torch.problems import to_qp_batch
    from iadmm_tpu_torch.scaling import scale_batch
    rows = []
    tol = {torch.bfloat16: BSR_TOL_BF16, torch.float32: BSR_TOL_F32}
    for B in (SP_TRAIN_B, SP_TEST_B):
        scaled, _ = scale_batch(to_qp_batch(ds, np.arange(B), device=DEV))
        Qd, Ad = scaled.Q, scaled.A0
        dense = dict(Q=Qd.to(torch.bfloat16), A0=Ad.to(torch.bfloat16),
                     A0T=Ad.transpose(1, 2).contiguous().to(torch.bfloat16))
        for dt in (torch.bfloat16, torch.float32):
            Q = bsr_from_dense(Qd, SP_TILE, dt, device=DEV)
            A, AT = bsr_pair_from_dense(Ad, SP_TILE, dt, device=DEV)
            for nm, M, MT in (("Q", Q, Q), ("A0", A, AT), ("A0T", AT, A)):
                m, n = M.shape
                bsr_case(f"{nm} B={B}", M, MT, dense[nm], B, m, n, tol[dt],
                         True, rows)
            # u and ν as the step slices them from xv: not contiguous, so
            # the wrapper copies each before the one launch
            g = torch.Generator().manual_seed(B * 11)
            xv = torch.randn((B, SP_N + SP_MI), generator=g).to(DEV)
            u, nu = xv[:, :SP_N], xv[:, SP_N:]
            bsr_group_case(f"group (A0·u, A0ᵀ·ν, Q·u) B={B}", [A, AT, Q],
                           [u, nu, u], tol[dt], True, rows)
            del Q, A, AT
        del scaled, Qd, Ad, dense
    g = torch.Generator().manual_seed(31)
    Mr = torch.randn((2, 1000, 1500), generator=g)
    band = (torch.arange(1000)[:, None] * 3 // 2
            - torch.arange(1500)[None, :]).abs() <= 40
    Mr = Mr * band
    for dt in (torch.bfloat16, torch.float32):
        M, MT = bsr_pair_from_dense(Mr.numpy(), (128, 128), dt, device=DEV)
        bsr_case("ragged 1000x1500 (128,128)", M, MT, None, 2, 1000, 1500,
                 tol[dt], False, rows)
        g = torch.Generator().manual_seed(37)
        vs = [torch.randn((2, k), generator=g).to(DEV)
              for k in (1500, 1000, 1500)]
        bsr_group_case("group ragged 1000x1500 (128,128)", [M, MT, M], vs,
                       tol[dt], False, rows)
    report["bsr"] = rows
    main = next(r for r in rows if r["case"] == f"Q B={SP_TRAIN_B}"
                and r["dtype"] == "bfloat16")
    return dict(main, max_abs_err=max(r["max_abs_err"] for r in rows
                                      if r["dtype"] == "bfloat16"
                                      and "kernel_ms" in r
                                      and not r.get("grouped")))


def trace_gap(a, b, keys, upto=None):
    """{key: max_t |a − b| / max_t |b|} over the first ``upto`` steps."""
    import numpy as np
    sl = slice(0, upto)
    return {k: float(np.abs(getattr(a, k)[sl] - getattr(b, k)[sl]).max()
                     / max(float(np.abs(getattr(b, k)[sl]).max()), 1e-30))
            for k in keys}


def sparse_chunk_breakdown(cfg, ds, params, ids):
    """Host-clock time of one chunk update on the BSR route (B=2, J=50)
    and, from one profiled update, the device time by kernel and the
    device's busy share (device time over the unprofiled wall time)."""
    import torch
    from functools import partial
    from iadmm_tpu_torch.kernels.sparse import make_sparse_chunk_loss
    from iadmm_tpu_torch.scaling import scale_batch
    from iadmm_tpu_torch.train.harness import make_optimizer, \
        make_train_chunk
    from iadmm_tpu_torch.train.preload import preload_sparse_cache
    from iadmm_tpu_torch.types import init_state
    (data, _), = preload_sparse_cache(
        ds, ids[:SP_TRAIN_B], 1, SP_TRAIN_B, cfg,
        partial(scale_batch, iters=cfg.scaling_ites), device=DEV)
    p = {k: torch.as_tensor(v, device=DEV).requires_grad_(True)
         for k, v in params.items()}
    body = make_train_chunk(
        None, make_optimizer(p, cfg.lr, clip_grad_norm=cfg.clip_grad_norm),
        cfg.outer_T, SP_K, cfg.sigma,
        loss_fn=make_sparse_chunk_loss(cfg.sigma, SP_K, cfg.outer_T))
    st = init_state(SP_TRAIN_B, data.num_var, data.num_constr, SP_H,
                    device=DEV)

    def update():
        body(p, st, data, 0)

    from iadmm_tpu_torch.kernels import sparse_matvec as tsm
    before = tsm.bsr_matvec.launches
    update()
    bsr_launches = tsm.bsr_matvec.launches - before
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    top, dev_ms = device_time_by_kernel(update, top=10)
    return dict(chunk_update_ms=times, device_ms=dev_ms,
                bsr_launches=bsr_launches,
                device_busy_share=dev_ms / min(times),
                train_instance_iters_per_s=SP_TRAIN_B * SP_K
                / (min(times) / 1e3),
                device_ms_by_kernel=top)


def sparse_cfg(data_size=SP_DATA):
    """scripts/run_workload.py's Sparse_QP_Large profile on the BSR route;
    the gate is open (eq_tol) so that 2 epochs write a checkpoint."""
    from iadmm_tpu_torch.config import ExperimentConfig
    return ExperimentConfig.from_dict(dict(
        prob_type="Sparse_QP", num_var=SP_N, num_ineq=SP_MI,
        data_size=data_size, hidden_dim=SP_H, sigma=SIGMA, outer_T=SP_K,
        truncated_length=SP_K, test_outer_T=SP_K, batch_size=SP_TRAIN_B,
        test_batch_size=SP_TEST_B, lr=5e-5, clip_grad_norm=1.0,
        num_epoch=TRAIN_EPOCHS, val_frac=1 / 11, test_frac=5 / 11,
        eq_tol=1e9, scaling=True, sparse=True, sparse_format="bsr",
        matvec_mode="bf16", use_pallas=True, gate_dtype="bfloat16",
        train_backend="step", feas_rest=True, feas_rest_num=POLISH_STEPS,
        save_dir=SPARSE_DIR))


def phase_sparse(ds, gen_s, report):
    """(j): train Sparse_QP_Large on the BSR route with harness.train, then
    evaluate the reloaded checkpoint with run_test on the BSR and the dense
    route."""
    import dataclasses
    import numpy as np
    import torch
    from iadmm_tpu_torch.evaluation.driver import run_test
    from iadmm_tpu_torch.kernels import lstm_cell, sparse_matvec as tsm
    from iadmm_tpu_torch.problems.io import split_ids
    from iadmm_tpu_torch.solvers.cells import lstm_init
    from iadmm_tpu_torch.train import checkpoint as ckpt
    from iadmm_tpu_torch.train.harness import train
    shutil.rmtree(SPARSE_DIR, ignore_errors=True)
    cfg = sparse_cfg()
    train_ids, _, test_ids = split_ids(cfg.data_size, cfg.val_frac,
                                       cfg.test_frac, cfg.seed)
    if len(test_ids) < SP_TEST_B:
        raise PhaseError(f"j: test split of {len(test_ids)} < {SP_TEST_B}")
    test_ids = test_ids[:SP_TEST_B]
    chunks = TRAIN_EPOCHS * (len(train_ids) // SP_TRAIN_B)
    p0 = lstm_init(torch.Generator().manual_seed(cfg.seed), 2, SP_H, SP_K,
                   device=DEV)
    bsr_c, cell_c = tsm.bsr_matvec, lstm_cell.fused_lstm_cell
    zero_counts()   # the sparse path, counted from 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train(cfg, ds, verbose=True, device=DEV)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = bsr_c.launches
    losses = [h["train_loss"] for h in res.history]
    if not all(np.isfinite(losses)) or len(losses) != TRAIN_EPOCHS:
        raise PhaseError(f"j train: losses {losses}")
    # per chunk: three grouped launches a step forward (the KKT feature's
    # two, the residuals' one) and three backward, but at step 0 (the
    # detached start state) only A0ᵀ·r2's and the residuals'; one Qv a
    # epoch for the train objective (18 * SP_K - 5 single launches a chunk
    # before the products were grouped)
    want = chunks * (6 * SP_K - 1) + TRAIN_EPOCHS
    if train_launches != want:
        raise PhaseError(f"j train: {train_launches} BSR launches, "
                         f"expected {want}")
    moved = max(float((res.params[k] - p0[k]).abs().max()) for k in p0)
    if not moved > 0:
        raise PhaseError("j train: the parameters did not change")
    params = ckpt.load_checkpoint(res.checkpoint_path)["params"]
    routes = dict(
        bsr=cfg,
        dense=dataclasses.replace(cfg, sparse=False),
        dense_f32_cell=dataclasses.replace(cfg, sparse=False,
                                           use_pallas=False,
                                           gate_dtype="float32",
                                           feas_rest=False))
    reps = {}
    for name in ("bsr", "dense"):   # the main path
        before = bsr_c.launches
        reps[name] = run_test(routes[name], ds, params, test_ids=test_ids,
                              verbose=False, device=DEV)
        # the warm-up and the timed batch, three grouped launches a step
        if name == "bsr" and bsr_c.launches - before != 2 * 3 * SP_K:
            raise PhaseError(f"j run_test: {bsr_c.launches - before} BSR "
                             f"launches, expected {2 * 3 * SP_K}")
    launches = dict(bsr=bsr_c.launches, cell=cell_c.launches)
    peak = torch.cuda.max_memory_allocated()
    # comparisons, outside the counted path: the dense route at the BSR
    # route's cell precision, and the BSR route with permuted hidden units
    reps["dense_f32_cell"] = run_test(routes["dense_f32_cell"], ds, params,
                                      test_ids=test_ids, verbose=False,
                                      device=DEV)
    perm = torch.randperm(SP_H, generator=torch.Generator().manual_seed(3))
    pp = permute_hidden({k: torch.as_tensor(v) for k, v in params.items()},
                        perm)
    reps["dense_f32_cell_perm"] = run_test(
        routes["dense_f32_cell"], ds, {k: v.numpy() for k, v in pp.items()},
        test_ids=test_ids, verbose=False, device=DEV)
    breakdown = sparse_chunk_breakdown(cfg, ds, params, train_ids)
    for name, r in reps.items():
        for k in ("obj", "ls_res", "primal_res", "dual_res"):
            if not np.isfinite(getattr(r, k)).all():
                raise PhaseError(f"j {name}: non-finite {k} trace")
        if r.x_final.shape != (SP_TEST_B, SP_N):
            raise PhaseError(f"j {name}: x_final {r.x_final.shape}")
    keys4 = ("obj", "primal_res", "dual_res", "ls_res")
    keys3 = keys4[:3]
    same6 = trace_gap(reps["bsr"], reps["dense_f32_cell"], keys4, K_CHECK)
    same50 = trace_gap(reps["bsr"], reps["dense_f32_cell"], keys3)
    own50 = trace_gap(reps["dense_f32_cell_perm"], reps["dense_f32_cell"],
                      keys3)
    prof6 = trace_gap(reps["bsr"], reps["dense"], keys4, K_CHECK)
    prof50 = trace_gap(reps["bsr"], reps["dense"], keys3)
    row = dict(
        config=(f"Sparse_QP_Large: n={SP_N}, m={SP_MI} box rows, h={SP_H}, "
                f"K=outer_T={SP_K}, B={SP_TRAIN_B}, test B={SP_TEST_B}, "
                f"bf16 (8,128) tiles, train_backend='step'"),
        dataset_s=gen_s, train_s=train_s,
        epochs=[{k: h[k] for k in ("epoch", "train_loss", "train_obj",
                                   "val_obj", "train_time", "val_time")}
                for h in res.history],
        chunks=chunks, train_bsr_launches=train_launches,
        launches=launches, max_param_change=moved,
        run_test={name: dict(total_s=r.total_time,
                             parallel_s_per_instance=r.parallel_time,
                             stage2_s=(r.stage2.total_time if r.stage2
                                       else None),
                             last_row=r.table().splitlines()[0] + " || "
                             + r.row(SP_K - 1),
                             stage2_final_primal_res=(
                                 float(r.stage2.primal_res[-1])
                                 if r.stage2 else None))
                  for name, r in reps.items()},
        gap_bsr_vs_dense_f32_cell_first6=same6,
        gap_bsr_vs_dense_f32_cell_K50=same50,
        gap_dense_f32_cell_vs_permuted_K50=own50,
        gap_bsr_vs_dense_profile_first6=prof6,
        gap_bsr_vs_dense_profile_K50=prof50,
        chunk_update_breakdown=breakdown,
        tol=(f"BSR vs dense at the same cell precision: every trace to "
             f"{ROUTE_RTOL_6} of max|ref| over the first {K_CHECK} steps; "
             f"obj/primal/dual over K={SP_K} to {MAX_GAP_OVER_ROUNDING}x the "
             f"dense route's own gap under a hidden-unit permutation (at "
             f"least {ROUTE_FLOOR_K:.3e}, {MAX_GAP_OVER_ROUNDING:g} float32 "
             f"ulps); BSR vs the dense profile (bf16-gate cell "
             f"kernel): primal, dual and ls_res to {PROFILE_RTOL_6} over the "
             f"first {K_CHECK} steps, obj (a cancelling sum near 0 there) "
             f"reported only"),
        max_memory_allocated_bytes=peak)
    say("j sparse train + run_test", **row)
    for k in keys4:
        if not same6[k] <= ROUTE_RTOL_6:
            raise PhaseError(f"j: {k} differs between the BSR and the dense "
                             f"route by {same6[k]:.3e} in {K_CHECK} steps")
    for k in keys4[1:]:
        if not prof6[k] <= PROFILE_RTOL_6:
            raise PhaseError(f"j: {k} differs between the BSR route and the "
                             f"dense profile by {prof6[k]:.3e}")
    for k in keys3:
        if not same50[k] <= max(MAX_GAP_OVER_ROUNDING * own50[k],
                                ROUTE_FLOOR_K):
            raise PhaseError(f"j: {k} gap {same50[k]:.3e} over K={SP_K} "
                             f"exceeds {MAX_GAP_OVER_ROUNDING}x the dense "
                             f"route's own {own50[k]:.3e} and the floor "
                             f"{ROUTE_FLOOR_K:.3e}")
    report["sparse"] = row
    shutil.rmtree(SPARSE_DIR, ignore_errors=True)
    return launches


def run_cli(module, args, log_name):
    """``module.main(args)`` in this process (the CLI's entry point), its
    standard output kept in OUT_DIR/log_name and returned."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(args)
    text = buf.getvalue()
    with open(os.path.join(OUT_DIR, log_name), "w") as f:
        f.write(text)
    if rc != 0:
        raise PhaseError(f"{module.__name__} {args}: exit code {rc}")
    return text


def phase_flagship(report):
    """(m): configs/qp_1000_500_500.yaml, unmodified, through the CLIs.
    Returns the launches of the three CLI runs (the main path)."""
    import re
    import types
    import numpy as np
    import torch
    from iadmm_tpu_torch.cli import test as cli_test, train as cli_train
    from iadmm_tpu_torch.config import ExperimentConfig
    from iadmm_tpu_torch.evaluation.driver import run_test
    from iadmm_tpu_torch.problems import generate
    from iadmm_tpu_torch.problems.io import dataset_path, load_dataset, \
        save_npz
    from iadmm_tpu_torch.solvers.cells import lstm_init
    from iadmm_tpu_torch.train import checkpoint as ckpt
    from iadmm_tpu_torch.utils.logging import RunLog
    shutil.rmtree(FLAGSHIP_DIR, ignore_errors=True)
    root = os.path.join(FLAGSHIP_DIR, "data")
    os.makedirs(root)
    t0 = time.perf_counter()
    ds = generate("QP", num_var=N_VAR, num_ineq=N_INEQ, num_eq=N_EQ,
                  data_size=FLAGSHIP_DATA, seed=41)
    save_npz(ds, dataset_path(root, "QP", N_VAR, N_INEQ, N_EQ))
    gen_s = time.perf_counter() - t0
    dirs = {k: os.path.join(FLAGSHIP_DIR, k) for k in ("step", "fused")}
    traces_path = os.path.join(FLAGSHIP_DIR, "traces.npz")
    common = ["--config", FLAGSHIP_CONFIG,
              "--data_size", str(FLAGSHIP_DATA),
              "--val_frac", str(FLAGSHIP_VAL),
              "--test_frac", str(FLAGSHIP_TEST), "--data_root", root]
    gate = ["--eq_tol", "1e9", "--ineq_tol", "1e9"]
    times = {}
    zero_counts()   # the shipped config's path, counted from 0
    for name, args, log in (
            ("train_step", common + gate + ["--num_epoch", str(TRAIN_EPOCHS),
                                            "--save_dir", dirs["step"]],
             "cli_train_step.txt"),
            ("test", common + ["--save_dir", dirs["step"], "--feas_rest",
                               "--export", traces_path], "cli_test.txt"),
            ("train_fused", common + gate + ["--num_epoch", "1",
                                             "--train_backend", "fused",
                                             "--save_dir", dirs["fused"]],
             "cli_train_fused.txt")):
        module = cli_test if name == "test" else cli_train
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text = run_cli(module, args, log)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        if name == "test":
            test_text = text
    launches = launch_counts()

    over = dict(data_size=FLAGSHIP_DATA, val_frac=FLAGSHIP_VAL,
                test_frac=FLAGSHIP_TEST, data_root=root, eq_tol=1e9,
                ineq_tol=1e9)
    cfg = ExperimentConfig.from_yaml(FLAGSHIP_CONFIG, save_dir=dirs["step"],
                                     num_epoch=TRAIN_EPOCHS, **over)
    epochs = {}
    for name, d in dirs.items():
        log = RunLog(os.path.join(d, cfg.model_name,
                                  cfg.run_name() + ".log.jsonl")).read()
        epochs[name] = [r for r in log if r["kind"] == "epoch"]
        losses = [r["train_loss"] for r in epochs[name]]
        want = TRAIN_EPOCHS if name == "step" else 1
        if len(losses) != want or not all(np.isfinite(losses)):
            raise PhaseError(f"m {name}: epoch losses {losses}")
    n_train = int(FLAGSHIP_DATA * (1 - FLAGSHIP_VAL - FLAGSHIP_TEST))
    chunks = n_train // cfg.batch_size
    for k in ("train_fwd_f32", "train_bwd_f32"):
        if launches[k] != chunks * cfg.truncated_length:
            raise PhaseError(f"m: {k} launched {launches[k]} steps, "
                             f"expected {chunks} chunks x "
                             f"{cfg.truncated_length}")
    for k in ("cell", "train_fwd", "train_bwd"):   # the bf16 kernels
        if launches[k]:
            raise PhaseError(f"m: the float32 profile launched {k}")
    if launches["cell_f32"] <= 0:
        raise PhaseError("m: the float32 cell kernel was not launched")
    p0 = lstm_init(torch.Generator().manual_seed(cfg.seed), 2, HIDDEN,
                   cfg.outer_T, device="cpu")
    path = ckpt.checkpoint_path(dirs["step"], cfg.model_name, cfg.run_name())
    params = ckpt.load_checkpoint(path)["params"]
    moved = max(float(np.abs(np.asarray(params[k]) - p0[k].numpy()).max())
                for k in p0)
    if not moved > 0:
        raise PhaseError("m: the parameters did not change")

    # The CLI's traces against run_test on the plain float32 cell
    # (use_pallas=False), itself with permuted hidden units as the yardstick
    # of K=100.
    tr = np.load(traces_path)
    cli_rep = types.SimpleNamespace(
        obj=tr["objs"], primal_res=tr["primal_res"],
        dual_res=tr["dual_res"], ls_res=tr["ls_res"])
    ds = load_dataset(root, "QP", N_VAR, N_INEQ, N_EQ, 0, FLAGSHIP_DATA)
    plain_cfg = ExperimentConfig.from_yaml(FLAGSHIP_CONFIG, save_dir=dirs[
        "step"], use_pallas=False, feas_rest=True, **over)
    ref = run_test(plain_cfg, ds, params, verbose=False, device=DEV)
    perm = torch.randperm(HIDDEN, generator=torch.Generator().manual_seed(3))
    pp = permute_hidden({k: torch.as_tensor(v) for k, v in params.items()},
                        perm)
    own = run_test(plain_cfg, ds, {k: v.numpy() for k, v in pp.items()},
                   verbose=False, device=DEV)
    keys4 = ("obj", "primal_res", "dual_res", "ls_res")
    keys3 = keys4[:3]
    gap6 = trace_gap(cli_rep, ref, keys4, K_CHECK)
    gap_k = trace_gap(cli_rep, ref, keys3)
    own_k = trace_gap(own, ref, keys3)

    def seconds(pattern):
        found = re.search(pattern, test_text)
        return float(found.group(1)) if found else None

    row = dict(
        config=("configs/qp_1000_500_500.yaml unmodified (use_pallas, float32 "
                "gates, matvec_mode 'highest', train_backend 'step'); CLI "
                f"overrides: data_size {FLAGSHIP_DATA}, val/test fractions "
                f"{FLAGSHIP_VAL}/{FLAGSHIP_TEST}, num_epoch, eq/ineq_tol, "
                "paths"),
        dataset_s=gen_s, cli_s=times,
        epochs={k: [{f: r[f] for f in ("epoch", "train_loss", "val_obj",
                                         "train_time", "val_time")}
                    for r in v] for k, v in epochs.items()},
        fused_chunks=chunks,
        launches={k: v for k, v in launches.items() if v},
        max_param_change=moved,
        parallel_s_per_instance=float(tr["time"]),
        total_s=float(tr["total_time"]),
        stage2_s=seconds(r"Stage II \(feasibility restoration\) \S+ "
                         r"([0-9.eE+-]+)s"),
        timing_line=next((ln.strip() for ln in test_text.splitlines()
                          if "Parallel Time" in ln), None),
        stage2_final_primal_res=float(tr["stage2_primal_res"][-1]),
        gap_cli_vs_plain_cell_first6=gap6,
        gap_cli_vs_plain_cell_K100=gap_k,
        gap_plain_cell_vs_permuted_K100=own_k,
        tol=(f"the CLI's run_test (float32 cell kernel) vs use_pallas=False "
             f"(plain float32 cell): every trace to {F32_LEAF_TOL:g} of "
             f"max|ref| over the first {K_CHECK} steps; obj/primal/dual over "
             f"K={K_ITERS} to {MAX_GAP_OVER_ROUNDING:g}x the plain route's "
             f"own gap under a hidden-unit permutation (at least "
             f"{ROUTE_FLOOR_K:.3e})"))
    say("m flagship CLIs", **row)
    for k in keys4:
        if not gap6[k] <= F32_LEAF_TOL:
            raise PhaseError(f"m: {k} differs from the plain float32 cell "
                             f"by {gap6[k]:.3e} in {K_CHECK} steps")
    for k in keys3:
        if not gap_k[k] <= max(MAX_GAP_OVER_ROUNDING * own_k[k],
                               ROUTE_FLOOR_K):
            raise PhaseError(f"m: {k} gap {gap_k[k]:.3e} over K={K_ITERS} "
                             f"exceeds {MAX_GAP_OVER_ROUNDING}x the plain "
                             f"route's own {own_k[k]:.3e}")
    report["flagship"] = row
    shutil.rmtree(FLAGSHIP_DIR, ignore_errors=True)
    return launches


# (o), (p): the segment-recompute route
SEG_LEN = 2           # pick_segment_len at the flagship (both packages)
SEG_CHECKS = (1, 2, 3)   # segment lengths of the J=K_CHECK checks
SEG_BATCH = 16        # the slice's batch: over IADMM_STREAM_HBM from B=9
# (p): 40 instances, 32 train (2 chunk updates of B=16), 4 val, 4 test
SEG_DATA, SEG_VAL, SEG_TEST = 40, 4 / 40, 4 / 40
SEG_DIR = os.path.join(ROOT, "results", "chip_smoke_seg")


def seg_forward(weights, state, dd, J, seg, cdt, plain=False):
    """The segment forward over a J-step chunk from ``state``, as
    make_fused_chunk_loss runs it (each call taking the loss its previous
    call left; a checkout whose wrapper has no such argument, as one
    copied in for ``--snapshot``, runs each call on its own):
    (pr, dr, final, checkpoints)."""
    import inspect
    import torch
    from iadmm_tpu_torch.kernels import train_rollout as tr
    kw = dict(sigma=SIGMA, compute_dtype=cdt)
    B = state[0].shape[0]
    ckpts, parts = [], []
    losses = tuple(torch.empty((B, J), device=DEV) for _ in range(2))
    fold = "pending" in inspect.signature(tr.train_fwd_seg_cuda).parameters
    n_segs = J // seg
    for s in range(n_segs):
        ckpts.append(state)
        if plain:
            pr, dr, state = tr.train_fwd_seg_plain(weights, state, dd,
                                                   t0=s * seg, J=seg, **kw)
            parts.append((pr, dr))
        else:
            order = (dict(pending=s > 0, close=s == n_segs - 1) if fold
                     else {})
            *_, state = tr.train_fwd_seg_cuda(weights, state, dd,
                                              t0=s * seg, J=seg,
                                              losses=losses, col=s * seg,
                                              **order, **kw)
    if plain:
        losses = tuple(torch.cat(v, 1) for v in zip(*parts))
    return (*losses, state, ckpts)


def seg_backward(weights, ckpts, dd, dfinal, d, seg, cdt, plain=False):
    """The segment backward over the checkpoints, in reverse: (gradients,
    start-state cotangents)."""
    from iadmm_tpu_torch.kernels import train_rollout as tr
    bwd = tr.train_bwd_seg_plain if plain else tr.train_bwd_seg_cuda
    acc, dst = None, dfinal
    for s in reversed(range(len(ckpts))):
        acc, dst = bwd(weights, ckpts[s], dd, dst, d, d, t0=s * seg, J=seg,
                       col=s * seg, acc=acc, sigma=SIGMA, compute_dtype=cdt)
    return acc, dst


def seg_checks(weights, state, dd, segs, cdt, tag):
    """The segment pair over a J=K_CHECK chunk from ``state``, in segments
    of each length in ``segs``: bitwise equal to the stream pair on the card
    (losses, final state, every gradient leaf and the start state's
    cotangents), the backward twice bitwise equal, one launch a segment
    each, and held to the plain segment pair at (f)/(l)'s J=K_CHECK limits
    (the float32 ones widened to 4x the plain pair's own gap to its float64
    run where larger, measured here on these inputs).  Returns ({seg:
    gaps}, max |Δ| of the forward outputs, max |Δ| of the gradients)."""
    import torch
    from iadmm_tpu_torch.kernels import train_rollout as tr
    prof = TRAIN_PROFILES[cdt]
    counter = "launches" if cdt == "bfloat16" else "launches_f32"
    B, J = state[0].shape[0], K_CHECK
    kw = dict(t0=0, J=J, sigma=SIGMA, compute_dtype=cdt)
    spr, sdr, sfin, sstr = tr.train_fwd_cuda(weights, state, dd, **kw)
    d = torch.full((B, J), 1.0 / (B * K_ITERS), device=DEV)
    zero = tuple(torch.zeros_like(f) for f in sfin)
    sg, sdst = tr.train_bwd_cuda(weights, dd, sstr, zero, d, d, **kw)
    del sstr
    ref = (spr, sdr, *sfin, *sg, *sdst)
    own_fwd, own_grad = [0.0] * len(FWD_OUTPUTS), [0.0] * len(GRAD_KEYS)
    if prof["f64"]:   # the plain pair's own float32 error, against float64
        ppr, pdr, pfin, pck = seg_forward(weights, state, dd, J, J, cdt,
                                          plain=True)
        pg, _ = seg_backward(weights, pck, dd, zero, d, J, cdt, plain=True)
        f64 = torch.float64
        w64, s64, d64 = (tuple(t.to(f64) for t in x)
                         for x in (weights, state, dd))
        qpr, qdr, qfin, qck = seg_forward(w64, s64, d64, J, J, cdt,
                                          plain=True)
        qg, _ = seg_backward(w64, qck, d64, tuple(t.to(f64) for t in zero),
                             d.to(f64), J, cdt, plain=True)
        own_fwd = leaf_gaps((ppr, pdr, *pfin), (qpr, qdr, *qfin))
        own_grad = leaf_gaps(pg, qg)
        del pck, qck, pfin, qfin, pg, qg
    fa, fr = prof["fwd"]
    names = FWD_OUTPUTS + GRAD_KEYS + tuple(
        "d" + k for k in ("x", "y", "z", "xv", "H", "C"))
    checks = {}
    err_fwd = err_grad = 0.0
    for seg in segs:
        f0 = getattr(tr.train_fwd_seg_cuda, counter)
        b0 = getattr(tr.train_bwd_seg_cuda, counter)
        kpr, kdr, kfin, ck = seg_forward(weights, state, dd, J, seg, cdt)
        kg, kdst = seg_backward(weights, ck, dd, zero, d, seg, cdt)
        torch.cuda.synchronize()
        if (getattr(tr.train_fwd_seg_cuda, counter) != f0 + J // seg
                or getattr(tr.train_bwd_seg_cuda, counter) != b0 + J // seg):
            raise PhaseError(f"{tag} seg={seg}: the wrappers did not launch "
                             f"one call a segment")
        mine = (kpr, kdr, *kfin, *kg, *kdst)
        differ = [k for k, a, b in zip(names, mine, ref)
                  if not torch.equal(a.reshape(b.shape), b)]
        if differ:
            raise PhaseError(f"{tag} seg={seg}: not bitwise equal to the "
                             f"stream pair in {differ}")
        again, _ = seg_backward(weights, ck, dd, zero, d, seg, cdt)
        if not all(torch.equal(a, b) for a, b in zip(kg, again)):
            raise PhaseError(f"{tag} seg={seg}: two segment backwards "
                             f"differ")
        ppr, pdr, pfin, pck = seg_forward(weights, state, dd, J, seg, cdt,
                                          plain=True)
        pg, _ = seg_backward(weights, pck, dd, zero, d, seg, cdt, plain=True)
        errs = [compare(f"{tag} seg={seg} fwd {k}", a, b, max(
                    fa, MAX_GAP_OVER_ROUNDING * own) * float(b.abs().max()),
                    fr)
                for k, a, b, own in zip(FWD_OUTPUTS, (kpr, kdr, *kfin),
                                        (ppr, pdr, *pfin), own_fwd)]
        gaps = leaf_gaps(kg, pg)
        for k, gap, own in zip(GRAD_KEYS, gaps, own_grad):
            lim = max(prof["leaf"], MAX_GAP_OVER_ROUNDING * own)
            if not gap <= lim:
                raise PhaseError(f"{tag} seg={seg}: grad[{k}] gap {gap:.3e} "
                                 f"to the plain segment pair > {lim:.3e}")
        e_g = max(float((a.reshape(b.shape) - b).abs().max())
                  for a, b in zip(kg, pg))
        err_fwd, err_grad = max(err_fwd, *(e[0] for e in errs)), max(
            err_grad, e_g)
        checks[seg] = dict(fwd_rel_gap=dict(zip(FWD_OUTPUTS,
                                                (e[1] for e in errs))),
                           grad_gap=dict(zip(GRAD_KEYS, gaps)),
                           bitwise_vs_stream_pair=True, bitwise_repeat=True)
        del ck, pck
    if prof["f64"]:
        checks["plain_vs_float64_fwd_gap"] = dict(zip(FWD_OUTPUTS, own_fwd))
        checks["plain_vs_float64_grad_gap"] = dict(zip(GRAD_KEYS, own_grad))
    return checks, err_fwd, err_grad


def phase_seg_kernels(params, data, data16, report, cdt="bfloat16"):
    """(o): the segment pair against its plain versions and, bitwise,
    against the stream pair on the card, at compute dtype ``cdt``: at
    J=K_CHECK in segments of SEG_CHECKS at B=2 and of SEG_LEN at B=16 (the
    main path's shape); timed at J=100 in segments of SEG_LEN, at B=2 and
    B=16."""
    import torch
    from iadmm_tpu_torch.kernels import bounds
    from iadmm_tpu_torch.kernels import train_rollout as tr
    prof = TRAIN_PROFILES[cdt]
    weights, state, dd = train_inputs(params, data)
    B, n = data.p.shape
    m = data.num_constr
    h = HIDDEN
    fa, fr = prof["fwd"]
    tag = "o" + ("" if cdt == "bfloat16" else " float32")
    checks, err_fwd, err_grad = seg_checks(weights, state, dd, SEG_CHECKS,
                                           cdt, tag)
    checks16, e_f, e_g = seg_checks(*train_inputs(params, data16),
                                    (SEG_LEN,), cdt, tag + f" B={SEG_BATCH}")
    err_fwd, err_grad = max(err_fwd, e_f), max(err_grad, e_g)
    torch.cuda.empty_cache()
    # J = K_ITERS in segments of SEG_LEN: times at B=2 and B=16
    J = K_ITERS

    def timings(w, st, dat, reps):
        Bb = st[0].shape[0]
        M = Bb * (n + m)
        dJ = torch.full((Bb, J), 1.0 / (Bb * K_ITERS), device=DEV)
        out = dict(B=Bb)
        out["fwd_ms"] = cuda_ms(lambda: seg_forward(w, st, dat, J, SEG_LEN,
                                                    cdt), reps=reps)
        busy = busy_share(lambda: seg_forward(w, st, dat, J, SEG_LEN, cdt))
        out.update(fwd_device_ms_by_kernel=busy["device_ms_by_kernel"],
                   fwd_device_ms=busy["device_ms"],
                   fwd_wall_ms=busy["wall_ms"],
                   fwd_busy_share=busy["busy_share"])
        *_, fin, ck = seg_forward(w, st, dat, J, SEG_LEN, cdt)
        z0 = tuple(torch.zeros_like(f) for f in fin)
        out["bwd_ms"] = cuda_ms(lambda: seg_backward(w, ck, dat, z0, dJ,
                                                     SEG_LEN, cdt), reps=reps)
        del ck
        out["fwd_plain_ms"], fr_ = warm_ms(
            lambda: seg_forward(w, st, dat, J, SEG_LEN, cdt, plain=True))
        *_, pck = seg_forward(w, st, dat, J, SEG_LEN, cdt, plain=True)
        out["bwd_plain_ms"], br_ = warm_ms(
            lambda: seg_backward(w, pck, dat, z0, dJ, SEG_LEN, cdt,
                                 plain=True))
        out["plain_timing"] = (f"1 warm-up, then {fr_} (fwd) / {br_} (bwd) "
                               f"timed calls")
        del pck
        skw = dict(t0=0, J=J, sigma=SIGMA, compute_dtype=cdt)
        out["stream_fwd_ms"] = cuda_ms(lambda: tr.train_fwd_cuda(
            w, st, dat, **skw), reps=1)
        kstr = tr.train_fwd_cuda(w, st, dat, **skw)[3]
        out["stream_bwd_ms"] = cuda_ms(lambda: tr.train_bwd_cuda(
            w, dat, kstr, z0, dJ, dJ, **skw), reps=1)
        del kstr
        wdt = torch.bfloat16 if cdt == "bfloat16" else torch.float32
        Hk = torch.randn((M, h), device=DEV).to(wdt)
        Uc = params["U"].to(wdt)
        dpre = torch.randn((M, 4 * h), device=DEV).to(wdt)
        out["fwd_library_ms"] = J * cuda_ms(lambda: torch.matmul(Hk, Uc),
                                            reps=10)
        out["bwd_library_ms"] = J * cuda_ms(
            lambda: (torch.matmul(Hk, Uc), torch.matmul(Hk, Uc),
                     torch.matmul(dpre, Uc.T), torch.matmul(Hk.T, dpre)),
            reps=5)
        del Hk, dpre
        out["fwd_bound_ms"], out["fwd_bound_by"] = bounds.train_fwd_seg(
            Bb, J, SEG_LEN, n, m, h, K_ITERS, cdt)
        out["bwd_bound_ms"], out["bwd_bound_by"] = bounds.train_bwd_seg(
            Bb, J, SEG_LEN, n, m, h, K_ITERS, cdt)
        return out

    b2 = timings(weights, state, dd, 2)
    torch.cuda.empty_cache()
    b16 = timings(*train_inputs(params, data16), 1)
    torch.cuda.empty_cache()
    row = dict(shape=dict(B=B, n=n, m=m, h=h, J_check=K_CHECK, J=J,
                          segment_len=SEG_LEN, B_large=SEG_BATCH),
               compute_dtype=cdt, J6_checks=checks,
               J6_checks_B16=checks16,
               max_abs_err_fwd=err_fwd, max_abs_err_grad=err_grad,
               tol=(f"J={K_CHECK}, segments of {SEG_CHECKS} at B={B} and of "
                    f"{SEG_LEN} at B={SEG_BATCH}: losses, final "
                    f"state, every gradient leaf and the start-state "
                    f"cotangents bitwise equal to the stream pair on the "
                    f"card; against the plain segment pair as "
                    f"{prof['tag'][0]}: fwd {fa:g}·max|ref| + {fr:g}|ref|, "
                    f"grads per leaf <= {prof['leaf']:g}"
                    + (" (widened to 4x the plain pair's own float64 gap "
                       "where larger)" if prof["f64"] else "")
                    + "; the segment backward twice bitwise equal"),
               B2=b2, B16=b16,
               library_note=(f"J x torch.matmul in {cdt} (TF32 off): H·U "
                             f"(fwd); H·U twice, dpre·Uᵀ, Hᵀ·dpre (bwd: the "
                             f"recompute and the reverse step): a yardstick "
                             f"of the GEMMs, not of the kernels"))
    say("o segment kernels" + ("" if cdt == "bfloat16" else " float32"),
        **row)
    report["seg_kernels" + ("" if cdt == "bfloat16" else "_f32")] = row


def seg_vs_stream_update(params, data16, cdt):
    """One chunk update (make_train_chunk: loss, backward, Adam) at B=16,
    J=100 on the route the rule picks (segments) and on the stream route,
    from the same params: loss, gradients, updated params and state
    bitwise equal; each route's time and peak device memory."""
    import torch
    from iadmm_tpu_torch.kernels.train_rollout import make_fused_chunk_loss
    from iadmm_tpu_torch.train.harness import make_optimizer, \
        make_train_chunk
    from iadmm_tpu_torch.types import init_state
    B, n = data16.p.shape
    m = data16.num_constr
    rows, res = {}, {}
    for name, route in (("segment", {}), ("stream", dict(stream=True))):
        fn = make_fused_chunk_loss(num_var=n, num_constr=m, batch=B,
                                   hidden=HIDDEN, sigma=SIGMA,
                                   chunk_len=K_ITERS, outer_T=K_ITERS,
                                   K_total=K_ITERS, compute_dtype=cdt,
                                   **route)
        want = (False, SEG_LEN) if name == "segment" else (True, K_ITERS)
        if (fn.stream, fn.segment_len) != want:
            raise PhaseError(f"p {name}: route {fn.stream, fn.segment_len}, "
                             f"expected {want}")
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        st = init_state(B, n, m, HIDDEN, device=DEV)
        body = make_train_chunk(None, make_optimizer(p, 5e-5), K_ITERS,
                                K_ITERS, SIGMA, loss_fn=fn)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        times = []
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new_st, loss = body(p, st, data16, 0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                peak = torch.cuda.max_memory_allocated()
                res[name] = (loss, [p[k].grad.clone() for k in GRAD_KEYS],
                             [p[k].detach().clone() for k in GRAD_KEYS],
                             new_st)
        rows[name] = dict(chunk_update_ms=times,
                          max_memory_allocated_bytes=peak,
                          allocated_before_bytes=before,
                          peak_over_before_bytes=peak - before)
        del p, body, new_st
    (sl, sg, sp, ss), (rl, rg, rp, rs) = res["segment"], res["stream"]
    same = dict(loss=torch.equal(sl, rl),
                grads=all(torch.equal(a, b) for a, b in zip(sg, rg)),
                params=all(torch.equal(a, b) for a, b in zip(sp, rp)),
                state=all(torch.equal(getattr(ss, k), getattr(rs, k))
                          for k in ("x", "y", "z", "xv", "H", "C")))
    if not bool(torch.isfinite(sl)) or not all(same.values()):
        raise PhaseError(f"p {cdt}: segment vs stream chunk update at "
                         f"B={B}: loss {float(sl)} vs {float(rl)}, bitwise "
                         f"equal {same}")
    return dict(batch=B, J=K_ITERS, profile=cdt, loss=float(sl),
                bitwise_equal=same, **{k: v for k, v in rows.items()})


def phase_seg_train(params, data16, report):
    """(p): the shipped config through ``cli.train --train_backend fused
    --batch_size 16`` at both profiles (the segment route, chosen by the
    rule), then one chunk update at B=16 on each route.  Returns the
    launches of each CLI run (the main path)."""
    import glob
    import numpy as np
    import torch
    from iadmm_tpu_torch.cli import train as cli_train
    from iadmm_tpu_torch.problems import generate
    from iadmm_tpu_torch.problems.io import dataset_path, save_npz
    from iadmm_tpu_torch.solvers.cells import lstm_init
    from iadmm_tpu_torch.train import checkpoint as ckpt
    from iadmm_tpu_torch.train.harness import split_ids
    from iadmm_tpu_torch.utils.logging import RunLog
    shutil.rmtree(SEG_DIR, ignore_errors=True)
    root = os.path.join(SEG_DIR, "data")
    os.makedirs(root)
    t0 = time.perf_counter()
    ds = generate("QP", num_var=N_VAR, num_ineq=N_INEQ, num_eq=N_EQ,
                  data_size=SEG_DATA, seed=43)
    save_npz(ds, dataset_path(root, "QP", N_VAR, N_INEQ, N_EQ))
    gen_s = time.perf_counter() - t0
    del ds
    n_train = len(split_ids(SEG_DATA, SEG_VAL, SEG_TEST, 17)[0])
    chunks = n_train // SEG_BATCH
    n_segs = K_ITERS // SEG_LEN
    common = ["--config", FLAGSHIP_CONFIG, "--data_size", str(SEG_DATA),
              "--val_frac", str(SEG_VAL), "--test_frac", str(SEG_TEST),
              "--data_root", root, "--eq_tol", "1e9", "--ineq_tol", "1e9",
              "--train_backend", "fused", "--batch_size", str(SEG_BATCH),
              "--num_epoch", "1"]
    runs, launches = {}, {}
    for cdt, extra in (("float32", []),
                       ("bfloat16", ["--gate_dtype", "bfloat16",
                                     "--matvec_mode", "bf16"])):
        d = os.path.join(SEG_DIR, cdt)
        zero_counts()   # the slice's path, counted from 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_cli(cli_train, common + extra + ["--save_dir", d],
                f"cli_train_seg_{cdt}.txt")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = launch_counts()
        launches[cdt] = counts
        (logfile,) = glob.glob(os.path.join(d, "*", "*.log.jsonl"))
        log = RunLog(logfile).read()
        route = [(r["stream"], r["segment_len"]) for r in log
                 if r["kind"] == "fused_route"]
        losses = [r["train_loss"] for r in log if r["kind"] == "epoch"]
        if route != [(False, SEG_LEN)]:
            raise PhaseError(f"p {cdt}: the fused route was {route}, "
                             f"expected [(False, {SEG_LEN})]")
        if len(losses) != 1 or not all(np.isfinite(losses)):
            raise PhaseError(f"p {cdt}: epoch losses {losses}")
        sfx = "" if cdt == "bfloat16" else "_f32"
        for k in ("train_fwd_seg", "train_bwd_seg"):
            if counts[k + sfx] != chunks * n_segs:
                raise PhaseError(f"p {cdt}: {k + sfx} launched "
                                 f"{counts[k + sfx]} segments, expected "
                                 f"{chunks} chunks x {n_segs}")
        stray = [k for k, v in counts.items() if v and k.startswith("train")
                 and k not in ("train_fwd_seg" + sfx, "train_bwd_seg" + sfx)]
        if stray:
            raise PhaseError(f"p {cdt}: also launched {stray}")
        path = ckpt.checkpoint_path(
            d, os.path.basename(os.path.dirname(logfile)),
            os.path.basename(logfile)[:-len(".log.jsonl")])
        trained = ckpt.load_checkpoint(path)["params"]
        p0 = lstm_init(torch.Generator().manual_seed(17), 2, HIDDEN,
                       K_ITERS, device="cpu")
        moved = max(float(np.abs(np.asarray(trained[k]) - p0[k].numpy())
                          .max()) for k in p0)
        if not moved > 0:
            raise PhaseError(f"p {cdt}: the parameters did not change")
        runs[cdt] = dict(cli_s=secs, fused_route=route, train_loss=losses,
                         chunks=chunks, segments_per_chunk=n_segs,
                         launches={k: v for k, v in counts.items() if v},
                         max_param_change=moved,
                         checkpoint=os.path.relpath(path, ROOT))
    shutil.rmtree(SEG_DIR, ignore_errors=True)
    updates = {cdt: seg_vs_stream_update(params, data16, cdt)
               for cdt in ("bfloat16", "float32")}
    row = dict(config=("configs/qp_1000_500_500.yaml with --train_backend "
                       f"fused --batch_size {SEG_BATCH} --num_epoch 1; "
                       f"{SEG_DATA} generated instances ({n_train} train, "
                       f"val/test fractions {SEG_VAL}/{SEG_TEST}); the fast "
                       "profile adds --gate_dtype bfloat16 --matvec_mode "
                       "bf16"),
               dataset_s=gen_s, cli=runs, chunk_update_B16=updates)
    say("p segment route", **row)
    report["seg_train"] = row
    return launches


# (q): Stage II's condensed-system solvers 'direct' and 'cg'
CG_ITERS, DIRECT_REFINE = 100, 2   # fused_stage2's defaults
Q_TIGHT = 1e-4   # kernel vs plain at the short runs, of max(1, max|ref|)
Q_OUTPUTS = ("x", "y", "z", "xt", "pr", "dr")
# The 'direct' outputs that carry ν = ρ(A0·xt − z) + y: ρ_eq = 1e3·ρ
# multiplies the rounding of xt (its M⁻¹ product, cond(M) ~ 2e5) into y,
# and dr = ‖Qx + p + A0ᵀy‖ carries it.  At the one-step runs the update is
# held on the kernel's own xt: these two to the float64 update within 4x the
# float32 update's own gap (the rounding of A0·xt itself meets ρ_eq there),
# the rest to the float32 update at Q_TIGHT; they are also held to 4x the
# plain twin's own gap under reorderings.
Q_NU_OUTPUTS = ("y", "dr")
# CG iterations of the 'cg' masking run (one polish step at a tolerance
# that stops some instances inside it and not others)
Q_MASK_ITERS = 10


def permuted_polish(plain, data, st, rho, op, seed, **kw):
    """``plain`` on the same polish with the variables and the constraint
    rows reordered (equal in exact arithmetic: only float32 sums run in
    another order), its outputs put back in the original order."""
    import dataclasses
    import torch
    from iadmm_tpu_torch.types import IterState
    B, n = data.p.shape
    m = data.num_constr
    pv = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    pc = torch.randperm(m, generator=torch.Generator().manual_seed(seed + 1))
    pv, pc = pv.to(data.p.device), pc.to(data.p.device)
    d = dataclasses.replace(data, Q=data.Q[:, pv][:, :, pv],
                            A0=data.A0[:, pc][:, :, pv], p=data.p[:, pv],
                            zl=data.zl[:, pc], zu=data.zu[:, pc],
                            eq_mask=data.eq_mask[:, pc])
    s = IterState(x=st.x[:, pv], y=st.y[:, pc], z=st.z[:, pc],
                  xv=torch.cat([st.xv[:, pv], st.xv[:, n:][:, pc]], -1),
                  H=st.H, C=st.C)
    op = op[:, pv][:, :, pv] if op.dim() == 3 else op[:, pv]
    out = plain(s, d, rho[:, pc], op, **kw)
    iv, ic = torch.argsort(pv), torch.argsort(pc)
    return (out[0][:, iv], out[1][:, ic], out[2][:, ic], out[3][:, iv],
            *out[4:])


def direct_yardstick(data, rho, P, b, refine):
    """One 'direct' polish solve on cuBLAS: torch.bmm of the operand by b,
    then ``refine`` passes of r = b − M·xt (three bmm), xt += P·r."""
    import torch
    Q, A0 = data.Q, data.A0
    xt = torch.bmm(P, b[..., None])
    for _ in range(refine):
        mv = (torch.bmm(Q, xt) + SIGMA * xt
              + torch.bmm(A0.mT, rho[..., None] * torch.bmm(A0, xt)))
        xt = xt + torch.bmm(P, b[..., None] - mv)
    return xt


def update_of(xt, data, st, rho, dtype):
    """One polish step's update of a given ``xt`` from ``st`` (ν = ρ(A0·xt −
    z) + y, the z-relaxed ADMM update, the residuals) in ``dtype``:
    ``solvers.cg.exact_step_cg`` with no CG iteration, warm-started from
    ``xt``.  Returns (x, y, z, xt, pr, dr), the traces (B, 1)."""
    import torch
    from iadmm_tpu_torch.evaluation import metrics
    from iadmm_tpu_torch.solvers.cg import exact_step_cg
    from iadmm_tpu_torch.types import IterState
    d = data_as(data, dtype)
    s = IterState(x=st.x.to(dtype), y=st.y.to(dtype), z=st.z.to(dtype),
                  xv=torch.cat([xt, st.xv[:, xt.shape[1]:]], -1).to(dtype),
                  H=st.H, C=st.C)
    out = exact_step_cg(rho.to(dtype), s, d, SIGMA, maxiter=0)
    pr, dr = metrics.primal_dual_residual(out.x, out.y, out.z, d.Q, d.p,
                                          d.A0)
    return out.x, out.y, out.z, xt.to(dtype), pr[:, None], dr[:, None]


def masking_tol(data, st, rho, diag):
    """A tolerance for the 'cg' masking run: the plain ‖r‖/‖b‖ of each
    instance after Q_MASK_ITERS // 2 unmasked CG iterations of the first
    polish step, sorted; the geometric mean of the two neighbours furthest
    apart, so that the instances below it stop inside the run, the others
    do not, and none sits near the bar.  Returns (tol, the ratios)."""
    import torch
    from iadmm_tpu_torch.solvers.cg import (batched_cg, condensed_matvec,
                                            condensed_rhs)
    b = condensed_rhs(data, st.x, st.y, st.z, SIGMA, rho)
    _, r, _ = batched_cg(lambda v: condensed_matvec(data, v, SIGMA, rho), b,
                         st.xv[:, :data.num_var], diag, Q_MASK_ITERS // 2,
                         0.0)
    ratios = sorted((r / torch.linalg.vector_norm(b, dim=-1)).tolist())
    lo, hi = max(zip(ratios, ratios[1:]), key=lambda p: p[1] / p[0])
    return (lo * hi) ** 0.5, ratios


def q_gaps(out, ref, floor):
    """{output: max |out − ref| over max(floor, max|ref|)}"""
    return {k: float((out[i] - ref[i]).abs().max())
            / max(float(ref[i].abs().max()), floor)
            for i, k in enumerate(Q_OUTPUTS)}


def phase_condensed(params, data, sc, xyz, requests, report):
    """(q): Stage II's 'direct' and 'cg' kernels against their plain twins
    at the serving shape (B=8, N=20) from the rollout iterates of (b), the
    public ``fused_stage2(solver='cg')`` on the same iterates, then
    ``make_solver`` with 'fused-direct' and 'cg' serving 3 requests each.
    Returns the main path's launches of each mode."""
    import torch
    from iadmm_tpu_torch.kernels import bounds, stage2_kernel as s2
    from iadmm_tpu_torch.solvers.cg import feasibility_restoration_cg
    from iadmm_tpu_torch.solvers.step import _schedules
    from iadmm_tpu_torch.types import IterState
    x, y, z = xyz
    B, n = data.p.shape
    m, N = data.num_constr, POLISH_STEPS
    st = IterState(x=sc.unscale_x(x), y=sc.unscale_y(y),
                   z=sc.unscale_z(z), xv=torch.cat([x, y], -1),
                   H=x.new_zeros((B, 1, 1)), C=x.new_zeros((B, 1, 1)))
    rho_vec, _ = _schedules(params, K_ITERS - 1, data.eq_mask)
    rho = rho_vec.float() * torch.ones_like(data.zl)
    diag = s2.cg_diag(data, rho, SIGMA)
    mask_tol, mask_ratios = masking_tol(data, st, rho, diag)
    modes = dict(
        direct=dict(form=s2.direct_inverse, kernel=s2.stage2_direct_cuda,
                    plain=s2.stage2_direct_plain, counter="launches_direct",
                    tight=dict(step_refine0=dict(num_iters=1, refine=0),
                               step_refine2=dict(num_iters=1,
                                                 refine=DIRECT_REFINE)),
                    nu_outputs=Q_NU_OUTPUTS,
                    full=dict(num_iters=N, refine=DIRECT_REFINE)),
        cg=dict(form=s2.cg_diag, kernel=s2.stage2_cg_cuda,
                plain=s2.stage2_cg_plain, counter="launches_cg",
                tight=dict(step_3_iters=dict(num_iters=1, cg_iters=3,
                                             tol=1e-8),
                           steps_3_3_iters=dict(num_iters=3, cg_iters=3,
                                                tol=1e-8),
                           step_masked=dict(num_iters=1,
                                            cg_iters=Q_MASK_ITERS,
                                            tol=mask_tol)),
                nu_outputs=(),
                full=dict(num_iters=N, cg_iters=CG_ITERS, tol=1e-8)))
    failures = []
    for solver, md in modes.items():
        op = md["form"](data, rho, SIGMA)
        op_ms = cuda_ms(lambda: md["form"](data, rho, SIGMA), reps=5)

        def run(which, kw, md=md, op=op):
            return md[which](st, data, rho, op, sigma=SIGMA, **kw)

        def own_gaps(ref, kw, floor, md=md, op=op):
            """{output: the plain twin's largest gap to ``ref`` under the
            reorderings, over max(floor, max|ref|)}"""
            perms = [permuted_polish(md["plain"], data, st, rho, op, seed,
                                     sigma=SIGMA, **kw)
                     for seed in PERMUTATIONS]
            own = [q_gaps(p, ref, floor) for p in perms]
            return {k: max(o[k] for o in own) for k in Q_OUTPUTS}

        # Short runs: tight
        tight, short_abs = {}, 0.0
        for name, kw in md["tight"].items():
            out, ref = run("kernel", kw), run("plain", kw)
            short_abs = max([short_abs] + [float((a - b).abs().max())
                                           for a, b in zip(out[:6], ref[:6])])
            t = dict(run=kw, gap=q_gaps(out, ref, 1.0))
            held = {k: t["gap"][k] for k in Q_OUTPUTS
                    if k not in md["nu_outputs"]}
            if kw["num_iters"] == 1:   # the update's arithmetic, on its xt
                u32, u64 = (update_of(out[3], data, st, rho, dt)
                            for dt in (torch.float32, torch.float64))
                t["gap_to_update_of_own_xt"] = q_gaps(out, u32, 1.0)
                held.update({f"{k} (update of own xt)": v for k, v in
                             t["gap_to_update_of_own_xt"].items()
                             if k not in md["nu_outputs"]})
                g64, own64 = q_gaps(out, u64, 1.0), q_gaps(u32, u64, 1.0)
                t["float64_update_gap_and_float32_own"] = {
                    k: (g64[k], own64[k]) for k in md["nu_outputs"]}
                for k in md["nu_outputs"]:
                    if g64[k] > max(Q_TIGHT, MAX_GAP_OVER_ROUNDING * own64[k]):
                        failures.append(
                            f"{solver} {name} {k}: {g64[k]:.3e} from the "
                            f"float64 update of its own xt exceeds "
                            f"{MAX_GAP_OVER_ROUNDING:g}x the float32 "
                            f"update's own {own64[k]:.3e}")
            if md["nu_outputs"]:
                own = own_gaps(ref, kw, 1.0)
                t["plain_own_gap"] = {k: own[k] for k in md["nu_outputs"]}
                for k in md["nu_outputs"]:
                    if t["gap"][k] > max(Q_TIGHT,
                                         MAX_GAP_OVER_ROUNDING * own[k]):
                        failures.append(
                            f"{solver} {name} {k}: {t['gap'][k]:.3e} exceeds "
                            f"{MAX_GAP_OVER_ROUNDING:g}x the plain twin's "
                            f"own {own[k]:.3e}")
            for k, g in held.items():
                if g > Q_TIGHT:
                    failures.append(f"{solver} {name} {k}: {g:.3e} exceeds "
                                    f"{Q_TIGHT:g}")
            if solver == "cg":
                t.update(unmasked_cg_iters=out[6].tolist(),
                         plain_unmasked_cg_iters=ref[6].tolist())
                if not torch.equal(out[6], ref[6]):
                    failures.append(f"cg {name}: unmasked CG iterations "
                                    f"differ from the plain twin's")
            tight[name] = t
        if solver == "cg":
            tight["step_masked"]["ratios_after_half"] = mask_ratios
            its = tight["step_masked"]["unmasked_cg_iters"]
            if len(set(its)) < 2 or min(its) >= Q_MASK_ITERS:
                failures.append(f"cg step_masked: the kernel stopped the "
                                f"instances after {its} iterations")

        # The full run: relative to the plain twin's own rounding
        before = getattr(s2.fused_stage2, md["counter"])
        out = run("kernel", md["full"])
        torch.cuda.synchronize()
        launched = getattr(s2.fused_stage2, md["counter"]) - before
        ref = run("plain", md["full"])
        full_gap = q_gaps(out, ref, 1e-30)
        full_own = own_gaps(ref, md["full"], 1e-30)
        again = run("kernel", md["full"])
        bitwise = all(torch.equal(a, b) for a, b in zip(out, again))
        k_ms = cuda_ms(lambda: run("kernel", md["full"]), reps=2)
        p_ms = cuda_ms(lambda: run("plain", md["full"]), reps=1)
        row = dict(shape=dict(B=B, n=n, m=m, N=N), full_run=md["full"],
                   max_abs_err=short_abs, tight_runs=tight,
                   max_abs_err_full=max(float((a - b).abs().max())
                                        for a, b in zip(out[:6], ref[:6])),
                   full_rel_gap=full_gap, full_plain_own_gap=full_own,
                   tol=(f"short runs: {Q_TIGHT:g}·max(1, max|ref|) per "
                        f"output ('direct' y, dr: on the plain update of the "
                        f"kernel's own xt, and within "
                        f"{MAX_GAP_OVER_ROUNDING:g}x the plain twin's own "
                        f"gap); 'cg': equal unmasked CG iterations; full "
                        f"run: each output within {MAX_GAP_OVER_ROUNDING:g}x "
                        f"the plain twin's own gap under "
                        f"{len(PERMUTATIONS)} reorderings of variables and "
                        f"rows, at least {ROUTE_FLOOR_K:.3e}"),
                   bitwise_repeat=bitwise, launches=launched,
                   kernel_ms=k_ms, plain_ms=p_ms, operand_ms=op_ms,
                   first_primal_res=[float(v) for v in out[4][:, 0]],
                   final_primal_res=[float(v) for v in out[4][:, -1]])
        if solver == "direct":
            b = torch.randn((B, n), generator=torch.Generator().manual_seed(
                9)).cuda()
            row["library_ms"] = N * cuda_ms(lambda: direct_yardstick(
                data, rho, op, b, DIRECT_REFINE), reps=3)
            row["library_note"] = (
                f"yardstick: {N} x (torch.bmm of the operand by b, then "
                f"{DIRECT_REFINE} refine passes of three bmm for M·xt and one "
                f"for P·r)")
            # where the one-time operand's time goes (library calls)
            eye = torch.eye(n, device=data.p.device)
            M = data.Q + SIGMA * eye + data.A0.mT @ (rho[..., None] * data.A0)
            L = torch.linalg.cholesky(M)
            row["operand_parts_ms"] = dict(
                product=cuda_ms(lambda: data.Q + SIGMA * eye + data.A0.mT
                                @ (rho[..., None] * data.A0), reps=3),
                cholesky=cuda_ms(lambda: torch.linalg.cholesky(M), reps=3),
                cholesky_solve=cuda_ms(lambda: torch.cholesky_solve(
                    eye.expand_as(M), L), reps=3),
                linalg_library=str(
                    torch.backends.cuda.preferred_linalg_library()))
            b_ms, b_by = bounds.stage2(B, N, n, m, solver,
                                       refine=DIRECT_REFINE)
        else:
            row["library_ms"] = cuda_ms(lambda: feasibility_restoration_cg(
                st, data, SIGMA, rho_vec, N, CG_ITERS), reps=1)
            row["library_note"] = (
                "solvers/cg.py::feasibility_restoration_cg, plain torch on "
                "cuBLAS matvecs: the same polish, make_solver('cg')'s route")
            iters = out[6]
            iters_per_step = float(iters.float().mean()) / N
            row.update(unmasked_cg_iters=[int(v) for v in iters],
                       plain_unmasked_cg_iters=[int(v) for v in ref[6]],
                       cg_iters_per_step_in_bound=iters_per_step)
            b_ms, b_by = bounds.stage2(B, N, n, m, solver,
                                       cg_iters=iters_per_step)
        row.update(bound_ms=b_ms, bound_by=b_by)
        say(f"q stage2 {solver}", **row)
        report[f"stage2_{solver}"] = row
        for k in Q_OUTPUTS:
            if not full_gap[k] <= max(MAX_GAP_OVER_ROUNDING * full_own[k],
                                      ROUTE_FLOOR_K):
                failures.append(f"{solver} {k}: gap {full_gap[k]:.3e} at "
                                f"N={N} exceeds {MAX_GAP_OVER_ROUNDING:g}x "
                                f"the plain twin's own {full_own[k]:.3e}")
        if launched != N:
            failures.append(f"{solver}: {launched} launches for {N} steps")
        if not bitwise:
            failures.append(f"{solver}: two calls gave different outputs")
    if failures:
        raise PhaseError("q: " + "; ".join(failures))

    # The public kernel entry of 'cg' on the same iterates (the only route
    # to the kernel's 'cg' mode, in the JAX package as well): main path.
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_cg, pr, dr = s2.fused_stage2(st, data, rho_vec, num_iters=N,
                                    solver="cg")
    torch.cuda.synchronize()
    entry_ms = (time.perf_counter() - t0) * 1e3
    cg_path = launch_counts()
    lu = make_lu_polish(data, st, rho_vec)
    row = dict(ms=entry_ms, launches={k: v for k, v in cg_path.items() if v},
               first_primal_res=[float(v) for v in pr[:, 0]],
               final_primal_res=[float(v) for v in pr[:, -1]],
               final_primal_res_lu=[float(v) for v in lu])
    say("q fused_stage2 cg", **row)
    report["fused_stage2_cg"] = row
    if not all(bool(t.isfinite().all()) for t in (st_cg.x, st_cg.y, st_cg.z,
                                                  st_cg.xv, pr, dr)):
        raise PhaseError("q: fused_stage2(solver='cg') is not finite")
    if not bool((pr[:, -1] < pr[:, 0]).all()):
        raise PhaseError("q: fused_stage2(solver='cg') left a primal "
                         "residual above its first step's")

    fast = dict(sigma=SIGMA, use_pallas=True, gate_dtype="bfloat16",
                matvec_mode="bf16", rollout_impl="fused")
    direct_path = phase_serve("q serve fused-direct", params, requests,
                              report, ("stage2_direct", "rollout"),
                              lu64=True, rtol=1e-3,
                              forbid=("stage2", "stage2_cg"),
                              stage2_impl="fused-direct", **fast)
    report["breakdown_direct"] = serve_breakdown(params, requests[1],
                                                 "direct")
    serve_cg(params, requests, report, **fast)
    report["breakdown_cg"] = serve_breakdown(params, requests[1], "cg")
    return dict(direct=direct_path["stage2_direct"],
                cg=cg_path["stage2_cg"])


def serve_cg(params, requests, report, **profile):
    """``make_solver(params, stage2_impl='cg', **profile)`` (plain-torch
    Jacobi CG: no Stage-II kernel) answering the requests.  CG stalls near
    1e-2 relative (the JAX package's remark), so it is not held to the LU
    route, whose residuals are printed beside it: the answers must be
    finite, and every instance's primal residual after the polish below its
    residual after the first polish step (the JAX package's own criterion
    for CG)."""
    import torch
    from iadmm_tpu_torch.api import make_solver
    tag = "q serve cg"
    kw = dict(hidden_dim=HIDDEN, num_iters=K_ITERS,
              feas_rest_num=POLISH_STEPS, stage2_impl="cg", **profile)
    solve = make_solver(params, **kw)
    zero_counts()   # main path: counted from 0
    times, prs = [], []
    for data in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(data)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        for f in ("x", "y", "z", "primal_res", "dual_res", "obj"):
            if not bool(getattr(res, f).isfinite().all()):
                raise PhaseError(f"{tag}: non-finite {f}")
        prs.append(res.primal_res)
    delta = launch_counts()
    first = make_solver(params, **dict(kw, feas_rest_num=1))(
        requests[0]).primal_res
    lu = make_solver(params, **dict(kw, stage2_impl="lu"))(
        requests[0]).primal_res
    row = dict(batch=int(requests[0].batch), ms_per_solve=times,
               launches={k: v for k, v in delta.items() if v},
               final_primal_res_max=float(torch.stack(prs).max()),
               primal_res_req0=[float(v) for v in prs[0]],
               primal_res_req0_after_step1=[float(v) for v in first],
               primal_res_req0_lu=[float(v) for v in lu])
    say(tag, **row)
    if delta["rollout"] <= 0:
        raise PhaseError(f"{tag}: the rollout kernel was not launched")
    for k in ("stage2", "stage2_direct", "stage2_cg"):
        if delta[k]:
            raise PhaseError(f"{tag}: the {k} kernel was launched")
    if not bool((prs[0] < first).all()):
        raise PhaseError(f"{tag}: a primal residual after the polish is not "
                         f"below its first polish step's")
    report[tag] = row


def make_lu_polish(data, st, rho_vec):
    """Primal residuals after the float32 LU Stage II from ``st``."""
    from iadmm_tpu_torch.evaluation import metrics
    from iadmm_tpu_torch.solvers.exact import feasibility_restoration
    out = feasibility_restoration(st, data, SIGMA, rho_vec, POLISH_STEPS)
    pr, _ = metrics.primal_dual_residual(out.x, out.y, out.z, data.Q,
                                         data.p, data.A0, "default")
    return pr


# (r): the canonical QP workload (scripts/run_workload.py's "QP" entry and
# the route it builds, :187-266) through the port's CLIs
CANON_DIR = os.path.join(ROOT, "results", "chip_smoke_canonical")
CANON_DATA, CANON_SEED, CANON_EPS = 24, 17, 1e-4
# scripts/run_workload.py's base config and its "QP" entry; the val and
# test fractions raised to 2 and 4 instances as it raises them (:221-224)
CANON_FLAGS = ("--prob_type", "QP", "--num_var", str(N_VAR), "--num_ineq",
               str(N_INEQ), "--num_eq", str(N_EQ), "--outer_T", "100",
               "--truncated_length", "100", "--hidden_dim", str(HIDDEN),
               "--eq_tol", "0.2", "--ineq_tol", "0.2",
               "--preload_dtype", "bfloat16", "--batch_size", "2",
               "--lr", "5e-5", "--sigma", "6e-6", "--seed", str(CANON_SEED),
               "--patience", "100", "--test_outer_T", "100",
               "--test_batch_size", "10", "--scaling", "true",
               "--use_pallas", "--gate_dtype", "bfloat16",
               "--matvec_mode", "bf16", "--clip_grad_norm", "1.0",
               "--feas_rest_num", "20", "--num_epoch", "1")
# First-epoch train loss and train objective (the last batch's, as the
# harness reports them), preload='always' vs 'never', relative.  'step':
# the stack holds Q as its float32 diagonal, multiplied exactly, where the
# per-batch route rounds Q and the vector to bf16 in every matvec; two
# runs on an NVIDIA H100 80GB HBM3 (700 W) measured 3.96e-5 (loss) and
# 4.8e-5 (objective).  'fused': the kernels round Q and A0 to bf16 on both
# routes, so the losses are bitwise equal; the objective is evaluated with
# the stack's bf16 Q (1.9e-5 measured).  The limit sits 20x above those
# gaps and below what a faulty stack moves (CANON_FAULTS).
CANON_LOSS_RTOL = 1e-3
# The gate's controls: step-route epochs over a stack with a known fault,
# each of which must move the loss or the objective past CANON_LOSS_RTOL:
# the train split stacked in reverse order (batches and labels no longer
# match), and Q's stored diagonal 1% too large.
CANON_FAULTS = ("reversed order", "Q x 1.01")


def cpu_model():
    """The host CPU's model name (``/proc/cpuinfo``, else ``lscpu``) and
    its logical core count."""
    import platform
    name = None
    try:
        with open("/proc/cpuinfo") as f:
            name = next((ln.split(":", 1)[1].strip() for ln in f
                         if ln.lower().startswith("model name")), None)
    except OSError:
        pass
    if not name:
        try:
            out = subprocess.run(["lscpu"], capture_output=True, text=True,
                                 timeout=30).stdout
            name = next((ln.split(":", 1)[1].strip()
                         for ln in out.splitlines()
                         if ln.lower().startswith("model name")), None)
        except (OSError, subprocess.SubprocessError):
            pass
    return (f"{name or 'model not reported'}, {platform.machine()}, "
            f"{os.cpu_count()} logical cores")


def stack_vs_per_batch(ds, cfg):
    """The train split's scaled stacks, as each route stores them (dense
    Q on 'fused'; Q as its float32 diagonal on 'step'; Q and A0 in
    ``cfg.preload_dtype``), against the per-batch scaled batches cast to
    the same dtypes: bitwise or not, and each leaf's largest gap.  The
    diagonal store also needs the per-batch Q to be diagonal
    (``Q_offdiag``)."""
    import torch
    from functools import partial
    from iadmm_tpu_torch.problems.io import split_ids, to_qp_batch
    from iadmm_tpu_torch.scaling import scale_batch
    from iadmm_tpu_torch.train import preload
    train_ids, _, _ = split_ids(cfg.data_size, cfg.val_frac, cfg.test_frac,
                                cfg.seed)
    B = cfg.batch_size
    nb = len(train_ids) // B
    scale = partial(scale_batch, iters=cfg.scaling_ites)
    refs = [scale(to_qp_batch(ds, train_ids[bi * B:(bi + 1) * B],
                              with_metric_views=False, device=DEV))
            for bi in range(nb)]

    def gap(a, b):
        return float((a.to(torch.float32) - b.to(torch.float32)).abs().max())

    out = {}
    for route, diag_q in (("fused", False), ("step", True)):
        stacked, cost = preload.preload_train_stack(
            ds, train_ids[:nb * B], nb, B, cfg, scale, device=DEV,
            diag_q=diag_q)
        gaps = {}
        for bi, (ref, sc) in enumerate(refs):
            got, got_cost = preload.index_stack(stacked, cost, bi, B)
            row = {k: gap(getattr(got, k), getattr(ref, k).to(
                getattr(got, k).dtype))
                for k in ("p", "A0", "zl", "zu", "eq_mask")}
            if diag_q:
                row["Q"] = gap(got.Q, torch.diagonal(ref.Q, 0, -2, -1))
                row["Q_offdiag"] = gap(ref.Q - torch.diag_embed(
                    torch.diagonal(ref.Q, 0, -2, -1)), torch.zeros_like(ref.Q))
            else:
                row["Q"] = gap(got.Q, ref.Q.to(got.Q.dtype))
            row["cost"] = gap(got_cost, sc.cost)
            for k, v in row.items():
                gaps[k] = max(gaps.get(k, 0.0), v)
        out[route] = dict(bitwise=all(v == 0.0 for v in gaps.values()),
                          max_abs_gap=gaps)
        del stacked
    torch.cuda.empty_cache()
    return dict(out, batches=nb)


def phase_canonical(report):
    """(r): the canonical QP workload at full width through the CLIs:
    generate and label with the native oracle, one epoch on each training
    route over the preloaded bf16 stack, ``cli.test --baseline osqp``;
    then the same epochs at preload='never' for the gate, and the gate's
    controls (CANON_FAULTS) on the step route.  Returns the
    launches of the main path (generation, the two preloaded epochs and
    the evaluation) and what (t) evaluates: the CLI flags, the step run's
    directory and checkpoint, the dataset and its config."""
    import dataclasses
    import re
    import numpy as np
    import torch
    from iadmm_tpu_torch import native
    from iadmm_tpu_torch.cli import config_parser, parse_config, \
        generate_data as cli_gen, test as cli_test, train as cli_train
    from iadmm_tpu_torch.problems.io import dataset_path, load_dataset
    from iadmm_tpu_torch.train import checkpoint as ckpt, harness
    from iadmm_tpu_torch.train.preload import device_memory_budget
    from iadmm_tpu_torch.utils.logging import RunLog
    shutil.rmtree(CANON_DIR, ignore_errors=True)
    root = os.path.join(CANON_DIR, "data")
    if not native.available():
        raise PhaseError("r: the native QP oracle did not build")

    zero_counts()   # the canonical workload's path, counted from 0
    label_s = []
    real_label = cli_gen.label_dataset

    def timed_label(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real_label(*a, **kw)
        finally:
            label_s.append(time.perf_counter() - t0)

    cli_gen.label_dataset = timed_label
    try:
        t0 = time.perf_counter()
        gen_text = run_cli(cli_gen, [
            "--prob_type", "QP", "--num_var", str(N_VAR), "--num_ineq",
            str(N_INEQ), "--num_eq", str(N_EQ), "--data_size",
            str(CANON_DATA), "--seed", str(CANON_SEED), "--eps",
            str(CANON_EPS), "--data_root", root], "canon_generate.txt")
        gen_s = time.perf_counter() - t0
    finally:
        cli_gen.label_dataset = real_label
    solved = re.search(r"native oracle: (\d+)/(\d+) solved, mean ([0-9.]+) "
                       r"iters", gen_text)
    if not solved or len(label_s) != 1:
        raise PhaseError(f"r: the dataset was not labelled by the native "
                         f"oracle: {gen_text[-300:]}")
    ds = load_dataset(root, "QP", N_VAR, N_INEQ, N_EQ, 0, CANON_DATA)
    n = ds.size
    if ds.x_opt is None or n < 12:
        raise PhaseError(f"r: {n} labelled instances")
    val_frac = 2.0 / n if int(n * 0.01) < 2 else 0.01
    test_frac = 4.0 / n if int(n * 0.05) < 4 else 0.05
    common = list(CANON_FLAGS) + ["--data_size", str(n), "--val_frac",
                                  str(val_frac), "--test_frac",
                                  str(test_frac), "--data_root", root]
    cfg = parse_config(config_parser("").parse_args(common))
    budget = device_memory_budget(DEV)

    def train_run(backend, preload, tag=None):
        tag = tag or f"{backend}_{preload}"
        d = os.path.join(CANON_DIR, tag)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        text = run_cli(cli_train, common + [
            "--train_backend", backend, "--preload", preload,
            "--save_dir", d], f"canon_train_{tag}.txt")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log = RunLog(os.path.join(d, cfg.model_name,
                                  cfg.run_name() + ".log.jsonl")).read()
        epochs = [r for r in log if r["kind"] == "epoch"]
        pre = [r for r in log if r["kind"] == "preload"]
        if len(epochs) != 1 or not np.isfinite(epochs[0]["train_loss"]):
            raise PhaseError(f"r {backend}/{preload}: epochs {epochs}")
        line = next((ln.strip() for ln in text.splitlines()
                     if ln.startswith("preloaded train split")), None)
        return dict(dir=d, cli_s=wall, train_s=epochs[0]["train_time"],
                    val_s=epochs[0]["val_time"],
                    train_loss=epochs[0]["train_loss"],
                    train_obj=epochs[0]["train_obj"],
                    val_obj=epochs[0]["val_obj"],
                    preload=pre[0] if pre else None, preload_line=line,
                    peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    runs = {}
    for backend in ("step", "fused"):
        runs[(backend, "always")] = train_run(backend, "always")
    step_path = ckpt.checkpoint_path(runs[("step", "always")]["dir"],
                                     cfg.model_name, cfg.run_name())
    load = (step_path if os.path.exists(step_path)
            else ckpt.latest_path(step_path))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    test_text = run_cli(cli_test, common + [
        "--save_dir", runs[("step", "always")]["dir"], "--load_path", load,
        "--baseline", "osqp"], "canon_test.txt")
    test_s = time.perf_counter() - t0
    launches = launch_counts()

    # the comparison runs: the same epochs on the per-batch route
    for backend in ("step", "fused"):
        runs[(backend, "never")] = train_run(backend, "never")
    stack = stack_vs_per_batch(ds, cfg)

    # the gate's controls: step epochs over a deliberately faulty stack
    real_stack = harness.preload_train_stack

    def reversed_order(ds_, ids, *a, **kw):
        return real_stack(ds_, ids[::-1].copy(), *a, **kw)

    def q_too_large(*a, **kw):
        stacked, cost = real_stack(*a, **kw)
        return dataclasses.replace(stacked, Q=stacked.Q * 1.01), cost

    controls = {}
    for name, fault in zip(CANON_FAULTS, (reversed_order, q_too_large)):
        harness.preload_train_stack = fault
        try:
            controls[name] = train_run(
                "step", "always", "step_fault_" + name.split()[0])
        finally:
            harness.preload_train_stack = real_stack

    n_train = int(n * (1 - val_frac - test_frac))
    chunks = n_train // cfg.batch_size
    for k in ("train_fwd", "train_bwd"):
        if launches[k] != chunks * cfg.truncated_length:
            raise PhaseError(f"r: {k} launched {launches[k]} steps, "
                             f"expected {chunks} chunks x "
                             f"{cfg.truncated_length}")
    if launches["cell"] <= 0:
        raise PhaseError("r: the step route did not launch the cell kernel")
    for k, v in launches.items():
        if v and k not in ("cell", "train_fwd", "train_bwd"):
            raise PhaseError(f"r: the bf16 profile launched {k}")
    for (backend, preload), r in runs.items():
        want = None if preload == "never" else (backend == "step")
        got = None if r["preload"] is None else r["preload"]["diag_q"]
        if got != want:
            raise PhaseError(f"r {backend}/{preload}: preload record "
                             f"{r['preload']}, expected diag_q {want}")
        if preload == "always" and r["preload"]["dtype"] != "bfloat16":
            raise PhaseError(f"r {backend}: stack dtype {r['preload']}")
    base = re.search(r"OSQP-baseline \(native batch\): (\d+)/(\d+) solved "
                     r"\| mean ([0-9.]+) iters \| mean ([0-9.]+) "
                     r"ms/instance", test_text)
    if not base or "Parallel Time" not in test_text:
        raise PhaseError(f"r: cli.test output: {test_text[-400:]}")
    def rel_gaps(a, b):
        return {k: abs(a[k] - b[k]) / abs(b[k])
                for k in ("train_loss", "train_obj")}

    gaps = {backend: rel_gaps(runs[(backend, "always")],
                              runs[(backend, "never")])
            for backend in ("step", "fused")}
    fault_gaps = {name: rel_gaps(r, runs[("step", "never")])
                  for name, r in controls.items()}
    row = dict(
        config=("scripts/run_workload.py 'QP' (QP 1000/500/500, h=800, "
                "outer_T = truncated_length = 100, B=2, lr 5e-5, use_pallas, "
                "bf16 gates and matvecs, preload_dtype bfloat16, clip 1.0); "
                f"cuts: {n} instances (seed {CANON_SEED}), val/test "
                f"fractions {val_frac:.4f}/{test_frac:.4f}, 1 epoch a route, "
                "untrained weights"),
        host_cpu=cpu_model(), generate_cli_s=gen_s, label_s=label_s[0],
        label_s_per_instance=label_s[0] / CANON_DATA,
        oracle=dict(backend="native", solved=int(solved.group(1)),
                    total=int(solved.group(2)),
                    mean_iters=float(solved.group(3)), eps=CANON_EPS),
        budget_gb=budget / 1e9,
        runs={f"{b}/{p}": {k: v for k, v in r.items() if k != "dir"}
              for (b, p), r in runs.items()},
        test_cli_s=test_s,
        timing_line=next((ln.strip() for ln in test_text.splitlines()
                          if "Parallel Time" in ln), None),
        baseline=dict(solved=int(base.group(1)), total=int(base.group(2)),
                      mean_iters=float(base.group(3)),
                      ms_per_instance=float(base.group(4))),
        launches={k: v for k, v in launches.items() if v},
        stack_vs_per_batch=stack, gap_always_vs_never=gaps,
        controls={name: dict(gap_vs_never=fault_gaps[name],
                             train_s=r["train_s"])
                  for name, r in controls.items()},
        tol=(f"first-epoch train loss and train objective, preload "
             f"'always' vs 'never': {CANON_LOSS_RTOL:g} relative, the "
             f"fused route's loss bitwise; each stack bitwise the "
             f"per-batch scaled batches in its dtypes; each control past "
             f"{CANON_LOSS_RTOL:g} in the loss or the objective"))
    say("r canonical QP", **row)
    for route in ("step", "fused"):
        if not stack[route]["bitwise"]:
            raise PhaseError(f"r {route}: the stack differs from the "
                             f"per-batch scaled batches: {stack[route]}")
        for k, g in gaps[route].items():
            if not g <= CANON_LOSS_RTOL:
                raise PhaseError(f"r {route}: {k} gap {g:.3e} always vs "
                                 f"never exceeds {CANON_LOSS_RTOL:g}")
    if gaps["fused"]["train_loss"] != 0.0:
        raise PhaseError(f"r fused: loss gap {gaps['fused']['train_loss']:.3e}"
                         f" always vs never over bitwise-equal operands")
    for name, g in fault_gaps.items():
        if not max(g.values()) > CANON_LOSS_RTOL:
            raise PhaseError(f"r control '{name}': a faulty stack moves the "
                             f"step route only {g}, inside the gate")
    if row["baseline"]["solved"] != row["baseline"]["total"]:
        raise PhaseError(f"r: the baseline solved {row['baseline']}")
    report["canonical"] = row
    # (t) evaluates the step run's checkpoint on this dataset; main() removes
    # CANON_DIR after it
    return launches, dict(common=common, save_dir=runs[("step", "always")]
                          ["dir"], load=load, ds=ds, cfg=cfg)


# (s): the ghost cells (the reference's ablations) at the flagship's width
GHOST_DIR = os.path.join(ROOT, "results", "chip_smoke_ghost")
GHOST_CELLS = ("gru", "safeguard_lstm", "multi_layer_lstm", "gd",
               "indirect_lstm")
# 20 generated instances: 8 train (4 chunk updates of B=2), 2 val, 10 test
GHOST_DATA, GHOST_VAL, GHOST_TEST, GHOST_TEST_B = 20, 0.1, 0.5, 10
# multi_layer_lstm applies the cell 5 times a step: at J=100 autograd would
# keep ~75 GB; it trains in chunks of 20 steps (5 chunk updates a batch)
GHOST_J = dict(multi_layer_lstm=20)
# The card's float32 K=6 rollout against the card's float64 one, each state
# field's gap over max(1, max|ref|), to the larger of GHOST_F32_RTOL
# (tests/test_torch_ghost.py's F32_K6_RTOL, which holds the CPU's float32
# rollout to float64) and MAX_GAP_OVER_ROUNDING x the float32 rollout's own
# gap with its hidden units permuted.  At this width indirect_lstm's float32
# rollout is ill-conditioned: its feature g = M(Mx̃ − rhs) carries
# rho_eq·A0ᵀA0 twice, and gates near 0 flip (the CPU measured 1.9e-2 on H,
# its permuted run 1.6e-2; the other cells <= 1.5e-5, y)
GHOST_F32_RTOL = 5e-4
# The gate's controls, each a faulty step that must miss GHOST_F32_RTOL:
# safeguard_lstm with α = 2σ(0) = 1.0 (an alpha schedule of zeros) in place
# of the fixed 1.6, and indirect_lstm with the ν block A0ᵀdiag(ρ)A0 dropped
# from its reduced matrix M
GHOST_FAULTS = ("safeguard_lstm alpha=2*sigmoid(0)",
                "indirect_lstm M without the nu block")


def ghost_k6(name, params, data, faulty=None, perm=None):
    """{field: gap} of the port's float32 K=6 rollout of cell ``name``
    against its float64 one, both on the card, from ``params``: max |f32 −
    f64| / max(1, max |f64|).  ``faulty`` runs one of GHOST_FAULTS in the
    float32 rollout; ``perm`` runs it with the hidden units permuted (its
    own rounding: the same function, float32 sums in another order)."""
    import contextlib
    import dataclasses
    from unittest import mock
    import torch
    from iadmm_tpu_torch.solvers import rollouts, step as S
    from iadmm_tpu_torch.types import init_state
    spec = S.get_cell(name)
    B, n, m = data.batch, data.num_var, data.num_constr
    p32 = dict(params)
    if perm is not None:
        p32 = permute_hidden(p32, perm)
    patch = contextlib.nullcontext()
    if faulty == GHOST_FAULTS[0]:
        p32["alpha"] = torch.zeros_like(params["rho"])
    elif faulty == GHOST_FAULTS[1]:
        def no_nu_block(d, x, y, z, sigma, rho_vec):
            def matvec_M(v):
                return S.bmv(d.Q, v) + sigma * v
            return matvec_M, sigma * x - d.p + S.bmv_t(d.A0,
                                                        rho_vec * z - y)
        patch = mock.patch.object(S, "indirect_system", no_nu_block)
    st32 = init_state(B, n, m, HIDDEN, device=DEV)
    with torch.no_grad():
        with patch:
            a = rollouts.rollout(spec.step, p32, st32, data, SIGMA, K_CHECK)
        b = rollouts.rollout(spec.step, {k: v.double()
                                         for k, v in params.items()},
                             data_as(st32, torch.float64),
                             data_as(data, torch.float64), SIGMA, K_CHECK)
    if perm is not None:   # the permuted network's unit j is unit perm[j]
        b = dataclasses.replace(b, H=b.H[..., perm], C=b.C[..., perm])
    return {f: float((getattr(a, f).double() - getattr(b, f)).abs().max()
                     / max(1.0, float(getattr(b, f).abs().max())))
            for f in ("x", "y", "z", "xv", "H", "C")}


def phase_ghost(report):
    """(s): each ghost cell at QP 1000/500/500, h=800, float32: one epoch of
    ``harness.train`` (4 chunk updates of B=2, J=100, or J=20 for
    multi_layer_lstm), ``run_test`` at K=100, B=10 on its parameters, every
    trace finite; the float32 K=6 rollout held to the float64 one on the
    card at GHOST_F32_RTOL, and GHOST_FAULTS missing it."""
    import numpy as np
    import torch
    from iadmm_tpu_torch.config import ExperimentConfig
    from iadmm_tpu_torch.evaluation.driver import run_test
    from iadmm_tpu_torch.problems import generate
    from iadmm_tpu_torch.problems.io import split_ids
    from iadmm_tpu_torch.scaling import scale_batch
    from iadmm_tpu_torch.solvers.step import get_cell
    from iadmm_tpu_torch.train.harness import train
    shutil.rmtree(GHOST_DIR, ignore_errors=True)
    n_train = len(split_ids(GHOST_DATA, GHOST_VAL, GHOST_TEST, 17)[0])
    t0 = time.perf_counter()
    ds = generate("QP", num_var=N_VAR, num_ineq=N_INEQ, num_eq=N_EQ,
                  data_size=GHOST_DATA, seed=43)
    gen_s = time.perf_counter() - t0
    data, _ = scale_batch(qp_batch(TRAIN_BATCH, seed=44))
    perm = torch.randperm(HIDDEN, generator=torch.Generator().manual_seed(3))
    rows, faults = {}, {}
    for name in GHOST_CELLS:
        J = GHOST_J.get(name, K_ITERS)
        cfg = ExperimentConfig(
            prob_type="QP", num_var=N_VAR, num_ineq=N_INEQ, num_eq=N_EQ,
            data_size=GHOST_DATA, model_name=name, hidden_dim=HIDDEN,
            sigma=SIGMA, outer_T=K_ITERS, truncated_length=J,
            batch_size=TRAIN_BATCH, lr=5e-5, num_epoch=1,
            val_frac=GHOST_VAL, test_frac=GHOST_TEST, eq_tol=1e9,
            test_outer_T=K_ITERS, test_batch_size=GHOST_TEST_B,
            save_dir=os.path.join(GHOST_DIR, name))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = train(cfg, ds, verbose=False, device=DEV)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_peak = torch.cuda.max_memory_allocated()
        if any(v.device.type != torch.device(DEV).type
               for v in res.params.values()):
            raise PhaseError(f"s {name}: parameters left the card")
        t0 = time.perf_counter()
        rep = run_test(cfg, ds, res.params, verbose=False, device=DEV)
        test_s = time.perf_counter() - t0
        traces = [rep.obj, rep.ls_res, rep.primal_res, rep.dual_res,
                  *rep.violations.values()]
        hist = res.history[0]
        if not (np.isfinite(hist["train_loss"]) and all(
                np.isfinite(t).all() for t in traces)):
            raise PhaseError(f"s {name}: non-finite loss or trace")
        if rep.test_size != GHOST_TEST_B:
            raise PhaseError(f"s {name}: test size {rep.test_size}")
        p0 = get_cell(name).init(torch.Generator().manual_seed(7), 2, HIDDEN,
                                 K_ITERS, device=DEV)
        gaps = ghost_k6(name, p0, data)
        own = ghost_k6(name, p0, data, perm=perm) if "W" in p0 else {}
        limit = max([GHOST_F32_RTOL] + [MAX_GAP_OVER_ROUNDING * v
                                        for v in own.values()])
        rows[name] = dict(
            chunk_len=J, chunk_updates=n_train // TRAIN_BATCH * (K_ITERS // J),
            train_s=train_s, epoch_train_s=hist["train_time"],
            val_s=hist["val_time"], train_loss=hist["train_loss"],
            train_peak_gb=train_peak / 1e9, run_test_s=test_s,
            run_test_total_s=rep.total_time,
            parallel_s_per_instance=rep.parallel_time,
            last_row=rep.row(K_ITERS - 1), k6_gap=gaps,
            k6_gap_permuted=own, k6_limit=limit)
        for fault in GHOST_FAULTS:
            if fault.startswith(name + " "):
                faults[fault] = dict(limit=limit, gap=ghost_k6(
                    name, p0, data, faulty=fault))
        del res, rep
    row = dict(
        config=(f"QP {N_VAR}/{N_INEQ}/{N_EQ}, h={HIDDEN}, float32 (plain "
                f"cells, float32 matvecs), K = outer_T = {K_ITERS}, train "
                f"B={TRAIN_BATCH}, lr 5e-5, 1 epoch, run_test B="
                f"{GHOST_TEST_B}; cuts: {GHOST_DATA} generated instances "
                f"(seed 43), untrained weights, multi_layer_lstm at J="
                f"{GHOST_J['multi_layer_lstm']}"),
        generate_s=gen_s, cells=rows, controls=faults,
        tol=(f"every loss and trace finite; the card's float32 K={K_CHECK} "
             f"rollout against its float64 one, each state field's gap "
             f"over max(1, max|f64|) to the larger of {GHOST_F32_RTOL:g} and "
             f"{MAX_GAP_OVER_ROUNDING:g}x the float32 rollout's own gap "
             f"with permuted hidden units; each control past its cell's "
             f"limit"))
    say("s ghost cells", **row)
    for name, r in rows.items():
        worst = max(r["k6_gap"].values())
        if not worst <= r["k6_limit"]:
            raise PhaseError(f"s {name}: float32 vs float64 K={K_CHECK} gap "
                             f"{worst:.3e} exceeds {r['k6_limit']:.3e}: "
                             f"{r['k6_gap']}")
    for fault, f in faults.items():
        if not max(f["gap"].values()) > f["limit"]:
            raise PhaseError(f"s control '{fault}' passes the gate: {f}")
    if set(faults) != set(GHOST_FAULTS):
        raise PhaseError(f"s: controls run {sorted(faults)}")
    report["ghost"] = row
    shutil.rmtree(GHOST_DIR, ignore_errors=True)


# (t): the theory traces of the canonical profile on (r)'s dataset.  The
# smallest eigenvalue of A0ᵀA0 (m = n = 1000, Gaussian rows) sits near the
# float32 rounding of the product: held to float64 numpy in absolute terms,
# EIG_ATOL of the largest eigenvalue (a backward-stable float32 solver on the
# float32 product lands within a few float32 ulps of λmax); the relative gap
# and cond(A0ᵀA0) are reported.
EIG_ATOL = 1e-5
THEORY_EXPORT = "theory.mat"


def phase_theory(ctx, report):
    """(t): ``cli.test --theory --export`` on (r)'s step checkpoint at the
    canonical bf16 profile (use_pallas, bf16 gates and matvecs, K=100):
    the traces' shapes, t=0 NaN and finiteness, the cell kernel's launches;
    then the theory rollout's iterates against the evaluation rollout's
    (bitwise) on the first test batch, and sigma_Q_max / sigma_AA_min of
    each batch's instance 0 against float64 numpy.  Returns the launches of
    the CLI run."""
    import numpy as np
    import scipy.io
    import torch
    from functools import partial
    from iadmm_tpu_torch.cli import test as cli_test
    from iadmm_tpu_torch.evaluation import theory
    from iadmm_tpu_torch.problems.io import split_ids, to_qp_batch
    from iadmm_tpu_torch.scaling import scale_batch
    from iadmm_tpu_torch.solvers import rollouts
    from iadmm_tpu_torch.solvers.step import make_lstm_step
    from iadmm_tpu_torch.train import checkpoint as ckpt
    from iadmm_tpu_torch.types import init_state
    cfg, ds = ctx["cfg"], ctx["ds"]
    out = os.path.join(CANON_DIR, THEORY_EXPORT)
    zero_counts()   # the theory run's path, counted from 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    text = run_cli(cli_test, ctx["common"] + [
        "--save_dir", ctx["save_dir"], "--load_path", ctx["load"],
        "--theory", "--export", out], "theory_test.txt")
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = launch_counts()
    _, _, test_ids = split_ids(cfg.data_size, cfg.val_frac, cfg.test_frac,
                               cfg.seed)
    bs = cfg.test_batch_size
    nb = max(len(test_ids) // bs, 1)
    test_ids = test_ids[:nb * bs]
    T = cfg.test_outer_T
    # the warm-up batch's rollout, then each batch's evaluation and theory
    # rollouts, all through the cell kernel
    if launches["cell"] != T * (1 + 2 * nb):
        raise PhaseError(f"t: the cell kernel launched {launches['cell']} "
                         f"steps, expected {T} x (1 + 2 x {nb})")
    mat = scipy.io.loadmat(out)
    shapes = {k: list(mat[k].shape) for k in theory.COND_KEYS}
    for k in theory.COND_KEYS:
        v = mat[k]
        want = ((T, len(test_ids)) if k in theory.PER_INSTANCE_KEYS
                else (1, T))
        if v.shape != want:
            raise PhaseError(f"t: {k} exported as {v.shape}, not {want}")
        v = v if k in theory.PER_INSTANCE_KEYS else v.T
        if not np.isnan(v[0]).all() or not np.isfinite(v[1:]).all():
            raise PhaseError(f"t: {k} is not NaN at t=0 and finite after")

    # the theory rollout's iterates against the evaluation rollout's
    params = {k: torch.as_tensor(np.asarray(v), device=DEV)
              for k, v in ckpt.load_checkpoint(ctx["load"])["params"].items()}
    step = make_lstm_step(use_pallas=True, gate_dtype="bfloat16",
                          matvec_mode="bf16")
    scale = partial(scale_batch, iters=cfg.scaling_ites)

    def recording(states):
        def rec(*a):
            states.append(step(*a))
            return states[-1]
        return rec

    data = to_qp_batch(ds, test_ids[:bs], device=DEV)
    scaled, sc = scale(data)
    ev, th = [], []
    with torch.no_grad():
        st0 = init_state(data.batch, data.num_var, data.num_constr,
                         cfg.hidden_dim, device=DEV)
        rollouts.eval_rollout(recording(ev), params, st0, scaled, data, sc,
                              cfg.sigma, T)
        theory.theory_rollout(recording(th), params, st0, scaled, data, sc,
                              cfg.sigma, T)
    unequal = [(t, f) for t, (a, b) in enumerate(zip(ev, th))
               for f in ("x", "y", "z", "xv", "H", "C")
               if not torch.equal(getattr(a, f), getattr(b, f))]
    if len(ev) != T or len(th) != T or unequal:
        raise PhaseError(f"t: theory iterates differ from the evaluation's "
                         f"at (step, field) {unequal[:5]}")
    del ev, th

    # the eigenvalues against float64 numpy, and the conditioning
    eigs = []
    for bi in range(nb):
        d = to_qp_batch(ds, test_ids[bi * bs:(bi + 1) * bs], device=DEV)
        q32, aa32 = (float(v) for v in theory.extreme_eigs(d))
        Q0 = d.Q[0].double().cpu().numpy()
        A0 = d.A0[0].double().cpu().numpy()
        ev_q = np.linalg.eigvalsh(Q0)
        ev_aa = np.linalg.eigvalsh(A0.T @ A0)
        eigs.append(dict(
            sigma_Q_max=q32, sigma_Q_max_f64=float(ev_q[-1]),
            sigma_AA_min=aa32, sigma_AA_min_f64=float(ev_aa[0]),
            sigma_AA_max_f64=float(ev_aa[-1]),
            cond_AA=float(ev_aa[-1] / ev_aa[0]),
            aa_min_abs_gap_of_max=abs(aa32 - ev_aa[0]) / ev_aa[-1],
            aa_min_rel_gap=abs(aa32 - ev_aa[0]) / abs(ev_aa[0]),
            q_max_rel_gap=abs(q32 - ev_q[-1]) / abs(ev_q[-1])))
    row = dict(
        config=("scripts/run_workload.py 'QP' at its bf16 profile "
                f"(use_pallas, bf16 gates and matvecs), K={T}, on (r)'s "
                f"dataset and step checkpoint; {len(test_ids)} test "
                f"instances in {nb} batch(es)"),
        cli_s=cli_s, launches={k: v for k, v in launches.items() if v},
        export_shapes=shapes, iterates_bitwise=True, eigenvalues=eigs,
        timing_line=next((ln.strip() for ln in text.splitlines()
                          if "Parallel Time" in ln), None),
        tol=(f"traces (T, B) / (1, T), NaN at t=0, finite after; the "
             f"theory rollout's iterates bitwise the evaluation's; "
             f"sigma_Q_max and sigma_AA_min to {EIG_ATOL:g} x the largest "
             f"eigenvalue of their float64 matrix"))
    say("t theory", **row)
    for e in eigs:
        if not e["aa_min_abs_gap_of_max"] <= EIG_ATOL:
            raise PhaseError(f"t: sigma_AA_min {e['sigma_AA_min']:.6e} vs "
                             f"float64 {e['sigma_AA_min_f64']:.6e} at "
                             f"cond {e['cond_AA']:.3e}")
        if not (abs(e["sigma_Q_max"] - e["sigma_Q_max_f64"])
                <= EIG_ATOL * abs(e["sigma_Q_max_f64"])):
            raise PhaseError(f"t: sigma_Q_max {e}")
    report["theory"] = row
    return launches


# (u): the BCOO sparse route at scripts/run_workload.py's Sparse_QP
BCOO_DIR = os.path.join(ROOT, "results", "chip_smoke_bcoo")
BCOO_N, BCOO_MI, BCOO_H = 1000, 500, 400
# 16 generated instances: 4 train (2 chunk updates of B=2), 2 val, 10 test
BCOO_DATA, BCOO_VAL, BCOO_TEST = 16, 0.125, 0.625
BCOO_FLAGS = ("--prob_type", "Sparse_QP", "--num_var", str(BCOO_N),
              "--num_ineq", str(BCOO_MI), "--outer_T", str(K_ITERS),
              "--truncated_length", str(K_ITERS), "--hidden_dim",
              str(BCOO_H), "--eq_tol", "0.5", "--sparse", "--num_devices",
              "1", "--batch_size", str(TRAIN_BATCH), "--test_batch_size",
              "10", "--test_outer_T", str(K_ITERS), "--matvec_mode", "bf16",
              "--sigma", str(SIGMA), "--num_epoch", "1", "--data_size",
              str(BCOO_DATA), "--val_frac", str(BCOO_VAL), "--test_frac",
              str(BCOO_TEST))


def bcoo_matvec_times(ds):
    """Device ms of each BCOO matvec (Q, A0, A0ᵀ; B=2 and 10) beside the
    BSR kernel's on the same scaled operands (bf16 and float32 tiles),
    launches queued behind a sleep (``queued_ms``)."""
    import numpy as np
    import torch
    from iadmm_tpu_torch.kernels.sparse import from_dense
    from iadmm_tpu_torch.problems.io import to_qp_batch
    from iadmm_tpu_torch.scaling import scale_batch
    rows = []
    for B in (TRAIN_BATCH, 10):
        scaled, _ = scale_batch(to_qp_batch(ds, np.arange(B), device=DEV))
        routes = dict(bcoo=from_dense(scaled, fmt="bcoo"),
                      bsr_bf16=from_dense(scaled, fmt="bsr",
                                          dtype=torch.bfloat16),
                      bsr_f32=from_dense(scaled, fmt="bsr"))
        g = torch.Generator().manual_seed(B)
        for op, width in (("Qv", BCOO_N), ("Av", BCOO_N), ("ATv", BCOO_MI)):
            v = torch.randn((B, width), generator=g).to(DEV)
            row = dict(B=B, op=op, nse=dict(Q=routes["bcoo"].Q.nse,
                                            A0=routes["bcoo"].A0.nse))
            for name, sp in routes.items():
                fn = getattr(sp, op)
                row[f"{name}_ms"] = queued_ms(lambda: fn(v), reps=20,
                                              sleep_ms=100.0)
            ref = getattr(routes["bsr_f32"], op)(v)
            row["bcoo_vs_bsr_f32_max_rel"] = float(
                (getattr(routes["bcoo"], op)(v) - ref).abs().max()
                / ref.abs().max())
            rows.append(row)
    return rows


def phase_bcoo(report):
    """(u): Sparse_QP (n=1000, 500 box rows, h=400, K=100, bf16 matvecs) on
    the BCOO route through the CLIs: ``cli.train`` (one epoch, twice) and
    ``cli.test`` (twice), each pair bitwise equal, no kernel launched; the
    BCOO traces against ``run_test`` on the BSR route with float32 tiles
    (the same values, sums in another order) and with bf16 tiles; the
    BCOO matvec times beside the BSR kernel's; the device's busy share of a
    chunk update and of a test rollout."""
    import dataclasses
    import numpy as np
    import torch
    from functools import partial
    from iadmm_tpu_torch.cli import config_parser, parse_config, \
        test as cli_test, train as cli_train
    from iadmm_tpu_torch.evaluation.driver import run_test
    from iadmm_tpu_torch.kernels.sparse import eval_rollout_sparse, \
        from_dense, make_sparse_chunk_loss
    from iadmm_tpu_torch.problems import generate
    from iadmm_tpu_torch.problems.io import dataset_path, load_dataset, \
        save_npz, split_ids, to_qp_batch
    from iadmm_tpu_torch.scaling import scale_batch
    from iadmm_tpu_torch.train import checkpoint as ckpt
    from iadmm_tpu_torch.train.harness import make_optimizer, \
        make_train_chunk
    from iadmm_tpu_torch.train.preload import preload_sparse_cache
    from iadmm_tpu_torch.types import init_state
    from iadmm_tpu_torch.utils.logging import RunLog
    shutil.rmtree(BCOO_DIR, ignore_errors=True)
    root = os.path.join(BCOO_DIR, "data")
    os.makedirs(root)
    t0 = time.perf_counter()
    ds = generate("Sparse_QP", num_var=BCOO_N, num_ineq=BCOO_MI,
                  data_size=BCOO_DATA, seed=47)
    save_npz(ds, dataset_path(root, "Sparse_QP", BCOO_N, BCOO_MI))
    gen_s = time.perf_counter() - t0
    common = list(BCOO_FLAGS) + ["--data_root", root]
    cfg = parse_config(config_parser("").parse_args(common))

    zero_counts()   # the BCOO route's path, counted from 0
    runs = []
    for i in range(2):
        d = os.path.join(BCOO_DIR, f"run{i}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        text = run_cli(cli_train, common + ["--save_dir", d],
                       f"bcoo_train_{i}.txt")
        torch.cuda.synchronize()
        train_cli_s = time.perf_counter() - t0
        path = ckpt.checkpoint_path(d, cfg.model_name, cfg.run_name())
        load = path if os.path.exists(path) else ckpt.latest_path(path)
        export = os.path.join(BCOO_DIR, f"traces{i}.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        test_text = run_cli(cli_test, common + [
            "--save_dir", d, "--load_path", load, "--export", export],
            f"bcoo_test_{i}.txt")
        torch.cuda.synchronize()
        test_cli_s = time.perf_counter() - t0
        log = RunLog(os.path.join(d, cfg.model_name,
                                  cfg.run_name() + ".log.jsonl")).read()
        epoch = next(r for r in log if r["kind"] == "epoch")
        runs.append(dict(
            train_cli_s=train_cli_s, test_cli_s=test_cli_s,
            epoch_train_s=epoch["train_time"], val_s=epoch["val_time"],
            train_loss=epoch["train_loss"], load=load,
            params=ckpt.load_checkpoint(load)["params"],
            traces=dict(np.load(export)),
            cache_line=next((ln.strip() for ln in text.splitlines()
                             if ln.startswith("sparse train cache")), None),
            timing_line=next((ln.strip() for ln in test_text.splitlines()
                              if "Parallel Time" in ln), None)))
    launches = launch_counts()
    if any(launches.values()):
        raise PhaseError(f"u: the BCOO route launched kernels {launches}")
    if not runs[0]["cache_line"] or "(bcoo" not in runs[0]["cache_line"]:
        raise PhaseError(f"u: no BCOO train cache: {runs[0]['cache_line']}")
    a, b = runs
    bitwise = dict(
        train_loss=a["train_loss"] == b["train_loss"],
        params=all(np.array_equal(a["params"][k], b["params"][k])
                   for k in a["params"]),
        traces=all(np.array_equal(a["traces"][k], b["traces"][k])
                   for k in a["traces"] if k not in ("time", "total_time")))
    if not all(np.isfinite(v).all() for k, v in a["traces"].items()):
        raise PhaseError("u: non-finite BCOO trace")

    # the BSR route on the same checkpoint, and the BCOO route with its
    # hidden units permuted (its own rounding over K=100)
    ds = load_dataset(root, "Sparse_QP", BCOO_N, BCOO_MI, 0, 0, BCOO_DATA)
    params = a["params"]
    bcoo_rep = run_test(cfg, ds, params, verbose=False, device=DEV)
    reps = {
        "bsr_f32": run_test(dataclasses.replace(cfg, sparse_format="bsr",
                                                matvec_mode="highest"),
                            ds, params, verbose=False, device=DEV),
        "bsr_bf16": run_test(dataclasses.replace(cfg, sparse_format="bsr"),
                             ds, params, verbose=False, device=DEV)}
    perm = torch.randperm(BCOO_H, generator=torch.Generator().manual_seed(3))
    pp = permute_hidden({k: torch.as_tensor(v) for k, v in params.items()},
                        perm)
    reps["bcoo_perm"] = run_test(cfg, ds, {k: v.numpy()
                                           for k, v in pp.items()},
                                 verbose=False, device=DEV)
    if not np.array_equal(bcoo_rep.x_final, a["traces"]["x"]):
        raise PhaseError("u: run_test differs from the CLI's export")
    keys4 = ("obj", "primal_res", "dual_res", "ls_res")
    keys3 = keys4[:3]
    gaps = dict(
        bsr_f32_first6=trace_gap(bcoo_rep, reps["bsr_f32"], keys4, K_CHECK),
        bsr_f32_K100=trace_gap(bcoo_rep, reps["bsr_f32"], keys3),
        own_perm_K100=trace_gap(reps["bcoo_perm"], bcoo_rep, keys3),
        bsr_bf16_first6=trace_gap(bcoo_rep, reps["bsr_bf16"], keys4,
                                  K_CHECK),
        bsr_bf16_K100=trace_gap(bcoo_rep, reps["bsr_bf16"], keys3))

    # times: the matvecs alone, and the busy share of a chunk update and of
    # a test batch's rollout
    mv = bcoo_matvec_times(ds)
    train_ids, _, test_ids = split_ids(cfg.data_size, cfg.val_frac,
                                       cfg.test_frac, cfg.seed)
    scale = partial(scale_batch, iters=cfg.scaling_ites)
    (data, _), = preload_sparse_cache(ds, train_ids[:TRAIN_BATCH], 1,
                                      TRAIN_BATCH, cfg, scale, device=DEV)
    p = {k: torch.as_tensor(v, device=DEV).requires_grad_(True)
         for k, v in params.items()}
    body = make_train_chunk(
        None, make_optimizer(p, cfg.lr), cfg.outer_T, K_ITERS, cfg.sigma,
        loss_fn=make_sparse_chunk_loss(cfg.sigma, K_ITERS, cfg.outer_T))
    st = init_state(TRAIN_BATCH, BCOO_N, BCOO_MI, BCOO_H, device=DEV)
    chunk = busy_share(lambda: body(p, st, data, 0), top=8)
    orig = to_qp_batch(ds, test_ids[:10], device=DEV)
    sd, sc = scale(orig)
    sp = from_dense(sd, fmt="bcoo")
    pt = {k: torch.as_tensor(v, device=DEV) for k, v in params.items()}
    st10 = init_state(10, BCOO_N, BCOO_MI, BCOO_H, device=DEV)

    def rollout():
        with torch.no_grad():
            eval_rollout_sparse(pt, st10, sp, orig, sc, cfg.sigma, K_ITERS)

    test_roll = busy_share(rollout, top=8)
    row = dict(
        config=("scripts/run_workload.py 'Sparse_QP' (n=1000, 500 box rows, "
                "h=400, K = outer_T = 100, B=2, sparse_format bcoo, single "
                "device) at matvec_mode bf16, test B=10; cuts: "
                f"{BCOO_DATA} generated instances (seed 47), val/test "
                f"fractions {BCOO_VAL}/{BCOO_TEST}, 1 epoch, untrained "
                "weights"),
        generate_s=gen_s,
        runs=[{k: v for k, v in r.items()
               if k not in ("params", "traces", "load")} for r in runs],
        bitwise_two_runs=bitwise, launches=launches,
        run_test_s={"bcoo": bcoo_rep.total_time,
                    **{k: r.total_time for k, r in reps.items()}},
        gaps=gaps, matvec_ms=mv,
        chunk_update=chunk, test_rollout_B10=test_roll,
        tol=(f"two CLI runs bitwise equal (loss, params, traces); BCOO vs "
             f"BSR with float32 tiles: every trace to {ROUTE_RTOL_6} of "
             f"max|ref| over the first {K_CHECK} steps, obj/primal/dual "
             f"over K={K_ITERS} within {MAX_GAP_OVER_ROUNDING:g}x the BCOO "
             f"route's own gap under a hidden-unit permutation (at least "
             f"{ROUTE_FLOOR_K:.3e}); BSR with bf16 tiles (the data rounded "
             f"to bf16, the BCOO values float32 as in the JAX package): "
             f"primal, dual and ls_res to {PROFILE_RTOL_6} over the first "
             f"{K_CHECK} steps, reported"))
    say("u bcoo", **row)
    if not all(bitwise.values()):
        raise PhaseError(f"u: two BCOO runs differ: {bitwise}")
    for k in keys4:
        if not gaps["bsr_f32_first6"][k] <= ROUTE_RTOL_6:
            raise PhaseError(f"u: {k} BCOO vs BSR float32 "
                             f"{gaps['bsr_f32_first6'][k]:.3e} in "
                             f"{K_CHECK} steps")
    for k in keys4[1:]:
        if not gaps["bsr_bf16_first6"][k] <= PROFILE_RTOL_6:
            raise PhaseError(f"u: {k} BCOO vs BSR bf16 "
                             f"{gaps['bsr_bf16_first6'][k]:.3e}")
    for k in keys3:
        if not gaps["bsr_f32_K100"][k] <= max(
                MAX_GAP_OVER_ROUNDING * gaps["own_perm_K100"][k],
                ROUTE_FLOOR_K):
            raise PhaseError(f"u: {k} BCOO vs BSR float32 over K={K_ITERS}: "
                             f"{gaps['bsr_f32_K100'][k]:.3e} against the "
                             f"own gap {gaps['own_perm_K100'][k]:.3e}")
    report["bcoo"] = row
    shutil.rmtree(BCOO_DIR, ignore_errors=True)
    return launches


# Rows 3, 3d, 3c of PERF.md §6: one N=20 call of each Stage-II solver at
# B=8 from the serving rollout's iterates (as phases (c) and (q))
STAGE2_ROWS = (
    ("3 stage2 kkt", "kkt", dict(num_iters=POLISH_STEPS, sigma=SIGMA,
                                 refine=0)),
    ("3d stage2 direct", "direct", dict(num_iters=POLISH_STEPS, sigma=SIGMA,
                                        refine=DIRECT_REFINE)),
    ("3c stage2 cg", "cg", dict(num_iters=POLISH_STEPS, sigma=SIGMA,
                                cg_iters=CG_ITERS, tol=1e-8)))


def stage2_iterates(params):
    """(data, state, rho) of Stage II at the serving shape: the fused
    rollout's iterates of the B=8 batch of seed 1, unscaled, and the last
    step's ρ."""
    import torch
    from iadmm_tpu_torch.kernels import rollout_kernel as rk
    from iadmm_tpu_torch.scaling import scale_batch
    from iadmm_tpu_torch.solvers.step import _schedules
    from iadmm_tpu_torch.types import IterState
    data = qp_batch(SERVE_BATCH, seed=1)
    scaled, sc = scale_batch(data)
    x, y, z = rk.fused_rollout(params, scaled, hidden=HIDDEN, K=K_ITERS,
                               sigma=SIGMA)
    B = x.shape[0]
    st = IterState(x=sc.unscale_x(x), y=sc.unscale_y(y), z=sc.unscale_z(z),
                   xv=torch.cat([x, y], -1), H=x.new_zeros((B, 1, 1)),
                   C=x.new_zeros((B, 1, 1)))
    rho_vec, _ = _schedules(params, K_ITERS - 1, data.eq_mask)
    return data, st, rho_vec.float() * torch.ones_like(data.zl)


def stage2_call(solver, data, rho):
    """(the solver's CUDA wrapper, its operand) for ``data`` and ``rho``."""
    from iadmm_tpu_torch.kernels import stage2_kernel as s2
    form, fn = dict(kkt=(s2.kkt_inverse, s2.stage2_cuda),
                    direct=(s2.direct_inverse, s2.stage2_direct_cuda),
                    cg=(s2.cg_diag, s2.stage2_cg_cuda))[solver]
    return fn, form(data, rho, SIGMA)


def snapshot_stage2(params, out):
    """The Stage-II outputs that ``compare`` holds bitwise: each solver's
    N=20 call of rows 3, 3d, 3c ('cg' with its unmasked-iteration counts),
    'kkt' at refine 1 and 'direct' at refine 0, from the serving rollout's
    iterates."""
    data, st, rho = stage2_iterates(params)
    extra = (("kkt", dict(STAGE2_ROWS[0][2], refine=1)),
             ("direct", dict(STAGE2_ROWS[1][2], refine=0)))
    for solver, kw in [(s, kw) for _, s, kw in STAGE2_ROWS] + list(extra):
        fn, op = stage2_call(solver, data, rho)
        tag = ", ".join(f"{k}={v}" for k, v in kw.items()
                        if k not in ("sigma", "tol"))
        out[f"stage2 {solver} {tag}"] = fn(st, data, rho, op, **kw)
        del op


SP_SNAP_SEED = 29   # the Sparse_QP_Large instances of --snapshot/--time-rows


def sparse_snapshot_batches(B_big):
    """(raw dataset, {B: (data, scaled data, scaling)} for B = SP_TRAIN_B
    and ``B_big``) of Sparse_QP_Large instances generated from
    SP_SNAP_SEED: the first SP_TRAIN_B, and the ``B_big`` after them."""
    import numpy as np
    from iadmm_tpu_torch.problems import generate, to_qp_batch
    from iadmm_tpu_torch.scaling import scale_batch
    ds = generate("Sparse_QP", num_var=SP_N, num_ineq=SP_MI,
                  data_size=SP_TRAIN_B + B_big, seed=SP_SNAP_SEED)
    out = {}
    for B, ids in ((SP_TRAIN_B, np.arange(SP_TRAIN_B)),
                   (B_big, np.arange(SP_TRAIN_B, SP_TRAIN_B + B_big))):
        data = to_qp_batch(ds, ids, device=DEV)
        out[B] = (data, *scale_batch(data))
    return ds, out


def snapshot_bsr(out):
    """The BSR outputs that ``compare`` holds bitwise, built only from
    ``bsr_matvec``, ``bsr_matvec_ad``, ``chunk_loss_sparse`` and
    ``eval_rollout_sparse``: each single product (Q, A0, A0ᵀ; bf16 and
    float32 tiles; TM 8 and 128) and its VJP at B=2; a J=6 chunk loss at
    B=2 on the route's (8, 128) bf16 tiles with its final state and every
    gradient; a K=6 eval_rollout_sparse at B=10: (x, y, z) and the
    traces."""
    import dataclasses
    import torch
    from iadmm_tpu_torch.kernels import sparse as tsp
    from iadmm_tpu_torch.kernels import sparse_matvec as tsm
    from iadmm_tpu_torch.solvers.cells import lstm_init
    from iadmm_tpu_torch.types import IterState, init_state
    _, batches = sparse_snapshot_batches(SP_TEST_B)
    _, small, _ = batches[SP_TRAIN_B]
    g = torch.Generator().manual_seed(14)
    for dt in (torch.bfloat16, torch.float32):
        for tm in (8, 128):
            Q = tsm.bsr_from_dense(small.Q, (tm, 128), dt, device=DEV)
            A, AT = tsm.bsr_pair_from_dense(small.A0, (tm, 128), dt,
                                            device=DEV)
            for nm, M, MT in (("Q", Q, Q), ("A0", A, AT), ("A0T", AT, A)):
                m, n = M.shape
                v = torch.randn((SP_TRAIN_B, n), generator=g).to(DEV)
                w = torch.randn((SP_TRAIN_B, m), generator=g).to(DEV)
                vg = v.clone().requires_grad_(True)
                (tsm.bsr_matvec_ad(M, MT, vg) * w).sum().backward()
                out[f"bsr {nm} {str(dt)[6:]} TM={tm} B={SP_TRAIN_B}"] = (
                    tsm.bsr_matvec(M, v), vg.grad)
            del Q, A, AT
    fields = [f.name for f in dataclasses.fields(IterState)]
    params = lstm_init(torch.Generator().manual_seed(0), 2, SP_H, SP_K,
                       device=DEV)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    data = tsp.from_dense(small, fmt="bsr", tile=SP_TILE,
                          dtype=torch.bfloat16)
    st = init_state(SP_TRAIN_B, SP_N, SP_MI, SP_H, device=DEV)
    loss, fin = tsp.chunk_loss_sparse(p, st, data, SIGMA, K_CHECK, SP_K, 0)
    loss.backward()
    out[f"bsr chunk loss J={K_CHECK} B={SP_TRAIN_B}"] = (
        loss.detach(), *(getattr(fin, f).detach() for f in fields),
        *(p[k].grad for k in GRAD_KEYS))
    del data, fin, loss
    orig, scaled, sc = batches[SP_TEST_B]
    data = tsp.from_dense(scaled, fmt="bsr", tile=SP_TILE,
                          dtype=torch.bfloat16)
    with torch.no_grad():
        fin, tr = tsp.eval_rollout_sparse(
            params, init_state(SP_TEST_B, SP_N, SP_MI, SP_H, device=DEV),
            data, orig, sc, SIGMA, K_CHECK)
    out[f"bsr eval K={K_CHECK} B={SP_TEST_B}"] = (
        fin.x, fin.y, fin.z, tr.obj, tr.primal_res, tr.dual_res, tr.ls_res)
    torch.cuda.empty_cache()


def snapshot(path):
    """Save this checkout's outputs that ``compare`` holds bitwise."""
    import torch
    from iadmm_tpu_torch.api import make_solver
    from iadmm_tpu_torch.kernels import _build
    from iadmm_tpu_torch.kernels import lstm_cell as lc
    from iadmm_tpu_torch.kernels import rollout_kernel as rk
    from iadmm_tpu_torch.kernels import train_rollout as ttr
    from iadmm_tpu_torch.scaling import scale_batch
    from iadmm_tpu_torch.solvers.cells import lstm_init
    _build.build_all()
    params = lstm_init(torch.Generator().manual_seed(0), 2, HIDDEN, K_ITERS,
                       device="cuda")
    out = {}
    g = torch.Generator().manual_seed(11)
    bf, f32 = torch.bfloat16, torch.float32
    for B, S, h, hc in ((SERVE_BATCH, N_VAR + N_INEQ + N_EQ, HIDDEN, bf),
                        (2, RAGGED_S, HIDDEN, bf), (2, 37, 20, f32),
                        (2, 40, 16, bf), (2, 37, 44, bf), (2, 300, 64, f32)):
        keys, x, H, C = cell_case(params, B, S, h, hc, g)
        out[f"cell B={B} S={S} h={h} {hc}"] = lc.cell_forward(
            *keys, x, H, C, "bfloat16")
    # the float32-gate cell: the flagship shape with both state dtypes,
    # ragged shapes
    for B, S, h, hc in ((SERVE_BATCH, N_VAR + N_INEQ + N_EQ, HIDDEN, f32),
                        (SERVE_BATCH, N_VAR + N_INEQ + N_EQ, HIDDEN, bf),
                        (2, RAGGED_S, RAGGED_H, f32), (2, 37, 20, f32),
                        (2, 133, 44, bf)):
        keys, x, H, C = cell_case(params, B, S, h, hc, g)
        out[f"cell f32 B={B} S={S} h={h} {hc}"] = lc.cell_forward(
            *keys, x, H, C, "float32")
    # the serving rollout's own (x, y, z): the flagship batch at K=6 and
    # K=100, and its two ragged shapes (S = 1037 with h = 808; h = 212)
    scaled, _ = scale_batch(qp_batch(SERVE_BATCH, seed=1))
    for K in (K_CHECK, K_ITERS):
        out[f"rollout B={SERVE_BATCH} K={K}"] = rk.fused_rollout(
            params, scaled, hidden=HIDDEN, K=K, sigma=SIGMA)
    for n, mi, me, h in ROLLOUT_RAGGED:
        p = lstm_init(torch.Generator().manual_seed(1), 2, h, K_ITERS,
                      device="cuda")
        d = scale_batch(qp_batch(2, seed=3, n=n, mi=mi, me=me))[0]
        out[f"rollout B=2 S={n + mi + me} h={h} K={K_ITERS}"] = \
            rk.fused_rollout(p, d, hidden=h, K=K_ITERS, sigma=SIGMA)
    scaled, _ = scale_batch(qp_batch(TRAIN_BATCH, seed=2))
    w, st, dd = train_inputs(params, scaled)
    pr, dr, final, _ = ttr.train_fwd_cuda(w, st, dd, t0=0, J=K_CHECK,
                                          sigma=SIGMA)
    out["train_fwd J=6"] = (pr, dr, *final)
    # the float32 training pair at J=6: losses, final state, every gradient
    # and the start-state cotangents; then the segment pair in segments of 2
    f32kw = dict(sigma=SIGMA, compute_dtype="float32")
    pr, dr, final, streams = ttr.train_fwd_cuda(w, st, dd, t0=0, J=K_CHECK,
                                                **f32kw)
    gd = torch.Generator().manual_seed(12)
    dpr = torch.rand(pr.shape, generator=gd).to(DEV)
    ddr = torch.rand(dr.shape, generator=gd).to(DEV)
    dfin = tuple((0.1 * torch.randn(f.shape, generator=gd)).to(DEV)
                 for f in final)
    grads, dst = ttr.train_bwd_cuda(w, dd, streams, dfin, dpr, ddr, t0=0,
                                    J=K_CHECK, **f32kw)
    del streams
    out["train_fwd f32 J=6"] = (pr, dr, *final)
    out["train_bwd f32 J=6"] = (*grads, *dst)
    pr, dr, final, ckpts = seg_forward(w, st, dd, K_CHECK, SEG_LEN,
                                       "float32")
    acc = seg_backward(w, ckpts, dd, dfin, dpr, SEG_LEN, "float32")
    del ckpts
    out["train_fwd_seg f32 J=6"] = (pr, dr, *final)
    out["train_bwd_seg f32 J=6"] = (*acc[0], *acc[1])
    # the J=100 forward at both profiles; one segment call at B=16
    for cdt in ("bfloat16", "float32"):
        pr, dr, final, _ = ttr.train_fwd_cuda(w, st, dd, t0=0, J=K_ITERS,
                                              sigma=SIGMA, compute_dtype=cdt)
        out[f"train_fwd {cdt} J=100"] = (pr, dr, *final)
        del final
    torch.cuda.empty_cache()
    w16, st16, dd16 = train_inputs(params, scale_batch(
        qp_batch(SEG_BATCH, seed=5))[0])
    pr, dr, final = ttr.train_fwd_seg_cuda(w16, st16, dd16, t0=0, J=SEG_LEN,
                                           sigma=SIGMA)
    out[f"train_fwd_seg bf16 B={SEG_BATCH}"] = (pr, dr, *final)
    del w16, st16, dd16, final
    torch.cuda.empty_cache()
    kw = dict(hidden_dim=HIDDEN, num_iters=K_ITERS,
              feas_rest_num=POLISH_STEPS, sigma=SIGMA, use_pallas=True,
              gate_dtype="bfloat16", matvec_mode="bf16",
              stage2_impl="fused", rollout_impl="fused")
    req = qp_batch(SERVE_BATCH, seed=100)
    for name, k in (("serve fused", kw),
                    ("serve lu", dict(kw, stage2_impl="lu")),
                    ("serve before stage2", dict(kw, feas_rest_num=0))):
        r = make_solver(params, **k)(req)
        out[name] = tuple(getattr(r, f) for f in ("x", "y", "z",
                                                  "primal_res"))
    r = make_solver(params, hidden_dim=HIDDEN, num_iters=K_ITERS,
                    feas_rest_num=POLISH_STEPS, sigma=SIGMA,
                    use_pallas=True)(req)
    out["serve float32"] = tuple(getattr(r, f) for f in ("x", "y", "z",
                                                         "primal_res"))
    snapshot_stage2(params, out)
    snapshot_bsr(out)
    torch.save({k: [t.cpu() for t in v] for k, v in out.items()}, path)
    return 0


def time_rows(path):
    """Time this checkout's rows of the PERF.md §6 table at its shapes and
    write them to ``path`` as JSON: the cell (1, 1f), the rollout (2),
    Stage II 'kkt', 'direct', 'cg' (3, 3d, 3c; each call's device ms by
    kernel and busy share; 'kkt' also on a row-major operand, 'cg' also
    with a new argument set each call), the stream pair at B=2 (4, 4f, 5,
    5f) and the segment pair at B=16 (6, 6f, 7, 7f) over J=100, a
    fused chunk update at B=2 at both profiles (three in a row), solves
    of B=8 at both profiles (three requests, twice; a solve's device
    breakdown, the 'fused' solve by stage six times, and Ã⁻¹'s formation
    alone six times), the rollout's and the forward's device breakdown
    and busy share, then row 8 and the BSR route (``time_rows_bsr``).
    Run in two checkouts, in turns, to compare them on one card."""
    import torch
    from iadmm_tpu_torch.api import make_solver
    from iadmm_tpu_torch.kernels import _build
    from iadmm_tpu_torch.kernels import lstm_cell as lc
    from iadmm_tpu_torch.kernels import rollout_kernel as rk
    from iadmm_tpu_torch.kernels import stage2_kernel as s2
    from iadmm_tpu_torch.kernels import train_rollout as tr
    from iadmm_tpu_torch.kernels.train_rollout import make_fused_chunk_loss
    from iadmm_tpu_torch.scaling import scale_batch
    from iadmm_tpu_torch.solvers.cells import lstm_init
    from iadmm_tpu_torch.train.harness import make_optimizer, \
        make_train_chunk
    from iadmm_tpu_torch.types import init_state
    _build.build_all()
    out = dict(card=torch.cuda.get_device_name(0))
    params = lstm_init(torch.Generator().manual_seed(0), 2, HIDDEN, K_ITERS,
                       device="cuda")
    g = torch.Generator().manual_seed(13)
    S0 = N_VAR + N_INEQ + N_EQ
    for gate, key in (("bfloat16", "1"), ("float32", "1f")):
        keys, x, H, C = cell_case(params, SERVE_BATCH, S0, HIDDEN,
                                  torch.float32, g)
        out[f"{key} cell"] = cuda_ms(
            lambda: lc.cell_forward(*keys, x, H, C, gate), reps=20)
        del keys, x, H, C
    # serving: the rollout, then Stage II from its iterates
    data = qp_batch(SERVE_BATCH, seed=1)
    scaled, _ = scale_batch(data)
    out["2 rollout"] = cuda_ms(lambda: rk.fused_rollout(
        params, scaled, hidden=HIDDEN, K=K_ITERS, sigma=SIGMA), reps=3)
    out["2 rollout busy"] = rollout_breakdown(lambda: rk.fused_rollout(
        params, scaled, hidden=HIDDEN, K=K_ITERS, sigma=SIGMA))
    data, st2, rho = stage2_iterates(params)
    for key, solver, kw in STAGE2_ROWS:
        fn, op = stage2_call(solver, data, rho)
        if solver == "kkt":
            # Ã⁻¹ as torch.linalg.inv returns it (column-major), so that the
            # row's time holds the copy to row-major in every checkout
            # (made in the wrapper, or where the operand is formed); beside
            # it the kernel alone on a row-major operand
            rows = op.contiguous()
            op = op.mT.contiguous().mT
            out[f"{key}, row-major operand"] = cuda_ms(
                lambda: fn(st2, data, rho, rows, **kw), reps=2)
            del rows
        out[key] = cuda_ms(lambda: fn(st2, data, rho, op, **kw), reps=2)
        # the call's device ms by kernel and the device's busy share
        out[f"{key} busy"] = busy_share(
            lambda: fn(st2, data, rho, op, **kw), top=16)
        if solver == "cg":
            # each call with another tolerance than the last: a CUDA graph
            # of the CG loop is captured and instantiated anew each call
            tols = itertools.cycle((kw["tol"], 1.01 * kw["tol"]))
            out[f"{key}, graph captured each call"] = cuda_ms(
                lambda: fn(st2, data, rho, op, **dict(kw, tol=next(tols))),
                reps=2)
        del op
    torch.cuda.empty_cache()
    # training: the stream pair at B=2, the segment pair at B=16
    sc2, _ = scale_batch(qp_batch(TRAIN_BATCH, seed=2))
    w, st, dd = train_inputs(params, sc2)
    for cdt, f in (("bfloat16", ""), ("float32", "f")):
        kw = dict(t0=0, J=K_ITERS, sigma=SIGMA, compute_dtype=cdt)
        out[f"4{f} train_fwd"] = cuda_ms(
            lambda: tr.train_fwd_cuda(w, st, dd, **kw), reps=3)
        out[f"4{f} train_fwd busy"] = busy_share(
            lambda: tr.train_fwd_cuda(w, st, dd, **kw))
        pr, _, fin, streams = tr.train_fwd_cuda(w, st, dd, **kw)
        z0 = tuple(torch.zeros_like(t) for t in fin)
        dJ = torch.full(pr.shape, 1.0 / (pr.shape[0] * K_ITERS), device=DEV)
        out[f"5{f} train_bwd"] = cuda_ms(lambda: tr.train_bwd_cuda(
            w, dd, streams, z0, dJ, dJ, **kw), reps=3)
        del streams, fin
        torch.cuda.empty_cache()
    w16, st16, dd16 = train_inputs(params, scale_batch(
        qp_batch(SEG_BATCH, seed=5))[0])
    for cdt, f in (("bfloat16", ""), ("float32", "f")):
        out[f"6{f} seg fwd B=16"] = cuda_ms(lambda: seg_forward(
            w16, st16, dd16, K_ITERS, SEG_LEN, cdt), reps=2)
        pr, _, fin, ck = seg_forward(w16, st16, dd16, K_ITERS, SEG_LEN, cdt)
        z0 = tuple(torch.zeros_like(t) for t in fin)
        dJ = torch.full(pr.shape, 1.0 / (pr.shape[0] * K_ITERS), device=DEV)
        out[f"7{f} seg bwd B=16"] = cuda_ms(lambda: seg_backward(
            w16, ck, dd16, z0, dJ, SEG_LEN, cdt), reps=2)
        del ck, fin
        torch.cuda.empty_cache()
    del w16, st16, dd16
    # a fused chunk update (fwd + bwd + Adam) at B=2, three in a row
    B, n = sc2.p.shape
    m = sc2.num_constr
    for cdt in ("bfloat16", "float32"):
        fused = make_fused_chunk_loss(num_var=n, num_constr=m, batch=B,
                                      hidden=HIDDEN, sigma=SIGMA,
                                      chunk_len=K_ITERS, outer_T=K_ITERS,
                                      K_total=K_ITERS, compute_dtype=cdt)
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in params.items()}
        s0 = init_state(B, n, m, HIDDEN, device=DEV)
        body = make_train_chunk(None, make_optimizer(p, 5e-5), K_ITERS,
                                K_ITERS, SIGMA, loss_fn=fused)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            body(p, s0, sc2, 0)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"chunk update {cdt}"] = times
    # solves of B=8: the fast profile ('fused' rollout and Stage II) and
    # the float32 one (step route over the float32 cell)
    kw = dict(hidden_dim=HIDDEN, num_iters=K_ITERS,
              feas_rest_num=POLISH_STEPS, sigma=SIGMA, use_pallas=True)
    for name, extra in (("solve bfloat16", dict(
            gate_dtype="bfloat16", matvec_mode="bf16", stage2_impl="fused",
            rollout_impl="fused")), ("solve float32", {})):
        solve = make_solver(params, **kw, **extra)
        times = []
        for r in range(6):   # the three requests twice
            req = qp_batch(SERVE_BATCH, seed=100 + r % 3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve(req)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = times
        # what spreads a solve: its device ms by kernel, and Ã⁻¹'s
        # formation alone (the batched LU inverse; six calls, CUDA events)
        out[f"{name} busy"] = busy_share(lambda: solve(req), top=16)
    # the 'fused' solve by stage (Ruiz, rollout, Ã⁻¹, Stage II), the three
    # requests twice
    out["solve bfloat16 breakdown"] = [
        serve_breakdown(params, qp_batch(SERVE_BATCH, seed=100 + r % 3))
        for r in range(6)]
    out["kkt_inverse"] = [cuda_ms(lambda: s2.kkt_inverse(data, rho, SIGMA),
                                  reps=1, warmup=int(i == 0))
                          for i in range(6)]
    torch.cuda.empty_cache()
    time_rows_bsr(out)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


def bsr_device_us(fn, reps, flush=None):
    """Device µs a call of ``fn`` spends in the BSR kernel, from one
    profiled run of ``reps`` calls (each after ``flush()``, where given):
    the kernel's own time, without launch gaps or host cost.  The mean of
    the launches the profiler recorded (it can drop a few) times the
    launches a call makes."""
    from iadmm_tpu_torch.kernels import sparse_matvec as tsm
    before = tsm.bsr_matvec.launches
    fn()
    per_call = tsm.bsr_matvec.launches - before

    def run():
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
    by_kernel, _ = device_time_by_kernel(run, top=64)
    rows = [r for k, r in by_kernel.items() if "bsr_matvec_kernel" in k]
    return (1e3 * sum(r["ms"] for r in rows)
            / max(sum(r["calls"] for r in rows), 1) * per_call)


def time_rows_bsr(out):
    """Row 8 and the BSR route at Sparse_QP_Large ((8, 128) bf16 tiles),
    into ``out``: one Q product's device µs warm (back to back) at B=2 and
    cold (each after an L2 flush) at B=10, from the profiler's kernel
    times, and as Python launches it back to back (paced: host clock over
    50 calls, the wrapper included); the step's first group (A0·u, A0ᵀ·ν,
    Q·u) the same ways (a checkout without the grouped launch runs the
    three products as single launches); a chunk update at B=2, J=50 (three
    in a row; its device ms by kernel, busy share and BSR launches); three
    ``run_test`` calls at B=10, K=50 with Stage II (Parallel Time, Stage
    II's seconds, BSR launches)."""
    import numpy as np
    import torch
    from iadmm_tpu_torch.evaluation.driver import run_test
    from iadmm_tpu_torch.kernels import sparse_matvec as tsm
    from iadmm_tpu_torch.solvers.cells import lstm_init
    ds, batches = sparse_snapshot_batches(SP_TEST_B)
    buf = torch.ones(FLUSH_BYTES // 4, device=DEV)

    def flush():
        buf.sum()
    grouped = hasattr(tsm, "bsr_matvec_group")
    out["8 grouped launch"] = grouped
    g = torch.Generator().manual_seed(15)
    for B in (SP_TRAIN_B, SP_TEST_B):
        scaled = batches[B][1]
        Q = tsm.bsr_from_dense(scaled.Q, SP_TILE, torch.bfloat16, device=DEV)
        A, AT = tsm.bsr_pair_from_dense(scaled.A0, SP_TILE, torch.bfloat16,
                                        device=DEV)
        u = torch.randn((B, SP_N), generator=g).to(DEV)
        nu = torch.randn((B, SP_MI), generator=g).to(DEV)
        mats, vs = [A, AT, Q], [u, nu, u]

        def group():
            if grouped:
                return tsm.bsr_matvec_group(mats, vs)
            return [tsm.bsr_matvec(M, v) for M, v in zip(mats, vs)]
        warm = "warm" if B == SP_TRAIN_B else "cold"
        kw = {} if B == SP_TRAIN_B else dict(flush=flush)
        for name, fn in (("Q", lambda: tsm.bsr_matvec(Q, u)),
                         ("group", group)):
            out[f"8 {name} B={B} paced us"] = 1e3 * cuda_ms(fn, reps=50,
                                                            warmup=5)
            out[f"8 {name} B={B} {warm} device us"] = bsr_device_us(
                fn, 50, **kw)
        del Q, A, AT
    cfg = sparse_cfg(data_size=SP_TRAIN_B + SP_TEST_B)
    params = {k: v.cpu().numpy() for k, v in lstm_init(
        torch.Generator().manual_seed(0), 2, SP_H, SP_K,
        device=DEV).items()}
    ids = np.arange(SP_TRAIN_B)
    out["8 bsr chunk update"] = sparse_chunk_breakdown(cfg, ds, params, ids)
    runs = []
    for _ in range(3):
        before = tsm.bsr_matvec.launches
        r = run_test(cfg, ds, params, test_ids=np.arange(
            SP_TRAIN_B, SP_TRAIN_B + SP_TEST_B), verbose=False, device=DEV)
        runs.append(dict(
            parallel_s_per_instance=r.parallel_time, total_s=r.total_time,
            stage2_s=r.stage2.total_time if r.stage2 else None,
            bsr_launches=tsm.bsr_matvec.launches - before))
    out["8 bsr run_test"] = runs
    del buf
    torch.cuda.empty_cache()


def time_bsr(path):
    """Time this checkout's row 8 and BSR route alone (``time_rows_bsr``)
    and write them to ``path`` as JSON.  Run in two checkouts, in turns,
    to compare them on one card."""
    import torch
    from iadmm_tpu_torch.kernels import _build
    _build.build_all()
    out = dict(card=torch.cuda.get_device_name(0))
    time_rows_bsr(out)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


def time_rollout(path):
    """Time this checkout's serving rollout alone (row 2: B=8, K=100) and
    write the times to ``path`` as JSON, its (x, y, z) to ``path``.pt
    (for --compare): calls of one shape back to back; a B=7 call alone;
    B=8 and B=7 calls in turn (a batch and its last, partial one); and
    twice the device breakdown and busy share of a B=8 call.  Run in two
    checkouts, in turns, to compare them on one card."""
    import torch
    from iadmm_tpu_torch.kernels import rollout_kernel as rk
    from iadmm_tpu_torch.scaling import scale_batch
    from iadmm_tpu_torch.solvers.cells import lstm_init
    params = lstm_init(torch.Generator().manual_seed(0), 2, HIDDEN, K_ITERS,
                       device="cuda")
    full = scale_batch(qp_batch(SERVE_BATCH, seed=1))[0]
    part = scale_batch(qp_batch(SERVE_BATCH - 1, seed=2))[0]

    def call(data):
        return rk.fused_rollout(params, data, hidden=HIDDEN, K=K_ITERS,
                                sigma=SIGMA)

    out = dict(card=torch.cuda.get_device_name(0))
    out["B=8 ms"] = [cuda_ms(lambda: call(full), reps=5) for _ in range(2)]
    out["B=7 ms"] = cuda_ms(lambda: call(part), reps=5)
    out["B=8 then B=7, ms a pair"] = [
        cuda_ms(lambda: (call(full), call(part)), reps=3) for _ in range(2)]
    out["B=8 busy"] = [rollout_breakdown(lambda: call(full))
                       for _ in range(2)]
    torch.save({f"rollout B={SERVE_BATCH} K={K_ITERS}": [
        t.cpu() for t in call(full)]}, path + ".pt")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return 0


def compare_snapshots(path_a, path_b):
    """Print, for each output of two snapshots, whether it is bitwise
    equal and the largest gap; 1 where any differs."""
    import torch
    a, b = torch.load(path_a), torch.load(path_b)
    same = a.keys() == b.keys()
    for k in (k for k in a if k in b):
        eq = [bool(torch.equal(u, v)) for u, v in zip(a[k], b[k])]
        gap = [float((u.double() - v.double()).abs().max())
               for u, v in zip(a[k], b[k])]
        say("compare", output=k, bitwise_equal=eq, max_abs_gap=gap)
        same = same and all(eq)
    print(json.dumps({"bitwise_equal": same}), flush=True)
    return 0 if same else 1


def main(argv=()) -> int:
    sys.path.insert(0, ROOT)
    import torch
    if argv[:1] == ["--compare"] and len(argv) == 3:
        return compare_snapshots(*argv[1:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    import iadmm_tpu_torch  # noqa: F401  (fails outside the repository)
    from iadmm_tpu_torch.kernels import _build
    from iadmm_tpu_torch.solvers.cells import lstm_init

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv:
        modes = {"--snapshot": snapshot, "--time-rows": time_rows,
                 "--time-rollout": time_rollout, "--time-bsr": time_bsr}
        if argv[0] not in modes or len(argv) != 2:
            print("usage: chip_smoke.py [--snapshot OUT | --compare A B | "
                  "--time-rows OUT | --time-rollout OUT | --time-bsr OUT]",
                  file=sys.stderr)
            return 2
        return modes[argv[0]](argv[1])
    say("setup", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), card=card,
        tf32="matmul.allow_tf32=False, cudnn.allow_tf32=False")

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    for stem, log in _build.BUILD_LOGS.items():
        with open(os.path.join(OUT_DIR, f"ptxas_{stem}.txt"), "w") as f:
            f.write(log)
    spills = sorted({ln.strip() for log in _build.BUILD_LOGS.values()
                     for ln in log.splitlines()
                     if "spill" in ln and not ln.strip().startswith(
                         "0 bytes stack frame, 0 bytes spill")})
    say("build", seconds=build_s, libraries=sorted(libs),
        nonzero_spill_lines=spills[:8])

    params = lstm_init(torch.Generator().manual_seed(0), 2, HIDDEN,
                       K_ITERS, device="cuda")
    report = dict(setup=dict(torch=torch.__version__, cuda=torch.version.cuda,
                             build_s=build_s))
    phase_cell(params, report)
    data_b = qp_batch(SERVE_BATCH, seed=1)  # the serving batch
    _, sc, xyz = phase_rollout(params, data_b, report)
    phase_stage2(params, data_b, sc, xyz, report)
    small_reference_check()

    requests = [qp_batch(SERVE_BATCH, seed=100 + r) for r in range(3)]
    fast = dict(sigma=SIGMA, use_pallas=True, gate_dtype="bfloat16",
                matvec_mode="bf16", stage2_impl="fused")
    d = phase_serve("d serve fused", params, requests, report,
                    ("stage2", "rollout"), rollout_impl="fused", **fast)
    report["breakdown"] = serve_breakdown(params, requests[1])
    e = phase_serve("e serve step", params, requests, report,
                    ("stage2", "cell"), rollout_impl="step", **fast)
    # Main path: the requests of (d) and (e), each counted from 0 just
    # before and read just after; reference solves come after the reading.
    cell_all, roll_all, s2_all = (d[k] + e[k]
                                  for k in ("cell", "rollout", "stage2"))
    say("main path launches", fused=d, step=e)

    data_t = qp_batch(TRAIN_BATCH, seed=2)
    from iadmm_tpu_torch.scaling import scale_batch
    scaled_t, _ = scale_batch(data_t)
    phase_train_kernels(params, scaled_t, report)
    phase_train_ragged(report)
    phase_gemm_cores(report)
    phase_kkt_pass(report)
    g = phase_train(report)
    cell_all += g["cell"]
    say("training path launches", **g)
    phase_step_vs_fused(params, scaled_t, report)
    del requests, data_t, scaled_t
    torch.cuda.empty_cache()

    ds_sp, gen_s = sparse_dataset()
    bsr_row = phase_bsr(ds_sp, report)
    j = phase_sparse(ds_sp, gen_s, report)
    cell_all += j["cell"]
    say("sparse path launches", **j)
    del ds_sp
    torch.cuda.empty_cache()

    # The float32 profile of configs/qp_1000_500_500.yaml
    phase_cell_f32(params, report)                                   # (k)
    data_t = qp_batch(TRAIN_BATCH, seed=2)
    scaled_t, _ = scale_batch(data_t)
    phase_train_kernels(params, scaled_t, report, "float32")         # (l)
    m = phase_flagship(report)                                       # (m)
    say("shipped config path launches",
        **{k: v for k, v in m.items() if v})
    phase_step_vs_fused(params, scaled_t, report, "float32")
    del data_t, scaled_t
    requests = [qp_batch(SERVE_BATCH, seed=100 + r) for r in range(3)]
    nf = phase_serve("n serve float32", params, requests, report,
                     ("stage2", "cell_f32"), lu64=True,
                     use_pallas=True)                                # (n)
    s2_all += nf["stage2"]
    say("float32 serving path launches", **{k: v for k, v in nf.items()
                                             if v})

    # The segment-recompute route: (o) its kernels, (p) the shipped config
    # at --batch_size 16, where the rule takes it
    data_t = qp_batch(TRAIN_BATCH, seed=2)
    scaled_t, _ = scale_batch(data_t)
    scaled16, _ = scale_batch(qp_batch(SEG_BATCH, seed=5))
    for cdt in ("bfloat16", "float32"):
        phase_seg_kernels(params, scaled_t, scaled16, report, cdt)  # (o)
    del data_t, scaled_t
    torch.cuda.empty_cache()
    p = phase_seg_train(params, scaled16, report)                   # (p)
    del scaled16
    say("segment route path launches",
        **{cdt: {k: v for k, v in c.items() if v} for cdt, c in p.items()})

    # Stage II's condensed-system solvers, from (b)'s rollout iterates
    q = phase_condensed(params, data_b, sc, xyz, requests, report)   # (q)
    say("condensed Stage II path launches", **q)
    del requests
    torch.cuda.empty_cache()

    # The canonical QP workload through the CLIs, its data layer included
    r, canon = phase_canonical(report)                               # (r)
    cell_all += r["cell"]
    say("canonical workload path launches",
        **{k: v for k, v in r.items() if v})

    # The single-device routes of the last module slice: the ghost cells,
    # the theory traces on (r)'s run, the BCOO sparse route
    phase_ghost(report)                                              # (s)
    t = phase_theory(canon, report)                                  # (t)
    cell_all += t["cell"]
    say("theory path launches", **{k: v for k, v in t.items() if v})
    shutil.rmtree(CANON_DIR, ignore_errors=True)
    del canon
    torch.cuda.empty_cache()
    u = phase_bcoo(report)                                           # (u)
    say("bcoo path launches", **u)

    def entry(name, src, replaces, key, launches):
        r = report[key]
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches, max_abs_err=r["max_abs_err"],
                    ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r.get("library_ms"))

    train_src = "iadmm_tpu_torch/kernels/csrc/train_{}.cu"

    def train_entries(suffix, key, launches):
        tk = report[key]
        return [
            dict(name="train_fwd" + suffix, route="cuda",
                 source=train_src.format("fwd"),
                 replaces="iadmm_tpu/kernels/train_rollout.py:256",
                 launches=launches["train_fwd" + suffix],
                 max_abs_err=tk["max_abs_err_fwd"], ms=tk["fwd_ms"],
                 plain_ms=tk["fwd_plain_ms"], bound_ms=tk["fwd_bound_ms"],
                 bound_by=tk["fwd_bound_by"],
                 library_ms=tk["fwd_library_ms"]),
            dict(name="train_bwd" + suffix, route="cuda",
                 source=train_src.format("bwd"),
                 replaces="iadmm_tpu/kernels/train_rollout.py:397",
                 launches=launches["train_bwd" + suffix],
                 max_abs_err=tk["max_abs_err_grad"], ms=tk["bwd_ms"],
                 plain_ms=tk["bwd_plain_ms"], bound_ms=tk["bwd_bound_ms"],
                 bound_by=tk["bwd_bound_by"],
                 library_ms=tk["bwd_library_ms"])]

    def seg_entries(suffix, key, launches):
        sk = report[key]
        t = sk["B16"]   # the main path's shape
        return [
            dict(name=f"train_{d}_seg" + suffix, route="cuda",
                 source=train_src.format(d),
                 replaces=f"iadmm_tpu/kernels/train_rollout.py:{line}",
                 launches=launches[f"train_{d}_seg" + suffix],
                 max_abs_err=sk[err], ms=t[f"{d}_ms"],
                 plain_ms=t[f"{d}_plain_ms"], bound_ms=t[f"{d}_bound_ms"],
                 bound_by=t[f"{d}_bound_by"],
                 library_ms=t[f"{d}_library_ms"])
            for d, line, err in (("fwd", 147, "max_abs_err_fwd"),
                                 ("bwd", 664, "max_abs_err_grad"))]

    kernels = [
        entry("lstm_cell", "iadmm_tpu_torch/kernels/csrc/lstm_cell.cu",
              "iadmm_tpu/kernels/lstm_cell.py:49", "cell", cell_all),
        entry("rollout", "iadmm_tpu_torch/kernels/csrc/rollout.cu",
              "iadmm_tpu/kernels/rollout_kernel.py:56", "rollout", roll_all),
        entry("stage2_kkt", "iadmm_tpu_torch/kernels/csrc/stage2.cu",
              "iadmm_tpu/kernels/stage2_kernel.py:59", "stage2", s2_all),
        *train_entries("", "train_kernels", {k: g[k] + r[k] for k in g}),
        dict(name="bsr_matvec", route="cuda",
             source="iadmm_tpu_torch/kernels/csrc/bsr_matvec.cu",
             replaces="iadmm_tpu/kernels/sparse_matvec.py:116",
             launches=j["bsr"], max_abs_err=bsr_row["max_abs_err"],
             ms=bsr_row["kernel_ms"], plain_ms=bsr_row["plain_ms"],
             bound_ms=bsr_row["bound_ms"], bound_by=bsr_row["bound_by"],
             library_ms=bsr_row["library_ms"]),
        entry("lstm_cell_f32", "iadmm_tpu_torch/kernels/csrc/lstm_cell.cu",
              "iadmm_tpu/kernels/lstm_cell.py:49", "cell_f32",
              m["cell_f32"] + nf["cell_f32"]),
        *train_entries("_f32", "train_kernels_f32", m),
        *seg_entries("", "seg_kernels", p["bfloat16"]),
        *seg_entries("_f32", "seg_kernels_f32", p["float32"]),
        entry("stage2_direct", "iadmm_tpu_torch/kernels/csrc/stage2.cu",
              "iadmm_tpu/kernels/stage2_kernel.py:59", "stage2_direct",
              q["direct"]),
        entry("stage2_cg", "iadmm_tpu_torch/kernels/csrc/stage2.cu",
              "iadmm_tpu/kernels/stage2_kernel.py:59", "stage2_cg", q["cg"]),
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise PhaseError(f"{k['name']}: no launch on the main path")
    with open(os.path.join(OUT_DIR, "report.json"), "w") as f:
        json.dump(dict(card=card, report=report, kernels=kernels), f,
                  indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
