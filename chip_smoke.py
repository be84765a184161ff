#!/usr/bin/env python3
"""Drive the PyTorch port (``iadmm_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``iadmm_tpu_torch/kernels/csrc`` (first use),
then runs five phases at the flagship shape QP_1000_500_500 / h=800:

  (a) the cell kernel against its plain version (B=8, S=2000, h=800, bf16)
      and on a ragged small case;
  (b) the rollout kernel against its plain version (B=8): held to the
      plain version after K_CHECK=6 steps, and after K=100 to within
      MAX_GAP_OVER_ROUNDING times the gap between the plain version and
      itself with permuted hidden units (its own rounding, amplified by
      the untrained recurrence); timed at K=100;
  (c) the Stage-II 'kkt' kernel against its plain version (B=8, N=20);
  (d) serving: ``make_solver`` with the fast profile answers 3 requests of
      B=8 fresh instances (rollout_impl='fused', Stage II 'fused');
  (e) the same with rollout_impl='step', whose cell goes through the cell
      kernel.

Each phase prints its errors, tolerance, times and launch counts; any
failure exits non-zero.  Launch counters are zeroed just before (d) and read
just after (e).  The second-to-last line is the per-kernel JSON, the last
line ``{"ok": true, "device": {...}}``.  Weights are random from a seed (no
trained checkpoint is in the repository).  Exits non-zero without a CUDA
device.  Longer output (ptxas reports) goes to ``chiprun_out/chip_smoke/``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s, bf16 and f32 FLOP/s.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

N_VAR, N_INEQ, N_EQ, HIDDEN, K_ITERS = 1000, 500, 500, 800, 100
SERVE_BATCH, POLISH_STEPS = 8, 20
SIGMA = 6e-6
K_CHECK = 6
MAX_POLISH_RATIO = 1e-2
MAX_GAP_OVER_ROUNDING = 4.0


class PhaseError(RuntimeError):
    pass


def bound_ms(nbytes, bf16_ops=0.0, f32_ops=0.0):
    t_bytes = nbytes / HBM_BPS
    t_ops = bf16_ops / BF16_FLOPS + f32_ops / F32_FLOPS
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops) * 1e3, by


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
    return to_qp_batch(ds, device="cuda")


def phase_cell(params, report):
    import torch
    from iadmm_tpu_torch.kernels import lstm_cell as lc
    g = torch.Generator().manual_seed(11)
    for B, S, h, hc in ((SERVE_BATCH, N_VAR + N_INEQ + N_EQ, HIDDEN,
                         torch.bfloat16),
                        (2, 37, 20, torch.float32)):
        if h == HIDDEN:
            p = dict(params)
            p["U"] = params["U"] * 5.0   # gates of order 1
        else:
            p = {k: (0.05 * torch.randn(v.shape, generator=g)).cuda()
                 for k, v in params.items()}
            p["U"] = p["U"][:h, :4 * h].contiguous()
            p["W"] = p["W"][:, :4 * h].contiguous()
            p["b"] = p["b"][:4 * h].contiguous()
            p["W_h"] = p["W_h"][:h].contiguous()
        keys = [p[k].to(torch.bfloat16) if k in ("W", "U", "W_h")
                else p[k] for k in lc.CELL_KEYS]
        x = torch.randn((B, S, 2), generator=g).cuda()
        H = (0.9 * torch.tanh(torch.randn((B, S, h), generator=g))).to(
            "cuda", hc)
        C = torch.randn((B, S, h), generator=g).to("cuda", hc)
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
        k_ms = cuda_ms(lambda: lc.cell_forward(*keys, x, H, C, "bfloat16"),
                       reps=10)
        p_ms = cuda_ms(lambda: lc.cell_plain(*keys, x, H, C, "bfloat16"),
                       reps=3)
        M = B * S
        hb = 2 if hc == torch.bfloat16 else 4
        nbytes = (M * 2 * 4 + 4 * M * h * hb + M * 4
                  + (2 * 4 * h + h * 4 * h + h) * 2 + 4 * h * 4 + 4)
        b_ms, b_by = bound_ms(nbytes, bf16_ops=2.0 * M * h * 4 * h,
                              f32_ops=2.0 * M * 2 * 4 * h + 20.0 * M * h)
        row = dict(shape=dict(B=B, S=S, h=h, state=str(hc)),
                   max_abs_err=max_abs, max_rel_err=max_rel,
                   tol="delta: 1e-3 + 1e-2|ref|; H', C': 1e-5 + 2^-7|ref| "
                       "(2 bf16 ulps)",
                   kernel_ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                   bound_by=b_by, launches=1)
        if h == HIDDEN:
            U = keys[1]
            H2 = H.reshape(M, h)
            row["library_ms"] = cuda_ms(lambda: torch.matmul(H2, U),
                                        reps=10)
            row["library_note"] = ("torch.matmul of the H·U GEMM alone "
                                   "(bf16): a yardstick of the GEMM, not "
                                   "of the cell")
            report["cell"] = row
        say("a cell", **row)


def permute_hidden(params, perm):
    """The same network with its hidden units reordered by ``perm``: its
    outputs are equal in exact arithmetic; only float32 sums over the
    hidden units run in another order."""
    import torch
    h = len(perm)
    cols = torch.cat([g * h + perm for g in range(4)])
    return dict(params, W=params["W"][:, cols],
                U=params["U"][perm][:, cols], b=params["b"][cols],
                W_h=params["W_h"][perm])


def rel_gap(outs, refs):
    """max over outputs of max |out − ref| / max |ref|."""
    return max(float((a - b).abs().max()) / float(b.abs().max())
               for a, b in zip(outs, refs))


def phase_rollout(params, data, report):
    import torch
    from iadmm_tpu_torch.kernels import rollout_kernel as rk
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
               launches=K, library_ms=None,
               instance_iters_per_s=B * K / (k_ms / 1e3))
    say("b rollout", **row)
    report["rollout"] = row
    return scaled, sc, xyz


def phase_stage2(params, data, sc, xyz, report):
    import torch
    from iadmm_tpu_torch.kernels import stage2_kernel as s2
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
    S = n + m
    nbytes = (B * S * S * 4 + B * (n * n + m * n) * 4 + B * (2 * n + 4 * m)
              * 4 + B * (2 * n + 2 * m + 2 * N) * 4)
    b_ms, b_by = bound_ms(nbytes, f32_ops=N * B * (
        2.0 * S * S + 2.0 * (n * n + 2 * m * n) + 20.0 * S))
    row = dict(shape=dict(B=B, n=n, m=m, N=N),
               max_abs_err=max(e[0] for e in errs),
               max_rel_err=max(e[1] for e in errs),
               tol="1e-3·max(1, max|ref|) + 1e-3|ref| per output (float32, "
                   "other summation order)",
               tf32="torch.backends.cuda.matmul.allow_tf32=False, "
                    "torch.backends.cudnn.allow_tf32=False",
               kernel_ms=k_ms, plain_ms=p_ms, inverse_ms=inv_ms,
               bound_ms=b_ms, bound_by=b_by, launches=N, library_ms=None,
               final_primal_res=[float(v) for v in out[4][:, -1]])
    say("c stage2", **row)
    report["stage2"] = row


def counters():
    from iadmm_tpu_torch.kernels import lstm_cell, rollout_kernel, \
        stage2_kernel
    return (lstm_cell.fused_lstm_cell, rollout_kernel.fused_rollout,
            stage2_kernel.fused_stage2)


def phase_serve(tag, params, rollout_impl, requests, report):
    """Answer the requests; check each residual against the 'lu' route."""
    import torch
    from iadmm_tpu_torch.api import make_solver
    kw = dict(hidden_dim=HIDDEN, num_iters=K_ITERS, sigma=SIGMA,
              feas_rest_num=POLISH_STEPS, use_pallas=True,
              gate_dtype="bfloat16", matvec_mode="bf16",
              rollout_impl=rollout_impl)
    solve = make_solver(params, stage2_impl="fused", **kw)
    cell, roll, s2 = counters()
    for c in (cell, roll, s2):   # main path: counted from 0
        c.launches = 0
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
    delta = dict(cell=cell.launches, rollout=roll.launches,
                 stage2=s2.launches)
    # References on request 0: the same pipeline with the LU Stage II
    # (torch.linalg), and without Stage II.
    lu = make_solver(params, stage2_impl="lu", **kw)(requests[0])
    kw0 = dict(kw, feas_rest_num=0)
    pr_before = make_solver(params, **kw0)(requests[0]).primal_res
    pr_fused = prs[0]
    pr_lu = lu.primal_res
    gap = float(((pr_fused - pr_lu).abs() - 1e-2 * pr_lu.abs()).max())
    ratio = float((pr_fused / pr_before).max())
    row = dict(rollout_impl=rollout_impl, batch=int(requests[0].batch),
               ms_per_solve=times, launches=delta,
               final_primal_res_max=float(torch.stack(prs).max()),
               primal_res_req0=[float(v) for v in pr_fused],
               primal_res_req0_lu=[float(v) for v in pr_lu],
               primal_res_req0_before_stage2=[float(v) for v in pr_before],
               max_ratio_after_over_before=ratio,
               gap_to_lu_minus_1e2_rel=gap)
    say(tag, **row)
    need = ["stage2", "rollout" if rollout_impl == "fused" else "cell"]
    for k in need:
        if delta[k] <= 0:
            raise PhaseError(f"{tag}: the {k} kernel was not launched")
    if gap > 1e-4:
        raise PhaseError(f"{tag}: primal residual differs from the LU "
                         f"route by more than 1e-4 + 1e-2·|LU|")
    # Threshold: the polish steps must bring every instance's primal
    # residual below MAX_POLISH_RATIO of the learned rollout's own (weights
    # are untrained, so no absolute level is meaningful).
    if not ratio < MAX_POLISH_RATIO:
        raise PhaseError(f"{tag}: Stage II left a primal residual above "
                         f"{MAX_POLISH_RATIO:g} of the rollout's own "
                         f"(max ratio {ratio:.3e})")
    report[tag] = row
    return delta


def serve_breakdown(params, data):
    """Host-clock time of each stage of the fused serving route."""
    import torch
    from iadmm_tpu_torch.evaluation import metrics
    from iadmm_tpu_torch.kernels import rollout_kernel as rk, \
        stage2_kernel as s2
    from iadmm_tpu_torch.scaling import scale_batch
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
    Ainv = s2.kkt_inverse(data, rho, SIGMA)
    t0 = mark("kkt_inverse_ms", t0)
    out = s2.stage2_cuda(st, data, rho, Ainv, num_iters=POLISH_STEPS,
                          sigma=SIGMA, refine=0)
    t0 = mark("stage2_kernel_ms", t0)
    s2.finish_state(st, data, rho, *out[:4])
    metrics.primal_dual_residual(out[0], out[1], out[2], data.Q, data.p,
                                 data.A0, "default")
    mark("finish_and_metrics_ms", t0)
    say("d breakdown", batch=B, **t)
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


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
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
    report = {}
    phase_cell(params, report)
    data_b = qp_batch(SERVE_BATCH, seed=1)  # the serving batch
    _, sc, xyz = phase_rollout(params, data_b, report)
    phase_stage2(params, data_b, sc, xyz, report)
    small_reference_check()

    requests = [qp_batch(SERVE_BATCH, seed=100 + r) for r in range(3)]
    d = phase_serve("d serve fused", params, "fused", requests, report)
    report["breakdown"] = serve_breakdown(params, requests[1])
    e = phase_serve("e serve step", params, "step", requests, report)
    # Main path: the requests of (d) and (e), each counted from 0 just
    # before and read just after; reference solves come after the reading.
    cell_all, roll_all, s2_all = (d[k] + e[k]
                                  for k in ("cell", "rollout", "stage2"))
    say("main path launches", fused=d, step=e)

    def entry(name, src, replaces, key, launches):
        r = report[key]
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches, max_abs_err=r["max_abs_err"],
                    ms=r["kernel_ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r.get("library_ms"))

    kernels = [
        entry("lstm_cell", "iadmm_tpu_torch/kernels/csrc/lstm_cell.cu",
              "iadmm_tpu/kernels/lstm_cell.py:49", "cell", cell_all),
        entry("rollout", "iadmm_tpu_torch/kernels/csrc/rollout.cu",
              "iadmm_tpu/kernels/rollout_kernel.py:56", "rollout", roll_all),
        entry("stage2_kkt", "iadmm_tpu_torch/kernels/csrc/stage2.cu",
              "iadmm_tpu/kernels/stage2_kernel.py:59", "stage2", s2_all),
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
    sys.exit(main())
