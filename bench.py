#!/usr/bin/env python
"""Headline benchmark: ALS NMF throughput at k=50 on the accelerator vs the
CPU reference.

Prints the device (platform, kind, count, card name and power limit), then
ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

Refuses to run without an accelerator: a CPU number is not a device metric.

The problem matches the CPU baseline bench (singlet_tpu/native/baseline_bench
.cpp): genes=16384, cells=8192, k=50, ~7% density, L1=0.01 — a pbmc3k-class
workload at 3x cells. The baseline denominator is the measured cells/s of the
reference-semantics C++/OpenMP implementation on this host (see BASELINE.md).
"""

import json
import os
import sys
import time

import numpy as np

BASELINE_CELLS_PER_S = None  # loaded from bench_baseline.json if present


def _load_baseline():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "bench_baseline.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


RANK_SHELF = (13, 16)          # documented flat shelf; vignette picks 15
CURVE_RTOL = 0.003             # frozen-golden max relative shift per point


def run_rank_guard():
    """pbmc3k rank-selection fidelity under production defaults (standing
    guard, runs inside every bench): CV + ARD selected ranks must land in
    the flat shelf, CV curve within CURVE_RTOL of the frozen golden."""
    import time as _time

    from singlet_tpu.data import load_pbmc3k
    from singlet_tpu.preprocess import log_normalize
    from singlet_tpu.solvers import drivers

    ds = load_pbmc3k()
    A = log_normalize(ds.counts)

    t0 = _time.perf_counter()
    df = drivers.cross_validate_nmf(A, ranks=list(range(2, 31, 2)),
                                    n_replicates=2, verbose=0, seed=123)
    cv_rank = int(drivers.get_best_rank(df))
    cv_s = _time.perf_counter() - t0
    condensed = (df.sort_values("iter").groupby(["k", "rep"], as_index=False)
                 .last().groupby("k")["test_error"].mean())
    curve = {str(int(kk)): float(v) for kk, v in condensed.items()}

    t0 = _time.perf_counter()
    ard = drivers.ard_nmf(A, seed=123, verbose=0)
    ard_rank = int(ard.k)
    ard_s = _time.perf_counter() - t0

    golden_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "benchmarks", "golden_pbmc3k_cv.json")
    max_shift = None
    golden_ok = None
    if os.path.exists(golden_path):
        with open(golden_path) as f:
            golden = json.load(f)["curve"]
        max_shift = max(abs(curve[kk] - golden[kk]) / golden[kk]
                        for kk in golden)
        golden_ok = max_shift <= CURVE_RTOL
    lo, hi = RANK_SHELF
    ok = (lo <= cv_rank <= hi and lo <= ard_rank <= hi
          and golden_ok is not False)
    return {
        "ok": bool(ok),
        "cv_rank": cv_rank,
        "ard_rank": ard_rank,
        "shelf": list(RANK_SHELF),
        "curve_max_rel_shift_vs_golden": (
            round(max_shift, 6) if max_shift is not None else "no_golden"),
        "cv_wall_s": round(cv_s, 1),
        "ard_wall_s": round(ard_s, 1),
        "curve": curve,
    }


def _card_info() -> str:
    """``name, power.limit`` from nvidia-smi (a child process, not JAX)."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _pbmc3k_present() -> bool:
    from singlet_tpu.data import _PBMC3K_PATH

    return os.path.exists(_PBMC3K_PATH)


def main():
    baseline = _load_baseline()

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    card = _card_info()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card}
    print(f"device: {json.dumps(device)}", flush=True)
    if dev.platform == "cpu":
        print("bench.py: no accelerator found; refusing to report a CPU "
              "number as a device metric", file=sys.stderr)
        return 2

    from singlet_tpu.utils import enable_compilation_cache
    enable_compilation_cache()

    from singlet_tpu.sparse.matrix import DenseMatrix

    genes, cells, k, density = 16384, 8192, 50, 0.07
    # synthetic sparse operand generated ON DEVICE from a seed (no 1 GB
    # host transfer in the set-up). Same geometry/density/value-range as the
    # C++ baseline bench.
    key = jax.random.PRNGKey(42)
    k1, k2, k3 = jax.random.split(key, 3)

    @jax.jit
    def gen():
        mask = jax.random.uniform(k1, (genes, cells)) < density
        vals = jax.random.uniform(k2, (genes, cells), minval=0.1, maxval=3.0)
        return jnp.where(mask, vals, 0.0).astype(jnp.float32)

    A = gen()
    Ap = DenseMatrix(data=A, nonempty=jnp.any(A != 0, axis=0),
                     rows_true=genes, cols_true=cells, cols_are_cells=True,
                     block=cells)
    Atp = DenseMatrix(data=A.T, nonempty=jnp.any(A != 0, axis=1),
                      rows_true=cells, cols_true=genes, cols_are_cells=False,
                      block=genes)
    genes_pad, cells_pad = genes, cells
    W = jax.random.uniform(k3, (genes_pad, k), dtype=jnp.float32)
    H = jnp.zeros((cells_pad, k), jnp.float32)
    W0, H0 = W, H          # kept for the instrumented sweep-count replay

    l1 = jnp.float32(0.01)
    l2 = jnp.float32(0.0)

    # The timed path is the fused device loop (ONE dispatch per fit, the
    # production path of nmf_fit) synced with block_until_ready. Warmup runs
    # the same program once (compile + cold-start transients).
    from singlet_tpu.solvers.als import _fit_loop_device

    iters = 10

    def run_loop(Wi, Hi, n):
        Wn, Hn, dn, n_it, tols = jax.block_until_ready(_fit_loop_device(
            Ap, Atp, Wi, Hi, l1, l1, l2, l2, None, None,
            jnp.float32(0.0), n))
        return Wn, Hn, dn, n_it, tols

    run_loop(W, H, iters)                  # compile + warm (same program)
    t0 = time.perf_counter()
    W, H, d, n_it, tols = run_loop(W, H, iters)
    secs = time.perf_counter() - t0
    assert int(n_it) == iters
    tol = tols[iters - 1]

    ips = iters / secs
    cells_per_s = ips * cells
    # Apples-to-apples headline: the denominator is
    # the C++ reference implementation running the SAME adaptive inner-sweep
    # schedule (baseline_bench --adaptive, measured by race_baseline.py on
    # the identical operand) — both sides run ~8 sweeps/column in this
    # 10-iteration window, so the ratio divides equal inner-solve depth.
    # The legacy full-sweep-cap CPU rate is reported alongside. CAVEAT (keep
    # with every ratio): the CPU host has only 2 vCPUs; a 16-thread
    # workstation would be ~5-8x faster (BASELINE.md).
    base_adapt = (baseline or {}).get("cells_per_s_adaptive")
    base_full = (baseline or {}).get("cells_per_s")
    vs = cells_per_s / base_adapt if base_adapt else (
        cells_per_s / base_full if base_full else None)

    # --- convergence race: wall-clock to tol=1e-5, identical operand ------
    # The claim users care about: time to a converged model, each side free
    # to use its production schedule. CPU side measured by race_baseline.py
    # (best of reference/adaptive schedules, same operand + W0 bit-for-bit:
    # jax.random threefry is backend-deterministic — verified here via the
    # corner checksum recorded at operand-export time).
    race = (baseline or {}).get("race")
    race_out = None
    if race:
        corner = float(jnp.sum(A[:128, :128]))
        corner_ok = abs(corner - race["operand_corner_checksum"]) <= max(
            1e-3 * abs(race["operand_corner_checksum"]), 1e-3)
        race_tol = jnp.float32(race["tol"])
        maxit_race = 1000
        # compile/warm the maxit=1000 program with a 0-iteration call
        # (tol starts at 1.0; a target >= 1 runs no iterations)
        jax.block_until_ready(_fit_loop_device(
            Ap, Atp, W0, H0, l1, l1, l2, l2, None, None, jnp.float32(2.0),
            maxit_race))
        t0 = time.perf_counter()
        _, _, _, n_race, tols_race = jax.block_until_ready(_fit_loop_device(
            Ap, Atp, W0, H0, l1, l1, l2, l2, None, None,
            race_tol, maxit_race))
        device_race_s = time.perf_counter() - t0
        n_race = int(n_race)
        race_out = {
            "race_tol": race["tol"],
            "device_wall_s": round(device_race_s, 3),
            "device_iters": n_race,
            "device_final_tol": float(tols_race[n_race - 1]),
            "cpu_best_wall_s": race["best_wall_s"],
            "cpu_best_mode": race["best_mode"],
            "cpu_reference_wall_s": race["reference_schedule"]["wall_s"],
            "cpu_adaptive_wall_s": race["adaptive_schedule"]["wall_s"],
            "race_speedup": round(race["best_wall_s"] / device_race_s, 2),
            "operand_corner_ok": bool(corner_ok),
        }

    # --- measured NNLS sweep counts (honest FLOP accounting) -------------
    # Replay the same trajectory (same W0/H0/operand) with the instrumented
    # XLA solver, which returns per-column sweep counts. Untimed; runs after
    # the timed loop. Sweeps are data-dependent per iteration, so average
    # over the iterations the timed loop actually executed.
    from singlet_tpu.ops.linalg import gram, scale_columns
    from singlet_tpu.ops.nnls import nnls_batch

    @jax.jit
    def inst_step(Ap, Atp, W, H, cap):   # operands as args, NOT closures —
        # a closed-over 512 MB constant would be embedded in the program
        a = gram(W)
        B = Ap.t_matmul(W)
        H2, sw_h = nnls_batch(a, B, H, L1=l1, L2=l2,
                              update_mask=Ap.nonempty, return_sweeps=True,
                              sweep_cap=cap)
        H2, _ = scale_columns(H2)
        a2 = gram(H2)
        B2 = Atp.t_matmul(H2)
        W2, sw_w = nnls_batch(a2, B2, W, L1=l1, L2=l2,
                              update_mask=Atp.nonempty, return_sweeps=True,
                              sweep_cap=cap)
        W2, _ = scale_columns(W2)
        return W2, H2, jnp.mean(sw_h.astype(jnp.float32)), \
            jnp.mean(sw_w.astype(jnp.float32))

    # replay with the SAME adaptive sweep schedule the timed loop ran
    from singlet_tpu.ops.nnls import CD_MAX_SWEEPS, sweep_cap_update

    Wi, Hi = W0, H0
    exact = jnp.bool_(False)
    tol_prev = jnp.float32(1.0)
    sw_h_t, sw_w_t = [], []
    for it in range(iters):
        cap, exact = sweep_cap_update(exact, tol_prev, jnp.float32(0.0))
        cap = jnp.float32(CD_MAX_SWEEPS) if cap is None else cap
        Wi, Hi, sh, sw = inst_step(Ap, Atp, Wi, Hi, cap)
        tol_prev = jnp.float32(float(tols[it]))
        sw_h_t.append(float(sh))
        sw_w_t.append(float(sw))
    sweeps_h = float(np.mean(sw_h_t))     # mean sweeps/column, h-updates
    sweeps_w = float(np.mean(sw_w_t))     # mean sweeps/column, w-updates

    # FLOP accounting per ALS iteration (model flops, not HW passes):
    #   B products: A^T W and A H  -> 2 * (2 * genes * cells * k)
    #   Grams:      W^T W + H^T H  -> 2 * (genes + cells) * k^2
    #   NNLS: measured mean sweeps * 2k^2 per column (residual downdates)
    matmul_flops = 2 * (2.0 * genes * cells * k) + 2.0 * (genes + cells) * k * k
    nnls_flops = (cells * sweeps_h + genes * sweeps_w) * 2.0 * k * k
    flops_per_iter = matmul_flops + nnls_flops
    tflops = flops_per_iter * ips / 1e12

    # --- standing rank-selection guard -------------------------------------
    # pbmc3k CV + ARD under PRODUCTION defaults must select a rank inside
    # the documented flat shelf 13-16 (vignette: 15) and the CV error curve
    # must stay within a frozen tolerance of the recorded golden
    # (benchmarks/golden_pbmc3k_cv.json), so a perf knob that silently
    # moves the rank cannot ship. A failed guard fails the bench.
    rank_guard = None
    if os.environ.get("SINGLET_TPU_BENCH_RANK_GUARD", "1") != "0":
        rank_guard = (run_rank_guard() if _pbmc3k_present()
                      else "not run: pbmc3k absent")

    out = {
        "metric": "als_nmf_cells_per_s_k50",
        "value": round(cells_per_s, 1),
        "unit": "cells/s",
        "vs_baseline": round(vs, 2) if vs is not None else None,
        "vs_baseline_denominator": (
            "cpu_adaptive_schedule" if base_adapt else "cpu_full_sweeps"),
        "vs_baseline_cpu_full_sweeps": (
            round(cells_per_s / base_full, 2) if base_full else None),
        "cpu_caveat": "CPU ref measured on 2 vCPUs; a 16-thread "
                      "workstation would be ~5-8x faster (BASELINE.md)",
        "race": race_out,
        "rank_guard": rank_guard,
        "iters_per_s": round(ips, 3),
        "genes": genes,
        "cells": cells,
        "k": k,
        "density": density,
        "device": device,
        "baseline_cells_per_s": base_full,
        "baseline_cells_per_s_adaptive": base_adapt,
        "final_tol": float(tol),
        "measured_sweeps_per_col_h": round(sweeps_h, 2),
        "measured_sweeps_per_col_w": round(sweeps_w, 2),
        "model_tflops": round(tflops, 3),
    }
    print(json.dumps(out))
    if isinstance(rank_guard, dict) and not rank_guard["ok"]:
        print("bench.py: rank guard failed", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
