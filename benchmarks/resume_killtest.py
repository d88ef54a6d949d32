#!/usr/bin/env python
"""Kill-and-resume proof for the at-scale recovery story (SURVEY §5,
VERDICT r4 weak #4): run the BASELINE config-5 ard_nmf workflow with
per-rank-fit checkpointing, SIGKILL it mid-search, resume from the
checkpoint directory, and assert the final model + CV trace match an
uninterrupted run BIT-FOR-BIT. Records the recovery overhead.

Three phases (all through benchmarks/endtoend_large.py, the production
driver path):
  A. uninterrupted run  -> model_a.npz         (wall t_a)
  B. fresh run, SIGKILL'd (exact child PID — never pattern-kill) once the
     search passes --kill-after-fraction of t_a  (wall t_b_partial)
  C. SAME command re-launched -> resumes from B's checkpoint dir
     -> model_b.npz                            (wall t_c)

Pass criteria: every array in model_a == model_b exactly (np.array_equal),
and the resumed run's fit count < the uninterrupted run's (it actually
skipped work). Overhead = (t_b_partial + t_c) - t_a.

Run (full config-5 scale):   python benchmarks/resume_killtest.py
Small smoke (for CI/CPU):    python benchmarks/resume_killtest.py \
                                 --cells 8192 --genes 2048 --k-max 8 \
                                 --maxit 8 --kill-after-fraction 0.4
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_workflow(args, ckpt_dir, model_path, kill_after_s=None):
    """Run endtoend_large.py; optionally SIGKILL the exact child PID after
    kill_after_s seconds. Returns (wall_s, returncode, stdout_tail)."""
    cmd = [sys.executable, os.path.join(REPO, "benchmarks",
                                        "endtoend_large.py"),
           "--cells", str(args.cells), "--genes", str(args.genes),
           "--k-init", str(args.k_init), "--k-max", str(args.k_max),
           "--maxit", str(args.maxit), "--cv-tol", str(args.cv_tol),
           "--trace-test-mse", str(args.trace_test_mse),
           "--checkpoint", ckpt_dir, "--save-model", model_path,
           "--skip-project"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    if kill_after_s is not None:
        try:
            proc.wait(timeout=kill_after_s)
        except subprocess.TimeoutExpired:
            proc.kill()                      # SIGKILL the exact PID
            proc.wait()
        out = proc.stdout.read()
    else:
        out, _ = proc.communicate()
    return time.perf_counter() - t0, proc.returncode, out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=524288)
    ap.add_argument("--genes", type=int, default=16384)
    ap.add_argument("--k-init", type=int, default=2)
    ap.add_argument("--k-max", type=int, default=32)
    ap.add_argument("--maxit", type=int, default=40)
    ap.add_argument("--cv-tol", type=float, default=1e-4)
    ap.add_argument("--trace-test-mse", type=int, default=5)
    ap.add_argument("--kill-after-fraction", type=float, default=0.45,
                    help="SIGKILL run B at this fraction of run A's wall")
    ap.add_argument("--post-kill-sleep", type=float, default=0.0,
                    help="seconds to wait after the kill before resuming")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args()

    work = args.workdir or tempfile.mkdtemp(prefix="singlet_killtest_")
    os.makedirs(work, exist_ok=True)
    dir_a, dir_b = os.path.join(work, "ckpt_a"), os.path.join(work, "ckpt_b")
    model_a = os.path.join(work, "model_a.npz")
    model_b = os.path.join(work, "model_b.npz")
    for d in (dir_a, dir_b):
        shutil.rmtree(d, ignore_errors=True)
    for p in (model_a, model_b):
        if os.path.exists(p):
            os.unlink(p)

    print(f"[A] uninterrupted run (checkpointing to {dir_a})...", flush=True)
    t_a, rc_a, out_a = run_workflow(args, dir_a, model_a)
    assert rc_a == 0, out_a[-3000:]
    print(f"[A] done in {t_a:.1f} s", flush=True)

    kill_s = args.kill_after_fraction * t_a
    print(f"[B] fresh run, SIGKILL after {kill_s:.1f} s...", flush=True)
    t_b, rc_b, out_b = run_workflow(args, dir_b, model_b, kill_after_s=kill_s)
    killed = rc_b != 0
    note = ("killed mid-search" if killed
            else "FINISHED BEFORE KILL - increase --kill-after-fraction")
    print(f"[B] exited rc={rc_b} after {t_b:.1f} s ({note})", flush=True)
    fits_b_partial = out_b.count("k = ")

    if killed and args.post_kill_sleep > 0:
        print(f"[B] sleeping {args.post_kill_sleep} s (device recovery "
              "after mid-execution kill)...", flush=True)
        time.sleep(args.post_kill_sleep)

    print("[C] resuming the killed run (same command, same checkpoint "
          "dir)...", flush=True)
    t_c, rc_c, out_c = run_workflow(args, dir_b, model_b)
    assert rc_c == 0, out_c[-3000:]
    resumed = "resuming from" in out_c
    fits_c = out_c.count("k = ")
    fits_a = out_a.count("k = ")
    print(f"[C] done in {t_c:.1f} s (resumed={resumed}, "
          f"fits A={fits_a} B-partial={fits_b_partial} C={fits_c})",
          flush=True)

    import numpy as np
    a, b = np.load(model_a), np.load(model_b)
    bitwise = {k: bool(np.array_equal(a[k], b[k])) for k in a.files}
    ok = all(bitwise.values()) and (not killed or (resumed
                                                   and fits_c < fits_a))
    print(json.dumps({
        "metric": "ard_search_kill_resume",
        "cells": args.cells, "genes": args.genes, "k_max": args.k_max,
        "uninterrupted_wall_s": round(t_a, 1),
        "killed_after_s": round(t_b, 1),
        "resume_wall_s": round(t_c, 1),
        "recovery_overhead_s": round(t_b + t_c - t_a, 1),
        "killed_mid_search": killed,
        "resumed_from_checkpoint": resumed,
        "fits_uninterrupted": fits_a,
        "fits_after_resume": fits_c,
        "bitwise_equal": bitwise,
        "ok": bool(ok),
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
