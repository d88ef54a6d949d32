#!/usr/bin/env python
"""Identical-operand convergence-race + adaptive-throughput CPU baseline.

Produces the denominators for bench.py's apples-to-apples ratios: an
accelerator iteration rate at the adaptive fast cap (8 sweeps/column)
divided by a CPU iteration rate at the reference's full 100-sweep cap would
compare unequal inner work. This script:

1. regenerates bench.py's EXACT operand and W0 on the host CPU backend —
   jax.random (threefry) is bit-deterministic across backends, so the CSC
   written here matches the device-side operand bit-for-bit (checked once
   on device by bench.py via a corner-checksum);
2. writes the ``--load`` binary for native/baseline_bench;
3. runs the C++ bench (reference CD-NNLS semantics,
   reference:src/singlet.cpp:229-347) in:
   a. adaptive-schedule throughput mode — the same inner-sweep schedule as
      the JAX engine (ops/nnls.py sweep_cap_update), so the headline
      iteration-rate ratio compares equal inner-solve depth;
   b. convergence race to tol=1e-5 under BOTH schedules — the race
      denominator takes the FASTER (the CPU is free to use its best
      schedule; wall-clock to a converged model is the claim users care
      about);
4. merges the results into bench_baseline.json.

Runs entirely on host CPU (no accelerator needed). Re-run whenever the bench
operand geometry changes.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

GENES, CELLS, K, DENSITY = 16384, 8192, 50, 0.07
RACE_TOL = 1e-5


def gen_operand():
    """bench.py's operand + W0, bit-identical (same keys, same program)."""
    import jax

    # force CPU before the backend initializes: this script measures the
    # CPU reference and must not take the accelerator from another process
    jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    assert jax.devices()[0].platform == "cpu", jax.devices()

    key = jax.random.PRNGKey(42)
    k1, k2, k3 = jax.random.split(key, 3)
    mask = jax.random.uniform(k1, (GENES, CELLS)) < DENSITY
    vals = jax.random.uniform(k2, (GENES, CELLS), minval=0.1, maxval=3.0)
    A = jnp.where(mask, vals, 0.0).astype(jnp.float32)
    W0 = jax.random.uniform(k3, (GENES, K), dtype=jnp.float32)
    return A, W0


def write_race_file(path, A_np, W0_np):
    import numpy as np
    import scipy.sparse as sp

    A_csc = sp.csc_matrix(A_np)
    nnz = A_csc.nnz
    with open(path, "wb") as f:
        np.asarray([GENES, CELLS, K, nnz], np.int64).tofile(f)
        np.asarray(A_csc.indptr, np.int64).tofile(f)
        np.asarray(A_csc.indices, np.int32).tofile(f)
        np.asarray(A_csc.data, np.float32).tofile(f)
        np.ascontiguousarray(W0_np, np.float32).tofile(f)
    h = hashlib.sha256()
    h.update(np.asarray(A_csc.indptr, np.int64).tobytes())
    h.update(np.asarray(A_csc.indices, np.int32).tobytes())
    h.update(np.asarray(A_csc.data, np.float32).tobytes())
    return nnz, h.hexdigest()


def run_bench(binary, args):
    out = subprocess.run([binary] + args, capture_output=True, text=True,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main():
    import numpy as np

    binary = os.path.join(REPO, "singlet_tpu", "native", "baseline_bench")
    if not os.path.exists(binary):
        subprocess.run(
            ["g++", "-O3", "-march=native", "-fopenmp", "-o", binary,
             binary + ".cpp"], check=True)

    print("generating operand (host CPU backend, bit-identical to device)...",
          flush=True)
    A, W0 = gen_operand()
    A_np = np.asarray(A)
    # corner checksum bench.py re-verifies on device (cheap 128x128 fetch)
    corner = float(A_np[:128, :128].sum())
    path = os.path.join(tempfile.gettempdir(), "singlet_tpu_race_operand.bin")
    nnz, sha = write_race_file(path, A_np, np.asarray(W0))
    print(f"operand: nnz={nnz} sha256={sha[:16]}... corner={corner:.6f}",
          flush=True)

    print("C++ adaptive throughput (equal inner depth)...", flush=True)
    thr_adapt = run_bench(binary, ["--load", path, "--adaptive", "0", "0",
                                   "0", "0", "5"])
    print(json.dumps(thr_adapt), flush=True)

    print("C++ race, reference schedule (full 100-sweep cap)...", flush=True)
    race_ref = run_bench(binary, ["--load", path, "--race", str(RACE_TOL),
                                  "--maxit", "500"])
    print(json.dumps(race_ref), flush=True)

    print("C++ race, adaptive schedule...", flush=True)
    race_adapt = run_bench(binary, ["--load", path, "--race", str(RACE_TOL),
                                    "--adaptive", "--maxit", "500"])
    print(json.dumps(race_adapt), flush=True)

    best = min((race_ref, race_adapt), key=lambda r: r["wall_s"])
    base_path = os.path.join(REPO, "bench_baseline.json")
    with open(base_path) as f:
        base = json.load(f)
    base.update({
        "cells_per_s_adaptive": thr_adapt["cells_per_s"],
        "iters_per_s_adaptive": thr_adapt["iters_per_s"],
        "race": {
            "tol": RACE_TOL,
            "operand_sha256": sha,
            "operand_corner_checksum": corner,
            "reference_schedule": {"wall_s": race_ref["wall_s"],
                                   "iters": race_ref["iters"],
                                   "converged": race_ref["converged"]},
            "adaptive_schedule": {"wall_s": race_adapt["wall_s"],
                                  "iters": race_adapt["iters"],
                                  "converged": race_adapt["converged"]},
            "best_wall_s": best["wall_s"],
            "best_mode": ("adaptive" if best is race_adapt else "reference"),
        },
    })
    with open(base_path, "w") as f:
        json.dump(base, f, indent=1)
    print(f"updated {base_path}", flush=True)


if __name__ == "__main__":
    main()
