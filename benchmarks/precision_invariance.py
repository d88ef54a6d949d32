"""CV-curve invariance guard for the numeric relaxations.

Three relaxations trade exactness for speed; this guard proves none of
them moves what the user actually consumes — the pbmc3k cross-validation
error curve and the selected rank (reference workflow: cross_validate_nmf
+ GetBestRank, reference:R/cross_validate_nmf.R:18-105, R/GetBestRank.R:8-46):

  * SINGLET_TPU_MM_PRECISION=high (TF32 tensor-core products on a GPU
    instead of the full-f32 HIGHEST default) — opt-in;
  * DEFAULT-precision masked packed-Gram products (MASK_MM_PRECISION; TF32
    on a GPU) — the DEFAULT;
  * the adaptive inexact-inner-solve schedule (SINGLET_TPU_SWEEPS,
    ops/nnls.py:sweep_cap_update) — the DEFAULT since round 4: CD sweeps
    capped at 8 until the outer tol nears convergence, then full sweeps.

Each configuration runs in a subprocess (the knobs are bound at import),
one at a time; this parent process never initialises a JAX backend, so
each child has the device to itself. Prints one JSON line with the
curves, selected ranks, and the verdict.
"""

import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys
import numpy as np
from singlet_tpu.data import load_pbmc3k
from singlet_tpu.preprocess import log_normalize
from singlet_tpu.solvers import drivers

ds = load_pbmc3k()
A = log_normalize(ds.counts)
ranks = list(range(2, 31, 2))
df = drivers.cross_validate_nmf(A, ranks=ranks, n_replicates=2, verbose=0,
                                seed=123)
best = drivers.get_best_rank(df)
condensed = (df.sort_values("iter").groupby(["k", "rep"], as_index=False)
             .last().groupby("k")["test_error"].mean())
print("RESULT " + json.dumps({
    "best_rank": int(best),
    "curve": {str(int(k)): float(v) for k, v in condensed.items()},
}))
"""


def run_child(precision: str, **extra_env: str):
    env = dict(os.environ, SINGLET_TPU_MM_PRECISION=precision, **extra_env)
    out = subprocess.run([sys.executable, "-c", CHILD], env=env,
                         capture_output=True, text=True, timeout=3600,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"child({precision}) failed:\n{out.stdout[-2000:]}\n"
                       f"{out.stderr[-2000:]}")


def main():
    # reference-exact baseline: pin ALL knobs (mask products default to
    # DEFAULT precision and sweeps to adaptive, so the baseline must opt
    # out explicitly)
    hi = run_child("highest", SINGLET_TPU_MASK_MM_PRECISION="highest",
                   SINGLET_TPU_SWEEPS="reference")
    rel = run_child("high", SINGLET_TPU_MASK_MM_PRECISION="highest",
                    SINGLET_TPU_SWEEPS="reference")
    ks = sorted(hi["curve"], key=int)

    def shift(child):
        return max(abs(child["curve"][k] - hi["curve"][k]) / hi["curve"][k]
                   for k in ks)

    max_rel_shift = shift(rel)
    # the masked-Gram relaxation (DEFAULT-precision products for
    # mask @ packed_outer_products only, see
    # ops/linalg.py:MASK_MM_PRECISION) — the DEFAULT; this guard is what
    # licenses that default
    mrel = run_child("highest", SINGLET_TPU_SWEEPS="reference")
    max_mask_shift = shift(mrel)
    # the adaptive inexact-inner-solve schedule plus DEFAULT-precision mask
    # products = the shipped defaults; this guard is what licenses them
    srel = run_child("highest")
    max_sweep_shift = shift(srel)
    verdict = (hi["best_rank"] == rel["best_rank"] == mrel["best_rank"]
               == srel["best_rank"]
               and max_rel_shift < 0.01 and max_mask_shift < 0.01
               and max_sweep_shift < 0.02)
    print(json.dumps({
        "metric": "precision_invariance_pbmc3k_cv",
        "best_rank_highest": hi["best_rank"],
        "best_rank_high": rel["best_rank"],
        "best_rank_mask_bf16": mrel["best_rank"],
        "best_rank_default": srel["best_rank"],
        "max_relative_curve_shift": round(max_rel_shift, 6),
        "max_relative_curve_shift_mask_bf16": round(max_mask_shift, 6),
        "max_relative_curve_shift_default": round(max_sweep_shift, 6),
        "invariant": bool(verdict),
    }))
    return 0 if verdict else 1


if __name__ == "__main__":
    sys.exit(main())
