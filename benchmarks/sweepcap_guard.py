"""Masked-sweep-cap guard: does lowering CD_FAST_SWEEPS_MASKED move the
pbmc3k CV curve or the selected rank?

The masked fast cap bounds the inner CD sweeps during rank-search fits
(ops/nnls.py:CD_FAST_SWEEPS_MASKED, default 32 — cap 8 measured a rank
flip on the flat pbmc3k shelf). The cap bounds the per-column CD solves
of every masked iteration, so the smallest safe cap is worth knowing.
Children run one at a time and this parent never initialises a JAX
backend. Prints one JSON line; exit 0 iff every tested cap keeps the
selected rank AND the curve within 1% of cap-32.

Run: python benchmarks/sweepcap_guard.py [--caps 16,12,8]
"""

import argparse
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


def run_child(**extra_env: str):
    env = dict(os.environ, **extra_env)
    out = subprocess.run([sys.executable, "-c", CHILD], env=env,
                         capture_output=True, text=True, timeout=3600,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"child({extra_env}) failed:\n{out.stdout[-2000:]}\n"
                       f"{out.stderr[-2000:]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--caps", default="16,12")
    args = ap.parse_args()
    base = run_child()                       # production default (cap 32)
    ks = sorted(base["curve"], key=int)
    rows = {"cap32": base}
    ok = True
    for cap in args.caps.split(","):
        child = run_child(SINGLET_TPU_FAST_SWEEPS_MASKED=cap.strip())
        rows[f"cap{cap.strip()}"] = child
        shift = max(abs(child["curve"][k] - base["curve"][k])
                    / base["curve"][k] for k in ks)
        child["max_rel_shift_vs_cap32"] = round(shift, 6)
        ok = ok and child["best_rank"] == base["best_rank"] and shift < 0.01
        del child["curve"]
    del base["curve"]
    print(json.dumps({"metric": "sweepcap_guard_pbmc3k", "rows": rows,
                      "all_safe": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
