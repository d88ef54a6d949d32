"""pbmc3k parity capture vs the reference's rendered vignette artifacts.

The reference's Guided_Clustering vignette
(reference:docs/articles/Guided_Clustering_with_NMF.html, run with
set.seed(123) on Seurat's pbmc3k: 13,714 genes x 2,638 QC-filtered cells) is
the golden snapshot: default RunNMF (= ard_nmf automatic rank determination)
selected **rank 15**, visited ranks {2,4,8,10,12,13,14,15,16,24,...} across
3 replicates (22 trace rows), test_error head {0.136, 0.133, 0.131, 0.131,
0.131} at k={2,4,8,10,12}, d spectrum head {541314, 413514, 361714, 342022,
307180}.

This script runs the same workflow on the bundled pbmc3k (same 13,714 genes,
2,700 cells — the unfiltered twin) and records rank, per-k final test errors
and the normalized d spectrum into PARITY_pbmc3k.json for PARITY.md.

Run: `python benchmarks/parity_pbmc3k.py`
"""

import json
import time

import numpy as np

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from singlet_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    from singlet_tpu.data import load_pbmc3k
    from singlet_tpu.preprocess import log_normalize
    from singlet_tpu.solvers import drivers

    ds = load_pbmc3k()
    A = log_normalize(ds.counts)
    out = {"genes": int(A.shape[0]), "cells": int(A.shape[1])}

    t0 = time.perf_counter()
    model = drivers.ard_nmf(A, verbose=1, seed=123)
    out["ard_seconds"] = round(time.perf_counter() - t0, 1)
    out["ard_rank"] = int(model.w.shape[1])
    df = model.cv_data
    out["ard_ranks_visited"] = sorted(int(k) for k in df["k"].unique())
    out["ard_trace_rows"] = int(len(df))
    # final test error per (k, rep), mirroring the vignette's cv_data frame
    condensed = (df.sort_values("iter").groupby(["k", "rep"],
                                                as_index=False).last())
    out["final_test_error_by_k"] = {
        str(int(k)): round(float(g["test_error"].mean()), 5)
        for k, g in condensed.groupby("k")}
    d = np.asarray(model.d, np.float64)
    out["d_spectrum_normalized"] = [round(float(v), 4)
                                    for v in (d / d[0])[:8]]
    # vignette golden values (2,638-cell filtered twin)
    out["vignette"] = {
        "rank": 15,
        "ranks_visited_head": [2, 4, 8, 10, 12, 13, 14, 15, 16, 24],
        "trace_rows": 22,
        "test_error_head": [0.136, 0.133, 0.131, 0.131, 0.131],
        "d_head": [541314, 413514, 361714, 342022, 307180],
        "d_normalized": [round(v / 541314, 4)
                         for v in [541314, 413514, 361714, 342022, 307180]],
    }
    with open("PARITY_pbmc3k.json", "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
