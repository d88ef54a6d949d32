"""BASELINE config 5 end to end, as ONE workflow with ONE wall-clock:
million-cell-class `ard_nmf` rank search -> rank selection -> final
unmasked fit -> `project` of held-out cells on the frozen model.

Per-iteration rates of the individual phases miss the search's own
costs (compiles per rank bucket, host bookkeeping); this script runs the
whole reference workflow (RunNMF's automatic rank determination,
reference:R/ard_nmf.R:98-193, then ProjectData,
reference:R/ProjectData.R:37-110) against the 524k x 16k synthetic
operand through the production drivers (`ard_nmf(engine)` -> fused
masked ARD loops with k-bucketed compiled programs -> final plain fit ->
`ShardedEllEngine.project`).

The operand is generated ON DEVICE in the engine's blocked-ELL layout
(no host-side packing at this size). Held-out cells reuse
the synthetic generator at a smaller cell count — as projection inputs
they are simply "new data" with the training gene axis.

Run: python benchmarks/endtoend_large.py [--cells 524288 --genes 16384
     --k-max 40 --maxit 50 --project-cells 65536]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=524288)
    ap.add_argument("--genes", type=int, default=16384)
    ap.add_argument("--nnz", type=int, default=824)      # ~5% density
    ap.add_argument("--k-init", type=int, default=2)
    ap.add_argument("--k-max", type=int, default=40)
    ap.add_argument("--maxit", type=int, default=50,
                    help="per-fit iteration cap (the reference default is "
                         "100; 50 bounds the workflow on one chip)")
    ap.add_argument("--cv-tol", type=float, default=1e-4)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--trace-test-mse", type=int, default=5)
    ap.add_argument("--project-cells", type=int, default=65536)
    ap.add_argument("--checkpoint", default=None,
                    help="directory for per-rank-fit search checkpoints; a "
                         "killed run re-launched with the same args resumes "
                         "the search there (benchmarks/resume_killtest.py)")
    ap.add_argument("--save-model", default=None,
                    help="write the final model + CV trace to this .npz "
                         "(for bitwise kill-and-resume comparison)")
    ap.add_argument("--skip-project", action="store_true")
    args = ap.parse_args()

    import jax

    from singlet_tpu.utils import enable_compilation_cache

    enable_compilation_cache()

    from benchmarks.largescale import build_sharded_ell_synth
    from singlet_tpu.parallel.sharded_ell import ShardedEllEngine
    from singlet_tpu.solvers.drivers import ard_nmf

    t_all = time.perf_counter()

    t0 = time.perf_counter()
    data = build_sharded_ell_synth(args.genes, args.cells, args.nnz)
    jax.block_until_ready(data.b_val)
    eng = ShardedEllEngine(None, data=data)
    gen_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    model = ard_nmf(eng, k_init=args.k_init, k_max=args.k_max,
                    n_replicates=1, tol=args.tol, cv_tol=args.cv_tol,
                    maxit=args.maxit, trace_test_mse=args.trace_test_mse,
                    verbose=2, seed=0, checkpoint=args.checkpoint)
    search_s = time.perf_counter() - t0

    if args.save_model:
        import numpy as np
        np.savez(args.save_model, w=model.w, d=model.d, h=model.h,
                 cv_k=model.cv_data["k"].to_numpy(),
                 cv_rep=model.cv_data["rep"].to_numpy(),
                 cv_err=model.cv_data["test_error"].to_numpy(),
                 cv_iter=model.cv_data["iter"].to_numpy(),
                 cv_tol=model.cv_data["tol"].to_numpy())
    best_rank = model.k
    n_fits = int(model.cv_data.groupby("k").ngroups) if model.cv_data is not \
        None else -1
    fit_ks = sorted(model.cv_data["k"].unique().tolist())

    if args.skip_project:
        pgen_s = proj_s = 0.0
        h_proj = model.h.T
    else:
        t0 = time.perf_counter()
        pdata = build_sharded_ell_synth(args.genes, args.project_cells,
                                        args.nnz)
        jax.block_until_ready(pdata.b_val)
        peng = ShardedEllEngine(None, data=pdata)
        pgen_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        h_proj, d_proj = peng.project(model.w)
        proj_s = time.perf_counter() - t0

    total_s = time.perf_counter() - t_all
    print(json.dumps({
        "metric": "endtoend_ard_project_524k",
        "cells": args.cells, "genes": args.genes,
        "k_max": args.k_max, "maxit": args.maxit,
        "selected_rank": int(best_rank),
        "ranks_fit": fit_ks,
        "n_ranks_fit": n_fits,
        "operand_gen_s": round(gen_s, 1),
        "rank_search_and_final_fit_s": round(search_s, 1),
        "project_operand_gen_s": round(pgen_s, 1),
        "project_cells": args.project_cells,
        "project_s": round(proj_s, 1),
        "total_s": round(total_s, 1),
        "h_proj_shape": list(h_proj.shape),
        "device": str(jax.devices()[0]),
    }), flush=True)


if __name__ == "__main__":
    main()
