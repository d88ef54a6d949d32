"""Workload-level benchmarks (BASELINE.md targets), one JSON line each.

Unlike bench.py (the driver's single headline metric), these time the
end-to-end flagship workflows on the attached accelerator:

  * pbmc3k cross-validation, k = 2..30, 3 replicates + final fit
    (the guided-clustering vignette configuration)
  * ~30k-cell automatic rank determination (ard_nmf)
  * projection of held-out cells onto a frozen model (ProjectData)

Operands for the synthetic 30k-cell config are generated ON DEVICE from a
seed, so operand construction is not part of the measured workflow.

Run:  python benchmarks/workloads.py [--skip-30k]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_pbmc3k_cv():
    from singlet_tpu import Experiment, load_pbmc3k

    exp = Experiment.from_dataset(load_pbmc3k()).preprocess_data()
    t0 = time.time()
    exp.run_nmf(k=list(range(2, 31)), reps=3, verbose=0)
    dt = time.time() - t0
    m = exp.reductions["nmf"]
    print(json.dumps({
        "metric": "pbmc3k_cv_k2_30_reps3_wall_s", "value": round(dt, 1),
        "unit": "s", "rank": int(m.w.shape[1]),
        "genes": exp.n_genes, "cells": exp.n_cells,
    }), flush=True)
    return exp


def bench_30k_ard():
    import jax
    import jax.numpy as jnp

    from singlet_tpu.solvers.als import make_dense_providers, pick_block
    from singlet_tpu.solvers.drivers import ard_nmf
    from singlet_tpu.sparse.matrix import DenseMatrix

    genes, cells, density = 16384, 30720, 0.05
    key = jax.random.PRNGKey(7)
    k1, k2, k3, k4 = jax.random.split(key, 4)

    @jax.jit
    def gen():
        # planted rank-12 structure + speckle noise, log1p'd like real data
        Wt = jax.random.gamma(k1, 0.5, (genes, 12))
        Ht = jax.random.gamma(k2, 0.5, (12, cells))
        lam = Wt @ Ht
        lam = lam / lam.mean() * 0.12
        mask = jax.random.uniform(k3, (genes, cells)) < density
        x = jnp.where(mask, lam * jax.random.uniform(k4, (genes, cells),
                                                     minval=0.5, maxval=8.0),
                      0.0)
        return jnp.log1p(x).astype(jnp.float32)

    A = gen()
    cb = pick_block(cells, 2048)
    gb = pick_block(genes, 4096)
    Ap = DenseMatrix(data=A, nonempty=jnp.any(A != 0, axis=0),
                     rows_true=genes, cols_true=cells, cols_are_cells=True,
                     block=cb)
    Atp = DenseMatrix(data=A.T, nonempty=jnp.any(A != 0, axis=1),
                      rows_true=cells, cols_true=genes, cols_are_cells=False,
                      block=gb)
    jax.block_until_ready(Ap.data)
    t0 = time.time()
    model = ard_nmf((Ap, Atp), verbose=1)
    dt = time.time() - t0
    print(json.dumps({
        "metric": "ard_30k_cells_wall_s", "value": round(dt, 1), "unit": "s",
        "rank": int(model.w.shape[1]), "genes": genes, "cells": cells,
        "density": density,
    }), flush=True)
    return model, np.asarray(A[:, :2048])


def bench_projection(model, A_new):
    from singlet_tpu import project_model

    t0 = time.time()
    h, d = project_model(A_new, model.w)
    dt = time.time() - t0
    print(json.dumps({
        "metric": "project_2048_cells_wall_s", "value": round(dt, 2),
        "unit": "s", "k": int(model.w.shape[1]),
    }), flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--skip-30k", action="store_true")
    args = p.parse_args()

    from singlet_tpu.utils import enable_compilation_cache
    enable_compilation_cache()

    bench_pbmc3k_cv()
    if not args.skip_30k:
        model, A_new = bench_30k_ard()
        bench_projection(model, A_new)
    return 0


if __name__ == "__main__":
    sys.exit(main())
