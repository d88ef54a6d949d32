#!/usr/bin/env python
"""BASELINE config 3 on REAL-data statistics: bootstrap-expand pbmc3k to
~30k cells and run the full `ard_nmf` automatic rank search (the other
≥30k operands are gamma-Poisson synthetic; pbmc3k at 2.7k cells is the only
real dataset).

Construction (documented so the measurement is reproducible):
  1. sample 30,720 source columns of the real pbmc3k count matrix with
     replacement (seeded);
  2. for each sampled column, multinomially resample its counts on its
     nonzero support — new_col ~ Multinomial(n = source depth,
     p = source counts / depth). Every expanded cell keeps a REAL cell's
     gene support, depth, and value distribution (overdispersion across
     cells comes from the real column variety), while no two cells are
     exact duplicates;
  3. Seurat LogNormalize (the library's preprocess.log_normalize), shipped
     to the device as uint16 COO triplets (half the transfer bytes;
     normalization then happens ON DEVICE with the same math as the host
     path).

The reference's own validation is real-data vignettes
(reference:R/get_pbmc3k_data.R:14-20, vignettes/); this is the closest
attainable ≥30k real-data operand in a zero-egress environment.

Run: python benchmarks/pbmc30k_ard.py [--cells 30720] [--k-max 100]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SEED = 2026


def bootstrap_expand(counts, n_out: int, seed: int = SEED):
    """Column-bootstrap + per-column multinomial count resampling.

    counts: scipy CSC (genes x cells) of raw integer counts.
    Returns (rows u16, cols u16, vals u16, src_ids) COO triplets.
    """
    import scipy.sparse as sp

    counts = sp.csc_matrix(counts)
    rng = np.random.default_rng(seed)
    n_src = counts.shape[1]
    src = rng.integers(0, n_src, size=n_out)
    indptr, indices = counts.indptr, counts.indices
    data = np.asarray(counts.data)
    rows_out, cols_out, vals_out = [], [], []
    for j, s in enumerate(src):
        lo, hi = indptr[s], indptr[s + 1]
        if lo == hi:
            continue
        v = data[lo:hi].astype(np.float64)
        depth = v.sum()
        new_v = rng.multinomial(int(depth), v / depth)
        nz = new_v > 0
        rows_out.append(indices[lo:hi][nz])
        cols_out.append(np.full(int(nz.sum()), j, np.uint16))
        vals_out.append(new_v[nz])
    rows = np.concatenate(rows_out).astype(np.uint16)
    cols = np.concatenate(cols_out)
    vals = np.concatenate(vals_out)
    assert vals.max() < 65536, "count overflow for uint16 wire format"
    return rows, cols, vals.astype(np.uint16), src


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=30720)
    ap.add_argument("--k-max", type=int, default=100)
    ap.add_argument("--maxit", type=int, default=100)
    ap.add_argument("--seed", type=int, default=123)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from singlet_tpu.data import load_pbmc3k
    from singlet_tpu.solvers.als import pick_block
    from singlet_tpu.solvers.drivers import ard_nmf
    from singlet_tpu.sparse.matrix import DenseMatrix
    from singlet_tpu.utils import enable_compilation_cache

    enable_compilation_cache()

    t0 = time.perf_counter()
    ds = load_pbmc3k()
    rows, cols, vals, src = bootstrap_expand(ds.counts, args.cells)
    genes = ds.counts.shape[0]
    nnz = len(vals)
    host_s = time.perf_counter() - t0
    print(f"expanded: {genes} genes x {args.cells} cells, nnz={nnz} "
          f"({nnz / genes / args.cells:.4f} dense), host {host_s:.1f} s",
          flush=True)

    # ship u16 triplets; densify + LogNormalize on device (same math as
    # preprocess.log_normalize: x * (1e4 / colsum), log1p)
    t0 = time.perf_counter()
    genes_pad = -(-genes // 256) * 256

    @jax.jit
    def build(r, c, v):
        A = jnp.zeros((genes_pad, args.cells), jnp.float32)
        A = A.at[r.astype(jnp.int32), c.astype(jnp.int32)].add(
            v.astype(jnp.float32))
        colsums = A.sum(axis=0)
        scale = 1e4 / jnp.where(colsums == 0, 1.0, colsums)
        return jnp.log1p(A * scale[None, :])

    A = build(jax.device_put(rows), jax.device_put(cols),
              jax.device_put(vals))
    A.block_until_ready()
    ship_s = time.perf_counter() - t0
    print(f"device densify+normalize {ship_s:.1f} s", flush=True)

    def div_block(n: int, target: int, quantum: int = 256) -> int:
        """Largest quantum-multiple block <= target that DIVIDES n (the
        masked half-update asserts cols_pad % block == 0; pick_block
        alone returns the bare target for large axes — fine for the
        providers make_dense_providers builds, which pad the axis up,
        but this script pads genes only to a 256 quantum)."""
        b = min(target, n)
        while b > quantum and n % b:
            b -= quantum
        return b

    cb = div_block(args.cells, 2048)
    gb = div_block(genes_pad, 4096)
    Ap = DenseMatrix(data=A, nonempty=jnp.any(A != 0, axis=0),
                     rows_true=genes, cols_true=args.cells,
                     cols_are_cells=True, block=cb)
    Atp = DenseMatrix(data=A.T, nonempty=jnp.any(A != 0, axis=1),
                      rows_true=args.cells, cols_true=genes,
                      cols_are_cells=False, block=gb)

    t0 = time.perf_counter()
    model = ard_nmf((Ap, Atp), k_max=args.k_max, maxit=args.maxit,
                    seed=args.seed, verbose=1)
    ard_s = time.perf_counter() - t0

    cv = model.cv_data
    final_by_k = (cv.sort_values("iter").groupby("k", as_index=False).last()
                  .sort_values("k"))
    print(json.dumps({
        "metric": "pbmc3k_bootstrap30k_ard",
        "genes": genes, "cells": args.cells, "nnz": nnz,
        "construction": "column bootstrap + per-column multinomial count "
                        "resample of real pbmc3k (seed 2026)",
        "selected_rank": int(model.k),
        "ranks_visited": final_by_k["k"].tolist(),
        "final_test_error_by_k": {
            str(int(r.k)): round(float(r.test_error), 5)
            for r in final_by_k.itertuples()},
        "ard_wall_s": round(ard_s, 1),
        "host_expand_s": round(host_s, 1),
        "ship_normalize_s": round(ship_s, 1),
        "device": str(jax.devices()[0]),
    }), flush=True)


if __name__ == "__main__":
    main()
