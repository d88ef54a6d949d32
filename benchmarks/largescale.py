"""Large-scale sparse NMF workload: half-million cells on one chip.

The "cellxgene million-cell" success criterion (BASELINE.md) needs a
demonstrated large fit in ELL storage. The operand is generated ON DEVICE in
closed form, directly in the engine's blocked-ELL layout, so no host-side
packing of GB-scale planes is timed or needed.

Pattern: within each gene block, each cell has ``per_gb`` nonzeros, one per
evenly-spaced slot, hash-jittered inside the slot — distinct within the
cell by construction, pseudo-random across cells. Values are a
(cell, gene) hash in [0.1, 1.1). A CPU test asserts the blocked planes and
the scipy-ingested row planes describe the same operand
(tests/test_sharded_ell.py).

This measures the real production path — ShardedEllData + the fused
sharded fit loop (parallel/sharded_ell.py) — not a synthetic kernel.

Run: `python benchmarks/largescale.py [--cells 524288 --genes 16384
      --nnz 824 --k 100 --masked]`
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _hash_val(c, g):
    """Deterministic value in [0.1, 1.1) from (cell, gene) — jnp/np agnostic."""
    h = (c.astype("uint32") * np.uint32(2654435761)
         + g.astype("uint32") * np.uint32(40503) + np.uint32(0x9E37))
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(2246822519)
    return (h >> np.uint32(16)).astype("float32") / np.float32(65536.0) \
        + np.float32(0.1)


def _synth_cfg(genes: int, nnz_per_cell: int, gene_block: int):
    """(n_gb, per_gb, width): per-gene-block count and padded plane width.
    The effective nnz/cell is n_gb * per_gb (nnz_per_cell rounded down to a
    multiple of the gene-block count)."""
    assert genes % gene_block == 0
    n_gb = genes // gene_block
    per_gb = max(1, nnz_per_cell // n_gb)
    assert per_gb <= gene_block
    width = ((per_gb + 7) // 8) * 8
    return n_gb, per_gb, width


def _synth_li(c, gb, w, per_gb, gene_block, xp):
    """Closed-form local index for slot w of gene block gb in cell c:
    slot w owns [w*GB//per_gb, (w+1)*GB//per_gb); a (cell, slot) hash picks
    a position inside — distinct within the cell by construction."""
    base = (w * gene_block) // per_gb
    gap = ((w + 1) * gene_block) // per_gb - base
    h = (c.astype("uint32") * np.uint32(2654435761)
         + (gb * np.int32(131) + w).astype("uint32") * np.uint32(40503))
    h = (h & np.uint32(0x7FFFFFFF)).astype("int32")
    return base + h % xp.maximum(gap, 1)


def synth_ell_planes(genes: int, cells: int, nnz_per_cell: int,
                     gene_block: int = 512, xp=np):
    """(idx, val) closed-form row-ELL planes (GLOBAL gene ids, gene-sorted
    within each cell) of the synthetic operand — the scipy-ingest
    cross-check twin of :func:`synth_bell_planes` (same multiset of
    (cell, gene, value) triples)."""
    n_gb, per_gb, _ = _synth_cfg(genes, nnz_per_cell, gene_block)
    c = xp.arange(cells, dtype=xp.int32)[:, None, None]
    gb = xp.arange(n_gb, dtype=xp.int32)[None, :, None]
    w = xp.arange(per_gb, dtype=xp.int32)[None, None, :]
    li = _synth_li(c, gb, w, per_gb, gene_block, xp)
    gidx = gb * gene_block + li
    val = _hash_val(c + xp.zeros_like(gidx), gidx)
    return (gidx.reshape(cells, n_gb * per_gb),
            val.reshape(cells, n_gb * per_gb))


def synth_bell_planes(genes: int, cells: int, nnz_per_cell: int,
                      gene_block: int = 512, xp=np):
    """(b_li, b_val, width) closed-form gb-major blocked-ELL planes in the
    engine's 2-D device layout (n_gb*width, cells): per gene block,
    ``per_gb`` jittered evenly-spaced LOCAL indices (pad -1/0 up to the
    8-rounded width). Same operand as
    ``shard_ell_data(csc_of(synth_ell_planes(...)))`` up to within-block
    entry order, which the tile build (a sum) does not observe."""
    n_gb, per_gb, width = _synth_cfg(genes, nnz_per_cell, gene_block)
    gb = xp.arange(n_gb, dtype=xp.int32)[:, None, None]
    w = xp.arange(width, dtype=xp.int32)[None, :, None]
    c = xp.arange(cells, dtype=xp.int32)[None, None, :]
    live = w < per_gb
    li = xp.where(live, _synth_li(c, gb, xp.minimum(w, per_gb - 1),
                                  per_gb, gene_block, xp), -1)
    gidx = gb * gene_block + xp.maximum(li, 0)
    val = xp.where(live, _hash_val(c + xp.zeros_like(gidx), gidx), 0.0)
    return (li.astype(xp.int32).reshape(n_gb * width, cells),
            val.astype(xp.float32).reshape(n_gb * width, cells), width)


def build_sharded_ell_synth(genes: int, cells: int, nnz_per_cell: int,
                            mesh=None, cell_block: int = 2048,
                            gene_block: int = 512):
    """Device-generated ShardedEllData for the synthetic operand
    (single-shard mesh; planes generated on device in closed form)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from singlet_tpu.parallel.sharded import AXIS, make_mesh
    from singlet_tpu.parallel.sharded_ell import ShardedEllData

    mesh = mesh or make_mesh(1)
    n_dev = mesh.devices.size
    assert n_dev == 1, "synthetic generator builds one shard (one chip)"
    assert genes % gene_block == 0 and cells % cell_block == 0

    gen = jax.jit(lambda: synth_bell_planes(genes, cells, nnz_per_cell,
                                            gene_block, xp=jnp)[:2])
    b_li, b_val = gen()
    width = synth_bell_planes(genes, 1, nnz_per_cell, gene_block)[2]
    sh = lambda spec: NamedSharding(mesh, spec)
    data = ShardedEllData(
        b_li=jax.device_put(b_li, sh(P(None, AXIS))),
        b_val=jax.device_put(b_val, sh(P(None, AXIS))),
        b_width=width,
        nonempty=jax.device_put(jnp.ones((cells,), bool), sh(P(AXIS))),
        gene_nonempty=jax.device_put(jnp.ones((genes,), bool), sh(P())),
        mesh=mesh, genes_true=genes, cells_true=cells,
        genes_pad=genes, cells_pad=cells,
        cell_block=cell_block, gene_block=gene_block,
    )
    return data


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=524288)
    ap.add_argument("--genes", type=int, default=16384)
    ap.add_argument("--nnz", type=int, default=824)   # ~5% density
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--maxit", type=int, default=10)
    ap.add_argument("--masked", action="store_true")
    ap.add_argument("--ard", action="store_true",
                    help="the full rank-search fit: masked steps + per-"
                         "iteration held-out MSE traces + overfit early "
                         "stop, as one fused device program (ard_loop)")
    ap.add_argument("--cell-block", type=int, default=2048)
    args = ap.parse_args()

    import jax

    from singlet_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    from singlet_tpu.parallel.sharded_ell import ShardedEllEngine

    t0 = time.perf_counter()
    data = build_sharded_ell_synth(args.genes, args.cells, args.nnz,
                                   cell_block=args.cell_block)
    jax.block_until_ready(data.b_val)
    gen_s = time.perf_counter() - t0

    eng = ShardedEllEngine(None, data=data)
    plane_bytes = data.b_li.nbytes + data.b_val.nbytes
    n_gb = args.genes // data.gene_block
    nnz_cell = (args.nnz // n_gb) * n_gb

    # Time the fused device loop directly, synced with block_until_ready.
    # The one-time model download to the host is reported separately as
    # model_fetch_s — it amortizes over a real fit's ~100 iterations.
    chunk = 8 if args.masked else min(args.maxit, 10)
    import jax.numpy as jnp

    from singlet_tpu.ops.rngmask import seed_pair

    W, H, eargs, _ = eng._state(args.k, None, 0)
    f32 = jnp.float32
    sp_ = seed_pair(0)

    if args.ard:
        # the full rank-search fit program: masked steps + held-out MSE
        # trace every iteration + overfit early stop, one device program
        loop = eng.ard_loop(20, int(args.maxit), 1, int(args.maxit) + 1)

        def run_ard():
            out = loop(*eargs, W, H, sp_, f32(0.01), f32(0.0),
                       jnp.int32(args.k), f32(0.0), f32(jnp.inf))
            return jax.block_until_ready(out)

        run_ard()              # compile + warm (full maxit)
        t0 = time.perf_counter()
        out_a = run_ard()
        secs = time.perf_counter() - t0
        Wn, Hn, dn, tols = out_a[0], out_a[1], out_a[2], out_a[9]
        n_it = out_a[3]
        W, H = Wn, Hn
    else:
        loop = eng.fit_loop(20, chunk, bool(args.masked))

        def run(budget):
            if args.masked:
                out = loop(*eargs, W, H, sp_, f32(0.01), f32(0.01), f32(0.0),
                           f32(0.0), jnp.int32(args.k), f32(0.0),
                           jnp.int32(budget), f32(1.0), jnp.bool_(False))
            else:
                out = loop(*eargs, W, H, f32(0.01), f32(0.01), f32(0.0),
                           f32(0.0), f32(0.0), jnp.int32(budget),
                           f32(1.0), jnp.bool_(False))
            return jax.block_until_ready(out)

        run(min(2, chunk))         # compile + warm
        t0 = time.perf_counter()
        done = 0
        while done < args.maxit:
            b = min(chunk, args.maxit - done)
            Wn, Hn, dn, n_it, tols, _ = run(b)
            W, H = Wn, Hn
            done += int(n_it)
        secs = time.perf_counter() - t0
    ips = int(n_it if args.ard else args.maxit) / secs

    t0 = time.perf_counter()
    out = {"w": np.asarray(W[: data.genes_true]),
           "d": np.asarray(dn),
           "h": np.asarray(H[: data.cells_true]).T,
           "tol_trace": [float(t) for t in np.asarray(tols[: int(n_it)])]}
    fetch_s = time.perf_counter() - t0

    mem = {}
    try:
        stats = jax.local_devices()[0].memory_stats()
        mem = {"hbm_bytes_in_use": int(stats.get("bytes_in_use", 0)),
               "hbm_peak_bytes": int(stats.get("peak_bytes_in_use", 0))}
    except Exception:
        pass

    print(json.dumps({
        "metric": ("largescale_ell_ard" if args.ard
                   else "largescale_ell_fit"),
        "cells": args.cells, "genes": args.genes, "k": args.k,
        "nnz_per_cell": nnz_cell,
        "density": round(nnz_cell / args.genes, 4),
        "masked": bool(args.masked or args.ard),
        "plane_gib": round(plane_bytes / 2**30, 2),
        "gen_seconds": round(gen_s, 1),
        "iters_per_s": round(ips, 3),
        "cells_per_s": round(ips * args.cells, 1),
        "model_fetch_s": round(fetch_s, 2),
        "final_tol": float(out["tol_trace"][-1]),
        "device": str(jax.devices()[0]),
        **mem,
    }))


if __name__ == "__main__":
    main()
