"""Multi-chip sharded ALS over blocked-ELL sparse shards — the million-cell path.

Combines the cell-mesh engine (parallel/sharded.py) with sparse storage:
each chip holds only its cells' nnz-padded index/value A-planes (~10-20x
smaller than dense for scRNA). NO transpose copy exists — the w-update
right-hand sides and masked Gram corrections are accumulated over the same
cell-block tiles (``B_w += tile_b^T @ H_b``), so the reference's 2x A+At
memory trade (reference:R/run_nmf.R:40) disappears.

Storage is **blocked ELL**: each cell's nonzeros are partitioned by gene
block at ingest and stored as per-block fixed-width planes of LOCAL gene
indices (pad = -1) and values (pad = 0). Compute tiles are then built per
(cell block x gene block) as a statically-unrolled multiply-compare-sum
over the tiny per-block window — one fused elementwise kernel with
contiguous loads and no gather/scatter — followed by dense matmuls. The
masked-CV math on the densified tiles is identical to the dense engine's —
and the counter-RNG masks are keyed by global ids, so models are
independent of mesh size and storage layout (tested).

Fits run as fused device programs: the whole ALS loop — including the
masked-CV trace / overfit-early-stop policy — is one ``lax.while_loop``
under ``shard_map``, so a fit costs ONE host sync instead of one per
iteration.
Rank searches share compiled programs via ``k_bucket`` factor padding,
exactly like the single-chip engine (solvers/ard.py).

Multi-host ingest (``shard_ell_from_local``): each host packs only its own
cell-column chunk into local ELL A-planes and contributes them to the
global sharded arrays via ``jax.make_array_from_process_local_data`` — no
host ever holds the full matrix, and no transpose is ever built. The
per-column nnz maximum is agreed across hosts with one tiny allgather, so
the assembled operand is bit-identical to single-host ``shard_ell_data``
of the same matrix.

Host-side shard construction uses the native C++ packer when available.
This replaces the reference's single-node chunked "sparse list" mode and
R-level distributed transpose (reference:src/singlet.cpp:384-402,
reference:R/ard_nmf.R:57-70) with true cross-chip sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from singlet_tpu.checkpoint import CheckpointManager, resolve_manager
from singlet_tpu.ops.linalg import (
    MM_PRECISION,
    cor_distance,
    mask_dot_t,
    packed_outer_products,
    pad_pairs,
    triu_pairs,
)
from singlet_tpu.ops.nnls import (solve_nnls, solve_nnls_packed_t,
                                  sweep_cap_update)
from singlet_tpu.ops.rngmask import mask_block, seed_pair
from singlet_tpu.parallel.sharded import AXIS, make_mesh

__all__ = ["ShardedEllData", "ShardedEllEngine", "shard_ell_data",
           "shard_ell_from_local", "ell_geometry", "sharded_ell_nmf_fit",
           "make_mesh"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class ShardedEllData:
    """Cell-sharded blocked-ELL planes. A-planes ONLY — no transpose copy.

    The reference pays 2x memory keeping both A and At
    (reference:R/run_nmf.R:40, SURVEY.md hard part 4). Here the w-update
    right-hand sides are accumulated over cell blocks from the same
    A-planes (``B_w += tile_b^T @ H_b``), so the transpose never exists:
    half the HBM, and multi-host ingest needs no distributed transpose.

    Planes are gene-block-major: ``b_li[gb, c]`` holds cell c's nonzeros
    whose gene lies in ``[gb*gene_block, (gb+1)*gene_block)``, as LOCAL
    indices ``gene - gb*gene_block`` (pad -1) and values (pad 0), at one
    UNIFORM width (the max per-(cell, block) count over all cells and
    blocks, agreed across hosts, rounded to 8). gb-major order lets both
    SpMM directions stream the planes exactly once per pass, and the
    uniform width gives every (cell_block x gene_block) compute tile a
    static shape.

    Device layout: the planes are stored 2-D as ``(n_gb * width,
    cells_pad)`` — row ``gb*width + w`` holds slot w of gene block gb. The
    CELL axis is the minor (contiguous) dimension, so a cell block's slice
    of one plane row is one contiguous run and the tile builder's loads
    coalesce; the tiny width (8-64) never sits on the minor axis, where
    layouts pad it. ``planes_to_device_layout`` converts the packers' 3-D
    output.
    """

    b_li: jnp.ndarray           # (n_gb*width, cells_pad) i32 local gene ids, P(None, AXIS)
    b_val: jnp.ndarray          # (n_gb*width, cells_pad) f32
    b_width: int                # static uniform plane width
    nonempty: jnp.ndarray       # (cells_pad,) bool, P(AXIS)
    gene_nonempty: jnp.ndarray  # (genes_pad,) bool, replicated
    mesh: Mesh
    genes_true: int
    cells_true: int
    genes_pad: int
    cells_pad: int
    cell_block: int
    gene_block: int


def bell_widths(A: sp.csc_matrix, n_gb: int, gene_block: int) -> np.ndarray:
    """Per-gene-block max nonzero count over columns of CSC ``A`` —
    the (unrounded) blocked-ELL plane widths."""
    cols = A.shape[1]
    if A.nnz == 0 or cols == 0:
        return np.zeros(n_gb, np.int64)
    gb_of = A.indices.astype(np.int64) // gene_block
    col_of = np.repeat(np.arange(cols, dtype=np.int64), np.diff(A.indptr))
    counts = np.bincount(col_of * n_gb + gb_of,
                         minlength=cols * n_gb).reshape(cols, n_gb)
    return counts.max(axis=0)


def bell_width(widths: np.ndarray) -> int:
    """Uniform plane width: the max per-(cell, gene-block) count, rounded
    to a sublane multiple (min 8)."""
    m = int(np.asarray(widths).max()) if np.asarray(widths).size else 0
    return max(_round_up(m, 8), 8)


def _log_bell_ingest(width: int, nnz: int, cells: int, n_gb: int,
                     cells_pad: int) -> None:
    """Ingest observability: the uniform plane width is a global max, so a
    single anomalously dense cell inflates EVERY plane (HBM scales with
    width * n_gb * cells_pad). Log the chosen width vs the mean per-(cell,
    gene-block) count and warn on severe inflation so users can spot
    outlier cells before a fit OOMs."""
    from singlet_tpu.tracing import get_metric_logger

    mean = nnz / max(cells * n_gb, 1)
    hbm_gib = 2 * n_gb * cells_pad * width * 4 / 2 ** 30
    get_metric_logger().log(
        "bell_ingest", width=width, mean_nnz_per_block=round(mean, 2),
        n_gene_blocks=n_gb, planes_gib=round(hbm_gib, 3))
    if width > 16 and width > 8 * max(mean, 1.0):
        import warnings

        warnings.warn(
            f"blocked-ELL plane width {width} is {width / max(mean, 1e-9):.0f}x "
            f"the mean per-(cell, gene-block) nonzero count ({mean:.1f}): a few "
            f"anomalously dense cells are inflating the operand to "
            f"{hbm_gib:.2f} GiB. Consider filtering outlier cells or raising "
            f"gene_block.")


def _pack_bell(A: sp.csc_matrix, cols_pad: int, gene_block: int,
               n_gb: int, width: int):
    """CSC -> gb-major blocked-ELL planes (native packer; numpy fallback)."""
    from singlet_tpu import native

    return native.csc_to_bell(A, cols_pad, gene_block, n_gb, width)


def planes_to_device_layout(planes: np.ndarray) -> np.ndarray:
    """Packer 3-D planes (n_gb, cells, width) -> the engine's 2-D device
    layout (n_gb * width, cells): cells on the minor axis (see
    ShardedEllData)."""
    n_gb, cells, width = planes.shape
    return np.ascontiguousarray(planes.transpose(0, 2, 1)).reshape(
        n_gb * width, cells)


def ell_geometry(genes: int, cells: int, mesh: Mesh, cell_block: int = 2048,
                 gene_block: int = 512) -> Tuple[int, int, int, int]:
    """(genes_pad, cells_pad, cell_block, gene_block) for an ELL-sharded
    operand on this mesh — the single source of truth shared by single-host
    ``shard_ell_data`` and multi-host ``shard_ell_from_local`` so both
    produce bit-identical global operands."""
    n_dev = mesh.devices.size
    cell_block = min(cell_block, _round_up(max(cells // n_dev, 1), 256))
    cells_pad = _round_up(cells, n_dev * cell_block)
    gene_block = min(gene_block, _round_up(genes, 256))
    genes_pad = _round_up(genes, gene_block)
    return genes_pad, cells_pad, cell_block, gene_block


def shard_ell_data(A: sp.spmatrix, mesh: Mesh, cell_block: int = 2048,
                   gene_block: int = 512) -> ShardedEllData:
    """Build cell-sharded blocked-ELL A-planes from genes x cells sparse
    input (single process holds the full matrix). No transpose is built."""
    A = sp.csc_matrix(A)
    genes, cells = A.shape
    genes_pad, cells_pad, cell_block, gene_block = ell_geometry(
        genes, cells, mesh, cell_block, gene_block)
    n_gb = genes_pad // gene_block

    width = bell_width(bell_widths(A, n_gb, gene_block))
    _log_bell_ingest(width, A.nnz, cells, n_gb, cells_pad)
    b_li, b_val = _pack_bell(A, cells_pad, gene_block, n_gb, width)

    nnz_a = np.diff(A.indptr)
    ne = np.zeros(cells_pad, bool)
    ne[:cells] = nnz_a > 0
    gne = np.zeros(genes_pad, bool)
    gne[:genes] = np.asarray((A != 0).sum(axis=1)).ravel() > 0

    sh = lambda spec: NamedSharding(mesh, spec)
    return ShardedEllData(
        b_li=jax.device_put(planes_to_device_layout(b_li), sh(P(None, AXIS))),
        b_val=jax.device_put(planes_to_device_layout(b_val),
                             sh(P(None, AXIS))),
        b_width=width,
        nonempty=jax.device_put(ne, sh(P(AXIS))),
        gene_nonempty=jax.device_put(gne, sh(P())),
        mesh=mesh, genes_true=genes, cells_true=cells,
        genes_pad=genes_pad, cells_pad=cells_pad,
        cell_block=cell_block, gene_block=gene_block,
    )


def _allgather_max(vals: Tuple[int, ...]) -> Tuple[int, ...]:
    """Elementwise max of small host-side ints across all processes."""
    if jax.process_count() == 1:
        return vals
    from jax.experimental import multihost_utils

    arr = multihost_utils.process_allgather(np.asarray(vals, np.int64))
    return tuple(int(v) for v in np.asarray(arr).max(axis=0))


def shard_ell_from_local(local_cols: sp.spmatrix, cells_true: int,
                         mesh: Mesh, cell_block: int = 2048,
                         gene_block: int = 512) -> ShardedEllData:
    """Assemble the global ELL-sharded operand from per-host column chunks.

    Each host passes only its own (genes x owned_true_cols) slice — the
    contiguous cell range its local devices own under ``mesh`` (device-id
    order, see ``parallel.multihost.process_cell_range``). The nnz plane
    width is agreed across hosts with one allgather, so
    the assembled ``ShardedEllData`` is bit-identical to single-host
    ``shard_ell_data`` of the concatenated matrix.

    The multi-host twin of the reference's chunked sparse-list ingest +
    R distributed transpose (reference:src/singlet.cpp:384-402,
    reference:R/ard_nmf.R:57-70): the "distributed transpose" here is each
    host transposing only its own device shards, locally.
    """
    local_cols = sp.csc_matrix(local_cols)
    genes = local_cols.shape[0]
    n_dev = mesh.devices.size
    n_proc = jax.process_count()
    pid = jax.process_index()
    per_proc = n_dev // n_proc
    genes_pad, cells_pad, cell_block, gene_block = ell_geometry(
        genes, cells_true, mesh, cell_block, gene_block)
    cells_local = cells_pad // n_dev

    start = pid * per_proc * cells_local
    stop = (pid + 1) * per_proc * cells_local
    expected = max(0, min(stop, cells_true) - start)
    if local_cols.shape[1] != expected:
        raise ValueError(
            f"process {pid} owns padded cell range [{start}, {stop}) = "
            f"{expected} true columns, got {local_cols.shape[1]}")

    nnz_a = np.diff(local_cols.indptr)
    n_gb = genes_pad // gene_block
    # agree the uniform plane width across hosts (one allgather), so every
    # process packs the identical global layout
    (wmax,) = _allgather_max(
        (int(bell_widths(local_cols, n_gb, gene_block).max(initial=0)),))
    width = bell_width(np.asarray([wmax]))
    _log_bell_ingest(width, local_cols.nnz, local_cols.shape[1], n_gb,
                     cells_pad)

    local_cells = per_proc * cells_local
    b_li, b_val = _pack_bell(local_cols, local_cells, gene_block, n_gb,
                             width)

    ne_loc = np.zeros(local_cells, bool)
    ne_loc[: nnz_a.size] = nnz_a > 0
    gene_present = np.zeros(genes, bool)
    gene_present[np.unique(local_cols.indices)] = True

    return _assemble_from_local_planes(
        b_li, b_val, ne_loc, gene_present, genes, cells_true, mesh,
        (genes_pad, cells_pad, cell_block, gene_block), width, start, stop)


def _assemble_from_local_planes(b_li, b_val, ne_loc, gene_present,
                                genes, cells_true, mesh, geometry, width,
                                start, stop) -> ShardedEllData:
    """Build the global ShardedEllData from this process's packed planes.

    Shared tail of ``shard_ell_from_local`` / ``shard_ell_from_chunks``:
    contributes the local planes via ``make_array_from_process_local_data``,
    validates shard contiguity, and ORs per-process gene presence on device.
    """
    genes_pad, cells_pad, cell_block, gene_block = geometry
    n_dev = mesh.devices.size
    n_gb = genes_pad // gene_block
    cells_local = cells_pad // n_dev
    per_proc = n_dev // jax.process_count()

    sh = lambda spec: NamedSharding(mesh, spec)
    mk = jax.make_array_from_process_local_data
    a_idx_g = mk(sh(P(None, AXIS)), planes_to_device_layout(b_li),
                 global_shape=(n_gb * width, cells_pad))
    a_val_g = mk(sh(P(None, AXIS)), planes_to_device_layout(b_val),
                 global_shape=(n_gb * width, cells_pad))
    ne_g = mk(sh(P(AXIS)), ne_loc, global_shape=(cells_pad,))
    # validate the contiguity assumption: this process's addressable A-plane
    # shards must cover exactly [start, stop) on the cell axis
    owned = sorted({s.index[1].start or 0
                    for s in a_idx_g.addressable_shards})
    expect_starts = list(range(start, stop, cells_local))
    if owned != expect_starts:
        raise RuntimeError(
            "mesh device order does not give this process a contiguous "
            f"cell range: owns plane-row starts {owned}, expected "
            f"{expect_starts}. Build the mesh with global_mesh() (device-id "
            "order) or load columns matching the owned ranges.")

    # global gene-nonempty: OR of per-process local gene nnz, computed on
    # device (each host only knows its own columns)
    gne_loc = np.zeros((per_proc, genes_pad), bool)
    gne_loc[:, :genes] = gene_present[None, :]
    gne_sharded = mk(sh(P(AXIS, None)), gne_loc,
                     global_shape=(n_dev, genes_pad))
    gne = jax.jit(lambda x: jnp.any(x, axis=0),
                  out_shardings=sh(P()))(gne_sharded)

    return ShardedEllData(
        b_li=a_idx_g, b_val=a_val_g, b_width=width,
        nonempty=ne_g, gene_nonempty=gne,
        mesh=mesh, genes_true=genes, cells_true=cells_true,
        genes_pad=genes_pad, cells_pad=cells_pad,
        cell_block=cell_block, gene_block=gene_block,
    )


def shard_ell_from_chunks(chunks, mesh: Mesh, cell_block: int = 2048,
                          gene_block: int = 512) -> ShardedEllData:
    """Stream a chunk list (scipy matrices, ``.svc``/``.mtx`` paths, or
    loader callables) into mesh-sharded blocked-ELL planes WITHOUT ever
    materializing the concatenated matrix on the host.

    Three streaming passes, none of which loads a chunk this process does
    not own: (1) shapes — SVC paths read only their header, other sources
    are loaded (in-memory chunks are free; path/callable chunks this
    process owns are loaded again in later passes — the streaming trade);
    (2) the plane width from the OWNED chunk slices, agreed across hosts
    with one allgather; (3) each owned slice packed directly into its
    plane offset. The multi-host twin of the reference's chunked
    sparse-list mode (reference:src/singlet.cpp:384-402) without its
    full-matrix staging.
    """
    from singlet_tpu import native
    from singlet_tpu.sparse.chunked import _load_chunk

    # pass 1: shapes only (header fast-path for .svc shards)
    genes = None
    cols_of = []
    nnz_total = 0
    for c in chunks:
        if isinstance(c, str) and c.endswith(".svc"):
            r, cc, nz = native.svc_shape(c)
        else:
            M = _load_chunk(c)
            r, cc, nz = M.shape[0], M.shape[1], M.nnz
            del M
        if genes is None:
            genes = r
        elif r != genes:
            raise ValueError("chunks disagree on the gene axis")
        cols_of.append(cc)
        nnz_total += nz
    cells_true = int(sum(cols_of))
    genes_pad, cells_pad, cell_block, gene_block = ell_geometry(
        genes, cells_true, mesh, cell_block, gene_block)
    n_gb = genes_pad // gene_block

    n_dev = mesh.devices.size
    pid = jax.process_index()
    per_proc = n_dev // jax.process_count()
    cells_local = cells_pad // n_dev
    start = pid * per_proc * cells_local
    stop = (pid + 1) * per_proc * cells_local
    local_cells = per_proc * cells_local

    def _owned_slices():
        off = 0
        for c, w in zip(chunks, cols_of):
            lo, hi = max(start, off), min(stop, off + w)
            if lo < hi:
                yield c, off, lo, hi
            off += w

    # pass 2: plane width from owned slices; one allgather agrees the
    # global layout (every process sees the max over ALL cells)
    wmax = 0
    for c, off, lo, hi in _owned_slices():
        M = sp.csc_matrix(_load_chunk(c)[:, lo - off: hi - off])
        wmax = max(wmax, int(bell_widths(M, n_gb, gene_block)
                             .max(initial=0)))
        del M
    (wmax,) = _allgather_max((wmax,))
    width = bell_width(np.asarray([wmax]))
    _log_bell_ingest(width, nnz_total, cells_true, n_gb, cells_pad)

    # pass 3: pack owned chunk slices straight into the local planes
    b_li = np.full((n_gb, local_cells, width), -1, np.int32)
    b_val = np.zeros((n_gb, local_cells, width), np.float32)
    ne_loc = np.zeros(local_cells, bool)
    gene_present = np.zeros(genes, bool)
    for c, off, lo, hi in _owned_slices():
        M = sp.csc_matrix(_load_chunk(c)[:, lo - off: hi - off])
        li, lv = _pack_bell(M, hi - lo, gene_block, n_gb, width)
        b_li[:, lo - start: hi - start, :] = li
        b_val[:, lo - start: hi - start, :] = lv
        ne_loc[lo - start: hi - start] = np.diff(M.indptr) > 0
        gene_present[np.unique(M.indices)] = True
        del M

    return _assemble_from_local_planes(
        b_li, b_val, ne_loc, gene_present, genes, cells_true, mesh,
        (genes_pad, cells_pad, cell_block, gene_block), width, start,
        min(stop, cells_pad))


def shard_ell_from_staged(directory: str, mesh: Mesh,
                          cell_block: int = 2048,
                          gene_block: int = 512) -> ShardedEllData:
    """Multi-host ingest from a staged chunk directory: each host reads ONLY
    the SVC shards overlapping its owned cell range, slices them to the
    range, and contributes via :func:`shard_ell_from_local`.

    The pod-scale version of the reference's file-staging workflow
    (reference:R/run_nmf.R:79-107 SLURM helpers + sparse-list mode): stage
    once with ``sparse.chunked.stage_chunks``, then every host of a
    multi-host fit ingests its slice independently — no host reads the
    whole dataset.
    """
    import json as _json
    import os as _os

    with open(_os.path.join(directory, "manifest.json")) as f:
        meta = _json.load(f)
    if meta.get("format") != "svc1-chunks":
        raise ValueError(f"not a staged chunk directory: {directory}")
    genes = int(meta["genes"])
    cells = int(meta["cells"])

    n_dev = mesh.devices.size
    pid = jax.process_index()
    per_proc = n_dev // jax.process_count()
    _, cells_pad, _, _ = ell_geometry(genes, cells, mesh, cell_block,
                                      gene_block)
    cells_local = cells_pad // n_dev
    start = pid * per_proc * cells_local
    stop = min((pid + 1) * per_proc * cells_local, cells)

    from singlet_tpu import native

    parts = []
    off = 0
    for ch in meta["chunks"]:
        w = int(ch["cols"])
        lo, hi = max(start, off), min(stop, off + w)
        if lo < hi:
            M = native.svc_read(_os.path.join(directory, ch["file"]))
            parts.append(M[:, lo - off: hi - off])
        off += w
    local = (sp.hstack(parts).tocsc() if parts
             else sp.csc_matrix((genes, 0), dtype=np.float32))
    return shard_ell_from_local(local, cells, mesh, cell_block=cell_block,
                                gene_block=gene_block)


# Plane width above which _bell_tile switches from the statically-unrolled
# FMA chain to the one-shot compare-and-reduce: traced HLO size scales with
# n_gb * width under the unroll (measured at production widths — n_gb=32,
# width=40, maxit=100 masked loop — 5.4 s trace + 28 s XLA compile on CPU),
# so anomalously wide planes (a few very dense cells) would blow up compile
# time. The one-shot form is O(1) HLO ops with a (block, width, gene_block)
# intermediate that XLA fuses into the reduction.
_BELL_TILE_UNROLL_MAX_WIDTH = 128


def _bell_tile(li, lv, gene_block: int):
    """(width, block) local-index blocked-ELL window (the 2-D plane
    layout's per-gene-block rows) -> dense (block, gene_block) tile, as a
    fused multiply-compare-sum: no gather/scatter anywhere (pad entries
    have li = -1 / val = 0, so they contribute exactly zero).

    Two formulations, same math: narrow planes use a statically-unrolled
    chain of FMAs that XLA fuses into ONE elementwise kernel with no 3D
    intermediate; wide planes (width > _BELL_TILE_UNROLL_MAX_WIDTH) use a
    single compare-and-reduce over the width axis so traced-HLO size stays
    independent of the plane width."""
    iota = jnp.arange(gene_block, dtype=li.dtype)[None, :]
    if li.shape[0] > _BELL_TILE_UNROLL_MAX_WIDTH:
        onehot = (li[:, :, None] == iota[None]).astype(lv.dtype)
        return jnp.sum(lv[:, :, None] * onehot, axis=0)
    tile = jnp.zeros((li.shape[1], gene_block), lv.dtype)
    for w in range(li.shape[0]):
        # static SLICES, not integer row indexing — the latter lowers to a
        # (constant-index) stablehlo.gather, which the no-gather invariant
        # test rightly rejects
        tile = tile + lv[w:w + 1, :].T * (li[w:w + 1, :].T == iota)
    return tile


def build_sharded_ell_steps(data: ShardedEllData, inv_density: int,
                            linked: bool = False):
    """Jitted plain + masked sharded ALS steps and mse over ELL shards.

    The masked step takes per-side penalties (L1_h, L1_w, L2_h, L2_w) and a
    traced ``k_true`` for rank bucketing — padded factor columns beyond
    k_true provably stay exactly zero through every update (zero Gram row +
    zero RHS + clamp-at-zero), so only the CD-sweep divisor and the Pearson
    tol's element count need the true rank (same invariant as the
    single-chip engine, solvers/als.py:als_step_masked). ``linked`` adds
    (link_h_loc, link_w) arguments to the plain step (see
    ``_build_local_fns``)."""
    fns = _build_local_fns(data, inv_density, linked=linked)
    mesh = data.mesh
    specs_a = (P(None, AXIS), P(None, AXIS), P(AXIS), P(None))
    link_specs = (P(AXIS, None), P(None, None)) if linked else ()

    # trailing sweep_cap (traced scalar, adaptive inexact-solve schedule) so
    # the per-step host loops (the checkpoint path) can follow the same
    # schedule as the fused fit loops
    def _plain_w(*a):
        return fns["plain"](*a[:-1], sweep_cap=a[-1])

    def _masked_w(*a):
        return fns["masked"](*a[:-1], sweep_cap=a[-1])

    plain_step = jax.jit(jax.shard_map(
        _plain_w, mesh=mesh,
        in_specs=specs_a + (P(None, None), P(AXIS, None)) + link_specs
        + (P(), P(), P(), P(), P()),
        out_specs=(P(None, None), P(AXIS, None), P(None), P()),
        check_vma=False))
    masked_step = jax.jit(jax.shard_map(
        _masked_w, mesh=mesh,
        in_specs=specs_a + (P(None, None), P(AXIS, None), P(None),
                            P(), P(), P(), P(), P(), P()),
        out_specs=(P(None, None), P(AXIS, None), P(None), P()),
        check_vma=False))
    mse_fn = jax.jit(jax.shard_map(
        fns["mse"], mesh=mesh,
        in_specs=(P(None, AXIS), P(None, AXIS), P(None, None),
                  P(None), P(AXIS, None), P(None)),
        out_specs=P(),
        check_vma=False))
    return plain_step, masked_step, mse_fn


def _make_spmm_fns(gene_block: int, n_gb: int, inv_density: int):
    """The two SpMM products over blocked-ELL planes of a given geometry,
    as (spmm_b, spmm_bw): ``spmm_b(li, lv, X)`` = densify(planes) @ X
    (block, k) and ``spmm_bw(li, lv, Xb)`` = densify(planes)^T @ Xb
    (n_gb*gene_block, k), each optionally keep-masked by the CV hash
    (``seed=``/``ids=``). Each gene block's dense tile comes from the fused
    compare-sum (``_bell_tile``) and meets W in a dense matmul. Shared by
    the fit engines (A planes) and the GCNMF graph convolution (G planes,
    whose "gene" axis is the neighbor-cell axis)."""

    def _gb_tiles(li, lv):
        width = li.shape[0] // n_gb
        for gb in range(n_gb):
            sl = slice(gb * width, (gb + 1) * width)
            yield gb, _bell_tile(li[sl], lv[sl], gene_block)

    def _keep_dense(seed, ids, gsl):
        # keep factor: 1 - mask over one gene-block slice. No validity
        # clamp needed — padded cells/genes have no nonzeros, so keep
        # multiplies exact zeros.
        gene_ids = jnp.arange(gsl.start, gsl.stop)
        m = mask_block(seed, ids, gene_ids, inv_density)
        return 1.0 - m.astype(jnp.float32)

    def _spmm_b(li, lv, W, seed=None, ids=None):
        """B (block, k) = keep-masked SpMM of one cell block against W."""
        B = jnp.zeros((li.shape[1], W.shape[1]), W.dtype)
        for gb, tile in _gb_tiles(li, lv):
            gsl = slice(gb * gene_block, (gb + 1) * gene_block)
            if seed is not None:
                tile = tile * _keep_dense(seed, ids, gsl)
            B = B + jnp.dot(tile, W[gsl], precision=MM_PRECISION)
        return B

    def _spmm_bw(li, lv, Hb, seed=None, ids=None):
        """Bw partials (genes_pad, k) = keep-masked SpMM^T of one block."""
        parts = []
        for gb, tile in _gb_tiles(li, lv):
            gsl = slice(gb * gene_block, (gb + 1) * gene_block)
            if seed is not None:
                tile = tile * _keep_dense(seed, ids, gsl)
            parts.append(jnp.dot(tile.T, Hb, precision=MM_PRECISION))
        return jnp.concatenate(parts, axis=0)

    return _spmm_b, _spmm_bw


def _build_local_fns(data: ShardedEllData, inv_density: int,
                     linked: bool = False):
    """Per-device (shard_map body) functions shared by single steps and the
    fused fit loops.

    ``linked`` (static) adds 0/1 linking-mask arguments to the plain step —
    ``link_h_loc`` (cells_local, k, cell-sharded) and ``link_w``
    (genes_pad, k, replicated) — which elementwise-multiply the NNLS
    right-hand sides before the solves, zeroing unlinked factors exactly
    like ``predict_link`` (reference:src/singlet.cpp:416-433) inside
    ``c_linked_nmf`` (reference:src/singlet.cpp:1059-1086). The masked
    (CV) path takes no links, matching the reference."""
    mesh = data.mesh
    n_dev = mesh.shape[AXIS]
    cells_local = data.cells_pad // n_dev
    cell_block = data.cell_block
    gene_block = data.gene_block
    genes_pad, cells_true, genes_true = (data.genes_pad, data.cells_true,
                                         data.genes_true)
    n_gb = genes_pad // gene_block

    def _local_cell_ids(dev):
        return dev * cells_local + jnp.arange(cells_local)

    _spmm_b, _spmm_bw = _make_spmm_fns(gene_block, n_gb, inv_density)

    def _gb_tiles(li, lv):
        """Per-gene-block dense tiles of one cell block (static row-range
        slices; li/lv: (n_gb*width, cell_block)) — the _mse path."""
        width = li.shape[0] // n_gb
        for gb in range(n_gb):
            sl = slice(gb * width, (gb + 1) * width)
            yield gb, _bell_tile(li[sl], lv[sl], gene_block)

    def _slice2(arr, start, size):
        return jax.lax.dynamic_slice_in_dim(arr, start, size, 0)

    def _slice_planes(arr, start, size):
        """Cell-axis slice of (n_gb, cells_local, width) planes."""
        return jax.lax.dynamic_slice_in_dim(arr, start, size, 1)

    def _solve_w_blocks(a_h, Bw, W, gene_ne, L1_w, L2_w, n_coord,
                        packed_w_t=None, k=None, iu=None, sweep_cap=None):
        """Gene-block NNLS solves against accumulated right-hand sides.
        With ``packed_w_t`` (masked path, TRANSPOSED (np_pad, genes_pad)
        layout — the orientation ``mask_dot_t`` emits), each
        gene's Gram correction comes from the accumulated packed outer
        products via one static row-gather (``solve_nnls_packed_t``)."""
        def w_blk(_, bi):
            start = bi * gene_block
            B = jax.lax.dynamic_slice_in_dim(Bw, start, gene_block, 0)
            Y0 = jax.lax.dynamic_slice_in_dim(W, start, gene_block, 0)
            ne = jax.lax.dynamic_slice_in_dim(gene_ne, start, gene_block, 0)
            if packed_w_t is None:
                X = solve_nnls(a_h, B, Y0, L1=L1_w, L2=L2_w,
                               update_mask=ne, n_coord=n_coord,
                               sweep_cap=sweep_cap)
            else:
                pk_t = jax.lax.dynamic_slice_in_dim(packed_w_t, start,
                                                    gene_block, 1)
                X = solve_nnls_packed_t(a_h, pk_t, iu, B, Y0, L1=L1_w,
                                        L2=L2_w, update_mask=ne,
                                        n_coord=n_coord,
                                        sweep_cap=sweep_cap)
            return None, X

        _, Ws = jax.lax.scan(w_blk, None, jnp.arange(genes_pad // gene_block))
        return Ws.reshape(genes_pad, -1)

    def _plain(b_li, b_val, ne_loc, gene_ne, W, H_loc, *rest,
               sweep_cap=None):
        # Blocked over (cells x gene blocks): each blocked-ELL slice is
        # expanded to a dense (cell_block, gene_block) tile by the
        # fused compare-sum (_bell_tile), then dense matmuls. The w-update
        # right-hand sides accumulate over the SAME cell-block tiles
        # (B_w += tile^T @ H_b), so no transpose storage exists and every
        # buffer is O(cell_block * gene_block).
        if linked:
            link_h_loc, link_w, L1_h, L1_w, L2_h, L2_w = rest
        else:
            link_h_loc = link_w = None
            L1_h, L1_w, L2_h, L2_w = rest
        k = W.shape[1]
        a_w = jnp.dot(W.T, W, precision=MM_PRECISION) + 1e-15 * jnp.eye(k)

        # ONE fused pass over cell blocks: each block's tiles are built
        # once and used for both the h-update RHS and (with the freshly
        # solved, still-unnormalized H_b) the w-update RHS accumulation.
        # The global column rescale H /= d is applied algebraically after
        # the scan: B_w and the H Gram are linear/bilinear in H, so
        # psum(B_w_raw)/d and psum(Gram_raw)/outer(d, d) equal the
        # two-pass formulation exactly (modulo fp reassociation). Halves
        # the tile-densify work per iteration.
        def blk(carry, bi):
            Bw, Hsum, Hgram = carry
            start = bi * cell_block
            li = _slice_planes(b_li, start, cell_block)
            lv = _slice_planes(b_val, start, cell_block)
            B = _spmm_b(li, lv, W)
            if link_h_loc is not None:
                B = B * _slice2(link_h_loc, start, cell_block)
            Y0 = _slice2(H_loc, start, cell_block)
            ne = _slice2(ne_loc, start, cell_block)
            Hb = solve_nnls(a_w, B, Y0, L1=L1_h, L2=L2_h, update_mask=ne,
                            sweep_cap=sweep_cap)
            Bw = Bw + _spmm_bw(li, lv, Hb)
            Hsum = Hsum + jnp.sum(Hb, axis=0)
            Hgram = Hgram + jnp.dot(Hb.T, Hb, precision=MM_PRECISION)
            return (Bw, Hsum, Hgram), Hb

        carry0 = (jnp.zeros((genes_pad, k), W.dtype),
                  jnp.zeros((k,), W.dtype), jnp.zeros((k, k), W.dtype))
        (Bw, Hsum, Hgram), Hs = jax.lax.scan(
            blk, carry0, jnp.arange(cells_local // cell_block))
        d = jax.lax.psum(Hsum, AXIS) + 1e-15
        H_new = Hs.reshape(cells_local, k) / d[None, :]
        a_h = jax.lax.psum(Hgram, AXIS) / (d[:, None] * d[None, :])
        a_h = a_h + 1e-15 * jnp.eye(k)
        Bw = jax.lax.psum(Bw, AXIS) / d[None, :]
        if link_w is not None:
            Bw = Bw * link_w
        W_new = _solve_w_blocks(a_h, Bw, W, gene_ne, L1_w, L2_w, None,
                                sweep_cap=sweep_cap)
        d = jnp.sum(W_new, axis=0) + 1e-15
        W_new = W_new / d[None, :]
        tol = cor_distance(W_new[:genes_true], W[:genes_true])
        return W_new, H_new, d, tol

    def _masked_block(k: int, npairs: int) -> int:
        """Masked compute-block size: a multiple of ``cell_block`` dividing
        ``cells_local``. Default = one storage block.
        ``SINGLET_TPU_MASKED_BLOCK_GIB`` sets a budget for the per-block
        device intermediates (the dense mask, the packed products and the
        per-column Grams) and takes the largest block within it."""
        import os

        budget = int(float(os.environ.get(
            "SINGLET_TPU_MASKED_BLOCK_GIB", "0")) * (1 << 30))
        if budget <= 0:
            return cell_block
        per_col = 4 * (3 * genes_pad + 2 * k * k + 2 * npairs)
        n_base = max(cells_local // cell_block, 1)
        f_cap = max(1, min(n_base, budget // per_col // cell_block))
        f = max(d for d in range(1, f_cap + 1) if n_base % d == 0)
        return f * cell_block

    def _mask_of(seed, ids, gene_ids):
        """Dense (cells, genes) CV mask of the given cells, clamped to the
        true (unpadded) extent."""
        m = mask_block(seed, ids, gene_ids, inv_density)
        return m & (ids < cells_true)[:, None] & \
            (gene_ids < genes_true)[None, :]

    def _masked(b_li, b_val, ne_loc, gene_ne, W, H_loc,
                seed, L1_h, L1_w, L2_h, L2_w, k_true, sweep_cap=None):
        k = W.shape[1]
        dev = jax.lax.axis_index(AXIS)
        cell_ids_local = _local_cell_ids(dev)
        gene_ids = jnp.arange(genes_pad)
        iu = triu_pairs(k)
        npairs = k * (k + 1) // 2
        np_pad = -(-npairs // 128) * 128
        iu_pad = pad_pairs(iu, np_pad)
        n_coord = jnp.asarray(k_true, jnp.float32)
        mblock = _masked_block(k, np_pad)

        a_full = jnp.dot(W.T, W, precision=MM_PRECISION) + 1e-15 * jnp.eye(k)
        Pw = packed_outer_products(W, iu_pad)      # (genes_pad, np_pad)

        # ONE fused pass over cell blocks (same algebra as the plain step's
        # fusion): the keep-multiplied tiles, the block's dense CV mask and
        # its packed products are each built ONCE per iteration. Both
        # packed products are emitted TRANSPOSED ((np_pad, n), mask_dot_t)
        # so the Gram-correction unpack downstream is a pure static
        # row-gather with no relayout. The w-side accumulators use the
        # unnormalized H_b and are rescaled after the psum: B_w scales as
        # 1/d per column, the packed H Gram corrections as 1/(d_i d_j) per
        # pair. Ph is built per block — materializing (cells_local, npairs)
        # would be 10s of GB at scale.
        carry0 = (jnp.zeros((genes_pad, k), W.dtype),
                  jnp.zeros((np_pad, genes_pad), W.dtype),
                  jnp.zeros((k,), W.dtype), jnp.zeros((k, k), W.dtype))
        n_blk = cells_local // mblock

        def blk(carry, bi):
            Bw, Pk_t, Hsum, Hgram = carry
            start = bi * mblock
            ids = jax.lax.dynamic_slice_in_dim(cell_ids_local, start, mblock)
            li = _slice_planes(b_li, start, mblock)
            lv = _slice_planes(b_val, start, mblock)
            B = _spmm_b(li, lv, W, seed=seed, ids=ids)
            m = _mask_of(seed, ids, gene_ids).astype(W.dtype)
            packed_t = mask_dot_t(Pw, m, 1)
            Y0 = _slice2(H_loc, start, mblock)
            ne = _slice2(ne_loc, start, mblock)
            Hb = solve_nnls_packed_t(a_full, packed_t, iu, B, Y0,
                                     L1=L1_h, L2=L2_h, update_mask=ne,
                                     n_coord=n_coord, sweep_cap=sweep_cap)
            Bw = Bw + _spmm_bw(li, lv, Hb, seed=seed, ids=ids)
            Ph_b = packed_outer_products(Hb, iu_pad)  # (blk, np_pad)
            Pk_t = Pk_t + mask_dot_t(Ph_b, m, 0)
            Hsum = Hsum + jnp.sum(Hb, axis=0)
            Hgram = Hgram + jnp.dot(Hb.T, Hb, precision=MM_PRECISION)
            return (Bw, Pk_t, Hsum, Hgram), Hb

        (Bw, Pk_t, Hsum, Hgram), Hs = jax.lax.scan(
            blk, carry0, jnp.arange(n_blk))
        d = jax.lax.psum(Hsum, AXIS) + 1e-15
        H_new = Hs.reshape(cells_local, k) / d[None, :]
        a_h = jax.lax.psum(Hgram, AXIS) / (d[:, None] * d[None, :])
        a_h = a_h + 1e-15 * jnp.eye(k)
        Bw = jax.lax.psum(Bw, AXIS) / d[None, :]
        d_pair = d[iu_pad[0]] * d[iu_pad[1]]             # (np_pad,)
        Pk_t = jax.lax.psum(Pk_t, AXIS) / d_pair[:, None]
        W_new = _solve_w_blocks(a_h, Bw, W, gene_ne, L1_w, L2_w, n_coord,
                                packed_w_t=Pk_t, k=k, iu=iu,
                                sweep_cap=sweep_cap)
        d = jnp.sum(W_new, axis=0) + 1e-15
        W_new = W_new / d[None, :]
        n_true = genes_true * jnp.asarray(k_true, jnp.float32)
        tol = cor_distance(W_new[:genes_true], W[:genes_true], n_true)
        return W_new, H_new, d, tol

    def _project(b_li, b_val, ne_loc, W, L1, L2):
        """One cold-start h half-update against a frozen, column-normalized
        W — ``c_project_model`` (reference:src/singlet.cpp:405-413) on the
        sharded ELL operand. Returns (H_loc, d)."""
        k = W.shape[1]
        Wn = W / (jnp.sum(W, axis=0) + 1e-15)[None, :]
        a = jnp.dot(Wn.T, Wn, precision=MM_PRECISION) + 1e-15 * jnp.eye(k)

        def blk(_, bi):
            start = bi * cell_block
            li = _slice_planes(b_li, start, cell_block)
            lv = _slice_planes(b_val, start, cell_block)
            B = _spmm_b(li, lv, Wn)
            ne = _slice2(ne_loc, start, cell_block)
            return None, solve_nnls(a, B, jnp.zeros((cell_block, k), W.dtype),
                                    L1=L1, L2=L2, update_mask=ne)

        _, Hs = jax.lax.scan(blk, None,
                             jnp.arange(cells_local // cell_block))
        H_new = Hs.reshape(cells_local, k)
        d = jax.lax.psum(jnp.sum(H_new, axis=0), AXIS) + 1e-15
        return H_new / d[None, :], d

    def _mse(b_li, b_val, W, d, H_loc, seed):
        dev = jax.lax.axis_index(AXIS)
        cell_ids_local = _local_cell_ids(dev)
        gene_ids = jnp.arange(genes_pad)
        Wd = W * d[None, :]

        def blk(acc, bi):
            start = bi * cell_block
            ids = jax.lax.dynamic_slice_in_dim(cell_ids_local, start,
                                               cell_block)
            m = _mask_of(seed, ids, gene_ids)
            li = _slice_planes(b_li, start, cell_block)
            lv = _slice_planes(b_val, start, cell_block)
            Hb = _slice2(H_loc, start, cell_block)
            s = jnp.zeros((cell_block,), W.dtype)
            n = jnp.zeros((cell_block,), jnp.int32)
            for gb, tile in _gb_tiles(li, lv):
                gsl = slice(gb * gene_block, (gb + 1) * gene_block)
                m_gb = m[:, gsl]
                pred = jnp.dot(Hb, Wd[gsl].T, precision=MM_PRECISION)
                diff2 = jnp.square(pred - tile)
                s = s + jnp.sum(jnp.where(m_gb, diff2, 0.0), axis=1)
                n = n + jnp.sum(m_gb, axis=1)
            return acc + jnp.sum(jnp.where(n > 0, s / jnp.maximum(n, 1),
                                           0.0)), None

        acc, _ = jax.lax.scan(blk, jnp.zeros((), W.dtype),
                              jnp.arange(cells_local // cell_block))
        return jax.lax.psum(acc, AXIS) / cells_true

    return dict(plain=_plain, masked=_masked, mse=_mse, project=_project)


def build_sharded_ell_fit_loop(data: ShardedEllData, inv_density: int,
                               maxit: int, masked: bool,
                               linked: bool = False):
    """The whole (plain or masked, traceless) fit as ONE device program:
    ``lax.while_loop`` over the sharded ALS step under ``shard_map``.
    Returns (W, H, d, n_iter, tols[maxit]). One host sync per fit — the
    multi-chip twin of solvers/als.py:_fit_loop_device."""
    fns = _build_local_fns(data, inv_density, linked=linked)
    step = fns["masked"] if masked else fns["plain"]
    mesh = data.mesh

    def _loop(a_idx, a_val, ne_loc, gene_ne, W, H, *extra):
        # extra = (..., tol_target, n_steps, tol0, exact0):
        #   ([link_h_loc, link_w,] L1_h, L1_w, L2_h, L2_w, tol_target,
        #    n_steps, tol0, exact0) plain
        #   (seed, L1_h, L1_w, L2_h, L2_w, k_true, tol_target, n_steps,
        #    tol0, exact0) masked
        # n_steps is a traced budget <= the static maxit, letting chunked
        # callers run a partial final chunk on the same compiled program;
        # tol0/exact0 carry the previous chunk's tol and adaptive-sweep
        # exact-phase latch so a chunked fit follows the same sweep schedule
        # as an unchunked one (fresh fits pass 1.0 / False).
        args = extra[:-4]
        tol_target, n_steps, tol0, exact0 = extra[-4:]
        k = W.shape[1]

        def cond(st):
            it, _, _, _, tolv, _, _ = st
            return (it < maxit) & (it < n_steps) & (tolv > tol_target)

        def body(st):
            it, W, H, d, tolv, exact, tols = st
            cap, exact = sweep_cap_update(exact, tolv, tol_target,
                                          masked=masked)
            W, H, d, tolv = step(a_idx, a_val, ne_loc, gene_ne, W, H, *args,
                                 sweep_cap=cap)
            tols = tols.at[it].set(tolv)
            return (it + 1, W, H, d, tolv, exact, tols)

        st0 = (jnp.int32(0), W, H, jnp.ones((k,), W.dtype),
               jnp.asarray(tol0, jnp.float32), jnp.asarray(exact0, bool),
               jnp.full((maxit,), jnp.nan, jnp.float32))
        it, W, H, d, _, exact, tols = jax.lax.while_loop(cond, body, st0)
        return W, H, d, it, tols, exact

    specs_a = (P(None, AXIS), P(None, AXIS), P(AXIS), P(None))
    if masked:
        extra_specs = (P(None), P(), P(), P(), P(), P(), P(), P(), P(), P())
    else:
        link_specs = (P(AXIS, None), P(None, None)) if linked else ()
        extra_specs = link_specs + (P(), P(), P(), P(), P(), P(), P(), P())
    return jax.jit(jax.shard_map(
        _loop, mesh=mesh,
        in_specs=specs_a + (P(None, None), P(AXIS, None)) + extra_specs,
        out_specs=(P(None, None), P(AXIS, None), P(None), P(), P(), P()),
        check_vma=False))


def build_sharded_ell_ard_loop(data: ShardedEllData, inv_density: int,
                               maxit: int, trace_every: int,
                               max_traces: int):
    """The whole masked-CV fit — trace schedule, overfit score, early stop —
    as ONE device program under ``shard_map``; the multi-chip twin of
    solvers/ard.py:_ard_loop_device with identical bookkeeping (incl. the
    reference's break-before-increment on early stop,
    reference:src/singlet.cpp:1106-1141)."""
    fns = _build_local_fns(data, inv_density)
    masked = fns["masked"]
    mse = fns["mse"]
    mesh = data.mesh

    def _loop(a_idx, a_val, ne_loc, gene_ne, W, H, seed,
              L1, L2, k_true, tol_target, overfit_threshold):
        k = W.shape[1]
        nanf = jnp.float32(jnp.nan)

        def cond(st):
            it, _, _, _, tolv, stopped = st[:6]
            return (~stopped) & (it < maxit) & (tolv > tol_target)

        def body(st):
            (it, W, H, d, tolv, stopped, min_err, n_tr, tmse, t_iters,
             scores, tols, exact) = st
            cap, exact = sweep_cap_update(exact, tolv, tol_target,
                                          masked=True)
            W, H, d, tolv = masked(a_idx, a_val, ne_loc,
                                   gene_ne, W, H, seed, L1, L1, L2, L2,
                                   k_true, sweep_cap=cap)
            tols = tols.at[it].set(tolv)

            def with_trace(args):
                min_err, n_tr, tmse, t_iters, scores, stopped = args
                err = mse(a_idx, a_val, W, d, H, seed)
                min_err = jnp.minimum(min_err, err)
                score = (err - min_err) / (err + min_err)
                tmse = tmse.at[n_tr].set(err)
                t_iters = t_iters.at[n_tr].set(it)
                scores = scores.at[n_tr].set(score)
                return (min_err, n_tr + 1, tmse, t_iters, scores,
                        score > overfit_threshold)

            traced = (it % trace_every) == 0
            min_err, n_tr, tmse, t_iters, scores, stopped = jax.lax.cond(
                traced, with_trace, lambda a: a,
                (min_err, n_tr, tmse, t_iters, scores, stopped))
            it = jnp.where(stopped, it, it + 1)  # break before it+=1
            return (it, W, H, d, tolv, stopped, min_err, n_tr, tmse,
                    t_iters, scores, tols, exact)

        st0 = (jnp.int32(0), W, H, jnp.ones((k,), W.dtype),
               jnp.float32(1.0), jnp.bool_(False), jnp.float32(jnp.inf),
               jnp.int32(0), jnp.full((max_traces,), nanf),
               jnp.full((max_traces,), -1, jnp.int32),
               jnp.full((max_traces,), nanf),
               jnp.full((maxit,), nanf), jnp.bool_(False))
        (it, W, H, d, _, stopped, _, n_tr, tmse, t_iters, scores,
         tols, _) = jax.lax.while_loop(cond, body, st0)
        return W, H, d, it, stopped, n_tr, tmse, t_iters, scores, tols

    specs_a = (P(None, AXIS), P(None, AXIS), P(AXIS), P(None))
    return jax.jit(jax.shard_map(
        _loop, mesh=mesh,
        in_specs=specs_a + (P(None, None), P(AXIS, None), P(None),
                            P(), P(), P(), P(), P()),
        out_specs=(P(None, None), P(AXIS, None), P(None), P(), P(), P(),
                   P(None), P(None), P(None), P(None)),
        check_vma=False))


def build_sharded_ell_gcnmf_loop(data: ShardedEllData,
                                 g_data: ShardedEllData, maxit: int):
    """Graph-convolutional NMF (``c_gcnmf``, reference:src/singlet.cpp:
    1668-1730) as ONE fused device program over the sharded ELL engine —
    the scale route for GCNMF (the dense solver holds a (cells, cells) G
    in HBM; this one holds G as cell-sharded blocked-ELL planes, sparse).

    Per iteration (reference semantics exactly):
      1. B = A^T W per local cell block (SpMM over A planes);
      2. all_gather B (the graph couples cells across shards — neighbor
         cells may live on other devices; this is the step's only extra
         collective, (cells_pad, k) over ICI);
      3. convolved RHS Bc = G^T B per local cell block (SpMM over the G
         planes, whose "gene" axis is the global neighbor-cell axis), then
         the H NNLS solves — ALL columns, like the reference (its
         ``gcnmf_update_h`` convolve+solve loop has no empty-column skip,
         so a cell with an empty A column but graph neighbors still gets a
         nonzero RHS);
      4. all_gather the rescaled H, convolve GH = G^T H per block, and
         accumulate the w-update RHS over the SAME A-planes
         (``B_w += tile^T @ GH_b``) — the Gram stays AAt(h), NOT AAt(GH)
         (reference:src/singlet.cpp:1693-1710).
    """
    mesh = data.mesh
    n_dev = mesh.shape[AXIS]
    cells_local = data.cells_pad // n_dev
    cell_block = data.cell_block
    genes_pad, genes_true = data.genes_pad, data.genes_true
    gene_block = data.gene_block
    assert g_data.genes_pad == data.cells_pad, (
        "G planes' row axis must be padded to the engine's cells_pad")
    spmm_a_b, spmm_a_bw = _make_spmm_fns(
        gene_block, genes_pad // gene_block, 20)
    spmm_g_b, _ = _make_spmm_fns(
        g_data.gene_block, g_data.genes_pad // g_data.gene_block, 20)

    def _slice_planes(arr, start, size):
        return jax.lax.dynamic_slice_in_dim(arr, start, size, 1)

    def _slice2(arr, start, size):
        return jax.lax.dynamic_slice_in_dim(arr, start, size, 0)

    def step(a_li, a_val, g_li, g_val, W, H_loc, L1_h, L1_w, L2_h, L2_w,
             sweep_cap):
        k = W.shape[1]
        a_w = jnp.dot(W.T, W, precision=MM_PRECISION) + 1e-15 * jnp.eye(k)
        n_blocks = cells_local // cell_block

        def b_blk(_, bi):
            start = bi * cell_block
            li = _slice_planes(a_li, start, cell_block)
            lv = _slice_planes(a_val, start, cell_block)
            return None, spmm_a_b(li, lv, W)

        _, Bs = jax.lax.scan(b_blk, None, jnp.arange(n_blocks))
        B_glob = jax.lax.all_gather(Bs.reshape(cells_local, k), AXIS,
                                    tiled=True)          # (cells_pad, k)

        def h_blk(carry, bi):
            Hsum, Hgram = carry
            start = bi * cell_block
            gli = _slice_planes(g_li, start, cell_block)
            glv = _slice_planes(g_val, start, cell_block)
            Bc = spmm_g_b(gli, glv, B_glob)
            Y0 = _slice2(H_loc, start, cell_block)
            Hb = solve_nnls(a_w, Bc, Y0, L1=L1_h, L2=L2_h,
                            sweep_cap=sweep_cap)
            return (Hsum + jnp.sum(Hb, axis=0),
                    Hgram + jnp.dot(Hb.T, Hb, precision=MM_PRECISION)), Hb

        (Hsum, Hgram), Hs = jax.lax.scan(
            h_blk, (jnp.zeros((k,), W.dtype), jnp.zeros((k, k), W.dtype)),
            jnp.arange(n_blocks))
        d = jax.lax.psum(Hsum, AXIS) + 1e-15
        H_new = Hs.reshape(cells_local, k) / d[None, :]
        a_h = jax.lax.psum(Hgram, AXIS) / (d[:, None] * d[None, :])
        a_h = a_h + 1e-15 * jnp.eye(k)
        H_glob = jax.lax.all_gather(H_new, AXIS, tiled=True)

        def w_blk(Bw, bi):
            start = bi * cell_block
            gli = _slice_planes(g_li, start, cell_block)
            glv = _slice_planes(g_val, start, cell_block)
            GH_b = spmm_g_b(gli, glv, H_glob)
            li = _slice_planes(a_li, start, cell_block)
            lv = _slice_planes(a_val, start, cell_block)
            return Bw + spmm_a_bw(li, lv, GH_b), None

        Bw, _ = jax.lax.scan(w_blk, jnp.zeros((genes_pad, k), W.dtype),
                             jnp.arange(n_blocks))
        Bw = jax.lax.psum(Bw, AXIS)

        def wsolve_blk(_, bi):
            start = bi * gene_block
            B = jax.lax.dynamic_slice_in_dim(Bw, start, gene_block, 0)
            Y0 = jax.lax.dynamic_slice_in_dim(W, start, gene_block, 0)
            return None, solve_nnls(a_h, B, Y0, L1=L1_w, L2=L2_w,
                                    sweep_cap=sweep_cap)

        _, Ws = jax.lax.scan(wsolve_blk, None,
                             jnp.arange(genes_pad // gene_block))
        W_new = Ws.reshape(genes_pad, k)
        d = jnp.sum(W_new, axis=0) + 1e-15
        W_new = W_new / d[None, :]
        tol = cor_distance(W_new[:genes_true], W[:genes_true])
        return W_new, H_new, d, tol

    def _loop(a_li, a_val, g_li, g_val, W, H, L1_h, L1_w, L2_h, L2_w,
              tol_target, n_steps):
        k = W.shape[1]

        def cond(st):
            it, _, _, _, tolv, _, _ = st
            return (it < maxit) & (it < n_steps) & (tolv > tol_target)

        def body(st):
            it, W, H, d, tolv, exact, tols = st
            cap, exact = sweep_cap_update(exact, tolv, tol_target)
            W, H, d, tolv = step(a_li, a_val, g_li, g_val, W, H,
                                 L1_h, L1_w, L2_h, L2_w, cap)
            tols = tols.at[it].set(tolv)
            return (it + 1, W, H, d, tolv, exact, tols)

        st0 = (jnp.int32(0), W, H, jnp.ones((k,), W.dtype),
               jnp.float32(1.0), jnp.bool_(False),
               jnp.full((maxit,), jnp.nan, jnp.float32))
        it, W, H, d, _, _, tols = jax.lax.while_loop(cond, body, st0)
        return W, H, d, it, tols

    plane_spec = P(None, AXIS)
    return jax.jit(jax.shard_map(
        _loop, mesh=mesh,
        in_specs=(plane_spec,) * 4 + (P(None, None), P(AXIS, None),
                                      P(), P(), P(), P(), P(), P()),
        out_specs=(P(None, None), P(AXIS, None), P(None), P(), P()),
        check_vma=False))


def build_sharded_ell_batch_loop(data: ShardedEllData, n_batches: int,
                                 maxit: int):
    """Batch-aware L1-matrix NMF (``c_nmf_batch``,
    reference:src/singlet.cpp:677-710) as ONE fused device program over the
    sharded ELL engine — the scale route for the experimental batch solver
    (the dense one densifies A). The per-(factor, batch) penalty
    (``calc_L1_matrix``, :281-311, documented intent — see
    solvers/batch.py) is computed ON DEVICE each iteration from the
    current H: per-batch mean loadings via a one-hot matmul psum'ed over
    shards, then ``pen[:, b] = mean_b - mean(other batches' means)``; the
    h-solves then take a per-(cell, factor) L1 array."""
    mesh = data.mesh
    n_dev = mesh.shape[AXIS]
    cells_local = data.cells_pad // n_dev
    cell_block = data.cell_block
    genes_pad, genes_true = data.genes_pad, data.genes_true
    gene_block = data.gene_block
    spmm_b, spmm_bw = _make_spmm_fns(gene_block, genes_pad // gene_block, 20)

    def _slice_planes(arr, start, size):
        return jax.lax.dynamic_slice_in_dim(arr, start, size, 1)

    def _slice2(arr, start, size):
        return jax.lax.dynamic_slice_in_dim(arr, start, size, 0)

    def step(a_li, a_val, ne_loc, onehot_loc, counts, W, H_loc,
             L1, L2, sweep_cap):
        k = W.shape[1]
        # per-(cell, factor) L1 from the CURRENT H (reference recomputes
        # the matrix each iteration before the h update, :692-695)
        sums = jax.lax.psum(
            jnp.dot(H_loc.T, onehot_loc, precision=MM_PRECISION), AXIS)
        means = sums / counts[None, :]                      # (k, nb)
        pen = means - (jnp.sum(means, axis=1, keepdims=True) - means) \
            / max(n_batches - 1, 1)
        L1_loc = jnp.dot(onehot_loc, pen.T,
                         precision=MM_PRECISION) + L1       # (cells_loc, k)

        a_w = jnp.dot(W.T, W, precision=MM_PRECISION) + 1e-15 * jnp.eye(k)
        n_blocks = cells_local // cell_block

        def blk(carry, bi):
            Bw, Hsum, Hgram = carry
            start = bi * cell_block
            li = _slice_planes(a_li, start, cell_block)
            lv = _slice_planes(a_val, start, cell_block)
            B = spmm_b(li, lv, W)
            Y0 = _slice2(H_loc, start, cell_block)
            ne = _slice2(ne_loc, start, cell_block)
            L1b = _slice2(L1_loc, start, cell_block)
            Hb = solve_nnls(a_w, B, Y0, L1=L1b, L2=L2, update_mask=ne,
                            sweep_cap=sweep_cap)
            Bw = Bw + spmm_bw(li, lv, Hb)
            return (Bw, Hsum + jnp.sum(Hb, axis=0),
                    Hgram + jnp.dot(Hb.T, Hb, precision=MM_PRECISION)), Hb

        carry0 = (jnp.zeros((genes_pad, k), W.dtype),
                  jnp.zeros((k,), W.dtype), jnp.zeros((k, k), W.dtype))
        (Bw, Hsum, Hgram), Hs = jax.lax.scan(blk, carry0,
                                             jnp.arange(n_blocks))
        d = jax.lax.psum(Hsum, AXIS) + 1e-15
        H_new = Hs.reshape(cells_local, k) / d[None, :]
        a_h = jax.lax.psum(Hgram, AXIS) / (d[:, None] * d[None, :])
        a_h = a_h + 1e-15 * jnp.eye(k)
        Bw = jax.lax.psum(Bw, AXIS) / d[None, :]

        def w_blk(_, bi):
            start = bi * gene_block
            B = jax.lax.dynamic_slice_in_dim(Bw, start, gene_block, 0)
            Y0 = jax.lax.dynamic_slice_in_dim(W, start, gene_block, 0)
            return None, solve_nnls(a_h, B, Y0, L1=L1, L2=L2,
                                    sweep_cap=sweep_cap)

        _, Ws = jax.lax.scan(w_blk, None,
                             jnp.arange(genes_pad // gene_block))
        W_new = Ws.reshape(genes_pad, k)
        d = jnp.sum(W_new, axis=0) + 1e-15
        W_new = W_new / d[None, :]
        tol = cor_distance(W_new[:genes_true], W[:genes_true])
        return W_new, H_new, d, tol

    def _loop(a_li, a_val, ne_loc, onehot_loc, counts, W, H,
              L1, L2, tol_target, n_steps):
        k = W.shape[1]

        def cond(st):
            it, _, _, _, tolv, _, _ = st
            return (it < maxit) & (it < n_steps) & (tolv > tol_target)

        def body(st):
            it, W, H, d, tolv, exact, tols = st
            cap, exact = sweep_cap_update(exact, tolv, tol_target)
            W, H, d, tolv = step(a_li, a_val, ne_loc, onehot_loc, counts,
                                 W, H, L1, L2, cap)
            tols = tols.at[it].set(tolv)
            return (it + 1, W, H, d, tolv, exact, tols)

        st0 = (jnp.int32(0), W, H, jnp.ones((k,), W.dtype),
               jnp.float32(1.0), jnp.bool_(False),
               jnp.full((maxit,), jnp.nan, jnp.float32))
        it, W, H, d, _, _, tols = jax.lax.while_loop(cond, body, st0)
        return W, H, d, it, tols

    return jax.jit(jax.shard_map(
        _loop, mesh=mesh,
        in_specs=(P(None, AXIS), P(None, AXIS), P(AXIS),
                  P(AXIS, None), P(None), P(None, None), P(AXIS, None),
                  P(), P(), P(), P()),
        out_specs=(P(None, None), P(AXIS, None), P(None), P(), P()),
        check_vma=False))


def _as_pair(x) -> Tuple[float, float]:
    if isinstance(x, (tuple, list)):
        return float(x[0]), float(x[1] if len(x) > 1 else x[0])
    return float(x), float(x)


class ShardedEllEngine:
    """Dataset-resident multi-chip sparse NMF engine.

    Holds the sharded ELL planes plus the compiled step/loop programs
    (cached per mask density and loop statics) so a rank search re-uses
    compilations across fits — the analogue of the reference keeping A/At
    alive for a whole ``ard_nmf`` search (reference:R/ard_nmf.R:57-97),
    plus ``k_bucket`` factor padding so distinct ranks share programs.
    This is the engine the drivers route to when given a ``mesh``.
    """

    def __init__(self, A: Optional[sp.spmatrix], mesh: Optional[Mesh] = None,
                 cell_block: int = 2048, gene_block: int = 512,
                 data: Optional[ShardedEllData] = None) -> None:
        self.mesh = (data.mesh if data is not None
                     else (mesh or make_mesh()))
        self.data = data if data is not None else shard_ell_data(
            A, self.mesh, cell_block=cell_block, gene_block=gene_block)
        self._steps = {}
        self._loops = {}

    # driver-facing geometry (mirrors the provider protocol)
    @property
    def rows_pad(self) -> int:
        return self.data.genes_pad

    @property
    def rows_true(self) -> int:
        return self.data.genes_true

    @property
    def cols_true(self) -> int:
        return self.data.cells_true

    def steps(self, inv_density: int, linked: bool = False):
        key = (inv_density, linked)
        if key not in self._steps:
            self._steps[key] = build_sharded_ell_steps(
                self.data, inv_density, linked=linked)
        return self._steps[key]

    def fit_loop(self, inv_density: int, maxit: int, masked: bool,
                 linked: bool = False):
        key = ("fit", inv_density, maxit, masked, linked)
        if key not in self._loops:
            self._loops[key] = build_sharded_ell_fit_loop(
                self.data, inv_density, maxit, masked, linked=linked)
        return self._loops[key]

    def ard_loop(self, inv_density: int, maxit: int, trace_every: int,
                 max_traces: int):
        key = ("ard", inv_density, maxit, trace_every, max_traces)
        if key not in self._loops:
            self._loops[key] = build_sharded_ell_ard_loop(
                self.data, inv_density, maxit, trace_every, max_traces)
        return self._loops[key]

    def _state(self, k: int, w_init, seed: int, k_bucket: int = 1):
        data = self.data
        k = int(k)
        k_pad = (k if k_bucket <= 1
                 else ((k + k_bucket - 1) // k_bucket) * k_bucket)
        W = jnp.zeros((data.genes_pad, k_pad), jnp.float32)
        if w_init is None:
            key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x5117)
            w = jax.random.uniform(key, (data.genes_pad, k),
                                   dtype=jnp.float32)
            w = jnp.where(
                (jnp.arange(data.genes_pad) < data.genes_true)[:, None],
                w, 0.0)
            W = W.at[:, :k].set(w)
        else:
            W = W.at[: w_init.shape[0], :k].set(
                jnp.asarray(w_init, jnp.float32))
        W = jax.device_put(W, NamedSharding(self.mesh, P(None, None)))
        H = jax.device_put(jnp.zeros((data.cells_pad, k_pad), jnp.float32),
                           NamedSharding(self.mesh, P(AXIS, None)))
        args = (data.b_li, data.b_val, data.nonempty, data.gene_nonempty)
        return W, H, args, k_pad

    # ---------------------------------------------------------------- fits
    def fit(self, k: int, tol: float = 1e-4, maxit: int = 100,
            L1=0.01, L2=0.0, seed: int = 0, verbose: bool = False,
            w_init: Optional[np.ndarray] = None,
            masked: bool = False, inv_density: int = 20,
            mask_seed: int = 0,
            checkpoint: Optional[Union[str, CheckpointManager]] = None,
            chunk_iters: Optional[int] = None,
            link_h: Optional[np.ndarray] = None,
            link_w: Optional[np.ndarray] = None):
        """Plain (or masked, without traces) sharded fit; returns the same
        dict shape ``sharded_ell_nmf_fit`` always has. L1/L2 may be scalars
        or (w, h) pairs — both sides reach both half-updates (the masked
        path previously dropped the w side; now supported).

        ``link_h`` (cells, k) / ``link_w`` (genes, k): 0/1 linking masks
        for linked NMF (``c_linked_nmf``, reference:src/singlet.cpp:
        1059-1086) — link_h is cell-sharded over the mesh, link_w
        replicated. Links are a plain-fit feature (the reference's masked
        ARD solver takes none).

        ``chunk_iters``: run the fused device loop in chunks of this many
        iterations per device call (semantics unchanged — the loop's own
        tol check stops inside a chunk). Default None = the whole fit in
        one call. Chunks bound the length of one device execution, so a
        caller can observe progress or stop between chunks at the cost of
        one host sync per chunk."""
        k = int(k)
        linked = link_h is not None or link_w is not None
        if linked and masked:
            raise ValueError("linked NMF has no masked (CV) variant "
                             "(reference c_ard_nmf takes no link matrices)")
        _, masked_step, mse_fn = self.steps(inv_density)
        W, H, args, _ = self._state(k, w_init, seed)
        sp_ = seed_pair(mask_seed)
        L1_w, L1_h = _as_pair(L1)
        L2_w, L2_h = _as_pair(L2)

        link_args = ()
        if linked:
            data = self.data
            lh = np.ones((data.cells_pad, k), np.float32)
            if link_h is not None:
                link_h = np.asarray(link_h, np.float32)
                if link_h.shape != (data.cells_true, k):
                    raise ValueError(
                        f"link_h must be (cells, k) = ({data.cells_true}, "
                        f"{k}), got {link_h.shape}")
                lh[: data.cells_true] = link_h
            lw = np.ones((data.genes_pad, k), np.float32)
            if link_w is not None:
                link_w = np.asarray(link_w, np.float32)
                if link_w.shape != (data.genes_true, k):
                    raise ValueError(
                        f"link_w must be (genes, k) = ({data.genes_true}, "
                        f"{k}), got {link_w.shape}")
                lw[: data.genes_true] = link_w
            link_args = (
                jax.device_put(lh, NamedSharding(self.mesh, P(AXIS, None))),
                jax.device_put(lw, NamedSharding(self.mesh, P(None, None))),
            )

        from singlet_tpu.tracing import get_metric_logger

        logger = get_metric_logger()
        fit_id = logger.new_fit_id("sharded_ell")
        logger.log("fit_start", fit=fit_id, algo="sharded_ell_fit", k=k,
                   genes=int(self.data.genes_true),
                   cells=int(self.data.cells_true),
                   n_devices=int(self.mesh.devices.size),
                   masked=bool(masked), linked=bool(linked), maxit=maxit)
        mgr = resolve_manager(checkpoint)
        traces = []
        it = 0
        tol_ = 1.0
        d = jnp.ones((k,), jnp.float32)
        ckpt_config = CheckpointManager.config_of(
            algo="sharded_ell_fit", k=k, masked=bool(masked),
            genes_pad=int(self.data.genes_pad),
            cells_pad=int(self.data.cells_pad), L1=[L1_w, L1_h],
            L2=[L2_w, L2_h], seed=int(seed), mask_seed=int(mask_seed),
            inv_density=int(inv_density),
            linked=[link_h is not None, link_w is not None])
        if mgr is not None:
            st = mgr.restore(ckpt_config, verbose=bool(verbose))
            if st is not None:
                W = jax.device_put(jnp.asarray(st["W"]),
                                   NamedSharding(self.mesh, P(None, None)))
                H = jax.device_put(jnp.asarray(st["H"]),
                                   NamedSharding(self.mesh, P(AXIS, None)))
                d = jnp.asarray(st["d"])
                traces = list(st["tol_trace"])
                it = int(st["it"])
                tol_ = traces[-1] if traces else 1.0

        if mgr is None:
            chunk = int(maxit if chunk_iters is None
                        else min(chunk_iters, maxit))
            loop = self.fit_loop(inv_density, chunk, bool(masked), linked)
            exact = jnp.bool_(False)
            tol0 = jnp.float32(tol_)
            while it < maxit and tol_ > tol:
                budget = jnp.int32(min(chunk, maxit - it))
                if masked:
                    W, H, d, n_it, tols, exact = loop(
                        *args, W, H, sp_, jnp.float32(L1_h),
                        jnp.float32(L1_w), jnp.float32(L2_h),
                        jnp.float32(L2_w), jnp.int32(k), jnp.float32(tol),
                        budget, tol0, exact)
                else:
                    W, H, d, n_it, tols, exact = loop(
                        *args, W, H, *link_args, jnp.float32(L1_h),
                        jnp.float32(L1_w), jnp.float32(L2_h),
                        jnp.float32(L2_w), jnp.float32(tol), budget,
                        tol0, exact)
                n = int(n_it)
                new = [float(t) for t in np.asarray(tols[:n])]
                traces.extend(new)
                it += n
                tol_ = traces[-1] if traces else tol_
                tol0 = jnp.float32(tol_)
                if n < int(budget):     # converged inside the chunk
                    break
            if verbose:
                for i, t in enumerate(traces):
                    print(f"{i + 1:4d} | {t:8.2e}")
        else:
            plain_step = self.steps(inv_density, linked)[0]
            # host-side twin of the fused loop's exact-phase latch
            from singlet_tpu.ops.nnls import CD_EXACT_TOL
            thresh_ = max(10.0 * tol, CD_EXACT_TOL)
            exact = jnp.bool_(any(t <= thresh_ for t in traces))
            while it < maxit and tol_ > tol:
                cap, exact = sweep_cap_update(exact, jnp.float32(tol_),
                                              jnp.float32(tol),
                                              masked=bool(masked))
                cap = jnp.float32(1e9) if cap is None else cap
                if masked:
                    W, H, d, tol_j = masked_step(
                        *args, W, H, sp_, jnp.float32(L1_h),
                        jnp.float32(L1_w), jnp.float32(L2_h),
                        jnp.float32(L2_w), jnp.int32(k), cap)
                else:
                    W, H, d, tol_j = plain_step(*args, W, H, *link_args,
                                                jnp.float32(L1_h),
                                                jnp.float32(L1_w),
                                                jnp.float32(L2_h),
                                                jnp.float32(L2_w), cap)
                tol_ = float(tol_j)
                traces.append(tol_)
                if verbose:
                    print(f"{it + 1:4d} | {tol_:8.2e}")
                it += 1
                if mgr.should_save(it):
                    mgr.save(it, dict(
                        ckpt_config, W=np.asarray(W), H=np.asarray(H),
                        d=np.asarray(d), tol_trace=traces))

        for i, t in enumerate(traces):
            logger.log("iteration", fit=fit_id, iter=i + 1, tol=t)
        logger.log("fit_end", fit=fit_id, n_iter=len(traces),
                   tol=traces[-1] if traces else None)
        out = dict(
            w=np.asarray(W[: self.data.genes_true]),
            d=np.asarray(d),
            h=np.asarray(H[: self.data.cells_true]).T,
            tol_trace=traces,
        )
        if masked:
            out["test_mse"] = float(
                mse_fn(self.data.b_li, self.data.b_val, W, d, H, sp_))
        return out

    def project(self, w: np.ndarray, L1: float = 0.01, L2: float = 0.0):
        """Project the dataset's cells onto a frozen factor model
        (``c_project_model``, reference:src/singlet.cpp:405-413): normalize
        w's factor columns, one cold-start NNLS h half-update over the
        sharded ELL planes, rescale. Returns (h (k, cells), d (k,)).

        This is the scale path for ProjectData
        (reference:R/ProjectData.R:37-110) — the operand stays in sharded
        sparse storage; no densification anywhere."""
        data = self.data
        w = np.asarray(w, np.float32)
        if w.shape[0] != data.genes_true:
            if w.shape[1] == data.genes_true:
                w = w.T
            else:
                raise ValueError("'w' must share a common edge with the "
                                 "gene axis of the dataset")
        k = w.shape[1]
        key = ("project",)
        if key not in self._loops:
            fns = _build_local_fns(data, 20)
            self._loops[key] = jax.jit(jax.shard_map(
                fns["project"], mesh=self.mesh,
                in_specs=(P(None, AXIS), P(None, AXIS), P(AXIS),
                          P(None, None), P(), P()),
                out_specs=(P(AXIS, None), P(None)),
                check_vma=False))
        W = jnp.zeros((data.genes_pad, k), jnp.float32)
        W = W.at[: data.genes_true].set(jnp.asarray(w))
        W = jax.device_put(W, NamedSharding(self.mesh, P(None, None)))
        H, d = self._loops[key](data.b_li, data.b_val, data.nonempty, W,
                                jnp.float32(L1), jnp.float32(L2))
        return np.asarray(H[: data.cells_true]).T, np.asarray(d)

    def gcnmf_fit(self, G, k: int, tol: float = 1e-4, maxit: int = 100,
                  L1=0.01, L2=0.0, seed: int = 0, w_init=None,
                  verbose: bool = False):
        """Graph-convolutional NMF over the sharded ELL engine — the scale
        route for ``c_gcnmf`` (reference:src/singlet.cpp:1668-1730). ``G``
        is a SPARSE (cells, cells) graph (LKNN/SNN output); it is packed
        into a second set of cell-sharded blocked-ELL planes whose "gene"
        axis is the global neighbor-cell axis, so the graph never
        densifies (the dense solver's (cells, cells) G caps at ~50k cells
        on one chip). Equivalence-tested against the dense solver at small
        shapes."""
        data = self.data
        G = sp.csc_matrix(G).astype(np.float32)
        if G.shape != (data.cells_true, data.cells_true):
            raise ValueError(
                f"G must be cells x cells = ({data.cells_true}, "
                f"{data.cells_true}), got {G.shape}")
        # pad G's row (neighbor) axis to cells_pad so the packed planes'
        # gene axis matches the all_gathered (cells_pad, k) operands
        Gp = sp.csc_matrix((G.data, G.indices, G.indptr),
                           shape=(data.cells_pad, data.cells_true))
        key = ("gcnmf", int(maxit))
        g_data = shard_ell_data(Gp, self.mesh, cell_block=data.cell_block,
                                gene_block=data.gene_block)
        if key not in self._loops:
            self._loops[key] = build_sharded_ell_gcnmf_loop(
                data, g_data, int(maxit))
        loop = self._loops[key]
        W, H, _, _ = self._state(k, w_init, seed)
        L1_w, L1_h = _as_pair(L1)
        L2_w, L2_h = _as_pair(L2)
        W, H, d, n_it, tols = loop(
            data.b_li, data.b_val, g_data.b_li, g_data.b_val, W, H,
            jnp.float32(L1_h), jnp.float32(L1_w), jnp.float32(L2_h),
            jnp.float32(L2_w), jnp.float32(tol), jnp.int32(maxit))
        n = int(n_it)
        traces = [float(t) for t in np.asarray(tols[:n])]
        if verbose:
            for i, t in enumerate(traces):
                print(f"{i + 1:4d} | {t:8.2e}")
        return dict(
            w=np.asarray(W[: data.genes_true]),
            d=np.asarray(d),
            h=np.asarray(H[: data.cells_true]).T,
            tol_trace=traces,
        )

    def batch_fit(self, batch_id, k: int, tol: float = 1e-4,
                  maxit: int = 100, L1: float = 0.01, L2: float = 0.0,
                  seed: int = 0, w_init=None, verbose: bool = False):
        """Batch-aware L1-matrix NMF over the sharded ELL engine — the
        scale route for ``c_nmf_batch`` (reference:src/singlet.cpp:
        677-710). ``batch_id``: per-cell 0-based ints (or labels)."""
        data = self.data
        batch_id = np.asarray(batch_id)
        if batch_id.dtype.kind not in "iu":
            _, batch_id = np.unique(batch_id, return_inverse=True)
        if batch_id.size != data.cells_true:
            raise ValueError("batch_id vector must be of the same length "
                             "as the number of columns in A")
        nb = int(batch_id.max()) + 1
        onehot = np.zeros((data.cells_pad, nb), np.float32)
        onehot[np.arange(data.cells_true), batch_id] = 1.0
        # empty batches: sum is 0, so clamping the divisor reproduces the
        # dense solver's zero mean instead of 0/0
        counts = np.maximum(onehot.sum(axis=0), 1.0)
        key = ("batch", nb, int(maxit))
        if key not in self._loops:
            self._loops[key] = build_sharded_ell_batch_loop(
                data, nb, int(maxit))
        loop = self._loops[key]
        W, H, args, _ = self._state(k, w_init, seed)
        oh = jax.device_put(onehot,
                            NamedSharding(self.mesh, P(AXIS, None)))
        W, H, d, n_it, tols = loop(
            data.b_li, data.b_val, data.nonempty, oh,
            jnp.asarray(counts), W, H, jnp.float32(L1), jnp.float32(L2),
            jnp.float32(tol), jnp.int32(maxit))
        n = int(n_it)
        traces = [float(t) for t in np.asarray(tols[:n])]
        if verbose:
            for i, t in enumerate(traces):
                print(f"{i + 1:4d} | {t:8.2e}")
        return dict(
            w=np.asarray(W[: data.genes_true]),
            d=np.asarray(d),
            h=np.asarray(H[: data.cells_true]).T,
            tol_trace=traces,
        )

    def ard_fit(self, k: int, w_init=None, mask_seed: int = 0,
                inv_density: int = 20, tol: float = 1e-4, maxit: int = 100,
                L1: float = 0.01, L2: float = 0.0,
                overfit_threshold: float = 1e-3, trace_test_mse: int = 1,
                verbose: int = 0, init_seed: int = 0,
                checkpoint: Optional[Union[str, CheckpointManager]] = None,
                k_bucket: int = 8):
        """Masked fit with test-MSE traces and overfit early-stop — the
        multi-chip twin of ``solvers.ard.ard_nmf_fit`` (semantics from
        reference:src/singlet.cpp:1106-1141), consumed by the drivers'
        rank-search loops unchanged. Runs as one fused device program
        unless checkpointing is requested (that path needs per-iteration
        host control). ``k_bucket`` pads the compiled factor count so rank
        searches share programs."""
        from singlet_tpu.solvers.ard import ArdFitResult
        from singlet_tpu.utils import vprint

        k = int(k)
        _, masked_step, mse_fn = self.steps(inv_density)
        mgr = resolve_manager(checkpoint)
        W, H, args, k_pad = self._state(k, w_init, init_seed,
                                        k_bucket if mgr is None else 1)
        d = jnp.ones((k_pad,), jnp.float32)
        sp_ = seed_pair(mask_seed)

        test_mse_t, iter_t, tol_t, score_t = [], [], [], []
        tol_ = 1.0
        it = 0
        stopped_early = False

        if mgr is None:
            max_traces = (maxit + trace_test_mse - 1) // trace_test_mse + 1
            loop = self.ard_loop(inv_density, int(maxit),
                                 int(trace_test_mse), int(max_traces))
            (W, H, d, it_j, stopped_j, n_tr_j, tmse_a, titer_a, score_a,
             tols_a) = loop(*args, W, H, sp_, jnp.float32(L1),
                            jnp.float32(L2), jnp.int32(k), jnp.float32(tol),
                            jnp.float32(overfit_threshold))
            it = int(it_j)
            stopped_early = bool(stopped_j)
            n_tr = int(n_tr_j)
            tols_np = np.asarray(tols_a)
            test_mse_t = [float(v) for v in np.asarray(tmse_a[:n_tr])]
            iter_t = [int(v) for v in np.asarray(titer_a[:n_tr])]
            tol_t = [float(tols_np[i]) for i in iter_t]
            score_t = [float(v) for v in np.asarray(score_a[:n_tr])]
            last_idx = it if stopped_early else it - 1
            tol_ = float(tols_np[last_idx]) if last_idx >= 0 else tol_
            if verbose >= 3:
                ti = {i: j for j, i in enumerate(iter_t)}
                n_steps = it if not stopped_early else it + 1
                for i in range(n_steps):
                    if i in ti:
                        vprint(verbose, 3,
                               f"{i + 1:4d} | {tols_np[i]:8.2e} | "
                               f"{score_t[ti[i]]:8.2e}")
                    else:
                        vprint(verbose, 3,
                               f"{i + 1:4d} | {tols_np[i]:8.2e} |        -")
        else:
            ckpt_config = CheckpointManager.config_of(
                algo="sharded_ell_ard", k=k,
                genes_pad=int(self.data.genes_pad),
                cells_pad=int(self.data.cells_pad), L1=L1, L2=L2,
                mask_seed=int(mask_seed), inv_density=int(inv_density),
                trace=int(trace_test_mse))
            st = mgr.restore(ckpt_config, verbose=verbose >= 1)
            if st is not None:
                W = jax.device_put(jnp.asarray(st["W"]),
                                   NamedSharding(self.mesh, P(None, None)))
                H = jax.device_put(jnp.asarray(st["H"]),
                                   NamedSharding(self.mesh, P(AXIS, None)))
                d = jnp.asarray(st["d"])
                test_mse_t = list(st["test_mse"])
                iter_t = [int(i) for i in st["iter"]]
                tol_t = list(st["tol"])
                score_t = list(st["score_overfit"])
                it = int(st["it"])
                tol_ = tol_t[-1] if tol_t else 1.0
            # host-side twin of the fused loop's exact-phase latch,
            # recovered from the saved (traced-iteration) tol trace on resume
            from singlet_tpu.ops.nnls import CD_EXACT_TOL
            thresh_ = max(10.0 * tol, CD_EXACT_TOL)
            exact = jnp.bool_(any(t <= thresh_ for t in tol_t))
            while it < maxit and tol_ > tol:
                cap, exact = sweep_cap_update(exact, jnp.float32(tol_),
                                              jnp.float32(tol), masked=True)
                cap = jnp.float32(1e9) if cap is None else cap
                W, H, d, tol_j = masked_step(*args, W, H, sp_,
                                             jnp.float32(L1),
                                             jnp.float32(L1),
                                             jnp.float32(L2),
                                             jnp.float32(L2), jnp.int32(k),
                                             cap)
                tol_ = float(tol_j)
                if it % trace_test_mse == 0:
                    err = float(mse_fn(self.data.b_li, self.data.b_val,
                                       W, d, H, sp_))
                    test_mse_t.append(err)
                    iter_t.append(it)
                    tol_t.append(tol_)
                    min_err = min(test_mse_t)
                    score = (err - min_err) / (err + min_err)
                    score_t.append(score)
                    vprint(verbose, 3,
                           f"{it + 1:4d} | {tol_:8.2e} | {score:8.2e}")
                    if score > overfit_threshold:
                        stopped_early = True
                        break
                else:
                    vprint(verbose, 3, f"{it + 1:4d} | {tol_:8.2e} |        -")
                it += 1
                if mgr.should_save(it):
                    mgr.save(it, dict(
                        ckpt_config, W=np.asarray(W), H=np.asarray(H),
                        d=np.asarray(d), test_mse=test_mse_t, iter=iter_t,
                        tol=tol_t, score_overfit=score_t))

        if (it % trace_test_mse != 0 and not stopped_early
                and (not iter_t or iter_t[-1] != it)):
            err = float(mse_fn(self.data.b_li, self.data.b_val,
                               W, d, H, sp_))
            test_mse_t.append(err)
            iter_t.append(it)
            tol_t.append(tol_)
            min_err = min(test_mse_t)
            score_t.append((err - min_err) / (err + min_err))

        return ArdFitResult(
            w=np.asarray(W[: self.data.genes_true, :k]),
            d=np.asarray(d[:k]),
            h=np.asarray(H[: self.data.cells_true, :k]).T,
            test_mse=test_mse_t, iter=iter_t, tol=tol_t,
            score_overfit=score_t,
        )


def sharded_ell_nmf_fit(A: sp.spmatrix, k: int, mesh: Optional[Mesh] = None,
                        tol: float = 1e-4, maxit: int = 100,
                        L1=0.01, L2=0.0, seed: int = 0,
                        masked: bool = False, inv_density: int = 20,
                        mask_seed: int = 0, verbose: bool = False,
                        w_init: Optional[np.ndarray] = None,
                        data: Optional[ShardedEllData] = None,
                        checkpoint=None, chunk_iters: Optional[int] = None,
                        link_h: Optional[np.ndarray] = None,
                        link_w: Optional[np.ndarray] = None):
    """Sparse sharded NMF fit. Semantics identical to the dense engines."""
    engine = ShardedEllEngine(A, mesh=mesh, data=data)
    return engine.fit(k, tol=tol, maxit=maxit, L1=L1, L2=L2, seed=seed,
                      verbose=verbose, w_init=w_init, masked=masked,
                      inv_density=inv_density, mask_seed=mask_seed,
                      checkpoint=checkpoint, chunk_iters=chunk_iters,
                      link_h=link_h, link_w=link_w)
