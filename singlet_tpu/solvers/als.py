"""The alternating-least-squares NMF engine (single-chip path).

TPU-native re-design of the reference solver loops
(``c_nmf_base`` reference:src/singlet.cpp:639-666, ``c_ard_nmf_base``
:1091-1152): each half-iteration is one fused XLA program — Gram (MXU),
B = P^T X product (MXU), batched CD-NNLS over all columns at once
(ops/nnls.py), column rescale, convergence metric — instead of an OpenMP loop
of per-column scalar solves.

Masked (cross-validation) updates block over columns: for each column block
the speckled test mask is recomputed on device from the counter RNG
(never materialized globally), the operand tile is mask-multiplied for the
training B product, and the per-column Gram corrections
``a_c = X^T X - sum_{masked j} X_j X_j^T`` (reference:src/singlet.cpp:447-464)
come from one packed-outer-product matmul (ops/linalg.py:mask_dot_t).

Semantics preserved from the reference:
  * warm-started NNLS + column rescale => damped (EMA-like) ALS updates;
  * empty columns are skipped, retaining their previous values;
  * tol = 1 - Pearson(w_iter, w_prev) on true (unpadded) entries;
  * masked test-set MSE counts *all* masked entries incl. zeros, averaged
    per column then across columns (reference:src/singlet.cpp:536-568).
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from singlet_tpu.ops.linalg import (
    MM_PRECISION,
    cor_distance,
    gram,
    mask_dot_t,
    packed_outer_products,
    scale_columns,
    triu_pairs,
)
from singlet_tpu.checkpoint import CheckpointManager, resolve_manager
from singlet_tpu.ops.nnls import (solve_nnls, solve_nnls_packed_t,
                                  sweep_cap_update)
from singlet_tpu.ops.rngmask import seed_pair
from singlet_tpu.sparse.matrix import DenseMatrix
from singlet_tpu.tracing import get_metric_logger
from singlet_tpu.utils import is_scipy_sparse


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pick_block(n_true: int, target: int, quantum: int = 256) -> int:
    """Choose a column-block size: single block for small axes (minimal
    padding), otherwise the configured target."""
    if n_true <= target:
        return _round_up(n_true, quantum)
    return target


def make_dense_providers(A, cell_block: int = 2048,
                         gene_block: int = 4096,
                         dtype=jnp.float32) -> Tuple[DenseMatrix, DenseMatrix]:
    """Build (A, At) dense providers from a genes x cells array (numpy or
    scipy sparse), padded so each provider's column axis divides its
    masked-update block size.

    scipy-sparse inputs ship only their COO triplets to the device and
    densify there with one scatter — scRNA matrices are ~95% zeros, so the
    triplets are a fraction of the dense transfer, and the transpose copy
    is made on device.
    """
    is_sparse = is_scipy_sparse(A)
    genes, cells = A.shape
    cb = pick_block(cells, cell_block)
    gb = pick_block(genes, gene_block)
    cells_pad = _round_up(cells, cb)
    genes_pad = _round_up(genes, gb)

    if is_sparse:
        coo = A.tocoo()
        data = jnp.zeros((genes_pad, cells_pad), dtype)
        data = data.at[jnp.asarray(coo.row, jnp.int32),
                       jnp.asarray(coo.col, jnp.int32)].add(
            jnp.asarray(coo.data, dtype))
    else:
        A = np.asarray(A)
        buf = np.zeros((genes_pad, cells_pad), dtype=np.float32)
        buf[:genes, :cells] = A
        data = jnp.asarray(buf, dtype=dtype)

    nonempty_cells = jnp.any(data != 0, axis=0)
    nonempty_genes = jnp.any(data != 0, axis=1)
    Ap = DenseMatrix(
        data=data,
        nonempty=nonempty_cells,
        rows_true=genes, cols_true=cells, cols_are_cells=True, block=cb,
    )
    Atp = DenseMatrix(
        data=data.T,
        nonempty=nonempty_genes,
        rows_true=cells, cols_true=genes, cols_are_cells=False, block=gb,
    )
    return Ap, Atp


# --------------------------------------------------------------------------
# Half-updates
# --------------------------------------------------------------------------

def _half_update(P: DenseMatrix, X, Y_warm, L1, L2, link=None,
                 sweep_cap=None):
    """Unmasked half-update: solve P's columns against factor matrix X.

    Equivalent of ``predict`` / ``predict_link``
    (reference:src/singlet.cpp:333-347,416-433).
    """
    a = gram(X)
    B = P.t_matmul(X)
    if link is not None:
        B = B * link
    return solve_nnls(a, B, Y_warm, L1=L1, L2=L2, update_mask=P.nonempty,
                      sweep_cap=sweep_cap)


def _half_update_masked(P: DenseMatrix, X, Y_warm, seed, L1, L2,
                        inv_density: int, block: int, n_coord=None,
                        sweep_cap=None):
    """Masked half-update over column blocks (reference:src/singlet.cpp:436-466)."""
    k = X.shape[1]
    a_full = gram(X)
    iu = triu_pairs(k)
    P_pairs = packed_outer_products(X, iu)          # (rows_pad, npairs)
    cols_pad = P.cols_pad
    assert cols_pad % block == 0, (cols_pad, block)
    n_blocks = cols_pad // block

    def body(_, bi):
        col_start = bi * block
        m = P.mask_tile(seed, col_start, block, inv_density)     # (blk, rows)
        tile = P.col_block(col_start, block)                     # (rows, blk)
        keep = jnp.where(m.T, jnp.zeros((), X.dtype), jnp.ones((), X.dtype))
        B = jnp.dot((tile * keep).T, X, precision=MM_PRECISION)  # (blk, k)
        packed_t = mask_dot_t(P_pairs, m.astype(X.dtype), 1)
        Y0 = jax.lax.dynamic_slice_in_dim(Y_warm, col_start, block, axis=0)
        ne = jax.lax.dynamic_slice_in_dim(P.nonempty, col_start, block, axis=0)
        Y = solve_nnls_packed_t(a_full, packed_t, iu, B, Y0, L1=L1, L2=L2,
                                update_mask=ne, n_coord=n_coord,
                                sweep_cap=sweep_cap)
        return None, Y

    _, Ys = jax.lax.scan(body, None, jnp.arange(n_blocks))
    return Ys.reshape(cols_pad, k)


@partial(jax.jit, static_argnames=("inv_density", "block"))
def mse_test(A: DenseMatrix, W, d, H, seed, inv_density: int, block: int):
    """Held-out test-set MSE (reference:src/singlet.cpp:536-568).

    mean over cells of (sum over masked genes of (w d h - A)^2 / n_masked).
    """
    Wd = W * d[None, :]
    cols_pad = A.cols_pad
    n_blocks = cols_pad // block

    def body(acc, bi):
        col_start = bi * block
        m = A.mask_tile(seed, col_start, block, inv_density)      # (blk, genes)
        tile = A.col_block(col_start, block)                      # (genes, blk)
        Hb = jax.lax.dynamic_slice_in_dim(H, col_start, block, axis=0)
        pred = jnp.dot(Hb, Wd.T, precision=MM_PRECISION)          # (blk, genes)
        diff2 = jnp.square(pred - tile.T)
        s = jnp.sum(jnp.where(m, diff2, 0.0), axis=1)
        n = jnp.sum(m, axis=1)
        losses = jnp.where(n > 0, s / jnp.maximum(n, 1), 0.0)
        return acc + jnp.sum(losses), None

    total, _ = jax.lax.scan(body, jnp.zeros((), W.dtype), jnp.arange(n_blocks))
    return total / A.cols_true


# --------------------------------------------------------------------------
# Full ALS iterations (one fused jit each)
# --------------------------------------------------------------------------

@jax.jit
def als_step(A: DenseMatrix, At: DenseMatrix, W, H, L1_h, L1_w, L2_h, L2_w,
             link_h=None, link_w=None, sweep_cap=None):
    """One ALS iteration: h-update, rescale, w-update, rescale, tol.

    reference:src/singlet.cpp:647-664 (c_nmf_base) and :1073-1084 (linked).
    """
    H = _half_update(A, W, H, L1_h, L2_h, link=link_h, sweep_cap=sweep_cap)
    H, d = scale_columns(H)
    W_new = _half_update(At, H, W, L1_w, L2_w, link=link_w,
                         sweep_cap=sweep_cap)
    W_new, d = scale_columns(W_new)
    tol = cor_distance(W_new[: At.cols_true], W[: At.cols_true])
    return W_new, H, d, tol


@partial(jax.jit, static_argnames=("inv_density", "cell_block", "gene_block"))
def als_step_masked(A: DenseMatrix, At: DenseMatrix, W, H, seed, L1, L2,
                    inv_density: int, cell_block: int, gene_block: int,
                    k_true=None, sweep_cap=None):
    """One masked ALS iteration (reference:src/singlet.cpp:1107-1114).

    ``k_true`` (traced int scalar) supports rank bucketing: W/H may carry
    zero-padded factor columns beyond k_true (they provably stay exactly
    zero through the CD-NNLS updates — zero Gram rows/RHS plus the
    clamp-at-zero — so only the Pearson tol's element count needs it).
    """
    n_coord = None if k_true is None else jnp.asarray(k_true, jnp.float32)
    H = _half_update_masked(A, W, H, seed, L1, L2, inv_density, cell_block,
                            n_coord, sweep_cap=sweep_cap)
    H, d = scale_columns(H)
    W_new = _half_update_masked(At, H, W, seed, L1, L2, inv_density,
                                gene_block, n_coord, sweep_cap=sweep_cap)
    W_new, d = scale_columns(W_new)
    n_true = None if k_true is None else At.cols_true * k_true
    tol = cor_distance(W_new[: At.cols_true], W[: At.cols_true], n_true)
    return W_new, H, d, tol


# --------------------------------------------------------------------------
# Device-fused fit loop
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("maxit",))
def _fit_loop_device(A: DenseMatrix, At: DenseMatrix, W, H, L1_h, L1_w,
                     L2_h, L2_w, link_h, link_w, tol_target, maxit: int):
    """The whole ALS fit as ONE device program (lax.while_loop over
    als_step), returning (W, H, d, n_iter, tol_trace[maxit]).

    Rationale: the host-side loop costs a blocking device->host sync per
    iteration for the tol check; one fused program syncs once per *fit*.
    Identical per-iteration semantics — the tol test runs every iteration,
    on device (reference:src/singlet.cpp:647-664).
    """
    k = W.shape[1]

    def cond(st):
        it, _, _, _, tolv, _, _ = st
        return (it < maxit) & (tolv > tol_target)

    def body(st):
        it, W, H, d, tolv, exact, tols = st
        cap, exact = sweep_cap_update(exact, tolv, tol_target)
        W, H, d, tolv = als_step(A, At, W, H, L1_h, L1_w, L2_h, L2_w,
                                 link_h, link_w, sweep_cap=cap)
        tols = tols.at[it].set(tolv)
        return (it + 1, W, H, d, tolv, exact, tols)

    # tol starts at 1.0 exactly like the host loop, so a tol_target >= 1
    # yields zero iterations in both paths
    st0 = (jnp.int32(0), W, H, jnp.ones((k,), W.dtype),
           jnp.float32(1.0), jnp.bool_(False),
           jnp.full((maxit,), jnp.nan, jnp.float32))
    it, W, H, d, _, _, tols = jax.lax.while_loop(cond, body, st0)
    return W, H, d, it, tols


# --------------------------------------------------------------------------
# Fit drivers
# --------------------------------------------------------------------------

@dataclasses.dataclass
class FitResult:
    w: np.ndarray            # (genes, k) — true rows only
    d: np.ndarray            # (k,)
    h: np.ndarray            # (k, cells) — reference orientation
    tol: float
    n_iter: int
    tol_trace: list


def _as_pair(x) -> Tuple[float, float]:
    if isinstance(x, (tuple, list)):
        return float(x[0]), float(x[1] if len(x) > 1 else x[0])
    return float(x), float(x)


def init_w(k: int, genes_pad: int, genes_true: int, seed: int) -> jnp.ndarray:
    """Uniform(0,1) init of W (genes, k), zero on padded rows.

    Counterpart of ``w_init = matrix(runif(nrow(A) * rank), rank, nrow(A))``
    (reference:R/run_nmf.R:56). Nested inits for rank search slice columns
    of a k_max-wide matrix (reference:R/ard_nmf.R:72,105)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x5117)
    w = jax.random.uniform(key, (genes_pad, k), dtype=jnp.float32)
    rows = jnp.arange(genes_pad) < genes_true
    return jnp.where(rows[:, None], w, 0.0)


def nmf_fit(
    A: Union[np.ndarray, DenseMatrix],
    k: int,
    At: Optional[DenseMatrix] = None,
    w_init: Optional[jnp.ndarray] = None,
    tol: float = 1e-4,
    maxit: int = 100,
    L1: Union[float, Tuple[float, float]] = 0.01,
    L2: Union[float, Tuple[float, float]] = 0.0,
    seed: int = 0,
    verbose: bool = False,
    link_h: Optional[jnp.ndarray] = None,
    link_w: Optional[jnp.ndarray] = None,
    checkpoint: Optional[Union[str, CheckpointManager]] = None,
) -> FitResult:
    """Fit NMF by ALS: the engine under ``run_nmf`` (reference:R/run_nmf.R:18-77,
    solver loop reference:src/singlet.cpp:639-666).

    L1/L2 may be scalars or (w, h) pairs, matching ``c_nmf``'s split
    penalties. ``link_h``/``link_w`` are 0/1 linking masks of shape
    (cells, k) / (genes, k) for linked NMF (reference:src/singlet.cpp:1059-1086).

    ``checkpoint`` (a directory path or CheckpointManager) enables periodic
    atomic state saves and automatic resume; a resumed fit continues
    bit-identically (the ALS recurrence is deterministic given state). No
    reference counterpart — singlet restarts crashed fits from zero.
    """
    if At is not None:
        Ap, Atp = A, At        # caller-built providers (dense or ELL)
    else:
        Ap, Atp = make_dense_providers(np.asarray(A))

    genes_pad = Ap.rows_pad
    cells_pad = Ap.cols_pad
    if w_init is None:
        W = init_w(k, genes_pad, Ap.rows_true, seed)
    else:
        W = jnp.zeros((genes_pad, k), jnp.float32)
        W = W.at[: w_init.shape[0]].set(jnp.asarray(w_init, jnp.float32))
    H = jnp.zeros((cells_pad, k), jnp.float32)
    d = jnp.ones((k,), jnp.float32)

    L1_w, L1_h = _as_pair(L1)
    L2_w, L2_h = _as_pair(L2)

    if link_h is not None:
        lh = jnp.zeros((cells_pad, k), jnp.float32)
        link_h = lh.at[: link_h.shape[0]].set(jnp.asarray(link_h, jnp.float32))
    if link_w is not None:
        lw = jnp.zeros((genes_pad, k), jnp.float32)
        link_w = lw.at[: link_w.shape[0]].set(jnp.asarray(link_w, jnp.float32))

    mgr = resolve_manager(checkpoint)
    ckpt_config = CheckpointManager.config_of(
        algo="als", k=int(k), genes_pad=int(genes_pad),
        cells_pad=int(cells_pad), L1=[L1_w, L1_h], L2=[L2_w, L2_h],
        seed=int(seed), linked=[link_h is not None, link_w is not None],
    )
    tol_trace = []
    start_it = 0
    if mgr is not None:
        st = mgr.restore(ckpt_config, verbose=verbose)
        if st is not None:
            W = jnp.asarray(st["W"])
            H = jnp.asarray(st["H"])
            d = jnp.asarray(st["d"])
            tol_trace = list(st["tol_trace"])
            start_it = int(st["it"])

    logger = get_metric_logger()
    fit_id = logger.new_fit_id("als")
    logger.log("fit_start", fit=fit_id, algo="als", k=int(k),
               genes=int(Ap.rows_true), cells=int(Ap.cols_true),
               maxit=maxit, resumed_at=start_it or None)
    tol_ = tol_trace[-1] if tol_trace else 1.0

    if mgr is None:
        # fused device loop: one host sync per fit instead of one per
        # iteration (the checkpointing path needs per-iteration host control)
        t0 = time.perf_counter()
        W, H, d, n_it, tols = _fit_loop_device(
            Ap, Atp, W, H, jnp.float32(L1_h), jnp.float32(L1_w),
            jnp.float32(L2_h), jnp.float32(L2_w), link_h, link_w,
            jnp.float32(tol), maxit)
        n = int(n_it)
        per_ms = round((time.perf_counter() - t0) * 1e3 / max(n, 1), 3)
        tol_trace = [float(t) for t in np.asarray(tols[:n])]
        for i, t in enumerate(tol_trace):
            logger.log("iteration", fit=fit_id, iter=i + 1, tol=t, ms=per_ms)
            if verbose:
                print(f"{i + 1:4d} | {t:8.2e}")
        tol_ = tol_trace[-1] if tol_trace else 1.0
    else:
        # host-side twin of the fused loop's exact-phase latch; after a
        # checkpoint resume the latch state is recovered from the saved tol
        # trace (it would have fired iff any past tol crossed the threshold)
        from singlet_tpu.ops.nnls import CD_EXACT_TOL
        thresh_ = max(10.0 * tol, CD_EXACT_TOL)
        exact = jnp.bool_(any(t <= thresh_ for t in tol_trace))
        for it in range(start_it, maxit):
            if tol_ <= tol:
                break
            t0 = time.perf_counter()
            cap, exact = sweep_cap_update(exact, jnp.float32(tol_),
                                          jnp.float32(tol))
            W, H, d, tol_j = als_step(Ap, Atp, W, H, L1_h, L1_w, L2_h, L2_w,
                                      link_h, link_w, sweep_cap=cap)
            tol_ = float(tol_j)
            tol_trace.append(tol_)
            logger.log("iteration", fit=fit_id, iter=it + 1, tol=tol_,
                       ms=round((time.perf_counter() - t0) * 1e3, 3))
            if verbose:
                print(f"{it + 1:4d} | {tol_:8.2e}")
            if mgr.should_save(it + 1):
                mgr.save(it + 1, dict(
                    ckpt_config, W=np.asarray(W), H=np.asarray(H),
                    d=np.asarray(d), tol_trace=tol_trace))

    logger.log("fit_end", fit=fit_id, n_iter=len(tol_trace), tol=tol_)
    return FitResult(
        w=np.asarray(W[: Ap.rows_true]),
        d=np.asarray(d),
        h=np.asarray(H[: Ap.cols_true]).T,
        tol=tol_,
        n_iter=len(tol_trace),
        tol_trace=tol_trace,
    )
