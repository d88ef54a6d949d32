"""Dense helpers: Gram matrices, factor rescaling, convergence metric.

Equivalents of the reference's Eigen helpers
(reference:src/singlet.cpp:184-225). Everything here is plain XLA — these
ops are dense, small, and fuse well.

Layout conventions (differ from the reference on purpose — we batch NNLS over
the *rows* of the factor matrices):
  W: (genes, k)   factor loadings   (reference keeps w as k x genes)
  H: (cells, k)   sample embeddings (reference keeps h as k x cells)
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

# All f32 matmuls in the solver run at highest precision by default:
# convergence of the CD-NNLS fixed point and CV-curve shape is sensitive to
# Gram accuracy. On a GPU, HIGHEST is full IEEE f32 (no TF32); HIGH and
# DEFAULT let XLA use TF32 tensor cores. SINGLET_TPU_MM_PRECISION=high opts
# into the relaxation; benchmarks/precision_invariance.py is the guard that
# the CV curve and selected rank do not move under it.
MM_PRECISION = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}[os.environ.get("SINGLET_TPU_MM_PRECISION", "highest").lower()]

# The masked-CV packed-Gram products (mask @ packed outer products) are the
# largest matmuls of the masked path. The mask operand is exact at any
# precision (0/1); only the packed outer products round, and each output
# entry sums ~genes*density independent rounded terms. These products
# (alone) therefore run at DEFAULT precision: f32 dots that XLA may run as
# TF32 on a GPU (10-bit mantissa operands, f32 accumulation). The guards are
# benchmarks/precision_invariance.py (CV curve and selected rank) and the
# mesh-vs-dense equivalence tests. SINGLET_TPU_MASK_MM_PRECISION=highest
# restores full-f32 products. On the CPU every precision is exact f32.
MASK_MM_PRECISION = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
    "": jax.lax.Precision.DEFAULT,
}[os.environ.get("SINGLET_TPU_MASK_MM_PRECISION", "").lower()]


def gram(X: jnp.ndarray) -> jnp.ndarray:
    """X^T X with 1e-15 diagonal jitter.

    Equivalent of ``AAt`` (reference:src/singlet.cpp:200-206) under our
    transposed layout: the reference computes w w^T for w of shape (k, m); we
    store the factor matrix as (m, k) so the same k x k Gram is X^T X.
    """
    a = jnp.dot(X.T, X, precision=MM_PRECISION)
    return a + 1e-15 * jnp.eye(a.shape[0], dtype=a.dtype)


def scale_columns(X: jnp.ndarray):
    """Normalize columns of X to sum to one; return (X_normalized, d).

    Equivalent of ``scale`` (reference:src/singlet.cpp:219-225): the reference
    scales *rows* of its (k, m) factor matrix; our factors live in columns.
    d gets the pre-normalization column sums (+1e-15).
    """
    d = jnp.sum(X, axis=0) + 1e-15
    return X / d[None, :], d


def cor_distance(x: jnp.ndarray, y: jnp.ndarray,
                 n_true=None) -> jnp.ndarray:
    """1 - Pearson correlation between two equally-shaped matrices.

    The ALS convergence metric (reference:src/singlet.cpp:184-197): computed
    over all entries of consecutive-iteration W matrices.

    ``n_true`` (traced scalar) overrides the element count when x/y carry
    rank-bucketing padding columns (solvers/ard.py): the padded columns are
    exactly zero in both matrices, so every sum below is unaffected — only
    the Pearson denominator's n must reflect the true factor count.
    """
    xf = x.ravel()
    yf = y.ravel()
    n = xf.shape[0] if n_true is None else n_true
    sum_x = jnp.sum(xf)
    sum_y = jnp.sum(yf)
    sum_xy = jnp.dot(xf, yf, precision=MM_PRECISION)
    sum_x2 = jnp.dot(xf, xf, precision=MM_PRECISION)
    sum_y2 = jnp.dot(yf, yf, precision=MM_PRECISION)
    denom = jnp.sqrt((n * sum_x2 - sum_x * sum_x) * (n * sum_y2 - sum_y * sum_y))
    return 1.0 - (n * sum_xy - sum_x * sum_y) / denom


def triu_pairs(k: int):
    """Static upper-triangle index pair (i, j) arrays for k x k, i <= j."""
    return np.triu_indices(k)


def packed_outer_products(X: jnp.ndarray, iu) -> jnp.ndarray:
    """Columns of all pairwise products X[:, i] * X[:, j] for i <= j.

    Used by the masked-Gram trick: for a 0/1 mask tile M (cells x genes) the
    per-cell Gram correction sum_{j in mask_c} X_j X_j^T equals
    ``unpack(M @ P)`` with P = packed_outer_products(X). This turns the
    reference's per-cell ``submat``+``AAt`` loop
    (reference:src/singlet.cpp:447-462) into one matmul.
    """
    return X[:, iu[0]] * X[:, iu[1]]


def unpack_sym(packed: jnp.ndarray, k: int, iu) -> jnp.ndarray:
    """Inverse of the triangular packing: (..., npairs) -> (..., k, k).

    Implemented as a STATIC-index gather (a pure permutation copy), not a
    scatter. The (i, j) entry reads the packed position of its sorted
    pair, covering both triangles in one take."""
    pos = _sym_pos(k, iu)
    batch = packed.shape[:-1]
    return jnp.take(packed, jnp.asarray(pos.reshape(-1)),
                    axis=-1).reshape(batch + (k, k))


def pad_pairs(iu, np_pad: int):
    """Pad the triangular index pairs to ``np_pad`` entries with (0, 0)
    pairs. The padded tail of a packed-product array then holds X0*X0
    duplicates — garbage that no consumer reads (the unpack gathers only
    true-pair positions) — but keeps every packed axis a multiple of 128,
    a tile-friendly width for the products."""
    npairs = iu[0].shape[0]
    pad = np.zeros((np_pad - npairs,), iu[0].dtype)
    return (np.concatenate([iu[0], pad]), np.concatenate([iu[1], pad]))


def mask_dot_t(P, m, m_contract_dim: int) -> jnp.ndarray:
    """Masked packed-Gram product: contract dim 0 of the packed-product
    matrix ``P`` against ``m_contract_dim`` of the dense mask ``m``,
    yielding the (npairs, n) orientation the Gram-correction unpack
    consumes (``unpack_sym_from_t``) with no relayout. Runs at
    ``MASK_MM_PRECISION``: an f32 dot at DEFAULT precision, which a GPU
    may run as TF32."""
    dims = (((0,), (m_contract_dim,)), ((), ()))
    return jax.lax.dot_general(P, m.astype(P.dtype), dims,
                               precision=MASK_MM_PRECISION,
                               preferred_element_type=P.dtype)


def unpack_sym_from_t(packed_t: jnp.ndarray, k: int, iu,
                      a_full: jnp.ndarray) -> jnp.ndarray:
    """Per-column Grams ``a_full - unpack(packed_c)`` in the coordinate-tile
    layout (k, k, n), ``at[i, j, c] = a_c[j, i]``, from TRANSPOSED packed
    corrections ``packed_t`` (np_pad, n) — the orientation ``mask_dot_t``
    emits. Pure static row-gather; pad rows (>= npairs) are never
    indexed."""
    pos = _sym_pos(k, iu)
    up = jnp.take(packed_t, jnp.asarray(pos.reshape(-1)), axis=0)
    return (a_full.reshape(k * k, 1) - up).reshape(k, k, packed_t.shape[1])


def _sym_pos(k: int, iu) -> np.ndarray:
    """(k, k) map from matrix position to packed-triangle index."""
    npairs = iu[0].shape[0]
    pos = np.zeros((k, k), np.int32)
    ar = np.arange(npairs, dtype=np.int32)
    pos[iu[0], iu[1]] = ar
    pos[iu[1], iu[0]] = ar
    return pos

