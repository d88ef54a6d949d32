"""Batch-aware L1-matrix NMF (experimental parity feature).

Equivalent of ``c_nmf_batch`` (reference:src/singlet.cpp:677-710) with
``calc_L1_matrix`` (:281-311) and ``predict_L1_matrix`` (:314-328): during the
h update, each (factor, cell) coordinate receives an extra L1 penalty equal to
the difference between the factor's mean loading in the cell's batch and its
mean loading across the other batches — penalizing batch-specific factors.

Reference quirks not reproduced (its experimental code indexes the penalty
matrix by cell column and leaves batch 0 uninitialized — out-of-bounds /
uninitialized reads in Eigen): we implement the documented intent, expanding
the (k, n_batches) penalty to per-cell columns via each cell's batch id.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from singlet_tpu.model import NMFModel
from singlet_tpu.ops.linalg import MM_PRECISION, cor_distance, gram, scale_columns
from singlet_tpu.ops.nnls import solve_nnls
from singlet_tpu.solvers.drivers import _coerce_dense, _finalize
from singlet_tpu.utils import enable_compilation_cache


def calc_l1_matrix(h: np.ndarray, batch_id: np.ndarray) -> np.ndarray:
    """Per-(factor, batch) penalty: mean loading in batch minus mean of the
    per-batch means of the other batches (reference:src/singlet.cpp:281-311,
    intended semantics). h: (k, cells); batch_id: 0-based ints per cell."""
    h = np.asarray(h)
    batch_id = np.asarray(batch_id)
    n_batches = int(batch_id.max()) + 1
    means = np.zeros((h.shape[0], n_batches))
    for b in range(n_batches):
        sel = batch_id == b
        if sel.any():
            means[:, b] = h[:, sel].mean(axis=1)
    out = np.zeros_like(means)
    if n_batches < 2:
        # a single batch has no "other batches" to contrast against — the
        # penalty is zero (the reference never exercises this; its delete+
        # mean would produce NaN)
        return out
    for b in range(n_batches):
        others = np.delete(means, b, axis=1)
        out[:, b] = means[:, b] - others.mean(axis=1)
    return out


def nmf_batch(A, k: int, batch_id, tol: float = 1e-4, maxit: int = 100,
              L1: float = 0.01, L2: float = 0.0, seed: int = 0,
              verbose: bool = False, gene_names=None,
              cell_names=None, w_init=None, mesh=None) -> NMFModel:
    """ALS NMF with batch-aware per-coordinate L1 on the h update.

    Without ``mesh``: the single-chip dense solver. With ``mesh``: the
    sharded ELL engine (A stays sparse; the per-batch penalty matrix is
    computed on device each iteration) — the scale route."""
    enable_compilation_cache()
    if mesh is not None:
        import scipy.sparse as _sp

        from singlet_tpu.parallel.sharded_ell import ShardedEllEngine

        if not _sp.issparse(A):
            A = _sp.csc_matrix(np.asarray(A, np.float32))
        eng = ShardedEllEngine(A, mesh=mesh)
        out = eng.batch_fit(batch_id, k, tol=tol, maxit=maxit, L1=L1,
                            L2=L2, seed=seed, w_init=w_init,
                            verbose=verbose)
        return _finalize(out["w"], out["d"], out["h"],
                         gene_names, cell_names)
    A = _coerce_dense(A)
    batch_id = np.asarray(batch_id)
    if batch_id.dtype.kind not in "iu":
        _, batch_id = np.unique(batch_id, return_inverse=True)
    genes, cells = A.shape
    if batch_id.size != cells:
        raise ValueError("batch_id vector must be of the same length as the "
                         "number of columns in A")
    if w_init is not None:
        W = jnp.asarray(w_init, jnp.float32)
    else:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x5117)
        W = jax.random.uniform(key, (genes, k), dtype=jnp.float32)
    H = jnp.zeros((cells, k), jnp.float32)
    Aj = jnp.asarray(A)
    bid = jnp.asarray(batch_id.astype(np.int32))
    nonempty = jnp.any(Aj != 0, axis=0)

    @jax.jit
    def step(W, H, L1_cells, sweep_cap=None):
        a_w = gram(W)
        B = jnp.dot(Aj.T, W, precision=MM_PRECISION)
        # per-(cell, factor) L1: base scalar + batch penalty
        H = solve_nnls(a_w, B, H, L1=L1_cells, L2=L2, update_mask=nonempty,
                       sweep_cap=sweep_cap)
        H, d = scale_columns(H)
        a_h = gram(H)
        B_w = jnp.dot(Aj, H, precision=MM_PRECISION)
        W_new = solve_nnls(a_h, B_w, W, L1=L1, L2=L2, sweep_cap=sweep_cap)
        W_new, d = scale_columns(W_new)
        tol = cor_distance(W_new, W)
        return W_new, H, d, tol

    from singlet_tpu.ops.nnls import sweep_cap_update

    tol_ = 1.0
    it = 0
    d = jnp.ones((k,), jnp.float32)
    exact = jnp.bool_(False)   # adaptive-sweep exact-phase latch
    while it < maxit and tol_ > tol:
        cap, exact = sweep_cap_update(exact, jnp.float32(tol_),
                                      jnp.float32(tol))
        L1m = calc_l1_matrix(np.asarray(H).T, batch_id)   # (k, n_batches)
        L1_cells = jnp.asarray(L1m.T[batch_id], jnp.float32) + jnp.float32(L1)
        W, H, d, tol_j = step(W, H, L1_cells, sweep_cap=cap)
        tol_ = float(tol_j)
        if verbose:
            print(f"{it + 1:4d} | {tol_:8.2e}")
        it += 1
    return _finalize(np.asarray(W), np.asarray(d), np.asarray(H).T,
                     gene_names, cell_names)
