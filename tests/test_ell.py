"""The single-chip sparse path: blocked-ELL engine routing + equivalences.

Large scipy-sparse inputs route to the transpose-free blocked-ELL engine on
a 1-device mesh — the same layout/packer/compute as the multi-chip path
(parallel/sharded_ell.py), with no scatter anywhere in the operand-sized
work (the blocked compare-sum formulation replaced a row-ELL scatter
densify).
"""

import numpy as np
import pytest
import scipy.sparse as sp

from singlet_tpu.parallel.sharded_ell import ShardedEllEngine
from singlet_tpu.solvers import drivers
from singlet_tpu.solvers.als import nmf_fit
from singlet_tpu.solvers.drivers import _engine_or_providers, run_nmf


def _sparse(rng, genes=60, cells=40, density=0.15):
    A = sp.random(genes, cells, density=density, random_state=7,
                  dtype=np.float32, format="csc")
    A.data = np.abs(A.data) + 0.1
    return A


def test_large_sparse_routes_to_engine(monkeypatch):
    """Above SPARSE_THRESHOLD, scipy inputs stay sparse on the blocked-ELL
    engine (1-device mesh); below it they densify."""
    monkeypatch.setattr(drivers, "SPARSE_THRESHOLD", 100)
    A = _sparse(np.random.default_rng(0))
    P = _engine_or_providers(A, None)
    assert isinstance(P, ShardedEllEngine)
    assert P.mesh.devices.size == 1
    assert P.rows_true == A.shape[0] and P.cols_true == A.shape[1]

    monkeypatch.setattr(drivers, "SPARSE_THRESHOLD", 64e6)
    P2 = _engine_or_providers(A, None)
    assert not isinstance(P2, ShardedEllEngine)


def test_engine_routed_fit_matches_dense(monkeypatch, rng):
    """run_nmf on the engine-routed sparse path == the dense single-chip
    engine (same counter-RNG keying, same ALS semantics)."""
    monkeypatch.setattr(drivers, "SPARSE_THRESHOLD", 100)
    A = _sparse(rng)
    k = 4
    w0 = rng.random((A.shape[0], k)).astype(np.float32)
    m_sparse = run_nmf(A, k, w_init=w0, tol=0.0, maxit=4)
    dense_res = nmf_fit(np.asarray(A.todense()), k, w_init=w0, tol=0.0,
                        maxit=4)
    np.testing.assert_allclose(m_sparse.w, dense_res.w[:, np.argsort(
        -dense_res.d)], rtol=2e-4, atol=2e-5)


def test_engine_routed_cv_matches_dense(monkeypatch, rng):
    """Masked CV traces on the engine route == dense-path traces."""
    monkeypatch.setattr(drivers, "SPARSE_THRESHOLD", 100)
    A = _sparse(rng)
    kw = dict(ranks=[2, 3], n_replicates=1, maxit=3, verbose=0,
              trace_test_mse=1, test_density=0.1, seed=4)
    df_sparse = drivers.cross_validate_nmf(A, **kw)
    monkeypatch.setattr(drivers, "SPARSE_THRESHOLD", 64e6)
    df_dense = drivers.cross_validate_nmf(np.asarray(A.todense()), **kw)
    assert list(df_sparse["k"]) == list(df_dense["k"])
    np.testing.assert_allclose(df_sparse["test_error"],
                               df_dense["test_error"], rtol=2e-3)


def test_no_scatter_in_operand_densify(rng):
    """The blocked-ELL tile densify + SpMM (the operand-sized work) lowers
    with no scatter op — it is a pure multiply-compare-sum chain + matmul.
    (The CD-NNLS solve still updates factor columns with tiny (block, k)
    scatters; this test pins the formulation that removed the operand
    scatter.)"""
    import jax
    import jax.numpy as jnp

    from singlet_tpu.parallel.sharded import make_mesh
    from singlet_tpu.parallel.sharded_ell import _bell_tile

    A = _sparse(np.random.default_rng(1), genes=64, cells=96)
    eng = ShardedEllEngine(A, mesh=make_mesh(1))
    data = eng.data
    n_gb = data.genes_pad // data.gene_block

    width = data.b_width

    def spmm(b_li, b_val, W):
        B = jnp.zeros((b_li.shape[1], W.shape[1]), W.dtype)
        for gb in range(n_gb):
            sl = slice(gb * width, (gb + 1) * width)
            tile = _bell_tile(b_li[sl], b_val[sl], data.gene_block)
            B = B + tile @ W[gb * data.gene_block:(gb + 1) * data.gene_block]
        return B

    W = jnp.zeros((data.genes_pad, 3))
    hlo = jax.jit(spmm).lower(data.b_li, data.b_val, W).as_text()
    assert "scatter" not in hlo.lower()
    assert "gather" not in hlo.lower()


def test_bell_tile_wide_plane_formulation_equivalence():
    """Planes wider than _BELL_TILE_UNROLL_MAX_WIDTH switch to the one-shot
    compare-and-reduce (traced-HLO size independent of width); both
    formulations must produce identical tiles."""
    import jax.numpy as jnp

    from singlet_tpu.parallel import sharded_ell
    from singlet_tpu.parallel.sharded_ell import _bell_tile

    rng = np.random.default_rng(5)
    block, width, gene_block = 16, 12, 32
    # 2-D device layout: (width, block) windows
    li = np.full((width, block), -1, np.int32)
    lv = np.zeros((width, block), np.float32)
    for c in range(block):
        n = rng.integers(0, width + 1)
        li[:n, c] = np.sort(rng.choice(gene_block, size=n, replace=False))
        lv[:n, c] = rng.random(n) + 0.1

    narrow = np.asarray(_bell_tile(jnp.asarray(li), jnp.asarray(lv),
                                   gene_block))
    try:
        orig = sharded_ell._BELL_TILE_UNROLL_MAX_WIDTH
        sharded_ell._BELL_TILE_UNROLL_MAX_WIDTH = width - 1
        wide = np.asarray(_bell_tile(jnp.asarray(li), jnp.asarray(lv),
                                     gene_block))
    finally:
        sharded_ell._BELL_TILE_UNROLL_MAX_WIDTH = orig
    np.testing.assert_array_equal(narrow, wide)

    dense = np.zeros((block, gene_block), np.float32)
    for c in range(block):
        for w in range(width):
            if li[w, c] >= 0:
                dense[c, li[w, c]] += lv[w, c]
    np.testing.assert_allclose(narrow, dense, rtol=1e-6)
