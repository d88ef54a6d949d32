"""Golden tests for the batched coordinate-descent NNLS solver.

Oracle 1: a straightforward per-column numpy implementation of the reference
CD semantics (reference:src/singlet.cpp:229-276), written independently in
float64 — validates exact algorithmic parity (warm starts, clamp/tolerance
rules, L1-matrix mode).
Oracle 2: scipy.optimize.nnls — validates that the cold-start solution is a
true NNLS optimum.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import scipy.optimize

from singlet_tpu.ops.nnls import nnls_batch


def nnls_cd_numpy(a, b, x, L1=0.0, L2=0.0, L1_vec=None, max_sweeps=100):
    """Reference-semantics CD on one column (float64)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64).copy()
    x = np.asarray(x, np.float64).copy()
    k = b.size
    tol = 1.0
    it = 0
    while it < max_sweeps and tol / k > 1e-8:
        tol = 0.0
        for i in range(k):
            diff = b[i] / a[i, i]
            if L1_vec is not None:
                diff -= L1_vec[i]
            if L1 != 0:
                diff -= L1
            if L2 != 0:
                diff += L2 * x[i]
            if -diff > x[i]:
                if x[i] != 0:
                    b -= a[:, i] * -x[i]
                    tol = 1.0
                    x[i] = 0.0
            elif diff != 0:
                x[i] += diff
                b -= a[:, i] * diff
                tol += abs(diff / (x[i] + 1e-15))
        it += 1
    return x


def _random_problem(rng, n, k, m=64):
    F = rng.random((m, k)).astype(np.float32)
    a = F.T @ F + 1e-15 * np.eye(k, dtype=np.float32)
    G = rng.random((m, n)).astype(np.float32)
    B = (F.T @ G).T  # (n, k)
    return F, a, G, B


def test_cold_start_matches_scipy(rng):
    F, a, G, B = _random_problem(rng, n=8, k=12)
    X = np.asarray(nnls_batch(jnp.asarray(a), jnp.asarray(B),
                              jnp.zeros_like(jnp.asarray(B))))
    for c in range(8):
        x_ref, _ = scipy.optimize.nnls(F.astype(np.float64), G[:, c].astype(np.float64))
        np.testing.assert_allclose(X[c], x_ref, rtol=2e-3, atol=2e-4)


def test_matches_reference_cd_semantics_cold(rng):
    _, a, _, B = _random_problem(rng, n=16, k=10)
    X = np.asarray(nnls_batch(jnp.asarray(a), jnp.asarray(B),
                              jnp.zeros((16, 10), jnp.float32)))
    for c in range(16):
        x_ref = nnls_cd_numpy(a, B[c], np.zeros(10))
        np.testing.assert_allclose(X[c], x_ref, rtol=2e-4, atol=2e-5)


def test_matches_reference_cd_semantics_warm(rng):
    """Warm starts reproduce the reference's damped-update behavior exactly."""
    _, a, _, B = _random_problem(rng, n=16, k=10)
    X0 = rng.random((16, 10)).astype(np.float32)
    X = np.asarray(nnls_batch(jnp.asarray(a), jnp.asarray(B), jnp.asarray(X0)))
    for c in range(16):
        x_ref = nnls_cd_numpy(a, B[c], X0[c])
        np.testing.assert_allclose(X[c], x_ref, rtol=5e-4, atol=5e-4)


def test_l1_l2_penalties(rng):
    _, a, _, B = _random_problem(rng, n=12, k=8)
    X = np.asarray(nnls_batch(jnp.asarray(a), jnp.asarray(B),
                              jnp.zeros((12, 8), jnp.float32), L1=0.05, L2=0.01))
    for c in range(12):
        x_ref = nnls_cd_numpy(a, B[c], np.zeros(8), L1=0.05, L2=0.01)
        np.testing.assert_allclose(X[c], x_ref, rtol=1e-3, atol=1e-4)
    # L1 increases sparsity
    X_plain = np.asarray(nnls_batch(jnp.asarray(a), jnp.asarray(B),
                                    jnp.zeros((12, 8), jnp.float32)))
    assert (X == 0).sum() >= (X_plain == 0).sum()


def test_l1_matrix_mode(rng):
    """Per-(column, factor) penalties, the batch-aware L1-matrix variant."""
    _, a, _, B = _random_problem(rng, n=6, k=8)
    L1m = (rng.random((6, 8)) * 0.1).astype(np.float32)
    X = np.asarray(nnls_batch(jnp.asarray(a), jnp.asarray(B),
                              jnp.zeros((6, 8), jnp.float32), L1=jnp.asarray(L1m)))
    for c in range(6):
        x_ref = nnls_cd_numpy(a, B[c], np.zeros(8), L1_vec=L1m[c])
        np.testing.assert_allclose(X[c], x_ref, rtol=1e-3, atol=1e-4)


def test_batched_gram(rng):
    """Per-column Gram batch — the masked-CV path."""
    k, n = 7, 9
    a_batch = np.zeros((n, k, k), np.float32)
    B = np.zeros((n, k), np.float32)
    for c in range(n):
        F = rng.random((32, k)).astype(np.float32)
        a_batch[c] = F.T @ F + 1e-15 * np.eye(k)
        B[c] = F.T @ rng.random(32).astype(np.float32)
    X = np.asarray(nnls_batch(jnp.asarray(a_batch), jnp.asarray(B),
                              jnp.zeros((n, k), jnp.float32)))
    for c in range(n):
        x_ref = nnls_cd_numpy(a_batch[c], B[c], np.zeros(k))
        np.testing.assert_allclose(X[c], x_ref, rtol=2e-3, atol=2e-4)


def test_update_mask_freezes_rows(rng):
    _, a, _, B = _random_problem(rng, n=10, k=6)
    X0 = rng.random((10, 6)).astype(np.float32)
    mask = np.array([True] * 5 + [False] * 5)
    X = np.asarray(nnls_batch(jnp.asarray(a), jnp.asarray(B), jnp.asarray(X0),
                              update_mask=jnp.asarray(mask)))
    np.testing.assert_array_equal(X[5:], X0[5:])
    assert not np.allclose(X[:5], X0[:5])


def test_nnls_sweep_instrumentation(rng):
    """return_sweeps reports per-column CD sweep counts without changing
    the solution (honest FLOP accounting for bench.py)."""
    from singlet_tpu.ops.nnls import nnls_batch

    k, n = 6, 32
    a = np.eye(k) + 0.1 * rng.random((k, k))
    a = (a + a.T) / 2 + k * np.eye(k)
    B = rng.random((n, k)).astype(np.float32)
    X0 = np.zeros((n, k), np.float32)
    X_plain = nnls_batch(jnp.asarray(a, jnp.float32), jnp.asarray(B),
                         jnp.asarray(X0))
    X, sweeps = nnls_batch(jnp.asarray(a, jnp.float32), jnp.asarray(B),
                           jnp.asarray(X0), return_sweeps=True)
    np.testing.assert_array_equal(np.asarray(X), np.asarray(X_plain))
    sweeps = np.asarray(sweeps)
    assert sweeps.shape == (n,)
    assert (sweeps >= 1).all() and (sweeps <= 100).all()
    # an empty (masked-out) column runs zero sweeps
    mask = np.ones(n, bool)
    mask[3] = False
    _, sw2 = nnls_batch(jnp.asarray(a, jnp.float32), jnp.asarray(B),
                        jnp.asarray(X0), update_mask=jnp.asarray(mask),
                        return_sweeps=True)
    assert np.asarray(sw2)[3] == 0


def test_solve_nnls_packed_t_matches_explicit_batched_gram(rng):
    """solve_nnls_packed_t (pair-padded, transposed packed Gram corrections)
    must equal the explicit a_full[None] - unpack_sym formulation."""
    from singlet_tpu.ops.linalg import (packed_outer_products, pad_pairs,
                                        triu_pairs, unpack_sym)
    from singlet_tpu.ops.nnls import solve_nnls_packed_t

    n, k, genes = 24, 5, 40
    F, a_full, _, B = _random_problem(rng, n, k, m=genes)
    iu = triu_pairs(k)
    npairs = k * (k + 1) // 2
    Pw = packed_outer_products(jnp.asarray(F), pad_pairs(iu, 128))
    m = (rng.random((n, genes)) < 0.3).astype(np.float32)
    packed_t = Pw.T @ jnp.asarray(m).T                      # (128, n)

    X0 = jnp.zeros((n, k), jnp.float32)
    got = solve_nnls_packed_t(jnp.asarray(a_full), packed_t, iu,
                              jnp.asarray(B), X0, L1=0.01)
    a_batch = jnp.asarray(a_full)[None] - unpack_sym(packed_t[:npairs].T, k,
                                                     iu)
    want = nnls_batch(a_batch, jnp.asarray(B), X0, L1=0.01)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-6)


def _oracle_problem(rng, n, k, genes=64):
    """A well-conditioned NNLS batch as NMF produces it: a sparse
    nonnegative factor F (genes, k), right-hand sides B = G^T F, and per
    column c a masked Gram F^T F - F[m_c]^T F[m_c] (~5% of the genes held
    out), built in float64 independently of the packing helpers."""
    F = rng.random((genes, k)) * (rng.random((genes, k)) < 0.5)
    F[np.arange(k) % genes, np.arange(k)] += 1.0     # no empty coordinate
    B = rng.random((n, genes)) @ F
    m = rng.random((n, genes)) < 0.05
    a_full = F.T @ F + 1e-15 * np.eye(k)
    a_cols = a_full[None] - np.einsum("cg,gi,gj->cij", m, F, F)
    return F, B, m, a_full, a_cols


@pytest.mark.parametrize("l1", ["scalar", "matrix"])
@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("k", [3, 9, 17])
@pytest.mark.parametrize("gram", ["shared", "per_column", "packed_t"])
def test_solve_nnls_matches_float64_oracle(rng, gram, k, start, l1):
    """The engines' entry points (solve_nnls on a shared or per-column
    Gram, solve_nnls_packed_t on pair-padded transposed corrections from
    mask_dot_t) against the float64 per-column oracle of the reference CD
    semantics, over rank x cold/warm start x scalar/per-entry L1, with
    ~10% of the columns frozen (returned bit-equal)."""
    from singlet_tpu.ops.linalg import (mask_dot_t, packed_outer_products,
                                        pad_pairs, triu_pairs)
    from singlet_tpu.ops.nnls import solve_nnls, solve_nnls_packed_t

    n = 40
    F, B, m, a_full, a_cols = _oracle_problem(rng, n, k)
    X0 = np.zeros((n, k)) if start == "cold" else \
        rng.random((n, k)) * (rng.random((n, k)) < 0.5)
    L1 = rng.random((n, k)) * 0.02 if l1 == "matrix" else 0.01
    frozen = rng.random(n) < 0.1
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    kw = dict(L1=f32(L1) if l1 == "matrix" else L1, L2=0.001,
              update_mask=jnp.asarray(~frozen))
    if gram == "shared":
        got = solve_nnls(f32(a_full), f32(B), f32(X0), **kw)
    elif gram == "per_column":
        got = solve_nnls(f32(a_cols), f32(B), f32(X0), **kw)
    else:
        iu = triu_pairs(k)
        P = packed_outer_products(f32(F), pad_pairs(iu, 256))
        packed_t = mask_dot_t(P, f32(m), 1)
        got = solve_nnls_packed_t(f32(a_full), packed_t, iu, f32(B),
                                  f32(X0), **kw)
    got = np.asarray(got)
    assert got.shape == (n, k)
    grams = a_cols if gram != "shared" else np.broadcast_to(a_full,
                                                            (n, k, k))
    for c in np.flatnonzero(~frozen):
        want = nnls_cd_numpy(grams[c], B[c], X0[c], L2=0.001,
                             L1=0.0 if l1 == "matrix" else L1,
                             L1_vec=L1[c] if l1 == "matrix" else None)
        np.testing.assert_allclose(got[c], want, rtol=1e-3,
                                   atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(got[frozen],
                                  X0[frozen].astype(np.float32))


@pytest.mark.parametrize("cap", [1, 3])
def test_sweep_cap_stops_every_column_after_cap_sweeps(rng, cap):
    """A traced sweep cap stops every column after ``cap`` sweeps, exactly
    as the float64 oracle run for ``cap`` sweeps: early sweeps are far from
    converged, so an extra or missing sweep would show."""
    from singlet_tpu.ops.nnls import solve_nnls

    _, a, _, B = _random_problem(rng, n=12, k=6)
    X0 = np.zeros((12, 6), np.float32)
    got = np.asarray(solve_nnls(jnp.asarray(a), jnp.asarray(B),
                                jnp.asarray(X0), L1=0.01,
                                sweep_cap=jnp.float32(cap)))
    full = np.asarray(solve_nnls(jnp.asarray(a), jnp.asarray(B),
                                 jnp.asarray(X0), L1=0.01))
    for c in range(12):
        want = nnls_cd_numpy(a, B[c], X0[c], L1=0.01, max_sweeps=cap)
        np.testing.assert_allclose(got[c], want, rtol=1e-4, atol=1e-5)
    assert not np.allclose(got, full, rtol=1e-4, atol=1e-5)


def test_n_coord_overrides_the_convergence_divisor(rng):
    """Rank bucketing: a k=8 system whose last 3 coordinates are padding
    (zero Gram rows/cols with the 1e-15 jitter, zero RHS) solved with
    n_coord=5 equals the unpadded k=5 solve, and the pad stays zero."""
    _, a, _, B = _random_problem(rng, n=16, k=5)
    a8 = np.zeros((8, 8), np.float32)
    a8[:5, :5] = a
    a8[np.arange(5, 8), np.arange(5, 8)] = 1e-15
    B8 = np.zeros((16, 8), np.float32)
    B8[:, :5] = B
    got = np.asarray(nnls_batch(jnp.asarray(a8), jnp.asarray(B8),
                                jnp.zeros((16, 8), jnp.float32), L1=0.01,
                                n_coord=jnp.float32(5)))
    want = np.asarray(nnls_batch(jnp.asarray(a), jnp.asarray(B),
                                 jnp.zeros((16, 5), jnp.float32), L1=0.01))
    np.testing.assert_array_equal(got[:, 5:], 0.0)
    np.testing.assert_allclose(got[:, :5], want, rtol=1e-6, atol=1e-7)


def test_mask_dot_t_matches_plain_dot(rng):
    """mask_dot_t == P.T @ m.T / P.T @ m on CPU (exact f32 at every
    precision), in the (pairs, n) orientation."""
    from singlet_tpu.ops.linalg import mask_dot_t

    P = jnp.asarray(rng.random((20, 9)).astype(np.float32))
    m = jnp.asarray((rng.random((12, 20)) < 0.3).astype(np.float32))
    np.testing.assert_allclose(np.asarray(mask_dot_t(P, m, 1)),
                               np.asarray(P.T @ m.T), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(mask_dot_t(P, m.T, 0)),
                               np.asarray(P.T @ m.T), rtol=1e-6)


@pytest.mark.gpu
def test_mm_precision_is_full_f32_on_gpu(gpu_device, rng):
    """MM_PRECISION (HIGHEST) products run in full f32 on the card: against
    float64 their error stays under 1e-5 of the largest entry, a limit the
    same product at DEFAULT precision (TF32 operands) exceeds.
    chip_smoke.py runs the same check."""
    import jax
    from singlet_tpu.ops.linalg import MM_PRECISION

    X = rng.standard_normal((2048, 4096)).astype(np.float32)
    Y = rng.standard_normal((4096, 64)).astype(np.float32)
    exact = X.astype(np.float64) @ Y.astype(np.float64)
    err = {}
    with jax.default_device(gpu_device):
        for prec in (MM_PRECISION, jax.lax.Precision.DEFAULT):
            got = np.asarray(jnp.dot(jnp.asarray(X), jnp.asarray(Y),
                                     precision=prec))
            err[prec] = np.abs(got - exact).max() / np.abs(exact).max()
    assert err[MM_PRECISION] <= 1e-5 < err[jax.lax.Precision.DEFAULT], err


def test_unpack_sym_from_t_matches_unpack_sym(rng):
    """The transposed-packed Gram unpack must equal the batch unpack."""
    from singlet_tpu.ops.linalg import triu_pairs, unpack_sym, \
        unpack_sym_from_t

    k = 5
    iu = triu_pairs(k)
    npairs = k * (k + 1) // 2
    np_pad = 128
    n = 16
    a0 = rng.random((k, k)).astype(np.float32)
    a_full = jnp.asarray(a0 + a0.T)   # Grams are symmetric; the tile layout
    # identity at[i, j, c] = a_c[j, i] = a_c[i, j] relies on it
    packed = jnp.asarray(rng.random((n, npairs)).astype(np.float32))
    packed_t = jnp.zeros((np_pad, n), jnp.float32)
    packed_t = packed_t.at[:npairs].set(packed.T)
    # garbage in the pad rows must not leak into the unpack
    packed_t = packed_t.at[npairs:].set(1e6)

    at = unpack_sym_from_t(packed_t, k, iu, a_full)     # (k, k, n)
    want = a_full[None] - unpack_sym(packed, k, iu)     # (n, k, k)
    np.testing.assert_allclose(np.asarray(at),
                               np.asarray(want).transpose(2, 1, 0),
                               rtol=0, atol=0)
