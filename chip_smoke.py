#!/usr/bin/env python
"""Smoke test of the NMF engine on one NVIDIA GPU, in one process.

Drives the main path as a user would and checks every answer against a
plain reference:

1. solver — the CD-NNLS solve (``solve_nnls``, XLA) at n = 65,536 columns,
   k in {10, 50, 100}, shared and per-column Grams, cold and warm starts,
   against the same solve on the host CPU backend and against the float64
   oracle at n = 1,024; one ``MM_PRECISION`` product against float64 (full
   f32, no TF32); the TF32 error of one masked packed-Gram product;
2. dense route — ``run_nmf``, ``cross_validate_nmf`` + ``get_best_rank`` and
   ``ard_nmf`` on a seeded planted-rank operand of pbmc3k's shape; the fit
   and the CV are repeated on the host CPU backend of the same process;
3. sparse route — the blocked-ELL engine on one card (16,384 genes x 65,536
   cells at 5% density): ``run_nmf``, ``cross_validate_nmf`` and
   ``project_model``; the sparse engine against the dense engine on the
   first 8,192 cells, plain fit and masked CV.

``--four`` runs only the four-card path: the sparse route's plain fit and a
masked CV fit on ``make_mesh(4)`` against ``make_mesh(1)``, on the sparse
route's operand with its seeds.

Each phase prints its wall time, compile time and the process's
``peak_bytes_in_use`` so far, beside the card's name and power limit. The
last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
printed only when every check passed. Without a GPU the script exits
non-zero and prints no result: it never carries on on the CPU.

Run: ``python chip_smoke.py`` (one GPU) or ``python chip_smoke.py --four``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016

# Problem sizes. Widths are the real ones; depth (iterations) is bounded.
SIZES = dict(
    solve_n=65536, solve_ref_n=2048, solve_ks=(10, 50, 100),
    oracle_n=1024, oracle_k=10,
    f32_rows=8192, f32_inner=4096, f32_k=64,
    tf32_cells=2048, tf32_genes=16384, tf32_k=50,
    dense_genes=13714, dense_cells=2700, dense_density=0.06,
    dense_maxit=20, dense_cv_ranks=tuple(range(2, 17, 2)),
    dense_ard_kmax=24,
    sparse_genes=16384, sparse_cells=65536, sparse_held=8192,
    sparse_stratum=20, sparse_k=50, sparse_cv_ranks=(10, 30, 50),
    sparse_ref_cells=8192, sparse_ref_cv_rank=10, four_cv_rank=30,
)
PLANTED_RANK = 12


def card_info() -> str:
    """``name, power.limit`` of the card, read by a child process that
    never imports JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown card, power limit not read"


class Phase:
    """Times one phase: wall clock, compile seconds (XLA backend compiles,
    from JAX's monitoring events, inside the phase) and the device's peak
    bytes in use so far."""

    compile_s = 0.0

    def __init__(self, name: str, card: str, device):
        self.name, self.card, self.device = name, card, device

    @classmethod
    def listen(cls):
        import jax.monitoring

        def on_duration(event, duration, **_):
            if event == "/jax/core/compile/backend_compile_duration":
                cls.compile_s += duration

        jax.monitoring.register_event_duration_secs_listener(on_duration)

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.c0 = Phase.compile_s
        print(f"== phase {self.name} ({self.card})", flush=True)
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self.t0
        stats = self.device.memory_stats() or {}
        peak = stats.get("peak_bytes_in_use", -1)
        print(f"== phase {self.name}: wall {wall:.1f} s, compile "
              f"{Phase.compile_s - self.c0:.1f} s, peak_bytes_in_use "
              f"{peak} (process so far) | {self.card}", flush=True)
        self.wall = wall
        return False


class Checks:
    """Collects named pass/fail comparisons and prints each one."""

    def __init__(self):
        self.failed = []

    def __call__(self, name: str, ok: bool, detail: str) -> bool:
        print(f"  [{'PASS' if ok else 'FAIL'}] {name}: {detail}", flush=True)
        if not ok:
            self.failed.append(name)
        return ok


def excess(got, want, rtol: float, atol: float) -> float:
    """max(|got - want| - (atol + rtol |want|)): <= 0 iff allclose."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.max(np.abs(got - want) - (atol + rtol * np.abs(want))))


def trace_agreement(cv_a, cv_b, rtol: float):
    """(number of shared (k, rep, iter) trace points, max excess of their
    test errors over rtol) for two CV trace tables."""
    import numpy as np

    def points(cv):
        return {(int(k), int(r), int(i)): float(e) for k, r, i, e in zip(
            cv["k"], cv["rep"], cv["iter"], cv["test_error"])}

    pa, pb = points(cv_a), points(cv_b)
    keys = sorted(set(pa) & set(pb))
    if not keys:
        return 0, float("inf")
    return len(keys), excess([pa[k] for k in keys], [pb[k] for k in keys],
                             rtol, 0.0)


def timed(fn, *args):
    """(result, seconds) of one call, synced with block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------- operands

def planted_dense_counts(genes: int, cells: int, density: float, seed: int):
    """Seeded planted-rank count matrix (genes x cells, scipy CSC), Poisson
    counts whose mean makes ~``density`` of the entries nonzero."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    W = rng.gamma(0.5, size=(genes, PLANTED_RANK)).astype(np.float32)
    H = rng.gamma(0.5, size=(PLANTED_RANK, cells)).astype(np.float32)
    lam = W @ H
    lam *= -np.log1p(-density) / lam.mean()
    counts = rng.poisson(lam).astype(np.float32)
    return sp.csc_matrix(counts)


def sparse_operand():
    """The sparse route's operand and its held-back cells (scipy CSC)."""
    S = SIZES
    A_all = planted_sparse(S["sparse_genes"],
                           S["sparse_cells"] + S["sparse_held"],
                           S["sparse_stratum"], SEED + 2)
    return A_all[:, :S["sparse_cells"]], A_all[:, S["sparse_cells"]:]


def planted_sparse(genes: int, cells: int, stratum: int, seed: int):
    """Seeded planted-rank log-scale operand (genes x cells, scipy CSC) with
    one nonzero per ``stratum`` consecutive genes in every cell (density
    1/stratum); values log1p(lambda * u), lambda from a rank-12 gamma
    model."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    W = rng.gamma(0.5, size=(genes, PLANTED_RANK)).astype(np.float32)
    H = rng.gamma(0.5, size=(cells, PLANTED_RANK)).astype(np.float32)
    per_col = genes // stratum
    rows = (np.arange(per_col, dtype=np.int32)[None, :] * stratum
            + rng.integers(0, stratum, (cells, per_col), dtype=np.int32))
    rows = rows.ravel()
    vals = np.empty(rows.size, np.float32)
    chunk = 1 << 22
    for s in range(0, rows.size, chunk):
        r = rows[s:s + chunk]
        c = np.arange(s, s + r.size) // per_col
        lam = np.einsum("ij,ij->i", W[r], H[c])
        u = rng.uniform(0.5, 8.0, r.size).astype(np.float32)
        vals[s:s + chunk] = np.log1p(lam * u)
    indptr = np.arange(cells + 1, dtype=np.int64) * per_col
    return sp.csc_matrix((vals, rows, indptr), shape=(genes, cells))


# ------------------------------------------------------------------ phases

def phase_solver(check: Checks, cpu):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from singlet_tpu.ops.linalg import (MM_PRECISION, mask_dot_t,
                                        packed_outer_products, pad_pairs,
                                        triu_pairs, unpack_sym_from_t)
    from singlet_tpu.ops.nnls import solve_nnls
    from reference_impl import nnls_cd

    S = SIZES
    rtol, atol = 5e-3, 1e-6
    n, n_ref = S["solve_n"], S["solve_ref_n"]
    print(f"  CD-NNLS (solve_nnls) on the GPU at n={n} against the same solve "
          f"on the host CPU backend for the first {n_ref} columns (columns "
          f"are independent): rtol={rtol} atol={atol}, frozen rows "
          "bit-equal; another backend may fuse the arithmetic differently, "
          "so a borderline column may run one converged-tail sweep more or "
          "fewer", flush=True)
    print("  precision: the solve is elementwise IEEE f32 (no matrix "
          "products)", flush=True)
    rng = np.random.default_rng(SEED)
    hi = jax.lax.Precision.HIGHEST
    solve = solve_nnls
    for k in S["solve_ks"]:
        F = (rng.random((512, k)) * (rng.random((512, k)) < 0.5)) \
            .astype(np.float32)
        a = F.T @ F + np.float32(1e-15) * np.eye(k, dtype=np.float32)
        B = (rng.random((n, 512), np.float32) @ F).astype(np.float32)
        mask = rng.random(n) >= 0.1
        # per-column Grams of the masked-CV form: a minus the outer
        # products of a random ~5% of the rows, per column
        iu = triu_pairs(k)
        P = packed_outer_products(jnp.asarray(F),
                                  pad_pairs(iu, -(-len(iu[0]) // 128) * 128))
        m = jnp.asarray(rng.random((n, 512)) < 0.05, jnp.float32)
        a_cols = jnp.transpose(unpack_sym_from_t(
            jax.lax.dot_general(P, m, (((0,), (1,)), ((), ())),
                                precision=hi), k, iu, jnp.asarray(a)),
            (2, 1, 0))
        for start in ("cold", "warm"):
            X0 = np.zeros((n, k), np.float32) if start == "cold" else \
                (rng.random((n, k)) * (rng.random((n, k)) < .5)) \
                .astype(np.float32)
            for form, g in (("shared", jnp.asarray(a)),
                            ("per-column", a_cols)):
                args = (g, jnp.asarray(B), jnp.asarray(X0))
                kw = dict(L1=0.01, update_mask=jnp.asarray(mask))
                timed(lambda: solve(*args, **kw))
                got, t_g = timed(lambda: solve(*args, **kw))
                got = np.asarray(got)
                g_r = np.asarray(g if form == "shared" else g[:n_ref])
                with jax.default_device(cpu):
                    want = np.asarray(solve(
                        jnp.asarray(g_r), jnp.asarray(B[:n_ref]),
                        jnp.asarray(X0[:n_ref]), L1=0.01,
                        update_mask=jnp.asarray(mask[:n_ref])))
                ex = excess(got[:n_ref], want, rtol, atol)
                bit = np.array_equal(got[~mask], X0[~mask])
                check(f"solve_nnls {form} k={k} {start}, GPU vs host CPU",
                      ex <= 0 and bit and np.isfinite(got).all(),
                      f"max excess over tolerance {ex:.3e}, frozen rows "
                      f"bit-equal {bit}; GPU {t_g * 1e3:.2f} ms at n={n}")

    # float64 oracle at a small size, on a well-conditioned Gram (a sparse
    # factor, as NMF produces) so the solves converge inside the sweep cap
    # in both precisions
    n_o, k_o = S["oracle_n"], S["oracle_k"]
    F = (rng.random((256, k_o)) * (rng.random((256, k_o)) < 0.3)) \
        .astype(np.float32)
    a = (F.T @ F + 1e-15 * np.eye(k_o)).astype(np.float32)
    B = (rng.random((n_o, 256)) @ F).astype(np.float32)
    X0 = np.zeros((n_o, k_o), np.float32)
    oracle = np.stack([nnls_cd(a.astype(np.float64), B[c], X0[c], L1=0.01)
                       for c in range(n_o)])
    big = np.abs(oracle) > 1e-6 * np.abs(oracle).max()
    got = np.asarray(solve(jnp.asarray(a), jnp.asarray(B), jnp.asarray(X0),
                           L1=0.01))
    rel = float(np.max(np.abs(got - oracle)[big] / np.abs(oracle)[big]))
    check(f"solve_nnls on the GPU vs float64 oracle n={n_o} k={k_o}",
          rel <= 1e-4, f"max relative error {rel:.3e} (limit 1e-4, entries "
          "above 1e-6 x max)")

    # MM_PRECISION (HIGHEST) must be full f32 on the card: one SpMM-shaped
    # product (a dense tile against a factor block, as the engines form
    # it) against float64, with a limit that the same product in TF32
    # (10-bit mantissa operands) exceeds
    lim = 1e-5
    X = rng.standard_normal((S["f32_rows"], S["f32_inner"]), np.float32)
    Y = rng.standard_normal((S["f32_inner"], S["f32_k"]), np.float32)
    exact = X.astype(np.float64) @ Y.astype(np.float64)
    err = {}
    for name, prec in (("MM_PRECISION", MM_PRECISION),
                       ("DEFAULT", jax.lax.Precision.DEFAULT)):
        got = np.asarray(jnp.dot(jnp.asarray(X), jnp.asarray(Y),
                                 precision=prec))
        err[name] = float(np.abs(got - exact).max() / np.abs(exact).max())
    check(f"MM_PRECISION={MM_PRECISION} is full f32 on the card "
          f"({X.shape[0]} x {X.shape[1]} @ {Y.shape[0]} x {Y.shape[1]})",
          err["MM_PRECISION"] <= lim < err["DEFAULT"],
          f"max error / max entry against float64: MM_PRECISION "
          f"{err['MM_PRECISION']:.3e}, DEFAULT {err['DEFAULT']:.3e} (limit "
          f"{lim:g}: f32 passes, TF32 fails)")

    # TF32 error of one masked packed-Gram product at DEFAULT precision
    cells, genes, k = S["tf32_cells"], S["tf32_genes"], S["tf32_k"]
    iu = triu_pairs(k)
    np_pad = -(-len(iu[0]) // 128) * 128
    W = jnp.asarray(rng.random((genes, k)), jnp.float32) / genes
    Pw = packed_outer_products(W, pad_pairs(iu, np_pad))
    m = jnp.asarray(rng.random((cells, genes)) < 0.05, jnp.float32)
    d = np.asarray(mask_dot_t(Pw, m, 1))
    h = np.asarray(jax.lax.dot_general(Pw, m, (((0,), (1,)), ((), ())),
                                       precision=hi))
    err = np.abs(d - h)
    rel_max = float(err.max() / np.abs(h).max())
    rel_med = float(np.median(err / np.maximum(np.abs(h), 1e-30)))
    check(f"mask_dot_t TF32 error ({cells} cells x {genes} genes x "
          f"{np_pad} pairs)", rel_max < 1e-2,
          f"DEFAULT vs HIGHEST: max error / max entry {rel_max:.3e}, median "
          f"relative error {rel_med:.3e} (sanity limit 1e-2)")


def phase_dense(check: Checks, cpu):
    import jax
    import numpy as np

    from singlet_tpu import (ard_nmf, cross_validate_nmf, get_best_rank,
                             run_nmf)
    from singlet_tpu.preprocess import log_normalize

    S = SIZES
    A = log_normalize(planted_dense_counts(
        S["dense_genes"], S["dense_cells"], S["dense_density"], SEED + 1))
    print(f"  operand {A.shape[0]} x {A.shape[1]}, density "
          f"{A.nnz / (A.shape[0] * A.shape[1]):.4f}, log-normalised",
          flush=True)
    fit_kw = dict(rank=10, maxit=S["dense_maxit"], tol=1e-4, seed=3)
    # tol=0 and no overfit stop: every fit runs maxit iterations, so the
    # GPU and CPU traces have the same points and all of them are compared
    cv_kw = dict(ranks=list(S["dense_cv_ranks"]), n_replicates=1,
                 maxit=S["dense_maxit"], tol=0.0, tol_overfit=float("inf"),
                 verbose=0, seed=5)

    t0 = time.perf_counter()
    model = run_nmf(A, **fit_kw)
    print(f"  run_nmf(k=10) {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cv = cross_validate_nmf(A, **cv_kw)
    best = get_best_rank(cv)
    print(f"  cross_validate_nmf(ranks 2..16) {time.perf_counter() - t0:.1f}"
          f" s, best rank {best}", flush=True)
    t0 = time.perf_counter()
    ard = ard_nmf(A, k_max=S["dense_ard_kmax"], maxit=S["dense_maxit"],
                  verbose=0, seed=7)
    print(f"  ard_nmf {time.perf_counter() - t0:.1f} s, rank "
          f"{ard.w.shape[1]}", flush=True)
    check("dense route outputs finite",
          all(np.isfinite(x).all() for x in
              (model.w, model.d, model.h, ard.w, ard.d, ard.h,
               np.asarray(cv["test_error"]))),
          f"run_nmf w {model.w.shape}, ard rank {ard.w.shape[1]}, "
          f"{len(cv['k'])} CV trace rows")

    with jax.default_device(cpu):
        t0 = time.perf_counter()
        model_c = run_nmf(A, **fit_kw)
        cv_c = cross_validate_nmf(A, **cv_kw)
        best_c = get_best_rank(cv_c)
        print(f"  host CPU reference {time.perf_counter() - t0:.1f} s",
              flush=True)
    print("  precision: Gram/SpMM products HIGHEST (full f32 on both); "
          "masked packed-Gram products DEFAULT (TF32 on the GPU, exact f32 "
          "on the CPU)", flush=True)
    ex = excess(model.d, model_c.d, 1e-3, 0.0)
    check("run_nmf d, GPU vs host CPU", ex <= 0,
          f"max excess {ex:.3e} at rtol 1e-3: same program, other "
          "summation order")
    shared, ex = trace_agreement(cv, cv_c, 1e-3)
    n_g, n_c = len(cv["k"]), len(cv_c["k"])
    check("CV test-error traces, GPU vs host CPU",
          ex <= 0 and shared == n_g == n_c,
          f"{shared} shared (k, iter) trace points of {n_g} (GPU) / {n_c} "
          f"(CPU), max excess {ex:.3e} at rtol 1e-3: same program, TF32 "
          "mask products and another summation order on the GPU")
    check("selected rank, GPU vs host CPU", best == best_c,
          f"GPU {best}, CPU {best_c}")


def phase_sparse(check: Checks):
    import numpy as np

    from singlet_tpu import (cross_validate_nmf, get_best_rank,
                             project_model, run_nmf)
    from singlet_tpu.parallel.sharded import make_mesh
    from singlet_tpu.solvers.drivers import SPARSE_THRESHOLD

    S = SIZES
    t0 = time.perf_counter()
    A, A_held = sparse_operand()
    print(f"  operand {A.shape[0]} x {A.shape[1]} ({A.nnz} nnz, density "
          f"{A.nnz / (A.shape[0] * A.shape[1]):.4f}) + {A_held.shape[1]} "
          f"held-back cells, made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    k = S["sparse_k"]

    t0 = time.perf_counter()
    model = run_nmf(A, rank=k, maxit=10, tol=0.0, seed=11)
    print(f"  run_nmf(k={k}, 10 iterations) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cv = cross_validate_nmf(A, ranks=list(S["sparse_cv_ranks"]),
                            n_replicates=1, maxit=20, verbose=0, seed=13)
    best = get_best_rank(cv)
    print(f"  cross_validate_nmf(ranks {list(S['sparse_cv_ranks'])}) "
          f"{time.perf_counter() - t0:.1f} s, best rank {best}", flush=True)
    t0 = time.perf_counter()
    h, d = project_model(A_held, model.w)
    print(f"  project_model({A_held.shape[1]} cells) "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    routed = A.shape[0] * A.shape[1] > SPARSE_THRESHOLD
    check("sparse route outputs finite",
          all(np.isfinite(x).all() for x in
              (model.w, model.d, model.h, h, d,
               np.asarray(cv["test_error"])))
          and h.shape == (k, A_held.shape[1]),
          f"w {model.w.shape}, projected h {h.shape}, "
          f"{len(cv['k'])} CV trace rows; blocked-ELL engine route {routed}")

    # the sparse engine against the dense engine on the same cells
    n_ref = S["sparse_ref_cells"]
    A_s = A[:, :n_ref]
    A_d = np.asarray(A_s.todense())
    engines_agree(check, A_s, A_d)

    # masked CV on the sparse engine against the dense route on the same
    # cells (tests/test_ell.py:test_engine_routed_cv_matches_dense at a
    # real width); every fit runs maxit iterations, each one traced
    cv_kw = dict(ranks=[S["sparse_ref_cv_rank"]], n_replicates=1, maxit=10,
                 tol=0.0, tol_overfit=float("inf"), trace_test_mse=1,
                 verbose=0, seed=19)
    cv_s = cross_validate_nmf(A_s, mesh=make_mesh(1), **cv_kw)
    cv_d = cross_validate_nmf(A_d, **cv_kw)
    shared, ex = trace_agreement(cv_s, cv_d, 2e-3)
    check(f"masked CV test-error trace, sparse engine vs dense route "
          f"({n_ref} cells, k={S['sparse_ref_cv_rank']}, 10 iterations)",
          ex <= 0 and shared == len(cv_s["k"]) == len(cv_d["k"]),
          f"{shared} of {len(cv_d['k'])} trace points shared, max excess "
          f"{ex:.3e} at rtol 2e-3 (the CPU test's tolerance): same hash "
          "mask, TF32 mask products in another layout and another "
          "summation order")


def engines_agree(check: Checks, A_s, A_d):
    """Plain fit of the sparse engine (1-device mesh) against the dense
    engine on the same cells, from the same w_init, after 10 iterations."""
    import numpy as np

    from singlet_tpu.parallel.sharded import make_mesh
    from singlet_tpu.parallel.sharded_ell import sharded_ell_nmf_fit
    from singlet_tpu.solvers.als import nmf_fit

    k = SIZES["sparse_k"]
    w0 = np.random.default_rng(SEED + 3).random(
        (A_s.shape[0], k)).astype(np.float32)
    sparse = sharded_ell_nmf_fit(A_s, k, mesh=make_mesh(1), w_init=w0,
                                 tol=0.0, maxit=10)
    dense = nmf_fit(A_d, k, w_init=w0, tol=0.0, maxit=10)
    # tests/test_sharded_ell.py's tolerance carried to this scale: rtol
    # 3e-4, and an atol of 1.4e-3 (w) to 1.9e-3 (h) of the mean magnitude
    # there, here 2e-3 x mean|x|: an entry at the clamp may settle a
    # little above zero in one engine and at zero in the other
    for name, a, b in (("w", sparse["w"], dense.w), ("d", sparse["d"],
                                                       dense.d),
                       ("h", sparse["h"], dense.h)):
        check(f"sparse engine vs dense engine {name} ({A_s.shape[1]} cells, "
              f"k={k}, 10 iterations)",
              *agreement(a, b, 3e-4, 2e-3, "same math, blocked vs dense "
                         "summation order"))


def agreement(got, want, rtol: float, atol_mean: float, why: str):
    """(ok, detail) of allclose(got, want, rtol, atol = atol_mean x
    mean|want|), with the worst entry and the mean magnitude."""
    import numpy as np

    a, b = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.mean(np.abs(b)))
    atol = atol_mean * scale
    ex = excess(a, b, rtol, atol)
    diff = np.abs(a - b)
    i = np.unravel_index(np.argmax(diff), diff.shape)
    return ex <= 0, (f"max excess {ex:.3e} at rtol {rtol:g}, atol "
                     f"{atol_mean:g} x mean|x| ({atol:.2e}); max |diff| "
                     f"{diff[i]:.3e} where |x| = {abs(b[i]):.3e}, mean|x| "
                     f"{scale:.3e}: {why}")


def phase_four(check: Checks):
    import numpy as np

    from singlet_tpu import cross_validate_nmf, run_nmf
    from singlet_tpu.parallel.sharded import make_mesh
    from singlet_tpu.parallel.sharded_ell import ShardedEllEngine

    S = SIZES
    A, _ = sparse_operand()
    print(f"  operand {A.shape[0]} x {A.shape[1]} ({A.nnz} nnz), the sparse "
          "route's", flush=True)
    k, k_cv = S["sparse_k"], S["four_cv_rank"]
    eng4 = ShardedEllEngine(A, mesh=make_mesh(4))
    eng1 = ShardedEllEngine(A, mesh=make_mesh(1))
    devs = {s.device for s in eng4.data.b_li.addressable_shards}
    check("operand sharded over four devices", len(devs) == 4,
          f"A-plane shards on {sorted(str(d) for d in devs)}")
    out = {}
    for name, eng in (("4", eng4), ("1", eng1)):
        t0 = time.perf_counter()
        model = run_nmf(eng, rank=k, maxit=10, tol=0.0, seed=11)
        cv = cross_validate_nmf(eng, ranks=[k_cv], n_replicates=1,
                                maxit=20, verbose=0, seed=13)
        out[name] = (model, cv)
        print(f"  mesh of {name}: fit (k={k}, 10 iterations) + CV (k={k_cv},"
              f" 20 iterations) {time.perf_counter() - t0:.1f} s",
              flush=True)
    m4, cv4 = out["4"]
    m1, cv1 = out["1"]
    # np.allclose at rtol 1e-4 (its default atol, 1e-8, is 1.6e-4 of mean|w|
    # and 6.6e-4 of mean|h| at this operand's scale)
    for name, a, b in (("w", m4.w, m1.w), ("d", m4.d, m1.d),
                       ("h", m4.h, m1.h)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        ex = excess(a, b, 1e-4, 1e-8)
        diff = np.abs(a - b)
        check(f"make_mesh(4) vs make_mesh(1): {name}", ex <= 0,
              f"max excess {ex:.3e} at rtol 1e-4, atol 1e-8; max |diff| "
              f"{diff.max():.3e}, mean|x| {np.abs(b).mean():.3e}: the psum "
              "order is the only difference")
    shared, ex = trace_agreement(cv4, cv1, 1e-4)
    check("make_mesh(4) vs make_mesh(1): test-MSE trace",
          ex <= 0 and shared == len(cv1["k"]) == len(cv4["k"]),
          f"{shared} of {len(cv1['k'])} trace points shared, max excess "
          f"{ex:.3e} at rtol 1e-4")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    # the main path must not need the optional plotting/table libraries
    sys.modules["pandas"] = None
    sys.modules["matplotlib"] = None
    # the host CPU backend is the dense route's plain reference
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform}); "
              "this script runs on an NVIDIA GPU only", file=sys.stderr)
        return 2
    need = 4 if args.four else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 2

    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import singlet_tpu  # noqa: F401  (fails outside a checkout)
    from singlet_tpu.ops.linalg import MASK_MM_PRECISION, MM_PRECISION
    from singlet_tpu.utils import compilation_cache_dir

    card = card_info()
    gpu = devices[0]
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}: {len(devices)} x {gpu.device_kind}; "
          f"MM_PRECISION={MM_PRECISION}, MASK_MM_PRECISION="
          f"{MASK_MM_PRECISION}; compile cache {compilation_cache_dir()}",
          flush=True)
    Phase.listen()
    check = Checks()
    budget = {}
    t_all = time.perf_counter()
    if args.four:
        with Phase("four-card mesh", card, gpu) as ph:
            phase_four(check)
        budget["four"] = ph.wall
    else:
        cpu = jax.devices("cpu")[0]
        with Phase("solver", card, gpu) as ph:
            phase_solver(check, cpu)
        budget["solver"] = ph.wall
        with Phase("dense route", card, gpu) as ph:
            phase_dense(check, cpu)
        budget["dense"] = ph.wall
        with Phase("sparse route", card, gpu) as ph:
            phase_sparse(check)
        budget["sparse"] = ph.wall
    total = time.perf_counter() - t_all
    print("phase budget: " + ", ".join(f"{k} {v:.1f} s"
                                        for k, v in budget.items())
          + f"; total {total:.1f} s | {card}", flush=True)
    if check.failed:
        print(f"chip_smoke: {len(check.failed)} check(s) failed: "
              f"{check.failed}", file=sys.stderr)
        return 1
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": gpu.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
