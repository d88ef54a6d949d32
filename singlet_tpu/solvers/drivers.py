"""Matrix-in / model-out algorithm drivers.

Equivalents of the reference's L3 R drivers: ``run_nmf``
(reference:R/run_nmf.R:18-77), ``cross_validate_nmf``
(reference:R/cross_validate_nmf.R:18-105), ``GetBestRank``
(reference:R/GetBestRank.R:8-46) and the ``ard_nmf`` adaptive rank search
(reference:R/ard_nmf.R:31-193). The CV trace schema — columns
(k, rep, test_error, iter, tol[, overfit_score]) — is part of the public
surface and preserved verbatim.

Providers for A and its transpose are built once per dataset and shared
across every fit of a rank search (the reference similarly keeps A and At
alive for the whole search).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from singlet_tpu.model import NMFModel
from singlet_tpu.solvers.als import init_w, make_dense_providers, nmf_fit
from singlet_tpu.solvers.ard import ard_nmf_fit
from singlet_tpu.sparse.matrix import DenseMatrix
from singlet_tpu.utils import (enable_compilation_cache, is_scipy_sparse,
                               pandas_available, vprint)


def _coerce_dense(A) -> np.ndarray:
    """Accept numpy arrays or scipy sparse; below ``SPARSE_THRESHOLD``
    density is a storage detail (the dense provider path), not an
    algorithmic switch."""
    try:
        import scipy.sparse as sp

        if sp.issparse(A):
            return np.asarray(A.todense(), dtype=np.float32)
    except ImportError:
        pass
    return np.asarray(A, dtype=np.float32)


# scipy-sparse inputs with more dense entries than this stay in blocked-ELL
# sparse storage (the transpose-free engine); smaller inputs are densified
# outright and run as dense matmuls.
SPARSE_THRESHOLD = 64e6


def _providers(A) -> Tuple[DenseMatrix, DenseMatrix]:
    """Build single-chip dense (A, At) providers (or pass a prebuilt
    provider pair through)."""
    if isinstance(A, tuple) and len(A) == 2 and hasattr(A[0], "t_matmul"):
        return A
    # make_dense_providers ships scipy-sparse inputs as COO triplets and
    # densifies on device (the dense transfer dominates otherwise)
    return make_dense_providers(A if is_scipy_sparse(A) else _coerce_dense(A))


def _engine_or_providers(A, mesh):
    """Route the input to a compute backend.

    All sparse-at-scale inputs — scipy matrices above ``SPARSE_THRESHOLD``
    dense entries, chunk lists, staged directories — run on the blocked-ELL
    engine (transpose-free, scatter-free, cell-sharded), on the given mesh
    or a 1-device mesh when none is given: the single-chip sparse path IS
    the multi-chip engine at mesh size 1 (one layout, one packer, one
    compute formulation). Chunk lists and staged directories stream into
    the sharded planes one chunk at a time — the concatenated matrix is
    never materialized on the host. Everything smaller becomes dense
    single-chip providers (or, with a mesh, engine shards)."""
    import scipy.sparse as sp

    from singlet_tpu.parallel.sharded_ell import (ShardedEllEngine,
                                                  shard_ell_from_chunks,
                                                  shard_ell_from_staged)

    if isinstance(A, ShardedEllEngine):
        return A
    if isinstance(A, str):
        from singlet_tpu.parallel.sharded import make_mesh

        mesh = mesh or make_mesh(1)
        return ShardedEllEngine(None, mesh=mesh,
                                data=shard_ell_from_staged(A, mesh))
    if isinstance(A, (list, tuple)) and not (
            len(A) == 2 and hasattr(A[0], "t_matmul")):
        from singlet_tpu.parallel.sharded import make_mesh

        mesh = mesh or make_mesh(1)
        return ShardedEllEngine(None, mesh=mesh,
                                data=shard_ell_from_chunks(A, mesh))
    if mesh is None:
        if sp.issparse(A) and A.shape[0] * A.shape[1] > SPARSE_THRESHOLD:
            from singlet_tpu.parallel.sharded import make_mesh

            return ShardedEllEngine(sp.csc_matrix(A), mesh=make_mesh(1))
        return _providers(A)
    return ShardedEllEngine(sp.csc_matrix(A), mesh=mesh)


def _fit_plain(P, k, *, w_init, tol, maxit, L1, L2, seed, verbose):
    """Dispatch a plain fit to the single-chip engine or a sharded engine;
    returns (w, d, h)."""
    from singlet_tpu.parallel.sharded_ell import ShardedEllEngine

    if isinstance(P, ShardedEllEngine):
        out = P.fit(k, tol=tol, maxit=maxit, L1=L1, L2=L2, seed=seed,
                    verbose=bool(verbose), w_init=w_init)
        return out["w"], out["d"], out["h"]
    Ap, Atp = P
    res = nmf_fit(Ap, int(k), At=Atp, w_init=w_init, tol=tol, maxit=maxit,
                  L1=L1, L2=L2, seed=seed, verbose=bool(verbose))
    return res.w, res.d, res.h


def _fit_masked(P, k, **kw):
    """Dispatch a masked (trace-producing) fit; returns ArdFitResult."""
    from singlet_tpu.parallel.sharded_ell import ShardedEllEngine

    if isinstance(P, ShardedEllEngine):
        return P.ard_fit(k, **kw)
    Ap, Atp = P
    return ard_nmf_fit(Ap, k, At=Atp, **kw)


def _rows_pad_of(P) -> int:
    from singlet_tpu.parallel.sharded_ell import ShardedEllEngine

    return P.rows_pad if isinstance(P, ShardedEllEngine) else P[0].rows_pad


def _rows_true_of(P) -> int:
    from singlet_tpu.parallel.sharded_ell import ShardedEllEngine

    return P.rows_true if isinstance(P, ShardedEllEngine) else P[0].rows_true


def _finalize(w, d, h, gene_names=None, cell_names=None, cv_data=None,
              reduction_key: str = "NMF_") -> NMFModel:
    """Sort factors by decreasing d and attach names
    (reference:R/run_nmf.R:65-76)."""
    model = NMFModel(w=w, d=d, h=h, gene_names=gene_names,
                     cell_names=cell_names, cv_data=cv_data,
                     reduction_key=reduction_key)
    return model.sorted_by_d()


# ---------------------------------------------------------------------------
# run_nmf — fixed-rank fit
# ---------------------------------------------------------------------------

def run_nmf(
    A,
    rank: int,
    tol: float = 1e-4,
    maxit: int = 100,
    verbose: Union[bool, int] = False,
    L1: Union[float, Tuple[float, float]] = 0.01,
    L2: Union[float, Tuple[float, float]] = 0.0,
    seed: int = 0,
    w_init: Optional[np.ndarray] = None,
    gene_names=None,
    cell_names=None,
    mesh=None,
    config=None,
) -> NMFModel:
    """Fit NMF at a fixed rank (reference:R/run_nmf.R:18-77).

    ``mesh``: an optional ``jax.sharding.Mesh`` — the fit then runs on the
    multi-chip sparse engine with cells sharded over the mesh (models are
    identical to the single-chip path). ``config`` (an
    :class:`~singlet_tpu.config.NMFConfig`) supplies the solver
    hyperparameters, taking precedence over the per-argument defaults."""
    if config is not None:
        tol, maxit, L1, L2, seed = (config.tol, config.maxit, config.L1,
                                    config.L2, config.seed)
    if np.isscalar(L1) and L1 >= 1:
        raise ValueError("L1 penalty must be strictly in the range [0, 1)")
    enable_compilation_cache()
    P = _engine_or_providers(A, mesh)
    w, d, h = _fit_plain(P, int(rank), w_init=w_init, tol=tol, maxit=maxit,
                         L1=L1, L2=L2, seed=seed, verbose=verbose)
    return _finalize(w, d, h, gene_names, cell_names)


# ---------------------------------------------------------------------------
# GetBestRank — the rank-selection rule
# ---------------------------------------------------------------------------

def _columns(df) -> dict:
    """Numpy columns of a CV trace table (DataFrame or dict of columns)."""
    if hasattr(df, "columns"):
        return {c: df[c].to_numpy() for c in df.columns}
    return {c: np.asarray(v) for c, v in df.items()}


def trace_table(rows: list, columns: Sequence[str]):
    """CV trace rows as the public table: a pandas DataFrame of class
    ``cross_validate_nmf_data`` when pandas is importable, otherwise a dict
    of numpy columns with the same keys."""
    if pandas_available():
        import pandas as pd

        df = pd.DataFrame(rows, columns=list(columns))
        df.attrs["class"] = "cross_validate_nmf_data"
        return df
    return {c: np.asarray([r[c] for r in rows]) for c in columns}


def _unique_in_order(x: np.ndarray) -> np.ndarray:
    _, first = np.unique(x, return_index=True)
    return x[np.sort(first)]


def get_best_rank(df, tol_overfit: float = 1e-4) -> int:
    """Select the best rank from CV traces (reference:R/GetBestRank.R:8-46).

    ``df``: the trace table of ``cross_validate_nmf`` (a DataFrame or a dict
    of columns k, rep, test_error, iter). Per replicate: cap max_rank at
    the smallest rank whose running-min normalized error trace rises by
    more than tol_overfit; below the cap, condense each (rep, k) to its
    last trace point and take the k minimizing test error; floor of the
    mean across replicates.
    """
    cols = _columns(df)
    n_rows = len(cols["k"]) if "k" in cols else 0
    if n_rows == 0:
        # e.g. the very first fit of a search already overfit: nothing below
        # the cap — fall back to the minimum rank (mirrors the empty-cap
        # branch below; R would propagate NaN here)
        return 2
    k_all, rep_all = cols["k"], cols["rep"]
    best_ranks = []
    for rep in np.unique(rep_all):
        sel = rep_all == rep
        k_r, err_r, it_r = k_all[sel], cols["test_error"][sel], \
            cols["iter"][sel]
        max_rank = int(k_r.max()) + 1
        for rank in _unique_in_order(k_r):
            if rank < max_rank:
                err = err_r[k_r == rank]
                if err.size > 1:
                    v2 = err[1:]
                    v1 = err[:-1].copy()
                    # running min, exactly as the reference's in-place loop
                    for pos in range(1, v1.size):
                        if v1[pos] > v1[pos - 1]:
                            v1[pos] = v1[pos - 1]
                    rise = np.max(np.concatenate([[0.0], (v2 - v1) / (v2 + v1)]))
                    if rise > tol_overfit:
                        max_rank = int(rank)
        cap = k_r < max_rank
        if not cap.any():
            best_ranks.append(2)
        elif n_rows == 1:  # quirk preserved: tests the FULL table's length
            best_ranks.append(int(k_r[cap][0]))
        else:
            # condense each k to its last trace point (largest iter)
            k_c, err_c, it_c = k_r[cap], err_r[cap], it_r[cap]
            order = np.argsort(it_c, kind="stable")
            last = {}
            for j in order:
                last[k_c[j]] = err_c[j]
            ks = sorted(last)
            best_ranks.append(int(ks[int(np.argmin([last[k] for k in ks]))]))
    return int(math.floor(float(np.mean(best_ranks))))


# R-style alias (public surface name)
GetBestRank = get_best_rank


# ---------------------------------------------------------------------------
# cross_validate_nmf — fixed-grid CV
# ---------------------------------------------------------------------------

def cross_validate_nmf(
    A,
    ranks: Sequence[int],
    n_replicates: int = 3,
    tol: float = 1e-4,
    maxit: int = 100,
    verbose: int = 1,
    L1: float = 0.01,
    L2: float = 0.0,
    test_density: float = 0.05,
    tol_overfit: float = 1e-4,
    trace_test_mse: int = 5,
    seed: int = 0,
    mesh=None,
    config=None,
):
    """Masked CV over a (rank, replicate) grid
    (reference:R/cross_validate_nmf.R:18-105).

    Each replicate shares one nested w_init (rank-k fit uses the first k
    columns) and a deterministic per-replicate mask seed. Returns the tidy
    trace table (columns k, rep, test_error, iter, tol): a pandas DataFrame
    of class ``cross_validate_nmf_data`` when pandas is importable,
    otherwise a dict of numpy columns with the same keys. ``mesh`` routes every
    fit to the multi-chip sparse engine. ``config`` (an NMFConfig) supplies
    the hyperparameters, taking precedence over per-argument defaults.
    """
    if config is not None:
        n_replicates, maxit, verbose = (config.reps, config.maxit,
                                        config.verbose)
        tol = config.cv_tol_effective
        L1, L2, seed = config.L1, config.L2, config.seed
        test_density = config.test_set_density
        tol_overfit, trace_test_mse = (config.tol_overfit,
                                       config.trace_test_mse)
    if L1 >= 1:
        raise ValueError("L1 penalty must be strictly in the range [0, 1)")
    if test_density > 0.2 or test_density < 0.01:
        import warnings
        warnings.warn("'test_density' should not be greater than 0.2 or less "
                      "than 0.01, as a general rule of thumb")
    enable_compilation_cache()
    P = _engine_or_providers(A, mesh)
    genes_pad = _rows_pad_of(P)
    k_top = int(max(ranks))
    inv_density = round(1.0 / test_density)

    w_inits = [
        init_w(k_top, genes_pad, _rows_true_of(P), seed=seed * 1000 + rep)
        for rep in range(1, n_replicates + 1)
    ]

    rows = []
    # expand.grid(k, rep) varies k fastest: rep-major outer, k inner
    grid = [(int(k), rep) for rep in range(1, n_replicates + 1) for k in ranks]
    for idx, (k, rep) in enumerate(grid):
        vprint(verbose, 2, f"k = {k}, rep = {rep} ({idx + 1}/{len(grid)}):")
        res = _fit_masked(
            P, k, w_init=w_inits[rep - 1][:, :k],
            mask_seed=seed + rep, inv_density=inv_density, tol=tol,
            maxit=maxit, L1=L1, L2=L2, overfit_threshold=tol_overfit,
            trace_test_mse=trace_test_mse, verbose=verbose,
        )
        for e, i, t in zip(res.test_mse, res.iter, res.tol):
            rows.append(dict(k=k, rep=rep, test_error=e, iter=i, tol=t))
        vprint(verbose, 2, f"test set error: {res.test_mse[-1]:.4e}\n")

    return trace_table(rows, ("k", "rep", "test_error", "iter", "tol"))


# ---------------------------------------------------------------------------
# ard_nmf — adaptive rank search
# ---------------------------------------------------------------------------

_ARD_COLUMNS = ("k", "rep", "test_error", "iter", "tol", "overfit_score")


def _rows_to_columns(rows: list) -> dict:
    return {c: np.asarray([r[c] for r in rows]) for c in _ARD_COLUMNS}

def ard_nmf(
    A,
    k_init: Optional[int] = 2,
    k_max: int = 100,
    k_min: int = 2,
    n_replicates: int = 1,
    tol: float = 1e-5,
    cv_tol: float = 1e-4,
    maxit: int = 100,
    verbose: int = 1,
    L1: float = 0.01,
    L2: float = 0.0,
    test_density: float = 0.05,
    learning_rate: float = 1.0,
    tol_overfit: float = 1e-3,
    trace_test_mse: int = 1,
    seed: int = 0,
    gene_names=None,
    cell_names=None,
    max_fits: int = 100,
    mesh=None,
    config=None,
    checkpoint=None,
) -> NMFModel:
    """Automatic rank determination (reference:R/ard_nmf.R:31-193).

    Replicated adaptive search: exponential step growth while the best rank
    is the largest fit so far, bisection between bracketing ranks otherwise;
    k_max shrinks to any rank that overfits; stops when the bracketing
    neighbors are within 1. Then refits unmasked at the chosen rank.

    ``max_fits`` is a safety valve (no reference counterpart) against
    pathological search oscillation. ``config`` (an NMFConfig) supplies the
    hyperparameters, taking precedence over per-argument defaults.

    ``checkpoint`` (a CheckpointManager or directory path) persists the
    SEARCH state after every completed rank fit: the accumulated CV rows
    plus the adaptive-walk position (replicate, rank, step size, shrunken
    k_max). A killed search resumed with the same arguments skips every
    completed fit and continues bit-identically — per-fit state needs no
    arrays (w inits are deterministic in ``seed``, the CV mask is a
    stateless counter-RNG of the mask seed). The recovery story for
    multi-hour searches (SURVEY §5); kill-tested at the 524k config by
    benchmarks/resume_killtest.py.
    """
    if config is not None:
        k_init, k_max, k_min = config.k_init, config.k_max, config.k_min
        n_replicates, tol, maxit = config.reps, config.tol, config.maxit
        cv_tol = config.cv_tol_effective
        L1, L2, seed, verbose = (config.L1, config.L2, config.seed,
                                 config.verbose)
        test_density = config.test_set_density
        learning_rate, tol_overfit = (config.learning_rate,
                                      config.tol_overfit)
        trace_test_mse = config.trace_test_mse
    if L1 >= 1:
        raise ValueError("L1 penalty must be strictly in the range [0, 1)")
    if test_density > 0.2 or test_density < 0.01:
        import warnings
        warnings.warn("'test_density' should not be greater than 0.2 or less "
                      "than 0.01, as a general rule of thumb")
    if k_init is None or k_init < k_min:
        k_init = k_min
    if k_min < 2:
        raise ValueError("k_min cannot be less than 2")
    enable_compilation_cache()

    P = _engine_or_providers(A, mesh)
    genes_pad = _rows_pad_of(P)
    inv_density = round(1.0 / test_density)
    test_seed = seed

    w_inits = [
        init_w(k_max, genes_pad, _rows_true_of(P), seed=seed * 1000 + rep)
        for rep in range(1, n_replicates + 1)
    ]

    # --- search-state checkpointing (saved after every completed fit) ----
    from singlet_tpu.checkpoint import CheckpointManager, resolve_manager

    ckpt = resolve_manager(checkpoint, default_every=1)
    ckpt_cfg = CheckpointManager.config_of(
        kind="ard_search", genes=int(_rows_true_of(P)),
        k_init=int(k_init), k_max=int(k_max), k_min=int(k_min),
        n_replicates=int(n_replicates), tol=float(tol), cv_tol=float(cv_tol),
        maxit=int(maxit), L1=float(L1), L2=float(L2),
        inv_density=int(inv_density), learning_rate=float(learning_rate),
        tol_overfit=float(tol_overfit), trace_test_mse=int(trace_test_mse),
        seed=int(seed)) if ckpt else None
    # (max_fits is deliberately NOT fingerprinted: resuming a valve-stopped
    # search with a larger max_fits is a supported workflow)

    rows = []
    n_fits = 0
    start_rep, resume_inner = 1, None
    if ckpt is not None:
        st = ckpt.restore(ckpt_cfg, verbose=verbose >= 1)
        if st is not None:
            rows = list(st["rows"])
            n_fits = int(st["n_fits"])
            start_rep = int(st["curr_rep"])
            if st.get("in_rep"):
                resume_inner = (float(st["step_size"]),
                                int(st["curr_rank"]), int(st["this_k_max"]))

    def _save_search(curr_rep, in_rep, step_size=1.0, curr_rank=0,
                     this_k_max=0):
        if ckpt is None:
            return
        ckpt.save(n_fits, dict(
            ckpt_cfg, rows=rows, n_fits=int(n_fits), curr_rep=int(curr_rep),
            in_rep=bool(in_rep), step_size=float(step_size),
            curr_rank=int(curr_rank), this_k_max=int(this_k_max)))

    for curr_rep in range(start_rep, n_replicates + 1):
        if verbose >= 1 and n_replicates > 1:
            print(f"\nREPLICATE {curr_rep}/{n_replicates}")
        if resume_inner is not None:
            step_size, curr_rank, this_k_max = resume_inner
            resume_inner = None
        else:
            step_size = 1.0
            curr_rank = int(k_init)
            this_k_max = k_max
        while (step_size >= 1 and curr_rank <= this_k_max
               and curr_rank >= k_min and n_fits < max_fits):
            vprint(verbose, 1, f"k = {curr_rank} , rep = {curr_rep}")
            res = _fit_masked(
                P, curr_rank,
                w_init=w_inits[curr_rep - 1][:, :curr_rank],
                mask_seed=test_seed + curr_rep, inv_density=inv_density,
                tol=cv_tol, maxit=maxit, L1=L1, L2=L2,
                overfit_threshold=tol_overfit,
                trace_test_mse=trace_test_mse, verbose=verbose,
            )
            n_fits += 1
            overfit_score = res.score_overfit[-1]
            # plain Python scalars: keeps the frame dtype identical between
            # fresh and checkpoint-resumed (JSON round-tripped) searches
            for e, i, t in zip(res.test_mse, res.iter, res.tol):
                rows.append(dict(k=int(curr_rank), rep=int(curr_rep),
                                 test_error=float(e), iter=int(i),
                                 tol=float(t),
                                 overfit_score=float(overfit_score)))
            vprint(verbose, 2, f"   test_error = {res.test_mse[-1]:.4e}")
            if overfit_score >= tol_overfit:
                this_k_max = curr_rank

            rep_rows = sorted((r for r in rows if r["rep"] == curr_rep),
                              key=lambda r: r["k"])
            # NOTE: the reference calls GetBestRank with its *default*
            # tol.overfit here (reference:R/ard_nmf.R:129), not tol_overfit.
            best_rank = get_best_rank(_rows_to_columns(
                [r for r in rep_rows if r["k"] < this_k_max]))
            vprint(verbose, 2, f"   best rank in replicate = {best_rank}\n")
            kvals = sorted({r["k"] for r in rep_rows})
            if best_rank not in kvals:
                # can occur only via the empty-frame fallback of
                # get_best_rank; step outward from it
                curr_rank = best_rank + int(step_size)
                step_size *= (1 + learning_rate)
                _save_search(curr_rep, True, step_size, curr_rank,
                             this_k_max)
                continue
            rank_ind = kvals.index(best_rank)
            if rank_ind == len(kvals) - 1:
                step_size *= (1 + learning_rate)
                curr_rank = best_rank + int(step_size)
            elif rank_ind == 0:
                if int(step_size) < best_rank:
                    curr_rank = best_rank - int(step_size)
                    step_size *= (learning_rate + 1)
                else:
                    curr_rank = best_rank // 2
            else:
                next_lower = kvals[rank_ind - 1]
                next_higher = kvals[rank_ind + 1]
                diff_lower = best_rank - next_lower
                diff_higher = next_higher - best_rank
                if diff_lower <= 1 and diff_higher <= 1:
                    break
                elif diff_lower >= diff_higher:
                    curr_rank = best_rank - diff_lower // 2
                else:
                    curr_rank = best_rank + diff_higher // 2
            _save_search(curr_rep, True, step_size, curr_rank, this_k_max)
        # replicate finished — unless the max_fits safety valve stopped it
        # mid-search (then the in-rep state above must survive so a resume
        # with a larger max_fits continues the walk)
        if not (step_size >= 1 and curr_rank <= this_k_max
                and curr_rank >= k_min and n_fits >= max_fits):
            _save_search(curr_rep + 1, False)

    df = trace_table(rows, _ARD_COLUMNS)
    best_rank = get_best_rank(_rows_to_columns(rows), tol_overfit)

    vprint(verbose, 1, f"\nFitting final model at k = {best_rank}")
    w, d, h = _fit_plain(P, best_rank, w_init=w_inits[0][:, :best_rank],
                         tol=tol, maxit=maxit, L1=L1, L2=L2, seed=seed,
                         verbose=verbose > 2)
    return _finalize(w, d, h, gene_names, cell_names, cv_data=df)
