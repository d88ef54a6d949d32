"""Independent float64 numpy oracle of the reference algorithm semantics.

Implements, from the behavioral spec in SURVEY.md (citations inline), the
dense-mode solver pipeline of the reference: stateless mask hash, CD-NNLS,
predict / predict_mask half-updates, scale, cor, test-set MSE, the plain ALS
loop and the masked (ARD) loop with overfit early-stop. Used as the golden
comparator for the JAX engine. Deliberately simple and slow.

Orientation follows the reference internals: w is (k, genes), h is (k, cells),
A is (genes, cells) dense.
"""

import numpy as np

M64 = (1 << 64) - 1


# --- stateless hash (reference:src/singlet.cpp:30-64) ----------------------
def hash_ij(seed: int, i: int, j: int) -> int:
    i &= M64
    i ^= (i << 19) & M64
    i ^= i >> 7
    i ^= (i << 36) & M64
    x = (seed + i) & M64
    x ^= (x << 38) & M64
    x ^= x >> 13
    x ^= (x << 23) & M64
    j &= M64
    j ^= j >> 7
    j ^= (j << 23) & M64
    j ^= j >> 8
    x = (x + j) & M64
    x ^= x >> 7
    x ^= (x << 53) & M64
    x ^= x >> 4
    return x


def is_masked(seed, cell, gene, inv_density):
    return hash_ij(seed, cell, gene) % inv_density == 0


def mask_matrix(seed, n_genes, n_cells, inv_density):
    """bool (genes, cells); True = held-out test entry."""
    m = np.zeros((n_genes, n_cells), dtype=bool)
    for c in range(n_cells):
        for g in range(n_genes):
            m[g, c] = is_masked(seed, c, g, inv_density)
    return m


# --- CD NNLS (reference:src/singlet.cpp:229-250) ---------------------------
def nnls_cd(a, b, x, L1=0.0, L2=0.0, max_sweeps=100):
    b = b.astype(np.float64).copy()
    x = x.astype(np.float64).copy()
    k = b.size
    tol = 1.0
    it = 0
    while it < max_sweeps and tol / k > 1e-8:
        tol = 0.0
        for i in range(k):
            diff = b[i] / a[i, i]
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


def AAt(w):
    a = w @ w.T
    return a + 1e-15 * np.eye(a.shape[0])


def scale(w):
    d = w.sum(axis=1) + 1e-15
    return w / d[:, None], d


def cor_distance(x, y):
    xf, yf = x.ravel(), y.ravel()
    n = xf.size
    sx, sy = xf.sum(), yf.sum()
    sxy = xf @ yf
    sx2, sy2 = xf @ xf, yf @ yf
    return 1 - (n * sxy - sx * sy) / np.sqrt((n * sx2 - sx * sx) * (n * sy2 - sy * sy))


# --- dense predict (reference:src/singlet.cpp:370-381) ---------------------
def predict(A, w, h, L1, L2, link=None, skip_empty=False, max_sweeps=100):
    a = AAt(w)
    for i in range(A.shape[1]):
        if skip_empty and not np.any(A[:, i]):
            continue
        b = w @ A[:, i]
        if link is not None:
            b = b * link[:, i]
        h[:, i] = nnls_cd(a, b, h[:, i], L1, L2, max_sweeps=max_sweeps)
    return h


# --- adaptive inexact-solve schedule (singlet_tpu.ops.nnls) -----------------
class SweepSchedule:
    """f64 twin of singlet_tpu.ops.nnls.sweep_cap_update: inner CD solves
    are capped at ``fast`` sweeps until the outer tol first drops under
    max(10 * tol_target, 1e-4); from then on (latched) the full cap runs.
    Mirrors the JAX engines' DEFAULT so oracle trajectories stay comparable;
    pass adaptive_sweeps=False for the reference's unconditional 100."""

    def __init__(self, tol_target, fast=8, full=100, exact_tol=1e-4):
        # fast=8 for plain fits, fast=32 for masked (CV/rank-search) fits —
        # mirrors CD_FAST_SWEEPS / CD_FAST_SWEEPS_MASKED in ops/nnls.py
        self.thresh = max(10.0 * tol_target, exact_tol)
        self.fast, self.full = fast, full
        self.exact = False

    def cap(self, tol_prev):
        self.exact = self.exact or tol_prev <= self.thresh
        return self.full if self.exact else self.fast


# --- masked predict (reference:src/singlet.cpp:506-531) --------------------
def predict_mask(A, seed, inv_density, w, h, L1, L2, mask_t,
                 max_sweeps=100):
    """A here is the operand being looped (A or At); mask_t=True when the
    operand columns are genes (w update)."""
    a = AAt(w)
    for i in range(A.shape[1]):
        b = np.zeros(h.shape[0])
        idx = []
        for j in range(A.shape[0]):
            masked = (is_masked(seed, j, i, inv_density) if mask_t
                      else is_masked(seed, i, j, inv_density))
            if masked:
                idx.append(j)
            else:
                b += A[j, i] * w[:, j]
        wsub = w[:, idx]
        a_i = a - AAt(wsub) + 1e-15 * np.eye(a.shape[0]) * 0  # AAt adds jitter once
        # note: reference computes a - AAt(wsub); AAt(wsub) carries its own
        # +1e-15 diag, so the jitters cancel to zero net on the diagonal:
        h[:, i] = nnls_cd(a_i, b, h[:, i], L1, L2, max_sweeps=max_sweeps)
    return h


# --- test-set mse (reference:src/singlet.cpp:610-634) ----------------------
def mse_test(A, w, d, h, seed, inv_density):
    w_ = w.T * d[None, :]          # (genes, k)
    losses = np.zeros(h.shape[1])
    for c in range(h.shape[1]):
        n = 0
        s = 0.0
        for g in range(A.shape[0]):
            if is_masked(seed, c, g, inv_density):
                n += 1
                s += (w_[g] @ h[:, c] - A[g, c]) ** 2
        losses[c] = s / n if n > 0 else 0.0
    return losses.sum() / h.shape[1]


# --- plain ALS (reference:src/singlet.cpp:639-666) -------------------------
def nmf(A, w, tol=1e-4, maxit=100, L1_w=0.01, L1_h=0.01, L2_w=0.0, L2_h=0.0,
        skip_empty=True, adaptive_sweeps=True):
    h = np.zeros((w.shape[0], A.shape[1]))
    d = np.ones(w.shape[0])
    tol_ = 1.0
    traces = []
    it = 0
    sched = SweepSchedule(tol) if adaptive_sweeps else None
    while it < maxit and tol_ > tol:
        cap = sched.cap(tol_) if sched else 100
        w_it = w.copy()
        h = predict(A, w, h, L1_h, L2_h, skip_empty=skip_empty,
                    max_sweeps=cap)
        h, d = scale(h)
        w = predict(A.T, h, w, L1_w, L2_w, skip_empty=skip_empty,
                    max_sweeps=cap)
        w, d = scale(w)
        tol_ = cor_distance(w, w_it)
        traces.append(tol_)
        it += 1
    return dict(w=w, d=d, h=h, tol=tol_, traces=traces)


# --- masked ALS with traces (reference:src/singlet.cpp:1091-1152) ----------
def ard_nmf(A, w, seed, inv_density, tol=1e-4, maxit=100, L1=0.01, L2=0.0,
            overfit_threshold=1e-3, trace_test_mse=1, adaptive_sweeps=True):
    h = np.zeros((w.shape[0], A.shape[1]))
    d = np.ones(w.shape[0])
    tol_ = 1.0
    test_mse_t, iter_t, tol_t, overfit_t = [], [], [], []
    it = 0
    sched = SweepSchedule(tol, fast=32) if adaptive_sweeps else None
    while it < maxit and tol_ > tol:
        cap = sched.cap(tol_) if sched else 100
        w_it = w.copy()
        h = predict_mask(A, seed, inv_density, w, h, L1, L2, mask_t=False,
                         max_sweeps=cap)
        h, d = scale(h)
        w = predict_mask(A.T, seed, inv_density, h, w, L1, L2, mask_t=True,
                         max_sweeps=cap)
        w, d = scale(w)
        tol_ = cor_distance(w, w_it)
        broke = False
        if it % trace_test_mse == 0:
            err = mse_test(A, w, d, h, seed, inv_density)
            test_mse_t.append(err)
            iter_t.append(it)
            tol_t.append(tol_)
            score = (err - min(test_mse_t)) / (err + min(test_mse_t))
            overfit_t.append(score)
            if score > overfit_threshold:
                broke = True
                break
        it += 1
    # tail trace exactly as reference:src/singlet.cpp:1130-1141
    if it % trace_test_mse != 0:
        err = mse_test(A, w, d, h, seed, inv_density)
        test_mse_t.append(err)
        iter_t.append(it)
        tol_t.append(tol_)
        score = (err - min(test_mse_t)) / (err + min(test_mse_t))
        overfit_t.append(score)
    return dict(w=w, d=d, h=h, test_mse=test_mse_t, iter=iter_t,
                tol=tol_t, score_overfit=overfit_t)
