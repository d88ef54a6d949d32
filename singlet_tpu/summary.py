"""Group-wise factor summaries and shared/unique factor selection.

Equivalents of ``MetadataSummary`` (reference:R/MetadataSummary.R:16-36) and
``GetSharedFactors`` / ``GetUniqueFactors`` (reference:R/GetSharedFactors.R:4-10,
GetUniqueFactors.R:4-10).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from singlet_tpu.utils import LazyModule

pd = LazyModule("pandas")


def metadata_summary(h: np.ndarray, factor_data: Sequence,
                     reorder: bool = True,
                     factor_names: Sequence[str] | None = None) -> pd.DataFrame:
    """Mean weight of each sample group within each factor.

    h: (k, cells); factor_data: length-cells group labels.
    Returns a (groups x factors) frame where each factor column is normalized
    to sum to 1 across groups (the reference's ``apply(m, 1, x/sum(x))``
    transposition, reference:R/MetadataSummary.R:26-27).
    """
    h = np.asarray(h)
    labels = np.asarray(factor_data)
    levels = sorted({str(v) for v in labels if v is not None and v == v})
    if factor_names is None:
        factor_names = [f"factor{i + 1}" for i in range(h.shape[0])]
    m = np.zeros((h.shape[0], len(levels)))
    for j, lv in enumerate(levels):
        sel = np.asarray([str(v) == lv for v in labels])
        m[:, j] = h[:, sel].mean(axis=1) if sel.any() else 0.0
    # normalize each factor's row across groups, then transpose
    m = (m / m.sum(axis=1, keepdims=True)).T            # (levels, k)
    df = pd.DataFrame(m, index=levels, columns=list(factor_names))
    if len(levels) == 2:
        # with 2 groups the reference orders the group rows by the first
        # factor column, decreasing
        df = df.iloc[np.argsort(-df.iloc[:, 0].to_numpy(), kind="stable")]
    elif reorder and len(levels) > 2:
        from scipy.cluster.hierarchy import leaves_list, linkage

        M = df.to_numpy()
        if M.shape[0] > 2:
            ro = leaves_list(linkage(M, method="ward"))
            df = df.iloc[ro]
        if M.shape[1] > 2:
            co = leaves_list(linkage(M.T, method="ward"))
            df = df.iloc[:, co]
    return df


def get_unique_factors(model, groups: Sequence) -> List[int]:
    """Factor indices where some group's normalized mean weight is exactly 0
    (LNMF group-specific factors)."""
    summ = metadata_summary(model.h, groups, reorder=False,
                            factor_names=model.factor_names)
    mins = summ.min(axis=0).to_numpy()
    return [i for i, v in enumerate(mins) if v == 0]


def get_shared_factors(model, groups: Sequence) -> List[int]:
    """Complement of :func:`get_unique_factors` — use these dims for UMAP
    after linked NMF (reference vignette workflow)."""
    uniq = set(get_unique_factors(model, groups))
    return [i for i in range(model.k) if i not in uniq]
