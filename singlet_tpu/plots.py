"""Visualization: rank selection, metadata composition, annotations, GSEA.

Matplotlib equivalents of the reference's ggplot surface: ``RankPlot`` /
``plot.cross_validate_nmf_data`` (reference:R/plot.cross_validate_nmf_data.R:13-58),
``MetadataPlot`` / ``MetadataHeatmap`` (reference:R/MetadataPlot.R,
MetadataHeatmap.R), ``AnnotationPlot`` (reference:R/AnnotationPlot.R:160-267),
``GSEAHeatmap`` (reference:R/GSEAHeatmap.R:13-75), ``plotFactorWeights``.
Each function returns the matplotlib Figure.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from singlet_tpu.solvers.drivers import get_best_rank
from singlet_tpu.utils import LazyModule

pd = LazyModule("pandas")
# headless backend, chosen before pyplot is first imported
plt = LazyModule("matplotlib.pyplot",
                 setup=lambda: __import__("matplotlib").use("Agg"))


def rank_plot(cv_data: pd.DataFrame, detail: int = 1,
              tol_overfit: float = 1e-4, min_iter: int = 5):
    """Test-set error vs rank (reference:R/RankPlot.R + the cross-validation
    frame's plot method). detail=1: final error per (rank, rep), normalized
    per replicate, log-y; detail=2: full per-iteration traces."""
    df = cv_data.copy()
    best = get_best_rank(df, tol_overfit)
    fig, ax = plt.subplots(figsize=(5, 5))
    if detail == 1:
        condensed = (df.sort_values("iter").groupby(["rep", "k"],
                                                    as_index=False).last())
        for rep, sub in condensed.groupby("rep"):
            sub = sub.sort_values("k")
            err = sub["test_error"] / sub["test_error"].min()
            ax.plot(sub["k"], err, marker="o", label=f"rep {rep}")
        ax.set_ylabel("relative test set error")
        ax.legend(title="replicate", frameon=False)
    else:
        df = df[df["iter"] >= min_iter]
        for (rep, it), sub in df.groupby(["rep", "iter"]):
            sub = sub.sort_values("k")
            ax.plot(sub["k"], sub["test_error"],
                    color=plt.cm.inferno(min(it / max(df["iter"].max(), 1), 1.0)),
                    linewidth=0.8)
        ax.set_ylabel("test set error")
    ax.set_yscale("log")
    ax.axvline(best, linestyle="--", color="red")
    ax.set_xlabel("factorization rank")
    ax.set_title(f"(best rank is k = {best})", fontsize=10)
    fig.tight_layout()
    return fig


def metadata_plot(summary: pd.DataFrame, stacked: bool = True):
    """Stacked-bar composition of groups per factor (MetadataPlot): summary is
    the (groups x factors) frame from :func:`singlet_tpu.summary.metadata_summary`."""
    fig, ax = plt.subplots(figsize=(max(6, summary.shape[1] * 0.4), 4))
    bottoms = np.zeros(summary.shape[1])
    x = np.arange(summary.shape[1])
    for gi, group in enumerate(summary.index):
        vals = summary.loc[group].to_numpy()
        ax.bar(x, vals, bottom=bottoms if stacked else None, label=str(group))
        if stacked:
            bottoms += vals
    ax.set_xticks(x)
    ax.set_xticklabels(summary.columns, rotation=90, fontsize=7)
    ax.set_ylabel("fraction of factor weight")
    ax.legend(frameon=False, fontsize=7, bbox_to_anchor=(1.02, 1),
              loc="upper left")
    fig.tight_layout()
    return fig


def metadata_heatmap(summary: pd.DataFrame):
    """Heatmap form of the metadata summary (MetadataHeatmap)."""
    fig, ax = plt.subplots(figsize=(max(6, summary.shape[1] * 0.3),
                                    max(3, summary.shape[0] * 0.3)))
    im = ax.imshow(summary.to_numpy(), aspect="auto", cmap="viridis")
    ax.set_xticks(range(summary.shape[1]))
    ax.set_xticklabels(summary.columns, rotation=90, fontsize=7)
    ax.set_yticks(range(summary.shape[0]))
    ax.set_yticklabels(summary.index, fontsize=7)
    fig.colorbar(im, ax=ax, label="fraction of factor weight")
    fig.tight_layout()
    return fig


def annotation_plot(annotation: pd.DataFrame, max_p: float = 0.05,
                    cluster: bool = True):
    """Dot plot of factor-group associations (AnnotationPlot,
    reference:R/AnnotationPlot.R:160-267): dot size ~ -log10 FDR, color ~
    lods evidence; rows/cols ordered by binary-pattern clustering."""
    df = annotation[annotation["p"] <= max_p]
    if len(df) == 0:
        raise ValueError("no associations at this significance level")
    groups = sorted(df["group"].unique())
    factors = sorted(df["factor"].unique())
    M_p = np.full((len(groups), len(factors)), np.nan)
    M_fc = np.full((len(groups), len(factors)), np.nan)
    gi = {g: i for i, g in enumerate(groups)}
    fi = {f: i for i, f in enumerate(factors)}
    for _, row in df.iterrows():
        M_p[gi[row["group"]], fi[row["factor"]]] = row["p"]
        M_fc[gi[row["group"]], fi[row["factor"]]] = row["fc"]
    if cluster and len(groups) > 2 and len(factors) > 2:
        from scipy.cluster.hierarchy import leaves_list, linkage

        pattern = (~np.isnan(M_p)).astype(float)
        ro = leaves_list(linkage(pattern, method="ward"))
        co = leaves_list(linkage(pattern.T, method="ward"))
        groups = [groups[i] for i in ro]
        factors = [factors[i] for i in co]
        M_p = M_p[np.ix_(ro, co)]
        M_fc = M_fc[np.ix_(ro, co)]
    fig, ax = plt.subplots(figsize=(max(5, len(factors) * 0.4),
                                    max(3, len(groups) * 0.3)))
    ys, xs = np.where(~np.isnan(M_p))
    sizes = -np.log10(np.clip(M_p[ys, xs], 1e-300, 1)) * 12
    colors = M_fc[ys, xs]
    sc = ax.scatter(xs, ys, s=np.clip(sizes, 5, 300), c=colors, cmap="viridis")
    ax.set_xticks(range(len(factors)))
    ax.set_xticklabels(factors, rotation=90, fontsize=7)
    ax.set_yticks(range(len(groups)))
    ax.set_yticklabels(groups, fontsize=7)
    ax.invert_yaxis()
    fig.colorbar(sc, ax=ax, label="lods (fc)")
    fig.tight_layout()
    return fig


def gsea_heatmap(gsea: dict, top_n: int = 50, field: str = "padj"):
    """Heatmap of -log10 adjusted p-values, most significant pathways
    (GSEAHeatmap, reference:R/GSEAHeatmap.R:13-75)."""
    M = gsea[field]
    scores = M.max(axis=1).sort_values(ascending=False)
    M = M.loc[scores.index[:top_n]]
    fig, ax = plt.subplots(figsize=(max(5, M.shape[1] * 0.4),
                                    max(4, M.shape[0] * 0.22)))
    im = ax.imshow(M.to_numpy().astype(float), aspect="auto", cmap="inferno")
    ax.set_xticks(range(M.shape[1]))
    ax.set_xticklabels(M.columns, rotation=90, fontsize=7)
    ax.set_yticks(range(M.shape[0]))
    ax.set_yticklabels([str(s)[:60] for s in M.index], fontsize=6)
    fig.colorbar(im, ax=ax, label=f"-log10 {field}")
    fig.tight_layout()
    return fig


def factor_weights_ranges(model, ranges: pd.DataFrame,
                          factors: Optional[Sequence] = None) -> pd.DataFrame:
    """Map factor loadings onto genomic coordinates — the exact analogue of
    ``plotFactorWeights``'s return value (reference:R/plotFactorWeights.R:
    20-38: subset the GRanges to the model's features, add one ``mcols``
    column of weights per requested factor, return the annotated ranges;
    its igvR rendering is an unimplemented stub emitting "igvR support is
    in process").

    ``ranges``: DataFrame indexed by gene name with columns ``chrom`` and
    ``start`` (``end`` optional). Like the reference's
    ``stopifnot(all(rownames(object@w) %in% names(gr)))``, every model gene
    must be present. Returns ranges subset/ordered to the model's genes
    with one added column per factor (named as in ``model.factor_names``).
    """
    if model.gene_names is None:
        raise ValueError("model has no gene_names; cannot map to ranges")
    genes = list(model.gene_names)
    missing = [g for g in genes if g not in ranges.index]
    if missing:
        raise ValueError(
            f"{len(missing)} model genes missing from ranges "
            f"(first: {missing[:5]})")
    out = ranges.loc[genes].copy()
    if factors is None:
        factors = range(min(3, model.w.shape[1]))   # reference default 1:3
    for f in factors:
        fi = (model.factor_names.index(f) if isinstance(f, str)
              else int(f))
        out[model.factor_names[fi]] = np.asarray(model.w)[:, fi]
    return out


def plot_factor_weights(model, factor: int, top_n: int = 30,
                        ranges: Optional[pd.DataFrame] = None):
    """Factor loadings plot (``plotFactorWeights``,
    reference:R/plotFactorWeights.R).

    With ``ranges`` (gene -> chrom/start[/end] table), renders a static
    genomic-coordinate track: one panel per chromosome, loadings as stems
    at each gene's start position — the rendering igvR would have provided
    (the reference's own igvR branch is a stub). Without ``ranges``, shows
    the ranked loading profile."""
    w = np.asarray(model.w)[:, factor]
    names = model.gene_names or [str(i) for i in range(len(w))]
    if ranges is not None:
        ann = factor_weights_ranges(model, ranges, factors=[factor])
        fname = model.factor_names[factor]
        chroms = list(dict.fromkeys(ann["chrom"]))   # first-seen order
        fig, axes = plt.subplots(len(chroms), 1, sharey=True,
                                 figsize=(8, max(2, 1.1 * len(chroms))),
                                 squeeze=False)
        ymax = float(ann[fname].max()) or 1.0
        for ax, ch in zip(axes[:, 0], chroms):
            sub = ann[ann["chrom"] == ch].sort_values("start")
            ax.vlines(sub["start"], 0, sub[fname], lw=1.2)
            ax.set_ylabel(str(ch), rotation=0, ha="right", fontsize=8)
            ax.set_ylim(0, ymax * 1.05)
            ax.tick_params(labelsize=6)
            # label the strongest loadings on each chromosome
            top = sub.nlargest(min(3, len(sub)), fname)
            for g, row in top.iterrows():
                if row[fname] > 0.2 * ymax:
                    ax.annotate(str(g), (row["start"], row[fname]),
                                fontsize=5, rotation=45,
                                textcoords="offset points", xytext=(1, 1))
        axes[-1, 0].set_xlabel("genomic position (bp)")
        axes[0, 0].set_title(f"{fname} loadings along the genome",
                             fontsize=9)
        fig.tight_layout()
        return fig
    order = np.argsort(-w)[:top_n]
    fig, ax = plt.subplots(figsize=(5, max(3, top_n * 0.18)))
    ax.barh(range(len(order)), w[order][::-1])
    ax.set_yticks(range(len(order)))
    ax.set_yticklabels([names[i] for i in order][::-1], fontsize=6)
    ax.set_xlabel(f"{model.factor_names[factor]} loading")
    fig.tight_layout()
    return fig
