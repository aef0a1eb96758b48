"""Diagnostic figure savers (t-SNE scatter, heatmap, CVI curves).

Port of ``scd_tpu/utils/plots.py`` (reference ``local_utils/util.py:178-247``:
``save_tsne``, ``save_heatmap``, ``save_cvi_curves``).  Matplotlib is
imported inside the functions with the Agg backend, so a headless host
never needs a display; sklearn provides TSNE.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def save_tsne(embeddings: np.ndarray, labels: np.ndarray,
              path: str = "tsne.png", marker_size: int = 5,
              seed: int = 0) -> None:
    """2-D t-SNE scatter colored by label (reference ``util.py:178-194``)."""
    from sklearn.manifold import TSNE

    plt = _plt()
    x2d = TSNE(n_components=2, random_state=seed).fit_transform(
        np.asarray(embeddings))
    labels = np.asarray(labels)
    names = np.unique(labels)
    vals = np.linspace(0, 1, len(names))
    np.random.default_rng(seed).shuffle(vals)
    cmap = plt.cm.colors.ListedColormap(plt.cm.gist_ncar(vals))
    fig = plt.figure(figsize=(8, 6))
    for i, name in enumerate(names):
        sel = labels == name
        plt.scatter(x2d[sel, 0], x2d[sel, 1], c=[cmap(i)], label=str(name),
                    s=marker_size)
    plt.legend(loc="center left", bbox_to_anchor=(1, 0.5))
    plt.axis("equal")
    plt.savefig(path, bbox_inches="tight")
    plt.close(fig)


def save_heatmap(data: np.ndarray, figsize=(4, 10),
                 path: str = "heatmap.png") -> None:
    """Matrix heatmap (reference ``util.py:221-226``; seaborn dropped — a
    plain imshow+colorbar needs no extra dependency)."""
    plt = _plt()
    fig = plt.figure(figsize=figsize)
    plt.imshow(np.asarray(data), aspect="auto", cmap="viridis")
    plt.colorbar()
    plt.savefig(path, bbox_inches="tight")
    plt.close(fig)


def save_cvi_curves(val_list: Sequence[Sequence[float]],
                    k_list: Sequence[int], figsize=(4, 10),
                    path: str = "cvi_curves.png") -> None:
    """Cluster-validity-index curves vs K: acc/nmi/ari/silhouette/dunn
    (reference ``util.py:228-247``)."""
    plt = _plt()
    fig = plt.figure(figsize=figsize)
    names = ("acc", "nmi", "ari", "silh", "dunn")
    colors = ("r", "g", "b", "c", "m")
    arr = np.asarray(val_list, dtype=float)
    for j, (name, color) in enumerate(zip(names, colors)):
        if j < arr.shape[1]:
            plt.plot(k_list, arr[:, j], color=color, marker=".",
                     linewidth=2, markersize=7, label=name)
    plt.xlabel("k", fontsize=14)
    plt.ylabel("CVIs", fontsize=14)
    plt.title("CVI Curves", fontsize=14)
    plt.tight_layout()
    plt.legend()
    plt.savefig(path, bbox_inches="tight")
    plt.close(fig)
