"""Per-instance feature stores written by offline extraction.

Port of the two savers of ``scd_tpu/data/features.py`` that
``pipelines/extract.py`` calls: the packed single-file store
(``features_packed.npz``: one [N, D] array with a ``uq_idxs`` index) and
the reference's one-file-per-instance tree
(``feature_root/{label}/{uq_idx}.npy``).  The layouts are the JAX
package's, so its ``FeatureVectorDataset`` reads what these write.
"""

from __future__ import annotations

import os

import numpy as np


def save_features_packed(feature_root: str, features: np.ndarray,
                         uq_idxs: np.ndarray,
                         targets: np.ndarray = None,
                         mask_lab: np.ndarray = None) -> str:
    os.makedirs(feature_root, exist_ok=True)
    path = os.path.join(feature_root, "features_packed.npz")
    extra = {}
    if targets is not None:
        extra["targets"] = np.asarray(targets, np.int64)
    if mask_lab is not None:
        extra["mask_lab"] = np.asarray(mask_lab, bool)
    np.savez(path, features=np.asarray(features, np.float32),
             uq_idxs=np.asarray(uq_idxs, np.int64), **extra)
    return path


def save_features_tree(feature_root: str, features: np.ndarray,
                       labels: np.ndarray, uq_idxs: np.ndarray) -> None:
    """The reference's one-file-per-instance layout."""
    for f, lab, uq in zip(features, labels, uq_idxs):
        d = os.path.join(feature_root, str(int(lab)))
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(d, f"{int(uq)}.npy"), np.asarray(f, np.float32))
