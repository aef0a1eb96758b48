"""Per-instance feature stores written by offline extraction.

Port of ``scd_tpu/data/features.py``: the reader
(:class:`FeatureVectorDataset`, which the k-means runners collate) and the
two savers that ``pipelines/extract.py`` calls: the packed single-file
store (``features_packed.npz``: one [N, D] array with a ``uq_idxs`` index)
and the reference's one-file-per-instance tree
(``feature_root/{label}/{uq_idx}.npy``).  The layouts are the JAX
package's, so either package reads what the other writes.
"""

from __future__ import annotations

import os

import numpy as np


class FeatureVectorDataset:
    """Wraps a base dataset, yielding (feature, label, uq_idx[, mask_lab])
    with each image swapped for its stored feature."""

    def __init__(self, base_dataset, feature_root: str):
        self.base_dataset = base_dataset
        self.feature_root = feature_root
        packed = os.path.join(feature_root, "features_packed.npz")
        self._packed = None
        if os.path.exists(packed):
            with np.load(packed) as z:
                self._packed = {int(u): i for i, u in enumerate(z["uq_idxs"])}
                self._feats = z["features"]

    def _feature(self, label: int, uq: int) -> np.ndarray:
        if self._packed is not None:
            return self._feats[self._packed[uq]]
        return np.load(os.path.join(self.feature_root, str(label),
                                    f"{uq}.npy"))

    def __len__(self):
        return len(self.base_dataset)

    def __getitem__(self, idx: int):
        item = self.base_dataset[idx]
        if len(item) == 4:
            _img, label, uq, lab = item
            return self._feature(int(label), int(uq)), label, uq, lab
        _img, label, uq = item
        return self._feature(int(label), int(uq)), label, uq


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
