"""Dataset registry + class splits (reference ``gcd/data/get_datasets.py``).

Port of ``scd_tpu/data/registry.py``: every reader of the JAX registry,
under the same root subdirectories, and the class splits of every
dataset.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence, Tuple

from scd_tpu_torch.core.config import DataConfig
from scd_tpu_torch.data import datasets as D
from scd_tpu_torch.data.core import (
    GCDSplits,
    MergedDataset,
    build_gcd_splits,
    make_target_transform,
)

_READERS = {
    "synthetic": lambda cfg: D.make_synthetic(),
    "cub": lambda cfg: D.make_cub(cfg.root_dir),
    "sdogs": lambda cfg: D.make_sdogs(cfg.root_dir),
    "cifar10": lambda cfg: D.make_cifar(cfg.root_dir, 10),
    "cifar100": lambda cfg: D.make_cifar(cfg.root_dir, 100),
    "imagenet_100": lambda cfg: D.make_imagenet_100(
        os.path.join(cfg.root_dir, "ILSVRC12")),
    "imagenet_1000": lambda cfg: D.make_imagenet_1000(
        os.path.join(cfg.root_dir, "ILSVRC12")),
    "imagenet_127": lambda cfg: D.make_imagenet_127(
        os.path.join(cfg.root_dir, "imagenet127")),
    "aircraft": lambda cfg: D.make_aircraft(cfg.root_dir),
    "scars": lambda cfg: D.make_scars(cfg.root_dir),
    "herbarium_19": lambda cfg: D.make_herbarium(cfg.root_dir),
    "imagefolder": lambda cfg: D.make_imagefolder(
        os.path.join(cfg.root_dir, "train"), os.path.join(cfg.root_dir, "val")),
}

# default Old/New class ranges (reference get_class_splits,
# get_datasets.py:101-231); SSB datasets may override from pickles
_DEFAULT_SPLITS = {
    "synthetic": (range(5), range(5, 10)),
    "cifar10": (range(5), range(5, 10)),
    "cifar100": (range(80), range(80, 100)),
    "imagenet_100": (range(50), range(50, 100)),
    "imagenet_1000": (range(500), range(500, 1000)),
    "imagenet_127": (range(64), range(64, 127)),
    "sdogs": (range(60), range(60, 120)),
    "cub": (range(100), range(100, 200)),
    "scars": (range(98), range(98, 196)),
    "aircraft": (range(50), range(50, 100)),
}


def get_class_splits(cfg: DataConfig,
                     ssb_dir: Optional[str] = None
                     ) -> Tuple[Sequence[int], Sequence[int]]:
    """(train_classes, unlabeled_classes) for a dataset; SSB pickle splits for
    cub/scars/aircraft/herbarium when available and enabled."""
    name = cfg.dataset_name
    ssb_dir = ssb_dir or os.path.join(cfg.root_dir, "ssb_splits")

    if name in ("cub", "scars", "aircraft") and cfg.use_ssb_splits:
        path = os.path.join(ssb_dir, f"{name}_osr_splits.pkl")
        if not os.path.exists(path):
            # fail loudly like the reference: silently falling back to the
            # default range splits would report results under a DIFFERENT
            # labelled/unlabelled class partition while claiming SSB
            raise FileNotFoundError(
                f"use_ssb_splits=True but {path} is missing; provide the "
                "SSB pickle or set use_ssb_splits=False explicitly")
        with open(path, "rb") as f:
            info = pickle.load(f)
        train = info["known_classes"]
        osc = info["unknown_classes"]
        return train, list(osc["Hard"]) + list(osc["Medium"]) + list(osc["Easy"])
    if name == "herbarium_19":
        path = os.path.join(ssb_dir, "herbarium_19_class_splits.pkl")
        with open(path, "rb") as f:
            info = pickle.load(f)
        return info["Old"], info["New"]
    if name not in _DEFAULT_SPLITS:
        raise NotImplementedError(f"no class splits for {name!r}")
    return _DEFAULT_SPLITS[name]


def get_datasets(cfg: DataConfig, train_transform=None, test_transform=None,
                 train_classes: Optional[Sequence[int]] = None,
                 unlabeled_classes: Optional[Sequence[int]] = None
                 ) -> Tuple[MergedDataset, object, object, Dict]:
    """Returns (train MergedDataset, test, unlabelled_train_test, extras) —
    the reference's ``get_datasets`` contract (``get_datasets.py:53-98``)."""
    name = cfg.dataset_name
    if name not in _READERS:
        raise ValueError(f"unknown dataset {name!r}")
    if train_classes is None or unlabeled_classes is None:
        train_classes, unlabeled_classes = get_class_splits(cfg)

    whole_train, test, extra = _READERS[name](cfg)
    whole_train = whole_train.with_transform(train_transform)
    test = test.with_transform(test_transform)

    splits: GCDSplits = build_gcd_splits(
        whole_train, test, train_classes, cfg.prop_train_labels,
        test_transform=test_transform)

    tt = make_target_transform(train_classes, unlabeled_classes)
    for table in (splits.train_labelled, splits.train_unlabelled, splits.test,
                  splits.train_unlabelled_test):
        table.target_transform = tt

    train_merged = MergedDataset(splits.train_labelled, splits.train_unlabelled)
    extras = dict(extra)
    extras.update({
        "splits": splits,
        "train_classes": list(train_classes),
        "unlabeled_classes": list(unlabeled_classes),
    })
    return train_merged, splits.test, splits.train_unlabelled_test, extras
