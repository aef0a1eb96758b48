"""Dataset core: a generic record table + the GCD split algebra.

The reference implements the same split recipe eight times, once per dataset
(``gcd/data/{cub,cifar,imagenet,...}.py``): take the whole training set with
``uq_idxs``, class-subsample the labelled classes, instance-subsample a
labelled fraction with a seeded draw, and define the unlabelled set as the
complement.  Here the recipe exists once over an ``ImageTable`` abstraction;
dataset readers (``scd_tpu_torch.data.datasets``) only produce tables.

RNG parity matters (SURVEY §7 hard-part 3): split membership must reproduce
the reference masks exactly, so ``subsample_instances`` re-seeds the legacy
numpy generator with 0 and draws ``np.random.choice`` identically
(reference ``data_utils.py:4-10``), and ImageNet-100's 100-class choice uses
the same seed-0 draw (``imagenet.py:280-282``).

The ``MergedDataset`` view reproduces the 4-tuple contract every pipeline
consumes: ``(image, label, uq_idx, labeled_or_not)`` with all labelled
instances first (``data_utils.py:12-37``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class ImageTable:
    """A dataset as a table of records.

    ``source``: per-record locator (file path, or an index into ``arrays``
    for in-memory datasets like CIFAR).  ``load(source) -> PIL.Image`` is the
    record loader.  ``targets`` are integer class ids; ``uq_idxs`` are the
    stable unique ids the split algebra operates on.
    """

    source: np.ndarray  # [N] object/str/int
    targets: np.ndarray  # [N] int64
    uq_idxs: np.ndarray  # [N] int64
    classnames: List[str]
    load: Callable[[Any], Any]
    transform: Optional[Callable] = None
    target_transform: Optional[Callable[[int], int]] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.targets)

    def __getitem__(self, idx: int):
        img = self.load(self.source[idx])
        if self.transform is not None:
            img = self.transform(img)
        target = int(self.targets[idx])
        if self.target_transform is not None:
            target = self.target_transform(target)
        return img, target, int(self.uq_idxs[idx])

    def select(self, idxs: Sequence[int]) -> "ImageTable":
        idxs = np.asarray(idxs, dtype=np.int64)
        return dataclasses.replace(self, source=self.source[idxs],
                                   targets=self.targets[idxs],
                                   uq_idxs=self.uq_idxs[idxs])

    def select_mask(self, mask: np.ndarray) -> "ImageTable":
        return self.select(np.nonzero(mask)[0])

    def subsample_classes(self, include_classes: Sequence[int]) -> "ImageTable":
        keep = np.isin(self.targets, np.asarray(list(include_classes)))
        return self.select_mask(keep)

    def with_transform(self, transform) -> "ImageTable":
        return dataclasses.replace(self, transform=transform)

    def remap_targets(self, mapping: Dict[int, int],
                      classnames: Optional[List[str]] = None) -> "ImageTable":
        new_targets = np.array([mapping[int(t)] for t in self.targets],
                               dtype=np.int64)
        return dataclasses.replace(self, targets=new_targets,
                                   classnames=classnames or self.classnames)


def subsample_instances(n: int, prop: float, seed: int = 0) -> np.ndarray:
    """Seeded instance subsample, bit-identical to the reference
    (``data_utils.py:4-10``): legacy global numpy RNG, seed 0."""
    np.random.seed(seed)
    return np.random.choice(range(n), replace=False, size=(int(prop * n),))


@dataclasses.dataclass
class GCDSplits:
    train_labelled: ImageTable
    train_unlabelled: ImageTable  # train transform (lives inside MergedDataset)
    test: ImageTable
    val: Optional[ImageTable] = None
    # test-transform copy of train_unlabelled (the reference's
    # ``unlabelled_train_examples_test``, ``get_datasets.py:84-90``)
    train_unlabelled_test: Optional[ImageTable] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


def build_gcd_splits(whole_train: ImageTable, test: ImageTable,
                     train_classes: Sequence[int], prop_train_labels: float,
                     test_transform=None) -> GCDSplits:
    """The shared split recipe (e.g. reference ``get_cub_datasets``,
    ``cub.py:151-189``)."""
    labelled = whole_train.subsample_classes(train_classes)
    keep = subsample_instances(len(labelled), prop_train_labels)
    labelled = labelled.select(keep)

    # vectorized complement: python set algebra + a per-element dict walk
    # costs seconds of host time at ImageNet-1k scale (1.28M rows)
    unlabelled = whole_train.select(
        np.flatnonzero(~np.isin(whole_train.uq_idxs, labelled.uq_idxs)))

    unlabelled_test = unlabelled
    if test_transform is not None:
        # the merged train set keeps the TRAIN transform on its unlabelled
        # part; only the separate eval copy gets the test transform
        # (reference ``get_datasets.py:53-98``)
        unlabelled_test = unlabelled.with_transform(test_transform)
        test = test.with_transform(test_transform)
    return GCDSplits(train_labelled=labelled, train_unlabelled=unlabelled,
                     test=test, train_unlabelled_test=unlabelled_test)


class MergedDataset:
    """Labelled-first concatenation yielding the 4-tuple contract
    ``(img, label, uq_idx, [labeled_or_not])`` (``data_utils.py:12-37``)."""

    def __init__(self, labelled: ImageTable, unlabelled: ImageTable):
        self.labelled_dataset = labelled
        self.unlabelled_dataset = unlabelled

    def __len__(self) -> int:
        return len(self.labelled_dataset) + len(self.unlabelled_dataset)

    def __getitem__(self, item: int):
        n_l = len(self.labelled_dataset)
        if item < n_l:
            img, label, uq = self.labelled_dataset[item]
            lab = 1
        else:
            img, label, uq = self.unlabelled_dataset[item - n_l]
            lab = 0
        return img, label, uq, np.array([lab])

    @property
    def mask_lab(self) -> np.ndarray:
        return np.concatenate([
            np.ones(len(self.labelled_dataset), bool),
            np.zeros(len(self.unlabelled_dataset), bool),
        ])

    @property
    def targets(self) -> np.ndarray:
        def resolved(t: ImageTable) -> np.ndarray:
            if t.target_transform is None:
                return t.targets
            return np.array([t.target_transform(int(x)) for x in t.targets])

        return np.concatenate([resolved(self.labelled_dataset),
                               resolved(self.unlabelled_dataset)])


def make_target_transform(train_classes: Sequence[int],
                          unlabeled_classes: Sequence[int]) -> Callable[[int], int]:
    """Class-id remap: labelled classes first, then unlabelled (reference
    ``get_datasets.py:73-82``)."""
    mapping = {cls: i for i, cls in
               enumerate(list(train_classes) + list(unlabeled_classes))}
    return lambda x: mapping[x]
