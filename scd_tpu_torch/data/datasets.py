"""Dataset readers: each produces ``ImageTable``s from the standard on-disk
formats (reference ``gcd/data/*.py``); the split algebra lives once in
``scd_tpu_torch.data.core``.

Port of the ``synthetic``, ``imagefolder``, ``imagenet_100`` and
``imagenet_1000`` readers of ``scd_tpu/data/datasets.py``; the other
readers come later (ROADMAP "Remaining data").  Readers return
``(whole_train, test, extra)``.  All filesystem roots come from config.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from scd_tpu_torch.data.core import ImageTable

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


def _pil_loader(path: str):
    with open(path, "rb") as f:
        img = Image.open(f)
        return img.convert("RGB")


# ------------------------------------------------------------------ synthetic

def make_synthetic(n_classes: int = 10, per_class: int = 25,
                   image_size: int = 32, seed: int = 0,
                   class_names: List[str] = None
                   ) -> Tuple[ImageTable, ImageTable, Dict]:
    """Deterministic colored-noise classes; each class has a distinct mean
    color so even tiny encoders separate them."""
    rng = np.random.default_rng(seed)
    means = rng.random((n_classes, 3)).astype(np.float32)
    names = class_names or [f"class_{i}" for i in range(n_classes)]

    def build(split_seed: int, per: int):
        r = np.random.default_rng(split_seed)
        imgs, targets = [], []
        for c in range(n_classes):
            base = means[c][None, None, None]
            x = np.clip(base + 0.08 * r.standard_normal(
                (per, image_size, image_size, 3)), 0, 1).astype(np.float32)
            imgs.append(x)
            targets.extend([c] * per)
        imgs = np.concatenate(imgs)
        targets = np.array(targets, np.int64)
        return imgs, targets

    train_imgs, train_targets = build(seed + 1, per_class)
    test_imgs, test_targets = build(seed + 2, max(per_class // 4, 2))

    def table(imgs, targets):
        return ImageTable(
            source=np.arange(len(targets)),
            targets=targets,
            uq_idxs=np.arange(len(targets)),
            classnames=names,
            load=lambda i, _imgs=imgs: _imgs[int(i)],
        )

    return table(train_imgs, train_targets), table(test_imgs, test_targets), {
        "class_names": names,
        "class_colors": {n: means[i] for i, n in enumerate(names)}}


# ---------------------------------------------------------------- imagefolder

# torchvision IMG_EXTENSIONS exactly (it excludes .gif; a wider list would
# yield extra samples and shift uq_idxs/class counts vs the reference's
# ImageFolder scan).
IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm", ".pgm", ".tif",
                  ".tiff", ".webp")


def scan_imagefolder(root: str) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """<root>/<class_dir>/<image> layout -> (paths, targets, classnames),
    classes sorted by directory name (torchvision ImageFolder convention,
    which the reference's wnid mapping relies on, ``main_unsup.py:423-426``)."""
    classes = sorted(e.name for e in os.scandir(root) if e.is_dir())
    paths, targets = [], []
    exts = IMG_EXTENSIONS
    for i, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            if fname.lower().endswith(exts):
                paths.append(os.path.join(cdir, fname))
                targets.append(i)
    return (np.array(paths, object), np.array(targets, np.int64), classes)


def make_imagefolder(train_root: str, test_root: str
                     ) -> Tuple[ImageTable, ImageTable, Dict]:
    tr_paths, tr_targets, classes = scan_imagefolder(train_root)
    te_paths, te_targets, te_classes = scan_imagefolder(test_root)
    # test targets must live in the TRAIN class-id space: val/ dirs can be
    # a subset/superset of train/'s, and positional ids would silently
    # misalign every test label
    if te_classes != classes:
        cls_to_idx = {c: i for i, c in enumerate(classes)}
        keep = np.array([te_classes[t] in cls_to_idx for t in te_targets],
                        bool)
        te_paths = te_paths[keep]
        te_targets = np.array([cls_to_idx[te_classes[t]]
                               for t in te_targets[keep]], np.int64)

    def table(paths, targets):
        return ImageTable(source=paths, targets=targets,
                          uq_idxs=np.arange(len(targets)),
                          classnames=classes, load=_pil_loader)

    return table(tr_paths, tr_targets), table(te_paths, te_targets), {
        "classes": classes}


# ------------------------------------------------------------------- imagenet

def make_imagenet_100(root: str) -> Tuple[ImageTable, ImageTable, Dict]:
    """Seed-0 100-class subsample of ImageNet-1k (reference
    ``imagenet.py:275-333``): the class choice and the idx1000->idx100
    ``class_map`` must reproduce the reference draw exactly."""
    # RandomState(0) draws the identical legacy sequence as the
    # reference's np.random.seed(0) WITHOUT reseeding the caller's global
    # NumPy RNG as a side effect
    chosen = np.sort(np.random.RandomState(0).choice(
        range(1000), size=(100,), replace=False))
    cls_map = {int(i): j for j, i in enumerate(chosen)}

    whole, test, extra = make_imagefolder(os.path.join(root, "train"),
                                          os.path.join(root, "val"))
    keep = np.isin(whole.targets, chosen)
    whole = whole.select_mask(keep).remap_targets(cls_map)
    whole.uq_idxs = np.arange(len(whole))
    tkeep = np.isin(test.targets, chosen)
    test = test.select_mask(tkeep).remap_targets(cls_map)
    test.uq_idxs = np.arange(len(test))
    extra["class_map"] = cls_map  # idx1000 -> idx100 (reference layout)
    return whole, test, extra


def make_imagenet_1000(root: str) -> Tuple[ImageTable, ImageTable, Dict]:
    return make_imagefolder(os.path.join(root, "train"),
                            os.path.join(root, "val"))
