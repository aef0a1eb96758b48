"""Dataset readers: each produces ``ImageTable``s from the standard on-disk
formats (reference ``gcd/data/*.py``); the split algebra lives once in
``scd_tpu_torch.data.core``.

Port of every reader of ``scd_tpu/data/datasets.py``.  Readers return
``(whole_train, test, extra)``.  All filesystem roots come from config.
The readers list paths and never open an image: ``ImageTable.load`` does
that when a row is read.
"""

from __future__ import annotations

import os
import pickle
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


def make_imagenet_127(root: str) -> Tuple[ImageTable, ImageTable, Dict]:
    """ImageNet-127 (reference ``imagenet.py:395-453``): a 127-class
    ImageFolder tree whose ``val`` split serves as BOTH the training pool
    and the test set.  The reference "subsamples" all 127 of 127 classes
    with seed 0 (``np.random.choice(range(127), size=127, replace=False)``
    then sorted — an identity permutation, quirk preserved here) so
    ``class_map`` is the identity and targets keep folder order."""
    chosen = np.sort(np.random.RandomState(0).choice(
        range(127), size=(127,), replace=False))  # no global-RNG side effect
    cls_map = {int(i): j for j, i in enumerate(chosen)}

    val_root = os.path.join(root, "val")
    paths, targets, classes = scan_imagefolder(val_root)

    def table():
        t = ImageTable(source=paths.copy(), targets=targets.copy(),
                       uq_idxs=np.arange(len(targets)),
                       classnames=classes, load=_pil_loader)
        keep = np.isin(t.targets, chosen)
        t = t.select_mask(keep).remap_targets(cls_map)
        t.uq_idxs = np.arange(len(t))
        return t

    return table(), table(), {"classes": classes, "class_map": cls_map}


# ------------------------------------------------------------------------ cub

def make_cub(root: str) -> Tuple[ImageTable, ImageTable, Dict]:
    """CUB-200-2011 metadata txts (reference ``cub.py:15-100``)."""
    base = os.path.join(root, "CUB_200_2011")

    def read_pairs(fname):
        out = {}
        with open(os.path.join(base, fname)) as f:
            for line in f:
                k, v = line.split()
                out[int(k)] = v
        return out

    images = read_pairs("images.txt")
    labels = {k: int(v) for k, v in read_pairs("image_class_labels.txt").items()}
    split = {k: int(v) for k, v in read_pairs("train_test_split.txt").items()}
    classnames = [line.split()[1]
                  for line in open(os.path.join(base, "classes.txt"))]

    img_dir = os.path.join(base, "images")
    ids = sorted(images)

    def table(want_train: bool):
        sel = [i for i in ids if bool(split[i]) == want_train]
        paths = np.array([os.path.join(img_dir, images[i]) for i in sel], object)
        targets = np.array([labels[i] - 1 for i in sel], np.int64)  # 1-based
        return ImageTable(source=paths, targets=targets,
                          uq_idxs=np.arange(len(sel)),
                          classnames=classnames, load=_pil_loader)

    return table(True), table(False), {"classnames": classnames}


# -------------------------------------------------------------- stanford dogs

def make_sdogs(root: str) -> Tuple[ImageTable, ImageTable, Dict]:
    """Stanford Dogs .mat split lists (reference ``stanford_dogs.py``)."""
    from scipy.io import loadmat

    base = os.path.join(root, "StanfordDogs")
    img_dir = os.path.join(base, "Images")
    breeds = sorted(e.name for e in os.scandir(img_dir) if e.is_dir())

    def table(mat_name: str):
        mat = loadmat(os.path.join(base, mat_name))
        files = [str(f[0][0]) for f in mat["file_list"]]
        targets = mat["labels"].ravel().astype(np.int64) - 1
        paths = np.array([os.path.join(img_dir, f) for f in files], object)
        return ImageTable(source=paths, targets=targets,
                          uq_idxs=np.arange(len(files)),
                          classnames=breeds, load=_pil_loader,
                          meta={"breeds": breeds})

    return table("train_list.mat"), table("test_list.mat"), {"breeds": breeds}


# ---------------------------------------------------------------------- cifar

def _load_cifar_batches(root: str, files: List[str], labels_key: str):
    imgs, targets = [], []
    for fname in files:
        with open(os.path.join(root, fname), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1))
        targets.extend(d[labels_key.encode()])
    return np.concatenate(imgs), np.array(targets, np.int64)


def make_cifar(root: str, which: int = 10) -> Tuple[ImageTable, ImageTable, Dict]:
    if which == 10:
        base = os.path.join(root, "cifar-10-batches-py")
        train_files = [f"data_batch_{i}" for i in range(1, 6)]
        test_files = ["test_batch"]
        labels_key = "labels"
        with open(os.path.join(base, "batches.meta"), "rb") as f:
            names = [n.decode() for n in
                     pickle.load(f, encoding="bytes")[b"label_names"]]
    else:
        base = os.path.join(root, "cifar-100-python")
        train_files, test_files = ["train"], ["test"]
        labels_key = "fine_labels"
        with open(os.path.join(base, "meta"), "rb") as f:
            names = [n.decode() for n in
                     pickle.load(f, encoding="bytes")[b"fine_label_names"]]

    tr_imgs, tr_targets = _load_cifar_batches(base, train_files, labels_key)
    te_imgs, te_targets = _load_cifar_batches(base, test_files, labels_key)

    def table(imgs, targets):
        return ImageTable(
            source=np.arange(len(targets)),
            targets=targets,
            uq_idxs=np.arange(len(targets)),
            classnames=names,
            load=lambda i, _im=imgs: Image.fromarray(_im[int(i)]),
        )

    return table(tr_imgs, tr_targets), table(te_imgs, te_targets), {
        "class_to_idx": {n: i for i, n in enumerate(names)}}


# ------------------------------------------------------------------- aircraft

def make_aircraft(root: str) -> Tuple[ImageTable, ImageTable, Dict]:
    """FGVC-Aircraft variant annotations (reference ``fgvc_aircraft.py``)."""
    base = os.path.join(root, "fgvc-aircraft-2013b", "data")
    with open(os.path.join(base, "variants.txt")) as f:
        variants = [line.strip() for line in f if line.strip()]
    v_to_i = {v: i for i, v in enumerate(variants)}

    def table(split: str):
        paths, targets = [], []
        with open(os.path.join(base, f"images_variant_{split}.txt")) as f:
            for line in f:
                img_id, variant = line.strip().split(" ", 1)
                paths.append(os.path.join(base, "images", img_id + ".jpg"))
                targets.append(v_to_i[variant])
        return ImageTable(source=np.array(paths, object),
                          targets=np.array(targets, np.int64),
                          uq_idxs=np.arange(len(paths)),
                          classnames=variants, load=_pil_loader)

    return table("trainval"), table("test"), {
        "class_to_idx": v_to_i}


# -------------------------------------------------------------- stanford cars

def make_scars(root: str) -> Tuple[ImageTable, ImageTable, Dict]:
    """Stanford Cars .mat annotations (reference ``stanford_cars.py``)."""
    from scipy.io import loadmat

    meta = loadmat(os.path.join(root, "devkit", "cars_meta.mat"))
    names = [str(c[0]) for c in meta["class_names"][0]]

    def table(anno_file: str, img_root: str):
        annos = loadmat(os.path.join(root, anno_file))["annotations"][0]
        paths, targets = [], []
        for a in annos:
            fname = str(a["fname"][0]) if "fname" in a.dtype.names else \
                str(a["relative_im_path"][0])
            cls = int(a["class"][0][0]) - 1
            paths.append(os.path.join(root, img_root, fname))
            targets.append(cls)
        return ImageTable(source=np.array(paths, object),
                          targets=np.array(targets, np.int64),
                          uq_idxs=np.arange(len(paths)),
                          classnames=names, load=_pil_loader)

    return (table(os.path.join("devkit", "cars_train_annos.mat"), "cars_train"),
            table(os.path.join("devkit", "cars_test_annos_withlabels.mat"),
                  "cars_test"),
            {"classnames": names})


# ------------------------------------------------------------------ herbarium

def make_herbarium(root: str) -> Tuple[ImageTable, ImageTable, Dict]:
    """Herbarium-19 (reference ``herbarium_19.py``): train/validation
    imagefolder layout with numeric class dirs."""
    whole, test, extra = make_imagefolder(os.path.join(root, "small-train"),
                                          os.path.join(root, "small-validation"))
    return whole, test, extra
