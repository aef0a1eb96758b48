"""Fabricate artifact roots for the port's paths: ImageNet-100, CUB and
Stanford Dogs.

Everything ``run_unsup`` reads, made from a seed, at any size.

Warm root (:func:`fabricate_imagenet100`, the ImageNet-100 deployment of
``bench.py::bench_e2e``: N = 130,048 images, 768-d clustering and 512-d
CLIP features, V = 68,000 nouns, K = 100, or a tiny one for tests):

- ``wordnet/``: a WNDB taxonomy (``data.noun``, ``index.noun``) whose
  first lemmas are the V vocabulary names: ``entity`` -> genera -> leaves;
  1000 of the leaves are the ImageNet-1k class synsets;
- ``data/wordnet_all_noun.txt``: the vocabulary, one name per line;
- ``ILSVRC12/{train,val}/<wnid>/``: the 1000 class dirs; the 100 classes of
  the seed-0 ImageNet-100 draw hold N ``.jpg`` files (empty, or real
  JPEGs when ``jpeg_size`` is given), split so the 50/50 class split
  labels exactly half of the Old classes' rows;
- the features caches (written through the port's ``ArtifactCache`` under
  the port's keys, which equal the JAX package's): class-structured,
  L2-normalized clustering and CLIP features whose ``targets`` and
  ``mask_lab`` are the dataset's own, modelled on ``bench.py:934-966``;
- ``zeroshot_weights.npz``: a [D_clip, V] matrix of random unit columns in
  which each class name's column carries its class signature.

CUB and Stanford Dogs warm roots (:func:`fabricate_fine_grained`, the
deployments of ``BASELINE.json`` configs 1, 2 and 4): each dataset's
metadata at its published split sizes (CUB 200 classes, 5,994 / 5,794
images, with an SSB split pickle; Dogs 120 breeds, 12,000 / 8,580), a
taxonomy whose leaves include every class name, and the same caches.

Cold root (:func:`fabricate_cold_root`): the same tree and taxonomy, no
caches, and the assets the encoders need instead: an OpenAI-layout CLIP
state dict and a DINO-layout ViT state dict (random weights at any width
and depth, :func:`clip_state_dict`, :func:`dino_state_dict`; a
torchvision-layout ResNet-50, :func:`resnet50_state_dict`) and a CLIP
BPE merges file (:func:`write_bpe_merges`).  With empty ``.jpg`` files,
:func:`fabricated_images` supplies each image from ``(seed, path)`` at
load time, already at the size ``clip_preprocess`` emits, so no decoder is
needed.

Features are drawn on ``device`` from a ``torch.Generator``.  The WNDB
writer is a parametrised copy of ``tests/wndb_fabricate.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import math
import os
import zlib
from typing import Dict, List, Sequence

import numpy as np
import torch

from scd_tpu_torch.core.cache import ArtifactCache
from scd_tpu_torch.core.config import (ClusterConfig, DataConfig,
                                       FeatureConfig, NamingConfig,
                                       PipelineConfig)

_HEADER = (
    "  1 This is a fabricated miniature WordNet 3.0 Copyright notice line\n"
    "  2 for test fixtures only; real WNDB headers carry the license.\n")


def build_wndb(out_dir: str, tree: Dict[str, Sequence[str]],
               lemmas: Dict[str, Sequence[str]] = None) -> Dict[str, int]:
    """Write a WNDB corpus (``wndb(5WN)`` layout: a ``data.noun`` line's
    offset is its byte position) into ``out_dir``.  ``tree``: synset id ->
    child synset ids, every synset a key, one root.  ``lemmas``: synset id
    -> words (default [synset id]).  Returns synset id -> byte offset (the
    wnid is ``n%08d % offset``)."""
    os.makedirs(out_dir, exist_ok=True)
    lemmas = lemmas or {}
    sids = list(tree.keys())
    parents: Dict[str, List[str]] = {s: [] for s in sids}
    for s, kids in tree.items():
        for kid in kids:
            parents[kid].append(s)

    def words(sid: str) -> List[str]:
        return list(lemmas.get(sid, [sid]))

    def line_for(sid: str, offsets: Dict[str, int]) -> str:
        ws = words(sid)
        ptrs = ([("@", p) for p in parents[sid]]
                + [("~", c) for c in tree[sid]])
        parts = [f"{offsets[sid]:08d}", "03", "n", f"{len(ws):02x}"]
        for w in ws:
            parts += [w, "0"]
        parts.append(f"{len(ptrs):03d}")
        for sym, tgt in ptrs:
            parts += [sym, f"{offsets[tgt]:08d}", "n", "0000"]
        return " ".join(parts) + f" | fabricated gloss for {sid}  \n"

    # two passes: dummy offsets fix the line lengths, then real positions
    dummy = {s: 0 for s in sids}
    offsets: Dict[str, int] = {}
    pos = len(_HEADER.encode())
    for s in sids:
        offsets[s] = pos
        pos += len(line_for(s, dummy).encode())
    with open(os.path.join(out_dir, "data.noun"), "w") as f:
        f.write(_HEADER)
        for s in sids:
            f.write(line_for(s, offsets))

    lemma_to_offsets: Dict[str, List[int]] = {}
    for s in sids:
        for w in words(s):
            lemma_to_offsets.setdefault(w.lower(), []).append(offsets[s])
    with open(os.path.join(out_dir, "index.noun"), "w") as f:
        f.write(_HEADER)
        for lemma in sorted(lemma_to_offsets):
            offs = lemma_to_offsets[lemma]
            f.write(f"{lemma} n {len(offs)} 1 @ {len(offs)} 0 "
                    + " ".join(f"{o:08d}" for o in offs) + "  \n")
    return offsets


def imagenet100_config(root: str, n_clusters: int = 100, n_init: int = 10,
                       max_iterations: int = 10,
                       algorithm: str = "SSKM") -> PipelineConfig:
    """The pipeline config of a fabricated root: ImageNet-100, DINO
    clustering features, WordNet corpus, the reference's SSKM settings."""
    return PipelineConfig(
        data=DataConfig(dataset_name="imagenet_100", root_dir=root,
                        corpus_dir=os.path.join(root, "data"),
                        wordnet_db_dir=os.path.join(root, "wordnet"),
                        zeroshot_weights=os.path.join(
                            root, "zeroshot_weights.npz"),
                        cache_dir=os.path.join(root, "cache")),
        feature=FeatureConfig(feat_model="dino_vit"),
        cluster=ClusterConfig(algorithm=algorithm, n_clusters=n_clusters,
                              n_init=n_init, max_iterations=max_iterations),
        naming=NamingConfig(corpus="wordnet", topk=5, num_common_vote=20,
                            num_common_linear=4),
        run_cluster=True)


def _unit_rows(t: torch.Tensor) -> torch.Tensor:
    return t / t.norm(dim=1, keepdim=True).clamp_min(1e-12)


def fabricate_imagenet_tree(cfg: PipelineConfig, n_images: int,
                            vocab: int, n_genus: int,
                            jpeg_size: int = 0, seed: int = 0) -> Dict:
    """Write the taxonomy, the vocabulary and the ImageNet tree of a root
    (see the module docstring).  ``jpeg_size`` > 0 writes real JPEGs of
    that size (random colours from ``seed``; needs PIL) instead of empty
    files.  Returns nouns, the GT name and vocabulary column of each
    class."""
    root = cfg.data.root_dir
    n_leaves = vocab - 1 - n_genus
    if n_leaves < 1000:
        raise ValueError(f"vocab={vocab} leaves room for {n_leaves} < 1000 "
                         "ImageNet class leaves")

    # ---- taxonomy and vocabulary
    tree: Dict[str, List[str]] = {"entity": []}
    leaves: List[str] = []
    per = -(-n_leaves // n_genus)
    for g in range(n_genus):
        genus = f"genus_{g:03d}"
        tree["entity"].append(genus)
        tree[genus] = []
        for i in range(g * per, min((g + 1) * per, n_leaves)):
            leaf = f"noun_{i:05d}"
            tree[genus].append(leaf)
            tree[leaf] = []
            leaves.append(leaf)
    offsets = build_wndb(cfg.data.wordnet_db_dir, tree)
    nouns = list(tree.keys())  # synset order; every name once
    os.makedirs(cfg.data.corpus_dir, exist_ok=True)
    with open(os.path.join(cfg.data.corpus_dir, "wordnet_all_noun.txt"),
              "w") as f:
        f.write("\n".join(nouns) + "\n")

    # ---- ImageNet-1k tree: 1000 class leaves spread over the taxonomy
    class_leaves = [leaves[i] for i in
                    np.linspace(0, n_leaves - 1, 1000).round().astype(int)]
    wnids = sorted(f"n{offsets[s]:08d}" for s in class_leaves)
    wnid_to_leaf = {f"n{offsets[s]:08d}": s for s in class_leaves}
    chosen = np.sort(np.random.RandomState(0).choice(
        range(1000), size=(100,), replace=False))  # make_imagenet_100's draw
    base, rem = divmod(n_images, 100)
    for split in ("train", "val"):
        for w in wnids:
            os.makedirs(os.path.join(root, "ILSVRC12", split, w),
                        exist_ok=True)
    for j, i1000 in enumerate(chosen):
        # +1 for the first rem//2 classes of each half: the Old half then
        # holds an even row count and the 0.5 label draw is exact
        count = base + int(j % 50 < rem // 2) + int(j == 0 and rem % 2)
        tdir = os.path.join(root, "ILSVRC12", "train", wnids[i1000])
        for t in range(count):
            _write_image(os.path.join(tdir, f"{t:05d}.jpg"), jpeg_size, seed)
        _write_image(os.path.join(root, "ILSVRC12", "val", wnids[i1000],
                                  "v.jpg"), jpeg_size, seed)
    class_names = [wnid_to_leaf[wnids[i]] for i in chosen]  # by idx100
    noun_col = {n: c for c, n in enumerate(nouns)}
    gt_cols = [noun_col[n] for n in class_names]
    return {"nouns": nouns, "class_names": class_names, "gt_cols": gt_cols}


def _write_image(path: str, jpeg_size: int, seed: int) -> None:
    if not jpeg_size:
        open(path, "w").close()
        return
    from PIL import Image

    Image.fromarray(fabricated_image(path, seed, jpeg_size)).save(
        path, quality=90)


def fabricated_image(path: str, seed: int, size: int = 224) -> np.ndarray:
    """A uint8 [size, size, 3] image made from ``(seed, path)``: a colour
    of the image's class directory plus noise of its own."""
    cls = os.path.basename(os.path.dirname(path))
    name = f"{cls}/{os.path.basename(path)}"
    base = np.random.default_rng([seed, zlib.crc32(cls.encode())]).integers(
        32, 224, 3)
    noise = np.random.default_rng([seed, zlib.crc32(name.encode())]
                                  ).integers(-12, 13, (size, size, 3))
    return (base + noise).astype(np.uint8)


@contextlib.contextmanager
def fabricated_images(seed: int, size: int = 224):
    """Within the block, the image readers load :func:`fabricated_image`
    for each path instead of decoding the file (the ``ImageTable.load``
    of the imagefolder readers)."""
    from scd_tpu_torch.data import datasets

    real = datasets._pil_loader
    datasets._pil_loader = lambda path: fabricated_image(path, seed, size)
    try:
        yield
    finally:
        datasets._pil_loader = real


def fabricate_imagenet100(cfg: PipelineConfig, seed: int = 0,
                          device="cpu", n_images: int = 130_048,
                          d_feat: int = 768, d_clip: int = 512,
                          vocab: int = 68_000, n_genus: int = 99) -> Dict:
    """Write the warm root that ``cfg`` (see :func:`imagenet100_config`)
    points at.  Returns what was written: nouns, the GT name of each class,
    and the vocabulary column of each class."""
    info = fabricate_imagenet_tree(cfg, n_images, vocab, n_genus)
    return _write_warm_caches(cfg, info, seed, device, d_feat, d_clip)


def _write_warm_caches(cfg: PipelineConfig, info: Dict, seed: int, device,
                       d_feat: int, d_clip: int) -> Dict:
    """The caches a warm run re-enters, for the dataset ``cfg`` names:
    class-structured, L2-normalised clustering and CLIP features in the
    dataset's own row order, with its ``targets`` (remapped: Old classes
    first) and ``mask_lab``, and a zero-shot matrix [D_clip, V] of random
    unit columns in which each class name's column carries its class
    signature.  ``info["gt_cols"]`` is the vocabulary column of each class
    by the dataset's original class id."""
    from scd_tpu_torch.data import get_datasets
    from scd_tpu_torch.data.core import make_target_transform
    from scd_tpu_torch.pipelines.common import feature_cache_key, stage_cache

    nouns, gt_cols = info["nouns"], info["gt_cols"]
    vocab, n_cls = len(nouns), len(gt_cols)

    # ---- the dataset's own targets and labelled mask
    train, _test, _unlab, extras = get_datasets(cfg.data)
    targets_np = train.targets.astype(np.int64)
    mask_lab = train.mask_lab
    mask_cls = targets_np < len(extras["train_classes"])  # remapped: Old first
    tt = make_target_transform(extras["train_classes"],
                               extras["unlabeled_classes"])
    remapped_cols = [0] * n_cls
    for c, col in enumerate(gt_cols):
        remapped_cols[tt(c)] = col

    # ---- class-structured features and vocabulary, on the device
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    targets = torch.as_tensor(targets_np, device=dev)
    n = len(targets_np)
    feat_c = 3.0 * torch.randn(n_cls, d_feat, generator=g, device=dev)
    clip_c = _unit_rows(torch.randn(n_cls, d_clip, generator=g, device=dev))
    feats = _unit_rows(feat_c[targets] + 0.5 * torch.randn(
        n, d_feat, generator=g, device=dev))
    clip = _unit_rows(clip_c[targets] + 0.1 * torch.randn(
        n, d_clip, generator=g, device=dev))
    zw = _unit_rows(torch.randn(vocab, d_clip, generator=g, device=dev))
    zw[torch.as_tensor(remapped_cols, device=dev)] = clip_c
    zw = zw.t().contiguous()  # [D, V]

    meta = {"targets": targets_np.astype(np.float64), "mask_lab": mask_lab,
            "mask_cls": mask_cls}
    cache: ArtifactCache = stage_cache(cfg)
    cache.save("features", feature_cache_key(cfg, "feat"),
               {"all_feats": feats.cpu().numpy(), **meta},
               meta={"fabricated": seed})
    cache.save("features", feature_cache_key(cfg, "clip"),
               {"all_feats": clip.cpu().numpy(), **meta},
               meta={"fabricated": seed})
    np.savez(cfg.data.zeroshot_weights, weights=zw.cpu().numpy())
    return {"nouns": nouns, "class_names": info["class_names"],
            "gt_cols": gt_cols, "n_images": n,
            "n_labelled": int(mask_lab.sum())}


def subclustered_blobs(n: int, d: int, classes: int, seed: int = 0,
                       per_class: int = 5):
    """(x [n, d] f32, targets [n], mask_lab [n]) of ``classes`` classes,
    each ``per_class`` tight sub-blobs (spread 0.01) around its class
    mean; the first half of the classes labelled on half their rows.  At
    any K up to ``classes * per_class`` k-means keeps whole sub-blobs
    together, so no row lies near a tie between two centers and a Lloyd
    loop on the card (split-bf16 products) and on the CPU (f32) give the
    same labels from the same initial centers."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((classes, d))
    subs = (np.repeat(means, per_class, axis=0)
            + 0.3 * rng.standard_normal((classes * per_class, d)))
    sub = rng.integers(0, classes * per_class, n)
    x = (subs[sub] + 0.01 * rng.standard_normal((n, d))).astype(np.float32)
    y = sub // per_class
    return x, y, (y < classes // 2) & (rng.random(n) < 0.5)


# ------------------------------------------------- CUB and Stanford Dogs

# the published split sizes: CUB-200-2011 (train_test_split.txt) and
# Stanford Dogs (train_list.mat / test_list.mat)
CUB_CLASSES, CUB_TRAIN, CUB_TEST = 200, 5_994, 5_794
SDOGS_CLASSES, SDOGS_TRAIN, SDOGS_TEST = 120, 12_000, 8_580


def warm_config(root: str, dataset_name: str, n_clusters: int,
                n_init: int = 10, max_iterations: int = 10,
                textual_enhancement: bool = False,
                partially_supervised: bool = False) -> PipelineConfig:
    """The pipeline config of a fabricated CUB or Stanford Dogs root:
    DINO clustering features, the WordNet corpus, SSKM and the reference's
    naming settings, as :func:`imagenet100_config`."""
    cfg = imagenet100_config(root, n_clusters=n_clusters, n_init=n_init,
                             max_iterations=max_iterations)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, dataset_name=dataset_name),
        naming=dataclasses.replace(
            cfg.naming, textual_enhancement=textual_enhancement),
        partially_supervised=partially_supervised)


def _write_vocabulary(cfg: PipelineConfig, class_names: Sequence[str],
                      vocab: int, n_genus: int) -> Dict:
    """A WNDB taxonomy ``entity`` -> genera -> leaves and its vocabulary
    file, V names in all; the class names are leaves spread over the
    genera, the other leaves ``noun_NNNNN``.  Returns the nouns and each
    class name's vocabulary column."""
    n_leaves = vocab - 1 - n_genus
    if n_leaves < len(class_names):
        raise ValueError(f"vocab={vocab} leaves room for {n_leaves} < "
                         f"{len(class_names)} class leaves")
    leaves = [f"noun_{i:05d}" for i in range(n_leaves)]
    at = np.linspace(0, n_leaves - 1, len(class_names)).round().astype(int)
    for i, name in zip(at, class_names):
        leaves[i] = name
    tree: Dict[str, List[str]] = {"entity": []}
    per = -(-n_leaves // n_genus)
    for g in range(n_genus):
        genus = f"genus_{g:03d}"
        tree["entity"].append(genus)
        tree[genus] = leaves[g * per:(g + 1) * per]
        for leaf in tree[genus]:
            tree[leaf] = []
    build_wndb(cfg.data.wordnet_db_dir, tree)
    nouns = list(tree.keys())
    os.makedirs(cfg.data.corpus_dir, exist_ok=True)
    with open(os.path.join(cfg.data.corpus_dir, "wordnet_all_noun.txt"),
              "w") as f:
        f.write("\n".join(nouns) + "\n")
    noun_col = {n: c for c, n in enumerate(nouns)}
    return {"nouns": nouns, "class_names": list(class_names),
            "gt_cols": [noun_col[n] for n in class_names]}


def _class_counts(n: int, n_cls: int) -> List[int]:
    base, rem = divmod(n, n_cls)
    return [base + int(c < rem) for c in range(n_cls)]


def fabricate_cub_tree(root: str, seed: int = 0, n_train: int = CUB_TRAIN,
                       n_test: int = CUB_TEST) -> List[str]:
    """The CUB-200-2011 metadata of ``make_cub`` (``CUB_200_2011/`` txts,
    image ids class by class, no image files) and an SSB split pickle
    (``ssb_splits/cub_osr_splits.pkl``: half the classes known, drawn from
    ``seed``, the rest in Hard / Medium / Easy tiers).  Returns the class
    names as the vocabulary spells them."""
    import pickle

    base = os.path.join(root, "CUB_200_2011")
    os.makedirs(base, exist_ok=True)
    dirs = [f"{c + 1:03d}.Bird_{c:03d}" for c in range(CUB_CLASSES)]
    images, labels, split = [], [], []
    i = 1
    for c, (tr, te) in enumerate(zip(_class_counts(n_train, CUB_CLASSES),
                                     _class_counts(n_test, CUB_CLASSES))):
        for j in range(tr + te):
            images.append(f"{i} {dirs[c]}/{dirs[c][4:]}_{j:04d}.jpg")
            labels.append(f"{i} {c + 1}")
            split.append(f"{i} {int(j < tr)}")
            i += 1
    for name, lines in (("images.txt", images),
                        ("image_class_labels.txt", labels),
                        ("train_test_split.txt", split),
                        ("classes.txt", [f"{c + 1} {d}"
                                         for c, d in enumerate(dirs)])):
        with open(os.path.join(base, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    order = np.random.default_rng(seed).permutation(CUB_CLASSES)
    known = sorted(int(c) for c in order[:CUB_CLASSES // 2])
    unknown = [int(c) for c in order[CUB_CLASSES // 2:]]
    third = len(unknown) // 3
    os.makedirs(os.path.join(root, "ssb_splits"), exist_ok=True)
    with open(os.path.join(root, "ssb_splits", "cub_osr_splits.pkl"),
              "wb") as f:
        pickle.dump({"known_classes": known, "unknown_classes": {
            "Hard": sorted(unknown[:third]),
            "Medium": sorted(unknown[third:2 * third]),
            "Easy": sorted(unknown[2 * third:])}}, f)
    return [d[4:].lower() for d in dirs]


def fabricate_sdogs_tree(root: str, n_train: int = SDOGS_TRAIN,
                         n_test: int = SDOGS_TEST) -> List[str]:
    """The Stanford Dogs layout of ``make_sdogs``: one (empty) breed
    directory per class under ``StanfordDogs/Images/`` and the
    ``train_list.mat`` / ``test_list.mat`` file lists with 1-based labels.
    Returns the class names as the vocabulary spells them."""
    from scipy.io import savemat

    base = os.path.join(root, "StanfordDogs")
    breeds = [f"n{2_085_620 + c:08d}-Breed_{c:03d}"
              for c in range(SDOGS_CLASSES)]
    for b in breeds:
        os.makedirs(os.path.join(base, "Images", b), exist_ok=True)
    for mat_name, n, tag in (("train_list.mat", n_train, "tr"),
                             ("test_list.mat", n_test, "te")):
        files, lab = [], []
        for c, count in enumerate(_class_counts(n, SDOGS_CLASSES)):
            files += [f"{breeds[c]}/{tag}_{j:04d}.jpg" for j in range(count)]
            lab += [c + 1] * count
        fl = np.empty((len(files), 1), object)
        for i, f in enumerate(files):
            fl[i, 0] = np.array([f])
        savemat(os.path.join(base, mat_name),
                {"file_list": fl, "labels": np.array(lab)[:, None]})
    return [b[10:].lower() for b in breeds]


def fabricate_fine_grained(cfg: PipelineConfig, seed: int = 0, device="cpu",
                           n_train: int = 0, n_test: int = 0,
                           d_feat: int = 768, d_clip: int = 512,
                           vocab: int = 68_000, n_genus: int = 99) -> Dict:
    """Write the warm root of ``cfg`` (``cub`` or ``sdogs``, see
    :func:`warm_config`): the dataset's metadata at the published split
    sizes (or ``n_train`` / ``n_test`` when given), a taxonomy and
    vocabulary holding every class name, and the caches a warm
    ``run_unsup`` / ``run_ptsup`` re-enters.  The readers list paths and
    never open an image, so no image file is written."""
    root, name = cfg.data.root_dir, cfg.data.dataset_name
    if name == "cub":
        class_names = fabricate_cub_tree(root, seed, n_train or CUB_TRAIN,
                                         n_test or CUB_TEST)
    elif name == "sdogs":
        class_names = fabricate_sdogs_tree(root, n_train or SDOGS_TRAIN,
                                           n_test or SDOGS_TEST)
    else:
        raise ValueError(f"no fine-grained fabricator for {name!r}")
    info = _write_vocabulary(cfg, class_names, vocab, n_genus)
    return _write_warm_caches(cfg, info, seed, device, d_feat, d_clip)


# ------------------------------------------------------------- cold root

def _randn(g: torch.Generator):
    def r(*shape, scale: float = 0.02) -> torch.Tensor:
        return torch.randn(*shape, generator=g) * scale
    return r


def _clip_block_sd(r, prefix: str, w: int) -> Dict[str, torch.Tensor]:
    return {
        f"{prefix}.ln_1.weight": 1.0 + r(w), f"{prefix}.ln_1.bias": r(w),
        f"{prefix}.ln_2.weight": 1.0 + r(w), f"{prefix}.ln_2.bias": r(w),
        f"{prefix}.attn.in_proj_weight": r(3 * w, w),
        f"{prefix}.attn.in_proj_bias": r(3 * w),
        f"{prefix}.attn.out_proj.weight": r(w, w),
        f"{prefix}.attn.out_proj.bias": r(w),
        f"{prefix}.mlp.c_fc.weight": r(4 * w, w),
        f"{prefix}.mlp.c_fc.bias": r(4 * w),
        f"{prefix}.mlp.c_proj.weight": r(w, 4 * w),
        f"{prefix}.mlp.c_proj.bias": r(w),
    }


def clip_state_dict(cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random weights in the OpenAI CLIP state-dict layout
    (``visual.transformer.resblocks.N.attn.in_proj_weight``, ...) for a
    ``models.clip.CLIPConfig``: N(0, 0.02) matrices and biases, LayerNorm
    gains near 1, projections scaled by width^-1/2."""
    r = _randn(torch.Generator().manual_seed(seed))
    v, w, tw = cfg.vision, cfg.vision.width, cfg.text_width
    sd = {
        "visual.conv1.weight": r(w, 3, v.patch_size, v.patch_size),
        "visual.class_embedding": r(w),
        "visual.positional_embedding": r(v.seq_len, w),
        "visual.ln_pre.weight": 1.0 + r(w), "visual.ln_pre.bias": r(w),
        "visual.ln_post.weight": 1.0 + r(w), "visual.ln_post.bias": r(w),
        "visual.proj": r(w, v.output_proj, scale=w ** -0.5),
        "token_embedding.weight": r(cfg.vocab_size, tw),
        "positional_embedding": r(cfg.context_length, tw, scale=0.01),
        "ln_final.weight": 1.0 + r(tw), "ln_final.bias": r(tw),
        "text_projection": r(tw, cfg.embed_dim, scale=tw ** -0.5),
        "logit_scale": torch.tensor(math.log(1 / 0.07)),
    }
    for i in range(v.depth):
        sd.update(_clip_block_sd(r, f"visual.transformer.resblocks.{i}", w))
    for i in range(cfg.text_depth):
        sd.update(_clip_block_sd(r, f"transformer.resblocks.{i}", tw))
    return sd


def dino_state_dict(cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random weights in the facebookresearch/dino ViT layout
    (``blocks.N.attn.qkv.weight``, ...) for a ``models.vit.ViTConfig``."""
    r = _randn(torch.Generator().manual_seed(seed))
    w, p = cfg.width, cfg.patch_size
    hidden = int(w * cfg.mlp_ratio)
    sd = {
        "patch_embed.proj.weight": r(w, 3, p, p),
        "patch_embed.proj.bias": r(w),
        "cls_token": r(1, 1, w), "pos_embed": r(1, cfg.seq_len, w),
        "norm.weight": 1.0 + r(w), "norm.bias": r(w),
    }
    for i in range(cfg.depth):
        b = f"blocks.{i}"
        sd.update({
            f"{b}.norm1.weight": 1.0 + r(w), f"{b}.norm1.bias": r(w),
            f"{b}.norm2.weight": 1.0 + r(w), f"{b}.norm2.bias": r(w),
            f"{b}.attn.qkv.weight": r(3 * w, w), f"{b}.attn.qkv.bias": r(3 * w),
            f"{b}.attn.proj.weight": r(w, w), f"{b}.attn.proj.bias": r(w),
            f"{b}.mlp.fc1.weight": r(hidden, w), f"{b}.mlp.fc1.bias": r(hidden),
            f"{b}.mlp.fc2.weight": r(w, hidden), f"{b}.mlp.fc2.bias": r(w),
        })
    return sd


def resnet50_state_dict(cfg, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Random weights in the torchvision ResNet-50 layout (``conv1``,
    ``bn1``, ``layer1.0.conv1``, ``layer1.0.downsample.0``, ``fc``, ...)
    for a ``models.resnet50.ResNet50Config``: He-scaled convolutions,
    BatchNorm gains near 1 with small shifts and running statistics, a
    ``fc`` head the loader ignores."""
    r = _randn(torch.Generator().manual_seed(seed))

    def conv(name, c_out, c_in, k):
        return {f"{name}.weight": r(c_out, c_in, k, k,
                                    scale=(2.0 / (c_in * k * k)) ** 0.5)}

    def bn(name, c):
        return {f"{name}.weight": 1.0 + r(c, scale=0.1),
                f"{name}.bias": r(c, scale=0.1),
                f"{name}.running_mean": r(c, scale=0.1),
                f"{name}.running_var": 1.0 + r(c, scale=0.1).abs(),
                f"{name}.num_batches_tracked": torch.tensor(100)}

    sd = {**conv("conv1", cfg.width, 3, 7), **bn("bn1", cfg.width)}
    in_ch = cfg.width
    for i, n_blocks in enumerate(cfg.layers):
        planes = cfg.stage_width(i)
        for j in range(n_blocks):
            p = f"layer{i + 1}.{j}"
            sd.update({**conv(f"{p}.conv1", planes, in_ch, 1),
                       **bn(f"{p}.bn1", planes),
                       **conv(f"{p}.conv2", planes, planes, 3),
                       **bn(f"{p}.bn2", planes),
                       **conv(f"{p}.conv3", 4 * planes, planes, 1),
                       **bn(f"{p}.bn3", 4 * planes)})
            if j == 0:
                sd.update({**conv(f"{p}.downsample.0", 4 * planes, in_ch, 1),
                           **bn(f"{p}.downsample.1", 4 * planes)})
            in_ch = 4 * planes
    sd.update({"fc.weight": r(1000, in_ch), "fc.bias": r(1000)})
    return sd


BPE_MERGES = 49152 - 256 - 2  # the release file's count: vocab 49,408


def write_bpe_merges(path: str, seed: int = 0,
                     n_merges: int = BPE_MERGES) -> str:
    """A gzipped merges file in the ``bpe_simple_vocab_16e6.txt.gz``
    format (a version line, then one ``a b`` merge per line) with
    ``n_merges`` distinct merges drawn from ``seed``: each joins a piece
    built so far (short pieces more often) with a letter, a digit or a
    piece, with or without the end-of-word mark.  At the default count the
    vocabulary has the release's 49,408 ids (EOT = 49,407)."""
    rng = np.random.default_rng(seed)
    pieces = list("abcdefghijklmnopqrstuvwxyz0123456789")
    made = set(pieces) | {c + "</w>" for c in pieces}
    lines = ["#version: 0.2 (fabricated)"]
    while len(lines) <= n_merges:
        a = pieces[int(len(pieces) * rng.random() ** 3)]
        b = pieces[int(len(pieces) * rng.random() ** 3)]
        if rng.random() < 0.5:
            b += "</w>"
        tok = a + b
        if tok in made:
            continue
        made.add(tok)
        lines.append(f"{a} {b}")
        if not tok.endswith("</w>"):
            pieces.append(tok)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return path


# words per name in a vocabulary build's traffic: the mix of the JAX
# package's own measurement of that build (``bench.py::bench_vocab_build``,
# "WordNet-ish mix: ~60% one-word, 30% two-word, 10% three-word lemmas")
NAME_WORD_MIX = (0.6, 0.3, 0.1)


def short_names(tokenizer, n: int, seed: int = 0) -> List[str]:
    """``n`` names of one, two or three words in the shares of
    :data:`NAME_WORD_MIX`, each word a single token of ``tokenizer`` (an
    alphabetic word-final entry of its vocabulary, three letters or more,
    that encodes to itself), drawn with repetition as that measurement
    draws its names (about 1,300 such words: distinct names would push
    the mix to two and three words).  Under
    :func:`write_bpe_merges`'s random merges a cold root's own names
    (``noun_00123``) take nine tokens and the templates' tails up to
    twelve, so no such name fits the prefix-KV build's 16-token suffix
    rows."""
    words = sorted(w[:-4] for w in tokenizer.encoder
                   if w.endswith("</w>") and w[:-4].isalpha()
                   and len(w) >= 7)
    words = [w for w in words if len(tokenizer.encode(w)) == 1]
    rng = np.random.default_rng(seed)
    n_words = 1 + rng.choice(len(NAME_WORD_MIX), size=n, p=NAME_WORD_MIX)
    return [" ".join(words[i] for i in rng.integers(0, len(words), k))
            for k in n_words]


def cold_config(root: str, dense_int8: bool = True, n_clusters: int = 100,
                n_init: int = 10, max_iterations: int = 10,
                batch_size: int = 128, num_workers: int = 8
                ) -> PipelineConfig:
    """The pipeline config of a cold root: ImageNet-100, DINO clustering
    features, WordNet corpus, SSKM, no caches and no precomputed
    zero-shot file, the weights and merges where
    :func:`fabricate_cold_root` writes them."""
    warm = imagenet100_config(root, n_clusters=n_clusters, n_init=n_init,
                              max_iterations=max_iterations)
    return warm.replace(
        data=dataclasses.replace(
            warm.data, zeroshot_weights="", batch_size=batch_size,
            num_workers=num_workers,
            clip_weights=os.path.join(root, "weights", "clip_vit_b16.pt"),
            dino_weights=os.path.join(root, "weights", "dino_vitb16.pt")),
        feature=dataclasses.replace(warm.feature, dense_int8=dense_int8))


def fabricate_cold_root(cfg: PipelineConfig, clip_cfg, dino_cfg,
                        seed: int = 0, n_images: int = 10_000,
                        vocab: int = 8_000, n_genus: int = 99,
                        jpeg_size: int = 0) -> Dict:
    """Write the cold root that ``cfg`` (see :func:`cold_config`) points
    at: the tree and taxonomy, CLIP and DINO state dicts for ``clip_cfg``
    and ``dino_cfg`` (``torch.save``), and the merges file.  Returns the
    tree's info (see :func:`fabricate_imagenet_tree`)."""
    info = fabricate_imagenet_tree(cfg, n_images, vocab, n_genus,
                                   jpeg_size=jpeg_size, seed=seed)
    os.makedirs(os.path.dirname(cfg.data.clip_weights), exist_ok=True)
    torch.save(clip_state_dict(clip_cfg, seed), cfg.data.clip_weights)
    torch.save(dino_state_dict(dino_cfg, seed + 1), cfg.data.dino_weights)
    write_bpe_merges(os.path.join(cfg.data.corpus_dir,
                                  "bpe_simple_vocab_16e6.txt.gz"), seed)
    return info
