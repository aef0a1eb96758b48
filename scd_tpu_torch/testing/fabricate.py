"""Fabricate an ImageNet-100 artifact root for the port's main path.

Everything ``run_unsup`` reads on a fully cached run, made from a seed, at
any size — the ImageNet-100 deployment of ``bench.py::bench_e2e``
(N = 130,048 images, 768-d clustering and 512-d CLIP features, V = 68,000
nouns, K = 100) or a tiny one for tests:

- ``wordnet/``: a WNDB taxonomy (``data.noun``, ``index.noun``) whose
  first lemmas are the V vocabulary names: ``entity`` -> genera -> leaves;
  1000 of the leaves are the ImageNet-1k class synsets;
- ``data/wordnet_all_noun.txt``: the vocabulary, one name per line;
- ``ILSVRC12/{train,val}/<wnid>/``: the 1000 class dirs; the 100 classes of
  the seed-0 ImageNet-100 draw hold empty ``.jpg`` files, N in all, split so
  the 50/50 class split labels exactly half of the Old classes' rows;
- the features caches (written through the port's ``ArtifactCache`` under
  the port's keys, which equal the JAX package's): class-structured,
  L2-normalized clustering and CLIP features whose ``targets`` and
  ``mask_lab`` are the dataset's own, modelled on ``bench.py:934-966``;
- ``zeroshot_weights.npz``: a [D_clip, V] matrix of random unit columns in
  which each class name's column carries its class signature.

Features are drawn on ``device`` from a ``torch.Generator``.  The WNDB
writer is a parametrised copy of ``tests/wndb_fabricate.py``.
"""

from __future__ import annotations

import os
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


def fabricate_imagenet100(cfg: PipelineConfig, seed: int = 0,
                          device="cpu", n_images: int = 130_048,
                          d_feat: int = 768, d_clip: int = 512,
                          vocab: int = 68_000, n_genus: int = 99) -> Dict:
    """Write the root that ``cfg`` (see :func:`imagenet100_config`) points
    at.  Returns what was written: nouns, the GT name of each class, and
    the vocabulary column of each class."""
    from scd_tpu_torch.data import get_datasets
    from scd_tpu_torch.pipelines.common import feature_cache_key, stage_cache

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
            open(os.path.join(tdir, f"{t:05d}.jpg"), "w").close()
        open(os.path.join(root, "ILSVRC12", "val", wnids[i1000], "v.jpg"),
             "w").close()
    class_names = [wnid_to_leaf[wnids[i]] for i in chosen]  # by idx100
    noun_col = {n: c for c, n in enumerate(nouns)}
    gt_cols = [noun_col[n] for n in class_names]

    # ---- the dataset's own targets and labelled mask
    train, _test, _unlab, extras = get_datasets(cfg.data)
    targets_np = train.targets.astype(np.int64)
    mask_lab = train.mask_lab
    mask_cls = targets_np < len(extras["train_classes"])  # remapped: Old first

    # ---- class-structured features and vocabulary, on the device
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    targets = torch.as_tensor(targets_np, device=dev)
    n = len(targets_np)
    feat_c = 3.0 * torch.randn(100, d_feat, generator=g, device=dev)
    clip_c = _unit_rows(torch.randn(100, d_clip, generator=g, device=dev))
    feats = _unit_rows(feat_c[targets] + 0.5 * torch.randn(
        n, d_feat, generator=g, device=dev))
    clip = _unit_rows(clip_c[targets] + 0.1 * torch.randn(
        n, d_clip, generator=g, device=dev))
    zw = _unit_rows(torch.randn(vocab, d_clip, generator=g, device=dev))
    zw[torch.as_tensor(gt_cols, device=dev)] = clip_c
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
    return {"nouns": nouns, "class_names": class_names, "gt_cols": gt_cols,
            "n_images": n, "n_labelled": int(mask_lab.sum())}
