"""Fabricate an ImageNet-100 artifact root for the port's main path.

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

Cold root (:func:`fabricate_cold_root`): the same tree and taxonomy, no
caches, and the assets the encoders need instead: an OpenAI-layout CLIP
state dict and a DINO-layout ViT state dict (random weights at any width
and depth, :func:`clip_state_dict`, :func:`dino_state_dict`) and a CLIP
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
    from scd_tpu_torch.data import get_datasets
    from scd_tpu_torch.pipelines.common import feature_cache_key, stage_cache

    info = fabricate_imagenet_tree(cfg, n_images, vocab, n_genus)
    nouns, class_names, gt_cols = (info["nouns"], info["class_names"],
                                   info["gt_cols"])

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
