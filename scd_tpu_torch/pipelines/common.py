"""Shared pipeline stages for the unsup and ptsup entry points.

Port of the single-device parts of ``scd_tpu/pipelines/common.py``: the
artifact cache and its keys, feature extraction (one dataset pass feeding
both image towers, built lazily so a fully cached run loads no weights),
the zero-shot vocabulary build, clustering (KM, SSKM, ConSSKM, FINCH) and
the metric printout.  Every stage goes through the ``ArtifactCache`` under the JAX
package's keys, so either package re-enters the other's caches.
"""

from __future__ import annotations

import collections
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from scd_tpu_torch.core.cache import ArtifactCache, tensors_from_arrays
from scd_tpu_torch.core.config import PipelineConfig, config_hash
from scd_tpu_torch.cluster.constrained import fit_constrained
from scd_tpu_torch.cluster.finch import finch_fit
from scd_tpu_torch.cluster.kmeans import fit_kmeans, fit_sskm
from scd_tpu_torch.data.loader import iterate_batches
from scd_tpu_torch.metrics import (
    evaluate_semantic_acc,
    split_cluster_acc_v2,
)
from scd_tpu_torch.metrics.semantic import evaluate_soft_semantic_acc

def _prefetched(batches, depth: int = 2, stage_fn=None):
    """Stage the next ``depth`` batches (``stage_fn``, e.g. the copy to the
    device) while the current one is encoded."""
    stage_fn = stage_fn or (lambda images: images)
    q = collections.deque()

    def stage(item):
        images, *rest = item
        return (stage_fn(images), *rest)

    it = iter(batches)
    for item in it:
        q.append(stage(item))
        if len(q) >= depth:
            break
    while q:
        out = q.popleft()
        for item in it:
            q.append(stage(item))
            break
        yield out


def _normalized(f: np.ndarray, normalize: bool) -> np.ndarray:
    if normalize:
        f = f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-12)
    return f


def extract_features(encode_image: Callable, dataset,
                     train_classes: Sequence[int], batch_size: int = 256,
                     num_workers: int = 8,
                     normalize: bool = True) -> Dict[str, np.ndarray]:
    """Batched feature extraction with the reference's output contract
    (``main_unsup.py:114-147``): all_feats (L2-normalized), mask_lab,
    mask_cls, targets.  ``encode_image.stage``, when present, moves each
    batch to the device during prefetch."""
    return extract_features_multi({"feat": encode_image}, dataset,
                                  train_classes, batch_size, num_workers,
                                  normalize)["feat"]


def extract_features_multi(encoders: Dict[str, Callable], dataset,
                           train_classes: Sequence[int],
                           batch_size: int = 256, num_workers: int = 8,
                           normalize: bool = True
                           ) -> Dict[str, Dict[str, np.ndarray]]:
    """One pass over the dataset feeding every encoder (the reference
    iterates once per encoder, paying decode and transfer twice).  Returns
    ``{encoder_name: extract_features-style dict}``.  Batches are staged by
    the encoders' common ``.stage`` when every encoder has one."""
    stage_fns = [getattr(f, "stage", None) for f in encoders.values()]
    common_stage = stage_fns[0] if all(
        s is not None for s in stage_fns) else None

    feats: Dict[str, list] = {k: [] for k in encoders}
    targets, mask_lab, mask_cls = [], [], []
    # dataset targets are remapped (labelled classes first), so Old-class
    # membership is id < n_lab
    n_lab = len(train_classes)
    for images, labels, _uq, mlab in _prefetched(
            iterate_batches(dataset, batch_size, num_workers=num_workers),
            stage_fn=common_stage):
        for k, enc in encoders.items():
            feats[k].append(_normalized(
                np.asarray(enc(images), np.float32), normalize))
        targets.append(labels)
        mask_lab.append(mlab)
        mask_cls.append(np.asarray(labels) < n_lab)
    meta = {
        "targets": np.concatenate(targets).astype(np.float64),
        "mask_lab": np.concatenate(mask_lab),
        "mask_cls": np.concatenate(mask_cls),
    }
    return {k: {"all_feats": np.concatenate(v), **meta}
            for k, v in feats.items()}


def make_shared_extractor(feat_encode, clip_encode, dataset,
                          train_classes: Sequence[int], batch_size: int,
                          num_workers: int,
                          needed: Sequence[str] = ("feat", "clip")):
    """Memoized single-pass extraction for the feat + CLIP encoder pair.
    ``needed``: the feature sets whose cache lookups missed; only those
    towers run, in one shared dataset pass.  Returns ``extract(key)``."""
    memo: Dict[str, Dict] = {}
    by_key = {"feat": feat_encode, "clip": clip_encode}

    def extract(key: str) -> Dict[str, np.ndarray]:
        if key not in memo:
            want = set(needed) | {key}
            encoders = {k: by_key[k] for k in sorted(want)}
            if encoders.get("clip") is encoders.get("feat"):
                encoders.pop("clip")  # same tower: run once, alias below
            memo.update(extract_features_multi(
                encoders, dataset, train_classes, batch_size, num_workers))
            if "clip" in want and "clip" not in memo:
                memo["clip"] = memo["feat"]
        return memo[key]

    return extract


class _LazyProxy:
    """Call/attribute proxy that builds its target on first use, so a fully
    cached run constructs no model and loads no weights."""

    def __init__(self, get):
        self._get = get

    def __call__(self, *a, **kw):
        return self._get()(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._get(), name)


def lazy_encoders(factory) -> Tuple[Callable, Callable, Callable]:
    """(feat_encode, clip_encode, encode_text) proxies over ``factory()``
    (a ``build_encoders`` thunk), built at most once and only when an
    encoder is actually used, i.e. on a cache miss."""
    memo: list = []

    def built():
        if not memo:
            memo.append(factory())
        return memo[0]

    return (_LazyProxy(lambda: built()[0]), _LazyProxy(lambda: built()[1]),
            _LazyProxy(lambda: built()[2]))


def load_shared_features(cfg: PipelineConfig, cache: ArtifactCache,
                         feat_encode, clip_encode, dataset,
                         train_classes: Sequence[int]) -> Tuple[Dict, Dict]:
    """The clustering and CLIP feature dicts under the JAX package's keys
    (``feature_cache_key``): loaded from the cache, or extracted in at most
    one dataset pass for the sets that miss (or all, under
    ``extract_feat``).  Returns ``(feats, clip_feats)``."""
    feat_key = feature_cache_key(cfg, "feat")
    clip_key = feature_cache_key(cfg, "clip")
    needed = tuple(k for k, ck in (("feat", feat_key), ("clip", clip_key))
                   if cfg.extract_feat or not cache.has("features", ck))
    extract = make_shared_extractor(
        feat_encode, clip_encode, dataset, train_classes,
        cfg.data.batch_size, cfg.data.num_workers, needed=needed)
    feats = cache.load_or_compute(
        "features", feat_key, lambda: extract("feat"),
        refresh=cfg.extract_feat)
    clip_feats = cache.load_or_compute(
        "features", clip_key, lambda: extract("clip"),
        refresh=cfg.extract_feat)
    return feats, clip_feats


def pipeline_transform(cfg: PipelineConfig):
    """The mains' transform: CLIP's own preprocess emitting uint8 for
    on-device normalization (``main_unsup.py:271``); synthetic datasets
    carry their own arrays (None)."""
    if cfg.data.dataset_name == "synthetic":
        return None
    from scd_tpu_torch.data.transforms import clip_preprocess

    return clip_preprocess(cfg.data.image_size, device_normalize=True)


def load_zeroshot_weights(cfg: PipelineConfig, cache: ArtifactCache,
                          encode_text, nouns) -> np.ndarray:
    """[D, V] zero-shot weights: an explicit ``--zeroshot_weights`` file
    (the reference's precomputed ``zeroshot_weights/*.pt``,
    ``main_unsup.py:387-395``), else the cached build through the CLIP
    text tower."""
    from scd_tpu_torch.naming.templates import IMAGENET_TEMPLATES
    from scd_tpu_torch.naming.zeroshot import build_zeroshot_weights

    if cfg.data.zeroshot_weights:
        return (np.load(cfg.data.zeroshot_weights)["weights"]
                if cfg.data.zeroshot_weights.endswith(".npz")
                else np.load(cfg.data.zeroshot_weights))
    return cache.load_or_compute(
        "zeroshot", feature_cache_key(cfg, f"zw_{cfg.naming.corpus}"),
        lambda: {"weights": build_zeroshot_weights(
            encode_text, nouns, IMAGENET_TEMPLATES)})["weights"]


def run_clustering(cfg: PipelineConfig, feats: Dict[str, np.ndarray],
                   device="cuda") -> Dict[str, np.ndarray]:
    """Cluster per config (reference ``main_unsup.py:334-364``) on
    ``device``.  Returns the reference's cluster_result contract as numpy:
    all_preds (-1 on the labelled rows for KM and FINCH; SSKM and ConSSKM
    give the labelled rows their class ids), u_preds, u_targets, mask."""
    c = cfg.cluster
    mask_lab = feats["mask_lab"].astype(bool)
    mask_cls = feats["mask_cls"].astype(bool)
    targets = feats["targets"].astype(np.int64)
    u_targets = targets[~mask_lab]
    mask = mask_cls[~mask_lab]

    if c.algorithm not in ("KM", "SSKM", "ConSSKM", "FINCH"):
        raise ValueError(f"unknown cluster algorithm {c.algorithm!r}")

    all_feats = tensors_from_arrays({"all_feats": feats["all_feats"]},
                                    device)["all_feats"]
    lab_t = torch.as_tensor(mask_lab, device=all_feats.device)
    u_feats = all_feats[~lab_t]
    if c.algorithm in ("KM", "FINCH"):
        # the labelled rows keep -1
        preds = (fit_kmeans(u_feats, c).labels if c.algorithm == "KM"
                 else finch_fit(u_feats, req_clust=c.n_clusters))
        preds = preds.astype(np.int64)
        all_preds = np.full(len(mask_lab), -1, np.int64)
        all_preds[~mask_lab] = preds
    else:
        fit = fit_sskm if c.algorithm == "SSKM" else fit_constrained
        res = fit(u_feats, all_feats[lab_t], targets[mask_lab], c)
        n_l = int(mask_lab.sum())
        all_preds = np.empty(len(mask_lab), np.int64)
        all_preds[mask_lab] = res.labels[:n_l]
        all_preds[~mask_lab] = res.labels[n_l:]
        preds = all_preds[~mask_lab]
    return {"all_preds": all_preds, "u_preds": np.asarray(preds, np.int64),
            "u_targets": u_targets, "mask": mask}


def print_acc_block(tag: str, u_targets, u_preds, mask,
                    cidx_to_cname, cand_names,
                    name_similarity: Optional[Callable] = None,
                    eval_soft: bool = True) -> Dict[str, float]:
    """The reference's per-iteration metric printout
    (``main_unsup.py:617-641``), returning the numbers as a dict.  The
    print formats are byte-identical to the JAX package's."""
    out: Dict[str, float] = {}
    all_acc, old_acc, new_acc = split_cluster_acc_v2(u_targets, u_preds, mask)
    out.update(all_acc=all_acc, old_acc=old_acc, new_acc=new_acc)
    print(f"Accuracies: All {all_acc} | Old {old_acc} | New {new_acc}")

    subsets = {"All": np.ones(len(u_preds), bool), "old": mask, "new": ~mask}
    sacc = {}
    for name, sel in subsets.items():
        if sel.sum() == 0:
            sacc[name] = (0.0, 0.0)
            continue
        sacc[name] = evaluate_semantic_acc(u_targets[sel], cidx_to_cname,
                                           u_preds[sel], cand_names)
    for label, (acc_key, sel_name) in (("All", ("all_acc", "All")),
                                       ("old", ("old_acc", "old")),
                                       ("new", ("new_acc", "new"))):
        avg, allv = sacc[sel_name]
        print(f"ACC/sACC_avg/sACC_all: {label} "
              f"{round(out[acc_key] * 100, 2)}/{round(avg * 100, 2)}"
              f"/{round(allv * 100, 2)} ")
        out[f"sacc_avg_{label}"] = avg
        out[f"sacc_all_{label}"] = allv

    if eval_soft and name_similarity is not None:
        for label, sel in subsets.items():
            if sel.sum() == 0:
                continue
            try:
                soft = evaluate_soft_semantic_acc(
                    u_targets[sel], cidx_to_cname, u_preds[sel], cand_names,
                    name_similarity)
            except KeyError:
                break
            acc_val = {"All": all_acc, "old": old_acc, "new": new_acc}[label]
            print(f"ACC/Soft sACC: {label} {round(acc_val * 100, 2)}"
                  f"/{round(soft * 100, 2)}")
            out[f"soft_sacc_{label}"] = soft
    return out


def stage_cache(cfg: PipelineConfig) -> ArtifactCache:
    root = cfg.data.cache_dir
    if not os.path.isabs(root):
        root = os.path.join(os.getcwd(), root)
    return ArtifactCache(root)


def feature_cache_key(cfg: PipelineConfig, which: str) -> str:
    # only the clustering-feature key depends on feat_model: CLIP features
    # and zeroshot weights are the same across feat_model choices
    extra = {"model": which}
    if which == "feat":
        extra["feat"] = cfg.feature.feat_model
    return config_hash(cfg.data, extra=extra)


def cluster_cache_key(cfg: PipelineConfig) -> str:
    return config_hash(cfg.cluster, extra={
        "data": config_hash(cfg.data), "feat": cfg.feature.feat_model})

