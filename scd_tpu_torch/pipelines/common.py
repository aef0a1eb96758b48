"""Shared pipeline stages for the unsup entry point.

Port of the parts of ``scd_tpu/pipelines/common.py`` that the cached main
path runs: the artifact cache and its keys, the cache-aware feature and
zero-shot loaders, clustering (KM, SSKM) and the metric printout.  Every
stage goes through the ``ArtifactCache`` under the JAX package's keys, so
either package re-enters the other's caches.

Extraction and the vocabulary build need the encoder towers, which come
with ROADMAP's encoder slice (slice (d)); until then a cache miss that
would need them raises.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from scd_tpu_torch.core.cache import ArtifactCache, tensors_from_arrays
from scd_tpu_torch.core.config import PipelineConfig, config_hash
from scd_tpu_torch.cluster.kmeans import fit_kmeans, fit_sskm
from scd_tpu_torch.metrics import (
    evaluate_semantic_acc,
    split_cluster_acc_v2,
)
from scd_tpu_torch.metrics.semantic import evaluate_soft_semantic_acc

_ENCODER_SLICE = ("ROADMAP's encoder slice (slice (d): encoders and "
                  "vocabulary)")


def load_shared_features(cfg: PipelineConfig, cache: ArtifactCache
                         ) -> Tuple[Dict[str, np.ndarray],
                                    Dict[str, np.ndarray]]:
    """The clustering and CLIP feature dicts from the cache, under the JAX
    package's keys (``feature_cache_key``).  Returns ``(feats,
    clip_feats)`` as numpy dicts.  A miss, or ``extract_feat``, needs the
    encoder towers and raises until they are ported."""
    out = []
    for which in ("feat", "clip"):
        key = feature_cache_key(cfg, which)
        if cfg.extract_feat or not cache.has("features", key):
            raise NotImplementedError(
                f"features cache miss for {which!r} (key {key} under "
                f"{cache.root}): extraction needs the encoder towers, which "
                f"the port gains with {_ENCODER_SLICE}")
        out.append(cache.load("features", key))
    return out[0], out[1]


def load_zeroshot_weights(cfg: PipelineConfig,
                          cache: ArtifactCache) -> np.ndarray:
    """[D, V] zero-shot weights: an explicit ``--zeroshot_weights`` file
    (the reference's precomputed ``zeroshot_weights/*.pt``,
    ``main_unsup.py:387-395``), else the cached build.  Building it needs
    the CLIP text tower and raises until it is ported."""
    if cfg.data.zeroshot_weights:
        return (np.load(cfg.data.zeroshot_weights)["weights"]
                if cfg.data.zeroshot_weights.endswith(".npz")
                else np.load(cfg.data.zeroshot_weights))
    key = feature_cache_key(cfg, f"zw_{cfg.naming.corpus}")
    if not cache.has("zeroshot", key):
        raise NotImplementedError(
            f"zeroshot cache miss (key {key} under {cache.root}): building "
            f"the vocabulary matrix needs the CLIP text tower, which the "
            f"port gains with {_ENCODER_SLICE}")
    return cache.load("zeroshot", key)["weights"]


def run_clustering(cfg: PipelineConfig, feats: Dict[str, np.ndarray],
                   device="cuda") -> Dict[str, np.ndarray]:
    """Cluster per config (reference ``main_unsup.py:334-364``) on
    ``device``.  Returns the reference's cluster_result contract as numpy:
    all_preds (-1 for KM), u_preds, u_targets, mask."""
    c = cfg.cluster
    mask_lab = feats["mask_lab"].astype(bool)
    mask_cls = feats["mask_cls"].astype(bool)
    targets = feats["targets"].astype(np.int64)
    u_targets = targets[~mask_lab]
    mask = mask_cls[~mask_lab]

    if c.algorithm == "ConSSKM":
        raise NotImplementedError(
            "ConSSKM is not ported yet (ROADMAP: constrained clustering)")
    if c.algorithm == "FINCH":
        raise NotImplementedError(
            "FINCH is not ported yet (ROADMAP: other clusterers)")
    if c.algorithm not in ("KM", "SSKM"):
        raise ValueError(f"unknown cluster algorithm {c.algorithm!r}")

    all_feats = tensors_from_arrays({"all_feats": feats["all_feats"]},
                                    device)["all_feats"]
    lab_t = torch.as_tensor(mask_lab, device=all_feats.device)
    u_feats = all_feats[~lab_t]
    if c.algorithm == "KM":
        res = fit_kmeans(u_feats, c)
        preds = res.labels.astype(np.int64)
        all_preds = np.full(len(mask_lab), -1, np.int64)
        all_preds[~mask_lab] = preds
    else:
        res = fit_sskm(u_feats, all_feats[lab_t], targets[mask_lab], c)
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

