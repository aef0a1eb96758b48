"""Shared pipeline stages for the unsup and ptsup entry points.

Port of ``scd_tpu/pipelines/common.py``: the artifact cache and its keys,
feature extraction (one dataset pass feeding both image towers, built
lazily so a fully cached run loads no weights), the zero-shot vocabulary
build, clustering (KM, SSKM, ConSSKM, FINCH) and the metric printout.
Every stage goes through the ``ArtifactCache`` under the JAX package's
keys, so either package re-enters the other's caches.

Over several ranks (``torchrun``; ``core/multihost.py``) the pipeline's
mesh (:func:`_pipeline_mesh`) shards the heavy stages, as the JAX
package's multi-controller path does: each rank decodes and encodes its
contiguous share of the dataset (:func:`extract_features_pod` through
:func:`make_sharded_image_encoder`), KM / SSKM / ConSSKM take each rank's
share of the unlabelled rows (:func:`_pod_shard`), the vocabulary build
shards the names; every rank ends each stage holding the same full result.
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
from scd_tpu_torch.core import multihost
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


def make_sharded_image_encoder(encode: Callable, mesh):
    """Data-parallel image encoder over a mesh
    (``scd_tpu/pipelines/common.py:66-157``, its multi-controller
    contract): ``encode(images)`` takes THIS RANK's rows of a batch, each
    rank runs its own copy of the tower (``encode``, an
    ``_image_encoder``-style callable returning [n, D] features), and the
    features of every rank's rows come back on every rank, in rank order
    (one ``all_gather``).  Ragged shares pad to a common width and the pad
    rows are dropped after (``core.multihost.rows_from_process_local``);
    ``encode.stage`` does that padding (and the inner encoder's device
    staging) for ``_prefetched``.  ``encode.mesh`` is set: consumers
    (serving) read it."""
    inner_stage = getattr(encode, "stage", None)

    def stage(images):
        local, valid = multihost.rows_from_process_local(
            mesh, images if isinstance(images, torch.Tensor)
            else np.asarray(images), pad=True, device="cpu")
        return (inner_stage(local) if inner_stage is not None
                else local.numpy()), valid

    def encode_sharded(images):
        staged, valid = images if isinstance(images, tuple) else \
            stage(images)
        f = torch.as_tensor(np.asarray(encode(staged), np.float32))
        full = multihost.host_fetch(f, mesh)
        return full if valid is None else full[valid]

    encode_sharded.stage = stage
    encode_sharded.mesh = mesh
    return encode_sharded


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


class _RowRange:
    """Index-window view over a 3/4-tuple dataset (decode-on-access)."""

    def __init__(self, ds, lo: int, hi: int):
        self._ds, self._lo, self._hi = ds, lo, hi

    def __len__(self) -> int:
        return self._hi - self._lo

    def __getitem__(self, i: int):
        return self._ds[self._lo + i]


def extract_features_pod(encoders: Dict[str, Callable], dataset,
                         train_classes: Sequence[int],
                         batch_size: int = 256, num_workers: int = 8,
                         normalize: bool = True
                         ) -> Dict[str, Dict[str, np.ndarray]]:
    """Extraction over ranks (``scd_tpu/pipelines/common.py:252-326``):
    each rank DECODES only its contiguous share of the dataset and the
    mesh encoders (:func:`make_sharded_image_encoder`) gather every rank's
    features of each batch; features and metadata come back the same on
    every rank, row-aligned with the single-process extraction order.
    Metadata comes from the dataset's host arrays, which every rank holds
    in full (only decoding is sharded)."""
    mesh = next(iter(encoders.values())).mesh
    rank, n_proc = mesh.data_index, mesh.n_data
    n = len(dataset)
    share = -(-n // n_proc)  # contiguous equal shares; tail ranks ragged
    lo, hi = multihost.share_bounds(n, n_proc, rank)
    n_batches = -(-share // batch_size)

    # per-(batch, rank) real row counts, the same on every rank
    starts = np.minimum(np.arange(n_proc) * share, n)
    stops = np.minimum(starts + share, n)
    counts = np.clip((stops - starts)[None, :]
                     - np.arange(n_batches)[:, None] * batch_size,
                     0, batch_size).astype(np.int64)

    it = iter(iterate_batches(_RowRange(dataset, lo, hi), batch_size,
                              num_workers=num_workers))
    img_shape = None
    feats: Dict[str, np.ndarray] = {}
    for b in range(n_batches):
        cnt = int(counts[b, rank])
        if cnt:
            images, _labels, _uq, _m = next(it)
            assert len(images) == cnt, (len(images), cnt)
            img_shape = images.shape[1:]
        else:
            if img_shape is None:  # this rank owns no rows at all
                img_shape = np.asarray(dataset[0][0]).shape
            images = np.zeros((0,) + tuple(img_shape), np.float32)
        # global row ids of this batch, in the gathered (rank-block) order
        idxs = np.concatenate([
            np.arange(starts[p] + b * batch_size,
                      starts[p] + b * batch_size + counts[b, p])
            for p in range(n_proc)])
        for k, enc in encoders.items():
            f = _normalized(np.asarray(enc(images), np.float32), normalize)
            if k not in feats:
                feats[k] = np.empty((n, f.shape[1]), np.float32)
            feats[k][idxs] = f

    targets = np.asarray(dataset.targets, np.int64)
    mask_lab = (np.asarray(dataset.mask_lab, bool)
                if hasattr(dataset, "mask_lab") else np.zeros(n, bool))
    meta = {
        "targets": targets.astype(np.float64),
        "mask_lab": mask_lab,
        # remapped ids: Old classes are 0..n_lab-1
        "mask_cls": targets < len(train_classes),
    }
    return {k: {"all_feats": v, **meta} for k, v in feats.items()}


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
            if multihost.is_multiprocess() and all(
                    hasattr(e, "mesh") for e in encoders.values()):
                # over ranks: each rank decodes only its dataset share
                memo.update(extract_features_pod(
                    encoders, dataset, train_classes, batch_size,
                    num_workers))
            else:
                memo.update(extract_features_multi(
                    encoders, dataset, train_classes, batch_size,
                    num_workers))
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
                          encode_text, nouns, mesh=None) -> np.ndarray:
    """[D, V] zero-shot weights: an explicit ``--zeroshot_weights`` file
    (the reference's precomputed ``zeroshot_weights/*.pt``,
    ``main_unsup.py:387-395``), else the cached build through the CLIP
    text tower (its names sharded over ``mesh``)."""
    from scd_tpu_torch.naming.templates import IMAGENET_TEMPLATES
    from scd_tpu_torch.naming.zeroshot import build_zeroshot_weights

    if cfg.data.zeroshot_weights:
        return (np.load(cfg.data.zeroshot_weights)["weights"]
                if cfg.data.zeroshot_weights.endswith(".npz")
                else np.load(cfg.data.zeroshot_weights))
    return cache.load_or_compute(
        "zeroshot", feature_cache_key(cfg, f"zw_{cfg.naming.corpus}"),
        lambda: {"weights": build_zeroshot_weights(
            encode_text, nouns, IMAGENET_TEMPLATES, mesh=mesh)})["weights"]


def _pipeline_mesh(cfg: PipelineConfig):
    """The pipeline's mesh (``scd_tpu/pipelines/common.py:462-471``): None
    on one rank that asks for no more (the single-device path), else
    ``make_mesh(cfg.mesh)`` over the world's ranks (which raises when the
    config asks for more ranks than were launched)."""
    if not multihost.is_multiprocess() and cfg.mesh.data <= 1 \
            and cfg.mesh.model <= 1:
        return None
    from scd_tpu_torch.core.mesh import make_mesh

    return make_mesh(cfg.mesh)


def _pod_shard(x, mesh):
    """THIS RANK's contiguous share of a value that every rank holds in
    full (the slicing half of the mesh fitters' contract: a row input is
    the rank's shard; the full array would count every row once per
    rank).  Ragged tails are fine: the fitters pad and mask."""
    if mesh is None:
        return x
    lo, hi = multihost.share_bounds(len(x), mesh.n_data, mesh.data_index)
    return x[lo:hi]


def run_clustering(cfg: PipelineConfig, feats: Dict[str, np.ndarray],
                   device="cuda", mesh=None) -> Dict[str, np.ndarray]:
    """Cluster per config (reference ``main_unsup.py:334-364``) on
    ``device``.  Returns the reference's cluster_result contract as numpy:
    all_preds (-1 on the labelled rows for KM and FINCH; SSKM and ConSSKM
    give the labelled rows their class ids), u_preds, u_targets, mask.

    With a ``mesh`` (``feats`` the same full dict on every rank) KM, SSKM
    and ConSSKM take this rank's share of the unlabelled rows
    (:func:`_pod_shard`) and the labelled rows in full, and return the
    full result on every rank; FINCH runs on the full unlabelled rows on
    every rank, as in the JAX package."""
    c = cfg.cluster
    mask_lab = feats["mask_lab"].astype(bool)
    mask_cls = feats["mask_cls"].astype(bool)
    targets = feats["targets"].astype(np.int64)
    u_targets = targets[~mask_lab]
    mask = mask_cls[~mask_lab]

    if c.algorithm not in ("KM", "SSKM", "ConSSKM", "FINCH"):
        raise ValueError(f"unknown cluster algorithm {c.algorithm!r}")

    over_ranks = mesh is not None and mesh.size > 1
    kw = {"mesh": mesh} if over_ranks and c.algorithm != "FINCH" else {}
    if kw:
        # every rank holds the features: each takes its unlabelled share
        all_np = feats["all_feats"]
        u_feats = _pod_shard(all_np[~mask_lab], mesh)
        l_feats = all_np[mask_lab]
    else:
        all_feats = tensors_from_arrays({"all_feats": feats["all_feats"]},
                                        device)["all_feats"]
        lab_t = torch.as_tensor(mask_lab, device=all_feats.device)
        u_feats, l_feats = all_feats[~lab_t], all_feats[lab_t]
    if c.algorithm in ("KM", "FINCH"):
        # the labelled rows keep -1
        preds = (fit_kmeans(u_feats, c, **kw).labels if c.algorithm == "KM"
                 else finch_fit(u_feats, req_clust=c.n_clusters))
        preds = preds.astype(np.int64)
        all_preds = np.full(len(mask_lab), -1, np.int64)
        all_preds[~mask_lab] = preds
    else:
        fit = fit_sskm if c.algorithm == "SSKM" else fit_constrained
        res = fit(u_feats, l_feats, targets[mask_lab], c, **kw)
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

