"""Partially-supervised SCD pipeline — the ``main_ptsup.py`` equivalent, in
PyTorch.

Port of ``scd_tpu/pipelines/ptsup.py``: the unsupervised pipeline's stages
(``pipelines/unsup.py``, ``pipelines/common.py``) plus (reference SURVEY
§3.2):

- the zero-shot sACC lower bound (full vocabulary) and upper bound
  (vocabulary restricted to the ground-truth names) before any voting
  (``main_ptsup.py:548-585``), each one streaming pass of the
  ``topk_softmax`` kernel at k = 1 over raw logits;
- labelled classes pin their ground-truth names; the voting loop runs only
  over unlabelled clusters with known-name pruning
  (``main_ptsup.py:629-705``).

The metric lines are byte-identical to the JAX package's.  Over several
ranks (``torchrun``) it shards as ``run_unsup`` does, ConSSKM included
(Sinkhorn track; the exact MCF track raises over ranks, as in the JAX
package); FINCH runs on every rank on the full rows.

Run: ``python -m scd_tpu_torch.pipelines.ptsup --dataset_name synthetic
--cluster ConSSKM --n_cluster 10 --cluster_size_min 5 --cluster_size_max 50
--device cpu`` (asset-free), or with the flags of ``pipelines/unsup.py``
on a cached root.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from scd_tpu_torch.core.cache import tensors_from_arrays
from scd_tpu_torch.core.config import PipelineConfig
from scd_tpu_torch.data import get_class_splits, get_datasets
from scd_tpu_torch.metrics import name_set_iou, split_cluster_acc_v2
from scd_tpu_torch.metrics.semantic import evaluate_soft_semantic_acc
from scd_tpu_torch.naming.classnames import (remap_cidx_to_cname,
                                             resolve_class_names)
from scd_tpu_torch.naming.loop import (gather_weight_columns,
                                       voting_loop_ptsup,
                                       voting_loop_ptsup_te)
from scd_tpu_torch.naming.templates import IMAGENET_TEMPLATES
from scd_tpu_torch.naming.vote import topk_names
from scd_tpu_torch.ops.topk import classify_topk
from scd_tpu_torch.pipelines.common import (
    cluster_cache_key,
    lazy_encoders,
    load_shared_features,
    load_zeroshot_weights,
    pipeline_transform,
    print_acc_block,
    run_clustering,
    stage_cache,
)
from scd_tpu_torch.pipelines.unsup import (
    build_argparser,
    build_encoders,
    config_from_args,
    load_vocabulary,
)


def zero_shot_preds(clip_feats: torch.Tensor, weights: torch.Tensor,
                    scale: float = 100.0, batch: int = 8192) -> np.ndarray:
    """Streaming zero-shot argmax over a (possibly huge) vocabulary, on the
    tensors' device.  Each chunk of ``batch`` rows is one
    ``classify_topk(k=1)`` call over raw logits, so on the card the
    ``topk_softmax`` kernel streams the vocabulary and the [N, V] logits
    never exist (127k x 68k f32 would be ~34 GB).  The JAX package pads
    the last chunk only to reuse one compiled program; a padded row cannot
    change another row's argmax, so the port does not pad."""
    n = clip_feats.shape[0]
    if n == 0:  # degenerate split (all rows labelled): no rows to predict
        return np.zeros(0, np.int64)
    preds = []
    for i in range(0, n, batch):
        _, idx = classify_topk(clip_feats[i:i + batch], weights, k=1,
                               scale=scale, apply_softmax=False)
        preds.append(idx[:, 0].cpu().numpy())
    return np.concatenate(preds).astype(np.int64)


def _top1_acc(preds: np.ndarray, targets: np.ndarray,
              cidx_to_cname: Dict[int, str], names: Sequence[str]) -> float:
    name_to_idx = {n: i for i, n in enumerate(names)}
    gt = np.array([name_to_idx[cidx_to_cname[int(t)]] for t in targets])
    return float((preds == gt).mean() * 100.0)


def zero_shot_top1(clip_feats: torch.Tensor, targets: np.ndarray,
                   cidx_to_cname: Dict[int, str], names: Sequence[str],
                   weights: torch.Tensor, scale: float = 100.0) -> float:
    """Zero-shot top-1 accuracy of CLIP features against a name list
    (reference ``evaluate_semantic_acc_ub_lb``, ``main_ptsup.py:102-129``)."""
    preds = zero_shot_preds(clip_feats, weights, scale=scale)
    return _top1_acc(preds, targets, cidx_to_cname, names)


def soft_sacc_bounds(clip_u: torch.Tensor, u_targets: np.ndarray,
                     mask: np.ndarray, cidx_to_cname: Dict[int, str],
                     nouns: Sequence[str], weights: torch.Tensor,
                     name_similarity, scale: float = 100.0,
                     lb_preds: Optional[np.ndarray] = None,
                     ub_preds: Optional[np.ndarray] = None) -> Dict:
    """Soft-sACC lower/upper bound block (``main_ptsup.py:564-585``).

    LB: zero-shot preds over the full vocabulary scored with soft-sACC.
    UB: vocabulary restricted to the ground-truth class names; also prints
    the number of distinct predictions and the "clip ACC" split-v2 line the
    reference emits in the same block (``main_ptsup.py:578-580``).  Each
    all/old/new subset normalizes by its own batch max, like the
    reference's per-call normalization.  ``lb_preds``/``ub_preds``: the
    two passes already made by the sACC bound block, reused when given.
    """
    out: Dict = {}

    def _soft3(preds: np.ndarray, cand: Sequence[str]):
        vals = []
        for sel in (np.ones(len(preds), bool), mask, ~mask):
            if sel.sum() == 0:
                vals.append(float("nan"))
                continue
            vals.append(evaluate_soft_semantic_acc(
                u_targets[sel], cidx_to_cname, preds[sel], cand,
                name_similarity))
        return tuple(vals)

    print("=====Soft sACC lower bound=====")
    if lb_preds is None:
        lb_preds = zero_shot_preds(clip_u, weights, scale=scale)
    s_all, s_old, s_new = _soft3(lb_preds, nouns)
    print(f"Soft sACC all {s_all},sACC old {s_old}, sACC new {s_new}")
    out["soft_lb"] = (s_all, s_old, s_new)

    print("=====Soft sACC upper bound=====")
    cand = [n.lower().replace("-", "_") for n in cidx_to_cname.values()]
    if ub_preds is None:
        noun_cols = {n: i for i, n in enumerate(nouns)}
        zw_sel = gather_weight_columns(weights, [noun_cols[n] for n in cand])
        ub_preds = zero_shot_preds(clip_u, zw_sel, scale=scale)
    print(len(set(ub_preds.tolist())))
    all_acc, old_acc, new_acc = split_cluster_acc_v2(u_targets, ub_preds, mask)
    print(f"clip ACC: All {all_acc} | Old {old_acc} | New {new_acc}")
    out["clip_acc"] = (all_acc, old_acc, new_acc)
    s_all, s_old, s_new = _soft3(ub_preds, cand)
    print(f"Soft sACC all {s_all},sACC old {s_old}, sACC new {s_new}")
    out["soft_ub"] = (s_all, s_old, s_new)
    return out


def run_ptsup(cfg: PipelineConfig, device="cuda") -> Dict:
    """The partially supervised pipeline on ``device`` (``"cuda"`` unless
    the caller asks for ``"cpu"``; no card raises).  Returns the JAX
    package's result dict plus ``stage_seconds`` (host clock per stage;
    each stage ends in a host fetch, so the times include the device
    work).  Over several ranks as ``pipelines/unsup.py::run_unsup``."""
    from scd_tpu_torch.core.multihost import maybe_initialize, rank0_stdout

    dev = maybe_initialize(device)
    with rank0_stdout():
        return _run_ptsup(cfg, dev)


def _run_ptsup(cfg: PipelineConfig, dev) -> Dict:
    from scd_tpu_torch.pipelines.common import _pipeline_mesh

    stage_seconds: Dict[str, float] = {}
    t0 = time.perf_counter()
    cache = stage_cache(cfg)
    train_classes, unlabeled_classes = get_class_splits(cfg.data)
    tf = pipeline_transform(cfg)
    train_merged, _test, _unlab, extras = get_datasets(
        cfg.data, train_transform=tf, test_transform=tf)
    # the encoders build lazily: a fully cached run loads no weights
    mesh = _pipeline_mesh(cfg)
    feat_encode, clip_encode, encode_text = lazy_encoders(
        lambda: build_encoders(cfg, extras, device=dev, mesh=mesh))
    stage_seconds["load"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    feats, clip_feats = load_shared_features(
        cfg, cache, feat_encode, clip_encode, train_merged, train_classes)
    stage_seconds["features"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cluster_result = cache.load_or_compute(
        "cluster", cluster_cache_key(cfg),
        lambda: run_clustering(cfg, feats, device=dev, mesh=mesh),
        refresh=cfg.run_cluster)
    stage_seconds["cluster"] = time.perf_counter() - t0

    all_preds = cluster_result["all_preds"].astype(np.int64)
    u_preds = cluster_result["u_preds"].astype(np.int64)
    u_targets = cluster_result["u_targets"].astype(np.int64)
    mask = cluster_result["mask"].astype(bool)

    t0 = time.perf_counter()
    nouns, taxonomy = load_vocabulary(cfg, extras)
    stage_seconds["vocabulary"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    zw_np = load_zeroshot_weights(cfg, cache, encode_text, nouns, mesh=mesh)
    zw = tensors_from_arrays({"weights": zw_np}, dev)["weights"]
    cidx_to_cname = remap_cidx_to_cname(
        resolve_class_names(
            cfg.data.dataset_name, extras, nouns, zw_np, encode_text,
            IMAGENET_TEMPLATES,
            wnid_to_name=taxonomy.wnid_to_name if taxonomy else None,
            corpus=cfg.naming.corpus),
        train_classes, unlabeled_classes)
    mask_lab = clip_feats["mask_lab"].astype(bool)
    clip_u = tensors_from_arrays(
        {"all_feats": clip_feats["all_feats"][~mask_lab]}, dev)["all_feats"]
    stage_seconds["zeroshot"] = time.perf_counter() - t0

    # ---- sACC bounds (reference main_ptsup.py:548-561).  Each pass
    # streams the [N, V] logits once; the all/old/new splits and the
    # soft-sACC block below reuse the same two passes.
    t0 = time.perf_counter()
    noun_cols = {n: i for i, n in enumerate(nouns)}
    print("=====sACC lower bound=====")
    lb_preds = zero_shot_preds(clip_u, zw)
    lb_all = _top1_acc(lb_preds, u_targets, cidx_to_cname, nouns)
    lb_old = _top1_acc(lb_preds[mask], u_targets[mask], cidx_to_cname, nouns)
    lb_new = _top1_acc(lb_preds[~mask], u_targets[~mask], cidx_to_cname,
                       nouns)
    print(f"sACC all {lb_all},sACC old {lb_old}, sACC new {lb_new}")

    print("=====sACC upper bound=====")
    gt_cand = [n.lower().replace("-", "_") for n in cidx_to_cname.values()]
    zw_gt = gather_weight_columns(zw, [noun_cols[n] for n in gt_cand])
    ub_preds = zero_shot_preds(clip_u, zw_gt)
    ub_all = _top1_acc(ub_preds, u_targets, cidx_to_cname, gt_cand)
    ub_old = _top1_acc(ub_preds[mask], u_targets[mask], cidx_to_cname,
                       gt_cand)
    ub_new = _top1_acc(ub_preds[~mask], u_targets[~mask], cidx_to_cname,
                       gt_cand)
    print(f"sACC all {ub_all},sACC old {ub_old}, sACC new {ub_new}")

    # ---- Soft-sACC LB/UB + clip ACC (reference main_ptsup.py:564-585,
    # gated off for CUB like the reference's `if 'cub' != ...`)
    name_sim = taxonomy.name_similarity if taxonomy else None
    if name_sim is None and cfg.data.dataset_name == "synthetic":
        from scd_tpu_torch.models.synthetic import synthetic_name_similarity

        name_sim = synthetic_name_similarity
    eval_soft = cfg.eval_soft_sacc and cfg.data.dataset_name != "cub"
    soft_bounds = None
    if eval_soft and name_sim is not None:
        soft_bounds = soft_sacc_bounds(clip_u, u_targets, mask, cidx_to_cname,
                                       nouns, zw, name_sim,
                                       scale=cfg.naming.logit_scale,
                                       lb_preds=lb_preds, ub_preds=ub_preds)
    stage_seconds["bounds"] = time.perf_counter() - t0

    # ---- clustering ACC + voting (reference main_ptsup.py:588-705); only
    # the unlabelled rows vote
    t0 = time.perf_counter()
    name_idx_u, _ = topk_names(clip_u, zw, cfg.naming.topk,
                               scale=cfg.naming.logit_scale)
    stage_seconds["topk"] = time.perf_counter() - t0

    all_acc, old_acc, new_acc = split_cluster_acc_v2(u_targets, u_preds, mask)
    print(f"{cfg.cluster.algorithm} Accuracies: All {all_acc} | Old {old_acc} "
          f"| New {new_acc}")

    gt_names = list(cidx_to_cname.values())
    lab_names = [gt_names[c] for c in range(len(train_classes))]
    l_preds = all_preds[mask_lab]
    lab_cluster_idx = sorted(set(l_preds.tolist()))
    unlab_cluster_idx = sorted(set(u_preds.tolist()) - set(lab_cluster_idx))

    def metrics_cb(it: int, preds: np.ndarray, cand_names: List[str]) -> Dict:
        print(f"iter: {it}")
        return print_acc_block("vote", u_targets, preds, mask, cidx_to_cname,
                               cand_names, name_similarity=name_sim,
                               eval_soft=eval_soft)

    t0 = time.perf_counter()
    result = voting_loop_ptsup(nouns, name_idx_u, clip_u, zw, u_preds,
                               unlab_cluster_idx, lab_names,
                               cfg.cluster.n_clusters, cfg.naming,
                               metrics_cb=metrics_cb)

    if cfg.naming.textual_enhancement:
        print("-- textual enhancement round --")
        result = voting_loop_ptsup_te(nouns, name_idx_u, clip_u, zw, result,
                                      lab_names, cfg.cluster.n_clusters,
                                      cfg.naming, alpha=cfg.naming.te_alpha,
                                      metrics_cb=metrics_cb)
    stage_seconds["voting"] = time.perf_counter() - t0

    iou = name_set_iou(result.cand_names, gt_names)
    print(f"IoU: {iou}")
    return {"bounds": {"lb": (lb_all, lb_old, lb_new),
                       "ub": (ub_all, ub_old, ub_new)},
            "soft_bounds": soft_bounds,
            "cluster_acc": (all_acc, old_acc, new_acc),
            "voting": result, "iou": iou,
            "cidx_to_cname": cidx_to_cname,
            "stage_seconds": stage_seconds}


def main(argv=None):
    args = build_argparser().parse_args(argv)
    cfg = config_from_args(args, partially_supervised=True)
    return run_ptsup(cfg, device=args.device)


if __name__ == "__main__":
    main()
