"""K-means evaluation runners over feature datasets.

Port of ``scd_tpu/cluster/runners.py`` (reference
``gcd/methods/clustering/k_means.py`` and ``k_means_stratified.py``):
plain k-means, semi-supervised k-means and the ground-truth-centroid upper
bound over a feature store, with ACC printed by the reference's v1/v2/v3
variants, optionally per SSB difficulty stratum.

The upper bound is a segment mean and one nearest-center assignment
(``ops.distance.estep_assign``: the ``csrc/estep.cu`` kernel on a CUDA
device, its plain version on the CPU); clustering goes through
``fit_kmeans`` / ``fit_sskm`` (the fused-EM kernel on a CUDA device).
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The k-means++ draws come from a ``torch.Generator`` seeded with the
config's seed, not from ``jax.random``.

As in the JAX package, the stratified mask selects unlabelled instances
whose target class belongs to the stratum (the reference's mask selects
nothing, ``k_means_stratified.py:139``).

Run: ``python -m scd_tpu_torch.cluster.runners --features store.npz
--n_train_classes 50 --optimal [--device cpu]``.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from scd_tpu_torch.cluster.kmeans import (KMeansResult, _device_f32,
                                          fit_kmeans, fit_sskm)
from scd_tpu_torch.core.config import ClusterConfig
from scd_tpu_torch.core.device import resolve_device
from scd_tpu_torch.metrics.cluster import log_accs_from_preds
from scd_tpu_torch.ops.distance import estep_assign
from scd_tpu_torch.ops.segment import segment_sums


def _normalize_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True),
                               1e-12)


def collate_features(dataset, n_train_classes: int, batch_size: int = 512,
                     num_workers: int = 8, normalize: bool = True,
                     device="cuda"
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Collate a feature dataset (``FeatureVectorDataset`` contract:
    (feat, label, uq[, mask_lab]) items) into arrays.

    Returns (feats [N, D] f32 L2-normalized on ``device``, targets [N] i64,
    mask_cls [N] bool — target in the first ``n_train_classes`` transformed
    ids, mask_lab [N] bool), all numpy."""
    from scd_tpu_torch.data.loader import iterate_batches

    feats, targets, masks_lab = [], [], []
    for batch in iterate_batches(dataset, batch_size,
                                 num_workers=num_workers):
        x, label, _uq, mask_lab = batch
        feats.append(np.asarray(x, np.float32))
        targets.append(np.asarray(label, np.int64))
        masks_lab.append(np.asarray(mask_lab, bool))
    x = np.concatenate(feats)
    targets = np.concatenate(targets)
    mask_lab = np.concatenate(masks_lab)
    if normalize:
        x = _normalize_rows(_device_f32(x, resolve_device(device)))
        x = x.cpu().numpy()
    mask_cls = targets < n_train_classes
    return x, targets, mask_cls, mask_lab


def eval_kmeans(feats, targets: np.ndarray, mask_cls: np.ndarray,
                cfg: ClusterConfig,
                eval_funcs: Sequence[str] = ("v1", "v2", "v3"),
                save_name: str = "Train ACC Unlabelled", writer=None,
                print_output: bool = True, device="cuda"
                ) -> Tuple[float, float, float, KMeansResult]:
    """Plain k-means over all features, ACC on everything
    (reference ``test_kmeans``, ``k_means.py:25-68``)."""
    res = fit_kmeans(feats, cfg, device=resolve_device(device))
    all_acc, old_acc, new_acc = log_accs_from_preds(
        y_true=targets, y_pred=res.labels, mask=mask_cls,
        eval_funcs=eval_funcs, save_name=save_name, writer=writer,
        print_output=print_output)
    return all_acc, old_acc, new_acc, res


def eval_kmeans_semi_sup(feats, targets: np.ndarray, mask_cls: np.ndarray,
                         mask_lab: np.ndarray, cfg: ClusterConfig,
                         eval_funcs: Sequence[str] = ("v1", "v2", "v3"),
                         save_name: str = "SS-K-Means Train ACC Unlabelled",
                         writer=None, print_output: bool = True,
                         device="cuda"):
    """Semi-supervised k-means over the merged labelled+unlabelled set;
    ACC on the unlabelled portion (reference ``test_kmeans_semi_sup``,
    ``k_means.py:70-138``).

    Returns (all_acc, old_acc, new_acc, u_preds, KMeansResult).
    """
    mask_lab = np.asarray(mask_lab, bool)
    x = _device_f32(feats, resolve_device(device))
    lab_idx = torch.as_tensor(np.flatnonzero(mask_lab), device=x.device)
    unl_idx = torch.as_tensor(np.flatnonzero(~mask_lab), device=x.device)
    res = fit_sskm(x[unl_idx], x[lab_idx], targets[mask_lab], cfg)
    # fit_sskm returns labels labelled-first, then unlabelled.
    n_lab = int(mask_lab.sum())
    u_preds = res.labels[n_lab:]
    u_targets = targets[~mask_lab]
    mask = mask_cls[~mask_lab]
    all_acc, old_acc, new_acc = log_accs_from_preds(
        y_true=u_targets, y_pred=u_preds, mask=mask, eval_funcs=eval_funcs,
        save_name=save_name, writer=writer, print_output=print_output)
    return all_acc, old_acc, new_acc, u_preds, res


def _gt_centroid_assign(x: torch.Tensor, dense_targets: torch.Tensor,
                        n_classes: int) -> torch.Tensor:
    sums, counts = segment_sums(x, dense_targets, n_classes)
    centers = sums / torch.clamp_min(counts, 1.0)[:, None]
    labels, _d = estep_assign(x, centers)
    return labels


def eval_kmeans_optimal(feats, targets: np.ndarray, mask_cls: np.ndarray,
                        mask_lab: np.ndarray,
                        eval_funcs: Sequence[str] = ("v1", "v2", "v3"),
                        save_name: str = "Optimal K-Means Train ACC Unlabelled",
                        writer=None, print_output: bool = True,
                        device="cuda"):
    """Assign every instance to its nearest ground-truth class centroid —
    the k-means upper bound (reference ``test_kmeans_optimal``,
    ``k_means.py:141-206``).  Returns (all, old, new, u_preds)."""
    dev = resolve_device(device)
    mask_lab = np.asarray(mask_lab, bool)
    classes, dense = np.unique(np.asarray(targets, np.int64),
                               return_inverse=True)
    labels = _gt_centroid_assign(
        _device_f32(feats, dev),
        torch.as_tensor(dense.reshape(-1).astype(np.int64), device=dev),
        len(classes)).cpu().numpy()
    u_preds = labels[~mask_lab]
    u_targets = targets[~mask_lab]
    mask = mask_cls[~mask_lab]
    all_acc, old_acc, new_acc = log_accs_from_preds(
        y_true=u_targets, y_pred=u_preds, mask=mask, eval_funcs=eval_funcs,
        save_name=save_name, writer=writer, print_output=print_output)
    return all_acc, old_acc, new_acc, u_preds


# ------------------------------------------------------- stratified (SSB)

def load_ssb_difficulty_splits(dataset_name: str, ssb_dir: str
                               ) -> Dict[str, list]:
    """{'Easy'|'Medium'|'Hard': [original class ids]} from the SSB pickle
    (reference ``get_fgvc_osr_class_splits``,
    ``k_means_stratified.py:28-52``)."""
    path = os.path.join(ssb_dir, f"{dataset_name}_osr_splits.pkl")
    with open(path, "rb") as f:
        info = pickle.load(f)
    return info["unknown_classes"]


def stratified_accs(u_targets: np.ndarray, u_preds: np.ndarray,
                    mask: np.ndarray,
                    difficulty_classes: Dict[str, Iterable[int]],
                    train_classes: Sequence[int],
                    unlabeled_classes: Sequence[int],
                    eval_funcs: Sequence[str] = ("v1", "v2", "v3"),
                    writer=None, print_output: bool = True
                    ) -> Dict[str, Tuple[float, float, float]]:
    """Report ACC per SSB difficulty stratum over the unlabelled set
    (reference ``k_means_stratified.py:125-151``; see the module docstring
    for the mask).  ``difficulty_classes`` holds ORIGINAL class ids;
    targets are transformed (train_classes first, then
    unlabeled_classes), so they map through the same target transform the
    datasets applied."""
    to_transformed = {cls: i for i, cls in
                      enumerate(list(train_classes) + list(unlabeled_classes))}
    u_targets = np.asarray(u_targets, np.int64)
    u_preds = np.asarray(u_preds, np.int64)
    mask = np.asarray(mask, bool)
    out: Dict[str, Tuple[float, float, float]] = {}
    for diff in ("Easy", "Medium", "Hard"):
        tcls = np.array([to_transformed[c] for c in difficulty_classes[diff]
                         if c in to_transformed], np.int64)
        diff_mask = np.isin(u_targets, tcls)
        if not diff_mask.any():
            out[diff] = (float("nan"),) * 3
            continue
        out[diff] = log_accs_from_preds(
            y_true=u_targets[diff_mask], y_pred=u_preds[diff_mask],
            mask=mask[diff_mask], eval_funcs=eval_funcs,
            save_name=f"Train ACC Unlabelled {diff}", writer=writer,
            print_output=print_output)
    return out


def eval_kmeans_semi_sup_stratified(
        feats, targets: np.ndarray, mask_cls: np.ndarray,
        mask_lab: np.ndarray, cfg: ClusterConfig,
        difficulty_classes: Dict[str, Iterable[int]],
        train_classes: Sequence[int], unlabeled_classes: Sequence[int],
        eval_funcs: Sequence[str] = ("v1", "v2", "v3"),
        writer=None, print_output: bool = True, device="cuda"):
    """SSKM + overall ACC + per-difficulty ACC (reference
    ``k_means_stratified.py:54-151``).  Returns (overall triple,
    {difficulty: triple}, u_preds)."""
    all_acc, old_acc, new_acc, u_preds, _res = eval_kmeans_semi_sup(
        feats, targets, mask_cls, mask_lab, cfg, eval_funcs=eval_funcs,
        save_name="SS-K-Means All Data Train ACC", writer=writer,
        print_output=print_output, device=device)
    mask_lab = np.asarray(mask_lab, bool)
    strata = stratified_accs(targets[~mask_lab], u_preds,
                             mask_cls[~mask_lab], difficulty_classes,
                             train_classes, unlabeled_classes,
                             eval_funcs=eval_funcs, writer=writer,
                             print_output=print_output)
    return (all_acc, old_acc, new_acc), strata, u_preds


def main(argv=None):
    """CLI covering the reference's ``k_means.py`` and
    ``k_means_stratified.py`` __main__ blocks: run (semi-sup) k-means over a
    packed feature store and report ACC (optionally stratified)."""
    p = argparse.ArgumentParser(description="K-means feature evaluation")
    p.add_argument("--features", type=str, required=True,
                   help="npz with features/targets/mask_lab arrays")
    p.add_argument("--K", type=int, default=None)
    p.add_argument("--n_train_classes", type=int, required=True)
    p.add_argument("--semi_sup", action="store_true")
    p.add_argument("--optimal", action="store_true",
                   help="ground-truth-centroid upper bound")
    p.add_argument("--max_kmeans_iter", type=int, default=100)
    p.add_argument("--n_init", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_funcs", nargs="+", default=["v1", "v2", "v3"])
    p.add_argument("--dataset_name", type=str, default=None,
                   help="with --ssb_dir: report SSB-stratified ACC")
    p.add_argument("--ssb_dir", type=str, default=None)
    p.add_argument("--n_classes_total", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) | cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    with np.load(args.features) as z:
        feats = np.asarray(z["features"], np.float32)
        targets = np.asarray(z["targets"], np.int64)
        mask_lab = (np.asarray(z["mask_lab"], bool) if "mask_lab" in z
                    else np.zeros(len(targets), bool))
    feats = _normalize_rows(_device_f32(feats, dev))
    mask_cls = targets < args.n_train_classes
    k = args.K or (args.n_classes_total or int(targets.max()) + 1)
    cfg = ClusterConfig(n_clusters=k, n_init=args.n_init,
                        max_iterations=args.max_kmeans_iter, seed=args.seed)

    if args.optimal:
        return eval_kmeans_optimal(feats, targets, mask_cls, mask_lab,
                                   eval_funcs=args.eval_funcs, device=dev)
    if args.dataset_name and args.ssb_dir:
        diff = load_ssb_difficulty_splits(args.dataset_name, args.ssb_dir)
        n_total = args.n_classes_total or int(targets.max()) + 1
        return eval_kmeans_semi_sup_stratified(
            feats, targets, mask_cls, mask_lab, cfg, diff,
            train_classes=range(args.n_train_classes),
            unlabeled_classes=range(args.n_train_classes, n_total),
            eval_funcs=args.eval_funcs, device=dev)
    if args.semi_sup:
        return eval_kmeans_semi_sup(feats, targets, mask_cls, mask_lab,
                                    cfg, eval_funcs=args.eval_funcs,
                                    device=dev)
    return eval_kmeans(feats, targets, mask_cls, cfg,
                       eval_funcs=args.eval_funcs, device=dev)


if __name__ == "__main__":
    main()
