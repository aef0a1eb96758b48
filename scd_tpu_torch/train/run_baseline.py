"""Baseline-method CLI: UNO v2, AutoNovel, supervised + combine.

Port of ``scd_tpu/train/run_baseline.py`` (the reference launchers
``gcd/bash_scripts/uno_v2_gcd.sh``, ``autonovel_gcd.sh``,
``train_supervised_classifer.sh`` and the evaluation in
``combine_classifier_and_kmeans.py``) over a packed feature store
(``features_packed.npz``: the GCD-setting frozen backbone + trained
heads).  The JAX CLI's flags plus ``--device`` (``cuda`` unless asked for
``cpu``); the same lines printed (``final loss`` and the ACC line).  The
supervised method's cluster assignment is ``fit_sskm`` (or ``fit_kmeans``
with ``--combine_cluster km``), the fused-EM kernel on a CUDA device; its
k-means++ draws come from a ``torch.Generator`` seeded with ``--seed``,
not from ``jax.random``.

Run: ``python -m scd_tpu_torch.train.run_baseline --method uno
--features feats/train/features_packed.npz --n_labeled 5 [--device cpu]``.
"""

from __future__ import annotations

import argparse

import numpy as np

from scd_tpu_torch.core.device import resolve_device
from scd_tpu_torch.metrics.cluster import log_accs_from_preds
from scd_tpu_torch.train.baselines import (
    combine_classifier_and_cluster_preds,
    osr_threshold_preds,
    train_autonovel,
    train_supervised,
    train_uno,
)


def _views(feats: np.ndarray, noise: float, seed: int, n: int = 2):
    rng = np.random.default_rng(seed)
    return np.stack([feats + noise * rng.standard_normal(feats.shape)
                     .astype(np.float32) for _ in range(n)])


def _combine_cluster_preds(seed: int, feats, targets, mask_lab,
                           n_labeled: int, n_unlab_cls: int,
                           backend: str = "sskm", device="cuda"):
    """Cluster assignment the classifier is combined with.  The reference
    pairs the classifier with the SEMI-SUPERVISED k-means predictions
    (``combine_classifier_and_kmeans.py:46-121``): labelled instances pin
    the Old-class centroids, so Old clusters keep their true class ids.
    ``backend="km"`` keeps the plain-k-means variant (cluster ids offset
    past the labelled range: a pure New-class assignment)."""
    from scd_tpu_torch.cluster import fit_kmeans, fit_sskm
    from scd_tpu_torch.core.config import ClusterConfig

    k = n_labeled + n_unlab_cls
    cfg = ClusterConfig(n_clusters=k, n_init=3, max_iterations=50,
                        seed=seed)
    if backend == "sskm" and mask_lab.any():
        res = fit_sskm(feats[~mask_lab], feats[mask_lab],
                       targets[mask_lab], cfg, device=device)
        n_lab = int(mask_lab.sum())
        out = np.empty(len(feats), np.int64)
        out[mask_lab] = res.labels[:n_lab]
        out[~mask_lab] = res.labels[n_lab:]
        # fit_sskm compresses labelled targets through np.unique: cluster
        # id i is the i-th PRESENT class.  Map pinned clusters back to their
        # true class ids and shift the free clusters past the Old block so
        # the combine's `< n_labeled` test stays meaningful even when some
        # labelled class has no labelled instances.
        classes = np.unique(targets[mask_lab])
        n_present = len(classes)
        remap = np.concatenate([
            classes,
            n_labeled + np.arange(k - n_present)]).astype(np.int64)
        return remap[out]
    km = fit_kmeans(feats, cfg, device=device)
    return km.labels + n_labeled


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="NCD baseline training")
    p.add_argument("--method", type=str, required=True,
                   help="uno | autonovel | supervised")
    p.add_argument("--features", type=str, required=True,
                   help="features_packed.npz with features/targets/mask_lab")
    p.add_argument("--n_labeled", type=int, required=True)
    p.add_argument("--n_unlabeled", type=int, default=None)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--view_noise", type=float, default=0.05,
                   help="gaussian feature-space augmentation for views")
    p.add_argument("--osr_threshold", type=float, default=0.5)
    p.add_argument("--combine_cluster", type=str, default="sskm",
                   help="sskm (reference default: Old centroids pinned by "
                        "labelled data) | km (plain k-means)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_funcs", nargs="+", default=["v2"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) | cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = resolve_device(args.device)

    with np.load(args.features) as z:
        feats = np.asarray(z["features"], np.float32)
        targets = np.asarray(z["targets"], np.int64)
        mask_lab = (np.asarray(z["mask_lab"], bool) if "mask_lab" in z
                    else np.zeros(len(targets), bool))
    feats = feats / np.maximum(
        np.linalg.norm(feats, axis=1, keepdims=True), 1e-12)
    n_unlab_cls = args.n_unlabeled or int(targets.max()) + 1 - args.n_labeled
    mask_cls = targets < args.n_labeled
    batch = min(args.batch_size, len(feats))

    if args.method == "uno":
        views = _views(feats, args.view_noise, args.seed)
        _model, predict, history = train_uno(
            args.seed, views, targets, mask_lab, args.n_labeled, n_unlab_cls,
            num_heads=args.num_heads, epochs=args.epochs, batch_size=batch,
            lr=args.lr, seed=args.seed, device=dev)
        preds = predict(feats).cpu().numpy()
    elif args.method == "autonovel":
        views = _views(feats, args.view_noise, args.seed)
        _model, predict, history = train_autonovel(
            args.seed, views[0], views[1], targets, mask_lab, args.n_labeled,
            n_unlab_cls, epochs=args.epochs, batch_size=batch, lr=args.lr,
            seed=args.seed, device=dev)
        # head1 spans all classes (labelled first): ids are already global
        preds = predict(feats).cpu().numpy()
    elif args.method == "supervised":
        lab_feats, lab_targets = feats[mask_lab], targets[mask_lab]
        _model, logits_fn, history = train_supervised(
            args.seed, lab_feats, lab_targets, args.n_labeled,
            epochs=args.epochs, batch_size=min(batch, len(lab_feats)),
            lr=args.lr, seed=args.seed, device=dev)
        cls_preds = osr_threshold_preds(logits_fn(feats),
                                        args.osr_threshold).cpu().numpy()
        cluster_preds = _combine_cluster_preds(
            args.seed, feats, targets, mask_lab, args.n_labeled, n_unlab_cls,
            backend=args.combine_cluster, device=dev)
        preds = combine_classifier_and_cluster_preds(
            cls_preds, cluster_preds, args.n_labeled)
    else:
        raise ValueError(f"unknown method {args.method!r}")

    print(f"final loss: {history[-1]:.4f}")
    u = ~mask_lab
    accs = log_accs_from_preds(
        y_true=targets[u], y_pred=preds[u], mask=mask_cls[u],
        eval_funcs=args.eval_funcs,
        save_name=f"{args.method} Train ACC Unlabelled", print_output=True)
    return accs, history


if __name__ == "__main__":
    main()
