"""End-to-end (trunk-finetuning) baseline CLI: UNO v2 / AutoNovel over
images.

Port of ``scd_tpu/train/run_baseline_e2e.py``: the reference trains these
baselines through the backbone from a DataLoader (``uno_v2.py:96-160``,
``rerun_autonovel.py:42-110``); the frozen-feature variant is
``run_baseline``.  The JAX CLI's flags plus ``--device`` (``cuda`` unless
asked for ``cpu``); the same eval lines (``log_accs_from_preds`` every
epoch over the unlabelled train images), epoch lines and ``best:`` line.
``--remat 1`` recomputes the trunk blocks' activations in the backward
pass (``torch.utils.checkpoint``).

Data parallel over ranks: ``torchrun --nproc_per_node N -m
scd_tpu_torch.train.run_baseline_e2e --mesh_data N ...`` (0 = every
launched rank; ``--device cpu`` runs gloo ranks).  The batch size rounds
down to a multiple of N (printed, as the JAX CLI prints it), every rank
draws the same batch indices and decodes only its contiguous block
(``train/baselines_e2e.py`` holds the rest), and rank 0 alone prints.
Tensor parallel: ``torchrun --nproc_per_node D*M ... --mesh_data D
--mesh_model M`` (the world is data x model): each rank holds 1 / M of
the backbone's qkv, proj, fc1 and fc2, the M model ranks of a data index
take the same rows, and the batch rounds on D alone.

Run: ``python -m scd_tpu_torch.train.run_baseline_e2e --method uno
--dataset_name synthetic --vit micro --image_size 32 --epochs 2
[--device cpu]``.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from scd_tpu_torch.core import multihost
from scd_tpu_torch.core.config import DataConfig, MeshConfig, PipelineConfig
from scd_tpu_torch.data import get_class_splits, get_datasets, get_transform
from scd_tpu_torch.data.augment import ContrastiveViewGenerator
from scd_tpu_torch.metrics.cluster import log_accs_from_preds
from scd_tpu_torch.models.vit import ViTConfig
from scd_tpu_torch.pipelines.common import _pipeline_mesh, _pod_shard
from scd_tpu_torch.train.baselines_e2e import (train_autonovel_e2e,
                                               train_uno_e2e)
from scd_tpu_torch.train.metric_learn import _VIT_SIZES


def image_batches(merged, batch_size: int, n_views: int,
                  steps: int, num_workers: int = 8, mesh=None):
    """Batch factory for the streaming e2e trainers: yields view-stacked
    ``([V, B, H, W, C], labels [B], mask_lab [B])`` per step (the
    reference's DataLoader contract without materializing the dataset);
    over a ``mesh`` this rank's contiguous block of each batch's
    indices, the same draws on every rank."""

    def fetch(i: int):
        views, label, _uq, m = merged[int(i)]
        if not isinstance(views, (list, tuple)):
            views = [views] * n_views
        return views, int(label), bool(np.asarray(m).reshape(-1)[0])

    def make(epoch, rng):
        n = len(merged)
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            for _ in range(steps):
                idxs = _pod_shard(rng.choice(n, size=min(batch_size, n),
                                           replace=False), mesh)
                items = list(pool.map(fetch, idxs))
                views = np.stack([
                    np.stack([np.asarray(it[0][v], np.float32)
                              for it in items])
                    for v in range(n_views)])
                yield (views,
                       np.array([it[1] for it in items], np.int64),
                       np.array([it[2] for it in items], bool))

    return make


def _eval_meta(ds):
    """Labels + labelled-mask for the eval split.  MergedDataset exposes
    both as array properties (target_transform applied): reading them
    avoids decoding every image for its label; any other 4-tuple dataset
    falls back to the item loop."""
    if hasattr(ds, "targets") and hasattr(ds, "mask_lab"):
        return np.asarray(ds.targets), np.asarray(ds.mask_lab, bool)
    labels, masks = [], []
    for i in range(len(ds)):
        _x, y, _uq, m = ds[i]
        labels.append(int(y))
        masks.append(bool(np.asarray(m).reshape(-1)[0]))
    return np.array(labels), np.array(masks)


def _predict_indices(predict, ds, indices, batch_size: int = 256,
                     num_workers: int = 8):
    """Stream ``ds[idx]`` images through ``predict`` in batches (an
    ImageNet-scale eval split is ~78 GB as one f32 stack)."""
    preds = []
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for s in range(0, len(indices), batch_size):
            chunk = indices[s:s + batch_size]
            imgs = np.stack(list(pool.map(
                lambda i: np.asarray(ds[int(i)][0], np.float32), chunk)))
            preds.append(predict(imgs))
    return np.concatenate(preds)


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="e2e NCD baseline training")
    p.add_argument("--method", type=str, required=True,
                   help="uno | autonovel")
    p.add_argument("--dataset_name", type=str, default="synthetic")
    p.add_argument("--root_dir", type=str, default="/data")
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--prop_train_labels", type=float, default=0.5)
    p.add_argument("--vit", type=str, default="micro",
                   help="micro | tiny | small | base")
    p.add_argument("--patch_size", type=int, default=8)
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--steps_per_epoch", type=int, default=None)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--overcluster_factor", type=int, default=0)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--ckpt_dir", type=str, default="",
                   help="per-epoch checkpoints + best-by-acc tracking")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--remat", type=int, default=0,
                   help="recompute the trunk blocks' activations in the "
                        "backward pass (torch.utils.checkpoint)")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="data-parallel axis size (>1 jits the train step "
                        "with dp shardings; 0 = all visible devices)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel axis size for the backbone")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) | cpu")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    dev = multihost.maybe_initialize(args.device)
    with multihost.rank0_stdout():
        return _run(args, dev)


def _run(args, dev):
    mesh = _pipeline_mesh(PipelineConfig(
        mesh=MeshConfig(data=args.mesh_data, model=args.mesh_model)))
    if mesh is not None:
        d = mesh.n_data
        if args.batch_size % d:
            args.batch_size -= args.batch_size % d
            print(f"[e2e] batch_size rounded to {args.batch_size} "
                  f"(must split evenly over the {d}-way data axis)")

    data_cfg = DataConfig(dataset_name=args.dataset_name,
                          root_dir=args.root_dir,
                          image_size=args.image_size,
                          prop_train_labels=args.prop_train_labels)
    train_classes, unlabeled_classes = get_class_splits(data_cfg)
    n_lab, n_unlab = len(train_classes), len(unlabeled_classes)

    train_tf = ContrastiveViewGenerator(
        get_transform("imagenet", image_size=args.image_size, train=True,
                      seed=args.seed), n_views=2)
    test_tf = get_transform("imagenet", image_size=args.image_size)
    merged, _test, _unlab, _extras = get_datasets(
        data_cfg, train_transform=train_tf, test_transform=test_tf)
    merged_eval, _t2, _u2, _e2 = get_datasets(
        data_cfg, train_transform=test_tf, test_transform=test_tf)
    eval_labels, eval_mask_lab = _eval_meta(merged_eval)
    # labelled classes are remapped to 0..n_lab-1 (data/registry.py), so
    # the Old/New split is "id < n_lab"
    eval_mask_cls = eval_labels < n_lab
    eval_u_idx = np.flatnonzero(~eval_mask_lab)

    steps = args.steps_per_epoch or max(len(merged) // args.batch_size, 1)
    vit_cfg = ViTConfig(image_size=args.image_size,
                        patch_size=args.patch_size,
                        remat=bool(args.remat),
                        **_VIT_SIZES[args.vit])
    # sampling is driven by the trainer's rng (seeded via its seed kwarg)
    batches = image_batches(merged, args.batch_size, 2, steps,
                            args.num_workers, mesh)
    ckpt = None
    if args.ckpt_dir:
        from scd_tpu_torch.train.checkpoint import CheckpointManager

        ckpt = CheckpointManager(args.ckpt_dir, keep=2, best_metric="acc")

    def eval_fn(predict, epoch):
        u = ~eval_mask_lab
        preds = _predict_indices(predict, merged_eval, eval_u_idx,
                                 num_workers=args.num_workers)
        all_acc, old_acc, new_acc = log_accs_from_preds(
            y_true=eval_labels[u], y_pred=preds, mask=eval_mask_cls[u],
            eval_funcs=["v2"], T=epoch,
            save_name=f"{args.method}_e2e", print_output=True)
        return {"acc": all_acc, "old_acc": old_acc, "new_acc": new_acc}

    if args.method == "uno":
        state, predict, history = train_uno_e2e(
            args.seed, batches, n_labeled=n_lab, n_unlabeled=n_unlab,
            vit_cfg=vit_cfg, num_heads=args.num_heads, epochs=args.epochs,
            batch_size=args.batch_size, lr=args.lr,
            overcluster_factor=args.overcluster_factor,
            steps_per_epoch=steps, seed=args.seed, eval_fn=eval_fn,
            log_fn=print, ckpt=ckpt, mesh=mesh, device=dev)
    elif args.method == "autonovel":
        def an_batches(epoch, rng):
            for views, lab, m in batches(epoch, rng):
                yield views[0], views[1], lab, m

        state, predict, history = train_autonovel_e2e(
            args.seed, an_batches, n_labeled=n_lab, n_unlabeled=n_unlab,
            vit_cfg=vit_cfg, epochs=args.epochs,
            batch_size=args.batch_size, lr=args.lr, seed=args.seed,
            eval_fn=eval_fn, log_fn=print, ckpt=ckpt, mesh=mesh,
            device=dev)
    else:
        raise ValueError(f"unknown method {args.method!r}")

    print(f"best: {state['best']}")
    return state, history


if __name__ == "__main__":
    main()
