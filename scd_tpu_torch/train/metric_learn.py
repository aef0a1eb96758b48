"""GCD contrastive finetuning entry point.

Port of ``scd_tpu/train/metric_learn.py`` (reference
``gcd/methods/metric_learn/learn_metric.py:386-521``): build the merged
labelled / unlabelled train set with a two-view contrastive transform,
balance labelled and unlabelled sampling (:496-500), finetune the last
ViT blocks with (1-w) InfoNCE + w SupCon, run a semi-supervised k-means
eval every epoch (:341-383; ``cluster.runners``, so ``fused_em_step`` on
a CUDA device), checkpoint every epoch and keep the best by old-class
test ACC (:320-338).

Run: ``python -m scd_tpu_torch.train.metric_learn --dataset_name
synthetic --epochs 1 --vit micro --image_size 32 [--device cpu]``; the
JAX CLI's flags plus ``--device`` (``cuda`` unless asked for ``cpu``).

Data parallel over ranks: ``torchrun --nproc_per_node N -m
scd_tpu_torch.train.metric_learn --mesh_data N ...`` (0 = every launched
rank; ``--device cpu`` runs gloo ranks).  Every rank draws the same
global batch indices from the seeded sampler and decodes and augments
only its own contiguous block of B / N rows (the host augmentation bounds
this trainer), the step gathers the projections over the ranks
(``train/gcd.py``), the per-epoch eval extracts each rank's share of the
splits and gathers the features, and rank 0 alone prints and writes the
run directory and the checkpoints.

Tensor parallel: ``torchrun --nproc_per_node D*M -m
scd_tpu_torch.train.metric_learn --mesh_data D --mesh_model M ...`` (the
world is data x model; ``train/gcd.py``): each rank holds 1 / M of the
backbone's qkv, proj, fc1 and fc2 and of the head's fc1 and fc2, the M
model ranks of a data index decode the same block, and the checkpoints
hold full tensors, gathered over the model group.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from scd_tpu_torch.cluster.runners import eval_kmeans, eval_kmeans_semi_sup
from scd_tpu_torch.core import multihost
from scd_tpu_torch.core.config import (ClusterConfig, DataConfig, MeshConfig,
                                       PipelineConfig, TrainConfig)
from scd_tpu_torch.data import get_class_splits, get_datasets, get_transform
from scd_tpu_torch.data.augment import ContrastiveViewGenerator
from scd_tpu_torch.data.loader import iterate_batches
from scd_tpu_torch.models.vit import ViTConfig
from scd_tpu_torch.pipelines.common import (_pipeline_mesh, _pod_shard,
                                            _RowRange)
from scd_tpu_torch.train.checkpoint import CheckpointManager
from scd_tpu_torch.train.gcd import GCDTrainer
from scd_tpu_torch.utils.experiment import (follow_experiment,
                                            init_experiment)

_VIT_SIZES = {
    "tiny": dict(width=192, depth=12, heads=3),
    "small": dict(width=384, depth=12, heads=6),
    "base": dict(width=768, depth=12, heads=12),
    # sub-tiny smoke config for synthetic runs
    "micro": dict(width=64, depth=2, heads=2),
}


def balanced_batches(merged, batch_size: int, n_views: int, seed: int,
                     steps_per_epoch: Optional[int] = None,
                     num_workers: int = 8, mesh=None) -> Iterator[dict]:
    """Sample labelled and unlabelled instances with equal total mass
    (reference ``WeightedRandomSampler`` balancing,
    ``learn_metric.py:496-500``; the JAX package's numpy draws) and
    collate view-major batches.  Over a ``mesh`` every rank draws the
    same global indices and collates only its contiguous block of them
    (``batch_size`` must divide by the ``data`` axis)."""
    n = len(merged)
    lab_flags = merged.mask_lab  # MergedDataset is labelled-first
    n_lab = int(lab_flags.sum())
    w = np.where(lab_flags, 1.0 / max(n_lab, 1), 1.0 / max(n - n_lab, 1))
    w = w / w.sum()
    rng = np.random.default_rng(seed)
    steps = steps_per_epoch or max(n // batch_size, 1)

    def fetch(i: int):
        views, label, _uq, m = merged[int(i)]
        return views, int(label), bool(np.asarray(m).reshape(-1)[0])

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for _ in range(steps):
            idxs = rng.choice(n, size=batch_size, p=w)
            idxs = _pod_shard(idxs, mesh)
            items = list(pool.map(fetch, idxs))
            # view-major: all first views, then all second views, ...
            images = np.concatenate([
                np.stack([np.asarray(it[0][v], np.float32) for it in items])
                for v in range(n_views)])
            yield {"images": images,
                   "labels": np.array([it[1] for it in items], np.int64),
                   "mask_lab": np.array([it[2] for it in items], bool)}


def run_metric_learn(args) -> dict:
    """Train, evaluate and checkpoint per ``args`` (the argparser's
    namespace).  Returns the last epoch's metrics, the log directory, the
    trainer and the checkpoint manager."""
    device = multihost.maybe_initialize(args.device)
    mesh = _pipeline_mesh(PipelineConfig(
        mesh=MeshConfig(data=args.mesh_data, model=args.mesh_model)))
    if mesh is not None and args.batch_size % mesh.n_data:
        raise ValueError(f"--batch_size {args.batch_size} does not split "
                         f"evenly over the {mesh.n_data} ranks of the data "
                         "axis")
    data_cfg = DataConfig(dataset_name=args.dataset_name,
                          root_dir=args.root_dir,
                          image_size=args.image_size,
                          prop_train_labels=args.prop_train_labels,
                          batch_size=args.batch_size,
                          num_workers=args.num_workers)
    train_classes, unlabeled_classes = get_class_splits(data_cfg)

    train_tf = ContrastiveViewGenerator(
        get_transform("imagenet", image_size=args.image_size, train=True,
                      seed=args.seed), n_views=args.n_views)
    test_tf = get_transform("imagenet", image_size=args.image_size)
    merged, test_ds, _unlab_ds, _extras = get_datasets(
        data_cfg, train_transform=train_tf, test_transform=test_tf)
    # the same seeded splits with the eval transform, for the per-epoch
    # k-means eval (the reference evaluates the merged train set with the
    # non-augmenting transform, learn_metric.py:341-383)
    merged_eval, _t2, _u2, _e2 = get_datasets(
        data_cfg, train_transform=test_tf, test_transform=test_tf)

    # bf16 compute with f32 parameters, LayerNorms and loss; --bf16 0 is
    # f32 throughout
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    vit_cfg = ViTConfig(image_size=args.image_size, patch_size=args.patch_size,
                        compute_dtype=dtype, gelu_tanh=bool(args.gelu_tanh),
                        remat=bool(args.remat), **_VIT_SIZES[args.vit])
    n_classes = len(train_classes) + len(unlabeled_classes)
    steps = args.steps_per_epoch or max(len(merged) // args.batch_size, 1)
    cfg = TrainConfig(lr=args.lr, sup_con_weight=args.sup_con_weight,
                      grad_from_block=args.grad_from_block,
                      n_views=args.n_views, proj_dim=args.proj_dim,
                      batch_size=args.batch_size,
                      int8_frozen=bool(args.int8_frozen))
    trainer = GCDTrainer(vit_cfg, cfg, seed=args.seed,
                         total_steps=steps * args.epochs, device=device,
                         mesh=mesh)

    # rank 0 creates the run directory; the other ranks follow its id
    ctx = None
    if multihost.process_index() == 0:
        ctx = init_experiment(vars(args), exp_root=args.exp_root,
                              runner_name="metric_learn")
    if mesh is not None:
        exp_id = multihost.broadcast_object(ctx and ctx.exp_id)
        ctx = ctx or follow_experiment(exp_id, args.exp_root,
                                       "metric_learn")
    # best checkpoint by old-class TEST ACC, the reference's criterion
    # (learn_metric.py:328-338)
    ckpt = CheckpointManager(ctx.model_dir, keep=2,
                             best_metric="old_acc_test")

    def make_batches(epoch):
        return balanced_batches(merged, args.batch_size, args.n_views,
                                seed=args.seed + epoch,
                                steps_per_epoch=args.steps_per_epoch,
                                num_workers=args.num_workers, mesh=mesh)

    def _extract(tr, ds):
        """(features, targets, mask_lab) of every row of ``ds``; over a
        mesh each rank extracts its contiguous share and the shares are
        gathered, in order, on every rank."""
        if mesh is not None:
            ds = _RowRange(ds, *multihost.share_bounds(
                len(ds), mesh.n_data, mesh.data_index))
        feats, targets, masks = [], [], []
        for images, labels, _uq, m in iterate_batches(
                ds, args.batch_size, num_workers=args.num_workers):
            feats.append(tr.extract_features([images]))
            targets.append(labels)
            masks.append(m)
        out = (np.concatenate(feats),
               np.concatenate(targets).astype(np.int64),
               np.concatenate(masks).astype(bool))
        return out if mesh is None else tuple(
            _gather_rows(mesh, a) for a in out)

    def kmeans_cfg(epoch):
        return ClusterConfig(n_clusters=n_classes, n_init=3,
                             max_iterations=args.max_kmeans_iter, seed=epoch)

    def eval_fn(tr, epoch):
        feats, targets, mask_lab = _extract(tr, merged_eval)
        mask_cls = targets < len(train_classes)
        if mask_lab.any():
            all_acc, old_acc, new_acc, _p, _r = eval_kmeans_semi_sup(
                feats, targets, mask_cls, mask_lab, kmeans_cfg(epoch),
                print_output=False, device=device)
        else:
            all_acc, old_acc, new_acc, _res = eval_kmeans(
                feats, targets, mask_cls, kmeans_cfg(epoch),
                print_output=False, device=device)
        m = {"all_acc_train": all_acc, "old_acc_train": old_acc,
             "new_acc_train": new_acc}
        ctx.writer.add_scalars("kmeans_train", m, step=epoch)

        # the disjoint TEST split: the reference's per-epoch test_kmeans,
        # whose old-class ACC selects model_best.pt
        if test_ds is not None and len(test_ds) > 0:
            tf, tt, _tm = _extract(tr, test_ds)
            t_all, t_old, t_new, _r = eval_kmeans(
                tf, tt, tt < len(train_classes), kmeans_cfg(epoch),
                print_output=False, device=device)
            mt = {"all_acc_test": t_all, "old_acc_test": t_old,
                  "new_acc_test": t_new}
            ctx.writer.add_scalars("kmeans_test", mt, step=epoch)
            m.update(mt)
        else:  # no test split (e.g. synthetic): the best-ckpt key
            m["old_acc_test"] = old_acc
        return m

    last = trainer.fit(args.epochs, make_batches, eval_fn=eval_fn, ckpt=ckpt,
                       log_fn=ctx.logger.info)
    ctx.close()
    return {"last": last, "log_dir": ctx.log_dir, "trainer": trainer,
            "ckpt": ckpt}


def _gather_rows(mesh, local: np.ndarray) -> np.ndarray:
    """Every rank's rows of ``local`` (ragged shares), in rank order, on
    every rank."""
    padded, valid = multihost.rows_from_process_local(mesh, local, pad=True,
                                                      device="cpu")
    full = multihost.host_fetch(padded, mesh)
    return full if valid is None else full[valid]


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GCD contrastive finetuning")
    p.add_argument("--dataset_name", type=str, default="synthetic")
    p.add_argument("--root_dir", type=str, default="/data")
    p.add_argument("--prop_train_labels", type=float, default=0.5)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--vit", type=str, default="base",
                   help="micro | tiny | small | base")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--sup_con_weight", type=float, default=0.35)
    p.add_argument("--grad_from_block", type=int, default=11)
    p.add_argument("--n_views", type=int, default=2)
    p.add_argument("--proj_dim", type=int, default=65536)
    p.add_argument("--max_kmeans_iter", type=int, default=50)
    p.add_argument("--steps_per_epoch", type=int, default=None)
    p.add_argument("--gelu_tanh", type=int, default=0,
                   help="tanh-approximate GELU in the towers; 0 keeps the "
                        "exact erf")
    p.add_argument("--int8_frozen", type=int, default=0,
                   help="W8A8 int8 dense layers (qkv, fc1) in the FROZEN "
                        "trunk blocks (< grad_from_block); trainable blocks "
                        "keep exact gradients")
    p.add_argument("--remat", type=int, default=0,
                   help="recompute the trainable blocks' activations in "
                        "the backward pass (torch.utils.checkpoint)")
    p.add_argument("--bf16", type=int, default=1,
                   help="1 = bf16 compute with f32 parameters, LayerNorms "
                        "and loss; 0 = f32 throughout")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--exp_root", type=str, default="runs")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="data-parallel mesh axis size")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel mesh axis size")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    with multihost.rank0_stdout():
        return run_metric_learn(args)


if __name__ == "__main__":
    main()
