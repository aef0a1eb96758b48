"""Offline feature extraction into a feature store.

Port of ``scd_tpu/pipelines/extract.py``: the train and test splits go
through the frozen feature tower and are written as the packed
``features_packed.npz`` store, and with ``--tree`` also as the reference's
``{split}/{label}/{uq_idx}.npy`` layout.

Run: ``python -m scd_tpu_torch.pipelines.extract --dataset_name
imagenet_100 --root_dir ROOT --feat_model dino_vit --save_dir OUT
--device cuda`` (weight paths come from the config's ``data`` section when
called as :func:`run_extract`).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from scd_tpu_torch.data import get_class_splits, get_datasets
from scd_tpu_torch.data.features import save_features_packed, \
    save_features_tree
from scd_tpu_torch.data.loader import iterate_batches
from scd_tpu_torch.pipelines.common import pipeline_transform
from scd_tpu_torch.pipelines.unsup import build_argparser, build_encoders, \
    config_from_args


def extract_to_store(encode_image, dataset, save_dir: str, split: str,
                     batch_size: int = 256, num_workers: int = 8,
                     tree: bool = False) -> Dict[str, np.ndarray]:
    """Extract features for one split and persist them."""
    feats, targets, uqs, masks = [], [], [], []
    for images, labels, uq, m in iterate_batches(dataset, batch_size,
                                                 num_workers=num_workers):
        feats.append(np.asarray(encode_image(images)))
        targets.append(labels)
        uqs.append(uq)
        masks.append(m)
    feats = np.concatenate(feats)
    targets = np.concatenate(targets)
    uqs = np.concatenate(uqs)
    mask_lab = np.concatenate(masks).astype(bool)

    root = os.path.join(save_dir, split)
    save_features_packed(root, feats, uqs, targets=targets,
                         mask_lab=mask_lab)
    if tree:
        save_features_tree(root, feats, targets, uqs)
    return {"features": feats, "targets": targets, "uq_idxs": uqs,
            "mask_lab": mask_lab}


def run_extract(cfg, save_dir: str, tree: bool = False,
                device="cuda") -> Dict[str, Dict]:
    get_class_splits(cfg.data)
    tf = pipeline_transform(cfg)
    train_merged, test_ds, _unlab, extras = get_datasets(
        cfg.data, train_transform=tf, test_transform=tf)
    feat_encode, _clip_encode, _txt = build_encoders(cfg, extras,
                                                     device=device)
    out = {}
    for split, ds in (("train", train_merged), ("test", test_ds)):
        out[split] = extract_to_store(
            feat_encode, ds, save_dir, split,
            batch_size=cfg.data.batch_size,
            num_workers=cfg.data.num_workers, tree=tree)
        print(f"{split}: {out[split]['features'].shape} features -> "
              f"{os.path.join(save_dir, split)}")
    return out


def main(argv=None):
    p = build_argparser()
    p.description = "Offline feature extraction (PyTorch/CUDA)"
    p.add_argument("--save_dir", type=str, required=True)
    p.add_argument("--tree", action="store_true",
                   help="also write the per-instance .npy tree layout")
    args = p.parse_args(argv)
    return run_extract(config_from_args(args), args.save_dir, tree=args.tree,
                       device=args.device)


if __name__ == "__main__":
    main()
