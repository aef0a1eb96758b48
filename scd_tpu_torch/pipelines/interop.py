"""Reference ``.pt`` artifact interop.

The reference distributes its stage caches as torch ``.pt`` files:
feature dicts (``main_unsup.py:294-311``: ``extracted_features/
{feat_model}_{dataset}_all.pt`` holding ``all_feats/mask_lab/mask_cls/
targets``), cluster results (``main_unsup.py:366-374``:
``cluster/{alg}_{feat_model}_{dataset}_{K}.pt`` holding ``all_preds/
u_preds/u_targets/mask``), and zero-shot weight matrices
(``main_unsup.py:387-395``: ``zeroshot_weights/zeroshot_weights_all_*.pt``
as a [D, V] tensor).

Port of ``scd_tpu/pipelines/interop.py``.  These importers convert them
into the :class:`ArtifactCache` npz protocol under the keys the pipelines
re-enter from (the same keys and layout as the JAX package's, so either
package re-enters what either imported):
``import_reference_artifacts(ref_root, cfg)`` then ``run_unsup(cfg)`` or
``run_ptsup(cfg)``.

Run: ``python -m scd_tpu_torch.pipelines.interop --ref_root ROOT
--dataset_name imagenet_100 --feat_model dino_vit --cluster KM
--n_cluster 100 --corpus wordnet --cache_dir artifacts`` (the flags of
``scripts/import_reference_cache.py``).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional

import numpy as np
import torch

from scd_tpu_torch.core.cache import ArtifactCache
from scd_tpu_torch.core.config import (ClusterConfig, DataConfig,
                                       FeatureConfig, NamingConfig,
                                       PipelineConfig)
from scd_tpu_torch.pipelines.common import (cluster_cache_key,
                                            feature_cache_key, stage_cache)


def _to_numpy(x, dtype=None) -> np.ndarray:
    """torch tensor / numpy array -> host numpy; fp16/bf16 promote to f32
    (npz round-trips fp16 but the pipelines compute in f32/bf16 anyway,
    and numpy has no bfloat16)."""
    if hasattr(x, "detach"):  # torch tensor (possibly on an accelerator)
        x = x.detach().cpu()
        if x.dtype in (torch.float16, torch.bfloat16):
            x = x.float()
        x = x.numpy()
    x = np.asarray(x)
    if dtype is not None:
        x = x.astype(dtype)
    elif x.dtype == np.float16:
        x = x.astype(np.float32)
    return x


def _torch_load(path: str):
    # the reference saves plain dicts of tensors/ndarrays; weights_only
    # rejects the ndarray entries under newer torch defaults
    return torch.load(path, map_location="cpu", weights_only=False)


def import_reference_features(pt_path: str, cfg: PipelineConfig,
                              which: str,
                              cache: Optional[ArtifactCache] = None) -> str:
    """Import a reference extracted-features dict (``main_unsup.py:294-311``)
    into the ``features`` cache under :func:`feature_cache_key`.

    ``which``: ``"feat"`` (the clustering tower, keyed by
    ``cfg.feature.feat_model``) or ``"clip"`` (the voting tower).
    Returns the written npz path.
    """
    d = _torch_load(pt_path)
    arrays = {
        "all_feats": _to_numpy(d["all_feats"], np.float32),
        "mask_lab": _to_numpy(d["mask_lab"]).astype(bool),
        "mask_cls": _to_numpy(d["mask_cls"]).astype(bool),
        "targets": _to_numpy(d["targets"], np.int64),
    }
    n = len(arrays["all_feats"])
    for k in ("mask_lab", "mask_cls", "targets"):
        if len(arrays[k]) != n:
            raise ValueError(f"{pt_path}: {k} has {len(arrays[k])} rows, "
                             f"all_feats has {n}")
    cache = cache or stage_cache(cfg)
    return cache.save("features", feature_cache_key(cfg, which), arrays,
                      meta={"imported_from": os.path.abspath(pt_path)})


def import_reference_cluster(pt_path: str, cfg: PipelineConfig,
                             cache: Optional[ArtifactCache] = None) -> str:
    """Import a reference cluster result (``main_unsup.py:366-374``) into
    the ``cluster`` cache under :func:`cluster_cache_key`.  The KM branch
    saves ``all_preds=None`` (``main_unsup.py:336``) — stored as the same
    all -1 sentinel our ``run_clustering`` uses."""
    d = _torch_load(pt_path)
    u_preds = _to_numpy(d["u_preds"], np.int64)
    all_preds = d.get("all_preds")
    arrays = {
        "all_preds": (np.full(len(u_preds), -1, np.int64)
                      if all_preds is None
                      else _to_numpy(all_preds, np.int64)),
        "u_preds": u_preds,
        "u_targets": _to_numpy(d["u_targets"], np.int64),
        "mask": _to_numpy(d["mask"]).astype(bool),
    }
    cache = cache or stage_cache(cfg)
    return cache.save("cluster", cluster_cache_key(cfg), arrays,
                      meta={"imported_from": os.path.abspath(pt_path)})


def import_reference_zeroshot(pt_path: str, cfg: PipelineConfig,
                              cache: Optional[ArtifactCache] = None) -> str:
    """Import a reference zero-shot weight matrix (``main_unsup.py:387-395``,
    a [D, V] tensor, one L2-normalized text embedding per vocabulary
    column) into the ``zeroshot`` cache under the corpus-specific key
    :func:`load_zeroshot_weights` reads."""
    w = _torch_load(pt_path)
    if isinstance(w, dict):  # tolerate {"weights": tensor} wrappers
        w = w.get("weights", next(iter(w.values())))
    weights = _to_numpy(w, np.float32)
    if weights.ndim != 2:
        raise ValueError(f"{pt_path}: zeroshot weights must be [D, V], "
                         f"got {weights.shape}")
    cache = cache or stage_cache(cfg)
    return cache.save("zeroshot",
                      feature_cache_key(cfg, f"zw_{cfg.naming.corpus}"),
                      {"weights": weights},
                      meta={"imported_from": os.path.abspath(pt_path)})


_ZW_FILES = {
    "wordnet": "zeroshot_weights_all_nouns_vit_b_16.pt",
    "wikibird": "zeroshot_weights_all_wikibird_vit_b_16.pt",
    "wikidog": "zeroshot_weights_all_wikidog_vit_b_16.pt",
}


def import_reference_artifacts(ref_root: str, cfg: PipelineConfig
                               ) -> Dict[str, str]:
    """Sweep a reference ``root_dir`` for every cached artifact this config
    would consume (the reference's own directory/file naming) and import
    each one found.  Returns {artifact: npz path} for what was imported."""
    ds, fm = cfg.data.dataset_name, cfg.feature.feat_model
    candidates = {
        "features_feat": os.path.join(
            ref_root, "extracted_features", f"{fm}_{ds}_all.pt"),
        "features_clip": os.path.join(
            ref_root, "extracted_features", f"clip_{ds}_all.pt"),
        "cluster": os.path.join(
            ref_root, "cluster",
            f"{cfg.cluster.algorithm}_{fm}_{ds}_{cfg.cluster.n_clusters}.pt"),
        "zeroshot": os.path.join(
            ref_root, "zeroshot_weights",
            _ZW_FILES.get(cfg.naming.corpus, "")),
    }
    out: Dict[str, str] = {}
    if os.path.exists(candidates["features_feat"]):
        out["features_feat"] = import_reference_features(
            candidates["features_feat"], cfg, "feat")
    if os.path.exists(candidates["features_clip"]):
        out["features_clip"] = import_reference_features(
            candidates["features_clip"], cfg, "clip")
    if os.path.exists(candidates["cluster"]):
        out["cluster"] = import_reference_cluster(candidates["cluster"], cfg)
    if candidates["zeroshot"].endswith(".pt") and os.path.exists(
            candidates["zeroshot"]):
        out["zeroshot"] = import_reference_zeroshot(
            candidates["zeroshot"], cfg)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Import the reference's cached .pt artifacts into the "
                    "npz stage cache")
    p.add_argument("--ref_root", required=True,
                   help="the reference's root_dir (holds extracted_features/"
                        ", cluster/, zeroshot_weights/)")
    p.add_argument("--dataset_name", default="imagenet_100")
    p.add_argument("--feat_model", default="dino_vit")
    p.add_argument("--cluster", default="KM")
    p.add_argument("--n_cluster", type=int, default=100)
    p.add_argument("--corpus", default="wordnet")
    p.add_argument("--cache_dir", default="artifacts")
    args = p.parse_args(argv)
    cfg = PipelineConfig(
        data=DataConfig(dataset_name=args.dataset_name,
                        cache_dir=args.cache_dir),
        feature=FeatureConfig(feat_model=args.feat_model),
        cluster=ClusterConfig(algorithm=args.cluster,
                              n_clusters=args.n_cluster),
        naming=NamingConfig(corpus=args.corpus),
    )
    imported = import_reference_artifacts(args.ref_root, cfg)
    if not imported:
        print(f"no reference artifacts found under {args.ref_root} for "
              f"this config")
        return 1
    for name, path in imported.items():
        print(f"imported {name}: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
