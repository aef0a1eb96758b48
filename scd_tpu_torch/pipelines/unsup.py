"""Unsupervised SCD pipeline — the ``main_unsup.py`` equivalent, in PyTorch.

Port of ``scd_tpu/pipelines/unsup.py::run_unsup``: encoders (built only
on a cache miss) -> feature extraction through the DINO and CLIP image
towers (cached) -> clustering (KM / SSKM) -> ACC v2 -> vocabulary + the
zero-shot weights through the CLIP text tower (cached) -> per-image top-k
names (the ``topk_softmax`` kernel) -> iterative voting loop with
per-iteration ACC/sACC/Soft-sACC printouts -> name-set IoU.  The metric
lines are byte-identical to the JAX package's.  ``--int8`` runs the towers'
qkv and fc1 layers through the W8A8 kernels.  The synthetic dataset runs
with the synthetic encoder pair (``models/synthetic.py``) and needs no
assets.  ``--feat_model resnet50`` takes the ResNet-50 backbone
(``models/resnet50.py``).  With ``SCD_PREFIX_VOCAB=1`` (and ``--int8``
off) the vocabulary build takes the prefix-KV route
(``naming/zeroshot.py::build_zeroshot_weights_prefix``).

Over several ranks (``torchrun --nproc_per_node N -m
scd_tpu_torch.pipelines.unsup --mesh_data N ...``; one rank per device,
``core/multihost.py``) the run is data-parallel as the JAX package's
multi-controller run: each rank decodes and encodes its share of the
dataset, clusters its share of the unlabelled rows (KM / SSKM) and
encodes its share of the vocabulary's names; every rank ends each stage
with the full result, and rank 0 alone prints the metric lines.

Run: ``python -m scd_tpu_torch.pipelines.unsup --dataset_name synthetic
--device cpu`` (asset-free), or ``... --dataset_name imagenet_100
--root_dir ROOT --cache_dir CACHE --cluster SSKM --n_cluster 100 --corpus
wordnet --device cuda`` with the caches present, or ``run_unsup(cfg)`` with
the weight paths in ``cfg.data`` (``clip_weights``, ``dino_weights``,
``corpus_dir`` holding ``bpe_simple_vocab_16e6.txt.gz``).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict

import numpy as np

from scd_tpu_torch.core.cache import tensors_from_arrays
from scd_tpu_torch.core.config import (
    ClusterConfig,
    DataConfig,
    FeatureConfig,
    MeshConfig,
    NamingConfig,
    PipelineConfig,
)
from scd_tpu_torch.core.device import resolve_device
from scd_tpu_torch.data import get_class_splits, get_datasets
from scd_tpu_torch.metrics import name_set_iou, split_cluster_acc_v2
from scd_tpu_torch.naming.classnames import (remap_cidx_to_cname,
                                             resolve_class_names)
from scd_tpu_torch.naming.loop import voting_loop
from scd_tpu_torch.naming.templates import IMAGENET_TEMPLATES
from scd_tpu_torch.naming.vote import topk_names
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


def vit_feature_backbones() -> Dict:
    """feat_model -> (ViT config factory, device normalization) for the
    ViT extraction backbones.  One loader serves every checkpoint (the
    ``blocks.N.*`` layout).  Normalization follows what each reference
    branch feeds its model: dino_vit / gcd the mains' CLIP preprocess,
    dino_vit_s (PASS) and dino_vit_t torchvision ImageNet statistics,
    vit_supervised mean/std 0/1."""
    from scd_tpu_torch.data.transforms import (
        device_normalize_clip,
        device_normalize_imagenet,
        device_normalize_unit,
    )
    from scd_tpu_torch.models import (
        dino_vit_b16_config,
        dino_vit_s16_config,
        dino_vit_t16_config,
    )

    return {
        "dino_vit": (dino_vit_b16_config, device_normalize_clip),
        "gcd": (dino_vit_b16_config, device_normalize_clip),
        "vit_supervised": (dino_vit_b16_config, device_normalize_unit),
        "dino_vit_s": (dino_vit_s16_config, device_normalize_imagenet),
        "dino_vit_t": (dino_vit_t16_config, device_normalize_imagenet),
    }


def _image_encoder(model, normalize, dev):
    """``encode(images) -> np.ndarray`` over a tower: uint8 (or already
    normalized float) NHWC batches, numpy or staged on ``dev`` by
    ``encode.stage``, normalized on the device."""
    import torch

    def stage(images):
        return torch.as_tensor(images).to(dev, non_blocking=True)

    def encode(images):
        with torch.inference_mode():
            feats = model(normalize(stage(images)))
        return feats.cpu().numpy()

    encode.stage = stage
    return encode


def build_encoders(cfg: PipelineConfig, extras: Dict, device="cuda",
                   mesh=None):
    """Returns (feat_encode_image, clip_encode_image, encode_text), the
    towers on ``device`` at bf16 compute with f32 LayerNorms (the JAX
    package's recipe), W8A8 qkv/fc1 under ``cfg.feature.dense_int8``.
    With a ``mesh`` the image encoders are data-parallel over it
    (``pipelines/common.py::make_sharded_image_encoder``) and every tower's
    weights are checked to be the same on every rank
    (``core.multihost.replicate_to_mesh``).

    ``encode_text`` also exposes ``forward(model, tokens)``, ``variables``
    (the CLIP model) and ``tokenize``, which the batched vocabulary build
    uses, and, unless ``cfg.feature.dense_int8``, the prefix-KV hooks
    ``prefix_forward(model, tokens)`` and ``suffix_forward(model, tokens,
    kv, p_len)`` of the ``SCD_PREFIX_VOCAB=1`` build."""
    import torch

    from scd_tpu_torch.data.transforms import device_normalize_clip
    from scd_tpu_torch.models import (
        CLIPModel,
        CLIPTokenizer,
        VisionTransformer,
        clip_vit_b16_config,
        load_dino_weights,
        load_openai_clip_weights,
        params_from_flax,
    )
    from scd_tpu_torch.naming.zeroshot import truncate_to_eot_bucket

    dev = resolve_device(device)
    name = cfg.feature.feat_model
    if cfg.data.dataset_name == "synthetic" or name == "synthetic":
        from scd_tpu_torch.models.synthetic import SyntheticCLIP

        clip = SyntheticCLIP(extras["class_colors"], device=dev)
        feat, img = _image_encoders_over(
            mesh, (clip.encode_image, clip.encode_image))
        return feat, img, clip.encode_text
    vit_feat_cfgs = vit_feature_backbones()
    if name not in ("clip", "resnet50") and name not in vit_feat_cfgs:
        raise ValueError(f"unknown feat_model {name!r}")
    if not cfg.data.clip_weights:
        raise FileNotFoundError(
            "cfg.data.clip_weights must point to an OpenAI CLIP ViT-B/16 "
            "checkpoint for non-synthetic datasets")

    clip_cfg = clip_vit_b16_config(compute_dtype=torch.bfloat16,
                                   dense_int8=cfg.feature.dense_int8)
    clip_sd = torch.load(cfg.data.clip_weights, map_location="cpu")
    clip_model = CLIPModel(clip_cfg, device=dev).eval()
    clip_model.load_state_dict(params_from_flax(load_openai_clip_weights(
        clip_sd.state_dict() if hasattr(clip_sd, "state_dict") else clip_sd,
        clip_cfg)))
    del clip_sd
    tokenizer = CLIPTokenizer(cfg.data.corpus_dir
                              + "/bpe_simple_vocab_16e6.txt.gz")
    clip_encode_image = _image_encoder(clip_model.visual,
                                       device_normalize_clip, dev)

    def text_forward(model, tokens) -> "torch.Tensor":
        with torch.inference_mode():
            return model.encode_text(torch.as_tensor(tokens).to(dev))

    def encode_text(texts) -> np.ndarray:
        # EOT-bucket truncation is exact (causal tower, EOT pooling)
        toks = truncate_to_eot_bucket(np.asarray(tokenizer(texts), np.int32))
        return text_forward(clip_model, toks).cpu().numpy()

    encode_text.forward = text_forward
    encode_text.variables = clip_model
    encode_text.tokenize = tokenizer
    if not cfg.feature.dense_int8:
        # the prefix-KV hooks of the opt-in SCD_PREFIX_VOCAB=1 build; the
        # int8 knob skips them, as in the JAX package (its sequence padding
        # does not compose with 8-token suffixes)
        def text_prefix_forward(model, tokens):
            with torch.inference_mode():
                return model.encode_text_prefix(
                    torch.as_tensor(tokens).to(dev))

        def text_suffix_forward(model, tokens, kv, p_len):
            with torch.inference_mode():
                return model.encode_text_suffix(
                    torch.as_tensor(tokens).to(dev), kv, p_len)

        encode_text.prefix_forward = text_prefix_forward
        encode_text.suffix_forward = text_suffix_forward

    if mesh is not None:
        from scd_tpu_torch.core.multihost import replicate_to_mesh

        replicate_to_mesh(mesh, clip_model)
    if name == "clip":
        img, = _image_encoders_over(mesh, (clip_encode_image,))
        return img, img, encode_text
    if name == "resnet50":
        from scd_tpu_torch.data.transforms import device_normalize_imagenet
        from scd_tpu_torch.models import (ResNet50, ResNet50Config,
                                          load_resnet50_weights)

        r50_cfg = ResNet50Config(compute_dtype=torch.bfloat16)
        r50 = ResNet50(r50_cfg, device=dev).eval()
        r50.load_state_dict(params_from_flax(load_resnet50_weights(
            torch.load(cfg.data.dino_weights, map_location="cpu"),
            r50_cfg)))
        if mesh is not None:
            replicate_to_mesh(mesh, r50)
        feat, img = _image_encoders_over(mesh, (
            _image_encoder(r50, device_normalize_imagenet, dev),
            clip_encode_image))
        return feat, img, encode_text
    path = (f"{cfg.data.gcd_weights_dir}/"
            f"{cfg.data.dataset_name}_model_best.pt"
            if name == "gcd" else cfg.data.dino_weights)
    cfg_fn, normalize = vit_feat_cfgs[name]
    vit_cfg = cfg_fn(compute_dtype=torch.bfloat16,
                     dense_int8=cfg.feature.dense_int8,
                     gelu_tanh=cfg.feature.gelu_tanh)
    dino = VisionTransformer(vit_cfg, device=dev).eval()
    dino.load_state_dict(params_from_flax(load_dino_weights(
        torch.load(path, map_location="cpu"), vit_cfg)))
    if mesh is not None:
        replicate_to_mesh(mesh, dino)
    feat, img = _image_encoders_over(mesh, (
        _image_encoder(dino, normalize, dev), clip_encode_image))
    return feat, img, encode_text


def load_vocabulary(cfg: PipelineConfig, extras: Dict):
    """Returns (nouns, taxonomy_or_None).  Corpus names follow the reference
    (wordnet | wikibird | wikidog | a path, ``clip_lang_util.py:139-149``);
    synthetic builds a class-names+distractors list."""
    corpus = cfg.naming.corpus
    if cfg.data.dataset_name == "synthetic" or corpus == "synthetic":
        from scd_tpu_torch.models.synthetic import synthetic_vocabulary

        return synthetic_vocabulary(extras["class_names"]), None

    taxonomy = None
    if corpus == "wordnet":
        from scd_tpu_torch.naming.wordnet import Taxonomy

        if cfg.data.wordnet_db_dir:
            taxonomy = Taxonomy.from_wndb(cfg.data.wordnet_db_dir)
        else:
            taxonomy = Taxonomy.from_nltk()
        path = os.path.join(cfg.data.corpus_dir, "wordnet_all_noun.txt")
        if os.path.exists(path):
            with open(path) as f:
                nouns = [line.rstrip("\n") for line in f]
        else:
            nouns = taxonomy.all_names()
    elif corpus in ("wikibird", "wikidog"):
        fname = ("wiki_birdclass_names.txt" if corpus == "wikibird"
                 else "wiki_dogclass_names.txt")
        with open(os.path.join(cfg.data.corpus_dir, fname)) as f:
            nouns = [line.rstrip("\n") for line in f]
        nouns = [n.lower().replace("'s", "").replace(" ", "_") for n in nouns]
    else:
        with open(corpus) as f:
            nouns = [line.rstrip("\n") for line in f]
    nouns = [n.lower().replace("-", "_") for n in nouns]
    return nouns, taxonomy


def run_unsup(cfg: PipelineConfig, device="cuda") -> Dict:
    """The unsupervised pipeline on ``device`` (``"cuda"`` unless the
    caller asks for ``"cpu"``; no card raises).  Returns the JAX package's
    result dict plus ``stage_seconds`` (host clock per stage; each stage
    ends in a host fetch, so the times include the device work).

    Launched over several ranks (``WORLD_SIZE`` > 1, or an initialized
    process group), each rank runs on the device ``core.multihost``
    bound and the stages shard over ``cfg.mesh`` (module docstring);
    every rank returns the same result and rank 0 prints."""
    from scd_tpu_torch.core.multihost import maybe_initialize, rank0_stdout

    dev = maybe_initialize(device)
    with rank0_stdout():
        return _run_unsup(cfg, dev)


def _run_unsup(cfg: PipelineConfig, dev) -> Dict:
    from scd_tpu_torch.pipelines.common import _pipeline_mesh

    stage_seconds: Dict[str, float] = {}
    t0 = time.perf_counter()
    cache = stage_cache(cfg)
    train_classes, unlabeled_classes = get_class_splits(cfg.data)
    tf = pipeline_transform(cfg)
    train_merged, _test, _unlab, extras = get_datasets(
        cfg.data, train_transform=tf, test_transform=tf)
    mesh = _pipeline_mesh(cfg)
    # the encoders build lazily: a fully cached run loads no weights
    feat_encode, clip_encode, encode_text = lazy_encoders(
        lambda: build_encoders(cfg, extras, device=dev, mesh=mesh))
    stage_seconds["load"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    # one dataset pass feeds both towers, for the sets whose caches miss
    feats, clip_feats = load_shared_features(
        cfg, cache, feat_encode, clip_encode, train_merged, train_classes)
    stage_seconds["features"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cluster_result = cache.load_or_compute(
        "cluster", cluster_cache_key(cfg),
        lambda: run_clustering(cfg, feats, device=dev, mesh=mesh),
        refresh=cfg.run_cluster)
    stage_seconds["cluster"] = time.perf_counter() - t0

    u_preds = cluster_result["u_preds"].astype(np.int64)
    u_targets = cluster_result["u_targets"].astype(np.int64)
    mask = cluster_result["mask"].astype(bool)
    all_acc, old_acc, new_acc = split_cluster_acc_v2(u_targets, u_preds, mask)
    print(f"{cfg.cluster.algorithm} Accuracies: All {all_acc} | Old {old_acc} "
          f"| New {new_acc}")

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
    # only the unlabelled rows vote
    mask_lab = clip_feats["mask_lab"].astype(bool)
    clip_u_feats = tensors_from_arrays(
        {"all_feats": clip_feats["all_feats"][~mask_lab]}, dev)["all_feats"]
    stage_seconds["zeroshot"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    name_idx_u, _vals = topk_names(clip_u_feats, zw, cfg.naming.topk,
                                   scale=cfg.naming.logit_scale)
    stage_seconds["topk"] = time.perf_counter() - t0

    name_sim = taxonomy.name_similarity if taxonomy else None
    if name_sim is None and cfg.data.dataset_name == "synthetic":
        from scd_tpu_torch.models.synthetic import synthetic_name_similarity

        name_sim = synthetic_name_similarity
    eval_soft = cfg.eval_soft_sacc and cfg.data.dataset_name != "cub"

    def metrics_cb(it: int, preds: np.ndarray, cand_names) -> Dict:
        print(f"iter: {it}")
        out = print_acc_block("vote", u_targets, preds, mask, cidx_to_cname,
                              cand_names, name_similarity=name_sim,
                              eval_soft=eval_soft)
        out["cand_names"] = list(cand_names)
        return out

    t0 = time.perf_counter()
    result = voting_loop(nouns, name_idx_u, clip_u_feats, zw, u_preds,
                         cfg.cluster.n_clusters, cfg.naming,
                         metrics_cb=metrics_cb)

    if cfg.naming.textual_enhancement:
        from scd_tpu_torch.naming.loop import voting_loop_te

        print("-- textual enhancement round --")
        result = voting_loop_te(nouns, name_idx_u, clip_u_feats, zw, result,
                                cfg.cluster.n_clusters, cfg.naming,
                                alpha=cfg.naming.te_alpha,
                                metrics_cb=metrics_cb)
    stage_seconds["voting"] = time.perf_counter() - t0

    gt_names = list(cidx_to_cname.values())
    iou = name_set_iou(result.cand_names, gt_names)
    print(f"IoU: {iou}")

    return {"cluster_acc": (all_acc, old_acc, new_acc),
            "voting": result, "iou": iou,
            "history": result.history,
            "cidx_to_cname": cidx_to_cname,
            "stage_seconds": stage_seconds}


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Unsupervised SCD pipeline "
                                            "(PyTorch/CUDA)")
    p.add_argument("--batch_size", default=256, type=int)
    p.add_argument("--num_workers", default=8, type=int)
    p.add_argument("--root_dir", type=str, default="/data")
    p.add_argument("--dataset_name", type=str, default="synthetic")
    p.add_argument("--feat_model", type=str, default="synthetic",
                   help="synthetic | clip | dino_vit | dino_vit_s | "
                        "dino_vit_t | vit_supervised | resnet50 | gcd")
    p.add_argument("--prop_train_labels", type=float, default=0.5)
    p.add_argument("--cluster", type=str, default="SSKM",
                   help="KM | SSKM | ConSSKM | FINCH")
    p.add_argument("--n_cluster", type=int, default=10)
    p.add_argument("--cluster_size_min", type=int, default=0)
    p.add_argument("--cluster_size_max", type=int, default=10 ** 9)
    p.add_argument("--corpus", type=str, default="synthetic")
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--num_common_vote", type=int, default=20)
    p.add_argument("--num_common_linear", type=int, default=4)
    p.add_argument("--te", action="store_true",
                   help="textual-enhancement re-ranking round (w/TE)")
    p.add_argument("--te_alpha", type=float, default=0.5)
    p.add_argument("--extract_feat", action="store_true")
    p.add_argument("--int8", action="store_true",
                   help="W8A8 int8 qkv/fc1 layers in the extraction and "
                        "text towers (the w8a8 CUDA kernels)")
    p.add_argument("--run_cluster", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--cache_dir", type=str, default="artifacts")
    p.add_argument("--mesh_data", type=int, default=0,
                   help="data-axis size (0 = every launched rank / model; "
                        "launch one rank per device with torchrun "
                        "--nproc_per_node N)")
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) | cpu")
    return p


def _image_encoders_over(mesh, encoders):
    """The image encoders data-parallel over ``mesh`` (None: as they are),
    one sharded encoder per distinct tower."""
    if mesh is None:
        return encoders
    from scd_tpu_torch.pipelines.common import make_sharded_image_encoder

    out, done = [], {}
    for enc in encoders:
        if id(enc) not in done:
            done[id(enc)] = make_sharded_image_encoder(enc, mesh)
        out.append(done[id(enc)])
    return out


def config_from_args(args, partially_supervised: bool = False) -> PipelineConfig:
    """The same PipelineConfig the JAX package builds from the same flags,
    so both derive the same cache keys."""
    return PipelineConfig(
        mesh=MeshConfig(data=getattr(args, "mesh_data", 0),
                        model=getattr(args, "mesh_model", 1)),
        data=DataConfig(dataset_name=args.dataset_name, root_dir=args.root_dir,
                        prop_train_labels=args.prop_train_labels,
                        batch_size=args.batch_size,
                        num_workers=args.num_workers,
                        cache_dir=args.cache_dir),
        feature=FeatureConfig(feat_model=args.feat_model,
                              dense_int8=getattr(args, 'int8', False)),
        cluster=ClusterConfig(algorithm=args.cluster,
                              n_clusters=args.n_cluster,
                              size_min=args.cluster_size_min,
                              size_max=args.cluster_size_max),
        naming=NamingConfig(corpus=args.corpus, topk=args.topk,
                            num_common_vote=args.num_common_vote,
                            num_common_linear=args.num_common_linear,
                            textual_enhancement=args.te,
                            te_alpha=args.te_alpha),
        partially_supervised=partially_supervised,
        extract_feat=args.extract_feat,
        run_cluster=args.run_cluster,
    )


def main(argv=None):
    args = build_argparser().parse_args(argv)
    return run_unsup(config_from_args(args), device=args.device)


if __name__ == "__main__":
    main()
