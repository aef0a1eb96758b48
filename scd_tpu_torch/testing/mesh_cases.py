"""Functions each rank of a world runs (``testing/dist.py::spawn``): the
mesh paths of the port at small sizes, for the CPU tests
(``tests/test_torch_mesh*.py``) and ``chip_smoke.py``'s phase 13.

Every function takes plain data (numpy arrays, configs), runs on the
device ``core.multihost.initialize`` bound (``multihost.local_device``),
and returns plain data: each rank's copy of every result, so the caller
can check that the ranks agree and hold them against a single-process
run.  Row inputs arrive in full; each rank slices its contiguous share
(``core.multihost.share_bounds``), the multi-controller contract.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import os
from typing import Dict

import numpy as np
import torch

from scd_tpu_torch.core import multihost
from scd_tpu_torch.core.config import ClusterConfig, MeshConfig
from scd_tpu_torch.core.mesh import make_mesh


def _share(x, mesh):
    lo, hi = multihost.share_bounds(len(x), mesh.n_data, mesh.data_index)
    return x[lo:hi]


def _raises(fn) -> str:
    """The exception type ``fn()`` raises ("" when it returns)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the name is the result
        return type(e).__name__
    return ""


def _row_contracts(mesh) -> Dict:
    r = mesh.data_index
    ragged = np.arange(3 + r, dtype=np.float32)[:, None] + 10 * r
    local, valid = multihost.rows_from_process_local(mesh, ragged, pad=True)
    even, n_global = multihost.rows_from_process_local(
        mesh, np.ones((4, 2), np.float32))
    return {"ragged_width": int(local.shape[0]),
            "ragged_valid": None if valid is None else valid.tolist(),
            "ragged_rows": multihost.host_fetch(local, mesh).ravel().tolist(),
            "exact_n": int(n_global), "exact_shape": tuple(even.shape),
            "exact_uneven": _raises(lambda: multihost.rows_from_process_local(
                mesh, ragged))}


def _refusals(mesh, data) -> Dict:
    """Each path this slice does not port over ranks, called with a mesh of
    more than one rank: the exception it raises."""
    import importlib

    from scd_tpu_torch.cluster.constrained import fit_constrained
    from scd_tpu_torch.train import baselines_e2e, gcd
    from scd_tpu_torch.train.gcd import GCDTrainer

    ek = importlib.import_module("scd_tpu_torch.cluster.estimate_k")
    x = data["x"][:40]
    y = data["y"][:40]
    cfg = ClusterConfig(n_clusters=4, n_init=1, max_iterations=2,
                        size_min=1, size_max=40)
    out = {
        "fit_constrained": _raises(lambda: fit_constrained(
            x[20:], x[:20], y[:20], cfg, mesh=mesh)),
        "estimate_k": _raises(lambda: ek.estimate_k(
            x, y, np.ones(40, bool), 2, 8, mesh=mesh)),
        "fit_kmeans_dynamic_k": _raises(lambda: ek.fit_kmeans_dynamic_k(
            torch.Generator(), x, 2, 8, mesh=mesh)),
        "make_gcd_state": _raises(lambda: gcd.make_gcd_state(
            None, None, mesh=mesh)),
        "GCDTrainer": _raises(lambda: GCDTrainer(
            None, None, mesh=mesh, device=mesh.device)),
    }
    for name in ("train_uno_e2e", "train_autonovel_e2e"):
        fn = getattr(baselines_e2e, name)
        out[name] = _raises(lambda: fn(None, 0, None, None, None, None,
                                       mesh=mesh))
    return out


def library_cases(data: Dict) -> Dict:
    """The library's mesh paths at the world's size: the row contracts,
    k-means++ (both seeders), the three fitters, the sharded EM
    iteration and the vocabulary-sharded top-k, and the refusals."""
    from scd_tpu_torch.cluster.kmeans import (fit_kmeans,
                                              fit_kmeans_from_labels,
                                              fit_sskm)
    from scd_tpu_torch.ops.em import em_iteration_sharded
    from scd_tpu_torch.ops.kpp import (kmeans_plus_plus,
                                       kmeans_plus_plus_local_trials)
    from scd_tpu_torch.ops.topk import classify_topk_sharded

    world = multihost.process_count()
    mesh = make_mesh(MeshConfig(data=world, model=1))
    dev = mesh.device
    out: Dict = {"rows": _row_contracts(mesh)}
    x, y = data["x"], data["y"]
    xs = _share(x, mesh)
    from scd_tpu_torch.cluster.kmeans import _Shard

    shard = _Shard(xs, mesh)
    k = int(data["k"])
    kpp = {}
    for name, fn in (("kpp", kmeans_plus_plus),
                     ("kpp_local_trials", kmeans_plus_plus_local_trials)):
        g = torch.Generator(device=dev).manual_seed(3)
        _, kpp[name] = fn(shard.x, k, g, n_valid=shard.local_mask,
                          mesh=mesh, return_index=True)
    g = torch.Generator(device=dev).manual_seed(3)
    pre = torch.as_tensor(data["pre"], device=dev)
    _, kpp["kpp_pre"] = kmeans_plus_plus(shard.x, k, g, pre_centers=pre,
                                         n_valid=shard.local_mask,
                                         mesh=mesh, return_index=True)
    out["kpp"] = kpp

    cfg = data["cfg"]
    for name, c in (("kmeans", data["cfg_km"]), ("kmeans_k", cfg)):
        res = fit_kmeans(xs, c, mesh=mesh)
        out[name] = (res.labels, res.centers, res.inertia, res.n_iter)
    mask = data["mask_lab"]
    res = fit_sskm(_share(x[~mask], mesh), x[mask], y[mask], cfg, mesh=mesh)
    out["sskm"] = (res.labels, res.centers, res.inertia, res.n_iter)
    res = fit_kmeans_from_labels(xs, _share(data["init_labels"], mesh), cfg,
                                 mesh=mesh)
    out["from_labels"] = (res.labels, res.centers, res.inertia, res.n_iter)

    xsep, ysep, msep = data["x_sep"], data["y_sep"], data["mask_sep"]
    out["kmeans_sep"] = fit_kmeans(_share(xsep, mesh), cfg, mesh=mesh).labels
    out["sskm_sep"] = fit_sskm(_share(xsep[~msep], mesh), xsep[msep],
                               ysep[msep], cfg, mesh=mesh).labels

    centers = torch.as_tensor(data["centers"], device=dev)
    lab, sums, counts, inertia = em_iteration_sharded(
        shard.x, centers, shard.row_w, mesh)
    out["em"] = (shard.fetch(lab), sums.cpu().numpy(), counts.cpu().numpy(),
                 float(inertia))

    vmesh = make_mesh(MeshConfig(data=1, model=world))
    vals, idx = classify_topk_sharded(data["feats"], data["zw"],
                                      int(data["topk"]), vmesh)
    raw, _ = classify_topk_sharded(data["feats"], data["zw"],
                                   int(data["topk"]), vmesh,
                                   apply_softmax=False)
    out["topk"] = (vals.cpu().numpy(), idx.cpu().numpy(), raw.cpu().numpy())
    out["refusals"] = _refusals(mesh, data)
    return out


def tiny_clip_config():
    """A CLIP of width 32 and two text blocks at 16 px (the JAX package's
    test towers' size)."""
    from scd_tpu_torch.models.clip import CLIPConfig
    from scd_tpu_torch.models.vit import ViTConfig

    return CLIPConfig(
        vision=ViTConfig(image_size=16, patch_size=8, width=32, depth=1,
                         heads=4, quick_gelu=True, pre_post_norm=True,
                         output_proj=16, patch_bias=False),
        vocab_size=512, context_length=77, text_width=32, text_depth=2,
        text_heads=4, embed_dim=16)


def _tiny_text_encoder(dev):
    """(encode_text with forward / variables / tokenize, as the pipeline's)
    over the tiny CLIP with weights fabricated from seed 0 in the OpenAI
    layout and the hash tokenizer."""
    from scd_tpu_torch.models import (CLIPModel, load_openai_clip_weights,
                                      params_from_flax)
    from scd_tpu_torch.models.tokenizer import HashTokenizer
    from scd_tpu_torch.testing.fabricate import clip_state_dict

    cfg = tiny_clip_config()
    model = CLIPModel(cfg, device=dev).eval()
    model.load_state_dict(params_from_flax(load_openai_clip_weights(
        clip_state_dict(cfg, seed=0), cfg)))
    tok = HashTokenizer(vocab_size=512)

    def forward(m, t):
        with torch.inference_mode():
            return m.encode_text(torch.as_tensor(t).to(dev))

    def encode(texts):
        return forward(model, tok(texts)).cpu().numpy()

    encode.forward, encode.variables, encode.tokenize = forward, model, tok
    return encode


def _lines(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue().splitlines()


def digest(*arrays) -> str:
    """sha256 over arrays' bytes (and strings), for comparing ranks."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.asarray(a).tobytes() if not isinstance(a, str)
                 else a.encode())
    return h.hexdigest()


def run_digest(res: Dict) -> str:
    """A run's result dict as one digest: the cluster predictions, the
    final votes and candidate names, and every metric of the history."""
    v = res["voting"]
    metrics = [f"{k}={h[k]!r}" for h in v.history for k in sorted(h)]
    return digest(np.asarray(v.u_preds), "|".join(v.cand_names),
                  "|".join(metrics))


def _extraction(mesh, dev, n_batch: int) -> Dict:
    """The sharded encoder on a tiny ViT (a full and a ragged batch, the
    staged form) and extraction of the synthetic dataset over the ranks,
    each beside the same computed on this rank alone."""
    from scd_tpu_torch.core.config import DataConfig
    from scd_tpu_torch.data import get_class_splits, get_datasets
    from scd_tpu_torch.models.params import flax_init_
    from scd_tpu_torch.models.synthetic import SyntheticCLIP
    from scd_tpu_torch.models.vit import ViTConfig, VisionTransformer
    from scd_tpu_torch.pipelines.common import (
        _pod_shard, extract_features, extract_features_pod,
        make_shared_extractor, make_sharded_image_encoder)
    from scd_tpu_torch.pipelines.unsup import _image_encoder

    vit = flax_init_(VisionTransformer(ViTConfig(
        image_size=16, patch_size=8, width=32, depth=2, heads=4),
        device=dev), 0).eval()
    encode = _image_encoder(vit, lambda x: x.float(), dev)
    sharded = make_sharded_image_encoder(encode, mesh)
    out = {}
    for name, n in (("full", n_batch), ("ragged", 13)):
        images = np.random.default_rng(n).standard_normal(
            (n, 16, 16, 3)).astype(np.float32)
        mine = _pod_shard(images, mesh)
        out[name] = (sharded(mine), encode(images))
    out["staged_equal"] = bool(np.array_equal(
        sharded(sharded.stage(mine)), out["ragged"][0]))

    dcfg = DataConfig(dataset_name="synthetic", prop_train_labels=0.5)
    train_classes, _ = get_class_splits(dcfg)
    train, _t, _u, extras = get_datasets(dcfg)
    clip = SyntheticCLIP(extras["class_colors"], device=dev)
    single = extract_features(clip.encode_image, train, train_classes,
                              batch_size=64, num_workers=1)
    enc = make_sharded_image_encoder(clip.encode_image, mesh)
    pod = extract_features_pod({"feat": enc}, train, train_classes,
                               batch_size=64, num_workers=1)["feat"]
    shared = make_shared_extractor(enc, enc, train, train_classes, 64, 1)
    out["extract"] = (pod, single, shared("clip"))
    return out


def _vocabulary(mesh, dev) -> Dict:
    """The name-sharded vocabulary build beside the single-process build,
    on the tiny text tower with the 80 ImageNet templates."""
    from scd_tpu_torch.naming.templates import IMAGENET_TEMPLATES
    from scd_tpu_torch.naming.zeroshot import (build_zeroshot_weights,
                                               build_zeroshot_weights_sharded)

    enc = _tiny_text_encoder(dev)
    names = [f"name{i} word" if i % 3 else f"n{i}" for i in range(29)]
    args = (enc.forward, enc.variables, enc.tokenize, names,
            IMAGENET_TEMPLATES)
    single = build_zeroshot_weights_sharded(*args, names_per_batch=6)
    sharded = build_zeroshot_weights_sharded(*args, names_per_batch=6,
                                             mesh=mesh)
    dispatch = build_zeroshot_weights(enc, names, IMAGENET_TEMPLATES,
                                      names_per_batch=6, mesh=mesh)
    return {"single": single, "sharded": sharded, "dispatch": dispatch}


def _synthetic_config(cache_dir: str, algorithm: str = "SSKM"):
    from scd_tpu_torch.core.config import (DataConfig, FeatureConfig,
                                           NamingConfig, PipelineConfig)

    return PipelineConfig(
        data=DataConfig(dataset_name="synthetic", cache_dir=cache_dir),
        feature=FeatureConfig(feat_model="synthetic"),
        cluster=ClusterConfig(algorithm=algorithm, n_clusters=10, n_init=3,
                              max_iterations=20),
        naming=NamingConfig(corpus="synthetic", topk=5, num_common_vote=5,
                            num_common_linear=3),
        mesh=MeshConfig(data=0, model=1))


def synthetic_runs(cache_dir: str, device: str = "cpu") -> Dict:
    """``run_unsup`` and ``run_ptsup`` on the synthetic dataset (SSKM),
    each run's digest, its printed lines and its cluster accuracy; over
    ranks when called in a world, else on one process."""
    from scd_tpu_torch.pipelines.ptsup import run_ptsup
    from scd_tpu_torch.pipelines.unsup import run_unsup

    out = {}
    for kind, fn in (("unsup", run_unsup), ("ptsup", run_ptsup)):
        cfg = _synthetic_config(os.path.join(cache_dir, kind))
        res, lines = _lines(fn, cfg, device=device)
        out[kind] = {"digest": run_digest(res), "lines": lines,
                     "u_preds": np.asarray(res["voting"].u_preds),
                     "iou": res["iou"]}
        if "cluster_acc" in res:
            out[kind]["cluster_acc"] = res["cluster_acc"]
    return out


def serving(images_path: str, device: str = "cpu",
            mesh_data: int = 0) -> Dict:
    """``infer.main`` on the synthetic smoke and on ``images_path`` (a .npy
    batch) through a tiny CLIP with seeded random weights, at
    ``--mesh_data mesh_data`` (0: every launched rank): (returned value,
    printed lines) of each."""
    import scd_tpu_torch.models as models
    from scd_tpu_torch.pipelines import infer

    mesh = ["--mesh_data", str(mesh_data), "--device", device]
    out = {"synthetic": _lines(infer.main, [
        "--dataset_name", "synthetic", "--topk", "3"] + mesh)}
    tmp = os.path.dirname(images_path)
    names = [f"name{i}" for i in range(12)]
    with open(os.path.join(tmp, "names.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    zw = np.random.default_rng(5).standard_normal((16, 12)).astype(
        np.float32)
    np.save(os.path.join(tmp, "zw.npy"), zw / np.linalg.norm(
        zw, axis=0, keepdims=True))
    full = models.clip_vit_b16_config
    models.clip_vit_b16_config = lambda compute_dtype=None, \
        dense_int8=False: tiny_clip_config()
    try:
        out["real"] = _lines(infer.main, [
            "--dataset_name", "real", "--clip_weights", "random",
            "--zeroshot_weights", os.path.join(tmp, "zw.npy"),
            "--names", os.path.join(tmp, "names.txt"),
            "--images", images_path, "--batch_size", "8", "--topk", "2"]
            + mesh)
    finally:
        models.clip_vit_b16_config = full
    return out


def pipeline_cases(data: Dict) -> Dict:
    """Extraction, the vocabulary build, the synthetic runs and serving
    over the world's ranks (``data``: ``cache_dir``, ``images``)."""
    world = multihost.process_count()
    mesh = make_mesh(MeshConfig(data=world, model=1))
    dev = mesh.device
    out = _extraction(mesh, dev, 32)
    out["vocabulary"] = _vocabulary(mesh, dev)
    out["runs"] = synthetic_runs(data["cache_dir"], dev.type)
    out["serving"] = serving(data["images"], dev.type, mesh_data=world)
    return out


def foreign_modules() -> list:
    """The JAX and JAX-package modules in this rank's ``sys.modules`` after
    it made a mesh and ran one sharded EM iteration (empty: the rank runs
    the port alone)."""
    import sys

    from scd_tpu_torch.ops.em import em_iteration_sharded

    mesh = make_mesh(MeshConfig())
    x = torch.ones(4, 3, device=mesh.device)
    em_iteration_sharded(x, x[:2].clone(), None, mesh)
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                  or m == "scd_tpu" or m.startswith("scd_tpu."))


# ------------------------------------------------------------ on the card
#
# ``chip_smoke.py``'s phase 13 and ``tests/test_torch_gpu.py`` run these in
# worlds on one card: ``mesh_stage_references`` at world size 1 over NCCL
# (the explicit mesh of one rank against the mesh-free fit, and the
# single-process references), ``mesh_stages`` at world size 2 over gloo
# with both ranks on the card.  ``spec`` sizes them:
#   cfg     a warm ImageNet-100 root's PipelineConfig (its stage cache:
#           features, targets, mask_lab; its zero-shot matrix)
#   towers  "vit_b16" (CLIP and DINO ViT-B/16 at full width, bf16, weights
#           fabricated from seed) or "tiny" (tiny_clip_config's towers)
#   images, batch, names, topk_rows, k, seed, bpe (a merges file)


def _launches() -> Dict[str, int]:
    from scd_tpu_torch.ops import attention, em, topk

    return {"fused_em_step": em.fused_em_step_cuda.launches,
            "topk_softmax": topk.topk_softmax_cuda.launches,
            "attention": attention.attention_cuda.launches}


def _reset_launches() -> None:
    from scd_tpu_torch.ops import attention, em, topk

    em.fused_em_step_cuda.launches = 0
    topk.topk_softmax_cuda.launches = 0
    attention.attention_cuda.launches = 0


def _card_towers(spec, dev):
    """(image encoders {"dino", "clip"}, encode_text) on ``dev``, the
    pipeline's closures (``pipelines/unsup.py``) over towers with weights
    fabricated from ``spec["seed"]``."""
    from scd_tpu_torch.data.transforms import device_normalize_clip
    from scd_tpu_torch.models import (CLIPModel, CLIPTokenizer,
                                      VisionTransformer, clip_vit_b16_config,
                                      dino_vit_b16_config, load_dino_weights,
                                      load_openai_clip_weights,
                                      params_from_flax)
    from scd_tpu_torch.models.tokenizer import HashTokenizer
    from scd_tpu_torch.models.vit import ViTConfig
    from scd_tpu_torch.naming.zeroshot import truncate_to_eot_bucket
    from scd_tpu_torch.pipelines.unsup import _image_encoder
    from scd_tpu_torch.testing.fabricate import (clip_state_dict,
                                                 dino_state_dict)

    seed = spec["seed"]
    if spec["towers"] == "vit_b16":
        ccfg = clip_vit_b16_config(torch.bfloat16)
        dcfg = dino_vit_b16_config(torch.bfloat16)
        tok = CLIPTokenizer(spec["bpe"])
    else:
        ccfg = tiny_clip_config()
        dcfg = ViTConfig(image_size=16, patch_size=8, width=32, depth=2,
                         heads=4)
        tok = HashTokenizer(vocab_size=512)
    clip = CLIPModel(ccfg, device=dev).eval()
    clip.load_state_dict(params_from_flax(load_openai_clip_weights(
        clip_state_dict(ccfg, seed), ccfg)))
    dino = VisionTransformer(dcfg, device=dev).eval()
    dino.load_state_dict(params_from_flax(load_dino_weights(
        dino_state_dict(dcfg, seed + 1), dcfg)))

    def text_forward(model, tokens):
        with torch.inference_mode():
            return model.encode_text(torch.as_tensor(tokens).to(dev))

    def encode_text(texts):
        toks = truncate_to_eot_bucket(np.asarray(tok(texts), np.int32))
        return text_forward(clip, toks).cpu().numpy()

    encode_text.forward, encode_text.variables = text_forward, clip
    encode_text.tokenize = tok
    images = {"dino": _image_encoder(dino, device_normalize_clip, dev),
              "clip": _image_encoder(clip.visual, device_normalize_clip,
                                     dev)}
    return images, encode_text, (clip, dino)


def _batch_images(spec, b: int, dev) -> torch.Tensor:
    """Batch ``b`` of the fabricated uint8 images (the same on every rank
    and in every run)."""
    size = 224 if spec["towers"] == "vit_b16" else 16
    n = min(spec["batch"], spec["images"] - b * spec["batch"])
    g = torch.Generator(device=dev).manual_seed(spec["seed"] * 100_003 + b)
    return torch.randint(0, 256, (n, size, size, 3), generator=g,
                         device=dev, dtype=torch.uint8)


def _names(spec, encode_text):
    if spec["towers"] == "vit_b16":
        from scd_tpu_torch.testing.fabricate import short_names

        return short_names(encode_text.tokenize, spec["names"], spec["seed"])
    return [f"name{i} word" for i in range(spec["names"])]


def _encode_all(spec, encoders, dev, mesh=None):
    """Every batch through both towers: the full batch, or over a mesh
    this rank's share of it; {tower: [N, D] f32}."""
    from scd_tpu_torch.pipelines.common import (_pod_shard,
                                                make_sharded_image_encoder)

    if mesh is not None:
        encoders = {k: make_sharded_image_encoder(e, mesh)
                    for k, e in encoders.items()}
    out = {k: [] for k in encoders}
    for b in range(-(-spec["images"] // spec["batch"])):
        images = _batch_images(spec, b, dev)
        if mesh is not None:
            images = _pod_shard(images, mesh)
        for k, enc in encoders.items():
            out[k].append(np.asarray(enc(images), np.float32))
    return {k: np.concatenate(v) for k, v in out.items()}


def _timed(seconds: Dict, name: str, fn, *a, **kw):
    import time

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    seconds[name] = time.perf_counter() - t0
    return out


def _warm_up(spec, encoders, encode_text, dev) -> None:
    """One small batch through every tower, untimed, so that no timed
    stage pays the first launches (library loads, cuBLAS handles)."""
    images = _batch_images(spec, 0, dev)[:8]
    for enc in encoders.values():
        enc(images)
    encode_text(["a photo of a warm up."] * 8)


def _warm_inputs(spec):
    from scd_tpu_torch.pipelines.common import feature_cache_key, stage_cache

    cfg = spec["cfg"]
    cache = stage_cache(cfg)
    feats = cache.load("features", feature_cache_key(cfg, "feat"))
    clip = cache.load("features", feature_cache_key(cfg, "clip"))
    zw = np.load(cfg.data.zeroshot_weights)["weights"]
    u_clip = clip["all_feats"][~clip["mask_lab"].astype(bool)]
    return cfg, feats, u_clip[:spec["topk_rows"]], zw


def mesh_stage_references(spec: Dict) -> Dict:
    """World size 1 (NCCL on a card): ``fit_sskm`` on the warm root's
    features with an explicit mesh of one rank against the mesh-free call
    (labels and inertia must be equal), then the single-process results
    and seconds of the stages ``mesh_stages`` shards: both towers over the
    images, ``run_clustering``, the vocabulary build and the top-k."""
    from scd_tpu_torch.cluster.kmeans import fit_sskm
    from scd_tpu_torch.naming.templates import IMAGENET_TEMPLATES
    from scd_tpu_torch.naming.zeroshot import build_zeroshot_weights_sharded
    from scd_tpu_torch.ops.topk import classify_topk
    from scd_tpu_torch.pipelines.common import run_clustering

    mesh = make_mesh(MeshConfig(data=1, model=1))
    dev = mesh.device
    cfg, feats, u_clip, zw = _warm_inputs(spec)
    mask = feats["mask_lab"].astype(bool)
    x, t = feats["all_feats"], feats["targets"].astype(np.int64)
    sec: Dict[str, float] = {}
    # untimed, so neither timed fit pays the first launches
    fit_sskm(x[~mask][:4096], x[mask], t[mask], dataclasses.replace(
        cfg.cluster, n_init=1, max_iterations=1), device=dev)
    _reset_launches()
    with_mesh = _timed(sec, "fit_sskm_mesh1", fit_sskm, x[~mask], x[mask],
                       t[mask], cfg.cluster, mesh=mesh)
    out = {"launches_mesh1": _launches()}
    alone = _timed(sec, "fit_sskm", fit_sskm, x[~mask], x[mask], t[mask],
                   cfg.cluster, device=dev)
    out["sskm"] = {"labels_equal": bool(np.array_equal(with_mesh.labels,
                                                       alone.labels)),
                   "inertia": (with_mesh.inertia, alone.inertia),
                   "n_iter": (with_mesh.n_iter, alone.n_iter)}
    encoders, encode_text, _ = _card_towers(spec, dev)
    _warm_up(spec, encoders, encode_text, dev)
    _reset_launches()
    out["features"] = _timed(sec, "encoders", _encode_all, spec, encoders,
                             dev)
    out["clusters"] = _timed(sec, "run_clustering", run_clustering, cfg,
                             feats, device=dev)["u_preds"]
    names = _names(spec, encode_text)
    out["vocabulary"] = _timed(
        sec, "vocabulary", build_zeroshot_weights_sharded,
        encode_text.forward, encode_text.variables, encode_text.tokenize,
        names, IMAGENET_TEMPLATES)
    f = torch.as_tensor(u_clip, device=dev)
    w = torch.as_tensor(zw, device=dev)
    vals, idx = _timed(sec, "topk", classify_topk, f, w, spec["k"])
    out["topk"] = (vals.cpu().numpy(), idx.cpu().numpy())
    out["launches"] = _launches()
    out["seconds"] = sec
    return out


def mesh_stages(spec: Dict) -> Dict:
    """The sharded stages over this world's ranks (gloo on one card): the
    data-parallel image encoders, ``run_clustering`` with the mesh, the
    name-sharded vocabulary build and ``classify_topk_sharded`` over the
    ``model`` axis; each rank's results, launches and seconds."""
    from scd_tpu_torch.naming.templates import IMAGENET_TEMPLATES
    from scd_tpu_torch.naming.zeroshot import build_zeroshot_weights_sharded
    from scd_tpu_torch.ops.topk import classify_topk_sharded
    from scd_tpu_torch.pipelines.common import run_clustering

    world = multihost.process_count()
    mesh = make_mesh(MeshConfig(data=world, model=1))
    vmesh = make_mesh(MeshConfig(data=1, model=world))
    dev = mesh.device
    cfg, feats, u_clip, zw = _warm_inputs(spec)
    encoders, encode_text, towers = _card_towers(spec, dev)
    multihost.replicate_to_mesh(mesh, list(towers))
    _warm_up(spec, encoders, encode_text, dev)
    sec: Dict[str, float] = {}
    names = _names(spec, encode_text)
    _reset_launches()
    out = {"features": _timed(sec, "encoders", _encode_all, spec, encoders,
                              dev, mesh)}
    out["clusters"] = _timed(sec, "run_clustering", run_clustering, cfg,
                             feats, device=dev, mesh=mesh)["u_preds"]
    out["vocabulary"] = _timed(
        sec, "vocabulary", build_zeroshot_weights_sharded,
        encode_text.forward, encode_text.variables, encode_text.tokenize,
        names, IMAGENET_TEMPLATES, mesh=mesh)
    vals, idx = _timed(sec, "topk", classify_topk_sharded, u_clip, zw,
                       spec["k"], vmesh)
    out["topk"] = (vals.cpu().numpy(), idx.cpu().numpy())
    out["launches"] = _launches()
    out["seconds"] = sec
    return out
