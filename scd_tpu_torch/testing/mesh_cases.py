"""Functions each rank of a world runs (``testing/dist.py::spawn``): the
mesh paths of the port at small sizes, for the CPU tests
(``tests/test_torch_mesh*.py``) and ``chip_smoke.py``'s phases 13-15.

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
from types import SimpleNamespace
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


def _raised(fn):
    """(exception type name, message) of what ``fn()`` raises, or
    ("", result) when it returns."""
    try:
        return "", fn()
    except Exception as e:  # noqa: BLE001 - the exception is the result
        return type(e).__name__, str(e)


def tiny_trainers(mesh, heads: int) -> Dict:
    """The four trainers at a tiny ViT (``heads`` heads of width 8, one
    block, 16 px) under ``mesh`` (a ``data`` 1 x ``model`` world mesh, or
    None for one process), on data made from a fixed seed:
    ``make_gcd_state``'s loss of one step, the bytes of ``GCDTrainer``'s
    tensor-parallel parameters on this rank, and the one epoch's loss of
    each e2e trainer."""
    from scd_tpu_torch.core.config import TrainConfig
    from scd_tpu_torch.models.params import tp_bytes
    from scd_tpu_torch.models.vit import ViTConfig
    from scd_tpu_torch.train import baselines_e2e, gcd

    dev = _device(mesh)
    vit = ViTConfig(image_size=16, patch_size=8, width=8 * heads, depth=1,
                    heads=heads)
    cfg = TrainConfig(grad_from_block=0, proj_dim=16, batch_size=4)
    rng = np.random.default_rng(5)
    views = rng.standard_normal((2, 4, 16, 16, 3)).astype(np.float32)
    labels, mask = np.array([0, 1, 2, 3]), np.array([True, True, False, False])
    # one trainer serves both: its step is make_gcd_state's
    tr = gcd.GCDTrainer(vit, cfg, total_steps=4, device=dev, mesh=mesh)
    batch = {"images": torch.from_numpy(views.reshape(8, 16, 16, 3)).to(dev),
             "labels": torch.from_numpy(labels).to(dev),
             "mask_lab": torch.from_numpy(mask).to(dev)}
    kw = dict(epochs=1, batch_size=4, device=dev, mesh=mesh)
    return {
        "make_gcd_state": float(tr.step_fn(tr.model, tr.opt,
                                           batch)["loss"]),
        "GCDTrainer": tp_bytes(tr.model),
        "train_uno_e2e": baselines_e2e.train_uno_e2e(
            0, views, labels, mask, 2, 2, vit, num_heads=1, lr=0.05,
            **kw)[2][0]["loss"],
        "train_autonovel_e2e": baselines_e2e.train_autonovel_e2e(
            1, views[0], views[1], labels, mask, 2, 2, vit, lr=0.05,
            **kw)[2][0]["loss"]}


def _refusals(mesh, data) -> Dict:
    """The paths that refused a mesh before they ran over ranks, each with
    what it gives now:
    the four trainers under a mesh of ``data`` 1 x ``model`` world train
    (:func:`tiny_trainers`); ``fit_constrained`` with the exact MCF
    backend over the world's ``data`` axis raises the JAX package's
    RuntimeError; ``estimate_k`` and ``fit_kmeans_dynamic_k`` over it
    return their results (each rank passes its share of 40 rows).
    {path: (exception type name or "", message or result)}."""
    import importlib

    from scd_tpu_torch.cluster.constrained import fit_constrained

    ek = importlib.import_module("scd_tpu_torch.cluster.estimate_k")
    x = data["x"][:40]
    y = data["y"][:40]
    cfg = ClusterConfig(n_clusters=4, n_init=1, max_iterations=2,
                        size_min=1, size_max=40, constrained_backend="mcf")
    tp = make_mesh(MeshConfig(data=1, model=mesh.size))
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    out = {
        "fit_constrained": _raised(lambda: fit_constrained(
            _share(x[20:], mesh), x[:20], y[:20], cfg, mesh=mesh)),
        "estimate_k": _raised(lambda: ek.estimate_k(
            _share(x, mesh), y, np.ones(40, bool), 2, 8, mesh=mesh)),
        "fit_kmeans_dynamic_k": _raised(lambda: ek.fit_kmeans_dynamic_k(
            gen, _share(x, mesh), 2, 8, mesh=mesh)),
    }
    kind, got = _raised(lambda: tiny_trainers(tp, mesh.size))
    for name in ("make_gcd_state", "GCDTrainer", "train_uno_e2e",
                 "train_autonovel_e2e"):
        out[name] = (kind, got if kind else got[name])
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


def prefix_vocab_build(spec: Dict) -> Dict:
    """The prefix-KV vocabulary build (``build_zeroshot_weights_prefix``)
    over the world's ``data`` axis (no mesh at world size 1), for each of
    ``spec["cases"]`` ({case: (names, templates, names_per_chunk)}), on a
    text tower made from ``spec``: ``"state"`` (a tiny CLIP's parameters,
    ``spec["cfg"]`` its config, the hash tokenizer of 512 ids) or
    ``"pipeline"`` (a cold root's ``PipelineConfig``: ``build_encoders``'
    bf16 tower with its BPE tokenizer).  Returns {case: [D, V] f32} and,
    under ``"launches"``, the prefix kernel's launches and its ``mma.sync``
    kernel's in the builds."""
    from scd_tpu_torch.naming.zeroshot import build_zeroshot_weights_prefix
    from scd_tpu_torch.ops import attention

    mesh = _world_mesh()
    dev = _device(mesh)
    if "pipeline" in spec:
        from scd_tpu_torch.pipelines.unsup import build_encoders

        enc = build_encoders(spec["pipeline"], {}, device=dev)[2]
    else:
        from scd_tpu_torch.models.clip import CLIPModel
        from scd_tpu_torch.models.tokenizer import HashTokenizer

        model = CLIPModel(spec["cfg"], device=dev).eval()
        model.load_state_dict(spec["state"])

        enc = SimpleNamespace(
            forward=lambda m, t: m.encode_text(torch.as_tensor(t).to(dev)),
            prefix_forward=lambda m, t: m.encode_text_prefix(
                torch.as_tensor(t).to(dev)),
            suffix_forward=lambda m, t, kv, p: m.encode_text_suffix(
                torch.as_tensor(t).to(dev), kv, p),
            variables=model, tokenize=HashTokenizer(vocab_size=512))
    pa = attention.prefix_attention_cuda
    pa.launches = pa.mma_launches = 0
    out = {}
    with torch.inference_mode():
        for case, (names, templates, chunk) in spec["cases"].items():
            out[case] = build_zeroshot_weights_prefix(
                enc.forward, enc.prefix_forward, enc.suffix_forward,
                enc.variables, enc.tokenize, names, templates, mesh=mesh,
                names_per_chunk=chunk)
    out["launches"] = {"prefix_attention": pa.launches,
                       "prefix_attention_mma": pa.mma_launches}
    return out


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


# ------------------------------------ ConSSKM, estimate_k and training
#
# Each function below runs at any world size: over a mesh of the world's
# ranks when there are several, on the single-device path in a world of
# one (``chip_smoke.py``'s phase 14 reference over NCCL) or with no
# process group at all (the CPU tests' one-process reference).  Row inputs
# arrive in full and each rank takes its contiguous share.

def _world_mesh(model: int = 1):
    world = multihost.process_count()
    if world == 1:
        return None
    return make_mesh(MeshConfig(data=world // model, model=model))


def _device(mesh):
    return mesh.device if mesh is not None else multihost.local_device()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _seconds(fn, dev):
    import time

    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _constrained_counters() -> Dict:
    from scd_tpu_torch.cluster.constrained import fit_constrained
    from scd_tpu_torch.ops.sinkhorn import sinkhorn_constrained_assign as sk

    return {"e_steps": sk.calls, "dual_iterations": sk.dual_iterations,
            "repair_passes": sk.repair_passes,
            "mcf_fallbacks": fit_constrained.mcf_fallbacks}


def _reset_constrained() -> None:
    from scd_tpu_torch.cluster.constrained import reset_counters
    from scd_tpu_torch.ops.sinkhorn import sinkhorn_constrained_assign as sk

    reset_counters()
    sk.calls = sk.dual_iterations = sk.repair_passes = 0


def constrained_fit(spec: Dict) -> Dict:
    """``fit_constrained`` on ``spec``'s (x_u, x_l, y_l, cfg), over the
    world's ranks (each its share of x_u) or alone: labels, centers,
    inertia, iterations, the Sinkhorn counters and seconds; with
    ``spec["mesh1"]`` also the same fit under an explicit mesh of this
    world's one rank (a world of one only)."""
    from scd_tpu_torch.cluster.constrained import fit_constrained

    mesh = _world_mesh()
    dev = _device(mesh)
    x_u, x_l, y_l, cfg = (spec[k] for k in ("x_u", "x_l", "y_l", "cfg"))
    out = {}
    runs = [("fit", mesh)]
    if spec.get("mesh1"):
        runs.append(("mesh1", make_mesh(MeshConfig(data=1, model=1))))
    for name, m in runs:
        _reset_constrained()
        res, sec = _seconds(lambda: fit_constrained(
            x_u if m is None else _share(x_u, m), x_l, y_l, cfg,
            device=dev, mesh=m), dev)
        out[name] = {"labels": res.labels, "centers": res.centers,
                     "inertia": res.inertia, "n_iter": res.n_iter,
                     "counters": _constrained_counters(), "seconds": sec}
    return out


def sinkhorn_rows(cost: np.ndarray, row_mask: np.ndarray, k: int,
                  size_min: int, size_max: int, eps: float) -> Dict:
    """``sinkhorn_constrained_assign`` on a padded cost [N, K] whose rows
    the world's ranks split in equal blocks (``row_mask`` marks the real
    rows): every rank's labels gathered in order, the duals, the flag."""
    from scd_tpu_torch.ops.sinkhorn import sinkhorn_constrained_assign

    mesh = _world_mesh()
    dev = _device(mesh)
    width = len(cost) // (1 if mesh is None else mesh.n_data)
    lo = 0 if mesh is None else mesh.data_index * width
    got = sinkhorn_constrained_assign(
        torch.as_tensor(cost[lo:lo + width], device=dev), k, size_min,
        size_max, eps=eps,
        row_mask=torch.as_tensor(row_mask[lo:lo + width], device=dev),
        mesh=mesh)
    return {"labels": multihost.host_fetch(got.labels, mesh),
            "duals": got.col_duals.cpu().numpy(), "feasible": got.feasible}


def estimate_k_search(spec: Dict) -> Dict:
    """``estimate_k`` over ``spec``'s features (``x``, or ``path`` to a
    features_packed.npz), each rank its share, ``spec["n_init"]``
    restarts a probe when given: (K, objective), the
    ``fused_em_step`` launches, seconds; and ``fit_kmeans_dynamic_k`` at
    ``spec["k_fit"]`` (labels, inertia) when asked."""
    import importlib

    ek = importlib.import_module("scd_tpu_torch.cluster.estimate_k")
    from scd_tpu_torch.ops import em

    mesh = _world_mesh()
    dev = _device(mesh)
    if "path" in spec:
        with np.load(spec["path"]) as z:
            x, y, mask = z["features"], z["targets"], z["mask_lab"]
    else:
        x, y, mask = spec["x"], spec["y"], spec["mask_lab"]
    mask = mask.astype(bool)
    mine = x if mesh is None else _share(x, mesh)
    em.fused_em_step_cuda.launches = 0

    def search():
        # spec["n_init"]: the objective's restarts a probe (default 3)
        obj = None if "n_init" not in spec else \
            ek.labelled_acc_objective_dynamic(
                mine, y, mask, spec["max_k"], n_init=spec["n_init"],
                mesh=mesh, device=dev)
        return ek.estimate_k(mine, y, mask, spec["min_k"], spec["max_k"],
                             method=spec["method"], objective=obj,
                             mesh=mesh, device=dev)

    best, sec = _seconds(search, dev)
    out = {"best": best, "seconds": sec,
           "fused_em_step": em.fused_em_step_cuda.launches}
    if "k_fit" in spec:
        gen = torch.Generator(device=dev).manual_seed(0)
        out["dynamic_k"] = ek.fit_kmeans_dynamic_k(
            gen, mine, spec["k_fit"], spec["max_k"], mesh=mesh, device=dev)
    return out


def _state_from(params: Dict) -> Dict:
    return {k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}


def _gcd_batch(spec: Dict, step: int, lo: int, hi: int) -> Dict:
    """Rows [lo, hi) of the global GCD batch of ``step``: ``spec
    ["batches"][step]`` sliced, or images made per row from the seed (so
    a rank makes only its own rows): view-major images, labels, mask."""
    if "batches" in spec:
        b = spec["batches"][step]
        n = len(b["labels"])
        v = len(b["images"]) // n
        images = np.concatenate([b["images"][i * n + lo:i * n + hi]
                                 for i in range(v)])
        return {"images": images, "labels": b["labels"][lo:hi],
                "mask_lab": b["mask_lab"][lo:hi]}
    size, views = spec["image_size"], spec["views"]
    per_view = [[], []]
    labels, mask = [], []
    for i in range(lo, hi):
        g = torch.Generator().manual_seed(spec["seed"] * 1_000_003
                                          + step * 10_007 + i)
        img = torch.randn((views, size, size, 3), generator=g)
        for v in range(views):
            per_view[v].append(img[v].numpy())
        labels.append(int(torch.randint(0, 50, (1,), generator=g)))
        mask.append(bool(torch.rand((1,), generator=g) < 0.5))
    return {"images": np.concatenate([np.stack(p) for p in per_view]),
            "labels": np.asarray(labels, np.int64),
            "mask_lab": np.asarray(mask, bool)}


def quick_init_(module, seed: int = 0):
    """Random weights for the full-width runs on the card, drawn fast:
    normals from one CPU ``torch.Generator(seed)`` in ``named_parameters``
    order (``models.params.flax_init_``'s truncated normals take ~15 s a
    ViT-B/16 on the host): a kernel N(0, 1 / fan_in) (fan_in: every axis
    but the last, and but the first of a stacked ``Vmap_*`` kernel), a
    bias or CLS token zeros, a LayerNorm scale ones, anything else
    N(0, 0.02).  Returns ``module``."""
    import math

    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in module.named_parameters():
            path = name.split(".")
            if path[-1] in ("bias", "cls_token"):
                p.zero_()
            elif path[-1] == "scale":
                p.fill_(1.0)
            else:
                stacked = any(k.startswith("Vmap_") for k in path[:-1])
                std = (math.prod(p.shape[1 if stacked else 0:-1]) ** -0.5
                       if path[-1] == "kernel" else 0.02)
                p.copy_(torch.randn(p.shape, generator=gen) * std)
    return module


def _init_patch(spec: Dict, module, name: str):
    """``module.name`` (the initializer a trainer calls) replaced by
    :func:`quick_init_` when ``spec["quick_init"]``."""
    if not spec.get("quick_init"):
        return contextlib.nullcontext()
    return _patched(module, name, lambda model, seed=0: quick_init_(model,
                                                                    seed))


@contextlib.contextmanager
def _exact_rows(spec: Dict):
    """Under ``spec["exact_rows"]``, one process (no ``model`` group)
    computes its row-parallel layers (proj, fc2) as the tensor-parallel
    ranks do: f32 products of the compute-dtype operands, the bias, one
    rounding (``models.vit.Dense.partial``), in place of the GEMM at the
    compute dtype.  The same model with only those roundings changed: its
    distance to the plain one process is the noise floor a tensor-parallel
    run is held to in bf16 (``chip_smoke.py`` phase 15)."""
    from scd_tpu_torch.models import vit

    if not spec.get("exact_rows"):
        yield
        return
    real = vit.row_parallel

    def exact(dense, x, tp):
        if tp is not None:
            return real(dense, x, tp)
        return (dense.partial(x) + dense.cast_bias().float()).to(
            dense.compute_dtype)

    with _patched(vit, "row_parallel", exact):
        yield


def _gcd_trainer(spec: Dict, mesh, dev):
    from scd_tpu_torch.core.config import TrainConfig
    from scd_tpu_torch.models.vit import ViTConfig
    from scd_tpu_torch.train.gcd import GCDTrainer

    from scd_tpu_torch.train import gcd

    params = _state_from(spec["params"]) if "params" in spec else None
    with _init_patch(spec, gcd, "flax_init_"):
        return GCDTrainer(ViTConfig(**spec["vit"]),
                          TrainConfig(**spec["train"]),
                          seed=spec.get("init_seed", 0),
                          total_steps=spec["total_steps"], device=dev,
                          mesh=mesh, params=params)


def _same_tree(a, b) -> bool:
    """Two nested states (dicts, lists, tensors, numbers) bitwise equal."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same_tree, a, b))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a.cpu(), b.cpu()))
    return a == b


def _checkpoint_round_trip(tr, spec: Dict, mesh, dev) -> Dict:
    """``tr.state`` (full tensors) written to ``spec["ckpt_dir"]`` through
    ``CheckpointManager`` (rank 0 writes), restored on every rank into a
    fresh trainer on the same mesh (each rank its shard) and gathered
    again: the step and whether the two gathered states are bitwise
    equal."""
    from scd_tpu_torch.train.checkpoint import CheckpointManager

    state = tr.state
    mgr = CheckpointManager(spec["ckpt_dir"], keep=1)
    mgr.save(tr.opt.count, state)
    step, restored = mgr.restore()
    back = _gcd_trainer(spec, mesh, dev)
    back.load_state(restored)
    return {"step": step, "equal": _same_tree(state, back.state)}


def gcd_steps(spec: Dict) -> Dict:
    """Steps of ``make_gcd_state`` (through ``GCDTrainer``) over the
    world's ranks (a ``data`` x ``spec["model"]`` mesh, default model 1),
    each data rank its block of every global batch of
    ``spec["global_batch"]`` images, or alone on the whole batch: each
    step's loss, a digest of the (gathered) trainable parameters after
    each step, the trainable parameters at the start and the end
    (``spec["return_params"]``; rank 0 only), this rank's bytes of
    tensor-parallel parameters, its shards of them
    (``spec["return_shards"]``), a checkpoint round trip
    (``spec["ckpt_dir"]``), seconds a step and the attention launches,
    bf16 and f32.  The parameters start from ``spec["params"]`` (a full
    state dict), else from the seed: ``flax_init_``, or
    :func:`quick_init_` under ``spec["quick_init"]``; ``spec
    ["exact_rows"]``: see :func:`_exact_rows`."""
    from scd_tpu_torch.models.params import tp_bytes

    mesh = _world_mesh(spec.get("model", 1))
    dev = _device(mesh)
    tr = _gcd_trainer(spec, mesh, dev)
    p0 = _trainable(tr.model, tr.tp) if spec.get("return_params") else None
    n = spec["global_batch"]
    dm = tr.data_mesh
    lo, hi = (0, n) if dm is None else multihost.share_bounds(
        n, dm.n_data, dm.data_index)
    losses, digests, seconds = [], [], []
    _reset_attention()
    for step in range(spec["steps"]):
        batch = tr.to_device(_gcd_batch(spec, step, lo, hi))
        with _exact_rows(spec):
            metrics, sec = _seconds(
                lambda: tr.step_fn(tr.model, tr.opt, batch), dev)
        losses.append(float(metrics["loss"]))
        digests.append(digest(*_trainable(tr.model, tr.tp).values()))
        seconds.append(sec)
    out = {"losses": losses, "digests": digests, "seconds": seconds,
           "launches": _attention_launches(),
           "tp_bytes": tp_bytes(tr.model)}
    if spec.get("return_shards"):
        from scd_tpu_torch.models.params import tp_layout

        out["shards"] = {k: p.detach().cpu().numpy()
                         for k, p in tr.model.named_parameters()
                         if tp_layout(k, p.shape) is not None}
    if "ckpt_dir" in spec:
        out["ckpt"] = _checkpoint_round_trip(tr, spec, mesh, dev)
    if spec.get("return_params"):
        params = _trainable(tr.model, tr.tp)
        if multihost.process_index() == 0:
            out["params0"], out["params"] = p0, params
    return out


def _reset_attention() -> None:
    from scd_tpu_torch.ops import attention, w8a8

    for fn in (attention.attention_cuda, attention.qkv_attention_bwd_cuda):
        fn.launches = fn.f32_wgmma_launches = 0
    w8a8.w8a8_fusedq_cuda.launches = 0


def _attention_launches() -> Dict[str, int]:
    """The training kernels' launches since :func:`_reset_attention`: the
    attention and its gradient, all and the f32 ones (three TF32 passes
    at head_dim 64), and the fused W8A8 (the frozen int8 blocks)."""
    from scd_tpu_torch.ops import attention, w8a8

    fwd, bwd = attention.attention_cuda, attention.qkv_attention_bwd_cuda
    return {"attention": fwd.launches, "attention_bwd": bwd.launches,
            "attention_f32": fwd.f32_wgmma_launches,
            "attention_bwd_f32": bwd.f32_wgmma_launches,
            "w8a8_fusedq": w8a8.w8a8_fusedq_cuda.launches}


def _trainable(model, tp=None) -> Dict:
    """The trainable parameters as host f32 arrays of their own (no view
    of a CPU parameter), whole: under ``tp`` gathered over the model group
    (every rank of it calls)."""
    from scd_tpu_torch.models.params import gather_tensor

    return {k: np.array(gather_tensor(k, p, tp).detach().float().cpu())
            for k, p in model.named_parameters() if p.requires_grad}


def e2e_runs(spec: Dict) -> Dict:
    """``train_uno_e2e`` and ``train_autonovel_e2e`` over the world's ranks
    (a ``data`` x ``spec["model"]`` mesh, default model 1) or alone, from
    ``spec["inits"][method]`` (state dicts, or the port's
    seeded init when absent; :func:`quick_init_`'s under
    ``spec["quick_init"]``) on the in-memory ``views`` / ``labels`` /
    ``mask_lab`` (or images made from ``spec["seed"]``), with each
    method's keyword arguments ``spec["kw"][method]``: each method's
    history, best head, predictions on the first view, seconds and f32
    attention launches."""
    import contextlib

    from scd_tpu_torch.models.vit import ViTConfig
    from scd_tpu_torch.ops import attention
    from scd_tpu_torch.train import baselines as B
    from scd_tpu_torch.train import baselines_e2e as E

    mesh = _world_mesh(spec.get("model", 1))
    dev = _device(mesh)
    if "views" in spec:
        views, labels, mask = spec["views"], spec["labels"], spec["mask_lab"]
    else:
        rng = np.random.default_rng(spec["seed"])
        n, size = spec["images"], spec["vit"]["image_size"]
        views = rng.standard_normal((2, n, size, size, 3)).astype(np.float32)
        labels = rng.integers(0, spec["n_labeled"] * 2, n)
        mask = (labels < spec["n_labeled"]) & (rng.random(n) < 0.5)
        mask[0], labels[0] = True, 3  # one labelled row at least
    vit = ViTConfig(**spec["vit"])
    nl = spec["n_labeled"]

    def kw(method):
        return dict(spec["kw"][method], device=dev, mesh=mesh)

    runs = {"uno": lambda: E.train_uno_e2e(
                0, views, labels, mask, nl, nl, vit,
                num_heads=spec["num_heads"],
                overcluster_factor=spec.get("overcluster_factor", 0),
                **kw("uno")),
            "autonovel": lambda: E.train_autonovel_e2e(
                1, views[0], views[1], labels, mask, nl, nl, vit,
                **kw("autonovel"))}
    out = {}
    for method, run in runs.items():
        inits = spec.get("inits", {})
        patch = _init_patch(spec, B, "_init_params")
        if method in inits:
            state = _state_from(inits[method])
            patch = _patched(B, "_init_params", lambda model, _seed: (
                model.load_state_dict(state), model)[1])
        attention.attention_cuda.f32_wgmma_launches = 0
        attention.qkv_attention_bwd_cuda.f32_wgmma_launches = 0
        with patch:
            (st, predict, hist), sec = _seconds(run, dev)
        out[method] = {
            "history": hist, "best_head": st.get("best_head"),
            "preds": predict(views[0]), "seconds": sec,
            "launches": {
                "attention_f32": attention.attention_cuda.f32_wgmma_launches,
                "attention_bwd_f32":
                attention.qkv_attention_bwd_cuda.f32_wgmma_launches}}
    return out


@contextlib.contextmanager
def _patched(obj, name, value):
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


def metric_learn_run(argv, image_seed=None) -> Dict:
    """``metric_learn.main(argv)`` (with ``--mesh_data`` the world's
    size), images fabricated from ``image_seed`` when given: the last
    epoch's metrics, the run directory and what it holds, this rank's
    printed lines and seconds."""
    import time

    from scd_tpu_torch.testing.fabricate import fabricated_images
    from scd_tpu_torch.train import metric_learn

    ctx = (fabricated_images(image_seed, size=256) if image_seed is not None
           else contextlib.nullcontext())
    t0 = time.perf_counter()
    with ctx:
        res, lines = _lines(metric_learn.main, list(argv))
    ckpt = res["ckpt"].directory
    return {"last": res["last"], "log_dir": res["log_dir"],
            "files": sorted(os.listdir(ckpt)) if os.path.isdir(ckpt)
            else [], "lines": lines, "seconds": time.perf_counter() - t0}


def train_cases(data: Dict) -> Dict:
    """The training paths over the world's ranks (CPU tests): GCD steps,
    the e2e trainers, ``metric_learn.main`` and ``run_baseline_e2e.main``
    with ``--mesh_data``, and, under a mesh of ``data`` 1 x ``model``
    world, one GCD step, the e2e trainers and ``metric_learn.main`` with
    ``--mesh_model`` (``data["metric_learn_tp"]``)."""
    from scd_tpu_torch.train import run_baseline_e2e

    world = multihost.process_count()
    dev = multihost.local_device().type
    out = {"gcd": gcd_steps(data["gcd"]), "e2e": e2e_runs(data["e2e"])}
    mesh_flags = ["--mesh_data", str(world), "--device", dev]
    out["metric_learn"] = metric_learn_run(data["metric_learn"] + mesh_flags)
    _res, out["run_baseline_e2e"] = _lines(
        run_baseline_e2e.main, data["run_baseline_e2e"] + mesh_flags)
    out["tp"] = {
        "make_gcd_state": gcd_steps(dict(data["gcd"], model=world, steps=1,
                                         return_params=False)),
        "e2e": e2e_runs(dict(data["e2e"], model=world)),
        "metric_learn": metric_learn_run(
            data["metric_learn_tp"] + ["--mesh_data", "1", "--mesh_model",
                                       str(world), "--device", dev])}
    return out


def tp_cases(data: Dict) -> Dict:
    """The tensor-parallel training paths over the world's ranks, on a
    mesh of ``data["model"]`` model ranks (a world of one runs them alone,
    the one-process references; CPU tests and ``chip_smoke.py`` phase
    15): GCD steps of each spec of ``data["steps"]`` (by name), the e2e
    trainers (``"e2e"``), and ``metric_learn.main`` /
    ``run_baseline_e2e.main`` with ``--mesh_data world / model
    --mesh_model model`` (their argv, when given)."""
    from scd_tpu_torch.train import run_baseline_e2e

    world, model = multihost.process_count(), data["model"]
    out = {"steps": {name: gcd_steps(dict(spec, model=model))
                     for name, spec in data.get("steps", {}).items()}}
    if "e2e" in data:
        out["e2e"] = e2e_runs(dict(data["e2e"], model=model))
    flags = ["--mesh_data", str(max(world // model, 1)), "--mesh_model",
             str(model), "--device", multihost.local_device().type]
    if "metric_learn" in data:
        out["metric_learn"] = metric_learn_run(data["metric_learn"] + flags)
    if "run_baseline_e2e" in data:
        _res, out["run_baseline_e2e"] = _lines(
            run_baseline_e2e.main, data["run_baseline_e2e"] + flags)
    return out


def cluster_cases(data: Dict) -> Dict:
    """ConSSKM, the Sinkhorn assignment and estimate_k over the world's
    ranks (CPU tests): each fit of ``data["fits"]``, ``run_clustering``
    with ConSSKM, the padded Sinkhorn rows, the searches, and the two
    raises (the exact MCF backend; an infeasible Sinkhorn result)."""
    from scd_tpu_torch.cluster.constrained import fit_constrained
    from scd_tpu_torch.pipelines.common import run_clustering

    mesh = _world_mesh()
    out = {name: constrained_fit(spec)["fit"]
           for name, spec in data["fits"].items()}
    out["run_clustering"] = run_clustering(
        data["pipeline_cfg"], data["feats"], device=mesh.device,
        mesh=mesh)["u_preds"]
    out["sinkhorn"] = sinkhorn_rows(*data["sinkhorn"])
    out["estimate_k"] = estimate_k_search(data["estimate_k"])
    for name in ("mcf", "infeasible"):
        x_u, x_l, y_l, cfg = (data[name][k]
                              for k in ("x_u", "x_l", "y_l", "cfg"))
        out[name] = _raised(lambda: fit_constrained(
            _share(x_u, mesh), x_l, y_l, cfg, mesh=mesh))
    return out


# ------------------------------------------------------- phase 14, on the card
#
# ``chip_smoke.py``'s phase 14 runs ``mesh_training_stages`` in a world of
# one over NCCL (the single-process references, and ConSSKM under an
# explicit mesh of one rank against the mesh-free fit) and in a world of
# two over gloo with both ranks on the card.  ``spec`` sizes it:
#   cfg         phase 3's warm root, its cluster config ConSSKM
#   estimate_k  estimate_k_search's spec (``path`` to the features)
#   gcd         gcd_steps' spec (ViT-B/16 bf16, images from the seed)
#   e2e         e2e_runs' spec (ViT-B/16 f32, images from the seed)
#   augment     augmentation_seconds' spec
#   metric_learn  metric_learn.main's argv (run over the ranks only), seed

def _consskm_stage(cfg, mesh, dev) -> Dict:
    """ConSSKM on the root's features: over the ranks ``run_clustering``
    (each rank its share of the unlabelled rows); alone the mesh-free fit
    and the same fit under an explicit mesh of one rank.  u_preds, the
    Sinkhorn counters, seconds."""
    from scd_tpu_torch.pipelines.common import (feature_cache_key,
                                                run_clustering, stage_cache)

    feats = stage_cache(cfg).load("features", feature_cache_key(cfg, "feat"))
    if mesh is not None:
        _reset_constrained()
        res, sec = _seconds(lambda: run_clustering(
            cfg, feats, device=dev, mesh=mesh), dev)
        return {"u_preds": res["u_preds"], "seconds": sec,
                "counters": _constrained_counters()}
    mask = feats["mask_lab"].astype(bool)
    x = feats["all_feats"]
    fits = constrained_fit({"x_u": x[~mask], "x_l": x[mask],
                            "y_l": feats["targets"][mask].astype(np.int64),
                            "cfg": cfg.cluster, "mesh1": True})
    n_l = int(mask.sum())
    return {"u_preds": fits["fit"]["labels"][n_l:].astype(np.int64),
            "seconds": fits["fit"]["seconds"],
            "counters": fits["fit"]["counters"],
            "mesh1": {"labels_equal": bool(np.array_equal(
                          fits["fit"]["labels"], fits["mesh1"]["labels"])),
                      "inertia": (fits["mesh1"]["inertia"],
                                  fits["fit"]["inertia"]),
                      "seconds": fits["mesh1"]["seconds"]}}


def augmentation_seconds(spec: Dict) -> Dict:
    """Host seconds of each of ``spec["steps"]`` batches of
    ``metric_learn.balanced_batches`` (decode, the two-view train
    transform, collation: what bounds ``metric_learn``), over the ranks
    each rank's block of the batch, alone the whole batch, on the root
    ``spec["root"]`` with images fabricated from ``spec["seed"]``."""
    import time

    from scd_tpu_torch.core.config import DataConfig
    from scd_tpu_torch.data import get_datasets, get_transform
    from scd_tpu_torch.data.augment import ContrastiveViewGenerator
    from scd_tpu_torch.testing.fabricate import fabricated_images
    from scd_tpu_torch.train.metric_learn import balanced_batches

    mesh = _world_mesh()
    size = spec["image_size"]
    dcfg = DataConfig(dataset_name="imagenet_100", root_dir=spec["root"],
                      image_size=size, prop_train_labels=0.5)
    tf = ContrastiveViewGenerator(get_transform(
        "imagenet", image_size=size, train=True, seed=spec["seed"]),
        n_views=2)
    seconds, rows = [], 0
    # the readers take their loader when the dataset is made
    with fabricated_images(spec["seed"], size=256):
        merged = get_datasets(dcfg, train_transform=tf, test_transform=(
            get_transform("imagenet", image_size=size)))[0]
        it = balanced_batches(merged, spec["batch"], 2, seed=spec["seed"],
                              steps_per_epoch=spec["steps"],
                              num_workers=spec["workers"], mesh=mesh)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            if batch is None:
                break
            seconds.append(time.perf_counter() - t0)
            rows = len(batch["labels"])
    return {"seconds": seconds, "rows": rows}


def mesh_training_stages(spec: Dict) -> Dict:
    """Phase 14's stages in this world (see the section's comment): each
    rank's results, launches and seconds."""
    mesh = _world_mesh()
    dev = _device(mesh)
    out = {"consskm": _consskm_stage(spec["cfg"], mesh, dev),
           "estimate_k": estimate_k_search(spec["estimate_k"]),
           "gcd": gcd_steps(spec["gcd"]), "e2e": e2e_runs(spec["e2e"]),
           "augment": augmentation_seconds(spec["augment"])}
    if mesh is not None:
        out["metric_learn"] = metric_learn_run(
            list(spec["metric_learn"]) + ["--mesh_data",
                                          str(mesh.n_data)],
            image_seed=spec["seed"])
    return out
