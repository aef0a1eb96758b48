"""The whole slice: the JAX package's ``run_unsup`` and the port's, on one
fabricated ImageNet-100 artifact root (``tests/oracle_fabricate.py``)
imported into one cache by ``scd_tpu.pipelines.interop``.

- ``run_cluster=False`` (fully cached re-entry): every metric line —
  cluster ACC, per-iteration ACC / sACC / soft-sACC, IoU — is byte-equal,
  and the voted names are equal at every iteration.
- ``run_cluster=True`` (KM and SSKM): the k-means++ draws differ between
  ``jax.random`` and ``torch.Generator``, so the partitions are compared,
  not the bits: ACC within 0.005 of each other and ARI >= 0.99 between
  the two packages' unlabelled partitions (both reach ACC 1.0 and ARI 1.0
  on this data).  The oracle's clustering features are its CLIP features,
  whose noise has twice the norm of the class signal (KM ACC ~0.4: two
  draws land in different local optima), so these cases rewrite the
  clustering-feature cache with the same targets and masks and a clear
  class structure.  The Lloyd loops themselves are held to equal labels
  from shared initial centers in ``test_torch_kmeans.py``.
- A small root from the port's own fabricator (the one ``chip_smoke.py``
  runs at full size) goes through both packages too.
- A cold run (extraction and the vocabulary build from JPEGs and weight
  files) goes through both packages on the same weights.
- The asset-free synthetic run goes through both packages' ``main``.
"""

import contextlib
import dataclasses
import io
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

_METRIC_PREFIXES = ("KM Accuracies:", "SSKM Accuracies:", "iter:",
                    "Accuracies:", "ACC/sACC_avg/sACC_all:",
                    "ACC/Soft sACC:", "IoU:")


def _metric_lines(text):
    return [ln.rstrip() for ln in text.splitlines()
            if ln.startswith(_METRIC_PREFIXES)]


def _run(fn, cfg, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(cfg, **kw)
    return res, _metric_lines(buf.getvalue())


def _cfgs(root, cache_dir, algorithm, run_cluster, n_init=10):
    from scd_tpu.core import config as J
    from scd_tpu_torch.core import config as T

    out = []
    for M in (J, T):
        out.append(M.PipelineConfig(
            data=M.DataConfig(dataset_name="imagenet_100", root_dir=root,
                              corpus_dir=os.path.join(root, "data"),
                              wordnet_db_dir=os.path.join(
                                  root, "nltk_data", "corpora", "wordnet"),
                              cache_dir=cache_dir),
            feature=M.FeatureConfig(feat_model="dino_vit"),
            cluster=M.ClusterConfig(algorithm=algorithm, n_clusters=20,
                                    n_init=n_init),
            naming=M.NamingConfig(corpus="wordnet", topk=5,
                                  num_common_vote=20, num_common_linear=4),
            run_cluster=run_cluster))
    return out


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    from oracle_fabricate import fabricate_oracle_root
    from scd_tpu.pipelines.interop import import_reference_artifacts

    base = tmp_path_factory.mktemp("torch_slice")
    old = os.environ.get("SCD_COMPILE_CACHE")
    os.environ["SCD_COMPILE_CACHE"] = str(base / "xla_cache")
    root, cache = str(base / "root"), str(base / "cache")
    info = fabricate_oracle_root(root)
    jcfg, _ = _cfgs(root, cache, "KM", run_cluster=False)
    imported = import_reference_artifacts(root, jcfg)
    assert set(imported) == {"features_feat", "features_clip", "cluster",
                             "zeroshot"}
    yield {"root": root, "cache": cache, "base": base, "info": info}
    if old is None:
        os.environ.pop("SCD_COMPILE_CACHE", None)
    else:
        os.environ["SCD_COMPILE_CACHE"] = old


def test_cached_reentry_byte_equal(oracle):
    from scd_tpu.pipelines.unsup import run_unsup as jax_run
    from scd_tpu_torch.pipelines.unsup import run_unsup as torch_run

    jcfg, tcfg = _cfgs(oracle["root"], oracle["cache"], "KM", False)
    jres, jlines = _run(jax_run, jcfg)
    tres, tlines = _run(torch_run, tcfg, device="cpu")
    assert tlines == jlines
    assert sum(ln.startswith("iter:") for ln in tlines) >= 2
    assert any(ln.startswith("ACC/Soft sACC:") for ln in tlines)
    assert [h["cand_names"] for h in tres["history"]] == \
        [h["cand_names"] for h in jres["history"]]
    assert tres["voting"].n_iters == jres["voting"].n_iters
    np.testing.assert_array_equal(tres["voting"].u_preds,
                                  np.asarray(jres["voting"].u_preds))
    assert tres["iou"] == jres["iou"] == oracle["info"]["k"] / 100.0


@pytest.mark.parametrize("algorithm", ["KM", "SSKM"])
def test_clustering_partitions_agree(oracle, algorithm):
    from sklearn.metrics import adjusted_rand_score

    from scd_tpu.pipelines.common import (cluster_cache_key,
                                          feature_cache_key)
    from scd_tpu.pipelines.interop import import_reference_artifacts
    from scd_tpu.pipelines.unsup import run_unsup as jax_run
    from scd_tpu_torch.core.cache import ArtifactCache
    from scd_tpu_torch.pipelines.unsup import run_unsup as torch_run

    # the cache dir is part of the feature keys: import afresh
    cache = str(oracle["base"] / f"cache_{algorithm}")
    jcfg, tcfg = _cfgs(oracle["root"], cache, algorithm, True, n_init=4)
    import_reference_artifacts(oracle["root"], jcfg)
    store = ArtifactCache(cache)
    key = feature_cache_key(jcfg, "feat")
    feats = store.load("features", key)
    rng = np.random.default_rng(0)
    means = 3.0 * rng.standard_normal((100, 32))
    x = means[feats["targets"].astype(np.int64)] + 0.3 * rng.standard_normal(
        (len(feats["targets"]), 32))
    feats["all_feats"] = (x / np.linalg.norm(x, axis=1, keepdims=True)
                          ).astype(np.float32)
    store.save("features", key, feats)
    jres, _ = _run(jax_run, jcfg)
    j_preds = store.load("cluster", cluster_cache_key(jcfg))["u_preds"]
    tres, tlines = _run(torch_run, tcfg, device="cpu")
    t_preds = store.load("cluster", cluster_cache_key(jcfg))["u_preds"]
    assert tlines[0].startswith(f"{algorithm} Accuracies:")
    assert abs(tres["cluster_acc"][0] - jres["cluster_acc"][0]) <= 0.005
    assert adjusted_rand_score(j_preds, t_preds) >= 0.99
    assert tres["iou"] == jres["iou"]


def test_port_fabricator_root_byte_equal(tmp_path):
    """The root ``chip_smoke.py`` fabricates, at a tiny size, through both
    packages: clustered by the port, then re-entered by both."""
    from scd_tpu.core import config as J
    from scd_tpu.pipelines.unsup import run_unsup as jax_run
    from scd_tpu_torch.pipelines.unsup import run_unsup as torch_run
    from scd_tpu_torch.testing.fabricate import (fabricate_imagenet100,
                                                 imagenet100_config)

    tcfg = imagenet100_config(str(tmp_path / "root"), n_init=2,
                              max_iterations=5)
    info = fabricate_imagenet100(tcfg, seed=1, device="cpu", n_images=2_400,
                                 d_feat=24, d_clip=16, vocab=1_500,
                                 n_genus=10)
    assert info["n_images"] == 2_400 and info["n_labelled"] == 600
    first, _ = _run(torch_run, tcfg, device="cpu")
    assert first["cluster_acc"][0] > 0.9 and first["iou"] > 0.8
    tcfg = dataclasses.replace(tcfg, run_cluster=False)
    jcfg = J.PipelineConfig(
        data=J.DataConfig(**dataclasses.asdict(tcfg.data)),
        feature=J.FeatureConfig(**dataclasses.asdict(tcfg.feature)),
        cluster=J.ClusterConfig(**dataclasses.asdict(tcfg.cluster)),
        naming=J.NamingConfig(**dataclasses.asdict(tcfg.naming)),
        run_cluster=False)
    _, jlines = _run(jax_run, jcfg)
    _, tlines = _run(torch_run, tcfg, device="cpu")
    assert tlines == jlines and len(tlines) > 3


def test_synthetic_run_unsup_byte_equal(tmp_path):
    """The asset-free synthetic run (both CLIs' default dataset) through
    each package's ``main``: byte-equal metric lines (SSKM reaches the
    same partition from either package's k-means++ draws)."""
    from scd_tpu.pipelines.unsup import main as jax_main
    from scd_tpu_torch.pipelines.unsup import main as torch_main

    lines = []
    for fn, extra in ((jax_main, []), (torch_main, ["--device", "cpu"])):
        argv = ["--dataset_name", "synthetic", "--cache_dir",
                str(tmp_path / f"cache{len(lines)}")] + extra
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(argv)
        lines.append(_metric_lines(buf.getvalue()))
    assert lines[1] == lines[0] and len(lines[0]) > 10
    assert lines[0][-1] == "IoU: 1.0"


def test_cuda_request_without_card_raises(monkeypatch):
    import torch

    from scd_tpu_torch.core.config import PipelineConfig
    from scd_tpu_torch.pipelines.unsup import run_unsup

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_unsup(PipelineConfig(), device="cuda")


def test_cache_miss_names_the_encoder_slice(tmp_path):
    """A features cache miss builds the encoders (lazily, on first use);
    the ``resnet50`` backbone's build without the weights it needs raises
    and names the missing file's setting, and nothing is written."""
    from scd_tpu_torch.core.config import (DataConfig, FeatureConfig,
                                           PipelineConfig)
    from scd_tpu_torch.pipelines.common import (lazy_encoders,
                                                load_shared_features,
                                                stage_cache)
    from scd_tpu_torch.pipelines.unsup import build_encoders

    cfg = PipelineConfig(
        data=DataConfig(dataset_name="imagefolder",
                        cache_dir=str(tmp_path)),
        feature=FeatureConfig(feat_model="resnet50"))
    built = []
    feat, clip, _txt = lazy_encoders(
        lambda: built.append(1) or build_encoders(cfg, {}, device="cpu"))
    assert not built  # nothing is built until an encoder is used
    with pytest.raises(FileNotFoundError, match="clip_weights"):
        load_shared_features(cfg, stage_cache(cfg), feat, clip,
                             [(np.zeros((4, 4, 3), np.uint8), 0, 0)], [0])
    assert built == [1]
    assert not any(f.startswith("features_") for f in os.listdir(tmp_path))


# ------------------------------------------------------------- cold run

def _tiny_factories(monkeypatch, int8):
    """Width-64, depth-2 towers at 32 px in place of the ViT-B/16 factories
    of both packages (their ``build_encoders`` hard-code ViT-B/16)."""
    import jax.numpy as jnp
    import torch

    from scd_tpu.models import clip as jclip
    from scd_tpu.models import vit as jvit
    from scd_tpu_torch.models import clip as tclip
    from scd_tpu_torch.models import vit as tvit

    vit = dict(image_size=32, patch_size=8, width=64, depth=2, heads=2)

    def make(vmod, cmod, default_dtype):
        def clip_cfg(compute_dtype=default_dtype, dense_int8=False):
            return cmod.CLIPConfig(
                vision=vmod.ViTConfig(
                    **vit, quick_gelu=True, pre_post_norm=True,
                    output_proj=32, patch_bias=False, norm_eps=1e-5,
                    dense_int8=dense_int8, compute_dtype=compute_dtype),
                text_width=64, text_depth=2, text_heads=2, embed_dim=32,
                compute_dtype=compute_dtype)

        def dino_cfg(compute_dtype=None, gelu_tanh=False, dense_int8=False):
            return vmod.ViTConfig(**vit, gelu_tanh=gelu_tanh,
                                  dense_int8=dense_int8,
                                  compute_dtype=compute_dtype
                                  or default_dtype)
        return clip_cfg, dino_cfg

    jc, jd = make(jvit, jclip, jnp.float32)
    tc, td = make(tvit, tclip, torch.float32)
    for mod, c, d in (("scd_tpu.models", jc, jd),
                      ("scd_tpu_torch.models", tc, td)):
        monkeypatch.setattr(f"{mod}.clip_vit_b16_config", c)
        monkeypatch.setattr(f"{mod}.dino_vit_b16_config", d)
    return tc(dense_int8=int8), td(dense_int8=int8, gelu_tanh=True)


def _row_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def test_cold_run_unsup_matches_jax(tmp_path, monkeypatch):
    """A cold run from JPEGs through both packages on the same weights
    (tiny towers at bf16 compute, int8 qkv/fc1): extraction, the
    vocabulary build, SSKM, top-k and voting.

    - The features and zero-shot caches each package writes under the
      same keys agree: rows and columns to a cosine >= 0.995 (bf16
      activations rounded at other places, int8 rounding flips at the
      quantization boundaries that follow), labels and masks exactly.
    - Re-entered from one package's caches, both print byte-equal metric
      lines.
    - The two cold runs' partitions agree: ARI >= 0.85 and ACC within
      0.05 (k-means++ draws differ between the packages; both reach ACC
      ~0.95 on these class-coloured images, ARI ~0.92 between them)."""
    import shutil

    from sklearn.metrics import adjusted_rand_score

    from scd_tpu.core import config as J
    from scd_tpu.pipelines.unsup import run_unsup as jax_run
    from scd_tpu_torch.core.cache import ArtifactCache
    from scd_tpu_torch.pipelines.common import (cluster_cache_key,
                                                feature_cache_key)
    from scd_tpu_torch.pipelines.unsup import run_unsup as torch_run
    from scd_tpu_torch.testing.fabricate import (cold_config,
                                                 fabricate_cold_root)

    monkeypatch.setenv("SCD_COMPILE_CACHE", str(tmp_path / "xla"))
    clip_cfg, dino_cfg = _tiny_factories(monkeypatch, int8=True)
    root = str(tmp_path / "root")
    tcfg = cold_config(root, batch_size=64, num_workers=2)
    tcfg = tcfg.replace(data=dataclasses.replace(tcfg.data, image_size=32))
    info = fabricate_cold_root(tcfg, clip_cfg, dino_cfg, seed=2,
                               n_images=300, vocab=1_100, n_genus=10,
                               jpeg_size=40)
    # a 128-name vocabulary: the class names and 28 others
    extra = [n for n in info["nouns"] if n not in info["class_names"]][:28]
    with open(os.path.join(tcfg.data.corpus_dir, "wordnet_all_noun.txt"),
              "w") as f:
        f.write("\n".join(info["class_names"] + extra) + "\n")
    jcfg = J.PipelineConfig(
        data=J.DataConfig(**dataclasses.asdict(tcfg.data)),
        feature=J.FeatureConfig(**dataclasses.asdict(tcfg.feature)),
        cluster=J.ClusterConfig(**dataclasses.asdict(tcfg.cluster)),
        naming=J.NamingConfig(**dataclasses.asdict(tcfg.naming)),
        run_cluster=True)
    cache_dir = tcfg.data.cache_dir
    keys = {"feat": ("features", feature_cache_key(tcfg, "feat")),
            "clip": ("features", feature_cache_key(tcfg, "clip")),
            "zw": ("zeroshot", feature_cache_key(tcfg, "zw_wordnet")),
            "cluster": ("cluster", cluster_cache_key(tcfg))}

    jres, _ = _run(jax_run, jcfg)
    jstore = cache_dir + "_jax"
    shutil.move(cache_dir, jstore)
    tres, _ = _run(torch_run, tcfg, device="cpu")
    jc, tc = ArtifactCache(jstore), ArtifactCache(cache_dir)
    for name, (stage, key) in keys.items():
        assert jc.has(stage, key) and tc.has(stage, key), name
    for name in ("feat", "clip"):
        j, t = jc.load(*keys[name]), tc.load(*keys[name])
        for k in ("targets", "mask_lab", "mask_cls"):
            np.testing.assert_array_equal(t[k], j[k])
        assert t["all_feats"].shape == j["all_feats"].shape
        assert _row_cos(t["all_feats"], j["all_feats"]).min() >= 0.995, name
    jw, tw = jc.load(*keys["zw"])["weights"], tc.load(*keys["zw"])["weights"]
    assert tw.shape == jw.shape == (32, 128)
    assert _row_cos(tw.T, jw.T).min() >= 0.995
    j_preds = jc.load(*keys["cluster"])["u_preds"]
    t_preds = tc.load(*keys["cluster"])["u_preds"]
    assert adjusted_rand_score(j_preds, t_preds) >= 0.85
    assert abs(tres["cluster_acc"][0] - jres["cluster_acc"][0]) <= 0.05

    # offline extraction writes the packed store of the same features
    from scd_tpu_torch.pipelines.extract import run_extract

    with contextlib.redirect_stdout(io.StringIO()):
        out = run_extract(tcfg, str(tmp_path / "store"), device="cpu")
    packed = np.load(tmp_path / "store" / "train" / "features_packed.npz")
    t_feat = tc.load(*keys["feat"])
    assert packed["features"].shape == (len(t_feat["targets"]), 64)
    np.testing.assert_array_equal(packed["targets"], t_feat["targets"])
    np.testing.assert_array_equal(packed["mask_lab"], t_feat["mask_lab"])
    assert _row_cos(packed["features"], t_feat["all_feats"]).min() > 0.99999
    assert out["test"]["features"].shape[0] == 100  # one val image a class

    # re-entry from the JAX package's caches: byte-equal metric lines
    shutil.rmtree(cache_dir)
    shutil.copytree(jstore, cache_dir)
    _, jlines = _run(jax_run, jcfg.replace(run_cluster=False))
    _, tlines = _run(torch_run, tcfg.replace(run_cluster=False),
                     device="cpu")
    assert tlines == jlines and len(tlines) > 3
