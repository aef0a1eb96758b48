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


def test_cuda_request_without_card_raises(monkeypatch):
    import torch

    from scd_tpu_torch.core.config import PipelineConfig
    from scd_tpu_torch.pipelines.unsup import run_unsup

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_unsup(PipelineConfig(), device="cuda")


def test_cache_miss_names_the_encoder_slice(tmp_path):
    from scd_tpu_torch.core.config import DataConfig, PipelineConfig
    from scd_tpu_torch.pipelines.common import (load_shared_features,
                                                stage_cache)

    cfg = PipelineConfig(data=DataConfig(cache_dir=str(tmp_path)))
    with pytest.raises(NotImplementedError, match="encoder slice"):
        load_shared_features(cfg, stage_cache(cfg))
