"""The port's main path over 2 gloo ranks on the CPU: sharded extraction,
the name-sharded vocabulary build, whole synthetic ``run_unsup`` /
``run_ptsup`` runs and serving with ``--mesh_data``.

One world runs ``scd_tpu_torch.testing.mesh_cases.pipeline_cases``
(``scd_tpu_torch.testing.dist.spawn``: the port only, a 60 s deadline and
a collective timeout); each rank also computes the single-process
reference where the check is rank-local (the encoder, extraction, the
vocabulary build).  Contract:
- the data-parallel encoder (a full and a ragged batch, and its staged
  form) and ``extract_features_pod`` equal the single-process encoder
  and extraction (counterparts of ``tests/test_sharded_extract.py:38, 49,
  68, 94``): each image's row is computed by the same tower on the same
  input, so equal bits;
- the vocabulary matrix of the name-sharded build is bitwise equal to the
  single-process build's on the CPU (whole names per rank, each batch's
  sequence buckets decided from the whole batch);
- the whole synthetic SSKM pipelines (``tests/test_multihost.py:214``):
  every rank's run digest is the same and equal to the single-process
  port's, rank 0 prints the single-process port's lines and rank 1
  prints none; against the JAX package's single-process run, cluster
  ACC and IoU within 0.02 and 0.05 (its seeds are threefry's);
- ``infer.main --mesh_data 2`` over the 2 ranks prints what one process
  prints, on the synthetic smoke and on a .npy batch through a tiny CLIP
  tower.
"""

import os

import numpy as np
import pytest

from scd_tpu_torch.testing import mesh_cases
from scd_tpu_torch.testing.dist import spawn


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_pipeline")
    images = np.random.default_rng(0).integers(0, 256, (21, 16, 16, 3),
                                               dtype=np.uint8)
    np.save(tmp / "images.npy", images)
    return {"cache_dir": str(tmp / "world"),
            "images": str(tmp / "images.npy"), "single": str(tmp / "one")}


@pytest.fixture(scope="module")
def world(paths):
    return spawn("scd_tpu_torch.testing.mesh_cases.pipeline_cases", world=2,
                 args=({"cache_dir": paths["cache_dir"],
                        "images": paths["images"]},), timeout=60,
                 collective_timeout=45)


@pytest.fixture(scope="module")
def single(paths):
    """The single-process port's runs and serving, in this process."""
    out = mesh_cases.synthetic_runs(paths["single"])
    out["serving"] = mesh_cases.serving(paths["images"])
    return out


@pytest.mark.parametrize("batch", ["full", "ragged"])
def test_sharded_encoder_matches_single_device(world, batch):
    for rank in world:
        sharded, single = rank[batch]
        assert sharded.shape == single.shape
        np.testing.assert_array_equal(sharded, single)
        assert rank["staged_equal"]


def test_extract_features_pod_matches_single(world):
    """Each rank decodes its share; the features and the metadata equal
    the single-process extraction, also through the shared extractor."""
    for rank in world:
        pod, single, shared = rank["extract"]
        for got in (pod, shared):
            np.testing.assert_array_equal(got["all_feats"],
                                          single["all_feats"])
            for k in ("targets", "mask_lab", "mask_cls"):
                np.testing.assert_array_equal(got[k], single[k])


@pytest.mark.parametrize("route", ["sharded", "dispatch"])
def test_sharded_vocabulary_build_is_bitwise_single(world, route):
    for rank in world:
        voc = rank["vocabulary"]
        assert voc[route].shape == voc["single"].shape == (16, 29)
        np.testing.assert_array_equal(voc[route], voc["single"])


@pytest.mark.parametrize("kind", ["unsup", "ptsup"])
def test_synthetic_run_over_ranks_matches_single_process(world, single,
                                                         kind):
    digests = {rank["runs"][kind]["digest"] for rank in world}
    assert digests == {single[kind]["digest"]}
    assert world[0]["runs"][kind]["lines"] == single[kind]["lines"]
    assert len(single[kind]["lines"]) > 5
    assert world[1]["runs"][kind]["lines"] == []


@pytest.mark.parametrize("kind", ["unsup", "ptsup"])
def test_synthetic_run_over_ranks_matches_jax(world, tmp_path, kind):
    """The JAX package's single-process run of the same config: ACC (unsup)
    and IoU within collective-order and seed tolerance."""
    import dataclasses

    from scd_tpu.core.config import (ClusterConfig, DataConfig,
                                     FeatureConfig, MeshConfig,
                                     NamingConfig, PipelineConfig)

    tcfg = mesh_cases._synthetic_config(str(tmp_path))
    cfg = PipelineConfig(
        data=DataConfig(dataset_name="synthetic", cache_dir=str(tmp_path)),
        feature=FeatureConfig(feat_model="synthetic"),
        cluster=ClusterConfig(**dataclasses.asdict(tcfg.cluster)),
        naming=NamingConfig(**dataclasses.asdict(tcfg.naming)),
        mesh=MeshConfig(data=0, model=1))
    if kind == "unsup":
        from scd_tpu.pipelines.unsup import run_unsup as run
    else:
        from scd_tpu.pipelines.ptsup import run_ptsup as run
    want = run(cfg)
    got = world[0]["runs"][kind]
    if kind == "unsup":
        np.testing.assert_allclose(got["cluster_acc"], want["cluster_acc"],
                                   atol=0.02)
    assert got["iou"] == pytest.approx(want["iou"], abs=0.05)


@pytest.mark.parametrize("route", ["synthetic", "real"])
def test_infer_over_ranks_prints_single_process_names(world, single,
                                                      route):
    got, lines = world[0]["serving"][route]
    want, want_lines = single["serving"][route]
    assert lines == want_lines and len(lines) > 3
    assert got == want
    assert world[1]["serving"][route][1] == []
    assert os.environ.get("WORLD_SIZE") is None
