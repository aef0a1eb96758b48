"""Host-side parity of the PyTorch port against the JAX package: config
hashes, the artifact cache in both directions, the dtype rules of
``tensors_from_arrays``, metrics, vote counters, the Hungarian name
assignment and WordNet lch.  All of it is host numpy/scipy code in both
packages, so every comparison is exact equality.

Also the pieces no pipeline calls: ``HashTokenizer``,
``SyntheticTaxonomy``, ``vote_candidates`` and
``soft_semantic_acc_from_table`` (host code, exact); the assignment ops
(contingency counts and the auction, exact: the auction runs the JAX
loop's f32 arithmetic step for step); ``segment_mean`` / ``mstep_update``
and ``masked_min_sum`` (f32 sums in another order: 1e-5)."""

import os

import numpy as np
import pytest
import torch

from scd_tpu.core import cache as jcache
from scd_tpu.core import config as jconfig
from scd_tpu.metrics import cluster as jcluster
from scd_tpu.metrics import semantic as jsemantic
from scd_tpu.naming import vote as jvote
from scd_tpu.naming.wordnet import Taxonomy as JTaxonomy
from scd_tpu_torch.core import cache as tcache
from scd_tpu_torch.core import config as tconfig
from scd_tpu_torch.metrics import cluster as tcluster
from scd_tpu_torch.metrics import semantic as tsemantic
from scd_tpu_torch.naming import vote as tvote
from scd_tpu_torch.naming.wordnet import Taxonomy as TTaxonomy


def _configs(mod):
    return [
        mod.PipelineConfig(),
        mod.PipelineConfig(
            data=mod.DataConfig(dataset_name="imagenet_100", root_dir="/r",
                                cache_dir="/c", zeroshot_weights="/z.npz"),
            cluster=mod.ClusterConfig(algorithm="SSKM", n_clusters=100,
                                      estep="x_bf16"),
            naming=mod.NamingConfig(topk=3, textual_enhancement=True),
            run_cluster=False),
    ]


@pytest.mark.parametrize("i", [0, 1])
def test_config_hash_equal(i):
    jc, tc = _configs(jconfig)[i], _configs(tconfig)[i]
    assert tconfig.config_hash(tc) == jconfig.config_hash(jc)
    for sec in ("mesh", "data", "feature", "cluster", "naming", "train"):
        extra = {"model": "feat", "feat": "dino_vit"}
        assert tconfig.config_hash(getattr(tc, sec), extra=extra) == \
            jconfig.config_hash(getattr(jc, sec), extra=extra)


def test_config_fields_identical():
    import dataclasses

    for name in ("MeshConfig", "ClusterConfig", "NamingConfig", "DataConfig",
                 "FeatureConfig", "TrainConfig", "PipelineConfig"):
        jf = [(f.name, repr(f.default)) for f in
              dataclasses.fields(getattr(jconfig, name))]
        tf = [(f.name, repr(f.default)) for f in
              dataclasses.fields(getattr(tconfig, name))]
        assert jf == tf, name


def test_flat_override_equal():
    items = ["cluster.n_clusters=7", "naming.topk=2", "run_cluster=false",
             "data.root_dir=/x"]
    jc = jconfig.flat_override(jconfig.PipelineConfig(), items)
    tc = tconfig.flat_override(tconfig.PipelineConfig(), items)
    assert tconfig.config_hash(tc) == jconfig.config_hash(jc)


def test_cache_keys_equal():
    from scd_tpu.pipelines import common as jcommon
    from scd_tpu_torch.pipelines import common as tcommon

    jc, tc = _configs(jconfig)[1], _configs(tconfig)[1]
    for which in ("feat", "clip", "zw_wordnet"):
        assert tcommon.feature_cache_key(tc, which) == \
            jcommon.feature_cache_key(jc, which)
    assert tcommon.cluster_cache_key(tc) == jcommon.cluster_cache_key(jc)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cache_readable_both_ways(tmp_path, writer):
    rng = np.random.default_rng(0)
    arrays = {"all_feats": rng.standard_normal((7, 3)).astype(np.float32),
              "targets": np.arange(7).astype(np.float64),
              "mask_lab": rng.random(7) < 0.5}
    w_mod, r_mod = (jcache, tcache) if writer == "jax" else (tcache, jcache)
    w_mod.ArtifactCache(str(tmp_path)).save("features", "k1", arrays)
    got = r_mod.ArtifactCache(str(tmp_path)).load("features", "k1")
    assert set(got) == set(arrays)
    for k in arrays:
        assert got[k].dtype == arrays[k].dtype
        np.testing.assert_array_equal(got[k], arrays[k])
    assert sorted(os.listdir(tmp_path)) == ["features_k1.json",
                                            "features_k1.npz"]


def test_tensors_from_arrays_dtypes():
    arrays = {"all_feats": np.ones((2, 3), np.float64),
              "targets": np.array([1.0, 2.0]),
              "mask_lab": np.array([1, 0]), "mask_cls": np.array([0, 1]),
              "weights": np.ones((3, 4), np.float16)}
    t = tcache.tensors_from_arrays(arrays, "cpu")
    assert t["all_feats"].dtype == torch.float32
    assert t["weights"].dtype == torch.float32
    assert t["targets"].dtype == torch.int64
    assert t["targets"].tolist() == [1, 2]
    assert t["mask_lab"].dtype == torch.bool
    assert t["mask_lab"].tolist() == [True, False]
    assert t["mask_cls"].dtype == torch.bool


@pytest.mark.parametrize("seed", range(4))
def test_metrics_bit_equal(seed):
    rng = np.random.default_rng(seed)
    n, k = 400, 12
    y = rng.integers(0, k, n)
    p = np.where(rng.random(n) < 0.7, (y + 3) % k, rng.integers(0, k, n))
    mask = y < k // 2
    assert tcluster.cluster_acc(y, p) == jcluster.cluster_acc(y, p)
    for v in ("split_cluster_acc_v1", "split_cluster_acc_v2",
              "split_cluster_acc_v3"):
        assert getattr(tcluster, v)(y, p, mask) == \
            getattr(jcluster, v)(y, p, mask)
    assert tcluster.split_cluster_acc_v2(y, p, mask, return_ind_map=True) \
        == jcluster.split_cluster_acc_v2(y, p, mask, return_ind_map=True)
    assert tcluster.evaluate_clustering(y, p) == \
        jcluster.evaluate_clustering(y, p)
    names = [f"n{i}" for i in range(k)]
    cidx = {i: names[(i * 5) % k] for i in range(k)}
    assert tsemantic.evaluate_semantic_acc(y, cidx, p, names) == \
        jsemantic.evaluate_semantic_acc(y, cidx, p, names)
    sim = lambda a, b: float(a == b) + 0.5  # noqa: E731
    assert tsemantic.evaluate_soft_semantic_acc(y, cidx, p, names, sim) == \
        jsemantic.evaluate_soft_semantic_acc(y, cidx, p, names, sim)
    assert tsemantic.name_set_iou(names[:7], names[3:]) == \
        jsemantic.name_set_iou(names[:7], names[3:])


@pytest.mark.parametrize("seed", range(4))
def test_vote_counters_and_assignment_bit_equal(seed):
    rng = np.random.default_rng(seed)
    n, k, v, top = 300, 9, 40, 5
    # skewed name draws make count ties and first-occurrence order matter
    idx = rng.zipf(1.6, (n, top)) % v
    preds = rng.integers(0, k, n)
    tc = tvote.cluster_name_counters(idx, preds, top)
    jc = jvote.cluster_name_counters(idx, preds, top)
    assert tc == jc
    voted = sorted({name for e in tc.values() for name, _ in e[:6]})
    ti, tw = tvote.assign_name(voted, tc, num_common=4)
    ji, jw = jvote.assign_name(voted, jc, num_common=4)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tw, jw)
    ti, tw = tvote.assign_name_on_leftover(voted, tc, voted[:3], 4)
    ji, jw = jvote.assign_name_on_leftover(voted, jc, voted[:3], 4)
    np.testing.assert_array_equal(ti, ji)
    vals = rng.random((n, top)).astype(np.float32) * 30
    tl = tvote.cluster_logit_counters(idx, vals, preds, top)
    assert tl == jvote.cluster_logit_counters(idx, vals, preds, top)
    ti, _ = tvote.assign_name_logits(voted, tl, 4)
    ji, _ = jvote.assign_name_logits(voted, tl, 4)
    np.testing.assert_array_equal(ti, ji)


def test_lch_equal_on_fabricated_wndb(tmp_path):
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from wndb_fabricate import build_wndb, demo_tree

    from scd_tpu_torch.testing.fabricate import build_wndb as t_build_wndb

    tree = demo_tree(width=5, depth=4)
    build_wndb(str(tmp_path / "a"), tree)
    # the port's parametrised copy of the writer produces the same bytes
    t_build_wndb(str(tmp_path / "b"), tree)
    for f in ("data.noun", "index.noun"):
        assert (tmp_path / "a" / f).read_bytes() == \
            (tmp_path / "b" / f).read_bytes()
    jt = JTaxonomy.from_wndb(str(tmp_path / "a"))
    tt = TTaxonomy.from_wndb(str(tmp_path / "a"))
    assert tt.wnids == jt.wnids and tt.all_names() == jt.all_names()
    assert tt.max_depth() == jt.max_depth()
    names = tt.all_names()
    for a in names:
        for b in names:
            assert tt.name_similarity(a, b) == jt.name_similarity(a, b)


def test_hash_tokenizer_bit_equal():
    from scd_tpu.models.tokenizer import HashTokenizer as J
    from scd_tpu_torch.models.tokenizer import HashTokenizer as T

    j, t = J(), T(vocab_size=1000)
    assert T().sot_id == j.sot_id and T().eot_id == j.eot_id
    j = J(vocab_size=1000)
    texts = ["a photo of a dog.", "it's 42 o'clock -- Ice-cream!", "",
             "word " * 90]
    for text in texts:
        assert t.encode(text) == j.encode(text)
    np.testing.assert_array_equal(t(texts), j(texts))
    np.testing.assert_array_equal(t(texts, context_length=9),
                                  j(texts, context_length=9))
    templates = ["a photo of a {}.", "{} in the wild", "art of the {}!",
                 "({})", "itap of {}'s"]
    names = ["dog", "great_white-shark", "o'clock", "(x)", "b.c"]
    assert t.template_pieces(templates) == j.template_pieces(templates)
    np.testing.assert_array_equal(t.prompt_tokens(templates, names),
                                  j.prompt_tokens(templates, names))
    assert T.name_boundary_punct("(x)") == J.name_boundary_punct("(x)")


def test_synthetic_taxonomy_equal():
    from scd_tpu.naming.wordnet import SyntheticTaxonomy as J
    from scd_tpu_torch.naming.wordnet import SyntheticTaxonomy as T

    j, t = J(), T()
    assert (t.wnids, t.lemmas, t.hypernyms) == (j.wnids, j.lemmas,
                                                j.hypernyms)
    assert t.all_names() == j.all_names() and t.max_depth() == j.max_depth()
    for a in t.all_names():
        for b in t.all_names():
            assert t.name_similarity(a, b) == j.name_similarity(a, b)


@pytest.mark.parametrize("seed", range(2))
def test_vote_candidates_and_soft_table_bit_equal(seed):
    rng = np.random.default_rng(seed)
    idx = rng.zipf(1.6, (200, 5)) % 30
    counters = jvote.cluster_name_counters(idx, rng.integers(0, 7, 200), 5)
    for m in (1, 3, 50):
        assert tvote.vote_candidates(counters, m) == \
            jvote.vote_candidates(counters, m)
    n_names, n_cls, k = 12, 6, 8
    table = rng.random((n_names, n_names))
    tgt = rng.integers(0, n_cls, 300)
    prd = rng.integers(0, k, 300)
    t_idx, p_idx = rng.integers(0, n_names, n_cls), rng.integers(0, n_names, k)
    assert tsemantic.soft_semantic_acc_from_table(tgt, prd, t_idx, p_idx,
                                                  table) == \
        jsemantic.soft_semantic_acc_from_table(tgt, prd, t_idx, p_idx, table)


@pytest.mark.parametrize("n", [1, 7, 40])
def test_assignment_ops_match_jax(n):
    import jax.numpy as jnp

    from scd_tpu.ops import assignment as ja
    from scd_tpu_torch.ops import assignment as ta

    rng = np.random.default_rng(n)
    y_pred, y_true = rng.integers(0, n + 2, 500), rng.integers(0, n, 500)
    want = ja.contingency_matrix_device(jnp.asarray(y_pred),
                                        jnp.asarray(y_true), n + 2, n)
    got = ta.contingency_matrix_device(torch.as_tensor(y_pred),
                                       torch.as_tensor(y_true), n + 2, n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for profit in (rng.integers(0, 60, (n, n)).astype(np.float64),
                   np.tile(rng.integers(0, 3, n)[:, None], (1, n)),  # ties
                   rng.integers(0, 60, (n, n)) * 1e9):  # host-solve range
        a = ta.auction_assignment(profit, device="cpu")
        np.testing.assert_array_equal(a, ja.auction_assignment(profit))
        assert sorted(a.tolist()) == list(range(n))
    # max_iters hit: both fall back to the exact host solve
    profit = rng.integers(0, 60, (n, n))
    np.testing.assert_array_equal(
        ta.auction_assignment(profit, max_iters=1, device="cpu"),
        ja.auction_assignment(profit, max_iters=1))
    cost = rng.random((n, n)).astype(np.float32)
    np.testing.assert_array_equal(
        ta.linear_assignment_device(cost, device="cpu"),
        ja.linear_assignment_device(cost))


@pytest.mark.parametrize("policy,weighted",
                         [("keep", False), ("farthest", False),
                          ("farthest", True)])
def test_segment_mean_and_mstep_update_match_jax(policy, weighted):
    import jax.numpy as jnp

    from scd_tpu.ops import distance as jd
    from scd_tpu.ops import segment as js
    from scd_tpu_torch.ops import distance as td
    from scd_tpu_torch.ops import segment as ts

    rng = np.random.default_rng(3)
    n, d, k = 300, 10, 9
    x = rng.standard_normal((n, d)).astype(np.float32)
    labels = rng.integers(0, k - 3, n)  # the last three clusters are empty
    prev = rng.standard_normal((k, d)).astype(np.float32)
    mindist = rng.random(n).astype(np.float32)
    w = (rng.random(n) < 0.7).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    jm, jc = js.segment_mean(jnp.asarray(x), jnp.asarray(labels), k, jw)
    tm, tc = ts.segment_mean(torch.from_numpy(x), torch.from_numpy(labels),
                             k, tw)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    want = js.mstep_update(jnp.asarray(x), jnp.asarray(labels), k,
                           jnp.asarray(prev), jnp.asarray(mindist), policy,
                           jw)
    got = ts.mstep_update(torch.from_numpy(x), torch.from_numpy(labels), k,
                          torch.from_numpy(prev), torch.from_numpy(mindist),
                          policy, tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="unknown empty_policy"):
        ts.mstep_update(torch.from_numpy(x), torch.from_numpy(labels), k,
                        torch.from_numpy(prev), empty_policy="nearest")
    for nv in (n, n - 17):
        np.testing.assert_allclose(
            float(td.masked_min_sum(torch.from_numpy(mindist), nv)),
            float(jd.masked_min_sum(jnp.asarray(mindist), nv)), rtol=1e-5)
