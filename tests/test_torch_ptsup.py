"""The partially supervised entry point of the port against the JAX
package's, on the CPU.

- ``zero_shot_preds`` (chunked, ragged last chunk), ``zero_shot_top1``
  and ``soft_sacc_bounds``: equal predictions, accuracies and printed
  lines.
- ``voting_loop_ptsup``: equal voted names and assignments at every round,
  including the break when no unlabelled cluster is left to vote.
- Cached re-entry (``run_cluster=False``) on the oracle root
  (``tests/oracle_fabricate.py``, imported into one cache by the JAX
  package's importer): byte-equal output, bound lines included, with and
  without the textual-enhancement round.
- The asset-free synthetic run through both packages' ``main``, with the
  SSKM flags of ``scripts/evaluate_partial_supervised.sh`` and the ConSSKM
  flags of ``scripts/smoke_all.sh``: the k-means++ draws differ between
  ``jax.random`` and ``torch.Generator``, so the partitions are compared
  first (ARI 1.0 on this data), then the lines byte for byte.
- Without ``--device`` and without a card, ``main`` raises.
"""

import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

EVAL_PTSUP = ["--batch_size", "32", "--dataset_name", "synthetic",
              "--feat_model", "synthetic", "--cluster", "SSKM",
              "--n_cluster", "10", "--topk", "3", "--num_common_vote", "10",
              "--num_common_linear", "2"]
SMOKE_PTSUP = ["--dataset_name", "synthetic", "--cluster", "ConSSKM",
               "--n_cluster", "10", "--cluster_size_min", "5",
               "--cluster_size_max", "50"]


def _printed(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*a, **kw)
    return res, buf.getvalue().splitlines()


def _unit(x, axis):
    return (x / np.linalg.norm(x, axis=axis, keepdims=True)).astype(
        np.float32)


def _naming_inputs(seed=0, n=700, d=16, v=60, k=6):
    """Features near k class names (columns 0..k-1) among v names."""
    rng = np.random.default_rng(seed)
    w = _unit(rng.standard_normal((d, v)), 0)
    y = rng.integers(0, k, n)
    f = _unit(w[:, y].T + 0.35 * rng.standard_normal((n, d)), 1)
    return f, w, y


def test_zero_shot_preds_and_soft_bounds_match_jax():
    from scd_tpu.pipelines import ptsup as J
    from scd_tpu_torch.pipelines import ptsup as T

    f, w, y = _naming_inputs()
    ft, wt = torch.as_tensor(f), torch.as_tensor(w)
    want = J.zero_shot_preds(f, w, batch=256)
    got = T.zero_shot_preds(ft, wt, batch=256)
    np.testing.assert_array_equal(got, want)
    assert len(T.zero_shot_preds(ft[:0], wt)) == 0

    names = [f"name_{i}" for i in range(w.shape[1])]
    cidx = {c: names[c] for c in range(6)}
    assert T.zero_shot_top1(ft, y, cidx, names, wt) == \
        J.zero_shot_top1(f, y, cidx, names, w) > 50.0
    mask = y < 3
    sim = {(a, b): 1.0 if a == b else 0.25 for a in names for b in names}

    def name_sim(a, b):
        return sim[(a, b)]

    outs = []
    for mod, fa, wa in ((J, f, w), (T, ft, wt)):
        for pre in (None, want):  # computed here, or the bound passes'
            res, lines = _printed(mod.soft_sacc_bounds, fa, y, mask, cidx,
                                  names, wa, name_sim, lb_preds=pre)
            outs.append((res, lines))
    assert all(o == outs[0] for o in outs[1:])
    assert len(outs[0][1]) == 6


def _ptsup_loop_case(seed, broken):
    f, w, y = _naming_inputs(seed, v=60, k=6)
    rng = np.random.default_rng(seed + 1)
    nouns = [f"name_{i}" for i in range(w.shape[1])]
    logits = 100.0 * f @ w
    topk = np.argsort(-logits, axis=1, kind="stable")[:, :3].astype(np.int32)
    lab_names = nouns[:3]
    if broken:  # every image sits in a labelled cluster: nothing votes
        u_preds = rng.integers(0, 3, len(y))
        unlab = [7]
    else:
        u_preds = np.where(rng.random(len(y)) < 0.9, y, rng.integers(0, 6,
                                                                     len(y)))
        unlab = [3, 4, 5]
    return nouns, topk, f, w, u_preds, unlab, lab_names


@pytest.mark.parametrize("broken", [False, True])
def test_voting_loop_ptsup_matches_jax(broken):
    from scd_tpu.core.config import NamingConfig as JN
    from scd_tpu.naming.loop import voting_loop_ptsup as jloop
    from scd_tpu.naming.loop import voting_loop_ptsup_te as jloop_te
    from scd_tpu_torch.core.config import NamingConfig as TN
    from scd_tpu_torch.naming.loop import voting_loop_ptsup as tloop
    from scd_tpu_torch.naming.loop import voting_loop_ptsup_te as tloop_te

    nouns, topk, f, w, u_preds, unlab, lab = _ptsup_loop_case(4, broken)
    hist = {}

    def cb(tag):
        def record(it, preds, cand):
            hist.setdefault(tag, []).append((it, list(cand),
                                             np.asarray(preds).tolist()))
        return record

    kw = dict(topk=3, num_common_vote=10, num_common_linear=2)
    jr = jloop(nouns, topk, f, w, u_preds, unlab, lab, 6, JN(**kw),
               metrics_cb=cb("jax"))
    ft, wt = torch.as_tensor(f), torch.as_tensor(w)
    tr = tloop(nouns, topk, ft, wt, u_preds, unlab, lab, 6, TN(**kw),
               metrics_cb=cb("torch"))
    for a, b in ((jr, tr), (jloop_te(nouns, topk, f, w, jr, lab, 6, JN(**kw)),
                            tloop_te(nouns, topk, ft, wt, tr, lab, 6,
                                     TN(**kw)))):
        assert b.cand_names == a.cand_names and b.n_iters == a.n_iters
        assert b.lab_class_index == a.lab_class_index
        np.testing.assert_array_equal(b.u_preds, np.asarray(a.u_preds))
    assert hist.get("torch") == hist.get("jax")
    if broken:
        assert tr.cand_names == sorted(lab) and tr.n_iters == 1
        assert set(tr.u_preds.tolist()) <= {0, 1, 2}
    else:
        assert len(hist["torch"]) >= 2 and len(tr.cand_names) == 6


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    from oracle_fabricate import fabricate_oracle_root
    from scd_tpu.core import config as J
    from scd_tpu.pipelines.interop import import_reference_artifacts

    from scd_tpu.pipelines.common import (cluster_cache_key,
                                          feature_cache_key, stage_cache)

    base = tmp_path_factory.mktemp("torch_ptsup")
    root, cache = str(base / "root"), str(base / "cache")
    fabricate_oracle_root(root)
    cfgs = []
    for alg, k, te in (("KM", 20, False), ("SSKM", 100, False),
                       ("SSKM", 100, True)):
        cfgs.append(J.PipelineConfig(
            data=J.DataConfig(dataset_name="imagenet_100", root_dir=root,
                              corpus_dir=os.path.join(root, "data"),
                              wordnet_db_dir=os.path.join(
                                  root, "nltk_data", "corpora", "wordnet"),
                              cache_dir=cache),
            feature=J.FeatureConfig(feat_model="dino_vit"),
            cluster=J.ClusterConfig(algorithm=alg, n_clusters=k),
            naming=J.NamingConfig(corpus="wordnet", topk=5,
                                  num_common_vote=20, num_common_linear=4,
                                  textual_enhancement=te),
            partially_supervised=True, run_cluster=False))
    assert len(import_reference_artifacts(root, cfgs[0])) == 4
    # the imported KM result carries all_preds for the unlabelled rows
    # only; ptsup reads the labelled rows' too, so store it as an SSKM
    # result over 100 clusters: the labelled rows in their remapped
    # classes first, the KM clusters after them
    store = stage_cache(cfgs[0])
    feats = store.load("features", feature_cache_key(cfgs[0], "feat"))
    km = store.load("cluster", cluster_cache_key(cfgs[0]))
    lab = feats["mask_lab"].astype(bool)
    all_preds = np.empty(len(lab), np.int64)
    _, all_preds[lab] = np.unique(feats["targets"][lab],
                                  return_inverse=True)
    u_preds = km["u_preds"] + all_preds[lab].max() + 1
    all_preds[~lab] = u_preds
    store.save("cluster", cluster_cache_key(cfgs[1]),
               dict(km, all_preds=all_preds, u_preds=u_preds))
    return cfgs[1:]


@pytest.mark.parametrize("te", [False, True])
def test_cached_reentry_byte_equal(oracle, te):
    import dataclasses

    from scd_tpu.pipelines.ptsup import run_ptsup as jax_run
    from scd_tpu_torch.core import config as T
    from scd_tpu_torch.pipelines.ptsup import run_ptsup as torch_run

    jcfg = oracle[int(te)]
    tcfg = T.PipelineConfig(
        data=T.DataConfig(**dataclasses.asdict(jcfg.data)),
        feature=T.FeatureConfig(**dataclasses.asdict(jcfg.feature)),
        cluster=T.ClusterConfig(**dataclasses.asdict(jcfg.cluster)),
        naming=T.NamingConfig(**dataclasses.asdict(jcfg.naming)),
        partially_supervised=True, run_cluster=False)
    jres, jlines = _printed(jax_run, jcfg)
    tres, tlines = _printed(torch_run, tcfg, device="cpu")
    assert tlines == jlines
    assert tlines[0] == "=====sACC lower bound=====" and len(tlines) > 20
    assert any(ln.startswith("Soft sACC all") for ln in tlines)
    assert ("-- textual enhancement round --" in tlines) == te
    assert tres["voting"].cand_names == jres["voting"].cand_names
    assert tres["bounds"] == jres["bounds"]


@pytest.mark.parametrize("argv", [EVAL_PTSUP, SMOKE_PTSUP],
                         ids=["SSKM", "ConSSKM"])
def test_synthetic_main_byte_equal(tmp_path, argv):
    from sklearn.metrics import adjusted_rand_score

    from scd_tpu.pipelines.ptsup import main as jax_main
    from scd_tpu_torch.pipelines.ptsup import main as torch_main

    out = []
    for fn, extra in ((jax_main, []), (torch_main, ["--device", "cpu"])):
        cache = tmp_path / f"cache{len(out)}"
        _, lines = _printed(fn, argv + ["--cache_dir", str(cache)] + extra)
        (f,) = [p for p in os.listdir(cache) if p.startswith("cluster_")
                and p.endswith(".npz")]
        with np.load(cache / f) as z:
            out.append((z["u_preds"], lines))
    assert adjusted_rand_score(out[0][0], out[1][0]) == 1.0
    assert out[1][1] == out[0][1] and out[0][1][-1] == "IoU: 1.0"


def test_main_without_card_raises(monkeypatch, tmp_path):
    from scd_tpu_torch.pipelines.ptsup import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (EVAL_PTSUP, SMOKE_PTSUP):
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv + ["--cache_dir", str(tmp_path)])
