"""The port's dataset readers against the JAX package's, on the CPU.

- Every name of the JAX registry, on a root fabricated in the dataset's
  own file format (as ``tests/test_dataset_readers.py`` does; CUB and
  Stanford Dogs by the port's fabricator, which ``chip_smoke.py`` runs at
  the published sizes): equal tables from the reader (paths or indices,
  int64 targets, ``uq_idxs``, class names, meta, extras) and from
  ``get_datasets`` (class splits, the four split tables with their
  remapped targets, the labelled mask).  Host code in both packages, so
  every comparison is exact.
- ``imagenet_osr``: equal tree distances, tiers and seed-0 draws.
- ``shards``: written by either package and read by the other, batch for
  batch, whole or one process's share.
- A cached ``run_unsup`` on a small fabricated CUB root and a cached
  ``run_ptsup`` with the textual-enhancement round on a small Stanford
  Dogs root: byte-equal metric lines.
"""

import contextlib
import dataclasses
import io
import os
import pickle

import numpy as np
import pytest

from scd_tpu.core import config as J
from scd_tpu.data import registry as JR
from scd_tpu_torch.core import config as T
from scd_tpu_torch.data import registry as TR

NAMES = sorted(JR._READERS)


def _touch(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    open(path, "w").close()


def _pickle(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _ssb(root, name, n_classes):
    known = list(range(0, n_classes, 2))
    rest = list(range(1, n_classes, 2))
    _pickle(os.path.join(root, "ssb_splits", f"{name}_osr_splits.pkl"),
            {"known_classes": known, "unknown_classes": {
                "Hard": rest[:1], "Medium": rest[1:2], "Easy": rest[2:]}})


def _cifar(root, which, rng):
    def batch(n, key):
        return {b"data": rng.integers(0, 255, (n, 3072), dtype=np.uint8),
                key: [int(v) for v in rng.integers(0, which, n)]}

    if which == 10:
        base = os.path.join(root, "cifar-10-batches-py")
        files = {f"data_batch_{i}": 20 for i in range(1, 6)}
        files["test_batch"] = 10
        key, meta = b"labels", ("batches.meta", b"label_names")
    else:
        base = os.path.join(root, "cifar-100-python")
        files, key = {"train": 300, "test": 40}, b"fine_labels"
        meta = ("meta", b"fine_label_names")
    for fname, n in files.items():
        _pickle(os.path.join(base, fname), batch(n, key))
    _pickle(os.path.join(base, meta[0]),
            {meta[1]: [f"class-{i}".encode() for i in range(which)]})


def _scars(root):
    from scipy.io import savemat

    os.makedirs(os.path.join(root, "devkit"))
    cn = np.empty((1, 6), object)
    for i in range(6):
        cn[0, i] = np.array([f"Car Model {i}"])
    savemat(os.path.join(root, "devkit", "cars_meta.mat"),
            {"class_names": cn})
    for fname, n in (("cars_train_annos.mat", 24),
                     ("cars_test_annos_withlabels.mat", 12)):
        arr = np.zeros((1, n), dtype=[("fname", "O"), ("class", "O")])
        for i in range(n):
            arr[0, i] = (np.array([f"{i:05d}.jpg"]),
                         np.array([[i % 6 + 1]]))
        savemat(os.path.join(root, "devkit", fname), {"annotations": arr})
    _ssb(root, "scars", 6)


def _aircraft(root):
    base = os.path.join(root, "fgvc-aircraft-2013b", "data")
    os.makedirs(base)
    variants = [f"7{i}7-{i}00" for i in range(8)] + ["A310", "F/A-18"]
    with open(os.path.join(base, "variants.txt"), "w") as f:
        f.write("\n".join(variants) + "\n")
    for split, n in (("trainval", 30), ("test", 10)):
        with open(os.path.join(base, f"images_variant_{split}.txt"),
                  "w") as f:
            for i in range(n):
                f.write(f"{split[:2]}{i:05d} {variants[i % 10]}\n")
    _ssb(root, "aircraft", 10)


def _imagefolder(root, splits, classes, per=3):
    for split in splits:
        for j, cls in enumerate(classes):
            for i in range(per + j % 2):
                _touch(os.path.join(root, split, cls, f"{i}.jpg"))
            _touch(os.path.join(root, split, cls, "notes.txt"))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One fabricated root per dataset name."""
    from scd_tpu_torch.testing.fabricate import (fabricate_cub_tree,
                                                 fabricate_sdogs_tree)

    base = tmp_path_factory.mktemp("readers")
    rng = np.random.default_rng(0)
    out = {}
    for name in NAMES:
        out[name] = str(base / name)
        os.makedirs(out[name])
    fabricate_cub_tree(out["cub"], seed=3, n_train=400, n_test=200)
    fabricate_sdogs_tree(out["sdogs"], n_train=240, n_test=120)
    _cifar(out["cifar10"], 10, rng)
    _cifar(out["cifar100"], 100, rng)
    wnids = [f"n{i:08d}" for i in range(1000)]
    _imagefolder(os.path.join(out["imagenet_100"], "ILSVRC12"),
                 ("train", "val"), wnids, per=1)
    out["imagenet_1000"] = out["imagenet_100"]  # the same ILSVRC12 tree
    _imagefolder(os.path.join(out["imagenet_127"], "imagenet127"), ("val",),
                 wnids[:127], per=2)
    _aircraft(out["aircraft"])
    _scars(out["scars"])
    _imagefolder(out["herbarium_19"], ("small-train", "small-validation"),
                 ["100", "205", "31", "4"])
    _pickle(os.path.join(out["herbarium_19"], "ssb_splits",
                         "herbarium_19_class_splits.pkl"),
            {"Old": [0, 2], "New": [1, 3]})
    _imagefolder(out["imagefolder"], ("train",), ["cat", "dog", "eel"])
    _imagefolder(out["imagefolder"], ("val",), ["dog", "eel", "fox"])
    return out


def _equal(a, b):
    """Deep equality of reader outputs (dicts, lists, arrays, scalars)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def _table(t):
    targets = t.targets if t.target_transform is None else np.array(
        [t.target_transform(int(x)) for x in t.targets], np.int64)
    return {"source": t.source, "targets": t.targets, "resolved": targets,
            "uq_idxs": t.uq_idxs, "classnames": list(t.classnames),
            "meta": t.meta}


def _cfgs(name, root):
    return (J.DataConfig(dataset_name=name, root_dir=root),
            T.DataConfig(dataset_name=name, root_dir=root))


@pytest.mark.parametrize("name", NAMES)
def test_reader_and_get_datasets_match_jax(roots, name):
    jcfg, tcfg = _cfgs(name, roots[name])
    jw, jt, jx = JR._READERS[name](jcfg)
    tw, tt, tx = TR._READERS[name](tcfg)
    for a, b in ((jw, tw), (jt, tt)):
        assert b.targets.dtype == np.int64 and len(b) > 0
        assert _equal(_table(a), _table(b))
    assert _equal(jx, tx)
    if name == "cifar10":  # in-memory images: the same pixels
        assert np.array_equal(np.asarray(jw.load(jw.source[3])),
                              np.asarray(tw.load(tw.source[3])))

    splits = {}
    if name == "imagefolder":  # no default splits: the caller names them
        for mod, cfg in ((JR, jcfg), (TR, tcfg)):
            with pytest.raises(NotImplementedError, match="no class splits"):
                mod.get_class_splits(cfg)
        splits = {"train_classes": [0, 2], "unlabeled_classes": [1]}
    else:
        assert _equal(tuple(map(list, JR.get_class_splits(jcfg))),
                      tuple(map(list, TR.get_class_splits(tcfg))))
    jout = JR.get_datasets(jcfg, **splits)
    tout = TR.get_datasets(tcfg, **splits)
    assert np.array_equal(jout[0].mask_lab, tout[0].mask_lab)
    assert np.array_equal(jout[0].targets, tout[0].targets)
    for a, b in zip(jout[1:3], tout[1:3]):
        assert _equal(_table(a), _table(b))
    js, ts = jout[3].pop("splits"), tout[3].pop("splits")
    assert _equal(jout[3], tout[3])
    for field in ("train_labelled", "train_unlabelled", "test",
                  "train_unlabelled_test"):
        assert _equal(_table(getattr(js, field)), _table(getattr(ts, field)))
    assert len(ts.train_labelled) > 0 and len(ts.train_unlabelled) > 0


def test_registry_reads_every_dataset():
    assert list(TR._READERS) == list(JR._READERS)
    assert TR._DEFAULT_SPLITS == JR._DEFAULT_SPLITS


def test_imagenet_osr_matches_jax():
    from scd_tpu.data import imagenet_osr as JO
    from scd_tpu_torch.data import imagenet_osr as TO

    rng = np.random.default_rng(5)
    n_i1k, n_i21k, n_anc = 6, 40, 12
    class_list = ([f"a{i}" for i in range(n_i1k)]
                  + [f"b{i}" for i in range(n_i21k)]
                  + [f"h{i}" for i in range(n_anc)])
    tree = []
    for c in range(n_i1k + n_i21k):
        depth = int(rng.integers(0, 4))
        anc = sorted(rng.choice(n_anc, depth, replace=False).tolist())
        tree.append([c] + [n_i1k + n_i21k + a for a in anc])
    i1k = class_list[:n_i1k] + ["absent"]
    i21k = class_list[n_i1k:n_i1k + n_i21k]
    c2i = {w: i for i, w in enumerate(class_list)}
    for total in (True, False):
        jm, jrows = JO.semantic_tree_distances(tree, class_list, i1k, i21k,
                                               total_path=total)
        tm, trows = TO.semantic_tree_distances(tree, class_list, i1k, i21k,
                                               total_path=total)
        assert trows == jrows and np.array_equal(tm, jm)
    for tier in (1, 7, 100):
        jt = JO.osr_difficulty_splits(jm, i21k, tier_size=tier)
        assert TO.osr_difficulty_splits(tm, i21k, tier_size=tier) == jt
    for split in ("random", "Easy", "Medium", "Hard"):
        kw = dict(num_classes=9, osr_split=split, precomputed=jt)
        assert (TO.get_imagenet_osr_class_splits(c2i, i1k, i21k, **kw)
                == JO.get_imagenet_osr_class_splits(c2i, i1k, i21k, **kw))
    with pytest.raises(ValueError, match="absent"):
        TO.semantic_tree_distances(tree, class_list, i1k, i21k + ["zz"])


def _shard_batches(rng):
    out = []
    for n in (4, 4, 3, 4, 1):
        out.append((rng.integers(0, 255, (n, 8, 6, 3), dtype=np.uint8),
                    rng.integers(0, 10, n), rng.integers(0, 10 ** 6, n),
                    rng.random(n) < 0.5))
    return out


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_shards_round_trip_across_packages(tmp_path, writer):
    from scd_tpu.data import shards as JS
    from scd_tpu_torch.data import shards as TS

    batches = _shard_batches(np.random.default_rng(2))
    w, r = (JS, TS) if writer == "jax" else (TS, JS)
    path = w.write_image_shards(iter(batches), str(tmp_path), shard_size=5)
    other = tmp_path / "other"
    assert r.shard_manifest(str(tmp_path)) == \
        w.shard_manifest(os.path.dirname(
            r.write_image_shards(iter(batches), str(other), shard_size=5)))
    assert sorted(os.listdir(tmp_path / "other")) == sorted(
        p for p in os.listdir(tmp_path) if p != "other")
    assert os.path.basename(path) == "shards.json"
    whole = [np.concatenate(a) for a in zip(*batches)]
    for kw in ({"readahead": 0}, {"readahead": 2},
               {"readahead": 0, "process_shard": (1, 2)}):
        got = list(r.iterate_shard_batches(str(tmp_path), 3, **kw))
        want = list(w.iterate_shard_batches(str(tmp_path), 3, **kw))
        assert len(got) == len(want) > 0
        for g, x in zip(got, want):
            assert all(a.dtype == b.dtype and np.array_equal(a, b)
                       for a, b in zip(g, x))
        if "process_shard" not in kw:
            cat = [np.concatenate(a) for a in zip(*got)]
            assert all(np.array_equal(a, b.astype(a.dtype))
                       for a, b in zip(cat, whole))
    with pytest.raises(ValueError, match="uint8"):
        TS.write_image_shards(iter([(np.zeros((1, 2, 2, 3), np.float32),
                                     [0], [0], [True])]),
                              str(tmp_path / "f32"))


_METRIC_PREFIXES = ("KM Accuracies:", "SSKM Accuracies:", "iter:",
                    "Accuracies:", "ACC/sACC_avg/sACC_all:",
                    "ACC/Soft sACC:", "IoU:", "sACC all", "=====", "-- ")


def _lines(fn, cfg, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(cfg, **kw)
    return res, [ln.rstrip() for ln in buf.getvalue().splitlines()
                 if ln.startswith(_METRIC_PREFIXES)]


def _jax_cfg(tcfg):
    return J.PipelineConfig(
        data=J.DataConfig(**dataclasses.asdict(tcfg.data)),
        feature=J.FeatureConfig(**dataclasses.asdict(tcfg.feature)),
        cluster=J.ClusterConfig(**dataclasses.asdict(tcfg.cluster)),
        naming=J.NamingConfig(**dataclasses.asdict(tcfg.naming)),
        partially_supervised=tcfg.partially_supervised, run_cluster=False)


@pytest.mark.parametrize("name", ["cub", "sdogs"])
def test_cached_fine_grained_run_byte_equal(tmp_path, name):
    """CUB through ``run_unsup`` (``BASELINE.json`` config 1), Stanford Dogs
    through ``run_ptsup`` with the textual-enhancement round (configs 2
    and 4): clustered by the port on the CPU, then re-entered from the
    cache by both packages."""
    from scd_tpu.pipelines import ptsup as JP
    from scd_tpu.pipelines import unsup as JU
    from scd_tpu_torch.pipelines import ptsup as TP
    from scd_tpu_torch.pipelines import unsup as TU
    from scd_tpu_torch.testing.fabricate import (fabricate_fine_grained,
                                                 warm_config)

    ptsup = name == "sdogs"
    k = 200 if name == "cub" else 120
    cfg = warm_config(str(tmp_path / name), name, k, n_init=2,
                      max_iterations=5, textual_enhancement=ptsup,
                      partially_supervised=ptsup)
    info = fabricate_fine_grained(cfg, seed=1, device="cpu",
                                  n_train=6 * k, n_test=2 * k, d_feat=24,
                                  d_clip=16, vocab=1_500, n_genus=10)
    assert info["n_images"] == 6 * k and len(info["class_names"]) == k
    jrun, trun = (JP.run_ptsup, TP.run_ptsup) if ptsup else (JU.run_unsup,
                                                             TU.run_unsup)
    first, _ = _lines(trun, cfg, device="cpu")
    assert first["cluster_acc"][0] > 0.9 and first["iou"] > 0.5
    cached = dataclasses.replace(cfg, run_cluster=False)
    jres, jlines = _lines(jrun, _jax_cfg(cached))
    tres, tlines = _lines(trun, cached, device="cpu")
    assert tlines == jlines and len(tlines) > 10
    assert tres["cidx_to_cname"] == jres["cidx_to_cname"]
    assert tres["voting"].cand_names == jres["voting"].cand_names
    assert ("-- textual enhancement round --" in tlines) == ptsup
    assert any(ln.startswith("ACC/Soft sACC:") for ln in tlines) == ptsup
