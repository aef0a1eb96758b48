"""The port's reference-cache importer against the JAX package's, on the
CPU.  Both run on the same fabricated reference ``.pt`` files (the
reference's directory layout and key schema, ``main_unsup.py:294-311,
366-374, 387-395``) into the same cache directory in turn; the entries
they write (file names, so keys, and every array with its dtype) are
equal, and so are the shape-mismatch and rank errors."""

import os
import shutil

import numpy as np
import pytest
import torch


def _fabricate(root, ds, fm, alg, k, zw_dict, seed=0, n=40, d=16, v=12):
    rng = np.random.default_rng(seed)
    for sub in ("extracted_features", "cluster", "zeroshot_weights"):
        os.makedirs(os.path.join(root, sub))
    mask_lab = rng.random(n) < 0.4
    for name, dim in ((f"{fm}_{ds}_all.pt", d), (f"clip_{ds}_all.pt", d + 2)):
        torch.save({"all_feats": torch.randn(n, dim, dtype=torch.float16),
                    "mask_lab": torch.as_tensor(mask_lab),
                    "mask_cls": rng.random(n) < 0.5,
                    "targets": torch.as_tensor(rng.integers(0, k, n))},
                   os.path.join(root, "extracted_features", name))
    n_u = int((~mask_lab).sum())
    all_preds = (None if alg == "KM"  # the reference's KM quirk
                 else torch.as_tensor(rng.integers(0, k, n)))
    torch.save({"all_preds": all_preds,
                "u_preds": rng.integers(0, k, n_u),
                "u_targets": torch.as_tensor(rng.integers(0, k, n_u)),
                "mask": rng.random(n_u) < 0.5},
               os.path.join(root, "cluster", f"{alg}_{fm}_{ds}_{k}.pt"))
    zw = torch.randn(d + 2, v, dtype=torch.bfloat16)
    torch.save({"weights": zw} if zw_dict else zw,
               os.path.join(root, "zeroshot_weights",
                            "zeroshot_weights_all_nouns_vit_b_16.pt"))


def _snapshot(cache_dir):
    out = {}
    for f in sorted(os.listdir(cache_dir)):
        if f.endswith(".npz"):
            with np.load(os.path.join(cache_dir, f)) as z:
                out[f] = {k: z[k] for k in z.files}
    return out


@pytest.mark.parametrize("alg,zw_dict", [("KM", False), ("SSKM", True)])
def test_importers_write_equal_entries(tmp_path, alg, zw_dict):
    from scd_tpu.core import config as J
    from scd_tpu.pipelines.interop import import_reference_artifacts
    from scd_tpu_torch.pipelines.interop import main

    ref, cache = str(tmp_path / "ref"), str(tmp_path / "cache")
    _fabricate(ref, "imagenet_100", "dino_vit", alg, 5, zw_dict)
    cfg = J.PipelineConfig(
        data=J.DataConfig(dataset_name="imagenet_100", cache_dir=cache),
        feature=J.FeatureConfig(feat_model="dino_vit"),
        cluster=J.ClusterConfig(algorithm=alg, n_clusters=5),
        naming=J.NamingConfig(corpus="wordnet"))
    assert len(import_reference_artifacts(ref, cfg)) == 4
    want = _snapshot(cache)
    shutil.rmtree(cache)
    assert main(["--ref_root", ref, "--dataset_name", "imagenet_100",
                 "--feat_model", "dino_vit", "--cluster", alg,
                 "--n_cluster", "5", "--corpus", "wordnet",
                 "--cache_dir", cache]) == 0
    got = _snapshot(cache)
    assert sorted(got) == sorted(want) and len(got) == 4
    for f, arrays in want.items():
        assert sorted(got[f]) == sorted(arrays)
        for k, a in arrays.items():
            assert got[f][k].dtype == a.dtype, (f, k)
            np.testing.assert_array_equal(got[f][k], a)
    assert main(["--ref_root", str(tmp_path / "nothing"),
                 "--cache_dir", cache]) == 1


def test_importer_errors_match_jax(tmp_path):
    from scd_tpu.core import config as J
    from scd_tpu.pipelines import interop as JI
    from scd_tpu_torch.core import config as T
    from scd_tpu_torch.pipelines import interop as TI

    bad = str(tmp_path / "bad.pt")
    torch.save({"all_feats": np.zeros((4, 3), np.float32),
                "mask_lab": np.zeros(5, bool), "mask_cls": np.zeros(4, bool),
                "targets": np.zeros(4, np.int64)}, bad)
    zw = str(tmp_path / "zw.pt")
    torch.save(torch.zeros(7), zw)
    msgs = []
    for M, I in ((J, JI), (T, TI)):
        cfg = M.PipelineConfig(data=M.DataConfig(
            cache_dir=str(tmp_path / "cache")))
        with pytest.raises(ValueError) as e1:
            I.import_reference_features(bad, cfg, "feat")
        with pytest.raises(ValueError) as e2:
            I.import_reference_zeroshot(zw, cfg)
        msgs.append((str(e1.value), str(e2.value)))
    assert msgs[1] == msgs[0]
    assert "mask_lab" in msgs[0][0] and "D, V" in msgs[0][1]
