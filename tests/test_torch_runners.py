"""The port's k-means runners against the JAX package's, on the CPU.

- ``eval_kmeans_optimal`` (the ground-truth-centroid upper bound, through
  each package's ``main --optimal`` on one packed feature store):
  predictions and printed ACC lines bit-equal.  The class structure keeps
  every row's nearest centroid far from a tie, so f32 sums in another
  order cannot flip a label.
- ``eval_kmeans_semi_sup``: the k-means++ draws differ between
  ``jax.random`` and ``torch.Generator`` (decided in the first slice), so
  the two are compared by ACC on well-separated blobs: both 1.0.
- ``stratified_accs`` (host logic) bit-equal; ``collate_features`` over a
  ``FeatureVectorDataset`` equal to the JAX package's.
"""

import contextlib
import io

import numpy as np
import pytest


def _store(tmp_path, n=600, d=32, k=10, seed=0, noise=0.3):
    rng = np.random.default_rng(seed)
    means = 3.0 * rng.standard_normal((k, d))
    targets = rng.integers(0, k, n).astype(np.int64)
    feats = (means[targets] + noise * rng.standard_normal((n, d))).astype(
        np.float32)
    mask_lab = (rng.random(n) < 0.3) & (targets < k // 2)
    path = str(tmp_path / "store.npz")
    np.savez(path, features=feats, targets=targets, mask_lab=mask_lab)
    return path, feats, targets, mask_lab


def _lines(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue().splitlines()


def test_optimal_main_bit_equal(tmp_path):
    from scd_tpu.cluster.runners import main as jax_main
    from scd_tpu_torch.cluster.runners import main as torch_main

    path, *_ = _store(tmp_path)
    argv = ["--features", path, "--n_train_classes", "5", "--optimal"]
    jout, jlines = _lines(jax_main, argv)
    tout, tlines = _lines(torch_main, argv + ["--device", "cpu"])
    assert len(tlines) == 3 and tlines == jlines
    assert tlines[0].startswith(
        "Epoch None, Optimal K-Means Train ACC Unlabelled_v1: All ")
    np.testing.assert_array_equal(tout[3], np.asarray(jout[3]))
    assert tout[:3] == jout[:3]


def test_semi_sup_acc_on_blobs(tmp_path):
    import jax

    from scd_tpu.cluster.runners import eval_kmeans_semi_sup as jax_ss
    from scd_tpu.core.config import ClusterConfig as JCfg
    from scd_tpu_torch.cluster.runners import eval_kmeans_semi_sup
    from scd_tpu_torch.core.config import ClusterConfig

    _, feats, targets, mask_lab = _store(tmp_path, noise=0.1, seed=3)
    feats = feats / np.linalg.norm(feats, axis=1, keepdims=True)
    mask_cls = targets < 5
    kw = dict(n_clusters=10, n_init=3, max_iterations=20)
    j = jax_ss(jax.random.PRNGKey(0), feats, targets, mask_cls, mask_lab,
               JCfg(**kw), print_output=False)
    t = eval_kmeans_semi_sup(feats, targets, mask_cls, mask_lab,
                             ClusterConfig(**kw), print_output=False,
                             device="cpu")
    assert t[0] == j[0] == 1.0
    assert t[3].shape == (int((~mask_lab).sum()),)


def test_stratified_accs_bit_equal():
    from scd_tpu.cluster.runners import stratified_accs as jax_strat
    from scd_tpu_torch.cluster.runners import stratified_accs

    rng = np.random.default_rng(5)
    u_targets = rng.integers(0, 8, 400)
    u_preds = np.where(rng.random(400) < 0.8, u_targets,
                       rng.integers(0, 8, 400))
    mask = u_targets < 4
    diff = {"Easy": [11, 12], "Medium": [13, 14], "Hard": [99]}
    args = (u_targets, u_preds, mask, diff, [1, 2, 3, 4], [11, 12, 13, 14])
    j, jl = _lines(jax_strat, *args)
    t, tl = _lines(stratified_accs, *args)
    assert tl == jl and len(tl) == 6
    for diff_name in ("Easy", "Medium", "Hard"):  # NaN: an empty stratum
        np.testing.assert_array_equal(t[diff_name], j[diff_name])
    assert all(np.isnan(t["Hard"]))


def test_collate_feature_vector_dataset(tmp_path):
    from scd_tpu.cluster.runners import collate_features as jax_collate
    from scd_tpu.data.features import FeatureVectorDataset as JFVD
    from scd_tpu_torch.cluster.runners import collate_features
    from scd_tpu_torch.data.features import (FeatureVectorDataset,
                                             save_features_packed)

    rng = np.random.default_rng(1)
    n = 40
    feats = rng.standard_normal((n, 8)).astype(np.float32)
    save_features_packed(str(tmp_path), feats, np.arange(n) + 100)
    base = [(None, i % 4, 100 + i, int(i % 3 == 0)) for i in range(n)]
    t = collate_features(FeatureVectorDataset(base, str(tmp_path)), 2,
                         batch_size=16, num_workers=2, device="cpu")
    j = jax_collate(JFVD(base, str(tmp_path)), 2, batch_size=16,
                    num_workers=2)
    np.testing.assert_allclose(t[0], np.asarray(j[0]), atol=1e-6, rtol=0)
    for a, b in zip(t[1:], j[1:]):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_cuda_request_without_card_raises(tmp_path, monkeypatch):
    import torch

    from scd_tpu_torch.cluster.runners import main

    path, *_ = _store(tmp_path, n=50)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--features", path, "--n_train_classes", "5", "--optimal"])
