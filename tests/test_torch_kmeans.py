"""The port's Lloyd loop against the JAX package's, KM and SSKM, from the
SAME injected initial centers.

The k-means++ draws are not compared: the port draws from a
``torch.Generator``, the JAX package from ``jax.random``, and the two give
different numbers from one seed (ROADMAP records this choice).  Given the
same initial centers, both loops must agree.

Tolerances: labels and the iteration count must be equal (blob margins
are far above f32 resolution); centers agree to 1e-5 and inertia to 1e-5
relative (f32 sums in different orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scd_tpu.cluster.kmeans import _lloyd_loop as jax_lloyd
from scd_tpu.ops.segment import segment_sums as jax_segment_sums
from scd_tpu_torch.cluster import kmeans as tk
from scd_tpu_torch.core.config import ClusterConfig
from scd_tpu_torch.ops.segment import segment_sums

RTOL = 1e-5


def _blobs(n, d, k, seed, std=0.6):
    rng = np.random.default_rng(seed)
    means = 4.0 * rng.standard_normal((k, d))
    y = rng.integers(0, k, n)
    x = (means[y] + std * rng.standard_normal((n, d))).astype(np.float32)
    return x, y


@pytest.mark.parametrize("k,max_iter", [(6, 10), (9, 3)])
def test_lloyd_km_matches_jax(k, max_iter):
    x, _ = _blobs(500, 16, k, seed=k)
    rng = np.random.default_rng(1)
    c0 = x[rng.choice(len(x), k, replace=False)]
    row_w = np.ones(len(x), np.float32)
    jl, ji, jc, jn = jax_lloyd(jnp.asarray(x), jnp.asarray(c0), k, max_iter,
                               1e-4, jnp.asarray(row_w), fused=False)
    tl, ti, tc, tn = tk._lloyd_loop(torch.from_numpy(x), torch.from_numpy(c0),
                                    k, max_iter, 1e-4,
                                    row_w=torch.from_numpy(row_w))
    assert tn == int(jn)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(float(ti), float(ji), rtol=RTOL)


def test_lloyd_sskm_matches_jax():
    """SSKM: labelled sums/counts and the labelled inertia enter every
    iteration; the first n_l_classes centers are the labelled means."""
    k, n_l_cls = 8, 4
    x, y = _blobs(600, 12, k, seed=3)
    lab = y < n_l_cls
    l, l_y = x[lab][:150], y[lab][:150]
    u = x[150:]
    rng = np.random.default_rng(2)
    l_sums_j, l_counts_j = jax_segment_sums(jnp.asarray(l), jnp.asarray(l_y),
                                            k)
    l_means = np.asarray(l_sums_j / jnp.maximum(l_counts_j, 1.0)[:, None])
    c0 = np.concatenate([l_means[:n_l_cls],
                         u[rng.choice(len(u), k - n_l_cls, replace=False)]])

    def j_inertia(c):
        diffs = jnp.asarray(l) - c[jnp.asarray(l_y)]
        return jnp.sum(diffs * diffs)

    jl, ji, jc, jn = jax_lloyd(jnp.asarray(u), jnp.asarray(c0), k, 10, 1e-4,
                               jnp.ones(len(u), jnp.float32),
                               extra_sums=l_sums_j, extra_counts=l_counts_j,
                               extra_inertia_fn=j_inertia, fused=False)
    lt, lyt = torch.from_numpy(l), torch.from_numpy(l_y)
    l_sums, l_counts = segment_sums(lt, lyt, k)

    def t_inertia(c):
        diffs = lt - c[lyt]
        return (diffs * diffs).sum()

    tl, ti, tc, tn = tk._lloyd_loop(torch.from_numpy(u), torch.from_numpy(c0),
                                    k, 10, 1e-4, extra_sums=l_sums,
                                    extra_counts=l_counts,
                                    extra_inertia_fn=t_inertia)
    assert tn == int(jn)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(float(ti), float(ji), rtol=RTOL)


def test_fit_sskm_contract():
    """Labelled rows first with their remapped class ids; the restarts'
    best partition recovers the blobs."""
    from sklearn.metrics import adjusted_rand_score

    k = 6
    x, y = _blobs(900, 10, k, seed=7, std=0.4)
    lab = np.zeros(len(x), bool)
    lab[:200] = True
    lab &= y < 3
    res = tk.fit_sskm(x[~lab], x[lab], y[lab] + 10,
                      ClusterConfig(algorithm="SSKM", n_clusters=k, n_init=3),
                      device="cpu")
    n_l = int(lab.sum())
    np.testing.assert_array_equal(res.labels[:n_l],
                                  np.unique(y[lab], return_inverse=True)[1])
    assert adjusted_rand_score(y[~lab], res.labels[n_l:]) > 0.95
    km = tk.fit_kmeans(x, ClusterConfig(n_clusters=k, n_init=3),
                       device="cpu")
    assert adjusted_rand_score(y, km.labels) > 0.95
    fl = tk.fit_kmeans_from_labels(x, y, ClusterConfig(n_clusters=k),
                                   device="cpu")
    np.testing.assert_array_equal(fl.labels, y)


def test_fitters_send_numpy_to_the_card(monkeypatch):
    """With no ``device``, a numpy input goes to the card: without one
    the three fitters raise ``resolve_device``'s error (the JAX package's
    fitters run on the default backend); a tensor stays where it is."""
    x, y = _blobs(60, 4, 3, seed=2)
    cfg = ClusterConfig(n_clusters=3, n_init=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tk.fit_kmeans(x, cfg),
                 lambda: tk.fit_sskm(x[20:], x[:20], y[:20], cfg),
                 lambda: tk.fit_kmeans_from_labels(x, y, cfg)):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
    res = tk.fit_kmeans(torch.from_numpy(x), cfg)
    assert res.labels.shape == (60,)


def test_estep_resolution_and_dispatch():
    cfg = ClusterConfig(n_clusters=5)
    x = torch.from_numpy(_blobs(400, 8, 5, seed=1)[0])
    assert tk._resolve_estep(cfg, False, x) == (3, False)
    for mode, want in (("exact", (3, False)), ("2pass", (2, False)),
                       ("x_bf16", (3, True))):
        assert tk._resolve_estep(ClusterConfig(n_clusters=5, estep=mode),
                                 True, x) == want
    # the probe itself, run through the plain versions: clear blobs agree
    assert tk._resolve_estep(cfg, True, x) == (3, True)
    assert tk._use_fused("auto", torch.device("cpu")) is False
    with pytest.raises(ValueError, match="CPU only"):
        tk._use_fused(False, torch.device("cuda"))
