"""The port's mesh library paths over 2 and 3 gloo ranks on the CPU.

Each world runs ``scd_tpu_torch.testing.mesh_cases.library_cases`` once
(``scd_tpu_torch.testing.dist.spawn``: fresh interpreters that import the
port only, a 60 s deadline and a collective timeout each) and returns
every rank's results; the cases below check them.  Three ranks leave
ragged shares (401 rows), so the pads and their masks are exercised.

Parity contract:
- against the single-process port (same seed, ``device="cpu"``): the
  k-means++ draws' global row indices equal (both seeders, with and
  without pinned centers); the fitters' labels equal, centers within
  rtol 1e-5, inertia within 1e-5 relative (the merged sums add per-rank
  partial sums: another float order); top-k indices equal, values within
  1e-6;
- against the JAX package's mesh path on its 8-device CPU mesh:
  ``em_iteration_sharded`` (the Pallas kernel in interpret mode, as its
  own tests run it) and ``classify_topk_sharded`` output by output; the
  Lloyd loop from the same initial centers (``fit_kmeans_from_labels``:
  the label centroids, no draws) label for label; whole KM and SSKM runs
  by ARI and ACC (the seeds differ: threefry against ``torch.Generator``,
  a decision on record in ROADMAP.md);
- every rank returns the same results;
- the paths that refused a mesh before they ran over ranks give what
  they give now (see ``test_not_ported_paths_refuse_a_mesh_of_two``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs
from sklearn.metrics import adjusted_rand_score as ari

from scd_tpu.core.config import ClusterConfig as JClusterConfig
from scd_tpu.core.config import MeshConfig as JMeshConfig
from scd_tpu.core.mesh import make_mesh as jmake_mesh
from scd_tpu_torch.core.config import ClusterConfig
from scd_tpu_torch.metrics import cluster_acc
from scd_tpu_torch.testing.dist import spawn

WORLDS = (2, 3)
K = 10
TOPK = 4
# the tensor-parallel trainers against one process: the GCD step's loss
# (the same f32 arithmetic, the partial products summed in another
# order) and the e2e trainers' epoch losses (the JAX package's
# tolerance for its mesh runs)
TP_RTOL = {"make_gcd_state": 1e-5, "train_uno_e2e": 2e-4,
           "train_autonovel_e2e": 2e-4}


def _inputs():
    x, y = make_blobs(n_samples=401, n_features=16, centers=K,
                      random_state=3, cluster_std=2.0)
    x = x.astype(np.float32)
    rng = np.random.default_rng(0)
    noisy = y.copy()
    flip = rng.random(len(y)) < 0.15
    noisy[flip] = rng.integers(0, K, flip.sum())
    feats = rng.standard_normal((50, 16)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    # well-separated blobs for the whole runs against JAX's own seeds
    x_sep, y_sep = make_blobs(n_samples=401, n_features=16, centers=K,
                              random_state=5, cluster_std=0.5)
    zw = rng.standard_normal((16, 72)).astype(np.float32)
    zw /= np.linalg.norm(zw, axis=0, keepdims=True)
    return dict(
        x=x, y=y, k=K, pre=x[:3],
        # K 8 on 10 blobs: the restarts end in distinct optima, so the best
        # one is not a float tie
        cfg_km=ClusterConfig(n_clusters=8, n_init=3, max_iterations=20),
        cfg=ClusterConfig(n_clusters=K, n_init=3, max_iterations=20),
        mask_lab=(y < 5) & (np.arange(len(y)) % 2 == 0), init_labels=noisy,
        centers=x[[0, 40, 80, 120, 160, 200, 240, 280, 320, 360]],
        feats=feats, zw=zw, topk=TOPK, x_sep=x_sep.astype(np.float32),
        y_sep=y_sep, mask_sep=(y_sep < 5) & (np.arange(len(y_sep)) % 2 == 0))


@pytest.fixture(scope="module")
def data():
    return _inputs()


@pytest.fixture(scope="module")
def worlds(data):
    """Both worlds, started together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {w: pool.submit(
            spawn, "scd_tpu_torch.testing.mesh_cases.library_cases",
            world=w, args=(data,), timeout=60, collective_timeout=45)
            for w in WORLDS}
        return {w: f.result() for w, f in runs.items()}


@pytest.fixture(scope="module")
def single(data):
    """The single-process port on the same inputs."""
    from scd_tpu_torch.cluster.kmeans import (fit_kmeans,
                                              fit_kmeans_from_labels,
                                              fit_sskm)
    from scd_tpu_torch.ops.kpp import (kmeans_plus_plus,
                                       kmeans_plus_plus_local_trials)
    from scd_tpu_torch.ops.topk import classify_topk

    x, y, mask = data["x"], data["y"], data["mask_lab"]
    xt = torch.from_numpy(x)
    out = {"kpp": {}}
    for name, fn, kw in (
            ("kpp", kmeans_plus_plus, {}),
            ("kpp_local_trials", kmeans_plus_plus_local_trials, {}),
            ("kpp_pre", kmeans_plus_plus,
             {"pre_centers": torch.from_numpy(data["pre"])})):
        g = torch.Generator().manual_seed(3)
        out["kpp"][name] = fn(xt, K, g, return_index=True, **kw)[1]
    for name, fn, args, cfg in (
            ("kmeans", fit_kmeans, (x,), data["cfg_km"]),
            ("kmeans_k", fit_kmeans, (x,), data["cfg"]),
            ("sskm", fit_sskm, (x[~mask], x[mask], y[mask]), data["cfg"]),
            ("from_labels", fit_kmeans_from_labels,
             (x, data["init_labels"]), data["cfg"])):
        res = fn(*args, cfg, device="cpu")
        out[name] = (res.labels, res.centers, res.inertia, res.n_iter)
    vals, idx = classify_topk(torch.from_numpy(data["feats"]),
                              torch.from_numpy(data["zw"]), TOPK)
    out["topk"] = (vals.numpy(), idx.numpy())
    import importlib

    # the one-process results of _refusals' estimate_k calls
    ek = importlib.import_module("scd_tpu_torch.cluster.estimate_k")
    x40, y40 = x[:40], y[:40]
    out["estimate_k"] = ek.estimate_k(x40, y40, np.ones(40, bool), 2, 8,
                                      device="cpu")
    out["fit_kmeans_dynamic_k"] = ek.fit_kmeans_dynamic_k(
        torch.Generator().manual_seed(0), x40, 2, 8, device="cpu")
    # and of the four trainers _refusals runs at data 1 x model 2
    from scd_tpu_torch.testing.mesh_cases import tiny_trainers

    out["tiny_trainers"] = tiny_trainers(None, heads=2)
    return out


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device mesh (virtual CPU or multi-chip)")
    return jmake_mesh(JMeshConfig(data=8, model=1))


def _same_on_every_rank(results, key):
    first = results[0][key]
    for other in results[1:]:
        for a, b in zip(first, other[key]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("world", WORLDS)
def test_rows_from_process_local_contracts(worlds, world):
    """Exact: even shares give (local, n_global), uneven shares raise.
    Ragged: each share pads to the widest, the global mask marks the pads
    at the end of each rank's block, identical on every rank."""
    width = 3 + world - 1
    want_valid = np.concatenate([[True] * (3 + r) + [False] * (width - 3 - r)
                                 for r in range(world)]).tolist()
    want_rows = np.concatenate([
        np.concatenate([np.arange(3 + r) + 10 * r, np.zeros(width - 3 - r)])
        for r in range(world)]).tolist()
    for rank in worlds[world]:
        rows = rank["rows"]
        assert rows["exact_n"] == 4 * world
        assert rows["exact_shape"] == (4, 2)
        assert rows["exact_uneven"] == "ValueError"
        assert rows["ragged_width"] == width
        assert rows["ragged_valid"] == want_valid
        assert rows["ragged_rows"] == want_rows


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("seeder", ["kpp", "kpp_local_trials", "kpp_pre"])
def test_kpp_draws_match_single_process(worlds, single, world, seeder):
    """The distributed draws pick the single-process draws' global rows
    from the same generator seed (-1: a pinned center)."""
    for rank in worlds[world]:
        assert rank["kpp"][seeder] == single["kpp"][seeder]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fit", ["kmeans", "kmeans_k", "sskm",
                                 "from_labels"])
def test_fitters_match_single_process(worlds, single, world, fit):
    """Same seed, same labels; centers and inertia to the float order of
    the merged per-rank sums; every rank holds the same result."""
    results = worlds[world]
    _same_on_every_rank(results, fit)
    labels, centers, inertia, n_iter = results[0][fit]
    s_labels, s_centers, s_inertia, s_iter = single[fit]
    np.testing.assert_array_equal(labels, s_labels)
    np.testing.assert_allclose(centers, s_centers, rtol=1e-5, atol=1e-5)
    assert inertia == pytest.approx(s_inertia, rel=1e-5)
    assert n_iter == s_iter


@pytest.mark.parametrize("world", WORLDS)
def test_em_iteration_sharded_matches_jax_mesh(worlds, data, jax_mesh,
                                               world):
    """One EM iteration over the ranks against the JAX package's
    ``em_iteration_sharded`` on its 8-device mesh (the fused Pallas kernel
    per shard in interpret mode, one psum): labels equal, the merged sums
    and counts and the inertia within f32 summation order."""
    import jax.numpy as jnp

    from scd_tpu.core.mesh import pad_rows
    from scd_tpu.ops.em import em_iteration_sharded as jem

    x, n = pad_rows(data["x"], 8)
    row_w = (np.arange(len(x)) < n).astype(np.float32)
    jl, js, jc, ji = jem(jnp.asarray(x), jnp.asarray(data["centers"]),
                         jnp.asarray(row_w), jax_mesh)
    _same_on_every_rank(worlds[world], "em")
    labels, sums, counts, inertia = worlds[world][0]["em"]
    np.testing.assert_array_equal(labels, np.asarray(jl)[:n])
    np.testing.assert_array_equal(counts, np.asarray(jc))
    np.testing.assert_allclose(sums, np.asarray(js), rtol=1e-5, atol=1e-3)
    assert inertia == pytest.approx(float(ji), rel=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_classify_topk_sharded_matches_jax_and_single(worlds, data, single,
                                                      world):
    """V 72 split over the ranks' model axis against the JAX package's
    ``classify_topk_sharded`` over 8 vocabulary shards and against the
    single-process port: indices equal; softmax values within 1e-6 of the
    single-process port's and 1e-5 of JAX's (XLA's dot and log-sum-exp
    sum in another order: ~1e-8 relative on logits of ~100, which the
    exponential turns into ~2e-6 on values near 1); the raw logits
    (apply_softmax=False) within 1e-4 of JAX's."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device mesh (virtual CPU or multi-chip)")
    from scd_tpu.ops.topk import classify_topk_sharded as jtopk

    vmesh = jmake_mesh(JMeshConfig(data=1, model=8))
    jv, ji = jtopk(data["feats"], data["zw"], TOPK, vmesh)
    jraw, _ = jtopk(data["feats"], data["zw"], TOPK, vmesh,
                    apply_softmax=False)
    _same_on_every_rank(worlds[world], "topk")
    vals, idx, raw = worlds[world][0]["topk"]
    np.testing.assert_array_equal(idx, np.asarray(ji))
    np.testing.assert_allclose(vals, np.asarray(jv), atol=1e-5, rtol=0)
    np.testing.assert_allclose(raw, np.asarray(jraw), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(idx, single["topk"][1])
    np.testing.assert_allclose(vals, single["topk"][0], atol=1e-6, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_lloyd_from_the_same_centers_matches_jax_mesh(worlds, data,
                                                      jax_mesh, world):
    """The Lloyd loop over the ranks from the label centroids (no draws)
    against the JAX package's mesh fit from the same labels."""
    from scd_tpu.cluster import fit_kmeans_from_labels as jfit

    cfg = data["cfg"]
    want = jfit(data["x"], data["init_labels"],
                JClusterConfig(n_clusters=cfg.n_clusters,
                               max_iterations=cfg.max_iterations),
                mesh=jax_mesh)
    labels, centers, inertia, n_iter = worlds[world][0]["from_labels"]
    np.testing.assert_array_equal(labels, want.labels)
    np.testing.assert_allclose(centers, want.centers, rtol=1e-4, atol=1e-4)
    assert inertia == pytest.approx(want.inertia, rel=1e-4)
    assert n_iter == want.n_iter


@pytest.fixture(scope="module")
def jax_runs(data, jax_mesh):
    from scd_tpu.cluster import fit_kmeans as jkm
    from scd_tpu.cluster import fit_sskm as jsskm

    x, y, mask = data["x_sep"], data["y_sep"], data["mask_sep"]
    cfg = JClusterConfig(**{f.name: getattr(data["cfg"], f.name)
                            for f in dataclasses.fields(data["cfg"])
                            if hasattr(JClusterConfig, f.name)})
    key = jax.random.PRNGKey(0)
    return {"kmeans_sep": jkm(key, x, cfg, mesh=jax_mesh).labels,
            "sskm_sep": jsskm(key, x[~mask], x[mask], y[mask], cfg,
                              mesh=jax_mesh).labels}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fit", ["kmeans_sep", "sskm_sep"])
def test_whole_runs_match_jax_mesh_by_ari_and_acc(worlds, data, jax_runs,
                                                  world, fit):
    """Whole KM and SSKM runs on separated blobs (each package's own
    seeds) against the JAX package's mesh runs: the partitions agree
    (ARI) and so does ACC."""
    y = data["y_sep"]
    if fit == "sskm_sep":
        mask = data["mask_sep"]
        y = np.concatenate([y[mask], y[~mask]])
    for rank in worlds[world][1:]:
        np.testing.assert_array_equal(rank[fit], worlds[world][0][fit])
    labels = worlds[world][0][fit]
    assert ari(jax_runs[fit], labels) > 0.99
    assert cluster_acc(y, labels) == pytest.approx(
        cluster_acc(y, jax_runs[fit]), abs=0.01)


@pytest.mark.parametrize("path", [
    "fit_constrained", "estimate_k", "fit_kmeans_dynamic_k",
    "make_gcd_state", "GCDTrainer", "train_uno_e2e", "train_autonovel_e2e"])
def test_not_ported_paths_refuse_a_mesh_of_two(worlds, single, path):
    """The paths that refused a mesh of two ranks before they were ported
    over ranks, each with what it gives now: the four trainers under a
    mesh of ``data`` 1 x ``model`` 2 train tensor-parallel (one GCD
    step's loss and each e2e trainer's epoch loss equal on both ranks
    and within LOSS_RTOL / 2e-4 of one process; each rank holds half the
    tensor-parallel bytes); ConSSKM's exact MCF backend over
    the ``data`` axis raises the JAX package's RuntimeError; estimate_k
    and the dynamic-K fit over it return the one-process result (labels
    equal, inertia within 1e-5 relative: per-rank sums merged)."""
    for rank in worlds[2]:
        kind, got = rank["refusals"][path]
        if path == "fit_constrained":
            assert kind == "RuntimeError"
            assert got.startswith("multi-controller fit_constrained supports "
                                  "only the sinkhorn backend")
        elif path == "estimate_k":
            assert kind == ""
            assert got[0] == single[path][0]
            assert got[1] == pytest.approx(single[path][1], abs=1e-6)
        elif path == "fit_kmeans_dynamic_k":
            assert kind == ""
            np.testing.assert_array_equal(got[0], single[path][0])
            assert got[1] == pytest.approx(single[path][1], rel=1e-5)
        else:
            assert kind == "", got
            assert got == worlds[2][0]["refusals"][path][1]
            want = single["tiny_trainers"][path]
            if path == "GCDTrainer":
                assert 2 * got == want
            else:
                assert got == pytest.approx(want, rel=TP_RTOL[path])


@pytest.mark.parametrize("n,m", [(0, 4), (1, 4), (8, 4), (13, 3), (401, 8)])
def test_pad_helpers_equal_jax(n, m):
    """``core.mesh.pad_to_multiple`` / ``pad_rows`` (no process group
    needed) equal the JAX package's."""
    from scd_tpu.core import mesh as jmesh
    from scd_tpu_torch.core import mesh as tmesh

    assert tmesh.pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2) + 1
    got, got_n = tmesh.pad_rows(x, m, fill=-1.0)
    want, want_n = jmesh.pad_rows(x, m, fill=-1.0)
    assert got_n == want_n
    np.testing.assert_array_equal(got, want)


def test_masked_min_sum_takes_a_count_or_a_mask():
    """A prefix count and its mask give the JAX package's sum; a mask with
    pads inside (the ragged layout) sums the rows it marks."""
    import jax.numpy as jnp

    from scd_tpu.ops.distance import masked_min_sum as jsum
    from scd_tpu_torch.ops.distance import masked_min_sum as tsum

    d = np.random.default_rng(0).random(37).astype(np.float32)
    want = float(jsum(jnp.asarray(d), 30))
    assert float(tsum(torch.from_numpy(d), 30)) == pytest.approx(want,
                                                                 rel=1e-6)
    prefix = np.arange(37) < 30
    assert float(tsum(torch.from_numpy(d), prefix)) == pytest.approx(
        want, rel=1e-6)
    ragged = np.tile([True, True, False], 13)[:37]
    assert float(tsum(torch.from_numpy(d), torch.from_numpy(ragged))) == \
        pytest.approx(float(d[ragged].sum()), rel=1e-6)
