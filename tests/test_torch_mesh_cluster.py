"""ConSSKM, the Sinkhorn assignment and estimate_k over 2 and 3 gloo ranks
on the CPU.

Each world runs ``scd_tpu_torch.testing.mesh_cases.cluster_cases`` once
(``testing/dist.py::spawn``: fresh interpreters that import the port
only, both worlds started together beside the JAX side's compiles).  Two
ranks split the unlabelled rows evenly; three leave ragged shares, so the
pads, their sentinel label and their masks are exercised.

Parity contract, with the tolerances' reasons:
- ``sinkhorn_constrained_assign(row_mask=)`` against the JAX function in
  process, on the same masked cost: labels equal, pad rows labelled k,
  duals within DUAL_ATOL (the dual loop's f32 sums in another order);
- the same assignment over the ranks, each an equal block of the padded
  cost, against the single-process port: labels equal, duals within
  DUAL_ATOL (the column log-sum-exp merges per-rank sums: another f32
  order), the feasibility flag equal;
- ``fit_constrained`` over two ranks (even shares) and ``run_clustering``
  with ConSSKM against one process: labels equal, inertia within
  INERTIA_RTOL (the merged M-step sums add per-rank partial sums); over
  three ranks (ragged shares), as ``tests/test_multichip_cluster.py:49``
  holds the JAX mesh run: every size within the bounds, the pads removed,
  NMI > 0.9 against the classes;
- the exact MCF backend and an infeasible Sinkhorn result raise over the
  ranks the JAX package's RuntimeError;
- ``estimate_k(mesh=)`` on ``tests/test_finch_estimate_k.py:165``'s blobs:
  the same K as the single-process port and as the JAX package's mesh run
  on its 8 virtual devices, the objective within 1e-6 (that test's own
  contract); ``fit_kmeans_dynamic_k`` the same partition (ARI 1) and
  inertia within 1e-5 relative;
- every rank returns the same results.
"""

import dataclasses
import importlib
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs
from sklearn.metrics import adjusted_rand_score as ari
from sklearn.metrics import normalized_mutual_info_score as nmi

from scd_tpu_torch.core.config import (ClusterConfig, DataConfig,
                                       MeshConfig, PipelineConfig)
from scd_tpu_torch.testing.dist import spawn

DUAL_ATOL, INERTIA_RTOL = 1e-5, 1e-5
WORLDS = (2, 3)


def _blobs(n, d, centers, seed, std=1.0):
    """``tests/conftest.py::make_blobs`` (centers in a box of +-10)."""
    x, y = make_blobs(n_samples=n, n_features=d, centers=centers,
                      cluster_std=std, center_box=(-10.0, 10.0),
                      shuffle=True, random_state=seed)
    return x.astype(np.float32), y


def _fit_spec(x, y, mask, **cfg):
    return {"x_u": x[~mask], "x_l": x[mask], "y_l": y[mask],
            "cfg": ClusterConfig(**cfg)}


def _constrained_data():
    """``tests/test_multichip_cluster.py:49``'s blobs and bounds (ragged:
    701 unlabelled rows), and 700 of them (even over two ranks); one
    restart of four Lloyd iterations."""
    x, y = _blobs(803, 16, 8, 6)
    mask = (y < 4) & (np.arange(len(y)) % 4 == 0)
    n_u = int((~mask).sum())
    kw = dict(n_clusters=8, n_init=1, max_iterations=4,
              size_min=n_u // 8 - 30, size_max=n_u // 8 + 40,
              constrained_backend="sinkhorn")
    ragged = _fit_spec(x, y, mask, **kw)
    keep = np.ones(len(y), bool)
    keep[np.flatnonzero(~mask)[-1]] = False  # 700 unlabelled rows
    even = _fit_spec(x[keep], y[keep], mask[keep], **kw)
    return even, ragged, (x[keep], y[keep], mask[keep], kw)


def _sinkhorn_data():
    """A cost of unit-norm distances [606, 10] from blobs, six pad rows
    (masked) spread over the rows; loose bounds."""
    x, _ = _blobs(606, 8, 10, 2)
    c = x[np.random.default_rng(0).choice(606, 10, replace=False)]
    cost = np.sqrt(((x[:, None] - c[None]) ** 2).sum(-1) / 100.0
                   ).astype(np.float32)
    mask = np.ones(606, bool)
    mask[[0, 101, 202, 303, 404, 605]] = False
    return cost, mask, 10, 30, 100, 0.05


def _estimate_k_data():
    x, y = _blobs(401, 16, 8, 3)
    return {"x": x, "y": y, "mask_lab": y < 4, "min_k": 4, "max_k": 16,
            "method": "binary", "k_fit": 8}


def _infeasible_data():
    """One blob of 600 rows and seven of 10 under bounds [82, 83]: one
    Sinkhorn iteration and the repair passes leave it infeasible (the
    single process goes on to the exact track)."""
    x, y = make_blobs(n_samples=[600] + [10] * 7, n_features=16,
                      cluster_std=0.5, center_box=(-10.0, 10.0),
                      shuffle=True, random_state=6)
    x = x.astype(np.float32)
    mask = (y == 1) & (np.arange(len(y)) % 2 == 0)
    return _fit_spec(x, y, mask, n_clusters=8, n_init=1, max_iterations=1,
                     size_min=82, size_max=83, sinkhorn_iters=1)


@pytest.fixture(scope="module")
def data():
    even, ragged, (xe, ye, me, kw) = _constrained_data()
    feats = {"all_feats": xe, "targets": ye, "mask_lab": me,
             "mask_cls": ye < 4}
    pipeline_cfg = PipelineConfig(
        data=DataConfig(dataset_name="synthetic"),
        cluster=ClusterConfig(algorithm="ConSSKM", **kw),
        mesh=MeshConfig(data=0, model=1))
    base = {"pipeline_cfg": pipeline_cfg, "feats": feats,
            "sinkhorn": _sinkhorn_data(), "estimate_k": _estimate_k_data(),
            "mcf": dict(even, cfg=dataclasses.replace(
                even["cfg"], constrained_backend="mcf")),
            "infeasible": _infeasible_data()}
    return {2: dict(base, fits={"even": even}),
            3: dict(base, fits={"ragged": ragged})}


@pytest.fixture(scope="module")
def runs(data):
    """Both worlds (started together) and, while they run, the JAX
    package's estimate_k on its 8-device mesh and the single-process
    port."""
    from scd_tpu.core.config import MeshConfig as JMeshConfig
    from scd_tpu.core.mesh import make_mesh as jmake_mesh
    from scd_tpu_torch.cluster.constrained import fit_constrained
    from scd_tpu_torch.pipelines.common import run_clustering
    from scd_tpu_torch.testing import mesh_cases

    jek = importlib.import_module("scd_tpu.cluster.estimate_k")
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        worlds = {w: pool.submit(
            spawn, "scd_tpu_torch.testing.mesh_cases.cluster_cases",
            world=w, args=(data[w],), timeout=90, collective_timeout=75)
            for w in WORLDS}
        e = data[2]["estimate_k"]
        jax_mesh = jek.estimate_k(
            e["x"], e["y"], e["mask_lab"], e["min_k"], e["max_k"],
            method="binary", dynamic_k=True,
            mesh=jmake_mesh(JMeshConfig(data=8, model=1)))
        even = data[2]["fits"]["even"]
        single = {
            "even": fit_constrained(even["x_u"], even["x_l"], even["y_l"],
                                    even["cfg"], device="cpu"),
            "run_clustering": run_clustering(
                data[2]["pipeline_cfg"], data[2]["feats"],
                device="cpu")["u_preds"],
            "sinkhorn": mesh_cases.sinkhorn_rows(*data[2]["sinkhorn"]),
            "estimate_k": mesh_cases.estimate_k_search(e)}
        return {"worlds": {w: f.result() for w, f in worlds.items()},
                "jax_mesh": jax_mesh, "single": single}


def test_sinkhorn_row_mask_matches_jax():
    from scd_tpu.ops.sinkhorn import sinkhorn_constrained_assign as jfn
    from scd_tpu_torch.ops.sinkhorn import sinkhorn_constrained_assign as tfn

    cost, mask, k, lo, hi, eps = _sinkhorn_data()
    want = jfn(jnp.asarray(cost), k, lo, hi, eps=eps,
               row_mask=jnp.asarray(mask))
    got = tfn(torch.as_tensor(cost), k, lo, hi, eps=eps,
              row_mask=torch.as_tensor(mask))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    assert (got.labels.numpy()[~mask] == k).all()
    np.testing.assert_allclose(got.col_duals.numpy(),
                               np.asarray(want.col_duals), rtol=0,
                               atol=DUAL_ATOL)
    assert got.feasible == bool(want.feasible)
    sizes = np.bincount(got.labels.numpy()[mask], minlength=k)
    assert sizes.min() >= lo and sizes.max() <= hi


@pytest.mark.parametrize("world", WORLDS)
def test_sinkhorn_over_ranks_matches_single_process(runs, world):
    ranks, want = runs["worlds"][world], runs["single"]["sinkhorn"]
    for rank in ranks:
        got = rank["sinkhorn"]
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_allclose(got["duals"], want["duals"], rtol=0,
                                   atol=DUAL_ATOL)
        assert got["feasible"] == want["feasible"]
        np.testing.assert_array_equal(got["duals"], ranks[0]["sinkhorn"][
            "duals"])


def test_consskm_even_shares_match_single_process(runs):
    want = runs["single"]["even"]
    for rank in runs["worlds"][2]:
        got = rank["even"]
        np.testing.assert_array_equal(got["labels"], want.labels)
        assert got["inertia"] == pytest.approx(want.inertia,
                                               rel=INERTIA_RTOL)
        assert got["counters"]["mcf_fallbacks"] == 0
        np.testing.assert_array_equal(got["labels"],
                                      runs["worlds"][2][0]["even"]["labels"])
        assert got["inertia"] == runs["worlds"][2][0]["even"]["inertia"]


def test_consskm_ragged_shares_respect_sizes(data, runs):
    spec = data[3]["fits"]["ragged"]
    cfg, n_l = spec["cfg"], len(spec["y_l"])
    n_u = len(spec["x_u"])
    y_u = _blobs(803, 16, 8, 6)[1]
    mask = (y_u < 4) & (np.arange(len(y_u)) % 4 == 0)
    for rank in runs["worlds"][3]:
        u = rank["ragged"]["labels"][n_l:]
        assert len(u) == n_u  # the pads removed
        sizes = np.bincount(u, minlength=cfg.n_clusters)
        assert sizes.sum() == n_u
        assert sizes.min() >= cfg.size_min and sizes.max() <= cfg.size_max
        assert nmi(y_u[~mask], u) > 0.9
        np.testing.assert_array_equal(
            rank["ragged"]["labels"], runs["worlds"][3][0]["ragged"]["labels"])


@pytest.mark.parametrize("world", WORLDS)
def test_run_clustering_consskm_over_ranks(data, runs, world):
    cfg = data[world]["pipeline_cfg"].cluster
    want = runs["single"]["run_clustering"]
    for rank in runs["worlds"][world]:
        got = rank["run_clustering"]
        sizes = np.bincount(got, minlength=cfg.n_clusters)
        assert sizes.min() >= cfg.size_min and sizes.max() <= cfg.size_max
        if world == 2:  # even shares: the single process's labels
            np.testing.assert_array_equal(got, want)
        else:
            assert nmi(want, got) > 0.9


@pytest.mark.parametrize("world", WORLDS)
def test_mcf_and_infeasible_raise_over_ranks(runs, world):
    for rank in runs["worlds"][world]:
        kind, msg = rank["mcf"]
        assert kind == "RuntimeError"
        assert msg.startswith("multi-controller fit_constrained supports "
                              "only the sinkhorn backend")
        kind, msg = rank["infeasible"]
        assert kind == "RuntimeError"
        assert msg.startswith("constrained sinkhorn E-step infeasible "
                              "under multi-controller execution")


def test_infeasible_goes_on_to_mcf_in_one_process(data):
    from scd_tpu_torch.cluster.constrained import fit_constrained

    spec = data[2]["infeasible"]
    before = fit_constrained.mcf_fallbacks
    res = fit_constrained(spec["x_u"], spec["x_l"], spec["y_l"],
                          spec["cfg"], device="cpu")
    assert fit_constrained.mcf_fallbacks == before + 1
    sizes = np.bincount(res.labels[len(spec["y_l"]):], minlength=8)
    assert sizes.min() >= 82 and sizes.max() <= 83


@pytest.mark.parametrize("world", WORLDS)
def test_estimate_k_over_ranks_matches_single_and_jax_mesh(runs, world):
    single = runs["single"]["estimate_k"]
    jk, jacc = runs["jax_mesh"]
    for rank in runs["worlds"][world]:
        got = rank["estimate_k"]
        assert got["best"][0] == single["best"][0] == jk
        assert got["best"][1] == pytest.approx(single["best"][1], abs=1e-6)
        assert got["best"][1] == pytest.approx(jacc, abs=1e-6)
        labels, inertia = got["dynamic_k"]
        # the same partition; restarts that end on it tie in inertia to
        # rounding, so which one is kept (and so the cluster ids) may differ
        assert ari(labels, single["dynamic_k"][0]) == 1.0
        assert inertia == pytest.approx(single["dynamic_k"][1], rel=1e-5)
        assert labels.max() < 8  # the sentinel slots never win
