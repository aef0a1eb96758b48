"""Constrained clustering (ConSSKM) of the port against the JAX package, on
the CPU.

- The Sinkhorn E-step's repair passes and ranking: equal labels from the
  same labels, cost and duals.
- The whole Sinkhorn assignment on the same cost matrices: the same
  ``feasible``, column duals within 1e-4 of the cost's std, equal labels
  outside the tie band (best and second-best reduced cost closer than
  1e-3 in the normalized cost), total cost within 1e-5 relative.
- The min-cost-flow bridge: equal labels and flows through both bridges,
  the same ``ValueError`` on infeasible bounds, a byte-equal solver
  source, and ``native/libscdmcf.so`` left as it was.
- The Lloyd loops of both tracks from shared initial centers (both
  packages' ``_seed_centers`` patched): the MCF track's rounded costs
  differ by at most 1 on at most 0.1% of entries (the JAX product and the
  port's f32 product differ in their last bits), labels are equal on at
  least 99.5% of rows, inertia within 1e-4 relative, iteration counts
  within one; the Sinkhorn track is feasible in both and ARI >= 0.99.
- Whole fits on blobs, both tracks: ARI >= 0.99 against the JAX package,
  sizes within bounds, the same ``ValueError``s.
- k-means++ with local trials: pins kept, no duplicate centers, a lower
  mean potential than simple k-means++ over seeds.
"""

import os

import numpy as np
import pytest
import torch
from sklearn.metrics import adjusted_rand_score

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cost(seed, n, k, d=16):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    return np.sqrt(((x[:, None] - c[None]) ** 2).sum(-1)).astype(np.float32)


# ---------------------------------------------------------------- Sinkhorn

@pytest.mark.parametrize("k", [3, 9])
@pytest.mark.parametrize("with_inf", [False, True])
def test_within_cluster_rank_matches_jax(with_inf, k):
    import jax
    import jax.numpy as jnp

    from scd_tpu.ops import sinkhorn as J
    from scd_tpu_torch.ops import sinkhorn as T

    rng = np.random.default_rng(3)
    labels = rng.integers(0, k, 700)
    # repeated keys exercise the stable sort
    key = rng.choice(rng.standard_normal(150), 700).astype(np.float32)
    if with_inf:
        key[rng.random(700) < 0.2] = np.inf
    # jitted: one compile instead of one per primitive
    want = jax.jit(J._within_cluster_rank, static_argnums=2)(
        jnp.asarray(labels, jnp.int32), jnp.asarray(key), k)
    got = T._within_cluster_rank(torch.as_tensor(labels),
                                 torch.as_tensor(key), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("which", ["evict", "steal"])
def test_repair_passes_match_jax(which):
    import jax
    import jax.numpy as jnp

    from scd_tpu.ops import sinkhorn as J
    from scd_tpu_torch.ops import sinkhorn as T

    rng = np.random.default_rng(5)
    n, k = 900, 12
    cost = _cost(5, n, k)
    g = (0.05 * rng.standard_normal(k)).astype(np.float32)
    # a skewed start: clusters 0-3 overfull, the rest short
    labels = np.where(rng.random(n) < 0.6, rng.integers(0, 4, n),
                      rng.integers(0, k, n))
    size_min, size_max = 60, 90
    jfn = jax.jit(getattr(J, f"_{which}_pass"), static_argnums=(3, 4, 5))
    tfn = getattr(T, f"_{which}_pass")
    want = jfn(jnp.asarray(cost), jnp.asarray(labels, jnp.int32),
               jnp.asarray(g), size_min, size_max, k)
    got = tfn(torch.as_tensor(cost), torch.as_tensor(labels),
              torch.as_tensor(g), size_min, size_max, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != labels).sum() > 10  # the pass moved rows


@pytest.mark.parametrize("n,k,size_min,size_max", [
    (500, 10, 10, 200),     # loose bounds
    (2_000, 20, 20, 400),   # loose bounds
    (1_000, 10, 95, 105),   # forced rebalancing
    (1_600, 16, 90, 110),   # forced rebalancing
])
def test_sinkhorn_assign_matches_jax(n, k, size_min, size_max):
    import jax.numpy as jnp

    from scd_tpu.ops.sinkhorn import sinkhorn_constrained_assign as jfn
    from scd_tpu_torch.ops.sinkhorn import sinkhorn_constrained_assign as tfn

    cost = _cost(n + k, n, k)
    want = jfn(jnp.asarray(cost), k, size_min, size_max, eps=0.01)
    got = tfn(torch.as_tensor(cost), k, size_min, size_max, eps=0.01)
    assert got.feasible == bool(want.feasible)
    std = float(cost.std())
    np.testing.assert_allclose(got.col_duals.numpy(),
                               np.asarray(want.col_duals), rtol=0,
                               atol=1e-4 * std)
    red = np.sort((cost - np.asarray(want.col_duals)[None]) / std, axis=1)
    outside = red[:, 1] - red[:, 0] >= 1e-3
    jl, tl = np.asarray(want.labels), got.labels.numpy()
    np.testing.assert_array_equal(tl[outside], jl[outside])
    rows = np.arange(n)
    jc, tc = cost[rows, jl].sum(), cost[rows, tl].sum()
    assert abs(tc - jc) <= 1e-5 * jc
    counts = np.bincount(tl, minlength=k)
    assert got.feasible and counts.min() >= size_min \
        and counts.max() <= size_max


# ---------------------------------------------------------------- MCF bridge

@pytest.mark.parametrize("n,k,lo,hi", [(400, 8, 30, 70),
                                        (1_500, 12, 120, 130)])
@pytest.mark.parametrize("method", ["auto", "ssp", "cost_scaling", "sparse"])
def test_constrained_assign_matches_jax_bridge(method, n, k, lo, hi):
    from scd_tpu.ops import native as J
    from scd_tpu_torch.ops import native as T

    rng = np.random.default_rng(n)
    costs = rng.integers(0, 2_000, (n, k)).astype(np.int32)
    want = J.constrained_assign(costs, lo, hi, method=method)
    got = T.constrained_assign(costs, lo, hi, method=method)
    np.testing.assert_array_equal(got, want)
    counts = np.bincount(got, minlength=k)
    assert counts.min() >= lo and counts.max() <= hi


def test_mcf_bridge_flows_errors_and_files():
    from scd_tpu.ops import native as J
    from scd_tpu_torch.ops import build
    from scd_tpu_torch.ops import native as T

    # the JAX bridge rebuilds native/libscdmcf.so in place when it is
    # older than its source: let it do so, and the port build its own
    # library, before the window the port's calls are watched in
    J._load()
    T._load()
    lib = os.path.join(ROOT, "native", "libscdmcf.so")
    with open(os.path.join(ROOT, "native", "mincostflow.cc"), "rb") as f:
        ref = f.read()
    with open(os.path.join(ROOT, "scd_tpu_torch", "csrc", "mincostflow.cc"),
              "rb") as f:
        assert f.read() == ref
    # a random transport problem: 6 sources -> 5 sinks through all arcs
    rng = np.random.default_rng(2)
    tail = np.repeat(np.arange(6), 5)
    head = 6 + np.tile(np.arange(5), 6)
    cap = rng.integers(1, 9, 30)
    cost = rng.integers(-20, 50, 30)
    supply = np.concatenate([np.full(6, 5), np.full(5, -6)])
    costs = rng.integers(0, 100, (50, 4)).astype(np.int32)
    before = os.path.getmtime(lib) if os.path.exists(lib) else None
    got = [T.mcf_solve(tail, head, cap, cost, supply, method=method)
           for method in ("ssp", "cost_scaling")]
    with pytest.raises(ValueError, match="infeasible size constraints"):
        T.constrained_assign(costs, 20, 30)
    T.constrained_assign(costs, 10, 15)
    after = os.path.getmtime(lib) if os.path.exists(lib) else None
    assert after == before
    want = [J.mcf_solve(tail, head, cap, cost, supply, method=method)
            for method in ("ssp", "cost_scaling")]
    with pytest.raises(ValueError, match="infeasible size constraints"):
        J.constrained_assign(costs, 20, 30)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    path = build.library_path("mincostflow")
    assert T._load()._name == path
    assert path.startswith(build.build_dir()) and os.path.exists(path)


# ---------------------------------------------------- Lloyd loops, shared init

def _blob_features(seed, n, d, k, noise=0.6):
    rng = np.random.default_rng(seed)
    means = 2.0 * rng.standard_normal((k, d))
    y = rng.integers(0, k, n)
    x = means[y] + noise * rng.standard_normal((n, d))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32), y


@pytest.fixture
def patch_seeds(monkeypatch):
    """Both packages' ``_seed_centers`` return the given centers.  The
    jitted JAX Sinkhorn fit keeps the seeding it was traced with, so its
    caches are cleared before (an earlier trace) and after (this one)."""
    import jax
    import jax.numpy as jnp

    from scd_tpu.cluster import constrained as J
    from scd_tpu_torch.cluster import constrained as T

    def patch(centers):
        jax.clear_caches()
        monkeypatch.setattr(J, "_seed_centers",
                            lambda *a, **kw: jnp.asarray(centers))
        monkeypatch.setattr(T, "_seed_centers",
                            lambda *a, **kw: torch.as_tensor(centers))

    yield patch
    jax.clear_caches()


@pytest.mark.parametrize("backend", ["mcf", "sinkhorn"])
def test_lloyd_loops_from_shared_centers(patch_seeds, backend):
    import jax
    import jax.numpy as jnp

    from scd_tpu.cluster import constrained as J
    from scd_tpu.core.config import ClusterConfig as JC
    from scd_tpu_torch.cluster import constrained as T
    from scd_tpu_torch.core.config import ClusterConfig as TC
    from scd_tpu_torch.ops.distance import pairwise_sqdist

    k = 8
    x, y = _blob_features(7, 1_200, 24, k)
    lab = y < 3
    lab &= np.random.default_rng(1).random(len(y)) < 0.5
    u, l, lt = x[~lab], x[lab], y[lab]
    rng = np.random.default_rng(9)
    centers = u[rng.choice(len(u), k, replace=False)]
    kw = dict(n_clusters=k, n_init=1, max_iterations=8, size_min=60,
              size_max=200, constrained_backend=backend)
    patch_seeds(centers)
    want = J.fit_constrained(jax.random.PRNGKey(0), u, l, lt, JC(**kw))
    got = T.fit_constrained(u, l, lt, TC(**kw), device="cpu")
    n_l = int(lab.sum())
    np.testing.assert_array_equal(got.labels[:n_l], want.labels[:n_l])
    ju, tu = want.labels[n_l:], got.labels[n_l:]
    for lb in (ju, tu):
        counts = np.bincount(lb, minlength=k)
        assert counts.min() >= 60 and counts.max() <= 200
    if backend == "mcf":
        _d, jcost = J._mcf_initial_costs(jnp.asarray(u), jnp.asarray(centers))
        tcost = T._costs(pairwise_sqdist(torch.as_tensor(u),
                                         torch.as_tensor(centers))).numpy()
        diff = np.abs(tcost.astype(np.int64) - np.asarray(jcost))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
        assert (ju == tu).mean() >= 0.995
        assert abs(got.inertia - want.inertia) <= 1e-4 * abs(want.inertia)
        assert abs(got.n_iter - want.n_iter) <= 1
    else:
        assert adjusted_rand_score(ju, tu) >= 0.99


# ---------------------------------------------------------------- whole fits

@pytest.mark.parametrize("backend", ["sinkhorn", "mcf"])
def test_fit_constrained_blobs_match_jax(backend):
    import jax

    from scd_tpu.cluster.constrained import fit_constrained as jfit
    from scd_tpu.cluster.constrained import fit_constrained_unsup as jfit_u
    from scd_tpu.core.config import ClusterConfig as JC
    from scd_tpu_torch.cluster.constrained import fit_constrained as tfit
    from scd_tpu_torch.cluster.constrained import \
        fit_constrained_unsup as tfit_u
    from scd_tpu_torch.core.config import ClusterConfig as TC

    k = 6
    x, y = _blob_features(21, 900, 16, k, noise=0.3)
    lab = (y < 2) & (np.random.default_rng(0).random(len(y)) < 0.5)
    u, l, lt = x[~lab], x[lab], y[lab]
    kw = dict(n_clusters=k, n_init=2, max_iterations=10, size_min=40,
              size_max=300, constrained_backend=backend, kpp_local_trials=-1)
    want = jfit(jax.random.PRNGKey(0), u, l, lt, JC(**kw))
    got = tfit(u, l, lt, TC(**kw), device="cpu")
    n_l = int(lab.sum())
    np.testing.assert_array_equal(got.labels[:n_l], want.labels[:n_l])
    assert adjusted_rand_score(want.labels[n_l:], got.labels[n_l:]) >= 0.99
    counts = np.bincount(got.labels[n_l:], minlength=k)
    assert counts.min() >= 40 and counts.max() <= 300

    kw.update(size_min=100, size_max=200)
    want = jfit_u(jax.random.PRNGKey(0), x, JC(**kw))
    got = tfit_u(x, TC(**kw), device="cpu")
    assert adjusted_rand_score(want.labels, got.labels) >= 0.99
    counts = np.bincount(got.labels, minlength=k)
    assert counts.min() >= 100 and counts.max() <= 200


def test_fit_constrained_errors_match_jax():
    import jax

    from scd_tpu.cluster.constrained import fit_constrained as jfit
    from scd_tpu.cluster.constrained import fit_constrained_unsup as jfit_u
    from scd_tpu.core.config import ClusterConfig as JC
    from scd_tpu_torch.cluster.constrained import fit_constrained as tfit
    from scd_tpu_torch.cluster.constrained import \
        fit_constrained_unsup as tfit_u
    from scd_tpu_torch.core.config import ClusterConfig as TC

    x, y = _blob_features(4, 200, 8, 4)
    key = jax.random.PRNGKey(0)
    for kw, args in ((dict(n_clusters=2), (x[:100], x[100:], y[100:])),
                     (dict(n_clusters=4, size_min=30, size_max=40),
                      (x[:100], x[100:150], y[100:150] % 2))):
        with pytest.raises(ValueError) as je:
            jfit(key, *args, JC(**kw))
        with pytest.raises(ValueError) as te:
            tfit(*args, TC(**kw), device="cpu")
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as je:
        jfit_u(key, x, JC(n_clusters=4, size_min=60))
    with pytest.raises(ValueError) as te:
        tfit_u(x, TC(n_clusters=4, size_min=60), device="cpu")
    assert str(te.value) == str(je.value)


def test_fit_constrained_numpy_goes_to_the_card(monkeypatch):
    """With no ``device``, numpy goes to the card: without one, raise."""
    from scd_tpu_torch.cluster.constrained import fit_constrained
    from scd_tpu_torch.core.config import ClusterConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = _blob_features(4, 200, 8, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        fit_constrained(x[:150], x[150:], y[150:],
                        ClusterConfig(n_clusters=4, size_min=10))


# ---------------------------------------------------------------- k-means++

@pytest.mark.parametrize("k", [4, 8, 16])
def test_kpp_local_trials_pins_and_potential(blobs, k):
    from scd_tpu_torch.ops.distance import pairwise_sqdist
    from scd_tpu_torch.ops.kpp import (auto_local_trials, kmeans_plus_plus,
                                       kmeans_plus_plus_local_trials)

    x = torch.as_tensor(blobs[0])
    assert auto_local_trials(k) == 2 + int(np.log(k))

    def potential(c):
        return float(pairwise_sqdist(x, c).min(dim=1).values.sum())

    simple, local = [], []
    for s in range(10):
        simple.append(potential(kmeans_plus_plus(
            x, k, torch.Generator().manual_seed(s))))
        c = kmeans_plus_plus_local_trials(x, k,
                                          torch.Generator().manual_seed(s))
        assert len({tuple(r) for r in c.tolist()}) == k  # no duplicates
        local.append(potential(c))
    assert np.mean(local) <= np.mean(simple)
    pre = x[:2]
    c = kmeans_plus_plus_local_trials(x, 6, torch.Generator().manual_seed(0),
                                      n_local_trials=4, pre_centers=pre)
    assert torch.equal(c[:2], pre)
    assert len({tuple(r) for r in c.tolist()}) == 6
