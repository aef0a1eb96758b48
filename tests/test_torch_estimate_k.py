"""``cluster/estimate_k.py`` of the port against the JAX package's, on the
CPU.

- The searches over ``dummy_objective`` (host logic): bit-equal K and
  objective, equal verbose lines, and both ``main``s print the same
  ``Best K`` line, with the halving search and with Brent.
- The dynamic-K Lloyd loop (``max_k`` slots, the ones at or past
  ``k_active`` far sentinels) from the JAX package's own ``_kpp_masked``
  centers (``jax.random.split(PRNGKey(seed), n_init)``): equal labels,
  inertia within 1e-5 relative and centers within 1e-5, as
  ``tests/test_torch_kmeans.py`` holds the Lloyd loops; the objective's ACC
  equal at three values of K from those centers.
- ``estimate_k`` over well-separated blobs from each package's own seeds
  (``jax.random`` and ``torch.Generator`` draw differently), through both
  ``main``s: both pick the same K.
"""

import contextlib
import importlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scd_tpu.ops.segment import segment_sums as jax_segment_sums

# the modules: each package's ``cluster`` exports the function of that name
J = importlib.import_module("scd_tpu.cluster.estimate_k")
T = importlib.import_module("scd_tpu_torch.cluster.estimate_k")

RTOL = 1e-5


def _printed(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*a, **kw)
    return res, buf.getvalue().splitlines()


@pytest.mark.parametrize("mode", ["binary", "brent"])
def test_searches_over_dummy_objective_bit_equal(mode):
    for min_k, max_k in ((2, 37), (50, 600)):  # main takes (10, 1000)
        jobj, tobj = J.dummy_objective(max_k), T.dummy_objective(max_k)
        if mode == "binary":
            jres, jlines = _printed(J.binary_search_k, jobj, min_k, max_k,
                                    verbose=True)
            tres, tlines = _printed(T.binary_search_k, tobj, min_k, max_k,
                                    verbose=True)
            assert tlines == jlines and len(tlines) > 1
        else:
            jres = J.scipy_optimise_k(jobj, min_k, max_k)
            tres = T.scipy_optimise_k(tobj, min_k, max_k)
        assert tres == jres
    argv = ["--min_k", "10", "--max_k", "1000", "--search_mode", mode]
    jres, jlines = _printed(J.main, argv)
    tres, tlines = _printed(T.main, argv + ["--device", "cpu"])
    assert tres == jres and tlines == jlines
    assert tlines[-1].startswith("Best K: ")


def _blobs(n, d, k, seed, std=0.1):
    """Well-separated blobs, every class labelled on half its rows."""
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((k, d))
    y = rng.integers(0, k, n)
    x = (means[y] + std * rng.standard_normal((n, d))).astype(np.float32)
    return x, y, rng.random(n) < 0.5


# one shape for every JAX fit below (N, D, max_k, n_init and the default
# max_iterations of the objective): the JAX package compiles it once
N, D, N_CLASSES, MAX_K, N_INIT, SEED = 900, 16, 8, 12, 3, 0
_jit_kpp = jax.jit(J._kpp_masked, static_argnames=("max_k",))


@pytest.fixture(scope="module")
def blobs():
    x, y, mask_lab = _blobs(N, D, N_CLASSES, seed=4)
    return x, y, mask_lab, J._normalized_device(x)


def _jax_centers(x_j, k_active):
    """The JAX package's initial centers of each restart of a probe."""
    keys = jax.random.split(jax.random.PRNGKey(SEED), N_INIT)
    return [np.array(_jit_kpp(key, x_j, jnp.asarray(k_active), max_k=MAX_K))
            for key in keys]


def _inject(monkeypatch, centers_by_k):
    """The port's seeding returns the JAX package's centers, restart by
    restart."""
    calls = []

    def kpp(x, k_active, max_k, generator):
        c = centers_by_k[k_active][len(calls) % N_INIT]
        calls.append(k_active)
        assert c.shape == (max_k, x.shape[1])
        return torch.from_numpy(c).to(x.device)

    monkeypatch.setattr(T, "_kpp_masked", kpp)
    return calls


def test_dynamic_k_lloyd_from_jax_centers(monkeypatch, blobs):
    x, _, _, x_j = blobs
    k_active, n_iter = N_CLASSES, 50
    x_t = T._normalized_device(x, "cpu")
    c0 = _jax_centers(x_j, k_active)
    assert all((c[k_active:] == np.float32(T.SENTINEL)).all() for c in c0)
    jl, ji = J.fit_kmeans_dynamic_k(jax.random.PRNGKey(SEED), x_j, k_active,
                                    MAX_K, n_init=N_INIT,
                                    max_iterations=n_iter)
    _inject(monkeypatch, {k_active: c0})
    tl, ti, tc = T._dynk_run(x_t, k_active, MAX_K, n_iter, N_INIT,
                             torch.Generator().manual_seed(SEED))
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_allclose(float(ti), ji, rtol=RTOL)
    # the JAX run's centers after its last update, from its own labels:
    # the sentinel slots stay empty and keep the sentinel
    sums, counts = jax_segment_sums(x_j, jnp.asarray(jl), MAX_K)
    counts = np.asarray(counts)
    assert (counts[:k_active] > 0).all() and (counts[k_active:] == 0).all()
    jc = np.where(counts[:, None] > 0,
                  np.asarray(sums) / np.maximum(counts, 1.0)[:, None],
                  np.float32(T.SENTINEL))
    np.testing.assert_allclose(tc.numpy(), jc, rtol=RTOL, atol=RTOL)
    labels, inertia = T.fit_kmeans_dynamic_k(
        torch.Generator().manual_seed(SEED), x_t, k_active, MAX_K,
        n_init=N_INIT, max_iterations=n_iter)
    np.testing.assert_array_equal(labels, jl)
    assert inertia == float(ti)


def test_objective_acc_equal_from_jax_centers(monkeypatch, blobs):
    x, y, mask_lab, x_j = blobs
    ks = (2, 8, 11)
    centers = {k: _jax_centers(x_j, k) for k in ks}
    jobj = J.labelled_acc_objective_dynamic(x, y, mask_lab, MAX_K,
                                            n_init=N_INIT, seed=SEED)
    calls = _inject(monkeypatch, centers)
    tobj = T.labelled_acc_objective_dynamic(x, y, mask_lab, MAX_K,
                                            n_init=N_INIT, seed=SEED,
                                            device="cpu")
    accs = [(jobj(k), tobj(k)) for k in ks]
    assert calls == [k for k in ks for _ in range(N_INIT)]
    assert all(j == t for j, t in accs), accs
    assert accs[0][0] < 0.5 and accs[1][0] == 1.0 > accs[2][0]
    # the per-K objective (``dynamic_k=False``: one ``fit_kmeans`` of K
    # clusters), each package from its own seeds, at the true K
    assert T.labelled_acc_objective(x, y, mask_lab, device="cpu")(8) == \
        J.labelled_acc_objective(x, y, mask_lab)(8) == 1.0


def test_estimate_k_on_blobs_picks_the_same_k(tmp_path, blobs):
    """Each package from its own seeds, through ``main`` (``estimate_k`` on
    a packed feature file).  The halving search over [4, 12] probes 12, 4,
    8, 10, 9: the labelled ACC is 1.0 at the true K of 8 and clearly lower
    at the others, so the search's every comparison falls the same way in
    both packages."""
    x, y, mask_lab, _ = blobs
    path = str(tmp_path / "features_packed.npz")
    np.savez(path, features=x, targets=y, mask_lab=mask_lab)
    argv = ["--features", path, "--min_k", "4", "--max_k", str(MAX_K),
            "--search_mode", "binary"]
    jres, jlines = _printed(J.main, argv)
    tres, tlines = _printed(T.main, argv + ["--device", "cpu"])
    assert tres == jres == (N_CLASSES, 1.0)
    assert tlines[-1] == jlines[-1] == "Best K: 8 (objective 1.0000)"


def test_mesh_and_missing_card_raise(monkeypatch):
    x, y, mask_lab = _blobs(50, 4, 3, seed=0)
    with pytest.raises(NotImplementedError, match="multi-device"):
        T.labelled_acc_objective_dynamic(x, y, mask_lab, 8, mesh=object())
    with pytest.raises(NotImplementedError, match="multi-device"):
        T.fit_kmeans_dynamic_k(torch.Generator(), x, 2, 8, mesh=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        T.main(["--min_k", "10", "--max_k", "100"])
    with pytest.raises(RuntimeError, match="cuda"):
        T.labelled_acc_objective_dynamic(x, y, mask_lab, 8)
