"""The port's frozen-feature NCD baselines (``scd_tpu_torch.train.
baselines`` and ``run_baseline``) against the JAX package's on the CPU,
from the same numpy inputs and the same parameters (the JAX init,
converted with ``params_from_flax`` and injected by patching the port's
``baselines._init_params``).

Tolerances, with their reasons:
- pure functions, f32: the same arithmetic in another library's order
  (sums of <= 64 terms, an exp / log): FN_RTOL / FN_ATOL on values and on
  gradients against ``jax.grad``; the ranking-statistics pairs, the OSR
  threshold and the combine are host-exact: bit-equal;
- trainers: f32 forward and backward, then six SGD steps of lr 0.1 with
  momentum, the error of each step carried into the next: TRAIN_RTOL /
  TRAIN_ATOL on each epoch's mean loss and on every final parameter;
  predictions equal on these separable features (margins far above);
- ``run_baseline.main``: the printed lines byte-equal (the loss printed
  to 4 decimals, the ACC line from equal predictions).  The supervised
  method's SSKM is seeded differently in the two packages (k-means++ from
  ``torch.Generator``, not ``jax.random``); on these separable features
  its partition is the same, so its ACC line is equal too.
"""

import contextlib
import io

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scd_tpu.train import baselines as jb
from scd_tpu.train import run_baseline as jrun
from scd_tpu_torch.models.params import flax_init_, params_from_flax
from scd_tpu_torch.train import baselines as tb
from scd_tpu_torch.train import run_baseline as trun

FN_RTOL, FN_ATOL = 1e-5, 1e-6
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-6

N, D, N_CLS, NLC = 96, 32, 6, 3


def _jax_head(n_classes, hidden_dim=0):
    """A replica of ``train_supervised``'s local Flax ``_Head``: the
    parameter rngs follow the names, so its init equals the JAX
    trainer's."""

    class _Head(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            if hidden_dim:
                x = fnn.relu(fnn.Dense(hidden_dim, name="fc")(x))
            return fnn.Dense(n_classes, name="out")(x)

    return _Head()


def jax_twin(model):
    """(the Flax module the JAX package builds for ``model``, its input
    width)."""
    if isinstance(model, tb.MultiHeadPrototypes):
        heads = getattr(model, "Vmap_Head_0")
        return jb.MultiHeadPrototypes(
            num_heads=model.num_heads,
            hidden_dim=heads.fc0.kernel.shape[-1],
            proj_dim=heads.out.kernel.shape[-1],
            num_prototypes=heads.prototypes.shape[-1]), \
            heads.fc0.kernel.shape[1]
    if isinstance(model, tb.TwoHeadClassifier):
        n_unlab = model.head2.kernel.shape[1]
        return jb.TwoHeadClassifier(
            num_labeled=model.head1.kernel.shape[1] - n_unlab,
            num_unlabeled=n_unlab,
            hidden_dim=model.trunk.kernel.shape[1]), \
            model.trunk.kernel.shape[0]
    if isinstance(model, tb._Head):
        hidden = model.fc.kernel.shape[1] if model.fc is not None else 0
        d = (model.fc or model.out).kernel.shape[0]
        return _jax_head(model.out.kernel.shape[1], hidden), d
    raise TypeError(type(model))


_INITS = {}


def jax_init(model, seed):
    """The JAX trainer's init of ``model``'s twin from PRNGKey(seed),
    converted and loaded (strict: every name maps); made once per twin
    and seed."""
    twin, d = jax_twin(model)
    key = (repr(twin), d, seed)
    if key not in _INITS:
        _INITS[key] = params_from_flax(jax.jit(twin.init)(
            jax.random.PRNGKey(seed), jnp.zeros((1, d), jnp.float32)))
    model.load_state_dict(_INITS[key])
    return model


@pytest.fixture
def jax_inits(monkeypatch):
    monkeypatch.setattr(tb, "_init_params", jax_init)


def _close(got, want, rtol=FN_RTOL, atol=FN_ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


# --------------------------------------------------------- pure functions

_rs = np.random.default_rng(7)
_LOGITS = _rs.standard_normal((2, 3, 10, 9)).astype(np.float32)  # V,H,B,C
_MASK = np.array([1, 0, 0, 1, 0, 0, 0, 1, 0, 0], bool)
_LAB = np.array([0, 5, 7, 2, 4, 3, 8, 1, 6, 5])


def _lab_mask(mod):
    if mod is tb:
        return torch.from_numpy(_LAB), torch.from_numpy(_MASK)
    return jnp.asarray(_LAB), jnp.asarray(_MASK)


def _targets(mod, logits):
    return mod.uno_targets(logits[..., 3:], *_lab_mask(mod), 3)


@pytest.mark.parametrize("masked", [False, True])
def test_sinkhorn_knopp_matches_jax(masked):
    # cosine logits, as the prototype heads give them: [-1, 1], so z up
    # to +-20 at epsilon 0.05 (the max-shift keeps exp in range; far
    # larger z reach f32 denormals, where the two libraries flush apart)
    lg = _rs.uniform(-1.0, 1.0, (12, 7)).astype(np.float32)
    mask = (np.arange(12) % 3 != 0) if masked else None
    want = jb.sinkhorn_knopp(jnp.asarray(lg), 3, 0.05,
                             None if mask is None else jnp.asarray(mask))
    got = tb.sinkhorn_knopp(torch.from_numpy(lg), 3, 0.05,
                            None if mask is None else torch.from_numpy(mask))
    _close(got, want)
    # and batched over leading axes, each matrix on its own
    batch = np.stack([lg, 2 * lg])
    got_b = tb.sinkhorn_knopp(torch.from_numpy(batch), 3, 0.05,
                              None if mask is None else torch.from_numpy(mask))
    _close(got_b[0], want)
    if masked:
        assert bool((got[~torch.from_numpy(mask)] == 0).all())


def test_uno_targets_match_jax():
    want = _targets(jb, jnp.asarray(_LOGITS))
    got = _targets(tb, torch.from_numpy(_LOGITS))
    assert got.shape == (2, 3, 10, 9)
    _close(got, want)


def _swapped(mod, logits, targets):
    return mod.swapped_prediction_loss(logits, targets, 0.1)


def _per_head(mod, logits, targets):
    return mod._swapped_loss_per_head(logits, targets, 0.1).sum() * 0.7 \
        + mod._swapped_loss_per_head(logits, targets, 0.1)[1]


def _autonovel(mod, o1, o1b, feats, kl):
    feats = torch.from_numpy(feats) if mod is tb else jnp.asarray(feats)
    return mod.autonovel_loss(o1, o1b, feats, *_lab_mask(mod), 0.37,
                              topk=3, kl_weight=kl)["loss"]


_P1 = np.abs(_rs.standard_normal((10, 6))).astype(np.float32)
_P1 /= _P1.sum(1, keepdims=True)
_P2 = np.abs(_rs.standard_normal((10, 6))).astype(np.float32)
_P2 /= _P2.sum(1, keepdims=True)
_SIMI = _rs.choice([-1.0, 0.0, 1.0], 10).astype(np.float32)
# feature rows with ties: rows 1 and 2 are equal, rows 3 and 4 hold one
# value many times, so the stable sort decides their top-k
_FEATS = _rs.standard_normal((10, 8)).astype(np.float32)
_FEATS[2] = _FEATS[1]
_FEATS[3] = 0.5
_FEATS[4] = 0.5
_FEATS[4, 7] = 0.25
_O1 = 3.0 * _rs.standard_normal((10, 9)).astype(np.float32)
_O1B = _O1 + 0.3 * _rs.standard_normal((10, 9)).astype(np.float32)

# (name, function of (module, *diff), inputs differentiated, targets
# needed from the logits)
LOSSES = [
    ("swapped_prediction_loss", _swapped, [_LOGITS], True),
    ("_swapped_loss_per_head", _per_head, [_LOGITS], True),
    ("pairwise_bce", lambda m, a, b: m.pairwise_bce(
        a, b, torch.from_numpy(_SIMI) if m is tb else jnp.asarray(_SIMI)),
     [_P1, _P2], False),
    ("autonovel_loss", lambda m, a, b: _autonovel(m, a, b, _FEATS, 0.0),
     [_O1, _O1B], False),
    ("autonovel_loss_kl", lambda m, a, b: _autonovel(m, a, b, _FEATS, 0.5),
     [_O1, _O1B], False),
]


def _mods(fn_name):
    from scd_tpu.train import baselines_e2e as je
    from scd_tpu_torch.train import baselines_e2e as te

    return (je, te) if fn_name == "_swapped_loss_per_head" else (jb, tb)


@pytest.mark.parametrize("name,fn,diff,with_targets", LOSSES,
                         ids=[c[0] for c in LOSSES])
def test_loss_value_and_gradient_match_jax(name, fn, diff, with_targets):
    jmod, tmod = _mods(name)
    if with_targets:  # the targets are constants (stop_gradient)
        jt = _targets(jb, jnp.asarray(_LOGITS))
        tt = _targets(tb, torch.from_numpy(_LOGITS))

        def jfn(x):
            return fn(jmod, x, jt)

        def tfn(x):
            return fn(tmod, x, tt)
    else:
        def jfn(*xs):
            return fn(jmod, *xs)

        def tfn(*xs):
            return fn(tmod, *xs)
    n = len(diff)
    want, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=tuple(range(n))))(
        *[jnp.asarray(a) for a in diff])
    xs = [torch.tensor(a, requires_grad=True) for a in diff]
    got = tfn(*xs)
    got.backward()
    _close(got.item(), float(want), msg=name)
    for x, g in zip(xs, jgrads):
        _close(x.grad, g, msg=name)


def test_ranking_stats_similarity_is_bit_equal_on_ties():
    for k in (1, 3, 5):
        want = np.asarray(jb.ranking_stats_similarity(jnp.asarray(_FEATS), k))
        got = tb.ranking_stats_similarity(torch.from_numpy(_FEATS), k)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got[1, 2] == 1.0
    # rows 3 and 4 tie on 7 of 8 values: the lowest indices rank first,
    # so they agree at k 3 and differ once k reaches the odd value
    assert tb.ranking_stats_similarity(torch.from_numpy(_FEATS), 3)[3, 4] \
        == 1.0


def test_osr_and_combine_are_bit_equal():
    logits = _rs.standard_normal((40, 5)).astype(np.float32) * 2.0
    logits[3] = 1.0  # a tie across every class: the first index, low conf
    for thr in (0.0, 0.35, 0.5, 0.9):
        want = np.asarray(jb.osr_threshold_preds(jnp.asarray(logits), thr))
        got = tb.osr_threshold_preds(torch.from_numpy(logits), thr).numpy()
        np.testing.assert_array_equal(got, want)
    cls = _rs.integers(-1, 6, 40)
    clu = _rs.integers(0, 9, 40)
    np.testing.assert_array_equal(
        tb.combine_classifier_and_cluster_preds(cls, clu, 3),
        jb.combine_classifier_and_cluster_preds(cls, clu, 3))


# ---------------------------------------------------------------- modules

def test_heads_match_jax_from_converted_parameters():
    x = _rs.standard_normal((7, D)).astype(np.float32)
    # the trainers' tests load the one-layer heads and the hidden-free
    # supervised head; these are the other shapes
    for port in (tb.MultiHeadPrototypes(D, num_heads=2, hidden_dim=24,
                                        proj_dim=8, num_prototypes=5,
                                        num_hidden_layers=2),
                 tb.TwoHeadClassifier(D, 4, 6, hidden_dim=40),
                 tb._Head(D, 5, hidden_dim=12)):
        twin, _d = jax_twin(port)
        if isinstance(port, tb.MultiHeadPrototypes):
            twin = twin.clone(
                num_hidden_layers=getattr(port, "Vmap_Head_0")
                .num_hidden_layers)
        params = jax.jit(twin.init)(jax.random.PRNGKey(1), jnp.asarray(x))
        # LayerNorm scales and biases away from (1, 0)
        params = jax.tree_util.tree_map(
            lambda v: np.asarray(v) + 0.1 * _rs.standard_normal(
                v.shape).astype(np.float32), params)
        want = jax.jit(twin.apply)(params, jnp.asarray(x))
        port.load_state_dict(params_from_flax(params))
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, msg=type(port).__name__)


def test_flax_init_draws_flax_distributions():
    """flax_init_ on the stacked heads: per-head fan-in (not H x in), the
    prototypes at normal(0.02), LayerNorm scales 1 and biases 0."""
    m = flax_init_(tb.MultiHeadPrototypes(512, num_heads=4), seed=3)
    heads = getattr(m, "Vmap_Head_0")
    k = heads.fc0.kernel.detach()  # [4, 512, 2048]: fan_in 512 a head
    for h in range(4):
        assert abs(k[h].std().item() - 512 ** -0.5) < 0.02 * 512 ** -0.5
    assert k.abs().max().item() <= 2 * 512 ** -0.5 / 0.8796256610342398
    o = heads.out.kernel.detach()  # [4, 2048, 256]: fan_in 2048
    assert abs(o.std().item() - 2048 ** -0.5) < 0.02 * 2048 ** -0.5
    assert abs(heads.prototypes.std().item() - 0.02) < 0.001
    assert torch.equal(heads.ln0.scale, torch.ones(4, 2048))
    assert torch.equal(heads.fc0.bias, torch.zeros(4, 2048))
    # the heads differ from one another (independent draws)
    assert not torch.equal(k[0], k[1])
    # against the JAX package's own init: the same spread per head
    j = jax.jit(jb.MultiHeadPrototypes(num_heads=4).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 512)))["params"]["Vmap_Head_0"]
    jstd = np.asarray(j["fc0"]["kernel"]).std(axis=(1, 2))
    np.testing.assert_allclose(k.std(dim=(1, 2)).numpy(), jstd, rtol=0.02)
    np.testing.assert_allclose(heads.prototypes.std().item(),
                               np.asarray(j["prototypes"]).std(), rtol=0.05)


# --------------------------------------------------------------- trainers

def _features(seed=0, n=N):
    """Separable, L2-normalised class features, labelled rows among the
    first NLC classes."""
    rng = np.random.default_rng(seed)
    centers = 3.0 * rng.standard_normal((N_CLS, D))
    y = rng.integers(0, N_CLS, n)
    x = centers[y] + 0.3 * rng.standard_normal((n, D))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    mask = (y < NLC) & (rng.random(n) < 0.5)
    views = np.stack([x + 0.05 * rng.standard_normal(x.shape).astype(
        np.float32) for _ in range(2)])
    return x, y, mask, views


TRAINERS = {
    "uno": lambda mod, init, x, y, m, v, **kw: mod.train_uno(
        init, v, y, m, NLC, N_CLS - NLC, epochs=2, batch_size=32, seed=3,
        **kw),
    "autonovel": lambda mod, init, x, y, m, v, **kw: mod.train_autonovel(
        init, v[0], v[1], y, m, NLC, N_CLS - NLC, epochs=2, batch_size=32,
        seed=3, **kw),
    "supervised": lambda mod, init, x, y, m, v, **kw: mod.train_supervised(
        init, x[m], y[m], NLC, epochs=2, batch_size=16, seed=3, **kw),
}


@pytest.fixture(scope="module")
def jax_trainers():
    """Each JAX trainer once: (final parameters as flat Flax names,
    predictions or logits on the features, history)."""
    x, y, m, v = _features()
    out = {}
    for name, run in TRAINERS.items():
        params, fn, history = run(jb, jax.random.PRNGKey(5), x, y, m, v)
        out[name] = (params_from_flax(params), np.asarray(fn(x)), history)
    return out


@pytest.mark.parametrize("name", list(TRAINERS))
def test_trainer_matches_jax(name, jax_trainers, jax_inits):
    x, y, m, v = _features()
    want_params, want_out, want_hist = jax_trainers[name]
    model, fn, history = TRAINERS[name](tb, 5, x, y, m, v, device="cpu")
    assert len(history) == len(want_hist) == 2
    _close(history, want_hist, TRAIN_RTOL, TRAIN_ATOL, msg="history")
    got = model.state_dict()
    assert set(got) == set(want_params)
    for k, w in want_params.items():
        _close(got[k], w, TRAIN_RTOL, TRAIN_ATOL, msg=k)
    if name == "autonovel":  # no loss reaches head2 and no decay: unmoved
        init = jax_init(tb.TwoHeadClassifier(D, NLC, N_CLS - NLC), 5)
        assert torch.equal(got["head2.kernel"], init.head2.kernel)
    out = fn(x)
    if name == "supervised":  # logits
        _close(out, want_out, TRAIN_RTOL, TRAIN_ATOL)
        np.testing.assert_array_equal(
            tb.osr_threshold_preds(out, 0.5).numpy(),
            np.asarray(jb.osr_threshold_preds(jnp.asarray(want_out), 0.5)))
    else:
        np.testing.assert_array_equal(out.numpy(), want_out)


def test_trainers_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, m, v = _features()
    with pytest.raises(RuntimeError, match="cuda"):
        tb.train_uno(0, v, y, m, NLC, N_CLS - NLC, epochs=1)


# ------------------------------------------------------------------- mains

def _lines(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    x, y, m, _v = _features(seed=1, n=240)
    path = str(tmp_path_factory.mktemp("feats") / "features_packed.npz")
    np.savez(path, features=x, targets=y, mask_lab=m)
    return path


@pytest.mark.parametrize("method", ["uno", "autonovel", "supervised"])
def test_run_baseline_main_prints_the_jax_lines(method, store, jax_inits):
    argv = ["--method", method, "--features", store, "--n_labeled",
            str(NLC), "--epochs", "2", "--batch_size", "64", "--seed", "2"]
    want = _lines(jrun.main, argv)
    got = _lines(trun.main, argv + ["--device", "cpu"])
    assert len(got) == 2 and got[0].startswith("final loss: ")
    assert got == want
