"""The port's GCD training (``scd_tpu_torch.train``) against the JAX
package's on the CPU, from the same numpy inputs.

Losses (values and gradients: ``jax.grad`` against autograd), schedules
(against optax), the checkpoint manager (same files, manifest and
sidecars), the DINO head from carried parameters, the trainable set
against ``_param_label``, three GCD steps from ``make_gcd_state``'s
parameters on the tiny ViT of ``tests/test_train.py`` (plain, ``remat``,
``int8_frozen``), ``balanced_batches``, and ``metric_learn.main`` on the
synthetic dataset.  The JAX GCD runs are made once per module (their
compiles are most of the time).

Tolerances, with their reasons:
- f32 losses and gradients: the same arithmetic reassociated by another
  library (sums of <= 64 terms), LOSS_RTOL / LOSS_ATOL;
- schedules: optax evaluates in f32, the port in f64: SCHED_RTOL, and
  SCHED_ATOL of the base lr (f32 ulps of optax's cosine factor, which
  cancels to ~0 at the end of a decay);
- GCD steps: f32 forward and backward through the tower and the head in
  another order, then one SGD update of lr 0.1 per step: STEP_RTOL /
  STEP_ATOL on the loss and on every parameter after each step, frozen
  parameters bit-equal.  Under ``int8_frozen`` an activation on a
  rounding boundary may quantize one int8 step apart in the two
  packages, so the frozen trunk's output may differ there by one
  quantization step of one element: INT8_RTOL / INT8_ATOL.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scd_tpu.core.config import TrainConfig as JTrainConfig
from scd_tpu.models.vit import ViTConfig as JViTConfig
from scd_tpu.train import checkpoint as jckpt
from scd_tpu.train import gcd as jgcd
from scd_tpu.train import losses as jlosses
from scd_tpu.train import metric_learn as jml
from scd_tpu.train import schedulers as jsched
from scd_tpu_torch.core.config import TrainConfig
from scd_tpu_torch.models.params import params_from_flax
from scd_tpu_torch.models.vit import ViTConfig
from scd_tpu_torch.train import checkpoint as tckpt
from scd_tpu_torch.train import gcd as tgcd
from scd_tpu_torch.train import losses as tlosses
from scd_tpu_torch.train import metric_learn as tml
from scd_tpu_torch.train import schedulers as tsched

LOSS_RTOL, LOSS_ATOL = 1e-5, 1e-6
SCHED_RTOL, SCHED_ATOL = 1e-6, 2.0 ** -22
STEP_RTOL, STEP_ATOL = 1e-4, 1e-6
INT8_RTOL, INT8_ATOL = 1e-3, 1e-5


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


# ------------------------------------------------------------------ losses

def _info_nce_ce(mod, f):
    logits, labels = mod.info_nce_loss(f, n_views=2, temperature=0.3)
    return mod.cross_entropy(logits, labels)


def _masked_supcon(mod, f, labels, valid):
    return mod.masked_supcon_loss(f, labels, valid, temperature=0.1)


_rs = np.random.default_rng(5)
_LABELS = _rs.integers(0, 3, 6).astype(np.int64)
_VALID = np.array([1, 0, 1, 1, 0, 1], bool)
# (name, JAX function, port function, inputs differentiated, other inputs)
LOSSES = [
    ("info_nce+cross_entropy",
     lambda f: _info_nce_ce(jlosses, f), lambda f: _info_nce_ce(tlosses, f),
     [_unit(_rs.standard_normal((12, 16)))], []),
    ("supcon",
     lambda f, y: jlosses.supcon_loss(f, y, temperature=0.2),
     lambda f, y: tlosses.supcon_loss(f, y, temperature=0.2),
     [_unit(_rs.standard_normal((6, 2, 16)))], [_LABELS]),
    ("nt_xent", lambda a, b: jlosses.nt_xent_loss(a, b),
     lambda a, b: tlosses.nt_xent_loss(a, b),
     [_rs.standard_normal((6, 8)).astype(np.float32),
      _rs.standard_normal((6, 8)).astype(np.float32)], []),
    ("label_smoothing_ce",
     lambda x, y: jlosses.label_smoothing_ce(x, y, 0.2),
     lambda x, y: tlosses.label_smoothing_ce(x, y, 0.2),
     [_rs.standard_normal((5, 4)).astype(np.float32)],
     [np.array([0, 1, 2, 3, 0])]),
    ("masked_supcon",
     lambda f, y, v: _masked_supcon(jgcd, f, y, v),
     lambda f, y, v: _masked_supcon(tgcd, f, y, v),
     [_unit(_rs.standard_normal((6, 2, 16)))], [_LABELS, _VALID]),
]


@pytest.mark.parametrize("name,jfn,tfn,diff,rest", LOSSES,
                         ids=[c[0] for c in LOSSES])
def test_loss_value_and_gradient_match_jax(name, jfn, tfn, diff, rest):
    n = len(diff)
    want, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=tuple(range(n))))(
        *[jnp.asarray(a) for a in diff], *[jnp.asarray(a) for a in rest])
    xs = [torch.tensor(a, requires_grad=True) for a in diff]
    got = tfn(*xs, *[torch.as_tensor(a) for a in rest])
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    for x, g in zip(xs, jgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL)


# --------------------------------------------------------------- schedules

SCHEDULES = [
    ("cosine_warmup", lambda m: m.cosine_warmup_schedule(0.1, 10, 100, 1e-3)),
    ("cosine_no_warmup",
     lambda m: m.cosine_warmup_schedule(0.1, 0, 100, 1e-4)),
    ("step", lambda m: m.get_scheduler("step", 0.1, 100, step_size=30)),
    ("multi_step", lambda m: m.get_scheduler("multi_step", 0.1, 100,
                                             milestones=[20, 50, 50, 90])),
    ("cosine", lambda m: m.get_scheduler("cosine", 0.1, 100)),
    ("cosine_warm_restarts",
     lambda m: m.get_scheduler("cosine_warm_restarts", 0.1, 100)),
    ("cosine_warm_restarts_warmup",
     lambda m: m.get_scheduler("cosine_warm_restarts_warmup", 0.1, 100)),
]


@pytest.mark.parametrize("name,make", SCHEDULES, ids=[c[0] for c in SCHEDULES])
def test_schedule_matches_optax(name, make):
    jfn, tfn = make(jsched), make(tsched)
    steps = np.arange(0, 131)
    want = np.array([float(np.asarray(jfn(int(s)))) for s in steps])
    got = np.array([tfn(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=SCHED_RTOL,
                               atol=0.1 * SCHED_ATOL)  # base lr 0.1


def test_ramps_and_plateau_controllers_match_jax():
    for cur in (0, 3, 7.5, 10, 12):
        assert tsched.sigmoid_rampup(cur, 10) == jsched.sigmoid_rampup(cur, 10)
        assert tsched.linear_rampup(cur, 10) == jsched.linear_rampup(cur, 10)
        assert tsched.cosine_rampdown(cur, 10) == jsched.cosine_rampdown(cur,
                                                                          10)
    metrics = np.random.default_rng(1).random(60).cumsum()[::-1] % 3.0
    for name, kw in (("plateau", {"patience": 3}),
                     ("warm_restarts_plateau",
                      {"patience": 2, "t_restart": 7, "threshold": 0.1})):
        j = jsched.get_scheduler(name, 0.1, 100, **kw)
        t = tsched.get_scheduler(name, 0.1, 100, **kw)
        assert [t.step(m) for m in metrics] == [j.step(m) for m in metrics]


# ---------------------------------------------------------- checkpointing

def test_checkpoint_manager_matches_jax(tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jm = jckpt.CheckpointManager(jdir, keep=2, best_metric="acc")
    tm = tckpt.CheckpointManager(tdir, keep=2, best_metric="acc")
    rng = np.random.default_rng(0)
    states = []
    for step, acc in enumerate((0.1, 0.5, 0.3, 0.7, 0.2)):
        w = rng.standard_normal((3, 4)).astype(np.float32)
        states.append(w)
        jm.save(step, {"w": w, "step": step}, metrics={"acc": acc})
        tm.save(step, {"w": torch.from_numpy(w), "step": step},
                metrics={"acc": acc})
    jfiles = sorted(f.replace(".msgpack", ".pt") for f in os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == jfiles
    for name in os.listdir(tdir):
        if name.endswith(".json"):
            with open(os.path.join(jdir, name)) as a, \
                    open(os.path.join(tdir, name)) as b:
                assert json.load(a) == json.load(b), name
    assert tm.latest_step() == jm.latest_step() == 4
    step, state = tm.restore()
    assert step == 4 and state["step"] == 4
    np.testing.assert_array_equal(state["w"].numpy(), states[4])
    step, state = tm.restore(3)
    np.testing.assert_array_equal(state["w"].numpy(), states[3])
    best_step, best = tm.restore_best()
    assert best_step == 3 == jm.restore_best({"w": states[0], "step": 0})[0]
    np.testing.assert_array_equal(best["w"].numpy(), states[3])
    # a manager reopened on the directory reads the manifest back
    again = tckpt.CheckpointManager(tdir, keep=2, best_metric="acc")
    assert again.latest_step() == 4
    with pytest.raises(FileNotFoundError):
        tm.restore(0)  # pruned
    assert tckpt.strip_key_prefix({"module.a": 1, "b": 2}) == \
        jckpt.strip_key_prefix({"module.a": 1, "b": 2})


# ----------------------------------------------------- experiment utils

def test_experiment_utilities_match_jax(tmp_path):
    """init_experiment's files, the scalar stream read back, config_hash,
    AverageMeter and IndicatePlateau, against the JAX package's."""
    from scd_tpu.utils import experiment as jexp
    from scd_tpu_torch.utils import experiment as texp

    config = {"lr": 0.1, "vit": "micro", "epochs": 2, "flag": True,
              "skip": [1, 2]}
    runs = {}
    for tag, mod in (("jax", jexp), ("torch", texp)):
        ctx = mod.init_experiment(config, exp_root=str(tmp_path / tag),
                                  runner_name="metric_learn", exp_id="run")
        ctx.writer.add_scalars("kmeans", {"acc": 0.5, "nmi": 0.25}, step=0)
        ctx.writer.add_scalar("loss", 1.5)
        ctx.logger.info("Epoch 0: loss 1.5000")
        ctx.close()
        runs[tag] = ctx
        assert ctx.model_path == os.path.join(ctx.model_dir, "model")
    for name in ("config.json", "hparams.json"):
        with open(os.path.join(runs["jax"].log_dir, name)) as a, \
                open(os.path.join(runs["torch"].log_dir, name)) as b:
            assert a.read() == b.read(), name
    got, want = (mod.read_scalars(runs[t].log_dir)
                 for mod, t in ((texp, "torch"), (jexp, "jax")))
    assert sorted(got) == sorted(want) == ["kmeans/acc", "kmeans/nmi", "loss"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert texp.config_hash(config) == jexp.config_hash(config)
    assert texp.read_scalars(str(tmp_path / "none")) == {}
    jm, tm = jexp.AverageMeter(), texp.AverageMeter()
    for v, n in ((1.0, 2), (4.0, 1), (0.5, 5)):
        jm.update(v, n)
        tm.update(v, n)
    assert (tm.val, tm.avg, tm.sum, tm.count) == (jm.val, jm.avg, jm.sum,
                                                  jm.count)
    seq = [5.0, 4.0, 4.0, 4.1, 3.9, 3.9, 3.95, 4.0, 1.0]
    for kw in ({}, {"mode": "max", "threshold_mode": "abs",
                    "patience_epochs": 1}):
        jp, tp = jexp.IndicatePlateau(**kw), texp.IndicatePlateau(**kw)
        assert [tp.step(m) for m in seq] == [jp.step(m) for m in seq]


# ------------------------------------------------ head, init, sampling

def test_dino_head_matches_jax():
    head = jgcd.DINOHead(out_dim=96, hidden_dim=48, bottleneck_dim=16)
    x = np.random.default_rng(2).standard_normal((5, 24)).astype(np.float32)
    params = jax.jit(head.init)(jax.random.PRNGKey(3),
                                jnp.asarray(x))["params"]
    want = np.asarray(jax.jit(head.apply)({"params": params},
                                          jnp.asarray(x)))
    port = tgcd.DINOHead(24, out_dim=96, hidden_dim=48, bottleneck_dim=16)
    port.load_state_dict(params_from_flax(params))
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)


def test_flax_init_draws_flax_distributions():
    _, tvit = _vit()
    tr = tgcd.GCDTrainer(tvit, _cfgs()[1], seed=4, device="cpu")
    sd = tr.model.state_dict()
    k = sd["head.fc2.kernel"]  # [2048, 2048]: lecun normal, fan_in 2048
    assert abs(k.std().item() - 2048 ** -0.5) < 0.02 * 2048 ** -0.5
    assert k.abs().max().item() <= 2 * 2048 ** -0.5 / 0.8796256610342398
    p = sd["backbone.patch_embed.kernel"]  # [8, 8, 3, 32]: fan_in 192
    assert p.abs().max().item() <= 2 * 192 ** -0.5 / 0.8796256610342398
    assert torch.equal(sd["backbone.cls_token"], torch.zeros(1, 1, 32))
    assert torch.equal(sd["backbone.block_0.norm1.scale"], torch.ones(32))
    assert abs(sd["head.last_layer"].std().item() - 0.02) < 0.001
    again = tgcd.GCDTrainer(tvit, _cfgs()[1], seed=4, device="cpu")
    for name, v in again.model.state_dict().items():
        assert torch.equal(v, sd[name]), name


class _Merged:
    """A MergedDataset stand-in: item i's two views are constant arrays."""

    def __init__(self, n=40, n_lab=9):
        self.n, self.n_lab = n, n_lab

    def __len__(self):
        return self.n

    @property
    def mask_lab(self):
        return np.arange(self.n) < self.n_lab

    def __getitem__(self, i):
        views = [np.full((2, 2, 3), i, np.float32),
                 np.full((2, 2, 3), -i, np.float32)]
        return views, i % 7, i, np.array([int(i < self.n_lab)])


def test_balanced_batches_match_jax():
    kw = dict(batch_size=6, n_views=2, seed=3, steps_per_epoch=4,
              num_workers=2)
    got = list(tml.balanced_batches(_Merged(), **kw))
    want = list(jml.balanced_batches(_Merged(), **kw))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for key in ("images", "labels", "mask_lab"):
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])


# ------------------------------------------------------------ the GCD model

def _vit(remat=False):
    kw = dict(image_size=16, patch_size=8, width=32, depth=4, heads=4)
    return (dataclasses.replace(JViTConfig(**kw), remat=remat),
            ViTConfig(**kw, remat=remat))


def _cfgs(int8_frozen=False):
    kw = dict(grad_from_block=2, proj_dim=64, batch_size=4, lr=0.1,
              int8_frozen=int8_frozen)
    return JTrainConfig(**kw), TrainConfig(**kw)


def _batches(n=3, b=4, size=16):
    rng = np.random.default_rng(11)
    return [{"images": rng.standard_normal((2 * b, size, size, 3)
                                           ).astype(np.float32),
             "labels": rng.integers(0, 3, b).astype(np.int32),
             "mask_lab": rng.random(b) < 0.5} for _ in range(n)]


# port variant: (remat, int8_frozen, the JAX run it is held against).  The
# JAX package's remat step equals its exact one (tests/test_train.py::
# test_gcd_step_remat_matches_exact, rtol 1e-6), so the port's remat run
# is held against the JAX f32 run, which saves a compile
VARIANTS = {"f32": (False, False, "f32"), "remat": (True, False, "f32"),
            "int8_frozen": (False, True, "int8_frozen")}


JAX_RUNS = {"f32": False, "int8_frozen": True}


@pytest.fixture(scope="module")
def jax_runs():
    """Per JAX run of JAX_RUNS: (make_gcd_state's parameters, [(loss,
    parameters)] after each of three steps on ``_batches()``), parameters
    as flat Flax names -> tensors."""
    out = {}
    for name, int8 in JAX_RUNS.items():
        jvit, _ = _vit()
        jcfg, _ = _cfgs(int8)
        params, opt_state, step = jgcd.make_gcd_state(
            jvit, jcfg, jax.random.PRNGKey(0), total_steps=10)
        p0, trace = params_from_flax(params), []
        for batch in _batches():
            params, opt_state, metrics = step(
                params, opt_state, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
            trace.append((float(metrics["loss"]), params_from_flax(params)))
        out[name] = (p0, trace)
    return out


def _port_trainer(p0, remat=False, int8=False):
    """A port trainer on the CPU from the flat parameters ``p0``."""
    _, tvit = _vit(remat)
    _, tcfg = _cfgs(int8)
    tr = tgcd.GCDTrainer(tvit, tcfg, seed=0, total_steps=10, device="cpu")
    tr.model.load_state_dict(p0)  # strict: every name maps, none is left
    return tr


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_three_gcd_steps_match_jax(jax_runs, variant):
    remat, int8, against = VARIANTS[variant]
    rtol, atol = (INT8_RTOL, INT8_ATOL) if int8 else (STEP_RTOL, STEP_ATOL)
    p0, trace = jax_runs[against]
    tr = _port_trainer(p0, remat, int8)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    trainable = {n for n, p in tr.model.named_parameters() if p.requires_grad}
    for i, (batch, (jloss, jparams)) in enumerate(zip(_batches(), trace)):
        metrics = tr.step_fn(tr.model, tr.opt, tr.to_device(batch))
        np.testing.assert_allclose(metrics["loss"].item(), jloss, rtol=rtol,
                                   atol=atol, err_msg=f"step {i}")
        want = jparams
        for name, got in tr.model.state_dict().items():
            if name in trainable:
                np.testing.assert_allclose(
                    got.numpy(), want[name].numpy(), rtol=rtol, atol=atol,
                    err_msg=f"step {i} {name}")
            else:
                assert torch.equal(got, before[name]), name
                assert torch.equal(got, want[name]), name
    # the trainable block's qkv and the head really moved
    for name in ("backbone.block_3.attn.qkv.kernel", "head.fc1.kernel",
                 "head.last_layer", "backbone.norm.scale"):
        assert not torch.equal(tr.model.state_dict()[name], before[name])
    if remat:  # recomputation changes when activations are made, not them
        exact = _port_trainer(p0)
        for batch in _batches():
            exact.step_fn(exact.model, exact.opt, exact.to_device(batch))
        got = tr.model.state_dict()
        for name, v in exact.model.state_dict().items():
            assert torch.equal(got[name], v), name


def test_trainable_set_matches_param_label(jax_runs):
    """``_param_label`` on the JAX tree's paths (rebuilt from the flat
    names, as ``make_gcd_state`` labels them) against the port's
    ``requires_grad`` set and its optimizer's parameters."""
    p0, _trace = jax_runs["f32"]
    tree = {}
    for name in p0:
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.zeros(1, np.float32)
    labels = jax.tree_util.tree_map_with_path(
        lambda path, _: jgcd._param_label(
            tuple(getattr(k, "key", k) for k in path), 2), tree)
    flat = params_from_flax(jax.tree_util.tree_map(
        lambda lab: np.float32(lab == "train"), labels))
    want = {k for k, v in flat.items() if v.item() == 1.0}
    tr = _port_trainer(p0)
    got = {n for n, p in tr.model.named_parameters() if p.requires_grad}
    assert got == want
    assert set(p0) == set(tr.model.state_dict())
    assert "backbone.block_1.attn.qkv.kernel" not in got
    assert {"backbone.norm.scale", "backbone.block_2.norm1.scale",
            "head.last_layer"} <= got
    opt_params = {id(p) for g in tr.opt.sgd.param_groups for p in g["params"]}
    assert opt_params == {id(p) for n, p in tr.model.named_parameters()
                          if n in want}


def test_trainer_epoch_state_and_restore(tmp_path, jax_runs):
    """One epoch through ``train_epoch`` (metrics read once, keys in the
    JAX step's sorted order), a checkpoint, and a restored trainer taking
    the next step with the same bits as the original."""
    p0, _trace = jax_runs["f32"]
    tr = _port_trainer(p0)
    batches = _batches()
    out = tr.train_epoch(batches[:2])
    assert list(out) == ["contrastive", "loss", "sup_con"]
    ckpt = tckpt.CheckpointManager(str(tmp_path), keep=1)
    ckpt.save(0, tr.state, metrics=out)
    fresh = _port_trainer({k: torch.zeros_like(v) for k, v in p0.items()})
    fresh.load_state(ckpt.restore()[1])
    assert fresh.opt.count == tr.opt.count == 2
    for t in (tr, fresh):
        t.step_fn(t.model, t.opt, t.to_device(batches[2]))
    b = fresh.model.state_dict()
    for name, v in tr.model.state_dict().items():
        assert torch.equal(v, b[name]), name
    with pytest.raises(NotImplementedError):
        tgcd.GCDTrainer(_vit()[1], _cfgs()[1], device="cpu", mesh=object())


# --------------------------------------------------------------- the entry

def _epoch_line_keys(log_dir):
    with open(os.path.join(log_dir, "log.txt")) as f:
        line = [ln for ln in f if "Epoch 0:" in ln][0]
    return [kv.rsplit(" ", 1)[0] for kv in
            line.split("Epoch 0: ", 1)[1].strip().split(" | ")]


ENTRY_ARGV = ["--dataset_name", "synthetic", "--vit", "micro",
              "--image_size", "32", "--epochs", "1", "--steps_per_epoch",
              "2", "--batch_size", "16", "--proj_dim", "64",
              "--num_workers", "2"]


def test_metric_learn_main_matches_jax_entry(tmp_path):
    jres = jml.main(ENTRY_ARGV + ["--exp_root", str(tmp_path / "jax")])
    tres = tml.main(ENTRY_ARGV + ["--exp_root", str(tmp_path / "torch"),
                                  "--device", "cpu"])
    assert _epoch_line_keys(tres["log_dir"]) == \
        _epoch_line_keys(jres["log_dir"])
    assert list(tres["last"]) == list(jres["last"])
    assert all(np.isfinite(v) for v in tres["last"].values())
    jfiles = sorted(f.replace(".msgpack", ".pt")
                    for f in os.listdir(jres["ckpt"].directory))
    assert sorted(os.listdir(tres["ckpt"].directory)) == jfiles
    for name in ("config.json", "hparams.json", "scalars.jsonl", "log.txt"):
        assert os.path.exists(os.path.join(tres["log_dir"], name))
    with open(os.path.join(tres["ckpt"].directory, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["steps"] == [0] and manifest["best_step"] == 0
    # a process launched alone (no torchrun) asking for two ranks
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices"):
        tml.main(ENTRY_ARGV + ["--device", "cpu", "--mesh_data", "2"])


def test_metric_learn_defaults_to_the_card(monkeypatch):
    """``--device`` defaults to cuda, which raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tml.build_argparser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        tml.main(ENTRY_ARGV)
