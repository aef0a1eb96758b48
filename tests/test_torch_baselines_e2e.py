"""The port's end-to-end NCD baselines (``scd_tpu_torch.train.
baselines_e2e`` and ``run_baseline_e2e``) against the JAX package's on the
CPU: the tiny ViT of ``tests/test_baselines_e2e.py`` trained through all
its blocks, from the same parameters (the JAX init, converted and
injected by patching the port's ``baselines._init_params``) and the same
numpy batches.

Each JAX trainer runs once, in a module fixture (its compiles are most of
the time).  Tolerances, with their reasons:
- f32 forward and backward through the trunk (the port's attention and
  its gradient are the plain versions here) and the heads, in another
  order, then six SGD steps with momentum and weight decay: TRAIN_RTOL /
  TRAIN_ATOL on each epoch's loss and on every final parameter;
- the best head, the eval ACC, the predictions and the checkpoint files'
  names and steps: equal (the margins on these separable images are far
  above the f32 differences);
- ``run_baseline_e2e.main`` on the synthetic dataset: the eval lines
  byte-equal.  The augmentation's per-thread generators make draws
  depend on which thread fetches which image, so both mains run with
  ``--num_workers 1``.
"""

import contextlib
import dataclasses
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scd_tpu.metrics.cluster import cluster_acc as jcluster_acc
from scd_tpu.models.vit import ViTConfig as JViTConfig
from scd_tpu.models.vit import VisionTransformer as JVisionTransformer
from scd_tpu.train import baselines as jb
from scd_tpu.train import baselines_e2e as je
from scd_tpu.train import checkpoint as jckpt
from scd_tpu.train import run_baseline_e2e as jrun
from scd_tpu_torch.metrics.cluster import cluster_acc
from scd_tpu_torch.models.params import params_from_flax
from scd_tpu_torch.models.vit import ViTConfig
from scd_tpu_torch.train import baselines as tb
from scd_tpu_torch.train import baselines_e2e as te
from scd_tpu_torch.train import checkpoint as tckpt
from scd_tpu_torch.train import run_baseline_e2e as trun

TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-6
SIZE, N_CLS, N_LAB, N_PER = 16, 4, 2, 12


def _cfgs():
    kw = dict(image_size=SIZE, patch_size=8, width=32, depth=2, heads=4)
    return JViTConfig(**kw), ViTConfig(**kw)


def _jax_vit_cfg(cfg: ViTConfig) -> JViTConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name != "compute_dtype"}
    return JViTConfig(**kw)


_INITS = {}


def jax_e2e_init(model, seed):
    """The JAX trainer's init of ``model`` (a ``UNOModel`` or an
    ``AutoNovelModel``) from PRNGKey(seed), converted and loaded; made
    once per model shape and seed."""
    key = (type(model).__name__, seed,
           tuple((k, tuple(v.shape)) for k, v in model.state_dict().items()))
    if key not in _INITS:
        _INITS[key] = _jax_e2e_params(model, seed)
    model.load_state_dict(_INITS[key])
    return model


def _jax_e2e_params(model, seed):
    jcfg = _jax_vit_cfg(model.backbone.cfg)
    feat_dim = jcfg.output_proj or jcfg.width
    dummy = jnp.zeros((1, jcfg.image_size, jcfg.image_size, 3), jnp.float32)
    feat = jnp.zeros((1, feat_dim), jnp.float32)
    key = jax.random.PRNGKey(seed)

    def protos(m):
        return getattr(m, "Vmap_Head_0").prototypes.shape[-1]

    if isinstance(model, te.UNOModel):
        kb, kh, ko = jax.random.split(key, 3)
        heads = {"heads": (kh, jb.MultiHeadPrototypes(
            num_heads=model.heads.num_heads,
            num_prototypes=protos(model.heads)))}
        if model.heads_over is not None:
            heads["heads_over"] = (ko, jb.MultiHeadPrototypes(
                num_heads=model.heads.num_heads,
                num_prototypes=protos(model.heads_over)))
    else:
        kb, kh = jax.random.split(key)
        n_unlab = model.heads.head2.kernel.shape[1]
        heads = {"heads": (kh, jb.TwoHeadClassifier(
            num_labeled=model.heads.head1.kernel.shape[1] - n_unlab,
            num_unlabeled=n_unlab))}
    params = {"backbone": jax.jit(JVisionTransformer(jcfg).init)(
        kb, dummy)["params"]}
    for name, (k, m) in heads.items():
        params[name] = jax.jit(m.init)(k, feat)["params"]
    return params_from_flax(params)


@pytest.fixture
def jax_inits(monkeypatch):
    monkeypatch.setattr(tb, "_init_params", jax_e2e_init)


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TRAIN_RTOL, atol=TRAIN_ATOL, err_msg=msg)


@pytest.fixture(scope="module")
def img_data():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((N_CLS, SIZE, SIZE, 3)).astype(np.float32)
    imgs = np.concatenate([
        base[c] + 0.25 * rng.standard_normal(
            (N_PER, SIZE, SIZE, 3)).astype(np.float32)
        for c in range(N_CLS)])
    labels = np.repeat(np.arange(N_CLS), N_PER)
    mask_lab = (labels < N_LAB) & (np.arange(len(labels)) % 2 == 0)
    views = np.stack([
        imgs + 0.1 * rng.standard_normal(imgs.shape).astype(np.float32)
        for _ in range(2)])
    return imgs, views, labels, mask_lab


def _uno(mod, init, cfg, data, ckpt, acc, **kw):
    imgs, views, labels, mask_lab = data
    return mod.train_uno_e2e(
        init, views, labels, mask_lab, N_LAB, N_CLS - N_LAB, cfg,
        num_heads=2, epochs=2, batch_size=16, lr=0.05, warmup_epochs=1,
        overcluster_factor=3, seed=1, ckpt=ckpt,
        eval_fn=lambda predict, epoch: {"acc": acc(labels, predict(imgs))},
        **kw)


def _autonovel(mod, init, cfg, data, ckpt, acc, **kw):
    imgs, views, labels, mask_lab = data
    # step_size 2: epoch 0 at lr, epoch 1 at lr * gamma.  lr 0.01: at
    # 0.05 the third step's loss jumps to ~13 and the steps that follow
    # grow a 1e-7 difference of the two packages' f32 sums to ~3e-4 (the
    # ranking-statistics pairs stay equal: a chaotic trajectory, not a
    # different objective)
    return mod.train_autonovel_e2e(
        init, views[0], views[1], labels, mask_lab, N_LAB, N_CLS - N_LAB,
        cfg, epochs=2, batch_size=16, lr=0.01, step_size=2, seed=1,
        ckpt=ckpt,
        eval_fn=lambda predict, epoch: {"acc": acc(labels, predict(imgs))},
        **kw)


TRAINERS = {"uno": _uno, "autonovel": _autonovel}


@pytest.fixture(scope="module")
def jax_runs(img_data, tmp_path_factory):
    """Each JAX trainer once: (state, final parameters as flat Flax names,
    predictions, history, checkpoint directory)."""
    jcfg, _ = _cfgs()
    out = {}
    for name, run in TRAINERS.items():
        d = str(tmp_path_factory.mktemp(f"jax_{name}"))
        ckpt = jckpt.CheckpointManager(d, keep=2, best_metric="acc")
        state, predict, history = run(je, jax.random.PRNGKey(0), jcfg,
                                      img_data, ckpt, jcluster_acc)
        out[name] = (state, params_from_flax(state["params"]),
                     predict(img_data[0]), history, d)
    return out


@pytest.mark.parametrize("name", list(TRAINERS))
def test_e2e_trainer_matches_jax(name, jax_runs, img_data, jax_inits,
                                 tmp_path):
    jstate, jparams, jpreds, jhist, jdir = jax_runs[name]
    _, cfg = _cfgs()
    ckpt = tckpt.CheckpointManager(str(tmp_path), keep=2, best_metric="acc")
    state, predict, history = TRAINERS[name](te, 0, cfg, img_data, ckpt,
                                             cluster_acc, device="cpu")
    assert len(history) == len(jhist) == 2
    for got, want in zip(history, jhist):
        assert list(got) == list(want)
        _close(got["loss"], want["loss"], "loss")
        assert got["acc"] == want["acc"]
        if name == "uno":
            assert got["best_head"] == want["best_head"]
        else:
            assert got["rampup_w"] == want["rampup_w"]
    if name == "uno":
        assert state["best_head"] == jstate["best_head"]
    assert state["best"]["epoch"] == jstate["best"]["epoch"]
    got = state["model"].state_dict()
    assert set(got) == set(jparams)
    for k, w in jparams.items():
        _close(got[k], w, k)
    np.testing.assert_array_equal(predict(img_data[0]), jpreds)
    # every parameter the JAX run moved moved here too (the trunk's blocks,
    # and AutoNovel's head2, which no loss reaches: weight decay alone)
    init = jax_e2e_init(type(state["model"])(
        *_model_args(name, cfg)), 0).state_dict()
    for k, w in jparams.items():
        assert torch.equal(got[k], init[k]) == torch.equal(w, init[k]), k
    assert not torch.equal(got["backbone.block_0.attn.qkv.kernel"],
                           init["backbone.block_0.attn.qkv.kernel"])
    # the checkpoint files: names, steps, best, and the metrics
    jfiles = sorted(f.replace(".msgpack", ".pt") for f in os.listdir(jdir))
    assert sorted(os.listdir(tmp_path)) == jfiles
    for f in jfiles:
        if f.endswith(".json"):
            with open(os.path.join(jdir, f)) as a, \
                    open(os.path.join(tmp_path, f)) as b:
                want_meta, got_meta = json.load(a), json.load(b)
            if f == "manifest.json":
                assert got_meta == want_meta
                continue
            assert got_meta["step"] == want_meta["step"]
            assert list(got_meta["metrics"]) == list(want_meta["metrics"])
            _close([got_meta["metrics"][k] for k in want_meta["metrics"]],
                   list(want_meta["metrics"].values()), f)
    step, blob = ckpt.restore()
    assert step == 1 and set(blob["model"]) == set(jparams)


def _model_args(name, cfg):
    if name == "uno":
        return cfg, 2, N_CLS, N_LAB + (N_CLS - N_LAB) * 3
    return cfg, N_LAB, N_CLS - N_LAB


def test_vision_transformer_with_linear_matches_jax(img_data):
    """``base_vit`` + ``linear`` from the converted Flax tree: the logits
    and the L2-normalised features."""
    from scd_tpu.models.vit import VisionTransformerWithLinear as JVTL
    from scd_tpu_torch.models import VisionTransformerWithLinear

    jcfg, cfg = _cfgs()
    x = img_data[0][:5]
    jm = JVTL(jcfg, num_classes=7)
    params = jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x))
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    tm = VisionTransformerWithLinear(cfg, num_classes=7)
    tm.load_state_dict(params_from_flax(params))  # strict: every name maps
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for g, w in zip(got, want):
        _close(g, w)
    np.testing.assert_allclose(got[1].norm(dim=-1).numpy(), 1.0, rtol=1e-6)


def test_e2e_trainers_refuse_a_mesh(img_data):
    _, cfg = _cfgs()
    for run in TRAINERS.values():
        with pytest.raises(NotImplementedError):
            run(te, 0, cfg, img_data, None, cluster_acc, device="cpu",
                mesh=object())


ENTRY_ARGV = ["--dataset_name", "synthetic", "--vit", "micro",
              "--image_size", "32", "--epochs", "1", "--steps_per_epoch",
              "2", "--batch_size", "16", "--num_workers", "1"]


def _lines(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


def test_run_baseline_e2e_main_prints_the_jax_eval_lines(jax_inits,
                                                         tmp_path):
    method = "uno"  # AutoNovel's CLI branch runs on the card (the smoke)
    argv = ENTRY_ARGV + ["--method", method, "--overcluster_factor", "3"]
    want = _lines(jrun.main, argv + ["--ckpt_dir", str(tmp_path / "j")])
    got = _lines(trun.main, argv + ["--ckpt_dir", str(tmp_path / "t"),
                                    "--device", "cpu"])
    tag = f"Epoch 0, {method}_e2e_v2"
    evals = [ln for ln in got if ln.startswith(tag)]
    assert len(evals) == 1
    assert evals == [ln for ln in want if ln.startswith(tag)]
    epoch = [ln for ln in got if ln.startswith("Epoch 0: ")]
    assert [kv.rsplit(" ", 1)[0] for kv in epoch[0][9:].split(" | ")] == \
        ["loss", "best_head", "acc", "old_acc", "new_acc"]
    assert got[-1].startswith("best: {")
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        f.replace(".msgpack", ".pt") for f in os.listdir(tmp_path / "j"))
    # a process launched alone (no torchrun) asking for two ranks
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices"):
        trun.main(argv + ["--device", "cpu", "--mesh_data", "2"])


def test_run_baseline_e2e_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert trun.build_argparser().parse_args(
        ["--method", "uno"]).device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        trun.main(ENTRY_ARGV + ["--method", "uno"])
