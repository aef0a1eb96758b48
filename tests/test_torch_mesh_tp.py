"""Tensor parallelism in the trainers over gloo ranks on the CPU: GCD at
``data`` 1 x ``model`` 2 and at 2 x 2, with ``--remat`` and
``--int8_frozen``, the shard layout, a tensor-parallel checkpoint, and
``metric_learn`` / ``run_baseline_e2e`` with ``--mesh_model``.  The
end-to-end UNO and AutoNovel trainers at 1 x 2 are held to the JAX
package in ``tests/test_torch_mesh_train.py``, whose world already runs
beside the JAX single-device runs they are compared with.

Two worlds (2 and 4 ranks) and a world of one (the port's one-process
references) run ``scd_tpu_torch.testing.mesh_cases.tp_cases``
(``testing/dist.py::spawn``) while the JAX side compiles and runs its
dp+tp step in this process, on the conftest's virtual CPU devices.
Every model is a ViT of width 64, depth 2, 2 heads at 32 px (patch 8),
as ``tests/test_torch_mesh_train.py`` sizes it.

Parity contract, with the tolerances' reasons:
- GCD: two f32 steps from ``scd_tpu.train.gcd.make_gcd_state``'s
  parameters (``params_from_flax``) against the port's one process and
  against the JAX package's own dp+tp step (``make_gcd_state(mesh=
  make_mesh(MeshConfig(data=1, model=2)))``) on the same global batches:
  each step's loss within LOSS_RTOL (the same f32 arithmetic; only the
  partial products of the row-parallel layers and the input gradients
  of the column-parallel ones add in another order), every trainable
  parameter's update at cosine >= UPDATE_COS and its norm within
  NORM_RTOL of the one process's; the ranks' gathered parameters
  bitwise equal after every step (the replicated parameters are each
  rank's own copy); each rank holding exactly 1 / tp of qkv, proj, fc1,
  fc2 and the head's fc1 / fc2, the packed qkv by heads;
- ``--remat`` (the recompute re-runs the forward's collectives) and
  ``--int8_frozen`` (the W8A8 chain on the column shards): one step's
  loss within LOSS_RTOL of the one process's, the ranks equal;
- the shard -> gather round trip and a tensor-parallel checkpoint
  restored in one process: bit-exact;
- the entry points with ``--mesh_model 2``: exit normally, rank 0 alone
  prints and writes the run.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scd_tpu.core.config import MeshConfig as JMeshConfig
from scd_tpu.core.config import TrainConfig as JTrainConfig
from scd_tpu.core.mesh import make_mesh as jmake_mesh
from scd_tpu.models.vit import ViTConfig as JViTConfig
from scd_tpu.train import gcd as jgcd
from scd_tpu_torch.models.params import (params_from_flax, shard_tensor,
                                         tp_layout, unshard_tensor)
from scd_tpu_torch.testing.dist import spawn

LOSS_RTOL, UPDATE_COS, NORM_RTOL = 1e-5, 0.9999, 1e-3
VIT = dict(image_size=32, patch_size=8, width=64, depth=2, heads=2)
TRAIN = dict(grad_from_block=1, proj_dim=64, batch_size=8, lr=0.1)
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
ENTRY = ["--dataset_name", "synthetic", "--vit", "micro", "--image_size",
         "32", "--epochs", "1", "--steps_per_epoch", "2", "--num_workers",
         "1"]
# the tensor-parallel parameters of the tiny GCD model, by name
TP_NAMES = [f"backbone.block_{i}.{m}.{k}" for i in range(2)
            for m in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")
            for k in ("kernel", "bias")
            if not (k == "bias" and m in ("attn.proj", "mlp.fc2"))] + [
    "head.fc1.kernel", "head.fc1.bias", "head.fc2.kernel"]


def _gcd_batches():
    rng = np.random.default_rng(11)
    b = TRAIN["batch_size"]
    return [{"images": rng.standard_normal((2 * b, 32, 32, 3)).astype(
                np.float32),
             "labels": rng.integers(0, 3, b).astype(np.int64),
             "mask_lab": rng.random(b) < 0.5} for _ in range(2)]


def _numpy(tree):
    return {k: v.numpy() for k, v in params_from_flax(tree).items()}


def _jax_tp_steps(batches, data, model):
    """The JAX package's dp+tp GCD steps on its virtual CPU mesh: each
    step's loss and the parameters after the last."""
    params, opt_state, step = jgcd.make_gcd_state(
        JViTConfig(**VIT), JTrainConfig(**TRAIN), jax.random.PRNGKey(0),
        total_steps=10, mesh=jmake_mesh(JMeshConfig(data=data, model=model)))
    losses = []
    for batch in batches:
        params, opt_state, metrics = step(
            params, opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    return losses, _numpy(jax.device_get(params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two worlds and a world of one (the port's one-process
    references: no mesh), and, while they run, the JAX dp+tp steps."""
    from concurrent.futures import ThreadPoolExecutor

    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual CPU mesh (2 devices or more)")
    tmp = tmp_path_factory.mktemp("mesh_tp")
    params, _o, _s = jgcd.make_gcd_state(
        JViTConfig(**VIT), JTrainConfig(**TRAIN), jax.random.PRNGKey(0),
        total_steps=10)
    p0 = _numpy(params)
    gcd = {"vit": VIT, "train": TRAIN, "total_steps": 10, "params": p0,
           "batches": _gcd_batches(), "global_batch": TRAIN["batch_size"],
           "steps": 2, "return_params": True}
    one_step = dict(gcd, steps=1, return_params=False)
    steps = {"remat": dict(one_step, vit=dict(VIT, remat=True)),
             "int8": dict(one_step, train=dict(TRAIN, int8_frozen=True))}
    worlds = {
        "single": (1, {"model": 2, "steps": dict(steps, gcd=gcd)}),
        "1x2": (2, {"model": 2, "steps": dict(steps, gcd=dict(
            gcd, return_shards=True, ckpt_dir=str(tmp / "ckpt"))),
            "run_baseline_e2e": ENTRY + ["--method", "uno", "--batch_size",
                                         "16"]}),
        "2x2": (4, {"model": 2, "steps": {"gcd": dict(gcd,
                                                      return_shards=True)},
                    "metric_learn": ENTRY + [
                        "--batch_size", "16", "--proj_dim", "64",
                        "--exp_root", str(tmp / "ml")]})}
    with ThreadPoolExecutor(len(worlds)) as pool:
        futures = {name: pool.submit(
            spawn, "scd_tpu_torch.testing.mesh_cases.tp_cases", world=world,
            args=(data,), timeout=300, collective_timeout=240)
            for name, (world, data) in worlds.items()}
        jax_gcd = _jax_tp_steps(gcd["batches"], 1, 2)
        ranks = {name: f.result() for name, f in futures.items()}
    ranks = {name: [r["steps"] | r for r in got]
             for name, got in ranks.items()}
    return {"ranks": ranks, "p0": p0, "single": ranks.pop("single")[0],
            "tmp": tmp, "jax": jax_gcd}


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gcd_tp_steps_match_one_process_and_jax(runs, mesh):
    ranks, single = runs["ranks"][mesh], runs["single"]["gcd"]
    jloss, jparams = runs["jax"]
    p0 = runs["p0"]
    for rank in ranks:
        got = rank["gcd"]
        np.testing.assert_allclose(got["losses"], single["losses"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"], jloss, rtol=LOSS_RTOL)
        # the gathered parameters: the replicated ones are bitwise equal
        assert got["digests"] == ranks[0]["gcd"]["digests"]
    got = ranks[0]["gcd"]["params"]
    assert set(got) == set(single["params"])
    for name, v in got.items():
        du, dw = v - p0[name], single["params"][name] - p0[name]
        assert _cos(du, dw) >= UPDATE_COS, name
        assert _cos(du, jparams[name] - p0[name]) >= UPDATE_COS, name
        assert np.linalg.norm(du) == pytest.approx(np.linalg.norm(dw),
                                                   rel=NORM_RTOL), name


@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_rank_holds_its_shard(runs, mesh):
    """1 / tp of every tensor-parallel parameter, the packed qkv as
    ``[q | k | v]`` of the rank's own heads; the frozen block's shards
    are cut from the initial parameters, the trained ones from the
    gathered final parameters."""
    ranks = runs["ranks"][mesh]
    full = dict(runs["p0"], **ranks[0]["gcd"]["params"])
    n_model = MESHES[mesh][1]
    whole = sum(full[k].nbytes for k in TP_NAMES)
    w, d = VIT["width"], VIT["width"] // VIT["heads"]
    for r, rank in enumerate(ranks):
        index = r % n_model  # the mesh is data-major
        shards = rank["gcd"]["shards"]
        assert sorted(shards) == sorted(TP_NAMES)
        assert rank["gcd"]["tp_bytes"] * n_model == whole
        for name in TP_NAMES:
            want = shard_tensor(name, torch.from_numpy(full[name]), n_model,
                                index).numpy()
            np.testing.assert_array_equal(shards[name], want, err_msg=name)
        # head-aligned, built here column by column: rank i's heads of q,
        # then of k, then of v
        for b in range(2):
            qkv = full[f"backbone.block_{b}.attn.qkv.kernel"]
            heads = VIT["heads"] // n_model
            cols = [part * w + h * d + j for part in range(3)
                    for h in range(index * heads, (index + 1) * heads)
                    for j in range(d)]
            np.testing.assert_array_equal(
                shards[f"backbone.block_{b}.attn.qkv.kernel"], qkv[:, cols])


def test_shard_gather_round_trip_is_exact(runs):
    """Every parameter of JAX's GCD tree, cut for each of 2 ranks and put
    back: the same bits; the layouts by name follow ``_tp_spec``."""
    for name, v in runs["p0"].items():
        t = torch.from_numpy(v)
        for size in (2, 4):
            if tp_layout(name, t.shape) == "qkv" and VIT["heads"] % size:
                continue
            parts = [shard_tensor(name, t, size, i) for i in range(size)]
            back = unshard_tensor(name, parts)
            assert back.dtype == t.dtype and torch.equal(back, t), name
    layouts = {n: tp_layout(n, runs["p0"][n].shape) for n in runs["p0"]}
    assert {n for n, k in layouts.items() if k} == set(TP_NAMES)
    assert layouts["head.fc2.bias"] is None
    assert layouts["head.fc3.kernel"] is None
    assert layouts["head.last_layer"] is None
    # the stacked UNO heads stay whole: a [H, in, out] kernel, [H, F] bias
    assert tp_layout("heads.Vmap_Head_0.fc1.kernel", (2, 64, 32)) is None
    assert tp_layout("heads.Vmap_Head_0.fc1.bias", (2, 32)) is None


def test_tp_checkpoint_restores_in_one_process(runs):
    """Rank 0's ``ckpt_<step>.pt`` of the 1 x 2 run holds full tensors:
    restored on every rank of the run and gathered again it is the same
    bits, and restored in one process its parameters are the run's
    gathered parameters and its momentum whole."""
    from scd_tpu_torch.core.config import TrainConfig
    from scd_tpu_torch.models.vit import ViTConfig
    from scd_tpu_torch.train.checkpoint import CheckpointManager
    from scd_tpu_torch.train.gcd import GCDTrainer

    ranks = runs["ranks"]["1x2"]
    for rank in ranks:
        assert rank["gcd"]["ckpt"] == {"step": 2, "equal": True}
    step, state = CheckpointManager(str(runs["tmp"] / "ckpt")).restore()
    assert step == 2
    tr = GCDTrainer(ViTConfig(**VIT), TrainConfig(**TRAIN), total_steps=10,
                    device="cpu", params={k: torch.from_numpy(v)
                                          for k, v in runs["p0"].items()})
    tr.load_state(state)
    got = ranks[0]["gcd"]["params"]
    trained = {n: p for n, p in tr.model.named_parameters()
               if p.requires_grad}
    assert set(trained) == set(got)
    for name, p in trained.items():
        np.testing.assert_array_equal(p.detach().numpy(), got[name],
                                      err_msg=name)
    momentum = tr.opt.sgd.state_dict()["state"]
    for i, p in enumerate(trained.values()):
        assert momentum[i]["momentum_buffer"].shape == p.shape


@pytest.mark.parametrize("case", ["remat", "int8"])
def test_remat_and_int8_frozen_under_tp(runs, case):
    ranks = runs["ranks"]["1x2"]
    for rank in ranks:
        np.testing.assert_allclose(rank[case]["losses"],
                                   runs["single"][case]["losses"],
                                   rtol=LOSS_RTOL)
        assert rank[case]["digests"] == ranks[0][case]["digests"]


@pytest.mark.parametrize("entry", ["metric_learn", "run_baseline_e2e"])
def test_entry_points_with_mesh_model(runs, entry):
    """``metric_learn`` at ``--mesh_data 2 --mesh_model 2`` (4 ranks) and
    ``run_baseline_e2e --method uno`` at ``--mesh_model 2``: normal
    exits, one run written and printed, by rank 0."""
    if entry == "metric_learn":
        got = [rank["metric_learn"] for rank in runs["ranks"]["2x2"]]
        assert len({g["log_dir"] for g in got}) == 1
        assert os.listdir(runs["tmp"] / "ml" / "metric_learn" / "log") == [
            os.path.basename(got[0]["log_dir"])]
        assert "ckpt_0.pt" in got[0]["files"]
        assert all(g["last"] == got[0]["last"] for g in got)
        assert all(np.isfinite(v) for v in got[0]["last"].values())
        assert all(g["lines"] == [] for g in got[1:])
        return
    lines = [rank["run_baseline_e2e"] for rank in runs["ranks"]["1x2"]]
    assert lines[1] == []
    assert sum(ln.startswith("Epoch 0, uno_e2e_v2") for ln in lines[0]) == 1
    assert lines[0][-1].startswith("best: {")


def test_model_axis_must_divide_the_heads():
    """A ``model`` axis that does not divide the heads (or a width) is
    refused when the model is built, before any collective."""
    from scd_tpu_torch.core.mesh import ModelGroup
    from scd_tpu_torch.models.vit import ViTConfig, VisionTransformer

    cfg = ViTConfig(**dict(VIT, heads=2))
    with pytest.raises(ValueError, match="head count 2 does not split "
                                         "over the 3 ranks"):
        VisionTransformer(cfg, tp=ModelGroup(None, 3, 0))
