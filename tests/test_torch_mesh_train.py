"""Data-parallel training over 2 gloo ranks on the CPU: GCD steps
(``make_gcd_state`` through ``GCDTrainer``), the end-to-end UNO and
AutoNovel trainers, ``metric_learn.main`` and ``run_baseline_e2e.main``
with ``--mesh_data``, and the same world as ``data`` 1 x ``model`` 2
(tensor parallelism: a GCD step, the e2e trainers, ``metric_learn``;
``tests/test_torch_mesh_tp.py`` holds the GCD steps to the JAX
package's dp+tp step).

One world runs ``scd_tpu_torch.testing.mesh_cases.train_cases``
(``testing/dist.py::spawn``) while the JAX side compiles and runs its
single-device references in this process.  Every model is a ViT of width
64, depth 2 at 32 px (patch 8).

Parity contract, with the tolerances' reasons:
- GCD: two f32 steps over 2 ranks from ``scd_tpu.train.gcd.
  make_gcd_state``'s parameters (``params_from_flax``) against the port's
  one process and against the JAX step on the same global batches: each
  step's loss within LOSS_RTOL (the same arithmetic; the gathered
  projections reach the losses in the one process's order, and only the
  per-rank parameter gradients add in another order), every trainable
  parameter's update at cosine >= UPDATE_COS and its norm within 1e-3
  of the one process's (a gradient W times too large fails); the two
  ranks' parameters
  bitwise equal after every step (the summed gradients are the same bits
  on both);
- UNO and AutoNovel: each epoch's loss over 2 ranks within E2E_RTOL of the
  JAX single-device run from the same parameters and the best head equal
  (``tests/test_baselines_e2e.py``'s own contract for its mesh runs),
  as data parallel (``data`` 2) and as tensor parallel (``model`` 2);
- the entry points with ``--mesh_data 2``: exit normally, rank 0 alone
  prints and writes the run directory and the checkpoints, the ranks end
  on the same metrics; ``run_baseline_e2e`` prints the JAX CLI's batch
  rounding line;
- a mesh of ``data`` 1 x ``model`` 2 (it raised the tensor-parallel
  refusal before tensor parallelism was ported): one GCD step's loss
  within LOSS_RTOL of the one process's and the ranks' gathered
  parameters equal; ``metric_learn.main --mesh_model 2`` exits normally
  and rank 0 alone writes the run;
- ``_mesh_batch_size`` rounds and raises as the JAX package's.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scd_tpu.core.config import TrainConfig as JTrainConfig
from scd_tpu.models.vit import ViTConfig as JViTConfig
from scd_tpu.models.vit import VisionTransformer as JVisionTransformer
from scd_tpu.train import baselines as jb
from scd_tpu.train import baselines_e2e as je
from scd_tpu.train import gcd as jgcd
from scd_tpu_torch.models.params import params_from_flax
from scd_tpu_torch.testing.dist import spawn

LOSS_RTOL, UPDATE_COS, E2E_RTOL = 1e-5, 0.9999, 2e-4
VIT = dict(image_size=32, patch_size=8, width=64, depth=2, heads=2)
TRAIN = dict(grad_from_block=1, proj_dim=64, batch_size=8, lr=0.1)
N_CLS, N_LAB, N_PER = 4, 2, 8
ENTRY = ["--dataset_name", "synthetic", "--vit", "micro", "--image_size",
         "32", "--epochs", "1", "--steps_per_epoch", "2", "--num_workers",
         "1"]


def _gcd_batches():
    rng = np.random.default_rng(11)
    b = TRAIN["batch_size"]
    return [{"images": rng.standard_normal((2 * b, 32, 32, 3)).astype(
                np.float32),
             "labels": rng.integers(0, 3, b).astype(np.int64),
             "mask_lab": rng.random(b) < 0.5} for _ in range(2)]


def _img_data():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((N_CLS, 32, 32, 3)).astype(np.float32)
    imgs = np.concatenate([
        base[c] + 0.25 * rng.standard_normal((N_PER, 32, 32, 3)).astype(
            np.float32) for c in range(N_CLS)])
    labels = np.repeat(np.arange(N_CLS), N_PER)
    mask = (labels < N_LAB) & (np.arange(len(labels)) % 2 == 0)
    views = np.stack([imgs + 0.1 * rng.standard_normal(imgs.shape).astype(
        np.float32) for _ in range(2)])
    return views, labels, mask


E2E_KW = {"uno": dict(epochs=2, batch_size=16, lr=0.05, warmup_epochs=1),
          "autonovel": dict(epochs=2, batch_size=16, lr=0.05)}


def _jax_e2e_inits():
    """Each JAX trainer's initial parameters (its own key splits), as the
    port's state dicts."""
    cfg = JViTConfig(**VIT)
    dummy = jnp.zeros((1, 32, 32, 3), jnp.float32)
    feat = jnp.zeros((1, VIT["width"]), jnp.float32)
    # jitted, as the trainers init: one compile instead of eager ops
    backbone = jax.jit(JVisionTransformer(cfg).init)
    kb, kh, _ko = jax.random.split(jax.random.PRNGKey(0), 3)
    uno = {"backbone": backbone(kb, dummy)["params"],
           "heads": jax.jit(jb.MultiHeadPrototypes(
               num_heads=2, num_prototypes=N_CLS).init)(kh, feat)["params"]}
    kb, kh = jax.random.split(jax.random.PRNGKey(1))
    an = {"backbone": backbone(kb, dummy)["params"],
          "heads": jax.jit(jb.TwoHeadClassifier(
              num_labeled=N_LAB, num_unlabeled=N_CLS - N_LAB).init)(
                  kh, feat)["params"]}
    return {k: {n: v.numpy() for n, v in params_from_flax(p).items()}
            for k, p in (("uno", uno), ("autonovel", an))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank world and, while it runs, the JAX references and the
    port's one-process GCD steps."""
    from concurrent.futures import ThreadPoolExecutor

    from scd_tpu_torch.testing import mesh_cases

    tmp = tmp_path_factory.mktemp("mesh_train")
    params, opt_state, step = jgcd.make_gcd_state(
        JViTConfig(**VIT), JTrainConfig(**TRAIN), jax.random.PRNGKey(0),
        total_steps=10)
    p0 = {k: v.numpy() for k, v in params_from_flax(params).items()}
    views, labels, mask = _img_data()
    gcd = {"vit": VIT, "train": TRAIN, "total_steps": 10, "params": p0,
           "batches": _gcd_batches(), "global_batch": TRAIN["batch_size"],
           "steps": 2, "return_params": True}
    e2e = {"vit": VIT, "views": views, "labels": labels, "mask_lab": mask,
           "n_labeled": N_LAB, "num_heads": 2, "kw": E2E_KW,
           "inits": _jax_e2e_inits()}
    data = {"gcd": gcd, "e2e": e2e,
            "metric_learn": ENTRY + ["--batch_size", "16", "--proj_dim",
                                     "64", "--exp_root", str(tmp / "ml")],
            "metric_learn_tp": ENTRY + ["--batch_size", "16", "--proj_dim",
                                        "64", "--exp_root",
                                        str(tmp / "ml_tp")],
            "run_baseline_e2e": ENTRY + ["--method", "uno", "--batch_size",
                                         "15"]}
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn,
                            "scd_tpu_torch.testing.mesh_cases.train_cases",
                            world=2, args=(data,), timeout=150,
                            collective_timeout=120)
        jax_gcd = []
        for batch in gcd["batches"]:
            params, opt_state, metrics = step(
                params, opt_state, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
            jax_gcd.append(float(metrics["loss"]))
        jax_params = {k: v.numpy() for k, v in params_from_flax(
            params).items()}
        jkey = jax.random.PRNGKey
        _s, _p, uno = je.train_uno_e2e(
            jkey(0), views, labels, mask, N_LAB, N_CLS - N_LAB,
            JViTConfig(**VIT), num_heads=2, **E2E_KW["uno"])
        _s, _p, an = je.train_autonovel_e2e(
            jkey(1), views[0], views[1], labels, mask, N_LAB, N_CLS - N_LAB,
            JViTConfig(**VIT), **E2E_KW["autonovel"])
        single = mesh_cases.gcd_steps(gcd)
        return {"ranks": world.result(), "p0": p0, "single": single,
                "jax": {"gcd": (jax_gcd, jax_params), "uno": uno,
                        "autonovel": an}, "tmp": tmp}


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_gcd_steps_over_ranks_match_one_process_and_jax(runs):
    ranks, single = runs["ranks"], runs["single"]
    jloss, jparams = runs["jax"]["gcd"]
    p0 = runs["p0"]
    for rank in ranks:
        got = rank["gcd"]
        np.testing.assert_allclose(got["losses"], single["losses"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["losses"], jloss, rtol=LOSS_RTOL)
        assert got["digests"] == ranks[0]["gcd"]["digests"]
    # rank 0 returns its parameters; the digests hold rank 1 to the same
    got = ranks[0]["gcd"]["params"]
    assert set(got) == set(single["params"])
    for name, v in got.items():
        du, dw = v - p0[name], single["params"][name] - p0[name]
        assert _cos(du, dw) >= UPDATE_COS, name
        assert _cos(du, jparams[name] - p0[name]) >= UPDATE_COS, name
        # the summed gradient is the one process's, not W times it
        assert np.linalg.norm(du) == pytest.approx(np.linalg.norm(dw),
                                                   rel=1e-3), name


def _e2e_matches_jax(runs, method, tp):
    want = runs["jax"][method]
    for rank in runs["ranks"]:
        got = (rank["tp"] if tp else rank)["e2e"][method]
        assert len(got["history"]) == len(want) == 2
        for hg, hw in zip(got["history"], want):
            np.testing.assert_allclose(hg["loss"], hw["loss"], rtol=E2E_RTOL)
            if method == "uno":
                assert hg["best_head"] == hw["best_head"]
        assert got["preds"].shape == (N_CLS * N_PER,)
        assert got["preds"].max() < N_CLS
        first = runs["ranks"][0]
        np.testing.assert_array_equal(
            got["preds"], (first["tp"] if tp else first)["e2e"][method][
                "preds"])


@pytest.mark.parametrize("method", ["uno", "autonovel"])
def test_e2e_trainers_over_ranks_match_jax(runs, method):
    _e2e_matches_jax(runs, method, tp=False)


@pytest.mark.parametrize("method", ["uno", "autonovel"])
def test_e2e_trainers_tensor_parallel_match_jax(runs, method):
    """``data`` 1 x ``model`` 2: each rank holds half the backbone's
    tensor-parallel parameters and both run every row."""
    _e2e_matches_jax(runs, method, tp=True)


def test_metric_learn_over_ranks_writes_once(runs):
    r0, r1 = (rank["metric_learn"] for rank in runs["ranks"])
    assert r0["log_dir"] == r1["log_dir"]
    assert os.listdir(runs["tmp"] / "ml" / "metric_learn" / "log") == [
        os.path.basename(r0["log_dir"])]
    assert r0["files"] == ["ckpt_0.json", "ckpt_0.pt", "ckpt_best.json",
                           "ckpt_best.pt", "manifest.json"]
    assert r0["last"] == r1["last"]
    assert all(np.isfinite(v) for v in r0["last"].values())
    with open(os.path.join(r0["log_dir"], "log.txt")) as f:
        assert sum("Epoch 0:" in ln for ln in f) == 1


def test_run_baseline_e2e_over_ranks_prints_once(runs):
    lines0, lines1 = (rank["run_baseline_e2e"] for rank in runs["ranks"])
    assert lines1 == []
    assert lines0[0] == ("[e2e] batch_size rounded to 14 (must split evenly "
                         "over the 2-way data axis)")
    assert sum(ln.startswith("Epoch 0, uno_e2e_v2") for ln in lines0) == 1
    assert lines0[-1].startswith("best: {")


@pytest.mark.parametrize("path", ["make_gcd_state", "metric_learn"])
def test_model_axis_raises_the_tensor_parallel_refusal(runs, path):
    """Named for the refusal these paths gave a ``model`` axis before
    tensor parallelism was ported; at ``data`` 1 x ``model`` 2 they now
    train: the GCD step as the one process's, ``metric_learn`` with rank
    0 alone writing."""
    ranks = [rank["tp"][path] for rank in runs["ranks"]]
    if path == "make_gcd_state":
        for got in ranks:
            np.testing.assert_allclose(got["losses"],
                                       runs["single"]["losses"][:1],
                                       rtol=LOSS_RTOL)
            assert got["digests"] == ranks[0]["digests"]
        return
    r0, r1 = ranks
    assert r0["log_dir"] == r1["log_dir"]
    assert os.listdir(runs["tmp"] / "ml_tp" / "metric_learn" / "log") == [
        os.path.basename(r0["log_dir"])]
    assert "ckpt_0.pt" in r0["files"]
    assert r0["last"] == r1["last"]
    assert all(np.isfinite(v) for v in r0["last"].values())


def test_mesh_batch_size_rounds_and_raises_as_jax():
    from scd_tpu_torch.train.baselines_e2e import _mesh_batch_size

    for b, d, n in ((64, 4, 1000), (30, 4, 1000), (64, 8, 50), (7, 1, 5)):
        mesh = types.SimpleNamespace(n_data=d)
        jmesh = types.SimpleNamespace(shape={"data": d})
        assert _mesh_batch_size(b, mesh, n) == je._mesh_batch_size(b, jmesh,
                                                                   n)
    assert _mesh_batch_size(30, None, 20) == je._mesh_batch_size(30, None, 20)
    for fn, mesh in ((_mesh_batch_size, types.SimpleNamespace(n_data=8)),
                     (je._mesh_batch_size,
                      types.SimpleNamespace(shape={"data": 8}))):
        with pytest.raises(ValueError,
                           match="batch_size 5 < data-axis size 8"):
            fn(5, mesh, 100)
