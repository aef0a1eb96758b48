"""The port's ResNet towers (``models/resnet.py``, ``models/resnet50.py``),
``build_encoders``' ``resnet50`` branch and WTA hashing (``ops/wta.py``)
against the JAX package's on the CPU, from the same numpy inputs and the
same parameters.

Tolerances, with their reasons:
- f32 towers: convolutions and GroupNorm statistics summed in another
  order (XLA's against oneDNN's): TOWER_RTOL / TOWER_ATOL;
- bf16 compute: each convolution rounds its output to bf16 (one ulp,
  2^-8 relative) at places the two libraries pick apart, through a few
  blocks: every row's cosine to the JAX package's >= BF16_COS;
- the folded ResNet-50 tree: the same numpy arithmetic, bit-equal;
- ``wta_hash`` given the same indices: bit-equal (first index of a tied
  maximum in both).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scd_tpu.models import resnet as jresnet
from scd_tpu.models import resnet50 as jr50
from scd_tpu.ops import wta as jwta
from scd_tpu_torch.models import resnet as tresnet
from scd_tpu_torch.models import resnet50 as tr50
from scd_tpu_torch.models.params import flax_init_, params_from_flax
from scd_tpu_torch.ops import wta as twta
from scd_tpu_torch.testing.fabricate import resnet50_state_dict

TOWER_RTOL, TOWER_ATOL = 1e-4, 1e-5
BF16_COS = 0.999

_rs = np.random.default_rng(3)


def _row_cos(a, b):
    a = np.asarray(a, np.float64).reshape(len(a), -1)
    b = np.asarray(b, np.float64).reshape(len(b), -1)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


# ----------------------------------------------------------- ResNetTwoHead

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_resnet_two_head_matches_jax(dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = _rs.standard_normal((2, 16, 16, 3)).astype(np.float32)
    jm = jresnet.ResNetTwoHead(num_labeled_classes=3,
                               num_unlabeled_classes=4,
                               num_blocks=(1, 1, 1, 1), dtype=jdt)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    # GroupNorm scales and biases away from (1, 0)
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.05 * _rs.standard_normal(
            v.shape).astype(np.float32), params)
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    tm = tresnet.ResNetTwoHead(3, 4, num_blocks=(1, 1, 1, 1), dtype=tdt)
    tm.load_state_dict(params_from_flax(params))  # strict: names and shapes
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(2, 3), (2, 4), (2, 512)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        if dtype == "f32":
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=TOWER_RTOL, atol=TOWER_ATOL)
        else:
            assert _row_cos(g.numpy(), np.asarray(w, np.float32)).min() \
                >= BF16_COS


def test_group_norm_is_flax_group_norm():
    """Flax's GroupNorm (epsilon 1e-6, E[x^2] - E[x]^2 in f32) on an input
    whose variance (~1e-6) is of the order of epsilon, where torch's
    ``nn.GroupNorm`` (epsilon 1e-5) would be ~2x off."""
    import flax.linen as fnn

    x = (1e-3 * _rs.standard_normal((2, 5, 5, 64))).astype(np.float32)
    jm = fnn.GroupNorm(num_groups=32, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + 0.1 * _rs.standard_normal(
            v.shape).astype(np.float32), params)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    gn = tresnet.GroupNorm(64)
    gn.load_state_dict(params_from_flax(params))
    got = gn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOWER_RTOL,
                               atol=TOWER_ATOL)
    # at unit scale and zero bias, torch's own GroupNorm is ~2x off here
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ratio = (tresnet.GroupNorm(64)(xt).std()
             / torch.nn.GroupNorm(32, 64)(xt).std()).item()
    assert ratio > 1.5


def test_flax_init_on_the_resnet():
    m = flax_init_(tresnet.ResNetTwoHead(3, 4, num_blocks=(1, 1, 1, 1)), 2)
    sd = m.state_dict()
    k = sd["layer2_0.conv2.kernel"]  # [3, 3, 128, 128]: fan_in 1,152
    assert abs(k.std().item() - 1152 ** -0.5) < 0.02 * 1152 ** -0.5
    assert k.abs().max().item() <= 2 * 1152 ** -0.5 / 0.8796256610342398
    assert torch.equal(sd["layer2_0.bn1.scale"], torch.ones(128))
    assert torch.equal(sd["layer2_0.shortcut_norm.bias"], torch.zeros(128))
    assert torch.equal(sd["head1.bias"], torch.zeros(3))


# ---------------------------------------------------------------- ResNet50

TINY = dict(layers=(1, 1, 1, 1), width=8)


def _tiny_sd():
    return resnet50_state_dict(tr50.ResNet50Config(**TINY), seed=4)


def test_load_resnet50_weights_matches_jax():
    sd = _tiny_sd()
    want = jr50.load_resnet50_weights(sd, jr50.ResNet50Config(**TINY))
    got = tr50.load_resnet50_weights(sd, tr50.ResNet50Config(**TINY))
    flat_w, flat_g = params_from_flax(want), params_from_flax(got)
    assert set(flat_g) == set(flat_w)
    assert "layer1_0.down.kernel" in flat_g and not any(
        k.startswith("fc") for k in flat_g)
    for k, w in flat_w.items():
        assert torch.equal(flat_g[k], w), k
    # a BN statistic, the BN of a projection (its conv is there), a conv
    for key in ("layer3.0.bn2.running_var", "layer1.0.downsample.1.weight",
                "conv1.weight"):
        broken = {k: v for k, v in sd.items() if k != key}
        with pytest.raises(KeyError):
            tr50.load_resnet50_weights(broken, tr50.ResNet50Config(**TINY))
        with pytest.raises(KeyError):
            jr50.load_resnet50_weights(broken, jr50.ResNet50Config(**TINY))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_resnet50_matches_jax(dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    sd = _tiny_sd()
    x = _rs.standard_normal((3, 37, 37, 3)).astype(np.float32)  # odd size
    jcfg = jr50.ResNet50Config(**TINY, compute_dtype=jdt)
    want = np.asarray(jax.jit(jr50.ResNet50(jcfg).apply)(
        jr50.load_resnet50_weights(sd, jcfg), jnp.asarray(x)))
    tcfg = tr50.ResNet50Config(**TINY, compute_dtype=tdt)
    tm = tr50.ResNet50(tcfg)
    tm.load_state_dict(params_from_flax(tr50.load_resnet50_weights(sd,
                                                                   tcfg)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (3, 256) and got.dtype == torch.float32
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=TOWER_RTOL,
                                   atol=TOWER_ATOL)
    else:
        assert _row_cos(got.numpy(), want).min() >= BF16_COS


def test_build_encoders_resnet50_branch_matches_jax(tmp_path, monkeypatch):
    """Both packages' ``build_encoders`` with ``feat_model="resnet50"``,
    their ViT-B/16 and ResNet-50 factories swapped for tiny ones: the
    feature encoder (bf16 compute, ImageNet normalisation) on the same
    uint8 images."""
    import dataclasses
    import os

    from test_torch_unsup import _tiny_factories

    from scd_tpu.core import config as J
    from scd_tpu.pipelines.unsup import build_encoders as jbuild
    from scd_tpu_torch.pipelines.unsup import build_encoders as tbuild
    from scd_tpu_torch.testing.fabricate import (clip_state_dict,
                                                 cold_config,
                                                 write_bpe_merges)

    clip_cfg, _ = _tiny_factories(monkeypatch, int8=False)
    for mod, real in (("scd_tpu.models", jr50.ResNet50Config),
                      ("scd_tpu_torch.models", tr50.ResNet50Config)):
        monkeypatch.setattr(
            f"{mod}.ResNet50Config",
            lambda compute_dtype, _real=real: _real(
                **TINY, compute_dtype=compute_dtype))
    tcfg = cold_config(str(tmp_path))
    tcfg = tcfg.replace(feature=dataclasses.replace(
        tcfg.feature, feat_model="resnet50", dense_int8=False))
    os.makedirs(os.path.dirname(tcfg.data.clip_weights))
    os.makedirs(tcfg.data.corpus_dir, exist_ok=True)
    torch.save(clip_state_dict(clip_cfg, 1), tcfg.data.clip_weights)
    torch.save(_tiny_sd(), tcfg.data.dino_weights)
    write_bpe_merges(os.path.join(tcfg.data.corpus_dir,
                                  "bpe_simple_vocab_16e6.txt.gz"), 1)
    jcfg = J.PipelineConfig(
        data=J.DataConfig(**dataclasses.asdict(tcfg.data)),
        feature=J.FeatureConfig(**dataclasses.asdict(tcfg.feature)),
        cluster=J.ClusterConfig(**dataclasses.asdict(tcfg.cluster)),
        naming=J.NamingConfig(**dataclasses.asdict(tcfg.naming)))
    images = _rs.integers(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    want = jbuild(jcfg, {})[0](images)
    got = tbuild(tcfg, {}, device="cpu")[0](images)
    assert got.shape == want.shape == (4, 256)
    assert _row_cos(got, want).min() >= BF16_COS


# --------------------------------------------------------------------- WTA

def test_wta_hash_is_bit_equal_given_the_same_windows():
    feats = _rs.standard_normal((9, 40)).astype(np.float32)
    feats[4] = 1.0  # every window tied: the first position wins
    feats[5, ::2] = 2.0
    idx = np.array(jwta.structured_hash_idx(jax.random.PRNGKey(1), 40, 16,
                                            6))
    want = np.asarray(jwta.wta_hash(jnp.asarray(feats), jnp.asarray(idx)))
    got = twta.wta_hash(torch.from_numpy(feats), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool((got[4] == 0).all())


def test_structured_hash_idx_properties():
    g = torch.Generator().manual_seed(5)
    idx = twta.structured_hash_idx(g, 50, 32, 7)
    assert idx.shape == (32, 7) and idx.dtype == torch.int64
    assert int(idx.min()) >= 0 and int(idx.max()) < 50
    assert all(len(set(row.tolist())) == 7 for row in idx)
    again = twta.structured_hash_idx(torch.Generator().manual_seed(5), 50,
                                     32, 7)
    assert torch.equal(idx, again)
    other = twta.structured_hash_idx(torch.Generator().manual_seed(6), 50,
                                     32, 7)
    assert not torch.equal(idx, other)
    assert len({tuple(r) for r in idx.tolist()}) > 1  # rows independent
    full = twta.structured_hash_idx(torch.Generator().manual_seed(0), 12, 3,
                                    12)
    for row in full:
        assert sorted(row.tolist()) == list(range(12))  # a permutation
    with pytest.raises(ValueError):
        twta.structured_hash_idx(g, 5, 2, 6)


def test_hash_transform():
    feats = torch.from_numpy(_rs.standard_normal((6, 24)).astype(np.float32))
    codes = twta.hash_transform(torch.Generator().manual_seed(2), feats, 10,
                                4)
    idx = twta.structured_hash_idx(torch.Generator().manual_seed(2), 24, 10,
                                   4)
    assert torch.equal(codes, twta.wta_hash(feats, idx))
    assert codes.shape == (6, 10) and int(codes.max()) < 4
    # monotone rescaling of the features leaves the codes unchanged
    assert torch.equal(codes, twta.wta_hash(3.0 * feats + 1.0, idx))
    with pytest.raises(ValueError):
        twta.hash_transform(torch.Generator(), feats[0], 10, 4)
