"""The port's towers, tokenizer and vocabulary builder against the JAX
package's, on the CPU.

- f32 towers on the golden state dicts (``tests/golden/*.npz``, the exact
  OpenAI CLIP and DINO key layouts): each package's loader, then the
  port's outputs against the Flax modules' and the goldens' at atol 1e-4
  (f32 sums in another order).
- int8 towers (width 128, depth 2) on random state dicts: the port's CPU
  chain and the JAX package's off-TPU chain quantize the same f32 inputs,
  so features agree to a cosine >= 0.9999 (an input exactly on a rounding
  boundary may round the other way in one package).
- ``params_from_flax`` on a Flax-initialised tree; ``interpolate_pos_embed``
  and a whole tower at off-grid sizes (``jax.image.resize`` bicubic
  semantics) at atol 1e-5.
- The tokenizer on a fabricated merges file: equal ids.
- ``build_zeroshot_weights``: the plain, the batched ungrouped and the
  batched grouped (length-sorted) builds on a deterministic text encoder,
  at atol 1e-6.
"""

import os

import numpy as np
import pytest
import torch

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
IMG, PATCH, VW, VHEADS, DEPTH = 16, 8, 32, 2, 2
EMBED = 16
VOCAB, CTX, TW, THEADS = 64, 12, 32, 2


def _sd(z):
    return {k[len("sd."):]: z[k] for k in z.files if k.startswith("sd.")}


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def _clip_cfgs(width=VW, depth=DEPTH, heads=VHEADS, image=IMG, patch=PATCH,
               embed=EMBED, vocab=VOCAB, ctx=CTX, tw=TW, theads=THEADS,
               int8=False):
    from scd_tpu.models import clip as jclip
    from scd_tpu.models import vit as jvit
    from scd_tpu_torch.models import clip as tclip
    from scd_tpu_torch.models import vit as tvit

    out = []
    for vit_mod, clip_mod in ((jvit, jclip), (tvit, tclip)):
        out.append(clip_mod.CLIPConfig(
            vision=vit_mod.ViTConfig(
                image_size=image, patch_size=patch, width=width, depth=depth,
                heads=heads, quick_gelu=True, pre_post_norm=True,
                output_proj=embed, patch_bias=False, norm_eps=1e-5,
                dense_int8=int8),
            vocab_size=vocab, context_length=ctx, text_width=tw,
            text_depth=depth, text_heads=theads, embed_dim=embed))
    return out


def _port_clip(tcfg, tree):
    from scd_tpu_torch.models import CLIPModel, params_from_flax

    model = CLIPModel(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(tree))
    return model.eval()


@pytest.fixture(scope="module")
def clip_golden():
    import jax
    import jax.numpy as jnp

    from scd_tpu.models.clip import CLIPModel, load_openai_clip_weights
    from scd_tpu_torch.models import clip as tclip

    z = np.load(os.path.join(GOLDEN, "clip_tiny.npz"))
    jcfg, tcfg = _clip_cfgs()
    jvars = load_openai_clip_weights(_sd(z), jcfg)
    model = CLIPModel(jcfg)
    jimg = jax.jit(lambda v, x: model.apply(
        v, x, method=CLIPModel.encode_image))(jvars,
                                              jnp.asarray(z["images_nhwc"]))
    jtxt = jax.jit(lambda v, t: model.apply(
        v, t, method=CLIPModel.encode_text))(jvars, jnp.asarray(z["tokens"]))
    port = _port_clip(tcfg, tclip.load_openai_clip_weights(
        {k: torch.from_numpy(v) for k, v in _sd(z).items()}, tcfg))
    return z, np.asarray(jimg), np.asarray(jtxt), port


def test_clip_towers_match_flax_and_goldens(clip_golden):
    z, jimg, jtxt, port = clip_golden
    with torch.no_grad():
        img = port.encode_image(torch.from_numpy(z["images_nhwc"])).numpy()
        txt = port.encode_text(torch.from_numpy(z["tokens"])).numpy()
    np.testing.assert_allclose(img, jimg, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(img, z["expected_image_feats"], atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(txt, jtxt, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(txt, z["expected_text_feats"], atol=1e-4,
                               rtol=1e-4)


def test_dino_tower_matches_flax_and_goldens():
    import jax.numpy as jnp

    from scd_tpu.models.dino import load_dino_weights as jload
    from scd_tpu.models.vit import ViTConfig as JCfg
    from scd_tpu.models.vit import VisionTransformer as JViT
    from scd_tpu_torch.models import VisionTransformer, params_from_flax
    from scd_tpu_torch.models.dino import load_dino_weights
    from scd_tpu_torch.models.vit import ViTConfig

    z = np.load(os.path.join(GOLDEN, "dino_tiny.npz"))
    kw = dict(image_size=IMG, patch_size=PATCH, width=VW, depth=DEPTH,
              heads=VHEADS, quick_gelu=False, pre_post_norm=False,
              output_proj=None, patch_bias=True)
    jvars = jload(_sd(z), JCfg(**kw))
    want = np.asarray(JViT(JCfg(**kw)).apply(jvars,
                                             jnp.asarray(z["images_nhwc"])))
    port = VisionTransformer(ViTConfig(**kw))
    port.load_state_dict(params_from_flax(load_dino_weights(_sd(z),
                                                            ViTConfig(**kw))))
    with torch.no_grad():
        got = port(torch.from_numpy(z["images_nhwc"])).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, z["expected_feats"], atol=1e-4,
                               rtol=1e-4)


def test_params_from_flax_on_an_initialised_tree():
    """A tree from ``flax.linen.Module.init`` (not from a loader) maps onto
    the port's tower and gives the same features, off-grid image size
    included (24 px on a 16 px grid: the position embedding is resized)."""
    import jax
    import jax.numpy as jnp

    from scd_tpu.models.vit import ViTConfig as JCfg
    from scd_tpu.models.vit import VisionTransformer as JViT
    from scd_tpu_torch.models import VisionTransformer, params_from_flax
    from scd_tpu_torch.models.vit import ViTConfig

    kw = dict(image_size=16, patch_size=4, width=32, depth=2, heads=2,
              gelu_tanh=True)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 24, 3)).astype(np.float32)
    jm = JViT(JCfg(**kw))
    tree = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                           jnp.asarray(x)))
    tree = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        tree)  # non-zero cls / bias / pos terms
    want = np.asarray(jax.jit(jm.apply)(tree, jnp.asarray(x)))
    port = VisionTransformer(ViTConfig(**kw))
    state = params_from_flax(tree)
    assert set(state) == set(port.state_dict())
    port.load_state_dict(state)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("new_grid", [10, 17])
def test_interpolate_pos_embed_off_grid(new_grid):
    import jax.numpy as jnp

    from scd_tpu.models.vit import interpolate_pos_embed as jinterp
    from scd_tpu_torch.models.vit import interpolate_pos_embed

    pos = np.random.default_rng(new_grid).standard_normal(
        (1, 1 + 14 * 14, 48)).astype(np.float32)
    want = np.asarray(jinterp(jnp.asarray(pos), new_grid))
    got = interpolate_pos_embed(torch.from_numpy(pos), new_grid).numpy()
    assert got.shape == (1, 1 + new_grid * new_grid, 48)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # not torch's own bicubic (a = -0.75, no antialiasing)
    tv = torch.nn.functional.interpolate(
        torch.from_numpy(pos[:, 1:]).reshape(1, 14, 14, 48).permute(
            0, 3, 1, 2), size=(new_grid, new_grid), mode="bicubic",
        align_corners=False).permute(0, 2, 3, 1).reshape(1, -1, 48)
    assert np.abs(tv.numpy() - want[:, 1:]).max() > 1e-3


def test_clip_image_tower_at_l257_matches_flax():
    """A tiny CLIP image tower with a 224 px (14 x 14) position grid fed
    256 px images: a 16 x 16 grid, L 257, past the short attention paths'
    256 (the position embedding is resized, as for ``image_size`` 256).
    Atol 1e-4: f32 sums in another order."""
    import jax
    import jax.numpy as jnp

    from scd_tpu.models.clip import CLIPModel, load_openai_clip_weights
    from scd_tpu_torch.models import clip as tclip
    from scd_tpu_torch.testing.fabricate import clip_state_dict

    jcfg, tcfg = _clip_cfgs(width=32, depth=1, heads=2, image=224, patch=16)
    sd = clip_state_dict(tcfg, seed=9)
    x = np.random.default_rng(9).standard_normal(
        (2, 256, 256, 3)).astype(np.float32)
    jm = CLIPModel(jcfg)
    want = np.asarray(jax.jit(lambda v, a: jm.apply(
        v, a, method=CLIPModel.encode_image))(
        load_openai_clip_weights({k: v.numpy() for k, v in sd.items()},
                                 jcfg), jnp.asarray(x)))
    port = _port_clip(tcfg, tclip.load_openai_clip_weights(sd, tcfg))
    with torch.no_grad():
        got = port.encode_image(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, EMBED)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def int8_weights():
    """Width-128, depth-2 CLIP (image + text) and DINO state dicts."""
    from scd_tpu_torch.models.vit import ViTConfig
    from scd_tpu_torch.testing.fabricate import (clip_state_dict,
                                                 dino_state_dict)

    _, tcfg = _clip_cfgs(width=128, heads=4, image=32, patch=8, embed=64,
                         vocab=300, ctx=20, tw=128, theads=4, int8=True)
    dcfg = ViTConfig(image_size=32, patch_size=8, width=128, depth=2,
                     heads=4, dense_int8=True)
    return clip_state_dict(tcfg, seed=3), dino_state_dict(dcfg, seed=4)


def test_int8_clip_towers_match_flax(int8_weights):
    import jax
    import jax.numpy as jnp

    from scd_tpu.models.clip import CLIPModel, load_openai_clip_weights
    from scd_tpu_torch.models import clip as tclip
    from scd_tpu_torch.ops import w8a8

    jcfg, tcfg = _clip_cfgs(width=128, heads=4, image=32, patch=8, embed=64,
                            vocab=300, ctx=20, tw=128, theads=4, int8=True)
    sd = int8_weights[0]
    rng = np.random.default_rng(5)
    img = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    tok = rng.integers(1, 298, (4, 20)).astype(np.int32)
    tok[np.arange(4), [5, 19, 9, 12]] = 299  # EOT = max id
    tok[0, 6:] = 0
    jvars = load_openai_clip_weights({k: v.numpy() for k, v in sd.items()},
                                     jcfg)
    jm = CLIPModel(jcfg)
    jimg = np.asarray(jax.jit(lambda v, x: jm.apply(
        v, x, method=CLIPModel.encode_image))(jvars, jnp.asarray(img)))
    jtxt = np.asarray(jax.jit(lambda v, t: jm.apply(
        v, t, method=CLIPModel.encode_text))(jvars, jnp.asarray(tok)))
    port = _port_clip(tcfg, tclip.load_openai_clip_weights(sd, tcfg))
    before = w8a8.w8a8_fusedq_cuda.launches
    with torch.no_grad():
        timg = port.encode_image(torch.from_numpy(img)).numpy()
        ttxt = port.encode_text(torch.from_numpy(tok)).numpy()
    assert w8a8.w8a8_fusedq_cuda.launches == before  # CPU: plain chain
    assert _cos(timg, jimg).min() >= 0.9999
    assert _cos(ttxt, jtxt).min() >= 0.9999
    # the quantization is really on: the f32 tower differs
    f32 = _port_clip(_clip_cfgs(width=128, heads=4, image=32, patch=8,
                                embed=64, vocab=300, ctx=20, tw=128,
                                theads=4)[1],
                     tclip.load_openai_clip_weights(sd, tcfg))
    with torch.no_grad():
        fimg = f32.encode_image(torch.from_numpy(img)).numpy()
    assert np.abs(fimg - timg).max() > 1e-5


@pytest.mark.parametrize("gelu_tanh,pad_seq_to", [(False, "auto"),
                                                  (True, 0)])
def test_int8_dino_tower_matches_flax(int8_weights, gelu_tanh, pad_seq_to):
    """Exact GELU outside the int8 layer and tanh GELU fused into it; the
    padded (17 -> 32 tokens) and the unpadded sequence."""
    import jax
    import jax.numpy as jnp

    from scd_tpu.models.dino import load_dino_weights as jload
    from scd_tpu.models.vit import ViTConfig as JCfg
    from scd_tpu.models.vit import VisionTransformer as JViT
    from scd_tpu_torch.models import VisionTransformer, params_from_flax
    from scd_tpu_torch.models.dino import load_dino_weights
    from scd_tpu_torch.models.vit import ViTConfig

    kw = dict(image_size=32, patch_size=8, width=128, depth=2, heads=4,
              dense_int8=True, gelu_tanh=gelu_tanh, pad_seq_to=pad_seq_to)
    sd = int8_weights[1]
    x = np.random.default_rng(6).standard_normal(
        (3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JViT(JCfg(**kw)).apply)(
        jload({k: v.numpy() for k, v in sd.items()}, JCfg(**kw)),
        jnp.asarray(x)))
    port = VisionTransformer(ViTConfig(**kw))
    port.load_state_dict(params_from_flax(load_dino_weights(
        sd, ViTConfig(**kw))))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert _cos(got, want).min() >= 0.9999


@pytest.fixture(scope="module")
def merges(tmp_path_factory):
    from scd_tpu_torch.testing.fabricate import write_bpe_merges

    return write_bpe_merges(
        str(tmp_path_factory.mktemp("bpe") / "bpe_simple_vocab_16e6.txt.gz"),
        seed=11)


NAMES = ["cat", "noun_00012", "genus_003", "ph.d.", "o'brien", "",
         "very long compound name with many many words in it indeed",
         "great white shark", "x-ray", "café"]


def test_tokenizer_matches_jax(merges):
    from scd_tpu.models.tokenizer import CLIPTokenizer as JTok
    from scd_tpu_torch.models.tokenizer import CLIPTokenizer
    from scd_tpu_torch.naming.templates import IMAGENET_TEMPLATES

    jt, tt = JTok(merges), CLIPTokenizer(merges)
    assert len(tt.encoder) == 49408 and tt.eot_id == 49407
    texts = [t.format(n) for n in NAMES for t in IMAGENET_TEMPLATES]
    np.testing.assert_array_equal(tt(texts), jt(texts))
    np.testing.assert_array_equal(
        tt.prompt_tokens(IMAGENET_TEMPLATES, NAMES),
        jt.prompt_tokens(IMAGENET_TEMPLATES, NAMES))
    assert tt.template_pieces(IMAGENET_TEMPLATES) == \
        jt.template_pieces(IMAGENET_TEMPLATES)


def _text_encoders(tokenize):
    """The same deterministic text encoder for both packages: position-
    weighted sums of a token embedding table (EOT truncation changes the
    sum, so both must truncate alike)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    table = rng.standard_normal((49408, 24)).astype(np.float32)
    pos = rng.standard_normal((77, 1)).astype(np.float32)

    def jfwd(v, toks):
        return (v[0][toks] * v[1][:toks.shape[1]]).sum(1)

    def tfwd(v, toks):
        toks = torch.as_tensor(np.asarray(toks)).long()
        return (v[0][toks] * v[1][:toks.shape[1]]).sum(1)

    def make(fwd, variables, asarray):
        def encode(texts):
            from scd_tpu_torch.naming.zeroshot import truncate_to_eot_bucket
            return np.asarray(fwd(variables, asarray(
                truncate_to_eot_bucket(tokenize(texts)))))
        encode.forward, encode.variables, encode.tokenize = \
            fwd, variables, tokenize
        return encode

    return (make(jfwd, (jnp.asarray(table), jnp.asarray(pos)), jnp.asarray),
            make(tfwd, (torch.from_numpy(table), torch.from_numpy(pos)),
                 lambda a: a))


@pytest.mark.parametrize("n_names,groups", [(6, 3), (40, 1), (40, 3)])
def test_build_zeroshot_weights_matches_jax(merges, n_names, groups):
    """6 names: the plain path (fewer than two batches); 40 names in
    batches of 4: the batched build, ungrouped and grouped (length-sorted
    names and templates)."""
    from scd_tpu.models.tokenizer import CLIPTokenizer
    from scd_tpu.naming import zeroshot as jz
    from scd_tpu_torch.naming import zeroshot as tz
    from scd_tpu_torch.naming.templates import IMAGENET_TEMPLATES

    tok = CLIPTokenizer(merges)
    names = [f"{NAMES[i % len(NAMES)]} {i}" * (1 + i % 3)
             for i in range(n_names)]
    jenc, tenc = _text_encoders(tok)
    if groups == 3:
        want = jz.build_zeroshot_weights(jenc, names, IMAGENET_TEMPLATES,
                                         names_per_batch=4 if n_names > 6
                                         else 64)
        got = tz.build_zeroshot_weights(tenc, names, IMAGENET_TEMPLATES,
                                        names_per_batch=4 if n_names > 6
                                        else 64)
    else:
        want = jz.build_zeroshot_weights_sharded(
            jenc.forward, jenc.variables, tok, names, IMAGENET_TEMPLATES,
            names_per_batch=4, template_groups=1)
        got = tz.build_zeroshot_weights_sharded(
            tenc.forward, tenc.variables, tok, names, IMAGENET_TEMPLATES,
            names_per_batch=4, template_groups=1)
    assert got.shape == want.shape == (24, n_names)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_clip_preprocess_matches_jax(tmp_path):
    """The eval transform through PIL (a JPEG of another size), and the
    pass-through of a uint8 image already at the target size, which needs
    no PIL: both equal the JAX package's output; so do the device
    normalizations."""
    from PIL import Image

    from scd_tpu.data import transforms as J
    from scd_tpu_torch.data import transforms as T

    rng = np.random.default_rng(8)
    path = tmp_path / "x.jpg"
    Image.fromarray(rng.integers(0, 256, (50, 37, 3)).astype(np.uint8)).save(
        path)
    img = Image.open(path)
    arr = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    for norm in (True, False):
        jt, tt = J.clip_preprocess(32, norm), T.clip_preprocess(32, norm)
        np.testing.assert_array_equal(tt(img), jt(img))
        np.testing.assert_array_equal(tt(arr), jt(arr))
    assert T.clip_preprocess(32, True)(arr) is arr  # no PIL on this path
    batch = np.stack([arr, arr[::-1]])
    for jn, tn in ((J.device_normalize_clip, T.device_normalize_clip),
                   (J.device_normalize_imagenet, T.device_normalize_imagenet),
                   (J.device_normalize_unit, T.device_normalize_unit)):
        np.testing.assert_allclose(tn(torch.from_numpy(batch)).numpy(),
                                   np.asarray(jn(batch)), atol=1e-6)
