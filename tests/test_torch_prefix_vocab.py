"""The port's prefix-KV vocabulary build (``SCD_PREFIX_VOCAB=1``) against
the JAX package's, on the CPU, at the tiny text tower of
``tests/test_naming.py`` (width 32, depth 2, 4 heads, ``HashTokenizer(512)``),
the port's parameters carried across from the JAX init by
``params_from_flax``.

- ``prefix_attention_plain`` against ``_prefix_attention`` on numpy inputs
  from a seed, f32, at ``p_valid`` < P and = P; the dispatch on a CPU
  tensor; and, at ``p_valid`` = P, against the full-row causal attention
  on the concatenated [prefix, suffix] rows.
- ``encode_text_prefix`` / ``encode_text_suffix`` against the JAX methods,
  f32, and the suffix forward against the port's own full-row forward.
- ``build_zeroshot_weights_prefix`` against the JAX one and the port's
  full-row build (the JAX tests' names and templates, the fallback
  templates and names included); the dispatch is opt-in; a mesh that is
  not a ``MeshContext`` raises; ``build_encoders`` sets the prefix hooks
  unless ``dense_int8``.
- ``build_zeroshot_weights_prefix`` over 2 gloo ranks
  (``testing/dist.py::spawn``, ``testing/mesh_cases.py::
  prefix_vocab_build``): every rank's whole [D, V] against the
  one-process build, the JAX build on a single-controller mesh of 2
  virtual devices and the full-row build, both cases above.

Tolerance: f32 throughout, atol 1e-5 (the JAX tests' own: sums in another
order); the pipeline's bf16 towers compare the two builds by column
cosine, >= BF16_COS (bf16 rounding of activations at other places, two
blocks deep).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scd_tpu.models import clip as jclip
from scd_tpu.models import vit as jvit
from scd_tpu.core.config import MeshConfig as JMeshConfig
from scd_tpu.core.mesh import make_mesh as jmake_mesh
from scd_tpu.models.tokenizer import HashTokenizer as JHashTokenizer
from scd_tpu.naming import zeroshot as jzs
from scd_tpu_torch.models import clip as tclip
from scd_tpu_torch.models import vit as tvit
from scd_tpu_torch.models.params import params_from_flax
from scd_tpu_torch.models.tokenizer import HashTokenizer
from scd_tpu_torch.naming import zeroshot as tzs
from scd_tpu_torch.ops import attention as A
from scd_tpu_torch.testing.dist import spawn

TOL = 1e-5
BF16_COS = 0.999

# the JAX tests' names and templates (tests/test_naming.py:386-445)
NAMES = [f"name{i} word" if i % 3 else f"n{i}" for i in range(41)]
TEMPLATES = ["a photo of a {} here", "art of the {} object",
             "the small {} model"]
FB_NAMES = [f"name{i}" for i in range(9)] + [" ".join(f"w{i}"
                                                     for i in range(20))]
FB_TEMPLATES = ["a photo of a {} here", "art of the {}.", "art of the {0}"]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _cfgs():
    out = []
    for vmod, cmod in ((jvit, jclip), (tvit, tclip)):
        out.append(cmod.CLIPConfig(
            vision=vmod.ViTConfig(image_size=16, patch_size=8, width=32,
                                  depth=1, heads=4, quick_gelu=True,
                                  pre_post_norm=True, output_proj=16,
                                  patch_bias=False),
            vocab_size=512, context_length=77, text_width=32, text_depth=2,
            text_heads=4, embed_dim=16))
    return out


@pytest.fixture(scope="module")
def tiny():
    """(JAX encode_text with its hooks, the port's, the port's model)."""
    jcfg, tcfg = _cfgs()
    jmodel = jclip.CLIPModel(jcfg)
    jvars = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3), jnp.float32),
        jnp.zeros((1, 8), jnp.int32))
    jtok = JHashTokenizer(vocab_size=512)
    M = jclip.CLIPModel

    def jenc(texts):
        return np.asarray(jmodel.apply(jvars, jnp.asarray(jtok(texts)),
                                       method=M.encode_text))

    jenc.forward = jax.jit(lambda v, t: jmodel.apply(
        v, t, method=M.encode_text))
    jenc.prefix_forward = jax.jit(lambda v, t: jmodel.apply(
        v, t, method=M.encode_text_prefix))
    jenc.suffix_forward = jax.jit(lambda v, t, kv, p: jmodel.apply(
        v, t, kv, p, method=M.encode_text_suffix))
    jenc.variables = jvars
    jenc.tokenize = jtok

    model = tclip.CLIPModel(tcfg, device="cpu").eval()
    model.load_state_dict(params_from_flax(jvars))
    tok = HashTokenizer(vocab_size=512)

    def tenc(texts):
        return model.encode_text(torch.from_numpy(tok(texts))).numpy()

    tenc.forward = lambda m, t: m.encode_text(torch.as_tensor(t))
    tenc.prefix_forward = lambda m, t: m.encode_text_prefix(
        torch.as_tensor(t))
    tenc.suffix_forward = lambda m, t, kv, p: m.encode_text_suffix(
        torch.as_tensor(t), kv, p)
    tenc.variables = model
    tenc.tokenize = tok
    return jenc, tenc, model


# ------------------------------------------------------------ the attention

@pytest.mark.parametrize("p_valid", [4, 7])
def test_prefix_attention_plain_matches_jax(p_valid):
    b, s, n_pre, h, d = 3, 6, 7, 4, 16
    q, k, v = (_rand((b, s, h, d), i) for i in range(3))
    pk, pv = _rand((n_pre, h, d), 3), _rand((n_pre, h, d), 4)
    want = np.asarray(jvit._prefix_attention(
        *map(jnp.asarray, (q, k, v, pk, pv)), d ** -0.5,
        jnp.arange(n_pre) < p_valid))
    args = tuple(map(torch.from_numpy, (q, k, v, pk, pv)))
    got = A.prefix_attention_plain(*args, d ** -0.5, p_valid)
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # a CPU tensor takes the plain version, and no launch is counted
    before = A.prefix_attention_cuda.launches
    assert torch.equal(A.prefix_attention(*args, d ** -0.5, p_valid), got)
    assert A.prefix_attention_cuda.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefix_attention_equals_full_row_causal(dtype):
    """With the whole prefix valid, [prefix, suffix] keys are the full
    row's causal keys: the suffix rows of the full-row attention on the
    concatenated rows, as views of one packed qkv (bf16: the same scores,
    p and sums up to the order of the f32 sums)."""
    b, s, n_pre, h, d = 2, 5, 6, 2, 8
    qkv = torch.from_numpy(_rand((b, n_pre + s, 3 * h * d), 9)).to(dtype)
    t = qkv.unflatten(-1, (3, h, d))
    q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]
    full = A.attention_plain(q, k, v, d ** -0.5, causal=True)[:, n_pre:]
    got = A.prefix_attention(q[:, n_pre:], k[:, n_pre:], v[:, n_pre:],
                             k[0, :n_pre], v[0, :n_pre], d ** -0.5, n_pre)
    # batch 0's prefix is the shared cache: the rows of batch 0 match
    torch.testing.assert_close(got[0].float(), full[0].float(), rtol=0,
                               atol=TOL if dtype == torch.float32 else 2e-2)


def test_prefix_attention_refuses_bad_shapes():
    x = torch.zeros(2, 4, 3, 8)
    with pytest.raises(ValueError, match="share one"):
        A.prefix_attention(x, x, x[:1], torch.zeros(5, 3, 8),
                           torch.zeros(5, 3, 8), 0.5, 5)
    with pytest.raises(ValueError, match="pk, pv"):
        A.prefix_attention(x, x, x, torch.zeros(5, 2, 8),
                           torch.zeros(5, 2, 8), 0.5, 5)


# ------------------------------------------------------------ the text tower

def test_encode_text_prefix_and_suffix_match_jax(tiny):
    jenc, tenc, model = tiny
    rs = np.random.default_rng(5)
    p_lens = [3, 8, 5]
    prows = np.zeros((3, 8), np.int32)
    for i, n in enumerate(p_lens):
        prows[i, 0] = 510  # SOT
        prows[i, 1:n] = rs.integers(1, 500, n - 1)
    jk, jv = jenc.prefix_forward(jenc.variables, jnp.asarray(prows))
    with torch.no_grad():
        tk, tv = model.encode_text_prefix(torch.from_numpy(prows))
    assert tk.shape == tv.shape == (2, 3, 8, 4, 8)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL, rtol=0)

    srows = np.zeros((5, 8), np.int32)
    for r in range(5):
        n = 2 + r
        srows[r, :n - 1] = rs.integers(1, 500, n - 1)
        srows[r, n - 1] = 511  # EOT, the row's largest id
    for t, p_len in enumerate(p_lens):
        want = np.asarray(jenc.suffix_forward(
            jenc.variables, jnp.asarray(srows), (jk[:, t], jv[:, t]),
            jnp.int32(p_len)))
        with torch.no_grad():
            got = model.encode_text_suffix(torch.from_numpy(srows),
                                           (tk[:, t], tv[:, t]), p_len)
            # the full-row forward on prefix + suffix rows
            rows = np.concatenate([np.repeat(prows[t:t + 1, :p_len], 5, 0),
                                   srows], axis=1)
            full = model.encode_text(torch.from_numpy(rows))
        assert got.shape == (5, 16)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
        np.testing.assert_allclose(got.numpy(), full.numpy(), atol=TOL,
                                   rtol=0)


def test_encode_text_suffix_refuses_positions_past_the_context(tiny):
    _, _, model = tiny
    kv = model.encode_text_prefix(torch.zeros(1, 8, dtype=torch.int64))
    with pytest.raises(ValueError, match="context length"):
        model.encode_text_suffix(torch.zeros(2, 8, dtype=torch.int64),
                                 (kv[0][:, 0], kv[1][:, 0]), 70)


# ------------------------------------------------------------ the build

class _PerPromptTokenizer:
    """A tokenizer without ``prompt_tokens``: the fallback templates' rows
    then come from tokenizing each prompt."""

    def __init__(self, tok):
        self._tok = tok
        for name in ("encode", "template_pieces", "name_boundary_punct",
                     "sot_id", "eot_id"):
            setattr(self, name, getattr(tok, name))

    def __call__(self, texts):
        return self._tok(texts)


# (names, templates, names_per_chunk, full-row names_per_batch)
CASES = {"spliced": (NAMES, TEMPLATES, 16, 16),
         "fallbacks": (FB_NAMES, FB_TEMPLATES, 8, 4)}


@pytest.fixture(scope="module")
def ranks(tiny):
    """Both cases built over 2 gloo ranks from the JAX init's parameters:
    every rank's result."""
    _, tenc, model = tiny
    spec = {"cfg": _cfgs()[1], "state": model.state_dict(),
            "cases": {c: v[:3] for c, v in CASES.items()}}
    return spawn("scd_tpu_torch.testing.mesh_cases.prefix_vocab_build",
                 world=2, args=(spec,), timeout=120)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefix_build_over_two_ranks(tiny, ranks, case):
    """Every rank's columns against the one-process prefix build, the JAX
    build over a single-controller mesh of 2 virtual devices (whose names
    are sharded over it) and the full-row build, to TOL."""
    jenc, tenc, _ = tiny
    names, templates, chunk, per_batch = CASES[case]
    jmesh = jmake_mesh(JMeshConfig(data=2, model=1),
                       devices=jax.devices()[:2])
    want = jzs.build_zeroshot_weights_prefix(
        jenc.forward, jenc.prefix_forward, jenc.suffix_forward,
        jenc.variables, jenc.tokenize, names, templates, mesh=jmesh,
        names_per_chunk=chunk)
    with torch.no_grad():
        one = tzs.build_zeroshot_weights_prefix(
            tenc.forward, tenc.prefix_forward, tenc.suffix_forward,
            tenc.variables, tenc.tokenize, names, templates,
            names_per_chunk=chunk)
        full = tzs.build_zeroshot_weights(lambda t: tenc(t), names,
                                          templates,
                                          names_per_batch=per_batch)
    for rank in ranks:
        got = rank[case]
        assert got.shape == (16, len(names)) and got.dtype == np.float32
        np.testing.assert_allclose(got, one, atol=TOL, rtol=0)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        np.testing.assert_allclose(got, full, atol=TOL, rtol=0)
        np.testing.assert_array_equal(got, ranks[0][case])


@pytest.mark.parametrize("case", ["spliced", "fallbacks",
                                  "fallbacks-per-prompt"])
def test_prefix_build_matches_jax_and_full_row(tiny, case):
    """The JAX tests' two cases: every template spliced (names in chunks of
    16), then a glued '{}.' template, a '{0}' template (a fallback
    template) and a 20-word name (a fallback name), chunks of 8; the
    second also with a tokenizer that has no ``prompt_tokens``."""
    jenc, tenc, _ = tiny
    names, templates, chunk, per_batch = (
        (NAMES, TEMPLATES, 16, 16) if case == "spliced"
        else (FB_NAMES, FB_TEMPLATES, 8, 4))
    tok = (_PerPromptTokenizer(tenc.tokenize)
           if case == "fallbacks-per-prompt" else tenc.tokenize)
    want = jzs.build_zeroshot_weights_prefix(
        jenc.forward, jenc.prefix_forward, jenc.suffix_forward,
        jenc.variables, jenc.tokenize, names, templates,
        names_per_chunk=chunk)
    with torch.no_grad():
        got = tzs.build_zeroshot_weights_prefix(
            tenc.forward, tenc.prefix_forward, tenc.suffix_forward,
            tenc.variables, tok, names, templates, names_per_chunk=chunk)
        full = tzs.build_zeroshot_weights(lambda t: tenc(t), names,
                                          templates,
                                          names_per_batch=per_batch)
    assert got.shape == want.shape == (16, len(names))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, full, atol=TOL, rtol=0)


def test_prefix_build_is_opt_in(tiny, monkeypatch):
    _, tenc, _ = tiny
    names = [f"name{i}" for i in range(40)]
    templates = ["a photo of a {} here"]
    called = []
    orig = tzs.build_zeroshot_weights_prefix

    def spy(*a, **k):
        called.append(True)
        return orig(*a, **k)

    monkeypatch.setattr(tzs, "build_zeroshot_weights_prefix", spy)
    monkeypatch.delenv("SCD_PREFIX_VOCAB", raising=False)
    with torch.no_grad():
        full = tzs.build_zeroshot_weights(tenc, names, templates,
                                          names_per_batch=16)
        assert not called, "the prefix build must be opt-in"
        monkeypatch.setenv("SCD_PREFIX_VOCAB", "1")
        got = tzs.build_zeroshot_weights(tenc, names, templates,
                                         names_per_batch=16)
        assert called, "the prefix build was not dispatched"
        # under 2 x names_per_batch names the plain loop runs either way
        called.clear()
        tzs.build_zeroshot_weights(tenc, names[:20], templates,
                                   names_per_batch=16)
        assert not called
    np.testing.assert_allclose(got, full, atol=TOL, rtol=0)


def test_mesh_other_than_none_raises(tiny):
    _, tenc, _ = tiny
    with pytest.raises(NotImplementedError, match="mesh"):
        tzs.build_zeroshot_weights(tenc, NAMES, TEMPLATES, mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        tzs.build_zeroshot_weights_prefix(
            tenc.forward, tenc.prefix_forward, tenc.suffix_forward,
            tenc.variables, tenc.tokenize, NAMES, TEMPLATES, mesh=object())


@pytest.mark.parametrize("int8", [False, True])
def test_build_encoders_sets_the_prefix_hooks(tmp_path, monkeypatch, int8):
    """The pipeline's text encoder (bf16 compute) carries the prefix hooks
    unless ``dense_int8``; with ``SCD_PREFIX_VOCAB=1`` the vocabulary build
    then takes the prefix route, and its columns agree with the full-row
    build's (bf16: by cosine)."""
    import dataclasses
    import os

    from test_torch_unsup import _tiny_factories

    from scd_tpu_torch.naming.templates import IMAGENET_TEMPLATES
    from scd_tpu_torch.pipelines.unsup import build_encoders
    from scd_tpu_torch.testing.fabricate import (clip_state_dict,
                                                 cold_config,
                                                 write_bpe_merges)

    clip_cfg, _ = _tiny_factories(monkeypatch, int8=int8)
    cfg = cold_config(str(tmp_path), dense_int8=int8)
    cfg = cfg.replace(feature=dataclasses.replace(cfg.feature,
                                                  feat_model="clip"))
    os.makedirs(os.path.dirname(cfg.data.clip_weights))
    torch.save(clip_state_dict(clip_cfg, 1), cfg.data.clip_weights)
    write_bpe_merges(os.path.join(cfg.data.corpus_dir,
                                  "bpe_simple_vocab_16e6.txt.gz"), 1)
    enc = build_encoders(cfg, {}, device="cpu")[2]
    assert hasattr(enc, "prefix_forward") is (not int8)
    assert hasattr(enc, "suffix_forward") is (not int8)
    if int8:
        return
    names = [f"noun_{i:05d}" for i in range(130)]
    templates = IMAGENET_TEMPLATES[:6]
    calls = []
    orig = tzs.build_zeroshot_weights_prefix
    monkeypatch.setattr(tzs, "build_zeroshot_weights_prefix",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    full = tzs.build_zeroshot_weights(enc, names, templates)
    monkeypatch.setenv("SCD_PREFIX_VOCAB", "1")
    got = tzs.build_zeroshot_weights(enc, names, templates)
    assert calls == [1]
    cos = (got * full).sum(0) / (np.linalg.norm(got, axis=0)
                                 * np.linalg.norm(full, axis=0))
    assert got.shape == full.shape == (32, 130)
    assert cos.min() >= BF16_COS, cos.min()
