"""The port's attention against the JAX package's, on the CPU.

- The plain ``qkv_attention`` / ``vit_attention`` against
  ``*_attention_pallas(..., interpret=True)`` at f32: max abs error
  <= 1e-5, as ``tests/test_pallas_kernels.py`` holds the Pallas kernels to
  the XLA path (f32 sums in another order).  Shapes: the image towers'
  (2, 197, 12, 64) through ``qkv_attention``, the causal text tower's
  (3, 77, 8, 64) through ``vit_attention``, L 5 through both, the long
  sequences of towers at image 256 (L 257, through ``qkv_attention``) and
  288 (L 325, causal, through ``vit_attention``), which the card's long
  paths take, and the int8 image sequence padded to 208 with 197 valid
  keys (against the JAX towers' masked ``dot_product_attention``, which
  the Pallas kernels do not take).
- ``models.vit.Attention`` on the CPU against the JAX ``Attention`` from
  one Flax tree, causal and padded, at atol 1e-5.
- The f32 kernels' product contract at head_dim 64 (three TF32 passes,
  ``testing/attention_tf32.py``) at input amplitudes 1, 3 and 6, with
  ``chip_smoke.ATTN_F32_VREL`` (1e-5 of max|v|, the tolerance the card's
  f32 forward is held to): the split's own error against float64
  attention (split-bf16's beyond it at 3 and 6), and the f32-summed
  emulation against the JAX towers' f32 attention off the TPU
  (``jax.nn.dot_product_attention``); ``tf32_rna``'s rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATTN_F32_VREL
from scd_tpu.ops.pallas_kernels import (qkv_attention_pallas,
                                        vit_attention_pallas)
from scd_tpu_torch.ops import attention as A
from scd_tpu_torch.testing.attention_tf32 import (attention_x3, split_bf16,
                                                  tf32_rna)

TOL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("b,length,h,d,causal", [
    (2, 197, 12, 64, False), (2, 5, 3, 64, False), (1, 257, 2, 64, False)])
def test_plain_matches_pallas_qkv(b, length, h, d, causal):
    qkv = _rand((b, length, 3 * h * d), length)
    want = np.asarray(qkv_attention_pallas(jnp.asarray(qkv), h, d ** -0.5,
                                           causal, interpret=True))
    got = A.qkv_attention(torch.from_numpy(qkv), h, d ** -0.5, causal).numpy()
    assert got.shape == (b, length, h * d)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("b,length,h,d,causal", [
    (3, 77, 8, 64, True), (2, 5, 3, 64, True), (1, 325, 2, 64, True)])
def test_plain_matches_pallas_vit(b, length, h, d, causal):
    q, k, v = (_rand((b, length, h, d), length + i) for i in range(3))
    want = np.asarray(vit_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), d ** -0.5, causal,
        interpret=True))
    got = A.vit_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), d ** -0.5, causal).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_pad_keys_masked_like_jax(causal):
    """L 208 with 197 valid keys (the int8 image sequence; causal + pad as
    a text row padded 77 -> 80 would be): the JAX towers' masked
    ``jax.nn.dot_product_attention``, and the real rows equal an unpadded
    run on the first 197 positions."""
    b, length, valid, h, d = 2, 208, 197, 4, 64
    q, k, v = (_rand((b, length, h, d), 7 + i) for i in range(3))
    mask = np.arange(length)[None, :] < valid
    if causal:
        mask = mask & np.tri(length, dtype=bool)
    want = np.asarray(jax.nn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        mask=jnp.asarray(mask)[None, None]))
    got = A.vit_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), d ** -0.5, causal,
                          l_valid=valid).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    short = A.vit_attention(*(torch.from_numpy(t[:, :valid]) for t in
                              (q, k, v)), d ** -0.5, causal).numpy()
    np.testing.assert_allclose(got[:, :valid], short, atol=TOL, rtol=0)


def test_bf16_rounds_p_before_pv():
    """bf16 inputs: p is rounded to bf16 before p . v (the Pallas kernels'
    ``p.astype(v.dtype)``), the output is bf16."""
    b, length, h, d = 1, 9, 2, 64
    q, k, v = (torch.from_numpy(_rand((b, length, h, d), 20 + i)).to(
        torch.bfloat16) for i in range(3))
    got = A.vit_attention(q, k, v, 0.125)
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * 0.125
    p = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
    want = torch.einsum("bhlm,bmhd->blhd", p, v.float()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -7 * (
        want.float().abs().max().item())


def test_attention_module_matches_flax():
    """One Flax tree through the JAX ``Attention`` and the port's, causal
    with sequence padding (real_len 11 of 16)."""
    from scd_tpu.models.vit import Attention as JAttention
    from scd_tpu.models.vit import ViTConfig as JCfg
    from scd_tpu_torch.models.params import params_from_flax
    from scd_tpu_torch.models.vit import Attention, ViTConfig

    kw = dict(width=32, heads=2, depth=1)
    x = _rand((2, 16, 32), 3)
    jmod = JAttention(JCfg(**kw), real_len=11)
    tree = jax.jit(jmod.init, static_argnums=2)(jax.random.PRNGKey(0),
                                                jnp.asarray(x), True)
    want = np.asarray(jax.jit(jmod.apply, static_argnums=2)(
        tree, jnp.asarray(x), True))
    port = Attention(ViTConfig(**kw))
    port.load_state_dict(params_from_flax(tree))
    with torch.no_grad():
        got = port(torch.from_numpy(x), causal=True, real_len=11).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_dispatch_plain_on_cpu_and_kernel_refuses_cpu():
    q = torch.zeros(1, 4, 2, 64)
    before = A.attention_cuda.launches
    out = A.vit_attention(q, q, q, 0.125)
    assert out.shape == (1, 4, 2, 64) and A.attention_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        A.attention_cuda(q, q, q, 0.125)
    with pytest.raises(ValueError, match="l_valid"):
        A.vit_attention(q, q, q, 0.125, l_valid=0)


@pytest.mark.parametrize("dtype,hd,route", [
    (torch.bfloat16, 64, "mma"),  # every shipped text tower
    (torch.bfloat16, 32, "simt"), (torch.bfloat16, 128, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 13, "simt")])
def test_prefix_route_from_dtype_and_head_dim(dtype, hd, route):
    """The prefix kernel's route is chosen from the dtype and head_dim
    alone: bf16 at head_dim 64 the mma.sync kernel, the rest the SIMT
    one; nothing is launched."""
    before = (A.prefix_attention_cuda.launches,
              A.prefix_attention_cuda.mma_launches)
    assert A.prefix_route(dtype, hd) == route
    assert (A.prefix_attention_cuda.launches,
            A.prefix_attention_cuda.mma_launches) == before


def test_tf32_rna_rounds_to_nearest_ties_away():
    """10 mantissa bits kept, to nearest, ties away from zero, by sign and
    magnitude; the rest of x is exact in f32."""
    one = 1.0 + 2.0 ** -10  # the TF32 successor of 1
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -11 - 2.0 ** -20, 3.0, -0.0,
                      one + 2.0 ** -11 + 2.0 ** -23])
    want = torch.tensor([one, -one, 1.0, 3.0, -0.0, one + 2.0 ** -10])
    assert torch.equal(tf32_rna(x), want)
    r = torch.from_numpy(_rand((4_096,), 9))
    hi = tf32_rna(r)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((r - hi).abs() <= 2.0 ** -11 * r.abs()).all())



_jax_attend = jax.jit(jax.nn.dot_product_attention)


def _f64_attention(q, k, v, scale):
    qh, kh, vh = (torch.from_numpy(t).double().transpose(1, 2)
                  for t in (q, k, v))
    p = torch.softmax(qh @ kh.transpose(-1, -2) * scale, dim=-1)
    return (p @ vh).transpose(1, 2).numpy()


@pytest.mark.parametrize("amp", [1.0, 3.0, 6.0])
def test_tf32x3_forward_matches_jax_f32(amp):
    """The f32 kernels' products, three TF32 passes (``attention_x3``), on
    numpy inputs scaled by ``amp`` (scores of std ~amp^2: at 6 the softmax
    is near one-hot), with ATTN_F32_VREL of max|v| as the tolerance:
    - the split's own error (the split products summed in float64) is
      within it of float64 attention, where split-bf16 products are not
      at amplitudes 3 and 6: the precision choice;
    - summed in f32 as the kernels sum, the emulation is within it of the
      JAX towers' f32 attention, beyond the distance at which the plain
      version (full f32 products, ``attention_plain``) lies from JAX: at
      amplitude 6 f32 arithmetic alone is ~1e-5 of max|v| off (scores up
      to ~150, each rounded at 2^-24 of that)."""
    b, length, h, d = 2, 197, 4, 64
    q, k, v = (amp * _rand((b, length, h, d), 40 + i) for i in range(3))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    tol = ATTN_F32_VREL * np.abs(v).max()
    truth = _f64_attention(q, k, v, d ** -0.5)
    split_err = np.abs(attention_x3(tq, tk, tv, d ** -0.5, acc=torch.float64
                                    ).numpy() - truth).max()
    bf16_err = np.abs(attention_x3(tq, tk, tv, d ** -0.5, split=split_bf16,
                                   acc=torch.float64).numpy() - truth).max()
    assert split_err <= tol, split_err / tol
    assert amp < 3 or bf16_err > tol, bf16_err / tol
    want = np.asarray(_jax_attend(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v)))
    got = attention_x3(tq, tk, tv, d ** -0.5).numpy()
    plain = np.abs(A.attention_plain(tq, tk, tv, d ** -0.5).numpy()
                   - want).max()
    err = np.abs(got - want).max()
    assert err <= tol + plain, (err / tol, plain / tol)
