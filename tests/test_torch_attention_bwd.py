"""The port's attention gradient against the JAX package's, on the CPU.

- ``qkv_attention_bwd_plain`` (autograd of the plain attention, the
  gradient kernel's plain version) against ``jax.vjp`` of the attention
  the JAX ``Attention`` runs off the TPU (``jax.nn.dot_product_attention``
  with the key mask, ``scd_tpu/models/vit.py``), f32 inputs made with numpy
  from a seed, B 2 · H 2 · d 16: at L 197 (image 224), at L 257 (image
  256, past the old 256-key limit) and at L 300 with l_valid 289, and
  under a causal mask (the text tower's) at L 77 and at L 300 with
  l_valid 289.  Every element within the f32 bound of
  ``testing/attention_grad.py`` (1e-4 of the sum of the absolute values
  of its terms).
- The f32 gradient kernels' product contract at head_dim 64 (three TF32
  passes in every product, ``testing/attention_tf32.py``, differentiated
  by autograd) against ``jax.vjp`` of the same JAX attention at input
  amplitudes 1, 3 and 6 (B 2 · L 197 · H 2 · d 64): every element within
  the f32 bound.
- ``_check_bwd`` on CPU tensors: bf16 and f32 at head_dim 64 pass at any
  L, and so do f32 at another head_dim past L 256, causal attention and
  bf16 at another head_dim; a head_dim-64 view off the 16-byte grid and
  head_dim 288 raise.
- ``attention_route`` / ``bwd_route`` at the micro ViT's shapes (head_dim
  32: bf16 on the key-tiled SIMT kernel at every L) and at head_dim 64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scd_tpu_torch.ops import attention as A
from scd_tpu_torch.testing.attention_grad import grad_bound
from scd_tpu_torch.testing.attention_tf32 import attention_x3

B, H, D = 2, 2, 16


def _jax_grad(qkv, dout, l_valid, heads=H, causal=False):
    """The gradient of the packed qkv through the JAX towers' off-TPU
    attention: split, heads, dot_product_attention with the key mask and,
    for the text tower, ``is_causal``."""
    b, length, w3 = qkv.shape
    d = w3 // (3 * heads)
    mask = None
    if l_valid < length:
        mask = (jnp.arange(length) < l_valid)[None, None, None, :]

    def attend(x):
        q, k, v = (t.reshape(b, length, heads, d)
                   for t in jnp.split(x, 3, axis=-1))
        return jax.nn.dot_product_attention(
            q, k, v, mask=mask, is_causal=causal).reshape(b, length, w3 // 3)

    @jax.jit
    def grad(x, g):
        return jax.vjp(attend, x)[1](g)[0]

    return np.asarray(grad(jnp.asarray(qkv), jnp.asarray(dout)))


@pytest.mark.parametrize("length,l_valid,causal", [
    (197, 197, False), (257, 257, False), (300, 289, False), (77, 77, True),
    (300, 289, True)])
def test_plain_gradient_matches_jax_vjp(length, l_valid, causal):
    rng = np.random.default_rng(length)
    qkv = rng.standard_normal((B, length, 3 * H * D)).astype(np.float32)
    dout = rng.standard_normal((B, length, H * D)).astype(np.float32)
    want = _jax_grad(qkv, dout, l_valid, causal=causal)
    qkv_t, dout_t = torch.from_numpy(qkv), torch.from_numpy(dout)
    got = A.qkv_attention_bwd_plain(qkv_t, dout_t, H, D ** -0.5, causal,
                                    l_valid)
    assert got.shape == qkv_t.shape and got.dtype == torch.float32
    bound = grad_bound(qkv_t, dout_t, H, D ** -0.5, l_valid, got,
                       causal).numpy()
    err = np.abs(got.numpy() - want)
    assert (err <= bound).all(), float((err / bound).max())
    # keys past l_valid get no gradient in dK and dV
    dkv = got.view(B, length, 3, H, D)[:, l_valid:, 1:]
    assert bool((dkv == 0).all())


@pytest.mark.parametrize("amp", [1.0, 3.0, 6.0])
def test_tf32x3_gradient_matches_jax_vjp(amp):
    """Autograd of ``attention_x3`` (every product of the forward and the
    backward three TF32 passes, as the f32 gradient kernels run them) on
    numpy inputs scaled by ``amp``, against ``jax.vjp`` of the JAX
    attention: every element within the f32 bound (1e-4 of the sum of
    the absolute values of its terms)."""
    h, d, length = 2, 64, 197
    rng = np.random.default_rng(int(amp))
    qkv = (amp * rng.standard_normal((B, length, 3 * h * d))).astype(
        np.float32)
    dout = rng.standard_normal((B, length, h * d)).astype(np.float32)
    want = _jax_grad(qkv, dout, length, heads=h)
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = attention_x3(*A._heads(x, h), d ** -0.5).reshape(B, length, h * d)
    dout_t = torch.from_numpy(dout)
    (got,) = torch.autograd.grad(out, x, dout_t)
    bound = grad_bound(torch.from_numpy(qkv), dout_t, h, d ** -0.5, None,
                       got).numpy()
    err = np.abs(got.numpy() - want)
    assert (err <= bound).all(), float((err / bound).max())


@pytest.mark.parametrize("length", [257, 1_025])
def test_check_bwd_takes_bf16_head_dim_64_at_any_length(length):
    qkv = torch.zeros(2, length, 3 * 64, dtype=torch.bfloat16)
    A._check_bwd(qkv, 1, False)


@pytest.mark.parametrize("length", [257, 1_025])
def test_check_bwd_takes_f32_head_dim_64_at_any_length(length):
    A._check_bwd(torch.zeros(2, length, 3 * 64), 1, False)


@pytest.mark.parametrize("qkv,heads,causal", [
    (torch.zeros(2, 257, 3 * 32), 1, False),
    (torch.zeros(2, 16, 3 * 64, dtype=torch.bfloat16), 1, True),
    (torch.zeros(2, 16, 3 * 64, dtype=torch.bfloat16), 2, False),
], ids=["f32-L257", "causal", "bf16-head_dim-32"])
def test_check_bwd_takes_what_the_kernels_take(qkv, heads, causal):
    """Once refused: f32 at head_dim 32 past L 256, causal attention and
    bf16 at head_dim 32 now have a route (SIMT, or ``wgmma`` under
    causal)."""
    A._check_bwd(qkv, heads, causal)


@pytest.mark.parametrize("qkv,heads,causal,raises", [
    (torch.zeros(2 * 16 * 3 * 64 + 1)[1:].view(2, 16, 3 * 64), 1, False,
     ValueError),
    (torch.zeros(2, 16, 3 * 288, dtype=torch.bfloat16), 1, True,
     ValueError),
], ids=["f32-misaligned", "head_dim-288"])
def test_check_bwd_refuses_what_the_kernel_does_not_take(qkv, heads, causal,
                                                         raises):
    with pytest.raises(raises):
        A._check_bwd(qkv, heads, causal)


@pytest.mark.parametrize("dtype,hd,length,fwd,bwd", [
    (torch.bfloat16, 32, 5, "long_simt", "simt"),  # micro at image 32
    (torch.bfloat16, 32, 197, "long_simt", "simt"),  # micro at 224
    (torch.bfloat16, 32, 290, "long_simt", "simt"),
    (torch.float32, 32, 197, "f32_simt", "simt"),
    (torch.float32, 32, 290, "long_simt", "simt"),  # e2e micro at 136 px
    (torch.float32, 128, 256, "long_simt", "simt"),  # rows past 227 KB
    (torch.bfloat16, 64, 197, "wgmma", "wgmma"),
    (torch.bfloat16, 64, 257, "long_wgmma", "wgmma"),
    (torch.float32, 64, 197, "f32_wgmma", "f32_wgmma"),
    (torch.float32, 64, 785, "f32_wgmma", "f32_wgmma"),
])
def test_routes_at_micro_and_head_dim_64(dtype, hd, length, fwd, bwd):
    assert A.attention_route(dtype, hd, length) == fwd
    assert A.bwd_route(dtype, hd) == bwd
