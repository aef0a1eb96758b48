"""The W8A8 plain versions against the JAX package's Pallas kernels in
interpret mode, with the contract of ``tests/test_pallas_kernels.py``.

- Pre-quantized product (2-D and rank-3): equal to within one f32 ulp
  (the TPU kernel's epilogue may contract the multiply-add into an FMA;
  the plain version rounds each step, as the CUDA kernel does).
- Fused quantization, each activation, f32 and bf16 out: the in-kernel
  divide may differ from the host chain by one ulp of s_x, flipping a
  rounding exactly at a quantization boundary, so the output may move by
  whole quantization steps; bounded at 1024 steps and required rare, plus
  one bf16 ulp of the output where it is bf16.
- The weight and row quantizations equal ``Int8Dense``'s chain.
- Dispatch: CPU tensors run the plain versions; any other device raises.
"""

import numpy as np
import pytest
import torch

from scd_tpu_torch.ops import w8a8


def _inputs(n=300, d=128, f=256, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        xq=rng.integers(-127, 128, (n, d)).astype(np.int8),
        wq=rng.integers(-127, 128, (d, f)).astype(np.int8),
        sx=(0.003 + 0.001 * rng.random((n, 1))).astype(np.float32),
        sw=(0.001 + 0.002 * rng.random((1, f))).astype(np.float32),
        b=rng.standard_normal(f).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_prequant_plain_matches_pallas_2d():
    import jax.numpy as jnp

    from scd_tpu.ops.pallas_kernels import dense_w8a8_pallas

    z = _inputs()
    want = np.asarray(dense_w8a8_pallas(
        jnp.asarray(z["xq"]), jnp.asarray(z["wq"]), jnp.asarray(z["sx"]),
        jnp.asarray(z["sw"]), jnp.asarray(z["b"]), block_n=128, block_f=128,
        out_dtype=jnp.float32, interpret=True))
    got = w8a8.dense_w8a8(_t(z["xq"]), _t(z["wq"].T), _t(z["sx"]),
                          _t(z["sw"][0]), _t(z["b"]),
                          out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=2e-6)
    # the pre-activation accumulators: exact at unit scales and zero bias
    acc = w8a8.dense_w8a8_plain(_t(z["xq"]), _t(z["wq"].T),
                                torch.ones(300), torch.ones(256),
                                torch.zeros(256), torch.float32).numpy()
    np.testing.assert_array_equal(
        acc, z["xq"].astype(np.int64) @ z["wq"].astype(np.int64))


def test_prequant_plain_matches_pallas_2d_wide():
    """D 2,048, wider than ``w8a8_fusedq`` takes: 127^2 * D passes 2^24, so
    the plain version takes its float64 route and rounds once to f32, as
    the kernel's int32 -> f32 conversion and the TPU kernel's do."""
    import jax.numpy as jnp

    from scd_tpu.ops.pallas_kernels import dense_w8a8_pallas

    z = _inputs(n=200, d=2_048, f=256, seed=2)
    want = np.asarray(dense_w8a8_pallas(
        jnp.asarray(z["xq"]), jnp.asarray(z["wq"]), jnp.asarray(z["sx"]),
        jnp.asarray(z["sw"]), jnp.asarray(z["b"]), block_n=128, block_f=128,
        out_dtype=jnp.float32, interpret=True))
    got = w8a8.dense_w8a8(_t(z["xq"]), _t(z["wq"].T), _t(z["sx"]),
                          _t(z["sw"][0]), _t(z["b"]),
                          out_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=2e-6)
    acc = w8a8.dense_w8a8_plain(_t(z["xq"]), _t(z["wq"].T),
                                torch.ones(200), torch.ones(256),
                                torch.zeros(256), torch.float32).numpy()
    exact = z["xq"].astype(np.int64) @ z["wq"].astype(np.int64)
    np.testing.assert_array_equal(acc, exact.astype(np.float32))


def test_prequant_plain_matches_pallas_3d():
    import jax.numpy as jnp

    from scd_tpu.ops.pallas_kernels import dense_w8a8_pallas_3d

    rng = np.random.default_rng(1)
    b, length, d, f = 4, 13, 128, 256  # odd L: the rank-3 kernel's case
    xq = rng.integers(-127, 128, (b, length, d)).astype(np.int8)
    wq = rng.integers(-127, 128, (d, f)).astype(np.int8)
    sx = (0.003 + 0.001 * rng.random((b, length, 1))).astype(np.float32)
    sw = (0.001 + 0.002 * rng.random((1, f))).astype(np.float32)
    bias = rng.standard_normal(f).astype(np.float32)
    want = np.asarray(dense_w8a8_pallas_3d(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sx), jnp.asarray(sw),
        jnp.asarray(bias), block_b=2, block_f=128, out_dtype=jnp.float32,
        interpret=True))
    got = w8a8.dense_w8a8_3d(_t(xq), _t(wq.T), _t(sx), _t(sw[0]), _t(bias),
                             out_dtype=torch.float32).numpy()
    assert got.shape == (b, length, f)
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=2e-6)


@pytest.mark.parametrize("act,out", [(None, "f32"), ("quick_gelu", "bf16"),
                                     ("gelu_tanh", "f32"), ("gelu", "bf16")])
def test_fusedq_plain_matches_pallas(act, out):
    import jax.numpy as jnp

    from scd_tpu.ops.pallas_kernels import dense_w8a8_fusedq_pallas

    rng = np.random.default_rng(2)
    n, d, f = 200, 256, 384  # ragged N (the kernel pads to 256 rows)
    x = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    wq = rng.integers(-127, 128, (d, f)).astype(np.int8)
    sw = (0.001 + 0.002 * rng.random((1, f))).astype(np.float32)
    bias = rng.standard_normal(f).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[out]
    want = np.asarray(dense_w8a8_fusedq_pallas(
        x, jnp.asarray(wq), jnp.asarray(sw), jnp.asarray(bias), block_n=128,
        block_f=128, out_dtype=jdt, act=act, interpret=True), np.float32)
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    got = w8a8.dense_w8a8_fusedq(xt, _t(wq.T), _t(sw[0]), _t(bias),
                                 out_dtype=tdt, act=act).float().numpy()
    x32 = np.asarray(x, np.float32)
    sx = np.maximum(np.abs(x32).max(axis=1, keepdims=True), 1e-12) / 127.0
    step = sx * sw  # [n, f] dequant step
    ulp = np.abs(want) * 2.0 ** -7 if out == "bf16" else 0.0
    diff = np.abs(got - want)
    assert (diff <= 1024 * step + ulp + 1e-5).all(), diff.max()
    assert (diff > ulp + 1e-5).mean() < 0.05


def test_quantizations_equal_int8dense_chain():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    w = rng.standard_normal((96, 80)).astype(np.float32)
    x = rng.standard_normal((5, 7, 96)).astype(np.float32)
    w32 = jnp.asarray(w)
    s_w = jnp.maximum(jnp.max(jnp.abs(w32), axis=0, keepdims=True),
                      1e-12) / 127.0
    jwq = np.asarray(jnp.round(w32 / s_w).astype(jnp.int8))
    x32 = jnp.asarray(x)
    s_x = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True),
                      1e-12) / 127.0
    jxq = np.asarray(jnp.round(jnp.clip(x32 / s_x, -127.0, 127.0)
                               ).astype(jnp.int8))
    wq_t, tsw = w8a8.prepare_weight(_t(w))
    np.testing.assert_array_equal(wq_t.numpy().T, jwq)
    np.testing.assert_array_equal(tsw.numpy(), np.asarray(s_w)[0])
    xq, tsx = w8a8.quantize_rows(_t(x))
    np.testing.assert_array_equal(xq.numpy(), jxq)
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(s_x))


def test_dispatch_plain_on_cpu_and_raises_elsewhere():
    z = _inputs(n=8, d=32, f=16)
    xq, wq_t = _t(z["xq"]), _t(z["wq"].T)
    sx, sw, b = _t(z["sx"]), _t(z["sw"][0]), _t(z["b"])
    before = (w8a8.w8a8_fusedq_cuda.launches,
              w8a8.w8a8_prequant_cuda.launches)
    w8a8.dense_w8a8(xq, wq_t, sx, sw, b)
    w8a8.dense_w8a8_fusedq(torch.randn(8, 32).to(torch.bfloat16), wq_t, sw,
                           b, act="quick_gelu")
    assert (w8a8.w8a8_fusedq_cuda.launches,
            w8a8.w8a8_prequant_cuda.launches) == before
    with pytest.raises(ValueError, match="unsupported device"):
        w8a8.dense_w8a8(xq.to("meta"), wq_t, sx, sw, b)
    with pytest.raises(ValueError, match="activation"):
        w8a8.act_plain(torch.ones(2), "relu")
