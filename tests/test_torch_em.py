"""The port's fused EM iteration (plain version, CPU) against the JAX
package's TPU kernel ``fused_em_step_pallas`` (interpret mode) and its
XLA path ``em_iteration(fused=False)``, on the same numpy inputs.

Tolerances: labels and counts must be equal (the inputs keep every
nearest-center margin far above f32 and bf16 resolution).  Sums agree to
1e-4 relative + 1e-4 absolute and inertia to 1e-5 relative: f32 sums of a
few hundred rows taken in different orders (one-hot matmul vs the JAX
kernel's hi/lo bf16 split passes).  With ``x_bf16`` both sides round x to
bf16 once; the JAX kernel also splits the centers into bf16 hi + lo, so
its cross term carries ~2^-16 relative error against the port's f32 one —
still far below the margins.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scd_tpu.ops.em import em_iteration as jax_em_iteration
from scd_tpu.ops.pallas_kernels import fused_em_step_pallas
from scd_tpu_torch.ops.em import em_iteration

SUM_RTOL, SUM_ATOL, INERTIA_RTOL = 1e-4, 1e-4, 1e-5


def _inputs(n, d, k_data, k_centers, seed, masked):
    rng = np.random.default_rng(seed)
    cls = 3.0 * rng.standard_normal((k_data, d))
    lab = rng.integers(0, k_data, n)
    x = cls[lab] + 0.3 * rng.standard_normal((n, d))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    c = (cls[:k_centers] / np.linalg.norm(cls[:k_centers], axis=1,
                                          keepdims=True)).astype(np.float32)
    w = ((rng.random(n) > 0.25).astype(np.float32) if masked else None)
    return x, c, w


def _port(x, c, k, w, x_bf16):
    out = em_iteration(torch.from_numpy(x), torch.from_numpy(c), k,
                       row_w=None if w is None else torch.from_numpy(w),
                       fused=True, x_bf16=x_bf16)
    return [t.numpy() for t in out]


def _close(port, ref):
    lab, sums, counts, ine = port
    rl, rs, rc, ri = [np.asarray(t) for t in ref]
    np.testing.assert_array_equal(lab, rl)
    np.testing.assert_array_equal(counts, rc)
    np.testing.assert_allclose(sums, rs, rtol=SUM_RTOL, atol=SUM_ATOL)
    np.testing.assert_allclose(ine, ri, rtol=INERTIA_RTOL)


@pytest.mark.parametrize("n,d,k,masked,x_bf16", [
    (300, 48, 7, False, False),
    (300, 48, 7, True, False),     # row mask with zeros
    (260, 40, 130, True, False),   # K padded past one 128-lane tile
    (300, 48, 7, True, True),      # x stored as bf16
])
def test_em_matches_pallas_kernel(n, d, k, masked, x_bf16):
    x, c, w = _inputs(n, d, k, k, seed=n + k, masked=masked)
    ref = fused_em_step_pallas(jnp.asarray(x), jnp.asarray(c),
                               row_mask=None if w is None else jnp.asarray(w),
                               block_n=128, interpret=True, x_bf16=x_bf16)
    _close(_port(x, c, k, w, x_bf16), ref)


@pytest.mark.parametrize("masked", [False, True])
def test_em_matches_xla_path(masked):
    x, c, w = _inputs(400, 32, 9, 9, seed=5, masked=masked)
    ref = jax_em_iteration(jnp.asarray(x), jnp.asarray(c), 9,
                           row_w=None if w is None else jnp.asarray(w),
                           fused=False)
    _close(_port(x, c, 9, w, False), ref)


@pytest.mark.parametrize("fused", [False, True])
def test_em_k_larger_than_centers(fused):
    """k > centers rows: far sentinels pad the centers (never win, zero
    sums and counts), so results are [k]-shaped on every path."""
    x, c, w = _inputs(200, 16, 5, 5, seed=9, masked=True)
    ref = jax_em_iteration(jnp.asarray(x), jnp.asarray(c), 8,
                           row_w=jnp.asarray(w), fused=fused)
    port = em_iteration(torch.from_numpy(x), torch.from_numpy(c), 8,
                        row_w=torch.from_numpy(w), fused=fused)
    port = [t.numpy() for t in port]
    assert port[1].shape == (8, 16) and port[2].shape == (8,)
    np.testing.assert_array_equal(port[2][5:], 0.0)
    _close(port, ref)


def test_em_k_smaller_than_centers_raises():
    x, c, _ = _inputs(20, 4, 3, 3, seed=0, masked=False)
    with pytest.raises(ValueError, match="centers rows"):
        em_iteration(torch.from_numpy(x), torch.from_numpy(c), 2)


def test_em_kernel_wrapper_refuses_cpu_tensors():
    from scd_tpu_torch.ops.em import fused_em_step_cuda

    x, c, _ = _inputs(20, 4, 3, 3, seed=0, masked=False)
    with pytest.raises(ValueError, match="CUDA"):
        fused_em_step_cuda(torch.from_numpy(x), torch.from_numpy(c))


@pytest.mark.parametrize("n,d,k,x_bf16,aligned", [
    (97_536, 768, 100, True, True),    # the main path: x read where it lies
    (97_536, 768, 100, False, True),   # f32 x: hi and lo written once
    (20_000, 768, 683, True, True),    # six center tiles of 128
    (3_001, 100, 130, True, True),     # D % 8 != 0: rows rewritten to 104
    (37, 768, 7, True, False),         # under one 64-row stage, unaligned x
    (1, 8, 1, True, True),
    (0, 16, 3, False, True),           # no rows: only the finalize runs
])
def test_em_plan_covers_every_row_once(n, d, k, x_bf16, aligned):
    """The kernels' plan (``ops.em.em_plan``): whole center tiles, rows
    rewritten exactly when TMA cannot read x where it lies, M-step runs
    that cover the padded rows with none empty, about one M-step unit per
    SM, and scratch buffers 1024-aligned, disjoint and large enough."""
    from scd_tpu_torch.ops.em import em_plan

    sms = 132
    p = em_plan(n, d, k, x_bf16, sms, aligned)
    assert p.kp % 128 == 0 and p.kp - 128 < k <= p.kp
    assert p.rewrite == (not x_bf16 or d % 8 != 0 or not aligned)
    assert p.dx == (-(-d // 8) * 8 if p.rewrite else d)
    assert p.dchunks * 128 >= p.dx > (p.dchunks - 1) * 128
    stages = -(-n // 64)
    assert p.eblocks == min(-(-n // 128), sms)
    if n:
        assert p.runs * p.run_stages >= stages > (p.runs - 1) * p.run_stages
        per_run = (p.kp // 128) * p.dchunks  # M-step units of one run
        assert p.run_stages == 1 or p.runs == 1 or (
            sms <= p.runs * per_run < sms + per_run)
    else:
        assert p.runs == 0
    sizes = {"chi": p.kp * p.dx * 2, "clo": p.kp * p.dx * 2, "csq": p.kp * 4,
             "xhi": n * p.dx * 2 if p.rewrite else 0,
             "xlo": 0 if x_bf16 else n * p.dx * 2, "lw": stages * 64 * 8,
             "part_sums": p.runs * p.kp * p.dchunks * 128 * 4,
             "part_counts": p.runs * p.kp * 4, "ine_part": p.eblocks * 4}
    spans = sorted((p.offsets[name], p.offsets[name] + size)
                   for name, size in sizes.items())
    assert all(off % 1024 == 0 for off in p.offsets.values())
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= p.work_bytes
