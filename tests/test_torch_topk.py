"""The port's ``classify_topk`` (plain version, CPU) against the JAX
package's TPU kernel ``topk_softmax_pallas`` (interpret mode) and its XLA
path ``_classify_topk_xla``, on the same numpy inputs.

Tolerances: indices must be equal (the inputs keep near-ties far above f32
resolution, except the exact ties, which both sides break by lowest
index).  Raw logits agree to 1e-4 absolute: scale 100 times f32 dot
products of unit vectors summed in different orders.  Softmax values
agree to 1e-5 absolute (relative error ~ the logit error, values <= 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scd_tpu.ops.pallas_kernels import topk_softmax_pallas
from scd_tpu.ops.topk import _classify_topk_xla
from scd_tpu_torch.ops.topk import classify_topk, classify_topk_plain

LOGIT_ATOL = 1e-4
PROB_ATOL = 1e-5


def _inputs(n, d, v, seed, dup=False):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((n, d)).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    w = rng.standard_normal((d, v)).astype(np.float32)
    w /= np.linalg.norm(w, axis=0, keepdims=True)
    if dup:  # exact ties: column 2j+1 repeats column 2j
        w[:, 1::2] = w[:, 0::2]
    return f, w


@pytest.mark.parametrize("n,d,v,k,softmax,dup", [
    (70, 32, 1000, 5, True, False),    # V not a multiple of the block
    (70, 32, 1000, 5, False, False),   # raw logits
    (33, 16, 600, 16, True, False),    # the kernel's largest k
    (40, 24, 512, 4, False, True),     # exact ties -> lowest index
])
def test_topk_matches_pallas_and_xla(n, d, v, k, softmax, dup):
    f, w = _inputs(n, d, v, seed=v + k, dup=dup)
    tv, ti = classify_topk(torch.from_numpy(f), torch.from_numpy(w), k,
                           scale=100.0, apply_softmax=softmax)
    assert ti.dtype == torch.int32 and tuple(ti.shape) == (n, k)
    pv, pi = topk_softmax_pallas(jnp.asarray(f), jnp.asarray(w), k,
                                 scale=100.0, block_n=128, block_v=256,
                                 apply_softmax=softmax, interpret=True)
    xv, xi = _classify_topk_xla(jnp.asarray(f), jnp.asarray(w), k, 100.0,
                                softmax)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(xi))
    atol = PROB_ATOL if softmax else LOGIT_ATOL
    np.testing.assert_allclose(tv.numpy(), np.asarray(pv), rtol=0, atol=atol)
    np.testing.assert_allclose(tv.numpy(), np.asarray(xv), rtol=0, atol=atol)
    if dup:
        odd = ti.numpy() % 2 == 1
        prev = np.concatenate([np.full((n, 1), -2), ti.numpy()[:, :-1]], 1)
        assert np.all(~odd | (prev == ti.numpy() - 1))


@pytest.mark.parametrize("k", [17, 32])
def test_topk_past_the_kernel_matches_jax(k):
    """k above the kernel's 16: both packages take the matmul route
    (``_classify_topk_xla`` in the JAX package); equal indices, values
    within the tolerances above, raw and softmax."""
    from scd_tpu.ops.topk import classify_topk as jax_classify_topk

    f, w = _inputs(60, 24, 700, seed=k)
    for softmax in (True, False):
        tv, ti = classify_topk(torch.from_numpy(f), torch.from_numpy(w), k,
                               scale=100.0, apply_softmax=softmax)
        jv, ji = jax_classify_topk(jnp.asarray(f), jnp.asarray(w), k,
                                   scale=100.0, apply_softmax=softmax)
        assert tuple(ti.shape) == (60, k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                                   atol=PROB_ATOL if softmax else LOGIT_ATOL)


def test_topk_chunking_is_invisible():
    f, w = _inputs(50, 16, 300, seed=3)
    a = classify_topk_plain(torch.from_numpy(f), torch.from_numpy(w), 5)
    b = classify_topk_plain(torch.from_numpy(f), torch.from_numpy(w), 5,
                            chunk_rows=7)
    assert torch.equal(a[1], b[1])
    # a CPU matmul may block rows differently per chunk size: f32 rounding
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=PROB_ATOL)


def test_topk_v_smaller_than_k_raises():
    f, w = _inputs(4, 8, 3, seed=0)
    with pytest.raises(ValueError, match="V >= k"):
        classify_topk(torch.from_numpy(f), torch.from_numpy(w), 5)
    with pytest.raises(ValueError, match="V >= k"):
        topk_softmax_pallas(jnp.asarray(f), jnp.asarray(w), 5,
                            interpret=True)


def test_topk_kernel_wrapper_refuses_cpu_tensors():
    f, w = _inputs(4, 8, 30, seed=0)
    from scd_tpu_torch.ops.topk import topk_softmax_cuda

    with pytest.raises(ValueError, match="CUDA"):
        topk_softmax_cuda(torch.from_numpy(f), torch.from_numpy(w), 3)
