"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``gpu`` marker and needs an NVIDIA GPU with
the CUDA toolkit (the kernels build with ``nvcc`` at first use).  Whether a
card is present is decided inside the ``cuda`` fixture, so every worker
collects the same tests; without a card they skip.  Run them on the card
with ``python -m pytest -m gpu --noconftest tests/test_torch_gpu.py``
(``tests/conftest.py`` imports JAX, which a CUDA machine need not have).

Tolerances: raw top-k logits agree to 2e-3 and softmax values to 5e-4
(f32 dot products summed in another order than cuBLAS's, at scale 100);
EM sums to 1e-4 relative + 1e-4 absolute and inertia to 1e-4 relative
(f32 sums in another order).  The inputs keep every margin far above
those errors, so indices, labels and counts must be equal.
"""

import contextlib
import dataclasses
import io

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    from scd_tpu_torch.core.device import f32_matmuls

    f32_matmuls()
    return torch.device("cuda")


def _unit(t, dim):
    return t / t.norm(dim=dim, keepdim=True)


@pytest.mark.parametrize("n,d,v,k", [(1_005, 64, 1_003, 5),
                                     (300, 100, 4_096, 16),
                                     (129, 32, 200, 1)])
def test_topk_kernel_matches_plain(cuda, n, d, v, k):
    from scd_tpu_torch.ops import topk

    g = torch.Generator(device=cuda).manual_seed(n + v)
    f = _unit(torch.randn(n, d, generator=g, device=cuda), 1)
    w = _unit(torch.randn(d, v, generator=g, device=cuda), 0)
    before = topk.topk_softmax_cuda.launches
    kv, ki = topk.classify_topk(f, w, k, apply_softmax=True)
    assert topk.topk_softmax_cuda.launches == before + 1
    pv, pi = topk.classify_topk_plain(f, w, k, apply_softmax=True)
    assert torch.equal(ki, pi)
    torch.testing.assert_close(kv, pv, rtol=0, atol=5e-4)
    raw_k = topk.topk_softmax_cuda(f, w, k)[2]
    raw_p, _ = topk.classify_topk_plain(f, w, k, apply_softmax=False)
    torch.testing.assert_close(raw_k, raw_p, rtol=0, atol=2e-3)


def test_topk_kernel_ties_go_to_lowest_index(cuda):
    from scd_tpu_torch.ops.topk import classify_topk

    g = torch.Generator(device=cuda).manual_seed(0)
    f = _unit(torch.randn(200, 48, generator=g, device=cuda), 1)
    w = _unit(torch.randn(48, 1_000, generator=g, device=cuda), 0)
    w[:, 1::2] = w[:, 0::2]
    _, idx = classify_topk(f, w, 6)
    odd = idx % 2 == 1
    prev = torch.cat([torch.full_like(idx[:, :1], -2), idx[:, :-1]], 1)
    assert bool((~odd | (prev == idx - 1)).all())


@pytest.mark.parametrize("n,d,k,masked,x_bf16", [
    (5_000, 768, 100, False, False), (1_005, 100, 7, True, False),
    (3_000, 64, 300, True, True)])
def test_em_kernel_matches_plain(cuda, n, d, k, masked, x_bf16):
    from scd_tpu_torch.ops import em
    from scd_tpu_torch.ops.segment import segment_sums

    g = torch.Generator(device=cuda).manual_seed(n + k)
    cls = 3.0 * torch.randn(k, d, generator=g, device=cuda)
    lab = torch.randint(0, k, (n,), generator=g, device=cuda)
    x = _unit(cls[lab] + 0.3 * torch.randn(n, d, generator=g, device=cuda),
              1).contiguous()
    c = _unit(cls, 1).contiguous()
    w = ((torch.rand(n, generator=g, device=cuda) > 0.3).float()
         if masked else None)
    before = em.fused_em_step_cuda.launches
    out = em.em_iteration(x, c, k, row_w=w, x_bf16=x_bf16)
    assert em.fused_em_step_cuda.launches == before + 1
    again = em.em_iteration(x, c, k, row_w=w, x_bf16=x_bf16)
    for a, b in zip(out, again):  # deterministic: identical bits
        assert torch.equal(a, b)
    xr = x.to(torch.bfloat16) if x_bf16 else x
    plab, psums, pcounts, pine = em.em_iteration_plain(xr, c, k, w)
    lab_k, sums, counts, ine = out
    assert torch.equal(lab_k.long(), plab.long())
    assert torch.equal(counts, pcounts)
    torch.testing.assert_close(sums, psums, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ine, pine, rtol=1e-4, atol=0)
    rs, _ = segment_sums(xr.float(), lab_k.long(), k, weights=w)
    torch.testing.assert_close(sums, rs, rtol=1e-4, atol=1e-4)


def test_cuda_tensor_never_reaches_plain_em(cuda):
    from scd_tpu_torch.ops.em import em_iteration

    x = torch.randn(10, 4, device=cuda)
    with pytest.raises(ValueError, match="CPU only"):
        em_iteration(x, x[:3].contiguous(), 3, fused=False)


def test_run_unsup_card_matches_cpu(cuda, tmp_path):
    """A tiny fabricated root: the card (kernels) and the CPU (plain
    versions) print the same metric lines from one cached clustering."""
    from scd_tpu_torch.ops import em, topk
    from scd_tpu_torch.pipelines.unsup import run_unsup
    from scd_tpu_torch.testing.fabricate import (fabricate_imagenet100,
                                                 imagenet100_config)

    cfg = imagenet100_config(str(tmp_path / "root"), n_init=2,
                             max_iterations=5)
    fabricate_imagenet100(cfg, seed=3, device="cuda", n_images=3_000,
                          d_feat=64, d_clip=32, vocab=2_000, n_genus=10)
    t0, e0 = topk.topk_softmax_cuda.launches, em.fused_em_step_cuda.launches
    with contextlib.redirect_stdout(io.StringIO()):
        res = run_unsup(cfg, device="cuda")
    assert topk.topk_softmax_cuda.launches > t0
    assert em.fused_em_step_cuda.launches > e0
    assert res["cluster_acc"][0] > 0.9
    lines = {}
    for dev in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run_unsup(dataclasses.replace(cfg, run_cluster=False),
                      device=dev)
        lines[dev] = buf.getvalue().splitlines()
    assert lines["cuda"] == lines["cpu"]
