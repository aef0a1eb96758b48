"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``gpu`` marker and needs an NVIDIA GPU with
the CUDA toolkit (the kernels build with ``nvcc`` at first use).  Whether a
card is present is decided inside the ``cuda`` fixture, so every worker
collects the same tests; without a card they skip.  Run them on the card
with ``python -m pytest -m gpu --noconftest tests/test_torch_gpu.py``
(``tests/conftest.py`` imports JAX, which a CUDA machine need not have).

Tolerances: raw top-k logits agree to 2e-3 and softmax values to 5e-4
(the kernel's split-bf16 products, error ~2^-16 relative per product, and
f32 sums in another order than cuBLAS's, at scale 100);
EM sums to 1e-4 relative + 1e-4 absolute and inertia to 1e-4 relative
(f32 sums in another order).  The inputs keep every margin far above
those errors, so indices, labels and counts must be equal.  The W8A8
kernels repeat the plain versions' arithmetic step by step, so their
outputs are equal before the activation (see each test for after).  The
attention kernel agrees with its plain version within the bound of
``_attention_within`` (bf16 rounding of p after sums in another order);
``estep_assign``'s labels are equal and its min distances within 1e-4.
"""

import contextlib
import dataclasses
import io

import numpy as np
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


@pytest.mark.parametrize("k", [17, 32])
def test_topk_past_the_kernel_takes_the_matmul_route(cuda, k):
    """k > 16 on the card: the JAX package's own route past its kernel
    (chunked f32 matmul, stable top-k), counted apart; the kernel does not
    launch, and the result is the plain version's.  That route runs the
    plain version itself, so the result is also held against the f64
    logits: indices within the tie band, softmax values within 5e-4."""
    from scd_tpu_torch.ops import topk

    g = torch.Generator(device=cuda).manual_seed(k)
    f = _unit(torch.randn(1_005, 64, generator=g, device=cuda), 1)
    w = _unit(torch.randn(64, 1_003, generator=g, device=cuda), 0)
    kern, route = topk.topk_softmax_cuda.launches, \
        topk.classify_topk.matmul_calls
    kv, ki = topk.classify_topk(f, w, k)
    assert topk.topk_softmax_cuda.launches == kern
    assert topk.classify_topk.matmul_calls == route + 1
    pv, pi = topk.classify_topk_plain(f, w, k)
    assert ki.shape == (1_005, k) and torch.equal(ki, pi)
    torch.testing.assert_close(kv, pv, rtol=0, atol=0)
    si = ki.sort(dim=1).values
    assert bool((si[:, 1:] != si[:, :-1]).all())
    exact = 100.0 * (f.double() @ w.double())
    ev = torch.sort(exact, dim=1, descending=True).values[:, :k]
    got = exact.gather(1, ki.long())
    assert (got - ev).abs().max().item() <= 2e-3
    m = exact.max(dim=1, keepdim=True).values
    want = torch.exp(got - m) / torch.exp(exact - m).sum(1, keepdim=True)
    torch.testing.assert_close(kv.double(), want, rtol=0, atol=5e-4)


@pytest.mark.parametrize("n,d,k,masked,x_bf16", [
    (5_000, 768, 100, False, False), (1_005, 100, 7, True, False),
    (3_000, 64, 300, True, True),
    (3_000, 64, 1, False, False), (3_000, 64, 1, True, True),  # K 1
    (20_000, 768, 683, True, False),  # six center tiles of 128
    (20_000, 768, 683, False, True),
    (37, 768, 100, False, True), (37, 96, 5, True, False)])  # N < 64
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


@pytest.mark.parametrize("k_active", [10, 100, 1_000])
def test_em_kernel_with_sentinel_slots_matches_plain(cuda, k_active):
    """``estimate_k``'s shape: 130,048 rows, 1,000 center slots, the ones
    at or past ``k_active`` at the 1e12 sentinel (squared norm ~7.7e26 at
    D 768); at k_active 10 a cluster holds ~13,000 rows.  Labels and
    counts equal, every sentinel slot empty, sums and inertia within the
    EM tolerances."""
    from scd_tpu_torch.cluster.estimate_k import SENTINEL
    from scd_tpu_torch.ops import em

    n, d, max_k = 130_048, 768, 1_000
    g = torch.Generator(device=cuda).manual_seed(k_active)
    cls = 3.0 * torch.randn(k_active, d, generator=g, device=cuda)
    lab = torch.randint(0, k_active, (n,), generator=g, device=cuda)
    x = _unit(cls[lab] + 0.3 * torch.randn(n, d, generator=g, device=cuda),
              1).contiguous()
    c = torch.full((max_k, d), SENTINEL, device=cuda)
    c[:k_active] = _unit(cls, 1)
    before = em.fused_em_step_cuda.launches
    lab_k, sums, counts, ine = em.em_iteration(x, c, max_k)
    assert em.fused_em_step_cuda.launches == before + 1
    plab, psums, pcounts, pine = em.em_iteration_plain(x, c, max_k)
    assert torch.equal(lab_k.long(), plab.long())
    assert torch.equal(counts, pcounts)
    assert int(counts[k_active:].abs().sum()) == 0
    assert bool((sums[k_active:] == 0).all())
    torch.testing.assert_close(sums, psums, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(ine, pine, rtol=1e-4, atol=0)


def test_fit_kmeans_dynamic_k_card_matches_cpu(cuda):
    """The dynamic-K Lloyd loop on the card (one kernel launch an
    iteration) and on the CPU from one set of initial centers, on blobs
    with no row near a tie: equal labels, inertia within 1e-4; and the
    objective equal at three K."""
    import importlib

    from scd_tpu_torch.ops import em
    from scd_tpu_torch.testing.fabricate import subclustered_blobs
    from scd_tpu_torch.testing.shared_centers import centers_drawn_on_cpu

    ek = importlib.import_module("scd_tpu_torch.cluster.estimate_k")
    x, y, mask_lab = subclustered_blobs(5_000, 64, 20)
    x_cpu = ek._normalized_device(x, "cpu")
    out = {}
    with centers_drawn_on_cpu(x) as reset:
        for dev in ("cuda", "cpu"):
            reset()
            before = em.fused_em_step_cuda.launches
            labels, inertia = ek.fit_kmeans_dynamic_k(
                None, x_cpu.to(dev), 20, 100, n_init=2, max_iterations=10)
            launches = em.fused_em_step_cuda.launches - before
            reset()
            obj = ek.labelled_acc_objective_dynamic(
                x, y, mask_lab, 100, n_init=2, max_iterations=10, device=dev)
            out[dev] = (labels, inertia, launches,
                        [obj(k) for k in (5, 20, 60)])
    (lc, ic, nc, ac), (lp, ip, npl, ap) = out["cuda"], out["cpu"]
    assert nc == 20 and npl == 0
    np.testing.assert_array_equal(lc, lp)
    assert abs(ic - ip) <= 1e-4 * abs(ip)
    assert ac == ap and ac[1] > max(ac[0], ac[2])


def test_fit_kmeans_numpy_runs_on_the_card(cuda):
    """With no ``device``, ``fit_kmeans`` sends numpy to the card: the
    fused EM kernel launches, and the labels recover the blobs."""
    from scd_tpu_torch.cluster.kmeans import fit_kmeans
    from scd_tpu_torch.core.config import ClusterConfig
    from scd_tpu_torch.ops import em

    rng = np.random.default_rng(0)
    centers = 4.0 * rng.standard_normal((5, 16))
    y = rng.integers(0, 5, 600)
    x = (centers[y] + 0.3 * rng.standard_normal((600, 16))).astype(
        np.float32)
    before = em.fused_em_step_cuda.launches
    res = fit_kmeans(x, ClusterConfig(n_clusters=5, n_init=2))
    assert em.fused_em_step_cuda.launches > before
    assert res.labels.shape == (600,)
    pairs = set(zip(res.labels.tolist(), y.tolist()))
    assert len(pairs) == 5  # one cluster per blob, one blob per cluster


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


def _w8a8_inputs(cuda, n, d, f, seed):
    from scd_tpu_torch.ops import w8a8

    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, d, generator=g, device=cuda).to(torch.bfloat16)
    wq_t, s_w = w8a8.prepare_weight(
        0.02 * torch.randn(d, f, generator=g, device=cuda))
    bias = 0.1 * torch.randn(f, generator=g, device=cuda)
    return x, wq_t, s_w, bias


def _within_one_bf16_ulp(got, want):
    # one bf16 ulp of |v| is at most |v| * 2^-7
    return bool(((got.float() - want.float()).abs()
                 <= want.float().abs() * 2.0 ** -7 + 1e-30).all())


@pytest.mark.parametrize("n,d,f,act,out", [
    (1_000, 768, 2_304, None, torch.bfloat16),
    (777, 512, 200, "quick_gelu", torch.float32),
    (129, 64, 130, "gelu_tanh", torch.bfloat16),
    (300, 128, 256, "gelu", torch.float32),
    # the wgmma design's edges: one 128-byte slice of D, a ragged last
    # slice, the widest panel (2-stage ring), N and F off the tiles
    (77, 16, 9, None, torch.bfloat16),
    (301, 80, 129, "quick_gelu", torch.bfloat16),
    (3_001, 768, 2_310, None, torch.bfloat16),
    (500, 1_536, 300, "gelu_tanh", torch.bfloat16)])
def test_w8a8_fusedq_kernel_matches_plain(cuda, n, d, f, act, out):
    """Before the activation the kernel's output equals the plain
    version's bit for bit (same quantization, exact int32 products, the
    same rounded dequant steps); after it, within one bf16 ulp (bf16 out)
    or 2e-6 relative (f32 out): exp, tanh and erf may differ in the last
    f32 bit."""
    from scd_tpu_torch.ops import w8a8

    x, wq_t, s_w, bias = _w8a8_inputs(cuda, n, d, f, n + f)
    before = w8a8.w8a8_fusedq_cuda.launches
    got = w8a8.dense_w8a8_fusedq(x, wq_t, s_w, bias, out_dtype=out, act=act)
    assert w8a8.w8a8_fusedq_cuda.launches == before + 1
    assert torch.equal(got, w8a8.w8a8_fusedq_cuda(x, wq_t, s_w, bias, out,
                                                  act))
    want = w8a8.dense_w8a8_fusedq_plain(x, wq_t, s_w, bias, out, act)
    assert got.shape == (n, f) and got.dtype == out
    if act is None:
        assert torch.equal(got, want)
    elif out == torch.bfloat16:
        assert _within_one_bf16_ulp(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=2e-6, atol=1e-7)
    pre = w8a8.w8a8_fusedq_cuda(x, wq_t, s_w, bias, torch.float32, None)
    assert torch.equal(pre, w8a8.dense_w8a8_fusedq_plain(
        x, wq_t, s_w, bias, torch.float32, None))


@pytest.mark.parametrize("shape", [(1_003, 768), (4, 197, 512),
                                   # layers wider than w8a8_fusedq takes,
                                   # and the unpadded qkv layer's rows
                                   (1_003, 2_048), (5, 197, 3_072),
                                   (25_216, 768)])
def test_w8a8_prequant_kernel_matches_plain(cuda, shape):
    """Pre-quantized x, 2-D and rank 3 (L = 197, the unpadded tower):
    equal bits to the plain version, f32 and bf16 out; where every partial
    sum is exact in f32 (D <= 1040) the int32 accumulators equal the exact
    product (unit scales, zero bias)."""
    from scd_tpu_torch.ops import w8a8

    d, f = shape[-1], 2_000
    x, wq_t, s_w, bias = _w8a8_inputs(cuda, int(np.prod(shape[:-1])), d, f,
                                      d)
    xq, s_x = w8a8.quantize_rows(x.reshape(*shape))
    fn = w8a8.dense_w8a8_3d if len(shape) == 3 else w8a8.dense_w8a8
    for out in (torch.float32, torch.bfloat16):
        before = w8a8.w8a8_prequant_cuda.launches
        got = fn(xq, wq_t, s_x, s_w, bias, out_dtype=out)
        assert w8a8.w8a8_prequant_cuda.launches == before + 1
        want = w8a8.dense_w8a8_plain(xq.reshape(-1, d), wq_t, s_x, s_w, bias,
                                     out).reshape(got.shape)
        assert torch.equal(got, want)
    if d > 1040:
        return
    n = xq.numel() // d
    acc = w8a8.w8a8_prequant_cuda(xq.reshape(n, d), torch.ones(n, device=cuda),
                                  wq_t, torch.ones(f, device=cuda),
                                  torch.zeros(f, device=cuda), torch.float32)
    exact = xq.reshape(n, d).double() @ wq_t.double().t()
    assert torch.equal(acc.double(), exact)  # |acc| < 2^24 at D <= 1040


def test_int8dense_routes_by_shape(cuda):
    """Int8Dense on the card: [B, 208, D] -> w8a8_fusedq (the padded
    tower), [B, 197, D] or D wider than w8a8_fusedq takes -> the
    quantization chain + w8a8_prequant."""
    from scd_tpu_torch.models.vit import Int8Dense
    from scd_tpu_torch.ops import w8a8

    layer = Int8Dense(64, 96, out_dtype=torch.bfloat16, act="quick_gelu",
                      device=cuda)
    with torch.no_grad():
        layer.kernel.normal_(0, 0.05)
        layer.bias.normal_(0, 0.1)
    fq, pq = w8a8.w8a8_fusedq_cuda.launches, w8a8.w8a8_prequant_cuda.launches
    y = layer(torch.randn(2, 208, 64, device=cuda))
    assert y.shape == (2, 208, 96) and y.dtype == torch.bfloat16
    assert w8a8.w8a8_fusedq_cuda.launches == fq + 1
    y = layer(torch.randn(2, 197, 64, device=cuda))
    assert y.shape == (2, 197, 96)
    assert w8a8.w8a8_prequant_cuda.launches == pq + 1
    d = w8a8.PANEL_MAX_D + 64
    wide = Int8Dense(d, 32, out_dtype=torch.bfloat16, device=cuda)
    with torch.no_grad():
        wide.kernel.normal_(0, 0.05)
    fq = w8a8.w8a8_fusedq_cuda.launches
    x = torch.randn(2, 16, d, device=cuda)
    y = wide(x)
    assert w8a8.w8a8_fusedq_cuda.launches == fq
    assert w8a8.w8a8_prequant_cuda.launches == pq + 2
    wq_t, s_w = w8a8.prepare_weight(wide.kernel)
    xq, s_x = w8a8.quantize_rows(x.reshape(-1, d))
    assert torch.equal(y.reshape(-1, 32), w8a8.dense_w8a8_plain(
        xq, wq_t, s_x, s_w, wide.bias, torch.bfloat16))
    with pytest.raises(ValueError, match="D <= "):
        w8a8.w8a8_fusedq_cuda(x.reshape(-1, d).bfloat16(), wq_t, s_w,
                              wide.bias)
    with pytest.raises(ValueError, match="multiple of 16"):
        w8a8.w8a8_fusedq_cuda(torch.randn(4, 40, device=cuda).bfloat16(),
                              torch.zeros(8, 40, dtype=torch.int8,
                                          device=cuda),
                              torch.ones(8, device=cuda),
                              torch.zeros(8, device=cuda))


def _attention_within(got, want, v):
    """bf16: one output ulp (2^-7 relative) plus 2^-8 max|v| for p values
    that round one bf16 ulp apart after row sums in another order; f32:
    1e-5 max|v| (sums in another order)."""
    err = (got.float() - want.float()).abs()
    vmax = v.float().abs().max()
    if got.dtype == torch.bfloat16:
        bound = 2.0 ** -7 * want.float().abs() + 2.0 ** -8 * vmax
    else:
        bound = 1e-5 * vmax
    return bool((err <= bound).all())


@pytest.mark.parametrize("b,length,h,causal,l_valid,dtype", [
    (4, 197, 12, False, None, torch.bfloat16),
    (3, 208, 12, False, 197, torch.bfloat16),
    (6, 77, 8, True, None, torch.bfloat16),
    (5, 80, 8, True, None, torch.bfloat16),
    (3, 5, 5, False, None, torch.bfloat16),
    # the persistent design's edges: L 1 and the text buckets 16 / 32,
    # 256 keys (the N = 128 + 128 score pieces), and B x H pairs that are
    # not a multiple of the grid (133, 143, 135, 134 pairs)
    (7, 1, 19, True, None, torch.bfloat16),
    (11, 16, 13, False, None, torch.bfloat16),
    (9, 32, 15, True, None, torch.bfloat16),
    (67, 80, 2, True, None, torch.bfloat16),
    (5, 256, 7, True, None, torch.bfloat16),
    (4, 256, 7, False, 200, torch.bfloat16),
    (2, 77, 8, True, 60, torch.float32)])
def test_attention_kernel_matches_plain(cuda, b, length, h, causal, l_valid,
                                        dtype):
    """Both entry points launch the kernel once each and agree with the
    plain version (see ``_attention_within``); two runs repeat their
    bits."""
    from scd_tpu_torch.ops import attention as A

    g = torch.Generator(device=cuda).manual_seed(length + h)
    qkv = torch.randn(b, length, 3 * h * 64, generator=g,
                      device=cuda).to(dtype)
    t = qkv.unflatten(-1, (3, h, 64))
    q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]
    before = A.attention_cuda.launches
    got = A.qkv_attention(qkv, h, 0.125, causal, l_valid)
    got_vit = A.vit_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              0.125, causal, l_valid)
    assert A.attention_cuda.launches == before + 2
    assert got.shape == (b, length, h * 64) and got.dtype == dtype
    assert torch.equal(got.reshape(b, length, h, 64), got_vit)
    assert torch.equal(got, A.qkv_attention(qkv, h, 0.125, causal, l_valid))
    want = A.attention_plain(q, k, v, 0.125, causal, l_valid)
    assert _attention_within(got_vit, want, v)


@pytest.mark.parametrize("b,length,h,causal,l_valid,dtype", [
    (2, 257, 12, False, None, torch.bfloat16),
    (2, 257, 5, True, None, torch.bfloat16),
    (3, 325, 4, False, 300, torch.bfloat16),
    (1, 325, 3, True, 290, torch.float32),
    (1, 577, 12, False, None, torch.bfloat16),
    (1, 577, 2, True, None, torch.bfloat16),
    (2, 577, 3, False, 500, torch.float32),
    (1, 300, 2, False, None, torch.float32),
    (1, 785, 12, False, None, torch.bfloat16),
    (2, 785, 3, True, None, torch.bfloat16),
    (2, 785, 4, False, 700, torch.bfloat16),
    (1, 785, 2, True, 600, torch.bfloat16),
    (1, 1025, 3, False, None, torch.bfloat16),
    (1, 1025, 2, True, 900, torch.bfloat16)])
def test_attention_long_path_matches_plain(cuda, b, length, h, causal,
                                           l_valid, dtype):
    """L > 256 (towers at image 256, 288, 384, 448, 512): the key-tiled
    long paths, counted apart, through both entry points: bf16 (head_dim
    64) on the ``wgmma`` long path, its key tiles resident up to L 832 and
    streamed past it (L 1,025), f32 (head_dim 64) on the f32 kernel (three
    TF32 passes on ``wgmma``, any L); agrees with the plain version within
    ``_attention_within`` and repeats its bits."""
    from scd_tpu_torch.ops import attention as A

    g = torch.Generator(device=cuda).manual_seed(length + h)
    qkv = torch.randn(b, length, 3 * h * 64, generator=g,
                      device=cuda).to(dtype)
    t = qkv.unflatten(-1, (3, h, 64))
    q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]
    before, long_before, wgmma_before = A.attention_cuda.launches, \
        A.attention_cuda.long_launches, A.attention_cuda.long_wgmma_launches
    f32_before = A.attention_cuda.f32_wgmma_launches
    got = A.qkv_attention(qkv, h, 0.125, causal, l_valid)
    got_vit = A.vit_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              0.125, causal, l_valid)
    assert A.attention_cuda.launches == before + 2
    assert A.attention_cuda.long_launches == long_before + 2
    assert A.attention_cuda.long_wgmma_launches == wgmma_before + 2 * (
        dtype == torch.bfloat16)
    assert A.attention_cuda.f32_wgmma_launches == f32_before + 2 * (
        dtype == torch.float32)
    assert got.shape == (b, length, h * 64) and got.dtype == dtype
    assert torch.equal(got.reshape(b, length, h, 64), got_vit)
    assert torch.equal(got, A.qkv_attention(qkv, h, 0.125, causal, l_valid))
    want = A.attention_plain(q, k, v, 0.125, causal, l_valid)
    assert _attention_within(got_vit, want, v)


def test_attention_kernel_refuses_what_it_does_not_take(cuda):
    """bf16 at head_dim 32 and L 8 is no longer refused: it takes the
    key-tiled SIMT kernel (its own counter moves) and agrees with the
    plain version; L 300 takes the long path (its own counter moves);
    the SIMT long path takes head_dim <= 256; the bf16 long path, like
    the short one, refuses a view whose strides are not 16-byte
    multiples; f16 is refused."""
    from scd_tpu_torch.ops import attention as A

    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(1, 8, 2, 32, generator=g, device=cuda).to(torch.bfloat16)
    simt_before = A.attention_cuda.simt_bf16_launches
    got = A.vit_attention(x, x, x, 0.125)
    assert A.attention_cuda.simt_bf16_launches == simt_before + 1
    assert _attention_within(got, A.attention_plain(x, x, x, 0.125), x)
    y = torch.zeros(1, 300, 2, 64, dtype=torch.bfloat16, device=cuda)
    long_before = A.attention_cuda.long_launches
    out = A.vit_attention(y, y, y, 0.125)
    assert A.attention_cuda.long_launches == long_before + 1
    assert out.shape == y.shape and not bool(out.any())
    w = torch.zeros(1, 300, 1, 288, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        A.vit_attention(w, w, w, 0.125)
    u = torch.zeros(1, 300, 2, 68, dtype=torch.bfloat16,
                    device=cuda)[..., :64]  # head stride 68 elements
    wgmma_before = A.attention_cuda.long_wgmma_launches
    with pytest.raises(ValueError, match="16-byte-aligned"):
        A.vit_attention(u, u, u, 0.125)
    assert A.attention_cuda.long_wgmma_launches == wgmma_before
    z = torch.zeros(1, 8, 2, 64, dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        A.vit_attention(z, z, z, 0.125)
    f = torch.zeros(2 * 300 * 2 * 64 + 1, device=cuda)[1:].view(2, 300, 2, 64)
    f32_before = A.attention_cuda.f32_wgmma_launches
    with pytest.raises(ValueError, match="16-byte-aligned"):
        A.vit_attention(f, f, f, 0.125)  # f32 at head_dim 64: no SIMT
    assert A.attention_cuda.f32_wgmma_launches == f32_before


@pytest.mark.parametrize("b,s,n_pre,p_valid,h,d,dtype,packed", [
    (512, 16, 16, 11, 8, 64, torch.bfloat16, True),  # the build's shapes
    (512, 8, 16, 16, 8, 64, torch.bfloat16, True),
    # the mma.sync kernel (bf16, head_dim 64) at the edges: S 1, 7, 8, 9,
    # 16; P 0, 1, 16; p_valid 1, 11, P; B 1, 3 and batches that no grid of
    # about one block an SM divides; H 12 (two groups of six heads), H 3
    (1, 1, 16, 1, 8, 64, torch.bfloat16, True),
    (3, 7, 1, 1, 8, 64, torch.bfloat16, False),
    (3, 9, 0, 0, 8, 64, torch.bfloat16, True),
    (1, 16, 16, 16, 8, 64, torch.bfloat16, False),
    (3, 8, 16, 11, 8, 64, torch.bfloat16, False),
    (1_001, 8, 16, 11, 8, 64, torch.bfloat16, True),
    (8_191, 16, 16, 16, 8, 64, torch.bfloat16, False),
    (5, 16, 16, 11, 12, 64, torch.bfloat16, True),
    (3, 9, 16, 11, 3, 64, torch.bfloat16, False),
    (2, 15, 17, 17, 2, 64, torch.bfloat16, False),  # 32 keys, P > 16
    # the SIMT kernel: f32, and bf16 at another head_dim
    (64, 16, 16, 9, 8, 64, torch.float32, True),
    (3, 8, 16, 11, 8, 32, torch.bfloat16, True),
    (9, 5, 3, 0, 3, 38, torch.bfloat16, False),  # scalar loads, d pad 40
    (3, 16, 16, 20, 2, 128, torch.float32, False),  # 32 keys, d 128
    (7, 1, 0, 0, 5, 13, torch.float32, False)])
def test_prefix_attention_kernel_matches_plain(cuda, b, s, n_pre, p_valid,
                                               h, d, dtype, packed):
    """The prefix attention kernels (``csrc/prefix_attention.cu``) against
    their plain version within ``_attention_within`` (max|v| over the
    prefix's values and the suffix's), on views of a packed qkv or
    contiguous tensors; one launch a call, on the ``mma.sync`` kernel
    exactly for bf16 at head_dim 64, and two runs repeat their bits."""
    from scd_tpu_torch.ops import attention as A

    g = torch.Generator(device=cuda).manual_seed(s + n_pre + d)
    if packed:
        qkv = torch.randn(b, s, 3 * h * d, generator=g, device=cuda).to(dtype)
        t = qkv.unflatten(-1, (3, h, d))
        q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]
    else:
        q, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype)
                   for _ in range(3))
    pk, pv = (torch.randn(n_pre, h, d, generator=g, device=cuda).to(dtype)
              for _ in range(2))
    mma = dtype == torch.bfloat16 and d == 64
    before = A.prefix_attention_cuda.launches
    mma_before = A.prefix_attention_cuda.mma_launches
    got = A.prefix_attention(q, k, v, pk, pv, d ** -0.5, p_valid)
    assert A.prefix_attention_cuda.launches == before + 1
    assert A.prefix_attention_cuda.mma_launches == mma_before + mma
    assert got.shape == (b, s, h, d) and got.dtype == dtype
    assert torch.equal(got, A.prefix_attention(q, k, v, pk, pv, d ** -0.5,
                                               p_valid))
    want = A.prefix_attention_plain(q, k, v, pk, pv, d ** -0.5, p_valid)
    assert _attention_within(got, want, torch.cat([v.flatten(),
                                                   pv.flatten()]))


def test_prefix_attention_kernel_refuses_what_it_does_not_take(cuda):
    from scd_tpu_torch.ops import attention as A

    x = torch.zeros(2, 17, 2, 64, device=cuda)
    p = torch.zeros(4, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="S <= 16"):
        A.prefix_attention(x, x, x, p, p, 0.125, 4)
    y = torch.zeros(2, 16, 2, 64, device=cuda)
    for n_pre in (17, 48):  # 33 and 64 keys
        pp = torch.zeros(n_pre, 2, 64, device=cuda)
        with pytest.raises(ValueError, match="P \\+ S <= 32"):
            A.prefix_attention(y, y, y, pp, pp, 0.125, 4)
    z = torch.zeros(2, 16, 2, 136, device=cuda)
    pz = torch.zeros(4, 2, 136, device=cuda)
    with pytest.raises(ValueError, match="head_dim <= 128"):
        A.prefix_attention(z, z, z, pz, pz, 0.125, 4)
    with pytest.raises(TypeError):
        A.prefix_attention(y.half(), y.half(), y.half(), p.half(),
                           p.half(), 0.125, 4)
    yg = y.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="gradient"):
        A.prefix_attention(yg, y, y, p, p, 0.125, 4)
    # bf16 at head_dim 64 (the mma.sync kernel) takes 16-byte-aligned views
    # only, and raises on others rather than taking the SIMT kernel
    yb, pb = y.bfloat16(), p.bfloat16()
    odd = torch.zeros(2, 16, 2, 68, dtype=torch.bfloat16,
                      device=cuda)[..., :64]  # head stride 68 elements
    shifted = torch.zeros(2 * 16 * 2 * 64 + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(2, 16, 2, 64)
    for bad in (odd, shifted):
        before = (A.prefix_attention_cuda.launches,
                  A.prefix_attention_cuda.mma_launches)
        with pytest.raises(ValueError, match="16-byte-aligned"):
            A.prefix_attention(bad, yb, yb, pb, pb, 0.125, 4)
        assert (A.prefix_attention_cuda.launches,
                A.prefix_attention_cuda.mma_launches) == before


@pytest.mark.parametrize("pixels", [64, 256])
def test_tower_attention_runs_the_kernel(cuda, pixels):
    """A bf16 CLIP image tower on the card launches the attention kernel
    once per block and agrees with the same tower on the CPU in f32; at
    256 px (a 16 x 16 grid on a 4 x 4 position grid, L 257) through the
    long path."""
    from scd_tpu_torch.models import CLIPModel, params_from_flax
    from scd_tpu_torch.models.clip import CLIPConfig
    from scd_tpu_torch.models.vit import ViTConfig
    from scd_tpu_torch.ops import attention as A
    from scd_tpu_torch.testing.fabricate import clip_state_dict
    from scd_tpu_torch.models.clip import load_openai_clip_weights

    def cfg(dt):
        return CLIPConfig(vision=ViTConfig(
            image_size=64, patch_size=16, width=128, depth=3, heads=2,
            quick_gelu=True, pre_post_norm=True, output_proj=32,
            patch_bias=False, norm_eps=1e-5, compute_dtype=dt),
            vocab_size=100, context_length=16, text_width=64, text_depth=1,
            text_heads=1, embed_dim=32, compute_dtype=dt)

    sd = params_from_flax(load_openai_clip_weights(
        clip_state_dict(cfg(torch.float32), seed=1), cfg(torch.float32)))
    x = torch.randn(4, pixels, pixels, 3,
                    generator=torch.Generator().manual_seed(0))
    models = {}
    for dev, dt in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        models[dev] = CLIPModel(cfg(dt), device=dev).eval()
        models[dev].load_state_dict(sd)
    before, long_before = A.attention_cuda.launches, \
        A.attention_cuda.long_launches
    with torch.inference_mode():
        card = models["cuda"].encode_image(x.to(cuda)).cpu()
        cpu = models["cpu"].encode_image(x)
    assert A.attention_cuda.launches == before + 3
    assert A.attention_cuda.long_launches == long_before + 3 * (pixels > 64)
    cos = torch.nn.functional.cosine_similarity(card.double(), cpu.double())
    assert cos.min().item() > 0.999  # bf16 activations through 3 blocks


@pytest.mark.parametrize("n,d,k,ties", [(5_000, 768, 100, False),
                                        (1_001, 64, 1, False),
                                        (3_000, 100, 130, True),
                                        # x a view at row offset 1 (not
                                        # 16-byte aligned at D 101), three
                                        # center tiles, the runners' shape
                                        (1_001, 101, 7, "view"),
                                        (20_000, 768, 300, False),
                                        (130_048, 768, 100, False)])
def test_estep_kernel_matches_plain(cuda, n, d, k, ties):
    """Labels equal to the plain version's (unit rows, margins far above
    f32 error; exact ties go to the lower index), min distances within
    1e-4; two runs repeat their bits.  ``ties`` "view": no ties, x the rows
    from 1 on of a contiguous [N + 1, D] tensor."""
    from scd_tpu_torch.ops import distance as D

    g = torch.Generator(device=cuda).manual_seed(n + k)
    cls = 3.0 * torch.randn(k, d, generator=g, device=cuda)
    rows = n + 1 if ties == "view" else n
    lab = torch.randint(0, k, (rows,), generator=g, device=cuda)
    x = _unit(cls[lab] + 0.5 * torch.randn(rows, d, generator=g, device=cuda),
              1)[rows - n:]
    c = _unit(cls + 0.05 * torch.randn(k, d, generator=g, device=cuda), 1)
    ties = ties is True
    if ties:
        c[1::2] = c[0::2]
    before = D.estep_assign_cuda.launches
    got = D.estep_assign(x, c)
    assert D.estep_assign_cuda.launches == before + 1
    again = D.estep_assign(x, c)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    want = D.estep_assign_plain(x, c)
    assert torch.equal(got[0], want[0].to(torch.int32))
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-4)
    if ties:
        assert bool((got[0] % 2 == 0).all())


def test_optimal_runner_card_matches_cpu(cuda, tmp_path):
    """``main --optimal`` on the card (estep kernel) prints the CPU's
    lines."""
    from scd_tpu_torch.cluster.runners import main
    from scd_tpu_torch.ops import distance as D

    rng = np.random.default_rng(0)
    targets = rng.integers(0, 20, 4_000)
    feats = (3.0 * rng.standard_normal((20, 64)))[targets] \
        + rng.standard_normal((4_000, 64))
    path = str(tmp_path / "store.npz")
    np.savez(path, features=feats.astype(np.float32), targets=targets,
             mask_lab=(rng.random(4_000) < 0.3) & (targets < 10))
    lines = {}
    for dev in ("cuda", "cpu"):
        before = D.estep_assign_cuda.launches
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(["--features", path, "--n_train_classes", "10", "--optimal",
                  "--device", dev])
        lines[dev] = buf.getvalue().splitlines()
        assert D.estep_assign_cuda.launches == before + (dev == "cuda")
    assert lines["cuda"] == lines["cpu"] and len(lines["cpu"]) == 3


@pytest.mark.parametrize("v", [2_000, 20])
def test_topk_k1_raw_logits_matches_plain(cuda, v):
    """The zero-shot bound passes' call: k 1 over raw logits, over a
    vocabulary and over the ground-truth names alone (V = K)."""
    from scd_tpu_torch.ops import topk

    g = torch.Generator(device=cuda).manual_seed(v)
    f = _unit(torch.randn(3_000, 64, generator=g, device=cuda), 1)
    w = _unit(torch.randn(64, v, generator=g, device=cuda), 0)
    before = topk.topk_softmax_cuda.launches
    kv, ki = topk.classify_topk(f, w, 1, apply_softmax=False)
    assert topk.topk_softmax_cuda.launches == before + 1
    pv, pi = topk.classify_topk_plain(f, w, 1, apply_softmax=False)
    assert torch.equal(ki, pi)
    torch.testing.assert_close(kv, pv, rtol=0, atol=2e-3)


def test_run_ptsup_card_matches_cpu(cuda, tmp_path):
    """A tiny fabricated root: ptsup on the card (kernels) and on the CPU
    (plain versions) print the same lines from one cached clustering."""
    from scd_tpu_torch.ops import em, topk
    from scd_tpu_torch.pipelines.ptsup import run_ptsup
    from scd_tpu_torch.testing.fabricate import (fabricate_imagenet100,
                                                 imagenet100_config)

    cfg = dataclasses.replace(
        imagenet100_config(str(tmp_path / "root"), n_init=2,
                           max_iterations=5), partially_supervised=True)
    fabricate_imagenet100(cfg, seed=3, device="cuda", n_images=3_000,
                          d_feat=64, d_clip=32, vocab=2_000, n_genus=10)
    t0, e0 = topk.topk_softmax_cuda.launches, em.fused_em_step_cuda.launches
    with contextlib.redirect_stdout(io.StringIO()):
        res = run_ptsup(cfg, device="cuda")
    assert topk.topk_softmax_cuda.launches >= t0 + 3
    assert em.fused_em_step_cuda.launches > e0
    assert res["cluster_acc"][0] > 0.9
    lines = {}
    for dev in ("cuda", "cpu"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run_ptsup(dataclasses.replace(cfg, run_cluster=False),
                      device=dev)
        lines[dev] = buf.getvalue().splitlines()
    assert lines["cuda"] == lines["cpu"] and len(lines["cpu"]) > 12


@pytest.mark.parametrize("size_min,size_max", [(20, 400), (95, 105)])
def test_sinkhorn_assign_card_matches_cpu(cuda, size_min, size_max):
    """The Sinkhorn E-step on the card against the CPU: the same
    ``feasible``, duals within 1e-4 of the cost's std, labels equal outside
    the tie band (best and second-best reduced cost within 1e-3)."""
    from scd_tpu_torch.ops.sinkhorn import sinkhorn_constrained_assign

    g = torch.Generator().manual_seed(size_min)
    x = _unit(torch.randn(2_000, 32, generator=g), 1)
    c = _unit(torch.randn(20, 32, generator=g), 1)
    cost = torch.cdist(x, c)
    cpu = sinkhorn_constrained_assign(cost, 20, size_min, size_max, eps=0.01)
    card = sinkhorn_constrained_assign(cost.to(cuda), 20, size_min,
                                       size_max, eps=0.01)
    assert card.feasible == cpu.feasible and cpu.feasible
    std = float(cost.std(correction=0))
    torch.testing.assert_close(card.col_duals.cpu(), cpu.col_duals, rtol=0,
                               atol=1e-4 * std)
    red = ((cost - cpu.col_duals[None]) / std).sort(dim=1).values
    outside = (red[:, 1] - red[:, 0]) >= 1e-3
    assert torch.equal(card.labels.cpu()[outside], cpu.labels[outside])


def test_mcf_track_card_matches_cpu(cuda, monkeypatch):
    """The exact track from injected centers on the card and the CPU: the
    rounded costs differ by at most 1 on at most 0.1% of entries (the two
    f32 products differ in their last bits), labels are equal on >= 99.5%
    of rows, inertia within 1e-4 relative."""
    from scd_tpu_torch.cluster import constrained as C
    from scd_tpu_torch.core.config import ClusterConfig
    from scd_tpu_torch.ops.distance import pairwise_sqdist

    rng = np.random.default_rng(0)
    y = rng.integers(0, 20, 4_000)
    x = (2.0 * rng.standard_normal((20, 64)))[y] \
        + rng.standard_normal((4_000, 64))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    centers = x[rng.choice(4_000, 20, replace=False)]
    monkeypatch.setattr(C, "_seed_centers",
                        lambda u, *a, **kw: torch.as_tensor(centers,
                                                            device=u.device))
    costs = {d: C._costs(pairwise_sqdist(torch.as_tensor(x, device=d),
                                         torch.as_tensor(centers, device=d)))
             .cpu().numpy().astype(np.int64) for d in ("cuda", "cpu")}
    diff = np.abs(costs["cuda"] - costs["cpu"])
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    cfg = ClusterConfig(n_clusters=20, n_init=1, max_iterations=5,
                        size_min=100, size_max=300, constrained_backend="mcf")
    res = {d: C.fit_constrained_unsup(x, cfg, device=d)
           for d in ("cuda", "cpu")}
    assert (res["cuda"].labels == res["cpu"].labels).mean() >= 0.995
    assert abs(res["cuda"].inertia - res["cpu"].inertia) \
        <= 1e-4 * res["cpu"].inertia
    counts = np.bincount(res["cuda"].labels, minlength=20)
    assert counts.min() >= 100 and counts.max() <= 300


def test_fit_constrained_numpy_runs_on_the_card(cuda, monkeypatch):
    """With no ``device``, numpy goes to the card (the Sinkhorn E-step
    sees CUDA costs); with no card the same call raises."""
    from scd_tpu_torch.cluster import constrained as C
    from scd_tpu_torch.core.config import ClusterConfig

    seen = []
    real = C.sinkhorn_constrained_assign

    def spy(cost, *a, **kw):
        seen.append(cost.device.type)
        return real(cost, *a, **kw)

    monkeypatch.setattr(C, "sinkhorn_constrained_assign", spy)
    rng = np.random.default_rng(1)
    y = rng.integers(0, 4, 600)
    x = ((4.0 * rng.standard_normal((4, 16)))[y]
         + 0.3 * rng.standard_normal((600, 16))).astype(np.float32)
    cfg = ClusterConfig(n_clusters=4, n_init=2, size_min=50, size_max=300)
    res = C.fit_constrained(x[:500], x[500:], y[500:], cfg)
    assert seen and set(seen) == {"cuda"}
    assert res.labels.shape == (600,)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        C.fit_constrained(x[:500], x[500:], y[500:], cfg)


@pytest.mark.parametrize("b,length,h,d,l_valid,dtype", [
    (8, 197, 12, 64, 197, torch.bfloat16),
    (8, 208, 12, 64, 197, torch.bfloat16),
    (3, 256, 5, 64, 256, torch.bfloat16),
    (7, 17, 3, 64, 9, torch.bfloat16),
    (5, 1, 2, 64, 1, torch.bfloat16),
    (2, 257, 12, 64, 257, torch.bfloat16),
    (2, 577, 12, 64, 577, torch.bfloat16),
    (3, 300, 2, 64, 289, torch.bfloat16),
    (4, 197, 12, 64, 197, torch.float32),
    (3, 257, 12, 64, 250, torch.float32),
    (2, 577, 5, 64, 577, torch.float32),
    (5, 1, 2, 64, 1, torch.float32),
    (3, 77, 2, 128, 70, torch.float32),
    (2, 33, 3, 40, 33, torch.float32),
])
def test_attention_bwd_kernel_matches_plain(cuda, b, length, h, d, l_valid,
                                            dtype):
    from scd_tpu_torch.ops import attention as A
    from scd_tpu_torch.testing.attention_grad import grad_bound

    g = torch.Generator(device=cuda).manual_seed(length * h + d)
    qkv = torch.randn(b, length, 3 * h * d, generator=g, device=cuda
                      ).to(dtype)
    dout = torch.randn(b, length, h * d, generator=g, device=cuda).to(dtype)
    before = A.qkv_attention_bwd_cuda.launches
    got = A.qkv_attention_bwd_cuda(qkv, dout, h, d ** -0.5, False, l_valid)
    again = A.qkv_attention_bwd_cuda(qkv, dout, h, d ** -0.5, False, l_valid)
    assert A.qkv_attention_bwd_cuda.launches == before + 2
    assert torch.equal(got, again)
    want = A.qkv_attention_bwd_plain(qkv, dout, h, d ** -0.5, False, l_valid)
    bound = grad_bound(qkv, dout, h, d ** -0.5, l_valid, want)
    assert bool(((got.float() - want.float()).abs() <= bound).all())
    dk_dv = got.view(b, length, 3, h, d)[:, l_valid:, 1:]
    assert bool((dk_dv == 0).all())


def test_attention_gradient_flows_through_the_function(cuda):
    """qkv_attention under grad mode routes through AttentionFunction: the
    forward kernel, then one launch of the gradient kernel."""
    from scd_tpu_torch.ops import attention as A
    from scd_tpu_torch.testing.attention_grad import grad_bound

    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(4, 208, 3 * 768, generator=g, device=cuda).to(
        torch.bfloat16).requires_grad_(True)
    fwd, bwd = A.attention_cuda.launches, A.qkv_attention_bwd_cuda.launches
    out = A.qkv_attention(qkv, 12, 0.125, l_valid=197)
    out.float().square().sum().backward()
    assert A.attention_cuda.launches == fwd + 1
    assert A.qkv_attention_bwd_cuda.launches == bwd + 1
    want = A.qkv_attention_bwd_plain(qkv.detach(), (2 * out.float()).to(
        torch.bfloat16), 12, 0.125, False, 197)
    bound = grad_bound(qkv.detach(), 2 * out.float(), 12, 0.125, 197,
                       want)
    assert bool(((qkv.grad.float() - want.float()).abs() <= bound).all())
    with torch.no_grad():  # no graph: the forward alone, as serving runs
        A.qkv_attention(qkv, 12, 0.125, l_valid=197)
    assert A.qkv_attention_bwd_cuda.launches == bwd + 1


def test_attention_bwd_kernel_refuses_what_it_does_not_take(cuda):
    """A head_dim-64 view off the 16-byte grid and head_dim 288 raise,
    through the kernel and through autograd.  What it refused before this
    slice now runs and agrees with the plain gradient (the bound of
    ``testing/attention_grad.py``), each on its route: f32 at head_dim 32
    past L 256 and at head_dim 160, bf16 at head_dim 32 (SIMT), causal at
    head_dim 64 (``wgmma``)."""
    from scd_tpu_torch.ops import attention as A
    from scd_tpu_torch.testing.attention_grad import grad_bound

    bf = torch.bfloat16
    for qkv, heads, causal in (
            (torch.zeros(2 * 16 * 192 + 1, device=cuda)[1:].view(2, 16, 192),
             1, False),
            (torch.zeros(2, 16, 3 * 288, device=cuda, dtype=bf), 1, True)):
        dout = torch.zeros(*qkv.shape[:2], qkv.shape[2] // 3, device=cuda,
                           dtype=qkv.dtype)
        with pytest.raises((ValueError, NotImplementedError)):
            A.qkv_attention_bwd_cuda(qkv, dout, heads, 0.125, causal)
        with pytest.raises((ValueError, NotImplementedError)):
            A.qkv_attention(qkv.requires_grad_(True), heads, 0.125, causal
                            ).float().sum().backward()
    g = torch.Generator(device=cuda).manual_seed(21)
    for (b, length, w3, dtype), heads, causal, route in (
            ((2, 257, 96, torch.float32), 1, False, "simt"),
            ((2, 16, 192, bf), 1, True, "wgmma"),
            ((2, 16, 192, bf), 2, False, "simt"),
            ((2, 16, 3 * 160, torch.float32), 1, False, "simt")):
        qkv = torch.randn(b, length, w3, generator=g, device=cuda).to(dtype)
        dout = torch.randn(b, length, w3 // 3, generator=g,
                           device=cuda).to(dtype)
        assert A.bwd_route(dtype, w3 // (3 * heads)) == route
        got = A.qkv_attention_bwd_cuda(qkv, dout, heads, 0.125, causal)
        want = A.qkv_attention_bwd_plain(qkv, dout, heads, 0.125, causal)
        bound = grad_bound(qkv, dout, heads, 0.125, None, want, causal)
        assert bool(((got.float() - want.float()).abs() <= bound).all())


@pytest.mark.parametrize("b,length,h,d,dtype,causal,l_valid", [
    (16, 197, 2, 32, torch.bfloat16, False, None),  # micro at 224 px
    (8, 5, 2, 32, torch.bfloat16, False, None),  # micro at 32 px
    (4, 290, 2, 32, torch.float32, False, 280),  # e2e micro at 136 px
    (6, 77, 8, 64, torch.bfloat16, True, None),  # the text tower
    (6, 77, 8, 64, torch.float32, True, None),
    (3, 300, 4, 64, torch.bfloat16, True, 290),
    (3, 300, 4, 64, torch.float32, True, 290),
    (5, 77, 4, 32, torch.bfloat16, True, 70)])
def test_attention_bwd_routes_match_plain(cuda, b, length, h, d, dtype,
                                          causal, l_valid):
    """The gradient's SIMT route (head_dim != 64, bf16 or f32, any L) and
    causal on every route against autograd of the plain attention, within
    ``testing/attention_grad.py``'s bound, the bits repeated, the route's
    counters moved; keys at or past l_valid get no dK, dV."""
    from scd_tpu_torch.ops import attention as A
    from scd_tpu_torch.testing.attention_grad import grad_bound

    g = torch.Generator(device=cuda).manual_seed(length + d)
    qkv = torch.randn(b, length, 3 * h * d, generator=g,
                      device=cuda).to(dtype)
    dout = torch.randn(b, length, h * d, generator=g, device=cuda).to(dtype)
    simt, caus = (A.qkv_attention_bwd_cuda.simt_launches,
                  A.qkv_attention_bwd_cuda.causal_launches)
    got = A.qkv_attention_bwd_cuda(qkv, dout, h, d ** -0.5, causal, l_valid)
    assert torch.equal(got, A.qkv_attention_bwd_cuda(qkv, dout, h, d ** -0.5,
                                                     causal, l_valid))
    assert A.qkv_attention_bwd_cuda.simt_launches == simt + 2 * (d != 64)
    assert A.qkv_attention_bwd_cuda.causal_launches == caus + 2 * causal
    want = A.qkv_attention_bwd_plain(qkv, dout, h, d ** -0.5, causal,
                                     l_valid)
    bound = grad_bound(qkv, dout, h, d ** -0.5, l_valid, want, causal)
    assert bool(((got.float() - want.float()).abs() <= bound).all())
    lv = length if l_valid is None else l_valid
    assert not bool(A._heads(got, h)[1][:, lv:].any())
    assert not bool(A._heads(got, h)[2][:, lv:].any())


@pytest.mark.parametrize("length", [1, 5, 17, 197, 300])
@pytest.mark.parametrize("d", [8, 32, 128])
def test_attention_bf16_simt_route_matches_plain(cuda, length, d):
    """bf16 at a head_dim other than 64 takes the key-tiled SIMT kernel at
    every L (``attention_route``), causal and not, with l_valid < L;
    within ``_attention_within``."""
    from scd_tpu_torch.ops import attention as A

    assert A.attention_route(torch.bfloat16, d, length) == "long_simt"
    g = torch.Generator(device=cuda).manual_seed(length * d)
    qkv = torch.randn(3, length, 3 * 2 * d, generator=g,
                      device=cuda).to(torch.bfloat16)
    q, k, v = A._heads(qkv, 2)
    for causal in (False, True):
        lv = max(1, length - 2)
        before = A.attention_cuda.simt_bf16_launches
        got = A.qkv_attention(qkv, 2, d ** -0.5, causal, lv).view(
            3, length, 2, d)
        assert A.attention_cuda.simt_bf16_launches == before + 1
        want = A.attention_plain(q, k, v, d ** -0.5, causal, lv)
        assert _attention_within(got, want, v)


def test_gcd_step_card_matches_cpu(cuda):
    """One GCD step of a small f32 ViT (L 65, the kernels' f32 paths) on
    the card and on the CPU from the same parameters and batch: the loss
    within 1e-4 relative, every trainable parameter's update within 1e-3
    of its scale with a cosine of at least 0.9999 (f32 sums in other
    orders), every frozen parameter bit-unchanged, and one launch of the
    gradient kernel (one trainable block)."""
    from scd_tpu_torch.core.config import TrainConfig
    from scd_tpu_torch.models.vit import ViTConfig
    from scd_tpu_torch.ops import attention as A
    from scd_tpu_torch.train.gcd import GCDTrainer

    vit = ViTConfig(image_size=128, patch_size=16, width=256, depth=3,
                    heads=4)
    cfg = TrainConfig(grad_from_block=2, proj_dim=4_096, lr=0.1)
    card = GCDTrainer(vit, cfg, seed=1, total_steps=10, device="cuda")
    cpu = GCDTrainer(vit, cfg, seed=1, total_steps=10, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"images": rng.standard_normal((16, 128, 128, 3)).astype(
                 np.float32),
             "labels": rng.integers(0, 3, 8), "mask_lab": rng.random(8) < .5}
    before = {k: v.cpu().clone() for k, v in card.model.state_dict().items()}
    trainable = {n for n, p in card.model.named_parameters()
                 if p.requires_grad}
    launches = A.qkv_attention_bwd_cuda.launches
    m_card = card.step_fn(card.model, card.opt, card.to_device(batch))
    assert A.qkv_attention_bwd_cuda.launches == launches + 1
    m_cpu = cpu.step_fn(cpu.model, cpu.opt, cpu.to_device(batch))
    torch.testing.assert_close(m_card["loss"].cpu(), m_cpu["loss"],
                               rtol=1e-4, atol=0)
    after_cpu = cpu.model.state_dict()
    for name, v in card.model.state_dict().items():
        v = v.cpu()
        if name not in trainable:
            assert torch.equal(v, before[name]), name
            continue
        du, dw = (v - before[name]).double(), \
            (after_cpu[name] - before[name]).double()
        assert dw.norm() > 0, name
        cos = (du * dw).sum() / (du.norm() * dw.norm())
        assert cos >= 0.9999, (name, cos.item())
        assert (du - dw).abs().max() <= 1e-3 * dw.abs().max(), name


def test_attention_f32_at_the_baselines_shape_matches_plain(cuda):
    """The end-to-end baselines' f32 attention at B 128 · L 197 · H 12 · d
    64 (ViT-B/16 at 224, 64 images x 2 views): the forward kernel within
    ``_attention_within`` and the gradient kernel within ``grad_bound`` of
    their plain versions, each launched once."""
    from scd_tpu_torch.ops import attention as A
    from scd_tpu_torch.testing.attention_grad import grad_bound

    g = torch.Generator(device=cuda).manual_seed(128)
    b, length, h, d = 128, 197, 12, 64
    qkv = torch.randn(b, length, 3 * h * d, generator=g, device=cuda)
    dout = torch.randn(b, length, h * d, generator=g, device=cuda)
    fwd, bwd = A.attention_cuda.launches, A.qkv_attention_bwd_cuda.launches
    got = A.qkv_attention(qkv, h, d ** -0.5)
    assert A.attention_cuda.launches == fwd + 1
    q, k, v = A._heads(qkv, h)
    want = A.attention_plain(q, k, v, d ** -0.5)
    assert _attention_within(got.view(b, length, h, d), want, v)
    dq = A.qkv_attention_bwd_cuda(qkv, dout, h, d ** -0.5)
    assert A.qkv_attention_bwd_cuda.launches == bwd + 1
    want = A.qkv_attention_bwd_plain(qkv, dout, h, d ** -0.5)
    bound = grad_bound(qkv, dout, h, d ** -0.5, None, want)
    assert bool(((dq - want).abs() <= bound).all())


def test_uno_e2e_step_card_matches_cpu(cuda):
    """One end-to-end UNO step (every block trainable, f32, overclustering
    heads) of a small ViT on the card and on the CPU from the same
    parameters and batch: the loss within 1e-4 relative, every update
    within 1e-3 of its largest element with a cosine >= 0.999, and one
    launch of the gradient kernel per block."""
    from scd_tpu_torch.models.params import flax_init_
    from scd_tpu_torch.models.vit import ViTConfig
    from scd_tpu_torch.ops import attention as A
    from scd_tpu_torch.train import baselines as B
    from scd_tpu_torch.train.baselines_e2e import UNOModel, train_uno_e2e

    vit = ViTConfig(image_size=64, patch_size=16, width=128, depth=3,
                    heads=2)
    rng = np.random.default_rng(0)
    views = rng.standard_normal((2, 8, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 6, 8)
    mask = (labels < 3) & (rng.random(8) < 0.5)
    init = flax_init_(UNOModel(vit, 2, 6, 3 + 3 * 3), 4).state_dict()
    runs = {}
    real = B._init_params
    try:
        B._init_params = lambda model, seed: (model.load_state_dict(init),
                                              model)[1]
        for dev in ("cuda", "cpu"):
            bwd = A.qkv_attention_bwd_cuda.launches
            state, _predict, hist = train_uno_e2e(
                0, views, labels, mask, 3, 3, vit, num_heads=2, epochs=1,
                batch_size=8, lr=0.1, overcluster_factor=3, device=dev)
            runs[dev] = (state["model"].state_dict(), hist[0]["loss"],
                         A.qkv_attention_bwd_cuda.launches - bwd)
    finally:
        B._init_params = real
    (card, loss_card, n_card), (cpu, loss_cpu, n_cpu) = runs["cuda"], \
        runs["cpu"]
    assert n_card == vit.depth and n_cpu == 0
    assert abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu)
    for name, w in cpu.items():
        du = (card[name].cpu() - init[name]).double()
        dw = (w - init[name]).double()
        if dw.norm() == 0:
            assert du.norm() == 0, name
            continue
        cos = (du * dw).sum() / (du.norm() * dw.norm())
        assert cos >= 0.999, (name, cos.item())
        assert (du - dw).abs().max() <= 1e-3 * dw.abs().max(), name


# ------------------------------------------------------------------- mesh

def _mesh_spec(tmp_path):
    from scd_tpu_torch.testing.fabricate import (fabricate_imagenet100,
                                                 imagenet100_config)

    cfg = imagenet100_config(str(tmp_path / "in100"), n_init=3,
                             max_iterations=5)
    fabricate_imagenet100(cfg, seed=0, device="cuda", n_images=4_000,
                          d_feat=64, d_clip=32, vocab=3_000, n_genus=20)
    return {"cfg": cfg, "towers": "tiny", "images": 96, "batch": 32,
            "names": 200, "topk_rows": 2_000, "k": 5, "seed": 0,
            "bpe": None}


def test_mesh_of_one_rank_over_nccl_matches_mesh_free(cuda, tmp_path):
    """chip_smoke phase 13's first check at a small size: in a world of
    one rank over NCCL, ``fit_sskm`` with an explicit mesh gives the
    mesh-free call's labels and inertia, launching ``fused_em_step``."""
    from scd_tpu_torch.testing.dist import spawn

    ref, = spawn("scd_tpu_torch.testing.mesh_cases.mesh_stage_references",
                 world=1, backend="nccl", device="cuda",
                 args=(_mesh_spec(tmp_path),), timeout=300, threads=0)
    assert ref["sskm"]["labels_equal"]
    assert ref["sskm"]["inertia"][0] == ref["sskm"]["inertia"][1]
    assert ref["launches_mesh1"]["fused_em_step"] > 0


def test_mesh_of_two_ranks_on_one_card_matches_one_process(cuda, tmp_path):
    """Phase 13's second check at a small size: two gloo ranks on the
    card run the sharded encoders, clustering, vocabulary build and
    top-k; each rank's outputs against the single-process run's (the
    smoke's gates), each rank launching the three kernels."""
    import importlib.util
    import os

    from scd_tpu_torch.testing.dist import spawn

    spec = _mesh_spec(tmp_path)
    ref, = spawn("scd_tpu_torch.testing.mesh_cases.mesh_stage_references",
                 world=1, backend="nccl", device="cuda", args=(spec,),
                 timeout=300, threads=0)
    ranks = spawn("scd_tpu_torch.testing.mesh_cases.mesh_stages", world=2,
                  backend="gloo", device="cuda", args=(spec,), timeout=300,
                  threads=0)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    loader = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(smoke)
    from scd_tpu_torch.pipelines.common import feature_cache_key, stage_cache

    feats = stage_cache(spec["cfg"]).load(
        "features", feature_cache_key(spec["cfg"], "feat"))
    u_targets = feats["targets"].astype(np.int64)[
        ~feats["mask_lab"].astype(bool)]
    metrics = smoke.mesh_checks(ref, ranks, u_targets)
    assert set(metrics) == {0, 1}
