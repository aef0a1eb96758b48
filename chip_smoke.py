#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--against-bwd SRC.cu] [--against-fwd SRC.cu]
                          [--against-prefix SRC.cu] [--profile-prefix]

Phases, each printing its own lines and seconds:

1. device and build: the card's name and power limit (``nvidia-smi``),
   then every CUDA kernel built from ``scd_tpu_torch/csrc`` (one ``nvcc``
   per source, started together) with the compiler's register report
   (no redesigned kernel may spill) and the tensor-core instructions of
   the SASS (HGMMA / IGMMA; HMMA in the prefix ``mma.sync`` kernel);
2. kernel parity: each kernel against its plain PyTorch version on the
   card, at the main paths' shapes and at edge shapes (attention at L 257,
   325, 577, 785 and 1,025 through its long paths: bf16 on ``wgmma``,
   resident to L 832 and streamed past it; f32 at head_dim 64 on three
   TF32 passes at L 1 to 785 (B 4 at L 197, 257, 325, 577), f32 at head_dim
   32 and 128 on SIMT, a misaligned f32 view raising; ``classify_topk``
   at k 17 and 32 through the matmul route; ``topk_softmax`` at k 1 over
   raw logits at V 68,000 and V 100, ptsup's bound passes; the attention
   gradient, ``csrc/attention_bwd.cu``, against autograd of the plain
   attention at a training step's shape, B 256 x L 197 x H 12 x d 64 bf16,
   at L 208 with l_valid 197, in f32 at head_dim 64 (L 1, 65, 197, 257,
   577) and at head_dim 128 and 40 (SIMT), at L 1, 17 and 256, at L 257,
   325 and 577 (B 32: image 256, 288, 384), and the shapes it does not take,
   a misaligned head_dim-64 view and head_dim 288, raising), with the
   stated tolerances; every kernel must also repeat its bits exactly;
3. the warm main path: an ImageNet-100-scale root fabricated from
   ``--seed`` (N = 130,048 images, 768-d / 512-d features, V = 68,000
   nouns) and ``scd_tpu_torch.pipelines.unsup.run_unsup`` from the stage
   cache with SSKM, K = 100, n_init = 10, max_iterations = 10; ACC and IoU
   must clear floors, and on a small root the run on the card must print
   the same metric lines as the same run on the CPU (plain versions);
4. the cold main path under ``--int8``: a root with N = 10,000 ImageNet-100
   images (224 x 224 x 3 uint8 made from ``(seed, path)`` at load time),
   V = 8,000 names, and full-width DINO ViT-B/16 and CLIP ViT-B/16 (image
   and text) weights and a BPE merges file fabricated from the seed;
   ``run_unsup`` with empty caches extracts features through both image
   towers, builds the vocabulary through the text tower, then clusters,
   names and votes.  8 images' features and 8 names' columns are held
   against the same computed on the CPU (plain versions, f32), one DINO
   pass with ``pad_seq_to=0`` over 256 images drives ``w8a8_prequant``
   and is held against the CPU on its first 32, and the int8 features'
   cosine to the
   bf16 towers' is printed;
5. timing at the main paths' shapes: each kernel, its plain version and a
   yardstick PyTorch call, beside the least time the card could take (for
   the f32 products of ``topk_softmax``, ``fused_em_step`` and
   ``estep_assign``: three bf16 tensor-core products, two where x is
   stored in bf16, with the f32 SIMT bound printed beside it);
   ``fused_em_step`` with both bf16 and f32 x (the ``kernels`` line takes
   the main path's); the attention long path at image 256, 288 and 384
   (L 257, 325, 577); ``topk_softmax`` at k 1 (ptsup's bound pass); the
   attention gradient at a training step's shapes (L 197, L 208 with
   l_valid 197, L 257) beside the backward of
   ``F.scaled_dot_product_attention``
   (``scd_tpu_torch/testing/attention_bwd.py``) and, with
   ``--against-bwd SRC.cu``, another build of ``csrc/attention_bwd.cu``
   (e.g. the parent commit's) timed in turns on the same inputs; and the
   end-to-end baselines' f32 attention forward and gradient (three TF32
   passes) at B 128 and 64 x L 197 and B 128 x L 257 x H 12 x d 64 beside
   their plain versions, SDPA, the bound at 4-byte elements and three TF32
   passes and, with ``--against-fwd SRC.cu`` / ``--against-bwd SRC.cu``,
   another build of each source (e.g. the parent commit's SIMT kernels)
   timed in turns;
6. serving: ``scd_tpu_torch.pipelines.infer.main`` with a CLIP ViT-B/16
   tower (bf16, seeded random weights) naming 5,000 224 px uint8 images
   (ImageNet-100's validation size) in batches of 128 from 100 names'
   columns, top-5; images/s and p50 / p99 ms per batch; the attention
   kernel must launch 40 batches x 12 blocks times; 8 images' features
   are held against the CPU's plain f32 tower and their top-1 names must
   be equal; one batch at image 256 (L 257, the attention long path) is
   held against the CPU the same way; ``main`` must return the image
   count; the synthetic CLI must compute its naming head on the card;
7. the k-means runners: ``scd_tpu_torch.cluster.runners.main --optimal``
   over fabricated, L2-normalised ImageNet-100-scale features (130,048 x
   768, 100 classes) on the card (the ``estep_assign`` kernel) and on the
   CPU (plain versions): the printed ACC lines must be equal;
8. the partially supervised path on phase 3's root:
   ``scd_tpu_torch.pipelines.ptsup.run_ptsup`` from the stage cache with
   SSKM (n_init 10, max_iterations 10), its sACC bound lines, cluster ACC,
   final vote and stage seconds; ``topk_softmax`` must launch >= 25 times
   (12 chunks of 8,192 rows in each of the two bound passes, then the
   names' top-k) and ``fused_em_step`` at all, and ACC and IoU must clear
   phase 3's floors.  Then ConSSKM on the Sinkhorn track (size bounds
   [50, 1,200], n_init 10, max_iterations 10): every unlabelled cluster
   size within the bounds, its E-steps' count, seconds, dual iterations
   and MCF fallbacks printed.  Then the exact MCF track at full width
   over a quarter of the 97,536 unlabelled rows, cut to n_init 1 and
   max_iterations 1 (the host solver takes ~47 s an E-step over all of
   them), the solver's
   and the device step's seconds per iteration; the MCF track on the
   card and the CPU from one set of centers at 4,000 x 64, K 20 (rounded
   costs at most 1 apart on at most 0.1% of entries, labels equal on >=
   99.5% of rows, inertia within 1e-4); a small root clustered on the
   card with SSKM, ConSSKM and FINCH, each re-entered on the card and the
   CPU with equal ptsup lines; and ``scripts/smoke_all.sh``'s ptsup
   command through ``ptsup.main`` on the card.

9. ``estimate_k`` and the new readers: ``fused_em_step`` at K = 1,000
   slots, the ones at or past k_active (10, 100, 1,000) at the 1e12
   sentinel, against its plain version on phase 7's features (130,048 x
   768, f32), with every sentinel slot empty, and timed at k_active 100;
   ``scd_tpu_torch.cluster.estimate_k.main`` on those features with the
   CLI's defaults (Brent over [10, 1,000], n_init 3, max_iterations 50),
   each probe's K, objective and seconds, the chosen K (within [10,
   1,000]) and the objective at K 100 (at least 0.9); the objective at
   five K on the card and the CPU from the same initial centers (4,000 x
   64, 20 classes of tight sub-blobs, max_k 100): equal; then warm runs
   on fabricated roots at the published sizes through the new readers
   (V = 68,000, 768-d / 512-d features): ``run_unsup`` on CUB (K 200,
   SSKM) and ``run_ptsup`` with the textual-enhancement round on
   Stanford Dogs (K 120, SSKM), each clustered on the card, with
   ``fused_em_step`` and ``topk_softmax`` then held against their plain
   versions on the inputs each run passed them (the first call at each
   shape, x as the run passed it), then re-entered from its cache on the
   card and on the CPU with equal lines (both read the card's cluster
   labels, so this compares the naming stages);
   and the Dogs run with ConSSKM on the Sinkhorn track, every unlabelled
   cluster within the config's size bounds.  Cut to stay near ~90 s: the
   halving search and the ConSSKM run's CPU re-entry (21 s and 26 s on
   an H100).
10. GCD training (``scd_tpu_torch.train``): one f32 step of a ViT-B/16
   GCD model (grad_from_block 11, proj_dim 65,536, 2 x 8 images at 224)
   on the card and on the CPU from the port's seeded init: losses within
   1e-4, every trainable update within 1e-3 of its largest element with
   a cosine >= 0.999, every frozen parameter bit-unchanged; then
   ``scd_tpu_torch.train.metric_learn.main`` at full width (ViT-B/16 at
   224, batch 128 x 2 views, bf16, 2 epochs of 10 steps, k-means evals
   with max_kmeans_iter 10) on a fabricated ImageNet-100 tree of 3,000
   train images (256 x 256 arrays made from ``(seed, path)`` at load
   time): its epoch lines, ms a step, images/s, eval seconds and peak
   memory; the attention forward must launch >= 12 x 20 times in the
   steps, the gradient kernel once a step and ``fused_em_step`` in the
   evals; the losses finite, ``manifest.json`` with latest and best, and
   a fresh trainer restored from the last checkpoint must take one more
   step with the same bits as the trainer that was not restored; two
   bf16 steps at image 256 (L 257: the forward's long path and the
   gradient kernel past 256 keys) on a fixed device batch of 128 x 2
   views, finite losses, the gradient kernel once a step; two
   steps under ``--int8_frozen 1`` (``w8a8_fusedq`` in the 11 frozen
   blocks, the gradient kernel at L 208 / l_valid 197) with losses within
   2% of bf16's from the same parameters, and the frozen blocks' summed
   residual updates and the first qkv update close to bf16's; and a bf16
   step's device time by kernel (``torch.profiler``), its peak memory and
   the host's augmentation time.  The card step, ``metric_learn.main``,
   the image-256 steps and the int8 steps each hold every kernel call
   they made
   (``attention``, its gradient, ``fused_em_step``, ``w8a8_fusedq``)
   against its plain version on the arguments the path passed it, once
   per shape (``path_inputs``).
11. the NCD baselines (``scd_tpu_torch.train``'s ``run_baseline_e2e``,
   ``run_baseline``) and the ResNet towers: ``run_baseline_e2e.main
   --method uno`` and ``--method autonovel`` at ViT-B/16 full width (224
   px, patch 16), f32 through all 12 blocks, 64 images x 2 views,
   ``--overcluster_factor 3``, with ``--ckpt_dir``, cut to 2 epochs of 3
   steps, on a fabricated ImageNet-100 tree of 3,000 train images (256
   px arrays made at load time), each epoch evaluated over the tree's
   unlabelled images: the epoch and eval lines, ms a step, images/s,
   eval seconds, peak memory; the attention forward and its f32
   gradient must launch 12 times a backbone pass (UNO one pass a step,
   AutoNovel two), every launch on the f32 kernels at head_dim 64, the
   manifest must hold both epochs and a best; one
   f32 step of each trainer card against CPU from the same parameters
   (phase 10's gates, every block trainable); each trainer's own step on
   a fixed device batch of 64 x 2 views (CUDA events, peak memory, time
   by kernel); one UNO step at image 256 (L 257: the f32 gradient past
   256 keys) on a fixed device batch, its kernel calls held;
   ``run_baseline.main`` for uno, autonovel and supervised
   (the SSKM combine on ``fused_em_step``, K 100) over phase 7's kind of
   store (130,048 x 768, --n_labeled 50, cut to 1 epoch), then each
   frozen-feature trainer card against CPU on the store's first 8,192
   rows from one init (losses, prediction agreement); the ResNet-50
   tower at bf16 (folded weights from a fabricated torchvision state
   dict) on 128 images at 224, ms a batch, against the CPU's f32 on 8
   of them, and the two-head ResNet-18 (f32) card against CPU.  The
   mains, the card steps and the frozen CLI hold every kernel call
   against its plain version on the path's arguments (``path_inputs``).
12. the prefix-KV vocabulary build (``SCD_PREFIX_VOCAB=1``): the prefix
   attention kernels (``csrc/prefix_attention.cu``) against their plain
   version at the build's shapes (B 8,192 x S 16 and 8 x P 16 x H 8 x d
   64 bf16 on the ``mma.sync`` kernel, one p_valid < P; one f32 case on
   the SIMT kernel); then, through the CLIP ViT-B/16 text tower that
   ``build_encoders`` makes from a fabricated cold root (bf16,
   ``dense_int8`` off), ``build_zeroshot_weights`` for 8,192 fabricated
   names of one to three tokens in the JAX package's word mix
   (``testing/fabricate.py::short_names``, all cached) x the 80 ImageNet
   templates, once on the prefix route and once on the full-row route:
   the prefix kernel must launch 12 x (cached templates) x (chunks)
   times, every launch on the ``mma.sync`` kernel, the two [512, 8,192]
   matrices must agree to a minimum column cosine of PREFIX_COS_TOL; then
   the same on 1,024 of those names and 128 of the root's own, which fall
   back, timed apart; both builds' prompts/s (warm), the fallback
   templates and names, every kernel call of the prefix build held
   against its plain version on its arguments (``path_inputs``), with
   ``--profile-prefix`` the cached-name prefix build's device time by
   kernel (``torch.profiler``), and the kernel's time at the build's
   shapes beside its plain version, SDPA (a yardstick, never on the
   path), its bound and, with ``--against-prefix SRC.cu``, another build
   of ``csrc/prefix_attention.cu`` (e.g. the parent commit's SIMT
   kernel) timed in turns on the same inputs.
13. the mesh (``torch.distributed``; ``core/mesh.py``,
   ``core/multihost.py``), ranks started by ``testing/dist.py``: at world
   size 1 over NCCL, ``fit_sskm`` on phase 3's features (130,048 x 768,
   K 100, n_init 10, 10 iterations) with an explicit mesh of one rank must
   give the mesh-free call's labels and inertia; the same process then
   computes the single-process references.  At world size 2 over gloo
   with both ranks on the card, each rank runs its share of 4,096
   fabricated 224 px images through DINO and CLIP ViT-B/16 (bf16, weights
   fabricated from the seed; batches of 128 split over the ranks),
   ``run_clustering`` (SSKM) on phase 3's features, the name-sharded
   vocabulary build of 4,000 fabricated names x 80 templates, and
   ``classify_topk_sharded`` over V 68,000 split over the two ranks' model
   axis (N 97,536, D 512, k 5).  Each rank's features and vocabulary
   columns must reach a minimum cosine of MESH_COS against the
   single-process run's, its clustering ARI MESH_ARI and ACC within
   MESH_ACC, its top-k rows equal on MESH_TOPK_AGREE of rows, and the
   ranks must hold the same clusters and vocabulary; every rank's
   ``fused_em_step``, ``topk_softmax`` and attention launches (counts set
   to 0 just before its stages) must be above 0.  Stage seconds of each
   rank and of the single-process run are printed beside the card's name
   and power limit.  A rank that fails or passes the deadline fails the
   phase.
14. the mesh: ConSSKM, estimate_k, training (``testing/mesh_cases.py::
   mesh_training_stages``, phase 13's rig), at world size 1 over NCCL (the
   single-process references; ConSSKM under an explicit mesh of one rank
   must give the mesh-free fit's labels and inertia bits) and at world
   size 2 over gloo with both ranks on the card: ``run_clustering`` with
   phase 8's ConSSKM configuration (Sinkhorn track) on phase 3's features
   (130,048 x 768, K 100; n_init cut to 1), every cluster size within
   [50, 1200], no MCF fallback, ACC within MESH_CON_ACC and ARI >=
   MESH_CON_ARI against one process; ``estimate_k`` (Brent, each probe's
   k-means cut to one restart) over 65,024 rows of phase 7's kind of
   features (max_k 1,000): the same K and the objective within
   MESH_EK_OBJ; three GCD
   steps of ViT-B/16 bf16 at 128 x 2 views: each loss within
   MESH_GCD_RTOL, the trainable parameters at cosine >=
   MESH_GCD_COS after the last step, the two ranks' parameters bitwise
   equal after each step; UNO and AutoNovel at ViT-B/16 f32, 64 x 2
   views, 2 steps each: losses within MESH_E2E_RTOL and the best head
   equal; ``metric_learn.main --mesh_data 2`` (1 epoch of 2 steps) exits
   and only rank 0 writes the run; each rank's seconds, E-steps, dual
   iterations, ``fused_em_step`` and attention launches (counts set to 0
   before each stage) and the augmentation's seconds a batch are printed
   beside the card's name and power limit.
15. tensor parallelism in the trainers (``testing/mesh_cases.py::
   tp_cases``; gloo ranks sharing the card, the one-process references at
   world size 1 over NCCL): first each kernel of the path against its
   plain version at a rank's shard shapes (attention and its gradient at
   6 heads a rank, bf16 and f32; ``w8a8_fusedq`` at the qkv and fc1
   column shards, F 1,152 and 1,536); (a) GCD at ``data`` 1 x ``model``
   2, ViT-B/16 bf16, TP_GCD_IMAGES x 2 views, TP_GCD_STEPS steps, and
   (a32) the same at f32 compute, TP_GCD32_STEPS steps: each loss within
   MESH_GCD_RTOL, after the last step the gathered trainable parameters
   at cosine >= MESH_GCD_COS (f32: each parameter; bf16: the whole update
   and the worst parameter within TP_NOISE x the noise floor of one
   process whose proj / fc2 products round otherwise, for the reason at
   TP_GCD_IMAGES), the ranks'
   gathered parameters bitwise equal after each step (the replicated
   ones are each rank's own), each rank holding exactly half the one
   process's bytes of tensor-parallel parameters; (b) UNO (2 steps) and
   AutoNovel (1 step)
   at ViT-B/16 f32, TP_E2E_IMAGES x 2 views: losses within MESH_E2E_RTOL,
   the best head equal, the ranks' predictions equal; (c) one GCD step
   on a 2 x 2 mesh (4 ranks) at full width, depth 2, under
   ``--int8_frozen``, with (a)'s gates; before the worlds, fc2's bf16
   product at (a)'s rows as one GEMM and as two f32 partial sums (the
   share of elements apart printed); (d)
   ``graft_entry.dryrun_multichip(4)`` on the card.  Each rank's ms a
   step, bytes and launches are printed beside the card's name and power
   limit.
16. attention at every head_dim and under causal, the scripts'
   counterparts, the prefix-KV build over ranks: (a) the forward's bf16
   SIMT route (head_dim 8, 16, 32 and 128 at L 1, 5, 17, 197 and 300,
   causal and not, l_valid < L), f32 rows past shared memory, and the
   gradient's new routes (bf16 at head_dim 32 at the micro ViT's B 256 x
   L 197 x H 2, f32 at head_dim 32 at L 290 and 785, causal at head_dim
   64 in bf16 and f32 on ``wgmma`` and at head_dim 32 on SIMT), each
   against its plain version and timed beside SDPA's forward or backward
   and its bound, a line a shape; (b) ``DEVICE=cuda bash
   scd_tpu_torch/scripts/smoke_all.sh`` (its gpu suite left to a call of
   its own, ``SMOKE_GPU_SUITE=0``), each CLI's seconds, then
   ``metric_learn.main --vit micro`` (bf16) and ``run_baseline_e2e.main
   --vit micro --image_size 136`` (f32, L 290) in this process, counted,
   every kernel call held against its plain version; (c)
   ``scd_tpu_torch.scripts.multihost_smoke --launch 2`` in its four modes
   (stages, ``--pipeline unsup|ptsup|train``) at once, gloo ranks sharing
   the card, each world's digests agreeing; (d)
   ``build_zeroshot_weights_prefix`` over 2 gloo ranks against one
   process at phase 12's CLIP ViT-B/16 text tower (bf16), 2,048 names x
   80 templates, min column cosine >= PREFIX_COS_TOL; (e)
   ``scd_tpu_torch.scripts.scale_smoke --small`` on the card against
   ``tests/test_scale_smoke.py``'s thresholds.

Each main path runs with every kernel's launch count set to 0 just before
it and read just after; a kernel of the path that never launched fails
the run.  The ``kernels`` line has one row per TPU kernel of
``scd_tpu/ops/pallas_kernels.py``: ``topk_softmax`` and ``fused_em_step``
with phase 3's launches plus phase 9's (the ``estimate_k`` search and the
first run on each fine-grained root), ``w8a8_fusedq`` with phase 4's ``run_unsup``,
``dense_w8a8`` and ``dense_w8a8_3d`` (one kernel, ``w8a8_prequant``) with
phase 4's ``pad_seq_to=0`` pass, ``vit_attention`` and ``qkv_attention``
(one kernel) with phase 6's, and ``estep_assign`` with phase 7's; a
row, ``attention_bwd`` (no TPU kernel: the JAX package takes its
attention gradient from XLA autodiff), with phase 10's training steps;
and the f32 kernels at head_dim 64 of the attention
(``qkv_attention_f32``) and its gradient (``attention_bwd_f32``), with
phase 11's end-to-end mains and phase 5's times at B 128 x L 197; and a
row, ``prefix_attention`` (no TPU kernel: the JAX package's prefix
attention is plain XLA), with the ``mma.sync`` kernel's launches in phase
12's prefix build and times at its first shape.  Phase 14's rank 0 adds
its launches: ``fused_em_step`` in its ``estimate_k`` search, the
attention and its gradient in its GCD steps, their f32 kernels in its
end-to-end trainers; so does phase 15's rank 0 (the attention and its
gradient in (a) and (c), ``w8a8_fusedq`` in (c), the f32 kernels in
(b)), and phase 16's micro main paths theirs; its two rows of their own,
``attention_simt_bf16`` (the forward's bf16 launches of the SIMT kernel)
and ``attention_bwd_simt`` (the gradient's SIMT route), carry those runs'
launches and phase 16's times at the micro ViT's training shape.
Phase 8 reads its own launches (``topk_softmax`` and ``fused_em_step``
in its ``run_ptsup``) and prints them on a line of their own; so do
phase 13 (each rank's) and
phase 10 (the attention forward, its gradient and ``fused_em_step`` in
``metric_learn``'s steps and evals) and phase 11 (the attention forward
and its f32 gradient in each end-to-end main, ``fused_em_step`` in the
frozen-feature CLI).

Prints a ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``.  Any failure raises: the exit code is
then nonzero and no result line is printed.  Imports nothing of JAX or of
the JAX package.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

# published H100 SXM peaks (NVIDIA data sheet), used for the bound only
PEAK_F32_FLOPS = 67e12     # f32 FMA outside the tensor cores
PEAK_BF16_FLOPS = 989e12   # dense bf16 tensor-core rate
PEAK_TF32_FLOPS = 495e12   # dense TF32 tensor-core rate
PEAK_INT8_OPS = 1979e12    # dense int8 tensor-core rate
PEAK_HBM_BYTES = 3.35e12   # HBM3

N_IMAGES, D_FEAT, D_CLIP, VOCAB, K = 130_048, 768, 512, 68_000, 100
TOPK = 5
# the cold path: images, vocabulary, extraction batch, padded ViT sequence
COLD_IMAGES, COLD_VOCAB, BATCH, L_PAD, L_VIT = 10_000, 8_000, 128, 208, 197
# the zero-shot columns the cold path holds against the CPU's text tower
# (80 prompts each through f32 CLIP on the CPU): 8, cut from 64, whose
# 5,120 prompts took ~240 s of a ~880 s smoke on an H100's host (16 took
# 57.1 s with the 8 images' features, and the unpadded DINO pass's 256
# images 50.0 s, on an H100 host whose smoke ran 1,197.6 s: the CPU side
# of that pass holds its first COLD_CPU_PAD0_IMAGES); 4 since phase 16
# came (8 columns and the 8 images' features took 27.2 s)
COLD_CPU_COLUMNS = 4
COLD_CPU_PAD0_IMAGES = 32
# a ViT-B/16 tower at image 256: 16 x 16 patches + class token
IMAGE_LONG, L_257 = 256, 257
# a GCD training step's batch: 2 views x 128 images
TRAIN_B = 256
# the text tower's largest batch (64 names x 80 templates) and the k-means
# runner's feature store (ImageNet-100's 130,048 training images)
TEXT_BATCH, RUNNER_N = 5_120, 130_048
# serving: ImageNet-100's validation size, K names, top-k
SERVE_IMAGES, SERVE_NAMES, SERVE_TOPK = 5_000, 100, 5

# tolerances, with their reasons:
# - top-k logits are scale * dot products of split-bf16 operands (lo.lo,
#   ~2^-16 relative, dropped) summed in another order than cuBLAS's f32:
#   |error| ~ 1e-4 at scale 100, D = 512 unit vectors
TOPK_LOGIT_TOL = 2e-3
# - softmax values inherit the logit error (relative ~ logit error)
TOPK_PROB_TOL = 5e-4
# - squared distances of unit-norm rows in f32: |error| ~ 1e-6 per term
EM_DIST_TOL = 1e-4
# - sums of ~1000 f32 rows per cluster and the inertia sum of ~1e5 terms,
#   each summed in another order than the plain version's matmul
EM_SUM_RTOL, EM_SUM_ATOL = 1e-4, 1e-4
EM_INERTIA_RTOL = 1e-4
# - and each row's term of the inertia, |x|^2 + |c|^2 - 2 x.c in f32 from
#   the contract's split products, is off by a share of |x|^2 + |c|^2
#   whatever the distance: the dropped lo.lo products, up to 2^-18 of it,
#   all of one sign where a row lies at its center; the split's rounding
#   and the f32 sums, of both signs.  An inertia near 0 (rows at their
#   centers, as when K = N) is all cancellation.  Read on an H100 at K = N
#   = 100, every row its own center: 2.9e-6 of |x|^2 + |c|^2
EM_INERTIA_ROW = 2.0 ** -17
# - W8A8: the kernels repeat the plain versions' arithmetic step by step
#   (IEEE division, round half to even, exact int32 products, each dequant
#   step rounded), so outputs before the activation are equal; after it
#   exp / tanh / erf may differ in the last f32 bit: at most one bf16 ulp
#   (|v| * 2^-7) in bf16, W8A8_F32_RTOL relative in f32
W8A8_F32_RTOL = 2e-6
# - towers on the card (bf16 activations, int8 kernels) against the CPU
#   (f32 activations, the plain int8 chain): bf16 rounding through 12
#   blocks of random weights, and the int8 rounding flips it causes.  Read
#   on an H100 at this seed: min 0.999866 (DINO), 0.999959 (CLIP image),
#   0.999979 (64 zero-shot columns).  The int8-vs-bf16 gap of the DINO
#   tower reads 0.999785 mean, 0.999730 min, so the limit lies between the
#   two: a card path that skipped the quantization fails it
TOWER_COS_TOL = 0.9998
# - attention, bf16: both versions round p to bf16 after row sums taken in
#   another order, so a p on a rounding boundary may land one bf16 ulp
#   (2^-8 relative) apart; with sum(p) = 1 that moves an output by at most
#   2^-8 max|v|, and the final rounding to bf16 by one ulp (2^-7 relative)
ATTN_BF16_REL, ATTN_BF16_VREL = 2.0 ** -7, 2.0 ** -8
# - attention, f32: dot products, exp and sums in another order than the
#   plain version's matmuls: ~1e-6 of max|v|
ATTN_F32_VREL = 1e-5
# - the attention gradient, against autograd of the plain version, per
#   element of dQ, dK, dV: bf16 2^-7 |want| + 2^-6 M, f32 1e-4 M, with M
#   the sum of the absolute values of the terms it sums; the reasons stand
#   in scd_tpu_torch/testing/attention_grad.py, which the gpu tests share
# - estep_assign: squared distances of unit-norm rows in f32 (labels equal
#   wherever the exact distances differ by more than EM_DIST_TOL)
ESTEP_DIST_TOL = 1e-4
# floors of the fabricated structure (class signal far above the noise)
ACC_FLOOR, IOU_FLOOR = 0.90, 0.80
# the kernel sources under scd_tpu_torch/csrc, built together in phase 1
SOURCES = ("topk_softmax", "fused_em", "w8a8", "attention", "estep",
           "attention_bwd", "prefix_attention")
# the attention gradient's bf16 kernels (wgmma fed by TMA)
BWD_WGMMA_KERNELS = ("attn_bwd_dq_kernel", "attn_bwd_dkv_kernel")
# the prefix attention's bf16 kernel at head_dim 64 (mma.sync tiles)
PREFIX_MMA_KERNEL = "prefix_mma_kernel"
# the f32 attention kernels at head_dim 64 (three TF32 passes on wgmma fed
# by TMA), by source
F32_WGMMA_KERNELS = {"attention": ("attn_f32_wgmma_kernel",),
                     "attention_bwd": ("attn_bwd_dq_f32_kernel",
                                       "attn_bwd_dkv_f32_kernel")}


def fail(msg: str):
    raise RuntimeError(msg)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def section(title: str):
    print(f"== {title}", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# ------------------------------------------------------------- phase 1

def phase_build():
    from scd_tpu_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    reports = build.build(SOURCES)
    for name in SOURCES:
        build.load(name)
    print(f"built {sorted(reports) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in ptxas_summary(log):
            print(f"  {name}: {line}")
    sass = {name: sass_counts(build.library_path(name))
            for name in ("attention", "w8a8", "topk_softmax", "fused_em",
                         "estep", "attention_bwd")}
    for name, per_fn in sass.items():
        for fn, (hg, ig) in per_fn.items():
            print(f"  {name} SASS {fn}: HGMMA {hg}, IGMMA {ig}")
    check(any(hg > 0 for fn, (hg, _) in sass["attention"].items()
              if "attn_bf16" in fn), "attention: no HGMMA in the bf16 kernel")
    check(any(hg > 0 for fn, (hg, _) in sass["attention"].items()
              if "attn_long_bf16" in fn),
          "attention: no HGMMA in the bf16 long-path kernel")
    if "attention" in reports:  # built now: its ptxas report is here
        lines = ptxas_summary(reports["attention"])
        check(any(ln.startswith("attn_long_bf16_kernel:")
                  and "spill 0 / 0 bytes" in ln for ln in lines),
              "attention: the bf16 long-path kernel spills")
        check(not any("wgmma" in ln and "attn_long_bf16" in ln
                      for ln in lines),
              "attention: ptxas serializes the long-path kernel's wgmma")
    check(any(ig > 0 for fn, (_, ig) in sass["w8a8"].items()
              if "fusedq" in fn), "w8a8: no IGMMA in the w8a8_fusedq kernel")
    check(all(ig > 0 for fn, (_, ig) in sass["w8a8"].items()
              if "prequant" in fn) and any(
        "prequant" in fn for fn in sass["w8a8"]),
        "w8a8: no IGMMA in the w8a8_prequant kernel")
    if "w8a8" in reports:  # built now: its ptxas report is here
        lines = ptxas_summary(reports["w8a8"])
        pq = [ln for ln in lines if ln.startswith("w8a8_prequant_kernel")]
        check(pq and all("spill 0 / 0 bytes" in ln for ln in pq),
              "w8a8: the w8a8_prequant kernel spills")
        check(not any("wgmma" in ln and "w8a8_prequant" in ln
                      for ln in lines),
              "w8a8: ptxas serializes the w8a8_prequant kernel's wgmma")
    check(all(hg > 0 for fn, (hg, _) in sass["topk_softmax"].items()
              if "topk_wgmma" in fn) and any(
        "topk_wgmma" in fn for fn in sass["topk_softmax"]),
        "topk_softmax: no HGMMA in the topk_wgmma kernel")
    for kern in ("estep_kernel", "mstep_kernel"):
        check(all(hg > 0 for fn, (hg, _) in sass["fused_em"].items()
                  if kern in fn) and any(
            kern in fn for fn in sass["fused_em"]),
            f"fused_em: no HGMMA in the {kern}")
    check(any(hg > 0 for fn, (hg, _) in sass["estep"].items()
              if fn.startswith("estep_kernel")),
          "estep: no HGMMA in the estep_kernel")
    for kern in BWD_WGMMA_KERNELS:
        check(any(hg > 0 for fn, (hg, _) in sass["attention_bwd"].items()
                  if fn.startswith(kern)),
              f"attention_bwd: no HGMMA in the {kern}")
    for src, kerns in F32_WGMMA_KERNELS.items():
        for kern in kerns:
            check(any(hg > 0 for fn, (hg, _) in sass[src].items()
                      if fn.startswith(kern)),
                  f"{src}: no HGMMA in the {kern}")
            if src in reports:  # built now: its ptxas report is here
                lines = ptxas_summary(reports[src])
                check(any(ln.startswith(f"{kern}:")
                          and "spill 0 / 0 bytes" in ln for ln in lines),
                      f"{src}: the {kern} spills")
                check(not any("serialized" in ln and kern in ln
                              for ln in lines),
                      f"{src}: ptxas serializes the {kern}'s wgmma")
    if "attention_bwd" in reports:  # built now: its ptxas report is here
        lines = ptxas_summary(reports["attention_bwd"])
        for kern in BWD_WGMMA_KERNELS:  # every instance (dQ: causal or not)
            mine = [ln for ln in lines if ln.startswith((f"{kern}:",
                                                         f"{kern}<"))]
            check(mine and all("spill 0 / 0 bytes" in ln for ln in mine),
                  f"attention_bwd: an instance of the {kern} spills")
            check(not any("wgmma" in ln and kern in ln for ln in lines),
                  f"attention_bwd: ptxas serializes the {kern}'s wgmma")
    hmma = sass_counts(build.library_path("prefix_attention"), ("HMMA",))
    for fn, (n,) in hmma.items():
        print(f"  prefix_attention SASS {fn}: HMMA {n}")
    mma_fns = [fn for fn in hmma if fn.startswith(PREFIX_MMA_KERNEL)]
    check(mma_fns and all(hmma[fn][0] > 0 for fn in mma_fns),
          f"prefix_attention: no HMMA in a {PREFIX_MMA_KERNEL} instance")
    if "prefix_attention" in reports:  # built now: its ptxas report is here
        lines = ptxas_summary(reports["prefix_attention"])
        for kern in ("prefix_attn_kernel", PREFIX_MMA_KERNEL):
            mine = [ln for ln in lines if ln.startswith(kern)]
            check(mine and all("spill 0 / 0 bytes" in ln for ln in mine),
                  f"prefix_attention: a {kern} instance spills")
    if "estep" in reports:  # built now: its ptxas report is here
        lines = ptxas_summary(reports["estep"])
        check(any(ln.startswith("estep_kernel:") and "spill 0 / 0 bytes" in ln
                  for ln in lines), "estep: the estep_kernel spills")
        check(not any("wgmma" in ln and "estep_kernel" in ln
                      for ln in lines),
              "estep: ptxas serializes the estep_kernel's wgmma")


def _short(mangled: str) -> str:
    """A kernel's name and template arguments, from its mangled name (the
    name follows its length, after the namespace's).  Of the identifiers
    ending in ``_kernel`` that a length prefix spells, the innermost (the
    last to start): the anonymous namespace's name carries a hash of the
    source's path whose digits can spell a longer one around it."""
    import re

    name, start, end = mangled[:48], -1, 0
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for i in range(len(digits)):
            cand = mangled[m.end():m.end() + int(digits[i:])]
            if (cand.endswith("_kernel") and cand.isidentifier()
                    and m.end() > start):
                name, start, end = cand, m.end(), m.end() + len(cand)
    tail = mangled[end:]
    args = re.match(r"ILi(\d+)E", tail)
    out = "bf16" if "bfloat16E" in tail[:24] else (
        "f32" if tail[:12].count("f") and args else "")
    targs = ",".join(a for a in (args.group(1) if args else "", out) if a)
    return name + (f"<{targs}>" if targs else "")


def ptxas_summary(log: str):
    """One line per kernel from ``nvcc -Xptxas -v``: registers, shared
    memory, spill bytes, and any wgmma serialization warning."""
    import re

    out, fn, info = [], None, {}
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            fn = _short(m.group(1))
            info = {}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and fn:
            info["spill"] = f"spill {m.group(1)} / {m.group(2)} bytes"
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", ln)
        if m and fn:
            out.append(f"{fn}: {m.group(1)} registers, {m.group(2) or 0} "
                       f"bytes static smem, {info.get('spill', 'spill ?')}")
        if "wgmma" in ln:
            out.append(ln.strip())
    return out


def sass_counts(lib: str, ops=("HGMMA", "IGMMA")):
    """{kernel: (count of each of ``ops``)} instruction counts in ``lib``'s
    SASS (by default HGMMA and IGMMA)."""
    from scd_tpu_torch.ops import build

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    res = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr[-2000:]}")
    counts, fn = {}, None
    for ln in res.stdout.splitlines():
        if "Function :" in ln:
            fn = _short(ln.split("Function :")[1].strip())
            counts[fn] = [0] * len(ops)
        elif fn is not None:
            for i, op in enumerate(ops):
                counts[fn][i] += op in ln
    return {k: tuple(v) for k, v in counts.items()}


# ------------------------------------------------------------- phase 2

def _unit(t, dim):
    return t / t.norm(dim=dim, keepdim=True).clamp_min(1e-12)


def topk_parity(n, d, v, k, gen, dup_cols=False, tag=""):
    """Kernel vs plain on one shape of random unit rows and columns (see
    :func:`topk_hold`); ``dup_cols`` makes column 2j+1 repeat column 2j
    (V even): exact ties."""
    import torch

    dev = torch.device("cuda")
    f = _unit(torch.randn(n, d, generator=gen, device=dev), 1)
    w = _unit(torch.randn(d, v, generator=gen, device=dev), 0)
    if dup_cols:
        w[:, 1::2] = w[:, 0::2]
    return topk_hold(f, w, k, 100.0, dup_cols, tag)


def topk_hold(f, w, k, scale=100.0, dup_cols=False, tag=""):
    """Hold ``topk_softmax`` against its plain version on feats ``f`` [N,
    D] and weights ``w`` [D, V].  Indices must be equal wherever the exact
    (f64) logits of the two choices differ by more than TOPK_LOGIT_TOL;
    with ``dup_cols`` a tie must go to the lowest index.  Returns (max abs
    err of raw logits, of softmax)."""
    import torch

    from scd_tpu_torch.ops.topk import (classify_topk_plain,
                                        topk_softmax_cuda)

    (n, d), v = f.shape, w.shape[1]
    m, s, kv, ki = topk_softmax_cuda(f, w, k, scale=scale)
    torch.cuda.synchronize()
    pv, pi = classify_topk_plain(f, w, k, scale, apply_softmax=False)
    diff = ki != pi
    if bool(diff.any()):
        rows = diff.any(dim=1).nonzero().flatten()
        f64 = f[rows].double()
        ek = scale * (f64[:, None, :] * w.t()[ki[rows].long()].double()).sum(-1)
        ep = scale * (f64[:, None, :] * w.t()[pi[rows].long()].double()).sum(-1)
        gap = (ek - ep).abs().max().item()
        check(gap <= TOPK_LOGIT_TOL,
              f"topk {tag}: indices differ beyond the tie band ({gap:.3e})")
    if dup_cols:
        # ties go to the lowest index: 2j+1 only ever right after 2j
        odd = (ki % 2 == 1)
        prev = torch.cat([torch.full_like(ki[:, :1], -2), ki[:, :-1]], 1)
        check(bool((~odd | (prev == ki - 1)).all()),
              f"topk {tag}: a tie did not go to the lowest index")
    err_raw = (kv - pv).abs().max().item()
    probs = torch.exp(kv - m[:, None]) / s[:, None]
    pprob, _ = classify_topk_plain(f, w, k, scale, apply_softmax=True)
    err_prob = (probs - pprob).abs().max().item()
    rel = err_raw / max(pv.abs().max().item(), 1e-30)
    check(err_raw <= TOPK_LOGIT_TOL, f"topk {tag}: logit error {err_raw}")
    check(err_prob <= TOPK_PROB_TOL, f"topk {tag}: softmax error {err_prob}")
    print(f"  topk_softmax {tag} N={n} D={d} V={v} k={k} scale={scale:g}: "
          f"idx mismatches {int(diff.sum())}, max abs err {err_raw:.3e} "
          f"(rel {rel:.3e}), softmax max abs err {err_prob:.3e}")
    return err_raw, err_prob


def topk_route_parity(n, d, v, k, gen):
    """k > 16 through ``classify_topk``: the JAX package's route past its
    kernel (the matmul route, counted apart; the kernel must not launch).
    That route runs the plain version itself, so equal indices only show
    the dispatch; the result is held against the f64 logits: indices equal
    outside the tie band (TOPK_LOGIT_TOL) and softmax values within
    TOPK_PROB_TOL."""
    import torch

    from scd_tpu_torch.ops import topk

    dev = torch.device("cuda")
    f = _unit(torch.randn(n, d, generator=gen, device=dev), 1)
    w = _unit(torch.randn(d, v, generator=gen, device=dev), 0)
    kern, route = topk.topk_softmax_cuda.launches, \
        topk.classify_topk.matmul_calls
    vals, idx = topk.classify_topk(f, w, k)
    torch.cuda.synchronize()
    check(topk.topk_softmax_cuda.launches == kern
          and topk.classify_topk.matmul_calls == route + 1,
          f"topk k={k}: did not take the matmul route alone")
    _, pi = topk.classify_topk_plain(f, w, k)
    check(torch.equal(idx, pi), f"topk k={k}: indices differ from plain")
    si = idx.sort(dim=1).values
    check(bool((si[:, 1:] != si[:, :-1]).all()),
          f"topk k={k}: an index repeats within a row")
    exact = 100.0 * (f.double() @ w.double())  # [N, V]
    ev, ei = torch.sort(exact, dim=1, descending=True, stable=True)
    ev, ei = ev[:, :k], ei[:, :k]
    gap = (exact.gather(1, idx.long()) - ev).abs().max().item()
    check(gap <= TOPK_LOGIT_TOL,
          f"topk k={k}: indices differ from f64 beyond the tie band "
          f"({gap:.3e})")
    m = exact.max(dim=1, keepdim=True).values
    want = torch.exp(exact.gather(1, idx.long()) - m) \
        / torch.exp(exact - m).sum(dim=1, keepdim=True)
    err = (vals.double() - want).abs().max().item()
    check(err <= TOPK_PROB_TOL, f"topk k={k}: softmax error vs f64 {err}")
    print(f"  classify_topk (matmul route) N={n} D={d} V={v} k={k}: vs f64 "
          f"idx mismatches {int((idx.long() != ei).sum())} (largest logit "
          f"gap {gap:.3e}), softmax max abs err {err:.3e}")


def em_inputs(n, d, k, gen):
    """Class-structured unit rows and centers picked from them."""
    import torch

    dev = torch.device("cuda")
    cls = 3.0 * torch.randn(k, d, generator=gen, device=dev)
    lab = torch.randint(0, k, (n,), generator=gen, device=dev)
    x = _unit(cls[lab] + 0.5 * torch.randn(n, d, generator=gen, device=dev), 1)
    pick = torch.linspace(0, n - 1, k, device=dev).round().long()
    return x.contiguous(), x[pick].contiguous()


def em_parity(n, d, k, gen, masked=False, x_bf16=False, tag=""):
    """Kernel vs plain on one shape of :func:`em_inputs` (see
    :func:`em_hold`); returns max abs err of the sums."""
    import torch

    x, c = em_inputs(n, d, k, gen)
    row_w = None
    if masked:
        row_w = (torch.rand(n, generator=gen, device=x.device) > 0.3).float()
    xk = x.to(torch.bfloat16) if x_bf16 else x
    return em_hold(xk, c, row_w, tag)[0]


def em_hold(xk, c, row_w=None, tag=""):
    """Hold ``fused_em_step`` against its plain version on x ``xk`` and
    centers ``c``.  Labels must be equal wherever the exact (f64) squared
    distances of the two choices differ by more than EM_DIST_TOL; sums and
    counts are held against the plain segment sums of the kernel's own
    labels; the kernel must repeat its bits.  Returns (max abs err of the
    sums, the kernel's (labels, sums, counts, inertia))."""
    import torch

    from scd_tpu_torch.ops.em import em_iteration_plain, fused_em_step_cuda
    from scd_tpu_torch.ops.segment import segment_sums

    n, d = xk.shape
    k = c.shape[0]
    lab, sums, counts, ine = fused_em_step_cuda(xk, c, row_w)
    torch.cuda.synchronize()
    lab2, sums2, counts2, ine2 = fused_em_step_cuda(xk, c, row_w)
    check(bool((lab == lab2).all()) and torch.equal(sums, sums2)
          and torch.equal(counts, counts2) and torch.equal(ine, ine2),
          f"fused_em {tag}: two runs on the same input differ")
    plab, psums, pcounts, pine = em_iteration_plain(xk, c, k, row_w)
    diff = lab.long() != plab.long()
    if bool(diff.any()):
        rows = diff.nonzero().flatten()
        x64 = xk[rows].double()
        dk = ((x64 - c[lab[rows].long()].double()) ** 2).sum(1)
        dp = ((x64 - c[plab[rows].long()].double()) ** 2).sum(1)
        gap = (dk - dp).abs().max().item()
        check(gap <= EM_DIST_TOL,
              f"fused_em {tag}: labels differ beyond the tie band ({gap:.3e})")
    rsums, rcounts = segment_sums(xk.float(), lab.long(), k, weights=row_w)
    err = (sums - rsums).abs().max().item()
    rel = err / max(rsums.abs().max().item(), 1e-30)
    check(torch.allclose(sums, rsums, rtol=EM_SUM_RTOL, atol=EM_SUM_ATOL),
          f"fused_em {tag}: sums error {err} (rel {rel:.3e} of the largest)")
    check(torch.equal(counts, rcounts), f"fused_em {tag}: counts differ")
    w = 1.0 if row_w is None else row_w.float()
    mag = (w * (xk.float().square().sum(1)
                + c.square().sum(1)[lab.long()])).sum().item()
    ine_err = abs(ine.item() - pine.item())
    ine_tol = EM_INERTIA_RTOL * abs(pine.item()) + EM_INERTIA_ROW * mag
    check(ine_err <= ine_tol, f"fused_em {tag}: inertia {ine.item()} vs "
          f"plain {pine.item()}, beyond {ine_tol:.3e}")
    print(f"  fused_em_step {tag} N={n} D={d} K={k} "
          f"mask={row_w is not None} x_bf16={xk.dtype == torch.bfloat16}: "
          f"label mismatches {int(diff.sum())}, sums max abs err {err:.3e} "
          f"(rel {rel:.3e}), inertia {ine.item():.6e} vs plain "
          f"{pine.item():.6e}: {ine_err / ine_tol:.3f} of the bound")
    return err, (lab, sums, counts, ine)


def w8a8_inputs(n, d, f, gen):
    """bf16 activations, weights prepared as the towers prepare them."""
    import torch

    from scd_tpu_torch.ops import w8a8

    x = torch.randn(n, d, generator=gen, device="cuda").to(torch.bfloat16)
    wq_t, s_w = w8a8.prepare_weight(
        0.02 * torch.randn(d, f, generator=gen, device="cuda"))
    bias = 0.1 * torch.randn(f, generator=gen, device="cuda")
    return x, wq_t, s_w, bias


def _w8a8_check(got, want, act, tag):
    """The W8A8 contract (see W8A8_F32_RTOL); returns max abs error."""
    import torch

    err = (got.float() - want.float()).abs()
    if act is None:
        check(torch.equal(got, want), f"{tag}: not bit-equal before the "
              f"activation (max abs err {err.max().item():.3e})")
    elif got.dtype == torch.bfloat16:
        check(bool((err <= want.float().abs() * 2.0 ** -7).all()),
              f"{tag}: beyond one bf16 ulp")
    else:
        check(bool((err <= want.abs() * W8A8_F32_RTOL + 1e-7).all()),
              f"{tag}: beyond {W8A8_F32_RTOL} relative")
    return err.max().item()


def fusedq_parity(n, d, f, act, out, gen, tag, inputs=None):
    """Kernel vs plain on random inputs of one shape, or on ``inputs``
    (x, wq_t, s_w, bias) a path passed it; returns the max abs error."""
    import torch

    from scd_tpu_torch.ops import w8a8

    x, wq_t, s_w, bias = inputs or w8a8_inputs(n, d, f, gen)
    want = w8a8.dense_w8a8_fusedq_plain(x, wq_t, s_w, bias, out, act)
    got = w8a8.w8a8_fusedq_cuda(x, wq_t, s_w, bias, out, act)
    again = w8a8.w8a8_fusedq_cuda(x, wq_t, s_w, bias, out, act)
    torch.cuda.synchronize()
    name = f"w8a8_fusedq {tag}"
    check(torch.equal(got, again), f"{name}: two runs differ")
    err = _w8a8_check(got, want, act, name)
    if act is not None:  # and before the activation, bit-equal
        pre = w8a8.dense_w8a8_fusedq_plain(x, wq_t, s_w, bias, out, None)
        _w8a8_check(w8a8.w8a8_fusedq_cuda(x, wq_t, s_w, bias, out, None),
                    pre, None, f"{name} pre-activation")
    print(f"  {name} N={n} D={d} F={f} act={act} out={str(out)[6:]}: max "
          f"abs err {err:.3e}")
    return err


def prequant_parity(shape, f, gen, tag):
    """Kernel (through ``dense_w8a8`` or ``dense_w8a8_3d``) vs plain on one
    shape: equal bits for bf16 and f32 out, repeated bits, and where
    127^2 * D < 2^24 (every partial sum exact in f32) the int32
    accumulators themselves (unit scales, zero bias, f32 out) equal to the
    exact product; returns the max abs error."""
    import torch

    from scd_tpu_torch.ops import w8a8

    d = shape[-1]
    n = 1
    for s_ in shape[:-1]:
        n *= s_
    x, wq_t, s_w, bias = w8a8_inputs(n, d, f, gen)
    xq, s_x = w8a8.quantize_rows(x.reshape(*shape))
    fn = w8a8.dense_w8a8_3d if len(shape) == 3 else w8a8.dense_w8a8
    err = 0.0
    for out in (torch.bfloat16, torch.float32):
        got = fn(xq, wq_t, s_x, s_w, bias, out_dtype=out)
        again = fn(xq, wq_t, s_x, s_w, bias, out_dtype=out)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"w8a8_prequant {tag}: two runs differ")
        want = w8a8.dense_w8a8_plain(xq.reshape(n, d), wq_t, s_x, s_w, bias,
                                     out).reshape(got.shape)
        err = max(err, _w8a8_check(got, want, None, f"w8a8_prequant {tag}"))
    exact = d * 127 * 127 < 2 ** 24
    if exact:  # the int32 accumulators themselves
        acc = w8a8.w8a8_prequant_cuda(
            xq.reshape(n, d), torch.ones(n, device="cuda"), wq_t,
            torch.ones(f, device="cuda"), torch.zeros(f, device="cuda"),
            torch.float32)
        check(torch.equal(
            acc.double(), xq.reshape(n, d).double() @ wq_t.double().t()),
            f"w8a8_prequant {tag}: int32 accumulators differ")
    print(f"  w8a8_prequant {tag} shape={tuple(shape)} F={f} out=bf16, f32: "
          f"max abs err {err:.3e}, accumulators "
          f"{'equal' if exact else 'not exact in f32 at this D'}")
    return err


def _attn_inputs(b, length, h, d, dtype, packed, gen):
    """(q, k, v) [B, L, H, d] views: of one packed [B, L, 3*H*d] buffer,
    as the towers' qkv projection gives them, or three tensors."""
    import torch

    if packed:
        qkv = torch.randn(b, length, 3 * h * d, generator=gen,
                          device="cuda").to(dtype)
        t = qkv.unflatten(-1, (3, h, d))
        return qkv, (t[:, :, 0], t[:, :, 1], t[:, :, 2])
    qkv = None
    return qkv, tuple(torch.randn(b, length, h, d, generator=gen,
                                  device="cuda").to(dtype) for _ in range(3))


def attention_parity(b, length, h, d, dtype, gen, causal=False, l_valid=None,
                     packed=True, tag="", inputs=None, scale=None):
    """Kernel (through ``qkv_attention`` or ``vit_attention``) vs plain on
    one shape, with the tolerances above; returns the max abs error.
    ``inputs``: the (qkv, (q, k, v)) of ``_attn_inputs`` to check, else
    made here from ``gen``; ``scale`` defaults to d^-0.5."""
    import torch

    from scd_tpu_torch.ops import attention as A

    scale = d ** -0.5 if scale is None else scale
    qkv, (q, k, v) = inputs or _attn_inputs(b, length, h, d, dtype, packed,
                                            gen)
    if packed:
        def run():
            return A.qkv_attention(qkv, h, scale, causal, l_valid).reshape(
                b, length, h, d)
    else:
        def run():
            return A.vit_attention(q, k, v, scale, causal, l_valid)
    got, again = run(), run()
    torch.cuda.synchronize()
    name = f"attention {tag}"
    check(torch.equal(got, again), f"{name}: two runs differ")
    want = A.attention_plain(q, k, v, scale, causal, l_valid)
    err = (got.float() - want.float()).abs()
    vmax = v.float().abs().max().item()
    if dtype == torch.bfloat16:
        bound = ATTN_BF16_REL * want.float().abs() + ATTN_BF16_VREL * vmax
    else:
        bound = torch.full_like(err, ATTN_F32_VREL * vmax)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(bool((err <= bound).all()), f"{name}: error {err.max().item():.3e} "
          f"beyond the stated bound")
    print(f"  {name} B={b} L={length} H={h} d={d} {str(dtype)[6:]} "
          f"causal={causal} l_valid={l_valid} "
          f"{'qkv' if packed else 'vit'}: max abs err {err.max().item():.3e}"
          f" (max |v| {vmax:.2f})")
    return err.max().item()


def attention_bwd_parity(b, length, h, d, dtype, gen, l_valid=None, tag="",
                         inputs=None, scale=None, causal=False):
    """The gradient kernel (``qkv_attention_bwd_cuda``) against autograd
    of ``attention_plain`` on the card (``qkv_attention_bwd_plain``), from
    a random packed qkv and output gradient, or ``inputs`` (qkv, dout) a
    path passed it (``scale`` defaults to d^-0.5); every element of dQ,
    dK and dV within the bound of ``testing/attention_grad.py``, the bits
    repeated.  Returns the max abs error."""
    import torch

    from scd_tpu_torch.ops import attention as A
    from scd_tpu_torch.testing.attention_grad import grad_bound

    scale = d ** -0.5 if scale is None else scale
    if inputs is None:
        qkv = torch.randn(b, length, 3 * h * d, generator=gen,
                          device="cuda").to(dtype)
        dout = torch.randn(b, length, h * d, generator=gen,
                           device="cuda").to(dtype)
    else:
        qkv, dout = inputs
    got = A.qkv_attention_bwd_cuda(qkv, dout, h, scale, causal, l_valid)
    again = A.qkv_attention_bwd_cuda(qkv, dout, h, scale, causal, l_valid)
    torch.cuda.synchronize()
    name = f"attention_bwd {tag}"
    check(torch.equal(got, again), f"{name}: two runs differ")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite gradient")
    want = A.qkv_attention_bwd_plain(qkv, dout, h, scale, causal, l_valid)
    lv = length if l_valid is None else l_valid
    bound = grad_bound(qkv, dout, h, scale, lv, want, causal)
    errs = []
    for part, g, w, m in zip("qkv", A._heads(got, h), A._heads(want, h),
                             A._heads(bound, h)):
        err = (g.float() - w.float()).abs()
        ratio = (err / m.clamp_min(1e-30)).max().item()
        check(bool((err <= m).all()),
              f"{name}: d{part} error {err.max().item():.3e} beyond the "
              f"stated bound (worst ratio {ratio:.3f})")
        errs.append((err.max().item(), w.float().abs().max().item(), ratio))
    check(bool((A._heads(got, h)[1][:, lv:] == 0).all()
               and (A._heads(got, h)[2][:, lv:] == 0).all()),
          f"{name}: nonzero dK or dV at a masked key")
    print(f"  {name} B={b} L={length} H={h} d={d} {str(dtype)[6:]} "
          f"causal={causal} l_valid={l_valid} "
          f"route={A.bwd_route(dtype, d)}: max abs err dq/dk/dv "
          + " / ".join(f"{e:.3e} (max {m:.3e}, {r:.3f} of bound)"
                       for e, m, r in errs))
    return max(e for e, _m, _r in errs)


def parity_attention_bwd(seed: int):
    """The gradient kernel at the training shape, the int8-padded one,
    f32 (head_dim 64 at L 197, 257 and 577, and the SIMT head_dims), the
    edges and the long sequences of image 256, 288 and 384; returns the
    max abs errors at the training shape and of the f32 kernels at
    head_dim 64.  Shapes it does not take must raise."""
    import torch

    from scd_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    bf16, f32 = torch.bfloat16, torch.float32
    err = max(
        attention_bwd_parity(TRAIN_B, L_VIT, 12, 64, bf16, gen,
                             tag="train"),
        attention_bwd_parity(TRAIN_B, L_PAD, 12, 64, bf16, gen,
                             l_valid=L_VIT, tag="train-int8-pad"))
    before = _counts()["attention_bwd_f32"]
    err_f32 = max(
        attention_bwd_parity(16, L_VIT, 12, 64, f32, gen, tag="f32-train"),
        attention_bwd_parity(4, L_257, 12, 64, f32, gen, l_valid=250,
                             tag="f32-L257"),
        attention_bwd_parity(2, 577, 12, 64, f32, gen, tag="f32-L577"))
    attention_bwd_parity(5, 1, 3, 64, f32, gen, tag="edge-f32-L1")
    attention_bwd_parity(7, 65, 3, 64, f32, gen, l_valid=33,
                         tag="edge-f32-L65")
    n = _counts()["attention_bwd_f32"] - before
    check(n == 2 * 5, f"attention_bwd: {n} launches of the f32 kernels at "
          f"head_dim 64 for 5 shapes x 2")
    attention_bwd_parity(5, 1, 3, 64, bf16, gen, tag="edge-L1")
    attention_bwd_parity(7, 17, 5, 64, bf16, gen, l_valid=9,
                         tag="edge-L17")
    attention_bwd_parity(3, 256, 7, 64, bf16, gen, tag="edge-L256")
    for length in (L_257, 325, 577):  # image 256, 288, 384
        attention_bwd_parity(32, length, 12, 64, bf16, gen,
                             tag=f"long-L{length}")
    attention_bwd_parity(3, 256, 2, 128, f32, gen, l_valid=200,
                         tag="edge-f32-d128")
    attention_bwd_parity(4, 33, 3, 40, f32, gen, tag="edge-f32-d40")
    check(_counts()["attention_bwd_f32"] - before == n,
          "attention_bwd: an f32 shape at another head_dim took the f32 "
          "kernels at head_dim 64")
    dout = torch.zeros(2, 16, 288, device="cuda", dtype=bf16)
    off = torch.zeros(2 * 16 * 3 * 64 + 1, device="cuda")[1:].view(2, 16, 192)
    wide = torch.zeros(2, 16, 3 * 288, device="cuda", dtype=bf16)
    for args, what in (((off, dout[..., :64].float(), 1, 0.125),
                        "a misaligned f32 head_dim-64 view"),
                       ((wide, dout, 1, 0.125), "head_dim 288")):
        try:
            A.qkv_attention_bwd_cuda(*args)
        except (NotImplementedError, ValueError):
            continue
        fail(f"attention_bwd: {what} did not raise")
    return err, err_f32


def estep_parity(n, d, k, gen, dup=False, view=False, tag=""):
    """Kernel (through ``estep_assign``) vs plain on one shape: labels
    equal wherever the exact (f64) distances of the two choices differ by
    more than ESTEP_DIST_TOL, min distances within it, and ties to the
    lowest index; returns the max abs error of the min distances.
    ``view``: x is the rows from 1 on of a contiguous [N + 1, D] tensor (a
    base that is not 16-byte aligned where D % 4 != 0)."""
    import torch

    from scd_tpu_torch.ops.distance import estep_assign, estep_assign_plain

    x, c = em_inputs(n, d, max(k, 1), gen)
    if view:
        x = torch.cat([x[:1], x])[1:]
    if dup:  # exact ties: center 2j+1 repeats center 2j
        c[1::2] = c[0::2][:c[1::2].shape[0]]
    lab, md = estep_assign(x, c)
    lab2, md2 = estep_assign(x, c)
    torch.cuda.synchronize()
    name = f"estep_assign {tag}"
    check(torch.equal(lab, lab2) and torch.equal(md, md2),
          f"{name}: two runs differ")
    plab, pmd = estep_assign_plain(x, c)
    diff = lab.long() != plab.long()
    if bool(diff.any()):
        rows = diff.nonzero().flatten()
        x64 = x[rows].double()
        dk = ((x64 - c[lab[rows].long()].double()) ** 2).sum(1)
        dp = ((x64 - c[plab[rows].long()].double()) ** 2).sum(1)
        gap = (dk - dp).abs().max().item()
        check(gap <= ESTEP_DIST_TOL,
              f"{name}: labels differ beyond the tie band ({gap:.3e})")
    if dup:
        check(bool((lab % 2 == 0).all()), f"{name}: a tie did not go to the "
              "lowest index")
    err = (md - pmd).abs().max().item()
    check(err <= ESTEP_DIST_TOL, f"{name}: min distance error {err:.3e}")
    print(f"  {name} N={n} D={d} K={k}: label mismatches "
          f"{int(diff.sum())}, min distance max abs err {err:.3e}")
    return err


def parity_attention_estep(seed: int):
    """Parity of the attention and estep kernels; returns the max abs
    errors at the main paths' shapes."""
    import torch

    from scd_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    errs = {}
    bf16, f32 = torch.bfloat16, torch.float32
    errs["vit_attention"] = attention_parity(BATCH, L_VIT, 12, 64, bf16, gen,
                                             packed=False, tag="image")
    errs["qkv_attention"] = max(
        attention_parity(BATCH, L_VIT, 12, 64, bf16, gen, tag="image"),
        attention_parity(BATCH, L_PAD, 12, 64, bf16, gen, l_valid=L_VIT,
                         tag="image-int8-pad"),
        attention_parity(TEXT_BATCH, 77, 8, 64, bf16, gen, causal=True,
                         tag="text"),
        attention_parity(TEXT_BATCH, 80, 8, 64, bf16, gen, causal=True,
                         tag="text-int8-pad"))
    attention_parity(3, 5, 5, 64, bf16, gen, tag="edge-L5")
    attention_parity(7, 1, 3, 64, bf16, gen, causal=True, packed=False,
                     tag="edge-L1")
    attention_parity(3, 33, 5, 64, bf16, gen, causal=True, l_valid=20,
                     tag="edge-BH15")
    attention_parity(2, 16, 3, 64, bf16, gen, packed=False, tag="edge-L16")
    attention_parity(5, 256, 7, 64, bf16, gen, causal=True, tag="edge-L256")
    attention_parity(11, 129, 3, 64, bf16, gen, l_valid=100, packed=False,
                     tag="edge-L129")
    # every key-tile template and both masks, packed and not, with
    # 7 x 19 = 133 (batch, head) pairs: not a multiple of the grid
    for i, length in enumerate((1, 5, 16, 32, 77, 80, L_VIT, L_PAD, 256)):
        for causal in (False, True):
            attention_parity(
                7, length, 19, 64, bf16, gen, causal=causal,
                l_valid=L_VIT if length == L_PAD else None,
                packed=(i + causal) % 2 == 0,
                tag=f"edge-grid-L{length}{'-causal' if causal else ''}")
    # the long paths (L > 256): towers at image 256, 288, 384, 448 and
    # 512; bf16 on wgmma (L 1,025 past the 832 keys that stay resident:
    # streamed), f32 on SIMT
    before = _counts()
    long_edges = (
        (L_257, 12, False, None, bf16, True),
        (L_257, 12, True, None, bf16, False),
        (325, 12, False, 300, bf16, True),
        (325, 7, True, None, f32, False),
        (577, 12, False, None, bf16, False),
        (577, 5, True, 500, bf16, True),
        (577, 3, False, None, f32, True),
        (785, 12, False, None, bf16, True),
        (785, 5, True, 700, bf16, False),
        (1_025, 3, False, None, bf16, True),
        (1_025, 2, True, 900, bf16, False))
    for length, h, causal, l_valid, dtype, packed in long_edges:
        attention_parity(3, length, h, 64, dtype, gen, causal=causal,
                         l_valid=l_valid, packed=packed,
                         tag=f"long-L{length}{'-causal' if causal else ''}")
    after = _counts()
    n_bf16 = sum(e[4] == bf16 for e in long_edges)
    check(after["attention_long"] - before["attention_long"]
          == 2 * len(long_edges),
          "attention: the long edges did not all take a long path")
    check(after["attention_long_wgmma"] - before["attention_long_wgmma"]
          == 2 * n_bf16, "attention: the bf16 long edges did not all take "
          "the wgmma long path, or an f32 one did")
    check(after["attention_f32"] - before["attention_f32"]
          == 2 * (len(long_edges) - n_bf16), "attention: the f32 long "
          "edges did not all take the f32 kernel at head_dim 64")
    # f32 at head_dim 64 (three TF32 passes on wgmma, any L): the
    # baselines' shape, image 256 / 288 / 384 (l_valid < L at 325), the
    # causal text shape, the edges; then the SIMT routes at other
    # head_dims (d 32 short and long, d 128), which it must not take
    before = _counts()
    errs["qkv_attention_f32"] = max(
        attention_parity(4, length, 12, 64, f32, gen, l_valid=lv,
                         tag=f"f32-L{length}")
        for length, lv in ((L_VIT, None), (L_257, None), (325, 300),
                           (577, None)))
    attention_parity(3, 77, 8, 64, f32, gen, causal=True, packed=False,
                     tag="f32-text")
    attention_parity(7, 1, 3, 64, f32, gen, causal=True, packed=False,
                     tag="f32-edge-L1")
    attention_parity(5, 65, 3, 64, f32, gen, l_valid=33, tag="f32-edge-L65")
    attention_parity(2, 785, 3, 64, f32, gen, causal=True, l_valid=700,
                     tag="f32-edge-L785-causal")
    f32_tc = _counts()["attention_f32"] - before["attention_f32"]
    check(f32_tc == 2 * 8, f"attention: {f32_tc} launches of the f32 "
          f"kernel at head_dim 64 for 8 shapes x 2")
    attention_parity(3, 5, 2, 32, f32, gen, l_valid=4, tag="f32-d32")
    attention_parity(3, 325, 2, 32, f32, gen, causal=True,
                     tag="f32-d32-long")
    attention_parity(2, 100, 3, 128, f32, gen, l_valid=90, tag="f32-d128")
    check(_counts()["attention_f32"] - before["attention_f32"] == f32_tc,
          "attention: an f32 shape at another head_dim took the f32 kernel "
          "at head_dim 64")
    # an f32 head_dim-64 view off the 16-byte grid raises: no other route
    x = torch.zeros(4 * L_VIT * 12 * 64 + 1, device="cuda")[1:].view(
        4, L_VIT, 12, 64)
    try:
        A.vit_attention(x, x, x, 0.125)
    except ValueError:
        pass
    else:
        fail("attention: a misaligned f32 head_dim-64 view did not raise")
    errs["estep_assign"] = estep_parity(RUNNER_N, D_FEAT, K, gen,
                                        tag="runner")
    estep_parity(1_001, 768, 100, gen, tag="edge-ragged")
    estep_parity(3_000, 64, 1, gen, tag="edge-K1")
    estep_parity(20_000, 768, 300, gen, tag="edge-K300")
    estep_parity(5_000, 100, 130, gen, dup=True, tag="edge-ties")
    # rows TMA cannot read where they lie (copied once, aligned), and the
    # runners' shape with exact ties
    estep_parity(1_001, 101, 7, gen, view=True, tag="edge-d101-view")
    estep_parity(RUNNER_N, D_FEAT, K, gen, dup=True, tag="runner-ties")
    return errs


def phase_parity(seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs = {}
    bf16, f32 = torch.bfloat16, torch.float32
    n_img = BATCH * L_PAD  # one padded image batch: 26,624 rows
    errs["w8a8_fusedq"] = max(
        fusedq_parity(n_img, 768, 2_304, None, bf16, gen, "vit-qkv"),
        fusedq_parity(n_img, 768, 3_072, "gelu_tanh", bf16, gen,
                      "dino-fc1"),
        fusedq_parity(n_img, 768, 3_072, "quick_gelu", bf16, gen,
                      "clip-fc1"),
        fusedq_parity(64 * 80 * 16, 512, 1_536, None, bf16, gen,
                      "text-qkv-L16"),
        fusedq_parity(64 * 80 * 32, 512, 2_048, "quick_gelu", bf16, gen,
                      "text-fc1-L32"))
    fusedq_parity(1_001, 768, 200, "gelu", f32, gen, "edge-ragged")
    fusedq_parity(129, 64, 130, "gelu_tanh", f32, gen, "edge-tiny")
    fusedq_parity(3_000, 512, 1_000, "quick_gelu", f32, gen, "edge-f32")
    fusedq_parity(77, 16, 9, None, bf16, gen, "edge-d16")
    fusedq_parity(300, 80, 129, "quick_gelu", bf16, gen, "edge-d80")
    fusedq_parity(500, 1_536, 300, "gelu_tanh", bf16, gen, "edge-d1536")
    fusedq_parity(1_001, 512, 1_001, None, bf16, gen, "edge-d512")
    fusedq_parity(3_001, 768, 2_310, "quick_gelu", bf16, gen, "edge-d768")
    fusedq_parity(129, 1_536, 2_305, None, f32, gen, "edge-d1536-f32")
    errs["w8a8_prequant"] = max(
        prequant_parity((BATCH, L_VIT, 768), 2_304, gen, "vit-qkv-L197"),
        prequant_parity((BATCH, L_VIT, 768), 3_072, gen, "vit-fc1-L197"))
    prequant_parity((1_001, 512), 200, gen, "edge-ragged")
    prequant_parity((3, 13, 64), 130, gen, "edge-3d")
    # the D > 1536 route (layers wider than w8a8_fusedq takes), N 1, and
    # the unpadded qkv layer as a 2-D matrix
    prequant_parity((1_003, 2_048), 500, gen, "edge-d2048")
    prequant_parity((BATCH, L_VIT, 3_072), 768, gen, "d3072")
    prequant_parity((1, 768), 2_304, gen, "edge-N1")
    prequant_parity((BATCH * L_VIT, 768), 2_304, gen, "vit-qkv-2d")
    errs["topk_softmax"] = topk_parity(N_IMAGES - 32_512, D_CLIP, VOCAB,
                                       TOPK, gen, tag="slice")[0]
    # the ptsup bound passes: k 1 over raw logits, over the vocabulary
    # and over the ground-truth names alone (V = K)
    topk_parity(N_IMAGES - 32_512, D_CLIP, VOCAB, 1, gen, tag="bound-lb")
    topk_parity(N_IMAGES - 32_512, D_CLIP, K, 1, gen, tag="bound-ub")
    topk_parity(1_005, 64, 1_003, 1, gen, tag="edge-k1")
    topk_parity(1_005, 64, 1_003, 16, gen, tag="edge-k16")
    topk_parity(777, 100, 2_000, 5, gen, dup_cols=True, tag="edge-ties")
    for k in (17, 32):
        topk_route_parity(1_005, 64, 1_003, k, gen)
    errs["fused_em_step"] = em_parity(N_IMAGES - 32_512, D_FEAT, K, gen,
                                      tag="slice")
    em_parity(N_IMAGES - 32_512, D_FEAT, K, gen, x_bf16=True,
              tag="slice-bf16")
    em_parity(1_005, 768, 7, gen, masked=True, tag="edge-K7")
    em_parity(20_000, 768, 683, gen, masked=True, tag="edge-K683")
    em_parity(3_001, 100, 130, gen, x_bf16=True, masked=True,
              tag="edge-bf16")
    em_parity(3_000, 64, 1, gen, x_bf16=True, tag="edge-K1-bf16")
    # N under one 64-row stage; K < N, since em_inputs picks the centers
    # from the rows (with K >= N every row would be a center, inertia 0)
    em_parity(37, 768, 7, gen, x_bf16=True, masked=True, tag="edge-N37-bf16")
    em_parity(20_000, 768, 683, gen, x_bf16=True, tag="edge-K683-bf16")
    errs.update(parity_attention_estep(seed))
    errs["attention_bwd"], errs["attention_bwd_f32"] = parity_attention_bwd(
        seed)
    return errs


# ------------------------------------------------------------- phase 3

def _metric_lines(text):
    prefixes = ("SSKM Accuracies:", "KM Accuracies:", "iter:",
                "Accuracies:", "ACC/sACC_avg/sACC_all:", "ACC/Soft sACC:",
                "IoU:")
    return [ln.rstrip() for ln in text.splitlines()
            if ln.startswith(prefixes)]


def phase_main_path(seed: int, workdir: str):
    import dataclasses

    import torch

    from scd_tpu_torch.cluster import kmeans
    from scd_tpu_torch.pipelines.unsup import run_unsup
    from scd_tpu_torch.testing.fabricate import (fabricate_imagenet100,
                                                 imagenet100_config)

    t0 = time.perf_counter()
    cfg = imagenet100_config(os.path.join(workdir, "in100"))
    info = fabricate_imagenet100(cfg, seed=seed, device="cuda",
                                 n_images=N_IMAGES, d_feat=D_FEAT,
                                 d_clip=D_CLIP, vocab=VOCAB)
    check(info["n_images"] == N_IMAGES and info["n_labelled"] == 32_512,
          f"fabricated {info['n_images']} / {info['n_labelled']} rows")
    print(f"fabricated N={info['n_images']} (labelled "
          f"{info['n_labelled']}), V={len(info['nouns'])} in "
          f"{time.perf_counter() - t0:.1f} s")

    _reset_counts()
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = run_unsup(cfg, device="cuda")
    wall = time.perf_counter() - t0
    counts = _counts()
    launches = {k: counts[k] for k in ("topk_softmax", "fused_em_step")}
    for ln in _metric_lines(out.getvalue()):
        print("  " + ln)
    print("stage seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["stage_seconds"].items())
        + f" | run_unsup {wall:.3f} s")
    estep = kmeans._ESTEP_PROBE_MEMO.get(
        ((N_IMAGES - 32_512, D_FEAT), K, "cuda"), (3, False))
    print(f"launches in run_unsup: {launches}; E-step mode "
          f"{'x_bf16' if estep[1] else 'exact'}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")

    u_preds = res["voting"].u_preds
    check(u_preds.shape == (N_IMAGES - 32_512,), f"u_preds {u_preds.shape}")
    acc = res["cluster_acc"][0]
    vote_acc = res["history"][-1]["all_acc"]
    check(acc >= ACC_FLOOR and vote_acc >= ACC_FLOOR,
          f"ACC {acc} / voted ACC {vote_acc} below {ACC_FLOOR}")
    check(res["iou"] >= IOU_FLOOR, f"IoU {res['iou']} below {IOU_FLOOR}")

    # small root: the card and the CPU print the same metric lines
    small = imagenet100_config(os.path.join(workdir, "small"), n_init=2,
                               max_iterations=5)
    fabricate_imagenet100(small, seed=seed, device="cuda", n_images=4_000,
                          d_feat=64, d_clip=32, vocab=3_000, n_genus=20)
    texts = {}
    for dev, run_cluster in (("cuda", True), ("cuda", False), ("cpu", False)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run_unsup(dataclasses.replace(small, run_cluster=run_cluster),
                      device=dev)
        texts[(dev, run_cluster)] = _metric_lines(buf.getvalue())
    check(texts[("cuda", False)] == texts[("cpu", False)]
          and len(texts[("cpu", False)]) > 3,
          "small root: card and CPU metric lines differ")
    print(f"small root: {len(texts[('cpu', False)])} metric lines equal on "
          f"the card and the CPU")
    return launches, estep, cfg


# ------------------------------------------------------------- phase 4

def _counters():
    """{name: (function, attribute)} of every count: each kernel wrapper's
    ``launches``, the attention long paths' launches (also in
    ``attention``) and of those the bf16 ``wgmma`` long path's, the f32
    attention forward's and gradient's launches at head_dim 64 (three TF32
    passes on ``wgmma``; also in ``attention`` and ``attention_bwd``), the
    top-k route past the kernel (k > 16), the prefix attention's
    launches and of those the ``mma.sync`` kernel's, the attention's bf16
    launches of the SIMT kernel (head_dim != 64), and the gradient's
    launches on the SIMT route and under ``causal``."""
    from scd_tpu_torch.ops import attention, distance, em, topk, w8a8

    return {"topk_softmax": (topk.topk_softmax_cuda, "launches"),
            "fused_em_step": (em.fused_em_step_cuda, "launches"),
            "w8a8_fusedq": (w8a8.w8a8_fusedq_cuda, "launches"),
            "w8a8_prequant": (w8a8.w8a8_prequant_cuda, "launches"),
            "attention": (attention.attention_cuda, "launches"),
            "attention_long": (attention.attention_cuda, "long_launches"),
            "attention_long_wgmma": (attention.attention_cuda,
                                     "long_wgmma_launches"),
            "attention_f32": (attention.attention_cuda,
                              "f32_wgmma_launches"),
            "estep_assign": (distance.estep_assign_cuda, "launches"),
            "topk_matmul_route": (topk.classify_topk, "matmul_calls"),
            "attention_bwd": (attention.qkv_attention_bwd_cuda,
                              "launches"),
            "attention_bwd_f32": (attention.qkv_attention_bwd_cuda,
                                  "f32_wgmma_launches"),
            "attention_simt_bf16": (attention.attention_cuda,
                                    "simt_bf16_launches"),
            "attention_bwd_simt": (attention.qkv_attention_bwd_cuda,
                                   "simt_launches"),
            "attention_bwd_causal": (attention.qkv_attention_bwd_cuda,
                                     "causal_launches"),
            "prefix_attention": (attention.prefix_attention_cuda,
                                 "launches"),
            "prefix_attention_mma": (attention.prefix_attention_cuda,
                                     "mma_launches")}


def _reset_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def _counts():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in _counters().items()}


def _row_cos(a, b):
    import numpy as np
    import torch

    a, b = np.asarray(a) if not isinstance(a, torch.Tensor) else a, \
        np.asarray(b) if not isinstance(b, torch.Tensor) else b
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return ((a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)))


def _towers(cfg, device, dtype, int8, pad_seq_to="auto"):
    """The cold root's CLIP model and DINO tower at ``dtype`` compute."""
    import dataclasses

    import torch

    from scd_tpu_torch.models import (CLIPModel, VisionTransformer,
                                      clip_vit_b16_config,
                                      dino_vit_b16_config, load_dino_weights,
                                      load_openai_clip_weights,
                                      params_from_flax)

    ccfg = clip_vit_b16_config(dtype, dense_int8=int8)
    dcfg = dataclasses.replace(
        dino_vit_b16_config(dtype, gelu_tanh=cfg.feature.gelu_tanh,
                            dense_int8=int8), pad_seq_to=pad_seq_to)
    clip = CLIPModel(ccfg, device=device)
    clip.load_state_dict(params_from_flax(load_openai_clip_weights(
        torch.load(cfg.data.clip_weights), ccfg)))
    dino = VisionTransformer(dcfg, device=device)
    dino.load_state_dict(params_from_flax(load_dino_weights(
        torch.load(cfg.data.dino_weights), dcfg)))
    return clip.eval(), dino.eval()


def phase_cold(seed: int, workdir: str):
    """The cold main path at full width and depth under --int8."""
    import numpy as np
    import torch

    from scd_tpu_torch.core.cache import ArtifactCache
    from scd_tpu_torch.data import get_datasets
    from scd_tpu_torch.data.transforms import device_normalize_clip
    from scd_tpu_torch.models import (CLIPTokenizer, clip_vit_b16_config,
                                      dino_vit_b16_config)
    from scd_tpu_torch.naming.templates import IMAGENET_TEMPLATES
    from scd_tpu_torch.naming.zeroshot import (build_zeroshot_weights,
                                               truncate_to_eot_bucket)
    from scd_tpu_torch.pipelines.common import (feature_cache_key,
                                                pipeline_transform)
    from scd_tpu_torch.pipelines.unsup import run_unsup
    from scd_tpu_torch.testing.fabricate import (cold_config,
                                                 fabricate_cold_root,
                                                 fabricated_images)

    t0 = time.perf_counter()
    cfg = cold_config(os.path.join(workdir, "cold"), dense_int8=True,
                      batch_size=BATCH, num_workers=8)
    info = fabricate_cold_root(
        cfg, clip_vit_b16_config(dense_int8=True),
        dino_vit_b16_config(gelu_tanh=cfg.feature.gelu_tanh,
                            dense_int8=True),
        seed=seed, n_images=COLD_IMAGES, vocab=COLD_VOCAB)
    print(f"fabricated N={COLD_IMAGES} images, V={len(info['nouns'])} "
          f"names, CLIP ViT-B/16 + DINO ViT-B/16 weights and merges in "
          f"{time.perf_counter() - t0:.1f} s")

    _reset_counts()
    t0 = time.perf_counter()
    out = io.StringIO()
    with fabricated_images(seed), contextlib.redirect_stdout(out):
        res = run_unsup(cfg, device="cuda")
    wall = time.perf_counter() - t0
    launches = _counts()
    lines = _metric_lines(out.getvalue())
    for ln in lines[:3] + lines[-2:]:
        print("  " + ln)
    print("stage seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["stage_seconds"].items())
        + f" | run_unsup {wall:.3f} s")
    print(f"launches in the cold run_unsup: {launches}")
    check(all(launches[k] > 0 for k in ("w8a8_fusedq", "topk_softmax",
                                         "fused_em_step", "attention")),
          f"a kernel of the cold path never launched: {launches}")
    print(f"cold ACC {res['cluster_acc'][0]:.4f} (SSKM), voted "
          f"{res['history'][-1]['all_acc']:.4f}, IoU {res['iou']:.4f} "
          "(random weights: no floor)")

    # ---- the card's outputs against the CPU's (plain versions, f32)
    store = ArtifactCache(cfg.data.cache_dir)
    feats = store.load("features", feature_cache_key(cfg, "feat"))
    clip_feats = store.load("features", feature_cache_key(cfg, "clip"))
    zw = store.load("zeroshot", feature_cache_key(cfg, "zw_wordnet"))
    for name, arr in (("feat", feats["all_feats"]),
                      ("clip", clip_feats["all_feats"]),
                      ("zeroshot", zw["weights"])):
        check(bool(np.isfinite(arr).all()), f"cold {name}: non-finite")
    check(feats["all_feats"].shape == (COLD_IMAGES, D_FEAT)
          and clip_feats["all_feats"].shape == (COLD_IMAGES, D_CLIP)
          and zw["weights"].shape == (D_CLIP, COLD_VOCAB),
          "cold caches: unexpected shapes")
    tf = pipeline_transform(cfg)
    with fabricated_images(seed):
        train, _t, _u, _e = get_datasets(cfg.data, train_transform=tf,
                                         test_transform=tf)
        images = np.stack([train[i][0] for i in range(256)])
    t0 = time.perf_counter()
    cpu_clip, cpu_dino = _towers(cfg, "cpu", torch.float32, True)
    x8 = device_normalize_clip(torch.from_numpy(images[:8]))
    with torch.inference_mode():
        ref_feat = cpu_dino(x8).numpy()
        ref_clip = cpu_clip.encode_image(x8).numpy()
    cos_feat = _row_cos(feats["all_feats"][:8], ref_feat).min().item()
    cos_clip = _row_cos(clip_feats["all_feats"][:8], ref_clip).min().item()
    tok = CLIPTokenizer(os.path.join(cfg.data.corpus_dir,
                                     "bpe_simple_vocab_16e6.txt.gz"))
    nouns = info["nouns"]
    cols = np.linspace(0, len(nouns) - 1, COLD_CPU_COLUMNS).round().astype(
        int)

    def cpu_text(texts):
        toks = truncate_to_eot_bucket(np.asarray(tok(texts), np.int32))
        with torch.inference_mode():
            return cpu_clip.encode_text(torch.from_numpy(toks)).numpy()

    ref_zw = build_zeroshot_weights(cpu_text, [nouns[c] for c in cols],
                                    IMAGENET_TEMPLATES)
    cos_zw = _row_cos(zw["weights"][:, cols].T, ref_zw.T).min().item()
    print(f"card vs CPU (f32, plain int8 chain), min cosine: 8 DINO "
          f"features {cos_feat:.6f}, 8 CLIP features {cos_clip:.6f}, "
          f"{COLD_CPU_COLUMNS} zero-shot columns {cos_zw:.6f} (tolerance "
          f"{TOWER_COS_TOL}; "
          f"{time.perf_counter() - t0:.1f} s on the CPU)")
    check(min(cos_feat, cos_clip, cos_zw) >= TOWER_COS_TOL,
          "cold path: the card disagrees with the CPU")

    # ---- the unpadded DINO tower: w8a8_prequant on a path
    _, dino0 = _towers(cfg, "cuda", torch.bfloat16, True, pad_seq_to=0)
    x256 = device_normalize_clip(torch.from_numpy(images).cuda())
    _reset_counts()
    with torch.inference_mode():
        f0 = torch.cat([dino0(x256[i:i + BATCH])
                        for i in range(0, 256, BATCH)])
    torch.cuda.synchronize()
    pad0 = _counts()
    print(f"launches in the pad_seq_to=0 DINO pass over 256 images: {pad0}")
    check(pad0["w8a8_prequant"] > 0 and pad0["w8a8_fusedq"] == 0,
          f"the unpadded tower did not run w8a8_prequant alone: {pad0}")
    t0 = time.perf_counter()
    _, cpu_dino0 = _towers(cfg, "cpu", torch.float32, True, pad_seq_to=0)
    n0 = COLD_CPU_PAD0_IMAGES
    with torch.inference_mode():
        ref0 = cpu_dino0(device_normalize_clip(torch.from_numpy(images[:n0])))
    cos0 = _row_cos(f0[:n0].float().cpu(), ref0).min().item()
    cos_pad = _row_cos(f0.float().cpu(), feats["all_feats"][:256]).min(
    ).item()
    print(f"pad_seq_to=0 DINO (w8a8_prequant) vs CPU, min cosine over the "
          f"first {n0} images: {cos0:.6f} ({time.perf_counter() - t0:.1f} s "
          f"on the CPU); vs the padded tower's cached features over 256: "
          f"{cos_pad:.6f}")
    check(cos0 >= TOWER_COS_TOL, "pad_seq_to=0 DINO: card disagrees with CPU")
    del dino0, cpu_dino0, cpu_clip, cpu_dino

    # ---- int8 against the bf16 towers (printed, not gated)
    bf_clip, bf_dino = _towers(cfg, "cuda", torch.bfloat16, False)
    with torch.inference_mode():
        bf_feat = torch.cat([bf_dino(x256[i:i + BATCH])
                             for i in range(0, 256, BATCH)]).cpu()
        bf_img = torch.cat([bf_clip.encode_image(x256[i:i + BATCH])
                            for i in range(0, 256, BATCH)]).cpu()
    cf = _row_cos(feats["all_feats"][:256], bf_feat)
    cc = _row_cos(clip_feats["all_feats"][:256], bf_img)
    print(f"int8 vs bf16 towers over 256 images, cosine mean / min: DINO "
          f"{cf.mean().item():.6f} / {cf.min().item():.6f}, CLIP "
          f"{cc.mean().item():.6f} / {cc.min().item():.6f}")

    # ---- one batch through each tower, int8 against bf16 (device time)
    q_clip, q_dino = _towers(cfg, "cuda", torch.bfloat16, True)
    xb = x256[:BATCH]
    toks = torch.from_numpy(truncate_to_eot_bucket(tok.prompt_tokens(
        IMAGENET_TEMPLATES, [nouns[c] for c in cols]))).cuda()
    with torch.inference_mode():
        for tag, q, b in (
                ("DINO ViT-B/16, 128 images", lambda: q_dino(xb),
                 lambda: bf_dino(xb)),
                ("CLIP image, 128 images", lambda: q_clip.encode_image(xb),
                 lambda: bf_clip.encode_image(xb)),
                (f"CLIP text, {toks.shape[0]} prompts x {toks.shape[1]} "
                 "tokens", lambda: q_clip.encode_text(toks),
                 lambda: bf_clip.encode_text(toks))):
            t_q, t_b = cuda_ms(q, reps=5), cuda_ms(b, reps=5)
            print(f"  tower {tag}: int8 {t_q:.2f} ms, bf16 {t_b:.2f} ms")
    del bf_clip, bf_dino, q_clip, q_dino
    return {"w8a8_fusedq": launches["w8a8_fusedq"],
            "w8a8_prequant": pad0["w8a8_prequant"]}


# ------------------------------------------------------------- phase 5

def _w8a8_bound(n, d, f, x_bytes, out_bytes):
    ops = 2.0 * n * d * f
    nbytes = (n * d * x_bytes + d * f + 8.0 * f + n * out_bytes * f
              + (4.0 * n if x_bytes == 1 else 0.0))
    by = "operations" if ops / PEAK_INT8_OPS >= nbytes / PEAK_HBM_BYTES \
        else "bytes"
    return max(ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES) * 1e3, by, ops


def time_w8a8(gen):
    """Both W8A8 entry points at the towers' shapes: kernel, plain, the
    yardstick (``torch._int_mm`` with the same quantization chain and
    dequant; for ``w8a8_prequant`` also ``_int_mm`` alone), and the bf16
    ``F.linear`` of the same layer."""
    import torch
    import torch.nn.functional as F

    from scd_tpu_torch.ops import w8a8

    bf16 = torch.bfloat16
    out = {}
    shapes = [("vit-qkv", BATCH * L_PAD, 768, 2_304, None),
              ("vit-fc1", BATCH * L_PAD, 768, 3_072, "gelu_tanh"),
              ("text-qkv", 64 * 80 * 32, 512, 1_536, None),
              ("text-fc1", 64 * 80 * 32, 512, 2_048, "quick_gelu")]
    for tag, n, d, f, act in shapes:
        x, wq_t, s_w, bias = w8a8_inputs(n, d, f, gen)
        wq, w_bf = wq_t.t().contiguous(), (wq_t.float().t() * s_w).to(bf16)

        def library():
            xq, s_x = w8a8.quantize_rows(x)
            y = torch._int_mm(xq, wq).float() * s_x * s_w + bias
            return w8a8.act_plain(y, act).to(bf16)

        ms = cuda_ms(lambda: w8a8.w8a8_fusedq_cuda(x, wq_t, s_w, bias, bf16,
                                                   act), reps=20, warmup=2)
        ms_again = cuda_ms(lambda: w8a8.w8a8_fusedq_cuda(
            x, wq_t, s_w, bias, bf16, act), reps=20, warmup=2)
        plain = cuda_ms(lambda: w8a8.dense_w8a8_fusedq_plain(
            x, wq_t, s_w, bias, bf16, act), reps=3)
        lib = cuda_ms(library, reps=20, warmup=2)
        lin = cuda_ms(lambda: F.linear(x, w_bf.t(), bias.to(bf16)), reps=20,
                      warmup=2)
        bound, by, ops = _w8a8_bound(n, d, f, 2, 2)
        print(f"  w8a8_fusedq {tag} N={n} D={d} F={f} act={act}: kernel "
              f"{ms:.4f} ms ({ops / ms / 1e9:.0f} TOP/s; again "
              f"{ms_again:.4f} ms), plain "
              f"{plain:.4f} ms, library (_int_mm chain) {lib:.4f} ms, bf16 "
              f"F.linear {lin:.4f} ms, bound {bound:.4f} ms ({by})")
        out.setdefault("w8a8_fusedq", (ms, plain, lib, bound, by))
    # w8a8_prequant: the unpadded tower's qkv layer (the kernels line), and
    # a layer wider than w8a8_fusedq takes (printed only)
    for tag, n, d, f in (("vit-qkv-L197", BATCH * L_VIT, 768, 2_304),
                         ("d3072", BATCH * L_VIT, 3_072, 768)):
        x, wq_t, s_w, bias = w8a8_inputs(n, d, f, gen)
        xq, s_x = w8a8.quantize_rows(x)
        wq, w_bf = wq_t.t().contiguous(), (wq_t.float().t() * s_w).to(bf16)
        ms = cuda_ms(lambda: w8a8.w8a8_prequant_cuda(xq, s_x, wq_t, s_w,
                                                     bias, bf16),
                     reps=20, warmup=2)
        ms_again = cuda_ms(lambda: w8a8.w8a8_prequant_cuda(
            xq, s_x, wq_t, s_w, bias, bf16), reps=20, warmup=2)
        plain = cuda_ms(lambda: w8a8.dense_w8a8_plain(xq, wq_t, s_x, s_w,
                                                      bias, bf16), reps=3)
        lib = cuda_ms(lambda: (torch._int_mm(xq, wq).float() * s_x * s_w
                               + bias).to(bf16), reps=20, warmup=2)
        int_mm = cuda_ms(lambda: torch._int_mm(xq, wq), reps=20, warmup=2)
        lin = cuda_ms(lambda: F.linear(x, w_bf.t(), bias.to(bf16)), reps=20,
                      warmup=2)
        bound, by, ops = _w8a8_bound(n, d, f, 1, 2)
        print(f"  w8a8_prequant {tag} N={n} D={d} F={f}: kernel {ms:.4f} ms "
              f"({ops / ms / 1e9:.0f} TOP/s; again {ms_again:.4f} ms), plain "
              f"{plain:.4f} ms, library (_int_mm + dequant) {lib:.4f} ms, "
              f"_int_mm alone {int_mm:.4f} ms, bf16 F.linear {lin:.4f} ms, "
              f"bound {bound:.4f} ms ({by})")
        out.setdefault("w8a8_prequant", (ms, plain, lib, bound, by))
        del x, xq, s_x, wq_t, s_w, bias, wq, w_bf
    return out


def _f32_product_bound(flops, nbytes, passes=3):
    """(least ms, what bounds it, the f32 SIMT bound in ms) of a product
    of f32 operands: on the card's tensor cores as ``passes`` bf16
    products, or at the HBM rate.  Two f32 operands take three (hi . hi,
    hi . lo, lo . hi: the split that keeps ~2^-16 relative error, like the
    JAX package's Precision.HIGH); an operand stored in bf16 has a lo part
    of exactly zero, so two.  Beside it the old bound, the same flops at
    the f32 SIMT peak."""
    t_ops = passes * flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            max(flops / PEAK_F32_FLOPS, t_bytes) * 1e3)


def _bound(ops, peak, nbytes):
    """(least ms, what bounds it) for ``ops`` at ``peak`` and ``nbytes``
    at the HBM rate."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _attention_bound(b, length, h, d, causal, l_valid, f32=False):
    """q, k, v read once and the output written once; the products of
    the score pairs this input keeps (causal: key <= query; keys < l_valid)
    in q.k and p.v: bf16 at the bf16 tensor-core peak; f32 (4-byte
    elements) as three TF32 passes at the TF32 peak, the route the f32
    kernel at head_dim 64 takes."""
    rows = range(length)
    pairs = sum(min(r + 1, l_valid) if causal else l_valid for r in rows)
    ops = 4.0 * b * h * d * pairs
    if f32:
        return _bound(3 * ops, PEAK_TF32_FLOPS, 16.0 * b * length * h * d)
    return _bound(ops, PEAK_BF16_FLOPS, 8.0 * b * length * h * d)


def time_attention_bwd(gen, against=None):
    """The gradient kernel at a training step's shapes (B 256: L 197; L 208
    with l_valid 197, under --int8_frozen; L 257, image 256): kernel, plain
    version, the backward of ``F.scaled_dot_product_attention`` by autograd
    (timed here, called nowhere in the port) and the bound
    (``testing/attention_bwd.py::time_shapes``), with ``against`` (an
    ``attention_bwd.cu``, e.g. the parent commit's) built and timed beside
    in turns."""
    from scd_tpu_torch.testing import attention_bwd as T

    other = T.build_other(against) if against else None
    if other is None:
        print("  attention_bwd: no other build given (--against-bwd)")
    times = T.time_shapes(gen, other)
    out = {f"attention_bwd-{tag}": v[:5] for tag, v in times.items()}
    out["attention_bwd"] = out.pop("attention_bwd-train")
    return out


# the f32 attention's timed shapes (ViT-B/16, H 12, d 64, every block
# trainable): (batch, L, tag): UNO's 64 images x 2 views, AutoNovel's
# passes of 64, UNO at image 256
F32_TIMED = ((128, 197, "uno"), (64, 197, "autonovel"),
             (128, 257, "image-256"))


def time_attention_f32(gen, against_fwd=None, against_bwd=None):
    """The end-to-end baselines' f32 attention on the f32 kernels at
    head_dim 64 (three TF32 passes on ``wgmma`` fed by TMA), at
    F32_TIMED: the forward through the packed entry, as a trunk block
    calls it, and the gradient (``testing/attention_bwd.py::time_shapes``),
    each beside its plain version, SDPA (a yardstick, used nowhere in the
    port), the bound (4-byte elements, three TF32 passes at the TF32 peak)
    and, with ``against_fwd`` / ``against_bwd`` (an ``attention.cu`` /
    ``attention_bwd.cu``, e.g. the parent commit's SIMT build), that build
    timed in turns, other, this, this, other, on the same inputs.  Returns
    the rows of the kernels line (UNO's shape) and the other shapes'."""
    import torch
    import torch.nn.functional as F

    from scd_tpu_torch.ops import attention as A
    from scd_tpu_torch.testing import attention_bwd as T
    from scd_tpu_torch.testing.attention_long import build_other

    h, f32, out = 12, torch.float32, {}
    other_fwd = build_other(against_fwd) if against_fwd else None
    other_bwd = T.build_other(against_bwd) if against_bwd else None
    for b, length, tag in F32_TIMED:
        qkv, (q, k, v) = _attn_inputs(b, length, h, 64, f32, True, gen)
        attention_parity(b, length, h, 64, f32, gen, packed=True,
                         tag=f"f32 {tag} timed inputs",
                         inputs=(qkv, (q, k, v)))

        def kern():
            return A.qkv_attention(qkv, h, 0.125)

        line = f"  attention f32 ({tag}) B={b} L={length} H={h} d=64:"
        if other_fwd is not None:
            def then():
                return A.attention_fwd(other_fwd, q, k, v, 0.125, False,
                                       length)

            diff = (then() - kern().view(b, length, h, 64)).abs().max()
            t_other = cuda_ms(then, reps=10, warmup=2)
            ms = cuda_ms(kern, reps=10, warmup=2)
            again = cuda_ms(kern, reps=10, warmup=2)
            t_other2 = cuda_ms(then, reps=10, warmup=2)
            line += (f" kernel {ms:.4f} ms (again {again:.4f}), other build "
                     f"{t_other:.4f} ms (again {t_other2:.4f}), max |kernel"
                     f" - other| {diff.item():.3e};")
        else:
            ms = cuda_ms(kern, reps=10, warmup=2)
            again = cuda_ms(kern, reps=10, warmup=2)
            line += f" kernel {ms:.4f} ms (again {again:.4f});"
        plain = cuda_ms(lambda: A.attention_plain(q, k, v, 0.125), reps=3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt),
                      reps=10, warmup=2)
        bound, by = _attention_bound(b, length, h, 64, False, length, True)
        print(f"{line} plain {plain:.4f} ms, library (SDPA) {lib:.4f} ms, "
              f"bound {bound:.4f} ms ({by}); {ms / bound:.1f} x the bound, "
              f"{ms / lib:.2f} x SDPA", flush=True)
        del qkv, q, k, v, qt, kt, vt
        out[f"qkv_attention_f32-{tag}"] = (ms, plain, lib, bound, by)
        times = T.time_shapes(gen, other_bwd, ((f"f32-{tag}", length,
                                                length),), b=b, dtype=f32)
        out[f"attention_bwd_f32-{tag}"] = times[f"f32-{tag}"][:5]
    out["qkv_attention_f32"] = out["qkv_attention_f32-uno"]
    out["attention_bwd_f32"] = out["attention_bwd_f32-uno"]
    return out


def time_attention_estep(gen):
    """The attention kernel through both entry points at the image
    towers' shape and the qkv entry at the text tower's, and the estep
    kernel at the k-means runner's shape: kernel, plain version, the
    library call (``F.scaled_dot_product_attention``; cuBLAS ``matmul`` +
    ``min``), timed here and used nowhere in the port."""
    import torch
    import torch.nn.functional as F

    from scd_tpu_torch.ops import attention as A
    from scd_tpu_torch.ops.distance import estep_assign, estep_assign_plain

    bf16, out = torch.bfloat16, {}
    for tag, key, b, length, h, causal, packed in (
            ("image", "vit_attention", BATCH, L_VIT, 12, False, False),
            ("image", "qkv_attention", BATCH, L_VIT, 12, False, True),
            ("text", "qkv_attention-text", TEXT_BATCH, 77, 8, True, True),
            ("text-L16", "qkv_attention-text16", TEXT_BATCH, 16, 8, True,
             True),
            ("text-L32", "qkv_attention-text32", TEXT_BATCH, 32, 8, True,
             True),
            ("image-256 (long path)", "qkv_attention-long", BATCH, L_257, 12,
             False, True),
            ("image-288 (long path)", "qkv_attention-long325", BATCH, 325,
             12, False, True),
            ("image-384 (long path)", "qkv_attention-long577", BATCH, 577,
             12, False, True)):
        qkv, (q, k, v) = _attn_inputs(b, length, h, 64, bf16, packed, gen)
        if packed:
            def kern():
                return A.qkv_attention(qkv, h, 0.125, causal)
        else:
            def kern():
                return A.vit_attention(q, k, v, 0.125, causal)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, L, d]
        if key.startswith("qkv_attention-long"):  # phase 2 has B 3 only
            attention_parity(b, length, h, 64, bf16, gen, causal=causal,
                             packed=packed, tag=f"{tag} timed inputs",
                             inputs=(qkv, (q, k, v)))
        ms = cuda_ms(kern, reps=20, warmup=2)
        ms_again = cuda_ms(kern, reps=20, warmup=2)
        plain = cuda_ms(lambda: A.attention_plain(q, k, v, 0.125, causal),
                        reps=3)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), reps=20, warmup=2)
        bound, by = _attention_bound(b, length, h, 64, causal, length)
        print(f"  attention {key.split('-')[0]} {tag} B={b} L={length} H={h} "
              f"d=64 causal={causal}: kernel {ms:.4f} ms (again "
              f"{ms_again:.4f}), plain {plain:.4f} ms, library (SDPA) "
              f"{lib:.4f} ms, bound {bound:.4f} ms ({by})")
        out[key] = (ms, plain, lib, bound, by)
        if key == "qkv_attention":  # the host's share: tensor maps, launch
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                kern()
            host_us = (time.perf_counter() - t0) / 50 * 1e6
            torch.cuda.synchronize()
            print(f"  attention host time per call (three tensor maps "
                  f"encoded, launch, wrapper): {host_us:.1f} us")
        del qkv, q, k, v, qt, kt, vt

    n, d, k = RUNNER_N, D_FEAT, K
    x, c = em_inputs(n, d, k, gen)

    def library():
        d2 = (c * c).sum(1)[None, :] - 2.0 * torch.matmul(x, c.t())
        return torch.min(d2, dim=1)

    ms = cuda_ms(lambda: estep_assign(x, c), reps=20, warmup=2)
    plain = cuda_ms(lambda: estep_assign_plain(x, c), reps=5)
    lib = cuda_ms(library, reps=20, warmup=2)
    bound, by, simt = _f32_product_bound(2.0 * n * k * d + n * d + k * d,
                                         4.0 * (n * d + k * d) + 8.0 * n)
    print(f"  estep_assign N={n} D={d} K={k} f32: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, library (matmul + min) {lib:.4f} ms, bound "
          f"{bound:.4f} ms ({by}; f32 SIMT bound {simt:.4f} ms)")
    out["estep_assign"] = (ms, plain, lib, bound, by)
    return out


def phase_timing(seed: int, estep, against_bwd=None, against_fwd=None):
    import torch

    from scd_tpu_torch.ops.em import em_iteration_plain, fused_em_step_cuda
    from scd_tpu_torch.ops.topk import classify_topk_plain, topk_softmax_cuda

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    n_u = N_IMAGES - 32_512
    f = _unit(torch.randn(n_u, D_CLIP, generator=gen, device="cuda"), 1)
    w = _unit(torch.randn(D_CLIP, VOCAB, generator=gen, device="cuda"), 0)

    def topk_library():
        for lo in range(0, n_u, 8192):
            logits = 100.0 * torch.matmul(f[lo:lo + 8192], w)
            torch.topk(logits, TOPK, dim=1)
            torch.logsumexp(logits, dim=1)

    t_topk = cuda_ms(lambda: topk_softmax_cuda(f, w, TOPK), reps=3)
    t_again = cuda_ms(lambda: topk_softmax_cuda(f, w, TOPK), reps=3)
    t_topk_plain = cuda_ms(
        lambda: classify_topk_plain(f, w, TOPK, 100.0), reps=1)
    t_topk_lib = cuda_ms(topk_library, reps=3)
    flops = 2.0 * n_u * D_CLIP * VOCAB
    nbytes = 4.0 * (n_u * D_CLIP + D_CLIP * VOCAB) + n_u * (8 + 8 * TOPK)
    topk_bound, topk_by, topk_simt = _f32_product_bound(flops, nbytes)
    print(f"  topk_softmax N={n_u} D={D_CLIP} V={VOCAB} k={TOPK}: kernel "
          f"{t_topk:.3f} ms (again {t_again:.3f}), plain {t_topk_plain:.3f} "
          f"ms, library {t_topk_lib:.3f} ms, bound {topk_bound:.3f} ms "
          f"({topk_by}, split bf16 on the tensor cores; f32 SIMT bound "
          f"{topk_simt:.3f} ms); {3 * flops / (t_topk * 1e-3) / 1e12:.1f} "
          f"TFLOP/s of bf16 products")
    # the ptsup lower-bound pass: k 1 over raw logits
    t_k1 = cuda_ms(lambda: topk_softmax_cuda(f, w, 1), reps=3)
    t_k1_plain = cuda_ms(lambda: classify_topk_plain(
        f, w, 1, 100.0, apply_softmax=False), reps=1)

    def k1_library():
        for lo in range(0, n_u, 8192):
            torch.max(torch.matmul(f[lo:lo + 8192], w), dim=1)

    t_k1_lib = cuda_ms(k1_library, reps=3)
    k1_bound, k1_by, _ = _f32_product_bound(
        flops, 4.0 * (n_u * D_CLIP + D_CLIP * VOCAB) + n_u * 16)
    print(f"  topk_softmax N={n_u} D={D_CLIP} V={VOCAB} k=1 (ptsup bound "
          f"pass): kernel {t_k1:.3f} ms, plain {t_k1_plain:.3f} ms, library "
          f"(matmul + max) {t_k1_lib:.3f} ms, bound {k1_bound:.3f} ms "
          f"({k1_by})")
    del f, w

    x, c = em_inputs(n_u, D_FEAT, K, gen)

    def em_library():
        cross = torch.matmul(x, c.t())
        d2 = (c * c).sum(1)[None, :] - 2.0 * cross
        lab = torch.argmin(d2, dim=1)
        sums = torch.zeros(K, D_FEAT, device="cuda").index_add_(0, lab, x)
        return lab, sums

    t_em_lib = cuda_ms(em_library, reps=20)
    em_times = {}
    for x_bf16 in (True, False):  # both modes; the row takes the main path's
        xk = x.to(torch.bfloat16) if x_bf16 else x
        t_em = cuda_ms(lambda: fused_em_step_cuda(xk, c), reps=50, warmup=3)
        t_again = cuda_ms(lambda: fused_em_step_cuda(xk, c), reps=50,
                          warmup=3)
        t_em_plain = cuda_ms(lambda: em_iteration_plain(xk, c, K), reps=20)
        x_bytes = 2 if x_bf16 else 4
        em_flops = 2.0 * n_u * K * D_FEAT + n_u * D_FEAT
        em_bytes = (x_bytes * n_u * D_FEAT + 4.0 * K * D_FEAT + 4.0 * n_u
                    + 4.0 * (K * D_FEAT + K + 1))
        # x in bf16: its lo part is zero, so two passes (x . c_hi, x .
        # c_lo) instead of three, as the TPU kernel counts them; the
        # M-step's N . D sums (1 / 2K of the flops) are counted at the same
        # number of passes
        em_bound, em_by, em_simt = _f32_product_bound(
            em_flops, em_bytes, passes=2 if x_bf16 else 3)
        print(f"  fused_em_step N={n_u} D={D_FEAT} K={K} x_bf16={x_bf16}"
              f"{' (the main path)' if x_bf16 == bool(estep[1]) else ''}: "
              f"kernel {t_em:.4f} ms (again {t_again:.4f}), plain "
              f"{t_em_plain:.4f} ms, library (f32 matmul + argmin + "
              f"index_add_) {t_em_lib:.4f} ms, bound {em_bound:.4f} ms "
              f"({em_by}; f32 SIMT bound {em_simt:.4f} ms)")
        em_times[x_bf16] = (t_em, t_em_plain, t_em_lib, em_bound, em_by)
        del xk
    return {
        "topk_softmax": (t_topk, t_topk_plain, t_topk_lib, topk_bound,
                         topk_by),
        "fused_em_step": em_times[bool(estep[1])],
        **time_w8a8(gen),
        **time_attention_estep(gen),
        **time_attention_bwd(gen, against_bwd),
        **time_attention_f32(gen, against_fwd, against_bwd),
    }


# ------------------------------------------------------------- phase 6

def serving_images(seed: int, n: int):
    """[n, 224, 224, 3] uint8 made in bulk from ``seed``: image i shows the
    colour of class i % SERVE_NAMES plus noise of its own.  Returns
    (images, class colours [SERVE_NAMES, 3])."""
    import numpy as np

    rng = np.random.default_rng([seed, 6])
    colors = rng.integers(32, 224, (SERVE_NAMES, 3))
    out = np.empty((n, 224, 224, 3), np.uint8)
    for lo in range(0, n, 500):
        hi = min(n, lo + 500)
        noise = rng.integers(-12, 13, (hi - lo, 224, 224, 3), dtype=np.int16)
        cls = colors[np.arange(lo, hi) % SERVE_NAMES]
        out[lo:hi] = (cls[:, None, None, :] + noise).astype(np.uint8)
    return out, colors


def phase_serving(seed: int, workdir: str):
    """The serving entry point (``pipelines/infer.py``) at full CLIP
    ViT-B/16 width, bf16: SERVE_IMAGES images in batches of BATCH, named
    from SERVE_NAMES zero-shot columns, top-SERVE_TOPK."""
    import numpy as np
    import torch

    from scd_tpu_torch.models import clip_vit_b16_config
    from scd_tpu_torch.pipelines import infer

    t0 = time.perf_counter()
    images, colors = serving_images(seed, SERVE_IMAGES)
    img_path = os.path.join(workdir, "images.npy")
    np.save(img_path, images)
    # the names' columns: the tower's features of each class's plain colour
    cfg = clip_vit_b16_config(compute_dtype=torch.bfloat16)
    enc = infer.build_clip_encoder(
        infer._load_clip_variables("random", cfg), cfg, device="cuda")
    protos = np.broadcast_to(colors[:, None, None, :].astype(np.uint8),
                             (SERVE_NAMES, 224, 224, 3))
    zw = enc(np.ascontiguousarray(protos)).float()
    zw = (zw / zw.norm(dim=-1, keepdim=True)).t().contiguous().cpu().numpy()
    zw_path = os.path.join(workdir, "zw.npy")
    np.save(zw_path, zw)
    names = [f"class_{i:03d}" for i in range(SERVE_NAMES)]
    names_path = os.path.join(workdir, "names.txt")
    with open(names_path, "w") as f:
        f.write("\n".join(names) + "\n")
    card8 = enc(images[:BATCH])[:8].float().cpu()
    # one batch at image 256 (L 257: the attention long path), on the card
    near = np.arange(IMAGE_LONG) * 224 // IMAGE_LONG  # nearest-pixel resize
    big = np.ascontiguousarray(images[:BATCH][:, near][:, :, near])
    _reset_counts()
    card8_256 = enc(big)[:8].float().cpu()
    torch.cuda.synchronize()
    long_counts = _counts()
    check(long_counts["attention_long"] == cfg.vision.depth
          and long_counts["attention_long_wgmma"] == cfg.vision.depth
          and long_counts["attention"] == cfg.vision.depth,
          f"image {IMAGE_LONG}: attention launches {long_counts}")
    t_224 = cuda_ms(lambda: enc(images[:BATCH]), reps=3)
    t_256 = cuda_ms(lambda: enc(big), reps=3)
    print(f"CLIP ViT-B/16 bf16, one batch of {BATCH}: {t_224:.2f} ms at 224 "
          f"px (L {L_VIT}), {t_256:.2f} ms at {IMAGE_LONG} px (L {L_257}, "
          f"attention's wgmma long path: "
          f"{long_counts['attention_long_wgmma']} launches)")
    del enc
    print(f"fabricated {SERVE_IMAGES} images 224x224x3 uint8, {SERVE_NAMES} "
          f"names' columns in {time.perf_counter() - t0:.1f} s")

    # main returns the count, as the JAX package's does; the per-batch
    # seconds are what its serve_images returns
    served, serve = [], infer.serve_images

    def record(*a, **kw):
        served.append(serve(*a, **kw))
        return served[-1]

    _reset_counts()
    infer.serve_images = record
    t0 = time.perf_counter()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            count = infer.main([
                "--dataset_name", "real", "--clip_weights", "random",
                "--zeroshot_weights", zw_path, "--names", names_path,
                "--images", img_path, "--batch_size", str(BATCH),
                "--topk", str(SERVE_TOPK)])
    finally:
        infer.serve_images = serve
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    check(isinstance(count, int) and len(served) == 1
          and served[0][0] == count, f"infer.main returned {count!r}")
    batch_seconds = served[0][1]
    lines = buf.getvalue().splitlines()
    n_batches = -(-SERVE_IMAGES // BATCH)
    print(f"launches in infer: {launches}")
    check(launches["attention"] == n_batches * cfg.vision.depth,
          f"attention launches {launches['attention']} != {n_batches} "
          f"batches x {cfg.vision.depth} blocks")
    check(count == SERVE_IMAGES and len(lines) == SERVE_IMAGES,
          f"served {count} images, {len(lines)} lines")
    top1 = [ast.literal_eval(ln.split("\t")[0])[0] for ln in lines]
    probs = np.array([ast.literal_eval(ln.split("\t")[1]) for ln in lines])
    check(probs.shape == (SERVE_IMAGES, SERVE_TOPK)
          and bool(np.isfinite(probs).all()) and bool((probs >= 0).all()),
          "served probabilities: wrong shape or not finite")
    acc = np.mean([t == names[i % SERVE_NAMES] for i, t in enumerate(top1)])
    ms = np.array(batch_seconds) * 1e3
    print(f"served {count} images in {wall:.3f} s (set-up "
          f"included): {count / (ms.sum() / 1e3):.1f} images/s over "
          f"the batches, per batch of {BATCH} p50 {np.percentile(ms, 50):.2f}"
          f" ms, p99 {np.percentile(ms, 99):.2f} ms (first "
          f"{ms[0]:.2f} ms); top-1 = the image's colour class "
          f"{acc:.4f} (random weights: no floor)")

    # ---- the card's tower against the CPU's plain tower (f32) on 8 images
    t0 = time.perf_counter()
    cpu_cfg = clip_vit_b16_config(compute_dtype=torch.float32)
    cpu_enc = infer.build_clip_encoder(
        infer._load_clip_variables("random", cpu_cfg), cpu_cfg,
        device="cpu")
    cpu8 = cpu_enc(images[:8]).float()
    cos = _row_cos(card8, cpu8)
    cos_256 = _row_cos(card8_256, cpu_enc(big[:8]).float()).min().item()
    print(f"card (bf16) vs CPU (f32) CLIP image tower at {IMAGE_LONG} px on 8"
          f" images: min cosine {cos_256:.6f} (tolerance {TOWER_COS_TOL})")
    check(cos_256 >= TOWER_COS_TOL,
          f"image {IMAGE_LONG}: the card's tower disagrees with the CPU")
    fc = cpu8 / cpu8.norm(dim=-1, keepdim=True)
    fk = card8 / card8.norm(dim=-1, keepdim=True)
    cpu_top = [names[j] for j in (fc @ torch.from_numpy(zw)).argmax(1)]
    band = 2.0 * 100.0 * (fc - fk).norm(dim=-1)  # the most a logit moves
    flips = 0
    for i in range(8):
        if cpu_top[i] != top1[i]:
            flips += 1
            cols = [names.index(cpu_top[i]), names.index(top1[i])]
            gap = 100.0 * (fc[i] @ torch.from_numpy(zw[:, cols])).diff().abs()
            check(gap.item() <= band[i].item(), f"serving image {i}: top-1 "
                  f"{top1[i]} on the card, {cpu_top[i]} on the CPU, "
                  f"beyond the rounding band")
    print(f"card (bf16) vs CPU (f32) CLIP image tower on 8 images: min cosine"
          f" {cos.min().item():.6f} (tolerance {TOWER_COS_TOL}); top-1 names "
          f"equal on {8 - flips} of 8 ({time.perf_counter() - t0:.1f} s on "
          f"the CPU)")
    check(cos.min().item() >= TOWER_COS_TOL,
          "serving: the card's tower disagrees with the CPU")
    check(flips == 0, "serving: top-1 names differ between card and CPU")

    # ---- the synthetic CLI (a bound-method encoder) runs its head on the
    # card: the head's device is the one asked for, not the encoder's
    seen, head = [], infer.NameClassifier._head

    def spy(self, feats, k):
        seen.append(feats.device.type)
        return head(self, feats, k)

    infer.NameClassifier._head = spy
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            syn = infer.main(["--dataset_name", "synthetic", "--topk", "3"])
    finally:
        infer.NameClassifier._head = head
    check(seen == ["cuda"], f"synthetic serving head ran on {seen}")
    print(f"synthetic serving (default --device cuda): head on {seen[0]}, "
          f"top-3 accuracy {syn}")
    return {"attention": launches["attention"]}


# ------------------------------------------------------------- phase 7

def write_features_packed(seed: int, path: str, n: int = None) -> str:
    """Fabricated, L2-normalised ImageNet-100-scale features in the
    runners' and ``estimate_k``'s ``features_packed.npz`` layout: ``n``
    rows (RUNNER_N when None), 768-d, 100 classes, the first 50 old, half
    their rows labelled (``prop_train_labels`` 0.5)."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    n = RUNNER_N if n is None else n
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    cls = 3.0 * torch.randn(K, D_FEAT, generator=g, device="cuda")
    targets = torch.randint(0, K, (n,), generator=g, device="cuda")
    x = _unit(cls[targets] + 0.5 * torch.randn(n, D_FEAT, generator=g,
                                               device="cuda"), 1)
    lab = (targets < K // 2) & (torch.rand(n, generator=g,
                                           device="cuda") < 0.5)
    np.savez(path, features=x.cpu().numpy(), targets=targets.cpu().numpy(),
             mask_lab=lab.cpu().numpy())
    print(f"fabricated N={n} D={D_FEAT} features of {K} classes in "
          f"{time.perf_counter() - t0:.1f} s")
    return path


def phase_runners(seed: int, workdir: str):
    """The k-means runner's upper bound (``cluster/runners.py main
    --optimal``) on :func:`write_features_packed`'s features."""
    from scd_tpu_torch.cluster import runners

    path = write_features_packed(seed, os.path.join(workdir,
                                                    "features_packed.npz"))
    argv = ["--features", path, "--n_train_classes", str(K // 2),
            "--optimal"]
    out = {}
    for dev in ("cuda", "cpu"):
        _reset_counts()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            runners.main(argv + ["--device", dev])
        out[dev] = (buf.getvalue().splitlines(), _counts(),
                    time.perf_counter() - t0)
    lines, launches, wall = out["cuda"]
    for ln in lines:
        print("  " + ln)
    print(f"launches in runners --optimal: {launches}; {wall:.3f} s on the "
          f"card, {out['cpu'][2]:.3f} s on the CPU (plain versions)")
    check(launches["estep_assign"] >= 1, "estep_assign never launched")
    check(len(lines) == 3 and lines == out["cpu"][0],
          "runners: the card's ACC lines differ from the CPU's")
    return {"estep_assign": launches["estep_assign"]}


# ------------------------------------------------------------- phase 8

# ConSSKM's size bounds: the config's defaults (the reference's
# main_unsup.py:219-220) at ImageNet-100 scale; on the small root, bounds
# its ~3,000 unlabelled rows over 100 clusters can meet
SIZE_MIN, SIZE_MAX, SMALL_SIZE_MIN, SMALL_SIZE_MAX = 50, 1_200, 5, 100
MCF_ROWS = (N_IMAGES - 32_512) // 4  # the MCF track's unlabelled rows
# the ptsup commands of scripts/smoke_all.sh (ConSSKM) and
# scripts/evaluate_partial_supervised.sh (SSKM), asset-free
SMOKE_PTSUP = ["--dataset_name", "synthetic", "--cluster", "ConSSKM",
               "--n_cluster", "10", "--cluster_size_min", "5",
               "--cluster_size_max", "50"]


def _ptsup(cfg, device):
    """``run_ptsup`` on ``device``: (result, printed lines, seconds)."""
    from scd_tpu_torch.pipelines.ptsup import run_ptsup

    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = run_ptsup(cfg, device=device)
    return res, buf.getvalue().splitlines(), time.perf_counter() - t0


def _unlab_sizes(cfg):
    """Cluster sizes of the unlabelled rows in ``cfg``'s cluster cache."""
    import numpy as np

    from scd_tpu_torch.pipelines.common import cluster_cache_key, stage_cache

    u_preds = stage_cache(cfg).load("cluster", cluster_cache_key(cfg))[
        "u_preds"]
    return np.bincount(u_preds, minlength=cfg.cluster.n_clusters)


def _constrained_counts():
    from scd_tpu_torch.cluster.constrained import fit_constrained
    from scd_tpu_torch.ops.sinkhorn import sinkhorn_constrained_assign as sk

    return {"fallbacks": fit_constrained.mcf_fallbacks,
            "mcf_seconds": list(fit_constrained.mcf_seconds),
            "mcf_iterations": fit_constrained.mcf_iterations,
            "sinkhorn_calls": sk.calls,
            "dual_iterations": sk.dual_iterations,
            "repair_passes": sk.repair_passes}


def _reset_constrained():
    from scd_tpu_torch.cluster import constrained
    from scd_tpu_torch.ops.sinkhorn import sinkhorn_constrained_assign as sk

    constrained.reset_counters()
    sk.calls = sk.dual_iterations = sk.repair_passes = 0


def ptsup_warm(cfg):
    """The warm ptsup run (SSKM) on the ImageNet-100-scale root, with the
    launch counts of its run."""
    _reset_counts()
    res, lines, wall = _ptsup(cfg, "cuda")
    counts = _counts()
    launches = {k: counts[k] for k in ("topk_softmax", "fused_em_step")}
    keep = ("=====", "sACC all", "Soft sACC all", "clip ACC:",
            "SSKM Accuracies:")
    for ln in lines:
        if ln.startswith(keep):
            print("  " + ln)
    hist = res["voting"].history
    check(hist, "ptsup: the voting loop ran no round")
    print(f"  final vote (iter {res['voting'].n_iters}): ACC "
          f"{hist[-1]['all_acc']}, IoU {res['iou']}")
    print("stage seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["stage_seconds"].items())
        + f" | run_ptsup {wall:.3f} s")
    print(f"launches in run_ptsup: {launches}")
    # 12 chunks of 8,192 rows in each bound pass, then topk_names
    check(launches["topk_softmax"] >= 25 and launches["fused_em_step"] > 0,
          f"ptsup: a kernel of the path launched too rarely: {launches}")
    acc, vote_acc = res["cluster_acc"][0], hist[-1]["all_acc"]
    check(acc >= ACC_FLOOR and vote_acc >= ACC_FLOOR,
          f"ptsup: ACC {acc} / voted ACC {vote_acc} below {ACC_FLOOR}")
    check(res["iou"] >= IOU_FLOOR, f"ptsup: IoU {res['iou']} below "
          f"{IOU_FLOOR}")
    return launches


def ptsup_consskm(cfg, device, size_min, size_max):
    """ptsup with ConSSKM on the Sinkhorn track: every unlabelled cluster
    size within the bounds.  Returns (result, lines, counts, sizes)."""
    import dataclasses

    cfg = dataclasses.replace(
        cfg, run_cluster=True, cluster=dataclasses.replace(
            cfg.cluster, algorithm="ConSSKM", size_min=size_min,
            size_max=size_max, constrained_backend="sinkhorn"))
    _reset_constrained()
    res, lines, _wall = _ptsup(cfg, device)
    counts = _constrained_counts()
    sizes = _unlab_sizes(cfg)
    check(sizes.min() >= size_min and sizes.max() <= size_max,
          f"ConSSKM sizes [{sizes.min()}, {sizes.max()}] outside "
          f"[{size_min}, {size_max}]")
    return res, lines, counts, sizes


def sinkhorn_estep_profile(cfg, size_min, size_max):
    """One Sinkhorn E-step at the phase's shape (the root's unlabelled
    clustering features against K of their rows as centers): host-clock
    ms, and the card's busy ms from ``torch.profiler`` (the sum of its
    kernels' device time), so the idle share.  Returns (wall ms, busy ms
    or None when the profiler saw no device time, dual iterations, the
    four kernels of most device time as (name, ms, launches))."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from scd_tpu_torch.ops.distance import pairwise_sqdist
    from scd_tpu_torch.ops.sinkhorn import sinkhorn_constrained_assign as sk
    from scd_tpu_torch.pipelines.common import feature_cache_key, stage_cache

    feats = stage_cache(cfg).load("features", feature_cache_key(cfg, "feat"))
    u = torch.as_tensor(feats["all_feats"][~feats["mask_lab"].astype(bool)],
                        device="cuda")
    k = cfg.cluster.n_clusters
    pick = np.linspace(0, len(u) - 1, k).round().astype(np.int64)
    cost = torch.sqrt(pairwise_sqdist(u, u[torch.as_tensor(pick,
                                                           device="cuda")]))

    def estep():
        return sk(cost, k, size_min, size_max, eps=cfg.cluster.sinkhorn_epsilon,
                  iters=cfg.cluster.sinkhorn_iters)

    estep()
    torch.cuda.synchronize()
    before = sk.dual_iterations
    t0 = time.perf_counter()
    estep()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    iters = sk.dual_iterations - before
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        estep()
        torch.cuda.synchronize()
    # the kernels' own events (an operator's total would count them again)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = [(e.key[:60], e.self_device_time_total / 1e3, e.count)
           for e in kernels[:4]]
    return wall, (busy or None), iters, top


def mcf_full_width(cfg, device, size_min, size_max, n_init=1, max_iter=1,
                   rows=None):
    """``fit_constrained`` on the exact track over the root's clustering
    features (the first ``rows`` unlabelled rows, all when None; the
    labelled ones pinned).  Returns (result, counts, seconds)."""
    import numpy as np

    from scd_tpu_torch.cluster.constrained import fit_constrained
    from scd_tpu_torch.core.config import ClusterConfig
    from scd_tpu_torch.pipelines.common import feature_cache_key, stage_cache

    feats = stage_cache(cfg).load("features", feature_cache_key(cfg, "feat"))
    lab = feats["mask_lab"].astype(bool)
    x, t = feats["all_feats"], feats["targets"].astype(np.int64)
    ccfg = ClusterConfig(n_clusters=cfg.cluster.n_clusters, n_init=n_init,
                         max_iterations=max_iter, size_min=size_min,
                         size_max=size_max, constrained_backend="mcf")
    _reset_constrained()
    t0 = time.perf_counter()
    res = fit_constrained(x[~lab][:rows], x[lab], t[lab], ccfg,
                          device=device)
    wall = time.perf_counter() - t0
    sizes = np.bincount(res.labels[int(lab.sum()):],
                        minlength=ccfg.n_clusters)
    check(sizes.min() >= size_min and sizes.max() <= size_max,
          f"MCF sizes [{sizes.min()}, {sizes.max()}] outside "
          f"[{size_min}, {size_max}]")
    return res, _constrained_counts(), wall


def mcf_card_against_cpu(seed, n=4_000, d=64, k=20):
    """The exact track from one set of injected centers on the card and on
    the CPU.  The two f32 products differ in their last bits, so a cost
    near a half-integer can round the other way: at most 1 apart, on at
    most 0.1% of entries.  Labels equal on >= 99.5% of rows, inertia
    within 1e-4 relative; one int32 cost matrix gives the solver's labels
    bit for bit."""
    import numpy as np
    import torch

    from scd_tpu_torch.cluster import constrained as C
    from scd_tpu_torch.core.config import ClusterConfig
    from scd_tpu_torch.ops.distance import pairwise_sqdist
    from scd_tpu_torch.ops.native import constrained_assign

    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, n)
    x = (2.0 * rng.standard_normal((k, d)))[y] + rng.standard_normal((n, d))
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    centers = x[rng.choice(n, k, replace=False)]
    costs = {dev: C._costs(pairwise_sqdist(
        torch.as_tensor(x, device=dev), torch.as_tensor(centers, device=dev)
    )).cpu().numpy() for dev in ("cuda", "cpu")}
    diff = np.abs(costs["cuda"].astype(np.int64) - costs["cpu"])
    check(diff.max() <= 1 and (diff > 0).mean() <= 1e-3,
          f"MCF costs: card and CPU differ by up to {diff.max()} on "
          f"{(diff > 0).mean():.2e} of entries")
    lab_a = constrained_assign(costs["cuda"], 100, 300)
    lab_b = constrained_assign(costs["cuda"].copy(), 100, 300)
    check(np.array_equal(lab_a, lab_b), "MCF: one cost matrix, two labels")
    cfg = ClusterConfig(n_clusters=k, n_init=1, max_iterations=5,
                        size_min=100, size_max=300, constrained_backend="mcf")
    real = C._seed_centers
    C._seed_centers = lambda u, *a, **kw: torch.as_tensor(centers,
                                                          device=u.device)
    try:
        res = {dev: C.fit_constrained_unsup(x, cfg, device=dev)
               for dev in ("cuda", "cpu")}
    finally:
        C._seed_centers = real
    same = (res["cuda"].labels == res["cpu"].labels).mean()
    rel = abs(res["cuda"].inertia - res["cpu"].inertia) / res["cpu"].inertia
    print(f"  MCF track N={n} D={d} K={k}, card against CPU from one set of "
          f"centers: {int((diff > 0).sum())} of {diff.size} rounded costs "
          f"differ (by at most {diff.max()}); labels equal on {same:.4%} of "
          f"rows; inertia rel diff {rel:.2e}; iterations "
          f"{res['cuda'].n_iter} / {res['cpu'].n_iter}")
    check(same >= 0.995 and rel <= 1e-4,
          "MCF track: the card and the CPU disagree")


def ptsup_small_root(seed, workdir, device="cuda"):
    """A small root clustered on ``device`` with SSKM, ConSSKM (Sinkhorn)
    and FINCH; each re-entered from that cache on ``device`` and on the
    CPU prints the same lines.  Returns the lines' count per algorithm."""
    import dataclasses

    from scd_tpu_torch.testing.fabricate import (fabricate_imagenet100,
                                                 imagenet100_config)

    base = dataclasses.replace(
        imagenet100_config(os.path.join(workdir, "small_ptsup"), n_init=2,
                           max_iterations=5), partially_supervised=True)
    fabricate_imagenet100(base, seed=seed, device=device, n_images=4_000,
                          d_feat=64, d_clip=32, vocab=3_000, n_genus=20)
    out = {}
    for alg in ("SSKM", "ConSSKM", "FINCH"):
        cfg = dataclasses.replace(base, cluster=dataclasses.replace(
            base.cluster, algorithm=alg, size_min=SMALL_SIZE_MIN,
            size_max=SMALL_SIZE_MAX))
        _ptsup(cfg, device)
        if alg == "ConSSKM":
            sizes = _unlab_sizes(cfg)
            check(sizes.min() >= SMALL_SIZE_MIN
                  and sizes.max() <= SMALL_SIZE_MAX,
                  f"small root ConSSKM sizes [{sizes.min()}, {sizes.max()}]")
        cached = dataclasses.replace(cfg, run_cluster=False)
        lines = {dev: _ptsup(cached, dev)[1] for dev in (device, "cpu")}
        check(lines[device] == lines["cpu"] and len(lines["cpu"]) > 12,
              f"small root {alg}: card and CPU ptsup lines differ")
        out[alg] = len(lines["cpu"])
    return out


def phase_ptsup(seed: int, cfg, workdir: str):
    """Phase 8: the partially supervised path (see the module
    docstring).  ``cfg`` is phase 3's ImageNet-100-scale root."""
    import dataclasses

    import numpy as np

    from scd_tpu_torch.pipelines.ptsup import main as ptsup_main

    cfg = dataclasses.replace(cfg, partially_supervised=True,
                              run_cluster=True)
    t0 = time.perf_counter()
    launches = ptsup_warm(cfg)
    print(f"warm ptsup (SSKM) {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    res, lines, counts, sizes = ptsup_consskm(cfg, "cuda", SIZE_MIN,
                                              SIZE_MAX)
    secs = res["stage_seconds"]["cluster"]
    calls = max(counts["sinkhorn_calls"], 1)
    print(f"  {[ln for ln in lines if ln.startswith('ConSSKM')][0]}")
    print(f"ConSSKM (Sinkhorn track) N={N_IMAGES - 32_512} K={K} sizes in "
          f"[{SIZE_MIN}, {SIZE_MAX}]: cluster {secs:.3f} s, "
          f"{counts['sinkhorn_calls']} E-steps ({secs / calls * 1e3:.1f} ms "
          f"each, {counts['dual_iterations'] / calls:.1f} dual iterations "
          f"and {counts['repair_passes'] / calls:.2f} repair passes on "
          f"average), mcf_fallbacks {counts['fallbacks']}; unlabelled "
          f"sizes [{sizes.min()}, {sizes.max()}]; run_ptsup "
          f"{time.perf_counter() - t0:.1f} s")

    wall, busy, iters, top = sinkhorn_estep_profile(cfg, SIZE_MIN, SIZE_MAX)
    print(f"one Sinkhorn E-step N={N_IMAGES - 32_512} K={K}: {wall:.1f} ms "
          f"(host clock), {iters} dual iterations; card busy "
          + (f"{busy:.1f} ms (torch.profiler), idle {1 - busy / wall:.1%}"
             if busy else "not measured (the profiler saw no device time)"))
    for name, ms, count in top:
        print(f"  {ms:.2f} ms in {count} launches of {name}")

    # cut: n_init 1, max_iterations 1, a quarter of the unlabelled rows
    # (the host solver took 47.2 s an E-step over all of them on an H100's
    # host, 76.0 s on a slower H100 host, 22.5 s over half on another;
    # this keeps the smoke, phases 14-16 included, inside its time)
    t0 = time.perf_counter()
    res, counts, wall = mcf_full_width(cfg, "cuda", SIZE_MIN, SIZE_MAX,
                                       rows=MCF_ROWS)
    it = max(counts["mcf_iterations"], 1)
    sizes = np.bincount(res.labels[32_512:], minlength=K)
    print(f"ConSSKM (MCF track) N={MCF_ROWS} D={D_FEAT} K={K}, "
          f"n_init 1, max_iterations 1: {counts['mcf_iterations']} "
          f"iterations, solver {counts['mcf_seconds'][0] / it:.3f} s and "
          f"device step {counts['mcf_seconds'][1] / it:.4f} s per iteration "
          f"(device step with the costs' copy to the host); fit "
          f"{wall:.3f} s; sizes [{sizes.min()}, {sizes.max()}]")
    mcf_card_against_cpu(seed)
    print(f"MCF phases {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    n_lines = ptsup_small_root(seed, workdir)
    print(f"small root: ptsup lines equal on the card and the CPU for "
          f"{n_lines} in {time.perf_counter() - t0:.1f} s")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ptsup_main(SMOKE_PTSUP + ["--cache_dir",
                                  os.path.join(workdir, "smoke_cache")])
    last = buf.getvalue().splitlines()[-1]
    check(last == "IoU: 1.0", f"smoke_all.sh ptsup command: {last}")
    print(f"smoke_all.sh ptsup command (ConSSKM, synthetic) on the card: "
          f"{last}")
    return launches


# ------------------------------------------------------------- phase 9

# estimate_k's slots (the JAX CLI's --max_k default) and search range; the
# live slots of the sentinel parity; the card-against-CPU check at phase
# 8's small size (20 classes, max_k 100, five K)
MAX_K, MIN_K, K_ACTIVE = 1_000, 10, (10, 100, 1_000)
EK_SMALL = dict(n=4_000, d=64, classes=20, max_k=100,
                ks=(5, 10, 20, 40, 100))
# the fine-grained roots' vocabulary and cluster counts (BASELINE.json
# configs 1, 2 and 4: K = the class count)
K_CUB, K_SDOGS = 200, 120


def _estimate_k_module():
    """``scd_tpu_torch.cluster.estimate_k`` the module (the package's
    ``cluster`` exports the function of that name, as the JAX package's
    does)."""
    import importlib

    return importlib.import_module("scd_tpu_torch.cluster.estimate_k")


def _kernel_launches(keys=("topk_softmax", "fused_em_step")):
    counts = _counts()
    return {k: counts[k] for k in keys}


def sentinel_em(x, gen):
    """``fused_em_step`` at MAX_K slots, the ones at or past k_active at
    ``estimate_k``'s 1e12 sentinel (squared norm ~7.7e26 at D 768), against
    its plain version (:func:`em_hold`'s tolerances) for each k_active of
    K_ACTIVE: every sentinel slot empty.  Then the times at k_active 100:
    kernel, plain, one library call, and the bound at MAX_K slots (the
    work the kernel does, as the JAX package's does) and at the live slots
    (the work this data needs).  Returns the sums' max abs error and the
    times."""
    import torch

    from scd_tpu_torch.cluster.estimate_k import SENTINEL
    from scd_tpu_torch.ops.em import em_iteration_plain, fused_em_step_cuda

    n, d = x.shape
    errs = []
    for k_active in K_ACTIVE:
        c = torch.full((MAX_K, d), SENTINEL, device="cuda")
        pick = torch.randperm(n, generator=gen, device="cuda")[:k_active]
        c[:k_active] = x[pick]
        err, (_, sums, counts, _) = em_hold(x, c, tag=f"sentinel-{k_active}")
        check(float(counts[k_active:].abs().sum()) == 0
              and bool((sums[k_active:] == 0).all()),
              f"fused_em sentinel-{k_active}: a sentinel slot got rows")
        errs.append(err)
        if k_active == 100:
            c100 = c

    def library():
        cross = torch.matmul(x, c100.t())
        d2 = (c100 * c100).sum(1)[None, :] - 2.0 * cross
        lab = torch.argmin(d2, dim=1)
        return torch.zeros(MAX_K, d, device="cuda").index_add_(0, lab, x)

    t_k = cuda_ms(lambda: fused_em_step_cuda(x, c100), reps=20, warmup=3)
    t_plain = cuda_ms(lambda: em_iteration_plain(x, c100, MAX_K), reps=3)
    t_lib = cuda_ms(library, reps=10)
    nbytes = 4.0 * (n * d + MAX_K * d + n + MAX_K * d + MAX_K + 1)
    bound, by, _ = _f32_product_bound(2.0 * n * MAX_K * d + n * d, nbytes)
    live, live_by, _ = _f32_product_bound(2.0 * n * 100 * d + n * d, nbytes)
    print(f"  fused_em_step N={n} D={d} K={MAX_K} (100 live slots), f32 x: "
          f"kernel {t_k:.4f} ms, plain {t_plain:.4f} ms, library (f32 "
          f"matmul + argmin + index_add_) {t_lib:.4f} ms, bound "
          f"{bound:.4f} ms ({by}, {MAX_K} slots) / {live:.4f} ms "
          f"({live_by}, the 100 live slots)")
    return max(errs), (t_k, t_plain, t_lib, bound, by)


def estimate_k_full(path):
    """``estimate_k.main`` on the features at ``path`` with the CLI's
    defaults (Brent, n_init 3, max_iterations 50), each probe timed; then
    the objective at K 100, the gate.  Returns (the fused_em_step and
    topk_softmax launches of the search, seconds)."""
    import numpy as np
    import torch

    ek = _estimate_k_module()

    real = ek.labelled_acc_objective_dynamic
    probes = []

    def timed_objective(*a, **kw):
        obj = real(*a, **kw)

        def probe(k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            acc = obj(k)
            probes.append((int(k), acc, time.perf_counter() - t0))
            return acc

        return probe

    ek.labelled_acc_objective_dynamic = timed_objective
    try:
        _reset_counts()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            best_k, best_acc = ek.main(["--features", path, "--min_k",
                                        str(MIN_K), "--max_k", str(MAX_K)])
        wall = time.perf_counter() - t0
        launches = _kernel_launches()
    finally:
        ek.labelled_acc_objective_dynamic = real
    for k, acc, secs in probes:
        print(f"  probe K={k}: objective {acc:.4f}, {secs:.3f} s")
    print(f"  {buf.getvalue().splitlines()[-1]}")
    print(f"estimate_k (Brent) N={RUNNER_N} D={D_FEAT} max_k={MAX_K}: "
          f"{len(probes)} probes, chosen K {best_k} (objective "
          f"{best_acc:.4f}), {wall:.1f} s; launches {launches}")
    check(MIN_K <= best_k <= MAX_K, f"estimate_k: K {best_k} out of range")
    check(launches["fused_em_step"] > 0, "estimate_k: fused_em_step never "
          "launched")
    with np.load(path) as z:
        obj = real(z["features"], z["targets"], z["mask_lab"], MAX_K,
                   device="cuda")
    acc100 = obj(100)
    print(f"  objective at K 100: {acc100:.4f}")
    check(acc100 >= 0.9, f"estimate_k: objective at K 100 is {acc100}")
    return launches, wall


def estimate_k_card_against_cpu(seed):
    """The objective at five K on the card and on the CPU from the same
    initial centers (drawn on the CPU, copied to the card), on
    :func:`subclustered_blobs`: equal."""
    from scd_tpu_torch.testing.fabricate import subclustered_blobs
    from scd_tpu_torch.testing.shared_centers import centers_drawn_on_cpu

    ek = _estimate_k_module()

    x, y, mask_lab = subclustered_blobs(EK_SMALL["n"], EK_SMALL["d"],
                                        EK_SMALL["classes"], seed)
    accs = {}
    with centers_drawn_on_cpu(x) as reset:
        for dev in ("cuda", "cpu"):
            reset()
            obj = ek.labelled_acc_objective_dynamic(
                x, y, mask_lab, EK_SMALL["max_k"], device=dev)
            accs[dev] = [obj(k) for k in EK_SMALL["ks"]]
    print(f"  objective at K {EK_SMALL['ks']} ({EK_SMALL['n']} x "
          f"{EK_SMALL['d']}, max_k {EK_SMALL['max_k']}): card {accs['cuda']}, "
          f"CPU {accs['cpu']}")
    check(accs["cuda"] == accs["cpu"], "estimate_k: the card's objective "
          "differs from the CPU's")


def _run(fn, cfg, device):
    """``fn(cfg, device)``: (result, printed lines, seconds)."""
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(cfg, device=device)
    return res, buf.getvalue().splitlines(), time.perf_counter() - t0


# the kernels whose inputs :func:`path_inputs` copies: name -> (module
# under scd_tpu_torch.ops, the wrapper that launches the kernel)
PATH_WRAPPERS = {"fused_em_step": ("em", "fused_em_step_cuda"),
                 "topk_softmax": ("topk", "topk_softmax_cuda"),
                 "attention": ("attention", "attention_cuda"),
                 "attention_bwd": ("attention", "qkv_attention_bwd_cuda"),
                 "w8a8_fusedq": ("w8a8", "w8a8_fusedq_cuda"),
                 "prefix_attention": ("attention", "prefix_attention_cuda")}


def _path_key(args):
    """A call's shapes, dtypes, strides and options."""
    import torch

    return tuple((name, (tuple(v.shape), v.dtype, v.stride()))
                 if isinstance(v, torch.Tensor) else (name, v)
                 for name, v in args.items())


def _path_copy(args):
    """``args`` with every tensor copied.  Tensors that are views of one
    contiguous buffer (the q, k, v of a packed qkv) stay views of one
    copy, at their strides."""
    import torch

    tensors = [v for v in args.values() if isinstance(v, torch.Tensor)]
    copies = {}
    for v in tensors:
        base = v._base
        if (base is not None and base.is_contiguous()
                and sum(t._base is base for t in tensors) > 1):
            copies.setdefault(id(base), (base, base.clone()))
    out = {}
    for name, v in args.items():
        if not isinstance(v, torch.Tensor):
            out[name] = v
        elif v._base is not None and id(v._base) in copies:
            base, copy = copies[id(v._base)]
            out[name] = copy.as_strided(
                v.shape, v.stride(), v.storage_offset() - base.storage_offset())
        else:
            out[name] = v.clone()
    return out


@contextlib.contextmanager
def path_inputs():
    """Within the block, the arguments of the first call of each wrapper
    of PATH_WRAPPERS at each distinct shape, dtype, stride and option are
    copied into the yielded dict, under the kernel's name; every call runs
    on as it would.  A wrapper counts its launches on the module's name
    for it, so each spy carries the counts while it stands in, and hands
    them back on leaving."""
    import importlib
    import inspect

    seen = {name: {} for name in PATH_WRAPPERS}
    patched = []
    for name, (mod_name, attr) in PATH_WRAPPERS.items():
        mod = importlib.import_module(f"scd_tpu_torch.ops.{mod_name}")
        real = getattr(mod, attr)
        sig = inspect.signature(real)

        def spy(*a, _real=real, _sig=sig, _seen=seen[name], **kw):
            bound = _sig.bind(*a, **kw)
            bound.apply_defaults()
            key = _path_key(bound.arguments)
            if key not in _seen:
                _seen[key] = _path_copy(bound.arguments)
            return _real(*a, **kw)

        spy.__dict__.update(real.__dict__)
        setattr(mod, attr, spy)
        patched.append((mod, attr, real, spy))
    try:
        yield seen
    finally:
        for mod, attr, real, spy in patched:
            setattr(mod, attr, real)
            real.__dict__.update(spy.__dict__)


def hold_path_inputs(seen, tag):
    """Each kernel against its plain version on the arguments a main path
    passed it (:func:`path_inputs`), with the tolerances of
    :func:`em_hold`, :func:`topk_hold`, :func:`attention_parity`,
    :func:`attention_bwd_parity`, :func:`fusedq_parity` and
    :func:`prefix_parity`."""
    for i, a in enumerate(seen["fused_em_step"].values()):
        em_hold(a["x"], a["centers"], a["row_w"], tag=f"{tag} #{i}")
    for i, a in enumerate(seen["topk_softmax"].values()):
        topk_hold(a["feats"], a["weights"], a["k"], a["scale"],
                  tag=f"{tag} #{i}")
    for i, a in enumerate(seen["attention"].values()):
        q = a["q"]
        b, length, h, d = q.shape
        attention_parity(b, length, h, d, q.dtype, None, a["causal"],
                         a["l_valid"], packed=False, tag=f"{tag} #{i}",
                         inputs=(None, (q, a["k"], a["v"])), scale=a["scale"])
    for i, a in enumerate(seen["attention_bwd"].values()):
        qkv, h = a["qkv"], a["heads"]
        b, length, w3 = qkv.shape
        attention_bwd_parity(b, length, h, w3 // (3 * h), qkv.dtype, None,
                             a["l_valid"], tag=f"{tag} #{i}",
                             inputs=(qkv, a["dout"]), scale=a["scale"],
                             causal=a["causal"])
    for i, a in enumerate(seen["w8a8_fusedq"].values()):
        x, wq_t = a["x"], a["wq_t"]
        fusedq_parity(x.shape[0], x.shape[1], wq_t.shape[0], a["act"],
                      a["out_dtype"], None, f"{tag} #{i}",
                      inputs=(x, wq_t, a["s_w"], a["bias"]))
    for i, a in enumerate(seen["prefix_attention"].values()):
        prefix_parity(a["p_valid"], a["q"].dtype, None, tag=f"{tag} #{i}",
                      inputs=tuple(a[n] for n in ("q", "k", "v", "pk", "pv")),
                      scale=a["scale"])


def fine_grained_run(fn, cfg, tag, against_cpu=True):
    """A warm run of ``fn`` (``run_unsup`` or ``run_ptsup``) on the card
    with clustering, its stage seconds and launches; then each kernel held
    against its plain version on the inputs that run passed it; then (with
    ``against_cpu``) the cached re-entry on the card and on the CPU: equal
    metric lines.  Both re-entries read the cluster labels the card's run
    cached, so that comparison covers the naming stages; the clustering
    is covered by the holds.  Returns the first run's launches."""
    import dataclasses

    _reset_counts()
    with path_inputs() as seen:
        res, lines, wall = _run(fn, cfg, "cuda")
    launches = _kernel_launches()
    for ln in lines:
        if ln.startswith(("SSKM Accuracies:", "ConSSKM Accuracies:",
                          "sACC all", "IoU:")):
            print("  " + ln)
    print(f"{tag}: stage seconds " + ", ".join(
        f"{k} {v:.3f}" for k, v in res["stage_seconds"].items())
        + f" | {wall:.3f} s; launches {launches}")
    check(res["cluster_acc"][0] >= ACC_FLOOR,
          f"{tag}: ACC {res['cluster_acc'][0]} below {ACC_FLOOR}")
    hold_path_inputs(seen, tag)
    if not against_cpu:
        return launches
    cached = dataclasses.replace(cfg, run_cluster=False)
    texts = {}
    for dev in ("cuda", "cpu"):
        _, texts[dev], secs = _run(fn, cached, dev)
        print(f"  {tag} cached re-entry on {dev}: {secs:.1f} s")
    check(texts["cuda"] == texts["cpu"] and len(texts["cpu"]) > 10,
          f"{tag}: the card's lines differ from the CPU's")
    print(f"  {tag}: {len(texts['cpu'])} lines equal on the card and the CPU "
          f"(naming stages, from the card's cluster labels)")
    return launches


def phase_estimate_k(seed: int, workdir: str):
    """Phase 9 (see the module docstring).  Returns the sentinel parity's
    error and times, and the launches of the phase's main paths."""
    import dataclasses

    import numpy as np
    import torch

    from scd_tpu_torch.pipelines.ptsup import run_ptsup
    from scd_tpu_torch.pipelines.unsup import run_unsup
    from scd_tpu_torch.testing.fabricate import (fabricate_fine_grained,
                                                 warm_config)

    path = write_features_packed(seed, os.path.join(workdir,
                                                    "features_packed.npz"))
    t0 = time.perf_counter()
    with np.load(path) as z:
        x = torch.from_numpy(z["features"]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    err, times = sentinel_em(x, gen)
    del x
    print(f"sentinel parity and timing {time.perf_counter() - t0:.1f} s")

    launches = {"topk_softmax": 0, "fused_em_step": 0}
    ek_launches, ek_wall = estimate_k_full(path)
    launches["fused_em_step"] += ek_launches["fused_em_step"]
    t0 = time.perf_counter()
    estimate_k_card_against_cpu(seed)
    print(f"card against CPU {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cub = warm_config(os.path.join(workdir, "cub"), "cub", K_CUB)
    info = fabricate_fine_grained(cub, seed=seed, device="cuda",
                                  d_feat=D_FEAT, d_clip=D_CLIP, vocab=VOCAB)
    print(f"fabricated CUB N={info['n_images']} (labelled "
          f"{info['n_labelled']}), V={len(info['nouns'])} in "
          f"{time.perf_counter() - t0:.1f} s")
    for k, v in fine_grained_run(run_unsup, cub, "CUB run_unsup").items():
        launches[k] += v
    check(launches["topk_softmax"] > 0, "CUB: topk_softmax never launched")

    t0 = time.perf_counter()
    dogs = warm_config(os.path.join(workdir, "sdogs"), "sdogs", K_SDOGS,
                       textual_enhancement=True, partially_supervised=True)
    info = fabricate_fine_grained(dogs, seed=seed, device="cuda",
                                  d_feat=D_FEAT, d_clip=D_CLIP, vocab=VOCAB)
    print(f"fabricated Stanford Dogs N={info['n_images']} (labelled "
          f"{info['n_labelled']}) in {time.perf_counter() - t0:.1f} s")
    dogs_launches = fine_grained_run(run_ptsup, dogs, "Dogs run_ptsup (TE)")
    check(dogs_launches["topk_softmax"] >= 3
          and dogs_launches["fused_em_step"] > 0,
          f"Dogs: a kernel of the path launched too rarely: {dogs_launches}")
    for k, v in dogs_launches.items():
        launches[k] += v
    con = dataclasses.replace(dogs, cluster=dataclasses.replace(
        dogs.cluster, algorithm="ConSSKM", constrained_backend="sinkhorn"))
    # cut: the ConSSKM run is not re-entered on the CPU (26 s on an H100;
    # its naming stages are the SSKM run's, held just above)
    for k, v in fine_grained_run(run_ptsup, con, "Dogs run_ptsup (TE, "
                                 "ConSSKM)", against_cpu=False).items():
        launches[k] += v
    sizes = _unlab_sizes(con)
    print(f"  ConSSKM unlabelled sizes [{sizes.min()}, {sizes.max()}] in "
          f"[{con.cluster.size_min}, {con.cluster.size_max}]")
    check(sizes.min() >= con.cluster.size_min
          and sizes.max() <= con.cluster.size_max,
          "Dogs ConSSKM: a cluster size out of bounds")
    print(f"estimate_k search {ek_wall:.1f} s; launches in phase 9's main "
          f"paths: {launches}")
    return err, times, launches


# ------------------------------------------------------------- phase 10

# the training step of phase 10: ViT-B/16 at 224, 128 images x 2 views,
# the GCD recipe's last block and head trainable; the card-against-CPU
# step's batch (2 views x 8 images); the fabricated ImageNet-100 root's
# train images (30 a class), its WordNet vocabulary
TRAIN_IMAGES, TRAIN_VIEWS, GRAD_FROM_BLOCK, PROJ_DIM = 128, 2, 11, 65_536
CPU_STEP_IMAGES, TRAIN_ROOT_IMAGES, TRAIN_ROOT_VOCAB = 8, 3_000, 1_100
TRAIN_EPOCHS, TRAIN_STEPS = 2, 10
# tolerances, with their reasons:
# - one f32 step card against CPU: the loss and the first SGD update
#   (-lr (g + wd p)) from f32 forward and backward passes through 12
#   blocks and the head whose sums run in other orders (cuBLAS and the
#   attention kernels against the CPU's matmuls and plain versions):
#   ~1e-6 relative per layer, so 1e-4 on the loss, and each trainable
#   update within 1e-3 of its largest element with a cosine >= 0.999
STEP_LOSS_RTOL, STEP_UPDATE_TOL, STEP_COS_MIN = 1e-4, 1e-3, 0.999
# - --int8_frozen against bf16 from the same parameters: W8A8 rounding
#   of qkv and fc1 (amax / 127 steps per row and per channel) in the 11
#   frozen blocks perturbs the features by ~1e-2 relative; the loss, a
#   mean over 256 anchors, moves less.  On noise images at init the loss
#   sits near log(255) whatever the trunk computes, so the trunk itself is
#   held too: the sum of the frozen blocks' residual updates and the
#   first qkv update of the trainable block, int8 against bf16, each
#   within ~3x the deviation read on an H100 at this seed (the updates:
#   1 - cosine 1.44e-4, 1.70e-2 relative; qkv: 1 - cosine 1.45e-3).
#   Every int8 weight scale 10% off, imposed at run time, reads 3.96e-3
#   and 0.167 (caught); the per-channel scales rotated by one channel,
#   nearly equal at this init, read 2.86e-4 and 2.39e-2 (not caught)
INT8_LOSS_RTOL = 0.02
INT8_TRUNK_DEV, INT8_TRUNK_REL, INT8_QKV_DEV = 5e-4, 0.05, 5e-3


def _train_configs(dtype, int8_frozen=False, total_steps=TRAIN_EPOCHS
                   * TRAIN_STEPS, image_size=224):
    """metric_learn's ViT-B/16 and TrainConfig for ``--vit base
    --image_size 224 --grad_from_block 11 --proj_dim 65536`` (the CLI's
    defaults otherwise; ``image_size`` 256 for the long-sequence steps)."""
    from scd_tpu_torch.core.config import TrainConfig
    from scd_tpu_torch.models.vit import ViTConfig

    vit = ViTConfig(image_size=image_size, patch_size=16, width=768, depth=12,
                    heads=12, compute_dtype=dtype)
    cfg = TrainConfig(lr=0.1, sup_con_weight=0.35,
                      grad_from_block=GRAD_FROM_BLOCK, n_views=TRAIN_VIEWS,
                      proj_dim=PROJ_DIM, batch_size=TRAIN_IMAGES,
                      int8_frozen=int8_frozen)
    return vit, cfg, total_steps


def _train_batch(seed, n_images, size=224):
    """A host batch of ``n_images`` x 2 views (normalized-scale noise)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal(
                (TRAIN_VIEWS * n_images, size, size, 3)).astype(np.float32),
            "labels": rng.integers(0, 50, n_images),
            "mask_lab": rng.random(n_images) < 0.5}


def train_step_card_against_cpu(seed):
    """One f32 GCD step of ViT-B/16 on the card and on the CPU from the
    port's init (seed), carried to both, and one batch."""
    import torch

    from scd_tpu_torch.train.gcd import GCDTrainer

    vit, cfg, total = _train_configs(torch.float32)
    t0 = time.perf_counter()
    card = GCDTrainer(vit, cfg, seed=seed, total_steps=total, device="cuda")
    cpu = GCDTrainer(vit, cfg, seed=seed, total_steps=total, device="cpu")
    cpu.model.load_state_dict(card.model.state_dict())
    before = {k: v.cpu().clone() for k, v in card.model.state_dict().items()}
    trainable = {n for n, p in card.model.named_parameters()
                 if p.requires_grad}
    batch = _train_batch(seed + 1, CPU_STEP_IMAGES)
    _reset_counts()
    with path_inputs() as seen:
        m_card = card.step_fn(card.model, card.opt, card.to_device(batch))
        torch.cuda.synchronize()
    counts = _counts()
    check(counts["attention_bwd"] == 1 and counts["attention"] == 12,
          f"card step: launches {counts}")
    hold_path_inputs(seen, "f32 step")
    m_cpu = cpu.step_fn(cpu.model, cpu.opt, cpu.to_device(batch))
    loss_card, loss_cpu = m_card["loss"].item(), m_cpu["loss"].item()
    check(abs(loss_card - loss_cpu) <= STEP_LOSS_RTOL * abs(loss_cpu),
          f"card step loss {loss_card} vs CPU {loss_cpu}")
    after_cpu = cpu.model.state_dict()
    worst_cos, worst_err, frozen = 1.0, 0.0, 0
    for name, v in card.model.state_dict().items():
        v = v.cpu()
        if name not in trainable:
            check(torch.equal(v, before[name]), f"frozen {name} changed")
            check(torch.equal(after_cpu[name], before[name]),
                  f"frozen {name} changed on the CPU")
            frozen += 1
            continue
        du = (v - before[name]).double()
        dw = (after_cpu[name] - before[name]).double()
        check(dw.norm().item() > 0, f"{name}: no update on the CPU")
        cos = ((du * dw).sum() / (du.norm() * dw.norm())).item()
        err = ((du - dw).abs().max() / dw.abs().max()).item()
        worst_cos, worst_err = min(worst_cos, cos), max(worst_err, err)
        check(cos >= STEP_COS_MIN and err <= STEP_UPDATE_TOL,
              f"{name}: update cosine {cos:.6f}, error {err:.2e} of its "
              f"largest element")
    print(f"  one f32 step, {TRAIN_VIEWS} x {CPU_STEP_IMAGES} images: loss "
          f"card {loss_card:.6f} CPU {loss_cpu:.6f}; {len(trainable)} "
          f"trainable updates: min cosine {worst_cos:.7f}, max error "
          f"{worst_err:.2e} of the largest element; {frozen} frozen "
          f"parameters unchanged; {time.perf_counter() - t0:.1f} s")
    del card, cpu


class _TrainProbe:
    """For the length of a ``with`` block, the clock and the launch counts
    at the start and the end of each ``GCDTrainer.train_epoch`` and at the
    start of each ``CheckpointManager.save``.  ``fit`` runs an epoch, its
    eval, its log line, then the save, so an eval is what lies between an
    epoch's end and the next save."""

    def __enter__(self):
        import torch

        from scd_tpu_torch.train import checkpoint, gcd

        self.marks = []
        self._real = [(gcd.GCDTrainer, "train_epoch",
                       gcd.GCDTrainer.train_epoch),
                      (checkpoint.CheckpointManager, "save",
                       checkpoint.CheckpointManager.save)]
        epoch_fn, save_fn = (real for _cls, _name, real in self._real)

        def mark(what):
            torch.cuda.synchronize()
            self.marks.append((what, time.perf_counter(), _counts()))

        def train_epoch(trainer, *a, **kw):
            mark("epoch")
            out = epoch_fn(trainer, *a, **kw)
            mark("epoch end")
            return out

        def save(manager, *a, **kw):
            mark("save")
            return save_fn(manager, *a, **kw)

        gcd.GCDTrainer.train_epoch = train_epoch
        checkpoint.CheckpointManager.save = save
        return self

    def __exit__(self, *exc):
        for cls, name, real in self._real:
            setattr(cls, name, real)

    def spans(self, start, end):
        """(seconds, launches by kernel) from each ``start`` mark to the
        ``end`` mark that follows it."""
        out, opened = [], None
        for what, t, counts in self.marks:
            if what == start:
                opened = (t, counts)
            elif what == end and opened is not None:
                out.append((t - opened[0],
                            {k: counts[k] - opened[1][k] for k in counts}))
                opened = None
        return out


def metric_learn_full(seed, workdir):
    """``metric_learn.main`` at ViT-B/16 full width on a fabricated
    ImageNet-100 root; returns (main's result, the per-step launches)."""
    import json as _json

    import torch

    from scd_tpu_torch.testing.fabricate import (fabricate_imagenet_tree,
                                                 fabricated_images,
                                                 imagenet100_config)
    from scd_tpu_torch.train import metric_learn

    t0 = time.perf_counter()
    cfg = imagenet100_config(os.path.join(workdir, "in100"))
    fabricate_imagenet_tree(cfg, TRAIN_ROOT_IMAGES, TRAIN_ROOT_VOCAB, 20)
    print(f"  fabricated an ImageNet-100 tree of {TRAIN_ROOT_IMAGES} train "
          f"images in {time.perf_counter() - t0:.1f} s")
    argv = ["--dataset_name", "imagenet_100", "--root_dir",
            cfg.data.root_dir, "--vit", "base", "--image_size", "224",
            "--batch_size", str(TRAIN_IMAGES), "--n_views",
            str(TRAIN_VIEWS), "--grad_from_block", str(GRAD_FROM_BLOCK),
            "--proj_dim", str(PROJ_DIM), "--bf16", "1", "--epochs",
            str(TRAIN_EPOCHS), "--steps_per_epoch", str(TRAIN_STEPS),
            "--max_kmeans_iter", "10", "--exp_root",
            os.path.join(workdir, "runs")]
    print("  python -m scd_tpu_torch.train.metric_learn " + " ".join(
        a if a != cfg.data.root_dir else "<root>" for a in argv))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    # the images are 256 x 256: the imagenet train transform's resize to
    # 224 / 0.875 = 256 is then the identity, so no decoder is needed
    with fabricated_images(seed, size=256), _TrainProbe() as probe, \
            path_inputs() as seen:
        res = metric_learn.main(argv)
    wall = time.perf_counter() - t0
    counts = _counts()
    epochs, evals = probe.spans("epoch", "epoch end"), \
        probe.spans("epoch end", "save")
    with open(os.path.join(res["log_dir"], "log.txt")) as f:
        for ln in f:
            if "Epoch" in ln:
                print("  " + ln.split(" INFO ", 1)[-1].rstrip())
    steps = TRAIN_EPOCHS * TRAIN_STEPS
    step_launch = {k: sum(e[1][k] for e in epochs)
                   for k in ("attention", "attention_bwd", "fused_em_step")}
    eval_launch = {k: sum(e[1][k] for e in evals)
                   for k in ("attention", "fused_em_step")}
    epoch_s = [e[0] for e in epochs]
    ms_step = 1e3 * sum(epoch_s) / steps
    print(f"  {steps} steps: {ms_step:.1f} ms a step (host augmentation "
          f"included), {TRAIN_IMAGES * 1e3 / ms_step:.1f} images/s "
          f"({TRAIN_VIEWS * TRAIN_IMAGES * 1e3 / ms_step:.1f} views/s); "
          f"epochs {', '.join(f'{t:.2f}' for t in epoch_s)} s; evals "
          f"{', '.join(f'{e[0]:.2f}' for e in evals)} s; main "
          f"{wall:.1f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  launches in the steps {step_launch}, in the evals "
          f"{eval_launch}, in all {counts}")
    check(step_launch["attention"] >= 12 * steps,
          "metric_learn: the attention kernel launched too rarely")
    check(step_launch["attention_bwd"] == steps
          and counts["attention_bwd"] == steps,
          "metric_learn: the gradient kernel did not launch once a step")
    check(eval_launch["fused_em_step"] > 0,
          "metric_learn: fused_em_step never launched in the evals")
    check(all(math.isfinite(float(v)) for v in res["last"].values()),
          f"metric_learn: a non-finite metric {res['last']}")
    with open(os.path.join(res["ckpt"].directory, "manifest.json")) as f:
        manifest = _json.load(f)
    check(manifest["steps"] == list(range(TRAIN_EPOCHS))
          and manifest["best_step"] is not None
          and os.path.exists(os.path.join(res["ckpt"].directory,
                                          "ckpt_best.pt")),
          f"metric_learn: manifest {manifest}")
    print(f"  manifest: latest {max(manifest['steps'])}, best "
          f"{manifest['best_step']} ({manifest['best_value']:.4f})")
    check(len(epochs) == len(evals) == TRAIN_EPOCHS,
          f"metric_learn: {len(epochs)} epochs, {len(evals)} evals timed")
    hold_path_inputs(seen, "metric_learn")
    return res, step_launch


def restore_and_step(res, seed):
    """A fresh trainer restored from main's last checkpoint and main's
    trainer each take one step on one batch: the same bits."""
    import torch

    from scd_tpu_torch.train.gcd import GCDTrainer

    vit, cfg, total = _train_configs(torch.bfloat16)
    trainer, ckpt = res["trainer"], res["ckpt"]
    fresh = GCDTrainer(vit, cfg, seed=seed + 99, total_steps=total,
                       device="cuda")
    step, state = ckpt.restore()
    fresh.load_state(state)
    batch = _train_batch(seed + 2, TRAIN_IMAGES)
    for t in (trainer, fresh):
        t.step_fn(t.model, t.opt, t.to_device(batch))
    a, b = trainer.model.state_dict(), fresh.model.state_dict()
    check(all(torch.equal(a[k], b[k]) for k in a),
          "restore: a parameter differs after the step")
    sa, sb = trainer.opt.sgd.state_dict(), fresh.opt.sgd.state_dict()
    check(trainer.opt.count == fresh.opt.count == total + 1
          and all(torch.equal(sa["state"][i]["momentum_buffer"],
                              sb["state"][i]["momentum_buffer"])
                  for i in sa["state"]),
          "restore: the optimizer state differs after the step")
    print(f"  restored checkpoint {step} into a fresh trainer: one more "
          f"step gives the same bits ({len(a)} parameters, "
          f"{len(sa['state'])} momentum buffers)")
    del fresh


def _cos_rel(a, b):
    """(cosine, |a - b| / |b|) of two tensors as flat f64 vectors."""
    a, b = a.double().flatten(), b.double().flatten()
    return ((a @ b) / (a.norm() * b.norm())).item(), \
        ((a - b).norm() / b.norm()).item()


def image256_steps(seed):
    """Two bf16 GCD steps of ViT-B/16 at image 256 (L 257: the forward's
    long path, the gradient kernel past 256 keys) on a fixed device batch
    of 128 x 2 views; every kernel call of the steps is held against its
    plain version on the arguments the steps passed it."""
    import torch

    from scd_tpu_torch.train.gcd import GCDTrainer

    vit, cfg, total = _train_configs(torch.bfloat16, image_size=IMAGE_LONG)
    tr = GCDTrainer(vit, cfg, seed=seed, total_steps=total, device="cuda")
    batch = tr.to_device(_train_batch(seed + 6, TRAIN_IMAGES, IMAGE_LONG))
    _reset_counts()
    t0 = time.perf_counter()
    with path_inputs() as seen:
        losses = [tr.step_fn(tr.model, tr.opt, batch)["loss"].item()
                  for _ in range(2)]
    wall = time.perf_counter() - t0
    counts = _counts()
    print(f"  two bf16 steps at image {IMAGE_LONG} (L {L_257}) on a device "
          f"batch of {TRAIN_VIEWS} x {TRAIN_IMAGES}: losses "
          f"{', '.join(f'{v:.5f}' for v in losses)}, {wall:.2f} s with the "
          f"first step's set-up; launches {counts}")
    check(all(math.isfinite(v) for v in losses),
          f"image {IMAGE_LONG}: a non-finite loss {losses}")
    check(counts["attention_bwd"] == 2
          and counts["attention_long_wgmma"] == counts["attention"] == 24,
          f"image {IMAGE_LONG}: launches {counts}")
    check(all(a["qkv"].shape[1] == L_257
              for a in seen["attention_bwd"].values()),
          f"image {IMAGE_LONG}: the gradient kernel saw another L")
    hold_path_inputs(seen, f"image {IMAGE_LONG}")
    del tr, batch


def int8_frozen_steps(seed):
    """Two steps under --int8_frozen 1 and two in bf16, from the same
    parameters and batches.  What the frozen trunk computes is held int8
    against bf16: the sum of the 11 frozen blocks' residual updates (the
    trainable block's input less block 0's, real tokens) and the first
    step's update of the trainable block's qkv kernel.  The int8 steps'
    kernel calls are held against their plain versions.  Returns the
    launches of the int8 steps."""
    import torch

    from scd_tpu_torch.train.gcd import GCDTrainer

    losses, seen_len, trunk, qkv_step = {}, [], {}, {}
    batches = [_train_batch(seed + 3 + i, TRAIN_IMAGES) for i in range(2)]
    launches = {}
    for int8 in (True, False):
        vit, cfg, total = _train_configs(torch.bfloat16, int8_frozen=int8)
        tr = GCDTrainer(vit, cfg, seed=seed, total_steps=total,
                        device="cuda")
        bb = tr.model.backbone
        top = getattr(bb, f"block_{GRAD_FROM_BLOCK}")
        inputs = {}

        def keep(name):
            def hook(_m, args, kw):
                if name not in inputs:  # the first step's
                    inputs[name] = args[0][:, :L_VIT].detach().float()
                    if name == "top":  # the trainable block: L, l_valid
                        seen_len.append((int8, tuple(args[0].shape),
                                         kw.get("real_len")))
            return hook

        hooks = [blk.register_forward_pre_hook(keep(name), with_kwargs=True)
                 for name, blk in (("first", bb.block_0), ("top", top))]
        kernel = top.attn.qkv.kernel
        before = kernel.detach().clone()
        _reset_counts()
        with contextlib.ExitStack() as stack:
            seen = stack.enter_context(path_inputs()) if int8 else None
            losses[int8] = []
            for i, b in enumerate(batches):
                losses[int8].append(tr.step_fn(tr.model, tr.opt,
                                               tr.to_device(b))["loss"].item())
                if i == 0:
                    qkv_step[int8] = (kernel.detach() - before).float()
        for h in hooks:
            h.remove()
        trunk[int8] = inputs["top"] - inputs["first"]
        if int8:
            launches = _counts()
            hold_path_inputs(seen, "int8_frozen")
        del tr, inputs, before
    check(launches["w8a8_fusedq"] == 2 * 2 * GRAD_FROM_BLOCK
          and launches["attention_bwd"] == 2,
          f"--int8_frozen: launches {launches}")
    check([x for x in seen_len if x[0]] == [
        (True, (TRAIN_VIEWS * TRAIN_IMAGES, L_PAD, 768), L_VIT)],
        f"--int8_frozen: the trainable block saw {seen_len}")
    trunk_cos, trunk_rel = _cos_rel(trunk[True], trunk[False])
    row_cos = _row_cos(trunk[True].flatten(0, 1), trunk[False].flatten(0, 1))
    qkv_cos, qkv_rel = _cos_rel(qkv_step[True], qkv_step[False])
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses[True],
                                                  losses[False]))
    print(f"  --int8_frozen 1, two steps: losses "
          f"{', '.join(f'{v:.5f}' for v in losses[True])} (bf16 "
          f"{', '.join(f'{v:.5f}' for v in losses[False])}, {rel:.2e} "
          f"relative); the frozen blocks' residual updates int8 vs bf16: "
          f"cosine {trunk_cos:.6f} (tokens: min {row_cos.min().item():.6f}, "
          f"mean {row_cos.mean().item():.6f}), {trunk_rel:.3e} relative; "
          f"the first qkv update: cosine {qkv_cos:.6f}, {qkv_rel:.3e} "
          f"relative; w8a8_fusedq {launches['w8a8_fusedq']} launches; the "
          f"trainable block, and so the gradient kernel, at L {L_PAD} / "
          f"l_valid {L_VIT}")
    check(all(math.isfinite(float(v)) for v in losses[True])
          and rel <= INT8_LOSS_RTOL,
          f"--int8_frozen losses {losses[True]} vs bf16 {losses[False]}")
    check(1 - trunk_cos <= INT8_TRUNK_DEV and trunk_rel <= INT8_TRUNK_REL,
          f"--int8_frozen: the frozen trunk's updates int8 vs bf16: cosine "
          f"{trunk_cos}, {trunk_rel} relative")
    check(1 - qkv_cos <= INT8_QKV_DEV,
          f"--int8_frozen: the first qkv update's cosine to bf16's {qkv_cos}")
    return launches


def profile_by_kernel(step, top=14):
    """One call of ``step`` under ``torch.profiler``: device time by
    kernel (the kernels' own events; an operator's device time repeats
    theirs), then by part (attention forward, attention gradient, the
    prefix attention, matrix products, other; parts with no time left
    out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    # the kernels' own events (an operator's device time repeats theirs)
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    total_ms = sum(r[1] for r in rows)
    if not rows:
        print("  the profiler shows no device time; CUDA-event times above")
    else:
        print(f"  device time by kernel in one profiled step "
              f"({total_ms:.2f} ms in all):")
        for key, ms, n in rows[:top]:
            print(f"    {ms:8.3f} ms {100 * ms / total_ms:5.1f}%  x{n:<4d} "
                  f"{key[:90]}")
        groups = {"attention forward": 0.0, "attention gradient": 0.0,
                  "prefix attention": 0.0, "matrix products": 0.0,
                  "other": 0.0}
        for key, ms, _n in rows:
            name = key.lower()
            if "prefix_" in name:
                groups["prefix attention"] += ms
            elif "attn_bwd" in name:
                groups["attention gradient"] += ms
            elif "attn_" in name:
                groups["attention forward"] += ms
            elif any(t in name for t in ("gemm", "xmma", "cutlass",
                                         "matmul", "nvjet", "sm90_")):
                groups["matrix products"] += ms
            else:
                groups["other"] += ms
        print("  by part: " + ", ".join(
            f"{k} {v:.3f} ms ({100 * v / total_ms:.1f}%)"
            for k, v in groups.items() if v))


def step_breakdown(seed):
    """Where a bf16 training step's device time goes (one step of 128 x 2
    views under ``torch.profiler``: time by kernel), its CUDA-event time,
    the trunk's forward alone, the host's augmentation of one batch, and
    the peak memory of a step."""
    import numpy as np
    import torch

    from scd_tpu_torch.data import get_transform
    from scd_tpu_torch.data.augment import ContrastiveViewGenerator
    from scd_tpu_torch.train.gcd import GCDTrainer

    vit, cfg, total = _train_configs(torch.bfloat16)
    tr = GCDTrainer(vit, cfg, seed=seed, total_steps=total, device="cuda")
    batch = tr.to_device(_train_batch(seed + 5, TRAIN_IMAGES))

    def step():
        tr.step_fn(tr.model, tr.opt, batch)

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms_step = cuda_ms(step, reps=5, warmup=1)
    with torch.no_grad():
        ms_trunk = cuda_ms(lambda: tr.model.backbone(batch["images"]),
                           reps=5, warmup=1)
    rng = np.random.default_rng(seed)
    views = ContrastiveViewGenerator(get_transform(
        "imagenet", image_size=224, train=True, seed=seed), TRAIN_VIEWS)
    imgs = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8)
            for _ in range(TRAIN_IMAGES)]
    t0 = time.perf_counter()
    for img in imgs:
        views(img)
    host_ms = 1e3 * (time.perf_counter() - t0)
    print(f"  a bf16 step on a device batch of {TRAIN_VIEWS} x "
          f"{TRAIN_IMAGES}: {ms_step:.2f} ms (CUDA events); the trunk's "
          f"forward alone (no graph) {ms_trunk:.2f} ms; the host's "
          f"augmentation of one batch {host_ms:.1f} ms on one thread; peak "
          f"memory of a step {peak / 2**30:.2f} GiB "
          f"({(peak - base) / 2**30:.2f} GiB above the resident "
          f"{base / 2**30:.2f} GiB)")
    profile_by_kernel(step)
    del tr, batch
    return ms_step, peak


def phase_train(seed, workdir):
    """Phase 10 (see the module docstring); returns the gradient kernel's
    launches in the training steps."""
    t0 = time.perf_counter()
    train_step_card_against_cpu(seed)
    print(f"card against CPU {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    res, step_launch = metric_learn_full(seed, workdir)
    restore_and_step(res, seed)
    del res
    print(f"metric_learn and restore {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    image256_steps(seed)
    print(f"image {IMAGE_LONG} steps {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    int8_frozen_steps(seed)
    step_breakdown(seed)
    print(f"int8 steps and breakdown {time.perf_counter() - t0:.1f} s")
    return step_launch


# ------------------------------------------------------------- phase 11

# the NCD baselines.  End to end (run_baseline_e2e): ViT-B/16 at 224, f32,
# 64 images x 2 views (so B 128 through the trunk a step), the reference's
# --overcluster_factor 3, cut to 2 epochs of 3 steps on a fabricated
# ImageNet-100 tree like phase 10's; the card-against-CPU steps' batch (4
# images x 2 views).  Frozen features (run_baseline): phase 7's store,
# --n_labeled 50, cut to 1 epoch; the card-against-CPU subset of its first
# 8,192 rows.  The ResNet-50 tower's batch.
E2E_BATCH, E2E_EPOCHS, E2E_STEPS = 64, 2, 3
E2E_CPU_IMAGES, BASELINE_LABELED, BASELINE_SUBSET = 4, 50, 8_192
R50_BATCH, R50_CPU_IMAGES = 128, 8
# tolerances, with their reasons:
# - one f32 step of each end-to-end trainer card against CPU: phase 10's
#   gates (STEP_LOSS_RTOL, STEP_UPDATE_TOL, STEP_COS_MIN), now through all
#   12 blocks' forward and gradient kernels;
# - the frozen-feature trainers on the subset, card against CPU, one epoch
#   of 32 SGD steps whose f32 sums run in other orders: each epoch's loss
#   within FROZEN_LOSS_RTOL, and the predictions equal on at least
#   FROZEN_AGREE of the rows.  Read on an H100 at this seed: losses 0,
#   1.1e-7 and 1.2e-7 relative apart, predictions equal on every row;
# - the ResNet-50 tower bf16 on the card against f32 on the CPU: bf16
#   activations through 16 bottlenecks, every row's cosine >= R50_COS
#   (read: min 0.999989); the two-head ResNet f32 on both (TF32 off):
#   RESNET_F32_COS (read: 1.0000000)
FROZEN_LOSS_RTOL, FROZEN_AGREE = 1e-5, 0.999
R50_COS, RESNET_F32_COS = 0.9999, 0.99999


class _EpochProbe:
    """For the length of a ``with`` block, the seconds and launch counts of
    each epoch and each eval of ``baselines_e2e._run_epochs`` (the device
    synchronised at both ends)."""

    def __enter__(self):
        import torch

        from scd_tpu_torch.train import baselines_e2e as E

        self.epochs, self.evals = [], []
        self._mod, self._real = E, E._run_epochs

        def timed(fn, out):
            def wrapped(epoch):
                torch.cuda.synchronize()
                t0, c0 = time.perf_counter(), _counts()
                res = fn(epoch)
                torch.cuda.synchronize()
                c1 = _counts()
                out.append((time.perf_counter() - t0,
                            {k: c1[k] - c0[k] for k in c1}))
                return res
            return wrapped

        def run(epochs, epoch_fn, eval_fn, *a, **kw):
            return self._real(epochs, timed(epoch_fn, self.epochs),
                              timed(eval_fn, self.evals) if eval_fn else None,
                              *a, **kw)

        E._run_epochs = run
        return self

    def __exit__(self, *exc):
        self._mod._run_epochs = self._real


def _vit_b16_f32():
    from scd_tpu_torch.models.vit import ViTConfig

    return ViTConfig(image_size=224, patch_size=16, width=768, depth=12,
                     heads=12)


def baseline_e2e_main(method, seed, root, workdir):
    """``run_baseline_e2e.main`` at ViT-B/16 full width, f32, on the
    fabricated root ``root``: its lines, ms a step, images/s, eval seconds,
    launches; every kernel call held against its plain version.  Returns
    the launches in the steps and in the evals."""
    import torch

    from scd_tpu_torch.testing.fabricate import fabricated_images
    from scd_tpu_torch.train import run_baseline_e2e

    ckpt_dir = os.path.join(workdir, f"ckpt_{method}")
    argv = ["--method", method, "--dataset_name", "imagenet_100",
            "--root_dir", root, "--vit", "base", "--patch_size", "16",
            "--image_size", "224", "--batch_size", str(E2E_BATCH),
            "--epochs", str(E2E_EPOCHS), "--steps_per_epoch",
            str(E2E_STEPS), "--overcluster_factor", "3", "--ckpt_dir",
            ckpt_dir, "--seed", str(seed)]
    print("  python -m scd_tpu_torch.train.run_baseline_e2e " + " ".join(
        "<root>" if a == root else "<dir>" if a == ckpt_dir else a
        for a in argv))
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    # 256 px images: the imagenet transforms' resize to 256 is the identity
    with fabricated_images(seed, size=256), _EpochProbe() as probe, \
            path_inputs() as seen, contextlib.redirect_stdout(buf):
        state, history = run_baseline_e2e.main(argv)
    wall = time.perf_counter() - t0
    for ln in buf.getvalue().splitlines():
        print("    " + ln)
    passes = 1 if method == "uno" else 2  # backbone passes a step
    steps = E2E_EPOCHS * E2E_STEPS
    step_launch = {k: sum(e[1][k] for e in probe.epochs)
                   for k in ("attention", "attention_bwd", "fused_em_step",
                             "attention_f32", "attention_bwd_f32")}
    eval_launch = {k: sum(e[1][k] for e in probe.evals)
                   for k in ("attention", "attention_bwd", "attention_f32")}
    epoch_s = [e[0] for e in probe.epochs]
    ms_step = 1e3 * sum(epoch_s) / steps
    print(f"  {method}: {steps} steps, {ms_step:.1f} ms a step (host clock; "
          f"augmentation of {E2E_BATCH} x 2 views included), "
          f"{E2E_BATCH * 1e3 / ms_step:.1f} images/s; epochs "
          f"{', '.join(f'{t:.2f}' for t in epoch_s)} s; evals "
          f"{', '.join(f'{e[0]:.2f}' for e in probe.evals)} s; main "
          f"{wall:.1f} s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  {method}: launches in the steps {step_launch}, in the evals "
          f"{eval_launch}")
    check(step_launch["attention"] == 12 * passes * steps
          and step_launch["attention_bwd"] == 12 * passes * steps,
          f"{method}_e2e: launches in the steps {step_launch}")
    check(step_launch["attention_f32"] == step_launch["attention"]
          and step_launch["attention_bwd_f32"] == step_launch["attention_bwd"],
          f"{method}_e2e: not every f32 launch took the kernels at head_dim "
          f"64: {step_launch}")
    check(eval_launch["attention"] > 0 and eval_launch["attention_bwd"] == 0,
          f"{method}_e2e: launches in the evals {eval_launch}")
    check(len(history) == E2E_EPOCHS and all(
        math.isfinite(h["loss"]) and 0.0 <= h["acc"] <= 1.0
        for h in history), f"{method}_e2e: history {history}")
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    check(manifest["steps"] == list(range(E2E_EPOCHS))
          and manifest["best_step"] is not None
          and os.path.exists(os.path.join(ckpt_dir, "ckpt_best.pt")),
          f"{method}_e2e: manifest {manifest}")
    if method == "uno":
        check(0 <= state["best_head"] < 4, f"best head {state['best_head']}")
    hold_path_inputs(seen, f"{method}_e2e")
    del state
    return step_launch, eval_launch


def _e2e_batch(seed, n):
    """``n`` images x 2 views at 224 (normalized-scale noise), labels in
    [0, 100), the labelled rows among the first 50 classes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    views = rng.standard_normal((2, n, 224, 224, 3)).astype(np.float32)
    labels = rng.integers(0, 2 * BASELINE_LABELED, n)
    mask = (labels < BASELINE_LABELED) & (rng.random(n) < 0.5)
    mask[0], labels[0] = True, 3  # one labelled row at least
    return views, labels, mask


def _e2e_trainer(method):
    """(the model of ``train_{method}_e2e`` at ViT-B/16 f32 with 50 + 50
    classes, a function running the trainer on an in-memory batch)."""
    from scd_tpu_torch.train import baselines_e2e as E

    nl = BASELINE_LABELED
    if method == "uno":
        def model(seed):
            return E.UNOModel(_vit_b16_f32(), 4, 2 * nl, nl + nl * 3)

        def run(seed, views, labels, mask, device, **kw):
            return E.train_uno_e2e(
                seed, views, labels, mask, nl, nl, _vit_b16_f32(),
                num_heads=4, batch_size=len(labels), overcluster_factor=3,
                device=device, **kw)
    else:
        def model(seed):
            return E.AutoNovelModel(_vit_b16_f32(), nl, nl)

        def run(seed, views, labels, mask, device, **kw):
            return E.train_autonovel_e2e(
                seed, views[0], views[1], labels, mask, nl, nl,
                _vit_b16_f32(), batch_size=len(labels), device=device, **kw)
    return model, run


def e2e_step_card_against_cpu(method, seed):
    """One f32 step of ``train_{method}_e2e`` at ViT-B/16 full width on
    the card and on the CPU from the same parameters (the port's seeded
    init, carried to both) and one batch of 4 images x 2 views: phase 10's
    gates on the loss and on every update; the card's kernel calls held
    against their plain versions."""
    import torch

    from scd_tpu_torch.models.params import flax_init_
    from scd_tpu_torch.train import baselines as B

    make, run = _e2e_trainer(method)
    init = flax_init_(make(seed), seed).state_dict()
    views, labels, mask = _e2e_batch(seed + 7, E2E_CPU_IMAGES)
    real, out = B._init_params, {}
    t0 = time.perf_counter()
    try:
        B._init_params = lambda model, _seed: (model.load_state_dict(init),
                                               model)[1]
        for dev in ("cuda", "cpu"):
            _reset_counts()
            with contextlib.ExitStack() as stack:
                seen = (stack.enter_context(path_inputs())
                        if dev == "cuda" else None)
                state, _p, hist = run(seed, views, labels, mask, dev,
                                      epochs=1, lr=0.1)
            out[dev] = (state["model"].state_dict(), hist[0]["loss"],
                        _counts())
            if dev == "cuda":
                hold_path_inputs(seen, f"{method} f32 step")
            del state
    finally:
        B._init_params = real
    (card, loss_card, counts), (cpu, loss_cpu, _c) = out["cuda"], out["cpu"]
    passes = 1 if method == "uno" else 2
    check(counts["attention_bwd"] == 12 * passes
          and counts["attention"] == 12 * passes,
          f"{method} card step: launches {counts}")
    check(abs(loss_card - loss_cpu) <= STEP_LOSS_RTOL * abs(loss_cpu),
          f"{method} card step loss {loss_card} vs CPU {loss_cpu}")
    worst_cos, worst_err = 1.0, 0.0
    for name, w in cpu.items():
        du = (card[name].cpu() - init[name]).double()
        dw = (w - init[name]).double()
        if dw.norm().item() == 0:  # a zero leaf no loss reaches (head2.bias)
            check(du.norm().item() == 0, f"{method} {name}: moved on the "
                  f"card only")
            continue
        cos = ((du * dw).sum() / (du.norm() * dw.norm())).item()
        err = ((du - dw).abs().max() / dw.abs().max()).item()
        worst_cos, worst_err = min(worst_cos, cos), max(worst_err, err)
        check(cos >= STEP_COS_MIN and err <= STEP_UPDATE_TOL,
              f"{method} {name}: update cosine {cos:.6f}, error {err:.2e} "
              f"of its largest element")
    print(f"  {method}: one f32 step, 2 x {E2E_CPU_IMAGES} images, every "
          f"block trainable: loss card {loss_card:.6f} CPU {loss_cpu:.6f}; "
          f"{len(cpu)} updates: min cosine {worst_cos:.7f}, max error "
          f"{worst_err:.2e} of the largest element; "
          f"{time.perf_counter() - t0:.1f} s")


def e2e_device_step(method, seed):
    """A step of ``train_{method}_e2e`` (the trainer's own ``step``) on a
    fixed device batch of 64 x 2 views: CUDA-event ms, peak memory above
    the resident model, and one profiled step by kernel.  Returns the
    ms."""
    import numpy as np
    import torch

    from scd_tpu_torch.train import baselines_e2e as E

    views, labels, mask = _e2e_batch(seed + 8, E2E_BATCH)
    nl = BASELINE_LABELED
    if method == "uno":
        state, _p, _h = E.train_uno_e2e(
            seed, lambda _e, _r: iter([(views, labels, mask)]),
            n_labeled=nl, n_unlabeled=nl, vit_cfg=_vit_b16_f32(),
            num_heads=4, epochs=1, batch_size=E2E_BATCH,
            overcluster_factor=3, steps_per_epoch=1, device="cuda")
    else:
        state, _p, _h = E.train_autonovel_e2e(
            seed, lambda _e, _r: iter([(views[0], views[1], labels, mask)]),
            n_labeled=nl, n_unlabeled=nl, vit_cfg=_vit_b16_f32(), epochs=1,
            batch_size=E2E_BATCH, device="cuda")
    v = torch.as_tensor(views).cuda()
    lab = torch.as_tensor(labels).cuda()
    m = torch.as_tensor(mask).cuda()
    step = state["step"]
    if method == "uno":
        def one():
            return step(v, lab, m)
    else:
        def one():
            return step(v[0], v[1], lab, m, np.float32(0.3369))
    one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    one()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = cuda_ms(one, reps=3, warmup=1)
    print(f"  {method}: a device step on a fixed batch of {E2E_BATCH} x 2 "
          f"views (f32, all 12 blocks): {ms:.2f} ms (CUDA events), "
          f"{E2E_BATCH * 1e3 / ms:.1f} images/s; peak memory of a step "
          f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above "
          f"the resident {base / 2**30:.2f} GiB)")
    profile_by_kernel(one, top=10)
    del state, v
    return ms


def e2e_step_image256(seed):
    """One UNO step at image 256 (ViT-B/16 f32, L 257: the f32 forward
    and gradient kernels past 256 keys, where the SIMT gradient raised) on
    a fixed device batch of 64 x 2 views: a finite loss, both f32 kernels
    launched 12 times in the step, its CUDA-event ms, and every kernel
    call of the step held against its plain version on the step's
    arguments (``path_inputs``)."""
    import numpy as np
    import torch

    from scd_tpu_torch.models.vit import ViTConfig
    from scd_tpu_torch.train import baselines_e2e as E

    px, nl = 256, BASELINE_LABELED
    vit = ViTConfig(image_size=px, patch_size=16, width=768, depth=12,
                    heads=12)
    rng = np.random.default_rng(seed + 9)
    views = rng.standard_normal((2, E2E_BATCH, px, px, 3)).astype(np.float32)
    labels = rng.integers(0, 2 * nl, E2E_BATCH)
    mask = labels < nl
    state, _p, _h = E.train_uno_e2e(
        seed, lambda _e, _r: iter([(views, labels, mask)]), n_labeled=nl,
        n_unlabeled=nl, vit_cfg=vit, num_heads=4, epochs=1,
        batch_size=E2E_BATCH, overcluster_factor=3, steps_per_epoch=1,
        device="cuda")
    v = torch.as_tensor(views).cuda()
    lab = torch.as_tensor(labels).cuda()
    m = torch.as_tensor(mask).cuda()
    step = state["step"]
    _reset_counts()
    with path_inputs() as seen:
        loss, _per_head = step(v, lab, m)
        torch.cuda.synchronize()
    counts = _counts()
    check(math.isfinite(loss.item()), f"uno image-256 step: loss {loss}")
    check(counts["attention_f32"] == 12 and counts["attention_bwd_f32"] == 12,
          f"uno image-256 step: launches {counts}")
    ms = cuda_ms(lambda: step(v, lab, m), reps=2, warmup=0)
    print(f"  uno: a device step at image {px} (L 257) on a fixed batch of "
          f"{E2E_BATCH} x 2 views (f32, all 12 blocks): loss "
          f"{loss.item():.6f}, {ms:.2f} ms (CUDA events); the f32 forward "
          f"and gradient kernels {counts['attention_f32']} and "
          f"{counts['attention_bwd_f32']} launches")
    hold_path_inputs(seen, "uno image-256 step")
    del state, v


def baselines_frozen(seed, workdir):
    """``run_baseline.main`` for uno, autonovel and supervised over phase
    7's ImageNet-100-scale store on the card (1 epoch); then each trainer
    card against CPU on the store's first BASELINE_SUBSET rows from one
    init.  Returns the launches of the three mains."""
    import numpy as np
    import torch

    from scd_tpu_torch.train import baselines as B
    from scd_tpu_torch.train import run_baseline

    path = write_features_packed(seed, os.path.join(workdir,
                                                    "features_packed.npz"))
    launches = {"fused_em_step": 0}
    for method in ("uno", "autonovel", "supervised"):
        argv = ["--method", method, "--features", path, "--n_labeled",
                str(BASELINE_LABELED), "--epochs", "1", "--seed", str(seed)]
        _reset_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with path_inputs() as seen, contextlib.redirect_stdout(buf):
            _accs, history = run_baseline.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        for ln in buf.getvalue().splitlines():
            print("    " + ln)
        print(f"  run_baseline --method {method} (N {RUNNER_N}, 1 epoch): "
              f"{wall:.2f} s; launches {counts}")
        check(all(math.isfinite(h) for h in history),
              f"run_baseline {method}: history {history}")
        if method == "supervised":
            check(counts["fused_em_step"] > 0,
                  "run_baseline supervised: fused_em_step never launched")
        launches["fused_em_step"] += counts["fused_em_step"]
        hold_path_inputs(seen, f"run_baseline {method}")

    with np.load(path) as z:
        x = np.asarray(z["features"], np.float32)[:BASELINE_SUBSET]
        y = np.asarray(z["targets"], np.int64)[:BASELINE_SUBSET]
        m = np.asarray(z["mask_lab"], bool)[:BASELINE_SUBSET]
    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    views = run_baseline._views(x, 0.05, seed)
    nl, nu = BASELINE_LABELED, int(y.max()) + 1 - BASELINE_LABELED
    runs = {
        "uno": lambda dev: B.train_uno(seed, views, y, m, nl, nu, epochs=1,
                                       seed=seed, device=dev),
        "autonovel": lambda dev: B.train_autonovel(
            seed, views[0], views[1], y, m, nl, nu, epochs=1, seed=seed,
            device=dev),
        "supervised": lambda dev: B.train_supervised(
            seed, x[m], y[m], nl, epochs=1, seed=seed, device=dev)}
    for method, fn in runs.items():
        out = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            _model, pred, hist = fn(dev)
            res = pred(x)
            if method == "supervised":
                res = B.osr_threshold_preds(res, 0.5)
            out[dev] = (hist, res.cpu().numpy(), time.perf_counter() - t0)
        (hc, pc, tc), (hp, pp, tp) = out["cuda"], out["cpu"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(hc, hp))
        agree = float((pc == pp).mean())
        print(f"  {method} on {BASELINE_SUBSET} rows, card vs CPU: losses "
              f"{hc} vs {hp} ({rel:.2e} relative), predictions equal on "
              f"{agree:.5f} of the rows; {tc:.2f} s vs {tp:.2f} s")
        check(rel <= FROZEN_LOSS_RTOL and agree >= FROZEN_AGREE,
              f"{method} frozen trainer card vs CPU: {rel}, {agree}")
    return launches


def resnet_towers(seed):
    """The ResNet-50 tower at bf16 (the ``resnet50`` branch of
    ``build_encoders``: folded weights from a fabricated torchvision state
    dict, ImageNet normalisation on the device) on a batch of 128 images
    at 224, card vs CPU (f32) on 8 of them, ms a batch; the two-head
    ResNet-18 (f32, 32 px) the same way."""
    import numpy as np
    import torch

    from scd_tpu_torch.data.transforms import device_normalize_imagenet
    from scd_tpu_torch.models import (ResNet50, ResNet50Config,
                                      ResNetTwoHead, load_resnet50_weights,
                                      params_from_flax)
    from scd_tpu_torch.models.params import flax_init_
    from scd_tpu_torch.testing.fabricate import resnet50_state_dict

    sd = resnet50_state_dict(ResNet50Config(), seed)
    towers = {}
    for dev, dt in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        cfg = ResNet50Config(compute_dtype=dt)
        towers[dev] = ResNet50(cfg, device=dev).eval()
        towers[dev].load_state_dict(params_from_flax(
            load_resnet50_weights(sd, cfg)))
    images = np.random.default_rng(seed).integers(
        0, 256, (R50_BATCH, 224, 224, 3), dtype=np.uint8)
    x = torch.as_tensor(images).cuda()
    with torch.inference_mode():
        def card():
            return towers["cuda"](device_normalize_imagenet(x))

        got = card()
        ms = cuda_ms(card, reps=10, warmup=2)
        want = towers["cpu"](device_normalize_imagenet(
            torch.as_tensor(images[:R50_CPU_IMAGES])))
    cos = _row_cos(got[:R50_CPU_IMAGES].cpu(), want)
    print(f"  ResNet-50 bf16, batch {R50_BATCH} at 224: {ms:.3f} ms a batch "
          f"({R50_BATCH * 1e3 / ms:.1f} images/s); features [{got.shape[0]}, "
          f"{got.shape[1]}], cosine to the CPU's f32 on {R50_CPU_IMAGES}: min "
          f"{cos.min().item():.6f}")
    check(bool(torch.isfinite(got).all()) and got.shape == (R50_BATCH, 2048)
          and cos.min().item() >= R50_COS, "ResNet-50 card vs CPU")
    del towers, x, got

    two = flax_init_(ResNetTwoHead(50, 50), seed)
    card_m = ResNetTwoHead(50, 50, device="cuda").eval()
    card_m.load_state_dict(two.state_dict())
    xs = torch.as_tensor(np.random.default_rng(seed + 1).standard_normal(
        (R50_BATCH, 32, 32, 3)).astype(np.float32))
    xc = xs.cuda()
    with torch.inference_mode():
        out = card_m(xc)
        ms2 = cuda_ms(lambda: card_m(xc), reps=10, warmup=2)
        ref = two(xs[:R50_CPU_IMAGES])
    coss = [_row_cos(a[:R50_CPU_IMAGES].cpu(), b).min().item()
            for a, b in zip(out, ref)]
    print(f"  ResNetTwoHead (ResNet-18, f32), batch {R50_BATCH} at 32: "
          f"{ms2:.3f} ms a batch; cosine to the CPU (head1, head2, feats): "
          + ", ".join(f"{c:.7f}" for c in coss))
    check(all(c >= RESNET_F32_COS for c in coss),
          "ResNetTwoHead card vs CPU")


def phase_baselines(seed, workdir):
    """Phase 11 (see the module docstring); returns the launches of its
    main paths."""
    from scd_tpu_torch.testing.fabricate import (fabricate_imagenet_tree,
                                                 imagenet100_config)

    t0 = time.perf_counter()
    cfg = imagenet100_config(os.path.join(workdir, "in100"))
    fabricate_imagenet_tree(cfg, TRAIN_ROOT_IMAGES, TRAIN_ROOT_VOCAB, 20)
    launches = {}
    for method in ("uno", "autonovel"):
        steps, evals = baseline_e2e_main(method, seed, cfg.data.root_dir,
                                         workdir)
        launches[f"{method}_e2e"] = {
            "attention": steps["attention"] + evals["attention"],
            "attention_bwd": steps["attention_bwd"],
            "attention_f32": steps["attention_f32"] + evals["attention_f32"],
            "attention_bwd_f32": steps["attention_bwd_f32"]}
    print(f"end-to-end mains {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for method in ("uno", "autonovel"):
        e2e_step_card_against_cpu(method, seed)
        e2e_device_step(method, seed)
    e2e_step_image256(seed)
    print(f"card against CPU and device steps "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches["run_baseline"] = baselines_frozen(seed, workdir)
    print(f"frozen-feature baselines {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    resnet_towers(seed)
    print(f"ResNet towers {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------- phase 12

# the prefix-KV vocabulary build: names (one chunk of the build), and the
# prefix kernel's heads and head_dim (the CLIP text tower's 8 x 64)
PREFIX_NAMES, PREFIX_CHUNK, PREFIX_P, TEXT_H, TEXT_D = 8_192, 8_192, 16, 8, 64
# names too long for the suffix rows (the fallback route), timed apart
# with PREFIX_MIXED of the short names
PREFIX_LONG, PREFIX_MIXED = 128, 1_024
# - the prefix-built [512, 8,192] matrix against the full-row-built one,
#   both through the bf16 text tower on the card: the same math, but
#   activations rounded to bf16 after products grouped otherwise (the
#   prefix K / V from [T, P] rows, suffixes in their own bucket, cuBLAS
#   picking other tilings), through 12 blocks, then the mean over 80
#   templates.  Read on an H100 at this seed: min 0.9999999 (the JAX
#   package read 0.999999 on its chip)
PREFIX_COS_TOL = 0.9999


def prefix_parity(p_valid, dtype, gen, b=PREFIX_NAMES, s=16, n_pre=PREFIX_P,
                  tag="", inputs=None, scale=None):
    """The prefix attention kernel against its plain version on one shape
    (q, k, v views of a packed qkv made from ``gen`` at H 8, d 64, or
    ``inputs`` = (q, k, v, pk, pv)), with :func:`attention_parity`'s
    tolerances (max|v| over the prefix's values and the suffix's); two
    runs must repeat their bits, on the ``mma.sync`` kernel exactly where
    :func:`prefix_route` says so.  Returns (max abs error, the inputs)."""
    import torch

    from scd_tpu_torch.ops import attention as A

    if inputs is None:
        _, (q, k, v) = _attn_inputs(b, s, TEXT_H, TEXT_D, dtype, True, gen)
        pk, pv = (torch.randn(n_pre, TEXT_H, TEXT_D, generator=gen,
                              device="cuda").to(dtype) for _ in range(2))
        inputs = (q, k, v, pk, pv)
    q, k, v, pk, pv = inputs
    b, s, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    route = A.prefix_route(q.dtype, d)
    mma_before = A.prefix_attention_cuda.mma_launches
    got = A.prefix_attention(*inputs, scale, p_valid)
    again = A.prefix_attention(*inputs, scale, p_valid)
    torch.cuda.synchronize()
    name = f"prefix attention {tag}"
    check(A.prefix_attention_cuda.mma_launches - mma_before
          == 2 * (route == "mma"), f"{name}: not on the {route} kernel")
    check(torch.equal(got, again), f"{name}: two runs differ")
    want = A.prefix_attention_plain(*inputs, scale, p_valid)
    err = (got.float() - want.float()).abs()
    vmax = max(v.float().abs().max().item(), pv.float().abs().max().item())
    if dtype == torch.bfloat16:
        bound = ATTN_BF16_REL * want.float().abs() + ATTN_BF16_VREL * vmax
    else:
        bound = torch.full_like(err, ATTN_F32_VREL * vmax)
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    check(bool((err <= bound).all()), f"{name}: error {err.max().item():.3e} "
          f"beyond the stated bound")
    print(f"  {name} B={b} S={s} P={pk.shape[0]} p_valid={p_valid} H={h} "
          f"d={d} {str(dtype)[6:]} ({route}): max abs err "
          f"{err.max().item():.3e} "
          f"(max |v| {vmax:.2f})")
    return err.max().item(), inputs


def _prefix_bound(b, s, n_pre, p_valid, h, d, elt):
    """q, k, v, the output ([B, S, H, d]) and pk, pv ([P, H, d]) moved once;
    the products of the pairs this input keeps (p_valid prefix keys and
    the causal suffix keys of each row) in q . k and p . v, at the bf16
    tensor-core peak (bf16) or the f32 SIMT peak (f32: exact products)."""
    pairs = sum(min(p_valid, n_pre) + i + 1 for i in range(s))
    ops = 4.0 * b * h * d * pairs
    return _bound(ops, PEAK_BF16_FLOPS if elt == 2 else PEAK_F32_FLOPS,
                  elt * (4.0 * b * s * h * d + 2.0 * n_pre * h * d))


def time_prefix_attention(inputs, p_valid, scale, other=None):
    """(kernel ms, plain ms, SDPA ms, bound ms, bound_by) on ``inputs``.
    SDPA, the yardstick, takes the same function as one call on the
    [prefix, suffix] keys concatenated beforehand (outside its time) with
    a boolean mask; its result is printed against the kernel's.  With
    ``other`` (another build of ``prefix_attention.cu``, e.g. the parent
    commit's SIMT kernel), its ``prefix_attention_fwd`` is timed in turns,
    other, this, this, other, on the same inputs and held against the
    kernel's output."""
    import torch
    import torch.nn.functional as F

    from scd_tpu_torch.ops import attention as A

    q, k, v, pk, pv = inputs
    b, s, h, d = q.shape
    n_pre = pk.shape[0]

    def kern():
        return A.prefix_attention_cuda(*inputs, scale, p_valid)

    if other is not None:
        def then():
            return A.prefix_attention_fwd(other, *inputs, scale, p_valid,
                                          False)

        diff = (then().float() - kern().float()).abs().max().item()
        t_other = cuda_ms(then, reps=50)
        ms = cuda_ms(kern, reps=50)
        again = cuda_ms(kern, reps=50)
        t_other2 = cuda_ms(then, reps=50)
        line = (f"kernel {ms:.4f} ms (again {again:.4f}), other build "
                f"{t_other:.4f} ms (again {t_other2:.4f}), max |kernel - "
                f"other| {diff:.3e},")
    else:
        ms = cuda_ms(kern, reps=50)
        line = f"kernel {ms:.4f} ms,"
    plain_ms = cuda_ms(lambda: A.prefix_attention_plain(*inputs, scale,
                                                        p_valid), reps=5)
    qh = q.transpose(1, 2)
    kh = torch.cat([pk.expand(b, n_pre, h, d), k], 1).transpose(1, 2)
    vh = torch.cat([pv.expand(b, n_pre, h, d), v], 1).transpose(1, 2)
    mask = torch.cat([
        (torch.arange(n_pre, device=q.device) < p_valid).expand(s, n_pre),
        torch.ones(s, s, dtype=torch.bool, device=q.device).tril()], 1)

    def sdpa():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                              scale=scale)

    lib_ms = cuda_ms(sdpa, reps=50)
    diff = (sdpa().transpose(1, 2).float() - kern().float()
            ).abs().max().item()
    bound_ms, by = _prefix_bound(b, s, n_pre, p_valid, h, d,
                                 q.element_size())
    print(f"  prefix attention B={b} S={s} P={n_pre} p_valid={p_valid} "
          f"{str(q.dtype)[6:]} ({A.prefix_route(q.dtype, d)}): {line} "
          f"plain {plain_ms:.4f}, SDPA {lib_ms:.4f} (max |SDPA - kernel| "
          f"{diff:.3e}), bound {bound_ms:.4f} ({by}), {ms / bound_ms:.2f}x "
          f"the bound", flush=True)
    return ms, plain_ms, lib_ms, bound_ms, by


def phase_prefix_vocab(seed: int, workdir: str, against=None,
                       profile=False):
    """The prefix-KV vocabulary build (``SCD_PREFIX_VOCAB=1``) at the
    full-width CLIP ViT-B/16 text tower (bf16): the kernel against its
    plain version, the build against the full-row build, their times
    (with ``against``, a ``prefix_attention.cu`` such as the parent
    commit's, that build's SIMT kernel timed beside; with ``profile``,
    one more cached-name prefix build under ``torch.profiler``, ~20 s on
    an H100, most of it the profiler's).  Returns (the
    ``mma.sync`` kernel's launches in the build, max abs error, the
    kernels line's times)."""
    import dataclasses

    import numpy as np
    import torch

    from scd_tpu_torch.models import clip_vit_b16_config, dino_vit_b16_config
    from scd_tpu_torch.naming import zeroshot as zs
    from scd_tpu_torch.naming.templates import IMAGENET_TEMPLATES
    from scd_tpu_torch.pipelines.unsup import build_encoders
    from scd_tpu_torch.testing.fabricate import (cold_config,
                                                 fabricate_cold_root,
                                                 short_names)

    # ---- (a) the kernel against its plain version at the build's shapes
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    bf16, f32 = torch.bfloat16, torch.float32
    err = max(prefix_parity(PREFIX_P, bf16, gen, s=16, tag="S16")[0],
              prefix_parity(PREFIX_P, bf16, gen, s=8, tag="S8")[0],
              prefix_parity(11, bf16, gen, s=16, tag="S16 p_valid<P")[0])
    prefix_parity(11, f32, gen, b=1_024, s=16, tag="f32")

    # ---- the text tower of build_encoders (dense_int8 off) on a cold root
    t0 = time.perf_counter()
    cfg = cold_config(os.path.join(workdir, "prefix"), dense_int8=False,
                      batch_size=BATCH, num_workers=1)
    cfg = cfg.replace(feature=dataclasses.replace(cfg.feature,
                                                  feat_model="clip"))
    info = fabricate_cold_root(
        cfg, clip_vit_b16_config(),
        dino_vit_b16_config(gelu_tanh=cfg.feature.gelu_tanh), seed=seed,
        n_images=100, vocab=PREFIX_NAMES)
    encode_text = build_encoders(cfg, {}, device="cuda")[2]
    check(hasattr(encode_text, "prefix_forward")
          and hasattr(encode_text, "suffix_forward"),
          "build_encoders set no prefix hooks with dense_int8 off")
    # one chunk of names of one to three tokens (short_names, in the JAX
    # package's word mix: the random merges split the root's own names
    # into nine tokens), all cached; then PREFIX_MIXED of them with the
    # root's last PREFIX_LONG names, which take the fallback route
    names = short_names(encode_text.tokenize, PREFIX_NAMES, seed)
    mixed = names[:PREFIX_MIXED] + info["nouns"][-PREFIX_LONG:]
    plans = {}
    for tag, nm in (("cached", names), ("mixed", mixed)):
        cached, fallback_t, cached_n, fallback_n = zs.prefix_plan(
            encode_text.tokenize, nm, IMAGENET_TEMPLATES)[:4]
        plans[tag] = (len(cached), -(-len(cached_n) // PREFIX_CHUNK),
                      len(fallback_n), len(fallback_t))
        print(f"{tag} names: {len(nm)} names x {len(IMAGENET_TEMPLATES)} "
              f"templates: {len(cached)} cached templates, "
              f"{len(fallback_t)} fallback templates, {len(cached_n)} "
              f"cached names in {plans[tag][1]} chunk(s), "
              f"{len(fallback_n)} fallback names")
    check(plans["cached"][2] == 0, "a short name took the fallback route")
    check(plans["mixed"][2] == PREFIX_LONG,
          "the root's names did not all take the fallback route")
    print(f"CLIP ViT-B/16 (bf16) from build_encoders and the names in "
          f"{time.perf_counter() - t0:.1f} s")

    env = os.environ.get("SCD_PREFIX_VOCAB")

    def build(prefix, nm):
        os.environ["SCD_PREFIX_VOCAB"] = "1" if prefix else "0"
        torch.cuda.synchronize()
        t = time.perf_counter()
        w = zs.build_zeroshot_weights(encode_text, nm, IMAGENET_TEMPLATES)
        torch.cuda.synchronize()
        return w, time.perf_counter() - t

    def both(tag, nm):
        """The prefix build (counted) and the full-row build on ``nm``,
        each warm; gates on the launches and the column cosine.  Returns
        (the prefix build's launches, its prompts/s)."""
        _reset_counts()
        w_pre, t_pre = build(True, nm)
        launches = _counts()
        w_full, t_full = build(False, nm)
        n_cached, chunks, n_fallback, n_fallback_t = plans[tag]
        print(f"launches in the prefix build ({tag} names): {launches}")
        want = 12 * n_cached * chunks
        check(launches["prefix_attention"] == want,
              f"{tag}: prefix_attention launched "
              f"{launches['prefix_attention']} times, not 12 x {n_cached} "
              f"x {chunks} = {want}")
        check(launches["prefix_attention_mma"] == want,
              f"{tag}: {launches['prefix_attention_mma']} of {want} prefix "
              f"launches on the mma.sync kernel")
        check(launches["attention"] > 0 or not (n_fallback or n_fallback_t),
              f"{tag}: the fallbacks ran no full-row attention")
        check(w_pre.shape == w_full.shape == (D_CLIP, len(nm))
              and bool(np.isfinite(w_pre).all()),
              f"{tag}: prefix build: bad matrix")
        cos = _row_cos(w_pre.T, w_full.T)
        prompts = len(nm) * len(IMAGENET_TEMPLATES)
        print(f"{tag} names ({len(nm)}, {n_fallback} fallback): prefix "
              f"build {t_pre:.3f} s ({prompts / t_pre:.1f} prompts/s), "
              f"full-row build {t_full:.3f} s ({prompts / t_full:.1f} "
              f"prompts/s), warm; column cosine min "
              f"{cos.min().item():.7f}, mean {cos.mean().item():.7f} "
              f"(tolerance {PREFIX_COS_TOL})")
        check(cos.min().item() >= PREFIX_COS_TOL,
              f"{tag}: the prefix build disagrees with the full-row build")
        return launches

    try:
        # ---- (b) the build: first under path_inputs (it warms the card
        # and copies each prefix-kernel call's arguments, one per shape),
        # then counted and timed against the full-row build (warmed
        # first), on the cached names and then on the mixed ones
        with path_inputs() as seen:
            build(True, names)
        build(False, names[:256])
        launches = both("cached", names)
        both("mixed", mixed)
        if profile:  # where the cached-name prefix build's device time goes
            os.environ["SCD_PREFIX_VOCAB"] = "1"
            print("the prefix build (cached names) under torch.profiler:")
            profile_by_kernel(lambda: zs.build_zeroshot_weights(
                encode_text, names, IMAGENET_TEMPLATES))
    finally:
        if env is None:
            os.environ.pop("SCD_PREFIX_VOCAB", None)
        else:
            os.environ["SCD_PREFIX_VOCAB"] = env

    # ---- every kernel on the arguments the build passed it
    held = list(seen["prefix_attention"].values())
    check(held, "path_inputs saw no prefix-kernel call")
    hold_path_inputs(seen, "prefix build")

    # ---- (c) the kernel alone: at the build's first shape, then both
    # suffix buckets on random inputs; with ``against``, beside that build
    other = None
    if against:
        from scd_tpu_torch.testing.attention_long import build_other

        other = build_other(against)
    else:
        print("  prefix attention: no other build given (--against-prefix)")
    a = held[0]
    times = time_prefix_attention(
        tuple(a[n] for n in ("q", "k", "v", "pk", "pv")), a["p_valid"],
        a["scale"], other)
    for s in (16, 8):
        time_prefix_attention(prefix_parity(PREFIX_P, bf16, gen, s=s,
                                            tag=f"timed S{s}")[1],
                              PREFIX_P, TEXT_D ** -0.5, other)
    return launches["prefix_attention_mma"], err, times


# (kernels line name, source, the TPU kernel it replaces, key of the
# launch count and the times); rows 3-4 share the attention kernel and
# rows 6-7 the w8a8_prequant kernel, and each pair reports that kernel's
# one launch count
KERNELS = [
    ("estep_assign", "scd_tpu_torch/csrc/estep.cu",
     "scd_tpu/ops/pallas_kernels.py:86", "estep_assign"),
    ("topk_softmax", "scd_tpu_torch/csrc/topk_softmax.cu",
     "scd_tpu/ops/pallas_kernels.py:203", "topk_softmax"),
    ("vit_attention", "scd_tpu_torch/csrc/attention.cu",
     "scd_tpu/ops/pallas_kernels.py:309", "attention"),
    ("qkv_attention", "scd_tpu_torch/csrc/attention.cu",
     "scd_tpu/ops/pallas_kernels.py:392", "attention"),
    ("fused_em_step", "scd_tpu_torch/csrc/fused_em.cu",
     "scd_tpu/ops/pallas_kernels.py:545", "fused_em_step"),
    ("dense_w8a8_3d", "scd_tpu_torch/csrc/w8a8.cu",
     "scd_tpu/ops/pallas_kernels.py:696", "w8a8_prequant"),
    ("dense_w8a8", "scd_tpu_torch/csrc/w8a8.cu",
     "scd_tpu/ops/pallas_kernels.py:760", "w8a8_prequant"),
    ("w8a8_fusedq", "scd_tpu_torch/csrc/w8a8.cu",
     "scd_tpu/ops/pallas_kernels.py:876", "w8a8_fusedq"),
    # no TPU kernel: the JAX package differentiates attention with XLA
    # autodiff; launches from phase 10's training steps
    ("attention_bwd", "scd_tpu_torch/csrc/attention_bwd.cu",
     "none: XLA autodiff of scd_tpu/models/vit.py:338",
     "attention_bwd"),
    # the f32 kernels at head_dim 64 (three TF32 passes on wgmma) of the
    # attention and its gradient; launches from phase 11's end-to-end mains
    ("qkv_attention_f32", "scd_tpu_torch/csrc/attention.cu",
     "scd_tpu/ops/pallas_kernels.py:392", "attention_f32"),
    ("attention_bwd_f32", "scd_tpu_torch/csrc/attention_bwd.cu",
     "none: XLA autodiff of scd_tpu/models/vit.py:338",
     "attention_bwd_f32"),
    # no TPU kernel: the JAX package's prefix attention is plain XLA;
    # launches of its mma.sync kernel from phase 12's prefix-KV build
    ("prefix_attention", "scd_tpu_torch/csrc/prefix_attention.cu",
     "none: XLA einsums of scd_tpu/models/vit.py:308 (_prefix_attention)",
     "prefix_attention_mma"),
    # the routes of phase 16, counted apart: the forward's bf16 SIMT
    # kernel (head_dim != 64: the micro ViT) and the gradient's SIMT
    # kernels; launches from phase 16's micro main paths, times at the
    # micro ViT's training shape (B 256 x L 197 x H 2 x d 32, bf16)
    ("attention_simt_bf16", "scd_tpu_torch/csrc/attention.cu",
     "scd_tpu/ops/pallas_kernels.py:309", "attention_simt_bf16"),
    ("attention_bwd_simt", "scd_tpu_torch/csrc/attention_bwd.cu",
     "none: XLA autodiff of scd_tpu/models/vit.py:338",
     "attention_bwd_simt"),
]


# ------------------------------------------------------------- phase 13

# the mesh phase's sizes: images through both ViT-B/16 towers in batches
# split over the ranks, vocabulary names, and the top-k over phase 3's
# unlabelled CLIP rows against its V = 68,000 matrix
MESH_IMAGES = 4_096
MESH_BATCH = 128
MESH_NAMES = 4_000
MESH_TOPK_ROWS = 97_536
MESH_K = 5
# its gates, with their reasons:
# - features and vocabulary columns: each rank runs the bf16 towers on 64
#   rows where one process runs 128, and a kernel may take another tiling
#   at another row count: bf16 rounding only
MESH_COS = 0.9999
# - clustering: the merged sums add two ranks' partial sums (another f32
#   order), which may move a near-tie row
MESH_ARI = 0.999
MESH_ACC = 0.001
# - top-k: the two shards' logits come from the same kernel at V 34,000
#   each; the merge picks the same candidates unless two logits tie to
#   the kernel's rounding
MESH_TOPK_AGREE = 0.9999
MESH_DEADLINE = 420


def _mesh_spec(seed, cfg, workdir):
    """What ``testing/mesh_cases.py``'s card functions run (see there)."""
    from scd_tpu_torch.testing.fabricate import write_bpe_merges

    return {"cfg": cfg, "towers": "vit_b16", "images": MESH_IMAGES,
            "batch": MESH_BATCH, "names": MESH_NAMES,
            "topk_rows": MESH_TOPK_ROWS, "k": MESH_K, "seed": seed,
            "bpe": write_bpe_merges(os.path.join(workdir, "bpe.txt.gz"),
                                    seed)}


def adjusted_rand_score(a, b) -> float:
    """The adjusted Rand index of two labelings (the card's machine has no
    scikit-learn): pair counts of the contingency table against their
    expectation under independence."""
    import numpy as np

    _, ai = np.unique(np.asarray(a), return_inverse=True)
    _, bi = np.unique(np.asarray(b), return_inverse=True)
    table = np.zeros((ai.max() + 1, bi.max() + 1), np.int64)
    np.add.at(table, (ai, bi), 1)

    def pairs(c):
        c = np.asarray(c, np.float64)
        return float((c * (c - 1) / 2).sum())

    n = pairs([len(ai)])
    both = pairs(table)
    rows, cols = pairs(table.sum(1)), pairs(table.sum(0))
    expected = rows * cols / n if n else 0.0
    top = (rows + cols) / 2 - expected
    return 1.0 if top == 0 else (both - expected) / top


def mesh_checks(ref, ranks, u_targets):
    """Hold every rank's sharded stages against the single-process ones:
    returns {rank: {metric: value}} and raises on a failed gate."""
    import numpy as np

    from scd_tpu_torch.metrics import cluster_acc

    acc_ref = cluster_acc(u_targets, ref["clusters"])
    out = {}
    for r, got in enumerate(ranks):
        m = {f"cos_{k}": float(_row_cos(got["features"][k],
                                        ref["features"][k]).min())
             for k in ref["features"]}
        m["cos_vocab"] = float(_row_cos(got["vocabulary"].T,
                                        ref["vocabulary"].T).min())
        m["ari"] = float(adjusted_rand_score(ref["clusters"],
                                             got["clusters"]))
        m["acc"] = float(cluster_acc(u_targets, got["clusters"]))
        m["topk_agree"] = float((got["topk"][1] == ref["topk"][1]).all(
            axis=1).mean())
        m["topk_max_abs_err"] = float(np.abs(got["topk"][0]
                                             - ref["topk"][0]).max())
        out[r] = m
        for key in ("cos_dino", "cos_clip", "cos_vocab"):
            check(m[key] >= MESH_COS, f"rank {r}: {key} {m[key]} < "
                                      f"{MESH_COS}")
        check(m["ari"] >= MESH_ARI, f"rank {r}: ARI {m['ari']} < {MESH_ARI}")
        check(abs(m["acc"] - acc_ref) <= MESH_ACC,
              f"rank {r}: ACC {m['acc']} against {acc_ref}")
        check(m["topk_agree"] >= MESH_TOPK_AGREE,
              f"rank {r}: top-k rows equal {m['topk_agree']}")
        check(all(v > 0 for v in got["launches"].values()),
              f"rank {r}: a kernel never launched: {got['launches']}")
    for other in ranks[1:]:
        for key in ("clusters", "vocabulary"):
            check(np.array_equal(other[key], ranks[0][key]),
                  f"the ranks' {key} differ")
    return out


def phase_mesh(seed: int, cfg, workdir: str):
    """World size 1 over NCCL (an explicit mesh of one rank against the
    mesh-free fit, and the single-process references), then world size 2
    over gloo with both ranks on the card (the sharded stages)."""
    import numpy as np

    from scd_tpu_torch.pipelines.common import feature_cache_key, stage_cache
    from scd_tpu_torch.testing.dist import spawn

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    spec = _mesh_spec(seed, cfg, workdir)
    t0 = time.perf_counter()
    ref, = spawn("scd_tpu_torch.testing.mesh_cases.mesh_stage_references",
                 world=1, backend="nccl", device="cuda", args=(spec,),
                 timeout=MESH_DEADLINE, threads=0)
    t_ref = time.perf_counter() - t0
    sskm = ref["sskm"]
    print(f"world 1 (nccl): fit_sskm with a mesh of one rank against the "
          f"mesh-free call: labels equal {sskm['labels_equal']}, inertia "
          f"{sskm['inertia'][0]!r} / {sskm['inertia'][1]!r}, iterations "
          f"{sskm['n_iter']}; launches {ref['launches_mesh1']}")
    check(sskm["labels_equal"] and sskm["inertia"][0] == sskm["inertia"][1],
          "world 1: the mesh fit differs from the mesh-free fit")
    check(ref["launches_mesh1"]["fused_em_step"] > 0,
          "world 1: fused_em_step never launched under the mesh")
    t0 = time.perf_counter()
    ranks = spawn("scd_tpu_torch.testing.mesh_cases.mesh_stages", world=2,
                  backend="gloo", device="cuda", args=(spec,),
                  timeout=MESH_DEADLINE, threads=0)
    t_mesh = time.perf_counter() - t0
    feats = stage_cache(cfg).load("features", feature_cache_key(cfg, "feat"))
    u_targets = feats["targets"].astype(np.int64)[
        ~feats["mask_lab"].astype(bool)]
    metrics = mesh_checks(ref, ranks, u_targets)
    for r, got in enumerate(ranks):
        print(f"world 2 (gloo, both ranks on the card) rank {r}: "
              f"{json.dumps(metrics[r])}; launches "
              f"{json.dumps(got['launches'])}")
    print(f"stage seconds ({smi}): single process "
          + ", ".join(f"{k} {v:.3f}" for k, v in ref["seconds"].items())
          + f" (world 1 call {t_ref:.1f} s)")
    for r, got in enumerate(ranks):
        print(f"stage seconds ({smi}): world 2 rank {r} "
              + ", ".join(f"{k} {v:.3f}" for k, v in got["seconds"].items())
              + (f" (world 2 call {t_mesh:.1f} s)" if r == 0 else ""))
    return {r: got["launches"] for r, got in enumerate(ranks)}


# ------------------------------------------------------------- phase 14

# the second mesh phase's configurations, each at full width:
# - ConSSKM: phase 8's (the Sinkhorn track, sizes in [SIZE_MIN,
#   SIZE_MAX]) on phase 3's features (130,048 x 768, K 100), cut to
#   MESH_CON_N_INIT restart of the config's 10 (each restart is 10 Lloyd
#   iterations of one Sinkhorn E-step; 3 restarts took 38.6 s a rank at
#   world size 2 on an H100, ~200 dual iterations an E-step, each with two
#   gloo collectives staged through the host)
# - estimate_k: phase 7's kind of features (MESH_EK_ROWS x D_FEAT), max_k
#   MAX_K, the CLI's Brent search from MIN_K, each probe's k-means cut to
#   MESH_EK_N_INIT restart of the objective's 3: with 3, the search took
#   140.2 s a rank at world size 2 (22.5 s in one process) and the phase
#   307.6 s; the halving search instead was slower still (its probes at
#   K 1,000 and 505 draw the most k-means++ centers, each draw a gather
#   and a broadcast through the host) and, its path turning on the
#   objective at K > 500 where rounding moves it, chose K 505 over the
#   ranks and 562 in one process
# - GCD: phase 10's ViT-B/16 bf16 step (TRAIN_IMAGES x 2 views, the last
#   block and the head trainable), MESH_GCD_STEPS fixed batches
# - UNO and AutoNovel: phase 11's ViT-B/16 f32 trainers, E2E_BATCH x 2
#   views, 2 epochs of one step each
# - metric_learn.main over the ranks: 1 epoch of 2 steps on a fabricated
#   root of MESH_ML_IMAGES train images, and MESH_AUG_STEPS batches of
#   its augmentation timed alone
MESH_CON_N_INIT = 1
MESH_EK_METHOD, MESH_EK_N_INIT = "brent", 1
# estimate_k's rows, cut from RUNNER_N (the search took 42.6 s a rank over
# all of them on an H100 host whose smoke ran 1,197.6 s)
MESH_EK_ROWS = 65_024
MESH_GCD_STEPS = 3
MESH_ML_IMAGES, MESH_AUG_STEPS = 1_000, 3
# its gates, with their reasons:
# - ConSSKM: the dual loop's column sums and the M-step's sums merge two
#   ranks' partial sums (another f32 order), which may move a near-tie row
MESH_CON_ACC, MESH_CON_ARI = 1e-3, 0.99
# - estimate_k: the same K; the objective, an ACC over ~32,500 labelled
#   rows, within MESH_EK_OBJ (phase 13's ACC bound).  Not 1e-6: the
#   merged M-step sums (each rank's fused_em_step partial sums, added
#   after) round otherwise than one process's sums over all rows, so
#   near-tie rows flip: from the same centers on an H100, 50 EM
#   iterations at K 99 over these features leave 9 of 130,048 labels
#   apart (836 at K 300, where the later k-means++ draws differ too), and
#   the search's objective at K 99 read 0.98876 over the ranks against
#   0.98863 in one process
MESH_EK_OBJ = 1e-3
# - GCD: the bf16 towers run 64 rows a rank where one process runs 128
#   (another tiling) and the summed gradients add in another order: each
#   step's loss, and the trainable parameters after the last step
MESH_GCD_RTOL, MESH_GCD_COS = 1e-3, 0.9999
# - UNO and AutoNovel, f32: the JAX package's tolerance for its mesh runs
MESH_E2E_RTOL = 2e-4
MESH14_DEADLINE = 900


def _mesh_training_spec(seed, cfg, workdir):
    """What ``testing/mesh_cases.py::mesh_training_stages`` runs."""
    import dataclasses

    import torch

    from scd_tpu_torch.testing.fabricate import (fabricate_imagenet_tree,
                                                 imagenet100_config)

    con = dataclasses.replace(cfg, cluster=dataclasses.replace(
        cfg.cluster, algorithm="ConSSKM", size_min=SIZE_MIN,
        size_max=SIZE_MAX, constrained_backend="sinkhorn",
        n_init=MESH_CON_N_INIT))
    ml = imagenet100_config(os.path.join(workdir, "in100_train"))
    fabricate_imagenet_tree(ml, MESH_ML_IMAGES, TRAIN_ROOT_VOCAB, 20)
    vit = dict(image_size=224, patch_size=16, width=768, depth=12, heads=12)
    return {
        "cfg": con, "seed": seed,
        "estimate_k": {"path": write_features_packed(
            seed, os.path.join(workdir, "features_packed.npz"),
            n=MESH_EK_ROWS),
            "min_k": MIN_K, "max_k": MAX_K, "method": MESH_EK_METHOD,
            "n_init": MESH_EK_N_INIT},
        "gcd": {"vit": dict(vit, compute_dtype=torch.bfloat16),
                "train": dict(lr=0.1, sup_con_weight=0.35,
                              grad_from_block=GRAD_FROM_BLOCK,
                              n_views=TRAIN_VIEWS, proj_dim=PROJ_DIM,
                              batch_size=TRAIN_IMAGES),
                "total_steps": 20, "global_batch": TRAIN_IMAGES,
                "steps": MESH_GCD_STEPS, "seed": seed, "image_size": 224,
                "views": TRAIN_VIEWS, "return_params": True},
        "e2e": {"vit": vit, "images": E2E_BATCH, "seed": seed + 5,
                "n_labeled": BASELINE_LABELED, "num_heads": 4,
                "overcluster_factor": 3,
                "kw": {m: dict(epochs=2, batch_size=E2E_BATCH)
                       for m in ("uno", "autonovel")}},
        "augment": {"root": ml.data.root_dir, "image_size": 224,
                    "batch": TRAIN_IMAGES, "steps": MESH_AUG_STEPS,
                    "workers": 8, "seed": seed},
        "metric_learn": [
            "--dataset_name", "imagenet_100", "--root_dir", ml.data.root_dir,
            "--vit", "base", "--image_size", "224", "--batch_size",
            str(TRAIN_IMAGES), "--grad_from_block", str(GRAD_FROM_BLOCK),
            "--proj_dim", str(PROJ_DIM), "--epochs", "1",
            "--steps_per_epoch", "2", "--max_kmeans_iter", "10",
            "--exp_root", os.path.join(workdir, "runs"), "--device",
            "cuda"]}


def _cos64(a, b) -> float:
    import numpy as np

    a = np.ravel(a).astype(np.float64)
    b = np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def mesh_training_checks(ref, ranks, u_targets):
    """Hold every rank's phase-14 stages against the single-process ones
    (raises on a failed gate); returns {rank: {metric: value}}."""
    import numpy as np

    from scd_tpu_torch.metrics import cluster_acc

    out = {}
    acc_ref = cluster_acc(u_targets, ref["consskm"]["u_preds"])
    g_ref = ref["gcd"]
    for r, got in enumerate(ranks):
        m = {}
        con = got["consskm"]
        sizes = np.bincount(con["u_preds"], minlength=K)
        check(sizes.min() >= SIZE_MIN and sizes.max() <= SIZE_MAX,
              f"rank {r}: ConSSKM sizes [{sizes.min()}, {sizes.max()}]")
        check(con["counters"]["mcf_fallbacks"] == 0,
              f"rank {r}: ConSSKM went on to the MCF track")
        m["con_ari"] = adjusted_rand_score(ref["consskm"]["u_preds"],
                                           con["u_preds"])
        m["con_acc"] = float(cluster_acc(u_targets, con["u_preds"]))
        check(m["con_ari"] >= MESH_CON_ARI,
              f"rank {r}: ConSSKM ARI {m['con_ari']} < {MESH_CON_ARI}")
        check(abs(m["con_acc"] - acc_ref) <= MESH_CON_ACC,
              f"rank {r}: ConSSKM ACC {m['con_acc']} against {acc_ref}")
        ek, ek_ref = got["estimate_k"]["best"], ref["estimate_k"]["best"]
        check(ek[0] == ek_ref[0] and abs(ek[1] - ek_ref[1]) <= MESH_EK_OBJ,
              f"rank {r}: estimate_k {ek} against {ek_ref}")
        check(got["estimate_k"]["fused_em_step"] > 0,
              f"rank {r}: fused_em_step never launched in estimate_k")
        g = got["gcd"]
        m["gcd_loss_rel"] = max(abs(a - b) / abs(b) for a, b in
                                zip(g["losses"], g_ref["losses"]))
        check(m["gcd_loss_rel"] <= MESH_GCD_RTOL,
              f"rank {r}: GCD losses {g['losses']} against "
              f"{g_ref['losses']}")
        check(g["digests"] == ranks[0]["gcd"]["digests"],
              f"rank {r}: the ranks' parameters differ after a step")
        check(g["launches"]["attention"] > 0
              and g["launches"]["attention_bwd"] > 0,
              f"rank {r}: GCD launches {g['launches']}")
        for method in ("uno", "autonovel"):
            e, e_ref = got["e2e"][method], ref["e2e"][method]
            rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b
                      in zip(e["history"], e_ref["history"]))
            m[f"{method}_loss_rel"] = rel
            check(rel <= MESH_E2E_RTOL and len(e["history"]) == 2,
                  f"rank {r}: {method} losses {e['history']} against "
                  f"{e_ref['history']}")
            check(e["best_head"] == e_ref["best_head"],
                  f"rank {r}: {method} best head {e['best_head']} against "
                  f"{e_ref['best_head']}")
            check(all(v > 0 for v in e["launches"].values()),
                  f"rank {r}: {method} launches {e['launches']}")
        out[r] = m
    for other in ranks[1:]:
        check(np.array_equal(other["consskm"]["u_preds"],
                             ranks[0]["consskm"]["u_preds"]),
              "the ranks' ConSSKM labels differ")
    p, p_ref = ranks[0]["gcd"]["params"], g_ref["params"]
    check(set(p) == set(p_ref), "the trainable sets differ")
    cos = {k: _cos64(p[k], p_ref[k]) for k in p}
    # a leaf no loss moves (a zero update in one process) has no cosine
    upd = {k: _cos64(p[k] - g_ref["params0"][k],
                     p_ref[k] - g_ref["params0"][k]) for k in p
           if np.any(p_ref[k] != g_ref["params0"][k])}
    worst = min(cos, key=cos.get)
    check(cos[worst] >= MESH_GCD_COS,
          f"GCD: {worst} at cosine {cos[worst]} to one process")
    out["con_acc_one_process"] = float(acc_ref)
    out["gcd_param_cos_min"] = cos[worst]
    out["gcd_update_cos_min"] = min(upd.values())
    return out


def phase_mesh_training(seed: int, cfg, workdir: str):
    """Phase 14: ConSSKM, estimate_k and data-parallel training over
    ranks, at world size 1 over NCCL (the references; ConSSKM under an
    explicit mesh of one rank against the mesh-free fit) and at world
    size 2 over gloo with both ranks on the card."""
    import numpy as np

    from scd_tpu_torch.pipelines.common import feature_cache_key, stage_cache
    from scd_tpu_torch.testing.dist import spawn

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    spec = _mesh_training_spec(seed, cfg, workdir)
    t0 = time.perf_counter()
    ref, = spawn("scd_tpu_torch.testing.mesh_cases.mesh_training_stages",
                 world=1, backend="nccl", device="cuda", args=(spec,),
                 timeout=MESH14_DEADLINE, threads=0)
    t_ref = time.perf_counter() - t0
    m1 = ref["consskm"]["mesh1"]
    print(f"world 1 (nccl): fit_constrained (ConSSKM, Sinkhorn, n_init "
          f"{MESH_CON_N_INIT}) with a mesh of one rank against the "
          f"mesh-free call: labels equal {m1['labels_equal']}, inertia "
          f"{m1['inertia'][0]!r} / {m1['inertia'][1]!r}, "
          f"{m1['seconds']:.3f} s / {ref['consskm']['seconds']:.3f} s")
    check(m1["labels_equal"] and m1["inertia"][0] == m1["inertia"][1],
          "world 1: the ConSSKM mesh fit differs from the mesh-free fit")
    t0 = time.perf_counter()
    ranks = spawn("scd_tpu_torch.testing.mesh_cases.mesh_training_stages",
                  world=2, backend="gloo", device="cuda", args=(spec,),
                  timeout=MESH14_DEADLINE, threads=0)
    t_mesh = time.perf_counter() - t0
    for name, got in [("world 1", ref)] + [(f"world 2 rank {r}", g)
                                            for r, g in enumerate(ranks)]:
        con, ek, g = got["consskm"], got["estimate_k"], got["gcd"]
        print(f"{name} ({smi}): ConSSKM {con['counters']['e_steps']} "
              f"E-steps, {con['counters']['dual_iterations']} dual "
              f"iterations, {con['counters']['repair_passes']} repair "
              f"passes, {con['seconds']:.3f} s; estimate_k "
              f"({MESH_EK_METHOD}) K {ek['best'][0]} objective "
              f"{ek['best'][1]:.6f}, {ek['seconds']:.3f} s, fused_em_step "
              f"{ek['fused_em_step']} launches; GCD "
              + ", ".join(f"{1e3 * s:.1f}" for s in g["seconds"])
              + f" ms a step, losses {g['losses']}, launches "
              f"{json.dumps(g['launches'])}; "
              + "; ".join(
                  f"{mth} {e['seconds']:.3f} s, losses "
                  f"{[h['loss'] for h in e['history']]}, best head "
                  f"{e['best_head']}, launches {json.dumps(e['launches'])}"
                  for mth, e in got["e2e"].items())
              + "; augmentation "
              + ", ".join(f"{1e3 * s:.1f}" for s in got["augment"]["seconds"])
              + f" ms a batch of {got['augment']['rows']} rows")
    print(f"phase 14 calls: world 1 {t_ref:.1f} s, world 2 {t_mesh:.1f} s; "
          f"metric_learn.main --mesh_data 2 "
          + " / ".join(f"{g['metric_learn']['seconds']:.1f}" for g in ranks)
          + " s a rank")
    feats = stage_cache(cfg).load("features", feature_cache_key(cfg, "feat"))
    u_targets = feats["targets"].astype(np.int64)[
        ~feats["mask_lab"].astype(bool)]
    metrics = mesh_training_checks(ref, ranks, u_targets)
    ml_dirs = os.listdir(os.path.join(workdir, "runs", "metric_learn", "log"))
    r0, r1 = (got["metric_learn"] for got in ranks)
    check(len(ml_dirs) == 1 and r0["log_dir"] == r1["log_dir"]
          and "ckpt_0.pt" in r0["files"] and r0["last"] == r1["last"]
          and all(math.isfinite(float(v)) for v in r0["last"].values()),
          f"metric_learn over the ranks: run dirs {ml_dirs}, files "
          f"{r0['files']}, last {r0['last']} / {r1['last']}")
    print(f"metric_learn.main --mesh_data 2 (1 epoch of 2 steps, "
          f"{MESH_ML_IMAGES} train images): one run directory, rank 0's "
          f"checkpoints {r0['files']}; last {json.dumps(r0['last'])}")
    print(f"world 2 against world 1: {json.dumps(metrics)}")
    g, e = ranks[0]["gcd"]["launches"], ranks[0]["e2e"]
    return {"fused_em_step": ranks[0]["estimate_k"]["fused_em_step"],
            "attention": g["attention"], "attention_bwd": g["attention_bwd"],
            "attention_f32": sum(e[m]["launches"]["attention_f32"]
                                 for m in e),
            "attention_bwd_f32": sum(e[m]["launches"]["attention_bwd_f32"]
                                     for m in e)}


# ------------------------------------------------------------- phase 15

# the tensor-parallel phase's sizes (gloo ranks sharing the card move
# every model-group collective through the host, ~0.4-0.5 GB/s on an
# H100 host in phase 14, so the batches are small):
#   (a) GCD at data 1 x model 2, ViT-B/16 bf16 at 224, grad_from_block
#       11, TP_GCD_IMAGES images x 2 views a step, TP_GCD_STEPS steps;
#   (b) UNO (2 steps) and AutoNovel (1 step) at ViT-B/16 f32,
#       TP_E2E_IMAGES images x 2 views;
#   (c) one GCD step on a 2 x 2 mesh (4 ranks) at full width, depth
#       TP_MESH_DEPTH, under --int8_frozen (block 0 frozen: the fused W8A8
#       kernel at the column shards, F 1,152 and 1,536), TP_MESH_IMAGES
#       images x 2 views;
#   (a32) (a) at f32 compute, TP_GCD32_STEPS steps;
#   (d) dryrun_multichip over TP_DRYRUN_RANKS ranks.
# The weights come from mesh_cases.quick_init_ (flax_init_'s truncated
# normals take ~15 s a ViT-B/16 on the host, in every rank).  Gates, all
# against the one process: phase 14's, MESH_GCD_RTOL on every loss, and
# for UNO and AutoNovel MESH_E2E_RTOL and the best head.  Parameters: in
# f32, (a32), phase 14's gate as it stands, every trainable parameter at
# cosine >= MESH_GCD_COS.  In bf16, (a) and (c): a row-parallel layer's
# output is an f32 sum in another order than one process's GEMM, so some
# of its bf16 elements round 1 ulp apart (tp_parity prints the share at
# fc2's shape; the column shards are bit-equal), and three steps of this
# loss carry that into the updates.  So the one process runs once more
# with only those roundings changed (mesh_cases' exact_rows: proj / fc2
# from f32 sums, rounded once), and the ranks' distance to the one
# process, 1 - cosine of the whole update (every trainable parameter's,
# as one vector) and of the worst parameter, may be at most TP_NOISE times
# that noise floor (twice its angle), or phase 14's 1 - MESH_GCD_COS
# where the floor is below it.
TP_GCD_IMAGES, TP_GCD_STEPS, TP_GCD32_STEPS = 32, 3, 2
TP_NOISE = 4.0
TP_E2E_IMAGES = 16
TP_MESH_IMAGES, TP_MESH_DEPTH = 16, 2
# the dry run's ranks: 8 took 50.2 s on an H100's host (8 interpreters
# on 8 cores), 4 since phase 16 came
TP_DRYRUN_RANKS = 4
TP_DEADLINE = 600


def _tp_specs(seed):
    """What ``testing/mesh_cases.py::tp_cases`` runs in each world: (a)
    and (a32) by name, (c), and (b) as the e2e spec."""
    import torch

    vit = dict(image_size=224, patch_size=16, width=768, depth=12, heads=12)
    train = dict(lr=0.1, sup_con_weight=0.35, n_views=TRAIN_VIEWS,
                 proj_dim=PROJ_DIM)
    gcd = {"vit": dict(vit, compute_dtype=torch.bfloat16),
           "train": dict(train, grad_from_block=GRAD_FROM_BLOCK,
                         batch_size=TP_GCD_IMAGES),
           "total_steps": 20, "global_batch": TP_GCD_IMAGES,
           "steps": TP_GCD_STEPS, "seed": seed, "image_size": 224,
           "views": TRAIN_VIEWS, "return_params": True, "quick_init": True}
    mesh22 = dict(gcd, vit=dict(gcd["vit"], depth=TP_MESH_DEPTH),
                  train=dict(train, grad_from_block=1, int8_frozen=True,
                             batch_size=TP_MESH_IMAGES),
                  global_batch=TP_MESH_IMAGES, steps=1, seed=seed + 7)
    gcd32 = dict(gcd, vit=dict(gcd["vit"], compute_dtype=torch.float32),
                 steps=TP_GCD32_STEPS)
    e2e = {"vit": vit, "images": TP_E2E_IMAGES, "seed": seed + 5,
           "n_labeled": BASELINE_LABELED, "num_heads": 4,
           "overcluster_factor": 3, "quick_init": True,
           "kw": {"uno": dict(epochs=2, batch_size=TP_E2E_IMAGES),
                  "autonovel": dict(epochs=1, batch_size=TP_E2E_IMAGES)}}
    return {"a": gcd, "a32": gcd32}, mesh22, e2e


def tp_parity(seed):
    """Each kernel of the tensor-parallel path against its plain version
    at a rank's shard shapes: attention and its gradient at 6 heads a rank
    (bf16 at (a)'s 64 views, f32 at (b)'s 32), the fused W8A8 at (c)'s
    rows (16 views x 208) and the qkv / fc1 column shards (F 1,152 and
    1,536, not multiples of 256).  Returns {name: max abs err}."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    heads, d = 6, 64
    errs = {}
    for dtype, b in ((torch.bfloat16, 2 * TP_GCD_IMAGES),
                     (torch.float32, 2 * TP_E2E_IMAGES)):
        tag = f"tp shard, {heads} heads a rank"
        errs[f"attention {dtype}"] = attention_parity(
            b, 197, heads, d, dtype, gen, tag=tag)
        errs[f"attention_bwd {dtype}"] = attention_bwd_parity(
            b, 197, heads, d, dtype, gen, tag=tag)
    rows = TP_MESH_IMAGES // 2 * TRAIN_VIEWS * 208  # a data rank's, L 208
    for f, what in ((3 * 768 // 2, "qkv"), (4 * 768 // 2, "fc1")):
        errs[f"w8a8_fusedq {what}"] = fusedq_parity(
            rows, 768, f, None, torch.bfloat16, gen, f"tp {what} shard")
    # the bf16 layers at (a)'s rows: one process's GEMM against the shards'
    n = 2 * TP_GCD_IMAGES * 197
    x = torch.randn(n, 768, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(2304, 768, generator=gen, device="cuda")
         * 768 ** -0.5).bfloat16()
    h = torch.randn(n, 3072, generator=gen, device="cuda").bfloat16()
    w2 = (torch.randn(768, 3072, generator=gen, device="cuda")
          * 3072 ** -0.5).bfloat16()
    lin = torch.nn.functional.linear
    cols = torch.equal(lin(x, w)[:, :1152], lin(x, w[:1152]))
    rows_tp = (lin(h[:, :1536].float(), w2[:, :1536].float())
               + lin(h[:, 1536:].float(), w2[:, 1536:].float())).bfloat16()
    apart = (lin(h, w2) != rows_tp).float().mean().item()
    print(f"  bf16 at N {n}: qkv's column shard bit-equal to one process's "
          f"columns {cols}; fc2's two f32 partial sums rounded once against "
          f"one process's GEMM: {100 * apart:.3f}% of the elements apart")
    check(cols, "a column shard's bf16 product differs from one process's")
    return errs


def _param_cosines(p, p_ref, p0):
    """(the worst parameter, its cosine, the cosine of the whole update)
    of trained parameters ``p`` against ``p_ref``, both from ``p0``."""
    import numpy as np

    cos = {k: _cos64(p[k], p_ref[k]) for k in p}
    worst = min(cos, key=cos.get)
    keys = sorted(p)
    whole = _cos64(np.concatenate([(p[k] - p0[k]).ravel() for k in keys]),
                   np.concatenate([(p_ref[k] - p0[k]).ravel() for k in keys]))
    return worst, cos[worst], whole


def tp_checks(ref, w2, w4):
    """Hold phase 15's ranks against the one process (raises on a failed
    gate); returns the figures to print."""
    import numpy as np

    out = {}
    for case, ranks in (("a", w2), ("a32", w2), ("c", w4)):
        want = ref["steps"][case]
        for r, got in enumerate(ranks):
            g = got["steps"][case]
            rel = max(abs(x - y) / abs(y)
                      for x, y in zip(g["losses"], want["losses"]))
            out[f"{case}_loss_rel_rank{r}"] = rel
            check(rel <= MESH_GCD_RTOL,
                  f"({case}) rank {r}: GCD losses {g['losses']} against "
                  f"{want['losses']}")
            check(g["digests"] == ranks[0]["steps"][case]["digests"],
                  f"({case}) rank {r}: the ranks' gathered parameters "
                  "differ (a replicated parameter is not bitwise equal)")
            check(g["launches"]["attention"] > 0
                  and g["launches"]["attention_bwd"] > 0,
                  f"({case}) rank {r}: launches {g['launches']}")
        p, p_ref = ranks[0]["steps"][case]["params"], want["params"]
        check(set(p) == set(p_ref), f"({case}) the trainable sets differ")
        check(all(np.array_equal(ranks[0]["steps"][case]["params0"][k],
                                 want["params0"][k]) for k in p),
              f"({case}) the initial parameters differ")
        p0 = want["params0"]
        worst, cos, whole = _param_cosines(p, p_ref, p0)
        out[f"{case}_param_cos_min"] = [worst, cos]
        out[f"{case}_update_cos_whole"] = whole
        if case == "a32":  # phase 14's gate as it stands
            check(cos >= MESH_GCD_COS,
                  f"({case}) {worst} at cosine {cos} to one process")
            continue
        floor = ref["steps"][f"{case}_exact"]
        f_worst, f_cos, f_whole = _param_cosines(floor["params"], p_ref, p0)
        out[f"{case}_floor_param_cos_min"] = [f_worst, f_cos]
        out[f"{case}_floor_update_cos_whole"] = f_whole
        for what, got, base in (("whole update", whole, f_whole),
                                (f"worst parameter ({worst})", cos, f_cos)):
            bound = max(1 - MESH_GCD_COS, TP_NOISE * (1 - base))
            check(1 - got <= bound,
                  f"({case}) {what} at cosine {got} to one process: beyond "
                  f"{TP_NOISE} x the floor (one process with exact rows at "
                  f"{base})")
    for r, got in enumerate(w2):
        bytes_ = got["steps"]["a"]["tp_bytes"]
        check(2 * bytes_ == ref["steps"]["a"]["tp_bytes"],
              f"(a) rank {r} holds {bytes_} bytes of tensor-parallel "
              f"parameters against one process's "
              f"{ref['steps']['a']['tp_bytes']}")
    check(all(g["steps"]["c"]["launches"]["w8a8_fusedq"] > 0 for g in w4),
          "(c) the fused W8A8 kernel never launched on a rank")
    for method in ("uno", "autonovel"):
        want = ref["e2e"][method]
        for r, got in enumerate(w2):
            e = got["e2e"][method]
            rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b
                      in zip(e["history"], want["history"]))
            out[f"{method}_loss_rel_rank{r}"] = rel
            check(rel <= MESH_E2E_RTOL
                  and len(e["history"]) == len(want["history"]),
                  f"(b) rank {r}: {method} losses {e['history']} against "
                  f"{want['history']}")
            check(e["best_head"] == want["best_head"],
                  f"(b) rank {r}: {method} best head {e['best_head']} "
                  f"against {want['best_head']}")
            check(all(v > 0 for v in e["launches"].values()),
                  f"(b) rank {r}: {method} launches {e['launches']}")
            check(np.array_equal(e["preds"], w2[0]["e2e"][method]["preds"]),
                  f"(b) rank {r}: {method} predictions differ between "
                  "the ranks")
    return out


def phase_tensor_parallel(seed: int):
    """Phase 15: tensor parallelism in the trainers (gloo ranks sharing
    the card; the one-process references in this process, a world of one
    over NCCL) and ``graft_entry.dryrun_multichip``; returns rank 0's
    launches."""
    from scd_tpu_torch.core import multihost
    from scd_tpu_torch.graft_entry import dryrun_multichip
    from scd_tpu_torch.testing.dist import spawn
    from scd_tpu_torch.testing.mesh_cases import tp_cases

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"kernels at a rank's shard shapes ({smi}):")
    tp_parity(seed)
    gcd, mesh22, e2e = _tp_specs(seed)
    fn = "scd_tpu_torch.testing.mesh_cases.tp_cases"
    kw = dict(device="cuda", timeout=TP_DEADLINE, threads=0)
    t0 = time.perf_counter()
    floors = {f"{k}_exact": dict(v, exact_rows=True)
              for k, v in (("a", gcd["a"]), ("c", mesh22))}
    with tempfile.TemporaryDirectory() as store:
        multihost.initialize(init_method=f"file://{store}/store",
                             world_size=1, rank=0, backend="nccl",
                             device="cuda")
        try:
            ref = tp_cases({"model": 2, "steps": dict(gcd, c=mesh22,
                                                      **floors),
                            "e2e": e2e})
        finally:
            multihost.shutdown()
    t1 = time.perf_counter()
    w2 = spawn(fn, world=2, backend="gloo", args=(
        {"model": 2, "steps": gcd, "e2e": e2e},), **kw)
    t2 = time.perf_counter()
    w4 = spawn(fn, world=4, backend="gloo", args=(
        {"model": 2, "steps": {"c": mesh22}},), **kw)
    t3 = time.perf_counter()
    one = ref["steps"]["a"]
    for name, got in [("one process", ref)] + [
            (f"data 1 x model 2 rank {r}", g) for r, g in enumerate(w2)]:
        for case in ("a", "a32"):
            a = got["steps"][case]
            print(f"({case}) GCD, {name} ({smi}): "
                  + ", ".join(f"{1e3 * x:.1f}" for x in a["seconds"])
                  + " ms a step (one process "
                  + ", ".join(f"{1e3 * x:.1f}"
                              for x in ref["steps"][case]["seconds"])
                  + f"), losses {a['losses']}, tensor-parallel parameters "
                  f"{a['tp_bytes']} bytes (one process {one['tp_bytes']}), "
                  f"launches {json.dumps(a['launches'])}")
        for method, e in got["e2e"].items():
            print(f"(b) {method}, {name} ({smi}): {e['seconds']:.3f} s, "
                  f"losses {[h['loss'] for h in e['history']]}, best head "
                  f"{e['best_head']}, launches {json.dumps(e['launches'])}")
    for name, got in [("one process", ref)] + [
            (f"data 2 x model 2 rank {r}", g) for r, g in enumerate(w4)]:
        c = got["steps"]["c"]
        print(f"(c) GCD --int8_frozen depth {TP_MESH_DEPTH}, {name} "
              f"({smi}): {1e3 * c['seconds'][0]:.1f} ms, losses "
              f"{c['losses']}, launches {json.dumps(c['launches'])}")
    metrics = tp_checks(ref, w2, w4)
    print(f"phase 15 against one process: {json.dumps(metrics)}")
    t4 = time.perf_counter()
    line = dryrun_multichip(TP_DRYRUN_RANKS, device="cuda",
                            timeout=TP_DEADLINE)
    check(line.startswith("dryrun_multichip ok: mesh={'data': "
                          f"{TP_DRYRUN_RANKS // 2}, 'model': 2}}"),
          f"dryrun_multichip: {line}")
    print(f"phase 15 calls: one process {t1 - t0:.1f} s, data 1 x model 2 "
          f"{t2 - t1:.1f} s, data 2 x model 2 {t3 - t2:.1f} s, "
          f"dryrun_multichip({TP_DRYRUN_RANKS}) "
          f"{time.perf_counter() - t4:.1f} s")
    a, c = w2[0]["steps"]["a"]["launches"], w4[0]["steps"]["c"]["launches"]
    a32, e = w2[0]["steps"]["a32"]["launches"], w2[0]["e2e"]
    return {"attention": a["attention"] + c["attention"],
            "attention_bwd": a["attention_bwd"] + c["attention_bwd"],
            "w8a8_fusedq": c["w8a8_fusedq"],
            "attention_f32": a32["attention_f32"] + sum(
                e[m]["launches"]["attention_f32"] for m in e),
            "attention_bwd_f32": a32["attention_bwd_f32"] + sum(
                e[m]["launches"]["attention_bwd_f32"] for m in e)}


# ------------------------------------------------------------- phase 16

# (a) the attention routes: the forward's head_dims and sequences (bf16,
# causal and not, l_valid < L), B x H of each case, and the micro ViT's
# training shape (``metric_learn --vit micro``: width 64 over 2 heads,
# 128 images x 2 views, at 224 px L 197)
ROUTE_HDS = (8, 16, 32, 128)
ROUTE_LS = (1, 5, 17, 197, 300)
ROUTE_B, ROUTE_H = 8, 3
MICRO_B, MICRO_H, MICRO_D = 256, 2, 32


def _sdpa_mask(length, causal, l_valid):
    """The boolean mask (True: attend) SDPA takes for this input, or
    None."""
    import torch

    if not causal and l_valid >= length:
        return None
    col = torch.arange(length, device="cuda")
    keep = (col < l_valid)[None, :].expand(length, length)
    if causal:
        keep = keep & (col[None, :] <= col[:, None])
    return keep


def time_route(kind, b, length, h, d, dtype, causal=False, l_valid=None,
               gen=None, reps=10):
    """One route at one shape, timed with CUDA events: the kernel (the
    forward through ``vit_attention``, or ``qkv_attention_bwd_cuda``),
    its plain version, SDPA's forward or its backward by autograd (a
    yardstick, called nowhere in the port) and the bound; prints a line
    and returns (ms, plain_ms, sdpa_ms, bound_ms, bound_by)."""
    import torch
    import torch.nn.functional as F

    from scd_tpu_torch.ops import attention as A
    from scd_tpu_torch.testing import attention_bwd as T

    lv = length if l_valid is None else l_valid
    f32 = dtype == torch.float32
    scale = d ** -0.5
    qkv = torch.randn(b, length, 3 * h * d, generator=gen,
                      device="cuda").to(dtype)
    q, k, v = A._heads(qkv, h)
    mask = _sdpa_mask(length, causal, lv)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    if kind == "fwd":
        route = A.attention_route(dtype, d, length)

        def kern():
            return A.vit_attention(q, k, v, scale, causal, lv)

        def plain():
            return A.attention_plain(q, k, v, scale, causal, lv)

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt, mask,
                                                  scale=scale)

        bound, by = _attention_bound(b, length, h, d, causal, lv, f32)
    else:
        route = A.bwd_route(dtype, d)
        dout = torch.randn(b, length, h * d, generator=gen,
                           device="cuda").to(dtype)
        do_t = dout.view(b, length, h, d).transpose(1, 2)
        leaves = [t.detach().requires_grad_(True) for t in (qt, kt, vt)]
        out = F.scaled_dot_product_attention(*leaves, mask, scale=scale)

        def kern():
            return A.qkv_attention_bwd_cuda(qkv, dout, h, scale, causal, lv)

        def plain():
            return A.qkv_attention_bwd_plain(qkv, dout, h, scale, causal, lv)

        def lib():
            return torch.autograd.grad(out, leaves, do_t, retain_graph=True)

        bound, by = T.bound_ms(b, length, h, d, lv, f32, causal)
    ms = cuda_ms(kern, reps=reps, warmup=2)
    plain_ms = cuda_ms(plain, reps=3)
    lib_ms = cuda_ms(lib, reps=reps, warmup=2)
    print(f"  time {kind} {route} B={b} L={length} H={h} d={d} "
          f"{str(dtype)[6:]} causal={causal} l_valid={lv}: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
          f"bound {bound:.5f} ms ({by}); {ms / bound:.1f} x the bound, "
          f"{ms / lib_ms:.2f} x SDPA", flush=True)
    return ms, plain_ms, lib_ms, bound, by


def attention_routes(seed: int):
    """(a): every new route of the attention and its gradient against its
    plain version (phases 2 and 5's tolerances), each timed
    (``time_route``).  The forward in bf16 at head_dim 8, 16, 32 and 128
    and L 1, 5, 17, 197 and 300, causal and not, l_valid < L where L > 1
    (the key-tiled SIMT kernel), f32 at L <= 256 whose rows do not fit the
    whole-row kernel (head_dim 128 at L 256: the key-tiled one) and f32 at
    head_dim 32 (the whole-row one); the gradient in bf16 at head_dim 32
    (the micro ViT's training shape), f32 at head_dim 32 at L 290 and 785
    (the SIMT route past 256 keys), and causal at head_dim 64 (bf16 and
    f32 on ``wgmma``; the text tower's B 64 x L 77 x H 8, and L 300 with
    l_valid 290 for the tiles the causal mask skips) and 32.  Each route's
    counter must move by its calls.  Returns ({row: (ms, plain_ms,
    sdpa_ms, bound_ms, bound_by)}, {row: max abs err}) of the kernels
    line's two rows of the new routes."""
    import torch

    from scd_tpu_torch.ops import attention as A

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    c0 = _counts()
    fwd_err = 0.0
    for d in ROUTE_HDS:
        for length in ROUTE_LS:
            check(A.attention_route(bf16, d, length) == "long_simt",
                  f"attention: bf16 d {d} L {length} routes to "
                  f"{A.attention_route(bf16, d, length)}")
            for causal in (False, True):
                lv = length - 3 if length > 5 else None
                fwd_err = max(fwd_err, attention_parity(
                    ROUTE_B, length, ROUTE_H, d, bf16, gen, causal=causal,
                    l_valid=lv, tag="route-long_simt"))
                time_route("fwd", ROUTE_B, length, ROUTE_H, d, bf16, causal,
                           lv, gen)
    n = _counts()["attention_simt_bf16"] - c0["attention_simt_bf16"]
    want = 2 * 2 * len(ROUTE_HDS) * len(ROUTE_LS)
    check(n >= want, f"attention: {n} launches of the bf16 SIMT route for "
          f"{want} calls")
    check(A.attention_route(f32, 128, 256) == "long_simt"
          and A.attention_route(f32, 32, 197) == "f32_simt",
          "attention: the f32 routes at L <= 256")
    attention_parity(4, 256, 3, 128, f32, gen, l_valid=250,
                     tag="route-long_simt f32 rows past shared memory")
    attention_parity(4, 197, 3, 32, f32, gen, causal=True,
                     tag="route-f32_simt")
    micro_inputs = _attn_inputs(MICRO_B, L_VIT, MICRO_H, MICRO_D, bf16, True,
                                gen)
    errs = {"attention_simt_bf16": max(fwd_err, attention_parity(
        MICRO_B, L_VIT, MICRO_H, MICRO_D, bf16, gen, tag="micro-224",
        inputs=micro_inputs))}
    del micro_inputs
    times = {"attention_simt_bf16": time_route(
        "fwd", MICRO_B, L_VIT, MICRO_H, MICRO_D, bf16, gen=gen)}

    c1 = _counts()
    bwd_cases = (  # (b, L, h, d, dtype, causal, l_valid, tag)
        (MICRO_B, L_VIT, MICRO_H, MICRO_D, bf16, False, None, "micro-224"),
        (16, 290, 2, 32, f32, False, None, "f32-L290"),
        (4, 785, 2, 32, f32, False, 770, "f32-L785"),
        (64, 77, 8, 64, bf16, True, None, "causal-text"),
        (64, 77, 8, 64, f32, True, None, "causal-text-f32"),
        (8, 300, 4, 64, bf16, True, 290, "causal-L300"),
        (8, 300, 4, 64, f32, True, 290, "causal-L300-f32"),
        (64, 77, 8, 32, bf16, True, None, "causal-d32"),
        (16, 290, 2, 32, f32, True, 280, "causal-d32-f32"),
        (5, 1, 3, 32, bf16, False, None, "edge-L1"),
        (7, 17, 5, 16, bf16, True, 9, "edge-L17-d16"),
        (3, 65, 2, 128, bf16, False, None, "edge-d128"),
        (2, 40, 2, 256, f32, True, None, "edge-d256"))
    bwd_err = 0.0
    for b, length, h, d, dtype, causal, lv, tag in bwd_cases:
        err = attention_bwd_parity(b, length, h, d, dtype, gen, l_valid=lv,
                                   tag=f"route-{tag}", causal=causal)
        if A.bwd_route(dtype, d) == "simt":
            bwd_err = max(bwd_err, err)
        time_route("bwd", b, length, h, d, dtype, causal, lv, gen,
                   reps=3 if length > 500 else 10)
    c2 = _counts()
    n_simt = sum(A.bwd_route(c[4], c[3]) == "simt" for c in bwd_cases)
    n_causal = sum(c[5] for c in bwd_cases)
    for key, n in (("attention_bwd_simt", n_simt),
                   ("attention_bwd_causal", n_causal)):
        got = c2[key] - c1[key]
        check(got >= 2 * n, f"{key}: {got} launches for {n} shapes x 2")
    errs["attention_bwd_simt"] = bwd_err
    times["attention_bwd_simt"] = time_route(
        "bwd", MICRO_B, L_VIT, MICRO_H, MICRO_D, bf16, gen=gen)
    return times, errs


# (b) the micro ViT on the card, the fault's reproduction: each CLI of
# smoke_all.sh's counterpart in a process of its own, then metric_learn
# (bf16) and run_baseline_e2e (f32 at image 136: L 290, the gradient's
# SIMT route past 256 keys) in this process, counted
MICRO_TRAIN = ["--dataset_name", "synthetic", "--vit", "micro",
               "--epochs", "1", "--device", "cuda"]


def _stop_group(proc):
    """Kill ``proc`` (started with ``start_new_session``) and every process
    of its session, if it still runs."""
    import signal

    if proc.poll() is None:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)


class SmokeAllCuda:
    """``DEVICE=cuda bash scd_tpu_torch/scripts/smoke_all.sh`` (the card's
    gpu suite left to its own call: ``SMOKE_GPU_SUITE=0``) in the
    background: started by the constructor, read by a thread that notes
    each CLI's seconds from the moment its trace line arrives to the next
    one's; :meth:`join` waits and checks exit 0 and ``ALL CLIS OK``."""

    def __init__(self, pycache: str):
        import threading

        here = os.path.dirname(os.path.abspath(__file__))
        # ten interpreters import the same modules: their bytecode is
        # cached after the first, under the smoke's own directory
        env = {k: v for k, v in os.environ.items()
               if k != "PYTHONDONTWRITEBYTECODE"}
        env.update(DEVICE="cuda", SMOKE_GPU_SUITE="0",
                   PYTHONPYCACHEPREFIX=os.path.join(pycache, "pycache"))
        env["PYTHONPATH"] = os.pathsep.join(
            [here] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            ["bash", "scd_tpu_torch/scripts/smoke_all.sh"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=here, start_new_session=True)
        self.lines, self.seconds = [], []
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        last = None
        for ln in self.proc.stdout:
            self.lines.append(ln)
            if ln.startswith(("+ python ", "+ echo ")):
                now = time.perf_counter()
                if last is not None:
                    self.seconds.append((last[1], now - last[0]))
                words = ln.split()
                last = (now, words[3] if len(words) > 3 else ln.strip())

    def stop(self):
        """End the smoke and every process it started."""
        _stop_group(self.proc)

    def join(self, timeout=600):
        rc = self.proc.wait(timeout=timeout)
        self.reader.join(timeout=60)
        check(rc == 0 and any(ln.strip() == "ALL CLIS OK"
                              for ln in self.lines),
              f"smoke_all.sh at DEVICE=cuda: rc {rc}\n"
              + "".join(self.lines[-40:]))
        for name, sec in self.seconds:
            print(f"  smoke_all (cuda) {name}: {sec:.1f} s")
        print(f"  smoke_all (cuda): ALL CLIS OK in "
              f"{time.perf_counter() - self.t0:.1f} s (beside (c)-(e))",
              flush=True)


def micro_main_paths(workdir):
    """``metric_learn.main --vit micro`` (bf16, image 32: L 5) and
    ``run_baseline_e2e.main --vit micro`` (f32, image 136: L 290) on the
    card, counts set to 0 just before and read just after each, every
    kernel call held against its plain version (``path_inputs``).
    Returns the launches of both runs."""
    from scd_tpu_torch.train import metric_learn, run_baseline_e2e

    total = {}
    for tag, fn, argv in (
            ("metric_learn micro bf16", metric_learn.main,
             MICRO_TRAIN + ["--image_size", "32", "--batch_size", "8",
                            "--steps_per_epoch", "2", "--proj_dim", "32",
                            "--grad_from_block", "0", "--max_kmeans_iter",
                            "10", "--exp_root", os.path.join(workdir, "ml")]),
            ("run_baseline_e2e micro f32 at 136 px", run_baseline_e2e.main,
             MICRO_TRAIN + ["--method", "uno", "--image_size", "136",
                            "--batch_size", "32", "--num_heads", "2"])):
        with path_inputs() as seen:
            _reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                fn(argv)
            sec = time.perf_counter() - t0
            launches = _counts()
        print(f"  {tag}: {sec:.1f} s, launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})}",
              flush=True)
        hold_path_inputs(seen, tag)
        for key, n in launches.items():
            total[key] = total.get(key, 0) + n
    check(total["attention_simt_bf16"] > 0,
          "the micro ViT's bf16 forward launched no SIMT attention")
    check(total["attention_bwd_simt"] > 0,
          "the micro ViT's gradients launched no SIMT gradient kernel")
    return total


# (c) the multihost smoke's four modes, two gloo ranks a world, the four
# worlds at once on the card
MULTIHOST_MODES = ("", "unsup", "ptsup", "train")


def multihost_cuda():
    """``python -m scd_tpu_torch.scripts.multihost_smoke --launch 2`` in
    the default mode and ``--pipeline unsup|ptsup|train`` at once: each
    launcher exits 0 (its ranks' digests agree)."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    t0 = time.perf_counter()
    for mode in MULTIHOST_MODES:
        procs[mode or "stages"] = subprocess.Popen(
            [sys.executable, "-m", "scd_tpu_torch.scripts.multihost_smoke",
             "--launch", "2", "--device", "cuda", "--timeout", "300"]
            + (["--pipeline", mode] if mode else []),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=here, start_new_session=True)
    try:
        for mode, proc in procs.items():
            out, _ = proc.communicate(timeout=400)
            ok = [ln for ln in out.splitlines()
                  if ln.startswith("multihost smoke ok")]
            check(proc.returncode == 0 and ok,
                  f"multihost smoke ({mode}): rc {proc.returncode}\n"
                  + out[-3000:])
            print(f"  multihost ({mode}): {ok[0][:200]}")
    finally:
        for proc in procs.values():
            _stop_group(proc)
    print(f"  multihost smoke, 4 worlds of 2 ranks at once: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


# (d) the prefix-KV build over 2 gloo ranks against one process: phase
# 12's shapes cut to 2,048 names
PREFIX_RANK_NAMES = 2_048


def prefix_over_ranks(seed, workdir):
    """Phase 12's cold root and CLIP ViT-B/16 text tower (bf16), 2,048 of
    its short names x the 80 templates: ``build_zeroshot_weights_prefix``
    in this process and over 2 gloo ranks on the card
    (``testing/mesh_cases.py::prefix_vocab_build``); every rank's [512,
    2,048] equal to the other's and at min column cosine >=
    PREFIX_COS_TOL to this process's; the prefix kernel launched on the
    ``mma.sync`` kernel in each rank."""
    import dataclasses

    import numpy as np
    import torch

    from scd_tpu_torch.models import clip_vit_b16_config, dino_vit_b16_config
    from scd_tpu_torch.naming import zeroshot as zs
    from scd_tpu_torch.naming.templates import IMAGENET_TEMPLATES
    from scd_tpu_torch.pipelines.unsup import build_encoders
    from scd_tpu_torch.testing.dist import spawn
    from scd_tpu_torch.testing.fabricate import (cold_config,
                                                 fabricate_cold_root,
                                                 short_names)

    cfg = cold_config(os.path.join(workdir, "prefix"), dense_int8=False,
                      batch_size=BATCH, num_workers=1)
    cfg = cfg.replace(feature=dataclasses.replace(cfg.feature,
                                                  feat_model="clip"))
    fabricate_cold_root(cfg, clip_vit_b16_config(),
                        dino_vit_b16_config(gelu_tanh=cfg.feature.gelu_tanh),
                        seed=seed, n_images=100, vocab=PREFIX_RANK_NAMES)
    enc = build_encoders(cfg, {}, device="cuda")[2]
    names = short_names(enc.tokenize, PREFIX_RANK_NAMES, seed)
    t0 = time.perf_counter()
    with torch.inference_mode():
        one = zs.build_zeroshot_weights_prefix(
            enc.forward, enc.prefix_forward, enc.suffix_forward,
            enc.variables, enc.tokenize, names, IMAGENET_TEMPLATES)
    t_one = time.perf_counter() - t0
    del enc
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn("scd_tpu_torch.testing.mesh_cases.prefix_vocab_build",
                  world=2, backend="gloo", device="cuda",
                  args=({"pipeline": cfg, "cases": {
                      "cached": (names, IMAGENET_TEMPLATES, 8_192)}},),
                  timeout=300)
    t_ranks = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        check(res["cached"].shape == one.shape == (D_CLIP, len(names)),
              f"prefix over ranks: rank {r} shape {res['cached'].shape}")
        check(np.array_equal(res["cached"], ranks[0]["cached"]),
              f"prefix over ranks: rank {r}'s columns differ from rank 0's")
        check(res["launches"]["prefix_attention_mma"] > 0
              and res["launches"]["prefix_attention_mma"]
              == res["launches"]["prefix_attention"],
              f"prefix over ranks: rank {r} launches {res['launches']}")
    cos = _row_cos(ranks[0]["cached"].T, one.T)
    print(f"  prefix build over 2 ranks ({len(names)} names x "
          f"{len(IMAGENET_TEMPLATES)} templates): column cosine to one "
          f"process min {cos.min().item():.7f} (tolerance {PREFIX_COS_TOL}); "
          f"one process {t_one:.2f} s (first build, cold), the world "
          f"{t_ranks:.2f} s start-up included; launches a rank "
          f"{ranks[0]['launches']}", flush=True)
    check(cos.min().item() >= PREFIX_COS_TOL,
          "prefix over ranks disagrees with one process")


def phase_scripts_and_routes(seed: int, workdir: str):
    """Phase 16: (a) the attention routes (:func:`attention_routes`), (b)
    ``smoke_all.sh``'s counterpart at ``DEVICE=cuda`` and the micro ViT's
    main paths in this process, (c) the multihost smoke's four modes, (d)
    the prefix-KV build over 2 ranks, (e) the scale smoke at ``--small``.
    Returns (times, errs, launches) for the kernels line."""
    from scd_tpu_torch.scripts import scale_smoke

    t0 = time.perf_counter()
    times, errs = attention_routes(seed)
    print(f"phase 16 (a) {time.perf_counter() - t0:.1f} s", flush=True)
    # (a) timed the kernels alone on the card; the rest shares it: the
    # smoke's CLIs, one process after another, run beside (b)-(e)
    smoke = SmokeAllCuda(workdir)
    try:
        t0 = time.perf_counter()
        launches = micro_main_paths(workdir)
        print(f"phase 16 (b) {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        multihost_cuda()
        print(f"phase 16 (c) {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        prefix_over_ranks(seed, workdir)
        print(f"phase 16 (d) {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            res = scale_smoke.main(["--small", "--device", "cuda"])
        for ln in buf.getvalue().splitlines():
            print(f"  {ln}")
        lo, hi = res["consskm_sizes"]
        check(res["sskm_acc"][0] > 0.9 and lo >= 30 and hi <= 2000
              and res["topk_hit"] > 0.9 and res["voting_sacc"] > 0.9
              and res["ub"] >= res["lb"] - 1e-9,
              f"scale smoke (--small, cuda): {res}")
        print(f"phase 16 (e) {time.perf_counter() - t0:.1f} s", flush=True)
    except BaseException:
        smoke.stop()
        raise
    smoke.join()
    return times, errs, launches


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--against-bwd", default=None,
                   help="an attention_bwd.cu (e.g. the parent commit's) to "
                        "build and time beside the gradient kernel in phase 5")
    p.add_argument("--against-fwd", default=None,
                   help="an attention.cu (e.g. the parent commit's) to build "
                        "and time beside the f32 forward kernel in phase 5")
    p.add_argument("--against-prefix", default=None,
                   help="a prefix_attention.cu (e.g. the parent commit's) "
                        "to build and time beside the prefix kernel in "
                        "phase 12")
    p.add_argument("--profile-prefix", action="store_true",
                   help="profile one more prefix build in phase 12 "
                        "(torch.profiler: device time by kernel, ~20 s)")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from scd_tpu_torch.core.device import f32_matmuls

    f32_matmuls()
    t_all = time.perf_counter()
    section("phase 1: device and build")
    t0 = time.perf_counter()
    phase_build()
    print(f"phase 1 {time.perf_counter() - t0:.1f} s")
    section("phase 2: kernel parity on the card")
    t0 = time.perf_counter()
    errs = phase_parity(args.seed)
    print(f"phase 2 {time.perf_counter() - t0:.1f} s")
    section("phase 3: warm main path (run_unsup, ImageNet-100 scale)")
    t0 = time.perf_counter()
    # phase 8 reads phase 3's root again
    in100_dir = tempfile.TemporaryDirectory()
    launches, estep, in100 = phase_main_path(args.seed, in100_dir.name)
    print(f"phase 3 {time.perf_counter() - t0:.1f} s")
    section("phase 4: cold main path (extraction and vocabulary, --int8)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        launches.update(phase_cold(args.seed, workdir))
    print(f"phase 4 {time.perf_counter() - t0:.1f} s")
    section("phase 5: timing at the main paths' shapes")
    t0 = time.perf_counter()
    times = phase_timing(args.seed, estep, args.against_bwd,
                         args.against_fwd)
    print(f"phase 5 {time.perf_counter() - t0:.1f} s")
    section("phase 6: serving (infer, CLIP ViT-B/16 bf16)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        launches.update(phase_serving(args.seed, workdir))
    print(f"phase 6 {time.perf_counter() - t0:.1f} s")
    section("phase 7: k-means runners (--optimal, ImageNet-100 scale)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        launches.update(phase_runners(args.seed, workdir))
    print(f"phase 7 {time.perf_counter() - t0:.1f} s")
    section("phase 8: partially supervised path (ptsup, ConSSKM, FINCH)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        ptsup_launches = phase_ptsup(args.seed, in100, workdir)
    print(f"launches in phase 8's run_ptsup: {json.dumps(ptsup_launches)}")
    print(f"phase 8 {time.perf_counter() - t0:.1f} s")
    section("phase 9: estimate_k and the new readers (CUB, Stanford Dogs)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        sentinel_err, sentinel_times, ek_launches = phase_estimate_k(
            args.seed, workdir)
    for key, n in ek_launches.items():
        launches[key] += n
    print(f"fused_em_step at K {MAX_K} with sentinel slots: max abs err "
          f"{sentinel_err:.3e}; ms {sentinel_times[0]:.4f}")
    print(f"phase 9 {time.perf_counter() - t0:.1f} s")
    section("phase 10: GCD training (metric_learn, ViT-B/16 at 224)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        train_launches = phase_train(args.seed, workdir)
    launches["attention_bwd"] = train_launches["attention_bwd"]
    print(f"launches in phase 10's training steps: "
          f"{json.dumps(train_launches)}")
    print(f"phase 10 {time.perf_counter() - t0:.1f} s")
    section("phase 11: the NCD baselines (UNO, AutoNovel, supervised; "
            "ResNet towers)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        baseline_launches = phase_baselines(args.seed, workdir)
    print(f"launches in phase 11's main paths: "
          f"{json.dumps(baseline_launches)}")
    for key in ("attention_f32", "attention_bwd_f32"):
        launches[key] = sum(baseline_launches[f"{m}_e2e"][key]
                            for m in ("uno", "autonovel"))
    print(f"phase 11 {time.perf_counter() - t0:.1f} s")
    section("phase 12: the prefix-KV vocabulary build (SCD_PREFIX_VOCAB=1)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        launches["prefix_attention_mma"], errs["prefix_attention"], \
            times["prefix_attention"] = phase_prefix_vocab(
                args.seed, workdir, args.against_prefix, args.profile_prefix)
    print(f"phase 12 {time.perf_counter() - t0:.1f} s")
    section("phase 13: the mesh (torch.distributed: NCCL at world size 1, "
            "gloo at world size 2 on one card)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        mesh_launches = phase_mesh(args.seed, in100, workdir)
    print(f"launches in phase 13's ranks: {json.dumps(mesh_launches)}")
    print(f"phase 13 {time.perf_counter() - t0:.1f} s")
    section("phase 14: the mesh: ConSSKM, estimate_k, training (NCCL at "
            "world size 1, gloo at world size 2 on one card)")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        train_mesh = phase_mesh_training(args.seed, in100, workdir)
    in100_dir.cleanup()  # phases 8, 13 and 14 read phase 3's root
    for key, n in train_mesh.items():
        launches[key] += n
    print(f"launches in phase 14's rank 0: {json.dumps(train_mesh)}")
    print(f"phase 14 {time.perf_counter() - t0:.1f} s")
    section("phase 15: tensor parallelism in the trainers (gloo ranks "
            "sharing the card) and graft_entry.dryrun_multichip")
    t0 = time.perf_counter()
    tp_launches = phase_tensor_parallel(args.seed)
    for key, n in tp_launches.items():
        launches[key] += n
    print(f"launches in phase 15's rank 0: {json.dumps(tp_launches)}")
    print(f"phase 15 {time.perf_counter() - t0:.1f} s")
    section("phase 16: attention at every head_dim and under causal, the "
            "scripts' counterparts, the prefix-KV build over ranks")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        route_times, route_errs, route_launches = phase_scripts_and_routes(
            args.seed, workdir)
    times.update(route_times)
    errs.update(route_errs)
    for key, n in route_launches.items():
        launches[key] = launches.get(key, 0) + n
    print(f"launches in phase 16's micro main paths: "
          f"{json.dumps({k: v for k, v in route_launches.items() if v})}")
    print(f"phase 16 {time.perf_counter() - t0:.1f} s; total "
          f"{time.perf_counter() - t_all:.1f} s")

    rows = []
    for name, src, replaces, key in KERNELS:
        ms, plain_ms, lib_ms, bound_ms, bound_by = times[
            name if name in times else key]
        check(launches[key] > 0, f"{name}: no launch on a path")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[key],
                     "max_abs_err": errs[name if name in errs else key],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
