"""Baseline NCD methods: UNO v2 and AutoNovel, plus the supervised
classifier + combine-with-kmeans evaluator.

Port of ``scd_tpu/train/baselines.py`` (reference
``gcd/methods/baselines/uno_v2.py`` / ``uno_v2_utils.py``: multi-head
prototype classifier, Sinkhorn-Knopp pseudo-labels, swapped prediction;
``rerun_autonovel.py`` / ``auto_novel_utils.py``: ranking-statistics
pairwise pseudo-labels, pairwise BCE, consistency;
``cluster_and_classifier/train_supervised.py``: label-smoothed head, OSR
max-prob thresholding; ``combine_classifier_and_kmeans.py``).

- The UNO heads are stacked parameters over a head axis (the JAX
  package's ``nn.vmap``), one batched product per layer, under the Flax
  names (``Vmap_Head_0.{fc0,ln0,out,prototypes}``), so a JAX tree loads
  with ``models.params.params_from_flax`` one to one.  The projector's
  norm is a per-head LayerNorm (epsilon 1e-6), as in the JAX package.
- Sinkhorn and the ranking-statistics pairs are vectorized over the batch
  (and over views and heads) on the device; nothing is materialized on
  the host.
- The frozen-feature trainers take one SGD step per batch in place (optax
  ``sgd(lr, momentum=0.9)`` is ``torch.optim.SGD(momentum=0.9,
  dampening=0)``), keep each step's loss on the device and read the
  epoch's mean once.  Parameters start from Flax's default initializers
  drawn from a ``torch.Generator(init_seed)``
  (``models.params.flax_init_``: the distributions, not the JAX draws);
  the batch order is the JAX package's numpy ``default_rng(seed)``.
- Every trainer runs on ``device`` (``cuda`` unless the caller asks for
  the CPU); there the products are cuBLAS and the rest PyTorch's
  kernels: these heads reach no Pallas kernel in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from scd_tpu_torch.core import multihost
from scd_tpu_torch.core.device import resolve_device
from scd_tpu_torch.models.params import flax_init_
from scd_tpu_torch.models.vit import Dense, _param
from scd_tpu_torch.train.gcd import _unit
from scd_tpu_torch.train.losses import label_smoothing_ce
from scd_tpu_torch.train.schedulers import sigmoid_rampup


# ------------------------------------------------------------------ UNO v2

def sinkhorn_knopp(logits: torch.Tensor, n_iters: int = 3,
                   epsilon: float = 0.05,
                   row_mask: torch.Tensor = None) -> torch.Tensor:
    """SwAV-style equality-constrained pseudo-labels (reference
    ``uno_v2.py:72,113-121``).  logits [..., B, K] -> soft targets
    [..., B, K] whose rows sum to 1 and columns balance to B_eff/K, each
    [B, K] matrix on its own (the JAX package vmaps over the leading
    axes).

    ``row_mask`` [B] (True = participate) restricts the transport problem
    to a subset of rows: excluded rows carry zero mass (their returned
    rows are zeros) and B_eff = max(sum(mask), 1), so the balance holds
    among exactly the rows the reference constrains (it slices
    ``logits_unlab[..., ~mask_lab]`` before sk, uno_v2.py:118).  f32
    throughout; the max-shift before ``exp`` is each matrix's global one
    (it cancels in the first normalization)."""
    z = logits.float() / epsilon
    q = torch.exp(z - z.amax(dim=(-2, -1), keepdim=True)).transpose(-1, -2)
    k = q.shape[-2]  # q: [..., K, B]
    if row_mask is None:
        b = float(q.shape[-1])
    else:
        mask = row_mask.to(q.dtype)
        q = q * mask
        b = torch.clamp_min(mask.sum(), 1.0)
    q = q / torch.clamp_min(q.sum(dim=(-2, -1), keepdim=True), 1e-12)
    for _ in range(n_iters):
        q = q / torch.clamp_min(q.sum(dim=-1, keepdim=True), 1e-12) / k
        q = q / torch.clamp_min(q.sum(dim=-2, keepdim=True), 1e-12) / b
    return (q * b).transpose(-1, -2)


class _StackedDense(nn.Module):
    """H Dense layers as one ``[H, in, out]`` kernel and ``[H, out]``
    bias: x [B, in] (shared) or [H, B, in] -> [H, B, out]."""

    def __init__(self, heads: int, in_dim: int, out_dim: int):
        super().__init__()
        self.kernel = _param(heads, in_dim, out_dim)
        self.bias = _param(heads, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 2:
            x = x.expand(self.kernel.shape[0], *x.shape)
        return torch.baddbmm(self.bias[:, None, :], x, self.kernel)


class _StackedLayerNorm(nn.Module):
    """H LayerNorms over the last axis (Flax's epsilon 1e-6), each with
    its own ``scale`` and ``bias`` [H, D]."""

    def __init__(self, heads: int, dim: int, eps: float = 1e-6):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(heads, dim),
                                  requires_grad=False)
        self.bias = _param(heads, dim)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x, (x.shape[-1],), eps=self.eps)
        return y * self.scale[:, None, :] + self.bias[:, None, :]


class _Heads(nn.Module):
    """The stacked (projector MLP -> unit-norm prototype layer) heads:
    Flax's ``Vmap_Head_0``."""

    def __init__(self, num_heads: int, in_dim: int, hidden_dim: int,
                 proj_dim: int, num_prototypes: int, num_hidden_layers: int):
        super().__init__()
        self.num_hidden_layers = num_hidden_layers
        d = in_dim
        for i in range(num_hidden_layers):
            self.add_module(f"fc{i}", _StackedDense(num_heads, d, hidden_dim))
            self.add_module(f"ln{i}", _StackedLayerNorm(num_heads,
                                                        hidden_dim))
            d = hidden_dim
        self.out = _StackedDense(num_heads, d, proj_dim)
        self.prototypes = _param(num_heads, proj_dim, num_prototypes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        for i in range(self.num_hidden_layers):
            x = getattr(self, f"fc{i}")(x)
            x = F.relu(getattr(self, f"ln{i}")(x))
        z = _unit(self.out(x), -1)
        return torch.bmm(z, _unit(self.prototypes, 1)), z


class MultiHeadPrototypes(nn.Module):
    """H independent (projector MLP -> unit-norm prototype layer) heads
    (reference ``MultiHead``, ``uno_v2_utils.py:64-91``): feats [B, D] ->
    (logits [H, B, P], proj [H, B, proj_dim]).  ``in_dim`` is D (Flax
    infers it at init)."""

    def __init__(self, in_dim: int, num_heads: int = 4,
                 hidden_dim: int = 2048, proj_dim: int = 256,
                 num_prototypes: int = 100, num_hidden_layers: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.add_module("Vmap_Head_0", _Heads(
            num_heads, in_dim, hidden_dim, proj_dim, num_prototypes,
            num_hidden_layers))

    def forward(self, feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return getattr(self, "Vmap_Head_0")(feats)


def swapped_prediction_loss(logits: torch.Tensor, targets: torch.Tensor,
                            temperature: float = 0.1) -> torch.Tensor:
    """Cross-view swapped CE (reference ``uno_v2.py:47-57``):
    logits/targets [V, H, B, C]; view v is scored against view w's
    targets."""
    v = logits.shape[0]
    logp = F.log_softmax(logits / temperature, dim=-1)
    loss, n_terms = 0.0, 0
    for view in range(v):
        for other in range(v):
            if other != view:
                loss = loss - (targets[view] * logp[other]).sum(-1).mean()
                n_terms += 1
    return loss / n_terms


def _one_hot(labels: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot``: a zero row for a label outside [0, n)."""
    return (labels[:, None] == torch.arange(n, device=labels.device)
            ).float()


def uno_targets(logits_unlab: torch.Tensor, labels: torch.Tensor,
                mask_lab: torch.Tensor, n_labeled_classes: int,
                sk_iters: int = 3, sk_epsilon: float = 0.05) -> torch.Tensor:
    """Targets [V, H, B, nlc+P]: labelled rows one-hot in the first nlc
    columns; unlabelled rows get Sinkhorn pseudo-labels over the
    prototype block, Sinkhorn run on the UNLABELLED rows only (reference
    uno_v2.py:115-121: with labelled rows in the transport problem they
    would absorb cluster mass)."""
    v, h, b, _p = logits_unlab.shape
    mask_lab = mask_lab.bool()
    pseudo = sinkhorn_knopp(logits_unlab, sk_iters, sk_epsilon,
                            row_mask=~mask_lab)
    m = mask_lab[:, None]
    lab_part = torch.where(m, _one_hot(labels, n_labeled_classes), 0.0)
    unlab_part = torch.where(m, 0.0, pseudo)
    return torch.cat([lab_part.expand(v, h, b, n_labeled_classes),
                      unlab_part], dim=-1)


# --------------------------------------------------------------- AutoNovel

def ranking_stats_similarity(feats: torch.Tensor,
                             topk: int = 5) -> torch.Tensor:
    """Pairwise +-1 pseudo-labels from top-k feature-rank agreement
    (reference ``rerun_autonovel.py:64-74``): +1 when two samples share
    an identical sorted top-k feature-index set.  Returns [B, B] f32.  The
    sort is stable, as ``jnp.argsort``'s: among tied values the lower
    index ranks first, and ties decide the pairs."""
    rank_idx = torch.argsort(-feats, dim=1, stable=True)[:, :topk]
    rank_sorted = torch.sort(rank_idx, dim=1).values  # [B, k]
    diff = (rank_sorted[:, None, :] - rank_sorted[None, :, :]).abs().sum(-1)
    return torch.where(diff == 0, 1.0, -1.0)


def pairwise_bce(prob1: torch.Tensor, prob2: torch.Tensor,
                 simi: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """AutoNovel's pairwise BCE (reference ``cluster_utils.py:142-151``):
    P = <p_i, p_j>; loss = -log(P) for similar, -log(1-P) for dissimilar.
    prob1/prob2 [N, C] enumerate pairs row-major; simi in {+1, -1, 0}."""
    return _bce_of_inner(torch.sum(prob1 * prob2, dim=1), simi, eps)


def _bce_of_inner(p: torch.Tensor, simi: torch.Tensor,
                  eps: float = 1e-7) -> torch.Tensor:
    p = p * simi + (simi == -1).to(p.dtype)
    valid = simi != 0
    neglog = -torch.log(p + eps)
    return torch.where(valid, neglog, 0.0).sum() / torch.clamp_min(
        valid.sum(), 1)


class TwoHeadClassifier(nn.Module):
    """Feature trunk with the reference's two output heads
    (``rerun_autonovel.py:339``): ``head1`` spans ALL classes (labelled
    CE, pairwise BCE, eval); ``head2`` (novel classes) exists for
    architecture parity and no loss touches it.  Flax names ``trunk``,
    ``head1``, ``head2``; returns (out1, out2, trunk features)."""

    def __init__(self, in_dim: int, num_labeled: int, num_unlabeled: int,
                 hidden_dim: int = 512):
        super().__init__()
        f32 = torch.float32
        self.trunk = Dense(in_dim, hidden_dim, f32)
        self.head1 = Dense(hidden_dim, num_labeled + num_unlabeled, f32)
        self.head2 = Dense(hidden_dim, num_unlabeled, f32)

    def forward(self, feats: torch.Tensor):
        x = F.relu(self.trunk(feats))
        return self.head1(x), self.head2(x), x


def autonovel_loss(output1: torch.Tensor, output1_bar: torch.Tensor,
                   feats: torch.Tensor, labels: torch.Tensor,
                   mask_lab: torch.Tensor, rampup_weight: float,
                   topk: int = 5, kl_weight: float = 0.0
                   ) -> Dict[str, torch.Tensor]:
    """The AutoNovel objective (reference ``rerun_autonovel.py:55-84``) on
    the all-classes head: CE on labelled rows, pairwise ranking-stats BCE
    across two views over the full batch, MSE consistency, uniform-KL.

    The ranking statistics run on ``feats`` detached (the reference's
    ``rank_feat = feat.detach()``, rerun_autonovel.py:66).  The pair (i, j)
    row-major is <p1_i, p1bar_j>, one entry of ``prob1 @ prob1_bar.T``
    (the JAX package repeats and tiles the rows; the same sums).

    ``kl_weight`` note: the reference passes PROBABILITIES to
    ``F.kl_div`` (which expects log-probabilities,
    rerun_autonovel.py:83), making its KL term a CONSTANT with zero
    gradient, so the reference's kl_div_loss=0.5 has no training effect
    and the default 0.0 matches its effective objective.  kl_weight > 0
    enables a real collapse regularizer (KL of the batch-mean prediction
    to uniform)."""
    prob1 = F.softmax(output1, dim=1)
    prob1_bar = F.softmax(output1_bar, dim=1)

    simi = ranking_stats_similarity(feats.detach(), topk)
    loss_bce = _bce_of_inner((prob1 @ prob1_bar.T).reshape(-1),
                             simi.reshape(-1))

    # CE on labelled rows of the all-classes head (masked mean)
    mask_lab = mask_lab.bool()
    logp = F.log_softmax(output1, dim=-1)
    idx = labels.long().clamp(0, output1.shape[1] - 1)[:, None]
    ce_rows = -logp.gather(1, idx)[:, 0]
    loss_ce = torch.where(mask_lab, ce_rows, 0.0).sum() / torch.clamp_min(
        mask_lab.sum(), 1)

    consistency = 2.0 * ((prob1 - prob1_bar) ** 2).mean()
    # collapse regularizer: KL of the BATCH-MEAN prediction to uniform
    mean_p = prob1.mean(dim=0)
    kl = (mean_p * (torch.log(mean_p + 1e-12)
                    - np.log(1.0 / prob1.shape[1]))).sum()

    total = loss_ce + loss_bce + rampup_weight * consistency \
        + kl_weight * kl
    return {"loss": total, "ce": loss_ce, "bce": loss_bce,
            "consistency": consistency, "kl": kl}


# ------------------------------------------- supervised + combine evaluator

def osr_threshold_preds(logits: torch.Tensor,
                        threshold: float) -> torch.Tensor:
    """Open-set recognition: argmax where the max softmax prob clears the
    threshold, else -1 (reference ``train_supervised.py:68-130``)."""
    prob = F.softmax(torch.as_tensor(logits), dim=-1)
    conf = prob.amax(dim=-1)
    preds = torch.argmax(prob, dim=-1)  # the first of tied maxima
    return torch.where(conf >= threshold, preds, -1)


def combine_classifier_and_cluster_preds(classifier_preds, cluster_preds,
                                         n_labeled_classes: int):
    """Classifier wins on confident Old-class predictions; cluster
    assignment covers the rest (reference
    ``combine_classifier_and_kmeans.py``).  numpy in and out."""
    classifier_preds = np.asarray(classifier_preds)
    cluster_preds = np.asarray(cluster_preds)
    use_cls = (classifier_preds >= 0) & (classifier_preds
                                         < n_labeled_classes)
    return np.where(use_cls, classifier_preds, cluster_preds)


# ------------------------------------------------------ training loops
#
# The reference trains these baselines end to end over a ResNet / ViT; in
# the GCD setting the backbone is frozen and only the heads learn, so
# these trainers run over precomputed feature views (the end-to-end ones
# are in ``baselines_e2e``).

def _batched(rng, n: int, batch_size: int):
    order = rng.permutation(n)
    for s in range(0, n - batch_size + 1, batch_size):
        yield order[s:s + batch_size]


def _epoch_mean(device_losses: List[torch.Tensor]) -> float:
    """Mean of per-step device scalars with ONE host fetch (a fetch per
    step would wait for each step's kernels)."""
    if not device_losses:
        return float("nan")
    return torch.stack(device_losses).mean().item()


def _init_params(model: nn.Module, seed: int) -> nn.Module:
    """Flax's default initializers from ``seed`` (``flax_init_``).  The
    trainers build every model through this one function, so a caller
    can load a carried parameter tree in its place."""
    return flax_init_(model, seed)


def _trainable(model: nn.Module, dev: torch.device) -> nn.Module:
    model = model.to(dev)
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def _on(x, dev, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    return t.to(dev, dtype) if dtype is not None else t.to(dev)


def _sgd(model: nn.Module, lr: float) -> torch.optim.SGD:
    """optax ``sgd(lr, momentum=0.9)``: momentum buffer g at the first
    step (optax's trace from zeros), then 0.9 buf + g; p -= lr buf."""
    return torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9,
                           dampening=0.0, nesterov=False)


def _fill_grads(opt: torch.optim.Optimizer) -> None:
    """A zero gradient for every parameter the loss did not reach (the
    AutoNovel head2): optax updates every leaf, so weight decay and the
    momentum trace reach such a parameter too, where torch's SGD would
    skip it."""
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


def _sgd_step(opt: torch.optim.Optimizer, loss: torch.Tensor,
              mesh=None) -> None:
    """backward, then SGD; over a ``mesh`` (data parallel) the ranks'
    gradients are summed first, in one packed ``all_reduce``."""
    opt.zero_grad(set_to_none=True)
    loss.backward()
    if mesh is not None:
        multihost.all_reduce_grads(
            [p for g in opt.param_groups for p in g["params"]],
            group=mesh.data_group)
    _fill_grads(opt)
    opt.step()


def train_uno(init_seed: int, views, labels, mask_lab, n_labeled: int,
              n_unlabeled: int, num_heads: int = 4, epochs: int = 10,
              batch_size: int = 256, lr: float = 0.1, sk_iters: int = 3,
              sk_epsilon: float = 0.05, temperature: float = 0.1,
              seed: int = 0, device="cuda"
              ) -> Tuple[nn.Module, Callable, List[float]]:
    """UNO v2 over feature views (reference train loop
    ``uno_v2.py:96-160``): multi-head prototypes on nlc+P logits, Sinkhorn
    pseudo-labels on the prototype block, swapped-prediction CE across
    views.

    ``views``: [V, N, D] float, V augmented views of N features (moved to
    ``device`` once).  Returns (the trained :class:`MultiHeadPrototypes`,
    whose state dict carries the Flax names; predict_fn [N, D] ->
    [N] int64 on the device; history of per-epoch mean losses)."""
    dev = resolve_device(device)
    views = _on(views, dev, torch.float32)
    labels = _on(labels, dev, torch.int64)
    mask_lab = _on(mask_lab, dev, torch.bool)
    v, n, d = views.shape
    batch_size = min(batch_size, n)  # n < batch would yield no step
    model = _trainable(_init_params(MultiHeadPrototypes(
        d, num_heads=num_heads, num_prototypes=n_labeled + n_unlabeled),
        init_seed), dev)
    opt = _sgd(model, lr)

    def loss_fn(batch_views, lab, m_lab):
        logits = torch.stack([model(batch_views[i])[0]
                              for i in range(v)])  # [V, H, B, nlc+P]
        targets = uno_targets(logits[..., n_labeled:].detach(), lab, m_lab,
                              n_labeled, sk_iters, sk_epsilon)
        return swapped_prediction_loss(logits, targets, temperature)

    rng = np.random.default_rng(seed)
    history = []
    for _epoch in range(epochs):
        losses = []
        for idx in _batched(rng, n, batch_size):
            i = torch.as_tensor(idx, device=dev)
            loss = loss_fn(views[:, i], labels[i], mask_lab[i])
            _sgd_step(opt, loss)
            losses.append(loss.detach())  # read once per epoch
        history.append(_epoch_mean(losses))

    def predict(feats) -> torch.Tensor:
        with torch.no_grad():
            logits, _ = model(_on(feats, dev, torch.float32))  # [H, B, C]
            return torch.argmax(F.softmax(logits, dim=-1).mean(dim=0),
                                dim=-1)

    return model, predict, history


def train_autonovel(init_seed: int, feats, feats_bar, labels, mask_lab,
                    n_labeled: int, n_unlabeled: int, epochs: int = 10,
                    batch_size: int = 256, lr: float = 0.1,
                    rampup_length: float = 150.0, rampup_coeff: float = 50.0,
                    topk: int = 5, seed: int = 0, device="cuda"
                    ) -> Tuple[nn.Module, Callable, List[float]]:
    """AutoNovel over two feature views (reference
    ``rerun_autonovel.py:44-110``): ranking-stats pairwise BCE + labelled
    CE on the all-classes head + MSE consistency with a sigmoid-ramped
    weight (the reference's rampup_length=150 / rampup_coefficient=50,
    rerun_autonovel.py:192-193).  The ranking statistics run on the
    frozen input features (the trainable trunk is a random projection at
    init).  Returns (the trained :class:`TwoHeadClassifier`, predict_fn ->
    all-class ids, history)."""
    dev = resolve_device(device)
    feats = _on(feats, dev, torch.float32)
    feats_bar = _on(feats_bar, dev, torch.float32)
    labels = _on(labels, dev, torch.int64)
    mask_lab = _on(mask_lab, dev, torch.bool)
    n, d = feats.shape
    batch_size = min(batch_size, n)
    model = _trainable(_init_params(TwoHeadClassifier(
        d, n_labeled, n_unlabeled), init_seed), dev)
    opt = _sgd(model, lr)

    def loss_fn(x, x_bar, lab, m_lab, w):
        o1, _o2, _trunk = model(x)
        o1b, _, _ = model(x_bar)
        return autonovel_loss(o1, o1b, x, lab, m_lab, w, topk=topk)["loss"]

    rng = np.random.default_rng(seed)
    history = []
    for epoch in range(epochs):
        w = rampup_coeff * sigmoid_rampup(epoch, rampup_length)
        losses = []
        for idx in _batched(rng, n, batch_size):
            i = torch.as_tensor(idx, device=dev)
            loss = loss_fn(feats[i], feats_bar[i], labels[i], mask_lab[i], w)
            _sgd_step(opt, loss)
            losses.append(loss.detach())
        history.append(_epoch_mean(losses))

    def predict(x) -> torch.Tensor:
        with torch.no_grad():
            return torch.argmax(model(_on(x, dev, torch.float32))[0], dim=-1)

    return model, predict, history


class _Head(nn.Module):
    """``train_supervised``'s head: optional ``fc`` + ReLU, then ``out``."""

    def __init__(self, in_dim: int, n_classes: int, hidden_dim: int = 0):
        super().__init__()
        f32 = torch.float32
        self.fc = Dense(in_dim, hidden_dim, f32) if hidden_dim else None
        self.out = Dense(hidden_dim or in_dim, n_classes, f32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fc is not None:
            x = F.relu(self.fc(x))
        return self.out(x)


def train_supervised(init_seed: int, feats, labels, n_classes: int,
                     epochs: int = 20, batch_size: int = 256,
                     lr: float = 0.1, smoothing: float = 0.1,
                     hidden_dim: int = 0, seed: int = 0, device="cuda"
                     ) -> Tuple[nn.Module, Callable, List[float]]:
    """Label-smoothed supervised head on labelled features (reference
    ``train_supervised.py:38-66`` + training loop).  Returns (the trained
    head, logits_fn, history); combine with :func:`osr_threshold_preds` +
    :func:`combine_classifier_and_cluster_preds`."""
    dev = resolve_device(device)
    feats = _on(feats, dev, torch.float32)
    labels = _on(labels, dev, torch.int64)
    n, d = feats.shape
    batch_size = min(batch_size, n)
    model = _trainable(_init_params(_Head(d, n_classes, hidden_dim),
                                    init_seed), dev)
    opt = _sgd(model, lr)

    rng = np.random.default_rng(seed)
    history = []
    for _epoch in range(epochs):
        losses = []
        for idx in _batched(rng, n, batch_size):
            i = torch.as_tensor(idx, device=dev)
            loss = label_smoothing_ce(model(feats[i]), labels[i], smoothing)
            _sgd_step(opt, loss)
            losses.append(loss.detach())
        history.append(_epoch_mean(losses))

    def logits_fn(x) -> torch.Tensor:
        with torch.no_grad():
            return model(_on(x, dev, torch.float32))

    return model, logits_fn, history
