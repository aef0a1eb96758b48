"""End-to-end (trunk-finetuning) UNO v2 and AutoNovel baselines.

Port of ``scd_tpu/train/baselines_e2e.py``.  The frozen-feature trainers
in ``train.baselines`` cover the GCD setting; the reference also trains
these methods THROUGH the backbone with SGD and a scheduled LR,
evaluating every epoch:

- UNO v2 (``gcd/methods/baselines/uno_v2.py:62-170``): SGD +
  ``LinearWarmupCosineAnnealingLR``, the per-head swapped-prediction loss
  accumulated into a per-head tracker, per-epoch eval with the **best
  head** (argmin of the accumulated cluster loss).
- AutoNovel (``gcd/methods/baselines/rerun_autonovel.py:42-110``): SGD +
  StepLR, ranking statistics on the model's own DETACHED trunk features,
  sigmoid-ramped consistency weight, per-epoch eval.

Every parameter trains (all blocks of the ViT, at the ViT config's
``compute_dtype``: f32 unless the caller asks otherwise, as in the JAX
package).  One step is the backbone's forward over all views, the heads,
the pseudo-labels, ``backward`` and the SGD update, in place; the
trainable blocks' attention goes through
``ops.attention.AttentionFunction``, so on a CUDA device the forward is
``csrc/attention.cu`` and the gradient ``csrc/attention_bwd.cu``.  Per-step
losses and the per-head tracker stay on the device until the epoch's end
(one read an epoch).  The optimizer is optax's ``add_decayed_weights(wd)``
then ``sgd(lr, momentum)``: ``torch.optim.SGD(momentum, weight_decay,
dampening=0)``, with UNO's lr set each step from the warmup-cosine
schedule (``gcd.ScheduledSGD``) and AutoNovel's once an epoch.
Parameters start from Flax's default initializers
(``baselines._init_params``), under the JAX tree's names (``backbone.*``,
``heads.*``, ``heads_over.*``).

Over a ``mesh`` (``scd_tpu/train/baselines_e2e.py:119-129, 256-300,
408-432``: data parallel over the ``data`` axis, one rank per device)
every rank builds the same parameters, draws the same batch indices and
runs the backbone on its contiguous block of each batch
(:func:`_mesh_batch_size` rounds the batch down to a multiple of the
axis).  In-memory arrays are the full data on every rank; a streamed
``views`` / ``images`` callable yields THIS RANK's block of each batch.
What stays global: UNO's Sinkhorn pseudo-labels (the detached head
logits are gathered, ``uno_targets`` runs on the global batch and each
rank keeps its rows; the swapped cross-entropy is the local rows' sum
over the global batch size, and the per-head losses, hence
``best_head``, are all-reduced), AutoNovel's pairwise ranking statistics
(the detached backbone features are gathered; ``output1`` /
``output1_bar`` are gathered with their gradient,
``core.multihost.all_gather_rows``, for the pairwise BCE).  The gradients
are summed in one packed ``all_reduce`` before each SGD step, and each
predictor splits its batches over the ranks, as serving does.

A ``model`` axis above 1 is tensor parallelism, the JAX package's
``_shard_setup`` (``scd_tpu/train/baselines_e2e.py:92-116``): every rank
builds the full model and keeps its shard of the backbone
(``models.params.shard_module``, the GCD trainer's layout); the heads
stay whole (their stacked or differently named parameters match no
tensor-parallel rule).  The data-parallel collectives above run over
the ``data`` group alone, and only when it has more than one rank;
model ranks take the same rows.  A checkpoint's state is gathered whole
(``models.params.gather_state_dict``, the momentum with
``train.checkpoint.gather_optimizer_state``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from scd_tpu_torch.core import multihost
from scd_tpu_torch.core.device import resolve_device
from scd_tpu_torch.core.mesh import data_mesh, model_group, train_mesh
from scd_tpu_torch.models.params import gather_state_dict, shard_module
from scd_tpu_torch.models.vit import ViTConfig, VisionTransformer
from scd_tpu_torch.pipelines.common import _pod_shard
from scd_tpu_torch.train import baselines as B
from scd_tpu_torch.train.checkpoint import gather_optimizer_state
from scd_tpu_torch.train.gcd import ScheduledSGD
from scd_tpu_torch.train.schedulers import (cosine_warmup_schedule,
                                            sigmoid_rampup)


def _swapped_loss_per_head(logits: torch.Tensor, targets: torch.Tensor,
                           temperature: float,
                           n_rows: Optional[int] = None) -> torch.Tensor:
    """Per-head swapped-prediction CE: logits/targets [V, H, B, C] ->
    [H].  The reference accumulates exactly this into ``loss_per_head``
    for best-head selection (``uno_v2.py:133``).  ``n_rows``: divide the
    sum over these B rows by the global batch instead of taking their
    mean (one rank's share of a data-parallel batch)."""
    v = logits.shape[0]
    logp = F.log_softmax(logits / temperature, dim=-1)
    per_head = torch.zeros(logits.shape[1], dtype=torch.float32,
                           device=logits.device)
    n_terms = 0
    for view in range(v):
        for other in range(v):
            if other != view:
                # mean over batch, sum over classes; keep the head axis
                rows = (targets[view] * logp[other]).sum(-1)
                per_head = per_head - (rows.mean(-1) if n_rows is None
                                       else rows.sum(-1) / n_rows)
                n_terms += 1
    return per_head / n_terms


def _mesh_batch_size(batch_size: int, mesh, n: int) -> int:
    """Largest batch <= batch_size that splits evenly over the data axis;
    a batch below the axis size raises."""
    batch_size = min(batch_size, n)
    if mesh is None:
        return batch_size
    d = mesh.n_data
    if batch_size < d:
        raise ValueError(f"batch_size {batch_size} < data-axis size {d}")
    return batch_size - batch_size % d


def _gathered(t: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order, no
    gradient (the identity without a mesh)."""
    if mesh is None:
        return t
    return torch.cat(multihost.all_gather(t.detach(), group=mesh.data_group),
                     dim=dim)


def _run_epochs(epochs: int, epoch_fn, eval_fn, best_metric: str,
                log_fn, ckpt=None, get_state=None) -> Tuple[list,
                                                            Optional[dict]]:
    """Shared epoch loop: ``epoch_fn(epoch) -> metrics`` then
    ``eval_fn(epoch) -> dict``; the best epoch by ``best_metric`` (the
    reference keeps the best checkpoint by eval ACC).  With ``ckpt`` (a
    ``train.checkpoint.CheckpointManager``) and ``get_state``, every epoch
    is checkpointed with its metrics (the manager's best-metric tracking
    is the reference's ``model_best.pt``)."""
    history, best = [], None
    for epoch in range(epochs):
        metrics = epoch_fn(epoch)
        if eval_fn is not None:
            metrics.update(eval_fn(epoch) or {})
        history.append(metrics)
        if best_metric in metrics and (
                best is None or metrics[best_metric] > best[best_metric]):
            best = dict(metrics, epoch=epoch)
        if ckpt is not None and get_state is not None:
            ckpt.save(epoch, get_state(), metrics={
                k: float(v) for k, v in metrics.items()
                if isinstance(v, (int, float, np.floating, np.integer))})
        if log_fn is not None:
            msg = " | ".join(
                f"{k} {v:.4f}" for k, v in metrics.items()
                if isinstance(v, (int, float)) and np.isfinite(v))
            log_fn(f"Epoch {epoch}: {msg}")
    return history, best


class UNOModel(nn.Module):
    """The backbone, the prototype heads and, with overclustering, the
    second block of heads: the JAX package's ``{"backbone", "heads",
    "heads_over"}`` tree.  ``tp``: the backbone's tensor-parallel
    context."""

    def __init__(self, vit_cfg: ViTConfig, num_heads: int, n_protos: int,
                 n_protos_over: int = 0, tp=None):
        super().__init__()
        feat_dim = vit_cfg.output_proj or vit_cfg.width
        self.backbone = VisionTransformer(vit_cfg, tp=tp)
        self.heads = B.MultiHeadPrototypes(feat_dim, num_heads=num_heads,
                                           num_prototypes=n_protos)
        self.heads_over = (B.MultiHeadPrototypes(
            feat_dim, num_heads=num_heads, num_prototypes=n_protos_over)
            if n_protos_over else None)


class AutoNovelModel(nn.Module):
    """The backbone and the two-head classifier (``{"backbone",
    "heads"}``); ``tp`` as :class:`UNOModel`'s."""

    def __init__(self, vit_cfg: ViTConfig, n_labeled: int,
                 n_unlabeled: int, tp=None):
        super().__init__()
        feat_dim = vit_cfg.output_proj or vit_cfg.width
        self.backbone = VisionTransformer(vit_cfg, tp=tp)
        self.heads = B.TwoHeadClassifier(feat_dim, n_labeled, n_unlabeled)


def _predictor(forward, dev, mesh=None):
    """``predict(images, batch=256) -> numpy``: ``forward`` over batches
    of host images, no graph.  Over a ``mesh`` (the images the same on
    every rank) each rank runs its share of each batch and the
    predictions are gathered, in order, on every rank."""

    def run(x: np.ndarray) -> np.ndarray:
        if mesh is None:
            return forward(torch.as_tensor(x).to(dev)).cpu().numpy()
        local, valid = multihost.rows_from_process_local(
            mesh, _pod_shard(x, mesh), pad=True, device=dev)
        full = multihost.host_fetch(forward(local), mesh)
        return full if valid is None else full[valid]

    def predict(images, batch: int = 256) -> np.ndarray:
        images = np.asarray(images, np.float32)
        with torch.no_grad():
            return np.concatenate([run(images[s:s + batch])
                                   for s in range(0, len(images), batch)])

    return predict


def train_uno_e2e(init_seed: int, views, labels: np.ndarray = None,
                  mask_lab: np.ndarray = None, n_labeled: int = 0,
                  n_unlabeled: int = 0, vit_cfg: ViTConfig = None,
                  num_heads: int = 4, epochs: int = 10,
                  batch_size: int = 64, lr: float = 0.4,
                  min_lr: float = 1e-3, warmup_epochs: int = 2,
                  momentum: float = 0.9, weight_decay: float = 1e-4,
                  sk_iters: int = 3, sk_epsilon: float = 0.05,
                  temperature: float = 0.1, overcluster_factor: int = 0,
                  steps_per_epoch: int = None, seed: int = 0,
                  eval_fn: Optional[Callable] = None,
                  best_metric: str = "acc", log_fn=None, ckpt=None,
                  mesh=None, device="cuda"):
    """UNO v2 trained through a ViT backbone (reference
    ``uno_v2.py:62-170``): multi-head prototype heads over backbone
    features, Sinkhorn pseudo-labels, swapped-prediction CE, SGD with
    linear-warmup cosine LR, per-head loss tracking and best-head
    prediction.

    ``views``: [V, N, H, W, C] float image views held in memory, OR a
    callable ``views(epoch, rng) -> iterator of (batch_views [V, B, ...],
    labels [B], mask_lab [B])`` (pass ``steps_per_epoch`` for the LR
    schedule; over a ``mesh`` it yields this rank's block of each batch).
    The backbone runs once a step over the flattened [V*B, ...] views.
    ``eval_fn(predict, epoch) -> dict`` runs every epoch; the
    best epoch by ``best_metric`` is tracked.

    ``overcluster_factor`` > 0 adds the reference's overclustering heads
    (``uno_v2_utils.py:142-146``: ``n_labeled + n_unlabeled * factor``
    prototypes; loss = (cluster + overcluster) / 2, ``uno_v2.py:127-130``;
    the best-head tracker takes the cluster loss only).

    Returns ``(state, predict_fn, history)``: ``state`` holds the model,
    the optimizer, the best-head index, the best epoch and ``step(views,
    labels, mask_lab) -> (loss, per-head loss)``, one SGD step on device
    tensors; ``predict_fn(images) -> labels`` (numpy) uses the best head.
    Over a ``mesh`` (``data x model``): see the module docstring."""
    mesh = train_mesh(mesh)
    # the data-parallel collectives run over ``mesh`` from here on
    tp, mesh = model_group(mesh), data_mesh(mesh)
    dev = resolve_device(device)
    if callable(views):
        if not steps_per_epoch:
            raise ValueError("streaming views need steps_per_epoch "
                             "(drives the cosine LR schedule)")
        batches = views
    else:
        views = np.asarray(views, np.float32)
        n = views.shape[1]
        batch_size = _mesh_batch_size(batch_size, mesh, n)
        labels = np.asarray(labels)
        mask_lab = np.asarray(mask_lab)
        steps_per_epoch = steps_per_epoch or max(n // batch_size, 1)

        def batches(_epoch, rng):
            for idx in B._batched(rng, n, batch_size):
                idx = _pod_shard(idx, mesh)
                yield views[:, idx], labels[idx], mask_lab[idx]

    n_over = (n_labeled + n_unlabeled * overcluster_factor
              if overcluster_factor > 0 else 0)
    model = B._trainable(shard_module(
        B._init_params(UNOModel(vit_cfg, num_heads, n_labeled + n_unlabeled,
                                n_over), init_seed),
        lambda: UNOModel(vit_cfg, num_heads, n_labeled + n_unlabeled,
                         n_over, tp=tp), tp), dev)

    total_steps = epochs * steps_per_epoch
    # short runs: warmup must leave >= 1 decay step
    warmup_steps = min(warmup_epochs * steps_per_epoch, total_steps - 1)
    schedule = cosine_warmup_schedule(lr, warmup_steps=max(warmup_steps, 0),
                                      total_steps=total_steps,
                                      final_lr=min_lr)
    opt = ScheduledSGD(list(model.parameters()), schedule, momentum,
                       weight_decay)

    def head_loss(module, feats, lab, m_lab):
        """``lab`` / ``m_lab``: the global batch's (over a mesh)."""
        logits = torch.stack([module(f)[0] for f in feats])  # [V, H, b, C]
        unlab = logits[..., n_labeled:].detach()
        if mesh is None:
            targets = B.uno_targets(unlab, lab, m_lab, n_labeled, sk_iters,
                                    sk_epsilon)
            return _swapped_loss_per_head(logits, targets, temperature)
        # the pseudo-labels of the global batch; this rank keeps its rows
        b = logits.shape[2]
        lo = mesh.data_index * b
        targets = B.uno_targets(_gathered(unlab, mesh, dim=2), lab, m_lab,
                                n_labeled, sk_iters, sk_epsilon)
        return _swapped_loss_per_head(logits, targets[:, :, lo:lo + b],
                                      temperature, n_rows=len(lab))

    def step(batch_views, lab, m_lab):
        n_v, vb = batch_views.shape[:2]
        lab, m_lab = _gathered(lab, mesh), _gathered(m_lab, mesh)
        flat = batch_views.reshape((-1,) + tuple(batch_views.shape[2:]))
        feats = model.backbone(flat).reshape(n_v, vb, -1)
        per_head = head_loss(model.heads, feats, lab, m_lab)
        loss = per_head.mean()
        if model.heads_over is not None:
            # reference: loss = (cluster + overcluster) / 2
            loss = (loss + head_loss(model.heads_over, feats, lab,
                                     m_lab).mean()) / 2
        loss.backward()
        out = torch.cat([loss.detach().reshape(1), per_head.detach()])
        if mesh is not None:
            multihost.all_reduce_grads(opt.sgd.param_groups[0]["params"],
                                       group=mesh.data_group)
            # this rank's share of the loss and of each head's: summed
            out = multihost.all_reduce(out, group=mesh.data_group)
        B._fill_grads(opt.sgd)
        opt.step()
        return out[0], out[1:]

    state = {"model": model, "optimizer": opt, "best_head": 0, "step": step}

    def forward(images):
        logits, _ = model.heads(model.backbone(images))  # [H, B, C]
        return torch.argmax(logits[state["best_head"]], dim=-1)

    predict = _predictor(forward, dev, mesh)
    rng = np.random.default_rng(seed)

    def epoch_fn(epoch):
        tracker = torch.zeros(num_heads, dtype=torch.float32, device=dev)
        losses = []
        for bv, lab, m in batches(epoch, rng):
            loss, per_head = step(
                torch.as_tensor(np.asarray(bv, np.float32)).to(dev),
                torch.as_tensor(np.asarray(lab)).to(dev, torch.int64),
                torch.as_tensor(np.asarray(m)).to(dev, torch.bool))
            tracker = tracker + per_head
            losses.append(loss)
        # ONE read for the epoch: the tracker and the stacked losses
        state["best_head"] = int(np.argmin(tracker.cpu().numpy()))
        return {"loss": B._epoch_mean(losses),
                "best_head": state["best_head"]}

    history, best = _run_epochs(
        epochs, epoch_fn,
        (lambda epoch: eval_fn(predict, epoch)) if eval_fn else None,
        best_metric, log_fn, ckpt=ckpt,
        get_state=lambda: {"model": gather_state_dict(model.state_dict(),
                                                      tp),
                           "best_head": state["best_head"],
                           "optimizer": gather_optimizer_state(
                               opt.sgd, model, tp),
                           "step": opt.count})
    state["best"] = best
    return state, predict, history


def train_autonovel_e2e(init_seed: int, images,
                        images_bar: np.ndarray = None,
                        labels: np.ndarray = None,
                        mask_lab: np.ndarray = None, n_labeled: int = 0,
                        n_unlabeled: int = 0, vit_cfg: ViTConfig = None,
                        epochs: int = 10, batch_size: int = 64,
                        lr: float = 0.1, momentum: float = 0.9,
                        weight_decay: float = 1e-4, step_size: int = 170,
                        gamma: float = 0.1, rampup_length: float = 150.0,
                        rampup_coeff: float = 50.0, topk: int = 5,
                        seed: int = 0, eval_fn: Optional[Callable] = None,
                        best_metric: str = "acc", log_fn=None, ckpt=None,
                        mesh=None, device="cuda"):
    """AutoNovel trained through a ViT backbone (reference
    ``rerun_autonovel.py:42-110``): two augmented views (two backbone
    passes a step), ranking statistics on the model's own detached trunk
    features, pairwise BCE + labelled CE + ramped MSE consistency, SGD +
    StepLR set at each epoch's start (``lr * gamma ** ((epoch + 1) //
    step_size)``, torch's last_epoch semantics), per-epoch eval.

    ``images`` may instead be a callable ``images(epoch, rng) -> iterator
    of (x [B, ...], x_bar [B, ...], labels [B], mask_lab [B])`` (over a
    ``mesh`` this rank's block of each batch; see the module docstring).
    Returns
    ``(state, predict_fn, history)``: ``state`` holds the model, the
    optimizer, the best epoch and ``step(x, x_bar, labels, mask_lab, w) ->
    loss``, one SGD step on device tensors; ``predict_fn`` maps images to
    all-classes-head argmax ids (labelled classes first, as the
    reference's eval on ``output1.max(1)``)."""
    mesh = train_mesh(mesh)
    tp, mesh = model_group(mesh), data_mesh(mesh)  # as train_uno_e2e
    dev = resolve_device(device)
    if callable(images):
        batches = images
    else:
        images = np.asarray(images, np.float32)
        images_bar = np.asarray(images_bar, np.float32)
        n = images.shape[0]
        batch_size = _mesh_batch_size(batch_size, mesh, n)
        labels = np.asarray(labels)
        mask_lab = np.asarray(mask_lab)

        def batches(_epoch, rng):
            for idx in B._batched(rng, n, batch_size):
                idx = _pod_shard(idx, mesh)
                yield images[idx], images_bar[idx], labels[idx], mask_lab[idx]

    model = B._trainable(shard_module(
        B._init_params(AutoNovelModel(vit_cfg, n_labeled, n_unlabeled),
                       init_seed),
        lambda: AutoNovelModel(vit_cfg, n_labeled, n_unlabeled, tp=tp), tp),
        dev)
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum,
                          weight_decay=weight_decay, dampening=0.0,
                          nesterov=False)

    def step(x, x_bar, lab, m_lab, w):
        feats = model.backbone(x)
        feats_bar = model.backbone(x_bar)
        o1, _o2, _ = model.heads(feats)
        o1b, _, _ = model.heads(feats_bar)
        if mesh is not None:  # the global batch's pairs and statistics
            group = mesh.data_group
            o1 = multihost.all_gather_rows(o1, group).flatten(0, 1)
            o1b = multihost.all_gather_rows(o1b, group).flatten(0, 1)
            feats, lab, m_lab = (_gathered(t, mesh)
                                 for t in (feats, lab, m_lab))
        # ranking stats on the DETACHED trunk features of the current
        # model (reference ``rank_feat = feat.detach()``)
        loss = B.autonovel_loss(o1, o1b, feats.detach(), lab, m_lab, w,
                                topk=topk)["loss"]
        B._sgd_step(opt, loss, mesh)
        return loss.detach()

    state = {"model": model, "optimizer": opt, "step": step}
    predict = _predictor(
        lambda x: torch.argmax(model.heads(model.backbone(x))[0], dim=-1),
        dev, mesh)
    rng = np.random.default_rng(seed)

    def epoch_fn(epoch):
        for group in opt.param_groups:  # StepLR, stepped at epoch start
            group["lr"] = lr * gamma ** ((epoch + 1) // step_size)
        w = rampup_coeff * sigmoid_rampup(epoch, rampup_length)
        losses = []
        for x, x_bar, lab, m in batches(epoch, rng):
            losses.append(step(
                torch.as_tensor(np.asarray(x, np.float32)).to(dev),
                torch.as_tensor(np.asarray(x_bar, np.float32)).to(dev),
                torch.as_tensor(np.asarray(lab)).to(dev, torch.int64),
                torch.as_tensor(np.asarray(m)).to(dev, torch.bool), w))
        return {"loss": B._epoch_mean(losses), "rampup_w": w}

    history, best = _run_epochs(
        epochs, epoch_fn,
        (lambda epoch: eval_fn(predict, epoch)) if eval_fn else None,
        best_metric, log_fn, ckpt=ckpt,
        get_state=lambda: {"model": gather_state_dict(model.state_dict(),
                                                      tp),
                           "optimizer": gather_optimizer_state(opt, model,
                                                               tp)})
    state["best"] = best
    return state, predict, history
