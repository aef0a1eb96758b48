"""GCD contrastive finetuning.

Port of ``scd_tpu/train/gcd.py`` (reference
``gcd/methods/metric_learn/learn_metric.py:217-338``): finetune the last
ViT blocks with ``loss = (1-w) InfoNCE + w SupCon``, SGD + cosine LR, two
augmented views per image, a DINO projection head, balanced labelled /
unlabelled sampling.

- One step is forward, both losses, ``backward`` and the SGD update, in
  place on the model and the optimizer (JAX returns new trees).
- Partial freezing (blocks >= ``grad_from_block``, reference
  ``learn_metric.py:463-471``): the parameters ``_param_label`` marks
  ``train`` get ``requires_grad`` and are the optimizer's only ones; the
  frozen blocks build no autograd graph (their inputs need no gradient),
  take their cached casts and, under ``int8_frozen``, the W8A8 kernels.
- The optimizer is optax's ``add_decayed_weights(wd)`` then ``sgd(lr,
  momentum)``: ``torch.optim.SGD(momentum, weight_decay, dampening=0,
  nesterov=False)`` does the same arithmetic (momentum buffer ``g + wd p``
  at the first step, as optax's trace from zeros), with the lr of step
  ``count`` (optax reads its count before the increment) set before each
  update (:class:`ScheduledSGD`).
- Parameters start from Flax's default initializers drawn from a
  ``torch.Generator(seed)`` (``models.params.flax_init_``); a JAX tree
  loads with ``models.params.params_from_flax`` (names
  ``backbone.*`` and ``head.*``).
- Per-step metrics stay on the device and are read once per epoch.
- SupCon's labelled-only subset is a mask: unlabelled rows are excluded
  from anchors, positives and denominators.

Over a ``mesh`` (``scd_tpu/train/gcd.py:171-260``, data parallel over
the ``data`` axis, one rank per device) every rank builds the same
parameters from the seed and takes ITS block of each global batch
(:func:`stage_pod_batch`); it runs the tower on its rows, the projections
are gathered with their gradient (``core.multihost.all_gather_rows``)
into the global view-major order (view, then rank block, then row: the
JAX layout of ``stage_pod_batch``), so both losses see the global batch
and the metrics are global; the trainable gradients are summed in one
packed ``all_reduce`` and :class:`ScheduledSGD` steps identically on
every rank.

A ``model`` axis above 1 is tensor parallelism, the JAX package's
``_tp_spec`` (``scd_tpu/train/gcd.py:113-125``) by its names: every rank
builds the full model from the seed and keeps its shard
(``models.params.shard_module``): the backbone's qkv, proj, fc1 and fc2
and, by the same names, the head's fc1 (columns) and fc2 (rows); fc3
and ``last_layer`` stay whole.  The optimizer state lives on the shard.
Ranks that differ only on the ``model`` axis take the same rows, and the
data-parallel collectives (the projections' gather, the gradient
``all_reduce``) run over the ``data`` group alone, and only when it has
more than one rank.  :attr:`GCDTrainer.state` gathers full tensors,
momentum included (what a checkpoint holds), and
:meth:`GCDTrainer.load_state` cuts them back.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from scd_tpu_torch.core.config import TrainConfig
from scd_tpu_torch.core.device import resolve_device
from scd_tpu_torch.core.mesh import data_mesh, model_group, train_mesh
from scd_tpu_torch.core.multihost import (all_gather, all_gather_rows,
                                          all_reduce_grads,
                                          rows_from_process_local)
from scd_tpu_torch.models.params import (flax_init_, gather_state_dict,
                                         shard_module, shard_state_dict)
from scd_tpu_torch.models.vit import (Dense, ViTConfig, VisionTransformer,
                                      column_input, row_parallel, tp_split)
from scd_tpu_torch.train.checkpoint import (gather_optimizer_state,
                                            shard_optimizer_state)
from scd_tpu_torch.train.losses import cross_entropy, info_nce_loss
from scd_tpu_torch.train.schedulers import cosine_warmup_schedule


def _unit(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.norm(x, dim=dim, keepdim=True),
                               1e-12)


class DINOHead(nn.Module):
    """3-layer MLP projection head with a unit-norm final layer (reference
    ``learn_metric.py:30-77``; the weight-normed last layer keeps g = 1):
    fc1 -> GELU (erf) -> fc2 -> GELU -> fc3 -> L2 norm -> @ the
    column-normalized ``last_layer`` [bottleneck, out].  f32 throughout,
    Flax names and layouts.  Under ``tp`` fc1 is column-parallel and fc2
    row-parallel (their names match ``_tp_spec``'s)."""

    def __init__(self, in_dim: int, out_dim: int = 65536,
                 hidden_dim: int = 2048, bottleneck_dim: int = 256,
                 device=None, tp=None):
        super().__init__()
        f32 = torch.float32
        self.tp = tp
        local = tp_split(hidden_dim, tp, "the head's hidden width")
        self.fc1 = Dense(in_dim, local, f32, device=device)
        self.fc2 = Dense(local, hidden_dim, f32, device=device)
        self.fc3 = Dense(hidden_dim, bottleneck_dim, f32, device=device)
        self.last_layer = nn.Parameter(
            torch.zeros(bottleneck_dim, out_dim, device=device),
            requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.fc1(column_input(x, self.tp)))
        x = F.gelu(row_parallel(self.fc2, x, self.tp))
        x = _unit(self.fc3(x), -1)
        return x @ _unit(self.last_layer, 0)


class GCDModel(nn.Module):
    """The backbone and the projection head, as ``backbone`` and ``head``
    (the JAX package's ``{"backbone": ..., "head": ...}`` tree); ``tp``
    the tensor-parallel context of both."""

    def __init__(self, vit_cfg: ViTConfig, proj_dim: int, device=None,
                 tp=None):
        super().__init__()
        self.backbone = VisionTransformer(vit_cfg, device=device, tp=tp)
        self.head = DINOHead(vit_cfg.output_proj or vit_cfg.width,
                             out_dim=proj_dim, device=device, tp=tp)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.head(self.backbone(images))


def masked_supcon_loss(features: torch.Tensor, labels: torch.Tensor,
                       valid: torch.Tensor, temperature: float = 0.07,
                       base_temperature: float = 0.07) -> torch.Tensor:
    """SupCon over [B, V, D] restricted to rows where ``valid`` is True."""
    b, v, _ = features.shape
    flat = torch.cat(torch.unbind(features, dim=1), dim=0)  # view-major
    lab = labels.repeat(v)
    ok = valid.repeat(v)

    sim = flat @ flat.T / temperature
    sim = sim - sim.max(dim=1, keepdim=True).values.detach()

    eye = torch.eye(b * v, dtype=torch.bool, device=features.device)
    both_ok = ok[:, None] & ok[None, :]
    pos_mask = (lab[:, None] == lab[None, :]) & ~eye & both_ok
    logits_mask = ~eye & both_ok

    exp_sim = torch.exp(sim) * logits_mask
    log_prob = sim - torch.log(exp_sim.sum(1, keepdim=True) + 1e-12)

    pos_count = torch.clamp_min(pos_mask.sum(1), 1)
    mean_log_prob_pos = torch.where(
        pos_mask, log_prob, torch.zeros_like(log_prob)).sum(1) / pos_count
    per_anchor = -(temperature / base_temperature) * mean_log_prob_pos
    denom = torch.clamp_min(ok.sum(), 1)
    return torch.where(ok, per_anchor,
                       torch.zeros_like(per_anchor)).sum() / denom


def _param_label(path: Tuple[str, ...], grad_from_block: int) -> str:
    """'train' for head params, the final norm, and blocks >=
    grad_from_block; 'frozen' for the rest."""
    parts = [str(p) for p in path]
    joined = "/".join(parts)
    if joined.startswith("head"):
        return "train"
    for p in parts:
        if p.startswith("block_"):
            return "train" if int(p.split("_")[1]) >= grad_from_block else "frozen"
    if "norm" in joined or "ln_post" in joined:
        return "train"
    return "frozen"


class ScheduledSGD:
    """``optax.chain(add_decayed_weights(wd), sgd(schedule, momentum))``
    over ``params``: each :meth:`step` sets the lr to ``schedule(count)``,
    updates, clears the gradients and counts."""

    def __init__(self, params, schedule: Callable[[int], float],
                 momentum: float, weight_decay: float):
        self.schedule = schedule
        self.count = 0
        self.sgd = torch.optim.SGD(params, lr=schedule(0), momentum=momentum,
                                   weight_decay=weight_decay, dampening=0.0,
                                   nesterov=False)

    def step(self) -> None:
        lr = self.schedule(self.count)
        for group in self.sgd.param_groups:
            group["lr"] = lr
        self.sgd.step()
        self.sgd.zero_grad(set_to_none=True)
        self.count += 1


def gcd_loss(model: GCDModel, cfg: TrainConfig, batch: Dict[str, torch.Tensor],
             mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of one batch: ``images`` view-major [n_views*B, H,
    W, C], ``labels`` [B], ``mask_lab`` [B] bool.  Over a ``mesh`` (whose
    ``data`` axis has more than one rank: ``core.mesh.data_mesh``) the
    batch is this rank's block and the loss is the global batch's (see
    the module docstring)."""
    images = batch["images"]
    if images.dim() == 5:  # [n_views, B, H, W, C]: back to view-major
        images = images.reshape((-1,) + tuple(images.shape[2:]))
    lab, mask_lab = batch["labels"], batch["mask_lab"]
    proj = _unit(model(images), -1)
    if mesh is not None:
        group = mesh.data_group
        blocks = all_gather_rows(proj.reshape(cfg.n_views, lab.shape[0], -1),
                                 group)  # [W, V, b, P]
        proj = blocks.transpose(0, 1).reshape(-1, proj.shape[-1])
        lab = torch.cat(all_gather(lab, group))
        mask_lab = torch.cat(all_gather(mask_lab, group))

    logits, targets = info_nce_loss(proj, n_views=cfg.n_views,
                                    temperature=cfg.temperature)
    contrastive = cross_entropy(logits, targets)

    b = lab.shape[0]
    per_view = torch.stack(torch.chunk(proj, cfg.n_views, dim=0), dim=1)
    sup_con = masked_supcon_loss(per_view[:b], lab, mask_lab,
                                 temperature=cfg.sup_temperature)
    loss = ((1 - cfg.sup_con_weight) * contrastive
            + cfg.sup_con_weight * sup_con)
    return loss, {"loss": loss, "contrastive": contrastive,
                  "sup_con": sup_con}


def make_gcd_state(vit_cfg: ViTConfig, cfg: TrainConfig, seed: int = 0,
                   total_steps: int = 10_000, device="cuda", mesh=None,
                   params=None):
    """Build (model, optimizer, step).  ``step(model, optimizer, batch) ->
    metrics`` (0-d tensors on the device) takes one SGD step in place.
    The parameters start from Flax's initializers drawn from ``seed``, or
    from ``params``, a full state dict (``backbone.*``, ``head.*``; a JAX
    tree through ``models.params.params_from_flax``).  Over a ``mesh``
    (``data x model``; ``device`` the rank's own) the batch is this rank's
    block of the ``data`` axis (:func:`stage_pod_batch`) and the model
    this rank's shard of the ``model`` axis (the module docstring)."""
    mesh = train_mesh(mesh)
    dmesh, tp = data_mesh(mesh), model_group(mesh)
    dev = resolve_device(device)
    if cfg.int8_frozen and cfg.grad_from_block > 0:
        # the frozen blocks (< grad_from_block) never take a gradient:
        # their forward runs the W8A8 path
        vit_cfg = dataclasses.replace(vit_cfg,
                                      dense_int8_until=cfg.grad_from_block)
    full = GCDModel(vit_cfg, cfg.proj_dim)
    if params is None:
        flax_init_(full, seed)
    else:
        full.load_state_dict(params)
    model = shard_module(full, lambda: GCDModel(vit_cfg, cfg.proj_dim,
                                                tp=tp), tp).to(dev)
    trainable = []
    for name, p in model.named_parameters():
        train = _param_label(tuple(name.split(".")),
                             cfg.grad_from_block) == "train"
        p.requires_grad_(train)
        if train:
            trainable.append(p)
    # eta_min = lr * 1e-3, the reference's CosineAnnealingLR floor
    # (learn_metric.py:222-226)
    schedule = cosine_warmup_schedule(cfg.lr, warmup_steps=0,
                                      total_steps=total_steps,
                                      final_lr=cfg.lr * 1e-3)
    opt = ScheduledSGD(trainable, schedule, cfg.momentum, cfg.weight_decay)

    def step(model, opt, batch):
        loss, metrics = gcd_loss(model, cfg, batch, dmesh)
        loss.backward()
        if dmesh is not None:
            all_reduce_grads(trainable, group=dmesh.data_group)
        opt.step()
        return {k: v.detach() for k, v in metrics.items()}

    return model, opt, step


def stage_pod_batch(mesh, batch: Dict, n_views: int,
                    device=None) -> Dict[str, torch.Tensor]:
    """The step's input from THIS RANK's block of a global batch
    (``scd_tpu/train/gcd.py:204-225``): view-major images [n_views *
    B_local, H, W, C] become [n_views, B_local, H, W, C] on the rank's
    device, labels [B_local] int64 and mask_lab [B_local] bool.  Every
    rank must hold the same B_local (``rows_from_process_local``'s exact
    contract raises otherwise); the step gathers the ranks' blocks in
    rank order, so rank r's block is rows [r B_local, (r+1) B_local) of
    the global batch."""
    dev = mesh.device if device is None else resolve_device(device)
    imgs = torch.as_tensor(np.asarray(batch["images"]))
    bl = imgs.shape[0] // n_views
    labels, _ = rows_from_process_local(
        mesh, np.asarray(batch["labels"], np.int64), device=dev)
    mask, _ = rows_from_process_local(
        mesh, np.asarray(batch["mask_lab"], bool), device=dev)
    images = imgs.reshape((n_views, bl) + tuple(imgs.shape[1:])).to(
        dev, torch.float32)
    return {"images": images, "labels": labels, "mask_lab": mask}


class GCDTrainer:
    """Epoch driver (host loop) over a MergedDataset with two augmented
    views per image (reference ``ContrastiveLearningViewGenerator``,
    ``learn_metric.py:172-181``), on ``device`` (default ``cuda``), over
    an optional ``data x model`` mesh (the module docstring); ``seed`` and
    ``params`` as :func:`make_gcd_state`'s."""

    def __init__(self, vit_cfg: ViTConfig, cfg: TrainConfig,
                 seed: int = 0, total_steps: int = 10_000, mesh=None,
                 device="cuda", params=None):
        self.mesh = train_mesh(mesh)
        self.data_mesh, self.tp = data_mesh(self.mesh), model_group(self.mesh)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model, self.opt, self.step_fn = make_gcd_state(
            vit_cfg, cfg, seed, total_steps, device=self.device,
            mesh=self.mesh, params=params)
        self.metrics_log = []

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        """A host batch (numpy arrays) on the trainer's device; over a
        mesh this rank's block, staged by :func:`stage_pod_batch`."""
        if self.data_mesh is not None:
            return stage_pod_batch(self.data_mesh, batch, self.cfg.n_views,
                                   self.device)
        return {"images": torch.as_tensor(batch["images"]).to(
                    self.device, torch.float32),
                "labels": torch.as_tensor(batch["labels"]).to(
                    self.device, torch.int64),
                "mask_lab": torch.as_tensor(batch["mask_lab"]).to(
                    self.device, torch.bool)}

    def train_epoch(self, batches) -> Dict[str, float]:
        """``batches``: iterable of dicts with images (view-major
        [n_views*B, H, W, C]), labels [B], mask_lab [B]; over a mesh this
        rank's block of each global batch.  Per-step metrics (global over
        a mesh) stay on the device; at the end of the epoch their means
        are read in one transfer, keyed in sorted order (the JAX
        step's)."""
        device_metrics: Dict[str, list] = {}
        for batch in batches:
            metrics = self.step_fn(self.model, self.opt,
                                   self.to_device(batch))
            if device_metrics and set(metrics) != set(device_metrics):
                # each metric is averaged over its own buffer length,
                # which silently changes meaning if a key comes and goes
                raise ValueError(
                    f"step metrics changed keys mid-epoch: "
                    f"{sorted(device_metrics)} -> {sorted(metrics)}")
            for k, v in metrics.items():
                device_metrics.setdefault(k, []).append(v)
        keys = sorted(device_metrics)  # the JAX step's (sorted) order
        out: Dict[str, float] = {}
        if keys:
            means = torch.stack([torch.stack(device_metrics[k]).mean()
                                 for k in keys])
            out = dict(zip(keys, means.tolist()))
        self.metrics_log.append(out)
        return out

    @property
    def state(self) -> Dict:
        """The model's backbone and head state dicts, the optimizer's and
        the step count (what :class:`CheckpointManager` saves): full
        tensors, under a ``model`` axis gathered over its group (every
        rank calls)."""
        return {"backbone": gather_state_dict(
                    self.model.backbone.state_dict(), self.tp),
                "head": gather_state_dict(self.model.head.state_dict(),
                                          self.tp),
                "optimizer": gather_optimizer_state(self.opt.sgd,
                                                    self.model, self.tp),
                "step": self.opt.count}

    def load_state(self, state: Dict) -> None:
        """:attr:`state`'s full tensors back, each rank keeping its
        shard."""
        self.model.backbone.load_state_dict(
            shard_state_dict(state["backbone"], self.tp))
        self.model.head.load_state_dict(
            shard_state_dict(state["head"], self.tp))
        self.opt.sgd.load_state_dict(shard_optimizer_state(
            state["optimizer"], self.opt.sgd, self.model, self.tp))
        self.opt.count = int(state["step"])

    def extract_features(self, batches) -> np.ndarray:
        """L2-normalized backbone features over an iterable of image
        batches (the per-epoch k-means eval, reference
        ``learn_metric.py:341-383``); under a ``model`` axis the sharded
        forward, every rank of the group on the same batches."""
        out = []
        with torch.no_grad():
            for x in batches:
                f = self.model.backbone(torch.as_tensor(x).to(
                    self.device, torch.float32))
                out.append(_unit(f, -1).cpu().numpy())
        return np.concatenate(out)

    def fit(self, epochs: int, make_train_batches, eval_fn=None,
            ckpt=None, log_fn=print) -> Dict[str, float]:
        """Per epoch: ``train_epoch`` over ``make_train_batches(epoch)``,
        ``eval_fn(trainer, epoch) -> metrics``, a checkpoint (reference
        ``train()``, ``learn_metric.py:217-338``; the best checkpoint is
        the ``ckpt`` manager's ``best_metric``)."""
        last: Dict[str, float] = {}
        for epoch in range(epochs):
            metrics = dict(self.train_epoch(make_train_batches(epoch)))
            if eval_fn is not None:
                metrics.update(eval_fn(self, epoch))
            if log_fn is not None:
                msg = " | ".join(f"{k} {v:.4f}" for k, v in metrics.items())
                log_fn(f"Epoch {epoch}: {msg}")
            if ckpt is not None:
                ckpt.save(epoch, self.state, metrics=metrics)
            last = metrics
        return last
