"""Contrastive and classification losses.

Port of ``scd_tpu/train/losses.py`` (reference ``info_nce_logits``,
``learn_metric.py:183-214``; ``SupConLoss``, ``learn_metric.py:80-170``;
NT-Xent, ``local_utils/nt_xent.py``; ``LabelSmoothingLoss``,
``train_supervised.py:38-66``).  Plain functions of already
L2-normalized features on torch tensors, differentiable by autograd; the
similarity matrices are plain matrix products (TF32 off, see
``core/device.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def info_nce_loss(features: torch.Tensor, n_views: int = 2,
                  temperature: float = 1.0
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SimCLR InfoNCE over ``n_views`` stacked views.

    ``features``: [n_views*B, D] L2-normalized, view-major.  Returns
    (logits [N, N+1], labels [N]) whose cross-entropy is the loss: column
    0 is the mean similarity to the other views of the same instance, the
    rest the similarities with self and positives at -inf."""
    n = features.shape[0]
    b = n // n_views
    sim = features @ features.T  # [N, N]

    ids = torch.arange(n, device=features.device) % b
    eye = torch.eye(n, dtype=torch.bool, device=features.device)
    pos_mask = (ids[:, None] == ids[None, :]) & ~eye
    pos = torch.where(pos_mask, sim, torch.zeros_like(sim)).sum(
        1, keepdim=True) / (n_views - 1)
    neg_mask = ~(pos_mask | eye)
    neg = torch.where(neg_mask, sim, torch.full_like(sim, float("-inf")))

    logits = torch.cat([pos, neg], dim=1) / temperature
    labels = torch.zeros(n, dtype=torch.int64, device=features.device)
    return logits, labels


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels[:, None].long()).mean()


def supcon_loss(features: torch.Tensor, labels: torch.Tensor,
                temperature: float = 0.07,
                base_temperature: float = 0.07) -> torch.Tensor:
    """Supervised contrastive loss (Khosla et al.), 'all' contrast mode.
    ``features``: [B, n_views, D] L2-normalized; ``labels``: [B]."""
    b, v, _ = features.shape
    flat = torch.cat(torch.unbind(features, dim=1), dim=0)  # view-major
    lab = labels.repeat(v)

    sim = flat @ flat.T / temperature
    sim = sim - sim.max(dim=1, keepdim=True).values.detach()

    eye = torch.eye(b * v, dtype=torch.bool, device=features.device)
    pos_mask = (lab[:, None] == lab[None, :]) & ~eye
    logits_mask = ~eye

    exp_sim = torch.exp(sim) * logits_mask
    log_prob = sim - torch.log(exp_sim.sum(1, keepdim=True) + 1e-12)

    pos_count = torch.clamp_min(pos_mask.sum(1), 1)
    mean_log_prob_pos = torch.where(
        pos_mask, log_prob, torch.zeros_like(log_prob)).sum(1) / pos_count

    loss = -(temperature / base_temperature) * mean_log_prob_pos
    return loss.mean()


def nt_xent_loss(z_i: torch.Tensor, z_j: torch.Tensor,
                 temperature: float = 0.5) -> torch.Tensor:
    """NT-Xent (SimCLR) between two view batches."""
    z = torch.cat([z_i, z_j], dim=0)
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    logits, labels = info_nce_loss(z, n_views=2, temperature=temperature)
    return cross_entropy(logits, labels)


def label_smoothing_ce(logits: torch.Tensor, labels: torch.Tensor,
                       smoothing: float = 0.1) -> torch.Tensor:
    """Label-smoothed cross-entropy."""
    n_classes = logits.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)
    one_hot = F.one_hot(labels.long(), n_classes).to(logp.dtype)
    smooth = one_hot * (1 - smoothing) + smoothing / n_classes
    return -(smooth * logp).sum(-1).mean()
