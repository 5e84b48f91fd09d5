"""Speaker losses: ASP pooling, Arc-InfoNCE, AAM-softmax, their schedules.

Same functions as the JAX package's ``losses/speaker.py``:

- ``AttentiveStatisticsPooling``: the L2-normalised mean as the query,
  scores scaled by ``gamma``, a length-masked softmax, weighted mean and
  std ``sqrt(max(m2 - mu^2, 0) + 1e-8)``, [mu; sigma] -> Linear(2d, d) ->
  L2 norm;
- ``arc_infonce_loss``: the mean-pooled speaker prompt against the pooled
  enrollment (positive) and ``num_negatives`` in-batch negatives drawn
  with replacement from ``softmax(neg_logits)`` (``torch.multinomial`` on
  the ``generator`` passed in), an angular ``margin`` added to the
  positive, cosines over ``temperature``;
- ``AAMSoftmaxHead``: a bias-free classifier over L2-normalised weights
  with an additive angular margin on the target class;
- ``asp_gamma_schedule`` and ``aam_margin_schedule``: the epoch warm-ups,
  as host floats (the port has no trace to carry them as tensors).

Everything runs in f32 whatever the compute dtype of the encoder.

Under data parallelism (``parallel.mesh.use_mesh``) each rank holds its
rows of the batch, yet Arc-InfoNCE draws its negatives from the whole
batch: every rank draws the whole batch's index matrix from the same
generator, keeps its rows' columns, and reads the negatives from the
pooled enrollments of every rank (all-gathered, the gradient
reduce-scattered back). A tensor-parallel AAM classifier (``tp``) holds
its rows of speakers and gathers the cosines.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..parallel import collectives
from ..parallel.mesh import data_group, gather_batch

_ACOS_EPS = 1e-7  # the clamp before arccos


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) (``F.normalize``)."""
    norm = torch.sqrt((x * x).sum(dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


class AttentiveStatisticsPooling(nn.Module):
    def __init__(self, input_dim: int, use_projection: bool = True):
        super().__init__()
        self.projection = nn.Linear(2 * input_dim, input_dim) if use_projection else None

    def forward(
        self,
        x: torch.Tensor,  # (batch, seq, dim)
        gamma: float = 6.0,
        lengths: Optional[torch.Tensor] = None,  # (batch,)
    ) -> torch.Tensor:
        x = x.float()
        mask = None
        if lengths is not None:
            mask = torch.arange(x.shape[1], device=x.device)[None, :] < lengths[:, None]
            p = (x * mask[..., None]).sum(1) / lengths[:, None].float()
        else:
            p = x.mean(1)
        scores = torch.einsum("bd,bsd->bs", l2_normalize(p), x) * gamma
        if mask is not None:
            scores = scores.masked_fill(~mask, float("-inf"))
        alpha = torch.softmax(scores, dim=-1)
        mu = torch.einsum("bs,bsd->bd", alpha, x)
        m2 = torch.einsum("bs,bsd->bd", alpha, x * x)
        sigma = torch.sqrt(torch.clamp(m2 - mu * mu, min=0.0) + 1e-8)
        pooled = torch.cat([mu, sigma], dim=-1)
        if self.projection is not None:
            w = self.projection.weight
            pooled = l2_normalize(self.projection(pooled.to(w.dtype)).float())
        return pooled


def sample_negatives(
    neg_logits: torch.Tensor,  # (batch, batch): 1 valid / -10000 same speaker
    num_negatives: int,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """(num_negatives, batch) indices, with replacement, per row from
    softmax(neg_logits)."""
    probs = torch.softmax(neg_logits.float(), dim=-1)
    return torch.multinomial(probs, num_negatives, replacement=True, generator=generator).t()


def arc_infonce_loss(
    spk_prompt: torch.Tensor,  # (batch, n_q, dim)
    pooled_enroll: torch.Tensor,  # (batch, dim), ASP-pooled, unit norm
    neg_logits: torch.Tensor,  # (batch, batch)
    generator: Optional[torch.Generator] = None,
    num_negatives: int = 10,
    temperature: float = 0.1,
    margin: float = 0.15,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, accuracy)."""
    pooled_prompt = l2_normalize(spk_prompt.float().mean(1))
    group = data_group()
    if group is None:
        neg_idx = sample_negatives(neg_logits, num_negatives, generator)  # (K, b)
        negatives = pooled_enroll[neg_idx]
    else:  # the whole batch's draw and rows; this rank's columns
        b = pooled_enroll.shape[0]
        r = torch.distributed.get_rank(group)
        neg_idx = sample_negatives(gather_batch(neg_logits), num_negatives, generator)
        everyone = collectives.gather_sum(pooled_enroll, 0, group)
        negatives = everyone[neg_idx[:, r * b:(r + 1) * b]]
    targets = torch.cat([pooled_enroll[None], negatives], dim=0)
    cos = torch.einsum("bd,kbd->kb", pooled_prompt, l2_normalize(targets))
    theta = torch.arccos(torch.clamp(cos, -1.0 + _ACOS_EPS, 1.0 - _ACOS_EPS))
    theta = torch.cat([theta[:1] + margin, theta[1:]], dim=0)  # positive only
    logits = (torch.cos(theta) / temperature).t()  # (batch, 1 + K)
    loss = -torch.log_softmax(logits, dim=-1)[:, 0].mean()
    acc = (logits.argmax(-1) == 0).float().mean()
    return loss, acc


class AAMSoftmaxHead(nn.Module):
    """``forward(pooled, labels, margin) -> (loss, accuracy)``; the
    classifier is (num_speakers, input_dim)."""

    def __init__(self, num_speakers: int, input_dim: int, temperature: float = 0.0333):
        super().__init__()
        self.num_speakers = num_speakers
        self.temperature = temperature
        self.classifier = nn.Parameter(torch.zeros(num_speakers, input_dim))
        self.tp = None  # the Split of a tensor-parallel classifier

    def forward(
        self, pooled: torch.Tensor, labels: torch.Tensor, margin: float = 0.25
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        feats = l2_normalize(pooled.float())
        weights = l2_normalize(self.classifier.float())
        if self.tp is None:
            cos = feats @ weights.t()
        else:  # this rank's speakers, then all of them
            cos = collectives.copy_to(feats, self.tp.group) @ weights.t()
            cos = collectives.gather_from(cos, -1, self.tp.group)
        cos = torch.clamp(cos, -1.0 + _ACOS_EPS, 1.0 - _ACOS_EPS)
        one_hot = torch.nn.functional.one_hot(labels.long(), self.num_speakers).float()
        logits = torch.cos(torch.arccos(cos) + one_hot * margin) / self.temperature
        loss = -(one_hot * torch.log_softmax(logits, dim=-1)).sum(-1).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, acc


def asp_gamma_schedule(
    epoch: float, gamma_initial: float = 1.0, gamma_final: float = 6.0,
    warmup_epochs: int = 6,
) -> float:
    """Linear gamma warm-up over ``warmup_epochs``."""
    return gamma_initial + min(epoch / warmup_epochs, 1.0) * (gamma_final - gamma_initial)


def aam_margin_schedule(
    epoch: float, margin: float = 0.25, warm_up_epochs: int = 5
) -> float:
    """0 before ``warm_up_epochs``, the full margin after."""
    return 0.0 if epoch < warm_up_epochs else margin
