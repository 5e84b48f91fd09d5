"""SpecAugment on log-mel features, for training.

Same function as the JAX package's ``audio/specaug.py``: ``num_freq_masks``
frequency bands of width U[0, F] and ``num_time_masks`` time spans whose
width is drawn in [0, T] and capped per utterance at
``max(1, int(length * time_mask_width_ratio))`` (ESPnet's adaptive cap),
starts uniform in [0, axis_len - 2]; masked cells take ``mask_value``.
Drawing the masks (``draw_masks``) is kept apart from applying them
(``apply_masks``), so given masks can be applied. The draws use the
``generator`` passed in and stay on the features' device (no host sync);
torch's streams differ from ``jax.random``, so only the distribution is
shared with the JAX package. Under data parallelism the masks are drawn for
the whole batch (its lengths gathered) and each rank keeps its rows, so
that the draw is one device's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SpecAugConfig:
    num_freq_masks: int = 2
    freq_mask_width: int = 27  # F
    num_time_masks: int = 2
    time_mask_width: int = 100  # T (frames)
    time_mask_width_ratio: float = 0.05
    mask_value: float = 0.0


def _mask_axis(
    batch: int,
    axis_len: int,
    num_masks: int,
    max_width: torch.Tensor,  # (batch,) int
    generator: Optional[torch.Generator],
) -> torch.Tensor:
    """Keep-mask (batch, axis_len), False where masked."""
    dev = max_width.device
    shape = (batch, num_masks, 1)
    # width uniform in [0, max over the batch], then capped per row
    u = torch.rand(shape, generator=generator, device=dev)
    width = (u * (max_width.max() + 1).float()).long()
    width = torch.minimum(width, max_width.view(-1, 1, 1))
    start = torch.randint(
        0, max(axis_len - 1, 1), shape, generator=generator, device=dev
    )
    idx = torch.arange(axis_len, device=dev)[None, None, :]
    masked = (idx >= start) & (idx < start + width)
    return ~masked.any(dim=1)


def draw_masks(
    feats: torch.Tensor,  # (batch, n_mels, frames)
    feat_lens: Optional[torch.Tensor],  # (batch,) valid frames
    cfg: SpecAugConfig = SpecAugConfig(),
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keep_f (batch, n_mels), keep_t (batch, frames)) boolean masks."""
    from ..parallel.mesh import data_group, gather_batch

    b, n_mels, frames = feats.shape
    dev = feats.device
    group = data_group()
    if group is not None:
        n = torch.distributed.get_world_size(group)
        r = torch.distributed.get_rank(group)
        lens = None if feat_lens is None else gather_batch(feat_lens.to(dev))
        masks = _draw(b * n, n_mels, frames, lens, cfg, generator, dev)
        return tuple(m[r * b:(r + 1) * b] for m in masks)
    return _draw(b, n_mels, frames, feat_lens, cfg, generator, dev)


def _draw(b, n_mels, frames, feat_lens, cfg, generator, dev):
    """``draw_masks`` for ``b`` rows of ``(n_mels, frames)`` features."""
    keep_f = _mask_axis(
        b, n_mels, cfg.num_freq_masks,
        torch.full((b,), cfg.freq_mask_width, device=dev), generator,
    )
    if feat_lens is not None:
        cap = (feat_lens.to(dev) * cfg.time_mask_width_ratio).long()
        adaptive = torch.clamp(cap, min=1, max=cfg.time_mask_width)
    else:
        adaptive = torch.full((b,), cfg.time_mask_width, device=dev)
    keep_t = _mask_axis(b, frames, cfg.num_time_masks, adaptive, generator)
    return keep_f, keep_t


def apply_masks(
    feats: torch.Tensor, keep_f: torch.Tensor, keep_t: torch.Tensor,
    mask_value: float = 0.0,
) -> torch.Tensor:
    keep = keep_f[:, :, None] & keep_t[:, None, :]
    return torch.where(keep, feats, torch.full_like(feats, mask_value))


def apply_specaug(
    feats: torch.Tensor,
    feat_lens: Optional[torch.Tensor] = None,
    cfg: SpecAugConfig = SpecAugConfig(),
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Frequency and time masking; masked feats of the same shape."""
    return apply_masks(feats, *draw_masks(feats, feat_lens, cfg, generator), cfg.mask_value)
