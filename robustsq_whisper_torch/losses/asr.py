"""ASR losses: sos/eos framing, label-smoothed attention CE, accuracy, CTC.

Same functions as the JAX package's ``losses/asr.py`` (ESPnet semantics):

- ``add_sos_eos``: static-shape framing of ``ignore_id``-padded labels;
- ``label_smoothing_loss``: KL(smoothed target || log_softmax) summed over
  the vocabulary and the non-pad positions, divided by the batch size (or
  the token count with ``normalize_length``);
- ``token_accuracy``: argmax accuracy over the non-pad positions;
- ``CTCHead``: a Linear to the vocabulary (f32) and the CTC loss with
  blank 0, mean over the batch. ``F.ctc_loss`` computes it (no kernel: the
  JAX package's ``optax.ctc_loss`` is plain XLA). An alignment that cannot
  exist (more labels than frames) gives ``inf`` here, where optax returns a
  large finite number.

Under data parallelism the token counts that divide are the whole batch's
(``parallel.mesh.global_count``): the mean of the ranks' values is then the
whole batch's. The batch means need nothing: every rank holds as many rows.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import global_count

IGNORE_ID = -1


def add_sos_eos(
    ys_pad: torch.Tensor,  # (batch, L) padded with ignore_id
    ys_lens: torch.Tensor,  # (batch,)
    sos: int,
    eos: int,
    ignore_id: int = IGNORE_ID,
    pad_in: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ys_in (batch, L+1) = [sos, y_1..y_n, pad_in...], ys_out (batch, L+1)
    = [y_1..y_n, eos, ignore_id...], ys_lens + 1)."""
    b, _ = ys_pad.shape
    lens = ys_lens[:, None]
    idx = torch.arange(ys_pad.shape[1] + 1, device=ys_pad.device)[None, :]
    tokens = torch.where(ys_pad == ignore_id, pad_in, ys_pad)
    col = lambda v: torch.full((b, 1), v, dtype=ys_pad.dtype, device=ys_pad.device)
    ys_in = torch.where(idx <= lens, torch.cat([col(sos), tokens], dim=1), pad_in)
    ys_out = torch.cat([tokens, col(ignore_id)], dim=1)
    ys_out = torch.where(idx == lens, eos, ys_out)
    ys_out = torch.where(idx > lens, ignore_id, ys_out)
    return ys_in, ys_out, ys_lens + 1


def _xlogx(v: float) -> float:
    return 0.0 if v == 0.0 else v * math.log(v)


def label_smoothing_loss(
    logits: torch.Tensor,  # (batch, L, vocab)
    targets: torch.Tensor,  # (batch, L) with ignore_id padding
    smoothing: float = 0.0,
    ignore_id: int = IGNORE_ID,
    normalize_length: bool = False,
) -> torch.Tensor:
    vocab = logits.shape[-1]
    mask = targets != ignore_id
    logp = torch.log_softmax(logits.float(), dim=-1)
    on, off = 1.0 - smoothing, smoothing / (vocab - 1)
    # the target distribution's own entropy term, kept for parity with
    # torch.nn.KLDivLoss
    entropy = _xlogx(on) + (vocab - 1) * _xlogx(off)
    on_logp = logp.gather(-1, torch.where(mask, targets, 0)[..., None])[..., 0]
    cross = on * on_logp + off * (logp.sum(-1) - on_logp)
    kl = torch.where(mask, entropy - cross, 0.0)
    denom = global_count(mask.sum().float()) if normalize_length else float(logits.shape[0])
    return kl.sum() / denom


def token_accuracy(
    logits: torch.Tensor, targets: torch.Tensor, ignore_id: int = IGNORE_ID
) -> torch.Tensor:
    mask = targets != ignore_id
    correct = mask & (logits.argmax(-1) == targets)
    return correct.sum() / global_count(mask.sum()).clamp(min=1)


class CTCHead(nn.Module):
    """Linear projection + CTC loss (ESPnet ``CTC``; blank 0)."""

    def __init__(self, vocab_size: int, dim: int, blank_id: int = 0):
        super().__init__()
        self.blank_id = blank_id
        self.ctc_lo = nn.Linear(dim, vocab_size)

    def project(self, encoder_out: torch.Tensor) -> torch.Tensor:
        return self.ctc_lo(encoder_out.to(self.ctc_lo.weight.dtype))

    def forward(
        self,
        encoder_out: torch.Tensor,  # (batch, T, dim), prompt stripped
        encoder_out_lens: torch.Tensor,  # (batch,)
        labels: torch.Tensor,  # (batch, L) padded with ignore_id
        label_lens: torch.Tensor,  # (batch,)
        ignore_id: int = IGNORE_ID,
    ) -> torch.Tensor:
        logp = torch.log_softmax(self.project(encoder_out).float(), dim=-1)
        per_seq = F.ctc_loss(
            logp.transpose(0, 1), torch.where(labels == ignore_id, 0, labels),
            encoder_out_lens, label_lens, blank=self.blank_id, reduction="none",
        )
        return per_seq.mean()
