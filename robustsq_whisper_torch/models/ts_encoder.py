"""Qformer target-speaker Whisper encoder (serving and training).

Mirrors ``QFormerTSEncoder`` of the JAX package's ``models/ts_encoder.py``:
conv stems on the speech (with positions) and the enrollment (without),
the Qformer speaker prompt, ``prompt_proj`` when the Qformer width differs
from the encoder's, the prompt concatenated ahead of the speech frames,
then the Whisper blocks and ``ln_post``. ``train=True`` turns on the
Qformer's dropout (masks from the ``generator`` passed in); ``remat``
recomputes the Whisper blocks in the backward. The embedding-enrollment
encoder (``SpkAdapterTSEncoder``) is ROADMAP A14, sequence parallelism
ROADMAP A15.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from .qformer import QFormerAdapter, QformerConfig
from .whisper.config import WhisperDims
from .whisper.modules import AudioEncoder, Linear


@dataclasses.dataclass(frozen=True)
class TSEncoderConfig:
    """The Qformer-path knobs of the JAX package's TSEncoderConfig (same
    names and defaults). ``enroll_type="embedding"`` (ROADMAP A14) and
    ``sequence_parallel=True`` (ROADMAP A15) raise; the five embedding-
    enrollment knobs after ``enroll_type`` are read by that encoder only."""

    enroll_type: str = "audio"
    enroll_size: int = 256
    adapter_method: str = "cat"  # cat | additive | film | cln
    adapter_normalize: bool = True
    adapter_layer: int = 1
    modulate_bias: bool = False
    num_query_tokens: int = 16
    num_hidden_layers: int = 2
    use_spk_prompt: bool = True
    qformer_hidden_size: int = 768
    qformer_heads: int = 12
    qformer_intermediate_size: int = 3072
    qformer_hidden_dropout: float = 0.1
    qformer_attention_dropout: float = 0.1
    use_flash_attention: bool = False
    flash_tmaj: bool = False
    remat: bool = False
    gelu_approx: bool = False
    sequence_parallel: bool = False


class QFormerTSEncoder(nn.Module):
    """``forward(feats, feats_lens, enroll_feats, enroll_feats_lens,
    train=False, generator=None) -> (encoder_out, out_lens, spk_prompt,
    enroll_embedding)``; the prompt occupies the first ``num_query_tokens``
    positions of ``encoder_out``."""

    def __init__(self, dims: WhisperDims, ts: TSEncoderConfig = TSEncoderConfig()):
        super().__init__()
        if ts.enroll_type != "audio":
            raise NotImplementedError(
                "embedding enrollment (SpkAdapterTSEncoder) is ROADMAP A14"
            )
        self.dims, self.ts = dims, ts
        self.encoder = AudioEncoder(
            dims, use_flash=ts.use_flash_attention, flash_tmaj=ts.flash_tmaj,
            gelu_approx=ts.gelu_approx, remat=ts.remat,
            sequence_parallel=ts.sequence_parallel,
        )
        qcfg = QformerConfig(
            encoder_width=dims.n_audio_state,
            hidden_size=ts.qformer_hidden_size,
            num_attention_heads=ts.qformer_heads,
            intermediate_size=ts.qformer_intermediate_size,
            num_hidden_layers=ts.num_hidden_layers,
            num_query_tokens=ts.num_query_tokens,
            hidden_dropout_prob=ts.qformer_hidden_dropout,
            attention_probs_dropout_prob=ts.qformer_attention_dropout,
        )
        self.qformer = QFormerAdapter(qcfg)
        self.prompt_proj = (
            Linear(qcfg.hidden_size, dims.n_audio_state)
            if qcfg.hidden_size != dims.n_audio_state else None
        )

    def forward(
        self,
        feats: torch.Tensor,  # (batch, n_mels, frames) speech log-mel
        feats_lens: Optional[torch.Tensor],  # (batch,) valid mel frames
        enroll_feats: torch.Tensor,  # (batch, n_mels, enr_frames)
        enroll_feats_lens: Optional[torch.Tensor],
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        max_ctx = self.dims.n_audio_ctx
        x = self.encoder.conv_stem(feats, add_positions=True)
        enroll = self.encoder.conv_stem(enroll_feats, add_positions=False)
        x_lens = (
            None if feats_lens is None
            else AudioEncoder.output_lengths(feats_lens, max_ctx)
        )
        enroll_lens = (
            None if enroll_feats_lens is None
            else AudioEncoder.output_lengths(enroll_feats_lens, max_ctx)
        )
        spk_prompt, enroll_embedding = self.qformer(
            x, x_lens, enroll, enroll_lens, train, generator
        )
        if self.prompt_proj is not None:
            spk_prompt = self.prompt_proj(spk_prompt)
            enroll_embedding = self.prompt_proj(enroll_embedding)
        if self.ts.use_spk_prompt:
            x = torch.cat([spk_prompt.to(x.dtype), x], dim=1)
            if x_lens is not None:
                x_lens = x_lens + self.ts.num_query_tokens
        x = self.encoder.run_blocks(x)
        return x, x_lens, spk_prompt, enroll_embedding

    @property
    def prompt_len(self) -> int:
        return self.ts.num_query_tokens if self.ts.use_spk_prompt else 0
