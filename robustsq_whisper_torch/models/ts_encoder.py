"""Target-speaker Whisper encoders (serving and training).

Mirrors the JAX package's ``models/ts_encoder.py``:

- ``QFormerTSEncoder`` (audio enrollment): conv stems on the speech (with
  positions) and the enrollment (without), the Qformer speaker prompt,
  ``prompt_proj`` when the Qformer width differs from the encoder's, the
  prompt concatenated ahead of the speech frames, then the Whisper blocks
  and ``ln_post``. ``train=True`` turns on the Qformer's dropout (masks
  from the ``generator`` passed in); ``remat`` recomputes the Whisper
  blocks in the backward; ``qw`` (``quantize_encoder_weights``) runs the
  Whisper blocks W8A8 for inference (conv stems, Qformer and prompt
  projection stay dense).
- ``SpkAdapterTSEncoder`` (embedding enrollment, the recipe's stage-103
  ``resnet.scp``): a fixed speaker embedding enters at block 0, through
  ``SpkAdapter`` (``cat``, ``additive`` or ``film``, with the optional
  ``adapter_norm``) ahead of the block, or through two
  ``ConditionalLayerNorm`` s that take the place of block 0's layer norms
  (``cln``). As in the JAX package its attention is the plain one in every
  config (the flash route, ``gelu_approx`` and the prompt do not apply);
  ``remat`` recomputes blocks 1 and up in the backward, which changes no
  value.

``sequence_parallel`` runs the Qformer encoder's Whisper blocks with the
residual stream split along the sequence over the model group when the
model is tensor-parallel and the length (prompt and frames: 16 + 1500 at
full width) divides (``whisper.modules.AudioEncoder.run_blocks``); the
embedding encoder calls its blocks itself and runs them whole.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .qformer import QFormerAdapter, QformerConfig
from .whisper.config import WhisperDims
from .whisper.modules import AudioEncoder, LayerNorm, Linear, _run_block
from .whisper.modules import quantize_encoder_weights as _quantize_encoder_weights


@dataclasses.dataclass(frozen=True)
class TSEncoderConfig:
    """The JAX package's TSEncoderConfig (same names and defaults).
    ``enroll_type`` picks the encoder (``audio``: ``QFormerTSEncoder``,
    ``embedding``: ``SpkAdapterTSEncoder``); the five knobs after it are
    the embedding encoder's, the Qformer ones the audio encoder's.
    ``sequence_parallel``: the blocks' residual stream split along the
    sequence under tensor parallelism (``AudioEncoder.run_blocks``)."""

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
            raise ValueError(
                f"QFormerTSEncoder is the audio-enrollment encoder, got enroll_type "
                f"{ts.enroll_type!r} (SpkAdapterTSEncoder is the embedding one)"
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
        qw: Optional[dict] = None,  # W8A8 block weights (inference)
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
        x = self.encoder.run_blocks(x, qw=qw)
        return x, x_lens, spk_prompt, enroll_embedding

    @property
    def prompt_len(self) -> int:
        return self.ts.num_query_tokens if self.ts.use_spk_prompt else 0


class FiLM(nn.Module):
    """Feature-wise linear modulation by the speaker embedding: a trunk of
    ``n_layers - 1`` Linear + GELU layers, then per-channel ``gamma`` and
    ``beta`` heads; ``x * (1 + gamma) + beta``."""

    def __init__(self, enroll_size: int, hidden_size: int, n_layers: int = 1):
        super().__init__()
        self.n_trunk = n_layers - 1
        for i in range(self.n_trunk):
            setattr(self, f"trunk_{i}", Linear(enroll_size if i == 0 else hidden_size,
                                               hidden_size))
        width = hidden_size if self.n_trunk else enroll_size
        self.gamma = Linear(width, hidden_size)
        self.beta = Linear(width, hidden_size)

    def forward(self, x: torch.Tensor, enroll: torch.Tensor) -> torch.Tensor:
        h = enroll
        for i in range(self.n_trunk):
            h = F.gelu(getattr(self, f"trunk_{i}")(h))
        return x * (1.0 + self.gamma(h)) + self.beta(h)


class ConditionalLayerNorm(nn.Module):
    """LayerNorm whose scale and shift are modulated by the speaker
    embedding: ``normed * (weight + delta_scale(e)) + bias [+
    delta_bias(e)]``, all in f32 whatever the parameters' dtype. ``weight``
    and ``bias`` start as a layer norm's (or the pretrained block-0 ones,
    ``cli.train --pretrained``), the delta heads at 0."""

    def __init__(self, hidden_size: int, enroll_size: int, modulate_bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden_size))
        self.bias = nn.Parameter(torch.zeros(hidden_size))
        self.delta_scale = nn.Linear(enroll_size, hidden_size)
        self.delta_bias = nn.Linear(enroll_size, hidden_size) if modulate_bias else None

    @staticmethod
    def _head(lin: nn.Linear, e: torch.Tensor) -> torch.Tensor:
        return F.linear(e, lin.weight.float(), lin.bias.float())[:, None, :]

    def forward(self, x: torch.Tensor, enroll: torch.Tensor) -> torch.Tensor:
        e = enroll.float()
        normed = F.layer_norm(x.float(), x.shape[-1:], eps=1e-5)
        shift = self.bias.float()
        if self.delta_bias is not None:
            shift = shift + self._head(self.delta_bias, e)
        return (normed * (self.weight.float() + self._head(self.delta_scale, e))
                + shift).to(x.dtype)


class SpkAdapter(nn.Module):
    """Speaker-embedding fusion ahead of block 0: ``cat`` adds a Linear of
    [x; e], ``additive`` adds an MLP of e (GELU between), ``film`` applies
    ``FiLM``; then, with ``adapter_normalize``, a LayerNorm (``adapter_norm``,
    in f32)."""

    def __init__(
        self, enroll_size: int, hidden_size: int, adapter_method: str = "cat",
        adapter_normalize: bool = True, adapter_layer: int = 1,
    ):
        super().__init__()
        self.method = adapter_method
        if adapter_method == "cat":
            self.proj = Linear(hidden_size + enroll_size, hidden_size)
        elif adapter_method == "additive":
            self.fc1 = Linear(enroll_size, 2 * enroll_size)
            self.fc2 = Linear(2 * enroll_size, hidden_size)
        elif adapter_method == "film":
            self.film = FiLM(enroll_size, hidden_size, adapter_layer)
        else:
            raise ValueError(f"Not supported adapter: {adapter_method}")
        self.adapter_norm = LayerNorm(hidden_size) if adapter_normalize else None

    def forward(self, x: torch.Tensor, enroll: torch.Tensor) -> torch.Tensor:
        e = enroll[:, None, :].to(x.dtype)  # (b, 1, E), broadcast over time
        if self.method == "cat":
            x = x + self.proj(torch.cat([x, e.expand(-1, x.shape[1], -1)], dim=-1))
        elif self.method == "additive":
            x = x + self.fc2(F.gelu(self.fc1(e)))
        else:
            x = self.film(x, e)
        if self.adapter_norm is not None:
            x = self.adapter_norm(x).to(x.dtype)
        return x


class SpkAdapterTSEncoder(nn.Module):
    """``forward(feats, feats_lens, enroll_emb) -> (encoder_out, out_lens)``:
    the embedding-enrollment encoder (see the module docstring). Its
    ``encoder`` is a plain ``AudioEncoder`` whose blocks load as the Qformer
    encoder's do; ``prompt_len`` is 0."""

    prompt_len = 0

    def __init__(self, dims: WhisperDims, ts: TSEncoderConfig = TSEncoderConfig()):
        super().__init__()
        if ts.enroll_type != "embedding":
            raise ValueError(
                f"SpkAdapterTSEncoder is the embedding-enrollment encoder, got "
                f"enroll_type {ts.enroll_type!r}"
            )
        self.dims, self.ts = dims, ts
        self.encoder = AudioEncoder(dims, sequence_parallel=ts.sequence_parallel)
        d = dims.n_audio_state
        self.adapter = self.attn_cln = self.mlp_cln = None
        if ts.adapter_method == "cln":
            self.attn_cln = ConditionalLayerNorm(d, ts.enroll_size, ts.modulate_bias)
            self.mlp_cln = ConditionalLayerNorm(d, ts.enroll_size, ts.modulate_bias)
            # they replace block 0's layer norms, which the JAX model never
            # creates either
            self.encoder.blocks[0].attn_ln = self.encoder.blocks[0].mlp_ln = None
        else:
            self.adapter = SpkAdapter(ts.enroll_size, d, ts.adapter_method,
                                      ts.adapter_normalize, ts.adapter_layer)

    def forward(
        self,
        feats: torch.Tensor,  # (batch, n_mels, frames)
        feats_lens: Optional[torch.Tensor],
        enroll_emb: torch.Tensor,  # (batch, enroll_size)
    ):
        enc = self.encoder
        x = enc.conv_stem(feats, add_positions=True)
        block0 = enc.blocks[0]
        if self.attn_cln is not None:
            # block 0 with its two layer norms replaced by the conditional ones
            x = x + block0.attn(self.attn_cln(x, enroll_emb).to(enc.dtype))
            x = x + block0._mlp(self.mlp_cln(x, enroll_emb).to(enc.dtype))
        else:
            x = _run_block(block0, self.ts.remat, self.adapter(x, enroll_emb))
        for block in enc.blocks[1:]:
            x = _run_block(block, self.ts.remat, x)
        x = enc.ln_post(x).to(enc.dtype)
        olens = (None if feats_lens is None
                 else AudioEncoder.output_lengths(feats_lens, self.dims.n_audio_ctx))
        return x, olens


def quantize_encoder_weights(enc: QFormerTSEncoder) -> dict:
    """Int8 W8A8 weights of a ``QFormerTSEncoder``'s Whisper blocks
    (``whisper.modules.quantize_encoder_weights``), for ``forward(...,
    qw=)``. Inference only."""
    return _quantize_encoder_weights(enc.encoder)
