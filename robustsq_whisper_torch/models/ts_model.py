"""The target-speaker ASR training model: hybrid CTC/attention loss plus the
speaker losses.

Mirrors ``TSASRModel`` of the JAX package's ``models/ts_model.py``.
``forward(batch, generator, epoch, train)`` runs, for audio enrollment
(``ts.enroll_type == "audio"``):

1. log-mel of the speech and the enrollment, SpecAugment on the speech
   (training, ``use_specaug``);
2. ``QFormerTSEncoder`` (Qformer dropout in training);
3. ASP pooling of the enrollment embeddings, Arc-InfoNCE against the
   speaker prompt and AAM-softmax on the pooled embedding;
4. CTC on the encoder output with the prompt stripped;
5. the teacher-forced ``TSDecoder`` over [startofprev; prompt; sos +
   targets], label-smoothed CE and token accuracy;
6. ``ctc_weight * ctc + (1 - ctc_weight) * att`` plus the speaker losses.

For embedding enrollment (``"embedding"``) the encoder is
``SpkAdapterTSEncoder`` on the batch's ``enroll_embed`` (B, enroll_size),
the decoder runs prompt-free (no <|startofprev|>, no prompt), and there is
no ASP, AAM or Arc-InfoNCE: the loss is the hybrid CTC/attention one alone.

It returns ``(loss, stats)`` with the JAX package's stats keys (loss,
loss_att, loss_ctc, loss_con, loss_aam, acc, acc_con, acc_aam), detached.
SpecAugment, dropout and the negative sampling draw from the ``generator``
passed in (on the batch's device).

Batch: ``speech`` (B, samples) f32, ``speech_lens`` (B,), ``enroll`` (B,
samples), ``enroll_lens``, ``text`` (B, L) padded with ``ignore_id``,
``text_lens``, ``neg_logits`` (B, B) (1 valid, -10000 same speaker),
``spk_labels`` (B,); with embedding enrollment ``enroll_embed`` (B,
enroll_size) in place of ``enroll`` and ``enroll_lens``.

``set_compute_dtype(torch.bfloat16)`` is the training operating point: the
encoder and decoder compute in bf16 while their layer norms (conditional
ones too) and the loss heads (CTC, ASP, AAM) keep f32 parameters, as the JAX
model keeps f32 parameters and computes its blocks in bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..audio.frontend import log_mel_spectrogram
from ..audio.specaug import SpecAugConfig, apply_specaug
from ..losses.asr import CTCHead, add_sos_eos, label_smoothing_loss, token_accuracy
from ..losses.speaker import (
    AAMSoftmaxHead,
    AttentiveStatisticsPooling,
    aam_margin_schedule,
    arc_infonce_loss,
    asp_gamma_schedule,
)
from .ts_decoder import TSDecoder
from .ts_encoder import (
    ConditionalLayerNorm,
    QFormerTSEncoder,
    SpkAdapterTSEncoder,
    TSEncoderConfig,
)
from .whisper.config import WhisperDims
from .whisper.modules import LayerNorm


@dataclasses.dataclass(frozen=True)
class TSModelConfig:
    """The JAX package's TSModelConfig (same names and defaults)."""

    vocab_size: int = 51865
    sos: int = 50258  # <|startoftranscript|>
    eos: int = 50257  # <|endoftext|>
    startofprev: int = 50361  # <|startofprev|>
    ignore_id: int = -1
    ctc_weight: float = 0.3
    lsm_weight: float = 0.0
    length_normalized_loss: bool = False
    contrastive_weight: float = 2.0
    contrastive_temp: float = 0.1
    contrastive_margin: float = 0.15
    num_negatives: int = 10
    num_speakers: int = 1000
    aam_softmax_weight: float = 0.4
    aam_margin: float = 0.25
    aam_temp: float = 0.0333
    warm_up_epochs: int = 5
    asp_gamma: float = 6.0
    asp_gamma_warmup_epochs: int = 6
    asp_gamma_initial: float = 1.0
    use_specaug: bool = True
    specaug: SpecAugConfig = SpecAugConfig()


class TSASRModel(nn.Module):
    """Target-speaker Whisper ASR model with its training losses."""

    def __init__(
        self,
        dims: WhisperDims,
        ts: TSEncoderConfig = TSEncoderConfig(),
        cfg: TSModelConfig = TSModelConfig(),
    ):
        super().__init__()
        if ts.enroll_type not in ("audio", "embedding"):
            raise ValueError(f"enroll_type must be audio|embedding, got {ts.enroll_type}")
        self.dims, self.ts, self.cfg = dims, ts, cfg
        self.embedding_enroll = ts.enroll_type == "embedding"
        encoder_cls = SpkAdapterTSEncoder if self.embedding_enroll else QFormerTSEncoder
        self.encoder = encoder_cls(dims, ts)
        self.decoder = TSDecoder(
            dims.replace(n_vocab=cfg.vocab_size), startofprev_token=cfg.startofprev,
            use_spk_prompt=not self.embedding_enroll, remat=ts.remat,
            sequence_parallel=ts.sequence_parallel,
        )
        self.ctc = CTCHead(cfg.vocab_size, dims.n_audio_state)
        self.asp = self.aam = None
        if not self.embedding_enroll:
            self.asp = AttentiveStatisticsPooling(dims.n_audio_state)
            self.aam = AAMSoftmaxHead(cfg.num_speakers, dims.n_audio_state, cfg.aam_temp)

    def set_compute_dtype(self, dtype: torch.dtype) -> "TSASRModel":
        """Encoder and decoder parameters and buffers to ``dtype``, except
        the layer norms, whose values are not rounded; the loss heads stay
        f32."""
        for m in (self.encoder, self.decoder):
            keep_f32 = {id(s) for c in m.modules()
                        if isinstance(c, (LayerNorm, ConditionalLayerNorm)) for s in c.modules()}
            for sub in m.modules():
                if id(sub) in keep_f32:
                    sub.float()
                    continue
                for p in sub.parameters(recurse=False):
                    p.data = p.data.to(dtype)
                for name, b in sub.named_buffers(recurse=False):
                    if b.is_floating_point():
                        setattr(sub, name, b.to(dtype))
        for m in (self.ctc, self.asp, self.aam):
            if m is not None:
                m.float()
        return self

    def encode(
        self,
        speech: torch.Tensor,
        speech_lens: Optional[torch.Tensor],
        enroll: torch.Tensor,
        enroll_lens: Optional[torch.Tensor],
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """Waveforms -> (encoder_out, out_lens, spk_prompt, enroll_embedding).
        With embedding enrollment ``enroll`` is the speaker embedding (B,
        enroll_size), ``enroll_lens`` is unused and the last two are None."""
        n_mels = self.dims.n_mels
        feats, feats_lens = log_mel_spectrogram(speech, speech_lens, n_mels=n_mels)
        if train and self.cfg.use_specaug:
            feats = apply_specaug(feats, feats_lens, self.cfg.specaug, generator)
        if self.embedding_enroll:
            x, x_lens = self.encoder(feats, feats_lens, enroll)
            return x, x_lens, None, None
        enroll_feats, enroll_feats_lens = log_mel_spectrogram(
            enroll, enroll_lens, n_mels=n_mels
        )
        return self.encoder(
            feats, feats_lens, enroll_feats, enroll_feats_lens,
            train=train, generator=generator,
        )

    def forward(
        self,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        epoch: float = 0,
        train: bool = True,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        emb = self.embedding_enroll
        encoder_out, out_lens, spk_prompt, enroll_embedding = self.encode(
            batch["speech"], batch.get("speech_lens"),
            batch["enroll_embed"] if emb else batch["enroll"],
            None if emb else batch.get("enroll_lens"), train=train, generator=generator,
        )
        stats: Dict[str, torch.Tensor] = {}
        loss = torch.zeros((), device=encoder_out.device)

        # speaker losses (audio enrollment only): Arc-InfoNCE, then
        # AAM-softmax on the pooled enrollment
        gamma = asp_gamma_schedule(
            epoch, cfg.asp_gamma_initial, cfg.asp_gamma, cfg.asp_gamma_warmup_epochs
        )
        margin = aam_margin_schedule(epoch, cfg.aam_margin, cfg.warm_up_epochs)
        if not emb and cfg.contrastive_weight > 0.0:
            pooled = self.asp(enroll_embedding, gamma)
            loss_con, stats["acc_con"] = arc_infonce_loss(
                spk_prompt, pooled, batch["neg_logits"], generator,
                num_negatives=cfg.num_negatives, temperature=cfg.contrastive_temp,
                margin=cfg.contrastive_margin,
            )
            stats["loss_con"] = loss_con
            loss = loss + cfg.contrastive_weight * loss_con
            if cfg.aam_softmax_weight > 0.0:
                loss_aam, stats["acc_aam"] = self.aam(pooled, batch["spk_labels"], margin)
                stats["loss_aam"] = loss_aam
                loss = loss + cfg.aam_softmax_weight * cfg.contrastive_weight * loss_aam

        # CTC on the prompt-stripped encoder output
        text, text_lens = batch["text"], batch["text_lens"]
        prompt_len = self.encoder.prompt_len
        loss_ctc = torch.zeros((), device=loss.device)
        if cfg.ctc_weight > 0.0:
            loss_ctc = self.ctc(
                encoder_out[:, prompt_len:], out_lens - prompt_len, text, text_lens,
                ignore_id=cfg.ignore_id,
            )
            stats["loss_ctc"] = loss_ctc

        # attention branch, teacher forced
        ys_in, ys_out, _ = add_sos_eos(
            text, text_lens, cfg.sos, cfg.eos, cfg.ignore_id, pad_in=cfg.eos
        )
        decoder_out = self.decoder(encoder_out, ys_in, spk_prompt)
        loss_att = label_smoothing_loss(
            decoder_out, ys_out, smoothing=cfg.lsm_weight, ignore_id=cfg.ignore_id,
            normalize_length=cfg.length_normalized_loss,
        )
        stats["loss_att"] = loss_att
        stats["acc"] = token_accuracy(decoder_out, ys_out, cfg.ignore_id)

        if cfg.ctc_weight == 0.0:
            asr_loss = loss_att
        elif cfg.ctc_weight == 1.0:
            asr_loss = loss_ctc
        else:
            asr_loss = cfg.ctc_weight * loss_ctc + (1 - cfg.ctc_weight) * loss_att
        loss = loss + asr_loss
        stats["loss"] = loss
        return loss, {k: v.detach() for k, v in stats.items()}
