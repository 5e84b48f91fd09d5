"""Plain (non-target-speaker) Whisper ASR: the zero-shot decode path.

Mirrors the JAX package's ``models/asr.py``: Whisper's ``AudioEncoder``
and a ``TSDecoder`` without the speaker prompt, with ``pad_or_trim`` to the
30 s window before the log-mel. The encoder runs its plain self-attention
(``use_flash=False``, the JAX defaults) and the decoder the dense cross K/V
over the flat self cache, so on the card a decode reads its cache through
the self-cache kernel and, at beam > 1, reorders it with the beam-reorder
kernel. ``from_random`` initialises from numpy (``init.py``), not from
``jax.random``, so its weights are not the JAX package's for the same seed;
converted JAX variables (``convert.load_flax``) or an OpenAI checkpoint give
the same model in both.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .._device import resolve_device
from ..audio.frontend import N_SAMPLES, log_mel_spectrogram, pad_or_trim
from ..decode.search import DecodeConfig, build_beam_decoder
from ..init import init_params
from ..tokenizer.whisper_tokenizer import special_tokens_for_vocab
from .ts_decoder import TSDecoder
from .whisper.config import WhisperDims, whisper_dims
from .whisper.modules import AudioEncoder


@dataclasses.dataclass
class WhisperASR:
    """An encoder and a prompt-free decoder, on ``device`` in ``dtype``."""

    dims: WhisperDims
    encoder: AudioEncoder
    decoder: TSDecoder
    dtype: torch.dtype = torch.float32
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cuda"))

    def __post_init__(self):
        self.device = resolve_device(self.device)
        for m in (self.encoder, self.decoder):
            m.to(device=self.device, dtype=self.dtype).eval()

    @staticmethod
    def build(dims: WhisperDims) -> Tuple[AudioEncoder, TSDecoder]:
        """The encoder and decoder of ``dims``, uninitialised, on the host."""
        return AudioEncoder(dims), TSDecoder(dims, use_spk_prompt=False)

    @classmethod
    def from_random(
        cls, name: str = "tiny", seed: int = 0, dtype=torch.float32, device="cuda",
        **overrides,
    ) -> "WhisperASR":
        """Seeded random weights (smoke runs and benchmarks)."""
        dims = whisper_dims(name, **overrides)
        device = resolve_device(device)
        enc, dec = cls.build(dims)
        return cls(dims, init_params(enc, seed), init_params(dec, seed), dtype, device)

    @classmethod
    def from_openai_checkpoint(
        cls, path: str, dtype=torch.float32, device="cuda"
    ) -> "WhisperASR":
        """An OpenAI whisper ``.pt`` through ``models/whisper/load.py``."""
        from .whisper import load as wload

        device = resolve_device(device)
        dims, enc_sd, dec_sd = wload.load_openai_checkpoint(path)
        enc, dec = cls.build(dims)
        res = enc.load_state_dict(enc_sd, strict=False)  # the sinusoids stay computed
        if res.unexpected_keys or set(res.missing_keys) != {"positional_embedding"}:
            raise KeyError(f"{path} does not fit the encoder: {res}")
        dec.decoder.load_state_dict(dec_sd, strict=True)
        return cls(dims, enc, dec, dtype, device)

    def modules(self) -> Tuple[AudioEncoder, TSDecoder]:
        return self.encoder, self.decoder

    def transcribe_batch(
        self,
        audio: torch.Tensor,  # (batch, samples) float32
        language: Optional[str] = "en",
        max_new_tokens: int = 128,
        beam_size: int = 1,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zero-shot transcription: pad_or_trim to 30 s, log-mel, encode,
        greedy or beam decode. Returns (tokens (batch, max_new) int32,
        scores (batch,))."""
        st = special_tokens_for_vocab(self.dims.n_vocab)
        multilingual = self.dims.n_vocab >= 51865
        if self.dims.n_vocab > st.sot:  # the real Whisper vocabulary layout
            eot = st.eot
            init = st.sot_sequence(language, "transcribe", True, multilingual=multilingual)
        else:  # reduced-vocabulary smoke models
            eot, init = self.dims.n_vocab - 1, (0,)
        dcfg = DecodeConfig(
            max_new_tokens=max_new_tokens, eot=eot, init_tokens=init, beam_size=beam_size,
        )
        run = build_beam_decoder(self.decoder, dcfg, self.device)
        with torch.inference_mode():
            audio = pad_or_trim(torch.as_tensor(audio).float().to(self.device), N_SAMPLES)
            mel, _ = log_mel_spectrogram(audio, n_mels=self.dims.n_mels)
            memory = self.encoder(mel)
            prompt = torch.zeros(
                (audio.shape[0], 0, self.dims.n_text_state), dtype=self.dtype, device=self.device
            )
        return run(memory, prompt)
