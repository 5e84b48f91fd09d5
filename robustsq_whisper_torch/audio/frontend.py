"""Whisper log-mel frontend in plain PyTorch (f32).

Same function as the JAX package's ``audio/frontend.py``: ``torch.stft``
with n_fft 400, hop 160, a periodic Hann window, centre reflect padding;
the last frame dropped; power -> 80 slaney mel filters ->
``log10(clamp(., 1e-10))``; floor at (per-utterance max - 8), then
``(x + 4) / 4``. The JAX version evaluates the DFT as one matmul for the
TPU; here ``torch.stft`` computes the same spectrum (no kernel stands
behind this stage).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .mel import mel_filter_bank

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_MELS = 80
CHUNK_LENGTH = 30  # seconds
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000 mel frames for a 30 s window
PCM16_SCALE = 32768.0


def stft_power(
    audio: torch.Tensor, n_fft: int = N_FFT, hop: int = HOP_LENGTH
) -> torch.Tensor:
    """|STFT|^2 with centre reflect padding: (batch, samples) ->
    (batch, n_fft // 2 + 1, 1 + samples // hop)."""
    window = torch.hann_window(n_fft, periodic=True, device=audio.device)
    spec = torch.stft(
        audio.float(), n_fft, hop_length=hop, window=window, center=True,
        pad_mode="reflect", onesided=True, return_complex=True,
    )
    return spec.real.square() + spec.imag.square()


def log_mel_spectrogram(
    audio: torch.Tensor,
    ilens: Optional[torch.Tensor] = None,
    n_mels: int = N_MELS,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(batch, samples) waveform in [-1, 1] -> (batch, n_mels,
    samples // hop) features and the optional frame lengths ilens // hop."""
    power = stft_power(audio)[..., :-1]  # Whisper drops the last frame
    filters = torch.from_numpy(
        mel_filter_bank(n_freqs=N_FFT // 2 + 1, n_mels=n_mels)
    ).to(audio.device)
    mel = torch.einsum("mf,bft->bmt", filters, power)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    global_max = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, global_max - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    olens = None if ilens is None else ilens // HOP_LENGTH
    return log_spec, olens


def to_pcm16(audio) -> np.ndarray:
    """float waveform in [-1, 1] -> int16 (host side, numpy)."""
    return np.clip(
        np.rint(np.asarray(audio, np.float32) * PCM16_SCALE), -32768, 32767
    ).astype(np.int16)


def pcm16_to_float(a: torch.Tensor) -> torch.Tensor:
    """int16 samples -> f32 waveform (on the tensor's device)."""
    return a.float() * (1.0 / PCM16_SCALE)


def pad_or_trim(
    audio: torch.Tensor, length: int = N_SAMPLES, axis: int = -1
) -> torch.Tensor:
    """Zero-pad or truncate along ``axis``."""
    size = audio.shape[axis]
    if size > length:
        return audio.narrow(axis, 0, length)
    if size < length:
        shape = list(audio.shape)
        shape[axis] = length - size
        pad = torch.zeros(shape, dtype=audio.dtype, device=audio.device)
        return torch.cat([audio, pad], dim=axis)
    return audio
