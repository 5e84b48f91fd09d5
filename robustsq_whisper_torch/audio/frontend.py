"""Whisper log-mel frontend in plain PyTorch (f32).

Same function as the JAX package's ``audio/frontend.py``: ``torch.stft``
with n_fft 400, hop 160, a periodic Hann window, centre reflect padding;
the last frame dropped; power -> 80 slaney mel filters ->
``log10(clamp(., 1e-10))``; floor at (per-utterance max - 8), then
``(x + 4) / 4``. The JAX version evaluates the DFT as one matmul for the
TPU; here ``torch.stft`` computes the same spectrum (no kernel stands
behind this stage).

``pcm16_log_mel`` feeds the decode jobs: it sends a batch of float
waveforms to the device through pinned memory, quantizes them to int16's
grid there (``quantize_pcm16_``, what ``to_pcm16`` then ``pcm16_to_float``
compute) and runs the log-mel there, with no host sync once warm.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import annotate
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
    mel = torch.einsum("mf,bft->bmt", mel_filters(n_mels, audio.device), power)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    global_max = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, global_max - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    olens = None if ilens is None else ilens // HOP_LENGTH
    return log_spec, olens


@functools.lru_cache(maxsize=None)
def mel_filters(n_mels: int, device: torch.device) -> torch.Tensor:
    """The (n_mels, n_fft // 2 + 1) filter bank on ``device``, copied there
    once (a copy from numpy waits on the host). Made outside inference mode,
    so training can use the bank after a decode made it."""
    with torch.inference_mode(False):
        return torch.from_numpy(
            mel_filter_bank(n_freqs=N_FFT // 2 + 1, n_mels=n_mels)
        ).to(device)


def to_pcm16(audio) -> np.ndarray:
    """float waveform in [-1, 1] -> int16 (host side, numpy)."""
    return np.clip(
        np.rint(np.asarray(audio, np.float32) * PCM16_SCALE), -32768, 32767
    ).astype(np.int16)


def pcm16_to_float(a: torch.Tensor) -> torch.Tensor:
    """int16 samples -> f32 waveform (on the tensor's device)."""
    return a.float() * (1.0 / PCM16_SCALE)


def quantize_pcm16_(x: torch.Tensor) -> torch.Tensor:
    """In place, on ``x``'s device: ``pcm16_to_float(to_pcm16(x))`` for
    finite samples, bit for bit: round half to even at 2^-15, saturated to
    int16's range. Adding 0.0 turns the -0.0 that rounds a small negative
    sample into the +0.0 an int16 zero reads as."""
    return x.mul_(PCM16_SCALE).round_().clamp_(-32768, 32767).add_(0.0).mul_(1.0 / PCM16_SCALE)


def pcm16_log_mel(
    wave, lens, n_mels: int, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows, samples) float waveforms and their (rows,) sample counts,
    numpy on the host -> (rows, n_mels, samples // hop) features and the
    frame counts on ``device``, as
    ``log_mel_spectrogram(pcm16_to_float(to_pcm16(wave)), lens)`` computes
    them. The int16 grid is kept because it is exact for WAV audio; the
    quantization runs on the device. On CUDA the host copies the batch into
    pinned memory (span ``rsq:decode.frontend_copy``; PyTorch's caching host
    allocator hands a block out again only once its copy has ended) and
    sends it without blocking; ``pcm16_log_mel.staged`` counts those
    batches."""
    device = torch.device(device)
    x = torch.from_numpy(np.asarray(wave, np.float32))
    x_lens = torch.from_numpy(np.asarray(lens))
    pinned = device.type == "cuda"
    with annotate("rsq:decode.frontend_copy"):
        # the copy that quantize_pcm16_ may overwrite, never the caller's array
        x, x_lens = (x.pin_memory(), x_lens.pin_memory()) if pinned else (x.clone(), x_lens)
    if pinned:
        pcm16_log_mel.staged += 1
    x = x.to(device, non_blocking=True)
    return log_mel_spectrogram(
        quantize_pcm16_(x), x_lens.to(device, non_blocking=True), n_mels
    )


pcm16_log_mel.staged = 0


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
