"""Whisper's log-mel frontend in plain float32 PyTorch and NumPy.

n_fft 400, hop 160, periodic Hann window, centre reflect padding, the last
frame dropped; power through 80 (or 128) slaney mel filters, log10 clamped
at 1e-10, floored at the utterance's maximum minus 8, then (x + 4) / 4.
The filter bank is librosa's ``filters.mel(sr=16000, n_fft=400)`` from its
closed form. ``pcm16`` is the 16-bit rounding of a float waveform.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

N_FFT, HOP, SR = 400, 160, 16000


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3.0)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / (np.log(6.4) / 27.0), lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = (200.0 / 3.0) * m
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (np.maximum(m, 15.0) - 15.0)), lin)


@functools.lru_cache(maxsize=4)
def mel_filters(n_mels: int) -> np.ndarray:
    n_freqs = N_FFT // 2 + 1
    fft = np.linspace(0.0, SR / 2.0, n_freqs)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SR / 2.0), n_mels + 2))
    diff = np.diff(hz)
    ramps = hz[:, None] - fft[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / diff[:-1, None], ramps[2:] / diff[1:, None]))
    return (w * (2.0 / (hz[2:] - hz[:n_mels]))[:, None]).astype(np.float32)


def log_mel(audio: torch.Tensor, lens: torch.Tensor, n_mels: int = 80):
    """(b, samples) float32 waveform -> ((b, n_mels, samples // 160) log-mel,
    frame lengths lens // 160)."""
    window = torch.hann_window(N_FFT, periodic=True, device=audio.device)
    spec = torch.stft(audio.float(), N_FFT, hop_length=HOP, window=window, center=True,
                      pad_mode="reflect", onesided=True, return_complex=True)
    power = (spec.real.square() + spec.imag.square())[..., :-1]
    mel = torch.einsum("mf,bft->bmt", torch.from_numpy(mel_filters(n_mels)).to(audio.device), power)
    x = torch.log10(torch.clamp(mel, min=1e-10))
    x = torch.maximum(x, x.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (x + 4.0) / 4.0, lens // HOP


def pcm16(wave: np.ndarray) -> np.ndarray:
    """A float waveform as it reads back after 16-bit PCM."""
    q = np.clip(np.rint(np.asarray(wave, np.float32) * 32768.0), -32768, 32767)
    return (q * (1.0 / 32768.0)).astype(np.float32)
