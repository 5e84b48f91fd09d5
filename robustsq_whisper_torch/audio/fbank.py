"""Kaldi-style log-mel filterbank features, the speaker extractor's input.

The JAX package's ``audio/fbank.py`` in torch, the computation of
``torchaudio.compliance.kaldi.fbank`` as the recipe's stage 103 calls it:
16 kHz, 25 ms frames every 10 ms (snip-edges framing), the waveform scaled
by 2^15, no dither; per frame the DC offset removed, pre-emphasis 0.97 (the
first sample against itself), a Hamming window; the power spectrum of a
512-point DFT, written as one matmul with a cos/sin bank; 80 Kaldi mel
filters (1127 ln(1 + f/700), 20 Hz to Nyquist); the natural log with the
``EPS`` floor; then CMN, the mean over each utterance's valid frames
subtracted (no variance normalisation).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

SAMPLE_RATE = 16000
FRAME_LENGTH = 400  # 25 ms
FRAME_SHIFT = 160  # 10 ms
N_MELS = 80
LOW_FREQ = 20.0  # Hz; the filters reach up to Nyquist
EPS = 1.1920928955078125e-07  # float32 eps, Kaldi's energy floor


def _hamming(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * k / (n - 1))


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=1)
def _dft_bank() -> np.ndarray:
    """(2 (nfft//2 + 1), FRAME_LENGTH) cos and -sin rows of a DFT
    zero-padded to nfft."""
    nfft = _next_pow2(FRAME_LENGTH)
    k = np.arange(nfft // 2 + 1, dtype=np.float64)[:, None]
    t = np.arange(FRAME_LENGTH, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * t / nfft
    return np.concatenate([np.cos(ang), -np.sin(ang)], axis=0).astype(np.float32)


def _mel(f: np.ndarray) -> np.ndarray:
    return 1127.0 * np.log(1.0 + f / 700.0)


@functools.lru_cache(maxsize=1)
def kaldi_mel_banks() -> np.ndarray:
    """Kaldi's triangular mel filters, shape (N_MELS, nfft//2 + 1)."""
    nfft = _next_pow2(FRAME_LENGTH)
    mel_low, mel_high = _mel(np.asarray(LOW_FREQ)), _mel(np.asarray(SAMPLE_RATE / 2.0))
    mel_points = np.linspace(mel_low, mel_high, N_MELS + 2)
    fft_mels = _mel(np.arange(nfft // 2 + 1) * SAMPLE_RATE / nfft)
    banks = np.zeros((N_MELS, nfft // 2 + 1), dtype=np.float32)
    for i in range(N_MELS):
        left, center, right = mel_points[i], mel_points[i + 1], mel_points[i + 2]
        up = (fft_mels - left) / (center - left)
        down = (right - fft_mels) / (right - center)
        banks[i] = np.maximum(0.0, np.minimum(up, down))
    return banks


def kaldi_fbank(
    audio: torch.Tensor,  # (batch, samples) float32 in [-1, 1]
    lengths: torch.Tensor,  # (batch,) valid samples
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Kaldi fbank and CMN on ``audio``'s device. Returns
    ((batch, frames, N_MELS), frame lengths), with frames =
    1 + (samples - 400) // 160; frames past a row's length are 0."""
    dev = audio.device
    audio = audio.to(torch.float32) * 32768.0
    n = audio.shape[1]
    num_frames = 1 + (n - FRAME_LENGTH) // FRAME_SHIFT
    frames = audio.unfold(1, FRAME_LENGTH, FRAME_SHIFT)[:, :num_frames]  # (b, frames, 400)

    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - 0.97 * prev
    frames = frames * torch.from_numpy(_hamming(FRAME_LENGTH).astype(np.float32)).to(dev)

    bank = torch.from_numpy(_dft_bank()).to(dev)
    n_bins = bank.shape[0] // 2
    proj = torch.matmul(frames, bank.t())
    power = proj[..., :n_bins] ** 2 + proj[..., n_bins:] ** 2
    mel = torch.matmul(power, torch.from_numpy(kaldi_mel_banks()).to(dev).t())
    feats = torch.log(torch.clamp(mel, min=EPS))

    frame_lens = torch.clamp(1 + (lengths - FRAME_LENGTH) // FRAME_SHIFT, min=0)
    mask = (torch.arange(num_frames, device=dev)[None, :] < frame_lens[:, None])[..., None]
    mean = torch.sum(torch.where(mask, feats, 0.0), dim=1, keepdim=True)
    mean = mean / torch.clamp(frame_lens[:, None, None], min=1)
    return torch.where(mask, feats - mean, 0.0), frame_lens
