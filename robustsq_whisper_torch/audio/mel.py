"""Slaney-scale mel filterbank, computed in numpy at trace time.

Reproduces the filterbank Whisper ships as ``mel_filters.npz`` (which is
``librosa.filters.mel(sr=16000, n_fft=400, n_mels=80)``: slaney mel scale,
slaney area normalization). A copy of the JAX package's ``audio/mel.py``:
the torch port keeps its own so it never imports the JAX package.

We compute it from the closed-form definition so the framework has no data
files and no librosa dependency.
"""

from __future__ import annotations

import functools

import numpy as np

# Slaney mel scale constants: linear below 1 kHz (200/3 Hz per mel),
# logarithmic above with step log(6.4)/27 per mel.
_F_SP = 200.0 / 3.0
_MIN_LOG_HZ = 1000.0
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0


def hz_to_mel(freq: np.ndarray | float) -> np.ndarray:
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq / _F_SP
    log_region = freq >= _MIN_LOG_HZ
    mels = np.where(
        log_region,
        _MIN_LOG_MEL + np.log(np.maximum(freq, _MIN_LOG_HZ) / _MIN_LOG_HZ) / _LOGSTEP,
        mels,
    )
    return mels


def mel_to_hz(mels: np.ndarray | float) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    freq = _F_SP * mels
    log_region = mels >= _MIN_LOG_MEL
    freq = np.where(
        log_region,
        _MIN_LOG_HZ * np.exp(_LOGSTEP * (np.maximum(mels, _MIN_LOG_MEL) - _MIN_LOG_MEL)),
        freq,
    )
    return freq


@functools.lru_cache(maxsize=8)
def mel_filter_bank(
    n_freqs: int = 201,
    n_mels: int = 80,
    sample_rate: int = 16000,
    f_min: float = 0.0,
    f_max: float | None = None,
) -> np.ndarray:
    """Triangular slaney-normalized mel filterbank, shape ``(n_mels, n_freqs)``."""
    if f_max is None:
        f_max = sample_rate / 2.0

    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)  # (n_mels + 2,)

    fdiff = np.diff(hz_pts)  # (n_mels + 1,)
    ramps = hz_pts[:, None] - fft_freqs[None, :]  # (n_mels + 2, n_freqs)

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # Slaney area normalization: each filter integrates to ~2/(band width).
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights = weights * enorm[:, None]

    return weights.astype(np.float32)
