"""Whisper model dimensions and the shared sinusoidal embedding.

Size presets mirror the OpenAI Whisper model family. A copy of
``models/whisper/config.py`` of the JAX package: the torch port keeps its
own so it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

MULTILINGUAL_VOCAB = 51865
ENGLISH_VOCAB = 51864


@dataclasses.dataclass(frozen=True)
class WhisperDims:
    n_mels: int = 80
    n_vocab: int = MULTILINGUAL_VOCAB
    n_audio_ctx: int = 1500
    n_audio_state: int = 384
    n_audio_head: int = 6
    n_audio_layer: int = 4
    n_text_ctx: int = 448
    n_text_state: int = 384
    n_text_head: int = 6
    n_text_layer: int = 4

    def replace(self, **kw: Any) -> "WhisperDims":
        return dataclasses.replace(self, **kw)


_PRESETS: Dict[str, Dict[str, int]] = {
    "tiny": dict(n_audio_state=384, n_audio_head=6, n_audio_layer=4,
                 n_text_state=384, n_text_head=6, n_text_layer=4),
    "base": dict(n_audio_state=512, n_audio_head=8, n_audio_layer=6,
                 n_text_state=512, n_text_head=8, n_text_layer=6),
    "small": dict(n_audio_state=768, n_audio_head=12, n_audio_layer=12,
                  n_text_state=768, n_text_head=12, n_text_layer=12),
    "medium": dict(n_audio_state=1024, n_audio_head=16, n_audio_layer=24,
                   n_text_state=1024, n_text_head=16, n_text_layer=24),
    "large": dict(n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                  n_text_state=1280, n_text_head=20, n_text_layer=32),
    # large-v1/v2 share "large" dims; v3 moves to 128 mel bins and adds one
    # token (<|yue|>); v3-turbo keeps the v3 encoder with a 4-layer decoder
    "large-v1": dict(n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                     n_text_state=1280, n_text_head=20, n_text_layer=32),
    "large-v2": dict(n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                     n_text_state=1280, n_text_head=20, n_text_layer=32),
    "large-v3": dict(n_mels=128, n_vocab=51866,
                     n_audio_state=1280, n_audio_head=20, n_audio_layer=32,
                     n_text_state=1280, n_text_head=20, n_text_layer=32),
    "large-v3-turbo": dict(n_mels=128, n_vocab=51866,
                           n_audio_state=1280, n_audio_head=20,
                           n_audio_layer=32, n_text_state=1280,
                           n_text_head=20, n_text_layer=4),
    # test-scale preset: full pipeline shape-compatible, trivially compilable
    "dev": dict(n_audio_state=64, n_audio_head=2, n_audio_layer=2,
                n_text_state=64, n_text_head=2, n_text_layer=2),
}


def whisper_dims(name: str, **overrides: Any) -> WhisperDims:
    base = name.removesuffix(".en")
    if base not in _PRESETS:
        raise ValueError(f"unknown whisper model '{name}'; have {sorted(_PRESETS)}")
    kw = dict(_PRESETS[base])
    if name.endswith(".en"):
        kw["n_vocab"] = ENGLISH_VOCAB
    kw.update(overrides)
    return WhisperDims(**kw)


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper/Qformer sinusoidal embedding table, shape (length, channels).

    Same formula as the Qformer sinusoids and OpenAI Whisper's encoder
    positional embedding.
    """
    assert channels % 2 == 0
    log_inc = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_inc * np.arange(channels // 2, dtype=np.float64))
    scaled = np.arange(length, dtype=np.float64)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)
