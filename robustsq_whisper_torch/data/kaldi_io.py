"""Kaldi data-dir IO: the part of the JAX package's ``data/kaldi_io.py``
that training and decoding read.

- ``read_scp`` / ``write_scp``: the two-column ``key value`` text maps
  (wav.scp, utt2spk, text, enroll.scp, ...);
- lazy-enrollment rows ``*<utt_id> <spk_id>`` resolved against a
  ``spk2enroll.json`` (``{spk: [[utt, path], ...]}``);
- WAV read/write through scipy (16-bit PCM <-> float32 in [-1, 1]); FLAC
  (LibriSpeech's format) is read by the native decoder
  (``native/flac.cpp`` through ``data/native_loader.py``), and raises where
  that cannot be built.

The validators and the data-prep helpers come with ``cli.datapre``
(ROADMAP A).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def read_scp(path: str) -> Dict[str, str]:
    """Ordered {key: rest-of-line}."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            parts = line.split(maxsplit=1)
            out[parts[0]] = parts[1] if len(parts) > 1 else ""
    return out


def write_scp(path: str, mapping: Dict[str, str], sort: bool = True) -> None:
    keys = sorted(mapping) if sort else list(mapping)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for k in keys:
            f.write(f"{k} {mapping[k]}\n")


# ---------------- enrollment ----------------


def read_spk2enroll(path: str) -> Dict[str, List[Tuple[str, str]]]:
    """spk2enroll.json: {spk: [[utt_id, wav_path], ...]}."""
    with open(path) as f:
        return {k: [tuple(x) for x in v] for k, v in json.load(f).items()}


def write_spk2enroll(path: str, spk2enroll: Dict[str, List[Tuple[str, str]]]) -> None:
    with open(path, "w") as f:
        json.dump({k: [list(x) for x in v] for k, v in spk2enroll.items()}, f)


def is_lazy_enrollment(value: str) -> bool:
    """Train-mode rows are ``*<utt_id> <spk_id>``: the enrollment is chosen
    at load time."""
    return value.startswith("*")


def parse_lazy_enrollment(value: str) -> Tuple[str, str]:
    utt, spk = value.split()
    return utt[1:], spk


def resolve_enrollment(
    value: str,
    spk2enroll: Optional[Dict[str, List[Tuple[str, str]]]],
    rng: Optional[np.random.Generator] = None,
    exclude_utt: Optional[str] = None,
) -> str:
    """An enroll.scp row as a concrete wav path. Lazy rows pick a random
    enrollment of the speaker, excluding the mixture's own utterance."""
    return resolve_enrollment_entry(value, spk2enroll, rng, exclude_utt)[1]


def resolve_enrollment_entry(
    value: str,
    spk2enroll: Optional[Dict[str, List[Tuple[str, str]]]],
    rng: Optional[np.random.Generator] = None,
    exclude_utt: Optional[str] = None,
) -> Tuple[Optional[str], str]:
    """Like :func:`resolve_enrollment` but returns ``(enroll_utt, path)``;
    non-lazy rows return ``(None, path)``. One ``rng.integers`` draw for a
    lazy row, none otherwise (the JAX package's draws, in its order)."""
    if not is_lazy_enrollment(value):
        return None, value
    src_utt, spk = parse_lazy_enrollment(value)
    if spk2enroll is None or spk not in spk2enroll:
        raise KeyError(f"no enrollment pool for speaker {spk}")
    # never the row's own source utterance, nor a caller-given id (the
    # mixture row's)
    excluded = {src_utt, exclude_utt}
    pool = [(u, p) for u, p in spk2enroll[spk] if u not in excluded] or list(spk2enroll[spk])
    rng = rng or np.random.default_rng()
    return pool[int(rng.integers(len(pool)))]


# ---------------- wav IO ----------------


def pcm_to_float(data: np.ndarray) -> np.ndarray:
    """scipy's WAV sample array -> mono float32 in [-1, 1]."""
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV or FLAC file to float32 [-1, 1]; returns (audio,
    sample_rate)."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC":
        from . import native_loader

        if not native_loader.available():
            raise RuntimeError(f"{path}: FLAC needs the native reader, which could not be built")
        n, sr = native_loader.num_samples(path)
        batch, _ = native_loader.load_batch([path], n, expect_rate=0)
        return batch[0], sr
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    return pcm_to_float(data), int(sr)


def write_wav(path: str, audio: np.ndarray, sr: int = 16000) -> None:
    """Write float32 [-1, 1] as 16-bit PCM."""
    from scipy.io import wavfile

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    pcm = np.clip(audio, -1.0, 1.0)
    wavfile.write(path, sr, (pcm * 32767.0).astype(np.int16))
