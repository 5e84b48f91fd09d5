"""ctypes bindings for the native batched WAV / FLAC reader
(``robustsq_whisper_torch/native/wavio.cpp`` and ``flac.cpp``).

The library is built at first use with ``g++ -O3 -std=c++17 -fPIC -shared
-lpthread`` into ``robustsq_whisper_torch/_build/libwavio-<hash>.so`` (the
hash is of both sources and the flags, so an edited source is rebuilt; the
build writes beside its target and renames into place, so processes that
build at once never load a half-written file). Without a compiler the
reader is unavailable: WAV batches fall back to scipy
(``data/dataset.py``) and FLAC raises (``data/kaldi_io.py``).
``reader()`` names the reader in use and is logged once.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

PKG = Path(__file__).resolve().parent.parent
SOURCES = (PKG / "native" / "wavio.cpp", PKG / "native" / "flac.cpp")
BUILD = PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

logger = logging.getLogger("robustsq_whisper_torch.data")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        digest.update(src.read_bytes())
    return BUILD / f"libwavio-{digest.hexdigest()[:12]}.so"


def _build(path: Path) -> None:
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}")
    subprocess.run(
        ["g++", *CXX_FLAGS, "-o", str(tmp), *map(str, SOURCES), "-lpthread"],
        check=True, capture_output=True, timeout=300,
    )
    os.replace(tmp, path)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = lib_path()
        try:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.SubprocessError) as e:
            logger.warning("native WAV/FLAC reader unavailable (%s): WAV batches are "
                           "read with scipy and FLAC cannot be read", e)
            return None
        lib.wavio_load_batch.restype = ctypes.c_int
        lib.wavio_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int32,
        ]
        lib.wavio_num_samples.restype = ctypes.c_int64
        lib.wavio_num_samples.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        logger.info("native WAV/FLAC reader: %s", path.name)
        return _lib


def available() -> bool:
    return _load() is not None


def reader() -> str:
    """``"native"`` or ``"scipy"``: what reads the dataset's WAV batches."""
    return "native" if available() else "scipy"


def load_batch(
    paths: Sequence[str], out_len: int, expect_rate: int = 16000,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode WAV / FLAC files into a (n, out_len) float32 batch (zero-padded
    or truncated) and the (n,) int32 valid lengths, over a thread pool as
    wide as the host's cores. ``expect_rate`` 0 accepts any rate. Raises ``IOError`` naming the files it could not
    read."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native WAV/FLAC reader is unavailable (no g++?)")
    n = len(paths)
    out = np.zeros((n, out_len), dtype=np.float32)
    lens = np.zeros((n,), dtype=np.int64)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    failures = lib.wavio_load_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_len,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), expect_rate, 0,
    )
    if failures:
        bad = [paths[i] for i in range(n) if lens[i] < 0]
        raise IOError(f"native decode failed for {failures} files: {bad[:3]}")
    return out, lens.astype(np.int32)


def num_samples(path: str) -> Tuple[int, int]:
    """(num_samples, sample_rate) from the header alone."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native WAV/FLAC reader is unavailable (no g++?)")
    rate = ctypes.c_int32(0)
    n = lib.wavio_num_samples(path.encode(), ctypes.byref(rate))
    if n < 0:
        raise IOError(f"cannot parse the audio header of {path}")
    return int(n), int(rate.value)
