"""Build the CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` (the hash is
of the source and of every shared ``csrc/*.cuh`` header, so an edited kernel
or header is rebuilt). Nothing includes PyTorch's headers, so a build takes
seconds. The build directory is listed in
``.gitignore``; it is created inside the package, next to the sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
KERNELS = (
    "flash_attention_tmaj",
    "decode_cross_attention",
    "decode_self_attention",
    "beam_reorder_cache",
    "settled_self_attention",
    "flash_attention",
    "flash_attention_bwd",
    "w8a8_matmul",
)
# C entry points of a library, where not one named like the library
ENTRIES = {
    "flash_attention_bwd": ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"),
    "decode_self_attention": ("decode_self_attention", "decode_self_attention_int8"),
    "beam_reorder_cache": ("beam_reorder_cache", "beam_reorder_cache_flat"),
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of each entry point: pointers and the stream as void*, sizes
# and modes as int
SIGNATURES = {
    "flash_attention_tmaj": [_P] * 6 + [_I] * 7 + [_P],
    "decode_cross_attention": [_P] * 9 + [_I] * 11 + [_P],
    "decode_self_attention": [_P] * 8 + [_I] * 5 + [_P],
    "decode_self_attention_int8": [_P] * 9 + [_I] * 5 + [_P],
    "beam_reorder_cache": [_P] * 3 + [_I] * 6 + [_P],
    "beam_reorder_cache_flat": [_P] * 5 + [_I] * 5 + [_P],
    "settled_self_attention": [_P] * 9 + [_I] * 6 + [_P],
    "flash_attention": [_P] * 6 + [_I] * 10 + [_P],
    "flash_attention_bwd_dq": [_P] * 8 + [_I] * 10 + [_P],
    "flash_attention_bwd_dkv": [_P] * 9 + [_I] * 10 + [_P],
    "w8a8_matmul": [_P] * 7 + [_I] * 5 + [_P, _P],
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns ``{name: ptxas report}`` for the sources built now
    (empty text for those already built). Raises if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    reports = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            reports[name] = ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp, out,
        )
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str, entry: str = ""):
    """C entry point ``entry`` (default: the library's first) of kernel
    library ``name``, the library built first if missing, with the argument
    types of its entry points declared."""
    lib = _loaded.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for e in ENTRIES.get(name, (name,)):
            fn = getattr(lib, e)
            fn.argtypes = SIGNATURES[e]
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return getattr(lib, entry or ENTRIES.get(name, (name,))[0])


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def device_scalar(x, device):
    """A one-element int32 tensor on ``device`` for a kernel to read (no
    copy when ``x`` already is one; a Python int is copied to the device)."""
    import torch

    t = torch.as_tensor(x, dtype=torch.int32, device=device)
    if t.numel() != 1:
        raise ValueError(f"expected a scalar, got shape {tuple(t.shape)}")
    return t


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
