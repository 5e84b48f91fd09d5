"""Symmetric int8 quantization and the W8A8 matmul of the decode step.

The JAX package's ``ops/quant.py``: ``quantize_weight`` gives int8 weights
with one f32 scale per output channel, computed once per decoder build;
``quantize_activation`` gives dynamic int8 codes with one scale per row;
``qmatmul`` multiplies them, ``y = (x_q @ w_q^T) * (a_s * w_s) + bias``,
with the sums exact in int32 and the scales folded into an f32 epilogue.
Every scale is ``max(amax / 127, 1e-12)`` in f32 and every code
``round(x / scale)``, half to even, by a true division on every device
(PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
which can move the last bit of a scale, so the divisor here is a tensor).

Weights keep the port's ``(out, in)`` layout (``nn.Linear``'s), so the
scale is taken over the last axis; the tied embedding ``(n_vocab,
n_state)`` is the same layout, quantized per row for the logits.

``qmatmul`` launches the hand-written CUDA kernels
(``csrc/w8a8_matmul.cu``) for CUDA tensors and runs ``qmatmul_plain`` for
CPU tensors: at most ``DECODE_ROWS`` rows (the decode step) and K at most
``DECODE_MAX_K``, one kernel with the row quantizer fused in; otherwise
(the encoder's rows) the row quantizer, then a ``wgmma`` product
(``launches_per_call``). The plain version sums the int8 products in f64,
exact for any K this model has (every partial sum is an integer below
2^53), so the two agree bit for bit.

Training and prefill never use this path: they run the dense weights.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build

_C127: Dict[torch.device, torch.Tensor] = {}
_X_MODES = {torch.float32: 0, torch.bfloat16: 1}
_OUT_MODES = {torch.float32: 0, torch.bfloat16: 1}
# the C entry's fused one-launch path takes at most this many rows and this K
# (w8a8_matmul.cu: DECODE_ROWS, DECODE_MAX_K)
DECODE_ROWS = 64
DECODE_MAX_K = 8192


def launches_per_call(m: int, k: int) -> int:
    """Kernels one ``qmatmul`` of ``m`` rows and depth ``k`` should launch
    on the card: one (quantizer and product fused) for at most
    ``DECODE_ROWS`` rows and ``k <= DECODE_MAX_K``, else two (the row
    quantizer, then the ``wgmma`` product). It decides whether ``qmatmul``
    passes scratch; what ``qmatmul`` counts is what the C entry reports."""
    return 1 if m <= DECODE_ROWS and k <= DECODE_MAX_K else 2


def _over_127(t: torch.Tensor) -> torch.Tensor:
    """``t / 127`` as an IEEE division: the divisor is a tensor on ``t``'s
    device (one per device, made at first use)."""
    c = _C127.get(t.device)
    if c is None:
        c = _C127[t.device] = torch.tensor(127.0, device=t.device)
    return t / c


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., out, in) weights -> (int8 codes of that shape, f32 scales
    (..., out)): one scale per output channel, over ``in``."""
    wf = w.float()
    scale = torch.clamp(_over_127(wf.abs().amax(dim=-1)), min=1e-12)
    return torch.round(wf / scale[..., None]).to(torch.int8), scale


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_q int8, scale f32 with the last axis kept as size 1)."""
    xf = x.float()
    scale = torch.clamp(_over_127(xf.abs().amax(dim=-1, keepdim=True)), min=1e-12)
    return torch.round(xf / scale).to(torch.int8), scale


def qmatmul_plain(
    x: torch.Tensor,  # (..., K) activations, f32 or bf16
    w_q: torch.Tensor,  # (N, K) int8
    w_s: torch.Tensor,  # (N,) f32
    bias: Optional[torch.Tensor] = None,  # (N,) f32
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``qmatmul`` in plain PyTorch: the JAX package's order, the int8
    products summed exactly (f64), then ``* (a_s * w_s)``, ``+ bias`` and
    the cast, each rounded on its own."""
    x_q, a_s = quantize_activation(x)
    acc = torch.matmul(x_q.double(), w_q.double().t())
    y = acc.float() * (a_s * w_s)
    if bias is not None:
        y = y + bias
    return y if out_dtype is None else y.to(out_dtype)


def qmatmul(
    x: torch.Tensor,
    w_q: torch.Tensor,
    w_s: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """W8A8 matmul: (..., K) activations, (N, K) int8 weights with (N,) f32
    scales and an optional (N,) f32 bias -> (..., N), f32 unless
    ``out_dtype`` (f32 or bf16 on the card) says otherwise. On a CUDA
    tensor it launches the kernels, adds to ``launches`` the number the C
    entry reports it launched, and raises for what they do not take: K
    must be a multiple of 16 (16-byte weight rows)."""
    if w_q.dim() != 2 or x.shape[-1] != w_q.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} does not match weights {tuple(w_q.shape)}")
    n, k = w_q.shape
    if w_q.dtype != torch.int8 or w_s.shape != (n,) or w_s.dtype != torch.float32:
        raise TypeError("weights are (N, K) int8 with (N,) f32 scales")
    if bias is not None and (bias.shape != (n,) or bias.dtype != torch.float32):
        raise TypeError(f"bias must be ({n},) f32")
    if x.device.type == "cpu":
        return qmatmul_plain(x, w_q, w_s, bias, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    out_dtype = out_dtype or torch.float32
    if x.dtype not in _X_MODES or out_dtype not in _OUT_MODES:
        raise TypeError(
            f"the kernel takes f32 or bf16 activations and output, got {x.dtype} -> {out_dtype}"
        )
    if k % 16:
        raise ValueError(
            f"w8a8_matmul needs K a multiple of 16 (16-byte weight rows), got "
            f"x {tuple(x.shape)} @ w_q {tuple(w_q.shape)}"
        )
    for t in (w_q, w_s) + (() if bias is None else (bias,)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("weights, scales and bias must be contiguous and on x's device")
    if w_q.data_ptr() % 16:
        raise ValueError("the int8 weights must be 16-byte aligned (the kernel's row loads)")
    x2 = x.reshape(-1, k).contiguous()
    if x2.data_ptr() % 16:  # the kernels read 16-byte words of a row
        x2 = x2.clone()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m:
        xq_ptr = as_ptr = None
        if launches_per_call(m, k) == 2:
            # the codes and the row scales, one buffer: (m, k) int8 then (m,) f32
            scratch = torch.empty(m * k + 4 * m, dtype=torch.int8, device=x.device)
            xq_ptr, as_ptr = scratch.data_ptr(), scratch.data_ptr() + m * k
        launched = ctypes.c_int(0)
        err = _build.load("w8a8_matmul")(
            x2.data_ptr(), w_q.data_ptr(), w_s.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            xq_ptr, as_ptr, m, n, k,
            _X_MODES[x.dtype], _OUT_MODES[out_dtype], _build.stream_ptr(x.device),
            ctypes.byref(launched),
        )
        qmatmul.launches += launched.value
        _build.check(err, "w8a8_matmul")
    return out.reshape(*x.shape[:-1], n)


qmatmul.launches = 0
