"""Dynamic int8 quantization of activations.

The JAX package's ``ops/quant.py::quantize_activation``: symmetric int8 per
row over the last axis, the scale ``max(amax / 127, 1e-12)`` in f32, values
rounded half to even. The 5-D int8 self cache uses it for its entries, the
query and the folded softmax weights. The W8A8 step weights of the same
module (``quantize_weight``, ``qmatmul``) are ROADMAP A10.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x_q int8, scale f32 with the last axis kept as size 1)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
    return torch.round(xf / scale).to(torch.int8), scale
