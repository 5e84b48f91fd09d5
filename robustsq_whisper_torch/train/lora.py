"""LoRA as factors beside the weights.

Same transform as the JAX package's ``train/lora.py``: rank-``r`` factors
``(a (in, r), b (r, out))`` on every weight whose name matches ``targets``
(the Whisper and the Qformer attention q/k/v/out projections), the
effective weight ``W + scale * (a @ b)`` with ``scale = alpha / rank``
(``W`` is the ``(out, in)`` Linear weight, so the delta is transposed). ``a``
starts N(0, 1/in), ``b`` at zero, so the merged model equals the base one.

The factors are keyed by the weight's parameter name
(``encoder.encoder.blocks.3.attn.query.weight``); the JAX regex on flax
paths (``.../attn/query/kernel``) becomes the same regex on dotted names.
``attach_lora`` hands the factors to the ``Linear`` modules, whose forward
then uses the effective weight (differentiable in ``a`` and ``b``);
``merge_lora`` / ``fold_lora`` bake them into a state dict.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..models.whisper.modules import Linear

DEFAULT_TARGETS = r".*\.(attn|cross_attn|attention|crossattention)\.(query|key|value|out)\.weight$"

Factors = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 16
    alpha: float = 32.0
    targets: str = DEFAULT_TARGETS

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def lora_targets(model: nn.Module, cfg: LoraConfig = LoraConfig()) -> Dict[str, Linear]:
    """{weight name: its Linear} for every weight ``cfg.targets`` matches."""
    pattern = re.compile(cfg.targets)
    return {
        f"{name}.weight": m for name, m in model.named_modules()
        if isinstance(m, Linear) and pattern.match(f"{name}.weight")
    }


def init_lora(model: nn.Module, cfg: LoraConfig = LoraConfig(), seed: int = 0) -> Factors:
    """f32 factors for every target, a ~ N(0, 1/in) from
    ``numpy.random.default_rng(seed)`` in sorted name order, b = 0; on the
    weights' device."""
    rng = np.random.default_rng(seed)
    out: Factors = {}
    for name, lin in sorted(lora_targets(model, cfg).items()):
        fan_out, fan_in = lin.weight.shape
        a = rng.standard_normal((fan_in, cfg.rank), dtype=np.float32) * fan_in**-0.5
        dev = lin.weight.device
        out[name] = (
            torch.from_numpy(a).to(dev),
            torch.zeros((cfg.rank, fan_out), device=dev),
        )
    return out


def attach_lora(model: nn.Module, lora: Factors, cfg: LoraConfig = LoraConfig()) -> None:
    """Let each target Linear compute with its merged weight."""
    targets = lora_targets(model, cfg)
    missing = set(lora) - set(targets)
    if missing:
        raise KeyError(f"LoRA factors for weights that are not targets: {sorted(missing)[:3]}")
    for name, lin in targets.items():
        lin.lora = (*lora[name], cfg.scale) if name in lora else None


def detach_lora(model: nn.Module) -> None:
    for m in model.modules():
        if isinstance(m, Linear):
            m.lora = None


def merge_lora(
    state_dict: Mapping[str, torch.Tensor], lora: Factors, cfg: LoraConfig = LoraConfig()
) -> Dict[str, torch.Tensor]:
    """A new state dict with ``W + scale * (a @ b)^T`` at each adapted
    weight (computed in f32, stored in the weight's dtype)."""
    out = dict(state_dict)
    for name, (a, b) in lora.items():
        w = state_dict[name]
        delta = (a.float() @ b.float()).t() * cfg.scale
        out[name] = (w.float() + delta.to(w.device)).to(w.dtype)
    return out


def fold_lora(
    state_dict: Mapping[str, torch.Tensor], lora: Factors, cfg: LoraConfig = LoraConfig()
) -> Dict[str, torch.Tensor]:
    """Bake the adapters into the weights for export and serving."""
    return merge_lora(state_dict, lora, cfg)
