"""Seeded random weights for the port's modules, from numpy alone.

``init_params(module, seed)`` fills every parameter from
``numpy.random.default_rng(seed)`` in a fixed order (sorted parameter
names): linear and conv weights N(0, 1/fan_in), embeddings N(0, 1/width),
the decoder's text positions and the Qformer's query tokens N(0, 0.02^2),
layer norms, batch norms and conditional layer norms 1 and biases 0, the
conditional layer norms' delta heads 0 -- the scales of the JAX package's
flax initialisers. The training heads take the JAX package's own initialisers:
the ASP projection xavier-uniform, the AAM classifier (num_speakers, dim)
lecun-normal (a normal truncated at two standard deviations, of variance
1 / num_speakers: flax takes the fan-in from the second-to-last axis).
Buffers (the sinusoid tables, batch-norm statistics) keep their values. The same seed
gives the same weights on any machine, with no JAX.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .losses.speaker import AAMSoftmaxHead, AttentiveStatisticsPooling
from .models.ts_encoder import ConditionalLayerNorm
from .models.whisper.modules import LayerNorm

_TRUNC_STD = 0.87962566103423978  # std of N(0, 1) truncated to [-2, 2]


def _std(owner: nn.Module, name: str, p: torch.Tensor) -> float:
    if name == "bias":
        return 0.0
    if isinstance(owner, nn.Embedding):
        return p.shape[1] ** -0.5
    if isinstance(owner, (nn.Linear, nn.Conv1d, nn.Conv2d)):
        return (p[0].numel()) ** -0.5  # 1 / sqrt(fan_in)
    return 0.02  # positional_embedding, query_tokens


def _truncated_normal(rng: np.random.Generator, shape) -> np.ndarray:
    """N(0, 1) truncated to [-2, 2], by redrawing what falls outside."""
    x = rng.standard_normal(shape, dtype=np.float32)
    while True:
        out = np.abs(x) > 2.0
        if not out.any():
            return x
        x[out] = rng.standard_normal(int(out.sum()), dtype=np.float32)


@torch.no_grad()
def init_params(module: nn.Module, seed: int) -> nn.Module:
    rng = np.random.default_rng(seed)
    owners = {
        f"{mname}.{pname}" if mname else pname: (m, pname)
        for mname, m in module.named_modules()
        for pname, _ in m.named_parameters(recurse=False)
    }
    asp_projections = {
        id(m.projection) for m in module.modules()
        if isinstance(m, AttentiveStatisticsPooling) and m.projection is not None
    }
    zero_heads = {
        id(head) for m in module.modules() if isinstance(m, ConditionalLayerNorm)
        for head in (m.delta_scale, m.delta_bias) if head is not None
    }
    for full, p in sorted(module.named_parameters()):
        owner, name = owners[full]
        if isinstance(owner, (LayerNorm, ConditionalLayerNorm, nn.BatchNorm2d)):
            p.fill_(1.0 if name == "weight" else 0.0)
            continue
        if isinstance(owner, AAMSoftmaxHead):  # lecun_normal, fan_in = shape[-2]
            std = np.float32(p.shape[-2] ** -0.5 / _TRUNC_STD)
            p.copy_(torch.from_numpy(_truncated_normal(rng, tuple(p.shape)) * std))
            continue
        if id(owner) in asp_projections and name == "weight":  # xavier_uniform
            limit = np.sqrt(6.0 / (p.shape[0] + p.shape[1]))
            p.copy_(torch.from_numpy(rng.uniform(-limit, limit, tuple(p.shape)).astype(np.float32)))
            continue
        std = 0.0 if id(owner) in zero_heads else _std(owner, name, p)
        if std == 0.0:
            p.zero_()
            continue
        x = rng.standard_normal(tuple(p.shape), dtype=np.float32) * std
        p.copy_(torch.from_numpy(x))
    return module
