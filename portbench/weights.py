"""Seeded weights, LoRA factors and sub-seeds, made on the device.

Every floating parameter is drawn from one ``torch.randn`` over all of them
(sorted by name, bf16, on the device), scaled by its leaf's rule and kept as
bf16 values, so a float32 copy (the reference) and a bf16 one (the program)
hold the same numbers. The rules, by name:

- a bias: 0; any other 1-D weight (a layer norm's scale): 1;
- ``token_embedding``: N(0, 1 / width); ``positional_embedding`` and
  ``query_tokens``: N(0, 0.02^2); ``aam.classifier``: N(0, 1 / width);
- every other weight (Linear, conv): N(0, 1 / fan_in).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for ``stream`` of the run seed ``seed``."""
    key = [int(b) for b in stream.encode()]
    state = np.random.SeedSequence([seed & (2**64 - 1), *key]).generate_state(2, np.uint32)
    return int((int(state[0]) << 31) ^ int(state[1])) & (2**63 - 1)


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, stream))


def std_of(name: str, shape: Tuple[int, ...]):
    """The leaf's standard deviation, or ("const", value)."""
    if name.endswith(".bias"):
        return ("const", 0.0)
    if len(shape) == 1:
        return ("const", 1.0)
    if "token_embedding" in name or name == "aam.classifier":
        return shape[-1] ** -0.5
    if "positional_embedding" in name or "query_tokens" in name:
        return 0.02
    return math.prod(shape[1:]) ** -0.5


@torch.no_grad()
def make_weights(specs: Iterable[Tuple[str, Tuple[int, ...]]], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: bf16 tensor on ``device``} for (name, shape) ``specs``."""
    specs = sorted(specs)
    drawn = [(n, s) for n, s in specs if not isinstance(std_of(n, s), tuple)]
    total = sum(math.prod(s) for _, s in drawn)
    flat = torch.randn(total, generator=generator(seed, "weights", device), device=device,
                       dtype=torch.bfloat16)
    out, off = {}, 0
    for name, shape in specs:
        rule = std_of(name, shape)
        if isinstance(rule, tuple):
            out[name] = torch.full(shape, rule[1], dtype=torch.bfloat16, device=device)
            continue
        n = math.prod(shape)
        out[name] = (flat[off:off + n].float() * rule).to(torch.bfloat16).view(shape)
        off += n
    return out


@torch.no_grad()
def make_lora(targets: List[Tuple[str, Tuple[int, ...]]], rank: int, seed: int, device):
    """{weight name: (a (in, rank) ~ N(0, 1/in), b (rank, out) = 0)}, f32."""
    targets = sorted(targets)
    total = sum(shape[1] * rank for _, shape in targets)
    flat = torch.randn(total, generator=generator(seed, "lora", device), device=device)
    out, off = {}, 0
    for name, (n_out, n_in) in targets:
        a = flat[off:off + n_in * rank].view(n_in, rank) * n_in ** -0.5
        out[name] = (a.clone(), torch.zeros(rank, n_out, device=device))
        off += n_in * rank
    return out
