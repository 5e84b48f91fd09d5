"""Flax variables of the JAX package -> the port's ``state_dict``.

Takes the variables dict of a JAX module (``{"params": ..., "buffers":
...}``, leaves as arrays or numpy) and returns the torch state dict of its
counterpart here. The module paths are the flax names with these changes:

- the scan-stacked ``block`` subtree (a leading layer axis on every leaf)
  becomes ``blocks.{i}``; unrolled ``layers_{i}`` becomes ``layers.{i}``;
- a Dense ``kernel`` (in, out) becomes a Linear ``weight`` (out, in), a
  Conv ``kernel`` (k, in, out) a Conv1d ``weight`` (out, in, k);
- LayerNorm ``scale`` and Embed ``embedding`` become ``weight``;
- everything else keeps its name: biases, ``query_tokens``, the decoder's
  ``positional_embedding`` param and the sinusoid buffers.

Whisper's attention ``key`` has no bias in either tree, so nothing is
added or dropped: every flax leaf maps to exactly one tensor (L tensors for
a stacked leaf).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def _leaves(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def _leaf(name: str, x: np.ndarray) -> Tuple[str, np.ndarray]:
    if name == "kernel":
        if x.ndim == 2:
            return "weight", x.T
        if x.ndim == 3:
            return "weight", x.transpose(2, 1, 0)
        raise ValueError(f"kernel of rank {x.ndim}")
    if name in ("scale", "embedding"):
        return "weight", x
    return name, x


def flax_to_state_dict(variables: Any) -> Dict[str, torch.Tensor]:
    """The torch state dict of ``variables`` (all collections merged), in
    f32. Raises if two leaves map to one name."""
    out: Dict[str, torch.Tensor] = {}

    def put(parts, x):
        *mods, name = parts
        tname, arr = _leaf(name, x)
        key = ".".join(mods + [tname])
        if key in out:
            raise ValueError(f"two flax leaves map to {key}")
        out[key] = torch.from_numpy(np.array(arr, np.float32))  # owned copy

    for collection in variables.values():
        for path, leaf in _leaves(collection):
            x = np.asarray(leaf, np.float32)
            parts = [
                p.replace("layers_", "layers.") if p.startswith("layers_") else p
                for p in path
            ]
            if "block" in parts:
                at = parts.index("block")
                for i in range(x.shape[0]):
                    put(parts[:at] + ["blocks", str(i)] + parts[at + 1 :], x[i])
            else:
                put(parts, x)
    return out


def load_flax(module: torch.nn.Module, variables: Any) -> torch.nn.Module:
    """Load JAX variables into ``module`` (strict), cast to its dtypes."""
    sd = flax_to_state_dict(variables)
    own = module.state_dict()
    module.load_state_dict(
        {k: v.to(own[k].dtype) if k in own else v for k, v in sd.items()},
        strict=True,
    )
    return module
