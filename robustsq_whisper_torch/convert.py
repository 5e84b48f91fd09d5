"""Flax variables of the JAX package -> the port's ``state_dict``.

Takes the variables dict of a JAX module (``{"params": ..., "buffers":
...}``, leaves as arrays or numpy) and returns the torch state dict of its
counterpart here. The module paths are the flax names with these changes:

- the scan-stacked ``block`` subtree (a leading layer axis on every leaf)
  becomes ``blocks.{i}``; unrolled ``layers_{i}`` and ``blocks_{i}`` (the
  embedding-enrollment encoder's, ``scan_layers=False``) become
  ``layers.{i}`` and ``blocks.{i}``;
- a Dense ``kernel`` (in, out) becomes a Linear ``weight`` (out, in), a
  Conv ``kernel`` (k, in, out) a Conv1d ``weight`` (out, in, k);
- LayerNorm ``scale`` and Embed ``embedding`` become ``weight``;
- everything else keeps its name: biases, ``query_tokens``, the decoder's
  ``positional_embedding`` param and the sinusoid buffers.

Whisper's attention ``key`` has no bias in either tree, so nothing is
added or dropped: every flax leaf maps to exactly one tensor (L tensors for
a stacked leaf). The training model's heads need no rule of their own:
``ctc/ctc_lo`` and ``asp/projection`` are Dense layers and the AAM
``classifier`` (num_speakers, dim) keeps its name and layout.

The embedding-enrollment encoder's ``adapter`` (``proj``, ``fc1``/``fc2``,
``film/{trunk_i, gamma, beta}``, ``adapter_norm``) and its conditional
layer norms ``attn_cln`` / ``mlp_cln`` (``scale``, ``bias`` and the
``delta_scale`` / ``delta_bias`` Dense heads) follow the same rules.
``flax_speaker_to_state_dict`` maps the speaker ResNet's variables
(``params`` and ``batch_stats``).

``flax_qw_to_port`` carries the JAX package's W8A8 weights
(``quantize_step_weights`` / ``quantize_encoder_weights``) over to the
port's form: each layer-stacked ``(L, in, out)`` int8 kernel becomes L
``(out, in)`` tensors, its scales and biases split the same way, and the
tied embedding's ``emb`` comes over as it is.

``flax_lora_to_port`` carries a JAX LoRA tree ``{kernel path: {"a": ([L,]
in, r), "b": ([L,] r, out)}}`` over to the port's per-layer factors, keyed
by the adapted weight's name (``train/lora.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Tuple

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


def _unstacked(path: Tuple[str, ...], x: np.ndarray) -> List[Tuple[List[str], np.ndarray]]:
    """A flax path and its leaf as (port module path parts, array) pairs:
    ``layers_i`` -> ``layers.i``, ``blocks_i`` -> ``blocks.i``, and a
    scan-stacked ``block`` leaf split into one ``blocks.i`` entry per
    layer."""
    parts = [
        p.replace("_", ".", 1) if p.startswith(("layers_", "blocks_")) else p
        for p in path
    ]
    if "block" not in parts:
        return [(parts, x)]
    at = parts.index("block")
    return [
        (parts[:at] + ["blocks", str(i)] + parts[at + 1 :], x[i])
        for i in range(x.shape[0])
    ]


def flax_to_state_dict(variables: Any) -> Dict[str, torch.Tensor]:
    """The torch state dict of ``variables`` (all collections merged), in
    f32. Raises if two leaves map to one name."""
    out: Dict[str, torch.Tensor] = {}
    for collection in variables.values():
        for path, leaf in _leaves(collection):
            for parts, x in _unstacked(path, np.asarray(leaf, np.float32)):
                *mods, name = parts
                tname, arr = _leaf(name, x)
                key = ".".join(mods + [tname])
                if key in out:
                    raise ValueError(f"two flax leaves map to {key}")
                out[key] = torch.from_numpy(np.array(arr, np.float32))  # owned copy
    return out


def flax_lora_to_port(lora: Any) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """JAX LoRA factors -> {port weight name: (a (in, r), b (r, out))}, f32."""
    out: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    for path, ab in lora.items():
        a, b = (np.asarray(ab[k], np.float32) for k in ("a", "b"))
        *mods, leaf = path.split("/")
        if leaf != "kernel":
            raise ValueError(f"LoRA on a non-kernel leaf: {path}")
        for (parts, a_i), (_, b_i) in zip(_unstacked(tuple(mods), a), _unstacked(tuple(mods), b)):
            out[".".join(parts + ["weight"])] = (
                torch.from_numpy(np.array(a_i)), torch.from_numpy(np.array(b_i)),
            )
    return out


def flax_qw_to_port(qw: Any) -> Dict[str, Any]:
    """JAX W8A8 weights ``{"layers": {name: ... (w_q (L, in, out) int8,
    scale (L, out), bias (L, out) or None)}[, "emb": (int8 (V, d), (V,))]}``
    -> the port's ``{"layers": [L dicts of (w_q (out, in), scale, bias)][,
    "emb": ...]}`` (``whisper.modules.quantize_step_weights``)."""
    t = lambda x: torch.from_numpy(np.array(x))  # owned copy, dtype kept

    def layer(tree: Any, i: int) -> Any:
        if isinstance(tree, (tuple, list)):
            w_q, scale, bias = tree
            return (t(np.asarray(w_q)[i].T), t(np.asarray(scale)[i]),
                    None if bias is None else t(np.asarray(bias)[i]))
        return {k: layer(v, i) for k, v in tree.items()}

    tree = qw["layers"]
    while not isinstance(tree, (tuple, list)):  # down to one (w_q, scale, bias)
        tree = next(iter(tree.values()))
    n_layers = np.asarray(tree[0]).shape[0]
    out: Dict[str, Any] = {"layers": [layer(qw["layers"], i) for i in range(n_layers)]}
    if "emb" in qw:
        out["emb"] = tuple(t(x) for x in qw["emb"])
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


def flax_speaker_to_state_dict(variables: Any) -> Dict[str, torch.Tensor]:
    """The JAX ``SpeakerResNet34``'s variables -> the port's state dict, f32:
    a Conv ``kernel`` (kH, kW, in, out) becomes a Conv2d ``weight`` (out,
    in, kH, kW) over the same (time, freq) map, BatchNorm ``scale`` /
    ``bias`` its ``weight`` / ``bias`` and ``batch_stats`` ``mean`` / ``var``
    its running statistics (``num_batches_tracked`` 0), the ``embed``
    Dense a Linear (both pool frequency-major, so no permutation)."""
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        for path, leaf in _leaves(tree):
            *mods, name = path
            x = np.asarray(leaf, np.float32)
            if collection == "batch_stats":
                name = {"mean": "running_mean", "var": "running_var"}[name]
                out[".".join(mods + ["num_batches_tracked"])] = torch.zeros((), dtype=torch.long)
            elif name == "kernel":
                x = x.transpose(3, 2, 0, 1) if x.ndim == 4 else x.T
                name = "weight"
            elif name == "scale":
                name = "weight"
            out[".".join(mods + [name])] = torch.from_numpy(np.array(x, np.float32))
    return out
