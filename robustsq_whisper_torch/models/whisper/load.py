"""Pretrained Whisper checkpoints mapped onto the port's modules.

The JAX package's ``models/whisper/load.py`` for the port. Two sources,
both read offline:

- OpenAI ``whisper`` ``.pt`` files (``whisper.load_model``'s format: a
  ``dims`` dict and a ``model_state_dict``), read with ``torch.load``;
- HuggingFace ``WhisperModel`` state dicts (plain ``{name: tensor}`` maps;
  nothing of ``transformers`` is imported).

Each map returns the state dict of the port's ``AudioEncoder`` or
``TextDecoder`` (``modules.py``) in f32: ``nn.Linear`` and ``Conv1d``
weights as the files store them (no transposes), one ``blocks.{i}`` entry
per layer (no stacking). The encoder's sinusoid positions are a buffer of
the module, computed, not read.

``adapt_vocab`` is the reference's vocab-size adaptation: on a mismatch it
appends rows drawn from N(mean, std) of the original table, or redraws the
whole table, from ``numpy.random.default_rng(seed)`` in the JAX package's
order, so both packages append the same rows.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from .config import WhisperDims

StateDict = Dict[str, torch.Tensor]


def _f32(x: Any) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", torch.float32, copy=True)


def _linear(out: StateDict, name: str, sd: Mapping[str, Any], src: str, bias: bool = True):
    out[f"{name}.weight"] = _f32(sd[f"{src}.weight"])
    if bias:
        out[f"{name}.bias"] = _f32(sd[f"{src}.bias"])


def _attn(out: StateDict, name: str, sd: Mapping[str, Any], src: str, names: Tuple[str, ...]):
    q, k, v, o = names
    _linear(out, f"{name}.query", sd, f"{src}.{q}")
    _linear(out, f"{name}.key", sd, f"{src}.{k}", bias=False)  # Whisper's key has no bias
    _linear(out, f"{name}.value", sd, f"{src}.{v}")
    _linear(out, f"{name}.out", sd, f"{src}.{o}")


# ---------------- OpenAI whisper checkpoints ----------------

_OPENAI_ATTN = ("query", "key", "value", "out")


def encoder_state_from_openai(sd: Mapping[str, Any], n_layers: int) -> StateDict:
    out: StateDict = {}
    for conv in ("conv1", "conv2"):
        _linear(out, conv, sd, f"encoder.{conv}")
    _linear(out, "ln_post", sd, "encoder.ln_post")
    for i in range(n_layers):
        p, b = f"encoder.blocks.{i}", f"blocks.{i}"
        _linear(out, f"{b}.attn_ln", sd, f"{p}.attn_ln")
        _attn(out, f"{b}.attn", sd, f"{p}.attn", _OPENAI_ATTN)
        _linear(out, f"{b}.mlp_ln", sd, f"{p}.mlp_ln")
        _linear(out, f"{b}.mlp_fc1", sd, f"{p}.mlp.0")
        _linear(out, f"{b}.mlp_fc2", sd, f"{p}.mlp.2")
    return out


def decoder_state_from_openai(sd: Mapping[str, Any], n_layers: int) -> StateDict:
    out: StateDict = {
        "token_embedding.weight": _f32(sd["decoder.token_embedding.weight"]),
        "positional_embedding": _f32(sd["decoder.positional_embedding"]),
    }
    _linear(out, "ln", sd, "decoder.ln")
    for i in range(n_layers):
        p, b = f"decoder.blocks.{i}", f"blocks.{i}"
        for attn in ("attn", "cross_attn"):
            _linear(out, f"{b}.{attn}_ln", sd, f"{p}.{attn}_ln")
            _attn(out, f"{b}.{attn}", sd, f"{p}.{attn}", _OPENAI_ATTN)
        _linear(out, f"{b}.mlp_ln", sd, f"{p}.mlp_ln")
        _linear(out, f"{b}.mlp_fc1", sd, f"{p}.mlp.0")
        _linear(out, f"{b}.mlp_fc2", sd, f"{p}.mlp.2")
    return out


def load_openai_checkpoint(path: str) -> Tuple[WhisperDims, StateDict, StateDict]:
    """An OpenAI whisper ``.pt`` -> (dims, encoder state, decoder state)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    dims_d = ckpt["dims"] if "dims" in ckpt else {}
    sd = ckpt.get("model_state_dict", ckpt)
    fields = WhisperDims.__dataclass_fields__
    dims = WhisperDims(**{k: v for k, v in dims_d.items() if k in fields})
    return (
        dims,
        encoder_state_from_openai(sd, dims.n_audio_layer),
        decoder_state_from_openai(sd, dims.n_text_layer),
    )


# ---------------- HuggingFace transformers ----------------

_HF_ATTN = ("q_proj", "k_proj", "v_proj", "out_proj")


def _hf_prefix(sd: Mapping[str, Any], part: str) -> str:
    return f"{part}." if any(k.startswith(f"{part}.") for k in sd) else ""


def encoder_state_from_hf(sd: Mapping[str, Any], n_layers: int) -> StateDict:
    pre = _hf_prefix(sd, "encoder")
    out: StateDict = {}
    for conv in ("conv1", "conv2"):
        _linear(out, conv, sd, f"{pre}{conv}")
    _linear(out, "ln_post", sd, f"{pre}layer_norm")
    for i in range(n_layers):
        p, b = f"{pre}layers.{i}", f"blocks.{i}"
        _linear(out, f"{b}.attn_ln", sd, f"{p}.self_attn_layer_norm")
        _attn(out, f"{b}.attn", sd, f"{p}.self_attn", _HF_ATTN)
        _linear(out, f"{b}.mlp_ln", sd, f"{p}.final_layer_norm")
        _linear(out, f"{b}.mlp_fc1", sd, f"{p}.fc1")
        _linear(out, f"{b}.mlp_fc2", sd, f"{p}.fc2")
    return out


def decoder_state_from_hf(sd: Mapping[str, Any], n_layers: int) -> StateDict:
    pre = _hf_prefix(sd, "decoder")
    out: StateDict = {
        "token_embedding.weight": _f32(sd[f"{pre}embed_tokens.weight"]),
        "positional_embedding": _f32(sd[f"{pre}embed_positions.weight"]),
    }
    _linear(out, "ln", sd, f"{pre}layer_norm")
    for i in range(n_layers):
        p, b = f"{pre}layers.{i}", f"blocks.{i}"
        _linear(out, f"{b}.attn_ln", sd, f"{p}.self_attn_layer_norm")
        _attn(out, f"{b}.attn", sd, f"{p}.self_attn", _HF_ATTN)
        _linear(out, f"{b}.cross_attn_ln", sd, f"{p}.encoder_attn_layer_norm")
        _attn(out, f"{b}.cross_attn", sd, f"{p}.encoder_attn", _HF_ATTN)
        _linear(out, f"{b}.mlp_ln", sd, f"{p}.final_layer_norm")
        _linear(out, f"{b}.mlp_fc1", sd, f"{p}.fc1")
        _linear(out, f"{b}.mlp_fc2", sd, f"{p}.fc2")
    return out


# ---------------- vocab adaptation ----------------


def adapt_vocab(
    decoder_state: StateDict,
    vocab_size: int,
    load_origin_token_embedding: bool = True,
    seed: int = 0,
) -> StateDict:
    """Match the reference's vocab-mismatch handling: keep the original
    rows and append rows drawn from N(mean, std) of the original table
    (``load_origin_token_embedding``), or redraw the whole table from that
    distribution. The mean and standard deviation are numpy's f32 ones and
    the rows numpy's, as in the JAX package."""
    emb = decoder_state["token_embedding.weight"].numpy().astype(np.float32, copy=False)
    orig = emb.shape[0]
    if vocab_size == orig:
        return decoder_state
    rng = np.random.default_rng(seed)
    mean, std = float(emb.mean()), float(emb.std())
    if load_origin_token_embedding:
        if vocab_size < orig:
            raise ValueError("expanded vocab_size must exceed the original")
        extra = rng.normal(mean, std, (vocab_size - orig, emb.shape[1])).astype(np.float32)
        new = np.concatenate([emb, extra], axis=0)
    else:
        new = rng.normal(mean, std, (vocab_size, emb.shape[1])).astype(np.float32)
    out = dict(decoder_state)
    out["token_embedding.weight"] = torch.from_numpy(new)
    return out
