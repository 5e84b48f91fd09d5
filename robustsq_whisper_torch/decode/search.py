"""Batched KV-cache greedy decode for TS-Whisper.

Mirrors the greedy half of the JAX package's ``decode/search.py``: the
speaker-prompt prefix is prefilled once, then one token per step runs over
the preallocated flat self cache (updated in place) and the cross K/V,
quantized for the token loop when ``quantize_cross_kv`` is set. The loop
runs eagerly; with ``stop_early`` it ends once every row emitted eot, which
costs one device-to-host read per token.

Beam search (``beam_size > 1``), speculative decode, timestamps, joint CTC
and W8A8 step weights are later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch

from .._device import resolve_device
from ..models.ts_decoder import TSDecoder


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """The JAX package's DecodeConfig, field for field."""

    max_new_tokens: int = 200
    # eot is masked from the raw logits until this many tokens were emitted
    min_new_tokens: int = 0
    eot: int = 50257
    init_tokens: Tuple[int, ...] = (50258,)
    beam_size: int = 1
    length_penalty: float = 0.0
    quantize_cross_kv: bool = False
    quantize_weights: bool = False
    # end the token loop once every row emitted eot
    stop_early: bool = True
    beam_reorder: str = "auto"
    defer_reorder: int = 0
    # quantize the cross K/V before the prefill (which then attends the
    # quantized form) so the dense stacked cross K/V never exists
    prefill_quantized: bool = False
    speculative_gamma: int = 0
    draft_layers: int = 4
    ctc_decode_weight: float = 0.0
    pre_beam: int = 8
    maxlenratio: float = 0.0
    minlenratio: float = 0.0
    with_timestamps: bool = False
    timestamp_begin: int = 50364
    max_initial_timestamp_index: int = 50


def length_bounds(
    cfg: DecodeConfig, memory: torch.Tensor, spk_prompt: torch.Tensor,
    use_prompt: bool,
) -> Tuple[int, int]:
    """(max_new, min_new) with the encoder-relative ratio bounds applied
    against the encoder window (prompt frames excluded)."""
    enc_t = memory.shape[1] - (spk_prompt.shape[1] if use_prompt else 0)
    return length_bounds_static(cfg, enc_t)


def length_bounds_static(cfg: DecodeConfig, enc_t: int) -> Tuple[int, int]:
    max_new = cfg.max_new_tokens
    if cfg.maxlenratio > 0:
        max_new = min(max_new, max(1, int(cfg.maxlenratio * enc_t)))
    min_new = cfg.min_new_tokens
    if cfg.minlenratio > 0:
        min_new = max(min_new, int(cfg.minlenratio * enc_t))
    return max_new, min_new


def _check_greedy(cfg: DecodeConfig) -> None:
    if cfg.speculative_gamma > 0:
        raise NotImplementedError("speculative decode is ROADMAP A11")
    if cfg.with_timestamps:
        raise NotImplementedError("timestamp decoding is ROADMAP A13")
    if cfg.ctc_decode_weight > 0:
        raise NotImplementedError("joint CTC/attention decode is ROADMAP A13")
    if cfg.quantize_weights:
        raise NotImplementedError("W8A8 step weights are ROADMAP A10")
    if cfg.prefill_quantized and not cfg.quantize_cross_kv:
        raise ValueError(
            "prefill_quantized requires quantize_cross_kv=True: the option "
            "prefills on the quantized cross K/V"
        )


def build_greedy_decoder(
    dec: TSDecoder,
    cfg: DecodeConfig = DecodeConfig(),
    device="cuda",
) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Returns ``run(memory, spk_prompt) -> (tokens, scores)``.

    tokens: (batch, max_new) int32, eot-padded after stop; scores: (batch,)
    summed log-probs of the emitted tokens (up to eot). Moves ``dec`` to
    ``device``."""
    _check_greedy(cfg)
    dev = resolve_device(device)
    dec.to(dev).eval()

    @torch.inference_mode()
    def run(memory: torch.Tensor, spk_prompt: torch.Tensor):
        memory, spk_prompt = memory.to(dev), spk_prompt.to(dev)
        b = memory.shape[0]
        prompt_len = 1 + spk_prompt.shape[1] if dec.use_spk_prompt else 0
        max_new, min_new = length_bounds(
            cfg, memory, spk_prompt, dec.use_spk_prompt
        )
        total = prompt_len + len(cfg.init_tokens) + max_new

        # prefill on the dense cross K/V (exact, runs once) and quantize
        # after for the token loop, unless prefill_quantized
        pq = cfg.prefill_quantized
        cross = dec.cross_kv(memory, quantize=pq)
        cache = dec.init_cache(b, total)
        init = torch.tensor(cfg.init_tokens, dtype=torch.int64, device=dev)
        init = init[None, :].expand(b, -1)
        logits, cache = dec.prefill(init, spk_prompt, cache, cross)
        if cfg.quantize_cross_kv and not pq:
            cross = dec.quantize_cross(cross)

        base = prompt_len + len(cfg.init_tokens)
        pos = torch.tensor(base, dtype=torch.int32, device=dev)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        score = torch.zeros(b, dtype=torch.float32, device=dev)
        tokens = torch.full((b, max_new), cfg.eot, dtype=torch.int32, device=dev)
        for i in range(max_new):
            if i < min_new:
                logits[:, cfg.eot] = -1e30
            logp = torch.log_softmax(logits, dim=-1)
            tok = torch.argmax(logp, dim=-1)
            tok = torch.where(done, cfg.eot, tok)
            tok_logp = logp.gather(1, tok[:, None])[:, 0]
            score = score + torch.where(done, 0.0, tok_logp)
            done = done | (tok == cfg.eot)
            tokens[:, i] = tok
            if i + 1 == max_new or (cfg.stop_early and bool(done.all())):
                break  # the next step's logits would go unused
            logits, cache = dec.step(tok[:, None], pos, cache, cross)
            pos += 1
        return tokens, score

    return run


def build_beam_decoder(
    dec: TSDecoder, cfg: DecodeConfig = DecodeConfig(), device="cuda"
):
    """Beam size 1 is the greedy decoder; wider beams are ROADMAP A9."""
    if cfg.beam_size == 1:
        return build_greedy_decoder(dec, cfg, device)
    raise NotImplementedError("beam search (beam_size > 1) is ROADMAP A9")


def strip_eot(tokens, eot: int) -> List[List[int]]:
    """Host-side: cut each row at the first eot."""
    out = []
    for row in tokens:
        row = [int(t) for t in row]
        if eot in row:
            row = row[: row.index(eot)]
        out.append(row)
    return out
