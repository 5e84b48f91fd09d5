"""Batched KV-cache greedy and beam search for TS-Whisper decode.

Mirrors the JAX package's ``decode/search.py``: the speaker-prompt prefix
is prefilled once, then one token per step runs over the preallocated self
cache (updated in place) and the cross K/V, quantized for the token loop
when ``quantize_cross_kv`` is set. Greedy takes the decoder's own cache
layout (``TextDecoder.init_cache(layout=None)``: time-minor when asked for
and eligible, else flat, else 5-D; dense or int8). On CUDA over the flat
or time-minor cache (``step_graph.graph_step_applies``) greedy replays
each token step as one CUDA graph (``decode/step_graph.py``), kept for the
batch shape; sampling runs eagerly. With ``stop_early`` greedy ends at
the first step whose stop flag, copied to the host without blocking
(``StopFlags``), says every row emitted eot: the host runs ahead of the
device by at most ``RUN_AHEAD`` steps and waits only there. Beam search
stops at once, on one device-to-host read per token.
``speculative_gamma > 0`` hands greedy decode to
``decode/speculative.py``.

Beam search flattens (batch, beam) into the row axis, row ``i * k + j``
for utterance ``i`` and beam ``j``, over the flat cache where the dims
allow it and the 5-D one otherwise (never the time-minor one). Each step
reorders the self cache by the backpointers with the reorder kernels
(``ops/beam_gather.py``; the cache length is padded so every leaf's row
payload tiles the kernels' chunks, as the JAX package pads it) or, where
that padding would be long (the 5-D int8 cache's f32 scales) and
``beam_reorder`` is ``auto``, with ``index_select``. With
``defer_reorder`` (dense flat cache only) it reads the settled prefix
through a per-row indirection and flushes the accumulated permutation
every R steps. The quantized cross K/V stays at batch rows and the grouped
cross kernel reads it once for all beams of an utterance. Scoring is the
JAX package's: summed log-probs, finished beams frozen on eot at zero
cost, ties in the top-k broken towards the lower flat index as
``jax.lax.top_k`` does.

With ``with_timestamps`` the greedy loop masks each step's logits by
the Whisper timestamp rules (``decode/timestamps.py``), as the JAX greedy
decoder does; beam search and speculative decode refuse it. Joint
CTC/attention decode is ``decode/joint.py`` (``build_decode_fns`` routes
``ctc_decode_weight > 0`` there); these builders refuse it rather than
decode attention-only. ``quantize_weights`` quantizes the decoder's step
weights once, when the decoder is built (``_step_weights``), and every
token step (greedy, beam eager and deferred) runs them W8A8; the prefill
stays dense.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Callable, Deque, List, Tuple

import torch

from .._device import resolve_device
from ..models.ts_decoder import TSDecoder, quantize_step_weights
from ..ops.beam_gather import CHUNK, beam_reorder_cache
from ..utils.profiling import annotate
from .step_graph import StepGraphs, graph_step_applies
from .timestamps import apply_timestamp_rules, update_timestamp_state

NEG = -1e30  # score of a dead beam and of a masked token
RUN_AHEAD = 4  # greedy steps the host may issue past the oldest stop flag it has not read


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


def _check_config(dec: TSDecoder, cfg: DecodeConfig) -> None:
    """Raise for the paths outside this port, before anything runs."""
    dec.check_self_cache()
    if cfg.ctc_decode_weight > 0:
        raise ValueError(
            "ctc_decode_weight > 0 decodes through decode/joint.py "
            "(build_decode_fns with the CTC head), not the attention-only decoders"
        )
    if cfg.with_timestamps and cfg.timestamp_begin >= dec.dims.n_vocab:
        raise ValueError(
            "timestamp decoding needs the timestamp tokens (from id "
            f"{cfg.timestamp_begin}) in the vocabulary of {dec.dims.n_vocab}"
        )
    if cfg.prefill_quantized and not cfg.quantize_cross_kv:
        raise ValueError(
            "prefill_quantized requires quantize_cross_kv=True: the option "
            "prefills on the quantized cross K/V"
        )


def _step_weights(dec: TSDecoder, cfg: DecodeConfig):
    """The int8 step weights of ``dec`` (already on its device), quantized
    once at build time, or None without ``quantize_weights``."""
    return quantize_step_weights(dec) if cfg.quantize_weights else None


def build_greedy_decoder(
    dec: TSDecoder,
    cfg: DecodeConfig = DecodeConfig(),
    device="cuda",
) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Returns ``run(memory, spk_prompt) -> (tokens, scores)``.

    tokens: (batch, max_new) int32, eot-padded after stop; scores: (batch,)
    summed log-probs of the emitted tokens (up to eot). Moves ``dec`` to
    ``device``. ``speculative_gamma > 0`` returns the speculative decoder
    (the same contract)."""
    if cfg.speculative_gamma > 0:
        from .speculative import build_speculative_decoder

        return build_speculative_decoder(dec, cfg, device)
    dev = resolve_device(device)
    _check_config(dec, cfg)
    dec.to(dev).eval()
    qw = _step_weights(dec, cfg)
    graphs = StepGraphs()
    stop = StopFlags(dev)

    @torch.inference_mode()
    def run(memory: torch.Tensor, spk_prompt: torch.Tensor):
        memory, spk_prompt = memory.to(dev), spk_prompt.to(dev)
        b = memory.shape[0]
        prompt_len = 1 + spk_prompt.shape[1] if dec.use_spk_prompt else 0
        max_new, min_new = length_bounds(
            cfg, memory, spk_prompt, dec.use_spk_prompt
        )
        base = prompt_len + len(cfg.init_tokens)
        total = base + max_new
        graph = None
        if graph_step_applies(dec, dev, dec.decoder.default_layout,
                              with_timestamps=cfg.with_timestamps):
            graph = graphs.get((b, total, memory.shape[1]))

        # prefill on the dense cross K/V (exact, runs once) and quantize
        # after for the token loop, unless prefill_quantized
        pq = cfg.prefill_quantized
        with annotate("rsq:decode.prefill"):
            # the graph's cross K/V is written in place where the prefill's
            # is the loop's
            direct = graph is not None and (pq or not cfg.quantize_cross_kv)
            cross = dec.cross_kv(memory, quantize=pq, out=graph.cross if direct else None)
            if graph is None:
                pos = torch.tensor(base, dtype=torch.int32, device=dev)
                cache = dec.init_cache(b, total)
            else:
                pos, cache = graph.start(dec, b, total, base)
            init = torch.tensor(cfg.init_tokens, dtype=torch.int64, device=dev)
            init = init[None, :].expand(b, -1)
            logits, cache = dec.prefill(init, spk_prompt, cache, cross)
            if cfg.quantize_cross_kv and not pq:
                cross = dec.quantize_cross(cross)
            if graph is not None:
                cross = graph.keep_cross(cross)

        done = torch.zeros(b, dtype=torch.bool, device=dev)
        score = torch.zeros(b, dtype=torch.float32, device=dev)
        tokens = torch.full((b, max_new), cfg.eot, dtype=torch.int32, device=dev)
        if cfg.with_timestamps:  # last token, the one before, largest timestamp
            ts_state = (torch.full((b,), -1, dtype=torch.int64, device=dev),
                        torch.full((b,), -1, dtype=torch.int64, device=dev),
                        torch.full((b,), cfg.timestamp_begin, dtype=torch.int64, device=dev))
        stop.reset()
        for i in range(max_new):
            with annotate("rsq:decode.step"):
                if i < min_new:
                    logits[:, cfg.eot] = -1e30
                if cfg.with_timestamps:
                    logits = apply_timestamp_rules(
                        logits.float(), *ts_state, cfg.timestamp_begin, cfg.eot,
                        cfg.max_initial_timestamp_index,
                    )
                logp = torch.log_softmax(logits, dim=-1)
                tok = torch.argmax(logp, dim=-1)
                tok = torch.where(done, cfg.eot, tok)
                tok_logp = logp.gather(1, tok[:, None])[:, 0]
                score = score + torch.where(done, 0.0, tok_logp)
                done = done | (tok == cfg.eot)
                tokens[:, i] = tok
                if cfg.with_timestamps:
                    ts_state = update_timestamp_state(
                        tok, ts_state[0], ts_state[2], cfg.timestamp_begin
                    )
                if i + 1 == max_new:
                    break  # the next step's logits would go unused
                with annotate("rsq:decode.stop_check"):
                    if cfg.stop_early and stop.push(done):
                        break
                logits, cache = dec.step(tok[:, None], pos, cache, cross, qw=qw, graph=graph)
                pos += 1
        return tokens, score

    return run


class _Settled:
    """A stop flag's event on the CPU, where the flag's copy is done when it
    returns."""

    def record(self) -> None:
        pass

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        pass


class StopFlags:
    """The greedy loop's stop check without a host wait. ``push(done)``
    copies ``done.all()`` without blocking into a pinned host flag and
    records an event behind it, then reads the flags whose events have
    completed (``query``, oldest first) and returns True at the first that
    says every row is done. Only once the host has issued ``RUN_AHEAD``
    steps past the oldest flag it has not read does it wait, on that flag's
    event. A batch whose rows are all done thus runs at most ``RUN_AHEAD``
    more steps; done rows emit eot and add 0 to the score, so the tokens and
    scores are those of a loop that stops at once."""

    def __init__(self, dev: torch.device):
        cuda = dev.type == "cuda"
        n = RUN_AHEAD + 1  # a flag for each step that may be in flight
        self.flags = torch.zeros(n, dtype=torch.bool, pin_memory=cuda)
        self.events = [torch.cuda.Event() if cuda else _Settled() for _ in range(n)]
        self.pending: Deque[int] = collections.deque()
        self.pushed = 0

    def reset(self) -> None:
        self.pending.clear()
        self.pushed = 0

    def push(self, done: torch.Tensor) -> bool:
        slot = self.pushed % len(self.flags)
        self.pushed += 1
        self.flags[slot].copy_(done.all(), non_blocking=True)
        self.events[slot].record()
        self.pending.append(slot)
        while self.pending:
            oldest = self.pending[0]
            if len(self.pending) > RUN_AHEAD:
                self.events[oldest].synchronize()
            elif not self.events[oldest].query():
                return False
            self.pending.popleft()
            if self.flags[oldest]:
                return True
        return False


def top_k_stable(x: torch.Tensor, k: int):
    """The k largest entries of each row of ``x``, ties in the order of the
    lower index first, as ``jax.lax.top_k`` breaks them (``torch.topk``
    promises no order among equal values). Returns (values, indices)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def build_beam_decoder(
    dec: TSDecoder, cfg: DecodeConfig = DecodeConfig(), device="cuda"
) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Returns ``run(memory, spk_prompt) -> (tokens, scores)`` for
    ``cfg.beam_size`` beams: the best hypothesis of each utterance, tokens
    (batch, max_new) int32 eot-padded, scores (batch,) its summed
    log-probs. Beam size 1 is the greedy decoder; ``speculative_gamma >
    0`` goes there too, and the speculative decoder refuses beams. Moves
    ``dec`` to ``device``."""
    k = cfg.beam_size
    if k == 1 or cfg.speculative_gamma > 0:
        return build_greedy_decoder(dec, cfg, device)
    if cfg.with_timestamps:
        raise ValueError(
            "timestamp decoding is greedy-only (beam_size 1): the timestamp "
            "rules are not threaded through the beam carry"
        )
    dev = resolve_device(device)
    if cfg.beam_reorder not in ("auto", "dma", "take"):
        raise ValueError(f"unknown beam_reorder {cfg.beam_reorder!r}")
    # the flush period rounds up to whole 8-position reorder chunks
    R = -(-cfg.defer_reorder // CHUNK) * CHUNK if cfg.defer_reorder > 0 else 0
    td = dec.decoder
    hd = td.dims.n_text_state // td.dims.n_text_head
    if R and not (
        td.self_kv_bits == 16 and td.flat_self_cache
        and td.dims.n_text_state % 128 == 0 and 128 % hd == 0
    ):
        raise ValueError(
            "defer_reorder needs the dense flat self cache, which this decoder "
            f"does not have (self_kv_bits {td.self_kv_bits}, flat_self_cache "
            f"{td.flat_self_cache}, n_state {td.dims.n_text_state} must tile "
            "128 lanes)"
        )
    _check_config(dec, cfg)
    dec.to(dev).eval()
    vocab = dec.dims.n_vocab
    qw = _step_weights(dec, cfg)

    @torch.inference_mode()
    def run(memory: torch.Tensor, spk_prompt: torch.Tensor):
        memory, spk_prompt = memory.to(dev), spk_prompt.to(dev)
        b = memory.shape[0]
        prompt_len = 1 + spk_prompt.shape[1] if dec.use_spk_prompt else 0
        max_new, min_new = length_bounds(
            cfg, memory, spk_prompt, dec.use_spk_prompt
        )
        base = prompt_len + len(cfg.init_tokens)
        total = base + max_new
        # The reorder kernels need each leaf's row payload in whole chunks
        # of 32 x 128 elements: pad the cache length to ``required``, as
        # the JAX package does, where that takes at most 64 positions; else
        # "auto" takes index_select (the 5-D int8 cache's f32 scales)
        per_pos = [
            math.prod(x.shape[3:])
            for x in dec.init_cache(1, 1, layout="flat")
        ]
        required = 1
        for pp in per_pos:
            required = math.lcm(required, 4096 // math.gcd(pp, 4096))
        use_kernel = cfg.beam_reorder == "dma" or (
            cfg.beam_reorder == "auto" and required <= 64
        )
        if R:  # the window [s0, s0 + R) always fits the cache
            mlt = math.lcm(required, CHUNK)
            total = -(-(total + R) // mlt) * mlt
        elif use_kernel:
            total = -(-total // required) * required

        # prefill at plain batch rows: every beam starts from the same prefix
        pq = cfg.prefill_quantized
        with annotate("rsq:decode.prefill"):
            cross = dec.cross_kv(memory, quantize=pq)
            cache = dec.init_cache(b, total, layout="flat")
            init = torch.tensor(cfg.init_tokens, dtype=torch.int64, device=dev)
            logits, cache = dec.prefill(init[None, :].expand(b, -1), spk_prompt, cache, cross)
            if cfg.quantize_cross_kv:
                # stays at batch rows: the grouped kernel shares it across beams
                if not pq:
                    cross = dec.quantize_cross(cross)
                group = k
            else:  # dense cross K/V is expanded across beams (stacked axis 1)
                cross = tuple(x.repeat_interleave(k, dim=1) for x in cross)
                group = 1
        cache = tuple(x.repeat_interleave(k, dim=1) for x in cache)
        logits = logits.repeat_interleave(k, dim=0)  # (b*k, vocab)
        t_pad = cache[0].shape[2]

        f32 = dict(dtype=torch.float32, device=dev)
        # beam 0 live, the others dead, so step 0 picks k distinct tokens
        scores = torch.full((b, k), NEG, **f32)
        scores[:, 0] = 0.0
        done = torch.zeros((b, k), dtype=torch.bool, device=dev)
        lengths = torch.zeros((b, k), dtype=torch.int32, device=dev)
        eot_only = torch.full((vocab,), NEG, **f32)
        eot_only[cfg.eot] = 0.0
        row0 = torch.arange(b, device=dev)[:, None] * k
        identity = torch.arange(b * k, device=dev)
        toks = torch.full((max_new, b, k), cfg.eot, dtype=torch.int32, device=dev)
        backptr = torch.arange(k, device=dev).expand(max_new, b, k).clone()
        pos = torch.tensor(base, dtype=torch.int32, device=dev)
        # deferred reorder: [0, s0) stays in last-flush row order and is
        # read through anc; s0 starts at the chunk boundary at or below the
        # prefix end (the prefix is the same in every beam)
        s0 = base - base % CHUNK
        s0_dev = torch.tensor(s0, dtype=torch.int32, device=dev)
        anc = identity

        for i in range(max_new):
            with annotate("rsq:decode.step"):
                with annotate("rsq:decode.beam_select"):
                    if i < min_new:
                        logits[:, cfg.eot] = NEG
                    logp = torch.log_softmax(logits, dim=-1).reshape(b, k, vocab)
                    logp = torch.where(done[..., None], eot_only, logp)
                    cand = (scores[..., None] + logp).reshape(b, k * vocab)
                    scores, top_idx = top_k_stable(cand, k)
                    src_beam = top_idx // vocab
                    tok = (top_idx % vocab).to(torch.int32)
                    toks[i] = tok
                    backptr[i] = src_beam
                    done_prev = done.gather(1, src_beam)
                    done = done_prev | (tok == cfg.eot)
                    # lengths follow the beam lineage
                    lengths = lengths.gather(1, src_beam) + (~done_prev).to(torch.int32)
                if i + 1 == max_new:
                    break  # the next step's logits would go unused
                with annotate("rsq:decode.stop_check"):
                    stop = cfg.stop_early and bool(done.all())
                if stop:
                    break

                step_kw = {}
                with annotate("rsq:decode.beam_reorder"):
                    gather_idx = (row0 + src_beam).reshape(-1)
                    if R:
                        anc = anc.index_select(0, gather_idx)  # compose permutations
                        for x in cache:  # the window holds logical rows
                            x[:, :, s0:s0 + R] = x[:, :, s0:s0 + R].index_select(1, gather_idx)
                        if base + i - s0 >= R:  # flush the settled permutation
                            if s0 > 0:  # the kernel's live chunks stop at s0
                                beam_reorder_cache(cache, anc, live=s0, time_len=t_pad)
                            anc = identity
                            s0 += R
                            s0_dev += R
                        step_kw = dict(row_map=anc, settled=s0_dev, defer_window=R)
                    elif not use_kernel:  # the JAX package's XLA gather
                        cache = tuple(x.index_select(1, gather_idx) for x in cache)
                    else:  # positions [0, base + i) hold data
                        cache = beam_reorder_cache(cache, gather_idx, live=base + i, time_len=t_pad)
                logits, cache = dec.step(
                    tok.reshape(-1, 1), pos, cache, cross, beam_group=group, qw=qw,
                    **step_kw,
                )
                pos += 1

        if cfg.length_penalty > 0.0:
            norm = scores / lengths.float() ** cfg.length_penalty
        else:
            norm = scores
        best = norm.argmax(dim=-1, keepdim=True)  # (b, 1)
        best_scores = scores.gather(1, best)[:, 0]
        out = torch.empty((b, max_new), dtype=torch.int32, device=dev)
        beam = best
        for t in range(max_new - 1, -1, -1):  # backtrace the lineage
            out[:, t] = toks[t].gather(1, beam)[:, 0]
            beam = backptr[t].gather(1, beam)
        return out, best_scores

    return run


def strip_eot(tokens, eot: int) -> List[List[int]]:
    """Host-side: cut each row at the first eot."""
    out = []
    for row in tokens:
        row = [int(t) for t in row]
        if eot in row:
            row = row[: row.index(eot)]
        out.append(row)
    return out
