"""Speculative greedy decode: a draft proposes, one multi-token step verifies.

Mirrors the JAX package's ``decode/speculative.py``. Each round:

1. **Draft**: a decoder of ``draft_layers`` blocks proposes ``gamma``
   greedy tokens one at a time. The self-draft is the target's own first
   blocks with the shared embedding, final LayerNorm and tied head
   (``draft_decoder``); its cross K/V and prefix cache are the target's,
   sliced to its depth. A separate draft (``draft=``, e.g. a converted JAX
   draft, ``convert.load_flax``) computes its own cross K/V, prefill and
   cache, and takes one more step a round so its cache covers the bonus
   position.
2. **Verify**: the full decoder runs one causal chunk over the ``gamma +
   1`` tokens [pending, d_1 .. d_gamma] (``TextDecoder.step`` with M > 1 at
   per-row positions on the 5-D cache) and re-decodes each position.
3. **Accept** the longest draft prefix that matches the target's own
   choices plus the target's next token; each row advances on its own.

The output is the target's greedy transcript, token for token: every
emitted token is an argmax of full-model logits. With ``quantize_weights``
the target's steps run its W8A8 step weights, and the draft's steps the
first ``draft_layers`` layers of them (the self-draft, sharing the
embedding's) or its own (a separate draft). The rounds run eagerly;
the loop reads ``done.all()`` once a round, the only value it takes back
to the host (positions, counts and acceptances stay on the device).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .._device import resolve_device
from ..models.ts_decoder import TSDecoder, quantize_step_weights
from .search import DecodeConfig, _check_config, _step_weights

NEG = -1e30  # the masked logit


def draft_decoder(
    dec: TSDecoder, draft_layers: int, source: Optional[TSDecoder] = None
) -> TSDecoder:
    """A ``draft_layers``-block TSDecoder over the 5-D cache (the cache
    form speculative steps need), with the target's flags, sharing the
    parameters of ``source``: the target itself (the self-draft, its first
    blocks; the JAX ``draft_variables``) or a separate draft of that depth.
    Nothing is copied."""
    src = (dec if source is None else source).decoder
    td = dec.decoder
    if source is not None and len(src.blocks) != draft_layers:
        raise ValueError(
            f"the draft has {len(src.blocks)} blocks, draft_layers is {draft_layers}"
        )
    if src.cross_kv_bits != td.cross_kv_bits:
        raise ValueError(
            f"the draft quantizes its cross K/V to {src.cross_kv_bits} bits, the "
            f"target to {td.cross_kv_bits}: build both alike"
        )
    with torch.device("meta"):
        draft = TSDecoder(
            dec.dims.replace(n_text_layer=draft_layers),
            startofprev_token=dec.startofprev_token,
            use_spk_prompt=dec.use_spk_prompt, cross_kv_bits=td.cross_kv_bits,
            self_kv_bits=td.self_kv_bits, flat_self_cache=False,
        )
    d = draft.decoder
    d.token_embedding, d.ln = src.token_embedding, src.ln
    d.positional_embedding = src.positional_embedding
    d.blocks = nn.ModuleList(list(src.blocks)[:draft_layers])
    d.register_buffer("layer_ids", src.layer_ids[:draft_layers].clone(), persistent=False)
    return draft


def build_speculative_decoder(
    dec: TSDecoder,
    cfg: DecodeConfig,
    device="cuda",
    return_stats: bool = False,
    draft: Optional[TSDecoder] = None,
) -> Callable:
    """Returns ``run(memory, spk_prompt) -> (tokens, scores)``, the greedy
    decoder's contract: (batch, max_new_tokens) int32 eot-padded tokens and
    per-row summed log-probs. ``draft=None`` self-drafts with the target's
    first ``cfg.draft_layers`` blocks; a TSDecoder of that many blocks is a
    separate draft. With ``return_stats`` a third element holds per-row
    int32 counters: ``chunks`` (rounds run while the row was live),
    ``accepted`` (matched draft tokens) and ``emitted`` (tokens after the
    prefill's). Needs ``beam_size == 1``, no timestamps,
    ``speculative_gamma >= 1``, ``1 <= draft_layers <=
    n_text_layer`` and a decoder whose cache is 5-D (``flat_self_cache=
    False``). Moves both decoders to ``device``."""
    g, d = int(cfg.speculative_gamma), int(cfg.draft_layers)
    n_layers = dec.dims.n_text_layer
    if cfg.beam_size != 1:
        raise ValueError(
            "speculative decode is greedy-only: beam_size must be 1 when "
            "speculative_gamma > 0"
        )
    if cfg.with_timestamps:
        raise ValueError(
            "timestamp decoding is plain-greedy only (the draft/verify "
            "chunks don't apply the timestamp rules)"
        )
    if g < 1:
        raise ValueError(f"speculative_gamma must be >= 1, got {g}")
    if not 1 <= d <= n_layers:
        raise ValueError(f"draft_layers must be in [1, {n_layers}], got {d}")
    if dec.decoder._flat_self:
        raise ValueError(
            "speculative decode needs per-row ragged cache writes: build "
            "the TSDecoder with flat_self_cache=False"
        )
    _check_config(dec, cfg)
    dev = resolve_device(device)
    dec.to(dev).eval()
    separate = draft is not None
    if separate:
        draft.to(dev).eval()
    dmod = draft_decoder(dec, d, draft)
    qw = dqw = _step_weights(dec, cfg)
    if qw is not None:  # a separate draft's own, or the target's first d layers
        dqw = (quantize_step_weights(dmod) if separate
               else {"layers": qw["layers"][:d], "emb": qw["emb"]})
    max_new, min_new, eot = cfg.max_new_tokens, cfg.min_new_tokens, cfg.eot

    def mask_eot(logits: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        """eot masked on the raw logits where the emission index is below
        min_new_tokens (the greedy loop's convention)."""
        if min_new <= 0:
            return logits
        masked = logits.clone()
        masked[..., eot] = NEG
        return torch.where((index < min_new)[..., None], masked, logits)

    @torch.inference_mode()
    def run(memory: torch.Tensor, spk_prompt: torch.Tensor):
        memory, spk_prompt = memory.to(dev), spk_prompt.to(dev)
        b = memory.shape[0]
        prompt_len = 1 + spk_prompt.shape[1] if dec.use_spk_prompt else 0
        base = prompt_len + len(cfg.init_tokens)
        total = base + max_new + g + 1  # the last verify may write past the budget

        pq = cfg.prefill_quantized
        cross = dec.cross_kv(memory, quantize=pq)
        cache = dec.init_cache(b, total)
        init = torch.tensor(cfg.init_tokens, dtype=torch.int64, device=dev)
        init = init[None, :].expand(b, -1)
        logits, cache = dec.prefill(init, spk_prompt, cache, cross)
        if cfg.quantize_cross_kv and not pq:
            cross = dec.quantize_cross(cross)
        if separate:  # its own cross K/V and prefix cache
            dcross = dmod.cross_kv(memory, quantize=pq)
            dcache = dmod.init_cache(b, total)
            _, dcache = dmod.prefill(init, spk_prompt, dcache, dcross)
            if cfg.quantize_cross_kv and not pq:
                dcross = dmod.quantize_cross(dcross)
        else:  # the target's, to its depth (a copy, synced every round)
            dcross = tuple(x[:d] for x in cross)
            dcache = tuple(x[:d].clone() for x in cache)

        i32 = dict(dtype=torch.int32, device=dev)
        count = torch.ones(b, **i32)
        logp0 = torch.log_softmax(mask_eot(logits, count - 1), dim=-1)
        pending = logp0.argmax(dim=-1)  # (b,)
        score = logp0.gather(1, pending[:, None])[:, 0]
        done = pending == eot
        # one spare column takes the writes of tokens that are not emitted
        out = torch.full((b, max_new + 1), eot, **i32)
        out[:, 0] = pending
        pos = torch.full((b,), base, **i32)
        rows = torch.arange(b, device=dev)
        j = torch.arange(g + 1, device=dev)
        chunks = torch.zeros(b, **i32)
        accepted = torch.zeros(b, **i32)

        while not bool(done.all()):
            # draft: gamma greedy proposals (one more for a separate draft,
            # whose cache must cover the bonus position)
            tok, p, ei, drafts = pending, pos, count, []
            for _ in range(g + 1 if separate else g):
                lg, dcache = dmod.step(tok[:, None], p, dcache, dcross, qw=dqw)
                tok = mask_eot(lg, ei).argmax(dim=-1)
                drafts.append(tok)
                p, ei = p + 1, ei + 1
            drafts = torch.stack(drafts[:g], dim=1)  # (b, g)

            # verify: one causal chunk through the full decoder
            ver_in = torch.cat([pending[:, None], drafts], dim=1)
            vlogits, cache = dec.step(ver_in, pos, cache, cross, qw=qw)  # (b, g+1, V)
            vlogits = mask_eot(vlogits, count[:, None] + j)
            vlogp = torch.log_softmax(vlogits, dim=-1)
            t = vlogits.argmax(dim=-1)  # (b, g+1)

            # accept the longest matching prefix and the bonus token
            match = (drafts == t[:, :-1]).to(torch.int32)
            n_acc = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
            active = (~done).to(torch.int32)
            chunks += active
            accepted += active * n_acc
            cand = j[None, :] <= n_acc[:, None]
            is_eot = (t == eot) & cand
            eot_at = torch.where(is_eot, j[None, :], g + 1).amin(dim=1)
            n_emit = torch.minimum(n_acc + 1, eot_at + 1)
            n_emit = torch.minimum(n_emit, max_new - count)  # the token budget
            n_emit = torch.where(done, 0, n_emit).to(torch.int32)
            emit = j[None, :] < n_emit[:, None]
            col = torch.where(emit, count[:, None] + j, max_new)
            out.scatter_(1, col, t.to(torch.int32))
            tok_logp = vlogp.gather(-1, t[..., None])[..., 0]
            score = score + torch.where(emit, tok_logp, 0.0).sum(dim=1)
            count = count + n_emit
            done = done | (eot_at < n_emit) | (count >= max_new)
            last = torch.clamp(n_emit - 1, min=0).long()
            pending = torch.where(n_emit > 0, t.gather(1, last[:, None])[:, 0], pending)
            if not separate:
                # the verify chunk's first-d-layer entries into the draft
                # cache (the bonus position the draft never ran included)
                idx = pos.long()[:, None] + j
                for dl, tl in zip(dcache, cache):
                    dl[:, rows[:, None], idx] = tl[:d, rows[:, None], idx]
            pos = pos + n_emit

        tokens = out[:, :max_new]
        if return_stats:
            stats = {"chunks": chunks, "accepted": accepted, "emitted": count - 1}
            return tokens, score, stats
        return tokens, score

    return run
