"""Joint CTC/attention beam search with encoder-relative length bounds.

Mirrors the JAX package's ``decode/joint.py`` (ESPnet ``beam_search``
parity options):

- the combined score is ``(1-w)·att_cum + w·ctc_prefix_cum`` per
  hypothesis, the CTC term by prefix scoring (``decode/ctc_prefix.py``) and
  eot's CTC score the full-labelling probability;
- partial scoring: CTC scores only the ``cfg.pre_beam`` candidates the
  attention posterior ranks highest per hypothesis, plus one canonical eot
  slot (an eot the top-k picked elsewhere becomes a dead slot);
- per-utterance length bounds from ``mem_lens`` (else the encoder window):
  eot is masked below ``minlen_i`` and forced at ``maxlen_i``.

The attention decoder is the dense path (dense cross K/V expanded across
beams, no quantization), prefilled once per utterance and tiled across the
beams; its self cache takes the decoder's own layout (the flat one where
the dims allow it, read by the self-cache kernel on the card) and is
reordered by ``index_select`` each step, as the JAX package reorders it
with ``jnp.take``. The (b, T, V) CTC log-softmax is never materialised:
one logsumexp per frame, candidate columns gathered per step. The loop
runs the JAX decoder's fixed step count (the selection continues once
every beam is done, as the scan does, but the decoder step is skipped
then), so the backtrace and the tie-breaks are the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .._device import resolve_device
from ..models.ts_decoder import TSDecoder
from .ctc_prefix import NEG_INF, eos_score, score_candidate_columns
from .search import DecodeConfig, length_bounds_static, top_k_stable


def ctc_logits(ctc_lo: Tuple[torch.Tensor, torch.Tensor], memory: torch.Tensor) -> torch.Tensor:
    """The CTC head ``memory @ W^T + b`` in f32, ``ctc_lo`` its (weight
    (V, n_state), bias (V,)) as stored (the JAX head multiplies the f32
    memory by the stored kernel, so a bf16 head is widened, not the
    memory narrowed)."""
    w, b = ctc_lo
    return torch.nn.functional.linear(memory.float(), w.float(), b.float())


def build_joint_beam_decoder(
    dec: TSDecoder,
    ctc_lo: Tuple[torch.Tensor, torch.Tensor],
    cfg: DecodeConfig,
    prompt_frames: int = 0,
    device="cuda",
) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """Returns ``run(memory, spk_prompt, mem_lens=None) -> (tokens,
    scores)``: tokens (batch, steps) int32 eot-padded, scores (batch,) the
    best hypothesis's combined score. ``ctc_lo`` is the CTC head's (weight,
    bias), applied to the prompt-stripped frames ``memory[:,
    prompt_frames:]``. ``mem_lens`` counts the prompt frames too, like the
    encoder's own lengths. Moves ``dec`` and the head to ``device``."""
    k = cfg.beam_size
    w = cfg.ctc_decode_weight
    if not 0.0 <= w < 1.0:
        raise ValueError(f"ctc_decode_weight must be in [0, 1), got {w}")
    c_cand = max(cfg.pre_beam, k + 1)  # a top-k plus the eot slot
    blank, eot = 0, cfg.eot
    dev = resolve_device(device)
    dec.check_self_cache()
    dec.to(dev).eval()
    ctc_lo = tuple(t.to(dev) for t in ctc_lo)

    @torch.inference_mode()
    def run(memory: torch.Tensor, spk_prompt: torch.Tensor,
            mem_lens: Optional[torch.Tensor] = None):
        memory, spk_prompt = memory.to(dev), spk_prompt.to(dev)
        b = memory.shape[0]
        n = b * k
        enc_t = memory.shape[1] - prompt_frames
        maxlen_static, _ = length_bounds_static(cfg, enc_t)
        i32 = dict(dtype=torch.int32, device=dev)
        if mem_lens is None:
            ctc_lens = torch.full((b,), enc_t, **i32)
        else:
            ctc_lens = torch.clamp(mem_lens.to(dev) - prompt_frames, 1, enc_t).to(torch.int32)
        if cfg.maxlenratio > 0:  # at least 1, like ESPnet's max(1, ratio * len)
            maxlen_i = torch.clamp(
                (cfg.maxlenratio * ctc_lens.float()).to(torch.int32), min=1, max=maxlen_static)
        else:
            maxlen_i = torch.full((b,), maxlen_static, **i32)
        if cfg.minlenratio > 0:
            minlen_i = (cfg.minlenratio * ctc_lens.float()).to(torch.int32)
        else:
            minlen_i = torch.full((b,), cfg.min_new_tokens, **i32)

        # CTC posteriors: logits, the per-frame logsumexp and the blank
        # column; frames beyond each utterance are a sure blank
        logits_ctc = ctc_logits(ctc_lo, memory[:, prompt_frames:])  # (b, T, V)
        lse = torch.logsumexp(logits_ctc, dim=-1)  # (b, T)
        pad = torch.arange(enc_t, device=dev)[None, :] >= ctc_lens[:, None]
        x_blank_b = torch.where(pad, 0.0, logits_ctc[..., blank] - lse)
        r_b0 = torch.cumsum(x_blank_b, dim=1)
        state = torch.stack([torch.full_like(r_b0, NEG_INF), r_b0], dim=-1)
        state = state.repeat_interleave(k, dim=0)  # (N, T, 2)

        # the attention decoder: prefill at batch rows, tiled across beams
        prompt_len = 1 + spk_prompt.shape[1] if dec.use_spk_prompt else 0
        base = prompt_len + len(cfg.init_tokens)
        cross = dec.cross_kv(memory)
        cache = dec.init_cache(b, base + maxlen_static)
        init = torch.tensor(cfg.init_tokens, dtype=torch.int64, device=dev)
        logits, cache = dec.prefill(init[None, :].expand(b, -1), spk_prompt, cache, cross)
        cross = tuple(x.repeat_interleave(k, dim=1) for x in cross)
        cache = tuple(x.repeat_interleave(k, dim=1) for x in cache)
        logits = logits.repeat_interleave(k, dim=0)  # (N, vocab)

        f32 = dict(dtype=torch.float32, device=dev)
        att_cum = torch.full((b, k), NEG_INF, **f32)
        att_cum[:, 0] = 0.0  # beam 0 live
        ctc_cum = torch.zeros((b, k), **f32)  # psi(empty) = 0
        last = torch.full((n,), -1, **i32)
        done = torch.zeros((b, k), dtype=torch.bool, device=dev)
        lengths = torch.zeros((b, k), **i32)
        utt = torch.arange(b, device=dev).repeat_interleave(k)
        slot_eot = torch.zeros((1, c_cand), dtype=torch.bool, device=dev)
        slot_eot[0, -1] = True
        row0 = torch.arange(b, device=dev)[:, None] * k
        pos = torch.tensor(base, **i32)
        toks, backptrs = [], []
        stepping = True

        for i in range(maxlen_static):
            att_logp = torch.log_softmax(logits, dim=-1)  # (N, vocab)
            below_min = (i < minlen_i).repeat_interleave(k)  # (N,)
            att_logp[:, eot] += torch.where(below_min, NEG_INF, 0.0)

            # candidates by the attention posterior; the last slot is the
            # one canonical eot, any other eot slot is dead
            cand_logp, cands = top_k_stable(att_logp, c_cand)  # (N, C)
            dead = cands == eot
            dead[:, -1] = False
            cands[:, -1] = eot
            cand_logp[:, -1] = att_logp[:, eot]

            # CTC prefix scores of the candidates, columns gathered per utt
            cands_b = cands.reshape(b, k * c_cand)
            cols = torch.gather(logits_ctc, 2, cands_b[:, None, :].expand(-1, enc_t, -1))
            cols = torch.where(pad[..., None], NEG_INF, cols - lse[..., None])
            x_c = cols.reshape(b, enc_t, k, c_cand).transpose(1, 2).reshape(n, enc_t, c_cand)
            psi, new_states = score_candidate_columns(
                state, x_c, x_blank_b[utt], cands == last[:, None], last < 0)
            psi = torch.where(slot_eot, eos_score(state)[:, None], psi)

            # combined scores; a finished beam keeps only its eot slot at
            # its frozen score; past maxlen everything must end
            att_flat, ctc_flat = att_cum.reshape(-1)[:, None], ctc_cum.reshape(-1)[:, None]
            att_new = att_flat + cand_logp
            comb = (1.0 - w) * att_new + w * psi
            comb = torch.where(dead, NEG_INF, comb)
            frozen = (1.0 - w) * att_flat + w * ctc_flat
            done_n = done.reshape(-1)[:, None]
            comb = torch.where(done_n, torch.where(slot_eot, frozen, NEG_INF), comb)
            att_new = torch.where(done_n, att_flat, att_new)
            psi = torch.where(done_n, ctc_flat, psi)
            over_n = (i >= maxlen_i).repeat_interleave(k)[:, None]
            comb = torch.where(over_n & ~slot_eot & ~done_n, NEG_INF, comb)

            # top-k over each utterance's k*C pool
            _, top_idx = top_k_stable(comb.reshape(b, k * c_cand), k)
            src_beam = top_idx // c_cand
            flat_src = (row0 + src_beam).reshape(-1)
            flat_pick = flat_src * c_cand + (top_idx % c_cand).reshape(-1)
            tok = cands.reshape(-1)[flat_pick].reshape(b, k).to(torch.int32)
            att_cum = att_new.reshape(-1)[flat_pick].reshape(b, k)
            ctc_cum = psi.reshape(-1)[flat_pick].reshape(b, k)
            state2 = new_states.reshape(-1, enc_t, 2)[flat_pick]
            # finished lineages keep their final forward variables
            done_prev = done.gather(1, src_beam)
            dp = done_prev.reshape(-1)
            state = torch.where(dp[:, None, None], state[flat_src], state2)
            last = torch.where(dp, last[flat_src], tok.reshape(-1))
            done = done_prev | (tok == eot)
            lengths = lengths.gather(1, src_beam) + (~done_prev).to(torch.int32)
            toks.append(tok)
            backptrs.append(src_beam)
            # once every beam is done the later steps only carry the frozen
            # scores (the logits go unused), so the decoder stops stepping
            if stepping and i + 1 < maxlen_static and not bool(done.all()):
                cache = tuple(x.index_select(1, flat_src) for x in cache)
                logits, cache = dec.step(tok.reshape(-1, 1), pos, cache, cross)
                pos += 1
            else:
                stepping = False

        final = (1.0 - w) * att_cum + w * ctc_cum
        if cfg.length_penalty > 0.0:
            norm = final / torch.clamp(lengths, min=1).float() ** cfg.length_penalty
        else:
            norm = final
        best = norm.argmax(dim=-1, keepdim=True)  # (b, 1)
        best_scores = final.gather(1, best)[:, 0]
        out = torch.empty((b, maxlen_static), **i32)
        beam = best
        for t in range(maxlen_static - 1, -1, -1):  # backtrace the lineage
            out[:, t] = toks[t].gather(1, beam)[:, 0]
            beam = backptrs[t].gather(1, beam)
        return out, best_scores

    return run
