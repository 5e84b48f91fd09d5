"""Whisper timestamp-token decoding rules and host-side segmentation.

Mirrors the JAX package's ``decode/timestamps.py`` (the semantics of
openai-whisper's ``ApplyTimestampRules``). With
``DecodeConfig.with_timestamps`` the greedy decoder drops
<|notimestamps|> from the init sequence and masks each step's logits:

1. timestamps come in pairs: after a lone timestamp (the token before it
   was text) the next token is a timestamp or eot; after a pair it is not
   a timestamp;
2. timestamps are monotonic: after a lone timestamp the next may repeat
   it, else it must be greater than the largest seen;
3. the first token is a timestamp no later than
   ``max_initial_index`` steps;
4. when the timestamp tokens together outweigh the best text token, text
   is masked (eot stays available).

The per-row state ``(last, penult, max_ts)`` rides along the decode loop;
``segments_from_tokens`` turns a decoded row into ``[(start_s, end_s,
text), ...]`` on the host, 0.02 s per timestamp step.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

NEG = -1e30
TIME_PRECISION = 0.02  # seconds per timestamp token step


def apply_timestamp_rules(
    logits: torch.Tensor,  # (rows, vocab) raw f32 logits
    last: torch.Tensor,  # (rows,) previous token, -1 before any
    penult: torch.Tensor,  # (rows,) the token before it, -1 if none
    max_ts: torch.Tensor,  # (rows,) largest timestamp seen (ts_begin at first)
    ts_begin: int,
    eot: int,
    max_initial_index: int = 50,
) -> torch.Tensor:
    """``logits`` masked by the timestamp rules (adds of NEG, in the JAX
    package's order, so the sums are its sums)."""
    vocab = logits.shape[-1]
    ids = torch.arange(vocab, device=logits.device)
    is_ts = (ids >= ts_begin)[None, :]  # (1, vocab)
    is_text = ((ids < ts_begin) & (ids != eot))[None, :]
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    neg = zero + NEG

    last_was_ts = last >= ts_begin
    penult_was_ts = (penult >= ts_begin) | (penult < 0)
    first = last < 0
    after_pair = (last_was_ts & penult_was_ts & ~first)[:, None]
    lone = (last_was_ts & ~penult_was_ts)[:, None]
    # 1. pairs
    mask = torch.where(after_pair & is_ts, neg, zero)
    mask = mask + torch.where(lone & is_text, neg, zero)
    # 2. monotonic: a lone timestamp may repeat, otherwise strictly greater
    bound = torch.where(first[:, None] | lone, max_ts[:, None], max_ts[:, None] + 1)
    mask = mask + torch.where(is_ts & (ids[None, :] < bound), neg, zero)
    # 3. the first token is a timestamp in the initial window
    first_bad = ~is_ts | (ids[None, :] > ts_begin + max_initial_index)
    mask = mask + torch.where(first[:, None] & first_bad, neg, zero)
    masked = logits + mask
    # 4. the timestamp mass against the best text token, on the masked
    # distribution
    logp = torch.log_softmax(masked, dim=-1)
    ts_mass = torch.logsumexp(torch.where(is_ts, logp, neg), dim=-1)
    best_text = torch.where(is_text, logp, neg).amax(dim=-1)
    force = (ts_mass > best_text)[:, None]
    return masked + torch.where(force & is_text, neg, zero)


def update_timestamp_state(
    tok: torch.Tensor, last: torch.Tensor, max_ts: torch.Tensor, ts_begin: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The new ``(last, penult, max_ts)`` after emitting ``tok``."""
    new_max = torch.where(tok >= ts_begin, torch.maximum(max_ts, tok), max_ts)
    return tok, last, new_max


def segments_from_tokens(
    row: List[int], tokenizer, ts_begin: int
) -> List[Tuple[float, float, str]]:
    """A timestamped token row (eot stripped) as ``(start_s, end_s, text)``
    segments. An unclosed trailing segment with text ends where it opened."""
    segments: List[Tuple[float, float, str]] = []
    start = None
    text_ids: List[int] = []
    for t in row:
        if t >= ts_begin:
            ts = (t - ts_begin) * TIME_PRECISION
            if start is None:
                start = ts
            elif text_ids:
                segments.append((start, ts, tokenizer.decode(text_ids).strip()))
                start = None
                text_ids = []
            else:  # consecutive timestamps: a new segment start
                start = ts
        elif start is not None:
            text_ids.append(t)
    if start is not None and text_ids:
        segments.append((start, start, tokenizer.decode(text_ids).strip()))
    return segments
