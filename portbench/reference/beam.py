"""Plain float32 beam search over the reference's decoder: the yardstick of
a beam cell's selection.

Every step recomputes the whole teacher-forced forward (``Ref.decode``) of
every beam's sequence so far, with no cache, and takes the last position's
logits. The selection rule is the one the configuration states:

- a hypothesis scores the sum of its tokens' log-probs, eot included;
- at step 0 only beam 0 is live (the others score -1e30), so the k beams
  start from k distinct tokens;
- a finished beam (one that emitted eot) extends only with eot, at no cost;
- the k best of the k x vocab candidates, by a stable sort: among equal
  scores the lower flat index (beam * vocab + token) first;
- the loop stops once every beam of every utterance has finished, or after
  ``max_new`` tokens; the best final beam (the first of equal scores) is
  the hypothesis.

It imports nothing of the program under test.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .model import Ref

NEG = -1e30


def rows_of(t: torch.Tensor, k: int) -> torch.Tensor:
    """(b, ...) -> (b * k, ...), row ``i * k + j`` a copy of row ``i``."""
    return t.repeat_interleave(k, dim=0)


@torch.no_grad()
def beam_search(ref: Ref, prompt: Optional[torch.Tensor], cross: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                init_tokens: Sequence[int], eot: int, k: int, max_new: int, stop_early: bool = True,
                record: Optional[List] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search of width ``k`` for b utterances.

    ``prompt``: the speaker prompt (b, n_q, width) or None; ``cross``: per
    decoder layer the cross attention's (k, v) heads (b, T, heads, head
    width), as ``Ref.quantized_cross`` gives them. Returns the best
    hypothesis of each utterance, tokens (b, max_new) eot-padded, and its
    score (b,). ``record``, a list, gets one entry a step: the logits the
    step selected from (b * k, vocab), and the source beam and the token of
    each kept candidate (b, k)."""
    b = cross[0][0].shape[0]
    dev = cross[0][0].device
    V = ref.P["decoder.decoder.token_embedding.weight"].shape[0]
    init = list(init_tokens)
    seq = torch.tensor([init] * (b * k), dtype=torch.long, device=dev)
    prompt_k = None if prompt is None else rows_of(prompt, k)
    cross_k = [(rows_of(kk, k), rows_of(vv, k)) for kk, vv in cross]
    scores = torch.full((b, k), NEG, device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros((b, k), dtype=torch.bool, device=dev)
    eot_only = torch.full((V,), NEG, device=dev)
    eot_only[eot] = 0.0
    for _ in range(max_new):
        x, _ = ref.embed_prefixed(seq, prompt_k)
        logits = ref.decode(x, cross=cross_k)[:, -1]
        logp = torch.log_softmax(logits, dim=-1).reshape(b, k, V)
        logp = torch.where(done[..., None], eot_only, logp)
        cand = (scores[..., None] + logp).reshape(b, k * V)
        values, idx = torch.sort(cand, dim=-1, descending=True, stable=True)
        scores, idx = values[:, :k], idx[:, :k]
        src, tok = idx // V, idx % V
        if record is not None:
            record.append((logits, src, tok))
        done = done.gather(1, src) | (tok == eot)
        kept = seq.reshape(b, k, -1).gather(1, src[..., None].expand(-1, -1, seq.shape[1]))
        seq = torch.cat([kept.reshape(b * k, -1), tok.reshape(-1, 1)], dim=1)
        if stop_early and bool(done.all()):
            break
    best = scores.argmax(dim=-1)
    gen = seq.reshape(b, k, -1)[torch.arange(b, device=dev), best, len(init):]
    tokens = torch.full((b, max_new), eot, dtype=torch.long, device=dev)
    tokens[:, : gen.shape[1]] = gen
    return tokens, scores.gather(1, best[:, None])[:, 0]
