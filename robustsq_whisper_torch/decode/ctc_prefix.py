"""Batched incremental CTC prefix scoring for joint CTC/attention decode.

Mirrors the JAX package's ``decode/ctc_prefix.py`` (ESPnet's
``CTCPrefixScoreTH`` semantics). Log domain, blank = 0. For a prefix ``g``
the state holds per frame ``t`` the forward log-probabilities ``r_nb[t]``
(paths whose collapsed labelling is exactly ``g`` and end in a non-blank)
and ``r_b[t]`` (same, ending in blank). Extending ``g`` by candidate ``c``::

    phi[t]      = r_b[t]  (+)  (c != last(g) ? r_nb[t] : -inf)
    r'_nb[t]    = (r'_nb[t-1] (+) phi[t-1]) + x[t, c]
    r'_b[t]     = (r'_b[t-1] (+) r'_nb[t-1]) + x[t, blank]
    psi(g+c)    = r'_nb[0] (+) ((+)_t phi[t-1] + x[t, c])

where ``(+)`` is logaddexp. ``psi`` is log p_ctc(the labelling begins
with g+c); the eos score of ``g`` is ``r_nb[T-1] (+) r_b[T-1]``. Frames at
or beyond an utterance's length are pre-masked to blank = 0 and the rest
to -inf, so the fixed-T recursion scores each utterance at its own length.

The recursion is a loop over frames of small element-wise ops (plain
PyTorch; it is plain XLA in the JAX package). ``ctc_prefix_score_np`` and
``ctc_label_prob_np`` are the slow numpy references the tests hold it to.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

NEG_INF = -1.0e30


def mask_ctc_logp(logp: torch.Tensor, lens: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """(B, T, V) log-softmax posteriors with frames t >= lens made a sure
    blank (log p 0 for blank, NEG_INF for the rest)."""
    t = logp.shape[1]
    pad = torch.arange(t, device=logp.device)[None, :] >= lens[:, None]  # (B, T)
    masked = torch.where(pad[..., None], NEG_INF, logp)
    masked[..., blank] = torch.where(pad, 0.0, masked[..., blank])
    return masked


def init_state(logp: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """State of the empty prefix, (B, T, 2): [..., 0] = r_nb = NEG_INF,
    [..., 1] = r_b = the cumulative blank log-prob. ``logp`` pre-masked."""
    r_b = torch.cumsum(logp[..., blank], dim=1)
    return torch.stack([torch.full_like(r_b, NEG_INF), r_b], dim=-1)


def score_candidates(
    state: torch.Tensor,  # (N, T, 2)
    last: torch.Tensor,  # (N,) last label of each prefix, -1 for the empty one
    logp: torch.Tensor,  # (N, T, V) pre-masked
    cands: torch.Tensor,  # (N, C) candidate ids
    blank: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every (hypothesis, candidate) extension: ``psi`` (N, C) and the new
    states (N, C, T, 2). At a real vocabulary gather the candidate columns
    yourself and call ``score_candidate_columns`` (the joint decoder does)."""
    x_c = torch.gather(logp, 2, cands[:, None, :].expand(-1, logp.shape[1], -1).long())
    same = cands == last[:, None]
    return score_candidate_columns(state, x_c, logp[..., blank], same, last < 0)


def score_candidate_columns(
    state: torch.Tensor,  # (N, T, 2)
    x_c: torch.Tensor,  # (N, T, C) candidate columns (pre-masked)
    x_blank: torch.Tensor,  # (N, T) blank column (pre-masked)
    same: torch.Tensor,  # (N, C) candidate == the prefix's last label
    empty: torch.Tensor,  # (N,) the prefix is empty
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recursion over pre-gathered candidate columns; returns ``psi``
    (N, C) and the new states (N, C, T, 2)."""
    n, t_len, c = x_c.shape
    r_nb, r_b = state[..., 0], state[..., 1]  # (N, T)
    neg = torch.full((), NEG_INF, dtype=x_c.dtype, device=x_c.device)
    phi = torch.logaddexp(
        r_b[..., None], torch.where(same[:, None, :], neg, r_nb[..., None])
    )  # (N, T, C)
    nb = torch.where(empty[:, None], x_c[:, 0, :], neg)  # (N, C)
    b = torch.full((n, c), NEG_INF, dtype=x_c.dtype, device=x_c.device)
    psi = nb
    nbs, bs = [nb], [b]
    for t in range(1, t_len):
        x_t, phi_tm1 = x_c[:, t, :], phi[:, t - 1, :]
        new_nb = torch.logaddexp(nb, phi_tm1) + x_t
        new_b = torch.logaddexp(b, nb) + x_blank[:, t, None]
        psi = torch.logaddexp(psi, phi_tm1 + x_t)
        nb, b = new_nb, new_b
        nbs.append(nb)
        bs.append(b)
    new_states = torch.stack(
        [torch.stack(nbs, dim=-1), torch.stack(bs, dim=-1)], dim=-1
    )  # (N, C, T, 2)
    return psi, new_states


def eos_score(state: torch.Tensor) -> torch.Tensor:
    """log p_ctc(the labelling is exactly g): the forward mass at the last
    frame (pre-masked frames make T-1 each utterance's true end)."""
    return torch.logaddexp(state[:, -1, 0], state[:, -1, 1])


# ---------------- numpy references (tests) ----------------


def ctc_prefix_score_np(logp, prefix, blank=0):
    """log p(the labelling begins with ``prefix``) for one utterance,
    ``logp`` (T, V) log-softmax; the exact Graves recursion, O(T·len)."""
    t_frames = logp.shape[0]
    if len(prefix) == 0:
        return 0.0
    r_nb = np.full((t_frames,), -np.inf)
    r_b = np.cumsum(logp[:, blank])
    last = None
    for c in prefix:
        new_nb = np.full((t_frames,), -np.inf)
        new_b = np.full((t_frames,), -np.inf)
        phi = np.logaddexp(r_b, r_nb if c != last else np.full_like(r_nb, -np.inf))
        new_nb[0] = logp[0, c] if last is None else -np.inf
        psi = new_nb[0]
        for t in range(1, t_frames):
            new_nb[t] = np.logaddexp(new_nb[t - 1], phi[t - 1]) + logp[t, c]
            new_b[t] = np.logaddexp(new_b[t - 1], new_nb[t - 1]) + logp[t, blank]
            psi = np.logaddexp(psi, phi[t - 1] + logp[t, c])
        r_nb, r_b, last = new_nb, new_b, c
    return float(psi)


def ctc_label_prob_np(logp, labels, blank=0):
    """log p(the labelling is exactly ``labels``) by the CTC forward
    algorithm (the eos score)."""
    ext = [blank]
    for lab in labels:
        ext += [lab, blank]
    s = len(ext)
    t_frames = logp.shape[0]
    alpha = np.full((t_frames, s), -np.inf)
    alpha[0, 0] = logp[0, ext[0]]
    if s > 1:
        alpha[0, 1] = logp[0, ext[1]]
    for t in range(1, t_frames):
        for j in range(s):
            terms = [alpha[t - 1, j]]
            if j > 0:
                terms.append(alpha[t - 1, j - 1])
            if j > 1 and ext[j] != blank and ext[j] != ext[j - 2]:
                terms.append(alpha[t - 1, j - 2])
            alpha[t, j] = np.logaddexp.reduce(terms) + logp[t, ext[j]]
    return float(np.logaddexp(alpha[-1, -1], alpha[-1, -2] if s > 1 else -np.inf))
