"""WER/CER scoring on the host (numpy).

The port's copy of the JAX package's ``decode/scorer.py``: Levenshtein
edit distance with substitution / deletion / insertion counts, summed over
a corpus.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int, int]:
    """Return (substitutions, deletions, insertions, ref_len) via DP.

    Row-vectorized Levenshtein: each dp row is one numpy pass; the
    left-to-right insertion dependency ``cur[j] = min(cur[j], cur[j-1]+1)``
    is a prefix-min scan, ``cur = col + minimum.accumulate(cur - col)``.
    """
    n, m = len(ref), len(hyp)
    if m == 0:
        return 0, n, 0, n
    if n == 0:
        return 0, 0, m, n
    # integer-encode symbols once for vectorized comparison
    sym: Dict = {}
    r_ids = np.fromiter((sym.setdefault(x, len(sym)) for x in ref), np.int32, n)
    h_ids = np.fromiter((sym.setdefault(x, len(sym)) for x in hyp), np.int32, m)

    dp = np.zeros((n + 1, m + 1), dtype=np.int32)
    dp[0, :] = np.arange(m + 1)
    dp[:, 0] = np.arange(n + 1)
    col = np.arange(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        prev = dp[i - 1]
        cost = (h_ids != r_ids[i - 1]).astype(np.int32)
        cur = dp[i]
        cur[1:] = np.minimum(prev[:-1] + cost, prev[1:] + 1)
        np.minimum.accumulate(cur - col, out=cur)
        cur += col
    # backtrace for s/d/i counts
    i, j = n, m
    subs = dels = ins = 0
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dp[i, j] == dp[i - 1, j - 1] + (
            0 if r_ids[i - 1] == h_ids[j - 1] else 1
        ):
            if r_ids[i - 1] != h_ids[j - 1]:
                subs += 1
            i, j = i - 1, j - 1
        elif i > 0 and dp[i, j] == dp[i - 1, j] + 1:
            dels += 1
            i -= 1
        else:
            ins += 1
            j -= 1
    return subs, dels, ins, n


def wer(refs: List[str], hyps: List[str]) -> Dict[str, float]:
    """Corpus word error rate. Returns dict with wer/sub/del/ins rates."""
    S = D = I = N = 0
    for r, h in zip(refs, hyps):
        s, d, i, n = edit_distance(r.split(), h.split())
        S, D, I, N = S + s, D + d, I + i, N + n
    denom = max(N, 1)
    return {
        "wer": (S + D + I) / denom,
        "sub": S / denom,
        "del": D / denom,
        "ins": I / denom,
        "n_words": N,
    }


def cer(refs: List[str], hyps: List[str]) -> Dict[str, float]:
    """Corpus character error rate (whitespace collapsed)."""
    S = D = I = N = 0
    for r, h in zip(refs, hyps):
        rc = list(" ".join(r.split()))
        hc = list(" ".join(h.split()))
        s, d, i, n = edit_distance(rc, hc)
        S, D, I, N = S + s, D + d, I + i, N + n
    denom = max(N, 1)
    return {"cer": (S + D + I) / denom, "n_chars": N}
