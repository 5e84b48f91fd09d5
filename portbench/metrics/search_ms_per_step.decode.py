"""Host ms from a batch's last encoder post-hook to the next batch request,
over the token-loop iterations the batch took: cross K/V, prefill, the
token loop and the previous batch's detokenize (mean over the window's
batches)."""


def read(obs):
    return sum(obs.search_ms_per_step) / len(obs.search_ms_per_step) if obs.search_ms_per_step else None
