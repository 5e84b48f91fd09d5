"""The beam loop's grouped cross-attention read's share (%) of its roofline
in the profiled batch: the least time of each call's bytes at the HBM
bandwidth (each utterance's int4 K and V and K's float32 scales read once
for its group of k beams, the k bf16 queries in and outputs out) over the
device time of the kernels named below, one call a layer and step."""

from portbench.harness import PEAK_HBM_BYTES_S

PATTERNS = ("decode_cross_kernel",)


def work(cfg, utterances, beams, length):
    """Bytes of one grouped call over ``utterances`` utterances of
    ``beams`` beams and ``length`` memory positions."""
    d = cfg["whisper"]["n_text_state"]
    return utterances * length * d + utterances * d * 4 + 2 * utterances * beams * d * 2


def read(obs):
    if obs.sub is None or obs.sub.t1 is None:
        return None
    ops = obs.sub.kernels(PATTERNS)
    if not ops:
        return None
    least = len(ops) * work(obs.config, obs.utterance_rows, obs.beam_size, obs.memory_len) / PEAK_HBM_BYTES_S
    return 100.0 * least / (sum(d for _, _, d in ops) / 1e6)
