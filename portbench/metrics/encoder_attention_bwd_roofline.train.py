"""The encoder self-attention backward's share (%) of its roofline in the
profiled steps (rank 0): the least time of its operations (10 b h T^2 d
a layer: the scores recomputed once and four products, at the bf16 peak)
over the device time of the kernels named below."""

from portbench.harness import PEAK_BF16_FLOPS

PATTERNS = ("flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel")
CALL = "flash_bwd_dq_sm90_kernel"  # one launch a layer's backward


def work(cfg, rows, length):
    return 10.0 * rows * length * length * cfg["whisper"]["n_audio_state"]


def read(obs):
    if obs.sub is None or obs.sub.t1 is None:
        return None
    ops = obs.sub.kernels(PATTERNS)
    calls = len(obs.sub.kernels((CALL,)))
    if not ops or not calls:
        return None
    least = calls * work(obs.config, obs.rows, obs.memory_len) / PEAK_BF16_FLOPS
    return 100.0 * least / (sum(d for _, _, d in ops) / 1e6)
