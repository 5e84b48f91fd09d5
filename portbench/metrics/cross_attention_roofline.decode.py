"""The token loop's cross-attention read's share (%) of its roofline in the
profiled batch: the least time of each call's bytes (the int4 K and V of
every row, K's float32 scales, the bf16 query in and output out, at the
HBM bandwidth) over the device time of the kernels named below, one call
a layer and step."""

from portbench.harness import PEAK_HBM_BYTES_S

PATTERNS = ("decode_cross_kernel",)


def work(cfg, rows, length):
    """Bytes of one call over ``rows`` rows and ``length`` memory
    positions."""
    d = cfg["whisper"]["n_text_state"]
    return rows * length * d + rows * d * 4 + 2 * rows * d * 2


def read(obs):
    if obs.sub is None or obs.sub.t1 is None:
        return None
    ops = obs.sub.kernels(PATTERNS)
    if not ops:
        return None
    least = len(ops) * work(obs.config, obs.batch_rows, obs.memory_len) / PEAK_HBM_BYTES_S
    return 100.0 * least / (sum(d for _, _, d in ops) / 1e6)
