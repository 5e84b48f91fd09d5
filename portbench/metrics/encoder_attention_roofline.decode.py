"""The encoder self-attention's share (%) of its roofline in the profiled
batch: the least time of its operations (4 b h T^2 d a layer, at the bf16
peak) over the device time of the kernels named below."""

from portbench.harness import PEAK_BF16_FLOPS

PATTERNS = ("flash_fwd_sm90_kernel", "flash_tmaj_f32_kernel")


def work(cfg, rows, length):
    """Operations of the encoder's self-attention over ``rows`` rows of
    ``length`` positions, every layer."""
    w = cfg["whisper"]
    return w["n_audio_layer"] * 4.0 * rows * length * length * w["n_audio_state"]


def read(obs):
    if obs.sub is None or obs.sub.t1 is None or not obs.sub_encoder_rows:
        return None
    ops = obs.sub.kernels(PATTERNS)
    if not ops:
        return None
    least = work(obs.config, obs.sub_encoder_rows, obs.memory_len) / PEAK_BF16_FLOPS
    return 100.0 * least / (sum(d for _, _, d in ops) / 1e6)
