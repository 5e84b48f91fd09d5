"""The beam cache reorder's share (%) of its roofline in the profiled
batch: the least time of the batch's reorder bytes at the HBM bandwidth
over the device time of the kernels named below. The bytes come from
shapes, not from a launch count, so any route is held to the same work:
before step i the K and V of every layer and of the loop's b x k rows are
read and written over the ``prefix + i`` live positions, bf16."""

from portbench.harness import PEAK_HBM_BYTES_S

PATTERNS = ("reorder_kernel",)


def work(cfg, rows, prefix, steps):
    """Bytes read and written by the reorders before ``steps`` token
    steps over ``rows`` rows, the i-th over ``prefix + i`` positions."""
    w = cfg["whisper"]
    per_position = 2 * 2 * w["n_text_layer"] * rows * w["n_text_state"] * 2  # K and V, read and written
    return per_position * sum(prefix + i for i in range(steps))


def read(obs):
    if obs.sub is None or obs.sub.t1 is None or not obs.sub_steps:
        return None
    ops = obs.sub.kernels(PATTERNS)
    if not ops:
        return None
    least = work(obs.config, obs.batch_rows, obs.prefix, obs.sub_steps - 1) / PEAK_HBM_BYTES_S
    return 100.0 * least / (sum(d for _, _, d in ops) / 1e6)
