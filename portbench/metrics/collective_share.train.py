"""Share (%) of the profiled steps' wall time that rank 0's NCCL kernels
ran on the device (the gradient all-reduce and the whole-batch losses'
collectives)."""

PATTERNS = ("nccl", "NCCL")


def read(obs):
    if obs.sub is None or obs.sub.t1 is None or obs.world < 2:
        return None
    ops = obs.sub.kernels(PATTERNS)
    if not ops:
        return None
    return 100.0 * sum(d for _, _, d in ops) / 1e6 / obs.sub.window_s
