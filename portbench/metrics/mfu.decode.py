"""The whole decode's share (%) of the bf16 peak over the profiled batch:
the model operations of its encoder, cross K/V, prefill and every
token-loop iteration (``portbench/flops.py``) over the stretch's wall
time times 989e12."""

from portbench import flops
from portbench.harness import PEAK_BF16_FLOPS


def read(obs):
    if obs.sub is None or obs.sub.t1 is None or not obs.sub_steps:
        return None
    rows = obs.batch_rows
    ops = flops.forward(flops.encoder_ops(obs.config, obs.sub_encoder_rows, obs.enroll_frames))
    ops += flops.serve_ops(obs.config, rows, obs.prefix, obs.sub_steps - 1)
    return 100.0 * ops / (obs.sub.window_s * PEAK_BF16_FLOPS)
