"""The training step's share (%) of the bf16 peak per GPU over the
profiled steps: one step's model operations for the mode (forward,
activation gradients, trainable weights' gradients; no recomputation;
``portbench/flops.py``) on this rank's rows, times the steps, over the
stretch's wall time times 989e12."""

from portbench import flops
from portbench.harness import PEAK_BF16_FLOPS


def read(obs):
    if obs.sub is None or obs.sub.t1 is None or not obs.sub_steps:
        return None
    step = flops.train_step_ops(obs.config, obs.rows, obs.text_len, obs.enroll_frames, obs.trainable)
    return 100.0 * step * obs.sub_steps / (obs.sub.window_s * PEAK_BF16_FLOPS)
