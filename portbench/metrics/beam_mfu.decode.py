"""The whole beam decode's share (%) of the bf16 peak over the profiled
batch: the model operations (``portbench/flops.py``) of its encoder at the
batch's rows, of the cross K/V and the prefill at the b utterance rows,
and of every token step at the loop's b x k rows, over the stretch's wall
time times 989e12."""

from portbench import flops
from portbench.harness import PEAK_BF16_FLOPS


def work(cfg, encoder_rows, enroll_frames, utterances, beams, prefix, steps):
    """Operations of one beam batch: the encoder over ``encoder_rows``; the
    cross K/V and the ``prefix``-token prefill over ``utterances`` rows;
    ``steps`` token steps over ``utterances * beams`` rows, the i-th
    attending ``prefix + i`` cached positions."""
    rows = utterances * beams
    ops = flops.forward(flops.encoder_ops(cfg, encoder_rows, enroll_frames))
    ops += flops.serve_ops(cfg, utterances, prefix, 0)
    return ops + flops.serve_ops(cfg, rows, prefix, steps) - flops.serve_ops(cfg, rows, prefix, 0)


def read(obs):
    if obs.sub is None or obs.sub.t1 is None or not obs.sub_steps:
        return None
    ops = work(obs.config, obs.sub_encoder_rows, obs.enroll_frames, obs.utterance_rows, obs.beam_size,
               obs.prefix, obs.sub_steps - 1)
    return 100.0 * ops / (obs.sub.window_s * PEAK_BF16_FLOPS)
