"""Host ms a training step spends in ``rsq:train.backward`` over the
profiled steps (rank 0): the spans' summed duration over the number of
``rsq:train.step`` spans. The span holds ``loss.backward()``; on the card
the main thread waits in it while the autograd engine's device thread
launches the backward's operators."""

from portbench.metrics.spans import ms_per_step


def read(obs):
    return ms_per_step(obs, "rsq:train.backward", "rsq:train.step")
