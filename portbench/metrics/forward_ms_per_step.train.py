"""Host ms a training step spends in ``rsq:train.forward`` over the
profiled steps (rank 0): the spans' summed duration over the number of
``rsq:train.step`` spans. The span holds the model's forward and its
losses (``state.model(batch, ...)``)."""

from portbench.metrics.spans import ms_per_step


def read(obs):
    return ms_per_step(obs, "rsq:train.forward", "rsq:train.step")
