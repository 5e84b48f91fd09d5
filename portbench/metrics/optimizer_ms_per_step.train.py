"""Host ms a training step spends in ``rsq:train.optimizer`` over the
profiled steps (rank 0): the spans' summed duration over the number of
``rsq:train.step`` spans. The span holds the gradients' exchange between
ranks, the stats' mean over ranks, the clipped norm and the update
(``sync_grads``, ``opt.norm``, ``opt.update``)."""

from portbench.metrics.spans import ms_per_step


def read(obs):
    return ms_per_step(obs, "rsq:train.optimizer", "rsq:train.step")
