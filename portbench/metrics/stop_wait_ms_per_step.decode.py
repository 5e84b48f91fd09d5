"""Host ms a token step waits on the device in the profiled batch: the
summed ``rsq:decode.stop_check`` spans (the ``bool(done.all())`` read, a
sync) over the number of ``rsq:decode.step`` spans."""

from portbench.metrics.spans import ms_per_step


def read(obs):
    return ms_per_step(obs, "rsq:decode.stop_check", "rsq:decode.step")
