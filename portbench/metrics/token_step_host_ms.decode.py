"""Host ms of a token step in the profiled batch: the mean over its
``rsq:decode.step`` spans of the span less the ``rsq:decode.stop_check``
inside it (sampling, the cache reorder, ``TSDecoder.step``'s dispatch:
the host's own time, without its wait for the stop flag)."""

from portbench.metrics.spans import named, nested_us


def read(obs):
    steps = named(obs, "rsq:decode.step")
    if not steps:
        return None
    waits = nested_us(named(obs, "rsq:decode.stop_check"), steps)
    return sum(d - w for (_, _, d), w in zip(steps, waits)) / 1e3 / len(steps)
