"""Device ms of the beam selection a token step in the profiled batch: the
device's busy time inside the ``rsq:decode.beam_select`` spans (the
log-softmax, the dead-beam mask, the stable top-k over k x vocab and the
lineage bookkeeping) over the number of ``rsq:decode.step`` spans.
Nothing to read where the program opens no selection span."""

from portbench.metrics.spans import busy_us, named


def read(obs):
    selects, steps = named(obs, "rsq:decode.beam_select"), named(obs, "rsq:decode.step")
    if not selects or not steps:
        return None
    return sum(busy_us(obs, selects)) / 1e3 / len(steps)
