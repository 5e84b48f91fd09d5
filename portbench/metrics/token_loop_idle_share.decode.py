"""Share (%) of the profiled batch's token loop in which no operation ran
on the device: 1 - the device's busy time clipped to the
``rsq:decode.step`` spans over their summed duration (``idle_share.decode``
without the frontend, the encoder, the prefill and the detokenize)."""

from portbench.metrics.spans import busy_us, named


def read(obs):
    steps = named(obs, "rsq:decode.step")
    total = sum(d for _, _, d in steps)
    if not total:
        return None
    return 100.0 * (1.0 - sum(busy_us(obs, steps)) / total)
