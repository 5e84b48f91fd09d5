"""Share (%) of the profiled batch's ``TSDecoder.step`` calls that were a
CUDA graph replay: 100 × the ``rsq:decode.graph_replay`` spans over the
``rsq:decode.step`` spans that called ``dec.step``, which are all but the
last of each greedy loop (one ``rsq:decode.prefill`` span a loop).
Nothing to read where the program opens no replay span."""

from portbench.metrics.spans import named


def read(obs):
    replays = named(obs, "rsq:decode.graph_replay")
    calls = len(named(obs, "rsq:decode.step")) - len(named(obs, "rsq:decode.prefill"))
    if not replays or calls <= 0:
        return None
    return 100.0 * len(replays) / calls
