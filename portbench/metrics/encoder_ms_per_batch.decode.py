"""Device ms of the target-speaker encoder a batch: CUDA events at its
forward pre- and post-hooks, summed over the batch's ``enc_chunk``
sub-batches (mean over the window's batches)."""


def read(obs):
    return sum(obs.encoder_ms) / len(obs.encoder_ms) if obs.encoder_ms else None
