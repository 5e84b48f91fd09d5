"""Waveforms shared by the frontend tests on the CPU and on the card."""

import numpy as np


def edge_wave(rows, width, seed):
    """Speech-like rows with the int16 quantizer's edges: exact half-steps
    (k + 0.5) / 32768 (ties, rounded to even), samples beyond +-1 that
    saturate, small negatives that round to zero, and a zero tail."""
    rng = np.random.default_rng(seed)
    wave = (rng.standard_normal((rows, width)) * 0.1).astype(np.float32)
    k = rng.integers(-32768, 32767, (rows, 64))
    wave[:, :64] = (k + 0.5) / 32768
    wave[:, 64:80] = rng.uniform(-3.0, 3.0, (rows, 16))
    wave[:, 80:96] = -rng.uniform(0.0, 0.49, (rows, 16)) / 32768
    wave[-1, width // 2:] = 0.0
    return wave
