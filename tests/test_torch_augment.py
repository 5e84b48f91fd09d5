"""The port's batched augmentation (``data/augment.py``) against the JAX
package's, on the CPU. The deterministic functions take the same arrays and
agree to 1e-6 relative (f32 means in another summation order), with a
floor of 1e-6 of the output's largest magnitude; the drawing
ones take a ``torch.Generator``, whose stream is not ``jax.random``'s, and
are held to what their draws promise: SIR and SNR measured on the output
within 0.1 dB of the drawn values (the JAX tests' bound), crops inside the
valid region."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from robustsq_whisper_tpu.data import augment as jaug
from robustsq_whisper_torch.data import augment as paug

N = 4000


def _rows(seed, b=3, n=N, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal((b, n))).astype(np.float32)


LENS = np.array([N, 2500, 900], np.int32)
CASES = {  # name: f(module, to_array) -> output
    "masked_power": lambda m, a: m._masked_power(a(_rows(0)), a(LENS)),
    "masked_power_unmasked": lambda m, a: m._masked_power(a(_rows(0)), None),
    "mix_with_sir": lambda m, a: m.mix_with_sir(
        a(_rows(0)), a(_rows(1)), a(np.array([-5.0, 0.5, 5.0], np.float32)), a(LENS), a(LENS[::-1].copy())),
    "mix_with_sir_silent_interferer": lambda m, a: m.mix_with_sir(
        a(_rows(0)), a(np.zeros((3, N), np.float32)), 3.0),
    "add_noise_with_snr": lambda m, a: m.add_noise_with_snr(
        a(_rows(0)), a(_rows(2)), a(np.array([10.0, 15.0, 20.0], np.float32)), a(LENS), None),
    "lufs": lambda m, a: m.lufs(a(np.concatenate([_rows(3, 2), np.zeros((1, N), np.float32)])), a(LENS)),
    "add_noise_with_lufs": lambda m, a: m.add_noise_with_lufs(
        a(_rows(0)), a(np.concatenate([_rows(4, 2), np.zeros((1, N), np.float32)])),
        a(np.array([-30.0, -35.0, -38.0], np.float32)), None, a(LENS)),
    "peak_normalize": lambda m, a: m.peak_normalize(a(_rows(5, scale=1.0)), 0.9),
    "tile_to_length": lambda m, a: m.tile_to_length(a(_rows(6, b=2, n=700)), 2000),
}


@pytest.mark.parametrize("case", list(CASES))
def test_deterministic_function_equals_jax(case):
    want = np.asarray(CASES[case](jaug, jnp.asarray))
    got = CASES[case](paug, torch.from_numpy).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    finite = np.isfinite(want)
    np.testing.assert_array_equal(finite, np.isfinite(got))
    np.testing.assert_array_equal(got[~finite], want[~finite])  # -inf LUFS of silence
    # 1e-6 relative, with a floor of 1e-6 of the output's largest magnitude:
    # a sum that cancels keeps the absolute rounding of its operands
    scale = np.abs(want[finite]).max()
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6, atol=1e-6 * scale)


def _db(num, den):
    return 10.0 * np.log10(np.mean(num ** 2) / np.mean(den ** 2))


def _draws(seed, b, n):
    g = torch.Generator().manual_seed(seed)
    return [(lo + (hi - lo) * torch.rand(b, generator=g)).numpy()
            for lo, hi in ((-5.0, 5.0), (10.0, 20.0))[:n]]


def test_batch_augment_sir_and_snr_within_a_tenth_of_a_db():
    """Overlap alone: the interferer's share is the drawn SIR; noise over a
    silent interferer: the noise's share is the drawn SNR (a second draw
    after the SIRs). The rows stay under the 0.9 peak, so no rescale."""
    b = 6
    speech, interf, noise = (torch.from_numpy(_rows(s, b, scale=0.1)) for s in (7, 8, 9))
    lens = torch.full((b,), N)
    mixed = paug.batch_augment(torch.Generator().manual_seed(3), speech, lens, interf, lens)
    (sir,) = _draws(3, b, 1)
    for i in range(b):
        added = (mixed[i] - speech[i]).numpy()
        assert abs(_db(speech[i].numpy(), added) - sir[i]) < 0.1, (i, sir[i])
    noisy = paug.batch_augment(torch.Generator().manual_seed(4), speech, lens,
                               torch.zeros_like(interf), lens, noise, lens)
    _, snr = _draws(4, b, 2)
    assert 10.0 <= snr.min() and snr.max() <= 20.0
    for i in range(b):
        added = (noisy[i] - speech[i]).numpy()
        assert abs(_db(speech[i].numpy(), added) - snr[i]) < 0.1, (i, snr[i])
    assert float(noisy.abs().max()) <= 0.9


def test_batch_augment_peak_normalizes():
    loud = torch.from_numpy(_rows(10, 2, scale=2.0))
    lens = torch.full((2,), N)
    out = paug.batch_augment(torch.Generator().manual_seed(0), loud, lens, loud.flip(0), lens)
    assert float(out.abs().max()) == pytest.approx(0.9, rel=1e-6)


def test_random_crop_stays_in_the_valid_region():
    """Static (b, crop) output; each crop is a window of its row's valid
    samples, shorter rows keep their length and are zero-padded; the
    starts follow the generator."""
    audio = torch.arange(3 * 1000, dtype=torch.float32).reshape(3, 1000)
    lens = torch.tensor([1000, 500, 100])
    crops, valid = paug.random_crop(torch.Generator().manual_seed(1), audio, lens, 300)
    assert crops.shape == (3, 300) and valid.tolist() == [300, 300, 100]
    for i in range(3):
        row = crops[i, : valid[i]]
        start = int(row[0]) - 1000 * i
        assert torch.equal(row, audio[i, start : start + int(valid[i])])
        assert start + int(valid[i]) <= int(lens[i])
    assert not crops[2, 100:].any()
    again, _ = paug.random_crop(torch.Generator().manual_seed(1), audio, lens, 300)
    assert torch.equal(again, crops)
