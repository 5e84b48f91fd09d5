"""Batched audio augmentation on the device: SIR overlap mixing, WHAM!-style
SNR / LUFS noise, peak normalisation and cropping.

The JAX package's ``data/augment.py`` on torch tensors: every function works
on the device its inputs lie on, and the ones that draw take a
``torch.Generator`` on that device in place of a ``jax.random`` key (torch's
random streams are not JAX's, so a seed draws other values than there; what
holds is what the draws promise, e.g. the measured SIR and SNR within 0.1 dB
of the drawn ones). The dB formulas are those of ``data/simulate.py``'s
offline simulators; batched rows carry valid lengths, and every power
statistic masks the padding so that it never biases SIR or SNR.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _masked_power(x: torch.Tensor, lens: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean power over valid samples. x: (..., n); lens: (...,) or None."""
    if lens is None:
        return torch.mean(x * x, dim=-1)
    n = x.shape[-1]
    mask = torch.arange(n, device=x.device)[None, :] < lens[:, None]
    return torch.sum(torch.where(mask, x * x, 0.0), dim=-1) / torch.clamp(lens, min=1).to(x.dtype)


def _db_scale(p_ref: torch.Tensor, p: torch.Tensor, db) -> torch.Tensor:
    """sqrt(p_ref / 10^(db/10) / p), 0 where ``p`` is 0."""
    lin = 10.0 ** (torch.as_tensor(db, dtype=torch.float32, device=p.device) / 10.0)
    scale = torch.sqrt(p_ref / lin / torch.clamp(p, min=1e-20))
    return torch.where(p > 0, scale, 0.0)


def mix_with_sir(
    target: torch.Tensor,  # (b, n)
    interferer: torch.Tensor,  # (b, n)
    sir_db,  # (b,) or scalar
    target_lens: Optional[torch.Tensor] = None,
    interferer_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scale ``interferer`` so that P_target / P_interferer is 10^(SIR/10),
    then add it; a silent interferer passes the target through."""
    p1 = _masked_power(target, target_lens)
    p2 = _masked_power(interferer, interferer_lens)
    return target + interferer * _db_scale(p1, p2, sir_db)[:, None]


def add_noise_with_snr(
    speech: torch.Tensor,  # (b, n)
    noise: torch.Tensor,  # (b, n)
    snr_db,  # (b,) or scalar
    speech_lens: Optional[torch.Tensor] = None,
    noise_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Noise scaled to P_speech / 10^(SNR/10), added."""
    ps = _masked_power(speech, speech_lens)
    pn = _masked_power(noise, noise_lens)
    return speech + noise * _db_scale(ps, pn, snr_db)[:, None]


def lufs(audio: torch.Tensor, lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Simplified LUFS, 20 log10(rms) - 0.691; -inf for silence."""
    rms = torch.sqrt(_masked_power(audio, lens))
    level = 20.0 * torch.log10(torch.clamp(rms, min=1e-20)) - 0.691
    return torch.where(rms > 0, level, float("-inf"))


def add_noise_with_lufs(
    speech: torch.Tensor,
    noise: torch.Tensor,
    target_lufs,
    speech_lens: Optional[torch.Tensor] = None,
    noise_lens: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Noise scaled to the target LUFS level, added; silent noise adds
    nothing."""
    cur = lufs(noise, noise_lens)
    target = torch.as_tensor(target_lufs, dtype=torch.float32, device=noise.device)
    scale = torch.where(torch.isfinite(cur), 10.0 ** ((target - cur) / 20.0), 0.0)
    return speech + noise * scale[:, None]


def peak_normalize(audio: torch.Tensor, max_value: float = 0.9) -> torch.Tensor:
    """Rescale the rows whose peak exceeds ``max_value`` to that peak."""
    peak = torch.amax(torch.abs(audio), dim=-1, keepdim=True)
    scale = torch.where(peak > max_value, max_value / torch.clamp(peak, min=1e-20), 1.0)
    return audio * scale


def random_crop(
    generator: torch.Generator,
    audio: torch.Tensor,  # (b, n)
    lens: torch.Tensor,  # (b,)
    crop_samples: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A random ``crop_samples`` window inside each row's valid region (the
    enrollment crop); rows shorter than that keep their valid length, padded
    with zeros. Returns (crops (b, crop_samples), valid lengths)."""
    b, n = audio.shape
    max_start = torch.clamp(lens - crop_samples, min=0)
    u = torch.rand(b, generator=generator, device=audio.device)
    start = (u * (max_start + 1).to(torch.float32)).to(torch.long)
    idx = start[:, None] + torch.arange(crop_samples, device=audio.device)[None, :]
    cropped = torch.gather(audio, 1, torch.clamp(idx, max=n - 1))
    valid = torch.clamp(lens, max=crop_samples)
    mask = torch.arange(crop_samples, device=audio.device)[None, :] < valid[:, None]
    return torch.where(mask, cropped, 0.0), valid


def tile_to_length(noise: torch.Tensor, length: int) -> torch.Tensor:
    """Repeat a noise clip along its last axis to at least ``length``
    samples, then cut there."""
    reps = -(-length // noise.shape[-1])
    return noise.repeat(*([1] * (noise.dim() - 1)), reps)[..., :length]


def batch_augment(
    generator: torch.Generator,
    speech: torch.Tensor,  # (b, n) target speaker audio
    speech_lens: torch.Tensor,
    interferer: torch.Tensor,  # (b, n) other speaker audio
    interferer_lens: torch.Tensor,
    noise: Optional[torch.Tensor] = None,  # (b, n) noise rows
    noise_lens: Optional[torch.Tensor] = None,
    sir_range: Tuple[float, float] = (-5.0, 5.0),
    snr_range: Tuple[float, float] = (10.0, 20.0),
    peak: float = 0.9,
) -> torch.Tensor:
    """The batched simulation: an overlap mix at SIR ~ U(sir_range), noise
    at SNR ~ U(snr_range) when ``noise`` is given, then peak normalisation.
    Draws b SIRs, then (with noise) b SNRs, from ``generator``."""
    b = speech.shape[0]

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(b, generator=generator, device=speech.device)

    mixed = mix_with_sir(speech, interferer, uniform(*sir_range), speech_lens, interferer_lens)
    if noise is not None:
        mixed = add_noise_with_snr(mixed, noise, uniform(*snr_range), speech_lens, noise_lens)
    return peak_normalize(mixed, peak)
