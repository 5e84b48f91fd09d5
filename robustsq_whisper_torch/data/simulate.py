"""Offline data simulation: overlap-enrollment mixing and WHAM!-style noise.

The port's copy of the JAX package's ``data/simulate.py``: numpy on the
host, every draw from one ``np.random.default_rng(seed)`` in the JAX
package's order, so that a seed writes the same WAVs, ``wav.scp``,
``utt2spk``, ``text``, ``enroll.scp`` and ``spk2enroll.json``, byte for byte.

- ``generate_overlap_enrollment``: mixes utterances of two random speakers
  at SIR ~ U[sir_min, sir_max] dB and writes TWO target-speaker rows per
  mixture named ``{utt1}_{utt2}_spk{1,2}``, with wav.scp, utt2spk,
  spk2utt, text, spk2gender and an ``enroll.scp`` of lazy
  ``*{utt_id} {spk_id}`` rows (the recipe's stage 101);
- ``add_wham_noise``: adds a random segment of a noise dir's WAVs at SNR ~
  U[snr_min, snr_max] dB (or at a drawn LUFS level), peak-normalises to
  0.9 and prefixes utt ids with ``noisy_`` (stage 101's noisy sets);
- ``format_sglspk_dataset``, ``generate_synth_clean_dir``,
  ``librispeech_to_kaldi``, ``build_spk2enroll_json`` and
  ``build_enrollment_scp`` (stage 102).

The dB formulas are those of ``data/augment.py``'s batched versions.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import kaldi_io


def mix_audio_with_sir(
    audio1: np.ndarray, audio2: np.ndarray, sir_db: float
) -> np.ndarray:
    """Scale ``audio2`` so that P1 / P2 is 10^(SIR/10), then add it (cut to
    the shorter length). A silent ``audio2`` returns ``audio1``."""
    sir_linear = 10.0 ** (sir_db / 10.0)
    p1 = float(np.mean(audio1**2))
    p2 = float(np.mean(audio2**2))
    if p2 == 0:
        return audio1
    scale = np.sqrt(p1 / sir_linear / p2)
    n = min(len(audio1), len(audio2))
    return audio1[:n] + audio2[:n] * scale


def add_noise_with_snr(
    speech: np.ndarray, noise: np.ndarray, snr_db: float
) -> np.ndarray:
    """Noise scaled to P_speech / 10^(SNR/10), added."""
    ps = float(np.mean(speech**2))
    pn = float(np.mean(noise**2))
    if pn == 0:
        return speech
    scale = np.sqrt(ps / (10.0 ** (snr_db / 10.0)) / pn)
    return speech + noise * scale


def calculate_lufs(audio: np.ndarray) -> float:
    rms = float(np.sqrt(np.mean(audio**2)))
    if rms == 0:
        return -float("inf")
    return 20.0 * np.log10(rms) - 0.691


def add_noise_with_lufs(
    speech: np.ndarray, noise: np.ndarray, target_lufs: float
) -> np.ndarray:
    cur = calculate_lufs(noise)
    if cur == -float("inf"):
        return speech
    return speech + noise * 10.0 ** ((target_lufs - cur) / 20.0)


def clip_to_prevent_clipping(audio: np.ndarray, max_value: float = 0.9) -> np.ndarray:
    peak = float(np.max(np.abs(audio))) if audio.size else 0.0
    if peak > max_value:
        audio = audio * (max_value / peak)
    return audio


def get_random_noise_segment(
    noise: np.ndarray, length: int, rng: np.random.Generator
) -> np.ndarray:
    """A random segment of ``length``; short noise is tiled first."""
    if len(noise) < length:
        reps = -(-length // len(noise))
        noise = np.tile(noise, reps)
    start = int(rng.integers(0, len(noise) - length + 1))
    return noise[start : start + length]


@dataclasses.dataclass
class OverlapConfig:
    sir_min: float = -5.0
    sir_max: float = 5.0
    num_mixtures: int = 100
    sample_rate: int = 16000
    seed: int = 42


def generate_overlap_enrollment(
    src_dir: str,
    out_dir: str,
    cfg: OverlapConfig = OverlapConfig(),
) -> Dict[str, int]:
    """Build an overlapped-enrollment dir from a clean single-speaker Kaldi
    dir (wav.scp/utt2spk/text[/spk2gender]). Two target rows per mixture."""
    rng = np.random.default_rng(cfg.seed)
    wav = kaldi_io.read_scp(os.path.join(src_dir, "wav.scp"))
    utt2spk = kaldi_io.read_scp(os.path.join(src_dir, "utt2spk"))
    text_p = os.path.join(src_dir, "text")
    text = kaldi_io.read_scp(text_p) if os.path.exists(text_p) else {}
    g_p = os.path.join(src_dir, "spk2gender")
    spk2gender = kaldi_io.read_scp(g_p) if os.path.exists(g_p) else {}

    spk2utt = kaldi_io.utt2spk_to_spk2utt(utt2spk)
    speakers = [s for s, us in spk2utt.items() if us]
    if len(speakers) < 2:
        raise ValueError("need at least two speakers to mix")

    audio_dir = os.path.join(out_dir, "mixed_audio")
    os.makedirs(audio_dir, exist_ok=True)
    out_wav: Dict[str, str] = {}
    out_u2s: Dict[str, str] = {}
    out_text: Dict[str, str] = {}
    out_enroll: Dict[str, str] = {}
    out_gender: Dict[str, str] = {}

    made = 0
    seen_pairs = set()
    attempts = 0
    while made < cfg.num_mixtures and attempts < cfg.num_mixtures * 20:
        attempts += 1
        s1, s2 = rng.choice(speakers, size=2, replace=False)
        u1 = spk2utt[s1][int(rng.integers(len(spk2utt[s1])))]
        u2 = spk2utt[s2][int(rng.integers(len(spk2utt[s2])))]
        if (u1, u2) in seen_pairs:
            continue
        seen_pairs.add((u1, u2))
        a1, sr1 = kaldi_io.read_wav(wav[u1].split()[0])
        a2, sr2 = kaldi_io.read_wav(wav[u2].split()[0])
        if sr1 != cfg.sample_rate or sr2 != cfg.sample_rate:
            continue
        sir = float(rng.uniform(cfg.sir_min, cfg.sir_max))
        mixed = clip_to_prevent_clipping(mix_audio_with_sir(a1, a2, sir))
        mix_id = f"{u1}_{u2}"
        path = os.path.join(audio_dir, f"{mix_id}.wav")
        kaldi_io.write_wav(path, mixed, cfg.sample_rate)

        # two target-speaker rows per mixture
        for slot, (utt, spk) in enumerate([(u1, s1), (u2, s2)], start=1):
            row_id = f"{mix_id}_spk{slot}"
            out_wav[row_id] = path
            out_u2s[row_id] = spk
            if utt in text:
                out_text[row_id] = text[utt]
            # lazy enrollment pattern: *<SOURCE utt> <spk> — the source utt id
            # (not the mixture row id) is what the exclusion in
            # resolve_enrollment must match against the enrollment pool
            out_enroll[row_id] = f"*{utt} {spk}"
            if spk in spk2gender:
                out_gender[spk] = spk2gender[spk]
        made += 1

    kaldi_io.write_scp(os.path.join(out_dir, "wav.scp"), out_wav)
    kaldi_io.write_scp(os.path.join(out_dir, "utt2spk"), out_u2s)
    if out_text:
        kaldi_io.write_scp(os.path.join(out_dir, "text"), out_text)
    kaldi_io.write_scp(os.path.join(out_dir, "enroll.scp"), out_enroll)
    if out_gender:
        kaldi_io.write_scp(os.path.join(out_dir, "spk2gender"), out_gender)
    kaldi_io.write_spk2utt(
        os.path.join(out_dir, "spk2utt"), kaldi_io.utt2spk_to_spk2utt(out_u2s)
    )
    # enrollment pool json from the clean source dir
    spk2enroll = {
        s: [(u, wav[u].split()[0]) for u in us] for s, us in spk2utt.items()
    }
    kaldi_io.write_spk2enroll(
        os.path.join(out_dir, "spk2enroll.json"), spk2enroll
    )
    return {"num_mixtures": made, "num_rows": len(out_wav)}


@dataclasses.dataclass
class NoiseConfig:
    snr_min: float = 10.0
    snr_max: float = 20.0
    mode: str = "snr"  # snr | lufs
    lufs_min: float = -38.0
    lufs_max: float = -30.0
    peak: float = 0.9
    sample_rate: int = 16000
    seed: int = 42


def add_wham_noise(
    clean_dir: str,
    noise_dir: str,
    out_dir: str,
    cfg: NoiseConfig = NoiseConfig(),
) -> Dict[str, int]:
    """Add random noise-dir wavs to every utterance of ``clean_dir``;
    output rows are prefixed ``noisy_``."""
    rng = np.random.default_rng(cfg.seed)
    wav = kaldi_io.read_scp(os.path.join(clean_dir, "wav.scp"))
    noise_files = sorted(
        os.path.join(noise_dir, f)
        for f in os.listdir(noise_dir)
        if f.endswith(".wav")
    )
    if not noise_files:
        raise ValueError(f"no .wav noise files in {noise_dir}")

    audio_dir = os.path.join(out_dir, "noisy_audio")
    os.makedirs(audio_dir, exist_ok=True)
    out_wav: Dict[str, str] = {}
    carried: Dict[str, Dict[str, str]] = {}
    for name in ("utt2spk", "text", "enroll.scp"):
        p = os.path.join(clean_dir, name)
        if os.path.exists(p):
            carried[name] = kaldi_io.read_scp(p)

    for utt, path in wav.items():
        audio, sr = kaldi_io.read_wav(path.split()[0])
        if sr != cfg.sample_rate:
            continue
        noise, nsr = kaldi_io.read_wav(
            noise_files[int(rng.integers(len(noise_files)))]
        )
        seg = get_random_noise_segment(noise, len(audio), rng)
        if cfg.mode == "lufs":
            target = float(rng.uniform(cfg.lufs_min, cfg.lufs_max))
            noisy = add_noise_with_lufs(audio, seg, target)
        else:
            snr = float(rng.uniform(cfg.snr_min, cfg.snr_max))
            noisy = add_noise_with_snr(audio, seg, snr)
        noisy = clip_to_prevent_clipping(noisy, cfg.peak)
        new_id = f"noisy_{utt}"
        out_path = os.path.join(audio_dir, f"{new_id}.wav")
        kaldi_io.write_wav(out_path, noisy, cfg.sample_rate)
        out_wav[new_id] = out_path

    kaldi_io.write_scp(os.path.join(out_dir, "wav.scp"), out_wav)
    for name, m in carried.items():
        renamed = {
            f"noisy_{u}": v for u, v in m.items() if f"noisy_{u}" in out_wav
        }
        kaldi_io.write_scp(os.path.join(out_dir, name), renamed)
    if "utt2spk" in carried:
        kaldi_io.write_spk2utt(
            os.path.join(out_dir, "spk2utt"),
            kaldi_io.utt2spk_to_spk2utt(
                kaldi_io.read_scp(os.path.join(out_dir, "utt2spk"))
            ),
        )
    src_json = os.path.join(clean_dir, "spk2enroll.json")
    if os.path.exists(src_json):
        import shutil

        shutil.copy(src_json, os.path.join(out_dir, "spk2enroll.json"))
    return {"num_rows": len(out_wav)}


def format_sglspk_dataset(
    mix_dir: str, out_dir: str, texts: Sequence[str] = ("text_spk1", "text_spk2")
) -> Dict[str, int]:
    """Explode each 2-speaker mixture row into two single-speaker rows
    ``{utt}_spk{N}`` with per-speaker transcripts."""
    wav = kaldi_io.read_scp(os.path.join(mix_dir, "wav.scp"))
    spk_texts = []
    for t in texts:
        p = os.path.join(mix_dir, t)
        spk_texts.append(kaldi_io.read_scp(p) if os.path.exists(p) else {})
    spk_maps = []
    for i in (1, 2):
        p = os.path.join(mix_dir, f"spk{i}.scp")
        spk_maps.append(kaldi_io.read_scp(p) if os.path.exists(p) else {})

    out_wav, out_text, out_u2s = {}, {}, {}
    for utt, path in wav.items():
        for slot in (1, 2):
            row = f"{utt}_spk{slot}"
            out_wav[row] = path
            t = spk_texts[slot - 1].get(utt)
            if t is not None:
                out_text[row] = t
            spk = spk_maps[slot - 1].get(utt)
            if spk is None:
                # derive from utt id: {u1}_{u2} -> slot field's speaker
                fields = utt.split("_")
                if len(fields) >= 2:
                    spk = fields[slot - 1].split("-")[0]
                else:
                    spk = utt
            out_u2s[row] = spk

    os.makedirs(out_dir, exist_ok=True)
    kaldi_io.write_scp(os.path.join(out_dir, "wav.scp"), out_wav)
    if out_text:
        kaldi_io.write_scp(os.path.join(out_dir, "text"), out_text)
    kaldi_io.write_scp(os.path.join(out_dir, "utt2spk"), out_u2s)
    kaldi_io.write_spk2utt(
        os.path.join(out_dir, "spk2utt"), kaldi_io.utt2spk_to_spk2utt(out_u2s)
    )
    with open(os.path.join(out_dir, "feats_type"), "w") as f:
        f.write("raw\n")
    return {"num_rows": len(out_wav)}


_SYNTH_WORDS = (
    "alpha bravo charlie delta echo foxtrot golf hotel india juliet kilo "
    "lima mike november oscar papa quebec romeo sierra tango uniform victor "
    "whiskey xray yankee zulu zero one two three four five six seven eight "
    "nine north south east west river mountain valley harbor"
).split()


def generate_synth_clean_dir(
    out_dir: str,
    n_speakers: int = 8,
    utts_per_spk: int = 8,
    seconds: float = 6.0,
    words_min: int = 4,
    words_max: int = 9,
    sample_rate: int = 16000,
    seed: int = 0,
) -> Dict[str, int]:
    """Synthetic LibriSpeech-style clean dir: per-speaker harmonic tones +
    noise with distinct word transcripts, the stand-in for a real corpus
    that drives the whole recipe (stages 101 -> 103 -> 11 -> 12) with no
    dataset: the audio is distinguishable per utterance (speaker-dependent
    fundamental, utterance-dependent overtones), so an overfit model can
    map each row to its transcript and a scored decode means something."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "wavs"), exist_ok=True)
    n = int(seconds * sample_rate)
    t = np.arange(n) / sample_rate
    wav: Dict[str, str] = {}
    u2s: Dict[str, str] = {}
    text: Dict[str, str] = {}
    for s in range(n_speakers):
        spk = f"{100 + s}"
        f0 = 120.0 + 37.0 * s
        for u in range(utts_per_spk):
            utt = f"{spk}-0-{u:04d}"
            f1 = f0 * (2.0 + 0.13 * u)
            audio = (
                0.25 * np.sin(2 * np.pi * f0 * t)
                + 0.15 * np.sin(2 * np.pi * f1 * t + 0.7 * u)
                + 0.03 * rng.standard_normal(n)
            ).astype(np.float32)
            p = os.path.join(out_dir, "wavs", f"{utt}.wav")
            kaldi_io.write_wav(p, audio, sample_rate)
            wav[utt] = p
            u2s[utt] = spk
            k = int(rng.integers(words_min, words_max + 1))
            words = rng.choice(_SYNTH_WORDS, size=k, replace=True)
            text[utt] = " ".join(str(w) for w in words)
    kaldi_io.write_scp(os.path.join(out_dir, "wav.scp"), wav)
    kaldi_io.write_scp(os.path.join(out_dir, "utt2spk"), u2s)
    kaldi_io.write_scp(os.path.join(out_dir, "text"), text)
    kaldi_io.write_spk2utt(
        os.path.join(out_dir, "spk2utt"), kaldi_io.utt2spk_to_spk2utt(u2s)
    )
    return {"num_utts": len(wav), "num_speakers": n_speakers}


def librispeech_to_kaldi(
    root: str,
    out_dir: str,
    exts: Tuple[str, ...] = (".wav", ".flac"),
) -> Dict[str, int]:
    """LibriSpeech tree -> Kaldi dir:
    ``{spk}/{chapter}/{spk}-{chapter}-{utt}.flac`` + ``*.trans.txt``
    transcripts + optional ``SPEAKERS.TXT`` genders."""
    wav: Dict[str, str] = {}
    u2s: Dict[str, str] = {}
    text: Dict[str, str] = {}
    for cur, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(exts):
                utt = os.path.splitext(f)[0]
                wav[utt] = os.path.join(cur, f)
                u2s[utt] = utt.split("-")[0]
            elif f.endswith(".trans.txt"):
                with open(os.path.join(cur, f)) as fh:
                    for line in fh:
                        parts = line.strip().split(maxsplit=1)
                        if len(parts) == 2:
                            text[parts[0]] = parts[1]
    spk2gender: Dict[str, str] = {}
    speakers_txt = os.path.join(root, "SPEAKERS.TXT")
    if os.path.exists(speakers_txt):
        with open(speakers_txt) as fh:
            for line in fh:
                if line.startswith(";"):
                    continue
                cols = [c.strip() for c in line.split("|")]
                if len(cols) >= 2 and cols[0] in {u2s[u] for u in u2s}:
                    spk2gender[cols[0]] = cols[1].lower()
    os.makedirs(out_dir, exist_ok=True)
    kaldi_io.write_scp(os.path.join(out_dir, "wav.scp"), wav)
    kaldi_io.write_scp(os.path.join(out_dir, "utt2spk"), u2s)
    if text:
        kaldi_io.write_scp(
            os.path.join(out_dir, "text"),
            {u: t for u, t in text.items() if u in wav},
        )
    if spk2gender:
        kaldi_io.write_scp(os.path.join(out_dir, "spk2gender"), spk2gender)
    kaldi_io.write_spk2utt(
        os.path.join(out_dir, "spk2utt"), kaldi_io.utt2spk_to_spk2utt(u2s)
    )
    kaldi_io.fix_data_dir(out_dir)
    return {"num_utts": len(wav), "num_speakers": len(set(u2s.values()))}


def build_spk2enroll_json(
    librispeech_root: str, out_path: str, exts: Tuple[str, ...] = (".wav", ".flac")
) -> int:
    """Walk a LibriSpeech-style tree {spk}/{chapter}/{utt}.wav ->
    spk2enroll.json."""
    spk2enroll: Dict[str, List[Tuple[str, str]]] = {}
    for root, _, files in os.walk(librispeech_root):
        for f in sorted(files):
            if not f.endswith(exts):
                continue
            utt = os.path.splitext(f)[0]
            spk = utt.split("-")[0]
            spk2enroll.setdefault(spk, []).append(
                (utt, os.path.join(root, f))
            )
    kaldi_io.write_spk2enroll(out_path, spk2enroll)
    return len(spk2enroll)


def build_enrollment_scp(
    data_dir: str,
    out_path: str,
    train: bool = True,
    spk2enroll_path: Optional[str] = None,
    seed: int = 0,
) -> int:
    """Train mode: lazy ``*utt spk`` rows. Eval mode: resolve concrete paths
    from spk2enroll.json."""
    utt2spk = kaldi_io.read_scp(os.path.join(data_dir, "utt2spk"))
    rows: Dict[str, str] = {}
    if train:
        for utt, spk in utt2spk.items():
            rows[utt] = f"*{utt} {spk}"
    else:
        spk2enroll = kaldi_io.read_spk2enroll(
            spk2enroll_path or os.path.join(data_dir, "spk2enroll.json")
        )
        rng = np.random.default_rng(seed)
        for utt, spk in utt2spk.items():
            rows[utt] = kaldi_io.resolve_enrollment(
                f"*{utt} {spk}", spk2enroll, rng, exclude_utt=utt
            )
    kaldi_io.write_scp(out_path, rows)
    return len(rows)
