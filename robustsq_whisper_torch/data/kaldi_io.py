"""Kaldi data-dir IO: the port's copy of the JAX package's
``data/kaldi_io.py`` (pure Python and numpy).

- ``read_scp`` / ``write_scp``: the two-column ``key value`` text maps
  (wav.scp, utt2spk, text, enroll.scp, utt2num_samples, ...);
- the data-dir tools of Kaldi's ``utils/`` scripts: ``utt2spk_to_spk2utt``
  and back, ``filter_scp``, ``subset_scp``, ``shuffle_list``,
  ``apply_map``, ``write_utt2dur``, ``validate_data_dir``,
  ``fix_data_dir``, ``copy_data_dir``, ``combine_data_dirs``,
  ``subset_data_dir``, ``split_data_dir_tr_cv``, ``librimix_to_kaldi``,
  ``remove_dup_utts``, ``resample_data_dir``, ``get_segments_for_data``,
  ``extend_segment_times(_file)`` and ``create_data_links``; every file
  they write is the JAX package's, byte for byte;
- lazy-enrollment rows ``*<utt_id> <spk_id>`` resolved against a
  ``spk2enroll.json`` (``{spk: [[utt, path], ...]}``);
- WAV read/write through scipy (16-bit PCM <-> float32 in [-1, 1]); FLAC
  (LibriSpeech's format) is read by the native decoder
  (``native/flac.cpp`` through ``data/native_loader.py``), and raises where
  that cannot be built; ``get_num_samples`` for ``utt2num_samples``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

REQUIRED_FILES = ("wav.scp", "utt2spk")


def read_scp(path: str) -> Dict[str, str]:
    """Ordered {key: rest-of-line}."""
    out: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                continue
            parts = line.split(maxsplit=1)
            out[parts[0]] = parts[1] if len(parts) > 1 else ""
    return out


def write_scp(path: str, mapping: Dict[str, str], sort: bool = True) -> None:
    keys = sorted(mapping) if sort else list(mapping)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        for k in keys:
            f.write(f"{k} {mapping[k]}\n")


def utt2spk_to_spk2utt(utt2spk: Dict[str, str]) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for utt, spk in utt2spk.items():
        out.setdefault(spk, []).append(utt)
    return {k: sorted(v) for k, v in sorted(out.items())}


def spk2utt_to_utt2spk(spk2utt: Dict[str, Sequence[str]]) -> Dict[str, str]:
    out = {}
    for spk, utts in spk2utt.items():
        for u in utts:
            out[u] = spk
    return dict(sorted(out.items()))


def read_spk2utt(path: str) -> Dict[str, List[str]]:
    return {k: v.split() for k, v in read_scp(path).items()}


def write_spk2utt(path: str, spk2utt: Dict[str, Sequence[str]]) -> None:
    write_scp(path, {k: " ".join(v) for k, v in spk2utt.items()})


def filter_scp(keys: Iterable[str], mapping: Dict[str, str]) -> Dict[str, str]:
    """utils/filter_scp.pl: keep rows whose key is in ``keys``."""
    keyset = set(keys)
    return {k: v for k, v in mapping.items() if k in keyset}


def subset_scp(mapping: Dict[str, str], n: int, first: bool = True) -> Dict[str, str]:
    """utils/subset_scp.pl: head/tail subset of n rows (sorted order)."""
    keys = sorted(mapping)
    keys = keys[:n] if first else keys[-n:]
    return {k: mapping[k] for k in keys}


def shuffle_list(items: Iterable[str], seed: int = 777) -> List[str]:
    """utils/shuffle_list.pl: seeded deterministic shuffle."""
    out = list(items)
    np.random.default_rng(seed).shuffle(out)
    return out


def apply_map(mapping: Dict[str, str], table: Dict[str, str]) -> Dict[str, str]:
    """utils/apply_map.pl: replace each value token through a lookup table."""
    out = {}
    for k, v in mapping.items():
        out[k] = " ".join(table.get(tok, tok) for tok in v.split())
    return out


def write_utt2dur(data_dir: str) -> int:
    """utils/data/get_utt2dur.sh equivalent: per-utterance durations, using
    each file's OWN sample rate (replacing the soxi/ffmpeg probes)."""
    wav = read_scp(os.path.join(data_dir, "wav.scp"))
    dur = {}
    for u, p in wav.items():
        audio, sr = read_wav(p.split()[0])
        dur[u] = f"{audio.shape[0] / sr:.3f}"
    write_scp(os.path.join(data_dir, "utt2dur"), dur)
    return len(dur)


# ---------------- data dirs ----------------

_ALL_UTT_FILES = (
    "wav.scp",
    "utt2spk",
    "text",
    "enroll.scp",
    "resnet.scp",
    "utt2num_samples",
    "utt2dur",
)


def validate_data_dir(
    path: str,
    require_text: bool = True,
    check_wav_exists: bool = False,
) -> List[str]:
    """Return a list of problems (empty = valid), mirroring
    utils/validate_data_dir.sh checks: required files, sorted keys, identical
    utterance sets, spk2utt consistency."""
    problems: List[str] = []
    maps: Dict[str, Dict[str, str]] = {}
    for name in REQUIRED_FILES + (("text",) if require_text else ()):
        p = os.path.join(path, name)
        if not os.path.exists(p):
            problems.append(f"missing required file: {name}")
    for name in _ALL_UTT_FILES:
        p = os.path.join(path, name)
        if os.path.exists(p):
            maps[name] = read_scp(p)
            keys = list(maps[name])
            if keys != sorted(keys):
                problems.append(f"{name}: keys not sorted")
    base = maps.get("wav.scp")
    if base is not None:
        base_keys = set(base)
        for name, m in maps.items():
            if name == "wav.scp":
                continue
            if set(m) != base_keys:
                missing = len(base_keys - set(m))
                extra = len(set(m) - base_keys)
                problems.append(
                    f"{name}: utterance set mismatch vs wav.scp "
                    f"({missing} missing, {extra} extra)"
                )
    s2u_path = os.path.join(path, "spk2utt")
    if os.path.exists(s2u_path) and "utt2spk" in maps:
        derived = utt2spk_to_spk2utt(maps["utt2spk"])
        if read_spk2utt(s2u_path) != derived:
            problems.append("spk2utt inconsistent with utt2spk")
    if check_wav_exists and base:
        for utt, p in list(base.items())[:5]:
            if not p.startswith("|") and not os.path.exists(p.split()[0]):
                problems.append(f"wav.scp: missing file for {utt}")
    return problems


def fix_data_dir(path: str) -> int:
    """Filter all per-utterance files to the common key set, sort, and
    regenerate spk2utt (utils/data/fix_data_dir.sh). Returns kept count."""
    maps = {}
    for name in _ALL_UTT_FILES:
        p = os.path.join(path, name)
        if os.path.exists(p):
            maps[name] = read_scp(p)
    if not maps:
        return 0
    common = None
    for m in maps.values():
        common = set(m) if common is None else (common & set(m))
    common = common or set()
    for name, m in maps.items():
        write_scp(os.path.join(path, name), filter_scp(common, m))
    if "utt2spk" in maps:
        write_spk2utt(
            os.path.join(path, "spk2utt"),
            utt2spk_to_spk2utt(filter_scp(common, maps["utt2spk"])),
        )
    return len(common)


# ---------------- data-dir operations (utils/*_data_dir.sh family) --------


def copy_data_dir(src: str, dst: str, utt_prefix: str = "") -> int:
    """utils/copy_data_dir.sh: copy with optional utterance-id prefix."""
    os.makedirs(dst, exist_ok=True)
    n = 0
    for name in _ALL_UTT_FILES:
        p = os.path.join(src, name)
        if not os.path.exists(p):
            continue
        m = read_scp(p)
        write_scp(
            os.path.join(dst, name),
            {f"{utt_prefix}{k}": v for k, v in m.items()},
        )
        n = len(m)
    u2s_p = os.path.join(dst, "utt2spk")
    if os.path.exists(u2s_p):
        write_spk2utt(
            os.path.join(dst, "spk2utt"), utt2spk_to_spk2utt(read_scp(u2s_p))
        )
    for extra in ("feats_type", "spk2gender", "spk2enroll.json"):
        p = os.path.join(src, extra)
        if os.path.exists(p):
            shutil.copy(p, os.path.join(dst, extra))
    return n


def combine_data_dirs(srcs: Sequence[str], dst: str) -> int:
    """utils/combine_data.sh: concatenate data dirs (keys must not clash)."""
    os.makedirs(dst, exist_ok=True)
    for name in _ALL_UTT_FILES:
        merged: Dict[str, str] = {}
        found = False
        for s in srcs:
            p = os.path.join(s, name)
            if os.path.exists(p):
                found = True
                for k, v in read_scp(p).items():
                    if k in merged:
                        raise ValueError(f"duplicate utt id {k} in {name}")
                    merged[k] = v
        if found:
            write_scp(os.path.join(dst, name), merged)
    u2s_p = os.path.join(dst, "utt2spk")
    if os.path.exists(u2s_p):
        write_spk2utt(
            os.path.join(dst, "spk2utt"), utt2spk_to_spk2utt(read_scp(u2s_p))
        )
    return len(read_scp(os.path.join(dst, "wav.scp")))


def subset_data_dir(src: str, dst: str, n: int, first: bool = True) -> int:
    """utils/subset_data_dir.sh: head/tail utterance subset."""
    wav = read_scp(os.path.join(src, "wav.scp"))
    keep = set(subset_scp(wav, n, first))
    copy_data_dir(src, dst)
    for name in _ALL_UTT_FILES:
        p = os.path.join(dst, name)
        if os.path.exists(p):
            write_scp(p, filter_scp(keep, read_scp(p)))
    return fix_data_dir(dst)


def split_data_dir_tr_cv(
    src: str, tr_dst: str, cv_dst: str, cv_fraction: float = 0.1, seed: int = 0
) -> Tuple[int, int]:
    """utils/subset_data_dir_tr_cv.sh: speaker-disjoint train/cv split."""
    utt2spk = read_scp(os.path.join(src, "utt2spk"))
    spk2utt = utt2spk_to_spk2utt(utt2spk)
    spks = sorted(spk2utt)
    rng = np.random.default_rng(seed)
    rng.shuffle(spks)
    n_cv = max(1, int(len(spks) * cv_fraction))
    cv_spks = set(spks[:n_cv])
    cv_utts = {u for s in cv_spks for u in spk2utt[s]}
    for dst, keep in (
        (tr_dst, set(utt2spk) - cv_utts),
        (cv_dst, cv_utts),
    ):
        copy_data_dir(src, dst)
        for name in _ALL_UTT_FILES:
            p = os.path.join(dst, name)
            if os.path.exists(p):
                write_scp(p, filter_scp(keep, read_scp(p)))
        fix_data_dir(dst)
    return len(utt2spk) - len(cv_utts), len(cv_utts)


def librimix_to_kaldi(metadata_csv: str, out_dir: str) -> int:
    """LibriMix metadata CSV -> Kaldi dir: columns mixture_ID,
    mixture_path, source_1_path, source_2_path[, noise_path]. utt2spk uses
    '{spk1}_{spk2}' composite speakers."""
    import csv

    os.makedirs(out_dir, exist_ok=True)
    wav, u2s, spk1, spk2, noise = {}, {}, {}, {}, {}
    with open(metadata_csv) as f:
        reader = csv.DictReader(f)
        for row in reader:
            utt = row["mixture_ID"]
            wav[utt] = row["mixture_path"]
            parts = utt.split("_")
            s1 = parts[0].split("-")[0]
            s2 = parts[1].split("-")[0] if len(parts) > 1 else s1
            u2s[utt] = f"{s1}_{s2}"
            if row.get("source_1_path"):
                spk1[utt] = row["source_1_path"]
            if row.get("source_2_path"):
                spk2[utt] = row["source_2_path"]
            if row.get("noise_path"):
                noise[utt] = row["noise_path"]
    write_scp(os.path.join(out_dir, "wav.scp"), wav)
    write_scp(os.path.join(out_dir, "utt2spk"), u2s)
    write_spk2utt(os.path.join(out_dir, "spk2utt"), utt2spk_to_spk2utt(u2s))
    if spk1:
        write_scp(os.path.join(out_dir, "spk1.scp"), spk1)
    if spk2:
        write_scp(os.path.join(out_dir, "spk2.scp"), spk2)
    if noise:
        write_scp(os.path.join(out_dir, "noise1.scp"), noise)
    return len(wav)


def remove_dup_utts(data_dir: str, max_count: int = 10) -> int:
    """utils/data/remove_dup_utts.sh: keep at most ``max_count`` utterances
    per distinct transcript (combats mass-repeated prompts). Returns kept."""
    text_p = os.path.join(data_dir, "text")
    if not os.path.exists(text_p):
        return fix_data_dir(data_dir)
    text = read_scp(text_p)
    counts: Dict[str, int] = {}
    keep = {}
    for utt in sorted(text):
        t = text[utt]
        counts[t] = counts.get(t, 0) + 1
        if counts[t] <= max_count:
            keep[utt] = t
    write_scp(text_p, keep)
    return fix_data_dir(data_dir)


def resample_data_dir(
    data_dir: str, out_dir: str, target_rate: int = 16000
) -> int:
    """utils/data/resample_data_dir.sh equivalent: rewrite every wav at the
    target rate (polyphase resampling via scipy) into ``out_dir/wavs`` and
    emit the updated dir (in-process, where Kaldi shells out to sox)."""
    from math import gcd

    from scipy.signal import resample_poly

    wav = read_scp(os.path.join(data_dir, "wav.scp"))
    copy_data_dir(data_dir, out_dir)
    os.makedirs(os.path.join(out_dir, "wavs"), exist_ok=True)
    new_wav = {}
    for utt, p in wav.items():
        audio, sr = read_wav(p.split()[0])
        if sr != target_rate:
            g = gcd(sr, target_rate)
            audio = resample_poly(audio, target_rate // g, sr // g).astype(
                np.float32
            )
        out_p = os.path.join(out_dir, "wavs", f"{utt}.wav")
        write_wav(out_p, audio, target_rate)
        new_wav[utt] = out_p
    write_scp(os.path.join(out_dir, "wav.scp"), new_wav)
    return len(new_wav)


def get_segments_for_data(data_dir: str) -> int:
    """utils/data/get_segments_for_data.sh: emit a whole-recording
    ``segments`` file (utt = recording, 0 .. duration)."""
    wav = read_scp(os.path.join(data_dir, "wav.scp"))
    segs = {}
    for utt, p in wav.items():
        audio, sr = read_wav(p.split()[0])
        segs[utt] = f"{utt} 0.000 {audio.shape[0] / sr:.3f}"
    write_scp(os.path.join(data_dir, "segments"), segs)
    return len(segs)


def extend_segment_times(
    lines: Sequence[str],
    start_padding: float = 0.1,
    end_padding: float = 0.1,
    last_segment_end_padding: float = 0.1,
    fix_overlapping_segments: bool = True,
) -> Tuple[List[str], int]:
    """utils/data/extend_segment_times.py equivalent: pad each segment's
    [start, end] by the given left/right context, clamp to [0,
    max_end + last_segment_end_padding] per recording, and (optionally)
    split overlaps at the midpoint between per-recording neighbours sorted
    by mid-time. Input/output rows: ``utt reco start end``; original order
    preserved; rows whose times are non-increasing after processing are
    dropped (as Kaldi's script does). Returns (out_lines, n_overlap_fixes).
    """
    entries: List[List] = []
    by_reco: Dict[str, List[int]] = {}
    for line in lines:
        parts = line.split()
        if len(parts) != 4:
            raise ValueError(f"bad segments line: {line!r}")
        utt, reco, start, end = parts[0], parts[1], float(parts[2]), float(parts[3])
        by_reco.setdefault(reco, []).append(len(entries))
        entries.append([utt, reco, start, end])

    n_fixed = 0
    for reco, idxs in by_reco.items():
        this = sorted(
            (entries[i] for i in idxs), key=lambda e: 0.5 * (e[2] + e[3])
        )
        max_time = max(e[3] for e in this) + last_segment_end_padding
        for e in this:
            e[2] = max(0.0, e[2] - start_padding)
            e[3] = min(max_time, e[3] + end_padding)
        if fix_overlapping_segments:
            for a, b in zip(this, this[1:]):
                if a[3] > b[2]:
                    mid = 0.5 * (a[3] + b[2])
                    a[3] = mid
                    b[2] = mid
                    n_fixed += 1

    out = []
    for utt, reco, start, end in entries:
        if not start < end:
            continue
        out.append(f"{utt} {reco} {start:.6g} {end:.6g}")
    return out, n_fixed


def extend_segment_times_file(
    data_dir: str,
    start_padding: float = 0.1,
    end_padding: float = 0.1,
    last_segment_end_padding: float = 0.1,
    fix_overlapping_segments: bool = True,
) -> int:
    """In-place ``segments`` rewrite for a data dir; returns #overlap fixes."""
    path = os.path.join(data_dir, "segments")
    with open(path) as f:
        lines = [ln for ln in (l.strip() for l in f) if ln]
    out, n_fixed = extend_segment_times(
        lines, start_padding, end_padding,
        last_segment_end_padding, fix_overlapping_segments,
    )
    with open(path, "w") as f:
        f.write("\n".join(out) + ("\n" if out else ""))
    return n_fixed


def create_data_links(
    file_paths: Sequence[str], storage_dirs: Sequence[str]
) -> List[str]:
    """utils/create_data_link.pl: distribute target files across storage
    roots and plant symlinks at the original paths (cross-filesystem data
    spreading). Returns the real storage paths."""
    out = []
    for i, path in enumerate(file_paths):
        path = os.path.abspath(path)
        storage = os.path.abspath(storage_dirs[i % len(storage_dirs)])
        os.makedirs(storage, exist_ok=True)
        real = os.path.join(storage, os.path.basename(path))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if os.path.islink(path):
            os.unlink(path)
        elif os.path.exists(path):
            os.replace(path, real)
        if not os.path.exists(real):
            open(real, "wb").close()  # placeholder target
        os.symlink(real, path)
        out.append(real)
    return out


# ---------------- enrollment ----------------


def read_spk2enroll(path: str) -> Dict[str, List[Tuple[str, str]]]:
    """spk2enroll.json: {spk: [[utt_id, wav_path], ...]}."""
    with open(path) as f:
        return {k: [tuple(x) for x in v] for k, v in json.load(f).items()}


def write_spk2enroll(path: str, spk2enroll: Dict[str, List[Tuple[str, str]]]) -> None:
    with open(path, "w") as f:
        json.dump({k: [list(x) for x in v] for k, v in spk2enroll.items()}, f)


def is_lazy_enrollment(value: str) -> bool:
    """Train-mode rows are ``*<utt_id> <spk_id>``: the enrollment is chosen
    at load time."""
    return value.startswith("*")


def parse_lazy_enrollment(value: str) -> Tuple[str, str]:
    utt, spk = value.split()
    return utt[1:], spk


def resolve_enrollment(
    value: str,
    spk2enroll: Optional[Dict[str, List[Tuple[str, str]]]],
    rng: Optional[np.random.Generator] = None,
    exclude_utt: Optional[str] = None,
) -> str:
    """An enroll.scp row as a concrete wav path. Lazy rows pick a random
    enrollment of the speaker, excluding the mixture's own utterance."""
    return resolve_enrollment_entry(value, spk2enroll, rng, exclude_utt)[1]


def resolve_enrollment_entry(
    value: str,
    spk2enroll: Optional[Dict[str, List[Tuple[str, str]]]],
    rng: Optional[np.random.Generator] = None,
    exclude_utt: Optional[str] = None,
) -> Tuple[Optional[str], str]:
    """Like :func:`resolve_enrollment` but returns ``(enroll_utt, path)``;
    non-lazy rows return ``(None, path)``. One ``rng.integers`` draw for a
    lazy row, none otherwise (the JAX package's draws, in its order)."""
    if not is_lazy_enrollment(value):
        return None, value
    src_utt, spk = parse_lazy_enrollment(value)
    if spk2enroll is None or spk not in spk2enroll:
        raise KeyError(f"no enrollment pool for speaker {spk}")
    # never the row's own source utterance, nor a caller-given id (the
    # mixture row's)
    excluded = {src_utt, exclude_utt}
    pool = [(u, p) for u, p in spk2enroll[spk] if u not in excluded] or list(spk2enroll[spk])
    rng = rng or np.random.default_rng()
    return pool[int(rng.integers(len(pool)))]


# ---------------- wav IO ----------------


def pcm_to_float(data: np.ndarray) -> np.ndarray:
    """scipy's WAV sample array -> mono float32 in [-1, 1]."""
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV or FLAC file to float32 [-1, 1]; returns (audio,
    sample_rate)."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"fLaC":
        from . import native_loader

        if not native_loader.available():
            raise RuntimeError(f"{path}: FLAC needs the native reader, which could not be built")
        n, sr = native_loader.num_samples(path)
        batch, _ = native_loader.load_batch([path], n, expect_rate=0)
        return batch[0], sr
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    return pcm_to_float(data), int(sr)


def write_wav(path: str, audio: np.ndarray, sr: int = 16000) -> None:
    """Write float32 [-1, 1] as 16-bit PCM."""
    from scipy.io import wavfile

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    pcm = np.clip(audio, -1.0, 1.0)
    wavfile.write(path, sr, (pcm * 32767.0).astype(np.int16))


def get_num_samples(path: str) -> int:
    """Samples in an audio file (``utt2num_samples``)."""
    audio, _ = read_wav(path)
    return int(audio.shape[0])
