"""The port's data preparation (``data/kaldi_io.py``'s tools,
``data/simulate.py`` and ``cli.datapre``) against the JAX package's, on the
CPU: both run the same operation in the same directory, one after the
other, and every file they leave must be the same bytes (paths inside the
files included), every return value and JSON line the same."""

import json
import os
import shutil

import numpy as np
import pytest

from robustsq_whisper_tpu.cli import datapre as jcli
from robustsq_whisper_tpu.data import kaldi_io as jkio
from robustsq_whisper_tpu.data import simulate as jsim
from robustsq_whisper_torch.cli import datapre as pcli
from robustsq_whisper_torch.data import kaldi_io as pkio
from robustsq_whisper_torch.data import simulate as psim

SR = 16000
PKGS = {"jax": (jkio, jsim, jcli), "torch": (pkio, psim, pcli)}


def snapshot(root):
    """{relative path: bytes} of every file under ``root`` (a symlink as
    its target's path)."""
    out = {}
    for cur, _, files in os.walk(root):
        for f in files:
            p = os.path.join(cur, f)
            rel = os.path.relpath(p, root)
            if os.path.islink(p):
                out[rel] = ("->", os.readlink(p))
            else:
                with open(p, "rb") as fh:
                    out[rel] = fh.read()
    return out


def both(work, setup, op):
    """``setup(work)`` then ``op(kaldi_io, simulate, cli, work)`` for each
    package in a fresh ``work``; asserts the same files and the same
    return value, and returns the port's."""
    results = {}
    for name, mods in PKGS.items():
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        setup(work)
        value = op(*mods, work)
        results[name] = (value, snapshot(work))
    (jv, jfiles), (pv, pfiles) = results["jax"], results["torch"]
    assert sorted(pfiles) == sorted(jfiles)
    for rel in jfiles:
        assert pfiles[rel] == jfiles[rel], rel
    assert pv == jv
    return pv, pfiles


# ---------------- inputs ----------------


def clean(work, n_spk=3, n_utt=2, seconds=0.5):
    """A synthetic clean dir (the JAX package's generator: the inputs do not
    depend on the package under test)."""
    d = os.path.join(work, "clean")
    jsim.generate_synth_clean_dir(d, n_speakers=n_spk, utts_per_spk=n_utt, seconds=seconds)
    return d


def noise_dir(work):
    d = os.path.join(work, "noise")
    rng = np.random.default_rng(7)
    for i, n in enumerate((3000, 12000)):  # one shorter than an utterance: tiled
        jkio.write_wav(os.path.join(d, f"n{i}.wav"), (0.2 * rng.standard_normal(n)).astype(np.float32))
    with open(os.path.join(d, "readme.txt"), "w") as f:
        f.write("not a wav\n")
    return d


def mixed(work):
    d = os.path.join(work, "mix")
    jsim.generate_overlap_enrollment(clean(work), d, jsim.OverlapConfig(num_mixtures=3, seed=1))
    return d


def broken(work):
    """A dir whose files disagree: an extra text row, a missing utt2spk
    row, unsorted keys."""
    d = mixed(work)
    text = jkio.read_scp(os.path.join(d, "text"))
    text["zzz_extra"] = "stray row"
    jkio.write_scp(os.path.join(d, "text"), text, sort=False)
    u2s = jkio.read_scp(os.path.join(d, "utt2spk"))
    u2s.pop(sorted(u2s)[0])
    jkio.write_scp(os.path.join(d, "utt2spk"), dict(reversed(list(u2s.items()))), sort=False)
    return d


def segments(work):
    d = mixed(work)
    wav = sorted(jkio.read_scp(os.path.join(d, "wav.scp")))
    rows = [f"{wav[0]} rec1 0.00 1.20", f"{wav[1]} rec1 1.15 2.50", f"{wav[2]} rec1 2.40 2.45",
            f"{wav[3]} rec2 0.05 0.90"]
    with open(os.path.join(d, "segments"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return d


def sglspk_mix(work):
    d = mixed(work)
    wav = jkio.read_scp(os.path.join(d, "wav.scp"))
    mix = {u.rsplit("_spk", 1)[0]: p for u, p in wav.items()}
    src = os.path.join(work, "mix2")
    jkio.write_scp(os.path.join(src, "wav.scp"), mix)
    jkio.write_scp(os.path.join(src, "text_spk1"), {u: f"first {u[:3]}" for u in mix})
    jkio.write_scp(os.path.join(src, "spk2.scp"), {u: "777" for u in list(mix)[:1]})
    return src


# ---------------- kaldi_io tools ----------------


KALDI_CASES = {
    "utt2spk_to_spk2utt": (lambda w: None, lambda k, s, c, w: k.utt2spk_to_spk2utt(
        {"b1": "s2", "a1": "s1", "a2": "s1", "c": "s3"})),
    "spk2utt_to_utt2spk": (lambda w: None, lambda k, s, c, w: k.spk2utt_to_utt2spk(
        {"s2": ["b2", "b1"], "s1": ["a1"]})),
    "filter_scp": (lambda w: None, lambda k, s, c, w: k.filter_scp(
        ["a", "c", "x"], {"a": "1", "b": "2", "c": "3"})),
    "subset_scp": (lambda w: None, lambda k, s, c, w: (
        k.subset_scp({"c": "3", "a": "1", "b": "2"}, 2),
        k.subset_scp({"c": "3", "a": "1", "b": "2"}, 2, first=False))),
    "shuffle_list": (lambda w: None, lambda k, s, c, w: k.shuffle_list([f"u{i}" for i in range(9)], 5)),
    "apply_map": (lambda w: None, lambda k, s, c, w: k.apply_map(
        {"u1": "a b c", "u2": "b"}, {"a": "A", "b": "B"})),
    "write_utt2dur": (clean, lambda k, s, c, w: k.write_utt2dur(os.path.join(w, "clean"))),
    "validate_data_dir": (broken, lambda k, s, c, w: (
        k.validate_data_dir(os.path.join(w, "mix")),
        k.validate_data_dir(os.path.join(w, "mix"), require_text=False, check_wav_exists=True))),
    "fix_data_dir": (broken, lambda k, s, c, w: k.fix_data_dir(os.path.join(w, "mix"))),
    "copy_data_dir": (mixed, lambda k, s, c, w: k.copy_data_dir(
        os.path.join(w, "mix"), os.path.join(w, "copy"), utt_prefix="sp1.1-")),
    "combine_data_dirs": (lambda w: (mixed(w), k_copy(w)), lambda k, s, c, w: k.combine_data_dirs(
        [os.path.join(w, "mix"), os.path.join(w, "mix_b")], os.path.join(w, "all"))),
    "subset_data_dir": (mixed, lambda k, s, c, w: k.subset_data_dir(
        os.path.join(w, "mix"), os.path.join(w, "sub"), 3, first=False)),
    "split_data_dir_tr_cv": (mixed, lambda k, s, c, w: k.split_data_dir_tr_cv(
        os.path.join(w, "mix"), os.path.join(w, "tr"), os.path.join(w, "cv"), 0.4, seed=3)),
    "librimix_to_kaldi": (lambda w: librimix_csv(w), lambda k, s, c, w: k.librimix_to_kaldi(
        os.path.join(w, "meta.csv"), os.path.join(w, "lm"))),
    "remove_dup_utts": (lambda w: dup_text(w), lambda k, s, c, w: k.remove_dup_utts(
        os.path.join(w, "mix"), max_count=1)),
    "resample_data_dir": (lambda w: clean(w, 2, 1), lambda k, s, c, w: k.resample_data_dir(
        os.path.join(w, "clean"), os.path.join(w, "rs"), target_rate=8000)),
    "get_segments_for_data": (lambda w: clean(w, 2, 1), lambda k, s, c, w: k.get_segments_for_data(
        os.path.join(w, "clean"))),
    "extend_segment_times": (lambda w: None, lambda k, s, c, w: k.extend_segment_times(
        ["u1 r 0.0 1.0", "u2 r 0.95 2.0", "u3 r 2.05 2.06", "u4 q 3.0 3.5"], 0.1, 0.2, 0.3)),
    "extend_segment_times_file": (segments, lambda k, s, c, w: k.extend_segment_times_file(
        os.path.join(w, "mix"), fix_overlapping_segments=False)),
    "create_data_links": (lambda w: links(w), lambda k, s, c, w: [os.path.relpath(p, w) for p in
        k.create_data_links([os.path.join(w, "data", f"f{i}.ark") for i in range(3)],
                            [os.path.join(w, "s1"), os.path.join(w, "s2")])]),
    "get_num_samples": (lambda w: clean(w, 1, 1), lambda k, s, c, w: k.get_num_samples(
        os.path.join(w, "clean", "wavs", "100-0-0000.wav"))),
}


def k_copy(work):
    jkio.copy_data_dir(os.path.join(work, "mix"), os.path.join(work, "mix_b"), utt_prefix="b-")


def librimix_csv(work):
    rows = ["mixture_ID,mixture_path,source_1_path,source_2_path,noise_path",
            "19-198-0001_26-495-0000,/m/a.wav,/s1/a.wav,/s2/a.wav,/n/a.wav",
            "103-1240-0003_1034-121119-0002,/m/b.wav,/s1/b.wav,/s2/b.wav,"]
    with open(os.path.join(work, "meta.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


def dup_text(work):
    d = mixed(work)
    text = jkio.read_scp(os.path.join(d, "text"))
    jkio.write_scp(os.path.join(d, "text"), {u: "same words" for u in text})


def links(work):
    os.makedirs(os.path.join(work, "data"))
    with open(os.path.join(work, "data", "f0.ark"), "w") as f:
        f.write("existing\n")


@pytest.mark.parametrize("case", list(KALDI_CASES))
def test_kaldi_io_tool_equals_jax(tmp_path, case):
    setup, op = KALDI_CASES[case]
    both(str(tmp_path / "work"), setup, op)


# ---------------- simulate ----------------


def _audio(seed, n=4000, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


SIGNAL_CASES = {
    "mix_audio_with_sir": lambda s: s.mix_audio_with_sir(_audio(0), _audio(1, 3000), -3.5),
    "mix_audio_with_sir_silent": lambda s: s.mix_audio_with_sir(_audio(0), np.zeros(10, np.float32), 2.0),
    "add_noise_with_snr": lambda s: s.add_noise_with_snr(_audio(0), _audio(2), 12.5),
    "calculate_lufs": lambda s: np.float64([s.calculate_lufs(_audio(0)), s.calculate_lufs(np.zeros(5))]),
    "add_noise_with_lufs": lambda s: s.add_noise_with_lufs(_audio(0), _audio(3), -33.0),
    "clip_to_prevent_clipping": lambda s: s.clip_to_prevent_clipping(_audio(0, scale=2.0)),
    "get_random_noise_segment": lambda s: np.concatenate([
        s.get_random_noise_segment(_audio(4, 900), 2000, np.random.default_rng(5)),
        s.get_random_noise_segment(_audio(4, 9000), 2000, np.random.default_rng(6))]),
}


@pytest.mark.parametrize("case", list(SIGNAL_CASES))
def test_signal_function_equals_jax(case):
    """The same numpy operations on the same arrays: bit for bit."""
    want, got = SIGNAL_CASES[case](jsim), SIGNAL_CASES[case](psim)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


SIM_CASES = {
    "generate_overlap_enrollment": (clean, lambda k, s, c, w: s.generate_overlap_enrollment(
        os.path.join(w, "clean"), os.path.join(w, "ov"),
        s.OverlapConfig(sir_min=-2.0, sir_max=4.0, num_mixtures=4, seed=9))),
    "add_wham_noise_snr": (lambda w: (mixed(w), noise_dir(w)), lambda k, s, c, w: s.add_wham_noise(
        os.path.join(w, "mix"), os.path.join(w, "noise"), os.path.join(w, "noisy"),
        s.NoiseConfig(seed=4))),
    "add_wham_noise_lufs": (lambda w: (mixed(w), noise_dir(w)), lambda k, s, c, w: s.add_wham_noise(
        os.path.join(w, "mix"), os.path.join(w, "noise"), os.path.join(w, "noisy"),
        s.NoiseConfig(mode="lufs", seed=5))),
    "format_sglspk_dataset": (sglspk_mix, lambda k, s, c, w: s.format_sglspk_dataset(
        os.path.join(w, "mix2"), os.path.join(w, "sgl"))),
    "generate_synth_clean_dir": (lambda w: None, lambda k, s, c, w: s.generate_synth_clean_dir(
        os.path.join(w, "synth"), n_speakers=2, utts_per_spk=2, seconds=0.25, seed=3)),
    "librispeech_to_kaldi": (lambda w: libri_tree(w), lambda k, s, c, w: s.librispeech_to_kaldi(
        os.path.join(w, "LibriSpeech"), os.path.join(w, "kaldi"))),
    "build_spk2enroll_json": (lambda w: libri_tree(w), lambda k, s, c, w: s.build_spk2enroll_json(
        os.path.join(w, "LibriSpeech"), os.path.join(w, "spk2enroll.json"))),
    "build_enrollment_scp": (mixed, lambda k, s, c, w: (
        s.build_enrollment_scp(os.path.join(w, "mix"), os.path.join(w, "train.scp")),
        s.build_enrollment_scp(os.path.join(w, "mix"), os.path.join(w, "eval.scp"), train=False,
                               seed=2))),
}


def libri_tree(work):
    """{spk}/{chapter}/{spk}-{chapter}-{utt}.wav with transcripts and a
    SPEAKERS.TXT."""
    root = os.path.join(work, "LibriSpeech")
    for spk, chapter in (("19", "198"), ("26", "495"), ("26", "496")):
        d = os.path.join(root, spk, chapter)
        lines = []
        for u in range(2):
            utt = f"{spk}-{chapter}-{u:04d}"
            jkio.write_wav(os.path.join(d, f"{utt}.wav"), _audio(int(spk) + u, 800))
            lines.append(f"{utt} WORDS OF {utt}")
        with open(os.path.join(d, f"{spk}-{chapter}.trans.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "SPEAKERS.TXT"), "w") as f:
        f.write("; ID | SEX | SUBSET\n19 | F | train\n26 | M | train\n")


@pytest.mark.parametrize("case", list(SIM_CASES))
def test_simulate_equals_jax(tmp_path, case):
    setup, op = SIM_CASES[case]
    both(str(tmp_path / "work"), setup, op)


# ---------------- cli.datapre ----------------


def _argv(w, *parts):
    return [p.format(w=w) for p in parts]


CLI_CASES = {  # subcommand case: (setup, argv)
    "overlap": (clean, ("overlap", "--src_dir", "{w}/clean", "--out_dir", "{w}/ov",
                        "--num_mixtures", "5", "--sir_min", "-5", "--sir_max", "5", "--seed", "3")),
    "wham-snr": (lambda w: (mixed(w), noise_dir(w)), (
        "wham", "--clean_dir", "{w}/mix", "--noise_dir", "{w}/noise", "--out_dir", "{w}/noisy",
        "--snr_min", "10", "--snr_max", "20", "--seed", "8")),
    "wham-lufs": (lambda w: (mixed(w), noise_dir(w)), (
        "wham", "--clean_dir", "{w}/mix", "--noise_dir", "{w}/noise", "--out_dir", "{w}/noisy",
        "--mode", "lufs", "--lufs_min", "-36", "--lufs_max", "-31")),
    "enroll-json": (clean, ("enroll-json", "--librispeech_root", "{w}/clean/wavs", "--out",
                            "{w}/spk2enroll.json")),
    "enroll-scp-train": (mixed, ("enroll-scp", "--data_dir", "{w}/mix", "--out", "{w}/e.scp")),
    "enroll-scp-eval": (mixed, ("enroll-scp", "--data_dir", "{w}/mix", "--out", "{w}/e.scp",
                                "--mode", "eval", "--spk2enroll", "{w}/mix/spk2enroll.json",
                                "--seed", "4")),
    "format-sglspk": (sglspk_mix, ("format-sglspk", "--mix_dir", "{w}/mix2", "--out_dir",
                                   "{w}/sgl")),
    "validate-ok": (mixed, ("validate", "{w}/mix")),
    "validate-problems": (broken, ("validate", "{w}/mix")),
    "validate-no-text": (lambda w: os.remove(os.path.join(mixed(w), "text")),
                         ("validate", "{w}/mix", "--no-text")),
    "fix": (broken, ("fix", "{w}/mix")),
    "num-samples": (mixed, ("num-samples", "{w}/mix")),
    "extend-segments": (segments, ("extend-segments", "{w}/mix", "--start_padding", "0.2",
                                   "--fix_overlapping_segments", "true")),
    "synth-clean": (lambda w: None, ("synth-clean", "--out_dir", "{w}/synth", "--n_speakers", "2",
                                     "--utts_per_spk", "2", "--seconds", "0.25", "--seed", "1")),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_subcommand_equals_jax(tmp_path, capsys, case):
    """Both CLIs on the same inputs: the same files, exit code and JSON
    line (``validate`` prints its problems to stderr and exits 1)."""
    setup, parts = CLI_CASES[case]
    work = str(tmp_path / "work")
    outs = []

    def op(kio, sim, cli, w):
        capsys.readouterr()
        rc = cli.main(_argv(w, *parts))
        out, err = capsys.readouterr()
        outs.append(out)
        return rc, out.strip().splitlines()[-1], err

    (rc, line, err), _ = both(work, setup, op)
    stats = json.loads(line)
    if case == "validate-problems":
        assert rc == 1 and not stats["valid"] and stats["problems"] >= 2 and "PROBLEM:" in err
    else:
        assert rc == 0
    if case == "overlap":
        assert stats == {"num_mixtures": 5, "num_rows": 10}


def test_cli_spk_embed_flags():
    """``spk-embed`` takes the JAX CLI's flags plus ``--device`` (default
    cuda); without CUDA it raises rather than running on the host."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pcli.main(["spk-embed", "--data_dir", "/nonexistent", "--out_dir", "/nonexistent"])
