"""The port's Kaldi readers, dataset and WER/CER scorer against the JAX
package's, on a data dir made by the JAX ``cli.datapre overlap`` (lazy
``*utt spk`` enrollment rows over a ``spk2enroll.json``)."""

import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from robustsq_whisper_tpu.data import dataset as jdataset
from robustsq_whisper_tpu.data import kaldi_io as jkio
from robustsq_whisper_tpu.decode import scorer as jscorer
from robustsq_whisper_tpu.tokenizer.whisper_tokenizer import load_tokenizer as jload
from robustsq_whisper_torch.data import collate as pcollate
from robustsq_whisper_torch.data import dataset as pdataset
from robustsq_whisper_torch.data import kaldi_io as pkio
from robustsq_whisper_torch.decode import scorer as pscorer
from robustsq_whisper_torch.tokenizer.whisper_tokenizer import load_tokenizer as pload

from tests.test_pipeline import _make_clean_dir

RANKS = os.path.join(os.path.dirname(__file__), "assets", "mini_ranks.tiktoken")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from robustsq_whisper_tpu.cli import datapre

    tmp = tmp_path_factory.mktemp("data")
    src = _make_clean_dir(tmp)
    out = str(tmp / "dump" / "train")
    assert datapre.main([
        "overlap", "--src_dir", src, "--out_dir", out, "--num_mixtures", "5", "--seed", "0",
    ]) == 0
    return out


@pytest.mark.parametrize("name", ["wav.scp", "text", "utt2spk", "enroll.scp"])
def test_read_scp_equals_jax(data_dir, name):
    path = os.path.join(data_dir, name)
    assert pkio.read_scp(path) == jkio.read_scp(path)


def test_scp_and_spk2enroll_round_trip(data_dir, tmp_path):
    s2e = pkio.read_spk2enroll(os.path.join(data_dir, "spk2enroll.json"))
    assert s2e == jkio.read_spk2enroll(os.path.join(data_dir, "spk2enroll.json"))
    pkio.write_spk2enroll(str(tmp_path / "s2e.json"), s2e)
    assert jkio.read_spk2enroll(str(tmp_path / "s2e.json")) == s2e
    text = pkio.read_scp(os.path.join(data_dir, "text"))
    pkio.write_scp(str(tmp_path / "sub" / "text"), text)
    jkio.write_scp(str(tmp_path / "jtext"), text)
    assert open(tmp_path / "sub" / "text").read() == open(tmp_path / "jtext").read()


def test_lazy_enrollment_draws_equal_jax(data_dir):
    enroll = pkio.read_scp(os.path.join(data_dir, "enroll.scp"))
    s2e = pkio.read_spk2enroll(os.path.join(data_dir, "spk2enroll.json"))
    assert all(pkio.is_lazy_enrollment(v) for v in enroll.values())
    prng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for utt, row in enroll.items():
        assert pkio.parse_lazy_enrollment(row) == jkio.parse_lazy_enrollment(row)
        assert pkio.resolve_enrollment_entry(row, s2e, prng, utt) == (
            jkio.resolve_enrollment_entry(row, s2e, jrng, utt)
        )
    assert pkio.resolve_enrollment("/a.wav", s2e) == "/a.wav"
    with pytest.raises(KeyError):
        pkio.resolve_enrollment("*x-0 999", s2e)


def test_read_wav_equals_jax(data_dir, tmp_path):
    for path in list(pkio.read_scp(os.path.join(data_dir, "wav.scp")).values())[:3]:
        (a, sr), (b, jsr) = pkio.read_wav(path), jkio.read_wav(path)
        assert sr == jsr == 16000 and a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    x = np.sin(np.arange(800) / 7.0).astype(np.float32) * 0.5
    pkio.write_wav(str(tmp_path / "x.wav"), x)
    np.testing.assert_array_equal(pkio.read_wav(str(tmp_path / "x.wav"))[0],
                                  jkio.read_wav(str(tmp_path / "x.wav"))[0])


def test_flac_raises(tmp_path):
    """A FLAC file goes to the native reader (tests/test_torch_native.py
    holds it to the JAX decoder), which raises for one with no STREAMINFO."""
    path = tmp_path / "a.flac"
    path.write_bytes(b"fLaC" + bytes(64))
    with pytest.raises(IOError, match="cannot parse the audio header"):
        pkio.read_wav(str(path))


@pytest.mark.parametrize("shuffle", [False, True])
def test_dataset_batches_equal_jax(data_dir, shuffle):
    kw = dict(speech_seconds=0.64, enroll_seconds=0.32, seed=7)
    pds = pdataset.KaldiTSDataset(data_dir, pload(RANKS), **kw)
    jds = jdataset.KaldiTSDataset(data_dir, jload(RANKS), **kw)
    assert pds.utt_ids == jds.utt_ids and len(pds) == 10
    n = 0
    for _ in range(2):  # a second epoch draws new enrollments and crops
        pb = list(pds.batches(4, shuffle=shuffle, drop_last=False))
        jb = list(jds.batches(4, shuffle=shuffle, drop_last=False))
        assert len(pb) == len(jb) == 3
        for a, b in zip(pb, jb):
            assert a.keys() == b.keys() and a.pop("utt_ids") == b.pop("utt_ids")
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            n += 1
    assert n == 6


def test_dataset_embedding_enrollment_raises(data_dir):
    """Embedding enrollment needs the stage-103 scp: without one both
    packages raise the same FileNotFoundError; an unknown enrollment type is
    a ValueError."""
    msgs = []
    for mod, load in ((pdataset, pload), (jdataset, jload)):
        with pytest.raises(FileNotFoundError) as e:
            mod.KaldiTSDataset(data_dir, load(None), enroll_type="embedding")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "resnet.scp" in msgs[0]
    with pytest.raises(ValueError, match="audio|embedding"):
        pdataset.KaldiTSDataset(data_dir, pload(None), enroll_type="xvector")


def test_collate_parsers_equal_jax():
    from robustsq_whisper_tpu.data import collate as jcollate

    utts = ["noisy_100-1-0004_1089-1-0000_spk1", "aug_100-2-0001_200-1-0000_spk2",
            "200-1-0000_100-1-0002_spk1"]
    for f in ("similarity_matrix", "negative_logits"):
        np.testing.assert_array_equal(getattr(pcollate, f)(utts), getattr(jcollate, f)(utts))
    np.testing.assert_array_equal(
        pcollate.speaker_labels(utts, num_speakers=2), jcollate.speaker_labels(utts, num_speakers=2)
    )
    for style, u in (("wsj2mix", "a_b_40ac0101"), ("ami", "AMI_ES2011a_H00_MEE068_0000")):
        assert pcollate.parse_speaker(u, style) == jcollate.parse_speaker(u, style)


WORDS = st.lists(st.sampled_from(["a", "the", "cat", "sat", "on", "mat", "ü", "z"]), max_size=9)
SENT = WORDS.map(" ".join)


@settings(max_examples=150, deadline=None)
@given(pairs=st.lists(st.tuples(SENT, SENT), max_size=5))
def test_wer_cer_equal_jax(pairs):
    refs = [r for r, _ in pairs]
    hyps = [h for _, h in pairs]
    assert pscorer.wer(refs, hyps) == jscorer.wer(refs, hyps)
    assert pscorer.cer(refs, hyps) == jscorer.cer(refs, hyps)
