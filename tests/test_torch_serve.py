"""The port's HTTP daemon against the JAX package's engine.

The tiny model of ``tests/test_serve.py`` (flax init, converted with
``convert.load_flax``): concurrent ``POST /v1/transcribe`` requests with
base64 WAV bodies must return the JAX engine's texts for the same audio;
unknown paths give 404 and oversized bodies 413; the admission bound sheds
with 503 and ``close()`` fails what is still queued. The engine stages
its batches with the decode jobs' frontend, and both sub-batch the encoder
through ``build_decode_fns``; a tiny port model with timestamp tokens
decodes a data set through ``decode_dataset``."""

import base64
import io
import json
import queue
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from robustsq_whisper_tpu.decode.search import DecodeConfig as JDecodeConfig
from robustsq_whisper_tpu.models import QFormerTSEncoder as JEnc
from robustsq_whisper_tpu.models import TSDecoder as JDec
from robustsq_whisper_tpu.models import TSEncoderConfig as JTS
from robustsq_whisper_tpu.models import WhisperDims as JDims
from robustsq_whisper_tpu.serve import EngineConfig as JEngineConfig
from robustsq_whisper_tpu.serve import TranscriptionEngine as JEngine
from robustsq_whisper_tpu.tokenizer.whisper_tokenizer import load_tokenizer as jload
from robustsq_whisper_torch.audio import frontend as tfront
from robustsq_whisper_torch.convert import load_flax
from robustsq_whisper_torch.decode.pipeline import decode_dataset
from robustsq_whisper_torch.decode.search import DecodeConfig
from robustsq_whisper_torch.init import init_params
from robustsq_whisper_torch.models import QFormerTSEncoder, TSDecoder, TSEncoderConfig, WhisperDims
from robustsq_whisper_torch.serve import EngineConfig, MicroBatcher, TranscriptionEngine
from robustsq_whisper_torch.serve import audio_from_bytes, make_server
from robustsq_whisper_torch.tokenizer import load_tokenizer

DIMS = dict(
    n_mels=80, n_vocab=50, n_audio_ctx=16, n_audio_state=32,
    n_audio_head=2, n_audio_layer=1, n_text_ctx=64, n_text_state=32,
    n_text_head=2, n_text_layer=2,
)
TS = dict(
    num_query_tokens=2, num_hidden_layers=1, qformer_hidden_size=48,
    qformer_heads=4, qformer_intermediate_size=96,
)
DCFG = dict(max_new_tokens=6, eot=2, init_tokens=(1,), beam_size=1)
ECFG = dict(batch_size=4, speech_seconds=0.32, enroll_seconds=0.20)
SR = 16000


def _wav(seed, seconds):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(seconds * SR)) * 0.1).astype(np.float32)


def _wav_bytes(audio):
    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, SR, (np.clip(audio, -1, 1) * 32767).astype(np.int16))
    return buf.getvalue()


@pytest.fixture(scope="module")
def engines():
    enc = JEnc(JDims(**DIMS), JTS(**TS))
    feats = jnp.zeros((1, 80, 2 * DIMS["n_audio_ctx"]), jnp.float32)
    efeats = jnp.zeros((1, 80, 20), jnp.float32)
    enc_vars = enc.init(jax.random.PRNGKey(0), feats, None, efeats, None)
    dec = JDec(JDims(**DIMS), startofprev_token=3)
    rng = np.random.default_rng(0)
    memory = jnp.asarray(rng.standard_normal((2, 18, 32)), jnp.float32)
    prompt = jnp.asarray(rng.standard_normal((2, 2, 32)), jnp.float32)
    ys = jnp.asarray(rng.integers(0, 50, (2, 4)))
    dec_vars = dec.init(jax.random.PRNGKey(1), memory, ys, prompt)
    jeng = JEngine(enc, enc_vars, dec, dec_vars, jload(None), JDecodeConfig(**DCFG),
                   JEngineConfig(**ECFG))
    penc = load_flax(QFormerTSEncoder(WhisperDims(**DIMS), TSEncoderConfig(**TS)), enc_vars)
    pdec = load_flax(TSDecoder(WhisperDims(**DIMS), startofprev_token=3), dec_vars)
    peng = TranscriptionEngine(penc, pdec, load_tokenizer(None), DecodeConfig(**DCFG),
                               EngineConfig(**ECFG), device="cpu")
    return peng, jeng


class _Server:
    def __init__(self, engine, **kw):
        self.server, self.batcher = make_server(engine, "127.0.0.1", 0, **kw)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def url(self, path):
        return f"http://127.0.0.1:{self.port}{path}"

    def close(self):
        self.server.shutdown()
        self.batcher.close()
        self.server.server_close()
        self.thread.join(timeout=10)


def _post(url, body, out=None, idx=0):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        res = json.loads(resp.read())
    if out is not None:
        out[idx] = res
    return res


def test_http_texts_equal_jax_engine(engines):
    peng, jeng = engines
    items = [(_wav(10 + i, 0.16 + 0.04 * (i % 3)), _wav(30 + i, 0.12 + 0.02 * i))
             for i in range(6)]
    wavs = [(_wav_bytes(s), _wav_bytes(e)) for s, e in items]
    decoded = [(audio_from_bytes(s), audio_from_bytes(e)) for s, e in wavs]
    want = jeng.transcribe(decoded[:4]) + jeng.transcribe(decoded[4:])
    assert want == peng.transcribe(decoded[:4]) + peng.transcribe(decoded[4:])
    srv = _Server(peng, max_wait_ms=200.0, info={"model": "tiny"})
    try:
        out = [None] * len(items)
        threads = [
            threading.Thread(target=_post, args=(
                srv.url("/v1/transcribe"),
                {"speech_wav": base64.b64encode(s).decode(),
                 "enroll_wav": base64.b64encode(e).decode()},
                out, i))
            for i, (s, e) in enumerate(wavs)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert [o["text"] for o in out] == want
        assert all(o["latency_ms"] >= 0 for o in out)
        pcm = _post(srv.url("/v1/transcribe"), {"speech_pcm": decoded[0][0].tolist(),
                                                "enroll_pcm": decoded[0][1].tolist()})
        assert pcm["text"] == want[0]
        with urllib.request.urlopen(srv.url("/healthz"), timeout=30) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ok" and health["compiled"] and health["model"] == "tiny"
        assert health["batch_size"] == ECFG["batch_size"]
        with urllib.request.urlopen(srv.url("/stats"), timeout=30) as resp:
            stats = json.loads(resp.read())
        assert stats["requests"] == 7 and stats["errors"] == 0 and stats["shed"] == 0
        assert 2 <= stats["batches"] <= 7
    finally:
        srv.close()


def test_http_errors(engines):
    peng, _ = engines
    srv = _Server(peng, max_wait_ms=20.0, max_body_bytes=1024)
    try:
        for method_body, path in ((None, "/nope"), (b"{}", "/v2/transcribe")):
            req = urllib.request.Request(srv.url(path), data=method_body)
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req, timeout=30)
            assert e.value.code == 404
        big = json.dumps({"speech_pcm": [0.0] * 4096, "enroll_pcm": [0.0] * 16}).encode()
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(urllib.request.Request(srv.url("/v1/transcribe"), data=big),
                                   timeout=30)
        assert e.value.code == 413
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.url("/v1/transcribe"), {"speech_pcm": [0.0]})
        assert e.value.code == 400
    finally:
        srv.close()


class _BlockingEngine:
    """The engine, with staging held until ``release`` is set; ``entered``
    is set once the stager has closed its first batch and is held."""

    def __init__(self, engine):
        self.engine, self.cfg = engine, engine.cfg
        self.release = threading.Event()
        self.entered = threading.Event()
        self.compiled = False

    def stage(self, items):
        self.entered.set()
        self.release.wait(timeout=30)
        return self.engine.stage(items)

    def infer_staged(self, staged, n):
        return self.engine.infer_staged(staged, n)


def test_admission_bound_sheds_with_503(engines):
    peng, _ = engines
    slow = _BlockingEngine(peng)
    srv = _Server(slow, max_wait_ms=1.0, max_queue=2)
    try:
        futs = [srv.batcher.submit(_wav(0, 0.2), _wav(1, 0.1))]
        # the stager took the first one, closed its batch and blocks; an
        # empty queue alone would not show that it stopped gathering
        assert slow.entered.wait(timeout=10)
        futs += [srv.batcher.submit(_wav(i, 0.2), _wav(i, 0.1)) for i in (2, 3)]
        with pytest.raises(queue.Full):
            srv.batcher.submit(_wav(4, 0.2), _wav(4, 0.1))
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.url("/v1/transcribe"), {"speech_pcm": [0.0] * 100, "enroll_pcm": [0.0] * 50})
        assert e.value.code == 503 and e.value.headers["Retry-After"] == "1"
        assert srv.batcher.shed == 2
        slow.release.set()
        assert all(isinstance(f.result(timeout=120), str) for f in futs)
    finally:
        slow.release.set()
        srv.close()


def test_close_fails_pending(engines):
    peng, _ = engines
    slow = _BlockingEngine(peng)
    batcher = MicroBatcher(slow, max_wait_ms=1.0, max_queue=8)
    futs = [batcher.submit(_wav(i, 0.2), _wav(i + 9, 0.15)) for i in range(6)]
    time.sleep(0.1)  # the stager takes the first batch and blocks
    slow.release.set()
    batcher.close()
    assert all(f.done() for f in futs)  # a text or "server closing", none stranded
    assert not batcher._stager.is_alive() and not batcher._runner.is_alive()
    with pytest.raises(RuntimeError, match="closing"):
        batcher.submit(_wav(0, 0.2), _wav(1, 0.15))


def test_audio_from_bytes_round_trip():
    from robustsq_whisper_tpu.serve.server import audio_from_bytes as jaudio

    wav = _wav(42, 0.1)
    data = _wav_bytes(wav)
    back = audio_from_bytes(data, SR)
    np.testing.assert_array_equal(back, jaudio(data, SR))
    np.testing.assert_allclose(back, wav, atol=2 / 32768)
    with pytest.raises(ValueError):
        audio_from_bytes(data, 8000)
    # FLAC goes to the native decoder, as in the JAX package
    from tests.test_torch_native import _voice, encode_flac

    flac = encode_flac(_voice(1600, seed=1), ["fixed2"])
    np.testing.assert_array_equal(audio_from_bytes(flac, SR), jaudio(flac, SR))
    with pytest.raises(ValueError):
        audio_from_bytes(flac, 8000)
    with pytest.raises(IOError, match="cannot parse"):
        audio_from_bytes(b"fLaC" + bytes(32), SR)


def test_stage_is_the_host_pcm16_frontend(engines):
    """``stage()`` packs float rows (padded and cropped to the windows,
    spare rows repeating row 0) and sends them through ``pcm16_log_mel``:
    features and frame counts bit for bit those of the host int16 path."""
    peng, _ = engines
    speech = [_wav(1, 0.1), _wav(2, 0.5), _wav(3, 0.32)]  # short, long, full
    speech[0][7] = 1.5  # beyond full scale: int16 saturates
    speech[1][5] = -1.25
    enroll = [_wav(4, 0.05), _wav(5, 0.3), _wav(6, 0.2)]
    staged = peng.stage(list(zip(speech, enroll)))
    for k, (waves, seconds) in enumerate(((speech, ECFG["speech_seconds"]),
                                          (enroll, ECFG["enroll_seconds"]))):
        n = int(round(seconds * SR))
        rows = np.zeros((ECFG["batch_size"], n), np.float32)
        lens = np.zeros((ECFG["batch_size"],), np.int32)
        for i in range(ECFG["batch_size"]):
            w = waves[i if i < len(waves) else 0]
            lens[i] = min(len(w), n)
            rows[i, : lens[i]] = w[: lens[i]]
        x = tfront.pcm16_to_float(torch.from_numpy(tfront.to_pcm16(rows)))
        feats, flens = tfront.log_mel_spectrogram(x, torch.from_numpy(lens))
        assert torch.equal(staged[2 * k], feats) and torch.equal(staged[2 * k + 1], flens)


TINY = dict(DIMS, n_vocab=120)
TINY_DCFG = dict(max_new_tokens=8, eot=2, init_tokens=(1, 4))


class _Ids:
    """A tokenizer whose text is the token ids."""

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


class _Pool:
    """A data set of one batch: (speech, enrollment) rows of the windows of
    ``ECFG`` with their true lengths, and empty references."""

    sample_rate = SR

    def __init__(self, n):
        s_len, e_len = (int(round(ECFG[k] * SR)) for k in ("speech_seconds", "enroll_seconds"))
        self.items = [(_wav(50 + i, 0.12 + 0.1 * i), _wav(70 + i, 0.1)) for i in range(n)]
        self.batch = {"utt_ids": [f"u{i}" for i in range(n)],
                      "speech": np.zeros((n, s_len), np.float32),
                      "speech_lens": np.zeros((n,), np.int32),
                      "enroll": np.zeros((n, e_len), np.float32),
                      "enroll_lens": np.zeros((n,), np.int32)}
        for i, (sp, en) in enumerate(self.items):
            for key, wave in (("speech", sp), ("enroll", en)):
                ln = min(len(wave), self.batch[key].shape[1])
                self.batch[key][i, :ln], self.batch[key + "_lens"][i] = wave[:ln], ln
        self.text = {}

    def batches(self, batch_size, shuffle=False, drop_last=False):
        yield self.batch


def _tiny_modules():
    enc = init_params(QFormerTSEncoder(WhisperDims(**TINY), TSEncoderConfig(**TS)), 2).eval()
    dec = init_params(TSDecoder(WhisperDims(**TINY), startofprev_token=3), 3).eval()
    return enc, dec


@pytest.mark.parametrize("entry", ["decode_dataset", "TranscriptionEngine"])
def test_enc_chunk_one_gives_the_tokens_of_one_call(entry):
    """``enc_chunk=1`` encodes a row at a time inside ``encode``: the same
    tokens as the whole batch in one call, for the decode job and the
    serving engine."""
    enc, dec = _tiny_modules()
    rows = []
    enc.register_forward_pre_hook(lambda m, args: rows.append(args[0].shape[0]))
    pool = _Pool(3)
    out, calls = [], []
    for chunk in (0, 1):
        rows.clear()
        if entry == "decode_dataset":
            res = decode_dataset(enc, dec, pool, _Ids(), DecodeConfig(**TINY_DCFG), batch_size=3,
                                 enc_chunk=chunk, device="cpu")
            out.append(res.hyps)
        else:
            eng = TranscriptionEngine(enc, dec, _Ids(), DecodeConfig(**TINY_DCFG),
                                      EngineConfig(**ECFG, enc_chunk=chunk), device="cpu")
            out.append(eng.transcribe(pool.items))
        calls.append(list(rows))
    b = 3 if entry == "decode_dataset" else ECFG["batch_size"]
    assert calls == [[b], [1] * b]
    assert out[0] == out[1] and len(out[0]) == 3
    assert any(out[0].values() if entry == "decode_dataset" else out[0])


def test_decode_dataset_writes_timestamp_segments(tmp_path):
    """With the timestamp rules ``decode_dataset`` writes a ``segments``
    file beside ``text``: each line an utterance, its start, its end and
    its text, from the decoded row's timestamp pairs."""
    from robustsq_whisper_torch.decode.search import build_beam_decoder, strip_eot
    from robustsq_whisper_torch.decode.timestamps import segments_from_tokens

    enc, dec = _tiny_modules()
    pool = _Pool(3)
    cfg = DecodeConfig(**TINY_DCFG, with_timestamps=True, timestamp_begin=100,
                       max_initial_timestamp_index=4)
    res = decode_dataset(enc, dec, pool, _Ids(), cfg, batch_size=3, output_dir=str(tmp_path),
                         device="cpu")
    encode_feats = [tfront.pcm16_log_mel(pool.batch[k], pool.batch[k + "_lens"], 80, "cpu")
                    for k in ("speech", "enroll")]
    with torch.inference_mode():
        memory, _, prompt, _ = enc(*encode_feats[0], *encode_feats[1])
        tokens = build_beam_decoder(dec, cfg, "cpu")(memory, prompt)[0]
    want = []
    for utt, ids in zip(pool.batch["utt_ids"], strip_eot(tokens.numpy(), cfg.eot)):
        assert res.hyps[utt] == " ".join(str(t) for t in ids if t < 100)
        want += [f"{utt} {s0:.2f} {s1:.2f} {text}"
                 for s0, s1, text in segments_from_tokens(ids, _Ids(), 100)]
    assert (tmp_path / "segments").read_text().splitlines() == want
    assert (tmp_path / "text").exists()
