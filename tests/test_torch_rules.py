"""Rules of the PyTorch port: no JAX, no reach into the JAX package, and
entry points that run on the card unless asked for the CPU."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from robustsq_whisper_torch.decode.search import (
    DecodeConfig,
    build_beam_decoder,
    build_greedy_decoder,
)
from robustsq_whisper_torch.init import init_params
from robustsq_whisper_torch.models import QFormerTSEncoder, TSDecoder
from robustsq_whisper_torch.models import TSEncoderConfig, WhisperDims
from robustsq_whisper_torch.serve import EngineConfig, TranscriptionEngine
from robustsq_whisper_torch.tokenizer import ByteTokenizer

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "robustsq_whisper_torch"


def test_port_never_imports_jax():
    """Importing every port module (and chip_smoke.py) loads no JAX."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import robustsq_whisper_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'robustsq_whisper_tpu')]\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_port_sources_never_name_the_jax_package():
    files = [*PORT.rglob("*.py"), *PORT.rglob("*.cu")]
    assert len(files) > 10
    for f in files:
        text = f.read_text()
        assert "robustsq_whisper_tpu" not in text, f
        assert "import jax" not in text and "from jax" not in text, f
    # chip_smoke.py names the TPU kernels it replaces, but imports none
    smoke = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in smoke and "from jax" not in smoke
    assert "import robustsq_whisper_tpu" not in smoke
    assert "from robustsq_whisper_tpu" not in smoke


def test_default_device_raises_without_cuda(monkeypatch):
    """Entry points default to the card and never fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dims = WhisperDims(n_text_state=128, n_text_head=2, n_text_layer=1, n_vocab=50)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_greedy_decoder(TSDecoder(dims), DecodeConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_beam_decoder(TSDecoder(dims), DecodeConfig(beam_size=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TranscriptionEngine(
            QFormerTSEncoder(dims, TSEncoderConfig(num_hidden_layers=1)),
            TSDecoder(dims), ByteTokenizer(), DecodeConfig(),
        )


@pytest.mark.parametrize(
    "change",
    [dict(with_timestamps=True), dict(ctc_decode_weight=0.3)],
)
def test_paths_outside_the_slice_raise(change):
    """A path the engine cannot serve raises when the engine is built; none
    runs a silent substitute. Timestamp decoding needs the timestamp tokens
    in the vocabulary (here 50 ids); joint CTC decode needs the CTC head,
    which the engine does not take (nor does the JAX package's)."""
    dims = WhisperDims(n_text_state=128, n_text_head=2, n_text_layer=1, n_vocab=50)
    enc = QFormerTSEncoder(dims, TSEncoderConfig(num_hidden_layers=1))
    error, match = {
        "with_timestamps": (ValueError, "timestamp tokens"),
        "ctc_decode_weight": (ValueError, "CTC head"),
    }[next(iter(change))]
    with pytest.raises(error, match=match):
        TranscriptionEngine(
            enc, TSDecoder(dims), ByteTokenizer(), DecodeConfig(**change),
            device="cpu",
        )


def _small_engine(dec_kw, change):
    dims = WhisperDims(
        n_audio_ctx=16, n_audio_state=128, n_audio_head=2, n_audio_layer=1,
        n_text_ctx=64, n_text_state=128, n_text_head=2, n_text_layer=2, n_vocab=300,
    )
    ts = TSEncoderConfig(num_query_tokens=2, num_hidden_layers=1, qformer_hidden_size=32,
                         qformer_heads=2, qformer_intermediate_size=64)
    enc = init_params(QFormerTSEncoder(dims, ts), 0)
    dec = init_params(TSDecoder(dims, startofprev_token=3, **dec_kw), 1)
    cfg = dict(max_new_tokens=4, eot=2, init_tokens=(1,), quantize_cross_kv=True)
    return TranscriptionEngine(
        enc, dec, ByteTokenizer(), DecodeConfig(**cfg, **change),
        EngineConfig(batch_size=2, speech_seconds=0.32, enroll_seconds=0.2),
        device="cpu",
    )


@pytest.mark.parametrize(
    "dec_kw,change",
    [
        (dict(self_kv_bits=8), dict(beam_size=4)),  # beam over the int8 flat cache
        (dict(flat_self_cache=False), dict(speculative_gamma=4, draft_layers=1)),
        (dict(), dict(quantize_weights=True)),  # W8A8 step weights, greedy
        (dict(self_kv_bits=8), dict(beam_size=4, quantize_weights=True)),
    ],
    ids=["beam-int8-flat", "speculative", "w8a8-greedy", "w8a8-beam-int8-flat"],
)
def test_paths_of_this_slice_build_and_run(dec_kw, change):
    """Paths this slice ported: the engine builds on the CPU and
    transcribes once."""
    engine = _small_engine(dec_kw, change)
    rng = np.random.default_rng(0)
    items = [(rng.standard_normal(5120).astype(np.float32) * 0.1,
              rng.standard_normal(3200).astype(np.float32) * 0.1)]
    texts = engine.transcribe(items)
    assert len(texts) == 1 and isinstance(texts[0], str)


def test_mesh_and_other_caches_raise():
    """A cache layout the decoder is not eligible for, or a self cache
    width with no layout, raises ValueError."""
    dims = WhisperDims(n_text_state=128, n_text_head=2, n_text_layer=1, n_vocab=50)
    for kw in (dict(), dict(self_kv_bits=8, tmin_self_cache=True),
               dict(flat_self_cache=False, tmin_self_cache=True)):
        with pytest.raises(ValueError, match="time-minor"):
            TSDecoder(dims, **kw).init_cache(2, 8, layout="tmin")
    with pytest.raises(ValueError, match="self_kv_bits"):
        TSDecoder(dims, self_kv_bits=4).init_cache(2, 8)


@pytest.mark.parametrize(
    "kw,layout,shapes",
    [
        (dict(self_kv_bits=8), "flat",
         [(1, 2, 16, 128), (1, 2, 16, 128), (1, 2, 16, 128)]),
        (dict(flat_self_cache=False), "5d", [(1, 2, 9, 2, 64)] * 2),
        (dict(tmin_self_cache=True), "tmin", [(1, 2, 2, 64, 128)] * 2),
    ],
    ids=["int8-flat", "5d", "tmin"],
)
def test_every_cache_layout_builds_and_steps(kw, layout, shapes):
    """The three caches that are not the dense flat one: init_cache gives
    the layout's leaves, and a prefill and a step run over them on the
    CPU."""
    dims = WhisperDims(n_text_state=128, n_text_head=2, n_text_layer=1, n_vocab=50)
    dec = init_params(TSDecoder(dims, **kw), 2).decoder
    cache = dec.init_cache(2, 9)
    assert dec._cache_layout(cache) == layout
    assert [tuple(c.shape) for c in cache] == shapes
    mem = torch.randn(2, 6, 128)
    cross = dec.quantize_cross(dec.cross_kv(mem))
    with torch.inference_mode():
        _, cache = dec.prefill(torch.randn(2, 3, 128), cache, dec.cross_kv(mem))
        logits, cache = dec.step(torch.randn(2, 1, 128), torch.tensor(3, dtype=torch.int32),
                                 cache, cross)
    assert logits.shape == (2, 50) and torch.isfinite(logits).all()


def test_defer_reorder_with_int8_cache_raises():
    """The deferred beam reorder reads the dense flat cache only."""
    dims = WhisperDims(n_text_state=128, n_text_head=2, n_text_layer=1, n_vocab=50)
    cfg = DecodeConfig(beam_size=4, defer_reorder=8)
    with pytest.raises(ValueError, match="dense flat self cache"):
        build_beam_decoder(TSDecoder(dims, self_kv_bits=8), cfg, device="cpu")


def _train_model(**ts):
    from robustsq_whisper_torch.models import TSASRModel

    dims = WhisperDims(n_audio_ctx=16, n_audio_state=32, n_audio_head=2, n_audio_layer=1,
                       n_text_ctx=16, n_text_state=32, n_text_head=2, n_text_layer=1, n_vocab=50)
    ts = TSEncoderConfig(num_query_tokens=2, num_hidden_layers=1, qformer_hidden_size=32,
                         qformer_heads=2, qformer_intermediate_size=64, **ts)
    return TSASRModel(dims, ts)


def test_train_entry_points_raise_without_cuda(monkeypatch):
    from robustsq_whisper_torch.train import TrainConfig, create_train_state, make_train_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(_train_model(), TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(_train_model(), TrainConfig())


def test_training_paths_outside_the_slice_raise():
    """An enrollment type other than audio and embedding raises
    ValueError."""
    with pytest.raises(ValueError, match="audio|embedding"):
        _train_model(enroll_type="xvector")


def test_no_multi_gpu_refusal_is_left():
    """The port serves and trains on a mesh: no source refuses it by naming
    the multi-GPU item of the roadmap."""
    for f in PORT.rglob("*.py"):
        assert "ROADMAP A15" not in f.read_text(), f
