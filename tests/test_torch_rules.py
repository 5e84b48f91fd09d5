"""Rules of the PyTorch port: no JAX, no reach into the JAX package, and
entry points that run on the card unless asked for the CPU."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from robustsq_whisper_torch.decode.search import (
    DecodeConfig,
    build_beam_decoder,
    build_greedy_decoder,
)
from robustsq_whisper_torch.models import QFormerTSEncoder, TSDecoder
from robustsq_whisper_torch.models import TSEncoderConfig, WhisperDims
from robustsq_whisper_torch.serve import TranscriptionEngine
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
    [
        dict(beam_size=4, self_kv_bits=8), dict(speculative_gamma=4),
        dict(with_timestamps=True), dict(ctc_decode_weight=0.3),
        dict(quantize_weights=True),
    ],
)
def test_paths_outside_the_slice_raise(change):
    """Paths of later slices raise NotImplementedError naming their ROADMAP
    item when the engine is built; none runs a silent substitute."""
    change = dict(change)
    dec_kw = {"self_kv_bits": change.pop("self_kv_bits")} if "self_kv_bits" in change else {}
    dims = WhisperDims(n_text_state=128, n_text_head=2, n_text_layer=1, n_vocab=50)
    enc = QFormerTSEncoder(dims, TSEncoderConfig(num_hidden_layers=1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TranscriptionEngine(
            enc, TSDecoder(dims, **dec_kw), ByteTokenizer(),
            DecodeConfig(**change), device="cpu",
        )


def test_mesh_and_other_caches_raise():
    dims = WhisperDims(n_text_state=128, n_text_head=2, n_text_layer=1, n_vocab=50)
    enc = QFormerTSEncoder(dims, TSEncoderConfig(num_hidden_layers=1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TranscriptionEngine(
            enc, TSDecoder(dims), ByteTokenizer(), DecodeConfig(),
            mesh=object(), device="cpu",
        )
    for kw in (dict(self_kv_bits=8), dict(flat_self_cache=False),
               dict(tmin_self_cache=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            TSDecoder(dims, **kw).init_cache(2, 8)


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
    """Sequence parallelism, FSDP / meshes and embedding enrollment raise
    NotImplementedError naming their ROADMAP item."""
    from robustsq_whisper_torch.train import TrainConfig, create_train_state, make_train_step

    with pytest.raises(NotImplementedError, match="ROADMAP A15"):
        _train_model(sequence_parallel=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A14"):
        _train_model(enroll_type="embedding")
    for kw, cfg in ((dict(), TrainConfig(fsdp=True)), (dict(mesh=object()), TrainConfig())):
        with pytest.raises(NotImplementedError, match="ROADMAP A15"):
            create_train_state(_train_model(), cfg, device="cpu", **kw)
        with pytest.raises(NotImplementedError, match="ROADMAP A15"):
            make_train_step(_train_model(), cfg, device="cpu", **kw)
