"""Whole decode and training paths of the port on the card against the CPU.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU. The
file imports no JAX, so it runs on the machine with the card, beside the
kernel tests:

    python -m pytest tests/test_torch_cuda.py tests/test_torch_cuda_paths.py -m cuda -q --noconftest

Small models (f32) decode and train on the card with the kernels and on
the CPU with their plain versions: the tokens, the speculative acceptance
counters and the training step must agree, and every kernel a path was
ported for must have launched on the card. The tests also marked ``slow``
run Whisper-medium at its published widths (bf16, seeded random weights,
4 synthetic pairs of 30 s speech and 10 s enrollment, 32 new tokens): each
decode path returns its whole output and launches its kernels, and one
training step a mode launches the flash kernels as often as its 24 layers
need. The multi-GPU paths over NCCL ranks are ``multi_gpu_check.py``'s.
"""

import copy
import dataclasses
import json
import socket

import numpy as np
import pytest
import torch

from multi_gpu_check import (
    TRAIN_B, TRAIN_KERNELS, counted, engine_for, medium_models, serving_config,
    synthetic_pairs, train_batch,
)
from robustsq_whisper_torch.decode.search import DecodeConfig, build_beam_decoder, strip_eot
from robustsq_whisper_torch.decode.speculative import build_speculative_decoder
from robustsq_whisper_torch.init import init_params
from robustsq_whisper_torch.models import TSDecoder, TSEncoderConfig, WhisperDims, whisper_dims

from .test_torch_cuda import cuda  # noqa: F401  (the fixture)

SMALL = dict(
    n_mels=80, n_vocab=120, n_audio_ctx=256, n_audio_state=128, n_audio_head=2,
    n_audio_layer=2, n_text_ctx=64, n_text_state=128, n_text_head=2, n_text_layer=2,
)
GREEDY_KERNELS = ("flash_attention_tmaj", "decode_cross_attention", "decode_self_attention")
BEAM_KERNELS = ("beam_reorder_cache", "decode_cross_attention_grouped", "decode_self_attention")
DEFER_KERNELS = ("settled_self_attention", "beam_reorder_cache", "decode_cross_attention_grouped")
# the 5-D self caches are read in plain PyTorch
SPEC_KERNELS = ("decode_cross_attention", "flash_attention_tmaj")


def decoder_with(dec, **flags):
    """A TSDecoder built with ``dec``'s settings but the cache flags in
    ``flags`` (``self_kv_bits``, ``flat_self_cache``, ``tmin_self_cache``,
    ``use_spk_prompt``), holding ``dec``'s weight tensors (shared, not
    copied)."""
    td = dec.decoder
    kw = dict(
        startofprev_token=dec.startofprev_token, use_spk_prompt=dec.use_spk_prompt,
        cross_kv_bits=td.cross_kv_bits, self_kv_bits=td.self_kv_bits,
        flat_self_cache=td.flat_self_cache, tmin_self_cache=td.tmin_self_cache,
    )
    with torch.device(td.token_embedding.weight.device):  # a quick init there
        new = TSDecoder(dec.dims, **{**kw, **flags})
    new.load_state_dict(dec.state_dict(), assign=True)
    return new.eval()


def decode_fn(dec, cfg, device, draft=None):
    """``run(memory, prompt) -> (tokens, scores[, stats])`` for ``cfg``:
    the speculative decoder (with acceptance counters) or beam / greedy."""
    if cfg.speculative_gamma > 0:
        return build_speculative_decoder(dec, cfg, device, return_stats=True, draft=draft)
    return build_beam_decoder(dec, cfg, device=device)


def on_both(fn, dev):
    """``fn(where)`` on the CPU and, launches counted, on ``dev``: (the
    CPU's (tokens, scores, stats), the card's, the card's launches)."""
    def host(res):
        return [x.cpu() for x in res[:2]] + [
            {k: v.cpu() for k, v in res[2].items()} if len(res) > 2 else {}]

    cpu = host(fn(torch.device("cpu")))
    card, counts = counted(torch, lambda: fn(dev))
    return cpu, host(card), counts


def assert_agree(cpu, card, tol):
    """Identical tokens and acceptance counters, scores within ``tol``."""
    (t_cpu, s_cpu, st_cpu), (t_card, s_card, st_card) = cpu, card
    assert torch.equal(t_cpu, t_card), (t_card.tolist(), t_cpu.tolist())
    assert (s_cpu - s_card).abs().max().item() <= tol
    assert st_cpu.keys() == st_card.keys()
    assert all(torch.equal(st_cpu[k], st_card[k]) for k in st_cpu), (st_card, st_cpu)


def assert_launched(counts, kernels):
    assert not [k for k in kernels if counts[k] == 0], counts


def skip_without_card():
    """A module fixture's own check, made before the ``cuda`` fixture's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


# ---- small models, the card against the CPU ----

FIVE = dict(flat_self_cache=False)
# the prefix is 1 + 4 + 2 = 7 positions, so with R = 4 the deferred reorder
# flushes a non-empty settled prefix
BASE = dict(max_new_tokens=16, eot=2, init_tokens=(1, 4), quantize_cross_kv=True)
SPEC = dict(speculative_gamma=4, draft_layers=1)
SMALL_PATHS = {  # path: (decoder flags, DecodeConfig keywords, separate draft, kernels)
    "greedy": ({}, {}, False, GREEDY_KERNELS[1:]),
    "beam 3": ({}, dict(beam_size=3), False, BEAM_KERNELS),
    "beam 3 defer_reorder=4": ({}, dict(beam_size=3, defer_reorder=4), False, DEFER_KERNELS),
    "greedy 5-D": (FIVE, {}, False, SPEC_KERNELS[:1]),
    "greedy 5-D int8": (dict(FIVE, self_kv_bits=8), {}, False, SPEC_KERNELS[:1]),
    "greedy flat int8": (dict(self_kv_bits=8), {}, False,
                         ("decode_self_attention_int8", "decode_cross_attention")),
    "greedy time-minor": (dict(tmin_self_cache=True), {}, False,
                          ("decode_cross_attention_state", "decode_cross_attention")),
    "beam 3 5-D": (FIVE, dict(beam_size=3), False,
                   ("beam_reorder_cache_flat", "decode_cross_attention_grouped")),
    "beam 3 flat int8": (dict(self_kv_bits=8), dict(beam_size=3), False,
                         ("decode_self_attention_int8",) + BEAM_KERNELS[:2]),
    "speculative self-draft": (FIVE, SPEC, False, SPEC_KERNELS[:1]),
    "speculative separate draft": (FIVE, SPEC, True, SPEC_KERNELS[:1]),
    "greedy W8A8": ({}, dict(quantize_weights=True), False, ("w8a8_matmul",) + GREEDY_KERNELS[1:]),
    "beam 3 W8A8": ({}, dict(beam_size=3, quantize_weights=True), False,
                    ("w8a8_matmul",) + BEAM_KERNELS),
}


@pytest.fixture(scope="module")
def small():
    """A small Qformer TS model on the flash route, its decoder over the
    int4 cross K/V, a separate 1-layer draft, and two inputs: a mel batch
    (decoded from the encoder's output) and a random memory and prompt of
    larger scale, which make the beams reorder at most steps."""
    from robustsq_whisper_torch.models import QFormerTSEncoder

    skip_without_card()
    dims = WhisperDims(**SMALL)
    ts = TSEncoderConfig(
        num_query_tokens=4, num_hidden_layers=1, qformer_hidden_size=64,
        qformer_heads=2, qformer_intermediate_size=128,
        use_flash_attention=True, flash_tmaj=True, gelu_approx=True,
    )
    rng = np.random.default_rng(5)
    f32 = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    mel, emel = f32(2, 80, 512), f32(2, 80, 120)
    return dict(
        enc=init_params(QFormerTSEncoder(dims, ts), 3).eval(),
        dec=init_params(TSDecoder(dims, startofprev_token=3, cross_kv_bits=4), 4),
        draft=init_params(TSDecoder(dims.replace(n_text_layer=1), startofprev_token=3,
                                    cross_kv_bits=4), 7),
        mel=(mel, torch.tensor([512, 400]), emel, torch.tensor([120, 90])),
        random=(f32(2, 40, 128) * 3, f32(2, 4, 128) * 3),
        encoded={},
    )


def small_encoded(small, where):
    """(memory, spk_prompt) of the small encoder on ``where``, once, with
    the launches of the run that made it."""
    key = str(where)
    if key not in small["encoded"]:
        enc = copy.deepcopy(small["enc"]).to(where)
        with torch.inference_mode():
            out, counts = counted(torch, lambda: enc(*(x.to(where) for x in small["mel"])))
        small["encoded"][key] = (out[0], out[2]), counts
    return small["encoded"][key]


@pytest.mark.cuda
def test_small_encoder_agrees_with_cpu(cuda, small):
    """The Qformer encoder's output on the card (the transposed flash
    kernel, f32, in its strided row-output form) within 1e-3 of the
    CPU's."""
    (m_cpu, _), _ = small_encoded(small, torch.device("cpu"))
    (m_card, _), counts = small_encoded(small, cuda)
    assert (m_cpu - m_card.cpu()).abs().max().item() <= 1e-3
    assert_launched(counts, GREEDY_KERNELS[:1])
    assert counts["flash_attention_tmaj_rows"] == counts["flash_attention_tmaj"]


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["encoder output", "random memory"])
@pytest.mark.parametrize("path", list(SMALL_PATHS))
def test_small_path_agrees_with_cpu(cuda, small, source, path):
    """A decode path with the kernels on the card and the plain versions on
    the CPU: identical tokens and acceptance counters, scores to 1e-3 (5e-2
    with W8A8 step weights: the attention kernels' f32 noise can move an
    activation across a rounding tie and flip one int8 code), and the path's
    kernels launched."""
    flags, cfg_kw, separate, kernels = SMALL_PATHS[path]
    cfg = DecodeConfig(**BASE, **cfg_kw)
    pairs = {
        str(where): small_encoded(small, where)[0] if source == "encoder output"
        else tuple(x.to(where) for x in small["random"])
        for where in (torch.device("cpu"), cuda)
    }

    def fn(where):
        d = decoder_with(copy.deepcopy(small["dec"]), **flags)
        draft = copy.deepcopy(small["draft"]) if separate else None
        return decode_fn(d, cfg, where, draft)(*pairs[str(where)])

    cpu, card, counts = on_both(fn, cuda)
    assert_agree(cpu, card, 5e-2 if cfg.quantize_weights else 1e-3)
    assert_launched(counts, kernels)


REMAINING_PATHS = {  # path: kernels it must launch
    # zero-shot ASR: the dense cross K/V over the flat self cache
    "WhisperASR greedy": ("decode_self_attention",),
    "WhisperASR beam 3": ("decode_self_attention", "beam_reorder_cache"),
    # joint decode is dense (no cross kernel) and reorders by index_select
    "joint CTC beam 3 w=0.3": ("decode_self_attention",),
    "greedy with timestamps": GREEDY_KERNELS[1:],
    "speculative distilled draft": SPEC_KERNELS[:1],
    # the large-v3 beam cell's loop at 2 layers: 1280 wide, 20 heads, the v3
    # vocabulary, 1500 + 16 memory positions, the v3 prompt
    "beam 5 at large-v3 widths": BEAM_KERNELS,
}


@pytest.fixture(scope="module")
def remaining():
    """The remaining decode paths' inputs: a small decoder, a memory and
    prompt, a CTC head, audio for a small ``WhisperASR``, and a 1-layer
    draft distilled on the CPU against the decoder's greedy rows (20
    steps)."""
    from robustsq_whisper_torch.models.asr import WhisperASR
    from robustsq_whisper_torch.train.distill import distill_draft, teacher_forcing_inputs

    skip_without_card()
    rng = np.random.default_rng(9)
    f32 = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    memory = f32(2, 4 + 40, 128) * 3
    prompt = memory[:, :4].clone()
    r = dict(memory=memory, prompt=prompt, mem_lens=torch.tensor([44, 30]),
             ctc_lo=(f32(120, 128) * 0.2, f32(120) * 0.5), audio=f32(2, 16000 * 3))
    r["dec"] = init_params(TSDecoder(WhisperDims(**SMALL), startofprev_token=3,
                                     cross_kv_bits=4), 4).eval()
    r["dec5"] = decoder_with(r["dec"], flat_self_cache=False)
    base = dict(max_new_tokens=12, eot=2, init_tokens=(1, 4))
    r["base"] = base
    r["greedy"], _ = build_beam_decoder(
        r["dec5"], DecodeConfig(**base, quantize_cross_kv=True), device="cpu")(memory, prompt)
    rows = strip_eot(r["greedy"], 2)
    text = np.full((2, 1 + max(map(len, rows))), -1, np.int32)
    for i, row in enumerate(rows):
        text[i, : 1 + len(row)] = [4] + row
    ys, mask = teacher_forcing_inputs(text, np.array([1 + len(row) for row in rows]), 1, 2)
    r["draft"], _ = distill_draft(r["dec5"], 1, memory, prompt, ys, mask, steps=20, lr=1e-3,
                                  batch_size=2, seed=0)
    r["asr"] = WhisperASR.from_random("dev", seed=5, device="cpu", n_vocab=120,
                                      n_audio_state=128, n_text_state=128, n_text_ctx=64)
    return r


def remaining_run(r, path, where):
    from robustsq_whisper_torch.decode.joint import build_joint_beam_decoder
    from robustsq_whisper_torch.models.asr import WhisperASR

    base = r["base"]
    if path.startswith("WhisperASR"):
        asr = r["asr"]
        enc, d = WhisperASR.build(asr.dims)
        enc.load_state_dict(asr.encoder.state_dict())
        d.load_state_dict(asr.decoder.state_dict())
        return WhisperASR(asr.dims, enc, d, device=where).transcribe_batch(
            r["audio"], max_new_tokens=8, beam_size=3 if "beam" in path else 1)
    if path.startswith("joint CTC"):
        cfg = DecodeConfig(**base, beam_size=3, ctc_decode_weight=0.3, pre_beam=6)
        return build_joint_beam_decoder(copy.deepcopy(r["dec"]), r["ctc_lo"], cfg,
                                        prompt_frames=4, device=where)(
            r["memory"], r["prompt"], r["mem_lens"])
    if path == "greedy with timestamps":
        cfg = DecodeConfig(**base, with_timestamps=True, timestamp_begin=100,
                           max_initial_timestamp_index=4, quantize_cross_kv=True)
        return build_beam_decoder(copy.deepcopy(r["dec"]), cfg, where)(r["memory"], r["prompt"])
    if path == "beam 5 at large-v3 widths":
        if "v3" not in r:
            g = np.random.default_rng(13)
            rows = lambda *shape: torch.from_numpy(g.standard_normal(shape).astype(np.float32))
            dims = whisper_dims("large-v3").replace(n_text_layer=2)
            r["v3"] = (init_params(TSDecoder(dims, startofprev_token=50362, cross_kv_bits=4), 6).eval(),
                       rows(2, 1516, 1280), rows(2, 16, 1280))
        dec, memory, prompt = r["v3"]
        cfg = DecodeConfig(max_new_tokens=16, eot=50257, init_tokens=(50258, 50259, 50360, 50364),
                           beam_size=5, quantize_cross_kv=True, prefill_quantized=True)
        return build_beam_decoder(copy.deepcopy(dec), cfg, where)(memory, prompt)
    cfg = DecodeConfig(**base, quantize_cross_kv=True, **SPEC)
    return build_speculative_decoder(copy.deepcopy(r["dec5"]), cfg, where, return_stats=True,
                                     draft=copy.deepcopy(r["draft"]))(r["memory"], r["prompt"])


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(REMAINING_PATHS))
def test_small_remaining_path_agrees_with_cpu(cuda, remaining, path):
    """Zero-shot ``WhisperASR`` greedy and beam 3, joint CTC/attention beam
    3, greedy with the timestamp rules, speculative decode with the
    distilled draft and beam 5 at large-v3's decoder widths: identical
    tokens and acceptance counters on the card and the CPU, scores to 1e-3
    (5e-3 at large-v3's widths), the path's kernels launched; the
    speculative tokens are the greedy decoder's."""
    cpu, card, counts = on_both(lambda where: remaining_run(remaining, path, where), cuda)
    # at large-v3's widths f32 sums run over 1280- and 5120-long dots and
    # 51,866 logits: its 16-token beam scores read 1.4e-3 apart on an H100
    assert_agree(cpu, card, 5e-3 if path == "beam 5 at large-v3 widths" else 1e-3)
    assert_launched(counts, REMAINING_PATHS[path])
    if path == "speculative distilled draft":
        assert torch.equal(cpu[0], remaining["greedy"])


def small_train_model(seed: int):
    """A small f32 TSASRModel on the flash route (2 + 256 encoder positions,
    head_dim 64), without SpecAugment or dropout, and a batch of 2."""
    from robustsq_whisper_torch.models import TSASRModel, TSModelConfig

    ts = TSEncoderConfig(
        num_query_tokens=2, num_hidden_layers=1, qformer_hidden_size=64,
        qformer_heads=2, qformer_intermediate_size=128, use_flash_attention=True,
        qformer_hidden_dropout=0.0, qformer_attention_dropout=0.0, remat=True,
    )
    cfg = TSModelConfig(vocab_size=120, sos=1, eos=2, startofprev=3, num_speakers=8,
                        num_negatives=1, use_specaug=False)
    model = init_params(TSASRModel(WhisperDims(**SMALL), ts, cfg), seed)
    rng = np.random.default_rng(seed)
    samples, e_samples = 512 * 160, 200 * 160
    neg = np.array([[-10000.0, 1.0], [1.0, -10000.0]], np.float32)  # one valid column
    batch = {
        "speech": torch.from_numpy((rng.standard_normal((2, samples)) * 0.05).astype(np.float32)),
        "speech_lens": torch.tensor([samples, samples - 20000]),
        "enroll": torch.from_numpy((rng.standard_normal((2, e_samples)) * 0.05).astype(np.float32)),
        "enroll_lens": torch.tensor([e_samples, e_samples - 8000]),
        "text": torch.from_numpy(rng.integers(4, 100, (2, 8))),
        "text_lens": torch.tensor([8, 6]),
        "neg_logits": torch.from_numpy(neg),
        "spk_labels": torch.tensor([1, 5]),
    }
    return model, batch


@pytest.mark.cuda
def test_small_training_agrees_with_cpu(cuda):
    """One train step of a small f32 model on the card (the kernels' f32
    route) and on the CPU (the plain versions): the loss to 1e-4 relative
    and every gradient to 2e-3 of its own largest entry (5e-4 at least: the
    attention key biases are zero in exact arithmetic); the flash kernels
    launched as ``TRAIN_KERNELS`` says for these 2 layers; four steps on the
    card lower the loss."""
    from robustsq_whisper_torch.train import OptimConfig, TrainConfig
    from robustsq_whisper_torch.train import create_train_state, make_train_step

    base, batch = small_train_model(6)
    grads = []
    for where in (torch.device("cpu"), cuda):
        model = copy.deepcopy(base).to(where)

        def step():
            loss, _ = model({k: v.to(where) for k, v in batch.items()}, None, 6, train=True)
            loss.backward()
            return loss

        loss, counts = counted(torch, step)
        grads.append((loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()}))
    (l_cpu, g_cpu), (l_card, g_card) = grads
    assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
    for n, g in g_cpu.items():
        assert (g_card[n] - g).abs().max().item() <= 2e-3 * max(g.abs().max().item(), 5e-4), n
    layers = SMALL["n_audio_layer"]
    assert {k: counts[k] for k in TRAIN_KERNELS} == {k: v * layers // 24
                                                     for k, v in TRAIN_KERNELS.items()}
    cfg = TrainConfig(optim=OptimConfig(lr=1e-3, schedule="constant"))
    model = copy.deepcopy(base)
    state = create_train_state(model, cfg, device=cuda)
    step = make_train_step(model, cfg, device=cuda)
    losses = [step(state, batch, None, 6)[1]["loss"].item() for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


EMBED_PATHS = {  # beam size: kernels it must launch
    1: ("decode_cross_attention", "decode_self_attention"),
    3: ("decode_cross_attention_grouped", "decode_self_attention", "beam_reorder_cache"),
}
# the embedding encoder's attention is the plain one, as the JAX package's
EMBED_PLAIN = ("flash_attention_tmaj", "flash_attention")


@pytest.mark.cuda
@pytest.mark.parametrize("beam", list(EMBED_PATHS))
def test_small_embedding_enrollment_agrees_with_cpu(cuda, beam):
    """A small embedding-enrollment model (``cat`` adapter, f32) encodes the
    same mel and speaker embedding on the card and on the CPU (memory to
    1e-3, no flash kernel), then its prompt-free decoder decodes each memory
    over the int4 cross K/V to identical tokens, its kernels launched."""
    from robustsq_whisper_torch.models import SpkAdapterTSEncoder

    dims = WhisperDims(**SMALL)
    enc = init_params(SpkAdapterTSEncoder(dims, TSEncoderConfig(enroll_type="embedding",
                                                               enroll_size=256)), 11).eval()
    dec = init_params(TSDecoder(dims, use_spk_prompt=False, cross_kv_bits=4), 12).eval()
    rng = np.random.default_rng(13)
    mel = torch.from_numpy(rng.standard_normal((2, 80, 512)).astype(np.float32))
    emb = torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32))
    lens = torch.tensor([512, 380])
    cfg = DecodeConfig(**BASE, beam_size=beam)

    def fn(where):
        e = copy.deepcopy(enc).to(where)
        with torch.inference_mode():
            memory, _ = e(mel.to(where), lens.to(where), emb.to(where))
        encoded.append(memory.cpu())
        return build_beam_decoder(copy.deepcopy(dec), cfg, where)(memory, memory[:, :0])

    encoded = []
    cpu, card, counts = on_both(fn, cuda)
    assert (encoded[0] - encoded[1]).abs().max().item() <= 1e-3
    assert torch.equal(cpu[0], card[0])
    assert_launched(counts, EMBED_PATHS[beam])
    assert not [k for k in EMBED_PLAIN if counts[k]], counts


@pytest.mark.cuda
def test_speaker_embeddings_on_the_card_equal_the_cpu(cuda):
    """The stage-103 extractor (the seeded ResNet34 at its published widths
    and the Kaldi fbank) on the card, with cuDNN's TF32 left on outside
    ``embed_batch`` as PyTorch's defaults leave it, against the CPU: cosine
    0.999 or more on each of 4 utterances."""
    from robustsq_whisper_torch.models.speaker_resnet import embed_batch, speaker_model

    rng = np.random.default_rng(21)
    lens = np.array([48000, 40000, 16000, 400])
    audio = (rng.standard_normal((4, 48000)) * 0.1).astype(np.float32)
    audio[np.arange(48000)[None] >= lens[:, None]] = 0.0
    x, xl = torch.from_numpy(audio), torch.from_numpy(lens)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        card = embed_batch(speaker_model(device=cuda), x.to(cuda), xl.to(cuda)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    host = embed_batch(speaker_model(device="cpu"), x, xl)
    assert card.shape == host.shape == (4, 256)
    assert torch.nn.functional.cosine_similarity(card, host, dim=-1).min().item() >= 0.999


# ---- Whisper-medium at its published widths ----

BATCH, MAX_NEW = 4, 32
# (K, N, calls in one full-depth decode step): 24 layers x (self q/k/v/out
# and cross q/out), fc1 and fc2 a layer, and the tied logits
W8A8_STEP = ((1024, 1024, 24 * 6), (1024, 4096, 24), (4096, 1024, 24), (1024, 51865, 1))
# (K, calls) of one W8A8 encoder block: q, k, v and out, fc1, fc2
W8A8_ENC_LAYER = ((1024, 4), (1024, 1), (4096, 1))
MEDIUM_PATHS = {  # path: (decoder flags, DecodeConfig keywords, kernels it must launch)
    "greedy": ({}, {}, GREEDY_KERNELS),
    "greedy prefill_quantized": ({}, dict(prefill_quantized=True), GREEDY_KERNELS),
    "beam 5 eager": ({}, dict(beam_size=5), BEAM_KERNELS),
    "beam 5 defer_reorder=8": ({}, dict(beam_size=5, defer_reorder=8), DEFER_KERNELS),
    "greedy self_kv_bits=8": (dict(self_kv_bits=8), {},
                              ("decode_self_attention_int8",) + GREEDY_KERNELS[:2]),
    "greedy tmin_self_cache": (dict(tmin_self_cache=True), {},
                               ("decode_cross_attention_state", "decode_cross_attention")),
    "beam 5 flat_self_cache=False": (FIVE, dict(beam_size=5),
                                     ("beam_reorder_cache_flat", "decode_cross_attention_grouped")),
    "beam 5 self_kv_bits=8": (dict(self_kv_bits=8), dict(beam_size=5),
                              ("decode_self_attention_int8",) + BEAM_KERNELS[:2]),
    # gamma 10 with a 1-layer self-draft over the 5-D cache
    "speculative gamma=10": (FIVE, dict(speculative_gamma=10, draft_layers=1), SPEC_KERNELS),
    "greedy W8A8": ({}, dict(quantize_weights=True), ("w8a8_matmul",)),
    "greedy W8A8 self_kv_bits=8": (dict(self_kv_bits=8), dict(quantize_weights=True),
                                   ("w8a8_matmul",)),
    "beam 5 W8A8 eager": ({}, dict(beam_size=5, quantize_weights=True), ("w8a8_matmul",)),
    "beam 5 W8A8 defer_reorder=8": ({}, dict(beam_size=5, defer_reorder=8,
                                             quantize_weights=True), ("w8a8_matmul",)),
    "speculative W8A8 gamma=10": (FIVE, dict(speculative_gamma=10, draft_layers=1,
                                             quantize_weights=True), ("w8a8_matmul",)),
}


def w8a8_step_launches(m: int, layers: int = 24) -> int:
    """``w8a8_matmul`` launches of one decode step of ``layers`` layers at
    ``m`` rows: ``W8A8_STEP``'s calls, each ``launches_per_call``."""
    from robustsq_whisper_torch.ops.quant import launches_per_call

    return sum((c // 24 * layers if n != 51865 else c) * launches_per_call(m, k)
               for k, n, c in W8A8_STEP)


def w8a8_expected(counts, cfg: DecodeConfig) -> int:
    """``w8a8_matmul`` launches a decode must show, from the cross kernel's:
    greedy and beam run one cross launch a layer a step, so steps =
    launches / 24, each of 193 calls at batch (x beam) rows; speculative
    decode runs the cross kernel in its 1-layer draft's steps only (the
    verify chunk reads the cross K/V in plain PyTorch), gamma a round, and
    a round is gamma draft steps of 9 calls at batch rows and one verify of
    193 at batch x (gamma + 1) rows."""
    gamma = cfg.speculative_gamma
    if gamma:
        rounds = counts["decode_cross_attention"] // gamma
        return rounds * (gamma * w8a8_step_launches(BATCH, layers=1)
                         + w8a8_step_launches(BATCH * (gamma + 1)))
    key = "decode_cross_attention_grouped" if cfg.beam_size > 1 else "decode_cross_attention"
    return counts[key] // 24 * w8a8_step_launches(BATCH * cfg.beam_size)


@pytest.fixture(scope="module")
def medium():
    """Whisper-medium's Qformer TS encoder and decoder on the card (bf16,
    seeded random weights) and 4 synthetic pairs."""
    skip_without_card()
    dims, enc, dec = medium_models(torch, torch.device("cuda"))
    return dict(dims=dims, enc=enc, dec=dec, items=synthetic_pairs(BATCH, seed=0))


def engine_decode(engine, items):
    """One batch staged, encoded and decoded by ``engine``, as it serves."""
    with torch.inference_mode():
        return engine.run(*engine.encode(*engine.stage(items)))


def assert_whole_output(tokens, scores, dims):
    assert tokens.shape == (BATCH, MAX_NEW)
    assert ((tokens >= 0) & (tokens < dims.n_vocab)).all()
    assert torch.isfinite(scores).all()


@pytest.mark.cuda
@pytest.mark.slow
@pytest.mark.parametrize("path", list(MEDIUM_PATHS))
def test_medium_decode_path(cuda, medium, path):
    """The serving engine at Whisper-medium: a text for each pair, then one
    batch staged, encoded and decoded with every launch count set to 0 just
    before: the whole (4, 32) output, tokens in the vocabulary and finite
    scores, the path's kernels launched, and with W8A8 step weights
    ``w8a8_matmul`` launched as often as the steps' calls need."""
    flags, cfg_kw, kernels = MEDIUM_PATHS[path]
    dec = decoder_with(medium["dec"], **flags) if flags else medium["dec"]
    engine = engine_for(torch, cuda, medium["enc"], dec, BATCH, MAX_NEW, **cfg_kw)
    items = medium["items"]
    texts = engine.transcribe(items)
    assert len(texts) == BATCH and all(isinstance(t, str) for t in texts)
    res, counts = counted(torch, lambda: engine_decode(engine, items))
    assert_whole_output(res[0], res[1], medium["dims"])
    assert_launched(counts, kernels)
    if engine.dcfg.quantize_weights:
        assert counts["w8a8_matmul"] == w8a8_expected(counts, engine.dcfg)


@pytest.mark.cuda
@pytest.mark.slow
def test_medium_speculative_equals_greedy_in_f32(cuda, medium):
    """Speculative decode (gamma 10, a 1-layer self-draft) against greedy
    over the 5-D cache on one encoder batch, the decoder in f32: identical
    tokens (in bf16 a multi-token verify rounds otherwise than one-token
    steps, and random weights leave near-ties)."""
    engine = engine_for(torch, cuda, medium["enc"], medium["dec"], BATCH, MAX_NEW)
    memory, prompt = engine.encode(*engine.stage(medium["items"]))
    d5 = decoder_with(copy.deepcopy(medium["dec"]).float(), **FIVE)
    cfg = serving_config(MAX_NEW, speculative_gamma=10, draft_layers=1)
    g_tok, _ = decode_fn(d5, dataclasses.replace(cfg, speculative_gamma=0), cuda)(memory, prompt)
    s_tok, s_score, _ = decode_fn(d5, cfg, cuda)(memory, prompt)
    assert torch.equal(g_tok, s_tok)
    assert_whole_output(s_tok, s_score, medium["dims"])


@pytest.mark.cuda
@pytest.mark.slow
@pytest.mark.parametrize("beam", [1, 3], ids=["greedy", "beam3"])
def test_medium_whisper_asr(cuda, medium, beam):
    """Zero-shot ``WhisperASR`` at Whisper-medium (bf16): the medium weights
    without the speaker prompt, the plain-attention encoder and the dense
    cross K/V over the flat self cache, on 4 x 30 s of audio."""
    from robustsq_whisper_torch.models.asr import WhisperASR
    from robustsq_whisper_torch.models.whisper.modules import AudioEncoder

    dims = medium["dims"]
    with torch.device("meta"):
        audio_enc = AudioEncoder(dims)
    audio_enc.load_state_dict(medium["enc"].encoder.state_dict(), assign=True)
    asr = WhisperASR(dims, audio_enc, decoder_with(medium["dec"], use_spk_prompt=False),
                     dtype=torch.bfloat16, device=cuda)
    audio = torch.from_numpy(np.stack([sp for sp, _ in medium["items"]]))
    asr.transcribe_batch(audio[:1], max_new_tokens=4, beam_size=beam)  # warm-up
    (tokens, scores), counts = counted(
        torch, lambda: asr.transcribe_batch(audio, max_new_tokens=MAX_NEW, beam_size=beam))
    assert_whole_output(tokens, scores, dims)
    assert_launched(counts, REMAINING_PATHS["WhisperASR beam 3" if beam > 1
                                            else "WhisperASR greedy"])


# the W8A8 kernels by family, as the profiler names them: the fused decode
# kernels (local and cluster), the large-M path's row quantizer and product
W8A8_KERNELS = {"fused": "w8a8_decode_", "quantizer": "quantize_rows_kernel",
                "wgmma": "w8a8_gemm_sm90_kernel"}


@pytest.mark.cuda
@pytest.mark.slow
@pytest.mark.parametrize("what", ["greedy run", "encode"])
def test_medium_w8a8_kernels_in_a_trace(cuda, medium, what, tmp_path):
    """The W8A8 kernels the card ran, counted by name in a profiler trace:
    a greedy run with W8A8 step weights runs only the fused decode kernels,
    as many as ``qmatmul`` counted and the steps' calls need; an encode
    with ``quantize_encoder_weights`` runs 144 row quantizers and 144
    ``wgmma`` products (6 a block over 24 blocks at 4 x 1516 rows), the
    row-major flash forward once a block and no transposed one."""
    from torch.profiler import ProfilerActivity, profile

    from robustsq_whisper_torch.models.ts_encoder import quantize_encoder_weights
    from robustsq_whisper_torch.ops.quant import launches_per_call

    enc = medium["enc"]
    engine = engine_for(torch, cuda, enc, medium["dec"], BATCH, MAX_NEW, quantize_weights=True)
    staged = engine.stage(medium["items"])
    if what == "encode":
        qw = quantize_encoder_weights(enc)

        def fn():
            with torch.inference_mode():
                return enc(*staged, qw=qw)
    else:
        memory, prompt = engine.encode(*staged)

        def fn():
            with torch.inference_mode():
                return engine.run(memory, prompt)

    fn()  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, counts = counted(torch, fn)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    seen = {fam: sum(pat in n for n in names) for fam, pat in W8A8_KERNELS.items()}
    if what == "encode":
        calls = 24 * sum(c for _, c in W8A8_ENC_LAYER)
        assert seen == {"fused": 0, "quantizer": calls, "wgmma": calls}
        rows = BATCH * (1500 + 16)  # the encoder's matmul rows: frames and queries
        assert counts["w8a8_matmul"] == 24 * sum(c * launches_per_call(rows, k)
                                                 for k, c in W8A8_ENC_LAYER)
        assert (counts["flash_attention"], counts["flash_attention_tmaj"]) == (24, 0)
        assert torch.isfinite(out[0].float()).all()
    else:
        want = w8a8_expected(counts, engine.dcfg)
        assert seen == {"fused": want, "quantizer": 0, "wgmma": 0}
    assert counts["w8a8_matmul"] == sum(seen.values())


def span_kernels(events, span):
    """Names of the kernels launched inside the first ``span`` range of a
    chrome trace's events, in device order."""
    rng = next(e for e in events if e.get("name") == span and e.get("ph") == "X"
               and e.get("cat") == "user_annotation")
    lo, hi = rng["ts"], rng["ts"] + rng["dur"]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})
                and lo <= e["ts"] <= hi}
    kernels = sorted((e for e in events if e.get("cat") == "kernel"
                      and e.get("args", {}).get("correlation") in launched),
                     key=lambda e: e["ts"])
    return [e["name"] for e in kernels]


@pytest.mark.cuda
@pytest.mark.slow
def test_medium_encode_feeds_flash_from_the_gemms(cuda, medium, tmp_path):
    """One Whisper-medium encoder chunk (4 utterances, bf16) under
    ``rsq:decode.encode`` in a profiler trace: each of the 24 blocks runs
    its three projection GEMMs straight into ``flash_fwd_sm90_kernel`` and
    the flash output straight into the out-projection, with no elementwise
    or copy kernel between them, and the strided row-output form launches
    once a block."""
    from torch.profiler import ProfilerActivity, profile

    from robustsq_whisper_torch.utils.profiling import annotate

    enc = medium["enc"]
    engine = engine_for(torch, cuda, enc, medium["dec"], BATCH, MAX_NEW)
    staged = engine.stage(medium["items"])

    def fn():
        with torch.inference_mode(), annotate("rsq:decode.encode"):
            return enc(*staged)

    fn()  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, counts = counted(torch, fn)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    names = span_kernels(json.loads((tmp_path / "trace.json").read_text())["traceEvents"],
                         "rsq:decode.encode")
    flash = [i for i, n in enumerate(names) if "flash_fwd_sm90_kernel" in n]
    assert len(flash) == 24
    for i in flash:
        around = names[i - 3:i] + names[i + 1:i + 2]  # q, k, v GEMMs; the out-projection
        assert not [n for n in around if "elementwise" in n or "copy" in n.lower()], around
    assert counts["flash_attention_tmaj_rows"] == counts["flash_attention_tmaj"] == 24


@pytest.mark.cuda
@pytest.mark.slow
@pytest.mark.parametrize("path", ["greedy", "beam 5"])
def test_medium_mesh_of_one_card(cuda, medium, path):
    """A one-process NCCL group and a ``(1, 1)`` mesh: ``build_decode_fns(
    mesh=)`` and ``build_sharded_decoder`` decode the unsharded decode's
    tokens with the same launches of every kernel (at one rank the sharded
    code is the unsharded code: this checks the wiring, not the sharding;
    ``multi_gpu_check.py`` checks the sharding over NCCL ranks)."""
    import torch.distributed as dist

    from robustsq_whisper_torch.decode.pipeline import build_decode_fns
    from robustsq_whisper_torch.decode.sharded import build_sharded_decoder
    from robustsq_whisper_torch.parallel.mesh import init_distributed, local_rows, make_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    assert init_distributed(f"tcp://localhost:{port}", 1, 0, device=cuda) == 1
    try:
        one = torch.ones(4, device=cuda)
        dist.all_reduce(one)
        assert dist.get_backend() == "nccl" and bool((one == 1).all())
        mesh = make_mesh(1, 1)
        enc, dec = medium["enc"], medium["dec"]
        staged = engine_for(torch, cuda, enc, dec, BATCH, MAX_NEW).stage(medium["items"])
        cfg = serving_config(MAX_NEW, **({"beam_size": 5} if path == "beam 5" else {}))
        encode, run = build_decode_fns(enc, dec, cfg, device=cuda)
        s_encode, s_run = build_decode_fns(enc, dec, cfg, mesh=mesh, device=cuda)
        direct = build_sharded_decoder(dec, cfg, mesh, cuda)
        memory, prompt = encode(*staged)
        for sharded, plain in (
            (lambda: s_run(*s_encode(*staged)), lambda: run(*encode(*staged))),
            (lambda: direct(local_rows(memory, mesh), local_rows(prompt, mesh)),
             lambda: run(memory, prompt)),
        ):
            ref, counts_u = counted(torch, plain)
            got, counts_s = counted(torch, sharded)
            assert torch.equal(got[0], ref[0]) and counts_s == counts_u
        assert_launched(counts_s, (BEAM_KERNELS if path == "beam 5" else GREEDY_KERNELS)[1:])
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.slow
@pytest.mark.parametrize("mode,moments", [("lora", "float32"), ("full", "bfloat16")])
def test_medium_train_step(cuda, mode, moments):
    """``make_train_step`` at Whisper-medium (bf16, remat, flash on the
    row-major route) at batch 8 of 30 s + 10 s with 48 text tokens, the
    JAX bench's training settings: after a warm-up step, a step launches the
    flash forward twice a layer and each backward kernel once
    (``TRAIN_KERNELS``) and logs finite stats."""
    from robustsq_whisper_torch.models import TSASRModel, TSModelConfig, whisper_dims
    from robustsq_whisper_torch.train import OptimConfig, TrainConfig
    from robustsq_whisper_torch.train import create_train_state, make_train_step

    dims = whisper_dims("medium")
    ts = TSEncoderConfig(use_flash_attention=True, flash_tmaj=False, remat=True,
                         gelu_approx=False)
    model = init_params(TSASRModel(dims, ts, TSModelConfig()), 2)
    model.set_compute_dtype(torch.bfloat16)
    cfg = TrainConfig(mode=mode, optim=OptimConfig(moment_dtype=moments))
    state = create_train_state(model, cfg, device=cuda)
    step = make_train_step(model, cfg, device=cuda)
    batch = train_batch(torch, cuda, TRAIN_B, dims.n_vocab)
    gen = torch.Generator(device=cuda).manual_seed(0)
    step(state, batch, gen, 0)  # warm-up
    (_, stats), counts = counted(torch, lambda: step(state, batch, gen, 0))
    assert {k: counts[k] for k in TRAIN_KERNELS} == TRAIN_KERNELS
    assert all(np.isfinite(v.item()) for v in stats.values()), stats
