"""The serving program pair (encode, run), the sub-batched encode, and the
decode of a Kaldi data dir with WER / CER scoring.

``serving_modules`` builds the serving encoder and decoder from a
``TSASRModel`` state dict: ``cli.decode``, ``cli.serve`` and the training
loop's valid WER (``train/eval.py::ValidWer``) all serve through it.
Mirrors the single-device cases of the JAX package's
``decode/pipeline.py``, for the Qformer encoder (audio enrollment) and
``SpkAdapterTSEncoder`` (embedding enrollment, with an empty speaker
prompt for the prompt-free decoder). ``build_decode_fns``: greedy or beam search as ``DecodeConfig.beam_size``
says (``run`` returns the best beam of each
utterance), speculative greedy decode when ``speculative_gamma > 0``
(``run`` then also returns the draft-acceptance counters, and ``draft``
may give a separate draft decoder, e.g. a distilled one), or joint
CTC/attention beam search when ``ctc_decode_weight > 0`` (``ctc_lo`` the
CTC head; ``run`` then takes the encoder lengths too). ``decode_dataset``
runs a ``KaldiTSDataset`` through them batch by batch (with
``with_timestamps`` it also writes the ``segments`` file) and
``score_and_write`` writes the ESPnet-style ``text`` (hypotheses) and
``score.txt``.

On a mesh (``parallel/mesh.py``, one process per GPU) the conditions are
JAX's: a model axis larger than 1 serves tensor-parallel, else a data axis
larger than 1 data-parallel (``decode/sharded.py``); joint CTC and a
separate draft refuse a mesh, and the embedding encoder serves
data-parallel only. Every rank reads the same batch and keeps its rows;
the tokens of the whole batch come back to every rank, and rank 0 writes
the files.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_size, rank
from ..audio.frontend import pcm16_log_mel
from ..data import kaldi_io
from ..models.ts_decoder import TSDecoder
from ..models.ts_encoder import QFormerTSEncoder, SpkAdapterTSEncoder
from ..models.whisper.modules import AudioEncoder
from ..utils.profiling import annotate
from .scorer import cer, wer
from .search import DecodeConfig, build_beam_decoder, strip_eot
from .speculative import build_speculative_decoder
from .timestamps import segments_from_tokens

logger = logging.getLogger("robustsq_whisper_torch.decode")


@dataclasses.dataclass
class DecodeResult:
    hyps: Dict[str, str]
    refs: Dict[str, str]
    metrics: Dict[str, float]
    audio_seconds: float
    wall_seconds: float

    @property
    def rtf(self) -> float:
        return self.audio_seconds / max(self.wall_seconds, 1e-9)


def serving_modules(
    dims, ts, mcfg, state_dict: Dict[str, torch.Tensor], dtype: torch.dtype, device,
    cross_kv_bits: int = 8, self_kv_bits: int = 16, flat_self_cache: bool = True,
):
    """``(encoder, TSDecoder)`` of the model ``(dims, ts, mcfg)``
    (``WhisperDims``, ``TSEncoderConfig``, ``ModelConfig``) on ``device``,
    every floating tensor in ``dtype`` (serving keeps the weights in the
    compute dtype), loaded from the ``encoder.`` and ``decoder.`` entries of
    a ``TSASRModel`` state dict. The encoder is ``ts.enroll_type``'s:
    ``QFormerTSEncoder``, or ``SpkAdapterTSEncoder`` with a prompt-free
    decoder."""
    emb = ts.enroll_type == "embedding"
    with torch.device(device):
        encoder = (SpkAdapterTSEncoder if emb else QFormerTSEncoder)(dims, ts)
        decoder = TSDecoder(
            dims.replace(n_vocab=mcfg.vocab_size),
            startofprev_token=mcfg.startofprev, use_spk_prompt=not emb,
            cross_kv_bits=cross_kv_bits, self_kv_bits=self_kv_bits,
            flat_self_cache=flat_self_cache,
        )
    for prefix, module in (("encoder.", encoder), ("decoder.", decoder)):
        module.to(device=device, dtype=dtype)
        module.load_state_dict(
            {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)},
            strict=True,
        )
        module.eval()
    return encoder, decoder


def chunked_encode(enc_fn, args, chunk):
    """Encode in sub-batches of ``chunk`` rows and concatenate, bounding the
    encoder's activation peak separately from the decode batch.
    ``enc_fn(*args) -> (memory, spk_prompt)``, every arg batch-leading;
    ``chunk`` <= 0 or >= batch encodes in one call."""
    b = args[0].shape[0]
    if chunk <= 0 or chunk >= b:
        return enc_fn(*args)
    mems, prompts = [], []
    for s in range(0, b, chunk):
        m, p = enc_fn(*(a[s : s + chunk] for a in args))
        mems.append(m)
        prompts.append(p)
    return torch.cat(mems, dim=0), torch.cat(prompts, dim=0)


def build_decode_fns(
    encoder: QFormerTSEncoder,
    decoder: TSDecoder,
    dcfg: DecodeConfig,
    mesh: Optional[Any] = None,
    device="cuda",
    draft: Optional[TSDecoder] = None,
    ctc_lo: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    enc_chunk: int = 0,
):
    """``(encode, run)``: ``encode`` returns ``(memory, spk_prompt)``, from
    ``(mel, flens, emel, elens)`` for the Qformer encoder and from ``(mel,
    flens, enroll_embed)`` for ``SpkAdapterTSEncoder``, whose
    ``spk_prompt`` is the empty (b, 0, n_state) one the prompt-free decoder
    expects; ``run(memory, spk_prompt)`` returns (tokens, scores[, stats]);
    the joint decoder's is ``run(memory, spk_prompt, mem_lens)``.
    ``ctc_lo``: the CTC head's (weight, bias), which joint decode needs.
    Moves the modules to ``device``. On a ``mesh`` ``encode`` takes the
    whole batch and returns this rank's rows, ``run`` takes those and
    returns the whole batch's; ``enc_chunk`` then sub-batches the encoder
    inside ``encode`` (decode/sharded.py). A tensor-parallel mesh shards
    the modules in place."""
    if draft is not None and not (
        dcfg.speculative_gamma > 0 and mesh is None and dcfg.ctc_decode_weight == 0
    ):
        raise ValueError(
            "a draft decoder requires the single-device speculative path: "
            "speculative_gamma > 0, no mesh, no joint CTC"
        )
    emb = isinstance(encoder, SpkAdapterTSEncoder)
    if emb and decoder.use_spk_prompt:
        raise ValueError("embedding enrollment decodes prompt-free: build the TSDecoder "
                         "with use_spk_prompt=False")
    dev = resolve_device(device)
    if mesh is not None and dcfg.ctc_decode_weight > 0:
        raise NotImplementedError(
            "ctc_decode_weight > 0 decodes on a single device (the "
            "joint scorer is the parity path, not the serving one); "
            "drop --data_parallel/--model_parallel"
        )
    if mesh is not None and axis_size(mesh, MODEL_AXIS) > 1:
        if emb:
            raise NotImplementedError(
                "tensor-parallel serving of the embedding-enrollment encoder is "
                "not wired up (the TS flagship path is the Qformer encoder); use "
                "--model_parallel 1"
            )
        from .sharded import build_tp_decoder, build_tp_encoder

        return (build_tp_encoder(encoder, mesh, dev, enc_chunk),
                build_tp_decoder(decoder, dcfg, mesh, dev))
    if mesh is not None and axis_size(mesh, DATA_AXIS) > 1:
        from .sharded import build_sharded_decoder, build_sharded_encoder

        run = build_sharded_decoder(decoder, dcfg, mesh, dev,
                                    return_stats=dcfg.speculative_gamma > 0)
        return build_sharded_encoder(encoder, mesh, dev, enc_chunk), run
    if dcfg.ctc_decode_weight > 0:
        if ctc_lo is None:
            raise ValueError(
                "ctc_decode_weight > 0 needs the CTC head weights: pass "
                "ctc_lo=(weight, bias) (the model's ctc.ctc_lo)"
            )
        from .joint import build_joint_beam_decoder

        run = build_joint_beam_decoder(
            decoder, ctc_lo, dcfg, prompt_frames=encoder.prompt_len, device=dev
        )
    elif dcfg.speculative_gamma > 0:
        # the acceptance counters say whether speculation pays on these weights
        run = build_speculative_decoder(
            decoder, dcfg, dev, return_stats=True, draft=draft
        )
    else:
        run = build_beam_decoder(decoder, dcfg, dev)
    encoder.to(dev).eval()
    if emb:
        @torch.inference_mode()
        def encode(mel, flens, enroll_embed):
            memory, _ = encoder(mel.to(dev), flens.to(dev), enroll_embed.to(dev))
            return memory, memory.new_zeros((memory.shape[0], 0, memory.shape[-1]))
    else:
        @torch.inference_mode()
        def encode(mel, flens, emel, elens):
            memory, _, spk_prompt, _ = encoder(
                mel.to(dev), flens.to(dev), emel.to(dev), elens.to(dev)
            )
            return memory, spk_prompt

    return encode, run


def decode_dataset(
    encoder: QFormerTSEncoder,
    decoder: TSDecoder,
    dataset: Any,  # KaldiTSDataset
    tokenizer: Any,
    dcfg: DecodeConfig,
    batch_size: int = 8,
    output_dir: Optional[str] = None,
    enc_chunk: int = 0,
    device="cuda",
    draft: Optional[TSDecoder] = None,
    ctc_lo: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    mesh: Optional[Any] = None,
) -> DecodeResult:
    """Decode every utterance of ``dataset`` and score it against its
    ``text``. On a ``mesh`` every rank runs this over the same batches
    (``batch_size`` and ``enc_chunk`` multiples of the data axis: the
    chunk is rounded up to one, as in JAX) and rank 0 writes the files.

    The loop keeps the JAX package's order: batch i is encoded and decoded,
    then the host detokenizes batch i-1 (the only place tokens move to the
    host) and reads the audio of batch i+1. It does not keep its overlap:
    the greedy ``run`` issues its token steps at most ``search.RUN_AHEAD``
    steps ahead of the device and returns with the last of them in
    flight, but the copy of batch i-1's tokens queues behind them, so the
    device has finished batch i before the host goes on (beam search still
    syncs with the host at every step). The frontend of batch i+1 then
    costs the host one copy of its waveforms into pinned memory:
    ``pcm16_log_mel`` sends the speech and the enrollments to the device
    without a sync and quantizes them to int16's grid there, the grid kept
    because it is exact for WAV audio."""
    dev = resolve_device(device)
    if enc_chunk < 0:
        raise ValueError(f"enc_chunk must be >= 0, got {enc_chunk}")
    n_data = axis_size(mesh, DATA_AXIS)
    if enc_chunk and mesh is not None:
        # each encode sub-batch must still divide the mesh data axis
        rounded = -(-enc_chunk // n_data) * n_data
        if rounded != enc_chunk:
            logger.info("rounded enc_chunk %d -> %d (multiple of the %d-way data axis)",
                        enc_chunk, rounded, n_data)
            enc_chunk = rounded
    encode, run = build_decode_fns(
        encoder, decoder, dcfg, mesh=mesh, device=dev, draft=draft, ctc_lo=ctc_lo,
        enc_chunk=enc_chunk,
    )
    # a sharded encode sub-batches inside (build_decode_fns)
    sharded = axis_size(mesh, DATA_AXIS) * axis_size(mesh, MODEL_AXIS) > 1
    outer_chunk = 0 if sharded else enc_chunk

    hyps: Dict[str, str] = {}
    refs: Dict[str, str] = {}
    segments: Dict[str, list] = {}
    spec_totals = np.zeros(3, np.int64)  # chunks, accepted, emitted
    audio_sec = 0.0
    t0 = time.time()

    def consume(pending) -> None:
        """Host half of one batch: fetch tokens, detokenize, look up refs."""
        nonlocal audio_sec
        utts, speech_lens, tokens, stats = pending
        tokens = tokens.cpu().numpy()
        if stats is not None:
            stats = {k: v.cpu().numpy() for k, v in stats.items()}
        for i, utt in enumerate(utts):
            if utt in hyps:  # drop_last=False wraps; skip duplicates
                continue
            ids = strip_eot(tokens[i : i + 1], dcfg.eot)[0]
            if dcfg.with_timestamps:
                segments[utt] = segments_from_tokens(ids, tokenizer, dcfg.timestamp_begin)
                ids = [t for t in ids if t < dcfg.timestamp_begin]
            hyps[utt] = tokenizer.decode(ids).strip()
            refs[utt] = dataset.text.get(utt, "")
            audio_sec += float(speech_lens[i]) / dataset.sample_rate
            if stats is not None:
                spec_totals[:] += [
                    stats["chunks"][i], stats["accepted"][i], stats["emitted"][i],
                ]

    pending = None
    emb = isinstance(encoder, SpkAdapterTSEncoder)
    n_mels = encoder.dims.n_mels
    with torch.inference_mode():
        for batch in dataset.batches(batch_size, shuffle=False, drop_last=False):
            with annotate("rsq:decode.frontend"):
                feats, feats_lens = pcm16_log_mel(batch["speech"], batch["speech_lens"], n_mels, dev)
                enroll = ((torch.from_numpy(batch["enroll_embed"]),) if emb
                          else pcm16_log_mel(batch["enroll"], batch["enroll_lens"], n_mels, dev))
            with annotate("rsq:decode.encode"):
                memory, spk_prompt = chunked_encode(encode, (feats, feats_lens, *enroll), outer_chunk)
            with annotate("rsq:decode.search"):
                if dcfg.ctc_decode_weight > 0:
                    # encoder lengths with the prompt frames, as the encoder's
                    # own: the joint scorer masks the frames beyond each
                    # utterance and bounds its length by them
                    prompt_frames = encoder.prompt_len
                    mem_lens = AudioEncoder.output_lengths(
                        feats_lens, memory.shape[1] - prompt_frames
                    ) + prompt_frames
                    res = run(memory, spk_prompt, mem_lens)
                else:
                    res = run(memory, spk_prompt)
            tokens, stats = res[0], (res[2] if len(res) == 3 else None)
            if pending is not None:
                with annotate("rsq:decode.consume"):
                    consume(pending)
            pending = (batch["utt_ids"], batch["speech_lens"], tokens, stats)
        if pending is not None:
            with annotate("rsq:decode.consume"):
                consume(pending)
    wall = time.time() - t0

    extra: Dict[str, float] = {}
    if dcfg.speculative_gamma > 0:
        # reported whenever the speculative path ran, even with 0 chunks
        chunks, accepted, emitted = (int(x) for x in spec_totals)
        extra = {
            "spec_acceptance_rate": round(
                accepted / max(chunks * dcfg.speculative_gamma, 1), 4
            ),
            "spec_tokens_per_chunk": round(emitted / max(chunks, 1), 3),
            "spec_chunks": float(chunks),
        }
        logger.info(
            "speculative decode: %.1f%% draft acceptance, %.2f tokens/chunk "
            "(gamma=%d draft_layers=%d)",
            100 * extra["spec_acceptance_rate"], extra["spec_tokens_per_chunk"],
            dcfg.speculative_gamma, dcfg.draft_layers,
        )
    if rank() != 0:
        output_dir = None
    if segments and output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "segments"), "w") as f:
            for utt in sorted(segments):
                for s0, s1, text in segments[utt]:
                    f.write(f"{utt} {s0:.2f} {s1:.2f} {text}\n")
    return score_and_write(hyps, refs, audio_sec, wall, output_dir, extra)


def score_and_write(
    hyps: Dict[str, str],
    refs: Dict[str, str],
    audio_sec: float,
    wall: float,
    output_dir: Optional[str] = None,
    extra_metrics: Optional[Dict[str, float]] = None,
) -> DecodeResult:
    """WER/CER/RTF metrics and the ESPnet-style ``text`` / ``score.txt``."""
    pairs = [(refs[u], hyps[u]) for u in hyps if refs.get(u)]
    metrics: Dict[str, float] = dict(extra_metrics or {})
    if pairs:
        r, h = zip(*pairs)
        metrics.update(wer(list(r), list(h)))
        metrics.update(cer(list(r), list(h)))
    metrics["rtf"] = audio_sec / max(wall, 1e-9)

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        kaldi_io.write_scp(os.path.join(output_dir, "text"), hyps)
        with open(os.path.join(output_dir, "score.txt"), "w") as f:
            for k, v in sorted(metrics.items()):
                f.write(f"{k} {v}\n")
    return DecodeResult(hyps, refs, metrics, audio_sec, wall)
