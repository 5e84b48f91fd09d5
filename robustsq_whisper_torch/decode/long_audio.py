"""Long-audio target-speaker decoding by batched 30 s windows.

Mirrors the JAX package's ``decode/long_audio.py``. The fixed-window
dataset path crops every utterance to the model's 30 s positional budget
(the reference's ``--max_wav_duration 30``); here the waveform is split
into fixed windows, the windows ride the batch axis through the encoder
with the same enrollment (the speaker prompt belongs to the speaker, not
to the window), they are decoded together, and the per-window token
streams are spliced in order.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..audio.frontend import SAMPLE_RATE, log_mel_spectrogram, pcm16_log_mel
from .search import DecodeConfig, build_beam_decoder, strip_eot


def chunk_waveform(
    wav: np.ndarray,  # (samples,) float32
    chunk_seconds: float = 30.0,
    sample_rate: int = SAMPLE_RATE,
) -> Tuple[np.ndarray, np.ndarray]:
    """One waveform as back-to-back windows: ``(windows (n, chunk_samples)``
    zero-padded, ``lens (n,)`` true sample counts)."""
    chunk = int(round(chunk_seconds * sample_rate))
    n = max(1, -(-len(wav) // chunk))
    windows = np.zeros((n, chunk), np.float32)
    lens = np.zeros((n,), np.int32)
    for i in range(n):
        piece = wav[i * chunk : (i + 1) * chunk]
        windows[i, : len(piece)] = piece
        lens[i] = len(piece)
    return windows, lens


def decode_long_audio(
    encoder: Any,  # QFormerTSEncoder
    decoder: Any,  # TSDecoder
    wav: np.ndarray,  # (samples,) the target-speaker mixture, any length
    enroll: np.ndarray,  # (samples,) enrollment audio of the target speaker
    dcfg: DecodeConfig = DecodeConfig(),
    chunk_seconds: float = 30.0,
    device="cuda",
) -> List[int]:
    """Token ids of arbitrarily long audio: its windows encoded and decoded
    as one batch, their token streams spliced in order. The enrollment mel
    is computed once and broadcast over the windows (its full length is
    the mask)."""
    dev = resolve_device(device)
    encoder.to(dev).eval()
    windows, lens = chunk_waveform(wav, chunk_seconds=chunk_seconds)
    n = windows.shape[0]
    n_mels = encoder.dims.n_mels
    with torch.inference_mode():
        feats, feats_lens = pcm16_log_mel(windows, lens, n_mels, dev)
        e1, _ = log_mel_spectrogram(
            torch.from_numpy(np.asarray(enroll, np.float32))[None].to(dev), n_mels=n_mels
        )
        efeats = e1.expand(n, *e1.shape[1:])
        efeats_lens = torch.full((n,), e1.shape[-1], dtype=torch.int32, device=dev)
        memory, _, spk_prompt, _ = encoder(feats, feats_lens, efeats, efeats_lens)
    tokens = build_beam_decoder(decoder, dcfg, dev)(memory, spk_prompt)[0].cpu().numpy()
    out: List[int] = []
    for row in strip_eot(tokens, dcfg.eot):
        out.extend(row)
    return out


def decode_dataset_long(
    encoder: Any,
    decoder: Any,
    dataset: Any,  # KaldiTSDataset
    tokenizer: Any,
    dcfg: DecodeConfig = DecodeConfig(),
    chunk_seconds: float = 30.0,
    output_dir: Optional[str] = None,
    window_batch: int = 16,
    device="cuda",
):
    """Long-audio decode of a whole Kaldi data dir: each utterance read at
    full length, windowed, and decoded in batches of at most
    ``window_batch`` windows (which bounds the encoder's and the decode's
    memory for any length). The enrollment is cropped or padded to the
    dataset's ``enroll_samples`` (its true length the mask). Returns a
    ``DecodeResult`` like ``decode_dataset``."""
    import time

    from .pipeline import score_and_write

    dev = resolve_device(device)
    max_chunk_s = encoder.dims.n_audio_ctx * 2 * 160 / SAMPLE_RATE
    if chunk_seconds > max_chunk_s + 1e-9:
        raise ValueError(
            f"chunk_seconds {chunk_seconds} exceeds the model's positional "
            f"budget ({max_chunk_s:.2f} s = n_audio_ctx * 2 frames)"
        )
    encoder.to(dev).eval()
    run = build_beam_decoder(decoder, dcfg, dev)
    n_mels = encoder.dims.n_mels
    hyps, refs = {}, {}
    audio_sec = 0.0
    t0 = time.time()
    for utt in dataset.utt_ids:
        wav = dataset._load_audio(dataset.wav[utt].split()[0])
        enroll = np.asarray(dataset._enroll_audio(utt), np.float32)[: dataset.enroll_samples]
        e_len = len(enroll)
        if e_len < dataset.enroll_samples:
            enroll = np.pad(enroll, (0, dataset.enroll_samples - e_len))
        with torch.inference_mode():
            e1, e1_lens = log_mel_spectrogram(
                torch.from_numpy(enroll)[None].to(dev),
                torch.tensor([e_len], dtype=torch.int32, device=dev), n_mels=n_mels,
            )
        windows, lens = chunk_waveform(wav, chunk_seconds=chunk_seconds)
        ids: List[int] = []
        for s in range(0, windows.shape[0], window_batch):
            w, wl = windows[s : s + window_batch], lens[s : s + window_batch]
            n = w.shape[0]
            with torch.inference_mode():
                feats, feats_lens = pcm16_log_mel(w, wl, n_mels, dev)
                memory, _, spk_prompt, _ = encoder(
                    feats, feats_lens, e1.expand(n, *e1.shape[1:]), e1_lens.expand(n)
                )
            tokens = run(memory, spk_prompt)[0].cpu().numpy()
            for row in strip_eot(tokens, dcfg.eot):
                ids.extend(row)
        hyps[utt] = tokenizer.decode(ids).strip()
        refs[utt] = dataset.text.get(utt, "")
        audio_sec += len(wav) / SAMPLE_RATE
    wall = time.time() - t0
    return score_and_write(hyps, refs, audio_sec, wall, output_dir)
