"""The one traffic generator: (mixture, enrollment) pairs, transcripts and
speaker labels from a traffic file's parameters and the run seed.

Audio is tones with five harmonics under a slow envelope plus noise (one
voice a row, its pitch and envelope rate drawn from the seed), made on the
device in chunks and handed over as host float32 arrays, zero-padded to the
window as the recipe pads its 30 s inputs. Every batch holds the same set of
mixture lengths, spread evenly over ``mixture_seconds`` and shuffled by the
seed, so every seed does the same work in another order. Transcripts have
``tokens_per_second`` of the mixture's length in ids from [1, 50257) (no
blank, no special token), padded with -1 to the longest possible.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .weights import generator, sub_seed

SR = 16000


def batch_lengths(traffic: dict, rows: int, rng: np.random.Generator) -> np.ndarray:
    """Sample counts of one batch: ``rows`` lengths evenly over the
    traffic's ``mixture_seconds`` range, in a seeded order."""
    lo, hi = traffic["mixture_seconds"]
    secs = lo + (hi - lo) * (np.arange(rows) + 0.5) / rows
    return rng.permutation(np.round(secs * SR).astype(np.int64))


@torch.no_grad()
def voices(lengths: np.ndarray, window_s: float, seed: int, stream: str, device,
           chunk: int = 128) -> np.ndarray:
    """(len(lengths), window_s * 16000) float32 host array."""
    n, width = len(lengths), int(round(window_s * SR))
    out = np.zeros((n, width), np.float32)
    g = generator(seed, stream, device)
    t = torch.arange(width, device=device, dtype=torch.float32) / SR
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        f0 = 90.0 + 210.0 * torch.rand(m, 1, generator=g, device=device)
        rate = 2.0 + 3.0 * torch.rand(m, 1, generator=g, device=device)
        x = sum(torch.sin((2 * math.pi * h) * f0 * t) / h for h in range(1, 6))
        env = 0.5 + 0.5 * torch.sin(2 * math.pi * rate * t)
        x = 0.1 * x * env + 0.01 * torch.randn(m, width, generator=g, device=device)
        lens = torch.as_tensor(lengths[s:s + m], device=device)
        x = torch.where(t[None] * SR < lens[:, None], x, 0.0)
        out[s:s + m] = x.cpu().numpy()
    return out


def decode_pool(traffic: dict, seed: int, device) -> Dict[str, np.ndarray]:
    """``pool_batches`` batches of ``batch_size`` pairs: speech, its
    lengths, enrollments and theirs."""
    b, nb = traffic["batch_size"], traffic["pool_batches"]
    rng = np.random.default_rng(sub_seed(seed, "decode-lengths"))
    lens = np.concatenate([batch_lengths(traffic, b, rng) for _ in range(nb)])
    enr = int(traffic["enroll_seconds"] * SR)
    return {
        "speech": voices(lens, traffic["window_seconds"], seed, "speech", device),
        "speech_lens": lens.astype(np.int32),
        "enroll": voices(np.full(b * nb, enr), traffic["enroll_seconds"], seed, "enroll", device),
        "enroll_lens": np.full(b * nb, enr, np.int32),
    }


def text_pad(traffic: dict) -> int:
    return int(math.ceil(traffic["tokens_per_second"] * traffic["mixture_seconds"][1]))


def train_pool(traffic: dict, cfg: dict, seed: int, device) -> List[Dict[str, np.ndarray]]:
    """``pool_batches`` global training batches (``batch_size`` rows, the
    loop's batch: every rank is handed all of it) as the port's
    collated batches: speech, enrollment or speaker embedding, text,
    speaker labels and the same-speaker mask."""
    b, nb = traffic["batch_size"], traffic["pool_batches"]
    rng = np.random.default_rng(sub_seed(seed, "train-draws"))
    lens = np.concatenate([batch_lengths(traffic, b, rng) for _ in range(nb)])
    speech = voices(lens, traffic["window_seconds"], seed, "speech", device)
    emb_enroll = cfg["encoder"]["enroll_type"] == "embedding"
    enr = int(traffic["enroll_seconds"] * SR)
    if emb_enroll:
        e = rng.standard_normal((b * nb, cfg["encoder"]["enroll_size"])).astype(np.float32)
        enroll = e / np.linalg.norm(e, axis=1, keepdims=True)
    else:
        enroll = voices(np.full(b * nb, enr), traffic["enroll_seconds"], seed, "enroll", device)
    pad = text_pad(traffic)
    batches = []
    for k in range(nb):
        rows = slice(k * b, (k + 1) * b)
        n_tok = np.round(traffic["tokens_per_second"] * lens[rows] / SR).astype(np.int32)
        text = np.full((b, pad), -1, np.int32)
        for r in range(b):
            text[r, : n_tok[r]] = rng.integers(1, 50257, n_tok[r])
        labels = rng.integers(0, cfg["model"]["num_speakers"], b).astype(np.int32)
        batch = {
            "speech": speech[rows],
            "speech_lens": lens[rows].astype(np.int32),
            "text": text,
            "text_lens": n_tok,
            "spk_labels": labels,
            "neg_logits": np.where(labels[:, None] == labels[None, :], -10000.0, 1.0).astype(np.float32),
        }
        if emb_enroll:
            batch["enroll_embed"] = enroll[rows]
        else:
            batch["enroll"] = enroll[rows]
            batch["enroll_lens"] = np.full(b, enr, np.int32)
        batches.append(batch)
    return batches
