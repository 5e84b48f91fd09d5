"""Kaldi-dir-backed target-speaker dataset with fixed-shape batching.

Mirrors the JAX package's ``data/dataset.py``. Reads a data dir
containing::

    wav.scp  utt2spk  text  enroll.scp  [spk2enroll.json]  [resnet.scp]

- ``text`` is tokenized with the given tokenizer (ids, not words);
- lazy ``*utt spk`` enrollment rows resolve to a random same-speaker
  enrollment utterance, and enrollments longer than ``enroll_seconds``
  are cropped at a random start;
- batches are fixed-shape (speech padded or cut to ``speech_seconds``);
- ``neg_logits`` / ``spk_labels`` come from the utt ids (``collate.py``);
- with ``enroll_type="embedding"`` a batch carries ``enroll_embed`` (B,
  enroll_size) from the stage-103 ``{enroll_prefix}.scp`` (default
  ``resnet.scp``) in place of enrollment audio: a lazy ``*utt spk`` row
  resolves to a random same-speaker enrollment utterance, whose id keys
  the scp; a concrete or absent row keys it by the mixture utt.

The random draws are the JAX package's, in its order, from one
``np.random.default_rng(seed)``: the shuffle of ``batches``, then per
utterance the enrollment pick and the crop start (with embeddings the
pick alone); so a seed picks the same enrollments and crops in both
packages. The speech window of a batch is
read in one call of the native reader (``data/native_loader.py``, WAV and
FLAC over a thread pool), or file by file with scipy where that reader
cannot be built; ``BATCH_READS`` counts the batches each served.
"""

from __future__ import annotations

import collections
import logging
import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from . import collate, kaldi_io, native_loader

# batches whose speech each reader served, {"native": n, "scipy": m}
BATCH_READS: collections.Counter = collections.Counter()


class KaldiTSDataset:
    """Target-speaker triplet dataset: (speech, enroll, text) per utt, at
    the JAX package's defaults for what no caller sets: 16 kHz audio, 128
    text tokens, ``spk2enroll.json`` in the dir."""

    sample_rate = 16000
    text_len = 128

    def __init__(
        self,
        data_dir: str,
        tokenizer,
        speech_seconds: float = 30.0,
        enroll_seconds: float = 10.0,
        utt_style: str = "libri2mix",
        num_speakers: Optional[int] = None,
        seed: int = 0,
        enroll_type: str = "audio",
        enroll_prefix: str = "resnet",
    ):
        self.data_dir = data_dir
        self.tokenizer = tokenizer
        self.speech_samples = int(speech_seconds * self.sample_rate)
        self.enroll_samples = int(enroll_seconds * self.sample_rate)
        self.utt_style = utt_style
        self.num_speakers = num_speakers
        self.rng = np.random.default_rng(seed)
        self.speaker_to_id: Dict[str, int] = {}

        self.wav = kaldi_io.read_scp(os.path.join(data_dir, "wav.scp"))
        self.text = kaldi_io.read_scp(os.path.join(data_dir, "text"))
        enroll_path = os.path.join(data_dir, "enroll.scp")
        self.enroll = kaldi_io.read_scp(enroll_path) if os.path.exists(enroll_path) else {}
        s2e = os.path.join(data_dir, "spk2enroll.json")
        self.spk2enroll = kaldi_io.read_spk2enroll(s2e) if os.path.exists(s2e) else None
        self.utt_ids: List[str] = sorted(set(self.wav) & set(self.text))
        self.enroll_type, self.enroll_prefix = enroll_type, enroll_prefix
        self.embed_scp: Dict[str, str] = {}
        if enroll_type == "embedding":
            scp_path = os.path.join(data_dir, f"{enroll_prefix}.scp")
            if not os.path.exists(scp_path):
                raise FileNotFoundError(
                    f"{scp_path}: enroll_type=embedding needs the stage-103 "
                    f"embedding scp (cli.datapre extract_embeddings)"
                )
            self.embed_scp = kaldi_io.read_scp(scp_path)
        elif enroll_type != "audio":
            raise ValueError(f"enroll_type must be audio|embedding, got {enroll_type}")
        self.reader = native_loader.reader()
        logging.getLogger("robustsq_whisper_torch.data").info(
            "%s: %d utterances, speech read by the %s reader",
            data_dir, len(self.utt_ids), self.reader)

    def __len__(self) -> int:
        return len(self.utt_ids)

    def _load_audio(self, path: str) -> np.ndarray:
        audio, sr = kaldi_io.read_wav(path)
        if sr != self.sample_rate:
            raise ValueError(f"{path}: sample rate {sr} != {self.sample_rate}")
        return audio

    def _enroll_audio(self, utt_id: str) -> np.ndarray:
        row = self.enroll.get(utt_id)
        if row is None:  # no enrollment: the mixture itself
            return self._load_audio(self.wav[utt_id].split()[0])
        path = kaldi_io.resolve_enrollment(row, self.spk2enroll, self.rng, exclude_utt=utt_id)
        audio = self._load_audio(path)
        if len(audio) > self.enroll_samples:  # random crop
            start = int(self.rng.integers(len(audio) - self.enroll_samples + 1))
            audio = audio[start : start + self.enroll_samples]
        return audio

    def _enroll_embedding(self, utt_id: str) -> np.ndarray:
        """The speaker embedding of ``utt_id``: a lazy row draws a
        same-speaker enrollment utterance, whose id keys the scp; a concrete
        or absent row keys it by the mixture utt."""
        row = self.enroll.get(utt_id)
        key = utt_id
        if row is not None and kaldi_io.is_lazy_enrollment(row):
            enroll_utt, _ = kaldi_io.resolve_enrollment_entry(
                row, self.spk2enroll, self.rng, exclude_utt=utt_id)
            key = enroll_utt if enroll_utt is not None else utt_id
        npy = self.embed_scp.get(key)
        if npy is None:
            raise KeyError(f"{self.enroll_prefix}.scp has no embedding for {key!r} "
                           f"(mixture {utt_id!r})")
        return np.load(npy).astype(np.float32).reshape(-1)

    def batches(
        self, batch_size: int, shuffle: bool = True, drop_last: bool = True
    ) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.utt_ids))
        if shuffle:
            self.rng.shuffle(order)
        for i in range(0, len(order), batch_size):
            idx = order[i : i + batch_size]
            if len(idx) < batch_size:
                if drop_last:
                    break
                # a short last batch wraps to the first utterances
                idx = np.concatenate([idx, order[: batch_size - len(idx)]])
            utts = [self.utt_ids[j] for j in idx]
            paths = [self.wav[u].split()[0] for u in utts]
            if self.reader == "native":
                window, lens = native_loader.load_batch(
                    paths, self.speech_samples, expect_rate=self.sample_rate)
                speech = [window[r, : lens[r]] for r in range(len(utts))]
            else:
                speech = [self._load_audio(p) for p in paths]
            BATCH_READS[self.reader] += 1
            enroll, embeds = None, None
            if self.enroll_type == "embedding":
                embeds = np.stack([self._enroll_embedding(u) for u in utts])
            else:
                enroll = [self._enroll_audio(u) for u in utts]
            texts = [np.asarray(self.tokenizer.encode(self.text[u]), np.int32) for u in utts]
            batch = collate.collate_batch(
                utts, speech, enroll, texts,
                speech_samples=self.speech_samples,
                enroll_samples=self.enroll_samples,
                text_len=self.text_len,
                style=self.utt_style,
                speaker_to_id=self.speaker_to_id,
                num_speakers=self.num_speakers,
                enroll_embeds=embeds,
            )
            batch["utt_ids"] = utts  # host-only metadata
            yield batch
