"""Host-side batch collation: utt-id parsing, negative-mask logits, padding.

The port's copy of the JAX package's ``data/collate.py`` (numpy only). The
collator parses the speaker out of each utterance id once a batch and
ships plain arrays: the same-speaker mask the contrastive loss samples
negatives from (``neg_logits``) and the AAM speaker labels.

Utt-id formats (one parser per dataset):
- libri2mix: ``{spk1utt}_{spk2utt}_spk{1,2}`` -> speaker of the targeted slot,
  e.g. ``100-121669-0004_1089-134686-0000_spk1`` -> ``100``
- wsj2mix: last ``_``-field's first 3 chars
- ami: 4th ``_``-field
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

NEG_MASK_VALUE = -10000.0


def parse_speaker(utt_id: str, style: str = "libri2mix") -> str:
    # Augmentation stages prefix ids (add_wham_noise emits noisy_<id>, copies
    # may add aug_/rvb_, possibly chained); strip them all BEFORE any
    # positional parse or the wrong field is selected for every style.
    stripped = True
    while stripped:
        stripped = False
        for prefix in ("noisy_", "aug_", "rvb_"):
            if utt_id.startswith(prefix):
                utt_id = utt_id[len(prefix):]
                stripped = True
    if style == "wsj2mix":
        return utt_id.split("_")[-1][:3]
    if style == "ami":
        return utt_id.split("_")[3]
    # libri2mix: trailing spk{1,2} selects which field holds the target spk
    idx = int(utt_id[-1]) - 1
    return utt_id.split("_")[idx].split("-")[0]


def similarity_matrix(utt_ids: Sequence[str], style: str = "libri2mix") -> np.ndarray:
    """(B, B) 1.0 where same target speaker."""
    spks = [parse_speaker(u, style) for u in utt_ids]
    arr = np.asarray(spks)
    return (arr[:, None] == arr[None, :]).astype(np.float32)


def negative_logits(utt_ids: Sequence[str], style: str = "libri2mix") -> np.ndarray:
    """Pre-softmax sampling logits: 1.0 valid / -10000 same-speaker
    (the contrastive loss samples negatives from them)."""
    sim = similarity_matrix(utt_ids, style)
    return np.where(sim == 1.0, NEG_MASK_VALUE, 1.0).astype(np.float32)


def speaker_labels(
    utt_ids: Sequence[str],
    style: str = "libri2mix",
    speaker_to_id: Optional[Dict[str, int]] = None,
    num_speakers: Optional[int] = None,
) -> np.ndarray:
    """Int speaker labels for AAM.

    With a persistent ``speaker_to_id`` (recommended) ids are globally stable
    across batches; ids are numbered per batch when it is None.
    ``num_speakers`` wraps ids into the classifier range.
    """
    local = speaker_to_id if speaker_to_id is not None else {}
    labels = []
    for u in utt_ids:
        spk = parse_speaker(u, style)
        if spk not in local:
            local[spk] = len(local)
        lab = local[spk]
        if num_speakers is not None:
            lab = lab % num_speakers
        labels.append(lab)
    return np.asarray(labels, dtype=np.int32)


def pad_1d(arrays: List[np.ndarray], length: int, value: float = 0.0) -> np.ndarray:
    """Stack variable-length 1-D arrays into (B, length), truncating/padding."""
    out = np.full((len(arrays), length), value, dtype=np.float32)
    for i, a in enumerate(arrays):
        n = min(len(a), length)
        out[i, :n] = a[:n]
    return out


def collate_batch(
    utt_ids: Sequence[str],
    speech: List[np.ndarray],
    enroll: Optional[List[np.ndarray]],
    texts: List[np.ndarray],
    speech_samples: int,
    enroll_samples: int,
    text_len: int,
    style: str = "libri2mix",
    speaker_to_id: Optional[Dict[str, int]] = None,
    num_speakers: Optional[int] = None,
    ignore_id: int = -1,
    enroll_embeds: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Build the fixed-shape training batch dict consumed by TSASRModel.

    ``enroll`` is the list of enrollment waveforms (enroll_type "audio");
    for embedding enrollment pass ``enroll=None`` and the stacked
    ``enroll_embeds`` (B, enroll_size) instead — the batch then carries an
    ``enroll_embed`` key and no enroll audio.
    """
    b = len(utt_ids)
    text_arr = np.full((b, text_len), ignore_id, dtype=np.int32)
    text_lens = np.zeros((b,), dtype=np.int32)
    for i, t in enumerate(texts):
        n = min(len(t), text_len)
        text_arr[i, :n] = t[:n]
        text_lens[i] = n
    batch = {
        "speech": pad_1d(speech, speech_samples),
        "speech_lens": np.minimum(
            np.asarray([len(s) for s in speech], np.int32), speech_samples
        ),
        "text": text_arr,
        "text_lens": text_lens,
        "neg_logits": negative_logits(utt_ids, style),
        "spk_labels": speaker_labels(
            utt_ids, style, speaker_to_id, num_speakers
        ),
    }
    if enroll_embeds is not None:
        batch["enroll_embed"] = np.asarray(enroll_embeds, np.float32)
    else:
        batch["enroll"] = pad_1d(enroll, enroll_samples)
        batch["enroll_lens"] = np.minimum(
            np.asarray([len(e) for e in enroll], np.int32), enroll_samples
        )
    return batch
