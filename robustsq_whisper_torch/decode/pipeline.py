"""The serving program pair (encode, run) and the sub-batched encode.

Mirrors the single-device Qformer case of the JAX package's
``decode/pipeline.py::build_decode_fns``: greedy or beam search as
``DecodeConfig.beam_size`` says (``run`` returns the best beam of each
utterance), or speculative greedy decode when ``speculative_gamma > 0``
(``run`` then also returns the draft-acceptance counters, and ``draft``
may give a separate draft decoder). Mesh serving (data or tensor
parallel), joint CTC and embedding enrollment are later slices and raise
``NotImplementedError``. The Kaldi data-dir batch job (``decode_dataset``)
comes with ROADMAP A8's bench.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .._device import resolve_device
from ..models.ts_decoder import TSDecoder
from ..models.ts_encoder import QFormerTSEncoder
from .search import DecodeConfig, build_beam_decoder
from .speculative import build_speculative_decoder


def chunked_encode(enc_fn, feats, feats_lens, efeats, efeats_lens, chunk):
    """Encode in sub-batches of ``chunk`` rows and concatenate, bounding the
    encoder's activation peak separately from the decode batch. ``chunk``
    <= 0 or >= batch encodes in one call. Returns (memory, spk_prompt)."""
    b = feats.shape[0]
    if chunk <= 0 or chunk >= b:
        memory, _, spk_prompt, _ = enc_fn(feats, feats_lens, efeats, efeats_lens)
        return memory, spk_prompt
    mems, prompts = [], []
    for s in range(0, b, chunk):
        sl = slice(s, s + chunk)
        m, _, p, _ = enc_fn(feats[sl], feats_lens[sl], efeats[sl], efeats_lens[sl])
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
):
    """``(encode, run)``: ``encode(mel, flens, emel, elens)`` returns the
    encoder 4-tuple, ``run(memory, spk_prompt)`` returns (tokens, scores[,
    stats]). Moves the modules to ``device``."""
    if draft is not None and not (dcfg.speculative_gamma > 0 and mesh is None):
        raise ValueError(
            "a draft decoder requires the single-device speculative path: "
            "speculative_gamma > 0 and no mesh"
        )
    if mesh is not None:
        raise NotImplementedError("multi-GPU serving is ROADMAP A15")
    if not isinstance(encoder, QFormerTSEncoder):
        raise NotImplementedError("embedding enrollment is ROADMAP A14")
    dev = resolve_device(device)
    if dcfg.speculative_gamma > 0:
        # the acceptance counters say whether speculation pays on these weights
        run = build_speculative_decoder(
            decoder, dcfg, dev, return_stats=True, draft=draft
        )
    else:
        run = build_beam_decoder(decoder, dcfg, dev)
    encoder.to(dev).eval()

    @torch.inference_mode()
    def encode(mel, flens, emel, elens):
        return encoder(mel.to(dev), flens.to(dev), emel.to(dev), elens.to(dev))

    return encode, run
