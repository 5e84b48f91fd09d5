"""Multi-GPU serving: the decode batch split over the data axis of a mesh,
and tensor-parallel weights over its model axis.

Mirrors the JAX package's ``decode/sharded.py`` in PyTorch's idiom, one
process per GPU:

- ``build_sharded_decoder`` / ``build_sharded_encoder`` (data parallel):
  every rank runs the single-device program unchanged (prefill, token loop
  and the hand-written kernels) on its ``b / n_data`` rows. Weights are
  whole on every rank and the program has no collectives; the tokens,
  scores and speculative counters of every rank are all-gathered after the
  loop. A rank's loop can stop early at its own step (``stop_early``), so
  its tokens are padded with eot to the width one device returns before
  the gather.
- ``build_tp_decoder`` / ``build_tp_encoder`` (tensor parallel, the
  capacity mode): the weights are split over the model axis by the
  Megatron rules of ``parallel/mesh.py`` (``parallel.shard.shard_model``):
  each rank holds ``n_head / n_model`` heads of q/k/v and out and its part
  of fc1 and fc2, so its cross and self K/V caches hold its heads only;
  the out and fc2 outputs are all-reduced and vocabulary-split logits
  all-gathered (``parallel/collectives.py``). As in JAX it needs the dense
  path: no quantized cross K/V, no W8A8, the 5-D self cache
  (``flat_self_cache=False``), no flash encoder, and the beam reorder by
  ``index_select`` (``beam_reorder="take"``). The rows split over the data
  axis as above.

The encoders take the whole batch (every rank reads the same batch) and
return this rank's rows; the decoders take this rank's rows and return the
whole batch's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..models.ts_decoder import TSDecoder
from ..parallel.collectives import all_gather_rows
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_group, axis_size, local_rows
from ..parallel.shard import shard_model
from .search import DecodeConfig, build_beam_decoder


def _gather_outputs(out, group, eot: int):
    """Every data rank's rows of a decoder's ``(tokens, scores[, stats])``,
    the tokens padded with ``eot`` to the widest rank's width."""
    if group is None:
        return out
    tokens = out[0]
    width = torch.tensor([tokens.shape[1]], device=tokens.device)
    dist.all_reduce(width, op=dist.ReduceOp.MAX, group=group)
    pad = int(width) - tokens.shape[1]
    if pad:
        tokens = torch.cat([tokens, tokens.new_full((tokens.shape[0], pad), eot)], dim=1)
    gathered = [all_gather_rows(tokens, group), all_gather_rows(out[1], group)]
    if len(out) == 3:
        gathered.append({k: all_gather_rows(v, group) for k, v in out[2].items()})
    return tuple(gathered)


def _wrap(inner, mesh, eot: int):
    group = axis_group(mesh, DATA_AXIS)

    def run(memory: torch.Tensor, spk_prompt: torch.Tensor):
        return _gather_outputs(inner(memory, spk_prompt), group, eot)

    return run


def build_sharded_decoder(
    decoder: TSDecoder,
    dcfg: DecodeConfig,
    mesh,
    device="cuda",
    return_stats: bool = False,
) -> Callable:
    """``run(memory, spk_prompt)`` over this rank's rows -> the whole
    batch's ``(tokens, scores)``, decoding data-parallel over ``mesh``'s
    data axis with the single-device greedy, beam or speculative decoder.
    ``return_stats=True`` (speculative greedy only) also gathers the
    per-row acceptance counters."""
    dev = resolve_device(device)
    if return_stats:
        if not (dcfg.speculative_gamma > 0 and dcfg.beam_size == 1):
            raise ValueError(
                "return_stats is a speculative-greedy feature: needs "
                "speculative_gamma > 0 and beam_size == 1"
            )
        from .speculative import build_speculative_decoder

        inner = build_speculative_decoder(decoder, dcfg, dev, return_stats=True)
    else:
        inner = build_beam_decoder(decoder, dcfg, dev)
    return _wrap(inner, mesh, dcfg.eot)


def build_tp_decoder(decoder: TSDecoder, dcfg: DecodeConfig, mesh, device="cuda") -> Callable:
    """Tensor-parallel serving: ``run(memory, spk_prompt)`` as
    ``build_sharded_decoder``'s, with the decoder's weights (and so its K/V
    caches) split over ``mesh``'s model axis. Shards ``decoder`` in place."""
    assert axis_size(mesh, MODEL_AXIS) > 1, dict(model=axis_size(mesh, MODEL_AXIS))
    assert not dcfg.quantize_cross_kv and not dcfg.quantize_weights, (
        "TP serving runs the dense XLA decode path: build the DecodeConfig "
        "with quantize_cross_kv=False, quantize_weights=False"
    )
    assert not decoder.decoder.flat_self_cache, (
        "TP serving requires TSDecoder(flat_self_cache=False) — the flat "
        "cache's Pallas self-attention cannot be auto-partitioned"
    )
    if dcfg.beam_size > 1 and dcfg.beam_reorder != "take":
        # the "dma"/"auto" cache reorder kernel works on whole rows; the
        # tensor-parallel beam uses index_select, as JAX's uses its gather
        dcfg = dataclasses.replace(dcfg, beam_reorder="take")
    dev = resolve_device(device)
    decoder.to(dev)
    shard_model(decoder, mesh)
    return _wrap(build_beam_decoder(decoder, dcfg, dev), mesh, dcfg.eot)


def build_sharded_encoder(encoder, mesh, device="cuda", enc_chunk: int = 0) -> Callable:
    """``encode(mel, mel_lens, enroll_mel, enroll_lens)`` (the whole batch,
    every rank the same) -> this rank's rows of ``(memory, spk_prompt)``:
    the single-device encoder over this rank's rows, in sub-batches of
    ``enc_chunk / n_data`` rows (``chunked_encode``; ``enc_chunk`` a
    multiple of the data axis, 0 for one call). For
    ``SpkAdapterTSEncoder``: ``encode(mel, mel_lens, enroll_embed)`` ->
    ``(memory, the empty prompt)``."""
    from ..models.ts_encoder import SpkAdapterTSEncoder
    from .pipeline import chunked_encode

    dev = resolve_device(device)
    encoder.to(dev).eval()
    n = axis_size(mesh, DATA_AXIS)

    @torch.inference_mode()
    def enc_rows(mel, flens, *enroll):
        out = encoder(mel.to(dev), flens.to(dev), *(t.to(dev) for t in enroll))
        if isinstance(encoder, SpkAdapterTSEncoder):
            memory = out[0]
            return memory, memory.new_zeros((memory.shape[0], 0, memory.shape[-1]))
        return out[0], out[2]

    def encode(*args):
        assert args[0].shape[0] % n == 0, (
            f"batch {args[0].shape[0]} must be a multiple of the data-axis size ({n})"
        )
        return chunked_encode(enc_rows, local_rows(args, mesh), enc_chunk // n)

    return encode


def build_tp_encoder(encoder, mesh, device="cuda", enc_chunk: int = 0) -> Callable:
    """Tensor-parallel companion of ``build_tp_decoder``: the encoder's
    weights split over ``mesh``'s model axis (in place), the rows over its
    data axis, as ``build_sharded_encoder``. Needs the flash-free encoder,
    as JAX's."""
    assert axis_size(mesh, MODEL_AXIS) > 1, dict(model=axis_size(mesh, MODEL_AXIS))
    assert not encoder.ts.use_flash_attention, (
        "TP serving requires TSEncoderConfig(use_flash_attention=False)"
    )
    encoder.to(resolve_device(device))
    shard_model(encoder, mesh)
    return build_sharded_encoder(encoder, mesh, device, enc_chunk)

