#!/usr/bin/env python3
"""Multi-GPU check of the port on the GPUs of one host, or on one card.

    python -m torch.distributed.run --nproc_per_node 4 multi_gpu_check.py
    python -m torch.distributed.run --nproc_per_node 2 multi_gpu_check.py --one-card

One process a GPU over NCCL (``parallel.mesh.init_distributed``), Whisper-
medium at full width and depth in bf16 with seeded random weights. With
``--one-card`` every rank computes on GPU 0 and the collectives go over
gloo (NCCL does not hold two ranks of one communicator on one GPU). Every
rank holds the same global batch:

- data-parallel decode (``build_decode_fns`` on an ``(n, 1)`` mesh) of 4
  (30 s, 10 s) pairs a rank, greedy and beam 5, at most 32 new tokens over
  the int4 cross K/V. Each rank then decodes its own rows alone, as one
  device would; that must equal its rows of the sharded decode bit for bit
  (tokens, the eot fill past its own width, scores) with the same launches
  of every kernel. Beside it, the share of tokens equal to one device's
  decode of the whole batch (the whole batch takes other shape-chosen
  kernel schedules than a rank's rows, so bf16 sums, and with random
  weights near-tied tokens, may differ);
- tensor-parallel decode on an ``(n / 2, 2)`` mesh (the dense path: no
  flash, no quantized cross K/V, the 5-D self cache), greedy, against the
  one-device dense decode: the share of equal tokens (not with
  ``--one-card``);
- one data-parallel lora step and one FSDP step (full; lora with
  ``--one-card``) at batch 8 against one device's step from the same
  weights: the loss to 5e-5 and the gradient norm to 1e-2 relative, about
  three times the largest bf16 errors read on H100s (1.75e-5 and 3.9e-3
  with two gloo ranks on one card, 3.8e-6 and 2.0e-3 over four cards: a
  rank's rows take other GEMM and kernel schedules than the whole batch),
  the three flash training kernels launched on every rank as
  ``TRAIN_KERNELS`` says; the peak memory a rank.

Any failed check fails the run. Rank 0 prints the card's name and power
limit and, last, one JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import numpy as np

STEP_RTOL = {"loss": 5e-5, "grad_norm": 1e-2}
TRAIN_B = 8  # the training batch: 8 x (30 s speech, 10 s enrollment)
TRAIN_KERNELS = {"flash_attention": 48, "flash_attention_bwd_dq": 24,
                 "flash_attention_bwd_dkv": 24}  # per step at medium
MESH_PATHS = {  # path -> (decode config, kernels the decoder must launch)
    "greedy": ({}, ("decode_cross_attention", "decode_self_attention")),
    "beam 5": (dict(beam_size=5), ("decode_cross_attention_grouped", "beam_reorder_cache",
                                   "decode_self_attention")),
}


def gpu_info() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def launch_counters():
    """{kernel: (wrapper, counter attribute)}, every kernel."""
    from robustsq_whisper_torch.ops import beam_gather as bg
    from robustsq_whisper_torch.ops import decode_attention as xa
    from robustsq_whisper_torch.ops import flash_attention as fa
    from robustsq_whisper_torch.ops import quant
    from robustsq_whisper_torch.ops import self_attention as sa

    return {
        "flash_attention_tmaj": (fa.flash_attention_tmaj, "launches"),
        "flash_attention_tmaj_rows": (fa.flash_attention_tmaj, "rows_launches"),
        "decode_cross_attention": (xa.decode_cross_attention, "launches"),
        "decode_cross_attention_grouped": (xa.decode_cross_attention, "grouped_launches"),
        "decode_self_attention": (sa.decode_self_attention, "launches"),
        "decode_self_attention_int8": (sa.decode_self_attention, "int8_launches"),
        "decode_cross_attention_state": (xa.decode_cross_attention, "state_launches"),
        "beam_reorder_cache": (bg.beam_reorder_cache, "launches"),
        "beam_reorder_cache_flat": (bg.beam_reorder_cache, "flat_launches"),
        "settled_self_attention": (sa.settled_self_attention, "launches"),
        "flash_attention": (fa.flash_attention_fwd, "launches"),
        "flash_attention_bwd_dq": (fa.flash_attention_bwd_dq, "launches"),
        "flash_attention_bwd_dkv": (fa.flash_attention_bwd_dkv, "launches"),
        "w8a8_matmul": (quant.qmatmul, "launches"),
    }


def counted(torch, fn):
    """Run ``fn`` with every launch count set to 0 just before and read just
    after; returns (its result, {kernel: launches})."""
    counters = launch_counters()
    torch.cuda.synchronize()
    for w, attr in counters.values():
        setattr(w, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    return out, {n: getattr(w, attr) for n, (w, attr) in counters.items()}


def warm_counted(torch, fn):
    """``fn()`` after one warm call, launches counted."""
    fn()
    return counted(torch, fn)


def synthetic_pairs(n: int, seed: int, seconds: float = 30.0):
    """(speech ``seconds``, enrollment 10 s) pairs: tones with harmonics +
    noise."""
    rng = np.random.default_rng(seed)
    sr = 16000

    def voice(seconds, f0):
        t = np.arange(int(seconds * sr)) / sr
        x = sum(np.sin(2 * np.pi * f0 * h * t) / h for h in range(1, 6))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t)
        return (0.1 * x * env + 0.01 * rng.standard_normal(t.size)).astype(np.float32)

    return [(voice(seconds, 110 + 20 * i), voice(10.0, 110 + 20 * i)) for i in range(n)]


def medium_models(torch, dev):
    """Whisper-medium TS encoder and decoder, bf16, seeded random weights."""
    from robustsq_whisper_torch.init import init_params
    from robustsq_whisper_torch.models import (
        QFormerTSEncoder, TSDecoder, TSEncoderConfig, whisper_dims,
    )

    dims = whisper_dims("medium")
    ts = TSEncoderConfig(
        num_query_tokens=16, num_hidden_layers=2, use_flash_attention=True,
        flash_tmaj=True, gelu_approx=True,
    )
    enc = init_params(QFormerTSEncoder(dims, ts), 0).to(dev, torch.bfloat16)
    dec = init_params(TSDecoder(dims, cross_kv_bits=4, self_kv_bits=16), 1)
    return dims, enc, dec.to(dev, torch.bfloat16)


def serving_config(max_new: int, **cfg):
    """The serving DecodeConfig: int4 cross K/V kernel, stop early."""
    from robustsq_whisper_torch.decode.search import DecodeConfig
    from robustsq_whisper_torch.tokenizer import special_tokens

    st = special_tokens(multilingual=True)
    return DecodeConfig(
        max_new_tokens=max_new, eot=st.eot,
        init_tokens=st.sot_sequence("en", "transcribe", True),
        quantize_cross_kv=True, stop_early=True, **cfg,
    )


def engine_for(torch, dev, enc, dec, batch: int, max_new: int, **cfg):
    from robustsq_whisper_torch.serve import EngineConfig, TranscriptionEngine
    from robustsq_whisper_torch.tokenizer import ByteTokenizer

    return TranscriptionEngine(
        enc, dec, ByteTokenizer(), serving_config(max_new, **cfg),
        EngineConfig(batch_size=batch, speech_seconds=30.0, enroll_seconds=10.0),
        device=dev,
    )


def train_batch(torch, dev, b: int, vocab: int):
    """b x (30 s speech, 10 s enrollment), 48 text tokens, every other row
    a valid negative."""
    g = torch.Generator(device=dev).manual_seed(0)
    return {
        "speech": torch.randn(b, 30 * 16000, generator=g, device=dev) * 0.1,
        "speech_lens": torch.full((b,), 30 * 16000, device=dev),
        "enroll": torch.randn(b, 10 * 16000, generator=g, device=dev) * 0.1,
        "enroll_lens": torch.full((b,), 10 * 16000, device=dev),
        "text": torch.randint(0, vocab - 4, (b, 48), generator=g, device=dev),
        "text_lens": torch.full((b,), 48, device=dev),
        "neg_logits": torch.ones(b, b, device=dev),
        "spk_labels": torch.randint(0, 1000, (b,), generator=g, device=dev),
    }


def agreement(a, b) -> float:
    return float((a.cpu() == b.cpu()).float().mean())


def check_rank_rows(torch, mesh, got, counts, alone, alone_counts, eot: int, path: str) -> None:
    """This rank's rows of the sharded decode ``got`` against its decode of
    them alone: bit for bit, the same launches."""
    from robustsq_whisper_torch.parallel.mesh import local_rows

    tokens, width = local_rows(got[0], mesh), alone[0].shape[1]
    same = (torch.equal(tokens[:, :width], alone[0])
            and bool((tokens[:, width:] == eot).all())
            and all(torch.equal(local_rows(g, mesh), a) for g, a in zip(got[1:], alone[1:])))
    if not same or counts != alone_counts:
        raise AssertionError(f"DP {path}: this rank's rows equal its decode alone {same}; "
                             f"launches {counts} against {alone_counts}")


def check_decode(torch, dev, n: int, one_card: bool, report: dict) -> None:
    """DP greedy and beam 5 (each rank's rows witnessed), TP greedy."""
    import torch.distributed as dist
    from robustsq_whisper_torch.decode.pipeline import build_decode_fns
    from robustsq_whisper_torch.models import QFormerTSEncoder, TSDecoder
    from robustsq_whisper_torch.parallel.mesh import local_rows, make_mesh

    dims, enc, dec = medium_models(torch, dev)
    batch, max_new = 4 * n, 32
    staged = engine_for(torch, dev, enc, dec, batch, max_new).stage(
        synthetic_pairs(batch, seed=0))
    dp = make_mesh(n, 1)
    for path, (cfg, expect) in MESH_PATHS.items():
        dcfg = serving_config(max_new, **cfg)
        encode, run = build_decode_fns(enc, dec, dcfg, device=dev)
        ref, _ = warm_counted(torch, lambda: run(*encode(*staged)))
        mine = local_rows(staged, dp)
        alone, alone_counts = warm_counted(torch, lambda: run(*encode(*mine)))
        s_encode, s_run = build_decode_fns(enc, dec, dcfg, mesh=dp, device=dev)
        got, counts = warm_counted(torch, lambda: s_run(*s_encode(*staged)))
        if got[0].shape[0] != ref[0].shape[0]:
            raise AssertionError(f"DP {path}: tokens {tuple(got[0].shape)}, one device "
                                 f"{tuple(ref[0].shape)}")
        check_rank_rows(torch, dp, got, counts, alone, alone_counts, dcfg.eot, path)
        missing = [k for k in ("flash_attention_tmaj",) + expect if counts[k] == 0]
        if missing:
            raise AssertionError(f"DP {path}: kernels not launched: {missing}")
        launches = [None] * n
        dist.all_gather_object(launches, counts)
        width = min(got[0].shape[1], ref[0].shape[1])
        report[f"DP {path}"] = {
            "mesh": [n, 1], "batch": batch, "rank_rows_equal_alone": True, "launches_by_rank": launches,
            "tokens_equal_whole_batch": agreement(got[0][:, :width], ref[0][:, :width]),
            "widths": [got[0].shape[1], ref[0].shape[1]]}
    if one_card:
        return

    # tensor parallel: dense copies of the same weights, sharded in place
    ts = dataclasses.replace(enc.ts, use_flash_attention=False, flash_tmaj=False)
    t_enc = QFormerTSEncoder(dims, ts).to(dev, torch.bfloat16)
    t_enc.load_state_dict(enc.state_dict())
    t_dec = TSDecoder(dims, cross_kv_bits=4, flat_self_cache=False).to(dev, torch.bfloat16)
    t_dec.load_state_dict(dec.state_dict())
    del enc, dec
    dcfg = dataclasses.replace(serving_config(max_new), quantize_cross_kv=False)
    encode, run = build_decode_fns(t_enc.eval(), t_dec.eval(), dcfg, device=dev)
    ref, _ = warm_counted(torch, lambda: run(*encode(*staged)))
    tp = make_mesh(n // 2, 2)
    s_encode, s_run = build_decode_fns(t_enc, t_dec, dcfg, mesh=tp, device=dev)
    got, _ = warm_counted(torch, lambda: s_run(*s_encode(*staged)))
    if got[0].shape[0] != ref[0].shape[0]:
        raise AssertionError(f"TP greedy: tokens {tuple(got[0].shape)}")
    width = min(got[0].shape[1], ref[0].shape[1])
    report["TP greedy (dense)"] = {"mesh": [n // 2, 2],
                                   "tokens_equal": agreement(got[0][:, :width],
                                                             ref[0][:, :width])}
    del t_enc, t_dec
    torch.cuda.empty_cache()


def check_training(torch, dev, n: int, one_card: bool, report: dict) -> None:
    """A DP lora step and an FSDP step against one device's."""
    from robustsq_whisper_torch.init import init_params
    from robustsq_whisper_torch.models import TSASRModel, TSEncoderConfig, TSModelConfig
    from robustsq_whisper_torch.models import whisper_dims
    from robustsq_whisper_torch.parallel.mesh import make_mesh
    from robustsq_whisper_torch.train import OptimConfig, TrainConfig
    from robustsq_whisper_torch.train import create_train_state, make_train_step
    from robustsq_whisper_torch.train.lora import detach_lora

    dims = whisper_dims("medium")
    ts = TSEncoderConfig(use_flash_attention=True, remat=True)
    batch = train_batch(torch, dev, TRAIN_B, dims.n_vocab)
    moments = {"lora": "float32", "full": "bfloat16"}
    # one model for every step, its weights restored before each; the
    # FSDP step shards it in place and comes last
    model = init_params(TSASRModel(dims, ts, TSModelConfig()), 2)
    model.set_compute_dtype(torch.bfloat16)
    model.to(dev)
    saved = {k: p.detach().clone() for k, p in model.named_parameters()}

    def step_once(mode: str, mesh, fsdp: bool) -> dict:
        detach_lora(model)
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(saved[k])
        cfg = TrainConfig(mode=mode, optim=OptimConfig(moment_dtype=moments[mode]), fsdp=fsdp)
        state = create_train_state(model, cfg, device=dev, mesh=mesh)
        step = make_train_step(model, cfg, device=dev, mesh=mesh)
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        (_, stats), counts = counted(torch, lambda: step(state, batch, gen, 0))
        out = dict(loss=stats["loss"].item(), grad_norm=stats["grad_norm"].item(),
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                   launches={k: counts[k] for k in TRAIN_KERNELS})
        del state, step
        torch.cuda.empty_cache()
        return out

    one_device = {}
    for mode, fsdp in (("lora", False), ("lora" if one_card else "full", True)):
        if mode not in one_device:
            one_device[mode] = step_once(mode, None, False)
        one, got = one_device[mode], step_once(mode, make_mesh(n, 1), fsdp)
        err = {k: abs(got[k] - one[k]) / abs(one[k]) for k in STEP_RTOL}
        name = f"{'FSDP' if fsdp else 'DP'} {mode} step"
        report[name] = {"mesh": [n, 1], "batch": TRAIN_B, **got, "one_device": one,
                        "rel_err": err}
        if any(err[k] > tol for k, tol in STEP_RTOL.items()):
            raise AssertionError(f"{name}: {got} against one device's {one}, bars {STEP_RTOL}")
        if got["launches"] != TRAIN_KERNELS:
            raise AssertionError(f"{name}: launches {got['launches']}, want {TRAIN_KERNELS}")


def main(argv) -> int:
    import torch

    from robustsq_whisper_torch.parallel.mesh import init_distributed, local_device, rank

    one_card = "--one-card" in argv
    if not torch.cuda.is_available():
        print("multi_gpu_check: no CUDA device", file=sys.stderr)
        return 1
    n = init_distributed(device="cpu" if one_card else "cuda")
    if n < 2 or n % 2:
        print(f"multi_gpu_check: needs an even number of ranks, got {n}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0) if one_card else local_device("cuda")
    report: dict = {"world": n, "backend": torch.distributed.get_backend(),
                    "one_card": one_card}
    check_decode(torch, dev, n, one_card, report)
    check_training(torch, dev, n, one_card, report)
    first = rank() == 0
    torch.distributed.destroy_process_group()
    if first:
        print(gpu_info())
        print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
