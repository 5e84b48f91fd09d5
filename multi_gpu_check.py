#!/usr/bin/env python3
"""Multi-GPU check of the port on the GPUs of one host, or on one card.

    python -m torch.distributed.run --nproc_per_node 4 multi_gpu_check.py
    python -m torch.distributed.run --nproc_per_node 2 multi_gpu_check.py --one-card

One process a GPU over NCCL (``parallel.mesh.init_distributed``), Whisper-
medium at full width and depth in bf16 with chip_smoke's seeded weights.
With ``--one-card`` every rank computes on GPU 0 and the collectives go
over gloo (NCCL does not hold two ranks of one communicator on one GPU);
chip_smoke's phase 4g runs it so. Every rank holds the same global batch:

- data-parallel decode (``build_decode_fns`` on an ``(n, 1)`` mesh) of 4
  (30 s, 10 s) pairs a rank, greedy and beam 5, chip_smoke's serving
  settings. Each rank then decodes its own rows alone, as one device
  would; that must equal its rows of the sharded decode bit for bit
  (tokens, the eot fill past its own width, scores) with the same launches
  of every kernel. Beside it, the share of tokens equal to one device's
  decode of the whole batch, and both runs' ms (the whole batch takes
  other shape-chosen kernel schedules than a rank's rows, so bf16 sums,
  and with random weights near-tied tokens, may differ);
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
  rows 4, 5a and 5b launched on every rank as chip_smoke's
  ``TRAIN_KERNELS``; each step's ms and the peak memory a rank.

Any failed check fails the run. Rank 0 prints the card's name and power
limit and, last, one JSON line.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

STEP_RTOL = {"loss": 5e-5, "grad_norm": 1e-2}


def timed(torch, fn):
    """``fn()`` after one warm call, launches counted (chip_smoke's
    ``counted``); returns (its result, ms, {kernel: launches})."""
    import chip_smoke as cs

    fn()
    out, wall, counts = cs.counted(torch, fn)
    return out, wall * 1e3, counts


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
    import chip_smoke as cs
    import torch.distributed as dist
    from robustsq_whisper_torch.decode.pipeline import build_decode_fns
    from robustsq_whisper_torch.models import QFormerTSEncoder, TSDecoder
    from robustsq_whisper_torch.parallel.mesh import local_rows, make_mesh

    dims, enc, dec = cs.medium_models(torch, dev)
    batch, max_new = 4 * n, 32
    staged = cs.engine_for(torch, dev, enc, dec, batch, max_new).stage(
        cs.synthetic_pairs(batch, seed=0))
    dp = make_mesh(n, 1)
    for path, (cfg, expect) in cs.MESH_PATHS.items():
        dcfg = cs.serving_config(max_new, **cfg)
        encode, run = build_decode_fns(enc, dec, dcfg, device=dev)
        ref, ms_one, _ = timed(torch, lambda: run(*encode(*staged)))
        mine = local_rows(staged, dp)
        alone, _, alone_counts = timed(torch, lambda: run(*encode(*mine)))
        s_encode, s_run = build_decode_fns(enc, dec, dcfg, mesh=dp, device=dev)
        got, ms_dp, counts = timed(torch, lambda: s_run(*s_encode(*staged)))
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
            "mesh": [n, 1], "batch": batch, "ms": ms_dp, "one_device_ms": ms_one,
            "rank_rows_equal_alone": True, "launches_by_rank": launches,
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
    dcfg = dataclasses.replace(cs.serving_config(max_new), quantize_cross_kv=False)
    encode, run = build_decode_fns(t_enc.eval(), t_dec.eval(), dcfg, device=dev)
    ref, ms_one, _ = timed(torch, lambda: run(*encode(*staged)))
    tp = make_mesh(n // 2, 2)
    s_encode, s_run = build_decode_fns(t_enc, t_dec, dcfg, mesh=tp, device=dev)
    got, ms_tp, _ = timed(torch, lambda: s_run(*s_encode(*staged)))
    if got[0].shape[0] != ref[0].shape[0]:
        raise AssertionError(f"TP greedy: tokens {tuple(got[0].shape)}")
    width = min(got[0].shape[1], ref[0].shape[1])
    report["TP greedy (dense)"] = {"mesh": [n // 2, 2], "ms": ms_tp, "one_device_ms": ms_one,
                                   "tokens_equal": agreement(got[0][:, :width],
                                                             ref[0][:, :width])}
    del t_enc, t_dec
    torch.cuda.empty_cache()


def check_training(torch, dev, n: int, one_card: bool, report: dict) -> None:
    """A DP lora step and an FSDP step against one device's."""
    import chip_smoke as cs
    from robustsq_whisper_torch.init import init_params
    from robustsq_whisper_torch.models import TSASRModel, TSEncoderConfig, TSModelConfig
    from robustsq_whisper_torch.models import whisper_dims
    from robustsq_whisper_torch.parallel.mesh import make_mesh
    from robustsq_whisper_torch.train import OptimConfig, TrainConfig
    from robustsq_whisper_torch.train import create_train_state, make_train_step
    from robustsq_whisper_torch.train.lora import detach_lora

    dims = whisper_dims("medium")
    ts = TSEncoderConfig(use_flash_attention=True, remat=True)
    batch = cs.train_batch(torch, dev, cs.TRAIN_B, dims.n_vocab)
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
        (_, stats), wall, counts = cs.counted(torch, lambda: step(state, batch, gen, 0))
        out = dict(ms=wall * 1e3, loss=stats["loss"].item(), grad_norm=stats["grad_norm"].item(),
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                   launches={k: counts[k] for k in cs.TRAIN_KERNELS})
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
        report[name] = {"mesh": [n, 1], "batch": cs.TRAIN_B, **got, "one_device": one,
                        "rel_err": err}
        if any(err[k] > tol for k, tol in STEP_RTOL.items()):
            raise AssertionError(f"{name}: {got} against one device's {one}, bars {STEP_RTOL}")
        if got["launches"] != cs.TRAIN_KERNELS:
            raise AssertionError(f"{name}: launches {got['launches']}, want {cs.TRAIN_KERNELS}")


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
    t0 = time.perf_counter()
    check_decode(torch, dev, n, one_card, report)
    check_training(torch, dev, n, one_card, report)
    report["total_s"] = time.perf_counter() - t0
    first = rank() == 0
    torch.distributed.destroy_process_group()
    if first:
        import chip_smoke as cs

        print(cs.gpu_info())
        print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
