#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit if it fails:

1. build the eight CUDA kernel libraries from ``robustsq_whisper_torch/csrc``
   (one ``nvcc`` per source, all started together) and print the build time;
2. hold each kernel against its plain PyTorch version at the Whisper-medium
   main-path shapes (batch 4, beam 5), print the errors, the kernel's median
   time, the plain version's, a library call's where one computes the same
   function, and the least time the card could take (bound); both beam
   reorders are timed at the JAX bench's beam shape too. The cross rows
   also carry ``call_ms`` (the public call), ``splits`` (the CTAs a
   cluster takes along T) and, for 2a and 2b, ``ms_layer_sweep`` (one
   call a layer over all 24, each layer read cold from HBM as the token
   loop reads it; ``ms`` replays one layer, warm in L2); the packed int4
   cross kernel is also timed cold at the JAX bench's greedy batch 128 and
   beam batch 64 x 5 shapes. The self-cache rows (3a, 3b, 6) carry ``ms``
   (the kernel through its C entry) and ``call_ms`` (the public call,
   ``self_main_times``), both 20 calls a graph; 3a also sdpa's time as
   ``library_ms`` and the call at the beam path's 20 rows as
   ``beam_rows_ms``; ``self_cold_times`` times the public reads at the JAX
   bench's shapes, each call on a layer read cold;
3. small-input agreement: a small model decodes the same input with the
   kernels (f32, on the card) and with the plain versions (on the CPU):
   greedy over every self-cache layout (dense flat, 5-D dense and int8, flat
   int8, time-minor), beam 3 over the dense flat cache (eager reorder, and
   ``defer_reorder=4``), the 5-D cache and the int8 flat cache, and
   speculative decode with a self-draft and with a separate 1-layer draft;
   then the remaining decode paths (``check_small_remaining``): zero-shot
   ``WhisperASR`` greedy and beam 3, joint CTC/attention beam 3, greedy
   with the timestamp rules, and speculative decode with a 1-layer draft
   distilled on the CPU (``train/distill.py``); the tokens (and acceptance
   counters) must be identical;
4. the main paths at full Whisper-medium width and depth (bf16, seeded
   random weights, the bench lanes' settings), each a
   ``TranscriptionEngine.transcribe`` on 4 synthetic (30 s speech, 10 s
   enrollment) pairs, 32 new tokens at most: greedy with
   ``prefill_quantized`` off and on, beam 5 (20 beam rows) with the eager
   reorder and with ``defer_reorder=8``, then greedy over the int8 flat and
   the time-minor caches, beam 5 over the 5-D and the int8 flat caches, and
   speculative decode (gamma 10, a 1-layer self-draft, the 5-D cache), and
   zero-shot ``WhisperASR`` (the medium weights without the speaker prompt)
   greedy and beam 3. Every kernel's launch count is set to 0 just before
   each run, and each kernel of that run's path must show > 0 after it. A
   phase-timed greedy pass prints frontend, encode, cross-KV + prefill and
   token-loop times;
   speculative decode must give the 5-D greedy's tokens with the decoder in
   f32 (in bf16 the share of identical tokens is printed);
4b. the entry points at Whisper-medium: a Kaldi data dir of 8 utterances
   (the synthetic pairs as WAV) and a lora-mode checkpoint of
   ``conf/tswhisper/train_tsasr_whisper_medium_lora_qkvo_r16_.yaml``
   (seeded init, saved with ``save_checkpoint``) in a temporary directory;
   ``cli.decode.main`` decodes the dir from that checkpoint greedy and at
   beam 5 (int4 cross K/V, 32 new tokens, batch 4, the mini BPE ranks):
   ``text`` and ``score.txt`` must be whole, the path's kernels must have
   launched, and ``text`` must be byte-identical to ``decode_dataset``'s
   over the same weights in memory; then ``make_server`` over
   ``cli.serve.build_engine`` answers 8 concurrent ``POST
   /v1/transcribe`` requests (base64 WAV), each with ``engine.transcribe``'s
   text for its pair, and ``/healthz`` and ``/stats`` are read. Every text
   of the phase is made of token ids (the tokenizer's ``decode`` is
   swapped), so each comparison is token-exact. The LoRA factors are saved
   seeded and nonzero, and the checkpoint's serving restore must equal
   ``merge_lora`` of the in-memory weights tensor for tensor. The decode walls and RTFs and the request latencies are
   printed with the card's name and power limit;
4d. the remaining decode paths over 4b's data dir, checkpoint and yamls
   (``run_remaining_paths``; each run counted like 4's, its kernels in
   ``EXTRA_PATHS``): ``cli.distill.main`` distils a 1-layer draft (50 steps
   at batch 8 over the 8 utterances; steps/s and ``final_agreement``
   printed); ``cli.decode --speculative_gamma 10 --draft_path`` must give
   ``decode_dataset``'s text with the same draft in memory, byte for byte,
   and its acceptance is printed beside the 1-layer self-draft's; on one
   encoder batch, speculative decode with the draft must give the 5-D
   greedy tokens with the decoder in f32 (the share is printed in bf16);
   ``cli.serve --draft_path`` answers 4 requests, each equal to
   ``engine.transcribe``; then ``cli.decode --ctc_weight 0.3`` at beam 5,
   ``--timestamps true`` (a ``segments`` file) and ``--long_audio true``
   over a second dir of 4 utterances of 75 s (three windows each);
4c. the training entry point at Whisper-medium: train and valid dirs of 24
   and 8 such pairs, a synthetic OpenAI-format medium.en ``.pt`` (fp16,
   one token short of the config's vocabulary) and the medium lora config
   with 32 new tokens and the cross K/V quantized (to int8: the
   cross kernel's int8 layout, as no flag asks for 4 bits); ``cli.train.main``
   warm-starts from the file and trains 2 epochs of 3 steps at batch 8
   with the validation pass, the valid WER and n-best 2: the frozen
   backbone must be the file's after the bf16 cast (the added token row
   ``adapt_vocab``'s), ``ave`` the mean of the two n-best checkpoints'
   masters and factors, every batch read by the native reader and every
   logged stat finite; a second ``main`` resumes to epoch 3 (steps 7 to
   9), and ``cli.decode --use_ave`` must give ``decode_dataset``'s
   hypotheses over that mean, token for token. Prints the steps/s and
   audio-s per GPU-s through the CLI (beside the in-memory step's, after
   phase 5), the validation, valid-WER, checkpoint save, restore and
   averaging seconds, the peak memory and the launches;
4e. the data stages and embedding enrollment (``run_embedding_enrollment``):
   first a small embedding-enrollment model decodes greedy and at beam 3
   on the card and on the CPU to the same tokens; then ``cli.datapre``
   writes a synthetic corpus (8 speakers x 4 utterances of 30 s), 16
   overlaps at SIR in [-5, 5] dB, WHAM!-style noise at SNR in [10, 20] dB
   over 4 synthetic noise WAVs, ``enroll-json``, an 8-utterance eval dir
   of concrete ``enroll-scp`` rows, ``num-samples``, ``fix`` and
   ``validate`` (each subcommand's wall printed); ``spk-embed`` runs the
   seeded ResNet34 at its published widths on the card at batch 16 over
   both dirs (utterances/s printed), and 4 embeddings on the card must
   match the CPU's (cosine >= 0.999, f32 without TF32); ``cli.train
   --enroll_type embedding`` trains the medium lora config 4 steps at
   batch 8 with validation and valid WER (audio-s per GPU-s and peak
   memory printed); ``cli.decode --enroll_type embedding`` decodes the
   eval dir greedy and at beam 5 (int4 cross K/V, 32 new tokens) and with
   ``--ctc_weight 0.3``: each run's launches are counted, the rows of
   ``EMBED_PATHS`` must launch and the flash rows must not (the embedding
   encoder's attention is plain, as the JAX package's), and the RTFs are
   printed;
4f. W8A8 serving (``quantize_weights``, ``--int8_weights``;
   ``run_w8a8_paths``): the ``ptxas`` lines of the ``w8a8_matmul``
   instantiations; ``w8a8_matmul`` against ``qmatmul_plain`` at every
   (M, K, N) of the slice's paths (the decode step at 4, 20 and 44 rows,
   the encoder at 4 x 1516 rows) and at the kernels' edges
   (``W8A8_EDGES``), bit for bit, for f32 and bf16 activations and
   outputs, with and without bias, each call's launches (as the C entry
   reports them) equal to ``launches_per_call`` (one at M <= 64, two
   above); each main shape's
   time (graph replay), bound, ``torch._int_mm``'s time for the product
   alone (M padded to 32, N to a multiple of 8) and the bf16 ``F.linear``
   it replaces; then the engine with W8A8 step weights at medium, greedy
   over the dense and int8 flat caches, beam 5 eager and deferred and
   speculative gamma 10 (1-layer self-draft): each transcribe counted, its
   ``w8a8_matmul`` launches equal to the steps (from the cross kernel's
   launches) x 193 calls (the speculative path's rounds x (10 draft steps
   x 9 + 193)) x the calls' ``launches_per_call``, its run timed beside
   the dense engine's and its tokens' agreement with the dense path
   printed; one encode with ``quantize_encoder_weights`` (row 4 launched
   24 times, row 1 never, ``w8a8_matmul`` 144 x 2) timed beside the dense
   encode; inside phase 4b
   (``run_w8a8_entry_points``), ``cli.decode --int8_weights true`` greedy
   and at beam 5 over 4b's data dir and ``cli.serve --int8_weights true``
   answering 8 requests; last of all, ``utils.profiling.op_stats`` over
   one profiled W8A8 greedy run and one W8A8 encode, the W8A8 kernels
   counted by name in each trace (``profile_w8a8``: the greedy run's
   fused kernels equal to its steps x 193 and to ``qmatmul``'s count, no
   quantizer or ``wgmma`` kernel; the encode's 144 quantizers and 144
   ``wgmma`` products, no fused kernel). Phase 3 holds W8A8 greedy and beam 3 on
   the card to the CPU's tokens;
4g. multi-GPU (``run_multi_gpu_decode``, ``run_one_card_ranks``, and
   inside phases 4b and 5). At world 1: ``init_distributed`` joins a
   one-process NCCL group (a failed init fails the run) and one NCCL
   all-reduce runs; on a ``(1, 1)`` ``make_mesh``, greedy and beam 5 at
   medium (4's settings) through ``build_decode_fns(mesh=)`` and through
   ``build_sharded_decoder`` directly must give the unsharded decode's
   tokens with the same launch count of every kernel (at one rank the
   sharded code is the unsharded code: this checks the wiring, not the
   sharding). With collectives: ``multi_gpu_check.py --one-card`` under
   ``python -m torch.distributed.run --nproc_per_node 2``, two gloo ranks
   on the one card, decodes 8 pairs data-parallel at medium, greedy and
   beam 5, each rank's rows bit-equal to its decode of them alone with the
   same launches, and takes one DP and one FSDP lora step at batch 8
   within that script's bars of one device's step, rows 4, 5a and 5b
   launched on each rank; in phase 4b, ``cli.decode --data_parallel true`` under
   ``python -m torch.distributed.run --nproc_per_node 1`` (this script's
   ``torchrun-decode`` mode, the 4b tokenizer swap applied) must write 4b's
   greedy ``text`` byte for byte and launch the greedy kernels; in phase
   5, before the timed steps, one data-parallel and one FSDP
   ``make_train_step`` of the medium lora model on that mesh must give the
   unsharded step's loss and gradient norm (to 1e-6 relative) and launch
   rows 4, 5a and 5b as often;
5. training: the three flash-attention training kernels (forward, dQ,
   dK/dV) against their plain versions at the medium training shape
   (batch 8 x 16 heads, T = 1500 + 16, bf16) and with a mask at a smaller
   shape, the port's whole backward (delta, dQ, dK/dV) timed beside
   ``scaled_dot_product_attention``'s; a small f32 ``TSASRModel`` on the
   flash route takes a train step on the card and on the CPU (loss and
   every gradient must agree), then four steps on the card must lower its
   loss; then ``make_train_step`` at Whisper-medium (bf16, remat, batch 8
   of 30 s + 10 s, 48 text tokens) in mode ``lora`` (f32 moments) and
   ``full`` (bf16 first moment), the JAX bench's training settings: a
   warm-up step and three timed steps each, every step with the flash
   forward launched 48 times and each backward kernel 24 times (24 layers,
   recomputed in the backward), and the host syncs of one more step
   (``torch.cuda.set_sync_debug_mode``) by source line;
6. last, the profiler reads the device's busy share of the encode, the
   greedy run, both beam runs and one full-mode training step, and the
   device time of the self-cache reads in each.

The next-to-last lines are the JSON kernel record and the card's name and
power limit (``nvidia-smi``); the last line is the JSON ok record. A
kernel's ``launches`` are those of the path it was ported for (greedy, the
eager beam path, the deferred one for the settled kernel, the int8 flat,
time-minor and 5-D paths for the kernels of those caches, one full-mode
training step for the training kernels); ``launches_by_path`` has every
path's. Needs one CUDA device; without one it exits non-zero and prints no
result.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# dense tensor-core bf16 and int8; f32 SIMT
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
TPU_SRC = "robustsq_whisper_tpu/ops"
# the JAX bench's beam sub-record: batch 64 x beam 5 rows, cache length 152
# at 128 new tokens, live 85 positions at its measured step
BENCH_BEAM = (64 * 5, 152, 85)


def log(msg: str) -> None:
    print(msg, flush=True)


def free_port() -> int:
    """A free TCP port on this host (a process group's rendezvous)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def gpu_info() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def time_ms(torch, fn, reps: int = 20, calls: int = 1) -> float:
    """Median device time of one call of ``fn``: ``calls`` calls are
    captured once in a CUDA graph, so host launch overhead stays out of the
    time; each of 5 samples replays it ``reps`` times between two CUDA
    events. A call of a few microseconds takes ``calls`` > 1: one replay a
    call can take longer on the host than the call takes on the card."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    samples = []
    for _ in range(5):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(reps):
            graph.replay()
        e.record()
        torch.cuda.synchronize()
        samples.append(s.elapsed_time(e) / (reps * calls))
    del graph
    return statistics.median(samples)


def device_busy(torch, fn, trace_path: str):
    """Run ``fn`` once under torch.profiler; returns (wall ms, summed device
    kernel/memcpy/memset ms, {name: device ms}) read from the exported
    chrome trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    by_name = {}
    busy = 0.0
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            busy += e["dur"] / 1e3
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    return wall, busy, by_name


def time_events_ms(torch, fn, reps: int = 10) -> float:
    """Median time of one call of ``fn`` between CUDA events (no graph: for
    calls that run autograd, each long enough that host launches hide)."""
    for _ in range(2):
        fn()
    samples = []
    for _ in range(5):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        samples.append(s.elapsed_time(e) / reps)
    return statistics.median(samples)


def ptxas_report(reports):
    """(library, kernel, registers line, spill line) for every kernel of
    the ``nvcc -Xptxas -v`` reports, each template instantiation on its own
    (names demangled where ``c++filt`` is found)."""
    import re
    import shutil

    out = []
    for name, text in reports.items():
        fn, spills = "?", ""
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line:
                out.append([name, fn, line.split(":", 1)[-1].strip(), spills])
    if out and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(r[1] for r in out),
                               capture_output=True, text=True, timeout=60).stdout.split("\n")
        for r, n in zip(out, names):
            r[1] = n or r[1]
    return out


def bound(bytes_moved: float, ops: float, kind: str):
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def with_shares(row) -> None:
    """A flash row's share of its bound (bound_ms / ms) and time over the
    library call's (ms / library_ms; for a backward kernel the library's
    whole backward)."""
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    row["vs_library"] = row["ms"] / row["library_ms"]
    log(f"kernel {row['name']}: share_of_bound {row['share_of_bound']:.3f}, "
        f"vs_library {row['vs_library']:.3f}")


# (label, batch, group, layers): the main path's shapes over all 24 layers,
# and the JAX bench's greedy (bench.py:830-914) and beam (bench.py:1091-1140)
# batches over two layers taken in turns; every layer's K + V passes the
# 50 MB L2, so each call reads cold
CROSS_COLD = (  # rows 2a and 2b take their ms_layer_sweep from the first two
    ("batch 4 greedy, 24-layer sweep", 4, 1, 24),
    ("batch 4 x beam 5, 24-layer sweep", 4, 5, 24),
    ("bench greedy batch 128, 2 layers in turns", 128, 1, 2),
    ("bench beam batch 64 x 5, 2 layers in turns", 64, 5, 2),
)


def cross_cold_times(torch, dev, xa):
    """The packed int4 cross kernel (``xa._launch`` on prescaled f32
    queries, a call every tree of the port takes) over stacked K/V at 1536
    padded positions, 1516 live, one call a layer captured in one graph:
    the median ms a call, its bound and share, and the split the host
    picks (1 for a tree without ``choose_splits``)."""
    heads, hd, t_pad, kv = 16, 64, 1536, 1500 + 16
    g = torch.Generator(device=dev).manual_seed(2)
    kv_len = torch.tensor(kv, dtype=torch.int32, device=dev)
    out = []
    for label, batch, group, layers in CROSS_COLD:
        kt, vt = (
            torch.randint(-128, 128, (layers, batch, heads, hd // 2, t_pad),
                          generator=g, device=dev, dtype=torch.int8)
            for _ in range(2)
        )
        qs = torch.randn(batch, heads, group, hd, generator=g, device=dev) * 0.0025
        lis = [torch.tensor(i, dtype=torch.int32, device=dev) for i in range(layers)]
        fn = lambda: [xa._launch(qs, kt, vt, kv_len, x, True) for x in lis]
        ms = time_ms(torch, fn, 5 if layers > 2 else 20) / layers
        b_ms, b_by = bound(
            2 * batch * heads * (hd // 2) * kv + 2 * batch * heads * group * hd * 4,
            4 * batch * heads * group * hd * kv, "f32",
        )
        choose = getattr(xa, "choose_splits", None)
        splits = choose(batch * heads, t_pad, 0, xa._sm_count(dev.index or 0)) if choose else 1
        out.append(dict(shape=label, batch=batch, group=group, layers=layers, ms=ms,
                        bound_ms=b_ms, bound_by=b_by, share=b_ms / ms, splits=splits))
        del kt, vt
    torch.cuda.empty_cache()
    return out


SELF_ROWS = ("decode_self_attention", "decode_self_attention_int8", "settled_self_attention")
# (label, read, rows, T_pad, live positions) of the self-cache reads: the
# main path's last step (batch 4, beam 4 x 5 rows, 32 new tokens), each on
# layer 7 of 24, warm in L2 after the first replay as the rows of phase 2
# are; and the JAX bench's greedy batch 128 (bench.py:830-914) and beam
# batch 64 x 5 (bench.py:1091-1140) at its 152-position cache, over layers
# taken in turns, so many (``cold_layers``) that every call reads cold
SELF_MAIN = (
    ("3a batch 4, pos 52", "dense", 4, 56, 52),
    ("3a beam rows 20, pos 52", "dense", 20, 56, 52),
    ("3b batch 4, pos 52", "int8", 4, 56, 52),
    ("6 beam rows 20, settled 48", "settled", 20, 64, 48),
)
SELF_COLD = (
    ("3a bench greedy batch 128, pos 148", "dense", 128, 152, 148),
    ("3a bench beam batch 64 x 5, pos 148", "dense", 320, 152, 148),
    ("3b bench greedy batch 128, pos 148", "int8", 128, 152, 148),
    ("6 bench beam batch 64 x 5, settled 144", "settled", 320, 152, 144),
)


def cold_layers(torch, dev, layer_bytes: int) -> int:
    """Layers to take in turns so that every call reads its layer cold:
    between two calls on one layer the others pass twice the L2 cache."""
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size", 50 << 20)
    return max(2, 1 + -(-2 * l2 // layer_bytes))


def self_read_times(torch, dev, sa, cases, reads=None):
    """The public self-cache reads of a tree (``sa``, its
    ``ops.self_attention``), bf16, one call on each layer of ``reads`` in
    turn (of 24 layers; without ``reads``, every layer of a cache of
    ``cold_layers`` layers), 20 calls or a few more captured in one graph:
    for each case the median ms a call, its bound and share."""
    heads, n_state = 16, 1024
    g = torch.Generator(device=dev).manual_seed(3)
    out = []
    for label, read, rows, t_pad, live in cases:
        rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
        q, kn, vn = (rnd(rows, n_state).bfloat16() for _ in range(3))
        n = torch.tensor(live, dtype=torch.int32, device=dev)
        # a layer's K and V in the cache, and the int8 cache's scale leaf
        per_layer = rows * t_pad * (2 * n_state + 256 if read == "int8" else 4 * n_state)
        layers = 24 if reads else cold_layers(torch, dev, per_layer)
        lis = [torch.tensor(i, dtype=torch.int32, device=dev)
               for i in (reads or range(layers))]
        if read == "int8":
            cache = sa.quantize_flat_kv(rnd(layers, rows, t_pad, n_state),
                                        rnd(layers, rows, t_pad, n_state), heads)
            moved = rows * live * (2 * n_state + 4 * heads) + 4 * rows * n_state * 2
        else:
            cache = tuple(rnd(layers, rows, t_pad, n_state).bfloat16() for _ in range(2))
            moved = 2 * rows * live * n_state * 2 + 4 * rows * n_state * 2
        if read == "settled":
            rmap = torch.randperm(rows, generator=g, device=dev).int()
            fn = lambda: [sa.settled_self_attention(q, cache, n, x, rmap, heads) for x in lis]
            # q in; f32 acc, m and l out, the row map in; no k_new, v_new
            moved += rows * n_state * (6 - 8) + 2 * rows * heads * 4 + rows * 4
        else:
            fn = lambda: [sa.decode_self_attention(q, kn, vn, cache, n, x, heads=heads)
                          for x in lis]
        ms = time_ms(torch, fn, 10, calls=-(-20 // len(lis))) / len(lis)
        b_ms, b_by = bound(moved, 4 * rows * n_state * live, "bf16")
        out.append(dict(shape=label, rows=rows, t_pad=t_pad, live=live, layers=len(lis), ms=ms,
                        bound_ms=b_ms, bound_by=b_by, share=b_ms / ms))
        del cache
    torch.cuda.empty_cache()
    return out


def self_main_times(torch, dev, sa):
    return self_read_times(torch, dev, sa, SELF_MAIN, (7,))


def self_cold_times(torch, dev, sa):
    return self_read_times(torch, dev, sa, SELF_COLD)


def check_kernels(torch, dev, batch: int, max_new: int, beam: int):
    """Phase 2: each kernel against its plain version at medium shapes."""
    from robustsq_whisper_torch.ops import _build
    from robustsq_whisper_torch.ops import beam_gather as bg
    from robustsq_whisper_torch.ops import decode_attention as xa
    from robustsq_whisper_torch.ops import flash_attention as fa
    from robustsq_whisper_torch.ops import self_attention as sa

    g = torch.Generator(device=dev).manual_seed(0)
    heads, hd, layers, n_state = 16, 64, 24, 1024
    t_enc = 1500 + 16  # speech frames + speaker prompt
    rows = []

    # 1. encoder self-attention, transposed layout, bf16
    bh = batch * heads
    q, k, v = (
        torch.randn(bh, hd, t_enc, generator=g, device=dev).bfloat16()
        for _ in range(3)
    )
    got = fa.flash_attention_tmaj(q, k, v)
    ref = fa.flash_attention_tmaj_plain(q, k, v)
    err = (got.float() - ref.float()).abs().max().item()
    tol = 2e-2  # bf16 output rounding (2^-8 relative) on O(1) values
    rm = lambda z: z.view(batch, heads, hd, t_enc).transpose(-1, -2).contiguous()
    qr, kr, vr = rm(q), rm(k), rm(v)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b_ms, b_by = bound(4 * bh * hd * t_enc * 2, 4 * bh * t_enc * t_enc * hd, "bf16")
    rows.append(dict(
        name="flash_attention_tmaj", route="cuda",
        source="robustsq_whisper_torch/csrc/flash_attention_tmaj.cu",
        replaces=f"{TPU_SRC}/flash_attention.py:438",
        max_abs_err=err, tol=tol,
        ms=time_ms(torch, lambda: fa.flash_attention_tmaj(q, k, v)),
        plain_ms=time_ms(torch, lambda: fa.flash_attention_tmaj_plain(q, k, v), 5),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: sdpa(qr, kr, vr)),
    ))
    with_shares(rows[-1])
    # what the layout costs: the same kernel at T = 1504 (16-byte words along
    # T where 1516 takes 8-byte ones), and its row-major layout on the same
    # heads (16-byte rows)
    q16, k16, v16 = (x[..., :1504].contiguous() for x in (q, k, v))
    rq, rk, rv = (z.view(batch, heads, hd, t_enc).permute(0, 3, 1, 2).contiguous()
                  for z in (q, k, v))
    log(f"flash_attention_tmaj at T 1504: "
        f"{time_ms(torch, lambda: fa.flash_attention_tmaj(q16, k16, v16)):.4f} ms; the "
        f"row-major forward on the same {bh} heads of T {t_enc}: "
        f"{time_ms(torch, lambda: fa.flash_attention_fwd(rq, rk, rv)):.4f} ms")
    del q16, k16, v16, rq, rk, rv

    # 2. decode cross attention, packed int4, stacked layers: ms is the
    # kernel on layer 7 (L2-warm after its first replay; kept so that trees
    # compare like with like), ms_layer_sweep one call a layer over all 24
    # (each layer cold from HBM, as the token loop meets them), call_ms the
    # public call
    cold = cross_cold_times(torch, dev, xa)
    for r in cold:
        log(f"decode_cross_attention at {r['shape']}: S {r['splits']}, ms {r['ms']:.4f}, "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}), share {r['share']:.3f}")
    t_pad = 1536
    kt, vt = (
        torch.randint(-128, 128, (layers, batch, heads, hd // 2, t_pad),
                      generator=g, device=dev, dtype=torch.int8)
        for _ in range(2)
    )
    k_s = torch.full((batch, heads, hd), 0.02, device=dev)  # scores O(1)
    kv_len = torch.tensor(t_enc, dtype=torch.int32, device=dev)
    li = torch.tensor(7, dtype=torch.int32, device=dev)
    for group, name, replaces, sweep in (
        (1, "decode_cross_attention", f"{TPU_SRC}/decode_attention.py:79", cold[0]),
        (beam, "decode_cross_attention_grouped", f"{TPU_SRC}/decode_attention.py:156", cold[1]),
    ):
        q4 = torch.randn(batch, heads, group, hd, generator=g, device=dev)
        qx = q4 if group > 1 else q4[:, :, 0]
        call = lambda: xa.decode_cross_attention(
            qx, kt, vt, k_s, kv_len=kv_len, layer_idx=li, packed_int4=True, group=group
        )
        launch = lambda: xa._launch(q4, kt, vt, kv_len, li, True, k_scale=k_s)
        qs = q4 * hd**-0.5 * k_s[:, :, None]
        plain = lambda: xa.decode_cross_attention_plain(qs, kt, vt, kv_len, 7, True)
        err = (call() - plain().reshape(qx.shape)).abs().max().item()
        b_ms, b_by = bound(
            2 * batch * heads * (hd // 2) * t_enc + 2 * batch * heads * group * hd * 4,
            4 * batch * heads * group * hd * t_enc, "f32",
        )
        rows.append(dict(
            name=name, route="cuda",
            source="robustsq_whisper_torch/csrc/decode_cross_attention.cu",
            replaces=replaces,
            max_abs_err=err, tol=1e-4,  # f32 math, __expf vs torch.exp
            ms=time_ms(torch, launch, 50), plain_ms=time_ms(torch, plain, 10),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            ms_layer_sweep=sweep["ms"], call_ms=time_ms(torch, call, 50),
            splits=xa.choose_splits(batch * heads, t_pad, xa.PACKED_INT4_MODE,
                                    xa._sm_count(dev.index or 0)),
        ))
        r = rows[-1]
        r["share_of_bound"] = b_ms / r["ms_layer_sweep"]
        log(f"kernel {name}: S {r['splits']}, ms (layer 7) {r['ms']:.4f}, "
            f"ms_layer_sweep {r['ms_layer_sweep']:.4f} (share of bound "
            f"{r['share_of_bound']:.3f}), call_ms {r['call_ms']:.4f}")
    del kt, vt

    # 3. decode self attention, dense flat cache, bf16, the last position:
    # ms is the kernel through its C entry, call_ms the public call
    # (self_main_times), both 20 calls a graph (one a replay measures the
    # host's replay rate); library_ms is sdpa over the strided view of the
    # layer's slab with the new token written at pos, the function the step
    # computes (it writes the token right after the read); beam_rows_ms the
    # call at the beam path's batch x beam rows
    assert (batch, beam, max_new) == (4, 5, 32), "SELF_MAIN holds the main path's shapes"
    main = self_main_times(torch, dev, sa)  # 3a, 3a at the beam rows, 3b, 6
    t_pad = -(-(17 + 4 + max_new) // 8) * 8
    pos_i = 17 + 4 + max_new - 1
    pos = torch.tensor(pos_i, dtype=torch.int32, device=dev)
    self_lib = _build.load("decode_self_attention")
    errs = []
    for n_rows in (batch * beam, batch):  # the batch's tensors stay for sdpa
        qd, kn, vn = (
            torch.randn(n_rows, n_state, generator=g, device=dev).bfloat16()
            for _ in range(3)
        )
        kc, vc = (
            torch.randn(layers, n_rows, t_pad, n_state, generator=g, device=dev).bfloat16()
            for _ in range(2)
        )
        call = lambda: sa.decode_self_attention(qd, kn, vn, (kc, vc), pos, li, heads=heads)
        plain = lambda: sa.decode_self_attention_plain(qd, kn, vn, (kc, vc), pos_i, 7, heads)
        errs.append((call().float() - plain().float()).abs().max().item())
    out = torch.empty_like(qd)
    kernel = lambda: self_lib(
        qd.data_ptr(), kn.data_ptr(), vn.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        li.data_ptr(), pos.data_ptr(), out.data_ptr(), batch, heads, hd, t_pad, 1,
        _build.stream_ptr(dev),
    )
    b_ms, b_by = bound(
        2 * batch * pos_i * n_state * 2 + 4 * batch * n_state * 2,
        4 * batch * n_state * (pos_i + 1), "bf16",
    )
    row = dict(
        name="decode_self_attention", route="cuda",
        source="robustsq_whisper_torch/csrc/decode_self_attention.cu",
        replaces=f"{TPU_SRC}/self_attention.py:103",
        max_abs_err=max(errs), tol=2e-2,  # bf16 output rounding
        ms=time_ms(torch, kernel, 10, calls=20), plain_ms=time_ms(torch, plain, 10),
        bound_ms=b_ms, bound_by=b_by, call_ms=main[0]["ms"], beam_rows_ms=main[1]["ms"],
    )
    got = call()
    for buf, new in ((kc, kn), (vc, vn)):
        buf[7, :, pos_i] = new
    heads_view = lambda x: x[7].view(batch, t_pad, heads, hd)[:, :pos_i + 1].transpose(1, 2)
    q4, kr, vr = qd.view(batch, 1, heads, hd).transpose(1, 2), heads_view(kc), heads_view(vc)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_err = (sdpa(q4, kr, vr).transpose(1, 2).reshape(batch, n_state).float()
                - got.float()).abs().max().item()
    row["library_ms"] = time_ms(torch, lambda: sdpa(q4, kr, vr), 10, calls=20)
    row["vs_library"] = row["call_ms"] / row["library_ms"]
    rows.append(row)
    log(f"kernel decode_self_attention: ms {row['ms']:.4f}, call_ms "
        f"{row['call_ms']:.4f} vs sdpa {row['library_ms']:.4f} (vs_library "
        f"{row['vs_library']:.3f}, sdpa against the call {sdpa_err:.2e}); at "
        f"{batch * beam} rows call_ms {row['beam_rows_ms']:.4f}")
    del kc, vc

    # 4. beam reorder of the flat cache (two bf16 leaves, in place), at the
    # beam-5 main path's last step and at the JAX bench's beam shape
    rb = batch * beam
    shapes = {
        "main path": (rb, -(-(17 + 4 + max_new) // 8) * 8, 17 + 4 + max_new - 2),
        "bench beam": BENCH_BEAM,
    }
    for where, (n_rows, t_len, live) in shapes.items():
        leaves = tuple(
            torch.randn(layers, n_rows, t_len, n_state, generator=g, device=dev).bfloat16()
            for _ in range(2)
        )
        src = torch.randperm(n_rows, generator=g, device=dev)
        src[1::3] = src[0::3][: src[1::3].numel()]  # repeats as well as moves
        p = bg.live_positions(live, t_len)
        got = bg.beam_reorder_cache(tuple(x.clone() for x in leaves), src, live, t_len)
        ref = bg.beam_reorder_cache_plain(tuple(x.clone() for x in leaves), src, p)
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
        call = lambda: bg.beam_reorder_cache(leaves, src, live, t_len)
        plain = lambda: bg.beam_reorder_cache_plain(leaves, src, p)
        library = lambda: [x[:, :, :p].index_select(1, src) for x in leaves]
        b_ms, b_by = bound(2 * 2 * layers * n_rows * p * n_state * 2 + n_rows * 8, 0, "bf16")
        row = dict(
            name="beam_reorder_cache", route="cuda",
            source="robustsq_whisper_torch/csrc/beam_reorder_cache.cu",
            replaces=f"{TPU_SRC}/beam_gather.py:122",
            max_abs_err=err, tol=0.0,  # a copy: exact
            ms=time_ms(torch, call, 20), plain_ms=time_ms(torch, plain, 5),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(torch, library, 5),
        )
        log(f"beam_reorder_cache at the {where} shape ({layers} x {n_rows} rows "
            f"x {p} of {t_len} positions x {n_state}, 2 bf16 leaves): "
            f"max_abs_err {err} ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
            f"bound_ms {b_ms:.4f} library_ms (index_select) {row['library_ms']:.4f}")
        if where == "main path":
            rows.append(row)
        del leaves, got, ref

    # 6. settled-prefix state through a shuffled row map, bf16 flat cache
    settled, t_len = 48, 64
    qd = torch.randn(rb, n_state, generator=g, device=dev).bfloat16()
    kc, vc = (
        torch.randn(layers, rb, t_len, n_state, generator=g, device=dev).bfloat16()
        for _ in range(2)
    )
    rmap = torch.randperm(rb, generator=g, device=dev)
    rmap32 = rmap.int()
    st = torch.tensor(settled, dtype=torch.int32, device=dev)
    call = lambda: sa.settled_self_attention(qd, (kc, vc), st, li, rmap, heads)
    plain = lambda: sa.settled_self_attention_plain(qd, (kc, vc), settled, 7, rmap, heads)
    err = max((a - b).abs().max().item() for a, b in zip(call(), plain()))
    f32 = dict(dtype=torch.float32, device=dev)
    m_o, l_o, acc_o = (torch.empty((rb, heads), **f32), torch.empty((rb, heads), **f32),
                       torch.empty((rb, n_state), **f32))
    settled_lib = _build.load("settled_self_attention")
    kernel = lambda: settled_lib(
        qd.data_ptr(), kc.data_ptr(), vc.data_ptr(), li.data_ptr(), st.data_ptr(),
        rmap32.data_ptr(), m_o.data_ptr(), l_o.data_ptr(), acc_o.data_ptr(), rb, rb, heads,
        hd, t_len, 1, _build.stream_ptr(dev),
    )
    b_ms, b_by = bound(
        2 * rb * settled * n_state * 2 + rb * n_state * (2 + 4) + 2 * rb * heads * 4,
        4 * rb * n_state * settled, "bf16",
    )
    rows.append(dict(
        name="settled_self_attention", route="cuda",
        source="robustsq_whisper_torch/csrc/settled_self_attention.cu",
        replaces=f"{TPU_SRC}/self_attention.py:276",
        max_abs_err=err, tol=1e-3,  # f32 state from bf16 inputs
        ms=time_ms(torch, kernel, 10, calls=20), plain_ms=time_ms(torch, plain, 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, call_ms=main[3]["ms"],
    ))
    del kc, vc
    # 3b. decode self attention, int8 flat cache (int8 K/V, bf16 scales)
    qd, kn, vn = (
        torch.randn(batch, n_state, generator=g, device=dev).bfloat16()
        for _ in range(3)
    )
    cache8 = sa.quantize_flat_kv(
        *(torch.randn(layers, batch, t_pad, n_state, generator=g, device=dev)
          for _ in range(2)), heads,
    )
    call = lambda: sa.decode_self_attention(qd, kn, vn, cache8, pos, li, heads=heads)
    plain = lambda: sa.decode_self_attention_plain(qd, kn, vn, cache8, pos_i, 7, heads)
    err = (call().float() - plain().float()).abs().max().item()
    int8_lib = _build.load("decode_self_attention", "decode_self_attention_int8")
    kernel = lambda: int8_lib(
        qd.data_ptr(), kn.data_ptr(), vn.data_ptr(), *(c.data_ptr() for c in cache8),
        li.data_ptr(), pos.data_ptr(), out.data_ptr(), batch, heads, hd, t_pad, 1,
        _build.stream_ptr(dev),
    )
    # a live position's int8 K and V, and its K and V scales (bf16 lanes
    # [0, 2 * heads) of the scale row; the rest of the row is not needed)
    b_ms, b_by = bound(
        batch * pos_i * (2 * n_state + 4 * heads) + 4 * batch * n_state * 2,
        4 * batch * n_state * (pos_i + 1), "bf16",
    )
    rows.append(dict(
        name="decode_self_attention_int8", route="cuda",
        source="robustsq_whisper_torch/csrc/decode_self_attention.cu",
        replaces=f"{TPU_SRC}/self_attention.py:103",
        max_abs_err=err, tol=2e-2,  # bf16 output rounding
        ms=time_ms(torch, kernel, 10, calls=20), plain_ms=time_ms(torch, plain, 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, call_ms=main[2]["ms"],
    ))
    del cache8
    for r in rows:
        if r["name"] in SELF_ROWS:
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
            log(f"kernel {r['name']}: ms {r['ms']:.4f} (share of bound "
                f"{r['share_of_bound']:.3f}), call_ms {r['call_ms']:.4f}")
    for r in self_cold_times(torch, dev, sa):
        log(f"self-cache read at {r['shape']} ({r['layers']} layers in turns): "
            f"ms {r['ms']:.4f}, "
            f"bound_ms {r['bound_ms']:.4f} ({r['bound_by']}), share {r['share']:.3f}")

    # 2c. the cross kernel with return_state over the time-minor self cache
    # (dense bf16, T_pad a multiple of 128), at the greedy path's last step;
    # the public call is held against sdpa, both timed 20 calls a graph
    # (one call a replay measured the host's replay rate as often as the
    # card: 4.4 to 8.1 us for one kernel in one run), the kernel alone
    # printed beside
    t_min = -(-(17 + 4 + max_new) // 128) * 128
    kt, vt = (
        torch.randn(layers, batch, heads, hd, t_min, generator=g, device=dev).bfloat16()
        for _ in range(2)
    )
    q3 = torch.randn(batch, heads, hd, generator=g, device=dev).bfloat16()
    call = lambda: xa.decode_cross_attention(
        q3, kt, vt, kv_len=pos, layer_idx=li, return_state=True
    )
    launch = lambda: xa._launch(q3[:, :, None], kt, vt, pos, li, False, True)
    qs = q3.float()[:, :, None] * hd**-0.5
    plain = lambda: xa.decode_cross_attention_plain(qs, kt, vt, pos, 7, False, True)
    err = max((a - b.reshape(a.shape)).abs().max().item()
              for a, b in zip(call(), plain()))
    kr, vr = (x[7].transpose(-1, -2)[:, :, :pos_i].contiguous() for x in (kt, vt))
    qr = q3[:, :, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    b_ms, b_by = bound(
        2 * batch * heads * hd * pos_i * 2 + batch * heads * (hd * 2 + hd * 4 + 8),
        4 * batch * heads * hd * pos_i, "f32",
    )
    rows.append(dict(
        name="decode_cross_attention_state", route="cuda",
        source="robustsq_whisper_torch/csrc/decode_cross_attention.cu",
        replaces=f"{TPU_SRC}/decode_attention.py:156",
        max_abs_err=err, tol=1e-4,  # f32 math, __expf vs torch.exp
        ms=time_ms(torch, launch, 50), plain_ms=time_ms(torch, plain, 10),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: sdpa(qr, kr, vr), 10, calls=20),
        call_ms=time_ms(torch, call, 10, calls=20),
        splits=xa.choose_splits(batch * heads, t_min, 2, xa._sm_count(dev.index or 0)),
    ))
    r = rows[-1]
    r["vs_library"] = r["call_ms"] / r["library_ms"]
    log(f"kernel decode_cross_attention_state: S {r['splits']}, call_ms {r['call_ms']:.4f} "
        f"(kernel alone {r['ms']:.4f}) vs sdpa {r['library_ms']:.4f}: vs_library "
        f"{r['vs_library']:.3f}")
    del kt, vt

    # 7b. the flattened zero-tail reorder of the 5-D cache (two bf16
    # leaves, out of place) at the beam-5 main path's last step (the cache
    # length padded to a multiple of 4, as the beam decoder pads it) and
    # at the JAX bench's beam shape
    shapes = {
        "main path": (rb, -(-(17 + 4 + max_new) // 4) * 4, 17 + 4 + max_new - 2),
        "bench beam": BENCH_BEAM,
    }
    for where, (n_rows, t_len, live) in shapes.items():
        leaves = tuple(
            torch.randn(layers, n_rows, t_len, heads, hd, generator=g, device=dev).bfloat16()
            for _ in range(2)
        )
        src = torch.randperm(n_rows, generator=g, device=dev)
        src[1::3] = src[0::3][: src[1::3].numel()]
        s_full = t_len * n_state // 128
        e = bg.live_rows(live, s_full, t_len)
        got = bg.beam_reorder_cache(leaves, src, live, t_len)
        ref = [bg.beam_reorder_flat_plain(x, src, e) for x in leaves]
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
        del got, ref
        call = lambda: bg.beam_reorder_cache(leaves, src, live, t_len)
        plain = lambda: [bg.beam_reorder_flat_plain(x, src, e) for x in leaves]

        def library():
            out = []
            for x in leaves:
                flat = x.view(layers, n_rows, -1)
                head = flat[:, :, :e * 128].index_select(1, src)
                tail = torch.zeros((layers, n_rows, flat.shape[2] - e * 128),
                                   dtype=x.dtype, device=dev)
                out.append(torch.cat([head, tail], dim=2))
            return out

        row_b = s_full * 128 * 2
        b_ms, b_by = bound(2 * layers * n_rows * (e * 128 * 2 + row_b) + n_rows * 8, 0, "bf16")
        row = dict(
            name="beam_reorder_cache_flat", route="cuda",
            source="robustsq_whisper_torch/csrc/beam_reorder_cache.cu",
            replaces=f"{TPU_SRC}/beam_gather.py:69",
            max_abs_err=err, tol=0.0,  # a copy: exact
            ms=time_ms(torch, call, 20), plain_ms=time_ms(torch, plain, 5),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(torch, library, 5),
        )
        log(f"beam_reorder_cache_flat at the {where} shape ({layers} x {n_rows} rows "
            f"x {e} of {s_full} rows of 128, 2 bf16 leaves of (T {t_len}, {heads}, {hd})): "
            f"max_abs_err {err} ms {row['ms']:.4f} plain_ms {row['plain_ms']:.4f} "
            f"bound_ms {b_ms:.4f} library_ms (index_select + zero tail) "
            f"{row['library_ms']:.4f}")
        if where == "main path":
            rows.append(row)
        del leaves
    torch.cuda.empty_cache()

    for r in rows:
        log(
            f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3e} "
            f"(tol {r['tol']}) ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
            f"bound_ms {r['bound_ms']:.5f} ({r['bound_by']}) "
            f"library_ms {r['library_ms']}"
        )
        if not r["max_abs_err"] <= r["tol"]:
            raise AssertionError(f"{r['name']} disagrees with its plain version")
    return rows


def decoder_with(dec, **flags):
    """A TSDecoder built with ``dec``'s settings but the cache flags in
    ``flags`` (``self_kv_bits``, ``flat_self_cache``, ``tmin_self_cache``),
    holding ``dec``'s weight tensors (shared, not copied)."""
    import torch
    from robustsq_whisper_torch.models import TSDecoder

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
    from robustsq_whisper_torch.decode.search import build_beam_decoder
    from robustsq_whisper_torch.decode.speculative import build_speculative_decoder

    if cfg.speculative_gamma > 0:
        return build_speculative_decoder(dec, cfg, device, return_stats=True, draft=draft)
    return build_beam_decoder(dec, cfg, device=device)


def check_small_agreement(torch, dev) -> None:
    """Phase 3: kernels (card, f32) and plain versions (CPU) decode a small
    model's input to the same tokens: greedy over every self-cache layout,
    beam 3 (eager and deferred reorder over the dense flat cache, eager over
    the 5-D cache, whose reorder is the flattened kernel, and over the int8
    flat cache) and speculative decode with a self-draft and with a
    separate 1-layer draft."""
    from robustsq_whisper_torch.decode.search import DecodeConfig
    from robustsq_whisper_torch.init import init_params
    from robustsq_whisper_torch.models import (
        QFormerTSEncoder, TSDecoder, TSEncoderConfig, WhisperDims,
    )

    dims = WhisperDims(
        n_mels=80, n_vocab=120, n_audio_ctx=256, n_audio_state=128,
        n_audio_head=2, n_audio_layer=2, n_text_ctx=64, n_text_state=128,
        n_text_head=2, n_text_layer=2,
    )
    ts = TSEncoderConfig(
        num_query_tokens=4, num_hidden_layers=1, qformer_hidden_size=64,
        qformer_heads=2, qformer_intermediate_size=128,
        use_flash_attention=True, flash_tmaj=True, gelu_approx=True,
    )
    enc = init_params(QFormerTSEncoder(dims, ts), 3).eval()
    dec = init_params(TSDecoder(dims, startofprev_token=3, cross_kv_bits=4), 4)
    draft = init_params(
        TSDecoder(dims.replace(n_text_layer=1), startofprev_token=3, cross_kv_bits=4), 7
    )
    rng = np.random.default_rng(5)
    mel = torch.from_numpy(rng.standard_normal((2, 80, 512)).astype(np.float32))
    emel = torch.from_numpy(rng.standard_normal((2, 80, 120)).astype(np.float32))
    lens, elens = torch.tensor([512, 400]), torch.tensor([120, 90])
    # the prefix is 1 + 4 + 2 = 7 positions, so with R = 8 the deferred
    # reorder flushes a non-empty settled prefix at position 16
    base = dict(max_new_tokens=16, eot=2, init_tokens=(1, 4), quantize_cross_kv=True)
    five = dict(flat_self_cache=False)
    spec = dict(base, speculative_gamma=4, draft_layers=1)
    cases = {  # name: (decoder flags, config, separate draft)
        "greedy": ({}, DecodeConfig(**base), None),
        "beam 3": ({}, DecodeConfig(**base, beam_size=3), None),
        "beam 3 defer_reorder=4": ({}, DecodeConfig(**base, beam_size=3, defer_reorder=4), None),
        "greedy 5-D": (five, DecodeConfig(**base), None),
        "greedy 5-D int8": (dict(five, self_kv_bits=8), DecodeConfig(**base), None),
        "greedy flat int8": (dict(self_kv_bits=8), DecodeConfig(**base), None),
        "greedy time-minor": (dict(tmin_self_cache=True), DecodeConfig(**base), None),
        "beam 3 5-D": (five, DecodeConfig(**base, beam_size=3), None),
        "beam 3 flat int8": (dict(self_kv_bits=8), DecodeConfig(**base, beam_size=3), None),
        "speculative self-draft": (five, DecodeConfig(**spec), None),
        "speculative separate draft": (five, DecodeConfig(**spec), draft),
        "greedy W8A8": ({}, DecodeConfig(**base, quantize_weights=True), None),
        "beam 3 W8A8": ({}, DecodeConfig(**base, beam_size=3, quantize_weights=True), None),
    }
    mems = {}
    for where in ("cpu", dev):
        e = copy.deepcopy(enc).to(where)
        with torch.inference_mode():
            mems[str(where)] = e(
                mel.to(where), lens.to(where), emel.to(where), elens.to(where)
            )
    m_cpu, m_gpu = mems["cpu"][0], mems[str(dev)][0].cpu()
    err = (m_cpu - m_gpu).abs().max().item()
    log(f"small agreement: encoder max_abs_err {err:.3e} (tol 1e-3, f32)")
    ok = err <= 1e-3
    # the random encoder's memory decodes to few distinct tokens; a memory
    # and prompt of larger scale make the beams reorder at most steps
    inputs = {
        "encoder output": {str(w): (m[0], m[2]) for w, m in mems.items()},
        "random memory": {
            w: (torch.from_numpy(rng.standard_normal((2, 40, 128)).astype(np.float32) * 3),
                torch.from_numpy(rng.standard_normal((2, 4, 128)).astype(np.float32) * 3))
            for w in ["cpu"]
        },
    }
    inputs["random memory"][str(dev)] = tuple(
        x.to(dev) for x in inputs["random memory"]["cpu"]
    )
    for (src, pair), (name, (flags, cfg, sep)) in itertools.product(
        inputs.items(), cases.items()
    ):
        out = {}
        for where in ("cpu", dev):
            d = decoder_with(copy.deepcopy(dec), **flags)
            run = decode_fn(d, cfg, where, None if sep is None else copy.deepcopy(sep))
            res = run(*pair[str(where)])
            out[str(where)] = [x.cpu() for x in res[:2]] + [
                {k: v.cpu() for k, v in res[2].items()} if len(res) > 2 else {}
            ]
        (t_cpu, s_cpu, st_cpu), (t_gpu, s_gpu, st_gpu) = out["cpu"], out[str(dev)]
        s_err = (s_cpu - s_gpu).abs().max().item()
        same_stats = all(torch.equal(st_cpu[k], st_gpu[k]) for k in st_cpu)
        # W8A8: the attention kernels' f32 noise can move an activation
        # across a rounding tie and flip one int8 code (tests/test_torch_w8a8.py)
        tol = 5e-2 if cfg.quantize_weights else 1e-3
        log(f"small agreement, {name} on {src}: score max_abs_err {s_err:.3e} "
            f"(tol {tol}, f32); tokens card {t_gpu.tolist()} cpu {t_cpu.tolist()}"
            + (f"; acceptance card {({k: v.tolist() for k, v in st_gpu.items()})} "
               f"equal on the CPU {same_stats}" if st_cpu else ""))
        ok = ok and s_err <= tol and torch.equal(t_cpu, t_gpu) and same_stats
    if not ok:
        raise AssertionError("kernels and plain versions disagree on a small input")


def check_small_remaining(torch, dev) -> None:
    """Phase 3, the remaining decode paths: ``WhisperASR`` greedy and beam 3,
    joint CTC/attention beam 3, greedy with the timestamp rules and
    speculative decode with a distilled 1-layer draft (distilled once, on
    the CPU), each with the kernels in f32 on the card and the plain
    versions on the CPU; the tokens (and acceptance counters) must be
    identical."""
    from robustsq_whisper_torch.decode.joint import build_joint_beam_decoder
    from robustsq_whisper_torch.decode.search import DecodeConfig, build_beam_decoder, strip_eot
    from robustsq_whisper_torch.decode.speculative import build_speculative_decoder
    from robustsq_whisper_torch.init import init_params
    from robustsq_whisper_torch.models import TSDecoder, WhisperDims
    from robustsq_whisper_torch.models.asr import WhisperASR
    from robustsq_whisper_torch.train.distill import distill_draft, teacher_forcing_inputs

    rng = np.random.default_rng(9)
    dims = WhisperDims(
        n_mels=80, n_vocab=120, n_audio_ctx=256, n_audio_state=128, n_audio_head=2,
        n_audio_layer=2, n_text_ctx=64, n_text_state=128, n_text_head=2, n_text_layer=2,
    )
    f32 = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    memory = f32(2, 4 + 40, 128) * 3
    prompt = memory[:, :4].clone()
    mem_lens = torch.tensor([44, 30])
    ctc_lo = (f32(120, 128) * 0.2, f32(120) * 0.5)
    audio = f32(2, 16000 * 3)
    dec = init_params(TSDecoder(dims, startofprev_token=3, cross_kv_bits=4), 4).eval()
    dec5 = decoder_with(dec, flat_self_cache=False)
    base = dict(max_new_tokens=12, eot=2, init_tokens=(1, 4))
    ts_cfg = DecodeConfig(**base, with_timestamps=True, timestamp_begin=100,
                          max_initial_timestamp_index=4, quantize_cross_kv=True)
    spec_cfg = DecodeConfig(**base, quantize_cross_kv=True, speculative_gamma=4, draft_layers=1)

    # the distilled draft: 20 steps against the teacher's greedy rows
    g_tok, _ = build_beam_decoder(dec5, DecodeConfig(**base, quantize_cross_kv=True),
                                  device="cpu")(memory, prompt)
    rows = strip_eot(g_tok, 2)
    text = np.full((2, 1 + max(map(len, rows))), -1, np.int32)
    for i, r in enumerate(rows):
        text[i, : 1 + len(r)] = [4] + r
    ys, mask = teacher_forcing_inputs(text, np.array([1 + len(r) for r in rows]), 1, 2)
    draft, stats = distill_draft(dec5, 1, memory, prompt, ys, mask, steps=20, lr=1e-3,
                                 batch_size=2, seed=0)
    asr_sd = WhisperASR.from_random("dev", seed=5, device="cpu", n_vocab=120,
                                    n_audio_state=128, n_text_state=128, n_text_ctx=64)

    def asr_on(where, beam):
        enc, d = WhisperASR.build(asr_sd.dims)
        enc.load_state_dict(asr_sd.encoder.state_dict())
        d.load_state_dict(asr_sd.decoder.state_dict())
        return WhisperASR(asr_sd.dims, enc, d, device=where).transcribe_batch(
            audio, max_new_tokens=8, beam_size=beam)

    cases = {
        "WhisperASR greedy": lambda w: asr_on(w, 1),
        "WhisperASR beam 3": lambda w: asr_on(w, 3),
        "joint CTC beam 3 w=0.3": lambda w: build_joint_beam_decoder(
            copy.deepcopy(dec), ctc_lo, DecodeConfig(**base, beam_size=3, ctc_decode_weight=0.3,
                                                     pre_beam=6), prompt_frames=4, device=w,
        )(memory, prompt, mem_lens),
        "greedy with timestamps": lambda w: build_beam_decoder(copy.deepcopy(dec), ts_cfg, w)(
            memory, prompt),
        "speculative distilled draft": lambda w: build_speculative_decoder(
            copy.deepcopy(dec5), spec_cfg, w, return_stats=True, draft=copy.deepcopy(draft),
        )(memory, prompt),
    }
    ok = True
    for name, fn in cases.items():
        out = {}
        for where in ("cpu", dev):
            res = fn(where)
            out[str(where)] = [x.cpu() for x in res[:2]] + [
                {k: v.cpu() for k, v in res[2].items()} if len(res) > 2 else {}]
        (t_cpu, s_cpu, st_cpu), (t_gpu, s_gpu, st_gpu) = out["cpu"], out[str(dev)]
        s_err = (s_cpu - s_gpu).abs().max().item()
        same_stats = all(torch.equal(st_cpu[k], st_gpu[k]) for k in st_cpu)
        log(f"small agreement, {name}: score max_abs_err {s_err:.3e} (tol 1e-3, f32); "
            f"tokens card {t_gpu.tolist()} cpu {t_cpu.tolist()}"
            + (f"; acceptance card { {k: v.tolist() for k, v in st_gpu.items()} } equal on "
               f"the CPU {same_stats}; draft final_agreement {stats['final_agreement']}"
               if st_cpu else ""))
        ok = ok and s_err <= 1e-3 and torch.equal(t_cpu, t_gpu) and same_stats
        if name == "speculative distilled draft" and not torch.equal(t_cpu, g_tok):
            raise AssertionError("speculative decode with the distilled draft differs from greedy")
    if not ok:
        raise AssertionError("kernels and plain versions disagree on a remaining decode path")


TRAIN_B, TRAIN_HEADS, TRAIN_T = 8, 16, 1500 + 16  # the JAX bench's training shape


def check_flash_kernels(torch, dev):
    """Phase 5a: the flash forward and its two backward kernels against
    their plain versions, at the medium training shape (bf16) and, with a
    key-padding mask, at a smaller one (bf16 and f32)."""
    from robustsq_whisper_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(1)

    def inputs(b, t, h, dtype, masked):
        q, k, v, do = (
            torch.randn(b, t, h, 64, generator=g, device=dev).to(dtype) for _ in range(4)
        )
        m = None
        if masked:  # key padding, the second row keeps half its keys
            lens = torch.tensor([t, t // 2 + 1][:b], device=dev)
            valid = torch.arange(t, device=dev)[None] < lens[:, None]
            m = torch.where(valid, 0.0, -1e9)[:, None, None, :]
        return q, k, v, do, m

    def errors(q, k, v, do, m):
        """max |kernel - plain| and max |plain| of out, dq, dk, dv (the
        backward kernels read the plain forward's lse, as in the tests)."""
        ref_out, lse = fa.flash_attention_fwd_plain(q, k, v, m)
        delta = fa.flash_delta(ref_out, do)
        got = (fa.flash_attention_fwd(q, k, v, m)[0],
               fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, m),
               *fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, m))
        ref = (ref_out, fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, m),
               *fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, m))
        return [((a.float() - b.float()).abs().max().item(), b.float().abs().max().item())
                for a, b in zip(got, ref)], lse, delta

    # f32 (SIMT): summation order and exp2f; bf16 (tensor cores): operands,
    # P and dS rounded to bf16 before their products, results to bf16.
    # Relative to the largest plain value of each result.
    tols = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    ok = True
    for dtype in (torch.bfloat16, torch.float32):
        errs, _, _ = errors(*inputs(2, 301, 4, dtype, masked=True))
        for name, (e, scale) in zip(("out", "dq", "dk", "dv"), errs):
            log(f"flash {name}, padding mask, (2, 301, 4, 64) {dtype}: max_abs_err "
                f"{e:.3e} (tol {tols[dtype]} x {scale:.3f})")
            ok = ok and e <= tols[dtype] * scale
    b, h, t = TRAIN_B, TRAIN_HEADS, TRAIN_T
    q, k, v, do, _ = inputs(b, t, h, torch.bfloat16, masked=False)
    errs, lse, delta = errors(q, k, v, do, None)
    bh = b * h
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs, dos = (x.transpose(1, 2).detach() for x in (q, k, v, do))
    leaves = [x.clone().requires_grad_() for x in (qs, ks, vs)]

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(*leaves), leaves, dos)

    lib_fwd = time_events_ms(torch, lambda: sdpa(qs, ks, vs), 20)
    lib_bwd = time_events_ms(torch, sdpa_fwd_bwd, 10) - lib_fwd
    log(f"scaled_dot_product_attention at the training shape: forward {lib_fwd:.4f} ms "
        f"(events), backward {lib_bwd:.4f} ms (forward + backward minus forward)")
    # the port's whole backward (delta, dQ, dK/dV), timed the same way
    port_leaves = [x.clone().requires_grad_() for x in (q, k, v)]

    def port_fwd_bwd():
        return torch.autograd.grad(fa.flash_attention(*port_leaves), port_leaves, do)

    port_fwd = time_events_ms(torch, lambda: fa.flash_attention_fwd(q, k, v), 20)
    port_bwd = time_events_ms(torch, port_fwd_bwd, 10) - port_fwd
    log(f"flash_attention at the training shape: forward {port_fwd:.4f} ms (events), "
        f"backward {port_bwd:.4f} ms (delta + dQ + dK/dV; forward + backward minus "
        f"forward)")
    io = bh * t * 64 * 2  # one bf16 (b, T, h, 64) tensor
    specs = [  # name, TPU kernel line, call, plain, bytes, operations, library ms
        ("flash_attention", 42, lambda: fa.flash_attention_fwd(q, k, v),
         lambda: fa.flash_attention_fwd_plain(q, k, v),
         4 * io + bh * t * 4, 4 * bh * t * t * 64,
         time_ms(torch, lambda: sdpa(qs, ks, vs))),
        ("flash_attention_bwd_dq", 215,
         lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta),
         lambda: fa.flash_attention_bwd_dq_plain(q, k, v, do, lse, delta),
         5 * io + 2 * bh * t * 4, 6 * bh * t * t * 64, lib_bwd),
        ("flash_attention_bwd_dkv", 250,
         lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta),
         lambda: fa.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta),
         6 * io + 2 * bh * t * 4, 8 * bh * t * t * 64, lib_bwd),
    ]
    errs = [errs[0], errs[1], max(errs[2:], key=lambda x: x[0] / x[1])]
    rows = []
    for (name, line, call, plain, nbytes, ops, lib), (e, scale) in zip(specs, errs):
        b_ms, b_by = bound(nbytes, ops, "bf16")
        rows.append(dict(
            name=name, route="cuda",
            source="robustsq_whisper_torch/csrc/" + (
                "flash_attention.cu" if name == "flash_attention" else "flash_attention_bwd.cu"),
            replaces=f"{TPU_SRC}/flash_attention.py:{line}",
            max_abs_err=e, tol=tols[torch.bfloat16] * scale,
            ms=time_ms(torch, call), plain_ms=time_ms(torch, plain, 3),
            bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        ))
        r = rows[-1]
        with_shares(r)
        log(f"kernel {name} at ({b}, {t}, {h}, 64) bf16: max_abs_err {e:.3e} (tol "
            f"{r['tol']:.3e}) ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
            f"{b_ms:.5f} ({b_by}) library_ms {lib:.4f}")
        ok = ok and e <= r["tol"]
    pair = rows[1]["ms"] + rows[2]["ms"]
    pair_bound = rows[1]["bound_ms"] + rows[2]["bound_ms"]
    # a fused backward (dQ accumulated across key blocks) recomputes S and dP
    # once: 10 bh T^2 64 operations where the two kernels do 14
    fused_bound, _ = bound(0, 10 * bh * t * t * 64, "bf16")
    log(f"backward pair (dQ + dK/dV) {pair:.4f} ms, share_of_bound {pair_bound / pair:.3f} "
        f"(bound {pair_bound:.4f} ms), {pair / lib_bwd:.2f}x "
        f"scaled_dot_product_attention's whole backward ({lib_bwd:.4f} ms); the port's "
        f"whole backward {port_bwd:.4f} ms, {port_bwd / lib_bwd:.2f}x sdpa's; a fused "
        f"backward's bound {fused_bound:.4f} ms, sdpa's share of it "
        f"{fused_bound / lib_bwd:.3f}")
    if not ok:
        raise AssertionError("a flash training kernel disagrees with its plain version")
    return rows


def small_train_model(torch, seed: int):
    """A small f32 TSASRModel on the flash route (2 + 256 encoder positions,
    head_dim 64), without SpecAugment or dropout, and a batch of 2."""
    from robustsq_whisper_torch.init import init_params
    from robustsq_whisper_torch.models import (
        TSASRModel, TSEncoderConfig, TSModelConfig, WhisperDims,
    )

    dims = WhisperDims(
        n_mels=80, n_vocab=120, n_audio_ctx=256, n_audio_state=128,
        n_audio_head=2, n_audio_layer=2, n_text_ctx=64, n_text_state=128,
        n_text_head=2, n_text_layer=2,
    )
    ts = TSEncoderConfig(
        num_query_tokens=2, num_hidden_layers=1, qformer_hidden_size=64,
        qformer_heads=2, qformer_intermediate_size=128, use_flash_attention=True,
        qformer_hidden_dropout=0.0, qformer_attention_dropout=0.0, remat=True,
    )
    cfg = TSModelConfig(vocab_size=120, sos=1, eos=2, startofprev=3, num_speakers=8,
                        num_negatives=1, use_specaug=False)
    model = init_params(TSASRModel(dims, ts, cfg), seed)
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


def check_small_training(torch, dev) -> None:
    """Phase 5b: one train step of a small f32 model on the card (the
    kernels' f32 route) and on the CPU (the plain versions): the loss and
    every gradient agree; four steps on the card lower the loss."""
    from robustsq_whisper_torch.train import OptimConfig, TrainConfig
    from robustsq_whisper_torch.train import create_train_state, make_train_step

    base, batch = small_train_model(torch, 6)
    grads = {}
    for where in ("cpu", dev):
        model = copy.deepcopy(base).to(where)
        loss, stats = model({k: v.to(where) for k, v in batch.items()}, None, 6, train=True)
        loss.backward()
        grads[str(where)] = (loss.item(), {n: p.grad.cpu() for n, p in model.named_parameters()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = grads["cpu"], grads[str(dev)]
    # f32 both ways: CTC, cuBLAS and the kernels sum in other orders; each
    # gradient is held to 2e-3 of its own largest entry (1e-6 absolute for
    # those that are zero in exact arithmetic, the attention key biases)
    worst = max(
        ((g_gpu[n] - g).abs().max().item() / max(g.abs().max().item(), 5e-4), n)
        for n, g in g_cpu.items()
    )
    log(f"small training agreement: loss card {l_gpu:.6f} cpu {l_cpu:.6f}; worst "
        f"gradient {worst[1]} at {worst[0]:.3e} of its scale (tol 2e-3), "
        f"{len(g_cpu)} tensors")
    if not (abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu) and worst[0] <= 2e-3):
        raise AssertionError("the training step disagrees between card and CPU")
    cfg = TrainConfig(optim=OptimConfig(lr=1e-3, schedule="constant"))
    model = copy.deepcopy(base)
    state = create_train_state(model, cfg, device=dev)
    step = make_train_step(model, cfg, device=dev)
    losses = [step(state, batch, None, 6)[1]["loss"].item() for _ in range(4)]
    log(f"small training, four card steps: losses {losses}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("four training steps did not lower the loss")


TRAIN_KERNELS = {"flash_attention": 48, "flash_attention_bwd_dq": 24,
                 "flash_attention_bwd_dkv": 24}  # per step at medium
TRAIN_MODES = {"train lora": ("lora", "float32"), "train full": ("full", "bfloat16")}


def train_batch(torch, dev, b: int, vocab: int):
    """The JAX bench's training batch: b x (30 s speech, 10 s enrollment),
    48 text tokens, every other row a valid negative."""
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


def host_syncs(torch, fn):
    """The host syncs ``fn`` makes with the card, by
    ``torch.cuda.set_sync_debug_mode``: {python file:line: count}."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}"
            out[key] = out.get(key, 0) + 1
    return out


def run_train_paths(torch, dev):
    """Phase 5c: make_train_step at Whisper-medium, lora then full. Returns
    ({path: launches of one step}, a profiled-step closure, {path: audio-s
    per GPU-s at the fastest step})."""
    from robustsq_whisper_torch.init import init_params
    from robustsq_whisper_torch.models import (
        TSASRModel, TSEncoderConfig, TSModelConfig, whisper_dims,
    )
    from robustsq_whisper_torch.train import OptimConfig, TrainConfig
    from robustsq_whisper_torch.train import create_train_state, make_train_step
    from robustsq_whisper_torch.train.lora import detach_lora

    dims = whisper_dims("medium")
    ts = TSEncoderConfig(use_flash_attention=True, flash_tmaj=False, remat=True,
                         gelu_approx=False)
    t0 = time.perf_counter()
    model = init_params(TSASRModel(dims, ts, TSModelConfig()), 2)
    model.set_compute_dtype(torch.bfloat16)
    log(f"medium training model: {sum(p.numel() for p in model.parameters())} "
        f"parameters, seeded init {time.perf_counter() - t0:.1f} s")
    counters = launch_counters()
    launches, rates, profiled = check_sharded_steps(torch, dev, model, dims.n_vocab), {}, None
    for path, (mode, mu) in TRAIN_MODES.items():
        cfg = TrainConfig(mode=mode, optim=OptimConfig(moment_dtype=mu))
        b = TRAIN_B
        while True:
            try:
                detach_lora(model)
                state = create_train_state(model, cfg, device=dev)
                step = make_train_step(model, cfg, device=dev)
                batch = train_batch(torch, dev, b, dims.n_vocab)
                gen = torch.Generator(device=dev).manual_seed(0)
                torch.cuda.reset_peak_memory_stats(dev)
                step(state, batch, gen, 0)  # warm-up
                torch.cuda.synchronize()
                break
            except torch.cuda.OutOfMemoryError:
                state = step = batch = None
                torch.cuda.empty_cache()
                b //= 2
                log(f"{path}: out of memory, batch halved to {b}")
                if b < 1:
                    raise
        times, losses = [], []
        for _ in range(3):
            for w, attr in counters.values():
                setattr(w, attr, 0)
            t0 = time.perf_counter()
            _, stats = step(state, batch, gen, 0)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            counts = {n: getattr(w, attr) for n, (w, attr) in counters.items()}
            losses.append({k: round(v.item(), 4) for k, v in stats.items()})
            wrong = {n: counts[n] for n, want in TRAIN_KERNELS.items() if counts[n] != want}
            if wrong:
                raise AssertionError(f"{path}: launches per step {wrong}, want {TRAIN_KERNELS}")
        launches[path] = counts
        rates[path] = b * 30 / min(times)
        syncs = host_syncs(torch, lambda: step(state, batch, gen, 0))
        n_train = sum(t.numel() for t in state.trainables)
        log(f"{path} (batch {b}, moments {mu}, {n_train} trainable): step ms "
            f"{[round(x * 1e3, 1) for x in times]}, {b * 30 / min(times):.2f} audio-s per "
            f"GPU-s at the fastest, peak memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches per step "
            f"{ {n: counts[n] for n in TRAIN_KERNELS} }; stats {losses}; host syncs in one "
            f"step {syncs}")
        if not all(np.isfinite(list(x.values())).all() for x in losses):
            raise AssertionError(f"{path}: non-finite loss or stats")
        if mode == "full":
            profiled = (state, step, batch, gen)
        else:
            del state, step, batch
            torch.cuda.empty_cache()
    return launches, profiled, rates


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


def launch_counters():
    """{kernel row name: (wrapper, counter attribute)}, every kernel."""
    from robustsq_whisper_torch.ops import beam_gather as bg
    from robustsq_whisper_torch.ops import decode_attention as xa
    from robustsq_whisper_torch.ops import flash_attention as fa
    from robustsq_whisper_torch.ops import quant
    from robustsq_whisper_torch.ops import self_attention as sa

    return {
        "flash_attention_tmaj": (fa.flash_attention_tmaj, "launches"),
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
    after; returns (its result, wall s, {kernel: launches})."""
    counters = launch_counters()
    torch.cuda.synchronize()
    for w, attr in counters.values():
        setattr(w, attr, 0)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {n: getattr(w, attr) for n, (w, attr) in counters.items()}


def counted_transcribe(torch, engine, items, path: str, expect):
    """Transcribe with every launch count set to 0 just before and read just
    after; each kernel in ``expect`` must have launched. Returns (wall s,
    {kernel: launches})."""
    engine.warmup()
    texts, wall, counts = counted(torch, lambda: engine.transcribe(items))
    log(f"main path {path}: transcribe {wall * 1e3:.1f} ms for {len(items)} x 30 s; "
        f"launches {counts}")
    missing = [n for n in expect if counts[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: {missing}")
    if len(texts) != len(items) or not all(isinstance(t, str) for t in texts):
        raise AssertionError("transcribe returned no text per item")
    return wall, counts


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
    t0 = time.perf_counter()
    enc = init_params(QFormerTSEncoder(dims, ts), 0).to(dev, torch.bfloat16)
    dec = init_params(TSDecoder(dims, cross_kv_bits=4, self_kv_bits=16), 1)
    dec = dec.to(dev, torch.bfloat16)
    n_par = sum(p.numel() for m in (enc, dec) for p in m.parameters())
    log(f"medium weights: {n_par} parameters, seeded init {time.perf_counter() - t0:.1f} s")
    return dims, enc, dec


def serving_config(max_new: int, **cfg):
    """The main paths' DecodeConfig: int4 cross K/V kernel, stop early."""
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

    dcfg = serving_config(max_new, **cfg)
    return TranscriptionEngine(
        enc, dec, ByteTokenizer(), dcfg,
        EngineConfig(batch_size=batch, speech_seconds=30.0, enroll_seconds=10.0),
        device=dev,
    )


GREEDY_KERNELS = ("flash_attention_tmaj", "decode_cross_attention", "decode_self_attention")
OWN_PATH = {  # the path a kernel was ported for, where not greedy's
    "decode_cross_attention_grouped": "beam 5 eager",
    "decode_self_attention_int8": "greedy self_kv_bits=8",
    "decode_cross_attention_state": "greedy tmin_self_cache",
    "beam_reorder_cache": "beam 5 eager",
    "beam_reorder_cache_flat": "beam 5 flat_self_cache=False",
    "settled_self_attention": "beam 5 defer_reorder=8",
    "flash_attention": "train full",
    "flash_attention_bwd_dq": "train full",
    "flash_attention_bwd_dkv": "train full",
    "w8a8_matmul": "greedy W8A8",
}


def run_main_path(torch, dev, models, batch: int, max_new: int):
    """Phase 4, greedy: the engine at full Whisper-medium size."""
    from robustsq_whisper_torch.decode.pipeline import chunked_encode
    from robustsq_whisper_torch.decode.search import strip_eot

    dims, enc, dec = models
    items = synthetic_pairs(batch, seed=0)
    launches = {}
    for pq in (False, True):
        engine = engine_for(torch, dev, enc, dec, batch, max_new, prefill_quantized=pq)
        dcfg = engine.dcfg
        _, launches[pq] = counted_transcribe(
            torch, engine, items, f"greedy prefill_quantized={pq}", GREEDY_KERNELS
        )

        # phase-timed pass over the same batch
        times = {}
        t0 = time.perf_counter()
        staged = engine.stage(items)
        torch.cuda.synchronize()
        times["frontend"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        memory, prompt = chunked_encode(engine.encode, staged, 0)
        torch.cuda.synchronize()
        times["encode"] = time.perf_counter() - t0
        with torch.inference_mode():
            t0 = time.perf_counter()
            cross = dec.cross_kv(memory, quantize=pq)
            cache = dec.init_cache(batch, 1 + 16 + len(dcfg.init_tokens) + max_new)
            init = torch.tensor(dcfg.init_tokens, device=dev)[None].expand(batch, -1)
            logits, _ = dec.prefill(init, prompt, cache, cross)
            if not pq:
                dec.quantize_cross(cross)
            torch.cuda.synchronize()
            times["cross_kv_prefill"] = time.perf_counter() - t0
            del cross, cache
        t0 = time.perf_counter()
        tokens, scores = engine.run(memory, prompt)
        torch.cuda.synchronize()
        times["run"] = time.perf_counter() - t0
        times["token_loop"] = times["run"] - times["cross_kv_prefill"]
        n_tok = [len(r) for r in strip_eot(tokens.cpu().tolist(), dcfg.eot)]
        log(f"phases prefill_quantized={pq} (ms): "
            + " ".join(f"{k} {v * 1e3:.1f}" for k, v in times.items())
            + f"; decoded tokens per row {n_tok}")
        if not pq:
            profiled = (engine, staged, memory, prompt)
        if memory.shape != (batch, 16 + dims.n_audio_ctx, dims.n_audio_state):
            raise AssertionError(f"encoder memory shape {tuple(memory.shape)}")
        if not (torch.isfinite(memory.float()).all() and torch.isfinite(logits).all()
                and torch.isfinite(scores).all()):
            raise AssertionError("non-finite encoder memory, logits or scores")
        if tokens.shape != (batch, max_new) or not (
            (tokens >= 0) & (tokens < dims.n_vocab)
        ).all():
            raise AssertionError("tokens out of shape or vocabulary")

    return launches[False], profiled


BEAM_PATHS = {  # path: (config, kernels it must launch)
    "beam 5 eager": (
        dict(beam_size=5),
        ("beam_reorder_cache", "decode_cross_attention_grouped", "decode_self_attention"),
    ),
    "beam 5 defer_reorder=8": (
        dict(beam_size=5, defer_reorder=8),
        ("settled_self_attention", "beam_reorder_cache", "decode_cross_attention_grouped"),
    ),
}


def run_beam_paths(torch, dev, models, batch: int, max_new: int):
    """Phase 4, beam search: beam 5 over batch rows x 5 beam rows, with the
    eager reorder and with the deferred one (the prefix is 21 positions, so
    with R = 8 the first window starts at 16 and flushes come at positions
    24, 32, 40 and 48)."""
    from robustsq_whisper_torch.decode.pipeline import chunked_encode
    from robustsq_whisper_torch.decode.search import strip_eot

    dims, enc, dec = models
    items = synthetic_pairs(batch, seed=0)
    launches, engines = {}, {}
    for path, (cfg, expect) in BEAM_PATHS.items():
        engine = engine_for(torch, dev, enc, dec, batch, max_new, **cfg)
        _, launches[path] = counted_transcribe(torch, engine, items, path, expect)
        engines[path] = engine
    # the two reorders decode the same tokens
    staged = engines["beam 5 eager"].stage(items)
    outs = {}
    for path, engine in engines.items():
        memory, prompt = chunked_encode(engine.encode, staged, 0)
        tokens, scores = engine.run(memory, prompt)
        outs[path] = (tokens.cpu(), scores.cpu())
    (t_e, s_e), (t_d, s_d) = outs.values()
    n_tok = [len(r) for r in strip_eot(t_e.tolist(), engines["beam 5 eager"].dcfg.eot)]
    log(f"beam 5: eager and deferred tokens identical {torch.equal(t_e, t_d)}, "
        f"score max_abs_diff {(s_e - s_d).abs().max().item():.3e}; decoded tokens "
        f"per row {n_tok}")
    if t_e.shape != (batch, max_new) or not (torch.isfinite(s_e).all() and
                                             ((t_e >= 0) & (t_e < dims.n_vocab)).all()):
        raise AssertionError("beam tokens out of shape or vocabulary, or scores not finite")
    return launches, (engines, memory, prompt)


LAYOUT_PATHS = {  # path: (decoder flags, config, kernels it must launch)
    "greedy self_kv_bits=8": (
        dict(self_kv_bits=8), dict(),
        ("decode_self_attention_int8", "decode_cross_attention", "flash_attention_tmaj"),
    ),
    "greedy tmin_self_cache": (
        dict(tmin_self_cache=True), dict(),
        ("decode_cross_attention_state", "decode_cross_attention"),
    ),
    "beam 5 flat_self_cache=False": (
        dict(flat_self_cache=False), dict(beam_size=5),
        ("beam_reorder_cache_flat", "decode_cross_attention_grouped"),
    ),
    "beam 5 self_kv_bits=8": (
        dict(self_kv_bits=8), dict(beam_size=5),
        ("decode_self_attention_int8", "beam_reorder_cache",
         "decode_cross_attention_grouped"),
    ),
    # the JAX bench's trained-lane settings (gamma 10, a 1-layer draft),
    # self-drafting over the 5-D cache
    "speculative gamma=10": (
        dict(flat_self_cache=False), dict(speculative_gamma=10, draft_layers=1),
        ("decode_cross_attention", "flash_attention_tmaj"),
    ),
}


MESH_PATHS = {  # phase 4g: path -> (decode config, kernels the decoder must launch)
    "greedy": ({}, ("decode_cross_attention", "decode_self_attention")),
    "beam 5": (dict(beam_size=5), ("decode_cross_attention_grouped", "beam_reorder_cache",
                                   "decode_self_attention")),
}


def run_multi_gpu_decode(torch, dev, models, batch: int, max_new: int):
    """Phase 4g, serving: a one-process NCCL group and a (1, 1) mesh;
    greedy and beam 5 through ``build_decode_fns(mesh=)`` and
    ``build_sharded_decoder`` against the unsharded decode: the same tokens
    and launches. Returns ({path: launches}, the mesh)."""
    import torch.distributed as dist

    from robustsq_whisper_torch.decode.pipeline import build_decode_fns
    from robustsq_whisper_torch.decode.sharded import build_sharded_decoder
    from robustsq_whisper_torch.parallel.mesh import init_distributed, local_rows, make_mesh

    t_phase = time.perf_counter()
    world = init_distributed(f"tcp://localhost:{free_port()}", 1, 0, device=dev)
    one = torch.ones(4, device=dev)
    dist.all_reduce(one)
    torch.cuda.synchronize()
    if world != 1 or dist.get_backend() != "nccl" or not bool((one == 1).all()):
        raise AssertionError(f"process group: world {world}, backend {dist.get_backend()}, "
                             f"all-reduce of ones {one.tolist()}")
    mesh = make_mesh(1, 1)
    log(f"multi-GPU: NCCL process group at world 1 ({time.perf_counter() - t_phase:.1f} s), "
        f"mesh {mesh}")
    dims, enc, dec = models
    staged = engine_for(torch, dev, enc, dec, batch, max_new).stage(synthetic_pairs(batch, seed=0))
    launches = {}
    for path, (cfg, expect) in MESH_PATHS.items():
        dcfg = serving_config(max_new, **cfg)
        encode, run = build_decode_fns(enc, dec, dcfg, device=dev)
        s_encode, s_run = build_decode_fns(enc, dec, dcfg, mesh=mesh, device=dev)
        direct = build_sharded_decoder(dec, dcfg, mesh, dev)
        memory, prompt = encode(*staged)
        runs = {  # name: (the call, its unsharded counterpart)
            "build_decode_fns(mesh)": (lambda: s_run(*s_encode(*staged)),
                                       lambda: run(*encode(*staged))),
            "build_sharded_decoder": (
                lambda: direct(local_rows(memory, mesh), local_rows(prompt, mesh)),
                lambda: run(memory, prompt)),
        }
        for name, (sharded, plain) in runs.items():
            ref, _, counts_u = counted(torch, plain)
            got, _, counts_s = counted(torch, sharded)
            if not torch.equal(got[0], ref[0]) or counts_s != counts_u:
                raise AssertionError(f"{path} {name}: tokens equal {torch.equal(got[0], ref[0])}, "
                                     f"launches {counts_s} vs unsharded {counts_u}")
            launches[f"{path} {name}"] = counts_s
        missing = [n for n in expect if launches[f"{path} build_sharded_decoder"][n] == 0]
        if missing:
            raise AssertionError(f"{path}: kernels not launched through the mesh: {missing}")
    log(f"multi-GPU at world 1 on {gpu_info()}: tokens and every kernel's launches equal the "
        f"unsharded decode's ({time.perf_counter() - t_phase:.1f} s); at one rank the sharded "
        f"code is the unsharded code, so no time is compared")
    return launches, mesh


def run_one_card_ranks(torch):
    """Phase 4g, the sharded code with its collectives: two gloo ranks on
    the one card (``multi_gpu_check.py --one-card`` under
    ``torch.distributed.run --nproc_per_node 2``) decode greedy and beam 5
    data-parallel, each rank's rows bit-equal to its decode of them alone
    with the same launches, and take one DP and one FSDP lora step within
    that script's bars of one device's. Returns {path: rank 0's launches}."""
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
           "--master_port", str(free_port()), os.path.join(ROOT, "multi_gpu_check.py"),
           "--one-card"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"two gloo ranks on one card: rc {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-6000:]}")
    rec = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
    log(f"multi-GPU, two gloo ranks on one card ({time.perf_counter() - t0:.1f} s with the "
        f"launcher) on {gpu_info()}: {json.dumps(rec)}")
    return {f"{path} (2 gloo ranks)": v["launches_by_rank"][0]
            for path, v in rec.items() if isinstance(v, dict) and "launches_by_rank" in v}


def torchrun_decode(argv) -> int:
    """This script's ``torchrun-decode`` mode (phase 4g): ``cli.decode``
    under ``torch.distributed.run``, with phase 4b's tokenizer swap; prints
    its launches as a JSON line."""
    import torch

    from robustsq_whisper_torch.cli import decode as cli_decode
    from robustsq_whisper_torch.tokenizer import whisper_tokenizer

    load_tokenizer = whisper_tokenizer.load_tokenizer
    whisper_tokenizer.load_tokenizer = lambda assets: TokenIds(load_tokenizer(assets))
    rc, wall, counts = counted(torch, lambda: cli_decode.main(argv))
    print(json.dumps({"rc": rc, "main_s": wall, "launches": counts}))
    return rc


def run_torchrun_decode(torch, argv, out_dir: str):
    """Phase 4g inside 4b: ``cli.decode --data_parallel true`` under
    ``torch.distributed.run --nproc_per_node 1``; its ``text`` must be
    ``out_dir``'s byte for byte. Returns {path: launches}."""
    out = out_dir + "_torchrun"
    argv = [out if a == out_dir else a for a in argv] + ["--data_parallel", "true"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
           "--master_port", str(free_port()), os.path.abspath(__file__), "torchrun-decode",
           *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=400)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torchrun cli.decode: rc {proc.returncode}\n{proc.stderr[-4000:]}")
    rec = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
    with open(os.path.join(out_dir, "text"), "rb") as f, open(os.path.join(out, "text"), "rb") as g:
        same = f.read() == g.read()
    missing = [n for n in GREEDY_KERNELS if rec["launches"][n] == 0]
    if not same or missing or rec["rc"] != 0:
        raise AssertionError(f"torchrun cli.decode: text equal {same}, kernels not launched "
                             f"{missing}, rc {rec['rc']}")
    log(f"multi-GPU: cli.decode --data_parallel true under torch.distributed.run "
        f"--nproc_per_node 1 on {gpu_info()}: {wall:.1f} s with the launcher ({rec['main_s']:.1f} "
        f"s in main), text byte-identical to phase 4b's greedy; launches {rec['launches']}")
    return {"cli.decode torchrun": rec["launches"]}


def check_sharded_steps(torch, dev, model, vocab: int):
    """Phase 4g, training: one lora step of the medium model unsharded,
    data-parallel and FSDP on a (1, 1) mesh, each from the same weights and
    a fresh optimizer, after one warm-up step: the same loss and gradient
    norm (1e-6 relative), rows 4, 5a and 5b launched as in
    ``TRAIN_KERNELS``. Returns {path: launches}."""
    from robustsq_whisper_torch.parallel.mesh import make_mesh
    from robustsq_whisper_torch.train import OptimConfig, TrainConfig
    from robustsq_whisper_torch.train import create_train_state, make_train_step
    from robustsq_whisper_torch.train.lora import detach_lora
    from robustsq_whisper_torch.train.step import FROZEN_BACKBONE_TRAINABLE, trainable_mask

    mesh = make_mesh(1, 1)
    mask = trainable_mask(model, FROZEN_BACKBONE_TRAINABLE)
    saved = {n: p.detach().clone() for n, p in model.named_parameters() if mask[n]}
    batch = train_batch(torch, dev, TRAIN_B, vocab)
    launches, report, ref = {}, {}, None
    paths = {"warm-up": (None, False), "train lora": (None, False),
             "train lora DP": (mesh, False), "train lora FSDP": (mesh, True)}
    for path, (m, fsdp) in paths.items():
        detach_lora(model)
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in saved:
                    p.copy_(saved[n])
        cfg = TrainConfig(mode="lora", optim=OptimConfig(), fsdp=fsdp)
        state = create_train_state(model, cfg, device=dev, mesh=m)
        step = make_train_step(model, cfg, device=dev, mesh=m)
        gen = torch.Generator(device=dev).manual_seed(0)
        (_, stats), _, counts = counted(torch, lambda: step(state, batch, gen, 0))
        got = (stats["loss"].item(), stats["grad_norm"].item())
        wrong = {n: counts[n] for n, want in TRAIN_KERNELS.items() if counts[n] != want}
        ref = got if ref is None else ref
        del state, step
        torch.cuda.empty_cache()
        if path == "warm-up":  # the first step of the process pays for its allocations
            continue
        if wrong or not np.allclose(got, ref, rtol=1e-6, atol=0):
            raise AssertionError(f"{path}: loss, grad norm {got} vs unsharded {ref}; launches "
                                 f"{wrong}, want {TRAIN_KERNELS}")
        launches[path] = counts
        report[path] = {"loss": got[0], "grad_norm": got[1]}
    detach_lora(model)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n in saved:
                p.copy_(saved[n])
    log(f"multi-GPU training on {gpu_info()} (first step from the same weights, batch "
        f"{TRAIN_B}; loss and grad norm equal the unsharded step's): {json.dumps(report)}")
    return {k: v for k, v in launches.items() if k != "train lora"}


def run_layout_paths(torch, dev, models, batch: int, max_new: int):
    """Phase 4, the other self-cache layouts and speculative decode: a
    counted transcribe each. Then speculative decode against greedy over
    the 5-D cache on one encoder output: with the decoder in f32 the
    tokens must be identical; in bf16 the share of identical tokens and the
    acceptance counters are printed (a multi-token verify rounds otherwise
    than one-token steps, and random weights leave near-ties)."""
    from robustsq_whisper_torch.decode.pipeline import chunked_encode
    from robustsq_whisper_torch.decode.search import strip_eot

    dims, enc, dec = models
    items = synthetic_pairs(batch, seed=0)
    launches = {}
    for path, (flags, cfg, expect) in LAYOUT_PATHS.items():
        engine = engine_for(torch, dev, enc, decoder_with(dec, **flags), batch, max_new, **cfg)
        _, launches[path] = counted_transcribe(torch, engine, items, path, expect)
    memory, prompt = chunked_encode(engine.encode, engine.stage(items), 0)
    dcfg = engine.dcfg
    greedy_cfg = dataclasses.replace(dcfg, speculative_gamma=0)
    for name, d in (("bf16", dec), ("f32", copy.deepcopy(dec).float())):
        d5 = decoder_with(d, flat_self_cache=False)
        g_tok, g_score = decode_fn(d5, greedy_cfg, dev)(memory, prompt)
        s_tok, s_score, st = decode_fn(d5, dcfg, dev)(memory, prompt)
        same = (g_tok == s_tok).float().mean().item()
        n_tok = [len(r) for r in strip_eot(g_tok.cpu().tolist(), dcfg.eot)]
        log(f"speculative vs 5-D greedy at medium, decoder {name}: identical token share "
            f"{same:.4f}, score max_abs_diff {(g_score - s_score).abs().max().item():.3e}, "
            f"greedy tokens per row {n_tok}; counters "
            f"{ {k: v.tolist() for k, v in st.items()} }")
        if not (torch.isfinite(s_score).all() and s_tok.shape == (batch, max_new)):
            raise AssertionError("speculative tokens out of shape or scores not finite")
        if name == "f32" and not torch.equal(g_tok, s_tok):
            raise AssertionError("f32 speculative tokens differ from the 5-D greedy's")
        del d5
    del d
    torch.cuda.empty_cache()
    return launches


ASR_PATHS = {  # path: (beam size, kernels it must launch)
    "WhisperASR greedy": (1, ("decode_self_attention",)),
    "WhisperASR beam 3": (3, ("decode_self_attention", "beam_reorder_cache")),
}


def run_asr_paths(torch, dev, models, batch: int, max_new: int):
    """Phase 4, zero-shot ``WhisperASR`` at Whisper-medium (bf16): the
    medium weights without the speaker prompt, its plain-attention encoder
    (``use_flash=False``, the JAX default) and the dense cross K/V over the
    flat self cache, greedy and beam 3 on 30 s audio, each run counted."""
    from robustsq_whisper_torch.models.asr import WhisperASR
    from robustsq_whisper_torch.models.whisper.modules import AudioEncoder

    dims, enc, dec = models
    with torch.device("meta"):
        audio_enc = AudioEncoder(dims)
    audio_enc.load_state_dict(enc.encoder.state_dict(), assign=True)
    asr = WhisperASR(dims, audio_enc, decoder_with(dec, use_spk_prompt=False),
                     dtype=torch.bfloat16, device=dev)
    audio = torch.from_numpy(np.stack([sp for sp, _ in synthetic_pairs(batch, seed=0)]))
    launches = {}
    for path, (beam, expect) in ASR_PATHS.items():
        asr.transcribe_batch(audio[:1], max_new_tokens=4, beam_size=beam)  # warm-up
        (tokens, scores), wall, counts = counted(
            torch, lambda: asr.transcribe_batch(audio, max_new_tokens=max_new, beam_size=beam))
        launches[path] = counts
        log(f"{path} at medium on {gpu_info()}: {wall * 1e3:.1f} ms for {batch} x 30 s "
            f"(RTF {batch * 30.0 / wall:.1f}); launches {counts}")
        missing = [n for n in expect if counts[n] == 0]
        if missing or tokens.shape != (batch, max_new) or not torch.isfinite(scores).all():
            raise AssertionError(f"{path}: kernels not launched {missing}, tokens "
                                 f"{tuple(tokens.shape)}, scores {scores.tolist()}")
    return launches


ROOT = os.path.dirname(os.path.abspath(__file__))
ENTRY_CONFIG = os.path.join(ROOT, "conf/tswhisper/train_tsasr_whisper_medium_lora_qkvo_r16_.yaml")
ENTRY_RANKS = os.path.join(ROOT, "tests/assets/mini_ranks.tiktoken")
ENTRY_PATHS = {  # path: (beam size, kernels it must launch)
    "cli.decode greedy": (1, GREEDY_KERNELS),
    "cli.decode beam 5": (5, ("decode_cross_attention_grouped", "beam_reorder_cache",
                              "decode_self_attention", "flash_attention_tmaj")),
}
ENTRY_REFS = ("the cat sat on the mat", "a quick brown fox", "hello from the other side",
              "one two three four", "speak to me", "the end of the line",
              "it's all in the mind", "then there were none")


def write_data_dir(root: str, n: int, seconds: float = 30.0):
    """A Kaldi data dir of ``n`` utterances (wav.scp, text, utt2spk,
    enroll.scp): the synthetic speech of ``seconds`` and 10 s enrollments
    as WAV."""
    from robustsq_whisper_torch.data import kaldi_io

    wav, text, utt2spk, enroll = {}, {}, {}, {}
    for i, (speech, enr) in enumerate(synthetic_pairs(n, seed=1, seconds=seconds)):
        utt = f"{100 + i}-0-0000_{200 + i}-0-0000_spk1"
        wav[utt] = os.path.join(root, "wavs", f"{utt}.wav")
        enroll[utt] = os.path.join(root, "wavs", f"{utt}_enroll.wav")
        kaldi_io.write_wav(wav[utt], speech)
        kaldi_io.write_wav(enroll[utt], enr)
        text[utt] = ENTRY_REFS[i % len(ENTRY_REFS)]
        utt2spk[utt] = str(100 + i)
    for name, rows in (("wav.scp", wav), ("text", text), ("utt2spk", utt2spk),
                       ("enroll.scp", enroll)):
        kaldi_io.write_scp(os.path.join(root, "data", name), rows)
    return os.path.join(root, "data"), wav, enroll


def serve_requests(port: int, wavs, enrolls):
    """Every (speech, enrollment) WAV pair POSTed at once to /v1/transcribe
    as base64 bodies; returns the responses in order."""
    import base64
    import threading
    import urllib.request

    def body(path):
        with open(path, "rb") as f:
            return base64.b64encode(f.read()).decode()

    out = [None] * len(wavs)

    def post(i):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/transcribe",
            data=json.dumps({"speech_wav": body(wavs[i]), "enroll_wav": body(enrolls[i])}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=300) as resp:
            out[i] = json.loads(resp.read())

    threads = [threading.Thread(target=post, args=(i,)) for i in range(len(wavs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if any(o is None for o in out):
        raise AssertionError("a request got no answer")
    return out


def get_json(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return json.loads(resp.read())


class TokenIds:
    """A tokenizer whose text is the token ids; ``encode`` is ``inner``'s."""

    def __init__(self, inner=None):
        self.inner = inner

    def encode(self, text):
        return self.inner.encode(text)

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)


def run_entry_points(torch, dev):
    """Phase 4b: the entry points a user runs, at Whisper-medium. A Kaldi
    data dir of 8 utterances and a lora-mode checkpoint of the medium
    config (seeded init) are written to a temporary directory; then
    ``cli.decode.main`` decodes the dir greedy and at beam 5 (int4 cross
    K/V, 32 new tokens, batch 4) from that checkpoint, and its hypotheses
    must equal ``decode_dataset`` over the same weights in memory; then the
    ``cli.serve`` engine answers 8 concurrent HTTP requests, each with
    ``engine.transcribe``'s text for its pair. ``load_tokenizer`` is patched
    for the phase to give texts of token ids: random weights rarely emit an
    id the mini ranks hold, so BPE texts would be empty and compare
    nothing. Returns {path: launches}."""
    import shutil
    import tempfile
    import threading

    from robustsq_whisper_torch.cli import decode as cli_decode
    from robustsq_whisper_torch.cli import serve as cli_serve
    from robustsq_whisper_torch.cli.train import build_model
    from robustsq_whisper_torch.data import kaldi_io
    from robustsq_whisper_torch.decode.pipeline import decode_dataset
    from robustsq_whisper_torch.serve import audio_from_bytes, make_server
    from robustsq_whisper_torch.tokenizer import whisper_tokenizer
    from robustsq_whisper_torch.train import create_train_state
    from robustsq_whisper_torch.train.checkpoint import (
        restore_serving_variables, save_checkpoint,
    )
    from robustsq_whisper_torch.train.lora import merge_lora
    from robustsq_whisper_torch.utils.config import load_experiment

    root = tempfile.mkdtemp(prefix="entry_points_")
    load_tokenizer = whisper_tokenizer.load_tokenizer
    whisper_tokenizer.load_tokenizer = lambda assets: TokenIds(load_tokenizer(assets))
    launches, report = {}, {}
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        data_dir, wavs, enrolls = write_data_dir(root, 8)
        exp = load_experiment(ENTRY_CONFIG)
        model = build_model(exp, seed=0, device=dev)
        state = create_train_state(model, exp.train, device=dev)
        # b starts at 0, where the merge is the identity: seed it nonzero
        gen = torch.Generator().manual_seed(2)
        with torch.no_grad():
            for _, b in state.lora.values():
                b.copy_(torch.randn(b.shape, generator=gen) * 0.02)
        t1 = time.perf_counter()
        save_checkpoint(os.path.join(root, "exp", "checkpoints"), 0, state, epoch=0)
        log(f"entry points: data dir and medium {exp.train.mode} model {t1 - t0:.1f} s, "
            f"checkpoint saved {time.perf_counter() - t1:.1f} s")

        # the in-memory weights as the serving restore makes them: each f32
        # parameter and factor cast to bf16 on the host, the factors merged
        def host_bf16(t):
            t = t.detach().cpu()
            return t.to(torch.bfloat16) if t.dtype == torch.float32 else t

        params = {n: host_bf16(p) for n, p in model.named_parameters()}
        memory_sd = merge_lora(
            params, {n: (host_bf16(a), host_bf16(b)) for n, (a, b) in state.lora.items()},
            exp.train.lora)
        unmerged = [n for n in state.lora if torch.equal(memory_sd[n], params[n])]
        if not state.lora or unmerged:
            raise AssertionError(f"{len(state.lora)} LoRA targets; the merge left "
                                 f"{len(unmerged)} of them as they were: {unmerged[:3]}")
        persistent = set(model.state_dict())
        memory_sd.update({n: b.detach().cpu() for n, b in model.named_buffers()
                          if n in persistent})
        del state, model, params
        torch.cuda.empty_cache()
        restored, _, _ = restore_serving_variables(
            os.path.join(root, "exp", "checkpoints"), torch.bfloat16, exp.train)
        differ = [k for k, v in memory_sd.items() if k not in restored
                  or restored[k].dtype != v.dtype or not torch.equal(restored[k], v)]
        if differ or restored.keys() != memory_sd.keys():
            raise AssertionError(f"the serving restore differs from the in-memory weights: "
                                 f"{differ[:3]}")
        log(f"entry points: the serving restore equals merge_lora of the in-memory weights, "
            f"{len(restored)} tensors")
        del restored

        argvs = {}
        for path, (beam, expect) in ENTRY_PATHS.items():
            inf = os.path.join(root, f"decode_beam{beam}.yaml")
            with open(inf, "w") as f:
                f.write(f"decode_conf:\n  beam_size: {beam}\n  max_new_tokens: 32\n"
                        "  quantize_cross_kv: true\n")
            out = os.path.join(root, f"decode_beam{beam}")
            argv = ["--config", ENTRY_CONFIG, "--inference_config", inf, "--data_dir", data_dir,
                    "--expdir", os.path.join(root, "exp"), "--output_dir", out,
                    "--cross_kv_bits", "4", "--batch_size", "4",
                    "--tokenizer_assets", ENTRY_RANKS, "--device", str(dev)]
            argvs[path] = (argv, out)
            rc, wall, counts = counted(torch, lambda: cli_decode.main(argv))
            launches[path] = counts
            hyps = kaldi_io.read_scp(os.path.join(out, "text"))
            with open(os.path.join(out, "score.txt")) as f:
                scores = dict(line.split() for line in f)
            log(f"{path}: rc {rc}, main {wall:.2f} s, RTF {float(scores['rtf']):.2f} "
                f"(decode loop), wer {scores.get('wer')} cer {scores.get('cer')} (of texts "
                f"of token ids); launches {counts}")
            missing = [n for n in expect if counts[n] == 0]
            if rc != 0 or missing:
                raise AssertionError(f"{path}: rc {rc}, kernels not launched: {missing}")
            if len(hyps) != 8 or not {"wer", "cer", "rtf"} <= scores.keys():
                raise AssertionError(f"{path}: {len(hyps)} hypotheses, score keys {sorted(scores)}")
            if not any(hyps.values()):
                raise AssertionError(f"{path}: every hypothesis is empty, so the comparison "
                                     f"below would hold no tokens")
            d = cli_decode.prepare(argv)
            enc, dec = d.modules(memory_sd)
            ref = decode_dataset(enc, dec, d.dataset, d.tokenizer, d.dcfg, batch_size=4,
                                 output_dir=out + "_in_memory", device=dev)
            del enc, dec
            with open(os.path.join(out, "text"), "rb") as f, \
                    open(os.path.join(out + "_in_memory", "text"), "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"{path}: hypotheses from the checkpoint differ from "
                                         f"the in-memory model's: {hyps} vs {ref.hyps}")
            report[path] = {"main_s": wall, "rtf": float(scores["rtf"]),
                            "decode_s": ref.wall_seconds}
        log("entry points: cli.decode hypotheses from the checkpoint equal the in-memory "
            "model's, greedy and beam 5")
        launches.update(run_torchrun_decode(torch, *argvs["cli.decode greedy"]))

        args = cli_serve.parse_args([
            "--config", ENTRY_CONFIG, "--inference_config", os.path.join(root, "decode_beam1.yaml"),
            "--expdir", os.path.join(root, "exp"), "--batch_size", "4", "--max_wait_ms", "15",
            "--cross_kv_bits", "4", "--tokenizer_assets", ENTRY_RANKS, "--device", str(dev),
        ])
        engine, info = cli_serve.build_engine(args)
        engine.warmup()
        server, batcher = make_server(engine, "127.0.0.1", 0, args.max_wait_ms, info=info)
        port = server.server_address[1]
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            answers, wall, counts = counted(torch, lambda: serve_requests(port, list(wavs.values()),
                                                                          list(enrolls.values())))
            launches["cli.serve"] = counts
            health, stats = get_json(port, "/healthz"), get_json(port, "/stats")
        finally:
            server.shutdown()
            batcher.close()
            server.server_close()
            thread.join(timeout=30)
        for (utt, w), e, a in zip(wavs.items(), enrolls.values(), answers):
            with open(w, "rb") as f, open(e, "rb") as g:
                pair = (audio_from_bytes(f.read()), audio_from_bytes(g.read()))
            want = engine.transcribe([pair])[0]
            if a["text"] != want:
                raise AssertionError(f"cli.serve {utt}: {a['text']!r} != engine {want!r}")
        if not any(a["text"] for a in answers):
            raise AssertionError("cli.serve: every text is empty, so the comparison held no tokens")
        lat = sorted(a["latency_ms"] for a in answers)
        report["cli.serve"] = {"wall_s": wall, "p50_ms": statistics.median(lat),
                               "max_ms": lat[-1], "batches": stats["batches"]}
        log(f"cli.serve: 8 concurrent requests in {wall:.2f} s, latency p50 "
            f"{statistics.median(lat):.1f} ms max {lat[-1]:.1f} ms, batches {stats['batches']}, "
            f"texts equal engine.transcribe; healthz {health['status']} compiled "
            f"{health['compiled']}; stats {stats}; launches {counts}")
        missing = [n for n in GREEDY_KERNELS if counts[n] == 0]
        if missing or health["status"] != "ok" or stats["requests"] != 8 or stats["errors"]:
            raise AssertionError(f"cli.serve: kernels not launched {missing}, health {health}, "
                                 f"stats {stats}")
        del engine
        torch.cuda.empty_cache()
        report["phase_s"] = time.perf_counter() - t_phase
        log(f"entry points on {gpu_info()}: {json.dumps(report)}")
        launches.update(run_remaining_paths(torch, dev, root, data_dir, wavs, enrolls, memory_sd))
        launches.update(run_w8a8_entry_points(torch, dev, root, data_dir, wavs, enrolls))
    finally:
        whisper_tokenizer.load_tokenizer = load_tokenizer
        shutil.rmtree(root, ignore_errors=True)
    return launches


SPEC_KERNELS = ("decode_cross_attention", "flash_attention_tmaj")  # the 5-D cache is plain
EXTRA_PATHS = {  # phase 4d: path -> kernels it must launch
    # cli.distill's encoder takes the config's flash route (use_flash_attention
    # without flash_tmaj: the row-major forward kernel); its teacher decode
    # runs the dense cross K/V over the 5-D cache and the training plain
    "cli.distill": ("flash_attention",),
    "cli.decode --draft_path": SPEC_KERNELS,
    "cli.decode self-draft": SPEC_KERNELS,
    "cli.serve --draft_path": SPEC_KERNELS,
    # joint decode is dense (no cross kernel) and reorders by index_select
    "cli.decode --ctc_weight 0.3": ("decode_self_attention", "flash_attention_tmaj"),
    "cli.decode --timestamps": GREEDY_KERNELS,
    "cli.decode --long_audio": GREEDY_KERNELS,
}


def run_remaining_paths(torch, dev, root, data_dir, wavs, enrolls, memory_sd):
    """Phase 4d: the remaining decode paths through the entry points, over
    phase 4b's data dir, lora checkpoint and inference yamls (token-id
    texts): ``cli.distill`` (a 1-layer draft, 50 steps at batch 8 over the
    8 utterances), ``cli.decode --speculative_gamma 10 --draft_path`` (text
    byte-identical to ``decode_dataset`` with the same draft in memory; the
    acceptance printed beside the 1-layer self-draft's; speculative against
    5-D greedy tokens, exact with the decoder in f32, the share printed in
    bf16), ``cli.serve --draft_path`` (4 requests, each equal to
    ``engine.transcribe``), ``cli.decode --ctc_weight 0.3`` at beam 5,
    ``cli.decode --timestamps true`` and ``cli.decode --long_audio true``
    over a second dir of 4 utterances of 75 s (three windows each). Each
    run's launch counts are set to 0 just before it and read after it.
    Returns {path: launches}."""
    import threading

    from robustsq_whisper_torch.cli import decode as cli_decode
    from robustsq_whisper_torch.cli import distill as cli_distill
    from robustsq_whisper_torch.cli import serve as cli_serve
    from robustsq_whisper_torch.data import kaldi_io
    from robustsq_whisper_torch.decode.pipeline import build_decode_fns, decode_dataset
    from robustsq_whisper_torch.decode.search import build_beam_decoder, strip_eot
    from robustsq_whisper_torch.decode.speculative import build_speculative_decoder
    from robustsq_whisper_torch.serve import audio_from_bytes, make_server
    from robustsq_whisper_torch.train import distill as distill_mod

    t_phase = time.perf_counter()
    launches, report = {}, {}
    info = gpu_info()
    exp_dir, draft_dir = os.path.join(root, "exp"), os.path.join(root, "draft")

    def argv(beam, out, *extra, data=data_dir):
        return ["--config", ENTRY_CONFIG, "--inference_config",
                os.path.join(root, f"decode_beam{beam}.yaml"), "--data_dir", data,
                "--expdir", exp_dir, "--output_dir", out, "--cross_kv_bits", "4",
                "--batch_size", "4", "--tokenizer_assets", ENTRY_RANKS, "--device", str(dev),
                *extra]

    def expect(path, counts, rc=0):
        launches[path] = counts
        missing = [n for n in EXTRA_PATHS[path] if counts[n] == 0]
        if rc != 0 or missing:
            raise AssertionError(f"{path}: rc {rc}, kernels not launched: {missing}")

    def decode_cli(path, args, n_utts):
        rc, wall, counts = counted(torch, lambda: cli_decode.main(args))
        out = args[args.index("--output_dir") + 1]
        hyps = kaldi_io.read_scp(os.path.join(out, "text"))
        with open(os.path.join(out, "score.txt")) as f:
            scores = {k: float(v) for k, v in (line.split() for line in f)}
        log(f"{path} on {info}: rc {rc}, main {wall:.2f} s, RTF {scores['rtf']:.2f} (decode "
            f"loop); scores {scores}; launches {counts}")
        expect(path, counts, rc)
        if len(hyps) != n_utts or not any(hyps.values()) or not {"wer", "cer"} <= scores.keys():
            raise AssertionError(f"{path}: {len(hyps)} hypotheses, scores {scores}")
        report[path] = {"main_s": wall, "rtf": scores["rtf"]}
        return hyps, scores, out

    # cli.distill, the draft's training timed inside the entry point
    timed = {}
    inner = distill_mod.distill_draft

    def timed_distill(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        timed.update(wall=time.perf_counter() - t0, **out[1])
        return out

    distill_mod.distill_draft = timed_distill
    try:
        rc, wall, counts = counted(torch, lambda: cli_distill.main([
            "--config", ENTRY_CONFIG, "--expdir", exp_dir, "--data_dir", data_dir,
            "--out", draft_dir, "--tokenizer_assets", ENTRY_RANKS, "--draft_layers", "1",
            "--steps", "50", "--batch_size", "8", "--max_items", "8", "--max_new_tokens", "32",
            "--device", str(dev)]))
    finally:
        distill_mod.distill_draft = inner
    expect("cli.distill", counts, rc)
    with open(os.path.join(draft_dir, "meta.json")) as f:
        meta = json.load(f)
    steps_s = timed["steps"] / timed["wall"]
    log(f"cli.distill on {info}: main {wall:.2f} s, 50 steps at batch 8 in "
        f"{timed['wall']:.2f} s ({steps_s:.2f} steps/s, with the end-of-run agreement "
        f"pass), final_loss {timed['final_loss']}, final_agreement "
        f"{timed['final_agreement']}; meta {meta}; launches {counts}")
    if meta["corpus_items"] != 8 or not 0.0 <= meta["final_agreement"] <= 1.0:
        raise AssertionError(f"cli.distill meta {meta}")
    report["cli.distill"] = {"main_s": wall, "steps_per_s": steps_s,
                             "final_agreement": timed["final_agreement"]}

    # speculative decode with the distilled draft, and with a 1-layer self-draft
    spec = ("--speculative_gamma", "10")
    d_args = argv(1, os.path.join(root, "spec_draft"), *spec, "--draft_path", draft_dir)
    _, d_scores, d_out = decode_cli("cli.decode --draft_path", d_args, 8)
    _, s_scores, _ = decode_cli("cli.decode self-draft", argv(
        1, os.path.join(root, "spec_self"), *spec, "--draft_layers", "1"), 8)
    acc = lambda sc: {k: sc[k] for k in ("spec_acceptance_rate", "spec_tokens_per_chunk",
                                         "spec_chunks")}
    log(f"draft acceptance at medium on {info} (gamma 10, seeded random weights): distilled "
        f"1-layer draft {acc(d_scores)}; 1-layer self-draft {acc(s_scores)}")
    report["acceptance"] = {"distilled": acc(d_scores), "self": acc(s_scores)}
    d = cli_decode.prepare(d_args)
    enc, dec = d.modules(memory_sd)
    draft = d.draft(dec)
    decode_dataset(enc, dec, d.dataset, d.tokenizer, d.dcfg, batch_size=4,
                   output_dir=d_out + "_in_memory", device=dev, draft=draft)
    with open(os.path.join(d_out, "text"), "rb") as f, \
            open(os.path.join(d_out + "_in_memory", "text"), "rb") as g:
        if f.read() != g.read():
            raise AssertionError("--draft_path hypotheses differ from decode_dataset's with the "
                                 "draft in memory")
    # speculative with the draft against 5-D greedy on one encoder batch
    encode, _ = build_decode_fns(enc, dec, d.dcfg, device=dev, draft=draft)
    batch = next(d.dataset.batches(4, shuffle=False, drop_last=False))
    from robustsq_whisper_torch.audio.frontend import log_mel_spectrogram, pcm16_to_float, to_pcm16

    def mel(wave, lens):
        x = pcm16_to_float(torch.from_numpy(to_pcm16(wave)).to(dev))
        return log_mel_spectrogram(x, torch.from_numpy(lens).to(dev), n_mels=enc.dims.n_mels)

    with torch.inference_mode():
        memory, prompt = encode(*mel(batch["speech"], batch["speech_lens"]),
                                *mel(batch["enroll"], batch["enroll_lens"]))
    greedy_cfg = dataclasses.replace(d.dcfg, speculative_gamma=0)
    for name, (t, dr) in (("bf16", (dec, draft)),
                          ("f32", (copy.deepcopy(dec).float(), copy.deepcopy(draft).float()))):
        g_tok, _ = build_beam_decoder(t, greedy_cfg, dev)(memory, prompt)
        s_tok, _, st = build_speculative_decoder(t, d.dcfg, dev, return_stats=True,
                                                 draft=dr)(memory, prompt)
        share = (g_tok == s_tok).float().mean().item()
        log(f"distilled-draft speculative vs 5-D greedy at medium, decoder {name}: identical "
            f"token share {share:.4f}; greedy tokens per row "
            f"{[len(r) for r in strip_eot(g_tok.cpu().tolist(), d.dcfg.eot)]}; counters "
            f"{ {k: v.tolist() for k, v in st.items()} }")
        if name == "f32" and not torch.equal(g_tok, s_tok):
            raise AssertionError("f32 speculative tokens with the distilled draft differ from "
                                 "the 5-D greedy's")
        del t, dr
    del enc, dec, draft, d, memory, prompt
    torch.cuda.empty_cache()

    # cli.serve with the draft
    args = cli_serve.parse_args([
        "--config", ENTRY_CONFIG, "--inference_config", os.path.join(root, "decode_beam1.yaml"),
        "--expdir", exp_dir, "--batch_size", "4", "--max_wait_ms", "15", "--cross_kv_bits", "4",
        "--tokenizer_assets", ENTRY_RANKS, "--device", str(dev), *spec,
        "--draft_path", draft_dir,
    ])
    engine, serve_info = cli_serve.build_engine(args)
    engine.warmup()
    server, batcher = make_server(engine, "127.0.0.1", 0, args.max_wait_ms, info=serve_info)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    pairs = list(zip(list(wavs.values())[:4], list(enrolls.values())[:4]))
    try:
        answers, wall, counts = counted(torch, lambda: serve_requests(
            server.server_address[1], [w for w, _ in pairs], [e for _, e in pairs]))
    finally:
        server.shutdown()
        batcher.close()
        server.server_close()
        thread.join(timeout=30)
    for (w, e), a in zip(pairs, answers):
        with open(w, "rb") as f, open(e, "rb") as g:
            want = engine.transcribe([(audio_from_bytes(f.read()), audio_from_bytes(g.read()))])[0]
        if a["text"] != want:
            raise AssertionError(f"cli.serve --draft_path: {a['text']!r} != engine {want!r}")
    if not any(a["text"] for a in answers):
        raise AssertionError("cli.serve --draft_path: every text is empty")
    lat = sorted(a["latency_ms"] for a in answers)
    log(f"cli.serve --draft_path on {info}: 4 requests in {wall:.2f} s, latency p50 "
        f"{statistics.median(lat):.1f} ms max {lat[-1]:.1f} ms, texts equal "
        f"engine.transcribe; launches {counts}")
    expect("cli.serve --draft_path", counts)
    report["cli.serve --draft_path"] = {"wall_s": wall, "p50_ms": statistics.median(lat)}
    del engine
    torch.cuda.empty_cache()

    decode_cli("cli.decode --ctc_weight 0.3", argv(5, os.path.join(root, "ctc"), "--ctc_weight",
                                                   "0.3"), 8)
    _, _, ts_out = decode_cli("cli.decode --timestamps", argv(
        1, os.path.join(root, "timestamps"), "--timestamps", "true"), 8)
    if not os.path.exists(os.path.join(ts_out, "segments")):
        raise AssertionError("--timestamps wrote no segments file")
    with open(os.path.join(ts_out, "segments")) as f:
        log(f"--timestamps: {len(f.readlines())} segments over 8 utterances")
    long_dir, _, _ = write_data_dir(os.path.join(root, "long"), 4, seconds=75.0)
    decode_cli("cli.decode --long_audio", argv(
        1, os.path.join(root, "long_out"), "--long_audio", "true", data=long_dir), 4)
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"remaining decode paths on {info}: {json.dumps(report)}")
    return launches


TRAIN_ENTRY_KERNELS = {  # path: kernels it must launch
    "cli.train": ("flash_attention", "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                  "flash_attention_tmaj", "decode_cross_attention", "decode_self_attention"),
    "cli.decode --use_ave": GREEDY_KERNELS,
}


# OpenAI whisper names -> the port's ``TSASRModel`` names, written here
# from the two layouts and not from ``models/whisper/load.py``, so that a
# fault of the loader's maps shows: a name keeps its path below the Whisper
# submodule but for the MLP's two linears
OPENAI_PREFIX = {"encoder.": "encoder.encoder.", "decoder.": "decoder.decoder."}
OPENAI_RENAME = {".mlp.0.": ".mlp_fc1.", ".mlp.2.": ".mlp_fc2."}
OPENAI_COMPUTED = ("encoder.positional_embedding",)  # a sinusoid buffer of the port


def openai_to_port(file_sd):
    """{port name: f32 tensor} of an OpenAI whisper state dict."""
    out = {}
    for name, t in file_sd.items():
        if name in OPENAI_COMPUTED:
            continue
        head = next(p for p in OPENAI_PREFIX if name.startswith(p))
        port = OPENAI_PREFIX[head] + name[len(head):]
        for a, b in OPENAI_RENAME.items():
            port = port.replace(a, b)
        out[port] = t.float()
    return out


def write_openai_pt(torch, path: str, dims, dev):
    """A synthetic OpenAI whisper ``.pt`` of ``dims``: the ``whisper.load_model``
    key layout and ``dims`` dict, fp16 weights drawn on the card from a seed
    (linear and conv weights N(0, 1/fan_in), embeddings N(0, 1/width), norms
    near 1, biases near 0)."""
    g = torch.Generator(dev).manual_seed(3)
    sd = {}

    def w(name, *shape, std=None, mean=0.0):
        if std is None:
            std = (shape[1] * (shape[2] if len(shape) == 3 else 1)) ** -0.5
        t = torch.randn(shape, generator=g, device=dev) * std + mean
        sd[name] = t.half().cpu()

    def lin(name, n_out, n_in, bias=True):
        w(f"{name}.weight", n_out, n_in)
        if bias:
            w(f"{name}.bias", n_out, std=0.01)

    def ln(name, n):
        w(f"{name}.weight", n, std=0.01, mean=1.0)
        w(f"{name}.bias", n, std=0.01)

    def block(p, n, cross):
        for attn in ("attn", "cross_attn") if cross else ("attn",):
            for m in ("query", "value", "out"):
                lin(f"{p}.{attn}.{m}", n, n)
            lin(f"{p}.{attn}.key", n, n, bias=False)
            ln(f"{p}.{attn}_ln", n)
        lin(f"{p}.mlp.0", 4 * n, n)
        lin(f"{p}.mlp.2", n, 4 * n)
        ln(f"{p}.mlp_ln", n)

    d, td = dims.n_audio_state, dims.n_text_state
    w("encoder.conv1.weight", d, dims.n_mels, 3)
    w("encoder.conv1.bias", d, std=0.01)
    w("encoder.conv2.weight", d, d, 3)
    w("encoder.conv2.bias", d, std=0.01)
    w("encoder.positional_embedding", dims.n_audio_ctx, d, std=0.02)
    for i in range(dims.n_audio_layer):
        block(f"encoder.blocks.{i}", d, cross=False)
    ln("encoder.ln_post", d)
    w("decoder.token_embedding.weight", dims.n_vocab, td, std=td ** -0.5)
    w("decoder.positional_embedding", dims.n_text_ctx, td, std=0.02)
    for i in range(dims.n_text_layer):
        block(f"decoder.blocks.{i}", td, cross=True)
    ln("decoder.ln", td)
    torch.save({"dims": dataclasses.asdict(dims), "model_state_dict": sd}, path)
    return sd


def averaged_payload(torch, ckpt_dir: str, steps):
    """The mean of the checkpoints at ``steps``, computed here: each f32
    master and LoRA factor in float64 and cast back, each parameter with a
    master that mean in its dtype, every other parameter (frozen: the same
    in every checkpoint, checked) as stored. Returns (params, masters by
    name, lora)."""
    from robustsq_whisper_torch.train.checkpoint import read_payload

    raws = [read_payload(ckpt_dir, s)[0] for s in sorted(steps)]
    names = raws[0]["opt"]["names"]

    def mean(xs):
        return (sum(x.double() for x in xs) / len(xs)).float()

    masters = {n: mean([r["opt"]["masters"][i] for r in raws])
               for i, n in enumerate(names) if raws[0]["opt"]["masters"][i] is not None}
    params = {}
    for n, p in raws[0]["params"].items():
        if n in masters:
            params[n] = masters[n].to(p.dtype)
        elif n in names:  # an f32 trainable parameter: its own master
            params[n] = mean([r["params"][n] for r in raws])
        else:
            if not all(torch.equal(r["params"][n], p) for r in raws[1:]):
                raise AssertionError(f"the frozen {n} changed between checkpoints")
            params[n] = p
    lora = {n: [mean([r["lora"][n][k] for r in raws]) for k in (0, 1)] for n in raws[0]["lora"]}
    return params, masters, lora, raws[0]["buffers"]


def check_average(torch, ckpt_dir: str, steps):
    """The ``ave`` checkpoint holds ``averaged_payload``'s masters, factors
    and parameters, tensor for tensor; returns that mean."""
    from robustsq_whisper_torch.train.checkpoint import read_payload
    from robustsq_whisper_torch.train.eval import AVE_SUBDIR

    params, masters, lora, buffers = averaged_payload(torch, ckpt_dir, steps)
    ave, ave_step = read_payload(os.path.join(ckpt_dir, AVE_SUBDIR))
    names = ave["opt"]["names"]
    got_masters = {names[i]: m for i, m in enumerate(ave["opt"]["masters"]) if m is not None}
    differ = [n for n in params if not torch.equal(ave["params"][n], params[n])]
    differ += [n for n in masters if not torch.equal(got_masters[n], masters[n])]
    differ += [n for n in lora if not all(torch.equal(ave["lora"][n][k], lora[n][k])
                                          for k in (0, 1))]
    if ave_step != len(steps) or differ or ave["params"].keys() != params.keys():
        raise AssertionError(f"the ave checkpoint (step {ave_step}) is not the mean of steps "
                             f"{steps}: {differ[:4]}")
    return params, lora, buffers


def run_train_entry(torch, dev):
    """Phase 4c: the training entry point at Whisper-medium. A train dir of
    24 and a valid dir of 8 synthetic (30 s, 10 s) WAV pairs, a synthetic
    OpenAI-format medium.en ``.pt`` (fp16, 51864 tokens: the medium lora
    config's 51865 adds one row) and a copy of that config capping
    ``max_new_tokens`` at 32 with the cross K/V quantized, to int8 (the
    cross kernel's int8 layout: ``TSDecoder``'s and ``cli.decode``'s
    default width, which nothing here changes). ``cli.train.main``
    warm-starts from the file and trains 2 epochs of 3 steps at batch 8
    with the validation pass, the valid WER on 8 utterances and n-best 2;
    the frozen backbone must be the file's after the bf16 cast (the added
    row ``adapt_vocab``'s, drawn again here), the ``ave`` checkpoint the
    mean of the n-best checkpoints' masters and factors, every batch read
    by the native reader, every logged stat finite. A second ``main`` with
    3 epochs resumes at step 6 and ends at step 9; then ``cli.decode
    --use_ave`` decodes the valid dir, token for token as
    ``decode_dataset`` over the mean computed here. Returns ({path:
    launches}, audio-s trained per GPU-s)."""
    import shutil
    import tempfile

    from robustsq_whisper_torch.cli import decode as cli_decode
    from robustsq_whisper_torch.cli import train as cli_train
    from robustsq_whisper_torch.data import dataset as data_dataset
    from robustsq_whisper_torch.decode.pipeline import decode_dataset
    from robustsq_whisper_torch.models import whisper_dims
    from robustsq_whisper_torch.tokenizer import whisper_tokenizer
    from robustsq_whisper_torch.train.lora import merge_lora
    from robustsq_whisper_torch.utils.config import load_experiment

    root = tempfile.mkdtemp(prefix="train_entry_")
    load_tokenizer = whisper_tokenizer.load_tokenizer
    whisper_tokenizer.load_tokenizer = lambda assets: TokenIds(load_tokenizer(assets))
    launches, report = {}, {}
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        train_dir = write_data_dir(os.path.join(root, "train"), 24)[0]
        valid_dir = write_data_dir(os.path.join(root, "valid"), 8)[0]
        config = os.path.join(root, "lora.yaml")
        with open(ENTRY_CONFIG) as f, open(config, "w") as g:
            g.write(f.read() + "decode_conf:\n  max_new_tokens: 32\n  quantize_cross_kv: true\n")
        exp = load_experiment(config)
        pt = os.path.join(root, "medium.en.pt")
        file_dims = whisper_dims("medium").replace(n_vocab=exp.model.vocab_size - 1)
        file_sd = write_openai_pt(torch, pt, file_dims, dev)
        report["setup_s"] = time.perf_counter() - t0
        expdir = os.path.join(root, "exp")
        ckpt = os.path.join(expdir, "checkpoints")
        argv = ["--config", config, "--train_dir", train_dir, "--valid_dir", valid_dir,
                "--expdir", expdir, "--pretrained", pt, "--batch_size", "8", "--nbest", "2",
                "--valid_wer_utts", "8", "--ckpt_every_steps", "0", "--log_every", "1",
                "--tokenizer_assets", ENTRY_RANKS, "--device", str(dev)]
        records = []

        def hook(step, values):
            records.append((step, dict(values)))

        data_dataset.BATCH_READS.clear()
        torch.cuda.reset_peak_memory_stats(dev)
        rc, wall, counts = counted(
            torch, lambda: cli_train.main(argv + ["--num_epochs", "2"], metrics_hook=hook))
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        launches["cli.train"] = counts
        seconds = records[-1][1]
        steps = [s for s, v in records if "loss" in v]
        valid = [v for _, v in records if "valid.acc" in v]
        reads = dict(data_dataset.BATCH_READS)
        # 1 batch read before the model is built, then per epoch 3 training
        # batches, the validation pass and the valid-WER pass (8 each)
        if rc != 0 or steps != [1, 2, 3, 4, 5, 6] or len(valid) != 2:
            raise AssertionError(f"cli.train: rc {rc}, steps {steps}, {len(valid)} valid passes")
        if reads != {"native": 11}:
            raise AssertionError(f"cli.train: batches read {reads}, want 11 by the native reader")
        bad = [(s, k) for s, v in records for k, x in v.items() if not np.isfinite(x)]
        if bad or not all("valid.wer" in v for v in valid):
            raise AssertionError(f"cli.train: non-finite stats {bad[:4]} or no valid WER")
        rate = 6 * 8 * 30 / seconds["seconds.train"]
        report["cli.train"] = {
            "main_s": wall, "steps_per_s": 6 / seconds["seconds.train"],
            "audio_s_per_gpu_s": rate, "peak_gib": peak,
            **{k.split(".")[1] + "_s": v for k, v in seconds.items()},
            "valid": {k: round(v, 4) for k, v in valid[-1].items()},
        }
        log(f"cli.train lora medium: rc {rc}, main {wall:.1f} s, 6 steps at batch 8 in "
            f"{seconds['seconds.train']:.2f} s of training wall ({6 / seconds['seconds.train']:.2f} "
            f"steps/s, {rate:.2f} audio-s per GPU-s), validation {seconds['seconds.valid']:.2f} s, "
            f"valid WER {seconds['seconds.valid_wer']:.2f} s, checkpoint saves "
            f"{seconds['seconds.save']:.2f} s, averaging {seconds['seconds.average']:.2f} s, peak "
            f"memory {peak:.2f} GiB; batches read {reads}; launches {counts}")
        missing = [n for n in TRAIN_ENTRY_KERNELS["cli.train"] if counts[n] == 0]
        if missing:
            raise AssertionError(f"cli.train: kernels not launched: {missing}")

        with open(os.path.join(ckpt, "nbest.json")) as f:
            nbest = [e["step"] for e in json.load(f)["entries"]]
        if sorted(nbest) != [3, 6]:
            raise AssertionError(f"cli.train: nbest.json names {nbest}, want steps 3 and 6")
        t0 = time.perf_counter()
        params, _, _ = check_average(torch, ckpt, nbest)
        # the warm start: the frozen Whisper weights are the file's, cast,
        # each found by its OpenAI name through this script's own table
        want = openai_to_port(file_sd)
        emb = want["decoder.decoder.token_embedding.weight"].numpy()
        row = np.random.default_rng(0).normal(float(emb.mean()), float(emb.std()), (1, emb.shape[1]))
        want["decoder.decoder.token_embedding.weight"] = torch.cat(
            [want["decoder.decoder.token_embedding.weight"], torch.from_numpy(row.astype(np.float32))])
        whisper = {k for k in params if k.startswith(("encoder.encoder.", "decoder.decoder."))}
        if want.keys() != whisper:
            raise AssertionError(f"cli.train --pretrained: the file's names map onto "
                                 f"{sorted(want.keys() ^ whisper)[:4]} that the model lacks or "
                                 f"does not take from it")
        differ = [k for k, v in want.items() if not torch.equal(params[k], v.float().to(params[k].dtype))]
        if differ:
            raise AssertionError(f"cli.train --pretrained: {len(differ)} weights differ from the "
                                 f"file's: {differ[:4]}")
        log(f"cli.train: nbest.json names steps {nbest}; the ave checkpoint is their mean "
            f"(masters, factors and parameters); the {len(want)} Whisper weights are the file's "
            f"after the cast, the added token row adapt_vocab's ({time.perf_counter() - t0:.1f} s "
            f"of checks)")
        del params

        records.clear()
        rc, wall, _ = counted(
            torch, lambda: cli_train.main(argv + ["--num_epochs", "3"], metrics_hook=hook))
        steps = [s for s, v in records if "loss" in v]
        if rc != 0 or steps != [7, 8, 9]:
            raise AssertionError(f"cli.train resume: rc {rc}, steps {steps}, want 7 to 9")
        seconds = records[-1][1]
        report["cli.train resume"] = {"main_s": wall, "restore_s": seconds["seconds.restore"],
                                      "save_s": seconds["seconds.save"],
                                      "average_s": seconds["seconds.average"]}
        log(f"cli.train resume: rc {rc}, main {wall:.1f} s, restore "
            f"{seconds['seconds.restore']:.2f} s, steps {steps}")
        with open(os.path.join(ckpt, "nbest.json")) as f:
            nbest = [e["step"] for e in json.load(f)["entries"]]
        params, lora, buffers = check_average(torch, ckpt, nbest)

        # the serving weights cli.decode makes of the mean: every f32
        # parameter and factor cast to bf16, the factors merged
        def bf16(t):
            return t.to(torch.bfloat16) if t.dtype == torch.float32 else t

        memory_sd = merge_lora({n: bf16(p) for n, p in params.items()},
                               {n: (bf16(a), bf16(b)) for n, (a, b) in lora.items()},
                               exp.train.lora)
        memory_sd.update(buffers)
        out = os.path.join(root, "decode_ave")
        dargv = ["--config", config, "--data_dir", valid_dir, "--expdir", expdir,
                 "--output_dir", out, "--batch_size", "8", "--tokenizer_assets", ENTRY_RANKS,
                 "--device", str(dev)]
        rc, wall, counts = counted(torch, lambda: cli_decode.main(dargv))
        launches["cli.decode --use_ave"] = counts
        d = cli_decode.prepare(dargv)
        enc, dec = d.modules(memory_sd)
        decode_dataset(enc, dec, d.dataset, d.tokenizer, d.dcfg, batch_size=8,
                       output_dir=out + "_in_memory", device=dev)
        del enc, dec, memory_sd, params
        with open(os.path.join(out, "text"), "rb") as f, \
                open(os.path.join(out + "_in_memory", "text"), "rb") as g:
            text, ref = f.read(), g.read()
        missing = [n for n in TRAIN_ENTRY_KERNELS["cli.decode --use_ave"] if counts[n] == 0]
        if rc != 0 or text != ref or text.count(b"\n") != 8 or missing:
            raise AssertionError(f"cli.decode --use_ave: rc {rc}, kernels not launched "
                                 f"{missing}, hypotheses equal the in-memory mean's: {text == ref}")
        # each line is "utt id tok tok ...": the texts are token ids
        n_tokens = sum(len(line.split()) - 1 for line in text.decode().splitlines())
        if n_tokens == 0:
            raise AssertionError("cli.decode --use_ave: every hypothesis is empty, so the "
                                 "comparison held no tokens")
        report["cli.decode --use_ave"] = {"main_s": wall, "tokens_compared": n_tokens}
        log(f"cli.decode --use_ave: rc {rc}, main {wall:.2f} s, 8 hypotheses ({n_tokens} "
            f"tokens) equal decode_dataset's over the mean of steps {nbest}; launches {counts}")
        torch.cuda.empty_cache()
    finally:
        whisper_tokenizer.load_tokenizer = load_tokenizer
        shutil.rmtree(root, ignore_errors=True)
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"training entry point on {gpu_info()}: {json.dumps(report)}")
    return launches, rate


EMBED_PATHS = {  # phase 4e: path -> kernels it must launch
    "cli.decode --enroll_type embedding greedy": ("decode_cross_attention",
                                                  "decode_self_attention"),
    "cli.decode --enroll_type embedding beam 5": ("decode_cross_attention_grouped",
                                                  "decode_self_attention", "beam_reorder_cache"),
    # joint decode is dense (no cross kernel) and reorders by index_select
    "cli.decode --enroll_type embedding --ctc_weight 0.3": ("decode_self_attention",),
}
# the embedding encoder's attention is the plain one, as the JAX package's
EMBED_PLAIN = ("flash_attention_tmaj", "flash_attention")


def check_small_embedding(torch, dev) -> None:
    """Phase 4e, first: a small embedding-enrollment model (``cat``
    adapter, 2 + 2 layers, f32) encodes the same mel and speaker embedding
    on the card and on the CPU (memory to 1e-3), then the prompt-free
    decoder decodes both memories greedy and at beam 3 over the int4 cross
    K/V with the kernels on the card and the plain versions on the CPU: the
    tokens must be identical."""
    from robustsq_whisper_torch.decode.search import DecodeConfig, build_beam_decoder
    from robustsq_whisper_torch.init import init_params
    from robustsq_whisper_torch.models import (
        SpkAdapterTSEncoder, TSDecoder, TSEncoderConfig, WhisperDims,
    )

    dims = WhisperDims(
        n_mels=80, n_vocab=120, n_audio_ctx=256, n_audio_state=128, n_audio_head=2,
        n_audio_layer=2, n_text_ctx=64, n_text_state=128, n_text_head=2, n_text_layer=2,
    )
    ts = TSEncoderConfig(enroll_type="embedding", enroll_size=256)
    enc = init_params(SpkAdapterTSEncoder(dims, ts), 11).eval()
    dec = init_params(TSDecoder(dims, use_spk_prompt=False, cross_kv_bits=4), 12).eval()
    rng = np.random.default_rng(13)
    mel = torch.from_numpy(rng.standard_normal((2, 80, 512)).astype(np.float32))
    emb = torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32))
    lens = torch.tensor([512, 380])
    base = dict(max_new_tokens=16, eot=2, init_tokens=(1, 4), quantize_cross_kv=True)
    out = {}
    for where in ("cpu", dev):
        e = copy.deepcopy(enc).to(where)
        with torch.inference_mode():
            memory, _ = e(mel.to(where), lens.to(where), emb.to(where))
        prompt = memory.new_zeros((2, 0, 128))
        out[str(where)] = [memory.cpu()] + [
            build_beam_decoder(copy.deepcopy(dec), DecodeConfig(**base, beam_size=k),
                               where)(memory, prompt)[0].cpu() for k in (1, 3)]
    (m_cpu, g_cpu, b_cpu), (m_gpu, g_gpu, b_gpu) = out["cpu"], out[str(dev)]
    err = (m_cpu - m_gpu).abs().max().item()
    log(f"small agreement, embedding enrollment: encoder max_abs_err {err:.3e} (tol 1e-3, f32); "
        f"greedy tokens card {g_gpu.tolist()} cpu {g_cpu.tolist()}; beam 3 tokens card "
        f"{b_gpu.tolist()} cpu {b_cpu.tolist()}")
    if err > 1e-3 or not torch.equal(g_cpu, g_gpu) or not torch.equal(b_cpu, b_gpu):
        raise AssertionError("embedding enrollment: the card and the CPU disagree")


def run_embedding_enrollment(torch, dev):
    """Phase 4e: the recipe's data stages 101-103 and embedding enrollment
    through the entry points, at Whisper-medium and ResNet34 full width.
    ``cli.datapre``: ``synth-clean`` (8 speakers x 4 utterances of 30 s),
    ``overlap`` (16 mixtures, SIR in [-5, 5] dB), ``wham`` (SNR in [10, 20]
    dB over 4 synthetic noise WAVs), ``enroll-json``, ``enroll-scp`` in
    eval mode (an 8-utterance eval dir of concrete rows), ``num-samples``,
    ``fix`` and ``validate``; ``spk-embed`` on the card at batch 16 over the
    train dir (its 32 pool utterances) and the eval dir; the embeddings of 4
    utterances on the card against the same seeded ResNet34 on the CPU (f32,
    cosine >= 0.999); ``cli.train --enroll_type embedding`` of the medium
    lora config, one epoch of 4 steps at batch 8 with the validation pass
    and the valid WER; ``cli.decode --enroll_type embedding`` from that
    checkpoint greedy and at beam 5 (int4 cross K/V, 32 new tokens) and one
    ``--ctc_weight 0.3`` decode, each run's launches counted (the rows of
    ``EMBED_PATHS`` must launch, the flash rows must not). Texts are token
    ids, as in 4b. Returns {path: launches}."""
    import contextlib
    import io
    import shutil
    import tempfile

    from robustsq_whisper_torch.cli import datapre as cli_datapre
    from robustsq_whisper_torch.cli import decode as cli_decode
    from robustsq_whisper_torch.cli import train as cli_train
    from robustsq_whisper_torch.data import kaldi_io
    from robustsq_whisper_torch.models.speaker_resnet import embed_batch, speaker_model
    from robustsq_whisper_torch.tokenizer import whisper_tokenizer

    t_phase = time.perf_counter()
    check_small_embedding(torch, dev)
    root = tempfile.mkdtemp(prefix="embedding_")
    load_tokenizer = whisper_tokenizer.load_tokenizer
    whisper_tokenizer.load_tokenizer = lambda assets: TokenIds(load_tokenizer(assets))
    launches, report, info = {}, {}, gpu_info()
    path = lambda *p: os.path.join(root, *p)  # noqa: E731

    def datapre(*args, rc_want=0):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli_datapre.main(list(args))
        wall = time.perf_counter() - t0
        stats = json.loads(buf.getvalue().strip().splitlines()[-1])
        log(f"cli.datapre {args[0]}: rc {rc}, {wall:.2f} s, {stats}")
        if rc != rc_want:
            raise AssertionError(f"cli.datapre {args[0]}: rc {rc}")
        report.setdefault("datapre_s", {})[args[0]] = wall
        return stats

    try:
        datapre("synth-clean", "--out_dir", path("clean"), "--n_speakers", "8",
                "--utts_per_spk", "4", "--seconds", "30")
        st = datapre("overlap", "--src_dir", path("clean"), "--out_dir", path("ov"),
                     "--num_mixtures", "16", "--sir_min", "-5", "--sir_max", "5")
        if st != {"num_mixtures": 16, "num_rows": 32}:
            raise AssertionError(f"overlap: {st}")
        rng = np.random.default_rng(21)
        for i in range(4):  # WHAM!-like noise: low-passed, 20 s
            x = np.cumsum(rng.standard_normal(20 * 16000)) * 0.002
            kaldi_io.write_wav(path("noise", f"noise{i}.wav"),
                               (x - x.mean()).astype(np.float32) / (np.abs(x).max() + 1e-9) * 0.5)
        train_dir = path("train")
        datapre("wham", "--clean_dir", path("ov"), "--noise_dir", path("noise"), "--out_dir",
                train_dir, "--snr_min", "10", "--snr_max", "20")
        datapre("enroll-json", "--librispeech_root", path("clean", "wavs"), "--out",
                path("spk2enroll.json"))
        for cmd in ("num-samples", "fix", "validate"):
            datapre(cmd, train_dir)
        # the eval dir: 8 utterances, concrete enrollment rows, no pool
        eval_dir = path("eval")
        kaldi_io.subset_data_dir(train_dir, eval_dir, 8)
        os.remove(os.path.join(eval_dir, "spk2enroll.json"))
        datapre("enroll-scp", "--data_dir", eval_dir, "--out", os.path.join(eval_dir, "enroll.scp"),
                "--mode", "eval", "--spk2enroll", path("spk2enroll.json"))
        datapre("validate", eval_dir)

        # stage 103 on the card, under PyTorch's own TF32 defaults (cuDNN on,
        # matmul off), which main turns off: a plain spk-embed run has them,
        # so the parity below tests embed_batch's own guard
        tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
        for name, d, n in (("train", train_dir, 32), ("eval", eval_dir, 8)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = datapre("spk-embed", "--data_dir", d, "--out_dir", path("emb", name),
                         "--batch_size", "16", "--device", str(dev))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if st != {"num_utts": n, "embed_dim": 256}:
                raise AssertionError(f"spk-embed {name}: {st}")
            report[f"spk-embed {name}"] = {"utts": n, "main_s": wall, "utts_per_s": n / wall}
        model = speaker_model(device=dev)
        enroll = kaldi_io.read_scp(os.path.join(eval_dir, "enroll.scp"))
        utts = sorted(enroll)[:4]
        batch = np.zeros((16, 30 * 16000), np.float32)
        lens = np.full((16,), 400, np.int64)
        for j, u in enumerate(utts):
            a, _ = kaldi_io.read_wav(enroll[u])
            batch[j, : len(a)], lens[j] = a[: 30 * 16000], max(len(a), 400)
        x, xl = torch.from_numpy(batch).to(dev), torch.from_numpy(lens).to(dev)
        ms = time_events_ms(torch, lambda: embed_batch(model, x, xl), reps=3)
        card = embed_batch(model, x, xl)[:4].cpu()
        host = embed_batch(speaker_model(device="cpu"), torch.from_numpy(batch[:4]),
                           torch.from_numpy(lens[:4]))
        scp = kaldi_io.read_scp(os.path.join(eval_dir, "resnet.scp"))
        files = torch.from_numpy(np.stack([np.load(scp[u]) for u in utts]))
        err = (card - host).abs().max().item()
        cos = torch.nn.functional.cosine_similarity(card, host, dim=-1).min().item()
        cos_files = torch.nn.functional.cosine_similarity(files, host, dim=-1).min().item()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        log(f"stage-103 parity on {info}, cuDNN TF32 allowed outside embed_batch: 4 "
            f"embeddings, card vs CPU max_abs_err {err:.3e}, min cosine {cos:.6f}; "
            f"spk-embed's files vs CPU min cosine {cos_files:.6f}; ResNet34 + fbank at batch "
            f"16 x 30 s: {ms:.2f} ms ({16e3 / ms:.1f} utterances/s, f32 without TF32)")
        if cos < 0.999 or cos_files < 0.999:
            raise AssertionError(f"stage 103: card vs CPU cosine {cos}, files {cos_files}")
        report["stage-103 parity"] = {"max_abs_err": err, "min_cos": cos,
                                      "batch16_ms": ms, "utts_per_s_device": 16e3 / ms}
        del model, x, xl
        torch.cuda.empty_cache()

        # stage 11 and 12 with embedding enrollment
        config = path("lora.yaml")
        with open(ENTRY_CONFIG) as f, open(config, "w") as g:
            g.write(f.read() + "decode_conf:\n  max_new_tokens: 32\n  quantize_cross_kv: true\n")
        expdir = path("exp")
        records = []
        argv = ["--config", config, "--train_dir", train_dir, "--valid_dir", eval_dir,
                "--expdir", expdir, "--batch_size", "8", "--num_epochs", "1",
                "--valid_wer_utts", "8", "--ckpt_every_steps", "0", "--log_every", "1",
                "--enroll_type", "embedding", "--tokenizer_assets", ENTRY_RANKS,
                "--device", str(dev)]
        torch.cuda.reset_peak_memory_stats(dev)
        rc, wall, counts = counted(torch, lambda: cli_train.main(
            argv, metrics_hook=lambda s, v: records.append((s, dict(v)))))
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        launches["cli.train --enroll_type embedding"] = counts
        steps = [s for s, v in records if "loss" in v]
        valid = [v for _, v in records if "valid.acc" in v]
        bad = [(s, k) for s, v in records for k, x in v.items() if not np.isfinite(x)]
        if rc != 0 or steps != [1, 2, 3, 4] or len(valid) != 1 or bad:
            raise AssertionError(f"cli.train --enroll_type embedding: rc {rc}, steps {steps}, "
                                 f"{len(valid)} valid passes, non-finite {bad[:4]}")
        seconds = records[-1][1]
        rate = 4 * 8 * 30 / seconds["seconds.train"]
        log(f"cli.train --enroll_type embedding (medium lora, adapter cat) on {info}: rc {rc}, "
            f"main {wall:.1f} s, 4 steps at batch 8 in {seconds['seconds.train']:.2f} s of "
            f"training wall ({rate:.2f} audio-s per GPU-s), validation "
            f"{seconds['seconds.valid']:.2f} s, valid WER {seconds['seconds.valid_wer']:.2f} s, "
            f"peak memory {peak:.2f} GiB; steps/s by step "
            f"{[round(v['steps_per_sec'], 3) for _, v in records if 'steps_per_sec' in v]}; "
            f"valid {valid[0]}; launches {counts}")
        report["cli.train"] = {"main_s": wall, "audio_s_per_gpu_s": rate, "peak_gib": peak,
                               "train_s": seconds["seconds.train"]}

        for beam in (1, 5):
            with open(path(f"decode_beam{beam}.yaml"), "w") as f:
                f.write(f"decode_conf:\n  beam_size: {beam}\n  max_new_tokens: 32\n"
                        "  quantize_cross_kv: true\n")
        for name, beam, extra in (("greedy", 1, ()), ("beam 5", 5, ()),
                                  ("--ctc_weight 0.3", 1, ("--ctc_weight", "0.3"))):
            key = f"cli.decode --enroll_type embedding {name}"
            out = path(f"decode_{beam}_{len(extra)}")
            dargv = ["--config", config, "--inference_config", path(f"decode_beam{beam}.yaml"),
                     "--data_dir", eval_dir, "--expdir", expdir, "--output_dir", out,
                     "--cross_kv_bits", "4", "--batch_size", "4", "--enroll_type", "embedding",
                     "--tokenizer_assets", ENTRY_RANKS, "--device", str(dev), *extra]
            rc, wall, counts = counted(torch, lambda: cli_decode.main(dargv))
            launches[key] = counts
            hyps = kaldi_io.read_scp(os.path.join(out, "text"))
            with open(os.path.join(out, "score.txt")) as f:
                scores = {k: float(v) for k, v in (line.split() for line in f)}
            log(f"{key} on {info}: rc {rc}, main {wall:.2f} s, RTF {scores['rtf']:.2f} (decode "
                f"loop); rows 2a {counts['decode_cross_attention']} 2b "
                f"{counts['decode_cross_attention_grouped']} 3a "
                f"{counts['decode_self_attention']} 7a {counts['beam_reorder_cache']}; "
                f"launches {counts}")
            missing = [n for n in EMBED_PATHS[key] if counts[n] == 0]
            flash = [n for n in EMBED_PLAIN if counts[n]]
            if rc != 0 or missing or flash or len(hyps) != 8 or not any(hyps.values()):
                raise AssertionError(f"{key}: rc {rc}, not launched {missing}, flash rows "
                                     f"launched {flash}, {len(hyps)} hypotheses")
            report[key] = {"main_s": wall, "rtf": scores["rtf"]}
    finally:
        whisper_tokenizer.load_tokenizer = load_tokenizer
        shutil.rmtree(root, ignore_errors=True)
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"data stages and embedding enrollment on {info}: {json.dumps(report)}")
    return launches


# (K, N, calls in one full-depth decode step): 24 layers x (self q/k/v/out
# and cross q/out), fc1 and fc2 a layer, and the tied logits
W8A8_STEP = ((1024, 1024, 24 * 6), (1024, 4096, 24), (4096, 1024, 24), (1024, 51865, 1))
W8A8_CALLS = sum(c for _, _, c in W8A8_STEP)  # 193
# (K, calls) of one W8A8 encoder block: q, k, v and out, fc1, fc2
W8A8_ENC_LAYER = ((1024, 4), (1024, 1), (4096, 1))
W8A8_ROWS = {  # where: the rows M of its products
    "decoder step, greedy batch 4": 4,
    "decoder step, beam 5": 20,
    "speculative verify, 4 x (gamma 10 + 1)": 44,
    "encoder with qw, 4 x 1516": 4 * 1516,
}
# (M, K, N) at the kernels' edges, held bit for bit only: the last rows of
# the fused path and the first of the wgmma one (64, 65), wgmma row tiles
# full and one past (128, 129) and ragged (700), N off the 64- and
# 128-column tiles, K of one segment or less (16, 48), one 16-byte chunk
# past a segment (1040), the fused path's largest K (8192) and the first
# past it at few rows (8208: two launches)
W8A8_EDGES = (
    (1, 16, 7), (64, 1024, 1000), (65, 1024, 1000), (128, 1024, 256), (129, 4096, 200),
    (700, 1024, 1000), (44, 48, 33), (17, 1040, 129), (6064, 1040, 136), (64, 8192, 100),
    (4, 8208, 64),
)
# (activations, output, bias) of the bit-equality checks
W8A8_DTYPES = (("bf16", "bf16", True), ("bf16", "f32", False), ("f32", "f32", True),
               ("f32", "bf16", False))


def w8a8_equal(torch, dev, quant, m: int, k: int, n: int, seed: int):
    """``qmatmul`` against ``qmatmul_plain`` at (M, K, N) for every
    ``W8A8_DTYPES`` case (a zero half-row among the activations): (all
    equal, largest |difference|, launches a call)."""
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev) * 3
    x[0, : k // 2] = 0
    w_q, w_s = quant.quantize_weight(torch.randn(n, k, generator=g, device=dev) * 0.05)
    bias = torch.randn(n, generator=g, device=dev)
    equal, err, launches = True, 0.0, set()
    for xd, od, with_bias in W8A8_DTYPES:
        xs, b = x.to(dt[xd]), bias if with_bias else None
        before = quant.qmatmul.launches
        got = quant.qmatmul(xs, w_q, w_s, b, dt[od])
        torch.cuda.synchronize()
        launches.add(quant.qmatmul.launches - before)
        ref = quant.qmatmul_plain(xs, w_q, w_s, b, dt[od])
        equal = equal and torch.equal(got, ref)
        err = max(err, (got.float() - ref.float()).abs().max().item())
    if len(launches) != 1:
        raise AssertionError(f"w8a8_matmul launched {launches} kernels a call at {(m, k, n)}")
    return equal, err, launches.pop()


def check_w8a8_kernel(torch, dev):
    """Phase 4f, the kernel: ``w8a8_matmul`` (through ``qmatmul``) against
    ``qmatmul_plain`` on the same bf16 activations, int8 weights, f32
    scales and biases at every (M, K, N) of ``W8A8_ROWS`` x ``W8A8_STEP``
    (the encoder has no logits): bit for bit; at each of those and of
    ``W8A8_EDGES`` also every ``W8A8_DTYPES`` case, each call's launches
    (the kernels the C entry reports it launched) equal to
    ``launches_per_call`` (reported per M at K <= 8192). Each shape's kernel time is
    graph replay (20 calls a graph at the decode rows); the bound is the
    larger of the bytes (x, the int8 weights, scales, bias and y once) over
    the memory rate and 2 M N K over the int8 tensor-core rate; the library
    column is ``torch._int_mm`` for the int8 product alone (M padded to 32,
    N to a multiple of 8: it takes no fewer rows and no odd N), and
    ``linear_ms`` the bf16 ``F.linear`` that W8A8 replaces. Returns the
    kernel row: one greedy decode step's 193 calls, each time the sum over
    them."""
    import torch.nn.functional as F

    from robustsq_whisper_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(13)
    shapes, step = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                            linear_ms=0.0, t_bytes=0.0, t_ops=0.0)
    max_err, all_equal, per_m = 0.0, True, {}
    checks = [(m, k, n) for m in W8A8_ROWS.values() for k, n, _ in W8A8_STEP
              if n != 51865 or m <= 64] + list(W8A8_EDGES)
    for i, (m, k, n) in enumerate(checks):
        equal, err, launches = w8a8_equal(torch, dev, quant, m, k, n, seed=100 + i)
        want = quant.launches_per_call(m, k)
        log(f"w8a8_matmul M {m} K {k} N {n}: equal to plain {equal} for {len(W8A8_DTYPES)} "
            f"dtype/bias cases (max_abs_err {err}); {launches} launches a call (want {want})")
        if launches != want:
            raise AssertionError(f"w8a8_matmul at {(m, k, n)}: {launches} launches, want {want}")
        if k <= quant.DECODE_MAX_K:
            per_m.setdefault(m, launches)
        max_err, all_equal = max(max_err, err), all_equal and equal
    torch.cuda.empty_cache()
    for where, m in W8A8_ROWS.items():
        for k, n, calls in W8A8_STEP:
            logits = n == 51865
            if logits and m > 64:
                continue
            x = torch.randn(m, k, generator=g, device=dev).bfloat16()
            w = torch.randn(n, k, generator=g, device=dev) * 0.03
            w_q, w_s = quant.quantize_weight(w)
            bias = None if logits else torch.randn(n, generator=g, device=dev)
            out_dtype = None if logits else torch.bfloat16
            got = quant.qmatmul(x, w_q, w_s, bias, out_dtype)
            ref = quant.qmatmul_plain(x, w_q, w_s, bias, out_dtype)
            equal = torch.equal(got, ref)
            err = (got.float() - ref.float()).abs().max().item()
            max_err, all_equal = max(max_err, err), all_equal and equal
            n_bytes = m * k * 2 + n * k + 4 * n * (1 if logits else 2) + m * n * (4 if logits else 2)
            t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, 2 * m * n * k / PEAK_OPS_S["int8"] * 1e3
            b_ms, b_by = bound(n_bytes, 2 * m * n * k, "int8")
            per_graph = 20 if m <= 64 else 1
            ms = time_ms(torch, lambda: quant.qmatmul(x, w_q, w_s, bias, out_dtype), calls=per_graph)
            plain_ms = time_ms(torch, lambda: quant.qmatmul_plain(x, w_q, w_s, bias, out_dtype), 5)
            xq = torch.randint(-127, 128, (max(m, 32), k), generator=g, device=dev,
                               dtype=torch.int8)
            wq_t = F.pad(w_q, (0, 0, 0, -n % 8)).t()  # (K, N8), column-major
            library_ms = time_ms(torch, lambda: torch._int_mm(xq, wq_t), calls=per_graph)
            wb, bb = w.bfloat16(), None if bias is None else bias.bfloat16()
            linear_ms = time_ms(torch, lambda: F.linear(x, wb, bb), calls=per_graph)
            row = dict(where=where, m=m, k=k, n=n, equal=equal, max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, share=b_ms / ms,
                       library_ms=library_ms, linear_ms=linear_ms)
            shapes.append(row)
            log(f"w8a8_matmul {where}: M {m} K {k} N {n}: equal to plain {equal} "
                f"(max_abs_err {err}) ms {ms:.4f} bound_ms {b_ms:.5f} ({b_by}, share "
                f"{b_ms / ms:.3f}) plain_ms {plain_ms:.4f} int_mm_ms {library_ms:.4f} "
                f"linear_bf16_ms {linear_ms:.4f}")
            if m == 4:  # the greedy step's calls of this shape
                for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                                 ("linear_ms", linear_ms), ("t_bytes", t_bytes),
                                 ("t_ops", t_ops)):
                    step[key] += calls * val
            del x, w, w_q, w_s, bias, got, ref, xq, wq_t, wb, bb
    torch.cuda.empty_cache()
    t_bytes, t_ops = step.pop("t_bytes"), step.pop("t_ops")
    step["bound_ms"], step["bound_by"] = max(t_bytes, t_ops), (
        "bytes" if t_bytes >= t_ops else "operations")
    row = dict(
        name="w8a8_matmul", route="cuda", source="robustsq_whisper_torch/csrc/w8a8_matmul.cu",
        replaces=f"{TPU_SRC}/quant.py:64", max_abs_err=max_err, tol=0.0,
        shape="one greedy decode step at batch 4: 193 calls (M 4), times summed",
        calls_per_step=W8A8_CALLS, launches_per_call={str(m): c for m, c in sorted(per_m.items())},
        shapes=shapes, **step,
    )
    log(f"w8a8_matmul launches a call by M (K <= 8192): {row['launches_per_call']}")
    log(f"kernel w8a8_matmul, one greedy step's {W8A8_CALLS} calls at batch 4 on {gpu_info()}: "
        f"ms {row['ms']:.4f} bound_ms {row['bound_ms']:.4f} ({row['bound_by']}, share "
        f"{row['bound_ms'] / row['ms']:.3f}) plain_ms {row['plain_ms']:.4f} int_mm_ms "
        f"{row['library_ms']:.4f} linear_bf16_ms {row['linear_ms']:.4f}")
    if not all_equal:
        raise AssertionError("w8a8_matmul differs from qmatmul_plain")
    return row


W8A8_PATHS = {  # path: (decoder flags, config)
    "greedy W8A8": ({}, {}),
    "greedy W8A8 self_kv_bits=8": (dict(self_kv_bits=8), {}),
    "beam 5 W8A8 eager": ({}, dict(beam_size=5)),
    "beam 5 W8A8 defer_reorder=8": ({}, dict(beam_size=5, defer_reorder=8)),
    "speculative W8A8 gamma=10": (dict(flat_self_cache=False),
                                  dict(speculative_gamma=10, draft_layers=1)),
}


def w8a8_step_launches(m: int, layers: int = 24) -> int:
    """``w8a8_matmul`` launches of one decode step of ``layers`` layers at
    ``m`` rows: ``W8A8_STEP``'s calls, each ``launches_per_call``."""
    from robustsq_whisper_torch.ops.quant import launches_per_call

    return sum((c // 24 * layers if n != 51865 else c) * launches_per_call(m, k)
               for k, n, c in W8A8_STEP)


def w8a8_expected(counts, cfg, batch: int) -> int:
    """``w8a8_matmul`` launches a transcribe must show, from the cross
    kernel's launches: greedy and beam run one cross launch a layer a step,
    so steps = launches / 24 and each step makes 193 calls at batch (x
    beam) rows; speculative decode runs the cross kernel in its 1-layer
    draft's steps only (the verify chunk reads the cross K/V in plain
    PyTorch), gamma a round, and a round makes gamma draft steps of 9 calls
    (8 matmuls and the logits) at batch rows and one verify of 193 at batch
    x (gamma + 1) rows."""
    gamma = cfg.get("speculative_gamma", 0)
    if gamma:
        rounds = counts["decode_cross_attention"] // gamma
        return rounds * (gamma * w8a8_step_launches(batch, layers=1)
                         + w8a8_step_launches(batch * (gamma + 1)))
    beam = cfg.get("beam_size", 1)
    key = "decode_cross_attention_grouped" if beam > 1 else "decode_cross_attention"
    return counts[key] // 24 * w8a8_step_launches(batch * beam)


def run_w8a8_paths(torch, dev, models, batch: int, max_new: int, reports):
    """Phase 4f: the ``ptxas`` lines of the ``w8a8_matmul`` instantiations
    (from the build's ``reports``), the kernel check
    (``check_w8a8_kernel``), the engine's W8A8 paths at medium and one
    encode with W8A8 blocks. Returns (kernel row, {path: launches}, (greedy
    W8A8 engine, memory, prompt), a function that runs the W8A8 encode)."""
    from robustsq_whisper_torch.decode.pipeline import chunked_encode
    from robustsq_whisper_torch.models.ts_encoder import quantize_encoder_weights
    from robustsq_whisper_torch.ops.quant import launches_per_call

    t_phase = time.perf_counter()
    for name, fn, regs, spills in ptxas_report({"w8a8_matmul": reports.get("w8a8_matmul", "")}):
        log(f"ptxas w8a8_matmul instantiation {fn}: {regs}; {spills or 'no spill line'}")
    row = check_w8a8_kernel(torch, dev)
    dims, enc, dec = models
    items = synthetic_pairs(batch, seed=0)
    launches, report = {}, {}
    memory = prompt = greedy = None
    for path, (flags, cfg) in W8A8_PATHS.items():
        d = decoder_with(dec, **flags) if flags else dec
        engine = engine_for(torch, dev, enc, d, batch, max_new, quantize_weights=True, **cfg)
        wall, counts = counted_transcribe(torch, engine, items, path, ("w8a8_matmul",))
        launches[path] = counts
        want = w8a8_expected(counts, cfg, batch)
        if memory is None:
            memory, prompt = chunked_encode(engine.encode, engine.stage(items), 0)
            greedy = (engine, memory, prompt)
        dense = engine_for(torch, dev, enc, d, batch, max_new, **cfg)
        runs = {}
        for name, e in (("w8a8", engine), ("dense", dense)):
            e.run(memory, prompt)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tokens = e.run(memory, prompt)[0]
            torch.cuda.synchronize()
            runs[name] = (time.perf_counter() - t0, tokens.cpu())
        agree = (runs["w8a8"][1] == runs["dense"][1]).float().mean().item()
        report[path] = {"transcribe_ms": wall * 1e3, "run_ms": runs["w8a8"][0] * 1e3,
                        "dense_run_ms": runs["dense"][0] * 1e3, "token_agreement": agree,
                        "w8a8_launches": counts["w8a8_matmul"], "expected": want}
        log(f"{path} on {gpu_info()}: transcribe {wall * 1e3:.1f} ms; run {runs['w8a8'][0] * 1e3:.1f} "
            f"ms against the dense engine's {runs['dense'][0] * 1e3:.1f} ms; token agreement "
            f"with the dense path {agree:.4f}; w8a8_matmul launches {counts['w8a8_matmul']} "
            f"(expected {want})")
        if counts["w8a8_matmul"] != want:
            raise AssertionError(f"{path}: {counts['w8a8_matmul']} w8a8_matmul launches, "
                                 f"expected {want}")
        if runs["w8a8"][1].shape != (batch, max_new):
            raise AssertionError(f"{path}: tokens of shape {tuple(runs['w8a8'][1].shape)}")
        del engine, dense, d
    torch.cuda.empty_cache()

    # one encode with W8A8 blocks: its attention takes attend (row 4)
    engine, memory, prompt = greedy
    staged = engine.stage(items)
    qw_enc = quantize_encoder_weights(enc)
    with torch.inference_mode():
        enc(*staged, qw=qw_enc)  # warm
        (out_q, *_), wall, counts = counted(torch, lambda: enc(*staged, qw=qw_enc))
        out_d = enc(*staged)[0]
        q_ms = time_events_ms(torch, lambda: enc(*staged, qw=qw_enc), reps=3)
        d_ms = time_events_ms(torch, lambda: enc(*staged), reps=3)
    launches["encode W8A8"] = counts
    dev_err = ((out_q.float() - out_d.float()).abs().max() / out_d.float().std()).item()
    report["encode W8A8"] = {"ms": q_ms, "dense_ms": d_ms, "max_dev_of_std": dev_err,
                             "launches": counts}
    log(f"encode with quantize_encoder_weights on {gpu_info()}: {q_ms:.2f} ms against the "
        f"dense encode's {d_ms:.2f} ms (batch {batch}, events); largest deviation from the "
        f"dense output {dev_err:.4f} of its std; launches flash_attention "
        f"{counts['flash_attention']} flash_attention_tmaj {counts['flash_attention_tmaj']} "
        f"w8a8_matmul {counts['w8a8_matmul']}")
    t_enc = batch * 1516  # rows of the encoder's matmuls (1500 frames + 16 queries)
    want = {"flash_attention": 24, "flash_attention_tmaj": 0,
            "w8a8_matmul": 24 * sum(c * launches_per_call(t_enc, k) for k, c in W8A8_ENC_LAYER)}
    if any(counts[k] != v for k, v in want.items()) or not torch.isfinite(out_q.float()).all():
        raise AssertionError(f"W8A8 encode: launches {counts}, expected {want}")
    del out_q, out_d
    torch.cuda.empty_cache()
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"W8A8 paths on {gpu_info()}: {json.dumps(report)}")

    def encode_q():
        with torch.inference_mode():
            return enc(*staged, qw=qw_enc)

    return row, launches, greedy, encode_q


def run_w8a8_entry_points(torch, dev, root, data_dir, wavs, enrolls):
    """Phase 4f, the entry points: ``cli.decode --int8_weights true``
    greedy and at beam 5 over phase 4b's data dir, checkpoint and yamls,
    and ``cli.serve --int8_weights true`` answering 8 concurrent requests,
    each equal to its engine's ``transcribe``. Returns {path: launches}."""
    import threading

    from robustsq_whisper_torch.cli import decode as cli_decode
    from robustsq_whisper_torch.cli import serve as cli_serve
    from robustsq_whisper_torch.data import kaldi_io
    from robustsq_whisper_torch.serve import audio_from_bytes, make_server

    launches, report = {}, {}
    for beam in (1, 5):
        path = f"cli.decode --int8_weights beam {beam}"
        out = os.path.join(root, f"decode_int8_beam{beam}")
        argv = ["--config", ENTRY_CONFIG, "--inference_config",
                os.path.join(root, f"decode_beam{beam}.yaml"), "--data_dir", data_dir,
                "--expdir", os.path.join(root, "exp"), "--output_dir", out,
                "--cross_kv_bits", "4", "--batch_size", "4", "--int8_weights", "true",
                "--tokenizer_assets", ENTRY_RANKS, "--device", str(dev)]
        rc, wall, counts = counted(torch, lambda: cli_decode.main(argv))
        launches[path] = counts
        hyps = kaldi_io.read_scp(os.path.join(out, "text"))
        with open(os.path.join(out, "score.txt")) as f:
            scores = dict(line.split() for line in f)
        report[path] = {"main_s": wall, "rtf": float(scores["rtf"])}
        log(f"{path}: rc {rc}, main {wall:.2f} s, RTF {float(scores['rtf']):.2f} (decode "
            f"loop) on {gpu_info()}; launches {counts}")
        if rc != 0 or counts["w8a8_matmul"] == 0 or len(hyps) != 8:
            raise AssertionError(f"{path}: rc {rc}, {len(hyps)} hypotheses, launches {counts}")

    args = cli_serve.parse_args([
        "--config", ENTRY_CONFIG, "--inference_config", os.path.join(root, "decode_beam1.yaml"),
        "--expdir", os.path.join(root, "exp"), "--batch_size", "4", "--max_wait_ms", "15",
        "--cross_kv_bits", "4", "--tokenizer_assets", ENTRY_RANKS, "--device", str(dev),
        "--int8_weights", "true",
    ])
    engine, info = cli_serve.build_engine(args)
    engine.warmup()
    server, batcher = make_server(engine, "127.0.0.1", 0, args.max_wait_ms, info=info)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        answers, wall, counts = counted(torch, lambda: serve_requests(
            server.server_address[1], list(wavs.values()), list(enrolls.values())))
        launches["cli.serve --int8_weights"] = counts
    finally:
        server.shutdown()
        batcher.close()
        server.server_close()
        thread.join(timeout=30)
    for (utt, w), e, a in zip(wavs.items(), enrolls.values(), answers):
        with open(w, "rb") as f, open(e, "rb") as g:
            want = engine.transcribe([(audio_from_bytes(f.read()), audio_from_bytes(g.read()))])[0]
        if a["text"] != want:
            raise AssertionError(f"cli.serve --int8_weights {utt}: {a['text']!r} != {want!r}")
    lat = sorted(a["latency_ms"] for a in answers)
    report["cli.serve --int8_weights"] = {"wall_s": wall, "p50_ms": statistics.median(lat),
                                          "max_ms": lat[-1]}
    log(f"cli.serve --int8_weights: 8 concurrent requests in {wall:.2f} s, latency p50 "
        f"{statistics.median(lat):.1f} ms max {lat[-1]:.1f} ms on {gpu_info()}, texts equal "
        f"engine.transcribe; launches {counts}")
    if counts["w8a8_matmul"] == 0 or not engine.dcfg.quantize_weights:
        raise AssertionError(f"cli.serve --int8_weights did not run W8A8: {counts}")
    del engine
    torch.cuda.empty_cache()
    log(f"W8A8 entry points on {gpu_info()}: {json.dumps(report)}")
    return launches


# the W8A8 kernels by family, as the profiler names them: the fused decode
# kernels (local and cluster), the large-M path's row quantizer and product
W8A8_KERNELS = {"fused": "w8a8_decode_", "quantizer": "quantize_rows_kernel",
                "wgmma": "w8a8_gemm_sm90_kernel"}


def profile_w8a8(torch, greedy, encode_q, batch: int) -> None:
    """Phase 4f, last: ``utils.profiling.trace`` around one W8A8 greedy run
    and one W8A8 encode, ``op_stats`` over each trace (the top device
    kernels), and the W8A8 kernels the card ran, counted by name in the
    trace: the greedy run's fused kernels must equal both the
    ``w8a8_matmul`` launches ``qmatmul`` counted in the same run and the
    steps x 193 calls (steps from the cross kernel's launches), with no
    quantizer or ``wgmma`` kernel; the encode's 144 calls must run 144
    quantizers and 144 ``wgmma`` products and no fused kernel."""
    import shutil

    from robustsq_whisper_torch.ops._build import BUILD
    from robustsq_whisper_torch.utils.profiling import op_stats, top_ops, trace

    engine, memory, prompt = greedy
    calls = 24 * sum(c for _, c in W8A8_ENC_LAYER)
    for what, fn in (("greedy run", lambda: engine.run(memory, prompt)), ("encode", encode_q)):
        trace_dir = str(BUILD / f"trace_w8a8_{what.replace(' ', '_')}")
        shutil.rmtree(trace_dir, ignore_errors=True)
        with trace(trace_dir):
            _, _, counts = counted(torch, fn)
        stats = op_stats(trace_dir)
        seen = {fam: round(sum(r["count"] for name, r in stats.items() if pat in name))
                for fam, pat in W8A8_KERNELS.items()}
        if what == "encode":
            want = {"fused": 0, "quantizer": calls, "wgmma": calls}
        else:
            want = {"fused": w8a8_expected(counts, {}, batch), "quantizer": 0, "wgmma": 0}
        log(f"op_stats of one W8A8 {what} on {gpu_info()} (device ms, calls):\n"
            + top_ops(stats, 8))
        log(f"W8A8 {what}: kernels in the trace {seen}, expected {want}; qmatmul counted "
            f"{counts['w8a8_matmul']} launches")
        if seen != want or counts["w8a8_matmul"] != sum(seen.values()):
            raise AssertionError(f"W8A8 {what}: the trace shows {seen}, expected {want}, and "
                                 f"qmatmul counted {counts['w8a8_matmul']} launches")


# the self-cache read kernels' names: the shared read's, and those of the
# two kernels it replaced (to profile an older tree)
SELF_KERNELS = ("self_cache_read_kernel", "decode_self_kernel", "settled_kernel")


def profile_runs(torch, greedy, beam, train) -> None:
    """Device busy share of the encode, the greedy run, the two beam runs
    and one full-mode training step, by profiler; last, because the
    profiler slows later host work."""
    from robustsq_whisper_torch.decode.pipeline import chunked_encode
    from robustsq_whisper_torch.ops._build import BUILD

    engine, staged, memory, prompt = greedy
    b_engines, b_memory, b_prompt = beam
    eager, deferred = (b_engines[p].run for p in BEAM_PATHS)
    state, step, batch, gen = train
    os.makedirs(BUILD, exist_ok=True)
    for phase, fn in (
        ("encode", lambda: chunked_encode(engine.encode, staged, 0)),
        ("run", lambda: engine.run(memory, prompt)),
        ("beam_run", lambda: eager(b_memory, b_prompt)),
        ("beam_run_deferred", lambda: deferred(b_memory, b_prompt)),
        ("train_full_step", lambda: step(state, batch, gen, 0)),
    ):
        wall, busy, by_name = device_busy(torch, fn, str(BUILD / f"trace_{phase}.json"))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        reads = {n: t for n, t in by_name.items() if any(k in n for k in SELF_KERNELS)}
        log(f"profile {phase}: wall {wall:.1f} ms, device busy {busy:.1f} ms "
            f"({busy / wall:.1%}); top kernels (ms): "
            + "; ".join(f"{n[:60]} {t:.2f}" for n, t in top)
            + "; self-cache reads (ms): "
            + ("; ".join(f"{n[:70]} {t:.3f}" for n, t in reads.items()) or "none"))


def main() -> int:
    import torch

    if len(sys.argv) > 1 and sys.argv[1] == "torchrun-decode":
        return torchrun_decode(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from robustsq_whisper_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    info = gpu_info()
    log(f"gpu: {info}; torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()
    secs, reports = _build.build_all()
    log(f"kernel build: {secs:.1f} s")
    for name, fn, regs, spills in ptxas_report(reports):
        log(f"ptxas {name}: {fn}: {regs}; {spills}")

    batch, max_new, beam = 4, 32, 5
    rows = check_kernels(torch, dev, batch, max_new, beam)
    rows += check_flash_kernels(torch, dev)
    check_small_agreement(torch, dev)
    check_small_remaining(torch, dev)
    check_small_training(torch, dev)
    models = medium_models(torch, dev)
    greedy_launches, greedy = run_main_path(torch, dev, models, batch, max_new)
    beam_launches, beam_run = run_beam_paths(torch, dev, models, batch, max_new)
    layout_launches = run_layout_paths(torch, dev, models, batch, max_new)
    asr_launches = run_asr_paths(torch, dev, models, batch, max_new)
    w8a8_row, w8a8_launches, w8a8_greedy, w8a8_encode = run_w8a8_paths(
        torch, dev, models, batch, max_new, reports)
    rows.append(w8a8_row)
    mesh_launches, _ = run_multi_gpu_decode(torch, dev, models, batch, max_new)
    mesh_launches.update(run_one_card_ranks(torch))
    entry_launches = run_entry_points(torch, dev)
    train_entry_launches, cli_rate = run_train_entry(torch, dev)
    embed_launches = run_embedding_enrollment(torch, dev)
    train_launches, train_run, train_rates = run_train_paths(torch, dev)
    log(f"training audio-s per GPU-s on {gpu_info()}: cli.train (lora, batch 8, the loop's "
        f"training wall) {cli_rate:.2f}, make_train_step in memory (lora, fastest step) "
        f"{train_rates['train lora']:.2f}")
    profile_runs(torch, greedy, beam_run, train_run)
    profile_w8a8(torch, w8a8_greedy, w8a8_encode, batch)
    by_path = {"greedy": greedy_launches, **beam_launches, **layout_launches, **asr_launches,
               **w8a8_launches, **entry_launches, **train_entry_launches, **embed_launches,
               **train_launches, **mesh_launches}
    for r in rows:  # launches on the path this row's kernel was ported for
        r["launches"] = by_path[OWN_PATH.get(r["name"], "greedy")][r["name"]]
        r["launches_by_path"] = {p: c[r["name"]] for p, c in by_path.items()}
        r.pop("tol")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    torch.distributed.destroy_process_group()  # phase 4g's
    print(json.dumps({"kernels": rows}))
    print(gpu_info())
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
