"""Driver of the offline decode job: ``decode.pipeline.decode_dataset`` over
a benchmark-owned in-memory dataset, as ``cli.decode`` runs it (``--batch_size
--cross_kv_bits --prefill_quantized --enc_chunk``).

Set-up makes the pool of (mixture, enrollment) pairs and the weights from
the seed, builds the serving modules and decodes one batch to warm every
shape. The window then decodes batches sliced from the pool (cycling, with
fresh utterance ids) until ``seconds`` have passed since the first batch
request; the batch in flight finishes. The tokenizer hands the token ids
back as the text, so the served tokens of every utterance are known.

The check follows rows of the window's first batch drawn from the seed:
their logits, as ``prefill`` and ``step`` return them, are copied to the
host during the window, and after it the plain reference runs over the same
inputs teacher forced on the served tokens. ``logit_gap`` is the widest gap
by which a served token's reference logit lies below the reference's best
at its position; ``logit_err`` the worst position's RMS error of the
program's logits over the spread of the reference's.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from portbench import flops, traffic as traffic_mod
from portbench.harness import Marks, SubWindow
from portbench.reference.frontend import log_mel, pcm16
from portbench.reference.model import Ref, param_specs
from portbench.weights import make_weights, sub_seed


class IdTokenizer:
    """Token ids as the text: ``decode([3, 7]) == "3 7"``."""

    def decode(self, ids) -> str:
        return " ".join(str(int(t)) for t in ids)


class PoolDataset:
    """The benchmark's dataset: batches sliced from the pool. Records the
    time of every batch request and hand-over; stops after ``n_batches``
    or once ``seconds`` have passed since the first request."""

    sample_rate = traffic_mod.SR

    def __init__(self, pool: Dict[str, np.ndarray], batch: int, tag: str, n_batches: int = 0,
                 seconds: float = 0.0, on_request=None):
        self.pool, self.b, self.tag = pool, batch, tag
        self.n_batches, self.seconds, self.on_request = n_batches, seconds, on_request
        self.text: Dict[str, str] = {}
        self.requests: List[float] = []
        self.handed: List[float] = []
        self.rows: Dict[str, int] = {}  # utterance id -> pool row
        self.pool_batches = len(pool["speech_lens"]) // batch

    def batches(self, batch_size: int, shuffle: bool = False, drop_last: bool = False):
        if batch_size != self.b:
            raise ValueError(f"the pool is cut in batches of {self.b}, asked for {batch_size}")
        k = 0
        while True:
            now = time.perf_counter()
            self.requests.append(now)
            if self.on_request is not None:
                self.on_request(k)
            if self.n_batches and k >= self.n_batches:
                return
            if self.seconds and now >= self.requests[0] + self.seconds:
                return
            s = (k % self.pool_batches) * self.b
            sl = slice(s, s + self.b)
            utts = [f"{self.tag}{k}-{i}" for i in range(self.b)]
            self.rows.update((u, s + i) for i, u in enumerate(utts))
            batch = {"utt_ids": utts, "speech": self.pool["speech"][sl],
                     "speech_lens": self.pool["speech_lens"][sl],
                     "enroll": self.pool["enroll"][sl], "enroll_lens": self.pool["enroll_lens"][sl]}
            self.handed.append(time.perf_counter())
            yield batch
            k += 1


def served_tokens(hyps: Dict[str, str]) -> Dict[str, List[int]]:
    return {u: [int(t) for t in h.split()] for u, h in hyps.items()}


def iterations(toks: List[List[int]], max_new: int) -> int:
    """Token-loop iterations of a batch: until every row emitted eot."""
    return min(max_new, max(len(t) + 1 for t in toks))


def run(ctx) -> SimpleNamespace:
    from robustsq_whisper_torch.decode.pipeline import decode_dataset

    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    B, max_new = tr["batch_size"], tr["max_new_tokens"]
    pool = traffic_mod.decode_pool(tr, seed, dev)
    weights = make_weights(param_specs(cfg, heads=False), seed, dev)
    enc, dec = ctx.program.serving_modules(cfg, weights, dev)
    del weights
    dcfg = ctx.program.decode_config(cfg, tr)
    tok = IdTokenizer()
    decode_dataset(enc, dec, PoolDataset(pool, B, "warm", n_batches=1), tok, dcfg, batch_size=B,
                   enc_chunk=tr["enc_chunk"], device=dev)
    ctx.sync()

    # spans: encoder calls (host times and device events) and the sub-window
    marks, sub = Marks(torch), (SubWindow(torch) if ctx.trace else None)
    enc_calls: List[list] = []  # [batch, host start, host end, start event, end event, rows]
    state = {"batch": -1}

    def on_request(k: int) -> None:
        if k == 0:
            ctx.window_started()
        marks.close("search")
        state["batch"] = k
        if sub is not None and k == 1:
            sub.start()
        elif sub is not None and k == 2 and sub.t0 is not None and sub.t1 is None:
            sub.stop()
        marks.open("stage")

    def pre(module, args):
        marks.close("stage")
        marks.open("encoder")
        ev = torch.cuda.Event(enable_timing=True) if ctx.cuda else None
        if ev is not None:
            ev.record()
        enc_calls.append([state["batch"], time.perf_counter(), None, ev, None, args[0].shape[0]])

    def post(module, args, out):
        call = enc_calls[-1]
        if ctx.cuda:
            call[4] = torch.cuda.Event(enable_timing=True)
            call[4].record()
        call[2] = time.perf_counter()
        marks.close("encoder")
        marks.open("search")

    hooks = [enc.register_forward_pre_hook(pre), enc.register_forward_hook(post)]
    check_rows = sample_rows(B, tr["check_utterances"], seed)
    capture = LogitCapture(dec, check_rows, max_new, state, ctx.cuda)
    ds = PoolDataset(pool, B, "u", seconds=ctx.seconds, on_request=on_request)
    res = decode_dataset(enc, dec, ds, tok, dcfg, batch_size=B, enc_chunk=tr["enc_chunk"], device=dev)
    t_end = time.perf_counter()
    marks.close("search")
    if sub is not None and sub.t0 is not None and sub.t1 is None:
        sub.stop()
    for h in hooks:
        h.remove()
    capture.remove()
    ctx.sync()
    wall = t_end - ds.requests[0]
    n_batches = len(ds.handed)
    toks = served_tokens(res.hyps)
    iters = [iterations([toks.get(f"u{k}-{i}", []) for i in range(B)], max_new) for k in range(n_batches)]
    attempted = n_batches * B
    failed = attempted - sum(1 for k in range(n_batches) for i in range(B) if f"u{k}-{i}" in res.hyps)

    # per-layer spans
    stage, encoder_ms, search = [], [], []
    for k in range(n_batches):
        calls = [c for c in enc_calls if c[0] == k]
        if not calls:
            continue
        stage.append((calls[0][1] - ds.handed[k]) * 1e3)
        if ctx.cuda:
            encoder_ms.append(sum(c[3].elapsed_time(c[4]) for c in calls))
        search.append((ds.requests[k + 1] - calls[-1][2]) * 1e3 / iters[k])
    prefix = (1 + cfg["encoder"]["num_query_tokens"] if cfg["encoder"]["enroll_type"] == "audio" else 0) \
        + len(cfg["serving"]["init_tokens"])
    enroll_frames = int(tr["enroll_seconds"] * traffic_mod.SR) // 160
    obs = SimpleNamespace(
        kind="decode", config=cfg, traffic=tr, sub=sub, batch_rows=B,
        stage_ms=stage, encoder_ms=encoder_ms, search_ms_per_step=search,
        sub_steps=iters[1] if sub is not None and n_batches > 1 else None,
        sub_encoder_rows=sum(c[5] for c in enc_calls if c[0] == 1),
        memory_len=flops.memory_len(cfg), prefix=prefix, enroll_frames=enroll_frames,
    )
    memory_peak = ctx.memory_peak()
    del enc, dec
    gc.collect()
    ctx.empty_cache()

    checks = check(ctx, pool, [ds.rows[f"u0-{i}"] for i in check_rows],
                   [toks.get(f"u0-{i}", []) for i in check_rows], capture.buf[: capture.i])
    return SimpleNamespace(
        end_to_end={"decode_audio_s_per_gpu_s": res.audio_seconds / (wall * ctx.world)},
        attempted=attempted, failed=failed, obs=obs, memory_peak=memory_peak, checks=checks,
        detail={"batches": n_batches, "audio_s": res.audio_seconds, "window_wall_s": wall,
                "iterations": iters,
                "batch_s": [round(b - a, 4) for a, b in zip(ds.requests, ds.requests[1:])],
                "stage_ms": [round(x, 1) for x in stage], "encoder_ms": [round(x, 1) for x in encoder_ms],
                "search_ms_per_step": [round(x, 2) for x in search]},
    )


class LogitCapture:
    """Copies the logits that ``prefill`` and ``step`` return for ``rows``
    of window batch 0 to pinned host memory, without a sync; wraps the two
    methods of the decoder instance for the window."""

    def __init__(self, dec, rows: List[int], max_new: int, state: dict, cuda: bool):
        self.dec, self.state, self.i = dec, state, 0
        V = dec.dims.n_vocab
        self.buf = torch.empty((max_new, len(rows), V), dtype=torch.float32, pin_memory=cuda)
        self.idx = torch.tensor(rows, device=dec.decoder.token_embedding.weight.device)
        self.orig = {n: getattr(dec, n) for n in ("prefill", "step")}
        for n, fn in self.orig.items():
            setattr(dec, n, self._wrap(fn))

    def _wrap(self, fn):
        def call(*args, **kw):
            logits, cache = fn(*args, **kw)
            if self.state["batch"] == 0 and self.i < len(self.buf):
                self.buf[self.i].copy_(logits.index_select(0, self.idx), non_blocking=True)
                self.i += 1
            return logits, cache
        return call

    def remove(self) -> None:
        for n in self.orig:
            delattr(self.dec, n)


def sample_rows(batch: int, n: int, seed: int) -> List[int]:
    rng = np.random.default_rng(sub_seed(seed, "check-sample"))
    return sorted(rng.choice(batch, size=min(n, batch), replace=False).tolist())


@torch.no_grad()
def reference_logits(ctx, pool, rows: List[int], token_lists: List[List[int]], lowp=None, block: int = 4):
    """Per utterance, the reference's float32 logits at each served
    position (the served tokens, and eot where the row stopped), teacher
    forced; with ``lowp`` also the control's, else None."""
    cfg, dev, sv = ctx.config, ctx.device, ctx.config["serving"]
    P = {k: v.float() for k, v in make_weights(param_specs(cfg, heads=False), ctx.seed, dev).items()}
    ref = Ref(P, cfg)
    ctl = Ref(P, cfg, lowp=lowp) if lowp else None
    init, eot = list(sv["init_tokens"]), sv["eot"]
    refs, ctls = [], []
    for s in range(0, len(rows), block):
        r = rows[s:s + block]
        sp = torch.from_numpy(pcm16(pool["speech"][r])).to(dev)
        er = torch.from_numpy(pcm16(pool["enroll"][r])).to(dev)
        mel, mel_lens = log_mel(sp, torch.from_numpy(pool["speech_lens"][r]).long().to(dev),
                                cfg["whisper"]["n_mels"])
        emel, emel_lens = log_mel(er, torch.from_numpy(pool["enroll_lens"][r]).long().to(dev),
                                  cfg["whisper"]["n_mels"])
        memory, _, prompt, _ = ref.encode(mel, mel_lens, emel, emel_lens, approx=sv["gelu_approx"])
        cross = ref.quantized_cross(memory, sv["cross_kv_bits"])
        if ctl is not None:
            c_mem, _, c_prompt, _ = ctl.encode(mel, mel_lens, emel, emel_lens, approx=sv["gelu_approx"])
            c_cross = ctl.quantized_cross(c_mem, sv["cross_kv_bits"])
        for j, toks in enumerate(token_lists[s:s + block]):
            served = served_with_eot(toks, ctx.traffic["max_new_tokens"], eot)
            seq = torch.tensor([init + served], device=dev)
            first = len(init) - 1
            x, prefix = ref.embed_prefixed(seq, prompt[j:j + 1])
            refs.append(ref.decode(x, cross=[(k[j:j + 1], v[j:j + 1]) for k, v in cross])
                        [0, prefix + first:prefix + first + len(served)])
            if ctl is not None:
                x, prefix = ctl.embed_prefixed(seq, c_prompt[j:j + 1])
                ctls.append(ctl.decode(x, cross=[(k[j:j + 1], v[j:j + 1]) for k, v in c_cross])
                            [0, prefix + first:prefix + first + len(served)])
    return refs, (ctls if ctl is not None else None)


def served_with_eot(toks: List[int], max_new: int, eot: int) -> List[int]:
    """The tokens the loop chose: the served ones, and eot where it stopped."""
    return list(toks) + ([eot] if len(toks) < max_new else [])


def token_gap(ref_logits: torch.Tensor, chosen: torch.Tensor) -> float:
    """Widest gap by which a chosen token's reference logit lies below the
    reference's best at its position."""
    picked = ref_logits.gather(1, chosen[:, None])[:, 0]
    return float((ref_logits.max(-1).values - picked).max())


def logit_err(logits: torch.Tensor, ref_logits: torch.Tensor) -> float:
    """Worst position's RMS logit error over the reference logits' spread."""
    err = (logits - ref_logits).pow(2).mean(-1).sqrt() / ref_logits.std(-1)
    return float(err.max())


def check(ctx, pool, rows: List[int], toks: List[List[int]], captured: torch.Tensor) -> Dict[str, dict]:
    """``rows``: the sampled pool rows (window batch 0), ``toks`` their
    served tokens, ``captured`` (iterations, rows, vocab) their logits."""
    ctx.reference_mode()
    dev, eot, max_new = ctx.device, ctx.config["serving"]["eot"], ctx.traffic["max_new_tokens"]
    refs, _ = reference_logits(ctx, pool, rows, toks)
    gaps, errs = [], []
    for j, (t, r) in enumerate(zip(toks, refs)):
        served = torch.tensor(served_with_eot(t, max_new, eot), device=dev)
        gaps.append(token_gap(r, served))
        errs.append(logit_err(captured[: len(served), j].to(dev), r))
    n_tok = sum(len(served_with_eot(t, max_new, eot)) for t in toks)
    over = f"{n_tok} served tokens of {len(rows)} utterances of window batch 0, lengths {sorted(len(t) for t in toks)}"
    return {"logit_gap": {"value": max(gaps), "limit": ctx.limits["logit_gap"], "rule": "at most", "over": over},
            "logit_err": {"value": max(errs), "limit": ctx.limits["logit_err"], "rule": "at most", "over": over}}
