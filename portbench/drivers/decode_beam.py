"""Driver of the offline decode job with beam search:
``decode.pipeline.decode_dataset`` over the benchmark's in-memory dataset,
as ``cli.decode`` runs it with a decode config of ``beam_size`` k
(``--batch_size --cross_kv_bits --prefill_quantized --enc_chunk``); the loop
runs b x k rows.

Set-up, the window, the encoder hooks and the spans are the greedy
driver's (``decode_dataset.py``). During window batch 0 the driver records,
for the sampled utterances, every row's logits as ``prefill`` and ``step``
return them, the tokens each ``step`` call is fed, and the row map each
cache reorder applies (``decode/search.py``'s ``beam_reorder_cache``,
wrapped for the window), copied to pinned host memory without a sync. So
every row's prefix at every step is known. The step calls of each batch
count its loop iterations; the launch counters of the reorder and the
grouped cross kernels are recorded per batch in ``detail``.

The check, after the window: the plain reference is teacher forced on
every row's own prefix (one forward per row that no later row continues,
in blocks), and on each served hypothesis. Its three numbers:

- ``logit_err``: the worst position's RMS logit error of any row against
  the reference's logits on that row's prefix, over their spread;
- ``select_gap``: at each step, how far the score of the k-th candidate
  the program kept lies below the k-th best over the same k x vocab
  candidates, a candidate scored by the program's own score of its beam
  plus the reference's log-prob of its token (dead beams extend only with
  eot, at no cost; at step 0 only beam 0 is live);
- ``score_gap``: how far the served hypothesis's reference log-prob lies
  below the reference's best extension of the last step's k rows (the best
  of the final beams).
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from portbench import flops, traffic as traffic_mod
from portbench.drivers.decode_dataset import (
    IdTokenizer, PoolDataset, logit_err, sample_rows, served_tokens, served_with_eot,
)
from portbench.harness import Marks, SubWindow
from portbench.reference.beam import NEG
from portbench.reference.frontend import log_mel, pcm16
from portbench.reference.model import Ref, param_specs
from portbench.weights import make_weights


def launch_counts() -> Tuple[int, int]:
    """(in-place reorder launches, grouped cross launches) so far."""
    from robustsq_whisper_torch.ops.beam_gather import beam_reorder_cache
    from robustsq_whisper_torch.ops.decode_attention import decode_cross_attention

    return beam_reorder_cache.launches, decode_cross_attention.grouped_launches


def run(ctx) -> SimpleNamespace:
    from robustsq_whisper_torch.decode.pipeline import decode_dataset

    cfg, tr, dev, seed = ctx.config, ctx.traffic, ctx.device, ctx.seed
    B, k, max_new = tr["batch_size"], tr["beam_size"], tr["max_new_tokens"]
    pool = traffic_mod.decode_pool(tr, seed, dev)
    weights = make_weights(param_specs(cfg, heads=False), seed, dev)
    enc, dec = ctx.program.serving_modules(cfg, weights, dev)
    del weights
    dcfg = ctx.program.decode_config(cfg, tr)
    tok = IdTokenizer()
    decode_dataset(enc, dec, PoolDataset(pool, B, "warm", n_batches=1), tok, dcfg, batch_size=B,
                   enc_chunk=tr["enc_chunk"], device=dev)
    ctx.sync()

    marks, sub = Marks(torch), (SubWindow(torch) if ctx.trace else None)
    enc_calls: List[list] = []  # [batch, host start, host end, start event, end event, rows]
    state = {"batch": -1}
    counts: List[Tuple[int, int]] = []  # launch counters at each batch request

    def on_request(i: int) -> None:
        if i == 0:
            ctx.window_started()
        marks.close("search")
        counts.append(launch_counts())
        state["batch"] = i
        if sub is not None and i == 1:
            sub.start()
        elif sub is not None and i == 2 and sub.t0 is not None and sub.t1 is None:
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
    capture = BeamCapture(dec, check_rows, k, max_new, state, ctx.cuda)
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
    iters = [capture.calls.get(i, 0) + 1 for i in range(n_batches)]
    attempted = n_batches * B
    failed = attempted - sum(1 for i in range(n_batches) for j in range(B) if f"u{i}-{j}" in res.hyps)

    stage, encoder_ms, search = [], [], []
    for i in range(n_batches):
        calls = [c for c in enc_calls if c[0] == i]
        if not calls:
            continue
        stage.append((calls[0][1] - ds.handed[i]) * 1e3)
        if ctx.cuda:
            encoder_ms.append(sum(c[3].elapsed_time(c[4]) for c in calls))
        search.append((ds.requests[i + 1] - calls[-1][2]) * 1e3 / iters[i])
    prefix = 1 + cfg["encoder"]["num_query_tokens"] + len(cfg["serving"]["init_tokens"])
    enroll_frames = int(tr["enroll_seconds"] * traffic_mod.SR) // 160
    obs = SimpleNamespace(
        kind="decode", config=cfg, traffic=tr, sub=sub, batch_rows=B * k, utterance_rows=B, beam_size=k,
        stage_ms=stage, encoder_ms=encoder_ms, search_ms_per_step=search,
        sub_steps=iters[1] if sub is not None and n_batches > 1 else None,
        sub_encoder_rows=sum(c[5] for c in enc_calls if c[0] == 1),
        memory_len=flops.memory_len(cfg), prefix=prefix, enroll_frames=enroll_frames,
    )
    memory_peak = ctx.memory_peak()
    del enc, dec
    gc.collect()
    ctx.empty_cache()

    trace = capture.trace()
    served = [toks.get(f"u0-{j}", []) for j in check_rows]
    checks = beam_check(ctx, pool, [ds.rows[f"u0-{j}"] for j in check_rows], *trace, served)
    return SimpleNamespace(
        end_to_end={"decode_audio_s_per_gpu_s": res.audio_seconds / (wall * ctx.world)},
        attempted=attempted, failed=failed, obs=obs, memory_peak=memory_peak, checks=checks,
        detail={"batches": n_batches, "audio_s": res.audio_seconds, "window_wall_s": wall,
                "iterations": iters,
                "reorder_launches": [b - a for (a, _), (b, _) in zip(counts, counts[1:])],
                "grouped_cross_launches": [b - a for (_, a), (_, b) in zip(counts, counts[1:])],
                "batch_s": [round(b - a, 4) for a, b in zip(ds.requests, ds.requests[1:])],
                "stage_ms": [round(x, 1) for x in stage], "encoder_ms": [round(x, 1) for x in encoder_ms],
                "search_ms_per_step": [round(x, 2) for x in search]},
    )


class BeamCapture:
    """For ``rows`` (utterances) of window batch 0: the logits of their k
    rows as ``prefill`` and ``step`` return them (level 0 the prefill's,
    level i + 1 the i-th step's), the token each of those rows is fed at
    step i and the source row the cache reorder before step i gives it, in
    pinned host memory without a sync. Wraps the decoder instance's two
    methods and ``decode/search.py``'s ``beam_reorder_cache`` until
    ``remove``, and counts the step calls of every batch (``calls``)."""

    def __init__(self, dec, rows: List[int], k: int, max_new: int, state: dict, cuda: bool):
        from robustsq_whisper_torch.decode import search

        self.dec, self.search, self.state, self.k = dec, search, state, k
        self.levels = 0  # levels of batch 0 recorded so far
        self.calls: Dict[int, int] = {}
        n, V = len(rows), dec.dims.n_vocab
        dev = dec.decoder.token_embedding.weight.device
        self.logits = torch.empty((max_new, n * k, V), dtype=torch.float32, pin_memory=cuda)
        self.src = torch.full((max_new, n * k), -1, dtype=torch.int64, pin_memory=cuda)
        self.tok = torch.full((max_new, n * k), -1, dtype=torch.int64, pin_memory=cuda)
        self.utt = torch.tensor(rows, device=dev)
        self.beam_rows = (self.utt[:, None] * k + torch.arange(k, device=dev)).reshape(-1)
        self.first = (self.utt * k).repeat_interleave(k)
        self.orig = {"prefill": dec.prefill, "step": dec.step}
        self.reorder = search.beam_reorder_cache
        dec.prefill, dec.step = self._prefill, self._step
        search.beam_reorder_cache = self._reorder

    def _recording(self) -> bool:
        return self.state["batch"] == 0 and self.levels < len(self.logits)

    def _prefill(self, *args, **kw):
        logits, cache = self.orig["prefill"](*args, **kw)
        if self._recording() and self.levels == 0:
            rows = logits.index_select(0, self.utt).float().repeat_interleave(self.k, dim=0)
            self.logits[0].copy_(rows, non_blocking=True)
            self.levels = 1
        return logits, cache

    def _reorder(self, cache, src_rows, *args, **kw):
        if self._recording() and self.levels >= 1:
            self.src[self.levels - 1].copy_(src_rows.index_select(0, self.beam_rows).long() - self.first,
                                            non_blocking=True)
        return self.reorder(cache, src_rows, *args, **kw)

    def _step(self, token, *args, **kw):
        batch = self.state["batch"]
        self.calls[batch] = self.calls.get(batch, 0) + 1
        record = self._recording() and self.levels >= 1
        if record:
            self.tok[self.levels - 1].copy_(token[:, 0].index_select(0, self.beam_rows).long(),
                                            non_blocking=True)
        logits, cache = self.orig["step"](token, *args, **kw)
        if record:
            self.logits[self.levels].copy_(logits.index_select(0, self.beam_rows).float(), non_blocking=True)
            self.levels += 1
        return logits, cache

    def remove(self) -> None:
        del self.dec.prefill, self.dec.step
        self.search.beam_reorder_cache = self.reorder

    def trace(self):
        """(logits (levels, utterances, k, vocab), src and tok (levels - 1,
        utterances, k)) of batch 0, after a sync."""
        n, k = self.levels, self.k
        u = len(self.utt)
        return (self.logits[:n].view(n, u, k, -1), self.src[: n - 1].view(n - 1, u, k),
                self.tok[: n - 1].view(n - 1, u, k))


def paths(src: np.ndarray, tok: np.ndarray, u: int) -> Tuple[List[Tuple[int, int]], Callable]:
    """Utterance ``u``'s tree of rows: the rows no later row continues
    (every row of the last level, and each earlier row that no reorder
    picked), and ``walk(level, row)`` -> (its tokens, its row at every
    level)."""
    n, k = src.shape[0] + 1, src.shape[2]
    continued = np.zeros((n, k), bool)
    for i in range(n - 1):
        continued[i, src[i, u]] = True
    leaves = [(i, j) for i in range(n) for j in range(k) if i == n - 1 or not continued[i, j]]

    def walk(i: int, j: int):
        toks, rows = [], [j]
        for t in range(i, 0, -1):
            toks.append(int(tok[t - 1, u, j]))
            j = int(src[t - 1, u, j])
            rows.append(j)
        return toks[::-1], rows[::-1]

    return leaves, walk


@torch.no_grad()
def reference_tree(ctx, pool, rows: List[int], src: np.ndarray, tok: np.ndarray, served: List[List[int]],
                   block: int = 16):
    """The float32 reference's logits at every (level, utterance, row) of
    the recorded trees, teacher forced on each leaf's prefix, and each
    served hypothesis's summed reference log-prob (with eot where it
    stopped). Returns (logits (levels, utterances, k, vocab), served
    log-probs (utterances,), the number of sequences run)."""
    cfg, dev, sv = ctx.config, ctx.device, ctx.config["serving"]
    P = {n: v.float() for n, v in make_weights(param_specs(cfg, heads=False), ctx.seed, dev).items()}
    ref = Ref(P, cfg)
    init, eot, max_new = list(sv["init_tokens"]), sv["eot"], ctx.traffic["max_new_tokens"]
    first = len(init) - 1
    n, u_n, k = src.shape[0] + 1, src.shape[1], src.shape[2]
    out = torch.empty((n, u_n, k, cfg["whisper"]["n_vocab"]), device=dev)
    served_lp = torch.empty(u_n, device=dev)
    sp = torch.from_numpy(pcm16(pool["speech"][rows])).to(dev)
    er = torch.from_numpy(pcm16(pool["enroll"][rows])).to(dev)
    mel, mel_lens = log_mel(sp, torch.from_numpy(pool["speech_lens"][rows]).long().to(dev),
                            cfg["whisper"]["n_mels"])
    emel, emel_lens = log_mel(er, torch.from_numpy(pool["enroll_lens"][rows]).long().to(dev),
                              cfg["whisper"]["n_mels"])
    memory, _, prompt, _ = ref.encode(mel, mel_lens, emel, emel_lens, approx=sv["gelu_approx"])
    cross = ref.quantized_cross(memory, sv["cross_kv_bits"])
    del memory
    runs = 0

    def forward(u: int, seqs: List[List[int]]) -> torch.Tensor:
        """Logits at each generated position of ``seqs`` (equal lengths)."""
        m = len(seqs)
        x, prefix = ref.embed_prefixed(torch.tensor([init + s for s in seqs], device=dev),
                                       prompt[u:u + 1].expand(m, -1, -1))
        lg = ref.decode(x, cross=[(a[u:u + 1].expand(m, *a.shape[1:]), b[u:u + 1].expand(m, *b.shape[1:]))
                                  for a, b in cross])
        return lg[:, prefix + first:prefix + first + len(seqs[0]) + 1]

    for u in range(u_n):
        leaves, walk = paths(src, tok, u)
        filled = np.zeros((n, k), bool)
        for level in sorted({i for i, _ in leaves}):
            group = [walk(i, j) for i, j in leaves if i == level]
            for s in range(0, len(group), block):
                part = group[s:s + block]
                lg = forward(u, [t for t, _ in part])
                runs += len(part)
                for b_i, (_, path) in enumerate(part):
                    todo = [t for t, r in enumerate(path) if not filled[t, r]]
                    if todo:
                        idx = torch.tensor(todo, device=dev)
                        out[idx, u, torch.tensor([path[t] for t in todo], device=dev)] = lg[b_i, idx]
                        filled[todo, [path[t] for t in todo]] = True
        seq = served_with_eot(served[u], max_new, eot)
        lp = torch.log_softmax(forward(u, [seq])[0, : len(seq)], dim=-1)
        served_lp[u] = lp.gather(1, torch.tensor(seq, device=dev)[:, None]).sum()
        runs += 1
    return out, served_lp, runs


def beam_numbers(ref_logits: torch.Tensor, logits: torch.Tensor, src: torch.Tensor, tok: torch.Tensor,
                 served_lp: torch.Tensor, eot: int) -> Dict[str, float]:
    """``logit_err``, ``select_gap`` and ``score_gap`` of one recorded trace
    (``logits`` (levels, utterances, k, vocab), ``src`` and ``tok``
    (levels - 1, utterances, k), on the reference's device) against the
    reference's logits at the same rows.

    A step's candidates are scored twice: by the reference's summed
    log-probs of the whole hypothesis (``score_gap``'s final beams), and,
    for ``select_gap``, by the score the program carried into the step
    (its own summed log-probs, from its recorded logits) plus the
    reference's log-prob of the step's token. The second judges the step's
    selection alone: a hypothesis's reference score drifts from the
    program's over 128 bf16 steps, by tenths of a nat on sound runs, and
    that drift is ``score_gap``'s to bound."""
    n, u_n, k, V = ref_logits.shape
    dev = ref_logits.device
    err = max(logit_err(logits[i].reshape(u_n * k, V).to(dev), ref_logits[i].reshape(u_n * k, V))
              for i in range(n))
    eot_only = torch.full((V,), NEG, device=dev)
    eot_only[eot] = 0.0
    score = torch.full((u_n, k), NEG, device=dev)
    score[:, 0] = 0.0  # beam 0 alone is live at step 0
    carried = score.clone()  # the program's own scores
    done = torch.zeros((u_n, k), dtype=torch.bool, device=dev)

    def extend(scores, step_logits):
        lp = torch.where(done[..., None], eot_only, torch.log_softmax(step_logits, dim=-1))
        return (scores[..., None] + lp).reshape(u_n, k * V)

    gaps = []
    for i in range(n):
        cand = extend(score, ref_logits[i])
        if i == n - 1:
            best = cand.max(dim=-1).values
            break
        step = extend(carried, ref_logits[i])
        s, t = src[i].to(dev), tok[i].to(dev)
        kept = s * V + t
        kth = step.topk(k, dim=-1).values[:, -1]
        gaps.append(float((kth - step.gather(1, kept).min(dim=-1).values).max()))
        score = cand.gather(1, kept)
        carried = extend(carried, logits[i].to(dev)).gather(1, kept)
        done = done.gather(1, s) | (t == eot)
    return {"logit_err": err, "select_gap": max(gaps) if gaps else 0.0,
            "score_gap": float((best - served_lp).max())}


def beam_check(ctx, pool, rows: List[int], logits: torch.Tensor, src: torch.Tensor, tok: torch.Tensor,
               served: List[List[int]]) -> Dict[str, dict]:
    """``rows``: the sampled pool rows (window batch 0); ``logits``, ``src``
    and ``tok``: their recorded trace; ``served``: their served tokens."""
    ctx.reference_mode()
    n, k = logits.shape[0], logits.shape[2]
    over = f"{n} steps x {k} beams of {len(rows)} utterances of window batch 0"
    if n == 0 or bool((src < 0).any()) or bool((tok < 0).any()):
        # a step without a recorded reorder: the loop took another route
        return {name: {"value": None, "limit": ctx.limits[name], "rule": "at most",
                       "over": over + ": no row map recorded"} for name in ("logit_err", "select_gap", "score_gap")}
    ref_logits, served_lp, runs = reference_tree(ctx, pool, rows, src.numpy(), tok.numpy(), served)
    numbers = beam_numbers(ref_logits, logits, src, tok, served_lp, ctx.config["serving"]["eot"])
    over += f", {runs} reference sequences"
    return {name: {"value": v, "limit": ctx.limits[name], "rule": "at most", "over": over}
            for name, v in numbers.items()}
