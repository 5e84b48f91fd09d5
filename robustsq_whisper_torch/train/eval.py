"""Validation pass, valid WER, n-best tracking and checkpoint averaging.

The JAX package's ``train/eval.py`` for the port. The reference trains
through ESPnet's trainer, which validates every epoch, keeps the n best
checkpoints by ``valid.acc`` and decodes from their average
(``valid.acc.ave``); this module is that half of the trainer:

- ``evaluate``: the training model's ``train=False`` forward (dropout and
  SpecAugment off) under ``torch.no_grad``, batch-weighted mean stats read
  once, after the pass;
- ``ValidWer``: greedy decode of the first ``n_utts`` validation
  utterances through the serving modules of ``cli.decode`` (the Qformer
  or the embedding-enrollment encoder, as the model's), built once and
  loaded with each epoch's weights, scored with the decode scorer;
- ``NBestTracker``: the n best ``(step, epoch, metric)``, persisted as
  ``nbest.json`` byte for byte as the JAX package writes it;
- ``average_checkpoints`` / ``write_averaged_checkpoint``: the float64
  running mean of the n-best checkpoints, saved under ``{ckpt_dir}/ave``
  (``cli.decode --use_ave`` reads it).

On a mesh (``TrainState.mesh``) the validation pass runs each rank's rows
of every batch, as a training step does, and its stats are the whole
batch's; the valid WER decodes over the data axis (``decode_dataset``'s
mesh) when the model axis is 1, and the whole subset on every rank else,
from the whole weights every rank gathers (``eval_params``).

What is averaged is what the JAX package averages, its f32 parameters and
LoRA factors: here each parameter's f32 optimizer master where it has one
(a trainable parameter held in bf16), else the stored parameter, and the
factors. The averaged checkpoint holds the mean masters and their cast to
each parameter's dtype. A tensor that is the same in every checkpoint (a
frozen backbone weight) is its own mean, bit for bit, and is never copied
to float64.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..decode.pipeline import decode_dataset, serving_modules
from ..parallel.mesh import MODEL_AXIS, axis_size, local_rows, rank, use_mesh
from ..parallel.shard import full_tensor
from ..models.ts_decoder import TSDecoder
from .checkpoint import read_payload, write_payload
from .lora import merge_lora
from .step import TrainConfig, TrainState

AVE_SUBDIR = "ave"
NBEST_FILE = "nbest.json"

Tensors = Dict[str, torch.Tensor]


def to_device(batch: Dict[str, Any], device) -> Tensors:
    """A collated numpy batch on ``device`` (``utt_ids`` dropped): each
    array crosses once, from pinned memory and without blocking the host
    when the device is a GPU."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        if k == "utt_ids":
            continue
        t = torch.from_numpy(v)
        out[k] = t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t
    return out


def eval_params(state: TrainState, tcfg: TrainConfig) -> Tensors:
    """The serving / eval view of the state's parameters: the model's, with
    the LoRA factors merged (``merge_lora``) in mode ``lora``; whole tensors
    on a mesh (every rank calls this: it gathers)."""
    params = {n: full_tensor(state.layout, n, p.detach())
              for n, p in state.model.named_parameters()}
    if tcfg.mode == "lora" and state.lora:
        lora = {n: (a.detach(), b.detach()) for n, (a, b) in state.lora.items()}
        return merge_lora(params, lora, tcfg.lora)
    return params


@torch.no_grad()
def evaluate(
    state: TrainState,
    dataset: Any,  # KaldiTSDataset-like
    batch_size: int,
    epoch: int,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, float]:
    """One validation pass of the training model; returns the stats' means
    weighted by batch size. The model keeps its LoRA factors attached (the
    forward then computes with the merged weights); nothing of it changes.
    ``generator`` draws the contrastive negatives, which the reference
    samples at eval too; pass a fixed one so that epochs compare."""
    from .step import _mean_stats

    model, mesh = state.model, state.mesh
    dev = next(model.parameters()).device
    pending: List[Tuple[int, Tensors]] = []
    for batch in dataset.batches(batch_size, shuffle=False):
        b = len(batch["utt_ids"])
        with use_mesh(mesh):
            _, stats = model(local_rows(to_device(batch, dev), mesh), generator, epoch,
                             train=False)
        if state.layout is not None:
            stats = _mean_stats(stats, state.layout.data_group)
        pending.append((b, stats))
    totals: Dict[str, float] = {}
    n_total = 0
    for b, stats in pending:  # one host sync, after the whole pass
        for k, v in stats.items():
            totals[k] = totals.get(k, 0.0) + float(v) * b
        n_total += b
    return {k: v / n_total for k, v in totals.items()} if n_total else {}


class ValidWer:
    """Per-epoch greedy-decode WER on the first ``n_utts`` validation
    utterances: the stage-12 metric, of which ``valid.acc`` is a proxy.

    The serving encoder and decoder are built once, at the first call, by
    ``decode.pipeline.serving_modules`` (what ``cli.decode`` serves with)
    on the training model's device in its compute dtype, the encoder in
    the time-major flash layout where the model uses flash attention, as
    ``cli.decode`` serves by default; each later call copies the epoch's
    eval weights into them. ``decode_dataset`` decodes. The training model
    is not touched."""

    def __init__(self, model: Any, dcfg: Any = None, n_utts: int = 64):
        from ..decode.search import DecodeConfig

        cfg = model.cfg
        if dcfg is None:
            dcfg = DecodeConfig(max_new_tokens=64, eot=cfg.eos, init_tokens=(cfg.sos,))
        if dcfg.quantize_weights:
            raise ValueError("eval-time WER decodes dense weights")
        if dcfg.speculative_gamma:
            raise ValueError("eval-time WER is plain greedy or beam search")
        if dcfg.ctc_decode_weight:
            raise ValueError("eval-time WER is attention-only; strip ctc_decode_weight")
        if max(dcfg.init_tokens) >= cfg.vocab_size:
            raise ValueError(f"init_tokens {dcfg.init_tokens} exceed the model vocab "
                             f"({cfg.vocab_size}); use the model's sos")
        self.dcfg, self.n_utts = dcfg, n_utts
        self.last_hyps: Dict[str, str] = {}
        self.model = model
        self.modules: Optional[Tuple[Any, TSDecoder]] = None

    @torch.no_grad()
    def load(self, weights: Tensors) -> None:
        """Copy a ``TSASRModel``'s ``encoder.`` and ``decoder.`` weights in,
        building the serving modules from them on the first call."""
        if self.modules is None:
            model = self.model
            ts = dataclasses.replace(
                model.ts, flash_tmaj=model.ts.use_flash_attention, remat=False)
            self.modules = serving_modules(
                model.dims, ts, model.cfg, {**model.state_dict(), **weights},
                model.decoder.decoder.token_embedding.weight.dtype,
                next(model.parameters()).device,
            )
            return
        for prefix, module in zip(("encoder.", "decoder."), self.modules):
            for name, p in module.named_parameters():
                p.copy_(weights[prefix + name])

    def __call__(
        self, state: TrainState, tcfg: TrainConfig, dataset: Any, batch_size: int,
    ) -> Dict[str, float]:
        self.load(eval_params(state, tcfg))
        sub = copy.copy(dataset)
        if self.n_utts > 0:
            sub.utt_ids = dataset.utt_ids[: self.n_utts]
        encoder, decoder = self.modules
        mesh = state.mesh if axis_size(state.mesh, MODEL_AXIS) == 1 else None
        res = decode_dataset(
            encoder, decoder, sub, dataset.tokenizer, self.dcfg,
            batch_size=batch_size, device=next(encoder.parameters()).device, mesh=mesh,
        )
        self.last_hyps = res.hyps
        return {k: float(res.metrics[k]) for k in ("wer", "cer") if k in res.metrics}


@dataclasses.dataclass
class NBestEntry:
    step: int
    epoch: int
    metric: float


class NBestTracker:
    """Keeps the n best (step, valid acc) checkpoints, persisted as JSON next
    to the checkpoints (the ESPnet ``valid.acc.best`` bookkeeping). The
    file names its metric and mode, as the JAX package's does; a file read
    back keeps them. Under several processes only rank 0 writes it."""

    def __init__(self, ckpt_dir: str, nbest: int = 5):
        self.ckpt_dir = ckpt_dir
        self.nbest = nbest
        self.metric = "acc"
        self.mode = "max"
        self.entries: List[NBestEntry] = []
        self._load()

    @property
    def path(self) -> str:
        return os.path.join(self.ckpt_dir, NBEST_FILE)

    def _load(self) -> None:
        if os.path.isfile(self.path):
            with open(self.path) as f:
                d = json.load(f)
            self.metric = d.get("metric", self.metric)
            self.mode = d.get("mode", self.mode)
            self.entries = [NBestEntry(**e) for e in d.get("entries", [])]

    def _save(self) -> None:
        if rank() != 0:
            return
        os.makedirs(self.ckpt_dir, exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(
                {
                    "metric": self.metric,
                    "mode": self.mode,
                    "entries": [dataclasses.asdict(e) for e in self.entries],
                },
                f,
                indent=1,
            )

    def _sort_key(self, e: NBestEntry) -> float:
        return -e.metric if self.mode == "max" else e.metric

    def update(self, step: int, epoch: int, value: float) -> bool:
        """Record an epoch result; returns True if it is a new best."""
        self.entries = [e for e in self.entries if e.step != step]
        self.entries.append(NBestEntry(step=step, epoch=epoch, metric=value))
        self.entries.sort(key=self._sort_key)
        is_best = self.entries[0].step == step
        self.entries = self.entries[: self.nbest]
        self._save()
        return is_best

    def best(self) -> Optional[NBestEntry]:
        return self.entries[0] if self.entries else None

    def steps(self) -> List[int]:
        return [e.step for e in self.entries]

    def epochs_since_best(self, current_epoch: int) -> int:
        b = self.best()
        return current_epoch - b.epoch if b else 0


class _RunningMean:
    """Running mean ``a + (b - a) / (i + 1)`` of a tensor over checkpoints,
    in float64 from the first checkpoint that differs from the first one
    (until then the mean is the first tensor itself, exactly)."""

    def __init__(self, first: torch.Tensor):
        self.first, self.acc = first, None

    def add(self, x: torch.Tensor, i: int) -> None:
        if self.acc is None:
            if torch.equal(x, self.first):
                return
            self.acc = self.first.double()
        self.acc += (x.double() - self.acc) / (i + 1)

    def mean(self, dtype: torch.dtype) -> torch.Tensor:
        return self.first.to(dtype) if self.acc is None else self.acc.to(dtype)


def _masters(raw: Dict[str, Any]) -> Dict[str, int]:
    """{parameter name: index in ``opt["masters"]``} of each parameter with
    an f32 master of its own (``opt["names"]`` names the optimizer's
    tensors; a checkpoint written without them averages its parameters)."""
    names, masters = raw["opt"].get("names", []), raw["opt"]["masters"]
    return {n: i for i, n in enumerate(names) if n in raw["params"] and masters[i] is not None}


def average_checkpoints(ckpt_dir: str, steps: List[int]) -> Dict[str, Any]:
    """The payload of the float64 running mean of the checkpoints at
    ``steps`` (ESPnet's ``valid.acc.ave`` model): mean masters (a
    parameter's own value where it has none) and LoRA factors, each
    parameter the mean master in its dtype. Buffers, the optimizer's
    moments, the epoch and the generator come from the last step (buffers
    do not train; the moments mean nothing for an average)."""
    if not steps:
        raise ValueError("no checkpoints to average")
    means: Dict[Tuple[str, ...], _RunningMean] = {}
    raw = None
    for i, s in enumerate(sorted(steps)):
        raw, _ = read_payload(ckpt_dir, s)
        masters = _masters(raw)
        values = {("params", n): raw["opt"]["masters"][masters[n]] if n in masters else p
                  for n, p in raw["params"].items()}
        for n, ab in raw["lora"].items():
            values[("lora", n, "a")], values[("lora", n, "b")] = ab
        if i == 0:
            means = {k: _RunningMean(v) for k, v in values.items()}
        elif values.keys() != means.keys():
            raise ValueError(f"checkpoint step {s} holds other tensors than step {min(steps)}")
        else:
            for k, v in values.items():
                means[k].add(v, i)
        del values
    masters = _masters(raw)
    out = dict(raw, opt=dict(raw["opt"], masters=list(raw["opt"]["masters"])))
    params = {}
    for n, p in raw["params"].items():
        mean = means[("params", n)]
        if n in masters:
            out["opt"]["masters"][masters[n]] = mean.mean(torch.float32)
        params[n] = mean.mean(p.dtype)
    out["params"] = params
    out["lora"] = {n: [means[("lora", n, "a")].mean(a.dtype), means[("lora", n, "b")].mean(b.dtype)]
                   for n, (a, b) in raw["lora"].items()}
    return out


def write_averaged_checkpoint(ckpt_dir: str, tracker: NBestTracker) -> Optional[str]:
    """Average the tracked n-best and save it under ``{ckpt_dir}/ave`` as
    step ``len(steps)`` (ESPnet's ``ave_5best``); returns its directory."""
    steps = tracker.steps()
    if not steps:
        return None
    payload = average_checkpoints(ckpt_dir, steps)
    return write_payload(os.path.join(ckpt_dir, AVE_SUBDIR), len(steps), payload, keep=1)
