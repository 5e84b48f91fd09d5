"""The epoch training loop: the ESPnet trainer's part of the recipe's stage 11.

The JAX package's ``train/loop.py`` for the port, in its order:

- every epoch shuffles the dataset and threads the epoch into the step (the
  AAM margin and ASP gamma warm-ups read it);
- stats stay device tensors until the ``log_every`` boundary, and the step
  index is a host counter: reading a value every step would make the host
  wait for each step before it reads the next batch;
- a checkpoint every ``ckpt_every_steps`` steps and at the end of an epoch
  (``ckpt_every_epochs``, always the last one and every one when n-best
  selection runs), the latter replacing a mid-epoch save of the same step;
- a resume from the latest checkpoint continues at its epoch (saved as
  ``epoch + 1`` at an epoch's end) with the optimizer's counts and the
  generator's state;
- with a validation set, per epoch: the validation pass (its contrastive
  negatives drawn from a generator seeded 0, the same every epoch), the
  valid WER (``wer_utts``), the n-best update, pruning that keeps the
  n-best steps, ``patience`` early stopping, and at the end the averaged
  ``ave`` checkpoint.

The JAX ``rng`` is one ``torch.Generator`` on the training device: SpecAugment,
dropout and the negative sampling draw from it, and checkpoints save its
state. ``metrics_hook(step, values)`` receives the JAX package's records
(the logged means with ``steps_per_sec`` and ``epoch``; ``valid.*`` with
``epoch``) and, last, ``seconds.*``: the loop's wall time in training,
validation, valid WER, checkpoint saves, the restore and the averaging.

On a ``(data, model)`` mesh (one process per GPU, every rank running this
loop over the same shuffled dataset) each step takes its rows of the global
batch (``train/step.py``); the stats, the validation pass and the valid WER
are the whole batch's on every rank, so every rank takes the same
decisions; the checkpoints are gathered and rank 0 writes them, prunes
them, keeps ``nbest.json`` and writes the average. ``TrainConfig.fsdp``
shards the parameters' storage over the data axis.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Optional

import torch

from .._device import resolve_device
from ..parallel.mesh import DATA_AXIS, axis_size, describe, rank
from .checkpoint import latest_step, prune_checkpoints, restore_checkpoint, save_checkpoint
from .eval import NBestTracker, ValidWer, evaluate, to_device, write_averaged_checkpoint
from .lora import Factors
from .step import TrainConfig, TrainState, create_train_state, make_train_step

logger = logging.getLogger("robustsq_whisper_torch.train")


@dataclasses.dataclass
class LoopConfig:
    num_epochs: int = 10
    batch_size: int = 8
    log_every: int = 50
    ckpt_every_steps: int = 1000
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    # epoch-end checkpoint cadence; the last epoch always saves
    ckpt_every_epochs: int = 1
    # validation / model selection (ESPnet semantics)
    nbest: int = 5  # checkpoints kept and averaged, ranked by valid acc
    patience: int = 0  # epochs without a new best before stopping; 0 = off
    # per-epoch greedy-decode WER on the first N valid utterances (valid.wer);
    # 0 = off
    wer_utts: int = 0
    wer_decode: Optional[Any] = None  # DecodeConfig of that pass


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_training(
    model: Any,
    dataset: Any,  # KaldiTSDataset-like: .batches(batch_size, shuffle)
    tcfg: TrainConfig = TrainConfig(),
    lcfg: LoopConfig = LoopConfig(),
    generator: Optional[torch.Generator] = None,
    metrics_hook: Optional[Callable[[int, Dict[str, float]], None]] = None,
    valid_dataset: Optional[Any] = None,
    device="cuda",
    seed: int = 0,
    lora: Optional[Factors] = None,
    mesh=None,
) -> TrainState:
    """Train ``model`` (a TSASRModel in its compute dtype) over ``dataset``
    for ``lcfg.num_epochs`` epochs and return the final state.
    ``generator``: the training draws' generator, on ``device`` (default:
    seeded 0); ``seed`` / ``lora``: the LoRA factors' seed or the factors
    themselves (``create_train_state``). ``mesh``: the ``(data, model)``
    mesh to train on (the model is sharded over it)."""
    dev = resolve_device(device)
    n_data = axis_size(mesh, DATA_AXIS)
    if lcfg.batch_size % n_data:
        raise ValueError(f"batch_size {lcfg.batch_size} must be a multiple of the "
                         f"data-axis size ({n_data})")
    gen = generator if generator is not None else torch.Generator(dev).manual_seed(0)
    state = create_train_state(model, tcfg, seed=seed, device=dev, lora=lora, mesh=mesh)
    step_fn = make_train_step(model, tcfg, device=dev, mesh=mesh)
    if mesh is not None:
        logger.info("training on a mesh (%s, fsdp %s)", describe(mesh), tcfg.fsdp)
    seconds = dict.fromkeys(("train", "valid", "valid_wer", "save", "restore", "average"), 0.0)
    start_epoch = 0

    if lcfg.ckpt_dir and latest_step(lcfg.ckpt_dir) is not None:
        t0 = time.perf_counter()
        state, start_epoch, gen_state = restore_checkpoint(lcfg.ckpt_dir, state)
        if gen_state is not None:
            try:
                gen.set_state(gen_state)
            except RuntimeError as e:
                raise RuntimeError(
                    f"the checkpoint's generator state does not fit a {gen.device.type} "
                    "generator: resume on the device type that saved it") from e
        seconds["restore"] = time.perf_counter() - t0
        logger.info("resumed from %s at step %d epoch %d", lcfg.ckpt_dir, state.step, start_epoch)

    wer_pass = tracker = None
    if valid_dataset is not None:
        if lcfg.wer_utts > 0:
            wer_pass = ValidWer(model, lcfg.wer_decode, n_utts=lcfg.wer_utts)
        if lcfg.ckpt_dir:
            tracker = NBestTracker(lcfg.ckpt_dir, lcfg.nbest)
    # rolling retention is manual when the n-best steps must be kept
    save_keep = None if tracker is not None else lcfg.keep_ckpts

    def save(epoch: int, overwrite: bool = False, prune: bool = False) -> None:
        t0 = time.perf_counter()
        save_checkpoint(lcfg.ckpt_dir, state.step, state, epoch, gen, save_keep,
                        overwrite=overwrite)
        if prune and tracker is not None and rank() == 0:
            prune_checkpoints(lcfg.ckpt_dir, lcfg.keep_ckpts, protected=tracker.steps())
        seconds["save"] += time.perf_counter() - t0

    pending: list = []
    step = state.step
    t_last = time.time()

    for epoch in range(start_epoch, lcfg.num_epochs):
        t_epoch = time.perf_counter()
        for batch in dataset.batches(lcfg.batch_size, shuffle=True):
            state, stats = step_fn(state, to_device(batch, dev), gen, epoch)
            step += 1
            pending.append(stats)
            if step % lcfg.log_every == 0:
                running: Dict[str, float] = {}
                for st in pending:
                    for k, v in st.items():
                        running[k] = running.get(k, 0.0) + float(v)
                avg = {k: v / len(pending) for k, v in running.items()}
                sps = len(pending) / max(time.time() - t_last, 1e-9)
                logger.info(
                    "epoch %d step %d %s steps/s %.2f", epoch, step,
                    " ".join(f"{k}={v:.4f}" for k, v in sorted(avg.items())), sps,
                )
                if metrics_hook:
                    metrics_hook(step, {**avg, "steps_per_sec": sps, "epoch": epoch})
                pending, t_last = [], time.time()
            if lcfg.ckpt_dir and lcfg.ckpt_every_steps and step % lcfg.ckpt_every_steps == 0:
                seconds["train"] += time.perf_counter() - t_epoch
                save(epoch, prune=True)
                t_epoch = time.perf_counter()
        _synchronize(dev)
        seconds["train"] += time.perf_counter() - t_epoch

        if lcfg.ckpt_dir and (
            tracker is not None  # n-best averaging needs every epoch's step
            or (epoch + 1) % max(1, lcfg.ckpt_every_epochs) == 0
            or epoch + 1 == lcfg.num_epochs
        ):
            # replaces a mid-epoch save of this step (this run's or an
            # earlier one's) with the epoch-end metadata: epoch + 1, so a
            # resume starts the next epoch
            save(epoch + 1, overwrite=True)

        if valid_dataset is not None:
            t0 = time.perf_counter()
            eval_gen = torch.Generator(dev).manual_seed(0)
            vstats = evaluate(state, valid_dataset, lcfg.batch_size, epoch, eval_gen)
            seconds["valid"] += time.perf_counter() - t0
            if wer_pass is not None:
                t0 = time.perf_counter()
                vstats.update(wer_pass(state, tcfg, valid_dataset, lcfg.batch_size))
                seconds["valid_wer"] += time.perf_counter() - t0
            logger.info("epoch %d valid %s", epoch,
                        " ".join(f"{k}={v:.4f}" for k, v in sorted(vstats.items())))
            if metrics_hook:
                metrics_hook(state.step, {**{f"valid.{k}": v for k, v in vstats.items()},
                                          "epoch": epoch})
            if tracker is not None and "acc" in vstats:
                if tracker.update(state.step, epoch, vstats["acc"]):
                    logger.info("epoch %d new best valid.acc=%.4f", epoch, vstats["acc"])
                if rank() == 0:
                    prune_checkpoints(lcfg.ckpt_dir, lcfg.keep_ckpts, protected=tracker.steps())
                since = tracker.epochs_since_best(epoch)
                if lcfg.patience and since >= lcfg.patience:
                    logger.info("early stop: no valid.acc improvement for %d epochs", since)
                    break

    if tracker is not None and tracker.steps() and rank() == 0:
        t0 = time.perf_counter()
        path = write_averaged_checkpoint(lcfg.ckpt_dir, tracker)
        seconds["average"] = time.perf_counter() - t0
        logger.info("averaged %d-best checkpoint (valid.acc) written to %s",
                    len(tracker.steps()), path)
    logger.info("loop seconds: %s", " ".join(f"{k}={v:.2f}" for k, v in seconds.items()))
    if metrics_hook:
        metrics_hook(state.step, {f"seconds.{k}": v for k, v in seconds.items()})
    return state
