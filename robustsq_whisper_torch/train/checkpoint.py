"""Checkpoint save / restore in the port's own format.

The JAX package's ``train/checkpoint.py`` semantics over ``torch.save``:
a checkpoint is ``{ckpt_dir}/{step}/state.pt``, written with
``torch.save`` and read with ``torch.load(weights_only=True)``, holding the
``TrainState``'s parameters, buffers, LoRA factors, optimizer state and
step, the epoch and the ``torch.Generator`` state (the training schedules
read the epoch, so a resume must restore it). A duplicate step raises
unless ``overwrite``; the retention (``keep``) and ``prune_checkpoints``
never delete the latest step. Serving reads weights only
(``restore_weights``, ``restore_serving_variables``).

A state sharded over a mesh (``TrainState.layout``) is saved whole: every
rank gathers each tensor (``parallel.shard.full_tensor``) and rank 0 writes
the same payload one device writes. A restore takes each rank's part of the
whole tensors, so a checkpoint moves between one device and any mesh.

The JAX package's checkpoints are Orbax directories, which need
tensorstore to read; they are not read here. Its weights come over
through ``convert.flax_to_state_dict`` (read them with the JAX package,
map them, and ``save_checkpoint`` them in this format).
"""

from __future__ import annotations

import logging
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..parallel.mesh import rank, world_size
from ..parallel.shard import full_tensor, local_part
from .lora import Factors, merge_lora
from .step import TrainState

STATE_FILE = "state.pt"

Tensors = Dict[str, torch.Tensor]


def all_steps(ckpt_dir: str) -> List[int]:
    """The steps saved under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(d) for d in os.listdir(ckpt_dir)
        if d.isdigit() and os.path.isfile(os.path.join(ckpt_dir, d, STATE_FILE))
    )


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _delete(ckpt_dir: str, step: int) -> None:
    shutil.rmtree(os.path.join(ckpt_dir, str(step)))


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _opt_names(state: TrainState) -> List[str]:
    """What each optimizer tensor belongs to: a parameter's name, or a
    LoRA factor's ``lora:<weight>:a|b``."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    for n, (a, b) in state.lora.items():
        names[id(a)], names[id(b)] = f"lora:{n}:a", f"lora:{n}:b"
    return [names[id(p)] for p in state.opt.params]


def _opt_state(state: TrainState) -> Dict[str, Any]:
    opt, layout = state.opt, state.layout
    names = _opt_names(state)
    whole = lambda ts: [_host(full_tensor(layout, n, t)) for n, t in zip(names, ts)]
    return {
        "names": names,
        "count": int(opt.count),
        "mini_step": int(opt.mini_step),
        # an f32 parameter is its own master: stored once, under params
        "masters": [None if m is p else _host(full_tensor(layout, n, m))
                    for n, m, p in zip(names, opt.masters, opt.params)],
        "mu": whole(opt.mu),
        "nu": whole(opt.nu),
        "acc": whole(opt.acc),
    }


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    state: TrainState,
    epoch: int,
    generator: Optional[torch.Generator] = None,
    keep: Optional[int] = 3,
    overwrite: bool = False,
) -> str:
    """Write ``state`` as step ``step``; returns the step's directory.
    ``keep`` most recent steps stay (``None``: keep all, the caller prunes,
    e.g. ``prune_checkpoints`` protecting the n-best steps). On a mesh
    every rank calls this and rank 0 writes."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    if step in all_steps(ckpt_dir) and not overwrite:
        raise ValueError(
            f"checkpoint step {step} already exists in {ckpt_dir}; "
            "pass overwrite=True to replace it"
        )
    model, layout = state.model, state.layout
    persistent = set(model.state_dict())
    payload = {
        "params": {n: _host(full_tensor(layout, n, p)) for n, p in model.named_parameters()},
        "buffers": {n: _host(b) for n, b in model.named_buffers() if n in persistent},
        "lora": {n: [_host(a), _host(b)] for n, (a, b) in state.lora.items()},
        "opt": _opt_state(state),
        "step": int(state.step),
        "epoch": int(epoch),
        "generator": None if generator is None else generator.get_state(),
    }
    if rank() != 0:
        path = os.path.join(ckpt_dir, str(step))
    else:
        path = write_payload(ckpt_dir, step, payload, keep)
    if world_size() > 1:
        torch.distributed.barrier()
    return path


def write_payload(
    ckpt_dir: str, step: int, payload: Dict[str, Any], keep: Optional[int] = 3,
) -> str:
    """Write a checkpoint's payload (``save_checkpoint``'s dict) as step
    ``step``, replacing one there, then apply the retention ``keep``."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    # written beside the step and renamed into place: a step directory
    # always holds a whole checkpoint
    tmp = os.path.join(ckpt_dir, f".tmp-{step}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    final = os.path.join(ckpt_dir, str(step))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    if keep is not None:
        steps = all_steps(ckpt_dir)
        for s in steps[: max(0, len(steps) - max(keep, 1))]:
            _delete(ckpt_dir, s)
    return final


def prune_checkpoints(ckpt_dir: str, keep: int, protected: Any = ()) -> None:
    """Delete the oldest steps that are not ``protected`` beyond ``keep``;
    the latest step is always protected."""
    steps = all_steps(ckpt_dir)
    if not steps:
        return
    protected = set(protected) | {steps[-1]}
    deletable = [s for s in steps if s not in protected]
    for s in deletable[: max(0, len(deletable) - keep)]:
        _delete(ckpt_dir, s)


def read_payload(ckpt_dir: str, step: Optional[int] = None) -> Tuple[Dict[str, Any], int]:
    """A checkpoint's payload on the host and its step (the latest when
    ``step`` is None)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, str(step), STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True), step


def restore_weights(
    ckpt_dir: str, step: Optional[int] = None
) -> Tuple[Tensors, Tensors, Factors, int, int]:
    """Serving-path restore: ``(params, buffers, lora, step, epoch)`` as
    host tensors (no optimizer state, no model)."""
    raw, _ = read_payload(ckpt_dir, step)
    lora = {n: (a, b) for n, (a, b) in raw["lora"].items()}
    return raw["params"], raw["buffers"], lora, int(raw["step"]), int(raw["epoch"])


def restore_serving_variables(
    ckpt_dir: str,
    compute_dtype: torch.dtype,
    train_cfg: Any,
    step: Optional[int] = None,
) -> Tuple[Tensors, int, int]:
    """Serving restore shared by ``cli.decode`` and ``cli.serve``: the
    weights read to the host, every f32 parameter (and the LoRA factors)
    cast to ``compute_dtype`` there, before any device copy, and the LoRA
    factors merged into their weights (``train.lora.merge_lora``) when the
    checkpoint trained adapters. Returns ``(state_dict, step, epoch)``: the
    model's state dict, buffers as stored."""
    params, buffers, lora, step_i, epoch = restore_weights(ckpt_dir, step)

    def host_cast(x: torch.Tensor) -> torch.Tensor:
        return x.to(compute_dtype) if x.dtype == torch.float32 else x

    params = {n: host_cast(p) for n, p in params.items()}
    if train_cfg.mode == "lora" and lora:
        lora = {n: (host_cast(a), host_cast(b)) for n, (a, b) in lora.items()}
        params = merge_lora(params, lora, train_cfg.lora)
    return {**params, **buffers}, step_i, epoch


def restore_checkpoint(
    ckpt_dir: str, state: TrainState, step: Optional[int] = None
) -> Tuple[TrainState, int, Optional[torch.Tensor]]:
    """Restore into ``state`` (built by ``create_train_state`` for the same
    model and config) in place; returns ``(state, epoch, generator_state)``
    (``torch.Generator.set_state`` takes the last).

    When the stored optimizer state does not fit ``state``'s (another mode
    or LoRA layout), the weights alone are restored and the optimizer keeps
    its fresh moments, as the JAX package does."""
    raw, step = read_payload(ckpt_dir, step)
    model, layout = state.model, state.layout
    part = lambda n, t: local_part(layout, n, t)
    with torch.no_grad():
        own = dict(model.named_parameters())
        own.update((n, b) for n, b in model.named_buffers() if n in raw["buffers"])
        missing = set(own) - set(raw["params"]) - set(raw["buffers"])
        if missing:
            raise KeyError(f"checkpoint step {step} lacks {sorted(missing)[:3]}")
        for n, t in own.items():
            t.copy_(part(n, raw["params"][n]) if n in raw["params"] else raw["buffers"][n])
        for n, (a, b) in state.lora.items():
            a.copy_(raw["lora"][n][0])
            b.copy_(raw["lora"][n][1])
        opt, saved = state.opt, raw["opt"]
        names = _opt_names(state)
        shapes = [tuple(m.shape) for m in opt.mu]
        if (
            set(raw["lora"]) == set(state.lora)
            and len(saved["mu"]) == len(names)
            and [tuple(part(n, m).shape) for n, m in zip(names, saved["mu"])] == shapes
            and len(saved["acc"]) == len(opt.acc)
        ):
            for n, p, m, sm in zip(names, opt.params, opt.masters, saved["masters"]):
                # an f32 parameter is its own master; others take theirs
                if m is not p:
                    m.copy_(part(n, sm))
            per_name = names * 3
            for n, dst, src in zip(per_name, opt.mu + opt.nu + opt.acc,
                                   saved["mu"] + saved["nu"] + saved["acc"]):
                dst.copy_(part(n, src))
            opt.count, opt.mini_step = int(saved["count"]), int(saved["mini_step"])
        else:
            logging.warning(
                "optimizer state layout mismatch in %s step %s; restoring weights "
                "only (optimizer moments reset)", ckpt_dir, step,
            )
            for m, p in zip(opt.masters, opt.params):
                if m is not p:
                    m.copy_(p.float())
    state.step = int(raw["step"])
    return state, int(raw["epoch"]), raw["generator"]
