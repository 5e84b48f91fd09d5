"""The training step: loss, gradients, clip + AdamW.

Mirrors the JAX package's ``train/step.py`` on one device. Three modes:

- ``full``: every parameter trains;
- ``lora``: rank-r factors on the attention projections (``train/lora.py``)
  plus the newly initialised target-speaker modules (``FROZEN_BACKBONE_
  TRAINABLE``: Qformer, prompt projection, CTC, ASP, AAM) train; the
  Whisper backbone stays frozen;
- ``frozen_backbone``: only those target-speaker modules train.

Frozen parameters get ``requires_grad=False``, so the backward computes no
weight gradient for them (the PyTorch form of the JAX package's
``split_by_mask``); the gradient still flows through them to what trains.

``create_train_state(model, cfg)`` moves the model to the device, freezes,
attaches LoRA and builds the optimizer; ``make_train_step(model, cfg)``
returns ``step(state, batch, generator, epoch) -> (state, stats)``, which
updates the state in place. ``stats`` are the model's plus ``grad_norm``,
the norm of the unclipped gradients. ``state.step`` counts micro-steps
(with ``accum_grad = k`` the parameters change on every k-th). Both entry
points default to ``device="cuda"`` and raise without CUDA. FSDP and
meshes are ROADMAP A15.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device
from .lora import Factors, LoraConfig, attach_lora, init_lora
from .optim import AdamW, OptimConfig, global_norm

FROZEN_BACKBONE_TRAINABLE = (
    r".*(qformer|prompt_proj|ctc|asp|aam|adapter|cln|query_tokens).*"
)
MODES = ("full", "lora", "frozen_backbone")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    mode: str = "full"  # full | lora | frozen_backbone
    optim: OptimConfig = OptimConfig()
    lora: LoraConfig = LoraConfig()
    accum_grad: int = 1
    fsdp: bool = False


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    lora: Factors  # {} unless mode == "lora"
    trainables: List[torch.Tensor]  # what the optimizer updates, in order
    opt: AdamW


def trainable_mask(model: nn.Module, pattern: str) -> Dict[str, bool]:
    regex = re.compile(pattern)
    return {name: bool(regex.match(name)) for name, _ in model.named_parameters()}


def _no_mesh(cfg: TrainConfig, mesh) -> None:
    if cfg.fsdp or mesh is not None:
        raise NotImplementedError(
            "sharded training (FSDP, data or model meshes) is ROADMAP A15"
        )


def create_train_state(
    model: nn.Module,
    cfg: TrainConfig = TrainConfig(),
    seed: int = 0,
    device="cuda",
    lora: Optional[Factors] = None,
    mesh=None,
) -> TrainState:
    """``model`` (a TSASRModel in its compute dtype) moved to ``device``;
    ``lora``: starting factors for mode ``lora`` (else ``init_lora`` with
    ``seed``)."""
    _no_mesh(cfg, mesh)
    if cfg.mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {cfg.mode}")
    dev = resolve_device(device)
    model.to(dev)
    mask = (
        trainable_mask(model, FROZEN_BACKBONE_TRAINABLE)
        if cfg.mode != "full" else None
    )
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask is None or mask[name])
        if p.requires_grad:
            params.append(p)
    factors: Factors = {}
    if cfg.mode == "lora":
        src = init_lora(model, cfg.lora, seed) if lora is None else lora
        factors = {
            k: tuple(t.detach().to(dev, torch.float32).clone().requires_grad_() for t in ab)
            for k, ab in src.items()
        }
        attach_lora(model, factors, cfg.lora)
    trainables = [t for ab in factors.values() for t in ab] + params
    opt = AdamW(trainables, cfg.optim, cfg.accum_grad)
    return TrainState(step=0, model=model, lora=factors, trainables=trainables, opt=opt)


def make_train_step(
    model: nn.Module, cfg: TrainConfig = TrainConfig(), device="cuda", mesh=None,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batch, generator=None, epoch=0)``: the batch's tensors
    are moved to the state's device."""
    _no_mesh(cfg, mesh)
    dev = resolve_device(device)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, epoch: float = 0):
        batch = {k: v.to(dev) for k, v in batch.items()}
        for t in state.trainables:
            t.grad = None
        loss, stats = state.model(batch, generator, epoch, train=True)
        loss.backward()
        grads = [
            torch.zeros_like(t) if t.grad is None else t.grad for t in state.trainables
        ]
        stats["grad_norm"] = global_norm(grads)
        state.opt.update(grads)
        for t in state.trainables:
            t.grad = None
        state.step += 1
        return state, stats

    return step
