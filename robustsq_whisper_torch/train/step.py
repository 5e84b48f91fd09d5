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
points default to ``device="cuda"`` and raise without CUDA.

On a ``(data, model)`` mesh (``parallel/mesh.py``; one process per GPU)
the step computes what one device computes on the whole batch:

- data parallelism: every rank is handed the same global batch and takes
  its rows (``place_batch``); the losses normalise by whole-batch counts
  and the random draws cover the whole batch (``parallel.mesh.use_mesh``);
  the gradients are averaged over the data group and the stats are the
  ranks' means;
- tensor parallelism (a model axis larger than 1): the parameters
  are split by ``parallel.shard.shard_model`` (Megatron column / row
  Linears, vocabulary-split embedding); a LoRA factor stays whole on every
  rank and its gradient, each rank's slice's part, is summed over the model
  group; ``TSEncoderConfig(sequence_parallel=True)`` runs the blocks
  sequence-parallel;
- ``TrainConfig.fsdp`` (a data axis larger than 1): ZeRO-3 storage; each
  rank holds ``1/n_data`` of every large parameter and so of its f32 master
  and Adam moments, the blocks gather their weights on use and the
  gradients are reduce-scattered;
- the gradient norm sums each rank's squares once per distinct shard
  (``parallel.shard.replication``) over the mesh.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..parallel import collectives
from ..parallel.mesh import local_rows, use_mesh
from ..parallel.shard import ShardLayout, replication, shard_model
from ..utils.profiling import annotate
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
    mesh: Optional[object] = None  # the (data, model) DeviceMesh, if any
    layout: Optional[ShardLayout] = None  # what shard_model did


def trainable_mask(model: nn.Module, pattern: str) -> Dict[str, bool]:
    regex = re.compile(pattern)
    return {name: bool(regex.match(name)) for name, _ in model.named_parameters()}


def place_batch(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch."""
    return local_rows(batch, mesh)


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
    ``seed``). With a ``mesh`` the model is sharded over it in place
    (tensor parallelism where the model axis is larger than 1;
    ``cfg.fsdp``: fully sharded storage of the parameters of at least
    ``parallel.mesh.FSDP_MIN_ELEMS`` elements)."""
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
    layout = None
    if mesh is not None:
        layout = shard_model(model, mesh, fsdp=cfg.fsdp)
        params = [p for p in model.parameters() if p.requires_grad]
    if factors:
        attach_lora(model, factors, cfg.lora)
    trainables = [t for ab in factors.values() for t in ab] + params
    opt = AdamW(trainables, cfg.optim, cfg.accum_grad,
                norm=_sharded_norm(model, trainables, layout))
    return TrainState(step=0, model=model, lora=factors, trainables=trainables, opt=opt,
                      mesh=mesh, layout=layout)


def _sharded_norm(model: nn.Module, trainables: List[torch.Tensor], layout):
    """The global gradient norm of ``trainables``' gradients: one device's
    ``global_norm``, or over a mesh each rank's squares divided by how many
    ranks hold the same part, summed over the mesh."""
    if layout is None:
        return global_norm
    names = {id(p): n for n, p in model.named_parameters()}
    weights = [float(replication(layout, names.get(id(t), ""))) for t in trainables]
    n_mesh = collectives.group_size(layout.model_group) * collectives.group_size(layout.data_group)
    # a LoRA factor (no parameter name) is whole on every rank
    weights = [w if id(t) in names else float(n_mesh) for w, t in zip(weights, trainables)]

    def norm(grads):
        sq = torch.stack([(g.float() * g.float()).sum() / w for g, w in zip(grads, weights)]).sum()
        sq = collectives.all_reduce_sum(sq, layout.model_group)
        return collectives.all_reduce_sum(sq, layout.data_group).sqrt()

    return norm


def sync_grads(state: TrainState, grads: List[torch.Tensor]) -> None:
    """Make ``grads`` (in place) the whole batch's on every rank: LoRA
    factors summed over the model group, then every gradient averaged over
    the data group (the fully sharded ones were summed by their
    reduce-scatter already)."""
    layout = state.layout
    if layout is None:
        return
    n_lora = 2 * len(state.lora)
    if layout.model_group is not None and n_lora:
        _all_reduce_flat(grads[:n_lora], layout.model_group)
    if layout.data_group is None:
        return
    n = collectives.group_size(layout.data_group)
    names = {id(p): name for name, p in state.model.named_parameters()}
    whole = [g for g, t in zip(grads, state.trainables) if names.get(id(t)) not in layout.fsdp]
    _all_reduce_flat(whole, layout.data_group)
    torch._foreach_div_(grads, float(n))


def _all_reduce_flat(tensors: List[torch.Tensor], group) -> None:
    """Sum ``tensors`` over ``group`` in place, as one flat buffer."""
    if not tensors:
        return
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = _flatten_dense_tensors(tensors)
    torch.distributed.all_reduce(flat, group=group)
    for t, f in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(f)


def _mean_stats(stats: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The data ranks' mean of each stat."""
    if group is None:
        return stats
    keys = sorted(stats)
    flat = torch.stack([stats[k].float() for k in keys])
    flat = collectives.all_reduce_sum(flat, group) / collectives.group_size(group)
    return dict(zip(keys, flat.unbind(0)))


def make_train_step(
    model: nn.Module, cfg: TrainConfig = TrainConfig(), device="cuda", mesh=None,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, batch, generator=None, epoch=0)``: the batch's tensors
    are moved to the state's device; on a ``mesh`` (the state's) ``batch``
    is the global batch and each rank takes its rows."""
    dev = resolve_device(device)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, epoch: float = 0):
        with annotate("rsq:train.step"):
            batch = {k: v.to(dev) for k, v in place_batch(batch, mesh).items()}
            for t in state.trainables:
                t.grad = None
            with use_mesh(mesh):
                with annotate("rsq:train.forward"):
                    loss, stats = state.model(batch, generator, epoch, train=True)
                with annotate("rsq:train.backward"):
                    loss.backward()
            with annotate("rsq:train.optimizer"):
                grads = [
                    torch.zeros_like(t) if t.grad is None else t.grad for t in state.trainables
                ]
                sync_grads(state, grads)
                if state.layout is not None:
                    stats = _mean_stats(stats, state.layout.data_group)
                stats["grad_norm"] = state.opt.norm(grads)
                state.opt.update(grads)
            for t in state.trainables:
                t.grad = None
            state.step += 1
        return state, stats

    return step
