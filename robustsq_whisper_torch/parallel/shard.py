"""Sharding a model's parameters over a mesh: tensor parallelism and fully
sharded (ZeRO-3) storage.

``shard_model(model, mesh, fsdp)`` applies ``mesh.placements`` in place
and returns what it did (a ``ShardLayout``):

- tensor parallelism (a model axis larger than 1): every parameter
  split over ``model`` is replaced by this rank's slice under its own name;
  its ``Linear`` becomes column-parallel (split by output: q/k/v, fc1) or
  row-parallel (split by input: out, fc2), attention modules keep their
  local heads, a vocabulary-split ``TextDecoder`` looks tokens up in its
  rows and gathers its logits, and a split AAM classifier gathers its
  cosines (``whisper/modules.py``, ``qformer.py``, ``losses/speaker.py``);
- fully sharded storage (``fsdp``, a data axis larger than 1): every
  parameter split over ``data`` is replaced by this rank's ``1/n_data``
  slice, again under its own name, so the optimizer's f32 masters and
  moments are built from the slice. Each block (``ResidualAttentionBlock``,
  ``QformerLayer``) all-gathers its slices when it runs and drops the
  gathered tensors after; the rest of the model (stems, embeddings, heads)
  does so around the model's forward. The gather's backward reduce-scatters
  the gradient into the slice (``collectives.gather_sum``). A block that
  is recomputed in the backward (``remat``) gathers again.

``full_tensor`` / ``local_part`` move one parameter (or an optimizer
tensor of its shape) between the whole tensor and this rank's part: the
checkpoints hold whole tensors, in the format of one device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from . import collectives
from .mesh import DATA_AXIS, MODEL_AXIS, axis_group, axis_rank, axis_size, placements


@dataclasses.dataclass(frozen=True)
class Split:
    """One split of a tensor: ``n`` equal chunks along ``dim``, chunk
    ``rank`` of them here, over ``group``."""

    dim: int
    group: Any
    rank: int
    n: int

    def take(self, t: torch.Tensor) -> torch.Tensor:
        return t.chunk(self.n, dim=self.dim)[self.rank]


@dataclasses.dataclass
class ShardLayout:
    """What ``shard_model`` did: per parameter name its tensor-parallel and
    fully sharded splits (absent: whole on this rank), and the groups."""

    tp: Dict[str, Split]
    fsdp: Dict[str, Split]
    model_group: Any
    data_group: Any


def _set_param(module: nn.Module, pname: str, value: torch.Tensor, requires_grad: bool) -> None:
    module._parameters[pname] = nn.Parameter(value.contiguous().clone(), requires_grad=requires_grad)


def shard_model(model: nn.Module, mesh, fsdp: bool = False) -> ShardLayout:
    """Shard ``model``'s parameters over ``mesh`` in place (see the module
    docstring); returns the layout."""
    from ..losses.speaker import AAMSoftmaxHead
    from ..models.qformer import BertSelfAttentionBlock, QformerLayer
    from ..models.whisper.modules import (
        AudioEncoder, Linear, MultiHeadAttention, ResidualAttentionBlock, TextDecoder,
    )

    n_data, n_model = axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS)
    specs = placements(model, n_data, n_model, fsdp=fsdp)
    mgroup, dgroup = axis_group(mesh, MODEL_AXIS), axis_group(mesh, DATA_AXIS)
    mrank, drank = axis_rank(mesh, MODEL_AXIS), axis_rank(mesh, DATA_AXIS)
    layout = ShardLayout({}, {}, mgroup, dgroup)
    for mod_name, module in model.named_modules():
        for pname, p in list(module.named_parameters(recurse=False)):
            name = f"{mod_name}.{pname}" if mod_name else pname
            spec = specs[name]
            t = p.detach()
            if MODEL_AXIS in spec:
                split = Split(spec.index(MODEL_AXIS), mgroup, mrank, n_model)
                layout.tp[name] = split
                t = split.take(t)
            if DATA_AXIS in spec:
                split = Split(spec.index(DATA_AXIS), dgroup, drank, n_data)
                layout.fsdp[name] = split
                t = split.take(t)
            if name in layout.tp or name in layout.fsdp:
                _set_param(module, pname, t, p.requires_grad)

    # the modules of the tensor-parallel splits: the Linears first, then
    # the modules that read them
    key = lambda mod_name, p: f"{mod_name}.{p}" if mod_name else p
    for mod_name, module in model.named_modules():
        if isinstance(module, Linear) and key(mod_name, "weight") in layout.tp:
            module.tp = layout.tp[key(mod_name, "weight")]
    for mod_name, module in model.named_modules():
        if isinstance(module, (MultiHeadAttention, BertSelfAttentionBlock)) and module.query.tp:
            heads = module.n_head
            if heads % n_model:
                raise ValueError(f"{mod_name}: {heads} heads do not split over {n_model} ranks")
            module.n_head = heads // n_model
        if isinstance(module, TextDecoder):
            module.tp_group = mgroup
            module.vocab_tp = layout.tp.get(key(mod_name, "token_embedding.weight"))
        if isinstance(module, AudioEncoder):
            module.tp_group = mgroup
        if isinstance(module, AAMSoftmaxHead):
            module.tp = layout.tp.get(key(mod_name, "classifier"))

    if layout.fsdp:
        # a block runs as one unit unless a caller reaches into it (block 0
        # of the embedding encoder's conditional layer norms)
        units = [
            m for m in model.modules()
            if isinstance(m, QformerLayer)
            or (isinstance(m, ResidualAttentionBlock) and m.attn_ln is not None)
        ]
        in_unit = {id(p) for u in units for p in u.parameters()}
        for unit in units:
            _gather_around(unit, _named_splits(unit, layout.fsdp, model))
        params = dict(model.named_parameters())
        _gather_around(model, {
            n: s for n, s in layout.fsdp.items() if id(params[n]) not in in_unit
        })
    return layout


def _named_splits(unit: nn.Module, splits: Dict[str, Split], model: nn.Module) -> Dict[str, Split]:
    """``splits`` of ``unit``'s own parameters, keyed by their names in
    ``unit``."""
    by_id = {id(p): n for n, p in model.named_parameters()}
    return {
        n: splits[by_id[id(p)]] for n, p in unit.named_parameters() if by_id[id(p)] in splits
    }


def _gather_around(unit: nn.Module, splits: Dict[str, Split]) -> None:
    """Hooks that put the gathered parameters of ``splits`` (names in
    ``unit``) in place of their slices while ``unit`` runs."""
    if not splits:
        return
    targets = []
    for name, split in splits.items():
        *path, pname = name.split(".")
        owner = unit.get_submodule(".".join(path)) if path else unit
        targets.append((owner, pname, split))

    def gather(module, args, kwargs=None):
        for owner, pname, split in targets:
            shard = owner._parameters[pname]
            # an instance attribute shadows the parameter of the same name
            owner.__dict__[pname] = collectives.gather_sum(shard, split.dim, split.group)

    def release(module, args, output):
        for owner, pname, _ in targets:
            owner.__dict__.pop(pname, None)

    unit.register_forward_pre_hook(gather)
    unit.register_forward_hook(release)


@torch.no_grad()
def full_tensor(layout: Optional[ShardLayout], name: str, t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of parameter ``name`` from this rank's part ``t``
    (every rank of the mesh calls this: it gathers)."""
    if layout is None:
        return t
    for splits in (layout.fsdp, layout.tp):
        split = splits.get(name)
        if split is not None and split.n > 1:
            parts = [torch.empty_like(t) for _ in range(split.n)]
            torch.distributed.all_gather(parts, t.contiguous(), group=split.group)
            t = torch.cat(parts, dim=split.dim)
    return t


def local_part(layout: Optional[ShardLayout], name: str, t: torch.Tensor) -> torch.Tensor:
    """This rank's part of the whole tensor ``t`` of parameter ``name``."""
    if layout is None:
        return t
    for splits in (layout.tp, layout.fsdp):
        split = splits.get(name)
        if split is not None:
            t = split.take(t)
    return t


def replication(layout: Optional[ShardLayout], name: str) -> int:
    """How many ranks of the mesh hold the same part of ``name``, divided
    out of its square sum in the global gradient norm."""
    if layout is None:
        return 1
    n_model = collectives.group_size(layout.model_group)
    n_data = collectives.group_size(layout.data_group)
    held = (n_model if name in layout.tp else 1) * (n_data if name in layout.fsdp else 1)
    return n_model * n_data // held
