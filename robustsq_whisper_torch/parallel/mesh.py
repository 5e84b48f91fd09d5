"""Process groups, the (data, model) mesh, and the placement rules of
multi-GPU serving and training.

Mirrors the JAX package's ``parallel/mesh.py`` in PyTorch's idiom: one
process per GPU (launched with ``python -m torch.distributed.run``), a
``torch.distributed`` ``DeviceMesh`` with a ``data`` axis (rows split over
ranks, gradients averaged) and a ``model`` axis (Megatron tensor
parallelism over attention heads, the MLP hidden width and the vocabulary).
JAX declares shardings and lets XLA insert the collectives; here the
collectives are explicit (``parallel/collectives.py``) and the placement
rules below say which tensors each rank holds a slice of:

- ``param_pspec``: the tensor-parallel rule of one parameter by its name,
  in torch's ``(out, in)`` Linear layout (flax kernels are ``(in, out)``):
  q/k/v and fc1 split by output, out and fc2 by input, the tied token
  embedding and the AAM classifier by rows;
- ``placements``: every parameter's spec, with JAX's divisibility guard (a
  tensor whose split dimension does not divide stays whole: Whisper's
  vocabulary of 51865 is not split over 2 or 4 ranks) and, with ``fsdp``,
  JAX's FSDP rule (``fsdp_dim``): the largest free dimension that divides
  the data axis, for tensors of at least ``FSDP_MIN_ELEMS`` elements. The
  port keeps each block's tensors apart, so the threshold applies to one
  layer's tensor (JAX's to the layer-stacked leaf);
- ``local_rows``: a rank's rows of a batch (JAX's ``batch_shardings``);
- ``shard_seq`` / ``gather_seq``: sequence parallelism at block boundaries
  (JAX's ``shard_seq`` constraint), an identity unless the model axis is
  larger than 1 and the length divides.

``use_mesh(mesh)`` makes a mesh current while a training step runs: the
losses' normalisers (``global_count``), the random draws of SpecAugment,
dropout and the negative sampling (``global_rand``) and the speaker loss's
gathered rows read it, so that a data-parallel step computes what one
device computes on the whole batch.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import re
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"
Spec = Tuple[Optional[str], ...]

logger = logging.getLogger("robustsq_whisper_torch.parallel")


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    timeout_s: float = 60.0,
) -> int:
    """Join the process group; returns the world size.

    Without arguments it reads what ``torch.distributed.run`` sets
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); with no launcher and no arguments it does nothing and
    returns 1. ``coordinator_address`` (``tcp://host:port``), ``num_processes``
    and ``process_id`` join explicitly (a one-process group on one card,
    for instance). The backend is NCCL for a CUDA ``device`` (default: CUDA
    when it is available), whose rank then uses ``cuda:LOCAL_RANK``, and
    gloo for the CPU. A collective that waits longer than ``timeout_s``
    fails rather than hangs."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    launched = "RANK" in env and "WORLD_SIZE" in env and "MASTER_ADDR" in env
    if coordinator_address is None and not launched:
        return 1
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    local_rank = int(env.get("LOCAL_RANK", 0 if process_id is None else process_id))
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank if dev.index is None else dev.index)
    kwargs: Dict[str, Any] = dict(
        backend="nccl" if dev.type == "cuda" else "gloo",
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    if coordinator_address is not None:
        kwargs.update(init_method=coordinator_address, world_size=num_processes or 1,
                      rank=process_id or 0)
    dist.init_process_group(**kwargs)
    logger.info("process group: rank %d of %d (%s)", dist.get_rank(), dist.get_world_size(),
                kwargs["backend"])
    return dist.get_world_size()


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def local_device(device="cuda") -> torch.device:
    """``device`` with the CUDA index of this rank (``LOCAL_RANK``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and world_size() > 1:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device_type: Optional[str] = None):
    """A ``(data, model)`` ``DeviceMesh`` over the process group (default:
    every rank on the data axis), ranks laid out data-major as JAX's
    device grid. Needs ``init_distributed`` first."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    world = world_size()
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    if n_data is None:
        n_data = world // n_model
    assert n_data * n_model <= world, (n_data, n_model, world)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    names = (DATA_AXIS, MODEL_AXIS)
    if n_data * n_model == world:
        return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=names)
    grid = torch.arange(n_data * n_model).reshape(n_data, n_model)
    return DeviceMesh(device_type, grid, mesh_dim_names=names)


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh[axis].size()


def axis_rank(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of ``axis``, or None when it has one rank."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def describe(mesh) -> str:
    return f"data={axis_size(mesh, DATA_AXIS)}, model={axis_size(mesh, MODEL_AXIS)}"


# ---- placement rules ----

_ATTN = r".*(attn|attention|crossattention|cross_attn)"
_TP_RULES: Tuple[Tuple[str, Spec], ...] = (
    (_ATTN + r"\.(query|key|value)\.weight$", (MODEL_AXIS, None)),
    (_ATTN + r"\.(query|key|value)\.bias$", (MODEL_AXIS,)),
    (_ATTN + r"\.out\.weight$", (None, MODEL_AXIS)),
    (r".*(mlp_fc1|fc1)\.weight$", (MODEL_AXIS, None)),
    (r".*(mlp_fc1|fc1)\.bias$", (MODEL_AXIS,)),
    (r".*(mlp_fc2|fc2)\.weight$", (None, MODEL_AXIS)),
    (r".*token_embedding\.weight$", (MODEL_AXIS, None)),
    (r".*aam\.classifier$", (MODEL_AXIS, None)),
)


def param_pspec(name: str, ndim: int) -> Spec:
    """The tensor-parallel spec of one parameter (torch layout), one entry
    per dimension: ``"model"`` where the tensor is split, else None."""
    for pattern, spec in _TP_RULES:
        if re.match(pattern, name) and len(spec) <= ndim:
            return spec + (None,) * (ndim - len(spec))
    return (None,) * ndim


def _flax_order(module: nn.Module, ndim: int):
    """The port's dimensions in the order of the flax leaf's: Linear and
    Conv1d weights are the flax kernels reversed, every other tensor has
    the flax layout."""
    if isinstance(module, (nn.Linear, nn.Conv1d)) and ndim >= 2:
        return list(range(ndim))[::-1]
    return list(range(ndim))


def fsdp_dim(spec: Spec, shape: Sequence[int], n_data: int, order: Sequence[int]) -> Optional[int]:
    """JAX's ``_fsdp_spec`` choice: the largest dimension not split by
    ``spec`` that ``n_data`` divides, the first of equals in the flax
    leaf's order ``order``, never that order's first dimension of a 3-D or
    larger leaf. None when no dimension qualifies."""
    best, best_size = None, 0
    for j, i in enumerate(order):
        if spec[i] is not None or (len(shape) >= 3 and j == 0):
            continue
        if shape[i] % n_data == 0 and shape[i] > best_size:
            best, best_size = i, shape[i]
    return best


# JAX's ``fsdp_min_elems``: smaller tensors stay whole under FSDP
FSDP_MIN_ELEMS = 2**15


def placements(
    model: nn.Module,
    n_data: int = 1,
    n_model: int = 1,
    fsdp: bool = False,
    fsdp_min_elems: Optional[int] = None,
) -> Dict[str, Spec]:
    """Every parameter's spec: ``"model"`` on its tensor-parallel split
    where the model axis is larger than 1 (kept only where the dimension
    divides ``n_model``), ``"data"`` on its fully sharded one (tensors of
    at least ``fsdp_min_elems``, default ``FSDP_MIN_ELEMS``, elements)."""
    if fsdp_min_elems is None:
        fsdp_min_elems = FSDP_MIN_ELEMS
    out: Dict[str, Spec] = {}
    for mod_name, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            name = f"{mod_name}.{pname}" if mod_name else pname
            spec = param_pspec(name, p.dim()) if n_model > 1 else (None,) * p.dim()
            if any(a is not None and p.shape[d] % n_model for d, a in enumerate(spec)):
                spec = (None,) * p.dim()
            if fsdp and n_data > 1 and p.numel() >= fsdp_min_elems:
                d = fsdp_dim(spec, p.shape, n_data, _flax_order(module, p.dim()))
                if d is not None:
                    spec = spec[:d] + (DATA_AXIS,) + spec[d + 1:]
            out[name] = spec
    return out


# ---- rows, sequences and the current mesh ----

def local_rows(batch: Any, mesh) -> Any:
    """This rank's rows of ``batch`` (a tensor, an array or a dict of
    them): the ``data``-axis rank's equal share of the leading dimension.
    Leaves whose leading dimension does not divide stay whole, as in
    JAX's ``batch_shardings``."""
    n = axis_size(mesh, DATA_AXIS)
    if n == 1:
        return batch
    r = axis_rank(mesh, DATA_AXIS)

    def take(x):
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(take(v) for v in x)
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] % n == 0:
            b = x.shape[0] // n
            return x[r * b:(r + 1) * b]
        return x

    return take(batch)


_CURRENT: Dict[str, Any] = {"mesh": None, "sp": None}


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[None]:
    """Make ``mesh`` current (None: no mesh) for the code inside."""
    prev = _CURRENT["mesh"]
    _CURRENT["mesh"] = mesh
    try:
        yield
    finally:
        _CURRENT["mesh"] = prev


def data_group():
    """The current mesh's data group, None without one of several ranks."""
    return axis_group(_CURRENT["mesh"], DATA_AXIS)


def global_count(x: torch.Tensor) -> torch.Tensor:
    """A loss's normaliser under data parallelism: the count over the whole
    batch divided by the data ranks, so that the mean of the ranks' losses
    is the whole batch's loss; ``x`` itself without a data group."""
    from .collectives import all_reduce_sum

    g = data_group()
    if g is None:
        return x
    return all_reduce_sum(x.detach().float(), g) / dist.get_world_size(g)


def global_rand(shape: Sequence[int], generator=None, device=None, heads: Optional[Tuple[int, Any]] = None) -> torch.Tensor:
    """``torch.rand(shape)`` as one device draws it for the whole batch:
    under data parallelism the draw covers every rank's rows (``shape[0]``
    is the local row count) and this rank keeps its own; ``heads=(dim,
    group)`` likewise draws every head of a tensor-parallel split along
    ``dim`` and keeps this rank's."""
    shape = list(shape)
    g = data_group()
    n = 1 if g is None else dist.get_world_size(g)
    hn = 1 if heads is None or heads[1] is None else dist.get_world_size(heads[1])
    full = list(shape)
    full[0] *= n
    if hn > 1:
        full[heads[0]] *= hn
    u = torch.rand(full, generator=generator, device=device)
    if n > 1:
        u = u.chunk(n, dim=0)[dist.get_rank(g)]
    if hn > 1:
        u = u.chunk(hn, dim=heads[0])[dist.get_rank(heads[1])]
    return u


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's rows of ``x`` (no gradient): the whole batch."""
    from .collectives import all_gather_rows

    return all_gather_rows(x, data_group())


@contextlib.contextmanager
def sequence_parallel(group) -> Iterator[None]:
    """Inside a sequence-parallel block: the row-parallel Linears
    reduce-scatter along the sequence and the block's layer norms and
    row biases reduce their gradients over ``group``."""
    prev = _CURRENT["sp"]
    _CURRENT["sp"] = group
    try:
        yield
    finally:
        _CURRENT["sp"] = prev


def sp_group():
    return _CURRENT["sp"]


def sp_applies(group, length: int) -> bool:
    """Sequence parallelism runs: a model group of more than one rank and
    a length it divides (JAX's ``shard_seq`` condition)."""
    return group is not None and length % dist.get_world_size(group) == 0


def shard_seq(x: torch.Tensor, group, seq_axis: int = 1) -> torch.Tensor:
    """This rank's chunk of the sequence of ``x`` where ``sp_applies``,
    else ``x``."""
    from .collectives import scatter_to

    return scatter_to(x, seq_axis, group) if sp_applies(group, x.shape[seq_axis]) else x


def gather_seq(x: torch.Tensor, group, seq_axis: int = 1) -> torch.Tensor:
    """The whole sequence from every rank's chunk (``shard_seq``'s inverse)."""
    from .collectives import gather_from

    return gather_from(x, seq_axis, group)
