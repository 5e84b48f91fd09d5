"""Multi-GPU serving and training on ``torch.distributed``: the mesh and
its placement rules (``mesh``), the collectives (``collectives``) and the
sharding of modules (``shard``)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_group,
    axis_rank,
    axis_size,
    init_distributed,
    local_rows,
    make_mesh,
    placements,
)
