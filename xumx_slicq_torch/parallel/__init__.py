"""Several devices: data-parallel training with cross-rank BatchNorm and the
target-parallel split (parallel/mesh.py, on torch.distributed), the
counterpart of xumx_slicq_tpu/parallel/. The Separator's chunk fan-out over
several devices needs no process group and lives in separator.py."""

from .mesh import (
    Mesh,
    backend_for,
    is_target_stacked,
    local_targets,
    make_mesh,
    replicate,
    shard_batch,
    spawn,
    take_targets,
)

__all__ = [
    "Mesh",
    "backend_for",
    "is_target_stacked",
    "local_targets",
    "make_mesh",
    "replicate",
    "shard_batch",
    "spawn",
    "take_targets",
]
