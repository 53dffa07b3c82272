"""The sharded renderers on torch.distributed (counterpart of
raytpu/parallel): image rows over the mesh's 'data' axis, triangles over
'model'."""

from raytpu_torch.parallel.distributed import (
    DistributedState,
    init_distributed,
    shutdown_distributed,
)
from raytpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, make_mesh

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "DistributedState",
    "init_distributed",
    "make_mesh",
    "shutdown_distributed",
]
