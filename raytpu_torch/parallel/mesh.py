"""The (data, model) device mesh on torch.distributed (counterpart of
raytpu/parallel/mesh.py).

The reference's whole "distributed backend" is OpenMP ``parallel for`` over
image rows (`raytracer/Source/raytracer.cpp:557,617`). The port, like the
JAX package, lays its processes out on a mesh with two named axes:

  data  - image rows: each rank renders a contiguous row block.
  model - triangle blocks: each rank intersects its block of the scene and
          the closest hit, z-test or soft aggregate is merged across the
          axis with collectives.

One process drives one device (a card, or the CPU with gloo in the tests):
the mesh is ``torch.distributed.device_mesh.DeviceMesh`` over the world's
ranks, data-major, with one process group for each axis (``axis_group``).
The JAX package's ``row_sharding`` and ``replicated`` have no counterpart:
there a sharding tells XLA where an array lives, here each rank simply
holds its own row block (the functions of parallel/render.py return it and
``gather_image`` assembles the image), and replicated arguments are the same
tensors on every rank.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: int | None = None, model: int = 1,
              device: str = "cuda") -> DeviceMesh:
    """The ('data', 'model') mesh over the initialized process group's
    ranks (parallel/distributed.py::init_distributed first): rank r sits at
    (r // model, r % model). data defaults to world_size // model. device
    "cuda" (the NCCL group of the cards) or "cpu" (gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "raytpu_torch.parallel.init_distributed() first")
    n = dist.get_world_size()
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} available devices")
    return init_device_mesh(device, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    return mesh.get_group(axis)
