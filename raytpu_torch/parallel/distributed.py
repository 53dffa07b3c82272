"""Multi-process bootstrap on torch.distributed (counterpart of
raytpu/parallel/distributed.py).

One process drives one device. ``init_distributed`` brings up the default
process group, NCCL for the cards and gloo for the CPU, after which
parallel/mesh.py::make_mesh lays the ranks out on the ('data', 'model')
mesh and the sharded renderers of parallel/render.py run unchanged at any
world size.

    from raytpu_torch.parallel import init_distributed
    state = init_distributed()                  # torchrun's env, or 1 process
    state = init_distributed(                   # or explicit
        init_method="file:///tmp/rendezvous", num_processes=4,
        process_id=rank, device="cpu")

Resolution order for each field: the explicit argument, then torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, and ``MASTER_ADDR``
for the ``env://`` rendezvous), else a single-process group on an
in-process store (``torch.distributed.HashStore``): the same group a
launched job brings up, with no network and no launcher, as the JAX
package's degenerate ``num_processes=1`` bootstrap is. Rank r binds
``cuda:LOCAL_RANK`` (LOCAL_RANK defaults to the rank). There is no
fallback: NCCL without a card, or a failed rendezvous, raises.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

__all__ = ["DistributedState", "init_distributed", "shutdown_distributed"]


@dataclasses.dataclass(frozen=True)
class DistributedState:
    """The process's place in the (possibly one-process) job."""

    num_processes: int
    process_id: int
    local_rank: int
    device: torch.device
    backend: str


_STATE: DistributedState | None = None


def _env_int(name: str) -> int | None:
    raw = os.environ.get(name)
    return int(raw) if raw else None


def init_distributed(init_method: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_rank: int | None = None,
                     device: str = "cuda") -> DistributedState:
    """Bring up the default process group (idempotent: a second call
    returns the existing state). device "cuda" takes NCCL and binds
    cuda:local_rank; "cpu" takes gloo."""
    global _STATE
    if _STATE is not None:
        return _STATE
    env = os.environ
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK")
    if init_method is None and "MASTER_ADDR" in env and \
            num_processes is not None:
        init_method = "env://"
    num_processes = 1 if num_processes is None else num_processes
    if num_processes > 1 and process_id is None:
        # Every process defaulting to rank 0 would hang the rendezvous.
        raise ValueError(f"init_distributed: num_processes={num_processes} "
                         "> 1 but the rank is unresolved: set RANK or pass "
                         "process_id")
    if num_processes > 1 and init_method is None:
        raise ValueError("init_distributed: num_processes > 1 needs a shared "
                         "rendezvous (init_method, or MASTER_ADDR)")
    process_id = 0 if process_id is None else process_id
    local_rank = process_id if local_rank is None else local_rank

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: device cuda but no CUDA "
                               "device is available")
        torch.cuda.set_device(local_rank)
        backend, dev = "nccl", torch.device("cuda", local_rank)
    elif device == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    else:
        raise ValueError(f"init_distributed: no backend for device {device!r}")
    if init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method=init_method,
                                rank=process_id, world_size=num_processes)
    _STATE = DistributedState(num_processes=dist.get_world_size(),
                              process_id=dist.get_rank(),
                              local_rank=local_rank, device=dev,
                              backend=backend)
    return _STATE


def shutdown_distributed() -> None:
    """Tear the process group down (tests; long-running programs on exit)."""
    global _STATE
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE = None
