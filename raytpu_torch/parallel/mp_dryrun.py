"""Multi-process dry run of the sharded path on the CPU (counterpart of
raytpu/parallel/mp_dryrun.py and of __graft_entry__.py's
dryrun_multichip).

Launches N local processes, one rank each, over gloo (the CPU stand-in for
NCCL), lays them out on the (data, model) mesh (model 2 where N is even)
and runs on every rank

  1. a cross-rank psum over 'data' of each rank's data index, and
  2. one full sharded train step (parallel/render.py::
     make_sharded_train_step: the sharded hard render, the backward, the
     gradient sum over the world and an Adam update),

asserting that the loss agrees bit for bit across ranks. The ranks meet
through a file store in a temporary directory: no network port.

Usage:
  parent:  launch(num_processes=4)
  worker:  python -m raytpu_torch.parallel.mp_dryrun --rank R \
               --num-processes N --init-method file:///path/to/store
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path


def worker_main(rank: int, num_processes: int, init_method: str) -> dict:
    """One rank's body, in a fresh interpreter."""
    import torch

    # N ranks share the host's cores.
    torch.set_num_threads(1)

    from raytpu_torch.core.cornell import cornell_box
    from raytpu_torch.core.types import Camera, Lights, RenderConfig
    from raytpu_torch.parallel.collectives import psum
    from raytpu_torch.parallel.distributed import (
        init_distributed,
        shutdown_distributed,
    )
    from raytpu_torch.parallel.mesh import (
        DATA_AXIS,
        axis_group,
        axis_index,
        axis_size,
        make_mesh,
    )
    from raytpu_torch.parallel.render import (
        make_sharded_render,
        make_sharded_train_step,
        train_state,
    )

    state = init_distributed(init_method=init_method,
                             num_processes=num_processes, process_id=rank,
                             device="cpu")
    try:
        if (state.num_processes, state.process_id) != (num_processes, rank):
            raise RuntimeError(f"joined as {state}, not rank {rank} of "
                               f"{num_processes}")
        model = 2 if num_processes % 2 == 0 else 1
        mesh = make_mesh(data=num_processes // model, model=model,
                         device="cpu")
        nd = axis_size(mesh, DATA_AXIS)

        # 1. psum over 'data': every rank sees the whole axis.
        di = torch.tensor([float(axis_index(mesh, DATA_AXIS))])
        got = float(psum(di, axis_group(mesh, DATA_AXIS))[0])
        if got != nd * (nd - 1) / 2:
            raise RuntimeError(f"psum across ranks: {got} != "
                               f"{nd * (nd - 1) / 2}")

        # 2. One sharded train step.
        cfg = RenderConfig(width=16, height=max(16, 2 * nd), mode="clean")
        scene = cornell_box(pad_to=32, device="cpu")
        camera = Camera.raytracer_default(device="cpu")
        target = make_sharded_render(mesh, cfg)(
            scene, camera, Lights.single(capacity=1, device="cpu"))
        train_step, _ = make_sharded_train_step(mesh, cfg)
        st = train_state(scene,
                         Lights.single(capacity=1, intensity=10.0,
                                       device="cpu"),
                         lambda params: torch.optim.Adam(params, lr=1e-2))
        loss = float(train_step(st, camera, target.detach()))
        if not loss > 0.0:
            raise RuntimeError(f"bad loss {loss}")
        return {"rank": rank, "num_processes": num_processes,
                "global_devices": num_processes,
                "mesh": {"data": nd, "model": model}, "psum": got,
                "loss": loss}
    finally:
        shutdown_distributed()


def launch(num_processes: int = 4, timeout: float = 120.0,
           store_dir: str | None = None) -> list[dict]:
    """Spawn the ranks and collect their result lines; raises on a rank's
    failure or when the launch outlasts ``timeout`` seconds (every rank is
    killed then)."""
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init_method = (Path(tmp) / "store").as_uri()
        env = dict(os.environ)
        root = str(Path(__file__).resolve().parents[2])
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        procs = [subprocess.Popen(
            [sys.executable, "-m", "raytpu_torch.parallel.mp_dryrun",
             "--rank", str(rank), "--num-processes", str(num_processes),
             "--init-method", init_method],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for rank in range(num_processes)]
        return _collect(procs, timeout)


def _collect(procs, timeout: float) -> list[dict]:
    """Each rank's last JSON line; every rank killed on the first failure
    or timeout."""
    results, errors = [], []
    try:
        for rank, proc in enumerate(procs):
            try:
                out, err = proc.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                errors.append(f"rank {rank}: no result within {timeout} s")
                break
            if proc.returncode != 0:
                errors.append(f"rank {rank}: rc={proc.returncode}; stderr: "
                              f"{err[-1500:]}")
                break
            lines = [x for x in out.splitlines() if x.startswith("{")]
            if not lines:
                errors.append(f"rank {rank}: no result line; stdout: "
                              f"{out[-500:]!r}")
                break
            results.append(json.loads(lines[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    if errors:
        raise RuntimeError("mp_dryrun failed:\n" + "\n".join(errors))
    losses = {r["loss"] for r in results}
    if len(losses) != 1:
        raise RuntimeError(f"loss disagrees across ranks: {losses}")
    return results


def _main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--init-method", required=True)
    args = ap.parse_args()
    res = worker_main(args.rank, args.num_processes, args.init_method)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    _main()
