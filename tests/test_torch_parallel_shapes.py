"""The sharded paths on the (4, 1) and (1, 4) meshes over gloo (rows only:
the DoF halo across three shard edges; triangles only: the merges over
four blocks), the multi-process dry run, and the bootstrap's argument
checks.

The launches, jobs and rules are tests/test_torch_parallel.py's (loaded
from that file): every rank runs every sharded path and the test process
holds each against the port's unsharded result.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

from raytpu_torch.parallel import mp_dryrun
from raytpu_torch.parallel.distributed import init_distributed
from raytpu_torch.parallel.mesh import make_mesh

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "torch_parallel_jobs", Path(__file__).with_name("test_torch_parallel.py"))
jobs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jobs)

SHAPES = [(4, 1), (1, 4)]


@pytest.fixture(scope="module", params=SHAPES, ids=["4x1", "1x4"])
def mesh(request, tmp_path_factory):
    shape = request.param
    return shape, jobs.launch(shape, tmp_path_factory.mktemp("p"))


@pytest.mark.parametrize("name", jobs.HARD)
def test_sharded_render_matches_unsharded(mesh, name):
    jobs.check_hard(mesh[1], mesh[0], name)


@pytest.mark.parametrize("name", jobs.RASTER)
def test_sharded_rasterize_matches_unsharded(mesh, name):
    jobs.check_raster(mesh[1], mesh[0], name)


@pytest.mark.parametrize("name", jobs.SOFT_FRAMES)
def test_sharded_soft_render_matches_unsharded(mesh, name):
    jobs.check_soft(mesh[1], mesh[0], name)


@pytest.mark.parametrize("name", list(jobs.STEPS))
def test_sharded_step_gradients_match_single_process(mesh, name):
    jobs.check_step(mesh[1], mesh[0], name)


def test_mp_dryrun_four_ranks(tmp_path):
    """mp_dryrun.launch(4): the JAX dry run's dict on every rank, a (2, 2)
    mesh, the psum over 'data', one finite loss the same on every rank."""
    results = mp_dryrun.launch(4, store_dir=str(tmp_path))
    assert [r["rank"] for r in results] == [0, 1, 2, 3]
    for r in results:
        assert set(r) == {"rank", "num_processes", "global_devices", "mesh",
                          "psum", "loss"}
        assert r["mesh"] == {"data": 2, "model": 2}
        assert r["num_processes"] == r["global_devices"] == 4
        assert r["psum"] == 1.0
    assert len({r["loss"] for r in results}) == 1
    assert 0.0 < results[0]["loss"] < 1.0


def test_bootstrap_checks_its_arguments(monkeypatch):
    """Several processes need a rank and a shared rendezvous; the mesh
    needs a process group and must cover it. Nothing is initialized."""
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="rank is unresolved"):
        init_distributed(num_processes=2, init_method="file:///x",
                         device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(ValueError, match="rendezvous"):
        init_distributed(device="cpu")
    with pytest.raises(ValueError, match="no backend"):
        init_distributed(num_processes=1, device="tpu")
    with pytest.raises(RuntimeError, match="init_distributed"):
        make_mesh(1, 1, device="cpu")


_ONE_RANK = """
import torch
from raytpu_torch.parallel import (init_distributed, make_mesh,
                                   shutdown_distributed)
from raytpu_torch.parallel.mesh import axis_index, axis_size
state = init_distributed(device="cpu")
assert init_distributed(device="cpu") is state
assert (state.num_processes, state.process_id, state.backend) == (
    1, 0, "gloo"), state
mesh = make_mesh(device="cpu")
assert [axis_size(mesh, a) for a in ("data", "model")] == [1, 1]
assert [axis_index(mesh, a) for a in ("data", "model")] == [0, 0]
try:
    make_mesh(2, 1, device="cpu")
except ValueError as e:
    assert "2x1 != 1" in str(e)
else:
    raise AssertionError("a 2x1 mesh of one rank")
shutdown_distributed()
print("one rank ok")
"""


def test_single_process_bootstrap():
    """With no launcher, one rank on an in-process store (the JAX
    package's degenerate num_processes=1 bootstrap), idempotent."""
    proc = subprocess.run([sys.executable, "-c", _ONE_RANK], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "one rank ok" in proc.stdout
