"""L2, L3 and L4, lab 2's and lab 3's probes (raytpu_torch/kernels/labs.py::
run_onestep, run_noop, run_tiny), against the JAX labs' ``onestep_kernel``,
``noop_kernel`` and ``tiny_kernel`` on the CPU; the chain estimators
(raytpu_torch/labs/timing.py::chain_time, total_time); and labs 2 and 3 on
the CPU.

bench/megakernel_lab2.py::run_onestep, run_noop and
bench/megakernel_lab3.py::run_tiny pass no ``interpret=``, so the test
makes the same ``pl.pallas_call`` (grid and block specs) with
``interpret=True``. The JAX labs are loaded by file path (``import bench``
finds bench.py); neither enables a compile cache at import. Inputs as lab
2 makes them (megakernel_lab2.py:175-206): one light
(``Lights.single(capacity=1)``), the Cornell box padded to 32, clean, here
at 32^2 with tiles of 256; ``blk_s`` from the primary ``valid``. Two
views: the raytracer's default camera (every ray hits) and a wide one
with a small triangle across the light-to-camera segment (the box plus
that triangle, padded to 32), where every miss ray's shadow ray is blocked
and its raw bit is 1 (ROADMAP fault F25). The JAX package's constants,
carried across as numpy, go into both. idx, occ and L3's and L4's
outputs bit for bit; L2's t within rtol 5e-7, since XLA:CPU contracts the
plane products into FMAs (ROADMAP fault F4; on the card L2 equals its
plain version and K4 bit for bit).
"""

import functools
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytpu.core.cornell import cornell_box_numpy as jax_cornell_box_numpy
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.core.types import Scene as JaxScene
from raytpu.kernels.intersect_pallas import _blocked_constants, _tight_chunk
from raytpu.ops.intersect import tri_constants as jax_tri_constants
from raytpu.render.raytrace import camera_ray_dirs, pixel_grid

from raytpu_torch.kernels import intersect, labs
from raytpu_torch.kernels.tables import constant_table
from raytpu_torch.labs import megakernel_lab2, megakernel_lab3, timing

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "bench" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jax_lab2 = _load("megakernel_lab2")
jax_lab3 = _load("megakernel_lab3")

SIZE, TILE = 32, 256
VIEWS = ("default", "blocked")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's plain versions on one thread: the tensors here are near
    torch's intra-op grain size, and the suite's parallel workers would
    each run a pool of every core's threads, which then wait on each other
    (a CPU lab run took minutes instead of seconds)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(shape, index):
    return pl.BlockSpec(shape, index, memory_space=pltpu.VMEM)


def _rows(tile_r, two_d=False):
    if two_d:
        return _spec((1, tile_r), lambda i, c: (0, i))
    return _spec((1, tile_r), lambda i: (0, i))


def _outs(R):
    return [jax.ShapeDtypeStruct((1, R), jnp.float32),
            jax.ShapeDtypeStruct((1, R), jnp.int32),
            jax.ShapeDtypeStruct((1, R), jnp.int32)]


def _jax_onestep(dirs_t, blk_p, blk_s, org, tile_r, C):
    """megakernel_lab2.py::run_onestep (:85-114) with interpret=True."""
    R = dirs_t.shape[1]
    whole = _spec((4 * C, 3), lambda i: (0, 0))
    return pl.pallas_call(
        functools.partial(jax_lab2.onestep_kernel, C=C),
        grid=(R // tile_r,),
        in_specs=[_spec((3, tile_r), lambda i: (0, i)), whole, whole,
                  _spec((8, 128), lambda i: (0, 0))],
        out_specs=[_rows(tile_r)] * 3, out_shape=_outs(R),
        interpret=True,
    )(dirs_t, blk_p, blk_s, org)


def _jax_noop(dirs_t, blocked, org, tile_r, chunk):
    """megakernel_lab2.py::run_noop (:128-155) with interpret=True."""
    R = dirs_t.shape[1]
    return pl.pallas_call(
        jax_lab2.noop_kernel,
        grid=(R // tile_r, blocked.shape[0] // (4 * chunk)),
        in_specs=[_spec((3, tile_r), lambda i, c: (0, i)),
                  _spec((4 * chunk, 3), lambda i, c: (c, 0)),
                  _spec((8, 128), lambda i, c: (0, 0))],
        out_specs=[_rows(tile_r, two_d=True)] * 3, out_shape=_outs(R),
        interpret=True,
    )(dirs_t, blocked, org)


def _jax_tiny(x):
    """megakernel_lab3.py::run_tiny (:53-59) with interpret=True."""
    return pl.pallas_call(
        jax_lab3.tiny_kernel,
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(x)


def _scene_and_camera(view):
    lights = JaxLights.single(capacity=1)
    light = np.asarray(lights.position[0])
    v0, v1, v2, color = jax_cornell_box_numpy()
    if view == "default":
        return (JaxScene.from_vertices(v0, v1, v2, color).pad_to(32),
                JaxCamera.raytracer_default(), light)
    cam = JaxCamera.make((0.1, 0.05, -2.0), yaw=0.1, focal=SIZE / 2)
    pos = np.asarray(cam.pos)
    axis = (light - pos) / np.linalg.norm(light - pos)
    e1 = np.cross(axis, [0.0, 1.0, 0.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(axis, e1)
    mid = 0.5 * (light + pos)
    blocker = [mid + 0.02 * e1, mid - 0.01 * e1 + 0.017 * e2,
               mid - 0.01 * e1 - 0.017 * e2]
    scene = JaxScene.from_vertices(
        *(np.concatenate([v, np.float32(b)[None]]) for v, b in
          zip((v0, v1, v2), blocker)),
        np.concatenate([color, np.full((1, 3), 0.5, np.float32)]))
    return scene.pad_to(32), cam, light


@pytest.fixture(scope="module", params=VIEWS)
def case(request):
    """One view's inputs in both packages' forms and the JAX results of
    onestep and noop (one interpret-mode run each)."""
    scene, cam, light = _scene_and_camera(request.param)
    cfg = JaxRenderConfig(width=SIZE, height=SIZE, mode="clean")
    dirs_t = jnp.asarray(camera_ray_dirs(*pixel_grid(cfg), cam, cfg).T)
    c = jax_tri_constants(scene, cam.pos)
    cl = jax_tri_constants(scene, light)
    C = _tight_chunk(32, 512)
    blk_p, _ = _blocked_constants(c.m, c.k0, c.valid, C)
    blk_s, _ = _blocked_constants(cl.m, cl.k0, c.valid, C)
    org = jnp.zeros((8, 128), jnp.float32)
    org = org.at[0:3, 0].set(cam.pos).at[3:6, 0].set(light)
    one = jax.jit(functools.partial(_jax_onestep, tile_r=TILE, C=C))(
        dirs_t, blk_p, blk_s, org)
    nop = jax.jit(functools.partial(_jax_noop, tile_r=TILE, chunk=C))(
        dirs_t, jnp.concatenate([blk_p, blk_s], axis=0), org)

    def t(a):
        return torch.tensor(np.asarray(a))

    m, k0, valid, m_l, k0_l = map(t, (c.m, c.k0, c.valid, cl.m, cl.k0))
    return dict(
        view=request.param, C=C, dirs_t=t(dirs_t).contiguous(),
        table=constant_table(m, k0, valid, m_l[None], k0_l[None], C),
        consts=(m, k0, valid, m_l, k0_l), cam=t(cam.pos), light=t(light),
        onestep=[np.asarray(a) for a in one],
        noop=[np.asarray(a) for a in nop])


def _args(c):
    return c["dirs_t"], c["table"], c["cam"], c["light"], TILE, c["C"]


def test_onestep_matches_jax_kernel(case):
    before = labs.LAUNCHES_ONESTEP
    got = labs.run_onestep(*_args(case))
    assert labs.LAUNCHES_ONESTEP == before  # CPU tensors: plain version
    want_t, want_idx, want_occ = case["onestep"]
    hit = want_idx >= 0
    mism = [int((g.numpy() != w).sum()) for g, w in zip(got, case["onestep"])]
    print(f"{case['view']}: {hit.sum()} hit rays of {hit.size}, occluded "
          f"{int(want_occ.sum())} (on misses {int(want_occ[~hit].sum())}); "
          f"mismatches [t, idx, occ] {mism}")
    assert [tuple(g.shape) for g in got] == [w.shape for w in
                                             case["onestep"]]
    assert got[1].dtype == got[2].dtype == torch.int32
    assert mism[1:] == [0, 0]
    np.testing.assert_allclose(got[0].numpy(), want_t, rtol=5e-7)
    assert want_occ[hit].any()
    if case["view"] == "blocked":  # F25: the raw bit, 1 on every miss
        assert 0 < (~hit).sum() and want_occ[~hit].all()


def test_onestep_is_k4(case):
    """L2 computes K4's function on every ray (F25's repair): the plain
    versions agree with K4's entry for entry."""
    m, k0, valid, m_l, k0_l = case["consts"]
    one = labs.run_onestep(*_args(case))
    k4 = intersect.closest_hit_occluded(case["dirs_t"].T.contiguous(), m, k0,
                                        valid, m_l, k0_l, case["cam"],
                                        case["light"], tri_chunk=512)
    for a, b in zip(one, k4):
        assert torch.equal(a[0], b)


def test_noop_matches_jax_kernel(case):
    before = labs.LAUNCHES_NOOP
    got = labs.run_noop(*_args(case))
    assert labs.LAUNCHES_NOOP == before
    for g, w in zip(got, case["noop"]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert torch.equal(got[0][0], case["dirs_t"][0])
    assert not got[1].any() and not got[2].any()


def test_tiny_matches_jax_kernel():
    x = np.random.default_rng(3).standard_normal((8, 128)).astype(np.float32)
    want = np.asarray(jax.jit(_jax_tiny)(jnp.asarray(x)))
    before = labs.LAUNCHES_TINY
    got = labs.run_tiny(torch.tensor(x))
    assert labs.LAUNCHES_TINY == before
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), x * 2)


def test_probes_refuse_what_jax_would_read_in_part(case):
    """A ray count that is not a whole number of tiles (F23: JAX's grid
    R // tile_r leaves the tail unwritten) and a table of more than one
    chunk (JAX's block spec reads chunk 0 alone) raise ValueError."""
    dirs_t, table, cam, light, tile, C = _args(case)
    for fn in (labs.run_onestep, labs.run_noop):
        with pytest.raises(ValueError, match="F23"):
            fn(dirs_t, table, cam, light, 3 * tile, C)
        two = torch.cat([table, table], dim=1)
        with pytest.raises(ValueError, match="one chunk"):
            fn(dirs_t, two, cam, light, tile, C)
    with pytest.raises(ValueError):
        labs.run_tiny(torch.ones((4, 128)))


def test_chain_time_and_total_time_chain_and_feed_on_the_cpu():
    """Lab 2's and lab 3's estimators on the CPU: warm-up and batches of
    reps chains of iters calls, each chain from a copy of x with each
    output's sum x 1e-30 fed back; eager only (no graph on the CPU)."""
    seen = []

    def fn(x):
        seen.append(x.clone())
        return x * 2.0, (x > 0).to(torch.int32)

    x = torch.full((8,), 1e31)
    r = timing.chain_time(fn, x, iters=3, batches=2, reps=2)
    assert r["graph"] is None and r["eager"] > 0
    assert r["calls"] == {"eager": (1 + 2) * 2 * 3, "captured": 0,
                          "replayed": 0}
    assert len(seen) == 18 and torch.equal(x, torch.full((8,), 1e31))
    # The second call of a chain sees the first's outputs fed back:
    # 1e31 + (8 * 2e31 + 8) * 1e-30.
    assert torch.equal(seen[0], x)
    assert float(seen[1][0]) == pytest.approx(1e31 + 160.0, rel=1e-6)
    total = timing.total_time(lambda c: c * 1.0000001, torch.tensor(1.0), 5,
                              batches=2, reps=2)
    assert total["calls"]["eager"] == (1 + 2) * 2 * 5
    assert total["eager"] > 0 and total["graph"] is None


def test_lab2_runs_on_the_cpu(capsys):
    """Lab 2 as a user runs it, on the CPU at 32^2 (tiles of 256): four
    rows at each pad, eager only; L2 = K4 and L3's outputs exact."""
    assert megakernel_lab2.main(["--device", "cpu", "--size", "32",
                                 "--tile", "256"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["card"] is None
    assert set(res["rows"]) == {str(p) for p in megakernel_lab2.PADS}
    for pad, rows in res["rows"].items():
        assert set(rows) == {r for r, _ in megakernel_lab2.ROWS}
        assert all(v["eager"] > 0 and v["graph"] is None
                   for v in rows.values())
        assert res["mismatch"][pad] == {
            "onestep_vs_k4": {"t": 0, "idx": 0, "occ": 0},
            "noop": {"t": 0, "idx": 0, "occ": 0}}
    assert res["launches"] == dict.fromkeys(megakernel_lab2.counts(), 0)


def test_lab3_runs_on_the_cpu(capsys):
    """Lab 3 as a user runs it, on the CPU at 32^2: three cases, the
    totals at 5, 20 and 80 iterations and lab 3's line through them,
    eager only."""
    assert megakernel_lab3.main(["--device", "cpu", "--size", "32"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["card"] is None
    assert set(res["cases"]) == {"scalar", "tiny", "fused-kernel"}
    for case in res["cases"].values():
        assert case["graph"] is None
        ts = case["eager"]["totals"]
        assert set(ts) == {"5", "20", "80"} and all(v > 0 for v in
                                                    ts.values())
        slope = (ts["80"] - ts["5"]) / 75.0
        assert case["eager"]["slope_ms"] == pytest.approx(slope)
        assert case["eager"]["fixed_ms"] == pytest.approx(ts["5"] - 5 * slope)
    assert res["launches"] == dict.fromkeys(megakernel_lab3.counts(), 0)


sys.modules.pop("jax_megakernel_lab2", None)
sys.modules.pop("jax_megakernel_lab3", None)
