"""L1, lab 1's closest-hit variants (raytpu_torch/kernels/labs.py::
kernel_lab_variant), against the JAX lab's ``_kernel_v`` on the CPU, and
lab 1 itself (raytpu_torch/labs/kernel_lab.py) on the CPU.

bench/kernel_lab.py::run_variant passes no ``interpret=``, so the test
makes the same ``pl.pallas_call`` (its padding, blocking, grid and block
specs) with ``interpret=True`` around ``functools.partial(_kernel_v,
...)``. The JAX lab is loaded by file path in a module fixture: it calls
``enable_cache()`` at import, which points JAX's persistent compile cache
(``RAYTPU_CACHE_DIR``) at a temporary directory here and is undone when
the module's tests end.

Inputs: 32^2 clean rays of the raytracer's default camera, tiles of 256
(and one case at 512), on the Cornell box padded to 32 (one chunk) and on
a random scene of 300 triangles (labs/common.py::random_scene, seed 1:
three chunks of 128 tight, three of 128 padded), all 8 (chunk, dot, div)
combinations; the JAX package's constants, carried across as numpy, go
into both. ``vpu``: idx bit for bit, t within rtol 5e-7 (XLA:CPU
contracts the products into FMAs, ROADMAP fault F4). ``mxu``: XLA:CPU
computes a float32 dot where the port's plain version computes 3xTF32, so
t is held to labs.mxu_rule's bound (|t| (2 MXU_EPS S_n / |n . d| +
2^-21), MXU_EPS = 2^-18) and the idx mismatch count is asserted at the
number measured, printed (no near-tie or near-edge ray at these sizes).
"""

import functools
import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import compilation_cache
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.core.types import Scene as JaxScene
from raytpu.ops.intersect import tri_constants as jax_tri_constants
from raytpu.render.raytrace import camera_ray_dirs, pixel_grid

from raytpu_torch.kernels import intersect, labs
from raytpu_torch.labs import kernel_lab
from raytpu_torch.labs.common import random_scene

ROOT = Path(__file__).resolve().parents[1]
SIZE, TILE, OTHER_TILE, RANDOM_T = 32, 256, 512, 300
COMBOS = [(c, d, v) for c in labs.CHUNK_MODES for d in labs.DOTS
          for v in labs.DIVS]
CASES = ([("cornell32", *combo, TILE) for combo in COMBOS]
         + [("random300", *combo, TILE) for combo in COMBOS]
         + [("random300", "tight", dot, "recip", OTHER_TILE)
            for dot in labs.DOTS])
# idx mismatches of the port's plain mxu (3xTF32) against the JAX kernel's
# float32 dot, as measured: none.
MXU_IDX_MISMATCHES = 0


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


@pytest.fixture(scope="module")
def jax_lab1(tmp_path_factory):
    """bench/kernel_lab.py, loaded with its compile cache in a temporary
    directory; JAX's cache settings are restored afterwards."""
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs,
             os.environ.get("RAYTPU_CACHE_DIR"))
    os.environ["RAYTPU_CACHE_DIR"] = str(tmp_path_factory.mktemp("xla"))
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_kernel_lab", ROOT / "bench" / "kernel_lab.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        yield module
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          saved[1])
        compilation_cache.reset_cache()
        if saved[2] is None:
            os.environ.pop("RAYTPU_CACHE_DIR", None)
        else:
            os.environ["RAYTPU_CACHE_DIR"] = saved[2]


def _jax_run_variant(lab, dirs_t, m, k0, valid, *, tile_r, chunk_mode, dot,
                     div):
    """kernel_lab.py::run_variant (:112-153) with interpret=True."""
    R, T0 = dirs_t.shape[1], m.shape[0]
    chunk = (min(128, max(8, -(-T0 // 8) * 8)) if chunk_mode == "tight"
             else 128)
    T = ((T0 + chunk - 1) // chunk) * chunk
    padn = T - T0
    if padn:
        m = jnp.concatenate([m, jnp.zeros((padn, 3, 3), jnp.float32)], 0)
        k0 = jnp.concatenate([k0, jnp.zeros((padn,), jnp.float32)])
        valid = jnp.concatenate([valid, jnp.zeros((padn,), jnp.float32)])
    n_chunks = T // chunk
    mc = (m * valid[:, None, None]).reshape(n_chunks, chunk, 3, 3)
    k0c = (k0 * valid).reshape(n_chunks, chunk)
    k0_rows = jnp.stack([k0c, jnp.zeros_like(k0c), jnp.zeros_like(k0c)], -1)
    blocked = jnp.concatenate(
        [mc[:, :, 0, :], mc[:, :, 1, :], mc[:, :, 2, :], k0_rows], axis=1
    ).reshape(n_chunks * 4 * chunk, 3)

    def spec(shape, index):
        return pl.BlockSpec(shape, index, memory_space=pltpu.VMEM)

    t, idx = pl.pallas_call(
        functools.partial(lab._kernel_v, tri_chunk=chunk, dot=dot, div=div),
        grid=(R // tile_r, n_chunks),
        in_specs=[spec((3, tile_r), lambda i, c: (0, i)),
                  spec((4 * chunk, 3), lambda i, c: (c, 0))],
        out_specs=[spec((1, tile_r), lambda i, c: (0, i)),
                   spec((1, tile_r), lambda i, c: (0, i))],
        out_shape=[jax.ShapeDtypeStruct((1, R), jnp.float32),
                   jax.ShapeDtypeStruct((1, R), jnp.int32)],
        scratch_shapes=[pltpu.VMEM((1, tile_r), jnp.float32),
                        pltpu.VMEM((1, tile_r), jnp.int32)],
        interpret=True,
    )(dirs_t, blocked)
    return t[0], idx[0]


@pytest.fixture(scope="module")
def inputs():
    """The lab's rays at 32^2 and its two scenes' camera-origin constants,
    in both packages' forms (the random scene drawn by the port and handed
    to JAX as numpy)."""
    cam = JaxCamera.raytracer_default()
    cfg = JaxRenderConfig(width=SIZE, height=SIZE, mode="clean")
    dirs_t = jnp.asarray(camera_ray_dirs(*pixel_grid(cfg), cam, cfg).T)
    rnd = random_scene(RANDOM_T, 1, "cpu")
    scenes = {"cornell32": jax_cornell_box(pad_to=32),
              "random300": JaxScene.from_vertices(
                  *(t.numpy() for t in (rnd.v0, rnd.v1, rnd.v2, rnd.color)))}
    out = {"dirs_t": dirs_t, "dirs_t_port": torch.tensor(np.asarray(dirs_t))}
    for name, scene in scenes.items():
        c = jax_tri_constants(scene, cam.pos)
        out[name] = (c, tuple(torch.tensor(np.asarray(a)) for a in c))
    return out


@pytest.fixture(scope="module")
def jax_results(jax_lab1, inputs):
    """Each case's JAX result, computed once."""
    cache = {}

    def get(case):
        if case not in cache:
            scene, chunk_mode, dot, div, tile = case
            c = inputs[scene][0]
            fn = jax.jit(functools.partial(
                _jax_run_variant, jax_lab1, tile_r=tile,
                chunk_mode=chunk_mode, dot=dot, div=div))
            cache[case] = [np.asarray(a) for a in
                           fn(inputs["dirs_t"], c.m, c.k0, c.valid)]
        return cache[case]
    return get


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_plain_variant_matches_jax_kernel(case, inputs, jax_results):
    scene, chunk_mode, dot, div, tile = case
    want_t, want_idx = jax_results(case)
    m, k0, valid = inputs[scene][1]
    dirs_t = inputs["dirs_t_port"]
    before = labs.LAUNCHES_KERNEL_LAB
    t, idx = labs.kernel_lab_variant(dirs_t, m, k0, valid, tile_r=tile,
                                     chunk_mode=chunk_mode, dot=dot, div=div)
    assert labs.LAUNCHES_KERNEL_LAB == before  # CPU tensors: plain version
    assert t.dtype == torch.float32 and idx.dtype == torch.int32
    assert tuple(t.shape) == tuple(idx.shape) == (SIZE * SIZE,)
    idx_mismatch = int((idx.numpy() != want_idx).sum())
    hit = want_idx >= 0
    print(f"{case}: {hit.sum()} hit rays; idx mismatches {idx_mismatch}, "
          f"t differ on {int((t.numpy() != want_t).sum())}")
    assert hit.mean() > (0.9 if scene == "cornell32" else 0.05)
    if dot == "vpu":
        assert idx_mismatch == 0
        np.testing.assert_allclose(t.numpy(), want_t, rtol=5e-7)
    else:
        table, _ = labs.kernel_lab_table(m, k0, valid, chunk_mode)
        rule = labs.mxu_rule(dirs_t, table, (t, idx),
                             (torch.tensor(want_t), torch.tensor(want_idx)))
        print(f"  mxu rule: {rule}")
        assert idx_mismatch == MXU_IDX_MISMATCHES
        assert rule["t_over"] == 0 and rule["other"] == 0


@pytest.mark.parametrize("scene", ["cornell32", "random300"])
def test_vpu_recip_is_k5_and_chunks_agree(scene, inputs):
    """(tight, vpu, recip) and (pad128, vpu, recip) compute K5's function
    with K5's chunk: both equal the port's K5 (closest_hit at tri_chunk
    512) bit for bit; the padded triangles never hit."""
    m, k0, valid = inputs[scene][1]
    dirs_t = inputs["dirs_t_port"]
    k5 = intersect.closest_hit(dirs_t.T.contiguous(), m, k0, valid,
                               tri_chunk=512)
    for chunk_mode in labs.CHUNK_MODES:
        got = labs.kernel_lab_variant(dirs_t, m, k0, valid, tile_r=TILE,
                                      chunk_mode=chunk_mode, dot="vpu",
                                      div="recip")
        assert torch.equal(got[0], k5[0]) and torch.equal(got[1], k5[1])


def test_tf32_split_and_the_rule_has_teeth(inputs):
    """The TF32 rounding is to nearest with ties away from zero (as
    cvt.rna), and hi + lo leaves at most 2^-22 of x; one TF32 pass (hi
    only) breaks mxu_rule where 3xTF32 keeps it."""
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 2 ** -11),
                      3.14159265, -2.5e-3])
    hi = labs._tf32(x)
    assert hi.tolist()[:4] == [1.0, 1.0 + 2 ** -10, 1.0, -(1.0 + 2 ** -10)]
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    lo = labs._tf32(x - hi)
    assert bool(((x.double() - hi - lo).abs() <= 2 ** -22 * x.abs()).all())

    m, k0, valid = inputs["random300"][1]
    dirs_t = inputs["dirs_t_port"]
    table, C = labs.kernel_lab_table(m, k0, valid, "tight")
    want = labs.lab_sweep_reference(dirs_t, table, C, "vpu", "recip")
    good = labs.lab_sweep_reference(dirs_t, table, C, "mxu", "recip")
    rule = labs.mxu_rule(dirs_t, table, good, want)
    print(f"3xTF32 against float32: {rule}")
    assert rule["t_over"] == rule["other"] == 0 and rule["t_differ"] > 0
    single = labs._dots
    try:
        labs._dots = lambda d, blk, dot: [
            labs._dot3(labs._tf32(d), labs._tf32(blk[3 * k:3 * k + 3]))
            for k in range(3)]
        bad = labs.lab_sweep_reference(dirs_t, table, C, "mxu", "recip")
    finally:
        labs._dots = single
    rule = labs.mxu_rule(dirs_t, table, bad, want)
    print(f"1xTF32 against float32: {rule}")
    assert rule["t_over"] > 0


def test_wrapper_refuses_what_the_kernel_does_not_take(inputs):
    m, k0, valid = inputs["cornell32"][1]
    dirs_t = inputs["dirs_t_port"]
    kw = dict(chunk_mode="tight", dot="vpu", div="recip")
    with pytest.raises(ValueError, match="F23"):
        labs.kernel_lab_variant(dirs_t, m, k0, valid, tile_r=3 * TILE, **kw)
    with pytest.raises(ValueError, match="chunk_mode"):
        labs.kernel_lab_variant(dirs_t, m, k0, valid, tile_r=TILE,
                                **dict(kw, chunk_mode="pad64"))
    with pytest.raises(ValueError, match="dot"):
        labs.kernel_lab_variant(dirs_t, m, k0, valid, tile_r=TILE,
                                **dict(kw, dot="mma"))


def test_lab1_runs_on_the_cpu(capsys):
    """The lab as a user runs it (--device cpu at 64^2, the random scene
    cut to 300 triangles, 2 timed calls): tiles 2048 and 4096 (8192 does
    not divide 4096 rays: skipped), 16 rows a scene, each (vpu, recip)
    row equal to the shipped K5 on every ray, nothing launched."""
    assert kernel_lab.main(["--device", "cpu", "--size", "64", "--iters",
                            "2", "--triangles", str(RANDOM_T)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["card"] is None and res["skipped_tiles"] == [8192]
    assert set(res["scenes"]) == {"cornell32", f"stl{RANDOM_T}"}
    for scene in res["scenes"].values():
        rows = scene["variants"]
        assert len(rows) == 16 and scene["shipped_ms"] > 0
        for r in rows:
            if (r["dot"], r["div"]) == ("vpu", "recip"):
                assert r["idx_mismatch"] == r["t_mismatch"] == 0
    assert res["launches"] == {"closest_hit": 0, "kernel_lab_variant": 0}
