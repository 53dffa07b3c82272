"""L5, lab 4's variants of the fused forward (raytpu_torch/kernels/labs.py::
run_variant), against the JAX lab's ``variant_kernel`` on the CPU.

bench/megakernel_lab4.py::run_variant passes no ``interpret=``, so the test
makes the same ``pl.pallas_call`` (its grid and block specs) with
``interpret=True`` around ``functools.partial(variant_kernel, ...)``. The
JAX lab is loaded by file path (``import bench`` finds bench.py). Inputs
as the lab makes them: the Cornell box padded to 32,
``Lights.single(capacity=1)``, the raytracer's default camera, clean;
here 32^2 with tiles of 256. The port's plain version runs on the same
inputs (the JAX package's constants, carried across as numpy, packed into
the port's table): idx and occ bit for bit, color and fd within atol 1e-6
(XLA:CPU's FMA contraction, ROADMAP fault F4).
"""

import functools
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.kernels import render_fused as jax_rf
from raytpu.kernels.intersect_pallas import _blocked_constants, _tight_chunk
from raytpu.ops.intersect import tri_constants as jax_tri_constants
from raytpu.render.raytrace import camera_ray_dirs, pixel_grid

from raytpu_torch.kernels import labs
from raytpu_torch.kernels.tables import pack_params, pack_tables
from raytpu_torch.labs import megakernel_lab4

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "jax_megakernel_lab4", ROOT / "bench" / "megakernel_lab4.py")
jax_lab4 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_lab4)

SIZE, TILE = 32, 256
VARIANTS = {name: (g, s) for g, s, name in megakernel_lab4.VARIANTS}


def _jax_run_variant(dirs_t, blk_p, blk_s, attrs, par, tile_r, C, gather,
                     shade):
    """megakernel_lab4.py::run_variant with interpret=True."""
    Rp = dirs_t.shape[1]

    def spec(shape, index):
        return pl.BlockSpec(shape, index, memory_space=pltpu.VMEM)

    def rows(k):
        return spec((k, tile_r), lambda i: (0, i))

    def whole(shape):
        return spec(shape, lambda i: (0, 0))

    return pl.pallas_call(
        functools.partial(jax_lab4.variant_kernel, C=C, gather=gather,
                          shade=shade),
        grid=(Rp // tile_r,),
        in_specs=[rows(3), whole((4 * C, 3)), whole((4 * C, 3)),
                  whole((2 * C, 3)), whole((8, 128))],
        out_specs=[rows(3), rows(1), rows(1), rows(1)],
        out_shape=[
            jax.ShapeDtypeStruct((3, Rp), jnp.float32),
            jax.ShapeDtypeStruct((1, Rp), jnp.float32),
            jax.ShapeDtypeStruct((1, Rp), jnp.int32),
            jax.ShapeDtypeStruct((1, Rp), jnp.int32),
        ],
        interpret=True,
    )(dirs_t, blk_p, blk_s, attrs, par)


@pytest.fixture(scope="module")
def inputs():
    """The lab's inputs (megakernel_lab4.py:171-191) at 32^2, in both
    packages' forms."""
    scene = jax_cornell_box(pad_to=32)
    lights = JaxLights.single(capacity=1)
    cam = JaxCamera.raytracer_default()
    cfg = JaxRenderConfig(width=SIZE, height=SIZE, mode="clean")
    xs, ys = pixel_grid(cfg)
    dirs_t = jnp.asarray(camera_ray_dirs(xs, ys, cam, cfg).T)
    c = jax_tri_constants(scene, cam.pos)
    cl = jax_tri_constants(scene, lights.position[0])
    C = _tight_chunk(32, 512)
    blk_p, _ = _blocked_constants(c.m, c.k0, c.valid, C)
    blk_s, _ = _blocked_constants(cl.m, cl.k0, c.valid, C)
    attrs = jnp.concatenate([jax_rf._pad_tri(scene.normals(), C),
                             jax_rf._pad_tri(scene.color, C)], axis=0)
    p_eff = lights.mask[0] * (lights.color[0] * lights.intensity[0])
    par = jax_rf._params_block(cam.pos, lights.position[0], p_eff,
                               cam.dof_focus)

    def t(a):
        return torch.tensor(np.asarray(a))

    port = dict(
        dirs_t=t(dirs_t).contiguous(),
        table=pack_tables(t(c.m), t(c.k0), t(c.valid), t(cl.m), t(cl.k0),
                          t(scene.normals()), t(scene.color), C),
        par=pack_params(t(cam.pos), t(lights.position[0]), t(p_eff),
                        t(cam.dof_focus)))
    return dict(jax=(dirs_t, blk_p, blk_s, attrs, par), port=port, C=C)


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request, inputs):
    gather, shade = VARIANTS[request.param]
    fn = jax.jit(functools.partial(_jax_run_variant, tile_r=TILE,
                                   C=inputs["C"], gather=gather,
                                   shade=shade))
    return request.param, [np.asarray(a) for a in fn(*inputs["jax"])]


def test_plain_variant_matches_jax_kernel(variant, inputs):
    name, (color, fd, idx, occ) = variant
    gather, shade = VARIANTS[name]
    p = inputs["port"]
    before = labs.LAUNCHES_VARIANT
    got = labs.run_variant(p["dirs_t"], p["table"], p["par"], TILE,
                           inputs["C"], gather, shade)
    assert labs.LAUNCHES_VARIANT == before  # CPU tensors: plain version
    assert [tuple(g.shape) for g in got] == [a.shape for a in
                                             (color, fd, idx, occ)]
    idx_mismatch = int((got[2].numpy() != idx).sum())
    occ_mismatch = int((got[3].numpy() != occ).sum())
    print(f"{name}: idx mismatches {idx_mismatch}, occ mismatches "
          f"{occ_mismatch} of {idx.size} rays")
    assert idx_mismatch == 0 and occ_mismatch == 0
    assert (idx >= 0).mean() > 0.9 and occ.any()
    np.testing.assert_allclose(got[0].numpy(), color, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), fd, rtol=0, atol=1e-6)


def test_full_variant_is_k1r(inputs):
    """mega-full computes K1r's function (clean, ambient 0.2): the plain
    versions agree entry for entry."""
    p = inputs["port"]
    got = labs.run_variant(p["dirs_t"], p["table"], p["par"], TILE,
                           inputs["C"], True, True)
    rays = labs.variant_rays_reference(p["dirs_t"].T.contiguous(),
                                       p["table"], p["par"], gather=True,
                                       shade=True)
    want = labs._rows(rays)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_lab4_runs_on_the_cpu(capsys):
    """The lab as a user runs it (--device cpu, small size): five rows,
    each variant's idx and occ equal to K1r's, mega-full equal on all
    four outputs."""
    assert megakernel_lab4.main(["--device", "cpu", "--size", "16",
                                 "--tile", "128"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"two-phase", *VARIANTS} <= set(res) and res["card"] is None
    assert res["mismatch_vs_k1r"]["mega-full"] == {"color": 0, "fd": 0,
                                                   "idx": 0, "occ": 0}
    for name in VARIANTS:
        assert res["mismatch_vs_k1r"][name]["idx"] == 0
        assert res["mismatch_vs_k1r"][name]["occ"] == 0
    assert res["launches"] == {"closest_hit_occluded": 0,
                               "megakernel_lab4_variant": 0,
                               "render_fused_fwd_rows": 0}
