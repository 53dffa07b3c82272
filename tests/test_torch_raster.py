"""The parity rasterizer (raytpu_torch.ops.raster, render.rasterize_full)
against the JAX package's, stage by stage, and against the numpy oracle.

Inputs are the JAX package's own (the Cornell box, the rasteriser camera
scaled to the image) carried across as numpy. Integers (screen
coordinates, row bounds, winners) must be identical. The float tables are
bit-equal where the camera is unturned; with a yaw, the rotation's cos/sin
and XLA:CPU's fused products (ROADMAP fault F4) move them by ulps, and
each table is held to 16 float32 eps of its largest entry (measured: at
most 7). Images and focal distances within atol 1e-6.

Mode 'clean' through rasterize_full is compared stage by stage, eagerly:
under jit XLA:CPU fuses the closed-form ``x_i + k * step`` of row_bounds
into an FMA, which moves a truncated row end by a pixel, so the JAX
package's own jitted frame differs from its eager stages there. (The
clean mode of ``rasterize`` is rasterize_exact, tests/test_torch_rasterize.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.ops import raster as jax_raster
from raytpu.render.rasterize import rasterize_full as jax_rasterize_full

from raytpu_torch import convert
from raytpu_torch.core.cornell import cornell_box_numpy
from raytpu_torch.core.image import quantize_u8
from raytpu_torch.core.stl import load_stl, procedural_stl_text
from raytpu_torch.core.types import RenderConfig
from raytpu_torch.oracle import rasterizer_oracle
from raytpu_torch.ops import raster
from raytpu_torch.render.rasterize import rasterize_full


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


def _camera(size, pos=(0.0, 0.0, -3.0), yaw=0.0):
    return JaxCamera.make(pos, yaw=yaw, focal=float(size), y_scale=1.01,
                          dof_focus=1.9)


def _both(scene, camera, lights):
    return (convert.scene_from_numpy(leaves(scene), device="cpu"),
            convert.camera_from_numpy(leaves(camera), device="cpu"),
            convert.lights_from_numpy(leaves(lights), device="cpu"))


# The CLI's view scaled to 32^2; a close, turned camera whose vertices
# project far off screen (starts outside [-H, 2H), walks longer than 2H);
# the box padded to 32 in chunks of 8 (four resolve_depth chunks).
CASES = {
    "cli": dict(pos=(0.0, 0.0, -3.0), yaw=0.0, pad_to=None, chunk=64),
    "close": dict(pos=(0.3, 0.2, -1.05), yaw=0.35, pad_to=None, chunk=64),
    "chunked": dict(pos=(0.0, 0.0, -3.0), yaw=0.0, pad_to=32, chunk=8),
}
SIZE = 32


def _case(name):
    c = CASES[name]
    scene = jax_cornell_box(pad_to=c["pad_to"])
    camera = _camera(SIZE, c["pos"], c["yaw"])
    lights = JaxLights.single(capacity=1)
    jcfg = JaxRenderConfig(width=SIZE, height=SIZE,
                           raster_tri_chunk=c["chunk"])
    cfg = RenderConfig(width=SIZE, height=SIZE, raster_tri_chunk=c["chunk"])
    return (scene, camera, lights, jcfg), (*_both(scene, camera, lights), cfg)


def _assert_tables(got, want, names, turned=False):
    eps = float(np.finfo(np.float32).eps)
    for name, g, w in zip(names, got, want):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.dtype == w.dtype, name
        if g.dtype != np.float32 or not turned:
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        scale = eps * np.abs(w).max()
        print(f"{name}: max |diff| {np.abs(g - w).max() / scale:.2f} eps "
              f"of the largest entry")
        np.testing.assert_allclose(g, w, rtol=0, atol=16 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("name", list(CASES))
def test_vertex_stage_and_cull_mask_match_jax(name):
    (scene, camera, lights, jcfg), (s, c, _, cfg) = _case(name)
    _assert_tables(raster.vertex_stage(s, c, cfg),
                   jax_raster.vertex_stage(scene, camera, jcfg),
                   ("px", "py", "zinv", "pos3d"), turned=name == "close")
    for back, frustum in ((True, True), (True, False), (False, True)):
        np.testing.assert_array_equal(
            raster.cull_mask(s, c, cfg.replace(backface_cull=back,
                                               frustum_cull=frustum)).numpy(),
            np.asarray(jax_raster.cull_mask(scene, camera, jcfg.replace(
                backface_cull=back, frustum_cull=frustum))))


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "closed"])
@pytest.mark.parametrize("name", list(CASES))
def test_row_bounds_match_jax(name, exact):
    """row_bounds_exact walks max|dy| + 1 samples (capped at 2H) where the
    JAX package scans 2H: identical tables show the early stop is exact.
    The close camera's edges start off screen and outrun 2H."""
    (scene, camera, lights, jcfg), (s, c, _, cfg) = _case(name)
    vd = raster.vertex_stage(s, c, cfg)
    jvd = jax_raster.vertex_stage(scene, camera, jcfg)
    fn, jfn = ((raster.row_bounds_exact, jax_raster.row_bounds_exact)
               if exact else (raster.row_bounds, jax_raster.row_bounds))
    got, want = fn(vd, cfg), jfn(jvd, jcfg)
    _assert_tables(got, want, raster.RowBounds._fields,
                   turned=name == "close")
    covered = got.left_x.numpy() != 2147483647
    assert covered.any() and not covered.all()
    if name == "close":
        H = SIZE
        assert (vd.py.numpy() < -H).any() or (vd.py.numpy() >= 2 * H).any()
        assert np.abs(np.diff(vd.py.numpy()[:, [0, 1, 2, 0]])).max() >= 2 * H


@pytest.mark.parametrize("name", list(CASES))
def test_resolve_depth_and_pixel_shade_match_jax(name):
    (scene, camera, lights, jcfg), (s, c, li, cfg) = _case(name)
    bounds = raster.row_bounds_exact(raster.vertex_stage(s, c, cfg), cfg)
    jbounds = jax_raster.row_bounds_exact(
        jax_raster.vertex_stage(scene, camera, jcfg), jcfg)
    keep = raster.cull_mask(s, c, cfg)
    g = raster.resolve_depth(bounds, keep, cfg)
    jg = jax_raster.resolve_depth(jbounds, jax_raster.cull_mask(
        scene, camera, jcfg), jcfg)
    mismatches = int((g.idx.numpy() != np.asarray(jg.idx)).sum())
    print(f"{name}: {int((g.idx >= 0).sum())} covered pixels, idx "
          f"mismatches {mismatches}")
    assert mismatches == 0
    _assert_tables(g, jg, ("idx", "zinv", "pos3d"), turned=name == "close")
    # pixel_shade on the JAX package's G-buffer.
    jg_t = raster.GBuffer(*(torch.tensor(np.asarray(a)) for a in jg))
    color, fd = raster.pixel_shade(jg_t, s, c, li, cfg)
    jcolor, jfd = jax_raster.pixel_shade(jg, scene, camera, lights, jcfg)
    np.testing.assert_allclose(color.numpy(), np.asarray(jcolor), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(fd.numpy(), np.asarray(jfd), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("mode,dof", [("parity", False), ("parity", True)])
def test_rasterize_full_matches_jax_64(mode, dof):
    size = 64
    scene, camera, lights = (jax_cornell_box(), _camera(size),
                             JaxLights.single(capacity=4))
    want = jax_rasterize_full(scene, camera, lights, JaxRenderConfig(
        width=size, height=size, mode=mode, dof_enabled=dof))
    got = rasterize_full(*_both(scene, camera, lights), RenderConfig(
        width=size, height=size, mode=mode, dof_enabled=dof))
    np.testing.assert_array_equal(got.gbuffer.idx.numpy(),
                                  np.asarray(want.gbuffer.idx))
    diff = np.abs(got.image.numpy() - np.asarray(want.image))
    print(f"{mode} dof={dof}: max |d image| {diff.max():.3g}")
    np.testing.assert_allclose(got.image.numpy(), np.asarray(want.image),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.focal_distances.numpy(),
                               np.asarray(want.focal_distances), rtol=0,
                               atol=1e-6)
    assert got.image.numpy().max() > 0.3


def test_parity_matches_the_oracle_128():
    """tests/test_rasterize_parity.py's rule: u8 within 1 step everywhere,
    >= 99.99% exact, focal distances within 1e-5."""
    size = 128
    from raytpu_torch.core.cornell import cornell_box
    from raytpu_torch.core.types import Camera, Lights
    out = rasterize_full(
        cornell_box(device="cpu"),
        Camera.make((0.0, 0.0, -3.0), focal=float(size), y_scale=1.01,
                    dof_focus=1.9, device="cpu"),
        Lights.single(capacity=1, device="cpu"),
        RenderConfig(width=size, height=size))
    img_o, fd_o, _ = rasterizer_oracle.render(
        cornell_box_numpy(), width=size, height=size, focal=float(size))
    diff = np.abs(quantize_u8(out.image.numpy()).astype(int)
                  - quantize_u8(img_o).astype(int)).max(axis=-1)
    assert (diff <= 1).all()
    assert (diff == 0).mean() >= 0.9999
    assert np.abs(out.focal_distances.numpy() - fd_o).max() < 1e-5


def test_parity_refuses_stl_scale_in_both_packages(tmp_path):
    """ROADMAP fault F8: parity rasterize raises for T > 64 with T % 64 !=
    0, in the JAX package and in the port; clean mode renders."""
    from raytpu.core.stl import load_stl as jax_load_stl
    from raytpu.render.rasterize import rasterize as jax_rasterize
    from raytpu_torch.core.types import Camera, Lights
    from raytpu_torch.render.rasterize import rasterize
    path = tmp_path / "small.stl"
    path.write_text(procedural_stl_text(7, 5))  # 70 triangles
    jscene = jax_load_stl(str(path), use_native=False)
    jcam = JaxCamera.make((0.0, -0.5, -5.0), focal=16.0)
    with pytest.raises(ValueError, match="not a multiple of 64"):
        jax_rasterize(jscene, jcam, JaxLights.single(capacity=1),
                      JaxRenderConfig(width=16, height=16))
    scene = load_stl(str(path), device="cpu")
    cam = Camera.make((0.0, -0.5, -5.0), focal=16.0, device="cpu")
    lights = Lights.single(capacity=1, device="cpu")
    with pytest.raises(ValueError, match="not a multiple of 64"):
        rasterize(scene, cam, lights, RenderConfig(width=16, height=16))
    img = rasterize(scene, cam, lights,
                    RenderConfig(width=16, height=16, mode="clean"))
    assert bool(torch.isfinite(img).all()) and float(img.max()) > 0.0


def test_to_i32_converts_as_xla():
    x = np.array([np.inf, -np.inf, np.nan, 3e9, -3e9, 2147483520.0,
                  -2147483648.0, 2.5, -2.5, -0.0], np.float32)
    np.testing.assert_array_equal(
        raster.to_i32(torch.tensor(x)).numpy(),
        np.asarray(jnp.asarray(x).astype(jnp.int32)))


def test_glm_inverse3_matches_jax():
    rng = np.random.default_rng(0)
    m = rng.uniform(-1.0, 1.0, (3, 3)).astype(np.float32)
    np.testing.assert_allclose(
        raster.glm_inverse3(torch.tensor(m)).numpy(),
        np.asarray(jax_raster.glm_inverse3(jnp.asarray(m))), rtol=1e-6)
