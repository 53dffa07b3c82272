"""The soft raster kernels' plain versions (raytpu_torch.kernels.soft_raster)
against the JAX package's ``soft_raster_pallas`` (Pallas in interpret mode).

On the CPU the port's wrappers run their plain versions; the CUDA kernels
K9a-K9d are held to those on the card (tests/test_torch_gpu.py,
chip_smoke.py). The forward and backward are compared on one table (JAX's
constants carried across), one set of pixels and one cotangent drawn from a
numpy seed, so the only differences are float32 reassociation: the
aggregate within 1e-5 relative, d consts at the scaled atol 1e-5 of
tests/test_soft_raster_pallas.py::test_culled_matches_unculled.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.kernels import soft_raster_pallas as jax_soft
from raytpu.render.soft import _screen_vertices as jax_screen_vertices

from raytpu_torch import convert
from raytpu_torch.core.stl import load_stl, procedural_stl_text
from raytpu_torch.core.types import Camera, Lights, RenderConfig
from raytpu_torch.kernels import soft_raster as kernels
from raytpu_torch.kernels.raster import tile_rects
from raytpu_torch.render.soft import _screen_vertices, rasterize_soft

W, H = 24, 20
ES, ZS = 60.0, 60.0
TILE_P = 256  # 480 pixels pad to 512: JAX's padded pixels take no cotangent
CHUNK = 8     # the box padded to 32 in 4 chunks


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


def _t(a):
    return torch.tensor(np.asarray(a))


def _jax_consts(scene, camera, cfg):
    sx, sy, zinv, pos3d = jax_screen_vertices(scene, camera, cfg)
    return jax_soft.soft_tri_constants(sx, sy, zinv, pos3d, scene.color,
                                       scene.normals(), scene.active)


@pytest.fixture(scope="module")
def cornell():
    """JAX's table of the box padded to 32, its globals and lights tables,
    the padded pixel coordinates, JAX's forward (agg, m, s) and backward
    (dc, dg, dl) on a numpy cotangent."""
    scene = jax_cornell_box(pad_to=32)
    # Off the pixel grid: where an edge or a barycentric of 0 runs exactly
    # through pixels, XLA:CPU's fused products and the port's unfused ones
    # pick different sides of the kink (ROADMAP fault F4).
    camera = JaxCamera.make((0.011, -0.007, -3.013), focal=500.23,
                            y_scale=1.01, dof_focus=1.9)
    lights = JaxLights.single(capacity=2)
    cfg = JaxRenderConfig(width=W, height=H, mode="soft",
                          soft_edge_sharpness=ES, soft_z_sharpness=ZS)
    consts = _jax_consts(scene, camera, cfg)
    glob = jax_soft.camera_globals(camera, cfg)
    lt = jax_soft.lights_table(lights)
    coords = np.asarray(kernels.pixel_coords(H, W, "cpu"))
    pad = np.full((2, TILE_P * 2 - H * W), -1e9, np.float32)
    jcoords = jnp.asarray(np.concatenate([coords, pad], axis=1))
    agg, m, s = jax_soft._soft_agg_fwd_impl(
        consts, glob, lt, jcoords, None, ES, ZS, 0.2, 2, TILE_P, CHUNK,
        interpret=True)
    rng = np.random.default_rng(0)
    cot = np.zeros((11, TILE_P * 2), np.float32)
    cot[:, :H * W] = rng.normal(size=(11, H * W)).astype(np.float32)
    dc, dg, dl = jax_soft._bwd_impl(
        consts, glob, lt, jcoords, None, m, jnp.asarray(cot), ES, ZS, 0.2, 2,
        TILE_P, CHUNK, interpret=True)
    return dict(scene=scene, camera=camera, lights=lights, cfg=cfg,
                consts=np.asarray(consts), coords=coords,
                agg=np.asarray(agg)[:, :H * W], m=np.asarray(m)[0, :H * W],
                s=np.asarray(s)[0, :H * W], cot=cot[:, :H * W],
                dc=np.asarray(dc), dg=np.asarray(dg), dl=np.asarray(dl))


def test_constants_and_tables_match_jax(cornell):
    c = cornell
    s = convert.scene_from_numpy(leaves(c["scene"]), device="cpu")
    cam = convert.camera_from_numpy(leaves(c["camera"]), device="cpu")
    cfg = RenderConfig(width=W, height=H, mode="soft")
    sx, sy, zinv, pos3d = _screen_vertices(s, cam, cfg)
    got = kernels.soft_tri_constants(sx, sy, zinv, pos3d, s.color,
                                     s.normals(), s.active)
    assert got.shape == (32, kernels.CONST_COLS) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), c["consts"], rtol=2e-6, atol=1e-6)


def test_plain_forward_matches_jax_kernel(cornell):
    c = cornell
    before = (kernels.LAUNCHES_SOFT_FWD, kernels.LAUNCHES_SOFT_FWD_MASKED)
    agg, m, s = kernels.soft_agg_fwd(_t(c["consts"]), H, W, CHUNK, None, ES,
                                     ZS)
    assert (kernels.LAUNCHES_SOFT_FWD,
            kernels.LAUNCHES_SOFT_FWD_MASKED) == before  # CPU: plain
    assert agg.shape == (kernels.N_CH, H * W)
    np.testing.assert_allclose(agg.numpy(), c["agg"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.numpy(), c["m"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), c["s"], rtol=1e-5, atol=1e-6)
    # Several surfaces in view.
    assert torch.unique(agg[0]).numel() > 20


def test_plain_backward_matches_jax_vjp(cornell):
    c = cornell
    got = kernels.soft_agg_bwd(_t(c["consts"]), _t(c["m"]), _t(c["cot"]), H,
                               W, CHUNK, None, ES, ZS)
    want = c["dc"]
    scale = np.abs(want).max()
    print(f"max |dc| {scale:.3g}, scaled error "
          f"{np.abs(got.numpy() - want).max() / scale:.3g}")
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=1e-5)
    assert not got[:, 29:].any()
    # Column 28 (valid) takes 1 / (valid + 1e-20) on the padding rows.
    assert np.abs(want[30:, 28]).max() > 0.0


def test_jax_globals_and_lights_gradients_are_zero(cornell):
    """_chunk_terms never reads the camera-globals or lights tables
    (ROADMAP fault F3), so the port's kernels take neither: JAX's gradients
    for them are exactly zero."""
    assert not cornell["dg"].any() and not cornell["dl"].any()
    assert cornell["dg"].shape == (1, 16) and cornell["dl"].shape == (2, 8)


def _tie_table():
    """Two right triangles with integer corners, so that pixels on the grid
    meet exact ties: equal half-plane distances on the diagonal, equal
    segment distances beyond a corner, barycentrics at 0 on an edge and
    segment parameters at 0 or 1."""
    sx = torch.tensor([[2.0, 10.0, 2.0], [12.0, 12.0, 20.0]])
    sy = torch.tensor([[2.0, 2.0, 10.0], [4.0, 12.0, 12.0]])
    zinv = torch.tensor([[0.5, 0.25, 0.4], [0.3, 0.3, 0.3]])
    pos3d = torch.arange(18, dtype=torch.float32).reshape(2, 3, 3) / 17.0
    color = torch.tensor([[0.9, 0.2, 0.1], [0.1, 0.8, 0.3]])
    normal = torch.tensor([[0.0, 0.0, -1.0], [0.6, 0.0, -0.8]])
    consts = kernels.soft_tri_constants(sx, sy, zinv, pos3d, color, normal,
                                        torch.ones(2))
    return torch.cat([consts, torch.zeros(6, kernels.CONST_COLS)])


def test_tie_gradients_split_in_half_as_jax():
    """jnp.minimum and jnp.clip pass half a tie's gradient to each side,
    as torch.minimum does and torch.clamp does not; on this grid the
    plain backward meets hundreds of exact ties and must still equal JAX's
    VJP, which it would miss by whole pair gradients with clamp."""
    consts = _tie_table()
    Hs, Ws = 16, 24
    coords = kernels.pixel_coords(Hs, Ws, "cpu")
    px, py = coords[0][None, :], coords[1][None, :]
    c = consts[:2]
    e = [((c[:, 2 * b:2 * b + 1] - c[:, 2 * a:2 * a + 1])
          * (py - c[:, 2 * a + 1:2 * a + 2])
          - (c[:, 2 * b + 1:2 * b + 2] - c[:, 2 * a + 1:2 * a + 2])
          * (px - c[:, 2 * a:2 * a + 1])) * c[:, 6 + a:7 + a]
         for a, b in ((0, 1), (1, 2), (2, 0))]
    ties = int(((e[0] == e[1]) | (e[1] == e[2]) | (e[0] == e[2])).sum())
    assert ties > 20, ties
    es, zs = 3.0, 5.0
    agg, m, s = kernels.soft_agg_reference(consts, coords, None, es, zs, 8)
    rng = np.random.default_rng(1)
    cot = rng.normal(size=(11, Hs * Ws)).astype(np.float32)
    got = kernels.soft_agg_bwd_reference(consts, coords, None, m,
                                         torch.tensor(cot), es, zs, 8)
    want, _, _ = jax_soft._bwd_impl(
        jnp.asarray(consts.numpy()), jnp.zeros((1, 16)), jnp.zeros((1, 8)),
        jnp.asarray(coords.numpy()), None, jnp.asarray(m.numpy()[None]),
        jnp.asarray(cot), es, zs, 0.2, 1, Hs * Ws, 8, interpret=True)
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=1e-6)


def test_zero_triangles_give_the_background():
    empty = torch.zeros((0, 3))
    from raytpu_torch.core.types import Scene
    scene = Scene(v0=empty, v1=empty, v2=empty, color=empty,
                  active=torch.zeros(0))
    cfg = RenderConfig(width=W, height=H, mode="soft")
    img = rasterize_soft(
        scene, Camera.rasterizer_default(device="cpu"),
        Lights.single(capacity=2, device="cpu"), cfg)
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    assert not img.any()


def test_auto_cull_rule_matches_jax():
    """JAX culls where the image blocks into its 1,024-pixel tiles: not at
    the CLI's 500^2, at 512^2. The port decides the same way."""
    for size in ((500, 500), (512, 512), (40, 48), (64, 64), (96, 128)):
        assert kernels.cull_block(1024, *size) == jax_soft._cull_block(
            1024, *size), size
    assert kernels.cull_block(1024, 500, 500) is None
    assert kernels.cull_block(1024, 512, 512) == (32, 32)
    assert kernels.use_cull(None, 283, 500, 500) is False
    assert kernels.use_cull(None, 288, 512, 512) is True
    assert kernels.use_cull(None, 1, 512, 512) is False
    assert kernels.use_cull(False, 288, 512, 512) is False
    with pytest.raises(ValueError, match="tile"):
        kernels.use_cull(True, 283, 500, 500)


@pytest.fixture(scope="module")
def mesh64(tmp_path_factory):
    """A 64-triangle slice of the procedural F1 mesh, small on a 64^2
    screen, in both packages, with its table and camera."""
    path = tmp_path_factory.mktemp("stl") / "f1.stl"
    path.write_text(procedural_stl_text())
    full = load_stl(str(path), device="cpu")
    scene = type(full)(**{k: v[:64] for k, v in vars(full).items()})
    camera = Camera.make((-1.24, 0.14, -3.0), yaw=0.02, focal=120.37,
                         device="cpu")
    cfg = RenderConfig(width=64, height=64, mode="soft",
                       soft_edge_sharpness=10.0, soft_z_sharpness=20.0)
    sx, sy, zinv, pos3d = _screen_vertices(scene, camera, cfg)
    consts = kernels.soft_tri_constants(sx, sy, zinv, pos3d, scene.color,
                                        scene.normals(), scene.active)
    return scene, camera, cfg, consts


def test_keep_mask_matches_jax(mesh64):
    """The port's mask over its 16 x 16 tiles is JAX's soft_keep_mask on
    coordinates ordered tile by tile."""
    _, _, cfg, consts = mesh64
    rects = tile_rects(64, 64, "cpu")
    got = kernels.soft_keep_mask(rects, consts, 10.0, 20.0, 16)
    ys, xs = np.meshgrid(np.arange(64.0), np.arange(64.0), indexing="ij")
    tiles = [np.stack([xs[ty:ty + 16, tx:tx + 16].ravel(),
                       ys[ty:ty + 16, tx:tx + 16].ravel()])
             for ty in range(0, 64, 16) for tx in range(0, 64, 16)]
    coords = jnp.asarray(np.concatenate(tiles, axis=1).astype(np.float32))
    want = jax_soft.soft_keep_mask(coords, jnp.asarray(consts.numpy()), 10.0,
                                   20.0, 256, 16)
    assert got.dtype == torch.int32 and got.shape == (16, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    boxes, zmax, nonempty = kernels.soft_chunk_bounds(consts, 16)
    jb, jz, jn = jax_soft.soft_chunk_bounds(jnp.asarray(consts.numpy()), 16)
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(zmax.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(nonempty.numpy(), np.asarray(jn))


def test_culled_matches_unculled(mesh64):
    """Culling (soft_keep_mask) changes the image and the vertex gradients
    by no more than the ~1e-20 relative mass it drops, and it does drop
    (tile, chunk) pairs: tests/test_soft_raster_pallas.py's rule on the F1
    mesh instead of the reference model."""
    scene, camera, cfg, consts = mesh64
    lights = Lights.single(capacity=1, device="cpu")
    mask = kernels.soft_keep_mask(tile_rects(64, 64, "cpu"), consts, 10.0,
                                  20.0, 16)
    assert float(mask.float().mean()) < 0.9, "the mask culled nothing"

    def run(cull):
        v0 = scene.v0.clone().requires_grad_(True)
        s = type(scene)(**{**vars(scene), "v0": v0})
        img = rasterize_soft(s, camera, lights, cfg, cull=cull, chunk=16)
        (img ** 2).sum().backward()
        return img.detach(), v0.grad

    ref, g_ref = run(False)
    out, g_cul = run(True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6, rtol=1e-6)
    scale = max(float(g_ref.abs().max()), 1e-3)
    np.testing.assert_allclose(g_cul.numpy() / scale, g_ref.numpy() / scale,
                               atol=1e-5)
    assert 0.05 < float((out.sum(-1) > 0.05).float().mean()) < 0.95


def test_masked_plain_version_keeps_the_carry():
    """A chunk a pixel's tile does not keep leaves that pixel's (m, s, acc)
    exactly as they were; an all-ones mask equals no mask."""
    consts = _tie_table()
    coords = kernels.pixel_coords(32, 32, "cpu")
    ones = torch.ones((4, 1), dtype=torch.int32)
    full = kernels.soft_agg_fwd(consts, 32, 32, 8, None, 3.0, 5.0)
    same = kernels.soft_agg_fwd(consts, 32, 32, 8, ones, 3.0, 5.0)
    for a, b in zip(full, same):
        assert torch.equal(a, b)
    none = torch.tensor([[1], [0], [1], [0]], dtype=torch.int32)
    agg, m, s = kernels.soft_agg_fwd(consts, 32, 32, 8, none, 3.0, 5.0)
    dropped = kernels.expand_mask(none, 32, 32)[0] == 0
    assert int(dropped.sum()) == 512
    assert not agg[:, dropped].any() and not m[dropped].any()
    assert bool((s[dropped] == 1.0).all())
    kept = ~dropped
    assert torch.equal(agg[:, kept], full[0][:, kept])
    assert coords.shape == (2, 1024)
