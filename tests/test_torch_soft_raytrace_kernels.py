"""The soft raytrace kernels' plain versions
(raytpu_torch.kernels.soft_raytrace) against the JAX package's
``soft_raytrace_pallas`` (Pallas in interpret mode).

On the CPU the port's wrappers run their plain versions; the CUDA kernels
K10a, K10c, K10g and K10i are held to those on the card
(tests/test_torch_gpu.py, chip_smoke.py). Both packages take one table, one
set of rays and one cotangent drawn from a numpy seed (JAX's tables and
directions carried across), so the only differences are float32
reassociation and the shadow's 1 / sqrt against JAX's rsqrt: the forwards
within 1e-5 relative, the gradients at rtol 1e-4 / atol 1e-5 after scaling
each column group by its own largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.kernels import soft_raytrace_pallas as jax_srt
from raytpu.kernels.soft_raster_pallas import lights_table
from raytpu.render.raytrace import camera_ray_dirs, pixel_grid

from raytpu_torch import convert
from raytpu_torch.core.types import Scene
from raytpu_torch.kernels import soft_raytrace as kernels

W, H = 24, 20
R = W * H
ES, ZS = 40.0, 40.0
TILE_P = 256  # 480 rays pad to 512 (replicated); pad rays take no cotangent
CHUNK = 8     # the box padded to 32 in 4 chunks
SRCS = np.array([[0.0, -0.5, -0.7], [0.31, -0.42, -0.55],
                 [-0.23, -0.61, -0.48]], np.float32)


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


def _t(a):
    return torch.tensor(np.asarray(a))


def _pad_rays(a, n):
    """(k, R) padded to (k, n) by replicating the last ray, as JAX pads."""
    a = np.asarray(a)
    return np.concatenate([a, np.repeat(a[:, -1:], n - a.shape[1], 1)], 1)


def within_groups(got, want, groups, rtol=1e-4, atol=1e-5):
    """The JAX tests' rule after scaling each column group by its own
    largest entry: {group: largest scaled |got - want|}; asserts the
    rule."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    errs = {}
    for name, lo, hi in groups:
        w, g = want[..., lo:hi], got[..., lo:hi]
        scale = max(np.abs(w).max(), 1e-12)
        errs[name] = np.abs(g - w).max() / scale
        assert (np.abs(g - w) <= atol * scale + rtol * np.abs(w)).all(), \
            (name, errs[name])
    return errs


@pytest.fixture(scope="module")
def cornell():
    """JAX's tables of the box padded to 32, its rays, its primary forward
    and backward and its shadow forward and backward toward three sources
    from the aggregated positions, on numpy cotangents."""
    scene = jax_cornell_box(pad_to=32)
    camera = JaxCamera.raytracer_default()
    lights = JaxLights.single(capacity=2)
    cfg = JaxRenderConfig(width=W, height=H, mode="soft")
    pri = jax_srt.primary_tri_constants(scene, camera.pos)
    shw = jax_srt.shadow_tri_constants(scene)
    glob = jnp.concatenate([camera.pos, jnp.zeros((13,), jnp.float32)])[None]
    lt = lights_table(lights)
    xs, ys = pixel_grid(cfg)
    dirs = np.asarray(camera_ray_dirs(xs, ys, camera, cfg)).T
    jdirs = jnp.asarray(_pad_rays(dirs, 2 * TILE_P))
    out, m, s = jax_srt._primary_fwd_impl(
        pri, glob, lt, jdirs, None, ES, ZS, 0.2, 2, kernels.T_NEAR, TILE_P,
        CHUNK, interpret=True)
    rng = np.random.default_rng(0)
    cot = np.zeros((10, 2 * TILE_P), np.float32)
    cot[:, :R] = rng.normal(size=(10, R)).astype(np.float32)
    dc, dg, dl, dd = jax_srt._pri_bwd_impl(
        pri, glob, lt, jdirs, None, m, jnp.asarray(cot), ES, ZS, 0.2, 2,
        kernels.T_NEAR, TILE_P, CHUNK, interpret=True)
    world = np.asarray(out)[3:6]
    srcs8 = jnp.asarray(np.concatenate([SRCS, np.zeros((3, 5), np.float32)],
                                       1))
    trans = jax_srt._shadow_fwd_impl(shw, srcs8, jnp.asarray(world), None, ES,
                                     ZS, TILE_P, CHUNK, interpret=True)
    gcot = np.zeros((3, 2 * TILE_P), np.float32)
    gcot[:, :R] = rng.normal(size=(3, R)).astype(np.float32)
    sdc, sdsrc, sdw, _ = jax_srt._shadow_bwd(
        ES, ZS, TILE_P, CHUNK, True,
        (shw, srcs8, jnp.asarray(world), None, trans), jnp.asarray(gcot))
    return dict(
        scene=scene, camera=camera, pri=np.asarray(pri),
        shw=np.asarray(shw), dirs=dirs, out=np.asarray(out)[:, :R],
        m=np.asarray(m)[0, :R], s=np.asarray(s)[0, :R], cot=cot[:, :R],
        dc=np.asarray(dc), dg=np.asarray(dg), dl=np.asarray(dl),
        dd=np.asarray(dd)[:, :R], world=world[:, :R],
        trans=np.asarray(trans)[:, :R], gcot=gcot[:, :R],
        sdc=np.asarray(sdc), sdsrc=np.asarray(sdsrc),
        sdw=np.asarray(sdw)[:, :R])


def test_tables_match_jax(cornell):
    c = cornell
    scene = convert.scene_from_numpy(leaves(c["scene"]), device="cpu")
    cam = convert.camera_from_numpy(leaves(c["camera"]), device="cpu")
    pri = kernels.primary_tri_constants(scene, cam.pos)
    shw = kernels.shadow_tri_constants(scene)
    assert pri.shape == (32, kernels.PRI_COLS) and pri.dtype == torch.float32
    assert shw.shape == (32, kernels.SHW_COLS)
    np.testing.assert_allclose(pri.numpy(), c["pri"], rtol=1e-6, atol=1e-6)
    # XLA:CPU may contract a cross product's products into FMAs (ROADMAP
    # fault F4): ulps.
    np.testing.assert_allclose(shw.numpy(), c["shw"], rtol=1e-6, atol=1e-6)
    # dmin (column 17) is 0 where the camera is within reach of a wall and
    # ~1.7e9 on the padding rows far away.
    assert pri[30:, 17].min() > 1e9 and (pri[:30, 17] >= 0).all()


def test_plain_primary_forward_matches_jax_kernel(cornell):
    c = cornell
    before = kernels.LAUNCHES_SRT_PRI_FWD
    out, m, s = kernels.primary_agg_fwd(_t(c["pri"]),
                                        _t(c["camera"].pos), _t(c["dirs"]),
                                        ES, ZS, CHUNK)
    assert kernels.LAUNCHES_SRT_PRI_FWD == before  # CPU: the plain version
    assert out.shape == (kernels.N_OUT, R)
    np.testing.assert_allclose(out.numpy(), c["out"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.numpy(), c["m"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), c["s"], rtol=1e-5, atol=1e-6)
    # Several walls in view, the rows [albedo, position, normal].
    assert torch.unique(out[0]).numel() > 20
    assert float(out[5].std()) > 0.01  # depth varies over the frame


def test_plain_primary_backward_matches_jax_vjp(cornell):
    c = cornell
    dc, dcam, dd = kernels.primary_agg_bwd(
        _t(c["pri"]), _t(c["camera"].pos), _t(c["dirs"]), _t(c["m"]),
        _t(c["cot"]), ES, ZS, CHUNK)
    errs = within_groups(dc.numpy(), c["dc"], kernels.PRI_GROUPS)
    errs.update(within_groups(dcam.numpy()[None], c["dg"][:, :3],
                              (("camera", 0, 3),)))
    errs.update(within_groups(dd.numpy().T, c["dd"].T, (("dirs", 0, 3),)))
    print(errs)
    assert not dc[:, kernels.PRI_USED:].any()


def test_jax_lights_and_globals_gradients_are_zero(cornell):
    """_primary_terms deletes the lights table and reads the globals' first
    three entries only (pos = g + t d): JAX's gradient for the lights
    table and globals 3-15 is exactly zero, and the port's kernels take
    neither. The camera position's is not, nor is column 16's (active),
    through log(active + 1e-20)."""
    c = cornell
    assert c["dl"].shape == (2, 8) and not c["dl"].any()
    assert c["dg"].shape == (1, 16) and not c["dg"][:, 3:].any()
    assert np.abs(c["dg"][:, :3]).max() > 1.0
    assert np.abs(c["dc"][:, 16]).max() > 1.0


def test_plain_shadow_forward_matches_jax_kernel(cornell):
    c = cornell
    before = kernels.LAUNCHES_SRT_SHW_FWD
    trans = kernels.shadow_trans_fwd(_t(c["shw"]), _t(SRCS), _t(c["world"]),
                                     ES, ZS, CHUNK)
    assert kernels.LAUNCHES_SRT_SHW_FWD == before
    assert trans.shape == (3, R)
    np.testing.assert_allclose(trans.numpy(), c["trans"], rtol=1e-5,
                               atol=1e-6)
    # Lit and shadowed points both.
    assert float(trans.max()) > 0.5 and float(trans.min()) < 0.01


def test_plain_shadow_backward_matches_jax_vjp(cornell):
    c = cornell
    dc, dsrc, dw = kernels.shadow_trans_bwd(
        _t(c["shw"]), _t(SRCS), _t(c["world"]), _t(c["trans"]),
        _t(c["gcot"]), ES, ZS, CHUNK)
    errs = within_groups(dc.numpy(), c["sdc"], kernels.SHW_GROUPS)
    errs.update(within_groups(dsrc.numpy(), c["sdsrc"][:, :3],
                              (("sources", 0, 3),)))
    errs.update(within_groups(dw.numpy().T, c["sdw"].T, (("world", 0, 3),)))
    print(errs)
    assert not dc[:, kernels.SHW_USED:].any()
    assert not c["sdsrc"][:, 3:].any()


def test_stale_docstrings_follow_the_code(cornell):
    """ROADMAP fault F12: the shadow kernel returns exp(-16 od) with od the
    plain sum of cov * occ (not a sum of log(1 - occ)), and the primary
    rows are [albedo, position, normal] (not shade, ambient, position)."""
    c = cornell
    world = _t(c["world"])
    shw = _t(c["shw"])
    od = sum(kernels.shadow_terms(shw[r:r + 8], _t(SRCS[0]), world[0:1],
                                  world[1:2], world[2:3], ES, ZS).sum(0)
             for r in range(0, 32, 8))
    np.testing.assert_allclose(np.exp(-16.0 * od.numpy()), c["trans"][0],
                               rtol=1e-5, atol=1e-6)
    # Rows 0-2 are an albedo (the box's colors lie in [0, 1]) and 6-8 a
    # normal: convex mixtures of the walls' (and the background's zeros).
    out = c["out"]
    assert out[0:3].min() >= 0.0 and out[0:3].max() <= 1.0
    norms = np.linalg.norm(out[6:9], axis=0)
    assert norms.max() <= 1.0 + 1e-5 and norms.max() > 0.5


def _tie_scene():
    """Two triangles seen from the origin: one in the plane z = 5 with
    corners (-1, -1), (1, -1), (-1, 1), where a ray with dx == dy has
    exactly u == v (the same products in the same order); one in the plane
    z = 0.1, hit by the ray (0, 0, 1) at t |d| = 0.1 exactly = t_near, on
    its edge u + v = 1."""
    v0 = [[-1.0, -1.0, 5.0], [-1.0, -1.0, 0.1]]
    v1 = [[1.0, -1.0, 5.0], [1.0, -1.0, 0.1]]
    v2 = [[-1.0, 1.0, 5.0], [-1.0, 1.0, 0.1]]
    color = [[0.9, 0.2, 0.1], [0.1, 0.8, 0.3]]
    return Scene.from_vertices(v0, v1, v2, color, device="cpu")


def test_tie_gradients_split_in_half_as_jax():
    """jnp.minimum and jnp.maximum pass half a tie's gradient to each side;
    rays aimed at u == v and at dist == t_near must give JAX's VJP."""
    scene = _tie_scene()
    cam = torch.zeros(3)
    pri = kernels.pad_rows(kernels.primary_tri_constants(scene, cam), 8)
    dirs = torch.tensor([[-0.6, -0.6, 5.0], [-0.2, -0.2, 5.0],
                         [0.0, 0.0, 1.0], [0.3, 0.3, 1.0],
                         [-0.5, 0.25, 5.0], [0.1, -0.7, 5.0],
                         [-0.61, -0.61, 5.0], [0.0, 0.0, 2.0]]).T.contiguous()
    cs = pri[:2]
    logit, _ = kernels.primary_terms(cs, cam, dirs[0:1], dirs[1:2],
                                     dirs[2:3], 3.0, 5.0)
    denom = -((dirs[0:1] * cs[:, 0:1] + dirs[1:2] * cs[:, 1:2])
              + dirs[2:3] * cs[:, 2:3])
    u = ((dirs[0:1] * cs[:, 3:4] + dirs[1:2] * cs[:, 4:5])
         + dirs[2:3] * cs[:, 5:6]) / denom
    v = ((dirs[0:1] * cs[:, 6:7] + dirs[1:2] * cs[:, 7:8])
         + dirs[2:3] * cs[:, 8:9]) / denom
    assert bool((u[0, :2] == v[0, :2]).all())  # u == v on the far wall
    t = cs[1, 9] / denom[1, 2]
    assert float(t) == np.float32(0.1)  # dist == t_near, |d| = 1
    out, m, s = kernels.primary_agg_reference(pri, cam, dirs, 3.0, 5.0, 8)
    rng = np.random.default_rng(1)
    cot = rng.normal(size=(10, 8)).astype(np.float32)
    got = kernels.primary_agg_bwd_reference(pri, cam, dirs, m,
                                            torch.tensor(cot), 3.0, 5.0, 8)
    glob = jnp.zeros((1, 16), jnp.float32)
    want = jax_srt._pri_bwd_impl(
        jnp.asarray(pri.numpy()), glob, jnp.zeros((1, 8), jnp.float32),
        jnp.asarray(dirs.numpy()), None, jnp.asarray(m.numpy()[None]),
        jnp.asarray(cot), 3.0, 5.0, 0.2, 1, kernels.T_NEAR, 8, 8,
        interpret=True)
    within_groups(got[0].numpy(), np.asarray(want[0]), kernels.PRI_GROUPS,
                  rtol=1e-5, atol=1e-6)
    within_groups(got[2].numpy().T, np.asarray(want[3]).T,
                  (("dirs", 0, 3),), rtol=1e-5, atol=1e-6)
    # A whole gradient (torch.clamp's, or a one-sided tie) would miss it.
    assert np.abs(np.asarray(want[0])[:2, :10]).max() > 1e-3


def test_gated_pairs_and_padding_chunks_contribute_exact_zeros():
    """Padding rows (n = 0), rays parallel to a plane and hits behind the
    camera get weight 0: finite outputs, and exactly zero gradient in
    those rows (only log(active)'s column on the padding rows, as JAX's
    where-VJP gives, and that weighted by w = 0)."""
    scene = _tie_scene()
    cam = torch.zeros(3)
    pri = kernels.pad_rows(kernels.primary_tri_constants(scene, cam), 8)
    pri = torch.cat([pri, torch.zeros(8, kernels.PRI_COLS)])  # a padding chunk
    # Parallel to both planes, and pointing away from both.
    dirs = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0],
                         [0.2, 0.1, 5.0]]).T.contiguous()
    out, m, s = kernels.primary_agg_reference(pri, cam, dirs, 3.0, 5.0, 8)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out[:, :2], torch.zeros(9, 2))  # the background
    assert torch.equal(s[:2], torch.ones(2)) and float(m[2]) > 10.0
    cot = torch.ones(10, 3)
    dc, dcam, dd = kernels.primary_agg_bwd_reference(pri, cam, dirs, m, cot,
                                                     3.0, 5.0, 8)
    assert bool(torch.isfinite(dc).all() and torch.isfinite(dd).all())
    assert not dc[2:].any() and not dd[:, :2].any()
    # The shadow: sources whose rays graze a plane or point away.
    shw = kernels.pad_rows(kernels.shadow_tri_constants(scene), 8)
    shw = torch.cat([shw, torch.zeros(8, kernels.SHW_COLS)])
    srcs = torch.tensor([[0.0, 0.0, 5.0], [-0.5, -0.5, 10.0]])
    world = torch.tensor([[3.0, 0.0, 5.0], [-0.5, -0.5, 2.0]]).T.contiguous()
    trans = kernels.shadow_trans_reference(shw, srcs, world, 3.0, 5.0, 8)
    assert bool(torch.isfinite(trans).all())
    dcs, dsrc, dw = kernels.shadow_trans_bwd_reference(
        shw, srcs, world, trans, torch.ones_like(trans), 3.0, 5.0, 8)
    assert bool(torch.isfinite(dcs).all() and torch.isfinite(dw).all())
    assert not dcs[2:].any()
    # Source 1 sees point 1 through the far wall at (-0.5, -0.5, 5): its
    # shadow there is deep; source 0 grazes the z = 5 plane at point 0.
    assert float(trans[1, 1]) < 1e-3 and float(trans[0, 0]) > 0.5


def test_zero_triangles_give_the_background():
    empty = torch.zeros((0, 3))
    scene = Scene(v0=empty, v1=empty, v2=empty, color=empty,
                  active=torch.zeros(0))
    from raytpu_torch.core.types import Camera, Lights, RenderConfig
    from raytpu_torch.render.soft import raytrace_soft
    img = raytrace_soft(
        scene, Camera.raytracer_default(device="cpu"),
        Lights.single(capacity=2, device="cpu"),
        RenderConfig(width=W, height=H, mode="soft"))
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    assert not img.any()


def test_wrappers_check_inputs():
    pri = torch.zeros(16, kernels.PRI_COLS)
    with pytest.raises(ValueError, match="chunk"):
        kernels._check_table(pri, kernels.PRI_COLS, 5)
    with pytest.raises(ValueError, match="consts"):
        kernels._check_table(pri[:, :16], kernels.PRI_COLS, 8)
    with pytest.raises(ValueError, match="no route"):
        kernels.primary_agg_fwd(pri.to("meta"), torch.zeros(3),
                                torch.zeros(3, 4), 1.0, 1.0, 8)
    # K10c's grid: the items (a tile a run of PRI_RUN chunks), at most the
    # blocks the card holds at once, and PARTIAL_BYTES of partials.
    assert kernels.pri_blocks(32, kernels.pri_items(1024, 1), 264) == 264
    assert kernels.pri_blocks(32, kernels.pri_items(1, 1), 264) == 1
    assert kernels.pri_blocks(9216, kernels.pri_items(1024, 288), 4096) \
        == kernels.PARTIAL_BYTES // (9216 * kernels.PRI_USED * 4)
