"""The kernels of the sharded paths, K7b, K7c and K8a, and the stats
variants of the soft aggregations, against the JAX package (Pallas in
interpret mode, as its own CPU tests run it).

JAX's CPU meshes turn Pallas off (``_resolve_pallas_for_mesh``), so its
sharded tests never reach K7b, K7c or K8a; the port's plain versions are
held here to ``occlusion_multi_pallas`` and ``resolve_winner_pallas``
called directly, on the same float32 inputs carried across as numpy:

  * K7b (``occlusion_multi`` without a mask) on the Cornell box padded to
    32 at 32^2, toward 1 and 4 sources, and K7b and K7c (with
    ``position_mask`` on the port's 16 x 16 tiles) on the 800-triangle
    procedural mesh toward 2 sources, against JAX's unmasked and culled
    kernels: occlusion bits equal for every point, misses included;
    ``position_mask`` equal to JAX's ``position_shadow_mask`` on the same
    tiles. The plain model of K7b's and K7c's work items
    (``occlusion_items_reference``: ``occlusion_plan``'s entries, each a
    run of a (tile, source)'s kept chunks, their bits ORed) against the
    plain versions and JAX's output on a crowded mask, position_mask, an
    all-ones mask and no mask; the plan lists every kept (tile, source,
    chunk) once, in order, and all ones plans what no mask does.
  * K8a (``raster_winner_chunked``) on the mesh at 32^2, the whole frame
    (y0 = 0) and its lower half (y0 = 16), from an off-grid camera (F4):
    winners equal.
  * ``SoftAggStats`` and ``PrimaryAggStats`` (agg, m, s) and their VJPs with
    a nonzero cotangent of s against ``_soft_agg_stats`` and
    ``_primary_agg_stats``, at the soft rules of
    tests/test_torch_soft_raster.py and tests/test_torch_soft_raytrace.py
    (forwards rtol 1e-5 / atol 1e-6, gradients atol 1e-5 after scaling),
    the raster one on rows 4..23 of the frame (y0 = 4).
  * Rows [y0, y0 + rows) of the K8b, K8c, K9a and K9c plain versions equal
    the same rows of the whole frame.
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
from raytpu.core.types import Scene as JaxScene
from raytpu.kernels import cull as jax_cull
from raytpu.kernels import raster_pallas as jax_raster
from raytpu.kernels import soft_raster_pallas as jax_soft
from raytpu.kernels import soft_raytrace_pallas as jax_srt
from raytpu.kernels.intersect_pallas import occlusion_multi_pallas
from raytpu.ops.intersect import intersect as jax_intersect
from raytpu.ops.intersect import tri_constants as jax_tri_constants
from raytpu.ops.raster import cull_mask as jax_cull_mask
from raytpu.render.raytrace import camera_ray_dirs, pixel_grid
from raytpu.render.soft import _screen_vertices as jax_screen_vertices

from raytpu_torch.core import stl
from raytpu_torch.kernels import intersect as isect
from raytpu_torch.kernels import raster
from raytpu_torch.kernels import soft_raster as sr
from raytpu_torch.kernels import soft_raytrace as srt
from raytpu_torch.kernels.intersect import TILE_RAYS, ray_tiles

# The 800-triangle mesh's camera, off the plane x = 0 (F13).
MESH_CAM = (0.0123, -0.5, -5.0)


def _t(a):
    return torch.tensor(np.asarray(a))


def _mesh() -> JaxScene:
    """The procedural torus of 20 x 20 quads (800 triangles)."""
    tris = stl.parse_ascii_stl(stl.procedural_stl_text(20, 20))
    tris = tris * np.float32(-stl.DEFAULT_SCALE)
    colors = np.stack([np.linspace(0.3, 0.9, tris.shape[0])] * 3,
                      axis=1).astype(np.float32)
    return JaxScene(v0=jnp.asarray(tris[:, 0]), v1=jnp.asarray(tris[:, 1]),
                    v2=jnp.asarray(tris[:, 2]), color=jnp.asarray(colors),
                    active=jnp.ones(tris.shape[0], jnp.float32))


def _hit_points(scene, cam_pos, focal, size):
    """The hit positions of a size^2 frame's rays (the camera position on a
    miss), as the sharded renderer forms them before its occlusion."""
    cam = JaxCamera.make(cam_pos, focal=focal)
    cfg = JaxRenderConfig(width=size, height=size)
    dirs = camera_ray_dirs(*pixel_grid(cfg), cam, cfg)
    hits = jax_intersect(dirs, jax_tri_constants(scene, cam.pos),
                         tri_chunk=max(scene.num_triangles, 512))
    t = jnp.where(hits.hit, hits.t, 0.0)
    return cam.pos[None, :] + t[:, None] * dirs, hits.hit


def _occlusion_inputs(scene, src):
    src = jnp.asarray(src)
    consts = jax.vmap(lambda o: jax_tri_constants(scene, o))(src)
    return consts, src


@pytest.mark.parametrize("n_src", [1, 4])
def test_occlusion_plain_matches_pallas_on_cornell(n_src):
    scene = jax_cornell_box(pad_to=32)
    pos, hit = _hit_points(scene, (0.0, 0.0, -2.0), 32.0, 32)
    rng = np.random.default_rng(n_src)
    src = np.array([[0.0, -0.5, -0.7]], np.float32)
    if n_src > 1:
        src = (src + rng.uniform(-0.1, 0.1, (n_src, 3))).astype(np.float32)
    consts, jsrc = _occlusion_inputs(scene, src)
    want = np.asarray(occlusion_multi_pallas(pos, consts, jsrc, scene.active))
    before = (isect.LAUNCHES_OCCLUSION, isect.LAUNCHES_OCCLUSION_MASKED)
    got = isect.occlusion_multi(_t(pos), _t(consts.m), _t(consts.k0),
                                _t(src), _t(scene.active), 512)
    assert (isect.LAUNCHES_OCCLUSION,
            isect.LAUNCHES_OCCLUSION_MASKED) == before  # CPU: plain
    assert got.dtype == torch.int32 and tuple(got.shape) == (n_src, 32 * 32)
    np.testing.assert_array_equal(got.numpy().astype(bool), want)
    hit = np.asarray(hit)
    assert want[:, hit].any() and not want[:, hit].all()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MESH_SIZE = 32


@pytest.fixture(scope="module")
def mesh_occlusion():
    """The 800-triangle mesh's hit points at 32^2 (the camera position on a
    miss) toward 2 sources, and JAX's unmasked and culled occlusion on
    them (one interpret-mode compile each, shared by the tests below)."""
    scene = _mesh()
    size = MESH_SIZE
    pos, hit = _hit_points(scene, MESH_CAM, float(size), size)
    src = np.array([[0.0, -0.5, -0.7], [0.4, -0.5, -0.7]], np.float32)
    consts, jsrc = _occlusion_inputs(scene, src)
    geom = (scene.v0, scene.v1, scene.v2)
    brute = np.asarray(occlusion_multi_pallas(pos, consts, jsrc, scene.active,
                                              tri_chunk=128))
    culled = np.asarray(occlusion_multi_pallas(
        pos, consts, jsrc, scene.active, tri_chunk=128, scene_geom=geom,
        image_hw=(size, size)))
    return dict(scene=scene, pos=pos, hit=hit, src=src, consts=consts,
                jsrc=jsrc, geom=geom, brute=brute, culled=culled)


def test_occlusion_plain_matches_pallas_on_mesh(mesh_occlusion):
    """K7b and K7c (7 chunks of 128) against JAX's unmasked and culled
    kernels; the culled one on JAX's 2048-point tiles, the port's on its
    16 x 16 tiles, and position_mask against JAX's mask on those."""
    c = mesh_occlusion
    scene, pos, hit, src = c["scene"], c["pos"], c["hit"], c["src"]
    consts, jsrc, geom = c["consts"], c["jsrc"], c["geom"]
    brute, culled = c["brute"], c["culled"]
    size = MESH_SIZE
    np.testing.assert_array_equal(culled, brute)

    args = (_t(pos), _t(consts.m), _t(consts.k0), _t(src), _t(scene.active))
    got = isect.occlusion_multi(*args, 128)
    np.testing.assert_array_equal(got.numpy().astype(bool), brute)
    tiles = ray_tiles(size * size, (size, size), "cpu")
    pgeom = tuple(_t(v) for v in geom)
    mask = isect.position_mask(_t(pos), tiles, pgeom, _t(scene.active),
                               _t(src), 128)
    assert tuple(mask.shape) == (tiles.count, 2 * 7)
    assert 0.0 < float(mask.float().mean()) < 0.9
    got_masked = isect.occlusion_multi(*args, 128, mask, tiles)
    np.testing.assert_array_equal(got_masked.numpy().astype(bool), brute)
    assert torch.equal(isect.occlusion_multi_masked_reference(
        *args, mask, tiles, tri_chunk=128), got_masked)
    # JAX's mask on the port's tiles.
    jc, jr = jax_cull.chunk_spheres(*geom, scene.active, 128)
    want_mask = np.asarray(jax_cull.position_shadow_mask(
        jnp.asarray(np.asarray(pos)[tiles.rays.numpy()]), jsrc, jc, jr,
        TILE_RAYS)).reshape(tiles.count, -1)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    hit = np.asarray(hit)
    assert brute[:, hit].any() and 0.1 < hit.mean() < 0.9


def _items_case(mesh_occlusion, kind: str, C: int):
    """The port's K7b / K7c inputs on the mesh fixture's points with chunks
    of C: the plain (pos, table, src), the tiles and a mask of ``kind``:
    "position" (position_mask), "ones", "none", or "crowded" (the kept
    chunks of both sources in three tiles: one keeping every chunk, two
    keeping a seeded random half)."""
    from raytpu_torch.kernels.tables import source_table
    c = mesh_occlusion
    pos, src, valid = _t(c["pos"]), _t(c["src"]), _t(c["scene"].active)
    table = source_table(_t(c["consts"].m), _t(c["consts"].k0), valid, C)
    tiles = ray_tiles(MESH_SIZE * MESH_SIZE, (MESH_SIZE, MESH_SIZE), "cpu")
    n_chunks = table.shape[1] // C
    shape = (tiles.count, 2 * n_chunks)
    if kind == "position":
        mask = isect.position_mask(pos, tiles, tuple(_t(v) for v in c["geom"]),
                                   valid, src, C)
    elif kind == "ones":
        mask = torch.ones(shape, dtype=torch.int32)
    elif kind == "none":
        mask, tiles = None, None
    else:
        rng = np.random.default_rng(20)
        mask = torch.zeros(shape, dtype=torch.int32)
        mask[1] = 1
        for t in (2, 3):
            mask[t] = torch.tensor(rng.integers(0, 2, shape[1]),
                                   dtype=torch.int32)
    return pos, table, src, mask, tiles


@pytest.mark.parametrize("kind", ["position", "ones", "none", "crowded"])
@pytest.mark.parametrize("C,run", [(32, 3), (32, isect.OCC_RUN), (128, 2)])
def test_occlusion_items_model_matches_plain_version(mesh_occlusion, kind, C,
                                                     run):
    """The plain model of K7b's and K7c's work items (occlusion_plan's
    entries, each tile's points swept over its run of kept chunks to their
    first blocker, the runs' bits ORed) gives the plain versions' bits
    exactly: occlusion_masked_reference on a mask that crowds its kept
    chunks into three tiles, on position_mask, and on an all-ones mask (=
    occlusion_reference); with no mask occlusion_reference, and with
    position_mask, all ones and no mask JAX's occlusion_multi_pallas."""
    pos, table, src, mask, tiles = _items_case(mesh_occlusion, kind, C)
    got = isect.occlusion_items_reference(pos, table, C, src, mask, tiles,
                                          run)
    brute = isect.occlusion_reference(pos, table, C, src)
    if mask is None:
        want = brute
    else:
        want = isect.occlusion_masked_reference(pos, table, C, src, mask,
                                                tiles)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if kind == "crowded":
        assert bool(got.any()) and not torch.equal(got, brute)
    else:
        np.testing.assert_array_equal(got.numpy().astype(bool),
                                      mesh_occlusion["brute"])


@pytest.mark.parametrize("kind", ["position", "ones", "crowded"])
@pytest.mark.parametrize("run", [1, 3, isect.OCC_RUN, 100])
def test_occlusion_plan_gives_each_kept_chunk_one_item(mesh_occlusion, kind,
                                                       run):
    """occlusion_plan lists every kept (tile, source, chunk) in exactly one
    entry, a pair's entries in order holding its kept chunks in order, at
    most ``run`` each; an all-ones mask plans the same entries as no
    mask."""
    C = 32
    _, table, _, mask, tiles = _items_case(mesh_occlusion, kind, C)
    n_chunks, S = table.shape[1] // C, 2
    plan = isect.occlusion_plan(mask, tiles.count, S, n_chunks, run)
    assert plan.shape[1] == 2
    chunks = {}
    for p, j in plan.tolist():
        got = isect.occlusion_entry_chunks(mask, p, j, n_chunks, run)
        assert 1 <= len(got) <= run
        assert j == len(chunks.setdefault(p, [])) // run
        chunks[p].extend(got)
    rows = mask.reshape(tiles.count * S, n_chunks)
    for p in range(tiles.count * S):
        want = torch.nonzero(rows[p]).squeeze(1).tolist()
        assert chunks.get(p, []) == want
    if kind == "ones":
        assert torch.equal(plan, isect.occlusion_plan(None, tiles.count, S,
                                                      n_chunks, run))
    assert plan.shape[0] == int((-(-(rows != 0).sum(dim=1) // run)).sum())


def test_occlusion_leaders_follow_equal_warps(mesh_occlusion):
    """occlusion_leaders on the mesh's points (a miss's point is the camera
    position): some warps follow another, each follower's points equal its
    leader's first point bit for bit, and a leader leads itself; on a 20 x
    20 grid (tiles past the edge) the slots outside the grid take no part,
    and a warp with none inside leads itself."""
    pos = _t(mesh_occlusion["pos"])
    for pts, hw in ((pos, (MESH_SIZE, MESH_SIZE)), (None, (20, 20))):
        if pts is None:
            rng = np.random.default_rng(21)
            pts = _t(rng.normal(size=(400, 3)).astype(np.float32))
            pts[:80] = pts[18 * 20:] = _t(np.float32([1.0, 2.0, 3.0]))
        tiles = ray_tiles(pts.shape[0], hw, "cpu")
        lead = isect.occlusion_leaders(pts, tiles)
        w = torch.arange(8)[None, :]
        assert bool((lead <= w).all())
        assert bool((lead[torch.arange(tiles.count)[:, None], lead] ==
                     lead).all())
        slots = tiles.rays.reshape(tiles.count, 8, 32)
        valid = isect._tile_slots_valid(tiles).reshape(tiles.count, 8, 32)
        followers = torch.nonzero(lead != w).tolist()
        assert followers
        for t, f in followers:
            want = pts[slots[t, lead[t, f], 0]]
            got = pts[slots[t, f][valid[t, f]]]
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32).expand_as(got))
    assert lead[:, 2:].eq(torch.arange(2, 8)).all()  # past the grid


def _raster_consts(size):
    """JAX's K8 constants of the mesh from an off-grid camera."""
    scene = _mesh()
    cam = JaxCamera.make(MESH_CAM, focal=float(size) + 0.23)
    cfg = JaxRenderConfig(width=size, height=size, mode="clean")
    sx, sy, zinv, _ = jax_screen_vertices(scene, cam, cfg)
    keep = jax_cull_mask(scene, cam, cfg.replace(frustum_cull=False))
    return jax_raster.raster_tri_constants(sx, sy, zinv, keep)


@pytest.mark.parametrize("y0", [0, 16])
def test_chunked_winner_matches_pallas(y0):
    size = 32
    rows = size - y0
    consts = _raster_consts(size)
    ys, xs = jnp.meshgrid(y0 + jnp.arange(rows, dtype=jnp.float32),
                          jnp.arange(size, dtype=jnp.float32), indexing="ij")
    want = np.asarray(jax_raster.resolve_winner_pallas(
        xs.reshape(-1), ys.reshape(-1), consts, tile_p=256))
    before = raster.LAUNCHES_WINNER_CHUNKED
    got = raster.resolve_winner(_t(consts), rows, size, y0=y0)
    assert raster.LAUNCHES_WINNER_CHUNKED == before  # CPU: plain
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(raster.raster_winner_chunked(_t(consts), rows, size,
                                                    128, y0), got)
    assert 0.1 < (want >= 0).mean() < 0.9


def test_row_blocks_equal_the_frame_rows():
    """K8b's, K8c's, K9a's and K9c's plain versions on rows [y0, y0 + rows)
    give those rows of the whole frame."""
    size, y0, rows = 32, 16, 16
    consts = _t(_raster_consts(size))
    full = raster.resolve_winner_chunked_reference(consts, size, size, 128)
    part = slice(y0 * size, (y0 + rows) * size)
    ones = torch.ones((4, 7), dtype=torch.int32)
    assert torch.equal(raster.raster_winner_masked(consts, rows, size, ones,
                                                   128, y0), full[part])
    small = consts[consts[:, 12] > 0][:100].contiguous()
    assert torch.equal(raster.raster_winner(small, rows, size, y0),
                       raster.raster_winner(small, size, size)[part])

    rng = np.random.default_rng(3)
    sconsts = _t(np.asarray(_soft_consts()[0]))
    agg, m, s = sr.soft_agg_fwd(sconsts, 20, 24, 8, None, 60.0, 60.0)
    agg_b, m_b, s_b = sr.soft_agg_fwd(sconsts, 8, 24, 8, None, 60.0, 60.0,
                                      y0=12)
    part = slice(12 * 24, 20 * 24)
    for a, b in ((agg[:, part], agg_b), (m[part], m_b), (s[part], s_b)):
        assert torch.equal(a, b)
    cot = _t(rng.normal(size=(11, 20 * 24)).astype(np.float32))
    cot[:, :12 * 24] = 0.0
    dc = sr.soft_agg_bwd(sconsts, m, cot, 20, 24, 8, None, 60.0, 60.0)
    dc_b = sr.soft_agg_bwd(sconsts, m_b, cot[:, part].contiguous(), 8, 24, 8,
                           None, 60.0, 60.0, y0=12)
    scale = float(dc.abs().max())
    np.testing.assert_allclose(dc_b.numpy() / scale, dc.numpy() / scale,
                               atol=1e-6)


def _soft_consts():
    """JAX's soft raster table of the box padded to 32 (24 x 20 frame, the
    off-grid camera of tests/test_torch_soft_kernels.py), its globals and
    lights tables."""
    scene = jax_cornell_box(pad_to=32)
    camera = JaxCamera.make((0.011, -0.007, -3.013), focal=500.23,
                            y_scale=1.01, dof_focus=1.9)
    cfg = JaxRenderConfig(width=24, height=20, mode="soft")
    sx, sy, zinv, pos3d = jax_screen_vertices(scene, camera, cfg)
    consts = jax_soft.soft_tri_constants(sx, sy, zinv, pos3d, scene.color,
                                         scene.normals(), scene.active)
    return (consts, jax_soft.camera_globals(camera, cfg),
            jax_soft.lights_table(JaxLights.single(capacity=2)))


def _scaled_close(got, want, atol=1e-5):
    want = np.asarray(want)
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=atol)


def test_soft_agg_stats_match_jax():
    """(agg, m, s) of rows 4..23 of the frame and the VJP with cotangents
    of agg, m and s (m's discarded by both)."""
    W, H, y0, tile_p, chunk, es, zs = 24, 20, 4, 256, 8, 60.0, 60.0
    consts, glob, lt = _soft_consts()
    coords = np.asarray(sr.pixel_coords(H, W, "cpu", y0=y0))
    pad = np.full((2, 2 * tile_p - H * W), -1e9, np.float32)
    jcoords = jnp.asarray(np.concatenate([coords, pad], axis=1))
    (agg, m, s), vjp = jax.vjp(
        lambda c: jax_soft._soft_agg_stats(c, glob, lt, jcoords, None, es,
                                           zs, 0.2, 2, tile_p, chunk, True),
        consts)
    rng = np.random.default_rng(11)
    P = 2 * tile_p
    g = np.zeros((10, P), np.float32)
    g[:, :H * W] = rng.normal(size=(10, H * W))
    g_m = np.zeros((1, P), np.float32)
    g_m[:, :H * W] = rng.normal(size=(1, H * W))
    g_s = np.zeros((1, P), np.float32)
    g_s[:, :H * W] = rng.normal(size=(1, H * W))
    (want_dc,) = vjp((jnp.asarray(g), jnp.asarray(g_m), jnp.asarray(g_s)))

    pc = _t(consts).requires_grad_(True)
    got = sr.SoftAggStats.apply(pc, H, W, chunk, None, es, zs, y0)
    for a, b in zip(got, (agg, m, s)):
        np.testing.assert_allclose(a.detach().numpy(),
                                   np.asarray(b)[..., :H * W].reshape(
                                       a.shape), rtol=1e-5, atol=1e-6)
    assert not got[1].requires_grad
    (dc,) = torch.autograd.grad([got[0], got[2]], pc,
                                [_t(g[:, :H * W]), _t(g_s[0, :H * W])])
    _scaled_close(dc.numpy(), want_dc)
    # The s cotangent matters: without it the gradient moves.
    (dc0,) = torch.autograd.grad(
        sr.SoftAggStats.apply(pc, H, W, chunk, None, es, zs, y0)[0], pc,
        _t(g[:, :H * W]))
    assert float((dc0 - dc).abs().max()) > 1e-3 * float(dc.abs().max())


def test_primary_agg_stats_match_jax():
    W, H, tile_p, chunk, es, zs = 24, 20, 256, 8, 40.0, 40.0
    R = W * H
    scene = jax_cornell_box(pad_to=32)
    camera = JaxCamera.raytracer_default()
    cfg = JaxRenderConfig(width=W, height=H, mode="soft")
    pri = jax_srt.primary_tri_constants(scene, camera.pos)
    glob = jnp.concatenate([camera.pos, jnp.zeros((13,), jnp.float32)])[None]
    lt = jax_soft.lights_table(JaxLights.single(capacity=2))
    dirs = np.asarray(camera_ray_dirs(*pixel_grid(cfg), camera, cfg)).T
    jdirs = jnp.asarray(np.concatenate(
        [dirs, np.repeat(dirs[:, -1:], 2 * tile_p - R, 1)], 1))
    (out, m, s), vjp = jax.vjp(
        lambda c, g_, d: jax_srt._primary_agg_stats(
            c, g_, lt, d, None, es, zs, 0.2, 2, srt.T_NEAR, tile_p, chunk,
            True), pri, glob, jdirs)
    rng = np.random.default_rng(12)
    P = 2 * tile_p
    g = np.zeros((9, P), np.float32)
    g[:, :R] = rng.normal(size=(9, R))
    g_s = np.zeros((1, P), np.float32)
    g_s[:, :R] = rng.normal(size=(1, R))
    want_dc, want_dg, want_dd = vjp((jnp.asarray(g), jnp.zeros((1, P)),
                                     jnp.asarray(g_s)))

    pc = _t(pri).requires_grad_(True)
    cam = _t(camera.pos).requires_grad_(True)
    d = _t(dirs).requires_grad_(True)
    got = srt.PrimaryAggStats.apply(pc, cam, d, es, zs, chunk)
    for a, b in zip(got, (out, m, s)):
        np.testing.assert_allclose(a.detach().numpy(),
                                   np.asarray(b)[..., :R].reshape(a.shape),
                                   rtol=1e-5, atol=1e-6)
    dc, dcam, dd = torch.autograd.grad([got[0], got[2]], [pc, cam, d],
                                       [_t(g[:, :R]), _t(g_s[0, :R])])
    for lo, hi in ((0, 10), (10, 13), (13, 16), (16, 17), (17, 18)):
        _scaled_close(dc.numpy()[:, lo:hi], np.asarray(want_dc)[:, lo:hi])
    _scaled_close(dcam.numpy(), np.asarray(want_dg)[0, :3])
    _scaled_close(dd.numpy(), np.asarray(want_dd)[:, :R])


def test_occlusion_wrapper_routes_by_device():
    """No route for devices other than the CPU and CUDA; CPU tensors take
    the plain version and count no launch. A point at its source has no
    blocker before it."""
    scene = jax_cornell_box(pad_to=32)
    src = np.array([[0.0, -0.5, -0.7]], np.float32)
    consts, _ = _occlusion_inputs(scene, src)
    args = (_t(consts.m), _t(consts.k0), _t(src), _t(scene.active))
    with pytest.raises(ValueError):
        isect.occlusion_multi(torch.zeros((4, 3), device="meta"),
                              *(a.to("meta") for a in args))
    before = (isect.LAUNCHES_OCCLUSION, isect.LAUNCHES_OCCLUSION_MASKED)
    occ = isect.occlusion_multi(_t(src).expand(4, 3), *args)
    assert not occ.any() and occ.shape == (1, 4)
    assert (isect.LAUNCHES_OCCLUSION,
            isect.LAUNCHES_OCCLUSION_MASKED) == before
