"""The port's chunk-cull math (raytpu_torch.kernels.cull) against the JAX
package's (raytpu/kernels/cull.py), on tests/test_cull.py's cluster scene
and on the 800-triangle procedural mesh.

Both packages get the same float32 inputs as numpy arrays. The masks agree
bit for bit at JAX's own ray tiles (512 rays on the cluster scene, JAX's
2048-ray 32 x 64 pixel blocks of a 64^2 frame on the mesh). The float
quantities behind them (centers, radii, cone axes and cosines) agree to a
few float32 ulps: XLA:CPU contracts products into FMAs and sums a tile's
2048 directions in its own order (ROADMAP fault F4).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.kernels import cull as jax_cull
from raytpu.kernels.intersect_pallas import _swizzle
from raytpu.render.raytrace import camera_ray_dirs, pixel_grid

from raytpu_torch.core import stl
from raytpu_torch.kernels import cull

CHUNK = 128
# Float quantities: a few float32 ulps of values of order 1-40.
ATOL, RTOL = 1e-5, 1e-5


def _cluster_tris(n_clusters=4, per_cluster=128, seed=0):
    """tests/test_cull.py::_cluster_scene's triangles: random triangles in
    well-separated clusters, cluster 0 on the camera axis."""
    rng = np.random.default_rng(seed)
    tris = []
    offsets = [(0.0, 0.0), (40.0, 0.0), (-40.0, 30.0), (0.0, -35.0)]
    for i in range(n_clusters):
        ox, oy = offsets[i % len(offsets)]
        center = np.array([ox, oy, 10.0 + 4.0 * i], np.float32)
        a = rng.normal(scale=0.6, size=(per_cluster, 3)) + center
        tris.append((a, a + rng.normal(scale=0.3, size=(per_cluster, 3)),
                     a + rng.normal(scale=0.3, size=(per_cluster, 3))))
    return [np.concatenate([t[k] for t in tris]).astype(np.float32)
            for k in range(3)]


def _mesh_tris():
    """The 800-triangle procedural torus (20 x 20 quads), the reference's
    STL scale and orientation, with its last 40 triangles inactive."""
    tris = stl.parse_ascii_stl(stl.procedural_stl_text(20, 20))
    tris = tris * np.float32(-stl.DEFAULT_SCALE)
    return [tris[:, k].copy() for k in range(3)]


def _dirs(size, pos, focal, swizzle_to=None):
    cam = JaxCamera.make(pos, focal=focal)
    cfg = JaxRenderConfig(width=size, height=size)
    d = camera_ray_dirs(*pixel_grid(cfg), cam, cfg)
    if swizzle_to is not None:
        d = _swizzle(d, size, size, *swizzle_to)
    return np.asarray(cam.pos), np.asarray(d)


# name -> (v0, v1, v2, active, origin, dirs, tile_r, sources)
def _case(name):
    if name == "cluster":
        v = _cluster_tris()
        active = np.ones(v[0].shape[0], np.float32)
        origin, dirs = _dirs(32, (0.0, 0.0, -2.0), 250.0)
        src = np.array([[0.0, -2.0, -1.0], [3.0, 1.0, 2.0]], np.float32)
        return (*v, active, origin, dirs, 512, src)
    v = _mesh_tris()
    active = np.ones(v[0].shape[0], np.float32)
    active[-40:] = 0.0
    # JAX's own tiles of a 64^2 frame: 32 x 64 pixel blocks of 2048 rays.
    origin, dirs = _dirs(64, (0.0, -0.5, -5.0), 64.0, swizzle_to=(32, 64))
    src = np.array([[0.0, -0.5, -0.7], [0.4, -0.5, -0.7], [1.5, 2.0, -1.0]],
                   np.float32)
    return (*v, active, origin, dirs, 2048, src)


CASES = ["cluster", "mesh800"]


@pytest.fixture(scope="module", params=CASES)
def case(request):
    return request.param, _case(request.param)


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _spheres(case):
    v0, v1, v2, active = case[1][:4]
    want = jax_cull.chunk_spheres(jnp.asarray(v0), jnp.asarray(v1),
                                  jnp.asarray(v2), jnp.asarray(active), CHUNK)
    got = cull.chunk_spheres(_t(v0), _t(v1), _t(v2), _t(active), CHUNK)
    return got, want


def test_chunk_spheres_match_jax(case):
    got, want = _spheres(case)
    _close(got[0], want[0])
    _close(got[1], want[1])
    # Empty chunks (radius -1) are the same ones.
    np.testing.assert_array_equal(got[1].numpy() < 0, np.asarray(want[1]) < 0)
    # Every active vertex lies in its chunk's sphere.
    v0, v1, v2, active = case[1][:4]
    verts = np.stack([v0, v1, v2], axis=1)
    for c, (cen, r) in enumerate(zip(got[0].numpy(), got[1].numpy())):
        sl = slice(c * CHUNK, (c + 1) * CHUNK)
        live = verts[sl][active[sl] > 0].reshape(-1, 3)
        if live.size:
            assert (np.linalg.norm(live - cen, axis=-1)
                    <= r * (1 + 1e-5) + 1e-5).all()


def test_tile_cones_match_jax(case):
    dirs, tile_r = case[1][5], case[1][6]
    want = jax_cull.tile_cones(jnp.asarray(dirs), tile_r)
    got = cull.tile_cones(_t(dirs), tile_r)
    _close(got[0], want[0])
    _close(got[1], want[1])
    # The cone bounds every direction of its tile.
    d = dirs.reshape(-1, tile_r, 3)
    dn = d / np.linalg.norm(d, axis=-1, keepdims=True)
    cos_all = np.sum(dn * got[0].numpy()[:, None, :], axis=-1)
    assert (cos_all >= got[1].numpy()[:, None] - 1e-6).all()


def test_keep_masks_match_jax_bitwise(case):
    name, (v0, v1, v2, active, origin, dirs, tile_r, src) = case
    jargs = [jnp.asarray(a) for a in (origin, dirs, v0, v1, v2, active)]
    want = np.asarray(jax_cull.chunk_mask_for(*jargs, tile_r, CHUNK))
    got = cull.chunk_mask_for(*(_t(a) for a in (origin, dirs, v0, v1, v2,
                                                  active)), tile_r, CHUNK)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # keep_mask from the pieces gives the same mask.
    (cen, rad), _ = _spheres(case)
    axes, cos_half = cull.tile_cones(_t(dirs), tile_r)
    np.testing.assert_array_equal(
        cull.keep_mask(_t(origin), axes, cos_half, cen, rad).numpy(), want)
    # The mask culls something on these scenes, and keeps something.
    assert 0.0 < want.mean() < 1.0, (name, want.mean())


def test_shadow_keep_mask_matches_jax_bitwise(case):
    name, (v0, v1, v2, active, origin, dirs, tile_r, src) = case
    jargs = [jnp.asarray(a) for a in (origin, dirs, v0, v1, v2, active)]
    primary = jax_cull.chunk_mask_for(*jargs, tile_r, CHUNK)
    jc, jr = jax_cull.chunk_spheres(*jargs[2:], CHUNK)
    want = np.asarray(jax_cull.shadow_keep_mask(primary, jc, jr,
                                                jnp.asarray(src)))
    (cen, rad), _ = _spheres(case)
    got = cull.shadow_keep_mask(_t(primary), cen, rad, _t(src))
    assert got.dtype == torch.int32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all(), name


@pytest.mark.parametrize("range_pad", [0.0, 0.25])
def test_position_shadow_mask_matches_jax_bitwise(case, range_pad):
    name, (v0, v1, v2, active, origin, dirs, tile_r, src) = case
    # Surface points of the rays at a few distances, misses at the origin.
    rng = np.random.default_rng(7)
    t = rng.uniform(0.0, 12.0, dirs.shape[0]).astype(np.float32)
    t[rng.uniform(size=t.shape) < 0.2] = 0.0
    pos = (origin[None, :] + t[:, None] * dirs).astype(np.float32)
    jc, jr = jax_cull.chunk_spheres(jnp.asarray(v0), jnp.asarray(v1),
                                    jnp.asarray(v2), jnp.asarray(active),
                                    CHUNK)
    want = np.asarray(jax_cull.position_shadow_mask(
        jnp.asarray(pos), jnp.asarray(src), jc, jr, tile_r, range_pad))
    (cen, rad), _ = _spheres(case)
    got = cull.position_shadow_mask(_t(pos), _t(src), cen, rad, tile_r,
                                    range_pad)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("part", ["cs_from_cos", "cs_from_sin",
                                  "angle_le_sum", "range_slack"])
def test_error_budgets_match_jax(part):
    """The helpers behind the masks, on random float32 inputs spanning
    their domains (degenerate ends included): the float outputs within a
    few ulps, the angle test's booleans bit for bit."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.2, 1.2, 4096).astype(np.float32)
    x[:8] = [-1.0, 1.0, 0.0, 1e-7, -1e-7, 0.9999999, 1.5, -1.5]
    y = np.abs(rng.uniform(-0.2, 1.2, 4096)).astype(np.float32)
    if part == "range_slack":
        got = cull._range_slack(_t(x), _t(y))
        want = jax_cull._range_slack(jnp.asarray(x), jnp.asarray(y))
        _close(got, want)
        return
    if part == "angle_le_sum":
        cos_a = rng.uniform(-1.0, 1.0, 4096).astype(np.float32)
        got = cull._angle_le_sum(_t(cos_a), cull._cs_from_cos(_t(x)),
                                 cull._cs_from_sin(_t(y)))
        want = jax_cull._angle_le_sum(
            jnp.asarray(cos_a), jax_cull._cs_from_cos(jnp.asarray(x)),
            jax_cull._cs_from_sin(jnp.asarray(y)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < np.asarray(want).mean() < 1
        return
    fn = "_cs_from_cos" if part == "cs_from_cos" else "_cs_from_sin"
    arg = x if part == "cs_from_cos" else y
    got = getattr(cull, fn)(_t(arg))
    want = getattr(jax_cull, fn)(jnp.asarray(arg))
    for g, w in zip(got, want):
        if isinstance(g, float):
            assert g == pytest.approx(float(w), rel=1e-7)
        else:
            # e_sin of a near-zero sine divides by the 1e-6 floor: a few
            # ulps of its inputs become that many ulps of it.
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-7)
