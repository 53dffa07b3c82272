"""The hard raytracer at STL scale: the plain versions of K5, K7d and K7a
(raytpu_torch.kernels.intersect) and ``raytrace_full`` on scenes of
several chunks, against the JAX package.

The kernels' plain versions are held to the JAX package's Pallas routes in
interpret mode (``intersect_pallas``, ``intersect_pallas_culled`` and the
``scene_geom`` branch of ``intersect_occluded_multi_pallas``, as
tests/test_cull.py runs them): at 64^2 JAX swizzles its rays into 32 x 64
pixel blocks, at 48^2 it pads row-major 2048-ray tiles; the port tiles
16 x 16 pixels either way. Winner index and occlusion bits agree bit for
bit, t to rtol 5e-7 (XLA:CPU contracts the plane products into FMAs, F4).
``raytrace_full`` is held to JAX's own CPU route (its jnp path, with a
tri_chunk dividing T): the image at atol 1e-6 (1e-5 with DoF) with at most
0.1% of pixels flipping winner, and its gradients to ``jax.grad`` at rtol
1e-4 / atol 1e-5, at 800 triangles (one-hot gathers) and 1,152
(indexing). The focal distances t |d| - focus are held at atol 1e-6 plus
2 float32 ulps of the distance times the winner's condition number (at
most 0.1% of pixels beyond): on a mesh, unlike the Cornell box's
axis-aligned walls, the three products of d . n and of n . b all differ
from 0 and partly cancel, and a 3-term dot product evaluated with and
without XLA:CPU's FMA contraction (F4) differs by up to 2 ulps of the sum
of its terms' magnitudes; so t moves by several ulps (measured up to 6 at
condition 7).

The scenes are the procedural torus of core/stl.py at 20 x 20 quads (800
triangles, 7 chunks of 128) and 24 x 24 (1,152, 9 chunks), seen from the
``render --stl`` camera (0, -0.5, -5), nudged off the plane x = 0, at
focal = the image width. On that plane the torus has a line of edges and
the light sits on it too, so its shadow rays graze those edges and an
ulp of FMA decides their occlusion bit (F4): both packages are right, and
the nudge keeps the comparison off that knife edge.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.core.types import Scene as JaxScene
from raytpu.kernels.intersect_pallas import closest_hit as jax_closest_hit
from raytpu.kernels.intersect_pallas import (
    intersect_occluded_multi_pallas,
    intersect_pallas,
    intersect_pallas_culled,
)
from raytpu.ops.intersect import intersect as jax_intersect
from raytpu.ops.intersect import tri_constants as jax_tri_constants
from raytpu.render.raytrace import camera_ray_dirs, pixel_grid
from raytpu.render.raytrace import raytrace_full as jax_raytrace_full

from raytpu_torch import convert
from raytpu_torch.core import stl
from raytpu_torch.core.types import RenderConfig
from raytpu_torch.kernels import intersect as kernels
from raytpu_torch.ops.intersect import TriConstants
from raytpu_torch.render.raytrace import raytrace_full

FLIP_FRAC = 0.001
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
CAM_POS = (0.0123, -0.5, -5.0)
SOURCES = np.array([[0.0, -0.5, -0.7], [0.4, -0.5, -0.7]], np.float32)


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


def _t(a):
    return torch.tensor(np.asarray(a))


@functools.lru_cache(maxsize=None)
def _mesh(n: int) -> JaxScene:
    """The procedural torus of n x n quads as a JAX scene."""
    tris = stl.parse_ascii_stl(stl.procedural_stl_text(n, n))
    tris = tris * np.float32(-stl.DEFAULT_SCALE)
    colors = np.stack([np.linspace(0.3, 0.9, tris.shape[0])] * 3,
                      axis=1).astype(np.float32)
    colors[:, 1] = colors[::-1, 0]
    return JaxScene(v0=jnp.asarray(tris[:, 0]), v1=jnp.asarray(tris[:, 1]),
                    v2=jnp.asarray(tris[:, 2]), color=jnp.asarray(colors),
                    active=jnp.ones(tris.shape[0], jnp.float32))


def _frame(size: int):
    """(scene, camera position, dirs) of a size^2 frame of the 800 mesh."""
    cam = JaxCamera.make(CAM_POS, focal=float(size))
    cfg = JaxRenderConfig(width=size, height=size)
    return _mesh(20), cam.pos, camera_ray_dirs(*pixel_grid(cfg), cam, cfg)


SIZES = [64, 48]


@pytest.fixture(scope="module")
def jax_sweeps():
    """JAX's three Pallas routes in interpret mode, once a size."""
    out = {}
    for size in SIZES:
        scene, cam, dirs = _frame(size)
        consts = jax_tri_constants(scene, cam)
        geom = (scene.v0, scene.v1, scene.v2)
        src = jnp.asarray(SOURCES)
        consts_src = jax.vmap(lambda o: jax_tri_constants(scene, o))(src)
        hits, occ = intersect_occluded_multi_pallas(
            dirs, consts, consts_src, cam, src, scene_geom=geom,
            image_hw=(size, size))
        out[size] = dict(
            brute=intersect_pallas(dirs, consts),
            culled=intersect_pallas_culled(dirs, consts, cam, *geom,
                                           image_hw=(size, size)),
            occluded=(hits, occ))
    return out


def _port_inputs(size):
    scene, cam, dirs = _frame(size)
    consts = TriConstants(*map(_t, jax_tri_constants(scene, cam)))
    src = _t(SOURCES)
    consts_src = TriConstants(*map(_t, jax.vmap(
        lambda o: jax_tri_constants(scene, o))(jnp.asarray(SOURCES))))
    geom = tuple(_t(v) for v in (scene.v0, scene.v1, scene.v2))
    return _t(dirs), consts, consts_src, _t(cam), src, geom


def _assert_hits_match(got, want):
    mismatches = int((got.idx.numpy() != np.asarray(want.idx)).sum())
    assert mismatches == 0, f"{mismatches} idx mismatches"
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    hit = got.hit.numpy()
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=5e-7)
    assert 0.1 < hit.mean() < 0.9


@pytest.mark.parametrize("size", SIZES)
def test_k5_and_k7d_plain_versions_match_pallas(jax_sweeps, size):
    dirs, consts, _, cam, _, geom = _port_inputs(size)
    before = (kernels.LAUNCHES_CLOSEST, kernels.LAUNCHES_CLOSEST_MASKED)
    brute = kernels.intersect_closest(dirs, consts)
    culled = kernels.intersect_closest_culled(dirs, consts, cam, *geom,
                                              image_hw=(size, size))
    _assert_hits_match(brute, jax_sweeps[size]["brute"])
    _assert_hits_match(culled, jax_sweeps[size]["culled"])
    # Culled equals brute within the port, bit for bit.
    assert torch.equal(brute.t, culled.t)
    assert torch.equal(brute.idx, culled.idx)
    assert brute.idx.dtype == torch.int32
    assert (kernels.LAUNCHES_CLOSEST,
            kernels.LAUNCHES_CLOSEST_MASKED) == before
    # The port's tiles cull: most (tile, chunk) pairs are skipped.
    tiles = kernels.ray_tiles(size * size, (size, size), "cpu")
    mask = kernels.primary_mask(cam, dirs, tiles, *geom, consts.valid, 128)
    assert mask.shape == (tiles.count, 7) and 0.05 < mask.float().mean() < 0.8


@pytest.mark.parametrize("size", SIZES)
def test_k7a_plain_version_matches_pallas(jax_sweeps, size):
    dirs, consts, consts_src, cam, src, geom = _port_inputs(size)
    before = kernels.LAUNCHES_OCCLUDED_MASKED
    hits, occ = kernels.intersect_occluded_multi(
        dirs, consts, consts_src, cam, src, scene_geom=geom,
        image_hw=(size, size))
    want_hits, want_occ = jax_sweeps[size]["occluded"]
    _assert_hits_match(hits, want_hits)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want_occ))
    assert occ.shape == (2, size * size) and occ.any()
    assert not occ[:, ~hits.hit].any()
    assert kernels.LAUNCHES_OCCLUDED_MASKED == before
    # Its mask against an all-ones mask, and its hits against K5's.
    tiles = kernels.ray_tiles(size * size, (size, size), "cpu")
    mask = kernels.fused_mask(dirs, tiles, geom, consts.valid, src, cam, 128)
    args = (dirs, consts.m, consts.k0, consts.valid, consts_src.m,
            consts_src.k0, cam, src)
    culled = kernels.closest_hit_occluded_multi_masked(*args, mask, tiles)
    brute = kernels.closest_hit_occluded_multi_masked(
        *args, torch.ones_like(mask), tiles)
    for a, b in zip(culled, brute):
        assert torch.equal(a, b)
    k5 = kernels.closest_hit(dirs, consts.m, consts.k0, consts.valid)
    assert torch.equal(culled[0], k5[0]) and torch.equal(culled[1], k5[1])
    assert float(mask.float().mean()) < 0.9


def test_flat_ray_tiles_replicate_the_last_ray():
    """Without an image the tiles are runs of 256 rays, the last padded
    with the last ray (as JAX pads its 2048-ray tiles)."""
    tiles = kernels.ray_tiles(600, None, "cpu")
    assert (tiles.height, tiles.width, tiles.th, tiles.count) == (1, 600, 1,
                                                                  3)
    assert torch.equal(tiles.rays[:600], torch.arange(600))
    assert bool((tiles.rays[600:] == 599).all())
    assert torch.equal(tiles.tile, torch.arange(600) // 256)
    image = kernels.ray_tiles(20 * 40, (20, 40), "cpu")
    assert image.count == 2 * 3
    # Pixel (17, 35) lies in tile row 1, column 2; slots past the edge
    # clamp to the image's last row and column.
    assert int(image.tile[17 * 40 + 35]) == 1 * 3 + 2
    last = image.rays.reshape(6, 256)[5]
    assert int(last.max()) == 20 * 40 - 1 and int(last.min()) == 16 * 40 + 32
    with pytest.raises(ValueError, match="does not hold"):
        kernels.ray_tiles(100, (8, 8), "cpu")


@pytest.mark.parametrize("n_quads", [20, 24], ids=["800tri", "1152tri"])
def test_closest_hit_vjp_matches_jax(n_quads):
    """The VJP of t through ClosestHit against jax.vjp of closest_hit: the
    one-hot sums at 800 triangles, the gather and fixed-order sums at
    1,152; two backward calls bit-identical."""
    scene = _mesh(n_quads)
    cam = JaxCamera.make(CAM_POS, focal=32.0)
    cfg = JaxRenderConfig(width=32, height=32)
    dirs = camera_ray_dirs(*pixel_grid(cfg), cam, cfg)
    consts = jax_tri_constants(scene, cam.pos)
    t_bar = np.random.default_rng(5).uniform(0.5, 1.5, 1024).astype(
        np.float32)

    def jax_t(d, m, k0):
        t, idx = jax_closest_hit(d, m, k0, consts.valid, 1024, 512)
        return jnp.where(idx >= 0, t, 0.0)

    t_j, vjp = jax.vjp(jax_t, dirs, consts.m, consts.k0)
    want = vjp(jnp.asarray(t_bar))

    def port_grads():
        d, m, k0 = (_t(a).requires_grad_(True)
                    for a in (dirs, consts.m, consts.k0))
        t, idx = kernels.ClosestHit.apply(
            d, m, k0, _t(consts.valid),
            functools.partial(kernels.closest_hit, tri_chunk=512))
        torch.where(idx >= 0, t, 0.0).backward(_t(t_bar))
        return [a.grad for a in (d, m, k0)]

    got = port_grads()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    assert all(torch.equal(a, b) for a, b in zip(got, port_grads()))
    assert float(got[2].abs().max()) > 0.0


def _two_lights(soft_samples):
    return JaxLights.single(capacity=2, soft_samples=soft_samples).add(
        (0.4, -0.5, -0.7), (1.0, 0.8, 0.6), 7.0, key=jax.random.PRNGKey(1))


# name -> (quads, size, lights, config); all through K7a (S sources).
FRAMES = {
    "parity-1light": (20, 48, lambda: JaxLights.single(capacity=1),
                      dict(mode="parity")),
    "clean-1light": (20, 48, lambda: JaxLights.single(capacity=1),
                     dict(mode="clean")),
    "clean-soft2": (20, 32, lambda: JaxLights.single(capacity=1,
                                                     soft_samples=2),
                    dict(mode="clean", soft_shadow_samples=2)),
    "parity-2lights": (20, 40, lambda: _two_lights(1), dict(mode="parity")),
    "parity-aa2": (20, 32, lambda: JaxLights.single(capacity=1),
                   dict(mode="parity", aa_samples=2)),
    "clean-dof": (20, 40, lambda: JaxLights.single(capacity=1),
                  dict(mode="clean", dof_enabled=True)),
    "clean-1152tri-gather": (24, 32, lambda: _two_lights(1),
                             dict(mode="clean")),
}


def _inputs(quads, size, lights):
    scene = _mesh(quads)
    camera = JaxCamera.make(CAM_POS, focal=float(size))
    port = [convert.scene_from_numpy(leaves(scene), device="cpu"),
            convert.camera_from_numpy(leaves(camera), device="cpu"),
            convert.lights_from_numpy(leaves(lights), device="cpu")]
    return (scene, camera, lights), port


def _assert_close_but_flips(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    bad = np.abs(got - want) > atol
    if bad.ndim == 3:
        bad = bad.any(axis=-1)
    print(f"{int(bad.sum())} of {bad.size} pixels beyond atol {atol}")
    assert bad.mean() <= FLIP_FRAC


def _fd_tolerance(scene, camera, cfg) -> np.ndarray:
    """(H, W) bound on |fd - fd_jax|: 1e-6 plus 2 ulps of the distance
    times the largest condition number, over the sub-rays, of the winner's
    t = (n . b) / -(d . n): sum |d_i n_i| / |d . n| + sum |n_i b_i| /
    |n . b|, b = camera - v0."""
    consts = jax_tri_constants(scene, camera.pos)
    m, k0 = np.asarray(consts.m), np.asarray(consts.k0)
    nb = np.abs(m[:, 0] * (np.asarray(camera.pos) - np.asarray(scene.v0)))
    xs, ys = pixel_grid(cfg)
    n_sub = max(cfg.aa_samples, 1)
    offsets = [0.0] if n_sub == 1 else [-0.5 + k / (n_sub - 1)
                                        for k in range(n_sub)]
    tol = np.zeros(xs.shape[0], np.float64)
    for dy in offsets:
        for dx in offsets:
            dirs = camera_ray_dirs(xs + dx, ys + dy, camera, cfg)
            hits = jax_intersect(dirs, consts, tri_chunk=32)
            i = np.maximum(np.asarray(hits.idx), 0)
            dn = np.asarray(dirs) * m[i, 0]
            cond = (np.abs(dn).sum(1) / np.abs(dn.sum(1))
                    + nb[i].sum(1) / np.abs(k0[i]))
            hit = np.asarray(hits.hit)
            dist = np.where(hit, np.asarray(hits.t), 0.0) * np.linalg.norm(
                np.asarray(dirs), axis=1)
            bound = 2 * np.finfo(np.float32).eps * cond * dist
            tol = np.maximum(tol, np.where(hit, bound, 0.0))
    return 1e-6 + tol.reshape(cfg.height, cfg.width)


@pytest.mark.parametrize("name", list(FRAMES))
def test_stl_frame_matches_jax(name):
    quads, size, make_lights, kw = FRAMES[name]
    (scene, camera, lights), port = _inputs(quads, size, make_lights())
    jcfg = JaxRenderConfig(width=size, height=size, use_pallas=False,
                           tri_chunk=32, **kw)
    want = jax_raytrace_full(scene, camera, lights, jcfg)
    before = kernels.LAUNCHES_OCCLUDED_MASKED
    got = raytrace_full(*port, RenderConfig(width=size, height=size, **kw))
    assert kernels.LAUNCHES_OCCLUDED_MASKED == before
    _assert_close_but_flips(got.image, want.image,
                            1e-5 if kw.get("dof_enabled") else 1e-6)
    fd_err = np.abs(got.focal_distances.numpy()
                    - np.asarray(want.focal_distances))
    tol = _fd_tolerance(scene, camera, jcfg)
    print(f"fd beyond 1e-6: {int((fd_err > 1e-6).sum())}; largest error "
          f"{fd_err.max():.3g} at {(fd_err / tol).max():.3f} of its bound")
    assert (fd_err > tol).mean() <= FLIP_FRAC
    img = got.image.numpy()
    assert np.isfinite(img).all() and img.max() > 0.1


@pytest.mark.parametrize("quads,kw", [
    (20, dict(mode="clean", soft_shadow_samples=2)),
    (24, dict(mode="parity", aa_samples=2)),
], ids=["800tri-clean-soft2", "1152tri-parity-aa2"])
def test_stl_grads_match_jax(quads, kw):
    """jax.grad of mean(image^2) + 0.1 mean(fd^2) over every leaf, against
    the port's autograd through K7a's analytic VJP and the attribute
    gathers (one-hot at 800, indexing at 1,152)."""
    size = 24
    lights = JaxLights.single(capacity=1, soft_samples=2)
    (scene, camera, lights), port = _inputs(quads, size, lights)
    jcfg = JaxRenderConfig(width=size, height=size, use_pallas=False,
                           tri_chunk=32, **kw)

    def loss(s, c, l):
        out = jax_raytrace_full(s, c, l, jcfg)
        return (jnp.mean(out.image ** 2)
                + 0.1 * jnp.mean(out.focal_distances ** 2))

    want = [leaves(g) for g in
            jax.grad(loss, argnums=(0, 1, 2))(scene, camera, lights)]
    for value in port:
        for t in vars(value).values():
            t.requires_grad_(True)
    out = raytrace_full(*port, RenderConfig(width=size, height=size, **kw))
    (torch.mean(out.image ** 2)
     + 0.1 * torch.mean(out.focal_distances ** 2)).backward()
    got = [convert.grads_to_numpy(v) for v in port]
    for part, g, w in zip(("scene", "camera", "lights"), got, want):
        assert g.keys() == w.keys()
        for field in w:
            np.testing.assert_allclose(
                g[field], w[field], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                err_msg=f"{part}.{field}")
    assert np.abs(got[0]["v0"]).max() > 0.0
    assert np.abs(got[0]["color"]).max() > 0.0
