"""The loop branch's intersection kernels (raytpu_torch.kernels.intersect)
against the JAX package's ``intersect_occluded_pallas`` (K4) and
``intersect_occluded_multi_pallas`` (K6), Pallas in interpret mode.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are held to those on the card (tests/test_torch_gpu.py, chip_smoke.py).
The winner index and the occlusion bits agree bit for bit on every ray:
K4's on a miss ray is the raw bit of a shadow ray from the light to the
camera in both packages (F25), K6's is 0 on a miss in both (the JAX
wrapper masks misses); t agrees to rtol 5e-7, since
XLA:CPU contracts the plane products into FMAs. The VJP of t is held to
``jax.vjp`` through the same call, at ROADMAP's gradient rule.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.cornell import cornell_box_numpy as jax_cornell_box_numpy
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.core.types import Scene as JaxScene
from raytpu.kernels.intersect_pallas import (
    intersect_occluded_multi_pallas,
    intersect_occluded_pallas,
)
from raytpu.ops.intersect import TriConstants as JaxTriConstants
from raytpu.ops.intersect import tri_constants as jax_tri_constants
from raytpu.render.raytrace import camera_ray_dirs, pixel_grid

from raytpu_torch.kernels import intersect as kernels
from raytpu_torch.ops.intersect import TriConstants

SIZE = 16


def _t(a):
    return torch.tensor(np.asarray(a))


def _sources(n_src):
    """One light (K4), or 2 lights x 4 jittered samples (K6)."""
    if n_src == 1:
        lights = JaxLights.single(capacity=1)
        return lights.position
    lights = JaxLights.single(capacity=2, soft_samples=4).add(
        (0.4, -0.5, -0.7), (1.0, 1.0, 1.0), 7.0, key=jax.random.PRNGKey(1))
    return lights.jitter[:, :4].reshape(-1, 3)


# K4 on the Cornell box's 30 triangles, K6 with 8 sources on the box
# padded to 32: one interpret-mode run each.
CASES = [(None, 1), (32, 8)]


@pytest.mark.parametrize("pad_to,n_src", CASES,
                         ids=["k4-30tri-1src", "k6-32tri-8src"])
def test_kernels_plain_versions_match_pallas(pad_to, n_src):
    scene = jax_cornell_box(pad_to=pad_to)
    # A wide view (focal SIZE / 2), so the blocks' shadows are in frame.
    cam = JaxCamera.make((0.1, 0.05, -2.0), yaw=0.1, focal=SIZE / 2)
    cfg = JaxRenderConfig(width=SIZE, height=SIZE)
    xs, ys = pixel_grid(cfg)
    dirs = camera_ray_dirs(xs, ys, cam, cfg)
    R = dirs.shape[0]
    consts = jax_tri_constants(scene, cam.pos)
    src = _sources(n_src)
    consts_src = jax.vmap(lambda o: jax_tri_constants(scene, o))(src)
    rng = np.random.default_rng(n_src)
    t_bar = rng.uniform(-1.0, 1.0, R).astype(np.float32)

    def jax_fn(d, m, k0):
        c = JaxTriConstants(m, k0, consts.valid)
        if n_src == 1:
            hits, occ = intersect_occluded_pallas(
                d, c, JaxTriConstants(consts_src.m[0], consts_src.k0[0],
                                      consts.valid),
                cam.pos, src[0], tile_r=R)
            occ = occ[None]
        else:
            hits, occ = intersect_occluded_multi_pallas(
                d, c, consts_src, cam.pos, src, tile_r=R)
        return hits.t, (hits.idx, occ)

    want_t, vjp, (want_idx, want_occ) = jax.vjp(
        jax_fn, dirs, consts.m, consts.k0, has_aux=True)
    want_g = vjp(jnp.asarray(t_bar))

    d, m, k0 = (_t(x).requires_grad_(True)
                for x in (dirs, consts.m, consts.k0))
    c = TriConstants(m, k0, _t(consts.valid))
    if n_src == 1:
        hits, occ = kernels.intersect_occluded(
            d, c, TriConstants(_t(consts_src.m[0]), _t(consts_src.k0[0]),
                               c.valid), _t(cam.pos), _t(src[0]))
        occ = occ[None]
    else:
        hits, occ = kernels.intersect_occluded_multi(
            d, c, TriConstants(_t(consts_src.m), _t(consts_src.k0), c.valid),
            _t(cam.pos), _t(src))

    hit = np.asarray(want_idx) >= 0
    mismatches = int((hits.idx.numpy() != np.asarray(want_idx)).sum())
    # K4: every ray, the raw bit on misses (F25); K6: hit rays, and 0 on
    # misses below.
    rays = np.ones_like(hit) if n_src == 1 else hit
    occ_mismatches = int((occ.numpy() != np.asarray(want_occ))[:, rays].sum())
    print(f"{hit.sum()} hit rays of {R}; idx mismatches {mismatches}, occ "
          f"mismatches on the {rays.sum()} rays compared {occ_mismatches}, "
          f"occluded {int(occ.sum())}")
    assert mismatches == 0 and occ_mismatches == 0
    assert occ.dtype == torch.bool and tuple(occ.shape) == (n_src, R)
    if n_src > 1:
        assert not occ.numpy()[:, ~hit].any()  # K6: 0 on misses, by contract
    assert occ.numpy()[:, hit].any() and not occ.numpy()[:, hit].all()
    np.testing.assert_array_equal(hits.hit.numpy(), hit)
    np.testing.assert_allclose(hits.t.detach().numpy(), np.asarray(want_t),
                               rtol=5e-7)

    got_g = torch.autograd.grad(hits.t, (d, m, k0), torch.tensor(t_bar))
    for name, g, w in zip(("dirs", "m", "k0"), got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert np.abs(np.asarray(want_g[2])).max() > 1e-3
    assert not got_g[1][:, 1:].any()  # only the normal row takes a gradient


def test_wrappers_launch_nothing_on_cpu():
    scene = jax_cornell_box(pad_to=32)
    cam = JaxCamera.raytracer_default()
    cfg = JaxRenderConfig(width=8, height=8)
    dirs = _t(camera_ray_dirs(*pixel_grid(cfg), cam, cfg))
    c = TriConstants(*map(_t, jax_tri_constants(scene, cam.pos)))
    src = _t(_sources(8))
    cs = TriConstants(*map(_t, jax.vmap(
        lambda o: jax_tri_constants(scene, o))(np.asarray(src))))
    before = (kernels.LAUNCHES_OCCLUDED, kernels.LAUNCHES_OCCLUDED_MULTI)
    t, idx, occ = kernels.closest_hit_occluded_multi(
        dirs, c.m, c.k0, c.valid, cs.m, cs.k0, _t(cam.pos), src)
    want = kernels.closest_hit_occluded_multi_reference(
        dirs, c.m, c.k0, c.valid, cs.m, cs.k0, _t(cam.pos), src)
    for a, b in zip((t, idx, occ), want):
        assert torch.equal(a, b)
    one = kernels.closest_hit_occluded(dirs, c.m, c.k0, c.valid, cs.m[0],
                                       cs.k0[0], _t(cam.pos), src[0])
    # K4 is K6 with one source (every ray of this view hits, so K4's raw
    # miss bits, F25, do not show).
    assert bool((idx >= 0).all())
    assert torch.equal(one[0], t) and torch.equal(one[1], idx)
    assert torch.equal(one[2], occ[0])
    assert (kernels.LAUNCHES_OCCLUDED,
            kernels.LAUNCHES_OCCLUDED_MULTI) == before
    assert idx.dtype == occ.dtype == torch.int32
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kernels.closest_hit_occluded(dirs, c.m, c.k0, c.valid, cs.m[0],
                                     cs.k0[0], _t(cam.pos), src[0],
                                     tri_chunk=16)


def test_k4_miss_rays_carry_jax_raw_bit():
    """F25: with a small triangle across the light-to-camera segment, every
    miss ray's shadow ray (from the light to the camera, tz = 0) is
    blocked: JAX's K4 returns bit 1 on each miss, and so does the port's."""
    v0, v1, v2, color = jax_cornell_box_numpy()
    cam = JaxCamera.make((0.1, 0.05, -2.0), yaw=0.1, focal=SIZE / 2)
    light = np.asarray(JaxLights.single(capacity=1).position[0])
    pos = np.asarray(cam.pos)
    # A triangle of side ~0.03 centred on the segment's midpoint, in the
    # plane normal to the segment.
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
    cfg = JaxRenderConfig(width=SIZE, height=SIZE)
    dirs = camera_ray_dirs(*pixel_grid(cfg), cam, cfg)
    R = dirs.shape[0]
    consts = jax_tri_constants(scene, cam.pos)
    cl = jax_tri_constants(scene, light)
    hits, want = intersect_occluded_pallas(dirs, consts, cl, cam.pos, light,
                                           tile_r=R)
    miss = ~np.asarray(hits.hit)

    c = TriConstants(*map(_t, consts))
    got_hits, got = kernels.intersect_occluded(
        _t(dirs), c, TriConstants(_t(cl.m), _t(cl.k0), c.valid),
        _t(cam.pos), _t(light))
    print(f"{miss.sum()} miss rays of {R}; JAX bits on misses "
          f"{int(np.asarray(want)[miss].sum())}, port's "
          f"{int(got.numpy()[miss].sum())}")
    assert 0 < miss.sum() < R
    np.testing.assert_array_equal(got_hits.idx.numpy(), np.asarray(hits.idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.asarray(want)[miss].all() and got.numpy()[miss].all()
