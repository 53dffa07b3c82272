"""The port's intersection and shading ops (raytpu_torch.ops) against the
JAX package's XLA path.

Inputs are the JAX package's own values carried across as numpy, so the
comparison isolates each op. The winner index agrees bit for bit on every
ray (mismatches are counted); t agrees to rtol 5e-7, since XLA:CPU
contracts the plane products into FMAs and moves t by an ulp.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.ops import intersect as jax_intersect
from raytpu.ops import shade as jax_shade
from raytpu.render.raytrace import camera_ray_dirs, pixel_grid

from raytpu_torch import convert
from raytpu_torch.core.types import RenderConfig
from raytpu_torch.ops import intersect, shade


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module", params=[None, 32])
def frame(request):
    scene = jax_cornell_box(pad_to=request.param)
    cam = JaxCamera.make((0.15, -0.1, -1.8), yaw=0.2)
    cfg = JaxRenderConfig(width=40, height=24)
    xs, ys = pixel_grid(cfg)
    dirs = camera_ray_dirs(xs, ys, cam, cfg)
    return scene, cam, dirs


def test_tri_constants_match_jax(frame):
    scene, cam, _ = frame
    want = jax_intersect.tri_constants(scene, cam.pos)
    got = intersect.tri_constants(
        convert.scene_from_numpy(leaves(scene), device="cpu"), _t(cam.pos))
    scale = np.abs(np.asarray(want.m)).max()
    np.testing.assert_allclose(got.m.numpy(), np.asarray(want.m), rtol=0,
                               atol=4 * np.finfo(np.float32).eps * scale)
    np.testing.assert_allclose(got.k0.numpy(), np.asarray(want.k0),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


def test_intersect_matches_jax(frame):
    scene, cam, dirs = frame
    consts = jax_intersect.tri_constants(scene, cam.pos)
    want = jax_intersect.intersect(dirs, consts)
    got = intersect.intersect(
        _t(dirs), intersect.TriConstants(*map(_t, consts)))
    mismatches = int((got.idx.numpy() != np.asarray(want.idx)).sum())
    print(f"idx mismatches {mismatches} of {dirs.shape[0]} rays")
    assert mismatches == 0
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=5e-7)
    np.testing.assert_allclose(
        intersect.hit_positions(_t(cam.pos), _t(dirs), got).numpy(),
        np.asarray(jax_intersect.hit_positions(cam.pos, dirs, want)),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        intersect.hit_distances(_t(dirs), got).numpy(),
        np.asarray(jax_intersect.hit_distances(dirs, want)),
        rtol=1e-6)


def test_intersect_refuses_more_than_one_chunk(frame):
    """The streamed multi-chunk intersect, once refused, matches JAX's
    ``lax.scan`` over chunks at tri_chunk=16 (two chunks of the box):
    winners bit for bit, t to rtol 5e-7, and the single-chunk result (the
    box's 30 triangles in two chunks of 15); a triangle count that is not
    a whole number of chunks raises as in JAX."""
    scene, cam, dirs = frame
    jconsts = jax_intersect.tri_constants(scene, cam.pos)
    consts = intersect.TriConstants(*map(_t, jconsts))
    chunk = scene.num_triangles // 2
    got = intersect.intersect(_t(dirs), consts, tri_chunk=chunk)
    want = jax_intersect.intersect(dirs, jconsts, tri_chunk=chunk)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=5e-7)
    one = intersect.intersect(_t(dirs), consts)
    assert torch.equal(got.idx, one.idx) and torch.equal(got.t, one.t)
    assert bool(got.hit.any())
    with pytest.raises(ValueError, match="multiple of tri_chunk=24"):
        intersect.intersect(_t(dirs), consts, tri_chunk=24)


@pytest.mark.parametrize("mode", ["clean", "parity"])
def test_direct_light_and_composite_match_jax(frame, mode):
    scene, cam, dirs = frame
    lights = JaxLights.single(capacity=1)
    jcfg = JaxRenderConfig(mode=mode, use_pallas=False)
    hits = jax_intersect.intersect(dirs, jax_intersect.tri_constants(
        scene, cam.pos))
    pos = jax_intersect.hit_positions(cam.pos, dirs, hits)
    shade_idx = np.maximum(np.asarray(hits.idx), 0)
    want = jax_shade.direct_light(pos, shade_idx, scene, lights, jcfg)
    want_color = jax_shade.composite(want, scene.color[shade_idx], hits.hit,
                                     jcfg)

    cfg = RenderConfig(mode=mode)
    t_scene = convert.scene_from_numpy(leaves(scene), device="cpu")
    got = shade.direct_light(
        _t(pos), _t(shade_idx).long(), t_scene,
        convert.lights_from_numpy(leaves(lights), device="cpu"), cfg)
    got_color = shade.composite(got, t_scene.color[_t(shade_idx).long()],
                                _t(hits.hit), cfg)
    # The inverse-square factor (up to ~14 / (4 pi r^2)) scales an ulp of
    # the Lambert dot into ~1e-6 near the light.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_color.numpy(), np.asarray(want_color),
                               rtol=0, atol=1e-6)


def test_direct_light_refuses_several_lights(frame):
    """Several lights and soft-shadow samples, once refused, now shade as
    the JAX package's direct_light does: 2 lights x 4 samples, both modes,
    each source's shadow rays traced by the op itself."""
    scene, cam, dirs = frame
    jax_lights = JaxLights.single(capacity=2, soft_samples=4).add(
        (0.4, -0.5, -0.7), (1.0, 0.8, 0.6), 7.0, key=jax.random.PRNGKey(1))
    hits = jax_intersect.intersect(dirs, jax_intersect.tri_constants(
        scene, cam.pos))
    pos = jax_intersect.hit_positions(cam.pos, dirs, hits)
    shade_idx = np.maximum(np.asarray(hits.idx), 0)
    t_scene = convert.scene_from_numpy(leaves(scene), device="cpu")
    lights = convert.lights_from_numpy(leaves(jax_lights), device="cpu")
    for mode in ("clean", "parity"):
        jcfg = JaxRenderConfig(mode=mode, soft_shadow_samples=4,
                               use_pallas=False)
        want = jax_shade.direct_light(pos, shade_idx, scene, jax_lights, jcfg)
        got = shade.direct_light(
            _t(pos), _t(shade_idx).long(), t_scene, lights,
            RenderConfig(mode=mode, soft_shadow_samples=4))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=mode)
    with pytest.raises(ValueError, match="jittered"):
        shade.direct_light(_t(pos), _t(shade_idx).long(), t_scene, lights,
                           RenderConfig(soft_shadow_samples=16))


def test_intersect_grad_reaches_the_last_tied_triangle():
    """F6: the gradient of t goes to the last-wins winner, as JAX's
    take_along_axis sends it. The centre rays tie on the back wall's
    diagonal, which triangles 8 and 9 share."""
    scene = jax_cornell_box(pad_to=32)
    cam = JaxCamera.raytracer_default()
    cfg = JaxRenderConfig(width=16, height=16)
    dirs = camera_ray_dirs(*pixel_grid(cfg), cam, cfg)

    def t_sum(v0, v1, v2, d):
        s = dataclasses.replace(scene, v0=v0, v1=v1, v2=v2)
        hits = jax_intersect.intersect(d, jax_intersect.tri_constants(
            s, cam.pos))
        return jnp.sum(jnp.where(hits.hit, hits.t, 0.0))

    want = jax.grad(t_sum, argnums=(0, 1, 2, 3))(scene.v0, scene.v1,
                                                 scene.v2, dirs)
    t_scene = convert.scene_from_numpy(leaves(scene), device="cpu")
    inputs = [t_scene.v0, t_scene.v1, t_scene.v2, _t(dirs)]
    for x in inputs:
        x.requires_grad_(True)
    t_scene = dataclasses.replace(t_scene, v0=inputs[0], v1=inputs[1],
                                  v2=inputs[2])
    hits = intersect.intersect(inputs[3], intersect.tri_constants(
        t_scene, _t(cam.pos)))
    got = torch.autograd.grad(torch.where(hits.hit, hits.t, 0.0).sum(),
                              inputs)
    assert int(hits.idx.eq(8).sum()) and int(hits.idx.eq(9).sum())
    for name, g, w in zip(("v0", "v1", "v2", "dirs"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    assert np.abs(np.asarray(want[0])[8:10]).max() > 1e-3
