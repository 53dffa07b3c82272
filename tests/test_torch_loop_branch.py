"""The loop branch of ``raytrace_full`` (AA, soft shadows, several lights,
``megakernel=False``) against the JAX package's.

The JAX side takes its XLA route (``use_pallas=False``: the plain
intersect and direct_light's own shadow traces) in every case, and its
Pallas route (K6 in interpret mode) in one; the port takes its own route,
the intersection kernels' plain versions on the CPU. Both sides get the
same numbers, the JAX light bank's jittered positions included. Image and
focal distances agree to atol 1e-6 (ROADMAP fault F5 allows it at these
sizes). A pixel whose AA record took another sub-ray's hit
(``dist <= rec_dist`` decided by an ulp) would differ by far more: such
pixels are counted and must be none.
"""

import numpy as np
import pytest
import torch

import jax

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.render.raytrace import raytrace_full as jax_raytrace_full

from raytpu_torch import convert
from raytpu_torch.core.types import RenderConfig
from raytpu_torch.kernels import intersect as kernels
from raytpu_torch.kernels import render_fused
from raytpu_torch.render.raytrace import raytrace_full

SIZE = 16


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


def _lights(n_lights, soft_samples=4):
    lights = JaxLights.single(capacity=n_lights, soft_samples=soft_samples)
    if n_lights == 2:
        lights = lights.add((0.4, -0.5, -0.7), (1.0, 0.8, 0.6), 7.0,
                            key=jax.random.PRNGKey(1))
    return lights


# (name, lights, config, JAX route through Pallas)
CASES = {
    "parity-aa3-1light": (1, dict(mode="parity", aa_samples=3), False),
    "parity-aa3-2lights": (2, dict(mode="parity", aa_samples=3), False),
    "clean-aa3-soft4-2lights-dof": (
        2, dict(mode="clean", aa_samples=3, soft_shadow_samples=4,
                dof_enabled=True), False),
    "parity-megakernel-off": (1, dict(mode="parity", megakernel=False),
                              False),
    "clean-aa3-soft4-2lights-dof-pallas": (
        2, dict(mode="clean", aa_samples=3, soft_shadow_samples=4,
                dof_enabled=True), True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_loop_branch_matches_jax(name):
    n_lights, kw, use_pallas = CASES[name]
    scene = jax_cornell_box(pad_to=32)
    # A wide view (focal SIZE / 2): walls, blocks and shadows in frame.
    camera = JaxCamera.make((0.0, 0.0, -2.0), focal=SIZE / 2)
    lights = _lights(n_lights)
    want = jax_raytrace_full(
        scene, camera, lights,
        JaxRenderConfig(width=SIZE, height=SIZE, use_pallas=use_pallas, **kw))
    counts = (render_fused.LAUNCHES, kernels.LAUNCHES_OCCLUDED,
              kernels.LAUNCHES_OCCLUDED_MULTI)
    got = raytrace_full(
        convert.scene_from_numpy(leaves(scene), device="cpu"),
        convert.camera_from_numpy(leaves(camera), device="cpu"),
        convert.lights_from_numpy(leaves(lights), device="cpu"),
        RenderConfig(width=SIZE, height=SIZE, **kw))
    # CPU tensors: every wrapper took its plain version.
    assert counts == (render_fused.LAUNCHES, kernels.LAUNCHES_OCCLUDED,
                      kernels.LAUNCHES_OCCLUDED_MULTI)
    img, fd = got.image.numpy(), got.focal_distances.numpy()
    want_img = np.asarray(want.image)
    want_fd = np.asarray(want.focal_distances)
    flips = int((np.abs(fd - want_fd) > 1e-4).sum())
    print(f"{name}: max |d image| {np.abs(img - want_img).max():.3g}, "
          f"max |d fd| {np.abs(fd - want_fd).max():.3g}, record flips "
          f"{flips}")
    assert flips == 0
    np.testing.assert_allclose(img, want_img, rtol=0, atol=1e-6)
    np.testing.assert_allclose(fd, want_fd, rtol=0, atol=1e-6)
    assert img.max() > 0.3 and np.isfinite(img).all()
