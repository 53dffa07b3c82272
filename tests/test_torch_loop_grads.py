"""Gradients of the loop branch of ``raytrace_full`` against ``jax.grad``.

The loss is ``mean(image^2) + 0.1 * mean(fd^2)`` (as in
tests/test_torch_slice_grads.py) at 16^2 on the Cornell box padded to 32,
with a wide view. The JAX side takes its XLA route, which differentiates
``intersect``'s last-wins winner (take_along_axis); the port differentiates
the intersection kernels' analytic VJP (kernels/intersect.py), as the JAX
package's Pallas route does. Every leaf of scene, camera and lights agrees
to ROADMAP's gradient rule, rtol 1e-4 / atol 1e-5, the jittered soft-shadow
positions included; ``Scene.active`` takes no part, in either.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.render.raytrace import raytrace_full as jax_raytrace_full

from raytpu_torch import convert
from raytpu_torch.core.types import RenderConfig
from raytpu_torch.render.raytrace import raytrace_full

SIZE = 16


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


CASES = {
    # The bench's full-feature configuration, cut to 4 samples a light.
    "clean-aa3-soft4-2lights-dof": (
        2, dict(mode="clean", aa_samples=3, soft_shadow_samples=4,
                dof_enabled=True)),
    "parity-aa3-1light": (1, dict(mode="parity", aa_samples=3)),
    "parity-aa3-2lights": (2, dict(mode="parity", aa_samples=3)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_loop_grads_match_jax(name):
    n_lights, kw = CASES[name]
    scene = jax_cornell_box(pad_to=32)
    camera = JaxCamera.make((0.0, 0.0, -2.0), focal=SIZE / 2)
    lights = JaxLights.single(capacity=n_lights, soft_samples=4)
    if n_lights == 2:
        lights = lights.add((0.4, -0.5, -0.7), (1.0, 0.8, 0.6), 7.0,
                            key=jax.random.PRNGKey(1))
    jcfg = JaxRenderConfig(width=SIZE, height=SIZE, use_pallas=False, **kw)

    def loss(s, c, l):
        out = jax_raytrace_full(s, c, l, jcfg)
        return (jnp.mean(out.image ** 2)
                + 0.1 * jnp.mean(out.focal_distances ** 2))

    want = [leaves(g) for g in
            jax.grad(loss, argnums=(0, 1, 2))(scene, camera, lights)]

    values = [convert.scene_from_numpy(leaves(scene), device="cpu"),
              convert.camera_from_numpy(leaves(camera), device="cpu"),
              convert.lights_from_numpy(leaves(lights), device="cpu")]
    for value in values:
        for t in vars(value).values():
            t.requires_grad_(True)
    out = raytrace_full(*values, RenderConfig(width=SIZE, height=SIZE, **kw))
    (torch.mean(out.image ** 2)
     + 0.1 * torch.mean(out.focal_distances ** 2)).backward()
    got = [convert.grads_to_numpy(v) for v in values]

    for part, g, w in zip(("scene", "camera", "lights"), got, want):
        assert g.keys() == w.keys()
        for field in w:
            diff = np.abs(g[field] - w[field])
            print(f"{part}.{field}: max |diff| {diff.max():.3g}, max |grad| "
                  f"{np.abs(w[field]).max():.3g}")
            np.testing.assert_allclose(g[field], w[field], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{part}.{field}")
    assert not got[0]["active"].any() and not want[0]["active"].any()
    soft = kw.get("soft_shadow_samples", 1) > 1
    # Soft shadows shade from the jittered positions, hard ones from the
    # lights' positions: the gradient reaches whichever the frame used.
    used, unused = ("jitter", "position") if soft else ("position", "jitter")
    assert np.abs(want[2][used]).max() > 1e-3
    assert not want[2][unused].any() and not got[2][unused].any()
