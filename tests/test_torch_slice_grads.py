"""Gradients of the port's slice against ``jax.grad`` of the JAX package.

The loss is ``mean(image^2) + 0.1 * mean(fd^2)`` of ``raytrace_full`` at
16^2 on the Cornell box padded to 32, the default camera and one light,
the test of tests/test_render_fused.py::test_grads_match_xla. The JAX side
takes the megakernel route (``render_hard_fused`` with Pallas in interpret
mode); the port calls ``.backward()`` on the same numbers. Every leaf of
scene, camera and lights agrees to ROADMAP's gradient rule, rtol 1e-4 /
atol 1e-5. Both sides differentiate the shading from the saved winner
index, so the centre rays that tie on the back wall's diagonal (triangles
8 and 9) send their gradient to the same triangle. ``Scene.active`` and
``Lights.jitter`` take no part in the gradient: JAX gives exact zeros, and
so does the port.
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


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


def _jax_grads(scene, camera, lights, cfg):
    def loss(s, c, l):
        out = jax_raytrace_full(s, c, l, cfg)
        return (jnp.mean(out.image ** 2)
                + 0.1 * jnp.mean(out.focal_distances ** 2))

    return [leaves(g) for g in
            jax.grad(loss, argnums=(0, 1, 2))(scene, camera, lights)]


def _port_grads(scene, camera, lights, cfg):
    values = [
        convert.scene_from_numpy(leaves(scene), device="cpu"),
        convert.camera_from_numpy(leaves(camera), device="cpu"),
        convert.lights_from_numpy(leaves(lights), device="cpu"),
    ]
    for value in values:
        for t in vars(value).values():
            t.requires_grad_(True)
    out = raytrace_full(*values, cfg)
    loss = (torch.mean(out.image ** 2)
            + 0.1 * torch.mean(out.focal_distances ** 2))
    loss.backward()
    return [convert.grads_to_numpy(v) for v in values]


@pytest.mark.parametrize("mode", ["clean", "parity"])
@pytest.mark.parametrize("dof", [False, True], ids=["nodof", "dof"])
def test_slice_grads_match_jax(mode, dof):
    scene = jax_cornell_box(pad_to=32)
    camera = JaxCamera.raytracer_default()
    lights = JaxLights.single(capacity=1)
    jcfg = JaxRenderConfig(width=16, height=16, mode=mode, dof_enabled=dof,
                           use_pallas=True, megakernel=True)
    want = _jax_grads(scene, camera, lights, jcfg)
    got = _port_grads(scene, camera, lights,
                      RenderConfig(width=16, height=16, mode=mode,
                                   dof_enabled=dof))
    for name, g, w in zip(("scene", "camera", "lights"), got, want):
        assert g.keys() == w.keys()
        for field in w:
            diff = np.abs(g[field] - w[field])
            beyond = diff > 1e-5 + 1e-4 * np.abs(w[field])
            rows = (np.unique(np.nonzero(beyond)[0]).tolist() if diff.ndim
                    else [])
            print(f"{name}.{field}: max |diff| {diff.max():.3g}, "
                  f"max |grad| {np.abs(w[field]).max():.3g}, rows beyond "
                  f"tolerance {rows}")
            np.testing.assert_allclose(g[field], w[field], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name}.{field}")
    # The back wall's two halves, where the centre rays tie.
    assert np.abs(want[0]["v0"][8:10]).max() > 1e-3
    for name, field in ((0, "active"), (2, "jitter")):
        assert not want[name][field].any()
        assert not got[name][field].any()
