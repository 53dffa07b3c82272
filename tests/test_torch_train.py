"""The train step of the JAX package's bench (``bench.py:204-221``) in the
port: the mean squared error of ``raytrace`` to a fixed target, and one
SGD step over every float leaf of the scene and the lights.

On the CPU the backward runs the plain version of the kernels. The step
is held against ``jax.grad`` of the same loss through the JAX package's
megakernel route (Pallas in interpret mode), at ROADMAP's gradient rule,
rtol 1e-4 / atol 1e-5; a fit of the albedo alone must converge.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.render.raytrace import raytrace as jax_raytrace

from raytpu_torch import convert
from raytpu_torch.core.cornell import cornell_box
from raytpu_torch.core.types import Camera, Lights, RenderConfig
from raytpu_torch.render.raytrace import raytrace

SIZE = 32


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


def test_train_step_matches_jax():
    lr = 1e-2
    scene = jax_cornell_box(pad_to=32)
    camera = JaxCamera.raytracer_default()
    lights = JaxLights.single(capacity=1)
    noise = np.random.default_rng(5).uniform(
        -0.1, 0.1, np.shape(scene.color)).astype(np.float32)
    jcfg = JaxRenderConfig(width=SIZE, height=SIZE, mode="clean",
                           use_pallas=True, megakernel=True)
    target = jax_raytrace(
        dataclasses.replace(scene, color=scene.color + noise), camera,
        lights, jcfg)

    def loss(s, l):
        return jnp.mean((jax_raytrace(s, camera, l, jcfg) - target) ** 2)

    grads = [leaves(g) for g in jax.grad(loss, argnums=(0, 1))(scene,
                                                                lights)]
    start = [leaves(scene), leaves(lights)]

    port = [convert.scene_from_numpy(start[0], device="cpu"),
            convert.lights_from_numpy(start[1], device="cpu")]
    cam = convert.camera_from_numpy(leaves(camera), device="cpu")
    cfg = RenderConfig(width=SIZE, height=SIZE, mode="clean")
    with torch.no_grad():
        port_target = raytrace(
            dataclasses.replace(port[0], color=port[0].color
                                + torch.tensor(noise)), cam, port[1], cfg)
    params = [t.requires_grad_(True) for value in port
              for t in vars(value).values()]
    opt = torch.optim.SGD(params, lr=lr)
    opt.zero_grad()
    torch.mean((raytrace(*port[:1], cam, port[1], cfg)
                - port_target) ** 2).backward()
    port_grads = [convert.grads_to_numpy(v) for v in port]
    opt.step()

    for value, g_port, g_jax, p0 in zip(port, port_grads, grads, start):
        after = convert.to_numpy(value)
        for field in p0:
            np.testing.assert_allclose(g_port[field], g_jax[field],
                                       rtol=1e-4, atol=1e-5, err_msg=field)
            np.testing.assert_allclose(after[field],
                                       p0[field] - lr * g_jax[field],
                                       rtol=1e-4, atol=1e-5, err_msg=field)
    assert np.abs(grads[0]["color"]).max() > 1e-3
    assert not np.array_equal(convert.to_numpy(port[0])["color"],
                              start[0]["color"])


def test_fit_albedo_converges():
    """SGD on the albedo alone from albedo + 0.1 toward the true render, at
    lr 1.0: the loss falls at every step and ends below 10% of its start.
    (lr 3.0 diverges at this size; the loss is separable per triangle and
    quadratic in its albedo, so a stable rate falls monotonically.)"""
    scene = cornell_box(pad_to=32, device="cpu")
    camera = Camera.raytracer_default(device="cpu")
    lights = Lights.single(capacity=1, device="cpu")
    cfg = RenderConfig(width=SIZE, height=SIZE, mode="clean")
    target = raytrace(scene, camera, lights, cfg)
    color = (scene.color + 0.1).requires_grad_(True)
    fit = dataclasses.replace(scene, color=color)
    opt = torch.optim.SGD([color], lr=1.0)
    losses = []
    for _ in range(50):
        opt.zero_grad()
        loss = torch.mean((raytrace(fit, camera, lights, cfg) - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    print(f"loss {losses[0]:.4g} -> {losses[-1]:.4g}")
    assert all(b < a for a, b in zip(losses, losses[1:]))
    assert losses[-1] < 0.1 * losses[0]
