"""The port's soft rasterizer (raytpu_torch.render.soft.rasterize_soft)
against the JAX package's ``rasterize_soft``, on the CPU.

JAX's jnp path (chunks of raster_tri_chunk) and its Pallas kernel agree to
fp reassociation; the port has the kernel's math (K9a-K9d's plain versions
here, the CUDA kernels on a card). The rules are the JAX tests' own
(tests/test_soft_raster_pallas.py): the image within atol 5e-5 / rtol 1e-4,
each gradient leaf within atol 2e-4 after scaling by its largest entry.
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
from raytpu.render.soft import rasterize_soft as jax_rasterize_soft

from raytpu_torch import convert
from raytpu_torch.core.cornell import cornell_box
from raytpu_torch.core.types import Camera, Lights, RenderConfig
from raytpu_torch.kernels import soft_raster as kernels
from raytpu_torch.render.rasterize import rasterize
from raytpu_torch.render.soft import (
    rasterize_exact,
    rasterize_soft,
    shade_agg_raster,
)

CFG = dict(width=48, height=40, mode="soft", soft_edge_sharpness=60.0,
           soft_z_sharpness=60.0)


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


@pytest.fixture(scope="module")
def jax_setup():
    return (jax_cornell_box(pad_to=32), JaxCamera.rasterizer_default(),
            JaxLights.single(capacity=2))


def _port(scene, camera, lights):
    return (convert.scene_from_numpy(leaves(scene), device="cpu"),
            convert.camera_from_numpy(leaves(camera), device="cpu"),
            convert.lights_from_numpy(leaves(lights), device="cpu"))


def test_forward_matches_jax(jax_setup):
    want = np.asarray(jax_rasterize_soft(*jax_setup, JaxRenderConfig(**CFG)))
    got = rasterize_soft(*_port(*jax_setup), RenderConfig(**CFG))
    assert got.shape == (40, 48, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)
    assert want.max() > 0.3


def test_gradients_match_jax(jax_setup):
    """Every leaf of scene (active too: log(valid) differentiates to
    1 / (valid + 1e-20), weighted by exp(-46) on padding rows), camera and
    lights against jax.grad of sum(sin(3 img))."""
    def loss(s, c, li):
        return jnp.sum(jnp.sin(3.0 * jax_rasterize_soft(
            s, c, li, JaxRenderConfig(**CFG))))

    want = jax.grad(loss, argnums=(0, 1, 2))(*jax_setup)
    port = _port(*jax_setup)
    for value in port:
        for t in vars(value).values():
            t.requires_grad_(True)
    torch.sin(3.0 * rasterize_soft(*port, RenderConfig(**CFG))).sum() \
        .backward()
    for got, w in zip(port, want):
        got = convert.grads_to_numpy(got)
        for name, a in leaves(w).items():
            assert np.isfinite(got[name]).all(), name
            scale = max(np.abs(a).max(), 1e-8)
            print(f"{name}: max |grad| {np.abs(a).max():.3g}, scaled error "
                  f"{np.abs(got[name] - a).max() / scale:.3g}")
            np.testing.assert_allclose(got[name] / scale, a / scale,
                                       atol=2e-4, err_msg=name)
    assert np.abs(np.asarray(want[0].active)).max() > 1.0
    assert np.abs(np.asarray(want[1].yaw)) > 0.0


def test_hard_limit_matches_rasterize_exact():
    """At high sharpness the soft frame converges to the hard rasterizer
    away from edges (the JAX kernel's test)."""
    scene = cornell_box(pad_to=32, device="cpu")
    camera = Camera.rasterizer_default(device="cpu")
    lights = Lights.single(capacity=2, device="cpu")
    sharp = RenderConfig(**{**CFG, "soft_edge_sharpness": 8000.0,
                            "soft_z_sharpness": 8000.0})
    soft = rasterize_soft(scene, camera, lights, sharp)
    hard = rasterize_exact(scene, camera, lights, sharp.replace(mode="clean"))
    d = (soft - hard).abs().max(dim=-1).values
    assert float(d.median()) < 1e-3
    assert float(d.mean()) < 0.02


def test_zero_triangles_match_jax():
    from raytpu.core.types import Scene as JaxScene
    empty = jnp.zeros((0, 3), jnp.float32)
    jax_scene = JaxScene(v0=empty, v1=empty, v2=empty, color=empty,
                         active=jnp.zeros((0,), jnp.float32))
    setup = (jax_scene, JaxCamera.rasterizer_default(),
             JaxLights.single(capacity=2))
    want = np.asarray(jax_rasterize_soft(*setup, JaxRenderConfig(**CFG)))
    got = rasterize_soft(*_port(*setup), RenderConfig(**CFG))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5, rtol=1e-4)


def test_rasterize_dispatches_soft_without_dof(jax_setup):
    """Mode 'soft' of rasterize is rasterize_soft on the compacted bank,
    DoF ignored, as in raytpu/render/rasterize.py:70-75."""
    scene, camera, _ = _port(*jax_setup)
    lights = Lights.single(capacity=4, device="cpu")
    cfg = RenderConfig(**CFG)
    want = rasterize_soft(scene, camera, lights.compact(), cfg)
    assert torch.equal(rasterize(scene, camera, lights, cfg), want)
    assert torch.equal(rasterize(scene, camera, lights,
                                 cfg.replace(dof_enabled=True)), want)


def test_shade_gate_bounds_background_cotangents():
    """shade_agg_raster gates the division at zpx > 1e-6 (not a 1e-12
    guard): a background pixel's cotangents stay bounded."""
    lights = Lights.single(capacity=1, device="cpu")
    camera = Camera.rasterizer_default(device="cpu")
    zpx = torch.tensor([1e-9, 0.25], requires_grad=True)
    ppx = torch.tensor([[1e-9, 2e-9, 1e-9], [0.1, 0.2, 0.25]],
                       requires_grad=True)
    alb = torch.full((2, 3), 0.5)
    nrm = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]])
    shade_agg_raster(alb, ppx, zpx, nrm, camera, lights, 0.2).sum().backward()
    assert float(zpx.grad[0]) == 0.0
    assert float(ppx.grad[0].abs().max()) < 10.0
    assert float(zpx.grad[1].abs()) > 0.0


def test_soft_frame_takes_no_kernel_on_cpu(jax_setup):
    counts = (kernels.LAUNCHES_SOFT_FWD, kernels.LAUNCHES_SOFT_FWD_MASKED,
              kernels.LAUNCHES_SOFT_BWD, kernels.LAUNCHES_SOFT_BWD_MASKED)
    scene, camera, lights = _port(*jax_setup)
    scene.v0.requires_grad_(True)
    rasterize_soft(scene, camera, lights, RenderConfig(**CFG)).sum() \
        .backward()
    assert (kernels.LAUNCHES_SOFT_FWD, kernels.LAUNCHES_SOFT_FWD_MASKED,
            kernels.LAUNCHES_SOFT_BWD,
            kernels.LAUNCHES_SOFT_BWD_MASKED) == counts
