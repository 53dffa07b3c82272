"""The port's plain backward (``fused_bwd_reference``) against the VJP of
the JAX package's ``render_hard_fused``.

Both sides take the same numbers: ray directions from a camera drawn with
numpy, the JAX package's triangle constants carried across as numpy, and
cotangents drawn with numpy. The JAX side runs its two backward Pallas
kernels in interpret mode. Every gradient is held to ROADMAP's rule,
rtol 1e-4 / atol 1e-5: XLA:CPU contracts products into FMAs (ROADMAP F4),
so the two agree to ulps, not bits.

The CUDA kernels themselves are checked against this plain version on the
card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.kernels.render_fused import render_hard_fused as jax_render
from raytpu.ops.intersect import tri_constants as jax_tri_constants
from raytpu.render.raytrace import camera_ray_dirs, pixel_grid

from raytpu_torch.core.cornell import cornell_box
from raytpu_torch.core.types import Camera, Lights, RenderConfig
from raytpu_torch.kernels import render_fused
from raytpu_torch.kernels.tables import GATHERED, pack_params, pack_tables
from raytpu_torch.kernels.tables import unpack
from raytpu_torch.render.raytrace import raytrace

SIZE = 32


def _camera(seed):
    rng = np.random.default_rng(seed)
    pos = np.array([0.0, 0.0, -2.0]) + rng.uniform(-0.3, 0.3, 3)
    return JaxCamera.make(pos.astype(np.float32),
                          yaw=float(rng.uniform(-0.4, 0.4)))


def _jax_args(cam_seed):
    scene = jax_cornell_box(pad_to=32)
    cam = _camera(cam_seed)
    lights = JaxLights.single(capacity=1)
    cfg = JaxRenderConfig(width=SIZE, height=SIZE)
    xs, ys = pixel_grid(cfg)
    c = jax_tri_constants(scene, cam.pos)
    cl = jax_tri_constants(scene, lights.position[0])
    p_eff = lights.mask[0] * (lights.color[0] * lights.intensity[0])
    return [np.asarray(a) for a in (
        camera_ray_dirs(xs, ys, cam, cfg), c.m, c.k0, c.valid, cl.m, cl.k0,
        scene.normals(), scene.color, cam.pos, lights.position[0], p_eff,
        cam.dof_focus)]


@functools.partial(jax.jit, static_argnums=2)
def _jax_vjp(args, cots, parity):
    def f(*a):
        return jax_render(*a, 2048, 512, 0.2, parity)

    return jax.vjp(f, *args)[1](cots)


@pytest.mark.parametrize("mode", ["clean", "parity"])
@pytest.mark.parametrize("cam_seed", [3, 17])
def test_plain_bwd_matches_jax_vjp(mode, cam_seed):
    parity = mode == "parity"
    args = _jax_args(cam_seed)
    R, T = args[0].shape[0], args[1].shape[0]
    rng = np.random.default_rng(100 + cam_seed)
    g_color = rng.standard_normal((R, 3), dtype=np.float32)
    g_fd = rng.standard_normal(R, dtype=np.float32)
    (jg_dirs, jg_m, jg_k0, jg_valid, jg_ml, jg_k0l, jg_nrm, jg_alb, jg_cam,
     jg_light, jg_peff, jg_dof) = map(
         np.asarray, _jax_vjp(tuple(args), (g_color, g_fd), parity))

    t = [torch.tensor(a) for a in args]
    table = pack_tables(*t[1:8], 32)
    params = pack_params(*t[8:12])
    fwd = render_fused.fused_fwd_reference(t[0], table, params, ambient=0.2,
                                           parity=parity)
    assert float((fwd.idx >= 0).float().mean()) > 0.5
    g_dirs, g_table, g_params = render_fused.fused_bwd_reference(
        t[0], table, params, fwd.idx, fwd.occ, torch.tensor(g_color),
        torch.tensor(g_fd), ambient=0.2, parity=parity)
    rows = {k: v.numpy() for k, v in unpack(g_table).items()}

    def close(got, want, what):
        print(f"{what}: max |diff| {np.abs(got - want).max():.3g}, "
              f"max |grad| {np.abs(want).max():.3g}")
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=what)

    close(g_dirs.numpy(), jg_dirs, "dirs")
    close(rows["n"][:, :T].T, jg_m[:, 0], "n")
    close(rows["k0"][:T], jg_k0, "k0")
    close(rows["normal"][:, :T].T, jg_nrm, "normal")
    close(rows["albedo"][:, :T].T, jg_alb, "albedo")
    close(g_params.numpy(),
          np.concatenate([jg_cam, jg_light, jg_peff, jg_dof[None]]),
          "params")
    # Neither side differentiates c2, c3, the mask or the shadow constants.
    assert not jg_m[:, 1:].any() and not jg_valid.any()
    assert not jg_ml.any() and not jg_k0l.any()
    outside = np.ones(g_table.shape[0], dtype=bool)
    outside[list(GATHERED)] = False
    assert not g_table.numpy()[outside].any()
    assert np.abs(jg_alb).max() > 1.0  # the cotangents reach the albedo


def test_cpu_backward_launches_nothing():
    scene = cornell_box(pad_to=32, device="cpu")
    lights = Lights.single(capacity=1, device="cpu")
    for value in (scene, lights):
        for t in vars(value).values():
            t.requires_grad_(True)
    counts = (render_fused.LAUNCHES, render_fused.LAUNCHES_BWD,
              render_fused.LAUNCHES_SCATTER)
    img = raytrace(scene, Camera.raytracer_default(device="cpu"), lights,
                   RenderConfig(width=16, height=16, mode="clean"))
    img.mean().backward()  # an expanded (stride 0) cotangent, no fd one
    assert (render_fused.LAUNCHES, render_fused.LAUNCHES_BWD,
            render_fused.LAUNCHES_SCATTER) == counts
    assert float(scene.color.grad.abs().max()) > 0.0
    assert scene.active.grad is None and lights.jitter.grad is None
