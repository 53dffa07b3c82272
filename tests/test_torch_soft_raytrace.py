"""The port's soft raytracer (raytpu_torch.render.soft.raytrace_soft)
against the JAX package's ``raytrace_soft``, on the CPU.

The port has the kernels' math (K10a-K10i's plain versions here, the CUDA
kernels on a card), so it is held to JAX's Pallas route
(``use_pallas=True``, interpret mode) at the kernels' rule, the image within
atol 3e-5 / rtol 1e-5 (ulps of the shadow's 1 / sqrt against rsqrt and of
the sums' order, through the shading), and to JAX's jnp streaming path,
which reassociates that math (another chunk, ``k0 / safe`` against
``k0 * rec``, ``sqrt`` against ``rsqrt``), at JAX's own rule, atol 5e-5 /
rtol 1e-4 (tests/test_soft_raytrace_pallas.py). Gradients of every leaf
within atol 2e-4 after scaling by the leaf's largest entry.
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
from raytpu.render.soft import raytrace_soft as jax_raytrace_soft

from raytpu_torch import convert
from raytpu_torch.core.cornell import cornell_box
from raytpu_torch.core.types import Camera, Lights, RenderConfig
from raytpu_torch.kernels import soft_raytrace as kernels
from raytpu_torch.kernels.soft_raster import use_cull
from raytpu_torch.render.raytrace import raytrace
from raytpu_torch.render.soft import raytrace_soft, raytrace_soft_inputs

CFG = dict(width=48, height=40, mode="soft", soft_edge_sharpness=60.0,
           soft_z_sharpness=60.0)


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


def _port(scene, camera, lights):
    return (convert.scene_from_numpy(leaves(scene), device="cpu"),
            convert.camera_from_numpy(leaves(camera), device="cpu"),
            convert.lights_from_numpy(leaves(lights), device="cpu"))


def _lights(n: int):
    lights = JaxLights.single(capacity=n, soft_samples=4)
    if n > 1:
        lights = lights.add((0.4, -0.5, -0.6), (1.0, 0.8, 0.6), 7.0,
                            key=jax.random.PRNGKey(1))
    return lights


CASES = {
    "one-light": (1, {}),
    "two-lights": (2, {}),
    "soft-shadows-4": (2, {"soft_shadow_samples": 4}),
}


@pytest.fixture(scope="module")
def setups():
    scene = jax_cornell_box(pad_to=32)
    camera = JaxCamera.raytracer_default()
    return {name: (scene, camera, _lights(n), extra)
            for name, (n, extra) in CASES.items()}


@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_jax_kernels_and_jnp(setups, name):
    scene, camera, lights, extra = setups[name]
    cfg = dict(CFG, **extra)
    got = raytrace_soft(*_port(scene, camera, lights), RenderConfig(**cfg))
    assert got.shape == (40, 48, 3) and got.dtype == torch.float32
    pallas = np.asarray(jax_raytrace_soft(
        scene, camera, lights, JaxRenderConfig(**cfg, use_pallas=True)))
    jnp_path = np.asarray(jax_raytrace_soft(
        scene, camera, lights, JaxRenderConfig(**cfg, use_pallas=False)))
    print(f"{name}: max |port - pallas| "
          f"{np.abs(got.numpy() - pallas).max():.3g}, |port - jnp| "
          f"{np.abs(got.numpy() - jnp_path).max():.3g}")
    np.testing.assert_allclose(got.numpy(), pallas, atol=3e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), jnp_path, atol=5e-5, rtol=1e-4)
    assert pallas.max() > 0.2


def test_gradients_match_jax(setups):
    """Every leaf of scene (active too, through log(active + 1e-20)),
    camera and lights (the jittered positions through the shadow sources)
    against jax.grad of sum(sin(3 img)) through JAX's kernels."""
    scene, camera, lights, extra = setups["soft-shadows-4"]
    cfg = dict(CFG, **extra)

    def loss(s, c, li):
        return jnp.sum(jnp.sin(3.0 * jax_raytrace_soft(
            s, c, li, JaxRenderConfig(**cfg, use_pallas=True))))

    want = jax.grad(loss, argnums=(0, 1, 2))(scene, camera, lights)
    port = _port(scene, camera, lights)
    for value in port:
        for t in vars(value).values():
            t.requires_grad_(True)
    torch.sin(3.0 * raytrace_soft(*port, RenderConfig(**cfg))).sum() \
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
    assert np.abs(np.asarray(want[1].pos)).max() > 0.0
    assert np.abs(np.asarray(want[2].jitter)).max() > 0.0


def test_cull_decision_is_jax_and_the_masked_route_raises():
    """JAX culls where there is more than one chunk and the image blocks
    into its 1,024-pixel tiles (not at the CLI's 500^2); there the frame
    runs the masked kernels (their plain versions here), auto or with cull
    True, and matches the brute frame at JAX's culled rule
    (tests/test_soft_raytrace_cull.py: atol 1e-6 / rtol 1e-6). cull True
    at a size that does not block still raises ValueError. cull=False runs
    the unmasked kernels at any size and gives the one-chunk frame's
    image."""
    scene = cornell_box(pad_to=32, device="cpu")
    camera = Camera.raytracer_default(device="cpu")
    lights = Lights.single(capacity=1, device="cpu")
    cfg = RenderConfig(width=64, height=64, mode="soft")
    brute = raytrace_soft(scene, camera, lights, cfg, cull=False, chunk=8)
    auto = raytrace_soft(scene, camera, lights, cfg, chunk=8)
    culled = raytrace_soft(scene, camera, lights, cfg, cull=True, chunk=8)
    assert kernels.LAUNCHES_SRT_PRI_FWD_MASKED == 0  # plain versions here
    for img in (auto, culled):
        np.testing.assert_allclose(img.numpy(), brute.numpy(), atol=1e-6,
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="tile"):
        raytrace_soft(scene, camera, lights,
                      cfg.replace(width=48, height=40), cull=True)
    one = raytrace_soft(scene, camera, lights, cfg)
    np.testing.assert_allclose(brute.numpy(), one.numpy(), atol=1e-6,
                               rtol=1e-5)
    # 283 chunks of the F1 mesh at 500^2: no cull; 512^2: cull.
    assert use_cull(None, 283, 500, 500) is False
    assert use_cull(None, 288, 512, 512) is True
    assert use_cull(None, 1, 512, 512) is False


def test_raytrace_dispatches_soft_on_the_compacted_bank():
    """Mode 'soft' of raytrace is raytrace_soft on lights.compact(), as
    raytpu/render/raytrace.py:280-285; an inactive slot changes nothing."""
    scene = cornell_box(device="cpu")
    camera = Camera.raytracer_default(device="cpu")
    lights = Lights.single(capacity=4, device="cpu")
    cfg = RenderConfig(width=16, height=12, mode="soft")
    want = raytrace_soft(scene, camera, lights.compact(), cfg)
    assert torch.equal(raytrace(scene, camera, lights, cfg), want)
    np.testing.assert_allclose(raytrace_soft(scene, camera, lights,
                                             cfg).numpy(), want.numpy(),
                               atol=1e-7)


def test_hard_limit_approaches_the_clean_raytracer():
    """At high sharpness the soft frame converges to 'clean', shadows
    included: tests/test_gradients.py::test_soft_raytracer_hard_limit's
    setup and rule."""
    from raytpu_torch.render.raytrace import raytrace_full
    size = 64
    scene = cornell_box(device="cpu")
    camera = Camera.make((0.011, -0.007, -2.013), focal=float(size) + 0.23,
                         dof_focus=1.3, device="cpu")
    lights = Lights.single(capacity=1, device="cpu")
    hard = raytrace_full(scene, camera, lights, RenderConfig(
        width=size, height=size, mode="clean")).image
    soft = raytrace_soft(scene, camera, lights, RenderConfig(
        width=size, height=size, mode="soft", soft_edge_sharpness=4e4,
        soft_z_sharpness=4e3))
    diff = (hard - soft).abs().max(dim=-1).values
    assert float((diff < 5e-3).float().mean()) > 0.98


def test_shadow_darkens_at_the_fits_first_stage_as_in_jax():
    """The fit's first stage (10 / 20) sits in the optical depth's sigmoid
    tails (raytpu/render/soft.py::_soft_shadow_factor's note): on the fit
    test's frame T averages < 0.1 there, > 0.3 at the last stage's 40 /
    200, and equals JAX's jnp shadow at JAX's own rule. Reproduced, not
    fixed; T stays above 0 here, so the lights keep a gradient."""
    from raytpu.render.soft import _soft_shadow_factor

    from raytpu_torch.ops.shade import source_positions

    W, H = 24, 20
    scene = jax_cornell_box()
    camera = JaxCamera.make((0.0, 0.0, -3.0), focal=float(W), y_scale=1.01)
    lights = JaxLights.single(capacity=1, intensity=8.0,
                              position=(0.2, -0.3, -0.5))
    pscene, pcamera, plights = _port(scene, camera, lights)
    means = []
    for es, zs in ((10.0, 20.0), (40.0, 200.0)):
        cfg = dict(width=W, height=H, mode="soft", soft_edge_sharpness=es,
                   soft_z_sharpness=zs)
        with torch.no_grad():
            pri, shw, dirs, chunk, es_, zs_, _, _ = raytrace_soft_inputs(
                pscene, pcamera, RenderConfig(**cfg))
            out, _, _ = kernels.primary_agg_reference(pri, pcamera.pos, dirs,
                                                      es_, zs_, chunk)
            world = out[3:6].contiguous()
            srcs = source_positions(plights, 1)
            trans = kernels.shadow_trans_reference(shw, srcs, world, es_,
                                                   zs_, chunk)[0]
        want = np.asarray(_soft_shadow_factor(
            jnp.asarray(world.T.numpy()), scene, lights,
            JaxRenderConfig(**cfg)))
        np.testing.assert_allclose(trans.numpy(), want, atol=5e-5, rtol=1e-4)
        assert bool((trans > 0).all())
        means.append(float(trans.mean()))
    assert means[0] < 0.1 < 0.3 < means[1], means


def test_soft_frame_takes_no_kernel_on_cpu():
    counts = (kernels.LAUNCHES_SRT_PRI_FWD, kernels.LAUNCHES_SRT_PRI_BWD,
              kernels.LAUNCHES_SRT_SHW_FWD, kernels.LAUNCHES_SRT_SHW_BWD)
    scene = cornell_box(device="cpu")
    scene.v0.requires_grad_(True)
    raytrace_soft(scene, Camera.raytracer_default(device="cpu"),
                  Lights.single(capacity=1, device="cpu"),
                  RenderConfig(width=8, height=8, mode="soft")).sum() \
        .backward()
    assert scene.v0.grad is not None and bool(torch.isfinite(
        scene.v0.grad).all())
    assert (kernels.LAUNCHES_SRT_PRI_FWD, kernels.LAUNCHES_SRT_PRI_BWD,
            kernels.LAUNCHES_SRT_SHW_FWD,
            kernels.LAUNCHES_SRT_SHW_BWD) == counts
