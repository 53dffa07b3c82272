"""The port's slice, ``raytrace_full`` end to end, against the JAX package.

Both JAX routes serve as references: the megakernel (Pallas in interpret
mode, ``use_pallas=True``) and the XLA path (``use_pallas=False``). The
port computes its own ray directions and constants, so a knife-edge
winner can flip where XLA:CPU's contracted FMAs or its dot move a value by
an ulp: such pixels are counted and capped at 0.1% (as ``f32_frac`` in
tests/test_raytrace_parity.py); every other pixel is held to atol 1e-6
(1e-5 with DoF, whose 64-term box sums add in another order). The numpy
oracle check uses tests/test_raytrace_parity.py's tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.cornell import cornell_box_numpy
from raytpu.core.image import quantize_u8
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.oracle import raytracer_oracle as oracle
from raytpu.render.raytrace import raytrace as jax_raytrace
from raytpu.render.raytrace import raytrace_full as jax_raytrace_full

from raytpu_torch import convert
from raytpu_torch.core.cornell import cornell_box
from raytpu_torch.core.types import Camera, Lights, RenderConfig
from raytpu_torch.kernels import render_fused
from raytpu_torch.render.raytrace import raytrace, raytrace_full

FLIP_FRAC = 0.001


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


def _render_both(mode, dof, width, height, megakernel_route):
    jax_scene = jax_cornell_box(pad_to=32)
    jax_camera = JaxCamera.raytracer_default()
    jax_lights = JaxLights.single(capacity=1)
    jcfg = JaxRenderConfig(width=width, height=height, mode=mode,
                           dof_enabled=dof, use_pallas=megakernel_route,
                           megakernel=megakernel_route)
    want = jax_raytrace_full(jax_scene, jax_camera, jax_lights, jcfg)
    cfg = RenderConfig(width=width, height=height, mode=mode, dof_enabled=dof)
    got = raytrace_full(
        convert.scene_from_numpy(leaves(jax_scene), device="cpu"),
        convert.camera_from_numpy(leaves(jax_camera), device="cpu"),
        convert.lights_from_numpy(leaves(jax_lights), device="cpu"),
        cfg,
    )
    return got, want


def _assert_close_but_flips(got, want, atol):
    """Pixels beyond atol (winner flips) are at most FLIP_FRAC."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    bad = np.abs(got - want) > atol
    if bad.ndim == 3:
        bad = bad.any(axis=-1)
    print(f"{int(bad.sum())} of {bad.size} pixels beyond atol {atol}")
    assert bad.mean() <= FLIP_FRAC


# The XLA route for every case; the megakernel route (a ~12 s interpret-
# mode compile per configuration) for one parity and one clean DoF case.
CASES = [
    (mode, dof, w, h, False)
    for mode in ("clean", "parity")
    for dof in (False, True)
    for (w, h) in ((32, 32), (48, 32))
] + [("parity", False, 32, 32, True), ("clean", True, 48, 32, True)]


@pytest.mark.parametrize(
    "mode,dof,width,height,megakernel_route", CASES,
    ids=[f"{m}-{'dof' if d else 'nodof'}-{w}x{h}-"
         f"{'megakernel' if k else 'xla'}" for m, d, w, h, k in CASES])
def test_slice_matches_jax(mode, dof, width, height, megakernel_route):
    got, want = _render_both(mode, dof, width, height, megakernel_route)
    _assert_close_but_flips(got.image, want.image, 1e-5 if dof else 1e-6)
    _assert_close_but_flips(got.focal_distances, want.focal_distances, 1e-6)
    assert float(got.image.max()) > 0.3


def test_parity_matches_numpy_oracle():
    size = 64
    img = raytrace_full(cornell_box(device="cpu"),
                        Camera.raytracer_default(device="cpu"),
                        Lights.single(capacity=1, device="cpu"),
                        RenderConfig(width=size, height=size))
    img_o, fd_o = oracle.render(cornell_box_numpy(), width=size, height=size)
    a = img.image.numpy()
    np.testing.assert_allclose(a, img_o, atol=2e-4, rtol=1e-3)
    close = (np.abs(quantize_u8(a).astype(int)
                    - quantize_u8(img_o).astype(int)).max(axis=-1) <= 1)
    assert close.mean() >= 0.999
    np.testing.assert_allclose(img.focal_distances.numpy(), fd_o, atol=1e-4)
    # Black parity border, lit interior.
    assert not a[0].any() and not a[:, 0].any()
    assert a[1:-1, 1:-1].max() > 0.3


def test_raytrace_returns_the_image_and_launches_nothing_on_cpu():
    args = (cornell_box(pad_to=32, device="cpu"),
            Camera.raytracer_default(device="cpu"),
            Lights.single(device="cpu"),  # capacity 32, compacted to 1
            RenderConfig(width=24, height=16, mode="clean"))
    before = render_fused.LAUNCHES
    img = raytrace(*args)
    assert render_fused.LAUNCHES == before
    assert torch.equal(img, raytrace_full(*args).image)
    assert img.shape == (16, 24, 3) and bool(torch.isfinite(img).all())


def _two_lights():
    return Lights.single(capacity=2, device="cpu").add(
        (0.3, -0.5, -0.5), (1.0, 1.0, 1.0), 5.0)


# The configurations of the loop branch, the soft raytracer and STL scale
# (the box padded past one chunk: two chunks through K7a), once out of
# scope, now render and match JAX.
OUT_OF_SCOPE = {
    "megakernel-off": (lambda: (cornell_box(device="cpu"),
                                RenderConfig(megakernel=False))),
    "aa": lambda: (cornell_box(device="cpu"), RenderConfig(aa_samples=3)),
    "soft-shadows": (lambda: (cornell_box(device="cpu"),
                              RenderConfig(soft_shadow_samples=16))),
    "two-lights": lambda: (cornell_box(device="cpu"), RenderConfig()),
    "stl-scale": (lambda: (cornell_box(pad_to=136, device="cpu"),
                           RenderConfig())),
    "soft-mode": lambda: (cornell_box(device="cpu"), RenderConfig(mode="soft")),
}
STILL_RAISE = ()


@pytest.mark.parametrize("name", list(OUT_OF_SCOPE))
def test_out_of_scope_configs_raise(name):
    scene, cfg = OUT_OF_SCOPE[name]()
    cfg = cfg.replace(width=8, height=8)
    lights = (_two_lights() if name == "two-lights"
              else Lights.single(capacity=1, device="cpu"))
    camera = Camera.raytracer_default(device="cpu")
    if name in STILL_RAISE:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            raytrace(scene, camera, lights, cfg)
        return
    got = raytrace(scene, camera, lights, cfg)
    if name == "soft-mode":
        # JAX's jnp soft path is the kernels' math reassociated: its own
        # rule (tests/test_soft_raytrace_pallas.py).
        want = jax_raytrace(jax_cornell_box(), JaxCamera.raytracer_default(),
                            JaxLights.single(capacity=1),
                            JaxRenderConfig(width=8, height=8, mode="soft",
                                            use_pallas=False))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                                   rtol=1e-4)
        assert float(got.max()) > 0.05
        return
    jcfg = JaxRenderConfig(**{f: getattr(cfg, f) for f in (
        "width", "height", "mode", "aa_samples", "soft_shadow_samples",
        "megakernel")}, use_pallas=False)
    want = jax_raytrace_full(
        jax_cornell_box(), JaxCamera.raytracer_default(),
        JaxLights(**{k: jnp.asarray(v) for k, v in
                     convert.to_numpy(lights).items()}), jcfg).image
    _assert_close_but_flips(got, want, 1e-6)


def test_more_soft_samples_than_the_bank_holds_raise():
    """F7: the JAX package repeats a bank's last jittered position when
    more samples are asked for than it holds; the port refuses."""
    lights = Lights.single(capacity=1, soft_samples=1, device="cpu")
    with pytest.raises(ValueError, match="jittered"):
        raytrace(cornell_box(device="cpu"),
                 Camera.raytracer_default(device="cpu"), lights,
                 RenderConfig(width=8, height=8, soft_shadow_samples=16))
