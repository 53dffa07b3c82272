"""The port's core types (raytpu_torch.core) against the JAX package's.

Exact (atol 0): the Cornell box vertices, the converter's round trip,
``pad_to``, ``Lights.add`` with the JAX jitter offsets, ``Lights.compact``,
the rotation at yaw 0, and the RenderConfig defaults.

Within float32 rounding, with the cause: ``normals()`` on the JAX side runs
``jnp.cross`` compiled by XLA:CPU, which contracts ``a*b - c*d`` into a
fused multiply-add; the port (like the TPU and the CUDA kernels) rounds
each product. The two differ by at most a few ulps of the unit normal.
``rotation()`` at other yaws differs where XLA's and PyTorch's float32
cos/sin differ, by at most 1 ulp.
"""

import dataclasses

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

from raytpu_torch import convert
from raytpu_torch.core.cornell import cornell_box, cornell_box_numpy
from raytpu_torch.core.types import Camera, Lights, RenderConfig

EPS32 = float(np.finfo(np.float32).eps)


def leaves(value):
    """A JAX pytree dataclass's leaves as numpy arrays."""
    return {k: np.asarray(v) for k, v in vars(value).items()}


def _random_jax_scene(seed=0, T=20):
    rng = np.random.default_rng(seed)
    v0, v1, v2, color = (rng.uniform(-1, 1, (T, 3)).astype(np.float32)
                         for _ in range(4))
    v2[3] = v0[3]  # one degenerate triangle (|n| = 0)
    return JaxScene.from_vertices(v0, v1, v2, np.abs(color))


SCENES = {"cornell": lambda: jax_cornell_box(), "random": _random_jax_scene}


@pytest.fixture(params=list(SCENES))
def jax_scene(request):
    return SCENES[request.param]()


def test_cornell_box_numpy_is_bit_exact():
    for ours, theirs in zip(cornell_box_numpy(), jax_cornell_box_numpy()):
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs)
    scene = convert.to_numpy(cornell_box(pad_to=32, device="cpu"))
    for name, value in leaves(jax_cornell_box(pad_to=32)).items():
        np.testing.assert_array_equal(scene[name], value)


def test_converter_round_trips(jax_scene):
    jax_lights = JaxLights.single(capacity=4, soft_samples=8,
                                  key=jax.random.PRNGKey(2))
    jax_camera = JaxCamera.make((0.1, 0.2, -1.5), yaw=0.3)
    for value, from_numpy in ((jax_scene, convert.scene_from_numpy),
                              (jax_camera, convert.camera_from_numpy),
                              (jax_lights, convert.lights_from_numpy)):
        want = leaves(value)
        got = convert.to_numpy(from_numpy(want, device="cpu"))
        assert got.keys() == want.keys()
        for name in want:
            assert got[name].dtype == np.float32
            np.testing.assert_array_equal(got[name], want[name])


def test_converter_refuses_other_dtypes():
    bad = leaves(jax_cornell_box())
    bad["v0"] = bad["v0"].astype(np.float64)
    with pytest.raises(ValueError, match="float32"):
        convert.scene_from_numpy(bad, device="cpu")


def test_pad_to_matches_jax(jax_scene):
    scene = convert.scene_from_numpy(leaves(jax_scene), device="cpu")
    T = scene.num_triangles
    for size in (T, T + 1, 40):
        got = convert.to_numpy(scene.pad_to(size))
        for name, value in leaves(jax_scene.pad_to(size)).items():
            np.testing.assert_array_equal(got[name], value)
    with pytest.raises(ValueError):
        scene.pad_to(T - 1)


def test_normals_match_jax(jax_scene):
    padded = jax_scene.pad_to(jax_scene.num_triangles + 4)
    scene = convert.scene_from_numpy(leaves(padded), device="cpu")
    got = scene.normals().numpy()
    want = np.asarray(padded.normals())
    # Degenerate and padding triangles give exactly 0 on both sides.
    zero = ~want.any(axis=1)
    assert zero.sum() >= 4
    np.testing.assert_array_equal(got[zero], 0.0)
    # Unit normals: the FMA contraction moves a component by a few ulps.
    np.testing.assert_allclose(got, want, rtol=0, atol=8 * EPS32)
    np.testing.assert_allclose(np.linalg.norm(got[~zero], axis=1), 1.0,
                               atol=4 * EPS32)


@pytest.mark.parametrize("yaw", [0.0, 0.1, -0.3, 1.0, 2.5])
def test_rotation_matches_jax(yaw):
    got = Camera.make((0.0, 0.0, -2.0), yaw=yaw, y_scale=1.01,
                      device="cpu").rotation().numpy()
    want = np.asarray(JaxCamera.make((0.0, 0.0, -2.0), yaw=yaw,
                                     y_scale=1.01).rotation())
    if yaw == 0.0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_camera_defaults_match_jax():
    got = convert.to_numpy(Camera.raytracer_default(device="cpu"))
    for name, value in leaves(JaxCamera.raytracer_default()).items():
        np.testing.assert_array_equal(got[name], value)


def test_lights_add_with_jax_offsets_matches_jax():
    key = jax.random.PRNGKey(3)
    pos = np.array([0.1, -0.4, -0.6], np.float32)
    jax_lights = JaxLights.empty(4, 16).add(
        jnp.asarray(pos), jnp.ones(3, jnp.float32), jnp.float32(9.0), key=key)
    offsets = np.asarray(
        jax.random.uniform(key, (16, 3), jnp.float32, -0.5, 0.5) * 0.08)
    lights = Lights.empty(4, 16, device="cpu").add(
        pos, (1.0, 1.0, 1.0), 9.0, offsets=offsets)
    got = convert.to_numpy(lights)
    for name, value in leaves(jax_lights).items():
        np.testing.assert_array_equal(got[name], value)


def test_lights_add_draws_from_the_generator():
    def draw(seed):
        return Lights.single(capacity=2, soft_samples=4, device="cpu",
                             generator=torch.Generator().manual_seed(seed))

    a, b, c = draw(1), draw(1), draw(2)
    assert torch.equal(a.jitter, b.jitter)
    assert not torch.equal(a.jitter, c.jitter)
    off = a.jitter[0] - a.position[0]
    assert float(off.abs().max()) <= 0.04 + 1e-7
    assert not a.jitter[1].any()  # the inactive slot stays zero


@pytest.mark.parametrize("active", [[0], [0, 2], [1, 3], [0, 1, 2, 3], []])
def test_compact_matches_jax(active):
    jax_lights = JaxLights.empty(4, 2)
    for i in range(4):
        jax_lights = jax_lights.add(
            jnp.full(3, 0.1 * i, jnp.float32), jnp.ones(3, jnp.float32),
            jnp.float32(i + 1.0), key=jax.random.PRNGKey(i))
    mask = np.zeros(4, np.float32)
    mask[active] = 1.0
    jax_lights = dataclasses.replace(jax_lights, mask=jnp.asarray(mask))
    lights = convert.lights_from_numpy(leaves(jax_lights), device="cpu")
    got = convert.to_numpy(lights.compact())
    want = leaves(jax_lights.compact())
    assert got["mask"].shape == (max(len(active), 1),)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value)


@pytest.mark.parametrize("active", [[0], [0, 2], [1, 3], [0, 1, 2, 3], []])
def test_delete_last_matches_jax(active):
    mask = np.zeros(4, np.float32)
    mask[active] = 1.0
    jax_lights = dataclasses.replace(JaxLights.empty(4, 2),
                                     mask=jnp.asarray(mask))
    lights = convert.lights_from_numpy(leaves(jax_lights), device="cpu")
    got = convert.to_numpy(lights.delete_last())
    want = leaves(jax_lights.delete_last())
    for name, value in want.items():
        np.testing.assert_array_equal(got[name], value)


def test_render_config_defaults_match_jax():
    ours = {f.name: getattr(RenderConfig(), f.name)
            for f in dataclasses.fields(RenderConfig)}
    theirs = {f.name: getattr(JaxRenderConfig(), f.name)
              for f in dataclasses.fields(JaxRenderConfig)}
    assert "use_pallas" not in ours
    del theirs["use_pallas"]
    assert ours == theirs
