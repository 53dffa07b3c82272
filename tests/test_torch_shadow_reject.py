"""K7a's exact any-hit reject on the CPU: its plain form, and K7a's plain
version against the JAX package.

K7a's shadow sweep decides a test "not blocked" without the IEEE
reciprocal where the signs of D, U, V and K, or a comparison against |D|
with a margin, prove that plane_test's ``ok and t < 0.99`` is false
(csrc/intersect.cu::shadow_reject, whose comment gives the rounding
argument); every other test goes to plane_test.
kernels/intersect.py::shadow_reject is its plain form, in plane_tests' order
of operations. These tests hold it to never reject a test that
``plane_tests`` finds blocking, and to decide nearly all the others: on
every (hit ray, source, triangle) test of the 800-triangle torus at 48^2
with 8 sources, and on hand-built constants at each edge of the argument
(D, U, V, K at +-0, subnormal, inf and NaN, the guard's ends, t at 0.99 and
u + v at 1, each +- 1 ulp); and, for K7b and K7c, which test every point,
on every (point, source, triangle) of that frame with a miss's camera
position as its point. K7a's plain version, ``occluded_masked_reference``
(unchanged by the reject, which only the kernel takes), is held to JAX's
interpret-mode route at the same frame, bit for bit in idx and occ.

Torch runs on one thread (a module fixture): under the suite's workers the
intra-op pool oversubscribes the cores.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.core.types import Scene as JaxScene
from raytpu.kernels.intersect_pallas import intersect_occluded_multi_pallas
from raytpu.ops.intersect import tri_constants as jax_tri_constants
from raytpu.render.raytrace import camera_ray_dirs, pixel_grid

from raytpu_torch.core import stl
from raytpu_torch.kernels import intersect as kernels
from raytpu_torch.ops.intersect import TriConstants, plane_tests
from raytpu_torch.ops.shade import SHADOW_T

SIZE = 48
CAM_POS = (0.0123, -0.5, -5.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sources() -> np.ndarray:
    """Two lights of the full-feature frame, four jittered samples each
    (S = 8, light-major and sample-minor), drawn with numpy."""
    rng = np.random.default_rng(15)
    base = np.array([[0.0, -0.5, -0.7], [0.4, -0.5, -0.7]], np.float32)
    jitter = rng.uniform(-0.1, 0.1, (2, 4, 3)).astype(np.float32)
    return (base[:, None, :] + jitter).reshape(8, 3)


@pytest.fixture(scope="module")
def frame():
    """The 800-triangle torus at 48^2 (the render --stl camera nudged off
    x = 0, focal 48), its constants from the camera and from 8 sources,
    JAX's occluded route in interpret mode, and the port's inputs."""
    tris = stl.parse_ascii_stl(stl.procedural_stl_text(20, 20))
    tris = tris * np.float32(-stl.DEFAULT_SCALE)
    scene = JaxScene(v0=jnp.asarray(tris[:, 0]), v1=jnp.asarray(tris[:, 1]),
                     v2=jnp.asarray(tris[:, 2]),
                     color=jnp.full((tris.shape[0], 3), 0.5, jnp.float32),
                     active=jnp.ones(tris.shape[0], jnp.float32))
    cam = JaxCamera.make(CAM_POS, focal=float(SIZE))
    cfg = JaxRenderConfig(width=SIZE, height=SIZE)
    dirs = camera_ray_dirs(*pixel_grid(cfg), cam, cfg)
    src = jnp.asarray(_sources())
    consts = jax_tri_constants(scene, cam.pos)
    consts_src = jax.vmap(lambda o: jax_tri_constants(scene, o))(src)
    geom = (scene.v0, scene.v1, scene.v2)
    want = intersect_occluded_multi_pallas(
        dirs, consts, consts_src, cam.pos, src, scene_geom=geom,
        image_hw=(SIZE, SIZE))

    def t(a):
        return torch.tensor(np.asarray(a))

    return dict(dirs=t(dirs), consts=TriConstants(*map(t, consts)),
                consts_src=TriConstants(*map(t, consts_src)), cam=t(cam.pos),
                src=t(src), geom=tuple(map(t, geom)), want=want)


def test_reject_on_every_shadow_test_of_the_torus(frame):
    """Every (hit ray, source, triangle) test of the frame: the reject
    rejects no blocking test, and decides nearly all that do not block."""
    c, cs = frame["consts"], frame["consts_src"]
    t, idx = kernels.closest_hit_reference(frame["dirs"], c.m, c.k0, c.valid)
    hit = idx >= 0
    pos = frame["cam"][None, :] + t[hit][:, None] * frame["dirs"][hit]
    m_s = cs.m * c.valid[None, :, None, None]
    k0_s = cs.k0 * c.valid[None, :]
    tests = rejected = blocking = 0
    for s in range(frame["src"].shape[0]):
        delta = pos - frame["src"][s][None, :]
        ts, oks = plane_tests(delta, m_s[s], k0_s[s])
        blocked = oks & (ts < SHADOW_T)
        reject = kernels.shadow_reject(delta, m_s[s], k0_s[s])
        assert not bool((reject & blocked).any())
        tests += reject.numel()
        rejected += int(reject.sum())
        blocking += int(blocked.sum())
    share = rejected / tests
    print(f"\n{hit.sum()} hit rays x 8 sources x 800 triangles: {tests} "
          f"tests, {blocking} blocking, the reject decides {rejected} "
          f"({share:.6f}), {tests - rejected - blocking} left to the full "
          f"test that do not block")
    assert int(hit.sum()) > 300 and blocking > 1000
    assert share > 0.99
    assert rejected >= 0.999 * (tests - blocking)


def test_reject_on_every_occlusion_test_of_the_torus_misses_included(frame):
    """K7b's and K7c's tests: every (point, source, triangle) of the frame,
    each point the hit position or, on a miss, the camera position (as the
    sharded renderer forms them): the reject rejects no blocking test, a
    miss point's included, and decides nearly all that do not block."""
    c, cs = frame["consts"], frame["consts_src"]
    t, idx = kernels.closest_hit_reference(frame["dirs"], c.m, c.k0, c.valid)
    hit = idx >= 0
    pos = frame["cam"][None, :] + torch.where(hit, t, 0.0)[:, None] * (
        frame["dirs"])
    m_s = cs.m * c.valid[None, :, None, None]
    k0_s = cs.k0 * c.valid[None, :]
    tests = rejected = blocking = miss_blocking = 0
    for s in range(frame["src"].shape[0]):
        delta = pos - frame["src"][s][None, :]
        ts, oks = plane_tests(delta, m_s[s], k0_s[s])
        blocked = oks & (ts < SHADOW_T)
        reject = kernels.shadow_reject(delta, m_s[s], k0_s[s])
        assert not bool((reject & blocked).any())
        tests += reject.numel()
        rejected += int(reject.sum())
        blocking += int(blocked.sum())
        miss_blocking += int(blocked[~hit].sum())
    assert 0 < int((~hit).sum()) < hit.numel() and miss_blocking > 0
    assert rejected >= 0.999 * (tests - blocking)


def test_reject_on_every_shadow_test_of_the_full_feature_frame():
    """K6's shadow tests on the bench's full-feature Cornell frame at 32^2
    (the box padded to 32, two lights of 16 jittered samples, S = 32, the
    first AA sub-ray): the reject rejects no blocking test of any hit ray,
    and decides nearly all that do not block."""
    from raytpu_torch.core.cornell import cornell_box
    from raytpu_torch.core.types import Camera, Lights, RenderConfig
    from raytpu_torch.core.types import pixel_grid as port_pixel_grid
    from raytpu_torch.ops.intersect import tri_constants
    from raytpu_torch.ops.shade import source_positions
    from raytpu_torch.render.raytrace import (
        camera_ray_dirs as port_ray_dirs)
    size = 32
    scene = cornell_box(pad_to=32, device="cpu")
    camera = Camera.raytracer_default(device="cpu")
    cfg = RenderConfig(width=size, height=size, mode="clean")
    lights = Lights.single(capacity=2, soft_samples=16, device="cpu").add(
        (0.4, -0.5, -0.7), (1.0, 1.0, 1.0), 7.0,
        generator=torch.Generator().manual_seed(1))
    xs, ys = port_pixel_grid(size, size, "cpu")
    dirs = port_ray_dirs(xs - 0.5, ys - 0.5, camera, cfg)
    c = tri_constants(scene, camera.pos)
    src = source_positions(lights, 16)
    cs = tri_constants(scene, src)
    table = kernels.occluded_table(c.m, c.k0, c.valid, cs.m, cs.k0,
                                   cfg.tri_chunk)
    t, idx, _ = kernels.sweeps_reference(dirs, table, camera.pos, src)
    hit = idx >= 0
    pos = camera.pos[None, :] + t[hit][:, None] * dirs[hit]
    tests = rejected = blocking = 0
    for s in range(src.shape[0]):
        m, k0 = kernels._block(table, 1 + s)
        delta = pos - src[s][None, :]
        ts, oks = plane_tests(delta, m, k0)
        blocked = oks & (ts < SHADOW_T)
        reject = kernels.shadow_reject(delta, m, k0)
        assert not bool((reject & blocked).any())
        tests += reject.numel()
        rejected += int(reject.sum())
        blocking += int(blocked.sum())
    print(f"\n{int(hit.sum())} hit rays x 32 sources x 32 triangles: "
          f"{tests} tests, {blocking} blocking, the reject decides "
          f"{rejected} ({rejected / tests:.6f})")
    assert src.shape[0] == 32 and int(hit.sum()) > 0.9 * size * size
    assert blocking > 100
    assert rejected >= 0.99 * (tests - blocking)


def test_reject_at_the_edges_of_its_argument():
    """Hand-built constants at every edge: no blocking test rejected, both
    verdicts present, and the clear cases decided."""
    delta, tri = kernels.reject_edge_pairs()
    m, k0 = tri[:, :9].reshape(-1, 3, 3), tri[:, 9]
    ts, oks = plane_tests(delta[:1], m, k0)
    blocked = (oks & (ts < SHADOW_T))[0]
    reject = kernels.shadow_reject(delta[:1], m, k0)[0]
    assert not bool((reject & blocked).any())
    assert int(blocked.sum()) > 10_000 and int(reject.sum()) > 50_000
    D, U, V, K = -tri[:, 0], tri[:, 3], tri[:, 6], tri[:, 9]
    # A zero D never hits, and the reject says so.
    assert bool(reject[D == 0].all())
    # Outside the guard (NaN, inf, subnormal, beyond 2^+-40) it decides
    # nothing but D = 0.
    Ds = D.abs()
    outside = ~((Ds >= kernels.REJECT_MIN_D) & (Ds <= kernels.REJECT_MAX_D))
    assert not bool(reject[outside & (D != 0)].any())
    # Inside it, a clearly negative u (U = -D / 2) is decided.
    clear = ~outside & (U == -0.5 * D) & ~torch.isnan(V) & ~torch.isnan(K)
    assert bool(clear.any()) and bool(reject[clear].all())
    # A blocking test one ulp inside t < 0.99 or u + v <= 1 is left alone.
    near = blocked & ~outside & (
        ((K / D - SHADOW_T).abs() < 1e-6) | (((U + V) / D - 1).abs() < 1e-6))
    assert bool(near.any()) and not bool(reject[near].any())


def test_reject_probe_plain_path():
    """The probe's CPU path is the plain reject and plane_tests, pair by
    pair."""
    delta, tri = kernels.reject_random_pairs(600, 3)
    reject, blocked = kernels.shadow_reject_probe(delta, tri)
    m, k0 = tri[:, :9].reshape(-1, 3, 3), tri[:, 9]
    for k in (0, 257, 599):
        ts, ok = plane_tests(delta[k:k + 1], m[k:k + 1], k0[k:k + 1])
        assert bool(blocked[k]) == bool(ok[0, 0] and ts[0, 0] < SHADOW_T)
        assert bool(reject[k]) == bool(kernels.shadow_reject(
            delta[k:k + 1], m[k:k + 1], k0[k:k + 1])[0, 0])
    assert not bool((reject & blocked).any())
    assert 0 < int(blocked.sum()) < 600 and int(reject.sum()) > 300


def test_occluded_masked_reference_matches_pallas(frame):
    """K7a's plain version against JAX's scene_geom route in interpret
    mode at S = 8: idx and occ bit for bit, t to rtol 5e-7 (XLA:CPU's FMA
    contraction, F4)."""
    c, cs = frame["consts"], frame["consts_src"]
    tiles = kernels.ray_tiles(SIZE * SIZE, (SIZE, SIZE), "cpu")
    mask = kernels.fused_mask(frame["dirs"], tiles, frame["geom"], c.valid,
                              frame["src"], frame["cam"], 128)
    before = kernels.LAUNCHES_OCCLUDED_MASKED
    t, idx, occ = kernels.closest_hit_occluded_multi_masked(
        frame["dirs"], c.m, c.k0, c.valid, cs.m, cs.k0, frame["cam"],
        frame["src"], mask, tiles)
    assert kernels.LAUNCHES_OCCLUDED_MASKED == before
    want_hits, want_occ = frame["want"]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_hits.idx))
    np.testing.assert_array_equal(occ.bool().numpy(), np.asarray(want_occ))
    hit = idx.numpy() >= 0
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(want_hits.t)[hit],
                               rtol=5e-7)
    assert occ.shape == (8, SIZE * SIZE) and bool(occ.any())
    assert not bool(occ[:, ~torch.tensor(hit)].any())
