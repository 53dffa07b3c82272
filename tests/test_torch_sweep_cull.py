"""K4's, L2's and K1's culled one-chunk sweeps on the CPU: the plain forms.

K4 (csrc/intersect.cu::closest_hit_occluded_kernel), L2 (the same kernel
on planar rays) and K1 (csrc/render_fused.cu::render_fused_fwd_kernel) run
both sweeps a warp at a time (csrc/sweep_cull.cuh): a warp bounds its
rays' directions by a box and culls every triangle that no ray of the box
can pass (kernels/intersect.py::primary_tile_reject), tests the survivors
in order with the exact reject first, then does the same with its shadow
rays e = (cam + tz d) - light, the box test with the t >= 0.99 clause. A
warp is 32 consecutive rays, or where the rays are an image (``image_hw``)
a block of SWEEP_WARP_ROWS x (32 / SWEEP_WARP_ROWS) pixels
(kernels/intersect.py::sweep_warps).

These tests hold the plain forms to ``plane_tests``: no culled (warp,
triangle) pair has a ray whose primary test is ok or whose shadow test
blocks, on the Cornell box at 128^2 (padded to 32 and to 128), on the
500^2 parity frame's AA sub-ray cut to eight rows, and on seeded random
rays; the sweeps over each ray's survivors (kernels/intersect.py::
sweep_keep) equal the brute plain versions (sweeps_reference,
fused_fwd_reference) bit for bit; the box's t clause culls no blocker on
random and adversarial boxes and triangles; ``image_hw`` changes no
output; and the culled plain K4's hits equal the JAX package's
``intersect`` on the cut rows.

Torch runs on one thread (a module fixture): under the suite's workers the
intra-op pool oversubscribes the cores.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.ops.intersect import TriConstants as JaxTriConstants
from raytpu.ops.intersect import intersect as jax_intersect

from raytpu_torch import Camera, Lights, RenderConfig, cornell_box
from raytpu_torch.core.types import pixel_grid
from raytpu_torch.kernels import intersect as kernels
from raytpu_torch.kernels import render_fused
from raytpu_torch.ops.intersect import plane_tests, tri_constants
from raytpu_torch.ops.shade import SHADOW_T
from raytpu_torch.render.raytrace import (
    camera_ray_dirs,
    fused_inputs,
    raytrace_full,
)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(size, mode, pad_to, offset=(0.0, 0.0), rows=None, dirs=None):
    """K1's and K4's inputs on a size^2 frame of the Cornell box (rows: the
    frame's rows [r0, r1) alone, an image of (r1 - r0, size); dirs: these
    rays instead, a list). Returns a dict of K1's table and parameters,
    K4's table, the camera and light positions, fused_inputs' arguments
    and keywords and the rays' image_hw (None for a list)."""
    cfg = RenderConfig(width=size, height=size, mode=mode)
    scene = cornell_box(pad_to=pad_to, device="cpu")
    camera = Camera.raytracer_default(device="cpu")
    args = list(fused_inputs(scene, camera,
                             Lights.single(capacity=1, device="cpu"), cfg))
    xs, ys = pixel_grid(size, size, "cpu")
    args[0] = camera_ray_dirs(xs + offset[0], ys + offset[1], camera, cfg)
    hw = (size, size)
    if rows is not None:
        args[0] = args[0].reshape(size, size, 3)[rows[0]:rows[1]].reshape(
            -1, 3).contiguous()
        hw = (rows[1] - rows[0], size)
    if dirs is not None:
        args[0], hw = dirs, None
    table, params = render_fused.pack_inputs(*args[1:], cfg.tri_chunk)
    k4_table = kernels.occluded_table(*args[1:4], args[4][None],
                                      args[5][None], cfg.tri_chunk)
    return dict(args=args, kw=dict(tri_chunk=cfg.tri_chunk,
                                   ambient=cfg.ambient,
                                   parity=mode == "parity"),
                table=table, params=params, k4_table=k4_table,
                cam=args[8], light=args[9], hw=hw)


def _random_rays(n, seed):
    """n rays from the default camera with directions drawn with numpy from
    seed: a quarter of them near the view axis at a pixel's spread, the
    rest over the whole sphere (many miss)."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    near = np.arange(n) < n // 4
    d[near] = np.array([0.0, 0.0, 1.0]) + 2e-3 * d[near]
    return torch.tensor(d, dtype=torch.float32)


CASES = {
    "clean-128-pad32": dict(size=128, mode="clean", pad_to=32),
    "clean-128-pad128": dict(size=128, mode="clean", pad_to=128),
    "parity-500-rows": dict(size=500, mode="parity", pad_to=None,
                            offset=(0.5, 0.0), rows=(248, 256)),
    "random": dict(size=64, mode="clean", pad_to=32,
                   dirs=_random_rays(4096, 3)),
}


@pytest.fixture(scope="module", params=list(CASES))
def frame(request):
    return request.param, _frame(**CASES[request.param])


def _mappings(c):
    return (None,) if c["hw"] is None else (None, c["hw"])


def test_cull_drops_no_hit_and_no_blocker(frame):
    """Every culled (warp, triangle) pair of both sweeps, on both
    mappings and on K1's and K4's tables: no ray of the warp whose primary
    test is ok, none whose shadow test blocks (the plain probe's counts);
    and the cull decides something (culled shares printed)."""
    name, c = frame
    for hw in _mappings(c):
        for table in (c["table"], c["k4_table"]):
            dec, counts = kernels.sweep_cull_probe(c["args"][0], table,
                                                   c["cam"], c["light"], hw)
            assert int(counts[2]) == 0 and int(counts[3]) == 0, (name, hw)
            assert int(counts[0]) == int(dec[:, 0].sum())
            pri = float(dec[:, 0].float().mean())
            shw = float(dec[:, 1].float().mean())
            print(f"{name} {hw}: culled {pri:.4f} primary, {shw:.4f} "
                  f"shadow (warp, triangle) pairs")
            assert pri > 0.1 and shw > 0.1


def test_culled_sweeps_equal_the_brute_ones(frame):
    """The sweeps over each ray's survivors in order (`<=`, the reject
    first: sweeps_reference and fused_fwd_reference with cull) give the
    brute plain versions' t, idx, occ, color and fd bit for bit, on both
    mappings; and they leave most tests out."""
    name, c = frame
    dirs = c["args"][0]
    src = c["light"][None]
    want4 = kernels.sweeps_reference(dirs, c["k4_table"], c["cam"], src,
                                     mask_misses=False)
    want1 = render_fused.fused_fwd_reference(
        dirs, c["table"], c["params"], ambient=c["kw"]["ambient"],
        parity=c["kw"]["parity"])
    for hw in _mappings(c):
        got4 = kernels.sweeps_reference(dirs, c["k4_table"], c["cam"], src,
                                        mask_misses=False, cull=True,
                                        image_hw=hw)
        got1 = render_fused.fused_fwd_reference(
            dirs, c["table"], c["params"], ambient=c["kw"]["ambient"],
            parity=c["kw"]["parity"], cull=True, image_hw=hw)
        for a, b in zip(got4, want4):
            assert torch.equal(a, b), (name, hw)
        for a, b in zip(got1, want1):
            assert torch.equal(a, b), (name, hw)
        pri, shw = kernels.sweep_keep(dirs, c["table"], c["cam"], c["light"],
                                      hw)
        print(f"{name} {hw}: plane tests left {float(pri.float().mean()):.4f}"
              f" primary, {float(shw.float().mean()):.5f} shadow")
        assert float(pri.float().mean()) < 0.2
    hit = want4[1] >= 0
    assert bool(hit.any()) and bool(want4[2].any())


def _box_case(seed, n_tri=600):
    """Eight 32-lane groups of random shadow vectors at spreads from a
    pixel's to a wide view's (the last group's lanes a mix of two groups),
    and random triangles of both signs and many scales."""
    rng = np.random.default_rng(seed)
    spread = np.repeat([1e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0, 2.0, 1.0], 32)
    v = rng.uniform(-1, 1, (256, 3)) * spread[:, None]
    v[:, 2] += rng.uniform(0.5, 2.0)
    v[224:240] = v[:16]
    tri = rng.standard_normal((n_tri, 10)) * np.exp2(
        rng.integers(-8, 9, (n_tri, 1)))
    return (torch.tensor(v.reshape(8, 32, 3), dtype=torch.float32),
            torch.tensor(tri, dtype=torch.float32))


def _assert_no_blocker_culled(v, tri):
    """No group's box culls (below_t) a triangle one of its lanes' shadow
    test blocks. Returns the culled share."""
    valid = torch.ones(v.shape[:2], dtype=torch.bool)
    lo, hi, any_, finite = kernels.lane_boxes(v, valid)
    m, k0 = tri[:, :9].reshape(-1, 3, 3), tri[:, 9]
    cull = kernels.primary_tile_reject(lo, hi, any_, finite, m, k0,
                                       below_t=True)
    ts, oks = plane_tests(v.reshape(-1, 3), m, k0)
    blocks = (oks & (ts < SHADOW_T)).reshape(v.shape[0], v.shape[1], -1)
    assert not bool((blocks & cull[:, None, :]).any())
    # Without the t clause the cull keeps at least as much.
    plain = kernels.primary_tile_reject(lo, hi, any_, finite, m, k0)
    assert not bool((plain & ~cull).any())
    return float(cull.float().mean()), float(plain.float().mean())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_box_t_clause_is_exact_on_random_boxes(seed):
    v, tri = _box_case(seed)
    with_t, without = _assert_no_blocker_culled(v, tri)
    print(f"seed {seed}: culled {with_t:.3f} with the t clause, "
          f"{without:.3f} without")
    assert with_t > without


def test_box_t_clause_is_exact_on_edge_triangles():
    """The t clause on the reject's edge constants (reject_edge_pairs: D,
    U, V, K at ±0, subnormal, the guard's ends and an ulp past them, inf,
    NaN, t at 0.99 ± 1 ulp) against boxes of one vector, of vectors within
    2^-30 and of a grazing fan: no blocker culled, and a box of one vector
    culls exactly what the per-ray shadow reject rejects inside the
    guard."""
    _, tri = kernels.reject_edge_pairs()
    rng = np.random.default_rng(4)
    v = np.zeros((3, 32, 3), np.float32)
    v[..., 0] = 1.0
    v[1, :, 1:] = rng.uniform(-1, 1, (32, 2)) * 2.0 ** -30
    v[2, :, 1] = np.linspace(-0.01, 0.01, 32)
    v = torch.tensor(v)
    _assert_no_blocker_culled(v, tri)
    lo, hi, any_, finite = kernels.lane_boxes(v[:1, :1],
                                              torch.ones((1, 1), dtype=bool))
    m, k0 = tri[:, :9].reshape(-1, 3, 3), tri[:, 9]
    cull = kernels.primary_tile_reject(lo, hi, any_, finite, m, k0,
                                       below_t=True)[0]
    reject = kernels.shadow_reject(v[0, :1], m, k0)[0]
    d = m[:, 0, 0].abs()  # |D| exactly: one term
    inside = (((d >= kernels.REJECT_MIN_D) & (d <= kernels.REJECT_MAX_D))
              | (d == 0.0)) & torch.isfinite(tri).all(dim=1)
    assert torch.equal(cull, reject & inside)
    assert int(cull.sum()) > 100


def test_sweep_warps_lay_out_the_grid(monkeypatch):
    """Each ray lies in exactly one valid lane; consecutive warps are the
    rays in order; an image's warp holds a block of SWEEP_WARP_ROWS rows
    (1, 2, 4 and 8); the warps fill whole blocks of 8."""
    R = 500 * 7
    rays, valid = kernels.sweep_warps(R, None)
    assert torch.equal(rays[valid], torch.arange(R))
    assert rays.shape[0] % kernels.SWEEP_BLOCK_WARPS == 0
    for wh in (1, 2, 4, 8):
        monkeypatch.setattr(kernels, "SWEEP_WARP_ROWS", wh)
        rays, valid = kernels.sweep_warps(R, (7, 500))
        got = torch.sort(rays[valid]).values
        assert torch.equal(got, torch.arange(R))
        y, x = rays // 500, rays % 500
        for g in range(rays.shape[0]):
            if valid[g].any():
                yy, xx = y[g][valid[g]], x[g][valid[g]]
                assert int(yy.max() - yy.min()) < wh
                assert int(xx.max() - xx.min()) < 32 // wh
    monkeypatch.undo()
    warp = kernels.sweep_ray_warps(R, (7, 500))
    rays, valid = kernels.sweep_warps(R, (7, 500))
    assert torch.equal(rays[warp, :].eq(torch.arange(R)[:, None]).any(1),
                       torch.ones(R, dtype=torch.bool))
    with pytest.raises(ValueError):
        kernels.sweep_grid(R, (8, 500))
    monkeypatch.setattr(kernels, "SWEEP_WARP_ROWS", 3)
    with pytest.raises(ValueError):
        kernels.sweep_grid(R, (7, 500))


def test_image_hw_changes_no_output(monkeypatch):
    """The image_hw keyword of closest_hit_occluded, intersect_occluded,
    fused_fwd and render_hard_fused changes no output (on the CPU the
    plain versions), and a wrong one raises; raytrace_full passes the
    frame's to K1 (its megakernel frame) and to K4 (its --aa 3 loop-branch
    frame), and its frames equal those made with the keyword dropped."""
    from raytpu_torch.render import raytrace as rt
    c = _frame(48, "parity", None)
    args, kw, hw = c["args"], c["kw"], c["hw"]
    k4 = (*args[:6], args[8], args[9])
    a = kernels.closest_hit_occluded(*k4)
    b = kernels.closest_hit_occluded(*k4, image_hw=hw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    consts = tri_constants(cornell_box(device="cpu"), args[8])
    light = tri_constants(cornell_box(device="cpu"), args[9])
    a = kernels.intersect_occluded(args[0], consts, light, args[8], args[9])
    b = kernels.intersect_occluded(args[0], consts, light, args[8], args[9],
                                   image_hw=hw)
    assert all(torch.equal(x, y) for x, y in zip((*a[0], a[1]),
                                                  (*b[0], b[1])))
    a = render_fused.render_hard_fused(*args, **kw)
    b = render_fused.render_hard_fused(*args, **kw, image_hw=hw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    a = render_fused.fused_fwd(args[0], c["table"], c["params"],
                               ambient=kw["ambient"], parity=kw["parity"])
    b = render_fused.fused_fwd(args[0], c["table"], c["params"],
                               ambient=kw["ambient"], parity=kw["parity"],
                               image_hw=hw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        kernels.closest_hit_occluded(*k4, image_hw=(47, 48))
    with pytest.raises(ValueError):
        render_fused.render_hard_fused(*args, **kw, image_hw=(48, 47))

    seen = []

    def spy(fn, drop):
        def call(*a, image_hw=None, **k):
            seen.append(image_hw)
            return fn(*a, **k) if drop else fn(*a, image_hw=image_hw, **k)
        return call

    scene = cornell_box(device="cpu")
    camera = Camera.raytracer_default(device="cpu")
    one = Lights.single(capacity=1, device="cpu")
    for cfg in (RenderConfig(width=40, height=24),
                RenderConfig(width=40, height=24, aa_samples=3)):
        frames = []
        for drop in (False, True):
            monkeypatch.setattr(rt.render_fused, "render_hard_fused",
                                spy(render_fused.render_hard_fused, drop))
            monkeypatch.setattr(rt, "intersect_occluded",
                                spy(kernels.intersect_occluded, drop))
            frames.append(raytrace_full(scene, camera, one, cfg))
            monkeypatch.undo()
        assert all(torch.equal(x, y) for x, y in zip(*frames))
        assert frames[0].image.shape == (24, 40, 3)
    assert seen == [(24, 40)] * 2 + [(24, 40)] * 18


def test_culled_plain_k4_matches_jax_on_the_cut_rows():
    """The culled plain K4 on the 500^2 parity frame's AA sub-ray (0.5, 0),
    rows 248-255, on its image's warps: idx equal to the JAX package's
    ``intersect`` on the same rays and constants (carried over as numpy)
    on every ray, t within 5e-7 on the hits."""
    c = _frame(500, "parity", None, (0.5, 0.0), rows=(248, 256))
    args = c["args"]
    t, idx, _ = kernels.sweeps_reference(args[0], c["k4_table"], c["cam"],
                                         c["light"][None], mask_misses=False,
                                         cull=True, image_hw=c["hw"])
    scene = jax_cornell_box()
    consts = JaxTriConstants(*(jnp.asarray(a.numpy()) for a in args[1:4]))
    assert scene.v0.shape[0] == args[1].shape[0]
    want = jax_intersect(jnp.asarray(args[0].numpy()), consts)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want.idx))
    hit = idx.numpy() >= 0
    assert 0.5 < hit.mean()
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=5e-7)
