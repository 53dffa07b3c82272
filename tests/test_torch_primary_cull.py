"""The closest-hit kernels' exact per-tile triangle cull on the CPU: the
plain form.

K5, K7d and K7a's primary sweep (csrc/intersect.cu::closest_cull_kernel)
bound each ray tile's directions, and each warp's, by a box, and leave out
every triangle that no ray of the box can pass: plane_tests' own sums Dn,
U and V evaluated at the box's corners bound every ray's (rounding to
nearest is monotone in each operand), and one of K7a's reject clauses but
t < 0.99's, holding at the bound, holds at every ray.
kernels/intersect.py::primary_tile_reject is its plain form, op by op.
These tests enumerate every ray of every tile and warp to hold it to
``plane_tests``: no culled (box, triangle) pair has a ray whose test is
ok, on random tiles and triangles and on adversarial ones (grazing tiles
over which D changes sign, coefficients at 2^+-40, D = 0, +-0, subnormal,
inf and NaN in directions and constants, u + v = 1 +- 1 ulp, k0 = +-0,
triangles behind the camera). Then the plain K5 and K7d with each warp's
culled triangles left out are held to the JAX package's
``intersect_pallas`` and ``intersect_pallas_culled`` (Pallas in interpret
mode, as its own tests run it) on the 800-triangle torus at 48^2.

Torch runs on one thread (a module fixture): under the suite's workers the
intra-op pool oversubscribes the cores.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.core.types import Scene as JaxScene
from raytpu.kernels.intersect_pallas import (
    intersect_pallas,
    intersect_pallas_culled,
)
from raytpu.ops.intersect import tri_constants as jax_tri_constants
from raytpu.render.raytrace import camera_ray_dirs, pixel_grid

from raytpu_torch.core import stl
from raytpu_torch.kernels import intersect as kernels
from raytpu_torch.ops.intersect import TriConstants

SIZE = 48
CAM_POS = (0.0123, -0.5, -5.0)
F32 = np.float32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_exact(dirs, tri, tiles=None, batch=1024):
    """Every (tile or warp, triangle) pair of the plain probe over the
    triangles ``tri`` (N, 10) [n | c2 | c3 | k0]: no culled pair has a ray
    whose plane test is ok. Returns (dec (n_tiles, 9, N) bool, culled tile
    pairs, culled warp pairs)."""
    decs, culled = [], np.zeros(2, np.int64)
    for b in range(0, tri.shape[0], batch):
        table = tri[b:b + batch].T.contiguous()
        dec, counts = kernels.primary_cull_probe(dirs, table, tiles)
        assert int(counts[2]) == 0 and int(counts[3]) == 0, \
            f"{int(counts[2])} + {int(counts[3])} ok rays in culled pairs"
        decs.append(dec)
        culled += counts[:2].numpy()
    return torch.cat(decs, dim=2), int(culled[0]), int(culled[1])


def _random_case(seed, n_tri=600):
    """Four 256-ray tiles of random directions around (0, 0, 1) at spreads
    from a pixel's to a wide view's (the last tile's rays permuted over
    the view), and random triangles: normals, edge constants and k0 of
    both signs and many scales."""
    rng = np.random.default_rng(seed)
    spread = np.repeat([1e-3, 3e-2, 0.3, 1.0], 256)[:, None]
    d = np.concatenate([rng.uniform(-1, 1, (1024, 2)) * spread,
                        np.ones((1024, 1))], axis=1)
    tri = rng.standard_normal((n_tri, 10)) * np.exp2(
        rng.integers(-8, 9, (n_tri, 1)))
    return (torch.tensor(d, dtype=torch.float32),
            torch.tensor(tri, dtype=torch.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cull_is_exact_on_random_tiles(seed):
    dirs, tri = _random_case(seed)
    dec, tile_culled, warp_culled = _check_exact(dirs, tri)
    share = warp_culled / dec[:, 1:].numel()
    print(f"seed {seed}: {tile_culled} (tile, triangle) and {warp_culled} "
          f"(warp, triangle) pairs culled ({share:.3f})")
    # Narrow tiles cull more than wide ones; a warp at least its tile.
    assert dec[0, 0].sum() > dec[3, 0].sum()
    assert bool((dec[:, 1:] | ~dec[:, :1]).all())
    assert 0.05 < share < 0.95


def _edge_triangles(n, seed):
    """n triangles from kernels.reject_edge_pairs' (D, U, V, K) values at
    every edge of the reject (against the ray (1, 0, 0): +-0, subnormal,
    the guard's ends and an ulp past them, inf and NaN; u, v, t near 0, u
    + v at 1 +- 1 ulp, k0 = +-0), and with their other components zero for
    a third, a 2^-30 multiple of a normal draw for a third and 1 for the
    rest (so that D changes sign over a grazing tile)."""
    _, tri = kernels.reject_edge_pairs()
    rng = np.random.default_rng(seed)
    tri = tri[torch.tensor(rng.choice(tri.shape[0], n, replace=False))]
    other = torch.tensor(rng.standard_normal((n, 6)), dtype=torch.float32)
    kind = torch.arange(n) % 3
    other = torch.where((kind == 0)[:, None], 0.0, torch.where(
        (kind == 1)[:, None], other * 2.0 ** -30, 1.0))
    tri = tri.clone()
    tri[:, [1, 2, 4, 5, 7, 8]] = other
    return tri


def _edge_tiles():
    """Nine 256-ray tiles: all (1, 0, 0) (a box of one direction); (1, y, z)
    with y, z within 2^-30; a grazing fan (1, y, 0), y in [-0.01, 0.01]
    with +-0; +-0 components mixed; subnormal components; one lane NaN,
    one lane inf, one lane (0, 0, 0), the rest (1, 0, 0); and a spread of
    directions of both signs of x."""
    rng = np.random.default_rng(5)
    tiles = np.zeros((9, 256, 3), F32)
    tiles[..., 0] = 1.0
    tiles[1, :, 1:] = rng.uniform(-1, 1, (256, 2)) * 2.0 ** -30
    tiles[2, :, 1] = np.linspace(-0.01, 0.01, 256)
    tiles[2, 128, 1] = -0.0
    tiles[3, :, 1:] = np.where(rng.uniform(size=(256, 2)) < 0.5, -0.0, 0.0)
    tiles[4, :, 1] = 1e-45 * rng.integers(-3, 4, 256)
    tiles[4, :, 2] = -1e-39
    tiles[5, 77, 1] = np.nan
    tiles[6, 200, 2] = np.inf
    tiles[7, 5] = 0.0
    tiles[8] = rng.uniform(-1, 1, (256, 3))
    return torch.tensor(tiles.reshape(-1, 3))


def test_cull_is_exact_on_adversarial_tiles():
    dirs = _edge_tiles()
    tri = _edge_triangles(6000, 11)
    dec, tile_culled, warp_culled = _check_exact(dirs, tri)
    print(f"{tri.shape[0]} edge triangles x 9 tiles: {tile_culled} (tile, "
          f"triangle) and {warp_culled} (warp, triangle) pairs culled")
    assert tile_culled > 0.05 * dec[:, 0].numel()
    # A box with a non-finite component culls nothing; the NaN and inf
    # lanes' warps neither, the tiles' other warps do.
    for tile, warp in ((5, 77 // 32), (6, 200 // 32)):
        assert not bool(dec[tile, 0].any())
        assert not bool(dec[tile, 1 + warp].any())
        assert bool(dec[tile, 1 + (warp + 1) % 8].any())
    # A non-finite coefficient never culls.
    bad = ~torch.isfinite(tri).all(dim=1)
    assert bool(bad.any()) and not bool(dec[:, :, bad].any())
    # A box of one direction is the reject itself: its bounds are the
    # ray's own sums, so it culls what the sweep's per-ray reject
    # (shadow_reject without t < 0.99) rejects at D = 0 or inside the
    # guard, where every coefficient is finite, and nothing else.
    m, k0 = tri[:, :9].reshape(-1, 3, 3), tri[:, 9]
    ts, oks = kernels.plane_tests(dirs[:1], m, k0)
    reject = kernels.shadow_reject(dirs[:1], m, k0, below_t=False)[0]
    d = (m[:, 0] * dirs[0]).sum(dim=1).abs()  # |D| exactly: one term
    inside = (((d >= kernels.REJECT_MIN_D) & (d <= kernels.REJECT_MAX_D))
              | (d == 0.0)) & torch.isfinite(tri).all(dim=1)
    assert torch.equal(dec[0, 0], reject & inside)
    assert int(oks[0].sum()) > 100 and int((reject & inside).sum()) > 100


def test_cull_rejects_triangles_behind_and_beside_the_tile():
    """A 16 x 16 tile of narrow rays around the ray through a triangle's
    centroid of the 180-triangle torus keeps that triangle and culls most
    others; the same rays turned around (the mesh behind them) cull it
    too, by its t < 0."""
    from raytpu_torch.core.types import Scene
    from raytpu_torch.ops.intersect import tri_constants
    tris = stl.parse_ascii_stl(stl.procedural_stl_text(10, 9))
    tris = tris * np.float32(-stl.DEFAULT_SCALE)
    scene = Scene.from_vertices(tris[:, 0], tris[:, 1], tris[:, 2],
                                np.full((tris.shape[0], 3), 0.5, F32),
                                device="cpu")
    cam = torch.tensor(CAM_POS)
    c = tri_constants(scene, cam)
    table, _ = kernels.primary_table(c.m, c.k0, c.valid, 128)
    target = 37
    center = torch.tensor(tris[target].mean(axis=0)) - cam
    y, x = torch.meshgrid(torch.arange(16.0) - 7.5, torch.arange(16.0) - 7.5,
                          indexing="ij")
    spread = 2e-4 * float(center.norm())
    dirs = (center + spread * torch.stack(
        [x, y, torch.zeros_like(x)], dim=-1)).reshape(-1, 3)
    tiles = kernels.ray_tiles(256, (16, 16), "cpu")
    shares = []
    for sign in (1.0, -1.0):
        dec, counts = kernels.primary_cull_probe(sign * dirs, table, tiles)
        assert int(counts[2]) == 0 and int(counts[3]) == 0
        real = dec[0, 0, :tris.shape[0]]
        assert bool(real[target]) == (sign < 0)
        shares.append(float(real.float().mean()))
    print(f"culled in front {shares[0]:.3f}, behind {shares[1]:.3f}")
    assert shares[0] > 0.8 and shares[1] > 0.9


@pytest.fixture(scope="module")
def torus():
    """The 800-triangle torus at 48^2 from the render --stl camera nudged
    off x = 0, JAX's brute and culled Pallas sweeps in interpret mode, and
    the port's inputs."""
    tris = stl.parse_ascii_stl(stl.procedural_stl_text(20, 20))
    tris = tris * np.float32(-stl.DEFAULT_SCALE)
    scene = JaxScene(v0=jnp.asarray(tris[:, 0]), v1=jnp.asarray(tris[:, 1]),
                     v2=jnp.asarray(tris[:, 2]),
                     color=jnp.full((tris.shape[0], 3), 0.5, jnp.float32),
                     active=jnp.ones(tris.shape[0], jnp.float32))
    cam = JaxCamera.make(CAM_POS, focal=float(SIZE))
    cfg = JaxRenderConfig(width=SIZE, height=SIZE)
    dirs = camera_ray_dirs(*pixel_grid(cfg), cam, cfg)
    consts = jax_tri_constants(scene, cam.pos)
    geom = (scene.v0, scene.v1, scene.v2)
    brute = intersect_pallas(dirs, consts)
    culled = intersect_pallas_culled(dirs, consts, cam.pos, *geom,
                                     image_hw=(SIZE, SIZE))

    def t(a):
        return torch.tensor(np.asarray(a))

    c = TriConstants(*map(t, consts))
    table, C = kernels.primary_table(c.m, c.k0, c.valid, 512)
    return dict(dirs=t(dirs), consts=c, cam=t(cam.pos),
                geom=tuple(map(t, geom)), table=table, C=C, brute=brute,
                culled=culled)


def _assert_hits(got, want):
    t, idx = got
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want.idx))
    hit = idx.numpy() >= 0
    assert 0.1 < hit.mean() < 0.9
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=5e-7)


def test_culled_plain_k5_and_k7d_match_pallas(torus):
    """The plain K5 (runs of 256 rays) and K7d (16 x 16 tiles, its
    keep-mask) with each warp's culled triangles left out equal JAX's
    intersect_pallas and intersect_pallas_culled, and the unculled plain
    versions bit for bit; the probe's plain form finds no ok ray among the
    culled pairs of either tiling."""
    c = torus
    dirs, table, C = c["dirs"], c["table"], c["C"]
    k5 = kernels.closest_reference(dirs, table, C, cull=True)
    tiles = kernels.ray_tiles(SIZE * SIZE, (SIZE, SIZE), "cpu")
    mask = kernels.primary_mask(c["cam"], dirs, tiles, *c["geom"],
                                c["consts"].valid, C)
    k7d = kernels.closest_masked_reference(dirs, table, C, mask, tiles,
                                           cull=True)
    _assert_hits(k5, c["brute"])
    _assert_hits(k7d, c["culled"])
    for got, want in ((k5, kernels.closest_reference(dirs, table, C)),
                      (k7d, kernels.closest_masked_reference(
                          dirs, table, C, mask, tiles))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for tl in (None, tiles):
        dec, counts = kernels.primary_cull_probe(dirs, table, tl)
        assert int(counts[2]) == 0 and int(counts[3]) == 0
        share = float(dec[:, 1:].float().mean())
        print(f"{'K5' if tl is None else 'K7d'} tiles: "
              f"{float(dec[:, 0].float().mean()):.4f} of (tile, triangle) "
              f"and {share:.4f} of (warp, triangle) pairs culled")
        assert share > 0.3
