"""K8a's and K8c's exact per-tile row cull on the CPU: the plain form.

The redesigned chunked winner kernels (csrc/raster.cu) decide, for every
16 x 16 pixel tile and every row of the (T, 16) constants, whether the row
can cover any pixel of the tile, and sweep only the rows that can. The
decision's plain form is kernels/raster.py::raster_tile_reject, op by op:
a plane is below 0 at every pixel of the tile where the sweep's own
expression is below 0 at the tile's largest corner (rounding to nearest is
monotone in each operand). These tests enumerate every pixel of every tile
to hold it to the per-pixel test on random rows and on adversarial ones
(edges through pixel corners, coefficients near 2^+-40, valid 0, NaN and
inf), and hold the plain K8a and K8c with the culled rows removed to the
JAX package's ``resolve_winner_pallas`` (Pallas in interpret mode, as its
own tests run it), at y0 = 0 and y0 != 0.

Torch runs on one thread (a module fixture): under the suite's workers the
intra-op pool oversubscribes the cores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.core.stl import load_stl as jax_load_stl
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.kernels import raster_pallas as jax_kernels
from raytpu.ops.raster import cull_mask as jax_cull_mask
from raytpu.render.soft import _screen_vertices as jax_screen_vertices

from raytpu_torch.core.stl import procedural_stl_text
from raytpu_torch.kernels import raster as kernels

SIZE = 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _covered(consts, H, W, y0):
    """(T, H*W) bool: the sweep's test of every row at every pixel of rows
    [y0, y0 + H), each plane in the kernels' expression."""
    px, py = kernels.pixel_grid(H, W, "cpu", y0)

    def plane(j):
        return (consts[:, j:j + 1] * px[None, :]
                + consts[:, j + 1:j + 2] * py[None, :]) + consts[:, j + 2:j + 3]

    return ((plane(0) >= 0.0) & (plane(3) >= 0.0) & (plane(6) >= 0.0)
            & (plane(9) > 0.0) & (consts[:, 12:13] > 0.0))


def _check_exact(consts, H, W, y0):
    """No rejected (row, tile) pair has a covered pixel of the tile. Returns
    the share of pairs rejected."""
    xmin, xmax, ymin, ymax = kernels.tile_rects(H, W, "cpu")
    rej = kernels.raster_tile_reject(consts, (xmin, xmax, ymin + y0,
                                              ymax + y0))
    px, py = kernels.pixel_grid(H, W, "cpu")
    tile = (py.long() // kernels.TILE) * -(-W // kernels.TILE) \
        + px.long() // kernels.TILE
    wrong = rej[:, tile] & _covered(consts, H, W, y0)
    assert not bool(wrong.any()), \
        f"{int(wrong.sum())} covered pixels of rejected rows"
    return float(rej.float().mean())


def _random_rows(n, seed, scale=60.0):
    """Triangles of a few pixels to a few tens, over and around a SIZE^2
    image, as raster_tri_constants makes them; a fifth invalid."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.3 * SIZE, 1.3 * SIZE, (n, 1, 2))
    v = c + rng.normal(0.0, scale / 6, (n, 3, 2))
    sx = torch.tensor(v[..., 0], dtype=torch.float32)
    sy = torch.tensor(v[..., 1], dtype=torch.float32)
    zinv = torch.tensor(rng.uniform(-0.2, 1.0, (n, 3)), dtype=torch.float32)
    keep = torch.tensor(rng.uniform(size=n) > 0.2, dtype=torch.float32)
    return kernels.raster_tri_constants(sx, sy, zinv, keep)


@pytest.mark.parametrize("H,W,y0", [(SIZE, SIZE, 0), (37, 53, 0),
                                    (40, SIZE, 24)])
def test_reject_is_exact_on_random_rows(H, W, y0):
    consts = _random_rows(600, seed=H + W + y0)
    share = _check_exact(consts, H, W, y0)
    print(f"{H}x{W} at y0 {y0}: {share:.3f} of (row, tile) pairs rejected")
    assert 0.5 < share < 1.0


def _adversarial_rows():
    """Edges through pixel corners (the corner's value exactly 0 and one
    ulp around it), coefficients near 2^40 and 2^-40, valid 0, and NaN and
    inf in each plane."""
    rows = []

    def row(e0, e1, e2, z, valid=1.0):
        rows.append([*e0, *e1, *e2, *z, valid, 0.0, 0.0, 0.0])

    big = (0.0, 0.0, 1.0)  # a plane >= 0 everywhere
    zpos = (0.0, 0.0, 0.5)
    for x0 in (0.0, 15.0, 16.0, 31.0, 47.0):
        for c in (np.nextafter(np.float32(-x0), np.float32(-np.inf)),
                  np.float32(-x0),
                  np.nextafter(np.float32(-x0), np.float32(np.inf))):
            # x - x0 >= 0: the edge x = x0 through a column of corners, and
            # its mirror x0 - x >= 0.
            row((1.0, 0.0, float(c)), big, big, zpos)
            row((-1.0, 0.0, float(-c)), big, big, zpos)
            row(big, (0.0, 1.0, float(c)), big, zpos)
            row(big, big, (0.0, -1.0, float(-c)), zpos)
            # zpx through the corners: covered only where zpx > 0.
            row(big, big, big, (1.0, 0.0, float(c)))
            row(big, big, big, (-1.0, 0.0, float(-c)))
    # Diagonals through corners, with slopes that round.
    for a, b in ((0.6, 0.8), (0.8, -0.6), (-0.70710677, 0.70710677),
                 (1e-7, 1.0), (1.0, -1e-7)):
        for x, y in ((16.0, 16.0), (15.0, 31.0), (47.0, 0.0)):
            c = -(np.float32(a) * np.float32(x) + np.float32(b)
                  * np.float32(y))
            for cc in (np.nextafter(c, np.float32(-np.inf)), c,
                       np.nextafter(c, np.float32(np.inf))):
                row((a, b, float(cc)), big, big, zpos)
                row(big, big, big, (a, b, float(cc)))
    # Coefficients near 2^+-40.
    for s in (2.0 ** 40, 2.0 ** -40, -(2.0 ** 40), 1.5 * 2.0 ** 39):
        row((s, s, -40.0 * s), big, big, zpos)
        row((s, -s, 0.0), (-s, s, 0.0), big, zpos)
        row(big, big, big, (s, s, -30.0 * s))
    row(big, big, big, zpos, valid=0.0)
    row(big, big, big, zpos, valid=-1.0)
    for bad in (float("nan"), float("inf"), -float("inf")):
        for j in range(12):
            r = [0.0, 0.0, -1e6, *big, *big, *zpos]
            r[j] = bad
            row(tuple(r[0:3]), tuple(r[3:6]), tuple(r[6:9]), tuple(r[9:12]))
        row(big, big, big, zpos, valid=bad)
    return torch.tensor(rows, dtype=torch.float32)


def test_reject_is_exact_on_adversarial_rows():
    consts = _adversarial_rows()
    for H, W, y0 in ((SIZE, SIZE, 0), (33, 47, 16)):
        _check_exact(consts, H, W, y0)
    rect = kernels.tile_rects(SIZE, SIZE, "cpu")
    rej = kernels.raster_tile_reject(consts, rect)
    # A non-finite coefficient never rejects by its plane: rows whose
    # other planes are >= 0 everywhere and whose valid is finite survive
    # wherever the tile meets... nothing else rejects them.
    nonfinite = ~torch.isfinite(consts[:, :12]).all(dim=1) \
        & torch.isfinite(consts[:, 12]) & (consts[:, 12] > 0)
    first = consts[:, 2] == -1e6  # the first plane rejects everything
    assert not bool(rej[nonfinite & ~first].any())
    # valid 0, -1 or NaN rejects everywhere.
    assert bool(rej[~(consts[:, 12] > 0)].all())
    # A plane at exactly 0 on a corner keeps the tile that holds it.
    print(f"{consts.shape[0]} adversarial rows, "
          f"{float(rej.float().mean()):.3f} of pairs rejected")


def test_reject_keeps_a_row_covering_one_corner():
    """A tiny triangle around a single pixel corner is kept by the tile
    holding that corner. The cull tests one edge or plane at a time, so the
    tile beyond its apex, which no single edge separates, keeps it too;
    every other tile rejects it."""
    sx = torch.tensor([[20.9, 21.1, 21.0]])
    sy = torch.tensor([[30.9, 30.9, 31.2]])
    consts = kernels.raster_tri_constants(sx, sy, torch.full((1, 3), 0.5),
                                          torch.ones(1))
    rej = kernels.raster_tile_reject(consts,
                                     kernels.tile_rects(SIZE, SIZE, "cpu"))
    tiles_x = SIZE // kernels.TILE
    holder = (31 // kernels.TILE) * tiles_x + 21 // kernels.TILE
    beyond = holder + tiles_x  # below the apex at y = 31.2
    assert not bool(rej[0, holder]) and not bool(rej[0, beyond])
    assert int(rej[0].sum()) == rej.shape[1] - 2
    _check_exact(consts, SIZE, SIZE, 0)


@pytest.fixture(scope="module")
def mesh_case(tmp_path_factory):
    """JAX's screen vertices and constants of an 800-triangle procedural
    mesh at SIZE^2 (7 chunks of 128), the off-grid STL camera."""
    path = tmp_path_factory.mktemp("stl") / "mesh.stl"
    path.write_text(procedural_stl_text(20, 20))
    scene = jax_load_stl(str(path), use_native=False)
    cam = JaxCamera.make((0.0, -0.5, -5.0), focal=float(SIZE) + 0.23)
    cfg = JaxRenderConfig(width=SIZE, height=SIZE, mode="clean")
    sx, sy, zinv, _ = jax_screen_vertices(scene, cam, cfg)
    keep = jax_cull_mask(scene, cam, cfg.replace(frustum_cull=False))
    consts = jax_kernels.raster_tri_constants(sx, sy, zinv, keep)
    return dict(sx=sx, sy=sy, zinv=zinv, consts=consts)


@pytest.mark.parametrize("y0", [0, 16])
def test_culled_plain_winners_match_pallas(mesh_case, y0):
    """The plain K8a and K8c with each tile's rejected rows removed
    (``cull=True``) equal resolve_winner_pallas in interpret mode, for rows
    [y0, SIZE) of the frame."""
    c = mesh_case
    H = SIZE - y0
    consts = torch.tensor(np.asarray(c["consts"]))
    ys, xs = jnp.meshgrid(jnp.arange(y0, SIZE, dtype=jnp.float32),
                          jnp.arange(SIZE, dtype=jnp.float32), indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)
    want_a = np.asarray(jax_kernels.resolve_winner_pallas(
        px, py, c["consts"], tri_chunk=128))
    sv = (c["sx"], c["sy"], c["zinv"])
    want_c = np.asarray(jax_kernels.resolve_winner_pallas(
        px, py, c["consts"], tri_chunk=128, screen_verts=sv,
        image_hw=(H, SIZE)))
    np.testing.assert_array_equal(want_a, want_c)
    got_a = kernels.resolve_winner_chunked_reference(consts, H, SIZE, 128,
                                                     y0=y0, cull=True)
    sx, sy, zinv = (torch.tensor(np.asarray(a)) for a in sv)
    xmin, xmax, ymin, ymax = kernels.tile_rects(H, SIZE, "cpu")
    mask = kernels.chunk_screen_mask(sx, sy, zinv, consts[:, 12],
                                     (xmin, xmax, ymin + y0, ymax + y0), 128)
    got_c = kernels.resolve_winner_masked_reference(consts, H, SIZE, mask,
                                                    128, y0=y0, cull=True)
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    np.testing.assert_array_equal(got_c.numpy(), want_a)
    rej = kernels.raster_tile_reject(consts, (xmin, xmax, ymin + y0,
                                              ymax + y0))
    print(f"y0 {y0}: {int((want_a >= 0).sum())} covered pixels, "
          f"{float(rej.float().mean()):.4f} of (row, tile) pairs culled")
    assert (want_a >= 0).sum() > 100
    assert float(rej.float().mean()) > 0.75
    _check_exact(consts, H, SIZE, y0)
