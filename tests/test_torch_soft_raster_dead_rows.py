"""K9a's and K9b's dead-row skip on the CPU: the plain form.

The redesigned soft raster forward (csrc/soft_raster.cu) bounds, for every
16 x 16 pixel tile and every staged row of the (Tp, 32) table, the row's
logit over the whole tile: ``B = (zb + cap) + log(valid + 1e-20)``, zb >=
zs * zpx for any barycentrics of the row, cap = es times minus a lower
bound of the distance the kernel computes at any pixel of the tile where
one edge is below 0 at all of them, else 0. Where B lies more than 110
below the tile's smallest running max, the row's weight is exactly 0 at
every pixel and it is no pixel's max, so the kernel skips it. The plain
form is kernels/soft_raster.py::soft_row_dead, in the kernel's order of
operations. These tests hold it, on JAX's own logit (``_chunk_terms``) and
the port's, to never call dead a row with a weight not 0 at some pixel of
its tile (the mesh's rows, random rows, slivers, degenerate and padding
rows), to leave non-finite and untame rows alone, and the plain forward
with the dead rows removed to the plain forward, bit for bit, and to JAX's
``soft_raster_pallas`` forward (interpret mode) within the port's
tolerance.

Torch runs on one thread (a module fixture): under the suite's workers the
intra-op pool oversubscribes the cores.
"""

import math
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.kernels import soft_raster_pallas as jax_sr

from raytpu_torch.core.stl import load_stl, procedural_stl_text
from raytpu_torch.core.types import Camera, RenderConfig
from raytpu_torch.kernels import soft_raster as sr
from raytpu_torch.render.soft import rasterize_soft_inputs

SIZE = 64
ES = ZS = 40.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_logit(cs, coords, es=ES, zs=ZS):
    """JAX's float32 logit of every (row, pixel) pair (XLA on the CPU)."""
    c = coords.numpy()
    logit, _ = jax_sr._chunk_terms(
        jnp.asarray(cs.numpy()), jnp.zeros((1, 16), jnp.float32),
        jnp.zeros((1, 8), jnp.float32), jnp.asarray(c[0:1]),
        jnp.asarray(c[1:2]), es=es, zs=zs, ambient=0.0, capacity=1)
    return torch.tensor(np.asarray(logit))


def _torus_frame(pos, focal):
    """The 384-triangle torus (16 x 12 quads, 12 chunks of 32) at 64^2
    through a camera at pos, sharpness 40 / 40, with its soft_keep_mask."""
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/torus.stl"
        with open(path, "w") as f:
            f.write(procedural_stl_text(16, 12))
        scene = load_stl(path, device="cpu")
    camera = Camera.make(pos, focal=focal, y_scale=1.01, device="cpu")
    cfg = RenderConfig(width=SIZE, height=SIZE, mode="soft",
                       soft_edge_sharpness=ES, soft_z_sharpness=ZS)
    with torch.no_grad():
        inp = rasterize_soft_inputs(scene, camera, cfg)
    return dict(consts=inp.consts.contiguous(), chunk=inp.chunk,
                mask=inp.mask)


@pytest.fixture(scope="module")
def frame():
    """The torus through the camera (0, 0, -3) at focal 64."""
    return _torus_frame((0.0, 0.0, -3.0), float(SIZE))


def _tile_floors(m, tile, n_tiles):
    return torch.full((n_tiles,), math.inf).scatter_reduce(0, tile, m, "amin")


def _check_dead(cs, dead, logit, tile, floor):
    """No row called dead for a tile has, at a pixel of the tile, a weight
    exp(logit - floor) that is not 0 or a logit not below the floor.
    logit (C, P), dead (C, n_tiles)."""
    d = dead[:, tile]
    f = floor[tile][None, :]
    wrong = d & ((torch.exp(logit - f) != 0.0) | ~(logit < f))
    assert not bool(wrong.any()), f"{int(wrong.sum())} live pairs called dead"


def test_dead_rows_have_jax_weight_zero(frame):
    """On the torus, at the floors of the frame's saved max m (each tile's
    smallest: the largest floor a tile reaches) and at 0 (the first
    chunk's), no dead row has a JAX weight that is not 0 at any pixel of
    its tile; a large share of the (block, row) pairs is dead."""
    c = frame
    coords = sr.pixel_coords(SIZE, SIZE, "cpu")
    tile, rect = sr.tile_layout(SIZE, SIZE, "cpu")
    n_tiles = rect[0].shape[0]
    logit = _jax_logit(c["consts"], coords)
    _, m, _ = sr.soft_agg_reference(c["consts"], coords, None, ES, ZS,
                                    c["chunk"])
    shares = []
    for floor in (_tile_floors(m, tile, n_tiles), torch.zeros(n_tiles)):
        dead = sr.soft_row_dead(c["consts"], rect, ES, ZS, floor)
        _check_dead(c["consts"], dead, logit, tile, floor)
        shares.append(float(dead.float().mean()))
    print(f"dead (block, row) pairs: at the saved max's floors "
          f"{shares[0]:.4f}, at 0 {shares[1]:.4f}")
    assert shares[0] >= shares[1] > 0.5


@pytest.mark.parametrize("masked", [False, True], ids=["k9a", "k9b"])
@pytest.mark.parametrize("y0", [0, 24])
def test_dropping_dead_rows_changes_no_bit(frame, masked, y0):
    """The plain forward that leaves out each tile's dead rows at its
    running floor, as the kernels do, equals the plain forward bit for bit
    (agg, m and s), with and without the keep-mask and on rows [y0, 64) of
    the frame."""
    c = frame
    H = SIZE - y0
    coords = sr.pixel_coords(H, SIZE, "cpu", y0=y0)
    pix = None
    if masked:
        from raytpu_torch.kernels.raster import tile_rects
        xmin, xmax, ymin, ymax = tile_rects(H, SIZE, "cpu")
        mask = sr.soft_keep_mask((xmin, xmax, ymin + y0, ymax + y0),
                                 c["consts"], ES, ZS, c["chunk"])
        assert 0.0 < float(mask.float().mean()) < 1.0
        pix = sr.expand_mask(mask, H, SIZE)
    want = sr.soft_agg_reference(c["consts"], coords, pix, ES, ZS,
                                 c["chunk"])
    stats = {}
    got = sr.soft_agg_reference(c["consts"], coords, pix, ES, ZS, c["chunk"],
                                dead_rows=sr.tile_layout(H, SIZE, "cpu", y0),
                                stats=stats)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    print(f"masked {masked}, y0 {y0}: {stats['dead']} of {stats['rows']} "
          f"(block, row) pairs dead, {stats['live_pairs']} live pairs")
    assert 0 < stats["dead"] < stats["rows"]
    assert stats["live_pairs"] > 0


def test_forward_without_dead_rows_matches_jax():
    """The plain forward with the dead rows removed against JAX's
    soft_raster_pallas forward (interpret mode, no mask, its 1,024-pixel
    tiles) on the same table, within rtol 1e-5 / atol 1e-6, the tolerance
    tests/test_torch_soft_kernels.py holds the plain forward to: the Cornell
    box padded to 32 in chunks of 8 at 64^2, sharpness 60 / 60, through
    that file's camera off the pixel grid (where an edge runs exactly
    through pixels, XLA:CPU's fused products and the port's unfused ones
    pick different sides of the kink, ROADMAP fault F4)."""
    from raytpu_torch.core.cornell import cornell_box
    from raytpu_torch.render.soft import _screen_vertices
    es = zs = 60.0
    scene = cornell_box(pad_to=32, device="cpu")
    camera = Camera.make((0.011, -0.007, -3.013), focal=SIZE + 0.23,
                         y_scale=1.01, dof_focus=1.9, device="cpu")
    cfg = RenderConfig(width=SIZE, height=SIZE, mode="soft")
    sx, sy, zinv, pos3d = _screen_vertices(scene, camera, cfg)
    consts = sr.soft_tri_constants(sx, sy, zinv, pos3d, scene.color,
                                   scene.normals(), scene.active).contiguous()
    coords = sr.pixel_coords(SIZE, SIZE, "cpu")
    stats = {}
    agg, m, s = sr.soft_agg_reference(
        consts, coords, None, es, zs, 8,
        dead_rows=sr.tile_layout(SIZE, SIZE, "cpu"), stats=stats)
    jagg, jm, js = jax_sr._soft_agg_fwd_impl(
        jnp.asarray(consts.numpy()), jnp.zeros((1, 16), jnp.float32),
        jnp.zeros((1, 8), jnp.float32), jnp.asarray(coords.numpy()), None,
        es, zs, 0.0, 1, 1024, 8, interpret=True)
    np.testing.assert_allclose(agg.numpy(), np.asarray(jagg), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm)[0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(js)[0], rtol=1e-5,
                               atol=1e-6)
    print(f"Cornell: {stats['dead']} of {stats['rows']} (block, row) pairs "
          f"dead")
    assert 0 < stats["dead"] < stats["rows"]
    assert float((agg[6] > 1e-3).float().mean()) > 0.1  # the box in view


def _random_rows(n, seed):
    """Soft-table rows of random screen triangles over and around a 64^2
    image, most a few pixels wide, some slivers (a vertex pulled onto the
    opposite edge), needles (one long edge, near-zero width), collinear
    (area 0, valid 0) and all-zero padding rows."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-20.0, 84.0, (n, 1, 2))
    v = c + rng.normal(0.0, 4.0, (n, 3, 2))
    kind = rng.integers(0, 5, n)
    t = rng.uniform(0.2, 0.8, n)
    for i in np.nonzero(kind == 1)[0]:  # sliver
        v[i, 2] = v[i, 0] + t[i] * (v[i, 1] - v[i, 0]) + 1e-3
    for i in np.nonzero(kind == 2)[0]:  # needle
        d = rng.normal(size=2)
        v[i, 1] = v[i, 0] + 60.0 * d
        v[i, 2] = v[i, 0] + 60.0 * d * 0.999 + 1e-4
    for i in np.nonzero(kind == 3)[0]:  # collinear
        v[i, 2] = v[i, 0] + 2.0 * (v[i, 1] - v[i, 0])
    v[kind == 4] = 0.0  # padding
    sx = torch.tensor(v[..., 0], dtype=torch.float32)
    sy = torch.tensor(v[..., 1], dtype=torch.float32)
    zinv = torch.tensor(rng.uniform(0.1, 0.6, (n, 3)), dtype=torch.float32)
    pos3d = torch.tensor(rng.normal(size=(n, 3, 3)), dtype=torch.float32)
    color = torch.tensor(rng.uniform(size=(n, 3)), dtype=torch.float32)
    normal = torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32)
    keep = torch.tensor((kind != 4).astype(np.float32))
    return sr.soft_tri_constants(sx, sy, zinv, pos3d, color, normal, keep)


@pytest.mark.parametrize("es,zs", [(ES, ZS), (10.0, 20.0), (200.0, 1.0)])
def test_dead_rows_have_weight_zero_on_random_rows(es, zs):
    """Random rows, slivers, needles, collinear and padding rows at random
    floors: every pixel of every tile enumerated with the port's logit
    (chunk_terms) and JAX's."""
    cs = _random_rows(480, seed=int(es + zs))
    coords = sr.pixel_coords(SIZE, SIZE, "cpu")
    tile, rect = sr.tile_layout(SIZE, SIZE, "cpu")
    n_tiles = rect[0].shape[0]
    logit, _ = sr.chunk_terms(cs, coords[0], coords[1], es, zs)
    jlogit = _jax_logit(cs, coords, es, zs)
    rng = np.random.default_rng(5)
    shares = []
    for floor in (torch.zeros(n_tiles),
                  torch.tensor(rng.uniform(0.0, 30.0, n_tiles),
                               dtype=torch.float32)):
        dead = sr.soft_row_dead(cs, rect, es, zs, floor)
        _check_dead(cs, dead, logit, tile, floor)
        _check_dead(cs, dead, jlogit, tile, floor)
        shares.append(float(dead.float().mean()))
    print(f"es {es}, zs {zs}: dead shares {shares}")
    assert shares[1] > 0.2


@pytest.mark.parametrize("col,value", [(0, float("nan")), (3, float("inf")),
                                       (12, -float("inf")), (20, 2.0 ** 41),
                                       (28, -1e-20)])
def test_non_finite_and_untame_rows_are_never_dead(col, value):
    """A row with a used column not finite or beyond 2^40, or with valid +
    1e-20 = 0, is never dead, however high the floor."""
    cs = _random_rows(64, seed=3)
    cs[:, col] = value
    _, rect = sr.tile_layout(SIZE, SIZE, "cpu")
    floor = torch.full((rect[0].shape[0],), 1e6)
    assert not bool(sr.soft_row_dead(cs, rect, ES, ZS, floor).any())
    fine = _random_rows(64, seed=3)
    assert bool(sr.soft_row_dead(fine, rect, ES, ZS, floor).all())


def test_sharpness_out_of_range_is_never_dead_by_distance():
    """es not positive takes no credit for distance (cap 0), and es or zs
    not finite or beyond 2^40 marks nothing dead."""
    cs = _random_rows(96, seed=11)
    _, rect = sr.tile_layout(SIZE, SIZE, "cpu")
    floor = torch.zeros(rect[0].shape[0])
    zb_only = sr.soft_row_dead(cs, rect, -ES, ZS, floor)
    valid = cs[:, 28:29] > 0
    assert not bool((zb_only & valid).any())  # valid rows need distance
    for es, zs in ((float("nan"), ZS), (ES, float("inf")), (2.0 ** 41, ZS)):
        assert not bool(sr.soft_row_dead(cs, rect, es, zs,
                                         floor + 1e6).any())
