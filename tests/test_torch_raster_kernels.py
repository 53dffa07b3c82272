"""The hard rasterizer's winner search (raytpu_torch.kernels.raster)
against the JAX package's ``raster_pallas`` (Pallas in interpret mode).

On the CPU the port's wrappers run their plain versions; the CUDA kernels
K8b and K8c are held to those on the card (tests/test_torch_gpu.py,
chip_smoke.py). Cases, all at the off-grid camera of
tests/test_raster_kernel.py: the Cornell box as one chunk (K8b), the same
box in chunks of 16 (several chunks with the mask, K8c), and a small
procedural STL mesh of 800 triangles (7 chunks of 128, with
``screen_verts``, as rasterize_exact calls it).

The constants are held to JAX's within a few float32 ulps (PyTorch's CPU
sqrt and XLA:CPU's fused products round differently, ROADMAP fault F4);
the winners are compared twice: from the same constants (must be
identical) and from each package's own constants (winner flips counted
and required to be 0 at these sizes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.stl import load_stl as jax_load_stl
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.kernels import raster_pallas as jax_kernels
from raytpu.ops.raster import cull_mask as jax_cull_mask
from raytpu.render.soft import _screen_vertices as jax_screen_vertices

from raytpu_torch import convert
from raytpu_torch.core.stl import procedural_stl_text
from raytpu_torch.kernels import raster as kernels
from raytpu_torch.ops.raster import cull_mask
from raytpu_torch.render.soft import _screen_vertices

SIZE = 64
# JAX's masked path needs whole tiles: 64^2 = two 2048-pixel tiles.
TILE_P = 2048


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def small_stl(tmp_path_factory):
    path = tmp_path_factory.mktemp("stl") / "small.stl"
    path.write_text(procedural_stl_text(20, 20))  # 800 triangles
    return str(path)


def _inputs(name, small_stl=None):
    """Both packages' screen vertices, keep-masks and constants for a
    case: (jax dict, port dict, tri_chunk)."""
    if name == "stl":
        scene = jax_load_stl(small_stl, use_native=False)
        cam = JaxCamera.make((0.0, -0.5, -5.0), focal=float(SIZE) + 0.23)
        chunk = 128
    else:
        scene = jax_cornell_box()
        cam = JaxCamera.make((0.011, -0.007, -3.013),
                             focal=float(SIZE) + 0.23, y_scale=1.01,
                             dof_focus=1.9)
        chunk = 128 if name == "cornell" else 16
    cfg = JaxRenderConfig(width=SIZE, height=SIZE, mode="clean")
    sx, sy, zinv, _ = jax_screen_vertices(scene, cam, cfg)
    keep = jax_cull_mask(scene, cam, cfg.replace(frustum_cull=False))
    want = dict(sx=sx, sy=sy, zinv=zinv, keep=keep,
                consts=jax_kernels.raster_tri_constants(sx, sy, zinv, keep))
    s = convert.scene_from_numpy(leaves(scene), device="cpu")
    c = convert.camera_from_numpy(leaves(cam), device="cpu")
    from raytpu_torch.core.types import RenderConfig
    pcfg = RenderConfig(width=SIZE, height=SIZE, mode="clean")
    psx, psy, pzinv, _ = _screen_vertices(s, c, pcfg)
    pkeep = cull_mask(s, c, pcfg.replace(frustum_cull=False))
    got = dict(sx=psx, sy=psy, zinv=pzinv, keep=pkeep,
               consts=kernels.raster_tri_constants(psx, psy, pzinv, pkeep))
    return want, got, chunk


def _pixels():
    ys, xs = jnp.meshgrid(jnp.arange(SIZE, dtype=jnp.float32),
                          jnp.arange(SIZE, dtype=jnp.float32), indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def _pixel_rects(px, py, tile_p):
    """The rectangles of the JAX package's tiles: runs of ``tile_p``
    pixels in its (swizzled) order."""
    pxt, pyt = px.reshape(-1, tile_p), py.reshape(-1, tile_p)
    return (pxt.min(dim=1).values, pxt.max(dim=1).values,
            pyt.min(dim=1).values, pyt.max(dim=1).values)


def _ulps(got, want):
    g = got.numpy().view(np.int32).astype(np.int64)
    w = np.asarray(want).view(np.int32).astype(np.int64)
    return int(np.abs(g - w).max())


CASES = ["cornell", "chunked", "stl"]


@pytest.mark.parametrize("name", CASES)
def test_constants_match_jax(name, small_stl):
    want, got, _ = _inputs(name, small_stl)
    np.testing.assert_array_equal(got["keep"].numpy(),
                                  np.asarray(want["keep"]))
    for key in ("sx", "sy", "zinv"):
        assert _ulps(got[key], want[key]) <= 2, key
    # The constants of the kept triangles: edges and plane within 8 ulps
    # (measured at most 4); the valid column exactly.
    consts, wconsts = got["consts"], np.asarray(want["consts"])
    np.testing.assert_array_equal(consts[:, 12].numpy(), wconsts[:, 12])
    live = wconsts[:, 12] > 0
    ulps = _ulps(consts[live], wconsts[live])
    print(f"{name}: {int(live.sum())} valid of {live.size}; constants "
          f"within {ulps} ulps")
    assert ulps <= 8


@pytest.mark.parametrize("name", CASES)
def test_winners_match_pallas(name, small_stl):
    """The plain winner (resolve_winner on CPU tensors) against
    resolve_winner_pallas in interpret mode, dispatched as
    rasterize_exact dispatches it."""
    want, got, chunk = _inputs(name, small_stl)
    px, py = _pixels()
    jax_sv = (want["sx"], want["sy"], want["zinv"])
    w_idx = np.asarray(jax_kernels.resolve_winner_pallas(
        px, py, want["consts"], tri_chunk=chunk, screen_verts=jax_sv,
        image_hw=(SIZE, SIZE)))
    before = (kernels.LAUNCHES_WINNER, kernels.LAUNCHES_WINNER_MASKED)
    same = kernels.resolve_winner(
        _t(want["consts"]), SIZE, SIZE, tri_chunk=chunk,
        screen_verts=tuple(_t(a) for a in jax_sv))
    own = kernels.resolve_winner(
        got["consts"], SIZE, SIZE, tri_chunk=chunk,
        screen_verts=(got["sx"], got["sy"], got["zinv"]))
    assert (kernels.LAUNCHES_WINNER,
            kernels.LAUNCHES_WINNER_MASKED) == before  # CPU: plain versions
    flips = int((own.numpy() != w_idx).sum())
    hits = int((w_idx >= 0).sum())
    print(f"{name}: {hits} covered of {w_idx.size}, winner flips from own "
          f"constants {flips}")
    np.testing.assert_array_equal(same.numpy(), w_idx)
    assert flips == 0
    assert hits > 0 and np.unique(w_idx).size >= 10
    assert same.dtype == torch.int32


def test_stl_mask_matches_jax_at_its_tiles(small_stl):
    """chunk_screen_mask over the JAX package's own tiles (its swizzled
    32 x 64 pixel blocks) is JAX's mask exactly; over K8c's 16 x 16 tiles
    it keeps fewer pairs, and the masked plain version's winners equal
    the unmasked search's."""
    from raytpu.kernels.intersect_pallas import _swizzle, _tile_shape
    want, got, chunk = _inputs("stl", small_stl)
    px, py = _pixels()
    th, tw = _tile_shape((SIZE, SIZE), TILE_P)
    spx, spy = _swizzle(px, SIZE, SIZE, th, tw), _swizzle(py, SIZE, SIZE,
                                                           th, tw)
    w_mask = np.asarray(jax_kernels.chunk_screen_mask(
        want["sx"], want["sy"], want["zinv"], want["consts"][:, 12], spx,
        spy, TILE_P, chunk))
    mask = kernels.chunk_screen_mask(
        _t(want["sx"]), _t(want["sy"]), _t(want["zinv"]),
        _t(want["consts"])[:, 12], _pixel_rects(_t(spx), _t(spy), TILE_P),
        chunk)
    np.testing.assert_array_equal(mask.numpy(), w_mask)
    consts = got["consts"]
    tiles = kernels.chunk_screen_mask(
        got["sx"], got["sy"], got["zinv"], consts[:, 12],
        kernels.tile_rects(SIZE, SIZE, "cpu"), chunk)
    assert tiles.shape == (16, 7) and tiles.dtype == torch.int32
    print(f"keep rate: JAX tiles {w_mask.mean():.3f}, 16 x 16 tiles "
          f"{float(tiles.float().mean()):.3f}")
    assert 0.0 < float(tiles.float().mean()) < 1.0
    masked = kernels.resolve_winner_masked_reference(consts, SIZE, SIZE,
                                                     tiles, chunk)
    ones = kernels.resolve_winner_masked_reference(
        consts, SIZE, SIZE, torch.ones_like(tiles), chunk)
    assert torch.equal(masked, ones)
    assert int((ones >= 0).sum()) > 0


def test_behind_camera_triangle_keeps_its_chunk():
    """A triangle with a vertex at zinv <= 0 keeps its chunk for every
    tile, however far off screen its projection lies."""
    sx = torch.tensor([[1e4, 1e4 + 1, 1e4], [5.0, 6.0, 5.0]])
    sy = torch.tensor([[1e4, 1e4, 1e4 + 1], [5.0, 5.0, 6.0]])
    zinv = torch.tensor([[0.5, -0.5, 0.5], [0.5, 0.5, 0.5]])
    valid = torch.ones(2)
    rects = kernels.tile_rects(64, 64, "cpu")
    mask = kernels.chunk_screen_mask(sx, sy, zinv, valid, rects, 1)
    assert mask[:, 0].all() and mask[0, 1] == 1 and not mask[:, 1].all()
    mask = kernels.chunk_screen_mask(sx, sy, zinv.abs(), valid, rects, 1)
    assert not mask[:, 0].any()


def test_wrappers_check_their_inputs():
    consts = torch.zeros((200, 16))
    assert torch.equal(kernels.raster_winner(consts[:30], 4, 4),
                       torch.full((16,), -1, dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels._check(consts, 4, 4)  # K8b takes one chunk
    with pytest.raises(ValueError):
        kernels._check(consts[:, :12], 4, 4)
    mask = torch.ones((1, 2), dtype=torch.int32)
    kernels._check(consts, 4, 4, mask, 128)
    with pytest.raises(ValueError):
        kernels._check(consts, 4, 4, mask, 256)
    with pytest.raises(ValueError):
        kernels._check(consts, 4, 4, mask.long(), 128)
    with pytest.raises(ValueError):
        kernels._check(consts, 20, 4, mask, 128)  # two tile rows
    # Several chunks without screen_verts: K8a (its plain version here).
    assert torch.equal(kernels.resolve_winner(consts, 4, 4),
                       torch.full((16,), -1, dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels._check(consts, 4, 4, None, 256)  # K8a's chunk
    with pytest.raises(ValueError):
        kernels.raster_winner(consts.to("meta"), 4, 4)
