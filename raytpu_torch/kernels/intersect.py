"""Closest hit, with and without shadow occlusion: the hard raytracer's
intersection kernels.

Counterpart of the K4-K7d parts of raytpu/kernels/intersect_pallas.py.
Per ray: the primary closest hit (last index wins ties), and for the
occluded kernels the hit position ``cam + t * d`` and the any-hit shadow
test (t < 0.99) from each shadow source toward it:

  closest_hit_occluded         K4's wrapper: one light, one chunk of
                               T <= 128 (replaces ``_fused_kernel``).
  closest_hit_occluded_multi   K6's wrapper: S sources, lights and/or the
                               jittered soft-shadow positions, light-major
                               and sample-minor, one chunk
                               (replaces ``_fused_multi_kernel``).
  closest_hit                  K5's wrapper: the closest hit streamed over
                               every chunk of 128 (replaces ``_kernel``).
  closest_hit_masked           K7d's wrapper: K5 skipping the chunks a
                               (ray tile, chunk) keep-mask rules out
                               (replaces ``_kernel_masked``).
  closest_hit_occluded_multi_masked
                               K7a's wrapper: K6 over several chunks with a
                               (ray tile, (1 + S) chunks) keep-mask
                               (replaces ``_fused_multi_kernel_masked``).
  occlusion_multi              K7b's and K7c's wrapper: the any-hit shadow
                               test of S sources toward known points, no
                               primary phase, over every chunk (K7b,
                               ``_occlusion_multi_kernel``) or the chunks a
                               (point tile, S chunks) keep-mask keeps (K7c,
                               ``_occlusion_multi_kernel_masked``): the
                               sharded renderer's occlusion of merged hits
                               (``occlusion_multi_pallas``).
  *_reference                  their plain PyTorch versions.
  shadow_reject                the plain form of K7a's exact any-hit reject
                               (a test decided "not blocked" without the
                               reciprocal); shadow_reject_probe runs the
                               card's reject beside plane_test on pairs.
  primary_tile_reject          the plain form of K5's, K7d's and K7a's
                               exact per-box triangle cull (boxes of a
                               tile's and a warp's ray directions,
                               primary_boxes); primary_cull_probe runs the
                               card's decisions beside plane_test.
  intersect_closest{,_culled}  Hits through K5 / K7d (``intersect_pallas``,
                               ``intersect_pallas_culled``).
  intersect_occluded{,_multi}  (Hits, occ bool) through K4 / K6, or K7a for
                               a multi-chunk scene given its vertices
                               (``intersect_occluded{,_multi}_pallas``).
  ClosestHit, ClosestHitOccluded
                               the torch.autograd.Functions around them.

On CUDA tensors the wrappers launch the hand-written kernels
(raytpu_torch/csrc/intersect.cu); on CPU tensors they run the plain
versions. They take the constants as one float32 table of 1 + S blocks of
10 rows by Tp columns (tables.py::constant_table; invalid triangles zeroed,
columns past T zero), the camera position and the S source positions.

The masked kernels' ray tiles are the port's own (:func:`ray_tiles`):
16 x 16 pixel blocks of an image, or runs of 256 rays of a ray list, one
CUDA block each, a tile that overhangs the image padded with its nearest
real ray as the JAX package pads. Their masks come from kernels/cull.py
for those tiles. The masks are conservative, so t, idx and occ (on hit
rays) do not depend on the tiling, and a masked kernel gives its unmasked
twin's results.

Occlusion on a miss ray is 0 in K6 and K7a, and its shadow sweeps are
skipped: that is the JAX package's contract for both. K7b and K7c know no
primary hit and test every point, as the JAX kernels do; their masks
(:func:`position_mask`) are conservative for every point. K6, K7a, K7b and
K7c decide nearly every shadow test with the exact reject
(:func:`shadow_reject`) before the plane test; K7b on one chunk sweeps a
thread a point, K7c and K7b over several chunks in the work items that
:func:`occlusion_plan` and :func:`occlusion_leaders` model
(:func:`occlusion_items_reference`). K4 sweeps every
ray, a miss with tz = 0, and returns that raw bit (a shadow ray from the
light to the camera) unmasked, as JAX's ``intersect_occluded_pallas``
does; no consumer reads it (composite zeroes misses, and the AA record
takes hits only).

The VJP is the JAX package's analytic ``_bwd``: t = k0_i / s with
s = -(d . n_i) at the winner i, so ``coef = t_bar / s`` gives
``g_dirs = coef t n_i``, ``g_m[i, 0] += coef t d`` and ``g_k0[i] += coef``.
Up to T = 1024 the per-triangle sums are one one-hot (R, T)^T @ (R, 4)
product in full float32; above, a gather and the fixed-order sums of
ops/intersect.py::sum_rows_by_index. Both add in a fixed order with no
atomics, so a step is reproducible. idx, occ, ``valid``, the shadow
constants, the source positions and the masks get no gradient.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from raytpu_torch.core.types import dot3
from raytpu_torch.kernels import _build
from raytpu_torch.kernels.cull import (
    chunk_spheres,
    keep_mask,
    position_shadow_mask,
    shadow_keep_mask,
    tile_cones,
)
from raytpu_torch.kernels.tables import (
    constant_table,
    source_table,
    tight_chunk,
)
from raytpu_torch.ops.intersect import (
    F32MAX,
    Hits,
    TriConstants,
    closest,
    gather_rows,
    intersect,
    one_hot_idx,
    plane_tests,
    sum_rows_by_index,
)
from raytpu_torch.ops.shade import SHADOW_T

# Launches of each CUDA kernel in this process, counted by its wrapper
# where it launches the kernel and nowhere else.
LAUNCHES_OCCLUDED = 0         # K4, by closest_hit_occluded
LAUNCHES_OCCLUDED_MULTI = 0   # K6, by closest_hit_occluded_multi
LAUNCHES_CLOSEST = 0          # K5, by closest_hit
LAUNCHES_CLOSEST_MASKED = 0   # K7d, by closest_hit_masked
LAUNCHES_OCCLUDED_MASKED = 0  # K7a, by closest_hit_occluded_multi_masked
LAUNCHES_OCCLUSION = 0         # K7b, by occlusion_multi without a mask
LAUNCHES_OCCLUSION_MASKED = 0  # K7c, by occlusion_multi with a mask

BLOCK_ROWS = 10  # n xyz | c2 xyz | c3 xyz | k0
TILE = 16        # the masked kernels' pixel tile side
TILE_RAYS = 256  # rays a tile: one CUDA block
# Up to this many triangles the VJP's per-triangle sums and the frame's
# attribute gather are one-hot products, above it indexing
# (``_bwd``, `raytpu/render/raytrace.py:246-260`).
ONE_HOT_MAX = 1024


def occluded_table(m, k0, valid, m_s, k0_s, tri_chunk: int) -> torch.Tensor:
    """The kernels' ((1 + S) * 10, C) table from the camera-origin
    constants (m (T, 3, 3), k0 (T,), valid (T,)) and the S sources'
    constants (m_s (S, T, 3, 3), k0_s (S, T)); C = tight_chunk(T)."""
    T = m.shape[0]
    C = tight_chunk(T, tri_chunk)
    if T > C:
        raise NotImplementedError(
            f"K4 and K6 take one chunk of {C} triangles, not {T}: a "
            "multi-chunk scene goes through K7a "
            "(closest_hit_occluded_multi_masked; ROADMAP.md section 2), as "
            "the JAX package routes it")
    return constant_table(m, k0, valid, m_s, k0_s, C)


def _block(table: torch.Tensor, b: int):
    """(m (C, 3, 3), k0 (C,)) of block b of a table."""
    rows = table[b * BLOCK_ROWS:(b + 1) * BLOCK_ROWS]
    return rows[:9].T.reshape(-1, 3, 3), rows[9]


def sweeps_reference(dirs: torch.Tensor, table: torch.Tensor,
                     cam: torch.Tensor, src: torch.Tensor, *,
                     mask_misses: bool = True):
    """Plain PyTorch version of both kernels, on any device: dirs (R, 3),
    table ((1 + S) * 10, C), cam (3,), src (S, 3). Returns (t (R,),
    idx (R,) int32, occ (S, R) int32). A miss ray's occ is 0 with
    ``mask_misses`` (K6), else the raw bit of its shadow ray from the
    camera position (K4)."""
    best_t, best_idx = closest(*plane_tests(dirs, *_block(table, 0)))
    hit = best_t < F32MAX
    tz = torch.where(hit, best_t, 0.0)
    pos = cam[None, :] + tz[:, None] * dirs
    occ = []
    for s in range(src.shape[0]):
        ts, oks = plane_tests(pos - src[s][None, :], *_block(table, 1 + s))
        bit = (oks & (ts < SHADOW_T)).any(dim=1)
        occ.append(bit & hit if mask_misses else bit)
    return (best_t, torch.where(hit, best_idx, -1),
            torch.stack(occ).to(torch.int32))


def _require(dirs, checks) -> None:
    """Raise unless each (name, tensor, dtype, shape) of ``checks`` has
    that dtype and shape, lies on dirs' device and is contiguous."""
    for name, t, dtype, shape in checks:
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if t.device != dirs.device:
            raise ValueError(f"{name} is on {t.device}, dirs on {dirs.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(dirs, table, cam, src):
    R, S = dirs.shape[0], src.shape[0]
    f32 = torch.float32
    _require(dirs, (("dirs", dirs, f32, (R, 3)),
                    ("table", table, f32, ((1 + S) * BLOCK_ROWS,
                                           table.shape[-1])),
                    ("cam", cam, f32, (3,)), ("src", src, f32, (S, 3))))
    if S < 1:
        raise ValueError("at least one shadow source is needed")


def _outputs(dirs: torch.Tensor, S: int):
    R = dirs.shape[0]
    return (torch.empty((R,), dtype=torch.float32, device=dirs.device),
            torch.empty((R,), dtype=torch.int32, device=dirs.device),
            torch.empty((S, R), dtype=torch.int32, device=dirs.device))


def launch_occluded_kernel(dirs, table, cam, light, t, idx, occ, *,
                           planar: bool = False):
    """Launch K4 on outputs the caller allocated: t (R,), idx (R,) and occ
    (R,) or (1, R); dirs (R, 3), or (3, R) with ``planar`` (lab 2's L2,
    kernels/labs.py::run_onestep). Checks nothing and counts nothing; the
    wrappers do both."""
    err = _build.load().raytpu_closest_hit_occluded(
        dirs.data_ptr(), table.data_ptr(), cam.data_ptr(), light.data_ptr(),
        table.shape[1], dirs.shape[1 if planar else 0], int(planar),
        t.data_ptr(), idx.data_ptr(), occ.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"closest_hit_occluded launch failed: CUDA error "
                           f"{err}")


# K6 stages its triangle-major copy of the sources' constants (48 bytes a
# triangle) in shared memory where it takes at most this many bytes, and
# reads it from device memory through the read-only cache above
# (csrc/intersect.cu; K7b on one chunk keeps the same rule there,
# kOccStagedBytes). On the H100 at 512^2, C = 32, staging was the faster
# at 96 KB (S = 64), where two blocks share an SM, and the slower at 144
# and 192 KB (chip_smoke.py::k6_staging_ms; times in PERF.md).
K6_STAGED_MAX_BYTES = 96 * 1024


def k6_staged(S: int, C: int) -> bool:
    """Whether K6 stages the S sources' C triangles in shared memory."""
    return 48 * S * C <= K6_STAGED_MAX_BYTES


def k6_scratch(table, src) -> torch.Tensor:
    """A fresh scratch buffer for one K6 call (uint8, on src's device): the
    triangle-major copy of the S sources' C triangles, 48 bytes each."""
    return torch.empty((48 * src.shape[0] * table.shape[1],),
                       dtype=torch.uint8, device=src.device)


def launch_occluded_multi_kernel(dirs, table, cam, src, t, idx, occ, *,
                                 scratch, staged: bool | None = None):
    """Launch K6 (and the triangle-major copy of the sources' constants it
    reads) on outputs the caller allocated: t (R,), idx (R,) and occ
    (S, R), with ``scratch`` (:func:`k6_scratch`) for the copy;
    ``staged`` None takes k6_staged's choice. Checks nothing and counts
    nothing; the wrapper does both."""
    S, C = src.shape[0], table.shape[1]
    if staged is None:
        staged = k6_staged(S, C)
    err = _build.load().raytpu_closest_hit_occluded_multi(
        dirs.data_ptr(), table.data_ptr(), cam.data_ptr(), src.data_ptr(),
        C, S, dirs.shape[0], t.data_ptr(), idx.data_ptr(), occ.data_ptr(),
        scratch.data_ptr(), scratch.numel(), int(staged),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"closest_hit_occluded_multi launch failed: CUDA "
                           f"error {err}")


def _on_cuda(dirs) -> bool:
    """True for CUDA tensors (launch), False for CPU tensors (the plain
    version); raises for any other device."""
    if dirs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no route for tensors on {dirs.device}")
    return dirs.device.type == "cuda"


def _sweeps(dirs, table, cam, src, launch, mask_misses: bool) -> tuple:
    """The sweeps of ``table`` on dirs' device: the plain version for CPU
    tensors, ``launch`` on fresh outputs for CUDA tensors."""
    if not _on_cuda(dirs):
        return sweeps_reference(dirs, table, cam, src,
                                mask_misses=mask_misses)
    _check(dirs, table, cam, src)
    out = _outputs(dirs, src.shape[0])
    with torch.cuda.device(dirs.device):
        launch(dirs, table, cam, src, *out)
    return out


def closest_hit_occluded_reference(dirs, m, k0, valid, m_l, k0_l, cam_pos,
                                   light_pos, *, tri_chunk: int = 512):
    """Plain PyTorch version of K4, on any device. dirs (R, 3); m, k0,
    valid the camera-origin constants; m_l (T, 3, 3), k0_l (T,) the
    light-origin ones; cam_pos, light_pos (3,). Returns (t (R,), idx (R,)
    int32, occ (R,) int32), occ the raw bit on a miss ray."""
    table = occluded_table(m, k0, valid, m_l[None], k0_l[None], tri_chunk)
    t, idx, occ = sweeps_reference(dirs, table, cam_pos, light_pos[None],
                                   mask_misses=False)
    return t, idx, occ[0]


def closest_hit_occluded_multi_reference(dirs, m, k0, valid, m_s, k0_s,
                                         cam_pos, src_pos, *,
                                         tri_chunk: int = 512):
    """Plain PyTorch version of K6, on any device. As
    closest_hit_occluded_reference with S sources: m_s (S, T, 3, 3),
    k0_s (S, T), src_pos (S, 3); occ is (S, R) int32, 0 on a miss ray."""
    table = occluded_table(m, k0, valid, m_s, k0_s, tri_chunk)
    return sweeps_reference(dirs, table, cam_pos, src_pos)


def closest_hit_occluded(dirs, m, k0, valid, m_l, k0_l, cam_pos, light_pos,
                         *, tri_chunk: int = 512):
    """K4's wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Arguments and result as for
    closest_hit_occluded_reference."""
    global LAUNCHES_OCCLUDED
    table = occluded_table(m, k0, valid, m_l[None], k0_l[None], tri_chunk)
    src = light_pos.reshape(1, 3).contiguous()
    t, idx, occ = _sweeps(dirs, table, cam_pos.contiguous(), src,
                          launch_occluded_kernel, mask_misses=False)
    if dirs.is_cuda:
        LAUNCHES_OCCLUDED += 1
    return t, idx, occ[0]


def closest_hit_occluded_multi(dirs, m, k0, valid, m_s, k0_s, cam_pos,
                               src_pos, *, tri_chunk: int = 512):
    """K6's wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Arguments and result as for
    closest_hit_occluded_multi_reference."""
    global LAUNCHES_OCCLUDED_MULTI
    table = occluded_table(m, k0, valid, m_s, k0_s, tri_chunk)

    def launch(*args):
        launch_occluded_multi_kernel(*args, scratch=k6_scratch(table,
                                                               src_pos))

    out = _sweeps(dirs, table, cam_pos.contiguous(), src_pos.contiguous(),
                  launch, mask_misses=True)
    if dirs.is_cuda:
        LAUNCHES_OCCLUDED_MULTI += 1
    return out


def closest_hit_vjp(dirs, m, k0, t, idx, t_bar):
    """The JAX package's ``_bwd``: cotangents (g_dirs (R, 3), g_m (T, 3, 3),
    g_k0 (T,)) of t = k0_i / -(d . n_i) at each ray's winner i. Misses add
    0 to triangle 0."""
    T = m.shape[0]
    hit = idx >= 0
    if T <= ONE_HOT_MAX:
        oh = one_hot_idx(idx, T).to(m.dtype)
        n = gather_rows(oh, m[:, 0])
    else:
        i = idx.clamp_min(0)
        n = m[i.long(), 0]
    s = -dot3(dirs, n)
    s_safe = torch.where(s.abs() > 0.0, s, 1.0)
    t_hit = torch.where(hit, t, 0.0)
    coef = torch.where(hit, t_bar / s_safe, 0.0)
    ct = (coef * t_hit)[:, None]
    # Both per-triangle sums at once; each column is its own sum.
    vals = torch.cat([coef[:, None], ct * dirs], dim=1)
    sums = (gather_rows(oh.T, vals) if T <= ONE_HOT_MAX
            else sum_rows_by_index(i, vals, T))
    g_m = m.new_zeros((T, 3, 3))
    g_m[:, 0] = sums[:, 1:]
    return ct * n, g_m, sums[:, 0]


# ---------------------------------------------------------------------------
# Several chunks: K5, K7d and K7a.


class RayTiles(NamedTuple):
    """The masked kernels' ray tiles, row-major over the tiles: th x tw
    pixel blocks (th * tw = TILE_RAYS) of an H x W grid of rays, ray
    ``y * W + x``.

    rays: (n_tiles * TILE_RAYS,) int64, the ray of each tile slot; a slot
      past the image's edge takes the nearest ray of its tile (clamped).
    tile: (R,) int64, the tile of each ray.
    """

    height: int
    width: int
    th: int
    rays: torch.Tensor
    tile: torch.Tensor

    @property
    def count(self) -> int:
        return self.rays.shape[0] // TILE_RAYS


def ray_tiles(R: int, image_hw, device) -> RayTiles:
    """Tiles of R rays: TILE x TILE pixel blocks where the rays are a
    row-major image of ``image_hw`` = (H, W) pixels, else runs of TILE_RAYS
    consecutive rays (the grid 1 x R, blocks of 1 x 256)."""
    if image_hw is None:
        H, W, th = 1, R, 1
    else:
        H, W = image_hw
        th = TILE
        if H * W != R:
            raise ValueError(f"image {H} x {W} does not hold {R} rays")
    tw = TILE_RAYS // th
    tiles_x = -(-W // tw)
    b = torch.arange(-(-H // th) * tiles_x, device=device)[:, None]
    k = torch.arange(TILE_RAYS, device=device)[None, :]
    y = ((b // tiles_x) * th + k // tw).clamp_max(H - 1)
    x = ((b % tiles_x) * tw + k % tw).clamp_max(W - 1)
    r = torch.arange(R, device=device)
    return RayTiles(H, W, th, rays=(y * W + x).reshape(-1),
                    tile=(r // W // th) * tiles_x + (r % W) // tw)


def primary_mask(origin, dirs, tiles: RayTiles, v0, v1, v2, valid,
                 chunk: int) -> torch.Tensor:
    """(n_tiles, n_chunks) int32 keep-mask of rays from ``origin``
    (kernels/cull.py::chunk_mask_for on the tiles' rays)."""
    with torch.no_grad():
        centers, radii = chunk_spheres(v0, v1, v2, valid, chunk)
        axes, cos_half = tile_cones(dirs[tiles.rays], TILE_RAYS)
        return keep_mask(origin, axes, cos_half, centers, radii)


def fused_mask(dirs, tiles: RayTiles, scene_geom, valid, src_pos, cam_pos,
               chunk: int) -> torch.Tensor:
    """(n_tiles, (1 + S) * n_chunks) int32 keep-mask of K7a: the primary
    columns, then each source's shadow columns (``_fused_masks``)."""
    with torch.no_grad():
        centers, radii = chunk_spheres(*scene_geom, valid, chunk)
        axes, cos_half = tile_cones(dirs[tiles.rays], TILE_RAYS)
        primary = keep_mask(cam_pos, axes, cos_half, centers, radii)
        shadow = shadow_keep_mask(primary, centers, radii, src_pos)
        return torch.cat([primary, shadow.reshape(tiles.count, -1)], dim=1)


def _chunk(table: torch.Tensor, b: int, c: int, C: int):
    """(m (C, 3, 3), k0 (C,)) of chunk c of block b of a table."""
    return _block(table[:, c * C:(c + 1) * C], b)


def _kept(mask, tiles: RayTiles, col: int) -> torch.Tensor:
    """The rays whose tile keeps mask column ``col``."""
    return torch.nonzero(mask[tiles.tile, col]).squeeze(1)


def closest_reference(dirs, table, C: int, cull: bool = False):
    """Plain PyTorch version of K5, on any device: the streamed
    ops/intersect.py::intersect over block 0 of table (10, Tp) in chunks of
    C. ``cull`` leaves out, for each ray, the triangles its warp's box of
    K5's tiles (runs of 256 rays) rejects (:func:`primary_tile_reject`), as
    the kernel does: the same t and idx. Returns (t (R,), idx (R,)
    int32)."""
    if cull:
        return closest_masked_reference(
            dirs, table, C, None, ray_tiles(dirs.shape[0], None, dirs.device),
            cull=True)
    m, k0 = _block(table, 0)
    hits = intersect(dirs, TriConstants(m, k0, torch.ones_like(k0)),
                     tri_chunk=C)
    return hits.t, hits.idx


def closest_masked_reference(dirs, table, C: int, mask, tiles: RayTiles,
                             cull: bool = False):
    """Plain PyTorch version of K7d, on any device: block 0 of table
    (10, Tp) chunk by chunk, each chunk on the rays whose tile keeps it
    (mask (n_tiles, Tp / C); None: every chunk). ``cull`` leaves out, for
    each ray, the triangles its warp's box rejects, as the kernel does
    (:func:`closest_reference`). Returns (t (R,), idx (R,) int32)."""
    R = dirs.shape[0]
    best_t = dirs.new_full((R,), F32MAX)
    best_idx = torch.zeros((R,), dtype=torch.int32, device=dirs.device)
    rows = torch.arange(R, device=dirs.device)
    if cull:
        lo, hi, any_, finite = primary_boxes(dirs, tiles, 32)
        warp = ray_warps(tiles)
    for c in range(table.shape[1] // C):
        if mask is not None:
            rows = _kept(mask, tiles, c)
        m, k0 = _chunk(table, 0, c, C)
        ts, oks = plane_tests(dirs[rows], m, k0)
        if cull:
            w, inv = torch.unique(warp[rows], return_inverse=True)
            oks = oks & ~primary_tile_reject(lo[w], hi[w], any_[w],
                                             finite[w], m, k0)[inv]
        t, idx = closest(ts, oks)
        bt = best_t[rows]
        upd = t <= bt  # a later chunk wins ties
        best_t[rows] = torch.where(upd, t, bt)
        best_idx[rows] = torch.where(upd, idx + c * C, best_idx[rows])
    hit = best_t < F32MAX
    return best_t, torch.where(hit, best_idx, -1)


def primary_boxes(dirs, tiles: RayTiles, group: int):
    """The boxes the closest-hit kernels cull with (csrc/intersect.cu::
    warp_box, tile_box), on any device: for each run of ``group`` slots of
    the tiles (256: a tile; 32: a warp, in the tile's slot order), over the
    slots inside the grid, (lo (n, 3), hi (n, 3)) the least and largest dx,
    dy and dz, any (n,) where the group holds such a slot and finite (n,)
    where all their directions are finite."""
    valid = _tile_slots_valid(tiles).reshape(-1, group)
    d = dirs[tiles.rays].reshape(-1, group, 3)
    inf = torch.tensor(float("inf"), dtype=dirs.dtype, device=dirs.device)
    v = valid[..., None]
    lo = torch.where(v, d, inf).amin(dim=1)
    hi = torch.where(v, d, -inf).amax(dim=1)
    finite = (torch.isfinite(d) | ~v).all(dim=2).all(dim=1)
    return lo, hi, valid.any(dim=1), finite


def ray_warps(tiles: RayTiles) -> torch.Tensor:
    """(R,) int64: the warp (tile * 8 + slot // 32) that sweeps each ray."""
    R = tiles.height * tiles.width
    r = torch.arange(R, device=tiles.rays.device)
    y, x = r // tiles.width, r % tiles.width
    tw = TILE_RAYS // tiles.th
    slot = (y % tiles.th) * tw + x % tw
    return tiles.tile * (TILE_RAYS // 32) + slot // 32


def primary_tile_reject(lo, hi, any_, finite, m, k0) -> torch.Tensor:
    """Plain form of the closest-hit kernels' exact per-box cull
    (csrc/intersect.cu::box_reject), op by op, on any device: (n, T) bool,
    True where no ray whose direction lies in box j (lo, hi (n, 3); any_,
    finite (n,), as :func:`primary_boxes` gives them) can pass
    ``plane_tests`` on triangle i (m (T, 3, 3), k0 (T,)). plane_tests'
    sums Dn = d . n, U = d . c2 and V = d . c3, each in its order of
    operations, are bounded over the box by their values at the corners
    where each product is largest or smallest (rounding to nearest is
    monotone in each operand); where Dn keeps one sign with |Dn| inside
    [REJECT_MIN_D, REJECT_MAX_D], one of :func:`shadow_reject`'s clauses
    but t < 0.99's holding at the bound holds at every ray; where both
    bounds of Dn are 0 (a zero triangle: padding, invalid), every ray's
    denominator is 0. A box of no ray rejects everything; a non-finite box
    or coefficient nothing."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=lo.device)

    def corner(row, top: bool):
        total = None
        for j in range(3):
            p = m[None, :, row, j]
            x = torch.where((p >= 0.0) == top, hi[:, j:j + 1], lo[:, j:j + 1])
            total = x * p if total is None else total + x * p
        return total

    eps = f32(REJECT_EPS)
    d_hi, d_lo = corner(0, True), corner(0, False)
    pos = (d_lo >= f32(REJECT_MIN_D)) & (d_hi <= f32(REJECT_MAX_D))
    neg = (d_hi <= -f32(REJECT_MIN_D)) & (d_lo >= -f32(REJECT_MAX_D))
    u_hi, u_lo = corner(1, True), corner(1, False)
    v_hi, v_lo = corner(2, True), corner(2, False)
    k = k0[None, :]
    uv = f32(REJECT_UV)
    rej_pos = ((u_lo > eps) | (v_lo > eps) | (k > eps)
               | (-(u_hi + v_hi) > d_hi * uv))
    rej_neg = ((u_hi < -eps) | (v_hi < -eps) | (k < -eps)
               | (u_lo + v_lo > -d_lo * uv))
    coef = (torch.isfinite(m).reshape(-1, 9).all(dim=1)
            & torch.isfinite(k0))[None, :]
    zero = (d_lo == 0.0) & (d_hi == 0.0)  # every Dn 0: nonpar is false
    cull = (finite[:, None] & coef
            & (zero | (pos & rej_pos) | (neg & rej_neg)))
    return ~any_[:, None] | cull


# K7a's exact any-hit reject (csrc/intersect.cu::shadow_reject, whose
# comment holds the rounding argument): a test is decided "not blocked"
# without the reciprocal where |D| lies in [REJECT_MIN_D, REJECT_MAX_D]
# and a sign-adjusted U, V or K lies below -REJECT_EPS, K reaches
# REJECT_T |D| or U + V exceeds REJECT_UV |D|; or where D = 0. All four
# constants are float32 values exactly.
REJECT_MIN_D, REJECT_MAX_D, REJECT_EPS = 2.0 ** -40, 2.0 ** 40, 2.0 ** -80
REJECT_T = float.fromhex("0x1.fae168p-1")  # float32(0.99) + 2^-20
REJECT_UV = 1.0 + 2.0 ** -20


def shadow_reject(delta, m, k0, below_t: bool = True) -> torch.Tensor:
    """Plain form of K7a's any-hit reject, on any device: (R, C) bool,
    True where the shadow test of ray ``delta`` (R, 3) against triangle
    (m (C, 3, 3), k0 (C,)) surely fails (``plane_tests``' ok and t < 0.99
    false), decided from D, U, V and K alone, each formed by plane_tests'
    own expressions in its order. False leaves the test to plane_tests:
    the reject never returns True for a blocking test. ``below_t`` False
    drops the t >= 0.99 clause: the closest-hit sweeps' reject
    (csrc/intersect.cu::primary_reject), True only where ok is false."""
    d = [delta[:, j:j + 1] for j in range(3)]

    def dot_rows(row):
        return (d[0] * m[None, :, row, 0] + d[1] * m[None, :, row, 1]
                + d[2] * m[None, :, row, 2])

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=delta.device)

    D = -dot_rows(0)
    flip = D < 0.0  # the kernel XORs D's sign bit into U, V and K
    Us = torch.where(flip, -dot_rows(1), dot_rows(1))
    Vs = torch.where(flip, -dot_rows(2), dot_rows(2))
    Ks = torch.where(flip, -k0[None, :], k0[None, :])
    Ds = D.abs()
    eps = f32(-REJECT_EPS)
    guard = (Ds >= f32(REJECT_MIN_D)) & (Ds <= f32(REJECT_MAX_D))
    return (D == 0.0) | (guard & ((Us < eps) | (Vs < eps) | (Ks < eps)
                                  | ((Ks >= Ds * f32(REJECT_T)) & below_t)
                                  | (Us + Vs > Ds * f32(REJECT_UV))))


def reject_edge_pairs(device="cpu"):
    """Hand-built (delta (N, 3), tri (N, 10)) pairs around each edge of the
    reject: the ray (1, 0, 0) and a triangle whose D, U, V and K are every
    combination of values at ±0, subnormal, the guard's ends and one ulp
    past them, inf and NaN, and of U, V, K at u, v, t near 0, u + v near 1
    and t near 0.99 (each ± 1 ulp) for each D. With e = (1, 0, 0) the dot
    products are n_x, c2_x and c3_x exactly (a zero's sign aside)."""
    f32 = np.float32

    def around(x):
        x = f32(x)
        return [np.nextafter(x, f32(-np.inf)), x, np.nextafter(x, f32(np.inf))]

    mags = [0.0, 1e-45, 1e-39, *around(REJECT_MIN_D), 2.0 ** -20, 0.37, 1.0,
            *around(REJECT_MAX_D), 3e38, np.inf]
    ds = np.array([v for m in mags for v in (m, -m)] + [np.nan], f32)
    fracs = np.array([0.0, -0.0, 1e-45, -1e-45, REJECT_EPS, -REJECT_EPS,
                      2.0 ** -100, -2.0 ** -100, 0.25, *around(0.5),
                      *around(1.0), *around(np.float32(0.99)), 1.5, -0.5,
                      np.inf, np.nan], f32)
    with np.errstate(all="ignore"):
        D, fu, fv, fk = np.meshgrid(ds, fracs, fracs, fracs, indexing="ij")
        D, fu, fv, fk = (a.reshape(-1) for a in (D, fu, fv, fk))
        U, V, K = (f32(f) * D for f in (fu, fv, fk))
        # u + v at 1 ± 1 ulp: V = D - U for a third of the pairs.
        V = np.where(np.arange(D.size) % 3 == 0, (D - U).astype(f32), V)
    tri = np.zeros((D.size, 10), f32)
    tri[:, 0], tri[:, 3], tri[:, 6], tri[:, 9] = -D, U, V, K
    delta = np.zeros((D.size, 3), f32)
    delta[:, 0] = 1.0
    return (torch.tensor(delta, device=device),
            torch.tensor(tri, device=device))


def reject_random_pairs(n: int, seed: int, device="cpu"):
    """n random (delta (n, 3), tri (n, 10)) pairs drawn with numpy from
    ``seed``: normal rays and constants, each pair's triangle scaled by
    2^k, k uniform in [-60, 60], so D spans the guard and both sides."""
    rng = np.random.default_rng(seed)
    delta = rng.standard_normal((n, 3)).astype(np.float32)
    tri = (rng.standard_normal((n, 10))
           * np.exp2(rng.integers(-60, 61, (n, 1)))).astype(np.float32)
    return (torch.tensor(delta, device=device),
            torch.tensor(tri, device=device))


def occluded_masked_reference(dirs, table, C: int, cam, src, mask,
                              tiles: RayTiles):
    """Plain PyTorch version of K7a, on any device: dirs (R, 3), table
    ((1 + S) * 10, Tp), cam (3,), src (S, 3), mask (n_tiles, (1 + S) *
    n_chunks). The primary sweep as closest_masked_reference, then each
    source's chunks on the hit rays whose tile keeps them. Returns (t (R,),
    idx (R,) int32, occ (S, R) int32), occ 0 on a miss."""
    n_chunks = table.shape[1] // C
    best_t, idx = closest_masked_reference(dirs, table, C,
                                           mask[:, :n_chunks], tiles)
    hit = idx >= 0
    pos = cam[None, :] + torch.where(hit, best_t, 0.0)[:, None] * dirs
    occ = torch.zeros((src.shape[0], dirs.shape[0]), dtype=torch.bool,
                      device=dirs.device)
    for s in range(src.shape[0]):
        for c in range(n_chunks):
            rows = _kept(mask, tiles, (1 + s) * n_chunks + c)
            rows = rows[hit[rows]]
            ts, oks = plane_tests(pos[rows] - src[s][None, :],
                                  *_chunk(table, 1 + s, c, C))
            occ[s, rows] |= (oks & (ts < SHADOW_T)).any(dim=1)
    return best_t, idx, occ.to(torch.int32)


def _check_chunked(dirs, table, C: int, mask, tiles) -> None:
    """The checks of K5 (mask None), K7d and K7a (their masks), beyond
    those of the sources (_check)."""
    R, Tp = dirs.shape[0], table.shape[-1]
    if not 1 <= C <= 128 or Tp % C:
        raise ValueError(f"chunk {C} must be in [1, 128] and divide {Tp}")
    checks = [("dirs", dirs, torch.float32, (R, 3)),
              ("table", table, torch.float32, (table.shape[0], Tp))]
    if mask is not None:
        if tiles.height * tiles.width != R:
            raise ValueError(f"tiles of {tiles.height} x {tiles.width} rays "
                             f"for {R} rays")
        blocks = table.shape[0] // BLOCK_ROWS
        checks.append(("mask", mask, torch.int32,
                       (tiles.count, blocks * (Tp // C))))
    _require(dirs, checks)


def _closest_grid(R: int, mask, tiles):
    """(H, W, th) of K5's tiles (runs of 256 rays) or K7d's (``tiles``)."""
    return (1, R, 1) if mask is None else (tiles.height, tiles.width,
                                           tiles.th)


@functools.lru_cache(maxsize=64)
def _closest_scratch_bytes(Tp: int, C: int, H: int, W: int, th: int,
                           masked: bool, run: int) -> int:
    """csrc/intersect.cu::raytpu_closest_hit_scratch, asked once a shape."""
    n = _build.load().raytpu_closest_hit_scratch(Tp, C, H, W, th,
                                                 int(masked), run)
    if n < 0:
        raise ValueError(f"K5/K7d take no table of {Tp} columns in chunks of "
                         f"{C} on {H} x {W} rays in runs of {run}")
    return n


def closest_scratch(dirs, table, C: int, mask, tiles,
                    run: int | None = None):
    """A fresh scratch buffer for one K5 or K7d call (uint8, on dirs'
    device), sized by the kernel's library: K7d's fold of the runs of its
    tiles (the runs' partial t and idx, 8 R bytes a run a tile of every
    chunk takes, 9 runs of 8 chunks at Tp / C = 72: 19 MB at 512^2, and a
    count a tile); None where there is none (K5)."""
    run = PRIMARY_RUN if run is None else run
    n = _closest_scratch_bytes(table.shape[1], C,
                               *_closest_grid(dirs.shape[0], mask, tiles),
                               mask is not None, run)
    return (None if n == 0
            else torch.empty((n,), dtype=torch.uint8, device=dirs.device))


def launch_closest_kernel(dirs, table, C: int, mask, tiles, t, idx, *,
                          run: int | None = None, scratch=None):
    """Launch K5 (mask None: every ray in runs of 256) or K7d (mask
    (n_tiles, n_chunks) over ``tiles``) on outputs the caller allocated:
    t (R,), idx (R,). ``run``: the most kept chunks a block of K7d sweeps,
    None PRIMARY_RUN (the same bits under any); ``scratch`` from
    :func:`closest_scratch` for the same run, None a fresh one. Checks
    nothing and counts nothing; the wrappers do both."""
    run = PRIMARY_RUN if run is None else run
    if scratch is None:
        scratch = closest_scratch(dirs, table, C, mask, tiles, run)
    H, W, th = _closest_grid(dirs.shape[0], mask, tiles)
    err = _build.load().raytpu_closest_hit(
        dirs.data_ptr(), table.data_ptr(), table.shape[1], C,
        None if mask is None else mask.data_ptr(), H, W, th, run,
        None if scratch is None else scratch.data_ptr(),
        0 if scratch is None else scratch.numel(), t.data_ptr(),
        idx.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"closest_hit launch failed: CUDA error {err}")


def primary_cull_decisions(dirs, table, tiles: RayTiles,
                           boxes: int = 1024) -> torch.Tensor:
    """The plain form of the cull's every decision, on any device: (n_tiles,
    9, Tp) bool over block 0 of ``table``, [:, 0] each tile's box, [:, 1 +
    w] its warp w's (:func:`primary_boxes`, :func:`primary_tile_reject`),
    True where culled; ``boxes`` boxes at a time."""
    m, k0 = _block(table, 0)
    out = []
    for group in (TILE_RAYS, 32):
        lo, hi, any_, finite = primary_boxes(dirs, tiles, group)
        out.append(torch.cat([
            primary_tile_reject(lo[b:b + boxes], hi[b:b + boxes],
                                any_[b:b + boxes], finite[b:b + boxes], m,
                                k0)
            for b in range(0, lo.shape[0], boxes)]))
    return torch.cat([out[0][:, None],
                      out[1].reshape(tiles.count, TILE_RAYS // 32, -1)],
                     dim=1)


def primary_cull_probe(dirs, table, tiles: RayTiles | None):
    """The closest-hit kernels' cull decided for every triangle of block 0
    of ``table`` (10, Tp) on the tiles (None: K5's runs of 256 rays) and
    their warps. Returns (dec (n_tiles, 9, Tp) bool, 1 + w the warp w's
    box, 0 the tile's, True where culled; counts (4,) int64: the culled
    (tile, triangle) and (warp, triangle) pairs, and the rays of those
    pairs that ``plane_tests`` finds ok, each 0). On CUDA tensors the card's
    decisions and plane_test (the probe kernel), on CPU tensors the plain
    forms (:func:`primary_tile_reject`)."""
    R, Tp = dirs.shape[0], table.shape[1]
    if tiles is None:
        tiles = ray_tiles(R, None, dirs.device)
    if _on_cuda(dirs):
        _require(dirs, (("dirs", dirs, torch.float32, (R, 3)),
                        ("table", table, torch.float32, (BLOCK_ROWS, Tp))))
        dec = torch.empty((tiles.count, 9, Tp), dtype=torch.uint8,
                          device=dirs.device)
        counts = torch.zeros((4,), dtype=torch.int64, device=dirs.device)
        with torch.cuda.device(dirs.device):
            err = _build.load().raytpu_primary_cull_probe(
                dirs.data_ptr(), table.data_ptr(), Tp, tiles.height,
                tiles.width, tiles.th, dec.data_ptr(), counts.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"primary_cull_probe launch failed: CUDA "
                               f"error {err}")
        return dec.bool(), counts
    m, k0 = _block(table, 0)
    dec = primary_cull_decisions(dirs, table, tiles)
    valid = _tile_slots_valid(tiles).reshape(-1)
    rays = tiles.rays[valid]
    slot = torch.nonzero(valid).squeeze(1)
    oks = plane_tests(dirs[rays], m, k0)[1]
    t_rej = dec[slot // TILE_RAYS, 0]
    w_rej = dec[slot // TILE_RAYS, 1 + slot % TILE_RAYS // 32]
    counts = torch.tensor([int(dec[:, 0].sum()), int(dec[:, 1:].sum()),
                           int((t_rej & oks).sum()),
                           int((w_rej & oks).sum())])
    return dec, counts


# K7d and K7a's primary sweep cut a tile's kept chunks into runs of at
# most PRIMARY_RUN chunks, a block each, folded in the kernel
# (csrc/intersect.cu::closest_cull_kernel): a tile of few kept chunks is
# one block, the few tiles that see a mesh at its heart spread over the
# card. K7a cuts each (tile, source)'s kept shadow chunks into SHADOW_RUNS
# // S runs (at least one). PRIMARY_RUN is measured on the H100 (PERF.md
# §6, K7d on the stl_intersect row and K7a's primary half at 500^2: runs of
# 8 are the best of both together).
PRIMARY_RUN = 8
SHADOW_RUNS = 32


def k7a_runs(S: int) -> tuple[int, int]:
    """(kept chunks a primary run holds at most, shadow runs) of K7a with S
    sources."""
    return PRIMARY_RUN, max(1, SHADOW_RUNS // S)


def k7a_scratch(dirs, table, C: int, S: int, tiles: RayTiles):
    """A fresh scratch buffer for one K7a call (uint8, on dirs' device),
    sized by the kernel's library (csrc/intersect.cu::k7a_scratch)."""
    n = _build.load().raytpu_closest_hit_occluded_masked_scratch(
        table.shape[1], C, S, tiles.height, tiles.width, tiles.th,
        k7a_runs(S)[0])
    if n < 0:
        raise ValueError(f"K7a takes no table of {table.shape[1]} columns "
                         f"in chunks of {C} on {tiles.height} x "
                         f"{tiles.width} rays")
    return torch.empty((n,), dtype=torch.uint8, device=dirs.device)


def launch_occluded_masked_kernel(dirs, table, C: int, cam, src, mask,
                                  tiles, t, idx, occ, *, scratch,
                                  phases: int = 3):
    """Launch K7a on outputs and scratch (:func:`k7a_scratch`) the caller
    allocated: t (R,), idx (R,) and occ (S, R). ``phases`` 3 runs K7a;
    1 its primary half alone (t, idx and the packed hits in ``scratch``),
    2 its shadow half alone on the hits a phase 1 left in the same scratch.
    Checks nothing and counts nothing; the wrapper does both."""
    S = src.shape[0]
    pri_run, shw_runs = k7a_runs(S)
    err = _build.load().raytpu_closest_hit_occluded_masked(
        dirs.data_ptr(), table.data_ptr(), table.shape[1], C, cam.data_ptr(),
        src.data_ptr(), S, mask.data_ptr(), tiles.height, tiles.width,
        tiles.th, t.data_ptr(), idx.data_ptr(), occ.data_ptr(),
        scratch.data_ptr(), scratch.numel(), pri_run, shw_runs, phases,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"closest_hit_occluded_masked launch failed: CUDA "
                           f"error {err}")


def shadow_reject_probe(delta, tri):
    """K7a's reject and the full any-hit test on pairs: delta (N, 3) shadow
    rays, tri (N, 10) constants [n | c2 | c3 | k0]. Returns (reject (N,),
    blocked (N,)) bool: the device reject and plane_test's verdict
    (t < 0.99) on CUDA tensors (the card's probe kernel), their plain forms
    on CPU tensors."""
    if not _on_cuda(delta):
        m, k0 = tri[:, :9].reshape(-1, 3, 3), tri[:, 9]
        reject, blocked = [], []
        for b in range(0, delta.shape[0], 256):  # each pair: a diagonal
            d, mb, kb = delta[b:b + 256], m[b:b + 256], k0[b:b + 256]
            ts, oks = plane_tests(d, mb, kb)
            reject.append(shadow_reject(d, mb, kb).diagonal())
            blocked.append((oks & (ts < SHADOW_T)).diagonal())
        empty = delta.new_zeros((0,), dtype=torch.bool)
        return torch.cat([empty, *reject]), torch.cat([empty, *blocked])
    N = delta.shape[0]
    _require(delta, (("delta", delta, torch.float32, (N, 3)),
                     ("tri", tri, torch.float32, (N, 10))))
    reject = torch.empty((N,), dtype=torch.int32, device=delta.device)
    blocked = torch.empty_like(reject)
    with torch.cuda.device(delta.device):
        err = _build.load().raytpu_shadow_reject_probe(
            delta.data_ptr(), tri.data_ptr(), N, reject.data_ptr(),
            blocked.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"shadow_reject_probe launch failed: CUDA error "
                           f"{err}")
    return reject.bool(), blocked.bool()


def primary_table(m, k0, valid, tri_chunk: int):
    """(table (10, Tp), C) of the closest-hit kernels: C = tight_chunk."""
    C = tight_chunk(m.shape[0], tri_chunk)
    return constant_table(m, k0, valid, None, None, C), C


def closest_hit_reference(dirs, m, k0, valid, *, tri_chunk: int = 512):
    """Plain PyTorch version of K5 from the camera-origin constants m
    (T, 3, 3), k0 (T,), valid (T,). Returns (t (R,), idx (R,) int32)."""
    return closest_reference(dirs, *primary_table(m, k0, valid, tri_chunk))


def closest_hit_masked_reference(dirs, m, k0, valid, mask, tiles, *,
                                 tri_chunk: int = 512):
    """Plain PyTorch version of K7d: as closest_hit_reference, skipping the
    chunks ``mask`` (n_tiles, n_chunks) rules out for each tile."""
    table, C = primary_table(m, k0, valid, tri_chunk)
    return closest_masked_reference(dirs, table, C, mask, tiles)


def closest_hit_occluded_multi_masked_reference(
        dirs, m, k0, valid, m_s, k0_s, cam_pos, src_pos, mask, tiles, *,
        tri_chunk: int = 512):
    """Plain PyTorch version of K7a: as closest_hit_occluded_multi_reference
    over any number of chunks, skipping what ``mask`` (n_tiles, (1 + S) *
    n_chunks) rules out for each tile."""
    C = tight_chunk(m.shape[0], tri_chunk)
    table = constant_table(m, k0, valid, m_s, k0_s, C)
    return occluded_masked_reference(dirs, table, C, cam_pos, src_pos, mask,
                                     tiles)


def closest_hit(dirs, m, k0, valid, *, tri_chunk: int = 512):
    """K5's wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Arguments and result as for closest_hit_reference."""
    global LAUNCHES_CLOSEST
    table, C = primary_table(m, k0, valid, tri_chunk)
    if not _on_cuda(dirs):
        return closest_reference(dirs, table, C)
    _check_chunked(dirs, table, C, None, None)
    t, idx, _ = _outputs(dirs, 0)
    with torch.cuda.device(dirs.device):
        launch_closest_kernel(dirs, table, C, None, None, t, idx)
    LAUNCHES_CLOSEST += 1
    return t, idx


def closest_hit_masked(dirs, m, k0, valid, mask, tiles, *,
                       tri_chunk: int = 512):
    """K7d's wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Arguments and result as for closest_hit_masked_reference."""
    global LAUNCHES_CLOSEST_MASKED
    table, C = primary_table(m, k0, valid, tri_chunk)
    if not _on_cuda(dirs):
        return closest_masked_reference(dirs, table, C, mask, tiles)
    _check_chunked(dirs, table, C, mask, tiles)
    t, idx, _ = _outputs(dirs, 0)
    with torch.cuda.device(dirs.device):
        launch_closest_kernel(dirs, table, C, mask, tiles, t, idx)
    LAUNCHES_CLOSEST_MASKED += 1
    return t, idx


def closest_hit_occluded_multi_masked(dirs, m, k0, valid, m_s, k0_s,
                                      cam_pos, src_pos, mask, tiles, *,
                                      tri_chunk: int = 512):
    """K7a's wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Arguments and result as for
    closest_hit_occluded_multi_masked_reference."""
    global LAUNCHES_OCCLUDED_MASKED
    C = tight_chunk(m.shape[0], tri_chunk)
    table = constant_table(m, k0, valid, m_s, k0_s, C)
    cam, src = cam_pos.contiguous(), src_pos.contiguous()
    if not _on_cuda(dirs):
        return occluded_masked_reference(dirs, table, C, cam, src, mask,
                                         tiles)
    _check(dirs, table, cam, src)
    _check_chunked(dirs, table, C, mask, tiles)
    out = _outputs(dirs, src.shape[0])
    scratch = k7a_scratch(dirs, table, C, src.shape[0], tiles)
    with torch.cuda.device(dirs.device):
        launch_occluded_masked_kernel(dirs, table, C, cam, src, mask, tiles,
                                      *out, scratch=scratch)
    LAUNCHES_OCCLUDED_MASKED += 1
    return out


# ---------------------------------------------------------------------------
# Occlusion of known points: K7b and K7c.


def position_mask(pos, tiles: RayTiles, scene_geom, valid, src_pos,
                  chunk: int) -> torch.Tensor:
    """(n_tiles, S * n_chunks) int32 keep-mask of K7c for the points pos
    (R, 3) on ``tiles``: kernels/cull.py::position_shadow_mask over the
    tiles' points (a tile's pad slots repeat a real point of it, so they
    widen no bound), chunk spheres from scene_geom = (v0, v1, v2)."""
    with torch.no_grad():
        centers, radii = chunk_spheres(*scene_geom, valid, chunk)
        keep = position_shadow_mask(pos[tiles.rays], src_pos, centers, radii,
                                    TILE_RAYS)
        return keep.reshape(tiles.count, -1).contiguous()


def occlusion_reference(pos, table, C: int, src):
    """Plain PyTorch version of K7b, on any device: pos (R, 3), table
    (S * 10, Tp), src (S, 3). Each source's chunks in turn. Returns occ
    (S, R) int32, 1 where a triangle blocks the segment at t < 0.99."""
    S, R = src.shape[0], pos.shape[0]
    occ = torch.zeros((S, R), dtype=torch.bool, device=pos.device)
    for s in range(S):
        delta = pos - src[s][None, :]
        for c in range(table.shape[1] // C):
            ts, oks = plane_tests(delta, *_chunk(table, s, c, C))
            occ[s] |= (oks & (ts < SHADOW_T)).any(dim=1)
    return occ.to(torch.int32)


def occlusion_masked_reference(pos, table, C: int, src, mask,
                               tiles: RayTiles):
    """Plain PyTorch version of K7c, on any device: as occlusion_reference,
    each (source, chunk) on the points whose tile keeps it (mask (n_tiles,
    S * n_chunks) over ``tiles``). Returns occ (S, R) int32."""
    n_chunks = table.shape[1] // C
    S, R = src.shape[0], pos.shape[0]
    occ = torch.zeros((S, R), dtype=torch.bool, device=pos.device)
    for s in range(S):
        for c in range(n_chunks):
            rows = _kept(mask, tiles, s * n_chunks + c)
            ts, oks = plane_tests(pos[rows] - src[s][None, :],
                                  *_chunk(table, s, c, C))
            occ[s, rows] |= (oks & (ts < SHADOW_T)).any(dim=1)
    return occ.to(torch.int32)


def occlusion_multi_reference(pos, m_s, k0_s, src_pos, valid, *,
                              tri_chunk: int = 512):
    """Plain PyTorch version of K7b from the S sources' constants m_s
    (S, T, 3, 3), k0_s (S, T) and valid (T,). Returns occ (S, R) int32."""
    C = tight_chunk(m_s.shape[1], tri_chunk)
    return occlusion_reference(pos, source_table(m_s, k0_s, valid, C), C,
                               src_pos)


def occlusion_multi_masked_reference(pos, m_s, k0_s, src_pos, valid, mask,
                                     tiles: RayTiles, *,
                                     tri_chunk: int = 512):
    """Plain PyTorch version of K7c: as occlusion_multi_reference, skipping
    what ``mask`` (n_tiles, S * n_chunks) rules out for each tile."""
    C = tight_chunk(m_s.shape[1], tri_chunk)
    return occlusion_masked_reference(
        pos, source_table(m_s, k0_s, valid, C), C, src_pos, mask, tiles)


# K7c and K7b over several chunks cut each (tile, source) pair's kept
# chunks (every chunk, K7b) into runs of at most occlusion_run(S) chunks, a
# work item each for each warp of the tile's points (csrc/intersect.cu::
# shadow_items_kernel); K7b on one chunk (Tp = C) takes no items. With few
# sources the few pairs need the cut to spread over the card; with many, a
# point shadowed in one run sweeping the next afresh costs more than the cut
# saves. On the H100 at 512^2 on the 9,216-triangle points (72 chunks):
# S = 1 ran fastest with runs of 8, S = 16 with no cut (PERF.md, the
# table of runs).
OCC_RUN = 8


def occlusion_run(S: int) -> int:
    """Kept chunks a K7b / K7c work item holds with S sources: OCC_RUN at
    S = 1, OCC_RUN * S above."""
    return OCC_RUN * S


def occlusion_items_route(Tp: int, C: int, mask) -> bool:
    """Whether K7b / K7c take the work items (a mask, or several chunks)
    rather than K7b's one-chunk kernel."""
    return mask is not None or Tp > C


def _occlusion_grid(R: int, mask, tiles):
    """(H, W, th) of the occlusion kernels' tiles: the mask's tiles, else
    runs of 256 consecutive points."""
    return (1, R, 1) if mask is None else (tiles.height, tiles.width,
                                           tiles.th)


@functools.lru_cache(maxsize=64)
def _occlusion_scratch_bytes(Tp: int, C: int, S: int, H: int, W: int,
                             th: int, masked: bool, run: int) -> int:
    """csrc/intersect.cu::raytpu_occlusion_points_scratch for these shapes,
    asked once a shape."""
    n = _build.load().raytpu_occlusion_points_scratch(Tp, C, S, H, W, th,
                                                      int(masked), run)
    if n < 0:
        raise ValueError(f"K7b/K7c take no table of {Tp} columns in chunks "
                         f"of {C} for {S} sources on {H} x {W} points (run "
                         f"{run})")
    return n


def occlusion_scratch(pos, table, C: int, S: int, mask, tiles,
                      run: int | None = None) -> torch.Tensor:
    """A fresh scratch buffer for one K7b or K7c call (uint8, on pos'
    device), sized by the kernel's library (csrc/intersect.cu::occ_scratch):
    the triangle-major copy of the S sources' blocks, 48 S Tp bytes (7 MB at
    S = 16, Tp = 9,216); on the items route also the plan's kept counts, 4
    n_tiles S bytes (64 KB at 512^2, S = 16), the warps' leaders, 32 n_tiles
    bytes, and 16 bytes of counters."""
    H, W, th = _occlusion_grid(pos.shape[0], mask, tiles)
    run = occlusion_run(S) if run is None else run
    n = _occlusion_scratch_bytes(table.shape[1], C, S, H, W, th,
                                 mask is not None, run)
    return torch.empty((n,), dtype=torch.uint8, device=pos.device)


def launch_occlusion_kernel(pos, table, C: int, src, mask, tiles, occ, *,
                            scratch, run: int | None = None):
    """Launch K7b (mask None: every point in runs of 256) or K7c (mask
    (n_tiles, S * n_chunks) over ``tiles``) on the (S, R) int32 output and
    the scratch (:func:`occlusion_scratch`, for the same ``run``) the caller
    allocated. ``run``: the kept chunks of an item, None occlusion_run's
    (the same bits under any run). Checks nothing and counts nothing; the
    wrapper does both."""
    S = src.shape[0]
    run = occlusion_run(S) if run is None else run
    H, W, th = _occlusion_grid(pos.shape[0], mask, tiles)
    err = _build.load().raytpu_occlusion_points(
        pos.data_ptr(), table.data_ptr(), table.shape[1], C, src.data_ptr(),
        S, None if mask is None else mask.data_ptr(), H, W, th,
        occ.data_ptr(), scratch.data_ptr(), scratch.numel(), run,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"occlusion_points launch failed: CUDA error "
                           f"{err}")


def occlusion_plan(mask, n_tiles: int, S: int, n_chunks: int,
                   run: int) -> torch.Tensor:
    """Plain model of K7b's and K7c's work items (csrc/intersect.cu::
    shadow_items_kernel), on any device: (E, 2) int64 entries (p, j), pair
    p = tile * S + s (the mask's row p of n_chunks columns; mask None:
    every chunk kept) with k kept chunks making ceil(k / run) entries, entry
    (p, j) the kept chunks of rank [j run, j run + run), in the kernel's
    order: run-major (every pair's run 0 first), then pair. Each entry is
    an item for each of the tile's 8 warps; the kernel skips the empty
    slots (j past a pair's last run) of its (max runs, pairs) grid."""
    device = "cpu" if mask is None else mask.device
    n_pairs = n_tiles * S
    if mask is None:
        kept = torch.full((n_pairs,), n_chunks, dtype=torch.long,
                          device=device)
    else:
        kept = (mask.reshape(n_pairs, n_chunks) != 0).sum(dim=1)
    j = torch.arange(-(-n_chunks // run), device=device)[:, None]
    pair = torch.arange(n_pairs, device=device)[None, :]
    live = j * run < kept[None, :]
    return torch.stack([pair.expand_as(live)[live], j.expand_as(live)[live]],
                       dim=1)


def occlusion_entry_chunks(mask, p: int, j: int, n_chunks: int,
                           run: int) -> list[int]:
    """The chunks of entry (p, j) of occlusion_plan, in order."""
    if mask is None:
        kept = list(range(n_chunks))
    else:
        row = mask.reshape(-1, n_chunks)[p]
        kept = torch.nonzero(row).squeeze(1).tolist()
    return kept[j * run:(j + 1) * run]


def _tile_slots_valid(tiles: RayTiles) -> torch.Tensor:
    """(n_tiles, TILE_RAYS) bool: the slots inside the H x W grid (the
    others repeat a real ray of their tile)."""
    tw = TILE_RAYS // tiles.th
    tiles_x = -(-tiles.width // tw)
    b = torch.arange(tiles.count, device=tiles.rays.device)[:, None]
    k = torch.arange(TILE_RAYS, device=tiles.rays.device)[None, :]
    return (((b // tiles_x) * tiles.th + k // tw < tiles.height)
            & ((b % tiles_x) * tw + k % tw < tiles.width))


def occlusion_leaders(pos, tiles: RayTiles) -> torch.Tensor:
    """Plain model of csrc/intersect.cu::occlusion_leaders_kernel, on any
    device: (n_tiles, 8) int64, each warp's leader. Warp w of a tile (slots
    32 w ...) is uniform where its first slot is inside the grid and every
    such slot's point equals that one bit for bit; a uniform warp's leader
    is the tile's first uniform warp with the same point, any other warp
    its own. K7b's and K7c's items sweep the leaders alone."""
    W = TILE_RAYS // 32
    valid = _tile_slots_valid(tiles).reshape(-1, W, 32)
    bits = pos.contiguous().view(torch.int32)[tiles.rays].reshape(
        -1, W, 32, 3)
    first = bits[:, :, :1]
    uniform = valid[:, :, 0] & ((bits == first).all(-1) | ~valid).all(-1)
    w = torch.arange(W, device=pos.device)
    same = ((first[:, :, None, 0] == first[:, None, :, 0]).all(-1)
            & uniform[:, :, None] & uniform[:, None, :]
            & (w[None, :] < w[:, None])[None])
    return torch.where(same.any(-1), same.int().argmax(-1), w[None, :])


def occlusion_items_reference(pos, table, C: int, src, mask,
                              tiles: RayTiles | None, run: int):
    """Plain model of K7b's and K7c's items route, on any device: for each
    entry of occlusion_plan, its tile's points swept over its chunks in
    order, each to its first blocker, their bits ORed into occ (S, R)
    int32, the points of a warp that follows another (occlusion_leaders)
    taking its leader's bit. mask None: every chunk, tiles of 256
    consecutive points."""
    S, R = src.shape[0], pos.shape[0]
    n_chunks = table.shape[1] // C
    if mask is None:
        tiles = ray_tiles(R, None, pos.device)
    n_tiles = tiles.count
    occ = torch.zeros((S, R), dtype=torch.bool, device=pos.device)
    lead = occlusion_leaders(pos, tiles)
    slots = tiles.rays.reshape(n_tiles, -1, 32)
    valid = _tile_slots_valid(tiles).reshape(n_tiles, -1, 32)
    led = lead == torch.arange(lead.shape[1], device=pos.device)[None, :]
    points = [torch.unique(slots[t][valid[t] & led[t][:, None]])
              for t in range(n_tiles)]
    for p, j in occlusion_plan(mask, n_tiles, S, n_chunks, run).tolist():
        rows, s = points[p // S], p % S
        sweeping = torch.ones(rows.shape[0], dtype=torch.bool,
                              device=pos.device)
        for c in occlusion_entry_chunks(mask, p, j, n_chunks, run):
            live = rows[sweeping]
            ts, oks = plane_tests(pos[live] - src[s][None, :],
                                  *_chunk(table, s, c, C))
            hit = (oks & (ts < SHADOW_T)).any(dim=1)
            occ[s, live[hit]] = True
            sweeping[torch.nonzero(sweeping).squeeze(1)[hit]] = False
    for t, w in torch.nonzero(~led).tolist():
        rows = slots[t, w][valid[t, w]]
        occ[:, rows] = occ[:, int(slots[t, lead[t, w], 0])].clone()[:, None]
    return occ.to(torch.int32)


def occlusion_multi(pos, m_s, k0_s, src_pos, valid, tri_chunk: int = 512,
                    mask=None, tiles: RayTiles | None = None) -> torch.Tensor:
    """K7b's (mask None) and K7c's wrapper: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. pos (R, 3) surface points;
    m_s (S, T, 3, 3), k0_s (S, T) the sources' constants
    (``tri_constants(scene, src_pos)``); src_pos (S, 3); valid (T,); mask
    (n_tiles, S * n_chunks) int32 over ``tiles`` (:func:`position_mask`).
    Returns occ (S, R) int32. No gradient: the inputs are read detached."""
    global LAUNCHES_OCCLUSION, LAUNCHES_OCCLUSION_MASKED
    with torch.no_grad():
        C = tight_chunk(m_s.shape[1], tri_chunk)
        table = source_table(m_s, k0_s, valid, C)
        pos, src = pos.contiguous(), src_pos.contiguous()
        if not _on_cuda(pos):
            if mask is None:
                return occlusion_reference(pos, table, C, src)
            return occlusion_masked_reference(pos, table, C, src, mask,
                                              tiles)
        S, R = src.shape[0], pos.shape[0]
        _check_chunked(pos, table, C, None, None)
        _require(pos, (("src", src, torch.float32, (S, 3)),
                       ("table", table, torch.float32,
                        (S * BLOCK_ROWS, table.shape[1]))))
        if mask is not None:
            if tiles.height * tiles.width != R:
                raise ValueError(f"tiles of {tiles.height} x {tiles.width} "
                                 f"points for {R} points")
            _require(pos, (("mask", mask, torch.int32,
                            (tiles.count, S * (table.shape[1] // C))),))
        occ = torch.empty((S, R), dtype=torch.int32, device=pos.device)
        scratch = occlusion_scratch(pos, table, C, S, mask, tiles)
        with torch.cuda.device(pos.device):
            launch_occlusion_kernel(pos, table, C, src, mask, tiles, occ,
                                    scratch=scratch)
    if mask is None:
        LAUNCHES_OCCLUSION += 1
    else:
        LAUNCHES_OCCLUSION_MASKED += 1
    return occ


class ClosestHit(torch.autograd.Function):
    """(t, idx) of ``fn`` (closest_hit, closest_hit_masked with its mask
    bound, or their plain versions), differentiable in t (counterpart of
    the custom_vjp of closest_hit{,_masked}). idx is not differentiable."""

    @staticmethod
    def forward(ctx, dirs, m, k0, valid, fn: Callable):
        t, idx = fn(dirs, m, k0, valid)
        ctx.save_for_backward(dirs, m, k0, t, idx)
        ctx.mark_non_differentiable(idx)
        return t, idx

    @staticmethod
    @once_differentiable
    def backward(ctx, t_bar, _g_idx):
        dirs, m, k0, t, idx = ctx.saved_tensors
        g_dirs, g_m, g_k0 = closest_hit_vjp(dirs, m, k0, t, idx, t_bar)
        return g_dirs, g_m, g_k0, None, None


class ClosestHitOccluded(torch.autograd.Function):
    """(t, idx, occ) of ``fn`` (closest_hit_occluded{,_multi} or their plain
    versions), differentiable in t (counterpart of the custom_vjp of
    closest_hit_occluded{,_multi}). idx and occ are not differentiable."""

    @staticmethod
    def forward(ctx, dirs, m, k0, valid, m_s, k0_s, cam_pos, src_pos,
                fn: Callable, tri_chunk: int):
        t, idx, occ = fn(dirs, m, k0, valid, m_s, k0_s, cam_pos, src_pos,
                         tri_chunk=tri_chunk)
        ctx.save_for_backward(dirs, m, k0, t, idx)
        ctx.mark_non_differentiable(idx, occ)
        return t, idx, occ

    @staticmethod
    @once_differentiable
    def backward(ctx, t_bar, _g_idx, _g_occ):
        dirs, m, k0, t, idx = ctx.saved_tensors
        g_dirs, g_m, g_k0 = closest_hit_vjp(dirs, m, k0, t, idx, t_bar)
        return g_dirs, g_m, g_k0, None, None, None, None, None, None, None


def _hits(t: torch.Tensor, idx: torch.Tensor) -> Hits:
    return Hits(t=t, idx=idx, hit=t < F32MAX)


def intersect_occluded(dirs: torch.Tensor, consts: TriConstants,
                       consts_light: TriConstants, cam_pos: torch.Tensor,
                       light_pos: torch.Tensor, *, tri_chunk: int = 512):
    """Primary intersect and hard-shadow occlusion toward one light through
    K4 (``intersect_occluded_pallas``). Returns (Hits, occ (R,) bool)."""
    t, idx, occ = ClosestHitOccluded.apply(
        dirs, consts.m, consts.k0, consts.valid, consts_light.m,
        consts_light.k0, cam_pos, light_pos, closest_hit_occluded, tri_chunk)
    return _hits(t, idx), occ.bool()


def intersect_closest(dirs: torch.Tensor, consts: TriConstants, *,
                      tri_chunk: int = 512) -> Hits:
    """Closest hit of every ray against every chunk through K5
    (``intersect_pallas``)."""
    t, idx = ClosestHit.apply(
        dirs, consts.m, consts.k0, consts.valid,
        functools.partial(closest_hit, tri_chunk=tri_chunk))
    return _hits(t, idx)


def intersect_closest_culled(dirs: torch.Tensor, consts: TriConstants,
                             origin: torch.Tensor, v0, v1, v2, *,
                             tri_chunk: int = 512,
                             image_hw: tuple | None = None) -> Hits:
    """Chunk-culled closest hit of rays from ``origin`` through K7d
    (``intersect_pallas_culled``): v0, v1, v2 are the scene's vertices in
    the constants' order; image_hw = (H, W) where the rays are a row-major
    pixel grid (pixel tiles cull far more than runs of rays). The same
    Hits as intersect_closest."""
    tiles = ray_tiles(dirs.shape[0], image_hw, dirs.device)
    mask = primary_mask(origin, dirs, tiles, v0, v1, v2, consts.valid,
                        tight_chunk(consts.m.shape[0], tri_chunk))
    t, idx = ClosestHit.apply(
        dirs, consts.m, consts.k0, consts.valid,
        functools.partial(closest_hit_masked, mask=mask, tiles=tiles,
                          tri_chunk=tri_chunk))
    return _hits(t, idx)


def intersect_occluded_multi(dirs: torch.Tensor, consts: TriConstants,
                             consts_src: TriConstants, cam_pos: torch.Tensor,
                             src_pos: torch.Tensor, *, tri_chunk: int = 512,
                             scene_geom: tuple | None = None,
                             image_hw: tuple | None = None):
    """Primary intersect and occlusion toward S sources
    (``intersect_occluded_multi_pallas``): through K6 for one chunk, and
    through K7a with its keep-mask for several where ``scene_geom`` =
    (v0, v1, v2) gives the scene's vertices (image_hw as for
    intersect_closest_culled). consts_src holds batched constants, m
    (S, T, 3, 3) and k0 (S, T), from ``tri_constants(scene, src_pos)``.
    Returns (Hits, occ (S, R) bool), occ False on a miss."""
    T = consts.m.shape[0]
    C = tight_chunk(T, tri_chunk)
    fn = closest_hit_occluded_multi
    if scene_geom is not None and T > C:
        tiles = ray_tiles(dirs.shape[0], image_hw, dirs.device)
        mask = fused_mask(dirs, tiles, scene_geom, consts.valid, src_pos,
                          cam_pos, C)
        fn = functools.partial(closest_hit_occluded_multi_masked, mask=mask,
                               tiles=tiles)
    t, idx, occ = ClosestHitOccluded.apply(
        dirs, consts.m, consts.k0, consts.valid, consts_src.m, consts_src.k0,
        cam_pos, src_pos, fn, tri_chunk)
    return _hits(t, idx), occ.bool()
