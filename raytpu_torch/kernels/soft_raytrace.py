"""The soft (differentiable) raytracer's kernels (counterpart of
raytpu/kernels/soft_raytrace_pallas.py).

Primary: per ray, a softmax over every triangle's logit
``zs * zinv + log_sigmoid(es * margin) + log(active + 1e-20)`` and a
background hypothesis (logit 0, black at infinity) aggregates 9 attribute
channels [albedo rgb, hit position xyz, normal xyz]; zinv is
``1 / max(t |d|, dmin, 0.1)`` and behind-camera or near-parallel pairs are
gated to weight 0. Shadow: per (source, point), the optical depth
``od = sum cov * occ_z`` over every triangle and ``T = exp(-16 od)``. The
triangles come as the (Tp, 32) and (Tp, 16) tables of
``primary_tri_constants`` and ``shadow_tri_constants`` in chunks of
``chunk`` <= 32 rows; both forwards keep JAX's chunk-by-chunk order (the
primary's online softmax: a chunk's max, one rescale of the carry, then the
chunk's sums).

  primary_agg_fwd   K10a's wrapper (K10b's with a mask): out (9, R), m, s.
  primary_agg_bwd   K10c's (K10d's): d consts, d camera position, d dirs
                    from the saved m and the 10 cotangent rows of
                    ``primary_cot``; above JAX's fused limit
                    (``pri_two_launch``) the two-launch route, K10e's
                    ``primary_bwd_tables`` (d consts, d camera position)
                    and K10f's ``primary_bwd_dirs`` (d dirs).
  shadow_trans_fwd  K10g's (K10h's): trans (S, R).
  shadow_trans_bwd  K10i's (K10j's): d consts, d sources, d world points;
                    above JAX's limit (``shw_two_launch``), K10k's
                    ``shadow_bwd_consts`` (d consts) and K10l's
                    ``shadow_bwd_rays`` (d sources, d world).
  *_reference       their plain PyTorch versions.
  primary_dead_pairs  the plain form of K10c-K10f's early-out: the pairs
                    they prove of weight exactly 0 and skip.
  primary_bwd_items plain model of K10c's and K10d's work items: each
                    tile's kept chunks cut into runs of PRI_RUN.
  primary_fwd_walk  the plain form of K10a's and K10b's early-out: the
                    pairs they prove of weight exactly 0 against the
                    running max of their work item, and skip.
  primary_fwd_run, primary_fwd_items, primary_agg_items  plain models of
                    K10a's and K10b's work items: the run, each tile's kept
                    chunks cut into runs of it, and the forward folded item
                    by item and merged in run order.
  shadow_dead_triples  the plain form of K10i's, K10j's, K10k's and K10l's
                    early-out: the triples whose sigmoid is exactly 0, which
                    they skip.
  shadow_dead_terms the plain form of K10g's and K10h's early-out: the
                    triples whose term is +-0, which they skip.
  shadow_run_index, shadow_trans_runs  plain models of K10g-K10j's work
                    items: the runs a (tile, source)'s kept chunks are cut
                    into, and the optical depth folded run by run.
  PrimaryAgg, ShadowTrans   the torch.autograd.Functions around them
                    (``_primary_agg``, ``_shadow_trans``).
  PrimaryAggStats   PrimaryAgg returning (out, m, s) (``_primary_agg_stats``),
                    for the sharded soft combine
                    (raytpu_torch/parallel/render.py).
  chunk_cull_bounds, inflate, soft_rt_keep_mask, soft_rt_shadow_mask
                    the culled frame's keep-masks (``_chunk_cull_bounds``,
                    ``_inflate``, ``soft_rt_keep_mask``,
                    ``soft_rt_shadow_mask``).

On CUDA tensors the wrappers launch the hand-written kernels
(raytpu_torch/csrc/soft_raytrace.cu); on CPU tensors they run the plain
versions. The frame that assembles them is render/soft.py::raytrace_soft.

Culling. Given a keep-mask and the ray tiles it was made on
(kernels/intersect.py::ray_tiles: the port's 16 x 16 pixel tiles, not
JAX's 1,024 swizzled pixels), the masked versions skip every (tile, chunk)
pair, or (tile, source, chunk) triple, the mask drops: a dropped chunk
leaves a ray's carry (m, s, acc), or od, exactly as it was, and gives its
pairs exactly zero gradient, as JAX's masked kernels do. The masks bound
what they drop to e^-46 of the background's weight (primary) or an
optical depth of e^-46 (shadow), so a culled frame and a brute one differ
by terms of that size; the masks carry no gradient.

The two-launch route. JAX's fused backwards keep the whole d-table resident
in VMEM, so above ``_FUSED_BWD_MAX_ROWS`` 16-column rows (Tp > 32,768 for the
32-column primary table, Tp > 65,536 for the shadow's) they split in two
launches, one owning the table's rows and one the rays, and that route takes
no mask: a culled frame's backward there runs over every pair (the forward
stays culled). The port routes on the same predicates: the fused kernels'
per-block table partials (capped at PARTIAL_BYTES) grow with the table, and
the split needs none.

The JAX kernels also take a (1, 16) globals row and the (L, 8) lights
table. ``_primary_terms`` reads only the globals' first three entries, the
camera position (``pos = g + t d``), and deletes the lights table, so
``jax.grad`` gives the lights table and globals 3-15 exactly zero
(tests/test_torch_soft_raytrace_kernels.py holds it): the port passes the
camera position alone. Two docstrings there are stale (ROADMAP fault F12):
the shadow kernel sums the optical depth, not ``log(1 - occ)``, and the
primary output rows are [albedo, position, normal], not [shade, ambient,
position].

The shadow's ``1 / |d|`` is ``1 / sqrt(r2)`` with a correctly rounded
square root here and in the kernel (JAX's ``rsqrt`` is not correctly
rounded), so the two agree bit for bit on the card and come within ulps of
JAX on the CPU. The running max m is a constant of the backward: the image
acc / s does not depend on it.
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.core.types import cross, dot3
from raytpu_torch.kernels import _build
from raytpu_torch.kernels.cull import (
    _norm,
    _sqrt,
    chunk_spheres,
    keep_mask,
    position_shadow_mask,
    tile_cones,
)
from raytpu_torch.kernels.intersect import RayTiles
from raytpu_torch.kernels.raster import _route
from raytpu_torch.kernels.soft_raster import (
    Kinks,
    _sqrt_f32,
    log_sigmoid,
    minimum,
)

# Launches of each CUDA kernel in this process, counted by its wrapper where
# it launches the kernel and nowhere else. A backward launch is the per-block
# pass and the fixed-order sums of its partials.
LAUNCHES_SRT_PRI_FWD = 0  # K10a, by primary_agg_fwd
LAUNCHES_SRT_PRI_BWD = 0  # K10c, by primary_agg_bwd
LAUNCHES_SRT_SHW_FWD = 0  # K10g, by shadow_trans_fwd
LAUNCHES_SRT_SHW_BWD = 0  # K10i, by shadow_trans_bwd
LAUNCHES_SRT_PRI_FWD_MASKED = 0  # K10b, by primary_agg_fwd with a mask
LAUNCHES_SRT_PRI_BWD_MASKED = 0  # K10d, by primary_agg_bwd with a mask
LAUNCHES_SRT_SHW_FWD_MASKED = 0  # K10h, by shadow_trans_fwd with a mask
LAUNCHES_SRT_SHW_BWD_MASKED = 0  # K10j, by shadow_trans_bwd with a mask
LAUNCHES_SRT_PRI_BWD_TABLES = 0  # K10e, by primary_bwd_tables
LAUNCHES_SRT_PRI_BWD_DIRS = 0  # K10f, by primary_bwd_dirs
LAUNCHES_SRT_SHW_BWD_CONSTS = 0  # K10k, by shadow_bwd_consts
LAUNCHES_SRT_SHW_BWD_RAYS = 0  # K10l, by shadow_bwd_rays

PRI_COLS = 32
SHW_COLS = 16
# Columns the kernels read (and the backward's partials carry).
PRI_USED = 18
SHW_USED = 14
N_OUT = 9
MAX_CHUNK = 32
# The tables' column groups, each of one kind and size, for rules scaled by
# a group's own largest entry.
PRI_GROUPS = (("planes", 0, 10), ("normal", 10, 13), ("albedo", 13, 16),
              ("active", 16, 17), ("dmin", 17, 18))
SHW_GROUPS = (("v0", 0, 3), ("edges", 3, 9), ("n", 9, 12), ("n_v0", 12, 13),
              ("active", 13, 14))
BIG = 3.4028235e38
OD_SCALE = 16.0
T_NEAR = 0.1  # raytpu/render/soft.py::_T_NEAR: the bounded depth's floor
# The kernels' block: this many rays (or shadow points) a block.
THREADS = 256
# The JAX package's cull constants (soft_raytrace_pallas.py:1374, 1454-1455,
# 1479-1483), copied: a dropped pair's weight is at most e^-CULL_MARGIN of
# the background's; the slacks, float32 where they meet a float32 array.
CULL_MARGIN = 46.0
_CULL_REL = float(np.float32(1.05))
_CULL_ABS = float(np.float32(1e-3))
# The JAX package's fused-backward limit (soft_raytrace_pallas.py:73
# ``_FUSED_BWD_MAX_ROWS``), copied: above this many 16-column rows the
# backwards take the two-launch route (pri_two_launch, shw_two_launch).
FUSED_BWD_MAX_ROWS = 65536
# K10c-K10f stop a (ray, row) pair whose logit bound lies more than this
# below the ray's saved max: its weight is exactly 0 (primary_dead_pairs,
# csrc/soft_raytrace.cu::pri_pair_dead).
DEAD_BELOW = -110.0
# K10e's scratch: rays packed 16 floats each in tiles of RAY_TILE, the
# tiles cut into at most TABLE_SPLITS runs (one partial of the table each).
RAY_TILE = 128
RAY_PACKED = 16
TABLE_SPLITS = 16
# K10f's scratch: the table staged 24 floats a row.
ROW_STAGED = 24
# K10k and K10l stop a (source, point, row) triple whose sigmoid argument
# es margin or zs (0.99 r - t) lies below this: that sigmoid is exactly 0
# (shadow_dead_triples, csrc/soft_raytrace.cu::shw_triple_dead).
SIG_ZERO = -100.0
# K10k's scratch: each source's points packed 8 floats each in tiles of
# POINT_TILE, the tiles cut into at most SHW_SPLITS runs (one partial of
# the table each): at R = 512^2 and Tp = 66,560, 8.4 MB of points a source
# (268 MB at S = 32) and 239 MB of partials. K10l's: the table staged 24
# floats a row for each source (S Tp 96 B: 6.4 MB at Tp = 66,560 and S =
# 1, 204 MB at S = 32).
POINT_TILE = 256
POINT_PACKED = 8
SHW_SPLITS = 64
SHW_STAGED = 24
# K10g-K10j cut each (tile, source)'s kept chunks (unmasked: every chunk)
# into runs of at most SHW_RUN, a work item each, in (tile, source, run)
# order (csrc/soft_raytrace.cu, "K10g-K10j, redesigned"); K10l folds d
# world in the same runs. The backward's blocks, as many as the card holds
# at once (shw_bwd_blocks), each keep a (Tp, 14) partial of the table's
# gradient, at most PARTIAL_BYTES of them in all, a cap sized for the
# H100's 80 GB (1 GiB: on the H100 the card's 396 blocks at Tp = 36,000,
# where the first design's 256 MiB left 133; 288 at 66,560). K10c and K10d
# (since their redesign) keep (Tp, 18) partials under the same cap, written
# only where a lane had a live pair. SHW_RUN 16 beat 32 on the culled
# steps' K10h and K10j at 36,000 triangles (chip_smoke.py phase 32). The
# scratch (shw_scratch) also holds the masked plan (an int a mask entry),
# each source's staged rows (96 B a row) and the runs' partial od (1 KB an
# item) or d world (3 KB an item) for the most items, n_tiles S
# ceil(n_chunks / SHW_RUN): 223 MB at Tp = 36,000 and S = 1.
SHW_RUN = 16
PARTIAL_BYTES = 1 << 30
# K10c and K10d cut each tile's kept chunks (unmasked: every chunk) into
# runs of at most PRI_RUN, a work item each, in (tile, run) order, from the
# plan K10j's kernels make (csrc/soft_raytrace.cu, "K10c and K10d,
# redesigned"); K10f folds d dirs in the same runs. On the culled 9,216
# step a tile keeps up to 111 of 288 chunks: 4,785 items. The scratch
# (pri_scratch) holds the plan, the staged rows (96 B a row), the runs'
# partial d dirs (3 KB an item) for the most items and the blocks'
# partials: 322 MB at Tp = 9,216 on 512^2 rays and 396 blocks.
PRI_RUN = 16
# K10a and K10b cut each tile's kept chunks (unmasked: every chunk) into
# runs, a work item each, in (tile, run) order, from the same plan
# (csrc/soft_raytrace.cu, "K10a and K10b, redesigned"; primary_fwd_run is
# the rule, primary_fwd_items the plain model). The run is the mean kept
# chunks a tile (rounded up) over ceil(PRI_FWD_ITEMS / ceil(R / THREADS)),
# at least PRI_FWD_RUN_MIN: at 512^2 a tile of more than the mean is cut in
# two or more, and a frame of fewer tiles is cut finer, so that about
# PRI_FWD_ITEMS items spread over the card. It depends on the shapes and
# the mask's kept count only, so an all-ones mask and no mask split alike.
# An item carries 11 floats a ray (m, s, acc) to the merge: at most
# n_tiles (ceil(PRI_FWD_ITEMS / tiles of R) + 1) items, 23 MB at 512^2,
# whatever the table's size. chip_smoke.py::pri_fwd_rule_ms times other
# values on the main path's frames: a floor of 4 ties 8 and 16 or 32 lose
# where few tiles hold the work; more items help the brute frames by a few
# percent and cost the culled step as much.
PRI_FWD_ITEMS = 1024
PRI_FWD_RUN_MIN = 8


def primary_fwd_run(kept: int, n_tiles: int, R: int) -> int:
    """The run of K10a's and K10b's work items (csrc/soft_raytrace.cu's
    pri_fwd_run, pri_fwd_run_kernel for a mask): ``kept`` (tile, chunk)
    pairs kept over n_tiles tiles of R rays."""
    mean = -(-kept // n_tiles)
    splits = max(1, -(-PRI_FWD_ITEMS // -(-R // THREADS)))
    return max(PRI_FWD_RUN_MIN, -(-mean // splits))


def _fwd_tiles(R: int, mask, tiles: RayTiles | None) -> tuple:
    """The forward's tiles: each ray's tile (R,) and their count, the
    mask's, or runs of THREADS consecutive rays where there is none."""
    if mask is None:
        return torch.arange(R) // THREADS, -(-R // THREADS)
    return tiles.tile.cpu(), tiles.count


def primary_fwd_items(mask, n_tiles: int, n_chunks: int, R: int) -> tuple:
    """Plain model of K10a's and K10b's work items: the run
    (primary_fwd_run) and each tile's kept chunks (mask (n_tiles,
    n_chunks) != 0, or every chunk where mask is None) cut into runs of
    it in order, a work item each, in (tile, run) order. Returns (run,
    [(tile, [chunk, ...]), ...])."""
    kept = n_tiles * n_chunks if mask is None else int((mask != 0).sum())
    run = primary_fwd_run(kept, n_tiles, R)
    return run, primary_bwd_items(mask, n_tiles, n_chunks, run)


def _fwd_plan(consts, dirs, chunk: int, mask, tiles) -> tuple:
    """Each ray's tile, whether chunk c starts a work item of tile t
    (n_tiles, n_chunks) and each tile's items (n_tiles,), as the forward's
    plan makes them."""
    R, n_chunks = dirs.shape[1], consts.shape[0] // chunk
    tile, n_tiles = _fwd_tiles(R, mask, tiles)
    kept = (torch.ones((n_tiles, n_chunks), dtype=torch.bool)
            if mask is None else mask.cpu() != 0)
    run = primary_fwd_run(int(kept.sum()), n_tiles, R)
    rank = torch.cumsum(kept.to(torch.int64), dim=1) - 1
    start = kept & (rank % run == 0)
    return tile, start, -(-kept.sum(dim=1) // run)


def primary_fwd_walk(consts, cam, dirs, es: float, zs: float, chunk: int,
                     mask=None, tiles: RayTiles = None):
    """Plain form of K10a's and K10b's dead-pair test against the running
    carry (csrc/soft_raytrace.cu::pri_dead at the item's m), for the tests
    and chip_smoke.py; the kernels' route never calls it. Chunk by chunk,
    yields (c, keep, logit, dead): the rays whose tile keeps chunk c (an
    index tensor, or every ray), their logits (C, K) (primary_terms,
    -1e30 where gated) and the pairs the test proves of weight exactly 0
    (primary_dead_pairs at each ray's carry m: 0 at its work item's first
    chunk, then the max of it and each chunk's logits)."""
    tile, start, _ = _fwd_plan(consts, dirs, chunk, mask, tiles)
    tile = tile.to(dirs.device)
    start = start.to(dirs.device)
    m = dirs.new_zeros(dirs.shape[1])
    for c, rows in enumerate(_chunks(consts.shape[0], chunk)):
        keep = _kept(mask, tiles, c)
        m = torch.where(start[tile, c], 0.0, m)
        d = dirs[:, keep]
        logit, _ = primary_terms(consts[rows], cam, d[0:1], d[1:2], d[2:3],
                                 es, zs)
        dead = primary_dead_pairs(consts[rows], d, m[keep], es, zs)
        yield c, keep, logit, dead
        m[keep] = torch.maximum(m[keep], logit.max(dim=0).values)


def primary_agg_items(consts, cam, dirs, es: float, zs: float, chunk: int,
                      mask=None, tiles: RayTiles = None):
    """Plain model of K10a's and K10b's order (primary_agg_reference's
    result, its sums in the kernels' order): each tile's kept chunks cut
    into work items (primary_fwd_items); a tile of one item carries (m, s,
    acc) from the background (0, 1, 0) as primary_agg_reference does, an
    item of a tile of several from (0, 0, 0), and the merge folds those
    items in run order into the background: m = max(m, m_j), s = s e^(m -
    m') + s_j e^(m_j - m'), acc likewise. Returns out (9, R), m, s."""
    R = dirs.shape[1]
    tile, start, n_items = _fwd_plan(consts, dirs, chunk, mask, tiles)
    tile, start = tile.to(dirs.device), start.to(dirs.device)
    split = (n_items > 1).to(dirs.device)[tile]
    m = dirs.new_zeros(R)
    s = torch.where(split, 0.0, 1.0).to(dirs.dtype)
    acc = dirs.new_zeros(N_OUT, R)
    fm, fs, facc = dirs.new_zeros(R), dirs.new_ones(R), dirs.new_zeros(N_OUT,
                                                                        R)

    def fold(rays):
        m_new = torch.maximum(fm[rays], m[rays])
        a, b = torch.exp(fm[rays] - m_new), torch.exp(m[rays] - m_new)
        fs[rays] = fs[rays] * a + s[rays] * b
        facc[:, rays] = facc[:, rays] * a + acc[:, rays] * b
        fm[rays] = m_new

    begun = torch.zeros(R, dtype=torch.bool, device=dirs.device)
    for c, rows in enumerate(_chunks(consts.shape[0], chunk)):
        new = start[tile, c] & split
        fold(torch.nonzero(new & begun).squeeze(1))
        m[new], s[new], acc[:, new] = 0.0, 0.0, 0.0
        begun |= new
        keep = _kept(mask, tiles, c)
        d = dirs[:, keep]
        logit, vals = primary_terms(consts[rows], cam, d[0:1], d[1:2],
                                    d[2:3], es, zs)
        m_old = m[keep]
        m_new = torch.maximum(m_old, logit.max(dim=0).values)
        scale = torch.exp(m_old - m_new)
        w = torch.exp(logit - m_new)
        m[keep] = m_new
        s[keep] = s[keep] * scale + w.sum(dim=0)
        acc[:, keep] = acc[:, keep] * scale + torch.stack(
            [(w * v).sum(dim=0) for v in vals])
    fold(torch.nonzero(begun).squeeze(1))
    m = torch.where(split, fm, m)
    s = torch.where(split, fs, s)
    acc = torch.where(split, facc, acc)
    return acc * (1.0 / s), m, s


def pri_two_launch(Tp: int) -> bool:
    """Whether the primary backward of a (Tp, 32) table takes the
    two-launch route (K10e + K10f), as ``_pri_bwd_impl`` decides
    (soft_raytrace_pallas.py:661): above 32,768 rows."""
    return Tp * PRI_COLS > FUSED_BWD_MAX_ROWS * 16


def shw_two_launch(Tp: int) -> bool:
    """Whether the shadow backward of a (Tp, 16) table takes the two-launch
    route (K10k + K10l), as ``_shadow_bwd`` decides
    (soft_raytrace_pallas.py:1228): above 65,536 rows."""
    return Tp > FUSED_BWD_MAX_ROWS


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

def primary_tri_constants(scene, start: torch.Tensor) -> torch.Tensor:
    """(T, 32) table of the primary kernels (``primary_tri_constants``):
    n = cross(e1, e2) (0-2), c2b = cross(e2, b) (3-5), cb1 = cross(b, e1)
    (6-8) with b = start - v0, k0 = n . b (9), the shading normal
    (``scene.normals()``, 10-12), albedo (13-15), active (16) and
    dmin = max(|start - centroid| - r_tri, 0) (17); 18-31 zero."""
    e1, e2 = scene.edges()
    b = start[None, :] - scene.v0
    n = cross(e1, e2)
    c2b = cross(e2, b)
    cb1 = cross(b, e1)
    k0 = dot3(n, b)
    nrm = scene.normals()
    cen = (scene.v0 + scene.v1 + scene.v2) / 3.0

    def sq(v):
        return dot3(v - cen, v - cen)

    r2t = torch.maximum(torch.maximum(sq(scene.v0), sq(scene.v1)),
                        sq(scene.v2))
    oc = _sqrt_f32(dot3(cen - start[None, :], cen - start[None, :]))
    dmin = torch.maximum(oc - _sqrt_f32(r2t + 1e-20), torch.zeros_like(oc))
    cols = [*n.unbind(1), *c2b.unbind(1), *cb1.unbind(1), k0,
            *nrm.unbind(1), *scene.color.unbind(1), scene.active, dmin]
    cols += [torch.zeros_like(k0)] * (PRI_COLS - len(cols))
    return torch.stack(cols, dim=1)


def shadow_tri_constants(scene) -> torch.Tensor:
    """(T, 16) table of the shadow kernels (``shadow_tri_constants``,
    source-independent): v0 (0-2), e1 (3-5), e2 (6-8), n (9-11), n . v0
    (12), active (13); 14-15 zero."""
    e1, e2 = scene.edges()
    n = cross(e1, e2)
    cols = [*scene.v0.unbind(1), *e1.unbind(1), *e2.unbind(1), *n.unbind(1),
            dot3(n, scene.v0), scene.active]
    cols += [torch.zeros_like(cols[0])] * (SHW_COLS - len(cols))
    return torch.stack(cols, dim=1)


def pad_rows(table: torch.Tensor, chunk: int) -> torch.Tensor:
    """The table padded with zero rows to a whole number of chunks; an empty
    table takes one all-zero chunk (the background)."""
    T = table.shape[0]
    pad = chunk if T == 0 else (-T) % chunk
    if not pad:
        return table
    return torch.cat([table, table.new_zeros(pad, table.shape[1])])


# ---------------------------------------------------------------------------
# Per-(triangle, ray) terms, op by op in the JAX kernels' order
# ---------------------------------------------------------------------------

def _flag(kinks: Kinks | None, make):
    """A branch decision (a boolean tensor), recorded or replayed."""
    return make() if kinks is None else kinks.decide(make)


def _safe_denom(denom, kinks: Kinks | None):
    """Where the Moller-Trumbore denominator is divided by, |denom| >
    1e-12 (else 1e-12 is). Replayed in float64, a denominator float32 kept
    can be exactly 0 (a ray parallel to a plane, exactly); it takes the
    1e-12 too, so that the gated pair's zero cotangent does not meet an
    infinite 1 / denom."""
    big = _flag(kinks, lambda: denom.abs() > 1e-12)
    return big & (denom != 0.0) if kinks is not None else big


def maximum(a, b, kinks: Kinks | None = None):
    """``jnp.maximum``: half the gradient to each side of a tie."""
    return -minimum(-a, -b, kinks)


def primary_terms(cs, cam, dx, dy, dz, es: float, zs: float,
                  kinks: Kinks | None = None):
    """Per-(row, ray) logit and the 9 values of one chunk
    (``_primary_terms``): cs (C, 32), cam (3,) the camera position, dx, dy,
    dz (1, P) the ray directions. Returns (logit (C, P), vals), vals[j]
    (C, P), or (C, 1) where a value is the row's own. ``kinks`` records or
    replays the branch decisions (Kinks)."""
    def col(j):
        return cs[:, j:j + 1]

    denom = -((dx * col(0) + dy * col(1)) + dz * col(2))
    safe = torch.where(_safe_denom(denom, kinks), denom, 1e-12)
    rec = 1.0 / safe
    t = col(9) * rec
    u = ((dx * col(3) + dy * col(4)) + dz * col(5)) * rec
    v = ((dx * col(6) + dy * col(7)) + dz * col(8)) * rec
    margin = minimum(minimum(u, v, kinks), (1.0 - u) - v, kinks)
    dn = _sqrt_f32((dx * dx + dy * dy) + dz * dz)
    nmag = _sqrt_f32((col(0) * col(0) + col(1) * col(1)) + col(2) * col(2))
    hit_ok = _flag(kinks, lambda: (t > 1e-6)
                   & (denom.abs() > (1e-3 * dn) * nmag))
    dist = t * dn
    zinv = 1.0 / maximum(maximum(dist, col(17), kinks),
                         torch.full_like(dist, T_NEAR), kinks)
    # A gated pair's margin can be anything (its t and u, v come from a
    # near-zero denominator); it is replaced by -1e30 below either way, and
    # taken as 0 here so that no exp(|margin|) overflows into its (zero)
    # gradient: replayed in float64 with float32's branches, such a margin
    # can take the other sign than its recorded |x|.
    margin = torch.where(hit_ok, margin, 0.0)
    logit = ((zs * torch.where(hit_ok, zinv, 0.0)
              + log_sigmoid(es * margin, kinks))
             + torch.log(col(16) + 1e-20))
    logit = torch.where(hit_ok, logit, -1e30)
    tp = torch.where(_flag(kinks, lambda: hit_ok & (t < BIG)), t, 0.0)
    pos = [cam[j] + tp * d for j, d in enumerate((dx, dy, dz))]
    vals = ([col(13 + j) for j in range(3)] + pos
            + [col(10 + j) for j in range(3)])
    return logit, vals


def shadow_terms(cs, src, wx, wy, wz, es: float, zs: float,
                 kinks: Kinks | None = None):
    """Per-(row, point) optical depth ``cov * occ_z`` of one chunk for one
    source (the summand of ``_shadow_od_terms``): cs (C, 16), src (3,), wx,
    wy, wz (1, P) the world points. Returns (C, P)."""
    def col(j):
        return cs[:, j:j + 1]

    d = [wx - src[0], wy - src[1], wz - src[2]]
    r2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    r2s = torch.where(_flag(kinks, lambda: r2 > 0.0), r2, 1.0)
    rrec = 1.0 / _sqrt_f32(r2s)  # JAX: lax.rsqrt (see the module note)
    r = r2s * rrec
    dh = [dj * rrec for dj in d]
    b = [src[j] - col(j) for j in range(3)]
    e1 = [col(3), col(4), col(5)]
    e2 = [col(6), col(7), col(8)]
    n = [col(9), col(10), col(11)]
    c2b = [e2[1] * b[2] - e2[2] * b[1],
           e2[2] * b[0] - e2[0] * b[2],
           e2[0] * b[1] - e2[1] * b[0]]
    cb1 = [b[1] * e1[2] - b[2] * e1[1],
           b[2] * e1[0] - b[0] * e1[2],
           b[0] * e1[1] - b[1] * e1[0]]
    k0 = ((src[0] * n[0] + src[1] * n[1]) + src[2] * n[2]) - col(12)
    denom = -((dh[0] * n[0] + dh[1] * n[1]) + dh[2] * n[2])
    safe = torch.where(_safe_denom(denom, kinks), denom, 1e-12)
    rec = 1.0 / safe
    t = k0 * rec
    u = ((dh[0] * c2b[0] + dh[1] * c2b[1]) + dh[2] * c2b[2]) * rec
    v = ((dh[0] * cb1[0] + dh[1] * cb1[1]) + dh[2] * cb1[2]) * rec
    margin = minimum(minimum(u, v, kinks), (1.0 - u) - v, kinks)
    cov = torch.sigmoid(es * margin) * col(13)
    nmag = _sqrt_f32((n[0] * n[0] + n[1] * n[1]) + n[2] * n[2])
    ok = _flag(kinks, lambda: (t > 1e-6) & (denom.abs() > 1e-3 * nmag))
    occ_z = torch.where(ok, torch.sigmoid(zs * (0.99 * r - t)), 0.0)
    return cov * occ_z


# ---------------------------------------------------------------------------
# Keep-masks of the culled frame
# ---------------------------------------------------------------------------

def chunk_cull_bounds(v0, v1, v2, chunk: int):
    """Bounding sphere and longest edge of each chunk of ``chunk`` rows
    over the rows that carry coverage, those of a nonzero plane normal
    (``_chunk_cull_bounds``; inactive rows carry e^-46-relative coverage,
    so they count). Returns (centers (n_chunks, 3), radii (n_chunks,),
    emax (n_chunks,)); radius -1 marks a chunk of degenerate rows only."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = cross(e1, e2)
    used = (dot3(n, n) > 0.0).to(torch.float32)
    centers, radii = chunk_spheres(v0, v1, v2, used, chunk)
    e3 = v2 - v1
    elen2 = torch.maximum(torch.maximum(dot3(e1, e1), dot3(e2, e2)),
                          dot3(e3, e3))
    pad = (-elen2.shape[0]) % chunk
    if pad:
        elen2 = torch.cat([elen2, elen2.new_zeros(pad)])
        used = torch.cat([used, used.new_zeros(pad)])
    elen2 = torch.where(used > 0.0, elen2, 0.0)
    emax = _sqrt(elen2.reshape(-1, chunk).amax(dim=1))
    return centers, radii, emax


def inflate(radii, delta):
    """Chunk radii grown by delta; an empty chunk (-1) stays empty."""
    return torch.where(radii >= 0.0, radii + delta, -1.0)


def soft_rt_keep_mask(dirs, origin, v0, v1, v2, es: float, zs: float,
                      t_near: float, tile_r: int, chunk: int):
    """(n_tiles, n_chunks) int32 keep-mask of the primary kernels
    (``soft_rt_keep_mask``): a chunk is dropped for a tile of ``tile_r``
    consecutive directions of dirs (R, 3) from ``origin`` where every ray
    clears its sphere inflated by 2 E (46 + zs / max(d_c - r_c, t_near)) /
    es (1.05 relative and 1e-3 absolute slack), which bounds each of its
    logits to 46 below the background's. Pad a tile with a real ray."""
    centers, radii, emax = chunk_cull_bounds(v0, v1, v2, chunk)
    d_c = _norm(centers - origin[None, :])
    zinv_max = 1.0 / torch.clamp_min(d_c - torch.clamp_min(radii, 0.0),
                                     float(np.float32(t_near)))
    delta = ((2.0 * emax / float(np.float32(es)))
             * (CULL_MARGIN + float(np.float32(zs)) * zinv_max) * _CULL_REL
             + _CULL_ABS)
    axes, cos_half = tile_cones(dirs, tile_r)
    keep = keep_mask(origin, axes, cos_half, centers,
                     inflate(radii, delta)) != 0
    return (keep & (radii >= 0.0)[None, :]).to(torch.int32)


def soft_rt_shadow_mask(world, src_pos, v0, v1, v2, es: float, zs: float,
                        tile_r: int, chunk: int):
    """(n_tiles, S, n_chunks) int32 keep-mask of the shadow kernels
    (``soft_rt_shadow_mask``): kernels/cull.py::position_shadow_mask of the
    tiles of ``tile_r`` consecutive points of world (R, 3), the aggregated
    hit positions, toward src_pos (S, 3), the chunk radii inflated by
    2 E 46 / es and the range cap extended by 46 / zs (each with the
    slacks), which bounds a dropped triple's optical depth to e^-46."""
    centers, radii, emax = chunk_cull_bounds(v0, v1, v2, chunk)
    delta = ((2.0 * emax / float(np.float32(es))) * CULL_MARGIN * _CULL_REL
             + _CULL_ABS)
    return position_shadow_mask(world, src_pos, centers,
                                inflate(radii, delta), tile_r,
                                range_pad=CULL_MARGIN / zs * 1.05 + 1e-3)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _chunks(Tp: int, chunk: int):
    return [slice(c * chunk, (c + 1) * chunk) for c in range(Tp // chunk)]


_ALL = slice(None)


def _kept(mask, tiles: RayTiles | None, c: int, s: int | None = None):
    """The rays whose tile keeps chunk c (of source s, for a shadow mask):
    an index tensor, or every ray where there is no mask."""
    if mask is None:
        return _ALL
    col = mask[tiles.tile, c] if s is None else mask[tiles.tile, s, c]
    return torch.nonzero(col).squeeze(1)


def primary_agg_reference(consts, cam, dirs, es: float, zs: float,
                          chunk: int, mask=None, tiles: RayTiles = None):
    """Plain PyTorch version of K10a (K10b with a mask), on any device and
    in any float type: consts (Tp, 32) in chunks of ``chunk`` rows, cam
    (3,), dirs (3, R). From the background hypothesis (m = 0, s = 1,
    acc = 0), chunk by chunk as ``_pri_fwd_kernel``; with mask (n_tiles,
    n_chunks) over ``tiles``, each chunk on the rays whose tile keeps it.
    Returns out (9, R) = acc / s, m (R,), s (R,)."""
    R = dirs.shape[1]
    m = dirs.new_zeros(R)
    s = dirs.new_ones(R)
    acc = dirs.new_zeros(N_OUT, R)
    for c, rows in enumerate(_chunks(consts.shape[0], chunk)):
        keep = _kept(mask, tiles, c)
        d = dirs[:, keep]
        logit, vals = primary_terms(consts[rows], cam, d[0:1], d[1:2],
                                    d[2:3], es, zs)
        m_old = m[keep]
        m_new = torch.maximum(m_old, logit.max(dim=0).values)
        scale = torch.exp(m_old - m_new)
        w = torch.exp(logit - m_new)
        m[keep] = m_new
        s[keep] = s[keep] * scale + w.sum(dim=0)
        acc[:, keep] = acc[:, keep] * scale + torch.stack(
            [(w * v).sum(dim=0) for v in vals])
    return acc * (1.0 / s), m, s


def primary_dead_pairs(cs, dirs, m, es: float, zs: float) -> torch.Tensor:
    """Plain PyTorch form of K10c-K10f's early-out
    (csrc/soft_raytrace.cu::pri_pair_dead) in its operations' order, for
    the tests and chip_smoke.py; the kernels' route never calls it. cs
    (C, 32) rows of the primary table, dirs (3, R), m (R,) the forward's
    saved max. Returns (C, R) bool, True where the pair is gated or where
    the bound of its logit
    ``B = (zb + min(es margin, 0)) + log(active + 1e-20)``,
    ``zb = zs / max(dmin, 0.1)`` (0 for zs < 0), lies below
    ``m + DEAD_BELOW``: its weight ``exp(logit - m)`` is then exactly 0. A
    NaN in B or m marks nothing (``min`` here keeps a NaN xs)."""
    def col(j):
        return cs[:, j:j + 1]

    dx, dy, dz = dirs[0:1], dirs[1:2], dirs[2:3]
    denom = -((dx * col(0) + dy * col(1)) + dz * col(2))
    safe = torch.where(denom.abs() > 1e-12, denom, 1e-12)
    rec = 1.0 / safe
    t = col(9) * rec
    dn = _sqrt_f32((dx * dx + dy * dy) + dz * dz)
    nmag = _sqrt_f32((col(0) * col(0) + col(1) * col(1)) + col(2) * col(2))
    hit = (t > 1e-6) & (denom.abs() > (1e-3 * dn) * nmag)
    u = ((dx * col(3) + dy * col(4)) + dz * col(5)) * rec
    v = ((dx * col(6) + dy * col(7)) + dz * col(8)) * rec
    # fminf and fmaxf drop a NaN operand; torch.fmin and fmax do too.
    margin = torch.fmin(torch.fmin(u, v), (1.0 - u) - v)
    xs = es * margin
    cap = torch.where(xs > 0.0, 0.0, xs)
    zinv_max = 1.0 / torch.fmax(col(17), torch.full_like(col(17), T_NEAR))
    zb = torch.zeros_like(zinv_max) if zs < 0.0 else zs * zinv_max
    bound = (zb + cap) + torch.log(col(16) + 1e-20)
    return ~hit | ((bound - m[None, :]) < DEAD_BELOW)


def primary_bwd_items(mask, n_tiles: int, n_chunks: int,
                      run: int = PRI_RUN) -> list:
    """Plain model of K10c's and K10d's work items (the plan of
    csrc/soft_raytrace.cu's shw_plan_kernel and shw_items_kernel with one
    source a tile; unmasked, every chunk): each tile's kept chunks (mask
    (n_tiles, n_chunks) != 0, or every chunk where mask is None) in order,
    cut into runs of at most ``run``, a work item each, in (tile, run)
    order. Returns [(tile, [chunk, ...]), ...]."""
    items = []
    for t in range(n_tiles):
        kept = (list(range(n_chunks)) if mask is None
                else torch.nonzero(mask[t]).squeeze(1).tolist())
        items += [(t, kept[i:i + run]) for i in range(0, len(kept), run)]
    return items


def _shadow_test(cs, src, world, es: float, zs: float):
    """The triples' test in the kernels' order of operations
    (csrc/soft_raytrace.cu::shw_test): cs (C, 16) rows of the shadow table,
    src (3,), world (3, P). Returns (hit, 1 - u - v, xs, y), each (C, P)."""
    def col(j):
        return cs[:, j:j + 1]

    # The point's ray (shadow_ray): 1 / |d| as 1 / sqrt.
    d = [world[j:j + 1] - src[j] for j in range(3)]
    r2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    r2s = torch.where(r2 > 0.0, r2, 1.0)
    rrec = 1.0 / _sqrt_f32(r2s)
    rr = r2s * rrec
    dh = [dj * rrec for dj in d]
    # The row staged for the source (stage_shw_row).
    b = [src[j] - col(j) for j in range(3)]
    e1 = [col(3), col(4), col(5)]
    e2 = [col(6), col(7), col(8)]
    n = [col(9), col(10), col(11)]
    c2b = [e2[1] * b[2] - e2[2] * b[1],
           e2[2] * b[0] - e2[0] * b[2],
           e2[0] * b[1] - e2[1] * b[0]]
    cb1 = [b[1] * e1[2] - b[2] * e1[1],
           b[2] * e1[0] - b[0] * e1[2],
           b[0] * e1[1] - b[1] * e1[0]]
    k0 = ((src[0] * n[0] + src[1] * n[1]) + src[2] * n[2]) - col(12)
    nmag = _sqrt_f32((n[0] * n[0] + n[1] * n[1]) + n[2] * n[2])
    # The test (shw_test).
    denom = -((dh[0] * n[0] + dh[1] * n[1]) + dh[2] * n[2])
    safe = torch.where(denom.abs() > 1e-12, denom, 1e-12)
    rec = 1.0 / safe
    t = k0 * rec
    u = ((dh[0] * c2b[0] + dh[1] * c2b[1]) + dh[2] * c2b[2]) * rec
    v = ((dh[0] * cb1[0] + dh[1] * cb1[1]) + dh[2] * cb1[2]) * rec
    omu = (1.0 - u) - v
    # fminf drops a NaN operand; torch.fmin does too.
    xs = es * torch.fmin(torch.fmin(u, v), omu)
    y = zs * (0.99 * rr - t)
    hit = (t > 1e-6) & (denom.abs() > 1e-3 * nmag)
    return hit, omu, xs, y


def shadow_dead_triples(cs, src, world, es: float,
                        zs: float) -> torch.Tensor:
    """Plain PyTorch form of the backwards' early-out (K10i, K10j, K10k,
    K10l: csrc/soft_raytrace.cu::shw_dead) in its operations' order, for
    the tests and chip_smoke.py; the kernels' route never calls it. cs
    (C, 16) rows of the shadow table, src (3,) one source, world (3, P)
    the points. Returns (C, P) bool, True where the triple is gated or
    where ``xs = es margin`` or ``y = zs (0.99 r - t)``, the floats the
    kernels' two sigmoids take, lies below SIG_ZERO: that sigmoid, and the
    triple's term and gradient, are then exactly 0. A NaN xs or y marks
    nothing."""
    hit, _, xs, y = _shadow_test(cs, src, world, es, zs)
    return ~hit | (xs < SIG_ZERO) | (y < SIG_ZERO)


def shadow_dead_terms(cs, src, world, es: float, zs: float) -> torch.Tensor:
    """Plain PyTorch form of the forwards' early-out (K10g, K10h:
    csrc/soft_raytrace.cu::shw_term_dead), in its operations' order, for
    the tests and chip_smoke.py; the kernels' route never calls it. Inputs
    as shadow_dead_triples'. Returns (C, P) bool, True where the triple's
    term ``sigmoid(xs) active sigmoid(y)`` (zero where gated) is +-0, so
    that skipping it leaves a sum from +0 as it was: shadow_dead_triples'
    triples, but only where the active column is finite and none of
    1 - u - v, xs and y is NaN (0 inf and 0 NaN are NaN). Where 1 - u - v
    is not NaN neither u nor v is, so the kernels' margin (fminf) is the
    plain version's (a NaN-keeping minimum)."""
    hit, omu, xs, y = _shadow_test(cs, src, world, es, zs)
    sane = (cs[:, 13:14].abs() <= BIG) & ~omu.isnan() & ~xs.isnan() \
        & ~y.isnan()
    return sane & (~hit | (xs < SIG_ZERO) | (y < SIG_ZERO))


def shadow_run_index(mask, n_tiles: int, S: int, n_chunks: int,
                     run: int = SHW_RUN) -> torch.Tensor:
    """(n_tiles, S, n_chunks) int64: the run, among K10g-K10j's work items
    of its (tile, source), that takes each chunk, -1 where the mask drops
    it: a pair's kept chunks (every chunk where mask is None) cut in order
    into runs of ``run``."""
    if mask is None:
        rank = torch.arange(n_chunks).expand(n_tiles, S, n_chunks)
        return rank // run
    rank = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    return torch.where(mask != 0, rank // run, -1)


def shadow_trans_runs(consts, srcs, world, es: float, zs: float, chunk: int,
                      mask=None, tiles: RayTiles = None,
                      run: int = SHW_RUN) -> torch.Tensor:
    """Plain model of K10g's and K10h's order (shadow_trans_reference's
    result in another order of its sums): each (tile, source)'s kept
    chunks cut into runs (shadow_run_index; unmasked, tiles of THREADS
    consecutive points), each run's od summed chunk by chunk from 0, then
    the runs added in order from 0 and ``exp(-16 od)``. Returns trans (S,
    R)."""
    R, S = world.shape[1], srcs.shape[0]
    n_chunks = consts.shape[0] // chunk
    if mask is None:
        tile = torch.arange(R, device=world.device) // THREADS
        n_tiles = -(-R // THREADS)
    else:
        tile, n_tiles = tiles.tile, tiles.count
    runs = shadow_run_index(None if mask is None else mask.cpu(), n_tiles, S,
                            n_chunks, run).to(world.device)
    out = []
    for s in range(S):
        part = world.new_zeros((-(-n_chunks // run), R))
        for c, rows in enumerate(_chunks(consts.shape[0], chunk)):
            j = runs[tile, s, c]
            keep = torch.nonzero(j >= 0).squeeze(1)
            w = world[:, keep]
            part[j[keep], keep] = part[j[keep], keep] + shadow_terms(
                consts[rows], srcs[s], w[0:1], w[1:2], w[2:3], es,
                zs).sum(dim=0)
        od = world.new_zeros(R)
        for j in range(part.shape[0]):
            od = od + part[j]
        out.append(torch.exp(-OD_SCALE * od))
    return torch.stack(out)


def _record(fn, args, kinks_wanted: bool):
    """The branch decisions of fn(*float32 args) for a replay, or None."""
    if not kinks_wanted:
        return None
    kinks = Kinks()
    with torch.no_grad():
        fn(*[a.float() if isinstance(a, torch.Tensor) else a for a in args],
           kinks)
    return kinks.replay()


def primary_agg_bwd_reference(consts, cam, dirs, m, cot, es: float,
                              zs: float, chunk: int,
                              f32_branches: bool = False, mask=None,
                              tiles: RayTiles = None):
    """Plain PyTorch version of K10c (K10d with a mask; without one, of
    K10e and K10f together), on any device and in any float type: each chunk recomputed at the saved m (R,), a
    constant, and differentiated by autograd against the cotangent rows
    cot (10, R) = [d s, d acc_0..8] (``primary_cot``), as
    ``_pri_bwd_fused_kernel``'s in-kernel ``jax.vjp`` does; with a mask,
    on the rays whose tile keeps the chunk only (a dropped pair's gradient
    is exactly 0). Returns (d consts (Tp, 32), d cam (3,), d dirs (3, R)).

    f32_branches: take the branch decisions (Kinks) of the inputs rounded
    to float32, for a float64 reference of the float32 kernel."""
    dc = torch.zeros_like(consts)
    dcam = torch.zeros_like(cam)
    dd = torch.zeros_like(dirs)
    with torch.enable_grad():
        for c, rows in enumerate(_chunks(consts.shape[0], chunk)):
            keep = _kept(mask, tiles, c)
            if mask is not None and keep.numel() == 0:
                continue
            kinks = _record(
                lambda cs, g, d, k: primary_terms(cs, g, d[0:1], d[1:2],
                                                  d[2:3], es, zs, k),
                (consts[rows], cam, dirs[:, keep]), f32_branches)
            cs = consts[rows].detach().requires_grad_()
            g = cam.detach().requires_grad_()
            d = dirs[:, keep].detach().requires_grad_()
            logit, vals = primary_terms(cs, g, d[0:1], d[1:2], d[2:3], es, zs,
                                        kinks)
            w = torch.exp(logit - m[keep])
            outs = [w.sum(dim=0)] + [(w * v).sum(dim=0) for v in vals]
            gc, gg, gd = torch.autograd.grad(outs, (cs, g, d),
                                             grad_outputs=list(cot[:, keep]))
            dc[rows] = gc
            dcam = dcam + gg
            dd[:, keep] = dd[:, keep] + gd
    return dc, dcam, dd


def shadow_trans_reference(consts, srcs, world, es: float, zs: float,
                           chunk: int, mask=None, tiles: RayTiles = None):
    """Plain PyTorch version of K10g (K10h with a mask): consts (Tp, 16),
    srcs (S, 3), world (3, R). The optical depth summed chunk by chunk,
    then ``exp(-16 od)`` (``_shw_fwd_kernel``); with mask (n_tiles, S,
    n_chunks) over ``tiles``, each (source, chunk) on the points whose tile
    keeps it, from od = 0. Returns trans (S, R)."""
    out = []
    for s in range(srcs.shape[0]):
        od = world.new_zeros(world.shape[1])
        for c, rows in enumerate(_chunks(consts.shape[0], chunk)):
            keep = _kept(mask, tiles, c, s)
            w = world[:, keep]
            od[keep] = od[keep] + shadow_terms(
                consts[rows], srcs[s], w[0:1], w[1:2], w[2:3], es,
                zs).sum(dim=0)
        out.append(torch.exp(-OD_SCALE * od))
    return torch.stack(out)


def shadow_trans_bwd_reference(consts, srcs, world, trans, gcot, es: float,
                               zs: float, chunk: int,
                               f32_branches: bool = False, mask=None,
                               tiles: RayTiles = None):
    """Plain PyTorch version of K10i (K10j with a mask; without one, of
    K10k and K10l together): d od = gcot *
    (-16) * trans, each (source, chunk) recomputed and differentiated by
    autograd, as ``_shw_bwd_fused_kernel``'s ``jax.vjp``, on the points
    whose tile keeps it where there is a mask; d world summed over the
    sources in order (``_shadow_bwd``). Returns (d consts (Tp, 16), d srcs
    (S, 3), d world (3, R)). f32_branches as for
    primary_agg_bwd_reference."""
    dc = torch.zeros_like(consts)
    dsrc = torch.zeros_like(srcs)
    dw = torch.zeros_like(world)
    dlog = gcot * trans * (-OD_SCALE)
    with torch.enable_grad():
        for s in range(srcs.shape[0]):
            dws = torch.zeros_like(world)
            for c, rows in enumerate(_chunks(consts.shape[0], chunk)):
                keep = _kept(mask, tiles, c, s)
                if mask is not None and keep.numel() == 0:
                    continue
                kinks = _record(
                    lambda cs, sr, w, k: shadow_terms(cs, sr, w[0:1], w[1:2],
                                                      w[2:3], es, zs, k),
                    (consts[rows], srcs[s], world[:, keep]), f32_branches)
                cs = consts[rows].detach().requires_grad_()
                sr = srcs[s].detach().requires_grad_()
                w = world[:, keep].detach().requires_grad_()
                od = shadow_terms(cs, sr, w[0:1], w[1:2], w[2:3], es, zs,
                                  kinks).sum(dim=0)
                gc, gs, gw = torch.autograd.grad(od, (cs, sr, w),
                                                 grad_outputs=dlog[s][keep])
                dc[rows] = dc[rows] + gc
                dsrc[s] = dsrc[s] + gs
                dws[:, keep] = dws[:, keep] + gw
            dw = dw + dws
    return dc, dsrc, dw


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, shape: tuple, device,
           dtype=torch.float32) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or \
            not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name}: expected a contiguous {dtype} {shape} "
                         f"tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_table(consts: torch.Tensor, cols: int, chunk: int) -> None:
    Tp = consts.shape[0] if consts.dim() == 2 else -1
    _check("consts", consts, (Tp, cols), consts.device)
    if not 1 <= chunk <= MAX_CHUNK or Tp < chunk or Tp % chunk:
        raise ValueError(f"chunk must be 1..{MAX_CHUNK} and divide Tp = {Tp},"
                         f" got {chunk}")


def _check_pri_bwd(consts, cam, dirs, m, cot, chunk: int) -> int:
    """The primary backward's inputs (as primary_agg_bwd takes them);
    returns R."""
    _check_table(consts, PRI_COLS, chunk)
    _check("cam", cam, (3,), consts.device)
    R = dirs.shape[1] if dirs.dim() == 2 else -1
    _check("dirs", dirs, (3, R), consts.device)
    _check("m", m, (R,), consts.device)
    _check("cot", cot, (1 + N_OUT, R), consts.device)
    return R


def _check_shw_bwd(consts, srcs, world, trans, gcot, chunk: int) -> tuple:
    """The shadow backward's inputs (as shadow_trans_bwd takes them);
    returns (S, R)."""
    _check_table(consts, SHW_COLS, chunk)
    S = srcs.shape[0] if srcs.dim() == 2 else -1
    _check("srcs", srcs, (S, 3), consts.device)
    R = world.shape[1] if world.dim() == 2 else -1
    _check("world", world, (3, R), consts.device)
    _check("trans", trans, (S, R), consts.device)
    _check("gcot", gcot, (S, R), consts.device)
    return S, R


def _check_mask(mask, tiles: RayTiles, R: int, shape: tuple,
                device) -> None:
    """A keep-mask (n_tiles, *shape) int32 over tiles of R rays."""
    if tiles.height * tiles.width != R:
        raise ValueError(f"tiles of {tiles.height} x {tiles.width} rays for "
                         f"{R} rays")
    _check("mask", mask, (tiles.count, *shape), device, torch.int32)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raise(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _tile_args(mask, tiles: RayTiles | None) -> tuple:
    """The C entry points' (mask, H, W, th): null for the unmasked
    kernels."""
    if mask is None:
        return None, 0, 0, 0
    return mask.data_ptr(), tiles.height, tiles.width, tiles.th


def pri_fwd_scratch(consts, chunk: int, dirs, mask=None,
                    tiles: RayTiles = None) -> torch.Tensor:
    """A fresh scratch buffer (uint8, on consts' device) for one K10a/K10b
    call on these inputs, sized by the kernels' library
    (csrc/soft_raytrace.cu::PriFwdCall): the plan, the staged rows and the
    items' partials."""
    H, W, th = ((tiles.height, tiles.width, tiles.th) if mask is not None
                else (0, 0, 0))
    n = _build.load().raytpu_soft_rt_pri_fwd_scratch(
        consts.shape[0], chunk, dirs.shape[1], int(mask is not None), H, W,
        th, PRI_FWD_RUN_MIN, PRI_FWD_ITEMS)
    if n < 0:
        raise ValueError(f"the primary forward takes no table of "
                         f"{consts.shape[0]} rows in chunks of {chunk} on "
                         f"{dirs.shape[1]} rays")
    return torch.empty((n,), dtype=torch.uint8, device=consts.device)


def launch_pri_fwd_kernel(consts, chunk: int, cam, dirs, es: float,
                          zs: float, out, m, s, mask=None,
                          tiles: RayTiles = None, *, scratch) -> None:
    """Launch K10a (mask None) or K10b (mask (n_tiles, n_chunks) over
    ``tiles``) with the scratch of pri_fwd_scratch: the plan, the rows'
    staging, the kernel and the merge of its items into the outputs the
    caller allocated. Checks nothing and counts nothing; the wrapper does
    both."""
    _raise("soft_rt_pri_fwd", _build.load().raytpu_soft_rt_pri_fwd(
        consts.data_ptr(), consts.shape[0], chunk, cam.data_ptr(),
        dirs.data_ptr(), dirs.shape[1], *_tile_args(mask, tiles), es, zs,
        PRI_FWD_RUN_MIN, PRI_FWD_ITEMS, scratch.data_ptr(), scratch.numel(),
        out.data_ptr(), m.data_ptr(), s.data_ptr(), _stream()))


def pri_items(n_tiles: int, n_chunks: int) -> int:
    """The most work items of a K10c/K10d call: every tile keeping every
    chunk, ceil(n_chunks / PRI_RUN) runs each (exactly K10c's items)."""
    return n_tiles * -(-n_chunks // PRI_RUN)


def pri_blocks(Tp: int, n_items: int, fit: int) -> int:
    """K10c's and K10d's blocks for a (Tp, 32) table with at most n_items
    work items, where the card holds ``fit`` blocks at once: at most the
    items, at most fit (a second wave's blocks would start their items when
    the first wave's are done) and PARTIAL_BYTES of (Tp, 18) partials."""
    return max(1, min(n_items, fit, PARTIAL_BYTES // (Tp * PRI_USED * 4)))


def pri_bwd_blocks(consts, chunk: int, n_tiles: int) -> int:
    """pri_blocks on the card (the library's raytpu_soft_rt_pri_bwd_fit, the
    same for both kernels, so that an all-ones mask and no mask take one
    grid) for a (Tp, 32) table in chunks of ``chunk`` and n_tiles tiles."""
    fit = _build.load().raytpu_soft_rt_pri_bwd_fit()
    if fit < 1:
        raise RuntimeError(f"soft_rt_pri_bwd: no block fits ({fit})")
    Tp = consts.shape[0]
    return pri_blocks(Tp, pri_items(n_tiles, Tp // chunk), fit)


def pri_scratch(consts, chunk: int, dirs, mask=None, tiles: RayTiles = None,
                *, blocks: int) -> torch.Tensor:
    """A fresh scratch buffer (uint8, on consts' device) for one K10c/K10d
    call on these inputs with ``blocks`` blocks, sized by the kernels'
    library (csrc/soft_raytrace.cu::PriCall)."""
    H, W, th = ((tiles.height, tiles.width, tiles.th) if mask is not None
                else (0, 0, 0))
    n = _build.load().raytpu_soft_rt_pri_scratch(
        consts.shape[0], chunk, dirs.shape[1], int(mask is not None), H, W,
        th, PRI_RUN, blocks)
    if n < 0:
        raise ValueError(f"the primary backward takes no table of "
                         f"{consts.shape[0]} rows in chunks of {chunk} on "
                         f"{dirs.shape[1]} rays and {blocks} blocks")
    return torch.empty((n,), dtype=torch.uint8, device=consts.device)


def launch_pri_bwd_kernel(consts, chunk: int, cam, dirs, es: float,
                          zs: float, m, cot, dc, dcam, dd, mask=None,
                          tiles: RayTiles = None, *, blocks: int,
                          scratch) -> None:
    """Launch K10c (K10d with a mask) with ``blocks`` blocks and the scratch
    of pri_scratch(blocks=blocks): the plan, the rows' staging, the kernel,
    the merge of its runs and the sums of its blocks' partials into dc (Tp,
    32), dcam (3,) and dd (3, R), all allocated by the caller. Checks
    nothing and counts nothing."""
    _raise("soft_rt_pri_bwd", _build.load().raytpu_soft_rt_pri_bwd(
        consts.data_ptr(), consts.shape[0], chunk, cam.data_ptr(),
        dirs.data_ptr(), dirs.shape[1], *_tile_args(mask, tiles), es, zs,
        m.data_ptr(), cot.data_ptr(), PRI_RUN, blocks, scratch.data_ptr(),
        scratch.numel(), dc.data_ptr(), dcam.data_ptr(), dd.data_ptr(),
        _stream()))


def shw_items(n_tiles: int, S: int, n_chunks: int) -> int:
    """The most work items of a K10g-K10j call: every (tile, source) pair
    keeping every chunk, ceil(n_chunks / SHW_RUN) runs each (exactly the
    unmasked kernels' items)."""
    return n_tiles * S * -(-n_chunks // SHW_RUN)


def shw_bwd_blocks(consts, chunk: int, n_tiles: int, S: int) -> int:
    """K10i's and K10j's blocks for a (Tp, 16) table in chunks of
    ``chunk``, n_tiles tiles and S sources: at most the work items
    (shw_items), as many as the card holds at once (a second wave's blocks
    would start their items when the first wave's are done; the library's
    raytpu_soft_rt_shw_bwd_fit, the same for both kernels, so that an
    all-ones mask and no mask take one grid), and PARTIAL_BYTES of
    (Tp, 14) partials."""
    Tp = consts.shape[0]
    fit = _build.load().raytpu_soft_rt_shw_bwd_fit(Tp // chunk)
    if fit < 1:
        raise RuntimeError(f"soft_rt_shw_bwd: no block fits ({fit})")
    return max(1, min(shw_items(n_tiles, S, Tp // chunk), fit,
                      PARTIAL_BYTES // (Tp * SHW_USED * 4)))


def _tile_count(R: int, mask, tiles: RayTiles | None) -> int:
    """The tiles the fused backwards (K10c, K10d, K10i, K10j) take: the
    mask's, or runs of THREADS consecutive rays or points."""
    return -(-R // THREADS) if mask is None else tiles.count


def shw_scratch(consts, chunk: int, srcs, world, mask=None,
                tiles: RayTiles = None, *, backward: bool,
                blocks: int = 0) -> torch.Tensor:
    """A fresh scratch buffer (uint8, on consts' device) for one K10g-K10j
    call on these inputs (K10i and K10j: with ``blocks`` blocks), sized by
    the kernels' library (csrc/soft_raytrace.cu::ShwCall)."""
    H, W, th = ((tiles.height, tiles.width, tiles.th) if mask is not None
                else (0, 0, 0))
    n = _build.load().raytpu_soft_rt_shw_scratch(
        consts.shape[0], chunk, srcs.shape[0], world.shape[1],
        int(mask is not None), H, W, th, SHW_RUN, int(backward), blocks)
    if n < 0:
        raise ValueError(f"the shadow kernels take no table of "
                         f"{consts.shape[0]} rows in chunks of {chunk} with "
                         f"{srcs.shape[0]} sources on {world.shape[1]} "
                         f"points and {blocks} blocks")
    return torch.empty((n,), dtype=torch.uint8, device=consts.device)


def launch_shw_fwd_kernel(consts, chunk: int, srcs, world, es: float,
                          zs: float, trans, mask=None,
                          tiles: RayTiles = None, *, scratch) -> None:
    """Launch K10g (K10h with a mask (n_tiles, S, n_chunks)) into trans
    (S, R), with the scratch of shw_scratch(backward=False). Checks nothing
    and counts nothing."""
    _raise("soft_rt_shw_fwd", _build.load().raytpu_soft_rt_shw_fwd(
        consts.data_ptr(), consts.shape[0], chunk, srcs.data_ptr(),
        srcs.shape[0], world.data_ptr(), world.shape[1],
        *_tile_args(mask, tiles), es, zs, SHW_RUN, scratch.data_ptr(),
        scratch.numel(), trans.data_ptr(), _stream()))


def launch_shw_bwd_kernel(consts, chunk: int, srcs, world, trans, gcot,
                          es: float, zs: float, dc, dsrc, dw, mask=None,
                          tiles: RayTiles = None, *, blocks: int,
                          scratch) -> None:
    """Launch K10i (K10j with a mask) with ``blocks`` blocks and the scratch
    of shw_scratch(backward=True, blocks=blocks), the merge of its runs and
    the sums of its blocks' partials into dc (Tp, 16), dsrc (S, 3) and dw
    (3, R). Checks nothing and counts nothing."""
    _raise("soft_rt_shw_bwd", _build.load().raytpu_soft_rt_shw_bwd(
        consts.data_ptr(), consts.shape[0], chunk, srcs.data_ptr(),
        srcs.shape[0], world.data_ptr(), world.shape[1],
        *_tile_args(mask, tiles), trans.data_ptr(), gcot.data_ptr(), es, zs,
        SHW_RUN, blocks, scratch.data_ptr(), scratch.numel(), dc.data_ptr(),
        dsrc.data_ptr(), dw.data_ptr(), _stream()))


def pri_bwd_tables_scratch(consts, dirs) -> tuple:
    """K10e's scratch for a (Tp, 32) table and dirs (3, R): the packed rays
    (ceil(R / RAY_TILE) RAY_TILE, RAY_PACKED), the runs' partials (splits,
    Tp, 18) and the blocks' camera sums (splits ceil(Tp / THREADS), 3),
    splits = min(TABLE_SPLITS, the ray tiles)."""
    Tp, R = consts.shape[0], dirs.shape[1]
    tiles = -(-R // RAY_TILE)
    splits = min(TABLE_SPLITS, tiles)
    return (consts.new_empty((tiles * RAY_TILE, RAY_PACKED)),
            consts.new_empty((splits, Tp, PRI_USED)),
            consts.new_empty((splits * -(-Tp // THREADS), 3)))


def launch_pri_bwd_tables_kernel(consts, chunk: int, cam, dirs, es: float,
                                 zs: float, m, cot, rays, partials,
                                 cam_partials, dc, dcam) -> None:
    """Launch K10e (the rays' packing, the kernel, the sums of its partials
    and camera sums) into dc (Tp, 32) and dcam (3,), with the scratch of
    pri_bwd_tables_scratch, all allocated by the caller. Checks nothing and
    counts nothing."""
    _raise("soft_rt_pri_bwd_tables",
           _build.load().raytpu_soft_rt_pri_bwd_tables(
               consts.data_ptr(), consts.shape[0], chunk, cam.data_ptr(),
               dirs.data_ptr(), dirs.shape[1], es, zs, m.data_ptr(),
               cot.data_ptr(), rays.data_ptr(), partials.shape[0],
               partials.data_ptr(), cam_partials.data_ptr(), dc.data_ptr(),
               dcam.data_ptr(), _stream()))


def launch_pri_bwd_dirs_kernel(consts, chunk: int, cam, dirs, es: float,
                               zs: float, m, cot, rows, dd) -> None:
    """Launch K10f (the table's staging into rows (Tp, ROW_STAGED) and the
    kernel, folding d dirs in K10c's runs of PRI_RUN chunks) into dd (3,
    R). Checks nothing and counts nothing."""
    _raise("soft_rt_pri_bwd_dirs", _build.load().raytpu_soft_rt_pri_bwd_dirs(
        consts.data_ptr(), consts.shape[0], chunk, cam.data_ptr(),
        dirs.data_ptr(), dirs.shape[1], es, zs, PRI_RUN, m.data_ptr(),
        cot.data_ptr(), rows.data_ptr(), dd.data_ptr(), _stream()))


def expf_probe(x: torch.Tensor) -> torch.Tensor:
    """expf of x (n,) float32 as the kernels compute it: on a CUDA tensor
    through the library's raytpu_soft_rt_expf (built with the kernels'
    flags), on a CPU tensor torch.exp. The tests' probe of the underflow
    that K10e's and K10f's early-out relies on."""
    if not _route(x):
        return torch.exp(x)
    _check("x", x, (x.numel(),), x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _raise("soft_rt_expf", _build.load().raytpu_soft_rt_expf(
            x.data_ptr(), x.numel(), out.data_ptr(), _stream()))
    return out


def sigmoid_probe(x: torch.Tensor) -> torch.Tensor:
    """sigmoid of x (n,) float32 as the kernels compute it, 1 / (1 +
    expf(-x)): on a CUDA tensor through the library's
    raytpu_soft_rt_sigmoid (built with the kernels' flags), on a CPU
    tensor torch.sigmoid. The tests' probe of the exact zero that K10k's
    and K10l's early-out relies on."""
    if not _route(x):
        return torch.sigmoid(x)
    _check("x", x, (x.numel(),), x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _raise("soft_rt_sigmoid", _build.load().raytpu_soft_rt_sigmoid(
            x.data_ptr(), x.numel(), out.data_ptr(), _stream()))
    return out


def shw_bwd_consts_scratch(consts, srcs, world) -> tuple:
    """K10k's scratch for a (Tp, 16) table, srcs (S, 3) and world (3, R):
    the packed points (S, ceil(R / POINT_TILE) POINT_TILE, POINT_PACKED)
    and the runs' partials (splits, Tp, 14), splits = min(SHW_SPLITS, the
    point tiles)."""
    tiles = -(-world.shape[1] // POINT_TILE)
    return (consts.new_empty((srcs.shape[0], tiles * POINT_TILE,
                              POINT_PACKED)),
            consts.new_empty((min(SHW_SPLITS, tiles), consts.shape[0],
                              SHW_USED)))


def launch_shw_bwd_consts_kernel(consts, chunk: int, srcs, world, trans,
                                 gcot, es: float, zs: float, pts, partials,
                                 dc) -> None:
    """Launch K10k (the points' packing, the kernel, the sum of its runs'
    partials) into dc (Tp, 16), with the scratch of shw_bwd_consts_scratch
    (its runs, partials.shape[0]), all allocated by the caller. Checks
    nothing and counts nothing."""
    _raise("soft_rt_shw_bwd_consts",
           _build.load().raytpu_soft_rt_shw_bwd_consts(
               consts.data_ptr(), consts.shape[0], chunk, srcs.data_ptr(),
               srcs.shape[0], world.data_ptr(), world.shape[1],
               trans.data_ptr(), gcot.data_ptr(), es, zs, pts.data_ptr(),
               partials.shape[0], partials.data_ptr(), dc.data_ptr(),
               _stream()))


def launch_shw_bwd_rays_kernel(consts, chunk: int, srcs, world, trans, gcot,
                               es: float, zs: float, rows, src_partials,
                               dsrc, dw) -> None:
    """Launch K10l (the table's staging into rows (S, Tp, SHW_STAGED), the
    kernel, the sum of its (ceil(R / 256), S, 3) source partials) into dsrc
    (S, 3) and dw (3, R), its scratch allocated by the caller; d world
    folds its chunks in K10i's runs of SHW_RUN. Checks nothing and counts
    nothing."""
    _raise("soft_rt_shw_bwd_rays", _build.load().raytpu_soft_rt_shw_bwd_rays(
        consts.data_ptr(), consts.shape[0], chunk, srcs.data_ptr(),
        srcs.shape[0], world.data_ptr(), world.shape[1], trans.data_ptr(),
        gcot.data_ptr(), es, zs, SHW_RUN, rows.data_ptr(),
        src_partials.data_ptr(), dsrc.data_ptr(), dw.data_ptr(), _stream()))


def primary_agg_fwd(consts: torch.Tensor, cam: torch.Tensor,
                    dirs: torch.Tensor, es: float, zs: float, chunk: int,
                    mask=None, tiles: RayTiles = None):
    """K10a's wrapper, K10b's with a mask: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. consts (Tp, 32) in chunks
    of ``chunk`` <= 32 rows, cam (3,), dirs (3, R); mask (n_tiles,
    n_chunks) int32 over ``tiles``, the R rays' tiles. Returns out (9, R),
    m (R,), s (R,)."""
    global LAUNCHES_SRT_PRI_FWD, LAUNCHES_SRT_PRI_FWD_MASKED
    if not _route(consts):
        return primary_agg_reference(consts, cam, dirs, es, zs, chunk, mask,
                                     tiles)
    _check_table(consts, PRI_COLS, chunk)
    _check("cam", cam, (3,), consts.device)
    R = dirs.shape[1] if dirs.dim() == 2 else -1
    _check("dirs", dirs, (3, R), consts.device)
    if mask is not None:
        _check_mask(mask, tiles, R, (consts.shape[0] // chunk,),
                    consts.device)
    out = dirs.new_empty((N_OUT, R))
    m, s = dirs.new_empty(R), dirs.new_empty(R)
    with torch.cuda.device(consts.device):
        launch_pri_fwd_kernel(
            consts, chunk, cam, dirs, es, zs, out, m, s, mask, tiles,
            scratch=pri_fwd_scratch(consts, chunk, dirs, mask, tiles))
    if mask is None:
        LAUNCHES_SRT_PRI_FWD += 1
    else:
        LAUNCHES_SRT_PRI_FWD_MASKED += 1
    return out, m, s


def primary_agg_bwd(consts, cam, dirs, m, cot, es: float, zs: float,
                    chunk: int, mask=None, tiles: RayTiles = None):
    """K10c's wrapper, K10d's with a mask: the CUDA kernels for CUDA
    tensors, the plain version for CPU tensors. m (R,) the forward's saved
    max, cot (10, R) = [d s, d acc_0..8]; the rest as primary_agg_fwd.
    Above JAX's fused limit (pri_two_launch) the two-launch route instead,
    K10e and K10f (primary_bwd_tables, primary_bwd_dirs), which ignores
    ``mask`` and ``tiles`` as ``_pri_bwd_impl`` does. Returns d consts (Tp,
    32, zero in columns 18-31), d cam (3,) and d dirs (3, R)."""
    global LAUNCHES_SRT_PRI_BWD, LAUNCHES_SRT_PRI_BWD_MASKED
    two = pri_two_launch(consts.shape[0])
    if two:
        mask = tiles = None
    if not _route(consts):
        return primary_agg_bwd_reference(consts, cam, dirs, m, cot, es, zs,
                                         chunk, mask=mask, tiles=tiles)
    if two:
        dc, dcam = primary_bwd_tables(consts, cam, dirs, m, cot, es, zs,
                                      chunk)
        return dc, dcam, primary_bwd_dirs(consts, cam, dirs, m, cot, es, zs,
                                          chunk)
    R = _check_pri_bwd(consts, cam, dirs, m, cot, chunk)
    Tp = consts.shape[0]
    if mask is not None:
        _check_mask(mask, tiles, R, (Tp // chunk,), consts.device)
    dc, dcam, dd = (torch.empty_like(consts), torch.empty_like(cam),
                    torch.empty_like(dirs))
    with torch.cuda.device(consts.device):
        blocks = pri_bwd_blocks(consts, chunk, _tile_count(R, mask, tiles))
        launch_pri_bwd_kernel(
            consts, chunk, cam, dirs, es, zs, m, cot, dc, dcam, dd, mask,
            tiles, blocks=blocks,
            scratch=pri_scratch(consts, chunk, dirs, mask, tiles,
                                blocks=blocks))
    if mask is None:
        LAUNCHES_SRT_PRI_BWD += 1
    else:
        LAUNCHES_SRT_PRI_BWD_MASKED += 1
    return dc, dcam, dd


def shadow_trans_fwd(consts: torch.Tensor, srcs: torch.Tensor,
                     world: torch.Tensor, es: float, zs: float,
                     chunk: int, mask=None,
                     tiles: RayTiles = None) -> torch.Tensor:
    """K10g's wrapper, K10h's with a mask: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. consts (Tp, 16) in chunks
    of ``chunk`` <= 32 rows, srcs (S, 3), world (3, R); mask (n_tiles, S,
    n_chunks) int32 over ``tiles``. Returns trans (S, R)."""
    global LAUNCHES_SRT_SHW_FWD, LAUNCHES_SRT_SHW_FWD_MASKED
    if not _route(consts):
        return shadow_trans_reference(consts, srcs, world, es, zs, chunk,
                                      mask, tiles)
    _check_table(consts, SHW_COLS, chunk)
    S = srcs.shape[0] if srcs.dim() == 2 else -1
    _check("srcs", srcs, (S, 3), consts.device)
    R = world.shape[1] if world.dim() == 2 else -1
    _check("world", world, (3, R), consts.device)
    if mask is not None:
        _check_mask(mask, tiles, R, (S, consts.shape[0] // chunk),
                    consts.device)
    trans = world.new_empty((S, R))
    with torch.cuda.device(consts.device):
        launch_shw_fwd_kernel(
            consts, chunk, srcs, world, es, zs, trans, mask, tiles,
            scratch=shw_scratch(consts, chunk, srcs, world, mask, tiles,
                                backward=False))
    if mask is None:
        LAUNCHES_SRT_SHW_FWD += 1
    else:
        LAUNCHES_SRT_SHW_FWD_MASKED += 1
    return trans


def shadow_trans_bwd(consts, srcs, world, trans, gcot, es: float, zs: float,
                     chunk: int, mask=None, tiles: RayTiles = None):
    """K10i's wrapper, K10j's with a mask: the CUDA kernels for CUDA
    tensors, the plain version for CPU tensors. trans (S, R) the forward's
    output, gcot (S, R) its cotangent; the rest as shadow_trans_fwd. Above
    JAX's limit (shw_two_launch) the two-launch route instead, K10k and
    K10l (shadow_bwd_consts, shadow_bwd_rays), which ignores ``mask`` and
    ``tiles`` as ``_shadow_bwd`` does. Returns d consts (Tp, 16, zero in
    columns 14-15), d srcs (S, 3) and d world (3, R)."""
    global LAUNCHES_SRT_SHW_BWD, LAUNCHES_SRT_SHW_BWD_MASKED
    two = shw_two_launch(consts.shape[0])
    if two:
        mask = tiles = None
    if not _route(consts):
        return shadow_trans_bwd_reference(consts, srcs, world, trans, gcot,
                                          es, zs, chunk, mask=mask,
                                          tiles=tiles)
    if two:
        dc = shadow_bwd_consts(consts, srcs, world, trans, gcot, es, zs,
                               chunk)
        return (dc, *shadow_bwd_rays(consts, srcs, world, trans, gcot, es,
                                     zs, chunk))
    S, R = _check_shw_bwd(consts, srcs, world, trans, gcot, chunk)
    Tp = consts.shape[0]
    if mask is not None:
        _check_mask(mask, tiles, R, (S, Tp // chunk), consts.device)
    blocks = shw_bwd_blocks(consts, chunk, _tile_count(R, mask, tiles), S)
    dc, dsrc, dw = (torch.empty_like(consts), torch.empty_like(srcs),
                    torch.empty_like(world))
    with torch.cuda.device(consts.device):
        launch_shw_bwd_kernel(
            consts, chunk, srcs, world, trans, gcot, es, zs, dc, dsrc, dw,
            mask, tiles, blocks=blocks,
            scratch=shw_scratch(consts, chunk, srcs, world, mask, tiles,
                                backward=True, blocks=blocks))
    if mask is None:
        LAUNCHES_SRT_SHW_BWD += 1
    else:
        LAUNCHES_SRT_SHW_BWD_MASKED += 1
    return dc, dsrc, dw


def primary_bwd_tables(consts, cam, dirs, m, cot, es: float, zs: float,
                       chunk: int):
    """K10e's wrapper: the CUDA kernel for CUDA tensors, for CPU tensors the
    unmasked primary_agg_bwd_reference's first two results; inputs as primary_agg_bwd's, no mask. Returns d consts
    (Tp, 32, zero in columns 18-31) and d cam (3,)."""
    global LAUNCHES_SRT_PRI_BWD_TABLES
    if not _route(consts):
        return primary_agg_bwd_reference(consts, cam, dirs, m, cot, es, zs,
                                         chunk)[:2]
    _check_pri_bwd(consts, cam, dirs, m, cot, chunk)
    scratch = pri_bwd_tables_scratch(consts, dirs)
    dc, dcam = torch.empty_like(consts), torch.empty_like(cam)
    with torch.cuda.device(consts.device):
        launch_pri_bwd_tables_kernel(consts, chunk, cam, dirs, es, zs, m, cot,
                                     *scratch, dc, dcam)
    LAUNCHES_SRT_PRI_BWD_TABLES += 1
    return dc, dcam


def primary_bwd_dirs(consts, cam, dirs, m, cot, es: float, zs: float,
                     chunk: int) -> torch.Tensor:
    """K10f's wrapper: the CUDA kernel for CUDA tensors, for CPU tensors the
    unmasked primary_agg_bwd_reference's last result; inputs as primary_agg_bwd's, no mask. Returns d dirs
    (3, R)."""
    global LAUNCHES_SRT_PRI_BWD_DIRS
    if not _route(consts):
        return primary_agg_bwd_reference(consts, cam, dirs, m, cot, es, zs,
                                         chunk)[2]
    _check_pri_bwd(consts, cam, dirs, m, cot, chunk)
    rows = consts.new_empty((consts.shape[0], ROW_STAGED))
    dd = torch.empty_like(dirs)
    with torch.cuda.device(consts.device):
        launch_pri_bwd_dirs_kernel(consts, chunk, cam, dirs, es, zs, m, cot,
                                   rows, dd)
    LAUNCHES_SRT_PRI_BWD_DIRS += 1
    return dd


def shadow_bwd_consts(consts, srcs, world, trans, gcot, es: float, zs: float,
                      chunk: int) -> torch.Tensor:
    """K10k's wrapper: the CUDA kernel for CUDA tensors, for CPU tensors the
    unmasked shadow_trans_bwd_reference's first result; inputs as shadow_trans_bwd's, no mask. Returns d
    consts (Tp, 16, zero in columns 14-15)."""
    global LAUNCHES_SRT_SHW_BWD_CONSTS
    if not _route(consts):
        return shadow_trans_bwd_reference(consts, srcs, world, trans, gcot,
                                          es, zs, chunk)[0]
    _check_shw_bwd(consts, srcs, world, trans, gcot, chunk)
    scratch = shw_bwd_consts_scratch(consts, srcs, world)
    dc = torch.empty_like(consts)
    with torch.cuda.device(consts.device):
        launch_shw_bwd_consts_kernel(consts, chunk, srcs, world, trans, gcot,
                                     es, zs, *scratch, dc)
    LAUNCHES_SRT_SHW_BWD_CONSTS += 1
    return dc


def shadow_bwd_rays(consts, srcs, world, trans, gcot, es: float, zs: float,
                    chunk: int):
    """K10l's wrapper: the CUDA kernel for CUDA tensors, for CPU tensors the
    unmasked shadow_trans_bwd_reference's last two results; inputs as shadow_trans_bwd's, no mask. Returns d srcs
    (S, 3) and d world (3, R)."""
    global LAUNCHES_SRT_SHW_BWD_RAYS
    if not _route(consts):
        return shadow_trans_bwd_reference(consts, srcs, world, trans, gcot,
                                          es, zs, chunk)[1:]
    S, R = _check_shw_bwd(consts, srcs, world, trans, gcot, chunk)
    rows = consts.new_empty((S, consts.shape[0], SHW_STAGED))
    src_partials = consts.new_empty((-(-R // THREADS), S, 3))
    dsrc, dw = torch.empty_like(srcs), torch.empty_like(world)
    with torch.cuda.device(consts.device):
        launch_shw_bwd_rays_kernel(consts, chunk, srcs, world, trans, gcot,
                                   es, zs, rows, src_partials, dsrc, dw)
    LAUNCHES_SRT_SHW_BWD_RAYS += 1
    return dsrc, dw


def primary_cot(g: torch.Tensor, out: torch.Tensor, s: torch.Tensor,
                g_s: torch.Tensor | None = None) -> torch.Tensor:
    """The 10 cotangent rows [d s, d acc_0..8] of out = acc / s
    (``_primary_cot``): d acc_j = g_j / s, d s = -(g . out) / s, plus the
    cotangent g_s (R,) of s itself where s is an output."""
    srec = 1.0 / s
    ds = -(g * out).sum(dim=0, keepdim=True) * srec
    if g_s is not None:
        ds = ds + g_s[None, :]
    return torch.cat([ds, g * srec]).contiguous()


class PrimaryAgg(torch.autograd.Function):
    """out (9, R) of the (Tp, 32) table (``_primary_agg``), differentiable
    in consts, the camera position and the ray directions (3, R); the
    backward runs K10c, or K10d with the forward's mask, or above JAX's
    fused limit K10e + K10f without it (or their plain versions). The mask
    and its tiles take no gradient (``_mask_cot``)."""

    @staticmethod
    def forward(ctx, consts, cam, dirs, es: float, zs: float, chunk: int,
                mask=None, tiles: RayTiles = None):
        out, m, s = primary_agg_fwd(consts, cam, dirs, es, zs, chunk, mask,
                                    tiles)
        ctx.save_for_backward(consts, cam, dirs, out, m, s)
        ctx.args = (es, zs, chunk)
        ctx.cull = (mask, tiles)
        return out

    @staticmethod
    def backward(ctx, g):
        consts, cam, dirs, out, m, s = ctx.saved_tensors
        mask, tiles = ctx.cull
        dc, dcam, dd = primary_agg_bwd(consts, cam, dirs, m,
                                       primary_cot(g, out, s), *ctx.args,
                                       mask=mask, tiles=tiles)
        return dc, dcam, dd, None, None, None, None, None


class PrimaryAggStats(torch.autograd.Function):
    """(out, m, s) of PrimaryAgg's inputs, unmasked
    (``_primary_agg_stats``): out and s are differentiable in consts, the
    camera position and the ray directions, m is not. The backward takes
    s's cotangent into the d s row and drops m's, exact where the caller
    uses (m, s) only through s * exp(m - M) with M held constant, as the
    sharded soft combine does (kernels/soft_raster.py::SoftAggStats)."""

    @staticmethod
    def forward(ctx, consts, cam, dirs, es: float, zs: float, chunk: int):
        out, m, s = primary_agg_fwd(consts, cam, dirs, es, zs, chunk)
        ctx.save_for_backward(consts, cam, dirs, out, m, s)
        ctx.args = (es, zs, chunk)
        ctx.mark_non_differentiable(m)
        return out, m, s

    @staticmethod
    def backward(ctx, g, _g_m, g_s):
        consts, cam, dirs, out, m, s = ctx.saved_tensors
        dc, dcam, dd = primary_agg_bwd(consts, cam, dirs, m,
                                       primary_cot(g, out, s, g_s),
                                       *ctx.args)
        return dc, dcam, dd, None, None, None


class ShadowTrans(torch.autograd.Function):
    """trans (S, R) from each source (S, 3) to each world point (3, R)
    (``_shadow_trans``), differentiable in all three; the backward runs
    K10i, or K10j with the forward's mask, or above JAX's limit K10k + K10l
    without it (or their plain versions). The mask and its tiles take no
    gradient."""

    @staticmethod
    def forward(ctx, consts, srcs, world, es: float, zs: float, chunk: int,
                mask=None, tiles: RayTiles = None):
        trans = shadow_trans_fwd(consts, srcs, world, es, zs, chunk, mask,
                                 tiles)
        ctx.save_for_backward(consts, srcs, world, trans)
        ctx.args = (es, zs, chunk)
        ctx.cull = (mask, tiles)
        return trans

    @staticmethod
    def backward(ctx, g):
        consts, srcs, world, trans = ctx.saved_tensors
        mask, tiles = ctx.cull
        dc, dsrc, dw = shadow_trans_bwd(consts, srcs, world, trans,
                                        g.contiguous(), *ctx.args, mask=mask,
                                        tiles=tiles)
        return dc, dsrc, dw, None, None, None, None, None
