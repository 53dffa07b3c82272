"""The soft (differentiable) rasterizer's aggregation (counterpart of
raytpu/kernels/soft_raster_pallas.py).

Per pixel, a softmax over every triangle's logit
``zs * zpx + log_sigmoid(es * sdist) + log(valid + 1e-20)`` and a
background hypothesis (logit 0, the cleared depth buffer,
`rasteriser.cpp:188`) aggregates 10 attribute channels [albedo rgb, pos3d
numerator xyz, zinv, normal xyz]; shading runs once per pixel on the
aggregate outside (render/soft.py::shade_agg_raster). The triangles come as
the (Tp, 32) table of ``soft_tri_constants``, in chunks of ``chunk`` <= 32
rows; the softmax is JAX's chunk-by-chunk online form (a chunk's max, one
rescale of the carry, then the chunk's sums).

  soft_agg_fwd   K9a's wrapper (no mask) and K9b's (a (tile, chunk) keep
                 mask over 16 x 16 pixel tiles): agg (10, R), m, s.
  soft_row_dead  the plain form of their exact dead-row test (a row of
                 weight exactly 0 at every pixel of a warp's 8 x 4 block);
                 soft_row_dead_probe runs the card's.
  soft_agg_bwd   K9c's and K9d's: d consts from the saved m and the 11
                 cotangent rows [d s, d acc_0..9].
  *_reference    their plain PyTorch versions.
  SoftAgg        the torch.autograd.Function around them (``_soft_agg``).
  SoftAggStats   the same returning (agg, m, s) (``_soft_agg_stats``), for
                 the sharded soft combine (raytpu_torch/parallel/render.py).

On CUDA tensors the wrappers launch the hand-written kernels
(raytpu_torch/csrc/soft_raster.cu); on CPU tensors they run the plain
versions. The frame that assembles them is render/soft.py::rasterize_soft.
Every function takes the image's first row ``y0``: the H x W image is rows
[y0, y0 + H) of the frame (pixel y = y0 + row), as the sharded soft
rasterizer's row blocks are; the masks are over the image's own tiles. The
JAX kernels also take the camera-globals and lights tables,
which ``_chunk_terms`` never reads (ROADMAP fault F3; ``jax.grad`` gives
them exactly zero): the port's kernels take neither.

The running max m is a constant of the backward: the image acc / s does not
depend on it (soft_raster_pallas.py:20-27).
"""

from __future__ import annotations

import functools
import math

import torch

from raytpu_torch.core.types import pixel_grid
from raytpu_torch.kernels import _build
from raytpu_torch.kernels.raster import TILE, _route, tile_rects

# Launches of each CUDA kernel in this process, counted by its wrapper where
# it launches the kernel and nowhere else. A backward launch is K9c's (or
# K9d's) four kernels: the kept-tile lists, the work items, the pass over
# the items and the fixed-order sum of their partials.
LAUNCHES_SOFT_FWD = 0          # K9a, by soft_agg_fwd without a mask
LAUNCHES_SOFT_FWD_MASKED = 0   # K9b, by soft_agg_fwd with a mask
LAUNCHES_SOFT_BWD = 0          # K9c, by soft_agg_bwd without a mask
LAUNCHES_SOFT_BWD_MASKED = 0   # K9d, by soft_agg_bwd with a mask

CONST_COLS = 32
N_CH = 10
MAX_CHUNK = 32
# ln(1e-20): a culled (tile, chunk) pair's weight is at most exp(-46) of the
# background hypothesis, the size the kernel already treats as zero.
CULL_MARGIN = 46.0
# K9a and K9b cut each tile's kept chunks (K9a: every chunk) into runs, a
# work item each, by K10a's rule (csrc/work_items.cuh::pri_fwd_run;
# soft_fwd_run below): the mean kept chunks a tile (rounded up) over
# ceil(SOFT_FWD_ITEMS / tiles), at least SOFT_FWD_RUN_MIN. At 512^2 and
# above K9a keeps one run a tile (no merge); K9b's tiles of more than the
# mean are cut, so the few tiles that hold the mesh spread over the card.
# The kernels hold the rule as constants (csrc/soft_raster.cu::
# kSoftFwdItems, kSoftFwdRunMin, K10b's values); these two mirror them for
# the plain count of the items.
SOFT_FWD_ITEMS = 1024
SOFT_FWD_RUN_MIN = 8
# The JAX package decides whether to cull by whether the image blocks into
# its 1,024-pixel tiles (trap: 500^2 does not, 512^2 does); the port keeps
# that decision, though its own tiles are 16 x 16.
JAX_TILE_P = 1024
# K9c and K9d stop a (pixel, row) pair whose logit bound lies more than
# this below the pixel's saved max: its weight is exactly 0 (float32 expf
# underflows to 0 below about -103.97; soft_dead_pairs,
# csrc/soft_raster.cu::soft_pair_dead). Only rows and pixels whose inputs
# lie within TAME in magnitude qualify, so that no 0 * inf arises. zb, the
# bound of zs * zpx, is |zs| max|zinv| times Z_SLACK (above the 8 ulps of
# rounding zpx can gather), at least Z_FLOOR.
DEAD_BELOW = -110.0
TAME = 2.0 ** 40
Z_SLACK = 1.0 + 2.0 ** -16
Z_FLOOR = 2.0 ** -99


def _sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The float32 square root rounded once from float64: correctly rounded,
    as XLA's and CUDA's are (PyTorch's CPU sqrt can be an ulp off, ROADMAP
    fault F4)."""
    return torch.sqrt(x.double()).to(x.dtype)


def soft_tri_constants(sx, sy, zinv, pos3d, color, normal, keep):
    """The kernels' (T, 32) float32 rows (``soft_tri_constants`` of the JAX
    package): sx, sy, zinv (T, 3) screen vertices and vertex 1/z; pos3d
    (T, 3, 3) camera-space position / z; color, normal (T, 3); keep (T,).

      0-5   ax ay bx by cx cy          13-21 pos3d row-major
      6-8   orient / (|edge_k| + 1e-12) 22-24 albedo rgb
      9     1 / area_safe               25-27 normal xyz
      10-12 vertex zinv                 28    valid = keep * (|area| > 1e-4)
      29-31 zero
    """
    ax, ay = sx[:, 0], sy[:, 0]
    bx, by = sx[:, 1], sy[:, 1]
    cx, cy = sx[:, 2], sy[:, 2]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    area_ok = area.abs() > 1e-4
    area_safe = torch.where(area.abs() > 1e-12, area, 1e-12)
    orient = torch.sign(area_safe)

    def edge_scale(x0, y0, x1, y1):
        ex = x1 - x0
        ey = y1 - y0
        # sqrt(0) guarded: its derivative would NaN the gradients of
        # degenerate (padding) edges, whose edge value is 0 anyway.
        n2 = ex * ex + ey * ey
        return orient / (_sqrt_f32(torch.where(n2 > 0.0, n2, 1.0)) + 1e-12)

    valid = keep * area_ok.to(torch.float32)
    cols = [ax, ay, bx, by, cx, cy,
            edge_scale(ax, ay, bx, by), edge_scale(bx, by, cx, cy),
            edge_scale(cx, cy, ax, ay),
            1.0 / area_safe,
            zinv[:, 0], zinv[:, 1], zinv[:, 2],
            *pos3d.reshape(-1, 9).unbind(1),
            *color.unbind(1), *normal.unbind(1), valid]
    zeros = torch.zeros_like(ax)
    cols += [zeros] * (CONST_COLS - len(cols))
    return torch.stack(cols, dim=1)


class Kinks:
    """The branch decisions of ``chunk_terms``, recorded on one evaluation
    and replayed on another.

    chunk_terms has kinks where its derivative jumps: the minimum of two
    values, clip01's bounds, |x| and the inside test. Where a pixel sits on
    a kink in exact arithmetic (an edge through a pixel, a barycentric of
    exactly 0), rounding picks the side, so a float64 evaluation can take
    another branch than the float32 kernel and differ from it by a whole
    pair's gradient. Recorded on a float32 evaluation and replayed in
    float64, the decisions give the float64 reference of the kernel's own
    branches (``soft_agg_bwd_reference(branches_from=...)``). A minimum's
    decision is the weight of its first argument: 1 where it is the
    smaller, 1/2 on a tie (the gradient's split), 0 else."""

    def __init__(self):
        self.decisions = []
        self.replaying = False
        self._next = 0

    def replay(self) -> "Kinks":
        self.replaying, self._next = True, 0
        return self

    def decide(self, make):
        if self.replaying:
            self._next += 1
            return self.decisions[self._next - 1]
        self.decisions.append(make())
        return self.decisions[-1]


def minimum(a, b, kinks: Kinks | None = None):
    """``torch.minimum`` (half the gradient to each side of a tie, as
    ``jnp.minimum``); replaying ``kinks``, the recorded weighting."""
    if kinks is None:
        return torch.minimum(a, b)
    w = kinks.decide(lambda: torch.where(a < b, 1.0,
                                         torch.where(a == b, 0.5, 0.0)))
    if not kinks.replaying:
        return torch.minimum(a, b)
    w = w.to(a.dtype)
    return w * a + (1.0 - w) * b


def clip01(x: torch.Tensor, kinks: Kinks | None = None) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)``: maximum then minimum, each passing half the
    gradient on a tie, as JAX's do (``torch.clamp`` passes all of it)."""
    zeros = torch.zeros_like(x)
    return minimum(-minimum(-x, zeros, kinks), zeros + 1.0, kinks)


def absolute(x: torch.Tensor, kinks: Kinks | None = None) -> torch.Tensor:
    """``x.abs()``; replaying ``kinks``, the recorded sign times x."""
    if kinks is None:
        return x.abs()
    sign = kinks.decide(lambda: torch.sign(x))
    return sign.to(x.dtype) * x if kinks.replaying else x.abs()


def log_sigmoid(x: torch.Tensor, kinks: Kinks | None = None) -> torch.Tensor:
    """``jax.nn.log_sigmoid`` op by op, ``min(x, 0) - log1p(exp(-|x|))``;
    its derivative is sigmoid(-x) (one half at 0, through the tie)."""
    return minimum(x, torch.zeros_like(x), kinks) - torch.log1p(
        torch.exp(-absolute(x, kinks)))


def chunk_terms(cs: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                es: float, zs: float, kinks: Kinks | None = None):
    """Per-(row, pixel) logit and the 10 attribute values of one chunk
    (``_chunk_terms``): cs (C, 32), px, py (P,). Returns (logit (C, P),
    vals), vals[j] (C, P) or (C, 1) where a value is the row's own.
    ``kinks`` records or replays the branch decisions (Kinks)."""
    def col(j):
        return cs[:, j:j + 1]

    px = px[None, :]
    py = py[None, :]
    ax, ay, bx, by, cx, cy = (col(j) for j in range(6))

    def edge_raw(x0, y0, x1, y1):
        return (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)

    # Raw edge values double as barycentric numerators (`:179-182`).
    r0 = edge_raw(ax, ay, bx, by)
    r1 = edge_raw(bx, by, cx, cy)
    r2 = edge_raw(cx, cy, ax, ay)
    hp_min = minimum(minimum(r0 * col(6), r1 * col(7), kinks), r2 * col(8),
                     kinks)

    def seg2(x0, y0, x1, y1):
        ex = x1 - x0
        ey = y1 - y0
        rec = 1.0 / (ex * ex + ey * ey + 1e-12)
        tpar = clip01(((px - x0) * ex + (py - y0) * ey) * rec, kinks)
        dx = px - (x0 + tpar * ex)
        dy = py - (y0 + tpar * ey)
        return dx * dx + dy * dy + 1e-20

    seg_min = torch.sqrt(minimum(
        minimum(seg2(ax, ay, bx, by), seg2(bx, by, cx, cy), kinks),
        seg2(cx, cy, ax, ay), kinks))
    inside = hp_min >= 0.0 if kinks is None else kinks.decide(
        lambda: hp_min >= 0.0)
    sdist = torch.where(inside, hp_min, -seg_min)

    l0 = r1 * col(9)
    l1 = r2 * col(9)
    l2 = 1.0 - l0 - l1
    l0c, l1c, l2c = clip01(l0, kinks), clip01(l1, kinks), clip01(l2, kinks)
    lrec = 1.0 / (l0c + l1c + l2c + 1e-12)
    l0c, l1c, l2c = l0c * lrec, l1c * lrec, l2c * lrec
    zpx = l0c * col(10) + l1c * col(11) + l2c * col(12)
    logit = (zs * zpx + log_sigmoid(es * sdist, kinks)
             + torch.log(col(28) + 1e-20))
    pnum = [l0c * col(13 + j) + l1c * col(16 + j) + l2c * col(19 + j)
            for j in range(3)]
    vals = [col(22 + j) for j in range(3)] + pnum + [zpx] + [
        col(25 + j) for j in range(3)]
    return logit, vals


def _chunks_kept(mask, n_chunks: int) -> list:
    """Which chunks any pixel keeps (all of them without a mask), read once
    on the host."""
    if mask is None:
        return [True] * n_chunks
    return mask.any(dim=1).tolist()


def soft_agg_reference(consts, coords, mask, es: float, zs: float,
                       chunk: int, dead_rows=None, stats=None):
    """Plain PyTorch version of K9a (mask None) and K9b, on any device and
    in any float type: consts (Tp, 32) in chunks of ``chunk`` rows, coords
    (2, R) pixel x, y, mask None or (n_chunks, R) bool (the keep-mask
    expanded to pixels). A chunk a pixel does not keep leaves its carry
    exactly as it was. Returns agg (10, R), m (R,), s (R,).

    dead_rows: None, or tile_layout's (block, rect) for these pixels: each
    chunk then leaves out, for each pixel block, the rows soft_row_dead
    finds dead at the block's floor (the smallest running max of its
    pixels), as the kernels do; the result is the same, bit for bit
    (float32). stats: None, or a dict to which the walk adds ``rows`` (the
    kept (block, row) pairs tested, blocks with pixels only), ``dead``
    (those found dead) and ``live_pairs`` (each block's pixels times its
    live rows)."""
    px, py = coords[0], coords[1]
    R = px.shape[0]
    m = px.new_zeros(R)
    s = px.new_ones(R)
    acc = px.new_zeros(N_CH, R)
    n_chunks = consts.shape[0] // chunk
    if dead_rows is not None:
        block, rect = dead_rows
        n_blocks = rect[0].shape[0]
        pixels = torch.bincount(block, minlength=n_blocks).to(px.dtype)
    for c, kept in enumerate(_chunks_kept(mask, n_chunks)):
        if not kept:
            continue
        logit, vals = chunk_terms(consts[c * chunk:(c + 1) * chunk], px, py,
                                  es, zs)
        if dead_rows is not None:
            floor = px.new_full((n_blocks,), math.inf).scatter_reduce(
                0, block, m, "amin")
            dead = soft_row_dead(consts[c * chunk:(c + 1) * chunk], rect, es,
                                 zs, floor)
            logit = torch.where(dead[:, block], -math.inf, logit)
            if stats is not None:
                on = pixels > 0
                if mask is not None:
                    on = torch.zeros_like(on).index_fill_(
                        0, torch.unique(block[mask[c]]), True)
                d = dead[:, on]
                stats["rows"] = stats.get("rows", 0) + d.numel()
                stats["dead"] = stats.get("dead", 0) + int(d.sum())
                stats["live_pairs"] = stats.get("live_pairs", 0) + int(
                    ((~d).to(px.dtype) * pixels[on][None, :]).sum())
        m_new = torch.maximum(m, logit.max(dim=0).values)
        scale = torch.exp(m - m_new)
        w = torch.exp(logit - m_new)
        s_new = s * scale + w.sum(dim=0)
        acc_new = acc * scale + torch.stack([(w * v).sum(dim=0)
                                             for v in vals])
        if mask is None:
            m, s, acc = m_new, s_new, acc_new
        else:
            keep = mask[c]
            m = torch.where(keep, m_new, m)
            s = torch.where(keep, s_new, s)
            acc = torch.where(keep, acc_new, acc)
    return acc * (1.0 / s), m, s


def soft_agg_bwd_reference(consts, coords, mask, m, cot, es: float,
                           zs: float, chunk: int, branches_from=None,
                           drop=None) -> torch.Tensor:
    """Plain PyTorch version of K9c (mask None) and K9d, on any device and
    in any float type: each chunk recomputed at the saved m (R,), a
    constant, and differentiated by autograd against the cotangent rows cot
    (11, R) = [d s, d acc_0..9], as ``_bwd_kernel``'s in-kernel ``jax.vjp``
    does. Pairs a mask drops take no part. Returns d consts (Tp, 32).

    branches_from: None, or a float32 table of the same rows whose branch
    decisions (Kinks) the evaluation takes, for a float64 reference of the
    float32 kernel. drop: None, or (Tp, R) bool pairs left out as a mask
    leaves them out (the tests' model of the kernels' skipped pairs)."""
    px, py = coords[0], coords[1]
    dc = torch.zeros_like(consts)
    n_chunks = consts.shape[0] // chunk
    with torch.enable_grad():
        for c, kept in enumerate(_chunks_kept(mask, n_chunks)):
            if not kept:
                continue
            rows = slice(c * chunk, (c + 1) * chunk)
            kinks = None
            if branches_from is not None:
                kinks = Kinks()
                with torch.no_grad():
                    chunk_terms(branches_from[rows], px.float(), py.float(),
                                es, zs, kinks)
                kinks.replay()
            cs = consts[rows].detach().requires_grad_()
            logit, vals = chunk_terms(cs, px, py, es, zs, kinks)
            w = torch.exp(logit - m)
            if mask is not None:
                w = torch.where(mask[c], w, 0.0)
            if drop is not None:
                w = torch.where(drop[rows], 0.0, w)
            outs = [w.sum(dim=0)] + [(w * v).sum(dim=0) for v in vals]
            (dc[rows],) = torch.autograd.grad(
                outs, cs, grad_outputs=list(cot))
    return dc


def soft_logit_bound(cs, coords, es: float, zs: float) -> torch.Tensor:
    """The bound B >= logit of K9c's and K9d's dead test
    (csrc/soft_raster.cu::soft_pair_dead) in its operations' order, (C, P)
    float32: ``B = (zb + min(es sd, 0)) + log(valid + 1e-20)``, sd the
    kernels' own signed distance (soft_dist: half-plane values inside,
    minus the distance to the nearest edge segment outside) and zb >= zs *
    zpx for any barycentrics of the row. cs (C, 32) rows, coords (2, P)
    pixel x, y. NaN on a row that may not be found dead: a used column, es
    or zs beyond TAME in magnitude (or not finite), or valid + 1e-20 = 0."""
    def col(j):
        return cs[:, j:j + 1]

    f32 = cs.dtype
    px, py = coords[0][None, :], coords[1][None, :]
    ax, ay, bx, by, cx, cy = (col(j) for j in range(6))

    def edge_raw(x0, y0, x1, y1):
        return (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)

    def seg2(x0, y0, x1, y1):
        ex, ey = x1 - x0, y1 - y0
        rec = 1.0 / ((ex * ex + ey * ey) + 1e-12)
        t = torch.fmin(torch.fmax(((px - x0) * ex + (py - y0) * ey) * rec,
                                  torch.zeros((), dtype=f32)),
                       torch.ones((), dtype=f32))
        dx = px - (x0 + t * ex)
        dy = py - (y0 + t * ey)
        return (dx * dx + dy * dy) + 1e-20

    # fminf and fmaxf drop a NaN operand; torch.fmin and fmax do too.
    hp = torch.fmin(torch.fmin(edge_raw(ax, ay, bx, by) * col(6),
                               edge_raw(bx, by, cx, cy) * col(7)),
                    edge_raw(cx, cy, ax, ay) * col(8))
    smin = _sqrt_f32(torch.fmin(torch.fmin(seg2(ax, ay, bx, by),
                                           seg2(bx, by, cx, cy)),
                                seg2(cx, cy, ax, ay)))
    xs = es * torch.where(hp >= 0.0, hp, -smin)
    cap = torch.where(xs > 0.0, 0.0, xs)  # keeps a NaN xs, as the kernels
    tame = math.isfinite(es) and math.isfinite(zs) and \
        abs(es) <= TAME and abs(zs) <= TAME
    row_ok = (cs[:, :29].abs() <= TAME).all(dim=1, keepdim=True) \
        & ((col(28) + 1e-20) != 0.0) & tame
    zabs = cs[:, 10:13].abs().max(dim=1, keepdim=True).values
    zb = torch.fmax((abs(zs) * zabs) * Z_SLACK,
                    torch.full_like(zabs, Z_FLOOR))
    zb = torch.where(row_ok, zb, float("nan"))
    return (zb + cap) + torch.log(col(28) + 1e-20)


def soft_dead_pairs(cs, coords, m, cot, es: float,
                    zs: float) -> torch.Tensor:
    """Plain PyTorch form of K9c's and K9d's early-out
    (csrc/soft_raster.cu::soft_pair_dead) in its operations' order, for
    the tests and chip_smoke.py; the kernels' route never calls it. cs
    (C, 32) float32 rows of the table, coords (2, P) pixel x, y, m (P,) the
    forward's saved max, cot (11, P) the cotangent rows. Returns (C, P)
    bool, True where soft_logit_bound's B lies more than DEAD_BELOW below
    m: the pair's weight exp(logit - m) is then exactly 0, and every term
    it would add is +-0, since only tame rows (soft_logit_bound) and pixels
    whose 11 cotangents lie within TAME in magnitude qualify. A NaN in B or
    m marks nothing."""
    pix_ok = (cot.abs() <= TAME).all(dim=0)[None, :]
    mt = torch.where(pix_ok, m[None, :], float("nan"))
    return soft_logit_bound(cs, coords, es, zs) - mt < DEAD_BELOW


def _edge_max(x0, y0, x1, y1, s, rect):
    """The largest half-plane value ``edge_raw(...) * s`` any pixel of each
    block computes (csrc/soft_raster.cu::edge_max): the value at the corner
    where each monotone step is largest. Rows (C, 1), rect (1, n_blocks)
    each; returns (C, n_blocks)."""
    xmin, xmax, ymin, ymax = rect
    up = s >= 0.0
    py = torch.where((x1 - x0 >= 0.0) == up, ymax, ymin)
    px = torch.where((y1 - y0 <= 0.0) == up, xmax, xmin)
    return ((x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)) * s


def soft_row_dead(cs, rect: tuple, es: float, zs: float,
                  m_floor) -> torch.Tensor:
    """Plain form of K9a's and K9b's dead-row test
    (csrc/soft_raster.cu::soft_row_bound) in its operations' order, for the
    tests and chip_smoke.py; the kernels' route never calls it. cs (C, 32)
    float32 rows; rect (xmin, xmax, ymin, ymax), (n_blocks,) each, pixel
    blocks' corners clipped to the image in frame coordinates (the
    kernels' blocks: tile_layout); m_floor (n_blocks,) the smallest running
    max of each block's pixels. Returns (C, n_blocks) bool, True where the
    bound ``B = (zb + cap) + log(valid + 1e-20)`` of the row's logit over
    the block lies more than DEAD_BELOW below the floor: its weight is then
    exactly 0 at every pixel of the block, and it is no pixel's max. zb is
    soft_logit_bound's; cap is 0, or, where es > 0 and one edge is computed
    below 0 at every pixel of the block (_edge_max), es times minus a lower
    bound of the distance the kernels compute at any pixel: the gap between
    the block and the row's bounding box, shortened by 2^-19 of the largest
    coordinate and scaled by 1 - 2^-18 for rounding. NaN (never dead) on a
    row that is not tame (soft_logit_bound)."""
    def col(j):
        return cs[:, j:j + 1]

    f32 = cs.dtype
    rect = tuple(r[None, :].to(f32) for r in rect)
    xmin, xmax, ymin, ymax = rect
    tame = math.isfinite(es) and math.isfinite(zs) and \
        abs(es) <= TAME and abs(zs) <= TAME
    row_ok = (cs[:, :29].abs() <= TAME).all(dim=1, keepdim=True) \
        & ((col(28) + 1e-20) != 0.0) & tame
    zabs = cs[:, 10:13].abs().max(dim=1, keepdim=True).values
    zb = torch.fmax((abs(zs) * zabs) * Z_SLACK,
                    torch.full_like(zabs, Z_FLOOR))
    ax, ay, bx, by, cx, cy = (col(j) for j in range(6))
    outside = ((_edge_max(ax, ay, bx, by, col(6), rect) < 0.0)
               | (_edge_max(bx, by, cx, cy, col(7), rect) < 0.0)
               | (_edge_max(cx, cy, ax, ay, col(8), rect) < 0.0))
    k = torch.fmax(torch.fmax(torch.fmax(xmax, ymax),
                              torch.ones((), dtype=f32)),
                   cs[:, :6].abs().max(dim=1, keepdim=True).values)
    e = k * 2.0 ** -19
    zero = torch.zeros((), dtype=f32)
    gx = torch.fmax(torch.fmax(torch.minimum(torch.minimum(ax, bx), cx)
                               - xmax,
                               xmin - torch.maximum(torch.maximum(ax, bx),
                                                    cx)), zero)
    gy = torch.fmax(torch.fmax(torch.minimum(torch.minimum(ay, by), cy)
                               - ymax,
                               ymin - torch.maximum(torch.maximum(ay, by),
                                                    cy)), zero)
    gx = torch.fmax(gx - e, zero)
    gy = torch.fmax(gy - e, zero)
    dlb = _sqrt_f32(gx * gx + gy * gy) * (1.0 - 2.0 ** -18)
    cap = torch.where(row_ok & outside & (es > 0.0), es * -dlb, zero)
    B = (zb + cap) + torch.log(col(28) + 1e-20)
    B = torch.where(row_ok, B, float("nan"))
    return B - m_floor[None, :].to(f32) < DEAD_BELOW


# K9a's and K9b's pixel blocks: warp w of a 16 x 16 tile takes the
# BLOCK_W x BLOCK_H block w, two across and four down, and tests each row of
# a chunk for its own block (csrc/soft_raster.cu::fwd_pixel, soft_rect).
BLOCK_W, BLOCK_H = 8, 4
BLOCKS_PER_TILE = (TILE // BLOCK_W) * (TILE // BLOCK_H)


def tile_layout(H: int, W: int, device, y0: int = 0) -> tuple:
    """The kernels' pixel blocks of rows [y0, y0 + H) of a frame W wide
    (BLOCKS_PER_TILE a 16 x 16 tile, tile by tile, then block by block):
    each pixel's block (H*W,) int64, row-major, and the blocks' pixel
    corners clipped to the image, in frame coordinates (xmin, xmax, ymin,
    ymax), (n_blocks,) float32 each (a block past the image's edge holds
    no pixel and has xmin > xmax or ymin > ymax): soft_agg_reference's
    ``dead_rows`` and soft_row_dead_probe's floors' order."""
    px, py = pixel_grid(H, W, device)
    tiles_x = -(-W // TILE)
    xl, yl = px.long(), py.long()
    tile = (yl // TILE) * tiles_x + xl // TILE
    block = (tile * BLOCKS_PER_TILE + ((yl % TILE) // BLOCK_H)
             * (TILE // BLOCK_W) + (xl % TILE) // BLOCK_W)
    t = torch.arange(-(-H // TILE) * tiles_x, device=device)
    w = torch.arange(BLOCKS_PER_TILE, device=device)
    x0 = ((t % tiles_x) * TILE)[:, None] + (w % (TILE // BLOCK_W))[None, :] \
        * BLOCK_W
    y0b = ((t // tiles_x) * TILE)[:, None] + (w // (TILE // BLOCK_W))[
        None, :] * BLOCK_H
    x0, y0b = x0.reshape(-1), y0b.reshape(-1)
    x1 = torch.clamp_max(x0 + BLOCK_W - 1, W - 1)
    y1 = torch.clamp_max(y0b + BLOCK_H - 1, H - 1)
    return block, tuple(v.to(torch.float32) for v in (x0, x1, y0b + y0,
                                                       y1 + y0))


def soft_fwd_run(kept: int, n_tiles: int) -> int:
    """The run of K9a's and K9b's work items (csrc/work_items.cuh::
    pri_fwd_run): ``kept`` (tile, chunk) pairs over n_tiles tiles."""
    mean = -(-kept // n_tiles)
    splits = -(-SOFT_FWD_ITEMS // n_tiles)
    return max(SOFT_FWD_RUN_MIN, -(-mean // splits))


def soft_fwd_items(mask, n_tiles: int, n_chunks: int) -> dict:
    """K9a's (mask None) or K9b's work items, as the card plans them: the
    run, the items and the tiles of more than one item (merged)."""
    nk = (torch.full((n_tiles,), n_chunks) if mask is None
          else (mask != 0).sum(dim=1).cpu())
    run = soft_fwd_run(int(nk.sum()), n_tiles)
    per_tile = -(-nk // run)
    return dict(run=run, items=int(per_tile.sum()),
                merged=int((per_tile > 1).sum()))


def pixel_coords(H: int, W: int, device, dtype=torch.float32, y0: int = 0):
    """(2, H*W) integer pixel coordinates x, y of rows [y0, y0 + H),
    row-major."""
    return torch.stack(pixel_grid(H, W, device, y0)).to(dtype)


def expand_mask(mask: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The (n_tiles, n_chunks) keep-mask over TILE x TILE tiles as an
    (n_chunks, H*W) bool mask of pixels."""
    px, py = pixel_grid(H, W, mask.device)
    tile = (py.long() // TILE) * -(-W // TILE) + px.long() // TILE
    return (mask[tile] != 0).T


def _check(consts, H: int, W: int, chunk: int, mask=None, m=None, cot=None):
    """Raise on what the kernels do not take."""
    Tp = consts.shape[0]
    if consts.dtype != torch.float32 or consts.dim() != 2 or \
            consts.shape[1] != CONST_COLS or not consts.is_contiguous():
        raise ValueError(f"consts: expected a contiguous (Tp, {CONST_COLS}) "
                         f"float32 tensor, got {consts.dtype} "
                         f"{tuple(consts.shape)}")
    if not 1 <= chunk <= MAX_CHUNK or Tp < chunk or Tp % chunk:
        raise ValueError(f"chunk must be 1..{MAX_CHUNK} and divide Tp = {Tp},"
                         f" got {chunk}")
    if H < 1 or W < 1:
        raise ValueError(f"empty image {H}x{W}")
    if consts.data_ptr() % 16:
        raise ValueError("consts: the kernels stage rows as float4s; the "
                         "tensor must start on 16 bytes")
    R = H * W
    if mask is not None:
        shape = (-(-H // TILE) * -(-W // TILE), Tp // chunk)
        if mask.dtype != torch.int32 or tuple(mask.shape) != shape or \
                not mask.is_contiguous() or mask.device != consts.device:
            raise ValueError(f"mask: expected a contiguous int32 {shape} "
                             f"tensor on {consts.device}, got {mask.dtype} "
                             f"{tuple(mask.shape)} on {mask.device}")
    for name, t, shape in (("m", m, (R,)), ("cot", cot, (1 + N_CH, R))):
        if t is not None and (t.dtype != torch.float32 or tuple(t.shape) !=
                              shape or not t.is_contiguous() or
                              t.device != consts.device):
            raise ValueError(f"{name}: expected a contiguous float32 {shape} "
                             f"tensor on {consts.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=64)
def _fwd_scratch_bytes(Tp: int, chunk: int, H: int, W: int,
                       masked: bool) -> int:
    """csrc/soft_raster.cu::raytpu_soft_raster_fwd_scratch for these shapes,
    asked once a shape (the fit CLI calls K9a 501 times on one)."""
    n = _build.load().raytpu_soft_raster_fwd_scratch(Tp, chunk, H, W,
                                                     int(masked))
    if n < 0:
        raise ValueError(f"K9a/K9b take no table of {Tp} rows in chunks of "
                         f"{chunk} on {H} x {W} pixels")
    return n


def fwd_scratch(consts, H: int, W: int, chunk: int,
                mask) -> torch.Tensor | None:
    """A fresh scratch buffer for one K9a or K9b call (uint8, on consts'
    device), sized by the kernels' library (csrc/soft_raster.cu::
    SoftFwdCall: the plan and the items' partials), or None where the call
    needs none (K9a at one item a tile, as the fit's frames are)."""
    n = _fwd_scratch_bytes(consts.shape[0], chunk, H, W, mask is not None)
    return (torch.empty((n,), dtype=torch.uint8, device=consts.device)
            if n else None)


def launch_fwd_kernel(consts, H: int, W: int, chunk: int, mask, es: float,
                      zs: float, agg, m, s, y0: int = 0, *,
                      scratch) -> None:
    """Launch K9a (mask None) or K9b, with ``scratch`` (fwd_scratch), into
    the outputs the caller allocated: the plan (K9b), the kernel and the
    merge of its items. Checks nothing and counts nothing; the wrapper
    does both."""
    err = _build.load().raytpu_soft_raster_fwd(
        consts.data_ptr(), consts.shape[0], chunk, _ptr(mask), H, W, y0, es,
        zs, _ptr(scratch), 0 if scratch is None else scratch.numel(),
        agg.data_ptr(), m.data_ptr(), s.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"soft_raster_fwd launch failed: CUDA error {err}")


def soft_row_dead_probe(consts: torch.Tensor, H: int, W: int, es: float,
                        zs: float, floors: torch.Tensor,
                        y0: int = 0) -> dict:
    """The card's check of K9a's and K9b's dead-row test
    (csrc/soft_raster.cu::soft_row_dead_probe_kernel): every row of the
    (Tp, 32) CUDA table tested by the device's test against each pixel
    block's floor (floors (n_blocks,) float32, tile_layout's order), and
    every row called dead evaluated by the kernels' fwd_logit at every
    pixel of its block. Returns the counts, over the blocks that hold
    pixels: ``dead`` (block, row) pairs, ``bad`` (pixel, row) pairs among
    them whose expf(logit - floor) is not 0 or whose logit is not below the
    floor (0 where the test is exact), and ``pairs`` in all. Counts no
    launch."""
    n_blocks = -(-H // TILE) * -(-W // TILE) * BLOCKS_PER_TILE
    if floors.dtype != torch.float32 or tuple(floors.shape) != (n_blocks,) \
            or floors.device != consts.device or consts.data_ptr() % 16:
        raise ValueError(f"floors: expected float32 ({n_blocks},) on "
                         f"{consts.device}, and consts on 16 bytes")
    counts = torch.zeros(3, dtype=torch.int64, device=consts.device)
    with torch.cuda.device(consts.device):
        err = _build.load().raytpu_soft_row_dead_probe(
            consts.data_ptr(), consts.shape[0], H, W, y0, es, zs,
            floors.contiguous().data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"soft_row_dead_probe launch failed: CUDA error "
                           f"{err}")
    dead, bad, pairs = counts.tolist()
    return dict(dead=dead, bad=bad, pairs=pairs)


def bwd_scratch(consts, H: int, W: int, chunk: int) -> torch.Tensor:
    """A fresh scratch buffer for one K9c or K9d call (uint8, on consts'
    device), sized by the kernels' library
    (csrc/soft_raster.cu::bwd_scratch: the kept-tile lists, the work items
    and their partials)."""
    n = _build.load().raytpu_soft_raster_bwd_scratch(consts.shape[0], chunk,
                                                     H, W)
    if n < 0:
        raise ValueError(f"K9c/K9d take no table of {consts.shape[0]} rows "
                         f"in chunks of {chunk} on {H} x {W} pixels")
    return torch.empty((n,), dtype=torch.uint8, device=consts.device)


def launch_bwd_kernel(consts, H: int, W: int, chunk: int, mask, es: float,
                      zs: float, m, cot, dc, y0: int = 0, *,
                      scratch) -> None:
    """Launch K9c (mask None) or K9d into dc (Tp, 32), allocated by the
    caller, with ``scratch`` (:func:`bwd_scratch`). Checks nothing and
    counts nothing; the wrapper does both."""
    err = _build.load().raytpu_soft_raster_bwd(
        consts.data_ptr(), consts.shape[0], chunk, _ptr(mask), H, W, y0, es,
        zs, m.data_ptr(), cot.data_ptr(), scratch.data_ptr(), scratch.numel(),
        dc.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"soft_raster_bwd launch failed: CUDA error {err}")


def soft_agg_fwd(consts: torch.Tensor, H: int, W: int, chunk: int,
                 mask: torch.Tensor | None, es: float, zs: float,
                 y0: int = 0):
    """K9a's (mask None) and K9b's wrapper: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. consts (Tp, 32) in chunks of
    ``chunk`` <= 32 rows; mask None or (n_tiles, n_chunks) int32 over
    TILE x TILE tiles (tile_rects); the image rows [y0, y0 + H). Returns agg
    (10, H*W), m, s (H*W,)."""
    global LAUNCHES_SOFT_FWD, LAUNCHES_SOFT_FWD_MASKED
    if not _route(consts):
        return soft_agg_reference(
            consts, pixel_coords(H, W, consts.device, consts.dtype, y0),
            None if mask is None else expand_mask(mask, H, W), es, zs, chunk)
    _check(consts, H, W, chunk, mask)
    R = H * W
    agg = torch.empty((N_CH, R), dtype=torch.float32, device=consts.device)
    m = torch.empty((R,), dtype=torch.float32, device=consts.device)
    s = torch.empty((R,), dtype=torch.float32, device=consts.device)
    scratch = fwd_scratch(consts, H, W, chunk, mask)
    with torch.cuda.device(consts.device):
        launch_fwd_kernel(consts, H, W, chunk, mask, es, zs, agg, m, s, y0,
                          scratch=scratch)
    if mask is None:
        LAUNCHES_SOFT_FWD += 1
    else:
        LAUNCHES_SOFT_FWD_MASKED += 1
    return agg, m, s


def soft_agg_bwd(consts: torch.Tensor, m: torch.Tensor, cot: torch.Tensor,
                 H: int, W: int, chunk: int, mask: torch.Tensor | None,
                 es: float, zs: float, y0: int = 0) -> torch.Tensor:
    """K9c's (mask None) and K9d's wrapper: the CUDA kernels for CUDA
    tensors, the plain version for CPU tensors. m (H*W,) the forward's
    saved max, cot (11, H*W) = [d s, d acc_0..9]; the rest as soft_agg_fwd.
    Returns d consts (Tp, 32), zero in columns 29-31."""
    global LAUNCHES_SOFT_BWD, LAUNCHES_SOFT_BWD_MASKED
    if not _route(consts):
        return soft_agg_bwd_reference(
            consts, pixel_coords(H, W, consts.device, consts.dtype, y0),
            None if mask is None else expand_mask(mask, H, W), m, cot, es,
            zs, chunk)
    _check(consts, H, W, chunk, mask, m, cot)
    dc = torch.empty_like(consts)
    scratch = bwd_scratch(consts, H, W, chunk)
    with torch.cuda.device(consts.device):
        launch_bwd_kernel(consts, H, W, chunk, mask, es, zs, m, cot, dc, y0,
                          scratch=scratch)
    if mask is None:
        LAUNCHES_SOFT_BWD += 1
    else:
        LAUNCHES_SOFT_BWD_MASKED += 1
    return dc


def _agg_bwd(ctx, g, g_s=None) -> torch.Tensor:
    """d consts of SoftAgg and SoftAggStats: the cotangent rows formed as
    ``_soft_agg_bwd`` does (img = acc / s: d acc_j = g_j / s, d s =
    -(g . img) / s, plus the cotangent of s itself where s is an output),
    then K9c/K9d (or their plain version)."""
    consts, agg, m, s = ctx.saved_tensors
    H, W, chunk, mask, es, zs, y0 = ctx.args
    srec = 1.0 / s
    da = g * srec
    ds = -(g * agg).sum(dim=0, keepdim=True) * srec
    if g_s is not None:
        ds = ds + g_s
    cot = torch.cat([ds, da]).contiguous()
    return soft_agg_bwd(consts.contiguous(), m, cot, H, W, chunk, mask, es,
                        zs, y0)


class SoftAgg(torch.autograd.Function):
    """agg (10, H*W) of the (Tp, 32) table for rows [y0, y0 + H)
    (``_soft_agg``), differentiable in consts; the backward runs K9c/K9d
    (or their plain version)."""

    @staticmethod
    def forward(ctx, consts, H: int, W: int, chunk: int, mask, es: float,
                zs: float, y0: int = 0):
        agg, m, s = soft_agg_fwd(consts, H, W, chunk, mask, es, zs, y0)
        ctx.save_for_backward(consts, agg, m, s)
        ctx.args = (H, W, chunk, mask, es, zs, y0)
        return agg

    @staticmethod
    def backward(ctx, g):
        return (_agg_bwd(ctx, g),) + (None,) * 7


class SoftAggStats(torch.autograd.Function):
    """(agg, m, s) of SoftAgg's inputs (``_soft_agg_stats``): agg and s are
    differentiable in consts, m is not. The backward takes s's cotangent
    into the d s row and drops m's: exact where the caller uses (m, s) only
    through s * exp(m - M) with M held constant, as the sharded soft combine
    does (the kernel's d s, taken at m held constant, carries what m's path
    would)."""

    @staticmethod
    def forward(ctx, consts, H: int, W: int, chunk: int, mask, es: float,
                zs: float, y0: int = 0):
        agg, m, s = soft_agg_fwd(consts, H, W, chunk, mask, es, zs, y0)
        ctx.save_for_backward(consts, agg, m, s)
        ctx.args = (H, W, chunk, mask, es, zs, y0)
        ctx.mark_non_differentiable(m)
        return agg, m, s

    @staticmethod
    def backward(ctx, g, _g_m, g_s):
        return (_agg_bwd(ctx, g, g_s[None, :]),) + (None,) * 7


def soft_chunk_bounds(consts: torch.Tensor, chunk: int):
    """Each chunk's screen box [xmin, ymin, xmax, ymax] (n_chunks, 4), its
    largest vertex zinv clamped at 0 (n_chunks,) and whether it has any
    row (``soft_chunk_bounds``). All-zero rows (chunk padding) are left
    out; every other row, valid or not, is covered: the kernel gives it a
    finite logit."""
    c = consts.reshape(-1, chunk, CONST_COLS)
    row_used = (c != 0.0).any(dim=-1)
    xs = torch.stack([c[..., 0], c[..., 2], c[..., 4]], -1)
    ys = torch.stack([c[..., 1], c[..., 3], c[..., 5]], -1)
    zi = torch.stack([c[..., 10], c[..., 11], c[..., 12]], -1)
    big = 3.0e38
    m3 = row_used[..., None]

    def reduce(a, lo: bool):
        a = torch.where(m3, a, big if lo else -big).reshape(a.shape[0], -1)
        return a.min(dim=1).values if lo else a.max(dim=1).values

    zmax = torch.clamp_min(reduce(zi, False), 0.0)
    boxes = torch.stack([reduce(xs, True), reduce(ys, True),
                         reduce(xs, False), reduce(ys, False)], dim=1)
    return boxes, zmax, row_used.any(dim=1)


def soft_keep_mask(rects: tuple, consts: torch.Tensor, es: float, zs: float,
                   chunk: int) -> torch.Tensor:
    """Conservative (n_tiles, n_chunks) int32 keep-mask for K9b/K9d
    (``soft_keep_mask``), for tiles given as rectangles (xmin, xmax, ymin,
    ymax), (n_tiles,) each (tile_rects).

    A chunk may be skipped for a tile when every pixel of the tile is
    farther than delta_c = (zs * zmax_c + 46) / es from the chunk's screen
    box: a dropped row's logit is then at most -46, a weight of 1e-20 of the
    background's, and so is its gradient."""
    xmin, xmax, ymin, ymax = rects
    boxes, zmax, nonempty = soft_chunk_bounds(consts, chunk)
    delta = (zs * zmax + CULL_MARGIN) / es

    def axis_gap(tlo, thi, clo, chi):
        gap = torch.maximum(clo[None, :] - thi[:, None],
                            tlo[:, None] - chi[None, :])
        return torch.clamp_min(gap, 0.0)

    dx = axis_gap(xmin, xmax, boxes[:, 0], boxes[:, 2])
    dy = axis_gap(ymin, ymax, boxes[:, 1], boxes[:, 3])
    # Relative and absolute slack on the comparison (boxes at ~1e3 px).
    lim = delta[None, :] * 1.001 + 0.5
    keep = (dx * dx + dy * dy <= lim * lim) & nonempty[None, :]
    return keep.to(torch.int32)


def cull_block(tile_p: int, H: int, W: int):
    """``_cull_block``: the (th, tw) pixel block of the JAX package's
    culled path, or None when H x W does not block evenly into tile_p
    pixels."""
    tw = 32
    while tw > 1 and (tile_p % tw or W % tw):
        tw //= 2
    th = tile_p // tw
    if tile_p % tw or H % th or W % tw:
        return None
    return th, tw


def use_cull(cull: bool | None, n_chunks: int, H: int, W: int) -> bool:
    """Whether the frame culls, as ``rasterize_soft_pallas`` decides: cull
    None culls where there is more than one chunk and the image blocks into
    the JAX package's 1,024-pixel tiles; cull True where it does not block
    raises ValueError, as there."""
    blk = cull_block(JAX_TILE_P, H, W)
    if cull is None:
        return n_chunks > 1 and blk is not None
    if cull and blk is None:
        raise ValueError(f"cull=True needs H, W to tile into 2D blocks for "
                         f"tile_p {JAX_TILE_P}; got {H}x{W}")
    return cull
