"""The hard rasterizer's winner search (counterpart of
raytpu/kernels/raster_pallas.py).

For every pixel of an H x W image, at the integer corner (x, y) as
rasterize_exact places it, the winning triangle: the FIRST triangle with
the largest covered ``zpx`` (the reference's strict ``zinv > depth``,
`rasteriser.cpp:606`), -1 for background. From the (T, 16) constants of
``raster_tri_constants`` (rows [A0 B0 C0 A1 B1 C1 A2 B2 C2 Za Zb Zc valid 0
0 0]): ``e_k = (A_k px + B_k py) + C_k``, ``zpx = (Za px + Zb py) + Zc``,
covered where ``min(e0, e1, e2) >= 0``, ``zpx > 0`` and ``valid``.

  raster_winner          K8b's wrapper, one chunk of T <= 128 triangles
                         (replaces ``_kernel_blk8``).
  raster_winner_masked   K8c's wrapper, several chunks, skipping the
                         chunks a (pixel tile, chunk) keep-mask rules out
                         (replaces ``_kernel_masked``).
  raster_winner_chunked  K8a's wrapper, several chunks, every one swept
                         (replaces ``_kernel``; only the sharded
                         rasterizer's triangle blocks launch it).
  *_reference            their plain PyTorch versions.
  resolve_winner         the dispatch of ``resolve_winner_pallas``.
  chunk_screen_mask      the conservative keep-mask, as the JAX package's
                         but for tiles given as rectangles (tile_rects).
  raster_tile_reject     the plain form of K8a's and K8c's exact per-tile
                         row cull; raster_cull_probe runs the card's.

On CUDA tensors the wrappers launch the hand-written kernels
(raytpu_torch/csrc/raster.cu); on CPU tensors they run the plain versions.
The winner is piecewise constant and gets no gradient: callers pass
detached constants, as the JAX package stop_gradients them.

Every function takes the image's first row ``y0``: the H x W image is rows
[y0, y0 + H) of the frame (pixel y = y0 + row), as the sharded
rasterizer's row blocks are (raytpu_torch/parallel/render.py); y0 = 0 is
the whole frame. K8c's mask is over the image's own tiles.
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.core.types import pixel_grid
from raytpu_torch.kernels import _build

# Launches of each CUDA kernel in this process, counted by its wrapper
# where it launches the kernel and nowhere else.
LAUNCHES_WINNER = 0          # K8b, by raster_winner
LAUNCHES_WINNER_MASKED = 0   # K8c, by raster_winner_masked
LAUNCHES_WINNER_CHUNKED = 0  # K8a, by raster_winner_chunked

NEG_INF = float(-np.finfo(np.float32).max)  # _NEG_INF = -3.4028235e38
MAX_CHUNK = 128
CONST_COLS = 16
TILE = 16  # K8c's pixel tile: TILE x TILE pixels, one block


def raster_tri_constants(sx, sy, zinv, keep) -> torch.Tensor:
    """The kernels' (T, 16) float32 rows from the screen vertices sx, sy,
    the vertex 1/z zinv (T, 3 each) and keep (T,): the three edge
    functions normalized (|(A, B)| = 1) and oriented inside-positive, the
    affine zinv plane (Za, Zb, Zc), and ``valid`` = keep & |area| > 1e-4
    px^2 (near-degenerate screen triangles would light whole lines)."""
    ax, ay = sx[:, 0], sy[:, 0]
    bx, by = sx[:, 1], sy[:, 1]
    cx, cy = sx[:, 2], sy[:, 2]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    area_ok = area.abs() > 1e-4
    area_safe = torch.where(area.abs() > 1e-12, area, 1.0)
    orient = torch.sign(area_safe)

    def edge(x0, y0, x1, y1):
        # E(p) = (x1 - x0)(py - y0) - (y1 - y0)(px - x0) = A px + B py + C
        ex = x1 - x0
        ey = y1 - y0
        # The square root rounded once from float64: correctly rounded as
        # XLA's and CUDA's are, where PyTorch's CPU sqrt can be an ulp off
        # (ROADMAP fault F4), which flips pixels on a shared edge.
        norm = torch.sqrt((ex * ex + ey * ey).double()).float() + 1e-12
        return (-ey * orient / norm, ex * orient / norm,
                (ey * x0 - ex * y0) * orient / norm)

    z0, z1, z2 = zinv[:, 0], zinv[:, 1], zinv[:, 2]
    za = ((z1 - z0) * (cy - ay) - (z2 - z0) * (by - ay)) / area_safe
    zb = ((z2 - z0) * (bx - ax) - (z1 - z0) * (cx - ax)) / area_safe
    zc = z0 - za * ax - zb * ay
    valid = ((keep > 0.0) & area_ok).to(torch.float32)
    zeros = torch.zeros_like(ax)
    return torch.stack([*edge(ax, ay, bx, by), *edge(bx, by, cx, cy),
                        *edge(cx, cy, ax, ay), za, zb, zc, valid, zeros,
                        zeros, zeros], dim=1)


def tile_rects(H: int, W: int, device) -> tuple:
    """K8c's tiles of an H x W image, TILE x TILE pixels, row-major over the
    tile grid (the last row and column clipped to the image): their
    (xmin, xmax, ymin, ymax) pixel coordinates, (n_tiles,) float32 each."""
    ty = torch.arange(-(-H // TILE), device=device)
    tx = torch.arange(-(-W // TILE), device=device)
    ty, tx = torch.meshgrid(ty, tx, indexing="ij")
    ty, tx = ty.reshape(-1) * TILE, tx.reshape(-1) * TILE
    return tuple(t.to(torch.float32) for t in (
        tx, (tx + TILE - 1).clamp_max(W - 1), ty,
        (ty + TILE - 1).clamp_max(H - 1)))


def chunk_screen_mask(sx, sy, zinv, valid, rects: tuple,
                      chunk: int) -> torch.Tensor:
    """Conservative (n_tiles, n_chunks) int32 keep-mask for K8c.

    A covered pixel lies inside its triangle's screen bounding box, so a
    tile whose rectangle misses the union box of a chunk's valid
    triangles can skip the chunk. A triangle with a vertex at zinv <= 0
    (behind the camera; its projection is unusable) keeps its chunk
    everywhere. The margin is the JAX package's: 2 px plus 1e-5 of the
    largest finite box coordinate, which dominates the edge functions'
    rounding error amplified at a sliver's apex.

    sx, sy, zinv: (T, 3); valid: (T,); rects: (xmin, xmax, ymin, ymax),
    (n_tiles,) each (tile_rects for K8c's tiles). Triangles pad to a
    multiple of ``chunk`` as invalid.
    """
    T = sx.shape[0]
    pad = -(-T // chunk) * chunk - T

    def padv(a, fill):
        return torch.cat([a, a.new_full((pad,) + a.shape[1:], fill)]) \
            if pad else a

    sx_, sy_ = padv(sx, 0.0), padv(sy, 0.0)
    v = padv(valid, 0.0) > 0.0
    behind = padv(zinv.min(dim=1).values, 1.0) <= 0.0
    big = 3.0e38

    def box(a, lo: bool):
        """Each chunk's lowest (lo) or highest box coordinate along a."""
        ext = a.min(dim=1).values if lo else a.max(dim=1).values
        inner = torch.where(behind, -big if lo else big, ext)
        t = torch.where(v, inner, big if lo else -big).reshape(-1, chunk)
        return t.min(dim=1).values if lo else t.max(dim=1).values

    cxmin, cxmax = box(sx_, True), box(sx_, False)
    cymin, cymax = box(sy_, True), box(sy_, False)

    def finite_mag(x):  # the largest |x| that is not a +-big sentinel
        ax = x.abs()
        return torch.where(ax < 1e30, ax, 0.0).max()

    mag = torch.maximum(torch.maximum(finite_mag(cxmin), finite_mag(cxmax)),
                        torch.maximum(finite_mag(cymin), finite_mag(cymax)))
    eps = 2.0 + 1e-5 * mag
    rxmin, rxmax, rymin, rymax = (r[:, None] for r in rects)
    keep = ((cxmin[None, :] <= rxmax + eps) & (cxmax[None, :] >= rxmin - eps)
            & (cymin[None, :] <= rymax + eps)
            & (cymax[None, :] >= rymin - eps))
    return keep.to(torch.int32)


def _plane_below(a, b, c, rect, at_zero: bool):
    """Where the plane (a, b, c) (each (T, 1)) is computed below 0 (below
    or at 0 where ``at_zero``) at every pixel of each tile: its value at
    the tile's largest corner by the sweep's expression ``(a x + b y) +
    c``, as csrc/raster.cu::plane_below. Never where a coefficient is not
    finite."""
    xmin, xmax, ymin, ymax = (r[None, :] for r in rect)
    x = torch.where(a >= 0.0, xmax, xmin)
    y = torch.where(b >= 0.0, ymax, ymin)
    v = (a * x + b * y) + c
    finite = torch.isfinite(a) & torch.isfinite(b) & torch.isfinite(c)
    return finite & ((v <= 0.0) if at_zero else (v < 0.0))


def raster_tile_reject(consts: torch.Tensor, rect: tuple) -> torch.Tensor:
    """Plain form of K8a's and K8c's per-tile row cull
    (csrc/raster.cu::tile_reject), op by op: (T, n_tiles) bool, True where
    row t covers no pixel of tile j. consts (T, 16) float32; rect (xmin,
    xmax, ymin, ymax), (n_tiles,) float32 each, the tiles' pixel corners
    clipped to the image, in frame coordinates (tile_rects, ymin and ymax
    plus y0). A row is rejected where its valid is not > 0, or where one of
    its three edges or its zpx (at or below 0) is computed below 0 at the
    tile's corner where the sweep's value is largest: rounding to nearest
    is monotone in each operand, so no pixel of the tile computes more."""
    def col(j):
        return consts[:, j:j + 1]

    rej = ~(col(12) > 0.0)
    for k in range(3):
        rej = rej | _plane_below(col(3 * k), col(3 * k + 1),
                                 col(3 * k + 2), rect, False)
    return rej | _plane_below(col(9), col(10), col(11), rect, True)


def _chunk_best(px, py, c: torch.Tensor, drop=None):
    """Over the rows c (C, 16) of one chunk: each pixel's largest covered
    zpx (NEG_INF where none) and the first row reaching it; ``drop`` None
    or (P, C) bool pairs left out."""
    def plane(j):
        return (c[None, :, j] * px[:, None] + c[None, :, j + 1] * py[:, None]
                ) + c[None, :, j + 2]

    sdist = torch.minimum(torch.minimum(plane(0), plane(3)), plane(6))
    zpx = plane(9)
    covered = (sdist >= 0.0) & (zpx > 0.0) & (c[None, :, 12] > 0.0)
    if drop is not None:
        covered = covered & ~drop
    z = torch.where(covered, zpx, NEG_INF)
    best = z.max(dim=1).values
    rows = torch.arange(c.shape[0], dtype=torch.int32, device=c.device)
    first = torch.where(z == best[:, None], rows, 2147483647).min(dim=1)
    return best, first.values


def _chunks_reference(consts, H: int, W: int, chunk: int, mask, y0: int,
                      cull: bool = False):
    """The chunks of ``chunk`` rows in order, each skipped for the pixels
    of a tile whose mask bit is 0 (mask None: none skipped); a chunk
    replaces the running winner only with a strictly larger zpx. With
    ``cull``, each tile's pixels leave out the rows raster_tile_reject
    rejects for the tile, as the kernels do."""
    px, py = pixel_grid(H, W, consts.device, y0)
    row = py.long() - y0
    tile = (row // TILE) * -(-W // TILE) + px.long() // TILE
    reject = None
    if cull:
        xmin, xmax, ymin, ymax = tile_rects(H, W, consts.device)
        reject = raster_tile_reject(consts, (xmin, xmax, ymin + y0,
                                             ymax + y0))
    best_z = torch.full_like(px, NEG_INF)
    best_i = torch.full(px.shape, -1, dtype=torch.int32, device=px.device)
    for c, lo in enumerate(range(0, consts.shape[0], chunk)):
        drop = None if reject is None else reject[lo:lo + chunk][:, tile].T
        z, first = _chunk_best(px, py, consts[lo:lo + chunk], drop)
        upd = z > best_z
        if mask is not None:
            upd = upd & (mask[tile, c] != 0)
        best_z = torch.where(upd, z, best_z)
        best_i = torch.where(upd, first + lo, best_i)
    return torch.where(best_z > NEG_INF, best_i, -1)


def resolve_winner_masked_reference(consts: torch.Tensor, H: int, W: int,
                                    mask: torch.Tensor, chunk: int,
                                    y0: int = 0,
                                    cull: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K8c, on any device: the chunks of
    ``chunk`` rows in order, each skipped for the pixels of a tile whose
    mask bit is 0 (TILE x TILE tiles of the image, mask (n_tiles,
    n_chunks)); a chunk replaces the running winner only with a strictly
    larger zpx. ``cull`` leaves out the rows each tile rejects
    (raster_tile_reject), as the kernel does: the same winners. Returns
    (H*W,) int32."""
    return _chunks_reference(consts, H, W, chunk, mask, y0, cull)


def resolve_winner_chunked_reference(consts: torch.Tensor, H: int, W: int,
                                     chunk: int, y0: int = 0,
                                     cull: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K8a, on any device: K8c's with no chunk
    skipped (``_kernel``: each chunk's first row at its max, then a strict
    ``>`` across chunks); ``cull`` as there. Returns (H*W,) int32."""
    return _chunks_reference(consts, H, W, chunk, None, y0, cull)


def resolve_winner_reference(consts: torch.Tensor, H: int, W: int,
                             y0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K8b, on any device: one chunk of T <= 128
    rows. Returns (H*W,) int32."""
    best_z, first = _chunk_best(*pixel_grid(H, W, consts.device, y0), consts)
    return torch.where(best_z > NEG_INF, first, -1)


def _check(consts, H: int, W: int, mask=None, chunk: int | None = None):
    """Raise on what the kernels do not take: K8b (mask and chunk None)
    one chunk of T <= 128 rows, K8a (chunk given) and K8c chunks of 1..128
    rows, K8c a mask over its tiles."""
    T = consts.shape[0]
    if consts.dtype != torch.float32 or consts.dim() != 2 or \
            consts.shape[1] != CONST_COLS or not consts.is_contiguous():
        raise ValueError(f"consts: expected a contiguous (T, {CONST_COLS}) "
                         f"float32 tensor, got {consts.dtype} "
                         f"{tuple(consts.shape)}")
    if H < 1 or W < 1 or T < 1:
        raise ValueError(f"empty image {H}x{W} or no triangles ({T})")
    if chunk is None:
        if T > MAX_CHUNK:
            raise ValueError(f"K8b takes at most {MAX_CHUNK} triangles, got "
                             f"{T}")
        return
    if consts.data_ptr() % 16:
        raise ValueError("consts: K8a and K8c read rows as float4s; the "
                         "tensor must start on 16 bytes")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must be 1..{MAX_CHUNK}, got {chunk}")
    if mask is None:
        return
    shape = ((-(-H // TILE)) * (-(-W // TILE)), -(-T // chunk))
    if mask.dtype != torch.int32 or tuple(mask.shape) != shape or \
            not mask.is_contiguous() or mask.device != consts.device:
        raise ValueError(f"mask: expected a contiguous int32 {shape} tensor "
                         f"on {consts.device}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")


def launch_winner_kernel(consts, H: int, W: int, idx, y0: int = 0) -> None:
    """Launch K8b on the (H*W,) int32 output the caller allocated. Checks
    nothing and counts nothing; the wrapper does both."""
    err = _build.load().raytpu_raster_winner(
        consts.data_ptr(), consts.shape[0], H, W, y0, idx.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"raster_winner launch failed: CUDA error {err}")


def launch_winner_masked_kernel(consts, H: int, W: int, mask, chunk: int,
                                idx, y0: int = 0) -> None:
    """Launch K8c (or K8a, mask None) on the (H*W,) int32 output the
    caller allocated. Checks nothing and counts nothing; the wrappers do
    both."""
    err = _build.load().raytpu_raster_winner_chunked(
        consts.data_ptr(), consts.shape[0], chunk,
        None if mask is None else mask.data_ptr(), H, W, y0, idx.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"raster_winner_chunked launch failed: CUDA error "
                           f"{err}")


def _route(consts: torch.Tensor) -> bool:
    """True for CUDA tensors (launch), False for CPU ones (plain)."""
    if consts.device.type == "cpu":
        return False
    if consts.device.type != "cuda":
        raise ValueError(f"no route for tensors on {consts.device}")
    return True


def raster_winner(consts: torch.Tensor, H: int, W: int,
                  y0: int = 0) -> torch.Tensor:
    """K8b's wrapper: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. consts (T <= 128, 16); returns (H*W,) int32 for rows
    [y0, y0 + H)."""
    global LAUNCHES_WINNER
    if not _route(consts):
        return resolve_winner_reference(consts, H, W, y0)
    _check(consts, H, W)
    idx = torch.empty((H * W,), dtype=torch.int32, device=consts.device)
    with torch.cuda.device(consts.device):
        launch_winner_kernel(consts, H, W, idx, y0)
    LAUNCHES_WINNER += 1
    return idx


def raster_winner_masked(consts: torch.Tensor, H: int, W: int,
                         mask: torch.Tensor, chunk: int,
                         y0: int = 0) -> torch.Tensor:
    """K8c's wrapper: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. consts (T, 16) in chunks of ``chunk`` <= 128 rows;
    mask (n_tiles, n_chunks) int32 over the image's TILE x TILE tiles;
    returns (H*W,) int32 for rows [y0, y0 + H)."""
    global LAUNCHES_WINNER_MASKED
    if not _route(consts):
        return resolve_winner_masked_reference(consts, H, W, mask, chunk, y0)
    _check(consts, H, W, mask, chunk)
    idx = torch.empty((H * W,), dtype=torch.int32, device=consts.device)
    with torch.cuda.device(consts.device):
        launch_winner_masked_kernel(consts, H, W, mask, chunk, idx, y0)
    LAUNCHES_WINNER_MASKED += 1
    return idx


def raster_winner_chunked(consts: torch.Tensor, H: int, W: int, chunk: int,
                          y0: int = 0) -> torch.Tensor:
    """K8a's wrapper: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. consts (T, 16) in chunks of ``chunk`` <= 128 rows,
    every chunk swept; returns (H*W,) int32 for rows [y0, y0 + H)."""
    global LAUNCHES_WINNER_CHUNKED
    if not _route(consts):
        return resolve_winner_chunked_reference(consts, H, W, chunk, y0)
    _check(consts, H, W, None, chunk)
    idx = torch.empty((H * W,), dtype=torch.int32, device=consts.device)
    with torch.cuda.device(consts.device):
        launch_winner_masked_kernel(consts, H, W, None, chunk, idx, y0)
    LAUNCHES_WINNER_CHUNKED += 1
    return idx


def resolve_winner(consts: torch.Tensor, H: int, W: int,
                   tri_chunk: int = 128, screen_verts: tuple | None = None,
                   y0: int = 0) -> torch.Tensor:
    """Winning triangle per pixel of rows [y0, y0 + H) of a frame W wide,
    dispatched as ``resolve_winner_pallas``: one chunk (T <= min(tri_chunk,
    128)) goes to K8b, several with ``screen_verts`` = (sx, sy, zinv) to K8c
    with chunk_screen_mask over its tiles, several without to K8a. Returns
    (H*W,) int32."""
    chunk = min(tri_chunk, MAX_CHUNK)
    if consts.shape[0] <= chunk:
        return raster_winner(consts, H, W, y0)
    if screen_verts is None:
        return raster_winner_chunked(consts, H, W, chunk, y0)
    sx, sy, zinv = screen_verts
    xmin, xmax, ymin, ymax = tile_rects(H, W, consts.device)
    mask = chunk_screen_mask(sx, sy, zinv, consts[:, 12],
                             (xmin, xmax, ymin + y0, ymax + y0), chunk)
    return raster_winner_masked(consts, H, W, mask, chunk, y0)


def raster_cull_probe(consts: torch.Tensor, H: int, W: int,
                      y0: int = 0) -> dict:
    """The card's check of K8a's and K8c's cull (csrc/raster.cu::
    raster_cull_probe_kernel): every row of the (T, 16) CUDA table decided
    by the device's tile_reject for every 16 x 16 tile of rows [y0, y0 + H)
    of a frame W wide, and each rejected row tested at every pixel of its
    tile with the sweep's own test. Returns the counts: ``rejected`` (tile,
    row) pairs, ``covered`` (pixel, row) pairs among them (0 where the cull
    is exact) and ``pairs`` in all. Counts no launch."""
    _check(consts, H, W, None, MAX_CHUNK)
    counts = torch.zeros(3, dtype=torch.int64, device=consts.device)
    with torch.cuda.device(consts.device):
        err = _build.load().raytpu_raster_cull_probe(
            consts.data_ptr(), consts.shape[0], H, W, y0, counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"raster_cull_probe launch failed: CUDA error "
                           f"{err}")
    rejected, covered, pairs = counts.tolist()
    return dict(rejected=rejected, covered=covered, pairs=pairs)
