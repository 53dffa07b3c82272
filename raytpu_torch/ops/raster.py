"""Pixel-major rasterization, plain PyTorch (counterpart of
raytpu/ops/raster.py). The parity path: it has no kernel in the JAX
package either, so it runs as plain torch on every device.

The pipeline, the reference's scanline rasteriser turned pixel-major
(`rasteriser/Source/rasteriser.cpp:461-768`):
  1. vertex_stage    batched VertexShader (`:532-546`).
  2. cull_mask       backface and frustum masks (`:404-447`).
  3. row_bounds      per-(triangle, row) left/right extremes, closed form;
     row_bounds_exact the reference's float walk replayed bit for bit
                     (`ComputePolygonRows`/`Interpolate`, `:615-735`).
  4. resolve_depth   coverage and the z-test ``zinv > depth`` in triangle
                     order, i.e. the largest zinv, first triangle on ties.
  5. pixel_shade     the deferred PixelShader (`:549-589`), no shadows.

Integers stay int32 as in JAX, sentinels included: ``_INTMAX`` arithmetic
wraps there and here alike, and the wrapped values are masked before they
reach an output (resolve_depth).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytpu_torch.core.types import (
    Camera,
    Lights,
    RenderConfig,
    Scene,
    dot3,
    matmul3,
)
from raytpu_torch.ops.shade import irradiance_no_shadow

_INTMAX = 2147483647


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts (``astype(jnp.int32)``): values
    beyond the range saturate and NaN becomes 0; in range it truncates."""
    out = x.clamp(-2147483648.0, 2147483520.0).to(torch.int32)
    out = torch.where(x >= 2147483648.0, _INTMAX, out)
    return torch.where(torch.isnan(x), 0, out)


def glm_inverse3(m: torch.Tensor) -> torch.Tensor:
    """3x3 inverse as adjugate / det in float32, glm::inverse's op order."""
    det = (m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
           - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
           + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]))
    inv_det = 1.0 / det
    adj = torch.stack([
        torch.stack([m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1],
                     -(m[0, 1] * m[2, 2] - m[0, 2] * m[2, 1]),
                     m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]]),
        torch.stack([-(m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0]),
                     m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0],
                     -(m[0, 0] * m[1, 2] - m[0, 2] * m[1, 0])]),
        torch.stack([m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0],
                     -(m[0, 0] * m[2, 1] - m[0, 1] * m[2, 0]),
                     m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]]),
    ])
    return adj * inv_det


class VertexData(NamedTuple):
    """Screen-space data of every triangle vertex.

    px, py: (T, 3) int32 screen coords (truncated, `rasteriser.cpp:544-545`).
    zinv:   (T, 3) float32 1/z in camera space (`:541`).
    pos3d:  (T, 3, 3) float32 camera-space position / z (`:538`).
    """

    px: torch.Tensor
    py: torch.Tensor
    zinv: torch.Tensor
    pos3d: torch.Tensor


def vertex_stage(scene: Scene, camera: Camera,
                 cfg: RenderConfig) -> VertexData:
    """Batched VertexShader over all 3T vertices: ``(v - C) * R``."""
    verts = torch.stack([scene.v0, scene.v1, scene.v2], dim=1)  # (T, 3, 3)
    pos = matmul3(verts - camera.pos, camera.rotation())
    zinv = 1.0 / pos[..., 2]
    pos3d = pos * zinv[..., None]
    # Truncation to int BEFORE adding W/2 (`:544-545`).
    px = to_i32(torch.trunc(camera.focal * (pos[..., 0] * zinv)))
    py = to_i32(torch.trunc(camera.focal * (pos[..., 1] * zinv)))
    return VertexData(px=px + cfg.width // 2, py=py + cfg.height // 2,
                      zinv=zinv, pos3d=pos3d)


def cull_mask(scene: Scene, camera: Camera,
              cfg: RenderConfig) -> torch.Tensor:
    """Triangle keep-mask (float32): active, not backfacing, not outside
    the frustum.

    Backface: ``dot(v0 - cameraPos, normal) > 0`` culls (`:410`). Frustum:
    the reference's fovy matrix with transform[3][2] overwritten to 1.0
    (`:402`) reduces to an x, y NDC bounds test with w' = z; a triangle is
    culled when ALL three vertices are outside (`:444-445`).
    """
    keep = scene.active > 0.0
    if cfg.backface_cull:
        keep = keep & ~(dot3(scene.v0 - camera.pos, scene.normals()) > 0.0)
    if cfg.frustum_cull:
        h = float(np.float32(cfg.height))
        w = float(np.float32(cfg.width))
        zero = torch.zeros_like(camera.focal)
        t = torch.stack([zero, zero - h / 2.0, camera.focal])
        b = torch.stack([zero, zero + h / 2.0, camera.focal])
        cy = dot3(t, b) / (torch.sqrt(dot3(t, t)) * torch.sqrt(dot3(b, b)))
        k = 1.0 / torch.tan(torch.arccos(cy) / 2.0)
        aspect = float(np.float32(w) / np.float32(h))
        rot = camera.rotation()

        def ndc_inside(v):
            cs = matmul3(v - camera.pos, rot)
            x = (cs[:, 0] * (k / aspect)) / cs[:, 2]
            y = (cs[:, 1] * k) / cs[:, 2]
            return (x >= -1) & (x <= 1) & (y >= -1) & (y <= 1)

        keep = keep & (ndc_inside(scene.v0) | ndc_inside(scene.v1)
                       | ndc_inside(scene.v2))
    return keep.to(torch.float32)


class RowBounds(NamedTuple):
    """Per-(triangle, screen row) scanline extremes.

    left_x/right_x: (T, H) int32 (INT_MAX / -INT_MAX where the row is not
    covered). left_z/right_z: (T, H) float32. left_p/right_p: (T, H, 3).
    """

    left_x: torch.Tensor
    right_x: torch.Tensor
    left_z: torch.Tensor
    right_z: torch.Tensor
    left_p: torch.Tensor
    right_p: torch.Tensor


def _empty_bounds(T: int, H: int, device) -> RowBounds:
    zeros = torch.zeros((T, H), dtype=torch.float32, device=device)
    return RowBounds(
        torch.full((T, H), _INTMAX, dtype=torch.int32, device=device),
        torch.full((T, H), -_INTMAX, dtype=torch.int32, device=device),
        zeros, zeros, zeros[..., None].expand(T, H, 3),
        zeros[..., None].expand(T, H, 3))


def _merge(b: RowBounds, vis, x, z, p) -> RowBounds:
    """One edge's samples into the bounds: the left/right extremes update
    on STRICT inequality (`:716-733`). vis (T, H) marks the rows the edge
    visits; x, z, p its samples there."""
    xl = torch.where(vis, x, _INTMAX)
    upd_l = xl < b.left_x
    xr = torch.where(vis, x, -_INTMAX)
    upd_r = xr > b.right_x
    return RowBounds(
        torch.where(upd_l, xl, b.left_x), torch.where(upd_r, xr, b.right_x),
        torch.where(upd_l, z, b.left_z), torch.where(upd_r, z, b.right_z),
        torch.where(upd_l[..., None], p, b.left_p),
        torch.where(upd_r[..., None], p, b.right_p))


def _edge(vd: VertexData, i: int):
    """Edge i -> (i + 1) % 3 of every triangle: its endpoints and the
    per-sample steps ``(end - start) / max(|dy|, 1)``."""
    j = (i + 1) % 3
    xi, xj = vd.px[:, i], vd.px[:, j]
    yi, yj = vd.py[:, i], vd.py[:, j]
    zi, zj = vd.zinv[:, i], vd.zinv[:, j]
    pi, pj = vd.pos3d[:, i], vd.pos3d[:, j]
    denom = (yj - yi).abs().clamp_min(1).to(torch.float32)
    return dict(xi=xi, xj=xj, yi=yi, yj=yj, zi=zi, pi=pi,
                sx=(xj - xi).to(torch.float32) / denom,
                sz=(zj - zi) / denom, sp=(pj - pi) / denom[:, None])


def _closed_form(e: dict, y_rows: torch.Tensor, rows_ok: torch.Tensor):
    """The edge's samples at every screen row, ``a + k * step`` with k =
    |y - y_i|, and the rows it visits (within ``rows_ok`` (T, 1))."""
    yi, yj = e["yi"][:, None], e["yj"][:, None]
    vis = rows_ok & (y_rows >= torch.minimum(yi, yj)) & (
        y_rows <= torch.maximum(yi, yj))
    kf = (y_rows - yi).abs().to(torch.float32)
    x = to_i32(torch.trunc(e["xi"][:, None].to(torch.float32)
                           + kf * e["sx"][:, None]))
    z = e["zi"][:, None] + kf * e["sz"][:, None]
    p = e["pi"][:, None, :] + kf[..., None] * e["sp"][:, None, :]
    return vis, x, z, p


def row_bounds(vd: VertexData, cfg: RenderConfig) -> RowBounds:
    """ComputePolygonRows, vectorized over (triangle, row), each edge's
    sample at row y in closed form (k = |y - y_i|, ``a + k * step``); the
    non-parity modes use it."""
    T, H = vd.px.shape[0], cfg.height
    y_rows = torch.arange(H, dtype=torch.int32, device=vd.px.device)[None]
    bounds = _empty_bounds(T, H, vd.px.device)
    all_rows = torch.ones((T, 1), dtype=torch.bool, device=vd.px.device)
    for i in range(3):
        bounds = _merge(bounds, *_closed_form(_edge(vd, i), y_rows, all_rows))
    return bounds


def row_bounds_exact(vd: VertexData, cfg: RenderConfig) -> RowBounds:
    """ComputePolygonRows with the reference's float ACCUMULATION, bit for
    bit (`Interpolate`, `rasteriser.cpp:615-637`): each edge walks
    ``current += step`` in float32 and truncates x per sample, so sample k
    is k chained rounded adds, with no closed form.

    The JAX package scans 2H steps per edge, scattering each step into
    (T, H) tables. Here the walk runs once for all three edges, one add of
    a (T, 3, 5) tensor a step (x, zinv, pos3d), for ``max |dy| + 1`` steps
    (capped at 2H): a sample with k > |dy| is never used, so the tables
    are the same. Within one edge every (triangle, row) is visited at most
    once (row ``y_i + k * sign(dy)``), so an edge's samples land in its
    rows with one scatter; the edges then merge in order, preserving the
    strict-inequality tie order (`:716-733`). Edges that start outside
    [-H, 2H) cannot reach the screen within 2H samples and take the
    closed-form sample instead, as in the JAX package.
    """
    T, H = vd.px.shape[0], cfg.height
    dev = vd.px.device
    y_rows = torch.arange(H, dtype=torch.int32, device=dev)[None]
    bounds = _empty_bounds(T, H, dev)
    edges = [_edge(vd, i) for i in range(3)]
    dy = torch.stack([e["yj"] - e["yi"] for e in edges], dim=1)  # (T, 3)
    yi = torch.stack([e["yi"] for e in edges], dim=1)
    in_horizon = (yi >= -H) & (yi < 2 * H)
    ady = dy.abs()
    steps = min(int(torch.where(in_horizon, ady, 0).max()) + 1, 2 * H)
    cur = torch.stack([torch.cat([e["xi"].to(torch.float32)[:, None],
                                  e["zi"][:, None], e["pi"]], dim=1)
                       for e in edges], dim=1)  # (T, 3, 5)
    inc = torch.stack([torch.cat([e["sx"][:, None], e["sz"][:, None],
                                  e["sp"]], dim=1) for e in edges], dim=1)
    walk = [cur]
    for _ in range(steps - 1):
        walk.append(walk[-1] + inc)
    walk = torch.stack(walk, dim=1)  # (T, K, 3, 5)
    k = torch.arange(steps, dtype=torch.int32, device=dev)[None]
    for i, e in enumerate(edges):
        r = e["yi"][:, None] + k * dy[:, i:i + 1].sign()  # (T, K)
        ok = ((k <= ady[:, i:i + 1]) & in_horizon[:, i:i + 1] & (r >= 0)
              & (r < H))
        # Unvisited samples go to a spare column H, dropped below.
        col = torch.where(ok, r, H).long()
        w = walk[:, :, i]

        def land(src, fill=0):
            shape = (T, H + 1) + tuple(src.shape[2:])
            idx = col.reshape(col.shape + (1,) * (src.dim() - 2)).expand(
                src.shape)
            return torch.full(shape, fill, dtype=src.dtype,
                              device=dev).scatter(1, idx, src)[:, :H]

        bounds = _merge(bounds, land(ok, False),
                        land(to_i32(torch.trunc(w[..., 0]))), land(w[..., 1]),
                        land(w[..., 2:]))
        bounds = _merge(bounds, *_closed_form(e, y_rows,
                                              ~in_horizon[:, i:i + 1]))
    return bounds


class GBuffer(NamedTuple):
    """Per-pixel closest-surface attributes (flattened R = H*W).

    idx: (R,) int32 winning triangle (-1 = background). zinv: (R,) float32.
    pos3d: (R, 3) float32 interpolated camera-space pos / z.
    """

    idx: torch.Tensor
    zinv: torch.Tensor
    pos3d: torch.Tensor


def check_raster_chunk(T: int, cfg: RenderConfig) -> int:
    """resolve_depth's triangle chunk, min(raster_tri_chunk, T). Raises
    ValueError where T is not a multiple of it, as the JAX package does
    (ROADMAP fault F8: that refuses most STL scenes in parity mode)."""
    chunk = min(cfg.raster_tri_chunk, T)
    if T % chunk != 0:
        raise ValueError(f"triangle count {T} not a multiple of {chunk}")
    return chunk


def resolve_depth(bounds: RowBounds, keep: torch.Tensor,
                  cfg: RenderConfig) -> GBuffer:
    """Pixel-major coverage and depth resolve.

    Pixel (x, y) is covered by a triangle when ``left_x < x <= right_x``
    on its row (the reference's Bresenham skips the leftmost pixel,
    `:651-653`) and its zinv beats the buffer (``zinv > depth``, cleared
    to 0: `:606, :188`). Attributes lag one pixel: ``attr(x) = a + step *
    (x - a.x - 1)`` (`:665-668`). Triangles go in chunks of
    ``cfg.raster_tri_chunk`` ((C, H, W) fields, 64 MB a float tensor at
    500^2 and C = 64); ties keep the earliest triangle.
    """
    T, H = bounds.left_x.shape
    W = cfg.width
    dev = bounds.left_x.device
    xs = torch.arange(W, dtype=torch.int32, device=dev)[None, None, :]
    chunk = check_raster_chunk(T, cfg)

    def chunk_best(lo: int):
        sl = slice(lo, lo + chunk)
        lx = bounds.left_x[sl][:, :, None]
        rx = bounds.right_x[sl][:, :, None]
        covered = (xs > lx) & (xs <= rx) & (keep[sl] > 0.0)[:, None, None]
        # Uncovered rows hold the sentinels, whose difference wraps; their
        # pixels are masked by `covered`.
        dx = (bounds.right_x[sl] - bounds.left_x[sl]).to(torch.float32)
        zstep = torch.where(dx > 0, (bounds.right_z[sl] - bounds.left_z[sl])
                            / torch.clamp_min(dx, 1.0), 0.0)
        i_rel = (xs - lx - 1).to(torch.float32)
        z = bounds.left_z[sl][:, :, None] + zstep[:, :, None] * i_rel
        z = torch.where(covered, z, -torch.inf)
        best_local = torch.argmax(z, dim=0)  # the first of equal maxima
        return z.gather(0, best_local[None])[0], best_local.to(torch.int32)

    best_z, best_idx = chunk_best(0)
    for lo in range(chunk, T, chunk):
        z, local = chunk_best(lo)
        upd = z > best_z  # strictly greater: the earlier chunk keeps ties
        best_z = torch.where(upd, z, best_z)
        best_idx = torch.where(upd, local + lo, best_idx)

    hit = torch.isfinite(best_z) & (best_z > 0.0)
    idx = torch.where(hit, best_idx, -1)

    # The winner's attributes, from its row bounds.
    safe = idx.clamp_min(0).long()
    y_grid = torch.arange(H, device=dev)[:, None].expand(H, W)
    lx = bounds.left_x[safe, y_grid]
    lz, rz = bounds.left_z[safe, y_grid], bounds.right_z[safe, y_grid]
    lp, rp = bounds.left_p[safe, y_grid], bounds.right_p[safe, y_grid]
    dx_safe = torch.clamp_min(
        (bounds.right_x[safe, y_grid] - lx).to(torch.float32), 1.0)
    i_rel = (xs[0] - lx - 1).to(torch.float32)
    zpx = lz + ((rz - lz) / dx_safe) * i_rel
    ppx = lp + ((rp - lp) / dx_safe[..., None]) * i_rel[..., None]
    return GBuffer(
        idx=idx.reshape(-1),
        zinv=torch.where(hit, zpx, 0.0).reshape(-1),
        pos3d=torch.where(hit[..., None], ppx, 0.0).reshape(-1, 3))


def pixel_shade(g: GBuffer, scene: Scene, camera: Camera, lights: Lights,
                cfg: RenderConfig):
    """Deferred PixelShader (`rasteriser.cpp:549-589`): the world position
    ``(pos3d / zinv) * R^-1 + C`` (`:554-560`), inverse-square Lambert per
    light with NO shadow test (`:567-584`), ``(result + ambient) *
    albedo`` (`:587`). Returns (color (R, 3), focal_distance (R,))."""
    hit = g.idx >= 0
    safe = g.idx.clamp_min(0).long()
    inv_rot = glm_inverse3(camera.rotation())
    zinv_safe = torch.where(hit, g.zinv, 1.0)
    world = matmul3(g.pos3d / zinv_safe[:, None], inv_rot) + camera.pos
    # Guarded norm: sqrt(0) has an infinite derivative.
    rel = world - camera.pos
    cam_d2 = dot3(rel, rel)
    cam_d = torch.sqrt(torch.where(cam_d2 > 0.0, cam_d2, 1.0))
    fd = torch.where(hit & (cam_d2 > 0.0), cam_d - camera.dof_focus, 0.0)
    result = irradiance_no_shadow(world, scene.normals()[safe], lights)
    ambient = float(np.float32(cfg.ambient))
    color = (result + ambient) * scene.color[safe]
    return torch.where(hit[:, None], color, 0.0), fd
