"""The soft rasterizer and the hard limit of the soft paths (counterpart of
the rasterizer half of raytpu/render/soft.py).

  * ``rasterize_soft`` — the differentiable rasterizer: per pixel, a
    softmax over triangle logits ``zs * zinv + log_sigmoid(es * sdist) +
    log(valid)`` and a background at logit 0 (the reference's cleared depth
    buffer, `rasteriser.cpp:188,606`) aggregates attributes (albedo, pos3d
    numerator, zinv, normal); ``shade_agg_raster`` shades the aggregate
    once per pixel. The aggregation runs in the soft raster kernels
    (raytpu_torch.kernels.soft_raster: K9a/K9b forward, K9c/K9d backward)
    on CUDA tensors and in their plain versions on the CPU. The JAX
    package's jnp streaming path (chunks of ``raster_tri_chunk``) is its
    kernel's math reassociated; the port has the kernel's math only.
  * ``rasterize_exact`` — the float-precise HARD rasterizer of mode
    'clean', the soft path's limit. Screen vertices are floats (no
    truncation); a pixel's winner is the first triangle with the largest
    covered zinv at its integer corner, found by the raster kernels
    (raytpu_torch.kernels.raster: K8b for one chunk, K8c for several) on
    constants computed from detached tensors: the winner is piecewise
    constant. Only the winner's attributes are then recomputed
    (``_shade_winner``) and shaded without shadows, and autograd
    differentiates that recompute, as ``jax.grad`` does through the JAX
    package's stop_gradient'ed winner.

  * ``raytrace_soft`` — the differentiable raytracer: per ray, a softmax
    over triangle logits ``zs * zinv + log_sigmoid(es * margin) +
    log(active)`` (zinv the bounded inverse metric depth of the ray-plane
    hit, margin the barycentric margin) and a background at logit 0
    aggregates (albedo, hit position, normal); an optical-depth shadow
    ``exp(-16 od)`` toward each shadow source scales the direct term of
    ``shade_agg_raytrace``. The aggregation and the shadow run in the soft
    raytrace kernels (raytpu_torch.kernels.soft_raytrace: K10a/K10g
    forward, K10c/K10i backward; where the JAX package culls, the masked
    K10b/K10h and K10d/K10j with keep-masks on the port's 16 x 16 pixel
    tiles). The JAX package's jnp streaming path is that math
    reassociated; the port has the kernels' math only.
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
    matmul3,
    pixel_grid,
)
from raytpu_torch.kernels import soft_raytrace as srt
from raytpu_torch.kernels.intersect import TILE_RAYS, RayTiles, ray_tiles
from raytpu_torch.kernels.raster import raster_tri_constants, resolve_winner
from raytpu_torch.kernels import soft_raster as sr
from raytpu_torch.kernels.raster import tile_rects
from raytpu_torch.kernels.soft_raster import clip01, use_cull
from raytpu_torch.ops.intersect import gather_rows, one_hot_idx
from raytpu_torch.ops.raster import cull_mask, glm_inverse3
from raytpu_torch.ops.shade import irradiance_no_shadow, source_positions


class SoftRasterInputs(NamedTuple):
    """The soft raster kernels' inputs for a frame (rasterize_soft_inputs):
    the (Tp, 32) table, Tp a multiple of chunk, carrying the autograd graph
    of scene and camera; the keep-mask (n_tiles, n_chunks) int32 over the
    16 x 16 tiles of kernels/raster.py::tile_rects where the frame culls,
    else None; and the sharpness."""

    consts: torch.Tensor
    chunk: int
    mask: torch.Tensor | None
    es: float
    zs: float


def soft_chunk(T: int, chunk: int = sr.MAX_CHUNK) -> int:
    """Rows a chunk of a soft table of T triangles: min(chunk, max(T, 8)),
    as the JAX package's soft frames take it."""
    return min(chunk, max(T, 8))


def rasterize_soft_inputs(scene: Scene, camera: Camera, cfg: RenderConfig,
                          cull: bool | None = None,
                          chunk: int = sr.MAX_CHUNK) -> SoftRasterInputs:
    """The kernels' inputs for a soft frame, as ``rasterize_soft_pallas``
    builds them: the table padded to a whole number of chunks of
    min(chunk, max(T, 8)) rows (T == 0 takes one all-invalid chunk, the
    background), and the keep-mask where ``use_cull`` culls."""
    H, W = cfg.height, cfg.width
    sx, sy, zinv, pos3d = _screen_vertices(scene, camera, cfg)
    consts = sr.soft_tri_constants(sx, sy, zinv, pos3d, scene.color,
                                   scene.normals(), scene.active)
    T = consts.shape[0]
    chunk = soft_chunk(T, chunk)
    pad = chunk if T == 0 else (-T) % chunk
    if pad:
        consts = torch.cat([consts, consts.new_zeros(pad, sr.CONST_COLS)])
    es = float(cfg.soft_edge_sharpness)
    zs = float(cfg.soft_z_sharpness)
    mask = None
    if use_cull(cull, consts.shape[0] // chunk, H, W):
        mask = sr.soft_keep_mask(tile_rects(H, W, consts.device),
                                 consts.detach(), es, zs, chunk)
    return SoftRasterInputs(consts, chunk, mask, es, zs)


def rasterize_soft(scene: Scene, camera: Camera, lights: Lights,
                   cfg: RenderConfig, cull: bool | None = None,
                   chunk: int = sr.MAX_CHUNK) -> torch.Tensor:
    """Differentiable rasterize; returns (H, W, 3). The JAX package's
    ``rasterize_soft_pallas``: the soft z-buffer through the soft raster
    kernels (``SoftAgg``: K9a, or K9b where the frame culls; the backward
    K9c or K9d), then ``shade_agg_raster``. Gradients reach the scene
    (``active`` too, through log(valid)), the camera (through the screen
    vertices) and the lights (through the shading).

    ``cull`` None culls where the JAX package would (several chunks, an
    image that blocks into its 1,024-pixel tiles); True culls or raises
    ValueError where the image does not block; False runs K9a at any size.
    ``chunk``: rows a chunk, at most 32."""
    H, W = cfg.height, cfg.width
    inp = rasterize_soft_inputs(scene, camera, cfg, cull, chunk)
    agg = sr.SoftAgg.apply(inp.consts, H, W, inp.chunk, inp.mask, inp.es,
                           inp.zs).T
    img = shade_agg_raster(agg[:, 0:3], agg[:, 3:6], agg[:, 6], agg[:, 7:10],
                           camera, lights, float(np.float32(cfg.ambient)))
    return img.reshape(H, W, 3)


class SoftRtInputs(NamedTuple):
    """The soft raytrace kernels' inputs for a frame (raytrace_soft_inputs).

    pri, shw: the (Tp, 32) and (Tp, 16) tables, Tp a multiple of chunk.
    dirs: (3, H*W) ray directions, row-major over the image.
    tiles, mask: the culled frame's ray tiles (kernels/intersect.py::
      ray_tiles, 16 x 16 pixels) and the primary keep-mask (n_tiles,
      n_chunks) int32 over them; None where the frame does not cull.
    """

    pri: torch.Tensor
    shw: torch.Tensor
    dirs: torch.Tensor
    chunk: int
    es: float
    zs: float
    tiles: RayTiles | None
    mask: torch.Tensor | None


def raytrace_soft_inputs(scene: Scene, camera: Camera, cfg: RenderConfig,
                         cull: bool | None = None,
                         chunk: int = srt.MAX_CHUNK) -> SoftRtInputs:
    """The kernels' inputs for a soft frame, as ``raytrace_soft_pallas``
    builds them: both tables padded to a whole number of chunks of
    min(chunk, max(T, 8)) rows (T == 0 takes one all-zero chunk), the ray
    directions and the sharpness, carrying the autograd graph of scene and
    camera; where the frame culls (``use_cull``: auto on several chunks at
    a size that blocks into JAX's 1,024-pixel tiles, or cull True), the ray
    tiles and the primary keep-mask, made on the device from detached
    tensors."""
    from raytpu_torch.render.raytrace import camera_ray_dirs

    H, W = cfg.height, cfg.width
    chunk = soft_chunk(scene.num_triangles, chunk)
    pri = srt.pad_rows(srt.primary_tri_constants(scene, camera.pos), chunk)
    culled = use_cull(cull, pri.shape[0] // chunk, H, W)
    shw = srt.pad_rows(srt.shadow_tri_constants(scene), chunk)
    xs, ys = pixel_grid(H, W, scene.device)
    dirs = camera_ray_dirs(xs, ys, camera, cfg).T.contiguous()
    es, zs = float(cfg.soft_edge_sharpness), float(cfg.soft_z_sharpness)
    tiles = mask = None
    if culled:
        tiles = ray_tiles(H * W, (H, W), scene.device)
        with torch.no_grad():
            mask = srt.soft_rt_keep_mask(
                dirs.detach().T[tiles.rays], camera.pos.detach(),
                scene.v0.detach(), scene.v1.detach(), scene.v2.detach(), es,
                zs, srt.T_NEAR, TILE_RAYS, chunk)
    return SoftRtInputs(pri, shw, dirs, chunk, es, zs, tiles, mask)


def raytrace_soft(scene: Scene, camera: Camera, lights: Lights,
                  cfg: RenderConfig, cull: bool | None = None,
                  chunk: int = srt.MAX_CHUNK) -> torch.Tensor:
    """Differentiable raytrace; returns (H, W, 3). The JAX package's
    ``raytrace_soft_pallas``: the primary aggregation (``PrimaryAgg``:
    K10a, or K10b where the frame culls) of albedo, hit position and
    normal, then the optical-depth shadow (``ShadowTrans``: K10g, or K10h
    with the shadow keep-mask of the aggregated positions) toward the
    shadow sources, each light's first ``soft_shadow_samples`` jittered
    positions (light-major) when that is above 1, else the lights'
    positions; a light's shadow is the mean over its sources, and the
    frame's sum of mask * shadow / max(sum of mask, 1). The light bank is
    taken as given: inactive slots' sources are traced too and weigh 0.
    Gradients reach every leaf of scene, camera and lights (the backward:
    K10c/K10i, or K10d/K10j; above JAX's fused limit, 32,768 triangles for
    the primary pass and 65,536 for the shadow's, K10e + K10f and K10k +
    K10l without the masks).

    ``cull`` None culls where the JAX package would (several chunks, an
    image that blocks into its 1,024-pixel tiles); True culls or raises
    ValueError where the image does not block; False runs the unmasked
    kernels at any size. ``chunk``: rows a chunk, at most 32."""
    H, W = cfg.height, cfg.width
    inp = raytrace_soft_inputs(scene, camera, cfg, cull, chunk)
    out = srt.PrimaryAgg.apply(inp.pri, camera.pos, inp.dirs, inp.es,
                               inp.zs, inp.chunk, inp.mask, inp.tiles)
    samples = max(cfg.soft_shadow_samples, 1)
    srcs = source_positions(lights, samples).contiguous()
    smask = None
    if inp.tiles is not None:
        with torch.no_grad():
            smask = srt.soft_rt_shadow_mask(
                out.detach()[3:6].T[inp.tiles.rays], srcs.detach(),
                scene.v0.detach(), scene.v1.detach(), scene.v2.detach(),
                inp.es, inp.zs, TILE_RAYS, inp.chunk)
    trans = srt.ShadowTrans.apply(inp.shw, srcs, out[3:6], inp.es, inp.zs,
                                  inp.chunk, smask, inp.tiles)
    per_light = trans.reshape(lights.capacity, samples, -1).mean(dim=1)
    denom = torch.maximum(lights.mask.sum(), lights.mask.new_ones(()))
    shadow = (lights.mask[:, None] * per_light).sum(dim=0) / denom
    img = shade_agg_raytrace(out[0:3].T, out[3:6].T, out[6:9].T, lights,
                             float(np.float32(cfg.ambient)), shadow)
    return img.reshape(H, W, 3)


def shade_agg_raytrace(alb, pos, nrm, lights: Lights, ambient: float,
                       shadow) -> torch.Tensor:
    """Shade the aggregated raytrace surface once per ray: irradiance at the
    aggregated (position, normal) scaled by the shadow transmittance, then
    albedo and ambient as in 'clean'. alb, pos, nrm (..., 3); shadow
    (...,); returns (..., 3)."""
    irr = irradiance_no_shadow(pos, nrm, lights)
    return alb * (irr * shadow[..., None] + float(np.float32(ambient)))


def shade_agg_raster(alb, ppx, zpx, nrm, camera: Camera, lights: Lights,
                     ambient: float) -> torch.Tensor:
    """Shade the aggregated raster surface once per pixel: the world point
    rebuilt from the aggregated pos3d numerator and zinv (in the hard limit
    the winner's `rasteriser.cpp:557` reconstruction), then irradiance
    without shadows. alb, ppx, nrm (..., 3); zpx (...,); returns (..., 3).

    ``zpx > 1e-6`` gates the division, not an epsilon guard as in
    ``_shade_winner``: background-dominated pixels have zpx ~ 0, and a
    1e-12 guard would amplify their cotangents by 1 / zpx^2 although the
    forward is masked by their near-zero albedo; there the point is shaded
    at z = 1 with bounded gradients."""
    inv_rot = glm_inverse3(camera.rotation())
    vis = zpx > 1e-6
    zsafe = torch.where(vis, zpx, 1.0)
    world = matmul3(ppx / zsafe[..., None], inv_rot) + camera.pos
    irr = irradiance_no_shadow(world, nrm, lights)
    return alb * (irr + float(np.float32(ambient)))


def _screen_vertices(scene: Scene, camera: Camera, cfg: RenderConfig):
    """Float screen coordinates (no truncation), zinv and pos3d of every
    vertex: sx, sy, zinv (T, 3) and pos3d (T, 3, 3)."""
    verts = torch.stack([scene.v0, scene.v1, scene.v2], dim=1)
    pos = matmul3(verts - camera.pos, camera.rotation())
    zinv = 1.0 / pos[..., 2]
    sx = camera.focal * pos[..., 0] * zinv + cfg.width / 2.0
    sy = camera.focal * pos[..., 1] * zinv + cfg.height / 2.0
    return sx, sy, zinv, pos * zinv[..., None]


def rasterize_exact(scene: Scene, camera: Camera, lights: Lights,
                    cfg: RenderConfig) -> torch.Tensor:
    """The float-precise HARD rasterizer; returns (H, W, 3).

    A pixel is covered where its signed distance is >= 0; the largest
    covered zinv > 0 wins (background where none, the cleared depth
    buffer). The reference's backface culling applies (`rasteriser.cpp:
    404-412`); frustum culling stays parity-only, as in the JAX package.
    DoF is not applied (ROADMAP fault F9, as in the JAX package).
    """
    H, W = cfg.height, cfg.width
    sx, sy, zinv, pos3d = _screen_vertices(scene, camera, cfg)
    px, py = pixel_grid(H, W, sx.device)  # the integer pixel corners
    with torch.no_grad():
        keep = cull_mask(scene, camera, cfg.replace(frustum_cull=False))
        consts = raster_tri_constants(sx, sy, zinv, keep)
        winner = resolve_winner(consts, H, W, screen_verts=(sx, sy, zinv))
    img = _shade_winner(winner, px, py, sx, sy, zinv, pos3d, scene, camera,
                        lights, cfg)
    return img.reshape(H, W, 3)


def _shade_winner(winner, px, py, sx, sy, zinv, pos3d, scene: Scene,
                  camera: Camera, lights: Lights,
                  cfg: RenderConfig) -> torch.Tensor:
    """Shade each pixel's winning triangle only: its barycentrics and
    attributes recomputed per pixel (O(R), not O(R T)), then the clean
    PixelShader. winner (R,) int32, -1 for background; returns (R, 3).

    Up to T = 1024 the winner's rows come from one (R, T) one-hot product,
    as in the JAX package; above that, where the one-hot would not fit,
    from indexing. Both give each row exactly, but indexing's backward on
    CUDA (an accumulating index_put) walks a row's duplicate indices in
    turn: on an H100 it took 44 ms of a 512^2 Cornell train step, where
    ~12k pixels share each winning row, against 1.8 ms for the whole
    step's device work with the one-hot product."""
    hit = winner >= 0
    T = sx.shape[0]
    if T <= 1024:
        g = gather_rows(one_hot_idx(winner, T), torch.cat(
            [sx, sy, zinv, pos3d.reshape(T, 9), scene.normals(),
             scene.color], dim=1))
        vx, vy, vz = g[:, 0:3], g[:, 3:6], g[:, 6:9]
        vp = g[:, 9:18].reshape(-1, 3, 3)
        n_dir, albedo = g[:, 18:21], g[:, 21:24]
    else:
        safe = winner.clamp_min(0).long()
        vx, vy, vz, vp = sx[safe], sy[safe], zinv[safe], pos3d[safe]
        n_dir, albedo = scene.normals()[safe], scene.color[safe]

    ax, ay = vx[:, 0], vy[:, 0]
    bx, by = vx[:, 1], vy[:, 1]
    cx, cy = vx[:, 2], vy[:, 2]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    area_safe = torch.where(area.abs() > 1e-12, area, 1e-12)
    l0 = ((bx - px) * (cy - py) - (by - py) * (cx - px)) / area_safe
    l1 = ((cx - px) * (ay - py) - (cy - py) * (ax - px)) / area_safe
    l2 = 1.0 - l0 - l1
    l0c, l1c, l2c = clip01(l0), clip01(l1), clip01(l2)
    lsum = l0c + l1c + l2c + 1e-12
    l0c, l1c, l2c = l0c / lsum, l1c / lsum, l2c / lsum

    zpx = l0c * vz[:, 0] + l1c * vz[:, 1] + l2c * vz[:, 2]
    ppx = (l0c[:, None] * vp[:, 0] + l1c[:, None] * vp[:, 1]
           + l2c[:, None] * vp[:, 2])
    inv_rot = glm_inverse3(camera.rotation())
    zsafe = torch.where(zpx.abs() > 1e-12, zpx, 1e-12)
    world = matmul3(ppx / zsafe[:, None], inv_rot) + camera.pos
    irr = irradiance_no_shadow(world, n_dir, lights)
    color = albedo * (irr + float(np.float32(cfg.ambient)))
    return torch.where(hit[:, None], color, 0.0)
