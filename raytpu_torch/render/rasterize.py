"""Public rasterize API (counterpart of raytpu/render/rasterize.py).

The pixel-major redesign of the reference's scanline rasteriser
(`rasteriser/Source/rasteriser.cpp`); modes follow RenderConfig.mode:

  * 'parity' — scanline-faithful coverage (the float edge walk, the
    Bresenham left-pixel skip, the attribute lag, truncated vertex
    coordinates) and CalculateDOF's border: ops/raster.py, plain torch on
    every device (the JAX package has no kernel there either).
  * 'clean'  — the float-precise hard rasterizer, render/soft.py
    ``rasterize_exact``: the winner search runs in the raster kernels
    (K8b for one triangle chunk, K8c for several) on CUDA tensors.
    As in the JAX package it ignores DoF (ROADMAP fault F9).
  * 'soft'   — the differentiable rasterizer, render/soft.py
    ``rasterize_soft``, through the soft raster kernels (K9a/K9b forward,
    K9c/K9d backward) on CUDA tensors; no DoF, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytpu_torch.core.types import Camera, Lights, RenderConfig, Scene
from raytpu_torch.ops.blur import dof_apply
from raytpu_torch.ops.raster import (
    GBuffer,
    check_raster_chunk,
    cull_mask,
    pixel_shade,
    resolve_depth,
    row_bounds,
    row_bounds_exact,
    vertex_stage,
)
from raytpu_torch.render.soft import rasterize_exact, rasterize_soft


class RasterOut(NamedTuple):
    image: torch.Tensor            # (H, W, 3) float32
    focal_distances: torch.Tensor  # (H, W) float32
    gbuffer: GBuffer


def rasterize_full(scene: Scene, camera: Camera, lights: Lights,
                   cfg: RenderConfig) -> RasterOut:
    """The scanline pipeline and DoF. Parity replays the reference's
    float-accumulated edge walk bit for bit; other modes take the closed
    form. Compacts the light bank on the host first."""
    lights = lights.compact()
    # F8's refusal before the edge walk, which the JAX package only traces.
    check_raster_chunk(scene.num_triangles, cfg)
    keep = cull_mask(scene, camera, cfg)
    vd = vertex_stage(scene, camera, cfg)
    bounds = (row_bounds_exact(vd, cfg) if cfg.mode == "parity"
              else row_bounds(vd, cfg))
    g = resolve_depth(bounds, keep, cfg)
    color, fd = pixel_shade(g, scene, camera, lights, cfg)
    img = color.reshape(cfg.height, cfg.width, 3)
    fd = fd.reshape(cfg.height, cfg.width)
    return RasterOut(image=dof_apply(img, fd, cfg), focal_distances=fd,
                     gbuffer=g)


def rasterize(scene: Scene, camera: Camera, lights: Lights,
              cfg: RenderConfig) -> torch.Tensor:
    """Render and return the (H, W, 3) float32 image."""
    if cfg.mode == "soft":
        return rasterize_soft(scene, camera, lights.compact(), cfg)
    if cfg.mode == "clean":
        return rasterize_exact(scene, camera, lights.compact(), cfg)
    return rasterize_full(scene, camera, lights, cfg).image
