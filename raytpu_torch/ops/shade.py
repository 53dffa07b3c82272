"""Direct lighting and compositing, plain PyTorch (raytpu/ops/shade.py).

Per light sample (`raytracer.cpp:294-304`):
  A = 4 * pi * r^2,  D = (P / A) * max(dot(r_hat, n_hat), 0)
with the shadow ray traced FROM the light toward the surface and occlusion
declared where something sits closer than 0.99 of the way
(`raytracer.cpp:307-315`).

Ported for one light and one shadow sample, the configuration of the fused
forward kernel; the multi-light run-on accumulation and soft-shadow sources
arrive with the loop branch of raytrace_full.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from raytpu_torch.core.types import Lights, RenderConfig, Scene, dot3
from raytpu_torch.ops.intersect import intersect_scene

# JAX multiplies by the Python float 4 * pi, which its weak typing rounds
# to float32 once; so does this constant.
FOUR_PI = float(np.float32(4.0 * math.pi))
SHADOW_T = float(np.float32(0.99))


def direct_light(hit_pos: torch.Tensor, hit_idx: torch.Tensor, scene: Scene,
                 lights: Lights, cfg: RenderConfig,
                 n_dir: torch.Tensor | None = None) -> torch.Tensor:
    """Direct-light term per ray, before albedo, for one light and one
    shadow sample. hit_pos (R, 3); hit_idx (R,) clamped to valid indices.
    Returns (R, 3); :func:`composite` applies the albedo per mode."""
    if lights.capacity != 1 or cfg.soft_shadow_samples != 1:
        raise NotImplementedError(
            "direct_light is ported for one light and one shadow sample; "
            "more arrive with ROADMAP.md port item 3 (loop branch)"
        )
    if n_dir is None:
        n_dir = scene.normals()[hit_idx]
    position = lights.position[0]
    P = lights.color[0] * lights.intensity[0]
    delta = hit_pos - position[None, :]
    # Guard r = 0 (a light exactly on the surface point) in the sqrt input
    # and the divisions, as the JAX package does.
    r2 = dot3(delta, delta)
    lit = r2 > 0.0
    r = torch.sqrt(torch.where(lit, r2, 1.0))
    A = FOUR_PI * (r * r)
    r_dir = -delta / r[:, None]
    B = P[None, :] / A[:, None]
    lam = torch.clamp_min(dot3(r_dir, n_dir), 0.0)
    D = torch.where(lit[:, None], B * lam[:, None], 0.0)
    # Shadow ray with the unnormalized direction pos - light: the ray
    # parameter is the fraction of the light distance, so the reference's
    # ``distance < 0.99 * r`` is t < 0.99.
    sh = intersect_scene(position, delta, scene, tri_chunk=cfg.tri_chunk)
    occluded = sh.hit & (sh.t < SHADOW_T)
    D = torch.where(occluded[:, None], 0.0, D)
    result = lights.mask[0] * D
    if cfg.mode == "parity":
        # The run-on accumulation (`raytracer.cpp:322`), for one light.
        result = lights.mask[0] * result
    return result


def composite(direct: torch.Tensor, albedo: torch.Tensor, hit: torch.Tensor,
              cfg: RenderConfig) -> torch.Tensor:
    """Final per-ray color (`raytracer.cpp:583-591`); misses are black.
    Parity applies the albedo to the direct term twice
    (`raytracer.cpp:325,588`)."""
    ambient = float(np.float32(cfg.ambient))
    if cfg.mode == "parity":
        color = albedo * (direct * albedo + ambient)
    else:
        color = albedo * (direct + ambient)
    return torch.where(hit[:, None], color, 0.0)
