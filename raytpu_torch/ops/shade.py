"""Direct lighting and compositing, plain PyTorch (raytpu/ops/shade.py).

Per light sample (`raytracer.cpp:294-304`):
  P = color * intensity / samples        (soft-shadow split, `:296`)
  A = 4 * pi * r^2,  D = (P / A) * max(dot(r_hat, n_hat), 0)
with the shadow ray traced FROM the light toward the surface and occlusion
declared where something sits closer than 0.99 of the way
(`raytracer.cpp:307-315`).

The JAX package loops over L lights and S samples, one (R, 3) term at a
time. Here the per-source physics runs once for all L * S sources as
(L * S, R, 3) tensors, element for element the same operations, so a
frame makes a few dozen launches instead of a few thousand. The terms
are then added in the JAX package's order: sample after sample within a
light, then light after light (parity's run-on included); a reduction
over sources would reassociate them.

Modes:
  * parity — the reference's accumulation run-on: ``result`` is never reset
    between lights, so light k is counted (L - k) times
    (`raytracer.cpp:269-322`).
  * clean  — each light counted once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from raytpu_torch.core.types import Lights, RenderConfig, Scene, dot3
from raytpu_torch.ops.intersect import TriConstants, intersect, tri_constants

# JAX multiplies by the Python float 4 * pi, which its weak typing rounds
# to float32 once; so does this constant.
FOUR_PI = float(np.float32(4.0 * math.pi))
SHADOW_T = float(np.float32(0.99))


def source_positions(lights: Lights, samples: int) -> torch.Tensor:
    """The (L * samples, 3) shadow sources, light-major and sample-minor:
    the lights' positions for hard shadows, their first ``samples``
    jittered positions for soft ones (`raytracer.cpp:286,290`).

    Raises ValueError where the bank holds fewer jittered positions than
    asked for (ROADMAP fault F7): the JAX package would index past the
    bank and silently repeat its last position."""
    if samples == 1:
        return lights.position
    if samples > lights.num_soft_samples:
        raise ValueError(
            f"{samples} soft-shadow samples asked of a light bank that "
            f"holds {lights.num_soft_samples} jittered positions a light")
    return lights.jitter[:, :samples].reshape(-1, 3)


def _trace_occlusion(src: torch.Tensor, delta: torch.Tensor, scene: Scene,
                     tri_chunk: int) -> torch.Tensor:
    """(N, R) bool: whether each shadow ray from source n along delta[n]
    meets a triangle before 0.99 of the way, through the plain intersect."""
    consts = tri_constants(scene, src)
    rows = []
    for n in range(src.shape[0]):
        sh = intersect(delta[n], TriConstants(consts.m[n], consts.k0[n],
                                              consts.valid),
                       tri_chunk=tri_chunk)
        rows.append(sh.hit & (sh.t < SHADOW_T))
    return torch.stack(rows)


def direct_light(hit_pos: torch.Tensor, hit_idx: torch.Tensor, scene: Scene,
                 lights: Lights, cfg: RenderConfig,
                 occlusion_fn=None, n_dir: torch.Tensor | None = None,
                 occlusion_rows: torch.Tensor | None = None) -> torch.Tensor:
    """Direct-light term ("result2") per ray, before albedo.

    hit_pos (R, 3) surface positions; hit_idx (R,) triangle indices,
    clamped to valid ones by the caller. Returns (R, 3); :func:`composite`
    applies the albedo per mode.

    The shadow test, by precedence:
      occlusion_rows: (L * samples, R) bool occlusion bits in source order
        (light-major, sample-minor), as the intersection kernels give them
        (kernels/intersect.py).
      occlusion_fn: (position (3,), delta (R, 3), r (R,)) -> (R,) bool,
        called once a source, with delta = hit_pos - position.
      otherwise each source's shadow rays are traced through the plain
        intersect, with the unnormalized direction delta: the ray parameter
        is the fraction of the light distance, so the reference's
        ``distance < 0.99 * r`` is t < 0.99.
    """
    samples = cfg.soft_shadow_samples
    if n_dir is None:
        n_dir = scene.normals()[hit_idx]
    src = source_positions(lights, samples)  # (N, 3), N = L * samples
    P = (lights.color * lights.intensity[:, None]) / float(samples)
    P = P.repeat_interleave(samples, dim=0)

    delta = hit_pos[None, :, :] - src[:, None, :]
    # Guard r = 0 (a light exactly on the surface point) in the sqrt input
    # and the divisions, as the JAX package does.
    r2 = dot3(delta, delta)
    lit = r2 > 0.0
    r = torch.sqrt(torch.where(lit, r2, 1.0))
    A = FOUR_PI * (r * r)
    r_dir = -delta / r[..., None]
    B = P[:, None, :] / A[..., None]
    # maximum, not clamp_min: at lam == 0 it passes half the gradient, as
    # jnp.maximum does; the value is the same.
    lam = dot3(r_dir, n_dir[None])
    lam = torch.maximum(lam, torch.zeros_like(lam))
    D = torch.where(lit[..., None], B * lam[..., None], 0.0)

    if occlusion_rows is None:
        with torch.no_grad():
            if occlusion_fn is None:
                occlusion_rows = _trace_occlusion(src, delta, scene,
                                                  cfg.tri_chunk)
            else:
                occlusion_rows = torch.stack([
                    occlusion_fn(src[n], delta[n], r[n])
                    for n in range(src.shape[0])])
    D = torch.where(occlusion_rows[..., None], 0.0, D)

    terms = D.unbind(0)
    result = result2 = None
    for k, mask_k in enumerate(lights.mask.unbind(0)):
        light_sum = terms[k * samples]
        for s in range(1, samples):
            light_sum = light_sum + terms[k * samples + s]
        if cfg.mode == "parity":
            # The run-on accumulation (`raytracer.cpp:322`).
            term = mask_k * light_sum
            result = term if result is None else result + term
            term = mask_k * result
        else:
            term = mask_k * light_sum
        result2 = term if result2 is None else result2 + term
    return result2


def irradiance_no_shadow(world: torch.Tensor, n_dir: torch.Tensor,
                         lights: Lights) -> torch.Tensor:
    """Direct irradiance per point with NO occlusion test: the rasteriser's
    lighting model (`rasteriser.cpp:567-584`). world, n_dir (..., 3);
    returns (..., 3). Light by light in the bank's order, with the same
    r = 0 guards as direct_light."""
    result = None
    for k in range(lights.capacity):
        delta = world - lights.position[k]
        r2 = dot3(delta, delta)
        lit = r2 > 0.0
        r2s = torch.where(lit, r2, 1.0)
        r = torch.sqrt(r2s)
        A = FOUR_PI * r2s
        light_color = lights.color[k] * lights.intensity[k]
        r_dir = -delta / r[..., None]
        lam = dot3(r_dir, n_dir)
        lam = torch.maximum(lam, torch.zeros_like(lam))
        term = lights.mask[k] * torch.where(
            lit[..., None], (light_color / A[..., None]) * lam[..., None], 0.0)
        # JAX starts from zeros; 0 + x is x.
        result = term if result is None else result + term
    if result is None:
        return torch.zeros_like(world)
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
