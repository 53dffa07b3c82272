"""Batched ray-triangle intersection, plain PyTorch (raytpu/ops/intersect.py).

For rays sharing one origin, every per-(ray, triangle) triple product of
the reference's Cramer's rule (`raytracer.cpp:202-257`) is the dot of the
ray direction with a per-triangle constant, so R rays against T triangles
are three (R, T) broadcast products and elementwise tests. The op order is
the JAX package's, with no fused multiply-adds, so the winner index agrees
bit for bit with the CUDA kernel (raytpu_torch/csrc/render_fused.cu).

Only the single-chunk case (T <= tri_chunk) is ported; the streamed
multi-chunk scan arrives with the STL-scale slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytpu_torch.core.types import Scene, cross, dot3

F32MAX = float(np.finfo(np.float32).max)


class TriConstants(NamedTuple):
    """Per-(origin, triangle) intersection constants.

    m:  (T, 3, 3) rows [n, e2 x b, b x e1], b = start - v0.
    k0: (T,) n . b, the t numerator (`raytracer.cpp:231`).
    valid: (T,) float32 mask (scene.active).
    """

    m: torch.Tensor
    k0: torch.Tensor
    valid: torch.Tensor


def tri_constants(scene: Scene, start: torch.Tensor) -> TriConstants:
    """Intersection constants for rays originating at ``start`` (3,), or
    for each of S origins ``start`` (S, 3): then m is (S, T, 3, 3) and k0
    (S, T), element for element the operations of one origin (the JAX
    package's ``vmap`` of tri_constants over the shadow sources)."""
    e1, e2 = scene.edges()
    b = start[..., None, :] - scene.v0
    n = cross(e1, e2).expand_as(b)
    m = torch.stack([n, cross(e2, b), cross(b, e1)], dim=-2)
    return TriConstants(m=m, k0=dot3(n, b), valid=scene.active)


class Hits(NamedTuple):
    """Closest hit per ray: t (R,) (F32MAX when none), idx (R,) int32 (-1
    when none), hit (R,) bool."""

    t: torch.Tensor
    idx: torch.Tensor
    hit: torch.Tensor


def plane_tests(dirs: torch.Tensor, m: torch.Tensor, k0: torch.Tensor):
    """t and the inclusive hit test of every ray against every triangle.

    dirs (R, 3); m (C, 3, 3); k0 (C,). Returns (t (R, C), ok (R, C)). One
    reciprocal and three multiplies per pair, as in the JAX package.
    """
    d = [dirs[:, j:j + 1] for j in range(3)]

    def dot_rows(row):
        return (d[0] * m[None, :, row, 0] + d[1] * m[None, :, row, 1]
                + d[2] * m[None, :, row, 2])

    denom = -dot_rows(0)
    nonpar = denom != 0.0
    recip = torch.reciprocal(torch.where(nonpar, denom, 1.0))
    t = k0[None, :] * recip
    u = dot_rows(1) * recip
    v = dot_rows(2) * recip
    ok = (u + v <= 1.0) & (u >= 0.0) & (v >= 0.0) & (t >= 0.0) & nonpar
    return t, ok


def closest(t: torch.Tensor, ok: torch.Tensor):
    """Per-ray minimum of t over the passing triangles, LAST index winning
    ties (`raytracer.cpp:243` ``>=`` update). Returns (best_t, best_idx);
    best_t = F32MAX and best_idx = C - 1 where nothing passes.

    best_t is read at the winner, so its gradient reaches the last of tied
    triangles, as the JAX package's ``take_along_axis`` sends it; the
    minimum's own gradient would reach the first."""
    tm = torch.where(ok, t, F32MAX)
    low = tm.detach().min(dim=1).values
    rows = torch.arange(tm.shape[1], device=tm.device, dtype=torch.int32)
    best_idx = torch.where(tm == low[:, None], rows, -1).max(dim=1).values
    best_t = tm.gather(1, best_idx[:, None].long())[:, 0]
    return best_t, best_idx


def intersect(dirs: torch.Tensor, consts: TriConstants,
              tri_chunk: int = 512) -> Hits:
    """Closest intersection of R rays against all T <= tri_chunk triangles."""
    T = consts.m.shape[0]
    if T > tri_chunk:
        raise NotImplementedError(
            f"{T} triangles need the streamed multi-chunk intersect "
            f"(tri_chunk={tri_chunk}): ROADMAP.md port item 4 (STL scale)"
        )
    t, ok = plane_tests(dirs, consts.m, consts.k0)
    ok = ok & (consts.valid[None, :] > 0.0)
    best_t, best_idx = closest(t, ok)
    hit = best_t < F32MAX
    return Hits(t=best_t, idx=torch.where(hit, best_idx, -1), hit=hit)


def intersect_scene(start: torch.Tensor, dirs: torch.Tensor, scene: Scene,
                    tri_chunk: int = 512) -> Hits:
    """Constants + intersect in one call."""
    return intersect(dirs, tri_constants(scene, start), tri_chunk=tri_chunk)


def one_hot_idx(idx: torch.Tensor, T: int) -> torch.Tensor:
    """(R,) indices -> (R, T) float32 one-hot rows; negative indices (misses)
    take row 0, and callers mask misses."""
    rows = torch.arange(T, dtype=idx.dtype, device=idx.device)
    return (idx.clamp_min(0)[:, None] == rows).to(torch.float32)


def gather_rows(oh: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """one-hot (R, T) @ table (T, K) -> (R, K) in full float32: each output
    is the one selected row exactly, and the backward is the product
    ``oh.T @ g``, a fixed-order per-row sum with no atomics."""
    # TF32 would round a normal to 10 mantissa bits.
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(oh, table)


def hit_positions(start: torch.Tensor, dirs: torch.Tensor,
                  hits: Hits) -> torch.Tensor:
    """World positions of the closest hits, ``start + t * d`` (R, 3)."""
    t = torch.where(hits.hit, hits.t, 0.0)
    return start[None, :] + t[:, None] * dirs


def hit_distances(dirs: torch.Tensor, hits: Hits) -> torch.Tensor:
    """Euclidean hit distances ``t * |d|``; F32MAX where no hit."""
    norm = torch.sqrt(dot3(dirs, dirs))
    t = torch.where(hits.hit, hits.t, 0.0)
    return torch.where(hits.hit, t * norm, F32MAX)
