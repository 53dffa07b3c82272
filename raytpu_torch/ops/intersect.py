"""Batched ray-triangle intersection, plain PyTorch (raytpu/ops/intersect.py).

For rays sharing one origin, every per-(ray, triangle) triple product of
the reference's Cramer's rule (`raytracer.cpp:202-257`) is the dot of the
ray direction with a per-triangle constant, so R rays against T triangles
are three (R, T) broadcast products and elementwise tests. The op order is
the JAX package's, with no fused multiply-adds, so the winner index agrees
bit for bit with the CUDA kernels (raytpu_torch/csrc/render_fused.cu,
intersect.cu). Scenes of more than ``tri_chunk`` triangles stream through
``intersect`` a chunk at a time with a running closest hit, O(R * chunk)
memory at any T.

Per-triangle sums of per-ray values (the backward of a gather by triangle
index) run in a fixed order on every device, with no atomics
(:func:`sum_rows_by_index`), so a train step is reproducible bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytpu_torch.core.types import Scene, cross, dot3, matmul_f32

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


def _chunk_hits(dirs, m, k0, valid):
    """Closest hit of each ray within one chunk: (t, local index); t =
    F32MAX where the chunk has no valid hit."""
    t, ok = plane_tests(dirs, m, k0)
    return closest(t, ok & (valid[None, :] > 0.0))


def intersect(dirs: torch.Tensor, consts: TriConstants,
              tri_chunk: int = 512) -> Hits:
    """Closest intersection of R rays against all T triangles.

    T <= tri_chunk takes one chunk. Larger scenes stream chunks of
    tri_chunk triangles with a running (t, idx) minimum, a later chunk
    winning ties as a later triangle does (the reference's ``>=`` update);
    T must then be a multiple of tri_chunk (Scene.pad_to), as in the JAX
    package.
    """
    T = consts.m.shape[0]
    if T <= tri_chunk:
        best_t, best_idx = _chunk_hits(dirs, consts.m, consts.k0,
                                       consts.valid)
    else:
        if T % tri_chunk != 0:
            raise ValueError(
                f"triangle count {T} must be padded to a multiple of "
                f"tri_chunk={tri_chunk} (use Scene.pad_to)")
        best_t = best_idx = None
        for c0 in range(0, T, tri_chunk):
            cs = slice(c0, c0 + tri_chunk)
            t, idx = _chunk_hits(dirs, consts.m[cs], consts.k0[cs],
                                 consts.valid[cs])
            idx = idx + c0
            if best_t is None:
                best_t, best_idx = t, idx
                continue
            upd = t <= best_t
            best_t = torch.where(upd, t, best_t)
            best_idx = torch.where(upd, idx, best_idx)
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
    return matmul_f32(oh, table)


def sum_rows_by_index(idx: torch.Tensor, vals: torch.Tensor,
                      T: int) -> torch.Tensor:
    """(T, K) sums of the rows of vals (N, K) by idx (N,) in [0, T), in one
    fixed order on every device and with no atomics (``index_add_`` on CUDA
    adds in a varying order): a stable sort by index, a segmented inclusive
    scan in log2(N) doubling steps, and each run read at its end."""
    keys, order = torch.sort(idx, stable=True)
    v = vals[order]
    N = keys.shape[0]
    d = 1
    while d < N:
        # Each row adds the partial sum d rows back while it is its own
        # triangle's: after the step a row holds the sum of up to 2d rows.
        same = (keys[d:] == keys[:-d])[:, None]
        v = torch.cat([v[:d], torch.where(same, v[d:] + v[:-d], v[d:])])
        d *= 2
    tris = torch.arange(T, dtype=keys.dtype, device=keys.device)
    end = torch.searchsorted(keys, tris, right=True) - 1
    found = (end >= 0) & (keys[end.clamp_min(0)] == tris)
    return torch.where(found[:, None], v[end.clamp_min(0)], 0.0)


class _GatherByIndex(torch.autograd.Function):
    """table[idx] whose backward sums by index in a fixed order."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return sum_rows_by_index(idx, g, ctx.rows), None


def gather_rows_by_index(table: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """table (T, K) rows at idx (R,) in [0, T): the indexing of the JAX
    package's large-scene gathers, its backward reproducible bit for bit
    (:func:`sum_rows_by_index`)."""
    return _GatherByIndex.apply(table, idx)


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
