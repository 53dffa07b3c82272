"""Closest hit with shadow occlusion, the loop branch's kernels.

Counterpart of the K4 and K6 parts of raytpu/kernels/intersect_pallas.py.
Per ray, in one launch: the primary closest hit over C <= 128 triangles
(last index wins ties), the hit position ``cam + t * d``, and the any-hit
shadow test (t < 0.99) from each shadow source toward it:

  closest_hit_occluded         K4's wrapper: one light
                               (replaces ``_fused_kernel``).
  closest_hit_occluded_multi   K6's wrapper: S sources, lights and/or the
                               jittered soft-shadow positions, light-major
                               and sample-minor
                               (replaces ``_fused_multi_kernel``).
  *_reference                  their plain PyTorch versions.
  intersect_occluded{,_multi}  (Hits, occ bool) through ClosestHitOccluded,
                               as ``intersect_occluded{,_multi}_pallas``.
  ClosestHitOccluded           the torch.autograd.Function around both.

On CUDA tensors the wrappers launch the hand-written kernels
(raytpu_torch/csrc/intersect.cu); on CPU tensors they run the plain
versions. Both take the constants as one float32 table of 1 + S blocks of
10 rows by C columns (tables.py::_constant_rows; invalid triangles
zeroed, columns past T zero), the camera position and the S source
positions.

Occlusion on a miss ray is 0 in both, and its shadow sweeps are skipped:
that is K6's contract in the JAX package. K4's JAX wrapper returns the raw
bit of a shadow ray traced from the camera; no consumer reads it (composite
zeroes misses, and the AA record takes hits only).

The VJP is the JAX package's analytic ``_bwd``: t = k0_i / s with
s = -(d . n_i) at the winner i, so ``coef = t_bar / s`` gives
``g_dirs = coef t n_i``, ``g_m[i, 0] += coef t d`` and ``g_k0[i] += coef``.
The per-triangle sums are one one-hot (R, T)^T @ (R, 4) product in full
float32: a fixed order and no atomics, so a step is reproducible. idx,
occ, ``valid``, the shadow constants and the source positions get no
gradient.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.autograd.function import once_differentiable

from raytpu_torch.core.types import dot3
from raytpu_torch.kernels import _build
from raytpu_torch.kernels.tables import _constant_rows, tight_chunk
from raytpu_torch.ops.intersect import (
    F32MAX,
    Hits,
    TriConstants,
    closest,
    gather_rows,
    one_hot_idx,
    plane_tests,
)
from raytpu_torch.ops.shade import SHADOW_T

# Launches of each CUDA kernel in this process, counted by its wrapper
# where it launches the kernel and nowhere else.
LAUNCHES_OCCLUDED = 0        # K4, by closest_hit_occluded
LAUNCHES_OCCLUDED_MULTI = 0  # K6, by closest_hit_occluded_multi

BLOCK_ROWS = 10  # n xyz | c2 xyz | c3 xyz | k0


def occluded_table(m, k0, valid, m_s, k0_s, tri_chunk: int) -> torch.Tensor:
    """The kernels' ((1 + S) * 10, C) table from the camera-origin
    constants (m (T, 3, 3), k0 (T,), valid (T,)) and the S sources'
    constants (m_s (S, T, 3, 3), k0_s (S, T)); C = tight_chunk(T)."""
    T = m.shape[0]
    C = tight_chunk(T, tri_chunk)
    if T > C:
        raise NotImplementedError(
            f"{T} triangles need the chunked intersection kernels "
            f"(tri_chunk={tri_chunk}): ROADMAP.md port item 4 (STL scale)")
    rows = torch.cat([_constant_rows(m, k0, valid),
                      _constant_rows(m_s, k0_s, valid).flatten(0, 1)])
    return torch.nn.functional.pad(rows, (0, C - T)).contiguous()


def _block(table: torch.Tensor, b: int):
    """(m (C, 3, 3), k0 (C,)) of block b of a table."""
    rows = table[b * BLOCK_ROWS:(b + 1) * BLOCK_ROWS]
    return rows[:9].T.reshape(-1, 3, 3), rows[9]


def sweeps_reference(dirs: torch.Tensor, table: torch.Tensor,
                     cam: torch.Tensor, src: torch.Tensor):
    """Plain PyTorch version of both kernels, on any device: dirs (R, 3),
    table ((1 + S) * 10, C), cam (3,), src (S, 3). Returns (t (R,),
    idx (R,) int32, occ (S, R) int32)."""
    best_t, best_idx = closest(*plane_tests(dirs, *_block(table, 0)))
    hit = best_t < F32MAX
    tz = torch.where(hit, best_t, 0.0)
    pos = cam[None, :] + tz[:, None] * dirs
    occ = []
    for s in range(src.shape[0]):
        ts, oks = plane_tests(pos - src[s][None, :], *_block(table, 1 + s))
        occ.append((oks & (ts < SHADOW_T)).any(dim=1) & hit)
    return (best_t, torch.where(hit, best_idx, -1),
            torch.stack(occ).to(torch.int32))


def _check(dirs, table, cam, src):
    R, S = dirs.shape[0], src.shape[0]
    for name, t, shape in (("dirs", dirs, (R, 3)),
                           ("table", table, ((1 + S) * BLOCK_ROWS,
                                             table.shape[-1])),
                           ("cam", cam, (3,)), ("src", src, (S, 3))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected torch.float32, got {t.dtype}")
        if t.device != dirs.device:
            raise ValueError(f"{name} is on {t.device}, dirs on {dirs.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if S < 1:
        raise ValueError("at least one shadow source is needed")


def _outputs(dirs: torch.Tensor, S: int):
    R = dirs.shape[0]
    return (torch.empty((R,), dtype=torch.float32, device=dirs.device),
            torch.empty((R,), dtype=torch.int32, device=dirs.device),
            torch.empty((S, R), dtype=torch.int32, device=dirs.device))


def launch_occluded_kernel(dirs, table, cam, light, t, idx, occ):
    """Launch K4 on outputs the caller allocated: t (R,), idx (R,) and occ
    (R,) or (1, R). Checks nothing and counts nothing; the wrapper does
    both."""
    err = _build.load().raytpu_closest_hit_occluded(
        dirs.data_ptr(), table.data_ptr(), cam.data_ptr(), light.data_ptr(),
        table.shape[1], dirs.shape[0], t.data_ptr(), idx.data_ptr(),
        occ.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"closest_hit_occluded launch failed: CUDA error "
                           f"{err}")


def launch_occluded_multi_kernel(dirs, table, cam, src, t, idx, occ):
    """Launch K6 on outputs the caller allocated: t (R,), idx (R,) and occ
    (S, R). Checks nothing and counts nothing; the wrapper does both."""
    err = _build.load().raytpu_closest_hit_occluded_multi(
        dirs.data_ptr(), table.data_ptr(), cam.data_ptr(), src.data_ptr(),
        table.shape[1], src.shape[0], dirs.shape[0], t.data_ptr(),
        idx.data_ptr(), occ.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"closest_hit_occluded_multi launch failed: CUDA "
                           f"error {err}")


def _sweeps(dirs, table, cam, src, launch) -> tuple:
    """The sweeps of ``table`` on dirs' device: the plain version for CPU
    tensors, ``launch`` on fresh outputs for CUDA tensors."""
    if dirs.device.type == "cpu":
        return sweeps_reference(dirs, table, cam, src)
    if dirs.device.type != "cuda":
        raise ValueError(f"no route for tensors on {dirs.device}")
    _check(dirs, table, cam, src)
    out = _outputs(dirs, src.shape[0])
    with torch.cuda.device(dirs.device):
        launch(dirs, table, cam, src, *out)
    return out


def closest_hit_occluded_reference(dirs, m, k0, valid, m_l, k0_l, cam_pos,
                                   light_pos, *, tri_chunk: int = 512):
    """Plain PyTorch version of K4, on any device. dirs (R, 3); m, k0,
    valid the camera-origin constants; m_l (T, 3, 3), k0_l (T,) the
    light-origin ones; cam_pos, light_pos (3,). Returns (t (R,), idx (R,)
    int32, occ (R,) int32)."""
    table = occluded_table(m, k0, valid, m_l[None], k0_l[None], tri_chunk)
    t, idx, occ = sweeps_reference(dirs, table, cam_pos, light_pos[None])
    return t, idx, occ[0]


def closest_hit_occluded_multi_reference(dirs, m, k0, valid, m_s, k0_s,
                                         cam_pos, src_pos, *,
                                         tri_chunk: int = 512):
    """Plain PyTorch version of K6, on any device. As
    closest_hit_occluded_reference with S sources: m_s (S, T, 3, 3),
    k0_s (S, T), src_pos (S, 3); occ is (S, R) int32."""
    table = occluded_table(m, k0, valid, m_s, k0_s, tri_chunk)
    return sweeps_reference(dirs, table, cam_pos, src_pos)


def closest_hit_occluded(dirs, m, k0, valid, m_l, k0_l, cam_pos, light_pos,
                         *, tri_chunk: int = 512):
    """K4's wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Arguments and result as for
    closest_hit_occluded_reference."""
    global LAUNCHES_OCCLUDED
    table = occluded_table(m, k0, valid, m_l[None], k0_l[None], tri_chunk)
    src = light_pos.reshape(1, 3).contiguous()
    t, idx, occ = _sweeps(dirs, table, cam_pos.contiguous(), src,
                          launch_occluded_kernel)
    if dirs.is_cuda:
        LAUNCHES_OCCLUDED += 1
    return t, idx, occ[0]


def closest_hit_occluded_multi(dirs, m, k0, valid, m_s, k0_s, cam_pos,
                               src_pos, *, tri_chunk: int = 512):
    """K6's wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Arguments and result as for
    closest_hit_occluded_multi_reference."""
    global LAUNCHES_OCCLUDED_MULTI
    table = occluded_table(m, k0, valid, m_s, k0_s, tri_chunk)
    out = _sweeps(dirs, table, cam_pos.contiguous(), src_pos.contiguous(),
                  launch_occluded_multi_kernel)
    if dirs.is_cuda:
        LAUNCHES_OCCLUDED_MULTI += 1
    return out


def closest_hit_vjp(dirs, m, k0, t, idx, t_bar):
    """The JAX package's ``_bwd``: cotangents (g_dirs (R, 3), g_m (T, 3, 3),
    g_k0 (T,)) of t = k0_i / -(d . n_i) at each ray's winner i."""
    T = m.shape[0]
    hit = idx >= 0
    oh = one_hot_idx(idx, T).to(m.dtype)
    n = gather_rows(oh, m[:, 0])
    s = -dot3(dirs, n)
    s_safe = torch.where(s.abs() > 0.0, s, 1.0)
    t_hit = torch.where(hit, t, 0.0)
    coef = torch.where(hit, t_bar / s_safe, 0.0)
    ct = (coef * t_hit)[:, None]
    # Both per-triangle sums in one product; each column is its own sum.
    sums = gather_rows(oh.T, torch.cat([coef[:, None], ct * dirs], dim=1))
    g_m = m.new_zeros((T, 3, 3))
    g_m[:, 0] = sums[:, 1:]
    return ct * n, g_m, sums[:, 0]


class ClosestHitOccluded(torch.autograd.Function):
    """(t, idx, occ) of ``fn`` (closest_hit_occluded{,_multi} or their plain
    versions), differentiable in t (counterpart of the custom_vjp of
    closest_hit_occluded{,_multi}). idx and occ are not differentiable."""

    @staticmethod
    def forward(ctx, dirs, m, k0, valid, m_s, k0_s, cam_pos, src_pos,
                fn: Callable, tri_chunk: int):
        t, idx, occ = fn(dirs, m, k0, valid, m_s, k0_s, cam_pos, src_pos,
                         tri_chunk=tri_chunk)
        ctx.save_for_backward(dirs, m, k0, t, idx)
        ctx.mark_non_differentiable(idx, occ)
        return t, idx, occ

    @staticmethod
    @once_differentiable
    def backward(ctx, t_bar, _g_idx, _g_occ):
        dirs, m, k0, t, idx = ctx.saved_tensors
        g_dirs, g_m, g_k0 = closest_hit_vjp(dirs, m, k0, t, idx, t_bar)
        return g_dirs, g_m, g_k0, None, None, None, None, None, None, None


def _hits(t: torch.Tensor, idx: torch.Tensor) -> Hits:
    return Hits(t=t, idx=idx, hit=t < F32MAX)


def intersect_occluded(dirs: torch.Tensor, consts: TriConstants,
                       consts_light: TriConstants, cam_pos: torch.Tensor,
                       light_pos: torch.Tensor, *, tri_chunk: int = 512):
    """Primary intersect and hard-shadow occlusion toward one light through
    K4 (``intersect_occluded_pallas``). Returns (Hits, occ (R,) bool)."""
    t, idx, occ = ClosestHitOccluded.apply(
        dirs, consts.m, consts.k0, consts.valid, consts_light.m,
        consts_light.k0, cam_pos, light_pos, closest_hit_occluded, tri_chunk)
    return _hits(t, idx), occ.bool()


def intersect_occluded_multi(dirs: torch.Tensor, consts: TriConstants,
                             consts_src: TriConstants, cam_pos: torch.Tensor,
                             src_pos: torch.Tensor, *, tri_chunk: int = 512):
    """Primary intersect and occlusion toward S sources through K6
    (``intersect_occluded_multi_pallas``). consts_src holds batched
    constants, m (S, T, 3, 3) and k0 (S, T), from
    ``tri_constants(scene, src_pos)``. Returns (Hits, occ (S, R) bool)."""
    t, idx, occ = ClosestHitOccluded.apply(
        dirs, consts.m, consts.k0, consts.valid, consts_src.m, consts_src.k0,
        cam_pos, src_pos, closest_hit_occluded_multi, tri_chunk)
    return _hits(t, idx), occ.bool()
