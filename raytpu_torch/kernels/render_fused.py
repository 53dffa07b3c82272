"""The fused hard-visibility forward render: one kernel launch per frame.

Counterpart of raytpu/kernels/render_fused.py, forward only. Per ray, in
one pass: the primary closest hit over C <= 128 triangles (last index wins
ties), the hit position, the shadow any-hit toward the light (t < 0.99),
the winner's normal and albedo, inverse-square Lambert plus ambient
(parity applies the albedo twice), the composite, and the focal distance
``t * |d| - dof_focus``.

  render_hard_fused            the entry point: packs the triangle tables
                               and calls fused_fwd.
  fused_fwd                    the kernel wrapper. On a CUDA tensor it
                               launches the hand-written kernel
                               (raytpu_torch/csrc/render_fused.cu); on a
                               CPU tensor it runs fused_fwd_reference.
  fused_fwd_reference          the plain PyTorch version of the kernel.
  render_hard_fused_reference  render_hard_fused through the plain version.

The plain version computes the JAX kernel's ``_shade_rows`` term for term
(divides stay divides, 4*pi is rounded to float32 once) and the kernel is
compiled without fused multiply-adds, so on one card the two agree bit for
bit. The backward kernels (ROADMAP.md K2/K3) are not ported yet: the
wrapper refuses CUDA inputs that require grad rather than differentiate
the plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from raytpu_torch.core.types import dot3
from raytpu_torch.kernels import _build
from raytpu_torch.kernels.tables import (
    ALBEDO,
    MAX_CHUNK,
    NORMAL,
    PARAMS,
    PRIMARY,
    SHADOW,
    TABLE_ROWS,
    pack_params,
    pack_tables,
    tight_chunk,
)
from raytpu_torch.ops.intersect import F32MAX, closest, plane_tests
from raytpu_torch.ops.shade import FOUR_PI, SHADOW_T

# Launches of the CUDA kernel in this process, counted by fused_fwd where it
# launches and nowhere else.
LAUNCHES = 0


class FusedOut(NamedTuple):
    color: torch.Tensor  # (R, 3) float32 composited color
    fd: torch.Tensor     # (R,) float32 focal distance, 0 on misses
    idx: torch.Tensor    # (R,) int32 winner triangle, -1 on misses
    occ: torch.Tensor    # (R,) int32 1 where the light is blocked


def _constants(table: torch.Tensor, base: int):
    """(m (C, 3, 3), k0 (C,)) from table rows base..base+9."""
    C = table.shape[1]
    return table[base:base + 9].T.reshape(C, 3, 3), table[base + 9]


def fused_fwd_reference(dirs: torch.Tensor, table: torch.Tensor,
                        params: torch.Tensor, *, ambient: float,
                        parity: bool) -> FusedOut:
    """Plain PyTorch version of the kernel, on any device.

    dirs (R, 3) ray directions; table (TABLE_ROWS, C) from pack_tables;
    params (PARAMS,) from pack_params.
    """
    m, k0 = _constants(table, PRIMARY)
    best_t, best_idx = closest(*plane_tests(dirs, m, k0))
    hit = best_t < F32MAX
    tz = torch.where(hit, best_t, 0.0)

    cam, light, p_eff, dof = params[0:3], params[3:6], params[6:9], params[9]
    # Shadow sweep from the light toward pos = cam + t*d, in that order.
    delta = (cam[None, :] + tz[:, None] * dirs) - light[None, :]
    m_l, k0_l = _constants(table, SHADOW)
    ts, oks = plane_tests(delta, m_l, k0_l)
    occ = (oks & (ts < SHADOW_T)).any(dim=1)

    # Exactly one triangle is the winner, so indexing equals the JAX
    # kernel's select chain; misses (best_idx = C - 1) are masked below.
    nrm = table[NORMAL:NORMAL + 3].T[best_idx]
    alb = table[ALBEDO:ALBEDO + 3].T[best_idx]

    # _shade_rows of the JAX kernel, term for term.
    r2 = dot3(delta, delta)
    lit = r2 > 0.0
    r = torch.sqrt(torch.where(lit, r2, 1.0))
    A = FOUR_PI * (r * r)
    r_dir = -delta / r[:, None]
    lam = torch.clamp_min(dot3(r_dir, nrm), 0.0)
    D = torch.where(lit[:, None], (p_eff[None, :] / A[:, None]) * lam[:, None],
                    0.0)
    D = torch.where(occ[:, None], 0.0, D)
    amb = float(np.float32(ambient))
    if parity:
        color = alb * (D * alb + amb)
    else:
        color = alb * (D + amb)
    color = torch.where(hit[:, None], color, 0.0)
    dn = torch.sqrt(dot3(dirs, dirs))
    fd = torch.where(hit, tz * dn - dof, 0.0)
    return FusedOut(color=color, fd=fd, idx=torch.where(hit, best_idx, -1),
                    occ=occ.to(torch.int32))


def _check(dirs: torch.Tensor, table: torch.Tensor, params: torch.Tensor):
    for name, t, shape in (("dirs", dirs, (dirs.shape[0], 3)),
                           ("table", table, (TABLE_ROWS, table.shape[-1])),
                           ("params", params, (PARAMS,))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.device != dirs.device:
            raise ValueError(f"{name} is on {t.device}, dirs on {dirs.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= table.shape[1] <= MAX_CHUNK:
        raise ValueError(f"table holds {table.shape[1]} triangles; the "
                         f"kernel takes 1..{MAX_CHUNK}")


def fused_fwd(dirs: torch.Tensor, table: torch.Tensor, params: torch.Tensor,
              *, ambient: float, parity: bool) -> FusedOut:
    """The kernel wrapper: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Arguments as for fused_fwd_reference."""
    global LAUNCHES
    if dirs.device.type == "cpu":
        return fused_fwd_reference(dirs, table, params, ambient=ambient,
                                   parity=parity)
    if dirs.device.type != "cuda":
        raise ValueError(f"no route for tensors on {dirs.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dirs, table, params)):
        raise NotImplementedError(
            "the fused forward kernel has no backward yet: the backward "
            "kernels K2/K3 are ROADMAP.md's next port item"
        )
    _check(dirs, table, params)
    R, C = dirs.shape[0], table.shape[1]
    out = FusedOut(
        color=torch.empty((R, 3), dtype=torch.float32, device=dirs.device),
        fd=torch.empty((R,), dtype=torch.float32, device=dirs.device),
        idx=torch.empty((R,), dtype=torch.int32, device=dirs.device),
        occ=torch.empty((R,), dtype=torch.int32, device=dirs.device),
    )
    lib = _build.load()
    with torch.cuda.device(dirs.device):
        err = lib.raytpu_render_fused_fwd(
            dirs.data_ptr(), table.data_ptr(), params.data_ptr(), C, R,
            ctypes.c_float(ambient), int(parity),
            out.color.data_ptr(), out.fd.data_ptr(), out.idx.data_ptr(),
            out.occ.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"render_fused_fwd launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def pack_inputs(m, k0, valid, m_l, k0_l, nrm, alb, cam_pos, light_pos, p_eff,
                dof_focus, tri_chunk):
    """(table, params) for fused_fwd from render_hard_fused's arguments."""
    T = m.shape[0]
    C = tight_chunk(T, tri_chunk)
    if T > C:
        raise ValueError(f"render_fused is single-chunk only (T={T} > {C})")
    return (pack_tables(m, k0, valid, m_l, k0_l, nrm, alb, C),
            pack_params(cam_pos, light_pos, p_eff, dof_focus))


def render_hard_fused(dirs, m, k0, valid, m_l, k0_l, nrm, alb, cam_pos,
                      light_pos, p_eff, dof_focus, *, tri_chunk: int = 512,
                      ambient: float = 0.2, parity: bool = False) -> FusedOut:
    """Fully fused hard render step (raytpu's ``render_hard_fused``).

    Args:
      dirs: (R, 3) unnormalized ray directions.
      m, k0, valid: camera-origin TriConstants ((T, 3, 3), (T,), (T,)).
      m_l, k0_l: light-origin constants (shadow sweep).
      nrm: (T, 3) shading normals (scene.normals()).
      alb: (T, 3) albedo.
      cam_pos, light_pos: (3,).
      p_eff: (3,) mask * color * intensity of the single light.
      dof_focus: () focal-plane distance.
    Returns FusedOut(color (R, 3), fd (R,), idx (R,), occ (R,)).
    """
    table, params = pack_inputs(m, k0, valid, m_l, k0_l, nrm, alb, cam_pos,
                                light_pos, p_eff, dof_focus, tri_chunk)
    return fused_fwd(dirs, table, params, ambient=ambient, parity=parity)


def render_hard_fused_reference(dirs, m, k0, valid, m_l, k0_l, nrm, alb,
                                cam_pos, light_pos, p_eff, dof_focus, *,
                                tri_chunk: int = 512, ambient: float = 0.2,
                                parity: bool = False) -> FusedOut:
    """render_hard_fused through the plain version, on any device."""
    table, params = pack_inputs(m, k0, valid, m_l, k0_l, nrm, alb, cam_pos,
                                light_pos, p_eff, dof_focus, tri_chunk)
    return fused_fwd_reference(dirs, table, params, ambient=ambient,
                               parity=parity)
