"""The fused hard-visibility render, forward and backward.

Counterpart of raytpu/kernels/render_fused.py. The forward, per ray in one
pass: the primary closest hit over C <= 128 triangles (last index wins
ties), the hit position, the shadow any-hit toward the light (t < 0.99),
the winner's normal and albedo, inverse-square Lambert plus ambient
(parity applies the albedo twice), the composite, and the focal distance
``t * |d| - dof_focus``. It saves the winner index and the occlusion bit.

The backward treats both as constants (they are piecewise constant), as
the JAX package's ``custom_vjp`` does: it recomputes ``t = k0_i / -(d .
n_i)`` and the shading from the winner's table values, differentiates
them with respect to those values, the parameters and the ray direction,
and sums the winner values' cotangents per triangle. No gradient passes
through the plane tests, the closest-hit choice or the shadow sweep.

  render_hard_fused            the entry point: packs the triangle tables
                               and renders through RenderHardFused with
                               the kernel wrappers.
  RenderHardFused              the torch.autograd.Function.
  fused_fwd, fused_bwd         the kernel wrappers. On CUDA tensors they
                               launch the hand-written kernels
                               (raytpu_torch/csrc/render_fused.cu,
                               render_fused_bwd.cu); on CPU tensors they run
                               the plain versions.
  fused_fwd_reference,         the plain PyTorch versions of the kernels.
  fused_bwd_reference
  render_hard_fused_reference  render_hard_fused through the plain
                               versions, forward and backward.

The plain versions compute the JAX kernel's ``_shade_rows`` term for term
(divides stay divides, 4*pi is rounded to float32 once) and the kernels
are compiled without fused multiply-adds, so on one card the forward
kernel and its plain version agree bit for bit; the backward kernel's
hand-written derivative agrees with autograd's to rounding.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from raytpu_torch.core.types import dot3
from raytpu_torch.kernels import _build
from raytpu_torch.kernels.intersect import sweep_grid, sweep_keep
from raytpu_torch.kernels.tables import (
    ALBEDO,
    GATHERED,
    MAX_CHUNK,
    NORMAL,
    PARAMS,
    PRIMARY,
    SHADOW,
    TABLE_ROWS,
    gathered_rows,
    pack_params,
    pack_tables,
    table_from_gathered,
    tight_chunk,
)
from raytpu_torch.ops.intersect import F32MAX, closest, plane_tests
from raytpu_torch.ops.shade import FOUR_PI, SHADOW_T

# Launches of each CUDA kernel in this process, counted by its wrapper
# where it launches the kernel and nowhere else.
LAUNCHES = 0            # the forward (K1), by fused_fwd
LAUNCHES_BWD = 0        # the per-ray backward (K2), by fused_bwd
LAUNCHES_SCATTER = 0    # the per-triangle sums (K3), by fused_bwd

# Rays a block of the backward kernel takes (kThreads in
# csrc/render_fused_bwd.cu); each block leaves one row of partial sums.
BWD_RAYS_PER_BLOCK = 256


class FusedOut(NamedTuple):
    color: torch.Tensor  # (R, 3) float32 composited color
    fd: torch.Tensor     # (R,) float32 focal distance, 0 on misses
    idx: torch.Tensor    # (R,) int32 winner triangle, -1 on misses
    occ: torch.Tensor    # (R,) int32 1 where the light is blocked


def _constants(table: torch.Tensor, base: int):
    """(m (C, 3, 3), k0 (C,)) from table rows base..base+9."""
    C = table.shape[1]
    return table[base:base + 9].T.reshape(C, 3, 3), table[base + 9]


def _shade(delta, dirs, tz, hit, occ, nrm, alb, p_eff, dof, *,
           ambient: float, parity: bool):
    """``_shade_rows`` of the JAX kernel, term for term, from the light
    vector ``delta = pos - light`` (R, 3). p_eff broadcasts against (R, 3)
    and dof against (R,). Returns (color (R, 3), fd (R,))."""
    r2 = dot3(delta, delta)
    lit = r2 > 0.0
    r = torch.sqrt(torch.where(lit, r2, 1.0))
    A = FOUR_PI * (r * r)
    r_dir = -delta / r[:, None]
    lam = dot3(r_dir, nrm)
    # maximum, not clamp_min: at lam == 0 it passes half the gradient, as
    # jnp.maximum does; the value is the same.
    lam = torch.maximum(lam, torch.zeros_like(lam))
    D = torch.where(lit[:, None], (p_eff / A[:, None]) * lam[:, None], 0.0)
    D = torch.where(occ[:, None], 0.0, D)
    amb = float(np.float32(ambient))
    if parity:
        color = alb * (D * alb + amb)
    else:
        color = alb * (D + amb)
    color = torch.where(hit[:, None], color, 0.0)
    dn = torch.sqrt(dot3(dirs, dirs))
    fd = torch.where(hit, tz * dn - dof, 0.0)
    return color, fd


def fused_fwd_reference(dirs: torch.Tensor, table: torch.Tensor,
                        params: torch.Tensor, *, ambient: float,
                        parity: bool, image_hw: tuple | None = None,
                        cull: bool = False) -> FusedOut:
    """Plain PyTorch version of the forward kernel, on any device.

    dirs (R, 3) ray directions; table (TABLE_ROWS, C) from pack_tables;
    params (PARAMS,) from pack_params. ``cull`` leaves out, for each ray,
    the tests the kernel's culled sweeps leave out (its warps over
    ``image_hw``: kernels/intersect.py::sweep_keep), as the kernel does:
    the same outputs. image_hw is the kernel's warps' grid and changes
    nothing else.
    """
    cam, light, p_eff, dof = params[0:3], params[3:6], params[6:9], params[9]
    if cull:
        pri, shw = sweep_keep(dirs, table, cam, light, image_hw)
    m, k0 = _constants(table, PRIMARY)
    ts, oks = plane_tests(dirs, m, k0)
    best_t, best_idx = closest(ts, oks & pri if cull else oks)
    hit = best_t < F32MAX
    tz = torch.where(hit, best_t, 0.0)

    # Shadow sweep from the light toward pos = cam + t*d, in that order.
    delta = (cam[None, :] + tz[:, None] * dirs) - light[None, :]
    m_l, k0_l = _constants(table, SHADOW)
    ts, oks = plane_tests(delta, m_l, k0_l)
    blocks = oks & (ts < SHADOW_T)
    occ = (blocks & shw if cull else blocks).any(dim=1)

    # Exactly one triangle is the winner, so indexing equals the JAX
    # kernel's select chain; misses (best_idx = C - 1) are masked below.
    nrm = table[NORMAL:NORMAL + 3].T[best_idx]
    alb = table[ALBEDO:ALBEDO + 3].T[best_idx]
    color, fd = _shade(delta, dirs, tz, hit, occ, nrm, alb, p_eff[None, :],
                       dof, ambient=ambient, parity=parity)
    return FusedOut(color=color, fd=fd, idx=torch.where(hit, best_idx, -1),
                    occ=occ.to(torch.int32))


def bwd_rays_reference(dirs: torch.Tensor, table: torch.Tensor,
                       params: torch.Tensor, idx: torch.Tensor,
                       occ: torch.Tensor, g_color: torch.Tensor,
                       g_fd: torch.Tensor, *, ambient: float, parity: bool):
    """Plain PyTorch version of the per-ray backward (K2's function).

    Arguments as for fused_bwd_reference. Returns per-ray cotangents:
    g_dirs (R, 3), g_gathered (R, 10) of the GATHERED winner values and
    g_params (R, PARAMS); all zero on misses.
    """
    R = dirs.shape[0]
    hit = idx >= 0
    win = idx.clamp_min(0).long()
    # The winner's values, zero on misses (as the JAX kernel's select
    # chain), and the parameters as per-ray rows.
    gathered = torch.where(hit[:, None], gathered_rows(table)[:, win].T,
                           0.0)
    gathered = gathered.detach().requires_grad_()
    d = dirs.detach().requires_grad_()
    par = params.detach().expand(R, PARAMS).contiguous().requires_grad_()
    with torch.enable_grad():
        n, k0 = gathered[:, 0:3], gathered[:, 3]
        nrm, alb = gathered[:, 4:7], gathered[:, 7:10]
        # t = k0_i / -(d . n_i) in the plane test's operations, so it
        # equals the forward's winner t.
        denom = -dot3(d, n)
        safe = torch.where(denom != 0.0, denom, 1.0)
        tz = torch.where(hit, k0 * torch.reciprocal(safe), 0.0)
        delta = (par[:, 0:3] + tz[:, None] * d) - par[:, 3:6]
        color, fd = _shade(delta, d, tz, hit, occ > 0, nrm, alb,
                           par[:, 6:9], par[:, 9], ambient=ambient,
                           parity=parity)
        g_gathered, g_dirs, g_par = torch.autograd.grad(
            (color, fd), (gathered, d, par), (g_color, g_fd))
    return g_dirs, g_gathered, g_par


def scatter_reference(idx: torch.Tensor, g_gathered: torch.Tensor,
                      g_params: torch.Tensor, C: int):
    """Plain PyTorch version of the per-triangle sums (K3's function): the
    per-ray cotangents of bwd_rays_reference summed by winner into g_table
    (TABLE_ROWS, C), and over all rays into g_params (PARAMS,). A miss's
    cotangents are zero, so adding them to triangle 0 changes nothing and
    no mask (a device-to-host sync) is needed."""
    g_rows = g_gathered.new_zeros((len(GATHERED), C))
    g_rows.index_add_(1, idx.clamp_min(0).long(), g_gathered.T)
    return table_from_gathered(g_rows), g_params.sum(dim=0)


def fused_bwd_reference(dirs: torch.Tensor, table: torch.Tensor,
                        params: torch.Tensor, idx: torch.Tensor,
                        occ: torch.Tensor, g_color: torch.Tensor,
                        g_fd: torch.Tensor, *, ambient: float, parity: bool):
    """Plain PyTorch version of the backward kernels, on any device.

    Arguments as for fused_fwd_reference, plus the forward's idx and occ
    and the cotangents g_color (R, 3) and g_fd (R,). Returns (g_dirs (R, 3),
    g_table (TABLE_ROWS, C), g_params (PARAMS,)); g_table is zero outside
    the GATHERED rows.
    """
    g_dirs, g_gathered, g_par = bwd_rays_reference(
        dirs, table, params, idx, occ, g_color, g_fd, ambient=ambient,
        parity=parity)
    return (g_dirs, *scatter_reference(idx, g_gathered, g_par,
                                       table.shape[1]))


def _check(dirs: torch.Tensor, table: torch.Tensor, params: torch.Tensor,
           **per_ray: tuple[torch.Tensor, tuple, torch.dtype]):
    R = dirs.shape[0]
    for name, t, shape, dtype in (
            ("dirs", dirs, (R, 3), torch.float32),
            ("table", table, (TABLE_ROWS, table.shape[-1]), torch.float32),
            ("params", params, (PARAMS,), torch.float32),
            *((name, *spec) for name, spec in per_ray.items())):
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
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


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def fused_fwd(dirs: torch.Tensor, table: torch.Tensor, params: torch.Tensor,
              *, ambient: float, parity: bool,
              image_hw: tuple | None = None) -> FusedOut:
    """The forward kernel's wrapper: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Arguments as for fused_fwd_reference;
    image_hw = (H, W) where the rays are a row-major pixel grid, whose
    warps the kernel takes as squarer blocks of pixels
    (kernels/intersect.py::sweep_grid; the same outputs)."""
    global LAUNCHES
    H, W, wh = sweep_grid(dirs.shape[0], image_hw)
    if dirs.device.type == "cpu":
        return fused_fwd_reference(dirs, table, params, ambient=ambient,
                                   parity=parity)
    if dirs.device.type != "cuda":
        raise ValueError(f"no route for tensors on {dirs.device}")
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
            dirs.data_ptr(), table.data_ptr(), params.data_ptr(), C, H, W,
            wh, ctypes.c_float(ambient), int(parity),
            out.color.data_ptr(), out.fd.data_ptr(), out.idx.data_ptr(),
            out.occ.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err, "render_fused_fwd")
    LAUNCHES += 1
    return out


def fused_bwd(dirs: torch.Tensor, table: torch.Tensor, params: torch.Tensor,
              idx: torch.Tensor, occ: torch.Tensor, g_color: torch.Tensor,
              g_fd: torch.Tensor, *, ambient: float, parity: bool):
    """The backward kernels' wrapper: K2 then K3 for CUDA tensors, the plain
    version for CPU tensors. Arguments and result as for
    fused_bwd_reference; every tensor contiguous."""
    global LAUNCHES_BWD, LAUNCHES_SCATTER
    if dirs.device.type == "cpu":
        return fused_bwd_reference(dirs, table, params, idx, occ, g_color,
                                   g_fd, ambient=ambient, parity=parity)
    if dirs.device.type != "cuda":
        raise ValueError(f"no route for tensors on {dirs.device}")
    R, C = dirs.shape[0], table.shape[1]
    _check(dirs, table, params, idx=(idx, (R,), torch.int32),
           occ=(occ, (R,), torch.int32),
           g_color=(g_color, (R, 3), torch.float32),
           g_fd=(g_fd, (R,), torch.float32))
    blocks = -(-R // BWD_RAYS_PER_BLOCK)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dirs.device)

    g_dirs, g_table, g_params = empty(R, 3), empty(TABLE_ROWS, C), empty(
        PARAMS)
    partials = empty(blocks, len(GATHERED) * C + PARAMS)
    with torch.cuda.device(dirs.device):
        launch_bwd_kernel(dirs, table, params, idx, occ, g_color, g_fd,
                          ambient, parity, g_dirs, partials)
        LAUNCHES_BWD += 1
        launch_scatter_kernel(partials, g_table, g_params)
        LAUNCHES_SCATTER += 1
    return g_dirs, g_table, g_params


def launch_bwd_kernel(dirs, table, params, idx, occ, g_color, g_fd, ambient,
                      parity, g_dirs, partials):
    """Launch the per-ray backward kernel (K2) on outputs the caller
    allocated: g_dirs (R, 3) and partials (blocks, 10 C + PARAMS). Checks
    nothing and counts nothing; fused_bwd does both."""
    err = _build.load().raytpu_render_fused_bwd(
        dirs.data_ptr(), table.data_ptr(), params.data_ptr(), idx.data_ptr(),
        occ.data_ptr(), g_color.data_ptr(), g_fd.data_ptr(), table.shape[1],
        dirs.shape[0], ctypes.c_float(ambient), int(parity),
        g_dirs.data_ptr(), partials.data_ptr(), partials.shape[0],
        torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "render_fused_bwd")


def launch_scatter_kernel(partials, g_table, g_params):
    """Launch the sums over blocks (K3) into g_table (TABLE_ROWS, C) and
    g_params (PARAMS,). Checks nothing and counts nothing; fused_bwd does
    both."""
    err = _build.load().raytpu_render_fused_scatter(
        partials.data_ptr(), partials.shape[0], g_table.shape[1],
        g_table.data_ptr(), g_params.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "render_fused_scatter")


def _dense(g: torch.Tensor | None, like: torch.Tensor) -> torch.Tensor:
    """A cotangent the kernels can take: zeros for an unused output, and a
    contiguous copy of an expanded (stride 0) or strided one."""
    if g is None:
        return torch.zeros_like(like)
    return g.contiguous()


class RenderHardFused(torch.autograd.Function):
    """(color, fd, idx, occ) of the fused render, differentiable in dirs,
    table and params (counterpart of render_hard_fused's custom_vjp).

    ``fwd`` and ``bwd`` are the forward and backward functions: the kernel
    wrappers, or the plain versions. idx and occ are not differentiable.
    """

    @staticmethod
    def forward(ctx, dirs, table, params, ambient, parity, fwd, bwd):
        out = fwd(dirs, table, params, ambient=ambient, parity=parity)
        ctx.save_for_backward(dirs, table, params, out.idx, out.occ)
        ctx.mark_non_differentiable(out.idx, out.occ)
        ctx.ambient, ctx.parity, ctx.bwd = ambient, parity, bwd
        return tuple(out)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_color, g_fd, _g_idx, _g_occ):
        dirs, table, params, idx, occ = ctx.saved_tensors
        g_dirs, g_table, g_params = ctx.bwd(
            dirs, table, params, idx, occ, _dense(g_color, dirs),
            _dense(g_fd, dirs[:, 0]), ambient=ctx.ambient,
            parity=ctx.parity)
        return g_dirs, g_table, g_params, None, None, None, None


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
                      ambient: float = 0.2, parity: bool = False,
                      image_hw: tuple | None = None) -> FusedOut:
    """Fully fused hard render step (raytpu's ``render_hard_fused``),
    differentiable through the backward kernels.

    Args:
      dirs: (R, 3) unnormalized ray directions.
      m, k0, valid: camera-origin TriConstants ((T, 3, 3), (T,), (T,)).
      m_l, k0_l: light-origin constants (shadow sweep).
      nrm: (T, 3) shading normals (scene.normals()).
      alb: (T, 3) albedo.
      cam_pos, light_pos: (3,).
      p_eff: (3,) mask * color * intensity of the single light.
      dof_focus: () focal-plane distance.
      image_hw: (H, W) where the rays are a row-major pixel grid (the
        kernel's warps, fused_fwd; the same outputs).
    Returns FusedOut(color (R, 3), fd (R,), idx (R,), occ (R,)). The
    gradient reaches dirs, m[:, 0], k0, nrm, alb and the four parameters;
    valid and the shadow constants get none, as in the JAX package.
    """
    table, params = pack_inputs(m, k0, valid, m_l, k0_l, nrm, alb, cam_pos,
                                light_pos, p_eff, dof_focus, tri_chunk)
    return FusedOut(*RenderHardFused.apply(
        dirs, table, params, ambient, parity,
        functools.partial(fused_fwd, image_hw=image_hw), fused_bwd))


def render_hard_fused_reference(dirs, m, k0, valid, m_l, k0_l, nrm, alb,
                                cam_pos, light_pos, p_eff, dof_focus, *,
                                tri_chunk: int = 512, ambient: float = 0.2,
                                parity: bool = False) -> FusedOut:
    """render_hard_fused through the plain versions, on any device."""
    table, params = pack_inputs(m, k0, valid, m_l, k0_l, nrm, alb, cam_pos,
                                light_pos, p_eff, dof_focus, tri_chunk)
    return FusedOut(*RenderHardFused.apply(
        dirs, table, params, ambient, parity, fused_fwd_reference,
        fused_bwd_reference))
