"""The megakernel labs' forward kernels: K1r, L5 and L6.

Counterparts of raytpu/kernels/render_fused.py::_fused_fwd_raw (K1r, the
row-layout forward ``_fwd_kernel``), bench/megakernel_lab4.py::run_variant
(L5, ``variant_kernel``: K1r with the gather and/or the shading switched
off) and bench/megakernel_lab6.py::fused_fwd_blk8 (L6, the (8, tile/8)
blocked forward ``_fwd_kernel_blk8``). All three compute K1's function
(kernels/render_fused.py) in another layout; the CUDA kernels are one
template in raytpu_torch/csrc/labs.cu.

  fused_fwd_raw, fused_fwd_blk8,   the wrappers, with the JAX functions'
  run_variant                      signatures: the CUDA kernels for CUDA
                                   tensors, the plain versions for CPU
                                   tensors (no flag, no fallback).
  fused_fwd_raw_reference,         the plain PyTorch versions.
  fused_fwd_blk8_reference,
  run_variant_reference
  blk8, unblk8                     the lab's (k, Rp) <-> (8k, Rp / 8)
                                   re-blocking (``_blk8`` / ``_unblk8``).

Where the JAX functions take the (8, 128) parameter block of
``_params_block``, these take the port's (PARAMS,) vector
(kernels/tables.py::pack_params). Rp must be a whole number of tiles: the
JAX kernels' grid is ``Rp // tile_r`` and leaves a ragged tail unwritten
(ROADMAP fault F23); these raise ValueError instead.

The plain versions compute in the JAX kernels' operation order (K1r's is
K1's plain version, render_fused.fused_fwd_reference, whose function it
is), and the kernels are compiled without fused multiply-adds, so on one
card kernel and plain version agree bit for bit. The JAX row kernel
gathers the winner's normal and albedo as a sum of ``where(win, attr, 0)``
over the triangles; an index read gives the same value except for the sign
of a zero, which compares equal.
"""

from __future__ import annotations

import ctypes

import torch

from raytpu_torch.kernels import _build
from raytpu_torch.kernels.render_fused import (
    FusedOut,
    _constants,
    _raise_on,
    _shade,
    fused_fwd_reference,
    pack_inputs,
)
from raytpu_torch.kernels.tables import (
    ALBEDO,
    MAX_CHUNK,
    NORMAL,
    PARAMS,
    PRIMARY,
    SHADOW,
    TABLE_ROWS,
)
from raytpu_torch.ops.intersect import F32MAX, closest, plane_tests
from raytpu_torch.ops.shade import SHADOW_T

# Launches of each CUDA kernel in this process, counted by its wrapper
# where it launches the kernel and nowhere else.
LAUNCHES_ROWS = 0     # K1r, by fused_fwd_raw
LAUNCHES_VARIANT = 0  # L5, by run_variant
LAUNCHES_BLK8 = 0     # L6, by fused_fwd_blk8

# lab 4's attributes without the gather (megakernel_lab4.py:105-107) and
# its shading's constants (:110-111).
NO_GATHER_NORMAL = (0.1, 0.2, 0.3)
NO_GATHER_ALBEDO = (0.4, 0.5, 0.6)
VARIANT_AMBIENT, VARIANT_PARITY = 0.2, False

_ROW, _BLK8 = 0, 1


def blk8(a_t: torch.Tensor, tile_r: int) -> torch.Tensor:
    """(k, Rp) row-major -> (8k, Rp / 8): per tile, each row becomes 8 rows
    of tile_r / 8 columns (megakernel_lab6.py::_blk8)."""
    k, Rp = a_t.shape
    n_tiles, p8 = Rp // tile_r, tile_r // 8
    a = a_t.reshape(k, n_tiles, 8, p8)
    return a.permute(0, 2, 1, 3).reshape(k * 8, n_tiles * p8)


def unblk8(a8: torch.Tensor, tile_r: int) -> torch.Tensor:
    """Inverse of blk8 (megakernel_lab6.py::_unblk8)."""
    k8, cols = a8.shape
    k, p8 = k8 // 8, tile_r // 8
    n_tiles = cols // p8
    a = a8.reshape(k, 8, n_tiles, p8)
    return a.permute(0, 2, 1, 3).reshape(k, n_tiles * tile_r)


def _tiles(Rp: int, tile_r: int, blocked: bool = False) -> None:
    """F23: refuse a ray count that is not a whole number of tiles."""
    if tile_r < 1 or Rp % tile_r != 0:
        raise ValueError(f"{Rp} rays are not a whole number of tiles of "
                         f"{tile_r}: the JAX kernel's grid Rp // tile_r "
                         f"would leave the last {Rp % max(tile_r, 1)} "
                         f"unwritten (ROADMAP fault F23)")
    if blocked and tile_r % 8 != 0:
        raise ValueError(f"tile_r {tile_r} is not a multiple of 8")


def _table(m, k0, valid, m_l, k0_l, nrm, alb, par, tri_chunk):
    """The (TABLE_ROWS, C) table for the JAX functions' arguments, with
    _fused_fwd_raw's ValueError for T > C."""
    table, _ = pack_inputs(m, k0, valid, m_l, k0_l, nrm, alb, par[0:3],
                           par[3:6], par[6:9], par[9], tri_chunk)
    return table


def _check(dirs_t, table, params) -> None:
    """What the kernel takes: float32 dirs_t (3, Rp), a contiguous
    (TABLE_ROWS, C) table with 1 <= C <= MAX_CHUNK and (PARAMS,) params,
    all on one device."""
    for name, t, shape in (
            ("dirs_t", dirs_t, (3, dirs_t.shape[-1])),
            ("table", table, (TABLE_ROWS, table.shape[-1])),
            ("params", params, (PARAMS,))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if t.device != dirs_t.device:
            raise ValueError(f"{name} is on {t.device}, dirs_t on "
                             f"{dirs_t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
        if name != "dirs_t" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= table.shape[1] <= MAX_CHUNK:
        raise ValueError(f"table holds {table.shape[1]} triangles; the "
                         f"kernel takes 1..{MAX_CHUNK}")


def _rows(out: FusedOut):
    """(R,)-shaped outputs as the row layout's (3, R) and (1, R) rows."""
    return (out.color.T.contiguous(), out.fd[None], out.idx[None],
            out.occ[None])


def variant_rays_reference(dirs: torch.Tensor, table: torch.Tensor,
                           params: torch.Tensor, *, gather: bool,
                           shade: bool) -> FusedOut:
    """Plain PyTorch version of L5 per ray: dirs (R, 3), table
    (TABLE_ROWS, C), params (PARAMS,). With the gather and the shading on
    it is K1's plain version at lab 4's clean shading (ambient 0.2)."""
    if gather and shade:
        return fused_fwd_reference(dirs, table, params,
                                   ambient=VARIANT_AMBIENT,
                                   parity=VARIANT_PARITY)
    best_t, best_idx = closest(*plane_tests(dirs,
                                            *_constants(table, PRIMARY)))
    hit = best_t < F32MAX
    tz = torch.where(hit, best_t, 0.0)
    cam, light, p_eff, dof = params[0:3], params[3:6], params[6:9], params[9]
    delta = (cam[None, :] + tz[:, None] * dirs) - light[None, :]
    ts, oks = plane_tests(delta, *_constants(table, SHADOW))
    occ = (oks & (ts < SHADOW_T)).any(dim=1)
    if gather:
        nrm = torch.where(hit[:, None], table[NORMAL:NORMAL + 3].T[best_idx],
                          0.0)
        alb = torch.where(hit[:, None], table[ALBEDO:ALBEDO + 3].T[best_idx],
                          0.0)
    else:
        # tz times each float32 constant, as the kernels compute it (and
        # with no host-to-device copy).
        nrm = torch.stack([tz * k for k in NO_GATHER_NORMAL], dim=1)
        alb = torch.stack([tz * k for k in NO_GATHER_ALBEDO], dim=1)
    if shade:
        color, fd = _shade(delta, dirs, tz, hit, occ, nrm, alb,
                           p_eff[None, :], dof, ambient=VARIANT_AMBIENT,
                           parity=VARIANT_PARITY)
    else:
        color, fd = nrm + alb, tz
    return FusedOut(color=color, fd=fd, idx=torch.where(hit, best_idx, -1),
                    occ=occ.to(torch.int32))


def _launch(dirs, table, params, Rp, tile_r, layout, gather, shade, ambient,
            parity, outs):
    """Launch the labs' kernel on outputs the caller allocated (row layout:
    color, fd, idx, occ; blk8: the (32, Rp / 8) block). Checks nothing and
    counts nothing; the wrappers do both."""
    ptrs = [o.data_ptr() for o in outs] + [None] * (4 - len(outs))
    with torch.cuda.device(dirs.device):
        err = _build.load().raytpu_mega_fwd(
            dirs.data_ptr(), table.data_ptr(), params.data_ptr(),
            table.shape[1], Rp, tile_r, layout, int(gather), int(shade),
            ctypes.c_float(ambient), int(parity), *ptrs,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "mega_fwd")


def _route(dirs_t: torch.Tensor) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (the plain version)."""
    if dirs_t.device.type == "cpu":
        return False
    if dirs_t.device.type != "cuda":
        raise ValueError(f"no route for tensors on {dirs_t.device}")
    return True


def _rows_call(dirs_t, table, params, tile_r, gather, shade, ambient, parity):
    """The row-layout kernel on CUDA tensors (after _check): color (3, Rp),
    fd, idx and occ (1, Rp)."""
    Rp, dev = dirs_t.shape[1], dirs_t.device
    outs = (torch.empty((3, Rp), dtype=torch.float32, device=dev),
            torch.empty((1, Rp), dtype=torch.float32, device=dev),
            torch.empty((1, Rp), dtype=torch.int32, device=dev),
            torch.empty((1, Rp), dtype=torch.int32, device=dev))
    _launch(dirs_t.contiguous(), table, params, Rp, tile_r, _ROW, gather,
            shade, ambient, parity, outs)
    return outs


def fused_fwd_raw_reference(dirs_t, m, k0, valid, m_l, k0_l, nrm, alb, par,
                            *, tile_r: int, tri_chunk: int, ambient: float,
                            parity: bool):
    """Plain PyTorch version of K1r. Arguments as for fused_fwd_raw."""
    _tiles(dirs_t.shape[1], tile_r)
    table = _table(m, k0, valid, m_l, k0_l, nrm, alb, par, tri_chunk)
    return _rows(fused_fwd_reference(dirs_t.T.contiguous(), table, par,
                                     ambient=ambient, parity=parity))


def fused_fwd_raw(dirs_t, m, k0, valid, m_l, k0_l, nrm, alb, par, *,
                  tile_r: int, tri_chunk: int, ambient: float, parity: bool):
    """K1r's wrapper (``_fused_fwd_raw``): dirs_t (3, Rp), the primary
    constants (m, k0, valid), the shadow constants (m_l, k0_l), normals and
    albedo (T, 3), par (PARAMS,). Returns color (3, Rp), fd (1, Rp), idx
    (1, Rp) int32 (-1 on misses) and occ (1, Rp) int32. Raises ValueError
    for T > C and for Rp not a multiple of tile_r (F23)."""
    global LAUNCHES_ROWS
    if not _route(dirs_t):
        return fused_fwd_raw_reference(
            dirs_t, m, k0, valid, m_l, k0_l, nrm, alb, par, tile_r=tile_r,
            tri_chunk=tri_chunk, ambient=ambient, parity=parity)
    _tiles(dirs_t.shape[1], tile_r)
    table = _table(m, k0, valid, m_l, k0_l, nrm, alb, par, tri_chunk)
    _check(dirs_t, table, par)
    outs = _rows_call(dirs_t, table, par, tile_r, True, True, ambient, parity)
    LAUNCHES_ROWS += 1
    return outs


def fused_fwd_blk8_reference(dirs_t, m, k0, valid, m_l, k0_l, nrm, alb, par,
                             *, tile_r: int, tri_chunk: int, ambient: float,
                             parity: bool):
    """Plain PyTorch version of L6. Arguments as for fused_fwd_blk8."""
    _tiles(dirs_t.shape[1], tile_r, blocked=True)
    table = _table(m, k0, valid, m_l, k0_l, nrm, alb, par, tri_chunk)
    out = fused_fwd_reference(dirs_t.T.contiguous(), table, par,
                              ambient=ambient, parity=parity)
    return blk8(torch.cat([out.color.T, out.fd[None]]), tile_r)


def fused_fwd_blk8(dirs_t, m, k0, valid, m_l, k0_l, nrm, alb, par, *,
                   tile_r: int, tri_chunk: int, ambient: float,
                   parity: bool):
    """L6's wrapper (``fused_fwd_blk8``): arguments as for fused_fwd_raw,
    dirs_t (3, Rp) blocked here as the lab does (blk8). Returns the
    (32, Rp / 8) block [c0 x8 | c1 x8 | c2 x8 | fd x8]; unblk8 of its rows
    0:24 and 24:32 gives K1r's color and fd."""
    global LAUNCHES_BLK8
    if not _route(dirs_t):
        return fused_fwd_blk8_reference(
            dirs_t, m, k0, valid, m_l, k0_l, nrm, alb, par, tile_r=tile_r,
            tri_chunk=tri_chunk, ambient=ambient, parity=parity)
    Rp = dirs_t.shape[1]
    _tiles(Rp, tile_r, blocked=True)
    table = _table(m, k0, valid, m_l, k0_l, nrm, alb, par, tri_chunk)
    _check(dirs_t, table, par)
    out8 = torch.empty((32, Rp // 8), dtype=torch.float32,
                       device=dirs_t.device)
    _launch(blk8(dirs_t, tile_r).contiguous(), table, par, Rp, tile_r, _BLK8,
            True, True, ambient, parity, (out8,))
    LAUNCHES_BLK8 += 1
    return out8


def _variant_check(dirs_t, table, tile_r, C):
    _tiles(dirs_t.shape[1], tile_r)
    if table.shape[1] != C:
        raise ValueError(f"table holds {table.shape[1]} triangles, C={C}")


def run_variant_reference(dirs_t, table, par, tile_r, C, gather, shade):
    """Plain PyTorch version of L5. Arguments as for run_variant."""
    _variant_check(dirs_t, table, tile_r, C)
    return _rows(variant_rays_reference(dirs_t.T.contiguous(), table, par,
                                        gather=gather, shade=shade))


def run_variant(dirs_t, table, par, tile_r, C, gather, shade):
    """L5's wrapper (megakernel_lab4.py::run_variant): dirs_t (3, Rp), the
    port's (TABLE_ROWS, C) table (kernels/tables.py::pack_tables) where the
    JAX function takes its chunk-blocked constants blk_p, blk_s and attrs,
    par (PARAMS,), and the switches ``gather`` and ``shade``. Returns
    color (3, Rp), fd, idx, occ (1, Rp) as fused_fwd_raw does, with lab 4's
    clean shading (ambient 0.2)."""
    global LAUNCHES_VARIANT
    if not _route(dirs_t):
        return run_variant_reference(dirs_t, table, par, tile_r, C, gather,
                                     shade)
    _variant_check(dirs_t, table, tile_r, C)
    _check(dirs_t, table, par)
    outs = _rows_call(dirs_t, table, par, tile_r, gather, shade,
                      VARIANT_AMBIENT, VARIANT_PARITY)
    LAUNCHES_VARIANT += 1
    return outs
