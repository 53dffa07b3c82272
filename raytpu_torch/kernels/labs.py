"""The labs' kernels: the megakernel labs' forward kernels K1r, L5 and L6,
lab 1's closest-hit variants L1, lab 2's probes L2 and L3 and lab 3's L4.

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

Lab 1, 2 and 3's kernels (the last section; CUDA in
raytpu_torch/csrc/kernel_lab.cu, intersect.cu (L2 is K4's kernel on
planar rays) and labs.cu):

  kernel_lab_variant               L1 (bench/kernel_lab.py::run_variant):
                                   K5's closest hit in the lab's variants
                                   of chunk, dot (the tensor cores' 3xTF32
                                   for ``mxu``), divide and ray tile.
  run_onestep, run_noop            L2 and L3 (bench/megakernel_lab2.py):
                                   K4's function in one step, and a no-op
                                   with K4's launch and staging.
  run_tiny                         L4 (bench/megakernel_lab3.py): an
                                   (8, 128) tile times 2.
  *_reference                      their plain PyTorch versions.
  mxu_rule                         the error rule that holds L1's ``mxu``
                                   instances to their plain version.
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
from raytpu_torch.kernels.intersect import (
    BLOCK_ROWS,
    launch_occluded_kernel,
    sweeps_reference,
)
from raytpu_torch.kernels.tables import (
    ALBEDO,
    MAX_CHUNK,
    NORMAL,
    PARAMS,
    PRIMARY,
    SHADOW,
    TABLE_ROWS,
    constant_table,
)
from raytpu_torch.ops.intersect import F32MAX, closest, plane_tests
from raytpu_torch.ops.shade import SHADOW_T

# Launches of each CUDA kernel in this process, counted by its wrapper
# where it launches the kernel and nowhere else.
LAUNCHES_ROWS = 0     # K1r, by fused_fwd_raw
LAUNCHES_VARIANT = 0  # L5, by run_variant
LAUNCHES_BLK8 = 0     # L6, by fused_fwd_blk8
LAUNCHES_KERNEL_LAB = 0  # L1, by kernel_lab_variant
LAUNCHES_ONESTEP = 0     # L2, by run_onestep
LAUNCHES_NOOP = 0        # L3, by run_noop
LAUNCHES_TINY = 0        # L4, by run_tiny

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


# ---------------------------------------------------------------------------
# Lab 1's closest-hit variants (L1), lab 2's probes (L2, L3), lab 3's (L4).

CHUNK_MODES, DOTS, DIVS = ("pad128", "tight"), ("mxu", "vpu"), ("div", "recip")
# The ray tiles of bench/kernel_lab.py:207, the CUDA kernel's instances (a
# block of 256 threads a tile, 8, 16 or 32 rays a thread).
KERNEL_LAB_TILES = (2048, 4096, 8192)
# 3xTF32's error on a dot of three products, |dot - exact| <= MXU_EPS *
# sum_k |a_k d_k|: splitting each operand into hi + lo leaves 2^-22 of it,
# and dropping lo * lo 2^-22 of a product (3 x 2^-22 = 0.375 x 2^-19); the
# float32 sums of the 9 products over three MMAs round (or, in a tensor
# core, truncate) at most ~11 times at up to 2^-23 of the running
# magnitude (0.69 x 2^-19). 2^-18 bounds their total with room to spare.
MXU_EPS = 2.0 ** -18
# Relative rounding of t, u, v after the dots: a divide, or a reciprocal
# and a multiply, in each of the two versions compared (4 x 2^-24),
# doubled.
_T_ROUND = 2.0 ** -21


def kernel_lab_chunk(T: int, chunk_mode: str) -> int:
    """Triangles a chunk (kernel_lab.py:115-119): 128 for ``pad128``, T
    rounded up to 8 and at most 128 for ``tight``."""
    if chunk_mode == "pad128":
        return 128
    if chunk_mode == "tight":
        return min(128, max(8, -(-T // 8) * 8))
    raise ValueError(f"chunk_mode {chunk_mode!r} is not one of {CHUNK_MODES}")


def kernel_lab_table(m, k0, valid, chunk_mode: str):
    """(table (10, Tp), C) of L1: the camera-origin constants m (T, 3, 3),
    k0 (T,), invalid triangles zeroed (``m * valid``, ``k0 * valid``) and
    T padded with zero triangles to whole chunks of C
    (kernel_lab.py:120-134), in the port's row layout."""
    C = kernel_lab_chunk(m.shape[0], chunk_mode)
    return constant_table(m, k0, valid, None, None, C), C


def _lab_check(dirs_t, tile_r: int, chunk_mode: str, dot: str,
               div: str) -> None:
    if chunk_mode not in CHUNK_MODES or dot not in DOTS or div not in DIVS:
        raise ValueError(f"chunk_mode {chunk_mode!r}, dot {dot!r}, div "
                         f"{div!r}: not in {CHUNK_MODES}, {DOTS}, {DIVS}")
    _tiles(dirs_t.shape[1], tile_r)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as kernel_lab.cu's tf32_rna: to nearest, ties away
    from zero, the 13 low bits zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _dot3(d, a):
    """(R, C) dots (d0 a0 + d1 a1) + d2 a2 of rays d (R, 3) and rows a
    (3, C)."""
    return (d[:, 0:1] * a[0][None] + d[:, 1:2] * a[1][None]) \
        + d[:, 2:3] * a[2][None]


def _dots(dirs, blk, dot: str):
    """The three dots n . d, c2 . d, c3 . d of rays dirs (R, 3) and a 10-row
    block (R, C each): float32 (vpu), or 3xTF32 (mxu: lo.hi, hi.lo, hi.hi
    added in that order, as the CUDA kernel issues its MMAs)."""
    if dot == "vpu":
        return [_dot3(dirs, blk[3 * m:3 * m + 3]) for m in range(3)]
    d_hi = _tf32(dirs)
    d_lo = _tf32(dirs - d_hi)
    out = []
    for m in range(3):
        a = blk[3 * m:3 * m + 3]
        a_hi = _tf32(a)
        a_lo = _tf32(a - a_hi)
        out.append((_dot3(d_hi, a_lo) + _dot3(d_lo, a_hi))
                   + _dot3(d_hi, a_hi))
    return out


def lab_sweep_reference(dirs_t, table, C: int, dot: str, div: str):
    """Plain PyTorch version of L1 on a packed table (10, Tp): each chunk's
    plane tests in kernel_lab.py's form, the chunk's minimum with the last
    index winning ties, ``<=`` across chunks. Returns (t (R,), idx (R,)
    int32, -1 on a miss)."""
    dirs = dirs_t.T
    R = dirs.shape[0]
    best_t = dirs.new_full((R,), F32MAX)
    best_idx = torch.zeros((R,), dtype=torch.int32, device=dirs.device)
    for c in range(table.shape[1] // C):
        blk = table[:, c * C:(c + 1) * C]
        dn, du, dv = _dots(dirs, blk, dot)
        denom = -dn
        nonpar = denom != 0.0
        safe = torch.where(nonpar, denom, 1.0)
        k0 = blk[9][None]
        if div == "div":
            t, u, v = k0 / safe, du / safe, dv / safe
        else:
            r = torch.reciprocal(safe)
            t, u, v = k0 * r, du * r, dv * r
        ok = (u + v <= 1.0) & (u >= 0.0) & (v >= 0.0) & (t >= 0.0) & nonpar
        t, idx = closest(t, ok)
        upd = t <= best_t  # a later chunk wins ties
        best_t = torch.where(upd, t, best_t)
        best_idx = torch.where(upd, idx + c * C, best_idx)
    return best_t, torch.where(best_t < F32MAX, best_idx, -1)


def kernel_lab_variant_reference(dirs_t, m, k0, valid, *, tile_r: int,
                                 chunk_mode: str, dot: str, div: str):
    """Plain PyTorch version of L1. Arguments as for kernel_lab_variant."""
    _lab_check(dirs_t, tile_r, chunk_mode, dot, div)
    table, C = kernel_lab_table(m, k0, valid, chunk_mode)
    return lab_sweep_reference(dirs_t, table, C, dot, div)


def launch_kernel_lab(dirs_t, table, C: int, tile_r: int, dot: str,
                      div: str, t, idx) -> None:
    """Launch L1 on outputs the caller allocated: t (R,), idx (R,). Checks
    nothing and counts nothing; the wrapper does both."""
    with torch.cuda.device(dirs_t.device):
        err = _build.load().raytpu_kernel_lab(
            dirs_t.data_ptr(), table.data_ptr(), table.shape[1], C,
            dirs_t.shape[1], tile_r, int(dot == "mxu"), int(div == "recip"),
            t.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "kernel_lab")


def kernel_lab_variant(dirs_t, m, k0, valid, *, tile_r: int,
                       chunk_mode: str, dot: str, div: str):
    """L1's wrapper (kernel_lab.py::run_variant): dirs_t (3, R), the
    camera-origin constants m (T, 3, 3), k0 (T,), valid (T,); tile_r rays
    a tile (the CUDA kernel takes KERNEL_LAB_TILES), chunk_mode ``pad128``
    or ``tight``, dot ``mxu`` (the tensor cores) or ``vpu``, div ``div`` or
    ``recip``. Returns t (R,) float32 (F32MAX on a miss) and idx (R,) int32
    (-1 on a miss). Raises ValueError for R not a whole number of tiles
    (F23)."""
    global LAUNCHES_KERNEL_LAB
    if not _route(dirs_t):
        return kernel_lab_variant_reference(
            dirs_t, m, k0, valid, tile_r=tile_r, chunk_mode=chunk_mode,
            dot=dot, div=div)
    _lab_check(dirs_t, tile_r, chunk_mode, dot, div)
    if tile_r not in KERNEL_LAB_TILES:
        raise ValueError(f"tile_r {tile_r}: the CUDA kernel takes "
                         f"{KERNEL_LAB_TILES}")
    table, C = kernel_lab_table(m, k0, valid, chunk_mode)
    dirs_t = dirs_t.contiguous()
    for name, x in (("dirs_t", dirs_t), ("table", table)):
        if x.dtype != torch.float32 or x.device != dirs_t.device:
            raise TypeError(f"{name}: expected float32 on {dirs_t.device}")
    if dirs_t.dim() != 2 or dirs_t.shape[0] != 3:
        raise ValueError(f"dirs_t: expected (3, R), got {tuple(dirs_t.shape)}")
    R = dirs_t.shape[1]
    t = torch.empty((R,), dtype=torch.float32, device=dirs_t.device)
    idx = torch.empty((R,), dtype=torch.int32, device=dirs_t.device)
    launch_kernel_lab(dirs_t, table, C, tile_r, dot, div, t, idx)
    LAUNCHES_KERNEL_LAB += 1
    return t, idx


def mxu_rule(dirs_t, table, got, want) -> dict:
    """How L1's ``mxu`` result ``got`` (t, idx) departs from ``want``, the
    plain 3xTF32 version's (or any other float32 evaluation's), on dirs_t
    (3, R) and the packed table (10, Tp), against 3xTF32's error bound
    (MXU_EPS), computed in float64 from the inputs:

      t_over       rays with equal idx whose t differ by more than
                   |t| (2 MXU_EPS S_n / |n . d| + 2^-21), S_n = sum_k
                   |n_k d_k| of the winner;
      near_tie     rays whose idx differ and whose two winners' t lie
                   within the sum of those bounds;
      near_edge    rays whose idx differ where either winner's decision
                   (u, v, 1 - u - v or t against 0, or n . d against 0)
                   lies within its bound, so either version may take or
                   drop it;
      other        the rest of the rays whose idx differ.

    A result within the rule has t_over == other == 0."""
    (t_got, i_got), (t_want, i_want) = got, want
    dirs = dirs_t.T.double()

    def tri(i):
        """t, the bound of t, and whether a decision is within its bound,
        of triangle i (R,) for each ray (i >= 0)."""
        rows = table[:, i.clamp_min(0).long()].T.double()  # (R, 10)

        def dot(m):
            prods = dirs * rows[:, 3 * m:3 * m + 3]
            return prods.sum(1), prods.abs().sum(1)

        (dn, sn), (du, su), (dv, sv) = dot(0), dot(1), dot(2)
        denom = torch.where(dn != 0.0, -dn, 1.0)
        t, u, v = rows[:, 9] / denom, du / denom, dv / denom
        rel = 2.0 * MXU_EPS * sn / denom.abs() + _T_ROUND
        tol_t = t.abs() * rel
        tol_u = u.abs() * rel + 2.0 * MXU_EPS * su / denom.abs()
        tol_v = v.abs() * rel + 2.0 * MXU_EPS * sv / denom.abs()
        edge = ((u.abs() <= tol_u) | (v.abs() <= tol_v)
                | ((1.0 - u - v).abs() <= tol_u + tol_v + 2.0 ** -23)
                | (t.abs() <= tol_t) | (dn.abs() <= 2.0 * MXU_EPS * sn))
        return t, tol_t, edge & (i >= 0)

    same = i_got == i_want
    t_p, tol_p, edge_p = tri(i_want)
    t_k, tol_k, edge_k = tri(i_got)
    t_diff = (t_got.double() - t_want.double()).abs()
    over = same & (i_want >= 0) & (t_diff > tol_p)
    both = (i_got >= 0) & (i_want >= 0)
    tie = ~same & both & ((t_p - t_k).abs() <= tol_p + tol_k)
    edge = ~same & ~tie & (edge_p | edge_k)
    return {"t_differ": int((same & (t_got != t_want)).sum()),
            "t_over": int(over.sum()),
            "idx_differ": int((~same).sum()),
            "near_tie": int(tie.sum()), "near_edge": int(edge.sum()),
            "other": int((~same & ~tie & ~edge).sum())}


def _k4_probe_check(dirs_t, table, cam, light, tile_r: int, C: int) -> None:
    """F23 and the one chunk that JAX's block spec reads (index map (0, 0):
    a larger table would be read only in part)."""
    _tiles(dirs_t.shape[1], tile_r)
    if table.shape != (2 * BLOCK_ROWS, C) or not 1 <= C <= MAX_CHUNK:
        raise ValueError(f"table {tuple(table.shape)}: L2 and L3 take one "
                         f"chunk, (20, C) with C = {C} <= {MAX_CHUNK}; JAX's "
                         "block spec reads chunk 0 only")
    for name, x, shape in (("dirs_t", dirs_t, (3, dirs_t.shape[1])),
                           ("table", table, table.shape), ("cam", cam, (3,)),
                           ("light", light, (3,))):
        if x.dtype != torch.float32 or x.device != dirs_t.device:
            raise TypeError(f"{name}: expected float32 on {dirs_t.device}")
        if tuple(x.shape) != tuple(shape) or not x.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {tuple(shape)}")


def run_onestep_reference(dirs_t, table, cam, light, tile_r: int, C: int):
    """Plain PyTorch version of L2: K4's plain version on dirs_t's rays
    (intersect.py::sweeps_reference, the raw bit on a miss). Returns t,
    idx, occ, each (1, R)."""
    _k4_probe_check(dirs_t, table, cam, light, tile_r, C)
    t, idx, occ = sweeps_reference(dirs_t.T, table, cam, light[None],
                                   mask_misses=False)
    return t[None], idx[None], occ


def run_noop_reference(dirs_t, table, cam, light, tile_r: int, C: int):
    """Plain PyTorch version of L3: t = dirs_t[0], idx = occ = 0, each
    (1, R)."""
    _k4_probe_check(dirs_t, table, cam, light, tile_r, C)
    zeros = torch.zeros((1, dirs_t.shape[1]), dtype=torch.int32,
                        device=dirs_t.device)
    return dirs_t[0:1].clone(), zeros, zeros.clone()


def launch_k4_probe(dirs_t, table, cam, light, noop: bool, t, idx,
                    occ) -> None:
    """Launch L2 (noop False: K4's kernel on planar rays) or L3 on outputs
    the caller allocated, each (1, R). Checks nothing and counts nothing;
    the wrappers do both."""
    with torch.cuda.device(dirs_t.device):
        if not noop:
            launch_occluded_kernel(dirs_t, table, cam, light, t, idx, occ,
                                   planar=True)
            return
        err = _build.load().raytpu_lab_noop(
            dirs_t.data_ptr(), table.data_ptr(), cam.data_ptr(),
            light.data_ptr(), table.shape[1], dirs_t.shape[1], t.data_ptr(),
            idx.data_ptr(), occ.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "noop")


def _k4_probe(dirs_t, table, cam, light, tile_r, C, noop: bool):
    dirs_t = dirs_t.contiguous()
    _k4_probe_check(dirs_t, table, cam, light, tile_r, C)
    R, dev = dirs_t.shape[1], dirs_t.device
    out = (torch.empty((1, R), dtype=torch.float32, device=dev),
           torch.empty((1, R), dtype=torch.int32, device=dev),
           torch.empty((1, R), dtype=torch.int32, device=dev))
    launch_k4_probe(dirs_t, table, cam, light, noop, *out)
    return out


def run_onestep(dirs_t, table, cam, light, tile_r: int, C: int):
    """L2's wrapper (megakernel_lab2.py::run_onestep): dirs_t (3, R), the
    port's (20, C) table of one chunk (tables.py::constant_table with the
    light's constants; where JAX takes blk_p, blk_s), cam and light (3,)
    (JAX: the (8, 128) org block). Returns t (1, R) float32, idx and occ
    (1, R) int32: K4's function, the raw bit on a miss. Raises ValueError
    for a table of more than one chunk and for R not a whole number of
    tiles (F23)."""
    global LAUNCHES_ONESTEP
    if not _route(dirs_t):
        return run_onestep_reference(dirs_t, table, cam, light, tile_r, C)
    out = _k4_probe(dirs_t, table, cam, light, tile_r, C, noop=False)
    LAUNCHES_ONESTEP += 1
    return out


def run_noop(dirs_t, table, cam, light, tile_r: int, C: int):
    """L3's wrapper (megakernel_lab2.py::run_noop): arguments as for
    run_onestep (JAX's ``blocked`` is the table). Returns t = dirs_t[0:1],
    idx and occ zeros, each (1, R)."""
    global LAUNCHES_NOOP
    if not _route(dirs_t):
        return run_noop_reference(dirs_t, table, cam, light, tile_r, C)
    out = _k4_probe(dirs_t, table, cam, light, tile_r, C, noop=True)
    LAUNCHES_NOOP += 1
    return out


TINY_SHAPE = (8, 128)


def _tiny_check(x) -> None:
    if x.dtype != torch.float32 or tuple(x.shape) != TINY_SHAPE:
        raise ValueError(f"x: expected float32 {TINY_SHAPE}, got {x.dtype} "
                         f"{tuple(x.shape)}")


def run_tiny_reference(x):
    """Plain PyTorch version of L4: x * 2."""
    _tiny_check(x)
    return x * 2.0


def launch_tiny_kernel(x, out) -> None:
    """Launch L4 on contiguous float32 x and out of the same n <= 1024
    elements, at any address (out = 2 x). Checks nothing and counts
    nothing; run_tiny does both."""
    _raise_on(_build.load().raytpu_lab_tiny(
        x.data_ptr(), out.data_ptr(), x.numel(),
        torch.cuda.current_stream().cuda_stream), "tiny")


def run_tiny(x):
    """L4's wrapper (megakernel_lab3.py::run_tiny): x (8, 128) float32 ->
    2 x."""
    global LAUNCHES_TINY
    if not _route(x):
        return run_tiny_reference(x)
    _tiny_check(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        launch_tiny_kernel(x, out)
    LAUNCHES_TINY += 1
    return out
