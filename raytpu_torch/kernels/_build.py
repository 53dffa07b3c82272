"""Build and load the port's CUDA kernels.

The sources are raytpu_torch/csrc/*.cu, each with a plain C interface (no
PyTorch headers, so a build takes seconds), and the *.cuh headers they
include. At first use each is compiled
with nvcc for Hopper (sm_90a), all at once in parallel, and the objects are
linked into one shared library under ``build/raytpu_torch/`` beside the
package, named by a hash of the sources and flags, and loaded with ctypes.
Nothing is built at import. A missing nvcc or a failed build raises: there
is no fallback.

Rounding is pinned: ``-fmad=false`` forbids contracting a multiply and an
add into one FMA, and division and sqrt stay IEEE round-to-nearest, so the
kernels round exactly as PyTorch's op-by-op CUDA arithmetic does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raytpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# The C interface of every kernel: name -> argument types. Each returns the
# cudaError_t of its launch as an int, but those in RESTYPES.
SIGNATURES = {
    # dirs, table, params, C, R, ambient, parity, color, fd, idx, occ, stream
    "raytpu_render_fused_fwd": [_P, _P, _P, _I, _I, _F, _I, _P, _P, _P, _P,
                                _P],
    # dirs, table, params, idx, occ, g_color, g_fd, C, R, ambient, parity,
    # g_dirs, partials, blocks, stream
    "raytpu_render_fused_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I,
                                _P, _P, _I, _P],
    # partials, blocks, C, g_table, g_params, stream
    "raytpu_render_fused_scatter": [_P, _I, _I, _P, _P, _P],
    # dirs, table, cam, light, C, R, planar, t, idx, occ, stream
    "raytpu_closest_hit_occluded": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P,
                                    _P],
    # dirs, table, cam, src, C, S, R, t, idx, occ, tris, scratch_bytes,
    # staged, stream
    "raytpu_closest_hit_occluded_multi": [_P, _P, _P, _P, _I, _I, _I, _P, _P,
                                          _P, _P, _L, _I, _P],
    # dirs, table, Tp, C, mask (or null), H, W, th, run, scratch (or
    # null), scratch_bytes, t, idx, stream
    "raytpu_closest_hit": [_P, _P, _I, _I, _P, _I, _I, _I, _I, _P, _L, _P,
                           _P, _P],
    # Tp, C, H, W, th, masked, run: K5's or K7d's scratch bytes (-1:
    # refused)
    "raytpu_closest_hit_scratch": [_I, _I, _I, _I, _I, _I, _I],
    # dirs, table, Tp, H, W, th, dec, counts, stream
    "raytpu_primary_cull_probe": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    # dirs, table, Tp, C, cam, src, S, mask, H, W, th, t, idx, occ, scratch,
    # scratch_bytes, pri_run, shw_runs, phases, stream
    "raytpu_closest_hit_occluded_masked": [_P, _P, _I, _I, _P, _P, _I, _P,
                                           _I, _I, _I, _P, _P, _P, _P, _L,
                                           _I, _I, _I, _P],
    # Tp, C, S, H, W, th, pri_run: K7a's scratch bytes (-1: refused)
    "raytpu_closest_hit_occluded_masked_scratch": [_I, _I, _I, _I, _I, _I,
                                                   _I],
    # e, tri, N, reject, blocked, stream
    "raytpu_shadow_reject_probe": [_P, _P, _I, _P, _P, _P],
    # pos, table, Tp, C, src, S, mask (or null), H, W, th, occ, scratch,
    # scratch_bytes, run, stream
    "raytpu_occlusion_points": [_P, _P, _I, _I, _P, _I, _P, _I, _I, _I, _P,
                                _P, _L, _I, _P],
    # Tp, C, S, H, W, th, masked, run: K7b's or K7c's scratch bytes (-1:
    # refused)
    "raytpu_occlusion_points_scratch": [_I, _I, _I, _I, _I, _I, _I, _I],
    # consts, T, H, W, y0, idx, stream
    "raytpu_raster_winner": [_P, _I, _I, _I, _I, _P, _P],
    # consts, T, chunk, mask (or null), H, W, y0, idx, stream
    "raytpu_raster_winner_chunked": [_P, _I, _I, _P, _I, _I, _I, _P, _P],
    # consts, T, H, W, y0, counts, stream
    "raytpu_raster_cull_probe": [_P, _I, _I, _I, _I, _P, _P],
    # consts, Tp, chunk, mask (or null), H, W, y0, es, zs, scratch (or
    # null), scratch_bytes, agg, m, s, stream
    "raytpu_soft_raster_fwd": [_P, _I, _I, _P, _I, _I, _I, _F, _F, _P, _L,
                               _P, _P, _P, _P],
    # Tp, chunk, H, W, masked: the forward's scratch bytes (-1: refused)
    "raytpu_soft_raster_fwd_scratch": [_I, _I, _I, _I, _I],
    # consts, Tp, H, W, y0, es, zs, floors, counts, stream
    "raytpu_soft_row_dead_probe": [_P, _I, _I, _I, _I, _F, _F, _P, _P, _P],
    # consts, Tp, chunk, mask (or null), H, W, y0, es, zs, m, cot, scratch,
    # scratch_bytes, dc, stream
    "raytpu_soft_raster_bwd": [_P, _I, _I, _P, _I, _I, _I, _F, _F, _P, _P,
                               _P, _L, _P, _P],
    # Tp, chunk, H, W: the backward's scratch bytes (-1: refused)
    "raytpu_soft_raster_bwd_scratch": [_I, _I, _I, _I],
    # consts, Tp, chunk, cam, dirs, R, mask (or null), H, W, th, es, zs,
    # run_min, items, scratch, scratch_bytes, out, m, s, stream
    "raytpu_soft_rt_pri_fwd": [_P, _I, _I, _P, _P, _I, _P, _I, _I, _I, _F,
                               _F, _I, _I, _P, _L, _P, _P, _P, _P],
    # Tp, chunk, R, masked, H, W, th, run_min, items: the scratch bytes of
    # a K10a / K10b call (-1: refused)
    "raytpu_soft_rt_pri_fwd_scratch": [_I, _I, _I, _I, _I, _I, _I, _I, _I],
    # consts, Tp, chunk, cam, dirs, R, mask (or null), H, W, th, es, zs, m,
    # cot, run, blocks, scratch, scratch_bytes, dc, dcam, dd, stream
    "raytpu_soft_rt_pri_bwd": [_P, _I, _I, _P, _P, _I, _P, _I, _I, _I, _F,
                               _F, _P, _P, _I, _I, _P, _L, _P, _P, _P, _P],
    # the blocks of K10c / K10d the card holds at once (-1: none)
    "raytpu_soft_rt_pri_bwd_fit": [],
    # Tp, chunk, R, masked, H, W, th, run, blocks: the scratch bytes of a
    # K10c / K10d call (-1: refused)
    "raytpu_soft_rt_pri_scratch": [_I, _I, _I, _I, _I, _I, _I, _I, _I],
    # consts, Tp, chunk, srcs, S, world, R, mask (or null), H, W, th, es,
    # zs, run, scratch, scratch_bytes, trans, stream
    "raytpu_soft_rt_shw_fwd": [_P, _I, _I, _P, _I, _P, _I, _P, _I, _I, _I,
                               _F, _F, _I, _P, _L, _P, _P],
    # consts, Tp, chunk, srcs, S, world, R, mask (or null), H, W, th,
    # trans, gcot, es, zs, run, blocks, scratch, scratch_bytes, dc, dsrc,
    # dw, stream
    "raytpu_soft_rt_shw_bwd": [_P, _I, _I, _P, _I, _P, _I, _P, _I, _I, _I,
                               _P, _P, _F, _F, _I, _I, _P, _L, _P, _P, _P,
                               _P],
    # n_chunks: the blocks of K10i / K10j the card holds at once (-1: none)
    "raytpu_soft_rt_shw_bwd_fit": [_I],
    # Tp, chunk, S, R, masked, H, W, th, run, backward, blocks: the scratch
    # bytes of a K10g-K10j call (-1: refused)
    "raytpu_soft_rt_shw_scratch": [_I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                   _I],
    # consts, Tp, chunk, cam, dirs, R, es, zs, m, cot, rays, splits,
    # partials, cam_partials, dc, dcam, stream
    "raytpu_soft_rt_pri_bwd_tables": [_P, _I, _I, _P, _P, _I, _F, _F, _P, _P,
                                      _P, _I, _P, _P, _P, _P, _P],
    # consts, Tp, chunk, cam, dirs, R, es, zs, run, m, cot, rows, dd, stream
    "raytpu_soft_rt_pri_bwd_dirs": [_P, _I, _I, _P, _P, _I, _F, _F, _I, _P,
                                    _P, _P, _P, _P],
    # x, n, out, stream
    "raytpu_soft_rt_expf": [_P, _I, _P, _P],
    # x, n, out, stream
    "raytpu_soft_rt_sigmoid": [_P, _I, _P, _P],
    # consts, Tp, chunk, srcs, S, world, R, trans, gcot, es, zs, pts,
    # splits, partials, dc, stream
    "raytpu_soft_rt_shw_bwd_consts": [_P, _I, _I, _P, _I, _P, _I, _P, _P, _F,
                                      _F, _P, _I, _P, _P, _P],
    # consts, Tp, chunk, srcs, S, world, R, trans, gcot, es, zs, run, rows,
    # src_partials, dsrc, dw, stream
    "raytpu_soft_rt_shw_bwd_rays": [_P, _I, _I, _P, _I, _P, _I, _P, _P, _F,
                                    _F, _I, _P, _P, _P, _P, _P],
    # dirs, table, params, C, Rp, tile_r, layout, gather, shade, ambient,
    # parity, color, fd, idx, occ, stream
    "raytpu_mega_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P, _P,
                        _P, _P, _P],
    # dirs_t, table, Tp, C, R, tile_r, dot, div, t, idx, stream
    "raytpu_kernel_lab": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # dirs_t, table, cam, light, C, R, t, idx, occ, stream
    "raytpu_lab_noop": [_P, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    # x, out, n, stream
    "raytpu_lab_tiny": [_P, _P, _I, _P],
}

RESTYPES = {"raytpu_closest_hit_occluded_masked_scratch": _L,
            "raytpu_closest_hit_scratch": _L,
            "raytpu_occlusion_points_scratch": _L,
            "raytpu_soft_raster_bwd_scratch": _L,
            "raytpu_soft_raster_fwd_scratch": _L,
            "raytpu_soft_rt_shw_scratch": _L,
            "raytpu_soft_rt_pri_scratch": _L,
            "raytpu_soft_rt_pri_fwd_scratch": _L}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of raytpu_torch are compiled "
        "from raytpu_torch/csrc at first use (CUDA toolkit required)"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"raytpu_torch_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; returns its path. The
    compiler's report (registers, shared memory, spills) is kept beside
    it as a .log file."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.with_name(f"{tag}.{src.stem}.o") for src in _sources()]
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True))
        for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(_sources(), objs))
    ]
    # Wait for every compile before reading any result.
    log = [f"$ {' '.join(cmd)}\n{proc.communicate()[0]}"
           for cmd, proc in procs]
    try:
        for (_, proc), entry in zip(procs, log):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with code {proc.returncode}:\n{entry}")
        tmp = out.with_name(f"{tag}.tmp.so")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("".join(log))
    os.replace(tmp, out)  # atomic: no process ever loads half a file
    return out


def load() -> ctypes.CDLL:
    """The built library with every function's argument types declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = RESTYPES.get(name, ctypes.c_int)
        _lib = lib
    return _lib
