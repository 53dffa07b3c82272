"""Lab 1 on the H100: do a tensor-core dot, a tighter chunk, the divide form
or a larger ray tile move K5?

The Hopper counterpart of bench/kernel_lab.py (:175-227). At size^2 clean
(the raytracer's default camera) on two scenes, the Cornell box padded to
32 (``cornell32``) and 9,216 random triangles (``stl9216``,
common.random_scene with seed 1: the JAX lab's law, numpy's draw, ROADMAP
fault F24), it times the shipped kernel, K5 at tri_chunk 512
(kernels/intersect.py::closest_hit), then L1 (kernels/labs.py::
kernel_lab_variant) in its 24 variants a scene: tile 2048 / 4096 / 8192 x
chunk pad128 / tight x dot mxu (the tensor cores, 3xTF32) / vpu x div
div / recip. Each is timed over ``--iters`` calls (30, the JAX lab's
count) after a warm call, between two CUDA events, and each variant's
``idx!=`` and ``t!=`` count the rays where it differs from the shipped
row. A tile that does not divide size^2 is skipped and said so (F23: the
JAX kernel would leave the tail unwritten); any other failure fails the
run (the JAX lab logs FAIL and goes on).

    python -m raytpu_torch.labs.kernel_lab [--size 512] [--device cuda]
        [--iters 30] [--triangles 9216]

Each row is logged on standard error as the JAX lab logs it; the last
line of standard output is one JSON object: the rows, the mismatch counts,
the tiles skipped, the card (nvidia-smi name and power limit) and each
kernel's launches in this run. ``--device cpu`` runs the plain versions
on the host clock: its times are not device numbers.
"""

from __future__ import annotations

import argparse
import json

from raytpu_torch.core.cornell import cornell_box
from raytpu_torch.core.types import Camera, RenderConfig, pixel_grid
from raytpu_torch.kernels import intersect, labs
from raytpu_torch.labs.common import card_line, device_from, log, random_scene
from raytpu_torch.labs.timing import time_batches
from raytpu_torch.ops.intersect import tri_constants
from raytpu_torch.render.raytrace import camera_ray_dirs


def _counts() -> dict:
    return {"closest_hit": intersect.LAUNCHES_CLOSEST,
            "kernel_lab_variant": labs.LAUNCHES_KERNEL_LAB}


def bench(fn, device, iters: int):
    """ms a call of fn over ``iters`` calls after a warm call, and the warm
    call's output (kernel_lab.py:165-172, with CUDA events on the card)."""
    out = fn()
    return time_batches(fn, lambda k: (), device, batches=1,
                        reps=iters)[0], out


def scenes(size: int, triangles: int, device):
    """The lab's rays (dirs (R, 3), dirs_t (3, R)) and its two scenes'
    camera-origin constants (m, k0, valid) by name."""
    camera = Camera.raytracer_default(device=device)
    cfg = RenderConfig(width=size, height=size, mode="clean")
    dirs = camera_ray_dirs(*pixel_grid(size, size, device), camera, cfg)
    out = {}
    for name, scene in (("cornell32", cornell_box(pad_to=32, device=device)),
                        (f"stl{triangles}",
                         random_scene(triangles, 1, device))):
        c = tri_constants(scene, camera.pos)
        out[name] = (c.m, c.k0, c.valid)
    return dirs, dirs.T.contiguous(), out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kernel_lab")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--triangles", type=int, default=9216)
    args = ap.parse_args(argv)
    device = device_from(args.device)
    start = _counts()

    dirs, dirs_t, by_name = scenes(args.size, args.triangles, device)
    R = dirs.shape[0]
    tiles = [t for t in labs.KERNEL_LAB_TILES if R % t == 0]
    skipped = [t for t in labs.KERNEL_LAB_TILES if R % t != 0]
    for t in skipped:
        log(f"[lab1] tile={t}: skipped, {R} rays are not a whole number of "
            f"tiles (F23)")
    res = {"scenes": {}}
    for sname, (m, k0, valid) in by_name.items():
        dt0, (t0, idx0) = bench(
            lambda: intersect.closest_hit(dirs, m, k0, valid, tri_chunk=512),
            device, args.iters)
        log(f"[lab1] [{sname}] shipped: {dt0:.3f} ms")
        rows = []
        for tile_r in tiles:
            for chunk_mode in labs.CHUNK_MODES:
                for dot in labs.DOTS:
                    for div in labs.DIVS:
                        dt, (t_, idx_) = bench(
                            lambda: labs.kernel_lab_variant(
                                dirs_t, m, k0, valid, tile_r=tile_r,
                                chunk_mode=chunk_mode, dot=dot, div=div),
                            device, args.iters)
                        mism_i = int((idx_ != idx0).sum())
                        mism_t = int((t_ != t0).sum())
                        log(f"[lab1] [{sname}] tile={tile_r} "
                            f"{chunk_mode:6s} {dot} {div:5s}: {dt:7.3f} ms"
                            f"  idx!={mism_i} t!={mism_t}")
                        rows.append(dict(tile=tile_r, chunk=chunk_mode,
                                         dot=dot, div=div, ms=dt,
                                         idx_mismatch=mism_i,
                                         t_mismatch=mism_t))
        res["scenes"][sname] = dict(T=m.shape[0], shipped_ms=dt0,
                                    variants=rows)
    card = card_line(device)
    res.update(size=args.size, device=str(device), iters=args.iters,
               skipped_tiles=skipped, card=card,
               launches={k: v - start[k] for k, v in _counts().items()})
    log(f"[lab1] card: {card or 'none (CPU: host-clock times)'}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
