#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (raytpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and the script exits
nonzero without printing a result:

  1. environment: the card (nvidia-smi name and power limit), torch, CUDA.
  2. build: the port's CUDA kernels, from raytpu_torch/csrc, with nvcc.
  3. kernel against its plain PyTorch version on the card, at the shapes
     the main path gives it: 512^2 clean (Cornell box padded to 32),
     500^2 parity (30 triangles) and 1024^2 clean. idx/occ mismatches must
     be 0; color and focal distance within 1e-6.
  4. the main path as a user calls it: raytpu_torch.raytrace at the CLI
     defaults (500^2 parity, Cornell box, one light of capacity 1) against
     the numpy oracle (raytpu/oracle/raytracer_oracle.py, loaded by path:
     this script imports no JAX), and the ``render`` CLI writing a BMP.
  5. a few requests: an 8-frame key script through the animate loop; the
     kernel must launch exactly once a frame.
  6. card numbers: the 512^2 clean forward frame and the kernel alone, each
     through the kernel and through the plain version, timed with CUDA
     events (median), beside the card's name and power limit.

Launch counts are zeroed just before phase 4 and read just after phase 5,
so they count the main path only. The line before the last is one JSON
object describing each kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Details (result.json, render.bmp) go to build/chip_smoke/.
"""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"
ORACLE = ROOT / "raytpu" / "oracle" / "raytracer_oracle.py"
# Image tolerances of tests/test_raytrace_parity.py::_assert_images_match.
F32_ATOL, F32_RTOL, U8_FRAC, FLIP_FRAC = 2e-4, 1e-3, 0.999, 0.999


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def load_oracle():
    spec = importlib.util.spec_from_file_location("raytracer_oracle", ORACLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"FAILED: {what}")


def cuda_ms(fn, n: int) -> float:
    """Device time of ``n`` back-to-back calls of fn, per call, in ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def median_ms_in_turns(fns: dict, n: int, reps: int) -> dict:
    """Median over ``reps`` of cuda_ms for each fn, alternating the order
    (a, b, b, a, ...) so that drift hits both alike."""
    names = list(fns)
    for name in names:  # warm up
        cuda_ms(fns[name], 3)
    times = {name: [] for name in names}
    for rep in range(reps):
        for name in (names if rep % 2 == 0 else names[::-1]):
            times[name].append(cuda_ms(fns[name], n))
    return {name: statistics.median(ts) for name, ts in times.items()}


def main() -> int:
    record = {}

    say("== phase 1: environment")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say(f"card: {card}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device "
        f"{kind}, {torch.cuda.device_count()} visible")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    from raytpu_torch import Camera, Lights, RenderConfig, cornell_box
    from raytpu_torch.cli.main import main as cli_main
    from raytpu_torch.core.cornell import cornell_box_numpy
    from raytpu_torch.core.image import quantize_u8, read_bmp
    from raytpu_torch.kernels import _build, render_fused
    from raytpu_torch.kernels.tables import tight_chunk
    from raytpu_torch.render.animate import animate, expand_script
    from raytpu_torch.render.raytrace import (
        fused_inputs, raytrace, raytrace_full)
    OUT.mkdir(parents=True, exist_ok=True)

    say("== phase 2: build")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    say(f"built {lib_path.relative_to(ROOT)} in {build_s:.2f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")
    record["build_s"] = build_s

    def frame_args(size, mode, pad_to):
        scene = cornell_box(pad_to=pad_to, device=dev)
        cfg = RenderConfig(width=size, height=size, mode=mode)
        args = fused_inputs(scene, Camera.raytracer_default(device=dev),
                            Lights.single(capacity=1, device=dev), cfg)
        kw = dict(tri_chunk=cfg.tri_chunk, ambient=cfg.ambient,
                  parity=mode == "parity")
        return args, kw

    say("== phase 3: kernel against its plain version on the card")
    max_err = 0.0
    for size, mode, pad_to in ((512, "clean", 32), (500, "parity", None),
                               (1024, "clean", 32)):
        args, kw = frame_args(size, mode, pad_to)
        got = render_fused.render_hard_fused(*args, **kw)
        want = render_fused.render_hard_fused_reference(*args, **kw)
        torch.cuda.synchronize()
        idx_mis = int((got.idx != want.idx).sum())
        occ_mis = int((got.occ != want.occ).sum())
        dcolor = float((got.color - want.color).abs().max())
        dfd = float((got.fd - want.fd).abs().max())
        hits = float((got.idx >= 0).float().mean())
        say(f"{size}^2 {mode} T={args[1].shape[0]}: idx mismatches "
            f"{idx_mis}, occ mismatches {occ_mis}, max|dcolor| {dcolor:.3g}, "
            f"max|dfd| {dfd:.3g}, hit rays {hits:.4f}")
        require(idx_mis == 0 and occ_mis == 0, "idx/occ bit-identical")
        require(dcolor <= 1e-6 and dfd <= 1e-6, "color/fd within 1e-6")
        require(bool(torch.isfinite(got.color).all()), "finite color")
        max_err = max(max_err, dcolor, dfd)
        record[f"compare_{size}_{mode}"] = dict(
            idx_mismatch=idx_mis, occ_mismatch=occ_mis, dcolor=dcolor,
            dfd=dfd)

    say("== phase 4: main path (raytrace at the CLI defaults, render CLI)")
    render_fused.LAUNCHES = 0
    cfg = RenderConfig()  # 500x500 parity, the CLI's defaults
    out = raytrace_full(cornell_box(device=dev),
                        Camera.raytracer_default(device=dev),
                        Lights.single(capacity=1, device=dev), cfg)
    img = out.image.cpu().numpy()
    fd = out.focal_distances.cpu().numpy()
    require(img.shape == (500, 500, 3) and np.isfinite(img).all(),
            "finite (500, 500, 3) image")
    t0 = time.perf_counter()
    img_o, fd_o = load_oracle().render(cornell_box_numpy(), width=500,
                                       height=500)
    err = np.abs(img - img_o) - (F32_ATOL + F32_RTOL * np.abs(img_o))
    f32_ok = float((err.max(axis=-1) <= 0).mean())
    u8_ok = float((np.abs(quantize_u8(img).astype(int)
                          - quantize_u8(img_o).astype(int)).max(axis=-1)
                   <= 1).mean())
    fd_ok = float((np.abs(fd - fd_o) <= 1e-4).mean())
    say(f"vs numpy oracle ({time.perf_counter() - t0:.1f} s): f32-close "
        f"pixels {f32_ok:.6f}, u8 within 1 {u8_ok:.6f}, fd within 1e-4 "
        f"{fd_ok:.6f} (winner flips at triangle seams: "
        f"{int(round((1 - f32_ok) * img.shape[0] * img.shape[1]))} pixels)")
    require(u8_ok >= U8_FRAC, "u8 within 1 step on >= 99.9% of pixels")
    require(f32_ok >= FLIP_FRAC and fd_ok >= FLIP_FRAC,
            "f32 atol 2e-4 on all but <= 0.1% (winner-flip) pixels")
    require(not img[0].any() and not img[:, 0].any()
            and img[1:-1, 1:-1].max() > 0.3, "black border, lit interior")
    bmp = OUT / "render.bmp"
    cli_main(["render", "-o", str(bmp)])
    require(np.array_equal(read_bmp(str(bmp)), quantize_u8(img)),
            "the render CLI writes the same frame")
    record["oracle"] = dict(f32_ok=f32_ok, u8_ok=u8_ok, fd_ok=fd_ok)

    say("== phase 5: a few requests (8-frame key script through animate)")
    before = render_fused.LAUNCHES
    keys = expand_script("left*2,up*2,w*2,a*2")
    res = animate(cornell_box(pad_to=32, device=dev),
                  Camera.raytracer_default(device=dev),
                  Lights.single(capacity=1, device=dev), cfg, keys)
    frame_launches = render_fused.LAUNCHES - before
    say(f"{res.n_frames} frames, {res.ms_per_frame:.3f} ms/frame host clock, "
        f"kernel launches {frame_launches}")
    require(frame_launches == len(keys) == 8, "one launch per frame")
    for frame in res.frames:
        require(bool(torch.isfinite(frame).all())
                and float(frame[1:-1, 1:-1].max()) > 0.3,
                "finite frame with a lit interior")
    launches = render_fused.LAUNCHES
    say(f"main path launches: render_fused_fwd {launches}")
    require(launches > 0, "the main path launched the kernel")
    record["animate_ms_per_frame_host"] = res.ms_per_frame

    say("== phase 6: card numbers (512^2 clean forward, CUDA events)")
    args, kw = frame_args(512, "clean", 32)
    table, params = render_fused.pack_inputs(*args[1:], kw["tri_chunk"])
    dirs = args[0]
    kernel_ms = median_ms_in_turns({
        "kernel": lambda: render_fused.fused_fwd(
            dirs, table, params, ambient=kw["ambient"], parity=False),
        "plain": lambda: render_fused.fused_fwd_reference(
            dirs, table, params, ambient=kw["ambient"], parity=False),
    }, n=50, reps=9)
    scene = cornell_box(pad_to=32, device=dev)
    camera = Camera.raytracer_default(device=dev)
    lights = Lights.single(capacity=1, device=dev)
    cfg512 = RenderConfig(width=512, height=512, mode="clean")

    def frame():
        return raytrace(scene, camera, lights, cfg512)

    def plain_frame():
        # The same frame with the kernel wrapper swapped for the plain
        # version, for this measurement only.
        launch = render_fused.fused_fwd
        render_fused.fused_fwd = render_fused.fused_fwd_reference
        try:
            return frame()
        finally:
            render_fused.fused_fwd = launch

    frame_ms = median_ms_in_turns({"kernel": frame, "plain": plain_frame},
                                  n=1, reps=31)
    card = card_line()
    say(f"kernel alone, 512^2 C={tight_chunk(32, 512)}: "
        f"{kernel_ms['kernel']:.4f} ms kernel, {kernel_ms['plain']:.4f} ms "
        f"plain ({card})")
    say(f"forward frame 512^2 clean: {frame_ms['kernel']:.4f} ms through the "
        f"kernel, {frame_ms['plain']:.4f} ms through the plain version "
        f"({card})")
    record.update(card=card, kernel_ms=kernel_ms, frame_ms=frame_ms,
                  main_path_launches=launches, max_abs_err=max_err)
    (OUT / "result.json").write_text(json.dumps(record, indent=1))

    say(card)
    print(json.dumps({"kernels": [{
        "name": "render_fused_fwd",
        "route": "cuda",
        "source": "raytpu_torch/csrc/render_fused.cu",
        "replaces": "raytpu/kernels/render_fused.py:228",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms["kernel"],
        "plain_ms": kernel_ms["plain"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
