#!/usr/bin/env python3
"""Times one checkout's K8a, K8c, K9a and K9b, and the frames and steps
they sit in, on one card.

    python3 tools/raster_soft_ab.py TREE OUT.json [--counts | --fit]

TREE is the root of a checkout of this repository: this one, or an earlier
commit unpacked with ``git archive``. The script imports raytpu_torch from
TREE and this checkout's chip_smoke.py for its inputs, and measures through
TREE's public wrappers (kernels/raster.py::raster_winner_chunked and
raster_winner_masked, kernels/soft_raster.py::soft_agg_fwd):

- the kernels on the main path's shapes: K8a on the 9,028-triangle mesh at
  512^2 (phase 29's), K8c on the rasterize CLI's 500^2 --stl frame (phase
  12's), K9b on the 512^2 culled soft STL step's forward and K9a on the
  512^2 Cornell frame and the fit CLI's 500^2 frame (phase 15's): the
  device's ms a call (a held stream, median of 7) and a digest of the
  output;
- the frames and steps they sit in: the sharded STL raster frame on a 1 x 1
  mesh (phase 30), the rasterize CLI's --stl frame, the culled soft STL
  train step (CUDA events, median of 15, the frames without grad) and the
  fit CLI's ms a step (200 steps, the median of its logged steps).

``--counts`` (this checkout only) prints instead the work the redesigned
kernels' plain forms find on those inputs: the (tile or block, row) pairs the
raster cull and the soft dead-row test decide, and K9b's work items.
``--fit`` measures the fit alone: K9a's device ms on the fit frame, the
host's us a soft_agg_fwd call there (20 calls enqueued on a held stream,
median of 15) and the fit CLI's ms a step.

It writes what it measured to OUT.json; tools/ab_common.py says how two
checkouts are compared.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import sys
from pathlib import Path

import torch

from ab_common import HERE, digest, host_us, load, write


def fit_step_ms(cli_main, smoke, steps: int = 200) -> dict:
    """The fit CLI's ms a step: the median of its logged steps."""
    logs = io.StringIO()
    target = HERE / "results" / "fit_reference" / "target.bmp"
    with contextlib.redirect_stderr(logs), \
            contextlib.redirect_stdout(io.StringIO()):
        cli_main(["fit", str(target), "--steps", str(steps), "-o",
                  str(smoke.OUT / "raster_soft_ab_fit.bmp")])
    logged = [json.loads(line)["ms_per_step"]
              for line in logs.getvalue().splitlines()
              if line.startswith("{")]
    return dict(ms=statistics.median(logged), logged=logged)


def main(tree: Path, out: Path, mode: str) -> int:
    smoke = load(tree, "raster_soft_ab")
    from raytpu_torch import Camera, Lights, RenderConfig, cornell_box
    from raytpu_torch import load_stl
    from raytpu_torch.cli.main import main as cli_main
    from raytpu_torch.core.stl import procedural_stl_text
    from raytpu_torch.kernels import raster
    from raytpu_torch.kernels import soft_raster as sr
    from raytpu_torch.render.rasterize import rasterize
    from raytpu_torch.render.soft import rasterize_soft
    dev = torch.device("cuda", 0)
    stl_path = smoke.OUT / "raster_soft_ab_torus.stl"
    stl_path.write_text(procedural_stl_text())

    def soft_frame(scene, camera, size, es, zs):
        return (scene, camera, Lights.single(capacity=1, device=dev),
                RenderConfig(width=size, height=size, mode="soft",
                             soft_edge_sharpness=es, soft_z_sharpness=zs))

    def pick(f):
        return f[0], f[1], f[3]

    def timed(fn) -> float:
        return smoke.median_ms_in_turns({"k": fn}, n=5, reps=7,
                                        timer=smoke.held_ms)["k"]

    def soft_fwd(c):
        return sr.soft_agg_fwd(c["consts"], c["H"], c["W"], c["chunk"],
                               c["mask"], c["es"], c["zs"])

    fit_frame = (cornell_box(device=dev),
                 Camera.make((0.0, 0.0, -3.0), focal=500.0, y_scale=1.01,
                             device=dev),
                 Lights.single(capacity=1, intensity=10.0, device=dev),
                 RenderConfig(mode="soft", soft_edge_sharpness=10.0,
                              soft_z_sharpness=20.0))
    record = {"tree": str(tree), "card": smoke.card_line()}
    if mode == "fit":
        c = smoke.soft_case(*pick(fit_frame))
        call = (lambda: soft_fwd(c))
        record["k9a_500_fit"] = dict(
            ms=timed(call), host_us=host_us(call, smoke.HOLD_CYCLES),
            bits=digest(call()))
        record["fit_cli_step"] = fit_step_ms(cli_main, smoke)
        print({k: v for k, v in record["fit_cli_step"].items()
               if k != "logged"}, record["k9a_500_fit"], flush=True)
        write(out, record)
        return 0

    k8_frame = smoke.stl_frame(dev, stl_path, 512)
    k8c_frame = smoke.stl_frame(dev, stl_path, 500)
    soft_stl = soft_frame(load_stl(str(stl_path), device=dev).pad_to(9216),
                          Camera.rasterizer_default(device=dev), 512, 40.0,
                          40.0)
    soft_bench = soft_frame(cornell_box(pad_to=32, device=dev),
                            Camera.rasterizer_default(device=dev), 512, 40.0,
                            40.0)

    k8a = smoke.raster_case(*pick(k8_frame))
    k8c = smoke.raster_case(*pick(k8c_frame))
    scases = {"k9b_512_stl": smoke.soft_case(*pick(soft_stl)),
              "k9a_512_bench": smoke.soft_case(*pick(soft_bench)),
              "k9a_500_fit": smoke.soft_case(*pick(fit_frame))}

    if mode == "counts":
        w = {"k8a_stl_512": smoke.winner_work(k8a["consts"], 512, 512),
             "k8c_500_stl": smoke.winner_work(k8c["consts"], 500, 500,
                                              k8c["chunk"], k8c["mask"])}
        for name, x in w.items():
            print(f"{name}: {smoke.winner_work_line(x)}", flush=True)
        for name, c in scases.items():
            stats = {}
            smoke.plain_soft_fwd(c, stats=stats)
            mask = c["mask"]
            n_tiles = -(-c["H"] // 16) * -(-c["W"] // 16)
            stats["items"] = sr.soft_fwd_items(mask, n_tiles,
                                               c["consts"].shape[0]
                                               // c["chunk"])
            stats["pairs_before"] = smoke.soft_bound(c, False)[0]
            w[name] = stats
            print(f"{name}: {stats['dead']} of {stats['rows']} (block, row) "
                  f"pairs dead ({stats['dead'] / max(1, stats['rows']):.4%})"
                  f", {stats['live_pairs']} live (pixel, row) pairs; items "
                  f"{stats['items']}", flush=True)
            torch.cuda.empty_cache()
        record["counts"] = w
        write(out, record)
        return 0

    calls = {
        "k8a_stl_512": lambda: raster.raster_winner_chunked(
            k8a["consts"], 512, 512, 128),
        "k8c_500_stl": lambda: raster.raster_winner_masked(
            k8c["consts"], 500, 500, k8c["mask"], k8c["chunk"]),
    }
    for name, c in scases.items():
        calls[name] = (lambda c=c: soft_fwd(c))
    record["kernels"] = {}
    for name, fn in calls.items():
        got = fn()
        record["kernels"][name] = dict(
            ms=timed(fn), bits=digest(got))
        print(name, record["kernels"][name], flush=True)

    from raytpu_torch.parallel import (
        init_distributed,
        make_mesh,
        shutdown_distributed,
    )
    from raytpu_torch.parallel import render as pr
    init_distributed()
    mesh = make_mesh(1, 1)
    sharded = pr.make_sharded_rasterize(mesh, k8_frame[3])

    def cull_render(s, c, li, cfg):
        return rasterize_soft(s, c, li, cfg, cull=True)

    step = smoke.train_step(*soft_stl, 1e-9, target_scale=0.9,
                            render=cull_render)
    frames = {"sharded_stl_raster_512": lambda: sharded(*k8_frame[:3]),
              "rasterize_stl_500": lambda: rasterize(*k8c_frame),
              "soft_stl_culled_step": step}
    record["frames"] = {}
    for name, fn in frames.items():
        ctx = torch.no_grad() if name != "soft_stl_culled_step" else \
            contextlib.nullcontext()
        with ctx:
            img = fn()
            ms = smoke.median_ms_in_turns({"f": fn}, n=1, reps=15)["f"]
        record["frames"][name] = dict(
            ms=ms, bits=digest(img) if torch.is_tensor(img) else None)
        print(name, record["frames"][name], flush=True)
    shutdown_distributed()

    record["frames"]["fit_cli_step"] = fit_step_ms(cli_main, smoke)
    print("fit_cli_step", record["frames"]["fit_cli_step"], flush=True)
    write(out, record)
    return 0


if __name__ == "__main__":
    flags = [a for a in sys.argv[1:] if a.startswith("--")]
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if len(args) != 2 or flags not in ([], ["--counts"], ["--fit"]):
        raise SystemExit(__doc__)
    sys.exit(main(Path(args[0]).resolve(), Path(args[1]),
                  flags[0][2:] if flags else "all"))
