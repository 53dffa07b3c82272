#!/usr/bin/env python3
"""Times one checkout's occlusion of known points (K7b, K7c), its
closest-hit kernels (K5, K7d, K7a), or its one-chunk sweeps (K4, L2, K1),
on one card.

    python3 tools/occlusion_ab.py TREE OUT.json [--frames | --hits | --sweeps]

TREE is the root of a checkout of this repository: this one, or an earlier
commit unpacked with ``git archive``. The script imports raytpu_torch from
TREE and this checkout's chip_smoke.py for its inputs, and measures through
TREE's wrapper (kernels/intersect.py::occlusion_multi):

- phase 29's four cases (chip_smoke.py::occlusion_cases): the device's ms
  a call (a held stream, median of 7), the host's us a call (20 calls
  enqueued on a held stream, median of 15) and a digest of the bits;
- where TREE's wrapper cuts K7c's kept chunks into runs
  (kernels/intersect.py::occlusion_run), K7c's device ms a call on the two
  STL cases under runs of 4, 8, 16 and 1,024 kept chunks (median of 5 in
  turns), the bits required equal under every run;
- phase 30's sharded full-feature and STL frames on a 1 x 1 mesh: ms a
  frame on the host's clock to the call's return and to the device's end
  (median of 15), the device's busy ms a frame under the profiler
  (chip_smoke.py::device_busy) and a digest of the frame.

``--frames`` measures the frames alone. ``--hits`` measures instead the
closest-hit kernels through TREE's launch helpers
(kernels/intersect.py::launch_closest_kernel, launch_occluded_masked_kernel)
on this checkout's chip_smoke.py::hit_cases: K5 and K7d on the
stl_intersect row (512^2, the mesh padded to 9,216), K5 on the sharded
renderer's one-chunk Cornell sub-ray (512^2, T = 32), K7a whole and its
primary half (phases 1) on the render --stl sub-ray at S = 1, K7a whole at
S = 32: the device's ms a call (a held stream, median of 7), the host's us
a call and a digest of the outputs; where TREE's launch helpers cut K7d's
and K7a's tiles into runs (kernels/intersect.py::PRIMARY_RUN), K7d's and
K7a's primary half's device ms under runs of 2, 4, 8, 16 and 32 kept chunks
and one run a tile (median of 5 in turns), the bits required equal under
every run.

``--sweeps`` measures instead the one-chunk sweeps through TREE's launch
helpers and wrappers: K4 (kernels/intersect.py::launch_occluded_kernel) on
phase 9's 512^2 clean case and its 500^2 parity AA sub-ray
(chip_smoke.py::sweep_case), K1 (kernels/render_fused.py::fused_fwd) on
phase 3's 512^2 clean and 500^2 parity frames, L2
(kernels/labs.py::launch_k4_probe) on lab 2's 512^2 planar rays: the
device's ms a call (a held stream, median of 7, 20 calls a hold) and a
digest of the outputs, over consecutive rays and, where TREE's kernels
take an image's warps (kernels/intersect.py::sweep_grid), over warps of
1, 2, 4 and 8 rows of pixels, the bits required equal under every
mapping; then the default render frame (500^2 parity, one K1) and the
--aa 3 frame (nine K4): ms a frame on the host's clock to the call's
return and to the device's end (median of 15), the device's busy ms under
the profiler and a digest of the image. It writes what it measured to
OUT.json; tools/ab_common.py says how two checkouts are compared.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from ab_common import digest, host_us, load, wall_ms, write


def runs_ms(isect, c, smoke, runs=(4, 8, 16, 1024)) -> dict:
    """K7c's device ms a launch on the occlusion case c under each run of
    kept chunks, in turns; the bits equal to the wrapper's under each."""
    S, R = c["src"].shape[0], c["pos"].shape[0]
    want = smoke.run_occlusion(c)
    outs, fns = {}, {}
    for run in runs:
        outs[run] = torch.empty((S, R), dtype=torch.int32,
                                device=c["pos"].device)
        scratch = isect.occlusion_scratch(c["pos"], c["table"], c["C"], S,
                                          c["mask"], c["tiles"], run)
        fns[run] = (lambda run=run, scratch=scratch:
                    isect.launch_occlusion_kernel(
                        c["pos"], c["table"], c["C"], c["src"], c["mask"],
                        c["tiles"], outs[run], scratch=scratch, run=run))
    ms = smoke.median_ms_in_turns(fns, n=5, reps=5, timer=smoke.held_ms)
    torch.cuda.synchronize()
    for run in runs:
        smoke.require(torch.equal(outs[run], want),
                      f"K7c's bits under runs of {run}")
    return {str(run): ms[run] for run in runs}


def hits(smoke, dev, mesh9028) -> dict:
    """K5, K7d and K7a on chip_smoke.py::hit_cases through the launch
    helpers: device ms, host us and a digest of the outputs of each."""
    from raytpu_torch.kernels import intersect as isect
    cases = smoke.hit_cases(dev, mesh9028)
    calls = {}
    for name, c in cases.items():
        S = c["src"].shape[0]
        outs = isect._outputs(c["dirs"], S)
        if "k0_s" in c:
            scratch = isect.k7a_scratch(c["dirs"], c["table"], c["C"], S,
                                        c["tiles"])
            for key, phases in (("k7a", 3), ("k7a_primary", 1)):
                if S > 1 and phases == 1:
                    continue
                calls[f"{key}_{name}"] = (
                    lambda c=c, outs=outs, scratch=scratch, phases=phases:
                    isect.launch_occluded_masked_kernel(
                        c["dirs"], c["table"], c["C"], c["cam"], c["src"],
                        c["mask"], c["tiles"], *outs, scratch=scratch,
                        phases=phases), outs if phases == 3 else outs[:2])
            continue
        masks = {"k5": None}
        if "mask" in c:
            masks["k7d"] = c["mask"][:, :c["n_chunks"]].contiguous()
        for key, mask in masks.items():
            calls[f"{key}_{name}"] = (
                lambda c=c, outs=outs, mask=mask:
                isect.launch_closest_kernel(c["dirs"], c["table"][:10],
                                            c["C"], mask, c["tiles"],
                                            *outs[:2]), outs[:2])
    record = {}
    for key, (call, outs) in calls.items():
        ms = smoke.median_ms_in_turns({"k": call}, n=3, reps=7,
                                      timer=smoke.held_ms)["k"]
        call()
        record[key] = dict(ms=ms, host_us=host_us(call, smoke.HOLD_CYCLES),
                           bits=digest(outs))
        print(key, record[key], flush=True)
    if hasattr(isect, "PRIMARY_RUN"):
        record["runs"] = primary_runs_ms(isect, cases, smoke)
        print("runs", record["runs"], flush=True)
    return record


def primary_runs_ms(isect, cases, smoke, runs=(2, 4, 8, 16, 32)) -> dict:
    """K7d's device ms a launch on the stl_intersect row and K7a's primary
    half's at S = 1 under runs of at most `run` kept chunks (and one run a
    tile: run = the chunk count), in turns; the bits required equal to the
    wrapper's under each."""
    out = {}
    for name, kernel in (("stl_intersect_512", "k7d"),
                         ("render_stl_500_s1", "k7a_primary")):
        c = cases[name]
        S = c["src"].shape[0]
        want = smoke.run_stl(c, "k7d" if kernel == "k7d" else "k7a")[:2]
        fns, outs = {}, {}
        for run in (*runs, c["n_chunks"]):
            outs[run] = isect._outputs(c["dirs"], S)
            if kernel == "k7d":
                mask = c["mask"][:, :c["n_chunks"]].contiguous()
                scratch = isect.closest_scratch(c["dirs"], c["table"][:10],
                                                c["C"], mask, c["tiles"], run)
                fns[run] = (lambda run=run, mask=mask, scratch=scratch:
                            isect.launch_closest_kernel(
                                c["dirs"], c["table"][:10], c["C"], mask,
                                c["tiles"], *outs[run][:2], run=run,
                                scratch=scratch))
                continue
            saved, isect.PRIMARY_RUN = isect.PRIMARY_RUN, run
            scratch = isect.k7a_scratch(c["dirs"], c["table"], c["C"], S,
                                        c["tiles"])
            isect.PRIMARY_RUN = saved

            def launch(run=run, scratch=scratch):
                saved, isect.PRIMARY_RUN = isect.PRIMARY_RUN, run
                isect.launch_occluded_masked_kernel(
                    c["dirs"], c["table"], c["C"], c["cam"], c["src"],
                    c["mask"], c["tiles"], *outs[run], scratch=scratch,
                    phases=1)
                isect.PRIMARY_RUN = saved
            fns[run] = launch
        ms = smoke.median_ms_in_turns(fns, n=5, reps=5, timer=smoke.held_ms)
        torch.cuda.synchronize()
        for run in fns:
            smoke.require(all(torch.equal(a, b) for a, b in
                              zip(outs[run][:2], want)),
                          f"{kernel}'s bits under runs of {run}")
        out[kernel] = {str(run): ms[run] for run in fns}
    return out


def sweeps(smoke, dev) -> dict:
    """K4, K1 and L2 through TREE's launch helpers on their main-path
    inputs, every warp mapping TREE has, and the two frames that run them
    (the module docstring)."""
    from raytpu_torch import Camera, Lights, RenderConfig, cornell_box
    from raytpu_torch.kernels import intersect as isect
    from raytpu_torch.kernels import labs, render_fused
    from raytpu_torch.kernels.tables import constant_table
    from raytpu_torch.labs.common import lab_inputs
    from raytpu_torch.render.raytrace import fused_inputs, raytrace_full
    tiled = hasattr(isect, "sweep_grid")
    rows = (1, 2, 4, 8) if tiled else ()
    record, calls = {}, {}

    def with_rows(wh, fn):
        def call():
            saved, isect.SWEEP_WARP_ROWS = isect.SWEEP_WARP_ROWS, wh
            try:
                return fn()
            finally:
                isect.SWEEP_WARP_ROWS = saved
        return call

    one = Lights.single(capacity=1, device=dev)
    for name, size, mode, pad, off in (
            ("k4_512_clean", 512, "clean", 32, (0.0, 0.0)),
            ("k4_500_parity", 500, "parity", None, (0.5, 0.0))):
        c = smoke.sweep_case(dev, size, mode, pad, one, 1, off)
        outs = isect._outputs(c["dirs"], 1)
        args = (c["dirs"], c["table"], c["cam"], c["src"], *outs)
        calls[f"{name}_rays"] = (
            lambda a=args: isect.launch_occluded_kernel(*a), outs)
        for wh in rows:
            calls[f"{name}_image{wh}"] = (with_rows(
                wh, lambda a=args, hw=(size, size):
                isect.launch_occluded_kernel(*a, image_hw=hw)), outs)
    for size, mode, pad in ((512, "clean", 32), (500, "parity", None)):
        cfg = RenderConfig(width=size, height=size, mode=mode)
        fargs = fused_inputs(cornell_box(pad_to=pad, device=dev),
                             Camera.raytracer_default(device=dev), one, cfg)
        table, params = render_fused.pack_inputs(*fargs[1:], cfg.tri_chunk)
        kw = dict(ambient=cfg.ambient, parity=mode == "parity")
        held = {}

        def k1(hw=None, a=(fargs[0], table, params), kw=kw, held=held):
            extra = {} if hw is None else {"image_hw": hw}
            held["out"] = render_fused.fused_fwd(*a, **kw, **extra)
            return held["out"]
        name = f"k1_{size}_{mode}"
        calls[f"{name}_rays"] = (k1, held)
        for wh in rows:
            calls[f"{name}_image{wh}"] = (with_rows(
                wh, lambda hw=(size, size), k1=k1: k1(hw)), held)
    x = lab_inputs(one, 512, dev, pad_to=32)
    m, k0, valid, m_l, k0_l = x["consts"][0:5]
    t4 = constant_table(m, k0, valid, m_l[None], k0_l[None], x["C"])
    R = x["dirs_t"].shape[1]
    l2_out = (torch.empty((1, R), device=dev),
              torch.empty((1, R), dtype=torch.int32, device=dev),
              torch.empty((1, R), dtype=torch.int32, device=dev))
    calls["l2_512_clean"] = (
        lambda: labs.launch_k4_probe(x["dirs_t"], t4, x["cam_pos"],
                                     x["light_pos"], False, *l2_out), l2_out)
    ms = smoke.median_ms_in_turns({k: v[0] for k, v in calls.items()},
                                  n=20, reps=7, timer=smoke.held_ms)
    for key, (call, outs) in calls.items():
        call()
        torch.cuda.synchronize()
        record[key] = dict(ms=ms[key], bits=digest(
            tuple(outs["out"]) if isinstance(outs, dict) else outs))
        print(key, record[key], flush=True)
    for key in record:
        base = key.rsplit("_", 1)[0]
        if key.startswith(("k4", "k1")):
            smoke.require(record[key]["bits"] == record[f"{base}_rays"]["bits"],
                          f"{key}: the bits of consecutive rays")
    for name, cfg in (("render_500_parity", RenderConfig()),
                      ("aa3_500_parity", RenderConfig(aa_samples=3))):
        scene = cornell_box(device=dev)
        camera = Camera.raytracer_default(device=dev)

        def frame(scene=scene, camera=camera, cfg=cfg):
            return raytrace_full(scene, camera, one, cfg).image
        img = frame()
        busy = smoke.device_busy(frame, steps=3)
        host_ms, done_ms = wall_ms(frame)
        record[name] = dict(ms=done_ms, host_ms=host_ms,
                            busy_ms=busy["busy_ms"], share=busy["share"],
                            img=digest(img))
        print(name, record[name], flush=True)
    return record


def main(tree: Path, out: Path, mode: str) -> int:
    smoke = load(tree, "occlusion_ab")
    from raytpu_torch import load_stl
    from raytpu_torch.core.stl import procedural_stl_text
    from raytpu_torch.parallel import (
        init_distributed,
        make_mesh,
        shutdown_distributed,
    )
    from raytpu_torch.parallel import render as pr
    dev = torch.device("cuda", 0)
    if mode == "--sweeps":
        write(out, {"tree": str(tree), "card": smoke.card_line(),
                    "kernels": sweeps(smoke, dev)})
        return 0
    stl_path = smoke.OUT / "occlusion_ab_torus.stl"
    stl_path.write_text(procedural_stl_text())
    mesh9028 = load_stl(str(stl_path), device=dev)
    record = {"tree": str(tree), "card": smoke.card_line(), "kernels": {},
              "frames": {}}
    if mode == "--hits":
        record["kernels"] = hits(smoke, dev, mesh9028)
        write(out, record)
        return 0
    cases = {} if mode else smoke.occlusion_cases(dev, mesh9028)
    for name, c in cases.items():
        def call(c=c):
            return smoke.run_occlusion(c)
        ms = smoke.median_ms_in_turns({"k": call}, n=5, reps=7,
                                      timer=smoke.held_ms)["k"]
        record["kernels"][name] = dict(
            ms=ms, host_us=host_us(call, smoke.HOLD_CYCLES),
            bits=digest(call()))
        print(name, record["kernels"][name], flush=True)
    from raytpu_torch.kernels import intersect as isect
    if cases and hasattr(isect, "occlusion_run"):
        record["runs"] = {name: runs_ms(isect, cases[name], smoke)
                          for name in ("stl_512_s1", "stl_512_s16")}
        print("runs", record["runs"], flush=True)
    del cases
    init_distributed()
    mesh = make_mesh(1, 1)
    frames = {"full_feature_512": smoke.full_feature_frame(dev, 512),
              "stl_512": smoke.stl_lit_frame(dev, mesh9028)}
    with torch.no_grad():
        for name, f in frames.items():
            fn = pr.make_sharded_render(mesh, f[3])

            def frame(fn=fn, f=f):
                return fn(*f[:3])
            img = frame()
            busy = smoke.device_busy(frame, steps=3)
            host_ms, ms = wall_ms(frame)
            record["frames"][name] = dict(
                ms=ms, host_ms=host_ms, busy_ms=busy["busy_ms"],
                share=busy["share"], img=digest(img))
            print(name, record["frames"][name], flush=True)
    shutdown_distributed()
    write(out, record)
    return 0


if __name__ == "__main__":
    if len(sys.argv) not in (3, 4) or sys.argv[3:] not in (
            [], ["--frames"], ["--hits"], ["--sweeps"]):
        raise SystemExit(__doc__)
    sys.exit(main(Path(sys.argv[1]).resolve(), Path(sys.argv[2]),
                  "".join(sys.argv[3:])))
