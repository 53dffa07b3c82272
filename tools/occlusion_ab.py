#!/usr/bin/env python3
"""Times one checkout's occlusion of known points (K7b, K7c), or its
closest-hit kernels (K5, K7d, K7a), on one card.

    python3 tools/occlusion_ab.py TREE OUT.json [--frames | --hits]

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
every run. It writes what it measured to
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
            [], ["--frames"], ["--hits"]):
        raise SystemExit(__doc__)
    sys.exit(main(Path(sys.argv[1]).resolve(), Path(sys.argv[2]),
                  "".join(sys.argv[3:])))
