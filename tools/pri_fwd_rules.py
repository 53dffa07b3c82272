#!/usr/bin/env python3
"""Times K10a and K10b under other run rules on one card.

    python3 tools/pri_fwd_rules.py OUT.json

K10a and K10b (csrc/soft_raytrace.cu) cut each tile's kept chunks into
work items by a run rule, kernels/soft_raytrace.py PRI_FWD_RUN_MIN (the
run's floor) and PRI_FWD_ITEMS (the items a split aims at). This script
sets other values for a call at a time (chip_smoke.py::pri_fwd_rule) and
times the launcher on the main path's frames: K10a on the render CLI's
500^2 --stl frame and the brute 512^2 mesh step's frame, K10b on the
culled 512^2 mesh step and render --mode soft --stl at 512^2, the rule in
use first. Each rule's m must equal the first's bit for bit, and out and s
stay within rtol 1e-5 / atol 1e-6 of it. It prints a line a frame and
writes the rows to OUT.json. It measures this checkout, on its
chip_smoke.py's cases.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from ab_common import HERE, load, write

# The run rules pri_fwd_rule_ms times, (PRI_FWD_RUN_MIN, PRI_FWD_ITEMS),
# the rule in use first: the run's floor and the items the split aims at,
# each moved alone, and (1024, 1), one item a tile (no split, no merge).
FWD_RULES_UNMASKED = ((8, 1024), (8, 2048), (8, 4096), (1024, 1))
FWD_RULES_MASKED = ((8, 1024), (4, 1024), (16, 1024), (32, 1024),
                    (8, 2048), (8, 4096), (1024, 1))


def pri_fwd_rule_ms(smoke, c, masked: bool, rules, n: int) -> list[dict]:
    """K10a (masked: K10b) on a srt_case under each (run_min, items) of
    rules: the plan's run, items and tiles of more than one item
    (srt.primary_fwd_items) and the launcher's median device ms (held
    stream, in turns, median of 5 of n calls). Requires every rule's m bit
    for bit equal to the first rule's, and out and s within rtol 1e-5 /
    atol 1e-6 of it: the split moves no max, only the rounding of the
    sums. The launcher counts no launch."""
    from raytpu_torch.kernels import soft_raytrace as srt
    pcull = smoke._cull(c, masked, "mask")
    R, n_chunks = c["dirs"].shape[1], c["pri"].shape[0] // c["chunk"]
    n_tiles = c["tiles"].count if masked else -(-R // srt.THREADS)
    mask = c["mask"].cpu() if masked else None
    dev = c["dirs"].device
    rows, outs, calls = [], [], {}
    for run_min, items in rules:
        with smoke.pri_fwd_rule(run_min, items):
            run, plan = srt.primary_fwd_items(mask, n_tiles, n_chunks, R)
            scratch = srt.pri_fwd_scratch(c["pri"], c["chunk"], c["dirs"],
                                          **pcull)
        out = (torch.empty((9, R), device=dev), torch.empty(R, device=dev),
               torch.empty(R, device=dev))

        def call(rule=(run_min, items), out=out, scratch=scratch):
            with smoke.pri_fwd_rule(*rule):
                srt.launch_pri_fwd_kernel(
                    c["pri"], c["chunk"], c["cam"], c["dirs"], c["es"],
                    c["zs"], *out, **pcull, scratch=scratch)

        call()
        per_tile = np.bincount([t for t, _ in plan], minlength=n_tiles)
        rows.append(dict(run_min=run_min, items=items, run=run,
                         n_items=len(plan),
                         merged=int((per_tile > 1).sum()),
                         scratch_mb=scratch.numel() / 1e6))
        outs.append(out)
        calls[f"{run_min}/{items}"] = call
    torch.cuda.synchronize()
    for row, out in zip(rows, outs):
        errs = [(g - w).abs() for g, w in zip(out, outs[0])]
        smoke.require(torch.equal(out[1], outs[0][1])
                and all(bool((e <= 1e-6 + 1e-5 * w.abs()).all())
                        for e, w in zip(errs, outs[0])),
                f"rule {row['run_min']}/{row['items']}: m bitwise, out and "
                f"s within rtol 1e-5 / atol 1e-6 of the rule in use")
        row["max_abs_d"] = max(float(e.max()) for e in errs)
    t = smoke.median_ms_in_turns(calls, n=n, reps=5, timer=smoke.held_ms)
    for row in rows:
        row["ms"] = t[f"{row['run_min']}/{row['items']}"]
    return rows


def pri_fwd_rule_line(rows) -> str:
    """pri_fwd_rule_ms's rows as printed."""
    return "; ".join(
        f"{r['run_min']}/{r['items']}: {r['ms']:.4f} ms, run {r['run']}, "
        f"{r['n_items']} items, {r['merged']} merged, max |d| "
        f"{r['max_abs_d']:.3g}" for r in rows)


def main(out: Path) -> int:
    smoke = load(HERE, "pri_fwd_rules")
    from raytpu_torch import Camera, Lights, RenderConfig, load_stl
    from raytpu_torch.cli import main as cli_module
    from raytpu_torch.core.stl import procedural_stl_text
    dev = torch.device("cuda", 0)
    stl_path = smoke.OUT / "pri_fwd_rules_torus.stl"
    stl_path.write_text(procedural_stl_text())

    def soft_stl_frame(size):
        return (load_stl(str(stl_path), device=dev).pad_to(9216),
                Camera.rasterizer_default(device=dev),
                Lights.single(capacity=1, device=dev),
                RenderConfig(width=size, height=size, mode="soft",
                             soft_edge_sharpness=40.0,
                             soft_z_sharpness=40.0))

    parser = argparse.ArgumentParser()
    cli_module._render_flags(parser)
    flags = ["--stl", str(stl_path), "--mode", "soft"]
    cases = {
        "stl500_cli": (False, smoke.srt_case(
            *cli_module._build_inputs(parser.parse_args(flags)))),
        "stl_512_brute": (False, smoke.srt_case(*soft_stl_frame(512))),
        "stl_step_512": (True, smoke.srt_case(*soft_stl_frame(512),
                                              cull=True)),
        "render_stl_512": (True, smoke.srt_case(*cli_module._build_inputs(
            parser.parse_args(flags + ["--width", "512", "--height",
                                       "512"])), cull=True)),
    }
    record = {"card": smoke.card_line(), "rules": {}}
    for name, (masked, c) in cases.items():
        rows = pri_fwd_rule_ms(
            smoke, c, masked, FWD_RULES_MASKED if masked
            else FWD_RULES_UNMASKED, n=5 if masked else 2)
        record["rules"][name] = rows
        print(f"K10{'b' if masked else 'a'} under other run rules "
              f"(PRI_FWD_RUN_MIN/PRI_FWD_ITEMS, the rule in use first), "
              f"{name}: {pri_fwd_rule_line(rows)} ({record['card']})",
              flush=True)
        torch.cuda.empty_cache()
    write(out, record)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("out", type=Path)
    sys.exit(main(ap.parse_args().out))
