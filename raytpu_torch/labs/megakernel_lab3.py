"""Lab 3 on the H100: is there a fixed cost a call in the chained timing,
and is it the host's or the device's?

The Hopper counterpart of bench/megakernel_lab3.py (:62-100). Lab 3's
estimator (timing.total_time: ms a chain, the best of 4 batches of 3
chains) times chains of 5, 20 and 80 calls of three bodies:

  scalar        a 0-d float32 device tensor times 1.0000001 (one PyTorch
                op; JAX's is not a Pallas kernel either)
  tiny          L4, an (8, 128) tile times 2 (kernels/labs.py::run_tiny)
  fused-kernel  K4 on the Cornell box padded to 32 at size^2 clean, one
                light (kernels/intersect.py::closest_hit_occluded)

and fits total = fixed + slope x iters: slope = (t80 - t5) / 75, fixed =
t5 - 5 slope, in two columns: ``eager``, the chain launched call by call
from the host, and ``graph``, the chain captured once in a CUDA graph and
replayed (the counterpart of JAX's jit of a scan).

    python -m raytpu_torch.labs.megakernel_lab3 [--size 512] [--device cuda]

Each case's line is logged on standard error as the JAX lab logs it, one
a column; the last line of standard output is one JSON object: the totals,
slopes and fixed costs, the card (nvidia-smi name and power limit) and
each kernel's device launches in this run (each counter's change minus the
calls captured into graphs plus the calls replayed). ``--device cpu`` runs
the plain versions on the host clock, eager only: its times are not device
numbers.
"""

from __future__ import annotations

import argparse
import json

import torch

from raytpu_torch.core.types import Lights
from raytpu_torch.kernels import intersect, labs
from raytpu_torch.labs.common import card_line, device_from, lab_inputs, log
from raytpu_torch.labs.timing import total_time

ITERS = (5, 20, 80)


def counts() -> dict:
    return {"lab3_tiny": labs.LAUNCHES_TINY,
            "closest_hit_occluded": intersect.LAUNCHES_OCCLUDED}


def fit(ts: dict) -> dict:
    """Lab 3's line through the totals: slope ms an iteration, fixed ms."""
    k = (ts[80] - ts[5]) / 75.0
    return {"totals": ts, "slope_ms": k, "fixed_ms": ts[5] - 5 * k}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="megakernel_lab3")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_from(args.device)
    start = counts()
    graph_excess = dict.fromkeys(start, 0)

    x = lab_inputs(Lights.single(capacity=1, device=device), args.size,
                   device)
    m, k0, valid, m_l, k0_l = x["consts"][0:5]
    cases = {
        "scalar": (None, lambda c: c * 1.0000001,
                   torch.tensor(1.0, device=device)),
        "tiny": ("lab3_tiny", labs.run_tiny,
                 torch.ones(labs.TINY_SHAPE, device=device)),
        "fused-kernel": ("closest_hit_occluded",
                         lambda d: intersect.closest_hit_occluded(
                             d, m, k0, valid, m_l, k0_l, x["cam_pos"],
                             x["light_pos"], tri_chunk=512), x["dirs"]),
    }
    res = {"cases": {}}
    for name, (key, fn, x0) in cases.items():
        runs = {n: total_time(fn, x0, n) for n in ITERS}
        if key is not None:
            graph_excess[key] += sum(r["calls"]["captured"]
                                     - r["calls"]["replayed"]
                                     for r in runs.values())
        res["cases"][name] = {}
        for col in ("eager", "graph"):
            if runs[ITERS[0]][col] is None:
                res["cases"][name][col] = None
                continue
            f = fit({n: r[col] for n, r in runs.items()})
            res["cases"][name][col] = f
            ts = f["totals"]
            log(f"[lab3] {name} ({col}): totals {ts[5]:.2f}/{ts[20]:.2f}/"
                f"{ts[80]:.2f} ms (5/20/80 iters) -> slope "
                f"{f['slope_ms'] * 1e3:.0f} us/iter, fixed "
                f"{f['fixed_ms']:.2f} ms")
    card = card_line(device)
    res.update(size=args.size, device=str(device), card=card,
               launches={k: v - start[k] - graph_excess[k]
                         for k, v in counts().items()},
               launches_counted="eager calls plus graph replays x calls a "
                                "graph")
    log(f"[lab3] card: {card or 'none (CPU: host-clock times)'}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
