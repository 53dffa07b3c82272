"""Lab 2 on the H100: where does K4's time go, launch and staging or plane
tests?

The Hopper counterpart of bench/megakernel_lab2.py (:158-219). On the
Cornell box padded to 32, 64 and 128, one light
(``Lights.single(capacity=1)``, not compacted), the raytracer's default
camera at size^2 clean, lab 2's estimator (timing.chain_time: the best of
4 batches of 3 chains of 20 calls, each output's sum x 1e-30 carried into
the next input) times four rows:

  primary-only   K5, the closest hit alone (kernels/intersect.py::
                 closest_hit, tri_chunk 512)
  fused 2-phase  K4, the closest hit and the shadow sweep
                 (closest_hit_occluded)
  no-op          L3, K4's launch and staging of the table, no plane test
                 (kernels/labs.py::run_noop)
  single-step    L2, K4's function in one step (run_onestep)

each in two columns: ``eager``, the chain launched call by call from the
host (as labs 4 and 6 time), and ``graph``, the chain captured once in a
CUDA graph and replayed (the counterpart of JAX's jit of a scan). It
counts the rays where L2 differs from K4 (t, idx, occ: one function since
ROADMAP fault F25's repair) and where L3's t differs from the rays' x
component or its idx or occ is not 0.

    python -m raytpu_torch.labs.megakernel_lab2 [--size 512] [--tile 2048]
        [--device cuda]

The last line of standard output is one JSON object: each row's ms a call
in both columns, the mismatch counts, the card (nvidia-smi name and power
limit) and each kernel's device launches in this run (a launch counter
counts a call recorded into a graph, which the device does not run, and
not the graph's replays, which it does: ``launches`` is each counter's
change minus the calls captured plus the calls replayed). ``--device cpu``
runs the plain versions on the host clock, eager only: its times are not
device numbers.
"""

from __future__ import annotations

import argparse
import json

from raytpu_torch.core.types import Lights
from raytpu_torch.kernels import intersect, labs
from raytpu_torch.kernels.tables import constant_table
from raytpu_torch.labs.common import card_line, device_from, lab_inputs, log
from raytpu_torch.labs.timing import chain_time

PADS = (32, 64, 128)
# Each row's function and the launch counter of the one kernel it runs.
ROWS = (("primary-only", "closest_hit"), ("fused 2-phase",
                                          "closest_hit_occluded"),
        ("no-op", "lab2_noop"), ("single-step", "lab2_onestep"))


def counts() -> dict:
    return {"closest_hit": intersect.LAUNCHES_CLOSEST,
            "closest_hit_occluded": intersect.LAUNCHES_OCCLUDED,
            "lab2_noop": labs.LAUNCHES_NOOP,
            "lab2_onestep": labs.LAUNCHES_ONESTEP}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="megakernel_lab2")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--tile", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_from(args.device)
    start = counts()
    # Calls recorded into graphs (counted, not run) less calls replayed.
    graph_excess = dict.fromkeys(start, 0)
    lights = Lights.single(capacity=1, device=device)
    res = {"rows": {}, "mismatch": {}}
    for pad in PADS:
        x = lab_inputs(lights, args.size, device, pad_to=pad)
        m, k0, valid, m_l, k0_l = x["consts"][0:5]
        cam, light, C = x["cam_pos"], x["light_pos"], x["C"]
        table = constant_table(m, k0, valid, m_l[None], k0_l[None], C)
        dirs, dirs_t, tile = x["dirs"], x["dirs_t"], args.tile

        k4 = intersect.closest_hit_occluded(dirs, m, k0, valid, m_l, k0_l,
                                            cam, light, tri_chunk=512)
        one = labs.run_onestep(dirs_t, table, cam, light, tile, C)
        nop = labs.run_noop(dirs_t, table, cam, light, tile, C)
        res["mismatch"][pad] = {
            "onestep_vs_k4": {name: int((a[0] != b).sum()) for name, a, b in
                              zip(("t", "idx", "occ"), one, k4)},
            "noop": {"t": int((nop[0][0] != dirs_t[0]).sum()),
                     "idx": int((nop[1] != 0).sum()),
                     "occ": int((nop[2] != 0).sum())}}
        log(f"[lab2] T={pad}: mismatches {res['mismatch'][pad]}")

        fns = {
            "primary-only": (lambda d: intersect.closest_hit(
                d, m, k0, valid, tri_chunk=512), dirs),
            "fused 2-phase": (lambda d: intersect.closest_hit_occluded(
                d, m, k0, valid, m_l, k0_l, cam, light, tri_chunk=512), dirs),
            "no-op": (lambda d: labs.run_noop(d, table, cam, light, tile, C),
                      dirs_t),
            "single-step": (lambda d: labs.run_onestep(d, table, cam, light,
                                                       tile, C), dirs_t),
        }
        res["rows"][pad] = {}
        for row, key in ROWS:
            fn, x0 = fns[row]
            r = chain_time(fn, x0)
            graph_excess[key] += r["calls"]["captured"] - \
                r["calls"]["replayed"]
            res["rows"][pad][row] = {"eager": r["eager"], "graph": r["graph"]}
            graph = "none" if r["graph"] is None else f"{r['graph']:.4f}"
            log(f"[lab2] T={pad}: {row}: {r['eager']:.4f} ms eager, "
                f"{graph} ms graph")
    card = card_line(device)
    res.update(size=args.size, tile=args.tile, device=str(device), card=card,
               launches={k: v - start[k] - graph_excess[k]
                         for k, v in counts().items()},
               launches_counted="eager calls plus graph replays x calls a "
                                "graph")
    log(f"[lab2] card: {card or 'none (CPU: host-clock times)'}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
