"""Lab 4 on the H100: where does the fused forward's time go?

The Hopper counterpart of bench/megakernel_lab4.py (:160-208). On the
Cornell box padded to 32, one light (``Lights.single(capacity=1)``, not
compacted, as the JAX lab has it), the raytracer's default camera at
size^2 clean, lab 4's estimator (timing.slope_time: chains of 5 and 40,
batch minima) times five rows:

  two-phase      K4, the closest hit and the shadow sweep alone
                 (kernels/intersect.py::closest_hit_occluded)
  mega-full      L5 with the gather and the shading: K1r's function
  mega-nogather  L5 with the winner's attributes replaced by constants
  mega-noshade   L5 with color = normal + albedo, fd = t
  mega-neither   L5 with both switched off (the JAX lab runs it too)

It counts the entries where each variant differs from K1r: all four
outputs for mega-full, which computes K1r's function; idx and occ, which
every variant computes as K1r does, for the others.

    python -m raytpu_torch.labs.megakernel_lab4 [--size 512] [--tile 2048]
        [--device cuda]

The last line of standard output is one JSON object: each row's ms, the
mismatch counts, the card (nvidia-smi name and power limit) and each
kernel's launches in this run. ``--device cpu`` runs the plain versions on
the host clock: its times are not device numbers.
"""

from __future__ import annotations

import argparse
import json

from raytpu_torch.core.types import Lights
from raytpu_torch.kernels import intersect, labs
from raytpu_torch.labs.common import (
    card_line,
    device_from,
    lab_inputs,
    log,
    mismatches,
)
from raytpu_torch.labs.timing import slope_time

VARIANTS = ((True, True, "mega-full"), (False, True, "mega-nogather"),
            (True, False, "mega-noshade"), (False, False, "mega-neither"))


def _counts() -> dict:
    return {"closest_hit_occluded": intersect.LAUNCHES_OCCLUDED,
            "megakernel_lab4_variant": labs.LAUNCHES_VARIANT,
            "render_fused_fwd_rows": labs.LAUNCHES_ROWS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="megakernel_lab4")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--tile", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_from(args.device)
    start = _counts()

    x = lab_inputs(Lights.single(capacity=1, device=device), args.size,
                   device)
    m, k0, valid, m_l, k0_l = x["consts"][0:5]
    tri_chunk = x["cfg"].tri_chunk
    table, par, C, tile = x["table"], x["par"], x["C"], args.tile
    d_t = x["dirs_t"]

    k1r = labs.fused_fwd_raw(d_t, *x["consts"], par, tile_r=tile,
                             tri_chunk=tri_chunk, ambient=0.2, parity=False)
    res = {"mismatch_vs_k1r": {}}
    for g, s, name in VARIANTS:
        out = labs.run_variant(d_t, table, par, tile, C, g, s)
        res["mismatch_vs_k1r"][name] = (
            mismatches(out, k1r) if g and s
            else mismatches(out[2:], k1r[2:], ("idx", "occ")))
    log(f"[lab4] mismatches against K1r: {res['mismatch_vs_k1r']}")

    ms = slope_time(
        lambda d: intersect.closest_hit_occluded(
            d.T.contiguous(), m, k0, valid, m_l, k0_l, x["cam_pos"],
            x["light_pos"], tri_chunk=tri_chunk),
        d_t)
    res["two-phase"] = ms
    log(f"[lab4] two-phase: {ms:.4f} ms")
    for g, s, name in VARIANTS:
        ms = slope_time(
            lambda d, g=g, s=s: labs.run_variant(d, table, par, tile, C, g,
                                                 s),
            d_t)
        res[name] = ms
        log(f"[lab4] {name}: {ms:.4f} ms")
    card = card_line(device)
    res.update(size=args.size, tile=tile, device=str(device), card=card,
               launches={k: v - start[k] for k, v in _counts().items()})
    log(f"[lab4] card: {card or 'none (CPU: host-clock times)'}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
