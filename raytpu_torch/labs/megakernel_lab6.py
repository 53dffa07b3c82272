"""Lab 6 on the H100: does the ray layout matter to the fused forward?

The Hopper counterpart of bench/megakernel_lab6.py (:190-279). On the
Cornell box padded to 32, one light (``Lights.single(capacity=1)
.compact()``), the raytracer's default camera at size^2 clean:

  A  K1r, the forward in the (1, tile) row layout (kernels/labs.py::
     fused_fwd_raw): dirs (3, Rp) planar in;
  B  L6, the same forward in the (8, tile/8) blocked layout
     (fused_fwd_blk8): dirs (24, Rp / 8) in, (32, Rp / 8) out;
  C  ``raytrace_full`` at its default RenderConfig, as the JAX lab calls
     it. ``megakernel`` defaults to True, so C runs K1 (rays read as
     (R, 3) structs) and the torch ops around it, not the split design the
     JAX lab's docstring names (ROADMAP fault F21).

Each is timed with bench.py's estimator (timing.chain_fwd: chains of 10,
30 and 50 forwards, the regression slope and its uncertainty). Besides
JAX's maxdiff_ab it counts the entries where A and B differ (color, fd)
and where A and K1 differ (color, fd, idx, occ).

    python -m raytpu_torch.labs.megakernel_lab6 [--size 512] [--tile 2048]
        [--check-only] [--device cuda]

The last line of standard output is one JSON object with JAX's keys
(fused_1row_ms, fused_8row_ms, split_full_fwd_ms, unc_*, maxdiff_ab),
the mismatch counts, the card (nvidia-smi name and power limit) and each
kernel's launches in this run. ``--device cpu`` runs the plain versions on
the host clock: its times are not device numbers.
"""

from __future__ import annotations

import argparse
import json

from raytpu_torch.core.types import Lights
from raytpu_torch.kernels import labs, render_fused
from raytpu_torch.labs.common import (
    card_line,
    device_from,
    lab_inputs,
    log,
    mismatches,
)
from raytpu_torch.labs.timing import chain_fwd
from raytpu_torch.render.raytrace import raytrace_full

LENGTHS = (10, 30, 50)


def _counts() -> dict:
    return {"render_fused_fwd_rows": labs.LAUNCHES_ROWS,
            "megakernel_lab6_blk8": labs.LAUNCHES_BLK8,
            "render_fused_fwd": render_fused.LAUNCHES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="megakernel_lab6")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--tile", type=int, default=2048)
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = device_from(args.device)
    start = _counts()

    x = lab_inputs(Lights.single(capacity=1, device=device).compact(),
                   args.size, device)
    kw = dict(tile_r=args.tile, tri_chunk=x["cfg"].tri_chunk, ambient=0.2,
              parity=False)

    def run_a(d_t):
        c, fd, _, _ = labs.fused_fwd_raw(d_t, *x["consts"], x["par"], **kw)
        return c + fd  # consume both

    def run_b(d_t):
        return labs.fused_fwd_blk8(d_t, *x["consts"], x["par"], **kw)

    d_t = x["dirs_t"]
    a = labs.fused_fwd_raw(d_t, *x["consts"], x["par"], **kw)
    out8 = run_b(d_t)
    cb = labs.unblk8(out8[0:24], args.tile)
    fdb = labs.unblk8(out8[24:32], args.tile)
    k1 = render_fused.fused_fwd(x["dirs"], x["table"], x["par"],
                                ambient=0.2, parity=False)
    k1_rows = (k1.color.T, k1.fd[None], k1.idx[None], k1.occ[None])
    diff = float((a[0] - cb).abs().max())
    diff_fd = float((a[1] - fdb).abs().max())
    ab = mismatches((cb, fdb), a[:2], ("color", "fd"))
    ak1 = mismatches(a, k1_rows)
    log(f"[lab6] A-vs-B maxdiff color {diff:.3e} fd {diff_fd:.3e}; "
        f"mismatches A-vs-B {ab}, A-vs-K1 {ak1}")
    card = card_line(device)
    res = {"maxdiff_ab": diff, "maxdiff_fd": diff_fd, "mismatch_ab": ab,
           "mismatch_a_k1": ak1}
    if not args.check_only:
        ms_a, diag_a = chain_fwd(run_a, d_t, lengths=LENGTHS)
        res["fused_1row_ms"], res["unc_1row"] = ms_a, diag_a["unc_ms"]
        log(f"[lab6] A (1, tile) K1r fused fwd: {ms_a:.4f} ms "
            f"+- {diag_a['unc_ms']:.4f}")
        ms_b, diag_b = chain_fwd(run_b, d_t, lengths=LENGTHS)
        res["fused_8row_ms"], res["unc_8row"] = ms_b, diag_b["unc_ms"]
        log(f"[lab6] B (8, tile/8) L6 fused fwd: {ms_b:.4f} ms "
            f"+- {diag_b['unc_ms']:.4f}")

        def run_c(s):
            return raytrace_full(s, x["camera"], x["lights"], x["cfg"]).image

        ms_c, diag_c = chain_fwd(run_c, x["scene"], lengths=LENGTHS)
        res["split_full_fwd_ms"], res["unc_split"] = ms_c, diag_c["unc_ms"]
        log(f"[lab6] C raytrace_full at its default config (the megakernel "
            f"branch: K1, F21): {ms_c:.4f} ms +- {diag_c['unc_ms']:.4f}")
        res["diag"] = {"1row": diag_a, "8row": diag_b, "split": diag_c}
    res.update(size=args.size, tile=args.tile, device=str(device),
               card=card, launches={k: v - start[k]
                                    for k, v in _counts().items()})
    log(f"[lab6] card: {card or 'none (CPU: host-clock times)'}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
