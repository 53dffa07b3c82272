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
     the port's copy of the numpy oracle (raytpu_torch.oracle; this script
     imports nothing of JAX or of the JAX package), and the ``render`` CLI
     writing a BMP.
  5. a few requests: an 8-frame key script through the animate loop, every
     frame written as a BMP equal to the frame the renderer returned; then
     the ``animate`` CLI at ``--preset realtime`` (150^2 parity, the Cornell
     box padded to 32, its default 100-key script) writing every 8th frame
     to build/chip_smoke/animate, its fps and compile_s printed. The kernel
     must launch exactly once a frame, plus once for the render that warms
     the path before the clock starts (JAX's ``compile_s``).
  6. card numbers: the 512^2 clean forward frame and the kernel alone, each
     through the kernel and through the plain version, timed with CUDA
     events (median), beside the card's name and power limit; K1's bound
     on its culled sweeps' work (sweep_cull_work) beside the bound before
     the cull, and the cull's probe (sweep_probe_check: the card's
     decisions on K1's warps = their plain form, no ok or blocking ray in
     a culled pair) at 512^2 clean and 500^2 parity, over the image's
     warps and over consecutive rays.
  7. the backward kernels (K2, the per-ray backward, and K3, the sums per
     triangle) against their plain version on the card, at 512^2 clean,
     500^2 parity and 1024^2 clean, with cotangents drawn from a numpy
     seed: g_dirs, g_table and g_params within rtol 1e-4 / atol 1e-5 of the
     plain version evaluated in float64, two kernel calls bit-identical,
     all finite. (A per-triangle sum adds 10^3-10^5 terms; the float32
     plain version's own rounding reaches 0.8 of that tolerance, so the
     float64 evaluation is the reference and the float32 one is printed.)
  8. the train path as a user writes it: 20 SGD steps (lr 1e-9, every
     float leaf of scene and lights) of the MSE of the 512^2 clean render
     to a fixed target, each step launching K1, K2 and K3 once; an albedo
     fit (albedo + 0.1, lr 1.0) whose loss falls at every step to below
     10% of its start; then card numbers: the train step through the
     kernels and through the plain backward, K2 and K3 alone and the plain
     backward alone, ``index_add_`` for K3's function, the device-busy
     share of a step (torch.profiler), and the 1024^2 train step.
  9. the intersection kernels of the loop branch (K4, one light; K6,
     several shadow sources) against their plain version on the card:
     512^2 clean with one light, the bench's full-feature sources (2
     lights x 16 samples, S = 32) and 500^2 parity (30 triangles) at an AA
     sub-ray offset. t, idx and occ bit-identical (K4 over the image's
     warps and over consecutive rays), two calls identical, and the VJP of
     t within rtol 1e-4 / atol 1e-5 of its float64 evaluation.
 10. the loop branch serving: raytrace at the CLI's ``--aa 3`` (exactly 9
     K4 launches) against the numpy oracle; the ``render`` CLI's
     full-feature frame (``--aa 3 --soft-shadows 16 --add-light ...
     --dof``, exactly 9 K6 launches); the view server on a free loopback
     port answering page, frame, key and state requests, each with the
     launches its toggles call for (K1 with everything off, K4 a sub-ray
     with one light, K6 a sub-ray with more sources).
 11. the loop branch training: 3 SGD steps of the bench's full-feature
     512^2 step (every float leaf of scene and lights, jittered positions
     included; exactly 9 K6 launches a step, no other kernel; finite
     gradients); then card numbers: the full-feature frame and step,
     K4 and K6 alone beside their plain versions and bounds (K4's on its
     culled sweeps' work, and before the cull), K4's cull probe on phase
     9's two K4 cases, the device-busy share and event count of a step and
     its peak memory.
 12. the hard rasterizer's winner kernels (K8b, one triangle chunk; K8c,
     several chunks skipped by a (pixel tile, chunk) mask) against their
     plain versions on the card: K8b at 512^2 clean (the bench's raster
     step: Cornell box padded to 32, the rasteriser camera) and at 500^2
     clean (30 triangles); K8c on the 9,028-triangle procedural STL mesh
     (raytpu_torch.core.stl.procedural_stl_text, written to
     build/chip_smoke/) at 500^2 clean, with its mask and with the mask
     forced to all ones. 0 winner mismatches, masked = all-ones, two calls
     identical; the mask's keep rate. K8c's per-tile row cull on its STL
     frame: the pairs its plain form (kernels/raster.py::
     raster_tile_reject) decides, and the card's probe
     (raster_cull_probe: every rejected (tile, row) pair tested at every
     pixel) counting 0 covered pixels and rejecting what the plain form
     rejects.
 13. the rasterizer serving: rasterize at the CLI defaults (500^2 parity,
     plain torch, no kernel) against the port's copy of the rasterizer
     oracle (u8 within 1 everywhere, >= 99.99% exact, focal distances
     within 1e-5); the ``rasterize`` CLI in clean mode (exactly 1 K8b) and
     with ``--stl`` (exactly 1 K8c), each writing a BMP; parity with
     ``--stl`` refusing the mesh (ROADMAP fault F8); an 8-frame animate
     key script with the clean rasterizer (one K8b a frame and one for the
     warm render; every frame written as a BMP); the view
     server with the rasterizer, each request with its launches (its key
     0 is phase 17's).
 14. the raster train step: 3 SGD steps of the bench's step (512^2 clean,
     Cornell padded to 32, the rasteriser camera, MSE to a fixed target,
     every float leaf of scene and lights): exactly one K8b a step and no
     other kernel, finite gradients; then card numbers: the clean frame
     and step, the 500^2 parity frame, the 500^2 clean STL frame, K8b and
     K8c alone beside their plain versions and bounds, the device-busy
     share and event count of a step and its peak memory.
 15. the soft raster forward kernels (K9a, K9b) against their plain
     versions on the card: the bench's soft_rasterize frame (512^2,
     Cornell padded to 32, the rasteriser camera, sharpness 40 / 40), the
     fit's frame (500^2, 30 triangles, the fit CLI's camera, 10 / 20) and
     the bench's soft_stl frame (the 9,028-triangle mesh padded to 9,216 at
     512^2, culled) with its keep-mask and with an all-ones mask. agg, m and
     s within rtol 1e-5 / atol 1e-6, the all-ones mask bit-identical to
     K9a, two calls identical; the keep rate. The kernels are held
     against the whole plain version. The dead-row skip: the plain version
     with each 8 x 4 pixel block's dead rows left out
     (kernels/soft_raster.py::soft_row_dead) against it bit for bit on
     every case (the mesh masked and brute), its counts, the card's probe (soft_row_dead_probe: every row
     called dead evaluated at every pixel of its block) at the floors of
     the saved max and at 0
     counting 0 rows of weight not 0 and calling dead what the plain form
     does, and the work items (soft_fwd_items).
 16. the soft raster backward kernels (K9c, K9d) on the same cases
     against the plain backward in float64 with the float32 branch
     decisions (kernels/soft_raster.py::Kinks), cotangents drawn from a
     numpy seed: within rtol 1e-4 / atol 1e-5 after scaling by the largest
     entry. Where the plain float32 version itself misses that rule (the
     mesh at 512^2: pixels within float32 rounding of an edge), within the
     rule of the plain float32 version and no farther from float64 than
     it; two calls identical; K9d with all ones equal to K9c.
 17. soft serving: the ``rasterize`` CLI in soft mode at its defaults
     (500^2 Cornell: exactly one K9a), with ``--stl`` at 512^2 (one K9b)
     and at 500^2 (one K9a over 283 chunks: the JAX package culls only
     where the image blocks into its 1,024-pixel tiles); the view server
     with the rasterizer, key 0 giving a soft frame (one K9a) and back
     (one K8b), the raytracer's key 0 a soft raytrace frame (one K10a and
     one K10g).
 18. training: the ``fit`` CLI at its defaults on
     results/fit_reference/target.bmp (500 steps in two stages at 500^2:
     exactly one K9a and one K9c a step, one K9a for the final frame, no
     other kernel; the logged loss finite and falling; fit.bmp written); a
     fit checkpointed after 10 steps and resumed for 10 ending bit for bit
     on the straight run's parameters; the bench's soft_rasterize step and
     its soft_stl step culled (K9b + K9d) and brute (K9a + K9c); then card
     numbers: the soft frames, the fit's ms a step, the steps' device-busy
     share, events and peak memory, K9a-K9d alone beside their plain
     versions and bounds.
 19. the soft raytrace forward kernels (K10a, the primary softmax; K10g,
     the shadow's optical depth) against their plain versions on the card,
     cull=False: the bench's soft_raytrace frame (512^2, Cornell padded to
     32, the raytracer camera, sharpness 40 / 40), the fit CLI's frame
     (500^2, 30 triangles, 10 / 20), the bench's full-feature sources (2
     lights x 16 samples, S = 32) and the brute soft_raytrace_stl frame
     (the mesh padded to 9,216 at 512^2, the rasteriser camera). out, m, s
     and trans within rtol 1e-5 / atol 1e-6, two calls identical.
 20. the soft raytrace backward kernels (K10c, K10i) on the same cases
     against the plain backward in float64 with the float32 branch
     decisions (Kinks) and against the plain float32 version, cotangents
     of one sign from a numpy seed: rtol 1e-4 / atol 1e-5 after scaling
     each column group (kernels/soft_raytrace.py::PRI_GROUPS, SHW_GROUPS)
     and each of d camera, d dirs, d sources, d world by its own largest
     entry, with phase 16's rule where the float32 version itself misses
     float64 (F11); two calls identical.
 21. soft raytrace serving: the ``render`` CLI in soft mode at its
     defaults (500^2 Cornell: one K10a and one K10g), with 16 soft-shadow
     samples and a second light (one K10g over 32 sources), with ``--stl``
     (one K10a over 283 chunks: unculled at 500^2) and at 512^2 (culled:
     one K10b and one K10h); the view server with the raytracer at the
     view CLI's defaults, key 0 giving a soft frame (one K10a, one K10g)
     and back (one K1).
 22. training through the soft raytracer: the ``fit`` CLI with
     ``--renderer raytrace`` at its other defaults (500 steps at 500^2:
     exactly one K10a, K10c, K10g and K10i a step, one K9a for the final
     frame, no other kernel; the logged loss finite and falling in each
     stage); the bench's soft_raytrace step and its brute soft_raytrace_stl
     step (one of each K10 kernel a step); then card numbers: the soft
     raytrace frames and steps, the fit's ms a step, the steps' device-busy
     share, events and peak memory, K10a-K10i alone on each case beside
     their plain versions and bounds.
 23. the multi-chunk intersection kernels (K5, the brute closest hit; K7d,
     K5 with a (ray tile, chunk) keep-mask; K7a, the closest hit and the
     shadow sweeps of S sources with a (ray tile, (1 + S) chunks) mask)
     against their plain versions on the card: K5 and K7d at the bench's
     stl_intersect shapes (512^2, the 9,028-triangle mesh padded to 9,216,
     the rasteriser camera), K7a on the render --stl frame (500^2, 9,028
     triangles, the CLI's STL camera) at an AA sub-ray offset with one
     light (S = 1) and with the full-feature sources (S = 32). t, idx and
     occ bit-identical to the plain versions, culled = brute (K7d = K5; K7a
     = K7a with an all-ones mask, its hits = K5's), two calls identical,
     the keep rates printed; the VJP of t at T = 9,028 within rtol 1e-4 /
     atol 1e-5 of its float64 evaluation, two backward calls identical.
 24. STL serving: the ``render`` CLI with ``--stl`` at its defaults (500^2
     parity: exactly one K7a, no other kernel), ``--mode clean`` (one),
     ``--aa 3`` (nine), and ``--aa 3 --soft-shadows 16 --add-light ...
     --dof`` (nine, each at S = 32); the 800-triangle mesh at 96^2 parity
     with two lights and 4 soft-shadow samples (one K7a) against the
     port's numpy oracle, at tests/test_raytrace_parity.py's tolerances.
 25. the bench's stl_intersect row through the port (brute: one K5 a
     call; culled: one K7d a call; timed with CUDA events), 3 SGD steps of
     the MSE of the 512^2 clean STL frame (9,028 triangles, the render
     --stl camera, one light in front of the mesh) to a fixed target over
     every float leaf (exactly one K7a a step, no other kernel, finite
     gradients), then card numbers: the STL frames and step, the step's
     device-busy share, events and peak memory, K5, K7d and K7a alone
     beside their plain versions and bounds.
 26. the masked soft raytrace kernels (K10b, K10h forward; K10d, K10j
     backward) against their plain versions on the card: the bench's
     culled soft_raytrace_stl step (the mesh padded to 9,216 at 512^2, the
     rasteriser camera, 40 / 40, cull=True) and the ``render --mode soft
     --stl`` 512^2 frame (9,028 triangles, the CLI's STL camera, S = 1 and
     ``--soft-shadows 16``), each with its keep-masks on the port's 16 x
     16 tiles: out, m, s and trans within rtol 1e-5 / atol 1e-6, two calls
     identical, all-ones masks = K10a / K10g bit for bit, culled = brute at
     JAX's rule (atol 1e-6 / rtol 1e-6), the keep rates printed; at the
     step's shapes K10d and K10j against the plain masked backward in
     float64 by column group with phase 20's rule, culled = brute at that
     rule (or, where float32 misses it, F11, within twice the plain
     float32 version's distance from float64), all-ones masks on 256-ray
     runs = K10c / K10i bit for bit, two calls identical.
 27. culled soft raytrace serving: ``render --mode soft --stl`` at 512^2
     (one K10b and one K10h over 283 chunks and one source) and with
     ``--soft-shadows 16`` (16 sources); the view server on the STL scene
     at 512^2, key 0 giving a culled soft frame (one K10b, one K10h) and
     back (one K7a).
 28. the bench's culled soft_raytrace_stl step: 2 SGD steps (exactly one
     K10b, K10d, K10h and K10j a step, no unmasked K10), then card
     numbers: the culled step beside phase 22's brute step, its device-busy
     share, events and peak memory, the culled frames, K10b-K10j alone
     beside their plain versions (one call each) and bounds (kept pairs
     and triples only).
 29. the sharded renderer's kernels against their plain versions on the
     card: K7b (occlusion of known points) on the 512^2 Cornell frame's
     hit points toward the full-feature sources (S = 32) and toward its
     one light (S = 1); K7c (K7b with kernels/intersect.py::position_mask)
     on the bench's stl_intersect frame's hit points (the mesh padded to
     9,216, 512^2, the rasteriser camera) at S = 1 and S = 16, = K7b; K8a
     (the multi-chunk winner without a mask) on the rasterize CLI's STL
     frame at 512^2 (9,028 triangles), the whole frame and its lower half
     (y0 = 256), = K8c. Bits equal, two calls identical, exact launch
     counts; for each K7b/K7c case the work the plain forms count
     (occlusion_work: tests to the first blocker, those the exact reject
     decides, none of them blocking, misses included; the miss points'
     share, the items and runs planned); K8a's cull: its plain form's
     counts and the card's probe at y0 = 0 and 256 (0 covered pixels).
 30. sharded serving on a 1 x 1 NCCL mesh (init_distributed at world size
     1, make_mesh(1, 1)), each frame against its single-card frame:
     make_sharded_render at 512^2 clean Cornell, at full feature (AA 3,
     16 soft samples, two lights, DoF through dof_block) and on the mesh
     (K7d + K7c); make_sharded_rasterize on Cornell (K8b) and on the mesh
     (K8a); make_sharded_soft_render at 512^2, 40 / 40, both renderers.
     Hard frames within atol 1e-6, soft within atol 1e-6 / rtol 1e-5;
     exact launches; ms a frame beside the single-card frame's; the
     full-feature and STL frames under the profiler.
 31. the sharded train step on 1 x 1 (hard clean 512^2 against the
     single-card loop branch, both soft renderers against their frames):
     loss and every gradient within rtol 1e-4 / atol 1e-5 (soft leaves
     scaled by their largest entry), one launch of each kernel a step;
     step ms beside the single-card step's, busy share, events, peak
     memory; fit(mesh=1x1) against fit (rtol 1e-4) and ``fit --mesh 1x1``
     (the CLI, which then shuts the process group down); then K7b, K7c and
     K8a alone beside their plain versions and bounds.
 32. the two-launch soft raytrace backwards (K10e and K10f, the primary's
     tables and rays halves, above 32,768 triangles; K10k and K10l, the
     shadow's, above 65,536) on the procedural torus at 256 x 130 quads
     (66,560 triangles, 2,080 chunks): the four kernels at 128^2 (the
     route depends on the table's size alone) against the plain backward
     in float64 by column group with phase 20's rule, or where the plain
     float32 version misses float64 (F11) within twice its distance, two
     calls identical, d dirs and d world equal to the fused K10c's and
     K10i's bit for bit; the culled 512^2 soft raytrace step on that torus
     (exactly one K10b, K10h, K10e, K10f, K10k and K10l) and on the 200 x
     90 one (36,000 triangles: K10e and K10f beside the masked K10j),
     ``fit(renderer="raytrace")`` for 2 steps, the sharded step on a new
     1 x 1 NCCL mesh against the single-card step; then card numbers at
     512^2: the four kernels beside the fused K10c and K10i on the same
     inputs (56 and 72 blocks under their partials' cap) and the first
     design's K10e and K10f, K10f with a warp on 8 x 4 pixels (the same d
     dirs), the plain backward of each pass once (~15 s apiece), the four
     kernels held to it by column group with phase 20's rule, the pairs
     gated, proved dead by K10e's and K10f's early-out and of weight not
     0, bounds, both steps, their device-busy shares and peak memory.
 33. the megakernel labs' kernels against their plain versions on the card
     (raytpu_torch/kernels/labs.py, csrc/labs.cu): K1r (the forward in the
     (1, tile) row layout), L6 (the (8, tile/8) blocked layout, unblocked)
     and the four L5 variants (gather and shading on or off) at 512^2 clean
     (Cornell padded to 32, tile 2048) and 500^2 parity (30 triangles, tile
     2000: 125 whole tiles, 250 columns a sublane for L6). color, fd, idx
     and occ bit for bit (0 mismatches, max error 0.0), K1r equal to K1 on
     all four outputs, two calls identical, exact launches, and ROADMAP
     fault F23's ValueError for a ray count that is not a whole number of
     tiles; then each kernel alone at 512^2 clean beside K1, its plain
     version and its bound.
 34. the labs as a user runs them, each in a subprocess that must exit 0:
     ``python -m raytpu_torch.labs.megakernel_lab6 --check-only`` (A, B and
     K1 agree entry for entry), then lab 6 (A = K1r, B = L6, C =
     raytrace_full at its default config, which runs K1: F21) and lab 4
     (two-phase K4 and the four L5 variants) in full at 512^2; their JSON
     lines are parsed and their tables printed beside the card line. Each
     lab process starts with its counts at 0 and prints its launches.

 35. lab 1's, lab 2's and lab 3's kernels against their plain versions
     on the card (raytpu_torch/kernels/labs.py, csrc/kernel_lab.cu,
     csrc/intersect.cu for L2, csrc/labs.cu), at 512^2 clean (the raytracer's default camera): L1 on
     the Cornell box padded to 32 and on 9,216 random triangles
     (labs/common.py::random_scene, seed 1), every chunk mode, dot and
     divide at tile 2048 and (tight, recip) also at 4096 and 8192; its vpu
     instances bit for bit and (vpu, recip) equal to K5, its mxu (tensor
     core, 3xTF32) instances within labs.mxu_rule (t within the 3xTF32
     bound of the winner, idx equal except near-ties and near-edges,
     counted and printed); L2 equal to its plain version and to K4 on t,
     idx and occ of every ray, L3 (t = the rays' x, idx = occ = 0) and L4
     (2 x) exact, at the Cornell box padded to 32, 64 and 128; two calls
     identical, exact launches, the tile and F23 ValueErrors and L2's and
     L3's refusal of a table of more than one chunk; then each kernel alone
     (held stream) beside K5 or K4 on the same inputs, its plain version,
     its bound (mxu: its padded MACs at the TF32 peak plus the rest at the
     float32 peak) and, for L4, ``x * 2``.
 36. the labs as a user runs them, each in a subprocess that must exit 0:
     ``python -m raytpu_torch.labs.kernel_lab`` (K5 and L1's 24 variants
     a scene, each row's mismatches against K5: (vpu, recip) must be 0),
     ``megakernel_lab2`` (K5, K4, L3 and L2 at pads 32 / 64 / 128, eager
     and CUDA-graph chains; L2 = K4, L3 exact) and ``megakernel_lab3``
     (a scalar op, L4 and K4 in chains of 5 / 20 / 80, eager and graph,
     with lab 3's line through them); their tables are printed beside the
     card line. Each lab process starts with its counts at 0 and prints
     its launches (graph replays counted as the calls they run).

Launch counts are zeroed just before each path and read just after it:
before phase 4 and after phase 5 (serving: K1), before and after the 20
steps of phase 8 (training: K1, K2, K3), before and after phase 10
(serving the loop branch: K1, K4, K6), before and after the 3 steps of
phase 11 (training the loop branch: K6), before and after phase 13
(serving the rasterizer: K8b, K8c), before and after the 3 steps of
phase 14 (training the rasterizer: K8b), before and after phase 17
(serving the soft rasterizer: K9a, K9b, K8b, and the raytracer's key 0:
K10a, K10g), before and after the fit CLI of phase 18 (training: K9a, K9c),
before and after phase 21 (serving the soft raytracer: K10a, K10g, K10b,
K10h, K1),
before and after the raytrace fit CLI of phase 22 (training: K10a, K10c,
K10g, K10i), before and after phase 24 (serving STL scenes: K7a), before
and after each call of phase 25's stl_intersect row (K5, K7d) and its 3
STL steps (K7a), before and after phase 27 (serving the culled soft
raytracer: K10b, K10h, K7a), before and after phase 28's 2 culled steps
(K10b, K10d, K10h, K10j), before and after phase 30's sharded frames (K5,
K7b, K7d, K7c, K8b, K8a, K9a, K10a, K10g), before and after each
sharded step and the sharded fit of phase 31, and before and after each
of phase 32's two steps, its fit and its sharded step (K10b, K10h,
K10e, K10f, K10k, K10l, K10j, K10a, K10g), and in each lab process of
phase 34 from its start to its JSON line (K1r, L6, L5, K1, K4), and in each
lab process of phase 36 likewise (L1, K5, L2, L3, K4, L4). Comparisons and timings
launch outside those windows. The
line before the last is one JSON object describing each kernel; the last
line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Details (result.json and the BMPs) go to build/chip_smoke/.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import shutil
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"
# Image tolerances of tests/test_raytrace_parity.py::_assert_images_match.
F32_ATOL, F32_RTOL, U8_FRAC, FLIP_FRAC = 2e-4, 1e-3, 0.999, 0.999
# test_aa_parity's u8 fraction for AA frames.
AA_U8_FRAC = 0.995
# ROADMAP's gradient rule.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
# The H100 SXM's published peaks at its 700 W limit: device memory
# bytes/s and float32 operations/s outside the tensor cores. A kernel's bound is the larger of its bytes and its
# operations over these.
PEAK_BYTES_S, PEAK_F32_S = 3.35e12, 67e12
# Float operations the kernels do, counted from their sources (a divide or
# a square root counts as one; compares and selects not at all): a plane
# test (render_fused.cu::plane_test), the forward's shading of a hit ray,
# and the backward's recompute, derivative and block sums of a hit ray
# (render_fused_bwd.cu).
FLOPS_PLANE_TEST, FLOPS_FWD_SHADE, FLOPS_BWD_HIT = 20, 50, 180
# The any-hit reject of K6 and K7a (csrc/intersect.cu::shadow_reject):
# FLOPS_DOTS for the dot products, the products |D| kRejectT and
# |D| kRejectUV and the sum U + V; its 8 comparisons count not at all, as
# above, so a test it decides costs less than the plane test's 20.
FLOPS_REJECT = 15 + 3  # FLOPS_DOTS + 3
# The closest-hit sweeps' cull (csrc/intersect.cu::box_reject):
# a (box, triangle) decision forms Dn, U and V at two corners of the box
# (30) and one sum and one product; their comparisons count not at all. A
# warp's survivor then costs each of its rays the reject without its t <
# 0.99 clause (primary_reject: the 15 of the dot products, a sum, a
# product) and, where that leaves the test open, a plane test besides.
FLOPS_PRIMARY_CULL = 30 + 2
FLOPS_PRIMARY_REJECT = 15 + 2
# K4's, L2's and K1's shadow sweep decides its warp's box with the t >=
# 0.99 clause besides (box_reject<true>: one more product).
FLOPS_SHADOW_CULL = FLOPS_PRIMARY_CULL + 1
# The raster kernels' pixel-triangle test (raster.cu::sweep): four planes
# of two multiplies and two adds.
FLOPS_RASTER_TEST = 16
# K8a's and K8c's per-tile row cull (raster.cu::tile_reject), a (tile, row)
# pair they walk: each of the four planes at one corner, two multiplies and
# two adds (its comparisons and selects count not at all, as above).
FLOPS_RASTER_CULL = 16
# The soft raster kernels' float operations a (pixel, row) pair, counted
# from raytpu_torch/csrc/soft_raster.cu for a pixel outside the triangle
# (the three segment distances and one square root; most pairs), a divide,
# square root, exp, log1p, min or max counting as one. Forward: the logit
# (123: edges 21, half planes 5, segments 64, barycentrics 22,
# log_sigmoid and sum 10, the max 1), then the barycentrics, the weight
# and the 10 sums (74). Backward: the recompute (160) and the derivative
# through one segment distance (218).
FLOPS_SOFT_FWD, FLOPS_SOFT_BWD = 197, 378
# K9c's and K9d's dead test since their redesign (soft_raster.cu::
# soft_dist, soft_pair_dead), counted as above with its comparison: the
# edges (21), half planes (5) and segment distances (64) of the forward's
# logit, xs = es sd (1), its cap (1), B's two adds, B - m and the
# comparison (4): 96 a pair. A live pair goes on from soft_dist's floats
# (pair_bwd): FLOPS_SOFT_BWD without the edges, half planes, segment
# distances and xs that its recompute held, 287 more.
FLOPS_SOFT_DEAD = 21 + 5 + 64 + 1 + 1 + 4
FLOPS_SOFT_BWD_REST = FLOPS_SOFT_BWD - (21 + 5 + 64 + 1)
# K9a's and K9b's dead-row test since their redesign (soft_raster.cu::
# soft_row_bound), a (8 x 4 pixel block, row) pair they walk, counted as
# above: the tame check (32), zb (9), the three edges at their corners
# (30), the distance bound of an outside row (43: the coordinates'
# magnitude 15, the box 8, the gaps 14, the distance 5, cap 1), B, its log
# and B - floor (4). A live pair then pays FLOPS_SOFT_FWD.
FLOPS_SOFT_ROW_DEAD = 32 + 9 + 30 + 43 + 4
# Column groups of the soft kernels' (Tp, 32) table
# (kernels/soft_raster.py::soft_tri_constants), each of one kind and size:
# the gradient of 1 / area is 1e2-1e6 times the vertices', so a rule scaled
# by the whole table's largest entry would not see the others.
SOFT_GROUPS = (("vertices", 0, 9), ("inv_area", 9, 10), ("zinv", 10, 13),
               ("attributes", 13, 28), ("valid", 28, 29))
# The soft raytrace kernels' float operations, counted from
# raytpu_torch/csrc/soft_raytrace.cu as FLOPS_SOFT_* are, a comparison
# counting as one too. Every pair or triple pays its gate (primary 12: the
# denominator's dot product, its guard, 1 / denom, t and the hit test;
# shadow 11, the hit test without |d|); a gated one (behind the camera or
# the source, or near-parallel) needs nothing more. K10a: an ungated (ray,
# row) pair's logit (40, the gate included) and, where its weight is not 0,
# the weight and the 9 sums (27). K10c: an ungated pair's recompute up to
# its weight (41) and, where that is not 0, the derivative (128) and its
# share of the row's 18 sums over rays (18). The shadow's backward: only
# the triples of a (source, point) whose cotangent d od is not 0; of those,
# an ungated one's recompute (38) and, where its term is not 0, the
# derivative (128) and its 14 sums. A pair of weight 0 (underflowed) needs
# nothing past its recompute: its every contribution is 0. K10g-K10j as
# redesigned: below.
FLOPS_SRT_PRI_GATE, FLOPS_SRT_SHW_GATE = 12, 11
FLOPS_SRT_PRI_LOGIT, FLOPS_SRT_PRI_SUMS = 40, 27
FLOPS_SRT_PRI_W, FLOPS_SRT_PRI_BWD = 41, 146
FLOPS_SRT_SHW_W, FLOPS_SRT_SHW_BWD = 38, 142
# The derivative's 128 operations by what needs them, counted from
# pri_pair_bwd and shw_pair_bwd as above. Only the table's gradient (and the
# camera's) needs the primary's 40: the albedo and normal rows (12), the
# camera (3), the active row (3), the dmin row (2), the t row (2) and the
# three plane rows (18); only the ray's needs its 26: the direction through
# pos (6), |d| (2) and the planes (18). Only the table's gradient needs the
# shadow's 42: the active row (2), n (9), n . v0 (1), the edges' two cross
# products (18) and the adds into the v0, edge and n rows (12); only the
# point's and the source's need its 29: the ray's length (2), unit
# direction (18) and the source (9). The chain both halves need is the
# rest. The two-launch halves each drop the other half's terms.
FLOPS_SRT_PRI_TABLE, FLOPS_SRT_PRI_DIRS = 40, 26
FLOPS_SRT_SHW_TABLE, FLOPS_SRT_SHW_RAYS = 42, 29
FLOPS_SRT_PRI_CHAIN = (FLOPS_SRT_PRI_BWD - 18 - FLOPS_SRT_PRI_TABLE
                       - FLOPS_SRT_PRI_DIRS)
FLOPS_SRT_SHW_CHAIN = (FLOPS_SRT_SHW_BWD - 14 - FLOPS_SRT_SHW_TABLE
                       - FLOPS_SRT_SHW_RAYS)
# K10e and K10f (and, since their redesign, the fused K10c and K10d, and
# the forwards K10a and K10b against their running max) stop a pair that
# pri_pair_dead proves of weight 0 at its test
# (csrc/soft_raytrace.cu): the gate (12) and then u and v's dot products
# (10) and products (2), 1 - u - v (2), the margin's two minima (2), es
# margin (1), min(xs, 0) (1), B's two adds (2), B - m (1) and the
# comparison (1): 34, against FLOPS_SRT_PRI_W's 41 for the pairs it does
# not prove dead.
FLOPS_SRT_PRI_DEAD = FLOPS_SRT_PRI_GATE + 22
# K10k and K10l take 1e-3 |n| once a row and 0.99 rr once a point for each
# source (stage_shw_row, pack_shw_points_kernel, the test's staged point),
# so a triple there does without those two products: its gate is 10, and
# a triple shw_triple_dead finds dead stops at its test, the gate (10) and
# then u and v's dot products (10) and products (2), 1 - u - v (2), the
# margin's two minima (2), es margin (1), y = zs (0.99 rr - t) (2) and the
# two comparisons (2): 31, against the 36 of FLOPS_SRT_SHW_W without the
# two products for the triples it does not find dead. Since their redesign
# the fused K10g-K10j stage their rows and points the same way and count
# the same (srt_bounds): K10i and K10j stop a triple shw_dead finds dead at
# that test (FLOPS_SRT_SHW_DEAD) and go on from it for the others; K10g's
# and K10h's test (shw_term_dead) adds four comparisons to it (the active
# column finite; 1 - u - v, xs and y not NaN), 35, and a triple it does not
# skip adds the term's two sigmoids (4 each), its two products and its add
# into the chunk's sum, 11 more: 46 (the first design's count was 40 a
# triple the gate passes).
FLOPS_SRT_SHW_STAGED_GATE = FLOPS_SRT_SHW_GATE - 1
FLOPS_SRT_SHW_STAGED_W = FLOPS_SRT_SHW_W - 2
FLOPS_SRT_SHW_DEAD = FLOPS_SRT_SHW_STAGED_GATE + 21
FLOPS_SRT_SHW_FWD_DEAD = FLOPS_SRT_SHW_DEAD + 4
FLOPS_SRT_SHW_FWD_LIVE = FLOPS_SRT_SHW_FWD_DEAD + 11
# Image rule of tests/test_rasterize_parity.py::test_parity_vs_oracle_500.
RASTER_EXACT_FRAC, RASTER_FD_ATOL = 0.9999, 1e-5
# Cycles of torch.cuda._sleep that hold the stream while timed calls are
# enqueued (about 100 ms at the H100's clocks). The calls held must also
# stay within the stream's queue of about a thousand launches.
HOLD_CYCLES = 200_000_000


T0 = time.perf_counter()


def say(msg: str) -> None:
    if msg.startswith("== phase"):
        msg += f" [{time.perf_counter() - T0:.1f} s]"
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


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


def held_ms(fn, n: int) -> float:
    """Device time of ``n`` calls of fn, per call, in ms. A device-side
    sleep holds the stream while the calls are enqueued, so the events time
    the device's work back to back and not the host's dispatch."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    end.record()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    require(enqueue_ms < 0.5 * HOLD_CYCLES / 2e6,
            f"{n} calls enqueued within the hold ({enqueue_ms:.1f} ms)")
    return start.elapsed_time(end) / n


def median_ms_in_turns(fns: dict, n: int, reps: int, timer=cuda_ms) -> dict:
    """Median over ``reps`` of timer(fn, n) for each fn, alternating the
    order (a, b, b, a, ...) so that drift hits both alike."""
    names = list(fns)
    for name in names:  # warm up
        cuda_ms(fns[name], 3)
    times = {name: [] for name in names}
    for rep in range(reps):
        for name in (names if rep % 2 == 0 else names[::-1]):
            times[name].append(timer(fns[name], n))
    return {name: statistics.median(ts) for name, ts in times.items()}


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take for work that moves ``nbytes``
    and does ``flops`` float32 operations, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, flops / PEAK_F32_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tests_to_first_blocker(delta, m, k0) -> torch.Tensor:
    """Plane tests a shadow sweep makes along each ray of ``delta``: the
    triangles in order up to the first blocker (t < 0.99), or all C."""
    from raytpu_torch.ops.intersect import plane_tests
    from raytpu_torch.ops.shade import SHADOW_T
    ts, oks = plane_tests(delta, m, k0)
    blocked = oks & (ts < SHADOW_T)
    first = blocked.float().argmax(dim=1) + 1  # the first True, 1-based
    return torch.where(blocked.any(dim=1), first, m.shape[0])


def shadow_tests(dirs, table, params) -> int:
    """Plane tests K1's shadow sweep makes on these rays (misses sweep
    too, from the camera position)."""
    from raytpu_torch.kernels.render_fused import _constants
    from raytpu_torch.kernels.tables import PRIMARY, SHADOW
    from raytpu_torch.ops.intersect import F32MAX, closest, plane_tests
    best_t, _ = closest(*plane_tests(dirs, *_constants(table, PRIMARY)))
    tz = torch.where(best_t < F32MAX, best_t, 0.0)
    delta = (params[0:3] + tz[:, None] * dirs) - params[3:6]
    return int(tests_to_first_blocker(delta, *_constants(table, SHADOW)).sum())


def bwd_args(args, kw, seed: int):
    """The backward's inputs for a frame's fused_inputs: dirs, table, params,
    the forward's idx and occ, and cotangents drawn with numpy from seed."""
    from raytpu_torch.kernels import render_fused
    table, params = render_fused.pack_inputs(*args[1:], kw["tri_chunk"])
    dirs = args[0]
    out = render_fused.fused_fwd_reference(dirs, table, params,
                                           ambient=kw["ambient"],
                                           parity=kw["parity"])
    # Of one sign, as the gradient of an MSE where the render is brighter
    # than its target everywhere: signed cotangents cancel in the sums
    # until float32 rounding decides the small ones.
    rng = np.random.default_rng(seed)
    R = dirs.shape[0]
    g_color = rng.uniform(0.5, 1.5, (R, 3)).astype(np.float32)
    g_fd = rng.uniform(0.5, 1.5, R).astype(np.float32)
    return ((dirs, table, params, out.idx, out.occ,
             torch.tensor(g_color, device=dirs.device),
             torch.tensor(g_fd, device=dirs.device)),
            dict(ambient=kw["ambient"], parity=kw["parity"]))


def bench_frame(dev, size: int):
    """bench.py's train-step frame: the size^2 clean render of the Cornell
    box (padded to 32), one light of capacity 1."""
    from raytpu_torch import Camera, Lights, RenderConfig, cornell_box
    return (cornell_box(pad_to=32, device=dev),
            Camera.raytracer_default(device=dev),
            Lights.single(capacity=1, device=dev),
            RenderConfig(width=size, height=size, mode="clean"))


def full_feature_lights(dev, samples: int = 16):
    """bench.py's full-feature light bank (`bench.py:584-586`): two lights
    with 16 jittered positions each (or ``samples``), the second's jitter
    from seed 1."""
    from raytpu_torch import Lights
    return Lights.single(capacity=2, soft_samples=samples, device=dev).add(
        (0.4, -0.5, -0.7), (1.0, 1.0, 1.0), 7.0,
        generator=torch.Generator().manual_seed(1))


def full_feature_frame(dev, size: int):
    """bench.py's full-feature frame (`bench.py:582-589`): size^2 clean,
    AA 3x3, 16 soft-shadow samples, two lights, DoF, the Cornell box
    padded to 32."""
    from raytpu_torch import Camera, RenderConfig, cornell_box
    return (cornell_box(pad_to=32, device=dev),
            Camera.raytracer_default(device=dev), full_feature_lights(dev),
            RenderConfig(width=size, height=size, mode="clean", aa_samples=3,
                         soft_shadow_samples=16, dof_enabled=True))


def train_step(scene, camera, lights, cfg, lr: float, target_scale=1.0,
               render=None):
    """bench.py's train step in the port: the MSE of the render (raytrace,
    or ``render``) to the render of the starting parameters (times
    ``target_scale``; bench.py takes 1, where every gradient starts at 0),
    and one SGD step over every float leaf of scene and lights. Returns a
    function that takes one step and returns its loss."""
    if render is None:
        from raytpu_torch.render.raytrace import raytrace as render
    with torch.no_grad():
        target = render(scene, camera, lights, cfg) * target_scale
    opt = torch.optim.SGD([t.requires_grad_(True) for value in (scene, lights)
                           for t in vars(value).values()], lr=lr)

    def step():
        opt.zero_grad()
        loss = torch.mean((render(scene, camera, lights, cfg) - target)
                          ** 2)
        loss.backward()
        opt.step()
        return loss.detach()

    return step


def fit_albedo(dev, size: int, lr: float, steps: int) -> list[float]:
    """SGD on the albedo alone, from albedo + 0.1 toward the render of the
    true scene (size^2 clean); the loss of every step."""
    from raytpu_torch import Camera, Lights, RenderConfig, cornell_box
    from raytpu_torch.render.raytrace import raytrace
    scene = cornell_box(pad_to=32, device=dev)
    camera = Camera.raytracer_default(device=dev)
    lights = Lights.single(capacity=1, device=dev)
    cfg = RenderConfig(width=size, height=size, mode="clean")
    with torch.no_grad():
        target = raytrace(scene, camera, lights, cfg)
    color = (scene.color + 0.1).requires_grad_(True)
    fit = dataclasses.replace(scene, color=color)
    opt = torch.optim.SGD([color], lr=lr)
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = torch.mean((raytrace(fit, camera, lights, cfg) - target) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses


def device_busy(step, steps: int) -> dict:
    """torch.profiler over ``steps`` calls of step: the device's busy time
    (kernels, copies and sets) and the host clock's time a step, their
    ratio, the device events a step and the busy time a step by name."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name, count = {}, 0
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            ms = event.time_range.elapsed_us() / 1e3 / steps
            by_name[event.name] = by_name.get(event.name, 0.0) + ms
            count += 1
    busy_ms = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    # No device events means the profiler did not trace the card: the
    # share is then not measured, not zero.
    return dict(busy_ms=busy_ms, wall_ms=wall_ms,
                share=busy_ms / wall_ms if count else None,
                kernels=count / steps,
                by_name=[(name[:120], ms) for name, ms in ranked])


def sweep_case(dev, size: int, mode: str, pad_to, lights, samples: int,
               offset: tuple[float, float]) -> dict:
    """The intersection kernels' inputs for one sub-ray of a frame: the
    rays at sub-pixel ``offset``, the camera's and the shadow sources'
    constants (sources light-major, sample-minor, as raytrace_full makes
    them) and the packed table."""
    from raytpu_torch import Camera, RenderConfig, cornell_box
    from raytpu_torch.kernels.intersect import occluded_table
    from raytpu_torch.ops.intersect import tri_constants
    from raytpu_torch.ops.shade import source_positions
    from raytpu_torch.core.types import pixel_grid
    from raytpu_torch.render.raytrace import camera_ray_dirs
    scene = cornell_box(pad_to=pad_to, device=dev)
    camera = Camera.raytracer_default(device=dev)
    cfg = RenderConfig(width=size, height=size, mode=mode)
    xs, ys = pixel_grid(size, size, dev)
    dirs = camera_ray_dirs(xs + offset[0], ys + offset[1], camera, cfg)
    consts = tri_constants(scene, camera.pos)
    src = source_positions(lights, samples)
    consts_src = tri_constants(scene, src)
    table = occluded_table(consts.m, consts.k0, consts.valid, consts_src.m,
                           consts_src.k0, cfg.tri_chunk)
    return dict(dirs=dirs, m=consts.m, k0=consts.k0, valid=consts.valid,
                m_s=consts_src.m, k0_s=consts_src.k0, cam=camera.pos, src=src,
                table=table, tri_chunk=cfg.tri_chunk, image_hw=(size, size))


def run_sweeps(case: dict, multi: bool, image_hw="case"):
    """The K4 (multi False, one source) or K6 wrapper on a sweep_case; occ
    is (S, R) either way. K4's warps over ``image_hw`` ("case": the case's
    image, as raytrace_full passes it; None: consecutive rays)."""
    from raytpu_torch.kernels import intersect as isect
    c = case
    if multi:
        return isect.closest_hit_occluded_multi(
            c["dirs"], c["m"], c["k0"], c["valid"], c["m_s"], c["k0_s"],
            c["cam"], c["src"], tri_chunk=c["tri_chunk"])
    t, idx, occ = isect.closest_hit_occluded(
        c["dirs"], c["m"], c["k0"], c["valid"], c["m_s"][0], c["k0_s"][0],
        c["cam"], c["src"][0], tri_chunk=c["tri_chunk"],
        image_hw=c["image_hw"] if image_hw == "case" else image_hw)
    return t, idx, occ[None]


def sweep_work(case: dict, multi: bool) -> dict:
    """Plane tests the intersection kernels make on a sweep_case: C a ray
    in the primary sweep (``primary``), and each source's shadow sweep of
    each hit ray to its first blocker (``shadow``; K6's misses skip theirs,
    K4 sweeps a miss from the camera, F25). Of K6's shadow tests,
    ``rejected`` counts those its exact reject decides (the plain form,
    kernels/intersect.py::shadow_reject) and ``reject_wrong`` every test of
    a hit ray it rejects that plane_tests calls blocking (it must be 0);
    ``hit`` is the share of hit rays."""
    from raytpu_torch.kernels.intersect import (_block, shadow_reject,
                                                sweeps_reference)
    from raytpu_torch.ops.intersect import plane_tests
    from raytpu_torch.ops.shade import SHADOW_T
    dirs, table, src = case["dirs"], case["table"], case["src"]
    t, idx, _ = sweeps_reference(dirs, table, case["cam"], src)
    hit = idx >= 0
    pos = case["cam"][None, :] + torch.where(hit, t, 0.0)[:, None] * dirs
    C = table.shape[1]
    cols = torch.arange(C, device=dirs.device)[None, :]
    work = dict(primary=dirs.shape[0] * C, shadow=0, rejected=0,
                reject_wrong=0, hit=float(hit.float().mean()))
    for s in range(src.shape[0]):
        delta = pos - src[s][None, :]
        m, k0 = _block(table, 1 + s)
        tests = tests_to_first_blocker(delta, m, k0)
        if not multi:
            work["shadow"] += int(tests.sum())
            work["cull"] = sweep_cull_work(dirs, table, case["cam"], src[0],
                                           case.get("image_hw"))
            continue
        tests = torch.where(hit, tests, 0)
        work["shadow"] += int(tests.sum())
        ts, oks = plane_tests(delta[hit], m, k0)
        reject = shadow_reject(delta[hit], m, k0)
        work["rejected"] += int((reject & (cols < tests[hit][:, None])).sum())
        work["reject_wrong"] += int((reject & oks & (ts < SHADOW_T)).sum())
    return work


def sweep_cull_work(dirs, table, cam, light, image_hw=None) -> dict:
    """The work of K4's, L2's and K1's culled sweeps (csrc/sweep_cull.cuh)
    on one light, from the plain forms on these tensors
    (kernels/intersect.py::sweep_cull_decisions, sweep_keep; table's first
    two blocks, K1's 26-row table too), their warps over ``image_hw``:
    ``pri_decided`` the (warp, triangle) pairs the warps of a valid ray
    decide, ``pri_kept`` those that survive, ``pri_tests`` the (ray,
    survivor of its warp) tests, ``pri_open`` those the reject leaves open;
    the shadow sweep's ``shw_*`` likewise, its warp deciding a group of 32
    triangles while a lane sweeps (a lane sweeps group g where its first
    blocker is g or later) and a lane testing its survivors up to its first
    blocker; ``before`` the tests of the brute sweeps (every ray's C and
    its shadow tests to its first blocker), ``hits`` the hit rays."""
    from raytpu_torch.kernels import intersect as isect
    from raytpu_torch.ops.intersect import F32MAX, closest, plane_tests
    from raytpu_torch.ops.shade import SHADOW_T
    R, C = dirs.shape[0], table.shape[1]
    dec = isect.sweep_cull_decisions(dirs, table, cam, light, image_hw)
    rays, valid = isect.sweep_warps(R, image_hw, dirs.device)
    warp = isect.sweep_ray_warps(R, image_hw, dirs.device)
    live = valid.any(dim=1)
    pri, shw = isect.sweep_keep(dirs, table, cam, light, image_hw)
    e = isect.sweep_shadow_rays(dirs, table, cam, light)
    ts, oks = plane_tests(e, *isect._block(table, 1))
    blocks = oks & (ts < SHADOW_T)
    first = torch.where(blocks.any(dim=1),
                        blocks.float().argmax(dim=1), C)  # C: none
    cols = torch.arange(C, device=dirs.device)
    swept = cols[None, :] <= first[:, None]  # a lane's tests to its blocker
    # A warp decides group g (its triangles g .. g + 31) while a lane of it
    # sweeps: while some valid lane's first blocker is g or later.
    reach = torch.full((rays.shape[0],), -1, dtype=torch.long,
                       device=dirs.device)
    reach.scatter_reduce_(0, warp, first, "amax")
    decided = (cols[None, :] // 32 * 32 <= reach[:, None]) & live[:, None]
    pri_kept = ~dec[:, 0] & live[:, None]
    t, _ = closest(*plane_tests(dirs, *isect._block(table, 0)))
    return dict(
        pri_decided=int(live.sum()) * C, pri_kept=int(pri_kept.sum()),
        pri_tests=int(pri_kept.sum(dim=1)[warp].sum()),
        pri_open=int(pri.sum()),
        shw_decided=int(decided.sum()),
        shw_kept=int((decided & ~dec[:, 1]).sum()),
        shw_tests=int((~dec[warp, 1] & swept).sum()),
        shw_open=int((shw & swept).sum()),
        before=R * C + int(torch.where(first < C, first + 1, C).sum()),
        hits=int((t < F32MAX).sum()))


def sweep_cull_line(w: dict) -> str:
    return (f"the warps decide {w['pri_decided']} primary (warp, triangle) "
            f"pairs and keep {w['pri_kept']} "
            f"({w['pri_kept'] / max(1, w['pri_decided']):.4f}), "
            f"{w['shw_decided']} shadow pairs and keep {w['shw_kept']} "
            f"({w['shw_kept'] / max(1, w['shw_decided']):.4f}); ray tests "
            f"{w['pri_tests']} + {w['shw_tests']} of {w['before']} before "
            f"the cull ({(w['pri_tests'] + w['shw_tests']) / max(1, w['before']):.5f}), "
            f"{w['pri_open']} + {w['shw_open']} left open by the reject")


def sweep_cull_flops(w: dict) -> int:
    """The float operations of sweep_cull_work's counts: FLOPS_PRIMARY_CULL
    a primary and FLOPS_SHADOW_CULL a shadow (warp, triangle) decision,
    FLOPS_PRIMARY_REJECT a primary and FLOPS_REJECT a shadow ray test, a
    plane test's more where the reject leaves one open."""
    return (FLOPS_PRIMARY_CULL * w["pri_decided"]
            + FLOPS_SHADOW_CULL * w["shw_decided"]
            + FLOPS_PRIMARY_REJECT * w["pri_tests"]
            + FLOPS_REJECT * w["shw_tests"]
            + FLOPS_PLANE_TEST * (w["pri_open"] + w["shw_open"]))


def sweep_bound(case: dict, multi: bool, work: dict | None = None,
                reject: bool = True) -> tuple[float, str]:
    """K4's (multi False) or K6's bound on a sweep_case: 12 B in and
    8 + 4 S B out a ray, the table and positions once, and FLOPS_PLANE_TEST
    a test of sweep_work; since K6's redesign its shadow tests
    FLOPS_REJECT each and, where the reject does not decide, a plane test
    besides; since K4's, K4's culled sweeps' work on the warps of the
    case's ``image_hw`` (none: consecutive rays, L2's), sweep_cull_flops
    (``reject`` False: every test a plane test, the count before either
    redesign)."""
    R, S = case["dirs"].shape[0], case["src"].shape[0]
    w = work or sweep_work(case, multi)
    flops = FLOPS_PLANE_TEST * (w["primary"] + w["shadow"])
    if multi and reject:
        flops = (FLOPS_PLANE_TEST * (w["primary"] + w["shadow"]
                                     - w["rejected"])
                 + FLOPS_REJECT * w["shadow"])
    elif reject:
        flops = sweep_cull_flops(w["cull"])
    return bound_ms(R * (12 + 8 + 4 * S)
                    + (case["table"].numel() + 3 + 3 * S) * 4, flops)


def sweep_probe_check(dirs, table, cam, light, image_hw) -> dict:
    """K4's and K1's cull on the card (kernels/intersect.py::
    sweep_cull_probe: the kernels' own box_reject on their own warps)
    against its plain form on the same tensors (sweep_cull_decisions):
    every decision equal, the culled pairs counted alike, no culled pair
    with an ok ray (primary) or a blocking one (shadow)."""
    from raytpu_torch.kernels import intersect as isect
    dec, counts = isect.sweep_cull_probe(dirs, table, cam, light, image_hw)
    want = isect.sweep_cull_decisions(dirs, table, cam, light, image_hw)
    torch.cuda.synchronize()
    counts = [int(n) for n in counts]
    out = dict(same=bool(torch.equal(dec, want)), counts=counts,
               plain=[int(want[:, 0].sum()), int(want[:, 1].sum())],
               pairs=int(dec[:, 0].numel()))
    require(out["same"] and counts[:2] == out["plain"],
            "the card's cull decisions = their plain form")
    require(counts[2] == 0 and counts[3] == 0,
            "no culled pair holds an ok (primary) or blocking (shadow) ray")
    return out


def sweep_probe_line(p: dict) -> str:
    return (f"decisions = plain {p['same']}, culled {p['counts'][0]} "
            f"primary and {p['counts'][1]} shadow (warp, triangle) pairs of "
            f"{p['pairs']} each, ok rays culled {p['counts'][2]}, blocking "
            f"rays culled {p['counts'][3]}")


def k6_staging_ms(dev, sources=(64, 96, 128)) -> list[dict]:
    """K6 with its triangle-major copy staged in shared memory and read
    through the cache, in turns, at 512^2 on the Cornell box (C = 32) with
    S sources (full_feature_lights with S / 2 samples a light): 96, 144
    and 192 KB of copy, the largest kernels/intersect.py::k6_staged stages
    and two it reads through (the C side stages up to 200 KB): the
    readings behind K6_STAGED_MAX_BYTES. The two outputs agree bit for
    bit."""
    from raytpu_torch.kernels import intersect as isect
    rows = []
    for S in sources:
        case = sweep_case(dev, 512, "clean", 32,
                          full_feature_lights(dev, S // 2), S // 2,
                          (-0.5, -0.5))
        C = case["table"].shape[1]
        scratch = isect.k6_scratch(case["table"], case["src"])
        outs = {k: isect._outputs(case["dirs"], S) for k in (True, False)}

        def run(staged):
            return lambda: isect.launch_occluded_multi_kernel(
                case["dirs"], case["table"], case["cam"], case["src"],
                *outs[staged], scratch=scratch, staged=staged)

        ms = median_ms_in_turns({"staged": run(True), "read": run(False)},
                                n=5, reps=9, timer=held_ms)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(outs[True],
                                                      outs[False])),
                f"K6 staged and read through agree at S = {S}")
        rows.append(dict(S=S, C=C, copy_kb=48 * S * C / 1024,
                         wrapper_staged=isect.k6_staged(S, C), **ms))
    return rows


# The render CLI's STL camera (raytpu_torch/cli/main.py::_build_inputs,
# as the JAX CLI's): (0, -0.5, -5) at the raytracer's focal 250 and DoF
# focus 1.3.
STL_CAM, STL_FOCAL = (0.0, -0.5, -5.0), 250.0


def stl_camera(dev):
    from raytpu_torch import Camera
    return Camera.make(STL_CAM, focal=STL_FOCAL, dof_focus=1.3, device=dev)


def stl_case(dev, scene, camera, size: int, lights, samples: int,
             offset: tuple[float, float]) -> dict:
    """The multi-chunk kernels' inputs for one sub-ray of a size^2 frame of
    ``scene``: the rays at sub-pixel ``offset``, the camera's constants,
    the port's 16 x 16 ray tiles, and with ``lights`` (else None) the
    shadow sources' constants (light-major, sample-minor); the table and
    the keep-mask K7a takes (K7d: its primary columns), as raytrace_full
    and intersect_closest_culled make them."""
    from raytpu_torch import RenderConfig
    from raytpu_torch.core.types import pixel_grid
    from raytpu_torch.kernels import intersect as isect
    from raytpu_torch.kernels.tables import constant_table, tight_chunk
    from raytpu_torch.ops.intersect import tri_constants
    from raytpu_torch.ops.shade import source_positions
    from raytpu_torch.render.raytrace import camera_ray_dirs
    cfg = RenderConfig(width=size, height=size)
    xs, ys = pixel_grid(size, size, dev)
    dirs = camera_ray_dirs(xs + offset[0], ys + offset[1], camera, cfg)
    c = tri_constants(scene, camera.pos)
    T = scene.num_triangles
    C = tight_chunk(T, cfg.tri_chunk)
    n_chunks = -(-T // C)
    tiles = isect.ray_tiles(size * size, (size, size), dev)
    geom = (scene.v0, scene.v1, scene.v2)
    case = dict(dirs=dirs, m=c.m, k0=c.k0, valid=c.valid, cam=camera.pos,
                tiles=tiles, C=C, n_chunks=n_chunks, geom=geom, size=size)
    if lights is None:
        case["mask"] = isect.primary_mask(camera.pos, dirs, tiles, *geom,
                                          c.valid, C)
        case["table"] = constant_table(c.m, c.k0, c.valid, None, None, C)
        case["src"] = dirs.new_zeros((0, 3))
        return case
    src = source_positions(lights, samples)
    cs = tri_constants(scene, src)
    case.update(m_s=cs.m, k0_s=cs.k0, src=src,
                mask=isect.fused_mask(dirs, tiles, geom, c.valid, src,
                                      camera.pos, C),
                table=constant_table(c.m, c.k0, c.valid, cs.m, cs.k0, C))
    return case


def hit_cases(dev, mesh9028) -> dict:
    """The closest-hit kernels' main-path inputs (stl_case): the bench's
    stl_intersect row, K5 and K7d (`bench.py:679-719`: 512^2, the mesh
    padded to 9,216, the rasteriser camera); the sharded renderer's
    Cornell sub-ray, K5 on one chunk (phase 30: 512^2, the box padded to
    32, the raytracer's camera; no mask); the render --stl frame, K7a:
    500^2, 9,028 triangles, one light (S = 1) at the AA sub-ray (-0.5,
    0.5), and the full-feature sources, 2 lights x 16 samples (S = 32)."""
    from raytpu_torch import Camera, Lights, cornell_box
    cornell = stl_case(dev, cornell_box(pad_to=32, device=dev),
                       Camera.raytracer_default(device=dev), 512, None, 1,
                       (0.0, 0.0))
    del cornell["mask"]
    return {
        "stl_intersect_512": stl_case(
            dev, mesh9028.pad_to(9216), Camera.rasterizer_default(device=dev),
            512, None, 1, (0.0, 0.0)),
        "cornell_512": cornell,
        "render_stl_500_s1": stl_case(
            dev, mesh9028, stl_camera(dev), 500,
            Lights.single(capacity=1, device=dev), 1, (-0.5, 0.5)),
        "render_stl_500_s32": stl_case(
            dev, mesh9028, stl_camera(dev), 500, full_feature_lights(dev), 16,
            (-0.5, -0.5)),
    }


def run_stl(case: dict, kernel: str, mask=None, plain: bool = False):
    """K5, K7d or K7a (``kernel``) on an stl_case through its wrapper, or
    its plain version; ``mask`` overrides the case's keep-mask."""
    from raytpu_torch.kernels import intersect as isect
    c = case
    mask = c.get("mask") if mask is None else mask
    table, C = c["table"], c["C"]
    if kernel == "k5":
        return (isect.closest_reference(c["dirs"], table[:10], C) if plain
                else isect.closest_hit(c["dirs"], c["m"], c["k0"],
                                       c["valid"]))
    if kernel == "k7d":
        mask = mask[:, :c["n_chunks"]].contiguous()
        if plain:
            return isect.closest_masked_reference(c["dirs"], table[:10], C,
                                                  mask, c["tiles"])
        return isect.closest_hit_masked(c["dirs"], c["m"], c["k0"],
                                        c["valid"], mask, c["tiles"])
    if plain:
        return isect.occluded_masked_reference(c["dirs"], table, C, c["cam"],
                                               c["src"], mask, c["tiles"])
    return isect.closest_hit_occluded_multi_masked(
        c["dirs"], c["m"], c["k0"], c["valid"], c["m_s"], c["k0_s"],
        c["cam"], c["src"], mask, c["tiles"])


def primary_work(dirs, table, C: int, mask, tiles) -> dict:
    """The closest-hit sweep's work under the cull (K5: mask None, its runs
    of 256 rays; K7d and K7a's primary half: the mask's first Tp / C
    columns over ``tiles``), from the plain forms on these tensors
    (kernels/intersect.py::primary_cull_decisions, shadow_reject without
    t < 0.99): ``walked`` the (tile, triangle) pairs of the kept chunks the
    tiles of a valid ray decide, ``tile_kept`` those that survive,
    ``warp_tests`` the (warp, survivor) pairs its warps of a valid ray
    decide, ``warp_kept`` those that survive, ``tests`` the (ray, survivor
    of its warp) tests, ``rejected`` those the reject decides; and
    ``before``, the tests of the sweep before the cull (every ray of a
    tile against every triangle of its kept chunks)."""
    from raytpu_torch.kernels import intersect as isect
    R, Tp = dirs.shape[0], table.shape[1]
    if mask is None:
        tiles = isect.ray_tiles(R, None, dirs.device)
    dec = isect.primary_cull_decisions(dirs, table, tiles)
    nt = tiles.count
    kept = (torch.ones((nt, Tp), dtype=torch.bool, device=dirs.device)
            if mask is None else
            mask[:, :Tp // C].bool().repeat_interleave(C, dim=1))
    lanes = isect._tile_slots_valid(tiles).reshape(nt, 8, 32).sum(dim=2)
    walked = kept & (lanes.sum(dim=1) > 0)[:, None]
    tile_kept = walked & ~dec[:, 0]
    warp_kept = tile_kept[:, None, :] & ~dec[:, 1:] & (lanes > 0)[..., None]
    n_tile = tile_kept.sum(dim=1)
    warp = isect.ray_warps(tiles)
    surv = warp_kept.reshape(nt * 8, Tp)
    rejected = 0
    for lo in range(0, Tp, C):
        m, k0 = isect._chunk(table, 0, lo // C, C)
        rej = isect.shadow_reject(dirs, m, k0, below_t=False)
        rejected += int((rej & surv[warp, lo:lo + C]).sum())
        del rej
    return dict(walked=int(walked.sum()), tile_kept=int(n_tile.sum()),
                warp_tests=int((n_tile[:, None] * (lanes > 0)).sum()),
                warp_kept=int(warp_kept.sum()),
                tests=int((warp_kept.sum(dim=2) * lanes).sum()),
                rejected=rejected,
                before=int((kept.sum(dim=1) * lanes.sum(dim=1)).sum()))


def primary_work_line(w: dict) -> str:
    return (f"the tiles decide {w['walked']} (tile, triangle) pairs and keep "
            f"{w['tile_kept']} ({w['tile_kept'] / max(1, w['walked']):.5f}), "
            f"the warps decide {w['warp_tests']} and keep {w['warp_kept']} "
            f"({w['warp_kept'] / max(1, w['warp_tests']):.4f}); {w['tests']}"
            f" ray tests of {w['before']} before the cull "
            f"({w['tests'] / max(1, w['before']):.6f}), {w['rejected']} "
            f"decided by the reject")


def stl_work(case: dict, kernel: str) -> dict:
    """Plane tests K5, K7d or K7a make on an stl_case: every ray against
    every column (K5); each tile's real rays against its kept chunks'
    (K7d, K7a's primary sweep); and K7a's shadow sweeps: each hit ray of a
    tile, for each source, through the chunks the tile keeps for it in
    order, up to its first blocker (t < 0.99). Of those shadow tests,
    ``rejected`` counts the ones K7a's reject decides (its plain form,
    kernels/intersect.py::shadow_reject), and ``reject_wrong`` every test
    of the sweeps, to the end of each chunk, that it rejects and
    plane_tests calls blocking (it must be 0)."""
    from raytpu_torch.kernels import intersect as isect
    from raytpu_torch.ops.intersect import plane_tests
    from raytpu_torch.ops.shade import SHADOW_T
    c = case
    tiles, C, n = c["tiles"], c["C"], c["n_chunks"]
    R = c["dirs"].shape[0]
    if kernel == "k5":
        return dict(primary=R * c["table"].shape[1], shadow=0, keep=1.0,
                    cull=primary_work(c["dirs"], c["table"][:10], C, None,
                                      None))
    rays = torch.bincount(tiles.tile, minlength=tiles.count)
    pmask = c["mask"][:, :n].long()
    work = dict(primary=int((pmask.sum(dim=1) * rays).sum()) * C, shadow=0,
                keep=float(pmask.float().mean()),
                cull=primary_work(c["dirs"], c["table"][:10], C, c["mask"],
                                  tiles))
    if kernel == "k7d":
        return work
    work["shadow_keep"] = float(c["mask"][:, n:].float().mean())
    t, idx = isect.closest_masked_reference(
        c["dirs"], c["table"][:10], C, pmask.int(), tiles)
    hit = idx >= 0
    pos = c["cam"][None, :] + torch.where(hit, t, 0.0)[:, None] * c["dirs"]
    cols = torch.arange(C, device=pos.device)[None, :]
    shadow = rejected = wrong = 0
    S = c["src"].shape[0]
    ray_tests = torch.zeros((S, R), dtype=torch.long, device=pos.device)
    for s in range(S):
        sweeping = hit.clone()
        for ch in range(n):
            keep = c["mask"][tiles.tile, (1 + s) * n + ch] != 0
            rows = torch.nonzero(sweeping & keep).squeeze(1)
            if rows.numel() == 0:
                continue
            delta = pos[rows] - c["src"][s][None, :]
            m, k0 = isect._chunk(c["table"], 1 + s, ch, C)
            ts, oks = plane_tests(delta, m, k0)
            blocked = oks & (ts < SHADOW_T)
            reject = isect.shadow_reject(delta, m, k0)
            first = blocked.float().argmax(dim=1) + 1
            any_ = blocked.any(dim=1)
            tests = torch.where(any_, first, C)
            ray_tests[s].index_add_(0, rows, tests)
            shadow += int(tests.sum())
            rejected += int((reject & (cols < tests[:, None])).sum())
            wrong += int((reject & blocked).sum())
            sweeping[rows[any_]] = False
    # K7a packs each tile's hit rays in ray order into warps of 32; in one
    # run a warp sweeps until its last lane is done. Lane use: the tests its
    # lanes make over 32 times its longest lane's, summed over the sources.
    rays = torch.nonzero(hit).squeeze(1)  # in ray order
    tile = tiles.tile[rays]
    per_tile = torch.bincount(tile, minlength=tiles.count)
    start = torch.cumsum(per_tile, 0) - per_tile
    order = torch.argsort(tile, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(rays.numel(), device=rays.device) - start[
        tile[order]]
    warp = tile * (isect.TILE_RAYS // 32) + rank // 32
    longest = torch.zeros((S, tiles.count * (isect.TILE_RAYS // 32)),
                          dtype=torch.long, device=rays.device)
    longest.scatter_reduce_(1, warp[None, :].expand(S, -1),
                            ray_tests[:, rays], "amax")
    work.update(shadow=shadow, rejected=rejected, reject_wrong=wrong,
                hit_tiles=int((per_tile > 0).sum()),
                hit_warps=int(((per_tile + 31) // 32).sum()),
                lane_use=float(ray_tests.sum()) / max(
                    1, 32 * int(longest.sum())))
    return work


def stl_bound(case: dict, kernel: str, work: dict, reject: bool = True,
              cull: bool = True) -> tuple[float, str]:
    """K5's, K7d's or K7a's bound: 12 B in and 8 + 4 S B out a ray, the
    table and the mask read once; the primary sweep's cull
    (stl_work's ``cull``, primary_work): FLOPS_PRIMARY_CULL a (tile,
    triangle) and a (warp, survivor) decision, FLOPS_PRIMARY_REJECT a
    test of a warp's survivors and a plane test besides where the reject
    leaves it open (``cull`` False: FLOPS_PLANE_TEST a test of every ray
    against every triangle of its tile's kept chunks, the count before the
    cull); K7a's shadow tests FLOPS_REJECT each and, where the reject does
    not decide, a plane test besides (``reject`` False: every test of both
    sweeps a plane test, the count before K7a's reject)."""
    c = case
    R, S = c["dirs"].shape[0], c["src"].shape[0]
    nbytes = R * (12 + 8 + 4 * S) + c["table"].numel() * 4 + (3 + 3 * S) * 4
    if kernel != "k5":
        nbytes += (c["mask"].numel() if kernel == "k7a"
                   else c["tiles"].count * c["n_chunks"]) * 4
    if not reject:
        return bound_ms(nbytes, FLOPS_PLANE_TEST * (work["primary"]
                                                    + work["shadow"]))
    primary = FLOPS_PLANE_TEST * work["primary"]
    if cull:
        w = work["cull"]
        primary = (FLOPS_PRIMARY_CULL * (w["walked"] + w["warp_tests"])
                   + FLOPS_PRIMARY_REJECT * w["tests"]
                   + FLOPS_PLANE_TEST * (w["tests"] - w["rejected"]))
    shadow = 0
    if kernel == "k7a":
        shadow = (FLOPS_PLANE_TEST * (work["shadow"] - work["rejected"])
                  + FLOPS_REJECT * work["shadow"])
    return bound_ms(nbytes, primary + shadow)


def kernel_counts() -> dict:
    from raytpu_torch.kernels import intersect as isect
    from raytpu_torch.kernels import raster, render_fused
    from raytpu_torch.kernels import soft_raster as sr
    from raytpu_torch.kernels import soft_raytrace as srt
    return {"render_fused_fwd": render_fused.LAUNCHES,
            "soft_raster_fwd": sr.LAUNCHES_SOFT_FWD,
            "soft_raster_fwd_masked": sr.LAUNCHES_SOFT_FWD_MASKED,
            "soft_raster_bwd": sr.LAUNCHES_SOFT_BWD,
            "soft_raster_bwd_masked": sr.LAUNCHES_SOFT_BWD_MASKED,
            "closest_hit_occluded": isect.LAUNCHES_OCCLUDED,
            "closest_hit_occluded_multi": isect.LAUNCHES_OCCLUDED_MULTI,
            "closest_hit": isect.LAUNCHES_CLOSEST,
            "closest_hit_masked": isect.LAUNCHES_CLOSEST_MASKED,
            "closest_hit_occluded_masked": isect.LAUNCHES_OCCLUDED_MASKED,
            "occlusion": isect.LAUNCHES_OCCLUSION,
            "occlusion_masked": isect.LAUNCHES_OCCLUSION_MASKED,
            "render_fused_bwd": render_fused.LAUNCHES_BWD,
            "render_fused_scatter": render_fused.LAUNCHES_SCATTER,
            "raster_winner": raster.LAUNCHES_WINNER,
            "raster_winner_masked": raster.LAUNCHES_WINNER_MASKED,
            "raster_winner_chunked": raster.LAUNCHES_WINNER_CHUNKED,
            "soft_rt_pri_fwd": srt.LAUNCHES_SRT_PRI_FWD,
            "soft_rt_pri_bwd": srt.LAUNCHES_SRT_PRI_BWD,
            "soft_rt_shw_fwd": srt.LAUNCHES_SRT_SHW_FWD,
            "soft_rt_shw_bwd": srt.LAUNCHES_SRT_SHW_BWD,
            "soft_rt_pri_fwd_masked": srt.LAUNCHES_SRT_PRI_FWD_MASKED,
            "soft_rt_pri_bwd_masked": srt.LAUNCHES_SRT_PRI_BWD_MASKED,
            "soft_rt_shw_fwd_masked": srt.LAUNCHES_SRT_SHW_FWD_MASKED,
            "soft_rt_shw_bwd_masked": srt.LAUNCHES_SRT_SHW_BWD_MASKED,
            "soft_rt_pri_bwd_tables": srt.LAUNCHES_SRT_PRI_BWD_TABLES,
            "soft_rt_pri_bwd_dirs": srt.LAUNCHES_SRT_PRI_BWD_DIRS,
            "soft_rt_shw_bwd_consts": srt.LAUNCHES_SRT_SHW_BWD_CONSTS,
            "soft_rt_shw_bwd_rays": srt.LAUNCHES_SRT_SHW_BWD_RAYS}


def zero_counts() -> None:
    from raytpu_torch.kernels import intersect as isect
    from raytpu_torch.kernels import raster, render_fused
    for name in ("LAUNCHES", "LAUNCHES_BWD", "LAUNCHES_SCATTER"):
        setattr(render_fused, name, 0)
    isect.LAUNCHES_OCCLUDED = isect.LAUNCHES_OCCLUDED_MULTI = 0
    isect.LAUNCHES_CLOSEST = isect.LAUNCHES_CLOSEST_MASKED = 0
    isect.LAUNCHES_OCCLUDED_MASKED = 0
    isect.LAUNCHES_OCCLUSION = isect.LAUNCHES_OCCLUSION_MASKED = 0
    raster.LAUNCHES_WINNER = raster.LAUNCHES_WINNER_MASKED = 0
    raster.LAUNCHES_WINNER_CHUNKED = 0
    from raytpu_torch.kernels import soft_raster as sr
    sr.LAUNCHES_SOFT_FWD = sr.LAUNCHES_SOFT_FWD_MASKED = 0
    sr.LAUNCHES_SOFT_BWD = sr.LAUNCHES_SOFT_BWD_MASKED = 0
    from raytpu_torch.kernels import soft_raytrace as srt
    srt.LAUNCHES_SRT_PRI_FWD = srt.LAUNCHES_SRT_PRI_BWD = 0
    srt.LAUNCHES_SRT_SHW_FWD = srt.LAUNCHES_SRT_SHW_BWD = 0
    srt.LAUNCHES_SRT_PRI_FWD_MASKED = srt.LAUNCHES_SRT_PRI_BWD_MASKED = 0
    srt.LAUNCHES_SRT_SHW_FWD_MASKED = srt.LAUNCHES_SRT_SHW_BWD_MASKED = 0
    srt.LAUNCHES_SRT_PRI_BWD_TABLES = srt.LAUNCHES_SRT_PRI_BWD_DIRS = 0
    srt.LAUNCHES_SRT_SHW_BWD_CONSTS = srt.LAUNCHES_SRT_SHW_BWD_RAYS = 0


def raster_case(scene, camera, cfg) -> dict:
    """The winner kernels' inputs for a clean frame, as rasterize_exact
    makes them: the (T, 16) constants from the screen vertices and the
    backface mask, and the K8c mask over its tiles where T is more than a
    chunk."""
    from raytpu_torch.kernels import raster
    from raytpu_torch.ops.raster import cull_mask
    from raytpu_torch.render.soft import _screen_vertices
    with torch.no_grad():
        sx, sy, zinv, _ = _screen_vertices(scene, camera, cfg)
        keep = cull_mask(scene, camera, cfg.replace(frustum_cull=False))
        consts = raster.raster_tri_constants(sx, sy, zinv, keep)
        case = dict(consts=consts, H=cfg.height, W=cfg.width, mask=None,
                    chunk=raster.MAX_CHUNK)
        if consts.shape[0] > raster.MAX_CHUNK:
            case["mask"] = raster.chunk_screen_mask(
                sx, sy, zinv, consts[:, 12],
                raster.tile_rects(cfg.height, cfg.width, consts.device),
                raster.MAX_CHUNK)
    return case


def run_winner(case: dict, mask=None):
    """The K8b (no mask) or K8c wrapper on a raster_case; ``mask``
    overrides the case's own."""
    from raytpu_torch.kernels import raster
    c = case
    if c["mask"] is None:
        return raster.raster_winner(c["consts"], c["H"], c["W"])
    return raster.raster_winner_masked(
        c["consts"], c["H"], c["W"], c["mask"] if mask is None else mask,
        c["chunk"])


def plain_winner(case: dict):
    from raytpu_torch.kernels import raster
    c = case
    if c["mask"] is None:
        return raster.resolve_winner_reference(c["consts"], c["H"], c["W"])
    return raster.resolve_winner_masked_reference(
        c["consts"], c["H"], c["W"], c["mask"], c["chunk"])


def winner_work(consts, H: int, W: int, chunk: int | None = None,
                mask=None, y0: int = 0) -> dict:
    """What K8a (mask None: every row for every tile) or K8c (the rows of
    the chunks each tile's mask keeps) must do since the cull, from its
    plain form (kernels/raster.py::raster_tile_reject) on the card's
    tensors: the (tile, row) pairs walked, those rejected and kept, the
    (pixel, row) tests of the kept rows (each tile's pixels inside the
    image), and the tests the kernels made before the cull (every valid
    row walked, every pixel)."""
    from raytpu_torch.kernels import raster
    T = consts.shape[0]
    xmin, xmax, ymin, ymax = raster.tile_rects(H, W, consts.device)
    rej = raster.raster_tile_reject(consts, (xmin, xmax, ymin + y0,
                                             ymax + y0))
    pixels = ((xmax - xmin + 1) * (ymax - ymin + 1)).double()
    walked = (torch.ones_like(rej) if mask is None else
              (mask != 0).T.repeat_interleave(chunk, dim=0)[:T])
    keep = walked & ~rej
    valid = (consts[:, 12] > 0.0)[:, None]
    w = dict(walked=int(walked.sum()), rejected=int((walked & rej).sum()),
             kept=int(keep.sum()),
             tests=int((keep.double() * pixels[None, :]).sum()),
             tests_before=int(((walked & valid).double()
                               * pixels[None, :]).sum()),
             all_pairs=rej.numel(), all_rejected=int(rej.sum()))
    return w


def winner_work_line(w: dict) -> str:
    return (f"{w['walked']} (tile, row) pairs walked, {w['rejected']} culled "
            f"({w['rejected'] / max(1, w['walked']):.4%}), {w['kept']} kept; "
            f"{w['tests']} pixel tests of kept rows (before the cull "
            f"{w['tests_before']})")


def winner_bound(case: dict, work: dict | None = None) -> tuple[float, str]:
    """K8b's, K8c's or K8a's bound on a raster_case: the constants (and
    mask) read once and 4 B of winner written a pixel, against
    FLOPS_RASTER_TEST a test of a pixel against a valid row (valid =
    consts[:, 12] > 0; an invalid row needs no test): every valid row for
    every pixel (K8b), or for each (tile, chunk) pair the mask keeps, the
    tile's pixels inside the image against the chunk's valid rows (K8c).
    With ``work`` (winner_work) since the cull: FLOPS_RASTER_CULL a (tile,
    row) pair walked and FLOPS_RASTER_TEST a test of a kept row."""
    from raytpu_torch.kernels import raster
    c = case
    T, H, W = c["consts"].shape[0], c["H"], c["W"]
    valid = (c["consts"][:, 12] > 0.0).long()
    nbytes = c["consts"].numel() * 4 + H * W * 4
    if c["mask"] is not None:
        nbytes += c["mask"].numel() * 4
    if work is not None:
        return bound_ms(nbytes, FLOPS_RASTER_CULL * work["walked"]
                        + FLOPS_RASTER_TEST * work["tests"])
    if c["mask"] is None:
        return bound_ms(nbytes, FLOPS_RASTER_TEST * H * W * int(valid.sum()))
    pad = c["mask"].shape[1] * c["chunk"] - T
    chunk_valid = torch.cat([valid, valid.new_zeros(pad)]).reshape(
        -1, c["chunk"]).sum(dim=1)
    xmin, xmax, ymin, ymax = raster.tile_rects(H, W, valid.device)
    tile_pixels = ((xmax - xmin + 1) * (ymax - ymin + 1)).long()
    tests = int((c["mask"].long() * tile_pixels[:, None]
                 * chunk_valid[None, :]).sum())
    return bound_ms(nbytes, FLOPS_RASTER_TEST * tests)


def raster_bench_frame(dev, size: int):
    """bench.py's raster step frame (`bench.py:339-397`): size^2 clean, the
    Cornell box padded to 32, the rasteriser camera, one light."""
    from raytpu_torch import Camera, Lights, RenderConfig, cornell_box
    return (cornell_box(pad_to=32, device=dev),
            Camera.rasterizer_default(device=dev),
            Lights.single(capacity=1, device=dev),
            RenderConfig(width=size, height=size, mode="clean"))


def stl_frame(dev, path, size: int):
    """The rasterize CLI's STL frame (`--stl`): size^2 clean, the camera
    (0, -0.5, -5) at f = 500, one light."""
    from raytpu_torch import Camera, Lights, RenderConfig, load_stl
    return (load_stl(str(path), device=dev),
            Camera.make((0.0, -0.5, -5.0), focal=500.0, dof_focus=1.9,
                        device=dev),
            Lights.single(capacity=1, device=dev),
            RenderConfig(width=size, height=size, mode="clean"))


def soft_case(scene, camera, cfg) -> dict:
    """The soft kernels' inputs for a frame, as rasterize_soft builds them
    (render/soft.py::rasterize_soft_inputs), on detached tensors."""
    from raytpu_torch.render.soft import rasterize_soft_inputs
    with torch.no_grad():
        consts, chunk, mask, es, zs = rasterize_soft_inputs(scene, camera,
                                                            cfg)
    return dict(consts=consts.contiguous(), chunk=chunk, mask=mask, es=es,
                zs=zs, H=cfg.height, W=cfg.width)


def own_mask(case, mask):
    """``mask``, or the case's own where it is "own"."""
    return case["mask"] if isinstance(mask, str) else mask


def soft_fwd(case, mask="own"):
    """K9a (no mask) or K9b's wrapper on a soft_case; ``mask`` overrides
    the case's own."""
    from raytpu_torch.kernels import soft_raster as sr
    c = case
    return sr.soft_agg_fwd(c["consts"], c["H"], c["W"], c["chunk"],
                           own_mask(c, mask), c["es"],
                           c["zs"])


def soft_bwd(case, m, cot, mask="own"):
    from raytpu_torch.kernels import soft_raster as sr
    c = case
    return sr.soft_agg_bwd(c["consts"], m, cot, c["H"], c["W"], c["chunk"],
                           own_mask(c, mask), c["es"],
                           c["zs"])


def soft_pixel_mask(case, mask="own"):
    from raytpu_torch.kernels import soft_raster as sr
    mask = own_mask(case, mask)
    return None if mask is None else sr.expand_mask(mask, case["H"],
                                                    case["W"])


def plain_soft_fwd(case, mask="own", stats=None):
    """The plain forward; with ``stats`` (a dict), the plain forward with
    each pixel block's dead rows left out as the kernels leave them out
    (the same bits), adding its counts to stats (soft_agg_reference)."""
    from raytpu_torch.kernels import soft_raster as sr
    c = case
    dev = c["consts"].device
    return sr.soft_agg_reference(
        c["consts"], sr.pixel_coords(c["H"], c["W"], dev),
        soft_pixel_mask(case, mask), c["es"], c["zs"], c["chunk"],
        dead_rows=(None if stats is None
                   else sr.tile_layout(c["H"], c["W"], dev)),
        stats=stats)


def soft_dead_probe(case, m) -> dict:
    """The card's dead-row probe (kernels/soft_raster.py::
    soft_row_dead_probe) at each pixel block's floor from the forward's
    saved max m (the largest a block reaches) and at 0 (an item's first
    chunk), beside the plain form's count at the same floors."""
    from raytpu_torch.kernels import soft_raster as sr
    c = case
    block, rect = sr.tile_layout(c["H"], c["W"], m.device)
    top = torch.full((rect[0].shape[0],), float("inf"),
                     device=m.device).scatter_reduce(0, block, m, "amin")
    held = (rect[0] <= rect[1]) & (rect[2] <= rect[3])  # blocks with pixels
    out = {}
    for name, floor in (("max", top), ("zero", torch.zeros_like(top))):
        got = sr.soft_row_dead_probe(c["consts"], c["H"], c["W"], c["es"],
                                     c["zs"], floor)
        got["plain"] = int(sr.soft_row_dead(c["consts"], rect, c["es"],
                                            c["zs"], floor)[:, held].sum())
        out[name] = got
    return out


def plain_soft_bwd(case, m, cot, mask="own", dtype=torch.float32):
    """The plain backward; in float64 with the float32 table's branch
    decisions (Kinks)."""
    from raytpu_torch.kernels import soft_raster as sr
    c = case
    return sr.soft_agg_bwd_reference(
        c["consts"].to(dtype),
        sr.pixel_coords(c["H"], c["W"], c["consts"].device, dtype),
        soft_pixel_mask(case, mask), m.to(dtype), cot.to(dtype), c["es"],
        c["zs"], c["chunk"],
        branches_from=c["consts"] if dtype != torch.float32 else None)


def soft_pair_work(case, m, cot, mask="own") -> dict:
    """The (pixel, row) pairs K9c or K9d takes on a soft_case at the saved
    max m and cotangents cot: every pixel against every row, or each tile's
    pixels against the rows of the chunks its mask keeps (``pairs``); of
    those, ``dead`` the ones its exact dead test skips (the plain form,
    kernels/soft_raster.py::soft_dead_pairs), ``zero`` the ones whose plain
    float32 weight exp(logit - m) is 0, ``wrong`` the skipped ones whose
    weight is not (it must be 0); and, a warp on each 4 x 8 pixel block of
    a 16 x 16 tile as the kernels run them, the (warp, row) units, those
    with a live lane and the live lanes in those."""
    from raytpu_torch.kernels import soft_raster as sr
    c = case
    mask = own_mask(c, mask)
    H, W, chunk, consts = c["H"], c["W"], c["chunk"], c["consts"]
    n_chunks = consts.shape[0] // chunk
    dev = consts.device
    tiles_x = -(-W // 16)
    n_tiles = tiles_x * -(-H // 16)
    ly, lx = torch.meshgrid(torch.arange(16, device=dev),
                            torch.arange(16, device=dev), indexing="ij")
    lane_order = torch.argsort((((ly // 4) * 2 + lx // 8) * 32
                                + (ly % 4) * 8 + lx % 8).reshape(-1))
    t = torch.arange(n_tiles, device=dev)
    X = ((t % tiles_x) * 16)[:, None] + lx.reshape(-1)[lane_order][None, :]
    Y = ((t // tiles_x) * 16)[:, None] + ly.reshape(-1)[lane_order][None, :]
    keep = (torch.ones((n_tiles, n_chunks), dtype=torch.bool, device=dev)
            if mask is None else mask != 0)
    w = dict(pairs=0, dead=0, zero=0, wrong=0, units=0, live_units=0,
             live_lanes=0)
    for ch in range(n_chunks):
        kept = torch.nonzero(keep[:, ch]).squeeze(1)
        if kept.numel() == 0:
            continue
        x, y = X[kept].reshape(-1), Y[kept].reshape(-1)
        ok = ((x < W) & (y < H))[None, :]
        r = torch.where(ok[0], y * W + x, 0)
        cs = consts[ch * chunk:(ch + 1) * chunk]
        coords = torch.stack([x.float(), y.float()])
        with torch.no_grad():
            logit, _ = sr.chunk_terms(cs, coords[0], coords[1], c["es"],
                                      c["zs"])
            zero = torch.exp(logit - m[r][None, :]) == 0.0
            dead = sr.soft_dead_pairs(cs, coords, m[r], cot[:, r], c["es"],
                                      c["zs"]) & ok
        live = ~dead & ok
        w["pairs"] += int(ok.sum()) * chunk
        w["dead"] += int(dead.sum())
        w["zero"] += int((zero & ok).sum())
        w["wrong"] += int((dead & ~zero).sum())
        units = live.reshape(chunk, -1, 32)
        w["units"] += units.shape[0] * units.shape[1]
        w["live_units"] += int(units.any(dim=2).sum())
        w["live_lanes"] += int(units.sum())
    return w


def soft_bound(case, backward: bool, mask="own",
               work: dict | None = None) -> tuple[float, str]:
    """K9a-K9d's bound on a soft_case: the table read (and, backward,
    its gradient written) once, 12 floats a pixel (agg, m, s out; m and the
    11 cotangents in), against FLOPS_SOFT_* a (pixel, row) pair: every pixel
    against every row, or for each (tile, chunk) pair the mask keeps, the
    tile's pixels inside the image against the chunk's rows. Backward, with
    ``work`` (soft_pair_work) since the redesign: FLOPS_SOFT_DEAD a pair
    for its dead test and FLOPS_SOFT_BWD_REST more for a live one; without
    it, FLOPS_SOFT_BWD a pair (the count before). Forward, with ``work``
    (plain_soft_fwd's stats) since the redesign: FLOPS_SOFT_ROW_DEAD a
    (block, row) pair walked and FLOPS_SOFT_FWD a live (pixel, row) pair."""
    from raytpu_torch.kernels.raster import tile_rects
    c = case
    mask = own_mask(c, mask)
    H, W, Tp = c["H"], c["W"], c["consts"].shape[0]
    nbytes = Tp * 128 * (2 if backward else 1) + H * W * 48
    if mask is None:
        pairs = H * W * Tp
    else:
        xmin, xmax, ymin, ymax = tile_rects(H, W, mask.device)
        tile_pixels = ((xmax - xmin + 1) * (ymax - ymin + 1)).long()
        pairs = int((mask.long() * tile_pixels[:, None]).sum()) * c["chunk"]
        nbytes += mask.numel() * 4
    if backward and work is not None:
        return bound_ms(nbytes, FLOPS_SOFT_DEAD * pairs
                        + FLOPS_SOFT_BWD_REST * (pairs - work["dead"]))
    if work is not None:
        return bound_ms(nbytes, FLOPS_SOFT_ROW_DEAD * work["rows"]
                        + FLOPS_SOFT_FWD * work["live_pairs"])
    return bound_ms(nbytes, (FLOPS_SOFT_BWD if backward else FLOPS_SOFT_FWD)
                    * pairs)


def soft_cot(case, seed: int) -> torch.Tensor:
    """(11, R) cotangents of one sign (as phase 7's backward check: signed
    ones cancel in the sums until float32 rounding decides the small
    ones), from a numpy seed."""
    rng = np.random.default_rng(seed)
    R = case["H"] * case["W"]
    return torch.tensor(rng.uniform(0.5, 1.5, (11, R)).astype(np.float32),
                        device=case["consts"].device)


def srt_case(scene, camera, lights, cfg, cull: bool = False) -> dict:
    """The soft raytrace kernels' inputs for a frame, as raytrace_soft
    builds them (render/soft.py::raytrace_soft_inputs, cull False or
    True), on detached tensors: both tables, the rays (3, R), the camera
    position, the chunk, the sharpness and the shadow sources; culled, the
    ray tiles, the primary keep-mask and the vertices the shadow mask is
    made from (srt_shadow_mask)."""
    from raytpu_torch.ops.shade import source_positions
    from raytpu_torch.render.soft import raytrace_soft_inputs
    with torch.no_grad():
        inp = raytrace_soft_inputs(scene, camera, cfg, cull=cull)
        srcs = source_positions(lights, max(cfg.soft_shadow_samples, 1))
    c = dict(pri=inp.pri.contiguous(), shw=inp.shw.contiguous(),
             dirs=inp.dirs.detach(), cam=camera.pos.detach().contiguous(),
             chunk=inp.chunk, es=inp.es, zs=inp.zs,
             srcs=srcs.detach().contiguous())
    if cull:
        c.update(tiles=inp.tiles, mask=inp.mask, smask=None,
                 geom=tuple(v.detach() for v in (scene.v0, scene.v1,
                                                  scene.v2)))
    return c


def srt_shadow_mask(c, world) -> torch.Tensor:
    """The shadow keep-mask (n_tiles, S, n_chunks) of a culled srt_case at
    the aggregated hit positions world (3, R), as raytrace_soft makes it."""
    from raytpu_torch.kernels import soft_raytrace as srt
    from raytpu_torch.kernels.intersect import TILE_RAYS
    with torch.no_grad():
        return srt.soft_rt_shadow_mask(world.T[c["tiles"].rays], c["srcs"],
                                       *c["geom"], c["es"], c["zs"],
                                       TILE_RAYS, c["chunk"])


def _cull(c, masked: bool, mask_key: str) -> dict:
    """The wrappers' mask and tiles of a culled srt_case, or none."""
    return dict(mask=c[mask_key], tiles=c["tiles"]) if masked else {}


def srt_fwd(c, plain=False, masked=False):
    """K10a's wrapper on a srt_case (out, m, s), or its plain version;
    masked: K10b's with the case's keep-mask."""
    from raytpu_torch.kernels import soft_raytrace as srt
    fn = srt.primary_agg_reference if plain else srt.primary_agg_fwd
    return fn(c["pri"], c["cam"], c["dirs"], c["es"], c["zs"], c["chunk"],
              **_cull(c, masked, "mask"))


def srt_shw(c, world, plain=False, masked=False):
    """K10g's wrapper on a srt_case and world points (3, R), or its plain
    version; masked: K10h's with the case's shadow mask."""
    from raytpu_torch.kernels import soft_raytrace as srt
    fn = srt.shadow_trans_reference if plain else srt.shadow_trans_fwd
    return fn(c["shw"], c["srcs"], world, c["es"], c["zs"], c["chunk"],
              **_cull(c, masked, "smask"))


def srt_bwd(c, m, cot, plain=False, dtype=torch.float32, masked=False):
    """K10c's wrapper (dc, dcam, dd), or its plain version; in float64 with
    the float32 branch decisions (Kinks); masked: K10d's."""
    from raytpu_torch.kernels import soft_raytrace as srt
    args = (c["pri"], c["cam"], c["dirs"], m, cot)
    cull = _cull(c, masked, "mask")
    if not plain:
        return srt.primary_agg_bwd(*args, c["es"], c["zs"], c["chunk"],
                                   **cull)
    return srt.primary_agg_bwd_reference(
        *(t.to(dtype) for t in args), c["es"], c["zs"], c["chunk"],
        f32_branches=dtype != torch.float32, **cull)


def srt_shw_bwd(c, world, trans, gcot, plain=False, dtype=torch.float32,
                masked=False):
    """K10i's wrapper (dc, dsrc, dw), or its plain version; in float64 with
    the float32 branch decisions; masked: K10j's."""
    from raytpu_torch.kernels import soft_raytrace as srt
    args = (c["shw"], c["srcs"], world, trans, gcot)
    cull = _cull(c, masked, "smask")
    if not plain:
        return srt.shadow_trans_bwd(*args, c["es"], c["zs"], c["chunk"],
                                    **cull)
    return srt.shadow_trans_bwd_reference(
        *(t.to(dtype) for t in args), c["es"], c["zs"], c["chunk"],
        f32_branches=dtype != torch.float32, **cull)


def pri_fwd_work(c, m, masked: bool = False) -> dict:
    """What K10a (masked: K10b) and K10c (K10d) must do on a srt_case's
    primary pairs, from the plain forms: (ray, row) pairs in all (masked:
    of the rays whose tile keeps the row's chunk), gated, of a weight not
    0 at the saved m; of those the gate passes, how many the forward's
    test proves dead against the running carry of its work item
    (srt.primary_fwd_walk, dead_pf) and how many K10c-K10f's test at the
    saved m does (srt.primary_dead_pairs, dead_p); and the forward's plan
    (srt.primary_fwd_items): its run, items and the tiles of more than one
    item, which the merge folds. Requires that neither test marks a pair
    of a weight not 0. Kept in c for the saved m it was counted at."""
    from raytpu_torch.kernels import soft_raytrace as srt
    key = "pri_work_masked" if masked else "pri_work"
    if key in c and c[key][0] is m:
        return c[key][1]
    pri, d, chunk = c["pri"], c["dirs"], c["chunk"]
    mask, tiles = (c["mask"], c["tiles"]) if masked else (None, None)
    w = dict(pairs=0, gated_p=0, dead_pf=0, dead_p=0, live_p=0)
    with torch.no_grad():
        for k, keep, logit, dead in srt.primary_fwd_walk(
                pri, c["cam"], d, c["es"], c["zs"], chunk, mask, tiles):
            hit = logit != -1e30
            live = torch.exp(logit - m[keep]) != 0.0
            no_pair = srt.primary_dead_pairs(pri[k * chunk:(k + 1) * chunk],
                                             d[:, keep], m[keep], c["es"],
                                             c["zs"])
            w["pairs"] += logit.numel()
            w["gated_p"] += int((~hit).sum())
            w["live_p"] += int(live.sum())
            w["dead_pf"] += int((dead & hit).sum())
            w["dead_p"] += int((no_pair & hit).sum())
            require(not (dead & live).any(),
                    "pri_fwd_work: no pair of weight not 0 proved dead "
                    "against the running carry")
            require(not (no_pair & live).any(),
                    "pri_fwd_work: no pair of weight not 0 proved dead")
    R, n_chunks = d.shape[1], pri.shape[0] // chunk
    n_tiles = tiles.count if masked else -(-R // srt.THREADS)
    run, items = srt.primary_fwd_items(None if mask is None else mask.cpu(),
                                       n_tiles, n_chunks, R)
    per_tile = np.bincount([t for t, _ in items], minlength=n_tiles)
    w.update(fwd_run=run, fwd_items=len(items),
             fwd_merged=int((per_tile > 1).sum()))
    c[key] = (m, w)
    return w


def pri_fwd_line(w) -> str:
    """The primary forward's counts (pri_fwd_work's w) as printed by
    phases 19, 22, 26 and 28."""
    hit = w["pairs"] - w["gated_p"]
    return (f"{w['pairs']} pairs: {w['gated_p']} gated, {w['dead_pf']} "
            f"proved dead against the running carry "
            f"({w['dead_pf'] / max(hit, 1):.4%} of the gate's passing pairs; "
            f"at the saved max {w['dead_p'] / max(hit, 1):.4%}), "
            f"{hit - w['dead_pf']} live (not proved dead), {w['live_p']} of "
            f"weight not 0; {w['fwd_items']} items of runs of "
            f"{w['fwd_run']} chunks, {w['fwd_merged']} tiles of more than "
            f"one item (merged)")


@contextlib.contextmanager
def pri_fwd_rule(run_min: int, items: int):
    """K10a's and K10b's run rule (kernels/soft_raytrace.py
    PRI_FWD_RUN_MIN, PRI_FWD_ITEMS, which the wrappers and launchers read
    at each call) set to (run_min, items) inside the block."""
    from raytpu_torch.kernels import soft_raytrace as srt
    old = srt.PRI_FWD_RUN_MIN, srt.PRI_FWD_ITEMS
    srt.PRI_FWD_RUN_MIN, srt.PRI_FWD_ITEMS = run_min, items
    try:
        yield
    finally:
        srt.PRI_FWD_RUN_MIN, srt.PRI_FWD_ITEMS = old


def srt_work(c, m, world, dl, masked: bool = False,
             primary: bool = True) -> dict:
    """What K10a-K10i (masked: K10b-K10j) must do on a srt_case, from a
    plain recompute: the primary pairs as pri_fwd_work counts them
    (primary False: none of these); (source, point, row) triples in all
    (masked: kept), gated, and of those the gate passes, how many the
    forwards' test skips (srt.shadow_dead_terms) and how many have a term
    not 0; of the triples whose cotangent dl (S, R) is not 0 (dl None: not
    counted), how many, how many gated, how many of those the gate passes
    the backwards' test finds dead (srt.shadow_dead_triples) and how many
    of a term not 0."""
    from raytpu_torch.kernels import soft_raytrace as srt
    from raytpu_torch.kernels.soft_raster import Kinks
    shw, chunk = c["shw"], c["chunk"]
    Tp, S = c["pri"].shape[0], c["srcs"].shape[0]
    tiles = c.get("tiles")
    w = dict(pairs=0, gated_p=0, dead_p=0, dead_pf=0, live_p=0, triples=0,
             gated_s=0, dead_f=0, live_f=0, act_s=0, act_gated_s=0,
             dead_s=0, live_s=0)
    if primary:
        w.update(pri_fwd_work(c, m, masked))
    with torch.no_grad():
        for k, lo in enumerate(range(0, Tp, chunk)):
            for s in range(S):
                keep = srt._kept(c["smask"] if masked else None, tiles, k, s)
                wk = world[:, keep]
                kinks = Kinks()
                term = srt.shadow_terms(shw[lo:lo + chunk], c["srcs"][s],
                                        wk[0:1], wk[1:2], wk[2:3], c["es"],
                                        c["zs"], kinks)
                ok = kinks.decisions[-1]  # shadow_terms' last: its hit test
                require(ok.dtype == torch.bool and ok.shape == term.shape,
                        "srt_work: the shadow hit test recorded")
                skip = srt.shadow_dead_terms(shw[lo:lo + chunk],
                                             c["srcs"][s], wk, c["es"],
                                             c["zs"])
                w["triples"] += term.numel()
                w["gated_s"] += int((~ok).sum())
                w["dead_f"] += int((ok & skip).sum())
                w["live_f"] += int((term != 0.0).sum())
                require(not (skip & (term != 0.0)).any(),
                        "srt_work: no triple of a term not 0 skipped")
                if dl is None:
                    continue
                act = (dl[s][keep] != 0.0).expand_as(term)
                live = act & (term != 0.0)
                dead = act & ok & srt.shadow_dead_triples(
                    shw[lo:lo + chunk], c["srcs"][s], wk, c["es"], c["zs"])
                w["act_s"] += int(act.sum())
                w["act_gated_s"] += int((act & ~ok).sum())
                w["dead_s"] += int(dead.sum())
                w["live_s"] += int(live.sum())
                require(not (dead & live).any(),
                        "srt_work: no triple of a term not 0 found dead")
    return w


def srt_bounds(c, w, masked: bool = False) -> dict:
    """K10a-K10i's (masked: K10b-K10j's) bounds on a srt_case with
    srt_work's counts w: each input read and each output written once
    (primary forward: 12 B in, 44 B out a ray; backward: 56 B in, 12 B out
    a ray, the table's gradient out; shadow: 12 B a point and 4 B a
    (source, point) each way, 8 B in and 12 B out backward; masked, the
    keep-mask read once too), against the operations of FLOPS_SRT_*: the
    gate alone for a gated pair or triple. The primary forward as
    redesigned: a pair it proves dead against the running carry 34
    (FLOPS_SRT_PRI_DEAD), another the gate passes its logit (40, _LOGIT)
    and, where its weight is not 0, the weight and the sums (_SUMS). The
    primary backward as
    redesigned: a pair primary_dead_pairs proves dead 34
    (FLOPS_SRT_PRI_DEAD), another the gate passes 41 (_W) and, where its
    weight is not 0, the derivative and its sums (_BWD). The shadow kernels as
    redesigned: 1e-3 |n| and 0.99 rr once a row and a point for each
    source ((Tp + R) S), a gated triple 10 operations
    (FLOPS_SRT_SHW_STAGED_GATE); forward, a triple the test skips 35
    (FLOPS_SRT_SHW_FWD_DEAD), another 46 (_FWD_LIVE); backward, of the
    triples whose d od is not 0, a dead one 31 (FLOPS_SRT_SHW_DEAD),
    another 36 (_STAGED_W) and, where its term is not 0, the derivative and
    its sums (FLOPS_SRT_SHW_BWD)."""
    Tp, R, S = c["pri"].shape[0], c["dirs"].shape[1], c["srcs"].shape[0]
    pmask = c["mask"].numel() * 4 if masked else 0
    smask = c["smask"].numel() * 4 if masked else 0
    hit_p = w["pairs"] - w["gated_p"]
    return {
        "pri_fwd": bound_ms(R * 56 + Tp * 128 + 12 + pmask,
                            FLOPS_SRT_PRI_GATE * w["gated_p"]
                            + FLOPS_SRT_PRI_DEAD * w["dead_pf"]
                            + FLOPS_SRT_PRI_LOGIT * (hit_p - w["dead_pf"])
                            + FLOPS_SRT_PRI_SUMS * w["live_p"]),
        "pri_bwd": bound_ms(R * 68 + Tp * 256 + 24 + pmask,
                            FLOPS_SRT_PRI_GATE * w["gated_p"]
                            + FLOPS_SRT_PRI_DEAD * w["dead_p"]
                            + FLOPS_SRT_PRI_W * (hit_p - w["dead_p"])
                            + FLOPS_SRT_PRI_BWD * w["live_p"]),
        "shw_fwd": bound_ms(R * (12 + 4 * S) + Tp * 64 + 12 * S + smask,
                            (Tp + R) * S
                            + FLOPS_SRT_SHW_STAGED_GATE * w["gated_s"]
                            + FLOPS_SRT_SHW_FWD_DEAD * w["dead_f"]
                            + FLOPS_SRT_SHW_FWD_LIVE
                            * (w["triples"] - w["gated_s"] - w["dead_f"])),
        "shw_bwd": bound_ms(R * (24 + 8 * S) + Tp * 128 + 24 * S + smask,
                            (Tp + R) * S
                            + FLOPS_SRT_SHW_STAGED_GATE * w["act_gated_s"]
                            + FLOPS_SRT_SHW_DEAD * w["dead_s"]
                            + FLOPS_SRT_SHW_STAGED_W
                            * (w["act_s"] - w["act_gated_s"] - w["dead_s"])
                            + FLOPS_SRT_SHW_BWD * w["live_s"]),
    }


def pri_item_work(c, m, masked: bool = False) -> dict:
    """K10c's (masked: K10d's) work on a srt_case, from the plain forms:
    the items its plan makes (srt.primary_bwd_items: how many, the chunks
    of the shortest, mean and longest, the tiles cut into more than one);
    of the (warp, row) units of the kept (tile, chunk) pairs, a warp on 32
    rays of a tile (K10d: a 4 x 8 pixel block of a 16 x 16 tile, K10c: 32
    consecutive rays), how many have a lane whose pair
    srt.primary_dead_pairs does not prove dead, and the share of their
    lanes that are; the (ray, chunk) pairs with a pair not proved dead."""
    from raytpu_torch.kernels import soft_raytrace as srt
    from raytpu_torch.kernels.intersect import TILE, ray_tiles
    pri, d, chunk = c["pri"], c["dirs"], c["chunk"]
    R, n_chunks = d.shape[1], pri.shape[0] // chunk
    tiles = c["tiles"] if masked else ray_tiles(R, None, d.device)
    mask = c["mask"] if masked else None
    items = srt.primary_bwd_items(None if mask is None else mask.cpu(),
                                  tiles.count, n_chunks)
    runs = [len(ch) for _, ch in items]
    per_tile = np.bincount([t for t, _ in items], minlength=tiles.count)
    tw = srt.THREADS // tiles.th
    b = torch.arange(tiles.count, device=d.device)[:, None]
    k = torch.arange(srt.THREADS, device=d.device)[None, :]
    tiles_x = -(-tiles.width // tw)
    valid = (((b // tiles_x) * tiles.th + k // tw < tiles.height)
             & ((b % tiles_x) * tw + k % tw < tiles.width))
    if tiles.th == TILE:  # csrc/soft_raytrace.cu::bwd_slot's 4 x 8 blocks
        wp = torch.arange(8, device=d.device)[:, None]
        ln = torch.arange(32, device=d.device)[None, :]
        slot = (((wp // 2) * 4 + ln // 8) * 16 + (wp % 2) * 8
                + ln % 8).reshape(-1)
    else:
        slot = torch.arange(srt.THREADS, device=d.device)
    rays = tiles.rays.view(tiles.count, srt.THREADS)[:, slot]
    valid = valid[:, slot]
    units = live_units = live_lanes = ray_chunks = 0
    with torch.no_grad():
        for ch in range(n_chunks):
            keep = (torch.arange(tiles.count, device=d.device) if mask is None
                    else torch.nonzero(mask[:, ch]).squeeze(1))
            if keep.numel() == 0:
                continue
            r = rays[keep].reshape(-1)
            ok = ~srt.primary_dead_pairs(pri[ch * chunk:(ch + 1) * chunk],
                                         d[:, r], m[r], c["es"], c["zs"])
            ok = (ok & valid[keep].reshape(1, -1)).view(chunk, -1, 32)
            units += ok.shape[0] * ok.shape[1]
            unit = ok.any(dim=-1)
            live_units += int(unit.sum())
            live_lanes += int(ok.sum())
            ray_chunks += int(ok.any(dim=0).sum())
    return dict(items=len(items), run_min=min(runs), run_mean=float(
        np.mean(runs)), run_max=max(runs),
        split_tiles=int((per_tile > 1).sum()), units=units,
        live_units=live_units,
        lane_share=live_lanes / max(32 * live_units, 1),
        ray_chunks=ray_chunks)


def pri_work_line(w, iw) -> str:
    """The fused primary backward's counts (srt_work's w, pri_item_work's
    iw) as printed by phases 22 and 28."""
    hit = w["pairs"] - w["gated_p"]
    return (f"{w['pairs']} pairs: {w['gated_p']} gated, {w['dead_p']} "
            f"proved dead ({w['dead_p'] / max(hit, 1):.4%} of the gate's "
            f"passing pairs), {hit - w['dead_p']} live (not proved dead), "
            f"{w['live_p']} of weight not 0; {iw['items']} items of "
            f"{iw['run_min']}-{iw['run_max']} chunks (mean "
            f"{iw['run_mean']:.2f}), {iw['split_tiles']} tiles cut into "
            f"more than one; (warp, row) units with a live lane "
            f"{iw['live_units']} of {iw['units']} "
            f"({iw['live_units'] / max(iw['units'], 1):.4%}), their lanes "
            f"{iw['lane_share']:.2%} live; (ray, chunk) pairs with a pair not "
            f"proved dead {iw['ray_chunks']}")


def two_launch_bounds(c, w) -> dict:
    """K10e, K10f, K10k and K10l's bounds on a srt_case with srt_work's
    unmasked counts w (the two-launch route takes no mask): each input
    read and each output written once (K10e: 56 B a ray and the table in,
    its gradient and d camera out; K10f: the same in, 12 B a ray out; K10k:
    12 + 8 S B a point and the table in, its gradient out; K10l: the same
    in, 12 B a point and d sources out), against srt_bounds' operations:
    each half does a pair's or triple's recompute, the derivative's shared
    chain and its own terms (FLOPS_SRT_*_TABLE, _DIRS, _RAYS), the tables
    halves also their share of the row's sums (18 primary, 14 shadow);
    K10e and K10f stop a pair proved dead at its test
    (FLOPS_SRT_PRI_DEAD), K10k and K10l a triple found dead at its test
    (FLOPS_SRT_SHW_DEAD), and form 1e-3 |n| and 0.99 rr once a row and a
    point for each source in place of once a triple (_STAGED_GATE,
    _STAGED_W)."""
    Tp, R, S = c["pri"].shape[0], c["dirs"].shape[1], c["srcs"].shape[0]
    hit_p = w["pairs"] - w["gated_p"]
    pri = (FLOPS_SRT_PRI_GATE * w["gated_p"]
           + FLOPS_SRT_PRI_DEAD * w["dead_p"]
           + FLOPS_SRT_PRI_W * (hit_p - w["dead_p"]))
    shw = ((Tp + R) * S
           + FLOPS_SRT_SHW_STAGED_GATE * w["act_gated_s"]
           + FLOPS_SRT_SHW_DEAD * w["dead_s"]
           + FLOPS_SRT_SHW_STAGED_W * (w["act_s"] - w["act_gated_s"]
                                       - w["dead_s"]))
    return {
        "pri_bwd_tables": bound_ms(
            R * 56 + Tp * 256 + 24,
            pri + (FLOPS_SRT_PRI_CHAIN + FLOPS_SRT_PRI_TABLE + 18)
            * w["live_p"]),
        "pri_bwd_dirs": bound_ms(
            R * 68 + Tp * 128 + 12,
            pri + (FLOPS_SRT_PRI_CHAIN + FLOPS_SRT_PRI_DIRS) * w["live_p"]),
        "shw_bwd_consts": bound_ms(
            R * (12 + 8 * S) + Tp * 128 + 12 * S,
            shw + (FLOPS_SRT_SHW_CHAIN + FLOPS_SRT_SHW_TABLE + 14)
            * w["live_s"]),
        "shw_bwd_rays": bound_ms(
            R * (24 + 8 * S) + Tp * 64 + 24 * S,
            shw + (FLOPS_SRT_SHW_CHAIN + FLOPS_SRT_SHW_RAYS) * w["live_s"]),
    }


def rule_by_group(got, want, groups) -> dict:
    """The JAX tests' rule, rtol 1e-4 / atol 1e-5 after scaling each column
    group by want's largest entry in it: {group: (largest |got - want|
    over that scale, every entry within the rule)}."""
    want = want.double()
    diff = (got.double() - want).abs()
    out = {}
    for group, lo, hi in groups:
        w, d = want[..., lo:hi], diff[..., lo:hi]
        scale = float(w.abs().max())
        ok = bool((d <= 1e-5 * scale + 1e-4 * w.abs()).all())
        out[group] = (float(d.max()) / scale if scale else float(d.max()), ok)
    return out


def one_signed(shape, device, seed: int) -> torch.Tensor:
    """Cotangents of one sign from a numpy seed (as phase 7's: signed ones
    cancel in the sums until float32 rounding decides the small ones)."""
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.uniform(0.5, 1.5, shape).astype(np.float32),
                        device=device)


@contextlib.contextmanager
def spy_frames(module, name: str):
    """Record every frame ``module.name`` (animate's renderer) returns, as
    the tensor the caller gets; no extra render, no extra launch."""
    real, frames = getattr(module, name), []

    def spy(*args):
        frames.append(real(*args))
        return frames[-1]

    setattr(module, name, spy)
    try:
        yield frames
    finally:
        setattr(module, name, real)


def check_written_frames(res, frames, border: int) -> None:
    """animate's frames: finite and lit (inside a ``border``), each written
    as the BMP of its quantized values."""
    from raytpu_torch.core.image import quantize_u8, read_bmp
    require(res.n_frames == len(frames) == len(res.paths),
            "one BMP a frame (save_every 1)")
    for frame, path in zip(frames, res.paths):
        inner = frame[border:frame.shape[0] - border,
                      border:frame.shape[1] - border]
        require(bool(torch.isfinite(frame).all())
                and float(inner.max()) > 0.3,
                "finite frame with a lit interior")
        require(np.array_equal(read_bmp(path),
                               quantize_u8(frame.cpu().numpy())),
                f"{path} holds its frame")


def delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def occlusion_case(dev, scene, camera, size: int, lights, samples: int,
                   masked: bool) -> dict:
    """K7b's or K7c's inputs as the sharded renderer's 1 x 1 block makes
    them for the first sub-ray of a size^2 frame: the single-card hit
    positions (K5 over the whole scene, the camera position on a miss),
    the sources' constants (light-major, sample-minor), the miss points
    and, masked, the port's 16 x 16 tiles and
    kernels/intersect.py::position_mask."""
    from raytpu_torch import RenderConfig
    from raytpu_torch.core.types import pixel_grid
    from raytpu_torch.kernels import intersect as isect
    from raytpu_torch.kernels.tables import source_table, tight_chunk
    from raytpu_torch.ops.intersect import tri_constants
    from raytpu_torch.ops.shade import source_positions
    from raytpu_torch.render.raytrace import camera_ray_dirs
    with torch.no_grad():
        cfg = RenderConfig(width=size, height=size)
        dirs = camera_ray_dirs(*pixel_grid(size, size, dev), camera, cfg)
        c = tri_constants(scene, camera.pos)
        t, idx = isect.closest_hit(dirs, c.m, c.k0, c.valid)
        pos = camera.pos + torch.where(idx >= 0, t, 0.0)[:, None] * dirs
        src = source_positions(lights, samples).contiguous()
        cs = tri_constants(scene, src)
        C = tight_chunk(scene.num_triangles, cfg.tri_chunk)
        case = dict(pos=pos.contiguous(), m_s=cs.m, k0_s=cs.k0, src=src,
                    valid=scene.active, C=C, tri_chunk=cfg.tri_chunk,
                    table=source_table(cs.m, cs.k0, scene.active, C),
                    mask=None, tiles=None, miss=idx < 0,
                    hit=float((idx >= 0).float().mean()))
        if masked:
            case["tiles"] = isect.ray_tiles(size * size, (size, size), dev)
            case["mask"] = isect.position_mask(
                pos, case["tiles"], (scene.v0, scene.v1, scene.v2),
                scene.active, src, C)
    return case


def run_occlusion(case: dict, mask="own", plain: bool = False):
    """K7b (no mask) or K7c on an occlusion_case through the wrapper, or
    the plain version; ``mask`` None forces K7b."""
    from raytpu_torch.kernels import intersect as isect
    c = case
    mask = c["mask"] if isinstance(mask, str) else mask
    if plain:
        if mask is None:
            return isect.occlusion_reference(c["pos"], c["table"], c["C"],
                                             c["src"])
        return isect.occlusion_masked_reference(c["pos"], c["table"], c["C"],
                                                c["src"], mask, c["tiles"])
    return isect.occlusion_multi(c["pos"], c["m_s"], c["k0_s"], c["src"],
                                 c["valid"], c["tri_chunk"], mask,
                                 c["tiles"])


def occlusion_work(case: dict, run: int | None = None) -> dict:
    """The tests K7b or K7c make on an occlusion_case, counted with the plain
    forms on the case's tensors: each point (a miss's camera-origin point
    too), for each source, through the chunks its tile keeps (every chunk,
    K7b) in order, up to its first blocker (t < 0.99): ``tests``, of them
    ``rejected`` the ones the exact reject decides (the plain
    kernels/intersect.py::shadow_reject) and ``miss_tests`` those of miss
    points; ``reject_wrong`` every test of the sweeps, to the end of each
    chunk, that the reject rejects and plane_tests calls blocking (it must
    be 0). On the items route (a mask, or several chunks) a work item sweeps
    a run of ``run`` kept chunks of a (tile, source) pair afresh, so a point
    blocked in an earlier run sweeps the next to its own first blocker:
    ``item_tests`` counts those (the kernel stops a lane whose bit another
    item has set, which this count cannot see), ``entries`` and ``items``
    (8 warps an entry) what kernels/intersect.py::occlusion_plan lists, of
    the kernel's ``grid`` of (runs, pairs, warps) slots; ``follower_tests``
    the tests of the warps whose points all equal an earlier warp's of
    their tile (kernels/intersect.py::occlusion_leaders), which the items
    do not sweep. ``distinct_tests`` and ``distinct_rejected`` count each
    tile's distinct points once (bit for bit; a miss's point is the camera
    position): the work the points need (occlusion_bound). A warp runs
    until its longest lane is done: ``warp_tests`` is 32 times the longest
    lane's tests summed over the items (K7b on one chunk: over each warp's
    sources), ``longest`` the most tests a lane makes in one item."""
    from raytpu_torch.kernels import intersect as isect
    from raytpu_torch.ops.intersect import plane_tests
    from raytpu_torch.ops.shade import SHADOW_T
    c = case
    run = isect.occlusion_run(c["src"].shape[0]) if run is None else run
    R, C, S = c["pos"].shape[0], c["C"], c["src"].shape[0]
    n = c["table"].shape[1] // C
    dev = c["pos"].device
    items = isect.occlusion_items_route(c["table"].shape[1], C, c["mask"])
    tiles = c["tiles"] or isect.ray_tiles(R, None, dev)
    cols = torch.arange(C, device=dev)[None, :]
    work = dict(tests=0, rejected=0, miss_tests=0, reject_wrong=0,
                item_tests=0, entries=0, items=0, grid=0, warp_tests=0,
                longest=0, follower_tests=0, distinct_tests=0,
                distinct_rejected=0, run=run if items else None)
    # The warp of each point (its tile's slot over 32), the points of
    # follower warps, and each tile's first point of each bit pattern.
    warp = torch.empty(R, dtype=torch.long, device=dev)
    warp[tiles.rays] = torch.arange(tiles.rays.numel(), device=dev) // 32
    lead = isect.occlusion_leaders(c["pos"], tiles).reshape(-1)
    follower = lead[warp] != warp % (isect.TILE_RAYS // 32)
    if not items:
        follower[:] = False
    key = torch.cat([tiles.tile[:, None],
                     c["pos"].view(torch.int32).long()], dim=1)
    _, group = torch.unique(key, dim=0, return_inverse=True)
    at = torch.arange(R, device=dev)
    first = torch.full((int(group.max()) + 1,), R, dtype=torch.long,
                       device=dev).scatter_reduce_(0, group, at, "amin")
    distinct = first[group] == at
    n_runs = -(-n // run)
    for s in range(S):
        sweeping = torch.ones(R, dtype=torch.bool, device=dev)
        in_run = torch.ones(R, dtype=torch.bool, device=dev)
        rank = torch.zeros(R, dtype=torch.long, device=dev)
        lane = torch.zeros((R, n_runs), dtype=torch.long, device=dev)
        for ch in range(n):
            keep = torch.ones(R, dtype=torch.bool, device=dev)
            if c["mask"] is not None:
                keep = c["mask"][tiles.tile, s * n + ch] != 0
            # A new run starts at every run-th kept chunk of the tile.
            in_run |= keep & (rank % run == 0)
            j = rank // run
            rank += keep.long()
            rows = torch.nonzero(keep & in_run).squeeze(1)
            if rows.numel() == 0:
                continue
            ts, oks = plane_tests(c["pos"][rows] - c["src"][s][None, :],
                                  *isect._chunk(c["table"], s, ch, C))
            blocked = oks & (ts < SHADOW_T)
            any_ = blocked.any(dim=1)
            first = blocked.float().argmax(dim=1) + 1
            tests = torch.where(any_, first, C)
            seq = sweeping[rows]
            reject = isect.shadow_reject(
                c["pos"][rows] - c["src"][s][None, :],
                *isect._chunk(c["table"], s, ch, C))
            work["item_tests"] += int(tests.sum())
            lane[rows, j[rows]] += tests if items else torch.where(seq, tests,
                                                                   0)
            work["tests"] += int(tests[seq].sum())
            work["miss_tests"] += int(tests[seq & c["miss"][rows]].sum())
            decided = (reject & (cols < tests[:, None])).sum(dim=1)
            work["rejected"] += int(decided[seq].sum())
            one = seq & distinct[rows]
            work["distinct_tests"] += int(tests[one].sum())
            work["distinct_rejected"] += int(decided[one].sum())
            work["follower_tests"] += int(tests[follower[rows]].sum())
            work["reject_wrong"] += int((reject & blocked).sum())
            sweeping[rows[any_]] = False
            in_run[rows[any_]] = False
        longest = torch.zeros((tiles.rays.numel() // 32, n_runs),
                              dtype=torch.long, device=dev)
        at = warp[:, None] * n_runs + torch.arange(n_runs, device=dev)
        longest.view(-1).scatter_reduce_(0, at.reshape(-1), lane.reshape(-1),
                                         "amax")
        work["warp_tests"] += 32 * int(longest.sum())
        work["longest"] = max(work["longest"], int(longest.max()))
    if items:
        plan = isect.occlusion_plan(c["mask"], tiles.count, S, n, run)
        work.update(entries=int(plan.shape[0]),
                    items=int(plan.shape[0]) * isect.TILE_RAYS // 32,
                    grid=n_runs * tiles.count * S * isect.TILE_RAYS // 32)
    else:
        work["item_tests"] = work["tests"]
    return work


def occlusion_work_line(w: dict) -> str:
    t = max(1, w["tests"])
    route = (f"{w['entries']} entries of runs of {w['run']} chunks, "
             f"{w['items']} warp items of a grid of {w['grid']}, "
             f"{w['item_tests']} tests in them at most"
             if w["run"] is not None else "one chunk: a thread a point")
    route += (f"; the warps' longest lanes {w['warp_tests']} tests (lane use "
              f"{w['item_tests'] / max(1, w['warp_tests']):.4f}), the "
              f"longest lane of an item {w['longest']}")
    return (f"{w['tests']} tests to the first blocker, the reject decides "
            f"{w['rejected']} ({w['rejected'] / t:.6f}), miss points' "
            f"{w['miss_tests']} ({w['miss_tests'] / t:.4f}), each tile's "
            f"distinct points' {w['distinct_tests']}, blocking tests "
            f"rejected {w['reject_wrong']}; {route}, of them in warps that "
            f"follow another {w['follower_tests']}")


def occlusion_bound(case: dict, work: dict, reject: bool = True,
                    distinct: bool = True) -> tuple[float, str]:
    """K7b's or K7c's bound: 12 B in and 4 S B out a point, the table, the
    sources and the mask read once; since their redesign FLOPS_REJECT a test
    of each tile's distinct points (occlusion_work) and, where the reject
    does not decide, a plane test's FLOPS_PLANE_TEST besides (``reject``
    False: every point's every test a plane test, the count before the
    redesign; ``distinct`` False: every point's tests with the reject)."""
    c = case
    R, S = c["pos"].shape[0], c["src"].shape[0]
    nbytes = R * (12 + 4 * S) + (c["table"].numel() + 3 * S) * 4
    if c["mask"] is not None:
        nbytes += c["mask"].numel() * 4
    flops = FLOPS_PLANE_TEST * work["tests"]
    if reject:
        tests, rejected = ((work["distinct_tests"], work["distinct_rejected"])
                           if distinct else (work["tests"], work["rejected"]))
        flops = FLOPS_REJECT * tests + FLOPS_PLANE_TEST * (tests - rejected)
    return bound_ms(nbytes, flops)


def occlusion_cases(dev, mesh9028) -> dict:
    """Phase 29's K7b and K7c cases (occlusion_case), on the 9,028-triangle
    mesh ``mesh9028`` for K7c."""
    from raytpu_torch import Camera, Lights, cornell_box
    one = Lights.single(capacity=1, device=dev)
    return {
        # K7b: the 512^2 Cornell frame's hit points toward the bench's
        # full-feature sources (2 lights x 16 samples, S = 32).
        "cornell_512_s32": occlusion_case(
            dev, cornell_box(pad_to=32, device=dev),
            Camera.raytracer_default(device=dev), 512,
            full_feature_lights(dev), 16, masked=False),
        # K7b: the clean 512^2 Cornell frame's points toward its one light
        # (S = 1): phase 30's clean sub-ray and phase 31's clean step.
        "cornell_512_s1": occlusion_case(
            dev, cornell_box(pad_to=32, device=dev),
            Camera.raytracer_default(device=dev), 512, one, 1,
            masked=False),
        # K7c: the bench's stl_intersect frame (the mesh padded to 9,216 at
        # 512^2, the rasteriser camera), S = 1 and S = 16.
        "stl_512_s1": occlusion_case(
            dev, mesh9028.pad_to(9216), Camera.rasterizer_default(device=dev),
            512, one, 1, masked=True),
        "stl_512_s16": occlusion_case(
            dev, mesh9028.pad_to(9216), Camera.rasterizer_default(device=dev),
            512, Lights.single(capacity=1, soft_samples=16, device=dev), 16,
            masked=True),
    }


def stl_lit_frame(dev, mesh9028):
    """Phase 30's sharded STL frame: the mesh at 512^2 clean from the render
    CLI's STL camera, one light in front of it."""
    from raytpu_torch import Lights, RenderConfig
    return (mesh9028, stl_camera(dev),
            Lights.single(capacity=1, position=(0.3, -1.5, -3.0), device=dev),
            RenderConfig(width=512, height=512, mode="clean"))


def sharded_phases(dev, stl_path, record: dict) -> list[dict]:
    """Phases 29-31: K7b, K7c and K8a against their plain versions, the
    sharded serving frames and the sharded train step and fit on a 1 x 1
    NCCL mesh. Returns the three kernels' entries of the kernels line."""
    from raytpu_torch import Camera, Lights, RenderConfig, cornell_box
    from raytpu_torch import load_stl
    from raytpu_torch.cli.main import main as cli_main
    from raytpu_torch.kernels import intersect as isect
    from raytpu_torch.kernels import raster
    from raytpu_torch.opt.fit import FitConfig, fit
    from raytpu_torch.parallel import (
        init_distributed,
        make_mesh,
        shutdown_distributed,
    )
    from raytpu_torch.parallel import render as pr
    from raytpu_torch.render.raytrace import raytrace_full
    from raytpu_torch.render.soft import (
        rasterize_exact,
        rasterize_soft,
        raytrace_soft,
    )

    say("== phase 29: K7b, K7c and K8a against their plain versions on the "
        "card")
    mesh9028 = load_stl(str(stl_path), device=dev)
    one = Lights.single(capacity=1, device=dev)
    occ_cases = occlusion_cases(dev, mesh9028)
    err = {"k7b": 0.0, "k7c": 0.0, "k8a": 0.0}
    occ_work = {}
    zero_counts()
    for name, c in occ_cases.items():
        key = "k7b" if c["mask"] is None else "k7c"
        before = kernel_counts()
        got, again = run_occlusion(c), run_occlusion(c)
        launched = delta(before, kernel_counts())
        want = run_occlusion(c, plain=True)
        brute = run_occlusion(c, mask=None) if key == "k7c" else got
        torch.cuda.synchronize()
        mism = int((got != want).sum())
        keep = (float(c["mask"].float().mean()) if c["mask"] is not None
                else 1.0)
        say(f"{key.upper()} {name} (S = {c['src'].shape[0]}, {c['C']}-"
            f"triangle chunks of {c['table'].shape[1]}, keep rate "
            f"{keep:.4f}, hit points {c['hit']:.4f}): mismatches vs plain "
            f"{mism}, = K7b {torch.equal(got, brute)}, two calls identical "
            f"{torch.equal(got, again)}; occluded {int(got.sum())}; launches "
            f"{launched}")
        require(mism == 0, f"{name}: {key.upper()} bit-identical to plain")
        require(torch.equal(got, brute), f"{name}: culled K7c = K7b")
        require(torch.equal(got, again), f"{name}: two calls identical")
        require(bool(got.any()) and not bool(got.all()),
                f"{name}: some points occluded, not all")
        want_l = {"occlusion" if key == "k7b" else "occlusion_masked": 2}
        require(launched == want_l, f"{name}: exact launch counts")
        err[key] = max(err[key], float((got - want).abs().max()))
        del again, want, brute
        occ_work[name] = occlusion_work(c)
        say(f"  {name} work: {occlusion_work_line(occ_work[name])}")
        require(occ_work[name]["reject_wrong"] == 0,
                f"{name}: the reject rejects no blocking test, miss points "
                f"included")

    k8_frame = stl_frame(dev, stl_path, 512)
    k8 = raster_case(k8_frame[0], k8_frame[1], k8_frame[3])
    consts = k8["consts"]
    before = kernel_counts()
    full = raster.raster_winner_chunked(consts, 512, 512, 128)
    full_again = raster.raster_winner_chunked(consts, 512, 512, 128)
    half = raster.raster_winner_chunked(consts, 256, 512, 128, y0=256)
    launched = delta(before, kernel_counts())
    want_full = raster.resolve_winner_chunked_reference(consts, 512, 512, 128)
    want_half = raster.resolve_winner_chunked_reference(consts, 256, 512, 128,
                                                        y0=256)
    masked = run_winner(k8)
    torch.cuda.synchronize()
    say(f"K8a on the mesh at 512^2 (T = {consts.shape[0]}, "
        f"{-(-consts.shape[0] // 128)} chunks): winner mismatches vs plain "
        f"{int((full != want_full).sum())}, the lower half (y0 = 256) "
        f"{int((half != want_half).sum())}, = the frame's rows "
        f"{torch.equal(half, full[256 * 512:])}, = K8c "
        f"{torch.equal(full, masked)}, two calls identical "
        f"{torch.equal(full, full_again)}; covered "
        f"{float((full >= 0).float().mean()):.4f}; launches {launched}")
    require(torch.equal(full, want_full) and torch.equal(half, want_half),
            "K8a bit-identical to plain at y0 = 0 and 256")
    require(torch.equal(half, full[256 * 512:]) and torch.equal(full, masked)
            and torch.equal(full, full_again),
            "K8a's half block = the frame's rows = K8c; repeats identical")
    require(launched == {"raster_winner_chunked": 3},
            "exactly three K8a launches")
    require(bool((full >= 0).any()), "the mesh is in view")
    k8a_work = winner_work(consts, 512, 512)
    for y0 in (0, 256):
        probe = raster.raster_cull_probe(consts, 512 - y0, 512, y0)
        plain = (k8a_work if y0 == 0 else
                 winner_work(consts, 256, 512, y0=256))["all_rejected"]
        say(f"K8a's cull at y0 = {y0}: the card's probe rejects "
            f"{probe['rejected']} of {probe['pairs']} (tile, row) pairs "
            f"(plain form {plain}), covered pixels among them "
            f"{probe['covered']}")
        require(probe["covered"] == 0 and probe["rejected"] == plain,
                "K8a's cull rejects no covering row, as its plain form")
    say(f"K8a's work on the mesh: {winner_work_line(k8a_work)}")
    record["k8a_cull"] = k8a_work
    del full_again, want_full, want_half, masked, half

    say("== phase 30: sharded serving on a 1 x 1 NCCL mesh")
    state = init_distributed()
    mesh = make_mesh(1, 1)
    say(f"process group: {state.backend}, world {state.num_processes}, rank "
        f"{state.process_id} on {state.device}; mesh {mesh}")
    require(state.backend == "nccl" and state.num_processes == 1,
            "one NCCL rank")
    hard_frames = {"clean_512": bench_frame(dev, 512),
                   "full_feature_512": full_feature_frame(dev, 512),
                   "stl_512": stl_lit_frame(dev, mesh9028)}
    raster_frames = {"raster_512": raster_bench_frame(dev, 512),
                     "raster_stl_512": k8_frame}
    soft40 = dict(mode="soft", soft_edge_sharpness=40.0,
                  soft_z_sharpness=40.0)
    soft_frames = {
        "soft_rasterize_512": (
            cornell_box(pad_to=32, device=dev),
            Camera.rasterizer_default(device=dev), one,
            RenderConfig(width=512, height=512, **soft40)),
        "soft_raytrace_512": (
            cornell_box(pad_to=32, device=dev),
            Camera.raytracer_default(device=dev), one,
            RenderConfig(width=512, height=512, **soft40))}
    sharded = {}
    for name, f in hard_frames.items():
        sharded[name] = (pr.make_sharded_render(mesh, f[3]), f)
    for name, f in raster_frames.items():
        sharded[name] = (pr.make_sharded_rasterize(mesh, f[3]), f)
    for name, f in soft_frames.items():
        sharded[name] = (pr.make_sharded_soft_render(
            mesh, f[3], name.split("_")[1]), f)
    zero_counts()
    with torch.no_grad():
        images = {name: fn(*f[:3]) for name, (fn, f) in sharded.items()}
    torch.cuda.synchronize()
    serve = {k: v for k, v in kernel_counts().items() if v}
    say(f"sharded serving, 7 frames: launches {serve}")
    require(serve == {"closest_hit": 10, "occlusion": 10,
                      "closest_hit_masked": 1, "occlusion_masked": 1,
                      "raster_winner": 1, "raster_winner_chunked": 1,
                      "soft_raster_fwd": 1, "soft_rt_pri_fwd": 1,
                      "soft_rt_shw_fwd": 1},
            "the sharded frames launch K5 + K7b (1 + 9 sub-rays), K7d + "
            "K7c, K8b, K8a, K9a, K10a + K10g, nothing else")

    def single(name, f):
        s, c, li, cfg = f
        if name in hard_frames:
            return raytrace_full(s, c, li, cfg).image
        if name in raster_frames:
            return rasterize_exact(s, c, li, cfg)
        return (rasterize_soft if "rasterize" in name else raytrace_soft)(
            s, c, li, cfg)

    frame_err, frame_ms = {}, {}
    for name, (fn, f) in sharded.items():
        with torch.no_grad():
            want = single(name, f)
            diff = (images[name] - want).abs()
            soft = name.startswith("soft")
            tol = 1e-6 + (1e-5 * want.abs() if soft else 0.0)
            frame_err[name] = float(diff.max())
            require(bool((diff <= tol).all()) and bool(
                torch.isfinite(images[name]).all()),
                f"{name}: the sharded frame = the single-card frame within "
                f"{'atol 1e-6 / rtol 1e-5' if soft else 'atol 1e-6'}")
            require(float(images[name].max()) > 0.0, f"{name}: not black")
            frame_ms[name] = median_ms_in_turns(
                {"sharded": lambda fn=fn, f=f: fn(*f[:3]),
                 "single": lambda name=name, f=f: single(name, f)},
                n=1, reps=5)
    del images
    card = card_line()
    for name, t in frame_ms.items():
        say(f"{name}: max |sharded - single| {frame_err[name]:.3g}; "
            f"{t['sharded']:.4f} ms a sharded frame, {t['single']:.4f} ms "
            f"the single-card frame (CUDA events, median of 5; {card})")
    # Where the full-feature and STL frames' time goes, sharded and
    # single-card.
    frame_busy = {}
    for name in ("full_feature_512", "stl_512"):
        fn, f = sharded[name]
        with torch.no_grad():
            frame_busy[name] = {
                "sharded": device_busy(lambda fn=fn, f=f: fn(*f[:3]),
                                       steps=3),
                "single": device_busy(
                    lambda name=name, f=f: single(name, f), steps=3)}
        for side, b in frame_busy[name].items():
            say(f"{name} {side} frame under the profiler: device busy "
                f"{b['busy_ms']:.4f} ms a frame in {b['kernels']} events, "
                f"{b['wall_ms']:.4f} ms on the host clock (share "
                f"{b['share']})")
            for kname, ms in b["by_name"][:6]:
                say(f"  {ms:.5f} ms  {kname[:100]}")

    say("== phase 31: the sharded train step and fit on 1 x 1")
    rng = np.random.default_rng(31)
    steps = {
        "clean_512": (bench_frame(dev, 512), "raytrace", None),
        "soft_rasterize_512": (soft_frames["soft_rasterize_512"],
                               "rasterize", rasterize_soft),
        "soft_raytrace_512": (soft_frames["soft_raytrace_512"], "raytrace",
                              raytrace_soft)}
    step_err, step_fns, train_launches = {}, {}, {}
    for name, (f, renderer, soft_fn) in steps.items():
        s, c, li, cfg = f
        target = torch.tensor(rng.uniform(0.0, 0.5, (512, 512, 3)).astype(
            np.float32), device=dev)
        train, _ = pr.make_sharded_train_step(mesh, cfg, renderer=renderer)
        st = pr.train_state(s, li, lambda p: torch.optim.SGD(p, lr=1e-9))
        ref = pr.train_state(s, li, lambda p: torch.optim.SGD(p, lr=1e-9))
        if soft_fn is None:
            # The single-card loop branch: the sharded block's own ops.
            ref_cfg = cfg.replace(megakernel=False)

            def ref_img(st_, c=c, cfg_=ref_cfg):
                return raytrace_full(st_.scene, c, st_.lights, cfg_).image
        else:
            def ref_img(st_, c=c, cfg_=cfg, fn=soft_fn):
                return fn(st_.scene, c, st_.lights, cfg_)

        def ref_step(st_=ref, ref_img=ref_img, target=target):
            for p in pr.leaves(st_.scene, st_.lights):
                p.grad = None
            loss = torch.mean((ref_img(st_) - target) ** 2)
            loss.backward()
            st_.optimizer.step()
            return loss.detach()

        zero_counts()
        loss = train(st, c, target)
        torch.cuda.synchronize()
        train_launches[name] = {k: v for k, v in kernel_counts().items()
                                if v}
        want_loss = ref_step()
        worst = 0.0  # the largest error as a fraction of its tolerance
        for i, (g, w) in enumerate(zip(
                (p.grad for p in pr.leaves(st.scene, st.lights)),
                (p.grad for p in pr.leaves(ref.scene, ref.lights)))):
            w = torch.zeros_like(g) if w is None else w
            require(bool(torch.isfinite(g).all()), f"{name}: finite grad")
            # The soft leaves scaled by their largest entry, as the CPU
            # tests hold them (tests/test_torch_parallel.py).
            scale = (max(float(w.abs().max()), 1e-3) if soft_fn is not None
                     else 1.0)
            frac = ((g - w).abs() / scale) / (GRAD_ATOL
                                             + GRAD_RTOL * w.abs() / scale)
            worst = max(worst, float(frac.max()))
            require(bool((frac <= 1.0).all()),
                    f"{name}: leaf {i}'s gradient = the single-card step's "
                    f"(rtol {GRAD_RTOL} / atol {GRAD_ATOL})")
        lrel = abs(float(loss) - float(want_loss)) / float(want_loss)
        require(lrel <= GRAD_RTOL, f"{name}: loss = the single-card loss")
        step_err[name] = dict(loss=float(loss), single_loss=float(want_loss),
                              loss_rel=lrel, grad_of_tolerance=worst)
        step_fns[name] = (lambda train=train, st=st, c=c, target=target:
                          train(st, c, target), ref_step)
        say(f"{name} sharded step: loss {float(loss):.8g} (single-card "
            f"{float(want_loss):.8g}, rel {lrel:.3g}); every gradient within "
            f"the rule (worst {worst:.3g} of the tolerance); launches "
            f"{train_launches[name]}")
    require(train_launches == {
        "clean_512": {"closest_hit": 1, "occlusion": 1},
        "soft_rasterize_512": {"soft_raster_fwd": 1, "soft_raster_bwd": 1},
        "soft_raytrace_512": {"soft_rt_pri_fwd": 1, "soft_rt_pri_bwd": 1,
                              "soft_rt_shw_fwd": 1, "soft_rt_shw_bwd": 1}},
        "each sharded step launches exactly its kernels once")
    step_ms, step_busy, step_peak = {}, {}, {}
    for name, (fn, ref_fn) in step_fns.items():
        step_ms[name] = median_ms_in_turns({"sharded": fn, "single": ref_fn},
                                           n=1, reps=5)
        step_busy[name] = device_busy(fn, steps=3)
        step_peak[name] = {}
        for side, f_ in (("sharded", fn), ("single", ref_fn)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            f_()
            torch.cuda.synchronize()
            step_peak[name][side] = torch.cuda.max_memory_allocated() / 1e9
    card = card_line()
    for name in step_fns:
        b = step_busy[name]
        say(f"{name}: sharded step {step_ms[name]['sharded']:.4f} ms, "
            f"single-card {step_ms[name]['single']:.4f} ms (median of 5); "
            f"device busy {b['busy_ms']:.4f} ms a step in {b['kernels']} "
            f"events, {b['wall_ms']:.4f} ms on the host clock under the "
            f"profiler (share {b['share']}); peak "
            f"{step_peak[name]['sharded']:.3f} GB (single-card "
            f"{step_peak[name]['single']:.3f} GB) ({card})")
        for kname, ms in b["by_name"][:5]:
            say(f"  {ms:.5f} ms  {kname[:100]}")

    # fit(mesh=...) against fit: 6 steps of the fit CLI's frame at 128^2.
    from raytpu_torch.core.image import read_bmp, write_bmp
    fit_cam = Camera.make((0.0, 0.0, -3.0), focal=128.0, y_scale=1.01,
                          device=dev)
    fit_cfg_r = RenderConfig(width=128, height=128, mode="soft")
    with torch.no_grad():
        fit_target = rasterize_soft(cornell_box(device=dev), fit_cam, one,
                                    fit_cfg_r.replace(
                                        soft_edge_sharpness=40.0,
                                        soft_z_sharpness=200.0))

    def run_fit(m):
        return fit(fit_target, cornell_box(device=dev), fit_cam,
                   Lights.single(capacity=1, intensity=10.0, device=dev),
                   fit_cfg_r, FitConfig(steps=6),
                   mesh=m).losses

    zero_counts()
    fit_sharded = run_fit(mesh)
    fit_launches = {k: v for k, v in kernel_counts().items() if v}
    fit_single = run_fit(None)
    require(np.allclose(fit_sharded, fit_single, rtol=1e-4, atol=0.0),
            "fit(mesh=1x1) follows fit at rtol 1e-4")
    require(fit_launches == {"soft_raster_fwd": 6, "soft_raster_bwd": 6},
            "one K9a and one K9c a sharded fit step")
    say(f"fit(mesh=1x1), 6 steps at 128^2: losses {fit_sharded.tolist()} "
        f"(fit: {fit_single.tolist()}); launches {fit_launches}")
    target_bmp = OUT / "sharded_fit_target.bmp"
    write_bmp(str(target_bmp), fit_target.cpu().numpy())
    cli_out = OUT / "sharded_fit.bmp"
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        cli_main(["fit", str(target_bmp), "--steps", "4", "--mesh", "1x1",
                  "-o", str(cli_out)])  # shuts the process group down
    # fit() on what the CLI reads: the BMP's u8 target, focal = its width.
    want_line = fit(read_bmp(str(target_bmp)).astype(np.float32) / 255.0,
                    cornell_box(device=dev), fit_cam,
                    Lights.single(capacity=1, intensity=10.0, device=dev),
                    fit_cfg_r, FitConfig(steps=4)).losses[-1]
    say(f"fit --mesh 1x1: {printed.getvalue().strip()!r} (fit: final loss "
        f"{want_line:.6f})")
    require(f"final loss: {want_line:.6f}" in printed.getvalue()
            and cli_out.exists(), "fit --mesh 1x1 prints fit's final loss "
                                  "and writes its frame")
    shutdown_distributed()

    record.update(sharded_err=err, sharded_serve=serve,
                  sharded_frame_err=frame_err, sharded_frame_ms=frame_ms,
                  sharded_frame_busy=frame_busy,
                  sharded_steps=step_err, sharded_train=train_launches,
                  sharded_step_ms=step_ms, sharded_step_busy=step_busy,
                  sharded_step_peak=step_peak,
                  sharded_fit=[fit_sharded.tolist(), fit_single.tolist()])

    # Card numbers of the kernels alone.
    timings = {}
    for name, c in occ_cases.items():
        t = median_ms_in_turns({"kernel": lambda c=c: run_occlusion(c)},
                               n=5, reps=5, timer=held_ms)
        t.update(median_ms_in_turns(
            {"plain": lambda c=c: run_occlusion(c, plain=True)}, n=1,
            reps=1))
        t["bound"] = occlusion_bound(c, occ_work[name])
        t["bound_first_count"] = occlusion_bound(c, occ_work[name],
                                                 reject=False)
        t["bound_every_point"] = occlusion_bound(c, occ_work[name],
                                                 distinct=False)
        t["work"] = occ_work[name]
        timings[name] = t
    t = median_ms_in_turns(
        {"kernel": lambda: raster.raster_winner_chunked(consts, 512, 512,
                                                        128)},
        n=5, reps=5, timer=held_ms)
    t.update(median_ms_in_turns(
        {"plain": lambda: raster.resolve_winner_chunked_reference(
            consts, 512, 512, 128)}, n=1, reps=1))
    k8_case = dict(consts=consts, H=512, W=512, mask=None, chunk=128)
    t["bound"] = winner_bound(k8_case, k8a_work)
    t["bound_before"] = winner_bound(k8_case)
    timings["k8a_stl_512"] = t
    card = card_line()
    for name, t in timings.items():
        first = (f", {t['bound_every_point'][0]:.4f} ms on every point's "
                 f"tests, {t['bound_first_count'][0]:.4f} ms counting every "
                 f"test a plane test" if "bound_first_count" in t else
                 f", before the cull {t['bound_before'][0]:.4f} ms"
                 if "bound_before" in t else "")
        say(f"{name}: kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} "
            f"ms, bound {t['bound'][0]:.4f} ms ({t['bound'][1]}){first} "
            f"({card})")
    record["sharded_kernels"] = timings

    def entry(name, key, case, launches, replaces, extra=None):
        t = timings[case]
        e = dict(name=name, route="cuda",
                 source=("raytpu_torch/csrc/raster.cu" if key == "k8a"
                         else "raytpu_torch/csrc/intersect.cu"),
                 replaces=replaces, launches=launches, max_abs_err=err[key],
                 ms=t["kernel"], plain_ms=t["plain"], bound_ms=t["bound"][0],
                 bound_by=t["bound"][1], library_ms=None)
        if extra is not None:
            x = timings[extra]
            e[extra] = dict(ms=x["kernel"], plain_ms=x["plain"],
                            bound_ms=x["bound"][0], bound_by=x["bound"][1])
        return e

    return [
        entry("occlusion", "k7b", "cornell_512_s32", serve["occlusion"],
              replaces="raytpu/kernels/intersect_pallas.py:912",
              extra="cornell_512_s1"),
        entry("occlusion_masked", "k7c", "stl_512_s1",
              serve["occlusion_masked"],
              replaces="raytpu/kernels/intersect_pallas.py:950",
              extra="stl_512_s16"),
        entry("raster_winner_chunked", "k8a", "k8a_stl_512",
              serve["raster_winner_chunked"],
              replaces="raytpu/kernels/raster_pallas.py:39"),
    ]


# The first design's card numbers at 512^2 on the 66,560-triangle torus
# (PERF.md §6, NVIDIA H100 80GB HBM3, 700 W), printed beside this run's:
# K10e and K10f's (a block a chunk, every pair's logit worked out in full)
# and the culled step's with them; K10k and K10l's (a block a chunk, and a
# thread a point with every chunk staged in every block; every triple's
# sigmoids worked out in full), measured after K10e and K10f's redesign,
# and the culled step's with those.
FIRST_DESIGN_MS = {"pri_bwd_tables": 126.4583, "pri_bwd_dirs": 79.7943,
                   "culled_step": 336.37, "shw_bwd_consts": 84.5155,
                   "shw_bwd_rays": 65.0146, "culled_step_pr13": 206.0834}


def two_launch_phase(dev, record: dict) -> list[dict]:
    """Phase 32: K10e, K10f, K10k and K10l, the two-launch soft raytrace
    backwards, against their plain versions on the 66,560-triangle torus;
    the paths that take them (the culled 512^2 soft raytrace step on 66,560
    and 36,000 triangles, fit(renderer="raytrace"), the sharded step on a
    1 x 1 NCCL mesh) with exact launches; their card numbers beside the
    fused K10c and K10i on the same inputs. Returns their entries of the
    kernels line."""
    from raytpu_torch import Camera, Lights, RenderConfig, load_stl
    from raytpu_torch.core.stl import procedural_stl_text
    from raytpu_torch.kernels import soft_raytrace as srt
    from raytpu_torch.opt.fit import FitConfig, fit
    from raytpu_torch.parallel import (
        init_distributed,
        make_mesh,
        shutdown_distributed,
    )
    from raytpu_torch.parallel import render as pr
    from raytpu_torch.render.soft import raytrace_soft

    say("== phase 32: K10e, K10f, K10k and K10l (the two-launch soft "
        "raytrace backwards) on meshes above 32,768 / 65,536 triangles")
    t_phase = time.perf_counter()
    geometry = {}
    for quads in ((256, 130), (200, 90)):  # 2 n_major n_minor triangles
        path = OUT / f"torus_{quads[0]}x{quads[1]}.stl"
        path.write_text(procedural_stl_text(*quads))
        mesh = load_stl(str(path), device=dev)
        geometry[mesh.num_triangles] = mesh
    require(sorted(geometry) == [36000, 66560], "the tori's sizes")

    def frame(T: int, size: int):
        """bench.py's soft_raytrace_stl frame (`bench.py:644-676`) on the
        T-triangle torus: size^2, the rasteriser camera, one light,
        sharpness 40 / 40; the scene's leaves fresh copies."""
        mesh = geometry[T]
        return (dataclasses.replace(mesh, **{k: v.clone() for k, v
                                             in vars(mesh).items()}),
                Camera.rasterizer_default(device=dev),
                Lights.single(capacity=1, device=dev),
                RenderConfig(width=size, height=size, mode="soft",
                             soft_edge_sharpness=40.0,
                             soft_z_sharpness=40.0))

    def inputs(c):
        """The backwards' inputs on a srt_case: the forward's m, world and
        trans (K10a, K10g) and one-signed cotangents from numpy seeds."""
        out, m, _ = srt_fwd(c)
        world = out[3:6].contiguous()
        trans = srt_shw(c, world)
        cot = one_signed((10, m.shape[0]), dev, seed=7)
        gcot = one_signed(tuple(trans.shape), dev, seed=8)
        return ((c["pri"], c["cam"], c["dirs"], m, cot, c["es"], c["zs"],
                 c["chunk"]),
                (c["shw"], c["srcs"], world, trans, gcot, c["es"], c["zs"],
                 c["chunk"]))

    def pri_launch(a):  # the launch helpers' order of a backward's inputs
        consts, cam, dirs, m, cot, es, zs, chunk = a
        return consts, chunk, cam, dirs, es, zs, m, cot

    def shw_launch(a):
        consts, srcs, world, trans, gcot, es, zs, chunk = a
        return consts, chunk, srcs, world, trans, gcot, es, zs

    def fused(c, pargs, sargs):
        """K10c and K10i, launched directly (the wrappers route this table
        to K10e-K10l): (dc, dcam, dd), (dc, dsrc, dw) and the launches."""
        R, S = c["dirs"].shape[1], c["srcs"].shape[0]
        pg = srt.pri_bwd_blocks(c["pri"], c["chunk"],
                                srt._tile_count(R, None, None))
        sg = srt.shw_bwd_blocks(c["shw"], c["chunk"],
                                srt._tile_count(R, None, None), S)
        pbuf = (torch.empty_like(c["pri"]), torch.empty(3, device=dev),
                torch.empty_like(c["dirs"]))
        pscratch = srt.pri_scratch(c["pri"], c["chunk"], c["dirs"],
                                   blocks=pg)
        sbuf = (torch.empty_like(c["shw"]), torch.empty_like(c["srcs"]),
                torch.empty_like(sargs[2]))
        scratch = srt.shw_scratch(c["shw"], c["chunk"], c["srcs"], sargs[2],
                                  backward=True, blocks=sg)
        return pbuf, sbuf, {
            "pri_bwd_fused": lambda: srt.launch_pri_bwd_kernel(
                *pri_launch(pargs), *pbuf, blocks=pg, scratch=pscratch),
            "shw_bwd_fused": lambda: srt.launch_shw_bwd_kernel(
                *shw_launch(sargs), *sbuf, blocks=sg, scratch=scratch)}

    # The kernels against their plain versions at R = 128^2 (the route
    # depends on Tp alone), in float64 with the float32 branch decisions
    # and in float32, by column group with phase 20's rule (F11) or, where
    # the plain float32 version misses float64 by more than the rule (the
    # sources' 3 entries at these sizes: every float32 order, the fused
    # K10i's too, lands 2-7 times the rule from float64), within twice
    # that version's distance from float64, as phase 26 holds culled
    # against brute.
    c = srt_case(*frame(66560, 128))
    Tp = c["pri"].shape[0]
    require(Tp == 66560 and c["chunk"] == 32 and srt.pri_two_launch(Tp)
            and srt.shw_two_launch(Tp), "66,560 rows: both passes two-launch")
    t0 = time.perf_counter()
    pargs, sargs = inputs(c)

    def halves(pargs, sargs):
        """The four kernels through their wrappers: (dc, dcam, dd, dc, dsrc,
        dw)."""
        return (*srt.primary_bwd_tables(*pargs), srt.primary_bwd_dirs(*pargs),
                srt.shadow_bwd_consts(*sargs), *srt.shadow_bwd_rays(*sargs))

    def parts(got, pri, shw):
        """(kernel, part, column groups, got's part, the same part of the
        primary and shadow backwards pri and shw)."""
        one = (("all", 0, 3),)
        return [("k10e", "table", srt.PRI_GROUPS, got[0], pri[0]),
                ("k10e", "camera", one, got[1][None], pri[1][None]),
                ("k10f", "dirs", one, got[2].T, pri[2].T),
                ("k10k", "table", srt.SHW_GROUPS, got[3], shw[0]),
                ("k10l", "sources", one, got[4], shw[1]),
                ("k10l", "world", one, got[5].T, shw[2].T)]

    got, again = halves(pargs, sargs), halves(pargs, sargs)
    f_pri, f_shw, launch = fused(c, pargs, sargs)
    launch["pri_bwd_fused"]()
    launch["shw_bwd_fused"]()
    w64 = srt.primary_agg_bwd_reference(
        *(t.double() for t in pargs[:5]), *pargs[5:], f32_branches=True)
    p32 = srt.primary_agg_bwd_reference(*pargs)
    sw64 = srt.shadow_trans_bwd_reference(
        *(t.double() for t in sargs[:5]), *sargs[5:], f32_branches=True)
    sp32 = srt.shadow_trans_bwd_reference(*sargs)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    # K10f adds a ray's terms as K10c does, K10l a point's as K10i does.
    rays_equal = (torch.equal(got[2], f_pri[2])
                  and torch.equal(got[5], f_shw[2]))
    say(f"66,560 triangles ({Tp // c['chunk']} chunks), {c['dirs'].shape[1]}"
        f" rays, S = {c['srcs'].shape[0]}: two calls identical {same}; d dirs"
        f" = K10c's and d world = K10i's bit for bit {rays_equal} "
        f"({time.perf_counter() - t0:.1f} s); by group, the largest |d| "
        f"scaled by the group's largest float64 entry:")
    require(same and rays_equal, "K10e-K10l: two calls identical, the rays' "
                                 "gradients = K10c's and K10i's")
    require(all(bool(torch.isfinite(t).all()) for t in got)
            and not got[0][:, srt.PRI_USED:].any()
            and not got[3][:, srt.SHW_USED:].any(),
            "K10e-K10l: finite gradients, unused columns 0")
    err = {"k10e": 0.0, "k10f": 0.0, "k10k": 0.0, "k10l": 0.0}
    checks = {}
    for (kernel, part, groups, g, w), (*_, p) in zip(
            parts(got, w64, sw64), parts(got, p32, sp32)):
        r64, r32, f64 = (rule_by_group(g, w, groups),
                         rule_by_group(g, p, groups),
                         rule_by_group(p, w, groups))
        for grp in r64:
            rule20 = r32[grp][1] and (r64[grp][1]
                                      or r64[grp][0] <= 1.01 * f64[grp][0])
            twice = not f64[grp][1] and r64[grp][0] <= 2.0 * f64[grp][0]
            ok = rule20 or twice
            checks.setdefault(kernel, {})[f"{part}/{grp}"] = [
                r64[grp][0], r64[grp][1], f64[grp][0], r32[grp][1]]
            how = ("float64" if r64[grp][1] else "the F11 rule" if rule20
                   else "twice the plain float32 version's distance")
            say(f"  {kernel} {part}/{grp}: vs float64 {r64[grp][0]:.3g} "
                f"within {r64[grp][1]}; plain float32 vs float64 "
                f"{f64[grp][0]:.3g}; vs plain float32 {r32[grp][0]:.3g} "
                f"within {r32[grp][1]}; passes on {how} {ok}")
            require(ok, f"{kernel} {part}/{grp}: within rtol 1e-4 / atol "
                        f"1e-5 after scaling")
            err[kernel] = max(err[kernel], r64[grp][0])
    del got, again, f_pri, f_shw, launch, w64, p32, sw64, sp32
    torch.cuda.empty_cache()

    # The culled 512^2 step (forward K10b + K10h; above 32,768 rows the
    # primary backward is two-launch, above 65,536 the shadow's too).
    k10 = {k: f"soft_rt_{k}" for k in (
        "pri_fwd_masked", "shw_fwd_masked", "pri_bwd_tables", "pri_bwd_dirs",
        "shw_bwd_consts", "shw_bwd_rays", "shw_bwd_masked", "pri_fwd",
        "shw_fwd")}
    fwd = {k10["pri_fwd_masked"]: 1, k10["shw_fwd_masked"]: 1}
    two = {k10["pri_bwd_tables"]: 1, k10["pri_bwd_dirs"]: 1}
    want = {66560: {**fwd, **two, k10["shw_bwd_consts"]: 1,
                    k10["shw_bwd_rays"]: 1},
            36000: {**fwd, **two, k10["shw_bwd_masked"]: 1}}
    steps, step_launches = {}, {}
    for T in (66560, 36000):
        steps[T] = train_step(*frame(T, 512), 1e-9, target_scale=0.9,
                              render=raytrace_soft)
        zero_counts()
        loss = float(steps[T]())
        step_launches[T] = {k: v for k, v in kernel_counts().items() if v}
        say(f"culled 512^2 soft raytrace step on {T} triangles: loss "
            f"{loss:.6g}, launches {step_launches[T]}")
        require(np.isfinite(loss) and step_launches[T] == want[T],
                f"the {T}-triangle step launches {want[T]}")

    s_, c_, l_, cfg_ = frame(66560, 512)
    with torch.no_grad():
        target = raytrace_soft(s_, c_, l_, cfg_) * 0.9
    zero_counts()
    res = fit(target, s_, c_, l_, cfg_,
              FitConfig(steps=2, stages=((40.0, 40.0, 1.0),),
                        renderer="raytrace", log_every=0))
    fit_launches = {k: v for k, v in kernel_counts().items() if v}
    say(f"fit(renderer='raytrace'), 2 steps on 66,560 triangles at 512^2: "
        f"losses {res.losses.tolist()}, launches {fit_launches}")
    require(np.isfinite(res.losses).all()
            and fit_launches == {k: 2 * v for k, v in want[66560].items()},
            "each raytrace fit step launches K10b, K10h and K10e-K10l once")

    # The sharded step on 1 x 1 (PrimaryAggStats, unmasked: K10a, K10g)
    # against the single-card brute step, the same kernels.
    init_distributed()
    mesh = make_mesh(1, 1)
    s_, c_, l_, cfg_ = frame(66560, 512)
    target = torch.tensor(np.random.default_rng(32).uniform(
        0.0, 0.5, (512, 512, 3)).astype(np.float32), device=dev)
    train, _ = pr.make_sharded_train_step(mesh, cfg_, renderer="raytrace")
    st = pr.train_state(s_, l_, lambda p: torch.optim.SGD(p, lr=1e-9))
    ref = pr.train_state(s_, l_, lambda p: torch.optim.SGD(p, lr=1e-9))
    zero_counts()
    loss = float(train(st, c_, target).detach())
    sharded_launches = {k: v for k, v in kernel_counts().items() if v}
    want_loss = torch.mean((raytrace_soft(ref.scene, c_, ref.lights, cfg_,
                                          cull=False) - target) ** 2)
    want_loss.backward()
    worst = 0.0
    for g, w in zip((p.grad for p in pr.leaves(st.scene, st.lights)),
                    (p.grad for p in pr.leaves(ref.scene, ref.lights))):
        w = torch.zeros_like(g) if w is None else w
        scale = max(float(w.abs().max()), 1e-3)
        frac = ((g - w).abs() / scale) / (GRAD_ATOL
                                         + GRAD_RTOL * w.abs() / scale)
        worst = max(worst, float(frac.max()))
        require(bool(torch.isfinite(g).all()), "sharded step: finite grads")
    shutdown_distributed()
    lrel = abs(loss - float(want_loss)) / float(want_loss)
    say(f"sharded soft raytrace step on 1 x 1, 66,560 triangles at 512^2: "
        f"loss {loss:.8g} (single-card {float(want_loss):.8g}, rel "
        f"{lrel:.3g}); worst gradient {worst:.3g} of the tolerance; "
        f"launches {sharded_launches}")
    require(sharded_launches == {k10["pri_fwd"]: 1, k10["shw_fwd"]: 1,
                                 **{k: 1 for k in want[66560]
                                    if k not in fwd}},
            "the sharded step launches K10a, K10g and K10e-K10l once")
    require(lrel <= GRAD_RTOL and worst <= 1.0,
            "the sharded step = the single-card step (rtol 1e-4 / atol "
            "1e-5, leaves scaled)")
    del st, ref, train, target
    torch.cuda.empty_cache()

    # Card numbers at the main path's 512^2: the four kernels launched into
    # preallocated outputs beside the fused K10c and K10i on the same
    # inputs; the plain version of each pass once (~15 s apiece: it computes
    # both halves), its result kept to hold the kernels at these shapes.
    peak = {}
    for T, step in steps.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        peak[T] = torch.cuda.max_memory_allocated() / 1e9
    step_ms = median_ms_in_turns({T: steps[T] for T in steps}, n=1, reps=3)
    busy = {T: device_busy(steps[T], steps=2) for T in steps}
    c = srt_case(*frame(66560, 512))
    pargs, sargs = inputs(c)
    R, S = c["dirs"].shape[1], c["srcs"].shape[0]
    tables_scratch = srt.pri_bwd_tables_scratch(c["pri"], c["dirs"])
    rows = torch.empty((Tp, srt.ROW_STAGED), device=dev)
    consts_scratch = srt.shw_bwd_consts_scratch(c["shw"], c["srcs"],
                                                sargs[2])
    # K10k in half its runs (SHW_SPLITS / 2), the setting it was chosen
    # over: another order of its row sums, so only its time is read.
    partials_half = consts_scratch[1][:consts_scratch[1].shape[0] // 2]
    sdc_half = torch.empty_like(c["shw"])
    shw_rows = torch.empty((S, Tp, srt.SHW_STAGED), device=dev)
    src_partials = torch.empty((-(-R // srt.THREADS), S, 3), device=dev)
    dc, dcam = torch.empty_like(c["pri"]), torch.empty(3, device=dev)
    dd, sdc = torch.empty_like(c["dirs"]), torch.empty_like(c["shw"])
    dsrc, dw = torch.empty_like(c["srcs"]), torch.empty_like(sargs[2])
    _, _, launch = fused(c, pargs, sargs)
    # K10f with a warp on an 8 x 4 block of pixels in place of 32 x 1 (the
    # rays permuted so that each 32 in a row are one block; its d dirs
    # permuted back): the kernel cannot take that map itself, as its
    # callers pass no image width. It may not change a ray's bits.
    blocks = torch.arange(R, device=dev).reshape(512 // 4, 4, 512 // 8, 8)
    perm = blocks.permute(0, 2, 1, 3).reshape(-1)
    pargs_8x4 = (pargs[0], pargs[1], pargs[2][:, perm].contiguous(),
                 pargs[3][perm].contiguous(), pargs[4][:, perm].contiguous(),
                 *pargs[5:])
    dd_8x4 = torch.empty_like(dd)
    kernels = {
        "pri_bwd_tables": lambda: srt.launch_pri_bwd_tables_kernel(
            *pri_launch(pargs), *tables_scratch, dc, dcam),
        "pri_bwd_dirs": lambda: srt.launch_pri_bwd_dirs_kernel(
            *pri_launch(pargs), rows, dd),
        "pri_bwd_dirs_8x4": lambda: srt.launch_pri_bwd_dirs_kernel(
            *pri_launch(pargs_8x4), rows, dd_8x4),
        "shw_bwd_consts": lambda: srt.launch_shw_bwd_consts_kernel(
            *shw_launch(sargs), consts_scratch[0], consts_scratch[1], sdc),
        "shw_bwd_consts_half": lambda: srt.launch_shw_bwd_consts_kernel(
            *shw_launch(sargs), consts_scratch[0], partials_half, sdc_half),
        "shw_bwd_rays": lambda: srt.launch_shw_bwd_rays_kernel(
            *shw_launch(sargs), shw_rows, src_partials, dsrc, dw),
        **launch}
    t = median_ms_in_turns(kernels, n=1, reps=3, timer=held_ms)
    torch.cuda.synchronize()
    same_8x4 = torch.equal(dd_8x4[:, torch.argsort(perm)], dd)
    say(f"K10f with a warp on 8 x 4 pixels {t['pri_bwd_dirs_8x4']:.4f} ms, "
        f"on 32 x 1 {t['pri_bwd_dirs']:.4f} ms; d dirs the same bits "
        f"{same_8x4}")
    require(same_8x4, "K10f on 8 x 4 pixels a warp gives the same d dirs")
    del pargs_8x4, dd_8x4
    say(f"K10k in {consts_scratch[1].shape[0]} runs "
        f"{t['shw_bwd_consts']:.4f} ms, in {partials_half.shape[0]} "
        f"{t['shw_bwd_consts_half']:.4f} ms")
    del partials_half, sdc_half
    plain = {}
    for part, fn, args in (("pri", srt.primary_agg_bwd_reference, pargs),
                           ("shw", srt.shadow_trans_bwd_reference, sargs)):
        t[f"{part}_plain"] = cuda_ms(
            lambda part=part, fn=fn, args=args: plain.update({
                part: fn(*args)}), 1)
    # The kernels at 512^2 against the plain float32 version by column
    # group (phase 20's rule; no float64 reference at this size).
    got = halves(pargs, sargs)
    for kernel, part, groups, g, p in parts(got, plain["pri"], plain["shw"]):
        for grp, (e, ok) in rule_by_group(g, p, groups).items():
            checks[kernel][f"512/{part}/{grp}"] = [e, ok]
            say(f"  512^2 {kernel} {part}/{grp}: vs plain float32 {e:.3g} "
                f"within {ok}")
            require(ok, f"{kernel} {part}/{grp} at 512^2: within rtol 1e-4 "
                        f"/ atol 1e-5 of the plain float32 version after "
                        f"scaling")
            err[kernel] = max(err[kernel], e)
    del got, plain
    trans = sargs[3]
    work = srt_work(c, pargs[3], sargs[2], sargs[4] * trans * (-srt.OD_SCALE))
    bounds = two_launch_bounds(c, work)
    fused_bounds = srt_bounds(c, work)
    bounds["pri_bwd_fused"] = fused_bounds["pri_bwd"]
    bounds["shw_bwd_fused"] = fused_bounds["shw_bwd"]
    card = card_line()
    groups = {"pri": srt.pri_bwd_blocks(c["pri"], c["chunk"],
                                        srt._tile_count(R, None, None)),
              "shw": srt.shw_bwd_blocks(c["shw"], c["chunk"],
                                        srt._tile_count(R, None, None), S)}
    passing = work["pairs"] - work["gated_p"]
    passing_s = work["act_s"] - work["act_gated_s"]
    say(f"two-launch kernels alone, 66,560 triangles at 512^2 ({R} rays, "
        f"{work['pairs']} pairs, {work['gated_p']} gated, {work['dead_p']} "
        f"proved dead by K10e's and K10f's bound "
        f"({work['dead_p'] / max(passing, 1):.4%} of the gate's passing "
        f"pairs), {work['live_p']} of weight not 0; {work['triples']} "
        f"shadow triples, {work['gated_s']} gated; {work['act_s']} of d od "
        f"not 0, {work['act_gated_s']} of them gated, {work['dead_s']} found "
        f"dead by K10k's and K10l's test "
        f"({work['dead_s'] / max(passing_s, 1):.4%} of the gate's passing "
        f"triples), {work['live_s']} live): "
        + ", ".join(f"{k} {t[k]:.4f} ms ("
                    + (f"first design {FIRST_DESIGN_MS[k]:.4f}; "
                       if k in FIRST_DESIGN_MS else "")
                    + f"plain, both halves {t[k[:3] + '_plain']:.4f}; bound "
                    f"{bounds[k][0]:.4f} ms, {bounds[k][1]})"
                    for k in ("pri_bwd_tables", "pri_bwd_dirs",
                              "shw_bwd_consts", "shw_bwd_rays"))
        + f"; fused K10c {t['pri_bwd_fused']:.4f} ms ({groups['pri']} "
        f"blocks, bound {bounds['pri_bwd_fused'][0]:.4f}), fused K10i "
        f"{t['shw_bwd_fused']:.4f} ms ({groups['shw']} blocks, bound "
        f"{bounds['shw_bwd_fused'][0]:.4f}) ({card})")
    say(f"culled 512^2 soft raytrace steps (CUDA events, median of 3): "
        f"66,560 triangles {step_ms[66560]:.4f} ms (first design "
        f"{FIRST_DESIGN_MS['culled_step']:.2f}; with K10k and K10l's "
        f"{FIRST_DESIGN_MS['culled_step_pr13']:.2f}), 36,000 "
        f"{step_ms[36000]:.4f} ms; "
        f"peak memory {peak[66560]:.3f} / {peak[36000]:.3f} GB ({card})")
    for T in steps:
        say(f"  the {T} step's device busy {busy[T]['busy_ms']:.4f} ms a "
            f"step in {busy[T]['kernels']} device events, "
            f"{busy[T]['wall_ms']:.4f} ms on the host clock (share "
            f"{busy[T]['share']})")
        for kname, ms in busy[T]["by_name"][:8]:
            say(f"    {ms:.5f} ms  {kname[:100]}")
    masked = masked_shadow_numbers(dev, frame, t["shw_bwd_rays"])
    say(f"phase 32 took {time.perf_counter() - t_phase:.1f} s")
    record["k10hj_big"] = masked
    record["two_launch"] = dict(
        err=err, checks=checks, step_launches={str(k): v for k, v in
                                               step_launches.items()},
        fit_launches=fit_launches, fit_losses=res.losses.tolist(),
        sharded=dict(loss=loss, single_loss=float(want_loss),
                     grad_of_tolerance=worst, launches=sharded_launches),
        kernel_ms=t, bounds=bounds, work=work, fused_groups=groups,
        step_ms={str(k): v for k, v in step_ms.items()},
        peak_gb={str(k): v for k, v in peak.items()},
        busy={str(k): v for k, v in busy.items()})

    def entry(part: str, key: str, fused_part: str, replaces: str) -> dict:
        return dict(name=f"soft_rt_{part}", route="cuda",
                    source="raytpu_torch/csrc/soft_raytrace.cu",
                    replaces=replaces,
                    launches=step_launches[66560][f"soft_rt_{part}"],
                    max_abs_err=err[key], ms=t[part],
                    plain_ms=t[f"{part[:3]}_plain"],
                    bound_ms=bounds[part][0],
                    bound_by=bounds[part][1], library_ms=None,
                    checks=checks[key], fused_ms=t[fused_part])

    return [
        entry("pri_bwd_tables", "k10e", "pri_bwd_fused",
              replaces="raytpu/kernels/soft_raytrace_pallas.py:449"),
        entry("pri_bwd_dirs", "k10f", "pri_bwd_fused",
              replaces="raytpu/kernels/soft_raytrace_pallas.py:499"),
        entry("shw_bwd_consts", "k10k", "shw_bwd_fused",
              replaces="raytpu/kernels/soft_raytrace_pallas.py:1079"),
        entry("shw_bwd_rays", "k10l", "shw_bwd_fused",
              replaces="raytpu/kernels/soft_raytrace_pallas.py:1105"),
    ]


def masked_shadow_numbers(dev, frame, k10l_ms: float) -> dict:
    """Phase 32's K10h and K10j on the culled 512^2 steps' own inputs (the
    66,560- and 36,000-triangle tori: K10b's and K10h's forward, the shadow
    mask of its hit positions, one-signed cotangents): K10h against its
    plain masked version (rtol 1e-5 / atol 1e-6) at both sizes, K10j
    against its plain float32 version by column group (phase 20's rule) at
    36,000, where the step takes it; each launched into preallocated
    outputs and timed, K10j also in half its blocks and both in runs of
    twice SHW_RUN kept chunks (another order of their sums: time only);
    the keep rate, srt_work's counts and srt_bounds'. K10h at 66,560 is
    printed beside K10l's k10l_ms of the same call. Returns {T: numbers}."""
    from raytpu_torch.kernels import soft_raytrace as srt
    res = {}
    for T in (66560, 36000):
        t0 = time.perf_counter()
        c = srt_case(*frame(T, 512), cull=True)
        agg, m, _ = srt_fwd(c, masked=True)
        world = agg[3:6].contiguous()
        del agg
        c["smask"] = srt_shadow_mask(c, world)
        trans = srt_shw(c, world, masked=True)
        want = srt_shw(c, world, plain=True, masked=True)
        torch.cuda.synchronize()
        err = float((trans - want).abs().max())
        ok = bool(torch.isfinite(trans).all()) and torch.allclose(
            trans, want, rtol=1e-5, atol=1e-6)
        require(ok, f"K10h on the {T}-triangle culled step within rtol 1e-5 "
                    f"/ atol 1e-6 of its plain version")
        del want
        gcot = one_signed(tuple(trans.shape), dev, seed=8)
        Tp, R, S, chunk = (c["shw"].shape[0], world.shape[1],
                           c["srcs"].shape[0], c["chunk"])
        scull = dict(mask=c["smask"], tiles=c["tiles"])
        margs = (c["shw"], chunk, c["srcs"], world)
        checks = {}
        if T == 36000:
            got = srt_shw_bwd(c, world, trans, gcot, masked=True)
            plain = srt_shw_bwd(c, world, trans, gcot, plain=True,
                                masked=True)
            one = (("all", 0, 3),)
            for part, g, p, groups in (
                    ("table", got[0], plain[0], srt.SHW_GROUPS),
                    ("sources", got[1], plain[1], one),
                    ("world", got[2].T, plain[2].T, one)):
                for grp, (e, gok) in rule_by_group(g, p, groups).items():
                    checks[f"{part}/{grp}"] = [e, gok]
                    say(f"  K10j on 36,000 triangles {part}/{grp}: vs plain "
                        f"float32 {e:.3g} within {gok}")
                    require(gok, f"K10j {part}/{grp} at 36,000: within "
                                 f"rtol 1e-4 / atol 1e-5 of the plain "
                                 f"float32 version after scaling")
            del got, plain
        tr = torch.empty_like(trans)
        outs = (torch.empty_like(c["shw"]), torch.empty_like(c["srcs"]),
                torch.empty_like(world))

        def timers(run: int) -> dict:
            """K10h's and K10j's launches with runs of `run` kept chunks
            (and K10j's in half its blocks), their scratch allocated."""
            old, srt.SHW_RUN = srt.SHW_RUN, run
            try:
                blocks = srt.shw_bwd_blocks(c["shw"], chunk,
                                            c["tiles"].count, S)
                fs = srt.shw_scratch(*margs, **scull, backward=False)
                bs = {b: srt.shw_scratch(*margs, **scull, backward=True,
                                         blocks=b)
                      for b in (blocks, max(1, blocks // 2))}
            finally:
                srt.SHW_RUN = old

            def with_run(fn):
                def go():
                    old, srt.SHW_RUN = srt.SHW_RUN, run
                    try:
                        fn()
                    finally:
                        srt.SHW_RUN = old
                return go
            tag = "" if run == srt.SHW_RUN else f"_run{run}"
            fns = {f"k10h{tag}": with_run(lambda: srt.launch_shw_fwd_kernel(
                *margs, c["es"], c["zs"], tr, **scull, scratch=fs))}
            for b, sc in bs.items():
                name = f"k10j{tag}" + ("" if b == blocks else "_half")
                if tag and b != blocks:
                    continue
                fns[name] = with_run(
                    lambda b=b, sc=sc: srt.launch_shw_bwd_kernel(
                        *margs, trans, gcot, c["es"], c["zs"], *outs,
                        **scull, blocks=b, scratch=sc))
            return fns, blocks

        fns, blocks = timers(srt.SHW_RUN)
        fns2, _ = timers(2 * srt.SHW_RUN)
        ms = median_ms_in_turns({**fns, **fns2}, n=2, reps=3, timer=held_ms)
        del fns, fns2
        torch.cuda.empty_cache()
        work = srt_work(c, m, world, gcot * trans * (-srt.OD_SCALE),
                        masked=True, primary=False)
        bounds = srt_bounds(c, work, masked=True)
        keep = float(c["smask"].float().mean())
        passing = work["triples"] - work["gated_s"]
        passing_b = work["act_s"] - work["act_gated_s"]
        res[T] = dict(ms=ms, blocks=blocks, keep=keep, work=work,
                      bound_fwd=bounds["shw_fwd"], bound_bwd=bounds["shw_bwd"],
                      fwd_err=err, bwd_checks=checks)
        say(f"K10h and K10j on the culled 512^2 step's inputs, {T} triangles "
            f"({Tp // chunk} chunks, shadow keep rate {keep:.4f}; "
            f"{work['triples']} kept triples, {work['gated_s']} gated, "
            f"{work['dead_f']} skipped by the forward's test "
            f"({work['dead_f'] / max(passing, 1):.4%} of the gate's passing), "
            f"{work['live_f']} of a term not 0; backward {work['act_s']} of d "
            f"od not 0, {work['dead_s']} found dead "
            f"({work['dead_s'] / max(passing_b, 1):.4%}), {work['live_s']} "
            f"live): K10h {ms['k10h']:.4f} ms (bound "
            f"{bounds['shw_fwd'][0]:.4f} ms, {bounds['shw_fwd'][1]}; vs "
            f"plain {err:.3g}; runs of {2 * srt.SHW_RUN}: "
            f"{ms[f'k10h_run{2 * srt.SHW_RUN}']:.4f}; K10l in this call "
            f"{k10l_ms:.4f}), K10j {ms['k10j']:.4f} ms in {blocks} blocks "
            f"(bound {bounds['shw_bwd'][0]:.4f} ms, {bounds['shw_bwd'][1]}; "
            f"in {max(1, blocks // 2)} blocks {ms['k10j_half']:.4f}; runs of "
            f"{2 * srt.SHW_RUN}: {ms[f'k10j_run{2 * srt.SHW_RUN}']:.4f}) "
            f"({time.perf_counter() - t0:.1f} s; {card_line()})")
        del c, trans, gcot, tr, outs, world, m
        torch.cuda.empty_cache()
    return res


# Float operations of L5's variants beyond K1's, counted from
# raytpu_torch/csrc/labs.cu: without the gather, the constant normal and
# albedo (six multiplies a ray); without the shading, color = normal +
# albedo (three adds a ray) in place of the shading of a hit ray.
FLOPS_NO_GATHER, FLOPS_NO_SHADE = 6, 3


def lab_case(dev, size: int, mode: str, pad_to, tile: int) -> dict:
    """The lab kernels' inputs for a frame as the labs make them
    (raytpu_torch/labs/common.py::lab_inputs: the Cornell box padded to
    pad_to, the raytracer's default camera, one light of capacity 1) and
    the wrappers' keywords for ``tile``."""
    from raytpu_torch import Lights
    from raytpu_torch.labs.common import lab_inputs
    c = lab_inputs(Lights.single(capacity=1, device=dev), size, dev, mode,
                   pad_to)
    c.update(tile=tile, kw=dict(tile_r=tile, tri_chunk=c["cfg"].tri_chunk,
                                ambient=c["cfg"].ambient,
                                parity=mode == "parity"))
    return c


def lab_bound(c: dict, out_bytes: int, gather: bool = True,
              shade: bool = True) -> tuple[float, str]:
    """A lab kernel's bound on case c: 12 B of dirs in and ``out_bytes``
    out a ray plus the tables; K1's plane tests (all C of the primary
    sweep, the shadow sweep's up to its first blocker) and the shading of
    each hit ray, or L5's replacements (FLOPS_NO_GATHER, FLOPS_NO_SHADE)."""
    from raytpu_torch.kernels.render_fused import fused_fwd_reference
    dirs, table, par = c["dirs"], c["table"], c["par"]
    R = dirs.shape[0]
    if "hits" not in c:
        c["hits"] = int((fused_fwd_reference(
            dirs, table, par, ambient=0.2, parity=False).idx >= 0).sum())
        c["shadow_tests"] = shadow_tests(dirs, table, par)
    flops = FLOPS_PLANE_TEST * (R * c["C"] + c["shadow_tests"])
    flops += (FLOPS_FWD_SHADE * c["hits"] if shade
              else FLOPS_NO_SHADE * R)
    if not gather:
        flops += FLOPS_NO_GATHER * R
    return bound_ms(R * (12 + out_bytes) + (table.numel() + par.numel()) * 4,
                    flops)


def run_lab(module: str, *flags: str) -> dict:
    """``python -m raytpu_torch.labs.<module> flags`` in a subprocess that
    must exit 0; its log goes to build/chip_smoke/, its [lab] lines are
    printed, and its JSON line is returned."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"raytpu_torch.labs.{module}", *flags],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    tag = module + "".join(f.replace("-", "_") for f in flags)
    (OUT / f"{tag}.log").write_text(proc.stdout + proc.stderr)
    require(proc.returncode == 0,
            f"{module} {' '.join(flags)} exits 0 (code {proc.returncode}: "
            f"{proc.stderr[-3000:]})")
    for line in proc.stderr.splitlines():
        if line.startswith("[lab"):
            say(f"  {line}")
    say(f"  ({module} {' '.join(flags)}: {time.perf_counter() - t0:.1f} s)")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def lab_phases(dev, record: dict) -> list[dict]:
    """Phases 33 and 34: the lab kernels K1r, L6 and L5 against their plain
    versions and K1, their card numbers, and the two labs run as a user
    runs them. Returns their entries of the kernels line."""
    from raytpu_torch.kernels import labs, render_fused
    from raytpu_torch.labs.megakernel_lab4 import VARIANTS as LAB_VARIANTS

    say("== phase 33: K1r, L6 and the four L5 variants against their plain "
        "versions on the card")
    t_phase = time.perf_counter()

    def mismatch(got, want) -> list[int]:
        return [int((a != b).sum()) for a, b in zip(got, want)]

    def max_err(got, want) -> float:
        return max(float((a - b).abs().max()) for a, b in zip(got, want))

    err = {"k1r": 0.0, "l6": 0.0, "l5": 0.0}
    cases = {}
    for key, size, mode, pad_to, tile in (
            ("clean_512", 512, "clean", 32, 2048),
            ("parity_500", 500, "parity", None, 2000)):
        c = cases[key] = lab_case(dev, size, mode, pad_to, tile)
        args = (c["dirs_t"], *c["consts"], c["par"])
        before = (labs.LAUNCHES_ROWS, labs.LAUNCHES_BLK8,
                  labs.LAUNCHES_VARIANT)
        rows = labs.fused_fwd_raw(*args, **c["kw"])
        again = labs.fused_fwd_raw(*args, **c["kw"])
        out8 = labs.fused_fwd_blk8(*args, **c["kw"])
        variants = {name: labs.run_variant(c["dirs_t"], c["table"], c["par"],
                                           tile, c["C"], g, s)
                    for g, s, name in LAB_VARIANTS}
        launched = (labs.LAUNCHES_ROWS - before[0],
                    labs.LAUNCHES_BLK8 - before[1],
                    labs.LAUNCHES_VARIANT - before[2])
        plain = labs.fused_fwd_raw_reference(*args, **c["kw"])
        plain8 = labs.fused_fwd_blk8_reference(*args, **c["kw"])
        k1 = render_fused.fused_fwd(c["dirs"], c["table"], c["par"],
                                    ambient=c["kw"]["ambient"],
                                    parity=c["kw"]["parity"])
        k1_rows = (k1.color.T, k1.fd[None], k1.idx[None], k1.occ[None])
        unblocked = (labs.unblk8(out8[0:24], tile),
                     labs.unblk8(out8[24:32], tile))
        v_mis, v_err = {}, 0.0
        for g, s, name in LAB_VARIANTS:
            want = labs.run_variant_reference(c["dirs_t"], c["table"],
                                              c["par"], tile, c["C"], g, s)
            v_mis[name] = mismatch(variants[name], want)
            v_err = max(v_err, max_err(variants[name][:2], want[:2]))
        torch.cuda.synchronize()
        m_rows, m_k1 = mismatch(rows, plain), mismatch(rows, k1_rows)
        m_again = mismatch(rows, again)
        m_l6 = mismatch(unblocked, plain[:2]) + mismatch([out8], [plain8])
        e_rows, e_l6 = max_err(rows[:2], plain[:2]), max_err([out8], [plain8])
        hits = float((rows[2] >= 0).float().mean())
        try:
            labs.fused_fwd_raw(*args, **dict(c["kw"], tile_r=tile + 8))
            refused = ""
        except ValueError as exc:
            refused = str(exc)
        say(f"{size}^2 {mode} T={c['consts'][0].shape[0]} C={c['C']} tile "
            f"{tile} (hit rays {hits:.4f}): K1r vs plain mismatches "
            f"[color, fd, idx, occ] {m_rows}, max error {e_rows}; K1r vs K1 "
            f"{m_k1}; two K1r calls {m_again}; L6 unblocked vs plain "
            f"[color, fd] and the block {m_l6}, max error {e_l6}; L5 vs "
            f"plain {v_mis}, max error {v_err}; launches [K1r, L6, L5] "
            f"{list(launched)}; tile {tile + 8}: ValueError {refused!r}")
        require(not any(m_rows + m_k1 + m_again + m_l6)
                and not any(sum(v_mis.values(), [])),
                "lab kernels = plain versions = K1 bit for bit")
        require(e_rows == e_l6 == v_err == 0.0, "max error 0.0")
        require(launched == (2, 1, 4), "exact launches")
        require("F23" in refused, "a ragged tile count is refused (F23)")
        require(bool(torch.isfinite(rows[0]).all()) and hits > 0.9,
                "finite color, most rays hit")
        err["k1r"] = max(err["k1r"], e_rows)
        err["l6"] = max(err["l6"], e_l6)
        err["l5"] = max(err["l5"], v_err)
        record[f"labs_compare_{key}"] = dict(
            k1r=m_rows, k1r_vs_k1=m_k1, repeat=m_again, l6=m_l6, l5=v_mis,
            launches=launched)

    # Each kernel alone on the labs' frame (512^2 clean), launched past the
    # wrappers' packing (K1r and L6 take the JAX functions' constants and
    # pack the table each call; K1 and L5 take it packed), beside K1 on the
    # same inputs, the plain versions and the bounds.
    c = cases["clean_512"]
    tile, R = c["tile"], c["dirs"].shape[0]
    args = (c["dirs_t"], *c["consts"], c["par"])
    dirs8 = labs.blk8(c["dirs_t"], tile).contiguous()
    out8 = torch.empty((32, R // 8), dtype=torch.float32, device=dev)
    kernels = {
        "k1r": lambda: labs._rows_call(c["dirs_t"], c["table"], c["par"],
                                       tile, True, True, 0.2, False),
        "l6": lambda: labs._launch(dirs8, c["table"], c["par"], R, tile,
                                   labs._BLK8, True, True, 0.2, False,
                                   (out8,)),
        "k1": lambda: render_fused.fused_fwd(c["dirs"], c["table"], c["par"],
                                             ambient=0.2, parity=False),
        **{name: (lambda g=g, s=s: labs.run_variant(
            c["dirs_t"], c["table"], c["par"], tile, c["C"], g, s))
           for g, s, name in LAB_VARIANTS},
    }
    plains = {
        "k1r_plain": lambda: labs.fused_fwd_raw_reference(*args, **c["kw"]),
        "l6_plain": lambda: labs.fused_fwd_blk8_reference(*args, **c["kw"]),
        **{f"{name}_plain": (lambda g=g, s=s: labs.run_variant_reference(
            c["dirs_t"], c["table"], c["par"], tile, c["C"], g, s))
           for g, s, name in LAB_VARIANTS},
    }
    t = median_ms_in_turns(kernels, n=20, reps=7, timer=held_ms)
    t.update(median_ms_in_turns(plains, n=3, reps=5, timer=held_ms))
    t["l6_wrapper"] = median_ms_in_turns(
        {"w": lambda: labs.fused_fwd_blk8(*args, **c["kw"])}, n=20, reps=5,
        timer=held_ms)["w"]
    bounds = {"k1r": lab_bound(c, 24), "l6": lab_bound(c, 16),
              **{name: lab_bound(c, 24, g, s) for g, s, name in LAB_VARIANTS}}
    card = card_line()
    say(f"512^2 clean, C={c['C']}, tile {tile}, device time a call (CUDA "
        f"events, median of turns): "
        + ", ".join(f"{k} {t[k]:.4f} ms (plain {t[k + '_plain']:.4f}; "
                    f"bound {bounds[k][0]:.4f} ms, {bounds[k][1]})"
                    for k in bounds)
        + f"; K1 {t['k1']:.4f} ms; L6 through its wrapper (re-blocking "
        f"dirs) {t['l6_wrapper']:.4f} ms ({card})")
    say(f"phase 33 took {time.perf_counter() - t_phase:.1f} s")

    say("== phase 34: the labs as a user runs them (subprocesses)")
    t_phase = time.perf_counter()
    check = run_lab("megakernel_lab6", "--check-only")
    require(check["maxdiff_ab"] == 0.0
            and not any(check["mismatch_ab"].values())
            and not any(check["mismatch_a_k1"].values()),
            "lab 6: A = B = K1 entry for entry")
    lab6 = run_lab("megakernel_lab6")
    lab4 = run_lab("megakernel_lab4")
    rows6 = (("A  K1r, (1, tile) rows", "fused_1row_ms", "unc_1row"),
             ("B  L6, (8, tile/8) blocks", "fused_8row_ms", "unc_8row"),
             ("C  raytrace_full, default config (K1, F21)",
              "split_full_fwd_ms", "unc_split"))
    say(f"lab 6 (512^2 clean, Cornell 32, tile 2048; bench.py's estimator, "
        f"ms a forward): ({lab6['card']})")
    for label, key, unc in rows6:
        say(f"  {label:44s} {lab6[key]:.4f} +- {lab6[unc]:.4f}")
    say(f"  maxdiff_ab {lab6['maxdiff_ab']}, mismatches A-B "
        f"{lab6['mismatch_ab']}, A-K1 {lab6['mismatch_a_k1']}")
    say(f"lab 4 (512^2 clean, Cornell 32; lab 4's estimator, ms a call): "
        f"({lab4['card']})")
    for name in ("two-phase", *(v[2] for v in LAB_VARIANTS)):
        say(f"  {name:14s} {lab4[name]:.4f}")
    say(f"  mismatches against K1r {lab4['mismatch_vs_k1r']}")
    require(all(lab6[k] > 0 for _, k, _ in rows6)
            and all(lab4[v[2]] == lab4[v[2]] for v in LAB_VARIANTS),
            "the labs' times")
    require(not any(sum((list(m.values()) for m in
                         lab4["mismatch_vs_k1r"].values()), [])),
            "lab 4: every variant's idx and occ = K1r's, mega-full's all")
    launched = {}
    for res in (check, lab6, lab4):
        for k, v in res["launches"].items():
            launched[k] = launched.get(k, 0) + v
    say(f"lab path launches (the three lab processes): {launched}")
    require(all(launched.get(k, 0) > 0 for k in (
        "render_fused_fwd_rows", "megakernel_lab6_blk8",
        "megakernel_lab4_variant")), "the labs launched K1r, L6 and L5")
    say(f"phase 34 took {time.perf_counter() - t_phase:.1f} s")
    record["labs"] = dict(err=err, kernel_ms=t, bounds=bounds, lab6=lab6,
                          lab6_check=check, lab4=lab4, launches=launched)

    def entry(name, key, err_key, launches, lab_ms, replaces,
              **extra) -> dict:
        return dict(name=name, route="cuda",
                    source="raytpu_torch/csrc/labs.cu", replaces=replaces,
                    launches=launches, max_abs_err=err[err_key],
                    ms=t[key], plain_ms=t[f"{key}_plain"],
                    bound_ms=bounds[key][0], bound_by=bounds[key][1],
                    library_ms=None, lab_ms=lab_ms, k1_ms=t["k1"], **extra)

    return [
        entry("render_fused_fwd_rows", "k1r", "k1r",
              launched["render_fused_fwd_rows"], lab6["fused_1row_ms"],
              replaces="raytpu/kernels/render_fused.py:539"),
        entry("megakernel_lab4_variant", "mega-full", "l5",
              launched["megakernel_lab4_variant"], lab4["mega-full"],
              replaces="bench/megakernel_lab4.py:126",
              variants={name: dict(ms=t[name], plain_ms=t[f"{name}_plain"],
                                   bound_ms=bounds[name][0],
                                   bound_by=bounds[name][1],
                                   lab_ms=lab4[name])
                        for _, _, name in LAB_VARIANTS}),
        entry("megakernel_lab6_blk8", "l6", "l6",
              launched["megakernel_lab6_blk8"], lab6["fused_8row_ms"],
              replaces="bench/megakernel_lab6.py:180",
              wrapper_ms=t["l6_wrapper"]),
    ]


# L1's bound: a plane test of its div form has three divides for K5's one
# reciprocal and three multiplies (one operation fewer); its mxu instances
# move the 15 operations of the three dots onto the tensor cores as 3 dots
# x 3 TF32 passes x K = 8 padded MACs (2 operations each) a pair of
# triangles padded to whole 16-row tiles, at the dense TF32 peak.
FLOPS_PLANE_TEST_DIV, FLOPS_DOTS = FLOPS_PLANE_TEST - 1, 15
MXU_FLOPS_PAIR, PEAK_TF32_S = 2 * 3 * 3 * 8, 495e12


def kernel_lab_bound(R: int, table, C: int, dot: str,
                     div: str) -> tuple[float, str]:
    """L1's bound on R rays and a packed table (10, Tp) of chunks of C: 12
    B in and 8 B out a ray and the table once; every (ray, triangle) pair
    of the padded table (vpu); mxu: the padded MACs at the TF32 peak plus
    the CUDA-core remainder at the float32 peak."""
    nbytes = R * 20 + table.numel() * 4
    per_test = FLOPS_PLANE_TEST_DIV if div == "div" else FLOPS_PLANE_TEST
    pairs = R * table.shape[1]
    if dot == "vpu":
        return bound_ms(nbytes, per_test * pairs)
    tiles = -(-C // 16) * 16 * (table.shape[1] // C)
    t_ops = (MXU_FLOPS_PAIR * R * tiles / PEAK_TF32_S
             + (per_test - FLOPS_DOTS) * pairs / PEAK_F32_S)
    t_bytes = nbytes / PEAK_BYTES_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_lab_phases(dev, record: dict) -> list[dict]:
    """Phases 35 and 36: L1 (lab 1's closest-hit variants), L2 and L3 (lab
    2's one-step and no-op) and L4 (lab 3's tiny kernel) against their
    plain versions, K5 and K4, their card numbers, and the three labs run
    as a user runs them. Returns their entries of the kernels line."""
    from raytpu_torch import Lights
    from raytpu_torch.kernels import intersect as isect
    from raytpu_torch.kernels import labs
    from raytpu_torch.kernels.tables import constant_table
    from raytpu_torch.labs import kernel_lab
    from raytpu_torch.labs.common import lab_inputs

    say("== phase 35: L1, L2, L3 and L4 against their plain versions on the "
        "card")
    t_phase = time.perf_counter()
    dirs, dirs_t, scenes = kernel_lab.scenes(512, 9216, dev)
    R = dirs.shape[0]
    err = {"vpu": 0.0, "mxu": 0.0}
    near = {"near_tie": 0, "near_edge": 0}
    tables = {}
    before, launched = labs.LAUNCHES_KERNEL_LAB, 0
    for name, (m, k0, valid) in scenes.items():
        k5 = isect.closest_hit(dirs, m, k0, valid, tri_chunk=512)
        for chunk_mode in labs.CHUNK_MODES:
            table, C = tables[name, chunk_mode] = labs.kernel_lab_table(
                m, k0, valid, chunk_mode)
            for dot in labs.DOTS:
                for div in labs.DIVS:
                    kw = dict(chunk_mode=chunk_mode, dot=dot, div=div)
                    want = labs.lab_sweep_reference(dirs_t, table, C, dot,
                                                    div)
                    extra = (chunk_mode, div) == ("tight", "recip")
                    for tile in (2048, 4096, 8192) if extra else (2048,):
                        got = labs.kernel_lab_variant(dirs_t, m, k0, valid,
                                                      tile_r=tile, **kw)
                        launched += 1
                        if extra and tile == 2048:
                            again = labs.kernel_lab_variant(
                                dirs_t, m, k0, valid, tile_r=tile, **kw)
                            launched += 1
                            require(torch.equal(got[0], again[0])
                                    and torch.equal(got[1], again[1]),
                                    f"{name} {kw}: two calls identical")
                        torch.cuda.synchronize()
                        both = (got[1] == want[1]) & (want[1] >= 0)
                        e = float(torch.where(both, got[0] - want[0],
                                              0.0).abs().max())
                        line = (f"{name} T={m.shape[0]} C={C} {chunk_mode} "
                                f"{dot} {div} tile {tile}: ")
                        if dot == "vpu":
                            same = (torch.equal(got[0], want[0])
                                    and torch.equal(got[1], want[1]))
                            k5_same = (torch.equal(got[0], k5[0])
                                       and torch.equal(got[1], k5[1]))
                            say(line + f"= plain bit for bit {same}"
                                + (f", = K5 {k5_same}" if div == "recip"
                                   else ""))
                            require(same, f"{line}vpu = plain bit for bit")
                            require(div == "div" or k5_same,
                                    f"{line}(vpu, recip) = K5 bit for bit")
                            err["vpu"] = max(err["vpu"], e)
                        else:
                            rule = labs.mxu_rule(dirs_t, table, got, want)
                            say(line + f"against plain 3xTF32 {rule}, max "
                                f"|dt| {e:.3g}")
                            require(rule["t_over"] == 0 and
                                    rule["other"] == 0,
                                    f"{line}mxu within the 3xTF32 rule")
                            for k in near:
                                near[k] += rule[k]
                            err["mxu"] = max(err["mxu"], e)
    require(labs.LAUNCHES_KERNEL_LAB - before == launched,
            "L1: one launch a wrapper call")
    m, k0, valid = scenes["cornell32"]
    for bad, what in ((dict(tile_r=1024), "tile_r"),
                      (dict(tile_r=2048, dirs_t=dirs_t[:, :R - 256]),
                       "F23")):
        try:
            labs.kernel_lab_variant(bad.pop("dirs_t", dirs_t), m, k0, valid,
                                    chunk_mode="tight", dot="vpu",
                                    div="recip", **bad)
            refused = ""
        except ValueError as exc:
            refused = str(exc)
        require(what in refused, f"L1 refuses {what}: {refused!r}")
    say(f"L1: {launched} launches, mxu near-ties {near['near_tie']}, "
        f"near-edges {near['near_edge']} (counted, allowed by the rule)")

    probe = {}
    counts0 = (labs.LAUNCHES_ONESTEP, labs.LAUNCHES_NOOP)
    for pad in (32, 64, 128):
        x = probe[pad] = lab_inputs(Lights.single(capacity=1, device=dev),
                                    512, dev, pad_to=pad)
        m, k0, valid, m_l, k0_l = x["consts"][0:5]
        x["table_k4"] = constant_table(m, k0, valid, m_l[None], k0_l[None],
                                       x["C"])
        args = x["probe_args"] = (x["dirs_t"], x["table_k4"], x["cam_pos"],
                                  x["light_pos"], 2048, x["C"])
        one, again = labs.run_onestep(*args), labs.run_onestep(*args)
        nop = labs.run_noop(*args)
        k4 = isect.closest_hit_occluded(x["dirs"], m, k0, valid, m_l, k0_l,
                                        x["cam_pos"], x["light_pos"])
        plain_one = labs.run_onestep_reference(*args)
        plain_nop = labs.run_noop_reference(*args)
        torch.cuda.synchronize()
        m_k4 = [int((a[0] != b).sum()) for a, b in zip(one, k4)]
        m_plain = [int((a != b).sum()) for a, b in zip(one, plain_one)]
        m_again = [int((a != b).sum()) for a, b in zip(one, again)]
        m_nop = [int((a != b).sum()) for a, b in zip(nop, plain_nop)]
        miss = one[1] < 0
        say(f"L2/L3 512^2 clean T={pad} C={x['C']}: L2 vs K4 [t, idx, occ] "
            f"{m_k4} on all rays ({int(miss.sum())} misses, raw bits "
            f"{int(one[2][miss].sum())}); vs plain {m_plain}; two calls "
            f"{m_again}; L3 vs plain {m_nop}, t = dirs x "
            f"{torch.equal(nop[0][0], x['dirs_t'][0])}")
        require(not any(m_k4 + m_plain + m_again + m_nop),
                "L2 = plain = K4 on every ray, L3 = plain, bit for bit")
        require(torch.equal(nop[0][0], x["dirs_t"][0])
                and not nop[1].any() and not nop[2].any(),
                "L3: t = dirs x, idx = occ = 0")
    x_tiny = torch.tensor(np.random.default_rng(35).standard_normal(
        labs.TINY_SHAPE).astype(np.float32), device=dev)
    tiny = labs.run_tiny(x_tiny)
    require(torch.equal(tiny, x_tiny * 2) and torch.equal(
        tiny, labs.run_tiny_reference(x_tiny)), "L4 = x * 2 bit for bit")
    require((labs.LAUNCHES_ONESTEP - counts0[0],
             labs.LAUNCHES_NOOP - counts0[1]) == (6, 3),
            "L2, L3: one launch a wrapper call")
    args = probe[32]["probe_args"]
    for fn in (labs.run_onestep, labs.run_noop):
        for bad, what in ((args[:4] + (3000, args[5]), "F23"),
                          ((args[0], torch.cat([args[1], args[1]], 1))
                           + args[2:], "one chunk")):
            try:
                fn(*bad)
                refused = ""
            except ValueError as exc:
                refused = str(exc)
            require(what in refused, f"L2/L3 refuse {what}: {refused!r}")

    # Each kernel alone (held stream, past the wrappers' packing) beside
    # K5 or K4 on the same inputs, its plain version and its bound.
    t, bounds = {}, {}
    for name in scenes:
        fns = {}
        m, k0, valid = scenes[name]
        k5_table, C5 = isect.primary_table(m, k0, valid, 512)
        k5_out = isect._outputs(dirs, 0)[:2]
        fns[(name, "k5")] = (lambda tb=k5_table, c=C5, o=k5_out:
                             isect.launch_closest_kernel(dirs, tb, c, None,
                                                         None, *o))
        for chunk_mode in labs.CHUNK_MODES:
            table, C = tables[name, chunk_mode]
            for tile in labs.KERNEL_LAB_TILES:
                for dot in labs.DOTS:
                    for div in labs.DIVS:
                        if name == "cornell32" and tile != 2048:
                            continue
                        key = (name, tile, chunk_mode, dot, div)
                        out = isect._outputs(dirs, 0)[:2]
                        fns[key] = (lambda tb=table, c=C, a=(tile, dot, div),
                                    o=out: labs.launch_kernel_lab(
                                        dirs_t, tb, c, *a, *o))
                        bounds[key] = kernel_lab_bound(R, table, C, dot, div)
        t.update(median_ms_in_turns(fns, n=5, reps=3, timer=held_ms))
    # The kernels line's L1 numbers: K5's function (tight, vpu, recip) at
    # tile 2048 on the 9,216-triangle scene; the mxu twin beside it.
    main_key = ("stl9216", 2048, "tight", "vpu", "recip")
    mxu_key = ("stl9216", 2048, "tight", "mxu", "recip")
    t["l1"], bounds["l1"] = t[main_key], bounds[main_key]
    stl_table, stl_c = tables["stl9216", "tight"]
    t.update(median_ms_in_turns({
        "l1_plain": lambda: labs.lab_sweep_reference(dirs_t, stl_table,
                                                     stl_c, "vpu", "recip"),
        "l1_mxu_plain": lambda: labs.lab_sweep_reference(
            dirs_t, stl_table, stl_c, "mxu", "recip")}, n=1, reps=3))
    x = probe[32]
    a = x["probe_args"]
    dirs32 = x["dirs"]
    outs = {k: (torch.empty((1, R), device=dev),
                torch.empty((1, R), dtype=torch.int32, device=dev),
                torch.empty((1, R), dtype=torch.int32, device=dev))
            for k in ("l2", "l3", "k4")}
    src32 = x["light_pos"].reshape(1, 3).contiguous()
    t.update(median_ms_in_turns({
        "l2": lambda: labs.launch_k4_probe(*a[:4], False, *outs["l2"]),
        "l3": lambda: labs.launch_k4_probe(*a[:4], True, *outs["l3"]),
        "k4": lambda: isect.launch_occluded_kernel(
            dirs32, a[1], a[2], src32, *outs["k4"]),
        "l4": lambda: labs.run_tiny(x_tiny),
        "l4_library": lambda: x_tiny * 2}, n=20, reps=7, timer=held_ms))
    # The plain versions launch tens of ops a call: fewer calls a hold.
    t.update(median_ms_in_turns({
        "l2_plain": lambda: labs.run_onestep_reference(*a),
        "l3_plain": lambda: labs.run_noop_reference(*a),
        "l4_plain": lambda: labs.run_tiny_reference(x_tiny)}, n=3, reps=5,
        timer=held_ms))
    l2_case = dict(dirs=dirs32, table=a[1], cam=a[2], src=src32)
    l2_work = sweep_work(l2_case, False)
    bounds["l2"] = sweep_bound(l2_case, False, l2_work)
    l2_bound_old = sweep_bound(l2_case, False, l2_work, reject=False)
    bounds["l3"] = bound_ms(R * 16 + (a[1].numel() + 6) * 4, 0)
    bounds["l4"] = bound_ms(2 * x_tiny.numel() * 4, x_tiny.numel())
    card = card_line()
    say(f"512^2, device time a call (CUDA events, median of turns; "
        f"{card}):")
    for name in scenes:
        say(f"  {name}: K5 {t[(name, 'k5')]:.4f} ms")
        for key in (k for k in bounds if isinstance(k, tuple)
                    and k[0] == name):
            say(f"  {name} tile {key[1]} {key[2]:6s} {key[3]} {key[4]:5s} "
                f"{t[key]:.4f} ms (bound {bounds[key][0]:.4f} ms, "
                f"{bounds[key][1]})")
    say(f"  plain L1 stl9216 (tight, vpu, recip) {t['l1_plain']:.4f} ms, "
        f"(tight, mxu, recip) {t['l1_mxu_plain']:.4f} ms (back to back)")
    for k in ("l2", "l3", "l4"):
        say(f"  {k.upper()} {t[k]:.4f} ms (plain {t[k + '_plain']:.4f}; "
            f"bound {bounds[k][0]:.5f} ms, {bounds[k][1]})")
    say(f"  K4 (same inputs as L2) {t['k4']:.4f} ms; x * 2 "
        f"{t['l4_library']:.4f} ms; L2's bound before the cull "
        f"{l2_bound_old[0]:.5f} ms, {l2_bound_old[1]}; L2's cull on "
        f"consecutive rays: {sweep_cull_line(l2_work['cull'])}")
    say(f"phase 35 took {time.perf_counter() - t_phase:.1f} s")

    say("== phase 36: labs 1, 2 and 3 as a user runs them (subprocesses)")
    t_phase = time.perf_counter()
    lab1 = run_lab("kernel_lab")
    lab2 = run_lab("megakernel_lab2")
    lab3 = run_lab("megakernel_lab3")
    say(f"lab 1 (512^2 clean; ms a call over 30 calls, CUDA events; "
        f"{lab1['card']}):")
    for name, sc in lab1["scenes"].items():
        say(f"  [{name}] T={sc['T']} shipped (K5) {sc['shipped_ms']:.4f}")
        for r in sc["variants"]:
            say(f"  [{name}] tile={r['tile']} {r['chunk']:6s} {r['dot']} "
                f"{r['div']:5s}: {r['ms']:.4f} ms idx!={r['idx_mismatch']} "
                f"t!={r['t_mismatch']}")
            if (r["dot"], r["div"]) == ("vpu", "recip"):
                require(r["idx_mismatch"] == r["t_mismatch"] == 0,
                        "lab 1: (vpu, recip) = the shipped K5")
    say(f"lab 2 (512^2 clean, Cornell; lab 2's estimator, ms a call, eager "
        f"/ graph; {lab2['card']}):")
    for pad, rows in lab2["rows"].items():
        for row, v in rows.items():
            say(f"  T={pad} {row:14s} {v['eager']:.4f} / {v['graph']:.4f}")
        require(not any(sum((list(mm.values()) for mm in
                             lab2["mismatch"][pad].values()), [])),
                "lab 2: L2 = K4, L3 exact")
    say(f"lab 3 (ms a chain of 5 / 20 / 80 calls; slope us a call, fixed "
        f"ms; {lab3['card']}):")
    for name, case in lab3["cases"].items():
        for col in ("eager", "graph"):
            f = case[col]
            ts = f["totals"]
            say(f"  {name:12s} {col:5s} {ts['5']:.4f} / {ts['20']:.4f} / "
                f"{ts['80']:.4f}: slope {f['slope_ms'] * 1e3:.2f} us, fixed "
                f"{f['fixed_ms']:.4f} ms")
    launched = {}
    for res in (lab1, lab2, lab3):
        for k, v in res["launches"].items():
            launched[k] = launched.get(k, 0) + v
    say(f"lab path launches (the three lab processes, graph replays "
        f"counted): {launched}")
    require(all(launched.get(k, 0) > 0 for k in (
        "kernel_lab_variant", "lab2_onestep", "lab2_noop", "lab3_tiny")),
        "the labs launched L1, L2, L3 and L4")
    say(f"phase 36 took {time.perf_counter() - t_phase:.1f} s")
    record["kernel_labs"] = dict(
        err=err, near=near, lab1=lab1, lab2=lab2, lab3=lab3,
        launches=launched, kernel_ms={str(k): v for k, v in t.items()},
        bounds={str(k): v for k, v in bounds.items()})

    def entry(name, key, replaces, launches, max_err, source, **extra):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches,
                    max_abs_err=max_err, ms=t[key],
                    plain_ms=t[f"{key}_plain"], bound_ms=bounds[key][0],
                    bound_by=bounds[key][1], library_ms=None, **extra)

    return [
        entry("kernel_lab_variant", "l1", "bench/kernel_lab.py:138",
              launched["kernel_lab_variant"], err["vpu"],
              "raytpu_torch/csrc/kernel_lab.cu",
              k5_ms=t[("stl9216", "k5")],
              mxu=dict(max_abs_err=err["mxu"], **near, ms=t[mxu_key],
                       plain_ms=t["l1_mxu_plain"]),
              variants={" ".join(map(str, k)): dict(
                  ms=t[k], bound_ms=bounds[k][0], bound_by=bounds[k][1])
                  for k in bounds if isinstance(k, tuple)}),
        entry("lab2_onestep", "l2", "bench/megakernel_lab2.py:88",
              launched["lab2_onestep"], 0.0,
              "raytpu_torch/csrc/intersect.cu",
              k4_ms=t["k4"]),
        entry("lab2_noop", "l3", "bench/megakernel_lab2.py:131",
              launched["lab2_noop"], 0.0, "raytpu_torch/csrc/labs.cu"),
        dict(entry("lab3_tiny", "l4", "bench/megakernel_lab3.py:54",
                   launched["lab3_tiny"], 0.0, "raytpu_torch/csrc/labs.cu"),
             library_ms=t["l4_library"]),
    ]


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
    from raytpu_torch.kernels.tables import GATHERED, PARAMS, tight_chunk
    from raytpu_torch.oracle import raytracer_oracle
    from raytpu_torch.render import animate as animate_mod
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
        # K1's warps as raytrace_full lays them over the image.
        tiled = render_fused.render_hard_fused(*args, **kw,
                                               image_hw=(size, size))
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, tiled)),
                "K1 over the image's warps = over consecutive rays")
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
    img_o, fd_o = raytracer_oracle.render(cornell_box_numpy(), width=500,
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

    say("== phase 5: a few requests (an 8-frame key script through animate, "
        "the animate CLI at --preset realtime)")
    before = render_fused.LAUNCHES
    keys = expand_script("left*2,up*2,w*2,a*2")
    with spy_frames(animate_mod, "raytrace") as rendered:
        res = animate(cornell_box(pad_to=32, device=dev),
                      Camera.raytracer_default(device=dev),
                      Lights.single(capacity=1, device=dev), cfg, keys,
                      out_dir=str(OUT / "animate_keys"))
    frame_launches = render_fused.LAUNCHES - before
    say(f"{res.n_frames} frames, {res.fps:.1f} frames/s, "
        f"{res.ms_per_frame:.3f} ms/frame host clock, warm render "
        f"{res.compile_s:.3f} s, {len(res.paths)} BMPs, kernel launches "
        f"{frame_launches}")
    require(frame_launches == len(keys) + 1 == 9,
            "one launch per frame and one for the warm render")
    check_written_frames(res, rendered[1:], 1)
    before = render_fused.LAUNCHES
    anim_dir = OUT / "animate"
    shutil.rmtree(anim_dir, ignore_errors=True)
    with contextlib.redirect_stdout(io.StringIO()) as text:
        cli_main(["animate", "--preset", "realtime", "--out-dir",
                  str(anim_dir), "--save-every", "8"])
    anim = json.loads(text.getvalue().strip().splitlines()[-1])
    cli_launches = render_fused.LAUNCHES - before
    bmps = sorted(anim_dir.glob("frame_*.bmp"))
    say(f"animate CLI --preset realtime: {anim} ({cli_launches} K1 "
        f"launches, {len(bmps)} BMPs in {anim_dir.relative_to(ROOT)})")
    require(cli_launches == anim["frames"] + 1 == 101,
            "the CLI: one K1 a frame and one for the warm render")
    require(anim["saved"] == len(bmps) == 13 and anim["fps"] > 0
            and anim["compile_s"] >= 0, "every 8th of 100 frames written")
    firsts = [read_bmp(str(p)) for p in (bmps[0], bmps[-1])]
    require(all(f.shape == (150, 150, 3) and f.max() > 80 for f in firsts)
            and not np.array_equal(*firsts), "lit 150^2 frames that move")
    launches = render_fused.LAUNCHES
    say(f"main path launches: render_fused_fwd {launches}")
    require(launches > 0, "the main path launched the kernel")
    record["animate_ms_per_frame_host"] = res.ms_per_frame
    record["animate_cli"] = anim

    say("== phase 6: card numbers (512^2 clean forward, CUDA events)")
    args, kw = frame_args(512, "clean", 32)
    table, params = render_fused.pack_inputs(*args[1:], kw["tri_chunk"])
    dirs = args[0]

    def k1():
        return render_fused.fused_fwd(dirs, table, params,
                                      ambient=kw["ambient"], parity=False,
                                      image_hw=(512, 512))

    def k1_plain():
        return render_fused.fused_fwd_reference(
            dirs, table, params, ambient=kw["ambient"], parity=False)

    kernel_ms = median_ms_in_turns({"kernel": k1, "plain": k1_plain},
                                   n=50, reps=9)
    k1_ms = median_ms_in_turns({"kernel": k1, "plain": k1_plain}, n=5,
                               reps=9, timer=held_ms)
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
    # K1's work on this frame: 36 B a ray in and out plus the tables, its
    # culled sweeps' work on the image's warps (sweep_cull_work) and the
    # shading of each hit ray; before the cull, C plane tests a ray in the
    # primary sweep and the shadow sweep's tests up to the first blocker.
    out = k1_plain()
    R, C = dirs.shape[0], table.shape[1]
    k1_work = sweep_cull_work(dirs, table, params[0:3], params[3:6],
                              (512, 512))
    k1_bytes = R * 36 + (table.numel() + params.numel()) * 4
    k1_shade = FLOPS_FWD_SHADE * int((out.idx >= 0).sum())
    k1_bound = bound_ms(k1_bytes, sweep_cull_flops(k1_work) + k1_shade)
    k1_bound_old = bound_ms(k1_bytes, FLOPS_PLANE_TEST * (
        R * C + shadow_tests(dirs, table, params)) + k1_shade)
    # The card's cull decisions on K1's inputs (the probe kernel) against
    # their plain form, on the image's warps and on consecutive rays, here
    # and on phase 3's 500^2 parity frame.
    k1_probe = {}
    for size, mode, pad_to in ((512, "clean", 32), (500, "parity", None)):
        p_args, p_kw = frame_args(size, mode, pad_to)
        p_table, p_params = render_fused.pack_inputs(*p_args[1:],
                                                     p_kw["tri_chunk"])
        for hw in ((size, size), None):
            k1_probe[f"{size}_{mode}_{'image' if hw else 'rays'}"] = (
                sweep_probe_check(p_args[0], p_table, p_params[0:3],
                                  p_params[3:6], hw))
    card = card_line()
    say(f"K1 alone, 512^2 C={tight_chunk(32, 512)}: device time "
        f"{k1_ms['kernel']:.4f} ms kernel, {k1_ms['plain']:.4f} ms plain; "
        f"back to back (host included) {kernel_ms['kernel']:.4f} ms kernel, "
        f"{kernel_ms['plain']:.4f} ms plain; bound {k1_bound[0]:.4f} ms "
        f"({k1_bound[1]}; before the cull {k1_bound_old[0]:.4f} ms, "
        f"{k1_bound_old[1]}) ({card})")
    say(f"K1's cull, 512^2 clean on 8 x 4 warps: {sweep_cull_line(k1_work)}")
    for name, pr in k1_probe.items():
        say(f"K1's cull probe, {name}: {sweep_probe_line(pr)}")
    say(f"forward frame 512^2 clean: {frame_ms['kernel']:.4f} ms through the "
        f"kernel, {frame_ms['plain']:.4f} ms through the plain version "
        f"({card})")
    record.update(card=card, kernel_ms=kernel_ms, k1_device_ms=k1_ms,
                  k1_bound=k1_bound, k1_bound_pre_cull=k1_bound_old,
                  k1_cull=k1_work, k1_probe=k1_probe, frame_ms=frame_ms,
                  main_path_launches=launches, max_abs_err=max_err)

    say("== phase 7: backward kernels against their plain version")
    # K2's own output is g_dirs; g_table and g_params come out of K3.
    bwd_err = {"rays": 0.0, "sums": 0.0}
    for size, mode, pad_to in ((512, "clean", 32), (500, "parity", None),
                               (1024, "clean", 32)):
        bargs, bkw = bwd_args(*frame_args(size, mode, pad_to), seed=size)
        got = render_fused.fused_bwd(*bargs, **bkw)
        again = render_fused.fused_bwd(*bargs, **bkw)
        plain = render_fused.fused_bwd_reference(*bargs, **bkw)
        want = render_fused.fused_bwd_reference(
            *(a.double() if a.is_floating_point() else a for a in bargs),
            **bkw)
        torch.cuda.synchronize()
        line = []
        for name, g, p, w in zip(("g_dirs", "g_table", "g_params"), got,
                                 plain, want):
            require(bool(torch.isfinite(g).all()), f"finite {name}")
            tol = GRAD_ATOL + GRAD_RTOL * w.abs()
            err = (g.double() - w).abs()
            line.append(f"{name} max|d| {float(err.max()):.3g} (of tol "
                        f"{float((err / tol).max()):.3f}; float32 plain "
                        f"{float(((p.double() - w).abs() / tol).max()):.3f})")
            require(bool((err <= tol).all()),
                    f"{name} within rtol {GRAD_RTOL} / atol {GRAD_ATOL}")
            key = "rays" if name == "g_dirs" else "sums"
            bwd_err[key] = max(bwd_err[key], float(err.max()))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        say(f"{size}^2 {mode}: {', '.join(line)}; two calls bit-identical "
            f"{same}")
        require(same, "two kernel calls bit-identical")
        record[f"bwd_compare_{size}_{mode}"] = line

    say("== phase 8: the train path (512^2 clean, SGD on scene + lights)")
    step512 = train_step(*bench_frame(dev, 512), 1e-9)
    for name in ("LAUNCHES", "LAUNCHES_BWD", "LAUNCHES_SCATTER"):
        setattr(render_fused, name, 0)
    losses = [step512() for _ in range(20)]
    train_launches = {"render_fused_fwd": render_fused.LAUNCHES,
                      "render_fused_bwd": render_fused.LAUNCHES_BWD,
                      "render_fused_scatter": render_fused.LAUNCHES_SCATTER}
    say(f"20 steps, loss {float(losses[0]):.6g} -> {float(losses[-1]):.6g}; "
        f"train path launches: {train_launches}")
    require(all(n == 20 for n in train_launches.values()),
            "each step launches K1, K2 and K3 exactly once")
    require(all(bool(torch.isfinite(x)) for x in losses), "finite losses")

    fit_losses = fit_albedo(dev, 512, lr=1.0, steps=50)
    say(f"albedo fit 512^2 (lr 1.0): loss {fit_losses[0]:.6g} -> "
        f"{fit_losses[-1]:.6g} in {len(fit_losses)} steps")
    require(all(b < a for a, b in zip(fit_losses, fit_losses[1:])),
            "the fit's loss falls at every step")
    require(fit_losses[-1] < 0.1 * fit_losses[0],
            "the fit ends below 10% of its start loss")

    def plain_bwd(fn):
        def run():
            # The step with the backward wrapper swapped for the plain
            # version, for this measurement only.
            launch = render_fused.fused_bwd
            render_fused.fused_bwd = render_fused.fused_bwd_reference
            try:
                return fn()
            finally:
                render_fused.fused_bwd = launch
        return run

    step_ms = median_ms_in_turns({"kernels": step512,
                                  "plain_bwd": plain_bwd(step512)},
                                 n=1, reps=31)
    bargs, bkw = bwd_args(*frame_args(512, "clean", 32), seed=0)
    b_dirs, b_table, b_idx = bargs[0], bargs[1], bargs[3]
    R, C = b_dirs.shape[0], b_table.shape[1]
    blocks = -(-R // render_fused.BWD_RAYS_PER_BLOCK)
    cols = len(GATHERED) * C + PARAMS
    g_dirs = torch.empty((R, 3), device=dev)
    partials = torch.empty((blocks, cols), device=dev)
    g_table = torch.empty_like(b_table)
    g_params = torch.empty((PARAMS,), device=dev)
    render_fused.launch_bwd_kernel(*bargs, bkw["ambient"], bkw["parity"],
                                   g_dirs, partials)
    rays = render_fused.bwd_rays_reference(*bargs, **bkw)
    win, g_rays = b_idx.clamp_min(0).long(), rays[1].T.contiguous()

    def index_add():
        # K3's function as one PyTorch call: the per-ray cotangents summed
        # by winner (a miss adds its zeros to triangle 0).
        return torch.zeros((len(GATHERED), C), device=dev).index_add_(
            1, win, g_rays)

    bwd_ms = median_ms_in_turns({
        "kernels": lambda: render_fused.fused_bwd(*bargs, **bkw),
        "plain": lambda: render_fused.fused_bwd_reference(*bargs, **bkw),
    }, n=2, reps=9, timer=held_ms)
    k2_ms = median_ms_in_turns({
        "kernel": lambda: render_fused.launch_bwd_kernel(
            *bargs, bkw["ambient"], bkw["parity"], g_dirs, partials),
        "plain": lambda: render_fused.bwd_rays_reference(*bargs, **bkw),
    }, n=2, reps=9, timer=held_ms)
    k3_ms = median_ms_in_turns({
        "kernel": lambda: render_fused.launch_scatter_kernel(
            partials, g_table, g_params),
        "plain": lambda: render_fused.scatter_reference(
            b_idx, rays[1], rays[2], C),
        "index_add_": index_add,
    }, n=5, reps=9, timer=held_ms)
    nhit = int((b_idx >= 0).sum())
    k2_bound = bound_ms(R * (12 + 4 + 4 + 12 + 4 + 12)
                        + (len(GATHERED) * C + PARAMS) * 4
                        + blocks * cols * 4,
                        FLOPS_BWD_HIT * nhit)
    k3_bound = bound_ms(blocks * cols * 4 + (b_table.numel() + PARAMS) * 4,
                        blocks * cols)
    say(f"train step 512^2 clean (CUDA events, median of 31): "
        f"{step_ms['kernels']:.4f} ms through K2/K3, "
        f"{step_ms['plain_bwd']:.4f} ms through the plain backward ({card})")
    say(f"backward alone, device time: K2+K3 {bwd_ms['kernels']:.4f} ms, "
        f"plain {bwd_ms['plain']:.4f} ms; K2 {k2_ms['kernel']:.4f} ms "
        f"(plain {k2_ms['plain']:.4f}, bound {k2_bound[0]:.4f} "
        f"{k2_bound[1]}); K3 {k3_ms['kernel']:.4f} ms (plain "
        f"{k3_ms['plain']:.4f}, index_add_ {k3_ms['index_add_']:.4f}, "
        f"bound {k3_bound[0]:.5f} {k3_bound[1]}); {nhit} hit rays of {R} "
        f"({card})")
    busy = device_busy(step512, steps=10)
    say(f"profile of 10 steps: device busy {busy['busy_ms']:.4f} ms a step "
        f"in {busy['kernels']} device events; {busy['wall_ms']:.4f} ms a "
        f"step on the host clock under the profiler (share "
        f"{busy['share']}), {step_ms['kernels']:.4f} ms without it")
    for name, ms in busy["by_name"][:8]:
        say(f"  {ms:.5f} ms  {name[:100]}")
    step1024 = train_step(*bench_frame(dev, 1024), 1e-9)
    step1024_ms = median_ms_in_turns({"kernels": step1024}, n=1, reps=31)
    say(f"train step 1024^2 clean: {step1024_ms['kernels']:.4f} ms through "
        f"K2/K3 ({card})")
    record.update(train_launches=train_launches, fit_losses=fit_losses,
                  step_ms=step_ms, bwd_ms=bwd_ms, k2_ms=k2_ms, k3_ms=k3_ms,
                  k2_bound=k2_bound, k3_bound=k3_bound, profile=busy,
                  step1024_ms=step1024_ms, bwd_max_abs_err=bwd_err)

    say("== phase 9: K4 and K6 against their plain versions on the card")
    from raytpu_torch.kernels import intersect as isect
    from raytpu_torch.view import ViewerApp, serve
    cases = {
        # 512^2 clean, one light: K4.
        "k4_512_clean": (sweep_case(dev, 512, "clean", 32, Lights.single(
            capacity=1, device=dev), 1, (0.0, 0.0)), False),
        # The bench's full-feature sources, 2 lights x 16 samples, at the
        # first AA sub-ray and at the central one: K6 with S = 32.
        "k6_512_clean_s32": (sweep_case(dev, 512, "clean", 32,
                                        full_feature_lights(dev), 16,
                                        (-0.5, -0.5)), True),
        "k6_512_clean_s32_aa4": (sweep_case(dev, 512, "clean", 32,
                                            full_feature_lights(dev), 16,
                                            (0.0, 0.0)), True),
        # 500^2 parity, 30 triangles, at the AA sub-ray (0.5, 0): K4.
        "k4_500_parity": (sweep_case(dev, 500, "parity", None, Lights.single(
            capacity=1, device=dev), 1, (0.5, 0.0)), False),
    }
    sweep_err = {False: 0.0, True: 0.0}
    sweep_works = {}
    for name, (case, multi) in cases.items():
        got = run_sweeps(case, multi)
        again = run_sweeps(case, multi)
        want = isect.sweeps_reference(case["dirs"], case["table"], case["cam"],
                                      case["src"], mask_misses=multi)
        if not multi:
            # K4's warps over consecutive rays (L2's) give the same bits.
            rays = run_sweeps(case, multi, image_hw=None)
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in zip(got, rays)),
                    f"{name}: K4 on consecutive rays = on the image's warps")
        torch.cuda.synchronize()
        idx_mis = int((got[1] != want[1]).sum())
        occ_mis = int((got[2] != want[2]).sum())
        t_same = torch.equal(got[0], want[0])
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        hits = float((got[1] >= 0).float().mean())
        # The VJP of t against its float64 evaluation, one-signed
        # cotangents as in phase 7.
        rng = np.random.default_rng(len(name))
        t_bar = torch.tensor(rng.uniform(0.5, 1.5, got[0].shape[0]).astype(
            np.float32), device=dev)
        vjp_args = (case["dirs"], case["m"], case["k0"], got[0], got[1],
                    t_bar)
        g32 = isect.closest_hit_vjp(*vjp_args)
        g64 = isect.closest_hit_vjp(*(
            a.double() if a.is_floating_point() else a for a in vjp_args))
        vjp_line = []
        for gname, g, w in zip(("g_dirs", "g_m", "g_k0"), g32, g64):
            require(bool(torch.isfinite(g).all()), f"finite {gname}")
            tol = GRAD_ATOL + GRAD_RTOL * w.abs()
            err = (g.double() - w).abs()
            vjp_line.append(f"{gname} {float((err / tol).max()):.3f} of tol")
            require(bool((err <= tol).all()),
                    f"VJP {gname} within rtol {GRAD_RTOL} / atol {GRAD_ATOL}")
        say(f"{name} (S={case['src'].shape[0]}, C={case['table'].shape[1]}):"
            f" idx mismatches {idx_mis}, occ mismatches {occ_mis}, t "
            f"bit-identical {t_same}, two calls identical {same}, hit rays "
            f"{hits:.4f}, occluded {int(got[2].sum())}; VJP vs float64: "
            f"{', '.join(vjp_line)}")
        require(idx_mis == 0 and occ_mis == 0 and t_same,
                f"{name}: t, idx and occ bit-identical to the plain version")
        require(same, f"{name}: two kernel calls identical")
        require(bool(got[2].any()), f"{name}: some ray is occluded")
        sweep_err[multi] = max(sweep_err[multi],
                               float((got[0] - want[0]).abs().max()))
        record[f"sweeps_{name}"] = dict(idx_mismatch=idx_mis,
                                        occ_mismatch=occ_mis, t_equal=t_same,
                                        repeat_equal=same, vjp=vjp_line)
        if multi:
            # K6's exact reject on every shadow test of the hit rays.
            work = sweep_work(case, True)
            sweep_works[name] = work
            say(f"  K6's reject: {work['rejected']} of {work['shadow']} "
                f"shadow tests to the first blocker decided "
                f"({work['rejected'] / max(1, work['shadow']):.6f}), "
                f"{work['reject_wrong']} blocking tests rejected; hit rays "
                f"{work['hit']:.4f}")
            require(work["reject_wrong"] == 0,
                    f"{name}: K6's reject rejects no blocking test")
            record[f"sweeps_{name}"]["reject"] = work

    say("== phase 10: the loop branch serving (AA frame, render CLI, view "
        "server)")
    zero_counts()
    before = kernel_counts()
    cfg_aa = RenderConfig(aa_samples=3)  # the CLI's defaults with --aa 3
    out = raytrace_full(cornell_box(device=dev),
                        Camera.raytracer_default(device=dev),
                        Lights.single(capacity=1, device=dev), cfg_aa)
    img = out.image.cpu().numpy()
    aa_launches = delta(before, kernel_counts())
    say(f"500^2 parity --aa 3 frame: launches {aa_launches}")
    require(aa_launches == {"closest_hit_occluded": 9},
            "an AA 3 frame launches K4 9 times and nothing else")
    require(np.isfinite(img).all() and not img[0].any()
            and img[1:-1, 1:-1].max() > 0.3, "finite, black border, lit")
    t0 = time.perf_counter()
    img_o, _ = raytracer_oracle.render(cornell_box_numpy(), width=500,
                                    height=500, aa_samples=3)
    err = np.abs(img - img_o) - (F32_ATOL + F32_RTOL * np.abs(img_o))
    f32_ok = float((err.max(axis=-1) <= 0).mean())
    u8_ok = float((np.abs(quantize_u8(img).astype(int)
                          - quantize_u8(img_o).astype(int)).max(axis=-1)
                   <= 1).mean())
    say(f"vs numpy oracle, AA 3 ({time.perf_counter() - t0:.1f} s): "
        f"f32-close pixels {f32_ok:.6f}, u8 within 1 {u8_ok:.6f}")
    require(u8_ok >= AA_U8_FRAC, "u8 within 1 step on >= 99.5% of pixels")
    require(f32_ok >= FLIP_FRAC, "f32 atol 2e-4 on all but <= 0.1% pixels")
    record["oracle_aa3"] = dict(f32_ok=f32_ok, u8_ok=u8_ok)

    before = kernel_counts()
    bmp = OUT / "full_feature.bmp"
    cli_main(["render", "--aa", "3", "--soft-shadows", "16", "--add-light",
              "0.4", "-0.5", "-0.7", "1", "1", "1", "7", "--dof", "-o",
              str(bmp)])
    cli_launches = delta(before, kernel_counts())
    frame_u8 = read_bmp(str(bmp))
    say(f"render CLI --aa 3 --soft-shadows 16 --add-light --dof: "
        f"{frame_u8.shape}, launches {cli_launches}")
    require(frame_u8.shape == (500, 500, 3)
            and frame_u8[1:-1, 1:-1].max() > 80, "a lit full-feature BMP")
    require(cli_launches == {"closest_hit_occluded_multi": 9},
            "the full-feature frame launches K6 9 times and nothing else")

    app = ViewerApp(cornell_box(device=dev),
                    Camera.raytracer_default(device=dev),
                    Lights.single(capacity=32, soft_samples=16, device=dev),
                    RenderConfig(), seed=0)  # the view CLI's defaults
    server = serve(app, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    k1, k4, k6 = ("render_fused_fwd", "closest_hit_occluded",
                  "closest_hit_occluded_multi")
    # (request, the launches it must make): K1 with everything off, K4 a
    # sub-ray with one light and hard shadows, K6 a sub-ray otherwise.
    requests = [("/", {}), ("/frame.bmp", {k1: 1}), ("/key?k=7", {k4: 9}),
                ("/key?k=8", {k6: 9}), ("/key?k=2", {k6: 9}),
                ("/key?k=9", {k6: 9}), ("/key?k=up", {k6: 9}),
                ("/key?k=3", {k6: 9}), ("/key?k=8", {k4: 9}),
                ("/key?k=7", {k1: 1}), ("/frame.bmp", {}), ("/state", {})]
    try:
        for path, want in requests:
            before = kernel_counts()
            t0 = time.perf_counter()
            with urllib.request.urlopen(base + path, timeout=300) as r:
                status, body = r.status, r.read()
            ms = (time.perf_counter() - t0) * 1e3
            got = delta(before, kernel_counts())
            say(f"GET {path}: {status}, {len(body)} bytes, {ms:.1f} ms, "
                f"launches {got}")
            require(status == 200, f"{path} answered 200")
            require(got == want, f"{path} launches {want}")
            require(app._frame is None or np.isfinite(app._frame).all(),
                    "finite frames")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    state = json.loads(body)
    require(state["lights"] == 1 and state["dof"] and not state["aa"],
            "the viewer's state follows the keys")
    serve_launches = kernel_counts()  # zeroed where phase 10 began
    say(f"serving path launches: {serve_launches}")
    require(all(serve_launches[k] > 0 for k in (k1, k4, k6)),
            "the serving path launched K1, K4 and K6")

    say("== phase 11: the loop branch training (the bench's full-feature "
        "step, 512^2)")
    scene_f, camera_f, lights_f, cfg_f = full_feature_frame(dev, 512)
    # A target 10% darker than the start, so that every gradient is
    # nonzero and its finiteness means something.
    step_full = train_step(scene_f, camera_f, lights_f, cfg_f, 1e-9,
                           target_scale=0.9)
    zero_counts()
    losses = [step_full() for _ in range(3)]
    full_launches = kernel_counts()
    say(f"3 steps, loss {float(losses[0]):.6g} -> {float(losses[-1]):.6g}; "
        f"train path launches: {full_launches}")
    require(full_launches[k6] == 27 and full_launches[k4] == 0
            and full_launches[k1] == 0
            and full_launches["render_fused_bwd"] == 0
            and full_launches["render_fused_scatter"] == 0,
            "each step launches K6 9 times and no other kernel")
    # A leaf the frame does not read (Lights.position, where soft shadows
    # shade from the jittered positions) has no gradient; Scene.active
    # takes no part in it, as in the JAX package.
    for value in (scene_f, lights_f):
        for name, leaf in vars(value).items():
            require(leaf.grad is None
                    or bool(torch.isfinite(leaf.grad).all()),
                    f"finite gradient of {name}")
    require(scene_f.active.grad is None or not scene_f.active.grad.any(),
            "no gradient of Scene.active")
    require(all(float(leaf.grad.abs().max()) > 0.0 for leaf in (
        scene_f.v0, scene_f.color, lights_f.color, lights_f.jitter)),
        "vertices, albedo, light colors and jittered positions take a "
        "gradient")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_full()
    torch.cuda.synchronize()
    step_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def full_frame():
        with torch.no_grad():
            return raytrace(scene_f, camera_f, lights_f, cfg_f)

    full_ms = median_ms_in_turns({"frame": full_frame, "step": step_full},
                                 n=1, reps=11)
    busy_full = device_busy(step_full, steps=3)
    busy_frame = device_busy(full_frame, steps=3)

    k4_case, k6_case = cases["k4_512_clean"][0], cases["k6_512_clean_s32"][0]
    outs = {m: isect._outputs(c["dirs"], c["src"].shape[0])
            for m, c in ((False, k4_case), (True, k6_case))}

    k6_scratch = isect.k6_scratch(k6_case["table"], k6_case["src"])

    def launcher(case, multi):
        if multi:
            return lambda: isect.launch_occluded_multi_kernel(
                case["dirs"], case["table"], case["cam"], case["src"],
                *outs[True], scratch=k6_scratch)
        return lambda: isect.launch_occluded_kernel(
            case["dirs"], case["table"], case["cam"], case["src"],
            *outs[False], image_hw=case["image_hw"])

    def plain(case, multi):
        return lambda: isect.sweeps_reference(case["dirs"], case["table"],
                                              case["cam"], case["src"],
                                              mask_misses=multi)

    k4_ms = median_ms_in_turns({"kernel": launcher(k4_case, False),
                                "plain": plain(k4_case, False)},
                               n=5, reps=9, timer=held_ms)
    # K6 as the wrapper launches it, and with its triangle-major copy
    # staged in shared memory and read from device memory, in turns (the
    # choice: kernels/intersect.py::k6_staged).
    def k6_launcher(staged):
        return lambda: isect.launch_occluded_multi_kernel(
            k6_case["dirs"], k6_case["table"], k6_case["cam"],
            k6_case["src"], *outs[True], scratch=k6_scratch, staged=staged)

    k6_ms = median_ms_in_turns({"kernel": launcher(k6_case, True),
                                "staged": k6_launcher(True),
                                "read": k6_launcher(False)}, n=5, reps=9,
                               timer=held_ms)
    # The plain K6 makes ~40 launches a source, more than the stream holds
    # while a sleep blocks it: timed back to back, where its 33 MB
    # operations keep the device the bottleneck.
    k6_ms.update(median_ms_in_turns({"plain": plain(k6_case, True)}, n=2,
                                    reps=5))
    k6_staging = k6_staging_ms(dev)
    k4_work = sweep_work(k4_case, False)
    k4_bound = sweep_bound(k4_case, False, k4_work)
    k4_bound_old = sweep_bound(k4_case, False, k4_work, reject=False)
    # The card's cull decisions on K4's inputs (the probe kernel) against
    # their plain form, on the image's warps and on consecutive rays (L2's).
    k4_probe = {}
    for name in ("k4_512_clean", "k4_500_parity"):
        c = cases[name][0]
        for hw in (c["image_hw"], None):
            k4_probe[f"{name}_{'image' if hw else 'rays'}"] = (
                sweep_probe_check(c["dirs"], c["table"], c["cam"],
                                  c["src"][0], hw))
    k6_work = sweep_works["k6_512_clean_s32"]
    k6_bound = sweep_bound(k6_case, True, k6_work)
    k6_bound_old = sweep_bound(k6_case, True, k6_work, reject=False)
    card = card_line()
    say(f"K4 alone, 512^2 clean, S=1: {k4_ms['kernel']:.4f} ms device time "
        f"(plain {k4_ms['plain']:.4f} ms; bound {k4_bound[0]:.4f} ms, "
        f"{k4_bound[1]}; before the cull {k4_bound_old[0]:.4f} ms, "
        f"{k4_bound_old[1]}) ({card})")
    say(f"K4's cull, 512^2 clean on 8 x 4 warps: "
        f"{sweep_cull_line(k4_work['cull'])}")
    for name, pr in k4_probe.items():
        say(f"K4's cull probe, {name}: {sweep_probe_line(pr)}")
    say(f"K6 alone, 512^2 clean, S=32: {k6_ms['kernel']:.4f} ms device time "
        f"(staged {k6_ms['staged']:.4f} ms, read through the cache "
        f"{k6_ms['read']:.4f} ms; plain {k6_ms['plain']:.4f} ms back to "
        f"back; bound {k6_bound[0]:.4f} ms, {k6_bound[1]}; without the "
        f"reject {k6_bound_old[0]:.4f} ms) ({card})")
    for row in k6_staging:
        say(f"K6 alone, 512^2 clean, C={row['C']}, S={row['S']} "
            f"({row['copy_kb']:.0f} KB of copy): staged {row['staged']:.4f} "
            f"ms, read through the cache {row['read']:.4f} ms; the wrapper "
            f"{'stages' if row['wrapper_staged'] else 'reads through'} "
            f"({card})")
    say(f"full-feature 512^2 (AA 3, soft 16, 2 lights, DoF): frame "
        f"{full_ms['frame']:.4f} ms, train step {full_ms['step']:.4f} ms "
        f"(CUDA events, median of 11); peak memory of a step "
        f"{step_peak_gb:.3f} GB ({card})")
    say(f"profile of 3 steps: device busy {busy_full['busy_ms']:.4f} ms a "
        f"step in {busy_full['kernels']} device events; "
        f"{busy_full['wall_ms']:.4f} ms a step on the host clock under the "
        f"profiler (share {busy_full['share']})")
    for name, ms in busy_full["by_name"][:10]:
        say(f"  {ms:.5f} ms  {name[:100]}")
    say(f"profile of 3 frames: device busy {busy_frame['busy_ms']:.4f} ms a "
        f"frame in {busy_frame['kernels']} device events; "
        f"{busy_frame['wall_ms']:.4f} ms a frame on the host clock under the "
        f"profiler (share {busy_frame['share']})")
    record.update(aa_launches=aa_launches, cli_launches=cli_launches,
                  serve_launches=serve_launches, full_launches=full_launches,
                  full_ms=full_ms, full_profile=busy_full,
                  full_frame_profile=busy_frame,
                  step_peak_gb=step_peak_gb, k4_ms=k4_ms, k6_ms=k6_ms,
                  k4_bound=k4_bound, k4_bound_pre_cull=k4_bound_old,
                  k4_cull=k4_work["cull"], k4_probe=k4_probe,
                  k6_bound=k6_bound,
                  k6_bound_without_reject=k6_bound_old,
                  k6_staging=k6_staging)

    say("== phase 12: K8b and K8c against their plain versions on the card")
    from raytpu_torch.core.stl import procedural_stl_text
    from raytpu_torch.kernels import raster
    from raytpu_torch.oracle import rasterizer_oracle
    from raytpu_torch.render.rasterize import rasterize, rasterize_full
    # The 9,028-triangle stand-in for the reference's enemy1.stl.
    stl_path = OUT / "f1_torus.stl"
    stl_path.write_text(procedural_stl_text())
    s512, c512, _, cfg_r512 = raster_bench_frame(dev, 512)
    rcases = {
        # The bench's raster step: 512^2 clean, padded to 32 (K8b).
        "k8b_512_bench": raster_case(s512, c512, cfg_r512),
        # The rasterize CLI in clean mode: 500^2, 30 triangles (K8b).
        "k8b_500_clean": raster_case(
            cornell_box(device=dev),
            Camera.make((0.0, 0.0, -3.0), focal=500.0, dof_focus=1.9,
                        device=dev),
            RenderConfig(mode="clean")),
        # The rasterize CLI's --stl frame: 500^2 clean, 71 chunks (K8c).
        "k8c_500_stl": raster_case(*(stl_frame(dev, stl_path, 500)[i]
                                     for i in (0, 1, 3))),
    }
    winner_err = {"k8b": 0, "k8c": 0}
    for name, case in rcases.items():
        got, again, want = run_winner(case), run_winner(case), \
            plain_winner(case)
        line = ""
        if case["mask"] is not None:
            ones = torch.ones_like(case["mask"])
            got_ones = run_winner(case, mask=ones)
            want_ones = raster.resolve_winner_masked_reference(
                case["consts"], case["H"], case["W"], ones, case["chunk"])
            torch.cuda.synchronize()
            keep_rate = float(case["mask"].float().mean())
            same_ones = (torch.equal(got, got_ones)
                         and torch.equal(got_ones, want_ones))
            line = (f", mask keep rate {keep_rate:.4f} of "
                    f"{tuple(case['mask'].shape)} (tile, chunk) pairs, "
                    f"masked = all-ones {same_ones}")
            require(same_ones, f"{name}: the masked winners equal the "
                               f"all-ones mask's, kernel and plain")
            record[f"{name}_keep_rate"] = keep_rate
        torch.cuda.synchronize()
        mis = int((got != want).sum())
        same = torch.equal(got, again)
        hits = float((got >= 0).float().mean())
        say(f"{name} (T={case['consts'].shape[0]}, {case['H']}^2): winner "
            f"mismatches {mis}, two calls identical {same}, covered pixels "
            f"{hits:.4f}, distinct winners {int(torch.unique(got).numel())}"
            f"{line}")
        require(mis == 0, f"{name}: 0 winner mismatches")
        require(same, f"{name}: two kernel calls identical")
        require(0.1 < hits, f"{name}: pixels covered")
        key = "k8b" if case["mask"] is None else "k8c"
        winner_err[key] = max(winner_err[key],
                              int((got.long() - want.long()).abs().max()))
        record[f"winner_{name}"] = dict(mismatch=mis, repeat_equal=same,
                                        covered=hits)
    # K8c's per-tile row cull: its plain form's counts and the card's
    # probe (every rejected (tile, row) pair tested at every pixel).
    k8c_case = rcases["k8c_500_stl"]
    k8c_work = winner_work(k8c_case["consts"], 500, 500, k8c_case["chunk"],
                           k8c_case["mask"])
    probe = raster.raster_cull_probe(k8c_case["consts"], 500, 500)
    say(f"K8c's cull on k8c_500_stl: {winner_work_line(k8c_work)}; the "
        f"card's probe rejects {probe['rejected']} of {probe['pairs']} "
        f"(tile, row) pairs (plain form {k8c_work['all_rejected']}), "
        f"covered pixels among them {probe['covered']}")
    require(probe["covered"] == 0
            and probe["rejected"] == k8c_work["all_rejected"],
            "K8c's cull rejects no covering row, as its plain form")
    record["k8c_cull"] = dict(work=k8c_work, probe=probe)

    say("== phase 13: the rasterizer serving (the CLI defaults against the "
        "oracle, the rasterize CLI, animate, the view server)")
    zero_counts()
    before = kernel_counts()
    cfg_par = RenderConfig()  # 500x500 parity, the rasterize CLI's defaults
    out = rasterize_full(cornell_box(device=dev),
                         Camera.rasterizer_default(device=dev),
                         Lights.single(capacity=1, device=dev), cfg_par)
    img = out.image.cpu().numpy()
    fd = out.focal_distances.cpu().numpy()
    require(img.shape == (500, 500, 3) and np.isfinite(img).all()
            and img.max() > 0.3, "a finite, lit (500, 500, 3) parity frame")
    t0 = time.perf_counter()
    img_o, fd_o, _ = rasterizer_oracle.render(cornell_box_numpy(), width=500,
                                              height=500)
    diff = np.abs(quantize_u8(img).astype(int)
                  - quantize_u8(img_o).astype(int)).max(axis=-1)
    exact = float((diff == 0).mean())
    fd_err = float(np.abs(fd - fd_o).max())
    say(f"parity 500^2 vs the rasterizer oracle ({time.perf_counter() - t0:.1f}"
        f" s): u8 max step {int(diff.max())}, exact pixels {exact:.6f}, "
        f"max |d focal distance| {fd_err:.3g}")
    require(int(diff.max()) <= 1 and exact >= RASTER_EXACT_FRAC,
            "u8 within 1 everywhere and >= 99.99% exact")
    require(fd_err < RASTER_FD_ATOL, "focal distances within 1e-5")
    bmp = OUT / "raster_parity.bmp"
    cli_main(["rasterize", "-o", str(bmp)])
    require(np.array_equal(read_bmp(str(bmp)), quantize_u8(img)),
            "the rasterize CLI writes the same parity frame")
    par_launches = delta(before, kernel_counts())
    say(f"parity frame and CLI: launches {par_launches}")
    require(par_launches == {}, "parity mode launches no kernel")
    record["raster_oracle"] = dict(exact=exact, max_step=int(diff.max()),
                                   fd_err=fd_err)

    for flags, want, bmp_name in (
            (["--mode", "clean"], {"raster_winner": 1}, "raster_clean.bmp"),
            (["--mode", "clean", "--stl", str(stl_path)],
             {"raster_winner_masked": 1}, "raster_stl.bmp")):
        before = kernel_counts()
        cli_main(["rasterize", *flags, "-o", str(OUT / bmp_name)])
        got = delta(before, kernel_counts())
        frame_u8 = read_bmp(str(OUT / bmp_name))
        lit = float((frame_u8.max(axis=-1) > 0).mean())
        say(f"rasterize CLI {' '.join(flags[:2])}"
            f"{' --stl' if '--stl' in flags else ''}: {frame_u8.shape}, lit "
            f"{lit:.4f}, launches {got}")
        require(frame_u8.shape == (500, 500, 3) and 0.2 < lit
                and frame_u8.max() > 80, f"a lit {bmp_name}")
        require(got == want, f"{bmp_name}: launches {want}")
    before = kernel_counts()
    try:
        cli_main(["rasterize", "--stl", str(stl_path), "-o",
                  str(OUT / "raster_stl_parity.bmp")])
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    say(f"rasterize CLI --stl in parity mode: ValueError {refused!r} "
        f"(ROADMAP fault F8)")
    require("not a multiple of 64" in refused
            and delta(before, kernel_counts()) == {},
            "parity refuses the 9,028-triangle mesh before any launch")

    before = kernel_counts()
    keys = expand_script("left*2,up*2,w*2,a*2")
    with spy_frames(animate_mod, "rasterize") as rendered:
        res = animate(cornell_box(pad_to=32, device=dev),
                      Camera.rasterizer_default(device=dev),
                      Lights.single(capacity=1, device=dev),
                      RenderConfig(mode="clean"), keys, renderer="rasterize",
                      out_dir=str(OUT / "animate_raster"))
    got = delta(before, kernel_counts())
    say(f"animate, clean rasterizer: {res.n_frames} frames, "
        f"{res.ms_per_frame:.3f} ms/frame host clock, {len(res.paths)} "
        f"BMPs, launches {got}")
    require(got == {"raster_winner": 9},
            "one K8b a frame and one for the warm render")
    check_written_frames(res, rendered[1:], 0)
    require(not torch.equal(rendered[1], rendered[-1]),
            "the key script moves the view")

    app = ViewerApp(cornell_box(device=dev),
                    Camera.make((0.0, 0.0, -3.0), focal=500.0,
                                dof_focus=1.9, device=dev),
                    Lights.single(capacity=32, soft_samples=16, device=dev),
                    RenderConfig(mode="clean"), renderer="rasterize", seed=0)
    server = serve(app, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    k8b = "raster_winner"
    # (request, status, launches): every frame one K8b; keys 7, 8 and 9
    # change settings the clean rasterizer ignores; key 0 (soft) is
    # phase 17's.
    requests = [("/", 200, {}), ("/frame.bmp", 200, {k8b: 1}),
                ("/key?k=up", 200, {k8b: 1}), ("/key?k=left", 200, {k8b: 1}),
                ("/key?k=w", 200, {k8b: 1}), ("/key?k=7", 200, {k8b: 1}),
                ("/key?k=8", 200, {k8b: 1}), ("/key?k=9", 200, {k8b: 1}),
                ("/key?k=2", 200, {k8b: 1}), ("/key?k=3", 200, {k8b: 1}),
                ("/frame.bmp", 200, {}), ("/state", 200, {})]
    try:
        for path, want_status, want in requests:
            before = kernel_counts()
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(base + path, timeout=300) as r:
                    status, body = r.status, r.read()
            except urllib.error.HTTPError as exc:
                status, body = exc.code, exc.read()
            ms = (time.perf_counter() - t0) * 1e3
            got = delta(before, kernel_counts())
            say(f"GET {path}: {status}, {len(body)} bytes, {ms:.1f} ms, "
                f"launches {got}")
            require(status == want_status, f"{path} answered {want_status}")
            require(got == want, f"{path} launches {want}")
            require(app._frame is None or np.isfinite(app._frame).all(),
                    "finite frames")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    state = json.loads(body)
    require(state["renderer"] == "rasterize" and state["lights"] == 1
            and state["dof"] and state["aa"], "the viewer's state follows "
            "the keys")
    raster_serve = kernel_counts()  # zeroed where phase 13 began
    say(f"rasterizer serving path launches: {raster_serve}")
    require(raster_serve[k8b] > 0 and raster_serve["raster_winner_masked"] > 0
            and not any(v for k, v in raster_serve.items()
                        if not k.startswith("raster_")),
            "the rasterizer's serving path launched K8b and K8c and no "
            "raytracer kernel")

    say("== phase 14: the raster train step (the bench's step, 512^2 "
        "clean) and card numbers")
    scene_r, camera_r, lights_r, cfg_r = raster_bench_frame(dev, 512)
    step_r = train_step(scene_r, camera_r, lights_r, cfg_r, 1e-9,
                        target_scale=0.9, render=rasterize)
    zero_counts()
    losses = [step_r() for _ in range(3)]
    raster_train = kernel_counts()
    say(f"3 steps, loss {float(losses[0]):.6g} -> {float(losses[-1]):.6g}; "
        f"train path launches: {raster_train}")
    require(raster_train[k8b] == 3
            and not any(v for k, v in raster_train.items() if k != k8b),
            "each step launches K8b once and no other kernel")
    for value in (scene_r, lights_r):
        for name, leaf in vars(value).items():
            require(leaf.grad is None or bool(torch.isfinite(leaf.grad).all()),
                    f"finite gradient of {name}")
    require(all(float(leaf.grad.abs().max()) > 0.0 for leaf in (
        scene_r.v0, scene_r.color, lights_r.position, lights_r.color)),
        "vertices, albedo, light position and color take a gradient")
    require(scene_r.active.grad is None or not scene_r.active.grad.any(),
            "no gradient of Scene.active")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_r()
    torch.cuda.synchronize()
    raster_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    def clean_frame():
        with torch.no_grad():
            return rasterize(scene_r, camera_r, lights_r, cfg_r)

    scene_p = cornell_box(device=dev)
    camera_p = Camera.rasterizer_default(device=dev)
    lights_p = Lights.single(capacity=1, device=dev)
    scene_s, camera_s, lights_s, cfg_s = stl_frame(dev, stl_path, 500)

    def parity_frame():
        return rasterize(scene_p, camera_p, lights_p, cfg_par)

    def stl_clean_frame():
        return rasterize(scene_s, camera_s, lights_s, cfg_s)

    raster_ms = median_ms_in_turns({"frame": clean_frame, "step": step_r},
                                   n=1, reps=31)
    raster_ms.update(median_ms_in_turns({"stl_frame": stl_clean_frame},
                                        n=1, reps=11))
    raster_ms.update(median_ms_in_turns({"parity_frame": parity_frame},
                                        n=1, reps=5))
    busy_r = device_busy(step_r, steps=10)
    k8b_case, k8c_case = rcases["k8b_512_bench"], rcases["k8c_500_stl"]
    idx_b = torch.empty(512 * 512, dtype=torch.int32, device=dev)
    idx_c = torch.empty(500 * 500, dtype=torch.int32, device=dev)
    k8b_ms = median_ms_in_turns({
        "kernel": lambda: raster.launch_winner_kernel(
            k8b_case["consts"], 512, 512, idx_b),
        "plain": lambda: plain_winner(k8b_case),
    }, n=5, reps=9, timer=held_ms)
    k8c_ms = median_ms_in_turns({
        "kernel": lambda: raster.launch_winner_masked_kernel(
            k8c_case["consts"], 500, 500, k8c_case["mask"],
            k8c_case["chunk"], idx_c),
    }, n=5, reps=9, timer=held_ms)
    # The plain K8c makes ~20 launches a chunk, 71 chunks: more than the
    # stream holds while a sleep blocks it, so it is timed back to back.
    k8c_ms.update(median_ms_in_turns({"plain": lambda: plain_winner(
        k8c_case)}, n=1, reps=3))
    k8b_bound = winner_bound(k8b_case)
    k8c_bound = winner_bound(k8c_case, k8c_work)
    k8c_bound_before = winner_bound(k8c_case)
    card = card_line()
    def valid_rows(case):
        return int((case["consts"][:, 12] > 0.0).sum())

    say(f"K8b alone, 512^2 clean, T={k8b_case['consts'].shape[0]} "
        f"({valid_rows(k8b_case)} valid): {k8b_ms['kernel']:.4f} ms device "
        f"time (plain {k8b_ms['plain']:.4f} ms; bound {k8b_bound[0]:.4f} ms, "
        f"{k8b_bound[1]}) ({card})")
    say(f"K8c alone, 500^2 clean STL, T={k8c_case['consts'].shape[0]} "
        f"({valid_rows(k8c_case)} valid), keep "
        f"rate {record['k8c_500_stl_keep_rate']:.4f}: {k8c_ms['kernel']:.4f} "
        f"ms device time (plain {k8c_ms['plain']:.4f} ms back to back; bound "
        f"{k8c_bound[0]:.4f} ms, {k8c_bound[1]}; before the cull "
        f"{k8c_bound_before[0]:.4f} ms) ({card})")
    say(f"raster 512^2 clean (CUDA events, median of 31): frame "
        f"{raster_ms['frame']:.4f} ms, train step {raster_ms['step']:.4f} ms;"
        f" 500^2 clean STL frame {raster_ms['stl_frame']:.4f} ms (median of "
        f"11); 500^2 parity frame {raster_ms['parity_frame']:.4f} ms (median "
        f"of 5); peak memory of a step {raster_peak_gb:.3f} GB ({card})")
    say(f"profile of 10 raster steps: device busy {busy_r['busy_ms']:.4f} ms "
        f"a step in {busy_r['kernels']} device events; {busy_r['wall_ms']:.4f}"
        f" ms a step on the host clock under the profiler (share "
        f"{busy_r['share']})")
    for name, ms in busy_r["by_name"][:8]:
        say(f"  {ms:.5f} ms  {name[:100]}")
    record.update(raster_serve=raster_serve, raster_train=raster_train,
                  raster_ms=raster_ms, raster_profile=busy_r,
                  raster_peak_gb=raster_peak_gb, k8b_ms=k8b_ms,
                  k8c_ms=k8c_ms, k8b_bound=k8b_bound, k8c_bound=k8c_bound,
                  k8c_bound_before=k8c_bound_before,
                  winner_err=winner_err)

    say("== phase 15: K9a and K9b against their plain versions on the card")
    from raytpu_torch import load_stl
    from raytpu_torch.kernels import soft_raster as sr
    from raytpu_torch.opt.fit import FitConfig, fit
    from raytpu_torch.render.soft import rasterize_soft

    def soft_bench_frame(size: int):
        """bench.py's soft_rasterize frame (`bench.py:399-425`): size^2,
        the Cornell box padded to 32, the rasteriser camera, one light,
        sharpness 40 / 40."""
        return (cornell_box(pad_to=32, device=dev),
                Camera.rasterizer_default(device=dev),
                Lights.single(capacity=1, device=dev),
                RenderConfig(width=size, height=size, mode="soft",
                             soft_edge_sharpness=40.0,
                             soft_z_sharpness=40.0))

    def fit_frame():
        """The fit CLI's frame at its first stage: the 500^2 target's
        camera (0, 0, -3) at focal 500, y_scale 1.01, 30 triangles, one
        light of intensity 10, sharpness 10 / 20."""
        return (cornell_box(device=dev),
                Camera.make((0.0, 0.0, -3.0), focal=500.0, y_scale=1.01,
                            device=dev),
                Lights.single(capacity=1, intensity=10.0, device=dev),
                RenderConfig(mode="soft", soft_edge_sharpness=10.0,
                             soft_z_sharpness=20.0))

    def soft_stl_frame(size: int):
        """bench.py's soft_stl frame (`bench.py:610-641`): the mesh padded
        to 9,216 at size^2, the rasteriser camera, sharpness 40 / 40."""
        return (load_stl(str(stl_path), device=dev).pad_to(9216),
                Camera.rasterizer_default(device=dev),
                Lights.single(capacity=1, device=dev),
                RenderConfig(width=size, height=size, mode="soft",
                             soft_edge_sharpness=40.0,
                             soft_z_sharpness=40.0))

    def pick(frame):  # (scene, camera, cfg) of a frame
        return frame[0], frame[1], frame[3]

    scases = {
        "k9a_512_bench": soft_case(*pick(soft_bench_frame(512))),
        "k9a_500_fit": soft_case(*pick(fit_frame())),
        # 288 chunks at 512^2: the JAX rule culls (K9b).
        "k9b_512_stl": soft_case(*pick(soft_stl_frame(512))),
    }
    require(scases["k9b_512_stl"]["mask"] is not None
            and scases["k9a_512_bench"]["mask"] is None
            and scases["k9a_500_fit"]["mask"] is None,
            "the JAX rule culls the mesh at 512^2 and not the box")
    soft_err = {"k9a": 0.0, "k9b": 0.0, "k9c": 0.0, "k9d": 0.0}
    soft_m = {}
    soft_rows = {}  # the dead-row walks' counts (plain_soft_fwd's stats)

    def agg_close(got, want) -> tuple[bool, float]:
        errs = [(g - w).abs() for g, w in zip(got, want)]
        ok = all(bool((e <= 1e-6 + 1e-5 * w.abs()).all())
                 for e, w in zip(errs, want))
        return ok, max(float(e.max()) for e in errs)

    for name, case in scases.items():
        t0 = time.perf_counter()
        got, again = soft_fwd(case), soft_fwd(case)
        # The whole plain version holds the kernel; the plain version with
        # each block's dead rows left out, as the kernels leave them out,
        # counts the dead rows and must give the whole version's bits.
        soft_rows[name] = {}
        want = plain_soft_fwd(case)
        require(all(torch.equal(a, b) for a, b in zip(
            plain_soft_fwd(case, stats=soft_rows[name]), want)),
                f"{name}: the plain version without the dead rows gives its "
                f"bits")
        torch.cuda.synchronize()
        ok, err = agg_close(got, want)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        line = ""
        key = "k9a"
        if case["mask"] is not None:
            key = "k9b"
            ones = torch.ones_like(case["mask"])
            got_ones, got_none = soft_fwd(case, ones), soft_fwd(case, None)
            brute = plain_soft_fwd(case, None)
            soft_rows[name + "_brute"] = {}
            require(all(torch.equal(a, b) for a, b in zip(plain_soft_fwd(
                case, None, stats=soft_rows[name + "_brute"]), brute)),
                    f"{name}: the brute plain version without the dead rows "
                    f"gives its bits")
            ok_none, err_none = agg_close(got_none, brute)
            del brute
            torch.cuda.synchronize()
            same_ones = all(torch.equal(a, b)
                            for a, b in zip(got_ones, got_none))
            keep_rate = float(case["mask"].float().mean())
            cull_err = max(float((a - b).abs().max())
                           for a, b in zip(got, got_none))
            line = (f"; mask keep rate {keep_rate:.4f} of "
                    f"{tuple(case['mask'].shape)} (tile, chunk) pairs, "
                    f"all-ones = K9a bitwise {same_ones}, culled vs unculled "
                    f"max |d| {cull_err:.3g}; K9a on it vs plain max |d| "
                    f"{err_none:.3g}")
            require(same_ones, f"{name}: K9b with all ones is K9a")
            require(ok_none, f"{name}: K9a within rtol 1e-5 / atol 1e-6")
            require(cull_err < 1e-6, f"{name}: culled within 1e-6")
            soft_err["k9a"] = max(soft_err["k9a"], err_none)
            record[f"{name}_keep_rate"] = keep_rate
            soft_m[name + "_ones"] = got_none[1]
        say(f"{name} (Tp={case['consts'].shape[0]} in chunks of "
            f"{case['chunk']}, {case['H']}^2, es {case['es']:g} zs "
            f"{case['zs']:g}): agg/m/s vs plain max |d| {err:.3g}, within "
            f"rtol 1e-5 / atol 1e-6 {ok}, two calls identical {same}, "
            f"foreground {float((got[0][6] > 1e-3).float().mean()):.4f}"
            f"{line} ({time.perf_counter() - t0:.1f} s)")
        require(ok, f"{name}: agg, m, s within rtol 1e-5 / atol 1e-6")
        require(same, f"{name}: two kernel calls identical")
        require(all(bool(torch.isfinite(t).all()) for t in got), "finite")
        # The dead-row test: the plain walk's counts, the card's probe and
        # the work items.
        rows = soft_rows[name]
        probe = soft_dead_probe(case, got[1])
        n_tiles = -(-case["H"] // 16) * -(-case["W"] // 16)
        items = sr.soft_fwd_items(case["mask"], n_tiles,
                                  case["consts"].shape[0] // case["chunk"])
        say(f"  {name}: {rows['dead']} of {rows['rows']} (block, row) pairs "
            f"dead ({rows['dead'] / max(1, rows['rows']):.4%}), "
            f"{rows['live_pairs']} live (pixel, row) pairs; the card's probe "
            f"at the saved max's floors {probe['max']['dead']} dead (plain "
            f"{probe['max']['plain']}), weight not 0 among them "
            f"{probe['max']['bad']}; at 0 {probe['zero']['dead']} "
            f"({probe['zero']['plain']}), {probe['zero']['bad']}; items "
            f"{items}")
        require(all(p["bad"] == 0 and p["dead"] == p["plain"]
                    for p in probe.values()),
                f"{name}: the dead-row test calls no live row dead, as its "
                f"plain form")
        record[f"soft_rows_{name}"] = dict(rows=rows, probe=probe,
                                           items=items)
        soft_err[key] = max(soft_err[key], err)
        soft_m[name] = got[1]
        record[f"soft_fwd_{name}"] = dict(max_abs_err=err, repeat_equal=same)

    say("== phase 16: K9c and K9d against the plain backward in float64")

    def within(got, want) -> dict:
        """The JAX tests' rule, rtol 1e-4 / atol 1e-5 after scaling by
        want's largest entry, over the whole table and over each column
        group of SOFT_GROUPS scaled by its own: {group: (largest scaled
        |got - want|, every entry within the rule)}."""
        want = want.double()
        diff = (got.double() - want).abs()
        out = {}
        for group, lo, hi in (("table", 0, 32),) + SOFT_GROUPS:
            w, d = want[:, lo:hi], diff[:, lo:hi]
            scale = float(w.abs().max())
            ok = bool((d <= 1e-5 * scale + 1e-4 * w.abs()).all())
            out[group] = (float(d.max()) / scale if scale else float(d.max()),
                          ok)
        return out

    soft_checks = {}
    for name, case in scases.items():
        variants = [("own", soft_m[name])]
        if case["mask"] is not None:
            variants.append((torch.ones_like(case["mask"]),
                             soft_m[name + "_ones"]))
        for mask, m in variants:
            t0 = time.perf_counter()
            cot = soft_cot(case, seed=5)
            got, again = soft_bwd(case, m, cot, mask), \
                soft_bwd(case, m, cot, mask)
            want = plain_soft_bwd(case, m, cot, mask, torch.float64)
            plain32 = plain_soft_bwd(case, m, cot, mask)
            torch.cuda.synchronize()
            r64, r32, f64 = (within(got, want), within(got, plain32),
                             within(plain32, want))
            # A pixel within float32 rounding of an edge, outside it, loses
            # the direction of its segment distance in float32 (the
            # difference that gives it is 0): there the float32 function
            # itself, the plain version's as the kernel's (and JAX's), is
            # far from float64 (F11). In every group the kernel is held to
            # the plain float32 version by the rule, and to float64 by the
            # rule or, where the plain float32 version misses it too, by
            # being no farther from float64 than that version.
            check = {g: dict(err64=r64[g][0], ok64=r64[g][1],
                             err32=r32[g][0], ok32=r32[g][1],
                             floor64=f64[g][0],
                             ok=r32[g][1] and (r64[g][1] or r64[g][0]
                                               <= 1.01 * f64[g][0]))
                     for g in r64}
            same = torch.equal(got, again)
            label = name if isinstance(mask, str) else name + " all-ones"
            soft_checks[label] = check
            extra = ""
            if not isinstance(mask, str):
                plain_c = soft_bwd(case, m, cot, None)
                torch.cuda.synchronize()
                equal_c = torch.equal(plain_c, got)
                extra = f", = K9c bitwise {equal_c}"
                require(equal_c, f"{label}: K9d with all ones is K9c")
            say(f"{label}: d consts, two calls identical {same}{extra} "
                f"({time.perf_counter() - t0:.1f} s); by column group, the "
                f"largest |d| scaled by the group's largest float64 entry:")
            for g, lo, hi in (("table", 0, 32),) + SOFT_GROUPS:
                cg = check[g]
                say(f"  {g} (cols {lo}-{hi - 1}, scale "
                    f"{float(want[:, lo:hi].abs().max()):.4g}): vs float64 "
                    f"{cg['err64']:.3g} within {cg['ok64']}; the plain "
                    f"float32 version vs float64 {cg['floor64']:.3g}; vs the "
                    f"plain float32 version {cg['err32']:.3g} within "
                    f"{cg['ok32']}; passes {cg['ok']}")
            for g, cg in check.items():
                require(cg["ok"], f"{label}, {g}: K9c/K9d within rtol 1e-4 "
                                  f"/ atol 1e-5 of the plain float32 version "
                                  f"and of float64 (or no farther from "
                                  f"float64 than that version) after scaling")
            require(same, f"{label}: two backward calls identical")
            require(bool(torch.isfinite(got).all())
                    and not got[:, 29:].any(), f"{label}: finite gradient")
            # The pairs the kernel skips: its dead test's plain form on the
            # same inputs, against the plain float32 weight.
            work = soft_pair_work(case, m, cot, mask)
            say(f"  dead pairs: {work['dead']} of {work['pairs']} proved "
                f"dead ({work['dead'] / max(1, work['pairs']):.4f}), "
                f"{work['zero']} of weight 0, {work['wrong']} proved dead "
                f"with a weight not 0; (warp, row) units with a live lane "
                f"{work['live_units']} of {work['units']}")
            require(work["wrong"] == 0,
                    f"{label}: no pair of weight not 0 found dead")
            key = "k9c" if case["mask"] is None else "k9d"
            soft_err[key] = max([soft_err[key]] + [
                check[g]["err64"] for g, _, _ in SOFT_GROUPS])
            record[f"soft_bwd_{label}"] = dict(groups=check,
                                               repeat_equal=same, work=work)
            del want, plain32
    torch.cuda.empty_cache()

    say("== phase 17: soft serving (the rasterize CLI in soft mode, the "
        "view server's key 0)")
    zero_counts()
    stl500 = soft_case(*stl_frame(dev, stl_path, 500)[:2],
                       RenderConfig(mode="soft"))
    require(stl500["mask"] is None, "no cull at 500^2 (JAX's rule)")
    chunks_500 = stl500["consts"].shape[0] // stl500["chunk"]
    del stl500
    for flags, want, bmp_name in (
            ([], {"soft_raster_fwd": 1}, "raster_soft.bmp"),
            (["--stl", str(stl_path), "--width", "512", "--height", "512"],
             {"soft_raster_fwd_masked": 1}, "raster_soft_stl512.bmp"),
            (["--stl", str(stl_path)], {"soft_raster_fwd": 1},
             "raster_soft_stl500.bmp")):
        before = kernel_counts()
        t0 = time.perf_counter()
        cli_main(["rasterize", "--mode", "soft", *flags, "-o",
                  str(OUT / bmp_name)])
        ms = (time.perf_counter() - t0) * 1e3
        got = delta(before, kernel_counts())
        frame_u8 = read_bmp(str(OUT / bmp_name))
        lit = float((frame_u8.max(axis=-1) > 0).mean())
        size = 512 if "512" in flags else 500
        say(f"rasterize CLI --mode soft {' '.join(f for f in flags if not f.endswith('.stl'))}"
            f": {frame_u8.shape}, lit {lit:.4f}, {ms:.1f} ms host clock, "
            f"launches {got}"
            + (f" ({chunks_500} chunks, unculled)" if flags and size == 500
               else ""))
        require(frame_u8.shape == (size, size, 3) and 0.2 < lit
                and frame_u8.max() > 80, f"a lit {bmp_name}")
        require(got == want, f"{bmp_name}: launches {want}")
    require(chunks_500 == 283, "the mesh at 500^2 runs 283 chunks")

    def serve_and_check(app, requests):
        server = serve(app, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        body = b""
        try:
            for path, want_status, want in requests:
                before = kernel_counts()
                t0 = time.perf_counter()
                try:
                    with urllib.request.urlopen(base + path,
                                                timeout=300) as r:
                        status, body = r.status, r.read()
                except urllib.error.HTTPError as exc:
                    status, body = exc.code, exc.read()
                ms = (time.perf_counter() - t0) * 1e3
                got = delta(before, kernel_counts())
                say(f"GET {path} ({app.renderer}): {status}, {len(body)} "
                    f"bytes, {ms:.1f} ms, launches {got}, mode "
                    f"{app.cfg.mode}")
                require(status == want_status, f"{path} answered "
                                               f"{want_status}")
                require(got == want, f"{path} launches {want}")
                require(app._frame is None
                        or np.isfinite(app._frame).all(), "finite frames")
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        return body

    app = ViewerApp(cornell_box(device=dev),
                    Camera.make((0.0, 0.0, -3.0), focal=500.0,
                                dof_focus=1.9, device=dev),
                    Lights.single(capacity=32, soft_samples=16, device=dev),
                    RenderConfig(mode="clean"), renderer="rasterize", seed=0)
    k9a = "soft_raster_fwd"
    serve_and_check(app, [("/frame.bmp", 200, {k8b: 1})])
    clean_frame_np = app._frame.copy()
    serve_and_check(app, [("/key?k=0", 200, {k9a: 1})])
    soft_frame_np = app._frame.copy()
    serve_and_check(app, [("/key?k=up", 200, {k9a: 1}),
                          ("/frame.bmp", 200, {}),
                          ("/key?k=0", 200, {k8b: 1}), ("/state", 200, {})])
    require(app.cfg.mode == "clean" and float(np.abs(
        soft_frame_np - clean_frame_np).max()) > 1e-3,
        "key 0 toggles a soft frame and back")
    tracer = ViewerApp(cornell_box(pad_to=32, device=dev),
                       Camera.raytracer_default(device=dev),
                       Lights.single(capacity=1, device=dev),
                       RenderConfig(mode="clean"), renderer="raytrace")
    k10 = ("soft_rt_pri_fwd", "soft_rt_shw_fwd")
    serve_and_check(tracer, [("/key?k=0", 200, {k: 1 for k in k10})])
    require(tracer.cfg.mode == "soft", "the raytracer's key 0 gives soft")
    soft_serve = kernel_counts()  # zeroed where phase 17 began
    say(f"soft serving path launches: {soft_serve}")
    require(soft_serve[k9a] > 0 and soft_serve["soft_raster_fwd_masked"] > 0
            and soft_serve[k8b] > 0
            and not any(v for k, v in soft_serve.items()
                        if k not in (k9a, "soft_raster_fwd_masked", k8b)
                        + k10),
            "the soft serving path launched K9a, K9b, K8b and (the "
            "raytracer's key 0) K10a and K10g, nothing else")

    say("== phase 18: training (the fit CLI at its defaults, resume, the "
        "bench's soft steps) and card numbers")
    target_bmp = ROOT / "results" / "fit_reference" / "target.bmp"
    logs, printed = io.StringIO(), io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(logs), contextlib.redirect_stdout(printed):
        cli_main(["fit", str(target_bmp), "-o", str(OUT / "fit.bmp")])
    fit_s = time.perf_counter() - t0
    fit_launches = kernel_counts()
    records = [json.loads(line) for line in logs.getvalue().splitlines()
               if line.startswith("{")]
    for line in printed.getvalue().splitlines():
        say(f"  fit: {line}")
    fit_losses = [r["loss"] for r in records]
    say(f"fit CLI (500 steps, 2 stages, 500^2): {fit_s:.2f} s, logged "
        f"losses {[round(x, 6) for x in fit_losses]}, ms a step (last of "
        f"each 50) {[round(r['ms_per_step'], 3) for r in records]}; "
        f"launches {fit_launches}")
    require({k: v for k, v in fit_launches.items() if v}
            == {"soft_raster_fwd": 501, "soft_raster_bwd": 500},
            "each fit step launches K9a and K9c once (and the final frame one "
        "K9a), no other kernel")
    stage0, stage1 = fit_losses[:5], fit_losses[5:]
    require(len(records) == 10 and np.isfinite(fit_losses).all()
            and stage0[-1] < stage0[0] and stage1[-1] < stage1[0],
            "the fit's loss is finite and falls in each stage")
    fit_img = read_bmp(str(OUT / "fit.bmp"))
    require(fit_img.shape == (500, 500, 3) and fit_img.max() > 80,
            "fit.bmp written")
    fit_ms_step = statistics.median(r["ms_per_step"] for r in records)

    target_np = read_bmp(str(target_bmp)).astype(np.float32) / 255.0
    ckpt_dir = OUT / "ckpt"
    one_stage = ((10.0, 20.0, 1.0),)

    def fit_run(steps, resume_from=None, **kw):
        scene_f, camera_f, lights_f, _ = fit_frame()
        return fit(target_np, scene_f, camera_f, lights_f,
                   RenderConfig(mode="soft"),
                   FitConfig(steps=steps, stages=one_stage, log_every=0,
                             **kw), resume_from=resume_from)

    straight = fit_run(20, checkpoint_every=10, checkpoint_dir=str(ckpt_dir))
    resumed = fit_run(10, resume_from=str(ckpt_dir / "ckpt_10.npz"))
    same_resume = all(
        torch.equal(getattr(a, f), getattr(b, f))
        for a, b in ((resumed.scene, straight.scene),
                     (resumed.lights, straight.lights)) for f in vars(a))
    say(f"checkpoint at step 10 resumed for 10: parameters bit-identical to "
        f"the straight 20 steps {same_resume}; losses "
        f"{straight.losses[-1]:.6g} / {resumed.losses[-1]:.6g}")
    require(same_resume and np.array_equal(resumed.losses,
                                           straight.losses[10:]),
            "resume gives the straight run's parameters bit for bit")

    def cull_render(cull):
        def render(s, c, li, cfg):
            return rasterize_soft(s, c, li, cfg, cull=cull)
        return render

    step_soft = train_step(*soft_bench_frame(512), 1e-9, target_scale=0.9,
                           render=rasterize_soft)
    step_stl_c = train_step(*soft_stl_frame(512), 1e-9, target_scale=0.9,
                            render=cull_render(True))
    step_stl_b = train_step(*soft_stl_frame(512), 1e-9, target_scale=0.9,
                            render=cull_render(False))
    soft_train = {}
    for name, step, n, want in (
            ("soft_rasterize", step_soft, 3,
             {"soft_raster_fwd": 3, "soft_raster_bwd": 3}),
            ("soft_stl_culled", step_stl_c, 3,
             {"soft_raster_fwd_masked": 3, "soft_raster_bwd_masked": 3}),
            ("soft_stl_brute", step_stl_b, 2,
             {"soft_raster_fwd": 2, "soft_raster_bwd": 2})):
        zero_counts()
        losses = [float(step()) for _ in range(n)]
        got = {k: v for k, v in kernel_counts().items() if v}
        say(f"{name} step: {n} steps, loss {losses[0]:.6g} -> "
            f"{losses[-1]:.6g}; launches {got}")
        require(got == want, f"{name}: launches {want}")
        require(np.isfinite(losses).all(), f"{name}: finite loss")
        soft_train[name] = got

    def peak_gb(step):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() / 1e9

    soft_peak = {"soft_rasterize": peak_gb(step_soft),
                 "soft_stl_culled": peak_gb(step_stl_c),
                 "soft_stl_brute": peak_gb(step_stl_b)}
    busy_soft = {"soft_rasterize": device_busy(step_soft, steps=10),
                 "soft_stl_culled": device_busy(step_stl_c, steps=3),
                 "soft_stl_brute": device_busy(step_stl_b, steps=2)}

    s_b, c_b, l_b, cfg_b = soft_bench_frame(512)
    s_f, c_f, l_f, cfg_f = fit_frame()
    s_s, c_s, l_s, cfg_s = soft_stl_frame(512)
    s_5, c_5, l_5, _ = stl_frame(dev, stl_path, 500)
    cfg_5 = RenderConfig(mode="soft")

    def frame_fn(scene, camera, lights, cfg):
        def run():
            with torch.no_grad():
                return rasterize_soft(scene, camera, lights, cfg)
        return run

    soft_ms = median_ms_in_turns({
        "bench_frame": frame_fn(s_b, c_b, l_b, cfg_b),
        "fit_frame": frame_fn(s_f, c_f, l_f, cfg_f),
        "bench_step": step_soft}, n=1, reps=11)
    soft_ms.update(median_ms_in_turns({
        "stl512_culled_frame": frame_fn(s_s, c_s, l_s, cfg_s),
        "stl500_frame": frame_fn(s_5, c_5, l_5, cfg_5),
        "stl_culled_step": step_stl_c}, n=1, reps=5))
    soft_ms.update(median_ms_in_turns({"stl_brute_step": step_stl_b}, n=1,
                                      reps=3))

    def kernel_timers(case, mask="own"):
        c = case
        mk = own_mask(c, mask)
        R = c["H"] * c["W"]
        out = [torch.empty((sr.N_CH, R), device=dev),
               torch.empty(R, device=dev), torch.empty(R, device=dev)]
        cot = soft_cot(case, seed=5)
        m = soft_fwd(case, mk)[1]
        scratch = sr.bwd_scratch(c["consts"], c["H"], c["W"], c["chunk"])
        scratch_f = sr.fwd_scratch(c["consts"], c["H"], c["W"], c["chunk"],
                                   mk)
        dc = torch.empty_like(c["consts"])
        args = (c["consts"], c["H"], c["W"], c["chunk"], mk, c["es"],
                c["zs"])
        return (lambda: sr.launch_fwd_kernel(*args, *out, scratch=scratch_f),
                lambda: sr.launch_bwd_kernel(*args, m, cot, dc,
                                             scratch=scratch),
                lambda: plain_soft_fwd(case, mask),
                lambda: plain_soft_bwd(case, m, cot, mask), m, cot)

    kcases = {"bench": (scases["k9a_512_bench"], "own"),
              "fit": (scases["k9a_500_fit"], "own"),
              "stl_culled": (scases["k9b_512_stl"], "own"),
              "stl_brute": (scases["k9b_512_stl"], None)}
    krows = {"bench": "k9a_512_bench", "fit": "k9a_500_fit",
             "stl_culled": "k9b_512_stl", "stl_brute": "k9b_512_stl_brute"}
    soft_k = {}
    for name, (case, mask) in kcases.items():
        fwd_k, bwd_k, fwd_p, bwd_p, m_k, cot_k = kernel_timers(case, mask)
        big = name.startswith("stl")
        t = median_ms_in_turns({"fwd": fwd_k, "bwd": bwd_k},
                               n=2 if big else 5, reps=5, timer=held_ms)
        # The plain versions launch tens of kernels a chunk: timed back to
        # back, as they overflow the queue a held stream takes.
        t.update({f"{k}_plain": v for k, v in median_ms_in_turns(
            {"fwd": fwd_p, "bwd": bwd_p}, n=1, reps=3).items()})
        t["fwd_bound"] = soft_bound(case, False, mask,
                                    soft_rows[krows[name]])
        t["fwd_bound_old"] = soft_bound(case, False, mask)
        t["work"] = soft_pair_work(case, m_k, cot_k, mask)
        require(t["work"]["wrong"] == 0,
                f"{name}: no pair of weight not 0 found dead")
        t["bwd_bound"] = soft_bound(case, True, mask, t["work"])
        t["bwd_bound_old"] = soft_bound(case, True, mask)
        soft_k[name] = t
        torch.cuda.empty_cache()
    card = card_line()
    for name, t in soft_k.items():
        say(f"K9{'b' if name == 'stl_culled' else 'a'} / "
            f"K9{'d' if name == 'stl_culled' else 'c'} alone, {name}: "
            f"forward {t['fwd']:.4f} ms (plain {t['fwd_plain']:.4f}; bound "
            f"{t['fwd_bound'][0]:.4f} ms, {t['fwd_bound'][1]}; without the "
            f"dead rows {t['fwd_bound_old'][0]:.4f} ms), backward "
            f"{t['bwd']:.4f} ms (plain {t['bwd_plain']:.4f}; bound "
            f"{t['bwd_bound'][0]:.4f} ms, {t['bwd_bound'][1]}; without the "
            f"dead test {t['bwd_bound_old'][0]:.4f} ms) ({card})")
        wk = t["work"]
        say(f"  pairs {wk['pairs']}, proved dead {wk['dead']} "
            f"({wk['dead'] / max(1, wk['pairs']):.4f}), weight 0 "
            f"{wk['zero']}, live {wk['pairs'] - wk['dead']}; (warp, row) "
            f"units {wk['units']}, with a live lane {wk['live_units']}, "
            f"lanes live in those "
            f"{wk['live_lanes'] / max(1, 32 * wk['live_units']):.4f}")
    say(f"soft frames (CUDA events, median): 512^2 bench "
        f"{soft_ms['bench_frame']:.4f} ms, 500^2 fit frame "
        f"{soft_ms['fit_frame']:.4f} ms, STL 512^2 culled "
        f"{soft_ms['stl512_culled_frame']:.4f} ms, STL 500^2 unculled "
        f"{soft_ms['stl500_frame']:.4f} ms; steps: soft_rasterize "
        f"{soft_ms['bench_step']:.4f} ms, soft_stl culled "
        f"{soft_ms['stl_culled_step']:.4f} ms, brute "
        f"{soft_ms['stl_brute_step']:.4f} ms; the fit CLI "
        f"{fit_ms_step:.4f} ms a step (host clock, median of its logs) "
        f"({card})")
    for name, busy in busy_soft.items():
        say(f"profile of {name} steps: device busy {busy['busy_ms']:.4f} ms "
            f"a step in {busy['kernels']} device events; "
            f"{busy['wall_ms']:.4f} ms a step on the host clock under the "
            f"profiler (share {busy['share']}); peak memory "
            f"{soft_peak[name]:.3f} GB")
        for kname, ms in busy["by_name"][:5]:
            say(f"  {ms:.5f} ms  {kname[:100]}")
    record.update(soft_err=soft_err, soft_serve=soft_serve,
                  fit_launches=fit_launches, fit_losses=fit_losses,
                  fit_s=fit_s, fit_ms_step=fit_ms_step,
                  soft_train=soft_train, soft_ms=soft_ms, soft_k=soft_k,
                  soft_busy=busy_soft, soft_peak=soft_peak)
    (OUT / "result.json").write_text(json.dumps(record, indent=1))

    say("== phase 19: K10a and K10g against their plain versions on the "
        "card")
    from raytpu_torch.kernels import soft_raytrace as srt
    from raytpu_torch.render.soft import raytrace_soft

    def srt_bench_frame(size: int, lights=None, samples: int = 1):
        """bench.py's soft_raytrace frame (`bench.py:399-413`): size^2, the
        Cornell box padded to 32, the raytracer camera, sharpness 40 / 40,
        one light of capacity 1 (or ``lights`` with ``samples``
        soft-shadow samples)."""
        return (cornell_box(pad_to=32, device=dev),
                Camera.raytracer_default(device=dev),
                lights or Lights.single(capacity=1, device=dev),
                RenderConfig(width=size, height=size, mode="soft",
                             soft_shadow_samples=samples,
                             soft_edge_sharpness=40.0,
                             soft_z_sharpness=40.0))

    rcases = {
        "bench_512": srt_case(*srt_bench_frame(512)),
        # The fit CLI's first stage: 30 triangles, es 10 / zs 20.
        "fit_500": srt_case(*fit_frame()),
        # The bench's full-feature sources: 2 lights x 16 samples, S = 32.
        "full_512": srt_case(*srt_bench_frame(512, full_feature_lights(dev),
                                              16)),
        # bench.py's brute soft_raytrace_stl (`bench.py:644-676`): the mesh
        # padded to 9,216, the rasteriser camera, cull=False.
        "stl_512_brute": srt_case(*soft_stl_frame(512)),
    }
    require(rcases["stl_512_brute"]["pri"].shape[0] == 9216
            and rcases["stl_512_brute"]["chunk"] == 32
            and rcases["full_512"]["srcs"].shape[0] == 32,
            "the cases' shapes")
    srt_err = {"k10a": 0.0, "k10g": 0.0, "k10c": 0.0, "k10i": 0.0}
    srt_out = {}
    for name, c in rcases.items():
        t0 = time.perf_counter()
        got, again = srt_fwd(c), srt_fwd(c)
        want = srt_fwd(c, plain=True)
        world = got[0][3:6].contiguous()
        trans, trans2 = srt_shw(c, world), srt_shw(c, world)
        twant = srt_shw(c, world, plain=True)
        torch.cuda.synchronize()
        ok_a, err_a = agg_close(got, want)
        ok_g, err_g = agg_close((trans,), (twant,))
        same = all(torch.equal(a, b) for a, b in zip((*got, trans),
                                                     (*again, trans2)))
        Tp, S = c["pri"].shape[0], c["srcs"].shape[0]
        say(f"{name} (Tp={Tp} in {Tp // c['chunk']} chunks, "
            f"{c['dirs'].shape[1]} rays, S={S}, es {c['es']:g} zs "
            f"{c['zs']:g}): K10a out/m/s vs plain max |d| {err_a:.3g} "
            f"within rtol 1e-5 / atol 1e-6 {ok_a}; K10g trans vs plain max "
            f"|d| {err_g:.3g} within {ok_g}; two calls identical {same}; "
            f"surface share {float((got[1] > 1.0).float().mean()):.4f}, "
            f"trans mean {float(trans.mean()):.4f}, zero "
            f"{float((trans == 0).float().mean()):.4f} "
            f"({time.perf_counter() - t0:.1f} s)")
        require(ok_a and ok_g, f"{name}: K10a and K10g within rtol 1e-5 / "
                               f"atol 1e-6 of their plain versions")
        require(same, f"{name}: two kernel calls identical")
        require(all(bool(torch.isfinite(t).all()) for t in (*got, trans)),
                f"{name}: finite")
        say(f"  K10a on {name}: {pri_fwd_line(pri_fwd_work(c, got[1]))}")
        srt_err["k10a"] = max(srt_err["k10a"], err_a)
        srt_err["k10g"] = max(srt_err["k10g"], err_g)
        srt_out[name] = (got, world, trans)
        record[f"srt_fwd_{name}"] = dict(k10a=err_a, k10g=err_g,
                                         repeat_equal=same)
        del again, want, trans2, twant

    # The render CLI's --stl frame (500^2, 283 chunks, cull=False), where
    # the rule splits: 977 tiles of two work items each, folded by
    # pri_fwd_merge_kernel<false>. Against the plain version, two calls,
    # and one item a tile (the rule (1024, 1), no merge): m bit for bit.
    stl500_frame = (load_stl(str(stl_path), device=dev),
                    Camera.make((0.0, -0.5, -5.0), focal=250.0,
                                dof_focus=1.3, device=dev),
                    Lights.single(capacity=1, device=dev),
                    RenderConfig(mode="soft"))  # the render CLI's --stl
    stl500_case = c = srt_case(*stl500_frame)
    t0 = time.perf_counter()
    got, again = srt_fwd(c), srt_fwd(c)
    want = srt_fwd(c, plain=True)
    with pri_fwd_rule(1024, 1):
        whole = srt_fwd(c)
    torch.cuda.synchronize()
    ok_a, err_a = agg_close(got, want)
    ok_w, err_w = agg_close(got, whole)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    m_same = torch.equal(got[1], whole[1])
    w = pri_fwd_work(c, got[1])
    say(f"stl500_cli (Tp={c['pri'].shape[0]} in "
        f"{c['pri'].shape[0] // c['chunk']} chunks, {c['dirs'].shape[1]} "
        f"rays): K10a out/m/s vs plain max |d| {err_a:.3g} within rtol "
        f"1e-5 / atol 1e-6 {ok_a}; two calls identical {same}; vs one item "
        f"a tile: m bitwise {m_same}, out/s max |d| {err_w:.3g} within "
        f"{ok_w} ({time.perf_counter() - t0:.1f} s)")
    say(f"  K10a on stl500_cli: {pri_fwd_line(w)}")
    require(c["pri"].shape[0] == 283 * 32 and c["chunk"] == 32
            and w["fwd_merged"] > 0,
            "stl500_cli: 283 chunks, tiles of several items merged")
    require(ok_a, "stl500_cli: K10a within rtol 1e-5 / atol 1e-6 of its "
                  "plain version")
    require(same, "stl500_cli: two kernel calls identical")
    require(m_same and ok_w, "stl500_cli: the merged items keep m's bits "
                             "and out/s within the rule of one item a tile")
    require(all(bool(torch.isfinite(t).all()) for t in got),
            "stl500_cli: finite")
    srt_err["k10a"] = max(srt_err["k10a"], err_a)
    record["srt_fwd_stl500_cli"] = dict(k10a=err_a, repeat_equal=same,
                                        m_equal_one_item=m_same)
    del got, again, want, whole

    say("== phase 20: K10c and K10i against the plain backward in float64")
    srt_checks, srt_cots = {}, {}
    one = (("all", 0, 3),)
    for name, c in rcases.items():
        t0 = time.perf_counter()
        (_, m, _), world, trans = srt_out[name]
        cot = one_signed((10, m.shape[0]), dev, seed=7)
        gcot = one_signed(tuple(trans.shape), dev, seed=8)
        srt_cots[name] = (cot, gcot)
        got, again = srt_bwd(c, m, cot), srt_bwd(c, m, cot)
        sgot, sagain = (srt_shw_bwd(c, world, trans, gcot),
                        srt_shw_bwd(c, world, trans, gcot))
        same = all(torch.equal(a, b) for a, b in zip((*got, *sgot),
                                                     (*again, *sagain)))
        w64 = srt_bwd(c, m, cot, plain=True, dtype=torch.float64)
        p32 = srt_bwd(c, m, cot, plain=True)
        sw64 = srt_shw_bwd(c, world, trans, gcot, plain=True,
                           dtype=torch.float64)
        sp32 = srt_shw_bwd(c, world, trans, gcot, plain=True)
        torch.cuda.synchronize()
        # (kernel, part, got, float64, plain float32, column groups).
        pieces = [
            ("k10c", "table", got[0], w64[0], p32[0], srt.PRI_GROUPS),
            ("k10c", "camera", got[1][None], w64[1][None], p32[1][None], one),
            ("k10c", "dirs", got[2].T, w64[2].T, p32[2].T, one),
            ("k10i", "table", sgot[0], sw64[0], sp32[0], srt.SHW_GROUPS),
            ("k10i", "sources", sgot[1], sw64[1], sp32[1], one),
            ("k10i", "world", sgot[2].T, sw64[2].T, sp32[2].T, one)]
        say(f"{name}: two calls identical {same} "
            f"({time.perf_counter() - t0:.1f} s); by group, the largest "
            f"|d| scaled by the group's largest float64 entry:")
        for kernel, part, g, w, p, groups in pieces:
            r64, r32, f64 = (rule_by_group(g, w, groups),
                             rule_by_group(g, p, groups),
                             rule_by_group(p, w, groups))
            for grp in r64:
                # The kernel is held to the plain float32 version by the
                # rule, and to float64 by the rule or, where the plain
                # float32 version misses it too, by being no farther from
                # float64 than that version (ROADMAP fault F11).
                chk = dict(err64=r64[grp][0], ok64=r64[grp][1],
                           err32=r32[grp][0], ok32=r32[grp][1],
                           floor64=f64[grp][0],
                           ok=r32[grp][1] and (r64[grp][1] or r64[grp][0]
                                               <= 1.01 * f64[grp][0]))
                label = f"{kernel} {part}/{grp}"
                srt_checks.setdefault(kernel, {})[f"{name} {part}/{grp}"] = [
                    chk["err64"], chk["ok64"], chk["floor64"], chk["ok32"]]
                say(f"  {label}: vs float64 {chk['err64']:.3g} within "
                    f"{chk['ok64']}; plain float32 vs float64 "
                    f"{chk['floor64']:.3g}; vs plain float32 "
                    f"{chk['err32']:.3g} within {chk['ok32']}; passes on "
                    f"{'float64' if chk['ok64'] else 'the F11 rule'} "
                    f"{chk['ok']}")
                require(chk["ok"], f"{name} {label}: within rtol 1e-4 / "
                                   f"atol 1e-5 after scaling")
                srt_err[kernel] = max(srt_err[kernel], chk["err64"])
        require(same, f"{name}: two backward calls identical")
        require(all(bool(torch.isfinite(t).all()) for t in (*got, *sgot))
                and not got[0][:, srt.PRI_USED:].any()
                and not sgot[0][:, srt.SHW_USED:].any(),
                f"{name}: finite gradients, unused columns 0")
        del pieces, w64, p32, sw64, sp32, again, sagain
        torch.cuda.empty_cache()

    say("== phase 21: soft raytrace serving (the render CLI in soft mode, "
        "the view server's key 0)")
    zero_counts()
    k10a, k10g = "soft_rt_pri_fwd", "soft_rt_shw_fwd"
    one_frame = {k10a: 1, k10g: 1}
    seen = []
    real_pri, real_shw = srt.primary_agg_fwd, srt.shadow_trans_fwd

    def spy_pri(consts, cam, dirs, es, zs, chunk, *cull):
        seen.append(("chunks", consts.shape[0] // chunk))
        return real_pri(consts, cam, dirs, es, zs, chunk, *cull)

    def spy_shw(consts, srcs, *args):
        seen.append(("sources", srcs.shape[0]))
        return real_shw(consts, srcs, *args)

    srt.primary_agg_fwd, srt.shadow_trans_fwd = spy_pri, spy_shw
    try:
        for flags, shapes, bmp_name in (
                ([], [("chunks", 1), ("sources", 1)], "raytrace_soft.bmp"),
                (["--soft-shadows", "16", "--add-light", "0.4", "-0.5",
                  "-0.7", "1", "1", "1", "7"],
                 [("chunks", 1), ("sources", 32)], "raytrace_soft_full.bmp"),
                (["--stl", str(stl_path)], [("chunks", 283), ("sources", 1)],
                 "raytrace_soft_stl500.bmp")):
            before = kernel_counts()
            del seen[:]
            t0 = time.perf_counter()
            cli_main(["render", "--mode", "soft", *flags, "-o",
                      str(OUT / bmp_name)])
            ms = (time.perf_counter() - t0) * 1e3
            got = delta(before, kernel_counts())
            frame_u8 = read_bmp(str(OUT / bmp_name))
            lit = float((frame_u8.max(axis=-1) > 0).mean())
            say(f"render CLI --mode soft "
                f"{' '.join(f for f in flags if not f.endswith('.stl'))}: "
                f"{frame_u8.shape}, lit {lit:.4f}, max {frame_u8.max()}, "
                f"{ms:.1f} ms host clock, launches {got}, {seen}")
            # The mesh at 5 units from the light is dim: ambient 0.2 of its
            # albedo, ~40 of 255.
            require(frame_u8.shape == (500, 500, 3) and lit > 0.02
                    and frame_u8.max() > (20 if flags[:1] == ["--stl"]
                                          else 80), f"a lit {bmp_name}")
            require(got == one_frame and seen == shapes,
                    f"{bmp_name}: launches {one_frame} over {shapes}")
    finally:
        srt.primary_agg_fwd, srt.shadow_trans_fwd = real_pri, real_shw
    # At 512^2 the JAX package culls: one K10b and one K10h.
    k10b, k10h = "soft_rt_pri_fwd_masked", "soft_rt_shw_fwd_masked"
    before = kernel_counts()
    cli_main(["render", "--mode", "soft", "--stl", str(stl_path),
              "--width", "512", "--height", "512", "-o",
              str(OUT / "raytrace_soft_stl512.bmp")])
    got = delta(before, kernel_counts())
    frame_u8 = read_bmp(str(OUT / "raytrace_soft_stl512.bmp"))
    say(f"render CLI --mode soft --stl at 512^2 (culled): {frame_u8.shape}, "
        f"max {frame_u8.max()}, launches {got}")
    require(got == {k10b: 1, k10h: 1} and frame_u8.shape == (512, 512, 3)
            and frame_u8.max() > 20,
            "the culled soft raytracer renders 512^2: one K10b, one K10h")
    viewer = ViewerApp(cornell_box(device=dev),
                       Camera.raytracer_default(device=dev),
                       Lights.single(capacity=32, soft_samples=16,
                                     device=dev),
                       RenderConfig(), seed=0)  # the view CLI's defaults
    serve_and_check(viewer, [("/frame.bmp", 200, {k1: 1}),
                             ("/key?k=0", 200, one_frame),
                             ("/key?k=left", 200, one_frame),
                             ("/frame.bmp", 200, {}),
                             ("/key?k=0", 200, {k1: 1}),
                             ("/state", 200, {})])
    require(viewer.cfg.mode == "clean", "key 0 toggles soft and back")
    rt_serve = kernel_counts()  # zeroed where phase 21 began
    say(f"soft raytrace serving path launches: {rt_serve}")
    require(rt_serve[k10a] > 0 and rt_serve[k10g] > 0 and rt_serve[k1] > 0
            and rt_serve[k10b] > 0 and rt_serve[k10h] > 0
            and not any(v for k, v in rt_serve.items()
                        if k not in (k10a, k10g, k1, k10b, k10h)),
            "the soft raytrace serving path launched K10a, K10g, K10b, K10h "
            "and K1, nothing else")

    say("== phase 22: training through the soft raytracer (the fit CLI "
        "with --renderer raytrace, the bench's soft raytrace steps) and "
        "card numbers")
    logs, printed = io.StringIO(), io.StringIO()
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(logs), contextlib.redirect_stdout(printed):
        cli_main(["fit", str(target_bmp), "--renderer", "raytrace", "-o",
                  str(OUT / "fit_raytrace.bmp")])
    rfit_s = time.perf_counter() - t0
    rfit_launches = kernel_counts()
    rrecords = [json.loads(line) for line in logs.getvalue().splitlines()
                if line.startswith("{")]
    for line in printed.getvalue().splitlines():
        say(f"  fit: {line}")
    rfit_losses = [r["loss"] for r in rrecords]
    say(f"fit CLI --renderer raytrace (500 steps, 2 stages, 500^2): "
        f"{rfit_s:.2f} s, logged losses "
        f"{[round(x, 6) for x in rfit_losses]}, ms a step (last of each 50) "
        f"{[round(r['ms_per_step'], 3) for r in rrecords]}; launches "
        f"{ {k: v for k, v in rfit_launches.items() if v} }")
    four = ("soft_rt_pri_fwd", "soft_rt_pri_bwd", "soft_rt_shw_fwd",
            "soft_rt_shw_bwd")
    require({k: v for k, v in rfit_launches.items() if v}
            == {**{k: 500 for k in four}, "soft_raster_fwd": 1},
            "each raytrace fit step launches K10a, K10c, K10g and K10i once "
            "(the final frame one K9a), no other kernel")
    stage0, stage1 = rfit_losses[:5], rfit_losses[5:]
    require(len(rrecords) == 10 and np.isfinite(rfit_losses).all()
            and stage0[-1] < stage0[0] and stage1[-1] < stage1[0],
            "the raytrace fit's loss is finite and falls in each stage")
    require(read_bmp(str(OUT / "fit_raytrace.bmp")).shape == (500, 500, 3),
            "fit_raytrace.bmp written")
    rfit_ms_step = statistics.median(r["ms_per_step"] for r in rrecords)

    def brute(s_, c_, l_, cfg_):
        return raytrace_soft(s_, c_, l_, cfg_, cull=False)

    step_rt = train_step(*srt_bench_frame(512), 1e-9, target_scale=0.9,
                         render=raytrace_soft)
    step_rt_stl = train_step(*soft_stl_frame(512), 1e-9, target_scale=0.9,
                             render=brute)
    rt_train = {}
    for name, step, n in (("soft_raytrace", step_rt, 3),
                          ("soft_raytrace_stl_brute", step_rt_stl, 2)):
        zero_counts()
        losses = [float(step()) for _ in range(n)]
        got = {k: v for k, v in kernel_counts().items() if v}
        say(f"{name} step: {n} steps, loss {losses[0]:.6g} -> "
            f"{losses[-1]:.6g}; launches {got}")
        require(got == {k: n for k in four}, f"{name}: launches")
        require(np.isfinite(losses).all(), f"{name}: finite loss")
        rt_train[name] = got
    rt_peak = {"soft_raytrace": peak_gb(step_rt),
               "soft_raytrace_stl_brute": peak_gb(step_rt_stl)}
    rt_busy = {"soft_raytrace": device_busy(step_rt, steps=10),
               "soft_raytrace_stl_brute": device_busy(step_rt_stl, steps=2)}

    def rframe(frame, cull=None):
        s_, c_, l_, cfg_ = frame

        def run():
            with torch.no_grad():
                return raytrace_soft(s_, c_, l_, cfg_, cull=cull)
        return run

    rt_ms = median_ms_in_turns({
        "bench_frame": rframe(srt_bench_frame(512)),
        "fit_frame": rframe(fit_frame()),
        "full_frame": rframe(srt_bench_frame(512, full_feature_lights(dev),
                                             16)),
        "bench_step": step_rt}, n=1, reps=11)
    rt_ms.update(median_ms_in_turns({
        "stl500_frame": rframe(stl500_frame),
        "stl512_brute_frame": rframe(soft_stl_frame(512), cull=False)},
        n=1, reps=5))
    rt_ms.update(median_ms_in_turns({"stl_brute_step": step_rt_stl}, n=1,
                                    reps=3))

    def srt_timers(c, m, world, trans, cot, gcot, masked=False):
        """The four kernels (masked: K10b, K10d, K10h, K10j) launched into
        preallocated outputs, and their plain versions, on one case."""
        R, Tp, S = m.shape[0], c["pri"].shape[0], c["srcs"].shape[0]
        es, zs, chunk = c["es"], c["zs"], c["chunk"]
        pcull, scull = _cull(c, masked, "mask"), _cull(c, masked, "smask")
        out = (torch.empty((9, R), device=dev), torch.empty(R, device=dev),
               torch.empty(R, device=dev))
        tr = torch.empty((S, R), device=dev)
        pg = srt.pri_bwd_blocks(
            c["pri"], chunk,
            srt._tile_count(R, pcull.get("mask"), pcull.get("tiles")))
        sg = srt.shw_bwd_blocks(
            c["shw"], chunk,
            srt._tile_count(R, scull.get("mask"), scull.get("tiles")), S)
        pbuf = (torch.empty_like(c["pri"]), torch.empty(3, device=dev),
                torch.empty_like(c["dirs"]))
        pscratch = srt.pri_scratch(c["pri"], chunk, c["dirs"], **pcull,
                                   blocks=pg)
        fwd_scratch = srt.pri_fwd_scratch(c["pri"], chunk, c["dirs"], **pcull)
        sbuf = (torch.empty_like(c["shw"]), torch.empty_like(c["srcs"]),
                torch.empty_like(world))
        fscratch = srt.shw_scratch(c["shw"], chunk, c["srcs"], world,
                                   **scull, backward=False)
        bscratch = (srt.shw_scratch(c["shw"], chunk, c["srcs"], world,
                                    **scull, backward=True, blocks=sg)
                    if gcot is not None else None)
        kernels = {
            "pri_fwd": lambda: srt.launch_pri_fwd_kernel(
                c["pri"], chunk, c["cam"], c["dirs"], es, zs, *out, **pcull,
                scratch=fwd_scratch),
            "pri_bwd": lambda: srt.launch_pri_bwd_kernel(
                c["pri"], chunk, c["cam"], c["dirs"], es, zs, m, cot, *pbuf,
                **pcull, blocks=pg, scratch=pscratch),
            "shw_fwd": lambda: srt.launch_shw_fwd_kernel(
                c["shw"], chunk, c["srcs"], world, es, zs, tr, **scull,
                scratch=fscratch),
            "shw_bwd": lambda: srt.launch_shw_bwd_kernel(
                c["shw"], chunk, c["srcs"], world, trans, gcot, es, zs,
                *sbuf, **scull, blocks=sg, scratch=bscratch)}
        plain = {
            "pri_fwd": lambda: srt_fwd(c, plain=True, masked=masked),
            "pri_bwd": lambda: srt_bwd(c, m, cot, plain=True, masked=masked),
            "shw_fwd": lambda: srt_shw(c, world, plain=True, masked=masked),
            "shw_bwd": lambda: srt_shw_bwd(c, world, trans, gcot,
                                           plain=True, masked=masked)}
        return kernels, plain

    rt_k = {}
    for name, c in rcases.items():
        (_, m, _), world, trans = srt_out[name]
        cot, gcot = srt_cots[name]
        kernels, plain = srt_timers(c, m, world, trans, cot, gcot)
        big = name.startswith("stl")
        t = median_ms_in_turns(kernels, n=2 if big else 5, reps=5,
                               timer=held_ms)
        # The plain versions launch tens of kernels a chunk: timed back to
        # back, as they overflow the queue a held stream takes.
        t.update({f"{k}_plain": v for k, v in median_ms_in_turns(
            plain, n=1, reps=3).items()})
        dl = gcot * trans * (-srt.OD_SCALE)
        work = srt_work(c, m, world, dl)
        t["work"] = work
        t["items"] = pri_item_work(c, m)
        t["bounds"] = srt_bounds(c, work)
        rt_k[name] = t
        del kernels, plain
        torch.cuda.empty_cache()
    card = card_line()
    for name, t in rt_k.items():
        w = t["work"]
        say(f"K10 alone, {name} ({w['pairs']} pairs, {w['gated_p']} gated, "
            f"{w['live_p']} of weight not 0; {w['triples']} shadow triples, "
            f"{w['gated_s']} gated; backward {w['act_s']} of d od not 0, "
            f"{w['act_gated_s']} of them gated, {w['live_s']} live): "
            + ", ".join(
                f"{k} {t[k]:.4f} ms (plain {t[k + '_plain']:.4f}; bound "
                f"{t['bounds'][k][0]:.4f} ms, {t['bounds'][k][1]})"
                for k in ("pri_fwd", "pri_bwd", "shw_fwd", "shw_bwd"))
            + f" ({card})")
        say(f"  K10a on {name}: {pri_fwd_line(w)}")
        say(f"  K10c on {name}: {pri_work_line(w, t['items'])}")
    say(f"soft raytrace (CUDA events, median): frames 512^2 bench "
        f"{rt_ms['bench_frame']:.4f} ms, 500^2 fit {rt_ms['fit_frame']:.4f} "
        f"ms, 512^2 full-feature sources {rt_ms['full_frame']:.4f} ms, STL "
        f"500^2 (CLI) {rt_ms['stl500_frame']:.4f} ms, STL 512^2 brute "
        f"{rt_ms['stl512_brute_frame']:.4f} ms; steps: soft_raytrace "
        f"{rt_ms['bench_step']:.4f} ms, soft_raytrace_stl brute "
        f"{rt_ms['stl_brute_step']:.4f} ms; the raytrace fit CLI "
        f"{rfit_ms_step:.4f} ms a step (host clock, median of its logs) "
        f"({card})")
    for name, busy in rt_busy.items():
        say(f"profile of {name} steps: device busy {busy['busy_ms']:.4f} ms "
            f"a step in {busy['kernels']} device events; "
            f"{busy['wall_ms']:.4f} ms a step on the host clock under the "
            f"profiler (share {busy['share']}); peak memory "
            f"{rt_peak[name]:.3f} GB")
        for kname, ms in busy["by_name"][:5]:
            say(f"  {ms:.5f} ms  {kname[:100]}")
    record.update(srt_err=srt_err, srt_checks=srt_checks,
                  rt_serve=rt_serve, rfit_launches=rfit_launches,
                  rfit_losses=rfit_losses, rfit_s=rfit_s,
                  rfit_ms_step=rfit_ms_step, rt_train=rt_train, rt_ms=rt_ms,
                  rt_k=rt_k, rt_busy=rt_busy, rt_peak=rt_peak)
    say("== phase 23: K5, K7d and K7a against their plain versions on the "
        "card")
    from raytpu_torch import load_stl
    mesh = load_stl(str(stl_path), device=dev)  # 9,028 triangles
    stl_cases = hit_cases(dev, mesh)
    stl_err = {"k5": 0.0, "k7d": 0.0, "k7a": 0.0}
    stl_keep = {}

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b))

    c = stl_cases["stl_intersect_512"]
    k5, k5_again = run_stl(c, "k5"), run_stl(c, "k5")
    k7d, k7d_again = run_stl(c, "k7d"), run_stl(c, "k7d")
    k7d_ones = run_stl(c, "k7d", mask=torch.ones_like(c["mask"]))
    p5, p7d = run_stl(c, "k5", plain=True), run_stl(c, "k7d", plain=True)
    torch.cuda.synchronize()
    stl_keep["stl_intersect_512"] = float(c["mask"].float().mean())
    say(f"stl_intersect 512^2 (T = 9,216, {c['n_chunks']} chunks, "
        f"{c['tiles'].count} tiles): K5 = plain {same(k5, p5)}, K7d = plain "
        f"{same(k7d, p7d)}, K7d = K5 {same(k7d, k5)}, all-ones K7d = K5 "
        f"{same(k7d_ones, k5)}, two calls identical "
        f"{same(k5, k5_again) and same(k7d, k7d_again)}; keep rate "
        f"{stl_keep['stl_intersect_512']:.4f}, hit rays "
        f"{float((k5[1] >= 0).float().mean()):.4f}")
    require(same(k5, p5) and same(k7d, p7d),
            "K5 and K7d bit-identical to their plain versions")
    require(same(k7d, k5) and same(k7d_ones, k5), "culled K7d = brute K5")
    require(same(k5, k5_again) and same(k7d, k7d_again),
            "two kernel calls identical")
    require(bool((k5[1] >= 0).any()), "the mesh is in view")
    for key, got, want in (("k5", k5, p5), ("k7d", k7d, p7d)):
        hit = want[1] >= 0
        stl_err[key] = float((got[0][hit] - want[0][hit]).abs().max())
    del k5_again, k7d_again, k7d_ones, p5, p7d

    # The cull: the card's decisions on every (tile,
    # triangle) and (warp, triangle) pair against their plain form on the
    # same tensors, and plane_test on every ray of every culled pair (the
    # probe kernel): K5's tiles and K7d's on the row, K7a's at 500^2.
    cull_probe = {}
    for name, tiled in (("stl_intersect_512", False),
                        ("stl_intersect_512", True),
                        ("render_stl_500_s1", True)):
        c = stl_cases[name]
        tiles = c["tiles"] if tiled else None
        dec, counts = isect.primary_cull_probe(c["dirs"], c["table"][:10],
                                               tiles)
        want = isect.primary_cull_decisions(
            c["dirs"], c["table"][:10], tiles if tiled else isect.ray_tiles(
                c["dirs"].shape[0], None, dev))
        torch.cuda.synchronize()
        key = f"{name}_{'16x16' if tiled else 'runs'}"
        cull_probe[key] = dict(
            tile_culled=int(counts[0]), warp_culled=int(counts[1]),
            tile_pairs=int(dec[:, 0].numel()),
            warp_pairs=int(dec[:, 1:].numel()),
            ok_culled=int(counts[2]) + int(counts[3]),
            plain_equal=bool(torch.equal(dec, want)))
        say(f"cull probe on the card, {key}: {cull_probe[key]}")
        require(cull_probe[key]["ok_culled"] == 0,
                f"{key}: the cull culls no pair plane_test calls ok")
        require(cull_probe[key]["plain_equal"],
                f"{key}: the card's cull decisions = their plain form")
        del dec, want

    for name in ("render_stl_500_s1", "render_stl_500_s32"):
        c = stl_cases[name]
        got, again = run_stl(c, "k7a"), run_stl(c, "k7a")
        ones = run_stl(c, "k7a", mask=torch.ones_like(c["mask"]))
        want = run_stl(c, "k7a", plain=True)
        brute = run_stl(c, "k5")
        torch.cuda.synchronize()
        n = c["n_chunks"]
        stl_keep[name] = (float(c["mask"][:, :n].float().mean()),
                          float(c["mask"][:, n:].float().mean()))
        say(f"K7a {name} (S = {c['src'].shape[0]}, {n} chunks): = plain "
            f"{same(got, want)}, = all-ones mask {same(got, ones)}, t and "
            f"idx = K5 {same(got[:2], brute)}, two calls identical "
            f"{same(got, again)}; keep rate primary {stl_keep[name][0]:.4f},"
            f" shadow {stl_keep[name][1]:.4f}; hit rays "
            f"{float((got[1] >= 0).float().mean()):.4f}, occluded "
            f"{int(got[2].sum())}")
        require(same(got, want), f"{name}: K7a bit-identical to plain")
        require(same(got, ones) and same(got[:2], brute),
                f"{name}: culled K7a = brute")
        require(same(got, again), f"{name}: two K7a calls identical")
        require(bool(got[2].any()) and not bool(got[2][:, got[1] < 0].any()),
                f"{name}: some hit ray occluded, no miss ray")
        hit = want[1] >= 0
        stl_err["k7a"] = max(stl_err["k7a"], float(
            (got[0][hit] - want[0][hit]).abs().max()))
        stl_cases[name]["out"] = got
        del again, ones, want, brute

    # K7a's reject: its plain form over every shadow test of both frames'
    # sweeps (stl_work, to the end of each kept chunk), and the device
    # reject (the probe kernel) against plane_test on the card on the
    # hand-built edge pairs (= the plain form bit for bit there), 2^20
    # random pairs and 2^20 real (hit ray, source, triangle) tests of the
    # S = 32 frame.
    reject_share = {}
    for name in ("render_stl_500_s1", "render_stl_500_s32"):
        c = stl_cases[name]
        c["work"] = w = stl_work(c, "k7a")
        reject_share[name] = w["rejected"] / w["shadow"]
        say(f"K7a reject, {name}: decides {w['rejected']} of {w['shadow']} "
            f"shadow tests ({reject_share[name]:.6f}); rejects "
            f"{w['reject_wrong']} blocking tests of the sweeps; "
            f"{w['hit_tiles']} of {c['tiles'].count} tiles hold a hit ray, "
            f"{w['hit_warps']} warps of hit rays, lane use of one run "
            f"{w['lane_use']:.4f}")
        require(w["reject_wrong"] == 0,
                f"{name}: the reject rejects no blocking test")
        require(reject_share[name] > 0.99, f"{name}: the reject decides "
                                           f"nearly every shadow test")
        say(f"K7a primary cull, {name}: {primary_work_line(w['cull'])}")
    c = stl_cases["render_stl_500_s32"]
    rng = np.random.default_rng(25)
    hit_rays = torch.nonzero(c["out"][1] >= 0).squeeze(1)
    n_real = 1 << 20
    pick = torch.tensor(rng.integers(0, hit_rays.numel(), n_real), device=dev)
    s_of = torch.tensor(rng.integers(0, c["src"].shape[0], n_real),
                        device=dev)
    col = torch.tensor(rng.integers(0, c["table"].shape[1], n_real),
                       device=dev)
    r_of = hit_rays[pick]
    pos = c["cam"][None, :] + c["out"][0][r_of][:, None] * c["dirs"][r_of]
    blocks = c["table"].reshape(-1, 10, c["table"].shape[1])
    probe_pairs = {
        "edge": isect.reject_edge_pairs(dev),
        "random": isect.reject_random_pairs(n_real, 25, dev),
        "real S = 32": ((pos - c["src"][s_of]).contiguous(),
                        blocks[1 + s_of, :, col].contiguous())}
    probe = {}
    for pname, (rays_e, tri) in probe_pairs.items():
        rej, blk = isect.shadow_reject_probe(rays_e, tri)
        torch.cuda.synchronize()
        probe[pname] = dict(pairs=rays_e.shape[0], rejected=int(rej.sum()),
                            blocked=int(blk.sum()),
                            wrong=int((rej & blk).sum()))
        say(f"reject probe on the card, {pname}: {probe[pname]}")
        require(probe[pname]["wrong"] == 0,
                f"the device reject rejects no blocking {pname} pair")
        if pname == "edge":
            m, k0 = tri[:, :9].reshape(-1, 3, 3), tri[:, 9]
            require(torch.equal(rej, isect.shadow_reject(rays_e[:1], m,
                                                         k0)[0]),
                    "the device reject = its plain form on the edge pairs")
    del probe_pairs, pick, s_of, col, r_of, pos

    # The VJP of t at T = 9,028 (gather and fixed-order sums) against its
    # float64 evaluation; two backward calls bit-identical.
    c = stl_cases["render_stl_500_s1"]
    t7, idx7 = c["out"][:2]
    rng = np.random.default_rng(23)
    t_bar = torch.tensor(rng.uniform(0.5, 1.5, t7.shape[0]).astype(
        np.float32), device=dev)
    vjp_args = (c["dirs"], c["m"], c["k0"], t7, idx7, t_bar)
    g32 = isect.closest_hit_vjp(*vjp_args)
    g32_again = isect.closest_hit_vjp(*vjp_args)
    g64 = isect.closest_hit_vjp(*(
        a.double() if a.is_floating_point() else a for a in vjp_args))
    torch.cuda.synchronize()
    stl_vjp = []
    for gname, g, w in zip(("g_dirs", "g_m", "g_k0"), g32, g64):
        require(bool(torch.isfinite(g).all()), f"finite {gname}")
        tol = GRAD_ATOL + GRAD_RTOL * w.abs()
        err = (g.double() - w).abs()
        stl_vjp.append(f"{gname} {float((err / tol).max()):.3f} of tol")
        require(bool((err <= tol).all()),
                f"STL VJP {gname} within rtol {GRAD_RTOL} / atol {GRAD_ATOL}")
    require(same(g32, g32_again), "two backward calls bit-identical")
    require(float(g32[2].abs().max()) > 0.0, "the VJP reaches k0")
    say(f"VJP of t at T = 9,028 vs float64: {', '.join(stl_vjp)}; two "
        f"backward calls bit-identical True")
    record.update(stl_err=stl_err, stl_keep=stl_keep, stl_vjp=stl_vjp,
                  cull_probe=cull_probe,
                  reject_share=reject_share, reject_probe=probe)

    say("== phase 24: the hard raytracer at STL scale serving (the render "
        "CLI's --stl frames, the oracle)")
    k5n, k7dn, k7an = ("closest_hit", "closest_hit_masked",
                       "closest_hit_occluded_masked")
    sources_seen = []
    launch_k7a = isect.launch_occluded_masked_kernel

    def spy_k7a(dirs, table, C, cam, src, *args, **kwargs):
        sources_seen.append(src.shape[0])
        return launch_k7a(dirs, table, C, cam, src, *args, **kwargs)

    ff_flags = ["--aa", "3", "--soft-shadows", "16", "--add-light", "0.4",
                "-0.5", "-0.7", "1", "1", "1", "7", "--dof"]
    stl_runs = [("render --stl", [], 1, 1), ("--mode clean",
                                              ["--mode", "clean"], 1, 1),
                ("--aa 3", ["--aa", "3"], 9, 1),
                ("--aa 3 --soft-shadows 16 --add-light --dof", ff_flags, 9,
                 32)]
    isect.launch_occluded_masked_kernel = spy_k7a
    zero_counts()
    stl_serve_ms = {}
    try:
        for name, flags, n_launch, n_src in stl_runs:
            before = kernel_counts()
            sources_seen.clear()
            bmp = OUT / "render_stl.bmp"
            t0 = time.perf_counter()
            cli_main(["render", "--stl", str(stl_path), *flags, "-o",
                      str(bmp)])
            torch.cuda.synchronize()
            stl_serve_ms[name] = (time.perf_counter() - t0) * 1e3
            got = delta(before, kernel_counts())
            frame_u8 = read_bmp(str(bmp))
            say(f"render CLI {name}: {frame_u8.shape}, "
                f"{stl_serve_ms[name]:.1f} ms (host clock, build of the "
                f"scene included), launches {got}, sources {sources_seen}")
            require(got == {k7an: n_launch},
                    f"{name}: exactly {n_launch} K7a and no other kernel")
            require(sources_seen == [n_src] * n_launch, f"{name}: S = {n_src}")
            require(frame_u8.shape == (500, 500, 3) and frame_u8.max() >= 20
                    and (frame_u8.max(axis=-1) == 0).any(),
                    f"{name}: the mesh on a black background")
    finally:
        isect.launch_occluded_masked_kernel = launch_k7a

    # The 800-triangle mesh against the numpy oracle: parity, two lights
    # with 4 soft-shadow samples each (S = 8), no AA (the reference steps
    # its AA offsets only on hits, which the mesh's misses break) and no
    # DoF (the oracle has none), the camera nudged off the plane x = 0
    # where the torus's edges and the light line up, the light in front.
    import argparse
    from raytpu_torch.cli import main as cli_module
    from raytpu_torch.core.stl import procedural_stl_text
    small_path = OUT / "torus800.stl"
    small_path.write_text(procedural_stl_text(20, 20))
    parser = argparse.ArgumentParser()
    cli_module._render_flags(parser)
    args = parser.parse_args([
        "--stl", str(small_path), "--width", "96", "--height", "96",
        "--focal", "96", "--camera-pos", "0.0123", "-0.5", "-5",
        "--light-pos", "0.3", "-1.5", "-3", "--soft-shadows", "4",
        "--add-light", "0.4", "-0.5", "-0.7", "1", "1", "1", "7"])
    s8, cam8, l8, cfg8 = cli_module._build_inputs(args)
    before = kernel_counts()
    with torch.no_grad():
        img8 = raytrace_full(s8, cam8, l8, cfg8).image.cpu().numpy()
    got = delta(before, kernel_counts())
    t0 = time.perf_counter()
    img_o, _ = raytracer_oracle.render(
        tuple(x.cpu().numpy() for x in (s8.v0, s8.v1, s8.v2, s8.color)),
        width=96, height=96, focal=96.0, camera_pos=(0.0123, -0.5, -5.0),
        light_positions=l8.position.cpu().numpy(),
        light_colors=l8.color.cpu().numpy(),
        light_intensities=l8.intensity.cpu().numpy(),
        soft_positions=l8.jitter[:, :4].cpu().numpy())
    err = np.abs(img8 - img_o) - (F32_ATOL + F32_RTOL * np.abs(img_o))
    f32_ok = float((err.max(axis=-1) <= 0).mean())
    u8_ok = float((np.abs(quantize_u8(img8).astype(int)
                          - quantize_u8(img_o).astype(int)).max(axis=-1)
                   <= 1).mean())
    say(f"800-triangle mesh, 96^2 parity, S = 8, vs numpy oracle "
        f"({time.perf_counter() - t0:.1f} s): launches {got}, f32-close "
        f"pixels {f32_ok:.6f}, u8 within 1 {u8_ok:.6f}, lit "
        f"{float(img8.max()):.3f}")
    require(got == {k7an: 1}, "the oracle frame launches one K7a")
    require(img8.max() > 0.15, "the oracle frame is lit")
    require(u8_ok >= U8_FRAC, "u8 within 1 step on >= 99.9% of pixels")
    require(f32_ok >= FLIP_FRAC, "f32 atol 2e-4 on all but <= 0.1% pixels")
    stl_serve = kernel_counts()  # zeroed where phase 24 began
    say(f"STL serving path launches: {stl_serve}")
    record.update(stl_serve=stl_serve, stl_serve_ms=stl_serve_ms,
                  oracle_stl=dict(f32_ok=f32_ok, u8_ok=u8_ok))

    say("== phase 25: the stl_intersect row, the STL train step and card "
        "numbers")
    c = stl_cases["stl_intersect_512"]
    consts_b = isect.TriConstants(c["m"], c["k0"], c["valid"])

    def row_brute():
        return isect.intersect_closest(c["dirs"], consts_b).t

    def row_culled():
        return isect.intersect_closest_culled(
            c["dirs"], consts_b, c["cam"], *c["geom"],
            image_hw=(512, 512)).t

    row_launches, row_t = {}, {}
    for name, fn in (("brute", row_brute), ("culled", row_culled)):
        zero_counts()
        row_t[name] = fn()
        row_launches[name] = {k: v for k, v in kernel_counts().items() if v}
        say(f"stl_intersect row, {name}: launches {row_launches[name]}")
        require(row_launches[name]
                == {"brute": {k5n: 1}, "culled": {k7dn: 1}}[name],
                f"the stl_intersect row's {name} call launches one "
                f"{'K5' if name == 'brute' else 'K7d'} and nothing else")
    require(torch.equal(row_t["brute"], row_t["culled"]),
            "the row's culled t = its brute t")
    row_ms = median_ms_in_turns({"brute": row_brute, "culled": row_culled},
                                n=3, reps=7)

    # Three SGD steps of the MSE of the 512^2 clean STL frame (the render
    # --stl camera, 9,028 triangles, one light) to a target 10% darker.
    scene_t = load_stl(str(stl_path), device=dev)
    lights_t = Lights.single(capacity=1, position=(0.3, -1.5, -3.0),
                             device=dev)
    cfg_t = RenderConfig(width=512, height=512, mode="clean")
    step_stl = train_step(scene_t, stl_camera(dev), lights_t, cfg_t, 1e-9,
                          target_scale=0.9)
    zero_counts()
    losses = [float(step_stl()) for _ in range(3)]
    stl_train = {k: v for k, v in kernel_counts().items() if v}
    say(f"STL train step, 3 steps, loss {losses[0]:.6g} -> {losses[-1]:.6g};"
        f" launches {stl_train}")
    require(stl_train == {k7an: 3}, "each STL step launches one K7a and "
                                    "no other kernel")
    require(np.isfinite(losses).all(), "finite STL loss")
    for value in (scene_t, lights_t):
        for name, leaf in vars(value).items():
            require(leaf.grad is None
                    or bool(torch.isfinite(leaf.grad).all()),
                    f"finite gradient of {name}")
    require(all(float(leaf.grad.abs().max()) > 0.0 for leaf in (
        scene_t.v0, scene_t.color, lights_t.color)),
        "vertices, albedo and the light's color take a gradient")
    stl_peak = peak_gb(step_stl)

    def stl_frame_fn(flags):
        parser_f = argparse.ArgumentParser()
        cli_module._render_flags(parser_f)
        inputs = cli_module._build_inputs(parser_f.parse_args(
            ["--stl", str(stl_path), *flags]))

        def run():
            with torch.no_grad():
                return raytrace(*inputs)
        return run

    stl_ms = median_ms_in_turns({
        "render_stl_500": stl_frame_fn([]),
        "clean_500": stl_frame_fn(["--mode", "clean"]),
        "clean_512": stl_frame_fn(["--mode", "clean", "--width", "512",
                                   "--height", "512"]),
        "step_512": step_stl}, n=1, reps=5)
    stl_ms.update(median_ms_in_turns({
        "aa3_500": stl_frame_fn(["--aa", "3"]),
        "full_500": stl_frame_fn(ff_flags)}, n=1, reps=3))
    stl_busy = device_busy(step_stl, steps=3)

    # The kernels alone: K5 and K7d on the row's rays, K7a on the render
    # --stl sub-ray (S = 1) and the full-feature sources (S = 32): K7a whole
    # and its halves, the primary (phases 1: sweep, merge, packing) and the
    # shadow (phases 2, on the hits a phase 1 left in the same scratch).
    stl_k = {}
    for name, kernel in (("stl_intersect_512", "k5"),
                         ("stl_intersect_512", "k7d"),
                         ("cornell_512", "k5"),
                         ("render_stl_500_s1", "k7a"),
                         ("render_stl_500_s32", "k7a")):
        c = stl_cases[name]
        S = c["src"].shape[0]
        outs = isect._outputs(c["dirs"], S)
        table, C = c["table"], c["C"]
        if kernel == "k7a":
            scratch = isect.k7a_scratch(c["dirs"], table, C, S, c["tiles"])

            def k7a_launch(phases, c=c, outs=outs, scratch=scratch):
                return lambda: isect.launch_occluded_masked_kernel(
                    c["dirs"], c["table"], c["C"], c["cam"], c["src"],
                    c["mask"], c["tiles"], *outs, scratch=scratch,
                    phases=phases)
            fns = {"kernel": k7a_launch(3), "primary": k7a_launch(1),
                   "shadow": k7a_launch(2)}
        else:
            mask = (None if kernel == "k5"
                    else c["mask"][:, :c["n_chunks"]].contiguous())

            def launch(c=c, outs=outs, mask=mask):
                isect.launch_closest_kernel(c["dirs"], c["table"][:10],
                                            c["C"], mask, c["tiles"],
                                            *outs[:2])
            fns = {"kernel": launch}
        t = median_ms_in_turns(fns, n=3, reps=5, timer=held_ms)
        if kernel == "k7a":
            # The halves' outputs after the turns = a whole call's.
            fns["primary"]()
            fns["shadow"]()
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in zip(outs, c["out"])),
                    f"{name}: K7a's halves give its outputs")
        # The plain versions, warm from phase 23, back to back: K7a's at
        # S = 32 (seconds) once.
        t["plain"] = (cuda_ms(lambda c=c: run_stl(c, kernel, plain=True), 1)
                      if S > 1 else median_ms_in_turns(
                          {"plain": lambda c=c, k=kernel: run_stl(
                              c, k, plain=True)}, n=1, reps=3)["plain"])
        work = c["work"] if kernel == "k7a" else stl_work(c, kernel)
        t.update(work=work, bound=stl_bound(c, kernel, work),
                 bound_old=stl_bound(c, kernel, work, reject=False),
                 bound_pre_cull=stl_bound(c, kernel, work, cull=False))
        stl_k[f"{kernel}_{name}"] = t
        del outs
        torch.cuda.empty_cache()
    card = card_line()
    for key, t in stl_k.items():
        w = t["work"]
        say(f"{key} alone: {t['kernel']:.4f} ms device time (plain "
            f"{t['plain']:.4f} ms back to back; bound {t['bound'][0]:.4f} "
            f"ms, {t['bound'][1]}; before the cull {t['bound_pre_cull'][0]:.4f}"
            f" ms: {w['primary']} primary and {w['shadow']} shadow plane "
            f"tests, primary keep rate {w['keep']:.4f}) ({card})")
        say(f"{key} cull: {primary_work_line(w['cull'])}")
        if key.startswith("k7a"):
            say(f"{key} halves: primary {t['primary']:.4f} ms, shadow "
                f"{t['shadow']:.4f} ms device time; {w['rejected']} shadow "
                f"tests decided by the reject; bound "
                f"{t['bound'][0]:.4f} ms (without the reject, every test a "
                f"plane test: {t['bound_old'][0]:.4f} ms); {w['hit_tiles']} "
                f"tiles hold a hit ray in {w['hit_warps']} warps ({card})")
    say(f"stl_intersect row (CUDA events, median of 7, 3 calls each): brute "
        f"{row_ms['brute']:.4f} ms, culled {row_ms['culled']:.4f} ms "
        f"(mask included) ({card})")
    say(f"STL frames (CUDA events, median): render --stl 500^2 parity "
        f"{stl_ms['render_stl_500']:.4f} ms, clean {stl_ms['clean_500']:.4f}"
        f" ms, --aa 3 {stl_ms['aa3_500']:.4f} ms, full feature (AA 3, S = "
        f"32, DoF) {stl_ms['full_500']:.4f} ms, 512^2 clean "
        f"{stl_ms['clean_512']:.4f} ms; 512^2 clean train step "
        f"{stl_ms['step_512']:.4f} ms, peak memory {stl_peak:.3f} GB "
        f"({card})")
    say(f"profile of 3 STL steps: device busy {stl_busy['busy_ms']:.4f} ms a "
        f"step in {stl_busy['kernels']} device events; "
        f"{stl_busy['wall_ms']:.4f} ms a step on the host clock under the "
        f"profiler (share {stl_busy['share']})")
    for kname, ms in stl_busy["by_name"][:8]:
        say(f"  {ms:.5f} ms  {kname[:100]}")
    record.update(row_launches=row_launches, row_ms=row_ms,
                  stl_train=stl_train, stl_losses=losses, stl_ms=stl_ms,
                  stl_busy=stl_busy, stl_peak=stl_peak, stl_k={
                      k: {kk: vv for kk, vv in v.items()}
                      for k, v in stl_k.items()})

    say("== phase 26: K10b, K10d, K10h and K10j against their plain "
        "versions on the card")
    parser_s = argparse.ArgumentParser()
    cli_module._render_flags(parser_s)
    stl512_flags = ["--stl", str(stl_path), "--mode", "soft", "--width",
                    "512", "--height", "512"]

    def cli_inputs(flags):
        """The render CLI's scene, camera, lights and config for flags."""
        return cli_module._build_inputs(parser_s.parse_args(flags))

    k10b, k10h = "soft_rt_pri_fwd_masked", "soft_rt_shw_fwd_masked"
    k10d, k10j = "soft_rt_pri_bwd_masked", "soft_rt_shw_bwd_masked"
    masked4 = (k10b, k10d, k10h, k10j)
    mcases = {
        # bench.py's culled soft_raytrace_stl step (`bench.py:644-676`):
        # the mesh padded to 9,216 at 512^2, the rasteriser camera, 40 /
        # 40, one light, cull=True.
        "stl_step_512": srt_case(*soft_stl_frame(512), cull=True),
        # render --mode soft --stl at 512^2: 9,028 triangles (283 chunks),
        # the CLI's STL camera, one light (S = 1) and --soft-shadows 16.
        "render_stl_512": srt_case(*cli_inputs(stl512_flags), cull=True),
        "render_stl_512_s16": srt_case(*cli_inputs(
            stl512_flags + ["--soft-shadows", "16"]), cull=True),
    }
    require(mcases["stl_step_512"]["pri"].shape[0] == 9216
            and mcases["render_stl_512"]["pri"].shape[0] == 283 * 32
            and mcases["render_stl_512_s16"]["srcs"].shape[0] == 16
            and all(c["tiles"].count == 1024 for c in mcases.values()),
            "the culled cases' shapes (1,024 tiles of 16 x 16)")
    srtm_err = {"k10b": 0.0, "k10h": 0.0, "k10d": 0.0, "k10j": 0.0}
    srtm_out, srtm_keep = {}, {}
    for name, c in mcases.items():
        t0 = time.perf_counter()
        got, again = srt_fwd(c, masked=True), srt_fwd(c, masked=True)
        want = srt_fwd(c, plain=True, masked=True)
        brute = srt_fwd(c)
        ones = srt.primary_agg_fwd(c["pri"], c["cam"], c["dirs"], c["es"],
                                   c["zs"], c["chunk"],
                                   torch.ones_like(c["mask"]), c["tiles"])
        world = got[0][3:6].contiguous()
        c["smask"] = srt_shadow_mask(c, world)
        trans, trans2 = (srt_shw(c, world, masked=True),
                         srt_shw(c, world, masked=True))
        twant = srt_shw(c, world, plain=True, masked=True)
        tbrute = srt_shw(c, world)
        tones = srt.shadow_trans_fwd(c["shw"], c["srcs"], world, c["es"],
                                     c["zs"], c["chunk"],
                                     torch.ones_like(c["smask"]), c["tiles"])
        torch.cuda.synchronize()
        ok_b, err_b = agg_close(got, want)
        ok_h, err_h = agg_close((trans,), (twant,))
        same = all(torch.equal(a, b) for a, b in zip((*got, trans),
                                                     (*again, trans2)))
        ones_same = all(torch.equal(a, b) for a, b in zip(
            (*ones, tones), (*brute, tbrute)))
        # Culled = brute at JAX's rule (tests/test_soft_raytrace_cull.py):
        # the frame's attributes and shadow within atol 1e-6 / rtol 1e-6.
        cb = max(float(((a - b).abs() - 1e-6 * b.abs()).max())
                 for a, b in ((got[0], brute[0]), (trans, tbrute)))
        keep = (float(c["mask"].float().mean()),
                float(c["smask"].float().mean()))
        srtm_keep[name] = keep
        say(f"{name} ({c['pri'].shape[0] // c['chunk']} chunks, S="
            f"{c['srcs'].shape[0]}, keep rates primary {keep[0]:.4f} shadow "
            f"{keep[1]:.4f}): K10b vs plain max |d| {err_b:.3g} within rtol "
            f"1e-5 / atol 1e-6 {ok_b}; K10h vs plain {err_h:.3g} within "
            f"{ok_h}; two calls identical {same}; all-ones = K10a/K10g "
            f"bitwise {ones_same}; culled vs brute beyond rtol 1e-6 by "
            f"{cb:.3g} (atol 1e-6); surface share "
            f"{float((got[1] > 1.0).float().mean()):.4f}, trans mean "
            f"{float(trans.mean()):.4f} ({time.perf_counter() - t0:.1f} s)")
        require(ok_b and ok_h, f"{name}: K10b and K10h within rtol 1e-5 / "
                               f"atol 1e-6 of their plain versions")
        require(same and ones_same, f"{name}: two calls identical, all-ones "
                                    f"masks = the unmasked kernels bitwise")
        require(cb <= 1e-6, f"{name}: culled = brute at JAX's rule")
        require(all(bool(torch.isfinite(t).all()) for t in (*got, trans))
                and 0.0 < keep[0] < 1.0 and 0.0 < keep[1] < 1.0,
                f"{name}: finite, the masks drop pairs")
        say(f"  K10b on {name}: "
            f"{pri_fwd_line(pri_fwd_work(c, got[1], masked=True))}")
        srtm_err["k10b"] = max(srtm_err["k10b"], err_b)
        srtm_err["k10h"] = max(srtm_err["k10h"], err_h)
        srtm_out[name] = (got, world, trans)
        del again, want, brute, ones, trans2, twant, tbrute, tones
        torch.cuda.empty_cache()

    # The backward kernels at the culled step's shapes (the only path that
    # runs them), against the plain masked backward in float64 by column
    # group with phase 20's F11 rule.
    from raytpu_torch.kernels.intersect import ray_tiles
    c = mcases["stl_step_512"]
    (_, m, _), world, trans = srtm_out["stl_step_512"]
    t0 = time.perf_counter()
    cot = one_signed((10, m.shape[0]), dev, seed=7)
    gcot = one_signed(tuple(trans.shape), dev, seed=8)
    srtm_cots = (cot, gcot)
    got, again = srt_bwd(c, m, cot, masked=True), srt_bwd(c, m, cot,
                                                           masked=True)
    sgot, sagain = (srt_shw_bwd(c, world, trans, gcot, masked=True),
                    srt_shw_bwd(c, world, trans, gcot, masked=True))
    kb, skb = srt_bwd(c, m, cot), srt_shw_bwd(c, world, trans, gcot)
    # Every bit set, on tiles of 256 consecutive rays (K10c's own blocks):
    # K10c's and K10i's bits.
    runs = ray_tiles(m.shape[0], None, dev)
    n_chunks, S = c["pri"].shape[0] // c["chunk"], c["srcs"].shape[0]
    ones = srt.primary_agg_bwd(
        c["pri"], c["cam"], c["dirs"], m, cot, c["es"], c["zs"], c["chunk"],
        mask=torch.ones((runs.count, n_chunks), dtype=torch.int32,
                        device=dev), tiles=runs)
    sones = srt.shadow_trans_bwd(
        c["shw"], c["srcs"], world, trans, gcot, c["es"], c["zs"],
        c["chunk"], mask=torch.ones((runs.count, S, n_chunks),
                                    dtype=torch.int32, device=dev),
        tiles=runs)
    same = all(torch.equal(a, b) for a, b in zip((*got, *sgot),
                                                 (*again, *sagain)))
    ones_same = all(torch.equal(a, b) for a, b in zip((*ones, *sones),
                                                      (*kb, *skb)))
    w64 = srt_bwd(c, m, cot, plain=True, dtype=torch.float64, masked=True)
    p32 = srt_bwd(c, m, cot, plain=True, masked=True)
    sw64 = srt_shw_bwd(c, world, trans, gcot, plain=True,
                       dtype=torch.float64, masked=True)
    sp32 = srt_shw_bwd(c, world, trans, gcot, plain=True, masked=True)
    torch.cuda.synchronize()
    say(f"stl_step_512 backward: two calls identical {same}; all-ones on "
        f"256-ray runs = K10c/K10i bitwise {ones_same} "
        f"({time.perf_counter() - t0:.1f} s); by group, the largest |d| "
        f"scaled by the group's largest float64 entry:")
    require(same and ones_same, "K10d/K10j: two calls identical, all-ones "
                                "= K10c/K10i bitwise")
    srtm_checks = {}
    one = (("all", 0, 3),)
    pieces = [
        ("k10d", "table", got[0], w64[0], p32[0], kb[0], srt.PRI_GROUPS),
        ("k10d", "camera", got[1][None], w64[1][None], p32[1][None],
         kb[1][None], one),
        ("k10d", "dirs", got[2].T, w64[2].T, p32[2].T, kb[2].T, one),
        ("k10j", "table", sgot[0], sw64[0], sp32[0], skb[0], srt.SHW_GROUPS),
        ("k10j", "sources", sgot[1], sw64[1], sp32[1], skb[1], one),
        ("k10j", "world", sgot[2].T, sw64[2].T, sp32[2].T, skb[2].T, one)]
    for kernel, part, g, w, p, b, groups in pieces:
        r64, r32, f64, rcb = (rule_by_group(g, w, groups),
                              rule_by_group(g, p, groups),
                              rule_by_group(p, w, groups),
                              rule_by_group(g, b, groups))
        for grp in r64:
            # Phase 20's rule against the plain masked version; culled =
            # brute at the same rule or, where float32 itself misses it
            # (F11), within twice the plain float32 version's own distance
            # from float64.
            chk = dict(err64=r64[grp][0], ok64=r64[grp][1],
                       err32=r32[grp][0], ok32=r32[grp][1],
                       floor64=f64[grp][0], errcb=rcb[grp][0],
                       okcb=rcb[grp][1] or rcb[grp][0] <= 2.0 * f64[grp][0],
                       ok=r32[grp][1] and (r64[grp][1] or r64[grp][0]
                                           <= 1.01 * f64[grp][0]))
            srtm_checks.setdefault(kernel, {})[
                f"stl_step_512 {part}/{grp}"] = [
                chk["err64"], chk["ok64"], chk["floor64"], chk["ok32"]]
            label = f"{kernel} {part}/{grp}"
            say(f"  {label}: vs float64 {chk['err64']:.3g} within "
                f"{chk['ok64']}; plain float32 vs float64 "
                f"{chk['floor64']:.3g}; vs plain float32 {chk['err32']:.3g} "
                f"within {chk['ok32']}; culled vs brute {chk['errcb']:.3g} "
                f"passes {chk['okcb']}; passes on "
                f"{'float64' if chk['ok64'] else 'the F11 rule'} {chk['ok']}")
            require(chk["ok"] and chk["okcb"],
                    f"stl_step_512 {label}: within rtol 1e-4 / atol 1e-5 "
                    f"after scaling, culled = brute")
            srtm_err[kernel] = max(srtm_err[kernel], chk["err64"])
    require(all(bool(torch.isfinite(t).all()) for t in (*got, *sgot))
            and not got[0][:, srt.PRI_USED:].any()
            and not sgot[0][:, srt.SHW_USED:].any(),
            "K10d/K10j: finite gradients, unused columns 0")
    del pieces, w64, p32, sw64, sp32, again, sagain, ones, sones, kb, skb
    torch.cuda.empty_cache()

    say("== phase 27: culled soft raytrace serving (render --mode soft "
        "--stl at 512^2, the view server's key 0 on the STL scene)")
    zero_counts()
    seen = []
    srt.primary_agg_fwd, srt.shadow_trans_fwd = spy_pri, spy_shw
    try:
        for flags, shapes, bmp_name in (
                (stl512_flags, [("chunks", 283), ("sources", 1)],
                 "raytrace_soft_stl512_s1.bmp"),
                (stl512_flags + ["--soft-shadows", "16"],
                 [("chunks", 283), ("sources", 16)],
                 "raytrace_soft_stl512_s16.bmp")):
            before = kernel_counts()
            del seen[:]
            t0 = time.perf_counter()
            cli_main(["render", *flags, "-o", str(OUT / bmp_name)])
            ms = (time.perf_counter() - t0) * 1e3
            got = delta(before, kernel_counts())
            frame_u8 = read_bmp(str(OUT / bmp_name))
            lit = float((frame_u8.max(axis=-1) > 0).mean())
            say(f"render CLI {' '.join(flags[2:])}: {frame_u8.shape}, lit "
                f"{lit:.4f}, max {frame_u8.max()}, {ms:.1f} ms host clock, "
                f"launches {got}, {seen}")
            require(frame_u8.shape == (512, 512, 3) and lit > 0.02
                    and frame_u8.max() > 20, f"a lit {bmp_name}")
            require(got == {k10b: 1, k10h: 1} and seen == shapes,
                    f"{bmp_name}: one K10b and one K10h over {shapes}")
    finally:
        srt.primary_agg_fwd, srt.shadow_trans_fwd = real_pri, real_shw
    # The view CLI's inputs (cmd_view): the render flags' scene, camera and
    # config, a 32-slot light bank of 16 jittered positions each.
    vs, vc, _, vcfg = cli_inputs(["--stl", str(stl_path), "--width", "512",
                                  "--height", "512"])
    stl_viewer = ViewerApp(vs, vc, Lights.single(capacity=32,
                                                 soft_samples=16,
                                                 device=dev), vcfg)
    serve_and_check(stl_viewer, [("/frame.bmp", 200, {k7an: 1}),
                                 ("/key?k=0", 200, {k10b: 1, k10h: 1}),
                                 ("/key?k=left", 200, {k10b: 1, k10h: 1}),
                                 ("/key?k=0", 200, {k7an: 1}),
                                 ("/state", 200, {})])
    require(stl_viewer.cfg.mode == "clean", "key 0 toggles soft and back")
    rtm_serve = kernel_counts()  # zeroed where phase 27 began
    say(f"culled soft raytrace serving path launches: "
        f"{ {k: v for k, v in rtm_serve.items() if v} }")
    require(rtm_serve[k10b] == 4 and rtm_serve[k10h] == 4
            and rtm_serve[k7an] == 2
            and not any(v for k, v in rtm_serve.items()
                        if k not in (k10b, k10h, k7an)),
            "the culled serving path launched K10b, K10h (4 each) and K7a "
            "(the viewer's hard frames), nothing else")

    say("== phase 28: the culled soft_raytrace_stl step and card numbers")

    def culled(s_, c_, l_, cfg_):
        return raytrace_soft(s_, c_, l_, cfg_, cull=True)

    step_rt_stl_c = train_step(*soft_stl_frame(512), 1e-9, target_scale=0.9,
                               render=culled)
    zero_counts()
    losses = [float(step_rt_stl_c()) for _ in range(2)]
    rtm_train = {k: v for k, v in kernel_counts().items() if v}
    say(f"soft_raytrace_stl culled step: 2 steps, loss {losses[0]:.6g} -> "
        f"{losses[-1]:.6g}; launches {rtm_train}")
    require(rtm_train == {k: 2 for k in masked4},
            "each culled step launches K10b, K10d, K10h and K10j once, no "
            "unmasked K10")
    require(np.isfinite(losses).all(), "finite culled loss")
    rtm_peak = {"culled_step": peak_gb(step_rt_stl_c),
                "brute_step": peak_gb(step_rt_stl)}
    rtm_busy = {"culled_step": device_busy(step_rt_stl_c, steps=3)}
    rtm_ms = median_ms_in_turns({"culled_step": step_rt_stl_c,
                                 "brute_step": step_rt_stl}, n=1, reps=3)
    rtm_ms.update(median_ms_in_turns({
        "step_frame_culled": rframe(soft_stl_frame(512), cull=True),
        "render_stl512": rframe(cli_inputs(stl512_flags)),
        "render_stl512_s16": rframe(cli_inputs(
            stl512_flags + ["--soft-shadows", "16"]))}, n=1, reps=5))
    rtm_k = {}
    for name, c in mcases.items():
        (_, m, _), world, trans = srtm_out[name]
        step_case = name == "stl_step_512"
        cot, gcot = srtm_cots if step_case else (None, None)
        kernels, plain = srt_timers(c, m, world, trans, cot, gcot,
                                    masked=True)
        parts = (("pri_fwd", "pri_bwd", "shw_fwd", "shw_bwd") if step_case
                 else ("pri_fwd", "shw_fwd"))
        t = median_ms_in_turns({k: kernels[k] for k in parts}, n=2, reps=5,
                               timer=held_ms)
        # The plain versions once each (0.6-10 s a call; phase 26 ran them
        # on these shapes already).
        t.update({f"{k}_plain": cuda_ms(plain[k], 1) for k in parts})
        dl = gcot * trans * (-srt.OD_SCALE) if step_case else None
        work = srt_work(c, m, world, dl, masked=True)
        t["work"] = work
        if step_case:
            t["items"] = pri_item_work(c, m, masked=True)
        t["bounds"] = srt_bounds(c, work, masked=True)
        rtm_k[name] = t
        del kernels, plain
        torch.cuda.empty_cache()
    card = card_line()
    for name, t in rtm_k.items():
        w = t["work"]
        parts = [k for k in ("pri_fwd", "pri_bwd", "shw_fwd", "shw_bwd")
                 if k in t]
        say(f"K10 masked alone, {name} (keep rates primary "
            f"{srtm_keep[name][0]:.4f} shadow {srtm_keep[name][1]:.4f}; "
            f"{w['pairs']} kept pairs, {w['gated_p']} gated, {w['live_p']} "
            f"of weight not 0; {w['triples']} kept shadow triples, "
            f"{w['gated_s']} gated; backward {w['act_s']} of d od not 0, "
            f"{w['live_s']} live): "
            + ", ".join(
                f"{k} {t[k]:.4f} ms (plain {t[k + '_plain']:.4f}; bound "
                f"{t['bounds'][k][0]:.4f} ms, {t['bounds'][k][1]})"
                for k in parts) + f" ({card})")
        say(f"  K10b on {name}: {pri_fwd_line(w)}")
        if "items" in t:
            say(f"  K10d on {name}: {pri_work_line(w, t['items'])}")
    say(f"soft_raytrace_stl steps (CUDA events, median of 3): culled "
        f"{rtm_ms['culled_step']:.4f} ms, brute {rtm_ms['brute_step']:.4f} "
        f"ms; peak memory culled {rtm_peak['culled_step']:.3f} GB, brute "
        f"{rtm_peak['brute_step']:.3f} GB; frames (median of 5): the step's "
        f"512^2 frame culled {rtm_ms['step_frame_culled']:.4f} ms, render "
        f"--mode soft --stl 512^2 {rtm_ms['render_stl512']:.4f} ms, with "
        f"--soft-shadows 16 {rtm_ms['render_stl512_s16']:.4f} ms ({card})")
    busy = rtm_busy["culled_step"]
    say(f"profile of 3 culled soft_raytrace_stl steps: device busy "
        f"{busy['busy_ms']:.4f} ms a step in {busy['kernels']} device "
        f"events; {busy['wall_ms']:.4f} ms a step on the host clock under "
        f"the profiler (share {busy['share']})")
    for kname, ms in busy["by_name"][:8]:
        say(f"  {ms:.5f} ms  {kname[:100]}")
    record.update(srtm_err=srtm_err, srtm_checks=srtm_checks,
                  srtm_keep=srtm_keep, rtm_serve=rtm_serve,
                  rtm_train=rtm_train, rtm_losses=losses, rtm_ms=rtm_ms,
                  rtm_peak=rtm_peak, rtm_busy=rtm_busy, rtm_k=rtm_k)

    sharded_entries = sharded_phases(dev, stl_path, record)
    two_launch_entries = two_launch_phase(dev, record)
    lab_entries = lab_phases(dev, record)
    lab_entries += kernel_lab_phases(dev, record)

    (OUT / "result.json").write_text(json.dumps(record, indent=1))

    def bwd_checks(prefix: str) -> dict:
        """Phase 16's rule for each case of K9c (prefix k9a) or K9d (k9b)
        and each column group: [scaled error vs float64, within the rule,
        the plain float32 version's scaled error vs float64, K9c/K9d within
        the rule of that version]."""
        return {label: {g: [c["err64"], c["ok64"], c["floor64"], c["ok32"]]
                        for g, c in check.items()}
                for label, check in soft_checks.items()
                if label.startswith(prefix)}

    def fwd_work(w) -> dict:
        """The primary forward's counts of pri_fwd_work for the kernels
        line."""
        return {k: w[k] for k in ("pairs", "gated_p", "dead_pf", "live_p",
                                  "fwd_run", "fwd_items", "fwd_merged")}

    def k10_entry(part: str, key: str, replaces: str) -> dict:
        """A soft raytrace kernel's entry: its launches in the raytrace fit
        CLI, its error (K10c/K10i: the largest group-scaled error against
        float64, with the groups' checks), times and bound at the bench's
        512^2 Cornell case."""
        t = rt_k["bench_512"]
        entry = dict(name=f"soft_rt_{part}", route="cuda",
                     source="raytpu_torch/csrc/soft_raytrace.cu",
                     replaces=replaces,
                     launches=rfit_launches[f"soft_rt_{part}"],
                     max_abs_err=srt_err[key], ms=t[part],
                     plain_ms=t[f"{part}_plain"],
                     bound_ms=t["bounds"][part][0],
                     bound_by=t["bounds"][part][1], library_ms=None)
        for case in ("fit_500", "stl_512_brute"):  # the other frames
            f = rt_k[case]
            entry[case] = dict(ms=f[part], plain_ms=f[f"{part}_plain"],
                               bound_ms=f["bounds"][part][0],
                               bound_by=f["bounds"][part][1])
        if part == "pri_fwd":
            entry["work"] = {case: fwd_work(f["work"])
                             for case, f in rt_k.items()}
        if key in srt_checks:
            entry["checks"] = srt_checks[key]
        return entry

    def k10m_entry(part: str, key: str, launches: int,
                   replaces: str) -> dict:
        """A masked soft raytrace kernel's entry: its launches on the main
        path (K10b, K10h: phase 27's serving; K10d, K10j: phase 28's
        culled steps), its error (K10d/K10j: the largest group-scaled
        error against float64, with the groups' checks), times and bound
        at the culled step's shapes; the forwards' at the render --stl
        512^2 frame's beside them (S = 1 and S = 16)."""
        t = rtm_k["stl_step_512"]
        entry = dict(name=f"soft_rt_{part}_masked", route="cuda",
                     source="raytpu_torch/csrc/soft_raytrace.cu",
                     replaces=replaces, launches=launches,
                     max_abs_err=srtm_err[key], ms=t[part],
                     plain_ms=t[f"{part}_plain"],
                     bound_ms=t["bounds"][part][0],
                     bound_by=t["bounds"][part][1], library_ms=None)
        for case in ("render_stl_512", "render_stl_512_s16"):
            f = rtm_k[case]
            if part in f:
                entry[case] = dict(ms=f[part], plain_ms=f[f"{part}_plain"],
                                   bound_ms=f["bounds"][part][0],
                                   bound_by=f["bounds"][part][1])
        if part == "pri_fwd":
            entry["work"] = {case: fwd_work(f["work"])
                             for case, f in rtm_k.items()}
        # K10h and K10j on phase 32's culled steps (66,560 and 36,000
        # triangles): time, bound, keep rate and the triples skipped.
        for T, b in record["k10hj_big"].items():
            if part not in ("shw_fwd", "shw_bwd"):
                break
            fwd = part == "shw_fwd"
            w = b["work"]
            bound = b["bound_fwd" if fwd else "bound_bwd"]
            entry[f"step_{T}"] = dict(
                ms=b["ms"]["k10h" if fwd else "k10j"], bound_ms=bound[0],
                bound_by=bound[1], keep=b["keep"], triples=w["triples"],
                gated=w["gated_s"] if fwd else w["act_gated_s"],
                dead=w["dead_f"] if fwd else w["dead_s"],
                live=w["live_f"] if fwd else w["live_s"])
        if key in srtm_checks:
            entry["checks"] = srtm_checks[key]
        return entry

    def stl_entry(name: str, key: str, case: str, launches: int,
                  replaces: str, s32=None, t32=None) -> dict:
        """K5's, K7d's or K7a's entry: its launches on the main path (the
        stl_intersect row's call; K7a: phase 24's serving), its t error
        against plain, its times and bounds on its phase 25 case (K7a: the
        render --stl sub-ray, S = 1, and the S = 32 sources beside; K5:
        ``t32``, phase 30's launches and the time on its Cornell sub-ray)."""
        t = stl_k[case]
        entry = dict(name=name, route="cuda",
                     source="raytpu_torch/csrc/intersect.cu",
                     replaces=replaces, launches=launches,
                     max_abs_err=stl_err[key], ms=t["kernel"],
                     plain_ms=t["plain"], bound_ms=t["bound"][0],
                     bound_by=t["bound"][1], library_ms=None,
                     bound_pre_cull_ms=t["bound_pre_cull"][0],
                     cull=t["work"]["cull"])
        if t32 is not None:
            entry["t32"] = dict(launches=t32[0], ms=t32[1]["kernel"],
                                plain_ms=t32[1]["plain"],
                                bound_ms=t32[1]["bound"][0],
                                bound_by=t32[1]["bound"][1])
        if s32 is not None:
            entry["s32"] = dict(ms=s32["kernel"], plain_ms=s32["plain"],
                                bound_ms=s32["bound"][0],
                                bound_by=s32["bound"][1])
            for part, tt in (("s1", t), ("s32", s32)):
                entry.setdefault(part, {}).update(
                    primary_ms=tt["primary"], shadow_ms=tt["shadow"],
                    bound_without_reject_ms=tt["bound_old"][0],
                    reject_share=tt["work"]["rejected"]
                    / tt["work"]["shadow"])
        return entry

    say(card)
    print(json.dumps({"kernels": [
        dict(name="render_fused_fwd", route="cuda",
             source="raytpu_torch/csrc/render_fused.cu",
             replaces="raytpu/kernels/render_fused.py:228",
             launches=launches, max_abs_err=max_err, ms=k1_ms["kernel"],
             plain_ms=k1_ms["plain"], bound_ms=k1_bound[0],
             bound_by=k1_bound[1], library_ms=None,
             bound_pre_cull_ms=k1_bound_old[0]),
        dict(name="render_fused_bwd", route="cuda",
             source="raytpu_torch/csrc/render_fused_bwd.cu",
             replaces="raytpu/kernels/render_fused.py:402",
             launches=train_launches["render_fused_bwd"],
             max_abs_err=bwd_err["rays"], ms=k2_ms["kernel"],
             plain_ms=k2_ms["plain"], bound_ms=k2_bound[0],
             bound_by=k2_bound[1], library_ms=None),
        dict(name="render_fused_scatter", route="cuda",
             source="raytpu_torch/csrc/render_fused_bwd.cu",
             replaces="raytpu/kernels/render_fused.py:476",
             launches=train_launches["render_fused_scatter"],
             max_abs_err=bwd_err["sums"], ms=k3_ms["kernel"],
             plain_ms=k3_ms["plain"], bound_ms=k3_bound[0],
             bound_by=k3_bound[1], library_ms=k3_ms["index_add_"]),
        dict(name="closest_hit_occluded", route="cuda",
             source="raytpu_torch/csrc/intersect.cu",
             replaces="raytpu/kernels/intersect_pallas.py:288",
             launches=serve_launches[k4], max_abs_err=sweep_err[False],
             ms=k4_ms["kernel"], plain_ms=k4_ms["plain"],
             bound_ms=k4_bound[0], bound_by=k4_bound[1], library_ms=None,
             bound_pre_cull_ms=k4_bound_old[0]),
        dict(name="closest_hit_occluded_multi", route="cuda",
             source="raytpu_torch/csrc/intersect.cu",
             replaces="raytpu/kernels/intersect_pallas.py:451",
             launches=full_launches[k6], max_abs_err=sweep_err[True],
             ms=k6_ms["kernel"], plain_ms=k6_ms["plain"],
             bound_ms=k6_bound[0], bound_by=k6_bound[1], library_ms=None),
        dict(name="raster_winner", route="cuda",
             source="raytpu_torch/csrc/raster.cu",
             replaces="raytpu/kernels/raster_pallas.py:90",
             launches=raster_serve[k8b], max_abs_err=winner_err["k8b"],
             ms=k8b_ms["kernel"], plain_ms=k8b_ms["plain"],
             bound_ms=k8b_bound[0], bound_by=k8b_bound[1], library_ms=None),
        dict(name="raster_winner_masked", route="cuda",
             source="raytpu_torch/csrc/raster.cu",
             replaces="raytpu/kernels/raster_pallas.py:178",
             launches=raster_serve["raster_winner_masked"],
             max_abs_err=winner_err["k8c"], ms=k8c_ms["kernel"],
             plain_ms=k8c_ms["plain"], bound_ms=k8c_bound[0],
             bound_by=k8c_bound[1], library_ms=None),
        dict(name="soft_raster_fwd", route="cuda",
             source="raytpu_torch/csrc/soft_raster.cu",
             replaces="raytpu/kernels/soft_raster_pallas.py:245",
             launches=fit_launches["soft_raster_fwd"],
             max_abs_err=soft_err["k9a"], ms=soft_k["bench"]["fwd"],
             plain_ms=soft_k["bench"]["fwd_plain"],
             bound_ms=soft_k["bench"]["fwd_bound"][0],
             bound_by=soft_k["bench"]["fwd_bound"][1], library_ms=None),
        dict(name="soft_raster_fwd_masked", route="cuda",
             source="raytpu_torch/csrc/soft_raster.cu",
             replaces="raytpu/kernels/soft_raster_pallas.py:342",
             launches=soft_serve["soft_raster_fwd_masked"],
             max_abs_err=soft_err["k9b"], ms=soft_k["stl_culled"]["fwd"],
             plain_ms=soft_k["stl_culled"]["fwd_plain"],
             bound_ms=soft_k["stl_culled"]["fwd_bound"][0],
             bound_by=soft_k["stl_culled"]["fwd_bound"][1], library_ms=None),
        dict(name="soft_raster_bwd", route="cuda",
             source="raytpu_torch/csrc/soft_raster.cu",
             replaces="raytpu/kernels/soft_raster_pallas.py:286",
             launches=fit_launches["soft_raster_bwd"],
             max_abs_err=soft_err["k9c"], ms=soft_k["bench"]["bwd"],
             plain_ms=soft_k["bench"]["bwd_plain"],
             bound_ms=soft_k["bench"]["bwd_bound"][0],
             bound_by=soft_k["bench"]["bwd_bound"][1], library_ms=None,
             checks=bwd_checks("k9a")),
        dict(name="soft_raster_bwd_masked", route="cuda",
             source="raytpu_torch/csrc/soft_raster.cu",
             replaces="raytpu/kernels/soft_raster_pallas.py:389",
             launches=soft_train["soft_stl_culled"]["soft_raster_bwd_masked"],
             max_abs_err=soft_err["k9d"], ms=soft_k["stl_culled"]["bwd"],
             plain_ms=soft_k["stl_culled"]["bwd_plain"],
             bound_ms=soft_k["stl_culled"]["bwd_bound"][0],
             bound_by=soft_k["stl_culled"]["bwd_bound"][1], library_ms=None,
             checks=bwd_checks("k9b")),
        k10_entry("pri_fwd", "k10a",
                  replaces="raytpu/kernels/soft_raytrace_pallas.py:235"),
        k10_entry("pri_bwd", "k10c",
                  replaces="raytpu/kernels/soft_raytrace_pallas.py:326"),
        k10_entry("shw_fwd", "k10g",
                  replaces="raytpu/kernels/soft_raytrace_pallas.py:925"),
        k10_entry("shw_bwd", "k10i",
                  replaces="raytpu/kernels/soft_raytrace_pallas.py:974"),
        stl_entry("closest_hit", "k5", "k5_stl_intersect_512",
                  row_launches["brute"][k5n],
                  replaces="raytpu/kernels/intersect_pallas.py:89",
                  t32=(record["sharded_serve"]["closest_hit"],
                       stl_k["k5_cornell_512"])),
        stl_entry("closest_hit_masked", "k7d", "k7d_stl_intersect_512",
                  row_launches["culled"][k7dn],
                  replaces="raytpu/kernels/intersect_pallas.py:1128"),
        stl_entry("closest_hit_occluded_masked", "k7a",
                  "k7a_render_stl_500_s1", stl_serve[k7an],
                  replaces="raytpu/kernels/intersect_pallas.py:632",
                  s32=stl_k["k7a_render_stl_500_s32"]),
        k10m_entry("pri_fwd", "k10b", rtm_serve[k10b],
                   replaces="raytpu/kernels/soft_raytrace_pallas.py:276"),
        k10m_entry("pri_bwd", "k10d", rtm_train[k10d],
                   replaces="raytpu/kernels/soft_raytrace_pallas.py:390"),
        k10m_entry("shw_fwd", "k10h", rtm_serve[k10h],
                   replaces="raytpu/kernels/soft_raytrace_pallas.py:945"),
        k10m_entry("shw_bwd", "k10j", rtm_train[k10j],
                   replaces="raytpu/kernels/soft_raytrace_pallas.py:1031"),
        *sharded_entries,
        *two_launch_entries,
        *lab_entries,
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
