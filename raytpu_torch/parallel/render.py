"""Sharded rendering and the sharded train step on torch.distributed
(counterpart of raytpu/parallel/render.py).

An SPMD re-design of the reference's OpenMP row loop (`raytracer.cpp:557`),
on the ('data', 'model') mesh of parallel/mesh.py:

  * image rows are sharded over 'data': each rank renders a contiguous row
    block, rows [y0, y0 + rows) with y0 = data index * rows;
  * triangles are sharded over 'model': each rank intersects its block of
    the (replicated) scene with the single-card kernels, and the global
    closest hit is merged over the axis in ascending block order with the
    reference's last-wins tie rule (`raytracer.cpp:243`); the shadow bits
    merge by an any-reduce, the rasterizer's z-test by a strict ``>``
    (the earlier block keeps ties, `rasteriser.cpp:606`), the soft
    aggregates by a softmax combine and the soft shadow by a product of
    transmittances;
  * scene attributes stay replicated, so winner gathers are local.

The kernels a block launches (on CUDA tensors; their plain versions on the
CPU): the primary hit through K5 (a block of <= 128 triangles) or K7d with
its keep-mask (more); the occlusion of the merged hit positions through K7b
or, above 128 triangles, K7c with kernels/intersect.py::position_mask; the
raster winner through K8b or, above 128 triangles, K8a; the soft
aggregates through K9a/K9c (SoftAggStats) and K10a/K10c (PrimaryAggStats),
the soft shadow through K10g/K10i, all unmasked, as JAX's sharded blocks
run them (a rank's block above JAX's fused limit takes the two-launch
backwards K10e + K10f and K10k + K10l, as JAX's does).

Each ``make_*`` returns a callable that gives this rank's row block;
``gather_image`` assembles the full image on every rank, differentiably.
The DoF blur runs on the row blocks with a halo exchange over 'data'
(``dof_block``), zeros beyond the image's edges, as ``dof_blur`` pads.

Gradients. Parameters are replicated; the objective is the sum over ranks
of each rank's share, and every collective a gradient crosses transposes
under that sum (parallel/collectives.py). A train step differentiates each
rank's share, sum over 'data' of the squared error / (H W 3) / |model|
(the model ranks hold the same image block), then sums every parameter's
gradient over the whole world (``reduce_grads``), which gives every rank the
single-process gradient. The loss itself is the data-sum of the squared
error / (H W 3), in rank order: the same bits on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from raytpu_torch.core.types import (
    Camera,
    Lights,
    RenderConfig,
    Scene,
    pixel_grid,
)
from raytpu_torch.kernels import soft_raytrace as srt
from raytpu_torch.kernels.intersect import (
    ONE_HOT_MAX,
    intersect_closest,
    intersect_closest_culled,
    occlusion_multi,
    position_mask,
    ray_tiles,
)
from raytpu_torch.kernels.raster import raster_tri_constants, resolve_winner
from raytpu_torch.kernels.soft_raster import SoftAggStats, soft_tri_constants
from raytpu_torch.kernels.tables import MAX_CHUNK as MAX_TRIS
from raytpu_torch.kernels.tables import tight_chunk
from raytpu_torch.ops.blur import _interior_mask, _weights, _window_sum
from raytpu_torch.ops.intersect import (
    F32MAX,
    Hits,
    gather_rows,
    gather_rows_by_index,
    hit_distances,
    hit_positions,
    one_hot_idx,
    tri_constants,
)
from raytpu_torch.ops.raster import cull_mask
from raytpu_torch.ops.shade import composite, direct_light, source_positions
from raytpu_torch.parallel.collectives import (
    all_gather,
    all_gather_grad,
    psum,
    shift,
    sum_in_order,
)
from raytpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_group,
    axis_index,
    axis_size,
)
from raytpu_torch.render.raytrace import _subpixel_offsets, camera_ray_dirs
from raytpu_torch.render.soft import (
    _screen_vertices,
    _shade_winner,
    shade_agg_raster,
    shade_agg_raytrace,
    soft_chunk,
)


def _block_range(T: int, mesh) -> tuple[int, int]:
    """(base, tb): this rank's contiguous block of T triangles, rows
    [base, base + tb), the model index's share; T must divide by |model|."""
    nm = axis_size(mesh, MODEL_AXIS)
    if T % nm != 0:
        raise ValueError(f"triangle count {T} not divisible by model axis "
                         f"{nm}; use Scene.pad_to")
    tb = T // nm
    return axis_index(mesh, MODEL_AXIS) * tb, tb


def _scene_block(scene: Scene, mesh) -> tuple[Scene, int]:
    """This rank's contiguous triangle block of the replicated scene and
    its global base index."""
    base, tb = _block_range(scene.num_triangles, mesh)
    return Scene(**{f.name: getattr(scene, f.name)[base:base + tb]
                    for f in dataclasses.fields(Scene)}), base


def _merged_intersect(start, dirs, block: Scene, base: int,
                      cfg: RenderConfig, mesh, image_hw: tuple) -> Hits:
    """Closest hit against the FULL scene from the per-rank triangle
    blocks: each rank's hits (K5, or K7d above 128 triangles), gathered
    over 'model' and merged in ascending block order, a later block winning
    ties. t is differentiable across the merge."""
    consts = tri_constants(block, start)
    if block.num_triangles > MAX_TRIS:
        h = intersect_closest_culled(dirs, consts, start, block.v0, block.v1,
                                     block.v2, tri_chunk=cfg.tri_chunk,
                                     image_hw=image_hw)
    else:
        h = intersect_closest(dirs, consts, tri_chunk=cfg.tri_chunk)
    group = axis_group(mesh, MODEL_AXIS)
    ts = all_gather_grad(torch.where(h.hit, h.t, F32MAX), group)
    idxs = all_gather(torch.where(h.hit, h.idx + base, -1), group)
    best_t, best_idx = ts[0], idxs[0]
    for m in range(1, ts.shape[0]):
        upd = ts[m] <= best_t  # later (higher-index) blocks win ties
        best_t = torch.where(upd, ts[m], best_t)
        best_idx = torch.where(upd, idxs[m], best_idx)
    hit = best_t < F32MAX
    return Hits(t=best_t, idx=torch.where(hit, best_idx, -1), hit=hit)


def _merged_occlusion_rows(pos, block: Scene, src_pos, cfg: RenderConfig,
                           mesh, image_hw: tuple) -> torch.Tensor:
    """(S, R) bool occlusion of the S sources toward pos (R, 3) against the
    FULL scene: each rank tests its triangle block (K7b, or K7c with its
    position keep-mask above 128 triangles), then any-reduces over
    'model'. No gradient: occlusion is piecewise constant."""
    with torch.no_grad():
        consts = tri_constants(block, src_pos)
        mask = tiles = None
        if block.num_triangles > MAX_TRIS:
            tiles = ray_tiles(pos.shape[0], image_hw, pos.device)
            mask = position_mask(
                pos, tiles, (block.v0, block.v1, block.v2), block.active,
                src_pos, tight_chunk(block.num_triangles, cfg.tri_chunk))
        occ = occlusion_multi(pos, consts.m, consts.k0, src_pos,
                              block.active, cfg.tri_chunk, mask, tiles)
        gathered = all_gather(occ, axis_group(mesh, MODEL_AXIS))
        return gathered.amax(dim=0) > 0


def render_block(scene: Scene, camera: Camera, lights: Lights,
                 cfg: RenderConfig, y0: int, rows: int, mesh):
    """Render rows [y0, y0 + rows) on the mesh: the full clean / parity
    (non-AA-record) feature set of the single-card path, AA sub-rays, soft
    shadows and several lights, every (light, sample) source's occlusion in
    one launch a sub-ray and any-merged over 'model'. Returns (color
    (rows * W, 3), focal distances (rows * W,)); DoF is the caller's
    (dof_block)."""
    xs, ys = pixel_grid(rows, cfg.width, scene.device, y0)
    block, base = _scene_block(scene, mesh)
    src_pos = source_positions(lights, cfg.soft_shadow_samples)
    offsets = _subpixel_offsets(cfg)
    T = scene.num_triangles
    normals_albedo = torch.cat([scene.normals(), scene.color], dim=1)
    image_hw = (rows, cfg.width)
    accum = None
    rec_dist = torch.full(xs.shape, F32MAX, device=xs.device)
    for dx, dy in offsets:
        dirs = camera_ray_dirs(xs + dx, ys + dy, camera, cfg)
        hits = _merged_intersect(camera.pos, dirs, block, base, cfg, mesh,
                                 image_hw)
        pos = hit_positions(camera.pos, dirs, hits)
        idx = hits.idx.clamp_min(0)
        # The closest Euclidean distance over the sub-rays (feeds DoF).
        dist_ = hit_distances(dirs, hits)
        upd = hits.hit & (dist_ <= rec_dist)
        rec_dist = torch.where(upd, dist_, rec_dist)
        occ = _merged_occlusion_rows(pos, block, src_pos, cfg, mesh,
                                     image_hw)
        if T <= ONE_HOT_MAX:
            both = gather_rows(one_hot_idx(idx, T), normals_albedo)
        else:
            both = gather_rows_by_index(normals_albedo, idx)
        direct = direct_light(pos, idx, scene, lights, cfg,
                              n_dir=both[:, :3], occlusion_rows=occ)
        color = composite(direct, both[:, 3:], hits.hit, cfg)
        accum = color if accum is None else accum + color
    fd = torch.where(rec_dist < F32MAX, rec_dist - camera.dof_focus, 0.0)
    return accum / float(len(offsets)), fd


def dof_block(img_block, fd_block, cfg: RenderConfig, global_h: int,
              y0: int, mesh) -> torch.Tensor:
    """The clean DoF blur on this rank's row block (rows, W, 3), with a
    halo exchange over 'data': the K x K window needs K/2 rows of the
    previous block and K/2 - 1 of the next; the image's first and last
    blocks receive zeros, dof_blur's zero padding, so the blocks blur as
    the whole image does. The weights take the block's own focal distances
    fd_block (rows, W); the 1-pixel border of the whole image is black."""
    if not cfg.dof_enabled:
        return img_block
    k = cfg.dof_kernel_size
    lo = k // 2       # rows from the previous block
    hi = k - lo - 1   # rows from the next block
    rows, w, _ = img_block.shape
    if rows < max(lo, hi):
        raise ValueError(f"row shard of {rows} smaller than the DoF halo "
                         f"{max(lo, hi)}")
    group = axis_group(mesh, DATA_AXIS)
    parts = [img_block]
    if lo:
        parts.insert(0, shift(img_block[rows - lo:], group, 1))
    if hi:
        parts.append(shift(img_block[:hi], group, -1))
    ext = torch.cat(parts)  # (rows + k - 1, W, 3)
    pad = F.pad(ext.permute(2, 0, 1), (lo, hi)).permute(1, 2, 0)
    box = _window_sum(_window_sum(pad, k, 1, rows).permute(1, 0, 2), k, 1,
                      w).permute(1, 0, 2)
    w_center, w_other = _weights(fd_block, k)
    out = w_center[..., None] * img_block + w_other[..., None] * (
        box - img_block)
    mask = _interior_mask(global_h, w, img_block.device)[y0:y0 + rows]
    return out * mask[..., None]


def _rows(mesh, cfg: RenderConfig) -> int:
    """Rows a data block: H / |data|, which must divide."""
    nd = axis_size(mesh, DATA_AXIS)
    if cfg.height % nd != 0:
        raise ValueError(f"height {cfg.height} not divisible by {nd}")
    return cfg.height // nd


def make_sharded_render(mesh, cfg: RenderConfig) -> Callable:
    """The sharded hard render: a callable (scene, camera, lights) -> this
    rank's row block (rows, W, 3), with the full clean feature set (AA,
    soft shadows, several lights, DoF through the halo exchange)."""
    rows = _rows(mesh, cfg)

    def frame(scene: Scene, camera: Camera, lights: Lights) -> torch.Tensor:
        y0 = axis_index(mesh, DATA_AXIS) * rows
        color, fd = render_block(scene, camera, lights, cfg, y0, rows, mesh)
        img = color.reshape(rows, cfg.width, 3)
        return dof_block(img, fd.reshape(rows, cfg.width), cfg, cfg.height,
                         y0, mesh)

    return frame


def gather_image(block: torch.Tensor, mesh) -> torch.Tensor:
    """The full (H, W, ...) image on every rank from the ranks' row blocks
    (rows, W, ...), differentiable: each block's cotangent is the sum of
    every rank's cotangent for it."""
    stack = all_gather_grad(block, axis_group(mesh, DATA_AXIS))
    return stack.reshape(-1, *block.shape[1:])


# ---------------------------------------------------------------------------
# The hard rasterizer


def merged_winner(scene: Scene, camera: Camera, cfg: RenderConfig, screen,
                  xs, ys, y0: int, rows: int, mesh) -> torch.Tensor:
    """The winning triangle (global index, -1 for background) of each
    pixel (xs, ys) of rows [y0, y0 + rows) against the FULL scene, from its
    screen vertices ``screen`` = (sx, sy, zinv) (T, 3) each: each rank's
    winner over its triangle block (K8b, or K8a above 128 triangles), then
    the max-zinv merge over 'model', strict ``>`` so that the earlier block
    keeps ties (the reference's first-triangle-wins z-test,
    `rasteriser.cpp:606`). Backface culling holds; frustum culling stays
    parity-only, as in rasterize_exact. Returns (rows * W,) int32."""
    base, tb = _block_range(scene.num_triangles, mesh)
    with torch.no_grad():
        sx, sy, zinv = (a.detach() for a in screen)
        keep = cull_mask(scene, camera, cfg.replace(frustum_cull=False))
        consts = raster_tri_constants(*(a[base:base + tb]
                                        for a in (sx, sy, zinv, keep)))
        win = resolve_winner(consts, rows, cfg.width, y0=y0)
        plane = consts[win.clamp_min(0).long()]
        z = plane[:, 9] * xs + plane[:, 10] * ys + plane[:, 11]
        z = torch.where(win >= 0, z, 0.0)
        group = axis_group(mesh, MODEL_AXIS)
        zs = all_gather(z, group)
        idxs = all_gather(torch.where(win >= 0, win + base, -1), group)
        best_z, best_idx = zs[0], idxs[0]
        for m in range(1, zs.shape[0]):
            upd = zs[m] > best_z  # strictly: the earlier block keeps ties
            best_z = torch.where(upd, zs[m], best_z)
            best_idx = torch.where(upd, idxs[m], best_idx)
        return torch.where(best_z > 0.0, best_idx, -1)


def raster_block(scene: Scene, camera: Camera, lights: Lights,
                 cfg: RenderConfig, y0: int, rows: int,
                 mesh) -> torch.Tensor:
    """Clean-rasterize rows [y0, y0 + rows) on the mesh: the merged winner,
    then its attributes recomputed and shaded on the replicated scene
    (``_shade_winner``), differentiable through the recompute. Returns
    (rows * W, 3)."""
    xs, ys = pixel_grid(rows, cfg.width, scene.device, y0)
    sx, sy, zinv, pos3d = _screen_vertices(scene, camera, cfg)
    winner = merged_winner(scene, camera, cfg, (sx, sy, zinv), xs, ys, y0,
                           rows, mesh)
    return _shade_winner(winner, xs, ys, sx, sy, zinv, pos3d, scene, camera,
                         lights, cfg)


def make_sharded_rasterize(mesh, cfg: RenderConfig) -> Callable:
    """The sharded clean rasterizer: a callable (scene, camera, lights) ->
    this rank's row block (rows, W, 3)."""
    rows = _rows(mesh, cfg)

    def frame(scene: Scene, camera: Camera, lights: Lights) -> torch.Tensor:
        y0 = axis_index(mesh, DATA_AXIS) * rows
        return raster_block(scene, camera, lights, cfg, y0, rows,
                            mesh).reshape(rows, cfg.width, 3)

    return frame


# ---------------------------------------------------------------------------
# The soft renderers


def _soft_combine(vals, m, s, bg_logit: float, mesh) -> torch.Tensor:
    """Combine the per-rank online-softmax partials over 'model' into
    globally normalized values. Each rank aggregated its own triangle
    block plus the shared background hypothesis (value 0, logit bg_logit)
    into (vals = acc / s, m, s), so its mass is s exp(m) and the combined
    denominator counts the background |model| times: the duplicates are
    taken off. The global max M is a constant (any shift gives the same
    value and gradient; the stats Functions' s cotangent carries the logit
    dependence). vals (K, R); m, s (R,). Returns (K, R) float32.

    The combine runs in float64 (ROADMAP fault F17): in float32 its
    roundings, with the subtraction of the duplicates, moved the gradient
    of ``active`` (through log(valid)) away from the single-process one as
    |model| grew. On one model rank it gives vals back bit for bit."""
    group = axis_group(mesh, MODEL_AXIS)
    nm = axis_size(mesh, MODEL_AXIS)
    M = all_gather(m, group).amax(dim=0).double()
    w = s.double() * torch.exp(m.double() - M)
    num = psum(vals.double() * w, group)
    den = psum(w, group) - float(nm - 1) * torch.exp(bg_logit - M)
    return (num / den).float()


def _shard_pad_rows(table, mesh) -> tuple[torch.Tensor, int]:
    """This rank's contiguous row block of a replicated (T, cols) soft
    table, zero-padded up to a whole number of chunks (zero rows are
    inactive), and the chunk (``soft_chunk`` of the block)."""
    base, tb = _block_range(table.shape[0], mesh)
    chunk = soft_chunk(tb)
    return srt.pad_rows(table[base:base + tb], chunk).contiguous(), chunk


def soft_raster_block(scene: Scene, camera: Camera, lights: Lights,
                      cfg: RenderConfig, y0: int, rows: int,
                      mesh) -> torch.Tensor:
    """Soft-rasterize rows [y0, y0 + rows) on the mesh: each rank
    aggregates its triangle block (K9a through SoftAggStats, unmasked) and
    the softmax merges over 'model' (_soft_combine); shading as in
    rasterize_soft. Returns (rows * W, 3), differentiable in every leaf."""
    sx, sy, zinv, pos3d = _screen_vertices(scene, camera, cfg)
    consts_full = soft_tri_constants(sx, sy, zinv, pos3d, scene.color,
                                     scene.normals(), scene.active)
    consts, chunk = _shard_pad_rows(consts_full, mesh)
    agg, m, s = SoftAggStats.apply(
        consts, rows, cfg.width, chunk, None,
        float(cfg.soft_edge_sharpness), float(cfg.soft_z_sharpness), y0)
    # Background logit 0 (`rasteriser.cpp:188`, the cleared depth buffer).
    out = _soft_combine(agg, m, s, 0.0, mesh).T
    return shade_agg_raster(out[:, 0:3], out[:, 3:6], out[:, 6],
                            out[:, 7:10], camera, lights,
                            float(np.float32(cfg.ambient)))


def soft_raytrace_block(scene: Scene, camera: Camera, lights: Lights,
                        cfg: RenderConfig, y0: int, rows: int,
                        mesh) -> torch.Tensor:
    """Soft-raytrace rows [y0, y0 + rows) on the mesh: the primary
    softmax partials (K10a through PrimaryAggStats) merge by _soft_combine;
    the shadow transmittance exp(-16 od) of each rank's block (K10g)
    merges by a product over 'model' (the optical depth adds over
    triangles). Returns (rows * W, 3), differentiable in every leaf."""
    es, zs = float(cfg.soft_edge_sharpness), float(cfg.soft_z_sharpness)
    xs, ys = pixel_grid(rows, cfg.width, scene.device, y0)
    dirs = camera_ray_dirs(xs, ys, camera, cfg).T.contiguous()  # (3, R)
    pri, chunk = _shard_pad_rows(srt.primary_tri_constants(scene,
                                                           camera.pos), mesh)
    shw, _ = _shard_pad_rows(srt.shadow_tri_constants(scene), mesh)
    out, m, s = srt.PrimaryAggStats.apply(pri, camera.pos, dirs, es, zs,
                                          chunk)
    # Background logit 0 (the bounded-background relaxation).
    comb = _soft_combine(out, m, s, 0.0, mesh)
    samples = max(cfg.soft_shadow_samples, 1)
    srcs = source_positions(lights, samples).contiguous()
    trans_local = srt.ShadowTrans.apply(shw, srcs, comb[3:6].contiguous(),
                                        es, zs, chunk)
    trans = all_gather_grad(trans_local, axis_group(mesh, MODEL_AXIS))
    prod = trans[0]
    for k in range(1, trans.shape[0]):
        prod = prod * trans[k]
    per_light = prod.reshape(lights.capacity, samples, -1).mean(dim=1)
    denom = torch.maximum(lights.mask.sum(), lights.mask.new_ones(()))
    shadow = (lights.mask[:, None] * per_light).sum(dim=0) / denom
    return shade_agg_raytrace(comb[0:3].T, comb[3:6].T, comb[6:9].T, lights,
                              float(np.float32(cfg.ambient)), shadow)


def make_sharded_soft_render(mesh, cfg: RenderConfig,
                             renderer: str = "rasterize") -> Callable:
    """The sharded soft (differentiable) render: a callable (scene, camera,
    lights) -> this rank's row block (rows, W, 3); renderer 'rasterize' or
    'raytrace'."""
    rows = _rows(mesh, cfg)
    block_fn = _soft_block_fn(renderer)

    def frame(scene: Scene, camera: Camera, lights: Lights) -> torch.Tensor:
        y0 = axis_index(mesh, DATA_AXIS) * rows
        return block_fn(scene, camera, lights, cfg, y0, rows,
                        mesh).reshape(rows, cfg.width, 3)

    return frame


def _soft_block_fn(renderer: str) -> Callable:
    if renderer == "rasterize":
        return soft_raster_block
    if renderer == "raytrace":
        return soft_raytrace_block
    raise ValueError(f"unknown renderer {renderer!r}")


# ---------------------------------------------------------------------------
# Training


class TrainState(NamedTuple):
    """Replicated parameters and their optimizer: every float leaf of scene
    and lights a tensor that takes gradients (``train_state``), updated in
    place by ``optimizer``."""

    scene: Scene
    lights: Lights
    optimizer: torch.optim.Optimizer


def leaves(scene: Scene, lights: Lights) -> list[torch.Tensor]:
    """The leaves of scene and lights in the JAX package's pytree order."""
    return ([getattr(scene, f.name) for f in dataclasses.fields(Scene)]
            + [getattr(lights, f.name) for f in dataclasses.fields(Lights)])


def train_state(scene: Scene, lights: Lights,
                make_optimizer: Callable) -> TrainState:
    """A TrainState of fresh leaf copies of scene and lights that take
    gradients, with make_optimizer(leaves) over them (any torch.optim
    optimizer; the same on every rank)."""
    def fresh(value):
        return type(value)(**{f.name: getattr(value, f.name).detach().clone()
                              .requires_grad_(True)
                              for f in dataclasses.fields(value)})
    scene, lights = fresh(scene), fresh(lights)
    return TrainState(scene, lights, make_optimizer(leaves(scene, lights)))


def reduce_grads(params) -> None:
    """Sum every parameter's ``.grad`` over the whole world in rank order
    (a parameter the loss did not reach counts 0), so every rank holds the
    same bits."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    total = sum_in_order(all_gather(flat, dist.group.WORLD))
    for p, g in zip(params, total.split([p.numel() for p in params])):
        p.grad = g.reshape(p.shape).clone()


def make_sharded_train_step(mesh, cfg: RenderConfig,
                            renderer: str = "raytrace"):
    """The sharded inverse-rendering step: the mean squared error of the
    render to a target whose row block each rank holds. cfg.mode 'soft'
    trains through the sharded soft renderer ``renderer``; other modes
    through the hard clean path (DoF with the halo exchange). Returns
    (train_step, loss_fn):

      loss_fn(scene, lights, camera, target_block) -> (loss, share): the
        loss (no graph, the same bits on every rank) and this rank's share
        to differentiate; ``share.backward()`` on every rank, then
        ``reduce_grads``, gives every rank the loss's gradient.
      train_step(state, camera, target_block) -> loss: one optimizer step
        of a TrainState (its leaves keep the step's reduced gradients).
    """
    rows = _rows(mesh, cfg)
    denom = float(cfg.height * cfg.width * 3)
    nm = axis_size(mesh, MODEL_AXIS)
    soft_fn = _soft_block_fn(renderer) if cfg.mode == "soft" else None

    def loss_fn(scene, lights, camera, target_block):
        y0 = axis_index(mesh, DATA_AXIS) * rows
        if soft_fn is not None:
            color = soft_fn(scene, camera, lights, cfg, y0, rows, mesh)
            img = color.reshape(rows, cfg.width, 3)
        else:
            color, fd = render_block(scene, camera, lights, cfg, y0, rows,
                                     mesh)
            img = color.reshape(rows, cfg.width, 3)
            if cfg.dof_enabled:
                img = dof_block(img, fd.reshape(rows, cfg.width), cfg,
                                cfg.height, y0, mesh)
        local = torch.sum((img - target_block) ** 2)
        loss = sum_in_order(all_gather(local, axis_group(mesh, DATA_AXIS)))
        return loss / denom, local / (denom * nm)

    def train_step(state: TrainState, camera: Camera,
                   target_block) -> torch.Tensor:
        params = leaves(state.scene, state.lights)
        for p in params:
            p.grad = None
        loss, share = loss_fn(state.scene, state.lights, camera,
                              target_block)
        share.backward()
        reduce_grads(params)
        state.optimizer.step()
        return loss

    return train_step, loss_fn
