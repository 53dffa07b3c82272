"""Public raytrace API (counterpart of raytpu/render/raytrace.py).

``raytrace_full`` renders and differentiates every hard-visibility
configuration of the JAX package ('parity' and 'clean', scenes of any
triangle count) through one of two branches:

  * the megakernel branch (one active light, hard shadows, one sub-ray,
    ``cfg.megakernel``, at most 128 triangles): the whole per-ray forward
    in the fused kernel and its backward in the two backward kernels
    (raytpu_torch.kernels.render_fused);
  * the loop branch (AA, soft shadows, several lights,
    ``megakernel=False``, or more than 128 triangles): per sub-ray, the
    primary hit and the shadow occlusion in one launch of an intersection
    kernel (raytpu_torch.kernels.intersect: K4 for one light with hard
    shadows, K6 for several shadow sources, K7a with its chunk keep-mask
    for a scene of more than 128 triangles, one light included), the
    running AA record with the parity quirk, the gather of normals and
    albedo (a one-hot product up to 1,024 triangles, indexing above), and
    the vectorised shading of ops/shade.py.

The DoF stage follows as plain torch. A loss on the image or the focal
distances differentiates to every leaf of the scene (``active`` excepted,
as in the JAX package), of the lights (the jittered soft-shadow positions
through the shading) and, through ``camera_ray_dirs``, of the camera.
``raytrace`` renders mode 'soft'
through the soft raytracer (render/soft.py::raytrace_soft, the soft
raytrace kernels K10a/K10c/K10g/K10i) on the compacted light bank.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytpu_torch.core.types import (
    Camera,
    Lights,
    RenderConfig,
    Scene,
    matmul_f32,
    pixel_grid,
)
from raytpu_torch.kernels import render_fused
from raytpu_torch.kernels.intersect import (
    ONE_HOT_MAX,
    intersect_occluded,
    intersect_occluded_multi,
)
from raytpu_torch.kernels.tables import MAX_CHUNK
from raytpu_torch.ops.blur import dof_apply
from raytpu_torch.ops.intersect import (
    F32MAX,
    gather_rows,
    gather_rows_by_index,
    hit_distances,
    hit_positions,
    one_hot_idx,
    tri_constants,
)
from raytpu_torch.ops.shade import composite, direct_light, source_positions


class RenderOut(NamedTuple):
    image: torch.Tensor            # (H, W, 3) float32
    focal_distances: torch.Tensor  # (H, W) float32 (distance - dof_focus)


def camera_ray_dirs(xs: torch.Tensor, ys: torch.Tensor, camera: Camera,
                    cfg: RenderConfig) -> torch.Tensor:
    """Pinhole ray directions ``cameraRot * (x - W/2, y - H/2, f)``
    (`raytracer.cpp:579-580`), (R, 3), unnormalized."""
    d = torch.stack(
        [xs - cfg.width / 2.0, ys - cfg.height / 2.0,
         camera.focal.expand(xs.shape)],
        dim=-1,
    )
    # Full float32: TF32 would move the directions by ~1e-3 relative.
    return matmul_f32(d, camera.rotation().T)


def _subpixel_offsets(cfg: RenderConfig) -> list[tuple[float, float]]:
    """AA sub-ray offsets (dx, dy): from -0.5 in steps of 1/(N-1)
    (`raytracer.cpp:564-576,593,596`), x fastest."""
    n = cfg.aa_samples
    if n <= 1:
        return [(0.0, 0.0)]
    step = 1.0 / (n - 1)
    return [(-0.5 + z2 * step, -0.5 + z * step)
            for z in range(n) for z2 in range(n)]


def _check_scope(lights: Lights, cfg: RenderConfig):
    """Raise for more soft-shadow samples than the light bank holds
    (ROADMAP fault F7: the JAX package silently repeats the bank's last
    jittered position)."""
    if cfg.soft_shadow_samples > lights.num_soft_samples:
        raise ValueError(
            f"soft_shadow_samples={cfg.soft_shadow_samples} but the light "
            f"bank holds {lights.num_soft_samples} jittered positions a "
            "light (Lights(soft_samples=...))")


def fused_inputs(scene: Scene, camera: Camera, lights: Lights,
                 cfg: RenderConfig) -> tuple:
    """The positional arguments of render_fused.render_hard_fused for a
    frame: ray directions, both constant sets, normals, albedo and the
    single light's parameters (``lights`` compacted to one slot)."""
    xs, ys = pixel_grid(cfg.height, cfg.width, scene.device)
    consts = tri_constants(scene, camera.pos)
    consts_light = tri_constants(scene, lights.position[0])
    p_eff = lights.mask[0] * (lights.color[0] * lights.intensity[0])
    return (camera_ray_dirs(xs, ys, camera, cfg),
            consts.m, consts.k0, consts.valid,
            consts_light.m, consts_light.k0,
            scene.normals(), scene.color,
            camera.pos, lights.position[0], p_eff, camera.dof_focus)


def raytrace_full(scene: Scene, camera: Camera, lights: Lights,
                  cfg: RenderConfig) -> RenderOut:
    """Render a full frame; returns the image and the DoF focal distances.

    Compacts the light bank on the host first, so a capacity-32 bank with
    one active light renders as a capacity-1 bank.
    """
    lights = lights.compact()
    _check_scope(lights, cfg)
    if (cfg.megakernel and lights.capacity == 1
            and cfg.soft_shadow_samples == 1 and cfg.aa_samples <= 1
            and scene.num_triangles <= MAX_CHUNK):
        out = render_fused.render_hard_fused(
            *fused_inputs(scene, camera, lights, cfg),
            tri_chunk=cfg.tri_chunk, ambient=cfg.ambient,
            parity=cfg.mode == "parity", image_hw=(cfg.height, cfg.width))
        img = out.color.reshape(cfg.height, cfg.width, 3)
        fd = out.fd.reshape(cfg.height, cfg.width)
        return RenderOut(image=dof_apply(img, fd, cfg), focal_distances=fd)
    return _loop_branch(scene, camera, lights, cfg)


def _loop_branch(scene: Scene, camera: Camera, lights: Lights,
                 cfg: RenderConfig) -> RenderOut:
    """The loop branch of the JAX package's ``_raytrace_full``
    (`render/raytrace.py:152-274`), one intersection launch a sub-ray."""
    xs, ys = pixel_grid(cfg.height, cfg.width, scene.device)
    consts = tri_constants(scene, camera.pos)
    offsets = _subpixel_offsets(cfg)
    parity_record = cfg.mode == "parity" and len(offsets) > 1
    # One light with hard shadows takes K4; anything else K6, with the
    # sources light-major and sample-minor, as direct_light reads them. A
    # scene of several chunks takes K7a with its keep-mask, one light
    # (S = 1) included (`render/raytrace.py:152-162`).
    T = scene.num_triangles
    big_scene = T > MAX_CHUNK
    single = (lights.capacity == 1 and cfg.soft_shadow_samples == 1
              and not big_scene)
    src_pos = source_positions(lights, cfg.soft_shadow_samples)
    consts_src = tri_constants(scene, src_pos[0] if single else src_pos)
    geom = (scene.v0, scene.v1, scene.v2) if big_scene else None
    normals_albedo = torch.cat([scene.normals(), scene.color], dim=1)

    R = xs.shape[0]
    accum = None
    # The closest Euclidean distance per pixel over the sub-rays (the
    # reference's persistent intersection record, `raytracer.cpp:580`),
    # which feeds DoF, and the record's hit, triangle and occlusion bits.
    rec_dist = torch.full((R,), F32MAX, device=xs.device)
    rec_idx = torch.zeros((R,), dtype=torch.int32, device=xs.device)
    rec_pos = torch.zeros((R, 3), device=xs.device)
    rec_occ = torch.zeros((src_pos.shape[0], R), dtype=torch.bool,
                          device=xs.device)

    for dx, dy in offsets:
        dirs = camera_ray_dirs(xs + dx, ys + dy, camera, cfg)
        if single:
            hits, occ = intersect_occluded(
                dirs, consts, consts_src, camera.pos, src_pos[0],
                tri_chunk=cfg.tri_chunk, image_hw=(cfg.height, cfg.width))
            occ = occ[None, :]
        else:
            hits, occ = intersect_occluded_multi(
                dirs, consts, consts_src, camera.pos, src_pos,
                tri_chunk=cfg.tri_chunk, scene_geom=geom,
                image_hw=(cfg.height, cfg.width))
        dist = hit_distances(dirs, hits)

        # Merge into the running record (`>=` update semantics, `:243`).
        upd = hits.hit & (dist <= rec_dist)
        rec_dist = torch.where(upd, dist, rec_dist)
        rec_idx = torch.where(upd, hits.idx, rec_idx)
        rec_pos = torch.where(upd[:, None],
                              hit_positions(camera.pos, dirs, hits), rec_pos)
        if parity_record:
            # Parity quirk: each sub-ray shades the RECORD's hit, which may
            # be a stale closer hit of an earlier sub-ray. Occlusion is a
            # function of the record position alone, so the bits of the
            # sub-ray that set the record are the record's.
            rec_occ = torch.where(upd[None, :], occ, rec_occ)
            pos, shade_idx, occ = rec_pos, rec_idx, rec_occ
        else:
            pos = hit_positions(camera.pos, dirs, hits)
            shade_idx = hits.idx.clamp_min(0)

        # Normals and albedo of the shaded triangle: one one-hot product up
        # to ONE_HOT_MAX triangles, indexing above (the same values).
        if T <= ONE_HOT_MAX:
            both = gather_rows(one_hot_idx(shade_idx, T), normals_albedo)
        else:
            both = gather_rows_by_index(normals_albedo, shade_idx)
        direct = direct_light(pos, shade_idx, scene, lights, cfg,
                              n_dir=both[:, :3], occlusion_rows=occ)
        # The reference adds a sample only where the sub-ray itself hit
        # (`raytracer.cpp:580-591`).
        color = composite(direct, both[:, 3:], hits.hit, cfg)
        accum = color if accum is None else accum + color

    img = (accum / float(len(offsets))).reshape(cfg.height, cfg.width, 3)
    fd = torch.where(rec_dist < F32MAX, rec_dist - camera.dof_focus,
                     0.0).reshape(cfg.height, cfg.width)
    return RenderOut(image=dof_apply(img, fd, cfg), focal_distances=fd)


def raytrace(scene: Scene, camera: Camera, lights: Lights,
             cfg: RenderConfig) -> torch.Tensor:
    """Render and return the (H, W, 3) float32 image; mode 'soft' through
    raytrace_soft on the compacted bank, as the JAX package's raytrace."""
    if cfg.mode == "soft":
        from raytpu_torch.render.soft import raytrace_soft

        return raytrace_soft(scene, camera, lights.compact(), cfg)
    return raytrace_full(scene, camera, lights, cfg).image
