"""Public raytrace API (counterpart of raytpu/render/raytrace.py).

This slice of the port renders and differentiates the configuration of
the JAX package's megakernel branch: one active light, hard shadows, one
sub-ray per pixel, at most 128 triangles, mode 'parity' or 'clean'. The
whole per-ray forward runs in the fused kernel and its backward in the two
backward kernels (raytpu_torch.kernels.render_fused); the DoF stage
follows as plain torch. A loss on the image or the focal distances
differentiates, through ``dof_apply``, the packed tables and parameters,
``tri_constants`` and ``Scene.normals()``, to every leaf of the scene
(``active`` excepted, as in the JAX package), to the light, and through
``camera_ray_dirs`` to the camera. Any other configuration raises
NotImplementedError naming the ROADMAP.md item that brings it, whatever
the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raytpu_torch.core.types import Camera, Lights, RenderConfig, Scene
from raytpu_torch.kernels import render_fused
from raytpu_torch.kernels.tables import MAX_CHUNK
from raytpu_torch.ops.blur import dof_apply
from raytpu_torch.ops.intersect import tri_constants


class RenderOut(NamedTuple):
    image: torch.Tensor            # (H, W, 3) float32
    focal_distances: torch.Tensor  # (H, W) float32 (distance - dof_focus)


def pixel_grid(cfg: RenderConfig, device):
    """Integer pixel coordinates as float32 (H*W,) grids, row-major."""
    ys, xs = torch.meshgrid(
        torch.arange(cfg.height, dtype=torch.float32, device=device),
        torch.arange(cfg.width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return xs.reshape(-1), ys.reshape(-1)


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
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.matmul(d, camera.rotation().T)


def _check_scope(scene: Scene, lights: Lights, cfg: RenderConfig):
    """Raise for a configuration this slice of the port does not render."""
    gaps = []
    if cfg.mode not in ("clean", "parity"):
        gaps.append(f"mode {cfg.mode!r}: port item 6 (soft renderers)")
    if not cfg.megakernel:
        gaps.append("megakernel=False: port item 3 (loop branch)")
    if cfg.aa_samples > 1:
        gaps.append(f"aa_samples={cfg.aa_samples}: port item 3 (loop branch)")
    if cfg.soft_shadow_samples > 1:
        gaps.append(f"soft_shadow_samples={cfg.soft_shadow_samples}: "
                    "port item 3 (loop branch)")
    if lights.capacity > 1:
        gaps.append(f"{lights.capacity} active lights: port item 3 "
                    "(loop branch)")
    if scene.num_triangles > MAX_CHUNK:
        gaps.append(f"{scene.num_triangles} triangles: port item 4 "
                    "(STL scale)")
    if gaps:
        raise NotImplementedError(
            "not ported yet (see ROADMAP.md): " + "; ".join(gaps))


def fused_inputs(scene: Scene, camera: Camera, lights: Lights,
                 cfg: RenderConfig) -> tuple:
    """The positional arguments of render_fused.render_hard_fused for a
    frame: ray directions, both constant sets, normals, albedo and the
    single light's parameters (``lights`` compacted to one slot)."""
    xs, ys = pixel_grid(cfg, scene.device)
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
    _check_scope(scene, lights, cfg)
    out = render_fused.render_hard_fused(
        *fused_inputs(scene, camera, lights, cfg), tri_chunk=cfg.tri_chunk,
        ambient=cfg.ambient, parity=cfg.mode == "parity")
    img = out.color.reshape(cfg.height, cfg.width, 3)
    fd = out.fd.reshape(cfg.height, cfg.width)
    return RenderOut(image=dof_apply(img, fd, cfg), focal_distances=fd)


def raytrace(scene: Scene, camera: Camera, lights: Lights,
             cfg: RenderConfig) -> torch.Tensor:
    """Render and return the (H, W, 3) float32 image."""
    return raytrace_full(scene, camera, lights, cfg).image
