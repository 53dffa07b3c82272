"""What both labs share: the device flag, the card line, the Cornell box
inputs at 512^2 clean and the mismatch counts."""

from __future__ import annotations

import subprocess
import sys

import torch

from raytpu_torch.core.cornell import cornell_box
from raytpu_torch.core.types import Camera, RenderConfig
from raytpu_torch.kernels.tables import pack_params, pack_tables, tight_chunk
from raytpu_torch.render.raytrace import fused_inputs


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def device_from(name: str) -> torch.device:
    """The --device flag's device; a CUDA device must exist (no fallback
    to the CPU)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("lab: --device cuda but no CUDA device is available "
                         "(pass --device cpu to run the plain versions)")
    return device


def card_line(device: torch.device) -> str | None:
    """nvidia-smi's name and power limit of the card, None on the CPU."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def lab_inputs(lights, size: int, device, mode: str = "clean",
               pad_to: int | None = 32) -> dict:
    """The labs' frame: the Cornell box padded to ``pad_to``, the
    raytracer's default camera, ``lights``, size^2 in ``mode`` (the labs:
    clean, padded to 32). Returns the JAX functions' arguments (dirs_t
    (3, R) contiguous, the constants, normals, albedo), the port's params
    vector and table, and the scene, camera and config."""
    scene = cornell_box(pad_to=pad_to, device=device)
    camera = Camera.raytracer_default(device=device)
    cfg = RenderConfig(width=size, height=size, mode=mode)
    (dirs, m, k0, valid, m_l, k0_l, nrm, alb, cam_pos, light_pos, p_eff,
     dof) = fused_inputs(scene, camera, lights, cfg)
    C = tight_chunk(scene.num_triangles, cfg.tri_chunk)
    return dict(
        dirs=dirs, dirs_t=dirs.T.contiguous(),
        consts=(m, k0, valid, m_l, k0_l, nrm, alb),
        par=pack_params(cam_pos, light_pos, p_eff, dof),
        table=pack_tables(m, k0, valid, m_l, k0_l, nrm, alb, C), C=C,
        scene=scene, camera=camera, lights=lights, cfg=cfg,
        cam_pos=cam_pos, light_pos=light_pos)


def mismatches(got, want, names=("color", "fd", "idx", "occ")) -> dict:
    """Entries of each output that differ (values: -0.0 equals 0.0)."""
    return {name: int((g != w).sum()) for name, g, w in zip(names, got, want)}
