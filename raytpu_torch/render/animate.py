"""Frame-sequence loop (counterpart of raytpu/render/animate.py).

The reference is an interactive app whose Update() moves the camera and the
light each frame; here a SCRIPT of per-frame key tokens replays the same
state transitions:

  raytracer  (`raytracer/Source/raytracer.cpp:346-423`)
    up/down    cameraPos += / -= 0.1 * forward
    left/right yaw += / -= 0.1
    w/s        lights[0] += / -= 0.1 * forward  (the jitter bank moves too)
    a/d        lights[0] -= / += 0.1 * right

  rasteriser (`rasteriser/Source/rasteriser.cpp:330-373`, dt-scaled)
    up/down    cameraPos += / -= 0.05 * forward * (dt / 20)
    left/right yaw += / -= 0.01 * (dt / 20)
    w/s        light.z += / -= 0.05 * (dt / 20)   (world axes, unrotated)
    a/d        light.x -= / += 0.05 * (dt / 20)

``forward``/``right`` are the camera rotation's third/first columns. Each
frame is one render request: the state update runs on the host, the render
on the scene's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable

import numpy as np
import torch

from raytpu_torch.core.types import Camera, Lights, RenderConfig, Scene, f32
from raytpu_torch.render.rasterize import rasterize
from raytpu_torch.render.raytrace import raytrace

KEYS = ("none", "up", "down", "left", "right", "w", "s", "a", "d")


def expand_script(script: str) -> list[str]:
    """'left*3,up,w*2' -> ['left','left','left','up','w','w']."""
    out = []
    for token in script.split(","):
        token = token.strip()
        if not token:
            continue
        if "*" in token:
            key, _, count = token.partition("*")
            out.extend([key.strip()] * int(count))
        else:
            out.append(token)
    for k in out:
        if k not in KEYS:
            raise ValueError(f"unknown key {k!r}; valid: {KEYS}")
    return out


def apply_key_raytracer(camera: Camera, lights: Lights, key: str):
    """One Update() state transition, raytracer semantics (fixed 0.1 steps;
    light motion shifts the jitter bank too). Host-side float32 numpy
    arithmetic, as in the JAX package."""
    rot = camera.rotation().cpu().numpy()
    right, forward = rot[:, 0], rot[:, 2]
    pos = camera.pos.cpu().numpy()
    yaw = float(camera.yaw)
    dlight = None
    if key == "up":
        pos = pos + 0.1 * forward
    elif key == "down":
        pos = pos - 0.1 * forward
    elif key == "left":
        yaw += 0.1
    elif key == "right":
        yaw -= 0.1
    elif key == "w":
        dlight = 0.1 * forward
    elif key == "s":
        dlight = -0.1 * forward
    elif key == "a":
        dlight = -0.1 * right
    elif key == "d":
        dlight = 0.1 * right
    dev = camera.device
    camera = dataclasses.replace(camera, pos=f32(pos, dev), yaw=f32(yaw, dev))
    if dlight is not None:
        d = f32(dlight, lights.device)
        position = lights.position.clone()
        position[0] += d
        jitter = lights.jitter.clone()
        jitter[0] += d[None, :]
        lights = dataclasses.replace(lights, position=position, jitter=jitter)
    return camera, lights


def apply_key_rasterizer(camera: Camera, lights: Lights, key: str,
                         dt_ms: float = 20.0):
    """One Update() state transition, rasteriser semantics: dt-scaled
    steps, the light moving on WORLD x/z (`rasteriser.cpp:353-373`), its
    jitter bank unchanged. Host-side float32 numpy arithmetic, as in the
    JAX package."""
    forward = camera.rotation().cpu().numpy()[:, 2]
    scale = dt_ms / 20.0
    pos = camera.pos.cpu().numpy()
    yaw = float(camera.yaw)
    dl = np.zeros(3, np.float32)
    if key == "up":
        pos = pos + 0.05 * forward * scale
    elif key == "down":
        pos = pos - 0.05 * forward * scale
    elif key == "left":
        yaw += 0.01 * scale
    elif key == "right":
        yaw -= 0.01 * scale
    elif key == "w":
        dl[2] = 0.05 * scale
    elif key == "s":
        dl[2] = -0.05 * scale
    elif key == "a":
        dl[0] = -0.05 * scale
    elif key == "d":
        dl[0] = 0.05 * scale
    dev = camera.device
    camera = dataclasses.replace(camera, pos=f32(pos, dev), yaw=f32(yaw, dev))
    if np.any(dl):
        position = lights.position.clone()
        position[0] += f32(dl, lights.device)
        lights = dataclasses.replace(lights, position=position)
    return camera, lights


@dataclasses.dataclass
class AnimateResult:
    n_frames: int
    ms_per_frame: float  # host clock, up to the last frame's completion
    frames: list         # (H, W, 3) float32 tensors, one per key


def animate(scene: Scene, camera: Camera, lights: Lights, cfg: RenderConfig,
            keys: Iterable[str], renderer: str = "raytrace",
            dt_ms: float = 20.0) -> AnimateResult:
    """Render one frame per key token with ``renderer`` ("raytrace" or
    "rasterize"), applying the motion BEFORE each frame (Update then Draw,
    `raytracer.cpp:165-172`); ``dt_ms`` is the rasteriser's virtual frame
    time. Frames stay on the scene's device."""
    if renderer == "raytrace":
        render, step = raytrace, apply_key_raytracer
    elif renderer == "rasterize":
        render = rasterize

        def step(cam, li, k):
            return apply_key_rasterizer(cam, li, k, dt_ms=dt_ms)
    else:
        raise ValueError(f"unknown renderer {renderer!r}")
    keys = list(keys)
    if not keys:
        raise ValueError("animate() needs at least one key event")
    frames = []
    t0 = time.perf_counter()
    for key in keys:
        camera, lights = step(camera, lights, key)
        frames.append(render(scene, camera, lights, cfg))
    if frames[-1].is_cuda:
        torch.cuda.synchronize(frames[-1].device)
    wall = time.perf_counter() - t0
    return AnimateResult(n_frames=len(keys),
                         ms_per_frame=wall / len(keys) * 1e3, frames=frames)
