"""Core value types of the PyTorch port (counterpart of raytpu/core/types.py).

  * :class:`Scene`   — struct-of-arrays triangle soup.
  * :class:`Camera`  — pinhole camera.
  * :class:`Lights`  — padded point-light bank with an active mask.
  * :class:`RenderConfig` — hashable render settings.

Scene, Camera and Lights are frozen dataclasses of float32 tensors that live
on one device. The device picks the route through the kernels: tensors on a
CUDA device launch the hand-written kernels, tensors on the CPU run their
plain PyTorch versions. There is no other switch.

Arithmetic is written op by op in the JAX package's order (no fused
multiply-adds, no library cross products) so that the CPU path, the CUDA
path and the CUDA kernels round alike.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Literal

import numpy as np
import torch

Mode = Literal["parity", "clean", "soft"]


def f32(x, device) -> torch.Tensor:
    """``x`` as a float32 tensor on ``device`` (copies host data once)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, in ``jnp.cross``'s op order."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over a last axis of 3, summed left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def matmul3(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``a @ m`` for a (..., 3) and m (3, 3), each output summed left to
    right in float32: the same bits on every device (a library matmul may
    fuse or reorder its products)."""
    return (a[..., 0:1] * m[0] + a[..., 1:2] * m[1]) + a[..., 2:3] * m[2]


@contextlib.contextmanager
def full_float32():
    """Library matmuls in full float32 inside the block: TF32 (10 mantissa
    bits) off, and the caller's setting restored on the way out."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


class _MatMulF32(torch.autograd.Function):
    """``torch.matmul`` under full_float32, its backward too: the backward
    runs after the forward's block has restored the caller's flag, so it
    redoes the product under its own and takes autograd's gradients of it
    (the same library calls on the same layouts as a plain matmul's)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        with full_float32():
            return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        want = [t.detach().requires_grad_(need)
                for t, need in zip((a, b), ctx.needs_input_grad)]
        with torch.enable_grad(), full_float32():
            out = torch.matmul(*want)
            got = iter(torch.autograd.grad(
                out, [t for t in want if t.requires_grad], g))
        return tuple(next(got) if t.requires_grad else None for t in want)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32, forward and backward, whatever the
    caller's TF32 setting, which it leaves as it found it."""
    return _MatMulF32.apply(a, b)


def pixel_grid(height: int, width: int, device, y0: int = 0):
    """Integer pixel coordinates (x, y) as float32 (H*W,) grids,
    row-major, of rows [y0, y0 + height) of a frame ``width`` wide."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device) + float(y0),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return xs.reshape(-1), ys.reshape(-1)


@dataclasses.dataclass(frozen=True)
class Scene:
    """Triangle soup as struct-of-arrays (raytpu.core.types.Scene).

    Attributes:
      v0, v1, v2: (T, 3) float32 vertex positions.
      color:      (T, 3) float32 per-triangle albedo.
      active:     (T,)  float32 mask; 1.0 = real triangle, 0.0 = padding.
    """

    v0: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    color: torch.Tensor
    active: torch.Tensor

    @property
    def num_triangles(self) -> int:
        return self.v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.device

    def edges(self):
        """e1 = v1 - v0, e2 = v2 - v0 (`raytracer.cpp:216-217`)."""
        return self.v1 - self.v0, self.v2 - self.v0

    def normals(self) -> torch.Tensor:
        """Unit normals ``normalize(cross(e2, e1))`` (`TestModel.h:30`), (T, 3).

        Degenerate and padding triangles (|n| = 0) get 0, not NaN: the sqrt
        input and the division are both guarded, as in the JAX package.
        """
        e1, e2 = self.edges()
        n = cross(e2, e1)
        norm2 = dot3(n, n)[:, None]
        norm = torch.sqrt(torch.where(norm2 > 0.0, norm2, 1.0))
        return torch.where(norm2 > 0.0, n, 0.0) / norm

    def pad_to(self, size: int) -> "Scene":
        """Pad to ``size`` triangles with inactive zero-area triangles placed
        far outside the scene, so they never hit even unmasked."""
        t = self.num_triangles
        if size < t:
            raise ValueError(f"pad_to({size}) smaller than {t} triangles")
        if size == t:
            return self
        pad = size - t
        far = torch.full((pad, 3), 1e9, dtype=torch.float32, device=self.device)
        zc = torch.zeros((pad, 3), dtype=torch.float32, device=self.device)
        return Scene(
            v0=torch.cat([self.v0, far]),
            v1=torch.cat([self.v1, far]),
            v2=torch.cat([self.v2, far]),
            color=torch.cat([self.color, zc]),
            active=torch.cat(
                [self.active, torch.zeros((pad,), dtype=torch.float32,
                                          device=self.device)]
            ),
        )

    @staticmethod
    def from_vertices(v0, v1, v2, color, *, device) -> "Scene":
        v0 = f32(v0, device)
        return Scene(
            v0=v0,
            v1=f32(v1, device),
            v2=f32(v2, device),
            color=f32(color, device),
            active=torch.ones((v0.shape[0],), dtype=torch.float32,
                              device=device),
        )


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera (raytpu.core.types.Camera).

    Attributes:
      pos:       (3,) float32 camera position.
      yaw:       ()  float32 rotation about the y axis.
      focal:     ()  float32 focal length in pixels.
      y_scale:   ()  float32 the ``cameraRot[1][1]`` value (1.0 raytracer).
      dof_focus: ()  float32 the DoF focus distance (`raytracer.cpp:45`).
    """

    pos: torch.Tensor
    yaw: torch.Tensor
    focal: torch.Tensor
    y_scale: torch.Tensor
    dof_focus: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def rotation(self) -> torch.Tensor:
        """Row-major rotation ``[[c, 0, -s], [0, y_scale, 0], [s, 0, c]]``,
        GLM's ``cameraRot[col][row]`` storage (ray dirs are ``M @ d``)."""
        c = torch.cos(self.yaw)
        s = torch.sin(self.yaw)
        z = torch.zeros_like(c)
        return torch.stack(
            [
                torch.stack([c, z, -s]),
                torch.stack([z, self.y_scale, z]),
                torch.stack([s, z, c]),
            ]
        )

    @staticmethod
    def make(pos, yaw=0.0, focal=250.0, y_scale=1.0, dof_focus=1.3, *,
             device) -> "Camera":
        return Camera(
            pos=f32(pos, device),
            yaw=f32(yaw, device),
            focal=f32(focal, device),
            y_scale=f32(y_scale, device),
            dof_focus=f32(dof_focus, device),
        )

    @staticmethod
    def raytracer_default(*, device) -> "Camera":
        """`raytracer.cpp:67-70`: f=250, pos (0,0,-2), DoF focus 1.3."""
        return Camera.make((0.0, 0.0, -2.0), focal=250.0, dof_focus=1.3,
                           device=device)

    @staticmethod
    def rasterizer_default(*, device) -> "Camera":
        """`rasteriser.cpp:39-41`: f=500, pos (0,0,-3), y_scale 1.01
        (`rasteriser.cpp:115`), DoF focus 1.9 (`rasteriser.cpp:31`)."""
        return Camera.make((0.0, 0.0, -3.0), focal=500.0, y_scale=1.01,
                           dof_focus=1.9, device=device)


@dataclasses.dataclass(frozen=True)
class Lights:
    """Padded bank of point lights with an active mask
    (raytpu.core.types.Lights).

    Attributes:
      position:  (L, 3) float32.
      color:     (L, 3) float32.
      intensity: (L,)  float32.
      mask:      (L,)  float32; 1.0 = active.
      jitter:    (L, S, 3) float32 jittered soft-shadow positions
                 ``position + uniform(-0.5, 0.5) * 0.08`` per axis.
    """

    position: torch.Tensor
    color: torch.Tensor
    intensity: torch.Tensor
    mask: torch.Tensor
    jitter: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    @property
    def num_soft_samples(self) -> int:
        return self.jitter.shape[1]

    @property
    def device(self) -> torch.device:
        return self.position.device

    @staticmethod
    def single(position=(0.0, -0.5, -0.7), color=(1.0, 1.0, 1.0),
               intensity=14.0, capacity: int = 32, soft_samples: int = 16, *,
               device, generator: torch.Generator | None = None,
               offsets=None) -> "Lights":
        """One active light with the reference defaults (`raytracer.cpp:116`).
        ``generator`` and ``offsets`` are as for :meth:`add`."""
        return Lights.empty(capacity, soft_samples, device=device).add(
            position, color, intensity, generator=generator, offsets=offsets
        )

    @staticmethod
    def empty(capacity: int = 32, soft_samples: int = 16, *,
              device) -> "Lights":
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return Lights(
            position=zeros(capacity, 3),
            color=zeros(capacity, 3),
            intensity=zeros(capacity),
            mask=zeros(capacity),
            jitter=zeros(capacity, soft_samples, 3),
        )

    def add(self, position, color, intensity, *,
            generator: torch.Generator | None = None,
            offsets=None) -> "Lights":
        """Functional AddLight (`raytracer.cpp:180-193`): fills the first
        inactive slot and stores jittered soft-shadow positions.

        ``offsets`` (S, 3) are the jitter offsets ``uniform(-0.5, 0.5) *
        0.08``; pass them to reproduce another bank's jitter exactly (the
        JAX package draws them with ``jax.random``, which torch cannot
        replay). Without them they are drawn on the host from
        ``generator`` (a fresh one seeded 0 when None).
        """
        dev = self.device
        idx = torch.argmin(self.mask)
        s = self.num_soft_samples
        if offsets is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            offsets = (torch.rand((s, 3), generator=generator) - 0.5) * 0.08
        offsets = f32(offsets, dev)
        if offsets.shape != (s, 3):
            raise ValueError(f"offsets must be ({s}, 3), got "
                             f"{tuple(offsets.shape)}")
        position = f32(position, dev)

        def put(table, value):
            table = table.clone()
            table[idx] = value
            return table

        return Lights(
            position=put(self.position, position),
            color=put(self.color, f32(color, dev)),
            intensity=put(self.intensity, f32(intensity, dev)),
            mask=put(self.mask, 1.0),
            jitter=put(self.jitter, position[None, :] + offsets),
        )

    def compact(self) -> "Lights":
        """Strip inactive slots on the host, keeping the order of the active
        ones, so render cost follows the ACTIVE light count. Inactive slots
        contribute exactly zero, so results are unchanged. A bank with no
        active light keeps one inactive slot."""
        keep = np.flatnonzero(self.mask.detach().cpu().numpy() > 0.0)
        if max(keep.size, 1) == self.capacity:
            return self
        if keep.size == 0:
            keep = np.array([0])
        take = torch.as_tensor(keep, device=self.device)
        return Lights(
            position=self.position[take],
            color=self.color[take],
            intensity=self.intensity[take],
            mask=self.mask[take],
            jitter=self.jitter[take],
        )

    def delete_last(self) -> "Lights":
        """Functional DeleteLight (`raytracer.cpp:195-199`): deactivates the
        highest active slot; a bank with no active light is unchanged. On
        the device, without a host read."""
        active = self.mask > 0
        slots = torch.arange(self.capacity, device=self.device)
        last = torch.argmax(torch.where(active, slots, -1))
        mask = torch.where((slots == last) & active.any(), 0.0, self.mask)
        return dataclasses.replace(self, mask=mask)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings, the same fields and defaults as
    raytpu.core.types.RenderConfig (see there for each field's source).

    The JAX package's ``use_pallas`` switch has no counterpart: the device
    of the tensors picks the route.
    """

    width: int = 500
    height: int = 500
    mode: Mode = "parity"
    aa_samples: int = 1
    soft_shadow_samples: int = 1
    dof_enabled: bool = False
    dof_kernel_size: int = 8
    backface_cull: bool = True
    frustum_cull: bool = True
    ambient: float = 0.2
    tri_chunk: int = 512
    raster_tri_chunk: int = 64
    soft_edge_sharpness: float = 100.0
    soft_z_sharpness: float = 100.0
    # Route the eligible configuration (one light, hard shadows, one
    # sub-ray, one triangle chunk) through the fused forward kernel; with
    # False it takes the loop branch of raytrace_full.
    megakernel: bool = True

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
