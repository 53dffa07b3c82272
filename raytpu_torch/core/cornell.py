"""The Cornell-box scene (counterpart of raytpu/core/cornell.py).

The numpy construction is a bit-exact copy of the JAX package's, so both packages
start from identical vertices; importing raytpu would load jax.

Bit-exact reconstruction of the reference scene
(`raytracer/Source/TestModel.h:51-192`; identical geometry in the rasteriser
copy at `rasteriser/Source/TestModel.h:151-292`): 30 triangles — 10 room
surfaces, 10 for the short red block, 10 for the tall blue block — built at
box side L=555 and then rescaled to [-1, 1]^3 with x and y negated
(`TestModel.h:172-191`). All arithmetic is float32 in the same operation
order as the C++ so the constants match bit-for-bit.
"""

from __future__ import annotations

import numpy as np

from raytpu_torch.core.types import Scene

_L = np.float32(555.0)

# Colors (`TestModel.h:56-62`).
_RED = (0.75, 0.15, 0.15)
_YELLOW = (0.75, 0.75, 0.15)
_GREEN = (0.15, 0.75, 0.15)
_CYAN = (0.15, 0.75, 0.75)
_BLUE = (0.15, 0.15, 0.75)
_PURPLE = (0.75, 0.15, 0.75)
_WHITE = (0.75, 0.75, 0.75)


def _room():
    L = float(_L)
    A = (L, 0, 0)
    B = (0, 0, 0)
    C = (L, 0, L)
    D = (0, 0, L)
    E = (L, L, 0)
    F = (0, L, 0)
    G = (L, L, L)
    H = (0, L, L)
    return [
        # Floor (`TestModel.h:83-84`)
        (C, B, A, _GREEN),
        (C, D, B, _GREEN),
        # Left wall (`:87-88`)
        (A, E, C, _PURPLE),
        (C, E, G, _PURPLE),
        # Right wall (`:91-92`)
        (F, B, D, _YELLOW),
        (H, F, D, _YELLOW),
        # Ceiling (`:95-96`)
        (E, F, G, _CYAN),
        (F, H, G, _CYAN),
        # Back wall (`:99-100`)
        (G, D, C, _WHITE),
        (G, H, D, _WHITE),
    ]


def _block(A, B, C, D, E, F, G, H, color):
    """Ten triangles of a box block (`TestModel.h:116-133` pattern)."""
    return [
        (E, B, A, color),
        (E, F, B, color),
        (F, D, B, color),
        (F, H, D, color),
        (H, C, D, color),
        (H, G, C, color),
        (G, E, C, color),
        (E, A, C, color),
        (G, F, E, color),
        (G, H, F, color),
    ]


def _short_block():
    # `TestModel.h:105-113`
    return _block(
        (290, 0, 114), (130, 0, 65), (240, 0, 272), (82, 0, 225),
        (290, 165, 114), (130, 165, 65), (240, 165, 272), (82, 165, 225),
        _RED,
    )


def _tall_block():
    # `TestModel.h:138-146`
    return _block(
        (423, 0, 247), (265, 0, 296), (472, 0, 406), (314, 0, 456),
        (423, 330, 247), (265, 330, 296), (472, 330, 406), (314, 330, 456),
        _BLUE,
    )


def cornell_box_numpy():
    """Return (v0, v1, v2, color) float32 numpy arrays of shape (30, 3).

    Applies the reference rescale loop (`TestModel.h:172-191`) in float32 with
    the same op order: v *= 2/L; v -= (1,1,1); v.x *= -1; v.y *= -1.
    """
    tris = _room() + _short_block() + _tall_block()
    v0 = np.array([t[0] for t in tris], dtype=np.float32)
    v1 = np.array([t[1] for t in tris], dtype=np.float32)
    v2 = np.array([t[2] for t in tris], dtype=np.float32)
    color = np.array([t[3] for t in tris], dtype=np.float32)

    scale = np.float32(2.0) / _L  # C++ `2/L` with float L
    flip = np.array([-1.0, -1.0, 1.0], dtype=np.float32)
    for v in (v0, v1, v2):
        v *= scale
        v -= np.float32(1.0)
        v *= flip
    return v0, v1, v2, color


def cornell_box(pad_to: int | None = None, *, device) -> Scene:
    """Cornell box as a :class:`Scene` on ``device``; optionally padded to a
    static size."""
    v0, v1, v2, color = cornell_box_numpy()
    scene = Scene.from_vertices(v0, v1, v2, color, device=device)
    if pad_to is not None:
        scene = scene.pad_to(pad_to)
    return scene
