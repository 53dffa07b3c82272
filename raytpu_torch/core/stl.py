"""ASCII STL models (counterpart of raytpu/core/stl.py), numpy only.

  * :func:`parse_ascii_stl` / :func:`load_stl` — the reference's loader
    (`rasteriser/Source/LoadSTL.cpp:17-97`): "outer" loop blocks, three
    "vertex x y z" lines each, a fixed gray albedo (`LoadSTL.cpp:22`), then
    ``v *= -0.05`` on every axis (`LoadSTL.cpp:64-77`). ``use_native``
    picks the C++ parser of raytpu_torch.native (the JAX package's, built
    at first use), which reads the same numbers.
  * :func:`morton_order` — the centroid Morton sort of the ``--morton``
    flag (raytpu/kernels/cull.py::morton_order).
  * :func:`procedural_stl_text` — ASCII STL text of a closed, seeded,
    bumpy torus of 74 x 61 quads: 9,028 triangles, the count of the
    reference's ``enemy1.stl`` (`rasteriser.cpp:20` CUSTOM_MODEL), which
    the repository does not hold. It is input data for tests and
    chip_smoke.py; no entry point calls it.
"""

from __future__ import annotations

import numpy as np

from raytpu_torch.core.types import Scene

DEFAULT_COLOR = (0.5, 0.5, 0.5)  # `LoadSTL.cpp:22`
DEFAULT_SCALE = 0.05  # `LoadSTL.cpp:19`


def parse_ascii_stl(text: str) -> np.ndarray:
    """ASCII STL text -> (T, 3, 3) float32 vertices. Only "outer" blocks
    and the three lines after each count (`LoadSTL.cpp:32-61`); the file's
    facet normals are ignored (the reference recomputes them)."""
    verts = []
    lines = iter(text.splitlines())
    for line in lines:
        if "outer" in line:
            tri = []
            for _ in range(3):
                vline = next(lines, "")
                parts = [tok for tok in vline.split(" ")
                         if tok and tok != "vertex"]
                tri.append([float(parts[0]), float(parts[1]),
                            float(parts[2])])
            verts.append(tri)
    if not verts:
        raise ValueError("no 'outer loop' facets found — not an ASCII STL?")
    return np.asarray(verts, dtype=np.float32)


def morton_order(v0, v1, v2, bits: int = 10) -> np.ndarray:
    """Permutation sorting triangles by the Morton code of their centroids
    (stable, so equal codes keep file order)."""
    c = (np.asarray(v0) + np.asarray(v1) + np.asarray(v2)) / 3.0
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.minimum(
        ((c - lo) / span * (2**bits - 1)).astype(np.uint64), 2**bits - 1)

    def spread(x):
        x &= np.uint64(0x3FF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
        return x

    code = (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable")


def load_stl(path: str, scale: float = DEFAULT_SCALE, color=DEFAULT_COLOR,
             pad_to: int | None = None, use_native: bool | None = None,
             reorder: str | None = None, *, device) -> Scene:
    """An ASCII STL file as a Scene on ``device``, with the reference's
    ``v *= -scale`` on every axis and one albedo ``color`` for every
    triangle. Raises on a missing or invalid file. ``use_native``: None
    takes the C++ parser where raytpu_torch.native builds and the python
    one otherwise. ``reorder``: None keeps file order (the reference's
    tie-breaks depend on it), "morton" sorts by centroid Morton code."""
    from raytpu_torch import native

    if use_native is None:
        use_native = native.available()
    if use_native:
        tris = native.parse_stl(path)
    else:
        with open(path, "r", errors="replace") as f:
            tris = parse_ascii_stl(f.read())
    tris = tris * np.float32(-scale)
    if reorder == "morton":
        tris = tris[morton_order(tris[:, 0], tris[:, 1], tris[:, 2])]
    elif reorder is not None:
        raise ValueError(f"unknown reorder {reorder!r}")
    colors = np.broadcast_to(np.asarray(color, np.float32),
                             (tris.shape[0], 3)).copy()
    scene = Scene.from_vertices(tris[:, 0], tris[:, 1], tris[:, 2], colors,
                                device=device)
    return scene.pad_to(pad_to) if pad_to is not None else scene


def procedural_stl_text(n_major: int = 74, n_minor: int = 61) -> str:
    """ASCII STL text of a closed torus of ``n_major`` x ``n_minor`` quads
    (two triangles each) in file units: major radius 25, minor radius 10
    with a smooth radial bump of up to ~15% from a fixed seed, its axis
    tilted 0.8 rad about x. After the reference's x(-0.05) it spans ~3.5
    units, most of a 500^2 frame from the STL camera (0, -0.5, -5),
    f = 500. Triangles are wound so that backface culling keeps the side
    facing that camera."""
    rng = np.random.default_rng(0)
    u = 2.0 * np.pi * np.arange(n_major) / n_major
    v = 2.0 * np.pi * np.arange(n_minor) / n_minor
    uu, vv = np.meshgrid(u, v, indexing="ij")
    # Whole wave numbers keep the surface periodic, hence closed.
    bump = np.zeros_like(uu)
    for _ in range(4):
        m, n = rng.integers(1, 6, size=2)
        bump += rng.uniform(0.02, 0.04) * np.sin(m * uu + n * vv
                                                 + rng.uniform(0, 2 * np.pi))
    r = 10.0 * (1.0 + bump)
    pts = np.stack([(25.0 + r * np.cos(vv)) * np.cos(uu),
                    (25.0 + r * np.cos(vv)) * np.sin(uu),
                    r * np.sin(vv)], axis=-1)
    tilt = 0.8
    c, s = np.cos(tilt), np.sin(tilt)
    pts = pts @ np.array([[1.0, 0.0, 0.0], [0.0, c, s], [0.0, -s, c]])
    i0, j0 = np.meshgrid(np.arange(n_major), np.arange(n_minor),
                         indexing="ij")
    i1, j1 = (i0 + 1) % n_major, (j0 + 1) % n_minor
    a, b, cc, d = pts[i0, j0], pts[i1, j0], pts[i1, j1], pts[i0, j1]
    tris = np.stack([np.stack([a, b, cc], axis=-2),
                     np.stack([a, cc, d], axis=-2)], axis=2).reshape(-1, 3, 3)
    out = ["solid procedural_torus"]
    for tri in tris:
        out.append("  facet normal 0 0 0")
        out.append("    outer loop")
        out.extend(f"      vertex {x:.6f} {y:.6f} {z:.6f}" for x, y, z in tri)
        out.append("    endloop")
        out.append("  endfacet")
    out.append("endsolid procedural_torus")
    return "\n".join(out) + "\n"
