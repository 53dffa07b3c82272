"""Numpy parity oracle for the reference scanline rasteriser.

Re-derives `rasteriser/Source/rasteriser.cpp` bit-for-bit (float32, same op
order): VertexShader (`:532-546`), ComputePolygonRows + Interpolate
(`:674-735`, `:615-637`), the per-row Bresenham fill (`:639-672`),
DrawLineSDL's z-test (`:592-612`), PixelShader (`:549-589`), and the
backface/frustum culling pass (`:404-447`). Validated against the committed
ground-truth render `rasteriser/screenshot.bmp`.

Reproduced quirks (SURVEY.md §7):
  * ``cameraRot[1][1] = 1.01`` — the y axis is scaled by 1.01
    (`rasteriser.cpp:115`).
  * Vertex screen coords are truncated to int BEFORE adding W/2
    (`rasteriser.cpp:544-545`).
  * Edge interpolation walks float accumulators and truncates per row
    (`Interpolate`, `:615-637`); left/right extremes update on strict
    inequality only (`:716-733`).
  * The row fill draws x in (left.x, right.x] — the leftmost pixel is
    SKIPPED (Bresenham increments x before writing, `:651-653`), and the
    attributes lag one pixel (``zinv = a.zinv + step*i`` while
    ``x = a.x + 1 + i``, `:665-668`). Single-pixel rows draw nothing.
  * z-test is ``zinv > depthBuffer`` with the buffer cleared to 0
    (`:606`, `:188`): first triangle wins zinv ties.
  * PixelShader ignores shadows entirely (`:567-584`).
"""

from __future__ import annotations

import numpy as np

F32 = np.float32


def _f32(x):
    return np.float32(x)


def glm_inverse3(m: np.ndarray) -> np.ndarray:
    """glm::inverse for a 3x3, float32 op order (adjugate / det).

    m is row-major (m[r, c]); matches GLM's
    `detail/func_matrix.inl` compute_inverse<mat3> element order.
    """
    m = m.astype(np.float32)
    det = (
        m[0, 0] * (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1])
        - m[0, 1] * (m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0])
        + m[0, 2] * (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0])
    )
    inv_det = _f32(1.0) / det
    out = np.empty((3, 3), np.float32)
    out[0, 0] = (m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]) * inv_det
    out[0, 1] = -(m[0, 1] * m[2, 2] - m[0, 2] * m[2, 1]) * inv_det
    out[0, 2] = (m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]) * inv_det
    out[1, 0] = -(m[1, 0] * m[2, 2] - m[1, 2] * m[2, 0]) * inv_det
    out[1, 1] = (m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]) * inv_det
    out[1, 2] = -(m[0, 0] * m[1, 2] - m[0, 2] * m[1, 0]) * inv_det
    out[2, 0] = (m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]) * inv_det
    out[2, 1] = -(m[0, 0] * m[2, 1] - m[0, 1] * m[2, 0]) * inv_det
    out[2, 2] = (m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]) * inv_det
    return out


def rotation_matrix(yaw: float, y_scale: float = 1.01) -> np.ndarray:
    """Row-major camera rotation; `rasteriser.cpp:115,378-383`."""
    c, s = _f32(np.cos(yaw)), _f32(np.sin(yaw))
    return np.array(
        [[c, 0, -s], [0, _f32(y_scale), 0], [s, 0, c]], np.float32
    )


def vertex_shader(v, camera_pos, rot, focal, width, height):
    """VertexShader (`rasteriser.cpp:532-546`). Returns
    (x:int, y:int, zinv:f32, pos3d:(3,) f32)."""
    pos = ((v - camera_pos) @ rot).astype(np.float32)  # (v-C)*R
    pos3d = (pos / pos[2]).astype(np.float32)
    zinv = _f32(1.0) / pos[2]
    x = int(np.int32(focal * (pos[0] * zinv)) + _f32(width / 2.0))
    y = int(np.int32(focal * (pos[1] * zinv)) + _f32(height / 2.0))
    return x, y, zinv, pos3d


def _interpolate(a, b):
    """Interpolate (`rasteriser.cpp:615-637`): N = |dy|+1 samples walked with
    float accumulators, truncated to int x/y per sample.

    a, b: dict(x:int, y:int, zinv:f32, pos3d:(3,)).
    Returns list of (x:int, y:int, zinv, pos3d).
    """
    n = abs(b["y"] - a["y"]) + 1
    denom = _f32(max(n - 1, 1))
    sx = _f32(b["x"] - a["x"]) / denom
    sy = _f32(b["y"] - a["y"]) / denom
    sz = _f32(b["zinv"] - a["zinv"]) / denom
    sp = ((b["pos3d"] - a["pos3d"]) / denom).astype(np.float32)

    cx, cy, cz = _f32(a["x"]), _f32(a["y"]), _f32(a["zinv"])
    cp = a["pos3d"].astype(np.float32).copy()
    out = []
    for _ in range(n):
        out.append((int(cx), int(cy), _f32(cz), cp.copy()))
        cx = _f32(cx + sx)
        cy = _f32(cy + sy)
        cz = _f32(cz + sz)
        cp = (cp + sp).astype(np.float32)
    return out


def compute_polygon_rows(vertex_pixels):
    """ComputePolygonRows (`rasteriser.cpp:674-735`).

    Returns (min_y, left, right) where left/right are lists of
    (x, y_screen, zinv, pos3d) per row; strict-inequality updates.
    """
    ys = [p["y"] for p in vertex_pixels]
    min_y, max_y = min(ys), max(ys)
    rows = max_y - min_y + 1
    intmax = np.iinfo(np.int32).max
    left = [
        {"x": intmax, "y": 0, "zinv": _f32(0), "pos3d": np.zeros(3, F32)}
        for _ in range(rows)
    ]
    right = [
        {"x": -intmax, "y": 0, "zinv": _f32(0), "pos3d": np.zeros(3, F32)}
        for _ in range(rows)
    ]
    for i in range(3):
        j = (i + 1) % 3
        v1 = dict(vertex_pixels[i])
        v2 = dict(vertex_pixels[j])
        v1["y"] -= min_y
        v2["y"] -= min_y
        for (x, y, zinv, pos3d) in _interpolate(v1, v2):
            if x < left[y]["x"]:
                left[y] = {
                    "x": x, "y": y + min_y, "zinv": zinv, "pos3d": pos3d
                }
            if x > right[y]["x"]:
                right[y] = {
                    "x": x, "y": y + min_y, "zinv": zinv, "pos3d": pos3d
                }
    return left, right


def cull_mask(v0, v1, v2, normals, camera_pos, rot, focal, width, height,
              backface=True, frustum=True):
    """Culling pass of Update (`rasteriser.cpp:404-447`).

    Returns boolean keep-mask (T,). Backface: cull when
    ``dot(v0 - cameraPos, normal) > 0`` (`:410`). Frustum: camera-space
    verts through the fovy perspective matrix (`:390-402` — note
    ``transform[3][2]`` is overwritten to 1.0, so w' = z and z' maps to a
    constant; effectively an x,y NDC bounds test), cull when ALL three
    verts are outside the cuboid (`:444-445`).
    """
    T = v0.shape[0]
    keep = np.ones(T, bool)
    if backface:
        keep &= ~(np.sum((v0 - camera_pos) * normals, axis=-1) > 0.0)
    if frustum:
        # fovy-derived factor: t=(0,-h/2,f), b=(0,h/2,f)
        h, w = _f32(height), _f32(width)
        t = np.array([0, -h / 2, focal], np.float32)
        b = np.array([0, h / 2, focal], np.float32)
        cy = _f32(np.dot(t, b) / (np.linalg.norm(t) * np.linalg.norm(b)))
        rfovy = _f32(np.arccos(cy))
        k = _f32(1.0) / _f32(np.tan(rfovy / 2.0))
        aspect = w / h

        def in_cuboid(vs):
            cs = ((vs - camera_pos) @ rot).astype(np.float32)
            # v' = v * transform with transform[0][0]=k/aspect,
            # [1][1]=k, [2][2]=far/(far-near), [3][2]=1 => w' = z.
            with np.errstate(divide="ignore", invalid="ignore"):
                x = (cs[:, 0] * (k / aspect)) / cs[:, 2]
                y = (cs[:, 1] * k) / cs[:, 2]
            return (x >= -1) & (x <= 1) & (y >= -1) & (y <= 1)

        inside = in_cuboid(v0) | in_cuboid(v1) | in_cuboid(v2)
        keep_f = keep & inside
        # Frustum pass only runs for triangles not already backface-culled
        # (`:416`), but its only effect is culling, so composition is an AND.
        keep = keep_f
    return keep


def render(scene_arrays, width=500, height=500, focal=500.0,
           camera_pos=(0.0, 0.0, -3.0), yaw=0.0, y_scale=1.01,
           light_positions=((0.0, -0.5, -0.7),),
           light_colors=((1.0, 1.0, 1.0),),
           light_intensities=(14.0,),
           ambient=0.2, backface=True, frustum=True,
           dof_enabled=False, dof_kernel_size=8, dof_focus=1.9):
    """Full-frame oracle render (Update culling + Draw + CalculateDOF).

    Returns (image (H, W, 3) f32 — post-DoF/border, focal_distances (H, W)).
    """
    v0, v1, v2, colors = scene_arrays
    e1 = (v1 - v0).astype(np.float32)
    e2 = (v2 - v0).astype(np.float32)
    n = np.cross(e2, e1).astype(np.float32)
    normals = (
        n / np.linalg.norm(n, axis=-1, keepdims=True).astype(np.float32)
    ).astype(np.float32)

    cam = np.asarray(camera_pos, np.float32)
    rot = rotation_matrix(yaw, y_scale)
    keep = cull_mask(
        v0, v1, v2, normals, cam, rot, _f32(focal), width, height,
        backface=backface, frustum=frustum,
    )

    depth = np.zeros((height, width), np.float32)  # cleared to 0 (`:188`)
    g_idx = np.full((height, width), -1, np.int32)
    g_zinv = np.zeros((height, width), np.float32)
    g_pos3d = np.zeros((height, width, 3), np.float32)

    for ti in range(v0.shape[0]):
        if not keep[ti]:
            continue
        vp = []
        for v in (v0[ti], v1[ti], v2[ti]):
            x, y, zinv, pos3d = vertex_shader(
                v, cam, rot, _f32(focal), width, height
            )
            vp.append({"x": x, "y": y, "zinv": zinv, "pos3d": pos3d})
        left, right = compute_polygon_rows(vp)

        for a, b in zip(left, right):
            ay, by = a["y"], b["y"]
            # DrawRows skip (`:743-746`)
            if (ay >= height and by >= height) or (ay < 0 and by < 0):
                continue
            dx = b["x"] - a["x"]
            if dx <= 0:
                continue
            i = np.arange(dx, dtype=np.int32)
            xs = a["x"] + 1 + i
            ys = np.full(dx, ay, np.int32)
            zstep = _f32((b["zinv"] - a["zinv"]) / _f32(dx))
            pstep = ((b["pos3d"] - a["pos3d"]) / _f32(dx)).astype(np.float32)
            zinv_i = (a["zinv"] + zstep * i.astype(np.float32)).astype(
                np.float32
            )
            pos3d_i = (
                a["pos3d"][None, :]
                + pstep[None, :] * i.astype(np.float32)[:, None]
            ).astype(np.float32)
            ok = (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
            ok &= zinv_i > depth[np.clip(ys, 0, height - 1),
                                 np.clip(xs, 0, width - 1)]
            xs, ys = xs[ok], ys[ok]
            depth[ys, xs] = zinv_i[ok]
            g_idx[ys, xs] = ti
            g_zinv[ys, xs] = zinv_i[ok]
            g_pos3d[ys, xs] = pos3d_i[ok]

    # Deferred PixelShader (`rasteriser.cpp:549-589`).
    img = np.zeros((height, width, 3), np.float32)
    fd = np.zeros((height, width), np.float32)
    hitmask = g_idx >= 0
    ys, xs = np.nonzero(hitmask)
    if len(ys):
        inv_rot = glm_inverse3(rot)
        p3 = g_pos3d[ys, xs] / g_zinv[ys, xs][:, None]
        world = (p3 @ inv_rot).astype(np.float32) + cam  # pos3d*inverse(R)+C
        dist = np.linalg.norm(world - cam, axis=-1).astype(np.float32)
        fd[ys, xs] = dist - _f32(dof_focus)

        result = np.zeros((len(ys), 3), np.float32)
        for lp, lc, li in zip(
            np.asarray(light_positions, np.float32),
            np.asarray(light_colors, np.float32),
            np.asarray(light_intensities, np.float32),
        ):
            delta = (world - lp).astype(np.float32)
            r = np.sqrt(np.sum(delta * delta, axis=-1)).astype(np.float32)
            A = (4.0 * np.pi * (r * r).astype(np.float64)).astype(np.float32)
            light_color = (lc * li).astype(np.float32)
            r_dir = (-delta / r[:, None]).astype(np.float32)
            n_dir = normals[g_idx[ys, xs]]
            B = light_color[None, :] / A[:, None]
            lam = np.maximum(
                np.sum(r_dir * n_dir, axis=-1), _f32(0.0)
            )
            result += B * lam[:, None]

        img[ys, xs] = (
            (result + _f32(ambient)) * colors[g_idx[ys, xs]]
        ).astype(np.float32)

    from raytpu_torch.oracle.raytracer_oracle import dof_post

    out = dof_post(img, fd, dof_enabled, dof_kernel_size)
    # `img` is the raw pixelColours buffer before CalculateDOF. The committed
    # `rasteriser/screenshot.bmp` matches THIS buffer (its border pattern —
    # only column x=0 black, from the scanline left-pixel skip — shows it was
    # saved by a pre-CalculateDOF build that wrote pixels directly in Draw).
    return out, fd, img
