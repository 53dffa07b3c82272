"""Chunk culling: conservative (ray tile, triangle chunk) keep-masks
(counterpart of raytpu/kernels/cull.py), plain PyTorch on every device.

Triangles stream through the intersection kernels in chunks of C. Each
chunk gets a bounding sphere (:func:`chunk_spheres`), each ray tile a
bounding cone of its directions (:func:`tile_cones`), and
:func:`keep_mask` keeps a chunk for a tile unless the cone provably misses
the sphere. :func:`shadow_keep_mask` extends it to the shadow sweeps: a
chunk is kept for (tile, source) if its sphere can meet the cone from the
source to any chunk the tile's primary sweep kept.
:func:`position_shadow_mask` does the same for sweeps from known surface
positions. The masks are conservative, so a culled sweep gives the brute
sweep's t, idx and (on hit rays) occlusion bits exactly; they carry no
gradient.

Every expression is the JAX package's, in its order, so that the error
budgets (``_E_COS``, ``_E_SIN``, ``_range_slack``) cover the float32
arithmetic done. Square roots, norms included, are rounded once from
float64: correctly rounded as XLA's and CUDA's are, where PyTorch's CPU
sqrt can be an ulp off (ROADMAP fault F4). The JAX package's einsum of 0/1
values in shadow_keep_mask is a float32 product here, exact for sums of
0s and 1s. ``morton_order`` lives in core/stl.py.
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.core.types import dot3, full_float32

# The JAX package's Python-float constants, rounded to float32 as its weak
# typing rounds them where they meet a float32 array.
_EPS = float(np.float32(1.1920929e-07))
_E_COS = float(np.float32(64.0 * 1.1920929e-07))
_E_SIN = float(np.float32(16.0 * 1.1920929e-07))
_FOUR_EPS = float(np.float32(4.0 * 1.1920929e-07))
_SLACK = float(np.float32(32.0 * 1.1920929e-07))
_BIG = float(np.float32(3.0e38))


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 square root rounded once from float64 (correctly rounded)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm(x, axis=-1)`` of a last axis of 3."""
    return _sqrt(dot3(x, x))


def _cs_from_cos(cosx: torch.Tensor):
    """(cos, sin, e_cos, e_sin) for an angle given by its cosine; the sine's
    error bound grows as sin -> 0 (floored: over-keeping, never culling)."""
    c = cosx.clamp(-1.0, 1.0)
    s = _sqrt(torch.clamp_min(1.0 - c * c, 0.0))
    e_s = (c.abs() * _E_COS) / torch.clamp_min(s, 1e-6)
    return c, s, _E_COS, e_s


def _cs_from_sin(sinx: torch.Tensor):
    """(cos, sin, e_cos, e_sin) for an angle in [0, pi/2] given by its
    sine (the asin(r / d) half-angles of spheres)."""
    s = sinx.clamp(0.0, 1.0)
    c = _sqrt(torch.clamp_min(1.0 - s * s, 0.0))
    e_s = s * _E_SIN + _EPS
    e_c = (s * e_s) / torch.clamp_min(c, 1e-6)
    return c, s, e_c, e_s


def _angle_le_sum(cos_alpha, a, b) -> torch.Tensor:
    """Conservative test alpha <= A + B in cosine space: a, b are the
    (cos, sin, e_cos, e_sin) tuples of A in [0, pi] and B in [0, pi/2];
    always true where A + B >= pi (cos A + cos B <= 0)."""
    ca, sa, eca, esa = a
    cb, sb, ecb, esb = b
    cos_sum = ca * cb - sa * sb
    e_sum = ((((cb.abs() * eca + abs(ca) * ecb) + sb.abs() * esa)
              + abs(sa) * esb) + _FOUR_EPS)
    wraps = (ca + cb) <= 0.0
    return ((cos_alpha + _E_COS) >= (cos_sum - e_sum)) | wraps


def _range_slack(*terms) -> torch.Tensor:
    """A few eps of the summed magnitudes: slack for distance compares."""
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return _SLACK * total.abs()


def chunk_spheres(v0, v1, v2, active, chunk: int):
    """Bounding sphere of each chunk of ``chunk`` triangles: v0, v1, v2
    (T, 3), active (T,). Returns (centers (n_chunks, 3), radii
    (n_chunks,)); a chunk with no active triangle gets radius -1."""
    T = v0.shape[0]
    Tp = -(-T // chunk) * chunk
    pad = Tp - T
    verts = torch.stack([v0, v1, v2], dim=1)
    act = active > 0.0
    if pad:
        verts = torch.cat([verts, verts.new_zeros((pad, 3, 3))])
        act = torch.cat([act, act.new_zeros((pad,))])
    n_chunks = Tp // chunk
    verts = verts.reshape(n_chunks, chunk * 3, 3)
    act3 = act.reshape(n_chunks, chunk).repeat_interleave(3, dim=1)[..., None]
    vmin = torch.where(act3, verts, _BIG).amin(dim=1)
    vmax = torch.where(act3, verts, -_BIG).amax(dim=1)
    any_act = act.reshape(n_chunks, chunk).any(dim=1)
    centers = torch.where(any_act[:, None], (vmin + vmax) * 0.5, 0.0)
    half = torch.where(any_act[:, None], (vmax - vmin) * 0.5, 0.0)
    radii = torch.where(any_act, _norm(half), -1.0)
    return centers, radii


def tile_cones(dirs, tile_r: int):
    """Bounding cone of each tile of ``tile_r`` consecutive directions of
    dirs (R, 3), R a multiple of tile_r (pad with a real ray of the tile,
    never junk). Returns (axes (n_tiles, 3), cos_half (n_tiles,)): every
    direction d of a tile has d_hat . axis >= cos_half."""
    n_tiles = dirs.shape[0] // tile_r
    d = dirs.reshape(n_tiles, tile_r, 3)
    dn = d / (_norm(d)[..., None] + 1e-30)
    axis = dn.mean(dim=1)
    axis = axis / (_norm(axis)[..., None] + 1e-30)
    cos_half = dot3(dn, axis[:, None, :]).amin(dim=1)
    return axis, cos_half.clamp(-1.0, 1.0)


def keep_mask(origin, axes, cos_half, centers, radii) -> torch.Tensor:
    """(n_tiles, n_chunks) int32: 1 where the cone {origin, axis,
    half-angle} of a tile can meet a chunk's sphere in +t; an origin
    inside the sphere keeps it, an empty chunk (radius < 0) never."""
    w = centers[None, :, :] - origin[None, None, :]
    dist = _norm(w)
    dist_safe = torch.clamp_min(dist, 1e-30)
    cos_alpha = dot3(w, axes[:, None, :]) / dist_safe
    theta = tuple(x[:, None] if isinstance(x, torch.Tensor) else x
                  for x in _cs_from_cos(cos_half))
    beta = _cs_from_sin(radii[None, :] / dist_safe)
    keep = _angle_le_sum(cos_alpha, theta, beta)
    keep = keep | (dist <= radii[None, :] + _range_slack(dist))
    keep = keep & (radii[None, :] >= 0.0)
    return keep.to(torch.int32)


def chunk_mask_for(origin, dirs, v0, v1, v2, active, tile_r: int,
                   chunk: int) -> torch.Tensor:
    """keep_mask of rays from one origin: (n_tiles, n_chunks) int32."""
    centers, radii = chunk_spheres(v0, v1, v2, active, chunk)
    axes, cos_half = tile_cones(dirs, tile_r)
    return keep_mask(origin, axes, cos_half, centers, radii)


def _expand_last(cs):
    return tuple(x[..., None] if isinstance(x, torch.Tensor) else x
                 for x in cs)


def shadow_keep_mask(primary_keep, centers, radii, src_pos) -> torch.Tensor:
    """(n_tiles, S, n_chunks) int32 keep-mask of the shadow sweeps: chunk c
    for (tile i, source s) where c's sphere meets the cone from src_pos[s]
    over some chunk j that primary_keep (n_tiles, n_chunks) keeps for tile
    i, within the range |p - src| <= d_j + r_j. Conservative for the
    occlusion of rays that hit, the only rays whose bits are used."""
    S = src_pos.shape[0]
    C = centers.shape[0]
    a = src_pos[:, None, :]
    axis = centers[None, :, :] - a
    d_j = _norm(axis)
    d_j_safe = torch.clamp_min(d_j, 1e-30)
    beta_j = _cs_from_sin(radii[None, :] / d_j_safe)
    inside_j = d_j <= radii[None, :] + _range_slack(d_j)

    w = centers[None, None, :, :] - a[:, :, None, :]
    d_c = _norm(w)
    d_c_safe = torch.clamp_min(d_c, 1e-30)
    beta_c = _cs_from_sin(radii[None, None, :] / d_c_safe)
    cos_ang = dot3(w, (axis / d_j_safe[..., None])[:, :, None, :]) / d_c_safe
    angle_ok = _angle_le_sum(cos_ang, _expand_last(beta_j), beta_c)
    rhs = (d_j + radii[None, :])[:, :, None]
    range_ok = (d_c - radii[None, None, :]
                <= rhs + _range_slack(d_c, radii[None, None, :], rhs))
    origin_in_c = d_c <= radii[None, None, :] + _range_slack(d_c)
    valid_j = (radii >= 0.0)[None, :, None]
    valid_c = (radii >= 0.0)[None, None, :]
    pair = (((angle_ok & range_ok) | inside_j[:, :, None] | origin_in_c)
            & valid_j & valid_c)                          # (S, Cj, Cc)
    # keep[i, s, c] = OR_j primary_keep[i, j] & pair[s, j, c], as a product
    # of 0/1 values in full float32 (TF32 would be exact too).
    pk = primary_keep.to(torch.float32)
    with full_float32():
        hits = torch.matmul(pk, pair.to(torch.float32).reshape(S, C, C))
    return (hits > 0.0).to(torch.int32).permute(1, 0, 2).contiguous()


def position_shadow_mask(pos, src_pos, centers, radii, tile_r: int,
                         range_pad: float = 0.0) -> torch.Tensor:
    """(n_tiles, S, n_chunks) int32 keep-mask of occlusion sweeps from known
    surface positions pos (R, 3), tiles of tile_r consecutive points: each
    tile's points get a bounding sphere, and chunk c is kept for (tile,
    source s) where its sphere meets the cone from src_pos[s] over the
    tile's sphere (range cap extended by range_pad). Conservative for every
    point."""
    n_tiles = pos.shape[0] // tile_r
    p = pos.reshape(n_tiles, tile_r, 3)
    pmin = p.amin(dim=1)
    pmax = p.amax(dim=1)
    p0 = (pmin + pmax) * 0.5
    pr = _norm((pmax - pmin) * 0.5)

    a = src_pos[None, :, :]
    axis = p0[:, None, :] - a
    d_t = _norm(axis)
    d_t_safe = torch.clamp_min(d_t, 1e-30)
    beta_t = _cs_from_sin(pr[:, None] / d_t_safe)
    inside_t = d_t <= pr[:, None] + _range_slack(d_t)

    w = centers[None, None, :, :] - a[:, :, None, :]
    d_c = _norm(w)
    d_c_safe = torch.clamp_min(d_c, 1e-30)
    beta_c = _cs_from_sin(radii[None, None, :] / d_c_safe)
    cos_ang = dot3(w, (axis / d_t_safe[..., None])[:, :, None, :]) / d_c_safe
    angle_ok = _angle_le_sum(cos_ang, _expand_last(beta_t), beta_c)
    rhs = (d_t + pr[:, None])[:, :, None] + float(np.float32(range_pad))
    range_ok = (d_c - radii[None, None, :]
                <= rhs + _range_slack(d_c, radii[None, None, :], rhs))
    origin_in_c = d_c <= radii[None, None, :] + _range_slack(d_c)
    keep = (((angle_ok & range_ok) | inside_t[:, :, None] | origin_in_c)
            & (radii >= 0.0)[None, None, :])
    return keep.to(torch.int32)
