"""Triangle tables and parameters of the fused forward kernel.

Counterpart of the helpers ``_tight_chunk`` and ``_blocked_constants`` in
raytpu/kernels/intersect_pallas.py. The TPU kernels read their constants
as chunk-blocked (4C, 3) scalar-prefetch arrays; the CUDA kernels read
flat float32 tables of 10-row constant blocks (``_constant_rows``). The
intersection kernels (kernels/intersect.py) take 1 + S such blocks of Tp
columns (``constant_table``: T rounded up to whole chunks, the columns
past T zero, as ``_blocked_constants`` zeroes them); the fused forward
kernel reads one table of TABLE_ROWS rows by C columns
(row-major), which each thread block copies into shared memory:

  rows  0..9   primary (camera-origin) constants  n xyz | c2 xyz | c3 xyz | k0
  rows 10..19  shadow (light-origin) constants, same layout
  rows 20..22  shading normal xyz
  rows 23..25  albedo xyz

where (n, c2, c3) are the rows of TriConstants.m. Invalid and padding
triangles have zeroed constants: their denominator is 0, so they never
hit. Columns T..C-1 are zero padding. The backward reads and writes only
the GATHERED rows, the values the forward takes from the winner; the
table's gradient is zero in every other row.
"""

from __future__ import annotations

import torch

TABLE_ROWS = 26
MAX_CHUNK = 128
PRIMARY, SHADOW, NORMAL, ALBEDO = 0, 10, 20, 23
PARAMS = 10  # cam xyz | light xyz | p_eff xyz | dof_focus
# The winner's values the shading reads: n xyz, k0, normal xyz, albedo xyz.
GATHERED = (PRIMARY, PRIMARY + 1, PRIMARY + 2, PRIMARY + 9,
            NORMAL, NORMAL + 1, NORMAL + 2, ALBEDO, ALBEDO + 1, ALBEDO + 2)


def tight_chunk(T: int, tri_chunk: int) -> int:
    """Triangles per chunk: T rounded up to 8, at most 128 and tri_chunk."""
    return min(tri_chunk, MAX_CHUNK, max(8, -(-T // 8) * 8))


def _constant_rows(m: torch.Tensor, k0: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """(10, T) rows [n | c2 | c3 | k0] with invalid triangles zeroed, from
    m (T, 3, 3) and k0 (T,); (S, 10, T) from batched constants m (S, T, 3,
    3) and k0 (S, T). The mask takes no part in the gradient, as in the JAX
    package's VJP."""
    valid = valid.detach()
    m = m * valid[:, None, None]
    k0 = k0 * valid
    return torch.cat([m[..., 0, :].transpose(-1, -2),
                      m[..., 1, :].transpose(-1, -2),
                      m[..., 2, :].transpose(-1, -2), k0[..., None, :]],
                     dim=-2)


def constant_table(m, k0, valid, m_s, k0_s, C: int) -> torch.Tensor:
    """The intersection kernels' ((1 + S) * 10, Tp) table, Tp = T rounded
    up to a multiple of the chunk C: block 0 from the camera-origin
    constants (m (T, 3, 3), k0 (T,), valid (T,)), block 1 + s from source
    s's (m_s (S, T, 3, 3), k0_s (S, T); None for no source); invalid
    triangles and the columns past T zero, so they never hit."""
    T = m.shape[0]
    rows = _constant_rows(m, k0, valid)
    if m_s is not None:
        rows = torch.cat([rows,
                          _constant_rows(m_s, k0_s, valid).flatten(0, 1)])
    return torch.nn.functional.pad(rows, (0, -(-T // C) * C - T)).contiguous()


def source_table(m_s, k0_s, valid, C: int) -> torch.Tensor:
    """The (S * 10, Tp) table of the occlusion kernels K7b and K7c: block s
    from source s's constants (m_s (S, T, 3, 3), k0_s (S, T)), invalid
    triangles and the columns past T zero, Tp = T rounded up to a multiple
    of the chunk C."""
    T = m_s.shape[1]
    rows = _constant_rows(m_s, k0_s, valid).flatten(0, 1)
    return torch.nn.functional.pad(rows, (0, -(-T // C) * C - T)).contiguous()


def pack_tables(m, k0, valid, m_l, k0_l, nrm, alb, C: int) -> torch.Tensor:
    """The kernel's (TABLE_ROWS, C) table from the primary constants
    (m, k0, valid), the shadow constants (m_l, k0_l), normals and albedo."""
    T = m.shape[0]
    if T > C:
        raise ValueError(f"{T} triangles do not fit one chunk of {C}")
    rows = torch.cat([
        _constant_rows(m, k0, valid),
        _constant_rows(m_l, k0_l, valid),
        nrm.T,
        alb.T,
    ])
    return torch.nn.functional.pad(rows, (0, C - T)).contiguous()


def pack_params(cam_pos, light_pos, p_eff, dof_focus) -> torch.Tensor:
    """The kernel's (PARAMS,) parameter vector."""
    return torch.cat([cam_pos, light_pos, p_eff, dof_focus.reshape(1)])


def gathered_rows(table: torch.Tensor) -> torch.Tensor:
    """The GATHERED rows of a table, (10, C), by slices (no index tensor,
    so no host-to-device copy)."""
    return torch.cat([table[PRIMARY:PRIMARY + 3],
                      table[PRIMARY + 9:PRIMARY + 10],
                      table[NORMAL:ALBEDO + 3]])


def table_from_gathered(rows: torch.Tensor) -> torch.Tensor:
    """The (TABLE_ROWS, C) table that holds ``rows`` (10, C) in its
    GATHERED rows and zeros everywhere else."""
    def zeros(n):
        return rows.new_zeros((n, rows.shape[1]))

    return torch.cat([rows[0:3], zeros(6), rows[3:4], zeros(NORMAL - 10),
                      rows[4:10]])


def unpack(table: torch.Tensor) -> dict[str, torch.Tensor]:
    """The rows of a (TABLE_ROWS, C) table, or of its gradient, by name:
    ``n``, ``c2``, ``c3`` (3, C) and ``k0`` (C,) of the primary constants,
    the same with a ``_l`` suffix for the shadow constants, ``normal`` and
    ``albedo`` (3, C)."""
    out = {}
    for base, suffix in ((PRIMARY, ""), (SHADOW, "_l")):
        out["n" + suffix] = table[base:base + 3]
        out["c2" + suffix] = table[base + 3:base + 6]
        out["c3" + suffix] = table[base + 6:base + 9]
        out["k0" + suffix] = table[base + 9]
    out["normal"] = table[NORMAL:NORMAL + 3]
    out["albedo"] = table[ALBEDO:ALBEDO + 3]
    return out
