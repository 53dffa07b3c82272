"""Depth-of-field post blur, plain PyTorch (raytpu/ops/blur.py).

Reference: CalculateDOF (`raytracer/Source/raytracer.cpp:608-656`). A KxK
box (offsets -K/2 .. K/2-1) whose weights depend only on the CENTER
pixel's |focal distance| (`:630-637`):

  w_center = 1 - min(|fd|, 1) * (K^2 - 1) / K^2
  w_other  =     min(|fd|, 1) / K^2

so the blur is ``w_c * img + w_o * (box_sum - img)``. The box sums are
separable: K shifted adds along one axis, then K along the other. They
run in another order than JAX's ``reduce_window``, which moves a result
by a few float32 ulps.

  * dof_blur_parity — the reference's flat-buffer indexing
    (`pixelColours[(y+z)*H + (x+z2)]`, `:637`): neighbours wrap into
    adjacent rows, out-of-buffer indices contribute zero, and only
    x, y in [1, S-2] are written (a black 1-px border, `:618-620`).
  * dof_blur — the clean 2-D zero-padded window.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _weights(focal_distances: torch.Tensor, kernel_size: int):
    # The two scales are float32 quotients, as in the JAX package.
    total = np.float32(kernel_size * kernel_size)
    m = torch.clamp_max(torch.abs(focal_distances), 1.0)
    w_center = 1.0 - m * float((total - np.float32(1.0)) / total)
    w_other = m * float(np.float32(1.0) / total)
    return w_center, w_other


def _interior_mask(h: int, w: int, device) -> torch.Tensor:
    """1.0 on [1, S-2] x [1, S-2], 0 on the 1-px border (`:618-620`)."""
    row = torch.zeros(h, dtype=torch.float32, device=device)
    col = torch.zeros(w, dtype=torch.float32, device=device)
    row[1:h - 1] = 1.0
    col[1:w - 1] = 1.0
    return row[:, None] * col[None, :]


def _window_sum(x: torch.Tensor, k: int, stride: int, n: int) -> torch.Tensor:
    """sum_{z < k} x[i + z * stride] along dim 0, for i < n."""
    out = x[0:n]
    for z in range(1, k):
        out = out + x[z * stride:z * stride + n]
    return out


def dof_blur(img: torch.Tensor, focal_distances: torch.Tensor,
             kernel_size: int = 8) -> torch.Tensor:
    """Clean DoF blur: 2-D neighbourhood, zero padding at the borders."""
    h, w, _ = img.shape
    lo = -(kernel_size // 2)
    hi = kernel_size + lo
    w_center, w_other = _weights(focal_distances, kernel_size)
    # Pad (H, W, 3) as (3, H, W) planes: -lo before, hi - 1 after.
    pad = F.pad(img.permute(2, 0, 1), (-lo, hi - 1, -lo, hi - 1))
    rows = _window_sum(pad.permute(1, 2, 0), kernel_size, 1, h)
    box = _window_sum(rows.permute(1, 0, 2), kernel_size, 1, w)
    box = box.permute(1, 0, 2)
    out = w_center[..., None] * img + w_other[..., None] * (box - img)
    return out * _interior_mask(h, w, img.device)[..., None]


def dof_blur_parity(img: torch.Tensor, focal_distances: torch.Tensor,
                    kernel_size: int = 8) -> torch.Tensor:
    """Parity DoF blur with the reference's flat-index neighbourhood: the
    K^2 offsets z*H + z2 are K runs of K consecutive flat indices at a
    stride of H (the image HEIGHT, as in the reference), so the box is a
    K-window along the flat buffer followed by a K-window at stride H."""
    h, w, _ = img.shape
    n = h * w
    flat = img.reshape(n, 3)
    lo = -(kernel_size // 2)
    hi = kernel_size + lo
    w_center, w_other = _weights(focal_distances.reshape(-1), kernel_size)
    # Zeros over the full reach are the unchecked-index zero fill.
    pad_lo = -lo * h - lo
    pad_hi = (hi - 1) * h + (hi - 1)
    flat_pad = F.pad(flat.T, (pad_lo, pad_hi)).T
    s1 = _window_sum(flat_pad, kernel_size, 1, n + (kernel_size - 1) * h)
    box = _window_sum(s1, kernel_size, h, n) - flat
    out = w_center[:, None] * flat + w_other[:, None] * box
    return out.reshape(h, w, 3) * _interior_mask(h, w, img.device)[..., None]


def dof_apply(img: torch.Tensor, focal_distances: torch.Tensor,
              cfg) -> torch.Tensor:
    """The DoF stage per RenderConfig. With DoF off only parity's border
    blanking applies (CalculateDOF still skips border pixels)."""
    h, w, _ = img.shape
    if not cfg.dof_enabled:
        if cfg.mode == "parity":
            return img * _interior_mask(h, w, img.device)[..., None]
        return img
    if cfg.mode == "parity":
        return dof_blur_parity(img, focal_distances, cfg.dof_kernel_size)
    return dof_blur(img, focal_distances, cfg.dof_kernel_size)
