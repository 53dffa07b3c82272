"""The port's DoF blur (raytpu_torch.ops.blur) against the JAX package's.

Seeded random images and focal distances at odd and square sizes. The box
sums add in another order than JAX's ``reduce_window``, which moves the
blurred value by a few float32 ulps: atol 1e-6 on values in [0, 1).
"""

import numpy as np
import pytest
import torch

from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.ops import blur as jax_blur

from raytpu_torch.core.types import RenderConfig
from raytpu_torch.ops import blur

SHAPES = [(17, 23), (32, 32), (23, 17)]


def _inputs(h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)
    fd = rng.uniform(-2.0, 2.0, (h, w)).astype(np.float32)
    return img, fd


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("kernel_size", [8, 5])
@pytest.mark.parametrize("name", ["dof_blur", "dof_blur_parity"])
def test_blur_matches_jax(name, h, w, kernel_size):
    img, fd = _inputs(h, w)
    want = np.asarray(getattr(jax_blur, name)(img, fd, kernel_size))
    got = getattr(blur, name)(torch.from_numpy(img), torch.from_numpy(fd),
                              kernel_size).numpy()
    assert got.shape == (h, w, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # The 1-px border is black in both variants (`raytracer.cpp:618-620`).
    assert not got[0].any() and not got[-1].any()
    assert not got[:, 0].any() and not got[:, -1].any()


@pytest.mark.parametrize("mode", ["clean", "parity"])
@pytest.mark.parametrize("dof", [False, True])
def test_dof_apply_matches_jax(mode, dof):
    img, fd = _inputs(17, 23, seed=1)
    want = np.asarray(jax_blur.dof_apply(
        img, fd, JaxRenderConfig(mode=mode, dof_enabled=dof)))
    got = blur.dof_apply(torch.from_numpy(img), torch.from_numpy(fd),
                         RenderConfig(mode=mode, dof_enabled=dof)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if not dof:
        np.testing.assert_array_equal(got, want)  # a mask or nothing: exact


def test_parity_wraps_rows_with_the_height_stride():
    """A single bright pixel spreads through flat indices (y+z)*H + (x+z2):
    on a non-square image the neighbours wrap into the next row."""
    h, w = 6, 9
    img = np.zeros((h, w, 3), np.float32)
    img[2, 8] = 1.0
    fd = np.full((h, w), 1.0, np.float32)
    got = blur.dof_blur_parity(torch.from_numpy(img), torch.from_numpy(fd),
                               3).numpy()
    want = np.asarray(jax_blur.dof_blur_parity(img, fd, 3))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert got.any()
