"""The port's fused forward (raytpu_torch.kernels.render_fused) against the
JAX package's megakernel.

On the CPU the port runs the plain PyTorch version of the kernel; the JAX
side runs its Pallas kernel in interpret mode (``_call_fwd``), both on the
same inputs (the JAX package's constants, carried across as numpy). Image
and focal distance agree to atol 1e-6 (as tests/test_render_fused.py holds
the JAX megakernel to the XLA path); the winner index and occlusion bit
agree bit for bit on every ray, and the mismatch count is reported.

The CUDA kernel itself is checked against the plain version on the card
by tests/test_torch_gpu.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.kernels.intersect_pallas import _blocked_constants, _tight_chunk
from raytpu.kernels.render_fused import _call_fwd
from raytpu.ops.intersect import tri_constants as jax_tri_constants
from raytpu.render.raytrace import camera_ray_dirs, pixel_grid

from raytpu_torch.kernels import render_fused
from raytpu_torch.kernels.tables import (
    NORMAL,
    PRIMARY,
    SHADOW,
    pack_params,
    pack_tables,
    tight_chunk,
)

_jit_call_fwd = jax.jit(_call_fwd, static_argnums=(12, 13, 14, 15))


def _random_camera(seed):
    rng = np.random.default_rng(seed)
    pos = np.array([0.0, 0.0, -2.0]) + rng.uniform(-0.3, 0.3, 3)
    return JaxCamera.make(pos.astype(np.float32),
                          yaw=float(rng.uniform(-0.4, 0.4)))


# (mode, scene size, camera): the two modes, the padded (32) and unpadded
# (30) Cornell box, the default and a seeded random camera.
CASES = {
    "clean-32-default": ("clean", 32, None),
    "clean-32-random": ("clean", 32, 7),
    "parity-30-default": ("parity", None, None),
    "parity-30-random": ("parity", None, 11),
}


def _jax_inputs(pad_to, cam_seed, size=32):
    scene = jax_cornell_box(pad_to=pad_to)
    cam = (JaxCamera.raytracer_default() if cam_seed is None
           else _random_camera(cam_seed))
    lights = JaxLights.single(capacity=1)
    cfg = JaxRenderConfig(width=size, height=size)
    xs, ys = pixel_grid(cfg)
    dirs = camera_ray_dirs(xs, ys, cam, cfg)
    c = jax_tri_constants(scene, cam.pos)
    cl = jax_tri_constants(scene, lights.position[0])
    p_eff = lights.mask[0] * (lights.color[0] * lights.intensity[0])
    return (dirs, c.m, c.k0, c.valid, cl.m, cl.k0, scene.normals(),
            scene.color, cam.pos, lights.position[0], p_eff, cam.dof_focus)


def _to_torch(args, device="cpu"):
    return [torch.tensor(np.asarray(a), device=device) for a in args]


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    mode, pad_to, cam_seed = CASES[request.param]
    args = _jax_inputs(pad_to, cam_seed)
    parity = mode == "parity"
    color, fd, idx, occ = _jit_call_fwd(*args, 2048, 512, 0.2, parity)
    R = args[0].shape[0]
    expected = (np.asarray(color), np.asarray(fd),
                np.asarray(idx)[0, :R], np.asarray(occ)[0, :R])
    return args, parity, expected


def test_plain_version_matches_jax_kernel(case):
    args, parity, (color, fd, idx, occ) = case
    out = render_fused.render_hard_fused_reference(
        *_to_torch(args), tri_chunk=512, ambient=0.2, parity=parity)
    idx_mismatch = int((out.idx.numpy() != idx).sum())
    occ_mismatch = int((out.occ.numpy() != occ).sum())
    print(f"idx mismatches {idx_mismatch}, occ mismatches {occ_mismatch} "
          f"of {idx.size} rays")
    assert idx_mismatch == 0
    assert occ_mismatch == 0
    assert (idx >= 0).mean() > 0.9  # the camera sees the box
    np.testing.assert_allclose(out.color.numpy(), color, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.fd.numpy(), fd, rtol=0, atol=1e-6)


def test_cpu_wrapper_runs_plain_version(case):
    args, parity, _ = case
    before = render_fused.LAUNCHES
    got = render_fused.render_hard_fused(
        *_to_torch(args), tri_chunk=512, ambient=0.2, parity=parity)
    want = render_fused.render_hard_fused_reference(
        *_to_torch(args), tri_chunk=512, ambient=0.2, parity=parity)
    assert render_fused.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("T", [1, 8, 9, 30, 32, 100, 128, 129, 600])
@pytest.mark.parametrize("tri_chunk", [64, 512])
def test_tight_chunk_matches_jax(T, tri_chunk):
    assert tight_chunk(T, tri_chunk) == _tight_chunk(T, tri_chunk)


@pytest.mark.parametrize("pad_to", [None, 32])
def test_tables_hold_the_jax_blocked_constants(pad_to):
    args = _jax_inputs(pad_to, None, size=8)
    (_, m, k0, valid, m_l, k0_l, nrm, alb) = args[:8]
    C = _tight_chunk(m.shape[0], 512)
    table = pack_tables(*_to_torch(args[1:8]), C).numpy()
    T = m.shape[0]
    for base, (mm, kk) in ((PRIMARY, (m, k0)), (SHADOW, (m_l, k0_l))):
        blk, _ = _blocked_constants(mm, kk, valid, C)  # (4C, 3)
        blk = np.asarray(blk)
        for part in range(3):  # n | c2 | c3
            np.testing.assert_array_equal(
                table[base + 3 * part:base + 3 * part + 3],
                blk[part * C:(part + 1) * C].T)
        np.testing.assert_array_equal(table[base + 9], blk[3 * C:, 0])
    np.testing.assert_array_equal(table[NORMAL:NORMAL + 3, :T],
                                  np.asarray(nrm).T)
    assert not table[:, T:].any()  # padding columns are zero
    params = pack_params(*_to_torch(args[8:12])).numpy()
    np.testing.assert_array_equal(
        params, np.concatenate([np.asarray(a).reshape(-1)
                                for a in args[8:12]]))


def test_multi_chunk_scene_is_refused():
    args = _to_torch(_jax_inputs(None, None, size=8))
    with pytest.raises(ValueError, match="single-chunk"):
        render_fused.render_hard_fused(*args, tri_chunk=16)
