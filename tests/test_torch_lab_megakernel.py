"""The lab kernels K1r and L6 (raytpu_torch/kernels/labs.py) against the
JAX package's, on the CPU.

The JAX side runs ``raytpu.kernels.render_fused._fused_fwd_raw`` (K1r) and
``bench/megakernel_lab6.py::fused_fwd_blk8`` (L6, loaded by file path:
``import bench`` finds bench.py) in interpret mode, as its own tests run
Pallas kernels off the TPU; the port runs the kernels' plain versions on
the same inputs (the JAX package's constants, carried across as numpy).
idx and occ agree bit for bit; color and fd within atol 1e-6 (XLA:CPU's
FMA contraction, ROADMAP fault F4). One module fixture per JAX compile.
The CUDA kernels are held to the plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.kernels.render_fused import _fused_fwd_raw, _params_block
from raytpu.ops.intersect import tri_constants as jax_tri_constants
from raytpu.render.raytrace import camera_ray_dirs, pixel_grid

from raytpu_torch.kernels import labs, render_fused
from raytpu_torch.kernels.tables import pack_params, pack_tables, tight_chunk
from raytpu_torch.labs import megakernel_lab6

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "jax_megakernel_lab6", ROOT / "bench" / "megakernel_lab6.py")
jax_lab6 = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_lab6)

# (mode, size, tile, scene padding): clean at 32^2 on the box padded to 32
# (tile 256, 4 tiles), parity at 48^2 on the 30-triangle box (tile 288, 8
# tiles, 36 columns a sublane for L6).
CASES = {"clean-32": ("clean", 32, 256, 32),
         "parity-48": ("parity", 48, 288, None)}


def _jax_inputs(size, pad_to):
    scene = jax_cornell_box(pad_to=pad_to)
    cam = JaxCamera.raytracer_default()
    lights = JaxLights.single(capacity=1).compact()
    cfg = JaxRenderConfig(width=size, height=size)
    xs, ys = pixel_grid(cfg)
    dirs = camera_ray_dirs(xs, ys, cam, cfg)
    c = jax_tri_constants(scene, cam.pos)
    cl = jax_tri_constants(scene, lights.position[0])
    p_eff = lights.mask[0] * (lights.color[0] * lights.intensity[0])
    return dict(dirs_t=dirs.T,
                consts=(c.m, c.k0, c.valid, cl.m, cl.k0, scene.normals(),
                        scene.color),
                par=_params_block(cam.pos, lights.position[0], p_eff,
                                  cam.dof_focus),
                params=(cam.pos, lights.position[0], p_eff, cam.dof_focus))


def _t(a):
    return torch.tensor(np.asarray(a))


def _port_args(x):
    return (_t(x["dirs_t"]).contiguous(), *map(_t, x["consts"]),
            pack_params(*map(_t, x["params"])))


def _kw(mode, tile):
    return dict(tile_r=tile, tri_chunk=512, ambient=0.2,
                parity=mode == "parity")


@pytest.fixture(scope="module", params=list(CASES))
def k1r_case(request):
    mode, size, tile, pad_to = CASES[request.param]
    x = _jax_inputs(size, pad_to)
    fn = jax.jit(lambda d, *c: _fused_fwd_raw(d, *c, x["par"],
                                              **_kw(mode, tile)))
    want = [np.asarray(a) for a in fn(x["dirs_t"], *x["consts"])]
    return mode, tile, x, want


@pytest.fixture(scope="module", params=list(CASES))
def l6_case(request):
    mode, size, tile, pad_to = CASES[request.param]
    x = _jax_inputs(size, pad_to)
    fn = jax.jit(lambda d, *c: jax_lab6.fused_fwd_blk8(d, *c, x["par"],
                                                       **_kw(mode, tile)))
    return mode, tile, x, np.asarray(fn(x["dirs_t"], *x["consts"]))


def test_plain_k1r_matches_jax_kernel(k1r_case):
    mode, tile, x, (color, fd, idx, occ) = k1r_case
    got = labs.fused_fwd_raw_reference(*_port_args(x), **_kw(mode, tile))
    assert [tuple(g.shape) for g in got] == [a.shape for a in
                                             (color, fd, idx, occ)]
    idx_mismatch = int((got[2].numpy() != idx).sum())
    occ_mismatch = int((got[3].numpy() != occ).sum())
    print(f"idx mismatches {idx_mismatch}, occ mismatches {occ_mismatch} "
          f"of {idx.size} rays")
    assert idx_mismatch == 0 and occ_mismatch == 0
    assert (idx >= 0).mean() > 0.9 and occ.any()
    np.testing.assert_allclose(got[0].numpy(), color, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), fd, rtol=0, atol=1e-6)


def test_cpu_wrapper_runs_plain_k1r_and_equals_k1(k1r_case):
    """On CPU tensors the wrapper is the plain version (no launch); K1r's
    function is K1's: the same table and rays give K1's plain outputs."""
    mode, tile, x, _ = k1r_case
    args = _port_args(x)
    before = (labs.LAUNCHES_ROWS, render_fused.LAUNCHES)
    got = labs.fused_fwd_raw(*args, **_kw(mode, tile))
    want = labs.fused_fwd_raw_reference(*args, **_kw(mode, tile))
    assert (labs.LAUNCHES_ROWS, render_fused.LAUNCHES) == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    dirs_t, consts, par = args[0], args[1:8], args[8]
    table = pack_tables(*consts, tight_chunk(consts[0].shape[0], 512))
    k1 = render_fused.fused_fwd_reference(dirs_t.T.contiguous(), table, par,
                                          ambient=0.2,
                                          parity=mode == "parity")
    for g, w in zip(got, (k1.color.T, k1.fd[None], k1.idx[None],
                          k1.occ[None])):
        assert torch.equal(g, w)


def test_plain_l6_matches_jax_kernel(l6_case):
    mode, tile, x, out8 = l6_case
    args = _port_args(x)
    got = labs.fused_fwd_blk8(*args, **_kw(mode, tile))
    assert tuple(got.shape) == out8.shape
    np.testing.assert_allclose(got.numpy(), out8, rtol=0, atol=1e-6)
    # Unblocked, L6 is K1r's color and fd (here bit for bit: one function).
    rows = labs.fused_fwd_raw_reference(*args, **_kw(mode, tile))
    assert torch.equal(labs.unblk8(got[0:24], tile), rows[0])
    assert torch.equal(labs.unblk8(got[24:32], tile), rows[1])


@pytest.mark.parametrize("k,Rp,tile", [(3, 1024, 256), (1, 2304, 288),
                                       (4, 4096, 2048), (3, 16, 8)])
def test_blk8_matches_the_lab(k, Rp, tile):
    a = np.random.default_rng(k * Rp).standard_normal((k, Rp)).astype(
        np.float32)
    got = labs.blk8(torch.tensor(a), tile)
    want = np.asarray(jax_lab6._blk8(jax.numpy.asarray(a), tile))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        labs.unblk8(got, tile).numpy(),
        np.asarray(jax_lab6._unblk8(jax.numpy.asarray(want), tile)))
    np.testing.assert_array_equal(labs.unblk8(got, tile).numpy(), a)


def test_ragged_tiles_and_too_many_triangles_are_refused():
    """F23: the JAX kernels' grid Rp // tile_r leaves a ragged tail
    unwritten; the port refuses it. T > C keeps _fused_fwd_raw's
    ValueError."""
    x = _jax_inputs(32, 32)
    args = _port_args(x)
    for fn in (labs.fused_fwd_raw, labs.fused_fwd_blk8,
               labs.fused_fwd_raw_reference, labs.fused_fwd_blk8_reference):
        with pytest.raises(ValueError, match="F23"):
            fn(*args, **_kw("clean", 300))
    with pytest.raises(ValueError, match="multiple of 8"):
        labs.fused_fwd_blk8(*args, **_kw("clean", 4))
    table = pack_tables(*args[1:8], 32)
    with pytest.raises(ValueError, match="F23"):
        labs.run_variant(args[0], table, args[8], 300, 32, True, True)
    with pytest.raises(ValueError, match="C=16"):
        labs.run_variant(args[0], table, args[8], 256, 16, True, True)
    consts = list(args[1:8])
    with pytest.raises(ValueError, match="single-chunk"):
        labs.fused_fwd_raw(args[0], *consts, args[8], tile_r=256,
                           tri_chunk=16, ambient=0.2, parity=False)


def test_lab6_runs_on_the_cpu(capsys):
    """The lab as a user runs it (--device cpu, small size): A, B and K1
    agree entry for entry, and its JSON line keeps the JAX lab's keys."""
    assert megakernel_lab6.main(["--device", "cpu", "--size", "32",
                                 "--tile", "256", "--check-only"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["maxdiff_ab"] == 0.0 and res["card"] is None
    assert res["mismatch_ab"] == {"color": 0, "fd": 0}
    assert res["mismatch_a_k1"] == {"color": 0, "fd": 0, "idx": 0, "occ": 0}
    assert megakernel_lab6.main(["--device", "cpu", "--size", "16",
                                 "--tile", "128"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"fused_1row_ms", "fused_8row_ms", "split_full_fwd_ms",
            "unc_1row", "unc_8row", "unc_split", "maxdiff_ab"} <= set(res)
    assert res["launches"] == {"render_fused_fwd_rows": 0,
                               "megakernel_lab6_blk8": 0,
                               "render_fused_fwd": 0}
