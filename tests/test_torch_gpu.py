"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here needs a CUDA device and nvcc; without a card each skips.
The file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX on the CPU.)
"""

import functools

import numpy as np
import pytest
import torch

from raytpu_torch import convert
from raytpu_torch.core.cornell import cornell_box
from raytpu_torch.core.types import Camera, Lights, RenderConfig
from raytpu_torch.kernels import render_fused
from raytpu_torch.kernels.tables import GATHERED, pack_params, pack_tables
from raytpu_torch.render.raytrace import fused_inputs, raytrace, raytrace_full

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(device, size, mode, pad_to=32, yaw=0.0, pos=(0.0, 0.0, -2.0)):
    cfg = RenderConfig(width=size, height=size, mode=mode)
    args = fused_inputs(cornell_box(pad_to=pad_to, device=device),
                        Camera.make(pos, yaw=yaw, device=device),
                        Lights.single(capacity=1, device=device), cfg)
    return args, dict(tri_chunk=cfg.tri_chunk, ambient=cfg.ambient,
                      parity=mode == "parity")


@pytest.mark.parametrize("mode", ["clean", "parity"])
@pytest.mark.parametrize("size,pad_to,yaw,pos", [
    (512, 32, 0.0, (0.0, 0.0, -2.0)),
    (257, None, 0.3, (0.2, -0.1, -1.8)),
])
def test_kernel_matches_plain_version(cuda, mode, size, pad_to, yaw, pos):
    args, kw = _inputs(cuda, size, mode, pad_to, yaw, pos)
    before = render_fused.LAUNCHES
    got = render_fused.render_hard_fused(*args, **kw)
    assert render_fused.LAUNCHES == before + 1
    want = render_fused.render_hard_fused_reference(*args, **kw)
    torch.cuda.synchronize()
    assert int((got.idx != want.idx).sum()) == 0
    assert int((got.occ != want.occ).sum()) == 0
    assert float((got.color - want.color).abs().max()) <= 1e-6
    assert float((got.fd - want.fd).abs().max()) <= 1e-6
    assert float((got.idx >= 0).float().mean()) > 0.9


def test_slice_on_gpu_matches_cpu(cuda):
    def render(device):
        return raytrace_full(cornell_box(device=device),
                             Camera.raytracer_default(device=device),
                             Lights.single(capacity=1, device=device),
                             RenderConfig(width=64, height=64))

    got, want = render(cuda), render("cpu")
    # PyTorch's CPU sqrt is not always correctly rounded; the card's is.
    assert float((got.image.cpu() - want.image).abs().max()) <= 1e-6
    assert float((got.focal_distances.cpu()
                  - want.focal_distances).abs().max()) <= 1e-6


def _bwd_inputs(device, size, mode, pad_to=32, yaw=0.0, pos=(0.0, 0.0, -2.0),
                seed=0):
    """The backward's inputs at a frame's shapes: dirs, table, params, the
    forward's idx and occ, and cotangents drawn with numpy from ``seed``."""
    args, kw = _inputs(device, size, mode, pad_to, yaw, pos)
    table, params = render_fused.pack_inputs(*args[1:], kw["tri_chunk"])
    dirs = args[0]
    out = render_fused.fused_fwd_reference(dirs, table, params,
                                           ambient=kw["ambient"],
                                           parity=kw["parity"])
    # One-signed, as chip_smoke.py's: signed cotangents cancel in the sums
    # until float32 rounding decides the small ones.
    rng = np.random.default_rng(seed)
    R = dirs.shape[0]
    g_color = torch.tensor(rng.uniform(0.5, 1.5, (R, 3)).astype(np.float32),
                           device=device)
    g_fd = torch.tensor(rng.uniform(0.5, 1.5, R).astype(np.float32),
                        device=device)
    return ((dirs, table, params, out.idx, out.occ, g_color, g_fd),
            dict(ambient=kw["ambient"], parity=kw["parity"]))


@pytest.mark.parametrize("mode", ["clean", "parity"])
@pytest.mark.parametrize("size,pad_to,yaw,pos", [
    (512, 32, 0.0, (0.0, 0.0, -2.0)),
    (257, None, 0.3, (0.2, -0.1, -1.8)),
])
def test_bwd_kernels_match_plain_version(cuda, mode, size, pad_to, yaw, pos):
    args, kw = _bwd_inputs(cuda, size, mode, pad_to, yaw, pos)
    before = (render_fused.LAUNCHES_BWD, render_fused.LAUNCHES_SCATTER)
    got = render_fused.fused_bwd(*args, **kw)
    assert (render_fused.LAUNCHES_BWD, render_fused.LAUNCHES_SCATTER) == (
        before[0] + 1, before[1] + 1)
    # The plain version in float64 is the reference: a per-triangle sum
    # adds thousands of terms, and float32 rounding of the plain version
    # itself reaches 0.8 of the tolerance.
    want = render_fused.fused_bwd_reference(
        *(a.double() if a.is_floating_point() else a for a in args), **kw)
    torch.cuda.synchronize()
    for name, g, w in zip(("g_dirs", "g_table", "g_params"), got, want):
        assert bool(torch.isfinite(g).all()), name
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    outside = torch.ones(got[1].shape[0], dtype=torch.bool)
    outside[list(GATHERED)] = False
    assert not got[1][outside].any()


def test_bwd_kernels_are_deterministic(cuda):
    args, kw = _bwd_inputs(cuda, 512, "clean", seed=1)
    first = render_fused.fused_bwd(*args, **kw)
    second = render_fused.fused_bwd(*args, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _train_leaves(device, size=64):
    scene = cornell_box(pad_to=32, device=device)
    lights = Lights.single(capacity=1, device=device)
    leaves = [t.requires_grad_(True) for value in (scene, lights)
              for t in vars(value).values()]
    return scene, lights, leaves


def test_train_step_launches_each_kernel_once(cuda):
    scene, lights, leaves = _train_leaves(cuda)
    cfg = RenderConfig(width=64, height=64, mode="clean")
    camera = Camera.raytracer_default(device=cuda)
    with torch.no_grad():
        target = raytrace(scene, camera, lights, cfg) * 0.9
    opt = torch.optim.SGD(leaves, lr=1e-3)
    before = (render_fused.LAUNCHES, render_fused.LAUNCHES_BWD,
              render_fused.LAUNCHES_SCATTER)
    opt.zero_grad()
    loss = torch.mean((raytrace(scene, camera, lights, cfg) - target) ** 2)
    loss.backward()
    opt.step()
    after = (render_fused.LAUNCHES, render_fused.LAUNCHES_BWD,
             render_fused.LAUNCHES_SCATTER)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    assert bool(torch.isfinite(scene.color.grad).all())
    assert float(scene.color.grad.abs().max()) > 0.0


@pytest.mark.parametrize("mode", ["clean", "parity"])
def test_slice_grads_on_gpu_match_cpu(cuda, mode):
    def grads(device):
        scene, lights, _ = _train_leaves(device)
        camera = Camera.raytracer_default(device=device)
        for t in vars(camera).values():
            t.requires_grad_(True)
        out = raytrace_full(scene, camera, lights,
                            RenderConfig(width=64, height=64, mode=mode))
        (torch.mean(out.image ** 2)
         + 0.1 * torch.mean(out.focal_distances ** 2)).backward()
        return [convert.grads_to_numpy(v) for v in (scene, camera, lights)]

    for got, want in zip(grads(cuda), grads("cpu")):
        for field in want:
            np.testing.assert_allclose(got[field], want[field], rtol=1e-4,
                                       atol=1e-5, err_msg=field)


def test_wrapper_checks_its_inputs(cuda):
    args, kw = _inputs(cuda, 16, "clean")
    table = pack_tables(*args[1:8], 32)
    params = pack_params(*args[8:12])
    dirs = args[0]
    call = dict(ambient=0.2, parity=False)
    with pytest.raises(TypeError):
        render_fused.fused_fwd(dirs.double(), table, params, **call)
    with pytest.raises(ValueError):
        render_fused.fused_fwd(dirs[:, :2].contiguous(), table, params, **call)
    with pytest.raises(ValueError):
        render_fused.fused_fwd(dirs.T.contiguous().T, table, params, **call)
    with pytest.raises(ValueError):
        render_fused.fused_fwd(dirs, table.cpu(), params, **call)
    wide = torch.zeros((table.shape[0], 129), device=cuda)
    with pytest.raises(ValueError):
        render_fused.fused_fwd(dirs, wide, params, **call)
    out = render_fused.fused_fwd(dirs, table, params, **call)
    R = dirs.shape[0]
    ones = torch.ones((R, 3), device=cuda)
    fd = torch.ones((R,), device=cuda)
    render_fused.fused_bwd(dirs, table, params, out.idx, out.occ, ones, fd,
                           **call)
    with pytest.raises(ValueError):  # an expanded (stride 0) cotangent
        render_fused.fused_bwd(dirs, table, params, out.idx, out.occ,
                               torch.ones(3, device=cuda).expand(R, 3), fd,
                               **call)
    with pytest.raises(TypeError):
        render_fused.fused_bwd(dirs, table, params, out.idx.long(), out.occ,
                               ones, fd, **call)


def _sweep_inputs(device, size, n_lights, samples, offset=(0.0, 0.0),
                  pad_to=32, yaw=0.0, pos=(0.0, 0.0, -2.0)):
    """The intersection kernels' arguments for one sub-ray of a frame."""
    from raytpu_torch.ops.intersect import tri_constants
    from raytpu_torch.ops.shade import source_positions
    from raytpu_torch.core.types import pixel_grid
    from raytpu_torch.render.raytrace import camera_ray_dirs
    scene = cornell_box(pad_to=pad_to, device=device)
    camera = Camera.make(pos, yaw=yaw, device=device)
    cfg = RenderConfig(width=size, height=size)
    lights = Lights.single(capacity=n_lights, soft_samples=16, device=device)
    if n_lights == 2:
        lights = lights.add((0.4, -0.5, -0.7), (1.0, 1.0, 1.0), 7.0)
    xs, ys = pixel_grid(size, size, device)
    dirs = camera_ray_dirs(xs + offset[0], ys + offset[1], camera, cfg)
    c = tri_constants(scene, camera.pos)
    src = source_positions(lights, samples)
    cs = tri_constants(scene, src)
    return dirs, c.m, c.k0, c.valid, cs.m, cs.k0, camera.pos, src


@pytest.mark.parametrize("multi", [False, True], ids=["k4", "k6"])
@pytest.mark.parametrize("size,pad_to,yaw,pos,offset", [
    (512, 32, 0.0, (0.0, 0.0, -2.0), (0.0, 0.0)),
    (257, None, 0.3, (0.2, -0.1, -1.8), (-0.5, 0.5)),
])
def test_intersect_kernels_match_plain_version(cuda, multi, size, pad_to,
                                               yaw, pos, offset):
    from raytpu_torch.kernels import intersect as isect
    n_lights, samples = (2, 16) if multi else (1, 1)
    args = _sweep_inputs(cuda, size, n_lights, samples, offset, pad_to, yaw,
                         pos)
    if multi:
        fn, ref, counter = (isect.closest_hit_occluded_multi,
                            isect.closest_hit_occluded_multi_reference,
                            "LAUNCHES_OCCLUDED_MULTI")
    else:
        args = (*args[:4], args[4][0], args[5][0], args[6], args[7][0])
        fn, ref, counter = (isect.closest_hit_occluded,
                            isect.closest_hit_occluded_reference,
                            "LAUNCHES_OCCLUDED")
    before = getattr(isect, counter)
    got = fn(*args)
    assert getattr(isect, counter) == before + 1
    want = ref(*args)
    again = fn(*args)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert float((got[1] >= 0).float().mean()) > 0.2
    assert bool(got[2].any()) and not bool(got[2].all())


def test_intersect_wrapper_checks_its_inputs(cuda):
    from raytpu_torch.kernels import intersect as isect
    dirs, m, k0, valid, m_s, k0_s, cam, src = _sweep_inputs(cuda, 16, 2, 4)
    call = (m, k0, valid, m_s, k0_s, cam, src)
    isect.closest_hit_occluded_multi(dirs, *call)
    with pytest.raises(TypeError):
        isect.closest_hit_occluded_multi(dirs.double(), *call)
    with pytest.raises(ValueError):
        isect.closest_hit_occluded_multi(dirs.T.contiguous().T, *call)
    with pytest.raises(ValueError):  # the camera position on the host
        isect.closest_hit_occluded_multi(dirs, m, k0, valid, m_s, k0_s,
                                         cam.cpu(), src)


def _k6_torus_inputs(device, quads, size, n_src, seed=3):
    """K6's arguments on the procedural torus of 2 x quads triangles at
    size^2 (the render --stl camera nudged off x = 0, focal size: rays
    through the hole and past the rim miss) with n_src shadow sources
    drawn with numpy above it."""
    import tempfile

    from raytpu_torch.core.stl import load_stl, procedural_stl_text
    from raytpu_torch.core.types import pixel_grid
    from raytpu_torch.ops.intersect import tri_constants
    from raytpu_torch.render.raytrace import camera_ray_dirs
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/torus.stl"
        with open(path, "w") as f:
            f.write(procedural_stl_text(*quads))
        scene = load_stl(path, device=device)
    camera = Camera.make((0.0123, -0.5, -5.0), focal=float(size),
                         device=device)
    cfg = RenderConfig(width=size, height=size)
    xs, ys = pixel_grid(size, size, device)
    dirs = camera_ray_dirs(xs, ys, camera, cfg)
    rng = np.random.default_rng(seed)
    src = torch.tensor((np.array([0.0, -1.5, -3.0], np.float32)
                        + rng.uniform(-0.6, 0.6, (n_src, 3))).astype(
                            np.float32), device=device)
    c = tri_constants(scene, camera.pos)
    cs = tri_constants(scene, src)
    return dirs, c.m, c.k0, c.valid, cs.m, cs.k0, camera.pos, src


@pytest.mark.parametrize("n_src,staged", [
    (48, None), (48, False), (4, None), (4, True), (4, False)])
def test_k6_at_128_triangles_on_a_frame_with_misses(cuda, n_src, staged):
    """K6 at C = 128 on a frame with misses: S = 48 (288 KB of
    triangle-major constants, more than a block's shared memory holds, so
    the wrapper reads them from device memory and staging them is
    refused) and S = 4 (24 KB: staged), each also forced either way. t,
    idx and occ equal the plain version bit for bit, occ is 0 on a miss,
    and two calls are identical."""
    from raytpu_torch.kernels import intersect as isect
    args = _k6_torus_inputs(cuda, (8, 8), 96, n_src)
    dirs, cam, src = args[0], args[6], args[7]
    table = isect.occluded_table(*args[1:6], 512)
    assert table.shape[1] == 128
    assert isect.k6_staged(n_src, 128) == (n_src == 4)

    def run():
        if staged is None:
            before = isect.LAUNCHES_OCCLUDED_MULTI
            out = isect.closest_hit_occluded_multi(*args)
            assert isect.LAUNCHES_OCCLUDED_MULTI == before + 1
            return out
        out = isect._outputs(dirs, n_src)
        isect.launch_occluded_multi_kernel(
            dirs, table, cam, src, *out,
            scratch=isect.k6_scratch(table, src), staged=staged)
        return out

    got, again = run(), run()
    want = isect.sweeps_reference(dirs, table, cam, src)
    torch.cuda.synchronize()
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    hit = got[1] >= 0
    assert 0.05 < float(hit.float().mean()) < 0.95
    assert not bool(got[2][:, ~hit].any()) and bool(got[2].any())
    if n_src == 48:
        with pytest.raises(RuntimeError):
            isect.launch_occluded_multi_kernel(
                dirs, table, cam, src, *isect._outputs(dirs, n_src),
                scratch=isect.k6_scratch(table, src), staged=True)


@pytest.mark.parametrize("staged", [True, False])
def test_k6_staged_and_read_through_at_the_bench_shapes(cuda, staged):
    """The bench's full-feature sources (2 lights x 16 samples, S = 32) at
    512^2 on the Cornell box: K6 with its triangle-major copy staged in
    shared memory and read through the cache, each bit for bit the plain
    version."""
    from raytpu_torch.kernels import intersect as isect
    args = _sweep_inputs(cuda, 512, 2, 16, (-0.5, -0.5))
    dirs, cam, src = args[0], args[6], args[7]
    table = isect.occluded_table(*args[1:6], 512)
    out = isect._outputs(dirs, src.shape[0])
    isect.launch_occluded_multi_kernel(dirs, table, cam, src, *out,
                                       scratch=isect.k6_scratch(table, src),
                                       staged=staged)
    want = isect.sweeps_reference(dirs, table, cam, src)
    torch.cuda.synchronize()
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    assert bool(out[2].any())


@pytest.mark.parametrize("n_lights,samples,kernel", [
    (1, 1, "LAUNCHES_OCCLUDED"), (2, 4, "LAUNCHES_OCCLUDED_MULTI")])
def test_loop_branch_on_gpu_matches_cpu(cuda, n_lights, samples, kernel):
    """The loop branch (AA 3, DoF) on the card, forward and gradients,
    against the CPU path; one intersection launch a sub-ray."""
    from raytpu_torch.kernels import intersect as isect

    def run(device):
        scene, lights, _ = _train_leaves(device)
        lights = Lights.single(capacity=n_lights, soft_samples=4,
                               device=device)
        if n_lights == 2:
            lights = lights.add((0.4, -0.5, -0.7), (1.0, 1.0, 1.0), 7.0)
        for t in vars(lights).values():
            t.requires_grad_(True)
        camera = Camera.raytracer_default(device=device)
        out = raytrace_full(scene, camera, lights, RenderConfig(
            width=64, height=64, mode="parity", aa_samples=3,
            soft_shadow_samples=samples, dof_enabled=True))
        (torch.mean(out.image ** 2)
         + 0.1 * torch.mean(out.focal_distances ** 2)).backward()
        return out, [convert.grads_to_numpy(v) for v in (scene, lights)]

    counts = (render_fused.LAUNCHES, render_fused.LAUNCHES_BWD,
              getattr(isect, kernel))
    got, got_grads = run(cuda)
    assert (render_fused.LAUNCHES, render_fused.LAUNCHES_BWD,
            getattr(isect, kernel)) == (counts[0], counts[1], counts[2] + 9)
    want, want_grads = run("cpu")
    # The card's matmul for the ray directions may fuse its products, so
    # a knife-edge winner can flip (at most 0.1% of pixels).
    bad = (got.image.detach().cpu() - want.image.detach()).abs() > 1e-5
    assert float(bad.any(dim=-1).float().mean()) <= 0.001
    for got_g, want_g in zip(got_grads, want_grads):
        for field in want_g:
            np.testing.assert_allclose(got_g[field], want_g[field], rtol=1e-4,
                                       atol=1e-5, err_msg=field)


def _raster_case(device, name, size):
    """The winner kernels' inputs for a clean frame, as rasterize_exact
    makes them: the Cornell box padded to 32 (one chunk, K8b) at the
    rasteriser camera or off the pixel grid, or a procedural STL mesh (9,028
    or 800 triangles, several chunks, K8c) at the STL camera."""
    import tempfile

    from raytpu_torch.core.stl import load_stl, procedural_stl_text
    from raytpu_torch.kernels import raster
    from raytpu_torch.ops.raster import cull_mask
    from raytpu_torch.render.soft import _screen_vertices
    if name.startswith("stl"):
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/mesh.stl"
            with open(path, "w") as f:
                f.write(procedural_stl_text(*((20, 20) if name == "stl800"
                                              else ())))
            scene = load_stl(path, device=device)
        camera = Camera.make((0.0, -0.5, -5.0), focal=float(size),
                             device=device)
    else:
        scene = cornell_box(pad_to=32, device=device)
        camera = (Camera.rasterizer_default(device=device)
                  if name == "cornell" else
                  Camera.make((0.011, -0.007, -3.013), focal=size + 0.23,
                              y_scale=1.01, device=device))
    cfg = RenderConfig(width=size, height=size, mode="clean")
    sx, sy, zinv, _ = _screen_vertices(scene, camera, cfg)
    keep = cull_mask(scene, camera, cfg.replace(frustum_cull=False))
    consts = raster.raster_tri_constants(sx, sy, zinv, keep)
    mask = raster.chunk_screen_mask(
        sx, sy, zinv, consts[:, 12], raster.tile_rects(size, size, device),
        raster.MAX_CHUNK) if consts.shape[0] > raster.MAX_CHUNK else None
    return consts, mask


@pytest.mark.parametrize("name,size", [
    ("cornell", 512), ("offgrid", 257), ("stl", 500), ("stl800", 129)])
def test_raster_kernels_match_plain_version(cuda, name, size):
    """K8b (one chunk) or K8c (several, with the mask and with the mask
    forced to all ones) against the plain version: identical winners, two
    calls identical."""
    from raytpu_torch.kernels import raster
    consts, mask = _raster_case(cuda, name, size)
    if mask is None:
        before = raster.LAUNCHES_WINNER
        got = raster.raster_winner(consts, size, size)
        again = raster.raster_winner(consts, size, size)
        assert raster.LAUNCHES_WINNER == before + 2
        want = raster.resolve_winner_reference(consts, size, size)
    else:
        before = raster.LAUNCHES_WINNER_MASKED
        got = raster.raster_winner_masked(consts, size, size, mask, 128)
        again = raster.raster_winner_masked(consts, size, size, mask, 128)
        ones = torch.ones_like(mask)
        got_ones = raster.raster_winner_masked(consts, size, size, ones, 128)
        assert raster.LAUNCHES_WINNER_MASKED == before + 3
        want = raster.resolve_winner_masked_reference(consts, size, size,
                                                      mask, 128)
        assert torch.equal(got_ones, got)
        assert 0.0 < float(mask.float().mean()) < 1.0
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == (size * size,)
    assert torch.equal(got, want) and torch.equal(got, again)
    assert float((got >= 0).float().mean()) > 0.1


def test_rasterize_on_gpu_matches_cpu(cuda):
    """Clean frames (K8b, and K8c on the 800-triangle mesh) and the raster
    step's gradients on the card against the CPU path."""
    import tempfile

    from raytpu_torch.core.stl import load_stl, procedural_stl_text
    from raytpu_torch.kernels import raster
    from raytpu_torch.render.rasterize import rasterize
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/mesh.stl"
        with open(path, "w") as f:
            f.write(procedural_stl_text(20, 20))

        def run(device):
            scene = cornell_box(pad_to=32, device=device)
            lights = Lights.single(capacity=1, device=device)
            for t in (*vars(scene).values(), *vars(lights).values()):
                t.requires_grad_(True)
            camera = Camera.make((0.011, -0.007, -3.013), focal=64.23,
                                 y_scale=1.01, device=device)
            cfg = RenderConfig(width=64, height=64, mode="clean")
            img = rasterize(scene, camera, lights, cfg)
            torch.mean((img - 0.3) ** 2).backward()
            with torch.no_grad():
                stl = rasterize(load_stl(path, device=device),
                                Camera.make((0.0, -0.5, -5.0), focal=64.0,
                                            device=device),
                                Lights.single(capacity=1, device=device),
                                cfg)
            return img.detach(), stl, [convert.grads_to_numpy(v)
                                       for v in (scene, lights)]

        counts = (raster.LAUNCHES_WINNER, raster.LAUNCHES_WINNER_MASKED)
        got = run(cuda)
        assert (raster.LAUNCHES_WINNER, raster.LAUNCHES_WINNER_MASKED) == (
            counts[0] + 1, counts[1] + 1)
        want = run("cpu")
    for g, w in zip(got[:2], want[:2]):
        assert float((g.cpu() - w).abs().max()) <= 1e-5
    for got_g, want_g in zip(got[2], want[2]):
        for field in want_g:
            np.testing.assert_allclose(got_g[field], want_g[field], rtol=1e-4,
                                       atol=1e-5, err_msg=field)


def test_raster_wrappers_check_their_inputs(cuda):
    from raytpu_torch.kernels import raster
    consts, mask = _raster_case(cuda, "stl800", 64)
    with pytest.raises(ValueError):
        raster.raster_winner(consts, 64, 64)  # more than one chunk
    with pytest.raises(ValueError):
        raster.raster_winner_masked(consts, 64, 64, mask.long(), 128)
    with pytest.raises(ValueError):
        raster.raster_winner_masked(consts, 64, 64, mask.cpu(), 128)
    with pytest.raises(ValueError):
        raster.raster_winner_masked(consts.double(), 64, 64, mask, 128)
    with pytest.raises(ValueError):
        raster.raster_winner_masked(consts, 80, 64, mask, 128)


def _soft_case(device, name, size=64):
    """The soft kernels' inputs at a small size: the (Tp, 32) table, its
    chunk, sharpness and, for the mesh, its keep-mask. 'cornell': the box
    padded to 32 (one chunk, K9a/K9c); 'mesh': the 800-triangle procedural
    mesh padded to 832 (26 chunks, K9b/K9d with soft_keep_mask)."""
    import tempfile

    from raytpu_torch.core.stl import load_stl, procedural_stl_text
    from raytpu_torch.kernels import soft_raster as sr
    from raytpu_torch.kernels.raster import tile_rects
    from raytpu_torch.render.soft import _screen_vertices
    es = zs = 40.0
    if name == "cornell":
        scene = cornell_box(pad_to=32, device=device)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/mesh.stl"
            with open(path, "w") as f:
                f.write(procedural_stl_text(20, 20))
            scene = load_stl(path, device=device).pad_to(832)
    camera = Camera.make((0.0, 0.0, -3.0), focal=float(size), y_scale=1.01,
                         device=device)
    cfg = RenderConfig(width=size, height=size, mode="soft")
    with torch.no_grad():
        sx, sy, zinv, pos3d = _screen_vertices(scene, camera, cfg)
        consts = sr.soft_tri_constants(sx, sy, zinv, pos3d, scene.color,
                                       scene.normals(), scene.active)
        mask = None
        if name == "mesh":
            mask = sr.soft_keep_mask(tile_rects(size, size, device), consts,
                                     es, zs, sr.MAX_CHUNK)
    return dict(consts=consts.contiguous(), chunk=min(32, consts.shape[0]),
                mask=mask, es=es, zs=zs, H=size, W=size)


def _soft_cot(case, seed=0):
    """(11, R) cotangents of one sign, as chip_smoke.py's: signed ones
    cancel in the sums over pixels until float32 rounding decides the small
    entries."""
    rng = np.random.default_rng(seed)
    R = case["H"] * case["W"]
    return torch.tensor(rng.uniform(0.5, 1.5, (11, R)).astype(np.float32),
                        device=case["consts"].device)


# Column groups of the (Tp, 32) table, as chip_smoke.py's SOFT_GROUPS:
# vertices and edge scales, 1 / area, vertex zinv, the attributes, valid.
# Each is held to the rule scaled by its own largest entry, since 1 / area's
# and valid's gradients are orders of magnitude above the others.
_SOFT_GROUPS = ((0, 32), (0, 9), (9, 10), (10, 13), (13, 28), (28, 29))


def _assert_groups_close(got, want):
    for lo, hi in _SOFT_GROUPS:
        w = want[:, lo:hi].double()
        scale = float(w.abs().max())
        torch.testing.assert_close(got[:, lo:hi].double() / scale, w / scale,
                                   rtol=1e-4, atol=1e-5,
                                   msg=lambda m: f"columns {lo}-{hi - 1}: {m}")


@pytest.mark.parametrize("name", ["cornell", "mesh"])
def test_soft_forward_kernels_match_plain_versions(cuda, name):
    from raytpu_torch.kernels import soft_raster as sr
    c = _soft_case(cuda, name)
    args = (c["consts"], c["H"], c["W"], c["chunk"], c["mask"], c["es"],
            c["zs"])
    counts = (sr.LAUNCHES_SOFT_FWD, sr.LAUNCHES_SOFT_FWD_MASKED)
    got, again = sr.soft_agg_fwd(*args), sr.soft_agg_fwd(*args)
    want = sr.soft_agg_reference(
        c["consts"], sr.pixel_coords(c["H"], c["W"], cuda),
        None if c["mask"] is None else sr.expand_mask(c["mask"], c["H"],
                                                      c["W"]),
        c["es"], c["zs"], c["chunk"])
    masked = c["mask"] is not None
    assert (sr.LAUNCHES_SOFT_FWD, sr.LAUNCHES_SOFT_FWD_MASKED) == (
        counts[0] + 2 * (not masked), counts[1] + 2 * masked)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    if masked:
        assert 0.0 < float(c["mask"].float().mean()) < 1.0
        ones = torch.ones_like(c["mask"])
        full = sr.soft_agg_fwd(c["consts"], c["H"], c["W"], c["chunk"], ones,
                               c["es"], c["zs"])
        plain = sr.soft_agg_fwd(c["consts"], c["H"], c["W"], c["chunk"], None,
                                c["es"], c["zs"])
        for f, p, g in zip(full, plain, got):
            assert torch.equal(f, p)  # K9b with all ones is K9a, bitwise
            torch.testing.assert_close(g, p, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["cornell", "mesh"])
def test_soft_backward_kernels_match_plain_float64(cuda, name):
    """K9c/K9d against the plain backward in float64 with the float32
    branch decisions (Kinks) and against the plain float32 version, the
    JAX tests' rule after scaling, over the whole table and over each
    column group by its own largest entry; two calls bit-identical."""
    from raytpu_torch.kernels import soft_raster as sr
    c = _soft_case(cuda, name)
    _, m, _ = sr.soft_agg_fwd(c["consts"], c["H"], c["W"], c["chunk"],
                              c["mask"], c["es"], c["zs"])
    cot = _soft_cot(c)
    args = (c["consts"], m, cot, c["H"], c["W"], c["chunk"], c["mask"],
            c["es"], c["zs"])
    got, again = sr.soft_agg_bwd(*args), sr.soft_agg_bwd(*args)
    pix = None if c["mask"] is None else sr.expand_mask(c["mask"], c["H"],
                                                        c["W"])
    want = sr.soft_agg_bwd_reference(
        c["consts"].double(),
        sr.pixel_coords(c["H"], c["W"], cuda, torch.float64), pix,
        m.double(), cot.double(), c["es"], c["zs"], c["chunk"],
        branches_from=c["consts"])
    plain32 = sr.soft_agg_bwd_reference(
        c["consts"], sr.pixel_coords(c["H"], c["W"], cuda), pix, m, cot,
        c["es"], c["zs"], c["chunk"])
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all()) and not got[:, 29:].any()
    _assert_groups_close(got, want)
    _assert_groups_close(got, plain32)


def _soft_bwd_and_plain(c, mask, cot=None):
    """K9c/K9d (mask None or not), twice, and the plain float32 and float64
    backwards on a _soft_case with the forward's saved max under ``mask``."""
    from raytpu_torch.kernels import soft_raster as sr
    _, m, _ = sr.soft_agg_fwd(c["consts"], c["H"], c["W"], c["chunk"], mask,
                              c["es"], c["zs"])
    cot = _soft_cot(c) if cot is None else cot
    args = (c["consts"], m, cot, c["H"], c["W"], c["chunk"], mask, c["es"],
            c["zs"])
    got, again = sr.soft_agg_bwd(*args), sr.soft_agg_bwd(*args)
    pix = None if mask is None else sr.expand_mask(mask, c["H"], c["W"])
    coords = sr.pixel_coords(c["H"], c["W"], c["consts"].device)
    plain32 = sr.soft_agg_bwd_reference(c["consts"], coords, pix, m, cot,
                                        c["es"], c["zs"], c["chunk"])
    want = sr.soft_agg_bwd_reference(
        c["consts"].double(), coords.double(), pix, m.double(),
        cot.double(), c["es"], c["zs"], c["chunk"],
        branches_from=c["consts"])
    torch.cuda.synchronize()
    return got, again, plain32, want, m


def test_k9d_with_a_tile_that_keeps_every_chunk(cuda):
    """K9d on the mesh's mask with one tile keeping every chunk (26 runs of
    one tile on that chunk row's lists): the JAX tests' rule against the
    plain float32 and float64 backwards by column group, two calls
    identical; an all-ones mask is K9c bit for bit."""
    from raytpu_torch.kernels import soft_raster as sr
    c = _soft_case(cuda, "mesh")
    mask = c["mask"].clone()
    mask[mask.shape[0] // 2 + 3] = 1
    assert bool(mask.all(dim=1).any()) and not bool(mask.all())
    got, again, plain32, want, m = _soft_bwd_and_plain(c, mask)
    assert torch.equal(got, again)
    _assert_groups_close(got, want)
    _assert_groups_close(got, plain32)
    ones = torch.ones_like(mask)
    cot = _soft_cot(c, seed=4)
    args = (c["consts"], m, cot, c["H"], c["W"], c["chunk"])
    full = sr.soft_agg_bwd(*args, ones, c["es"], c["zs"])
    plain = sr.soft_agg_bwd(*args, None, c["es"], c["zs"])
    torch.cuda.synchronize()
    assert torch.equal(full.view(torch.int32), plain.view(torch.int32))


@pytest.mark.parametrize("name", ["cornell", "mesh"])
@pytest.mark.parametrize("value", [float("nan"), float("inf")])
def test_soft_backward_with_non_finite_cotangents(cuda, name, value):
    """A NaN (an inf) cotangent on a few pixels: the kernel takes every
    pair of those pixels (its dead test leaves them alone), so the rows
    with a non-finite entry are exactly the rows of the chunks their tiles
    keep (every row for K9c), two calls agree bit for bit, and every other
    row is within the rule of the plain float32 version with those
    entries 0. (The plain version's own NaN reaches rows a mask drops too:
    its masked weight 0 times the NaN.)"""
    from raytpu_torch.kernels import soft_raster as sr
    c = _soft_case(cuda, name)
    cot, clean = _soft_cot(c), _soft_cot(c)
    bad = ((0, 700), (4, 2100), (9, 3333)) if value != value else (
        (7, 1500),)
    tiles_x = -(-c["W"] // sr.TILE)
    touched = torch.zeros(c["consts"].shape[0], dtype=torch.bool,
                          device=cuda)
    for row, pixel in bad:
        cot[row, pixel] = value
        clean[row, pixel] = 0.0
        y, x = divmod(pixel, c["W"])
        tile = (y // sr.TILE) * tiles_x + x // sr.TILE
        keep = (torch.ones(c["consts"].shape[0] // c["chunk"],
                           dtype=torch.bool, device=cuda)
                if c["mask"] is None else c["mask"][tile] != 0)
        touched |= keep.repeat_interleave(c["chunk"])
    got, again, _, _, _ = _soft_bwd_and_plain(c, c["mask"], cot)
    _, _, plain32, _, _ = _soft_bwd_and_plain(c, c["mask"], clean)
    assert torch.equal((~torch.isfinite(got)).any(dim=1), touched)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    if c["mask"] is not None:
        assert 0 < int(touched.sum()) < touched.numel()
        _assert_groups_close(got[~touched], plain32[~touched])


def test_fit_step_launches_k9a_and_k9c_once(cuda):
    from raytpu_torch.kernels import intersect, raster
    from raytpu_torch.kernels import soft_raster as sr
    from raytpu_torch.opt.fit import FitConfig, fit

    def counts():
        return (render_fused.LAUNCHES, render_fused.LAUNCHES_BWD,
                render_fused.LAUNCHES_SCATTER, intersect.LAUNCHES_OCCLUDED,
                intersect.LAUNCHES_OCCLUDED_MULTI, raster.LAUNCHES_WINNER,
                raster.LAUNCHES_WINNER_MASKED, sr.LAUNCHES_SOFT_FWD,
                sr.LAUNCHES_SOFT_FWD_MASKED, sr.LAUNCHES_SOFT_BWD,
                sr.LAUNCHES_SOFT_BWD_MASKED)

    camera = Camera.make((0.0, 0.0, -3.0), focal=48.0, y_scale=1.01,
                         device=cuda)
    target = torch.full((40, 48, 3), 0.3, device=cuda)
    before = counts()
    res = fit(target, cornell_box(device=cuda), camera,
              Lights.single(capacity=1, device=cuda),
              RenderConfig(width=48, height=40, mode="soft"),
              FitConfig(steps=3, stages=((10.0, 20.0, 1.0),), log_every=0))
    delta = [a - b for a, b in zip(counts(), before)]
    assert delta == [0] * 7 + [3, 0, 3, 0]
    assert np.isfinite(res.losses).all() and res.losses[-1] < res.losses[0]


def test_soft_wrappers_check_their_inputs(cuda):
    from raytpu_torch.kernels import soft_raster as sr
    c = _soft_case(cuda, "mesh")
    args = (c["H"], c["W"], c["chunk"])
    with pytest.raises(ValueError):
        sr.soft_agg_fwd(c["consts"], *args, c["mask"].long(), 40.0, 40.0)
    with pytest.raises(ValueError):
        sr.soft_agg_fwd(c["consts"], *args, c["mask"].cpu(), 40.0, 40.0)
    with pytest.raises(ValueError):
        sr.soft_agg_fwd(c["consts"].double(), *args, None, 40.0, 40.0)
    with pytest.raises(ValueError):
        sr.soft_agg_fwd(c["consts"], c["H"], c["W"], 33, None, 40.0, 40.0)
    m = torch.zeros(c["H"] * c["W"], device=cuda)
    with pytest.raises(ValueError):
        sr.soft_agg_bwd(c["consts"], m, _soft_cot(c)[:10], *args, None, 40.0,
                        40.0)


def _srt_case(device, name, size=64):
    """The soft raytrace kernels' inputs at a small size, cull=False: both
    tables, the rays, the chunk, sharpness, four shadow sources and the
    aggregated hit positions of the plain forward. 'cornell': the box
    padded to 32 (one chunk); 'mesh': the 800-triangle procedural mesh
    padded to 832 (26 chunks)."""
    import tempfile

    from raytpu_torch.core.stl import load_stl, procedural_stl_text
    from raytpu_torch.kernels import soft_raytrace as srt
    from raytpu_torch.render.soft import raytrace_soft_inputs
    if name == "cornell":
        scene = cornell_box(pad_to=32, device=device)
        camera = Camera.make((0.0, 0.0, -2.0), focal=size / 2.0,
                             device=device)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/mesh.stl"
            with open(path, "w") as f:
                f.write(procedural_stl_text(20, 20))
            scene = load_stl(path, device=device).pad_to(832)
        camera = Camera.make((0.0, -0.5, -5.0), focal=size / 2.0,
                             device=device)
    cfg = RenderConfig(width=size, height=size, mode="soft",
                       soft_edge_sharpness=40.0, soft_z_sharpness=40.0)
    with torch.no_grad():
        pri, shw, dirs, chunk, es, zs, _, _ = raytrace_soft_inputs(
            scene, camera, cfg, cull=False)
        out, _, _ = srt.primary_agg_reference(pri, camera.pos, dirs, es, zs,
                                              chunk)
    srcs = torch.tensor([[0.0, -0.5, -0.7], [0.03, -0.52, -0.69],
                         [0.4, -0.5, -0.7], [0.38, -0.47, -0.72]],
                        device=device)
    return dict(pri=pri.contiguous(), shw=shw.contiguous(), dirs=dirs,
                cam=camera.pos.contiguous(), chunk=chunk, es=es, zs=zs,
                srcs=srcs, world=out[3:6].contiguous())


def _one_signed(shape, device, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.uniform(0.5, 1.5, shape).astype(np.float32),
                        device=device)


def _rule(got, want):
    """Largest |got - want| over the rtol 1e-4 / atol 1e-5 bound scaled by
    want's largest entry: <= 1 passes."""
    got, want = got.double(), want.double()
    scale = max(float(want.abs().max()), 1e-30)
    return float(((got - want).abs() / (1e-5 * scale + 1e-4 * want.abs()))
                 .max())


def _assert_float64_rule(got, want64, plain32, groups, slack=1.01):
    """Each column group: within the rule of the plain float32 version, and
    of the float64 evaluation or no farther from it than that version
    (ROADMAP fault F11), up to a factor ``slack``."""
    for name, lo, hi in groups:
        g, w, p = (t[..., lo:hi] for t in (got, want64, plain32))
        assert _rule(g, p) <= 1.0, name
        assert _rule(g, w) <= max(1.0, slack * _rule(p, w)), name


@pytest.mark.parametrize("name", ["cornell", "mesh"])
def test_soft_raytrace_forward_kernels_match_plain_versions(cuda, name):
    from raytpu_torch.kernels import soft_raytrace as srt
    c = _srt_case(cuda, name)
    counts = (srt.LAUNCHES_SRT_PRI_FWD, srt.LAUNCHES_SRT_SHW_FWD)
    pargs = (c["pri"], c["cam"], c["dirs"], c["es"], c["zs"], c["chunk"])
    got, again = srt.primary_agg_fwd(*pargs), srt.primary_agg_fwd(*pargs)
    want = srt.primary_agg_reference(*pargs)
    sargs = (c["shw"], c["srcs"], c["world"], c["es"], c["zs"], c["chunk"])
    trans, trans2 = srt.shadow_trans_fwd(*sargs), srt.shadow_trans_fwd(*sargs)
    trans_want = srt.shadow_trans_reference(*sargs)
    torch.cuda.synchronize()
    assert (srt.LAUNCHES_SRT_PRI_FWD, srt.LAUNCHES_SRT_SHW_FWD) == (
        counts[0] + 2, counts[1] + 2)
    for g, a, w in zip((*got, trans), (*again, trans2), (*want, trans_want)):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    # Surfaces in view: a logit above the background's.
    assert float((got[1] > 1.0).float().mean()) > 0.05


@pytest.mark.parametrize("name", ["cornell", "mesh"])
def test_soft_raytrace_backward_kernels_match_plain_float64(cuda, name):
    """K10c/K10i against the plain backward in float64 with the float32
    branch decisions (Kinks) and against the plain float32 version, by
    column group; two calls bit-identical."""
    from raytpu_torch.kernels import soft_raytrace as srt
    c = _srt_case(cuda, name)
    R = c["dirs"].shape[1]
    _, m, _ = srt.primary_agg_fwd(c["pri"], c["cam"], c["dirs"], c["es"],
                                  c["zs"], c["chunk"])
    cot = _one_signed((10, R), cuda, 0)
    pargs = (c["pri"], c["cam"], c["dirs"], m, cot, c["es"], c["zs"],
             c["chunk"])
    got, again = srt.primary_agg_bwd(*pargs), srt.primary_agg_bwd(*pargs)
    want = srt.primary_agg_bwd_reference(
        *(t.double() for t in pargs[:5]), *pargs[5:], f32_branches=True)
    plain = srt.primary_agg_bwd_reference(*pargs)
    trans = srt.shadow_trans_fwd(c["shw"], c["srcs"], c["world"], c["es"],
                                 c["zs"], c["chunk"])
    gcot = _one_signed(trans.shape, cuda, 1)
    sargs = (c["shw"], c["srcs"], c["world"], trans, gcot, c["es"], c["zs"],
             c["chunk"])
    sgot, sagain = srt.shadow_trans_bwd(*sargs), srt.shadow_trans_bwd(*sargs)
    swant = srt.shadow_trans_bwd_reference(
        *(t.double() for t in sargs[:5]), *sargs[5:], f32_branches=True)
    splain = srt.shadow_trans_bwd_reference(*sargs)
    torch.cuda.synchronize()
    for g, a in zip((*got, *sgot), (*again, *sagain)):
        assert torch.equal(g, a) and bool(torch.isfinite(g).all())
    assert not got[0][:, srt.PRI_USED:].any()
    assert not sgot[0][:, srt.SHW_USED:].any()
    _assert_float64_rule(got[0], want[0], plain[0], srt.PRI_GROUPS)
    one = (("all", 0, 3),)
    _assert_float64_rule(got[1][None], want[1][None], plain[1][None], one)
    _assert_float64_rule(got[2].T, want[2].T, plain[2].T, one)
    _assert_float64_rule(sgot[0], swant[0], splain[0], srt.SHW_GROUPS)
    _assert_float64_rule(sgot[1], swant[1], splain[1], one)
    _assert_float64_rule(sgot[2].T, swant[2].T, splain[2].T, one)


def test_raytrace_fit_step_launches_each_k10_kernel_once(cuda):
    from raytpu_torch.kernels import intersect, raster
    from raytpu_torch.kernels import soft_raster as sr
    from raytpu_torch.kernels import soft_raytrace as srt
    from raytpu_torch.opt.fit import FitConfig, fit

    def counts():
        return (render_fused.LAUNCHES, render_fused.LAUNCHES_BWD,
                render_fused.LAUNCHES_SCATTER, intersect.LAUNCHES_OCCLUDED,
                intersect.LAUNCHES_OCCLUDED_MULTI, raster.LAUNCHES_WINNER,
                raster.LAUNCHES_WINNER_MASKED, sr.LAUNCHES_SOFT_FWD,
                sr.LAUNCHES_SOFT_FWD_MASKED, sr.LAUNCHES_SOFT_BWD,
                sr.LAUNCHES_SOFT_BWD_MASKED, srt.LAUNCHES_SRT_PRI_FWD,
                srt.LAUNCHES_SRT_PRI_BWD, srt.LAUNCHES_SRT_SHW_FWD,
                srt.LAUNCHES_SRT_SHW_BWD)

    camera = Camera.make((0.0, 0.0, -3.0), focal=48.0, y_scale=1.01,
                         device=cuda)
    target = torch.full((40, 48, 3), 0.3, device=cuda)
    before = counts()
    res = fit(target, cornell_box(device=cuda), camera,
              Lights.single(capacity=1, device=cuda),
              RenderConfig(width=48, height=40, mode="soft"),
              FitConfig(steps=3, stages=((40.0, 200.0, 1.0),), log_every=0,
                        renderer="raytrace"))
    delta = [a - b for a, b in zip(counts(), before)]
    assert delta == [0] * 11 + [3, 3, 3, 3]
    assert np.isfinite(res.losses).all() and res.losses[-1] < res.losses[0]


def test_soft_raytrace_on_gpu_matches_cpu(cuda):
    """The whole soft frame and its gradients on the card against the CPU
    (the plain versions)."""
    from raytpu_torch.render.soft import raytrace_soft

    def run(device):
        scene = cornell_box(pad_to=32, device=device)
        camera = Camera.raytracer_default(device=device)
        lights = Lights.single(capacity=2, soft_samples=4, device=device)
        for t in (scene.v0, camera.pos, lights.jitter):
            t.requires_grad_(True)
        img = raytrace_soft(scene, camera, lights, RenderConfig(
            width=48, height=40, mode="soft", soft_shadow_samples=4,
            soft_edge_sharpness=60.0, soft_z_sharpness=60.0))
        torch.sin(3.0 * img).sum().backward()
        return [t.detach().cpu() for t in (img, scene.v0.grad,
                                           camera.pos.grad,
                                           lights.jitter.grad)]

    for got, want in zip(run(cuda), run("cpu")):
        scale = max(float(want.abs().max()), 1e-8)
        torch.testing.assert_close(got / scale, want / scale, rtol=0,
                                   atol=2e-4)


def test_soft_raytrace_wrappers_check_their_inputs(cuda):
    from raytpu_torch.kernels import soft_raytrace as srt
    c = _srt_case(cuda, "cornell", size=16)
    with pytest.raises(ValueError):
        srt.primary_agg_fwd(c["pri"].double(), c["cam"], c["dirs"], 40.0,
                            40.0, c["chunk"])
    with pytest.raises(ValueError):
        srt.primary_agg_fwd(c["pri"], c["cam"].cpu(), c["dirs"], 40.0, 40.0,
                            c["chunk"])
    with pytest.raises(ValueError):
        srt.primary_agg_fwd(c["pri"], c["cam"], c["dirs"].T, 40.0, 40.0,
                            c["chunk"])
    with pytest.raises(ValueError):
        srt.shadow_trans_fwd(c["shw"], c["srcs"], c["world"], 40.0, 40.0, 33)
    with pytest.raises(ValueError):
        srt.shadow_trans_bwd(c["shw"], c["srcs"], c["world"],
                             torch.zeros(3, 5, device=cuda),
                             torch.zeros(3, 5, device=cuda), 40.0, 40.0,
                             c["chunk"])


def _srt_culled_case(device, H, W, samples=1):
    """The masked soft raytrace kernels' inputs on an H x W frame of the
    800-triangle procedural mesh (25 chunks of 32) from the STL camera:
    the culled frame's tables, rays, tiles and primary mask
    (render/soft.py::raytrace_soft_inputs with cull=True; the tiles are the
    port's 16 x 16 blocks, padded where H or W is not a multiple of 16),
    the aggregated hit positions of the plain masked forward, the shadow
    sources (one light, or its first ``samples`` jittered positions) and
    their shadow mask."""
    import tempfile

    from raytpu_torch.core.stl import load_stl, procedural_stl_text
    from raytpu_torch.kernels import soft_raytrace as srt
    from raytpu_torch.kernels.intersect import TILE_RAYS, ray_tiles
    from raytpu_torch.ops.shade import source_positions
    from raytpu_torch.render.soft import raytrace_soft_inputs
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/mesh.stl"
        with open(path, "w") as f:
            f.write(procedural_stl_text(20, 20))
        scene = load_stl(path, device=device)
    camera = Camera.make((0.0, -0.5, -5.0), focal=max(H, W) * 0.6,
                         device=device)
    lights = Lights.single(capacity=1, soft_samples=16,
                           position=(0.3, -1.5, -3.0), device=device)
    cfg = RenderConfig(width=W, height=H, mode="soft",
                       soft_edge_sharpness=40.0, soft_z_sharpness=40.0)
    with torch.no_grad():
        inp = raytrace_soft_inputs(scene, camera, cfg, cull=False)
        tiles = ray_tiles(H * W, (H, W), device)
        mask = srt.soft_rt_keep_mask(
            inp.dirs.T[tiles.rays], camera.pos, scene.v0, scene.v1,
            scene.v2, inp.es, inp.zs, srt.T_NEAR, TILE_RAYS, inp.chunk)
        out, _, _ = srt.primary_agg_reference(inp.pri, camera.pos, inp.dirs,
                                              inp.es, inp.zs, inp.chunk,
                                              mask, tiles)
        srcs = source_positions(lights, samples).contiguous()
        world = out[3:6].contiguous()
        smask = srt.soft_rt_shadow_mask(
            world.T[tiles.rays], srcs, scene.v0, scene.v1, scene.v2, inp.es,
            inp.zs, TILE_RAYS, inp.chunk)
    return dict(pri=inp.pri, shw=inp.shw, dirs=inp.dirs,
                cam=camera.pos.contiguous(), chunk=inp.chunk, es=inp.es,
                zs=inp.zs, tiles=tiles, mask=mask, srcs=srcs, world=world,
                smask=smask)


@pytest.mark.parametrize("H,W,samples", [(64, 64, 1), (40, 72, 16)],
                         ids=["64x64-s1", "40x72-s16"])
def test_masked_soft_raytrace_forward_kernels_match_plain_versions(
        cuda, H, W, samples):
    """K10b and K10h against their plain versions (rtol 1e-5 / atol 1e-6),
    two calls identical, with every bit set equal to K10a and K10g bit for
    bit, and within the JAX rule of the brute frame; 40 x 72 pads its
    tiles on both sides."""
    from raytpu_torch.kernels import soft_raytrace as srt
    c = _srt_culled_case(cuda, H, W, samples)
    assert 0 < int(c["mask"].sum()) < c["mask"].numel()
    counts = (srt.LAUNCHES_SRT_PRI_FWD_MASKED,
              srt.LAUNCHES_SRT_SHW_FWD_MASKED)
    pargs = (c["pri"], c["cam"], c["dirs"], c["es"], c["zs"], c["chunk"])
    got = srt.primary_agg_fwd(*pargs, c["mask"], c["tiles"])
    again = srt.primary_agg_fwd(*pargs, c["mask"], c["tiles"])
    want = srt.primary_agg_reference(*pargs, c["mask"], c["tiles"])
    ones = srt.primary_agg_fwd(*pargs, torch.ones_like(c["mask"]),
                               c["tiles"])
    brute = srt.primary_agg_fwd(*pargs)
    sargs = (c["shw"], c["srcs"], c["world"], c["es"], c["zs"], c["chunk"])
    trans = srt.shadow_trans_fwd(*sargs, c["smask"], c["tiles"])
    trans2 = srt.shadow_trans_fwd(*sargs, c["smask"], c["tiles"])
    twant = srt.shadow_trans_reference(*sargs, c["smask"], c["tiles"])
    tones = srt.shadow_trans_fwd(*sargs, torch.ones_like(c["smask"]),
                                 c["tiles"])
    tbrute = srt.shadow_trans_fwd(*sargs)
    torch.cuda.synchronize()
    assert (srt.LAUNCHES_SRT_PRI_FWD_MASKED,
            srt.LAUNCHES_SRT_SHW_FWD_MASKED) == (counts[0] + 3,
                                                 counts[1] + 3)
    for g, a, w, o, b in zip((*got, trans), (*again, trans2),
                             (*want, twant), (*ones, tones),
                             (*brute, tbrute)):
        assert torch.equal(g, a) and torch.equal(o, b)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[0], brute[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(trans, tbrute, rtol=1e-6, atol=1e-6)
    assert float((got[1] > 1.0).float().mean()) > 0.05


@pytest.mark.parametrize("kind", ["one-tile", "thin"])
def test_masked_primary_forward_on_crowded_and_thin_masks(cuda, kind):
    """K10b on a mask whose kept chunks all sit in one tile (it keeps every
    chunk, cut into several work items and merged; the others keep none)
    and on a thin one (at most one chunk a tile): against the plain masked
    forward (rtol 1e-5 / atol 1e-6), against the plain model of its items
    and merge (primary_agg_items) with m bit for bit, two calls identical,
    one launch a call, and with every bit set on the same tiles equal to
    K10a bit for bit."""
    from raytpu_torch.kernels import soft_raytrace as srt
    c = _srt_culled_case(cuda, 64, 64)
    n_tiles, n_chunks = c["mask"].shape
    mask = torch.zeros_like(c["mask"])
    if kind == "one-tile":
        mask[5] = 1  # a tile of the torus's middle rows
    else:
        rng = np.random.default_rng(3)
        mask[torch.arange(n_tiles), torch.tensor(
            rng.integers(0, n_chunks, n_tiles))] = 1
    pargs = (c["pri"], c["cam"], c["dirs"], c["es"], c["zs"], c["chunk"])
    before = srt.LAUNCHES_SRT_PRI_FWD_MASKED
    got = srt.primary_agg_fwd(*pargs, mask, c["tiles"])
    again = srt.primary_agg_fwd(*pargs, mask, c["tiles"])
    assert srt.LAUNCHES_SRT_PRI_FWD_MASKED == before + 2
    want = srt.primary_agg_reference(*pargs, mask, c["tiles"])
    model = srt.primary_agg_items(*pargs, mask, c["tiles"])
    ones = srt.primary_agg_fwd(*pargs, torch.ones_like(mask), c["tiles"])
    brute = srt.primary_agg_fwd(*pargs)
    torch.cuda.synchronize()
    run, items = srt.primary_fwd_items(mask.cpu(), n_tiles, n_chunks,
                                       c["dirs"].shape[1])
    if kind == "one-tile":
        assert len(items) > 1 and {t for t, _ in items} == {5}
    for g, a, w, d, o, b in zip(got, again, want, model, ones, brute):
        assert torch.equal(g, a) and torch.equal(o, b)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(g, d, rtol=1e-5, atol=1e-6)
    assert torch.equal(got[1], model[1])
    dropped = (mask[c["tiles"].tile] == 0).all(dim=1)
    assert not got[0][:, dropped].any() and (got[2][dropped] == 1).all()
    assert (got[1][~dropped] > 1.0).any()


def test_primary_forward_on_the_largest_table(cuda, monkeypatch):
    """K10a on phase 32's 66,560-triangle torus (2,080 chunks) at 64^2:
    its 16 tiles cut into 64 work items each, with a scratch within the
    bound of the design (the staged rows and n_tiles (splits + 1) partials
    of 11 floats a ray, whatever the table's size); against the plain
    forward (rtol 1e-5 / atol 1e-6); and against one item a tile (the
    rule's split forced to 1, no merge): m bit for bit, out and s within
    rtol 1e-5 / atol 1e-6."""
    from raytpu_torch.kernels import soft_raytrace as srt
    pargs = _two_launch_case(cuda, (256, 130), 64)[0]
    consts, cam, dirs, _, _, es, zs, chunk = pargs
    Tp, R = consts.shape[0], dirs.shape[1]
    n_tiles, n_chunks = R // srt.THREADS, Tp // chunk
    assert (Tp, n_chunks) == (66560, 2080)
    run, items = srt.primary_fwd_items(None, n_tiles, n_chunks, R)
    assert len(items) == n_tiles * 64
    splits = -(-srt.PRI_FWD_ITEMS // n_tiles)
    assert srt.pri_fwd_scratch(consts, chunk, dirs).numel() <= (
        Tp * 96 + n_tiles * (splits + 1) * 11 * srt.THREADS * 4 + 64)
    args = (consts, cam, dirs, es, zs, chunk)
    got = srt.primary_agg_fwd(*args)
    want = srt.primary_agg_reference(*args)
    monkeypatch.setattr(srt, "PRI_FWD_ITEMS", 1)
    assert srt.primary_fwd_items(None, n_tiles, n_chunks, R)[0] == n_chunks
    whole = srt.primary_agg_fwd(*args)
    torch.cuda.synchronize()
    for g, w, o in zip(got, want, whole):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(g, o, rtol=1e-5, atol=1e-6)
    assert torch.equal(got[1], whole[1])
    assert float((got[1] > 1.0).float().mean()) > 0.05


@pytest.mark.parametrize("H,W,samples", [(64, 64, 1), (40, 72, 16)],
                         ids=["64x64-s1", "40x72-s16"])
def test_masked_soft_raytrace_backward_kernels_match_plain_float64(
        cuda, H, W, samples):
    """K10d and K10j against the plain masked backward in float64 with the
    float32 branch decisions and against the plain float32 version, by
    column group; two calls bit-identical; a chunk no tile keeps gets
    exactly 0. With every bit set, the per-ray gradients (d dirs, d world)
    equal K10c's and K10i's bit for bit on the 16 x 16 tiles, and every
    gradient does on tiles of 256 consecutive rays, K10c's own blocks (the
    sums over rays add the same terms in the same order only there)."""
    from raytpu_torch.kernels import soft_raytrace as srt
    from raytpu_torch.kernels.intersect import ray_tiles
    c = _srt_culled_case(cuda, H, W, samples)
    R, tiles = c["dirs"].shape[1], c["tiles"]
    runs = ray_tiles(R, None, cuda)
    n_chunks = c["pri"].shape[0] // c["chunk"]
    S = c["srcs"].shape[0]
    _, m, _ = srt.primary_agg_fwd(c["pri"], c["cam"], c["dirs"], c["es"],
                                  c["zs"], c["chunk"], c["mask"], tiles)
    cot = _one_signed((10, R), cuda, 0)
    pargs = (c["pri"], c["cam"], c["dirs"], m, cot, c["es"], c["zs"],
             c["chunk"])
    cull = dict(mask=c["mask"], tiles=tiles)
    got, again = (srt.primary_agg_bwd(*pargs, **cull),
                  srt.primary_agg_bwd(*pargs, **cull))
    want = srt.primary_agg_bwd_reference(
        *(t.double() for t in pargs[:5]), *pargs[5:], f32_branches=True,
        **cull)
    plain = srt.primary_agg_bwd_reference(*pargs, **cull)
    ones = srt.primary_agg_bwd(*pargs, mask=torch.ones_like(c["mask"]),
                               tiles=tiles)
    ones_runs = srt.primary_agg_bwd(
        *pargs, mask=torch.ones((runs.count, n_chunks), dtype=torch.int32,
                                device=cuda), tiles=runs)
    brute = srt.primary_agg_bwd(*pargs)
    trans = srt.shadow_trans_fwd(c["shw"], c["srcs"], c["world"], c["es"],
                                 c["zs"], c["chunk"], c["smask"], tiles)
    gcot = _one_signed(trans.shape, cuda, 1)
    sargs = (c["shw"], c["srcs"], c["world"], trans, gcot, c["es"], c["zs"],
             c["chunk"])
    scull = dict(mask=c["smask"], tiles=tiles)
    sgot, sagain = (srt.shadow_trans_bwd(*sargs, **scull),
                    srt.shadow_trans_bwd(*sargs, **scull))
    swant = srt.shadow_trans_bwd_reference(
        *(t.double() for t in sargs[:5]), *sargs[5:], f32_branches=True,
        **scull)
    splain = srt.shadow_trans_bwd_reference(*sargs, **scull)
    sones = srt.shadow_trans_bwd(*sargs, mask=torch.ones_like(c["smask"]),
                                 tiles=tiles)
    sones_runs = srt.shadow_trans_bwd(
        *sargs, mask=torch.ones((runs.count, S, n_chunks), dtype=torch.int32,
                                device=cuda), tiles=runs)
    sbrute = srt.shadow_trans_bwd(*sargs)
    torch.cuda.synchronize()
    for g, a in zip((*got, *sgot), (*again, *sagain)):
        assert torch.equal(g, a) and bool(torch.isfinite(g).all())
    for o, b in zip((*ones_runs, *sones_runs), (*brute, *sbrute)):
        assert torch.equal(o, b)
    assert torch.equal(ones[2], brute[2]) and torch.equal(sones[2], sbrute[2])
    dropped = c["mask"].amax(dim=0) == 0
    if bool(dropped.any()):
        assert not got[0].reshape(-1, c["chunk"], srt.PRI_COLS)[
            dropped].any()
    # The masked kernels add a row's terms tile by tile (16 x 16 pixels),
    # in another order than the plain version's sums over the kept rays,
    # so where float32 misses float64 (F11: the sources' 3 entries cancel)
    # they are held within twice the plain float32 version's distance
    # from float64, as chip_smoke.py phase 26 holds culled against brute.
    rule = functools.partial(_assert_float64_rule, slack=2.0)
    rule(got[0], want[0], plain[0], srt.PRI_GROUPS)
    one = (("all", 0, 3),)
    rule(got[1][None], want[1][None], plain[1][None], one)
    rule(got[2].T, want[2].T, plain[2].T, one)
    rule(sgot[0], swant[0], splain[0], srt.SHW_GROUPS)
    rule(sgot[1], swant[1], splain[1], one)
    rule(sgot[2].T, swant[2].T, splain[2].T, one)


@pytest.mark.parametrize("run", [3, None], ids=["runs-of-3", "SHW_RUN"])
def test_masked_shadow_kernels_split_a_full_tile(cuda, monkeypatch, run):
    """K10h and K10j where the first tile keeps every chunk of both sources
    (25 of the 800-triangle torus's) and the others keep about half of what
    the culled frame's mask keeps (a seeded draw): that tile's runs (9 of 3
    chunks, or 2 of SHW_RUN) go to different blocks. Against the plain masked versions (K10h rtol
    1e-5 / atol 1e-6; K10j by column group against float64 with the
    float32 branch decisions, F11's rule), two calls bit-identical, and
    with every bit set the unmasked kernels' d world bit for bit."""
    from raytpu_torch.kernels import soft_raytrace as srt
    if run is not None:
        monkeypatch.setattr(srt, "SHW_RUN", run)
    c = _srt_culled_case(cuda, 48, 48, samples=2)
    draw = np.random.default_rng(4).uniform(size=tuple(c["smask"].shape))
    smask = c["smask"] * torch.tensor(draw < 0.5, device=cuda).int()
    smask[0] = 1
    assert 0 < int(smask[1:].sum()) < smask[1:].numel()
    fargs = (c["shw"], c["srcs"], c["world"], c["es"], c["zs"], c["chunk"])
    cull = dict(mask=smask, tiles=c["tiles"])
    trans = srt.shadow_trans_fwd(*fargs, **cull)
    trans2 = srt.shadow_trans_fwd(*fargs, **cull)
    twant = srt.shadow_trans_reference(*fargs, **cull)
    gcot = _one_signed(trans.shape, cuda, 3)
    sargs = (c["shw"], c["srcs"], c["world"], trans, gcot, c["es"], c["zs"],
             c["chunk"])
    got, again = (srt.shadow_trans_bwd(*sargs, **cull),
                  srt.shadow_trans_bwd(*sargs, **cull))
    want = srt.shadow_trans_bwd_reference(
        *(t.double() for t in sargs[:5]), *sargs[5:], f32_branches=True,
        **cull)
    plain = srt.shadow_trans_bwd_reference(*sargs, **cull)
    ones = srt.shadow_trans_bwd(*sargs, mask=torch.ones_like(smask),
                                tiles=c["tiles"])
    brute = srt.shadow_trans_bwd(*sargs)
    torch.cuda.synchronize()
    assert torch.equal(trans, trans2)
    torch.testing.assert_close(trans, twant, rtol=1e-5, atol=1e-6)
    for g, a in zip(got, again):
        assert torch.equal(g, a) and bool(torch.isfinite(g).all())
    assert torch.equal(ones[2], brute[2])
    one = (("all", 0, 3),)
    rule = functools.partial(_assert_float64_rule, slack=2.0)
    rule(got[0], want[0], plain[0], srt.SHW_GROUPS)
    rule(got[1], want[1], plain[1], one)
    rule(got[2].T, want[2].T, plain[2].T, one)


def test_forward_dead_test_holds_against_the_kernels_sigmoid(cuda):
    """shw_term_dead's premise on the card: on the 800-triangle torus's
    culled frame at S = 16, every triple the plain forward test marks and
    the gate passes has a term, the kernels' sigmoid of xs (built with
    their flags, raytpu_soft_rt_sigmoid) times the active column times
    their sigmoid of y, of +-0; most of those the gate passes are
    marked."""
    from raytpu_torch.kernels import soft_raytrace as srt
    c = _srt_culled_case(cuda, 40, 72, samples=16)
    shw, marked, passing = c["shw"], 0, 0
    for s in range(c["srcs"].shape[0]):
        hit, _, xs, y = srt._shadow_test(shw, c["srcs"][s], c["world"],
                                         c["es"], c["zs"])
        dead = srt.shadow_dead_terms(shw, c["srcs"][s], c["world"], c["es"],
                                     c["zs"]) & hit
        act = shw[:, 13:14].expand_as(xs)[dead]
        term = (srt.sigmoid_probe(xs[dead].contiguous()) * act
                * srt.sigmoid_probe(y[dead].contiguous()))
        torch.cuda.synchronize()
        assert not term.any()
        marked += int(dead.sum())
        passing += int(hit.sum())
    assert marked > 0.5 * passing


def test_culled_soft_raytrace_on_gpu_matches_cpu(cuda):
    """The culled soft frame (W = 40, H = 128: JAX culls in 8 x 128 blocks,
    the port's 16 x 16 tiles pad) and its gradients on the card against the
    CPU, one of each masked kernel and no unmasked one a step."""
    import tempfile

    from raytpu_torch.core.stl import load_stl, procedural_stl_text
    from raytpu_torch.kernels import soft_raytrace as srt
    from raytpu_torch.render.soft import raytrace_soft

    def counts():
        return [getattr(srt, f"LAUNCHES_SRT_{k}") for k in (
            "PRI_FWD", "PRI_BWD", "SHW_FWD", "SHW_BWD", "PRI_FWD_MASKED",
            "PRI_BWD_MASKED", "SHW_FWD_MASKED", "SHW_BWD_MASKED")]

    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/mesh.stl"
        with open(path, "w") as f:
            f.write(procedural_stl_text(5, 7))

        def run(device):
            scene = load_stl(path, device=device)
            camera = Camera.make((0.0, -0.5, -5.0), focal=60.0,
                                 device=device)
            lights = Lights.single(capacity=1, position=(0.3, -1.5, -3.0),
                                   device=device)
            for t in (scene.v0, camera.pos, lights.position):
                t.requires_grad_(True)
            before = counts()
            img = raytrace_soft(scene, camera, lights, RenderConfig(
                width=40, height=128, mode="soft", soft_edge_sharpness=40.0,
                soft_z_sharpness=40.0), cull=True, chunk=8)
            torch.sin(3.0 * img).sum().backward()
            launched = [a - b for a, b in zip(counts(), before)]
            return launched, [t.detach().cpu() for t in (
                img, scene.v0.grad, camera.pos.grad, lights.position.grad)]

        launched, got_all = run(cuda)
        assert launched == [0, 0, 0, 0, 1, 1, 1, 1]
        for got, want in zip(got_all, run("cpu")[1]):
            scale = max(float(want.abs().max()), 1e-8)
            torch.testing.assert_close(got / scale, want / scale, rtol=0,
                                       atol=2e-4)


def test_masked_soft_raytrace_wrappers_check_their_inputs(cuda):
    from raytpu_torch.kernels import soft_raytrace as srt
    c = _srt_culled_case(cuda, 32, 32)
    pargs = (c["pri"], c["cam"], c["dirs"], c["es"], c["zs"], c["chunk"])
    with pytest.raises(ValueError, match="mask"):
        srt.primary_agg_fwd(*pargs, c["mask"].float(), c["tiles"])
    with pytest.raises(ValueError, match="mask"):
        srt.primary_agg_fwd(*pargs, c["mask"][:, :-1].contiguous(),
                            c["tiles"])
    with pytest.raises(ValueError, match="tiles"):
        srt.primary_agg_fwd(c["pri"], c["cam"],
                            c["dirs"][:, :-1].contiguous(), c["es"], c["zs"],
                            c["chunk"], c["mask"], c["tiles"])
    with pytest.raises(ValueError, match="mask"):
        srt.shadow_trans_fwd(c["shw"], c["srcs"], c["world"], c["es"],
                             c["zs"], c["chunk"], c["mask"], c["tiles"])


def _torus(device, quads):
    """The procedural torus of quads[0] x quads[1] quads (two triangles
    each) as a scene on device."""
    import tempfile

    from raytpu_torch.core.stl import load_stl, procedural_stl_text
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/mesh.stl"
        with open(path, "w") as f:
            f.write(procedural_stl_text(*quads))
        return load_stl(path, device=device)


def _assert_f11_rule(got, want64, plain32, groups):
    """Each column group within phase 20's rule (_assert_float64_rule), or,
    where the plain float32 version misses float64 by more than the rule
    (ROADMAP fault F11: at 66,560 rows the sources' 3 entries, a sum of
    millions of cancelling terms, come out 2-7 times the rule from float64
    in every float32 order, the fused K10i's included), within twice that
    version's distance from float64, as chip_smoke.py phase 26 holds
    culled against brute."""
    for name, lo, hi in groups:
        g, w, p = (t[..., lo:hi] for t in (got, want64, plain32))
        r32, r64, f64 = _rule(g, p), _rule(g, w), _rule(p, w)
        assert ((r32 <= 1.0 and r64 <= max(1.0, 1.01 * f64))
                or (f64 > 1.0 and r64 <= 2.0 * f64)), (name, r32, r64, f64)


def _two_launch_case(device, quads, size, width=None, srcs=None):
    """The two-launch backwards' inputs on the torus at size^2, or size x
    width (the STL camera, 40 / 40, cull=False), two shadow sources (or
    srcs (S, 3)): the tables, rays, the plain forward's m, hit positions
    and transmittance, one-signed cotangents."""
    from raytpu_torch.kernels import soft_raytrace as srt
    from raytpu_torch.render.soft import raytrace_soft_inputs
    scene = _torus(device, quads)
    camera = Camera.make((0.0, -0.5, -5.0), focal=size * 0.6, device=device)
    cfg = RenderConfig(width=width or size, height=size, mode="soft",
                       soft_edge_sharpness=40.0, soft_z_sharpness=40.0)
    if srcs is None:
        srcs = torch.tensor([[0.3, -1.5, -3.0], [0.25, -1.45, -3.1]],
                            device=device)
    with torch.no_grad():
        inp = raytrace_soft_inputs(scene, camera, cfg, cull=False)
        out, m, _ = srt.primary_agg_reference(inp.pri, camera.pos, inp.dirs,
                                              inp.es, inp.zs, inp.chunk)
        world = out[3:6].contiguous()
        trans = srt.shadow_trans_reference(inp.shw, srcs, world, inp.es,
                                           inp.zs, inp.chunk)
    R = size * (width or size)
    return ((inp.pri, camera.pos.contiguous(), inp.dirs, m,
             _one_signed((10, R), device, 0), inp.es, inp.zs, inp.chunk),
            (inp.shw, srcs, world, trans,
             _one_signed((srcs.shape[0], R), device, 1), inp.es, inp.zs,
             inp.chunk))


@pytest.mark.parametrize("quads,size,limit", [
    ((256, 130), 16, None), ((20, 20), 48, 256)],
    ids=["66560-16x16", "800-forced-48x48"])
def test_two_launch_kernels_match_plain_float64(cuda, monkeypatch, quads,
                                                size, limit):
    """K10e, K10f, K10k and K10l through the wrappers' two-launch route
    (primary_agg_bwd, shadow_trans_bwd) on the 66,560-triangle torus, where
    JAX's limit takes it, and on the 800-triangle one with the limit forced
    down: against the plain backward in float64 with the float32 branch
    decisions and the plain float32 version by column group (phase 20's
    rule, and where float32 misses float64 by more than the rule, F11's:
    within twice the plain float32 version's distance from float64); two
    calls bit-identical; one launch of each, none of K10c/K10i; the rays'
    gradients (d dirs, d world) equal the fused K10c's and K10i's bit for
    bit (the same sums in the same order)."""
    from raytpu_torch.kernels import soft_raytrace as srt
    if limit is not None:
        monkeypatch.setattr(srt, "FUSED_BWD_MAX_ROWS", limit)
    pargs, sargs = _two_launch_case(cuda, quads, size)
    Tp = pargs[0].shape[0]
    assert srt.pri_two_launch(Tp) and srt.shw_two_launch(Tp)
    names = ("PRI_BWD_TABLES", "PRI_BWD_DIRS", "SHW_BWD_CONSTS",
             "SHW_BWD_RAYS", "PRI_BWD", "SHW_BWD")

    def counts():
        return [getattr(srt, f"LAUNCHES_SRT_{k}") for k in names]

    before = counts()
    got = (*srt.primary_agg_bwd(*pargs), *srt.shadow_trans_bwd(*sargs))
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 1, 1, 0, 0]
    again = (*srt.primary_agg_bwd(*pargs), *srt.shadow_trans_bwd(*sargs))
    monkeypatch.setattr(srt, "FUSED_BWD_MAX_ROWS", 1 << 30)
    fused = (*srt.primary_agg_bwd(*pargs), *srt.shadow_trans_bwd(*sargs))
    want = (*srt.primary_agg_bwd_reference(
        *(t.double() for t in pargs[:5]), *pargs[5:], f32_branches=True),
        *srt.shadow_trans_bwd_reference(
        *(t.double() for t in sargs[:5]), *sargs[5:], f32_branches=True))
    plain = (*srt.primary_agg_bwd_reference(*pargs),
             *srt.shadow_trans_bwd_reference(*sargs))
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a) and bool(torch.isfinite(g).all())
    assert torch.equal(got[2], fused[2]) and torch.equal(got[5], fused[5])
    assert not got[0][:, srt.PRI_USED:].any()
    assert not got[3][:, srt.SHW_USED:].any()
    one = (("all", 0, 3),)
    _assert_f11_rule(got[0], want[0], plain[0], srt.PRI_GROUPS)
    _assert_f11_rule(got[1][None], want[1][None], plain[1][None], one)
    _assert_f11_rule(got[2].T, want[2].T, plain[2].T, one)
    _assert_f11_rule(got[3], want[3], plain[3], srt.SHW_GROUPS)
    _assert_f11_rule(got[4], want[4], plain[4], one)
    _assert_f11_rule(got[5].T, want[5].T, plain[5].T, one)


def test_dead_pair_kernels_on_a_ragged_frame(cuda, monkeypatch):
    """K10e and K10f on a 40 x 72 frame of the 800-triangle torus, the
    limit forced down: 2,880 rays, not a whole number of K10e's 128-ray
    tiles or K10f's blocks. Against the plain
    backward in float64 with the float32 branch decisions and in float32 by
    column group (F11's rule); two calls bit-identical; d dirs equal to the
    fused K10c's bit for bit, as the early-out skips only pairs of weight
    exactly 0; the plain predicate marks most of the pairs."""
    from raytpu_torch.kernels import soft_raytrace as srt
    monkeypatch.setattr(srt, "FUSED_BWD_MAX_ROWS", 256)
    pargs = _two_launch_case(cuda, (20, 20), 40, width=72)[0]
    consts, cam, dirs, m, cot, es, zs, chunk = pargs
    assert dirs.shape[1] == 2880 and srt.pri_two_launch(consts.shape[0])
    before = (srt.LAUNCHES_SRT_PRI_BWD_TABLES, srt.LAUNCHES_SRT_PRI_BWD_DIRS)
    got = (*srt.primary_bwd_tables(*pargs), srt.primary_bwd_dirs(*pargs))
    assert (srt.LAUNCHES_SRT_PRI_BWD_TABLES,
            srt.LAUNCHES_SRT_PRI_BWD_DIRS) == (before[0] + 1, before[1] + 1)
    again = (*srt.primary_bwd_tables(*pargs), srt.primary_bwd_dirs(*pargs))
    monkeypatch.setattr(srt, "FUSED_BWD_MAX_ROWS", 1 << 30)
    fused = srt.primary_agg_bwd(*pargs)
    want = srt.primary_agg_bwd_reference(
        *(t.double() for t in pargs[:5]), *pargs[5:], f32_branches=True)
    plain = srt.primary_agg_bwd_reference(*pargs)
    dead = torch.cat([srt.primary_dead_pairs(consts[lo:lo + chunk], dirs, m,
                                             es, zs)
                      for lo in range(0, consts.shape[0], chunk)])
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a) and bool(torch.isfinite(g).all())
    assert torch.equal(got[2], fused[2])
    assert not got[0][:, srt.PRI_USED:].any()
    one = (("all", 0, 3),)
    _assert_f11_rule(got[0], want[0], plain[0], srt.PRI_GROUPS)
    _assert_f11_rule(got[1][None], want[1][None], plain[1][None], one)
    _assert_f11_rule(got[2].T, want[2].T, plain[2].T, one)
    assert float(dead.float().mean()) > 0.9


def test_dead_pair_kernels_through_the_hole(cuda):
    """The 48^2 frame of the rasterizer's default camera on the main path's
    66,560-triangle torus looks through its hole: every ray misses, every
    pair is gated or proved dead (the plain predicate), K10e's gradients are
    exactly zero and K10f's d dirs equals the fused K10c's bit for bit."""
    from raytpu_torch.kernels import soft_raytrace as srt
    from raytpu_torch.render.soft import raytrace_soft_inputs
    camera = Camera.rasterizer_default(device=cuda)
    cfg = RenderConfig(width=48, height=48, mode="soft",
                       soft_edge_sharpness=40.0, soft_z_sharpness=40.0)
    with torch.no_grad():
        inp = raytrace_soft_inputs(_torus(cuda, (256, 130)), camera, cfg,
                                   cull=False)
        _, m, _ = srt.primary_agg_fwd(inp.pri, camera.pos, inp.dirs, inp.es,
                                      inp.zs, inp.chunk)
    pargs = (inp.pri, camera.pos.contiguous(), inp.dirs, m,
             _one_signed((10, 48 * 48), cuda, 2), inp.es, inp.zs, inp.chunk)
    assert srt.pri_two_launch(inp.pri.shape[0])
    dc, dcam = srt.primary_bwd_tables(*pargs)
    dd = srt.primary_bwd_dirs(*pargs)
    fused = (torch.empty_like(inp.pri), torch.empty(3, device=cuda),
             torch.empty_like(inp.dirs))
    srt.launch_pri_bwd_kernel(
        inp.pri, inp.chunk, camera.pos.contiguous(), inp.dirs, inp.es,
        inp.zs, m, pargs[4], *fused, blocks=1,
        scratch=srt.pri_scratch(inp.pri, inp.chunk, inp.dirs, blocks=1))
    dead = all(bool(srt.primary_dead_pairs(inp.pri[lo:lo + inp.chunk],
                                           inp.dirs, m, inp.es,
                                           inp.zs).all())
               for lo in range(0, inp.pri.shape[0], inp.chunk))
    torch.cuda.synchronize()
    assert not m.any() and dead
    assert not dc.any() and not dcam.any()
    assert torch.equal(dd, fused[2]) and not dd.any()


def test_dead_triple_kernels_on_a_ragged_frame(cuda, monkeypatch):
    """K10k and K10l on a 40 x 72 frame of the 800-triangle torus with four
    shadow sources, the limit forced down: 2,880 points, not a whole number
    of K10k's 256-point tiles or K10l's blocks. Against the plain backward
    in float64 with the float32 branch decisions and in float32 by column
    group (F11's rule); two calls bit-identical; d world equal to the fused
    K10i's bit for bit, as the early-out skips only triples that add
    exactly nothing; the plain predicate marks most of the triples (83.8%
    of them, gated ones included, on the card)."""
    from raytpu_torch.kernels import soft_raytrace as srt
    monkeypatch.setattr(srt, "FUSED_BWD_MAX_ROWS", 256)
    srcs = torch.tensor([[0.3, -1.5, -3.0], [0.25, -1.45, -3.1],
                         [-0.4, -1.2, -2.8], [0.1, 1.3, -3.3]], device=cuda)
    sargs = _two_launch_case(cuda, (20, 20), 40, width=72, srcs=srcs)[1]
    consts, srcs, world, trans, gcot, es, zs, chunk = sargs
    assert world.shape[1] == 2880 and srt.shw_two_launch(consts.shape[0])
    before = (srt.LAUNCHES_SRT_SHW_BWD_CONSTS, srt.LAUNCHES_SRT_SHW_BWD_RAYS)
    got = (srt.shadow_bwd_consts(*sargs), *srt.shadow_bwd_rays(*sargs))
    assert (srt.LAUNCHES_SRT_SHW_BWD_CONSTS,
            srt.LAUNCHES_SRT_SHW_BWD_RAYS) == (before[0] + 1, before[1] + 1)
    again = (srt.shadow_bwd_consts(*sargs), *srt.shadow_bwd_rays(*sargs))
    monkeypatch.setattr(srt, "FUSED_BWD_MAX_ROWS", 1 << 30)
    fused = srt.shadow_trans_bwd(*sargs)
    want = srt.shadow_trans_bwd_reference(
        *(t.double() for t in sargs[:5]), *sargs[5:], f32_branches=True)
    plain = srt.shadow_trans_bwd_reference(*sargs)
    dead = torch.cat([srt.shadow_dead_triples(consts, srcs[k], world, es, zs)
                      for k in range(srcs.shape[0])])
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a) and bool(torch.isfinite(g).all())
    assert torch.equal(got[2], fused[2])
    assert not got[0][:, srt.SHW_USED:].any()
    one = (("all", 0, 3),)
    _assert_f11_rule(got[0], want[0], plain[0], srt.SHW_GROUPS)
    _assert_f11_rule(got[1], want[1], plain[1], one)
    _assert_f11_rule(got[2].T, want[2].T, plain[2].T, one)
    assert float(dead.float().mean()) > 0.8


def test_dead_triple_kernels_with_every_point_inactive(cuda, monkeypatch):
    """K10k and K10l where every point's cotangent is 0 (d od 0): every
    point is skipped, and the gradients are exactly zero, as the fused
    K10i's."""
    from raytpu_torch.kernels import soft_raytrace as srt
    monkeypatch.setattr(srt, "FUSED_BWD_MAX_ROWS", 256)
    sargs = list(_two_launch_case(cuda, (20, 20), 40, width=72)[1])
    sargs[4] = torch.zeros_like(sargs[4])
    dc = srt.shadow_bwd_consts(*sargs)
    dsrc, dw = srt.shadow_bwd_rays(*sargs)
    monkeypatch.setattr(srt, "FUSED_BWD_MAX_ROWS", 1 << 30)
    fused = srt.shadow_trans_bwd(*sargs)
    torch.cuda.synchronize()
    assert not dc.any() and not dsrc.any() and not dw.any()
    assert not any(t.any() for t in fused)


def test_sigmoid_is_zero_below_the_dead_threshold(cuda):
    """shw_triple_dead's premise on the card: the kernels' sigmoid (built
    with their flags) returns exactly 0 for every float32 from -100 down
    to -200, enumerated on the device (8,388,609 values), and for one in
    every 997 below that down to -FLT_MAX and -inf; at -88 it is not yet
    0."""
    from raytpu_torch.kernels import soft_raytrace as srt

    def floats(lo_bits, hi_bits, step=1):
        bits = torch.arange(lo_bits, hi_bits + 1, step, dtype=torch.int64,
                            device=cuda)
        return bits.to(torch.int32).view(torch.float32)

    x = floats(0xC2C80000, 0xC3480000)  # -100 ... -200, every float32
    assert x.numel() == 8_388_609
    assert float(x[0]) == srt.SIG_ZERO and float(x[-1]) == -200.0
    assert bool((x[1:] < x[:-1]).all())
    below = torch.cat([floats(0xC3480000, 0xFF7FFFFF, 997),
                       torch.tensor([-3.4028235e38, -float("inf")],
                                    device=cuda)])
    got, got_below = srt.sigmoid_probe(x), srt.sigmoid_probe(below)
    edge = srt.sigmoid_probe(torch.tensor([-88.0], device=cuda))
    torch.cuda.synchronize()
    assert not got.any() and not got_below.any()
    assert float(edge[0]) > 0.0


def test_expf_underflows_below_the_dead_threshold(cuda):
    """pri_pair_dead's premise on the card: the kernels' expf (built with
    their flags) returns exactly 0 for every float32 from -110 down to -200,
    enumerated on the device (7,077,889 values), and for one in every 997
    below that down to -FLT_MAX and -inf; at -103 it is not yet 0."""
    from raytpu_torch.kernels import soft_raytrace as srt

    def floats(lo_bits, hi_bits, step=1):
        bits = torch.arange(lo_bits, hi_bits + 1, step, dtype=torch.int64,
                            device=cuda)
        return bits.to(torch.int32).view(torch.float32)

    x = floats(0xC2DC0000, 0xC3480000)  # -110 ... -200, every float32
    assert x.numel() == 7_077_889
    assert float(x[0]) == srt.DEAD_BELOW and float(x[-1]) == -200.0
    assert bool((x[1:] < x[:-1]).all())
    below = torch.cat([floats(0xC3480000, 0xFF7FFFFF, 997),
                       torch.tensor([-3.4028235e38, -float("inf")],
                                    device=cuda)])
    got, got_below = srt.expf_probe(x), srt.expf_probe(below)
    edge = srt.expf_probe(torch.tensor([-103.0], device=cuda))
    torch.cuda.synchronize()
    assert not got.any() and not got_below.any()
    assert float(edge[0]) > 0.0


@pytest.mark.parametrize("limit,shadow_fused", [(256, False), (1024, True)],
                         ids=["both-two-launch", "primary-two-launch"])
def test_two_launch_step_launches_and_matches_cpu(cuda, monkeypatch, limit,
                                                  shadow_fused):
    """The culled soft frame of the 800-triangle torus (64^2, 25 chunks)
    and its gradients with the limit forced down, on the card against the
    CPU: the forward K10b + K10h, the backward K10e + K10f and K10k + K10l
    (or, where the shadow stays fused, K10j), no other K10 kernel; every
    leaf within atol 2e-4 after scaling, as the unforced frame's test."""
    from raytpu_torch.kernels import soft_raytrace as srt
    from raytpu_torch.render.soft import raytrace_soft
    monkeypatch.setattr(srt, "FUSED_BWD_MAX_ROWS", limit)
    names = ("PRI_FWD", "PRI_BWD", "SHW_FWD", "SHW_BWD", "PRI_FWD_MASKED",
             "PRI_BWD_MASKED", "SHW_FWD_MASKED", "SHW_BWD_MASKED",
             "PRI_BWD_TABLES", "PRI_BWD_DIRS", "SHW_BWD_CONSTS",
             "SHW_BWD_RAYS")

    def counts():
        return [getattr(srt, f"LAUNCHES_SRT_{k}") for k in names]

    def run(device):
        scene = _torus(device, (20, 20))
        camera = Camera.make((0.0, -0.5, -5.0), focal=40.0, device=device)
        lights = Lights.single(capacity=1, soft_samples=2,
                               position=(0.3, -1.5, -3.0), device=device)
        for t in (scene.v0, scene.color, camera.pos, lights.jitter):
            t.requires_grad_(True)
        before = counts()
        img = raytrace_soft(scene, camera, lights, RenderConfig(
            width=64, height=64, mode="soft", soft_shadow_samples=2,
            soft_edge_sharpness=40.0, soft_z_sharpness=40.0), cull=True)
        torch.sin(3.0 * img).sum().backward()
        launched = [a - b for a, b in zip(counts(), before)]
        return launched, [t.detach().cpu() for t in (
            img, scene.v0.grad, scene.color.grad, camera.pos.grad,
            lights.jitter.grad)]

    launched, got_all = run(cuda)
    fused, split = int(shadow_fused), int(not shadow_fused)
    assert launched == [0, 0, 0, 0, 1, 0, 1, fused, 1, 1, split, split]
    for got, want in zip(got_all, run("cpu")[1]):
        scale = max(float(want.abs().max()), 1e-8)
        torch.testing.assert_close(got / scale, want / scale, rtol=0,
                                   atol=2e-4)


def test_two_launch_wrappers_check_their_inputs(cuda):
    from raytpu_torch.kernels import soft_raytrace as srt
    pargs, sargs = _two_launch_case(cuda, (5, 7), 16)
    with pytest.raises(ValueError, match="cot"):
        srt.primary_bwd_tables(*pargs[:4], pargs[4][:9].contiguous(),
                               *pargs[5:])
    with pytest.raises(ValueError, match="dirs"):
        srt.primary_bwd_dirs(pargs[0], pargs[1], pargs[2].T, *pargs[3:])
    with pytest.raises(ValueError, match="chunk"):
        srt.shadow_bwd_consts(*sargs[:7], 33)
    with pytest.raises(ValueError, match="trans"):
        srt.shadow_bwd_rays(*sargs[:3], sargs[3][:1].contiguous(),
                            *sargs[4:])


def _torus_tris(quads):
    """The procedural torus of quads (two triangles each; 74 x 61 is the
    9,028 mesh) as (T, 3, 3) float32 vertices, scaled as load_stl does."""
    from raytpu_torch.core import stl
    tris = stl.parse_ascii_stl(stl.procedural_stl_text(*quads))
    return tris * np.float32(-stl.DEFAULT_SCALE)


def _mesh_sweep(device, size, quads, samples, n_lights, offset=(0.0, 0.0),
                zoom=1.0, tris=None):
    """The multi-chunk kernels' inputs: a size^2 frame of the procedural
    torus of ``quads`` (or the (T, 3, 3) vertices ``tris``), the ``render
    --stl`` camera nudged off x = 0 at focal zoom * size, the sources of
    n_lights lights with ``samples`` jittered positions each."""
    from raytpu_torch.core.types import Scene, pixel_grid
    from raytpu_torch.kernels import intersect as isect
    from raytpu_torch.ops.intersect import tri_constants
    from raytpu_torch.ops.shade import source_positions
    from raytpu_torch.render.raytrace import camera_ray_dirs
    if tris is None:
        tris = _torus_tris(quads)
    scene = Scene.from_vertices(tris[:, 0], tris[:, 1], tris[:, 2],
                                np.full((tris.shape[0], 3), 0.5, np.float32),
                                device=device)
    camera = Camera.make((0.0123, -0.5, -5.0), focal=zoom * size,
                         device=device)
    cfg = RenderConfig(width=size, height=size)
    lights = Lights.single(capacity=n_lights, soft_samples=16, device=device)
    if n_lights == 2:
        lights = lights.add((0.4, -0.5, -0.7), (1.0, 1.0, 1.0), 7.0)
    xs, ys = pixel_grid(size, size, device)
    dirs = camera_ray_dirs(xs + offset[0], ys + offset[1], camera, cfg)
    c = tri_constants(scene, camera.pos)
    src = source_positions(lights, samples)
    cs = tri_constants(scene, src)
    tiles = isect.ray_tiles(size * size, (size, size), device)
    geom = (scene.v0, scene.v1, scene.v2)
    return dict(args=(dirs, c.m, c.k0, c.valid), src_args=(cs.m, cs.k0,
                                                           camera.pos, src),
                tiles=tiles, geom=geom, cam=camera.pos)


def _grazing_tris():
    """The 800-triangle torus and an 800-triangle floor in the plane y =
    -0.5 of the camera, which its rows near the middle graze: D = 0 on the
    middle row, changing sign across the tiles that hold it."""
    g = np.linspace(-2.0, 2.0, 21, dtype=np.float32)
    z = np.linspace(-1.0, 3.0, 21, dtype=np.float32)
    quads = []
    for i in range(20):
        for j in range(20):
            a, b = (g[i], z[j]), (g[i + 1], z[j])
            c, d = (g[i + 1], z[j + 1]), (g[i], z[j + 1])
            quads += [(a, b, c), (a, c, d)]
    floor = np.array([[[x, -0.5, zz] for x, zz in q] for q in quads],
                     np.float32)
    return np.concatenate([_torus_tris((20, 20)), floor])


def _closest_case(device, case):
    """(the multi-chunk kernels' inputs, tri_chunk) of one case of
    test_closest_hit_kernels_match_plain_version."""
    if case == "mesh9028-512":
        return _mesh_sweep(device, 512, (74, 61), 1, 1), 128
    if case.startswith("chunk"):
        return _mesh_sweep(device, 200, (20, 20), 1, 1), int(case[5:])
    if case == "duplicates":
        # Every triangle twice, 800 apart, and the first 37 a third time:
        # equal t across chunk (128) and pass (256) boundaries, where the
        # last index must win.
        t = _torus_tris((20, 20))
        return _mesh_sweep(device, 200, None, 1, 1,
                           tris=np.concatenate([t, t, t[:37]])), 128
    if case == "grazing":
        return _mesh_sweep(device, 200, None, 1, 1, tris=_grazing_tris()), 128
    if case in ("specials", "permuted"):
        c = _mesh_sweep(device, 64 if case == "specials" else 200, (74, 61),
                        1, 1)
        dirs = c["args"][0].clone()
        if case == "specials":
            # NaN, inf and zero directions: single lanes of some tiles, a
            # whole 16 x 16 tile of zeros, and a K5 tile (rays 256-511)
            # holding NaN, inf and -0 components.
            dirs[5, 0] = float("nan")
            dirs[300, 1] = float("inf")
            dirs[400, 2] = -float("inf")
            dirs[600] = 0.0
            dirs[1000, 0] = -0.0
            for y in range(16, 32):
                dirs[y * 64 + 32:y * 64 + 48] = 0.0
        else:
            # Every ray permuted: K5's tiles and warps span the view.
            gen = torch.Generator().manual_seed(3)
            dirs = dirs[torch.randperm(dirs.shape[0], generator=gen).to(
                dirs.device)]
        c["args"] = (dirs.contiguous(), *c["args"][1:])
        return c, 128
    if case == "cornell32":
        # The sharded renderer's sub-ray shape: the Cornell box padded to
        # 32 triangles (one chunk), 512^2 at the raytracer's camera.
        from raytpu_torch.core.types import pixel_grid
        from raytpu_torch.kernels import intersect as isect
        from raytpu_torch.ops.intersect import tri_constants
        from raytpu_torch.ops.shade import source_positions
        from raytpu_torch.render.raytrace import camera_ray_dirs
        scene = cornell_box(pad_to=32, device=device)
        camera = Camera.raytracer_default(device=device)
        cfg = RenderConfig(width=512, height=512, mode="clean")
        dirs = camera_ray_dirs(*pixel_grid(512, 512, device), camera, cfg)
        c = tri_constants(scene, camera.pos)
        src = source_positions(Lights.single(capacity=1, device=device), 1)
        cs = tri_constants(scene, src)
        return dict(args=(dirs, c.m, c.k0, c.valid),
                    src_args=(cs.m, cs.k0, camera.pos, src),
                    tiles=isect.ray_tiles(512 * 512, (512, 512), device),
                    geom=(scene.v0, scene.v1, scene.v2),
                    cam=camera.pos), 32
    raise ValueError(case)


CLOSEST_CASES = ["mesh9028-512", "mesh800-200", "chunk20", "chunk24",
                 "chunk100", "duplicates", "grazing", "specials", "permuted",
                 "cornell32"]


@pytest.mark.parametrize("case", CLOSEST_CASES)
def test_closest_hit_kernels_match_plain_version(cuda, case):
    """K5 and K7d bit for bit against their plain versions, K7d = K5,
    K7d with an all-ones mask = K5, two calls identical, and K7a's t and
    idx = K5's: the meshes at chunks of 20, 24, 100 and 128, triangles
    repeated across chunk and pass boundaries, a floor the rays graze, NaN,
    inf and zero directions, permuted rays and the one-chunk Cornell box."""
    from raytpu_torch.kernels import intersect as isect
    if case == "mesh800-200":
        c, chunk = _mesh_sweep(cuda, 200, (20, 20), 1, 1), 128
    else:
        c, chunk = _closest_case(cuda, case)
    args, tiles = c["args"], c["tiles"]
    mask = isect.primary_mask(c["cam"], args[0], tiles, *c["geom"],
                              args[3], chunk)
    kw = dict(tri_chunk=chunk)
    before = (isect.LAUNCHES_CLOSEST, isect.LAUNCHES_CLOSEST_MASKED)
    k5 = isect.closest_hit(*args, **kw)
    k7d = isect.closest_hit_masked(*args, mask, tiles, **kw)
    ones = isect.closest_hit_masked(*args, torch.ones_like(mask), tiles, **kw)
    again = isect.closest_hit_masked(*args, mask, tiles, **kw)
    assert (isect.LAUNCHES_CLOSEST, isect.LAUNCHES_CLOSEST_MASKED) == (
        before[0] + 1, before[1] + 3)
    want5 = isect.closest_hit_reference(*args, **kw)
    want7 = isect.closest_hit_masked_reference(*args, mask, tiles, **kw)
    fmask = isect.fused_mask(args[0], tiles, c["geom"], args[3],
                             c["src_args"][3], c["cam"], chunk)
    k7a = isect.closest_hit_occluded_multi_masked(*args, *c["src_args"],
                                                  fmask, tiles, **kw)
    torch.cuda.synchronize()
    pairs = [(k5, want5), (k7d, want7), (ones, k5), (again, k7d),
             (k7a[:2], k5)]
    if case != "specials":  # a cone of NaN rays keeps no chunk
        pairs.append((k7d, k5))
    for got, want in pairs:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    hit = float((k5[1] >= 0).float().mean())
    assert 0.05 < hit < (1.0 if case == "cornell32" else 0.9)
    if case.startswith("mesh") or case.startswith("chunk"):
        assert float(mask.float().mean()) < 0.6


@pytest.mark.parametrize("case", ["mesh9028-512", "chunk20", "duplicates"])
def test_closest_hit_runs_fold_in_order(cuda, case):
    """K7d and K7a's primary half cut a tile's kept chunks into runs of at
    most `run` chunks, a block each, the last block to finish folding them
    in run order: the same bits at every run (1: every kept chunk its own
    block; 3, which divides no chunk count evenly; PRIMARY_RUN; 1,000: one
    run a tile), = K5's."""
    from raytpu_torch.kernels import intersect as isect
    c, chunk = _closest_case(cuda, case)
    args, tiles = c["args"], c["tiles"]
    table, C = isect.primary_table(*args[1:], chunk)
    mask = isect.primary_mask(c["cam"], args[0], tiles, *c["geom"], args[3],
                              C)
    want = isect.closest_hit(*args, tri_chunk=chunk)
    fmask = isect.fused_mask(args[0], tiles, c["geom"], args[3],
                             c["src_args"][3], c["cam"], C)
    ftable = isect.constant_table(args[1], args[2], args[3],
                                  *c["src_args"][:2], C)
    for run in (1, 3, isect.PRIMARY_RUN, 1000):
        got = isect._outputs(args[0], 0)[:2]
        isect.launch_closest_kernel(args[0], table, C, mask, tiles, *got,
                                    run=run)
        saved = isect.PRIMARY_RUN
        isect.PRIMARY_RUN = run
        try:
            outs = isect._outputs(args[0], c["src_args"][3].shape[0])
            isect.launch_occluded_masked_kernel(
                args[0], ftable, C, c["cam"], c["src_args"][3], fmask,
                tiles, *outs, phases=1, scratch=isect.k7a_scratch(
                    args[0], ftable, C, c["src_args"][3].shape[0], tiles))
        finally:
            isect.PRIMARY_RUN = saved
        torch.cuda.synchronize()
        for pair in (got, outs[:2]):
            assert torch.equal(pair[0], want[0]), (run, "t")
            assert torch.equal(pair[1], want[1]), (run, "idx")


def _probe_check(dirs, table, tiles):
    """The card's cull decisions = their plain form (on the card), every
    count of the probe = the plain decisions' and no ok ray culled."""
    from raytpu_torch.kernels import intersect as isect
    dec, counts = isect.primary_cull_probe(dirs, table, tiles)
    want = isect.primary_cull_decisions(
        dirs, table, tiles if tiles is not None
        else isect.ray_tiles(dirs.shape[0], None, dirs.device))
    torch.cuda.synchronize()
    assert torch.equal(dec, want)
    assert int(counts[0]) == int(want[:, 0].sum())
    assert int(counts[1]) == int(want[:, 1:].sum())
    assert int(counts[2]) == 0 and int(counts[3]) == 0
    return dec


@pytest.mark.parametrize("case", ["mesh9028-512", "specials", "grazing",
                                  "permuted"])
def test_primary_cull_probe(cuda, case):
    """The closest-hit kernels' cull on the card (box_reject, in
    raytpu_primary_cull_probe) decides every (tile, triangle) and (warp,
    triangle) pair as its plain form (primary_tile_reject) does, on K5's
    tiles (runs of 256 rays) and K7d's (16 x 16), and culls no pair that
    plane_test calls ok."""
    from raytpu_torch.kernels import intersect as isect
    c, chunk = _closest_case(cuda, case)
    table, _ = isect.primary_table(*c["args"][1:], chunk)
    for tiles in (None, c["tiles"]):
        dec = _probe_check(c["args"][0], table, tiles)
        if case == "mesh9028-512":
            assert float(dec[:, 1:].float().mean()) > 0.9


def test_primary_cull_probe_edge_triangles(cuda):
    """The card's decisions = the plain form's on constants at each edge of
    the reject (kernels.reject_edge_pairs' D, U, V and K, their other
    components 0, tiny or 1) and tiles of one direction, of directions
    within 2^-30, of a grazing fan and of a NaN lane; no ok ray culled."""
    from raytpu_torch.kernels import intersect as isect
    _, tri = isect.reject_edge_pairs(cuda)
    gen = np.random.default_rng(11)
    tri = tri[torch.tensor(gen.choice(tri.shape[0], 8192, replace=False),
                           device=cuda)].clone()
    other = torch.tensor(gen.standard_normal((tri.shape[0], 6)),
                         dtype=torch.float32, device=cuda)
    kind = (torch.arange(tri.shape[0], device=cuda) % 3)[:, None]
    tri[:, [1, 2, 4, 5, 7, 8]] = torch.where(
        kind == 0, 0.0, torch.where(kind == 1, other * 2.0 ** -30, 1.0))
    d = np.zeros((4, 256, 3), np.float32)
    d[..., 0] = 1.0
    d[1, :, 1:] = gen.uniform(-1, 1, (256, 2)) * 2.0 ** -30
    d[2, :, 1] = np.linspace(-0.01, 0.01, 256)
    d[3, 77, 1] = np.nan
    dirs = torch.tensor(d.reshape(-1, 3), device=cuda)
    dec = _probe_check(dirs, tri.T.contiguous(), None)
    assert bool(dec[0, 0].any()) and not bool(dec[3, 0].any())


@pytest.mark.parametrize("n_lights,samples", [(1, 1), (2, 16)],
                         ids=["s1", "s32"])
def test_occluded_masked_kernel_matches_plain_version(cuda, n_lights,
                                                      samples):
    """K7a on the 9,028 mesh at 500^2 (an AA sub-ray offset) bit for bit
    against its plain version and against an all-ones mask, its hits equal
    to K5's, two calls identical."""
    from raytpu_torch.kernels import intersect as isect
    case = _mesh_sweep(cuda, 500, (74, 61), samples, n_lights, (0.5, -0.5))
    args, tiles = case["args"], case["tiles"]
    mask = isect.fused_mask(args[0], tiles, case["geom"], args[3],
                            case["src_args"][3], case["cam"], 128)
    got = _k7a_checks(case, mask, tiles)
    assert got[2].shape == (n_lights * samples, 500 * 500)
    assert bool(got[2].any())


def _k7a_checks(case, mask, tiles):
    """K7a (three calls) against its plain version, an all-ones mask and
    K5; returns its outputs."""
    from raytpu_torch.kernels import intersect as isect
    args = (*case["args"], *case["src_args"])
    before = isect.LAUNCHES_OCCLUDED_MASKED
    got = isect.closest_hit_occluded_multi_masked(*args, mask, tiles)
    ones = isect.closest_hit_occluded_multi_masked(
        *args, torch.ones_like(mask), tiles)
    again = isect.closest_hit_occluded_multi_masked(*args, mask, tiles)
    assert isect.LAUNCHES_OCCLUDED_MASKED == before + 3
    want = isect.closest_hit_occluded_multi_masked_reference(*args, mask,
                                                             tiles)
    k5 = isect.closest_hit(*case["args"])
    torch.cuda.synchronize()
    for other in (want, ones, again):
        assert all(torch.equal(a, b) for a, b in zip(got, other))
    assert torch.equal(got[0], k5[0]) and torch.equal(got[1], k5[1])
    assert not bool(got[2][:, got[1] < 0].any())
    return got


@pytest.mark.parametrize("samples", [1, 16], ids=["s1", "s16"])
def test_occluded_masked_kernel_close_camera(cuda, samples):
    """K7a bit for bit where most tiles hold work: the 800-triangle torus
    at 160^2 zoomed in (focal 3 x 160), 89% of its tiles with hit rays."""
    from raytpu_torch.kernels import intersect as isect
    case = _mesh_sweep(cuda, 160, (20, 20), samples, 1, zoom=3.0)
    args, tiles = case["args"], case["tiles"]
    mask = isect.fused_mask(args[0], tiles, case["geom"], args[3],
                            case["src_args"][3], case["cam"], 128)
    got = _k7a_checks(case, mask, tiles)
    hit = got[1] >= 0
    per_tile = torch.bincount(tiles.tile[hit], minlength=tiles.count)
    assert float((per_tile > 0).float().mean()) > 0.8
    assert bool(got[2].any()) and float(hit.float().mean()) > 0.5


def test_occluded_masked_kernel_chunk_of_24(cuda):
    """K7a bit for bit with chunks of 24 triangles (the shadow sweep's
    groups of 16 then its tail group of 8), the 800-triangle torus at 96^2
    with 8 sources."""
    from raytpu_torch.kernels import intersect as isect
    case = _mesh_sweep(cuda, 96, (20, 20), 4, 2)
    args = (*case["args"], *case["src_args"])
    tiles = case["tiles"]
    mask = isect.fused_mask(args[0], tiles, case["geom"], args[3], args[7],
                            case["cam"], 24)
    got = isect.closest_hit_occluded_multi_masked(*args, mask, tiles,
                                                  tri_chunk=24)
    again = isect.closest_hit_occluded_multi_masked(*args, mask, tiles,
                                                    tri_chunk=24)
    want = isect.closest_hit_occluded_multi_masked_reference(
        *args, mask, tiles, tri_chunk=24)
    torch.cuda.synchronize()
    for other in (want, again):
        assert all(torch.equal(a, b) for a, b in zip(got, other))
    assert mask.shape[1] == 9 * 34 and bool(got[2].any())


def test_occluded_masked_kernel_single_hit_ray(cuda):
    """K7a bit for bit on a frame with one hit ray: the 9,028 mesh at 64^2
    with every other ray turned away from it (its tile holds one hit ray,
    one lane of one warp)."""
    from raytpu_torch.kernels import intersect as isect
    case = _mesh_sweep(cuda, 64, (74, 61), 16, 2)
    dirs = case["args"][0]
    t, idx = isect.closest_hit_reference(*case["args"])
    hits = torch.nonzero(idx >= 0).squeeze(1)
    keep = hits[hits.numel() // 2]
    away = dirs.clone()
    away[:, 2] = -away[:, 2]  # toward -z: behind the camera, a miss
    away[keep] = dirs[keep]
    case["args"] = (away.contiguous(), *case["args"][1:])
    tiles = case["tiles"]
    mask = isect.fused_mask(case["args"][0], tiles, case["geom"],
                            case["args"][3], case["src_args"][3],
                            case["cam"], 128)
    got = _k7a_checks(case, mask, tiles)
    assert int((got[1] >= 0).sum()) == 1 and int(got[1][keep]) >= 0


def test_shadow_reject_probe(cuda):
    """The device reject (raytpu_shadow_reject_probe) never rejects a test
    that plane_test on the card calls blocking: hand-built edge pairs (where
    it also equals its plain form bit for bit, and plane_test equals
    plane_tests), random pairs, and every shadow test of 32 hit rays of the
    9,028 mesh's S = 32 frame (16 of them occluded) against every
    triangle."""
    from raytpu_torch.kernels import intersect as isect
    from raytpu_torch.ops.intersect import plane_tests
    from raytpu_torch.ops.shade import SHADOW_T
    edge = isect.reject_edge_pairs(cuda)
    rej, blk = isect.shadow_reject_probe(*edge)
    delta, tri = edge
    m, k0 = tri[:, :9].reshape(-1, 3, 3), tri[:, 9]
    ts, oks = plane_tests(delta[:1], m, k0)
    torch.cuda.synchronize()
    assert not bool((rej & blk).any())
    assert torch.equal(rej, isect.shadow_reject(delta[:1], m, k0)[0])
    assert torch.equal(blk, (oks & (ts < SHADOW_T))[0])
    assert int(blk.sum()) > 1000 and int(rej.sum()) > 1000

    rej, blk = isect.shadow_reject_probe(
        *isect.reject_random_pairs(1 << 18, 7, cuda))
    assert not bool((rej & blk).any()) and bool(blk.any())

    case = _mesh_sweep(cuda, 200, (74, 61), 16, 2)
    dirs, cam, src = case["args"][0], case["cam"], case["src_args"][3]
    mask = isect.fused_mask(dirs, case["tiles"], case["geom"],
                            case["args"][3], src, cam, 128)
    t, idx, occ = isect.closest_hit_occluded_multi_masked(
        *case["args"], *case["src_args"], mask, case["tiles"])
    # 16 hit rays that some source finds occluded, 16 that none does.
    shade = occ.any(dim=0)
    rays = torch.cat([torch.nonzero(shade).squeeze(1)[:16],
                      torch.nonzero((idx >= 0) & ~shade).squeeze(1)[:16]])
    assert rays.numel() == 32
    m_s, k0_s, valid = case["src_args"][0], case["src_args"][1], \
        case["args"][3]
    T = m_s.shape[1]
    pos = cam[None, :] + t[rays][:, None] * dirs[rays]
    delta = (pos[None, :, None, :] - src[:, None, None, :]).expand(
        -1, -1, T, -1).reshape(-1, 3).contiguous()
    tri = torch.cat([(m_s * valid[None, :, None, None]).reshape(-1, T, 9),
                     (k0_s * valid[None, :])[..., None]], dim=2)
    tri = tri[:, None].expand(-1, rays.numel(), -1, -1).reshape(-1, 10)
    rej, blk = isect.shadow_reject_probe(delta, tri.contiguous())
    torch.cuda.synchronize()
    assert not bool((rej & blk).any()) and bool(blk.any())
    assert float(rej.float().mean()) > 0.99


def test_multi_chunk_wrappers_check_their_inputs(cuda):
    from raytpu_torch.kernels import intersect as isect
    case = _mesh_sweep(cuda, 64, (20, 20), 1, 1)
    args, tiles = case["args"], case["tiles"]
    mask = isect.primary_mask(case["cam"], args[0], tiles, *case["geom"],
                              args[3], 128)
    isect.closest_hit_masked(*args, mask, tiles)
    with pytest.raises(TypeError):
        isect.closest_hit_masked(*args, mask.long(), tiles)
    with pytest.raises(ValueError):  # one chunk column short
        isect.closest_hit_masked(*args, mask[:, 1:].contiguous(), tiles)
    with pytest.raises(ValueError):  # the mask on the host
        isect.closest_hit_masked(*args, mask.cpu(), tiles)
    with pytest.raises(TypeError):
        isect.closest_hit(args[0].double(), *args[1:])


def test_stl_frame_on_gpu_matches_cpu(cuda):
    """raytrace_full on the 800-triangle torus (K7a, one launch a sub-ray)
    and its gradients, on the card against the CPU path."""
    from raytpu_torch.core import stl
    from raytpu_torch.core.types import Scene
    from raytpu_torch.kernels import intersect as isect
    tris = stl.parse_ascii_stl(stl.procedural_stl_text(20, 20))
    tris = tris * np.float32(-stl.DEFAULT_SCALE)

    def run(device):
        scene = Scene.from_vertices(
            tris[:, 0], tris[:, 1], tris[:, 2],
            np.full((tris.shape[0], 3), 0.5, np.float32), device=device)
        lights = Lights.single(capacity=1, position=(0.3, -1.5, -3.0),
                               device=device)
        for value in (scene, lights):
            for t in vars(value).values():
                t.requires_grad_(True)
        camera = Camera.make((0.0123, -0.5, -5.0), focal=64.0, device=device)
        out = raytrace_full(scene, camera, lights, RenderConfig(
            width=64, height=64, mode="parity", aa_samples=2))
        (torch.mean(out.image ** 2)
         + 0.1 * torch.mean(out.focal_distances ** 2)).backward()
        return out, [convert.grads_to_numpy(v) for v in (scene, lights)]

    before = isect.LAUNCHES_OCCLUDED_MASKED
    got, got_grads = run(cuda)
    assert isect.LAUNCHES_OCCLUDED_MASKED == before + 4
    want, want_grads = run("cpu")
    bad = (got.image.detach().cpu() - want.image.detach()).abs() > 1e-5
    assert float(bad.any(dim=-1).float().mean()) <= 0.001
    assert float(want.image.detach().max()) > 0.1
    for got_g, want_g in zip(got_grads, want_grads):
        for field in want_g:
            np.testing.assert_allclose(got_g[field], want_g[field], rtol=1e-4,
                                       atol=1e-5, err_msg=field)


# ---------------------------------------------------------------------------
# The sharded renderer's kernels: K7b, K7c, K8a; K8b, K8c, K9a, K9c at y0.


def _occlusion_case(device, size, quads, samples):
    """K7b's and K7c's inputs: the hit points of a size^2 frame of the
    procedural torus (_mesh_sweep's; the camera position on a miss), the
    sources' constants, the port's tiles and position_mask."""
    from raytpu_torch.kernels import intersect as isect
    from raytpu_torch.kernels.tables import tight_chunk
    c = _mesh_sweep(device, size, quads, samples, 2 if samples > 1 else 1)
    dirs, m, k0, valid = c["args"]
    m_s, k0_s, cam, src = c["src_args"]
    with torch.no_grad():
        t, idx = isect.closest_hit(dirs, m, k0, valid)
        pos = (cam + torch.where(idx >= 0, t, 0.0)[:, None] * dirs)
        mask = isect.position_mask(pos, c["tiles"], c["geom"], valid, src,
                                   tight_chunk(m.shape[0], 512))
    return dict(args=(pos.contiguous(), m_s, k0_s, src.contiguous(), valid),
                mask=mask, tiles=c["tiles"], hit=idx >= 0)


@pytest.mark.parametrize("size,quads,samples",
                         [(512, (74, 61), 1), (200, (20, 20), 16)],
                         ids=["9028-tris-512-s1", "800-tris-200-s32"])
def test_occlusion_kernels_match_plain_version(cuda, size, quads, samples):
    """K7b and K7c against their plain versions: occlusion bits equal for
    every point, K7c = K7b, an all-ones mask = K7b, two calls identical,
    exact launch counts."""
    from raytpu_torch.kernels import intersect as isect
    c = _occlusion_case(cuda, size, quads, samples)
    args = c["args"]
    before = (isect.LAUNCHES_OCCLUSION, isect.LAUNCHES_OCCLUSION_MASKED)
    brute, brute_again = (isect.occlusion_multi(*args),
                          isect.occlusion_multi(*args))
    culled = isect.occlusion_multi(*args, 512, c["mask"], c["tiles"])
    ones = isect.occlusion_multi(*args, 512, torch.ones_like(c["mask"]),
                                 c["tiles"])
    assert (isect.LAUNCHES_OCCLUSION, isect.LAUNCHES_OCCLUSION_MASKED) == (
        before[0] + 2, before[1] + 2)
    want = isect.occlusion_multi_reference(*args)
    want_culled = isect.occlusion_multi_masked_reference(
        *args, c["mask"], c["tiles"])
    torch.cuda.synchronize()
    assert brute.dtype == torch.int32
    assert brute.shape == (args[3].shape[0], size * size)
    assert torch.equal(brute, want) and torch.equal(brute, brute_again)
    assert torch.equal(culled, want_culled) and torch.equal(culled, brute)
    assert torch.equal(ones, brute)
    assert bool(brute[:, c["hit"]].any()) and not bool(brute.all())
    assert 0.0 < float(c["mask"].float().mean()) < 1.0


def _k7b_points(args, n_src=None):
    """K7b's inputs from K6's arguments (_sweep_inputs, _k6_torus_inputs):
    each ray's hit position from the plain closest hit, the camera position
    on a miss, toward the first n_src sources; and the hit rays."""
    from raytpu_torch.kernels import intersect as isect
    dirs, m, k0, valid, m_s, k0_s, cam, src = args
    n_src = src.shape[0] if n_src is None else n_src
    t, idx = isect.closest_hit_reference(dirs, m, k0, valid)
    pos = (cam + torch.where(idx >= 0, t, 0.0)[:, None] * dirs).contiguous()
    return ((pos, m_s[:n_src], k0_s[:n_src], src[:n_src].contiguous(), valid),
            idx >= 0)


@pytest.mark.parametrize("case,n_src", [
    ("cornell", 1), ("cornell", 32), ("torus", 4), ("torus", 48)])
def test_k7b_on_one_chunk(cuda, case, n_src):
    """K7b on one chunk (K6's shadow half): the 512^2 Cornell frame's points
    (padded to 32) toward 1 and the bench's 32 sources (staged in shared
    memory), and a torus of 128 triangles with misses at 96^2 toward 4
    sources (staged) and 48 (288 KB of triangle-major constants, above
    k6_staged's 96 KB: read through the cache). Bits equal to the plain
    version, two calls identical, one launch a call."""
    from raytpu_torch.kernels import intersect as isect
    if case == "cornell":
        args = _sweep_inputs(cuda, 512, 2, 16, (-0.5, -0.5))
    else:
        args = _k6_torus_inputs(cuda, (8, 8), 96, n_src)
    (pos, m_s, k0_s, src, valid), hit = _k7b_points(args, n_src)
    table = isect.source_table(m_s, k0_s, valid, 128 if case == "torus"
                               else 32)
    C = table.shape[1]
    assert isect.k6_staged(n_src, C) == (n_src < 48)

    def run():
        before = isect.LAUNCHES_OCCLUSION
        out = isect.occlusion_multi(pos, m_s, k0_s, src, valid)
        assert isect.LAUNCHES_OCCLUSION == before + 1
        return out

    got, again = run(), run()
    want = isect.occlusion_reference(pos, table, C, src)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, again)
    assert bool(got.any()) and not bool(got.all())
    if case == "torus":
        assert 0.05 < float(hit.float().mean()) < 0.95


@pytest.mark.parametrize("kind", ["one_tile", "thin"])
def test_k7c_on_crowded_and_thin_masks(cuda, kind):
    """K7c on the 9,028 mesh's points at 512^2 (S = 1) with a mask that
    keeps every chunk of one tile and nothing else, and with a thin mask (a
    seeded 3% of the (tile, chunk) pairs): bits equal to the plain masked
    version, two calls identical, under runs of 1, OCC_RUN and no split."""
    from raytpu_torch.kernels import intersect as isect
    c = _occlusion_case(cuda, 512, (74, 61), 1)
    pos, m_s, k0_s, src, valid = c["args"]
    table = isect.source_table(m_s, k0_s, valid, 128)
    C, S = 128, 1
    mask = torch.zeros_like(c["mask"])
    if kind == "one_tile":
        busy = int(torch.argmax(c["mask"].sum(dim=1)))
        mask[busy] = 1
    else:
        rng = np.random.default_rng(20)
        mask = torch.tensor((rng.uniform(size=mask.shape) < 0.03).astype(
            np.int32), device=cuda)
    want = isect.occlusion_masked_reference(pos, table, C, src, mask,
                                            c["tiles"])
    for run in (1, isect.OCC_RUN, 1024):
        outs = []
        for _ in range(2):
            out = torch.empty((S, pos.shape[0]), dtype=torch.int32,
                              device=cuda)
            isect.launch_occlusion_kernel(
                pos, table, C, src, mask, c["tiles"], out,
                scratch=isect.occlusion_scratch(pos, table, C, S, mask,
                                                c["tiles"], run), run=run)
            outs.append(out)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], want) and torch.equal(outs[1], want)
    assert bool(want.any())


@pytest.mark.parametrize("chunk", [24, 20, 100])
def test_k7b_k7c_chunks_of_any_size(cuda, chunk):
    """K7b over several chunks and K7c with chunks of 24, 20 and 100
    triangles (the sweep's groups of 16, then of 8, then of 1 at each
    chunk's tail, no test reaching into the next chunk): the 800-triangle
    torus at 96^2 toward 8 sources, bits equal to the plain versions (K7c
    to the masked one), K7c = K7b, an all-ones mask = K7b."""
    from raytpu_torch.kernels import intersect as isect
    case = _mesh_sweep(cuda, 96, (20, 20), 4, 2)
    (pos, m_s, k0_s, src, valid), _ = _k7b_points(
        (*case["args"], *case["src_args"]))
    mask = isect.position_mask(pos, case["tiles"], case["geom"], valid, src,
                               chunk)
    args = (pos, m_s, k0_s, src, valid, chunk)
    brute = isect.occlusion_multi(*args)
    culled = isect.occlusion_multi(*args, mask, case["tiles"])
    ones = isect.occlusion_multi(*args, torch.ones_like(mask), case["tiles"])
    want = isect.occlusion_multi_reference(*args[:5], tri_chunk=chunk)
    want_culled = isect.occlusion_multi_masked_reference(
        *args[:5], mask, case["tiles"], tri_chunk=chunk)
    torch.cuda.synchronize()
    n_chunks = -(-800 // chunk)
    assert mask.shape[1] == 8 * n_chunks
    assert 0.0 < float(mask.float().mean()) < 1
    assert torch.equal(brute, want) and torch.equal(culled, want_culled)
    assert torch.equal(culled, brute) and torch.equal(ones, brute)
    assert bool(brute.any())


def test_occluded_masked_kernel_chunk_of_20(cuda):
    """K7a bit for bit with chunks of 20 triangles (the shadow sweep's
    groups of 16 then of 1 at each chunk's tail), the 800-triangle torus at
    96^2 with 8 sources."""
    from raytpu_torch.kernels import intersect as isect
    case = _mesh_sweep(cuda, 96, (20, 20), 4, 2)
    args = (*case["args"], *case["src_args"])
    tiles = case["tiles"]
    mask = isect.fused_mask(args[0], tiles, case["geom"], args[3], args[7],
                            case["cam"], 20)
    got = isect.closest_hit_occluded_multi_masked(*args, mask, tiles,
                                                  tri_chunk=20)
    want = isect.closest_hit_occluded_multi_masked_reference(
        *args, mask, tiles, tri_chunk=20)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert mask.shape[1] == 9 * 40 and bool(got[2].any())


def test_shadow_reject_probe_on_miss_point_rays(cuda):
    """The device reject on the shadow rays of miss points (K7b and K7c test
    every point, a miss's camera position too): the camera of the 9,028
    mesh's frame toward 32 sources, against every triangle. It never
    rejects a test plane_test calls blocking, equals its plain form bit for
    bit, and decides nearly all the others."""
    from raytpu_torch.kernels import intersect as isect
    from raytpu_torch.ops.intersect import plane_tests
    from raytpu_torch.ops.shade import SHADOW_T
    case = _mesh_sweep(cuda, 64, (74, 61), 16, 2)
    cam, src = case["cam"], case["src_args"][3]
    m_s, k0_s, valid = case["src_args"][0], case["src_args"][1], \
        case["args"][3]
    S, T = m_s.shape[:2]
    m_v = m_s * valid[None, :, None, None]
    k0_v = k0_s * valid[None, :]
    delta = (cam[None, :] - src)[:, None, :].expand(-1, T, -1).reshape(-1, 3)
    tri = torch.cat([m_v.reshape(S, T, 9), k0_v[..., None]], dim=2)
    rej, blk = isect.shadow_reject_probe(delta.contiguous(),
                                         tri.reshape(-1, 10).contiguous())
    want_rej = torch.cat([isect.shadow_reject((cam - src[s])[None], m_v[s],
                                              k0_v[s])[0] for s in range(S)])
    want_blk = torch.cat([
        (lambda ts, oks: (oks & (ts < SHADOW_T))[0])(
            *plane_tests((cam - src[s])[None], m_v[s], k0_v[s]))
        for s in range(S)])
    torch.cuda.synchronize()
    assert not bool((rej & blk).any())
    assert torch.equal(rej, want_rej) and torch.equal(blk, want_blk)
    assert float(rej.float().mean()) > 0.99


@pytest.mark.parametrize("chunk,y0", [(128, 0), (100, 0), (128, 256)])
def test_culled_winner_kernels_on_the_mesh(cuda, chunk, y0):
    """K8a and K8c, redesigned around the exact per-tile row cull, on the
    9,028-row mesh at 512^2 (rows [y0, 512)): the plain versions' winners
    bit for bit, in chunks of 128 and of 100 (not a multiple of 32), two
    calls identical, one launch a call."""
    from raytpu_torch.kernels import raster
    from raytpu_torch.ops.raster import cull_mask
    from raytpu_torch.render.soft import _screen_vertices
    consts, _ = _raster_case(cuda, "stl", 512)
    H = 512 - y0
    before = (raster.LAUNCHES_WINNER_CHUNKED, raster.LAUNCHES_WINNER_MASKED)
    got_a = raster.raster_winner_chunked(consts, H, 512, chunk, y0)
    again_a = raster.raster_winner_chunked(consts, H, 512, chunk, y0)
    # K8c's mask for these rows and this chunk, as resolve_winner makes it.
    import tempfile

    from raytpu_torch.core.stl import load_stl, procedural_stl_text
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/mesh.stl"
        with open(path, "w") as f:
            f.write(procedural_stl_text())
        scene = load_stl(path, device=cuda)
    camera = Camera.make((0.0, -0.5, -5.0), focal=512.0, device=cuda)
    cfg = RenderConfig(width=512, height=512, mode="clean")
    sx, sy, zinv, _ = _screen_vertices(scene, camera, cfg)
    keep = cull_mask(scene, camera, cfg.replace(frustum_cull=False))
    assert torch.equal(raster.raster_tri_constants(sx, sy, zinv, keep),
                       consts)
    xmin, xmax, ymin, ymax = raster.tile_rects(H, 512, cuda)
    mask = raster.chunk_screen_mask(sx, sy, zinv, consts[:, 12],
                                    (xmin, xmax, ymin + y0, ymax + y0), chunk)
    got_c = raster.raster_winner_masked(consts, H, 512, mask, chunk, y0)
    again_c = raster.raster_winner_masked(consts, H, 512, mask, chunk, y0)
    assert (raster.LAUNCHES_WINNER_CHUNKED,
            raster.LAUNCHES_WINNER_MASKED) == (before[0] + 2, before[1] + 2)
    want_a = raster.resolve_winner_chunked_reference(consts, H, 512, chunk,
                                                     y0)
    want_c = raster.resolve_winner_masked_reference(consts, H, 512, mask,
                                                    chunk, y0)
    torch.cuda.synchronize()
    assert torch.equal(got_a, want_a) and torch.equal(got_a, again_a)
    assert torch.equal(got_c, want_c) and torch.equal(got_c, again_c)
    assert torch.equal(got_a, got_c)
    assert 0.05 < float((got_a >= 0).float().mean()) < 0.95


def _random_raster_rows(device, n, seed, size):
    """raster_tri_constants rows of random triangles a few pixels to a few
    tens wide over and around a size^2 image, a fifth invalid, plus rows
    with an edge through a column of pixel corners."""
    from raytpu_torch.kernels import raster
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.2 * size, 1.2 * size, (n, 1, 2))
    v = c + rng.normal(0.0, 8.0, (n, 3, 2))
    sx = torch.tensor(v[..., 0], dtype=torch.float32)
    sy = torch.tensor(v[..., 1], dtype=torch.float32)
    zinv = torch.tensor(rng.uniform(-0.2, 1.0, (n, 3)), dtype=torch.float32)
    keep = torch.tensor(rng.uniform(size=n) > 0.2, dtype=torch.float32)
    rows = raster.raster_tri_constants(sx, sy, zinv, keep)
    edge = torch.zeros((48, 16))
    edge[:, 12] = 1.0
    edge[:, 5] = edge[:, 8] = 1.0   # planes 1 and 2 >= 0 everywhere
    edge[:, 11] = 0.5               # zpx > 0 everywhere
    for i, x0 in enumerate(np.arange(0, size, size // 16)[:16]):
        c0 = np.float32(-x0)
        for j, cc in enumerate((np.nextafter(c0, np.float32(-1e9)), c0,
                                np.nextafter(c0, np.float32(1e9)))):
            edge[3 * i + j, 0] = 1.0
            edge[3 * i + j, 2] = float(cc)
    return torch.cat([rows, edge]).contiguous().to(device)


@pytest.mark.parametrize("y0", [0, 256])
def test_raster_cull_probe(cuda, y0):
    """The card's cull (raytpu_raster_cull_probe) rejects no (tile, row)
    pair with a pixel the sweep covers, on the 9,028-row mesh at 512^2 and
    on random rows and edges through pixel corners, and rejects exactly
    the pairs its plain form does."""
    from raytpu_torch.kernels import raster
    mesh, _ = _raster_case(cuda, "stl", 512)
    H = 512 - y0
    xmin, xmax, ymin, ymax = raster.tile_rects(H, 512, cuda)
    rect = (xmin, xmax, ymin + y0, ymax + y0)
    for consts in (mesh, _random_raster_rows(cuda, 2000, 7 + y0, 512)):
        got = raster.raster_cull_probe(consts, H, 512, y0)
        want = int(raster.raster_tile_reject(consts, rect).sum())
        assert got["covered"] == 0
        assert got["rejected"] == want
        assert got["pairs"] == consts.shape[0] * rect[0].shape[0]
        assert got["rejected"] > 0.9 * got["pairs"]


def _soft_mesh_case(device, size):
    """The 9,028-row mesh padded to 9,216 at size^2, the rasteriser camera,
    sharpness 40 / 40 (bench.py's soft_stl frame), as rasterize_soft
    builds its inputs."""
    import tempfile

    from raytpu_torch.core.stl import load_stl, procedural_stl_text
    from raytpu_torch.render.soft import rasterize_soft_inputs
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/mesh.stl"
        with open(path, "w") as f:
            f.write(procedural_stl_text())
        scene = load_stl(path, device=device).pad_to(9216)
    cfg = RenderConfig(width=size, height=size, mode="soft",
                       soft_edge_sharpness=40.0, soft_z_sharpness=40.0)
    with torch.no_grad():
        inp = rasterize_soft_inputs(scene, Camera.rasterizer_default(
            device=device), cfg)
    return dict(consts=inp.consts.contiguous(), chunk=inp.chunk,
                mask=inp.mask, es=inp.es, zs=inp.zs, H=size, W=size)


def test_culled_soft_forward_on_the_mesh(cuda):
    """K9b in work items across the card on the culled soft STL step's
    table (512^2, 288 chunks): within rtol 1e-5 / atol 1e-6 of the plain
    version, two calls bit for bit, all ones = K9a bit for bit, culled =
    brute at 1e-6 / 1e-6, one launch a call."""
    from raytpu_torch.kernels import soft_raster as sr
    c = _soft_mesh_case(cuda, 512)
    assert c["mask"] is not None
    args = (c["consts"], 512, 512, c["chunk"])
    before = (sr.LAUNCHES_SOFT_FWD, sr.LAUNCHES_SOFT_FWD_MASKED)
    got = sr.soft_agg_fwd(*args, c["mask"], c["es"], c["zs"])
    again = sr.soft_agg_fwd(*args, c["mask"], c["es"], c["zs"])
    ones = sr.soft_agg_fwd(*args, torch.ones_like(c["mask"]), c["es"],
                           c["zs"])
    brute = sr.soft_agg_fwd(*args, None, c["es"], c["zs"])
    assert (sr.LAUNCHES_SOFT_FWD, sr.LAUNCHES_SOFT_FWD_MASKED) == (
        before[0] + 1, before[1] + 3)
    items = sr.soft_fwd_items(c["mask"], c["mask"].shape[0],
                              c["mask"].shape[1])
    assert items["merged"] > 0  # the heavy tiles are split
    want = sr.soft_agg_reference(
        c["consts"], sr.pixel_coords(512, 512, cuda),
        sr.expand_mask(c["mask"], 512, 512), c["es"], c["zs"], c["chunk"])
    torch.cuda.synchronize()
    for g, a, o, b, w in zip(got, again, ones, brute, want):
        assert torch.equal(g, a)
        assert torch.equal(o, b)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(g, b, rtol=1e-6, atol=1e-6)


def test_soft_fwd_rule_mirrors_the_kernels(cuda):
    """kernels/soft_raster.py SOFT_FWD_ITEMS and SOFT_FWD_RUN_MIN mirror
    csrc/soft_raster.cu's kSoftFwdItems and kSoftFwdRunMin: K9a's scratch
    holds the partials (12 floats a pixel) of as many items as
    soft_fwd_items plans, where the run is the floor (64^2), where it is
    the mean over the split (128^2), and none at one item a tile (512^2)."""
    from raytpu_torch.kernels import soft_raster as sr
    for Tp, chunk, size in ((9216, 32, 64), (9216, 32, 128), (2048, 8, 512)):
        n_tiles = (-(-size // sr.TILE)) ** 2
        items = sr.soft_fwd_items(None, n_tiles, Tp // chunk)["items"]
        want = 0 if items == n_tiles else items * (2 + sr.N_CH) * 256 * 4
        assert sr._fwd_scratch_bytes(Tp, chunk, size, size, False) == want
        consts = torch.zeros((Tp, sr.CONST_COLS), device=cuda)
        assert (sr.fwd_scratch(consts, size, size, chunk, None) is None) == (
            want == 0)


@pytest.mark.parametrize("name", ["cornell", "mesh", "mesh512"])
def test_soft_row_dead_probe(cuda, name):
    """The card's dead-row test (raytpu_soft_row_dead_probe) calls dead no
    (block, row) pair with a pixel whose expf(logit - floor) is not 0 or
    whose logit is not below the floor, at each pixel block's floor from
    the forward's saved max and at 0, and calls dead exactly the pairs its
    plain form does."""
    from raytpu_torch.kernels import soft_raster as sr
    c = (_soft_mesh_case(cuda, 512) if name == "mesh512"
         else _soft_case(cuda, name))
    H, W = c["H"], c["W"]
    _, m, _ = sr.soft_agg_fwd(c["consts"], H, W, c["chunk"], c["mask"],
                              c["es"], c["zs"])
    block, rect = sr.tile_layout(H, W, cuda)
    top = torch.full((rect[0].shape[0],), float("inf"),
                     device=cuda).scatter_reduce(0, block, m, "amin")
    held = (rect[0] <= rect[1]) & (rect[2] <= rect[3])  # blocks with pixels
    for floor in (top, torch.zeros_like(top)):
        got = sr.soft_row_dead_probe(c["consts"], H, W, c["es"], c["zs"],
                                     floor)
        want = sr.soft_row_dead(c["consts"], rect, c["es"], c["zs"], floor)
        assert got["bad"] == 0
        assert got["dead"] == int(want[:, held].sum())
        assert got["pairs"] == c["consts"].shape[0] * int(held.sum())
        assert got["dead"] > 0


@pytest.mark.parametrize("size,y0", [(257, 0), (512, 256), (129, 64)])
def test_chunked_winner_kernel_matches_plain_version(cuda, size, y0):
    """K8a on rows [y0, size) of the 9,028-triangle mesh's frame at the STL
    camera: winners equal to the plain version and to K8c with an
    all-ones mask over the same rows, two calls identical."""
    from raytpu_torch.kernels import raster
    consts, _ = _raster_case(cuda, "stl", size)
    rows = size - y0
    before = raster.LAUNCHES_WINNER_CHUNKED
    got = raster.raster_winner_chunked(consts, rows, size, 128, y0)
    again = raster.raster_winner_chunked(consts, rows, size, 128, y0)
    assert raster.LAUNCHES_WINNER_CHUNKED == before + 2
    n_tiles = -(-rows // raster.TILE) * -(-size // raster.TILE)
    ones = torch.ones((n_tiles, -(-consts.shape[0] // 128)),
                      dtype=torch.int32, device=cuda)
    masked = raster.raster_winner_masked(consts, rows, size, ones, 128, y0)
    want = raster.resolve_winner_chunked_reference(consts, rows, size, 128,
                                                   y0)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, again)
    assert torch.equal(got, masked)
    assert 0.05 < float((got >= 0).float().mean()) < 0.95
    if y0:
        full = raster.raster_winner_chunked(consts, size, size, 128)
        assert torch.equal(got, full[y0 * size:])


def test_row_offset_kernels_match_plain_versions(cuda):
    """K8b, K8c, K9a and K9c on rows [y0, y0 + rows) of a frame: the plain
    versions' winners and aggregates for those rows (K8b, K8c exactly; K9a
    within rtol 1e-5 / atol 1e-6; K9c the plain backward's rule by column
    group), and at y0 = 0 the same bits as before."""
    from raytpu_torch.kernels import raster
    from raytpu_torch.kernels import soft_raster as sr
    size, y0, rows = 128, 48, 64
    consts, _ = _raster_case(cuda, "offgrid", size)
    got = raster.raster_winner(consts, rows, size, y0)
    want = raster.resolve_winner_reference(consts, rows, size, y0)
    full = raster.raster_winner(consts, size, size)
    assert torch.equal(got, want)
    assert torch.equal(got, full[y0 * size:(y0 + rows) * size])
    mesh, _ = _raster_case(cuda, "stl", size)
    ones = torch.ones((-(-rows // raster.TILE) * (size // raster.TILE),
                       -(-mesh.shape[0] // 128)), dtype=torch.int32,
                      device=cuda)
    assert torch.equal(
        raster.raster_winner_masked(mesh, rows, size, ones, 128, y0),
        raster.resolve_winner_masked_reference(mesh, rows, size, ones, 128,
                                               y0))
    c = _soft_case(cuda, "cornell", size)
    args = (c["consts"], rows, size, c["chunk"], None, c["es"], c["zs"])
    agg, m, s = sr.soft_agg_fwd(*args, y0=y0)
    coords = sr.pixel_coords(rows, size, cuda, y0=y0)
    wagg, wm, ws = sr.soft_agg_reference(c["consts"], coords, None, c["es"],
                                         c["zs"], c["chunk"])
    for a, b in ((agg, wagg), (m, wm), (s, ws)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    fagg, _, _ = sr.soft_agg_fwd(c["consts"], size, size, c["chunk"], None,
                                 c["es"], c["zs"])
    part = slice(y0 * size, (y0 + rows) * size)
    torch.testing.assert_close(agg, fagg[:, part], rtol=1e-5, atol=1e-6)
    cot = _soft_cot(dict(c, H=rows), seed=9)
    dc = sr.soft_agg_bwd(c["consts"], m, cot, rows, size, c["chunk"], None,
                         c["es"], c["zs"], y0=y0)
    want_dc = sr.soft_agg_bwd_reference(
        c["consts"].double(), coords.double(), None, m.double(),
        cot.double(), c["es"], c["zs"], c["chunk"],
        branches_from=c["consts"])
    torch.cuda.synchronize()
    _assert_groups_close(dc, want_dc)


def test_sharded_frames_on_one_rank_match_single_card(cuda):
    """On a 1 x 1 NCCL mesh (one process), the sharded clean frame (K5 +
    K7b), rasterizer (K8b) and soft rasterizer (K9a) equal the single-card
    frames; launches exact."""
    import torch.distributed as dist

    from raytpu_torch.kernels import intersect as isect
    from raytpu_torch.kernels import raster
    from raytpu_torch.kernels import soft_raster as sr
    from raytpu_torch.parallel import (init_distributed, make_mesh,
                                       shutdown_distributed)
    from raytpu_torch.parallel import render as pr
    from raytpu_torch.render.soft import rasterize_exact, rasterize_soft
    if dist.is_initialized():
        pytest.skip("a process group is already up")
    init_distributed()
    try:
        mesh = make_mesh(1, 1)
        scene = cornell_box(pad_to=32, device=cuda)
        lights = Lights.single(capacity=1, device=cuda)
        clean = RenderConfig(width=128, height=128, mode="clean")
        cam_r = Camera.make((0.011, -0.007, -3.013), focal=128.23,
                            y_scale=1.01, device=cuda)
        soft = RenderConfig(width=128, height=128, mode="soft")
        before = (isect.LAUNCHES_CLOSEST, isect.LAUNCHES_OCCLUSION,
                  raster.LAUNCHES_WINNER, sr.LAUNCHES_SOFT_FWD)
        with torch.no_grad():
            img = pr.make_sharded_render(mesh, clean)(
                scene, Camera.raytracer_default(device=cuda), lights)
            ras = pr.make_sharded_rasterize(mesh, clean)(scene, cam_r,
                                                         lights)
            sof = pr.make_sharded_soft_render(mesh, soft)(scene, cam_r,
                                                          lights)
        assert (isect.LAUNCHES_CLOSEST, isect.LAUNCHES_OCCLUSION,
                raster.LAUNCHES_WINNER, sr.LAUNCHES_SOFT_FWD) == tuple(
            b + 1 for b in before)
        with torch.no_grad():
            want = raytrace_full(scene, Camera.raytracer_default(device=cuda),
                                 lights, clean).image
            want_r = rasterize_exact(scene, cam_r, lights, clean)
            want_s = rasterize_soft(scene, cam_r, lights, soft)
        torch.cuda.synchronize()
        assert float((img - want).abs().max()) <= 1e-6
        assert float((ras - want_r).abs().max()) <= 1e-6
        torch.testing.assert_close(sof, want_s, rtol=1e-5, atol=1e-6)
    finally:
        shutdown_distributed()


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (1, 4)],
                         ids=["2x2", "4x1", "1x4"])
def test_sharded_paths_across_four_cards(cuda, shape, tmp_path):
    """tests/test_torch_parallel.py's sharded jobs on four cards, one rank
    a card over NCCL (the halo and the merges crossing cards), held to the
    unsharded port on cuda:0 at that file's rules."""
    import importlib.util
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    spec = importlib.util.spec_from_file_location(
        "torch_parallel_jobs",
        __import__("pathlib").Path(__file__).with_name(
            "test_torch_parallel.py"))
    jobs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jobs)
    from raytpu_torch.kernels import _build
    _build.build()  # once, before the ranks load it
    names = (*jobs.JOBS, "fit") if shape == (2, 2) else jobs.JOBS
    results = jobs.launch(shape, tmp_path, names, device="cuda")
    checks = ([(jobs.check_hard, n) for n in jobs.HARD]
              + [(jobs.check_raster, n) for n in jobs.RASTER]
              + [(jobs.check_soft, n) for n in jobs.SOFT_FRAMES]
              + [(jobs.check_step, n) for n in jobs.STEPS])
    failed = []
    for check, name in checks:  # every check runs; any failure fails
        try:
            check(results, shape, name, cuda)
        except AssertionError as e:
            failed.append(f"{name}: {str(e)[:600]}")
    if shape == (2, 2):
        want = jobs.reference("fit", cuda)["losses"]
        for r in results:
            np.testing.assert_array_equal(r["fit"], results[0]["fit"])
        np.testing.assert_allclose(results[0]["fit"], want, rtol=1e-3)
    assert not failed, "\n".join(failed)


def _lab_case(device, size, mode, pad_to):
    """The lab kernels' inputs for a frame, as the labs make them."""
    from raytpu_torch.labs.common import lab_inputs
    return dict(lab_inputs(Lights.single(capacity=1, device=device), size,
                           device, mode, pad_to), parity=mode == "parity")


@pytest.mark.parametrize("size,mode,pad_to,tile", [
    (512, "clean", 32, 2048), (500, "parity", None, 2000)])
def test_lab_kernels_match_plain_versions(cuda, size, mode, pad_to, tile):
    """K1r, L6 (unblocked) and the four L5 variants against their plain
    versions bit for bit, K1r against K1 bit for bit, exact launches."""
    from raytpu_torch.kernels import labs
    c = _lab_case(cuda, size, mode, pad_to)
    kw = dict(tile_r=tile, tri_chunk=512, ambient=0.2, parity=c["parity"])
    before = (labs.LAUNCHES_ROWS, labs.LAUNCHES_BLK8, labs.LAUNCHES_VARIANT)
    rows = labs.fused_fwd_raw(c["dirs_t"], *c["consts"], c["par"], **kw)
    out8 = labs.fused_fwd_blk8(c["dirs_t"], *c["consts"], c["par"], **kw)
    variants = {(g, s): labs.run_variant(c["dirs_t"], c["table"], c["par"],
                                         tile, c["C"], g, s)
                for g in (True, False) for s in (True, False)}
    assert (labs.LAUNCHES_ROWS, labs.LAUNCHES_BLK8,
            labs.LAUNCHES_VARIANT) == (before[0] + 1, before[1] + 1,
                                       before[2] + 4)
    want = labs.fused_fwd_raw_reference(c["dirs_t"], *c["consts"], c["par"],
                                        **kw)
    k1 = render_fused.fused_fwd(c["dirs"], c["table"], c["par"],
                                ambient=0.2, parity=c["parity"])
    torch.cuda.synchronize()
    for g, w, k in zip(rows, want, (k1.color.T, k1.fd[None], k1.idx[None],
                                    k1.occ[None])):
        assert int((g != w).sum()) == 0 and int((g != k).sum()) == 0
    assert torch.equal(labs.unblk8(out8[0:24], tile), want[0])
    assert torch.equal(labs.unblk8(out8[24:32], tile), want[1])
    assert torch.equal(out8, labs.fused_fwd_blk8_reference(
        c["dirs_t"], *c["consts"], c["par"], **kw))
    for (g, s), got in variants.items():
        plain = labs.run_variant_reference(c["dirs_t"], c["table"], c["par"],
                                           tile, c["C"], g, s)
        for a, b in zip(got, plain):
            assert int((a != b).sum()) == 0, (g, s)
    again = labs.fused_fwd_raw(c["dirs_t"], *c["consts"], c["par"], **kw)
    for a, b in zip(rows, again):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="F23"):
        labs.fused_fwd_raw(c["dirs_t"], *c["consts"], c["par"],
                           **dict(kw, tile_r=tile + 8))


def test_kernel_lab_and_overhead_kernels_match_plain_versions(cuda):
    """Phase 35's checks at 128^2: L1's vpu instances against their plain
    versions bit for bit (both chunk modes and divide forms at tile 2048,
    one call each at 4096 and 8192), (vpu, recip) = K5, the mxu instances
    within labs.mxu_rule; L2 = its plain version = K4 on every ray, L3 and
    L4 exact; exact launches, repeats identical, the refusals; and one
    chain captured in a CUDA graph."""
    from raytpu_torch.kernels import intersect as isect
    from raytpu_torch.kernels import labs
    from raytpu_torch.labs import kernel_lab, timing
    from raytpu_torch.labs.common import lab_inputs
    dirs, dirs_t, scenes = kernel_lab.scenes(128, 1000, cuda)
    before = labs.LAUNCHES_KERNEL_LAB
    calls = 0
    for name, (m, k0, valid) in scenes.items():
        k5 = isect.closest_hit(dirs, m, k0, valid, tri_chunk=512)
        for chunk_mode in labs.CHUNK_MODES:
            table, _ = labs.kernel_lab_table(m, k0, valid, chunk_mode)
            for dot in labs.DOTS:
                for div in labs.DIVS:
                    kw = dict(chunk_mode=chunk_mode, dot=dot, div=div)
                    tiles = (2048, 4096, 8192) if div == "recip" else (2048,)
                    want = labs.kernel_lab_variant_reference(
                        dirs_t, m, k0, valid, tile_r=2048, **kw)
                    for tile in tiles:
                        got = labs.kernel_lab_variant(dirs_t, m, k0, valid,
                                                      tile_r=tile, **kw)
                        calls += 1
                        torch.cuda.synchronize()
                        if dot == "vpu":
                            assert torch.equal(got[0], want[0]), (name, kw)
                            assert torch.equal(got[1], want[1]), (name, kw)
                            if div == "recip":
                                assert torch.equal(got[0], k5[0])
                                assert torch.equal(got[1], k5[1])
                        else:
                            rule = labs.mxu_rule(dirs_t, table, got, want)
                            print(name, kw, tile, rule)
                            assert rule["t_over"] == rule["other"] == 0
    assert labs.LAUNCHES_KERNEL_LAB == before + calls
    with pytest.raises(ValueError, match="tile_r"):
        labs.kernel_lab_variant(dirs_t, m, k0, valid, tile_r=1024,
                                chunk_mode="tight", dot="vpu", div="recip")

    x = lab_inputs(Lights.single(capacity=1, device=cuda), 128, cuda)
    m, k0, valid, m_l, k0_l = x["consts"][0:5]
    from raytpu_torch.kernels.tables import constant_table
    table = constant_table(m, k0, valid, m_l[None], k0_l[None], x["C"])
    args = (x["dirs_t"], table, x["cam_pos"], x["light_pos"], 2048, x["C"])
    counts = (labs.LAUNCHES_ONESTEP, labs.LAUNCHES_NOOP, labs.LAUNCHES_TINY)
    one, again = labs.run_onestep(*args), labs.run_onestep(*args)
    nop = labs.run_noop(*args)
    ones = torch.ones(labs.TINY_SHAPE, device=cuda)
    tiny = labs.run_tiny(ones * 3.0)
    assert (labs.LAUNCHES_ONESTEP, labs.LAUNCHES_NOOP,
            labs.LAUNCHES_TINY) == (counts[0] + 2, counts[1] + 1,
                                    counts[2] + 1)
    k4 = isect.closest_hit_occluded(x["dirs"], m, k0, valid, m_l, k0_l,
                                    x["cam_pos"], x["light_pos"])
    plain = labs.run_onestep_reference(*args)
    torch.cuda.synchronize()
    for a, b, c, k in zip(one, again, plain, k4):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a[0], k)
    assert torch.equal(nop[0][0], x["dirs_t"][0])
    assert not nop[1].any() and not nop[2].any()
    assert torch.equal(tiny, ones * 6.0)
    with pytest.raises(ValueError, match="F23"):
        labs.run_onestep(*args[:4], 3000, x["C"])
    with pytest.raises(ValueError, match="one chunk"):
        labs.run_noop(x["dirs_t"], torch.cat([table, table], 1), *args[2:])
    r = timing.chain_time(labs.run_tiny, ones, iters=3, batches=1, reps=1)
    assert r["graph"] is not None and r["graph"] > 0
    assert r["calls"]["captured"] == 3 and r["calls"]["replayed"] == 6


@pytest.mark.parametrize("run", [3, None], ids=["runs-of-3", "PRI_RUN"])
@pytest.mark.parametrize("layout", ["full-tile", "thin"])
def test_masked_primary_backward_items(cuda, monkeypatch, run, layout):
    """K10d where the first tile keeps every chunk (25 of the 800-triangle
    torus's) and the others about half of what the culled frame's mask
    keeps, so that tile's runs (9 of 3 chunks, or 2 of PRI_RUN) go to
    different blocks; or spread thin, each tile keeping at most one chunk
    (a seeded draw). Against the plain masked backward by column group
    (float64 with the float32 branch decisions, F11's rule), two calls
    bit-identical, a chunk no tile keeps exactly 0; with every bit set on
    K10c's own tiles of 256 consecutive rays, K10c's bits; K10f's d dirs,
    folded in the same runs, = K10c's bit for bit."""
    from raytpu_torch.kernels import soft_raytrace as srt
    from raytpu_torch.kernels.intersect import ray_tiles
    if run is not None:
        monkeypatch.setattr(srt, "PRI_RUN", run)
    c = _srt_culled_case(cuda, 48, 48)
    R, tiles = c["dirs"].shape[1], c["tiles"]
    n_chunks = c["pri"].shape[0] // c["chunk"]
    rng = np.random.default_rng(5)
    mask = c["mask"].clone()
    if layout == "full-tile":
        draw = rng.uniform(size=tuple(mask.shape))
        mask *= torch.tensor(draw < 0.5, device=cuda).int()
        mask[0] = 1
        assert int(mask[0].sum()) == n_chunks
    else:
        pick = rng.integers(0, n_chunks, size=mask.shape[0])
        thin = torch.zeros_like(mask)
        thin[torch.arange(mask.shape[0]), torch.tensor(pick)] = 1
        mask *= thin
        assert int(mask.sum(dim=1).max()) <= 1
    assert 0 < int(mask.sum()) < mask.numel()
    _, m, _ = srt.primary_agg_fwd(c["pri"], c["cam"], c["dirs"], c["es"],
                                  c["zs"], c["chunk"], mask, tiles)
    cot = _one_signed((10, R), cuda, 6)
    pargs = (c["pri"], c["cam"], c["dirs"], m, cot, c["es"], c["zs"],
             c["chunk"])
    cull = dict(mask=mask, tiles=tiles)
    count = srt.LAUNCHES_SRT_PRI_BWD_MASKED
    got, again = (srt.primary_agg_bwd(*pargs, **cull),
                  srt.primary_agg_bwd(*pargs, **cull))
    want = srt.primary_agg_bwd_reference(
        *(t.double() for t in pargs[:5]), *pargs[5:], f32_branches=True,
        **cull)
    plain = srt.primary_agg_bwd_reference(*pargs, **cull)
    runs = ray_tiles(R, None, cuda)
    ones = srt.primary_agg_bwd(
        *pargs, mask=torch.ones((runs.count, n_chunks), dtype=torch.int32,
                                device=cuda), tiles=runs)
    brute = srt.primary_agg_bwd(*pargs)
    dirs_k10f = srt.primary_bwd_dirs(*pargs)
    torch.cuda.synchronize()
    assert srt.LAUNCHES_SRT_PRI_BWD_MASKED == count + 3
    for g, a, o, b in zip(got, again, ones, brute):
        assert torch.equal(g, a) and bool(torch.isfinite(g).all())
        assert torch.equal(o, b)
    assert torch.equal(dirs_k10f, brute[2])
    dropped = mask.amax(dim=0) == 0
    assert not got[0].reshape(-1, c["chunk"], srt.PRI_COLS)[dropped].any()
    rule = functools.partial(_assert_float64_rule, slack=2.0)
    one = (("all", 0, 3),)
    rule(got[0], want[0], plain[0], srt.PRI_GROUPS)
    rule(got[1][None], want[1][None], plain[1][None], one)
    rule(got[2].T, want[2].T, plain[2].T, one)


@pytest.mark.parametrize("case", ["1024", "1023", "misaligned"])
def test_tiny_kernel_is_x_times_two(cuda, case):
    """L4 (float4s a thread, a scalar tail and a scalar path off 16-byte
    alignment) equals x * 2 bit for bit on 1,024 and 1,023 elements and on
    a view 4 bytes past an aligned address (through run_tiny), including
    NaN, infinities, subnormals and values whose double overflows."""
    from raytpu_torch.kernels import labs
    rng = np.random.default_rng(7)
    vals = rng.standard_normal(1025).astype(np.float32) * 1e3
    vals[:6] = [np.nan, np.inf, -np.inf, 1e-40, -0.0, 3e38]
    base = torch.tensor(vals, device=cuda)
    if case == "misaligned":
        x = base[1:].view(labs.TINY_SHAPE)
        assert x.data_ptr() % 16 == 4
        count = labs.LAUNCHES_TINY
        got = labs.run_tiny(x)
        assert labs.LAUNCHES_TINY == count + 1
    else:
        x = base[:int(case)].clone()
        got = torch.empty_like(x)
        labs.launch_tiny_kernel(x, got)
    torch.cuda.synchronize()
    want = x * 2
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
