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


def _two_launch_case(device, quads, size):
    """The two-launch backwards' inputs on the torus at size^2 (the STL
    camera, 40 / 40, cull=False), two shadow sources: the tables, rays,
    the plain forward's m, hit positions and transmittance, one-signed
    cotangents."""
    from raytpu_torch.kernels import soft_raytrace as srt
    from raytpu_torch.render.soft import raytrace_soft_inputs
    scene = _torus(device, quads)
    camera = Camera.make((0.0, -0.5, -5.0), focal=size * 0.6, device=device)
    cfg = RenderConfig(width=size, height=size, mode="soft",
                       soft_edge_sharpness=40.0, soft_z_sharpness=40.0)
    srcs = torch.tensor([[0.3, -1.5, -3.0], [0.25, -1.45, -3.1]],
                        device=device)
    with torch.no_grad():
        inp = raytrace_soft_inputs(scene, camera, cfg, cull=False)
        out, m, _ = srt.primary_agg_reference(inp.pri, camera.pos, inp.dirs,
                                              inp.es, inp.zs, inp.chunk)
        world = out[3:6].contiguous()
        trans = srt.shadow_trans_reference(inp.shw, srcs, world, inp.es,
                                           inp.zs, inp.chunk)
    R = size * size
    return ((inp.pri, camera.pos.contiguous(), inp.dirs, m,
             _one_signed((10, R), device, 0), inp.es, inp.zs, inp.chunk),
            (inp.shw, srcs, world, trans, _one_signed((2, R), device, 1),
             inp.es, inp.zs, inp.chunk))


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


def _mesh_sweep(device, size, quads, samples, n_lights, offset=(0.0, 0.0)):
    """The multi-chunk kernels' inputs: a size^2 frame of the procedural
    torus (quads x quads, two triangles each; 74 x 61 is the 9,028 mesh),
    the ``render --stl`` camera nudged off x = 0, the sources of n_lights
    lights with ``samples`` jittered positions each."""
    from raytpu_torch.core import stl
    from raytpu_torch.core.types import Scene, pixel_grid
    from raytpu_torch.kernels import intersect as isect
    from raytpu_torch.ops.intersect import tri_constants
    from raytpu_torch.ops.shade import source_positions
    from raytpu_torch.render.raytrace import camera_ray_dirs
    tris = stl.parse_ascii_stl(stl.procedural_stl_text(*quads))
    tris = tris * np.float32(-stl.DEFAULT_SCALE)
    scene = Scene.from_vertices(tris[:, 0], tris[:, 1], tris[:, 2],
                                np.full((tris.shape[0], 3), 0.5, np.float32),
                                device=device)
    camera = Camera.make((0.0123, -0.5, -5.0), focal=float(size),
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


@pytest.mark.parametrize("size,quads", [(512, (74, 61)), (200, (20, 20))],
                         ids=["mesh9028-512", "mesh800-200"])
def test_closest_hit_kernels_match_plain_version(cuda, size, quads):
    """K5 and K7d bit for bit against their plain versions, K7d = K5,
    K7d with an all-ones mask = K5, two calls identical."""
    from raytpu_torch.kernels import intersect as isect
    case = _mesh_sweep(cuda, size, quads, 1, 1)
    args, tiles = case["args"], case["tiles"]
    mask = isect.primary_mask(case["cam"], args[0], tiles, *case["geom"],
                              args[3], 128)
    before = (isect.LAUNCHES_CLOSEST, isect.LAUNCHES_CLOSEST_MASKED)
    k5 = isect.closest_hit(*args)
    k7d = isect.closest_hit_masked(*args, mask, tiles)
    ones = isect.closest_hit_masked(*args, torch.ones_like(mask), tiles)
    again = isect.closest_hit_masked(*args, mask, tiles)
    assert (isect.LAUNCHES_CLOSEST, isect.LAUNCHES_CLOSEST_MASKED) == (
        before[0] + 1, before[1] + 3)
    want5 = isect.closest_hit_reference(*args)
    want7 = isect.closest_hit_masked_reference(*args, mask, tiles)
    torch.cuda.synchronize()
    for got, want in ((k5, want5), (k7d, want7), (k7d, k5), (ones, k5),
                      (again, k7d)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert 0.05 < float((k5[1] >= 0).float().mean()) < 0.9
    assert float(mask.float().mean()) < 0.6


@pytest.mark.parametrize("n_lights,samples", [(1, 1), (2, 16)],
                         ids=["s1", "s32"])
def test_occluded_masked_kernel_matches_plain_version(cuda, n_lights,
                                                      samples):
    """K7a on the 9,028 mesh at 500^2 (an AA sub-ray offset) bit for bit
    against its plain version and against an all-ones mask, its hits equal
    to K5's, two calls identical."""
    from raytpu_torch.kernels import intersect as isect
    case = _mesh_sweep(cuda, 500, (74, 61), samples, n_lights, (0.5, -0.5))
    args = (*case["args"], *case["src_args"])
    tiles = case["tiles"]
    mask = isect.fused_mask(args[0], tiles, case["geom"], args[3], args[7],
                            case["cam"], 128)
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
    assert got[2].shape == (n_lights * samples, 500 * 500)
    assert bool(got[2].any()) and not bool(got[2][:, got[1] < 0].any())


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
