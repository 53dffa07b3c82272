"""The sharded paths (raytpu_torch.parallel) over gloo, one process a rank,
against the port's unsharded frames, steps and fit, and on the (2, 2) mesh
against the JAX package's sharded functions.

Each mesh shape is one launch: fresh ``sys.executable`` processes running
this file as a script (``--worker``), meeting through a file store under
the test's tmp_path, each with a timeout that fails the test. Every rank
runs every sharded path (``JOBS``) and writes its row blocks, merged hit
indices, occlusion bits, winners, losses and gradients as numpy; the test
process assembles the images in data order and compares:

  * hard frames (the Cornell box padded to 32, 32^2 clean; the
    full-feature frame with AA 2, 4 soft samples, two lights and DoF
    across the shard edges, 16^2; the 800-triangle procedural mesh, 32^2,
    whose blocks take K7d and K7c; the box with two triangles copied into
    the last block, where the later block must win the ties): merged hit
    indices and the occlusion bits of hit rays equal to the unsharded
    ones, images within atol 1e-6;
  * the clean rasterizer (the box, K8b; the mesh, K8a; the box with two
    triangles copied, where the earlier block must keep the ties): winners
    equal, images within atol 1e-6;
  * the soft renderers (16^2, sharpness 10 / 20): within the JAX package's
    own rule for its sharded soft frames (atol 1e-4 / rtol 1e-3);
  * one train step each of the hard clean path and both soft renderers:
    every leaf's gradient within rtol 1e-4 / atol 1e-5 of the
    single-process step's (after scaling the soft leaves by their largest
    entry, as tests/test_torch_soft_raster.py does), losses bit-identical
    across ranks;
  * ``fit(mesh=...)`` on (2, 2): the unsharded fit's loss curve at rtol
    1e-3, JAX's own rule for the fit.

Model replicas (ranks of one data index) must hold bit-identical blocks.
Against JAX's ``make_sharded_*`` on 4 of its 8 virtual CPU devices at the
cross-package rules: hard frames atol 1e-6 with at most 0.1% of pixels
flipping winner (tests/test_torch_raytrace.py), the rasterizer atol 5e-6
(JAX's own sharded rule: a coplanar tie may flip), the soft rasterizer atol
5e-5 / rtol 1e-4, the soft raytracer atol 3e-5 / rtol 1e-5.
"""

from __future__ import annotations

import functools
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT = 120.0
MESH_CAM = (0.0123, -0.5, -5.0)
SOFT = dict(soft_edge_sharpness=10.0, soft_z_sharpness=20.0)
FLIP_FRAC = 0.001
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


# ---------------------------------------------------------------------------
# Inputs, the same on every rank and in the test process.


def _lights(dev, **kw):
    from raytpu_torch.core.types import Lights
    return Lights.single(device=dev, generator=torch.Generator()
                         .manual_seed(0), **kw)


def _mesh_scene(dev):
    from raytpu_torch.core import stl
    from raytpu_torch.core.types import Scene
    tris = stl.parse_ascii_stl(stl.procedural_stl_text(20, 20))
    tris = tris * np.float32(-stl.DEFAULT_SCALE)
    colors = np.stack([np.linspace(0.3, 0.9, tris.shape[0])] * 3,
                      axis=1).astype(np.float32)
    colors[:, 1] = colors[::-1, 0]
    return Scene.from_vertices(tris[:, 0], tris[:, 1], tris[:, 2], colors,
                               device=dev)


def _raster_camera(size, dev):
    """tests/test_raster_kernel.py's off-grid rasteriser camera (F4): the
    whole box in view at focal = size."""
    from raytpu_torch.core.types import Camera
    return Camera.make((0.011, -0.007, -3.013), focal=size + 0.23,
                       y_scale=1.01, dof_focus=1.9, device=dev)


def _tied_box(copies, dev):
    """The Cornell box's 30 triangles and copies of two of them (other
    colors) as triangles 30 and 31: every ray or pixel that meets an
    original meets its copy at the same depth, in another triangle block
    on a mesh of 2 or 4 model ranks, so the merges' tie rules decide."""
    import dataclasses
    from raytpu_torch.core.cornell import cornell_box
    box = cornell_box(device=dev)
    i = torch.tensor(copies, device=dev)

    def extend(a, b):
        return torch.cat([a, b])
    return dataclasses.replace(
        box, v0=extend(box.v0, box.v0[i]), v1=extend(box.v1, box.v1[i]),
        v2=extend(box.v2, box.v2[i]),
        color=extend(box.color, box.color[i].flip(1)),
        active=extend(box.active, box.active[i]))


def _frame(name, dev="cpu"):
    """(scene, camera, lights, cfg) of a named frame on device dev."""
    from raytpu_torch.core.cornell import cornell_box
    from raytpu_torch.core.types import Camera, RenderConfig
    box = cornell_box(pad_to=32, device=dev)
    if name == "tie":  # last wins: the copies
        return (_tied_box([9, 21], dev), Camera.raytracer_default(device=dev),
                _lights(dev, capacity=1), RenderConfig(32, 32, "clean"))
    if name == "raster_tie":  # first wins: the originals
        return (_tied_box([2, 6], dev), _raster_camera(32, dev), _lights(dev, capacity=1),
                RenderConfig(32, 32, "clean"))
    if name == "clean":
        return (box, Camera.raytracer_default(device=dev),
                _lights(dev, capacity=1), RenderConfig(32, 32, "clean"))
    if name == "full":
        lights = _lights(dev, capacity=2, soft_samples=4).add(
            (0.4, 0.4, -0.6), (1.0, 0.8, 0.6), 8.0,
            generator=torch.Generator().manual_seed(7))
        return (box, Camera.raytracer_default(device=dev), lights,
                RenderConfig(16, 16, "clean", aa_samples=2,
                             soft_shadow_samples=4, dof_enabled=True))
    if name == "mesh":
        return (_mesh_scene(dev), Camera.make(MESH_CAM, focal=32.0,
                                           device=dev),
                _lights(dev, position=(0.3, -1.5, -3.0), capacity=1),
                RenderConfig(32, 32, "clean"))
    if name == "raster":
        return (box, _raster_camera(32, dev), _lights(dev, capacity=1),
                RenderConfig(32, 32, "clean"))
    if name == "raster_mesh":
        return (_mesh_scene(dev), Camera.make(MESH_CAM, focal=32.23,
                                           device=dev),
                _lights(dev, capacity=1), RenderConfig(32, 32, "clean"))
    if name == "soft_rasterize":
        return (box, _raster_camera(16, dev), _lights(dev, capacity=1),
                RenderConfig(16, 16, "soft", **SOFT))
    if name == "soft_raytrace":
        return (box, Camera.raytracer_default(device=dev),
                _lights(dev, capacity=1), RenderConfig(16, 16, "soft", **SOFT))
    raise KeyError(name)


HARD = ("clean", "full", "mesh", "tie")
RASTER = ("raster", "raster_mesh", "raster_tie")
SOFT_FRAMES = ("soft_rasterize", "soft_raytrace")
# step name -> (frame, renderer); the clean step at 16^2.
STEPS = {"step_clean": ("clean", "raytrace"),
         "step_soft_rasterize": ("soft_rasterize", "rasterize"),
         "step_soft_raytrace": ("soft_raytrace", "raytrace")}


def _step_inputs(name, dev="cpu"):
    """(scene, camera, lights, cfg, target (H, W, 3)) of a train step: the
    scene's first vertices moved by 0.01 (soft) or the light dimmed to 10
    (clean), against a fixed target drawn from a numpy seed."""
    import dataclasses
    frame, _ = STEPS[name]
    scene, camera, lights, cfg = _frame(frame, dev)
    if frame == "clean":
        cfg = cfg.replace(width=16, height=16)
        lights = _lights(dev, capacity=1, intensity=10.0)
    else:
        scene = dataclasses.replace(scene, v0=scene.v0 + 0.01)
    rng = np.random.default_rng(5)
    target = torch.tensor(rng.uniform(0.0, 0.5, (cfg.height, cfg.width, 3))
                          .astype(np.float32), device=dev)
    return scene, camera, lights, cfg, target


def _fit_inputs(dev="cpu"):
    """The fit CLI's setup at 16^2 (30 triangles, the fit camera), its
    target the soft render of the box at the light's intensity 14."""
    from raytpu_torch.core.cornell import cornell_box
    from raytpu_torch.core.types import Camera, RenderConfig
    from raytpu_torch.opt.fit import FitConfig
    from raytpu_torch.render.soft import rasterize_soft
    camera = Camera.make((0.0, 0.0, -3.0), focal=16.0, y_scale=1.01,
                         device=dev)
    cfg = RenderConfig(width=16, height=16, mode="soft")
    with torch.no_grad():
        target = rasterize_soft(cornell_box(device=dev), camera,
                                _lights(dev, capacity=1), cfg)
    return (target, cornell_box(device=dev), camera,
            _lights(dev, capacity=1, intensity=10.0), cfg, FitConfig(steps=6))


# ---------------------------------------------------------------------------
# The worker: one rank, run as ``python tests/test_torch_parallel.py
# --worker RANK DATA MODEL STORE OUT JOBS DEVICE``: DEVICE "cpu" (gloo)
# or "cuda" (NCCL, rank r on cuda:r).


def _worker(rank, data, model, store, out, jobs, device):
    torch.set_num_threads(1)  # the ranks share the host's cores
    from raytpu_torch.parallel import render as pr
    from raytpu_torch.render.soft import _screen_vertices
    from raytpu_torch.parallel.distributed import (
        init_distributed,
        shutdown_distributed,
    )
    from raytpu_torch.parallel.mesh import (
        DATA_AXIS,
        axis_index,
        make_mesh,
    )
    from raytpu_torch.core.types import pixel_grid
    from raytpu_torch.render.raytrace import camera_ray_dirs

    dev = init_distributed(init_method=store, num_processes=data * model,
                           process_id=rank, device=device).device
    res = {}
    try:
        mesh = make_mesh(data, model, device=device)
        di = axis_index(mesh, DATA_AXIS)
        for name in jobs.split(","):
            if name in HARD:
                scene, camera, lights, cfg = _frame(name, dev)
                res[name] = pr.make_sharded_render(mesh, cfg)(
                    scene, camera, lights).detach().cpu().numpy()
                # The first sub-ray's merged hits and occlusion bits.
                rows = cfg.height // data
                xs, ys = pixel_grid(rows, cfg.width, dev, di * rows)
                dirs = camera_ray_dirs(xs, ys, camera, cfg)
                block, base = pr._scene_block(scene, mesh)
                hits = pr._merged_intersect(camera.pos, dirs, block, base,
                                            cfg, mesh, (rows, cfg.width))
                pos = camera.pos + torch.where(hits.hit, hits.t,
                                               0.0)[:, None] * dirs
                src = _sources(lights, cfg)
                occ = pr._merged_occlusion_rows(pos.detach(), block, src,
                                                cfg, mesh, (rows, cfg.width))
                res[name + "/idx"] = hits.idx.cpu().numpy()
                res[name + "/occ"] = occ.cpu().numpy()
            elif name in RASTER:
                scene, camera, lights, cfg = _frame(name, dev)
                res[name] = pr.make_sharded_rasterize(mesh, cfg)(
                    scene, camera, lights).detach().cpu().numpy()
                rows = cfg.height // data
                xs, ys = pixel_grid(rows, cfg.width, dev, di * rows)
                screen = _screen_vertices(scene, camera, cfg)[:3]
                res[name + "/winner"] = pr.merged_winner(
                    scene, camera, cfg, screen, xs, ys, di * rows, rows,
                    mesh).cpu().numpy()
            elif name in SOFT_FRAMES:
                scene, camera, lights, cfg = _frame(name, dev)
                res[name] = pr.make_sharded_soft_render(
                    mesh, cfg, name.split("_")[1])(
                    scene, camera, lights).detach().cpu().numpy()
            elif name in STEPS:
                scene, camera, lights, cfg, target = _step_inputs(name, dev)
                rows = cfg.height // data
                train_step, _ = pr.make_sharded_train_step(
                    mesh, cfg, renderer=STEPS[name][1])
                state = pr.train_state(
                    scene, lights,
                    lambda p: torch.optim.SGD(p, lr=1e-3))
                loss = train_step(state, camera,
                                  target[di * rows:(di + 1) * rows])
                res[name + "/loss"] = np.float32(loss.item())
                for i, leaf in enumerate(pr.leaves(state.scene,
                                                   state.lights)):
                    res[f"{name}/grad{i}"] = leaf.grad.cpu().numpy()
            elif name == "fit":
                from raytpu_torch.opt.fit import fit
                target, scene, camera, lights, cfg, fit_cfg = _fit_inputs(dev)
                res["fit"] = fit(target, scene, camera, lights, cfg, fit_cfg,
                                 mesh=mesh).losses
            else:
                raise KeyError(name)
    finally:
        shutdown_distributed()
    np.savez(Path(out) / f"rank{rank}.npz", **res)


def _sources(lights, cfg):
    from raytpu_torch.ops.shade import source_positions
    return source_positions(lights, cfg.soft_shadow_samples)


JOBS = (*HARD, *RASTER, *SOFT_FRAMES, *STEPS)


def launch(shape, tmp_path, jobs=JOBS, device="cpu") -> list[dict]:
    """Run ``jobs`` on a (data, model) mesh of fresh processes on
    ``device`` (cpu: gloo; cuda: NCCL, one card a rank); each rank's
    results as a dict of numpy arrays, by rank."""
    data, model = shape
    out = tmp_path / f"mesh{data}x{model}"
    out.mkdir()
    store = (out / "store").as_uri()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--worker", str(rank), str(data),
         str(model), store, str(out), ",".join(jobs), device],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(data * model)]
    errors = []
    try:
        for rank, proc in enumerate(procs):
            left = LAUNCH_TIMEOUT - (time.perf_counter() - t0)
            try:
                _, err = proc.communicate(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                errors.append(f"rank {rank}: not done in {LAUNCH_TIMEOUT} s")
                break
            if proc.returncode != 0:
                errors.append(f"rank {rank}: rc {proc.returncode}\n"
                              f"{err[-3000:]}")
                break
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert not errors, "\n".join(errors)
    print(f"mesh {data}x{model}: {time.perf_counter() - t0:.1f} s")
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(data * model)]


def assemble(results, shape, key):
    """The full array of ``key`` from the data-ordered row blocks; asserts
    that the model replicas of each block are bit-identical."""
    data, model = shape
    blocks = []
    for d in range(data):
        first = results[d * model][key]
        for m in range(1, model):
            np.testing.assert_array_equal(results[d * model + m][key], first,
                                          err_msg=f"{key}: model replicas")
        blocks.append(first)
    # Occlusion bits are (S, rows * W): the rows run along the last axis.
    return np.concatenate(blocks, axis=1 if key.endswith("/occ") else 0)


# ---------------------------------------------------------------------------
# The port's unsharded references (test process).


@functools.lru_cache(maxsize=None)
def reference(name, dev="cpu"):
    """The unsharded port's result of a job on device dev, as numpy."""
    from raytpu_torch.kernels.intersect import intersect_occluded_multi
    from raytpu_torch.kernels.raster import raster_tri_constants, resolve_winner
    from raytpu_torch.ops.intersect import tri_constants
    from raytpu_torch.ops.raster import cull_mask
    from raytpu_torch.render.raytrace import (
        camera_ray_dirs,
        pixel_grid,
        raytrace_full,
    )
    from raytpu_torch.render.soft import (
        _screen_vertices,
        rasterize_exact,
        rasterize_soft,
        raytrace_soft,
    )
    out = {}
    if name in HARD:
        scene, camera, lights, cfg = _frame(name, dev)
        out["img"] = raytrace_full(scene, camera, lights,
                                   cfg).image.cpu().numpy()
        xs, ys = pixel_grid(cfg.height, cfg.width, dev)
        dirs = camera_ray_dirs(xs, ys, camera, cfg)
        src = _sources(lights, cfg)
        T = scene.num_triangles
        hits, occ = intersect_occluded_multi(
            dirs, tri_constants(scene, camera.pos), tri_constants(scene, src),
            camera.pos, src, scene_geom=((scene.v0, scene.v1, scene.v2)
                                         if T > 128 else None),
            image_hw=(cfg.height, cfg.width))
        out["idx"], out["occ"] = hits.idx.cpu().numpy(), occ.cpu().numpy()
    elif name in RASTER:
        scene, camera, lights, cfg = _frame(name, dev)
        out["img"] = rasterize_exact(scene, camera, lights,
                                     cfg).cpu().numpy()
        sx, sy, zinv, _ = _screen_vertices(scene, camera, cfg)
        keep = cull_mask(scene, camera, cfg.replace(frustum_cull=False))
        out["winner"] = resolve_winner(
            raster_tri_constants(sx, sy, zinv, keep), cfg.height, cfg.width,
            screen_verts=(sx, sy, zinv)).cpu().numpy()
    elif name in SOFT_FRAMES:
        scene, camera, lights, cfg = _frame(name, dev)
        fn = rasterize_soft if name == "soft_rasterize" else raytrace_soft
        with torch.no_grad():
            out["img"] = fn(scene, camera, lights, cfg).cpu().numpy()
    elif name in STEPS:
        from raytpu_torch.parallel.render import leaves, train_state
        scene, camera, lights, cfg, target = _step_inputs(name, dev)
        state = train_state(scene, lights, lambda p: None)
        if cfg.mode == "soft":
            fn = (rasterize_soft if STEPS[name][1] == "rasterize"
                  else raytrace_soft)
            img = fn(state.scene, camera, state.lights, cfg)
        else:
            img = raytrace_full(state.scene, camera, state.lights,
                                cfg).image
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        out["loss"] = loss.item()
        out["grads"] = [np.zeros(p.shape, np.float32) if p.grad is None
                        else p.grad.cpu().numpy()
                        for p in leaves(state.scene, state.lights)]
    elif name == "fit":
        from raytpu_torch.opt.fit import fit
        out["losses"] = fit(*_fit_inputs(dev)).losses
    return out


def check_hard(results, shape, name, dev="cpu"):
    ref = reference(name, dev)
    img = assemble(results, shape, name)
    idx = assemble(results, shape, name + "/idx")
    np.testing.assert_array_equal(idx, ref["idx"])
    hit = ref["idx"] >= 0
    occ = assemble(results, shape, name + "/occ")
    np.testing.assert_array_equal(occ[:, hit], ref["occ"][:, hit])
    np.testing.assert_allclose(img, ref["img"], rtol=0, atol=1e-6)
    assert 0.1 < hit.mean() and occ[:, hit].any(), name
    if name == "tie":
        assert (ref["idx"] == 30).sum() > 100 and not (ref["idx"] == 9).any()
    return img


def check_raster(results, shape, name, dev="cpu"):
    ref = reference(name, dev)
    np.testing.assert_array_equal(assemble(results, shape, name + "/winner"),
                                  ref["winner"])
    img = assemble(results, shape, name)
    np.testing.assert_allclose(img, ref["img"], rtol=0, atol=1e-6)
    assert len(np.unique(ref["winner"])) > 5
    if name == "raster_tie":
        assert (ref["winner"] == 2).sum() > 50
        assert not np.isin(ref["winner"], [30, 31]).any()
    return img


def check_soft(results, shape, name, dev="cpu"):
    img = assemble(results, shape, name)
    np.testing.assert_allclose(img, reference(name, dev)["img"], atol=1e-4,
                               rtol=1e-3)
    return img


def check_step(results, shape, name, dev="cpu"):
    ref = reference(name, dev)
    losses = {float(r[name + "/loss"]) for r in results}
    assert len(losses) == 1, f"{name}: losses differ across ranks {losses}"
    np.testing.assert_allclose(losses.pop(), ref["loss"], rtol=1e-6)
    soft = STEPS[name][0] != "clean"
    pairs = []
    for i, want in enumerate(ref["grads"]):
        for r in results[1:]:
            np.testing.assert_array_equal(r[f"{name}/grad{i}"],
                                          results[0][f"{name}/grad{i}"])
        scale = max(np.abs(want).max(), 1e-3) if soft else 1.0
        pairs.append((results[0][f"{name}/grad{i}"] / scale, want / scale))
    # Each leaf's largest error as a fraction of the rule.
    print(f"{name} on {shape[0]}x{shape[1]}: " + " ".join(
        f"leaf {i} {np.max(np.abs(g - w) / (GRAD_ATOL + GRAD_RTOL * np.abs(w))):.3f}"
        for i, (g, w) in enumerate(pairs)))
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{name} leaf {i}")
    assert np.abs(ref["grads"][0]).max() > 0.0 or not soft


# ---------------------------------------------------------------------------
# The (2, 2) mesh: against the unsharded port and against JAX.


@pytest.fixture(scope="module")
def mesh2x2(tmp_path_factory):
    return launch((2, 2), tmp_path_factory.mktemp("p"), (*JOBS, "fit"))


@pytest.mark.parametrize("name", HARD)
def test_sharded_render_matches_unsharded(mesh2x2, name):
    check_hard(mesh2x2, (2, 2), name)


@pytest.mark.parametrize("name", RASTER)
def test_sharded_rasterize_matches_unsharded(mesh2x2, name):
    check_raster(mesh2x2, (2, 2), name)


@pytest.mark.parametrize("name", SOFT_FRAMES)
def test_sharded_soft_render_matches_unsharded(mesh2x2, name):
    check_soft(mesh2x2, (2, 2), name)


@pytest.mark.parametrize("name", list(STEPS))
def test_sharded_step_gradients_match_single_process(mesh2x2, name):
    check_step(mesh2x2, (2, 2), name)


def test_sharded_fit_follows_the_unsharded_fit(mesh2x2):
    want = reference("fit")["losses"]
    for r in mesh2x2:
        np.testing.assert_array_equal(r["fit"], mesh2x2[0]["fit"])
    np.testing.assert_allclose(mesh2x2[0]["fit"], want, rtol=1e-3)
    assert want[-1] < want[0]


@functools.lru_cache(maxsize=None)
def _jax_frame(name):
    """JAX's make_sharded_* on a (2, 2) mesh of its virtual CPU devices,
    from the port's inputs carried across as numpy."""
    import jax

    from raytpu.core.types import Camera as JaxCamera
    from raytpu.core.types import Lights as JaxLights
    from raytpu.core.types import RenderConfig as JaxRenderConfig
    from raytpu.core.types import Scene as JaxScene
    from raytpu.parallel.mesh import make_mesh
    from raytpu.parallel import render as jr

    scene, camera, lights, cfg = _frame(name)

    def conv(cls, value):
        return cls(**{k: jax.numpy.asarray(v.numpy())
                      for k, v in vars(value).items()})
    jcfg = JaxRenderConfig(**{k: getattr(cfg, k) for k in (
        "width", "height", "mode", "aa_samples", "soft_shadow_samples",
        "dof_enabled", "dof_kernel_size", "soft_edge_sharpness",
        "soft_z_sharpness")})
    mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
    if name in HARD:
        fn = jr.make_sharded_render(mesh, jcfg)
    elif name in RASTER:
        fn = jr.make_sharded_rasterize(mesh, jcfg)
    else:
        fn = jr.make_sharded_soft_render(mesh, jcfg, name.split("_")[1])
    return np.asarray(fn(conv(JaxScene, scene), conv(JaxCamera, camera),
                         conv(JaxLights, lights)))


@pytest.mark.parametrize("name", ["clean", "full", "raster"])
def test_sharded_hard_frames_match_jax(mesh2x2, name):
    got = assemble(mesh2x2, (2, 2), name)
    want = _jax_frame(name)
    if name == "raster":
        np.testing.assert_allclose(got, want, rtol=0, atol=5e-6)
        return
    bad = np.abs(got - want) > 1e-6
    print(f"{name}: {int(bad.sum())} of {bad.size} beyond atol 1e-6")
    assert bad.mean() <= FLIP_FRAC


@pytest.mark.parametrize("name", SOFT_FRAMES)
def test_sharded_soft_frames_match_jax(mesh2x2, name):
    got = assemble(mesh2x2, (2, 2), name)
    atol, rtol = (5e-5, 1e-4) if name == "soft_rasterize" else (3e-5, 1e-5)
    np.testing.assert_allclose(got, _jax_frame(name), atol=atol, rtol=rtol)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _r, _d, _m, _store, _out, _jobs, _dev = sys.argv[2:9]
    sys.path.insert(0, str(ROOT))
    _worker(int(_r), int(_d), int(_m), _store, _out, _jobs, _dev)
