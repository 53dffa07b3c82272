"""The port's rasterizer end to end (raytpu_torch.render.rasterize and
render.soft.rasterize_exact, the ``rasterize`` CLI, animate's and the
view server's rasterizer) against the JAX package's.

Clean frames are held to the JAX package's Pallas route
(``use_pallas=True``, interpret mode on the CPU), whose winner search
evaluates the same plane constants as the port's; its jnp route evaluates
the edges directly and rounds differently (tests/test_raster_kernel.py).
Clean cameras sit off the pixel grid: where the grid meets a shared edge
exactly, both triangles' edge values are 0 in the port (and in the CUDA
kernels, built without contraction), so the first wins, while XLA:CPU
contracts the interpret-mode kernel's planes into FMAs and moves them by
an ulp either way (ROADMAP fault F4). The JAX references run eagerly
(``jax.disable_jit``): under jit XLA:CPU contracts the vertex stage too,
which moves a truncated parity coordinate by a pixel. Images within atol
1e-6; the raster train step's gradients within ROADMAP's rule (rtol 1e-4 /
atol 1e-5).
"""

import argparse
import json
import re
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.stl import load_stl as jax_load_stl
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.render import animate as jax_animate
from raytpu.render.rasterize import rasterize as jax_rasterize
from raytpu.render.soft import rasterize_exact as jax_rasterize_exact
from raytpu.view import ViewerApp as JaxViewerApp

from raytpu_torch import convert
from raytpu_torch.cli import main as cli_main
from raytpu_torch.cli.main import main
from raytpu_torch.core.cornell import cornell_box
from raytpu_torch.core.image import quantize_u8, read_bmp
from raytpu_torch.core.stl import procedural_stl_text
from raytpu_torch.core.types import Camera, Lights, RenderConfig
from raytpu_torch.kernels import raster as raster_kernels
from raytpu_torch.render import animate
from raytpu_torch.render.rasterize import rasterize, rasterize_full
from raytpu_torch.render.soft import rasterize_exact, rasterize_soft
from raytpu_torch.view import ViewerApp

ROOT = Path(__file__).resolve().parents[1]
SIZE = 32


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


def _port(scene, camera, lights):
    return (convert.scene_from_numpy(leaves(scene), device="cpu"),
            convert.camera_from_numpy(leaves(camera), device="cpu"),
            convert.lights_from_numpy(leaves(lights), device="cpu"))


@pytest.fixture(scope="module")
def small_stl(tmp_path_factory):
    path = tmp_path_factory.mktemp("stl") / "small.stl"
    path.write_text(procedural_stl_text(20, 20))  # 800 triangles
    return str(path)


def _clean_case(name, small_stl):
    """The off-grid camera of tests/test_raster_kernel.py on the Cornell
    box (one chunk), or the STL camera on the small mesh (7 chunks)."""
    if name == "stl":
        scene = jax_load_stl(small_stl, use_native=False)
        camera = JaxCamera.make((0.0, -0.5, -5.0), focal=float(SIZE) + 0.23)
    else:
        scene = jax_cornell_box(pad_to=32)
        camera = JaxCamera.make((0.011, -0.007, -3.013),
                                focal=float(SIZE) + 0.23, y_scale=1.01,
                                dof_focus=1.9)
    lights = JaxLights.single(capacity=2).add(
        (0.4, -0.5, -0.7), (1.0, 0.5, 0.5), 7.0, key=jax.random.PRNGKey(1))
    return scene, camera, lights


@pytest.mark.parametrize("name", ["cornell", "stl"])
def test_clean_image_matches_pallas_route(name, small_stl):
    scene, camera, lights = _clean_case(name, small_stl)
    want = np.asarray(jax_rasterize_exact(
        scene, camera, lights, JaxRenderConfig(width=SIZE, height=SIZE,
                                               mode="clean",
                                               use_pallas=True)))
    cfg = RenderConfig(width=SIZE, height=SIZE, mode="clean")
    got = rasterize_exact(*_port(scene, camera, lights), cfg)
    assert got.shape == (SIZE, SIZE, 3) and got.dtype == torch.float32
    diff = np.abs(got.numpy() - want)
    print(f"{name}: max |d image| {diff.max():.3g}, lit "
          f"{(want.sum(-1) > 0).mean():.3f}")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (want.sum(-1) > 0).mean() > 0.2


def test_rasterize_dispatches_by_mode():
    scene = cornell_box(device="cpu")
    lights = Lights.single(capacity=4, device="cpu")  # compacted to one
    cfg = RenderConfig(width=16, height=16)
    camera = Camera.make((0.0, 0.0, -3.0), focal=16.0, y_scale=1.01,
                         dof_focus=1.9, device="cpu")
    assert torch.equal(rasterize(scene, camera, lights, cfg),
                       rasterize_full(scene, camera, lights, cfg).image)
    clean = cfg.replace(mode="clean")
    assert torch.equal(rasterize(scene, camera, lights, clean),
                       rasterize_exact(scene, camera, lights.compact(),
                                       clean))
    soft = cfg.replace(mode="soft")
    assert torch.equal(rasterize(scene, camera, lights, soft),
                       rasterize_soft(scene, camera, lights.compact(), soft))
    # F9: clean mode ignores DoF, as in the JAX package; parity blurs.
    dof = clean.replace(dof_enabled=True)
    assert torch.equal(rasterize(scene, camera, lights, dof),
                       rasterize(scene, camera, lights, clean))
    assert not torch.equal(rasterize(scene, camera, lights,
                                     cfg.replace(dof_enabled=True)),
                           rasterize(scene, camera, lights, cfg))


def test_rasterizer_default_camera_matches_jax():
    got = convert.to_numpy(Camera.rasterizer_default(device="cpu"))
    for name, value in leaves(JaxCamera.rasterizer_default()).items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_raster_step_grads_match_jax():
    """The bench's raster step, cut to 32^2: the clean render of the box
    padded to 32, MSE to a fixed target 10% darker than the start; the
    gradient of every float leaf of scene and lights."""
    scene = jax_cornell_box(pad_to=32)
    camera = JaxCamera.make((0.011, -0.007, -3.013), focal=float(SIZE) + 0.23,
                            y_scale=1.01, dof_focus=1.9)
    lights = JaxLights.single(capacity=1)
    jcfg = JaxRenderConfig(width=SIZE, height=SIZE, mode="clean",
                           use_pallas=True)
    s, c, li = _port(scene, camera, lights)
    cfg = RenderConfig(width=SIZE, height=SIZE, mode="clean")
    with torch.no_grad():
        target = 0.9 * rasterize(s, c, li, cfg)

    def jax_loss(s, li):
        return jnp.mean((jax_rasterize_exact(s, camera, li, jcfg)
                         - jnp.asarray(target.numpy())) ** 2)

    want_loss, (want_s, want_l) = jax.value_and_grad(
        jax_loss, argnums=(0, 1))(scene, lights)
    for t in (*vars(s).values(), *vars(li).values()):
        t.requires_grad_(True)
    loss = torch.mean((rasterize(s, c, li, cfg) - target) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    for got, want in ((s, want_s), (li, want_l)):
        got = convert.grads_to_numpy(got)
        for name, value in leaves(want).items():
            print(f"{name}: max |grad| {np.abs(value).max():.3g}")
            np.testing.assert_allclose(got[name], value, rtol=1e-4,
                                       atol=1e-5, err_msg=name)
    assert np.abs(np.asarray(want_s.v0)).max() > 1e-4
    assert not np.asarray(want_s.active).any()


def _parser():
    parser = argparse.ArgumentParser()
    cli_main._render_flags(parser, rasterizer=True)
    return parser


@pytest.mark.parametrize("mode", ["parity", "clean"])
def test_rasterize_cli_writes_the_jax_frame(tmp_path, mode, capsys):
    out = tmp_path / "frame.bmp"
    flags = ["--width", str(SIZE), "--height", str(SIZE), "--mode", mode]
    # The CLI's defaults: camera (0, 0, -3), focal 500, DoF focus 1.9,
    # y_scale 1.01 in parity only.
    _, camera, _, _ = cli_main._build_inputs(
        _parser().parse_args(["--device", "cpu", *flags]), rasterizer=True)
    assert camera.pos.tolist() == [0.0, 0.0, -3.0]
    assert float(camera.focal) == 500.0
    assert float(camera.dof_focus) == pytest.approx(1.9)
    y_scale = 1.01 if mode == "parity" else 1.0
    assert float(camera.y_scale) == pytest.approx(y_scale)
    pos = (0.0, 0.0, -3.0) if mode == "parity" else (0.011, -0.007, -3.013)
    focal = float(SIZE) if mode == "parity" else float(SIZE) + 0.23
    flags += ["--focal", str(focal), "--camera-pos", *map(str, pos)]
    main(["rasterize", "--device", "cpu", *flags, "-o", str(out)])
    assert "wrote" in capsys.readouterr().out
    got = read_bmp(str(out))
    jcam = JaxCamera.make(pos, focal=focal, y_scale=y_scale, dof_focus=1.9)
    # Eager where the camera is off the axis (the jitted vertex stage
    # contracts into FMAs); parity's on-axis frame is the same jitted.
    with jax.disable_jit(mode == "clean"):
        want = quantize_u8(np.asarray(jax_rasterize(
            jax_cornell_box(), jcam, JaxLights.single(capacity=1),
            JaxRenderConfig(width=SIZE, height=SIZE, mode=mode,
                            use_pallas=True))))
    np.testing.assert_array_equal(got, want)
    assert got.max() > 80


def test_rasterize_cli_renders_stl(tmp_path, small_stl):
    """--stl in clean mode (the STL camera, --morton or not); parity
    refuses the 800-triangle mesh with F8's ValueError, as the JAX CLI
    does."""
    out = tmp_path / "stl.bmp"
    flags = ["--device", "cpu", "--width", "24", "--height", "24", "--focal",
             "24", "--stl", small_stl]
    main(["rasterize", *flags, "--mode", "clean", "-o", str(out)])
    img = read_bmp(str(out))
    assert img.shape == (24, 24, 3) and 0.1 < (img.sum(-1) > 0).mean() < 0.9
    main(["rasterize", *flags, "--mode", "clean", "--morton", "-o",
          str(tmp_path / "morton.bmp")])
    morton = read_bmp(str(tmp_path / "morton.bmp"))
    assert (np.abs(morton.astype(int) - img.astype(int)).max(-1) > 1).mean() \
        < 0.01
    scene, camera, _, _ = cli_main._build_inputs(
        _parser().parse_args(flags), rasterizer=True)
    assert scene.num_triangles == 800
    assert camera.pos.tolist() == [0.0, -0.5, -5.0]
    with pytest.raises(ValueError, match="not a multiple of 64"):
        main(["rasterize", *flags, "-o", str(tmp_path / "parity.bmp")])
    assert not (tmp_path / "parity.bmp").exists()
    args = _parser().parse_args(["--no-backface-cull", "--no-frustum-cull"])
    cfg = cli_main._build_inputs(
        argparse.Namespace(**{**vars(args), "device": "cpu"}),
        rasterizer=True)[3]
    assert not cfg.backface_cull and not cfg.frustum_cull


def test_rasterizer_key_transitions_match_jax():
    jax_camera = JaxCamera.rasterizer_default()
    jax_lights = JaxLights.single(capacity=1, soft_samples=4)
    camera = convert.camera_from_numpy(leaves(jax_camera), device="cpu")
    lights = convert.lights_from_numpy(leaves(jax_lights), device="cpu")
    for key in animate.expand_script("left*2,up*2,w*2,a*2,d,s,down,right"):
        jax_camera, jax_lights = jax_animate.apply_key_rasterizer(
            jax_camera, jax_lights, key, dt_ms=33.0)
        camera, lights = animate.apply_key_rasterizer(camera, lights, key,
                                                      dt_ms=33.0)
        for got, want in ((camera, jax_camera), (lights, jax_lights)):
            got = convert.to_numpy(got)
            for name, value in leaves(want).items():
                np.testing.assert_allclose(got[name], value, rtol=0,
                                           atol=1e-6, err_msg=name)


def test_animate_rasterizer_renders_one_frame_per_key():
    keys = animate.expand_script("left*2,up*2,w*2,a*2")
    cfg = RenderConfig(width=24, height=24, mode="clean")
    camera = Camera.make((0.0, 0.0, -3.0), focal=24.0, y_scale=1.01,
                         dof_focus=1.9, device="cpu")
    before = (raster_kernels.LAUNCHES_WINNER,
              raster_kernels.LAUNCHES_WINNER_MASKED)
    res = animate.animate(cornell_box(pad_to=32, device="cpu"), camera,
                          Lights.single(capacity=1, device="cpu"), cfg, keys,
                          renderer="rasterize")
    assert (raster_kernels.LAUNCHES_WINNER,
            raster_kernels.LAUNCHES_WINNER_MASKED) == before  # plain on CPU
    assert res.n_frames == len(res.frames) == 8
    cam, lights = camera, Lights.single(capacity=1, device="cpu")
    for key in keys[:7]:
        cam, lights = animate.apply_key_rasterizer(cam, lights, key)
    want = rasterize(cornell_box(pad_to=32, device="cpu"), cam, lights, cfg)
    assert torch.equal(res.frames[6], want)
    assert not torch.equal(res.frames[0], res.frames[-1])
    with pytest.raises(ValueError, match="renderer"):
        animate.animate(cornell_box(device="cpu"), camera,
                        Lights.single(capacity=1, device="cpu"), cfg, keys,
                        renderer="scanline")


def _viewer_apps(mode):
    scene = jax_cornell_box()
    if mode == "parity":
        camera = JaxCamera.make((0.0, 0.0, -3.0), focal=16.0, y_scale=1.01,
                                dof_focus=1.9)
    else:
        camera = JaxCamera.make((0.011, -0.007, -3.013), focal=16.23,
                                dof_focus=1.9)
    lights = JaxLights.single(capacity=4)
    jax_app = JaxViewerApp(scene, camera, lights, JaxRenderConfig(
        width=16, height=16, mode=mode, use_pallas=True),
        renderer="rasterize", seed=0)
    app = ViewerApp(*_port(scene, camera, lights),
                    RenderConfig(width=16, height=16, mode=mode),
                    renderer="rasterize", seed=0)
    return jax_app, app


@pytest.mark.parametrize("mode", ["parity", "clean"])
def test_rasterize_viewer_frames_match_jax(mode):
    """Movement, DoF on (parity blurs, clean ignores it: F9), a light
    spawned, then a turn, each frame against the JAX viewer's; AA, soft
    shadows (which the rasterizer ignores) and deleting the light.

    The parity reference runs eagerly and is held to 1e-6. After the turn
    the rotation's cos/sin may differ by an ulp (ROADMAP fault F4, as in
    test_torch_cli's key transitions), which moves a shaded value by up to
    12 float32 eps of its size; that frame is held to 4e-6. The clean
    reference stays jitted (its interpret-mode kernel takes ~10 s a frame
    eagerly), where XLA:CPU contracts the shading into FMAs (F4; measured
    up to 3.4e-6): held to 8e-6, far below a winner flip's ~0.1."""
    jax_app, app = _viewer_apps(mode)
    for key in ["up", "w", "9", "2", "left"]:
        with jax.disable_jit(mode == "parity"):
            want = jax_app.handle_key(key)
        got = app.handle_key(key)
        assert {k: v for k, v in got.items() if k != "ms"} == {
            k: v for k, v in want.items() if k != "ms"}, key
        diff = np.abs(app._frame - np.asarray(jax_app._frame)).max()
        print(f"{mode} key {key}: max |d frame| {diff:.3g}")
        if mode == "parity":
            assert diff <= (4e-6 if key == "left" else 1e-6), key
        else:
            assert diff <= 8e-6, key
    assert got["renderer"] == "rasterize" and got["lights"] == 2
    frame = app._frame.copy()
    for key in ("7", "8"):
        assert app.handle_key(key)[{"7": "aa", "8": "soft_shadows"}[key]]
        np.testing.assert_array_equal(app._frame, frame)
    assert app.handle_key("3")["lights"] == 1
    assert np.abs(app._frame - frame).max() > 1e-3
    # Key 0: the soft frame, then back to clean.
    app.handle_key("0")
    assert app.cfg.mode == "soft"
    np.testing.assert_array_equal(app._frame, rasterize_soft(
        app.scene, app.camera, app.lights.compact(), app.cfg).numpy())
    app.handle_key("0")
    assert app.cfg.mode == "clean"


def test_rasterize_view_cli_serves_on_cpu():
    """``view --renderer rasterize --device cpu`` answers frame and key
    requests, key 0 with the soft frame, until interrupted."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "raytpu_torch.cli.main", "view", "--renderer",
         "rasterize", "--device", "cpu", "--width", "16", "--height", "16",
         "--mode", "clean", "--port", "0"], cwd=ROOT, stdout=subprocess.PIPE,
        text=True)
    try:
        line = proc.stdout.readline()
        base = re.search(r"http://127\.0\.0\.1:\d+", line)
        assert base, line
        base = base.group()
        with urllib.request.urlopen(base + "/state", timeout=60) as r:
            assert json.loads(r.read())["renderer"] == "rasterize"
        with urllib.request.urlopen(base + "/key?k=up", timeout=60) as r:
            assert json.loads(r.read())["frame"] >= 1
        with urllib.request.urlopen(base + "/frame.bmp", timeout=60) as r:
            assert r.status == 200 and len(r.read()) > 16 * 16 * 3
        with urllib.request.urlopen(base + "/key?k=0", timeout=60) as r:
            assert r.status == 200 and json.loads(r.read())["frame"] >= 2
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        finally:
            proc.kill()
            proc.stdout.close()
    assert proc.returncode == 0
