"""The port's request paths: the ``render`` CLI and the animate loop
(raytpu_torch.cli.main, raytpu_torch.render.animate) against the JAX
package's."""

import argparse
import json
import re
import signal
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.image import quantize_u8
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.render import animate as jax_animate
from raytpu.render.raytrace import raytrace as jax_raytrace
from raytpu.render.soft import rasterize_soft as jax_rasterize_soft

from raytpu_torch import convert
from raytpu_torch.cli import main as cli_main
from raytpu_torch.cli.main import main
from raytpu_torch.core.cornell import cornell_box
from raytpu_torch.core.image import quantize_u8, read_bmp
from raytpu_torch.core.types import Camera, Lights, RenderConfig
from raytpu_torch.kernels import render_fused
from raytpu_torch.opt.fit import FitConfig, fit
from raytpu_torch.render import animate
from raytpu_torch.render.raytrace import raytrace
from raytpu_torch.render.soft import rasterize_soft

ROOT = Path(__file__).resolve().parents[1]


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


@pytest.mark.parametrize("mode", ["parity", "clean"])
def test_render_cli_writes_the_jax_frame(tmp_path, mode, capsys):
    out = tmp_path / "frame.bmp"
    main(["render", "--device", "cpu", "--width", "32", "--height", "32",
          "--mode", mode, "-o", str(out)])
    assert "wrote" in capsys.readouterr().out
    got = read_bmp(str(out))
    want = quantize_u8(np.asarray(jax_raytrace(
        jax_cornell_box(), JaxCamera.raytracer_default(),
        JaxLights.single(capacity=1),
        JaxRenderConfig(width=32, height=32, mode=mode))))
    assert got.shape == want.shape == (32, 32, 3)
    close = np.abs(got.astype(int) - want.astype(int)).max(axis=-1) <= 1
    assert close.mean() >= 0.999


def test_render_cli_refuses_cuda_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        main(["render", "--width", "8", "--height", "8",
              "-o", str(tmp_path / "x.bmp")])
    assert exc.value.code != 0
    assert not (tmp_path / "x.bmp").exists()


def _mesh_stl(path, n: int):
    """The first n triangles of the procedural F1 mesh as an ASCII STL."""
    from raytpu_torch.core.stl import procedural_stl_text
    lines = procedural_stl_text().splitlines()
    facets = [i for i, line in enumerate(lines)
              if line.strip().startswith("facet")]
    body = lines[facets[0]:facets[n]] if n < len(facets) else \
        lines[facets[0]:-1]
    path.write_text("\n".join([lines[0], *body, lines[-1]]) + "\n")
    return path


def test_render_cli_refuses_unported_flags(tmp_path):
    """The hard raytracer's STL scale (more than 128 triangles, parity and
    clean), once refused, renders: ``render --stl`` on the procedural
    torus of 512 triangles (4 chunks of 128 through K7a's plain version)
    writes the BMP that the JAX package's CLI writes (its jnp route, one
    chunk), u8 within 1 on >= 99.9% of pixels. The camera is nudged off
    the plane x = 0, where the torus's edges and the light line up
    (tests/test_torch_stl_raytrace.py), and the light moved in front of the
    torus, which the default light does not reach."""
    from raytpu.cli.main import main as jax_main
    from raytpu_torch.core.stl import procedural_stl_text
    stl = tmp_path / "model.stl"
    stl.write_text(procedural_stl_text(16, 16))
    flags = ["--stl", str(stl), "--width", "32", "--height", "32",
             "--focal", "32", "--camera-pos", "0.0123", "-0.5", "-5",
             "--light-pos", "0.3", "-1.5", "-3"]
    for mode in ("parity", "clean"):
        got, want = tmp_path / f"port_{mode}.bmp", tmp_path / f"jax_{mode}.bmp"
        main(["render", "--device", "cpu", "--mode", mode, *flags,
              "-o", str(got)])
        jax_main(["render", "--mode", mode, *flags, "-o", str(want)])
        a, b = read_bmp(str(got)), read_bmp(str(want))
        assert a.shape == b.shape == (32, 32, 3) and a.max() > 40
        close = np.abs(a.astype(int) - b.astype(int)).max(axis=-1) <= 1
        assert close.mean() >= 0.999, (mode, close.mean())


def test_render_cli_soft_writes_the_jax_frame(tmp_path):
    """``render --mode soft`` at an off-grid camera against the JAX
    package's soft raytrace (its jnp path), u8 within 1."""
    out = tmp_path / "soft.bmp"
    pos = (0.011, -0.007, -2.013)
    main(["render", "--device", "cpu", "--mode", "soft", "--width", "32",
          "--height", "24", "--focal", "32.23", "--camera-pos",
          *map(str, pos), "-o", str(out)])
    want = quantize_u8(np.asarray(jax_raytrace(
        jax_cornell_box(), JaxCamera.make(pos, focal=32.23, dof_focus=1.3),
        JaxLights.single(capacity=1),
        JaxRenderConfig(width=32, height=24, mode="soft"))))
    got = read_bmp(str(out))
    assert got.shape == (24, 32, 3) and got.max() > 80
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_render_cli_soft_stl_runs_unculled_and_refuses_the_culled(tmp_path):
    """``render --mode soft --stl``: several chunks at a size that does not
    block into JAX's 1,024-pixel tiles run the unmasked kernels' plain
    versions and match raytrace_soft with cull=False; at a size that
    blocks (32^2), the CLI culls as JAX would, through the masked kernels'
    plain versions, and its BMP is the u8 of raytrace_soft with cull=True.
    (The name dates from before the culled frame was ported.)"""
    from raytpu_torch.render.soft import raytrace_soft
    stl = _mesh_stl(tmp_path / "model.stl", 70)
    parser = argparse.ArgumentParser()
    cli_main._render_flags(parser)
    for size, cull in (((24, 20), False), ((32, 32), True)):
        out = tmp_path / f"stl{size[0]}.bmp"
        flags = ["--mode", "soft", "--stl", str(stl), "--width",
                 str(size[0]), "--height", str(size[1])]
        main(["render", "--device", "cpu", *flags, "-o", str(out)])
        scene, camera, lights, cfg = cli_main._build_inputs(
            parser.parse_args(["--device", "cpu", *flags]))
        assert scene.num_triangles == 70
        want = raytrace_soft(scene, camera, lights, cfg, cull=cull)
        np.testing.assert_array_equal(read_bmp(str(out)),
                                      quantize_u8(want.numpy()))


def test_render_cli_renders_the_loop_branch(tmp_path):
    """AA, soft shadows, a second light and DoF: the full-feature frame."""
    out = tmp_path / "full.bmp"
    flags = ["--width", "16", "--height", "16", "--mode", "clean",
             "--focal", "8", "--aa", "3", "--soft-shadows", "4",
             "--add-light", "0.4", "-0.5", "-0.7", "1", "1", "1", "7",
             "--dof"]
    main(["render", "--device", "cpu", *flags, "-o", str(out)])
    parser = argparse.ArgumentParser()
    cli_main._render_flags(parser)
    want = raytrace(*cli_main._build_inputs(parser.parse_args(
        ["--device", "cpu", *flags])))
    got = read_bmp(str(out))
    np.testing.assert_array_equal(got, quantize_u8(want.numpy()))
    assert got[1:-1, 1:-1].max() > 80


def test_view_cli_serves_on_cpu():
    """``view --device cpu`` answers requests until interrupted."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "raytpu_torch.cli.main", "view", "--device",
         "cpu", "--width", "16", "--height", "16", "--mode", "clean",
         "--port", "0"], cwd=ROOT, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        base = re.search(r"http://127\.0\.0\.1:\d+", line)
        assert base, line
        base = base.group()
        with urllib.request.urlopen(base + "/key?k=7", timeout=60) as r:
            assert json.loads(r.read())["aa"] is True
        with urllib.request.urlopen(base + "/key?k=8", timeout=60) as r:
            assert json.loads(r.read())["soft_shadows"] is True
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        finally:
            proc.kill()
            proc.stdout.close()
    assert proc.returncode == 0


def test_expand_script_matches_jax():
    script = "left*2, up*2,w*2,a*2,none,d,s*3,down,right"
    assert animate.expand_script(script) == jax_animate.expand_script(script)
    with pytest.raises(ValueError):
        animate.expand_script("jump")


def test_key_transitions_match_jax():
    jax_camera = JaxCamera.raytracer_default()
    jax_lights = JaxLights.single(capacity=1, soft_samples=4)
    camera = convert.camera_from_numpy(leaves(jax_camera), device="cpu")
    lights = convert.lights_from_numpy(leaves(jax_lights), device="cpu")
    for key in animate.expand_script("left*2,up*2,w*2,a*2,d,s,down,right"):
        jax_camera, jax_lights = jax_animate.apply_key_raytracer(
            jax_camera, jax_lights, key)
        camera, lights = animate.apply_key_raytracer(camera, lights, key)
        # The rotation's cos/sin may differ by an ulp (see
        # test_torch_types), which the 0.1 steps carry along.
        for got, want in ((camera, jax_camera), (lights, jax_lights)):
            got = convert.to_numpy(got)
            for name, value in leaves(want).items():
                np.testing.assert_allclose(got[name], value, rtol=0,
                                           atol=1e-6)


def test_animate_renders_one_frame_per_key(tmp_path, monkeypatch):
    """Every frame is written (save_every 1) and equals a direct render of
    the state after its keys; a spy on the renderer sees the frames as
    float tensors (the first call is the warm render before the clock)."""
    keys = animate.expand_script("left*2,up*2,w*2,a*2")
    cfg = RenderConfig(width=24, height=24)
    rendered = []

    def spy(*args):
        rendered.append(raytrace(*args))
        return rendered[-1]

    monkeypatch.setattr(animate, "raytrace", spy)
    before = render_fused.LAUNCHES
    res = animate.animate(cornell_box(pad_to=32, device="cpu"),
                          Camera.raytracer_default(device="cpu"),
                          Lights.single(capacity=1, device="cpu"), cfg, keys,
                          out_dir=str(tmp_path))
    assert render_fused.LAUNCHES == before  # CPU tensors: plain version
    frames = rendered[1:]
    assert res.n_frames == len(frames) == len(res.paths) == 8
    assert res.ms_per_frame > 0 and res.fps > 0 and res.compile_s > 0
    for frame in frames:
        assert bool(torch.isfinite(frame).all())
        assert float(frame[1:-1, 1:-1].max()) > 0.3
    # Frame i is the state after keys 0..i.
    cam = Camera.raytracer_default(device="cpu")
    lights = Lights.single(capacity=1, device="cpu")
    for i, key in enumerate(keys):
        cam, lights = animate.apply_key_raytracer(cam, lights, key)
        want = raytrace(cornell_box(pad_to=32, device="cpu"), cam, lights,
                        cfg)
        assert res.paths[i] == str(tmp_path / f"frame_{i:04d}.bmp")
        assert np.array_equal(read_bmp(res.paths[i]),
                              quantize_u8(want.numpy()))
        if i == 6:
            assert torch.equal(frames[6], want)
    with pytest.raises(ValueError):
        animate.animate(cornell_box(device="cpu"),
                        Camera.raytracer_default(device="cpu"),
                        Lights.single(capacity=1, device="cpu"), cfg, [])


def test_fit_cli_trains_on_cpu(tmp_path, capsys):
    """``fit TARGET --device cpu``: the JAX CLI's set-up (the box, camera
    (0, 0, -3) at focal = the target's width, y_scale 1.01, one light at
    --init-intensity), the fit's final loss printed, the result rendered
    at sharpness 400 / 4000 to --output."""
    from raytpu_torch.core.image import write_bmp
    W, H = 24, 20
    camera = Camera.make((0.0, 0.0, -3.0), focal=float(W), y_scale=1.01,
                         device="cpu")
    cfg = RenderConfig(width=W, height=H, mode="soft")
    with torch.no_grad():
        img = rasterize_soft(cornell_box(device="cpu"), camera,
                             Lights.single(capacity=1, device="cpu"),
                             cfg.replace(soft_edge_sharpness=40.0,
                                         soft_z_sharpness=200.0))
    target = tmp_path / "target.bmp"
    write_bmp(str(target), img.numpy())
    out = tmp_path / "fit.bmp"
    main(["fit", str(target), "--device", "cpu", "--steps", "4", "-o",
          str(out)])
    printed = capsys.readouterr().out
    want = fit(read_bmp(str(target)).astype(np.float32) / 255.0,
               cornell_box(device="cpu"), camera,
               Lights.single(capacity=1, intensity=10.0, device="cpu"), cfg,
               FitConfig(steps=4))
    assert f"final loss: {want.losses[-1]:.6f}" in printed
    assert want.losses[-1] < want.losses[0]
    with torch.no_grad():
        frame = rasterize_soft(want.scene, camera, want.lights,
                               cfg.replace(soft_edge_sharpness=400.0,
                                           soft_z_sharpness=4000.0))
    np.testing.assert_array_equal(read_bmp(str(out)),
                                  quantize_u8(frame.numpy()))
    # --mesh: one rank under a plain python -m (a 1x1 mesh), and two
    # ranks under torchrun (2x1), each printing the unsharded fit's loss
    # and writing its frame (fresh processes: the process group is global
    # state).
    for launcher, mesh in (([sys.executable], "1x1"),
                           ([sys.executable, "-m",
                             "torch.distributed.run", "--standalone",
                             "--nproc-per-node", "2"], "2x1")):
        mesh_out = tmp_path / f"fit{mesh}.bmp"
        proc = subprocess.run(
            [*launcher, "-m", "raytpu_torch.cli.main", "fit", str(target),
             "--device", "cpu", "--steps", "4", "-o", str(mesh_out),
             "--mesh", mesh], cwd=ROOT, capture_output=True, text=True,
            timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert proc.stdout.count("final loss:") == 1  # rank 0 alone
        assert f"final loss: {want.losses[-1]:.6f}" in proc.stdout
        assert np.abs(read_bmp(str(mesh_out)).astype(int)
                      - read_bmp(str(out)).astype(int)).max() <= 1


def test_fit_cli_trains_the_raytracer_on_cpu(tmp_path, capsys):
    """``fit TARGET --renderer raytrace --device cpu``: the soft raytracer
    trains (the fit's own loss printed) and the final frame is still the
    soft rasterizer's at 400 / 4000, as in the JAX CLI."""
    from raytpu_torch.core.image import write_bmp
    W, H = 24, 20
    camera = Camera.make((0.0, 0.0, -3.0), focal=float(W), y_scale=1.01,
                         device="cpu")
    cfg = RenderConfig(width=W, height=H, mode="soft")
    with torch.no_grad():
        img = rasterize_soft(cornell_box(device="cpu"), camera,
                             Lights.single(capacity=1, device="cpu"),
                             cfg.replace(soft_edge_sharpness=40.0,
                                         soft_z_sharpness=200.0))
    target = tmp_path / "target.bmp"
    write_bmp(str(target), img.numpy())
    out = tmp_path / "fit.bmp"
    main(["fit", str(target), "--device", "cpu", "--steps", "4",
          "--renderer", "raytrace", "-o", str(out)])
    printed = capsys.readouterr().out
    want = fit(read_bmp(str(target)).astype(np.float32) / 255.0,
               cornell_box(device="cpu"), camera,
               Lights.single(capacity=1, intensity=10.0, device="cpu"), cfg,
               FitConfig(steps=4, renderer="raytrace"))
    assert f"final loss: {want.losses[-1]:.6f}" in printed
    assert np.isfinite(want.losses).all()
    with torch.no_grad():
        frame = rasterize_soft(want.scene, camera, want.lights,
                               cfg.replace(soft_edge_sharpness=400.0,
                                           soft_z_sharpness=4000.0))
    np.testing.assert_array_equal(read_bmp(str(out)),
                                  quantize_u8(frame.numpy()))


def test_rasterize_cli_soft_writes_the_jax_frame(tmp_path):
    """``rasterize --mode soft`` at an off-grid camera (ROADMAP fault F4)
    against the JAX package's soft frame, u8 within 1."""
    out = tmp_path / "soft.bmp"
    pos = (0.011, -0.007, -3.013)
    main(["rasterize", "--device", "cpu", "--mode", "soft", "--width", "32",
          "--height", "24", "--focal", "32.23", "--camera-pos",
          *map(str, pos), "-o", str(out)])
    want = quantize_u8(np.asarray(jax_rasterize_soft(
        jax_cornell_box(), JaxCamera.make(pos, focal=32.23, dof_focus=1.9),
        JaxLights.single(capacity=1),
        JaxRenderConfig(width=32, height=24, mode="soft"))))
    got = read_bmp(str(out))
    assert got.shape == (24, 32, 3) and got.max() > 80
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
