"""The port's animate (raytpu_torch.render.animate) and its CLI subcommand
against the JAX package's contract (raytpu/render/animate.py,
tests/test_animate.py): timing stats, BMPs written every ``save_every``
frames after the clock stops, at most MAX_PENDING frames on the device,
and the REALTIME preset (`raytracer.cpp:61-65`)."""

import json
import os

import numpy as np
import pytest
import torch

from raytpu.render import animate as jax_animate

from raytpu_torch.cli.main import main
from raytpu_torch.core.cornell import cornell_box
from raytpu_torch.core.image import quantize_u8, read_bmp
from raytpu_torch.core.types import Lights, RenderConfig
from raytpu_torch.kernels import render_fused
from raytpu_torch.render import animate
from raytpu_torch.render.raytrace import raytrace


def test_animate_renders_sequence(tmp_path):
    """tests/test_animate.py::test_animate_renders_sequence on the port."""
    scene = cornell_box(pad_to=32, device="cpu")
    camera, _ = animate.realtime_preset(device="cpu")
    cfg = RenderConfig(width=32, height=32, mode="parity")
    lights = Lights.single(capacity=1, device="cpu")
    res = animate.animate(scene, camera, lights, cfg,
                          ["left", "left", "up", "w"], renderer="raytrace",
                          out_dir=str(tmp_path), save_every=2)
    assert res.n_frames == 4
    assert res.fps > 0
    assert len(res.paths) == 2
    for p in res.paths:
        assert os.path.exists(p)
    assert [os.path.basename(p) for p in res.paths] == ["frame_0000.bmp",
                                                        "frame_0002.bmp"]
    # Motion must actually change the image.
    a = read_bmp(res.paths[0])
    b = read_bmp(res.paths[1])
    assert (a != b).any()
    assert set(vars(res)) == {f.name for f in
                              jax_animate.AnimateResult.__dataclass_fields__
                              .values()}


def test_realtime_preset_matches_reference():
    """tests/test_animate.py::test_realtime_preset_matches_reference, and
    the JAX preset's camera and config field by field."""
    camera, cfg = animate.realtime_preset(device="cpu")
    assert (cfg.width, cfg.height) == (150, 150)
    assert float(camera.focal) == 250.0
    np.testing.assert_allclose(camera.pos.numpy(), [0.0, 0.0, -4.3])
    jax_camera, jax_cfg = jax_animate.realtime_preset()
    assert cfg.mode == jax_cfg.mode == "parity"
    for name in ("pos", "yaw", "focal", "y_scale", "dof_focus"):
        np.testing.assert_array_equal(getattr(camera, name).numpy(),
                                      np.asarray(getattr(jax_camera, name)),
                                      err_msg=name)


def test_animate_drains_pending_frames_in_batches(tmp_path, monkeypatch):
    """With MAX_PENDING cut to 3, a 7-frame script saved every frame moves
    frames to the host in batches of 3 (never more than 3 tensors waiting)
    and still writes all 7, each equal to a direct render."""
    monkeypatch.setattr(animate, "MAX_PENDING", 3)
    held = []
    render = animate.raytrace

    def spy(*args):
        img = render(*args)
        held.append(img)
        return img

    monkeypatch.setattr(animate, "raytrace", spy)
    moved = []
    real_cpu = torch.Tensor.cpu

    def cpu(self, *a, **k):
        if any(self is img for img in held):
            moved.append(len(held) - 1)  # frames rendered when it moved
        return real_cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", cpu)
    keys = animate.expand_script("left*3,up*2,d*2")
    scene = cornell_box(pad_to=32, device="cpu")
    cfg = RenderConfig(width=16, height=16)
    res = animate.animate(scene, *animate.realtime_preset(device="cpu")[:1],
                          Lights.single(capacity=1, device="cpu"), cfg, keys,
                          out_dir=str(tmp_path))
    monkeypatch.setattr(torch.Tensor, "cpu", real_cpu)
    assert res.n_frames == 7 and len(res.paths) == 7
    # Frames 0-2 move after the third, 3-5 after the sixth, 6 at the end.
    assert moved == [3, 3, 3, 6, 6, 6, 7]
    cam, lights = (animate.realtime_preset(device="cpu")[0],
                   Lights.single(capacity=1, device="cpu"))
    for i, key in enumerate(keys):
        cam, lights = animate.apply_key_raytracer(cam, lights, key)
        want = raytrace(scene, cam, lights, cfg)
        assert np.array_equal(read_bmp(res.paths[i]),
                              quantize_u8(want.numpy()))


def test_animate_cli_takes_the_jax_flags(tmp_path, capsys):
    """``animate`` with JAX's flags (raytpu/cli/main.py:319-342) and the
    port's --device prints JAX's JSON line and writes the frames."""
    before = render_fused.LAUNCHES
    main(["animate", "--device", "cpu", "--script", "left*2,up,none",
          "--renderer", "raytrace", "--preset", "none", "--width", "20",
          "--height", "16", "--mode", "clean", "--dt", "20",
          "--out-dir", str(tmp_path), "--save-every", "3"])
    assert render_fused.LAUNCHES == before
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"frames", "fps", "ms_per_frame", "compile_s",
                         "saved", "out_dir"}
    assert line["frames"] == 4 and line["saved"] == 2
    assert line["out_dir"] == str(tmp_path) and line["fps"] > 0
    assert sorted(os.listdir(tmp_path)) == ["frame_0000.bmp",
                                            "frame_0003.bmp"]
    assert read_bmp(str(tmp_path / "frame_0003.bmp")).shape == (16, 20, 3)
    main(["animate", "--device", "cpu", "--script", "w", "--preset",
          "realtime", "--renderer", "rasterize", "--out-dir",
          str(tmp_path / "rt")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["frames"] == 1 and line["saved"] == 1
    assert read_bmp(str(tmp_path / "rt" / "frame_0000.bmp")).shape == (
        150, 150, 3)
    with pytest.raises(SystemExit):
        main(["animate", "--device", "cpu", "--mode", "soft"])
