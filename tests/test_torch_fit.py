"""The port's inverse-rendering fit (raytpu_torch.opt.fit) against the JAX
package's (raytpu/opt/fit.py), on the CPU.

The optimizer is held to optax on identical gradient sequences (a
gradient near rounding level can flip Adam's first step, lr * sign(g),
between two packages, so the fits are held by their loss curves); the fit
to JAX's fit through its Pallas kernel in interpret mode (the kernel's own
math); the options, checkpoints and logs as tests/test_fit_cli.py and
tests/test_fit_options.py check the JAX package's, with the rasterizer.
"""

import dataclasses
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.opt import fit as jax_fit
from raytpu.render.soft import rasterize_soft as jax_rasterize_soft

from raytpu_torch import convert
from raytpu_torch.core.cornell import cornell_box
from raytpu_torch.core.image import read_bmp
from raytpu_torch.core.types import Camera, Lights, RenderConfig, Scene
from raytpu_torch.opt import fit as fit_mod
from raytpu_torch.opt.fit import FitConfig, fit
from raytpu_torch.render.soft import rasterize_soft

SIZE = 24
ONE_STAGE = ((10.0, 20.0, 1.0),)


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


def _camera():
    return Camera.make((0.0, 0.0, -3.0), focal=float(SIZE), y_scale=1.01,
                       device="cpu")


def _start_lights():
    return Lights.single(capacity=1, intensity=8.0,
                         position=(0.2, -0.3, -0.5), device="cpu")


@pytest.fixture(scope="module")
def target():
    """The sharp soft render of the box with the reference light."""
    with torch.no_grad():
        return rasterize_soft(
            cornell_box(device="cpu"), _camera(),
            Lights.single(capacity=1, device="cpu"),
            RenderConfig(width=SIZE, height=SIZE, mode="soft",
                         soft_edge_sharpness=40.0,
                         soft_z_sharpness=200.0)).numpy()


def _fit(target, lights=None, **kw):
    kw.setdefault("log_every", 0)
    kw.setdefault("stages", ONE_STAGE)
    return fit(target, cornell_box(device="cpu"), _camera(),
               lights or _start_lights(),
               RenderConfig(width=SIZE, height=SIZE, mode="soft"),
               FitConfig(**kw))


@pytest.mark.parametrize("optimizer,schedule,stage_reset", [
    ("adam", "constant", False), ("adam", "cosine", False),
    ("sgd", "constant", False), ("sgd", "cosine", False),
    ("adam", "cosine", True)])
def test_optimizer_matches_optax(optimizer, schedule, stage_reset):
    """Ten updates on one gradient sequence (every leaf, the frozen ones
    too): the four groups with their own rates, the frozen leaves still,
    and with stage_reset a fresh optimizer (and cosine restart) after 5.

    The parameters agree to rtol 1e-6 / atol 1e-7, Adam's within a
    further 1e-5 of the leaf's largest update: optax computes its bias
    correction 1 - b2^t in float32 with b2 = float32(0.999),
    torch.optim.Adam in float64 with 0.999; the two differ by 1.3e-5
    relative, 6.4e-6 after the square root, and the moments agree."""
    kw = dict(steps=10, optimizer=optimizer, lr_schedule=schedule,
              lr_vertices=2e-3, lr_colors=3e-2, lr_lights=5e-2,
              lr_light_color=7e-3, stage_reset=stage_reset)
    jcfg = jax_fit.FitConfig(**kw)
    scene, lights = jax_cornell_box(), JaxLights.single(capacity=1)
    params = (scene, lights)
    port = fit_mod.params_of(
        convert.scene_from_numpy(leaves(scene), device="cpu"),
        convert.lights_from_numpy(leaves(lights), device="cpu"))
    steps = 5 if stage_reset else None
    jopt = jax_fit._make_optimizer(jcfg, steps=steps)
    jstate = jopt.init(params)
    opt, sched = fit_mod.make_optimizer(FitConfig(**kw), port, steps=steps)
    rng = np.random.default_rng(3)
    for k in range(10):
        if stage_reset and k == 5:
            jopt = jax_fit._make_optimizer(jcfg, steps=5)
            jstate = jopt.init(params)
            opt, sched = fit_mod.make_optimizer(FitConfig(**kw), port,
                                                steps=5)
        grads = {n: rng.normal(size=p.shape).astype(np.float32)
                 for n, p in port.items()}
        jgrads = (type(scene)(**{f: jnp.asarray(grads[f"scene.{f}"])
                                 for f in vars(scene)}),
                  type(lights)(**{f: jnp.asarray(grads[f"lights.{f}"])
                                  for f in vars(lights)}))
        updates, jstate = jopt.update(jgrads, jstate, params)
        params = optax.apply_updates(params, updates)
        for n, p in port.items():
            p.grad = torch.tensor(grads[n])
        fit_mod.optimizer_step(opt, sched)
    starts = (leaves(jax_cornell_box()), leaves(JaxLights.single(capacity=1)))
    for value, prefix, start in zip(params, ("scene", "lights"), starts):
        for field, want in leaves(value).items():
            got = port[f"{prefix}.{field}"].detach().numpy()
            moved = np.abs(want - start[field]).max()
            atol = 1e-7 + (1e-5 * moved if optimizer == "adam" else 0.0)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol,
                                       err_msg=field)
    start = starts[0]
    assert np.array_equal(port["scene.active"].detach().numpy(),
                          start["active"])
    assert not np.array_equal(port["scene.v0"].detach().numpy(), start["v0"])


def test_fit_matches_jax_fit():
    """One stage, 4 Adam steps at 24 x 20 against JAX's fit through its
    Pallas kernel (interpret mode): the loss curve and the logged gradient
    norm (which spans Scene.active, as optax.global_norm does) within
    rtol 1e-3."""
    W, H = 24, 20
    scene = jax_cornell_box()
    cam = JaxCamera.make((0.0, 0.0, -3.0), focal=float(W), y_scale=1.01)
    target = np.asarray(jax_rasterize_soft(
        scene, cam, JaxLights.single(capacity=1),
        JaxRenderConfig(width=W, height=H, mode="soft",
                        soft_edge_sharpness=40.0, soft_z_sharpness=200.0)))
    li0 = JaxLights.single(capacity=1, intensity=8.0,
                           position=(0.2, -0.3, -0.5))
    kw = dict(steps=4, log_every=1, stages=ONE_STAGE)
    jstream, stream = io.StringIO(), io.StringIO()
    want = jax_fit.fit(target, scene, cam, li0,
                       JaxRenderConfig(width=W, height=H, mode="soft",
                                       use_pallas=True),
                       jax_fit.FitConfig(metrics_stream=jstream, **kw))
    got = fit(target, convert.scene_from_numpy(leaves(scene), device="cpu"),
              convert.camera_from_numpy(leaves(cam), device="cpu"),
              convert.lights_from_numpy(leaves(li0), device="cpu"),
              RenderConfig(width=W, height=H, mode="soft"),
              FitConfig(metrics_stream=stream, **kw))
    print("losses", want.losses, got.losses)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-3)
    assert got.losses[-1] < got.losses[0]
    jrec = [json.loads(x) for x in jstream.getvalue().splitlines()]
    rec = [json.loads(x) for x in stream.getvalue().splitlines()]
    assert [r["step"] for r in rec] == [r["step"] for r in jrec] == [1, 2, 3, 4]
    np.testing.assert_allclose([r["grad_norm"] for r in rec],
                               [r["grad_norm"] for r in jrec], rtol=1e-3)


def test_raytrace_fit_matches_jax_fit():
    """renderer='raytrace': one stage (10 / 20, where the soft shadow
    darkens the direct term to a few percent: tests/test_torch_soft_raytrace
    .py::test_shadow_darkens_at_the_fits_first_stage_as_in_jax), 4
    Adam steps at 24 x 20 against JAX's fit through its soft raytrace
    kernels (interpret mode): the loss curve within rtol 1e-3."""
    W, H = 24, 20
    scene = jax_cornell_box()
    cam = JaxCamera.make((0.0, 0.0, -3.0), focal=float(W), y_scale=1.01)
    target = np.asarray(jax_rasterize_soft(
        scene, cam, JaxLights.single(capacity=1),
        JaxRenderConfig(width=W, height=H, mode="soft",
                        soft_edge_sharpness=40.0, soft_z_sharpness=200.0)))
    li0 = JaxLights.single(capacity=1, intensity=8.0,
                           position=(0.2, -0.3, -0.5))
    kw = dict(steps=4, log_every=0, stages=ONE_STAGE, renderer="raytrace")
    want = jax_fit.fit(target, scene, cam, li0,
                       JaxRenderConfig(width=W, height=H, mode="soft",
                                       use_pallas=True),
                       jax_fit.FitConfig(**kw))
    got = fit(target, convert.scene_from_numpy(leaves(scene), device="cpu"),
              convert.camera_from_numpy(leaves(cam), device="cpu"),
              convert.lights_from_numpy(leaves(li0), device="cpu"),
              RenderConfig(width=W, height=H, mode="soft"), FitConfig(**kw))
    print("losses", want.losses, got.losses)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-3)
    assert got.losses[-1] < got.losses[0]


def test_raytrace_fit_traces_the_bank_as_given(target, monkeypatch):
    """The fit, like JAX's, passes the light bank uncompacted: a 2-slot bank
    with one active light traces 2 shadow sources (the inactive one weighs
    0), where raytrace and the viewer compact it to 1."""
    from raytpu_torch.kernels import soft_raytrace as srt
    seen = []
    plain = srt.shadow_trans_fwd

    def spy(consts, srcs, *args):
        seen.append(srcs.shape[0])
        return plain(consts, srcs, *args)

    monkeypatch.setattr(srt, "shadow_trans_fwd", spy)
    lights = Lights.single(capacity=2, intensity=8.0, device="cpu")
    res = _fit(target, lights=lights, steps=2, renderer="raytrace")
    assert seen == [2, 2] and np.isfinite(res.losses).all()
    from raytpu_torch.render.raytrace import raytrace
    raytrace(cornell_box(device="cpu"), _camera(), lights,
             RenderConfig(width=8, height=8, mode="soft"))
    assert seen[-1] == 1


def test_fit_converges(target):
    res = _fit(target, steps=60)
    assert res.losses[-1] < res.losses[0] * 0.2
    assert isinstance(res.scene, Scene) and not res.scene.v0.requires_grad


def _ckpt_params(path):
    data = np.load(path)
    scene = Scene(**{f.name: torch.tensor(data[f"param/scene.{f.name}"])
                     for f in dataclasses.fields(Scene)})
    lights = Lights(**{f.name: torch.tensor(data[f"param/lights.{f.name}"])
                       for f in dataclasses.fields(Lights)})
    return scene, lights


def test_checkpoint_resume_is_bit_identical(target, tmp_path):
    """A fit checkpointed after 3 of 6 steps and resumed for 3 ends on the
    straight run's parameters bit for bit: parameters, Adam's moments and
    step count, the schedule's count."""
    straight = _fit(target, steps=6, checkpoint_every=3,
                    checkpoint_dir=str(tmp_path))
    ckpt = str(tmp_path / "ckpt_3.npz")
    data = np.load(ckpt)
    assert int(data["__step__"]) == 3 and int(data["sched/count"]) == 3
    assert float(data["opt/scene.v0/step"]) == 3.0
    assert "opt/scene.active/exp_avg" not in data.files  # frozen
    resumed = fit(target, cornell_box(device="cpu"), _camera(),
                  _start_lights(),
                  RenderConfig(width=SIZE, height=SIZE, mode="soft"),
                  FitConfig(steps=3, stages=ONE_STAGE, log_every=0),
                  resume_from=ckpt)
    np.testing.assert_array_equal(resumed.losses, straight.losses[3:])
    for a, b in ((resumed.scene, straight.scene),
                 (resumed.lights, straight.lights)):
        for field in vars(a):
            assert torch.equal(getattr(a, field), getattr(b, field)), field


def test_resume_reruns_the_stage_schedule_f10(target, tmp_path):
    """ROADMAP fault F10, kept from the JAX package: resume runs every
    stage again after the restored step, and stage_reset throws the
    restored optimizer state away at stage 0, so the resumed fit equals a
    fresh fit from the checkpoint's parameters."""
    kw = dict(steps=4, stages=((10.0, 20.0, 0.5), (40.0, 200.0, 0.5)),
              stage_reset=True, lr_schedule="cosine")
    _fit(target, checkpoint_every=2, checkpoint_dir=str(tmp_path), **kw)
    ckpt = str(tmp_path / "ckpt_2.npz")
    cfg = RenderConfig(width=SIZE, height=SIZE, mode="soft")
    resumed = fit(target, cornell_box(device="cpu"), _camera(),
                  _start_lights(), cfg, FitConfig(log_every=0, **kw),
                  resume_from=ckpt)
    assert len(resumed.losses) == 4  # the whole schedule, not 4 - 2
    scene, lights = _ckpt_params(ckpt)
    fresh = fit(target, scene, _camera(), lights, cfg,
                FitConfig(log_every=0, **kw))
    np.testing.assert_array_equal(resumed.losses, fresh.losses)
    for field in vars(fresh.scene):
        assert torch.equal(getattr(resumed.scene, field),
                           getattr(fresh.scene, field)), field


def test_checkpoint_refuses_other_shapes(target, tmp_path):
    _fit(target, steps=1, checkpoint_every=1, checkpoint_dir=str(tmp_path))
    params = fit_mod.params_of(cornell_box(pad_to=64, device="cpu"),
                               _start_lights())
    opt, sched = fit_mod.make_optimizer(FitConfig(), params)
    with pytest.raises(ValueError, match="shape"):
        fit_mod.load_checkpoint(str(tmp_path / "ckpt_1.npz"), params, opt,
                                sched)


@pytest.mark.parametrize("loss", ["mse", "chroma", "chroma+edge", "none"])
def test_loss_modes(target, loss):
    """Each mode's first loss is its formula on the starting render;
    'none' with extra_loss trains on the extra term alone."""
    extra = None
    if loss == "none":
        t = torch.tensor(target)

        def extra(img):
            return torch.mean((img - t) ** 2)

    res = _fit(target, steps=2, loss=loss, extra_loss=extra)
    with torch.no_grad():
        img = rasterize_soft(cornell_box(device="cpu"), _camera(),
                             _start_lights(),
                             RenderConfig(width=SIZE, height=SIZE,
                                          mode="soft",
                                          soft_edge_sharpness=10.0,
                                          soft_z_sharpness=20.0)).numpy()
    img, tgt = img.astype(np.float64), target.astype(np.float64)

    def chroma(x):
        return x / (x.sum(axis=-1, keepdims=True) + 0.15)

    mse = np.mean((img - tgt) ** 2)
    ch = np.mean((chroma(img) - chroma(tgt)) ** 2) + 0.05 * mse
    ca, cb = chroma(img), chroma(tgt)
    edge = (np.mean(((ca[1:] - ca[:-1]) - (cb[1:] - cb[:-1])) ** 2)
            + np.mean(((ca[:, 1:] - ca[:, :-1]) - (cb[:, 1:] - cb[:, :-1]))
                      ** 2))
    want = {"mse": mse, "chroma": ch, "chroma+edge": ch + 4.0 * edge,
            "none": mse}[loss]
    np.testing.assert_allclose(res.losses[0], want, rtol=1e-5)
    assert np.isfinite(res.losses).all() and res.losses[1] < res.losses[0]


def _moved(res):
    start_s, start_l = cornell_box(device="cpu"), _start_lights()
    return {"dcolor": float((res.scene.color - start_s.color).abs().max()),
            "dlight_color": float((res.lights.color
                                   - start_l.color).abs().max()),
            "dverts": float((res.scene.v0 - start_s.v0).abs().max())}


def test_groups_and_frozen_rates(target):
    """tests/test_fit_options.py's group checks: every group moves by
    default; lr 0 freezes colors and light color; light color follows
    lr_lights when its own rate is None; the frozen leaves never move."""
    d = _moved(_fit(target, steps=3))
    assert d["dcolor"] > 0 and d["dlight_color"] > 0 and d["dverts"] > 0
    d = _moved(_fit(target, steps=3, lr_colors=0.0, lr_light_color=0.0))
    assert d["dcolor"] == 0.0 and d["dlight_color"] == 0.0 and d["dverts"] > 0
    res = _fit(target, steps=3, lr_lights=0.0)
    d = _moved(res)
    assert d["dlight_color"] == 0.0 and d["dcolor"] > 0
    assert torch.equal(res.scene.active, cornell_box(device="cpu").active)
    assert torch.equal(res.lights.mask, _start_lights().mask)
    assert torch.equal(res.lights.jitter, _start_lights().jitter)


def test_sgd_prox_and_pure_extra(target):
    """SGD lowers the loss; loss 'none' with only prox is zero and moves
    nothing; a large prox_to_init holds the vertices nearer the start."""
    sgd = dict(optimizer="sgd", lr_vertices=1e-4, lr_lights=3e-3,
               lr_colors=1e-4, lr_light_color=3e-3)
    res = _fit(target, steps=3, **sgd)
    assert res.losses[-1] < res.losses[0]
    res = _fit(target, steps=3, loss="none", prox_to_init=5.0)
    assert _moved(res)["dverts"] == 0.0 and not res.losses.any()
    t = torch.tensor(target)

    def extra(img):
        return torch.mean((img - t) ** 2)

    frozen = dict(lr_colors=0.0, lr_lights=0.0, lr_light_color=0.0)
    free = _fit(target, steps=3, loss="none", extra_loss=extra,
                optimizer="sgd", lr_vertices=3e-2, **frozen)
    prox = _fit(target, steps=3, loss="none", extra_loss=extra,
                optimizer="sgd", lr_vertices=3e-2, prox_to_init=1e2, **frozen)
    assert prox.losses[0] == free.losses[0]
    assert 0.0 < _moved(prox)["dverts"] < _moved(free)["dverts"]


def test_unknown_options_raise(target):
    with pytest.raises(ValueError, match="unknown optimizer"):
        _fit(target, steps=1, optimizer="adagrad")
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        _fit(target, steps=1, lr_schedule="linear")
    with pytest.raises(ValueError, match="unknown select"):
        _fit(target, steps=1, select="first")
    with pytest.raises(ValueError, match="unknown renderer"):
        _fit(target, steps=1, renderer="scanline")


_MESH_FIT = """
import sys
import numpy as np
import torch
from raytpu_torch.core.cornell import cornell_box
from raytpu_torch.core.types import Camera, Lights, RenderConfig
from raytpu_torch.opt.fit import FitConfig, fit
from raytpu_torch.parallel import (init_distributed, make_mesh,
                                   shutdown_distributed)
target, out = sys.argv[1], sys.argv[2]
init_distributed(device="cpu")
try:
    res = fit(np.load(target), cornell_box(device="cpu"),
              Camera.make((0.0, 0.0, -3.0), focal=24.0, y_scale=1.01,
                          device="cpu"),
              Lights.single(capacity=1, intensity=8.0,
                            position=(0.2, -0.3, -0.5), device="cpu"),
              RenderConfig(width=24, height=24, mode="soft"),
              FitConfig(steps=3, log_every=0, stages=((10.0, 20.0, 1.0),)),
              mesh=make_mesh(1, 1, device="cpu"))
    np.save(out, res.losses)
finally:
    shutdown_distributed()
"""


def test_unported_routes_raise_naming_their_items(target, tmp_path):
    """The route that raised naming port item 8, ``fit(mesh=...)``, runs:
    on a 1 x 1 mesh of one rank (a fresh process: the process group is
    global state) it follows the unsharded fit at rtol 1e-4."""
    import subprocess
    import sys
    assert SIZE == 24 and ONE_STAGE == ((10.0, 20.0, 1.0),)
    np.save(tmp_path / "target.npy", target)
    proc = subprocess.run(
        [sys.executable, "-c", _MESH_FIT, str(tmp_path / "target.npy"),
         str(tmp_path / "losses.npy")],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = _fit(target, steps=3).losses
    np.testing.assert_allclose(np.load(tmp_path / "losses.npy"), want,
                               rtol=1e-4)


def test_metrics_stream_and_image_dumps(target, tmp_path):
    """tests/test_fit_cli.py's observability check: one JSON line per
    log_every steps with its six keys, and BMP dumps."""
    stream = io.StringIO()
    _fit(target, steps=8, log_every=2, metrics_stream=stream,
         image_dump_every=4, image_dump_dir=str(tmp_path))
    records = [json.loads(x) for x in stream.getvalue().strip().splitlines()]
    assert [r["step"] for r in records] == [2, 4, 6, 8]
    for rec in records:
        for key in ("step", "stage", "loss", "grad_norm", "ms_per_step",
                    "mrays_per_s"):
            assert key in rec, f"missing {key}: {rec}"
        assert rec["grad_norm"] > 0.0 and np.isfinite(rec["loss"])
    dumps = sorted(os.listdir(tmp_path))
    assert dumps == ["fit_000004.bmp", "fit_000008.bmp"]
    assert read_bmp(str(tmp_path / "fit_000008.bmp")).shape == (SIZE, SIZE, 3)


def test_stage_reset_and_best_select(target):
    """tests/test_fit_cli.py's check: select 'best' returns the parameters
    eval_fn scored highest (here the first evaluated), not the last."""
    seen = []

    def ev(scene, lights):
        seen.append(float(lights.intensity[0]))
        return -float(len(seen))

    res = _fit(target, steps=8, lr_schedule="cosine",
               stages=((10.0, 20.0, 0.5), (40.0, 200.0, 0.5)),
               stage_reset=True, eval_fn=ev, eval_every=2, select="best")
    assert res.best_score == -1.0
    assert [s for s, _ in res.evals] == [2, 4, 6, 8]
    assert float(res.lights.intensity[0]) == seen[0]
    assert seen[0] != seen[-1]
