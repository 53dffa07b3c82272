"""Inverse rendering: fit scene and light parameters to a target image
(counterpart of raytpu/opt/fit.py).

The soft rasterizer (render/soft.py::rasterize_soft, whose aggregation runs
in the soft raster kernels on a card) or the soft raytracer
(``renderer="raytrace"``: render/soft.py::raytrace_soft, the soft raytrace
kernels, with the light bank as given, not compacted) under an image loss;
Adam or SGD in parameter groups (vertices, albedo, light position and
intensity, light color); annealing stages that raise the soft sharpness so the fit moves
toward the hard image; npz checkpoints with exact resume.

The JAX package's optax chain maps onto torch.optim as follows:

  * one parameter group per optax label: verts (v0, v1, v2), colors
    (Scene.color), lights (Lights.position, Lights.intensity) and
    light_color (Lights.color). ``Scene.active``, ``Lights.mask`` and
    ``Lights.jitter`` are in no group, so they never move, like optax's
    ``set_to_zero``; they still take a gradient, and ``grad_norm`` counts
    it, as ``optax.global_norm`` spans every leaf.
  * a trainable leaf the loss does not reach takes a zero gradient, as
    ``jax.grad`` gives, so Adam's moments decay on it as optax's do.
  * the cosine schedule is optax's closed form,
    ``lr * ((1 - alpha) * (1 + cos(pi * min(k, K) / K)) / 2 + alpha)``, in
    a LambdaLR stepped once after each optimizer step.

``fit(resume_from=...)`` reruns the whole stage schedule after the restored
step, and with ``stage_reset`` discards the restored optimizer state at
stage 0: the JAX package's behaviour, kept (ROADMAP.md fault F10).

``fit(mesh=...)`` trains through the sharded soft renderer
(raytpu_torch/parallel/render.py: rows over 'data', triangles over
'model'), every rank of the mesh holding the full target and the same
parameters. Each step gathers the image on every rank, differentiates its
loss there at 1 / world size and sums the gradients over the world
(``reduce_grads``), so every rank takes the single-process step with the
same bits. Rank 0 alone writes checkpoints, images and log lines.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from raytpu_torch.core.types import Camera, Lights, RenderConfig, Scene
from raytpu_torch.utils.profiling import FrameTimer, log_metrics


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """The JAX package's FitConfig: the same fields and defaults (see
    raytpu/opt/fit.py for why each exists)."""

    steps: int = 500
    lr_vertices: float = 1e-3
    lr_colors: float = 1e-2
    lr_lights: float = 1e-2
    # Light color's own group; None follows lr_lights.
    lr_light_color: float | None = None
    optimizer: str = "adam"  # or "sgd"
    # Adds prox_to_init * sum(mean((p - p_init)^2)) over every leaf.
    prox_to_init: float = 0.0
    renderer: str = "rasterize"  # or "raytrace"
    # 'mse', 'chroma', 'chroma+edge' or 'none' (extra_loss and prox only);
    # any other value is mse, as in the JAX package.
    loss: str = "mse"
    lr_schedule: str = "constant"  # or 'cosine', decaying to alpha * lr
    lr_schedule_alpha: float = 0.05
    # (edge_sharpness, z_sharpness, fraction_of_steps) annealing stages.
    stages: tuple = ((10.0, 20.0, 0.5), (40.0, 200.0, 0.5))
    checkpoint_every: int = 100
    checkpoint_dir: str | None = None
    log_every: int = 50
    # One JSON line per log_every steps ({"step", "stage", "loss",
    # "grad_norm", "ms_per_step", "mrays_per_s"}); stderr by default.
    metrics_stream: object = None
    # Dump the render as BMP every N steps (0 = off) into image_dump_dir
    # (defaults to checkpoint_dir).
    image_dump_every: int = 0
    image_dump_dir: str | None = None
    # A new optimizer (and cosine restart over the stage) at every stage.
    stage_reset: bool = False
    # Every eval_every steps eval_fn(scene, lights) -> float, higher is
    # better; select "best" returns the best-scoring parameters.
    eval_fn: Callable | None = None
    eval_every: int = 0
    select: str = "last"
    # extra_loss(img) -> scalar, added to the base loss.
    extra_loss: Callable | None = None


class FitResult(NamedTuple):
    scene: Scene
    lights: Lights
    losses: np.ndarray
    # (step, score) pairs from eval_fn, empty when eval is off.
    evals: tuple = ()
    best_score: float | None = None


# The leaves in the JAX package's pytree order (Scene, then Lights), each
# with its optimizer group (None: frozen).
LEAVES = (
    ("scene.v0", "verts"), ("scene.v1", "verts"), ("scene.v2", "verts"),
    ("scene.color", "colors"), ("scene.active", None),
    ("lights.position", "lights"), ("lights.color", "light_color"),
    ("lights.intensity", "lights"), ("lights.mask", None),
    ("lights.jitter", None),
)
GROUPS = ("verts", "colors", "lights", "light_color")


def params_of(scene: Scene, lights: Lights) -> dict:
    """Fresh float32 leaf tensors of scene and lights that take gradients,
    keyed ``scene.<field>`` / ``lights.<field>``, in LEAVES order."""
    values = {"scene": scene, "lights": lights}
    out = {}
    for name, _ in LEAVES:
        owner, field = name.split(".")
        out[name] = getattr(values[owner], field).detach().clone() \
            .requires_grad_(True)
    return out


def scene_lights(params: dict, detach: bool = False):
    """The Scene and Lights whose leaves are the tensors of ``params``."""
    def get(name):
        return params[name].detach() if detach else params[name]
    return (Scene(**{f.name: get(f"scene.{f.name}")
                     for f in dataclasses.fields(Scene)}),
            Lights(**{f.name: get(f"lights.{f.name}")
                      for f in dataclasses.fields(Lights)}))


def cosine_factor(k: int, steps: int, alpha: float) -> float:
    """optax.cosine_decay_schedule's factor at count k, in closed form."""
    k = min(k, steps)
    return (1.0 - alpha) * (0.5 * (1.0 + math.cos(math.pi * k / steps))) \
        + alpha


def make_optimizer(fit_cfg: FitConfig, params: dict, steps: int | None = None):
    """The optimizer over the four groups and its LambdaLR schedule
    (``_make_optimizer``); ``steps`` is the cosine schedule's length
    (default fit_cfg.steps)."""
    lr_lc = (fit_cfg.lr_lights if fit_cfg.lr_light_color is None
             else fit_cfg.lr_light_color)
    if fit_cfg.optimizer == "adam":
        def opt_cls(groups):
            return torch.optim.Adam(groups, lr=0.0, betas=(0.9, 0.999),
                                    eps=1e-8)
    elif fit_cfg.optimizer == "sgd":
        def opt_cls(groups):
            return torch.optim.SGD(groups, lr=0.0)
    else:
        raise ValueError(f"unknown optimizer {fit_cfg.optimizer!r}")
    if fit_cfg.lr_schedule == "cosine":
        decay = max(steps or fit_cfg.steps, 1)
        alpha = fit_cfg.lr_schedule_alpha

        def factor(k):
            return cosine_factor(k, decay, alpha)
    elif fit_cfg.lr_schedule == "constant":
        def factor(k):
            return 1.0
    else:
        raise ValueError(f"unknown lr_schedule {fit_cfg.lr_schedule!r}")
    lr = {"verts": fit_cfg.lr_vertices, "colors": fit_cfg.lr_colors,
          "lights": fit_cfg.lr_lights, "light_color": lr_lc}
    opt = opt_cls([dict(params=[params[n] for n, g in LEAVES if g == group],
                        lr=lr[group], group=group) for group in GROUPS])
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def trainable(opt) -> list:
    return [p for group in opt.param_groups for p in group["params"]]


def optimizer_step(opt, sched) -> None:
    """One update from the leaves' ``.grad`` (zero where None, as jax.grad
    gives), then one step of the schedule."""
    for p in trainable(opt):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.step()
    sched.step()


def _loss_fn(fit_cfg: FitConfig, target: torch.Tensor, params: dict,
             params_init: dict) -> Callable:
    """The loss of an image, with the prox term on ``params``."""
    def chroma(x):
        return x / (x.sum(dim=-1, keepdim=True) + 0.15)

    def edge_term(a, b):
        # Image gradients of the chroma channels: a misplaced silhouette
        # is a displaced edge line.
        ca, cb = chroma(a), chroma(b)
        dya, dyb = ca[1:, :] - ca[:-1, :], cb[1:, :] - cb[:-1, :]
        dxa, dxb = ca[:, 1:] - ca[:, :-1], cb[:, 1:] - cb[:, :-1]
        return (torch.mean((dya - dyb) ** 2)
                + torch.mean((dxa - dxb) ** 2))

    def loss(img):
        if fit_cfg.loss == "none":
            base = img.new_zeros(())
        elif fit_cfg.loss == "chroma":
            base = (torch.mean((chroma(img) - chroma(target)) ** 2)
                    + 0.05 * torch.mean((img - target) ** 2))
        elif fit_cfg.loss == "chroma+edge":
            base = (torch.mean((chroma(img) - chroma(target)) ** 2)
                    + 0.05 * torch.mean((img - target) ** 2)
                    + 4.0 * edge_term(img, target))
        else:
            base = torch.mean((img - target) ** 2)
        if fit_cfg.extra_loss is not None:
            base = base + fit_cfg.extra_loss(img)
        if fit_cfg.prox_to_init > 0.0:
            base = base + fit_cfg.prox_to_init * sum(
                torch.mean((params[n] - params_init[n]) ** 2)
                for n, _ in LEAVES)
        return base

    return loss


def _render_fn(renderer: str) -> Callable:
    if renderer == "rasterize":
        from raytpu_torch.render.soft import rasterize_soft
        return rasterize_soft
    if renderer == "raytrace":
        from raytpu_torch.render.soft import raytrace_soft
        return raytrace_soft
    raise ValueError(f"unknown renderer {renderer!r}")


def _stage_frame(fit_cfg: FitConfig, cfg: RenderConfig, mesh) -> Callable:
    """(scene, camera, lights) -> the (H, W, 3) frame of one stage: the
    renderer's, or on a mesh the sharded soft renderer's row blocks
    gathered into the whole image on every rank."""
    if mesh is None:
        render = _render_fn(fit_cfg.renderer)
        return lambda s, c, li: render(s, c, li, cfg)  # noqa: E731
    from raytpu_torch.parallel.render import (
        gather_image,
        make_sharded_soft_render,
    )
    sharded = make_sharded_soft_render(mesh, cfg, fit_cfg.renderer)
    return lambda s, c, li: gather_image(sharded(s, c, li), mesh)  # noqa


def fit(target, scene0: Scene, camera: Camera, lights0: Lights,
        render_cfg: RenderConfig, fit_cfg: FitConfig,
        resume_from: str | None = None, mesh=None) -> FitResult:
    """Run the inverse-rendering fit; target (H, W, 3), float. Trains on
    the scene's device. Returns detached copies of the fitted (or, with
    select "best", the best-scoring) scene and lights.

    mesh: a (data, model) DeviceMesh over every rank of the job
    (raytpu_torch.parallel.make_mesh); the fit then runs on every rank,
    through the sharded soft renderer (module docstring)."""
    _render_fn(fit_cfg.renderer)  # an unknown renderer raises up front
    world = 1 if mesh is None else mesh.size()
    writer = mesh is None or mesh.get_rank() == 0
    if mesh is not None:
        from raytpu_torch.parallel.render import reduce_grads
    device = scene0.device
    if isinstance(target, torch.Tensor):
        target = target.detach().to(device=device, dtype=torch.float32)
    else:
        target = torch.tensor(np.asarray(target, dtype=np.float32),
                              device=device)
    params = params_of(scene0, lights0)
    opt, sched = make_optimizer(fit_cfg, params)
    start_step = 0
    if resume_from is not None:
        start_step = load_checkpoint(resume_from, params, opt, sched)

    # The prox_to_init anchor (after resume).
    params_init = {n: p.detach().clone() for n, p in params.items()}
    loss_of = _loss_fn(fit_cfg, target, params, params_init)
    scene, lights = scene_lights(params)
    losses, evals = [], []
    best_score, best_params = None, params_init

    def maybe_eval(step):
        nonlocal best_score, best_params
        if fit_cfg.eval_fn is None:
            return
        score = float(fit_cfg.eval_fn(*scene_lights(params, detach=True)))
        evals.append((step, score))
        if best_score is None or score > best_score:
            best_score = score
            best_params = {n: p.detach().clone() for n, p in params.items()}

    step_counter = start_step
    timer = FrameTimer(rays_per_frame=2 * render_cfg.width
                       * render_cfg.height)  # forward + backward
    for stage_i, (edge_s, z_s, frac) in enumerate(fit_cfg.stages):
        cfg = render_cfg.replace(mode="soft", soft_edge_sharpness=edge_s,
                                 soft_z_sharpness=z_s)
        n_steps = int(fit_cfg.steps * frac)
        if fit_cfg.stage_reset:
            opt, sched = make_optimizer(fit_cfg, params, steps=n_steps)
        frame = _stage_frame(fit_cfg, cfg, mesh)

        for _ in range(n_steps):
            log = bool(fit_cfg.log_every
                       and (step_counter + 1) % fit_cfg.log_every == 0)
            with timer.frame():
                for p in params.values():
                    p.grad = None
                loss = loss_of(frame(scene, camera, lights))
                if loss.requires_grad:
                    (loss if mesh is None else loss / world).backward()
                if mesh is not None:
                    reduce_grads(params.values())
                gnorm = None
                if log:
                    gnorm = torch.sqrt(sum(
                        (p.grad.pow(2).sum() for p in params.values()
                         if p.grad is not None), loss.new_zeros(())))
                optimizer_step(opt, sched)
                loss = loss.item()  # waits for the device
            losses.append(loss)
            step_counter += 1
            if (fit_cfg.eval_every
                    and step_counter % fit_cfg.eval_every == 0):
                maybe_eval(step_counter)
            if log and writer:
                log_metrics(step_counter, stream=fit_cfg.metrics_stream,
                            stage=stage_i, loss=loss, grad_norm=gnorm,
                            ms_per_step=timer.last_ms,
                            mrays_per_s=timer.mrays_per_s())
            if (fit_cfg.image_dump_every
                    and step_counter % fit_cfg.image_dump_every == 0):
                with torch.no_grad():
                    img = frame(scene, camera, lights)
                if writer:
                    _dump_image(img, fit_cfg, step_counter)
            if (writer and fit_cfg.checkpoint_dir
                    and step_counter % fit_cfg.checkpoint_every == 0):
                save_checkpoint(os.path.join(fit_cfg.checkpoint_dir,
                                             f"ckpt_{step_counter}.npz"),
                                params, opt, sched, step_counter)

    if fit_cfg.eval_fn is not None and (
            not evals or evals[-1][0] != step_counter):
        maybe_eval(step_counter)  # always score the final parameters
    if fit_cfg.select == "best" and best_score is not None:
        out = best_params
    elif fit_cfg.select in ("last", "best"):
        out = params
    else:
        raise ValueError(f"unknown select {fit_cfg.select!r}")
    scene, lights = scene_lights(
        {n: p.detach().clone() for n, p in out.items()})
    return FitResult(scene=scene, lights=lights,
                     losses=np.asarray(losses, dtype=np.float32),
                     evals=tuple(evals), best_score=best_score)


def _dump_image(img: torch.Tensor, fit_cfg: FitConfig, step: int) -> None:
    from raytpu_torch.core.image import write_bmp

    out_dir = fit_cfg.image_dump_dir or fit_cfg.checkpoint_dir or "."
    os.makedirs(out_dir, exist_ok=True)
    write_bmp(os.path.join(out_dir, f"fit_{step:06d}.bmp"),
              img.cpu().numpy())


# ---------------------------------------------------------------------------
# Checkpoints: one npz of every parameter, the optimizer's state per
# parameter, the schedule's count and the step counter.
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, params: dict, opt, sched, step: int) -> None:
    """Write ``param/<name>``, ``opt/<name>/<state key>`` (Adam's
    exp_avg, exp_avg_sq and step; SGD keeps none), ``sched/count`` and
    ``__step__``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    name_of = {id(p): n for n, p in params.items()}
    arrays = {f"param/{n}": p.detach().cpu().numpy()
              for n, p in params.items()}
    for p in trainable(opt):
        for key, value in opt.state.get(p, {}).items():
            arrays[f"opt/{name_of[id(p)]}/{key}"] = np.asarray(
                torch.as_tensor(value).detach().cpu())
    arrays["sched/count"] = np.asarray(sched.last_epoch)
    arrays["__step__"] = np.asarray(step)
    np.savez(path, **arrays)


def load_checkpoint(path: str, params: dict, opt, sched) -> int:
    """Restore the parameters (in place), the optimizer's state and the
    schedule's count from ``path``; returns the step. Raises ValueError
    where the checkpoint's parameters differ from ``params`` in name or
    shape."""
    data = np.load(path)
    stored = sorted(k[len("param/"):] for k in data.files
                    if k.startswith("param/"))
    if stored != sorted(params):
        raise ValueError(
            f"{path}: checkpoint parameters {stored} differ from the fit's "
            f"{sorted(params)}")
    for n, p in params.items():
        got = data[f"param/{n}"]
        if tuple(got.shape) != tuple(p.shape):
            raise ValueError(f"checkpoint parameter {n} shape {got.shape} "
                             f"!= template {tuple(p.shape)}")
    with torch.no_grad():
        for n, p in params.items():
            p.copy_(torch.as_tensor(data[f"param/{n}"]))
    name_of = {id(p): n for n, p in params.items()}
    state_dict = opt.state_dict()
    state = {}
    for i, p in enumerate(trainable(opt)):
        prefix = f"opt/{name_of[id(p)]}/"
        entry = {k[len(prefix):]: torch.as_tensor(data[k])
                 for k in data.files if k.startswith(prefix)}
        if entry:
            state[i] = entry
    state_dict["state"] = state
    opt.load_state_dict(state_dict)
    count = int(data["sched/count"])
    sched.last_epoch = count
    for group, base, factor in zip(opt.param_groups, sched.base_lrs,
                                   sched.lr_lambdas):
        group["lr"] = base * factor(count)
    return int(data["__step__"])
