"""raytpu-torch command-line interface (counterpart of raytpu/cli/main.py).

  raytpu-torch render    — raytrace the Cornell box to a BMP
  raytpu-torch rasterize — rasterize the Cornell box or an ASCII STL model
                           to a BMP (ref: the rasteriser binary)
  raytpu-torch fit       — inverse-rendering fit of the Cornell box to a
                           target BMP through the soft rasterizer
  raytpu-torch view      — the live viewer over localhost HTTP

The flags and their defaults are the JAX package's; ``--device`` picks
where the frame is rendered or the fit trained (default ``cuda``: a run
with no GPU fails instead of carrying on on the CPU). ``render --stl``
raytraces an ASCII STL model in parity and clean from the STL camera
(0, -0.5, -5) at focal 250, its triangles in file order (``--morton``
sorts them), through the chunk-culled intersection kernel K7a.
``render --mode soft`` and ``fit --renderer raytrace`` run the soft
raytracer; ``render --mode soft --stl`` culls chunks where the JAX package
would (an image that blocks into its 1,024-pixel tiles, such as 512^2:
the masked kernels K10b and K10h) and runs every chunk where it would not
(the CLI's 500^2). ``fit --mesh DATAxMODEL`` trains through the sharded
soft renderer on a (data, model) mesh of the job's ranks: under
``torchrun --nproc-per-node N`` (N = DATA x MODEL, rank r on cuda:r, or
gloo with ``--device cpu``); a plain ``python -m`` is one rank, a 1x1
mesh. Rank 0 alone prints and writes files.
"""

from __future__ import annotations

import argparse
import sys


def _render_flags(p: argparse.ArgumentParser, rasterizer: bool = False):
    p.add_argument("-o", "--output", default="screenshot.bmp",
                   help="output BMP path (ref: SDL_SaveBMP on exit)")
    p.add_argument("--width", type=int, default=500)
    p.add_argument("--height", type=int, default=500)
    p.add_argument("--mode", choices=["parity", "clean", "soft"],
                   default="parity")
    p.add_argument("--stl", default=None,
                   help="render an ASCII STL model instead of the Cornell "
                        "box (ref CUSTOM_MODEL, `rasteriser.cpp:20`)")
    p.add_argument("--morton", action="store_true",
                   help="Morton-sort STL triangles (with --stl)")
    p.add_argument("--camera-pos", type=float, nargs=3, default=None)
    p.add_argument("--yaw", type=float, default=0.0)
    p.add_argument("--focal", type=float, default=None,
                   help="focal length in pixels (ref: 250 raytracer / 500 "
                        "rasteriser)")
    p.add_argument("--light-pos", type=float, nargs=3,
                   default=(0.0, -0.5, -0.7))
    p.add_argument("--light-color", type=float, nargs=3,
                   default=(1.0, 1.0, 1.0))
    p.add_argument("--light-intensity", type=float, default=14.0)
    p.add_argument("--add-light", action="append", nargs=7,
                   type=float, metavar=("X", "Y", "Z", "R", "G", "B", "I"),
                   default=None, help="extra light (repeatable; ref key 2)")
    p.add_argument("--dof", action="store_true",
                   help="depth-of-field blur (ref key 9)")
    p.add_argument("--dof-kernel", type=int, default=8)
    p.add_argument("--dof-focus", type=float, default=None,
                   help="DoF focus distance (ref FOCAL_LENGTH, keys [ ])")
    if rasterizer:
        p.add_argument("--no-backface-cull", action="store_true",
                       help="disable backface culling (ref key 7)")
        p.add_argument("--no-frustum-cull", action="store_true",
                       help="disable frustum culling (ref key 8)")
    else:
        p.add_argument("--aa", type=int, default=1, metavar="N",
                       help="NxN supersample AA (ref key 7, AA_SAMPLES=3)")
        p.add_argument("--soft-shadows", type=int, default=1, metavar="S",
                       help="soft-shadow samples (ref key 8, 16 samples)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("raytpu-torch: --device cuda but no CUDA device is "
                         "available (pass --device cpu to run on the CPU)")
    return device


def _build_inputs(args, rasterizer: bool = False):
    """Scene, camera, lights and RenderConfig from the flags, with the
    raytracer's or the rasteriser's defaults: focal 250 / 500, camera
    (0, 0, -2) / (0, 0, -3) ((0, -0.5, -5) for an STL model,
    `rasteriser.cpp:109`), DoF focus 1.3 / 1.9, and the rasteriser's
    y_scale 1.01 in parity mode only."""
    import torch

    from raytpu_torch.core.cornell import cornell_box
    from raytpu_torch.core.stl import load_stl
    from raytpu_torch.core.types import Camera, Lights, RenderConfig

    device = _device(args.device)
    if args.stl:
        scene = load_stl(args.stl, reorder="morton" if args.morton else None,
                         device=device)
        default_cam = (0.0, -0.5, -5.0)
    else:
        scene = cornell_box(device=device)
        default_cam = (0.0, 0.0, -3.0) if rasterizer else (0.0, 0.0, -2.0)
    camera = Camera.make(
        args.camera_pos or default_cam, yaw=args.yaw,
        focal=args.focal if args.focal is not None else (
            500.0 if rasterizer else 250.0),
        y_scale=1.01 if (rasterizer and args.mode == "parity") else 1.0,
        dof_focus=args.dof_focus if args.dof_focus is not None else (
            1.9 if rasterizer else 1.3),
        device=device,
    )
    extra = args.add_light or []
    soft_shadows = getattr(args, "soft_shadows", 1)
    lights = Lights.single(
        position=args.light_pos, color=args.light_color,
        intensity=args.light_intensity, capacity=1 + len(extra),
        soft_samples=max(soft_shadows, 1), device=device,
    )
    for i, l in enumerate(extra):
        lights = lights.add(l[:3], l[3:6], l[6],
                            generator=torch.Generator().manual_seed(i + 1))
    cfg = RenderConfig(
        width=args.width, height=args.height, mode=args.mode,
        aa_samples=getattr(args, "aa", 1), soft_shadow_samples=soft_shadows,
        dof_enabled=args.dof, dof_kernel_size=args.dof_kernel,
        backface_cull=not getattr(args, "no_backface_cull", False),
        frustum_cull=not getattr(args, "no_frustum_cull", False),
    )
    return scene, camera, lights, cfg


def cmd_render(args):
    from raytpu_torch.core.image import write_bmp
    from raytpu_torch.render.raytrace import raytrace

    scene, camera, lights, cfg = _build_inputs(args)
    img = raytrace(scene, camera, lights, cfg).cpu().numpy()
    write_bmp(args.output, img)
    print(f"wrote {args.output} ({cfg.width}x{cfg.height}, {cfg.mode}, "
          f"{scene.device})")


def cmd_rasterize(args):
    from raytpu_torch.core.image import write_bmp
    from raytpu_torch.render.rasterize import rasterize

    scene, camera, lights, cfg = _build_inputs(args, rasterizer=True)
    img = rasterize(scene, camera, lights, cfg).cpu().numpy()
    write_bmp(args.output, img)
    print(f"wrote {args.output} ({cfg.width}x{cfg.height}, {cfg.mode}, "
          f"{scene.num_triangles} triangles, {scene.device})")


def cmd_fit(args):
    """Fit the Cornell box's vertices, albedo and light to a target BMP
    (``cmd_fit`` of the JAX CLI): camera (0, 0, -3) at focal = the target's
    width, y_scale 1.01; one light of capacity 1 at --init-intensity; the
    result rendered at sharpness 400 / 4000 to --output. With --mesh the
    job's ranks train on a DATAxMODEL mesh (init_distributed: torchrun's
    environment, or one rank), each on its own device."""
    device = _device(args.device)
    mesh = None
    if args.mesh:
        from raytpu_torch.parallel import init_distributed, make_mesh
        data, model = (int(x) for x in args.mesh.lower().split("x"))
        state = init_distributed(device=device.type)
        device = state.device
        mesh = make_mesh(data, model, device=device.type)
    try:
        _fit_and_write(args, device, mesh)
    finally:
        if mesh is not None:
            from raytpu_torch.parallel import shutdown_distributed
            shutdown_distributed()


def _fit_and_write(args, device, mesh):
    import numpy as np
    import torch

    from raytpu_torch.core.cornell import cornell_box
    from raytpu_torch.core.image import read_bmp, write_bmp
    from raytpu_torch.core.types import Camera, Lights, RenderConfig
    from raytpu_torch.opt.fit import FitConfig, fit
    from raytpu_torch.render.soft import rasterize_soft

    target = read_bmp(args.target).astype(np.float32) / 255.0
    h, w, _ = target.shape
    scene = cornell_box(device=device)
    camera = Camera.make((0.0, 0.0, -3.0), focal=float(w), y_scale=1.01,
                         device=device)
    lights = Lights.single(capacity=1, intensity=args.init_intensity,
                           device=device)
    cfg = RenderConfig(width=w, height=h, mode="soft")
    fit_cfg = FitConfig(steps=args.steps, renderer=args.renderer,
                        checkpoint_dir=args.checkpoint_dir)
    result = fit(target, scene, camera, lights, cfg, fit_cfg,
                 resume_from=args.resume, mesh=mesh)
    if mesh is not None and mesh.get_rank() != 0:
        return
    print(f"final loss: {result.losses[-1]:.6f}")
    if args.output:
        with torch.no_grad():
            img = rasterize_soft(result.scene, camera, result.lights,
                                 cfg.replace(soft_edge_sharpness=400.0,
                                             soft_z_sharpness=4000.0))
        write_bmp(args.output, img.cpu().numpy())
        print(f"wrote {args.output}")


def cmd_view(args):
    import torch

    from raytpu_torch.core.types import Lights
    from raytpu_torch.view import ViewerApp, serve

    scene, camera, _lights, cfg = _build_inputs(
        args, rasterizer=args.renderer == "rasterize")
    # The reference's 32-slot light bank (raytracer.cpp:47), so key 2 can
    # spawn lights, each with the 16 jittered positions key 8 asks for
    # (SOFT_SHADOWS_SAMPLES, raytracer.cpp:40-41).
    lights = Lights.single(
        position=args.light_pos, color=args.light_color,
        intensity=args.light_intensity, capacity=32,
        soft_samples=max(args.soft_shadows, 16), device=scene.device,
    )
    for i, l in enumerate(args.add_light or []):
        lights = lights.add(l[:3], l[3:6], l[6],
                            generator=torch.Generator().manual_seed(i + 1))
    app = ViewerApp(scene, camera, lights, cfg, renderer=args.renderer)
    app.render()
    server = serve(app, port=args.port)
    print(f"raytpu-torch viewer: http://127.0.0.1:{server.server_address[1]}/"
          f"  ({cfg.width}x{cfg.height}, {cfg.mode}, {scene.device}, "
          f"{app.last_ms:.0f} ms/frame)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="raytpu-torch",
        description="PyTorch/CUDA port of the raytpu raytracer and "
                    "rasterizer",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("render", help="raytrace to a BMP")
    _render_flags(p)
    p.set_defaults(func=cmd_render)
    p = sub.add_parser("rasterize", help="rasterize to a BMP")
    _render_flags(p, rasterizer=True)
    p.set_defaults(func=cmd_rasterize)
    p = sub.add_parser("fit", help="inverse-rendering fit")
    p.add_argument("target", help="target BMP image")
    p.add_argument("-o", "--output", default="fit.bmp")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--renderer", choices=["rasterize", "raytrace"],
                   default="rasterize")
    p.add_argument("--init-intensity", type=float, default=10.0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                   help="shard the fit over a (data, model) mesh of the "
                        "job's ranks (torchrun --nproc-per-node "
                        "DATA*MODEL)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda)")
    p.set_defaults(func=cmd_fit)
    p = sub.add_parser("view", help="live interactive viewer (browser "
                                    "framebuffer; the reference's realtime "
                                    "SDL loop)")
    _render_flags(p)
    p.add_argument("--renderer", default="raytrace",
                   choices=["raytrace", "rasterize"])
    p.add_argument("--port", type=int, default=8000)
    p.set_defaults(func=cmd_view)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
