"""Live interactive viewer (counterpart of raytpu/view/server.py).

The reference is an interactive SDL app: a main loop polls the keyboard,
changes camera, light and toggle state, renders and blits to a window
(`raytracer/Source/raytracer.cpp:113-178`, keys at 345-545;
`rasteriser/Source/rasteriser.cpp:174-449`). Here the framebuffer is
served over localhost HTTP: a browser <img> is the window and
``fetch('/key?k=...')`` the keyboard. Each key event renders one frame on
the scene's device (the CUDA kernels on a card, their plain versions on
the CPU), with the JAX viewer's key map:

  arrows        camera forward/back/yaw   (render.animate.apply_key_raytracer,
  w/s/a/d       light motion               apply_key_rasterizer: dt-scaled)
  7             AA toggle (3x3 sub-rays)            `raytracer.cpp:426-436`
  8             soft shadows toggle (16 samples)    `raytracer.cpp:438-448`
  9             depth-of-field toggle               `raytracer.cpp:450-460`
  ] / [         focal length +/- 0.1 (px scale ~ +/-10)  `raytracer.cpp:462-473`
  2 / 3         spawn random light / delete last    `raytracer.cpp:520-539`
  0             clean <-> soft (the differentiable render): the
                rasterizer's soft frame runs the soft raster kernels (K9a),
                the raytracer's the soft raytrace kernels (K10a, K10g; on
                a scene of several chunks at a size that blocks into JAX's
                1,024-pixel tiles, the masked K10b, K10h) on the
                compacted light bank

The raytracer's keys 7, 8 and 2 move a frame off the fused forward kernel
onto the loop branch of raytrace_full. The rasterizer (``renderer=
"rasterize"``) renders through render.rasterize: parity mode as plain
torch, clean mode through the raster kernels, soft mode (key 0) through
the soft raster kernels; it ignores the AA and soft-shadow settings that
keys 7 and 8 change, as the JAX viewer's does.

Run:  raytpu-torch view [--renderer raytrace|rasterize] [--width W
      --height H] [--port P] [--device cuda|cpu]
then open http://localhost:P/ in a browser.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from raytpu_torch.core.image import encode_bmp
from raytpu_torch.core.types import Camera, Lights, RenderConfig, Scene
from raytpu_torch.render.animate import (
    KEYS,
    apply_key_rasterizer,
    apply_key_raytracer,
)
from raytpu_torch.render.rasterize import rasterize
from raytpu_torch.render.raytrace import raytrace

_MOVE_KEYS = tuple(k for k in KEYS if k != "none")


class ViewerApp:
    """The viewer's state, rendering a frame on demand.

    Free of HTTP so tests can drive it directly; :func:`serve` wraps it in
    a ThreadingHTTPServer. Every state change goes through
    :meth:`handle_key` under a lock, so concurrent requests do not
    interleave."""

    def __init__(self, scene: Scene, camera: Camera, lights: Lights,
                 cfg: RenderConfig, renderer: str = "raytrace",
                 seed: int = 0):
        if renderer not in ("raytrace", "rasterize"):
            raise ValueError(f"unknown renderer {renderer!r}")
        self.scene = scene
        self.camera = camera
        self.lights = lights
        self.cfg = cfg
        self.renderer = renderer
        self.lock = threading.Lock()
        self.frame_n = 0
        self.last_ms = 0.0
        self._rng = np.random.default_rng(seed)
        self._frame: np.ndarray | None = None

    def render(self) -> np.ndarray:
        """Render the current state; returns the (H, W, 3) float32 frame."""
        t0 = time.perf_counter()
        with torch.no_grad():
            if self.renderer == "raytrace":
                img = raytrace(self.scene, self.camera, self.lights,
                               self.cfg)
            else:
                img = rasterize(self.scene, self.camera, self.lights,
                                self.cfg)
        self._frame = img.cpu().numpy()  # waits for the device
        self.last_ms = (time.perf_counter() - t0) * 1e3
        self.frame_n += 1
        return self._frame

    def frame_bmp(self) -> bytes:
        with self.lock:
            if self._frame is None:
                self.render()
            return encode_bmp(self._frame)

    def handle_key(self, key: str) -> dict:
        """Apply one key event (the reference's Update()), render, and
        return the new state. Raises KeyError for an unknown key, before
        changing any state."""
        with self.lock:
            if key in _MOVE_KEYS:
                apply_key = (apply_key_raytracer
                             if self.renderer == "raytrace"
                             else apply_key_rasterizer)
                self.camera, self.lights = apply_key(self.camera,
                                                     self.lights, key)
            elif key == "7":  # AA toggle (AA_SAMPLES=3)
                n = 1 if self.cfg.aa_samples > 1 else 3
                self.cfg = self.cfg.replace(aa_samples=n)
            elif key == "8":  # soft shadows toggle (16 samples)
                n = 1 if self.cfg.soft_shadow_samples > 1 else 16
                self.cfg = self.cfg.replace(soft_shadow_samples=n)
            elif key == "9":  # DoF toggle
                self.cfg = self.cfg.replace(
                    dof_enabled=not self.cfg.dof_enabled)
            elif key == "]":  # FOCAL_LENGTH += 0.1 (world scale) -> px
                self.camera = dataclasses.replace(
                    self.camera, focal=self.camera.focal + 10.0)
            elif key == "[":
                self.camera = dataclasses.replace(
                    self.camera, focal=self.camera.focal - 10.0)
            elif key == "2":  # spawn a random light (raytracer.cpp:522)
                u = lambda: float(self._rng.uniform(-1.0, 1.0))  # noqa: E731
                position = (u() * 2.0, u() * 2.0, u() * 2.0)
                color = (abs(u()) * 2.0 + 0.2, abs(u()) * 2.0 + 0.2,
                         abs(u()) * 2.0 + 0.2)
                intensity = abs(u()) * 20.0
                # The JAX viewer seeds a jax.random key here; torch cannot
                # replay it, so the jitter comes from a torch generator
                # seeded from the same draw.
                generator = torch.Generator().manual_seed(
                    int(self._rng.integers(2 ** 31)))
                self.lights = self.lights.add(position, color, intensity,
                                              generator=generator)
            elif key == "3":  # delete the most recent light
                self.lights = self.lights.delete_last()
            elif key == "0":  # clean <-> soft (differentiable) render
                new_mode = "soft" if self.cfg.mode != "soft" else "clean"
                self.cfg = self.cfg.replace(mode=new_mode)
            elif key != "none":
                raise KeyError(key)
            self.render()
            return self.state()

    def state(self) -> dict:
        return {
            "frame": self.frame_n,
            "ms": round(self.last_ms, 1),
            "renderer": self.renderer,
            "camera_pos": [round(v, 3) for v in self.camera.pos.tolist()],
            "yaw": round(float(self.camera.yaw), 3),
            "focal": round(float(self.camera.focal), 1),
            "lights": int(self.lights.mask.sum()),
            "aa": self.cfg.aa_samples > 1,
            "soft_shadows": self.cfg.soft_shadow_samples > 1,
            "dof": self.cfg.dof_enabled,
        }


_PAGE = """<!doctype html>
<html><head><title>raytpu viewer</title><style>
 body { background:#111; color:#9e9; font:13px monospace; text-align:center }
 img  { image-rendering:pixelated; width:70vmin; height:70vmin;
        border:1px solid #333; margin-top:1em }
 #hud { margin-top:.6em; white-space:pre }
</style></head><body>
<div>raytpu live viewer — arrows: move/turn · wasd: light · 7 AA · 8 soft
 shadows · 9 DoF · [ ] focal · 2/3 add/del light · 0 soft</div>
<img id="fb" src="/frame.bmp">
<div id="hud">connecting…</div>
<script>
 const KEYMAP = {ArrowUp:'up', ArrowDown:'down', ArrowLeft:'left',
   ArrowRight:'right', w:'w', s:'s', a:'a', d:'d', '7':'7', '8':'8',
   '9':'9', '[':'[', ']':']', '2':'2', '3':'3', '0':'0'};
 let busy = false;
 async function send(k) {
   if (busy) return; busy = true;
   try {
     const r = await fetch('/key?k=' + encodeURIComponent(k));
     if (!r.ok) {
       document.getElementById('hud').textContent = await r.text();
       return;
     }
     const st = await r.json();
     document.getElementById('fb').src = '/frame.bmp?n=' + st.frame;
     document.getElementById('hud').textContent = JSON.stringify(st);
   } finally { busy = false; }
 }
 window.addEventListener('keydown', e => {
   const k = KEYMAP[e.key]; if (k) { e.preventDefault(); send(k); }
 });
 fetch('/state').then(r => r.json()).then(st => {
   document.getElementById('hud').textContent = JSON.stringify(st);
 });
</script></body></html>"""


def serve(app: ViewerApp, port: int = 8000,
          host: str = "127.0.0.1") -> ThreadingHTTPServer:
    """An HTTP server for the viewer, bound but not serving: call its
    ``serve_forever()`` (in a thread, or blocking), then ``shutdown()`` and
    ``server_close()``. Port 0 picks a free port (``server_address``)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            try:
                if url.path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif url.path == "/frame.bmp":
                    self._send(200, app.frame_bmp(), "image/bmp")
                elif url.path == "/state":
                    with app.lock:
                        body = json.dumps(app.state()).encode()
                    self._send(200, body, "application/json")
                elif url.path == "/key":
                    k = parse_qs(url.query).get("k", ["none"])[0]
                    st = app.handle_key(k)
                    self._send(200, json.dumps(st).encode(),
                               "application/json")
                else:
                    self._send(404, b"not found", "text/plain")
            except KeyError:
                self._send(400, b"unknown key", "text/plain")
            except NotImplementedError as e:
                self._send(501, str(e).encode(), "text/plain")
            except BrokenPipeError:
                pass

    return ThreadingHTTPServer((host, port), Handler)
