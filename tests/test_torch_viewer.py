"""The port's view server (raytpu_torch.view) against the JAX package's.

Both ViewerApps start from the same numbers (the JAX bank carried across,
with 16 jittered positions a light so key 8 has its samples) and take the
same keys; after each, the port's frame is held to the JAX viewer's. Key 2
draws a light from the app's numpy generator, as the JAX viewer does, and
its jitter from a torch generator: that frame is held to JAX's
raytrace_full on the port's bank. The HTTP layer is driven over loopback.
"""

import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest

from raytpu.core.cornell import cornell_box as jax_cornell_box
from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.render.raytrace import raytrace_full as jax_raytrace_full
from raytpu.view import ViewerApp as JaxViewerApp

from raytpu_torch import convert
from raytpu_torch.core.image import read_bmp
from raytpu_torch.core.types import RenderConfig
from raytpu_torch.view import ViewerApp, serve

SIZE = 16


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


def _apps():
    scene = jax_cornell_box(pad_to=32)
    camera = JaxCamera.make((0.0, 0.0, -2.0), focal=SIZE / 2)
    lights = JaxLights.single(capacity=4, soft_samples=16)
    jax_app = JaxViewerApp(scene, camera, lights,
                           JaxRenderConfig(width=SIZE, height=SIZE,
                                           mode="clean"), seed=0)
    app = ViewerApp(convert.scene_from_numpy(leaves(scene), device="cpu"),
                    convert.camera_from_numpy(leaves(camera), device="cpu"),
                    convert.lights_from_numpy(leaves(lights), device="cpu"),
                    RenderConfig(width=SIZE, height=SIZE, mode="clean"),
                    seed=0)
    return jax_app, app


# Movement, AA on, DoF with AA, AA off, soft shadows with DoF, focal up
# and down, soft shadows off, and the last light deleted.
KEYS = ["up", "left", "w", "7", "9", "7", "8", "]", "[", "8", "3"]


def test_viewer_frames_match_jax():
    jax_app, app = _apps()
    for key in KEYS:
        want = jax_app.handle_key(key)
        got = app.handle_key(key)
        assert {k: v for k, v in got.items() if k != "ms"} == {
            k: v for k, v in want.items() if k != "ms"}, key
        diff = np.abs(app._frame - np.asarray(jax_app._frame))
        print(f"key {key}: max |d frame| {diff.max():.3g}")
        np.testing.assert_allclose(app._frame, np.asarray(jax_app._frame),
                                   rtol=0, atol=1e-6, err_msg=key)
    assert got["lights"] == 0 and app._frame.max() > 0.0  # ambient only


def test_viewer_spawned_light_matches_jax():
    _, app = _apps()
    before = app.render().copy()
    st = app.handle_key("2")
    assert st["lights"] == 2
    lights = {k: jnp.asarray(v) for k, v in convert.to_numpy(
        app.lights).items()}
    want = jax_raytrace_full(
        jax_cornell_box(pad_to=32),
        JaxCamera(**{k: jnp.asarray(v) for k, v in convert.to_numpy(
            app.camera).items()}),
        JaxLights(**lights),
        JaxRenderConfig(width=SIZE, height=SIZE, mode="clean",
                        use_pallas=False)).image
    np.testing.assert_allclose(app._frame, np.asarray(want), rtol=0,
                               atol=1e-6)
    assert np.abs(app._frame - before).max() > 1e-3
    # Key 8 on the spawned light: its 16 jittered positions exist.
    assert app.handle_key("8")["soft_shadows"] is True
    assert app.handle_key("3")["lights"] == 1


def test_viewer_refuses_what_is_not_ported():
    jax_app, app = _apps()
    # The hard raytracer at STL scale (more than 128 triangles), once
    # refused, renders: the box padded to 136 triangles (two chunks through
    # K7a's plain version) gives the JAX viewer's frame of the same scene,
    # AA on (key 7) included.
    scene = jax_cornell_box(pad_to=136)
    big = ViewerApp(convert.scene_from_numpy(leaves(scene), device="cpu"),
                    app.camera, app.lights, app.cfg)
    jax_big = JaxViewerApp(scene, jax_app.camera, jax_app.lights,
                           jax_app.cfg, seed=0)
    for key in ("none", "7"):
        got, want = big.handle_key(key), jax_big.handle_key(key)
        assert got["aa"] == want["aa"]
        np.testing.assert_allclose(big._frame, np.asarray(jax_big._frame),
                                   rtol=0, atol=1e-6, err_msg=key)
    assert big.frame_n == 2 and big._frame.max() > 0.1
    with pytest.raises(KeyError):
        app.handle_key("q")
    # The rasterizer is ported (tests/test_torch_rasterize.py); an unknown
    # renderer is refused.
    assert ViewerApp(app.scene, app.camera, app.lights, app.cfg,
                     renderer="rasterize").renderer == "rasterize"
    with pytest.raises(ValueError, match="renderer"):
        ViewerApp(app.scene, app.camera, app.lights, app.cfg,
                  renderer="scanline")


def test_viewer_http_roundtrip(tmp_path):
    _, app = _apps()
    server = serve(app, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        with urllib.request.urlopen(base + path, timeout=60) as r:
            return r.status, r.read()

    try:
        status, page = get("/")
        assert status == 200 and b"raytpu live viewer" in page
        status, body = get("/state")
        assert status == 200 and json.loads(body)["renderer"] == "raytrace"
        status, body = get("/key?k=left")
        assert status == 200 and json.loads(body)["yaw"] != 0.0
        status, bmp = get("/frame.bmp")
        assert status == 200
        (tmp_path / "frame.bmp").write_bytes(bmp)
        img = read_bmp(str(tmp_path / "frame.bmp"))
        assert img.shape == (SIZE, SIZE, 3) and img.max() > 0
        clean = app._frame.copy()
        status, body = get("/key?k=0")  # the soft raytracer
        assert status == 200 and app.cfg.mode == "soft"
        assert np.abs(app._frame - clean).max() > 1e-3
        with pytest.raises(urllib.error.HTTPError) as exc:
            get("/key?k=zz")
        assert exc.value.code == 400
        assert get("/state")[0] == 200  # still serving
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()



def test_key0_on_both_renderers():
    """Key 0 toggles the rasterizer's and the raytracer's frame between
    clean and soft, as the JAX viewer's does (the soft frames held to JAX's
    jnp paths at the soft tests' atol 5e-5 / rtol 1e-4)."""
    scene = jax_cornell_box(pad_to=32)
    camera = JaxCamera.make((0.011, -0.007, -3.013), focal=16.23,
                            dof_focus=1.9)
    lights = JaxLights.single(capacity=4)
    jax_app = JaxViewerApp(scene, camera, lights, JaxRenderConfig(
        width=SIZE, height=SIZE, mode="clean", use_pallas=False),
        renderer="rasterize", seed=0)
    app = ViewerApp(convert.scene_from_numpy(leaves(scene), device="cpu"),
                    convert.camera_from_numpy(leaves(camera), device="cpu"),
                    convert.lights_from_numpy(leaves(lights), device="cpu"),
                    RenderConfig(width=SIZE, height=SIZE, mode="clean"),
                    renderer="rasterize", seed=0)
    clean = app.render().copy()
    jax_app.render()
    for key in ("0", "left"):
        want = jax_app.handle_key(key)
        got = app.handle_key(key)
        assert {k: v for k, v in got.items() if k != "ms"} == {
            k: v for k, v in want.items() if k != "ms"}, key
        np.testing.assert_allclose(app._frame, np.asarray(jax_app._frame),
                                   atol=5e-5, rtol=1e-4, err_msg=key)
    assert app.cfg.mode == "soft"
    assert np.abs(app._frame - clean).max() > 1e-3
    app.handle_key("0")
    assert app.cfg.mode == "clean"
    jax_tracer, tracer = _apps()
    clean = tracer.render().copy()
    jax_tracer.render()
    for key, mode in (("0", "soft"), ("left", "soft"), ("0", "clean")):
        want = jax_tracer.handle_key(key)
        got = tracer.handle_key(key)
        assert {k: v for k, v in got.items() if k != "ms"} == {
            k: v for k, v in want.items() if k != "ms"}, key
        np.testing.assert_allclose(tracer._frame,
                                   np.asarray(jax_tracer._frame),
                                   atol=5e-5, rtol=1e-4, err_msg=key)
        assert tracer.cfg.mode == mode
        if key == "0" and mode == "soft":
            assert np.abs(tracer._frame - clean).max() > 1e-3
