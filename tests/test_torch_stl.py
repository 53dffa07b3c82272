"""The port's STL loader (raytpu_torch.core.stl) against the JAX package's
python parser, on the in-repo procedural mesh written as ASCII STL (the
reference's enemy1.stl is not in the repository)."""

import numpy as np
import pytest
import torch

from raytpu.core import stl as jax_stl
from raytpu.kernels.cull import morton_order as jax_morton_order

from raytpu_torch import load_stl
from raytpu_torch.core import stl
from raytpu_torch.core.types import Camera, RenderConfig
from raytpu_torch.ops.raster import cull_mask


@pytest.fixture(scope="module")
def stl_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("stl") / "torus.stl"
    path.write_text(stl.procedural_stl_text())
    return str(path)


def test_procedural_mesh_is_closed_at_the_reference_count():
    tris = stl.parse_ascii_stl(stl.procedural_stl_text())
    assert tris.shape == (9028, 3, 3) and tris.dtype == np.float32
    # Closed: every edge is shared by exactly two triangles, once each way.
    edges = {}
    for t in tris.reshape(-1, 3, 3).round(5):
        for i in range(3):
            key = (tuple(t[i]), tuple(t[(i + 1) % 3]))
            edges[key] = edges.get(key, 0) + 1
    assert set(edges.values()) == {1}
    assert all((b, a) in edges for a, b in edges)
    small = stl.parse_ascii_stl(stl.procedural_stl_text(20, 20))
    assert small.shape == (800, 3, 3)
    # The bump comes from a fixed seed: the same text every call.
    assert stl.procedural_stl_text(20, 20) == stl.procedural_stl_text(20, 20)


@pytest.mark.parametrize("reorder", [None, "morton"])
def test_load_stl_matches_jax(stl_path, reorder):
    got = load_stl(stl_path, reorder=reorder, device="cpu")
    want = jax_stl.load_stl(stl_path, use_native=False, reorder=reorder)
    for name in ("v0", "v1", "v2", "color", "active"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    padded = load_stl(stl_path, pad_to=9088, device="cpu")
    assert padded.num_triangles == 9088
    assert float(padded.active.sum()) == 9028


def test_morton_order_matches_jax(stl_path):
    tris = stl.parse_ascii_stl(open(stl_path).read()) * np.float32(-0.05)
    perm = stl.morton_order(tris[:, 0], tris[:, 1], tris[:, 2])
    np.testing.assert_array_equal(
        perm, jax_morton_order(tris[:, 0], tris[:, 1], tris[:, 2]))
    assert sorted(perm.tolist()) == list(range(9028))
    assert not np.array_equal(perm, np.arange(9028))


def test_parser_follows_the_reference(tmp_path):
    text = ("solid x\nfacet normal 0 0 1\n  outer loop\n"
            "    vertex 1 2 3\n  vertex  4.5 5 6\nvertex 7 8 -9e-1\n"
            "  endloop\nendfacet\nendsolid x\n")
    np.testing.assert_array_equal(stl.parse_ascii_stl(text),
                                  jax_stl.parse_ascii_stl(text))
    with pytest.raises(ValueError):
        stl.parse_ascii_stl("solid empty\nendsolid empty\n")
    (tmp_path / "bad.stl").write_text("not an stl")
    for loader in (lambda p: load_stl(p, device="cpu"),
                   lambda p: jax_stl.load_stl(p, use_native=False)):
        with pytest.raises(ValueError):
            loader(str(tmp_path / "bad.stl"))
        with pytest.raises(OSError):
            loader(str(tmp_path / "missing.stl"))
    (tmp_path / "one.stl").write_text(text)
    with pytest.raises(ValueError, match="reorder"):
        load_stl(str(tmp_path / "one.stl"), reorder="hilbert", device="cpu")


def test_load_stl_applies_the_reference_scale_and_color(tmp_path):
    """The loader's only scale and color are the reference's
    (`LoadSTL.cpp:19-22`), the JAX package's defaults."""
    assert stl.DEFAULT_SCALE == jax_stl.DEFAULT_SCALE
    assert stl.DEFAULT_COLOR == jax_stl.DEFAULT_COLOR
    path = tmp_path / "one.stl"
    path.write_text("solid x\n outer loop\n  vertex 1 2 3\n  vertex 4 5 6\n"
                    "  vertex 7 8 -9\n endloop\nendsolid x\n")
    scene = load_stl(str(path), device="cpu")
    want = np.float32([[1, 2, 3], [4, 5, 6], [7, 8, -9]]) * np.float32(-0.05)
    for i, name in enumerate(("v0", "v1", "v2")):
        np.testing.assert_array_equal(getattr(scene, name).numpy()[0],
                                      want[i], err_msg=name)
    np.testing.assert_array_equal(scene.color.numpy(),
                                  np.float32([[0.5, 0.5, 0.5]]))


def test_backface_culling_keeps_the_visible_side(stl_path):
    """The winding faces the STL camera: culling drops the far side, about
    half the mesh, and the clean frame is the same with or without it."""
    from raytpu_torch.core.types import Lights
    from raytpu_torch.render.soft import rasterize_exact
    scene = load_stl(stl_path, device="cpu")
    cam = Camera.make((0.0, -0.5, -5.0), focal=24.0, device="cpu")
    cfg = RenderConfig(width=24, height=24, mode="clean")
    kept = float(cull_mask(scene, cam, cfg.replace(frustum_cull=False)).sum())
    assert 0.3 * 9028 < kept < 0.7 * 9028
    lights = Lights.single(capacity=1, device="cpu")
    on = rasterize_exact(scene, cam, lights, cfg)
    off = rasterize_exact(scene, cam, lights, cfg.replace(backface_cull=False))
    assert torch.equal(on, off)
    assert 0.15 < float((on.sum(-1) > 1e-3).float().mean()) < 0.6
