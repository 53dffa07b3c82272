"""The port's native host runtime (raytpu_torch.native, a copy of the JAX
package's C++ STL parser and BMP codec built with g++ at first use) against
the python parsers and codecs of both packages: the counterparts of
tests/test_native.py's tests on the procedural mesh, which the repository
holds (the reference's enemy1.stl is not in it), and load_stl's JAX
parameters (scale, color, use_native)."""

import numpy as np
import pytest

from raytpu import native as jax_native
from raytpu.core import image as jax_image
from raytpu.core import stl as jax_stl

from raytpu_torch import load_stl, native
from raytpu_torch.core import image
from raytpu_torch.core.stl import parse_ascii_stl, procedural_stl_text


@pytest.fixture(scope="module")
def mesh_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("native") / "torus.stl"
    path.write_text(procedural_stl_text(20, 20))
    return str(path)


def test_builds_into_the_build_directory():
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "raytpu_torch"
    assert path.parent.parent.name == "build"
    assert (native._SRC.read_bytes()
            == open(jax_native._SRC, "rb").read())


def test_stl_parser_matches_python(mesh_path):
    text = open(mesh_path).read()
    tris = native.parse_stl(mesh_path)
    assert tris.shape == (800, 3, 3) and tris.dtype == np.float32
    np.testing.assert_array_equal(tris, parse_ascii_stl(text))
    np.testing.assert_array_equal(tris, jax_stl.parse_ascii_stl(text))


@pytest.mark.parametrize("reorder", [None, "morton"])
def test_load_stl_native_equals_python(mesh_path, reorder):
    s_n = load_stl(mesh_path, use_native=True, reorder=reorder, device="cpu")
    s_p = load_stl(mesh_path, use_native=False, reorder=reorder,
                   device="cpu")
    s_d = load_stl(mesh_path, reorder=reorder, device="cpu")
    want = jax_stl.load_stl(mesh_path, use_native=False, reorder=reorder)
    for name in ("v0", "v1", "v2", "color", "active"):
        for got in (s_n, s_p, s_d):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)),
                                          err_msg=name)


def test_load_stl_takes_scale_and_color(mesh_path):
    got = load_stl(mesh_path, scale=0.1, color=(0.2, 0.4, 0.6), pad_to=808,
                   device="cpu")
    want = jax_stl.load_stl(mesh_path, scale=0.1, color=(0.2, 0.4, 0.6),
                            pad_to=808, use_native=False)
    assert got.num_triangles == 808
    for name in ("v0", "v1", "v2", "color", "active"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    # Positional as in the JAX package: path, scale, color, pad_to.
    pos = load_stl(mesh_path, 0.1, (0.2, 0.4, 0.6), 808, device="cpu")
    np.testing.assert_array_equal(pos.v1.numpy(), got.v1.numpy())


def test_stl_parser_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.parse_stl(str(tmp_path / "missing.stl"))
    bad = tmp_path / "bad.stl"
    bad.write_text("solid x\n outer loop\n vertex 1 2\n")
    with pytest.raises(ValueError):
        native.parse_stl(str(bad))
    (tmp_path / "empty.stl").write_text("solid x\nendsolid x\n")
    with pytest.raises(ValueError):
        native.parse_stl(str(tmp_path / "empty.stl"))
    with pytest.raises(ValueError):
        load_stl(str(bad), use_native=True, device="cpu")


def test_bmp_roundtrip_cross_impl(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (21, 35, 3), dtype=np.uint8)

    n_path = str(tmp_path / "n.bmp")
    native.write_bmp(n_path, img)
    np.testing.assert_array_equal(image.read_bmp(n_path), img)
    np.testing.assert_array_equal(jax_image.read_bmp(n_path), img)
    np.testing.assert_array_equal(native.read_bmp(n_path), img)

    for writer in (image.write_bmp, jax_image.write_bmp, jax_native.write_bmp):
        p_path = str(tmp_path / "p.bmp")
        writer(p_path, img)
        np.testing.assert_array_equal(native.read_bmp(p_path), img)
        # Byte-identical files from every writer.
        assert open(n_path, "rb").read() == open(p_path, "rb").read()
    with pytest.raises(FileNotFoundError):
        native.read_bmp(str(tmp_path / "missing.bmp"))
    (tmp_path / "bad.bmp").write_bytes(b"XX" + bytes(60))
    with pytest.raises(ValueError):
        native.read_bmp(str(tmp_path / "bad.bmp"))
