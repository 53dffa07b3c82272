"""The port's copies of the numpy oracles (raytpu_torch.oracle) render
exactly what the JAX package's originals render, and chip_smoke.py holds
the port's frames to those copies without loading any file of the JAX
package."""

import re
from pathlib import Path

import numpy as np
import pytest

from raytpu.oracle import rasterizer_oracle as jax_rasterizer_oracle
from raytpu.oracle import raytracer_oracle as jax_raytracer_oracle

from raytpu_torch.core.cornell import cornell_box_numpy
from raytpu_torch.oracle import rasterizer_oracle, raytracer_oracle

ROOT = Path(__file__).resolve().parents[1]


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("kw", [
    dict(width=24, height=24, focal=12.0),
    dict(width=24, height=24, focal=12.0, aa_samples=2, dof_enabled=True,
         yaw=0.2),
], ids=["plain", "aa-dof-yaw"])
def test_raytracer_oracle_copy_renders_the_same(kw):
    scene = cornell_box_numpy()
    _assert_same(raytracer_oracle.render(scene, **kw),
                 jax_raytracer_oracle.render(scene, **kw))


@pytest.mark.parametrize("kw", [
    dict(width=32, height=32, focal=32.0),
    dict(width=32, height=32, focal=32.0, dof_enabled=True, yaw=0.2,
         camera_pos=(0.1, 0.0, -2.5)),
], ids=["plain", "dof-yaw"])
def test_rasterizer_oracle_copy_renders_the_same(kw):
    scene = cornell_box_numpy()
    got = rasterizer_oracle.render(scene, **kw)
    _assert_same(got, jax_rasterizer_oracle.render(scene, **kw))
    assert np.asarray(got[0]).max() > 0.3


def test_oracle_copies_import_nothing_of_the_jax_package():
    for name in ("raytracer_oracle.py", "rasterizer_oracle.py"):
        text = (ROOT / "raytpu_torch" / "oracle" / name).read_text()
        assert not re.search(r"^\s*(from|import)\s+(raytpu|jax)\b", text,
                             re.M), name


def test_chip_smoke_names_no_path_of_the_jax_package():
    """chip_smoke.py imports the port's oracle copies: it loads no file
    under raytpu/ and imports nothing of it or of JAX. A path under
    raytpu/ appears only as the ``replaces`` entry of its kernels line
    (the TPU kernel a CUDA kernel replaces), which is never opened."""
    text = (ROOT / "chip_smoke.py").read_text()
    for line in text.splitlines():
        if re.search(r"\braytpu/", line):
            assert re.search(r'replaces="raytpu/kernels/\w+\.py:\d+"',
                             line), line
    assert not re.search(r"[\"']raytpu[\"']", text)
    assert "importlib" not in text and "spec_from_file_location" not in text
    assert not re.search(r"^\s*(from|import)\s+(raytpu|jax)\b", text, re.M)
    assert "raytpu_torch.oracle" in text
