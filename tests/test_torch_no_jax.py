"""The port stands alone: it imports no JAX, and chip_smoke.py fails
cleanly where there is no GPU."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_CHECK = """
import sys
import raytpu_torch, raytpu_torch.cli.main, raytpu_torch.kernels.render_fused
import raytpu_torch.render.animate, raytpu_torch.convert
import raytpu_torch.kernels.intersect, raytpu_torch.view
import raytpu_torch.kernels.raster, raytpu_torch.ops.raster
import raytpu_torch.render.rasterize, raytpu_torch.render.soft
import raytpu_torch.core.stl, raytpu_torch.oracle.raytracer_oracle
import raytpu_torch.oracle.rasterizer_oracle
import raytpu_torch.kernels.soft_raster, raytpu_torch.opt.fit
import raytpu_torch.kernels.soft_raytrace, raytpu_torch.kernels.cull
import raytpu_torch.utils.profiling
loaded = sorted(m for m in sys.modules
                if m == "jax" or m.startswith(("jax.", "raytpu.")) or m == "raytpu")
assert not loaded, loaded
print("no jax")
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", _IMPORT_CHECK], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "no jax" in proc.stdout


def test_chip_smoke_fails_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr
