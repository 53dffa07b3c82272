"""The port stands alone: it imports no JAX, and chip_smoke.py fails
cleanly where there is no GPU."""

import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_NO_JAX = """
loaded = sorted(m for m in sys.modules
                if m in ("jax", "raytpu", "bench")
                or m.startswith(("jax.", "raytpu.", "bench.")))
assert not loaded, loaded
print("no jax")
"""

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
import raytpu_torch.parallel, raytpu_torch.parallel.render
import raytpu_torch.parallel.collectives, raytpu_torch.parallel.mp_dryrun
import raytpu_torch.labs.megakernel_lab6, raytpu_torch.labs.megakernel_lab4
import raytpu_torch.kernels.labs, raytpu_torch.native
import raytpu_torch.labs.timing
""" + _NO_JAX


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


def _is_package(name: str) -> bool:
    spec = importlib.util.find_spec(name)
    return spec is not None and spec.submodule_search_locations is not None


def test_chip_smoke_loads_nothing_of_jax():
    """Every import statement of chip_smoke.py, its phases' included, names
    no module of JAX or of the JAX package, and importing the script (as a
    module: main() does not run) with the modules its phases use loads
    none."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
            # ``from package import module`` imports the module too.
            if node.module.startswith("raytpu_torch") and \
                    _is_package(node.module):
                names.update(
                    f"{node.module}.{a.name}" for a in node.names
                    if importlib.util.find_spec(f"{node.module}.{a.name}"))
    assert "raytpu_torch.parallel.render" in names
    bad = sorted(n for n in names
                 if n.split(".")[0] in ("jax", "jaxlib", "raytpu", "bench"))
    assert not bad, bad
    check = "\n".join(
        ["import sys", "sys.path.insert(0, '.')", "import chip_smoke"]
        + [f"import {n}" for n in sorted(names)
           if n.startswith("raytpu_torch")]) + _NO_JAX
    proc = subprocess.run([sys.executable, "-c", check], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "no jax" in proc.stdout
