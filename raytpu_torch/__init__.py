"""raytpu_torch — the PyTorch/CUDA port of raytpu for NVIDIA Hopper.

Mirrors the JAX package's layout (core, ops, kernels, render, cli). Plain
tensor code is PyTorch; each Pallas kernel of the JAX package becomes a
kernel written by hand in CUDA C++ (raytpu_torch/csrc). Tensors on a CUDA
device go through those kernels; tensors on the CPU go through their plain
PyTorch versions. This package never imports jax.

Public API:
  raytrace(scene, camera, lights, cfg)  -> image (H, W, 3) float32 tensor
  rasterize(scene, camera, lights, cfg) -> image (H, W, 3) float32 tensor
  load_stl(path, *, device)             -> Scene of an ASCII STL model
"""

from raytpu_torch.core.cornell import cornell_box
from raytpu_torch.core.stl import load_stl
from raytpu_torch.core.types import Camera, Lights, RenderConfig, Scene
from raytpu_torch.render.rasterize import rasterize
from raytpu_torch.render.raytrace import raytrace

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Lights",
    "RenderConfig",
    "Scene",
    "cornell_box",
    "load_stl",
    "rasterize",
    "raytrace",
]
