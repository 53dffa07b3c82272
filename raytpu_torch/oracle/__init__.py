"""Numpy parity oracles of the reference raytracer and rasteriser.

Copies of raytpu/oracle/raytracer_oracle.py and rasterizer_oracle.py (numpy
only; the rasteriser's ``dof_post`` import points at this package's copy),
so that the port and chip_smoke.py hold their frames to the oracles without
loading anything of the JAX package. tests/test_torch_oracle.py checks that
the copies render exactly what the originals render.
"""
