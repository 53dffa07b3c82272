"""Carry the JAX package's scene, camera and lights across to the port.

The JAX package's Scene, Camera and Lights are pytrees of float32 arrays.
A caller turns their leaves into numpy arrays (``np.asarray`` of each
field) and hands them here; these functions copy them, unchanged, into the
port's dataclasses on ``device``. Both packages then compute on identical
numbers. This module is numpy -> torch only and never imports jax.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from raytpu_torch.core.types import Camera, Lights, Scene


def _from_numpy(cls, leaves: Mapping[str, np.ndarray], device):
    out = {}
    for field in dataclasses.fields(cls):
        arr = np.asarray(leaves[field.name])
        if arr.dtype != np.float32:
            raise ValueError(
                f"{cls.__name__}.{field.name}: expected float32, got "
                f"{arr.dtype} (a cast would change the numbers)"
            )
        out[field.name] = torch.tensor(arr, device=device)
    return cls(**out)


def scene_from_numpy(leaves: Mapping[str, np.ndarray], *, device) -> Scene:
    """Scene from ``v0``, ``v1``, ``v2``, ``color`` and ``active``."""
    return _from_numpy(Scene, leaves, device)


def camera_from_numpy(leaves: Mapping[str, np.ndarray], *, device) -> Camera:
    """Camera from ``pos``, ``yaw``, ``focal``, ``y_scale``, ``dof_focus``."""
    return _from_numpy(Camera, leaves, device)


def lights_from_numpy(leaves: Mapping[str, np.ndarray], *, device) -> Lights:
    """Lights from ``position``, ``color``, ``intensity``, ``mask`` and
    ``jitter``."""
    return _from_numpy(Lights, leaves, device)


def to_numpy(value: Scene | Camera | Lights) -> dict[str, np.ndarray]:
    """The leaves of a port value as host numpy arrays, keyed by field."""
    return {
        field.name: getattr(value, field.name).detach().cpu().numpy()
        for field in dataclasses.fields(value)
    }


def grads_to_numpy(value: Scene | Camera | Lights) -> dict[str, np.ndarray]:
    """The ``.grad`` of each leaf of a port value as host numpy arrays,
    keyed by field; zeros where a leaf has no gradient (it took no part in
    the loss), as ``jax.grad`` gives."""
    out = {}
    for field in dataclasses.fields(value):
        leaf = getattr(value, field.name)
        grad = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        out[field.name] = grad.detach().cpu().numpy()
    return out
