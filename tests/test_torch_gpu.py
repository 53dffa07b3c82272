"""The port's CUDA kernel on a card, against its plain PyTorch version.

Every test here needs a CUDA device and nvcc; without a card each skips.
The file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX on the CPU.)
"""

import pytest
import torch

from raytpu_torch.core.cornell import cornell_box
from raytpu_torch.core.types import Camera, Lights, RenderConfig
from raytpu_torch.kernels import render_fused
from raytpu_torch.kernels.tables import pack_params, pack_tables
from raytpu_torch.render.raytrace import fused_inputs, raytrace_full

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(device, size, mode, pad_to=32, yaw=0.0, pos=(0.0, 0.0, -2.0)):
    cfg = RenderConfig(width=size, height=size, mode=mode)
    args = fused_inputs(cornell_box(pad_to=pad_to, device=device),
                        Camera.make(pos, yaw=yaw, device=device),
                        Lights.single(capacity=1, device=device), cfg)
    return args, dict(tri_chunk=cfg.tri_chunk, ambient=cfg.ambient,
                      parity=mode == "parity")


@pytest.mark.parametrize("mode", ["clean", "parity"])
@pytest.mark.parametrize("size,pad_to,yaw,pos", [
    (512, 32, 0.0, (0.0, 0.0, -2.0)),
    (257, None, 0.3, (0.2, -0.1, -1.8)),
])
def test_kernel_matches_plain_version(cuda, mode, size, pad_to, yaw, pos):
    args, kw = _inputs(cuda, size, mode, pad_to, yaw, pos)
    before = render_fused.LAUNCHES
    got = render_fused.render_hard_fused(*args, **kw)
    assert render_fused.LAUNCHES == before + 1
    want = render_fused.render_hard_fused_reference(*args, **kw)
    torch.cuda.synchronize()
    assert int((got.idx != want.idx).sum()) == 0
    assert int((got.occ != want.occ).sum()) == 0
    assert float((got.color - want.color).abs().max()) <= 1e-6
    assert float((got.fd - want.fd).abs().max()) <= 1e-6
    assert float((got.idx >= 0).float().mean()) > 0.9


def test_slice_on_gpu_matches_cpu(cuda):
    def render(device):
        return raytrace_full(cornell_box(device=device),
                             Camera.raytracer_default(device=device),
                             Lights.single(capacity=1, device=device),
                             RenderConfig(width=64, height=64))

    got, want = render(cuda), render("cpu")
    # PyTorch's CPU sqrt is not always correctly rounded; the card's is.
    assert float((got.image.cpu() - want.image).abs().max()) <= 1e-6
    assert float((got.focal_distances.cpu()
                  - want.focal_distances).abs().max()) <= 1e-6


def test_kernel_refuses_inputs_that_need_grad(cuda):
    args, kw = _inputs(cuda, 16, "clean")
    args = list(args)
    args[6] = args[6].clone().requires_grad_(True)  # normals
    with pytest.raises(NotImplementedError, match="K2/K3"):
        render_fused.render_hard_fused(*args, **kw)
    with torch.no_grad():
        render_fused.render_hard_fused(*args, **kw)


def test_wrapper_checks_its_inputs(cuda):
    args, kw = _inputs(cuda, 16, "clean")
    table = pack_tables(*args[1:8], 32)
    params = pack_params(*args[8:12])
    dirs = args[0]
    call = dict(ambient=0.2, parity=False)
    with pytest.raises(TypeError):
        render_fused.fused_fwd(dirs.double(), table, params, **call)
    with pytest.raises(ValueError):
        render_fused.fused_fwd(dirs[:, :2].contiguous(), table, params, **call)
    with pytest.raises(ValueError):
        render_fused.fused_fwd(dirs.T.contiguous().T, table, params, **call)
    with pytest.raises(ValueError):
        render_fused.fused_fwd(dirs, table.cpu(), params, **call)
    wide = torch.zeros((table.shape[0], 129), device=cuda)
    with pytest.raises(ValueError):
        render_fused.fused_fwd(dirs, wide, params, **call)
