"""K9c's and K9d's early-out on the CPU: the plain dead-pair predicate.

The soft rasterizer's backward kernels stop a (pixel, row) pair whose
logit bound ``B = (zb + min(es sd, 0)) + log(valid + 1e-20)`` (sd the
kernels' own signed distance, zb >= zs * zpx for any barycentrics of the
row) lies more than 110 below the pixel's saved max m: its weight
exp(logit - m) is then exactly 0 in float32, and on rows and pixels whose
inputs are tame (every used column and cotangent within 2^40 in
magnitude, valid + 1e-20 not 0) every term the pair would add is +-0
(csrc/soft_raster.cu::soft_pair_dead). kernels/soft_raster.py::
soft_dead_pairs is the predicate's plain form, in the kernels' order of
operations. These tests hold it, on JAX's own logit (``_chunk_terms``), to
never mark a pair whose weight is not 0, to catch nearly all that are, and
to leave non-finite inputs alone; and they hold the plain backward with
the marked pairs dropped to the plain backward with them kept, bit for
bit: a skipped pair changes nothing.

m is the forward's saved max, max(0, every kept logit): the background's
logit is 0, and the chunk-by-chunk running max is that maximum exactly.
Torch runs on one thread (a module fixture): under the suite's workers the
intra-op pool oversubscribes the cores.
"""

import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.kernels import soft_raster_pallas as jax_sr

from raytpu_torch.core.stl import load_stl, procedural_stl_text
from raytpu_torch.core.types import Camera, RenderConfig
from raytpu_torch.kernels import soft_raster as sr
from raytpu_torch.render.soft import rasterize_soft_inputs

SIZE = 64
ES = ZS = 40.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_logit(cs, coords, es=ES, zs=ZS):
    """JAX's float32 logit of every (row, pixel) pair (XLA on the CPU)."""
    c = coords.numpy()
    logit, _ = jax_sr._chunk_terms(
        jnp.asarray(cs.numpy()), jnp.zeros((1, 16), jnp.float32),
        jnp.zeros((1, 8), jnp.float32), jnp.asarray(c[0:1]),
        jnp.asarray(c[1:2]), es=es, zs=zs, ambient=0.0, capacity=1)
    return logit


@pytest.fixture(scope="module")
def frame():
    """The 384-triangle torus (16 x 12 quads, 12 chunks) at 64^2 through
    the camera (0, 0, -3) at focal 64, sharpness 40 / 40, culled by
    soft_keep_mask; JAX's logit of every pair, m from its kept pairs, and
    one-signed cotangents drawn with numpy."""
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/torus.stl"
        with open(path, "w") as f:
            f.write(procedural_stl_text(16, 12))
        scene = load_stl(path, device="cpu")
    camera = Camera.make((0.0, 0.0, -3.0), focal=float(SIZE), y_scale=1.01,
                         device="cpu")
    cfg = RenderConfig(width=SIZE, height=SIZE, mode="soft",
                       soft_edge_sharpness=ES, soft_z_sharpness=ZS)
    with torch.no_grad():
        inp = rasterize_soft_inputs(scene, camera, cfg)
    consts, chunk, mask = inp.consts.contiguous(), inp.chunk, inp.mask
    coords = sr.pixel_coords(SIZE, SIZE, "cpu")
    pix = sr.expand_mask(mask, SIZE, SIZE)  # (n_chunks, R)
    kept = pix.repeat_interleave(chunk, dim=0)  # (Tp, R)
    logit = torch.tensor(np.asarray(_jax_logit(consts, coords)))
    m = torch.clamp_min(torch.where(kept, logit, -np.inf).max(dim=0).values,
                        0.0)
    rng = np.random.default_rng(17)
    cot = torch.tensor(rng.uniform(0.5, 1.5, (11, SIZE * SIZE)).astype(
        np.float32))
    return dict(consts=consts, chunk=chunk, mask=mask, pix=pix, kept=kept,
                coords=coords, logit=logit, m=m, cot=cot)


def test_marked_pairs_have_jax_weight_zero(frame):
    """No pair the predicate marks has a JAX weight exp(logit - m) that is
    not 0; on the kept pairs it catches 98% of those of weight 0 (the rest
    lie in the 6 units between -110 and expf's underflow)."""
    f = frame
    dead = sr.soft_dead_pairs(f["consts"], f["coords"], f["m"], f["cot"], ES,
                              ZS)
    w = torch.tensor(np.asarray(jnp.exp(jnp.asarray(
        (f["logit"] - f["m"][None, :]).numpy()))))
    live = w != 0.0
    assert not bool((dead & live).any())
    kept = f["kept"]
    zero, caught = int((kept & ~live).sum()), int((kept & dead).sum())
    print(f"\n{int(kept.sum())} kept pairs, {zero} of weight 0, {caught} "
          f"marked dead ({caught / zero:.4f} of them)")
    assert 0.2 < float(f["mask"].float().mean()) < 1.0
    assert int((kept & live).sum()) > 10_000 and zero > 100_000
    assert caught >= 0.98 * zero


def test_dropping_marked_pairs_changes_no_bit(frame):
    """The plain float32 backward with the marked pairs dropped equals it
    with them kept, bit for bit, on the mask's pairs and on every pair."""
    f = frame
    port_m = sr.soft_agg_reference(f["consts"], f["coords"], f["pix"], ES,
                                   ZS, f["chunk"])[1]
    dead = sr.soft_dead_pairs(f["consts"], f["coords"], port_m, f["cot"], ES,
                              ZS)
    for pix in (f["pix"], None):
        args = (f["consts"], f["coords"], pix, port_m, f["cot"], ES, ZS,
                f["chunk"])
        kept = sr.soft_agg_bwd_reference(*args)
        dropped = sr.soft_agg_bwd_reference(*args, drop=dead)
        assert int(dead.sum()) > 100_000
        assert torch.equal(kept.view(torch.int32), dropped.view(torch.int32))
        assert bool(torch.isfinite(kept).all()) and kept.abs().max() > 0


def _probe_row():
    """One triangle, (2, 2) (12, 2) (2, 12), a table of one row."""
    sx = torch.tensor([[2.0, 12.0, 2.0]])
    sy = torch.tensor([[2.0, 2.0, 12.0]])
    zinv = torch.tensor([[0.3, 0.25, 0.2]])
    pos3d = torch.full((1, 3, 3), 0.1)
    color = torch.tensor([[0.9, 0.2, 0.1]])
    normal = torch.tensor([[0.0, 0.0, -1.0]])
    return sr.soft_tri_constants(sx, sy, zinv, pos3d, color, normal,
                                 torch.ones(1))


def test_threshold_from_both_sides():
    """Pixels 1-20 px right of the triangle, m set a unit either side of
    B + 110: marked exactly below, and each marked pair's weight 0."""
    cs = _probe_row()
    coords = torch.stack([torch.arange(13.0, 33.0), torch.full((20,), 3.0)])
    B = sr.soft_logit_bound(cs, coords, ES, ZS)[0]
    cot = torch.ones(11, 20)
    logit, _ = sr.chunk_terms(cs, coords[0], coords[1], ES, ZS)
    for off, want in ((111.0, True), (109.0, False)):
        m = B + off
        dead = sr.soft_dead_pairs(cs, coords, m, cot, ES, ZS)[0]
        assert bool((dead == want).all())
        assert bool((torch.exp(logit[0] - m)[dead] == 0.0).all())
    assert bool((B >= logit[0]).all())


@pytest.mark.parametrize("col,value", [
    (0, float("nan")), (0, float("inf")), (3, 3e38), (9, float("inf")),
    (11, float("nan")), (16, float("inf")), (23, float("nan")),
    (28, float("inf")), (28, -1e-20)])
def test_non_finite_rows_are_never_marked(col, value):
    """A row with a NaN, an inf or a huge entry in a used column, or with
    valid + 1e-20 = 0 (log -inf, G / 0 NaN), at m far above its bound:
    nothing marked."""
    cs = _probe_row()
    cs[0, col] = value
    coords = torch.stack([torch.arange(13.0, 33.0), torch.full((20,), 3.0)])
    dead = sr.soft_dead_pairs(cs, coords, torch.full((20,), 1e6),
                              torch.ones(11, 20), ES, ZS)
    assert not bool(dead.any())


def test_non_finite_pixels_and_sharpness_are_never_marked():
    """Pixels whose m or one cotangent is NaN or inf, and es or zs inf or
    beyond 2^40: nothing marked there; the other pixels are."""
    cs = _probe_row()
    coords = torch.stack([torch.arange(13.0, 33.0), torch.full((20,), 3.0)])
    m = torch.full((20,), 1e6)
    cot = torch.ones(11, 20)
    m[1] = float("nan")
    cot[0, 2] = float("inf")
    cot[5, 3] = float("nan")
    cot[10, 4] = -float("inf")
    cot[7, 5] = 2.0 ** 41
    dead = sr.soft_dead_pairs(cs, coords, m, cot, ES, ZS)[0]
    assert not bool(dead[1:6].any()) and bool(dead[6:].all())
    assert bool(dead[0])
    for es, zs in ((float("inf"), ZS), (ES, float("nan")), (ES, 2.0 ** 41)):
        assert not bool(sr.soft_dead_pairs(cs, coords, m, cot, es, zs).any())
