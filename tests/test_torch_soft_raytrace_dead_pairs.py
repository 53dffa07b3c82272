"""K10e's and K10f's early-out on the CPU: the plain dead-pair predicate.

Above JAX's fused limit the soft raytracer's primary backward runs K10e and
K10f, which stop a (ray, row) pair as soon as a bound of its logit,
``B = (zs / max(dmin, 0.1) + min(es margin, 0)) + log(active + 1e-20)``,
lies more than 110 below the ray's saved max m: its weight exp(logit - m)
is then exactly 0 in float32 (csrc/soft_raytrace.cu::pri_pair_dead).
kernels/soft_raytrace.py::primary_dead_pairs is the predicate's plain
form, in the kernels' order of operations. These tests hold it, on the
port's plain float32 logit (``primary_terms``) and on JAX's
(``_primary_terms``), to never mark a pair whose weight is not 0, and to
catch nearly all that are: on a torus frame where most rays hit, at
sharpness 200, on rows of active 0, for a negative zs, on hand-made pairs
either side of the threshold, and on the frame through the main path's
torus's hole, where every ray misses and every pair is dead.

m is the forward's saved max, max(0, every logit): the background's logit
is 0, and the chunk-by-chunk running max of ``primary_agg_reference`` is
that maximum exactly. Torch runs on one thread (a module fixture): under
the suite's workers the intra-op pool oversubscribes the cores.
"""

import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.kernels import soft_raytrace_pallas as jax_srt

from raytpu_torch.core.stl import load_stl, procedural_stl_text
from raytpu_torch.core.types import Camera, RenderConfig
from raytpu_torch.kernels import soft_raytrace as srt
from raytpu_torch.render.soft import raytrace_soft_inputs

ES = ZS = 40.0


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torus(quads):
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/torus.stl"
        with open(path, "w") as f:
            f.write(procedural_stl_text(*quads))
        return load_stl(path, device="cpu")


def _frame(quads, size, step, camera=None, es=ES, zs=ZS):
    """The primary table of the torus and the rays of every step-th row and
    column of the size^2 frame (the rasterizer's default camera, as the
    main path's culled step)."""
    camera = camera or Camera.rasterizer_default(device="cpu")
    cfg = RenderConfig(width=size, height=size, mode="soft",
                       soft_edge_sharpness=es, soft_z_sharpness=zs)
    with torch.no_grad():
        inp = raytrace_soft_inputs(_torus(quads), camera, cfg, cull=False)
    dirs = inp.dirs.reshape(3, size, size)[:, ::step, ::step]
    return inp.pri, camera.pos, dirs.reshape(3, -1).contiguous()


def _weights(pri, cam, dirs, es, zs, m=None):
    """The plain float32 logit of every pair (gated: -1e30), m (the saved
    max where not given) and the weight exp(logit - m)."""
    logit, _ = srt.primary_terms(pri, cam, dirs[0:1], dirs[1:2], dirs[2:3],
                                 es, zs)
    if m is None:
        m = torch.clamp_min(logit.max(dim=0).values, 0.0)
    return logit, m, torch.exp(logit - m)


def _counts(pri, cam, dirs, es, zs, m=None):
    """(pairs, gated, marked dead and not gated, weight not 0, marked with
    a weight not 0) on the whole table at once."""
    with torch.no_grad():
        logit, m, w = _weights(pri, cam, dirs, es, zs, m)
        dead = srt.primary_dead_pairs(pri, dirs, m, es, zs)
    gated = logit == -1e30
    live = w != 0.0
    return dict(pairs=logit.numel(), gated=int(gated.sum()),
                dead=int((dead & ~gated).sum()), live=int(live.sum()),
                wrong=int((dead & live).sum()))


@pytest.fixture(scope="module")
def torus_frame():
    """The 1,600-triangle torus (40 x 20 quads) on every 8th row and
    column of the 512^2 frame: 4,096 rays, 72% of them hit."""
    return _frame((40, 20), 512, 8)


def test_predicate_on_the_torus_frame(torus_frame):
    """Never a pair of weight not 0; 99.18% of the gate's passing pairs of
    weight 0 caught (the counts measured on this frame)."""
    got = _counts(*torus_frame, ES, ZS)
    assert got == dict(pairs=6553600, gated=959415, dead=5162596,
                       live=389111, wrong=0)
    zero = got["pairs"] - got["gated"] - got["live"]
    assert got["dead"] >= 0.99 * zero


def test_predicate_holds_against_jax_weights(torus_frame):
    """JAX's own logit (``_primary_terms``, XLA on the CPU) on the same
    pairs: no pair the predicate marks has a JAX weight that is not 0."""
    pri, cam, dirs = torus_frame
    gl = np.zeros((1, 16), np.float32)
    gl[0, :3] = cam.numpy()
    d = dirs.numpy()
    logit, _ = jax_srt._primary_terms(
        jnp.asarray(pri.numpy()), jnp.asarray(gl), jnp.zeros((1, 8)),
        jnp.asarray(d[0:1]), jnp.asarray(d[1:2]), jnp.asarray(d[2:3]),
        es=ES, zs=ZS, ambient=0.0, capacity=1, t_near=srt.T_NEAR)
    logit = torch.tensor(np.asarray(logit))
    m = torch.clamp_min(logit.max(dim=0).values, 0.0)
    live = torch.exp(logit - m) != 0.0
    dead = srt.primary_dead_pairs(pri, dirs, m, ES, ZS)
    assert int(live.sum()) > 100_000 and int(dead.sum()) > 5_000_000
    assert not (dead & live).any()


@pytest.mark.parametrize("case", ["sharpness200", "inactive_rows",
                                  "negative_zs"])
def test_predicate_never_marks_a_live_pair(torus_frame, case):
    """The 70-triangle torus (5 x 7 quads) at sharpness 200 through a camera
    5 units off; the torus frame with every third row of active 0 (log
    active ~ -46); and with zs = -40 (the bound's first term 0)."""
    es = zs = ES
    if case == "sharpness200":
        es = zs = 200.0
        frame = _frame((5, 7), 32, 1, Camera.make(
            (0.0123, -0.5, -5.0), focal=20.0, device="cpu"), es, zs)
    elif case == "inactive_rows":
        pri, cam, dirs = torus_frame
        pri = pri.clone()
        pri[::3, 16] = 0.0
        frame = pri, cam, dirs
    else:
        zs = -40.0
        frame = torus_frame
    got = _counts(*frame, es, zs)
    assert got["wrong"] == 0
    assert got["live"] > 0 and got["dead"] > 0.9 * (
        got["pairs"] - got["gated"] - got["live"]), got


def _bound(pri, dirs, es, zs):
    """B of every pair, written out here in pri_pair_dead's order."""
    d = [dirs[j:j + 1] for j in range(3)]

    def dot(k):
        return (d[0] * pri[:, k:k + 1] + d[1] * pri[:, k + 1:k + 2]) + \
            d[2] * pri[:, k + 2:k + 3]

    denom = -dot(0)
    rec = 1.0 / torch.where(denom.abs() > 1e-12, denom, 1e-12)
    u, v = dot(3) * rec, dot(6) * rec
    xs = es * torch.fmin(torch.fmin(u, v), (1.0 - u) - v)
    dmin = pri[:, 17:18]
    zb = zs * (1.0 / torch.fmax(dmin, torch.full_like(dmin, srt.T_NEAR)))
    return (zb + torch.where(xs > 0.0, 0.0, xs)) + torch.log(
        pri[:, 16:17] + 1e-20)


def test_predicate_either_side_of_the_threshold(torus_frame):
    """Hand-made pairs: each of the torus frame's first 64 rows against
    every ray that passes its gate with |B| < 50, the ray's m set so that
    B - m lies 1e-3 above or below -110, then so that the weight is e^-80.
    The predicate marks exactly the pairs below the threshold, all of weight
    0, and no pair of weight e^-80; B is never below the logit."""
    pri, cam, dirs = torus_frame
    pri = pri[:64]
    with torch.no_grad():
        logit, _, _ = _weights(pri, cam, dirs, ES, ZS)
        B = _bound(pri, dirs, ES, ZS)
    ok = logit != -1e30
    assert bool((B[ok] >= logit[ok]).all())
    # |B| < 50: B + 110 rounds to within 2e-5, well inside the 1e-3.
    near = ok & (B.abs() < 50.0)
    assert int(near.sum()) > 1000
    for i in range(pri.shape[0]):
        b, lg, dr = B[i][near[i]], logit[i][near[i]], dirs[:, near[i]]
        for gap, want in ((-srt.DEAD_BELOW - 1e-3, False),
                          (-srt.DEAD_BELOW + 1e-3, True)):
            m = b + gap
            dead = srt.primary_dead_pairs(pri[i:i + 1], dr, m, ES, ZS)[0]
            assert bool((dead == want).all()), (i, gap)
            assert not (torch.exp(lg - m)[dead] != 0.0).any()
        m = lg + 80.0
        dead = srt.primary_dead_pairs(pri[i:i + 1], dr, m, ES, ZS)[0]
        assert bool((torch.exp(lg - m) != 0.0).all()) and not dead.any()


def test_hole_frame_every_pair_dead():
    """The main path's 66,560-triangle torus (256 x 130 quads) on every 4th
    row and column of the 48^2 frame, which looks through its hole: every
    ray misses (m = 0), no pair has a weight that is not 0, and the
    predicate marks every pair the gate passes."""
    got = _counts(*_frame((256, 130), 48, 4), ES, ZS)
    assert got["pairs"] == 66560 * 144 and got["live"] == 0
    assert got["dead"] == got["pairs"] - got["gated"] > 8_000_000
