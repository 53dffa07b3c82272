"""K10k's and K10l's early-out on the CPU: the plain dead-triple predicate.

Above JAX's fused limit the soft raytracer's shadow backward runs K10k and
K10l, which stop a (source, point, row) triple that is gated, or whose
sigmoid argument ``xs = es margin`` or ``y = zs (0.99 r - t)`` lies below
-100: that sigmoid, 1 / (1 + expf(-x)), is then exactly 0 in float32, and so
are the triple's term and gradient (csrc/soft_raytrace.cu::shw_triple_dead).
kernels/soft_raytrace.py::shadow_dead_triples is the predicate's plain
form, in the kernels' order of operations. These tests hold it, on the
port's plain float32 term (``shadow_terms``) and on JAX's
(``_shadow_od_terms``, one row at a time), to never mark a triple whose
term is not 0, and to catch nearly all that are: on the main path's
66,560-triangle torus with the points of its plain forward, at sharpness
200, on rows of active 0, for a negative zs, on hand-made triples either
side of -100, and on shadow rays in a triangle's plane (the gate's edge).

Torch runs on one thread (a module fixture): under the suite's workers the
intra-op pool oversubscribes the cores.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.kernels import soft_raytrace_pallas as jax_srt

from raytpu_torch.core.stl import load_stl, procedural_stl_text
from raytpu_torch.core.types import Camera, RenderConfig
from raytpu_torch.kernels import soft_raytrace as srt
from raytpu_torch.kernels.soft_raster import Kinks
from raytpu_torch.render.soft import raytrace_soft_inputs

ES = ZS = 40.0
LIGHT = (0.0, -0.5, -0.7)  # Lights.single's position: the main path's source


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
    """The shadow table of the torus and the points of the plain forward
    (the aggregated hit positions) on every step-th row and column of the
    size^2 frame (the rasterizer's default camera, as the main path's
    culled step)."""
    camera = camera or Camera.rasterizer_default(device="cpu")
    cfg = RenderConfig(width=size, height=size, mode="soft",
                       soft_edge_sharpness=es, soft_z_sharpness=zs)
    with torch.no_grad():
        inp = raytrace_soft_inputs(_torus(quads), camera, cfg, cull=False)
        dirs = inp.dirs.reshape(3, size, size)[:, ::step, ::step]
        out, _, _ = srt.primary_agg_reference(
            inp.pri, camera.pos, dirs.reshape(3, -1).contiguous(), es, zs,
            inp.chunk)
    return inp.shw, torch.tensor(LIGHT), out[3:6].contiguous()


def _terms(shw, src, world, es, zs):
    """The plain float32 term of every triple and its gate (the hit test
    ``shadow_terms`` records last)."""
    kinks = Kinks()
    with torch.no_grad():
        term = srt.shadow_terms(shw, src, world[0:1], world[1:2],
                                world[2:3], es, zs, kinks)
    return term, kinks.decisions[-1]


def _counts(shw, src, world, es, zs):
    """(triples, gated, marked dead and not gated, not gated with a term of
    0, term not 0, marked with a term not 0)."""
    term, ok = _terms(shw, src, world, es, zs)
    dead = srt.shadow_dead_triples(shw, src, world, es, zs)
    live = term != 0.0
    return dict(triples=term.numel(), gated=int((~ok).sum()),
                dead=int((dead & ok).sum()), zero=int((ok & ~live).sum()),
                live=int(live.sum()), wrong=int((dead & live).sum()))


def _jax_terms(shw, src, world, es, zs):
    """JAX's per-triple term: ``_shadow_od_terms`` of one row at a time
    under jax.vmap (XLA on the CPU), in blocks of rows."""
    sr = np.zeros((1, 8), np.float32)
    sr[0, :3] = src.numpy()
    w = world.numpy()
    f = jax.jit(jax.vmap(lambda row: jax_srt._shadow_od_terms(
        row[None], jnp.asarray(sr), jnp.asarray(w[0:1]), jnp.asarray(w[1:2]),
        jnp.asarray(w[2:3]), es=es, zs=zs)[0]))
    cs, n = shw.numpy(), 8320
    return torch.cat([torch.tensor(np.asarray(f(jnp.asarray(cs[lo:lo + n]))))
                      for lo in range(0, cs.shape[0], n)])


@pytest.fixture(scope="module")
def torus_points():
    """The main path's 66,560-triangle torus (256 x 130 quads) and the
    points of every 32nd row and column of the 512^2 frame: 256 points,
    17,039,360 triples."""
    return _frame((256, 130), 512, 32)


def test_predicate_on_the_main_torus(torus_points):
    """Never a triple of a term not 0; 99.85% of the triples the gate
    passes whose term is 0 caught (the counts measured on this frame)."""
    got = _counts(*torus_points, ES, ZS)
    assert got == dict(triples=17039360, gated=8007438, dead=8992303,
                       zero=9005826, live=26096, wrong=0)
    assert got["dead"] >= 0.99 * got["zero"]


def test_predicate_holds_against_jax_terms(torus_points):
    """JAX's own term on the same triples: no triple the predicate marks
    has a JAX term that is not 0."""
    shw, src, world = torus_points
    live = _jax_terms(shw, src, world, ES, ZS) != 0.0
    dead = srt.shadow_dead_triples(shw, src, world, ES, ZS)
    assert int(live.sum()) > 20_000 and int(dead.sum()) > 15_000_000
    assert not (dead & live).any()


@pytest.mark.parametrize("case", ["sharpness200", "inactive_rows",
                                  "negative_zs"])
def test_predicate_never_marks_a_live_triple(case):
    """The 70-triangle torus (5 x 7 quads) at sharpness 200 through a camera
    5 units off; the 1,600-triangle torus (40 x 20 quads) on every 16th row
    and column of the 512^2 frame with every third row of active 0; and
    with zs = -40 (the sign of y flips)."""
    es = zs = ES
    if case == "sharpness200":
        es = zs = 200.0
        shw, src, world = _frame((5, 7), 32, 1, Camera.make(
            (0.0123, -0.5, -5.0), focal=20.0, device="cpu"), es, zs)
    else:
        shw, src, world = _frame((40, 20), 512, 16)
        if case == "inactive_rows":
            shw = shw.clone()
            shw[::3, 13] = 0.0
        else:
            zs = -40.0
    got = _counts(shw, src, world, es, zs)
    assert got["wrong"] == 0
    assert got["live"] > 0 and got["dead"] > 0.9 * got["zero"], got


def _one_triangle():
    """A shadow table of one hand-made row: v0 = 0, e1 = x, e2 = y, so n =
    z and a ray along z through (a, b, 0) has u = a, v = b; chunk of one."""
    v0, e1, e2 = (0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)
    row = [*v0, *e1, *e2, 0.0, 0.0, 1.0, 0.0, 1.0, 0.0, 0.0]
    return torch.tensor([row], dtype=torch.float32)


def _held(shw, src, world, es, zs):
    """The predicate on the triples, each checked against the plain and
    JAX terms: a marked triple's term is 0 in both."""
    dead = srt.shadow_dead_triples(shw, src, world, es, zs)
    term, _ = _terms(shw, src, world, es, zs)
    jterm = _jax_terms(shw, src, world, es, zs)
    assert not (term[dead] != 0.0).any() and not (jterm[dead] != 0.0).any()
    return dead[0]


def test_predicate_either_side_of_the_threshold():
    """Hand-made triples: rays along z through (a, 0.3, 0) of the unit
    triangle, es = 40 (margin = a, xs = 40 a), with a 1e-4 either side of
    -2.5; and rays from (0.25, 0.25, -1) to points L along z, zs = 200 (t
    = 1, y = 200 (0.99 L - 1)), with L 1e-4 either side of 0.5 / 0.99. The
    predicate marks exactly the triples whose xs or y lies below -100, and
    every one it marks has a term of 0."""
    shw = _one_triangle()
    a = torch.tensor([-2.5 - 1e-4, -2.5 + 1e-4, -2.6, -2.4, -1e6])
    src = torch.tensor([0.0, 0.3, -1.0])
    for ai, want in zip(a.tolist(), (True, False, True, False, True)):
        s = src.clone()
        s[0] = ai
        world = torch.tensor([[ai], [0.3], [1.0]])
        assert bool(_held(shw, s, world, ES, ZS)[0]) == want, ai
    src = torch.tensor([0.25, 0.25, -1.0])
    L = 0.5 / 0.99 + torch.tensor([-1e-4, 1e-4, -0.1, 0.1])
    world = torch.stack([torch.full_like(L, 0.25), torch.full_like(L, 0.25),
                         -1.0 + L])
    dead = _held(shw, src, world, ES, 200.0)
    assert dead.tolist() == [True, False, True, False]


def test_predicate_on_rays_in_the_triangles_plane():
    """A shadow ray in the plane of the unit triangle (z = 0: t = 0 and
    denom 0) and one through it at |denom| 2e-4 (below the gate's 1e-3
    |n|, t = 1.5) are gated and marked; one at 0.2 passes the gate, hits
    the triangle and is not marked. Every marked triple has a term of 0 in
    both packages."""
    shw = _one_triangle()
    for z, want in ((0.0, True), (3e-4, True), (0.3, False)):
        src = torch.tensor([-1.0, 0.25, -z])
        world = torch.tensor([[2.0], [0.25], [z]])
        _, ok = _terms(shw, src, world, ES, ZS)
        assert bool(_held(shw, src, world, ES, ZS)[0]) == want, z
        assert bool(ok[0, 0]) != want, z
