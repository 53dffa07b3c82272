"""K10g's and K10h's early-out and work items on the CPU: the plain forms.

The shadow forwards add each (source, point, row) triple's term
``sigmoid(xs) active sigmoid(y)`` to the optical depth, and skip a triple
whose term is +-0 (csrc/soft_raytrace.cu::shw_term_dead): gated, or with
``xs = es margin`` or ``y = zs (0.99 r - t)`` below -100, where that
sigmoid is exactly 0, and only where the active column is finite and none
of 1 - u - v, xs and y is NaN. kernels/soft_raytrace.py::shadow_dead_terms
is that test's plain form, in the kernels' order of operations. These
tests hold it to never mark a triple whose term is not +-0, on the port's
plain float32 term (``shadow_terms``) and on JAX's (``_shadow_od_terms``,
one row at a time), and to catch nearly all the triples of term 0 that the
gate passes, on the 9,028-triangle torus's kept chunks; on hand-made
triples either side of -100 and with NaN and inf inputs. The kernels also
cut each (tile, source)'s kept chunks into runs, a work item each, and fold
the runs' optical depths in order: ``shadow_trans_runs``, the plain model of
that order, equals the plain masked forward within the kernels' tolerance,
and an all-ones mask cuts at the unmasked route's chunks.

Torch runs on one thread (a module fixture): under the suite's workers the
intra-op pool oversubscribes the cores.
"""

import functools
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
from raytpu_torch.kernels.intersect import TILE_RAYS
from raytpu_torch.kernels.soft_raster import Kinks
from raytpu_torch.render.soft import raytrace_soft_inputs

ES = ZS = 40.0
LIGHT = (0.3, -1.5, -3.0)  # the culled test frames' light (tests/test_torch_gpu.py)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _terms(shw, src, world, es, zs):
    """The plain float32 term of every triple and its gate (the hit test
    ``shadow_terms`` records last)."""
    kinks = Kinks()
    with torch.no_grad():
        term = srt.shadow_terms(shw, src, world[0:1], world[1:2],
                                world[2:3], es, zs, kinks)
    return term, kinks.decisions[-1]


@functools.lru_cache(maxsize=None)
def _jax_fn(es, zs):
    """``_shadow_od_terms`` of one row at a time under jax.vmap, jitted once
    a sharpness."""
    def one(row, sr, wx, wy, wz):
        return jax_srt._shadow_od_terms(row[None], sr, wx, wy, wz, es=es,
                                        zs=zs)[0]
    return jax.jit(jax.vmap(one, in_axes=(0, None, None, None, None)))


def _jax_terms(shw, src, world, es, zs):
    """JAX's per-triple term: ``_shadow_od_terms`` of one row at a time
    (XLA on the CPU), in blocks of 1,024 rows."""
    sr = np.zeros((1, 8), np.float32)
    sr[0, :3] = src.numpy()
    w = [jnp.asarray(world[j:j + 1].numpy()) for j in range(3)]
    cs, n = shw.numpy(), 1024
    if cs.shape[0] % n:
        cs = np.concatenate([cs, np.zeros((n - cs.shape[0] % n, 16),
                                          np.float32)])
    f = _jax_fn(es, zs)
    got = torch.cat([torch.tensor(np.asarray(f(jnp.asarray(cs[lo:lo + n]),
                                                jnp.asarray(sr), *w)))
                     for lo in range(0, cs.shape[0], n)])
    return got[:shw.shape[0]]


def _by_rows(fn, shw, *args, n=1024):
    """fn(rows, *args) on blocks of n rows of the table, stacked: the
    (rows, points) intermediates of a whole table would take gigabytes."""
    return torch.cat([fn(shw[lo:lo + n], *args)
                      for lo in range(0, shw.shape[0], n)])


@pytest.fixture(scope="module")
def torus():
    """The 9,028-triangle torus (283 chunks of 32) culled on a 64 x 64
    frame from the STL camera at f = 38.4 (the GPU tests' culled frames):
    the shadow table, the light, the aggregated hit positions of the plain
    masked forward, the shadow mask over the 16 x 16 tiles and the tiles."""
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/torus.stl"
        with open(path, "w") as f:
            f.write(procedural_stl_text())
        scene = load_stl(path, device="cpu")
    camera = Camera.make((0.0, -0.5, -5.0), focal=38.4, device="cpu")
    cfg = RenderConfig(width=64, height=64, mode="soft",
                       soft_edge_sharpness=ES, soft_z_sharpness=ZS)
    src = torch.tensor(LIGHT)
    with torch.no_grad():
        inp = raytrace_soft_inputs(scene, camera, cfg, cull=True)
        out, _, _ = srt.primary_agg_reference(
            inp.pri, camera.pos, inp.dirs, ES, ZS, inp.chunk, inp.mask,
            inp.tiles)
        world = out[3:6].contiguous()
        smask = srt.soft_rt_shadow_mask(
            world.T[inp.tiles.rays], src[None], scene.v0, scene.v1,
            scene.v2, ES, ZS, TILE_RAYS, inp.chunk)
    assert inp.shw.shape[0] == 283 * 32 and inp.chunk == 32
    return dict(shw=inp.shw, src=src, world=world, smask=smask,
                tiles=inp.tiles, chunk=inp.chunk)


def _kept_counts(c):
    """Over the kept (tile, chunk) triples: (triples, gated, term 0 and not
    gated, marked and not gated, marked with a term not 0)."""
    n = dict(triples=0, gated=0, zero=0, dead=0, wrong=0)
    shw, chunk = c["shw"], c["chunk"]
    for k in range(shw.shape[0] // chunk):
        keep = torch.nonzero(c["smask"][c["tiles"].tile, 0, k]).squeeze(1)
        if keep.numel() == 0:
            continue
        rows, w = shw[k * chunk:(k + 1) * chunk], c["world"][:, keep]
        term, ok = _terms(rows, c["src"], w, ES, ZS)
        dead = srt.shadow_dead_terms(rows, c["src"], w, ES, ZS)
        n["triples"] += term.numel()
        n["gated"] += int((~ok).sum())
        n["zero"] += int((ok & (term == 0.0)).sum())
        n["dead"] += int((ok & dead).sum())
        n["wrong"] += int((dead & (term != 0.0)).sum())
    return n


def test_catches_the_zero_terms_of_the_kept_chunks(torus):
    """On the torus's kept chunks (17,965,056 triples, 48.5% of the frame's):
    no triple of a term not 0 marked, and 97.5% of the gate's passing
    triples of term 0 caught (15,260,793 of 15,654,096 as measured; the
    rest have xs or y between -100 and float32's underflow near -88)."""
    got = _kept_counts(torus)
    assert got["wrong"] == 0
    assert 0 < got["triples"] < 283 * 32 * 64 * 64
    assert got["gated"] > 0 and got["zero"] > 0
    assert got["dead"] >= 0.97 * got["zero"], got


def test_marks_no_term_that_jax_or_the_plain_version_gives_not_zero(torus):
    """Every row of the table against the frame's points (kept or not):
    no triple the test marks has a plain or JAX term that is not +-0, and
    the backward's test marks at least what the forward's does."""
    shw, src, world = torus["shw"], torus["src"], torus["world"][:, ::3]
    args = (src, world, ES, ZS)
    dead = _by_rows(srt.shadow_dead_terms, shw, *args)
    term = _by_rows(lambda rows, *a: _terms(rows, *a)[0], shw, *args)
    jterm = _jax_terms(shw, *args)
    assert int(dead.sum()) > 0.5 * dead.numel()
    assert not (dead & (term != 0.0)).any()
    assert not (dead & (jterm != 0.0)).any()
    assert not (dead & ~_by_rows(srt.shadow_dead_triples, shw, *args)).any()


def _one_triangle(active=1.0, n_v0=0.0, e2=(0.0, 1.0, 0.0)):
    """A shadow table of one hand-made row: v0 = 0, e1 = x, e2 = y, so n =
    z and a ray along z through (a, b, 0) has u = a, v = b."""
    row = [0.0, 0.0, 0.0, 1.0, 0.0, 0.0, *e2, 0.0, 0.0, 1.0, n_v0, active,
           0.0, 0.0]
    return torch.tensor([row], dtype=torch.float32)


def _held(shw, src, world, es, zs):
    """The test on the triples, each checked against the plain and JAX
    terms: a marked triple's term is +-0 in both (a NaN term is not)."""
    dead = srt.shadow_dead_terms(shw, src, world, es, zs)
    term, _ = _terms(shw, src, world, es, zs)
    jterm = _jax_terms(shw, src, world, es, zs)
    assert not (dead & (term != 0.0)).any()
    assert not (dead & (jterm != 0.0)).any()
    return dead[0].tolist()


def _along_z(a, b=0.3, z0=-1.0, z1=1.0):
    """A source at (a, b, z0) and a point at (a, b, z1): the ray along z
    through (a, b, 0), t = -z0."""
    return torch.tensor([a, b, z0]), torch.tensor([[a], [b], [z1]])


@pytest.mark.parametrize("edge", ["xs", "y"])
def test_either_side_of_the_threshold(edge):
    """xs = 40 a with a 1e-4 either side of -2.5 (margin = a); y = 200 (0.99
    L - 1) with L 1e-4 either side of 0.5 / 0.99: marked exactly below
    -100, and every mark holds against both packages' terms."""
    shw = _one_triangle()
    if edge == "xs":
        marks = []
        for a in (-2.5 - 1e-4, -2.5 + 1e-4, -2.6, -2.4, -1e6):
            marks += _held(shw, *_along_z(a), ES, ZS)
        assert marks == [True, False, True, False, True]
    else:
        L = 0.5 / 0.99 + torch.tensor([-1e-4, 1e-4, -0.1, 0.1])
        world = torch.stack([torch.full_like(L, 0.25),
                             torch.full_like(L, 0.25), -1.0 + L])
        marks = _held(shw, torch.tensor([0.25, 0.25, -1.0]), world, ES,
                      200.0)
        assert marks == [True, False, True, False]


@pytest.mark.parametrize("case", [
    "nan_y", "gated_nan_y", "inf_active", "nan_active", "nan_point",
    "inf_point", "nan_edge", "inf_es"])
def test_nan_and_inf_inputs_are_not_marked(case):
    """Where a NaN or inf reaches the term, 0 inf or 0 NaN would make it
    NaN: the test marks nothing there, though xs lies far below -100 (a =
    -10: xs = -400) or the gate stops the triple, and the backward's test
    marks it (but where u is NaN and v not, or es is inf: xs is not below
    -100 there). nan_y: zs = NaN, so
    y is NaN and the gate passes; gated_nan_y: n . v0 = NaN, so t and y
    are NaN and the triple gated; a row whose active column is inf or NaN;
    a point or a row's edge e2 with a NaN or inf (u NaN, v not); es = inf
    (xs = -inf, and inf 0 = NaN where the margin is 0)."""
    es, zs = ES, ZS
    shw = _one_triangle()
    src, world = _along_z(-10.0)
    if case == "nan_y":
        zs = float("nan")
    elif case == "gated_nan_y":
        shw = _one_triangle(n_v0=float("nan"))
    elif case in ("inf_active", "nan_active"):
        shw = _one_triangle(active=float(case[:3]))
    elif case == "nan_point":
        world = torch.tensor([[float("nan")], [0.3], [1.0]])
    elif case == "inf_point":
        world = torch.tensor([[-10.0], [float("inf")], [1.0]])
    elif case == "nan_edge":
        shw = _one_triangle(e2=(float("nan"), 1.0, 0.0))
    else:
        es = float("inf")
        src, world = _along_z(0.0)  # margin 0 at the triangle's corner
    assert _held(shw, src, world, es, zs) == [False]
    assert bool(srt.shadow_dead_triples(shw, src, world, es, zs)[0, 0]) == (
        case not in ("nan_edge", "inf_es"))


def test_run_model_equals_the_plain_masked_forward(torus):
    """The torus frame's optical depth folded run by run (runs of 5 and of
    SHW_RUN kept chunks) equals the plain masked forward within rtol 1e-5 /
    atol 1e-6, and the unmasked route's runs equal the brute forward's; an
    all-ones mask cuts at the unmasked route's chunks."""
    args = (torus["shw"], torus["src"][None], torus["world"][:, ::2], ES, ZS,
            torus["chunk"])
    tiles = torus["tiles"]
    want = srt.shadow_trans_reference(*args)
    for run in (5, srt.SHW_RUN):
        got = srt.shadow_trans_runs(*args, run=run)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    margs = (torus["shw"], torus["src"][None], torus["world"], ES, ZS,
             torus["chunk"], torus["smask"], tiles)
    want = srt.shadow_trans_reference(*margs)
    for run in (5, srt.SHW_RUN):
        got = srt.shadow_trans_runs(*margs, run=run)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    n_tiles, S, n_chunks = torus["smask"].shape
    runs = srt.shadow_run_index(torus["smask"], n_tiles, S, n_chunks)
    assert int(runs.max()) >= 1 and bool((runs[torus["smask"] == 0] == -1)
                                          .all())
    ones = srt.shadow_run_index(torch.ones_like(torus["smask"]), n_tiles, S,
                                n_chunks, 5)
    assert torch.equal(ones, srt.shadow_run_index(None, n_tiles, S, n_chunks,
                                                  5))
    assert torch.equal(ones[0, 0, :11], torch.tensor([0] * 5 + [1] * 5 + [2]))
