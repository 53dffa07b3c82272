"""The soft raytracer's two-launch backward route against the JAX
package's, on the CPU.

Above ``_FUSED_BWD_MAX_ROWS`` 16-column rows (a 32-column primary table of
more than 32,768 rows, a shadow table of more than 65,536) JAX's backwards
take two launches, K10e + K10f (``_pri_bwd_tables_kernel``,
``_pri_bwd_dirs_kernel``) and K10k + K10l (``_shw_bwd_consts_kernel``,
``_shw_bwd_rays_kernel``), and that route takes no keep-mask. The port
routes on the same predicates (kernels/soft_raytrace.py::pri_two_launch,
shw_two_launch); here its wrappers run the four kernels' plain versions.

No scene this small reaches the limit, so the tests move it: the port's
FUSED_BWD_MAX_ROWS and JAX's ``_FUSED_BWD_MAX_ROWS`` both, with
``jax.clear_caches()`` on entry and after the constant is restored (JAX
otherwise reuses the route it traced before the patch), and JAX's kernel
functions wrapped to record which of them it traced. The scene is the
70-triangle procedural torus (5 x 7 quads, chunks of 8: 72 rows, 9 chunks)
at 32^2 with two shadow sources; JAX's kernels run in interpret mode, as
its own tests run them here. The halves are held to JAX's at rtol 1e-4 /
atol 1e-5 after scaling each column group by its own largest entry; the
frames at the port's cross-package rules (tests/test_torch_soft_raytrace.py
and, for the mesh, tests/test_torch_soft_raytrace_cull.py: the image within
atol 3e-5 / rtol 1e-5, every leaf's gradient within atol 2e-4 after scaling
by its largest entry).

The port's frame is culled; JAX's is its brute frame at both limits and,
where both backwards are two-launch, its culled frame too: a masked forward
on JAX's own tiles and the unmasked two-launch backward.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.core.types import Camera as JaxCamera
from raytpu.core.types import Lights as JaxLights
from raytpu.core.types import RenderConfig as JaxRenderConfig
from raytpu.core.types import Scene as JaxScene
from raytpu.kernels import soft_raytrace_pallas as jax_srt

from raytpu_torch import convert
from raytpu_torch.core import stl
from raytpu_torch.core.types import RenderConfig
from raytpu_torch.kernels import soft_raytrace as kernels
from raytpu_torch.kernels.intersect import ray_tiles
from raytpu_torch.render.soft import raytrace_soft, raytrace_soft_inputs

CHUNK = 8
SIZE = 32
R = SIZE * SIZE
TILE_P = 256
ES, ZS = 40.0, 40.0
CFG = dict(width=SIZE, height=SIZE, mode="soft", soft_edge_sharpness=ES,
           soft_z_sharpness=ZS, soft_shadow_samples=2)
# Both passes two-launch at 72 rows (72 * 32 > 32 * 16, 72 > 32); at 128
# the primary (72 * 32 > 128 * 16) and not the shadow (72 <= 128).
BOTH, PRIMARY_ONLY = 32, 128
SRCS = np.array([[0.3, -1.5, -3.0], [0.25, -1.45, -3.1]], np.float32)
TWO_LAUNCH = ("_pri_bwd_tables_kernel", "_pri_bwd_dirs_kernel",
              "_shw_bwd_consts_kernel", "_shw_bwd_rays_kernel")
FUSED = ("_pri_bwd_fused_kernel", "_pri_bwd_fused_kernel_masked",
         "_shw_bwd_fused_kernel", "_shw_bwd_fused_kernel_masked")


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


def _t(a):
    return torch.tensor(np.asarray(a))


def within_groups(got, want, groups, rtol=1e-4, atol=1e-5):
    """The JAX tests' rule after scaling each column group by its own
    largest entry: {group: largest scaled |got - want|}; asserts the
    rule."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    errs = {}
    for name, lo, hi in groups:
        w, g = want[..., lo:hi], got[..., lo:hi]
        scale = max(np.abs(w).max(), 1e-12)
        errs[name] = np.abs(g - w).max() / scale
        assert (np.abs(g - w) <= atol * scale + rtol * np.abs(w)).all(), \
            (name, errs[name])
    return errs


def _setup():
    """The 70-triangle torus (albedo varying along the file), the camera 5
    units off, one light of two soft-shadow samples, 32^2."""
    tris = stl.parse_ascii_stl(stl.procedural_stl_text(5, 7))
    tris = tris * np.float32(-stl.DEFAULT_SCALE)
    colors = np.stack([np.linspace(0.3, 0.9, tris.shape[0])] * 3,
                      axis=1).astype(np.float32)
    colors[:, 1] = colors[::-1, 0]
    scene = JaxScene(v0=jnp.asarray(tris[:, 0]), v1=jnp.asarray(tris[:, 1]),
                     v2=jnp.asarray(tris[:, 2]), color=jnp.asarray(colors),
                     active=jnp.ones(tris.shape[0], jnp.float32))
    return (scene, JaxCamera.make((0.0123, -0.5, -5.0), focal=20.0),
            JaxLights.single(capacity=1, soft_samples=2,
                             position=(0.3, -1.5, -3.0)),
            JaxRenderConfig(**CFG))


def _port(scene, camera, lights):
    return (convert.scene_from_numpy(leaves(scene), device="cpu"),
            convert.camera_from_numpy(leaves(camera), device="cpu"),
            convert.lights_from_numpy(leaves(lights), device="cpu"))


def _jax_at(rows: int, fn):
    """fn() with JAX's fused limit at ``rows``, caches cleared on entry and
    after the limit is restored; returns (fn's result, the backward kernel
    functions JAX traced)."""
    traced = []

    def spy(name):
        real = getattr(jax_srt, name)

        def kernel(*args, **kw):
            traced.append(name)
            return real(*args, **kw)
        return kernel

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_srt, "_FUSED_BWD_MAX_ROWS", rows)
        for name in TWO_LAUNCH + FUSED:
            mp.setattr(jax_srt, name, spy(name))
        jax.clear_caches()
        try:
            return fn(), set(traced)
        finally:
            mp.undo()
            jax.clear_caches()


def _port_inputs():
    """The port's unmasked tables, rays and plain forward on the torus: m
    (R,), the aggregated hit positions (3, R) and the transmittance from
    SRCS (2, R)."""
    scene, camera, lights, _ = _setup()
    pscene, pcamera, _ = _port(scene, camera, lights)
    with torch.no_grad():
        inp = raytrace_soft_inputs(pscene, pcamera, RenderConfig(**CFG),
                                   cull=False, chunk=CHUNK)
        out, m, _ = kernels.primary_agg_reference(inp.pri, pcamera.pos,
                                                  inp.dirs, ES, ZS, CHUNK)
        world = out[3:6].contiguous()
        trans = kernels.shadow_trans_reference(inp.shw, _t(SRCS), world, ES,
                                               ZS, CHUNK)
    return dict(pri=inp.pri, shw=inp.shw, dirs=inp.dirs, cam=pcamera.pos,
                m=m, world=world, trans=trans)


@pytest.fixture(scope="module")
def jax_runs():
    """Everything JAX computes here, sharing its compiles: the brute
    frame's VJP (forward once), applied to sum(sin(3 img))'s cotangent at
    both limits; at BOTH also the culled frame's VJP, its two-launch halves on the port's tables,
    rays and plain forward (``_pri_bwd_impl``, ``_shadow_bwd``) on
    cotangents from a numpy seed, and the VJP of ``_primary_agg_stats``
    with a nonzero cotangent of s."""
    scene, camera, lights, cfg = _setup()
    p = _port_inputs()
    rng = np.random.default_rng(0)
    cot = rng.normal(size=(10, R)).astype(np.float32)
    gcot = rng.normal(size=(2, R)).astype(np.float32)
    g_out = rng.normal(size=(9, R)).astype(np.float32)
    g_s = rng.normal(size=R).astype(np.float32)
    pri, shw, dirs = (jnp.asarray(p[k].numpy()) for k in ("pri", "shw",
                                                          "dirs"))
    glob = jnp.concatenate([camera.pos, jnp.zeros((13,), jnp.float32)])[None]
    lt = jnp.zeros((1, 8), jnp.float32)
    srcs8 = jnp.asarray(np.concatenate([SRCS, np.zeros((2, 5), np.float32)],
                                       1))
    run = functools.partial(jax_srt.raytrace_soft_pallas, chunk=CHUNK,
                            tile_p=TILE_P, cull=False)
    frame = {}

    def at_both():
        img, vjp = jax.vjp(lambda s, c, li: run(s, c, li, cfg), scene, camera,
                           lights)
        frame.update(img=np.asarray(img), vjp=vjp,
                     cot=3.0 * jnp.cos(3.0 * img))
        grads = vjp(frame["cot"])
        cimg, cvjp = jax.vjp(lambda s, c, li: run(s, c, li, cfg, cull=True),
                             scene, camera, lights)
        frame.update(culled_img=np.asarray(cimg),
                     culled=cvjp(3.0 * jnp.cos(3.0 * cimg)))
        halves = [np.asarray(a) for a in (
            *jax_srt._pri_bwd_impl(
                pri, glob, lt, dirs, None, jnp.asarray(p["m"].numpy()[None]),
                jnp.asarray(cot), ES, ZS, 0.2, 1, kernels.T_NEAR, TILE_P,
                CHUNK, interpret=True),
            *jax_srt._shadow_bwd(
                ES, ZS, TILE_P, CHUNK, True,
                (shw, srcs8, jnp.asarray(p["world"].numpy()), None,
                 jnp.asarray(p["trans"].numpy())), jnp.asarray(gcot))[:3])]

        def stats(c, gl, d):
            return jax_srt._primary_agg_stats(
                c, gl, lt, d, None, ES, ZS, 0.2, 1, kernels.T_NEAR, TILE_P,
                CHUNK, True)

        outs, svjp = jax.vjp(stats, pri, glob, dirs)
        stat = [np.asarray(a) for a in (*outs, *svjp((
            jnp.asarray(g_out), jnp.zeros((1, R), jnp.float32),
            jnp.asarray(g_s[None]))))]
        return grads, halves, stat

    (grads32, halves, stat), traced32 = _jax_at(BOTH, at_both)
    grads128, traced128 = _jax_at(PRIMARY_ONLY,
                                  lambda: frame["vjp"](frame["cot"]))
    return dict(port=p, cot=cot, gcot=gcot, g_out=g_out, g_s=g_s,
                img=frame["img"], culled_img=frame["culled_img"],
                grads={BOTH: grads32, PRIMARY_ONLY: grads128,
                       "culled": frame["culled"]},
                traced={BOTH: traced32, PRIMARY_ONLY: traced128},
                halves=halves, stats=stat)


@pytest.fixture
def port_limit(monkeypatch):
    """Sets the port's fused limit for the test."""
    return functools.partial(monkeypatch.setattr, kernels,
                             "FUSED_BWD_MAX_ROWS")


def test_limit_and_predicates_match_jax():
    """The port's limit and table widths are JAX's, and its predicates
    JAX's conditions (``_pri_bwd_impl``: Tp * 32 > limit * 16;
    ``_shadow_bwd``: Tp > limit), by arithmetic alone."""
    assert kernels.FUSED_BWD_MAX_ROWS == jax_srt._FUSED_BWD_MAX_ROWS == 65536
    assert (kernels.PRI_COLS, kernels.SHW_COLS) == (jax_srt._PRI_COLS,
                                                    jax_srt._SHW_COLS)
    for Tp, pri, shw in ((32768, False, False), (32800, True, False),
                         (65536, True, False), (65568, True, True),
                         (66560, True, True), (36000, True, False)):
        assert kernels.pri_two_launch(Tp) is pri, Tp
        assert kernels.shw_two_launch(Tp) is shw, Tp
        assert pri == (Tp * jax_srt._PRI_COLS
                       > jax_srt._FUSED_BWD_MAX_ROWS * 16)
        assert shw == (Tp > jax_srt._FUSED_BWD_MAX_ROWS)


def test_plain_halves_match_jax_two_launch(jax_runs, port_limit):
    """The unmasked primary_agg_bwd_reference and
    shadow_trans_bwd_reference (the plain versions of K10e + K10f and of
    K10k + K10l) against JAX's two-launch outputs by column group, and the
    four halves' wrappers and the two-launch route (on the CPU: these plain
    versions, no launch) giving the same bits."""
    p = jax_runs["port"]
    dc_w, dg_w, dl_w, dd_w, sdc_w, sdsrc_w, sdw_w = jax_runs["halves"]
    pargs = (p["pri"], p["cam"], p["dirs"], p["m"], _t(jax_runs["cot"]), ES,
             ZS, CHUNK)
    dc, dcam, dd = kernels.primary_agg_bwd_reference(*pargs)
    errs = within_groups(dc.numpy(), dc_w, kernels.PRI_GROUPS)
    errs.update(within_groups(dcam.numpy()[None], dg_w[:, :3],
                              (("camera", 0, 3),)))
    errs.update(within_groups(dd.numpy().T, dd_w.T, (("dirs", 0, 3),)))
    # F3: the lights table's and globals 3-15's gradients are exactly 0.
    assert not dl_w.any() and not dg_w[:, 3:].any()
    sargs = (p["shw"], _t(SRCS), p["world"], p["trans"],
             _t(jax_runs["gcot"]), ES, ZS, CHUNK)
    sdc, dsrc, dw = kernels.shadow_trans_bwd_reference(*sargs)
    errs.update(within_groups(sdc.numpy(), sdc_w, kernels.SHW_GROUPS))
    errs.update(within_groups(dsrc.numpy(), sdsrc_w[:, :3],
                              (("sources", 0, 3),)))
    errs.update(within_groups(dw.numpy().T, sdw_w.T, (("world", 0, 3),)))
    print(errs)
    assert not dc[:, kernels.PRI_USED:].any()
    assert not sdc[:, kernels.SHW_USED:].any()
    assert np.abs(dc_w).max() > 0 and np.abs(sdc_w).max() > 0
    port_limit(BOTH)
    counts = [getattr(kernels, f"LAUNCHES_SRT_{k}") for k in (
        "PRI_BWD_TABLES", "PRI_BWD_DIRS", "SHW_BWD_CONSTS", "SHW_BWD_RAYS")]
    for got in ((*kernels.primary_agg_bwd(*pargs),
                 *kernels.shadow_trans_bwd(*sargs)),
                (*kernels.primary_bwd_tables(*pargs),
                 kernels.primary_bwd_dirs(*pargs),
                 kernels.shadow_bwd_consts(*sargs),
                 *kernels.shadow_bwd_rays(*sargs))):
        for g, w in zip(got, (dc, dcam, dd, sdc, dsrc, dw), strict=True):
            assert torch.equal(g, w)
    assert [getattr(kernels, f"LAUNCHES_SRT_{k}") for k in (
        "PRI_BWD_TABLES", "PRI_BWD_DIRS", "SHW_BWD_CONSTS",
        "SHW_BWD_RAYS")] == counts


@pytest.mark.parametrize("rows,jax_cull", [(BOTH, False),
                                           (PRIMARY_ONLY, False),
                                           (BOTH, True)],
                         ids=["both-two-launch", "primary-two-launch",
                              "both-two-launch-jax-culled"])
def test_frame_gradients_match_jax_forced_grad(jax_runs, port_limit, rows,
                                               jax_cull):
    """raytrace_soft's culled frame and every leaf's gradient of
    sum(sin(3 img)) against JAX's brute frame (jax_cull: its culled one),
    both limits at ``rows``: the two-launch backward for both passes, or
    for the primary pass beside the shadow's fused backward (the port's
    masked K10j, JAX's unmasked K10i). JAX traced exactly the kernels of
    that route."""
    want_kernels = {BOTH: set(TWO_LAUNCH),
                    PRIMARY_ONLY: {*TWO_LAUNCH[:2], "_shw_bwd_fused_kernel"}}
    assert jax_runs["traced"][rows] == want_kernels[rows]
    scene, camera, lights, _ = _setup()
    port = _port(scene, camera, lights)
    for value in port:
        for t in vars(value).values():
            t.requires_grad_(True)
    port_limit(rows)
    cfg = RenderConfig(**CFG)
    assert raytrace_soft_inputs(*port[:2], cfg, chunk=CHUNK).tiles is not None
    img = raytrace_soft(*port, cfg, cull=True, chunk=CHUNK)
    torch.sin(3.0 * img).sum().backward()
    key = "culled" if jax_cull else rows
    np.testing.assert_allclose(img.detach().numpy(),
                               jax_runs["culled_img" if jax_cull else "img"],
                               atol=3e-5, rtol=1e-5)
    errs = {}
    for got, want in zip(port, jax_runs["grads"][key]):
        got = convert.grads_to_numpy(got)
        for name, a in leaves(want).items():
            assert np.isfinite(got[name]).all(), name
            scale = max(np.abs(a).max(), 1e-8)
            errs[name] = float(np.abs(got[name] - a).max() / scale)
            np.testing.assert_allclose(got[name] / scale, a / scale,
                                       atol=2e-4, err_msg=name)
    print(key, errs)
    want = jax_runs["grads"][key]
    assert np.abs(np.asarray(want[0].v0)).max() > 0.0
    assert np.abs(np.asarray(want[2].jitter)).max() > 0.0


def test_primary_agg_stats_vjp_matches_jax(jax_runs, port_limit):
    """PrimaryAggStats' backward (the sharded step's) on the two-launch
    route, with a nonzero cotangent of s, against the VJP of JAX's
    ``_primary_agg_stats`` (m's cotangent dropped in both); without g_s
    the gradient differs."""
    p = jax_runs["port"]
    out_w, _, s_w, dc_w, dg_w, dd_w = jax_runs["stats"]
    port_limit(BOTH)
    pri, cam, dirs = (p[k].clone().requires_grad_(True)
                      for k in ("pri", "cam", "dirs"))
    out, _, s = kernels.PrimaryAggStats.apply(pri, cam, dirs, ES, ZS, CHUNK)
    # The mesh's cross-package rule (F15: ulps at triangle edges).
    np.testing.assert_allclose(out.detach().numpy(), out_w, rtol=1e-5,
                               atol=3e-5)
    np.testing.assert_allclose(s.detach().numpy(), s_w[0], rtol=1e-5,
                               atol=3e-5)
    g_out, g_s = _t(jax_runs["g_out"]), _t(jax_runs["g_s"])
    torch.autograd.backward((out, s), (g_out, g_s))
    errs = within_groups(pri.grad.numpy(), dc_w, kernels.PRI_GROUPS)
    errs.update(within_groups(cam.grad.numpy()[None], dg_w[:, :3],
                              (("camera", 0, 3),)))
    errs.update(within_groups(dirs.grad.numpy().T, dd_w.T,
                              (("dirs", 0, 3),)))
    print(errs)
    pri.grad = None
    out, _, _ = kernels.PrimaryAggStats.apply(pri, cam, dirs, ES, ZS, CHUNK)
    torch.autograd.backward((out,), (g_out,))
    assert not np.allclose(pri.grad.numpy(), dc_w, rtol=1e-3, atol=1e-3)


def test_two_launch_route_ignores_the_mask(port_limit):
    """Above the limit the backward with a keep-mask equals the backward
    without one, bit for bit, as JAX's two-launch route ignores its mask;
    at JAX's own limit (the fused masked route) the same mask, which drops
    pairs, changes both backwards."""
    p = _port_inputs()
    tiles = ray_tiles(R, (SIZE, SIZE), "cpu")
    n_chunks = p["pri"].shape[0] // CHUNK
    rng = np.random.default_rng(5)
    mask = torch.tensor(rng.integers(0, 2, (tiles.count, n_chunks)),
                        dtype=torch.int32)
    smask = torch.tensor(rng.integers(0, 2, (tiles.count, 2, n_chunks)),
                         dtype=torch.int32)
    cot = torch.tensor(rng.uniform(0.5, 1.5, (10, R)), dtype=torch.float32)
    gcot = torch.tensor(rng.uniform(0.5, 1.5, (2, R)), dtype=torch.float32)
    pargs = (p["pri"], p["cam"], p["dirs"], p["m"], cot, ES, ZS, CHUNK)
    sargs = (p["shw"], _t(SRCS), p["world"], p["trans"], gcot, ES, ZS,
             CHUNK)

    def both(with_mask: bool):
        pm = dict(mask=mask, tiles=tiles) if with_mask else {}
        sm = dict(mask=smask, tiles=tiles) if with_mask else {}
        return (*kernels.primary_agg_bwd(*pargs, **pm),
                *kernels.shadow_trans_bwd(*sargs, **sm))

    port_limit(BOTH)
    assert kernels.pri_two_launch(p["pri"].shape[0])
    assert kernels.shw_two_launch(p["shw"].shape[0])
    for g, w in zip(both(True), both(False)):
        assert torch.equal(g, w)
    port_limit(jax_srt._FUSED_BWD_MAX_ROWS)
    fused_masked, fused = both(True), both(False)
    for part in (0, 2, 3, 5):  # d consts and the rays' gradient, each pass
        assert not torch.equal(fused_masked[part], fused[part]), part
