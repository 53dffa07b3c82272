"""The port's culled soft raytracer against the JAX package's, on the CPU.

Where JAX culls (several chunks, an image that blocks into its 1,024-pixel
tiles), raytrace_soft runs the masked kernels K10b/K10d/K10h/K10j, here
their plain versions, with keep-masks made on the port's 16 x 16 pixel
tiles. JAX makes its masks on its own swizzled tiles, so the two culled
frames drop different pairs; each pair dropped weighs at most e^-46 of the
background, so the culled frame is held to the brute one at JAX's culled
rule (tests/test_soft_raytrace_cull.py): the image within atol 1e-6 /
rtol 1e-6, the gradients of every leaf within atol 1e-5 after scaling by
the largest entry. Across the two packages the mesh frames, culled or
brute alike, differ by more than that: up to 3.9e-6 on 14 of 12,288 image
entries and ~5e-5 after scaling in the gradients (float32 rounding in
another order, FMA included; ROADMAP fault F15; JAX's own Pallas and jnp
paths differ by 2.3e-6 there). So the port's culled frame is held to
JAX's culled and brute frames, and its gradients to JAX's culled
jax.grad, at the port's cross-package rules of
tests/test_torch_soft_raytrace.py: atol 3e-5 / rtol 1e-5 for the image,
atol 2e-4 after scaling for the gradients. The
mask functions are held to JAX's on JAX's own tiles (tile_p 256 and
1,024), where they are the same function of the same inputs: bit for bit,
the float bounds behind them to an ulp (F4).

The scenes are the procedural torus of core/stl.py at 5 x 7 quads (70
triangles) and 20 x 20 (800), with chunks of 8 for more chunks; JAX's
kernels run in interpret mode, as its own tests run them here.
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
from raytpu.kernels.intersect_pallas import _swizzle
from raytpu.kernels.soft_raster_pallas import _cull_block
from raytpu.render.raytrace import camera_ray_dirs, pixel_grid

from raytpu_torch import convert
from raytpu_torch.core import stl
from raytpu_torch.core.types import RenderConfig
from raytpu_torch.kernels import soft_raytrace as kernels
from raytpu_torch.kernels.intersect import ray_tiles
from raytpu_torch.render.soft import raytrace_soft, raytrace_soft_inputs

CHUNK = 8
CFG = dict(mode="soft", soft_edge_sharpness=40.0, soft_z_sharpness=40.0)
CAM_POS = (0.0123, -0.5, -5.0)
LIGHT_POS = (0.3, -1.5, -3.0)


def leaves(value):
    return {k: np.asarray(v) for k, v in vars(value).items()}


@functools.lru_cache(maxsize=None)
def _mesh(n_major: int, n_minor: int) -> JaxScene:
    """The procedural torus of n_major x n_minor quads as a JAX scene with
    albedo varying along the file."""
    tris = stl.parse_ascii_stl(stl.procedural_stl_text(n_major, n_minor))
    tris = tris * np.float32(-stl.DEFAULT_SCALE)
    colors = np.stack([np.linspace(0.3, 0.9, tris.shape[0])] * 3,
                      axis=1).astype(np.float32)
    colors[:, 1] = colors[::-1, 0]
    return JaxScene(v0=jnp.asarray(tris[:, 0]), v1=jnp.asarray(tris[:, 1]),
                    v2=jnp.asarray(tris[:, 2]), color=jnp.asarray(colors),
                    active=jnp.ones(tris.shape[0], jnp.float32))


def _setup(quads, width: int, height: int, focal: float):
    scene = _mesh(*quads)
    camera = JaxCamera.make(CAM_POS, focal=focal)
    lights = JaxLights.single(capacity=1, position=LIGHT_POS)
    cfg = JaxRenderConfig(width=width, height=height, **CFG)
    return scene, camera, lights, cfg


def _port(scene, camera, lights):
    return (convert.scene_from_numpy(leaves(scene), device="cpu"),
            convert.camera_from_numpy(leaves(camera), device="cpu"),
            convert.lights_from_numpy(leaves(lights), device="cpu"))


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("tile_p,size", [(256, 64), (1024, 128)])
def test_masks_equal_jax_on_jax_tiles(tile_p, size):
    """chunk_cull_bounds, soft_rt_keep_mask and soft_rt_shadow_mask of the
    800-triangle mesh (100 chunks of 8) at 64^2 and 128^2 equal JAX's
    ``_chunk_cull_bounds``, ``soft_rt_keep_mask`` and
    ``soft_rt_shadow_mask`` on JAX's swizzled tiles bit for bit; the
    shadow mask from three sources at hit positions from a numpy seed;
    the float bounds behind them to an ulp (F4)."""
    scene, camera, _, cfg = _setup((20, 20), size, size, 0.6 * size)
    th, tw = _cull_block(tile_p, size, size)
    xs, ys = pixel_grid(cfg)
    dirs = camera_ray_dirs(_swizzle(xs, size, size, th, tw),
                           _swizzle(ys, size, size, th, tw), camera, cfg)
    geom = (scene.v0, scene.v1, scene.v2)
    es, zs = cfg.soft_edge_sharpness, cfg.soft_z_sharpness
    pgeom = tuple(_t(v) for v in geom)

    # The spheres and edges: the same bits but where XLA:CPU contracts the
    # radius's sum of squares into FMAs (ROADMAP fault F4): 1 ulp, on 9 of
    # the 100 radii here.
    want = jax_srt._chunk_cull_bounds(*geom, CHUNK)
    got = kernels.chunk_cull_bounds(*pgeom, CHUNK)
    for g, w, ulps in zip(got, want, (0, 1, 0)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=ulps * 1.2e-7, atol=0)
        np.testing.assert_array_equal(g.numpy() < 0, w < 0)

    want = np.asarray(jax_srt.soft_rt_keep_mask(
        dirs, camera.pos, *geom, es, zs, 0.1, tile_p, CHUNK))
    got = kernels.soft_rt_keep_mask(_t(dirs), _t(camera.pos), *pgeom, es,
                                    zs, kernels.T_NEAR, tile_p, CHUNK)
    assert got.dtype == torch.int32 and got.shape == (size * size // tile_p,
                                                      100)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert 0.0 < want.mean() < 1.0

    rng = np.random.default_rng(3)
    t = rng.uniform(3.5, 6.0, (size * size, 1)).astype(np.float32)
    world = np.asarray(camera.pos)[None, :] + t * np.asarray(dirs) / size
    srcs = rng.uniform(-1.0, 1.0, (3, 3)).astype(np.float32)
    srcs[:, 2] -= 3.0
    want = np.asarray(jax_srt.soft_rt_shadow_mask(
        jnp.asarray(world), jnp.asarray(srcs), *geom, es, zs, tile_p,
        CHUNK))
    got = kernels.soft_rt_shadow_mask(_t(world), _t(srcs), *pgeom, es, zs,
                                      tile_p, CHUNK)
    assert got.shape == (size * size // tile_p, 3, 100)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert 0.0 < want.mean() < 1.0


@pytest.fixture(scope="module")
def frames():
    """JAX's culled and brute frames of the 800-triangle mesh at 64^2 (25
    chunks of 32; JAX's tiles of 256 pixels, as its own cull tests take
    them), and jax.grad of sum(sin(3 img)) through its culled frame, in
    interpret mode."""
    scene, camera, lights, cfg = _setup((20, 20), 64, 64, 40.0)
    run = functools.partial(jax_srt.raytrace_soft_pallas, chunk=32,
                            tile_p=256)
    culled = np.asarray(run(scene, camera, lights, cfg, cull=True))
    brute = np.asarray(run(scene, camera, lights, cfg, cull=False))

    def loss(s, c, li):
        return jnp.sum(jnp.sin(3.0 * run(s, c, li, cfg, cull=True)))

    grads = jax.grad(loss, argnums=(0, 1, 2))(scene, camera, lights)
    return (scene, camera, lights, cfg), culled, brute, grads


def test_culled_frame_matches_brute_and_jax_culled_and_brute(frames):
    """Auto and cull True: within JAX's culled rule of the port's brute
    frame, and within the port's cross-package rule of JAX's culled and
    brute frames."""
    (scene, camera, lights, cfg), culled, brute, _ = frames
    port = _port(scene, camera, lights)
    pcfg = RenderConfig(width=64, height=64, **CFG)
    inp = raytrace_soft_inputs(*port[:2], pcfg)
    assert inp.tiles is not None and inp.mask.shape == (16, 25)
    assert 0 < int(inp.mask.sum()) < inp.mask.numel()  # drops some pairs
    own = raytrace_soft(*port, pcfg, cull=False).numpy()
    for cull in (None, True):
        got = raytrace_soft(*port, pcfg, cull=cull).numpy()
        print(f"cull {cull}: max |port - port brute| "
              f"{np.abs(got - own).max():.3g}, |port - JAX culled| "
              f"{np.abs(got - culled).max():.3g}, |port - JAX brute| "
              f"{np.abs(got - brute).max():.3g}")
        np.testing.assert_allclose(got, own, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got, culled, atol=3e-5, rtol=1e-5)
        np.testing.assert_allclose(got, brute, atol=3e-5, rtol=1e-5)
    # The mesh covers part of the frame, the rest is background.
    assert 0.1 < float((culled.max(axis=-1) > 0.05).mean()) < 0.9


def _grads(scene, camera, lights, cfg, cull: bool, chunk: int):
    """The port's gradients of sum(sin(3 img)) as numpy, by leaf."""
    port = _port(scene, camera, lights)
    for value in port:
        for t in vars(value).values():
            t.requires_grad_(True)
    img = raytrace_soft(*port, cfg, cull=cull, chunk=chunk)
    torch.sin(3.0 * img).sum().backward()
    return img.detach(), [convert.grads_to_numpy(v) for v in port]


def _scaled_error(got, want) -> dict:
    """{leaf: largest |got - want| over want's largest entry}."""
    return {name: float(np.abs(got_v[name] - w).max()
                        / max(np.abs(w).max(), 1e-8))
            for got_v, want_v in zip(got, want)
            for name, w in want_v.items()}


def test_culled_gradients_match_brute_and_jax_culled_grad(frames):
    """Every leaf of scene, camera and lights: the culled gradients within
    atol 1e-5 of the brute ones after scaling (JAX's culled rule), and
    within the port's cross-package rule (atol 2e-4) of JAX's culled
    jax.grad."""
    (scene, camera, lights, cfg), _, _, want = frames
    pcfg = RenderConfig(width=64, height=64, **CFG)
    _, culled = _grads(scene, camera, lights, pcfg, True, 32)
    _, brute = _grads(scene, camera, lights, pcfg, False, 32)
    for v in culled:
        assert all(np.isfinite(g).all() for g in v.values())
    vs_brute = _scaled_error(culled, brute)
    vs_jax = _scaled_error(culled, [leaves(w) for w in want])
    print(f"scaled error, culled vs brute {vs_brute}; vs JAX culled {vs_jax}")
    assert max(vs_brute.values()) <= 1e-5, vs_brute
    assert max(vs_jax.values()) <= 2e-4, vs_jax
    assert np.abs(np.asarray(want[0].v0)).max() > 0.0
    assert np.abs(np.asarray(want[2].position)).max() > 0.0


def _plain_case(quads=(20, 20), size=48, samples=3):
    """Inputs of the plain masked versions: the mesh at size^2 culled on
    the port's tiles, the plain brute forward's hit positions, sources
    from a numpy seed, masks from a numpy seed (about half the bits)."""
    scene, camera, lights, cfg = _setup(quads, size, size, 0.8 * size)
    pscene, pcamera, _ = _port(scene, camera, lights)
    inp = raytrace_soft_inputs(pscene, pcamera,
                               RenderConfig(width=size, height=size, **CFG),
                               cull=False, chunk=CHUNK)
    tiles = ray_tiles(size * size, (size, size), "cpu")
    n_chunks = inp.pri.shape[0] // CHUNK
    rng = np.random.default_rng(5)
    out, _, _ = kernels.primary_agg_reference(inp.pri, pcamera.pos, inp.dirs,
                                              inp.es, inp.zs, CHUNK)
    srcs = torch.tensor(rng.uniform(-1.0, 1.0, (samples, 3)),
                        dtype=torch.float32) + torch.tensor([0.3, -1.5, -3.0])
    mask = torch.tensor(rng.integers(0, 2, (tiles.count, n_chunks)),
                        dtype=torch.int32)
    smask = torch.tensor(rng.integers(0, 2, (tiles.count, samples,
                                             n_chunks)), dtype=torch.int32)
    return dict(inp=inp, cam=pcamera.pos, tiles=tiles, srcs=srcs,
                world=out[3:6].contiguous(), mask=mask, smask=smask)


def test_plain_masked_versions_all_ones_and_all_zero():
    """An all-ones mask gives the unmasked plain versions' bits, forward
    and backward; an all-zero mask gives the background (out 0, m 0, s 1,
    trans 1) and exactly zero gradients."""
    c = _plain_case()
    inp, tiles = c["inp"], c["tiles"]
    R = inp.dirs.shape[1]
    pargs = (inp.pri, c["cam"], inp.dirs, inp.es, inp.zs, CHUNK)
    sargs = (inp.shw, c["srcs"], c["world"], inp.es, inp.zs, CHUNK)
    brute = kernels.primary_agg_reference(*pargs)
    sbrute = kernels.shadow_trans_reference(*sargs)
    cot = torch.tensor(np.random.default_rng(0).uniform(0.5, 1.5, (10, R)),
                       dtype=torch.float32)
    gcot = torch.tensor(np.random.default_rng(1).uniform(
        0.5, 1.5, tuple(sbrute.shape)), dtype=torch.float32)
    bwd = kernels.primary_agg_bwd_reference(*pargs[:3], brute[1], cot,
                                            *pargs[3:])
    sbwd = kernels.shadow_trans_bwd_reference(*sargs[:3], sbrute, gcot,
                                              *sargs[3:])
    for fill in (1, 0):
        mask, smask = c["mask"].fill_(fill), c["smask"].fill_(fill)
        got = kernels.primary_agg_reference(*pargs, mask, tiles)
        sgot = kernels.shadow_trans_reference(*sargs, smask, tiles)
        gb = kernels.primary_agg_bwd_reference(
            *pargs[:3], brute[1], cot, *pargs[3:], mask=mask, tiles=tiles)
        sgb = kernels.shadow_trans_bwd_reference(
            *sargs[:3], sbrute, gcot, *sargs[3:], mask=smask, tiles=tiles)
        if fill:
            for g, w in zip((*got, sgot, *gb, *sgb),
                            (*brute, sbrute, *bwd, *sbwd)):
                assert torch.equal(g, w)
        else:
            assert not got[0].any() and not got[1].any()
            assert torch.equal(got[2], torch.ones(R))
            assert torch.equal(sgot, torch.ones_like(sbrute))
            assert not any(t.any() for t in (*gb, *sgb))
    assert float((brute[1] > 1.0).float().mean()) > 0.05


def test_plain_masked_versions_skip_exactly_the_dropped_pairs():
    """Under a mask from a numpy seed: a tile's rays get what the unmasked
    plain versions give them over the tile's kept chunks alone (a dropped
    chunk leaves the carry as it was), bit for bit; a chunk no tile keeps
    gets exactly zero gradient, and a ray whose tile keeps no chunk
    exactly zero d dirs (d world likewise for the shadow)."""
    c = _plain_case(samples=2)
    inp, tiles, mask, smask = c["inp"], c["tiles"], c["mask"], c["smask"]
    mask[0] = 0              # tile 0 keeps nothing
    mask[:, 3] = 0           # chunk 3 is kept by no tile
    smask[1, 0] = 0          # tile 1 keeps nothing toward source 0
    smask[:, 1, 5] = 0       # chunk 5 is kept by no tile toward source 1
    R = inp.dirs.shape[1]
    pargs = (inp.pri, c["cam"], inp.dirs, inp.es, inp.zs, CHUNK)
    out, m, s = kernels.primary_agg_reference(*pargs, mask, tiles)
    trans = kernels.shadow_trans_reference(inp.shw, c["srcs"], c["world"],
                                           inp.es, inp.zs, CHUNK, smask,
                                           tiles)
    for tile in (2, 5):
        rays = tiles.rays[tile * 256:(tile + 1) * 256]
        kept = [k for k in range(mask.shape[1]) if mask[tile, k]]
        rows = torch.cat([torch.arange(k * CHUNK, (k + 1) * CHUNK)
                          for k in kept])
        want = kernels.primary_agg_reference(
            inp.pri[rows], c["cam"], inp.dirs[:, rays], inp.es, inp.zs,
            CHUNK)
        for g, w in zip((out[:, rays], m[rays], s[rays]), want):
            assert torch.equal(g, w)
        for src in range(2):
            kept = [k for k in range(mask.shape[1]) if smask[tile, src, k]]
            rows = torch.cat([torch.arange(k * CHUNK, (k + 1) * CHUNK)
                              for k in kept])
            want = kernels.shadow_trans_reference(
                inp.shw[rows], c["srcs"][src:src + 1],
                c["world"][:, rays].contiguous(), inp.es, inp.zs, CHUNK)
            assert torch.equal(trans[src, rays], want[0])
    cot = torch.tensor(np.random.default_rng(0).uniform(0.5, 1.5, (10, R)),
                       dtype=torch.float32)
    dc, dcam, dd = kernels.primary_agg_bwd_reference(
        *pargs[:3], m, cot, *pargs[3:], mask=mask, tiles=tiles)
    gcot = torch.ones_like(trans)
    sdc, dsrc, dw = kernels.shadow_trans_bwd_reference(
        inp.shw, c["srcs"], c["world"], trans, gcot, inp.es, inp.zs, CHUNK,
        mask=smask, tiles=tiles)
    tile0 = tiles.tile == 0
    assert not dc[3 * CHUNK:4 * CHUNK].any() and dc.any()
    assert not dd[:, tile0].any() and dd[:, ~tile0].any()
    assert out[:, tile0].abs().max() == 0.0 and bool((s[tile0] == 1).all())
    assert bool((trans[0, tiles.tile == 1] == 1.0).all())
    # d world from source 1 alone on tile 1; chunk 5 from source 0 alone.
    only1 = kernels.shadow_trans_bwd_reference(
        inp.shw, c["srcs"][1:], c["world"], trans[1:], gcot[1:], inp.es,
        inp.zs, CHUNK, mask=smask[:, 1:].contiguous(), tiles=tiles)[2]
    tile1 = tiles.tile == 1
    assert torch.equal(dw[:, tile1], only1[:, tile1])
    only0 = kernels.shadow_trans_bwd_reference(
        inp.shw, c["srcs"][:1], c["world"], trans[:1], gcot[:1], inp.es,
        inp.zs, CHUNK, mask=smask[:, :1].contiguous(), tiles=tiles)[0]
    assert torch.equal(sdc[5 * CHUNK:6 * CHUNK], only0[5 * CHUNK:6 * CHUNK])
    assert bool(torch.isfinite(dsrc).all()) and bool(dsrc.any())
    assert bool(torch.isfinite(dcam).all())


def test_padded_tiles_culled_gradients_equal_brute():
    """W = 40, H = 128 on the 70-triangle mesh (JAX culls it in 8 x 128
    blocks; the port's 16 x 16 tiles overhang the right edge by 8 columns;
    sharpness 200 and a wide view, so that half the pairs drop): the culled
    frame and its gradients equal the brute ones at JAX's rule, no ray
    counted twice."""
    scene, camera, lights, _ = _setup((5, 7), 40, 128, 16.0)
    pcfg = RenderConfig(width=40, height=128, mode="soft",
                        soft_edge_sharpness=200.0, soft_z_sharpness=200.0)
    port = _port(scene, camera, lights)
    inp = raytrace_soft_inputs(*port[:2], pcfg, chunk=CHUNK)
    assert inp.tiles.count == 24 and 0 < int(inp.mask.sum()) < 24 * 9 * 0.7
    culled, gc = _grads(scene, camera, lights, pcfg, True, CHUNK)
    brute, gb = _grads(scene, camera, lights, pcfg, False, CHUNK)
    np.testing.assert_allclose(culled.numpy(), brute.numpy(), atol=1e-6,
                               rtol=1e-6)
    assert float(brute.max()) > 0.2
    err = _scaled_error(gc, gb)
    assert max(err.values()) <= 1e-5, err


def test_culled_frame_keeps_the_callers_tf32_setting():
    """The frame's library products run in full float32 and leave
    torch.backends.cuda.matmul.allow_tf32 as the caller set it."""
    scene, camera, lights, _ = _setup((5, 7), 32, 32, 20.0)
    port = _port(scene, camera, lights)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            raytrace_soft(*port, RenderConfig(width=32, height=32, **CFG),
                          cull=True, chunk=CHUNK)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
