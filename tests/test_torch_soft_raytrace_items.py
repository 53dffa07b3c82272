"""K10c's and K10d's work items and the masked primary backward they
compute, on the CPU.

The redesigned fused primary backward (csrc/soft_raytrace.cu, "K10c and
K10d, redesigned") cuts each tile's kept chunks into runs of PRI_RUN, a
work item each, from a plan made on the card; primary_bwd_items is that
plan's plain model. Its kernels cannot run here: the card tests
(tests/test_torch_gpu.py) hold them to the plain masked backward, which is
held here to the JAX package's fused masked backward (``_pri_bwd_impl``
with a mask, Pallas in interpret mode) on a mask whose kept chunks crowd
into one tile, at the JAX tests' rule (rtol 1e-4 / atol 1e-5 after scaling
each column group by its largest entry).
"""

import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.kernels import soft_raytrace_pallas as jax_srt

from raytpu_torch.core.stl import load_stl, procedural_stl_text
from raytpu_torch.core.types import Camera, RenderConfig
from raytpu_torch.kernels import soft_raytrace as kernels
from raytpu_torch.kernels.intersect import ray_tiles
from raytpu_torch.render.soft import raytrace_soft_inputs

SIZE = 32        # 1,024 rays: four tiles of 256 consecutive rays
TILE_P = 256     # JAX's tile: the same 256 rays
CHUNK = 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops: one intra-op thread, so that the suite's workers do
    not oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _masks(n_tiles, n_chunks, seed):
    """A crowded mask (tile 0 keeps every chunk, the others about a
    quarter), a thin one (at most one chunk a tile) and the all-ones,
    all-zero and None masks."""
    rng = np.random.default_rng(seed)
    crowded = (rng.uniform(size=(n_tiles, n_chunks)) < 0.25).astype(np.int32)
    crowded[0] = 1
    thin = np.zeros((n_tiles, n_chunks), np.int32)
    thin[np.arange(n_tiles), rng.integers(0, n_chunks, n_tiles)] = 1
    thin[rng.uniform(size=n_tiles) < 0.3] = 0
    return {"crowded": crowded, "thin": thin,
            "ones": np.ones((n_tiles, n_chunks), np.int32),
            "zeros": np.zeros((n_tiles, n_chunks), np.int32), "none": None}


@pytest.mark.parametrize("run", [3, kernels.PRI_RUN])
@pytest.mark.parametrize("name", ["crowded", "thin", "ones", "zeros", "none"])
def test_primary_bwd_items_cover_each_kept_pair_once(name, run):
    """Every kept (tile, chunk) pair lands in exactly one item; the items
    run in (tile, run) order, each a run of at most ``run`` of its tile's
    kept chunks in chunk order, every run but a tile's last full; the
    all-ones mask and no mask give the same items, every tile's, as many
    as pri_items counts."""
    n_tiles, n_chunks = 12, 37
    mask = _masks(n_tiles, n_chunks, 3)[name]
    items = kernels.primary_bwd_items(
        None if mask is None else torch.tensor(mask), n_tiles, n_chunks, run)
    kept = np.ones((n_tiles, n_chunks), bool) if mask is None else mask != 0
    seen = np.zeros((n_tiles, n_chunks), np.int64)
    for (t, chunks), nxt in zip(items, items[1:] + [(n_tiles, [])]):
        assert 1 <= len(chunks) <= run and chunks == sorted(chunks)
        assert t <= nxt[0]
        if nxt[0] == t:  # a run followed by its tile's next run is full
            assert len(chunks) == run and chunks[-1] < nxt[1][0]
        seen[t, chunks] += 1
    assert (seen == kept).all()
    if name in ("ones", "none"):
        assert len(items) == n_tiles * -(-n_chunks // run)
        assert sorted({t for t, _ in items}) == list(range(n_tiles))
        other = kernels.primary_bwd_items(
            None if mask is not None else torch.ones(n_tiles, n_chunks),
            n_tiles, n_chunks, run)
        assert other == items
    if name == "zeros":
        assert items == []


def test_pri_blocks_caps():
    """K10c's and K10d's grid: at most the items, at most what the card
    holds at once, and PARTIAL_BYTES of (Tp, 18) partials."""
    assert kernels.pri_items(1024, 1) == 1024
    assert kernels.pri_items(1024, 288) == 1024 * 18
    assert kernels.pri_blocks(32, kernels.pri_items(1024, 1), 264) == 264
    assert kernels.pri_blocks(32, kernels.pri_items(1, 1), 264) == 1
    assert kernels.pri_blocks(9216, kernels.pri_items(1024, 288), 264) == 264
    assert kernels.pri_blocks(32768, kernels.pri_items(1024, 1024),
                              10 ** 6) == (1 << 30) // (32768 * 18 * 4)


@pytest.fixture(scope="module")
def crowded_case():
    """The 800-triangle torus (100 chunks of 8) at 32^2 from the STL
    camera, tiles of 256 consecutive rays (JAX's tile_p 256), a crowded
    mask (tile 0 keeps every chunk, tile 1 a seeded fifth, tiles 2 and 3
    none), the plain masked forward's saved max and numpy cotangents; and
    JAX's fused masked backward on them."""
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/torus.stl"
        with open(path, "w") as f:
            f.write(procedural_stl_text(20, 20))
        scene = load_stl(path, device="cpu")
    camera = Camera.make((0.0, -0.5, -5.0), focal=SIZE * 0.6, device="cpu")
    cfg = RenderConfig(width=SIZE, height=SIZE, mode="soft",
                       soft_edge_sharpness=40.0, soft_z_sharpness=40.0)
    inp = raytrace_soft_inputs(scene, camera, cfg, cull=False, chunk=CHUNK)
    R, n_chunks = inp.dirs.shape[1], inp.pri.shape[0] // CHUNK
    tiles = ray_tiles(R, None, "cpu")
    rng = np.random.default_rng(11)
    mask = np.zeros((tiles.count, n_chunks), np.int32)
    mask[0] = 1
    mask[1] = rng.uniform(size=n_chunks) < 0.2
    mask = torch.tensor(mask)
    cam = camera.pos.contiguous()
    with torch.no_grad():
        _, m, _ = kernels.primary_agg_reference(inp.pri, cam, inp.dirs,
                                                inp.es, inp.zs, CHUNK, mask,
                                                tiles)
    cot = torch.tensor(rng.normal(size=(10, R)).astype(np.float32))
    glob = jnp.asarray(np.concatenate([cam.numpy(),
                                       np.zeros(13, np.float32)])[None])
    dc, dg, _, dd = jax_srt._pri_bwd_impl(
        jnp.asarray(inp.pri.numpy()), glob, jnp.zeros((1, 8), jnp.float32),
        jnp.asarray(inp.dirs.numpy()), jnp.asarray(mask.numpy()),
        jnp.asarray(m.numpy()[None]), jnp.asarray(cot.numpy()), inp.es,
        inp.zs, 0.2, 1, kernels.T_NEAR, TILE_P, CHUNK, interpret=True)
    return dict(inp=inp, cam=cam, tiles=tiles, mask=mask, m=m, cot=cot,
                dc=np.asarray(dc), dg=np.asarray(dg)[0, :3],
                dd=np.asarray(dd))


def _within(got, want, groups, rtol=1e-4, atol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    for name, lo, hi in groups:
        w, g = want[..., lo:hi], got[..., lo:hi]
        scale = max(np.abs(w).max(), 1e-12)
        assert (np.abs(g - w) <= atol * scale + rtol * np.abs(w)).all(), \
            (name, np.abs(g - w).max() / scale)


def test_masked_plain_backward_matches_jax_on_crowded_tiles(crowded_case):
    """The plain masked backward (K10d's plain version) on the crowded
    mask against JAX's fused masked backward: d consts by column group, d
    camera and d dirs at rtol 1e-4 / atol 1e-5 after scaling; the chunks no
    tile keeps get exactly 0 on both sides, and the rays of the tiles that
    keep nothing exactly 0 d dirs."""
    c = crowded_case
    inp = c["inp"]
    dc, dcam, dd = kernels.primary_agg_bwd_reference(
        inp.pri, c["cam"], inp.dirs, c["m"], c["cot"], inp.es, inp.zs,
        CHUNK, mask=c["mask"], tiles=c["tiles"])
    assert int(c["mask"][0].sum()) == c["mask"].shape[1]
    assert np.abs(c["dc"]).max() > 0 and np.abs(c["dd"]).max() > 0
    _within(dc.numpy(), c["dc"], kernels.PRI_GROUPS)
    _within(dcam.numpy()[None], c["dg"][None], (("camera", 0, 3),))
    _within(dd.numpy().T, c["dd"].T, (("dirs", 0, 3),))
    dropped = (c["mask"].amax(dim=0) == 0).numpy()
    if dropped.any():
        rows = np.repeat(dropped, CHUNK)
        assert not dc.numpy()[rows].any() and not c["dc"][rows].any()
    assert not dd[:, 2 * TILE_P:].any() and not c["dd"][:, 2 * TILE_P:].any()
