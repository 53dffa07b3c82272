"""K10a's and K10b's work items, their merge and their dead-pair test
against the running carry, on the CPU.

The redesigned primary forward (csrc/soft_raytrace.cu, "K10a and K10b,
redesigned") cuts each tile's kept chunks into runs of primary_fwd_run
chunks, a work item each, skips the pairs it proves of weight exactly 0
against the carry of the item, and folds a tile's items in run order.
Its kernels cannot run here: the card tests (tests/test_torch_gpu.py) hold
them to the plain version. Here the plain models are held to the plain
version and to the JAX package: primary_fwd_items (the plan),
primary_fwd_walk (the test at the running carry, which must mark no pair
of a weight not 0), primary_agg_items (the items and their merge: within
rtol 1e-5 / atol 1e-6 of primary_agg_reference, m bit for bit), and the
plain masked forward against JAX's masked forward (``_primary_fwd_impl``
with a mask, Pallas in interpret mode) on a mask whose kept chunks crowd
into one tile.
"""

import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytpu.kernels import soft_raytrace_pallas as jax_srt

from raytpu_torch.core.cornell import cornell_box
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


@pytest.mark.parametrize("R", [SIZE * SIZE, 512 * 512])
@pytest.mark.parametrize("name", ["crowded", "thin", "ones", "zeros", "none"])
def test_primary_fwd_items_cover_each_kept_chunk_once(name, R):
    """Every kept (tile, chunk) pair lands in exactly one item; the items
    run in (tile, run) order, each a run of at most the rule's run of its
    tile's kept chunks in chunk order, every run but a tile's last full;
    the all-ones mask and no mask give the same run and items; the items
    stay within the kernels' bound n_tiles min(splits + 1, ceil(n_chunks /
    PRI_FWD_RUN_MIN))."""
    n_tiles, n_chunks = 12, 37
    mask = _masks(n_tiles, n_chunks, 3)[name]
    run, items = kernels.primary_fwd_items(
        None if mask is None else torch.tensor(mask), n_tiles, n_chunks, R)
    kept = np.ones((n_tiles, n_chunks), bool) if mask is None else mask != 0
    assert run == kernels.primary_fwd_run(int(kept.sum()), n_tiles, R)
    seen = np.zeros((n_tiles, n_chunks), np.int64)
    for (t, chunks), nxt in zip(items, items[1:] + [(n_tiles, [])]):
        assert 1 <= len(chunks) <= run and chunks == sorted(chunks)
        assert t <= nxt[0]
        if nxt[0] == t:  # a run followed by its tile's next run is full
            assert len(chunks) == run and chunks[-1] < nxt[1][0]
        seen[t, chunks] += 1
    assert (seen == kept).all()
    splits = -(-kernels.PRI_FWD_ITEMS // -(-R // kernels.THREADS))
    assert len(items) <= n_tiles * min(
        splits + 1, -(-n_chunks // kernels.PRI_FWD_RUN_MIN))
    if name in ("ones", "none"):
        assert len(items) == n_tiles * -(-n_chunks // run)
        other = kernels.primary_fwd_items(
            None if mask is not None else torch.ones(n_tiles, n_chunks),
            n_tiles, n_chunks, R)
        assert other == (run, items)
    if name == "zeros":
        assert items == []


def test_primary_fwd_run_rule():
    """The run at the main path's shapes: one chunk stays one item a tile
    (the Cornell frames); at 512^2 a full tile stays whole (the brute mesh,
    288 chunks) and a tile keeping more than the mean is cut; a frame of
    few tiles is cut finer (phase 32's 128^2 on 2,080 chunks: 16 items a
    tile); never below PRI_FWD_RUN_MIN; and an all-ones mask over another
    tile count (40 x 72: 15 tiles of 16 x 16, 12 of 256 rays) gives the
    same run."""
    rule = kernels.primary_fwd_run
    assert rule(1024, 1024, 512 * 512) == kernels.PRI_FWD_RUN_MIN
    assert rule(977, 977, 500 * 500) == kernels.PRI_FWD_RUN_MIN
    assert rule(1024 * 288, 1024, 512 * 512) == 288
    assert rule(69096, 1024, 512 * 512) == 68
    assert rule(64 * 2080, 64, 128 * 128) == 130
    assert rule(5, 1024, 512 * 512) == kernels.PRI_FWD_RUN_MIN
    assert rule(15 * 37, 15, 40 * 72) == rule(12 * 37, 12, 40 * 72)


@pytest.fixture(scope="module")
def crowded_case():
    """The 800-triangle torus (100 chunks of 8) at 32^2 from the STL
    camera, tiles of 256 consecutive rays (JAX's tile_p 256), a crowded
    mask (tile 1, where the torus is in view, keeps every chunk, tile 2 a
    seeded fifth, tiles 0 and 3 none); and JAX's masked forward on them."""
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
    mask[1] = 1
    mask[2] = rng.uniform(size=n_chunks) < 0.2
    mask = torch.tensor(mask)
    cam = camera.pos.contiguous()
    glob = jnp.asarray(np.concatenate([cam.numpy(),
                                       np.zeros(13, np.float32)])[None])
    out, m, s = jax_srt._primary_fwd_impl(
        jnp.asarray(inp.pri.numpy()), glob, jnp.zeros((1, 8), jnp.float32),
        jnp.asarray(inp.dirs.numpy()), jnp.asarray(mask.numpy()), inp.es,
        inp.zs, 0.2, 1, kernels.T_NEAR, TILE_P, CHUNK, interpret=True)
    return dict(inp=inp, cam=cam, tiles=tiles, mask=mask,
                out=np.asarray(out), m=np.asarray(m)[0], s=np.asarray(s)[0])


def _cornell_case():
    """The bench's Cornell frame cut to 32^2 (the box padded to 32, one
    chunk; sharpness 40 / 40) and the fit's first stage (30 rows, 10 /
    20), unmasked."""
    bench = raytrace_soft_inputs(
        cornell_box(pad_to=32, device="cpu"),
        Camera.raytracer_default(device="cpu"),
        RenderConfig(width=SIZE, height=SIZE, mode="soft",
                     soft_edge_sharpness=40.0, soft_z_sharpness=40.0),
        cull=False)
    cam = Camera.raytracer_default(device="cpu").pos.contiguous()
    return bench, cam


def test_masked_plain_forward_matches_jax_on_crowded_tiles(crowded_case):
    """The plain masked forward (K10b's plain version) on the crowded mask
    against JAX's masked forward: out, m and s within the port's
    cross-package rule (tests/test_torch_soft_raytrace_cull.py: rtol 1e-5
    / atol 3e-5; XLA's exp and log1p differ from torch's by ulps, and the
    carry is rescaled over 100 chunks: out within 9.1e-6, m 2.9e-5, s 2.2e-5
    relative); the tiles that keep nothing hold the background (out 0, m
    0, s 1) on both sides."""
    c = crowded_case
    inp = c["inp"]
    out, m, s = kernels.primary_agg_reference(
        inp.pri, c["cam"], inp.dirs, inp.es, inp.zs, CHUNK, c["mask"],
        c["tiles"])
    assert int(c["mask"][1].sum()) == c["mask"].shape[1]
    assert (m[TILE_P:2 * TILE_P] > 1.0).any()  # the torus's surface
    for got, want in ((out, c["out"]), (m, c["m"]), (s, c["s"])):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=3e-5)
    for rest in (slice(0, TILE_P), slice(3 * TILE_P, None)):
        assert not out[:, rest].any() and not c["out"][:, rest].any()
        assert (m[rest] == 0).all() and (s[rest] == 1).all()


@pytest.mark.parametrize("case", ["crowded", "none", "cornell"])
def test_fwd_walk_marks_no_pair_of_weight_not_0(crowded_case, case):
    """Every pair the plain forward test marks against the running carry
    has weight exactly 0, both at the chunk's new carry and at the saved
    max; it marks pairs that pass the gate (the test does work), and never
    a pair the test at the saved max (K10c's) leaves live."""
    c = crowded_case
    if case == "cornell":
        inp, cam = _cornell_case()
        mask = tiles = None
    else:
        inp, cam = c["inp"], c["cam"]
        mask, tiles = ((c["mask"], c["tiles"]) if case == "crowded"
                       else (None, None))
    pri, dirs, chunk = inp.pri, inp.dirs.detach(), inp.chunk
    _, m_saved, _ = kernels.primary_agg_reference(pri, cam, dirs, inp.es,
                                                  inp.zs, chunk, mask, tiles)
    carry = dirs.new_zeros(dirs.shape[1])
    marked = passing = 0
    for c_, keep, logit, dead in kernels.primary_fwd_walk(
            pri, cam, dirs, inp.es, inp.zs, chunk, mask, tiles):
        rows = slice(c_ * chunk, (c_ + 1) * chunk)
        hit = logit != -1e30
        m_new = torch.maximum(carry[keep], logit.max(dim=0).values)
        carry[keep] = m_new
        assert not (dead & (torch.exp(logit - m_new) != 0.0)).any()
        assert not (dead & (torch.exp(logit - m_saved[keep]) != 0.0)).any()
        at_saved = kernels.primary_dead_pairs(pri[rows], dirs[:, keep],
                                              m_saved[keep], inp.es, inp.zs)
        assert not (dead & ~at_saved).any()
        marked += int((dead & hit).sum())
        passing += int(hit.sum())
    assert 0 < marked < passing


@pytest.mark.parametrize("case", ["crowded", "none", "ones", "tiles16"])
def test_items_model_matches_plain_forward(crowded_case, case):
    """The plain model of the kernels' items and merge (primary_agg_items)
    against primary_agg_reference: out and s within rtol 1e-5 / atol 1e-6,
    m bit for bit; on the crowded mask tile 1 is cut into several items
    (merged). The
    all-ones mask on 16 x 16 tiles gives no mask's results bit for bit."""
    c = crowded_case
    inp = c["inp"]
    R, n_chunks = inp.dirs.shape[1], inp.pri.shape[0] // CHUNK
    mask, tiles = {"crowded": (c["mask"], c["tiles"]), "none": (None, None),
                   "ones": (torch.ones_like(c["mask"]), c["tiles"]),
                   "tiles16": (None, None)}[case]
    if case == "tiles16":
        tiles = ray_tiles(R, (SIZE, SIZE), "cpu")
        mask = torch.ones((tiles.count, n_chunks), dtype=torch.int32)
    args = (inp.pri, c["cam"], inp.dirs.detach(), inp.es, inp.zs, CHUNK,
            mask, tiles)
    run, items = kernels.primary_fwd_items(
        mask, R // kernels.THREADS if mask is None else tiles.count,
        n_chunks, R)
    assert sum(t == 1 for t, _ in items) > 1  # tile 1 is cut
    got, want = kernels.primary_agg_items(*args), \
        kernels.primary_agg_reference(*args)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert torch.equal(got[1], want[1])
    if case in ("ones", "tiles16"):
        brute = kernels.primary_agg_items(*args[:6])
        assert all(torch.equal(g, b) for g, b in zip(got, brute))
