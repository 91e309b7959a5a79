"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Every test here needs an NVIDIA card with nvcc (sm_90a) and skips
without one.  A machine with the card but without JAX runs them from the
repository root, past tests/conftest.py (which imports JAX), with

  python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest -p no:cacheprovider
"""
import pytest
import torch

from mitsuba_path_guiding_torch.accel.traverse import intersect_brute, occluded_brute
from mitsuba_path_guiding_torch.ops import build
from mitsuba_path_guiding_torch.ops.fused_path import (
    _pack_guide,
    build_fused_tables,
    trace_fused_cuda,
    trace_fused_plain,
)
from mitsuba_path_guiding_torch.ops.gather import gather_rows_t, gather_rows_t_plain
from mitsuba_path_guiding_torch.ops.intersect_tiled import (
    intersect_tiled,
    pack_triangles,
    tiled_plain,
)
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.scenes import cornell_box, veach_mis

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels are CUDA C++ for sm_90a)")
    build.build_all()
    return build_scene(cornell_box(), device="cuda")


def _rays(scene, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    lo, hi = scene.aabb_min, scene.aabb_max
    o = lo + (hi - lo) * torch.rand((n, 3), generator=g, device="cuda")
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g, device="cuda"), dim=-1)
    sel = torch.randint(0, 3, (n,), generator=g, device="cuda")
    tmax = torch.where(sel == 0, 3.0e37, torch.where(
        sel == 1, 3.0 * torch.rand((n,), generator=g, device="cuda"), -1.0))
    return o, d, tmax, g


@pytest.mark.parametrize("r", [36, 512])
def test_gather_rows_t_backward_bit_equal(card, r):
    """GatherRowsT launches the kernel forward and its backward equals
    autograd's gradient of the plain version bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(r + 1)
    table = torch.rand((r, 32), generator=g, device="cuda")
    idx = torch.randint(-5, r + 5, (100_003,), generator=g, device="cuda").to(torch.int32)
    cot = torch.randn((32, 100_003), generator=g, device="cuda")
    tab, plain = table.clone().requires_grad_(), table.clone().requires_grad_()
    before = build.LAUNCHES["gather_rows_t"]
    out = gather_rows_t(tab, idx)
    assert build.LAUNCHES["gather_rows_t"] == before + 1
    out.backward(cot)
    gather_rows_t_plain(plain, idx).backward(cot)
    torch.cuda.synchronize()
    assert torch.equal(out.detach(), gather_rows_t_plain(table, idx))
    assert torch.equal(tab.grad, plain.grad)


def test_intersect_tiled_closest_hit_with_grad(card):
    """With rays that require grad the kernel's hit comes back with t, u,
    v re-evaluated at the winner: the kernel's bits, tiled_plain's
    gradient."""
    pack = pack_triangles(card.geo.p0, card.geo.e1, card.geo.e2)
    o, d, tmax, _ = _rays(card, 20_000, 11)
    n = card.geo.p0.shape[0]
    with torch.no_grad():
        want = intersect_tiled(pack, o, d, tmax, n)
    grads = []
    for fn in (intersect_tiled, tiled_plain):
        o2, d2 = o.clone().requires_grad_(), d.clone().requires_grad_()
        hit = fn(pack, o2, d2, tmax, n)
        if fn is intersect_tiled:
            for a, b in zip(hit, want):
                assert torch.equal(a, b)
        (hit[0].clamp_max(1e3).sum() + hit[2].sum() + hit[3].sum()).backward()
        grads.append(torch.cat([o2.grad, d2.grad]))
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("r", [36, 512])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_gather_rows_t_bit_equal(card, r, dtype):
    g = torch.Generator(device="cuda").manual_seed(r)
    table = torch.rand((r, 32), generator=g, device="cuda")
    idx = torch.randint(-5, r + 5, (100_003,), generator=g, device="cuda").to(dtype)
    before = build.LAUNCHES["gather_rows_t"]
    got = gather_rows_t(table, idx)
    torch.cuda.synchronize()
    assert build.LAUNCHES["gather_rows_t"] == before + 1
    assert torch.equal(got, gather_rows_t_plain(table, idx))


@pytest.mark.parametrize("rows,cols,n,offset", [
    (244838, 32, 131071, 0),   # door_room's shading table, a ragged tile, unaligned rows
    (1000, 7, 4099, 0),        # another width: the general path
    (700, 45, 3000, 0),        # a width above one 32-column pass
    (600, 32, 5000, 1),        # a table that is not 16-byte aligned: the general path
])
def test_gather_rows_t_shapes(card, rows, cols, n, offset):
    g = torch.Generator(device="cuda").manual_seed(n)
    table = torch.rand((rows * cols + offset,), generator=g, device="cuda")[offset:]
    table = table.view(rows, cols)
    for dtype in (torch.int32, torch.int64):
        idx = torch.randint(-3, rows + 3, (n,), generator=g, device="cuda").to(dtype)
        got = gather_rows_t(table, idx)
        torch.cuda.synchronize()
        assert torch.equal(got, gather_rows_t_plain(table, idx))


def test_gather_rows_t_rejects_what_it_does_not_take(card):
    with pytest.raises(TypeError):
        gather_rows_t(torch.zeros((4, 4), dtype=torch.float64, device="cuda"),
                      torch.zeros((8,), dtype=torch.int32, device="cuda"))
    with pytest.raises(TypeError):
        gather_rows_t(torch.zeros((4, 4), device="cuda"),
                      torch.zeros((2, 8), dtype=torch.int32, device="cuda"))


@pytest.fixture(scope="module")
def veach(card):
    return build_scene(veach_mis(), device="cuda")


def test_intersect_tiled_matches_plain(card, veach):
    """The kernel against tiled_plain, bit for bit on every lane: t, prim,
    u, v and valid of closest hit, and the any-hit flags.  The Cornell box
    (36 triangles) and the first 1, 127, 128, 129 and all 3850 triangles
    of veach_mis (one tile, a full tile, one over, 31 tiles), each on
    100003 random rays (not a multiple of the CTA's 32 rays) from points
    of the scene's box, a third of them dead (tmax -1)."""
    for scene, n_tri in ((card, 36), (veach, 1), (veach, 127), (veach, 128), (veach, 129),
                         (veach, 3850)):
        geo = scene.geo
        pack = pack_triangles(geo.p0[:n_tri], geo.e1[:n_tri], geo.e2[:n_tri])
        o, d, tmax, _ = _rays(scene, 100_003, 1)
        before = build.LAUNCHES["intersect_tiled"]
        got = intersect_tiled(pack, o, d, tmax, n_tri)
        occ = intersect_tiled(pack, o, d, tmax, n_tri, any_hit=True)
        want = tiled_plain(pack, o, d, tmax, n_tri)
        occ_want = tiled_plain(pack, o, d, tmax, n_tri, any_hit=True)
        torch.cuda.synchronize()
        assert build.LAUNCHES["intersect_tiled"] == before + 2
        for name, a, b in zip(("t", "prim", "u", "v", "valid"), got, want):
            same = a.view(torch.int32) == b.view(torch.int32) if a.is_floating_point() else a == b
            lanes = torch.nonzero(~same).flatten()[:8].tolist()
            assert bool(same.all()), f"{n_tri} triangles: {name} differs on lanes {lanes}"
        assert torch.equal(occ, occ_want), f"{n_tri} triangles: any-hit flags differ"
        valid = got[4]
        assert not valid[tmax < 0].any() and not occ[tmax < 0].any()
        assert bool((got[2][~valid] == 0).all() and (got[3][~valid] == 0).all())
        if n_tri in (36, 3850):
            assert valid.float().mean() > 0.1 and torch.equal(occ, valid)


@pytest.mark.parametrize("guided", [False, True])
def test_trace_fused_matches_plain(card, guided):
    from mitsuba_path_guiding_torch.guiding.grid import make_grid

    scene = card
    tables = build_fused_tables(scene)
    o, d, _, g = _rays(scene, 32_768, 2)
    keys = torch.randint(0, 2**32, (o.shape[0], 2), generator=g, device="cuda", dtype=torch.int64)
    grid = make_grid(scene.aabb_min, scene.aabb_max, res=16, n_lobes=8)
    grid = grid._replace(valid=torch.rand(grid.valid.shape, generator=g, device="cuda") < 0.7,
                         kappa=20.0 * torch.rand(grid.kappa.shape, generator=g, device="cuda"))
    guide_tab, meta = _pack_guide(grid)
    kw = dict(max_depth=5, rr_depth=3, guided=guided, alpha=0.5)
    got = trace_fused_cuda(tables, o, d, keys, guide_tab, meta, **kw)
    want = trace_fused_plain(tables, o, d, keys, guide_tab, meta, **kw)
    torch.cuda.synchronize()
    close = torch.isclose(got[0:3], want[0:3], rtol=1e-3, atol=1e-6).all(dim=0)
    assert close.float().mean() >= 0.99
    assert (got[10] == want[10]).float().mean() >= 0.99
    # the work counts: closest-hit loops entered, shadow-ray triangle tests
    assert (got[14:16] == want[14:16]).all(dim=0).float().mean() >= 0.99
    assert torch.isfinite(got).all()


def test_trace_fused_uneven_depths(card):
    """Half the lanes start inside the box toward its open side (most
    escape at once), half are camera rays (most run all 5 bounces): the
    kernel's warps refill as paths end.  30001 lanes, not a multiple of
    the block; every row against the plain version."""
    from mitsuba_path_guiding_torch.guiding.grid import make_grid

    scene = card
    tables = build_fused_tables(scene)
    n = 30_001
    o, d, _, g = _rays(scene, n, 9)
    half = torch.arange(n, device="cuda") < n // 2
    out_dir = torch.nn.functional.normalize(d * torch.tensor([0.3, 0.3, 0.0], device="cuda")
                                            + torch.tensor([0.0, 0.0, -1.0], device="cuda"), dim=-1)
    cam = scene.sensor.to_world[:3, 3].to("cuda")
    d_cam = torch.nn.functional.normalize(o - cam, dim=-1)
    o = torch.where(half[:, None], o, cam.expand_as(o))
    d = torch.where(half[:, None], out_dir, d_cam)
    keys = torch.randint(0, 2**32, (n, 2), generator=g, device="cuda", dtype=torch.int64)
    grid = make_grid(scene.aabb_min, scene.aabb_max, res=16, n_lobes=8)
    grid = grid._replace(valid=torch.rand(grid.valid.shape, generator=g, device="cuda") < 0.7,
                         kappa=20.0 * torch.rand(grid.kappa.shape, generator=g, device="cuda"))
    guide_tab, meta = _pack_guide(grid)
    kw = dict(max_depth=5, rr_depth=5, guided=True, alpha=0.5)
    got = trace_fused_cuda(tables, o, d, keys, guide_tab, meta, **kw)
    want = trace_fused_plain(tables, o, d, keys, guide_tab, meta, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    depth = want[14]
    assert (depth[half] == 1).float().mean() > 0.5 and (depth[~half] == 5).float().mean() > 0.2
    close = torch.isclose(got, want, rtol=1e-3, atol=1e-6)
    for rows in (slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 10), slice(11, 14)):
        assert close[rows].all(dim=0).float().mean() >= 0.99
    assert (got[10] == want[10]).float().mean() >= 0.99
    assert (got[14:16] == want[14:16]).all(dim=0).float().mean() >= 0.99


@pytest.fixture(scope="module")
def door(card):
    from mitsuba_path_guiding_torch.scene.scenes import door_room

    return build_scene(door_room(20000), device="cuda")


def _edge_tiles(door, g):
    """Pair tiles on the cases the MT kernel's design branches on: blocks
    with 128, 1 and 79 real triangles (two of them tying in t), a tile
    whose pairs are all live, one live only in its first 41 pairs (a
    partly and two wholly dead 32-pair slots), an inert tile, one whose
    first 64 pairs are dead (dummies of the block before), a live block
    with every pair dead, one with every other pair dead and one live only
    in its last 32 pairs with some tmax at or below EPS_T.  Returns
    (tri_rows, tri_cols, tile_block, pdata)."""
    from mitsuba_path_guiding_torch.ops import intersect_pairs as ip

    pt = door.pairs
    # three blocks of 128 real triangles each, taken in table order
    real = torch.nonzero(pt.tri_rows[:, 9, :] >= 0)[:3 * ip.LEAF]
    b_src, s_src = real[:, 0], real[:, 1]
    rows = pt.tri_rows[b_src, :, s_src].reshape(3, ip.LEAF, 10).transpose(1, 2).contiguous()
    cols = torch.stack([pt.tri_cols[b_src, :, grp * ip.LEAF + s_src] for grp in range(5)], dim=1)
    cols = cols.reshape(3, ip.LEAF, 5, 16).permute(0, 3, 2, 1).reshape(3, 16, 5 * ip.LEAF)
    cols = cols.contiguous()
    rows[0, :, 11] = rows[0, :, 10]                  # a duplicate triangle: equal t,
    rows[0, 9, 11] = rows[0, 9, 10] - 0.5            # the lesser id must win
    cols[0, :, 11::128] = cols[0, :, 10::128]
    rows[1, 9, 1:] = -1.0                            # 1 real triangle, the rest padding
    rows[2, 9, 79:] = -1.0                           # 79 real triangles
    tile_block = torch.tensor([0, 1, -1, 2, 0, 1, 2], dtype=torch.int32, device="cuda")
    n_tiles = tile_block.numel()
    # each pair aims at a point of a random real triangle of its block
    blk = tile_block.clamp_min(0).long().repeat_interleave(ip.TILE)
    n_real = torch.tensor([128, 1, 79], device="cuda")[blk]
    k = (torch.rand(blk.shape, generator=g, device="cuda") * n_real).long()
    tri = rows[blk, :, k]
    b = torch.rand((blk.numel(), 2), generator=g, device="cuda") * 0.5
    target = tri[:, 0:3] + b[:, 0:1] * tri[:, 3:6] + b[:, 1:2] * tri[:, 6:9]
    o = target + torch.randn((blk.numel(), 3), generator=g, device="cuda")
    d = torch.nn.functional.normalize(target - o, dim=-1)
    d = torch.where(torch.rand((blk.numel(), 1), generator=g, device="cuda") < 0.2,
                    torch.nn.functional.normalize(torch.randn_like(d), dim=-1), d)
    tmax = torch.where(torch.rand(blk.shape, generator=g, device="cuda") < 0.8, 3.0e37, 1.0)
    pair = torch.arange(ip.TILE, device="cuda").repeat(n_tiles)
    tile = torch.arange(n_tiles, device="cuda").repeat_interleave(ip.TILE)
    dead = (((tile == 1) & (pair >= 41)) | ((tile == 3) & (pair < 64)) | (tile == 4)
            | ((tile == 5) & (pair % 2 == 1)) | ((tile == 6) & (pair < 96)))
    tmax = torch.where(dead, torch.where(pair % 3 == 0, -1.0, 0.0), tmax)
    tmax = torch.where((tile == 6) & (pair >= 120), torch.where(pair % 2 == 0, 1e-4, 5e-5), tmax)
    pdata = torch.cat([o.T, d.T, tmax[None, :]], dim=0).contiguous()
    return rows, cols, tile_block, pdata


@pytest.mark.parametrize("engine", ["mt", "plk"])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("case", ["door", "edges"])
def test_pair_tiles_match_plain(door, engine, any_hit, case):
    from mitsuba_path_guiding_torch.ops import intersect_pairs as ip

    if case == "door":
        o, d, tmax, _ = _rays(door, 20_000, 3)
        ids, _ = ip.build_pair_lists(door.pairs, o, d, tmax)
        skeys, spays, _ = ip.sorted_pairs(door.pairs, ids, o.shape[0], 5)
        pdata, tile_block = ip.pair_tiles(skeys, spays, o, d, tmax)
        rows, cols = door.pairs.tri_rows, door.pairs.tri_cols
    else:
        rows, cols, tile_block, pdata = _edge_tiles(door, torch.Generator(device="cuda")
                                                    .manual_seed(8))
    tabs = (rows,) if engine == "mt" else (cols, rows)
    kern = ip.mt_tiles if engine == "mt" else ip.plk_tiles
    plain = ip.mt_tiles_plain if engine == "mt" else ip.plk_tiles_plain
    before = build.LAUNCHES[f"intersect_pairs_{engine}"]
    got = kern(*tabs, tile_block, pdata, any_hit)
    want = plain(*tabs, tile_block, pdata, any_hit)
    torch.cuda.synchronize()
    assert build.LAUNCHES[f"intersect_pairs_{engine}"] == before + 1
    assert (got[0] < ip.INF).sum() > 100
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if case == "edges":
        dead = ~(pdata[6] > ip.EPS_T) | (tile_block.repeat_interleave(ip.TILE) < 0)
        assert bool((got[0][dead] == ip.INF).all() and (got[1][dead] == -1.0).all())
        assert ((got[0] < ip.INF) & ~dead).sum() < (~dead).sum()   # live misses too


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("k", [128, 1])
@pytest.mark.parametrize("n", [3000, 1500])   # 12 tiles, and 6: clusters of 16 CTAs
def test_blocklist_matches_plain(door, any_hit, k, n):
    from mitsuba_path_guiding_torch.ops import intersect_blocklist as ib

    bl = door.blocks
    o, d, tmax, _ = _rays(door, n, 4)
    o_p, d_p, t_p, npad = ib._pad_rays(o, d, tmax)
    cand, cnt = ib.candidate_superblocks(bl.sb_lo, bl.sb_hi, o_p, d_p, t_p,
                                         ib.cand_width(npad, bl.sb_lo.shape[0], k))
    got, gw = ib.blocklist_cuda(bl, o_p, d_p, t_p, cand, cnt, any_hit)
    want, ww = ib.blocklist_plain(bl, o_p, d_p, t_p, cand, cnt, any_hit)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)) and torch.equal(gw, ww)
    assert (want[1] >= 0).sum() > 100


def test_pairs_full_equals_the_oracle(door):
    from mitsuba_path_guiding_torch.accel.traverse import intersect_pairs_full, occluded_pairs_full

    o, d, tmax, _ = _rays(door, 4096, 5)
    build.reset_launches()
    # a budget of one pair per ray leaves rays unproven, each query's
    # blocklist launch re-traces them
    hit = intersect_pairs_full(door.pairs, door.blocks, o, d, tmax, cap_factor=1)
    occ = occluded_pairs_full(door.pairs, door.blocks, o, d, tmax, cap_factor=1, engine="plk")
    torch.cuda.synchronize()
    assert build.LAUNCHES["intersect_pairs_mt"] == 1 and build.LAUNCHES["intersect_pairs_plk"] == 1
    assert build.LAUNCHES["intersect_blocklist"] == 2
    assert torch.equal(hit.prim, intersect_brute(door.geo, o, d, tmax).prim)
    assert torch.equal(occ, occluded_brute(door.geo, o, d, tmax))


def _interior_camera_sorted():
    """tools/profile_blocklist_torch.py's interior scene (294924
    triangles, 37 superblocks) and its 524288-ray camera wave, sorted as
    intersect_blocks_sorted sorts it."""
    import os
    import sys

    from mitsuba_path_guiding_torch.ops import intersect_twolevel as tl

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                    "tools"))
    import profile_blocklist_torch as pb

    p0, e1, e2 = pb.make_interior(300_000)
    bt = tl.build_blocks(p0, e1, e2, device="cuda")
    o, d = (torch.from_numpy(x).cuda() for x in pb.camera_rays(524_288, seed=0))
    perm = torch.argsort(tl._ray_sort_keys(bt, o, d), stable=True)
    return bt, o[perm], d[perm]


@pytest.mark.parametrize("case", ["door_room", "ragged", "interior", "interior_ordered"])
def test_twolevel_matches_plain(door, case):
    """The kernel against twolevel_plain on the same mask and order: t,
    prim, u, v and the four work counts bit-equal.  door_room(20000) with
    3000 random rays; 1000 random rays with tmax 1.5 (a ragged last tile);
    4096 sorted rays of the interior camera wave; and 600 tiles of them
    with tmax 0.5 on every other tile, so uneven walks over more than two
    waves of CTAs, where the kernel takes the tiles longest walk first."""
    from mitsuba_path_guiding_torch.ops import intersect_twolevel as tl

    if case.startswith("interior"):
        bt, o, d = _interior_camera_sorted()
        n = 4096 if case == "interior" else 600 * tl.RAY_TILE
        start = o.shape[0] // 2 if case == "interior" else 0
        o, d = o[start:start + n], d[start:start + n]
        tmax = torch.full((n,), 3.0e38, device="cuda")
        if case == "interior_ordered":
            tmax[torch.arange(n, device="cuda") // tl.RAY_TILE % 2 == 1] = 0.5
    else:
        bt = tl.build_blocks(door.geo.p0.cpu().numpy(), door.geo.e1.cpu().numpy(),
                             door.geo.e2.cpu().numpy(), device="cuda")
        o, d, tmax, _ = _rays(door, 3000 if case == "door_room" else 1000, 6)
        if case == "ragged":
            tmax = torch.full_like(tmax, 1.5)
    ray, tmax_p = tl._pad_rays(o, d, tmax)
    mask, order = tl.superblock_mask(bt, o, d, tmax)
    if case == "interior_ordered":
        walked = mask.sum(dim=1)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        assert mask.shape[0] > 4 * sms
        assert 2 * int(walked.max()) * mask.shape[0] > 3 * int(walked.sum())
    before = build.LAUNCHES["intersect_twolevel"]
    got, gw = tl.twolevel_cuda(bt, ray, tmax_p, mask, order)
    want, ww = tl.twolevel_plain(bt, ray, tmax_p, mask, order)
    torch.cuda.synchronize()
    assert build.LAUNCHES["intersect_twolevel"] == before + 1
    assert (want[1] >= 0).sum() > 100
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)) and torch.equal(gw, ww)


@pytest.mark.parametrize("scene", ["door_room", "cornell"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_bvh_matches_plain(card, door, scene, any_hit):
    """The kernel over the packed tree against bvh_plain over the unpacked
    nodes (both read the packed triangles): t, prim, u, v and both work
    counts equal, on door_room and on the Cornell box's small tree."""
    from mitsuba_path_guiding_torch.ops.intersect_bvh import bvh_cuda, bvh_plain

    sc = door if scene == "door_room" else card
    o, d, tmax, _ = _rays(sc, 20_000, 7)
    before = build.LAUNCHES["intersect_bvh"]
    got = bvh_cuda(sc.bvh, o, d, tmax, any_hit)
    want = bvh_plain(sc.bvh, o, d, tmax, any_hit)
    torch.cuda.synchronize()
    assert build.LAUNCHES["intersect_bvh"] == before + 1
    assert (want[1] >= 0).sum() > 100
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_bvh_box_tests_equal_the_reference_walks_pops(door):
    """On one closest-hit call the kernel's box tests equal the nodes the
    reference's walk (both children pushed, each box tested at its pop)
    pops."""
    from torch_port_parity import reference_walk_pops

    from mitsuba_path_guiding_torch.ops.intersect_bvh import bvh_cuda

    g = door.geo
    o, d, tmax, _ = _rays(door, 20_000, 8)
    counts = bvh_cuda(door.bvh, o, d, tmax)[4]
    pops = reference_walk_pops(door.bvh, g.p0, g.e1, g.e2, o, d, tmax)
    torch.cuda.synchronize()
    assert pops.float().mean() > 10
    assert torch.equal(counts[0], pops)


def test_refine_and_guide_options_on_the_card(card):
    """refine_grid and the product, min_rough-gated guide on CUDA tensors
    against the same calls on the CPU: the refined grid equal field for
    field, the guide's directions, densities and weights within the
    tolerance of the card's transcendentals (rtol 1e-4 on 99% of lanes,
    the port's trace tolerance), its delta flags and the gate equal."""
    import numpy as np

    from mitsuba_path_guiding_torch.core.math import Frame
    from mitsuba_path_guiding_torch.guiding.fit import refine_grid
    from mitsuba_path_guiding_torch.guiding.grid import make_grid
    from mitsuba_path_guiding_torch.guiding.sampler import make_guide_fn
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.scene.transforms import rotate, scale, translate
    from torch_port_parity import frac_close

    rc = {"type": "roughconductor", "eta": [0.2, 0.92, 1.1], "k": [3.9, 2.45, 2.14]}
    floor = rotate([1, 0, 0], -90) @ scale(0.5)
    lamp = translate(0, 2.0, 0) @ rotate([1, 0, 0], 90) @ scale(0.3)
    spec = {"shapes": [
        {"type": "rectangle", "to_world": translate(-1.0, 0, 0) @ floor,
         "bsdf": {"type": "diffuse", "reflectance": [0.6, 0.6, 0.6]}},
        {"type": "rectangle", "to_world": floor, "bsdf": {**rc, "alpha": 0.08}},
        {"type": "rectangle", "to_world": translate(1.0, 0, 0) @ floor,
         "bsdf": {**rc, "alpha": 0.5}},
        {"type": "rectangle", "to_world": lamp, "emitter": {"radiance": [5.0] * 3},
         "bsdf": {"type": "diffuse", "reflectance": [0.0] * 3}},
    ]}
    scenes = {dev: build_scene(spec, device=dev) for dev in ("cpu", "cuda")}
    sc = scenes["cpu"]
    rs = np.random.default_rng(11)

    def f32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32))

    def unit(*shape):
        return torch.nn.functional.normalize(f32(rs.normal(size=shape)), dim=-1)

    g = make_grid(sc.aabb_min, sc.aabb_max, res=4, n_lobes=4, capacity=8 * 4**3)
    c, k = g.kappa.shape
    g = g._replace(mu=unit(c, k, 3), kappa=f32(0.5 + 60.0 * rs.random((c, k))),
                   log_weight=f32(rs.normal(size=(c, k))),
                   valid=torch.from_numpy(rs.random(c) < 0.8), alpha_scale=f32(rs.random(c)),
                   s_count=f32(np.where(rs.random(c) < 0.3, 100.0, 1.0)))
    on_card = g._replace(**{f: getattr(g, f).cuda() for f in g._fields
                            if torch.is_tensor(getattr(g, f))})
    grids = {"cpu": refine_grid(g, 50.0), "cuda": refine_grid(on_card, 50.0)}
    assert grids["cpu"].n_used == grids["cuda"].n_used > 4**3
    for f in g._fields:
        a, b = getattr(grids["cpu"], f), getattr(grids["cuda"], f)
        if torch.is_tensor(a):
            assert b.is_cuda and torch.equal(a, b.cpu()), f

    n = 65536
    mats = sc.mats
    mid = torch.from_numpy(rs.integers(0, mats.alpha.shape[0], n).astype(np.int32))
    p = sc.aabb_min + (sc.aabb_max - sc.aabb_min) * f32(rs.random((n, 3)))
    nrm, wi, d_nee = unit(n, 3), unit(n, 3), unit(n, 3)
    wi[:, 2] = wi[:, 2].abs()
    u = f32(rs.random((n, 5)))
    pdf_b = f32(0.05 + rs.random(n))
    guide = make_guide_fn(0.5, types_present(mats), product=True, min_rough=0.3)
    out = {}
    for dev in ("cpu", "cuda"):
        x = [v.to(dev) for v in (mid, p, nrm, wi, d_nee, u, pdf_b)]
        args = (grids[dev], scenes[dev].mats, x[0], x[1], Frame.from_normal(x[2]))
        out[dev] = [v.cpu() for v in (*guide(*args, x[3], x[5][:, 0:3], x[5][:, 3], x[5][:, 4]),
                                      guide.pdf_at(*args, x[4], x[6]))]
    for name, a, b in zip(("wo", "pdf", "weight", "is_delta", "pdf_at"), out["cpu"], out["cuda"]):
        if name == "is_delta":
            assert torch.equal(a, b)
        else:
            assert frac_close(b.numpy(), a.numpy(), rtol=1e-4) >= 0.99, name
    narrow = (mats.type.long()[mid.long()] == 3) & (mats.alpha[mid.long()] < 0.3)
    assert narrow.sum() > 0
    assert torch.equal(out["cuda"][4][narrow], pdf_b[narrow])


def test_cell_sums_repeat_and_equal_the_cpus(card):
    """The fit's per-cell sums on the card: bit-equal from call to call,
    and bit-equal to the CPU's serial ``index_add_`` (each cell's rows
    added in row order) on a payload whose cell ids crowd the low cells."""
    from mitsuba_path_guiding_torch.guiding.fit import cell_sums

    g = torch.Generator(device="cuda").manual_seed(5)
    n_cells = 4096
    cid = (torch.rand((300_000,), generator=g, device="cuda") ** 4 * n_cells).long()
    payload = torch.randn((300_000, 45), generator=g, device="cuda")
    first = cell_sums(n_cells, cid, payload)
    for _ in range(3):
        assert torch.equal(cell_sums(n_cells, cid, payload), first)
    assert torch.equal(first.cpu(), cell_sums(n_cells, cid.cpu(), payload.cpu()))


def test_gather_rows_t_coat_table(card):
    """The (M, 16) coat transmittance table through the kernel's general
    path, on random indices and on gather_params' own, bit-equal."""
    from mitsuba_path_guiding_torch.models import bsdf as bsdf_mod

    desc = cornell_box()
    desc["shapes"][5]["bsdf"] = {"type": "roughcoating", "alpha": 0.1,
                                 "bsdf": desc["shapes"][5]["bsdf"]}
    desc["shapes"][6]["bsdf"] = {"type": "coating", "bsdf": {"type": "diffuse"}}
    mats = build_scene(desc, device="cuda").mats
    table = mats.coat_trans
    assert table.shape[1] == 16 and int((table.amax(dim=1) > 0).sum()) == 2
    g = torch.Generator(device="cuda").manual_seed(16)
    for dtype in (torch.int32, torch.int64):
        idx = torch.randint(-3, table.shape[0] + 3, (65537,), generator=g, device="cuda").to(dtype)
        before = build.LAUNCHES["gather_rows_t"]
        got = gather_rows_t(table, idx)
        torch.cuda.synchronize()
        assert build.LAUNCHES["gather_rows_t"] == before + 1
        assert torch.equal(got, gather_rows_t_plain(table, idx))
    mid = torch.randint(0, table.shape[0], (65536,), generator=g, device="cuda").to(torch.int32)
    p = bsdf_mod.gather_params(mats, mid, types=bsdf_mod.types_present(mats))
    assert torch.equal(p.tcoat, gather_rows_t_plain(table, mid))


@pytest.mark.parametrize("cfg,fused", [
    ({}, 1),
    ({"sampler": "sobol"}, 0),
    ({"sampler": "stratified"}, 0),
    ({"qmc_bounces": 2}, 0),
])
def test_fused_gate_needs_independent_sampler_without_sobol_bounces(card, cfg, fused):
    """trace_fused draws its own threefry stream: a wave with another
    sampler or with Sobol' bounce dimensions takes the wavefront trace."""
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render_wave

    pix = torch.arange(64 * 64, device="cuda")
    build.reset_launches()
    _, L, _ = render_wave(card, RenderConfig(width=64, height=64, **cfg), pix,
                          torch.zeros_like(pix))
    torch.cuda.synchronize()
    assert build.LAUNCHES["trace_fused"] == fused
    assert (build.LAUNCHES["intersect_tiled"] > 0) == (fused == 0)
    assert bool(torch.isfinite(L).all())


@pytest.mark.parametrize("filter_name", ["box", "gaussian"])
def test_splat_repeats_and_equals_the_cpus(card, filter_name):
    """The film's scatter-add on the card: samples crowding few pixels
    (as a pixel's jittered sample rounding into its neighbour does) give
    the same accumulator from call to call, equal to the CPU's serial
    ``index_add_`` (the box's unit weights bit for bit; the Gaussian's
    weights go through ``exp``, whose last bit the card and the CPU may
    round apart, to rtol 1e-6)."""
    from mitsuba_path_guiding_torch.film.film import new_film, splat

    g = torch.Generator(device="cuda").manual_seed(3)
    n = 65536
    xy = torch.rand((n, 2), generator=g, device="cuda") * 8.0
    vals = torch.rand((n, 3), generator=g, device="cuda")
    first = splat(new_film(8, 8, device="cuda").rgb_weight, xy, vals, 8, 8, filter_name)
    for _ in range(3):
        again = splat(new_film(8, 8, device="cuda").rgb_weight, xy, vals, 8, 8, filter_name)
        assert torch.equal(again, first)
    cpu = splat(new_film(8, 8, device="cpu").rgb_weight, xy.cpu(), vals.cpu(), 8, 8, filter_name)
    if filter_name == "box":
        assert torch.equal(first.cpu(), cpu)
    else:
        torch.testing.assert_close(first.cpu(), cpu, rtol=1e-6, atol=0.0)


def test_volume_render_scanned_equals_render(card):
    """render_scanned and render give the volbox the same image bit for
    bit on the card, and each repeats from call to call."""
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render, render_scanned
    from mitsuba_path_guiding_torch.scene.scenes import volumetric_box

    sc = build_scene(volumetric_box(), device="cuda")
    cfg = RenderConfig(width=64, height=64, spp=4, max_depth=5, seed=5)
    img = render(sc, cfg)
    assert torch.equal(render(sc, cfg), img)
    assert torch.equal(render_scanned(sc, cfg), img)


def _curvature_box():
    desc = cornell_box()
    desc["shapes"][6] = {"type": "sphere", "center": [0.4, 0.3, -0.1], "radius": 0.3,
                         "bsdf": {"type": "diffuse", "texture": {"type": "curvature"}}}
    return desc


def test_gather_rows_t_vertex_colour_table(card):
    """The (T, 9) vertex-colour table of a curvature-coloured mesh (3968
    triangles: the kernel's general path), on random indices out of range
    too and on a camera wave's hit triangles, bit-equal; the tracer's
    bounce gathers it once."""
    from mitsuba_path_guiding_torch.core import rng
    from mitsuba_path_guiding_torch.integrators.path import trace
    from mitsuba_path_guiding_torch.models.bsdf import types_present
    from mitsuba_path_guiding_torch.models.emitter import kinds_present
    from mitsuba_path_guiding_torch.models.sensor import generate_rays

    sc = build_scene(_curvature_box(), device="cuda")
    table = sc.geo.vcol
    assert table.shape[0] > 512 and table.shape[1] == 9
    g = torch.Generator(device="cuda").manual_seed(9)
    for dtype in (torch.int32, torch.int64):
        idx = torch.randint(-3, table.shape[0] + 3, (65537,), generator=g, device="cuda").to(dtype)
        assert torch.equal(gather_rows_t(table, idx), gather_rows_t_plain(table, idx))
    pix = torch.arange(64 * 64, device="cuda")
    rkeys = rng.ray_keys(rng.base_key(0, device="cuda"), pix, torch.zeros_like(pix))
    o, d, _ = generate_rays(sc.sensor, 64, 64, pix, rng.event_uniform(rkeys, rng.TAG_CAMERA, 2))
    build.reset_launches()
    L, _, _ = trace(sc, o, d, rkeys, max_depth=2, textured=True,
                    mat_types=types_present(sc.mats), em_kinds=kinds_present(sc.emitters))
    torch.cuda.synchronize()
    # a bounce: shading, material, vertex-colour and emitter rows
    assert build.LAUNCHES["gather_rows_t"] == 4 * 2
    assert build.LAUNCHES["gather_rows_t_large"] == 2 * 2 and bool(torch.isfinite(L).all())


def test_textured_diffuse_scene_launches_no_trace_fused(card):
    """An unguided render of a diffuse Cornell box with a checkerboard
    floor takes the wavefront (the fused kernel would drop the texture),
    and its image equals the CPU's wavefront render to rtol 1e-4 on >= 99%
    of pixels."""
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render

    desc = cornell_box()
    desc["shapes"][0]["bsdf"] = {"type": "diffuse", "texture": {"type": "checkerboard"}}
    cfg = RenderConfig(width=32, height=32, spp=2, max_depth=5)
    build.reset_launches()
    img = render(build_scene(desc, device="cuda"), cfg)
    torch.cuda.synchronize()
    assert build.LAUNCHES["trace_fused"] == 0 and build.LAUNCHES["intersect_tiled"] == 2 * 5 * 2
    cpu = render(build_scene(desc, device="cpu"), cfg)
    close = torch.isclose(img.cpu(), cpu, rtol=1e-4, atol=1e-6).all(dim=-1)
    assert float(close.float().mean()) >= 0.99


def test_denoiser_card_equals_cpu(card):
    """The neural denoiser (cuDNN convolutions with TF32 off) on the card
    against the CPU on the same buffers, rtol 1e-4 (atol 1e-6), at a size
    that is not a multiple of 4."""
    from mitsuba_path_guiding_torch.film.neural_denoise import denoise_neural, load_net

    g = torch.Generator().manual_seed(2)
    h, w = 62, 90
    color = torch.rand((h, w, 3), generator=g) ** 3 * 3.0
    albedo = torch.rand((h, w, 3), generator=g)
    normal = torch.nn.functional.normalize(torch.randn((h, w, 3), generator=g), dim=-1)
    depth = torch.rand((h, w), generator=g) * 4.0
    bufs = (color, albedo, normal, depth)
    got = denoise_neural(*(b.cuda() for b in bufs))
    assert load_net(got.device) is not None
    torch.testing.assert_close(got.cpu(), denoise_neural(*bufs), rtol=1e-4, atol=1e-6)


def _image_close(got, want, rtol=1e-3):
    """The 16x16 parity bars: means within rtol relative, >= 99% of pixels
    within rtol (atol 1e-6)."""
    got, want = got.cpu(), want.cpu()
    assert abs(float(got.mean()) / float(want.mean()) - 1.0) < rtol
    close = torch.isclose(got, want, rtol=rtol, atol=1e-6).all(dim=-1)
    assert float(close.float().mean()) >= 0.99


@pytest.mark.parametrize("integrator", ["ptracer", "bdpt"])
def test_light_path_renders_repeat_and_equal_the_cpus(card, integrator):
    """render_ptracer and render_bdpt on the Cornell box at 16x16: two
    calls on the card give the same image bit for bit (the light splats
    add in an order fixed by the data), and the card's image meets the
    CPU's within the parity tests' bars (the card rounds transcendentals
    apart from the CPU)."""
    from mitsuba_path_guiding_torch.integrators import bdpt, ptracer
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig

    fn = ptracer.render_ptracer if integrator == "ptracer" else bdpt.render_bdpt
    cfg = RenderConfig(width=16, height=16, spp=4, max_depth=5, seed=2)
    img = fn(card, cfg)
    assert torch.equal(fn(card, cfg), img)
    _image_close(img, fn(build_scene(cornell_box(), device="cpu"), cfg))


def test_sample_ray_on_the_card_equals_the_cpus(card):
    """sample_ray of every kind the test scene holds (area, point, spot,
    directional, envmap) on 65536 lanes: valid and infinite equal, every
    field within rtol 1e-5 (atol 1e-6) on >= 99.9% of lanes."""
    import numpy as np

    from mitsuba_path_guiding_torch.models.emitter import kinds_present, sample_ray
    from mitsuba_path_guiding_torch.scene.transforms import look_at

    desc = cornell_box()
    rs = np.random.default_rng(3)
    desc["emitters"] = [
        {"type": "point", "position": [0.3, 1.5, -0.2], "intensity": [3.0, 2.0, 1.0]},
        {"type": "spot", "to_world": look_at([1.0, 1.8, 0.0], [0, 0, 0]),
         "intensity": [5.0, 4.0, 3.0], "cutoff_angle": 30.0},
        {"type": "directional", "direction": [0.0, -1.0, 0.0]},
        {"type": "envmap", "image": rs.random((8, 16, 3)).astype(np.float32)}]
    u = torch.rand((65536, 5), generator=torch.Generator().manual_seed(4))
    out = []
    for dev in ("cuda", "cpu"):
        sc = build_scene(desc, device=dev)
        out.append(sample_ray(sc.emitters, sc.aabb_min, sc.aabb_max, u.to(dev),
                              kinds=kinds_present(sc.emitters)))
    got, want = out
    assert torch.equal(got.valid.cpu(), want.valid) and torch.equal(got.infinite.cpu(), want.infinite)
    for f in ("o", "d", "weight", "normal", "emit_weight", "emission_pdf_w", "direct_pdf_a",
              "cos_light"):
        a, b = getattr(got, f).cpu(), getattr(want, f)
        close = torch.isclose(a, b, rtol=1e-5, atol=1e-6)
        close = close.all(dim=-1) if close.dim() > 1 else close
        assert float(close.float().mean()) >= 0.999, f


def test_chain_rng_on_the_card_equals_the_cpus(card):
    """permutation (131072: two rounds of a stable sort by random bits),
    choice (the XLA-order cumulative sum and the search) and split on the
    card bit-equal to the CPU's."""
    from mitsuba_path_guiding_torch.core import rng

    k = rng.base_key(17, device="cuda")
    assert torch.equal(rng.permutation(k, 131072).cpu(), rng.permutation(rng.base_key(17), 131072))
    assert torch.equal(rng.split(k, 5).cpu(), rng.split(rng.base_key(17), 5))
    p = torch.rand(32768, generator=torch.Generator().manual_seed(3)) ** 6
    p = p / p.sum()
    want = rng.choice(rng.base_key(9), 32768, (8192,), p)
    assert torch.equal(rng.choice(rng.base_key(9, device="cuda"), 32768, (8192,), p.cuda()).cpu(),
                       want)
    assert torch.equal(rng.cumsum_xla(p.cuda()).cpu(), rng.cumsum_xla(p))


@pytest.mark.parametrize("integrator", ["pssmlt", "mlt", "erpt", "sppm", "photonmapper"])
def test_chain_renders_repeat_and_equal_the_cpus(card, integrator):
    """Each chain and photon integrator on the Cornell box at 16x16 (one
    mutation step of 1024 chains; two ERPT seeds a pixel with 4 steps; two
    SPPM passes of 8192 photons; 8192 photons and two samples of the
    photon mapper): two calls on the card give the same image bit for bit
    (every splat in an order fixed by the data), and the card's image mean
    is the CPU's within 1e-3 (a chain's acceptance may flip where the card
    rounds a transcendental apart, so only the photon maps are held pixel
    by pixel, with the parity tests' bars)."""
    from mitsuba_path_guiding_torch.integrators import erpt, mlt, photonmapper, pssmlt, sppm
    from mitsuba_path_guiding_torch.integrators.render import RenderConfig

    fn, kw = {"pssmlt": (pssmlt.render_pssmlt, {"n_chains": 1024}),
              "mlt": (mlt.render_mlt, {"n_chains": 1024}),
              "erpt": (erpt.render_erpt, {"chain_length": 4}),
              "sppm": (sppm.render_sppm, {"n_iterations": 2, "photons_per_iter": 8192}),
              "photonmapper": (photonmapper.render_photonmapper, {"n_photons": 8192})}[integrator]
    cfg = RenderConfig(width=16, height=16, spp=4 if integrator in ("pssmlt", "mlt") else 2,
                       max_depth=4, seed=2)
    img = fn(card, cfg, **kw)
    assert torch.equal(fn(card, cfg, **kw), img)
    want = fn(build_scene(cornell_box(), device="cpu"), cfg, **kw)
    if integrator in ("sppm", "photonmapper"):
        _image_close(img, want)
    else:
        assert abs(float(img.mean()) / float(want.mean()) - 1.0) < 1e-3


def test_photon_gather_on_the_card_equals_the_cpus(card):
    """SPPM's sorted-grid gather of 32768 photons at 4096 hitpoints on the
    card: the photon order bit-equal, the counts equal and the binned flux
    within rtol 1e-4 on >= 99.9% of hitpoints (atan2 and the sums' inputs
    round apart)."""
    from mitsuba_path_guiding_torch.core import rng
    from mitsuba_path_guiding_torch.integrators import sppm

    out = []
    for dev in ("cuda", "cpu"):
        sc = card if dev == "cuda" else build_scene(cornell_box(), device="cpu")
        ids = torch.arange(32768, device=dev) + (1 << 24)
        rk = rng.ray_keys(rng.base_key(0, device=dev), ids, torch.zeros_like(ids))
        ph = sppm.photon_pass(sc, rk, max_depth=4)
        lo, inv_cell, G = sppm.grid_params(sc, 0.1)
        sp = sppm.sort_photons(*ph[:4], lo, inv_cell, G)
        hp = ph[0][:4096].contiguous()
        ns = torch.nn.functional.normalize(-ph[1][:4096], dim=-1)
        out.append((sp, sppm.gather_sorted(sp, hp, ns, torch.full((4096,), 0.05, device=dev),
                                           lo, inv_cell, G)))
    (sp_c, got), (sp_p, want) = out
    assert torch.equal(sp_c.keys.cpu(), sp_p.keys)
    assert torch.equal(got[0].cpu(), want[0])
    close = torch.isclose(got[1].cpu(), want[1], rtol=1e-4, atol=1e-7).reshape(4096, -1).all(-1)
    assert float(close.float().mean()) >= 0.999
