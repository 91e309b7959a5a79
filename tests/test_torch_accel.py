"""The port's BVH, blocklist and pair tables against the JAX package's: the
same triangles give the same tree and bit-equal tables (the pair table's
bf16 box table compared as float32)."""
import numpy as np
import pytest

from mitsuba_path_guiding_torch.accel.blocks import build_blocklist
from mitsuba_path_guiding_torch.accel.bvh import build_bvh
from mitsuba_path_guiding_torch.accel.pairs import build_pair_table
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.scenes import door_room
from mitsuba_path_guiding_tpu.accel.blocks import build_blocklist as j_build_blocklist
from mitsuba_path_guiding_tpu.accel.bvh import build_bvh as j_build_bvh
from mitsuba_path_guiding_tpu.accel.pairs import build_pair_table as j_build_pair_table
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from mitsuba_path_guiding_tpu.scene.scenes import door_room as j_door_room


def _soup(seed, t, spread=4.0, size=0.3):
    rs = np.random.default_rng(seed)
    p0 = (rs.random((t, 3)).astype(np.float32) - 0.5) * spread
    e1 = (rs.random((t, 3)).astype(np.float32) - 0.5) * size
    e2 = (rs.random((t, 3)).astype(np.float32) - 0.5) * size
    return p0, e1, e2


def _equal(port, ref, what):
    """Every field of a port table (numpy or tensor) equals the JAX one;
    the port's own layouts (``PORT_ONLY``, the BVH's packed walk) have no
    JAX counterpart."""
    for f in port._fields:
        if f in getattr(port, "PORT_ONLY", ()):
            continue
        a, b = getattr(port, f), getattr(ref, f)
        if isinstance(a, int):
            assert a == b, f"{what}.{f}"
            continue
        a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
        b = np.asarray(b).astype(np.float32) if f == "tblT" else np.asarray(b)
        assert a.shape == b.shape, (what, f, a.shape, b.shape)
        assert a.dtype == b.dtype, (what, f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}.{f}")


@pytest.fixture(scope="module")
def door_room_scenes():
    return build_scene(door_room(20000), device="cpu"), j_build_scene(j_door_room(20000))


def test_soup_tables_are_bit_equal():
    p0, e1, e2 = _soup(7, 3000)
    bvh, jbvh = build_bvh(p0, e1, e2), j_build_bvh(p0, e1, e2)
    _equal(bvh, jbvh, "bvh")
    _equal(build_blocklist(p0, e1, e2, bvh), j_build_blocklist(p0, e1, e2, jbvh), "blocks")
    _equal(build_pair_table(p0, e1, e2, bvh), j_build_pair_table(p0, e1, e2, jbvh), "pairs")


@pytest.mark.parametrize("t", [1, 4, 5, 400])
def test_small_soup_trees_are_bit_equal(t):
    """A single leaf, a full leaf, the first split and a few hundred
    triangles."""
    p0, e1, e2 = _soup(3, t)
    _equal(build_bvh(p0, e1, e2), j_build_bvh(p0, e1, e2), "bvh")


@pytest.mark.parametrize("field", ["bvh", "blocks", "pairs"])
def test_door_room_tables_are_bit_equal(door_room_scenes, field):
    port, ref = door_room_scenes
    assert port.geo.p0.shape[0] == 17510
    _equal(getattr(port, field), getattr(ref, field), field)


def test_door_room_table_shapes(door_room_scenes):
    port, _ = door_room_scenes
    assert port.pairs.tri_rows.shape[0] == 288 and port.pairs.sb_lo.shape[0] == 9
    assert port.blocks.sb_lo.shape[0] == 7
    assert port.pairs.sb_blk == 32 and port.pairs.leaf == 128
