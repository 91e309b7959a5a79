"""The port's multi-GPU renderer (``parallel/mesh.py``) on gloo ranks on
the CPU, against the JAX package's ``render_sharded`` on a 2-device mesh.

One spawn of three gloo ranks (``torch_sharded_ranks.job_cornell``)
renders the unguided 16x16 x 4 spp Cornell box at world sizes 1, 2 and 3
(the subgroups of ranks [0] and [0, 1], and the world), and at world size
2 the merged statistics of a guided wave, a guided render twice and the
checkpoint-resume recipe.  The unguided images are bit-equal across world
sizes (every pixel takes its samples on one rank), except pixel 0 at
world size 3, which takes duplicate samples from the padding (rel 1e-6);
each is within atol = rtol = 1e-5 of JAX's; the merged statistics are
within rtol 1e-5 (atol 1e-6 of the field's scale) of one rank's over the
whole wave; the guided render repeats bit for bit with equal grids on both
ranks; the collectives are one film merge and one stats merge per
``fit_every`` waves, none per wave; the resumed render is within 2e-5 of
the straight one.  The twins of the JAX package's slow sharding tests
(door_room's pair route, the 1080p banded and the volume steps of
``__graft_entry__.dryrun_multichip``, guided training) spawn chip_smoke's
rank jobs at world size 2 and are ``slow``.
"""
import jax
import numpy as np
import pytest
import torch

import chip_smoke
from mitsuba_path_guiding_torch.guiding.fit import accumulate_stats, fit_from_records, update_grid
from mitsuba_path_guiding_torch.guiding.grid import make_grid
from mitsuba_path_guiding_torch.guiding.sampler import make_guide_fn
from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
from mitsuba_path_guiding_torch.models.bsdf import types_present
from mitsuba_path_guiding_torch.parallel import mesh as pm
from mitsuba_path_guiding_tpu.integrators.render import RenderConfig as JRenderConfig
from mitsuba_path_guiding_tpu.parallel.mesh import make_device_mesh as j_make_device_mesh
from mitsuba_path_guiding_tpu.parallel.mesh import render_sharded as j_render_sharded
from mitsuba_path_guiding_tpu.scene.builder import build_scene as j_build_scene
from mitsuba_path_guiding_tpu.scene.scenes import cornell_box
from torch_port_parity import port_scene
from torch_sharded_ranks import spawn_ranks

W = H = 16
SPP = 4
DEPTH = 4
GUIDED_SPP = 8
FIT_EVERY = 4


@pytest.fixture(scope="module")
def jax_scene():
    return j_build_scene(cornell_box())


@pytest.fixture(scope="module")
def jax_sharded(jax_scene):
    img, _, seg = j_render_sharded(jax_scene, JRenderConfig(width=W, height=H, spp=SPP,
                                                            max_depth=DEPTH, seed=0),
                                   j_make_device_mesh(jax.devices()[:2]))
    return np.asarray(img), seg


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks("cornell", 3, str(tmp_path_factory.mktemp("ranks")), width=W, height=H,
                       spp=SPP, max_depth=DEPTH, guided_spp=GUIDED_SPP, fit_every=FIT_EVERY)


def test_unguided_bit_equal_across_world_sizes(ranks):
    one = ranks[0]["img_ws1"]
    for ws in (2, 3):
        for r in range(ws):
            img = ranks[r][f"img_ws{ws}"]
            assert ranks[r][f"seg_ws{ws}"] == ranks[0]["seg_ws1"]
            if ws == 3:
                # pixel 0 takes the padding's duplicate samples
                np.testing.assert_allclose(img[0, 0], one[0, 0], rtol=1e-6, atol=0)
                img, ref = img.reshape(-1, 3)[1:], one.reshape(-1, 3)[1:]
            else:
                ref = one
            np.testing.assert_array_equal(img, ref, err_msg=f"world size {ws}, rank {r}")


def test_unguided_matches_jax_render_sharded(ranks, jax_sharded):
    want, seg = jax_sharded
    for ws in (1, 2, 3):
        got = ranks[0][f"img_ws{ws}"]
        assert np.isfinite(got).all() and got.mean() > 0
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=f"world size {ws}")
        assert int(ranks[0][f"seg_ws{ws}"]) == int(seg)


def test_merge_stats_equals_one_rank(ranks):
    for r in range(2):
        for i in range(6):
            got, want = ranks[r][f"stats_merged{i}"], ranks[r][f"stats_whole{i}"]
            assert np.abs(want).max() > 0
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max(),
                                       err_msg=f"statistic {i}, rank {r}")
        # fit_from_records with the mesh: the merged sums' update
        for f in ("mu", "kappa", "log_weight", "valid", "s_count"):
            np.testing.assert_array_equal(ranks[r][f"fit_mesh_grid_{f}"],
                                          ranks[r][f"fit_merged_grid_{f}"])


def test_guided_repeats_and_grids_equal_on_ranks(ranks):
    r0, r1 = ranks[0], ranks[1]
    assert np.isfinite(r0["guided_img0"]).all() and r0["guided_img0"].mean() > 0
    for r in (r0, r1):
        np.testing.assert_array_equal(r["guided_img0"], r["guided_img1"])
        assert r["guided_seg0"] == r["guided_seg1"]
    np.testing.assert_array_equal(r0["guided_img0"], r1["guided_img0"])
    keys = [k for k in r0 if k.startswith("guided_grid0_")]
    assert "guided_grid0_grid_mu" in keys and r0["guided_grid0_grid_valid"].sum() > 0
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        np.testing.assert_array_equal(r0[k], r0[k.replace("grid0", "grid1")], err_msg=k)


def test_collectives_once_per_progression(ranks):
    """One film merge, one stats merge per FIT_EVERY waves, none a wave;
    each rank receives the world's buffers."""
    for ws in (1, 2, 3):
        # (film merges, stats merges, all-gathers): no collective at world size 1
        assert ranks[0][f"collectives_ws{ws}"].tolist() == [1, 0, 0 if ws == 1 else 1]
    n_fit = -(-GUIDED_SPP // FIT_EVERY)
    grid = make_grid(np.zeros(3, np.float32), np.ones(3, np.float32), res=4, n_lobes=4,
                     device="cpu")
    stats_bytes = sum(x.numel() * 4 for x in (grid.s_w, grid.s_dir, grid.s_count, grid.s_rho,
                                              grid.s_pos, grid.s_pos_w))
    film_bytes = W * H * 4 * 4 + 8  # the film and the segment count
    for r in range(2):
        for run in range(2):
            film, stats, gathers, nbytes = ranks[r][f"guided_collectives{run}"].tolist()
            assert (film, stats, gathers) == (1, n_fit, 1 + n_fit) and gathers < GUIDED_SPP
            assert nbytes == 2 * (film_bytes + n_fit * stats_bytes)


def test_checkpoint_resume_twin(ranks):
    for r in range(2):
        np.testing.assert_allclose(ranks[r]["ckpt_combined"], ranks[r]["ckpt_straight"],
                                   atol=2e-5, rtol=2e-5)


def test_world_size_one_without_a_group(jax_scene):
    """No process group: world size 1 on the given device, and the same
    image as render() (the same samples; the JAX test's bar)."""
    scene = port_scene(jax_scene)
    m = pm.make_device_mesh("cpu")
    assert (m.rank, m.world_size, m.device.type, m.group) == (0, 1, "cpu", None)
    cfg = RenderConfig(width=W, height=H, spp=2, max_depth=3, seed=1)
    img, grid, seg = pm.render_sharded(scene, cfg, m)
    assert grid is None and seg > W * H
    np.testing.assert_allclose(img.numpy(), render(scene, cfg).numpy(), atol=1e-5, rtol=1e-5)
    step = pm.make_sharded_step(scene, cfg, m._replace(world_size=3))
    with pytest.raises(ValueError, match="do not divide"):
        step(torch.arange(W * H), torch.zeros(W * H, dtype=torch.int64),
             pm.init_sharded_film(cfg, m), None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pm.make_device_mesh()


def test_fit_from_records_takes_a_mesh(jax_scene):
    """At world size 1 the mesh changes nothing."""
    scene = port_scene(jax_scene)
    cfg = RenderConfig(width=W, height=H, spp=1, max_depth=3, seed=0)
    m = pm.make_device_mesh("cpu")
    guide = make_guide_fn(0.5, mat_types=types_present(scene.mats))
    grid = make_grid(scene.aabb_min, scene.aabb_max, res=4, n_lobes=4, device="cpu")
    pix = torch.arange(W * H)
    _, _, _, rec = pm._wave_local(scene, cfg, False, guide, grid, pix, torch.zeros_like(pix))
    a = fit_from_records(grid, rec, m)
    b = update_grid(grid, *accumulate_stats(grid, rec))
    for f in ("mu", "kappa", "log_weight", "valid", "s_w", "s_dir", "s_count"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---- twins of the JAX package's slow sharding tests (world size 2)

def _dryrun(tmp_path, **kw):
    return chip_smoke.spawn_ranks("chip_smoke:job_sharded_dryrun", 2, str(tmp_path),
                                  backend="gloo", device="cpu", **kw)


@pytest.mark.slow
def test_sharded_pairs_accel_big_scene_twin(tmp_path):
    """door_room(120000) at 16x16, depth 2, through the pair route: one
    rank and two ranks give the same film."""
    out = _dryrun(tmp_path, steps=("door_room_small",))
    for r in out:
        film1, film2 = r["door_room_small_film_ws1"], r["door_room_small_film_ws2"]
        assert np.isfinite(film2).all() and film2[:, 3].sum() > 0
        np.testing.assert_allclose(film1, film2, rtol=1e-5, atol=1e-6)


@pytest.mark.slow
def test_sharded_guided_pairs_at_scale_twin(tmp_path):
    out = _dryrun(tmp_path, steps=("door_room",))
    for r in out:
        film = r["door_room_film"]
        assert np.isfinite(film).all()
        assert float(film[:, 3].sum()) == 128 * 128
        assert int(r["door_room_seg"]) > 128 * 128
        assert float(r["door_room_grid_count"]) > 0


@pytest.mark.slow
def test_dryrun_banded_and_volume_twin(tmp_path):
    out = _dryrun(tmp_path, steps=("banded_1080p", "volume"))
    for r in out:
        assert bool(r["banded_1080p_finite"]) and int(r["banded_1080p_seg"]) > 0
        assert float(r["volume_film_weight"]) > 0 and bool(r["volume_finite"])
        assert bool(r["volume_grid_finite"]) and float(r["volume_grid_count"]) > 0


@pytest.mark.slow
def test_sharded_guided_training_twin(tmp_path):
    """24x24 x 16 spp guided at world size 2 (fit every 8), within 8% of
    an unguided render() of another seed (the JAX test's bar)."""
    out = chip_smoke.spawn_ranks("chip_smoke:job_sharded_cornell", 2, str(tmp_path),
                                 backend="gloo", device="cpu", width=24, height=24, spp=16,
                                 depth=4, guided=True, fit_every=8, repeats=1)
    scene = port_scene(j_build_scene(cornell_box()))
    ref = render(scene, RenderConfig(width=24, height=24, spp=16, max_depth=4, seed=4)).numpy()
    img = out[0]["img0"][0]
    assert np.isfinite(img).all() and int(out[0]["grid0_grid_valid"].sum()) > 0
    assert abs(float(img.mean()) - ref.mean()) / ref.mean() < 0.08
