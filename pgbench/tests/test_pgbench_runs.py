"""Runs of the harness on the CPU at tiny sizes: the result line's shape,
a sound run's checks passing, and each fault a cell can have, planted in
the timed path underneath the harness, turning ``correct`` false.  The
harness's look for a card is skipped (``device="cpu"``); run.py itself
refuses to run without one."""
import json
import os
import subprocess
import sys

import pytest
import torch

from pgbench.harness.runner import judge, run_cell

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TINY = {
    "cornell.guided.1080p": {"width": 32, "height": 18,
                             "check_params": {"image": {"blocks": [1, 1], "passes": 16}}},
    "cornell.path.1080p": {"width": 32, "height": 18,
                           "check_params": {"image": {"blocks": [1, 1], "passes": 16}}},
}
SEED = 4294967311 + 12345


def _run(cell, trace=False):
    result, compared, _ = run_cell(cell, SEED, 0.05, trace=trace, device="cpu",
                                   overrides=TINY[cell])
    return result, {n: (v, lim) for n, v, lim in compared}


@pytest.mark.parametrize("cell", list(TINY))
def test_control_comes_out_not_correct(cell):
    """The control (the reference in bfloat16 in the program's place),
    judged under the cell's own limits by the harness's own verdict."""
    result, compared, ctrl = run_cell(cell, SEED, 0.05, device="cpu", overrides=TINY[cell],
                                      control=True)
    limits = {n: lim for n, _, lim in compared}
    assert set(ctrl) == set(limits)
    assert not judge(ctrl, limits), ctrl


def test_result_line_shape():
    result, compared = _run("cornell.path.1080p")
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert set(result["metrics"]) == {"samples_per_s", "time_to_noise_s", "frame_p95_ms",
                                      "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["checks"]) == set(compared) == {"scene_gap", "image_gap"}
    json.dumps(result)


def test_traced_line_has_the_cells_layer_metrics():
    result, _ = _run("cornell.guided.1080p", trace=True)
    assert {"progression_ms", "fit_ms", "trace_host_ms"} <= set(result["metrics"])
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", list(TINY))
def test_sound_run_passes_its_checks(cell):
    result, compared = _run(cell)
    for n, (v, lim) in compared.items():
        if n != "image_gap":   # a tiny image is too noisy for the cell's limit
            assert v <= lim, (n, v, lim)


def _alter_hits(monkeypatch):
    from mitsuba_path_guiding_torch.integrators import path

    orig = path.route_queries

    def route_queries(scene, accel, use_bvh=False):
        intersect, occluded = orig(scene, accel, use_bvh)

        def altered(o, d, tmax, *a, **kw):
            hit = intersect(o, d, tmax, *a, **kw)
            return hit._replace(t=hit.t * 1.01)
        return altered, occluded
    monkeypatch.setattr(path, "route_queries", route_queries)


def _state_unchanged(monkeypatch):
    from mitsuba_path_guiding_torch.integrators import progressive

    monkeypatch.setattr(progressive, "update_grid", lambda grid, *a, **k: grid)


def _half_batch(monkeypatch):
    from mitsuba_path_guiding_torch.integrators import progressive, render

    def half(module):
        orig = module.splat

        def splat(rgbw, film_xy, values, *a, **kw):
            n = film_xy.shape[0] // 2
            return orig(rgbw, film_xy[:n], values[:n], *a, **kw)
        monkeypatch.setattr(module, "splat", splat)
    half(progressive)
    half(render)


def _alter_radiance(monkeypatch):
    from mitsuba_path_guiding_torch.integrators import progressive, render

    for module in (progressive, render):
        orig = module.splat
        monkeypatch.setattr(module, "splat", lambda rgbw, xy, v, *a, _o=orig, **k:
                            _o(rgbw, xy, v * 1.5, *a, **k))


FAULTS = [
    ("cornell.guided.1080p", _alter_hits, "hit_t_share"),
    ("cornell.guided.1080p", _state_unchanged, "grid_gap"),
    ("cornell.guided.1080p", _half_batch, "film_weight_gap"),
    ("cornell.guided.1080p", _alter_radiance, "image_gap"),
    ("cornell.path.1080p", _half_batch, "image_gap"),
    ("cornell.path.1080p", _alter_radiance, "image_gap"),
]


@pytest.mark.parametrize("cell,fault,number", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f, _ in FAULTS])
def test_fault_turns_correct_false(monkeypatch, cell, fault, number):
    fault(monkeypatch)
    result, compared = _run(cell)
    assert not result["correct"]
    v, lim = compared[number]
    assert not v <= lim, (number, v, lim)


def test_run_py_without_a_card_prints_no_result():
    proc = subprocess.run([sys.executable, "pgbench/run.py", "--workload", "cornell.path.1080p",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_run_py_without_the_program_fails(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "pgbench"), tmp_path / "pgbench")
    proc = subprocess.run([sys.executable, "pgbench/run.py", "--workload", "cornell.path.1080p",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_roofline_work_is_the_references_count():
    """The fused kernel's work comes from the reference's queries a path,
    not from the kernel's own counts; without them no share is read."""
    from types import SimpleNamespace

    from pgbench.harness.peaks import FP32_FLOPS, MT_FLOPS
    from pgbench.metrics import frame_mfu, fused_roofline

    trace = SimpleNamespace(time_of=lambda p: 2e-3 if p.search("trace_fused_kernel") else 0.0)
    run = SimpleNamespace(trace=trace, trace_samples=8294400, work={"queries_per_path": 2.5},
                          n_tri=36, trace_unit_s=0.2, entry="frames")
    flops = 8294400 * 2.5 * 36 * MT_FLOPS
    assert fused_roofline.read(run) == pytest.approx(flops / FP32_FLOPS / 2e-3 * 100)
    assert frame_mfu.read(run) == pytest.approx(flops / FP32_FLOPS / 0.2 * 100)
    assert fused_roofline.read(SimpleNamespace(**{**vars(run), "work": {}})) is None
