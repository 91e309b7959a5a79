"""The port's spans and host-read counter (``utils/stats.py``): nothing is
recorded with tracing off; inside ``tracing()`` (or a torch profiler) a
progression and a frame give their exact span trees, on the profiler's
clock too; the scene's host reads are counted by site; the render
statistics stay on the device until read; the module attributes the
benchmark hooks still reach the calls; and a traced run of each
benchmark cell reports the metrics that read the spans.  The last test
holds the counter to the card's sync debug mode and skips without a card."""
import collections
import json
import os
import warnings

import pytest
import torch

from mitsuba_path_guiding_torch.integrators import path as path_mod
from mitsuba_path_guiding_torch.integrators import progressive as prog_mod
from mitsuba_path_guiding_torch.integrators.progressive import (
    ProgressiveConfig,
    ProgressiveRenderer,
)
from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render
from mitsuba_path_guiding_torch.scene.builder import build_scene
from mitsuba_path_guiding_torch.scene.scenes import cornell_box
from mitsuba_path_guiding_torch.utils import stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH = 3
SPP = 2
STAGES = ("intersect", "shade", "nee", "sample")
SCENE_READS = {"emitter.kinds_present": 1, "bsdf.types_present": 1, "render.textured": 1,
               "render.bumped": 1, "render.clothed": 1}
# the benchmark's cells at the sizes of pgbench/tests/test_pgbench_runs.py
TINY = {"width": 32, "height": 18, "check_params": {"image": {"blocks": [1, 1], "passes": 16}}}
BENCH_SEED = 4294967311 + 12345
# the benchmark's metrics that read the program's spans and counter
PROGRAM_METRICS = ("keys_ms", "splat_ms", "fit_device_ms", "bounce_intersect_ms",
                   "bounce_shade_ms", "bounce_nee_ms", "bounce_sample_ms", "host_syncs_per_wave")


@pytest.fixture(scope="module")
def scene():
    return build_scene(cornell_box(), device="cpu")


def _cfg(batch=24):
    # 8x6 pixels in waves of ``batch``: two batches a pass
    return RenderConfig(width=8, height=6, spp=SPP, max_depth=DEPTH, rr_depth=DEPTH,
                        pixel_batch=batch, seed=7)


def _renderer(scene, batch=24):
    return ProgressiveRenderer(scene, ProgressiveConfig(
        render=_cfg(batch), samples_per_progression=SPP, grid_res=4, n_lobes=2))


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder in the module's place."""
    rec = stats.Recorder()
    monkeypatch.setattr(stats, "RECORDER", rec)
    return rec


def _children(recs, i):
    return [r for r in recs if r.parent == i]


def _check_nesting(recs):
    """Every child's host interval lies inside its parent's, and every
    record carries its unit's number."""
    for r in recs:
        assert r.host_start_ns <= r.host_end_ns
        if r.parent is not None:
            p = recs[r.parent]
            assert p.host_start_ns <= r.host_start_ns and r.host_end_ns <= p.host_end_ns
            assert r.unit == p.unit
        assert r.device_ms >= 0.0


def _check_wave(recs, w, leaf):
    """A wave's span tree: its ``keys``, the tracer ``leaf`` with one
    ``keys`` and the four stages a depth (depths 0..DEPTH-1), its splat."""
    kids = _children(recs, w)
    assert [r.name for r in kids] == ["keys", leaf, "splat"]
    trace = recs.index(kids[1])
    inner = _children(recs, trace)
    assert [r.name for r in inner] == ["keys", *STAGES] * DEPTH
    for name in ("keys",) + STAGES:
        assert [r.depth for r in inner if r.name == name] == list(range(DEPTH))
    wave_index = recs[w].wave
    assert all(r.wave == wave_index for r in kids + inner)
    assert sum(r.name == "keys" for r in kids + inner) == DEPTH + 1


def test_off_records_nothing(scene, recorder):
    """No profiler recording and no ``tracing()``: a guided progression and
    a frame leave no record, count no host read, and each span site hands
    back the one shared null context."""
    assert stats.span("wave") is stats._OFF
    _renderer(scene).run_progression()
    render(scene, _cfg())
    assert recorder.records() == [] and not recorder.host_reads and recorder.dropped == 0


def test_progression_span_tree(scene, recorder):
    """One progression of 2 spp in 2 batches: one ``progression``, four
    ``wave``s (each: keys, trace with keys and four stages a depth, splat)
    and one ``fit``; one unit; children inside their parents."""
    ren = _renderer(scene)
    with stats.tracing():
        ren.run_progression()
    recs = recorder.records()
    counts = collections.Counter(r.name for r in recs)
    assert counts == {"progression": 1, "wave": 4, "splat": 4, "trace": 4,
                      "keys": 4 * (DEPTH + 1), "fit": 1,
                      **{s: 4 * DEPTH for s in STAGES}}
    assert recs[0].name == "progression" and recs[0].parent is None
    assert {r.unit for r in recs} == {0}
    top = [r.name for r in _children(recs, 0)]
    assert top == ["wave"] * 4 + ["fit"]
    waves = [i for i, r in enumerate(recs) if r.name == "wave"]
    assert [recs[i].wave for i in waves] == [0, 1, 2, 3]
    for w in waves:
        _check_wave(recs, w, "trace")
    assert recs[0].wave is None and recs[-1].name == "fit" and recs[-1].wave is None
    _check_nesting(recs)
    assert not recorder.host_reads


def test_frame_span_tree(scene, recorder):
    """A frame of ``render()`` on the CPU: the fused kernel's gate is
    closed off the card, so each wave takes the wavefront ``trace``."""
    with stats.tracing():
        render(scene, _cfg())
    recs = recorder.records()
    assert recs[0].name == "frame" and recs[0].parent is None
    waves = [i for i, r in enumerate(recs) if r.name == "wave"]
    assert [r.name for r in _children(recs, 0)] == ["wave"] * 4 == [recs[i].name for i in waves]
    for w in waves:
        _check_wave(recs, w, "trace")
    assert not any(r.name == "trace_fused" for r in recs)
    _check_nesting(recs)


def test_units_number_and_stretches_replace(scene, recorder):
    """Two frames in one stretch are units 0 and 1; a new stretch replaces
    the records and restarts the numbering."""
    with stats.tracing():
        render(scene, _cfg(48))
        render(scene, _cfg(48))
    recs = recorder.records()
    assert [r.unit for r in recs if r.name == "frame"] == [0, 1]
    assert sum(r.name == "wave" for r in recs) == 2 * SPP
    with stats.tracing():
        render(scene, _cfg(48))
    recs = recorder.records()
    assert [r.name for r in recs].count("frame") == 1 and {r.unit for r in recs} == {0}
    assert recorder.host_reads == SCENE_READS


def test_profiler_sees_the_ranges_on_its_clock(scene, recorder):
    """Under a CPU torch profiler the spans record without ``tracing()``,
    and each appears as an ``mpg/<name>`` host event, nested as the records
    are."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render(scene, _cfg())
    recs = recorder.records()
    events = [e for e in prof.events() if e.name.startswith("mpg/")]
    assert all(e.device_type == DeviceType.CPU for e in events)
    assert (collections.Counter(e.name[4:] for e in events)
            == collections.Counter(r.name for r in recs))

    # the i-th range to open is the i-th record
    events.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
    assert [e.name[4:] for e in events] == [r.name for r in recs]
    for e, r in zip(events, recs):
        if r.parent is not None:
            p = events[r.parent].time_range
            assert p.start <= e.time_range.start and e.time_range.end <= p.end


def test_host_reads_by_site(scene, recorder):
    """A frame reads the scene's emitter kinds, BSDF types and three
    texture flags, once each; a progression reads nothing."""
    with stats.tracing():
        render(scene, _cfg())
    assert recorder.host_reads == SCENE_READS
    ren = _renderer(scene)
    with stats.tracing():
        ren.run_progression()
    assert not recorder.host_reads


def test_span_cap_counts_what_it_drops(scene, recorder, monkeypatch):
    monkeypatch.setattr(stats, "SPAN_CAP", 10)
    with stats.tracing():
        render(scene, _cfg())
    recs = recorder.records()
    assert len(recs) == 10
    assert recorder.dropped == 1 + 4 * (3 + 1 + 5 * DEPTH) - 10
    _check_nesting(recs)


def test_registry_device_values_read_as_host_values():
    """``add`` and ``average`` of 0-d device tensors give the ``get`` and
    ``report`` of the same values fed as host numbers, exactly, past a
    fold of the held values."""
    host, device = stats.StatsRegistry(), stats.StatsRegistry()
    for i in range(stats.FOLD_EVERY + 3):
        seg = 12_345_678_901 + 7 * i
        for reg, v in ((host, seg), (device, torch.tensor(seg))):
            reg.add("samples", 4096)
            reg.add("rays traced", v * 2)
            reg.average("avg path length", v, 4096)
    for name in ("samples", "rays traced", "avg path length"):
        assert device.get(name) == host.get(name)
    assert device.report().splitlines()[:-2] == host.report().splitlines()[:-2]
    device.reset()
    assert device.get("rays traced") == 0.0


def test_progression_keeps_its_statistics_on_the_device(scene):
    """A progression's segment count stays a device tensor until ``get``,
    which reads the values the report prints."""
    ren = _renderer(scene)
    ren.run_progression()
    ren.run_progression()
    held = ren.stats._device[("add", "rays traced")]
    assert len(held) == 2 and all(torch.is_tensor(t) for t in held)
    n = 2 * SPP * 48
    assert ren.stats.get("samples") == n
    rays = ren.stats.get("rays traced")
    assert rays == float(int(rays)) and rays == 2 * ren.stats.get("avg path length") * n
    assert "rays traced" in ren.stats.report()


def test_benchmark_hooks_are_still_called(scene, monkeypatch):
    """The module attributes that a benchmark replaces are looked up at
    call time: ``progressive.trace``, ``accumulate_stats``,
    ``update_grid`` and ``path.route_queries``."""
    calls = collections.Counter()

    def counted(mod, name):
        orig = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return orig(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    for mod, name in ((prog_mod, "trace"), (prog_mod, "accumulate_stats"),
                      (prog_mod, "update_grid"), (path_mod, "route_queries")):
        counted(mod, name)
    with stats.tracing():
        _renderer(scene).run_progression()
    assert calls == {"trace": 4, "accumulate_stats": 4, "update_grid": 1, "route_queries": 4}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell", ["cornell.guided.1080p", "cornell.path.1080p"])
def test_traced_cell_reports_the_program_metrics(cell):
    """A traced run of each cell on the CPU reports every metric that reads
    the program's spans and counter where BENCHMARK.json lists the cell,
    and none elsewhere; ``idle_in_program``, like ``device_idle``, needs
    device events and is left out on the CPU."""
    from pgbench.harness.runner import run_cell

    result, _, _ = run_cell(cell, BENCH_SEED, 0.05, trace=True, device="cpu", overrides=TINY)
    got = result["metrics"]
    program = [m for m in _bench()["per_layer"] if m["name"] in PROGRAM_METRICS]
    assert len(program) == len(PROGRAM_METRICS)
    for m in program:
        assert (m["name"] in got) == (cell in m["workloads"]), m["name"]
    assert "idle_in_program" not in got and "device_idle" not in got
    assert got["host_syncs_per_wave"]["value"] == (1.25 if cell == "cornell.path.1080p" else 0.0)
    assert result["correct"]


@pytest.mark.cuda
def test_host_reads_equal_the_cards_syncs():
    """On the card: the counted host reads of a guided progression and of
    a frame equal the synchronisations torch's sync debug mode reports
    over the same units."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the kernels are CUDA C++ for sm_90a)")
    from mitsuba_path_guiding_torch.ops import build

    build.build_all()
    card = build_scene(cornell_box(), device="cuda")
    cfg = RenderConfig(width=64, height=64, spp=2, max_depth=DEPTH, pixel_batch=2048, seed=3)
    ren = ProgressiveRenderer(card, ProgressiveConfig(render=cfg, samples_per_progression=2,
                                                      grid_res=4, n_lobes=2))
    for unit in (ren.run_progression, lambda: render(card, cfg)):
        unit()
        torch.cuda.synchronize()
        with stats.tracing(), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                unit()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        # the mode's own notice on setting it is no synchronisation
        syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
        assert len(syncs) == sum(stats.RECORDER.host_reads.values())
