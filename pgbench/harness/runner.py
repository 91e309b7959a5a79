"""One run of one cell: set-up (the program's scene and renderer, one
warm-up unit of the cell's own shapes), a window of whole units of work
for at least the seconds asked (an even count, for the two half-images),
then, with the program's state freed, the reference's checks of what the
window produced, and the metrics.  ``run_cell`` returns the result line
as a dict and the compared numbers; the command line is run.py."""
import gc
import sys
import time
from types import SimpleNamespace

import torch

from pgbench.harness import noise, spec
from pgbench.harness.probes import Probes
from pgbench.harness.profiling import WindowProfiler
from pgbench.reference.scene import compile_scene

FORBIDDEN = ("jax", "jaxlib", "flax", "mitsuba_path_guiding_tpu")
TRACED_S = 2.0


def forbidden_modules():
    """Top-level names of loaded modules that a run may not hold,
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_name(device):
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def judge(readings, limits):
    """``correct`` of a set of readings: every number within its limit
    (a NaN compares false)."""
    return all(readings[n] <= lim for n, lim in limits.items())


class _BuildClock:
    """Seconds that the port spends building its CUDA kernels (nvcc, only
    where a checkout has not built them yet), counted inside set-up and
    reported apart in ``setup_parts``."""

    def __init__(self):
        self.seconds = 0.0
        self._saved = None

    def install(self):
        from mitsuba_path_guiding_torch.ops import build

        orig = build.build_all

        def build_all(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
        self._saved = (build, orig)
        build.build_all = build_all
        return self

    def uninstall(self):
        if self._saved is not None:
            build, orig = self._saved
            build.build_all = orig
            self._saved = None


def build_program_scene(cell, device, overrides=None):
    from mitsuba_path_guiding_torch.scene.builder import build_scene

    desc = spec.scene_description(cell, (overrides or {}).get("scene_params"))
    return desc, build_scene(desc, device=device)


def run_cell(name, seed, seconds, trace=False, device=None, overrides=None, prebuilt=None,
             control=False, t_start=None):
    """Run cell ``name``.  ``overrides`` (tests): width, height,
    scene_params, check params.  ``prebuilt``: (description, scene) made
    by ``build_program_scene`` for this cell.  ``control``: work out the
    control's readings beside the program's.  Returns
    (result dict, [(number, value, limit)], control readings or None);
    ``judge`` gives the control's verdict under the same limits."""
    t_start = time.perf_counter() if t_start is None else t_start
    overrides = overrides or {}
    cell = spec.load_cell(name)
    device = torch.device("cuda") if device is None else torch.device(device)
    checks = cell.workload["checks"]
    ctx = SimpleNamespace(cell=cell, seed=int(seed), device=device,
                          width=int(overrides.get("width", cell.config["width"])),
                          height=int(overrides.get("height", cell.config["height"])),
                          compiled=None, work={})
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    # set-up: the program's scene and renderer, and one warm-up unit
    parts = {"start": time.perf_counter() - t_start}
    torch.zeros(1, device=device)
    _sync(device)
    parts["device"] = time.perf_counter() - t_start
    build_clock = _BuildClock().install()
    probes = Probes(device, seed, hits_per_call=int(checks.get("hits", {}).get(
        "params", {}).get("per_call", 0)), grid="grid" in checks, spans=trace)
    try:
        desc, scene = prebuilt if prebuilt is not None else build_program_scene(cell, device,
                                                                                overrides)
        _sync(device)
        parts["scene"] = time.perf_counter() - t_start
        entry = spec.module("entries", cell.traffic["entry"]).Entry(ctx, scene)
        probes.install()
        parts["renderer"] = time.perf_counter() - t_start
        entry.unit()
        _sync(device)
        build_clock.uninstall()
        probes.reset()
        setup_s = time.perf_counter() - t_start
        parts["warm_unit"] = setup_s
        # of set-up, the seconds spent building kernels (0 once built)
        parts["kernel_build_s"] = build_clock.seconds

        # the window: whole units, at least ``seconds`` of them, an even count.
        # A traced run profiles its first units (an even count, at least
        # TRACED_S of them) and parses the trace between two units, outside
        # every unit's time.
        entry.begin_window()
        unit_s, samples = [], 0
        prof = WindowProfiler(device) if trace else None
        traced = None
        if prof is not None:
            prof.start()
            t_tr = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            samples += entry.unit()
            t1 = time.perf_counter()
            unit_s.append(t1 - t0)
            entry.add_half((len(unit_s) - 1) % 2)
            done = sum(unit_s) >= seconds and len(unit_s) % 2 == 0
            if prof is not None and traced is None and len(unit_s) % 2 == 0 and (
                    sum(unit_s) >= TRACED_S or done):
                _sync(device)
                traced = dict(wall=time.perf_counter() - t_tr, units=len(unit_s),
                              samples=samples)
                probes.mark()
                traced["trace"] = prof.stop()
            if done:
                break
        peak = max_memory(device)
        relvar = noise.relvar_from_halves(*entry.half_images())
        out = entry.outputs()
        out["scene"] = {k: v.clone() for k, v in
                        spec.module("checks", "scene").program_side(scene).items()}
        out["hits"] = probes.hits()
        if "grid" in checks:
            out["grid"] = spec.module("checks", "grid").program_side(probes.grid_step)
    finally:
        probes.uninstall()
        build_clock.uninstall()
    spans = probes.spans_after_mark()
    waves_per_unit = entry.waves_per_unit
    entry.release()
    del entry, scene, probes
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference's checks, with the program's state freed
    ctx.compiled = compile_scene(desc)
    compared, control_readings = [], {} if control else None
    check_s = {}
    for check, body in checks.items():
        t0 = time.perf_counter()
        mod = spec.module("checks", check)
        params = dict(body.get("params", {}))
        params.update(overrides.get("check_params", {}).get(check, {}))
        for number, value in mod.readings(ctx, out, params).items():
            compared.append((number, value, float(body["limits"][number])))
        check_s[check] = time.perf_counter() - t0
        if control:
            control_readings.update(mod.readings(ctx, out, params, control=True))
    limits = {n: lim for n, _, lim in compared}
    correct = judge({n: v for n, v, _ in compared}, limits)

    window_s = float(sum(unit_s))
    # per-layer readers take the device numbers from the traced units and
    # the host numbers from the units after them (the profiler slows the host)
    n_tr = traced["units"] if traced else 0
    host_units = unit_s[n_tr:] if len(unit_s) - n_tr >= 2 else unit_s
    run = SimpleNamespace(cell=cell, setup_s=setup_s, window_s=window_s, unit_s=unit_s,
                          host_unit_s=host_units, samples=samples, relvar=relvar, spans=spans,
                          host_units=len(host_units), trace=traced["trace"] if traced else None,
                          trace_wall=traced["wall"] if traced else None,
                          trace_waves=n_tr * waves_per_unit,
                          trace_unit_s=float(sum(unit_s[:n_tr])),
                          trace_samples=traced["samples"] if traced else 0, work=ctx.work,
                          n_tri=int(ctx.compiled["p0"].shape[0]), entry=cell.traffic["entry"])
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = spec.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": device_name(device),
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": len(unit_s), "failed": 0,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace_wall
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    # seconds from the process's start at which each set-up step ended, and
    # the seconds of each check
    result["setup_parts"] = parts
    result["check_s"] = check_s
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in compared}
    return result, compared, control_readings


def max_memory(device):
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))
