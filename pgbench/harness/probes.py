"""The benchmark's hooks around the program's layer boundaries.  Each
replaces a module attribute of the port, which the port reads at call
time, with a wrapper that calls the original and records:

  * ``hits``: of every closest-hit and any-hit query of a wave
    (``integrators.path.route_queries``), a fixed number of lanes drawn
    from the seed: the ray, its tmax and the answer, kept on the device
    for the reference to judge once the window has closed;
  * ``grid``: the records of a progression's waves and the guiding cache
    before and after its update (``integrators.progressive``'s
    ``accumulate_stats`` and ``update_grid``), the last one kept;
  * ``spans`` (traced runs): host times of ``trace`` calls (no sync) and
    of the fit (``accumulate_stats`` + ``update_grid``, synchronised at
    the end).

``uninstall`` puts the originals back."""
import time
from collections import defaultdict

import torch


class Probes:
    def __init__(self, device, seed, hits_per_call=0, grid=False, spans=False):
        self.device = device
        self.hits_per_call = hits_per_call
        self.want_grid = grid
        self.spans_on = spans
        self.spans = defaultdict(list)
        self.hit_rows = []
        self.calls = 0
        self.grid_step = None
        self._recs = []
        self._saved = []
        self._mark = {}
        if hits_per_call:
            g = torch.Generator(device="cpu")
            g.manual_seed(int(seed) & ((1 << 63) - 1))
            self._base = torch.randint(0, 1 << 40, (hits_per_call,), generator=g).to(device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _patch(self, mod, name, fn):
        self._saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def install(self):
        from mitsuba_path_guiding_torch.integrators import path, progressive

        if self.hits_per_call:
            self._patch(path, "route_queries", self._route(path.route_queries))
        if self.want_grid or self.spans_on:
            self._patch(progressive, "accumulate_stats", self._acc(progressive.accumulate_stats))
            self._patch(progressive, "update_grid", self._upd(progressive.update_grid))
        if self.spans_on:
            self._patch(progressive, "trace", self._timed("trace", progressive.trace))
        return self

    def uninstall(self):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved = []

    def mark(self):
        """Spans recorded from here on are the ones ``spans_after_mark``
        returns (the traced units' spans carry the profiler's cost)."""
        self._mark = {k: len(v) for k, v in self.spans.items()}

    def spans_after_mark(self):
        out = {}
        for k, v in self.spans.items():
            later = v[self._mark.get(k, 0):]
            out[k] = list(later if later else v)
        return out

    def reset(self):
        """Forget what the set-up's warm-up recorded."""
        self.spans.clear()
        self._mark = {}
        self.hit_rows = []
        self.calls = 0

    # -- hits ------------------------------------------------------------
    def _keep(self, o, d, tmax, t, valid, any_hit):
        n = o.shape[0]
        idx = (self._base + self.calls * 7919) % n
        self.calls += 1
        cols = [o[idx], d[idx], tmax[idx, None],
                (t[idx] if t is not None else torch.zeros_like(tmax[idx]))[:, None],
                valid[idx, None].to(torch.float32),
                torch.full_like(tmax[idx, None], 1.0 if any_hit else 0.0)]
        self.hit_rows.append(torch.cat([c.to(torch.float32) for c in cols], dim=1))

    def _route(self, orig):
        def route_queries(scene, accel, use_bvh=False):
            intersect, occluded = orig(scene, accel, use_bvh)

            def intersect_probe(o, d, tmax, *a, **kw):
                hit = intersect(o, d, tmax, *a, **kw)
                self._keep(o, d, tmax, hit.t, hit.valid, False)
                return hit

            def occluded_probe(o, d, tmax):
                occ = occluded(o, d, tmax)
                self._keep(o, d, tmax, None, occ, True)
                return occ
            return intersect_probe, occluded_probe
        return route_queries

    def hits(self):
        """(Q, 10) rows: o, d, tmax, t, hit, any_hit."""
        if not self.hit_rows:
            return None
        return torch.cat(self.hit_rows, dim=0)

    # -- the guiding cache's update ----------------------------------------
    def _acc(self, orig):
        def accumulate_stats(grid, rec, *a, **kw):
            t0 = time.perf_counter()
            out = orig(grid, rec, *a, **kw)
            if self.want_grid:
                self._recs.append(rec)
            if self.spans_on:
                self._sync()
                self.spans["fit"].append(time.perf_counter() - t0)
            return out
        return accumulate_stats

    def _upd(self, orig):
        def update_grid(grid, *stats, **kw):
            t0 = time.perf_counter()
            out = orig(grid, *stats, **kw)
            if self.want_grid:
                self.grid_step = (grid, self._recs, out)
                self._recs = []
            if self.spans_on:
                self._sync()
                self.spans["fit"].append(time.perf_counter() - t0)
            return out
        return update_grid

    # -- traced runs ------------------------------------------------------
    def _timed(self, name, orig):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            self.spans[name].append(time.perf_counter() - t0)
            return out
        return timed

