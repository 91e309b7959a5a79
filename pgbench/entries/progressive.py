"""Entry ``progressive``: the guided progressive renderer as the CLI runs
it, ``ProgressiveRenderer.run_progression``, one call a unit of work.
The program makes everything from the configuration and the seed
(``RenderConfig.seed``); the unit ends in a synchronisation, so its host
time is the progression's."""
import math

import torch


class Entry:
    def __init__(self, ctx, scene):
        from mitsuba_path_guiding_torch.integrators.progressive import (
            ProgressiveConfig,
            ProgressiveRenderer,
        )
        from mitsuba_path_guiding_torch.integrators.render import RenderConfig

        cfg, tr = ctx.cell.config, ctx.cell.traffic
        w, h = ctx.width, ctx.height
        batch = w * h if tr["pixel_batch"] == "frame" else int(tr["pixel_batch"])
        rc = RenderConfig(width=w, height=h, spp=0, max_depth=cfg["max_depth"],
                          rr_depth=cfg["rr_depth"], seed=ctx.seed, use_nee=cfg["use_nee"],
                          accel=cfg["accel"], pixel_batch=batch)
        self.spp = int(tr["spp"])
        pc = ProgressiveConfig(render=rc, samples_per_progression=self.spp, n_progressions=1,
                               guiding=bool(tr["guided"]), grid_res=int(tr["grid_res"]),
                               n_lobes=int(tr["n_lobes"]))
        self.renderer = ProgressiveRenderer(scene, pc)
        self.device = ctx.device
        self.samples_per_unit = w * h * self.spp
        self.waves_per_unit = math.ceil(w * h / batch) * self.spp
        self.units = 0
        self._prev = None
        self.halves = [None, None]

    def unit(self):
        self.renderer.run_progression()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.units += 1
        return self.samples_per_unit

    def begin_window(self):
        self._prev = self.renderer.film.rgb_weight.clone()
        self.halves = [torch.zeros_like(self._prev), torch.zeros_like(self._prev)]

    def add_half(self, parity):
        """The last unit's samples, added to half-image ``parity``."""
        cur = self.renderer.film.rgb_weight
        self.halves[parity] += cur - self._prev
        self._prev.copy_(cur)

    def half_images(self):
        return [h[:, :3] / torch.clamp_min(h[:, 3:4], 1e-12) for h in self.halves]

    def outputs(self):
        """What the checks judge, detached from the renderer."""
        rgbw = self.renderer.film.rgb_weight
        return {"film_weight": rgbw[:, 3].clone(),
                "image": (rgbw[:, :3] / torch.clamp_min(rgbw[:, 3:4], 1e-12)).clone(),
                "expected_weight": float(self.units * self.spp)}

    def release(self):
        self.renderer = None
        self._prev = None
        self.halves = [None, None]
