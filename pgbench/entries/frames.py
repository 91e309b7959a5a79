"""Entry ``frames``: whole frames of ``integrators.render.render``, one
call a unit of work, back to back, frame i rendered with the seed plus
i.  A frame is returned as the developed image; the unit ends in a
synchronisation, so its host time is the frame's latency."""
import math

import torch


class Entry:
    def __init__(self, ctx, scene):
        from mitsuba_path_guiding_torch.integrators.render import RenderConfig, render

        cfg, tr = ctx.cell.config, ctx.cell.traffic
        w, h = ctx.width, ctx.height
        batch = w * h if tr["pixel_batch"] == "frame" else int(tr["pixel_batch"])
        self.spp = int(tr["spp"])
        self.cfg = RenderConfig(width=w, height=h, spp=self.spp, max_depth=cfg["max_depth"],
                                rr_depth=cfg["rr_depth"], seed=ctx.seed, use_nee=cfg["use_nee"],
                                accel=cfg["accel"], pixel_batch=batch)
        self.render = render
        self.scene = scene
        self.device = ctx.device
        self.seed = int(ctx.seed)
        self.samples_per_unit = w * h * self.spp
        self.waves_per_unit = math.ceil(w * h / batch) * self.spp
        self.units = 0
        self.last = None
        self.halves = [None, None]
        self.counts = [0, 0]

    def unit(self):
        self.last = self.render(self.scene, self.cfg._replace(seed=self.seed + self.units))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.units += 1
        return self.samples_per_unit

    def begin_window(self):
        self.halves = [torch.zeros_like(self.last, dtype=torch.float64) for _ in range(2)]
        self.counts = [0, 0]

    def add_half(self, parity):
        self.halves[parity] += self.last
        self.counts[parity] += 1

    def half_images(self):
        return [h / max(c, 1) for h, c in zip(self.halves, self.counts)]

    def outputs(self):
        n = sum(self.counts)
        img = (self.halves[0] + self.halves[1]) / max(n, 1)
        return {"image": img.reshape(-1, 3).float()}

    def release(self):
        self.scene = None
        self.last = None
