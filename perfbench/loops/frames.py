"""Converged frames for a user rendering stills: each frame is
`Renderer.reset`, `render_spp(spp)` (one K1 launch) and `output` (the
scene's display filter and the copy to the host), the same frame every
time.  Checked: the accumulated radiance and the filtered frame of the last
frame on `check_rows` rows drawn from the seed, which the reference traces
with `filter_margin` rows on each side for the filter's window."""
from __future__ import annotations

import numpy as np
import torch

from perfbench import scene_data
from perfbench.loop_base import LoopBase
from perfbench.reference import compare as ref


class Loop(LoopBase):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        t = self.t
        m = t["filter_margin"]
        self.rows = np.sort(self.rng.choice(
            np.arange(m, t["size"] - m), t["check_rows"], replace=False))

    def setup(self):
        import sail_tpu_torch
        t = self.t
        self.scene = scene_data.make_scene(self.config["scene"],
                                           sail_tpu_torch)
        self.renderer = sail_tpu_torch.Renderer(
            t["size"], t["size"], seed=self.rseed, max_bounces=t["bounces"],
            device=self.device)
        self.renderer.update(self.scene)
        self.warm()

    def unit(self, rec, spans):
        t, r = self.t, self.renderer
        r.reset()
        r.render_spp(self.scene, t["spp"])
        self.frame = r.output(self.scene)
        rec["rays"] = t["size"] * t["size"] * t["spp"] * t["bounces"] * 2

    def release(self):
        rows = torch.as_tensor(self.rows)
        radiance = torch.stack(tuple(self.renderer.current()))
        self.out = {"radiance": radiance[:, rows.to(radiance.device)].cpu(),
                    "frame": torch.as_tensor(
                        self.frame[self.rows]).permute(2, 0, 1)}
        del self.renderer, self.frame

    def outputs(self):
        return self.out

    def reference(self, dtype):
        t, m = self.t, self.t["filter_margin"]
        params, static = ref.packed(self.config, self.device, dtype)
        radiance, frame = [], []
        with torch.no_grad():
            for i in self.rows:
                band = ref.mean_image(params, static, t["size"], t["size"],
                                      t["spp"], self.rseed, t["bounces"],
                                      row0=int(i) - m, rows=2 * m + 1)
                radiance.append(band[:, m].float().cpu())
                frame.append(ref.display(
                    band, self.config["scene"]["filter"])[:, m].float().cpu())
        return {"radiance": torch.stack(radiance, 1),
                "frame": torch.stack(frame, 1)}

    def compare(self, program, reference):
        return [("radiance_rel", ref.rel_linf(program["radiance"],
                                              reference["radiance"])),
                ("frame_rel", ref.rel_linf(program["frame"],
                                           reference["frame"]))]
