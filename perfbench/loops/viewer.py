"""The interactive viewer: frames in sessions of `session` frames; in the
first `moving` of a session an orbit drag (`Control.orbit`) moves the
camera, so the frame repacks the scene and restarts the accumulation, and
the rest accumulate.  Every frame is `Renderer.render` (one sample, one K1
launch), `output` (the display filter and the copy to the host) and
`png_bytes`, as the viewer shows each frame.  The drags of a session are
`drags`, in an order drawn from the seed and the session's number.
Checked: the mean radiance after the last frame and that frame decoded
from its PNG bytes; the reference replays the drags from the frame count
(the control: `control_frames` frames)."""
from __future__ import annotations

import numpy as np
import torch

from perfbench import scene_data
from perfbench.loop_base import LoopBase
from perfbench.reference import compare as ref


class Loop(LoopBase):
    def setup(self):
        import sail_tpu_torch
        from sail_tpu_torch.render.control import Control
        from sail_tpu_torch.utils.imageio import png_bytes
        self._png = png_bytes
        t = self.t
        self.scene = scene_data.make_scene(self.config["scene"],
                                           sail_tpu_torch)
        self.scene.filter = t["filter"]
        self.renderer = sail_tpu_torch.Renderer(
            t["size"], t["size"], seed=self.rseed, max_bounces=t["bounces"],
            device=self.device)
        self.renderer.update(self.scene)
        self.control = Control(self.scene, t["size"], t["size"],
                               device=self.device)
        self.frames = 0
        self.warm()

    def drag(self, frame: int):
        """Frame `frame`'s drag (dx, dy) in pixels, or None."""
        session, k = divmod(frame, self.t["session"])
        if k >= self.t["moving"]:
            return None
        order = np.random.default_rng([self.seed, session]).permutation(
            len(self.t["drags"]))
        return tuple(self.t["drags"][order[k]])

    def unit(self, rec, spans):
        drag = self.drag(self.frames)
        if drag is not None:
            self.control.orbit(*drag)
        self.renderer.render(self.scene)
        self.scene.moving = False
        with spans("output"):
            img = self.renderer.output(self.scene)
        with spans("png"):
            self.png = self._png(img)
        self.frames += 1

    def samples(self) -> int:
        """Samples in the accumulation after the last frame: the frames
        since the last drag, its own included."""
        k = (self.frames - 1) % self.t["session"]
        return 1 if k < self.t["moving"] else k - self.t["moving"] + 2

    def release(self):
        self.out = {"radiance": torch.stack(tuple(
                        self.renderer.current())).cpu(),
                    "frame": torch.as_tensor(ref.png_decode(self.png))}
        del self.renderer, self.control

    def outputs(self):
        return self.out

    def reference(self, dtype):
        t = self.t
        eye, center = self.config["scene"]["camera"]
        moves = [d for d in map(self.drag, range(self.frames)) if d]
        params, static = ref.packed(self.config, self.device, dtype,
                                    eye=ref.orbit_eye(eye, center, moves))
        with torch.no_grad():
            img = ref.mean_image(params, static, t["size"], t["size"],
                                 self.samples(), self.rseed, t["bounces"])
            shown = ref.display(img, t["filter"]).float()
        frame = ref.to_uint8(shown.permute(1, 2, 0).cpu().numpy(),
                             t["png_gamma"])
        return {"radiance": img.float().cpu(),
                "frame": torch.as_tensor(frame)}

    def control(self):
        self.frames = self.t["control_frames"]
        return super().control()

    def compare(self, program, reference):
        levels = (program["frame"].int() - reference["frame"].int()).abs()
        return [("radiance_rel", ref.rel_linf(program["radiance"],
                                              reference["radiance"])),
                ("frame_levels", float(levels.max()))]
