"""The differentiable render step, back to back: the mean image through
`render_image_fast` (K1), the mean of its pixels and channels, and
`backward()` (K2 and its reduce), each step ending in a synchronize, the
same parameters and seed every step.  Checked: the last step's image and
gradient against the reference's autograd through the plain tracer."""
from __future__ import annotations

import torch

from perfbench import scene_data
from perfbench.loop_base import LoopBase
from perfbench.reference import compare as ref


class Loop(LoopBase):
    def setup(self):
        import sail_tpu_torch
        from sail_tpu_torch.ops.cuda.megakernel import render_image_fast
        self._render = render_image_fast
        params, self.static = scene_data.make_scene(
            self.config["scene"], sail_tpu_torch).pack()
        self.params = params.to(self.device).requires_grad_()
        t = self.t
        self.shape = (t["size"], t["size"], t["spp"], t["bounces"])
        self.warm()

    def unit(self, rec, spans):
        H, W, spp, bounces = self.shape
        p = self.params
        p.grad = None
        img = self._render(p, self.rseed, self.static, H, W, spp, bounces)
        (img.x + img.y + img.z).mean().backward()
        self.image = img
        rec["rays"] = H * W * spp * bounces * 2

    def release(self):
        self.out = {"image": torch.stack(tuple(self.image)).detach(),
                    "grad": self.params.grad.detach().clone()}
        del self.image, self.params

    def outputs(self):
        return self.out

    def reference(self, dtype):
        image, grad = ref.image_and_grad(self.config, self.t, self.rseed,
                                         self.device, dtype)
        return {"image": image, "grad": grad}

    def compare(self, program, reference):
        return [("image_rel", ref.rel_linf(program["image"],
                                           reference["image"])),
                ("grad_leaf", ref.worst_leaf(program["grad"],
                                             reference["grad"]))]
