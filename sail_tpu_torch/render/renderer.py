"""Progressive renderer (port of `sail_tpu/render/renderer.py`).

`update(scene)` packs the scene onto the Renderer's device, `render` adds one
sample, `render_spp` adds many, and `output` runs the scene's display filter
and returns a numpy (H, W, 3) array.  Every render call goes through
`render_block`: on a CUDA device that is ONE launch of the K1 megakernel for
all `spp` samples; on the CPU it is the plain torch version.  The Renderer
runs on the card unless it is given `device="cpu"`; there is no fallback
from the card or the kernel to the CPU or the plain path.

Not ported yet: the G-buffer and the filters that read it (`normal`,
`position`, `wavelet`), the windowed filters, `early_exit`, the selection
overlay and checkpoint/resume (ROADMAP.md queue 1: display and runtime).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import constants as C
from ..core.vecmath import Vec3
from ..ops import filters
from ..ops.cuda.megakernel import render_block
from ..scene.scene import Scene


class Renderer:
    def __init__(self, width: int = 512, height: int = 512, seed: int = 0,
                 max_bounces: int = C.MAX_BOUNCES, device=None):
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Renderer runs on a CUDA device by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "render with the plain torch version")
        self.width = width
        self.height = height
        self.max_bounces = max_bounces
        self.seed = seed
        self.device = device
        self._params: Optional[torch.Tensor] = None
        self._static = None
        self._accum: Optional[Vec3] = None
        self.sample_count = 0

    def update(self, scene: Scene):
        """(Re)pack the scene; resets the accumulation."""
        params, self._static = scene.pack()
        self._params = params.to(self.device)
        self.reset()
        scene.sample_count = 0

    def reset(self):
        z = torch.zeros((self.height, self.width), dtype=torch.float32,
                        device=self.device)
        self._accum = Vec3(z, z, z)
        self.sample_count = 0

    def render(self, scene: Scene):
        """Add one progressive sample."""
        self.render_spp(scene, 1)

    def render_spp(self, scene: Scene, spp: int):
        """Add `spp` samples: one K1 launch on CUDA, identical to `spp`
        calls of :meth:`render` on the CPU."""
        if self._params is None:
            self.update(scene)
        if scene.moving:
            # motion invalidates the accumulation; objects are repacked
            params, self._static = scene.pack()
            self._params = params.to(self.device)
            self.reset()
        acc = render_block(self._params, self._static, self.height,
                           self.width, spp, self.seed, self.sample_count,
                           self.max_bounces)
        self._accum = self._accum + acc
        self.sample_count += spp
        scene.sample_count = self.sample_count

    def current(self) -> Vec3:
        """Mean radiance so far."""
        return self._accum * (1.0 / max(self.sample_count, 1))

    def output(self, scene: Optional[Scene] = None) -> np.ndarray:
        """Filtered image as a float32 numpy (H, W, 3) array — the only
        device→host transfer."""
        name = scene.filter if scene is not None else "color"
        params = scene.filter_params if scene is not None else {}
        img = filters.apply_filter(name, self.current(), **params)
        return img.stack().cpu().numpy()
