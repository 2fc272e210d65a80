"""Progressive renderer (port of `sail_tpu/render/renderer.py`).

`update(scene)` packs the scene onto the Renderer's device, `render` adds one
sample, `render_spp` adds many, and `output` runs the scene's display filter,
draws the selected object's box and returns a numpy (H, W, 3) array.  Every
render call goes through `render_block`: on a CUDA device that is ONE launch
of the K1 megakernel for all `spp` samples; on the CPU it is the plain torch
version.  The Renderer runs on the card unless it is given `device="cpu"`;
there is no fallback from the card or the kernel to the CPU or the plain
path.

`early_exit=True` (K1-ee) skips the bounces no ray needs, for open scenes
whose escaped rays die together; the image is the same bit for bit.

The G-buffer (first-hit normal and position) is filled lazily, for the
filters that read it, from the sample the JAX package's TPU path takes:
the sample just traced after `render`, sample 0 after `render_spp`.

Render state is (sample sum, count): `save`/`load` write and read the JAX
package's `.npz` checkpoint, and a Renderer that loads one and then renders
keeps the loaded sum.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import constants as C
from ..core.vecmath import Vec3
from ..ops import filters
from ..ops.cuda.megakernel import render_block
from ..scene.scene import Scene, unflatten
from ..utils.device import resolve
from ..utils.metrics import span, spanned
from .integrator import gbuffer
from .overlay import draw_selection


class Renderer:
    def __init__(self, width: int = 512, height: int = 512, seed: int = 0,
                 max_bounces: int = C.MAX_BOUNCES, device=None,
                 early_exit: bool = False):
        self.width = width
        self.height = height
        self.max_bounces = max_bounces
        self.seed = seed
        self.device = resolve(device, "Renderer")
        self.early_exit = early_exit
        self._params: Optional[torch.Tensor] = None
        self._static = None
        self._accum: Optional[Vec3] = None
        self._normal: Optional[Vec3] = None
        self._position: Optional[Vec3] = None
        self._gbuffer_ok = False
        self._gbuffer_sample = 0
        self.sample_count = 0

    @property
    def early_exit(self) -> bool:
        return self._early_exit

    @early_exit.setter
    def early_exit(self, value: bool):
        # read at every render call, so a change takes effect at the next
        self._early_exit = bool(value)

    @spanned("sail.pack")
    def _pack(self, scene: Scene):
        params, self._static = scene.pack()
        self._params = params.to(self.device)

    def update(self, scene: Scene):
        """(Re)pack the scene; resets the accumulation."""
        self._pack(scene)
        self.reset()
        scene.sample_count = 0

    def reset(self):
        z = torch.zeros((self.height, self.width), dtype=torch.float32,
                        device=self.device)
        self._accum = Vec3(z, z, z)
        self._normal = Vec3(z, z, z)
        self._position = Vec3(z, z, z)
        self.sample_count = 0
        self._gbuffer_ok = False

    def render(self, scene: Scene):
        """Add one progressive sample; the G-buffer is that sample's."""
        self.render_spp(scene, 1)
        self._gbuffer_sample = self.sample_count - 1

    def render_spp(self, scene: Scene, spp: int):
        """Add `spp` samples: one K1 launch on CUDA, identical to `spp`
        calls of :meth:`render` on the CPU; the G-buffer is sample 0's."""
        if self._params is None:
            if self._accum is None:
                self.update(scene)
            else:       # a loaded checkpoint: keep its sum
                self._pack(scene)
        if scene.moving:
            # motion invalidates the accumulation; objects are repacked
            self._pack(scene)
            self.reset()
        acc = render_block(self._params, self._static, self.height,
                           self.width, spp, self.seed, self.sample_count,
                           self.max_bounces, early_exit=self.early_exit)
        self._accum = self._accum + acc
        self._gbuffer_ok = False
        self._gbuffer_sample = 0
        self.sample_count += spp
        scene.sample_count = self.sample_count

    def current(self) -> Vec3:
        """Mean radiance so far."""
        return self._accum * (1.0 / max(self.sample_count, 1))

    def output(self, scene: Optional[Scene] = None) -> np.ndarray:
        """Filtered image as a float32 numpy (H, W, 3) array — the only
        device→host transfer — with the selected object's box drawn."""
        name = scene.filter if scene is not None else "color"
        params = scene.filter_params if scene is not None else {}
        if (name in filters.GBUFFER_FILTERS and not self._gbuffer_ok
                and self._params is not None):
            self._normal, self._position = gbuffer(
                unflatten(self._params, self._static), self._static,
                self.height, self.width, self.seed, self._gbuffer_sample)
            self._gbuffer_ok = True
        with span("sail.filter"):
            img = filters.apply_filter(name, self.current(), self._normal,
                                       self._position, **params)
        out = img.stack().cpu().numpy()
        if scene is not None and scene.select is not None:
            out = draw_selection(out, scene, scene.select)
        return out

    # -- checkpoint / resume -------------------------------------------------
    def checkpoint(self) -> dict:
        """Render state: the sample sum, as the mean times the count (the
        JAX package's arithmetic, so either package reads the other's), and
        the count."""
        return {
            "accum": self.current().stack().cpu().numpy() * self.sample_count
            if self.sample_count else np.zeros((self.height, self.width, 3)),
            "sample_count": self.sample_count,
        }

    def restore(self, state: dict):
        a = torch.as_tensor(np.asarray(state["accum"]), dtype=torch.float32,
                            device=self.device)
        if a.shape[:2] != (self.height, self.width):
            raise ValueError(
                f"checkpoint is {a.shape[1]}x{a.shape[0]} but this Renderer "
                f"is {self.width}x{self.height}")
        self._accum = Vec3(*(a[..., k].contiguous() for k in range(3)))
        self.sample_count = int(state["sample_count"])

    def save(self, path: str):
        """Write the render state to `path` (.npz); :meth:`load` resumes it,
        and the samples that follow continue the uninterrupted render."""
        np.savez(path, **self.checkpoint())

    def load(self, path: str):
        with np.load(path) as data:
            self.restore({"accum": data["accum"],
                          "sample_count": int(data["sample_count"])})
