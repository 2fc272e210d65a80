"""Faults the timed path can have, each planted in the program by patching
the call it makes (`patch(monkeypatch)`), for the tests that see `correct`
come out false and for the readings on the card that set a training cell's
upper limits:

    python3 -m perfbench.faults --workload cornell_mirror.inverse \
        --seeds 21,22,23 --seconds 2
"""
import argparse
import io
import json
import os
import sys
import time

import numpy as np
import torch


def _half_spp(render):
    """`render_image_fast` over half the samples: the mean of the rest."""
    def broken(params, seed, static, h, w, spp, bounces):
        return render(params, seed, static, h, w, max(1, spp // 2), bounces)
    return broken


def _altered(render):
    """`render_image_fast` with one pixel's red altered where it is made."""
    def broken(*args):
        img = render(*args)
        bump = torch.zeros_like(img.x)
        bump[0, 0] = 0.05
        return type(img)(img.x + bump, img.y, img.z)
    return broken


def _fwdbwd(fault):
    def patch(monkeypatch):
        from sail_tpu_torch.ops.cuda import megakernel
        monkeypatch.setattr(megakernel, "render_image_fast",
                            fault(megakernel.render_image_fast))
    return patch


def _frames_half(monkeypatch):
    from sail_tpu_torch.render.renderer import Renderer
    real = Renderer.render_spp
    monkeypatch.setattr(Renderer, "render_spp",
                        lambda self, scene, spp: real(self, scene,
                                                      max(1, spp // 2)))


def _frames_altered(monkeypatch):
    from sail_tpu_torch.render.renderer import Renderer
    real = Renderer.output

    def output(self, scene=None):
        out = real(self, scene).copy()
        out[:, 0, 0] += 0.05      # the first column, so every row
        return out
    monkeypatch.setattr(Renderer, "output", output)


def _viewer_unchanged(monkeypatch):
    """Frames that leave the accumulation as it was."""
    from sail_tpu_torch.render.renderer import Renderer
    monkeypatch.setattr(Renderer, "render", lambda self, scene: None)


def _viewer_png_altered(monkeypatch):
    from sail_tpu_torch.utils import imageio
    real = imageio.png_bytes

    def png_bytes(img, gamma=2.2):
        img = np.array(img)
        img[0, 0] = 1.0 - np.clip(img[0, 0], 0, 1)
        return real(img, gamma)
    monkeypatch.setattr(imageio, "png_bytes", png_bytes)


def _train_unchanged(monkeypatch):
    """Steps that leave the parameters as they were."""
    real = torch.optim.Adam.step

    def step(self, closure=None):
        kept = [p.detach().clone() for g in self.param_groups
                for p in g["params"]]
        real(self, closure)
        with torch.no_grad():
            for p, k in zip((p for g in self.param_groups
                             for p in g["params"]), kept):
                p.copy_(k)
    monkeypatch.setattr(torch.optim.Adam, "step", step)


def _train_half(monkeypatch):
    """The loss and its gradient over half the samples."""
    from sail_tpu_torch.parallel import render_sharded as rs
    real = rs._value_grad_image

    def half(params, target, static, mesh, height, width, spp, seed,
             max_bounces):
        return real(params, target, static, mesh, height, width,
                    max(1, spp // 2), seed, max_bounces)
    monkeypatch.setattr(rs, "_value_grad_image", half)


def _train_altered(monkeypatch):
    from sail_tpu_torch.parallel import render_sharded as rs
    real = rs._mse
    monkeypatch.setattr(rs, "_mse", lambda *a: real(*a) * 1.01)


# by the traffic's loop; a loop may carry its own in `loops/<loop>.py`
FAULTS = {
    "fwdbwd": {"half": _fwdbwd(_half_spp), "altered": _fwdbwd(_altered)},
    "frames": {"half": _frames_half, "altered": _frames_altered},
    "viewer": {"unchanged": _viewer_unchanged,
               "altered": _viewer_png_altered},
    "train": {"unchanged": _train_unchanged, "half": _train_half,
              "altered": _train_altered},
}


def of(cell: dict) -> dict:
    """The faults of the cell's loop, by name: this file's and those its
    loop module carries (a module-level `FAULTS`)."""
    from perfbench import harness
    return {**FAULTS.get(cell["traffic"]["loop"], {}),
            **getattr(harness.loop_module(cell), "FAULTS", {})}


def run(cell: dict, seed: int, seconds: float, fault: str | None = None,
        device: str = "cuda", log=None) -> dict:
    """The result of one untraced run of `cell` with `fault` planted (None:
    a sound run): in this process for a one-card cell, through the
    launcher for a multi-card one, each rank planting it."""
    from _pytest.monkeypatch import MonkeyPatch
    from perfbench import harness
    log = log or open(os.devnull, "w")
    if cell["workload"]["chips"] > 1:
        out = io.StringIO()
        rc = harness.launch(cell, seed, seconds, False, time.perf_counter(),
                            device, fault, out=out, err=log)
        if rc:
            raise RuntimeError(f"{cell['name']} exited with {rc}")
        return json.loads(out.getvalue().splitlines()[-1])
    mp = MonkeyPatch()
    try:
        if fault is not None:
            of(cell)[fault](mp)
        return harness.run_cell(cell, seed, seconds, False,
                                time.perf_counter(), device, log=log)
    finally:
        mp.undo()


def main(argv=None) -> int:
    from perfbench import harness
    ap = argparse.ArgumentParser(description="Run a cell with each of its "
                                 "faults planted; print the numbers.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the faults are read on a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for fault in of(cell):
        for seed in (int(s) for s in args.seeds.split(",")):
            r = run(cell, seed, args.seconds, fault)
            print(json.dumps({"workload": args.workload, "fault": fault,
                              "seed": seed, "correct": r["correct"],
                              "checks": {k: v["value"] for k, v in
                                         r["checks"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
