"""Render the BASELINE scenes to PNG (the counterpart of the repo's
`examples/render_scenes.py`): each scene through `Renderer.render_spp`, one
K1 launch on the card, timed by `RenderMeter`.

    python -m sail_tpu_torch.examples.render_scenes --size 256 --spp 64
"""
import argparse
import os

from sail_tpu_torch import scenes
from sail_tpu_torch.render.renderer import Renderer
from sail_tpu_torch.utils.imageio import write_png
from sail_tpu_torch.utils.metrics import RenderMeter

SCENES = ("cornell_matte", "cornell_mirror", "material_demo",
          "lights_and_quadrics")


def render(name: str, size: int, spp: int, bounces: int, out: str,
           device=None):
    """(PNG path, RenderMeter, the mean image as an (H, W, 3) array) of one
    scene: a warm-up sample (the kernel's first load), then `spp` samples
    timed from a fresh accumulation."""
    scene = getattr(scenes, name)()
    r = Renderer(size, size, seed=0, max_bounces=bounces, device=device)
    r.update(scene)
    r.render(scene)
    r.update(scene)
    meter = RenderMeter(size, size, bounces)
    meter.start()
    r.render_spp(scene, spp)
    img = r.current()
    meter.stop(spp, sync=img)
    path = os.path.join(out, f"{name}_{size}_{spp}spp.png")
    img = img.stack().cpu().numpy()
    write_png(path, img)
    return path, meter, img


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--bounces", type=int, default=5)
    ap.add_argument("--scene", default="all", choices=("all",) + SCENES)
    ap.add_argument("--out", default=".")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    names = SCENES if args.scene == "all" else (args.scene,)
    os.makedirs(args.out, exist_ok=True)
    for name in names:
        path, meter, _ = render(name, args.size, args.spp, args.bounces,
                             args.out, args.device)
        print(name, "->", path, meter, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
