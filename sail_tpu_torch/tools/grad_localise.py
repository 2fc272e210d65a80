"""Where K2 and its plain version differ on one gradient leaf, pixel by
pixel, on one GPU.

    python3 -m sail_tpu_torch.tools.grad_localise [--spheres 256] [--size 256]

The many-sphere scene (`scenes.many_spheres`) at size² with the fwd+bwd
step's cotangent 1/size², at 1 spp and 5 bounces: K2 (`render_grad_block`)
and its plain version (torch autograd) give the flat gradient; the leaf
furthest outside its bound (`leaf_excess` with the pixel term) is then
split into its per-pixel contributions g · d(image)/d(leaf) on both sides.
K2's come from its block partials (`render_grad_rows`) with the cotangent
on one pixel of every block at a time; the plain version's from
forward-mode autograd (`torch.func.jvp`) through `render_block_plain`.
Prints one JSON object: the leaf's two values and its excess with and
without the pixel term, the sums of its per-pixel contributions on both
sides, its mass (sum of |contribution|) and largest pixel, and the pixels
that carry the difference, with the card's name and power limit.  Without
a card it raises.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json

import torch

from sail_tpu_torch import scenes
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.ops.cuda import megakernel as mk
from sail_tpu_torch.scene.scene import param_offsets
from sail_tpu_torch.tools.many_object_bench import card

# The per-leaf bound K2 is held to beside its relative L-inf (chip_smoke.py):
# |K2 - plain| <= LEAF_RTOL·|plain| + LEAF_ATOL·max|plain|, so a small leaf
# (a camera or light adjoint) cannot hide under the largest one.  Where the
# pixels' own contributions are known (`k2_pixels`), the bound adds
# PIXEL_RTOL of the leaf's largest single-pixel contribution: a pixel at a
# silhouette, where the gradient grows as 1/sqrt(discriminant), carries
# float32 rounding amplified by the discriminant's cancellation, and may
# carry a whole leaf.  Set from the readings of this tool on 256 spheres at
# 256² (an H100, PERF.md): one such pixel carried 92% of a leaf, and K2 and
# the plain version differed there by 7.7e-4 of it (the plain version's own
# forward and reverse modes by 2.9e-4 of the leaf).
LEAF_RTOL, LEAF_ATOL, PIXEL_RTOL = 1e-4, 1e-6, 2e-3


def leaf_excess(got: torch.Tensor, want: torch.Tensor,
                pixel_max: torch.Tensor = None) -> torch.Tensor:
    """Each leaf's |K2 - plain| over its bound (above 1: outside it);
    `pixel_max`: each leaf's largest |pixel contribution|."""
    scale = want.abs().max().double()
    bound = LEAF_RTOL * want.abs().double() + LEAF_ATOL * scale
    if pixel_max is not None:
        bound = bound + PIXEL_RTOL * pixel_max.double()
    return (got - want).abs().double() / bound


def leaf_name(static, k: int) -> str:
    """`materials[1]+0`-style name of index k of the flat parameters."""
    off = param_offsets(static)
    starts = [(s, f"{section}[{j}]")
              for section in ("objects", "materials", "textures", "lights")
              for j, s in enumerate(getattr(off, section))]
    start, label = max(x for x in starts + [(off.camera, "camera")]
                       if x[0] <= k)
    return f"{label}+{k - start}"


def k2_pixels(params, static, g: Vec3, rows: int, cols: int, spp: int, seed,
              sample0, bounces: int, row0: int,
              image_height: int) -> torch.Tensor:
    """K2's (rows, cols, n_params) contributions of each pixel, from its
    block partials (`render_grad_rows`) with the cotangent on one pixel of
    every block at a time: one launch per pixel of a block."""
    bx, by = mk.grad_limits()["block"]
    gx = -(-cols // bx)
    out = torch.zeros((rows, cols, params.numel()), dtype=torch.float32,
                      device=params.device)
    for i in range(min(by, rows)):
        for j in range(min(bx, cols)):
            mask = torch.zeros((rows, cols), dtype=torch.bool,
                               device=params.device)
            mask[i::by, j::bx] = True
            gm = Vec3(*(torch.where(mask, c, 0.0).contiguous() for c in g))
            part = mk.render_grad_rows(params, static, gm, rows, cols, spp,
                                       seed, sample0, bounces, row0,
                                       image_height)
            # block (bi, bj)'s row holds its pixel (bi·by + i, bj·bx + j)
            sub = out[i::by, j::bx]
            sub.copy_(part.view(-1, gx, part.shape[1])
                      [:sub.shape[0], :sub.shape[1]])
    return out


def plain_pixels(params, static, g: Vec3, rows: int, cols: int, spp: int,
                 seed, sample0, bounces: int, row0: int, image_height: int,
                 leaf: int) -> torch.Tensor:
    """The plain version's (rows, cols) float64 contributions of each pixel
    to `leaf`, by forward-mode autograd (`torch.func.jvp`) along it."""
    tangent = torch.zeros_like(params)
    tangent[leaf] = 1.0

    def image(p):
        return torch.stack(tuple(mk.render_block_plain(
            p, static, rows, cols, spp, seed, sample0, bounces, row0,
            image_height)))

    _, d_image = torch.func.jvp(image, (params,), (tangent,))
    return (d_image.double() * torch.stack(tuple(g)).double()).sum(0)


def localise(k2_map: torch.Tensor, plain_map: torch.Tensor, row0: int,
             leaf: int, got: float, want: float) -> dict:
    """The readings of one leaf whose K2 value `got` and plain value `want`
    differ, from the two sides' (rows, cols) pixel maps of it: where,
    pixel by pixel, the difference sits."""
    k2, plain = k2_map.double(), plain_map.double()
    cols = k2.shape[1]
    diff = k2 - plain
    order = diff.abs().flatten().argsort(descending=True)
    share = diff.abs().flatten()[order].cumsum(0) \
        / diff.abs().sum().clamp(min=1e-300)
    top = []
    for k in order[:3].tolist():
        r, c = divmod(k, cols)
        top.append({"row": row0 + r, "col": c, "k2": float(k2[r, c]),
                    "plain": float(plain[r, c]),
                    "diff": float(diff[r, c])})
    return {
        "leaf": leaf, "k2": got, "plain": want, "diff": got - want,
        "pixel_sum_k2": float(k2.sum()), "pixel_sum_plain": float(plain.sum()),
        "pixel_diff_sum": float(diff.sum()),
        "mass": float(plain.abs().sum()),
        "largest_pixel": float(plain.abs().max()),
        "pixels_with_contribution": int((plain != 0).sum()),
        "pixels_for_90pct_of_abs_diff": int((share < 0.9).sum()) + 1,
        "top_pixels": top}


def check(params, static, g: Vec3, rows: int, cols: int, spp: int, seed,
          sample0, bounces: int, row0: int, image_height: int,
          got: torch.Tensor, want: torch.Tensor) -> dict:
    """K2's gradient `got` against the plain version's `want` on these
    inputs, per leaf with the pixel term of the bound: each leaf's excess
    (`leaf_excess`), and the worst leaf localised pixel by pixel."""
    args = (params, static, g, rows, cols, spp, seed, sample0, bounces, row0,
            image_height)
    pixels = k2_pixels(*args)
    pixel_max = pixels.abs().flatten(0, 1).max(0).values
    excess = leaf_excess(got, want, pixel_max)
    leaf = int(excess.argmax())
    out = localise(pixels[:, :, leaf], plain_pixels(*args, leaf), row0, leaf,
                   float(got[leaf]), float(want[leaf]))
    out.update(leaf_name=leaf_name(static, leaf), excess=float(excess[leaf]),
               excess_without_pixels=float(leaf_excess(got, want)[leaf]),
               max_excess_without_pixels=float(leaf_excess(got, want).max()))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spheres", type=int, default=256)
    ap.add_argument("--size", type=int, default=256)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("grad_localise needs a CUDA device")
    dev = torch.device("cuda", 0)
    params, static = scenes.many_spheres(a.spheres).pack()
    params = params.to(dev)
    g = Vec3(*(torch.full((a.size, a.size), 1.0 / a.size ** 2,
                          device=dev),) * 3)
    args = (params, static, g, a.size, a.size, 1, 0, 0, 5)
    got = mk.render_grad_block(*args)
    want = mk.render_grad_block_plain(*args)
    out = check(*args, 0, a.size, got, want)
    out.update(scene=f"spheres{a.spheres}", shape=f"{a.size}x{a.size} spp1 b5",
               max_abs_plain=float(want.abs().max()), card=card())
    print(json.dumps({"grad_localise": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
