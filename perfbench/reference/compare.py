"""The reference side of every check: plain PyTorch on the frozen copy in
`plain/`, given only the configuration's data, the traffic's sizes and the
seed, and the numbers that hold the program's outputs against it.

Nothing here imports the program.  Each function works out again what the
program derived (the packed parameters, the target, the accumulation, the
camera after the viewer's moves, the optimizer's state) and runs in the
dtype it is given: float32 is the reference, bfloat16 its control."""
from __future__ import annotations

import math
import struct
import zlib

import numpy as np
import torch

from . import plain
from .plain.diff import boundary
from .plain.core.vecmath import Vec3
from .plain.ops import filters
from .plain.render import integrator
from .plain.scene.scene import leaf_paths, unflatten
from .. import scene_data


# -- the numbers ------------------------------------------------------------

def rel_linf(a, b) -> float:
    """max |a − b| / max |b|."""
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64).to(a.device)
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def worst_leaf(a, b, leaves=None) -> float:
    """The worst leaf's |a − b| against that leaf's |b| or the median
    leaf's, whichever is larger, over `leaves` (all by default)."""
    a = torch.as_tensor(a, dtype=torch.float64).cpu()
    b = torch.as_tensor(b, dtype=torch.float64).cpu()
    if leaves is not None:
        a, b = a[leaves], b[leaves]
    if a.numel() == 0:
        return 0.0
    scale = torch.maximum(b.abs(), b.abs().median())
    return float(((a - b).abs() / scale.clamp_min(1e-30)).max())


def worst_norm_gap(a, b, leaves=None) -> float:
    """The worst leaf's gap between the norms, | |a| − |b| |, against that
    leaf's |b| or the median leaf's, whichever is larger (each leaf one
    scalar, as the flat parameters' keys are)."""
    return worst_leaf(torch.as_tensor(a).abs(), torch.as_tensor(b).abs(),
                      leaves)


# -- scenes -----------------------------------------------------------------

def packed(config: dict, device, dtype=torch.float32, eye=None):
    """(flat parameters, static) of the configuration's scene."""
    params, static = scene_data.make_scene(config["scene"], plain,
                                           eye=eye).pack()
    return params.to(device=device, dtype=dtype), static


def mean_image(params, static, height, width, spp, seed, bounces,
               row0=0, rows=None, count=None):
    """The mean radiance (3, rows, W) of samples 0 .. spp−1, as the program
    forms it: the spp-SUM in sample order times 1/count (count: spp)."""
    rows = height if rows is None else rows
    acc = integrator.render_sum(unflatten(params, static), static, rows,
                                width, spp, seed, 0, bounces, row0=row0,
                                image_height=height)
    return torch.stack(tuple(acc)) * (1.0 / (count or spp))


def display(img: torch.Tensor, name: str) -> torch.Tensor:
    """A display filter of a (3, H, W) image."""
    out = filters.apply_filter(name, Vec3(*img))
    return torch.stack(tuple(out))


# -- the fwd+bwd step -------------------------------------------------------

def image_and_grad(config, t, seed, device, dtype):
    """(mean image, gradient of its mean over pixels and channels) of the
    configuration's scene: the step `loops/fwdbwd.py` times.  The loss is
    linear in the image, so each pass of samples is back-propagated as it
    is traced and its graph let go; the image adds the samples in order."""
    params, static = packed(config, device, dtype)
    params.requires_grad_()
    H = W = t["size"]
    spp = t["spp"]
    per_pass = max(1, min(spp, integrator.RAYS_PER_PASS // (H * W)))
    acc = torch.zeros((3, H, W), dtype=dtype, device=device)
    for s in range(0, spp, per_pass):
        n = min(per_pass, spp - s)
        rad = integrator.render_sample(unflatten(params, static), static, H,
                                       W, seed, s, t["bounces"],
                                       n_samples=n)
        ((rad.x + rad.y + rad.z).sum() * (1.0 / (spp * H * W))).backward()
        with torch.no_grad():
            for k in range(n):
                acc = acc + torch.stack((rad.x[k], rad.y[k], rad.z[k]))
    return (acc * (1.0 / spp)).float(), params.grad.float()


# -- the viewer -------------------------------------------------------------

def orbit_eye(eye, center, moves):
    """The camera's eye after the orbit drags `moves` ((dx, dy) pixels
    each) about `center`: spherical angles, 0.01 rad a pixel, the
    elevation held inside ±(π/2 − 0.01)."""
    d = [e - c for e, c in zip(eye, center)]
    radius = math.sqrt(sum(x * x for x in d))
    ax = math.asin(max(-1.0, min(1.0, d[1] / max(radius, 1e-9))))
    ay = math.atan2(d[0], d[2])
    limit = math.pi / 2 - 0.01
    for dx, dy in moves:
        ay -= dx * 0.01
        ax = max(-limit, min(limit, ax + dy * 0.01))
    cx, cy, cz = center
    return (cx + radius * math.cos(ax) * math.sin(ay),
            cy + radius * math.sin(ax),
            cz + radius * math.cos(ax) * math.cos(ay))


def to_uint8(img: np.ndarray, gamma: float = 2.2) -> np.ndarray:
    """A float (H, W, 3) image as display bytes: clipped to [0, 1], raised
    to 1/gamma, rounded."""
    x = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    return (np.power(x, 1.0 / gamma) * 255.0 + 0.5).astype(np.uint8)


def png_decode(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 pixels of an 8-bit RGB, non-interlaced PNG, every
    row filter undone."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                                body)
            if (depth, ctype, interlace) != (8, 2, 0):
                raise ValueError("not an 8-bit RGB non-interlaced PNG")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    out = np.zeros((h, 3 * w), np.int32)
    prev = np.zeros(3 * w, np.int32)
    for i in range(h):
        kind, row = raw[i, 0], raw[i, 1:].astype(np.int32)
        if kind == 0:
            cur = row
        elif kind == 2:
            cur = (row + prev) & 255
        else:   # Sub, Average and Paeth read the pixel to the left
            cur = np.zeros(3 * w, np.int32)
            for j in range(3 * w):
                left = cur[j - 3] if j >= 3 else 0
                up, ul = prev[j], (prev[j - 3] if j >= 3 else 0)
                if kind == 1:
                    pred = left
                elif kind == 3:
                    pred = (left + up) >> 1
                elif kind == 4:
                    p = left + up - ul
                    pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
                    pred = left if pa <= pb and pa <= pc else (
                        up if pb <= pc else ul)
                else:
                    raise ValueError(f"row filter {kind}")
                cur[j] = (row[j] + pred) & 255
        out[i] = cur
        prev = cur
    return out.reshape(h, w, 3).astype(np.uint8)


# -- the train step ---------------------------------------------------------

def trainable(keys, groups) -> torch.Tensor:
    """The 0/1 mask of the keys that hold every part of some group."""
    return torch.tensor([1.0 if any(all(p in k for p in g) for g in groups)
                         else 0.0 for k in keys])


def mse(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over pixels and channels of (3, H, W) images."""
    se = ((img[0] - target[0]) ** 2 + (img[1] - target[1]) ** 2
          + (img[2] - target[2]) ** 2)
    return torch.sum(se) / (img.shape[1] * img.shape[2] * 3)


class Adam:
    """Adam on one flat tensor, as torch.optim.Adam's defaults step it."""

    def __init__(self, lr, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.betas, self.eps = lr, betas, eps
        self.m = self.v = None
        self.t = 0

    def step(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        b1, b2 = self.betas
        if self.m is None:
            self.m, self.v = torch.zeros_like(p), torch.zeros_like(p)
        self.t += 1
        self.m = self.m.lerp(g, 1 - b1)
        self.v = self.v * b2 + g * g * (1 - b2)
        step = self.lr / (1 - b1 ** self.t)
        denom = self.v.sqrt() / math.sqrt(1 - b2 ** self.t) + self.eps
        return p - step * self.m / denom


def train_steps(config, t, seed, device, dtype, n_steps):
    """The inverse-rendering loop `loops/train.py` times, followed for
    `n_steps`: the target rendered from the configuration's scene, the
    start perturbed as the traffic says, each step's loss, its gradient
    (the interior by autograd, the silhouette and penumbra edge terms,
    the mask) and Adam's update.  Returns the losses, the first step's
    gradient, the start and the parameters after the steps, and the
    mask."""
    H = W = t["size"]
    spp, bounces = t["spp"], t["bounces"]
    true, static = packed(config, device, dtype)
    keys = leaf_paths(static)
    with torch.no_grad():
        target = mean_image(true, static, H, W, spp, seed, bounces)
    p = true.detach().clone()
    for key, v in t["perturb"].items():
        p[keys.index(key)] = v
    start = p.clone()
    mask = trainable(keys, t["trainable"]).to(device=device, dtype=dtype)
    opt = Adam(t["lr"])
    losses, grad1 = [], None
    for _ in range(n_steps):
        leaf = p.detach().requires_grad_()
        img = mean_image(leaf, static, H, W, spp, seed, bounces)
        loss = mse(img, target)
        (grad,) = torch.autograd.grad(loss, leaf)
        adj = boundary.mse_adjoint(Vec3(*img.detach()), Vec3(*target))
        # the edge terms index pixels from screen coordinates, which
        # bfloat16 cannot hold at 1024²: they take float32 inputs always
        edge = boundary.full_boundary_term(
            p.detach().float(), static, Vec3(*(c.float() for c in adj)),
            H, W, n_edge_samples=t["edge_samples"],
            n_noise=t["edge_noise"], seed=seed + 7717, max_bounces=bounces,
            n_curve_samples=t["curve_samples"]).to(dtype)
        grad = (grad + edge * 1.0) * mask
        grad1 = grad.detach().clone() if grad1 is None else grad1
        losses.append(float(loss.detach()))
        p = opt.step(p.detach(), grad.detach())
    return dict(losses=losses, grad1=grad1.float(), start=start.float(),
                end=p.detach().float(), mask=mask.float())
