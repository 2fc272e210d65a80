"""Rendering, the image loss and the inverse-rendering train step on a
mesh (port of `sail_tpu/parallel/render_sharded.py`), for one rank.

The JAX package shards image rows over the mesh's "tile" axis and samples
over "spp", each device tracing its block with the streams one chip would
draw (keys from the global sample index and row), so any layout renders
the same image.  Here the layout is `make_mesh`'s one rank: its block is the
whole image, rendered through `render_tile_fast` (K1 forward, K2 and its
reduce backward on the card; their plain versions on the CPU), and the
mesh's sums over devices are sums over one.  The multi-process layouts come
with the `torch.distributed` slice (ROADMAP.md queue 1, item 6).
"""
from __future__ import annotations

from typing import Callable

import torch

from .. import constants as C
from ..core.vecmath import Vec3
from ..diff.boundary import full_boundary_term, mse_adjoint
from ..ops.cuda.megakernel import render_tile_fast
from ..scene.scene import SceneStatic, leaf_paths
from .mesh import Mesh


def _on(mesh: Mesh, v: Vec3) -> Vec3:
    return Vec3(*(c.to(mesh.device) for c in v))


def _render_block(params, static, height, width, spp, seed, sample0,
                  max_bounces, mesh):
    """The spp-SUM of this rank's block, the whole image on one rank,
    differentiable in `params`."""
    return render_tile_fast(params.to(mesh.device), seed, sample0, 0, static,
                            height, width, spp, height, max_bounces)


def render_sharded(params: torch.Tensor, static: SceneStatic, mesh: Mesh,
                   height: int, width: int, spp: int, seed: int = 0,
                   max_bounces: int = C.MAX_BOUNCES, sample0: int = 0,
                   return_sum: bool = False) -> Vec3:
    """The mean image over `spp` samples, a Vec3 of (H, W) tensors on the
    mesh's device.  `sample0` is the first global sample index (disjoint
    ranges accumulate to one render); `return_sum` gives the spp-SUM
    instead of the mean."""
    acc = _render_block(params, static, height, width, spp, seed, sample0,
                        max_bounces, mesh)
    return acc if return_sum else acc * (1.0 / spp)


def sharded_loss_and_image(params: torch.Tensor, target: Vec3,
                           static: SceneStatic, mesh: Mesh, height: int,
                           width: int, spp: int, seed: int = 0,
                           max_bounces: int = C.MAX_BOUNCES):
    """(mean squared error against `target` over pixels and channels, the
    mean image), differentiable in `params`; the image lets callers form
    the loss adjoint of the boundary terms without rendering again."""
    img = _render_block(params, static, height, width, spp, seed, 0,
                        max_bounces, mesh) * (1.0 / spp)
    target = _on(mesh, target)
    se = ((img.x - target.x) ** 2 + (img.y - target.y) ** 2
          + (img.z - target.z) ** 2)
    return torch.sum(se) / (height * width * 3), img


def sharded_loss(params: torch.Tensor, target: Vec3, static: SceneStatic,
                 mesh: Mesh, height: int, width: int, spp: int,
                 seed: int = 0, max_bounces: int = C.MAX_BOUNCES):
    """The loss of `sharded_loss_and_image` alone."""
    return sharded_loss_and_image(params, target, static, mesh, height,
                                  width, spp, seed, max_bounces)[0]


def make_train_step(static: SceneStatic, mesh: Mesh, height: int,
                    width: int, spp: int,
                    optimizer: torch.optim.Optimizer, seed: int = 0,
                    max_bounces: int = C.MAX_BOUNCES,
                    trainable: torch.Tensor = None, boundary: bool = True,
                    n_edge_samples: int = 192, n_noise: int = 2,
                    n_curve_samples: int = 32) -> Callable:
    """The inverse-rendering step (BASELINE.md config 5): `step(target)`
    takes the gradient of the image loss with respect to every scene
    parameter, adds (`boundary`, the default) the silhouette and penumbra
    edge terms, zeroes the leaves `trainable` (a flat 0/1 tensor,
    `trainable_mask`) leaves out, and steps `optimizer`, whose one
    parameter is the flat scene tensor on the mesh's device, updated in
    place.  Returns the loss before the update, detached.

    Without the edge terms the geometry and camera gradients are biased
    (autograd never sees the visibility steps the loss crosses); turn them
    off only where both are frozen.  Each device runs the edge terms with
    its own noise seed (seed + 7717·(device + 1)) and n_noise / devices
    passes, and their mean is the term."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if len(params) != 1:
        raise ValueError("the optimizer must hold one tensor: the flat scene "
                         "parameters")
    (params,) = params
    if params.device != mesh.device:
        raise ValueError(f"the parameters live on {params.device}, the mesh "
                         f"on {mesh.device}")
    ndev = mesh.size
    n_noise_local = max(1, n_noise // ndev)
    mask = None if trainable is None else trainable.to(params)

    def step(target: Vec3) -> torch.Tensor:
        target = _on(mesh, target)
        loss, img = sharded_loss_and_image(params, target, static, mesh,
                                           height, width, spp, seed,
                                           max_bounces)
        (grad,) = torch.autograd.grad(loss, params)
        if boundary:
            bnd = full_boundary_term(
                params.detach(), static, mse_adjoint(img, target), height,
                width, n_edge_samples=n_edge_samples, n_noise=n_noise_local,
                seed=seed + 7717, max_bounces=max_bounces,
                n_curve_samples=n_curve_samples)
            grad = grad + bnd * (1.0 / ndev)
        if mask is not None:
            grad = grad * mask
        params.grad = grad
        optimizer.step()
        return loss.detach()

    return step


def trainable_mask(static: SceneStatic,
                   predicate: Callable[[str], bool]) -> torch.Tensor:
    """A flat float32 0/1 tensor on the CPU: `predicate(key)` of each
    parameter's `leaf_paths` key (`.materials[1].kr`, ...)."""
    return torch.tensor([1.0 if predicate(k) else 0.0
                         for k in leaf_paths(static)], dtype=torch.float32)
