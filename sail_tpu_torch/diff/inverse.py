"""Inverse rendering: recover scene parameters from a target image (port of
`sail_tpu/diff/inverse.py`; BASELINE.md config 5).

    params, static = scene.pack()
    mesh = make_mesh(1)
    target = render_sharded(params, static, mesh, H, W, spp)
    result = optimize(perturbed, target, static, mesh, H, W, spp,
                      trainable=lambda k: ".materials" in k or ".lights" in k)

The JAX package's optax transformations are pure functions of a state; a
`torch.optim` optimizer holds its tensor, so `optimize` takes factories:
`optimizer(params)` (default `torch.optim.Adam(params, lr)`, as
`optax.adam(lr)`) and `scheduler(optimizer)` (for example
`CosineAnnealingLR(opt, T_max=steps, eta_min=0)`, the formula of
`optax.cosine_decay_schedule(lr, steps)`), stepped once per step.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..core.vecmath import Vec3
from ..parallel.mesh import Mesh
from ..parallel.render_sharded import make_train_step, trainable_mask
from ..scene.scene import SceneStatic, leaf_paths


@dataclass
class OptimizeResult:
    params: torch.Tensor      # the recovered flat scene parameters
    losses: list = field(default_factory=list)
    steps: int = 0


def optimize(params: torch.Tensor, target: Vec3, static: SceneStatic,
             mesh: Mesh, height: int, width: int, spp: int,
             steps: int = 100, learning_rate: float = 5e-2,
             optimizer: Optional[Callable] = None,
             trainable: Optional[Callable[[str], bool]] = None,
             seed: int = 0, max_bounces: int = 5,
             callback: Optional[Callable] = None, boundary: bool = True,
             scheduler: Optional[Callable] = None) -> OptimizeResult:
    """Gradient descent on the scene parameters toward `target`, on the
    mesh's device.  `trainable`: a predicate over `leaf_paths` keys
    choosing the parameters to fit (default: materials and lights).
    `boundary`: add the silhouette and penumbra edge terms (needed for
    unbiased geometry and camera gradients; `make_train_step`).
    `callback(step, loss, params)` runs after each step."""
    p = params.detach().to(mesh.device).clone().requires_grad_()
    opt = (torch.optim.Adam([p], lr=learning_rate) if optimizer is None
           else optimizer(p))
    sched = None if scheduler is None else scheduler(opt)
    if trainable is None:
        trainable = lambda k: ".materials" in k or ".lights" in k
    step = make_train_step(static, mesh, height, width, spp, opt, seed=seed,
                           max_bounces=max_bounces,
                           trainable=trainable_mask(static, trainable),
                           boundary=boundary)
    result = OptimizeResult(params=p.detach())
    for i in range(steps):
        loss = float(step(target))
        if sched is not None:
            sched.step()
        result.losses.append(loss)
        result.steps = i + 1
        if callback is not None:
            callback(i, loss, p.detach())
    result.params = p.detach().clone()
    return result


def finite_difference_grad(loss_fn: Callable, params: torch.Tensor, leaf,
                           eps: float = 1e-3,
                           static: SceneStatic = None) -> float:
    """Central difference of `loss_fn(params)` in one parameter: `leaf` is
    its flat index, or its `leaf_paths` key (with `static`).  The validation
    the gradient tests use."""
    if isinstance(leaf, str):
        if static is None:
            raise ValueError("a leaf key needs the scene's static structure")
        paths = leaf_paths(static)
        if leaf not in paths:
            raise ValueError(f"no parameter {leaf!r} in the scene")
        leaf = paths.index(leaf)
    v0 = float(params[leaf])

    def at(v):
        p = params.detach().clone()
        p[leaf] = v
        return float(loss_fn(p))

    return (at(v0 + eps) - at(v0 - eps)) / (2 * eps)
