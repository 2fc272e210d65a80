"""Rendering, the image loss and the inverse-rendering train step on a
mesh (port of `sail_tpu/parallel/render_sharded.py`).

Image rows shard over the mesh's "tile" axis and samples over "spp": rank
di = ti·n_spp + si renders rows [ti·rows, (ti+1)·rows) with the samples
sample0 + si·spp_local ... through `render_tile_fast` (K1 forward, K2 and
its reduce backward on the card; their plain versions on the CPU), drawing
the streams one device would (keys from the global sample index and row).
The blocks of a tile are added in si order and the tiles stacked in ti
order, so a layout that splits rows only gives one rank's image bit for
bit, and any layout the same image up to the order of that sum.

Within one process every rank is local and the mesh's sums are tensor
additions, differentiable by autograd.  Once a process group is up, a mesh
that holds ranks of each of its processes (`Mesh.gathers`) gathers each
rank's block (`all_gather`) and adds them in rank order on every process,
so each process holds the whole image, the same bits everywhere; its
gradient is `sharded_value_and_grad`'s (each rank's block back-propagated
with its rows of the loss adjoint, the ranks' gradients gathered and added
in rank order), the transpose psum of the JAX package's shard_map.  Gloo (CPU ranks) has `all_gather`; NCCL runs the
same calls on the card.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .. import constants as C
from ..core.vecmath import Vec3
from ..diff.boundary import full_boundary_term, mse_adjoint
from ..ops.cuda.megakernel import render_tile_fast
from ..scene.scene import SceneStatic, leaf_paths
from ..utils.metrics import span, spanned
from .mesh import Mesh, process_count


def _on(device: torch.device, v: Vec3) -> Vec3:
    return Vec3(*(c.to(device) for c in v))


def _split(mesh: Mesh, height: int, spp: int):
    """(rows, samples) of each rank's block; raises where the mesh does not
    divide the image (`render_sharded.py:126-127`)."""
    if height % mesh.n_tile or spp % mesh.n_spp:
        raise ValueError(f"a {mesh.n_tile} x {mesh.n_spp} mesh does not "
                         f"divide {height} rows and {spp} samples")
    return height // mesh.n_tile, spp // mesh.n_spp


def _block(params, static, mesh, di, rank, height, width, spp, seed,
           max_bounces, sample0) -> torch.Tensor:
    """Rank di's spp-SUM as one (3, rows, width) tensor on its device,
    differentiable in `params`."""
    rows, spp_local = _split(mesh, height, spp)
    ti, si = divmod(di, mesh.n_spp)
    return torch.stack(render_tile_fast(
        params.to(rank.device), seed, sample0 + si * spp_local, ti * rows,
        static, rows, width, spp_local, height, max_bounces))


def _gather(mesh: Mesh, local: list) -> list:
    """Every rank's tensor, in mesh order, on the mesh's device, from
    `local` (this process's ranks' tensors, in mesh order): the list itself
    where the mesh does not gather (`Mesh.gathers`), else one `all_gather`
    of each process's stack (every process must own as many ranks)."""
    dev = mesh.device
    if not mesh.gathers:
        if len(local) != mesh.size:
            raise ValueError("a mesh whose ranks other processes own must "
                             "hold ranks of every process of the group")
        return [t.to(dev) for t in local]
    counts = {p: sum(r.process == p for r in mesh.ranks)
              for p in range(process_count())}
    if len(set(counts.values())) != 1:
        raise ValueError(f"a mesh across processes needs as many ranks on "
                         f"each; it has {counts}")
    wire = dev if dist.get_backend() == "nccl" else torch.device("cpu")
    mine = torch.stack([t.detach() for t in local]).to(wire)
    parts = [torch.empty_like(mine) for _ in range(process_count())]
    dist.all_gather(parts, mine)
    taken = {p: iter(part) for p, part in enumerate(parts)}
    return [next(taken[r.process]).to(dev) for r in mesh.ranks]


def _add(terms: list) -> torch.Tensor:
    """Σ terms, added left to right."""
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total


def _assemble(mesh: Mesh, blocks: list) -> torch.Tensor:
    """The (3, H, W) spp-SUM from every rank's block in mesh order: each
    tile's blocks added in si order, the tiles stacked in ti order."""
    n = mesh.n_spp
    return torch.cat([_add(blocks[ti * n:(ti + 1) * n])
                      for ti in range(mesh.n_tile)], dim=1)


def render_sharded(params: torch.Tensor, static: SceneStatic, mesh: Mesh,
                   height: int, width: int, spp: int, seed: int = 0,
                   max_bounces: int = C.MAX_BOUNCES, sample0: int = 0,
                   return_sum: bool = False) -> Vec3:
    """The mean image over `spp` samples, a Vec3 of (H, W) tensors on the
    mesh's device, whole on every process.  `sample0` is the first global
    sample index (disjoint ranges accumulate to one render); `return_sum`
    gives the spp-SUM instead of the mean.  Differentiable in `params`
    where the mesh does not gather (`Mesh.gathers`)."""
    local = [_block(params, static, mesh, di, rank, height, width, spp, seed,
                    max_bounces, sample0) for di, rank in mesh.local_ranks]
    acc = _assemble(mesh, _gather(mesh, local))
    return Vec3(*(acc if return_sum else acc * (1.0 / spp)))


def _mse(img: Vec3, target: Vec3, height: int, width: int) -> torch.Tensor:
    se = ((img.x - target.x) ** 2 + (img.y - target.y) ** 2
          + (img.z - target.z) ** 2)
    return torch.sum(se) / (height * width * 3)


def sharded_loss_and_image(params: torch.Tensor, target: Vec3,
                           static: SceneStatic, mesh: Mesh, height: int,
                           width: int, spp: int, seed: int = 0,
                           max_bounces: int = C.MAX_BOUNCES):
    """(mean squared error against `target` over pixels and channels, the
    mean image), differentiable in `params` where the mesh does not gather
    (else `sharded_value_and_grad` gives the gradient); the image lets
    callers form the loss adjoint of the boundary terms without rendering
    again."""
    if mesh.gathers and params.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("autograd does not pass the mesh's collectives: "
                           "take the gradient with sharded_value_and_grad")
    img = render_sharded(params, static, mesh, height, width, spp, seed,
                         max_bounces)
    return _mse(img, _on(mesh.device, target), height, width), img


def sharded_loss(params: torch.Tensor, target: Vec3, static: SceneStatic,
                 mesh: Mesh, height: int, width: int, spp: int,
                 seed: int = 0, max_bounces: int = C.MAX_BOUNCES):
    """The loss of `sharded_loss_and_image` alone."""
    return sharded_loss_and_image(params, target, static, mesh, height,
                                  width, spp, seed, max_bounces)[0]


@spanned("sail.interior")
def _value_grad_image(params, target, static, mesh, height, width, spp,
                      seed, max_bounces):
    """(loss, interior gradient, mean image), each the same bits on every
    process: each local rank's block rendered with its own leaf of the
    parameters, the image gathered, the loss adjoint formed from it
    (`mse_adjoint`), each block back-propagated with its rows of the
    adjoint × 1/spp, and the ranks' gradients added in rank order."""
    rows, _ = _split(mesh, height, spp)
    leaves, blocks = [], []
    with torch.enable_grad():
        for di, rank in mesh.local_ranks:
            leaf = params.detach().to(rank.device).requires_grad_()
            leaves.append(leaf)
            blocks.append(_block(leaf, static, mesh, di, rank, height, width,
                                 spp, seed, max_bounces, 0))
    acc = _assemble(mesh, _gather(mesh, [b.detach() for b in blocks]))
    img = Vec3(*(acc * (1.0 / spp)))
    target = _on(mesh.device, target)
    adj = torch.stack(mse_adjoint(img, target))
    grads = []
    for (di, rank), leaf, block in zip(mesh.local_ranks, leaves, blocks):
        ti = di // mesh.n_spp
        g = (adj[:, ti * rows:(ti + 1) * rows] * (1.0 / spp)).to(rank.device)
        (grad,) = torch.autograd.grad(block, leaf, grad_outputs=g)
        grads.append(grad)
    grad = _add(_gather(mesh, grads)).to(params.device)
    return _mse(img, target, height, width), grad, img


def sharded_value_and_grad(params: torch.Tensor, target: Vec3,
                           static: SceneStatic, mesh: Mesh, height: int,
                           width: int, spp: int, seed: int = 0,
                           max_bounces: int = C.MAX_BOUNCES):
    """(the loss of `sharded_loss`, its flat gradient in `params`) on any
    mesh, across processes too, the same bits on every process; within one
    process the gradient is autograd's of `sharded_loss` up to the order
    of its float32 sums."""
    loss, grad, _ = _value_grad_image(params, target, static, mesh, height,
                                      width, spp, seed, max_bounces)
    return loss, grad


def make_train_step(static: SceneStatic, mesh: Mesh, height: int,
                    width: int, spp: int,
                    optimizer: torch.optim.Optimizer, seed: int = 0,
                    max_bounces: int = C.MAX_BOUNCES,
                    trainable: torch.Tensor = None, boundary: bool = True,
                    n_edge_samples: int = 192, n_noise: int = 2,
                    n_curve_samples: int = 32) -> Callable:
    """The inverse-rendering step (BASELINE.md config 5): `step(target)`
    takes the gradient of the image loss with respect to every scene
    parameter (`sharded_value_and_grad`), adds (`boundary`, the default)
    the silhouette and penumbra edge terms, zeroes the leaves `trainable`
    (a flat 0/1 tensor, `trainable_mask`) leaves out, and steps
    `optimizer`, whose one parameter is the flat scene tensor on the mesh's
    device, updated in place; every process ends the step with the same
    parameters.  Returns the loss before the update, detached.

    Without the edge terms the geometry and camera gradients are biased
    (autograd never sees the visibility steps the loss crosses); turn them
    off only where both are frozen.  Rank di runs the edge terms with its
    own noise seed, seed + 7717·(di + 1), and max(1, n_noise // ranks)
    passes; their sum in rank order over the ranks is the term."""
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

    @spanned("sail.train_step")
    def step(target: Vec3) -> torch.Tensor:
        target = _on(mesh.device, target)
        loss, grad, img = _value_grad_image(params, target, static, mesh,
                                            height, width, spp, seed,
                                            max_bounces)
        if boundary:
            adj = mse_adjoint(img, target)
            terms = [full_boundary_term(
                params.detach().to(rank.device), static,
                _on(rank.device, adj), height, width,
                n_edge_samples=n_edge_samples, n_noise=n_noise_local,
                seed=seed + 7717 * (di + 1), max_bounces=max_bounces,
                n_curve_samples=n_curve_samples)
                for di, rank in mesh.local_ranks]
            grad = grad + _add(_gather(mesh, terms)) * (1.0 / ndev)
        if mask is not None:
            grad = grad * mask
        params.grad = grad
        with span("sail.adam"):
            optimizer.step()
        return loss.detach()

    return step


def trainable_mask(static: SceneStatic,
                   predicate: Callable[[str], bool]) -> torch.Tensor:
    """A flat float32 0/1 tensor on the CPU: `predicate(key)` of each
    parameter's `leaf_paths` key (`.materials[1].kr`, ...)."""
    return torch.tensor([1.0 if predicate(k) else 0.0
                         for k in leaf_paths(static)], dtype=torch.float32)
