"""Carry the JAX package's scene parameters across to the port.

The JAX package packs a scene into a pytree (`PackedScene`) and a
`SceneStatic`.  `params_from_jax_leaves(jax.tree.leaves(packed))` (leaves as
numpy arrays) gives the port's flat parameter tensor and `static_from_jax`
its `SceneStatic`, so both packages compute on the same numbers.  Nothing
here imports jax: the caller flattens.
"""
from __future__ import annotations

import numpy as np
import torch

from .scene import SceneStatic


def params_from_jax_leaves(leaves) -> torch.Tensor:
    """Flat float32 tensor from the leaves of the JAX `PackedScene`, in
    `jax.tree.flatten` order (the JAX megakernel's `_flatten_scene`)."""
    vals = [np.asarray(leaf, np.float32).reshape(()) for leaf in leaves]
    return torch.from_numpy(np.stack(vals))


def static_from_jax(static) -> SceneStatic:
    """The port's SceneStatic from the JAX package's (same fields)."""
    return SceneStatic(*(tuple(v) for v in static))
