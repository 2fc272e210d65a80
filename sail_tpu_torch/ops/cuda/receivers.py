"""KH: the penumbra term's primary and mirror receivers
(`diff/boundary.shadow_boundary_term`) as one CUDA kernel with its adjoint.

KP (`ops/cuda/penumbra.py`) reads, for each receiver (the surface a pixel
sees directly, and where the scene has a Mirror material the surface seen
through one mirror bounce), its shading planes, its material row and object
id, and its points, live in the camera.  The plain version
(`diff/boundary._shadow_term_plain`) finds them with eager torch over
(H, W) tensors, twice (detached, and again under autograd), and stacks
them; on a card, `live_receivers` does it through `_Receivers`, a
`torch.autograd.Function` whose forward launches KH (`csrc/receivers.cu`,
`trace_receivers`: planes, ints and points in KP's layout, one thread a
pixel) and whose backward launches KH's adjoint (`receivers_adjoint`: the
points' cotangent onto the camera's 14 parameters, block rows summed by
K2's reduce).  The points are the detached hits' values, so KH computes
each hit once.  No fallback from one to the other: `shadow_boundary_term`
takes this path for CUDA tensors and the plain one for CPU tensors.

KH replaces no TPU kernel: the JAX package's receivers are XLA's inside the
jitted train step (`sail_tpu/parallel/render_sharded.py:257`).
`trace_receivers.launches` and `receivers_adjoint.launches` count their
launches (each adjoint launch is followed by one `reduce_grad_rows`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import megakernel as mk
from ...utils import build

_SOURCE = "receivers"
# the kernel's layout (csrc/receivers.cuh): floats a receiver writes per
# pixel (KP's plane set), the camera's parameters, and its thread block
# (columns, rows)
PLANES = 18
CAMERA = 14
BLOCK = (16, 16)
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _entries():
    lib = build.load(_SOURCE)
    limits = (ctypes.c_int * 4)()
    lib.sail_receivers_limits(limits)
    built = (tuple(limits[:2]), limits[2], limits[3])
    if built != (BLOCK, PLANES, CAMERA):
        raise RuntimeError(f"KH was built for (block, planes, camera) "
                           f"{built}, the wrapper expects "
                           f"{(BLOCK, PLANES, CAMERA)}")
    fwd, bwd = lib.sail_receivers, lib.sail_receivers_grad
    fwd.argtypes = [_PTR] * 2 + [_INT] * 8 + [_PTR] * 3 + [_INT] * 2 + [_PTR]
    bwd.argtypes = [_PTR] * 2 + [_INT] * 8 + [_PTR] * 2 + [_INT] * 2 + [_PTR]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _scene(params: torch.Tensor, static):
    """The scene arguments of KH's C entries, checked: (params, table,
    its counts and the camera's offset)."""
    if not params.is_cuda:
        raise TypeError("KH runs on the card: the scene must be a CUDA "
                        "tensor")
    off = mk.scene_table(static).offsets
    if not (params.dtype == torch.float32 and params.shape == (off.size,)
            and params.is_contiguous()):
        raise TypeError(f"KH's params must be a contiguous float32 tensor "
                        f"of {off.size} values; got {tuple(params.shape)} "
                        f"{params.dtype}")
    return (params.data_ptr(),
            mk._device_table(static, params.device).data_ptr(),
            *mk._counts(static), off.camera)


def trace_receivers(params: torch.Tensor, static, height: int, width: int,
                    R: int):
    """KH on the card: (points (R, 3, H, W), planes (R, PLANES, H, W),
    ints (R, 2, H, W) int32) of the R receivers (1: the primary; 2: and the
    mirror's) of the scene `params`, as KP takes them.  Raises for a tensor
    not on a card."""
    scene = _scene(params, static)
    if R not in (1, 2) or height < 1 or width < 1:
        raise ValueError(f"bad KH shapes: R {R}, {height}x{width}")
    dev = params.device
    xs = torch.empty((R, 3, height, width), dtype=torch.float32, device=dev)
    planes = torch.empty((R, PLANES, height, width), dtype=torch.float32,
                         device=dev)
    ints = torch.empty((R, 2, height, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _entries()[0](*scene, R, planes.data_ptr(), ints.data_ptr(),
                            xs.data_ptr(), height, width,
                            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"KH launch failed: cudaError_t {err}")
    mk.count_launch(trace_receivers)
    return xs, planes, ints


trace_receivers.launches = 0


def receivers_adjoint(params: torch.Tensor, static, g_xs: torch.Tensor):
    """KH's adjoint on the card: the cotangent `g_xs` (R, 3, H, W) of the
    receivers' points onto the camera's CAMERA parameters (eye, right, up,
    back, tan_half_fovy, aspect), summed over pixels in a fixed order (one
    row a thread block, then K2's reduce).  Raises for a tensor not on a
    card."""
    scene = _scene(params, static)
    R, three, H, W = g_xs.shape
    if not (R in (1, 2) and three == 3 and g_xs.dtype == torch.float32
            and g_xs.is_contiguous() and g_xs.device == params.device):
        raise TypeError(f"KH's cotangent must be a contiguous float32 "
                        f"(R, 3, H, W) tensor, R 1 or 2, on {params.device}; "
                        f"got {tuple(g_xs.shape)} {g_xs.dtype} on "
                        f"{g_xs.device}")
    dev = params.device
    bx, by = BLOCK
    rows = torch.empty((-(-W // bx) * -(-H // by), CAMERA),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _entries()[1](*scene, R, g_xs.data_ptr(), rows.data_ptr(), H, W,
                            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"KH's adjoint launch failed: cudaError_t {err}")
    mk.count_launch(receivers_adjoint)
    return mk.reduce_grad_rows(rows)


receivers_adjoint.launches = 0


class _Receivers(torch.autograd.Function):
    """The receivers' points of the live camera (CAMERA,), with their
    planes and ints (not differentiable); the backward is the adjoint's."""

    @staticmethod
    def forward(ctx, camera, params, static, height, width, R, kernels):
        trace, adjoint = kernels
        xs, planes, ints = trace(params, static, height, width, R)
        ctx.mark_non_differentiable(planes, ints)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(params)
        ctx.static, ctx.adjoint = static, adjoint
        return xs, planes, ints

    @staticmethod
    def backward(ctx, g_xs, _planes, _ints):
        g = None
        if g_xs is not None:
            (params,) = ctx.saved_tensors
            g = ctx.adjoint(params, ctx.static, g_xs.contiguous())
        return g, None, None, None, None, None, None


def live_receivers(camera: torch.Tensor, params: torch.Tensor, static,
                   height: int, width: int, R: int,
                   kernels=(trace_receivers, receivers_adjoint)):
    """(points, planes, ints) of the R receivers through KH (`kernels`:
    KH's forward and adjoint, or two functions of the same contract), the
    points live in `camera`, the camera's CAMERA parameters of the flat
    scene (a slice of it, or their stack), and the scene the detached flat
    tensor `params` (whose camera has `camera`'s values)."""
    return _Receivers.apply(camera, params.detach().contiguous(), static,
                            height, width, R, kernels)
