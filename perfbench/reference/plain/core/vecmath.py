"""Structure-of-arrays 3-vector math on torch tensors.

Port of `sail_tpu/core/vecmath.py`: a `Vec3` is a NamedTuple of three
tensors of one (broadcastable) shape, never a tensor with a trailing dim of
3.  Every expression keeps the JAX version's operation order, so the two
round alike; `normalize` uses `1/sqrt` where JAX uses `lax.rsqrt` (the CUDA
kernel does the same, so the port agrees with itself bit for bit and with
JAX to float32 rounding).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..utils.device import resolve


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # -- geometry -----------------------------------------------------------
    def dot(self, o: "Vec3") -> torch.Tensor:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_sq(self) -> torch.Tensor:
        return self.dot(self)

    def length(self) -> torch.Tensor:
        return torch.sqrt(clip(self.length_sq(), 1e-20))

    def normalize(self, eps: float = 1e-20) -> "Vec3":
        return self * rsqrt(clip(self.length_sq(), eps))

    def min_component(self) -> torch.Tensor:
        return torch.minimum(torch.minimum(self.x, self.y), self.z)

    def max_component(self) -> torch.Tensor:
        return torch.maximum(torch.maximum(self.x, self.y), self.z)

    # -- utilities ----------------------------------------------------------
    @property
    def shape(self):
        return torch.broadcast_shapes(self.x.shape, self.y.shape, self.z.shape)

    def broadcast_to(self, shape) -> "Vec3":
        return Vec3(self.x.broadcast_to(shape), self.y.broadcast_to(shape),
                    self.z.broadcast_to(shape))

    def stack(self, dim: int = -1) -> torch.Tensor:
        """Materialize as a dense [..., 3] tensor (host/IO boundary only)."""
        return torch.stack(torch.broadcast_tensors(self.x, self.y, self.z),
                           dim=dim)

    def clip(self, lo, hi) -> "Vec3":
        return Vec3(clip(self.x, lo, hi), clip(self.y, lo, hi),
                    clip(self.z, lo, hi))


@functools.lru_cache(maxsize=None)
def _bound(value: float, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype)


def clip(x: torch.Tensor, lo: float = None, hi: float = None) -> torch.Tensor:
    """`jnp.clip(x, lo, hi)` with JAX's gradient: `minimum(maximum(x, lo),
    hi)` against 0-d bounds, so where x sits exactly on a bound the gradient
    splits 0.5 / 0.5 as JAX's does (`torch.clamp` gives x all of it).  The
    value is `torch.clamp`'s, bit for bit.  Every clip of a differentiable
    value in the port goes through here."""
    if lo is not None:
        x = torch.maximum(x, _bound(lo, x.dtype))
    if hi is not None:
        x = torch.minimum(x, _bound(hi, x.dtype))
    return x


def rsqrt(x: torch.Tensor) -> torch.Tensor:
    """1/sqrt(x) with two correctly rounded steps (the kernel's `1.0f/sqrtf`)."""
    return 1.0 / torch.sqrt(x)


def vec3(x, y, z, dtype=torch.float32, device=None) -> Vec3:
    """A Vec3 of three tensors of `dtype` on `device` (the card unless the
    caller asks for another device), from numbers or tensors."""
    device = resolve(device, "vec3")
    return Vec3(*(torch.as_tensor(v, dtype=dtype, device=device)
                  for v in (x, y, z)))


def splat(v, dtype=torch.float32, device=None) -> Vec3:
    """A Vec3 from a length-3 sequence or a number (a Vec3 as it is), on
    `device` (the card unless the caller asks for another device)."""
    if isinstance(v, Vec3):
        return v
    if hasattr(v, "__len__"):
        return vec3(v[0], v[1], v[2], dtype, device)
    return vec3(v, v, v, dtype, device)


def where(c: torch.Tensor, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(torch.where(c, a.x, b.x), torch.where(c, a.y, b.y),
                torch.where(c, a.z, b.z))


def from_stacked(a: torch.Tensor, dim: int = -1) -> Vec3:
    """A Vec3 of the three slices of `a` along `dim` (length 3): the
    inverse of `Vec3.stack`."""
    x, y, z = torch.unbind(a, dim)
    return Vec3(x, y, z)


def lerp(a: Vec3, b: Vec3, t) -> Vec3:
    return a * (1.0 - t) + b * t


def full(shape, value: float, like: torch.Tensor) -> torch.Tensor:
    """A tensor of `shape` with `like`'s float dtype and device."""
    return torch.full(shape, value, dtype=like.dtype, device=like.device)


def zeros_vec(shape, like: torch.Tensor) -> Vec3:
    z = full(shape, 0.0, like)
    return Vec3(z, z, z)


# -- shading frames ---------------------------------------------------------

def world_to_local(v: Vec3, n: Vec3, s: Vec3, t: Vec3) -> Vec3:
    """Express world vector `v` in the orthonormal frame (s, t, n); local z
    is the normal axis."""
    return Vec3(v.dot(s), v.dot(t), v.dot(n))


def local_to_world(v: Vec3, n: Vec3, s: Vec3, t: Vec3) -> Vec3:
    return Vec3(
        s.x * v.x + t.x * v.y + n.x * v.z,
        s.y * v.x + t.y * v.y + n.y * v.z,
        s.z * v.x + t.z * v.y + n.z * v.z,
    )


def ortho(d: Vec3) -> Vec3:
    """A vector orthogonal to d."""
    big = (torch.abs(d.x) > 1e-5) | (torch.abs(d.y) > 1e-5)
    zx = torch.zeros_like(d.x)
    zz = torch.zeros_like(d.z)
    return where(big, Vec3(d.y, -d.x, zz), Vec3(zx, d.z, -d.y))


def onb(n: Vec3) -> tuple[Vec3, Vec3]:
    """An orthonormal basis (s, t) around the unit normal n."""
    s = ortho(n).normalize()
    t = n.cross(s)
    return s, t


def reflect(wo: Vec3, n: Vec3) -> Vec3:
    """Mirror direction of incoming -wo about n: GLSL reflect(-wo, n)."""
    return n * (2.0 * wo.dot(n)) - wo


def refract_dir(i: Vec3, n: Vec3, eta):
    """GLSL refract of incident `i` about `n` with eta = etaI/etaT:
    (direction, total-internal-reflection mask); the zero vector on TIR.
    The double `where` keeps sqrt's input positive on TIR lanes, so the
    backward pass stays finite there."""
    cos_i = -i.dot(n)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 0.0
    k_safe = torch.where(tir, 1.0, clip(k, 1e-12))
    d = i * eta + n * (eta * cos_i - torch.sqrt(k_safe))
    return where(tir, zeros_vec(d.shape, d.x), d), tir


# -- misc -------------------------------------------------------------------

def quadratic(a, b, c):
    """Stable quadratic solve.  Returns (has_roots, t0, t1) with t0 <= t1;
    where has_roots is False the roots are garbage for the caller to mask.
    The double `where` keeps sqrt's input positive on masked lanes and the
    `a == 0` / `q == 0` substitutions avoid 0/0, as in the JAX version."""
    discrim = b * b - 4.0 * a * c
    ok = discrim >= 0.0
    root = torch.sqrt(torch.where(ok, clip(discrim, 1e-20), 1.0))
    root = torch.where(ok, root, 0.0)
    q = torch.where(b < 0.0, -0.5 * (b - root), -0.5 * (b + root))
    t0 = q / torch.where(a == 0.0, 1e-20, a)
    t1 = c / torch.where(q == 0.0, 1e-20, q)
    return ok, torch.minimum(t0, t1), torch.maximum(t0, t1)


def spherical_direction(sin_theta, cos_theta, phi) -> Vec3:
    return Vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                cos_theta)


# -- shading-space trig (local frame, z = normal) ---------------------------

def cos_theta(w: Vec3):
    return w.z


def cos2_theta(w: Vec3):
    return w.z * w.z


def abs_cos_theta(w: Vec3):
    return torch.abs(w.z)


def sin2_theta(w: Vec3):
    return clip(1.0 - w.z * w.z, 0.0)


def sin_theta(w: Vec3):
    return torch.sqrt(clip(sin2_theta(w), 1e-12))


def tan2_theta(w: Vec3):
    """1e5 where cos²θ < 1e-5; the division sees 1 there (a double
    `where`), so its derivative meets no 0/0 on the lanes it does not
    give."""
    c2 = cos2_theta(w)
    near = c2 < 1e-5
    return torch.where(near, 1e5, sin2_theta(w)
                       / clip(torch.where(near, 1.0, c2), 1e-20))


def cos_phi(w: Vec3):
    s = sin_theta(w)
    return torch.where(torch.abs(s) < 1e-3, 1.0,
                       clip(w.x / torch.where(s == 0, 1.0, s), -1.0, 1.0))


def sin_phi(w: Vec3):
    s = sin_theta(w)
    return torch.where(torch.abs(s) < 1e-3, 0.0,
                       clip(w.y / torch.where(s == 0, 1.0, s), -1.0, 1.0))


def same_hemisphere(w: Vec3, wp: Vec3):
    return w.z * wp.z > 1e-5


def cos2_phi(w: Vec3):
    c = cos_phi(w)
    return c * c


def sin2_phi(w: Vec3):
    s = sin_phi(w)
    return s * s
