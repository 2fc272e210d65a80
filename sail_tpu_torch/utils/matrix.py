"""Host-side Vector/Matrix math (port of `sail_tpu/utils/matrix.py`; numpy).

Exported at the top level for user scene scripts, with the reference
library's surface.  Host-only convenience math for scene construction;
device-side vectors are :class:`sail_tpu_torch.core.vecmath.Vec3`.

Conventions:
- ``e(i)`` / ``e(i, j)`` are 1-based.
- ``Matrix.RotationX/Y/Z``/``Rotation(theta, axis)`` return 3x3 matrices;
  ``Translation``/``Scale`` of a 3-vector return 4x4 (translation in the
  last *column*).
- ``flatten()`` is column-major (GL upload order).
"""
from __future__ import annotations

import numbers

import numpy as np

__all__ = ["Vector", "Matrix"]

_PRECISION = 1e-6


def _as_elements(obj):
    if isinstance(obj, (Vector, Matrix)):
        return obj.elements
    return np.asarray(obj, dtype=np.float64)


class Vector:
    """n-dimensional host vector."""

    def __init__(self, elements):
        self.elements = np.array(_as_elements(elements), dtype=np.float64)
        if self.elements.ndim != 1:
            raise ValueError("Vector requires a 1-D sequence")

    # -- accessors ---------------------------------------------------------
    def e(self, i):
        """1-based element access; None when out of range."""
        if i < 1 or i > self.elements.size:
            return None
        return float(self.elements[i - 1])

    @property
    def x(self):
        return float(self.elements[0])

    @property
    def y(self):
        return float(self.elements[1])

    @property
    def z(self):
        return float(self.elements[2])

    def dimensions(self):
        return self.elements.size

    def dup(self):
        return Vector(self.elements.copy())

    def map(self, fn):
        return Vector([fn(v, i + 1) if _arity2(fn) else fn(v)
                       for i, v in enumerate(self.elements)])

    def flatten(self):
        return self.elements.tolist()

    # -- algebra -----------------------------------------------------------
    def modulus(self):
        return float(np.linalg.norm(self.elements))

    length = modulus

    def eql(self, other):
        other = _as_elements(other)
        return (self.elements.shape == other.shape
                and bool(np.all(np.abs(self.elements - other) < _PRECISION)))

    def toUnitVector(self):
        m = self.modulus()
        return self.dup() if m == 0 else Vector(self.elements / m)

    def angleFrom(self, other):
        other = _as_elements(other)
        denom = np.linalg.norm(self.elements) * np.linalg.norm(other)
        if denom == 0:
            return None
        return float(np.arccos(np.clip(
            np.dot(self.elements, other) / denom, -1.0, 1.0)))

    def add(self, other):
        return Vector(self.elements + _as_elements(other))

    def subtract(self, other):
        return Vector(self.elements - _as_elements(other))

    def multiply(self, k):
        return Vector(self.elements * k)

    def divide(self, k):
        return Vector(self.elements / k)

    def dot(self, other):
        return float(np.dot(self.elements, _as_elements(other)))

    def cross(self, other):
        other = _as_elements(other)
        if self.elements.size != 3 or other.size != 3:
            return None
        return Vector(np.cross(self.elements, other))

    def distanceFrom(self, other):
        return self.subtract(other).modulus()

    def divideByW(self):
        """Perspective divide of a homogeneous 4-vector."""
        return Vector(self.elements / self.elements[-1])

    def componentDivide(self, other):
        other = _as_elements(other)
        if self.elements.size != other.size:
            return None
        return Vector(self.elements / other)

    def maxComponent(self):
        return float(self.elements.max())

    def minComponent(self):
        return float(self.elements.min())

    # python operator sugar (not in the reference, free with numpy)
    def __add__(self, other):
        return self.add(other)

    def __sub__(self, other):
        return self.subtract(other)

    def __mul__(self, k):
        return self.multiply(k)

    def __repr__(self):
        return f"Vector({self.elements.tolist()})"

    # -- statics -----------------------------------------------------------
    @staticmethod
    def random(n):
        return Vector(np.random.rand(n))

    @staticmethod
    def Zero(n):
        return Vector(np.zeros(n))

    @staticmethod
    def min(a, b):
        return Vector(np.minimum(_as_elements(a), _as_elements(b)))

    @staticmethod
    def max(a, b):
        return Vector(np.maximum(_as_elements(a), _as_elements(b)))

    @classmethod
    def create(cls, elements):
        return cls(elements)


def _arity2(fn):
    try:
        from inspect import signature
        return len(signature(fn).parameters) >= 2
    except (TypeError, ValueError):
        return False


class Matrix:
    """n×m host matrix."""

    def __init__(self, elements):
        self.elements = np.array(_as_elements(elements), dtype=np.float64)
        if self.elements.ndim == 1:
            self.elements = self.elements[:, None]
        if self.elements.ndim != 2:
            raise ValueError("Matrix requires a 2-D sequence")

    # -- accessors ---------------------------------------------------------
    def e(self, i, j):
        """1-based element access."""
        n, m = self.elements.shape
        if i < 1 or i > n or j < 1 or j > m:
            return None
        return float(self.elements[i - 1, j - 1])

    def row(self, i):
        return Vector(self.elements[i - 1])

    def col(self, j):
        return Vector(self.elements[:, j - 1])

    def dimensions(self):
        n, m = self.elements.shape
        return {"rows": n, "cols": m}

    def dup(self):
        return Matrix(self.elements.copy())

    def map(self, fn):
        out = np.empty_like(self.elements)
        two = _arity2(fn)
        for (i, j), v in np.ndenumerate(self.elements):
            out[i, j] = fn(v, i + 1, j + 1) if two else fn(v)
        return Matrix(out)

    def eql(self, other):
        other = _as_elements(other)
        return (self.elements.shape == other.shape
                and bool(np.all(np.abs(self.elements - other) < _PRECISION)))

    def isSquare(self):
        n, m = self.elements.shape
        return n == m

    def flatten(self):
        """Column-major flatten, GL upload order."""
        return self.elements.T.reshape(-1).tolist()

    # -- algebra -----------------------------------------------------------
    def add(self, other):
        return Matrix(self.elements + _as_elements(other))

    def subtract(self, other):
        return Matrix(self.elements - _as_elements(other))

    def multiply(self, other):
        """Matrix @ (Matrix | Vector | scalar)."""
        if isinstance(other, numbers.Number):
            return Matrix(self.elements * other)
        els = _as_elements(other)
        prod = self.elements @ els
        return Vector(prod) if prod.ndim == 1 else Matrix(prod)

    x = multiply  # sylvester alias

    def transpose(self):
        return Matrix(self.elements.T)

    def determinant(self):
        return float(np.linalg.det(self.elements))

    det = determinant

    def isSingular(self):
        return self.isSquare() and abs(self.determinant()) < 1e-12

    def trace(self):
        return float(np.trace(self.elements))

    tr = trace

    def rank(self):
        return int(np.linalg.matrix_rank(self.elements))

    def max(self):
        return float(np.abs(self.elements).max())

    def inverse(self):
        """None when singular, as the reference library returns null."""
        if not self.isSquare():
            return None
        try:
            return Matrix(np.linalg.inv(self.elements))
        except np.linalg.LinAlgError:
            return None

    def round(self):
        return Matrix(np.round(self.elements))

    def __matmul__(self, other):
        return self.multiply(other)

    def __repr__(self):
        return f"Matrix({self.elements.tolist()})"

    # -- statics -----------------------------------------------------------
    @classmethod
    def create(cls, elements):
        return cls(elements)

    @staticmethod
    def I(n):
        return Matrix(np.eye(n))

    @staticmethod
    def Diagonal(elements):
        return Matrix(np.diag(_as_elements(elements)))

    @staticmethod
    def Zero(n, m):
        return Matrix(np.zeros((n, m)))

    @staticmethod
    def Random(n, m):
        return Matrix(np.random.rand(n, m))

    @staticmethod
    def Rotation(theta, axis=None):
        """2D rotation, or Rodrigues rotation about ``axis``."""
        c, s = np.cos(theta), np.sin(theta)
        if axis is None:
            return Matrix([[c, -s], [s, c]])
        a = _as_elements(axis)
        if a.size != 3:
            return None
        x, y, z = a / np.linalg.norm(a)
        t = 1 - c
        return Matrix([
            [t * x * x + c, t * x * y - s * z, t * x * z + s * y],
            [t * x * y + s * z, t * y * y + c, t * y * z - s * x],
            [t * x * z - s * y, t * y * z + s * x, t * z * z + c],
        ])

    @staticmethod
    def RotationX(t):
        c, s = np.cos(t), np.sin(t)
        return Matrix([[1, 0, 0], [0, c, -s], [0, s, c]])

    @staticmethod
    def RotationY(t):
        c, s = np.cos(t), np.sin(t)
        return Matrix([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    @staticmethod
    def RotationZ(t):
        c, s = np.cos(t), np.sin(t)
        return Matrix([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    @staticmethod
    def Scale(v):
        """Homogeneous scale: 2-vector → 3×3, 3-vector → 4×4."""
        a = _as_elements(v)
        m = Matrix.I(a.size + 1)
        m.elements[:a.size, :a.size] = np.diag(a)
        return m

    @staticmethod
    def Translation(v):
        """Homogeneous translation in the last column."""
        a = _as_elements(v)
        m = Matrix.I(a.size + 1)
        if a.size == 2:
            # 2-D translations go into the last *row*, as the reference
            # library writes them — kept for drop-in parity.
            m.elements[2, 0] = a[0]
            m.elements[2, 1] = a[1]
        else:
            m.elements[:a.size, a.size] = a
        return m
