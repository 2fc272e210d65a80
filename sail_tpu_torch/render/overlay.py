"""Selection-box overlay (port of `sail_tpu/render/overlay.py`; numpy).

The selected object's world bound box is projected through the camera model
the renderer uses and its 12 edges are drawn into the display image on the
host, after the frame's one device→host transfer: 24 line segments are not
worth a kernel launch.  Bounds come from the scene objects' own parameters,
and the projection inverts `core.camera.rays_for_pixels`.
"""
from __future__ import annotations

import math

import numpy as np

from ..scene import geometry as G


def object_bounds(obj) -> tuple[np.ndarray, np.ndarray] | None:
    """World-space AABB (min, max) of a scene object, or None if unbounded.

    Shape parameterizations follow the intersect ops (ops/intersect.py):
    frustum/quadric shapes live in object space where local z is world +y.
    """
    t = np.asarray(obj.temporary_translation, float)
    if isinstance(obj, (G.Cube, G.Rectangle, G.Cornellbox)):
        return np.asarray(obj.min, float) + t, np.asarray(obj.max, float) + t
    if isinstance(obj, G.Sphere):
        c = np.asarray(obj.center, float) + t
        r = float(obj.radius)
        return c - r, c + r
    if isinstance(obj, (G.Cone, G.Cylinder)):  # Cylinder subclasses Cone
        p = np.asarray(obj.position, float) + t
        r, h = float(obj.radius), float(obj.height)
        return (p + np.array([-r, min(h, 0.0), -r]),
                p + np.array([r, max(h, 0.0), r]))
    if isinstance(obj, G.Disk):
        p = np.asarray(obj.position, float) + t
        r = float(obj.radius)
        return p + np.array([-r, -1e-3, -r]), p + np.array([r, 1e-3, r])
    if isinstance(obj, G.Hyperboloid):
        p = np.asarray(obj.position, float) + t
        p1 = np.asarray(obj.p1, float)
        p2 = np.asarray(obj.p2, float)
        r = max(math.hypot(p1[0], p1[1]), math.hypot(p2[0], p2[1]))
        zlo, zhi = min(p1[2], p2[2]), max(p1[2], p2[2])
        return p + np.array([-r, zlo, -r]), p + np.array([r, zhi, r])
    if isinstance(obj, G.Paraboloid):
        p = np.asarray(obj.position, float) + t
        r = float(obj.radius)
        zlo, zhi = min(obj.z0, obj.z1), max(obj.z0, obj.z1)
        return p + np.array([-r, zlo, -r]), p + np.array([r, zhi, r])
    return None


def _camera_basis(camera):
    """Host copy of `core.camera.make_camera`'s basis."""
    eye = np.asarray(camera.eye, float)
    center = np.asarray(camera.center, float)
    up = np.asarray(getattr(camera, "up", (0.0, 1.0, 0.0)), float)
    z = eye - center
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, -x)
    y = y / np.linalg.norm(y)
    fovy = float(getattr(camera, "fovy", 55.0))
    aspect = float(getattr(camera, "aspect", 1.0))
    return eye, x, y, z, math.tan(fovy * math.pi / 360.0), aspect


def project_points(camera, pts: np.ndarray, width: int, height: int):
    """World points (N,3) → (pixel_xy (N,2), in_front (N,) bool), inverting
    the primary-ray construction of `core.camera.rays_for_pixels`."""
    eye, bx, by, bz, tanf, aspect = _camera_basis(camera)
    v = np.asarray(pts, float) - eye
    a = v @ bx
    b = v @ by
    c = -(v @ bz)          # distance along the view direction (-back)
    front = c > 1e-9
    cs = np.where(front, c, 1.0)
    ndc_x = (a / cs) / (tanf * aspect)
    ndc_y = (b / cs) / tanf
    px = (ndc_x + 1.0) * 0.5 * width - 0.5
    py = (1.0 - ndc_y) * 0.5 * height - 0.5
    return np.stack([px, py], -1), front


_EDGES = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
          (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]


def selection_segments(scene, index: int, width: int, height: int):
    """Screen-space line segments of the selected object's AABB wireframe."""
    bounds = object_bounds(scene.objects[index])
    if bounds is None:
        return []
    lo, hi = bounds
    corners = np.array([[(lo, hi)[i & 1][0], (lo, hi)[(i >> 1) & 1][1],
                         (lo, hi)[(i >> 2) & 1][2]] for i in range(8)])
    xy, front = project_points(scene.camera, corners, width, height)
    return [(xy[i], xy[j]) for i, j in _EDGES if front[i] and front[j]]


def _clip_segment(p0, p1, w, h):
    """Liang-Barsky clip of a screen-space segment to the viewport
    rectangle, or None if fully outside.  A corner barely past the
    near-plane guard (camera depth ~1e-8) projects to ~1e8 px; sizing the
    raster walk from the unclipped length would allocate gigabytes, so
    clip first, walk after."""
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    dx, dy = x1 - x0, y1 - y0
    t0, t1 = 0.0, 1.0
    for p, q in ((-dx, x0), (dx, (w - 1) - x0), (-dy, y0), (dy, (h - 1) - y0)):
        if p == 0.0:
            if q < 0.0:
                return None
            continue
        r = q / p
        if p < 0.0:
            if r > t1:
                return None
            t0 = max(t0, r)
        else:
            if r < t0:
                return None
            t1 = min(t1, r)
    return ((x0 + t0 * dx, y0 + t0 * dy), (x0 + t1 * dx, y0 + t1 * dy))


def _draw_line(img: np.ndarray, p0, p1, color):
    h, w = img.shape[:2]
    clipped = _clip_segment(p0, p1, w, h)
    if clipped is None:
        return
    p0, p1 = clipped
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    ts = np.linspace(0.0, 1.0, n)
    xs = np.round(p0[0] + (p1[0] - p0[0]) * ts).astype(int)
    ys = np.round(p0[1] + (p1[1] - p0[1]) * ts).astype(int)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def draw_selection(img: np.ndarray, scene, index, color=(1.0, 0.85, 0.2)):
    """Composite the selection wireframe into a display image (H, W, 3);
    draws in place when `img` is writable, else into a copy.  Returns the
    drawn array.  No-op when `index` is None or unbounded (Cornell boxes
    are not selectable, as in render/picking.py)."""
    if index is None:
        return img
    if not img.flags.writeable:
        img = img.copy()
    h, w = img.shape[:2]
    color = np.asarray(color, img.dtype)
    for p0, p1 in selection_segments(scene, index, w, h):
        _draw_line(img, p0, p1, color)
    return img
