"""The benchmark scenes the port renders (BASELINE.md configs 1 and 2;
`sail_tpu/scenes.py` holds all of them), the many-object scene of
`tools/many_object_bench.py`, and check scenes for the shapes and the
batched fold.  Cameras look from -z toward +z."""
from __future__ import annotations

import math

from . import (AreaLight, Camera, Cone, Cornellbox, Cube, Cylinder, Disk,
               Hyperboloid, Matte, Mirror, Paraboloid, Rectangle, Scene,
               Sphere, UniformColor)


def cornell_matte(light_emission=(5.0, 5.0, 5.0)) -> Scene:
    """Config 1: Cornell box + single matte sphere + ceiling area light."""
    scene = Scene()
    scene.add(Camera((0.0, 0.0, -2.5), (0.0, 0.0, 0.0)))
    scene.add(Cornellbox((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)))
    scene.add(Sphere((0.0, -0.6, 0.0), 0.4, Matte(kd=1.0)))
    scene.add(AreaLight(
        Rectangle((-0.3, 0.98, -0.3), (0.3, 0.98, 0.3), Matte()),
        light_emission))
    return scene


def cornell_mirror(light_emission=(5.0, 5.0, 5.0)) -> Scene:
    """Config 2: Cornell box + mirror sphere + matte sphere."""
    scene = Scene()
    scene.add(Camera((0.0, 0.0, -2.5), (0.0, 0.0, 0.0)))
    scene.add(Cornellbox((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)))
    scene.add(Sphere((-0.45, -0.6, -0.2), 0.4, Mirror(kr=1.0)))
    scene.add(Sphere((0.45, -0.6, 0.2), 0.4, Matte(kd=1.0)))
    scene.add(AreaLight(
        Rectangle((-0.3, 0.98, -0.3), (0.3, 0.98, 0.3), Matte()),
        light_emission))
    return scene


def open_lights() -> Scene:
    """Not a benchmark config: a scene that reaches the branches of the
    ported categories that configs 1 and 2 do not.  No enclosing box, so
    rays escape; a rough (Oren–Nayar) matte floor and sphere, a mirror, an
    emissive sphere that is not a light, two area lights (one with a
    reversed normal, facing the camera) and a 3:2 camera."""
    scene = Scene()
    scene.add(Camera((0.0, 0.4, -3.0), (0.0, -0.2, 0.0), aspect=1.5))
    scene.add(Rectangle((-1.5, -1.0, -1.5), (1.5, -1.0, 1.5),
                        Matte(kd=0.8, sigma=25.0),
                        UniformColor((0.9, 0.85, 0.7))))
    scene.add(Sphere((-0.55, -0.5, 0.1), 0.5, Matte(kd=0.9, sigma=20.0),
                     UniformColor((0.8, 0.3, 0.25))))
    scene.add(Sphere((0.45, -0.65, -0.45), 0.35, Mirror(kr=0.9)))
    scene.add(Sphere((1.0, -0.7, 0.3), 0.3, Matte(),
                     emission=(3.0, 1.5, 0.5)))
    scene.add(AreaLight(Rectangle((-0.5, 1.4, -0.5), (0.5, 1.4, 0.5)),
                        (5.0, 5.0, 5.0)))
    scene.add(AreaLight(Rectangle((-0.8, -0.6, 1.6), (0.8, 0.8, 1.6),
                                  reverse_normal=True), (0.5, 1.0, 2.0)))
    return scene


def many_spheres(n_spheres: int) -> Scene:
    """The many-object scene of `tools/many_object_bench.py`: a Cornell box,
    a grid of n small matte spheres (spatially localized, so the cull has
    something to cull) and a ceiling light.  13 n + 47 parameters."""
    scene = Scene()
    scene.add(Camera((0.0, 0.0, -2.5), (0.0, 0.0, 0.0)))
    scene.add(Cornellbox((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)))
    side = max(1, int(math.ceil(math.sqrt(n_spheres))))
    for k in range(n_spheres):
        x = -0.85 + 1.7 * (k % side) / max(1, side - 1)
        y = -0.85 + 1.7 * (k // side) / max(1, side - 1)
        scene.add(Sphere((x, y, 0.3), 0.75 / side, Matte(kd=0.8)))
    scene.add(AreaLight(
        Rectangle((-0.3, 0.98, -0.3), (0.3, 0.98, 0.3), Matte()),
        (5.0, 5.0, 5.0)))
    return scene


def quadrics() -> Scene:
    """Not a benchmark config: one of each shape the configs lack (cube,
    cone, cylinder, disk, hyperboloid, paraboloid) in a Cornell box, matte
    and mirror only, under a rectangle area light: `lights_and_quadrics`
    (BASELINE config 4) without its metal, point and spot lights."""
    scene = Scene()
    scene.add(Camera((0.0, 0.6, -3.0), (0.0, 0.0, 0.0)))
    scene.add(Cornellbox((-1.5, -1.0, -1.5), (1.5, 1.8, 1.5)))
    scene.add(Cone((-0.8, -1.0, -0.3), 0.9, 0.35, Matte(kd=0.9)))
    scene.add(Cylinder((0.0, -1.0, -0.5), 0.7, 0.25, Mirror(kr=0.9)))
    scene.add(Disk((0.8, -0.99, 0.2), 0.45, 0.1, Matte(kd=1.0)))
    scene.add(Paraboloid((0.6, -1.0, 0.6), 0.0, 0.6, 0.3, Matte(kd=0.8)))
    scene.add(Cube((-1.2, -1.0, 0.5), (-0.7, -0.5, 1.0),
                   Matte(kd=0.7, sigma=20.0), UniformColor((0.8, 0.5, 0.3))))
    scene.add(Hyperboloid((0.0, 0.3, 0.7), (0.45, 0.0, -0.35),
                          (0.6, 0.0, 0.55), Matte(kd=0.9)))
    scene.add(AreaLight(
        Rectangle((-0.4, 1.78, -0.4), (0.4, 1.78, 0.4), Matte()),
        (4.0, 4.0, 4.0)))
    return scene


def cubes_and_disks() -> Scene:
    """Not a benchmark config: 9 cubes and 8 disks, so that two categories
    other than spheres take the batched fold, between a Cornell box and a
    rectangle light."""
    scene = Scene()
    scene.add(Camera((0.0, 0.3, -2.5), (0.0, 0.0, 0.0)))
    scene.add(Cornellbox((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)))
    for k in range(9):
        x = -0.7 + 0.7 * (k % 3)
        z = -0.3 + 0.5 * (k // 3)
        top = -0.6 + 0.1 * (k % 4)
        scene.add(Cube((x - 0.12, -1.0, z - 0.12), (x + 0.12, top, z + 0.12),
                       Mirror(kr=0.8) if k == 4 else Matte(kd=0.8)))
    for k in range(8):
        x = -0.8 + 1.6 * k / 7.0
        scene.add(Disk((x, 0.2 + 0.1 * (k % 2), 0.6), 0.18, 0.05 * (k % 3),
                       Matte(kd=0.9)))
    scene.add(AreaLight(
        Rectangle((-0.3, 0.98, -0.3), (0.3, 0.98, 0.3), Matte()),
        (5.0, 5.0, 5.0)))
    return scene


def flat_rectangles() -> Scene:
    """Not a benchmark config: 8 axis-aligned (zero-thickness) rectangles in
    a Cornell box, the cull's degenerate bound boxes
    (`tests/test_intersect.py` test_batched_cull_keeps_flat_rectangles),
    lit by a ninth rectangle on the ceiling beside the stack, so a rectangle
    the cull dropped would change the image."""
    scene = Scene()
    scene.add(Camera((0.0, 0.0, -2.5), (0.0, 0.0, 0.0)))
    scene.add(Cornellbox((-1.0, -1.0, -1.0), (1.0, 1.0, 1.0)))
    for k in range(8):
        y = -0.8 + 1.5 * k / 7.0
        scene.add(Rectangle((-0.6, y, -0.6), (0.6, y, 0.6), Matte(kd=0.7)))
    scene.add(AreaLight(
        Rectangle((0.65, 0.98, -0.3), (0.95, 0.98, 0.3), Matte()),
        (5.0, 5.0, 5.0)))
    return scene
