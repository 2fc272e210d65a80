"""The benchmark scenes the port renders (BASELINE.md configs 1 to 4, and
config 3's open twin; `sail_tpu/scenes.py` holds all of them), the
many-object scene of `tools/many_object_bench.py`, and check scenes for the
shapes, the batched fold, the materials and textures and the area lights.
Cameras look from -z toward +z."""
from __future__ import annotations

import math

import sys

from . import (UV, AreaLight, Bilerp, Camera, Checkerboard, Checkerboard2,
               Cone, Cornellbox, Cube, Cylinder, Disk, Glass, Hyperboloid,
               Matte, Metal, Mirror, Mix, Paraboloid, PointLight, Rectangle,
               ScaleT, Scene, Sphere, SpotLight, UniformColor)


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


def _material_demo_objects(scene: Scene) -> Scene:
    floor_tex = Checkerboard2((1.0, 1.0, 1.0), (0.2, 0.2, 0.2), 0.25)
    scene.add(Rectangle((-1.5, -0.99, -1.5), (1.5, -0.99, 1.5),
                        Matte(), floor_tex))
    scene.add(Sphere((-0.9, -0.65, 0.0), 0.33, Metal(roughness=0.1)))
    scene.add(Sphere((-0.3, -0.65, 0.0), 0.33, Mirror()))
    scene.add(Sphere((0.3, -0.65, 0.0), 0.33, Glass(eta=1.5)))
    scene.add(Sphere((0.9, -0.65, 0.0), 0.33, Matte(kd=0.9, sigma=20.0)))
    scene.add(AreaLight(
        Rectangle((-0.5, 1.48, -0.5), (0.5, 1.48, 0.5), Matte()),
        (6.0, 6.0, 6.0)))
    return scene


def material_demo() -> Scene:
    """Config 3: metal/mirror/glass/matte spheres over a checkerboard."""
    scene = Scene()
    scene.add(Camera((0.0, 0.3, -2.8), (0.0, 0.0, 0.0)))
    scene.add(Cornellbox((-1.5, -1.0, -1.5), (1.5, 1.5, 1.5)))
    return _material_demo_objects(scene)


def lights_and_quadrics() -> Scene:
    """Config 4: an area, a point and a spot light over a cone, a metal
    cylinder, a disk and a paraboloid in a Cornell box."""
    scene = Scene()
    scene.add(Camera((0.0, 0.6, -3.0), (0.0, 0.0, 0.0)))
    scene.add(Cornellbox((-1.5, -1.0, -1.5), (1.5, 1.8, 1.5)))
    scene.add(Cone((-0.8, -1.0, -0.3), 0.9, 0.35, Matte(kd=0.9)))
    scene.add(Cylinder((0.0, -1.0, -0.5), 0.7, 0.25, Metal(roughness=0.05)))
    scene.add(Disk((0.8, -0.99, 0.2), 0.45, 0.1, Matte(kd=1.0)))
    scene.add(Paraboloid((0.6, -1.0, 0.6), 0.0, 0.6, 0.3, Matte(kd=0.8)))
    scene.add(AreaLight(
        Rectangle((-0.4, 1.78, -0.4), (0.4, 1.78, 0.4), Matte()),
        (4.0, 4.0, 4.0)))
    scene.add(PointLight((-1.0, 1.2, 1.0), (0.6, 0.6, 0.6)))
    scene.add(SpotLight((1.0, 1.5, 0.0), 35.0, 10.0, (2.0, 2.0, 2.0)))
    return scene


def area_lights(lib=None) -> Scene:
    """Not a benchmark config: an area light over each shape config 4 does
    not sample (sphere, disk, cube, cone, cylinder, paraboloid with its band
    starting at z0 = 0, hyperboloid), small and dim, in a Cornell box whose
    walls and a matte sphere receive them in view.  `lib`: the module whose
    scene classes build it (this package by default; a package with the
    same classes gives the same scene)."""
    m = sys.modules[__package__] if lib is None else lib
    scene = m.Scene()
    scene.add(m.Camera((0.0, 0.4, -3.0), (0.0, 0.0, 0.0)))
    scene.add(m.Cornellbox((-1.5, -1.0, -1.5), (1.5, 1.8, 1.5)))
    scene.add(m.Sphere((0.0, -0.45, 0.3), 0.55, m.Matte(kd=0.9)))
    scene.add(m.AreaLight(m.Sphere((-1.0, 1.2, 0.8), 0.15, m.Matte()),
                          (3.0, 2.5, 2.0)))
    scene.add(m.AreaLight(m.Disk((0.9, -0.99, -0.6), 0.25, 0.05, m.Matte()),
                          (1.5, 2.0, 3.0)))
    scene.add(m.AreaLight(m.Cube((0.8, 0.9, 0.7), (1.1, 1.2, 1.0),
                                 m.Matte()), (2.0, 2.0, 1.0)))
    scene.add(m.AreaLight(m.Cone((-1.0, -1.0, -0.7), 0.5, 0.2, m.Matte()),
                          (2.5, 1.0, 1.0)))
    scene.add(m.AreaLight(m.Cylinder((1.1, -1.0, 0.8), 0.4, 0.12,
                                     m.Matte()), (1.0, 2.5, 1.0)))
    scene.add(m.AreaLight(m.Paraboloid((-0.5, -1.0, 1.0), 0.0, 0.4, 0.2,
                                       m.Matte()), (1.0, 1.0, 2.5)))
    scene.add(m.AreaLight(m.Hyperboloid((0.2, 1.0, 1.1), (0.2, 0.0, -0.2),
                                        (0.25, 0.0, 0.2), m.Matte()),
                          (2.0, 1.5, 2.5)))
    return scene


def material_demo_open() -> Scene:
    """Config 3 without its Cornell box: rays escape into the sky and die
    there together, the scene `early_exit` is for."""
    scene = Scene()
    scene.add(Camera((0.0, 0.3, -2.8), (0.0, 0.0, 0.0)))
    return _material_demo_objects(scene)


def material_check() -> Scene:
    """Not a benchmark config: what config 3 lacks — Beckmann and
    anisotropic GGX metal, rough glass of both distributions (one
    anisotropic), and each uv texture, several on shapes whose u and v then
    carry gradient (Bilerp, UV) — in a Cornell box under a rectangle
    light."""
    scene = Scene()
    scene.add(Camera((0.0, 0.3, -2.8), (0.0, 0.0, 0.0)))
    scene.add(Cornellbox((-1.5, -1.0, -1.5), (1.5, 1.5, 1.5)))
    scene.add(Rectangle((-1.5, -0.99, -1.5), (1.5, -0.99, 1.5),
                        Matte(kd=0.9),
                        Checkerboard2((0.9, 0.9, 0.8), (0.3, 0.2, 0.2), 0.3)))
    scene.add(Rectangle((-1.4, -0.9, 1.45), (1.4, 1.2, 1.45), Matte(), UV()))
    scene.add(Sphere((-0.95, -0.6, -0.1), 0.35,
                     Metal(roughness=0.25, distribution="beckmann"),
                     Bilerp((1.0, 0.3, 0.2), (0.2, 1.0, 0.3),
                            (0.3, 0.2, 1.0), (0.9, 0.9, 0.2))))
    scene.add(Sphere((-0.2, -0.6, 0.1), 0.35,
                     Metal(uroughness=0.05, vroughness=0.35), UV()))
    scene.add(Sphere((0.55, -0.6, -0.2), 0.35,
                     Glass(eta=1.5, uroughness=0.15, vroughness=0.15)))
    scene.add(Cylinder((1.05, -1.0, 0.6), 0.8, 0.25,
                       Glass(eta=1.33, uroughness=0.1, vroughness=0.3,
                             distribution="beckmann"),
                       Mix((0.9, 0.9, 1.0), (0.6, 1.0, 0.8), 0.3)))
    scene.add(Cube((-1.3, -1.0, 0.7), (-0.8, -0.5, 1.2),
                   Matte(kd=0.8, sigma=15.0), Checkerboard(0.1, 0.02)))
    scene.add(Cone((-0.3, -1.0, 0.9), 0.8, 0.3, Matte(kd=0.9),
                   Bilerp((0.2, 0.4, 1.0), (1.0, 0.4, 0.2),
                          (0.4, 1.0, 0.2), (0.9, 0.9, 0.9))))
    scene.add(Disk((0.4, 0.6, 1.3), 0.4, 0.1, Matte(), UV()))
    scene.add(Paraboloid((0.3, -1.0, 0.9), 0.0, 0.5, 0.25, Matte(kd=0.8),
                         ScaleT((0.9, 0.6, 0.5), (0.8, 1.0, 0.9))))
    scene.add(Hyperboloid((-0.9, 0.5, 0.8), (0.3, 0.0, -0.3),
                          (0.4, 0.0, 0.3), Matte(kd=0.9), UV()))
    scene.add(AreaLight(
        Rectangle((-0.5, 1.48, -0.5), (0.5, 1.48, 0.5), Matte()),
        (6.0, 6.0, 6.0)))
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
    (BASELINE config 4) without its metal, point and spot lights, plus a
    cube and a hyperboloid."""
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
