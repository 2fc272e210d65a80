"""The benchmark scenes the port renders (BASELINE.md configs 1 and 2;
`sail_tpu/scenes.py` holds all of them), and `open_lights`, a check scene.
Cameras look from -z toward +z."""
from __future__ import annotations

from . import (AreaLight, Camera, Cornellbox, Matte, Mirror, Rectangle, Scene,
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
