"""Scenes as data: a configuration file's `scene` built with the classes of
a given module, the program's (`sail_tpu_torch`) or the reference's
(`perfbench.reference.plain`), which take the same arguments.

An object is `{"class": name, "args": [...], "kwargs": {...}}`; a list of
numbers is a point or a color (a tuple); anything else is taken as it is.
`scene` is `{"camera": [eye, center], "items": [...], "filter": name}`."""
from __future__ import annotations


def build(value, lib):
    """`value` with every `{"class": ...}` object made from `lib`."""
    if isinstance(value, dict) and "class" in value:
        return getattr(lib, value["class"])(
            *(build(a, lib) for a in value.get("args", ())),
            **{k: build(v, lib) for k, v in value.get("kwargs", {}).items()})
    if isinstance(value, list):
        return tuple(build(v, lib) for v in value)
    return value


def make_scene(scene: dict, lib, eye=None):
    """The scene of a configuration's `scene` entry, built from `lib`'s
    classes, its camera at `eye` where given."""
    s = lib.Scene()
    cam_eye, center = scene["camera"]
    s.add(lib.Camera(tuple(eye if eye is not None else cam_eye),
                     tuple(center)))
    for item in scene["items"]:
        s.add(build(item, lib))
    s.filter = scene.get("filter", "color")
    return s
