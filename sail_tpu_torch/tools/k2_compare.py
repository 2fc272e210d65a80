"""K2 against an earlier tree's K2 on the card, and the SASS of the kernels a
change to K2 must leave as they were.

    mkdir -p build/parent_csrc
    for f in $(git ls-tree --name-only <rev> sail_tpu_torch/csrc/); do
        git show <rev>:$f > build/parent_csrc/$(basename $f); done
    python3 -m sail_tpu_torch.tools.k2_compare --parent build/parent_csrc [--out K2_COMPARE.json]

1. Builds the parent's megakernel.cu, megakernel_grad.cu and profile.cu with
   `build.NVCC_FLAGS` into build/parent/, and this tree's through
   `utils/build.py`, one nvcc each, all started together.
2. SASS: `cuobjdump -sass` of both trees' libraries; each kernel of K1
   (`render_block_kernel<...>`, the eight production builds and the four
   stripped ones) and K5a (`isect_only_kernel<...>`) that both trees build
   must have the same instructions (symbols `_Z...` masked: they carry the
   file's anonymous-namespace hash) and the same `-Xptxas -v` resources.
3. K2 at the fwd+bwd step's arguments (1024² x 64 spp x 5 bounces, the
   cotangent 1/(H·W·spp) of `mean(x + y + z)` through the Function) on
   config 2, config 3 and 64 spheres, and at 1 spp on 256 spheres (the
   many-object steps of chip_smoke.py): the parent's K2 (its own C entry and
   reduce, its build for the scene's parameters) and this tree's, timed in
   turns (parent, new, new, parent; CUDA events, one call each after a
   warm-up); the gradients bit for bit, else their relative L-inf.
Prints and writes one JSON object.  Needs the card and nvcc; imports
nothing of JAX.

The parent's K2 is bound from its own source: the parameters of its
`sail_render_grad_block`, read by name, each given this tree's value of that
name (`parent_args`); a parameter this tool does not know stops it.  Its
build (`cap`) comes from its `sail_grad_limits`: block columns and rows,
bounces, the number of local array sizes, the sizes, then, where the parent
has the shared-memory build, the most parameters that build takes.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess

import torch

from sail_tpu_torch import scenes
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.ops.cuda import megakernel as mk
from sail_tpu_torch.tools.many_object_bench import card
from sail_tpu_torch.utils import build

SOURCES = ("megakernel", "megakernel_grad", "profile")
# the kernels whose SASS must not change: K1's builds (production and
# stripped) and K5a
SAME_SASS = re.compile(r"render_block_kernel<|isect_only_kernel<")
SIZE, SPP, BOUNCES = 1024, 64, 5
CASES = (("cornell_mirror", SPP), ("material_demo", SPP), ("spheres64", SPP),
         ("spheres256", 1))
_P, _I = ctypes.c_void_p, ctypes.c_int
# the parameters of a K2 entry that are pointers; every other is an int
K2_POINTERS = frozenset(("params", "table", "gx", "gy", "gz", "rows",
                         "stream"))


def entry_params(source: str, name: str = "sail_render_grad_block") -> list:
    """[(is_pointer, parameter name), ...] of the C entry `name` in the
    text `source`."""
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', source)
    if m is None:
        raise ValueError(f"no extern \"C\" {name} in the source")
    out = []
    for decl in m.group(1).split(","):
        words = re.findall(r"[A-Za-z_]\w*", decl)
        out.append(("*" in decl, words[-1]))
    return out


def parent_args(params: list, values: dict) -> tuple:
    """(argtypes, arguments) for an entry of `params` (`entry_params`),
    each argument `values[name]`.  Raises for a parameter this tool has no
    value for, or one declared a pointer where K2_POINTERS says an int or
    the other way round."""
    unknown = [n for _, n in params if n not in values]
    if unknown:
        raise ValueError(f"the parent's K2 entry takes {unknown}, which this "
                         f"tool cannot give it")
    wrong = [n for is_ptr, n in params if is_ptr != (n in K2_POINTERS)]
    if wrong:
        raise ValueError(f"the parent's K2 entry takes {wrong} as another "
                         f"kind (pointer or int) than this tool's")
    return ([_P if is_ptr else _I for is_ptr, _ in params],
            [values[n] for _, n in params])


def parent_cap(limits: list, n_params: int) -> int:
    """The parent's build for `n_params` from its `sail_grad_limits` (the
    buffer filled with -1 beforehand): 0, its shared-memory build, where it
    has one that holds them, else the smallest local size that does."""
    n_caps = limits[3]
    caps = tuple(limits[4:4 + n_caps])
    shared_max = limits[4 + n_caps]
    if shared_max >= 0 and n_params <= shared_max:
        return 0
    return mk.grad_cap(n_params, caps)


def build_parent(parent_dir: str, out_dir: str) -> dict:
    """Compile the parent's sources, all at once; {source: library}."""
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for name in SOURCES:
        lib = os.path.join(out_dir, f"lib{name}.so")
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib,
               os.path.join(parent_dir, f"{name}.cu")]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE,
                                            text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building the parent's {name}:"
                               f"\n{out}\n{err}")
        with open(lib + ".log", "w") as f:
            f.write(out + err)
        libs[name] = lib
    return libs


def sass(lib: str) -> dict:
    """{kernel name: its SASS lines, `_Z...` symbols masked}."""
    cuobjdump = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = build.kernel_name(m.group(1))
            out[cur] = []
        elif cur is not None and line.strip():
            out[cur].append(re.sub(r"_Z\w+", "_Z", line.strip()))
    return out


def compare_sass(parent_libs: dict, libs: dict) -> dict:
    same, differ = [], []
    for name in SOURCES:
        old, new = sass(parent_libs[name]), sass(libs[name])
        with open(parent_libs[name] + ".log") as f:
            old_res = build.parse_resource_usage(f.read())
        new_res = build.resource_usage(name)
        for kernel in sorted(set(old) & set(new)):
            if not SAME_SASS.match(kernel):
                continue
            equal = old[kernel] == new[kernel] \
                and old_res.get(kernel) == new_res.get(kernel)
            (same if equal else differ).append(kernel)
    return {"same": same, "differ": differ}


def _events(fn):
    """(result, ms) of one call between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end)


def in_turns(a, b) -> dict:
    """a, b, b, a, each timed once after one warm-up call of each; both
    results compared."""
    a(), b()
    ra, ta1 = _events(a)
    rb, tb1 = _events(b)
    _, tb2 = _events(b)
    _, ta2 = _events(a)
    diff = (ra - rb).abs()
    return {"a_ms": [ta1, ta2], "b_ms": [tb1, tb2],
            "a_median_ms": statistics.median([ta1, ta2]),
            "b_median_ms": statistics.median([tb1, tb2]),
            "bit_identical": bool(torch.equal(ra, rb)),
            "rel_linf": float(diff.max() / ra.abs().max()),
            "finite": bool(torch.isfinite(ra).all() and torch.isfinite(rb)
                           .all())}


def parent_k2(parent_dir: str, lib_path: str):
    """The parent's K2 as a function of (params, static, g, spp) at the
    step's shape: its C entries, bound from its source, and its build for
    the scene's parameters.  Returns (run, its limits)."""
    with open(os.path.join(parent_dir, "megakernel_grad.cu")) as f:
        params_decl = entry_params(f.read())
    lib = ctypes.CDLL(lib_path)
    limits = (ctypes.c_int * 32)(*([-1] * 32))
    lib.sail_grad_limits(limits)
    limits = list(limits)
    red = lib.sail_reduce_grad_rows
    red.argtypes, red.restype = mk.REDUCE_ARGTYPES, ctypes.c_int

    def run(params, static, g, spp):
        dev = params.device
        n = params.numel()
        bx, by = limits[0], limits[1]
        rows = torch.empty((-(-SIZE // bx) * -(-SIZE // by), n),
                           dtype=torch.float32, device=dev)
        out = torch.empty(n, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        t = mk.scene_table(static)
        counts = dict(zip(("n_obj", "n_plain", "n_groups", "n_mat", "n_tex",
                           "n_light"), mk._counts(static)))
        values = dict(
            params=params.data_ptr(),
            table=mk._device_table(static, dev).data_ptr(), **counts,
            cam=t.offsets.camera, n_params=n, cap=parent_cap(limits, n),
            all_shapes=int(t.all_shapes), materials=int(t.materials),
            gx=g.x.data_ptr(), gy=g.y.data_ptr(), gz=g.z.data_ptr(),
            rows=rows.data_ptr(), height=SIZE, width=SIZE, spp=spp, seed=0,
            sample0=0, max_bounces=BOUNCES, row0=0, image_height=SIZE,
            stream=stream)
        argtypes, args = parent_args(params_decl, values)
        grad = lib.sail_render_grad_block
        grad.argtypes, grad.restype = argtypes, ctypes.c_int
        err = grad(*args)
        err = err or red(rows.data_ptr(), rows.shape[0], n, out.data_ptr(),
                         stream)
        if err != 0:
            raise RuntimeError(f"the parent's K2 failed: cudaError_t {err}")
        return out
    return run, limits


def scene_of(name: str):
    if name.startswith("spheres"):
        return scenes.many_spheres(int(name[len("spheres"):]))
    return getattr(scenes, name)()


def run(parent_dir: str, out_dir: str = None) -> dict:
    dev = torch.device("cuda", 0)
    root = os.path.dirname(build.BUILD_DIR)
    parent_libs = build_parent(parent_dir,
                               out_dir or os.path.join(root, "parent"))
    libs = dict(zip(SOURCES, build.build(*SOURCES, "profile_grad")))
    out = {"device": card(), "shape": f"{SIZE}x{SIZE} b{BOUNCES}",
           "sass": compare_sass(parent_libs, libs),
           "resources": {k: v for k, v in build.resource_usage(
               "megakernel_grad").items() if k.startswith("render_grad")},
           "resources_profile": build.resource_usage("profile_grad")}
    old_k2, old_limits = parent_k2(parent_dir,
                                   parent_libs["megakernel_grad"])
    out["steps"] = {}
    for name, spp in CASES:
        params, static = scene_of(name).pack()
        params = params.to(dev)
        g = Vec3(*(torch.full((SIZE, SIZE), 1.0 / (SIZE * SIZE * spp),
                              device=dev),) * 3)
        r = in_turns(lambda: old_k2(params, static, g, spp),
                     lambda: mk.render_grad_block(params, static, g, SIZE,
                                                  SIZE, spp, 0, 0, BOUNCES))
        r["spp"] = spp
        r["parent_build"] = parent_cap(old_limits, params.numel())
        r["build"] = mk.grad_build(params.numel())
        r["min_blocks"] = mk.grad_launch_bound(params.numel(), static)
        r["n_params"] = params.numel()
        out["steps"][f"{name} spp{spp}"] = r
        print(name, json.dumps(r), flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a directory holding the parent's csrc/ files")
    ap.add_argument("--out", default="K2_COMPARE.json")
    args = ap.parse_args(argv)
    out = run(args.parent)
    text = json.dumps(out, indent=1)
    print(text)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return out


if __name__ == "__main__":
    main()
