"""K1, K5a and K2 against an earlier tree's on the card, and the SASS of the
kernels a change must leave as they were.

    mkdir -p build/parent_csrc
    for f in $(git ls-tree --name-only <rev> sail_tpu_torch/csrc/); do
        git show <rev>:$f > build/parent_csrc/$(basename $f); done
    python3 -m sail_tpu_torch.tools.k2_compare --parent build/parent_csrc \
        [--out COMPARE.json] [--no-k2]

1. Builds the parent's megakernel.cu, megakernel_grad.cu, profile.cu and
   profile_grad.cu with `build.NVCC_FLAGS` into build/parent/ (reused while
   the parent's sources are the same), and this tree's through
   `utils/build.py`, one nvcc each, all started together.
2. SASS: `cuobjdump -sass` of both trees' libraries.  Each kernel of K2
   (`render_grad_kernel<...>`, production and stripped; a parent without
   the LIGHTS argument names `<..., false>` one argument shorter) and of
   K5b/K5c (`alu_peak_kernel<...>`, `alu_peak_ilp8_kernel`) that both
   trees build must have the same instructions (symbols `_Z...` masked: they
   carry the file's anonymous-namespace hash) and the same `-Xptxas -v`
   resources, or it is listed under `differ`.  K1's builds
   (`render_block_kernel<...>`, production and stripped), K5a's
   (`isect_only_kernel<...>`) and the reduce are listed with each tree's
   registers, stack and spills, and whether their SASS changed.
3. K1 on the rows of PERF.md's kernel table at 1024² x 5 bounces: config 2,
   config 3, the open twin (K1-ee), 16 spheres and 64 (the cull) at 64 spp,
   256 spheres at 1 spp, config 2 through each of the four stripped builds,
   and K5a on config 2 at 64 spp: the parent's (its own C entries, bound
   from its source) and this tree's, timed in turns (ROUNDS x parent, new,
   new, parent; CUDA events, one call each after a warm-up); the outputs
   bit for bit, else their relative L-inf.
4. K2 at the fwd+bwd step's arguments (1024² x 64 spp x 5 bounces, the
   cotangent 1/(H·W·spp) of `mean(x + y + z)` through the Function) on
   config 2, config 3 and 64 spheres, and at 1 spp on 256 spheres (the
   many-object steps of chip_smoke.py), in turns as K1; its first pass
   (the rows) bit for bit against the parent's; and the reduce, the
   parent's and this tree's on the same rows, bit for bit and timed per
   launch queued behind a sleeping kernel, in turns, beside `sum(0)`
   (skipped with `--no-k2`, which also skips K2's builds and SASS).
Prints and writes one JSON object; its `summary` lists the rows whose
output is not the parent's bit for bit, the rows more than 2% slower than
the parent (median against median), and the kernels whose SASS must not
change and did.  Needs the card and nvcc; imports nothing of JAX.

A parent's entry is bound from its own source: the parameters of its
`sail_render_block`, `sail_render_block_stripped`, `sail_isect_only` and
`sail_render_grad_block`, read by name, each given this tree's value of
that name (`parent_args`); a parameter this tool does not know stops it.
Its K2 build (`cap`) comes from its `sail_grad_limits`: block columns and
rows, bounces, the number of local array sizes, the sizes, then, where the
parent has the shared-memory build, the most parameters that build takes.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import re
import statistics
import subprocess

import torch

from sail_tpu_torch import scenes
from sail_tpu_torch.core.vecmath import Vec3
from sail_tpu_torch.ops.cuda import megakernel as mk
from sail_tpu_torch.ops.cuda import profile as pf
from sail_tpu_torch.tools.many_object_bench import card
from sail_tpu_torch.utils import build

SOURCES = ("megakernel", "megakernel_grad", "profile", "profile_grad")
K2_SOURCES = ("megakernel_grad", "profile_grad")
# the kernels whose SASS must not change (K2's builds, K5b, K5c), and those
# listed with their resources and whether their SASS changed (K1's builds,
# K5a, the reduce)
SAME_SASS = re.compile(r"render_grad_kernel<|alu_peak_kernel<|"
                       r"alu_peak_ilp8_kernel")
K1_SASS = re.compile(r"render_block_kernel<|isect_only_kernel<|"
                     r"reduce_grad_rows_kernel")
SIZE, SPP, BOUNCES = 1024, 64, 5
ROUNDS = 3
CASES = (("cornell_mirror", SPP), ("material_demo", SPP), ("spheres64", SPP),
         ("spheres256", 1))
# K1's rows: (label, scene, spp, strip or None), and K5a's scene
K1_CASES = (("config2", "cornell_mirror", SPP, None),
            ("config3", "material_demo", SPP, None),
            ("k1ee_open", "material_demo_open", SPP, None),
            ("spheres16", "spheres16", SPP, None),
            ("spheres64_cull", "spheres64", SPP, None),
            ("spheres256_cull", "spheres256", 1, None),
            *((f"config2_{strip}", "cornell_mirror", SPP, strip)
              for strip in pf.STRIPS))
K5A_SCENE = "cornell_mirror"
SLOWER = 1.02   # a row more than 2% slower than the parent is listed
_P, _I = ctypes.c_void_p, ctypes.c_int
# the parameters of an entry that are pointers; every other is an int
POINTERS = frozenset(("params", "table", "gx", "gy", "gz", "rows", "out",
                      "out_x", "out_y", "out_z", "stream"))


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
    value for, or one declared a pointer where POINTERS says an int or the
    other way round."""
    unknown = [n for _, n in params if n not in values]
    if unknown:
        raise ValueError(f"the parent's entry takes {unknown}, which this "
                         f"tool cannot give it")
    wrong = [n for is_ptr, n in params if is_ptr != (n in POINTERS)]
    if wrong:
        raise ValueError(f"the parent's entry takes {wrong} as another "
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


def build_parent(parent_dir: str, out_dir: str, names=SOURCES) -> dict:
    """Compile the parent's sources, all at once, into libraries named
    after a hash of the flags and the parent's files (an existing one is
    reused); {source: library}."""
    os.makedirs(out_dir, exist_ok=True)
    digest = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
    for f in sorted(os.listdir(parent_dir)):
        with open(os.path.join(parent_dir, f), "rb") as fh:
            digest.update(f.encode() + fh.read())
    tag = digest.hexdigest()[:16]
    jobs, libs = {}, {}
    for name in names:
        lib = libs[name] = os.path.join(out_dir, f"lib{name}-{tag}.so")
        if os.path.exists(lib):
            continue
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib + ".tmp",
               os.path.join(parent_dir, f"{name}.cu")]
        jobs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
    for name, proc in jobs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building the parent's {name}:"
                               f"\n{out}\n{err}")
        with open(libs[name] + ".log", "w") as f:
            f.write(out + err)
        os.replace(libs[name] + ".tmp", libs[name])
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


def parent_name(kernel: str, parent: set) -> str:
    """A kernel's name in a parent that built it with one template argument
    fewer: K2's `render_grad_kernel<CAP, ALL, MATS, STRIP, MIN_BLOCKS,
    false>` is a parent's `<CAP, ALL, MATS, STRIP, MIN_BLOCKS>` (the LIGHTS
    argument, false in every build a parent had)."""
    short = re.sub(r"^(render_grad_kernel<(?:[^,>]+, ){4}[^,>]+), false>$",
                   r"\1>", kernel)
    return short if short != kernel and short in parent else kernel


def compare_sass(parent_libs: dict, libs: dict) -> dict:
    """`same` and `differ`: the kernels of SAME_SASS both trees build;
    `k1`: each K1, K5a and reduce kernel's resources in both trees and
    whether its SASS changed."""
    same, differ, k1 = [], [], {}
    for name in parent_libs:
        old, new = sass(parent_libs[name]), sass(libs[name])
        with open(parent_libs[name] + ".log") as f:
            old_res = build.parse_resource_usage(f.read())
        new_res = build.resource_usage(name)
        renamed = {parent_name(k, set(old)): k for k in new}
        new = {parent_name(k, set(old)): v for k, v in new.items()}
        new_res = {parent_name(k, set(old)): v for k, v in new_res.items()}
        for kernel in sorted(set(old) | set(new)):
            if K1_SASS.match(kernel):
                k1[f"{kernel} ({name})"] = {
                    "parent": old_res.get(kernel), "new": new_res.get(kernel),
                    "sass_changed": old.get(kernel) != new.get(kernel)}
            elif SAME_SASS.match(kernel) and kernel in old and kernel in new:
                equal = old[kernel] == new[kernel] \
                    and old_res.get(kernel) == new_res.get(kernel)
                (same if equal else differ).append(
                    f"{renamed.get(kernel, kernel)} ({name})")
    return {"same": same, "differ": differ, "k1": k1}


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


def in_turns(a, b, rounds: int = ROUNDS) -> dict:
    """`rounds` x (a, b, b, a), each timed once after one warm-up call of
    each; both results compared."""
    a(), b()
    ta, tb = [], []
    for _ in range(rounds):
        ra, t = _events(a)
        ta.append(t)
        rb, t = _events(b)
        tb.append(t)
        tb.append(_events(b)[1])
        ta.append(_events(a)[1])
    diff = (ra - rb).abs()
    return {"a_ms": ta, "b_ms": tb,
            "a_median_ms": statistics.median(ta),
            "b_median_ms": statistics.median(tb),
            "bit_identical": bool(torch.equal(ra, rb)),
            "rel_linf": float(diff.max() / ra.abs().max()),
            "finite": bool(torch.isfinite(ra).all() and torch.isfinite(rb)
                           .all())}


def _scene_values(params, static, dev) -> dict:
    """The values every scene entry takes, by parameter name."""
    t = mk.scene_table(static)
    return dict(params=params.data_ptr(),
                table=mk._device_table(static, dev).data_ptr(),
                **dict(zip(("n_obj", "n_plain", "n_groups", "n_mat", "n_tex",
                            "n_light"), mk._counts(static))),
                cam=t.offsets.camera, all_shapes=int(t.all_shapes),
                materials=int(t.materials), n_frames=t.n_frames,
                height=SIZE, width=SIZE, seed=0, sample0=0,
                max_bounces=BOUNCES, row0=0, image_height=SIZE,
                stream=torch.cuda.current_stream(dev).cuda_stream)


def _bound(lib, source: str, name: str, values: dict):
    """The parent's entry `name`, bound by the parameters its source
    declares, called with `values`; raises on a failed launch."""
    argtypes, args = parent_args(entry_params(source, name), values)
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"the parent's {name} failed: cudaError_t {err}")


def parent_k1(parent_dir: str, libs: dict):
    """The parent's K1 (its production and stripped entries) as a function
    of (params, static, spp, strip) giving the (3, H, W) image, and its K5a
    as one of (params, static, spp) giving the (H, W) sums; each bound from
    the parent's source, K1 culling where this tree's wrapper does."""
    with open(os.path.join(parent_dir, "megakernel.cu")) as f:
        k1_src = f.read()
    with open(os.path.join(parent_dir, "profile.cu")) as f:
        prof_src = f.read()
    k1_lib = ctypes.CDLL(libs["megakernel"])
    prof_lib = ctypes.CDLL(libs["profile"])
    max_clusters = k1_lib.sail_max_clusters()

    def k1(params, static, spp, strip=None):
        dev = params.device
        out = torch.empty((3, SIZE, SIZE), dtype=torch.float32, device=dev)
        values = dict(_scene_values(params, static, dev), spp=spp,
                      out_x=out[0].data_ptr(), out_y=out[1].data_ptr(),
                      out_z=out[2].data_ptr())
        if strip is None:
            values["n_clusters"] = mk.cull_clusters(static, None,
                                                    max_clusters)
            _bound(k1_lib, k1_src, "sail_render_block", values)
        else:
            values.update(n_clusters=0, strip=pf.STRIPS[strip])
            _bound(prof_lib, prof_src, "sail_render_block_stripped", values)
        return out

    def k5a(params, static, spp):
        dev = params.device
        out = torch.empty((SIZE, SIZE), dtype=torch.float32, device=dev)
        _bound(prof_lib, prof_src, "sail_isect_only",
               dict(_scene_values(params, static, dev), spp=spp,
                    out=out.data_ptr()))
        return out
    return k1, k5a


def _k1_new(params, static, spp, strip=None):
    """This tree's K1 (or a stripped build) through its wrapper, as a
    (3, H, W) image."""
    if strip is None:
        img = mk.render_block(params, static, SIZE, SIZE, spp, 0, 0, BOUNCES)
    else:
        img = pf.render_block_stripped(strip, params, static, SIZE, SIZE,
                                       spp, 0, 0, BOUNCES)
    return torch.stack(tuple(img))


def parent_k2(parent_dir: str, lib_path: str):
    """The parent's K2 at the step's shape: its C entries, bound from its
    source, and its build for the scene's parameters.  Returns (rows, the
    parent's first pass as a function of (params, static, g, spp) giving
    the (n_blocks, n_params) rows; reduce, its second pass on given rows;
    its limits)."""
    with open(os.path.join(parent_dir, "megakernel_grad.cu")) as f:
        params_decl = entry_params(f.read())
    lib = ctypes.CDLL(lib_path)
    limits = (ctypes.c_int * 32)(*([-1] * 32))
    lib.sail_grad_limits(limits)
    limits = list(limits)
    red = lib.sail_reduce_grad_rows
    red.argtypes, red.restype = mk.REDUCE_ARGTYPES, ctypes.c_int

    def rows_of(params, static, g, spp):
        dev = params.device
        n = params.numel()
        bx, by = limits[0], limits[1]
        rows = torch.empty((-(-SIZE // bx) * -(-SIZE // by), n),
                           dtype=torch.float32, device=dev)
        t = mk.scene_table(static)
        counts = dict(zip(("n_obj", "n_plain", "n_groups", "n_mat", "n_tex",
                           "n_light"), mk._counts(static)))
        values = dict(
            params=params.data_ptr(),
            table=mk._device_table(static, dev).data_ptr(), **counts,
            cam=t.offsets.camera, n_params=n, cap=parent_cap(limits, n),
            all_shapes=int(t.all_shapes), materials=int(t.materials),
            lights=int(t.lights),
            gx=g.x.data_ptr(), gy=g.y.data_ptr(), gz=g.z.data_ptr(),
            rows=rows.data_ptr(), height=SIZE, width=SIZE, spp=spp, seed=0,
            sample0=0, max_bounces=BOUNCES, row0=0, image_height=SIZE,
            stream=torch.cuda.current_stream(dev).cuda_stream)
        argtypes, args = parent_args(params_decl, values)
        grad = lib.sail_render_grad_block
        grad.argtypes, grad.restype = argtypes, ctypes.c_int
        err = grad(*args)
        if err != 0:
            raise RuntimeError(f"the parent's K2 failed: cudaError_t {err}")
        return rows

    def reduce(rows):
        out = torch.empty(rows.shape[1], dtype=torch.float32,
                          device=rows.device)
        err = red(rows.data_ptr(), rows.shape[0], rows.shape[1],
                  out.data_ptr(),
                  torch.cuda.current_stream(rows.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"the parent's reduce failed: cudaError_t "
                               f"{err}")
        return out
    return rows_of, reduce, limits


def queued_ms(fn, *args, n: int = 20, runs: int = 1, **kw) -> float:
    """Device ms per call of a short `fn` (a kernel or a few): n calls
    queued behind a sleeping kernel, so that the host's time to launch them
    is hidden, between CUDA events; the median of `runs` such batches."""
    fn(*args, **kw)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)   # ~25 ms at the SM clock
        start.record()
        for _ in range(n):
            fn(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def reduce_in_turns(old_reduce, rows) -> dict:
    """The parent's reduce and this tree's on the same rows: bit for bit,
    and per launch queued, ROUNDS x (parent, new, new, parent), with
    `sum(0)` beside them."""
    a, b = old_reduce(rows), mk.reduce_grad_rows(rows)
    ta, tb, ts = [], [], []
    for _ in range(ROUNDS):
        ta.append(queued_ms(old_reduce, rows))
        tb.append(queued_ms(mk.reduce_grad_rows, rows))
        tb.append(queued_ms(mk.reduce_grad_rows, rows))
        ta.append(queued_ms(old_reduce, rows))
        ts.append(queued_ms(lambda r: r.sum(0), rows))
    return {"shape": list(rows.shape), "a_ms": ta, "b_ms": tb,
            "a_median_ms": statistics.median(ta),
            "b_median_ms": statistics.median(tb),
            "sum0_median_ms": statistics.median(ts),
            "bit_identical": bool(torch.equal(a, b)),
            "rel_linf": float((a - b).abs().max() / a.abs().max()),
            "finite": bool(torch.isfinite(b).all())}


def scene_of(name: str):
    if name.startswith("spheres"):
        return scenes.many_spheres(int(name[len("spheres"):]))
    return getattr(scenes, name)()


def _row(label: str, r: dict) -> dict:
    print(label, json.dumps(r), flush=True)
    return r


def run(parent_dir: str, with_k2: bool = True) -> dict:
    dev = torch.device("cuda", 0)
    root = os.path.dirname(build.BUILD_DIR)
    names = SOURCES if with_k2 else tuple(n for n in SOURCES
                                          if n not in K2_SOURCES)
    parent_libs = build_parent(parent_dir, os.path.join(root, "parent"),
                               names)
    libs = dict(zip(names, build.build(*names)))
    out = {"device": card(), "shape": f"{SIZE}x{SIZE} b{BOUNCES}",
           "rounds": ROUNDS, "sass": compare_sass(parent_libs, libs)}
    old_k1, old_k5a = parent_k1(parent_dir, parent_libs)
    out["k1"] = {}
    for label, name, spp, strip in K1_CASES:
        params, static = scene_of(name).pack()
        params = params.to(dev)
        r = in_turns(lambda: old_k1(params, static, spp, strip),
                     lambda: _k1_new(params, static, spp, strip))
        out["k1"][label] = _row(label, dict(r, scene=name, spp=spp))
    params, static = scene_of(K5A_SCENE).pack()
    params = params.to(dev)
    r = in_turns(lambda: old_k5a(params, static, SPP),
                 lambda: pf.isect_only_block(params, static, SIZE, SIZE, SPP,
                                             BOUNCES))
    out["k1"]["k5a"] = _row("k5a", dict(r, scene=K5A_SCENE, spp=SPP))
    if with_k2:
        out["resources"] = {k: v for k, v in build.resource_usage(
            "megakernel_grad").items() if k.startswith("render_grad")}
        out["resources_profile"] = build.resource_usage("profile_grad")
        old_rows, old_reduce, old_limits = parent_k2(
            parent_dir, parent_libs["megakernel_grad"])
        out["steps"], out["k2_rows"], out["reduce"] = {}, {}, {}
        for name, spp in CASES:
            params, static = scene_of(name).pack()
            params = params.to(dev)
            g = Vec3(*(torch.full((SIZE, SIZE), 1.0 / (SIZE * SIZE * spp),
                                  device=dev),) * 3)
            r = in_turns(lambda: old_reduce(old_rows(params, static, g,
                                                     spp)),
                         lambda: mk.render_grad_block(params, static, g, SIZE,
                                                      SIZE, spp, 0, 0,
                                                      BOUNCES))
            r["spp"] = spp
            r["parent_build"] = parent_cap(old_limits, params.numel())
            r["build"] = mk.grad_build(params.numel())
            r["min_blocks"] = mk.grad_launch_bound(params.numel(), static)
            r["n_params"] = params.numel()
            out["steps"][f"{name} spp{spp}"] = _row(name, r)
            # K2's first pass alone, and the reduce on the same rows
            old = old_rows(params, static, g, spp)
            new = mk.render_grad_rows(params, static, g, SIZE, SIZE, spp, 0,
                                      0, BOUNCES)
            out["k2_rows"][f"{name} spp{spp}"] = _row(
                f"{name} rows", {"bit_identical": bool(torch.equal(old, new)),
                                 "shape": list(new.shape)})
            out["reduce"][f"{name} spp{spp}"] = _row(
                f"{name} reduce", reduce_in_turns(old_reduce, new))
    rows = {**out["k1"], **out.get("steps", {})}
    same = {**rows, **{f"{k} rows": r for k, r in
                       out.get("k2_rows", {}).items()},
            **{f"{k} reduce": r for k, r in out.get("reduce", {}).items()}}
    out["summary"] = {
        "not_bit_identical": [k for k, r in same.items()
                              if not r["bit_identical"]],
        "slower_than_parent": [k for k, r in rows.items() if r["b_median_ms"]
                               > SLOWER * r["a_median_ms"]],
        "sass_differs": out["sass"]["differ"]}
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a directory holding the parent's csrc/ files")
    ap.add_argument("--out", default="COMPARE.json")
    ap.add_argument("--no-k2", action="store_true",
                    help="K1 and K5a only: no K2 build, SASS or rows")
    args = ap.parse_args(argv)
    out = run(args.parent, with_k2=not args.no_k2)
    text = json.dumps(out, indent=1)
    print(text)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return out


if __name__ == "__main__":
    main()
