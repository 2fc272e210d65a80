"""`sail_tpu_torch.utils.build` without nvcc: the library name follows
every header a source includes and the defines a library is built with,
no more nvcc processes run than the host has cores, and the `-Xptxas -v`
report is read per kernel.  (The build itself runs on the card:
`python3 chip_smoke.py`.)"""
import os

import pytest

from sail_tpu_torch.utils import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path / "csrc"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    os.makedirs(build.CSRC_DIR)

    def write(name, text):
        with open(os.path.join(build.CSRC_DIR, name), "w") as f:
            f.write(text)
    write("k.cu", '#include "a.cuh"\n#include <cuda_runtime.h>\nint k;\n')
    write("a.cuh", '#pragma once\n  #  include "b.cuh"\nint a;\n')
    write("b.cuh", '#pragma once\n#include "a.cuh"\nint b;\n')
    return write


def test_sources_follow_includes(csrc):
    assert [os.path.basename(p) for p in build.sources("k")] == \
        ["k.cu", "a.cuh", "b.cuh"]


@pytest.mark.parametrize("edited", ["k.cu", "a.cuh", "b.cuh"])
def test_editing_any_included_file_changes_the_library(csrc, edited):
    before = build._library_path("k")
    assert before == build._library_path("k")
    with open(os.path.join(build.CSRC_DIR, edited), "a") as f:
        f.write("int edited;\n")
    assert build._library_path("k") != before


def test_defines_name_the_library(csrc):
    """A library's defines go into its hash and its file name: each set of
    defines of one source is a library of its own, its values in the name,
    and a library with none keeps the source's name alone."""
    plain = build._library_path("k")
    a = build._library_path(("k", ("CAP=352", "ALL=true")))
    b = build._library_path(("k", ("CAP=1024", "ALL=true")))
    assert len({plain, a, b}) == 3
    assert os.path.basename(a).startswith("libk-352-true-")
    assert os.path.basename(plain).startswith("libk-")
    assert build._library_path(("k", ())) == plain
    assert build._library_path(("k", ("CAP=352", "ALL=true"))) == a


class _FakeNvcc:
    """subprocess.Popen for nvcc: writes the library it is asked for when
    waited on, and counts how many run at once."""
    running = most = 0
    defines = []

    def __init__(self, cmd, **kw):
        self.out = cmd[cmd.index("-o") + 1]
        _FakeNvcc.defines.append([c for c in cmd if c.startswith("-D")])
        _FakeNvcc.running += 1
        _FakeNvcc.most = max(_FakeNvcc.most, _FakeNvcc.running)
        self.returncode = 0

    def communicate(self):
        _FakeNvcc.running -= 1
        with open(self.out, "w") as f:
            f.write("lib")
        return "ptxas info    : Used 1 registers\n", ""


def test_build_runs_no_more_nvcc_than_cores(csrc, monkeypatch):
    """Many libraries requested at once (every K2 build) run one nvcc
    each, each with its defines, no more at a time than the host has
    cores; a library that exists is not built again."""
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(build.os, "sched_getaffinity", lambda pid: {0, 1})
    for name, value in (("defines", []), ("running", 0), ("most", 0)):
        monkeypatch.setattr(_FakeNvcc, name, value)
    libs = [("k", (f"CAP={c}",)) for c in (0, 352, 1024, 4096)] + ["k"]
    paths = build.build(*libs)
    assert _FakeNvcc.most == 2 and _FakeNvcc.running == 0
    assert sorted(_FakeNvcc.defines) == sorted(
        [[f"-DCAP={c}"] for c in (0, 352, 1024, 4096)] + [[]])
    assert all(os.path.exists(p) and os.path.exists(p + ".log")
               for p in paths)
    assert build.build(*libs) == paths and len(_FakeNvcc.defines) == 5


def test_the_shipped_kernels_hash_their_headers():
    names = {os.path.basename(p) for p in build.sources("megakernel_grad")}
    assert {"megakernel_grad.cu", "adjoint.cuh", "path.cuh"} <= names
    assert "path.cuh" in {os.path.basename(p)
                          for p in build.sources("megakernel")}


def test_kernel_name_demangles():
    assert build.kernel_name(
        "_ZN12_GLOBAL__N_119render_block_kernelE5ScenePfS1_S1_iiijjiii") \
        == "render_block_kernel"
    # nvcc's anonymous namespace: a file hash that may read "0ab1..."
    ns = "_GLOBAL__N__0ab1c2d3_13_megakernel_cu_9f8e7d6c"
    assert build.kernel_name(
        f"_ZN{len(ns)}{ns}19render_block_kernelE5ScenePfS1_S1_iiijjiii") \
        == "render_block_kernel"
    assert build.kernel_name("_Z9my_kernelPf") == "my_kernel"
    assert build.kernel_name("sail_kernel") == "sail_kernel"
    # K2 is built for a few gradient-array sizes: one kernel per size
    assert build.kernel_name(
        f"_ZN{len(ns)}{ns}18render_grad_kernelILi4096EEEv5SceneiPKfS3_S3_Pf"
        "iiijjiii") == "render_grad_kernel<4096>"
    # K1 is built for each (ALL, CULL) pair of bools
    assert build.kernel_name(
        f"_ZN{len(ns)}{ns}19render_block_kernelILb1ELb0EEEv5SceneiPfS3_S3_"
        "iiijjiii") == "render_block_kernel<true, false>"


def test_resource_usage_reports_each_kernel(csrc):
    lib = build._library_path("k")
    os.makedirs(build.BUILD_DIR)
    with open(lib + ".log", "w") as f:
        f.write(
            "ptxas info    : Function properties for _Z10sphere_hitv\n"
            "    24 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
            "ptxas info    : Compiling entry function "
            "'_ZN12_GLOBAL__N_118render_grad_kernelE5Scene' for 'sm_90a'\n"
            "ptxas info    : Function properties for "
            "_ZN12_GLOBAL__N_118render_grad_kernelE5Scene\n"
            "    1792 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
            "ptxas info    : Used 128 registers, 11264 bytes smem\n"
            "ptxas info    : Compiling entry function "
            "'_ZN12_GLOBAL__N_123reduce_grad_rows_kernelEPKfiiPf' for 'sm_90a'\n"
            "ptxas info    : Function properties for "
            "_ZN12_GLOBAL__N_123reduce_grad_rows_kernelEPKfiiPf\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
            "ptxas info    : Used 12 registers, 1024 bytes smem\n")
    assert build.resource_usage("k") == {
        "render_grad_kernel": dict(registers=128, stack=1792,
                                   spill_stores=8, spill_loads=8,
                                   smem=11264),
        "reduce_grad_rows_kernel": dict(registers=12, stack=0,
                                        spill_stores=0, spill_loads=0,
                                        smem=1024)}


def test_build_without_nvcc_raises(csrc, monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        pytest.skip("this machine has the CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("k")


def _k2_build(params, static):
    from sail_tpu_torch.ops.cuda import megakernel as mk
    t = mk.scene_table(static)
    return mk.grad_build(params.numel(), t.all_shapes, t.materials, t.lights)


def test_largest_scene_of_the_slice_fits_k2():
    """K2 sums each thread's gradient in a compile-time array, built for a
    few sizes (GRAD_CAPS, each given to nvcc as the build's GRAD_CAP): a
    scene of 7 objects of each of the first slice's shapes, every one with
    its own material and texture, every rectangle a light, fits the
    smallest; the 256-sphere scene of the many-object benchmark (3,375
    parameters) fits the largest."""
    from sail_tpu_torch import (AreaLight, Camera, Cornellbox, Matte, Rectangle,
                                Scene, Sphere, UniformColor, scenes)
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.scene.scene import param_offsets
    caps = mk.GRAD_CAPS
    assert caps == (352, 1024, 4096)
    cap = caps[0]
    largest = _k2_build(*scenes.many_spheres(256).pack())
    assert largest.cap == caps[-1]
    assert f"GRAD_CAP={caps[-1]}" in largest.defines
    scene = Scene()
    scene.add(Camera((0.0, 0.0, -2.5), (0.0, 0.0, 0.0)))
    for k in range(7):
        scene.add(Sphere((0.1 * k, 0.0, 0.0), 0.1, Matte(sigma=10.0),
                         UniformColor((0.5, 0.5, 0.5))))
        scene.add(Cornellbox((-1.0 - k, -1.0, -1.0), (1.0 + k, 1.0, 1.0),
                             Matte()))
        scene.add(AreaLight(Rectangle((-0.3, 0.9 - 0.1 * k, -0.3),
                                      (0.3, 0.9 - 0.1 * k, 0.3), Matte(),
                                      UniformColor((1.0, 1.0, 1.0))),
                            (1.0, 1.0, 1.0)))
    params, static = scene.pack()
    size = param_offsets(static).size
    assert size == 336 <= cap
    assert _k2_build(params, static).cap == cap


def test_ctypes_bindings_match_the_c_entries():
    """Each C entry's parameters, read from its source, against the
    argument types the wrapper binds it with: pointers where the C side
    takes a pointer, ints where it takes an int, and as many."""
    import ctypes
    import re
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.ops.cuda import profile as pf
    csrc = os.path.join(os.path.dirname(build.__file__), "..", "csrc")
    for source, name, argtypes in (
            ("megakernel.cu", "sail_render_block", mk.K1_ARGTYPES),
            ("megakernel_grad.cu", "sail_render_grad_block", mk.K2_ARGTYPES),
            ("reduce_grad_rows.cu", "sail_reduce_grad_rows",
             mk.REDUCE_ARGTYPES),
            ("trace_rays.cu", "sail_trace_rays", mk.KR_ARGTYPES),
            ("profile.cu", "sail_isect_only", pf.ISECT_ARGTYPES),
            ("profile.cu", "sail_alu_peak", pf.ALU_ARGTYPES),
            ("profile.cu", "sail_alu_peak_ilp8", pf.ALU_ILP8_ARGTYPES),
            ("profile.cu", "sail_render_block_stripped",
             pf.STRIPPED_ARGTYPES),
            ("profile_grad.cu", "sail_render_grad_profile",
             pf.GRAD_PROFILE_ARGTYPES)):
        with open(os.path.join(csrc, source)) as f:
            text = f.read()
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)', text).group(1)
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                 for p in params.split(",")]
        assert kinds == argtypes, name


def test_profile_constants_match_the_source():
    """The strip bits (path.cuh STRIP_*) and the mixes (profile.cu MIX_*)
    the wrappers pass, against the sources; profile.cu hashes path.cuh, and
    it and megakernel.cu hash K1's kernel (render_block.cuh)."""
    import re
    from sail_tpu_torch.ops.cuda import profile as pf
    with open(os.path.join(build.CSRC_DIR, "path.cuh")) as f:
        strips = dict(re.findall(r"STRIP_(\w+) = (\d+)", f.read()))
    assert {k.lower(): int(v) for k, v in strips.items()} == {
        "const_rng": pf.STRIPS["const_rng"],
        "const_texture": pf.STRIPS["const_texture"],
        "no_shadow": pf.STRIPS["no_shadow_scan"],
        "no_nee": pf.STRIPS["no_nee"]}
    with open(os.path.join(build.CSRC_DIR, "profile.cu")) as f:
        mixes = dict(re.findall(r"MIX_(\w+) = (\d+)", f.read()))
    assert {k.lower(): int(v) for k, v in mixes.items()} == {
        "fma": pf.MIXES["fma"], "integrator": pf.MIXES["integrator_mix"]}
    assert "path.cuh" in {os.path.basename(p)
                          for p in build.sources("profile")}
    # the stripped builds are K1's own kernel template, not a copy of it
    for name in ("megakernel", "profile"):
        assert "render_block.cuh" in {os.path.basename(p)
                                      for p in build.sources(name)}
    # ... and K2's are K2's (render_grad.cuh, whose builds' numbers come
    # as defines), its variants in the wrapper's order; K2's reduce holds
    # none of K2's code
    for name in ("megakernel_grad", "profile_grad"):
        assert "render_grad.cuh" in {
            os.path.basename(p) for p in build.sources(name)}
    assert [os.path.basename(p) for p in build.sources("reduce_grad_rows")] \
        == ["reduce_grad_rows.cu"]
    with open(os.path.join(build.CSRC_DIR, "profile_grad.cu")) as f:
        variants = dict(re.findall(r"VARIANT_(\w+) = (\d+)", f.read()))
    assert {k.lower(): int(v) for k, v in variants.items()} == \
        pf.GRAD_STRIPS


# The K2 entry of a tree before one library per build (a `cap` argument,
# no all_shapes nor lights), as a parent's source gives it to
# tools/k2_compare.py.
_PARENT_K2_DECL = '''
extern "C" int sail_render_grad_block(const float* params, const int* table, int n_obj,
                                      int n_plain, int n_groups, int n_mat, int n_tex,
                                      int n_light, int cam, int n_params, int cap, int materials,
                                      const float* gx, const float* gy, const float* gz,
                                      float* rows, int height, int width, int spp, int seed,
                                      int sample0, int max_bounces, int row0, int image_height,
                                      void* stream) {
'''


def test_k2_compare_binds_a_parent_by_its_signature():
    """tools/k2_compare.py binds a parent's K2 from the parameters its
    source declares, by name: this tree's entry gets its argument list; an
    entry of the layout before one library per build takes a `cap` the
    tool no longer has, which stops it, as does any parameter the tool
    does not know; the parent's library for a scene is its build's, as
    this tree's `grad_build` picks it."""
    from sail_tpu_torch import scenes
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.tools import k2_compare as kc
    names = ("params", "table", "n_obj", "n_plain", "n_groups", "n_mat",
             "n_tex", "n_light", "cam", "n_params", "all_shapes",
             "materials", "lights", "gx", "gy", "gz", "rows", "height",
             "width", "spp", "seed", "sample0", "max_bounces", "row0",
             "image_height", "stream")
    values = {n: i for i, n in enumerate(names)}
    with open(os.path.join(build.CSRC_DIR, "megakernel_grad.cu")) as f:
        here = kc.entry_params(f.read())
    argtypes, args = kc.parent_args(here, values)
    assert argtypes == mk.K2_ARGTYPES
    assert args == [values[n] for n in names]
    old = kc.entry_params(_PARENT_K2_DECL)
    assert [n for _, n in old] == [
        n for n in names[:10] + ("cap",) + names[10:]
        if n not in ("all_shapes", "lights")]
    with pytest.raises(ValueError, match="cap"):
        kc.parent_args(old, values)
    with pytest.raises(ValueError, match="min_blocks"):
        kc.parent_args(here[:11] + [(False, "min_blocks")] + here[11:],
                       values)
    with pytest.raises(ValueError, match="materials"):
        kc.parent_args([(True, n) if n == "materials" else (p, n)
                        for p, n in here], values)
    # the library a scene runs: megakernel_grad.cu with its build's
    # defines, by parameter count and kind
    mirror = scenes.cornell_mirror().pack()[1]
    demo = scenes.material_demo().pack()[1]
    assert [kc.k2_library(n, demo)[1][:3] for n in (72, 879, 3375)] == [
        (f"GRAD_CAP={c}", "GRAD_ALL=true", "GRAD_MATS=true")
        for c in (0, 1024, 4096)]
    assert [kc.k2_library(n, mirror)[1][0] for n in (72, 220, 221, 879)] \
        == ["GRAD_CAP=0", "GRAD_CAP=0", "GRAD_CAP=352", "GRAD_CAP=1024"]
    assert {kc.k2_library(n, mirror)[0] for n in (72, 879)} == \
        {"megakernel_grad"}


# K1's entry before the staged rectangle frames (no n_frames), as the
# parent's source gives it to tools/k2_compare.py.
_PARENT_K1_DECL = '''
extern "C" int sail_render_block(const float* params, const int* table, int n_obj, int n_plain,
                                 int n_groups, int n_mat, int n_tex, int n_light, int cam,
                                 int all_shapes, int materials, int n_clusters, float* out_x,
                                 float* out_y,
                                 float* out_z, int height, int width, int spp, int seed, int sample0,
                                 int max_bounces, int row0, int image_height, void* stream) {
'''


def test_k1_compare_binds_a_parent_by_its_signature():
    """tools/k2_compare.py binds a parent's K1, its stripped builds and K5a
    from the parameters their sources declare, by name: this tree's entries
    and the K1 entry without `n_frames` each get their own argument list; a
    parameter the tool does not know stops it."""
    import ctypes
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.ops.cuda import profile as pf
    from sail_tpu_torch.tools import k2_compare as kc
    names = ("params", "table", "n_obj", "n_plain", "n_groups", "n_mat",
             "n_tex", "n_light", "cam", "all_shapes", "materials",
             "n_clusters", "n_frames", "out_x", "out_y", "out_z", "height",
             "width", "spp", "seed", "sample0", "max_bounces", "row0",
             "image_height", "stream")
    values = {n: i for i, n in enumerate(names + ("strip", "out"))}
    with open(os.path.join(build.CSRC_DIR, "megakernel.cu")) as f:
        here = kc.entry_params(f.read(), "sail_render_block")
    argtypes, args = kc.parent_args(here, values)
    assert argtypes == mk.K1_ARGTYPES
    assert args == [values[n] for n in names]
    old = kc.entry_params(_PARENT_K1_DECL, "sail_render_block")
    argtypes, args = kc.parent_args(old, values)
    assert [n for _, n in old] == [n for n in names if n != "n_frames"]
    assert argtypes == [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10 \
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    assert args[12] == values["out_x"]
    with open(os.path.join(build.CSRC_DIR, "profile.cu")) as f:
        prof = f.read()
    for entry, want in (("sail_render_block_stripped", pf.STRIPPED_ARGTYPES),
                        ("sail_isect_only", pf.ISECT_ARGTYPES)):
        assert kc.parent_args(kc.entry_params(prof, entry), values)[0] \
            == want, entry
    with pytest.raises(ValueError, match="n_rects"):
        kc.parent_args(old[:12] + [(False, "n_rects")] + old[12:], values)
    with pytest.raises(ValueError, match="out_x"):
        kc.parent_args([(False, n) if n == "out_x" else (p, n)
                        for p, n in old], values)


def test_k2_compare_names_a_kernel_as_its_parent_did():
    """tools/k2_compare.py compares a library's kernels with the parent's
    library of the same defines, kernel by kernel under the same name: a
    K2 build with the same SASS and resources is `same`, one whose SASS or
    resources changed `differ`, one only one tree builds neither; K1's and
    the reduce's are listed with both trees' resources."""
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.tools import k2_compare as kc
    two, shared = mk.GRAD_BUILDS[0].kernel, mk.GRAD_BUILDS[1].kernel
    assert two == "render_grad_kernel<0, false, false, 0, 2, false>"
    res = {"registers": 128, "stack": 0}
    old = {two: ["FADD R1, R2, R3"], shared: ["FMUL R1, R2, R3"],
           "render_grad_kernel<352, true, false, 0, 1, false>": ["EXIT"],
           "reduce_grad_rows_kernel<1>": ["EXIT"]}
    new = {two: ["FADD R1, R2, R3"], shared: ["FMUL R1, R2, R4"],
           "reduce_grad_rows_kernel<1>": ["NOP"]}
    out = {"same": [], "differ": [], "k1": {}}
    kc.compare_kernels("megakernel_grad", old, new, {k: res for k in old},
                       {k: res for k in new}, out)
    assert out["same"] == [f"{two} (megakernel_grad)"]
    assert out["differ"] == [f"{shared} (megakernel_grad)"]
    assert out["k1"] == {"reduce_grad_rows_kernel<1> (megakernel_grad)": {
        "parent": res, "new": res, "sass_changed": True}}
    out = {"same": [], "differ": [], "k1": {}}
    kc.compare_kernels("megakernel_grad", {two: old[two]}, {two: old[two]},
                       {two: res}, {two: dict(res, registers=127)}, out)
    assert out["differ"] == [f"{two} (megakernel_grad)"] and not out["same"]
