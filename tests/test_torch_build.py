"""`sail_tpu_torch.utils.build` without nvcc: the library name follows
every header a source includes, and the `-Xptxas -v` report is read per
kernel.  (The build itself runs on the card: `python3 chip_smoke.py`.)"""
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
                                   spill_stores=8, spill_loads=8),
        "reduce_grad_rows_kernel": dict(registers=12, stack=0,
                                        spill_stores=0, spill_loads=0)}


def test_build_without_nvcc_raises(csrc, monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        pytest.skip("this machine has the CUDA toolkit")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("k")


def test_largest_scene_of_the_slice_fits_k2():
    """K2 sums each thread's gradient in a compile-time array, built for a
    few sizes (`megakernel_grad.cu` CAPS, which the wrapper's GRAD_CAPS
    repeats): a scene of 7 objects of each of the first slice's shapes,
    every one with its own material and texture, every rectangle a light,
    fits the smallest; the 256-sphere scene of the many-object benchmark
    (3,375 parameters) fits the largest."""
    import re
    from sail_tpu_torch import (AreaLight, Camera, Cornellbox, Matte, Rectangle,
                                Scene, Sphere, UniformColor, scenes)
    from sail_tpu_torch.ops.cuda import megakernel as mk
    from sail_tpu_torch.scene.scene import param_offsets
    with open(os.path.join(build.CSRC_DIR, "megakernel_grad.cu")) as f:
        caps = tuple(int(c) for c in re.search(
            r"constexpr int CAPS\[\] = \{([\d, ]+)\};", f.read()).group(1)
            .split(","))
    assert caps == mk.GRAD_CAPS
    cap = caps[0]
    assert mk.grad_cap(scenes.many_spheres(256).pack()[0].numel()) == caps[-1]
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
    _, static = scene.pack()
    size = param_offsets(static).size
    assert size == 336 <= cap
