"""Build the port's CUDA kernels from the repository's sources.

A library is `csrc/<name>.cu` compiled with nvcc, with a tuple of defines
(`"NAME=VALUE"`, given to nvcc as `-DNAME=VALUE`) or none: a source name
alone, or a `(name, defines)` pair.  One source may make many libraries, one
per set of defines (K2: one per build, `ops/cuda/megakernel.py`
`grad_build`).  Each compiles into a shared library with a plain C
interface under `<repo>/build/kernels/`, at first use, and loads with
`ctypes`.  The library's file name carries the defines' values and a hash of
the flags, the defines, the source and every `csrc/` header it includes
(`#include "..."`, followed recursively), so an edited source or header
rebuilds and a stale library is never loaded.  `build(*libs)` runs one nvcc
per library, as many at once as the host has cores.  There is no fallback:
without nvcc the build raises.

`load_host` builds a C++ source of the repository for the host the same
way, with g++, into `<repo>/build/native/` (the native image codec).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
REPO_DIR = os.path.dirname(PACKAGE_DIR)
BUILD_DIR = os.path.join(REPO_DIR, "build", "kernels")
HOST_BUILD_DIR = os.path.join(REPO_DIR, "build", "native")

# Hopper only (`sm_90a`).  -fmad=false: the plain torch version never
# contracts a*b+c, and pixels on a geometric edge flip on one ulp.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else
    /usr/local/cuda/bin/nvcc.  Raises if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def sources(name: str) -> list:
    """csrc/<name>.cu and every csrc header it includes, in the order first
    reached."""
    out = []
    todo = [f"{name}.cu"]
    while todo:
        path = os.path.join(CSRC_DIR, todo.pop(0))
        if path in out:
            continue
        out.append(path)
        with open(path) as f:
            todo += re.findall(r'^\s*#\s*include\s+"([^"]+)"', f.read(), re.M)
    return out


def _spec(lib) -> tuple:
    """(source name, defines) of a library given as a name or a pair."""
    return (lib, ()) if isinstance(lib, str) else (lib[0], tuple(lib[1]))


def _library_path(lib) -> str:
    name, defines = _spec(lib)
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in sources(name):
        with open(path, "rb") as f:
            digest.update(f.read())
    tag = "".join(f"-{d.split('=', 1)[-1]}" for d in defines)
    return os.path.join(BUILD_DIR,
                        f"lib{name}{tag}-{digest.hexdigest()[:16]}.so")


def build(*libs) -> list:
    """Compile each library (a source name or a `(name, defines)` pair)
    whose current build does not exist, one nvcc each, as many at once as
    the host has cores; return the libraries' paths.  nvcc's resource
    report (`-Xptxas -v`) is kept beside each library as `<library>.log`."""
    paths = [_library_path(lib) for lib in libs]
    todo = [(_spec(lib), path) for lib, path in zip(libs, paths)
            if not os.path.exists(path)]
    running, failed = [], []

    def finish(job):
        (name, _), path, tmp, proc = job
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building {name} "
                          f"{path}:\n{out}\n{err}")
            return
        with open(f"{path}.log", "w") as f:
            f.write(out + err)
        os.replace(tmp, path)

    for (name, defines), path in todo:
        if len(running) >= len(os.sched_getaffinity(0)):
            finish(running.pop(0))
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o",
               tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        running.append(((name, defines), path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for job in running:
        finish(job)
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def load(lib) -> ctypes.CDLL:
    """Build (if needed) and load a library (a source name or a
    `(name, defines)` pair) once per process."""
    path = _library_path(lib)
    with _lock:
        if path not in _loaded:
            _loaded[path] = ctypes.CDLL(build(lib)[0])
        return _loaded[path]


# `native/Makefile`'s flags but -march=native: the library's arithmetic is
# then the same on every x86-64 host (no contracted multiply-adds).
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-Wall")


def _local_sources(source: str) -> list:
    """`source` and every file it includes with `#include "..."`, followed
    recursively, each found beside the file that includes it."""
    out, todo = [], [os.path.abspath(source)]
    while todo:
        path = todo.pop(0)
        if path in out or not os.path.exists(path):
            continue
        out.append(path)
        with open(path) as f:
            todo += [os.path.normpath(os.path.join(os.path.dirname(path), inc))
                     for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"',
                                           f.read(), re.M)]
    return out


def load_host(source: str, link: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load a C++ source of the repository as a
    shared library for the host: g++ with HOST_FLAGS and `link` (extra
    flags after the source) into HOST_BUILD_DIR, the file name carrying a
    hash of the flags, the source and the repository files it includes,
    under the kernels' lock, once per process.  Raises if g++ is missing or
    fails."""
    digest = hashlib.sha256(" ".join(HOST_FLAGS + tuple(link)).encode())
    for path in _local_sources(source):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()[:16]
    stem = os.path.splitext(os.path.basename(source))[0]
    lib = os.path.join(HOST_BUILD_DIR, f"lib{stem}-{digest}.so")
    with _lock:
        if lib not in _loaded:
            if not os.path.exists(lib):
                cxx = shutil.which("g++")
                if cxx is None:
                    raise RuntimeError(f"g++ not found: {source} needs a C++ "
                                       f"compiler")
                os.makedirs(HOST_BUILD_DIR, exist_ok=True)
                tmp = f"{lib}.{os.getpid()}.tmp"
                proc = subprocess.run([cxx, *HOST_FLAGS, "-o", tmp, source,
                                       *link], capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed ({proc.returncode}) "
                                       f"building {source}:\n{proc.stderr}")
                os.replace(tmp, lib)
            _loaded[lib] = ctypes.CDLL(lib)
        return _loaded[lib]


def kernel_name(symbol: str) -> str:
    """A kernel's own name from its (Itanium-mangled) symbol:
    `_ZN..._GLOBAL__N_119render_block_kernelE6Scene...` gives
    `render_block_kernel`, and an instance of a template over integer or
    bool literals, `..._GLOBAL__N_118render_grad_kernelILi352EEEv...` or
    `...19render_block_kernelILb1ELb0EEEv...`, gives `render_grad_kernel<352>`
    or `render_block_kernel<true, false>`; an unmangled name is returned as
    it is.  The names are read by their length prefixes, not searched for:
    nvcc names an anonymous namespace after a hash of the file, which may
    hold digits followed by letters."""
    if not symbol.startswith("_Z"):
        return symbol
    nested = symbol.startswith("_ZN")
    pos, name = (3 if nested else 2), symbol
    while True:
        m = re.match(r"\d+", symbol[pos:])
        if not m:
            t = re.match(r"I((?:L[ijb]\d+E)+)E", symbol[pos:])
            if not t:
                return name
            args = [("false", "true")[int(v)] if k == "b" else v
                    for k, v in re.findall(r"L([ijb])(\d+)E", t.group(1))]
            return f"{name}<{', '.join(args)}>"
        start = pos + m.end()
        name, pos = symbol[start:start + int(m.group())], start + int(m.group())
        if not nested:
            return name


def resource_usage(lib) -> dict:
    """{kernel name: registers, spill bytes, stack and static shared memory}
    for each kernel in the library (a source name or a `(name, defines)`
    pair), from the `-Xptxas -v` report of its build."""
    with open(_library_path(lib) + ".log") as f:
        return parse_resource_usage(f.read())


def parse_resource_usage(log: str) -> dict:
    """`resource_usage` of one `-Xptxas -v` report."""
    out = {}
    kernel = symbol = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel, symbol = kernel_name(m.group(1)), m.group(1)
        m = re.search(r"Function properties for (\w+)", line)
        if m and kernel and m.group(1) != symbol:
            kernel = None   # a device function's frame, not the kernel's
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and kernel:
            out.setdefault(kernel, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)),
                spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            out.setdefault(kernel, {})["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[kernel]["smem"] = int(m.group(1)) if m else 0
    return out
