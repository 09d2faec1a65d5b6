"""Build the port's native libraries and load them with ctypes.

Each `csrc/<name>.cu` is one shared library with a plain C interface (no
PyTorch headers, so it builds in seconds), compiled by nvcc. Host-only C++
sources (the image codec, data/csrc/image_io.cpp) are compiled by g++ through
`load_host`. Libraries go to `_build/` in the package, named by a hash of the
source and flags, so an edited source is rebuilt and an unchanged one is loaded
as it is. Nothing is built when the package is imported: a kernel's wrapper
calls `load()` when it first launches, the image codec when it is first used.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off", "-pthread")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from PATH, else from $CUDA_HOME or the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built on this host")


def _out_path(src: str, flags) -> str:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def _lib_path(name: str) -> str:
    return _out_path(os.path.join(CSRC, name + ".cu"), NVCC_FLAGS)


def build_all(names: Iterable[str] = None) -> Dict[str, str]:
    """Compile every named source (default: all of csrc/) that is not built yet,
    one nvcc per source, all started together. Returns {name: ptxas report}."""
    if names is None:
        names = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            jobs[name] = None
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), tmp, out)
    reports, failures = {}, []
    for name, job in jobs.items():
        if job is None:
            reports[name] = "(already built)"
            continue
        proc, tmp, out = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        reports[name] = log
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(_lib_path(name))
    return lib


def load_host(src: str, flags=()) -> ctypes.CDLL:
    """The library g++ builds from the C++ source `src` with `flags` (defines
    and -l libraries), built first if needed; a failed build raises with the
    compiler's output."""
    flags = (*GXX_FLAGS, *flags)
    out = _out_path(src, flags)
    lib = _LIBS.get(out)
    if lib is not None:
        return lib
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        defines = [f for f in flags if not f.startswith("-l")]
        libs = [f for f in flags if f.startswith("-l")]
        proc = subprocess.run(["g++", *defines, "-o", tmp, src, *libs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {os.path.basename(src)} (exit "
                               f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    lib = _LIBS[out] = ctypes.CDLL(out)
    return lib


def gxx_finds_header(header: str) -> bool:
    """Whether g++ finds `<header>` on its include path (after <cstdio>,
    which C headers such as jpeglib.h need first)."""
    proc = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o", os.devnull],
                          input=f"#include <cstdio>\n#include <{header}>\n",
                          capture_output=True, text=True)
    return proc.returncode == 0
