"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` is one shared library with a plain C interface (no
PyTorch headers, so it builds in seconds). Libraries go to `_build/` in the
package, named by a hash of the source and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. Nothing is built when the
package is imported: a kernel's wrapper calls `load()` when it first launches.
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


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


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
