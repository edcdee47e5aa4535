"""Build a native source at first use and load it with ctypes: one routine,
two compilers.

A source has a plain C interface and compiles alone into
``build/monosowa_tpu_torch/<name>-<hash>.so`` under the checkout (the hash
covers the source and the flags, so an edited source is rebuilt):

* ``<src_dir>/<name>.cu``, a CUDA kernel, with nvcc for sm_90a;
* ``<src_dir>/<name>.cpp``, host C++ (the KITTI evaluation's kernels), with
  the host compiler (``$CXX``, else g++ or c++).

The library is written to a temporary name and renamed into place, so
several processes may build the same source at once.  Nothing here runs at
import time; the caller sets its entry points' signatures.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "monosowa_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _cxx() -> str:
    for cand in (os.environ.get("CXX", ""), "g++", "c++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no host C++ compiler found (set CXX or put g++ on "
                       "PATH)")


def _source(name: str, src_dir: str) -> Tuple[str, Tuple[str, ...]]:
    """(path, flags) of the source ``name`` in ``src_dir``."""
    for ext, flags in ((".cu", NVCC_FLAGS), (".cpp", CXX_FLAGS)):
        path = os.path.join(src_dir, name + ext)
        if os.path.isfile(path):
            return path, flags
    raise FileNotFoundError(f"no {name}.cu or {name}.cpp in {src_dir}")


def _lib_path(name: str, src_dir: str) -> str:
    src, flags = _source(name, src_dir)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str, src_dir: str = CSRC) -> str:
    """Compile ``<src_dir>/<name>.cu`` or ``.cpp`` unless its library
    exists.  Returns the compiler's output (for nvcc the ptxas register
    counts), "" when nothing was built.  Raises with the compiler's output
    when the build fails."""
    path = _lib_path(name, src_dir)
    if os.path.exists(path):
        return ""
    src, flags = _source(name, src_dir)
    compiler = _nvcc() if src.endswith(".cu") else _cxx()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run([compiler, *flags, "-o", tmp, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed: {name}: "
                           f"{os.path.basename(compiler)} exit "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, path)
    return proc.stdout


def load_library(name: str, src_dir: str = CSRC) -> ctypes.CDLL:
    """The library of ``<src_dir>/<name>.cu`` or ``.cpp``, built at first
    use."""
    path = _lib_path(name, src_dir)
    lib = _loaded.get(path)
    if lib is None:
        build(name, src_dir)
        lib = _loaded[path] = ctypes.CDLL(path)
    return lib
