"""Build and load the port's hand-written CUDA kernels (ops/csrc/*.cu).

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface, at first use, into ``ops/_kbuild/`` (listed in .gitignore), and
loaded with ctypes. The library name carries a hash of the source and flags,
so an edited source rebuilds and concurrent processes never load a
half-written file (the build writes a temporary name, then renames).
``build_all`` starts one ``nvcc`` per source, all at once. Nothing here runs
at import time: the CPU tests import every module of the package on
machines without ``nvcc``.

``host_library`` does the same for host C++ (the snappy codec,
io/csrc/snappy.cpp, and the host kernel library, csrc/kernels.cpp): the
host compiler (``$CXX``, else ``c++``) with ``HOST_FLAGS``, into the same
build directory, at first use; a failed build raises. ``BUILD_INFO`` keeps
each host source's library path and compile seconds (0.0: a cached build).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_kbuild")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# per-source build record: seconds spent in nvcc (0.0 = loaded a cached build)
# and the compiler's -Xptxas -v report (registers, shared memory, spills)
BUILD_INFO: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _target(source: str) -> str:
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def _compile(sources: List[str]) -> None:
    """Compile the sources whose library is missing, one nvcc each, all
    started together; raises on the first that fails."""
    jobs = []
    for source in sources:
        out = _target(source)
        BUILD_INFO[source] = {"seconds": 0.0, "ptxas": "", "path": out}
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        jobs.append((source, out, tmp, proc, time.perf_counter()))
    failures = []
    for source, out, tmp, proc, t0 in jobs:
        stdout, stderr = proc.communicate()
        BUILD_INFO[source]["seconds"] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {source} (rc {proc.returncode}):\n"
                            f"{stdout}\n{stderr}")
            continue
        BUILD_INFO[source]["ptxas"] = stderr
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))


def library(source: str) -> ctypes.CDLL:
    """The loaded shared library of csrc/<source>, building it if needed.
    Raises when the build fails: there is no fallback to a plain version."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            if source not in BUILD_INFO or not os.path.exists(_target(source)):
                _compile([source])
            lib = _LIBS[source] = ctypes.CDLL(_target(source))
        return lib


def build_all() -> None:
    """Build every csrc/*.cu in parallel (one nvcc per source) and load them."""
    sources = sorted(os.path.basename(p) for p in glob.glob(os.path.join(CSRC, "*.cu")))
    with _LOCK:
        _compile([s for s in sources if s not in _LIBS])
    for source in sources:
        library(source)


def _host_target(path: str) -> str:
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(HOST_FLAGS).encode()).hexdigest()[:12]
    stem = os.path.splitext(os.path.basename(path))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_host_{digest}.so")


def host_library(path: str) -> ctypes.CDLL:
    """The loaded shared library of the host C++ source at ``path``, built
    with the host compiler if needed. Raises when the build fails."""
    with _LOCK:
        lib = _LIBS.get(path)
        if lib is not None:
            return lib
        out = _host_target(path)
        BUILD_INFO[os.path.basename(path)] = {"seconds": 0.0, "ptxas": "", "path": out}
        if not os.path.exists(out):
            cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
            if not cxx:
                raise RuntimeError(f"no host C++ compiler found to build {path}")
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run([cxx, *HOST_FLAGS, "-o", tmp, path],
                                  capture_output=True, text=True)
            BUILD_INFO[os.path.basename(path)]["seconds"] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed for {path} (rc {proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)
        lib = _LIBS[path] = ctypes.CDLL(out)
        return lib
