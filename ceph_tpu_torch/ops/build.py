"""Build the port's CUDA sources at first use and load them with ctypes.

Each library is one ``nvcc`` call over one source in ``ops/csrc/`` for
``sm_90a`` (Hopper), producing a shared library with a plain C interface —
no PyTorch headers, so a build takes seconds.  Libraries go to
``ceph_tpu_torch/_build/`` under a name that carries a hash of the sources,
headers and flags, so an edited source is rebuilt and a stale library is
never loaded.  ``ptxas -v`` output (registers, shared memory, spills) is kept
beside each library as ``<name>.log``.

    python -m ceph_tpu_torch.ops.build     # build every library, print logs
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from typing import Dict, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

#: library name -> its one source file in csrc/
SOURCES = {"gf2": "gf2.cu", "packedbit": "packedbit.cu"}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or the toolkit's
    default install prefix."""
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> str:
    """Where library `name` lives for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    deps = [os.path.join(CSRC_DIR, SOURCES[name])]
    deps += sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in deps:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str) -> Tuple[subprocess.Popen, str, str]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    target = library_path(name)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp,
           os.path.join(CSRC_DIR, SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, proc: subprocess.Popen, tmp: str, target: str) -> str:
    log, _ = proc.communicate()
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, target)  # atomic: a concurrent build never sees a partial file
    return log


def build_all() -> Dict[str, Tuple[float, str]]:
    """Build every library that is missing, one nvcc per source, all started
    together.  Returns name -> (seconds, compiler log); an up-to-date library
    reports (0.0, "up to date")."""
    t0 = time.perf_counter()
    started = {}
    results: Dict[str, Tuple[float, str]] = {}
    for name in SOURCES:
        if os.path.exists(library_path(name)):
            results[name] = (0.0, "up to date")
        else:
            started[name] = _start(name)
    for name, (proc, tmp, target) in started.items():
        log = _finish(name, proc, tmp, target)
        results[name] = (time.perf_counter() - t0, log)
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if it is missing."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                _finish(name, *_start(name))
            lib = _LOADED[name] = ctypes.CDLL(path)
        return lib


if __name__ == "__main__":
    for lib_name, (secs, text) in build_all().items():
        print(f"{lib_name}: {secs:.1f}s\n{text}")
    sys.exit(0)
