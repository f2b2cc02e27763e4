"""ctypes bridge to the port's native GF(2^8) core.

Counterpart of the GF part of ceph_tpu/native/bridge.py: ``gf_mul``,
``simd_kind``, ``rs_encode``, ``gf_apply``, ``rs_encode_mt`` and
``rs_decode``, over the port's own copy of the reference's native sources
(``csrc/``: gf256, rs, registry, capi, the two ``libec_<name>.so`` plugins
and the ``ceph_erasure_code_benchmark`` CLI).  crc32c lives in
``utils/checksum.py``; the wire path has no native arm in the port yet.

Everything is built with ``g++`` at first use into ``ceph_tpu_torch/_build/``
under names that carry a hash of the sources and flags (as
``utils/checksum.py`` builds crc32c), each written to a temporary name and
renamed into place, so concurrent first users in several processes never
load a partial file.  A failed build raises with the compiler's output: the
codecs' w=8 ``_apply`` has no hidden fallback (ec/codecs.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "native", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

FLAGS = ["-std=c++17", "-O3", "-march=native", "-fPIC",
         "-Wall", "-Wextra", "-Werror"]
HEADERS = ("gf256.h", "rs.h", "ec_api.h", "plugin_common.h")
LIB_SOURCES = ("gf256.cc", "rs.cc", "registry.cc", "capi.cc")
# libec_<name>.so, each with its own copy of the GF core (the reference's
# native/CMakeLists.txt links them the same way)
PLUGINS = {"jerasure": ("plugin_jerasure.cc", "gf256.cc", "rs.cc"),
           "isa": ("plugin_isa.cc", "gf256.cc", "rs.cc")}
BENCHMARK = "ceph_erasure_code_benchmark"

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _digest(names: Sequence[str], extra: Sequence[str] = ()) -> str:
    h = hashlib.sha256(" ".join([*FLAGS, *extra]).encode())
    for name in sorted(set(names) | set(HEADERS)):
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _gxx(out: str, sources: Sequence[str], *extra: str) -> subprocess.Popen:
    return subprocess.Popen(
        ["g++", *FLAGS, "-o", out,
         *(os.path.join(CSRC, s) for s in sources), *extra],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def _wait(proc: subprocess.Popen, what: str) -> None:
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {what} "
                           f"(exit {proc.returncode}):\n{err}")


def library_path() -> str:
    """Where the core library lives for the current sources and flags."""
    return os.path.join(BUILD_DIR,
                        f"libceph_tpu_ec-{_digest(LIB_SOURCES)}.so")


def build() -> str:
    """Compile the core library if it is missing; returns its path."""
    target = library_path()
    if not os.path.exists(target):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
        _wait(_gxx(tmp, LIB_SOURCES, "-shared", "-ldl", "-pthread"),
              "the native GF core")
        os.replace(tmp, target)  # atomic: no reader sees a partial file
    return target


def tools_dir() -> str:
    """Where the plugins and the benchmark CLI live for the current sources
    and flags."""
    names = [s for srcs in PLUGINS.values() for s in srcs] + ["bench.cc"]
    return os.path.join(BUILD_DIR, f"native-{_digest(names + list(LIB_SOURCES))}")


def build_tools() -> str:
    """Compile ``libec_jerasure.so``, ``libec_isa.so`` and the
    ``ceph_erasure_code_benchmark`` CLI (linked to the core library) into
    one directory if it is missing, all three compilers at once; returns
    the directory, which is what the CLI's ``--directory`` takes."""
    target = tools_dir()
    if os.path.isdir(target):
        return target
    lib = build()
    tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
    os.makedirs(tmp, exist_ok=True)
    try:
        procs = [(_gxx(os.path.join(tmp, f"libec_{name}.so"), srcs,
                       "-shared"), f"libec_{name}.so")
                 for name, srcs in PLUGINS.items()]
        procs.append((_gxx(os.path.join(tmp, BENCHMARK), ["bench.cc"], lib,
                           f"-Wl,-rpath,{os.path.dirname(lib)}", "-ldl"),
                      BENCHMARK))
        for proc, what in procs:
            _wait(proc, what)
        try:
            os.rename(tmp, target)  # atomic for a directory
        except OSError:
            if not os.path.isdir(target):
                raise
            # another process renamed its identical build first
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return target


def lib() -> ctypes.CDLL:
    """The loaded core library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _configure(ctypes.CDLL(build()))
        return _LIB


def _configure(so: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every exported symbol's signature."""
    so.ceph_tpu_gf_mul.restype = ctypes.c_uint8
    so.ceph_tpu_gf_mul.argtypes = [ctypes.c_uint8, ctypes.c_uint8]
    so.ceph_tpu_simd_kind.restype = ctypes.c_char_p
    so.ceph_tpu_simd_kind.argtypes = []
    so.ceph_tpu_rs_encode.restype = ctypes.c_int
    so.ceph_tpu_rs_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
    ]
    so.ceph_tpu_gf_apply.restype = ctypes.c_int
    so.ceph_tpu_gf_apply.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
    ]
    so.ceph_tpu_rs_encode_mt.restype = ctypes.c_int
    so.ceph_tpu_rs_encode_mt.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_int,
    ]
    so.ceph_tpu_rs_decode.restype = ctypes.c_int
    so.ceph_tpu_rs_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_size_t,
    ]
    return so


def _u8(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_char_p)


def gf_mul(a: int, b: int) -> int:
    return lib().ceph_tpu_gf_mul(a, b)


def simd_kind() -> str:
    """Which vectorized region kernel the native core dispatched to
    ("gfni" | "avx2" | "scalar"; CEPH_TPU_NO_SIMD=1 pins "scalar")."""
    return lib().ceph_tpu_simd_kind().decode()


def rs_encode(technique: str, data: np.ndarray, m: int) -> np.ndarray:
    """[k, chunk] uint8 -> [m, chunk] parity for a named technique
    (reed_sol_van, reed_sol_r6_op, cauchy_orig, isa_reed_sol_van,
    isa_cauchy)."""
    k, chunk = data.shape
    data = _u8(data)
    parity = np.zeros((m, chunk), dtype=np.uint8)
    rc = lib().ceph_tpu_rs_encode(technique.encode(), k, m, _ptr(data),
                                  _ptr(parity), chunk)
    if rc != 0:
        raise RuntimeError(f"native encode failed ({rc})")
    return parity


def gf_apply(matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
    """out[rows, chunk] = matrix[rows, cols] (x) data[cols, chunk] over
    GF(2^8) with the vectorized region kernels: the CPU codecs' w=8
    ``_apply`` (generator, inverted decode and recovery matrices alike)."""
    rows, cols = matrix.shape
    if data.ndim != 2 or data.shape[0] != cols:
        raise ValueError(f"gf_apply: matrix {matrix.shape} does not take "
                         f"regions {data.shape}")
    matrix, data = _u8(matrix), _u8(data)
    out = np.zeros((rows, data.shape[1]), dtype=np.uint8)
    rc = lib().ceph_tpu_gf_apply(_ptr(matrix), rows, cols, _ptr(data),
                                 _ptr(out), data.shape[1])
    if rc != 0:
        raise RuntimeError(f"native gf_apply failed ({rc})")
    return out


def rs_encode_mt(technique: str, data: np.ndarray, m: int,
                 nthreads: int = 0) -> tuple:
    """Encode with every core on its own column range (``nthreads`` <= 0:
    all of them).  Returns (parity, threads used)."""
    k, chunk = data.shape
    data = _u8(data)
    parity = np.zeros((m, chunk), dtype=np.uint8)
    rc = lib().ceph_tpu_rs_encode_mt(technique.encode(), k, m, _ptr(data),
                                     _ptr(parity), chunk, nthreads)
    if rc < 0:
        raise RuntimeError(f"native mt encode failed ({rc})")
    return parity, rc


def rs_decode(technique: str, k: int, m: int, sources: Sequence[int],
              source_data: np.ndarray, targets: Sequence[int]) -> np.ndarray:
    """Reconstruct `targets` chunks from k source chunks [k, chunk]."""
    if len(sources) != k or source_data.shape[0] != k:
        raise ValueError(f"rs_decode takes exactly k={k} sources")
    chunk = source_data.shape[1]
    source_data = _u8(source_data)
    out = np.zeros((len(targets), chunk), dtype=np.uint8)
    src = (ctypes.c_int * k)(*sources)
    tgt = (ctypes.c_int * len(targets))(*targets)
    rc = lib().ceph_tpu_rs_decode(technique.encode(), k, m, src,
                                  _ptr(source_data), len(targets), tgt,
                                  _ptr(out), chunk)
    if rc != 0:
        raise RuntimeError(f"native decode failed ({rc})")
    return out
