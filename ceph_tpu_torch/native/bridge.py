"""ctypes bridge to the port's native GF(2^8) core and native wire path.

Counterpart of ceph_tpu/native/bridge.py, over the port's own copy of the
reference's native sources (``csrc/``): the GF core (``gf_mul``,
``simd_kind``, ``rs_encode``, ``gf_apply``, ``rs_encode_mt``,
``rs_decode``; gf256, rs, registry, capi), the two ``libec_<name>.so``
plugins and the ``ceph_erasure_code_benchmark`` CLI, and the messenger's
wire path (``wirepath_kind``, ``wirepath_selftest``, ``wire_*`` over
wirepath.cc, and the PyDLL shim's ``wirepy_*`` over wirepath_py.cc).  The
process checksum lives in ``utils/checksum.py``; ``utils/wirepath.py``
decides whether a messenger runs the wire path below.

Everything is built with ``g++`` at first use into ``ceph_tpu_torch/_build/``
under names that carry a hash of the sources and flags (as
``utils/checksum.py`` builds crc32c), each written to a temporary name and
renamed into place, so concurrent first users in several processes never
load a partial file.  The two wire libraries each compile the port's
``utils/csrc/crc32c.cc`` in, so each calls its own copy of
``ceph_tpu_crc32c`` beside any other library that exports the name.  A
failed build raises with the compiler's output: the codecs' w=8 ``_apply``
and the messengers' wire path have no hidden fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
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
# the wire path: libceph_tpu_wire (plain C entry points, called through
# ctypes with the GIL released) and libceph_tpu_wirepy (the PyDLL shim,
# which parses Python segment lists itself), each with crc32c compiled in
CRC32C_SOURCE = os.path.join(_PKG_DIR, "utils", "csrc", "crc32c.cc")
WIRE_HEADERS = ("wirepath.h",)
WIRE_SOURCES = ("wirepath.cc", CRC32C_SOURCE)
WIREPY_SOURCES = ("wirepath_py.cc", "wirepath.cc", CRC32C_SOURCE)

_LIB: Optional[ctypes.CDLL] = None
_WIRE: Optional[ctypes.CDLL] = None
_WIREPY: Optional[ctypes.PyDLL] = None
_LOCK = threading.Lock()


def _digest(names: Sequence[str], extra: Sequence[str] = (),
            headers: Sequence[str] = HEADERS) -> str:
    """A hash of the flags and the sources (names under CSRC, or absolute
    paths) and headers a build reads."""
    h = hashlib.sha256(" ".join([*FLAGS, *extra]).encode())
    for name in sorted(set(names) | set(headers)):
        h.update(os.path.basename(name).encode())
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


def _build_once(target: str, sources: Sequence[str], what: str,
                *extra: str) -> str:
    """Compile `sources` into the shared library `target` if it is
    missing, through a temporary name; returns `target`."""
    if not os.path.exists(target):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
        _wait(_gxx(tmp, sources, "-shared", *extra), what)
        os.replace(tmp, target)  # atomic: no reader sees a partial file
    return target


def build() -> str:
    """Compile the core library if it is missing; returns its path."""
    return _build_once(library_path(), LIB_SOURCES, "the native GF core",
                       "-ldl", "-pthread")


def wire_library_path() -> str:
    """Where the wire-path library lives for the current sources and
    flags."""
    digest = _digest(WIRE_SOURCES, headers=WIRE_HEADERS)
    return os.path.join(BUILD_DIR, f"libceph_tpu_wire-{digest}.so")


def build_wire() -> str:
    """Compile the wire-path library (wirepath.cc and crc32c.cc) if it is
    missing; returns its path."""
    return _build_once(wire_library_path(), WIRE_SOURCES,
                       "the native wire path")


def _python_include() -> str:
    """The directory of this interpreter's Python.h; raises when the host
    has no Python development headers (the shim cannot build)."""
    inc = sysconfig.get_paths().get("include") or ""
    if not os.path.exists(os.path.join(inc, "Python.h")):
        raise RuntimeError(f"the wirepy shim needs Python.h, which is not "
                           f"in {inc!r} (no Python development headers)")
    return inc


def wirepy_library_path() -> str:
    """Where the PyDLL shim lives for the current sources, flags and
    Python headers."""
    inc = f"-I{_python_include()}"
    digest = _digest(WIREPY_SOURCES, (inc,), headers=WIRE_HEADERS)
    return os.path.join(BUILD_DIR, f"libceph_tpu_wirepy-{digest}.so")


def build_wirepy() -> str:
    """Compile the PyDLL shim (wirepath_py.cc, wirepath.cc and crc32c.cc
    against this interpreter's headers) if it is missing; returns its path.
    Python's symbols stay undefined and resolve from the process that loads
    it, as an extension module's do."""
    return _build_once(wirepy_library_path(), WIREPY_SOURCES,
                       "the wirepy shim", f"-I{_python_include()}")


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


def wire_lib() -> ctypes.CDLL:
    """The loaded wire-path library, built on first use."""
    global _WIRE
    with _LOCK:
        if _WIRE is None:
            _WIRE = _configure_wire(ctypes.CDLL(build_wire()))
        return _WIRE


def _configure_wire(so: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the signatures of wirepath.h."""
    pp = ctypes.POINTER(ctypes.c_void_p)
    sp = ctypes.POINTER(ctypes.c_size_t)
    ip = ctypes.POINTER(ctypes.c_int32)
    up = ctypes.POINTER(ctypes.c_uint32)
    so.ceph_tpu_crc32c.restype = ctypes.c_uint32
    so.ceph_tpu_crc32c.argtypes = [
        ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t]
    so.ceph_tpu_wirepath_kind.restype = ctypes.c_char_p
    so.ceph_tpu_wirepath_kind.argtypes = []
    so.ceph_tpu_wire_crc_batch.restype = ctypes.c_int32
    so.ceph_tpu_wire_crc_batch.argtypes = [
        pp, sp, ctypes.c_int32, ip, ctypes.c_int32, up, up]
    so.ceph_tpu_wire_gather.restype = ctypes.c_int64
    so.ceph_tpu_wire_gather.argtypes = [
        pp, sp, ctypes.c_int32, ctypes.c_char_p, ctypes.c_size_t]
    so.ceph_tpu_wire_copy_crc32c.restype = ctypes.c_uint32
    so.ceph_tpu_wire_copy_crc32c.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32]
    so.ceph_tpu_wire_writev.restype = ctypes.c_int64
    so.ceph_tpu_wire_writev.argtypes = [
        ctypes.c_int, pp, sp, ctypes.c_int32, ctypes.c_size_t]
    so.ceph_tpu_wire_scatter.restype = ctypes.c_int32
    so.ceph_tpu_wire_scatter.argtypes = [
        pp, sp, ctypes.c_int32, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_void_p, ctypes.c_size_t, up, ctypes.c_int32, ip]
    so.ceph_tpu_wire_verify_regions.restype = ctypes.c_int32
    so.ceph_tpu_wire_verify_regions.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int64), sp, up, ctypes.c_int32]
    so.ceph_tpu_wirepath_selftest.restype = ctypes.c_int32
    so.ceph_tpu_wirepath_selftest.argtypes = []
    return so


def pylib() -> ctypes.PyDLL:
    """The loaded PyDLL shim, built on first use.  Its entry points run
    with the GIL held on entry and release it around the byte work."""
    global _WIREPY
    with _LOCK:
        if _WIREPY is None:
            so = ctypes.PyDLL(build_wirepy())
            so.ceph_tpu_wirepy_writev.restype = ctypes.c_longlong
            so.ceph_tpu_wirepy_writev.argtypes = [
                ctypes.c_int, ctypes.py_object, ctypes.c_ulonglong]
            so.ceph_tpu_wirepy_crc_chain.restype = ctypes.c_longlong
            so.ceph_tpu_wirepy_crc_chain.argtypes = [
                ctypes.py_object, ctypes.c_uint]
            so.ceph_tpu_wirepy_gather.restype = ctypes.c_longlong
            so.ceph_tpu_wirepy_gather.argtypes = [
                ctypes.py_object, ctypes.py_object]
            so.ceph_tpu_wirepy_verify_regions.restype = ctypes.c_longlong
            so.ceph_tpu_wirepy_verify_regions.argtypes = [
                ctypes.py_object, ctypes.py_object, ctypes.py_object,
                ctypes.py_object]
            so.ceph_tpu_wirepy_scatter_from.restype = ctypes.c_longlong
            so.ceph_tpu_wirepy_scatter_from.argtypes = [
                ctypes.py_object, ctypes.py_object, ctypes.py_object]
            _WIREPY = so
        return _WIREPY


def has_wirepy() -> bool:
    """True once the shim is loaded; builds it on first use, and raises
    (with the compiler's output, or naming the missing Python.h) when it
    cannot be built."""
    return pylib() is not None


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


# -- the wire path (csrc/wirepath.h): the messenger's batch calls ------------
# Segment arguments take bytes, bytearray, a contiguous 1-D memoryview or a
# numpy array.  The caller keeps every segment alive across the call: what
# is passed is the address of the segment's own buffer, nothing is copied.


def crc32c(data, seed: int = 0) -> int:
    """Seedable crc32c through the wire library's own copy (the wire path's
    checksum; the process checksum is utils/checksum.py's, the same
    function of the bytes)."""
    a, n = _seg_addr(data)
    return int(wire_lib().ceph_tpu_crc32c(seed & 0xFFFFFFFF,
                                          ctypes.c_char_p(a), n))


def _seg_addr(s, writable: bool = False) -> tuple:
    """(address, nbytes) of a contiguous byte buffer, zero-copy.  With
    ``writable`` the buffer must be mutable: a destination the C side
    copies into is refused here when it is bytes or a readonly view, as the
    wirepy arm refuses it through PyBUF_WRITABLE."""
    if isinstance(s, bytes):
        if writable:
            raise TypeError("destination buffer is readonly (bytes)")
        if not s:
            return 0, 0
        return ctypes.cast(ctypes.c_char_p(s), ctypes.c_void_p).value, len(s)
    mv = s if isinstance(s, memoryview) else memoryview(s)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    if writable and mv.readonly:
        raise TypeError("destination buffer is readonly")
    if not mv.nbytes:
        return 0, 0
    # np.frombuffer wraps readonly and writable buffers alike; .ctypes.data
    # is the address of the original memory either way
    return int(np.frombuffer(mv, dtype=np.uint8).ctypes.data), mv.nbytes


def _seg_arrays(segs):
    n = len(segs)
    ptrs = (ctypes.c_void_p * n)()
    lens = (ctypes.c_size_t * n)()
    total = 0
    for i, s in enumerate(segs):
        a, ln = _seg_addr(s)
        ptrs[i] = a
        lens[i] = ln
        total += ln
    return ptrs, lens, total


def wirepath_kind() -> str:
    """"native" when the wirepath symbols loaded: the arm gauge that bench
    records and /metrics report."""
    return wire_lib().ceph_tpu_wirepath_kind().decode()


def wirepath_selftest() -> int:
    """The library's own battery of hostile geometries (0 = clean, else
    the failing case's number)."""
    return int(wire_lib().ceph_tpu_wirepath_selftest())


def wire_crc_batch(groups, seeds=None):
    """Chained crc32c of each group of segments in one released-GIL call:
    `groups` is a list of segment lists (a frame's crc sections, a flush
    window's blobs), `seeds` an optional seed a group.  Returns the crcs."""
    flat: list = []
    starts = (ctypes.c_int32 * (len(groups) + 1))()
    for g, segs in enumerate(groups):
        starts[g] = len(flat)
        flat.extend(segs)
    starts[len(groups)] = len(flat)
    ptrs, lens, _ = _seg_arrays(flat)
    out = (ctypes.c_uint32 * len(groups))()
    sd = None
    if seeds is not None:
        sd = (ctypes.c_uint32 * len(groups))(
            *(s & 0xFFFFFFFF for s in seeds))
    rc = wire_lib().ceph_tpu_wire_crc_batch(
        ptrs, lens, len(flat), starts, len(groups), sd, out)
    if rc != 0:
        raise ValueError(f"wire_crc_batch failed ({rc})")
    return list(out)


def wire_gather(segs, out) -> int:
    """Gather segments into the writable buffer ``out``; returns the total
    bytes.  Raises when ``out`` is too small (nothing written)."""
    ptrs, lens, total = _seg_arrays(segs)
    dst, cap = _seg_addr(out, writable=True)
    rc = wire_lib().ceph_tpu_wire_gather(ptrs, lens, len(segs),
                                         ctypes.c_char_p(dst), cap)
    if rc < 0:
        raise ValueError(f"wire_gather failed ({rc}): {total} > {cap}")
    return int(rc)


def wire_copy_crc32c(src, dst, seed: int = 0) -> int:
    """Copy ``src`` into ``dst`` (None: checksum only) and return the crc32c
    of the bytes chained from `seed`, in one released-GIL pass."""
    sa, n = _seg_addr(src)
    da = 0
    if dst is not None:
        da, dn = _seg_addr(dst, writable=True)
        if dn < n:
            raise ValueError(f"wire_copy_crc32c: dst {dn} < src {n}")
    return int(wire_lib().ceph_tpu_wire_copy_crc32c(sa, da, n,
                                                    seed & 0xFFFFFFFF))


def wire_writev(fd: int, segs, skip: int = 0) -> int:
    """writev the segments, less `skip` leading bytes, onto a nonblocking
    fd; partial writes, EINTR and IOV_MAX batches loop natively.  Returns
    the bytes written (0: would block); raises OSError on a hard error."""
    ptrs, lens, _ = _seg_arrays(segs)
    rc = wire_lib().ceph_tpu_wire_writev(fd, ptrs, lens, len(segs), skip)
    if rc < 0:
        err = int(-rc)
        raise OSError(err, os.strerror(err))
    return int(rc)


def wire_verify_regions(base, offs, lens, wants) -> int:
    """Verify the crc32c of regions of one buffer (the rx backlog): region
    i is base[offs[i]:offs[i] + lens[i]] and must checksum to wants[i].
    Returns -1 when every region matches, else the first index that does
    not; raises on out-of-bounds geometry."""
    ba, blen = _seg_addr(base)
    n = len(offs)
    rc = wire_lib().ceph_tpu_wire_verify_regions(
        ba, blen, (ctypes.c_int64 * n)(*offs),
        (ctypes.c_size_t * n)(*lens),
        (ctypes.c_uint32 * n)(*(w & 0xFFFFFFFF for w in wants)), n)
    if rc < -1:
        raise ValueError(f"wire_verify_regions bad geometry ({rc})")
    return int(rc)


def wire_scatter(srcs, offs, dst, want_crcs=None) -> tuple:
    """Copy fragments into ``dst`` at ``offs``, refusing out-of-bounds or
    overlapping geometry, with an optional crc32c a fragment checked over
    the source before any copy.  Returns (rc, bad_idx): rc == len(srcs) on
    success, else -22 (geometry) or -74 (crc) with bad_idx the fragment
    refused."""
    n = len(srcs)
    ptrs, lens, _ = _seg_arrays(srcs)
    o = (ctypes.c_int64 * n)(*offs)
    da, dlen = _seg_addr(dst, writable=True)
    crcs = None
    if want_crcs is not None:
        crcs = (ctypes.c_uint32 * n)(*(c & 0xFFFFFFFF for c in want_crcs))
    bad = ctypes.c_int32(-1)
    rc = wire_lib().ceph_tpu_wire_scatter(
        ptrs, lens, n, o, da, dlen, crcs,
        1 if want_crcs is not None else 0, ctypes.byref(bad))
    return int(rc), int(bad.value)


# -- wirepy: the PyDLL shim (csrc/wirepath_py.cc) ----------------------------
# The shim walks a Python LIST of buffers itself (PyObject_GetBuffer, about
# 100 ns a segment with the GIL held) and releases the GIL around the byte
# work: building pointer arrays in ctypes costs more than the syscall they
# feed, so the tx hot loop's one call a flush window goes through here.


def wirepy_writev(fd: int, segs, skip: int = 0) -> int:
    """writev a LIST of buffers onto a nonblocking fd in one call.
    Returns the bytes written (0: would block); raises OSError on a hard
    socket error."""
    rc = pylib().ceph_tpu_wirepy_writev(fd, segs, skip)
    if rc < 0:
        err = int(-rc)
        raise OSError(err, os.strerror(err))
    return int(rc)


def wirepy_crc_chain(segs, seed: int = 0) -> int:
    """Chained crc32c over a LIST of buffers in one call."""
    rc = pylib().ceph_tpu_wirepy_crc_chain(segs, seed & 0xFFFFFFFF)
    if rc < 0:
        raise ValueError(f"wirepy_crc_chain failed ({rc})")
    return int(rc)


def wirepy_gather(segs, out) -> int:
    """Gather a LIST of buffers into writable ``out`` in one call; returns
    the total bytes, raises when ``out`` is too small or readonly."""
    rc = pylib().ceph_tpu_wirepy_gather(segs, out)
    if rc < 0:
        raise ValueError(f"wirepy_gather failed ({rc})")
    return int(rc)


def wirepy_verify_regions(base, offs, lens, wants) -> int:
    """wire_verify_regions with the geometry as plain int LISTS (walked in
    C, no ctypes arrays built).  Returns -1 when every region matches, else
    the first index that does not; raises on out-of-bounds geometry."""
    rc = pylib().ceph_tpu_wirepy_verify_regions(base, offs, lens, wants)
    if rc < -1:
        raise ValueError(f"wirepy_verify_regions bad geometry ({rc})")
    return int(rc)


def wirepy_scatter_from(base, soffs, dsts) -> int:
    """Fill each writable buffer dsts[i] (its own length) from
    base[soffs[i]:], bounds checked before any byte moves; returns the
    total bytes copied, raises on bad geometry."""
    rc = pylib().ceph_tpu_wirepy_scatter_from(base, soffs, dsts)
    if rc < 0:
        raise ValueError(f"wirepy_scatter_from bad geometry ({rc})")
    return int(rc)
