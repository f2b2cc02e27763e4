"""Process-wide data checksum: hardware CRC32C when the port's own crc32c
library builds (``utils/csrc/crc32c.cc``, SSE4.2), zlib.crc32 otherwise.

Counterpart of ceph_tpu/utils/checksum.py at commit 4ac5bd2, with the same
contract (``checksum``, ``checksum_kind``, ``verify_any``, the same warning
on the zlib fallback).  The reference resolves crc32c through its native
bridge; the port keeps its own copy of that one source file and builds it
with ``g++`` at first use into ``ceph_tpu_torch/_build/`` under a name that
carries a hash of the source and flags (as ``ops/build.py`` does for
``nvcc``), then loads it with ctypes.  Every internal checksum site
(messenger frames, shard crcs, HashInfo chains, BlueStore extents, KV WAL
records) resolves through this one seedable function, so the port's chains
equal the reference's wherever both resolve crc32c."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import zlib

_IMPL = None
_KIND = None
_LIB = None
_LOCK = threading.Lock()

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "utils", "csrc", "crc32c.cc")
_BUILD_DIR = os.path.join(_PKG_DIR, "_build")
_FLAGS = ["-std=c++17", "-O3", "-march=native", "-fPIC", "-shared"]


def library_path() -> str:
    """Where the crc32c library lives for the current source and flags."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libcrc32c-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the crc32c library if it is missing; returns its path."""
    target = library_path()
    if not os.path.exists(target):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{target}.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *_FLAGS, "-o", tmp, _SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for crc32c.cc "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, target)  # atomic: a concurrent build sees no partial file
    return target


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            lib.ceph_tpu_crc32c.restype = ctypes.c_uint32
            lib.ceph_tpu_crc32c.argtypes = [
                ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t]
            lib.ceph_tpu_crc32c_kind.restype = ctypes.c_char_p
            lib.ceph_tpu_crc32c_kind.argtypes = []
            _LIB = lib
        return _LIB


def _buf_arg(data):
    """Zero-copy ctypes argument for any contiguous buffer: bytes pass
    through; bytearray/writable memoryview wrap via from_buffer (a c_char
    array is accepted where c_char_p is declared); anything else copies."""
    if isinstance(data, bytes):
        return data
    if isinstance(data, bytearray):
        return (ctypes.c_char * len(data)).from_buffer(data)
    if isinstance(data, memoryview):
        if not data.contiguous:
            return bytes(data)
        if data.readonly:
            obj = getattr(data, "obj", None)
            if isinstance(obj, bytes) and data.nbytes == len(obj):
                return obj  # whole-bytes view: pass the bytes directly
            return bytes(data)
        return (ctypes.c_char * data.nbytes).from_buffer(data)
    try:
        return _buf_arg(memoryview(data))  # numpy arrays et al.
    except TypeError:
        return bytes(data)


def crc32c(data, seed: int = 0) -> int:
    """Seedable CRC32C through the port's native library."""
    if isinstance(data, (bytes, bytearray)):
        n = len(data)
    else:
        # nbytes, not len(): a 2-D or wider-dtype buffer's len() is its
        # row/element count and would checksum a prefix
        n = memoryview(data).nbytes
    return _lib().ceph_tpu_crc32c(seed, _buf_arg(data), n)


def crc32c_kind() -> str:
    """Which dispatch the native crc takes ("sse4.2" | "table")."""
    return _lib().ceph_tpu_crc32c_kind().decode()


def _resolve() -> None:
    global _IMPL, _KIND
    try:
        crc32c(b"probe")
        _IMPL = crc32c
        _KIND = "crc32c"
    except (OSError, RuntimeError):
        import logging

        logging.getLogger("ceph_tpu_torch.checksum").warning(
            "native crc32c unavailable; falling back to zlib.crc32 "
            "(peers negotiate per connection)")
        _IMPL = zlib.crc32
        _KIND = "zlib"


def checksum(data, seed: int = 0) -> int:
    if _IMPL is None:
        _resolve()
    return _IMPL(data, seed)


def checksum_kind() -> str:
    """Which algorithm this process resolved ("crc32c" | "zlib") — rides
    the messenger handshake so mismatched builds degrade instead of
    rejecting every frame.  Resolving may BUILD the native library
    (about a second of g++): daemons call this at startup, never on a hot
    path."""
    if _KIND is None:
        _resolve()
    return _KIND


_PY_TABLE = None


def _crc32c_py(data, seed: int = 0) -> int:
    """Pure-Python CRC32C (Castagnoli) — recovery/scrub-time verification
    only (slow): lets a build whose native library is gone still VERIFY
    records a crc32c build wrote, so persisted state never reads as torn."""
    global _PY_TABLE
    if _PY_TABLE is None:
        t = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            t.append(c)
        _PY_TABLE = t
    crc = seed ^ 0xFFFFFFFF
    tbl = _PY_TABLE
    for b in bytes(data):
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def verify_any(data, want: int) -> bool:
    """True when `want` matches this data under ANY checksum a build of
    this framework may have written it with (current resolver, zlib,
    crc32c-by-table) — the accept-either discipline for persisted state
    and cross-build wire comparisons; an algorithm change must degrade,
    never masquerade as corruption or a torn tail."""
    want &= 0xFFFFFFFF
    if checksum(data) & 0xFFFFFFFF == want:
        return True
    if zlib.crc32(data) & 0xFFFFFFFF == want:
        return True
    if _KIND != "crc32c" and _crc32c_py(data) == want:
        return True
    return False
