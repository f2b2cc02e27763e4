"""Process-wide wirepath resolver, python arm only.

Counterpart of ceph_tpu/utils/wirepath.py at commit 4ac5bd2.  The reference
resolves a native messenger hot loop (native/wirepath.cc through its ctypes
bridge) when the native layer builds, and the pure-Python arm otherwise;
both arms put the same bytes on the wire.  The port has not got the native
wirepath yet, so every messenger runs the python arm: ``impl()`` is None,
``kind()`` is "python", and the messenger's ``wirepath_kind`` gauge reads 0.
The surface is the reference's, so the messenger and the reactor workers
branch on it exactly as they do there.
"""

from __future__ import annotations


def impl():
    """The native wirepath module when it resolved; the port has none, so
    always None (the messenger's pure-python arm)."""
    return None


def kind() -> str:
    """"native" | "python" — the arm this process resolved; always
    "python" in the port."""
    return "python"


def _reset_for_tests() -> None:
    """The reference drops its cached resolution here; the port caches
    nothing."""
