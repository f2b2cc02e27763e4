"""Process-wide wirepath resolver: the native messenger hot loop
(csrc/wirepath.cc and the wirepy shim, through native/bridge.py) or the
pure-Python arm.

Counterpart of ceph_tpu/utils/wirepath.py at commit d2d1706.  Under the
GIL, frame crc, fragment copies and writev segment assembly serialise every
reactor thread; the native wirepath batches that per-byte work into single
foreign calls that release the GIL, so a flush window's writev, a burst's
crc verify and a striped blob's scatter each cost one call instead of N
interpreter iterations.  Both arms put the same bytes on the wire.

Resolution happens once per process: every entry point is probed against
the python arm, and so is the library's selftest; ``kind()`` says which arm
runs, for bench records and /metrics.  The python arm is reached in two
ways only: ``CEPH_TPU_WIREPATH=0`` process-wide, and the messenger option
``ms_wirepath_native: False`` per daemon.  One difference from the
reference is deliberate: a native arm that fails to build, load or pass
its probe raises (with the compiler's output or the probe that failed)
where the reference logs a warning and runs the python arm, as the port's
native GF core raises for the codecs.

Under the process-sharded reactor plane (``ms_reactor_mode=process``),
ReactorProcessWorker.start() resolves the arm in the parent before it
forks, so each worker inherits a loaded, probed library and never builds
one of its own.

The native arm engages only when the process checksum resolved crc32c
(``checksum.checksum_kind() == "crc32c"``): the wirepath's crc entry points
compute crc32c, and a host on zlib must keep zlib frames.
"""

from __future__ import annotations

import os
from typing import Optional

_IMPL = None  # the bridge module when the native arm resolved
_KIND: Optional[str] = None


def _probe(bridge) -> None:
    """Hold every entry point of the native arm against the python arm on
    one probe buffer; raises RuntimeError naming the first that differs."""
    from ceph_tpu_torch.utils import checksum

    def need(ok, what: str) -> None:
        if not ok:
            raise RuntimeError(f"native wirepath probe failed: {what}")

    need(bridge.wirepath_kind() == "native", "wirepath symbols missing")
    probe = b"wirepath-probe-0123456789abcdef" * 8
    want = checksum.checksum(probe)
    head, tail = checksum.checksum(probe[:16]), checksum.checksum(probe[16:])
    need(bridge.crc32c(probe) == want, "crc32c")
    need(bridge.wire_crc_batch([[probe[:31], probe[31:]]]) == [want],
         "wire_crc_batch")
    out = bytearray(len(probe))
    need(bridge.wire_gather([probe[:7], probe[7:]], out) == len(probe)
         and bytes(out) == probe, "wire_gather")
    dst = bytearray(len(probe))
    need(bridge.wire_copy_crc32c(probe, dst) == want and bytes(dst) == probe,
         "wire_copy_crc32c")
    dst = bytearray(len(probe))
    rc, _bad = bridge.wire_scatter([probe[16:], probe[:16]], [16, 0], dst,
                                   want_crcs=[tail, head])
    need(rc == 2 and bytes(dst) == probe, "wire_scatter")
    need(bridge.wire_verify_regions(probe, [0, 16], [16, len(probe) - 16],
                                    [head, tail]) == -1,
         "wire_verify_regions")
    need(bridge.wirepath_selftest() == 0, "wirepath selftest")
    # the shim carries the tx hot loop's segment-list parsing: the native
    # arm is both libraries or neither, never a half-native mix
    need(bridge.has_wirepy(), "wirepy shim unavailable")
    need(bridge.wirepy_crc_chain([probe[:5], probe[5:]]) == want,
         "wirepy_crc_chain")
    out = bytearray(len(probe))
    need(bridge.wirepy_gather([probe[:9], probe[9:]], out) == len(probe)
         and bytes(out) == probe, "wirepy_gather")
    need(bridge.wirepy_verify_regions(probe, [0, 16], [16, len(probe) - 16],
                                      [head, tail]) == -1,
         "wirepy_verify_regions")
    d1, d2 = bytearray(16), bytearray(len(probe) - 16)
    need(bridge.wirepy_scatter_from(probe, [16, 0], [d2, d1]) == len(probe)
         and bytes(d1) == probe[:16] and bytes(d2) == probe[16:],
         "wirepy_scatter_from")


def _resolve() -> None:
    global _IMPL, _KIND
    if os.environ.get("CEPH_TPU_WIREPATH", "") == "0":
        _IMPL, _KIND = None, "python"
        return
    from ceph_tpu_torch.utils import checksum

    if checksum.checksum_kind() != "crc32c":
        _IMPL, _KIND = None, "python"
        return
    from ceph_tpu_torch.native import bridge

    # a build, load or probe failure raises: nothing is cached, so the next
    # caller tries again and raises again
    _probe(bridge)
    _IMPL, _KIND = bridge, "native"


def impl():
    """The bridge module when the native wirepath resolved, else None (the
    python arm): messengers branch on this once a connection, never a
    byte.  The first call may build the native libraries (seconds of g++):
    daemons resolve at construction, as they do checksum_kind()."""
    if _KIND is None:
        _resolve()
    return _IMPL


def kind() -> str:
    """"native" | "python": the arm this process resolved (bench's
    ``wirepath_kind``, checksum.checksum_kind's sibling)."""
    if _KIND is None:
        _resolve()
    return _KIND  # type: ignore[return-value]


def _reset_for_tests() -> None:
    """Drop the cached resolution, so that tests can exercise the
    CEPH_TPU_WIREPATH knob without a subprocess."""
    global _IMPL, _KIND
    _IMPL, _KIND = None, None
