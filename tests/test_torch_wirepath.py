"""The port's native wire path against ceph_tpu's.

Every ``wire_*`` and ``wirepy_*`` entry point of ceph_tpu_torch.native.bridge
returns what ceph_tpu.native.bridge returns on the same inputs, result and
return code alike: the archived frames of ``corpus/wire/`` cut into awkward
segments, and the hostile geometries of tests/test_native.py (overlap, out
of bounds, a negative offset, a crc mismatch, an undersized or readonly
destination).  The port's library passes its own selftest.  Its messengers
dispatch the same messages exactly once and in order on both arms under
injected socket failures and duplicated frames, over one connection and over
three lanes (tests/test_messenger.py::TestWirepathParity and
tests/test_wire_plane.py::TestWirepathLaneParity on the port), and the two
knobs that force the python arm force it.  A native arm that fails its probe
raises, where the reference falls back to the python arm.
"""

import asyncio
import hashlib
import os

import pytest

from ceph_tpu.native import bridge as ref_bridge
from ceph_tpu.utils import wirepath as ref_wirepath
from ceph_tpu_torch.native import bridge
from ceph_tpu_torch.rados.messenger import Messenger, message
from ceph_tpu_torch.utils import checksum, wirepath

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_WIRE = os.path.join(ROOT, "corpus", "wire")
FRAMES = sorted(n for n in os.listdir(CORPUS_WIRE)
                if n.endswith(".frame"))[:12]


@message(9811)
class MWirepathTest:
    seqno: int = 0
    blob: bytes = b""


@message(9812)
class MWirepathLane:
    seq: int = 0
    kind: str = "a"
    data: bytes = b""
    gseq: int = 0


# striped across lanes, as the data-plane messages are declared
MWirepathLane.LANE_STRIPE = True
MWirepathLane.BLOB_ATTR = "data"
MWirepathLane.BLOB_VIEW_OK = True
MWirepathLane.FIXED_FIELDS = [("seq", "q"), ("kind", "s"), ("data", "y"),
                              ("gseq", "Q")]


def both(fn, *args, **kw):
    """fn on the port's bridge and on the reference's: (result, error type)
    of each, asserted equal; returns the port's result."""
    got = []
    for b in (bridge, ref_bridge):
        try:
            got.append((getattr(b, fn)(*args, **kw), None))
        except Exception as e:  # the error type is part of the contract
            got.append((None, type(e)))
    assert got[0] == got[1], (fn, got)
    return got[0][0]


def test_both_resolve_the_native_arm():
    assert wirepath.kind() == "native" and wirepath.impl() is bridge
    assert ref_wirepath.kind() == "native"
    assert bridge.wirepath_kind() == ref_bridge.wirepath_kind() == "native"
    assert bridge.wirepath_selftest() == 0
    assert bridge.has_wirepy()


@pytest.mark.parametrize("name", FRAMES)
def test_corpus_frame_in_awkward_segments(name):
    with open(os.path.join(CORPUS_WIRE, name), "rb") as f:
        raw = f.read()
    cut1, cut2 = max(1, len(raw) // 3), max(2, (2 * len(raw)) // 3)
    segs = [raw[:cut1], bytearray(raw[cut1:cut2]), memoryview(raw)[cut2:],
            b""]
    py_crc = 0  # the python arm: one crc call a segment
    for s in segs:
        py_crc = checksum.checksum(s, py_crc)
    assert both("crc32c", raw, 7) == checksum.checksum(raw, 7)
    assert both("wire_crc_batch", [segs, segs[1:]], seeds=[0, 5]) == [
        py_crc, checksum.checksum(raw[cut1:], 5)]
    assert both("wirepy_crc_chain", list(segs)) == py_crc
    assert both("wirepy_crc_chain", list(segs), 9) == \
        checksum.checksum(raw, 9)
    for fn in ("wire_gather", "wirepy_gather"):
        outs = []
        for b in (bridge, ref_bridge):
            out = bytearray(len(raw) + 3)
            assert getattr(b, fn)(list(segs), out) == len(raw)
            outs.append(bytes(out))
        assert outs[0] == outs[1] == raw + b"\0\0\0"
    dsts = [bytearray(len(raw)) for _ in range(2)]
    crcs = [b.wire_copy_crc32c(raw, d, 3)
            for b, d in zip((bridge, ref_bridge), dsts)]
    assert crcs[0] == crcs[1] == checksum.checksum(raw, 3)
    assert bytes(dsts[0]) == bytes(dsts[1]) == raw
    assert both("wire_copy_crc32c", raw, None) == checksum.checksum(raw)
    offs = [0, cut1, cut2]
    lens = [cut1, cut2 - cut1, len(raw) - cut2]
    wants = [checksum.checksum(raw[o:o + n]) for o, n in zip(offs, lens)]
    assert both("wire_verify_regions", raw, offs, lens, wants) == -1
    assert both("wirepy_verify_regions", raw, offs, lens, wants) == -1
    wants[1] ^= 1
    assert both("wire_verify_regions", raw, offs, lens, wants) == 1
    assert both("wirepy_verify_regions", raw, offs, lens, wants) == 1
    # reassembly out of offset order, through the guarded scatter
    backs = []
    for b in (bridge, ref_bridge):
        back = bytearray(len(raw))
        assert b.wire_scatter(
            [segs[2], segs[0], segs[1]], [cut2, 0, cut1], back,
            want_crcs=[checksum.checksum(s)
                       for s in (segs[2], segs[0], segs[1])]) == (3, -1)
        backs.append(bytes(back))
    assert backs[0] == backs[1] == raw
    parts = []
    for b in (bridge, ref_bridge):
        out = [bytearray(n) for n in lens]
        assert b.wirepy_scatter_from(raw, offs, out) == len(raw)
        parts.append(b"".join(bytes(p) for p in out))
    assert parts[0] == parts[1] == raw


def test_writev_over_a_socket_pair():
    import socket

    payload = [os.urandom(n) for n in (1, 4096, 0, 70_001, 13)]
    joined = b"".join(payload)
    for fn in ("wire_writev", "wirepy_writev"):
        for skip in (0, 5000):
            got = []
            for b in (bridge, ref_bridge):
                a, z = socket.socketpair()
                try:
                    a.setblocking(False)
                    sent = 0
                    buf = b""
                    while sent < len(joined) - skip:
                        sent += getattr(b, fn)(a.fileno(), payload,
                                               skip + sent)
                        buf += z.recv(1 << 20)
                    while len(buf) < len(joined) - skip:
                        buf += z.recv(1 << 20)
                    got.append(buf)
                finally:
                    a.close()
                    z.close()
            assert got[0] == got[1] == joined[skip:]
    for fn in ("wire_writev", "wirepy_writev"):
        for b in (bridge, ref_bridge):
            with pytest.raises(OSError):  # EBADF: no such descriptor
                getattr(b, fn)(1 << 20, [b"x"])


def test_hostile_geometry_refused_alike():
    data = bytes(range(256)) * 16
    # overlap within one batch, an out-of-bounds tail, a negative offset
    for srcs, offs in (([data[:2048], data[:2048]], [0, 1024]),
                       ([data], [len(data) - 100]),
                       ([data[:16]], [-1])):
        got = [b.wire_scatter(srcs, offs, bytearray(len(data)))
               for b in (bridge, ref_bridge)]
        assert got[0] == got[1] and got[0][0] == -22
    # a crc mismatch refuses before the copy
    marks = [bytearray(b"\x55" * len(data)) for _ in range(2)]
    got = [b.wire_scatter([data], [0], m,
                          want_crcs=[checksum.checksum(data) ^ 1])
           for b, m in zip((bridge, ref_bridge), marks)]
    assert got[0] == got[1] == (-74, 0)
    assert bytes(marks[0]) == bytes(marks[1]) == b"\x55" * len(data)
    # an undersized or readonly destination, regions past the buffer
    ro = bytes(len(data))
    for fn, args in (("wire_gather", ([data], bytearray(len(data) - 1))),
                     ("wirepy_gather", ([data], bytearray(len(data) - 1))),
                     ("wire_scatter", ([data[:16]], [0], ro)),
                     ("wire_gather", ([data[:16]], ro)),
                     ("wire_copy_crc32c", (data[:16], ro)),
                     ("wire_copy_crc32c", (data, bytearray(8))),
                     ("wirepy_gather", ([data[:16]], ro)),
                     ("wirepy_scatter_from", (data, [0], [ro[:16]])),
                     ("wire_verify_regions", (data, [len(data) - 8], [64],
                                              [0])),
                     ("wirepy_verify_regions", (data, [len(data) - 8], [64],
                                                [0])),
                     ("wirepy_scatter_from", (data, [len(data) - 8],
                                              [bytearray(64)]))):
        errors = []
        for b in (bridge, ref_bridge):
            with pytest.raises((ValueError, TypeError)) as e:
                getattr(b, fn)(*args)
            errors.append(e.type)
        assert errors[0] is errors[1], fn


def test_a_failed_probe_raises(monkeypatch):
    monkeypatch.setattr(bridge, "wirepath_selftest", lambda: 7)
    wirepath._reset_for_tests()
    try:
        with pytest.raises(RuntimeError, match="wirepath selftest"):
            wirepath.kind()
        with pytest.raises(RuntimeError, match="wirepath selftest"):
            Messenger("probe", {})  # a daemon raises at construction
    finally:
        monkeypatch.undo()
        wirepath._reset_for_tests()
    assert wirepath.kind() == "native"


def test_env_knob_forces_python_arm(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_WIREPATH", "0")
    wirepath._reset_for_tests()
    try:
        assert wirepath.kind() == "python" and wirepath.impl() is None
        m = Messenger("knob", {"ms_wirepath_native": True})
        assert m.wirepath is None
        assert m.perf.dump()["wirepath_kind"] == 0
    finally:
        monkeypatch.delenv("CEPH_TPU_WIREPATH")
        wirepath._reset_for_tests()


def test_config_knob_forces_python_arm():
    off = Messenger("off", {"ms_wirepath_native": False})
    assert off.wirepath is None and off.perf.dump()["wirepath_kind"] == 0
    on = Messenger("on", {})
    assert on.wirepath is bridge and on.perf.dump()["wirepath_kind"] == 1


N_ONE = 48


def _one_connection(native: bool):
    async def go():
        conf = {"ms_wirepath_native": native,
                "ms_inject_socket_failures": 9, "ms_inject_dup_frames": 5}
        server = Messenger("server", dict(conf), entity_type="osd")
        client = Messenger("client", dict(conf), entity_type="osd")
        addr = await server.bind()
        got = []

        async def dispatch(conn, msg):
            got.append((msg.seqno, bytes(msg.blob)))

        server.dispatcher = dispatch
        for i in range(N_ONE):
            blob = bytes([(i * 7 + j) & 0xFF
                          for j in range(512)]) * (1 + i % 3)
            await client.send(addr, MWirepathTest(seqno=i, blob=blob),
                              retries=10)
        for _ in range(200):
            if len({s for s, _ in got}) == N_ONE:
                break
            await asyncio.sleep(0.05)
        tx = client.perf.dump()["native_tx_calls"]
        kinds = (client.perf.dump()["wirepath_kind"],
                 server.perf.dump()["wirepath_kind"])
        await client.shutdown()
        await server.shutdown()
        return got, tx, kinds

    return asyncio.run(go())


N_LANES = 30


def _three_lanes(native: bool):
    async def go():
        conf = {"ms_lanes_per_peer": 3, "ms_wirepath_native": native,
                "ms_inject_socket_failures": 25, "ms_inject_dup_frames": 6}
        a = Messenger("a", dict(conf))
        b = Messenger("b", dict(conf), entity_type="osd")
        await a.bind()
        addr_b = tuple(await b.bind())
        got = []
        done = asyncio.Event()

        async def disp(conn, msg):
            got.append((msg.seq, hashlib.sha256(bytes(msg.data)).hexdigest()))
            if len(got) >= N_LANES:
                done.set()

        b.dispatcher = disp
        for i in range(N_LANES):
            # sizes straddle the fragmentation threshold: some messages
            # stripe across the lanes and some ride whole
            data = bytes([(i * 11 + j) & 0xFF
                          for j in range(256)]) * (1 + (i % 5) * 120)
            await a.send(addr_b, MWirepathLane(seq=i, data=data))
        await asyncio.wait_for(done.wait(), 60)
        tx = (a.perf.dump()["native_tx_calls"]
              + b.perf.dump()["native_tx_calls"])
        await a.shutdown()
        await b.shutdown()
        return got, tx, None

    return asyncio.run(go())


@pytest.mark.parametrize("drive,want", [
    (_one_connection,
     [(i, bytes([(i * 7 + j) & 0xFF for j in range(512)]) * (1 + i % 3))
      for i in range(N_ONE)]),
    (_three_lanes,
     [(i, hashlib.sha256(bytes([(i * 11 + j) & 0xFF for j in range(256)])
                         * (1 + (i % 5) * 120)).hexdigest())
      for i in range(N_LANES)]),
], ids=["one_connection", "three_lanes"])
def test_arms_dispatch_identically(drive, want):
    native_got, native_tx, native_kinds = drive(True)
    python_got, python_tx, python_kinds = drive(False)
    # exactly once, in order, the same bytes, on both arms
    assert native_got == want
    assert python_got == want
    assert native_tx > 0  # the native arm ran native
    assert python_tx == 0  # the forced python arm stayed python
    if native_kinds is not None:
        assert native_kinds == (1, 1) and python_kinds == (0, 0)
