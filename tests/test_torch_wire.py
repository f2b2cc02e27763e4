"""The port's wire format and checksums against ceph_tpu's.

Every archived frame of ``corpus/wire/`` decodes with the port's messenger
(its copy of ``rados/types.py`` registers the message set) to the archived
field values, and re-encodes to the same frame bytes, as
tests/test_wire_corpus.py checks for the reference through
ceph_tpu/tools/wire_corpus.py.  The port's checksum (its own crc32c build)
equals the reference's on seeded buffers and seeds, and HashInfo chains and
encodes identically in both packages.
"""

import json
import os
import struct

import numpy as np
import pytest

from ceph_tpu.rados.ecutil import HashInfo as RefHashInfo
from ceph_tpu.tools import wire_corpus
from ceph_tpu.utils import checksum as ref_checksum
from ceph_tpu.utils import wirepath as ref_wirepath
from ceph_tpu_torch.rados import types  # registers the message set
from ceph_tpu_torch.rados.ecutil import HashInfo
from ceph_tpu_torch.rados.messenger import decode_message, encode_payload_parts
from ceph_tpu_torch.utils import checksum, wirepath

FRAMES = sorted(n for n in os.listdir(wire_corpus.CORPUS_DIR)
                if n.endswith(".frame"))


def split_frame(raw):
    type_id, version, fixed, plen = wire_corpus._FRAME_HDR.unpack_from(raw, 0)
    off = wire_corpus._FRAME_HDR.size
    payload = raw[off:off + plen]
    off += plen
    (blen,) = struct.unpack_from("<I", raw, off)
    blob = raw[off + 4:off + 4 + blen] if blen else None
    return type_id, version, bool(fixed), payload, blob


def test_corpus_covers_the_core_message_set():
    assert len({n.split(".")[0] for n in FRAMES}) >= 50


@pytest.mark.parametrize("name", FRAMES)
def test_corpus_frame_round_trips_through_port(name):
    path = os.path.join(wire_corpus.CORPUS_DIR, name)
    with open(path, "rb") as f:
        raw = f.read()
    with open(path[:-len(".frame")] + ".json") as f:
        meta = json.load(f)
    type_id, version, fixed, payload, blob = split_frame(raw)
    msg = decode_message(type_id, version, payload, blob, fixed)
    assert type(msg).__module__.startswith("ceph_tpu_torch.")
    assert type(msg).__name__ == meta["type"]
    got = {k: wire_corpus._norm(v) for k, v in msg.__dict__.items()}
    assert got == meta["fields"]
    payload2, blob2, fixed2 = encode_payload_parts(msg)
    blob2 = b"" if blob2 is None else bytes(blob2)
    frame = (wire_corpus._FRAME_HDR.pack(type(msg).TYPE_ID, type(msg).VERSION,
                                         1 if fixed2 else 0, len(payload2))
             + bytes(payload2) + struct.pack("<I", len(blob2)) + blob2)
    assert frame == raw


GOLDEN_DIR = os.path.join(wire_corpus.CORPUS_DIR, "golden")
# frames archived by older builds.  One (an MMapReply) pickles the
# reference's OSDMap by its class path, ceph_tpu.rados.types: the port's
# unpickler (rados/unpickle.py) reads it as ceph_tpu_torch.rados.types.
GOLDEN = sorted(n for n in os.listdir(GOLDEN_DIR) if n.endswith(".frame"))


@pytest.mark.parametrize("name", GOLDEN)
def test_golden_old_frame_decodes_through_port(name):
    with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
        type_id, version, fixed, payload, blob = split_frame(f.read())
    msg = decode_message(type_id, version, payload, blob, fixed)
    assert type(msg).__name__ == name.split(".")[0]
    for value in msg.__dict__.values():
        assert not type(value).__module__.startswith("ceph_tpu."), value


def test_reference_class_paths_unpickle_to_the_port():
    """A reference frame's typed field decodes into the port's class."""
    frames = [n for n in GOLDEN if b"ceph_tpu." in
              open(os.path.join(GOLDEN_DIR, n), "rb").read()]
    assert frames  # the MMapReply frame
    for name in frames:
        with open(os.path.join(GOLDEN_DIR, name), "rb") as f:
            type_id, version, fixed, payload, blob = split_frame(f.read())
        msg = decode_message(type_id, version, payload, blob, fixed)
        assert type(msg.osdmap) is types.OSDMap


def test_checksum_kind_is_crc32c_on_both():
    assert checksum.checksum_kind() == "crc32c"
    assert ref_checksum.checksum_kind() == "crc32c"
    assert wirepath.kind() == "native" and wirepath.impl() is not None
    assert ref_wirepath.kind() == "native"


def test_checksum_matches_reference():
    rng = np.random.default_rng(20)
    for n in (0, 1, 7, 64, 4095, 4096, 100_003, 1 << 20):
        buf = rng.integers(0, 256, n, dtype=np.uint8)
        seed = int(rng.integers(0, 1 << 32))
        for data in (buf.tobytes(), bytearray(buf.tobytes()),
                     memoryview(buf), buf):
            assert checksum.checksum(data) == ref_checksum.checksum(data)
            assert checksum.checksum(data, seed) == \
                ref_checksum.checksum(data, seed)
        assert checksum.verify_any(buf.tobytes(),
                                   ref_checksum.checksum(buf.tobytes()))
        assert checksum._crc32c_py(buf.tobytes()[:4096], seed) == \
            ref_checksum.checksum(buf.tobytes()[:4096], seed)


def test_hashinfo_matches_reference():
    rng = np.random.default_rng(21)
    port, ref = HashInfo(6), RefHashInfo(6)
    for _ in range(3):  # chained appends
        chunks = {s: rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
                  for s in range(6)}
        port.append(chunks)
        ref.append(chunks)
    assert port.encode() == ref.encode()
    assert HashInfo.decode(ref.encode()).encode() == ref.encode()
    dirty = HashInfo(6, 4096, [1, 2, 3, 4, 5, 6], dirty=True)
    assert dirty.encode() == RefHashInfo(6, 4096, [1, 2, 3, 4, 5, 6],
                                         dirty=True).encode()



def test_reference_stores_read_back_through_the_port(tmp_path):
    """A BlueStore written by ceph_tpu (its onodes pickle
    ceph_tpu.rados.bluestore._Onode) opens and reads in the port, and a
    reference PG log entry decodes as the port's."""
    from ceph_tpu.rados.bluestore import BlueStore as RefBlueStore
    from ceph_tpu.rados.pglog import LogEntry as RefLogEntry
    from ceph_tpu.rados.store import ShardMeta as RefShardMeta
    from ceph_tpu.rados.store import Transaction as RefTransaction
    from ceph_tpu_torch.rados import bluestore
    from ceph_tpu_torch.rados.bluestore import BlueStore
    from ceph_tpu_torch.rados.pglog import LogEntry

    ref = RefBlueStore(str(tmp_path / "osd"))
    txn = RefTransaction()
    data = np.random.default_rng(22).integers(0, 256, 70_000,
                                              dtype=np.uint8).tobytes()
    txn.write((1, "obj", 0), data, RefShardMeta(version=5,
                                                object_size=len(data)))
    ref.queue_transaction(txn)
    ref.close()
    store = BlueStore(str(tmp_path / "osd"))
    try:
        # the onode is the port's class, though ceph_tpu is importable here
        assert all(type(o) is bluestore._Onode for o in store._onodes.values())
        got = store.read((1, "obj", 0))
        assert got is not None and bytes(got[0]) == data
        assert (got[1].version, got[1].object_size) == (5, len(data))
    finally:
        store.close()
    entry = RefLogEntry(version=(3, 7), op="write", oid="o", reqid="r")
    back = LogEntry.decode(entry.encode())
    assert type(back) is LogEntry and back.__dict__ == entry.__dict__
