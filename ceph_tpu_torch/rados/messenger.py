# Copy of ceph_tpu/rados/messenger.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.  One seam differs: the rx
# path's install staging takes the daemon's device (osd_ec_device).  Control
# payloads unpickle through rados/unpickle.py.  One repair: the flush loop
# and adopt_transport write segment lists through _writelines, which refuses
# a closing transport (the reference's connections can wedge there).
"""Async messenger: typed messages over an authenticated, crc-guarded,
replay-safe framed TCP protocol.

Role-equivalent of the reference's AsyncMessenger + ProtocolV2 stack
(reference src/msg/async/AsyncMessenger.h:73, ProtocolV2.cc, frames_v2.cc):
every daemon creates one Messenger, registers a Dispatcher, and exchanges
versioned typed messages over ordered per-peer Connections.  The v2-style
connection bring-up is banner -> hello (peer name/type, nonce, session
cookie, requested policy, optional HMAC auth over a shared secret — the
cephx role, src/auth/) -> session.  Data frames carry a crc32 (ms_crc_data
mode) and an optional zlib-compressed payload (compression_onwire.cc role,
ms_compress_min_size).

Policies mirror the reference's (Policy::lossy_client vs lossless_peer),
negotiated at handshake: on a lossless session BOTH sides keep one
long-lived Connection object per peer session — frames are sequenced,
acked, and kept queued until acked; after a transport drop the initiator
reconnects and each side replays its un-acked frames onto the new transport
(the server adopts the new socket into the existing session Connection, the
reference's session-reconnect + out_queue replay, ProtocolV2.cc
reuse_connection) — with receiver-side seq dedupe making dispatch
exactly-once in both directions, the OSD<->OSD guarantee PG consistency is
built on.  Lossy connections just fail and are replaced wholesale.

A config-driven fault injector (reference
src/common/options/global.yaml.in:1240) exercises the failure paths
without code changes: ms_inject_socket_failures severs connections,
ms_inject_delay_max delays sends, and ms_inject_dup_frames delivers
client-op-plane messages twice (two frames, two seqs — duplicates the
receiver's seq dedupe CANNOT filter, proving the application layer's
reqid/pop-once dedup instead).  A dispatch throttle
(ms_dispatch_throttle_bytes) applies receive-side backpressure.

Wire formats, by plane (see README "Wire-format threat model"):
- DATA plane (MOSDOp/MOSDOpReply/ECSub*/MPushShard): fixed binary field
  layouts (FLAG_FIXED; FIXED_FIELDS declared in types.py) — struct-speed
  and incapable of executing code on decode, like the reference's
  fixed-layout dencoder structs.  Bulk bytes ride the zero-copy blob
  lane with their own crc32c.
- CONTROL plane (maps, peering, paxos, config): pickled dataclass
  fields — an internal trusted-cluster format behind cephx-lite auth.
- COLOCATED daemons (ms_local_fastpath): no serialization at all —
  typed messages hand over by reference (Messenger local_connection
  role).
The reference's cross-version dencoder discipline is represented by the
per-type version field checked on decode (and exercised by
tools/dencoder + the wire corpus).

Cork/flush discipline (the corked wire data plane): every Connection owns
an OUTBOX.  ``send()`` frames the message and appends the segments to the
outbox; a single per-connection flusher task drains the outbox with ONE
``writelines`` + ONE ``drain()`` per flush window, so frames queued by
concurrent senders (a k+m stripe fan-out, a burst of sub-write replies)
coalesce into one scatter-gather write instead of paying a
lock/write/drain round-trip each (the reference's ProtocolV2 out_queue +
segment writev).  The flush window is self-clocking: while one window
drains, new frames pile into the next — no added latency for an isolated
send, automatic batching under load.  On plaintext TCP the flusher also
swaps the StreamWriter for a CorkedWriter that ``sendmsg``-writevs the
frame segments STRAIGHT FROM their owning buffers (encode outputs, store
blobs, BufferList pieces) — zero copies between codec and kernel.

Acks are PIGGYBACKED: dispatching a frame queues a cumulative ack
(highest contiguous seq) on the connection instead of writing a
standalone ACK_TYPE frame; the next flush carries one ack frame for the
whole window (acks are cumulative, so the latest seq covers every
earlier one).  An ack-only flush is still written promptly when no data
frames are outbound.  The rx side mirrors the batching: the serve loop
drains every frame ALREADY BUFFERED on the transport into one batch,
dispatches the batch (through ``group_dispatcher`` when the daemon
installs one — the whole-stripe group handoff seam), and acks once.

Lossless-replay interaction: a frame enters the unacked replay queue
BEFORE it enters the outbox, and close() fails the pending flush window
and clears the outbox — un-flushed frames replay from the unacked queue
onto the adopted transport in seq order, and the receiver's dedupe floor
makes any flush/replay overlap exactly-once.

Sharded multi-reactor wire plane (reactor.py + the lane layer here):

- **Reactor pool** (``ms_async_op_threads``): N reactor workers, each a
  thread with its own event loop owning a shard of sockets (reference
  AsyncMessenger worker pool).  Outbound data lanes are bound to workers
  by a stable hash of (peer, lane); inbound sockets shard across the
  workers' dup'd listening fds.  Socket work (framing, crc, sendmsg,
  recv memcpy — all GIL-releasing) runs on the owning reactor; dispatch
  hops back to the daemon's home loop, so daemon state stays
  single-loop.  Each reactor-owned connection charges a per-worker
  dispatch throttle (receive backpressure is per shard).
- **Multi-lane peer striping** (``ms_lanes_per_peer`` > 1, negotiated —
  an old peer that doesn't advertise ``lanes_ok`` gets one lane): a peer
  pair opens N parallel lanes, each a full Connection (own cork/outbox,
  own seq space, own unacked replay queue, own flusher).  Lane 0 is the
  CONTROL lane — pings, acks, maps, backoffs, health are never queued
  behind data.  Data-plane messages (LANE_STRIPE types) are striped
  round-robin across lanes 1..N-1, stamped with a connection-global
  ``gseq``; the receiving LaneGroup reassembles gseq order before
  dispatch, so per-(peer,type) ordering (in fact total data-plane
  order) and the reqid/dedup machinery above are preserved.  Messages
  with blobs >= ``ms_lane_stripe_min`` are FRAGMENTED: the blob splits
  into per-lane MLaneSegment frames sent concurrently and reassembled
  into one buffer on the receiver — one large transfer rides all lanes
  at once.  A dead lane pins and replays only ITS unacked frames
  (per-lane sessions); the remaining lanes keep draining, and the gseq
  reorder buffer absorbs the replayed hole.
- **Colocated ring transport** (``ms_colocated_ring``): the handshake
  hello carries a per-process token; when both ends share the process
  (vstart/test topology, bench loopback arm) the acceptor offers an
  in-process RingPipe pair in its fin and both sides swap the TCP
  session for a zero-serialization ring (BufferList views hand over by
  reference).  Any negotiation failure falls back to TCP transparently.
"""

from __future__ import annotations

import asyncio
import collections
import hashlib
import hmac
import itertools
import json
import os
import pickle
import random
import socket as socket_mod
import struct
import threading
import time
import traceback
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from ceph_tpu_torch.common.perf_counters import PerfCounters, PerfCountersBuilder
from ceph_tpu_torch.common.throttle import Throttle
from ceph_tpu_torch.rados import unpickle
from ceph_tpu_torch.utils import wirepath as _wirepath
from ceph_tpu_torch.rados.reactor import (PROC_TOKEN, ReactorPool, RingConnection,
                                    ring_abandon, ring_claim, ring_offer)
from ceph_tpu_torch.rados.reactor_proc import ShmConnEndpoint, delegate_socket
from ceph_tpu_torch.rados.shm_ring import (FRAME_HDR as _SHM_FRAME_HDR,
                                     REC_EOF as _SHM_REC_EOF,
                                     REC_ERR as _SHM_REC_ERR,
                                     REC_FRAME as _SHM_REC_FRAME,
                                     RF_BLOB as _SHM_RF_BLOB,
                                     RF_FIXED as _SHM_RF_FIXED,
                                     RF_VERIFIED as _SHM_RF_VERIFIED)


def _build_wire_perf() -> PerfCounters:
    """The `wire` counter set — one per Messenger, added to the owning
    daemon's PerfCountersCollection so `perf dump` and the mgr prometheus
    exporter carry the wire-path breakdown the ROADMAP names as the
    reason the device-tier win is invisible over TCP.  COUNTER SCHEMA
    (name -> meaning -> kind):

      tx_msgs / rx_msgs    u64         messages sent / dispatched
      tx_bytes / rx_bytes  u64         frame bytes written / received on
                                       the socket (tx side counts EVERY
                                       write: messages, acks, session
                                       replays)
      tx_framing           longrunavg  encode + frame-build seconds per send
      tx_io                longrunavg  socket write + drain seconds per
                                       write (messages, acks, replays)
      rx_io                longrunavg  payload read seconds per frame
                                       (clock starts AFTER the header
                                       lands, so idle wait between
                                       messages never pollutes it)
      rx_framing           longrunavg  decode_message seconds per dispatch
      local_msgs           u64         colocated-fastpath handoffs (no
                                       framing or socket at all)
      tx_flushes           u64         outbox flush windows written (each is
                                       one writelines + one drain)
      tx_flush_frames      histogram   frames coalesced per flush window
      tx_flush_bytes       histogram   bytes per flush window
      tx_flush_data        u64         windows cut carrying data frames
      tx_flush_ack         u64         ack-only windows (no data pending)
      tx_acks              u64         ack frames written
      tx_acks_coalesced    u64         acks absorbed into a pending ack
                                       (would have been standalone frames)
      tx_crc_reused        u64         blob frames whose wire crc reused an
                                       app-level crc (no recompute pass)
      rx_batches           u64         multi-frame rx batches drained
      rx_batch_msgs        histogram   messages per rx dispatch batch
      wirepath_kind        u64 gauge   1 = native wirepath, 0 = python arm
      native_tx_calls      u64         released-GIL tx wirepath calls
      native_rx_calls      u64         released-GIL rx wirepath calls
      native_bytes         u64         bytes touched by native wirepath
                                       passes (counted once per pass)
      tx_<Type> / rx_<Type>        u64  per-message-type counts (dynamic)
      tx_bytes_<Type> / rx_bytes_<Type>  u64  per-type frame bytes

    framing vs io is the actionable split: framing seconds are Python
    encode cost a scatter-gather/zero-copy PR can remove; io seconds are
    the socket's.  With the corked outbox, tx_io is per FLUSH WINDOW (not
    per message): sum(tx_io)/tx_msgs is the per-message socket cost and
    drops as flush windows batch more frames."""
    b = PerfCountersBuilder("wire")
    b.add_u64_counter("tx_msgs", "messages sent")
    b.add_u64_counter("tx_bytes", "frame bytes sent")
    b.add_u64_counter("rx_msgs", "messages dispatched")
    b.add_u64_counter("rx_bytes", "frame bytes received")
    b.add_time_avg("tx_framing", "encode + frame-build seconds per send")
    b.add_time_avg("tx_io", "socket write + drain seconds per flush window")
    b.add_time_avg("rx_io", "payload read seconds per frame (post-header)")
    b.add_time_avg("rx_framing", "decode seconds per dispatched message")
    b.add_u64_counter("local_msgs", "colocated-fastpath handoffs")
    b.add_u64_counter("tx_flushes", "outbox flush windows written")
    b.add_histogram("tx_flush_frames", "frames coalesced per flush window")
    b.add_histogram("tx_flush_bytes", "bytes per flush window")
    b.add_u64_counter("tx_flush_data", "flush windows carrying data frames")
    b.add_u64_counter("tx_flush_ack", "ack-only flush windows")
    b.add_u64_counter("tx_acks", "ack frames written")
    b.add_u64_counter("tx_acks_coalesced",
                      "acks absorbed into a pending cumulative ack")
    b.add_u64_counter("tx_crc_reused",
                      "blob frames reusing an app-level crc on the wire")
    b.add_u64_counter("rx_batches", "multi-frame rx dispatch batches")
    b.add_histogram("rx_batch_msgs", "messages per rx dispatch batch")
    # multi-lane / reactor / ring plane (module docstring "Sharded
    # multi-reactor wire plane"); per-lane splits ride dynamic
    # tx_lane<k>_msgs / tx_lane<k>_bytes counters
    b.add_u64_counter("ring_msgs", "colocated ring handoffs (no framing, "
                                   "no socket, no serialization)")
    b.add_u64_counter("lane_rx_parked",
                      "striped frames parked awaiting a gseq gap")
    b.add_u64_counter("lane_frag_tx", "lane fragments sent (large blobs "
                                      "split across data lanes)")
    b.add_u64_counter("lane_frag_rx", "lane fragments reassembled")
    b.add_u64_counter("lane_frag_overflow",
                      "fragments refused by the reassembly memory cap")
    b.add_u64_counter("lane_revivals", "dead lanes redialed and replayed")
    # native wirepath (utils/wirepath.py): which arm ran and how much of
    # the per-byte hot loop it carried — wirepath_kind is the arm gauge
    # (1 = native, 0 = python; BENCH records the string alongside)
    b.add_u64("wirepath_kind", "wirepath arm: 1 = native, 0 = python")
    b.add_u64_counter("native_tx_calls",
                      "released-GIL wirepath calls on the tx side "
                      "(whole-window writev, batch blob crc)")
    b.add_u64_counter("native_rx_calls",
                      "released-GIL wirepath calls on the rx side "
                      "(burst crc verify, fused copy+crc, scatter)")
    b.add_u64_counter("native_bytes",
                      "bytes touched by native wirepath passes (each "
                      "pass counts: a byte crc-verified then scattered "
                      "counts once per pass)")
    # µs histograms of the socket-io longrunavgs: tail-latency
    # percentiles (p50/p99/p999) come out of the power-of-2 buckets, so
    # the BENCH record reports wire tx/rx TAILS, not just means
    b.add_histogram("tx_io_us", "socket write+drain µs per flush window")
    b.add_histogram("rx_io_us", "payload read µs per frame")
    # process-sharded reactor plane (ms_reactor_mode=process): the
    # byte-loop counters now live in the WORKER PROCESSES' counter
    # blocks; these proc_* aggregates are refreshed from shared memory
    # at dump time (perf.presample) so `perf dump`, /metrics and BENCH
    # see the whole plane, not just the parent's share.  Values are
    # ABSOLUTE since worker spawn (a perf reset does not zero a worker).
    b.add_u64("proc_workers", "live reactor worker processes")
    b.add_u64("proc_delegated_conns",
              "connections delegated to worker processes (absolute)")
    b.add_u64("proc_rx_frames",
              "frames parsed+verified in worker processes (absolute)")
    b.add_u64("proc_rx_bytes", "frame bytes received by workers (absolute)")
    b.add_u64("proc_tx_calls", "socket write passes by workers (absolute)")
    b.add_u64("proc_tx_bytes", "bytes written by workers (absolute)")
    b.add_u64("proc_native_rx_calls",
              "released-GIL rx wirepath calls in workers (absolute)")
    b.add_u64("proc_native_tx_calls",
              "released-GIL tx wirepath calls in workers (absolute)")
    b.add_u64("proc_native_bytes",
              "bytes touched by worker wirepath passes (absolute)")
    b.add_u64("proc_worker_respawns",
              "worker processes respawned after death (absolute)")
    return b.create_perf_counters()

BANNER = b"ceph_tpu msgr v2\n"
_HDR = struct.Struct("<IHHBIQ")  # len, type, version, flags, crc, seq

# blob-frame payload prefix: pickled length + blob checksum
_BLOB_PFX = struct.Struct("<II")

FLAG_COMPRESSED = 1
# FLAG_FIXED: the payload (or the header part of a blob frame) is the
# class's FIXED_FIELDS binary layout, not pickle — the data-plane
# framing discipline (reference fixed-layout dencoder encode for
# MOSDOp/ECSubWrite wire structs, src/osd/ECMsgTypes.h encode_payload):
# nothing on the hot path can execute code on decode, and field packing
# is struct-speed.  Control-plane types keep pickle (internal
# trusted-cluster format; see module docstring).
FLAG_FIXED = 4
# FLAG_BLOB: payload = [u32 plen][u32 blob_crc][pickled(plen)][blob].
# The large binary field of a message (MOSDOp.data, MECSubWrite.chunk, ...)
# rides OUT OF BAND from the pickle: the sender never copies it into a
# serialized buffer (scatter-gather writev via writer.writelines), the
# header crc covers only the small pickled part, and the blob's own
# hardware crc32c protects the bulk bytes — the zero-copy framing half of
# the reference's bufferlist-based wire path (src/msg/async/ProtocolV2.cc
# segments + crc sections role).
FLAG_BLOB = 2
# only bulk payloads are worth the second checksum + reattach bookkeeping
BLOB_MIN = 16 * 1024

ACK_TYPE = 0xFFF0  # control frame: payload is the acked seq (u64)

MAX_SESSIONS = 4096  # LRU cap on server-side peer sessions

# -- message registry --------------------------------------------------------

_MSG_TYPES: Dict[int, type] = {}
_MSG_IDS: Dict[type, int] = {}


def message(type_id: int, version: int = 1):
    """Register a message dataclass with a wire type id + version."""

    def deco(cls):
        existing = _MSG_TYPES.get(type_id)
        if existing is not None and existing.__name__ != cls.__name__:
            raise ValueError(
                f"wire type id {type_id} already taken by "
                f"{existing.__name__}; cannot register {cls.__name__}"
            )
        cls = dataclass(cls)
        cls.TYPE_ID = type_id
        cls.VERSION = version
        _MSG_TYPES[type_id] = cls
        _MSG_IDS[cls] = type_id
        return cls

    return deco


# -- lane negotiation / fragmentation wire types -----------------------------
# Messenger-internal data-plane types (fixed layouts; corpus + dencoder
# covered like every other wire type).  They live HERE, not types.py,
# because the lane layer itself produces and consumes them.


@message(71)
class MLaneHello:
    """First frame on every lane of a multi-lane peer session: binds the
    carrying connection to lane ``lane`` of lane-group ``group`` (the
    connection-negotiation fields of the wire plane).  Lane 0's hello
    CREATES the group on the acceptor; joining lanes attach to it.
    ``proc`` carries a short digest of the sender's process token for
    diagnostics only — colocation trust rides the handshake hello."""

    group: str = ""
    lane: int = 0
    n_lanes: int = 1
    proc: str = ""
    flags: int = 0

    FIXED_FIELDS = [("group", "s"), ("lane", "q"), ("n_lanes", "q"),
                    ("proc", "s"), ("flags", "Q")]


@message(72)
class MLaneSegment:
    """One fragment of a striped large message: blobs >=
    ``ms_lane_stripe_min`` split into per-data-lane segments sent
    concurrently; the receiver reassembles ``nfrags`` chunks into one
    contiguous buffer, decodes the original message from ``header``
    (fragment 0 carries it) and releases it into the gseq reorder at
    ``gseq``.  ``total`` is the full blob length, ``off`` this chunk's
    byte offset — explicit, so reassembly never depends on arrival
    order or even chunk sizing."""

    gseq: int = 0
    idx: int = 0
    nfrags: int = 1
    total: int = 0
    off: int = 0
    type_id: int = 0
    version: int = 1
    fixed: bool = False
    header: bytes = b""
    chunk: bytes = b""

    FIXED_FIELDS = [("gseq", "Q"), ("idx", "q"), ("nfrags", "q"),
                    ("total", "q"), ("off", "q"), ("type_id", "q"),
                    ("version", "q"), ("fixed", "?"), ("header", "y"),
                    ("chunk", "y")]
    BLOB_ATTR = "chunk"
    BLOB_VIEW_OK = True


# store-resident buffers may be memoryviews (ownership-transferred
# encode outputs); when one rides a pickled message field on the REAL
# wire, serialize it as its bytes — the local fastpath never serializes
import copyreg  # noqa: E402

copyreg.pickle(memoryview, lambda m: (bytes, (bytes(m),)))


def _norm_segments(segments):
    """Normalize buffers to non-empty 1-D byte memoryviews; returns
    (views, total_bytes).  Shared by BufferList and CorkedWriter so the
    cast/skip-empty rules cannot drift apart."""
    segs = []
    total = 0
    for s in segments:
        mv = s if isinstance(s, memoryview) else memoryview(s)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        if mv.nbytes:
            segs.append(mv)
            total += mv.nbytes
    return segs, total


class BufferList:
    """A blob made of multiple buffers (the reference's bufferlist,
    src/common/buffer.h): a message's bulk field may be handed over as a
    LIST of byte pieces — per-stripe chunk views, extent slices — and the
    corked send path writev's the pieces straight from their owning
    buffers.  No producer-side gather copy: the de-interleave a read
    reply used to pay (stripes -> one contiguous buffer -> frame) becomes
    a list of views the kernel gathers.  The frame crc chains across the
    pieces, so the bytes on the wire (and the receiver, which sees one
    contiguous blob land in its frame buffer) are identical to the
    concatenation.  Pickling one (control-plane ride-along, sub-threshold
    fallback) materializes to plain bytes."""

    __slots__ = ("segments", "nbytes")

    def __init__(self, segments=()):
        self.segments, self.nbytes = _norm_segments(segments)

    def __len__(self) -> int:
        return self.nbytes

    def tobytes(self) -> bytes:
        return b"".join(self.segments)

    def __bytes__(self) -> bytes:
        return self.tobytes()


# a BufferList that rides pickle (local-fastpath control copy, or a
# sub-threshold blob folded into the payload) lands as plain bytes
copyreg.pickle(BufferList, lambda bl: (bytes, (bl.tobytes(),)))


def as_bytes(data) -> bytes:
    """Materialize a message bulk field to bytes: blob-lane fields may be
    bytes, bytearray, memoryview, or BufferList depending on the path the
    message took (wire rx buffer, store view, scatter-gather reply)."""
    if isinstance(data, bytes):
        return data
    if isinstance(data, BufferList):
        return data.tobytes()
    return bytes(data)


# -- fixed binary field codec ------------------------------------------------
# Data-plane messages declare FIXED_FIELDS = [(name, kind)]: a flat,
# versioned-by-frame binary layout.  Kinds: q/Q/d/? scalars, s (u32-len
# utf8), y (u32-len bytes), Q* (u64 list), s* (str list), qq* (list of
# (i64, i64) pairs), addr ((host, port) or None).  A class may gate
# eligibility with FIXED_WHEN(msg) — e.g. MOSDOp falls back to pickle
# when a compound op vector is attached.

_FIX = {k: struct.Struct("<" + k) for k in ("q", "Q", "d", "?")}
_LEN32 = struct.Struct("<I")
_PAIR = struct.Struct("<qq")


def _pack_fixed(msg: Any, fields, blob_attr=None) -> bytes:
    parts = []
    for name, kind in fields:
        v = msg.__dict__.get(name)
        if name == blob_attr:
            v = b""  # rides the blob lane; reattached on decode
        st = _FIX.get(kind)
        if st is not None:
            parts.append(st.pack(v if kind != "?" else bool(v)))
        elif kind == "s":
            b = (v or "").encode()
            parts.append(_LEN32.pack(len(b)))
            parts.append(b)
        elif kind == "y":
            b = v if isinstance(v, (bytes, bytearray)) else \
                (b"" if v is None else bytes(v))
            parts.append(_LEN32.pack(len(b)))
            parts.append(b)
        elif kind == "Q*":
            v = v or ()
            parts.append(_LEN32.pack(len(v)))
            parts.append(struct.pack(f"<{len(v)}Q", *v))
        elif kind == "s*":
            v = v or ()
            parts.append(_LEN32.pack(len(v)))
            for s in v:
                b = s.encode()
                parts.append(_LEN32.pack(len(b)))
                parts.append(b)
        elif kind == "qq*":
            v = v or ()
            parts.append(_LEN32.pack(len(v)))
            for a, b in v:
                parts.append(_PAIR.pack(a, b))
        elif kind == "addr":
            if not v:
                parts.append(_LEN32.pack(0xFFFFFFFF))
            else:
                h = str(v[0]).encode()
                parts.append(_LEN32.pack(len(h)))
                parts.append(h)
                parts.append(_FIX["q"].pack(int(v[1])))
        else:  # pragma: no cover - schema bug
            raise ValueError(f"unknown fixed kind {kind!r}")
    return b"".join(parts)


def _default_copy(v):
    return list(v) if isinstance(v, list) else (
        dict(v) if isinstance(v, dict) else v)


def _unpack_fixed(cls, payload: bytes, blob: Any):
    obj = cls.__new__(cls)
    d = obj.__dict__
    # non-fixed fields keep their dataclass defaults (fresh containers)
    defaults = _FIXED_DEFAULTS.get(cls)
    if defaults is None:
        defaults = _FIXED_DEFAULTS[cls] = {
            k: v for k, v in cls().__dict__.items()}
    fixed_names = {n for n, _ in cls.FIXED_FIELDS}
    for k, v in defaults.items():
        if k not in fixed_names:
            d[k] = _default_copy(v)
    off = 0
    mv = memoryview(payload)
    for idx, (name, kind) in enumerate(cls.FIXED_FIELDS):
        if off >= len(payload):
            # truncated tail: the sender's FIXED_FIELDS list was SHORTER
            # — an old build predating trailing additions like the
            # trace-id pair.  Default the unsent remainder (the
            # fixed-layout analog of the reference's versioned-decode
            # "new fields default" rule); new fields MUST append.
            for tail_name, _ in cls.FIXED_FIELDS[idx:]:
                d[tail_name] = _default_copy(defaults[tail_name])
            break
        st = _FIX.get(kind)
        if st is not None:
            d[name] = st.unpack_from(payload, off)[0]
            off += st.size
        elif kind in ("s", "y"):
            (n,) = _LEN32.unpack_from(payload, off)
            off += 4
            raw = bytes(mv[off:off + n])
            off += n
            d[name] = raw.decode() if kind == "s" else raw
        elif kind == "Q*":
            (n,) = _LEN32.unpack_from(payload, off)
            off += 4
            d[name] = list(struct.unpack_from(f"<{n}Q", payload, off))
            off += 8 * n
        elif kind == "s*":
            (n,) = _LEN32.unpack_from(payload, off)
            off += 4
            out = []
            for _ in range(n):
                (sn,) = _LEN32.unpack_from(payload, off)
                off += 4
                out.append(bytes(mv[off:off + sn]).decode())
                off += sn
            d[name] = out
        elif kind == "qq*":
            (n,) = _LEN32.unpack_from(payload, off)
            off += 4
            out = []
            for _ in range(n):
                out.append(_PAIR.unpack_from(payload, off))
                off += _PAIR.size
            d[name] = out
        elif kind == "addr":
            (n,) = _LEN32.unpack_from(payload, off)
            off += 4
            if n == 0xFFFFFFFF:
                d[name] = None
            else:
                host = bytes(mv[off:off + n]).decode()
                off += n
                port = _FIX["q"].unpack_from(payload, off)[0]
                off += 8
                d[name] = (host, port)
    if blob is not None:
        d[getattr(cls, "BLOB_ATTR")] = blob
    return obj


_FIXED_DEFAULTS: Dict[type, Dict[str, Any]] = {}


def encode_payload(msg: Any) -> bytes:
    return pickle.dumps(msg.__dict__, protocol=5)


def encode_payload_parts(msg: Any):
    """(header, blob, fixed): when the message class declares BLOB_ATTR
    and the field is bulk bytes, it is stripped from the header part and
    returned separately so framing can scatter-gather it with zero
    copies.  Data-plane classes with FIXED_FIELDS get the fixed binary
    layout for the header part (fixed=True) instead of pickle."""
    cls = type(msg)
    attr = getattr(cls, "BLOB_ATTR", None)
    blob = None
    if attr is not None:
        b = msg.__dict__.get(attr)
        if isinstance(b, (bytes, bytearray, memoryview, BufferList)) \
                and len(b) >= BLOB_MIN:
            blob = b
    fields = getattr(cls, "FIXED_FIELDS", None)
    if fields is not None:
        when = getattr(cls, "FIXED_WHEN", None)
        if when is None or when(msg):
            return (_pack_fixed(msg, fields,
                                blob_attr=attr if blob is not None
                                else None),
                    blob, True)
    if blob is not None:
        d = dict(msg.__dict__)
        d[attr] = None  # reattached by decode_message
        return pickle.dumps(d, protocol=5), blob, False
    if attr is not None:
        b = msg.__dict__.get(attr)
        if isinstance(b, memoryview):
            # below the blob threshold the field rides the pickle,
            # which cannot serialize memoryviews natively fast
            d = dict(msg.__dict__)
            d[attr] = bytes(b)
            return pickle.dumps(d, protocol=5), None, False
    return pickle.dumps(msg.__dict__, protocol=5), None, False


def decode_message(type_id: int, version: int, payload: bytes,
                   blob: Any = None, fixed: bool = False) -> Any:
    cls = _MSG_TYPES.get(type_id)
    if cls is None:
        raise ValueError(f"unknown message type {type_id}")
    if version > cls.VERSION:
        raise ValueError(
            f"{cls.__name__} wire version {version} > supported {cls.VERSION}"
        )
    if fixed:
        if getattr(cls, "FIXED_FIELDS", None) is None:
            raise ValueError(f"{cls.__name__}: unexpected fixed frame")
        return _unpack_fixed(cls, payload, blob)
    obj = cls.__new__(cls)
    obj.__dict__.update(unpickle.loads(payload))
    if blob is not None:
        setattr(obj, getattr(cls, "BLOB_ATTR"), blob)
    return obj


# frame/bulk checksum: the shared hardware-crc32c resolver.  The KIND in
# use rides the handshake hello: when the two ends resolved differently
# (one host's native build failed), the connection falls back to zlib for
# its frames instead of looping on BadFrame forever.
from ceph_tpu_torch.utils.checksum import checksum, checksum_kind  # noqa: E402


class BadFrame(Exception):
    pass


# Everything a send/dial can legitimately raise when the PEER (not this
# process) is at fault: socket errors, handshake refusals/garbage, dial
# timeouts.  Daemons catching "send failed, treat as missing ack" catch
# THIS, not Exception — a TypeError in our own framing code must crash
# loudly, not melt into a silent degraded loop.  (ConnectionError and
# PermissionError are OSError subclasses and IncompleteReadError an
# EOFError subclass — listed anyway to document the intended surface.)
TRANSPORT_ERRORS = (ConnectionError, OSError, asyncio.TimeoutError,
                    asyncio.IncompleteReadError, EOFError, BadFrame,
                    PermissionError, json.JSONDecodeError)


# -- policies ----------------------------------------------------------------


@dataclass
class Policy:
    lossy: bool = True
    replay: bool = False  # keep unacked queue + replay on reconnect

    @classmethod
    def lossy_client(cls) -> "Policy":
        return cls(lossy=True, replay=False)

    @classmethod
    def lossless_peer(cls) -> "Policy":
        return cls(lossy=False, replay=True)


def _cget(conf, key: str, default: Any) -> Any:
    try:
        v = conf.get(key, default)
    except TypeError:
        v = conf.get(key) if key in conf else default
    return default if v is None else v


# -- local fast dispatch -----------------------------------------------------

# addr -> live Messenger in THIS process.  Colocated daemons' frames can
# skip the TCP stack entirely (ms_local_fastpath): the in-process
# equivalent of the reference's Messenger local_connection fast dispatch
# and the colocated-transport seam its pluggable NetworkStack keeps open
# (src/msg/async/Stack.h; DPDK/RDMA lanes plug in there the same way).
_LOCAL_REGISTRY: Dict[Tuple[str, int], "Messenger"] = {}


class LocalConnection:
    """In-process session with a colocated daemon: typed messages hand
    over BY REFERENCE through a receiver-side FIFO — no sockets,
    framing, checksums, or serialization.  Delivery matches a lossless
    wire session: per-connection order (one pump task), exactly-once
    (no transport to fail mid-frame), and dispatcher isolation
    (exceptions log, never propagate into the sender — the _serve
    discipline).  Shared contract with the reference's local delivery:
    a message is immutable once sent.

    Enabled per-messenger by ms_local_fastpath; vstart turns it on for
    plain clusters, while any wire-exercising configuration (auth,
    secure mode, fault injection) keeps real sockets so those paths
    stay covered."""

    def __init__(self, messenger: "Messenger", peer_messenger: "Messenger",
                 reverse: Optional["LocalConnection"] = None):
        self.messenger = messenger
        self.peer_messenger = peer_messenger
        self.peer = tuple(peer_messenger.addr or ("local", 0))
        self.peer_name = peer_messenger.name
        self.policy = Policy.lossless_peer()
        self.outbound = reverse is None
        # how the peer "authenticated": same-process construction IS the
        # trust statement (fastpath is off whenever auth is configured)
        self.auth_kind = "local"
        self.auth_entity_type = peer_messenger.entity_type
        self.closed = False
        # bounded: a flooding sender parks on put() exactly like a full
        # socket buffer parks drain()
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=1024)
        self._pump: Optional[asyncio.Task] = None
        self.reverse = reverse if reverse is not None else \
            LocalConnection(peer_messenger, messenger, reverse=self)

    async def send(self, msg: Any) -> None:
        peer = self.peer_messenger
        if (self.closed or peer._shutdown
                or _LOCAL_REGISTRY.get(self.peer) is not peer):
            self.closed = True
            raise ConnectionError(f"local peer {self.peer_name} gone")
        cls = type(msg)
        fields = getattr(cls, "FIXED_FIELDS", None)
        when = getattr(cls, "FIXED_WHEN", None)
        if fields is None or (when is not None and not when(msg)):
            # CONTROL-plane (or exotic) payload: give the receiver its
            # own object graph, exactly as the pickled wire would.
            # By-reference handoff is only safe for the flat, immutable
            # data-plane set — a control payload like MMapReply carries
            # the mon's LIVE OSDMap, whose next in-place mutation would
            # otherwise tear every colocated daemon's shared copy.
            msg = pickle.loads(pickle.dumps(msg, protocol=5))
        await self.reverse._deliver(msg)
        self.messenger.perf.inc("local_msgs")

    async def _deliver(self, msg: Any) -> None:
        await self._queue.put(msg)
        if self._pump is None or self._pump.done():
            m = self.messenger
            self._pump = asyncio.get_running_loop().create_task(
                self._pump_loop())
            m._tasks.add(self._pump)
            self._pump.add_done_callback(m._tasks.discard)

    async def _pump_loop(self) -> None:
        while not self.closed and not self.messenger._shutdown:
            msg = await self._queue.get()
            disp = self.messenger.dispatcher
            if disp is None:
                continue
            try:
                await disp(self, msg)
            except (asyncio.CancelledError, GeneratorExit):
                raise
            except Exception:
                traceback.print_exc()

    async def close(self, gen: int = 0) -> None:
        self.closed = True
        if self._pump is not None:
            self._pump.cancel()


# -- connection --------------------------------------------------------------


class FrameReceiver(asyncio.BufferedProtocol):
    """Zero-copy receive path: installed over the connection's transport
    (transport.set_protocol) AFTER the handshake, replacing the
    StreamReader chain whose kernel-copy -> feed_data-extend ->
    readexactly-slice pipeline double-copies every byte.  BufferedProtocol
    hands the transport OUR buffer: while a readexactly() is pending, the
    destination frame buffer itself is exposed, so payload bytes land
    exactly once.  Write-side flow control keeps working by forwarding
    pause_writing/resume_writing to the original stream protocol (the
    StreamWriter's drain() still consults it)."""

    # small backlog cap: bytes that arrive before a readexactly() is
    # waiting land in _pending and must be COPIED out, so the transport
    # pauses early — the single-copy path is bytes landing directly in
    # the registered destination buffer.  The native wirepath inverts
    # the tradeoff (Connection._rx_drain_native verifies AND lands the
    # whole backlog below the GIL), so enable_fast_read sizes the
    # backlog UP when that arm is live: a burst of bulk frames must fit
    # complete frames in _pending for the batch drain to engage at all.
    _LIMIT = 128 << 10
    _NATIVE_LIMIT = 1 << 20
    _NATIVE_SCRATCH = 256 << 10

    def __init__(self, transport, stream_protocol, leftover: bytes = b"",
                 limit: Optional[int] = None, scratch: Optional[int] = None):
        self._transport = transport
        self._stream_protocol = stream_protocol
        self._pending = bytearray(leftover)
        self._off = 0  # consumed prefix of _pending (O(1) front-consume)
        self._dest = None  # memoryview being filled by get_buffer
        self._dest_pos = 0
        if limit is not None:
            self._LIMIT = limit  # instance override of the class cap
        self._scratch = bytearray(scratch or (64 * 1024))
        self._scratch_view = memoryview(self._scratch)
        self._waiter: Optional[asyncio.Future] = None
        self._eof = False
        self._exc: Optional[BaseException] = None
        self._read_paused = False
        self._via_scratch = True  # last get_buffer handed out scratch
        # the connection's CorkedWriter, when one took over the tx side:
        # connection_lost must fail its drain waiters too
        self.corked = None

    # -- protocol side -------------------------------------------------------

    def get_buffer(self, sizehint: int):
        if self._dest is not None and self._dest_pos < len(self._dest):
            remaining = len(self._dest) - self._dest_pos
            if remaining >= len(self._scratch):
                # bulk destination (blob body): single-copy direct fill
                self._via_scratch = False
                return self._dest[self._dest_pos:]
            # SMALL destination (frame header, short payload): read
            # GREEDILY through scratch so one recv drains everything the
            # kernel has — the surplus (trailing frames of a burst)
            # lands in _pending, which is what the serve loop's rx
            # batching predicate looks at.  A per-dest-sized recv here
            # would hand frames over one at a time (two syscalls per
            # tiny frame) and batching would never see a second frame.
            self._via_scratch = True
            return self._scratch_view
        self._via_scratch = True
        return self._scratch_view

    def buffer_updated(self, nbytes: int) -> None:
        if self._dest is not None and self._dest_pos < len(self._dest):
            if not self._via_scratch:
                self._dest_pos += nbytes
                # wake the reader only when its buffer is COMPLETE: a
                # wake per network chunk would round-trip the event loop
                # hundreds of times per blob, each competing with every
                # other ready callback in a busy daemon
                if self._dest_pos >= len(self._dest):
                    self._wake()
                return
            # greedy scratch read: split between the waiting dest and
            # the pending backlog
            remaining = len(self._dest) - self._dest_pos
            take = min(nbytes, remaining)
            self._dest[self._dest_pos:self._dest_pos + take] = \
                self._scratch_view[:take]
            self._dest_pos += take
            if nbytes > take:
                self._pending += self._scratch_view[take:nbytes]
                self._check_limit()
            if self._dest_pos >= len(self._dest):
                self._wake()
        else:
            self._pending += self._scratch_view[:nbytes]
            self._check_limit()
            self._wake()

    def _check_limit(self) -> None:
        if len(self._pending) - self._off > self._LIMIT \
                and not self._read_paused:
            self._read_paused = True
            try:
                self._transport.pause_reading()
            except Exception:
                pass

    def eof_received(self):
        self._eof = True
        self._wake()
        return False

    def connection_lost(self, exc) -> None:
        self._eof = True
        self._exc = exc
        self._wake()
        if self.corked is not None:
            self.corked._on_lost(exc)
        # the StreamWriter still drains through the ORIGINAL stream
        # protocol: without this forward, a drain() parked on a paused
        # writer never learns the connection died and waits forever —
        # holding the connection send lock and wedging every reconnect
        try:
            self._stream_protocol.connection_lost(exc)
        except Exception:
            pass

    def pause_writing(self) -> None:
        self._stream_protocol.pause_writing()

    def resume_writing(self) -> None:
        self._stream_protocol.resume_writing()

    def _wake(self) -> None:
        w = self._waiter
        if w is not None and not w.done():
            w.set_result(None)

    # -- reader side ---------------------------------------------------------

    async def readexactly(self, n: int, uninit: bool = False, into=None):
        """Read n bytes.  With ``uninit=True`` the destination is an
        UNINITIALIZED buffer (np.empty) returned as a memoryview:
        bytearray(n) memsets n zero bytes the socket is about to
        overwrite, a full extra pass over the data volume on blob
        frames.  Only blob fields whose consumers are buffer-safe
        (BLOB_VIEW_OK types: store/decode lanes) opt in — everything
        else keeps bytearray semantics (concat, decode, mutation).
        With ``into=`` the bytes land DIRECTLY in the caller's buffer
        (the lane-fragment reassembly seam: a striped blob's segments
        fill their slice of the assembly buffer with zero extra
        passes); the buffer is returned."""
        pend = self._pending
        avail = len(pend) - self._off
        if into is not None:
            buf = into if isinstance(into, memoryview) \
                else memoryview(into)
            if buf.ndim != 1 or buf.itemsize != 1:
                buf = buf.cast("B")
            mv = buf
            if avail >= n:
                mv[:n] = pend[self._off:self._off + n]
                self._consume(n)
                return buf
        elif avail >= n:
            out = bytes(pend[self._off:self._off + n])
            self._consume(n)
            return out
        elif uninit:
            buf = memoryview(np.empty(n, dtype=np.uint8)).cast("B")
            mv = buf
        else:
            buf = bytearray(n)
            mv = memoryview(buf)
        pos = avail
        if pos:
            mv[:pos] = pend[self._off:]
            self._off = 0
            pend.clear()
            self._maybe_resume()
        self._dest = mv
        self._dest_pos = pos
        try:
            while self._dest_pos < n:
                if self._eof:
                    if self._exc is not None and not isinstance(
                            self._exc, (ConnectionError, OSError)):
                        raise self._exc
                    raise asyncio.IncompleteReadError(
                        bytes(mv[:self._dest_pos]), n)
                self._waiter = asyncio.get_running_loop().create_future()
                try:
                    await self._waiter
                finally:
                    self._waiter = None
        finally:
            self._dest = None
        return buf

    def _consume(self, n: int) -> None:
        """Advance the consumed-prefix pointer; compact only when the
        dead prefix dominates (amortized O(1) — a del-from-front per
        read is an O(len) memmove that dominated profiles)."""
        self._off += n
        pend = self._pending
        if self._off == len(pend):
            self._off = 0
            pend.clear()
        elif self._off > 1 << 16 and self._off * 2 > len(pend):
            del pend[:self._off]
            self._off = 0
        self._maybe_resume()

    def _maybe_resume(self) -> None:
        if self._read_paused \
                and len(self._pending) - self._off < self._LIMIT // 2:
            self._read_paused = False
            try:
                self._transport.resume_reading()
            except Exception:
                pass


def _writelines(writer, segs) -> None:
    """writer.writelines(segs), refused with ConnectionResetError once the
    writer's transport is closing.  asyncio's StreamWriter.writelines (on
    Python 3.12), unlike write(), does not check for a lost connection: it
    registers the transport's writer on a socket the loop is about to
    close, and that stale registration breaks the next socket given the
    same fd (its reader is never added, so it never reads)."""
    transport = getattr(writer, "transport", None)
    if transport is not None and transport.is_closing():
        raise ConnectionResetError("connection lost")
    writer.writelines(segs)


class CorkedWriter:
    """Zero-copy scatter-gather tx path: once the handshake is done (and
    the transport's own write buffer is empty), the connection's flusher
    swaps the StreamWriter for this — writes go STRAIGHT from the frame
    segments to ``socket.sendmsg`` (writev), so frame bytes are never
    joined or copied into a transport buffer.  The asyncio transport
    keeps owning the rx side (FrameReceiver) and the fd's lifetime; this
    class only owns which bytes leave.

    Congestion handling: segments queue in a deque; a full socket
    registers an add_writer callback that resumes sendmsg as the kernel
    drains.  ``drain()`` parks senders until the backlog is fully
    written: queued segments are VIEWS of live caller buffers (encode
    outputs, store blobs), and a drain that returned with segments still
    queued would let the owner mutate bytes before the kernel reads
    them.  Zero-copy therefore trades the overlap a buffered writer has
    — the copies it saves are the whole point.

    Failure: a send error (or the transport's connection_lost, forwarded
    by FrameReceiver) fails queued segments and drain waiters with the
    transport error — the same surface StreamWriter.drain() has."""

    IOV_MAX = 512  # segments per sendmsg call (conservative vs UIO_MAXIOV)

    def __init__(self, transport, sock, stream_writer, wp=None, perf=None):
        self._transport = transport
        self._sock = sock
        self._sw = stream_writer  # close/wait_closed/extra-info delegate
        # native wirepath arm: one released-GIL writev call drains the
        # whole backlog (partial writes, EINTR, IOV batching loop in C)
        # instead of the Python sendmsg walk below; perf counts the arm
        self._wp = wp
        self._perf = perf
        loop = asyncio.get_running_loop()
        self._loop = loop
        # the PRIVATE writer registration transports themselves use: the
        # public add_writer refuses fds owned by a transport (ours is —
        # the transport keeps the rx side).  _maybe_cork gates on these
        # existing, so an event loop without them just never corks.
        self._add_writer = loop._add_writer
        self._remove_writer = loop._remove_writer
        self._fd = sock.fileno()
        self._segs: Deque = collections.deque()
        self._buffered = 0
        self._writer_on = False  # add_writer registered
        self._waiters: list = []
        self._exc: Optional[BaseException] = None

    # -- StreamWriter surface -------------------------------------------------

    def write(self, data) -> None:
        self.writelines([data])

    def writelines(self, segments) -> None:
        if self._exc is not None:
            return  # error surfaces at drain(), like StreamWriter
        segs, total = _norm_segments(segments)
        self._segs.extend(segs)
        self._buffered += total
        if not self._writer_on:
            self._do_send()

    async def drain(self) -> None:
        while self._exc is None and self._buffered > 0:
            fut = self._loop.create_future()
            self._waiters.append(fut)
            await fut
        if self._exc is not None:
            exc = self._exc
            raise exc if isinstance(exc, Exception) \
                else ConnectionResetError("connection lost")

    def close(self) -> None:
        # best-effort final flush, then the transport closes the fd; any
        # still-unsent segments are dropped (lossless replay re-delivers)
        if self._exc is None and self._segs and not self._writer_on:
            self._do_send()
        self._detach()
        self._sw.close()

    async def wait_closed(self) -> None:
        await self._sw.wait_closed()

    def get_extra_info(self, *a, **kw):
        return self._sw.get_extra_info(*a, **kw)

    @property
    def transport(self):
        return self._transport

    # -- socket side ----------------------------------------------------------

    def _do_send(self) -> None:
        try:
            if self._wp is not None and self._segs:
                # ONE foreign call writes the whole backlog with the
                # GIL released — wirepy_writev loops partial writes /
                # EINTR / IOV_MAX internally and returns only on
                # completion or EAGAIN (the PyDLL shim parses the
                # segment list itself, so the Python side pays a bare
                # list() per call)
                written = self._wp.wirepy_writev(self._fd,
                                                 list(self._segs))
                if self._perf is not None:
                    self._perf.inc("native_tx_calls")
                    if written:
                        self._perf.inc("native_bytes", written)
                if written:
                    self._advance(written)
                if self._segs:
                    raise BlockingIOError  # kernel buffer full
            while self._segs:
                if len(self._segs) > self.IOV_MAX:
                    batch = list(itertools.islice(self._segs, self.IOV_MAX))
                else:
                    batch = list(self._segs)
                sent = self._sock.sendmsg(batch)
                self._advance(sent)
        except (BlockingIOError, InterruptedError):
            if not self._writer_on:
                self._writer_on = True
                self._add_writer(self._fd, self._do_send)
            return
        except OSError as e:
            self._on_lost(e)
            return
        if self._writer_on:
            self._writer_on = False
            try:
                self._remove_writer(self._fd)
            except Exception:
                pass
        self._wake()

    def _advance(self, n: int) -> None:
        self._buffered -= n
        while n and self._segs:
            head = self._segs[0]
            if n >= head.nbytes:
                n -= head.nbytes
                self._segs.popleft()
            else:
                self._segs[0] = head[n:]
                n = 0

    def _wake(self) -> None:
        if self._buffered == 0 or self._exc is not None:
            waiters, self._waiters = self._waiters, []
            for w in waiters:
                if not w.done():
                    w.set_result(None)

    def _detach(self) -> None:
        if self._writer_on:
            self._writer_on = False
            try:
                self._remove_writer(self._fd)
            except Exception:
                pass

    def _on_lost(self, exc) -> None:
        if self._exc is None:
            self._exc = exc if exc is not None else \
                ConnectionResetError("connection lost")
        self._detach()
        self._segs.clear()
        self._buffered = 0
        self._wake()


class Connection:
    """One ordered session with a peer.  For lossless sessions this object
    outlives TCP transports: seqs, the unacked queue, and the dedupe floor
    persist while transports come and go (transport_gen fences stale serve
    loops)."""

    def __init__(self, messenger: "Messenger", reader, writer,
                 peer: Tuple[str, int], policy: Policy,
                 peer_name: str = "", outbound: bool = False):
        self.messenger = messenger
        self.reader = reader
        self.writer = writer
        self.peer = peer
        self.peer_name = peer_name
        self.policy = policy
        self.outbound = outbound
        # how the peer authenticated ("ticket" / "secret" / "none") — set
        # by the acceptor after _handshake_in; outbound conns keep "none"
        self.auth_kind = "none"
        self.auth_entity_type = ""
        self.closed = False
        self.transport_gen = 0
        self.out_seq = 0
        self.in_seq = 0  # highest data seq dispatched (dedupe floor)
        # multi-reactor plane: the event loop owning this connection's
        # transport (all of its coroutine work runs there; cross-loop
        # senders hop via Messenger._conn_send), the reactor worker when
        # one owns the shard, and the lane-group membership when this
        # connection is one lane of a striped peer session
        try:
            self.loop: Optional[asyncio.AbstractEventLoop] = \
                asyncio.get_running_loop()
        except RuntimeError:
            self.loop = None
        self.reactor = None  # ReactorWorker owning this socket's shard
        # process mode: the reactor worker PROCESS this connection's
        # socket was delegated to (reader/writer are ShmConnEndpoints)
        self.shm_worker = None
        self.lane_group: Optional["LaneGroup"] = None
        self.lane_idx = 0
        # dispatch throttle for THIS connection's loop: the home loop
        # shares the messenger-wide throttle; each reactor worker gets
        # its own (receive backpressure is per shard — asyncio futures
        # inside Throttle are loop-bound)
        self.throttle = messenger._throttle_here()
        # per-connection session id: acceptors key replay sessions on it, so
        # a REPLACED connection never collides with its predecessor's seqs
        self.session_id = random.randbytes(8).hex()
        self.unacked: Deque[Tuple[int, bytes]] = collections.deque()
        from ceph_tpu_torch.common.lockdep import make_async_mutex

        self._send_lock = make_async_mutex("conn-send")
        # corked outbox (module docstring "Cork/flush discipline"):
        # framed segments awaiting the next flush window, the shared
        # future senders in that window await, and the single flusher
        # task that drains windows with one writelines+drain each
        self._outbox: list = []
        self._outbox_frames = 0
        self._outbox_bytes = 0
        self._ack_pending = -1  # highest seq owed an ack; -1 = none
        self._flush_fut: Optional[asyncio.Future] = None
        self._flusher: Optional[asyncio.Task] = None
        self._corked_ok = bool(_cget(messenger.conf, "ms_corked_writev",
                                     True))
        # crc/compression resolved once per connection (v2 negotiates at
        # handshake time; avoids typed-config parsing on the hot path)
        conf = messenger.conf
        self.crc_enabled = bool(_cget(conf, "ms_crc_data", True))
        self.compress_min = int(_cget(conf, "ms_compress_min_size", 0) or 0)
        # frame checksum for THIS connection: crc32c when both ends run
        # the native build (negotiated via the hello's "ckind"), zlib
        # otherwise — a silent per-host resolver difference must degrade,
        # not deadlock (set by the handshake; default local resolver)
        self.crc_fn = checksum
        # native wirepath arm (messenger-resolved): rx drains consult it
        # together with crc_fn — a zlib-negotiated connection keeps the
        # python arm so frame bytes stay identical either way
        self.wp = messenger.wirepath
        # frames pre-verified + pre-scattered by _rx_drain_native,
        # awaiting read_frame pops (each entry is read_frame's tuple);
        # _rx_error raises once the stash drains (a bad frame mid-burst
        # fails the connection AFTER its valid predecessors dispatch)
        self._rx_stash: Deque = collections.deque()
        self._rx_error: Optional[BaseException] = None

    def enable_fast_read(self) -> None:
        """Swap the StreamReader for the zero-copy FrameReceiver when the
        transport allows it (plaintext TCP; not already swapped).  Called
        at serve-loop start — the handshake has fully drained its reads,
        and any bytes the stream already buffered carry over."""
        r = self.reader
        if not isinstance(r, asyncio.StreamReader):
            return  # SecureStream (AES-GCM) or already a FrameReceiver
        try:
            transport = r._transport  # the stream pair shares it
            if transport is None:
                return
            proto = transport.get_protocol()
            leftover = bytes(r._buffer)
            r._buffer.clear()
            if self.wp is not None and (self.crc_fn is checksum
                                        or not self.crc_enabled):
                # native rx drain (same predicate read_frame gates the
                # drain on — a zlib-negotiated connection stays on the
                # python arm and must keep the small backlog): complete
                # frames must BUFFER for the burst verify+scatter to
                # batch, and the backlog-copy penalty the small default
                # guards against runs below the GIL on this arm
                receiver = FrameReceiver(
                    transport, proto, leftover,
                    limit=FrameReceiver._NATIVE_LIMIT,
                    scratch=FrameReceiver._NATIVE_SCRATCH)
            else:
                receiver = FrameReceiver(transport, proto, leftover)
            if r.at_eof():
                receiver._eof = True  # FIN landed before the swap
            transport.set_protocol(receiver)
            # the StreamReader may have left the transport paused (its
            # own flow control); the receiver starts unpaused, so resume
            # or reads would hang forever once the leftover drains
            try:
                transport.resume_reading()
            except Exception:
                pass
        except Exception:
            return
        self.reader = receiver

    # -- frame IO ------------------------------------------------------------

    def _frame(self, type_id: int, version: int, payload: bytes, seq: int,
               flags: int = 0) -> bytes:
        if self.compress_min and len(payload) >= self.compress_min:
            compressed = zlib.compress(payload, 1)
            if len(compressed) < len(payload):
                payload = compressed
                flags |= FLAG_COMPRESSED
        crc = self.crc_fn(payload) if self.crc_enabled else 0
        return _HDR.pack(len(payload), type_id, version, flags, crc, seq) + payload

    def _frame_segments(self, type_id: int, version: int, pickled: bytes,
                        blob, seq: int, flags: int = 0,
                        blob_crc: Optional[int] = None):
        """Scatter-gather frame for a blob message: the bulk bytes are
        never concatenated into a serialized buffer — the transport
        writev's [hdr, prefix, pickled, blob...] as-is (a BufferList blob
        contributes each piece unjoined).  The header crc covers
        prefix+pickled (small); the blob carries its own crc32c —
        ``blob_crc`` passes a crc the sender already holds over exactly
        these bytes (MECSubWrite.chunk_crc, a stored shard's meta crc) so
        the wire pass is skipped, the reference's bufferlist cached-crc
        discipline.  Blob frames skip on-wire compression (bulk data is
        usually incompressible shard bytes; the pickled part is tiny)."""
        if isinstance(blob, BufferList):
            segs = blob.segments
            blob_len = blob.nbytes
        else:
            segs = [blob]
            blob_len = len(blob)
        if blob_crc is None:
            if not self.crc_enabled:
                blob_crc = 0
            elif self.wp is not None and len(segs) > 1 \
                    and self.crc_fn is checksum:
                # multi-piece BufferList: ONE released-GIL call chains
                # the crc across every piece (was one ctypes round-trip
                # per piece)
                blob_crc = self.wp.wirepy_crc_chain(segs)
                self.messenger.perf.inc("native_tx_calls")
                self.messenger.perf.inc("native_bytes", blob_len)
            else:
                blob_crc = 0
                for s in segs:
                    blob_crc = self.crc_fn(s, blob_crc)
        else:
            self.messenger.perf.inc("tx_crc_reused")
        prefix = _BLOB_PFX.pack(len(pickled), blob_crc)
        crc = (self.crc_fn(pickled, self.crc_fn(prefix))
               if self.crc_enabled else 0)
        hdr = _HDR.pack(_BLOB_PFX.size + len(pickled) + blob_len,
                        type_id, version, FLAG_BLOB | flags, crc, seq)
        return [hdr, prefix, pickled, *segs]

    # -- corked outbox (tx coalescing) ---------------------------------------

    def _seg_len(self, s) -> int:
        return s.nbytes if isinstance(s, memoryview) else len(s)

    async def _enqueue(self, data) -> None:
        """Append one framed message to the outbox and await the flush
        window that carries it.  Concurrent senders in the same window
        share ONE writelines + ONE drain; a transport failure fails the
        whole window (each sender sees ConnectionResetError)."""
        if self.closed:
            raise ConnectionResetError("connection closed")
        segs = data if isinstance(data, list) else [data]
        self._outbox.extend(segs)
        self._outbox_frames += 1
        self._outbox_bytes += sum(self._seg_len(s) for s in segs)
        fut = self._flush_fut
        if fut is None:
            fut = self._flush_fut = \
                asyncio.get_running_loop().create_future()
        self._kick_flusher()
        await fut

    def queue_ack(self, seq: int) -> None:
        """Queue a cumulative ack for ``seq`` (acks are cumulative: the
        receiver pops every unacked frame <= seq, so only the highest
        pending seq ever needs a frame).  The ack piggybacks on the next
        flush window — one ack frame per window instead of one per
        dispatched message."""
        if self.closed:
            return
        if self._ack_pending >= 0:
            self.messenger.perf.inc("tx_acks_coalesced")
        self._ack_pending = max(self._ack_pending, seq)
        self._kick_flusher()

    def _kick_flusher(self) -> None:
        if self._flusher is None or self._flusher.done():
            m = self.messenger
            self._flusher = asyncio.get_running_loop().create_task(
                self._flush_loop())
            m._tasks.add(self._flusher)
            self._flusher.add_done_callback(m._tasks.discard)

    def _ack_frame(self) -> bytes:
        payload = struct.pack("<Q", self._ack_pending)
        self._ack_pending = -1
        return _HDR.pack(8, ACK_TYPE, 1, 0, self.crc_fn(payload), 0) + payload

    async def _flush_loop(self) -> None:
        """The per-connection flusher: drains flush windows until the
        outbox and pending ack are empty.  tx accounting lives HERE so
        every socket write — messages, acks — lands in tx_io/tx_bytes;
        per-message framing cost and per-type counts are send()'s
        (_note_tx).  The tx_io timer starts INSIDE the lock: queueing
        behind an adopt_transport replay is not socket time."""
        perf = self.messenger.perf
        try:
            while (self._outbox or self._ack_pending >= 0) \
                    and not self.closed:
                async with self._send_lock:
                    if self.closed:
                        break
                    self._maybe_cork()
                    segs = self._outbox
                    self._outbox = []
                    frames = self._outbox_frames
                    self._outbox_frames = 0
                    nbytes = self._outbox_bytes
                    self._outbox_bytes = 0
                    fut, self._flush_fut = self._flush_fut, None
                    had_data = bool(segs)
                    if self._ack_pending >= 0:
                        ack = self._ack_frame()
                        segs.append(ack)
                        frames += 1
                        nbytes += len(ack)
                        perf.inc("tx_acks")
                    if not segs:
                        break
                    perf.inc("tx_flush_data" if had_data else "tx_flush_ack")
                    perf.inc("tx_flushes")
                    perf.hinc("tx_flush_frames", frames)
                    perf.hinc("tx_flush_bytes", nbytes)
                    gen = self.transport_gen
                    t_io = time.monotonic()
                    try:
                        with perf.time_avg("tx_io"):
                            _writelines(self.writer, segs)
                            await self.writer.drain()
                    except (ConnectionError, OSError,
                            asyncio.TimeoutError) as e:
                        if fut is not None and not fut.done():
                            fut.set_exception(ConnectionResetError(
                                f"flush failed: {e}"))
                            fut.exception()  # mark retrieved (no-waiter GC)
                        # gen-fenced: a no-op here means adopt_transport
                        # replaced the transport under us — loop again and
                        # retry the remaining windows on the new writer
                        # (a genuine close ends the loop via its condition)
                        await self.close(gen)
                        continue
                    except asyncio.CancelledError:
                        raise
                    except BaseException as e:
                        # a framing/writer BUG must crash loudly — but
                        # never by leaving the window's senders parked on
                        # a future nobody will resolve
                        if fut is not None and not fut.done():
                            fut.set_exception(
                                ConnectionResetError(f"flush failed: {e}"))
                            fut.exception()
                        await self.close(gen)
                        raise
                    perf.inc("tx_bytes", nbytes)
                    perf.hinc("tx_io_us",
                              (time.monotonic() - t_io) * 1e6)
                    if fut is not None and not fut.done():
                        fut.set_result(None)
        finally:
            if self.closed:
                self._fail_pending(ConnectionResetError("connection closed"))

    def _pin_replay_queue(self) -> None:
        """Materialize view segments of queued unacked frames to bytes.
        Runs at transport death: from here the frames may sit queued for
        a whole reconnect window (or forever, for a gone peer), and a
        queued VIEW would pin its whole backing buffer (e.g. the k-row
        encode matrix behind one shard's 1/k-sized view) for that long.
        While the transport is healthy the queue turns over within an
        RTT, so the hot path never pays this copy."""
        for i, (seq, data) in enumerate(self.unacked):
            if isinstance(data, list) \
                    and any(not isinstance(s, bytes) for s in data):
                self.unacked[i] = (seq, [
                    s if isinstance(s, bytes) else bytes(s) for s in data])

    def _fail_pending(self, exc: Exception) -> None:
        """Fail the pending flush window (senders awaiting it see the
        transport error) and drop un-flushed segments: lossless frames
        live in the unacked queue and replay on the adopted transport;
        un-flushed acks are re-queued by the dedupe path when the peer
        replays."""
        fut, self._flush_fut = self._flush_fut, None
        self._outbox = []
        self._outbox_frames = 0
        self._outbox_bytes = 0
        self._ack_pending = -1
        if fut is not None and not fut.done():
            fut.set_exception(exc)
            fut.exception()  # mark retrieved: ok if every sender left

    def _maybe_cork(self) -> None:
        """Swap the StreamWriter for the zero-copy CorkedWriter when the
        transport allows it (plaintext TCP, nothing buffered in the
        transport, sendmsg available).  Called under the send lock at
        flush time — lazily, so it naturally re-engages after an
        adopt_transport handed us a fresh StreamWriter."""
        if not self._corked_ok:
            return
        w = self.writer
        if not isinstance(w, asyncio.StreamWriter):
            return  # SecureStream (AES-GCM) or already corked
        try:
            transport = w.transport
            if (transport is None or transport.is_closing()
                    or transport.get_write_buffer_size() != 0):
                return
            sock = transport.get_extra_info("socket")
            # unwrap asyncio's TransportSocket: its sendmsg() warns (and
            # is slated for removal); the raw socket is the real surface
            sock = getattr(sock, "_sock", sock)
            if sock is None or not hasattr(sock, "sendmsg"):
                return
            loop = asyncio.get_running_loop()
            if not hasattr(loop, "_add_writer"):
                return  # non-selector loop: keep the stream writer
            corked = CorkedWriter(transport, sock, w,
                                  wp=self.messenger.wirepath,
                                  perf=self.messenger.perf)
            proto = transport.get_protocol()
            if isinstance(proto, FrameReceiver):
                proto.corked = corked  # connection_lost fails its waiters
        except Exception:
            return
        self.writer = corked

    async def send(self, msg: Any) -> None:
        conf = self.messenger.conf
        inj = _cget(conf, "ms_inject_socket_failures", 0)
        injected = bool(inj) and random.randrange(inj) == 0
        if injected and not self.policy.replay:
            await self.close()
            raise ConnectionResetError("injected socket failure")
        delay = _cget(conf, "ms_inject_delay_max", 0)
        if delay:
            await asyncio.sleep(random.uniform(0, delay))
        # ms_inject_dup_frames: deliver this message TWICE (two frames,
        # two seqs — a genuine at-least-once delivery the receiver's seq
        # dedupe cannot filter), exercising the APPLICATION layer's
        # duplicate absorption.  Scoped to the client-op plane, which is
        # the layer contracted to absorb duplicates: MOSDOp dups dedupe
        # against the PG log's reqid set, MOSDOpReply dups against the
        # client's pop-once reply futures.  Other planes (sub-write
        # replies, peering gathers) count messages and are entitled to
        # the session's exactly-once delivery.
        dup_inj = _cget(conf, "ms_inject_dup_frames", 0)
        duplicate = (bool(dup_inj)
                     and type(msg).__name__ in ("MOSDOp", "MOSDOpReply")
                     and random.randrange(dup_inj) == 0)
        self.out_seq += 1
        seq = self.out_seq
        t_frame = time.monotonic()
        pickled, blob, fixed = encode_payload_parts(msg)
        flags = FLAG_FIXED if fixed else 0
        if blob is not None:
            # cached-crc reuse: a message that already carries a crc of
            # EXACTLY its blob bytes (BLOB_CRC_ATTR) skips the wire crc
            # pass — only when this connection's negotiated checksum is
            # the shared resolver the app-level crc was computed with
            pre_crc = None
            crc_attr = getattr(type(msg), "BLOB_CRC_ATTR", None)
            if crc_attr is not None and self.crc_enabled \
                    and self.crc_fn is checksum:
                v = msg.__dict__.get(crc_attr) or 0
                if v:
                    pre_crc = v & 0xFFFFFFFF
            data = self._frame_segments(msg.TYPE_ID, msg.VERSION, pickled,
                                        blob, seq, flags, blob_crc=pre_crc)
        else:
            pre_crc = None
            data = self._frame(msg.TYPE_ID, msg.VERSION, pickled, seq,
                               flags)
        self.messenger._note_tx(type(msg).__name__,
                                sum(self._seg_len(p) for p in data)
                                if isinstance(data, list) else len(data),
                                time.monotonic() - t_frame)
        if self.policy.replay:
            # lossless send never fails: the frame joins the session queue
            # and reconnect+replay delivers it exactly once (reference
            # lossless_peer out_queue semantics).  Blob VIEWS stay views
            # here — on a healthy session the ack pops the frame within
            # an RTT, so the pin on the backing buffer is transient; the
            # frames only materialize to bytes when the transport DIES
            # (close() -> _pin_replay_queue), which is when a frame can
            # actually sit queued long enough for pinning to matter.
            self.unacked.append((seq, data))
            if injected:
                # injected transport failure: frame stays queued, session
                # survives, reconnect+replay delivers
                await self.close()
                return
            try:
                await self._enqueue(data)
            except (ConnectionError, OSError):
                await self.close()
        else:
            await self._enqueue(data)
        if duplicate and not self.closed:
            # the duplicate frame is best-effort: the knob exists to
            # exercise dedup, and a transport error here already has the
            # original frame's failure handling covering the message
            self.out_seq += 1
            dseq = self.out_seq
            if blob is not None:
                ddata = self._frame_segments(
                    msg.TYPE_ID, msg.VERSION, pickled, blob, dseq, flags,
                    blob_crc=pre_crc)
            else:
                ddata = self._frame(msg.TYPE_ID, msg.VERSION, pickled,
                                    dseq, flags)
            if self.policy.replay:
                self.unacked.append((dseq, ddata))
            try:
                await self._enqueue(ddata)
            except (ConnectionError, OSError):
                pass

    async def send_ack(self, seq: int) -> None:
        """Compat shim: queue a cumulative ack (piggybacked on the next
        flush window; see queue_ack)."""
        self.queue_ack(seq)

    def handle_ack(self, seq: int) -> None:
        while self.unacked and self.unacked[0][0] <= seq:
            self.unacked.popleft()

    def buffered_frame_len(self) -> Optional[int]:
        """Payload length of the next COMPLETE frame in hand: a frame
        pre-verified into the rx stash by the native drain first, else
        whatever is fully buffered on the reader — the serve loop's rx
        batching predicate (batch only what needs no network wait).
        Delegated connections peek the shm ring instead: a fully
        buffered record needs no worker round-trip."""
        if self._rx_stash:
            return self._rx_stash[0][4]
        if isinstance(self.reader, ShmConnEndpoint):
            n = self.reader.complete_record_len()
            if n is None:
                return None
            return max(0, n - _SHM_FRAME_HDR.size)
        return Messenger._buffered_frame_len(self.reader)

    def _rx_drain_native(self) -> None:
        """Native rx burst: parse every COMPLETE frame already buffered
        in the FrameReceiver backlog, verify ALL their crc sections in
        ONE released-GIL call (wirepy_verify_regions — the geometry
        rides plain int lists, walked in C), land every verified
        frame's blob bytes with ONE more released-GIL scatter call
        (wirepy_scatter_from) — lane fragments straight into their
        slice of the group assembly buffer (frag_view) — and stash
        read_frame-ready tuples.  The python arm pays 2-4 awaits plus
        1-2 ctypes crc round-trips plus an interpreter copy per frame;
        this pays two foreign calls per BURST, and the GIL is released
        while the burst's bytes are checksummed and moved.

        A crc-failing frame mid-burst stashes its valid predecessors,
        consumes through the bad frame, and parks the BadFrame in
        _rx_error — read_frame raises it once the stash drains, exactly
        the slow path's fail-after-the-good-frames order."""
        r = self.reader
        pend = r._pending
        base = r._off
        end = len(pend)
        if end - base < _HDR.size or self._rx_error is not None:
            return
        crc_on = self.crc_enabled
        t0 = time.monotonic()
        voffs: list = []    # crc regions: offsets/lengths INTO pend
        vlens: list = []
        vwants: list = []
        expect: list = []   # (frame_index, is_blob) per crc region
        frames: list = []   # [type_id, version, seq, payload, length,
        #                      blob, fixed, verified, flags, src_off]
        pos = base
        error: Optional[BaseException] = None
        error_end = pos
        # one export for the whole drain: bytes(mv[a:b]) is a single
        # copy, where bytes(pend[a:b]) would copy twice (bytearray
        # slice, then bytes).  Released before _consume — a live export
        # blocks the bytearray resize.
        mv = memoryview(pend)
        try:
            while end - pos >= _HDR.size:
                length, type_id, version, flags, crc, seq = \
                    _HDR.unpack_from(pend, pos)
                if end - pos - _HDR.size < length:
                    break
                fstart = pos + _HDR.size
                fend = fstart + length
                blob = None
                verified = False
                src_off = -1
                if flags & FLAG_BLOB:
                    if _BLOB_PFX.size > length:
                        error = BadFrame(f"bad blob prefix on type {type_id}")
                        error_end = fend
                        break
                    plen, blob_crc = _BLOB_PFX.unpack_from(pend, fstart)
                    if _BLOB_PFX.size + plen > length:
                        # a corrupt plen would desync the stream — reject
                        # (the slow path refuses before any read; either
                        # way the frame is consumed and the session dies)
                        error = BadFrame(f"bad blob prefix on type {type_id}")
                        error_end = fend
                        break
                    hdr_end = fstart + _BLOB_PFX.size + plen
                    payload = bytes(mv[fstart + _BLOB_PFX.size:hdr_end])
                    blob_len = length - _BLOB_PFX.size - plen
                    if crc and crc_on:
                        # one region covers prefix+pickled: crc32c over the
                        # contiguous span == the chained tx-side crc
                        voffs.append(fstart)
                        vlens.append(hdr_end - fstart)
                        vwants.append(crc)
                        expect.append((len(frames), False))
                    cls = _MSG_TYPES.get(type_id)
                    dest = None
                    if cls is MLaneSegment and self.lane_group is not None \
                            and (flags & FLAG_FIXED) and blob_len \
                            and not (seq and seq <= self.in_seq):
                        # the in_seq guard: see the slow path — a replayed
                        # duplicate must not re-open reassembly state
                        try:
                            seg = _unpack_fixed(cls, payload, None)
                            dest = self.lane_group.frag_view(seg, blob_len)
                        except Exception:
                            dest = None
                    if dest is not None:
                        blob = dest
                    elif getattr(cls, "BLOB_VIEW_OK", False):
                        blob = memoryview(
                            np.empty(blob_len, dtype=np.uint8)).cast("B")
                    else:
                        blob = bytearray(blob_len)
                    src_off = hdr_end
                    if blob_crc and crc_on:
                        voffs.append(hdr_end)
                        vlens.append(blob_len)
                        vwants.append(blob_crc)
                        expect.append((len(frames), True))
                        verified = True
                else:
                    payload = bytes(mv[fstart:fend])
                    if crc and crc_on:
                        voffs.append(fstart)
                        vlens.append(length)
                        vwants.append(crc)
                        expect.append((len(frames), False))
                frames.append([type_id, version, seq, payload, length, blob,
                               bool(flags & FLAG_FIXED), verified, flags,
                               src_off])
                pos = fend
            if not frames and error is None:
                return
            perf = self.messenger.perf
            bad_idx = len(frames)
            if voffs:
                bad_region = self.wp.wirepy_verify_regions(
                    pend, voffs, vlens, vwants)
                perf.inc("native_rx_calls")
                perf.inc("native_bytes", sum(vlens))
                if bad_region >= 0:
                    fidx, is_blob = expect[bad_region]
                    if fidx < bad_idx:
                        bad_idx = fidx
                        error = BadFrame(
                            ("blob crc mismatch on type {}" if is_blob
                             else "crc mismatch on frame type {}").format(
                                frames[fidx][0]))
                        error_end = base + sum(
                            _HDR.size + f[4] for f in frames[:fidx + 1])
            consumed = pos - base
            soffs: list = []
            dsts: list = []
            for f in frames[:bad_idx]:
                if f[9] >= 0:
                    # verified-then-copied: a crc-refused frame never lands
                    # a byte (the slow path lands then kills; the failure
                    # surface — BadFrame, session death — is identical, the
                    # assembly buffer just stays cleaner)
                    soffs.append(f[9])
                    dsts.append(f[5])
                flags = f[8]
                payload = f[3]
                if flags & FLAG_COMPRESSED and not (flags & FLAG_BLOB):
                    payload = zlib.decompress(payload)
                self._rx_stash.append((f[0], f[1], f[2], payload, f[4],
                                       f[5], f[6], f[7]))
            if soffs:
                copied = self.wp.wirepy_scatter_from(pend, soffs, dsts)
                perf.inc("native_rx_calls")
                perf.inc("native_bytes", copied)
            if error is not None:
                self._rx_error = error
                consumed = error_end - base
        finally:
            mv.release()
        r._consume(consumed)
        rx_dt = time.monotonic() - t0
        perf.tinc("rx_io", rx_dt)
        perf.hinc("rx_io_us", rx_dt * 1e6)

    async def read_frame(self) -> Tuple[int, int, int, bytes, int, Any,
                                        bool, bool]:
        """Returns (type_id, version, seq, payload, cost, blob, fixed,
        blob_verified).  The dispatch throttle is charged `cost` bytes
        BEFORE the payload is read (receive-side backpressure, reference
        DispatchQueue throttle); the caller must put() cost back when
        done with the payload.  Blob frames (FLAG_BLOB) return the bulk
        bytes separately, checked against their own crc32c —
        ``blob_verified`` says that check actually ran (crc enabled and
        present), so handlers holding an app-level crc of the same bytes
        (MECSubWrite.chunk_crc) can skip their own verify pass."""
        stash = self._rx_stash
        if not stash and self.wp is not None \
                and isinstance(self.reader, FrameReceiver) \
                and (self.crc_fn is checksum or not self.crc_enabled):
            # native burst drain: every fully-buffered frame verifies in
            # one released-GIL call and lands pre-scattered in the stash
            self._rx_drain_native()
        if stash:
            (type_id, version, seq, payload, cost, blob, fixed,
             verified) = stash.popleft()
            await self.throttle.get(cost)
            self.messenger.perf.inc("rx_bytes", _HDR.size + cost)
            return (type_id, version, seq, payload, cost, blob, fixed,
                    verified)
        if self._rx_error is not None:
            err, self._rx_error = self._rx_error, None
            raise err
        if isinstance(self.reader, ShmConnEndpoint):
            return await self._read_frame_shm()
        hdr = await self.reader.readexactly(_HDR.size)
        length, type_id, version, flags, crc, seq = _HDR.unpack(hdr)
        cost = length
        await self.throttle.get(cost)
        # rx_io clock starts AFTER the header lands: the header read is
        # where idle between-message waiting parks, and folding that into
        # the per-frame number would drown the transfer cost it measures
        t_io = time.monotonic()
        blob_verified = False
        try:
            blob = None
            if flags & FLAG_BLOB:
                # the blob reads into ITS OWN buffer (FrameReceiver lands
                # bytes there directly — no giant payload slice)
                head = await self.reader.readexactly(_BLOB_PFX.size)
                plen, blob_crc = _BLOB_PFX.unpack_from(head)
                if _BLOB_PFX.size + plen > length:
                    # a corrupt plen would drive the blob read negative
                    # and desync the stream — reject before any read
                    raise BadFrame(f"bad blob prefix on type {type_id}")
                pickled = await self.reader.readexactly(plen)
                blob_len = length - _BLOB_PFX.size - plen
                cls = _MSG_TYPES.get(type_id)
                if getattr(cls, "BLOB_VIEW_OK", False) \
                        and isinstance(self.reader, FrameReceiver):
                    # lane-fragment reassembly seam: a striped segment's
                    # chunk lands DIRECTLY in its slice of the group's
                    # assembly buffer — no per-fragment staging buffer,
                    # no gather copy at reassembly time
                    dest = None
                    if cls is MLaneSegment and self.lane_group is not None \
                            and (flags & FLAG_FIXED) and blob_len \
                            and not (seq and seq <= self.in_seq):
                        # the in_seq guard keeps a REPLAYED duplicate
                        # (acked but re-sent across a lane revival) from
                        # re-creating reassembly state the serve loop is
                        # about to drop — that would leak one assembly
                        # buffer per replayed fragment
                        try:
                            seg = _unpack_fixed(cls, bytes(pickled), None)
                            dest = self.lane_group.frag_view(
                                seg, blob_len)
                        except Exception:
                            dest = None
                    if dest is not None:
                        blob = await self.reader.readexactly(blob_len,
                                                             into=dest)
                    else:
                        # store/decode-lane blob: land in an
                        # uninitialized buffer (no memset pass over the
                        # data volume)
                        blob = await self.reader.readexactly(blob_len,
                                                             uninit=True)
                else:
                    blob = await self.reader.readexactly(blob_len)
                if crc and self.crc_enabled \
                        and self.crc_fn(pickled, self.crc_fn(head)) != crc:
                    raise BadFrame(f"crc mismatch on frame type {type_id}")
                if blob_crc and self.crc_enabled:
                    if self.crc_fn(blob) != blob_crc:
                        raise BadFrame(f"blob crc mismatch on type {type_id}")
                    blob_verified = True
                payload = pickled
            else:
                payload = await self.reader.readexactly(length)
                if crc and self.crc_enabled \
                        and self.crc_fn(payload) != crc:
                    raise BadFrame(f"crc mismatch on frame type {type_id}")
                if flags & FLAG_COMPRESSED:
                    payload = zlib.decompress(payload)
        except BaseException:
            self.throttle.put(cost)
            raise
        perf = self.messenger.perf
        rx_dt = time.monotonic() - t_io
        perf.tinc("rx_io", rx_dt)
        perf.hinc("rx_io_us", rx_dt * 1e6)
        perf.inc("rx_bytes", _HDR.size + length)
        return (type_id, version, seq, payload, cost, blob,
                bool(flags & FLAG_FIXED), blob_verified)

    async def _read_frame_shm(self) -> Tuple[int, int, int, bytes, int,
                                             Any, bool, bool]:
        """Delegated-connection read_frame: the worker process already
        parsed, crc-verified (its own wirepath arm) and decompressed the
        frame; this side consumes the record from the shm ring.  Same
        contract as read_frame: throttle charged before the payload is
        copied out (and RETURNED on every error path — the r13 cost
        discipline extended to the process plane), lane fragments land
        straight in their slice of the group assembly buffer, EOF and
        crc failure surface exactly like the socket path's."""
        ep = self.reader
        kind, length = await ep.read_record_hdr()
        if kind == _SHM_REC_EOF:
            raise ConnectionResetError("delegated transport eof")
        if kind == _SHM_REC_ERR:
            raise BadFrame(
                (await ep.read_exact(length)).decode("utf-8", "replace"))
        if kind != _SHM_REC_FRAME:
            raise BadFrame(f"unknown shm record kind {kind}")
        fh = await ep.read_exact(_SHM_FRAME_HDR.size)
        type_id, version, rflags, seq, plen, blen = _SHM_FRAME_HDR.unpack(fh)
        cost = plen + blen
        await self.throttle.get(cost)
        t_io = time.monotonic()
        try:
            payload = await ep.read_exact(plen)
            blob = None
            if rflags & _SHM_RF_BLOB:
                cls = _MSG_TYPES.get(type_id)
                dest = None
                if cls is MLaneSegment and self.lane_group is not None \
                        and (rflags & _SHM_RF_FIXED) and blen \
                        and not (seq and seq <= self.in_seq):
                    # zero-copy reassembly across the process seam: the
                    # fragment's chunk reads shm -> its assembly slice
                    # (in_seq guard as in the socket paths — a replayed
                    # duplicate must not re-open reassembly state)
                    try:
                        seg = _unpack_fixed(cls, payload, None)
                        dest = self.lane_group.frag_view(seg, blen)
                    except Exception:
                        dest = None
                if dest is not None:
                    await ep.read_into(dest, blen)
                    blob = dest
                elif getattr(cls, "BLOB_VIEW_OK", False):
                    # rx -> install staging: page-aligned so a
                    # writeback install's h2d reads an aligned source
                    # (pinnable where pinned DMA exists) — the ring
                    # views native-gather straight into it, zero
                    # parent-side per-byte passes after the kernel.  The
                    # staging follows the daemon's device (osd_ec_device):
                    # pinned memory for the card, aligned host memory on
                    # a daemon told to use the CPU
                    from ceph_tpu_torch.rados.pagestore import install_staging

                    blob = install_staging(
                        blen, _cget(self.messenger.conf, "osd_ec_device",
                                    "cuda"))
                    await ep.read_into(blob, blen)
                else:
                    blob = bytearray(blen)
                    await ep.read_into(blob, blen)
        except BaseException:
            self.throttle.put(cost)
            raise
        perf = self.messenger.perf
        rx_dt = time.monotonic() - t_io
        perf.tinc("rx_io", rx_dt)
        perf.hinc("rx_io_us", rx_dt * 1e6)
        perf.inc("rx_bytes", _HDR.size + cost)
        return (type_id, version, seq, payload, cost, blob,
                bool(rflags & _SHM_RF_FIXED),
                bool(rflags & _SHM_RF_VERIFIED))

    async def adopt_transport(self, reader, writer) -> None:
        """Adopt a fresh transport into this session and replay unacked
        frames (both directions of the reference's session reconnect:
        the initiator replays requests, the acceptor replays replies)."""
        old_writer = self.writer
        async with self._send_lock:
            self.reader = reader
            self.writer = writer
            self.closed = False
            self.transport_gen += 1
            # pre-verified frames from the DEAD transport: never
            # dispatched, never acked — the peer replays them on this
            # transport, and the in_seq dedupe floor keeps it exactly-once
            self._rx_stash.clear()
            self._rx_error = None
            try:
                old_writer.close()
            except Exception:
                pass
            replayed = 0
            with self.messenger.perf.time_avg("tx_io"):
                for _, data in list(self.unacked):
                    if isinstance(data, list):
                        _writelines(self.writer, data)
                        replayed += sum(len(p) for p in data)
                    else:
                        self.writer.write(data)
                        replayed += len(data)
                await self.writer.drain()
            if replayed:
                self.messenger.perf.inc("tx_bytes", replayed)

    async def close(self, gen: Optional[int] = None) -> None:
        """Close the current transport.  With gen, only close if the
        transport hasn't been replaced since the caller observed it."""
        if gen is not None and gen != self.transport_gen:
            return
        if not self.closed:
            self.closed = True
            # senders parked on the pending flush window see the error
            # now; their frames replay from the unacked queue (lossless)
            self._fail_pending(ConnectionResetError("connection closed"))
            self._pin_replay_queue()
            self.writer.close()
            try:
                # bounded: wait_closed can block if the peer never reads
                await asyncio.wait_for(self.writer.wait_closed(), timeout=0.5)
            except Exception:
                pass


# -- multi-lane peer sessions ------------------------------------------------


class LaneGroup:
    """A striped peer session: N lane Connections plus the cross-lane
    sequencing/reassembly seam (module docstring "Sharded multi-reactor
    wire plane").  Duck-types the Connection surface daemons touch
    (send / close / peer / peer_name / auth metadata), so handlers reply
    through the group and replies stripe too.

    TX: LANE_STRIPE messages get the next connection-global ``gseq`` and
    round-robin across lanes 1..N-1 (lane 0 is control-only); blobs >=
    ``frag_min`` split into MLaneSegment fragments sent over ALL data
    lanes concurrently.  RX: every lane's serve loop pushes decoded
    messages here; gseq order is restored (holes park, a dead lane's
    replay fills them), fragments reassemble, and a single pump task on
    the messenger's home loop dispatches in order — one serialization
    point, so the ordering guarantee holds even when lanes live on
    different reactor threads.

    Throttle note: frames PARKED for a gap or a partial reassembly
    release their dispatch-throttle cost at park time (a dead lane may
    hold a gap open for seconds; holding budget hostage would stall the
    shard's other sessions) — parked memory is instead bounded by
    PARK_CAP, past which the reorderer force-drains in gseq order."""

    PARK_CAP = 8192  # parked frames before the reorderer force-drains
    # reassembly memory caps: fragment geometry is PEER-CLAIMED and read
    # before the frame crc can reject it, so the allocation it drives
    # must be bounded independently of the dispatch throttle (which only
    # accounts wire bytes).  Overflowing assemblies are refused and
    # counted (lane_frag_overflow); upper-layer resend recovers.
    FRAG_MAX_ASSEMBLIES = 64
    FRAG_MAX_BYTES = 256 << 20

    def __init__(self, messenger: "Messenger", addr: Tuple[str, int],
                 group_id: str, n_lanes: int, outbound: bool,
                 policy: Policy):
        self.messenger = messenger
        self.peer = tuple(addr)
        self.group_id = group_id
        self.n_lanes = max(2, int(n_lanes))
        self.outbound = outbound
        self.policy = policy
        self.lanes: List[Optional[Connection]] = [None] * self.n_lanes
        self.closed = False
        self.frag_min = int(_cget(messenger.conf, "ms_lane_stripe_min",
                                  1 << 20) or 0)
        self._tx_gseq = 0
        self._rr = 0
        # rx reorder + reassembly state, guarded for cross-reactor lanes
        self._lock = threading.Lock()
        self._rx_next = 1
        self._parked: Dict[int, Tuple[Any, Any]] = {}  # gseq -> (conn, msg)
        # gseq -> [seen, chunks, hdr, all_verified, buf, confirmed_ranges]
        self._frags: Dict[int, list] = {}
        self._frag_bytes = 0  # aggregate assembly-buffer bytes live
        self._fifo: Deque = collections.deque()  # (conn, msg, cost)
        self._pump_task: Optional[asyncio.Task] = None
        self._wake: Optional[asyncio.Event] = None
        self._reviving: set = set()

    # -- Connection surface ---------------------------------------------------

    def _lane0(self) -> Optional[Connection]:
        return self.lanes[0]

    @property
    def peer_name(self) -> str:
        c = self._lane0()
        return c.peer_name if c is not None else ""

    @property
    def auth_kind(self) -> str:
        c = self._lane0()
        return c.auth_kind if c is not None else "none"

    @property
    def auth_entity_type(self) -> str:
        c = self._lane0()
        return c.auth_entity_type if c is not None else ""

    def _lane(self, idx: int) -> Connection:
        conn = self.lanes[idx]
        if conn is None:
            conn = self.lanes[0]
        if conn is None:
            raise ConnectionResetError("lane group has no lanes")
        return conn

    @property
    def n_data_lanes(self) -> int:
        return self.n_lanes - 1

    async def send(self, msg: Any) -> None:
        if self.closed:
            raise ConnectionResetError("lane group closed")
        cls = type(msg)
        if not getattr(cls, "LANE_STRIPE", False):
            # control plane: lane 0, no gseq — never queued behind data
            await self.messenger._conn_send(self._lane(0), msg)
            return
        self._tx_gseq += 1
        gseq = self._tx_gseq
        msg.gseq = gseq
        blob_attr = getattr(cls, "BLOB_ATTR", None)
        blob = msg.__dict__.get(blob_attr) if blob_attr else None
        blob_len = len(blob) if blob is not None else 0
        if (self.frag_min and blob_len >= self.frag_min
                and self.n_data_lanes > 1):
            if await self._send_fragmented(msg, gseq):
                return
        idx = 1 + (gseq - 1) % self.n_data_lanes
        self._note_lane_tx(idx, blob_len)
        await self.messenger._conn_send(self._lane(idx), msg)

    def _note_lane_tx(self, idx: int, nbytes: int) -> None:
        p = self.messenger.perf
        p.ensure(f"tx_lane{idx}_msgs", desc=f"messages striped to lane {idx}")
        p.ensure(f"tx_lane{idx}_bytes", desc=f"blob bytes striped to lane {idx}")
        p.inc(f"tx_lane{idx}_msgs")
        p.inc(f"tx_lane{idx}_bytes", nbytes)

    async def _send_fragmented(self, msg: Any, gseq: int) -> bool:
        """Split a large blob across all data lanes as MLaneSegment
        frames sent concurrently; returns False when the message isn't
        actually blob-framed (caller falls back to whole-message)."""
        header, blob, fixed = encode_payload_parts(msg)
        if blob is None:
            return False
        if isinstance(blob, BufferList):
            segs, total = blob.segments, blob.nbytes
        else:
            segs, total = _norm_segments([blob])
        n = self.n_data_lanes
        base, extra = divmod(total, n)
        # walk the segment list once, carving n contiguous byte ranges
        sends = []
        seg_i, seg_off = 0, 0
        off = 0
        for i in range(n):
            want = base + (1 if i < extra else 0)
            pieces = []
            while want and seg_i < len(segs):
                seg = segs[seg_i]
                take = min(want, seg.nbytes - seg_off)
                pieces.append(seg[seg_off:seg_off + take])
                want -= take
                seg_off += take
                if seg_off >= seg.nbytes:
                    seg_i += 1
                    seg_off = 0
            chunk: Any = pieces[0] if len(pieces) == 1 else BufferList(pieces)
            frag = MLaneSegment(gseq=gseq, idx=i, nfrags=n, total=total,
                                off=off,
                                type_id=type(msg).TYPE_ID,
                                version=type(msg).VERSION,
                                fixed=bool(fixed),
                                header=header if i == 0 else b"",
                                chunk=chunk)
            lane_idx = 1 + (gseq + i - 1) % n
            self._note_lane_tx(lane_idx, len(chunk))
            sends.append(self.messenger._conn_send(
                self._lane(lane_idx), frag))
            off += len(chunk)
        self.messenger.perf.inc("lane_frag_tx", n)
        results = await asyncio.gather(*sends, return_exceptions=True)
        for r in results:
            if isinstance(r, BaseException):
                raise r
        return True

    # -- rx: reassembly + ordered dispatch ------------------------------------

    def rx_push(self, conn: Connection, msg: Any, cost: int) -> None:
        """Called by each lane's serve loop with a decoded message.
        Restores gseq order (parking holes), reassembles fragments, and
        feeds the ready run to the single dispatch pump.  Cost transfers
        with READY messages (released after dispatch); parked frames
        release theirs immediately (see class docstring)."""
        with self._lock:
            ready = self._ingest(conn, msg)
            first = True
            for c, m in ready:
                # THIS arrival's cost rides the first ready entry
                # (parked entries released theirs at park time; a
                # reassembled message inherits its completing
                # fragment's) — pump returns it, to the ARRIVAL's shard
                # throttle, after dispatch
                self._fifo.append((c, m, cost if first else 0, conn))
                first = False
        if not ready and cost:
            self.messenger._throttle_put(conn, cost)
        if ready:
            self._kick_pump()

    def _ingest(self, conn: Connection, msg: Any):
        """Under _lock: returns the in-order run of (conn, msg) this
        arrival unlocks ([] when it parked)."""
        if type(msg).__name__ == "MLaneSegment":
            msg = self._ingest_fragment(conn, msg)
            if msg is None:
                return []
        g = getattr(msg, "gseq", 0) or 0
        if g == 0 or g < self._rx_next:
            # control-plane (no gseq) dispatches immediately; g <
            # expected is a cross-lane duplicate (dup injection, replay
            # overlap) the application layer's reqid dedupe absorbs
            return [(conn, msg)]
        if g > self._rx_next:
            self._parked[g] = (conn, msg)
            self.messenger.perf.inc("lane_rx_parked")
            if len(self._parked) > self.PARK_CAP:
                # liveness backstop: force-drain in gseq order rather
                # than grow without bound (a hole this old means the
                # owning lane session is gone for good)
                self.messenger.dout(
                    1, f"lane group {self.group_id[:8]}: PARK_CAP "
                       f"({self.PARK_CAP}) exceeded at gseq hole "
                       f"{self._rx_next}; force-draining reorder buffer")
                keys = sorted(self._parked)
                out = [self._parked.pop(k) for k in keys]
                self._rx_next = keys[-1] + 1
                return out
            return []
        out = [(conn, msg)]
        self._rx_next += 1
        while self._rx_next in self._parked:
            out.append(self._parked.pop(self._rx_next))
            self._rx_next += 1
        return out

    def frag_view(self, seg: Any, blob_len: int):
        """Reassembly destination for one inbound MLaneSegment: the
        [off, off+blob_len) slice of gseq's assembly buffer, so the
        frame reader lands the bytes in place (zero-copy reassembly).
        None when the segment's geometry doesn't fit (corrupt/hostile
        frame: the caller falls back to a private buffer and the normal
        bounds-checked ingest)."""
        if (seg.total <= 0 or seg.total > (1 << 31) or seg.off < 0
                or seg.off + blob_len > seg.total
                or not (0 <= seg.idx < seg.nfrags <= 4096)):
            # implausible geometry (corrupt/hostile frame): refuse the
            # assembly allocation before the crc check can reject it
            return None
        with self._lock:
            st = self._frag_state(seg.gseq, seg.nfrags, seg.total)
            if st is None:
                return None
            if self._range_conflict(st, seg.idx, seg.off, blob_len):
                # overlaps a CONFIRMED fragment (or re-claims a consumed
                # idx): land in a private buffer instead — the crc check
                # will kill the corrupt frame without stomping verified
                # bytes, and a mere duplicate is dropped by _ingest
                return None
            return memoryview(st[4]).cast("B")[seg.off:seg.off + blob_len]

    def _frag_state(self, gseq: int, nfrags: int, total: int):
        """Under _lock: the reassembly entry for gseq, created if absent
        and the caps allow; None when refused (stale gseq, geometry
        mismatch, or the FRAG_MAX_* memory bounds)."""
        st = self._frags.get(gseq)
        if st is not None:
            return st if len(st[4]) == total else None
        if 0 < gseq < self._rx_next:
            # gseq already dispatched: a stale duplicate must not
            # re-open a completed (deleted) assembly
            return None
        if (len(self._frags) >= self.FRAG_MAX_ASSEMBLIES
                or self._frag_bytes + total > self.FRAG_MAX_BYTES):
            self.messenger.perf.inc("lane_frag_overflow")
            return None
        st = self._frags[gseq] = [0, [None] * nfrags, b"", True,
                                  np.empty(total, dtype=np.uint8), {}]
        self._frag_bytes += total
        return st

    @staticmethod
    def _range_conflict(st, idx: int, off: int, length: int) -> bool:
        """True when [off, off+length) overlaps a CONFIRMED fragment's
        bytes (or idx itself is already confirmed) — the guard that
        keeps a corrupt-geometry frame, whose blob lands BEFORE its crc
        is checked, from stomping verified regions of the assembly."""
        ranges = st[5]
        if idx in ranges:
            return True
        end = off + length
        for o, ln in ranges.values():
            if off < o + ln and o < end:
                return True
        return False

    def _frag_drop(self, gseq: int) -> None:
        st = self._frags.pop(gseq, None)
        if st is not None:
            self._frag_bytes -= len(st[4])

    def _ingest_fragment(self, conn: Connection, frag: Any):
        """Collect one MLaneSegment; returns the reassembled original
        message when complete, else None."""
        if frag.total <= 0 or frag.total > (1 << 31) \
                or not (0 < frag.nfrags <= 4096):
            return None
        st = self._frag_state(frag.gseq, frag.nfrags, frag.total)
        if st is None:
            return None
        seen, chunks, _hdr, ok, buf, ranges = st
        if 0 <= frag.idx < len(chunks) and chunks[frag.idx] is None:
            chunk = frag.chunk
            in_place = (isinstance(chunk, memoryview)
                        and chunk.obj is buf)
            nbytes = len(chunk)
            if not in_place:
                if frag.off < 0 or frag.off + nbytes > len(buf) \
                        or self._range_conflict(st, frag.idx, frag.off,
                                                nbytes):
                    # corrupt geometry: drop the fragment WITHOUT
                    # consuming its slot — a valid retransmission of
                    # this index must still be able to land
                    return None
                mv = chunk if isinstance(chunk, memoryview) \
                    else memoryview(as_bytes(chunk)
                                    if isinstance(chunk, BufferList)
                                    else chunk)
                if mv.ndim != 1 or mv.itemsize != 1:
                    mv = mv.cast("B")
                # single-fragment landing: the bounds/overlap guard above
                # already enforced everything the C-side guard would, and
                # one slice-assign is cheaper than a ctypes segment-list
                # round-trip (batched fragments ride the native drain)
                view = memoryview(buf).cast("B")
                view[frag.off:frag.off + mv.nbytes] = mv
            chunks[frag.idx] = True
            ranges[frag.idx] = (frag.off, nbytes)
            st[0] = seen = seen + 1
            if frag.header:
                st[2] = frag.header
            if not getattr(frag, "_wire_verified", False):
                st[3] = False
        if seen < len(chunks):
            return None
        self._frag_drop(frag.gseq)
        self.messenger.perf.inc("lane_frag_rx", len(chunks))
        msg = decode_message(frag.type_id, frag.version,
                             bytes(st[2]) if isinstance(st[2], (bytearray,
                                                                memoryview))
                             else st[2],
                             memoryview(st[4]).cast("B"), bool(frag.fixed))
        if st[3]:
            msg._wire_verified = True
        msg.gseq = frag.gseq
        return msg

    def _kick_pump(self) -> None:
        home = self.messenger.home_loop
        if home is None:
            try:
                home = asyncio.get_running_loop()
            except RuntimeError:
                return
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is home:
            self._ensure_pump()
        else:
            home.call_soon_threadsafe(self._ensure_pump)

    def _ensure_pump(self) -> None:
        if self._wake is None:
            self._wake = asyncio.Event()
        self._wake.set()
        if self._pump_task is None or self._pump_task.done():
            m = self.messenger
            self._pump_task = asyncio.get_running_loop().create_task(
                self._pump())
            m._tasks.add(self._pump_task)
            self._pump_task.add_done_callback(m._tasks.discard)

    async def _pump(self) -> None:
        """The group's single ordered dispatcher, on the home loop."""
        m = self.messenger
        while not self.closed and not m._shutdown:
            await self._wake.wait()
            self._wake.clear()
            while self._fifo and not self.closed and not m._shutdown:
                await self._pump_once(m)

    async def _pump_once(self, m: "Messenger") -> None:
        batch: list = []
        costs: list = []
        with self._lock:
            while self._fifo and len(batch) < m.RX_BATCH_MSGS:
                conn, msg, cost, cost_conn = self._fifo.popleft()
                batch.append((conn, msg))
                if cost:
                    costs.append((cost_conn, cost))
        if not batch:
            return
        try:
            if m.group_dispatcher is not None \
                    and (len(batch) > 1 or m.dispatcher is None):
                await m.group_dispatcher(self, [msg for _, msg in batch])
            elif m.dispatcher is not None:
                for _, msg in batch:
                    try:
                        await m.dispatcher(self, msg)
                    except (asyncio.CancelledError, GeneratorExit):
                        raise
                    except Exception:
                        traceback.print_exc()
        except (asyncio.CancelledError, GeneratorExit):
            raise
        except Exception:
            traceback.print_exc()
        finally:
            for conn, cost in costs:
                m._throttle_put(conn, cost)

    # -- lifecycle ------------------------------------------------------------

    def bind_lane(self, conn: Connection, lane: int) -> None:
        if 0 <= lane < self.n_lanes:
            self.lanes[lane] = conn
        conn.lane_group = self
        conn.lane_idx = lane

    async def close(self) -> None:
        self.closed = True
        for conn in self.lanes:
            if conn is not None:
                await self.messenger._conn_close(conn)
        if self._pump_task is not None:
            self._pump_task.cancel()
        # undispatched fifo entries still hold dispatch-throttle budget
        # (pump releases after dispatch): return it now or the shard's
        # receive path leaks it permanently under group churn
        with self._lock:
            entries = list(self._fifo)
            self._fifo.clear()
            self._parked.clear()
            self._frags.clear()
            self._frag_bytes = 0
        for _c, _m, cost, cost_conn in entries:
            if cost:
                self.messenger._throttle_put(cost_conn, cost)

    def dump(self) -> Dict[str, Any]:
        lanes = []
        for i, c in enumerate(self.lanes):
            if c is None:
                lanes.append({"lane": i, "state": "absent"})
                continue
            lanes.append({
                "lane": i, "state": "closed" if c.closed else "open",
                "control": i == 0,
                "outbox_frames": c._outbox_frames,
                "outbox_bytes": c._outbox_bytes,
                "unacked": len(c.unacked),
                "out_seq": c.out_seq, "in_seq": c.in_seq,
                "reactor": c.reactor.index if c.reactor is not None
                else None,
                # process mode: worker pid + per-shard shm-ring depths
                "shm": (c.reader.dump()
                        if isinstance(c.reader, ShmConnEndpoint)
                        else None)})
        with self._lock:
            parked = len(self._parked)
            fifo = len(self._fifo)
            frags = len(self._frags)
        return {"peer": list(self.peer), "group": self.group_id,
                "outbound": self.outbound, "n_lanes": self.n_lanes,
                "tx_gseq": self._tx_gseq, "rx_next": self._rx_next,
                "rx_parked": parked, "rx_fifo": fifo,
                "reassembling": frags, "lanes": lanes}


# -- messenger ---------------------------------------------------------------


class Messenger:
    """One per daemon.  dispatcher(conn, msg) is awaited per message
    (fast-dispatch style); receive-side bytes ride a dispatch throttle."""

    def __init__(self, name: str, conf: Optional[Any] = None,
                 entity_type: str = "client"):
        self.name = name
        self.conf = conf if conf is not None else {}
        self.entity_type = entity_type
        # resolve the frame checksum NOW (may g++-build the native
        # library, seconds): daemon construction, never the hot path
        checksum_kind()
        # native wirepath arm for this messenger (utils/wirepath.py):
        # the bridge module when the native hot loop resolved AND the
        # config allows it, else None (pure-python arm).  Resolved here
        # for the same reason as the checksum — never on the hot path.
        self.wirepath = (_wirepath.impl()
                         if bool(_cget(self.conf, "ms_wirepath_native",
                                       True)) else None)
        # the `wire` counter set (framing vs socket-io split; schema in
        # _build_wire_perf) — owning daemons add it to their collection
        self.perf = _build_wire_perf()
        self.perf.set("wirepath_kind", 1 if self.wirepath is not None
                      else 0)
        # gauge survives `perf reset` (bench/tests zero the window's
        # counters; the ARM doesn't change) — the resync hook restores
        # it, the service-plane gauge discipline
        self.perf.resync = lambda: self.perf.set(
            "wirepath_kind", 1 if self.wirepath is not None else 0)
        # per-daemon log (debug_ms levels): daemons attach their
        # Context's Log; raw messengers stay silent.  Per-frame douts are
        # call-site guarded with log.wants("ms", 20) so a disabled level
        # costs one cached compare on the hot path — turning up debug_ms
        # at runtime (asok / `ceph tell ... config set`) is the
        # diagnostic workflow.
        self.log = None
        self.dispatcher: Optional[Callable] = None
        # optional group-dispatch hook: group_dispatcher(conn, msgs) gets
        # a whole rx batch (frames that were already buffered) so the
        # daemon can hand stripe groups to the EC tier in one submit and
        # coalesce replies; falls back to per-message dispatcher when None
        self.group_dispatcher: Optional[Callable] = None
        self.server: Optional[asyncio.AbstractServer] = None
        self.addr: Optional[Tuple[str, int]] = None
        self._conns: Dict[Tuple[str, int], Connection] = {}
        self._conn_locks: Dict[Tuple[str, int], asyncio.Lock] = {}
        self._tasks: set = set()
        # reference defaults: clients are lossy, daemon peers lossless
        self.policies: Dict[str, Policy] = {
            "client": Policy.lossy_client(),
            "osd": Policy.lossless_peer(),
            "mon": Policy.lossless_peer(),
            "mgr": Policy.lossless_peer(),
        }
        self.dispatch_throttle = Throttle(
            f"{name}-dispatch", _cget(self.conf, "ms_dispatch_throttle_bytes", 100 << 20)
        )
        self._shutdown = False
        # cephx-lite state: this entity's service ticket + session key
        # (initiator side) and the rotating-secret keyring used to
        # validate presented tickets (acceptor side, daemons only)
        self.ticket: Optional[bytes] = None
        self.session_key: Optional[bytes] = None
        self.keyring = None  # Optional[TicketKeyring]
        # async callable: re-fetch rotating secrets on a validation miss
        # (a ticket sealed under a JUST-rotated secret must not be
        # refused until the periodic refresh happens to run)
        self.keyring_refresh: Optional[Callable] = None
        # session id -> session Connection, LRU-capped (peers come and go)
        self._sessions: "collections.OrderedDict[str, Connection]" = (
            collections.OrderedDict()
        )
        # colocated-daemon fast dispatch (LocalConnection): opt-in, and
        # only meaningful when BOTH endpoints run with it on
        self._local_fastpath = bool(
            _cget(self.conf, "ms_local_fastpath", False))
        self._local_conns: Dict[Tuple[str, int], LocalConnection] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # -- sharded multi-reactor wire plane (module docstring) -------------
        # the daemon's dispatch loop; reactor-owned serve loops hop here
        self.home_loop: Optional[asyncio.AbstractEventLoop] = None
        # reactor substrate: thread shards (r13) or forked worker
        # PROCESSES (ms_reactor_mode=process / CEPH_TPU_REACTOR=) whose
        # sockets run on truly independent cores, frames crossing via
        # shm rings into the home-loop dispatch pump (reactor_proc.py)
        mode = str(_cget(self.conf, "ms_reactor_mode", "thread")
                   or "thread").strip().lower()
        env_mode = os.environ.get("CEPH_TPU_REACTOR", "").strip().lower()
        if env_mode in ("thread", "process"):
            mode = env_mode
        elif env_mode in ("0", "off"):
            mode = "thread"
        if mode not in ("thread", "process"):
            mode = "thread"
        if mode == "process" and not hasattr(os, "fork"):
            mode = "thread"  # non-posix host: degrade, never fail
        self.reactor_mode = mode
        n_reactors = int(_cget(self.conf, "ms_async_op_threads", 0) or 0)
        if mode == "process" and n_reactors <= 0:
            n_reactors = 2  # process mode implies a pool
        self.reactors: Optional[ReactorPool] = (
            ReactorPool(name, n_reactors, mode=mode,
                        use_native=self.wirepath is not None)
            if n_reactors > 0 else None)
        self.shm_ring_bytes = int(
            _cget(self.conf, "ms_shm_ring_bytes", 4 << 20) or (4 << 20))
        self._conn_ids = itertools.count(1)
        # worker-process counters fold into this set at dump time
        self.perf.presample = self._refresh_proc_perf
        self.lanes_per_peer = max(1, int(
            _cget(self.conf, "ms_lanes_per_peer", 1) or 1))
        # colocated ring transport: negotiated at connect time; never
        # engaged under secure mode, configured auth, or socket-fault
        # injection (those configurations exist to exercise the real
        # wire, and authorization decisions key on how a peer proved
        # itself over it)
        self._ring_ok = bool(
            _cget(self.conf, "ms_colocated_ring", False)
            and not _cget(self.conf, "ms_secure_mode", False)
            and not _cget(self.conf, "ms_auth_secret", "")
            and not _cget(self.conf, "auth_cephx", False)
            and not _cget(self.conf, "ms_inject_socket_failures", 0))
        # live ring connections (both directions), for dump_reactors
        # and shutdown — acceptor-side rings are not in _conns
        self._ring_conns: list = []
        # acceptor-side lane groups, keyed by group id (LRU-capped with
        # the session table); guarded — lanes may land on reactor loops
        self._lane_groups: "collections.OrderedDict[str, LaneGroup]" = (
            collections.OrderedDict())
        self._lane_lock = threading.Lock()
        self._sessions_lock = threading.Lock()
        # per-reactor-loop dispatch throttles (Throttle futures are
        # loop-bound; backpressure is per shard)
        self._loop_throttles: Dict[Any, Throttle] = {}

    def policy_for(self, peer_type: str) -> Policy:
        return self.policies.get(peer_type, Policy.lossy_client())

    def dout(self, level: int, message: str) -> None:
        """debug_ms-leveled dout into the owning daemon's log (no-op on
        raw messengers).  Hot paths guard with ``self.log.wants`` first."""
        log = self.log
        if log is not None:
            log.dout("ms", level, message)

    # -- cross-loop plumbing (reactor plane) ---------------------------------

    def _throttle_here(self) -> Throttle:
        """Dispatch throttle for the CURRENT loop: the messenger-wide
        one on the home loop, a per-worker one on reactor loops."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return self.dispatch_throttle
        if self.home_loop is None or loop is self.home_loop:
            return self.dispatch_throttle
        t = self._loop_throttles.get(loop)
        if t is None:
            t = self._loop_throttles[loop] = Throttle(
                f"{self.name}-dispatch-shard",
                _cget(self.conf, "ms_dispatch_throttle_bytes", 100 << 20))
        return t

    def _throttle_put(self, conn, cost: int) -> None:
        """Return dispatch-throttle budget to ``conn``'s shard, from any
        loop (Throttle wakeups are loop-bound futures)."""
        if not cost:
            return
        loop = getattr(conn, "loop", None)
        throttle = getattr(conn, "throttle", None)
        if throttle is None:
            return
        try:
            here = asyncio.get_running_loop()
        except RuntimeError:
            here = None
        if loop is None or loop is here or loop.is_closed():
            throttle.put(cost)
        else:
            loop.call_soon_threadsafe(throttle.put, cost)

    async def _conn_send(self, conn, msg: Any) -> None:
        """Send on a connection that may live on another loop (its
        reactor shard): hop with run_coroutine_threadsafe, no-op hop for
        home-loop connections."""
        loop = getattr(conn, "loop", None)
        if loop is None or loop is asyncio.get_running_loop():
            await conn.send(msg)
            return
        fut = asyncio.run_coroutine_threadsafe(conn.send(msg), loop)
        await asyncio.wrap_future(fut)

    async def _conn_close(self, conn) -> None:
        loop = getattr(conn, "loop", None)
        try:
            here = asyncio.get_running_loop()
        except RuntimeError:
            here = None
        if loop is None or loop is here or loop.is_closed():
            await conn.close()
            return
        fut = asyncio.run_coroutine_threadsafe(conn.close(), loop)
        try:
            await asyncio.wait_for(asyncio.wrap_future(fut), timeout=1.0)
        except Exception:
            pass

    async def _dispatch_home(self, conn, msg: Any) -> None:
        """Invoke the daemon dispatcher on the HOME loop (daemon state is
        single-loop); serve loops on reactor shards hop here."""
        if self.dispatcher is None:
            return
        if self.home_loop is None \
                or self.home_loop is asyncio.get_running_loop():
            await self.dispatcher(conn, msg)
            return
        fut = asyncio.run_coroutine_threadsafe(
            self.dispatcher(conn, msg), self.home_loop)
        await asyncio.wrap_future(fut)

    async def _dispatch_group_home(self, conn, msgs: list) -> None:
        if self.group_dispatcher is None:
            return
        if self.home_loop is None \
                or self.home_loop is asyncio.get_running_loop():
            await self.group_dispatcher(conn, msgs)
            return
        fut = asyncio.run_coroutine_threadsafe(
            self.group_dispatcher(conn, msgs), self.home_loop)
        await asyncio.wrap_future(fut)

    # -- process-sharded reactor plane (delegation seam) ---------------------

    def _delegatable(self) -> bool:
        return (self.reactors is not None
                and self.reactors.mode == "process")

    def _crc_mode_for(self, crc_fn, crc_enabled: bool) -> str:
        if not crc_enabled:
            return "off"
        return "shared" if crc_fn is checksum else "zlib"

    def _delegate_transport(self, reader, writer, worker, crc_fn,
                            crc_enabled: bool):
        """Hand a live plaintext transport to a reactor worker PROCESS:
        extract the raw socket + any already-buffered rx bytes, build
        the shm ring pair, send the fd over the worker's ctrl channel,
        and close the parent's copy (the worker's dup now OWNS the
        socket — worker death = transport death, the revival signal).
        Returns (reader, writer) shm endpoints, or None when this
        transport can't delegate (secure stream, no raw socket, pending
        tx bytes, worker unavailable) — the caller keeps the in-process
        transport, a graceful fallback never an error."""
        pool = self.reactors
        if not self._delegatable() or not pool.ensure_worker(worker):
            return None
        # raw socket extraction (plaintext only — a SecureStream has no
        # transport to hand across; delegation happens below the AES
        # layer or not at all)
        if isinstance(writer, CorkedWriter):
            transport, sock = writer._transport, writer._sock
            if writer._buffered:
                return None  # unsent segments would interleave
        elif isinstance(writer, asyncio.StreamWriter):
            transport = writer.transport
            sock = transport.get_extra_info("socket") \
                if transport is not None else None
            sock = getattr(sock, "_sock", sock)
        else:
            return None
        if transport is None or sock is None or transport.is_closing():
            return None
        try:
            if transport.get_write_buffer_size() != 0:
                return None  # buffered tx would race the worker's writes
        except Exception:
            return None
        # leftover rx bytes: captured only after the ctrl handoff
        # succeeds, so a failed delegation leaves the reader intact
        if isinstance(reader, FrameReceiver):
            leftover = bytes(memoryview(reader._pending)[reader._off:])
        elif isinstance(reader, asyncio.StreamReader):
            leftover = bytes(reader._buffer)
        else:
            return None
        try:
            transport.pause_reading()
        except Exception:
            pass
        conn_id = next(self._conn_ids)
        try:
            ep = delegate_socket(worker, conn_id, sock.fileno(), leftover,
                                 self.shm_ring_bytes,
                                 self._crc_mode_for(crc_fn, crc_enabled),
                                 wp=self.wirepath, perf=self.perf)
        except OSError:
            ep = None
        if ep is None:
            try:
                transport.resume_reading()
            except Exception:
                pass
            return None
        # handoff complete: the worker owns a dup of the fd.  Clear the
        # captured bytes from the parent reader and close our copy.
        if isinstance(reader, FrameReceiver):
            reader._pending.clear()
            reader._off = 0
        else:
            reader._buffer.clear()
        if isinstance(writer, CorkedWriter):
            writer._detach()
        try:
            transport.close()
        except Exception:
            pass
        # proc_delegated_conns has ONE owner: the presample refresh
        # (worker.sockets tally) — no inc here, two sources would drift
        self.dout(4, f"conn {conn_id} delegated to reactor worker "
                     f"{worker.index} (pid {worker.pid})")
        return ep, ep

    async def _delegate_conn(self, conn: "Connection", lane: int) -> None:
        """Delegate a LIVE connection (acceptor side, right after its
        MLaneHello bound it into a lane group).  Runs under the send
        lock so an in-flight flush window can't race the writer swap;
        the caller is the connection's own serve loop, so no reader
        race exists."""
        if isinstance(conn.reader, ShmConnEndpoint) or conn.closed:
            return
        worker = self.reactors.worker_for(conn.peer, lane)
        async with conn._send_lock:
            if conn.closed or isinstance(conn.reader, ShmConnEndpoint):
                return
            pair = self._delegate_transport(conn.reader, conn.writer,
                                            worker, conn.crc_fn,
                                            conn.crc_enabled)
            if pair is None:
                return
            conn.reader, conn.writer = pair
            conn.shm_worker = worker

    def _accepted_fd_cb(self, fd: int, worker) -> None:
        """A worker's accept loop forwarded a fresh inbound socket: run
        the normal handshake/accept path on the home loop (auth,
        session resume and ring negotiation need parent state)."""
        loop = self.home_loop
        if loop is None or loop.is_closed() or self._shutdown:
            try:
                os.close(fd)
            except OSError:
                pass
            return

        async def _adopt():
            try:
                sock = socket_mod.socket(fileno=fd)
            except OSError:
                try:
                    os.close(fd)
                except OSError:
                    pass
                return
            try:
                sock.setblocking(False)
                reader, writer = await asyncio.open_connection(sock=sock)
            except OSError:
                # close via the OBJECT (it owns the fd now): a raw
                # os.close here would double-close a number the socket
                # destructor closes again later — onto whoever reused it
                sock.close()
                return
            await self._accept(reader, writer)

        def _spawn():
            # runs ON the home loop (call_soon_threadsafe below)
            t = asyncio.get_running_loop().create_task(_adopt())
            self._tasks.add(t)
            t.add_done_callback(self._tasks.discard)

        loop.call_soon_threadsafe(_spawn)

    def _refresh_proc_perf(self) -> None:
        """perf presample hook: fold the worker processes' counter
        blocks into the wire set so the daemon's `perf dump` (and with
        it /metrics and BENCH) reports the WHOLE reactor plane."""
        pool = self.reactors
        if pool is None or pool.mode != "process":
            return
        agg = pool.counters_sum()
        if not agg:
            return
        p = self.perf
        p.set("proc_workers",
              sum(1 for w in pool.workers if w.is_alive()))
        p.set("proc_delegated_conns",
              sum(w.sockets for w in pool.workers))
        p.set("proc_worker_respawns",
              sum(w.respawns for w in pool.workers))
        p.set("proc_rx_frames", agg.get("rx_frames", 0))
        p.set("proc_rx_bytes", agg.get("rx_bytes", 0))
        p.set("proc_tx_calls", agg.get("tx_calls", 0))
        p.set("proc_tx_bytes", agg.get("tx_bytes", 0))
        p.set("proc_native_rx_calls", agg.get("native_rx_calls", 0))
        p.set("proc_native_tx_calls", agg.get("native_tx_calls", 0))
        p.set("proc_native_bytes", agg.get("native_bytes", 0))

    # -- wire accounting -----------------------------------------------------

    def _note_tx(self, type_name: str, nbytes: int, framing_s: float) -> None:
        # tx_bytes is NOT counted here: _write_raw owns it, so acks and
        # session replays land in the socket totals too
        p = self.perf
        p.inc("tx_msgs")
        p.tinc("tx_framing", framing_s)
        p.ensure(f"tx_{type_name}", desc=f"{type_name} messages sent")
        p.ensure(f"tx_bytes_{type_name}", desc=f"{type_name} bytes sent")
        p.inc(f"tx_{type_name}")
        p.inc(f"tx_bytes_{type_name}", nbytes)

    def _note_rx(self, type_name: str, nbytes: int, framing_s: float) -> None:
        p = self.perf
        p.inc("rx_msgs")
        p.tinc("rx_framing", framing_s)
        p.ensure(f"rx_{type_name}", desc=f"{type_name} messages dispatched")
        p.ensure(f"rx_bytes_{type_name}",
                 desc=f"{type_name} bytes received")
        p.inc(f"rx_{type_name}")
        p.inc(f"rx_bytes_{type_name}", nbytes)

    # -- handshake -----------------------------------------------------------

    def _auth_tag(self, nonce: bytes, key: Optional[bytes] = None,
                  transcript: bytes = b"") -> str:
        """HMAC proof over a handshake nonce + negotiated-mode transcript:
        with a ticket session key when one is in play (cephx role), else
        the cluster bootstrap secret.  Binding the transcript (the secure
        flags both sides sent) into the tag makes mode-stripping by an
        active MITM detectable — the reference binds the negotiated mode
        into msgr2's signed handshake payload the same way."""
        if key is not None:
            return hmac.new(key, nonce + transcript, hashlib.sha256).hexdigest()
        secret = str(_cget(self.conf, "ms_auth_secret", "") or "")
        if not secret:
            return ""
        return hmac.new(secret.encode(), nonce + transcript,
                        hashlib.sha256).hexdigest()

    @staticmethod
    def _mode_transcript(initiator_secure: bool, acceptor_secure: bool) -> bytes:
        return f"|mode:i{int(bool(initiator_secure))}a{int(bool(acceptor_secure))}".encode()

    def _secure_key(self, session_key: Optional[bytes],
                    nonce_a: bytes, nonce_b: bytes) -> Optional[bytes]:
        """Key material for AES-GCM on-wire mode: the ticket session key,
        else a key derived from the cluster secret and both nonces."""
        if session_key is not None:
            return session_key
        secret = str(_cget(self.conf, "ms_auth_secret", "") or "")
        if not secret:
            return None
        return hmac.new(secret.encode(), b"onwire" + nonce_a + nonce_b,
                        hashlib.sha256).digest()

    def _wrap_secure(self, reader, writer, key: bytes):
        from ceph_tpu_torch.rados.auth import SecureStream

        s = SecureStream(reader, writer, key)
        return s, s

    async def _handshake_out(self, reader, writer, lossless: bool,
                             session_id: str, want_ring: bool = False):
        """Returns (peer_name, resumed, peer_ckind, lanes_ok, ring_id,
        reader, writer) — the pair is AES-GCM wrapped when secure mode
        was negotiated.  ``lanes_ok`` says the acceptor understands the
        multi-lane plane (old peers fall back to one lane); ``ring_id``
        is non-empty when the acceptor offered a colocated in-process
        ring (its fin carries the id; see reactor.py)."""
        secure_want = bool(_cget(self.conf, "ms_secure_mode", False))
        writer.write(BANNER)
        nonce = random.randbytes(16)
        hello = {"name": self.name, "type": self.entity_type,
                 "nonce": nonce.hex(), "auth": "",
                 "session": session_id, "lossless": lossless,
                 "secure": secure_want, "ckind": checksum_kind(),
                 "proc": PROC_TOKEN, "ring": bool(want_ring),
                 "lanes_ok": True}
        if self.ticket is not None:
            hello["ticket"] = self.ticket.hex()
        writer.write(json.dumps(hello).encode() + b"\n")
        await writer.drain()
        banner = await reader.readexactly(len(BANNER))
        if banner != BANNER:
            raise BadFrame("bad banner from peer")
        peer_hello = json.loads(await reader.readline())
        key = self.session_key if self.ticket is not None else None
        # both secure flags ride the HMAC material: a stripped flag makes
        # the tags disagree instead of silently downgrading to plaintext
        transcript = self._mode_transcript(secure_want,
                                           peer_hello.get("secure", False))
        # acceptor proves knowledge of the secret (or of OUR ticket's
        # session key, which only rotating-secret holders can open) by
        # tagging OUR nonce
        expect = self._auth_tag(nonce, key, transcript)
        if expect and not hmac.compare_digest(peer_hello.get("auth", ""), expect):
            raise PermissionError("peer failed auth (bad cluster secret)")
        # then we prove ourselves by tagging THEIR nonce
        try:
            their_nonce = bytes.fromhex(peer_hello.get("nonce", ""))
        except ValueError:
            raise BadFrame("garbled nonce in peer hello") from None
        tag = self._auth_tag(their_nonce, key, transcript)
        writer.write(json.dumps({"auth": tag}).encode() + b"\n")
        await writer.drain()
        fin = json.loads(await reader.readline())
        if not fin.get("ok", False):
            raise PermissionError("peer rejected our auth")
        if secure_want:
            # ms_secure_mode is a REQUIREMENT, not a preference: ending up
            # on plaintext (peer refused, or no key material to derive a
            # session key from) is a failed connection, never a downgrade
            skey = (self._secure_key(key, nonce, their_nonce)
                    if peer_hello.get("secure") else None)
            if skey is None:
                raise PermissionError(
                    "ms_secure_mode set but connection would be plaintext")
            reader, writer = self._wrap_secure(reader, writer, skey)
        return (peer_hello.get("name", ""), bool(peer_hello.get("resumed")),
                peer_hello.get("ckind", "zlib"),
                bool(peer_hello.get("lanes_ok")),
                str(fin.get("ring", "") or ""), reader, writer)

    async def _handshake_in(self, reader, writer):
        """Returns (peer_name, peer_type, session, lossless, auth_kind,
        auth_entity_type, reader, writer) — the pair is AES-GCM wrapped
        when secure mode was negotiated.  ``auth_kind`` records HOW the
        peer proved itself ("ticket", "secret", or "none"): authorization
        decisions (e.g. who may fetch the rotating service secrets) key on
        it, not on the peer's self-declared type."""
        secure_want = bool(_cget(self.conf, "ms_secure_mode", False))
        banner = await reader.readexactly(len(BANNER))
        if banner != BANNER:
            raise BadFrame("bad banner from peer")
        peer_hello = json.loads(await reader.readline())
        writer.write(BANNER)
        nonce = random.randbytes(16)
        their_nonce = bytes.fromhex(peer_hello.get("nonce", ""))
        key: Optional[bytes] = None
        auth_kind = "none"
        auth_entity_type = ""
        ticket_hex = peer_hello.get("ticket", "")
        if ticket_hex and self.keyring is not None:
            tkt = self.keyring.validate(bytes.fromhex(ticket_hex))
            if tkt is None and self.keyring_refresh is not None:
                # maybe sealed under a rotation we haven't fetched yet
                try:
                    await asyncio.wait_for(self.keyring_refresh(), timeout=2.0)
                except Exception:
                    pass
                tkt = self.keyring.validate(bytes.fromhex(ticket_hex))
            if tkt is None:
                # a PRESENTED ticket must verify: silently falling back to
                # the shared-secret path would let an expired/forged
                # ticket ride a daemon's bootstrap credentials
                writer.write(json.dumps({"ok": False}).encode() + b"\n")
                await writer.drain()
                raise PermissionError(
                    f"invalid ticket from {peer_hello.get('name')}")
            key = tkt["session_key"]
            auth_kind = "ticket"
            auth_entity_type = tkt.get("type", "")
        # tell the initiator whether we still hold its session: if not, it
        # must reset its reply-dedupe floor (our out_seq restarts at 1)
        resumed = peer_hello.get("session", "") in self._sessions
        transcript = self._mode_transcript(peer_hello.get("secure", False),
                                           secure_want)
        hello = {"name": self.name, "type": self.entity_type,
                 "nonce": nonce.hex(),
                 "auth": self._auth_tag(their_nonce, key, transcript),
                 "resumed": resumed, "secure": secure_want,
                 "ckind": checksum_kind(),
                 "proc": PROC_TOKEN, "lanes_ok": True}
        writer.write(json.dumps(hello).encode() + b"\n")
        await writer.drain()
        proof = json.loads(await reader.readline())
        expect = self._auth_tag(nonce, key, transcript)
        ok = not expect or hmac.compare_digest(proof.get("auth", ""), expect)
        # colocated ring offer (reactor.py): only to an AUTHENTICATED
        # peer that shares our process token and asked for one — the fin
        # carries the ring id the initiator claims from the in-process
        # registry.  Never under secure mode (the wire security applies
        # to wires; a colocated ring has none, but the configuration
        # asked to exercise the secured path).
        ring_offered: Optional[Tuple[str, Any, Any]] = None
        fin: Dict[str, Any] = {"ok": ok}
        if (ok and self._ring_ok and not secure_want
                and peer_hello.get("ring")
                and peer_hello.get("proc") == PROC_TOKEN):
            ring_id, rx, tx = ring_offer()
            ring_offered = (ring_id, rx, tx)
            fin["ring"] = ring_id
        writer.write(json.dumps(fin).encode() + b"\n")
        await writer.drain()
        if not ok:
            raise PermissionError(f"auth failed for peer {peer_hello.get('name')}")
        if expect and auth_kind == "none":
            auth_kind = "secret"  # peer proved the cluster bootstrap secret
        if secure_want:
            # required, not best-effort (see _handshake_out)
            skey = (self._secure_key(key, their_nonce, nonce)
                    if peer_hello.get("secure") else None)
            if skey is None:
                raise PermissionError(
                    "ms_secure_mode set but connection would be plaintext")
            reader, writer = self._wrap_secure(reader, writer, skey)
        return (peer_hello.get("name", ""), peer_hello.get("type", "client"),
                peer_hello.get("session", ""), bool(peer_hello.get("lossless")),
                auth_kind, auth_entity_type,
                peer_hello.get("ckind", "zlib"), ring_offered,
                reader, writer)

    # -- lifecycle -----------------------------------------------------------

    async def disconnect(self, addr) -> None:
        """Drop the live outbound connection to ``addr`` (if any): the
        next send re-dials and re-runs the handshake — used when the
        credentials the old handshake was built on changed (e.g. a ticket
        was dropped to force bootstrap-secret auth)."""
        key = tuple(addr)
        conn = self._conns.pop(key, None)
        if conn is not None:
            await conn.close()

    async def bind(self, host: str = "127.0.0.1", port: int = 0) -> Tuple[str, int]:
        self.home_loop = asyncio.get_running_loop()
        self.server = await asyncio.start_server(self._accept, host, port)
        self.addr = self.server.sockets[0].getsockname()[:2]
        if self.reactors is not None:
            self.reactors.log = self.log
            # shard the listening socket across the reactor workers:
            # inbound sockets are owned by whichever reactor accepts
            self.reactors.start()
            try:
                if self.reactors.mode == "process":
                    # worker processes accept on dup'd listening fds
                    # and forward fresh sockets here for the handshake
                    self.reactors.serve_shards_process(
                        self.server.sockets[0], self._accepted_fd_cb)
                else:
                    await self.reactors.serve_shards(
                        self.server.sockets[0], self._accept)
            except (OSError, NotImplementedError):
                pass  # platform without dup'd-fd accept: home loop only
        if self._local_fastpath:
            self._loop = asyncio.get_running_loop()
            _LOCAL_REGISTRY[tuple(self.addr)] = self
        self.dout(1, f"bind {self.addr[0]}:{self.addr[1]} (reactors "
                     f"{self.reactors.n_workers if self.reactors else 0}, "
                     f"lanes/peer {self.lanes_per_peer})")
        return self.addr

    @staticmethod
    def _negotiated_crc(peer_ckind: str):
        """Per-connection frame checksum: the fast shared resolver when
        both ends resolved the same KIND, zlib (which every build has)
        when they differ — a per-host native-build failure must degrade,
        never loop every frame through BadFrame."""
        return checksum if peer_ckind == checksum_kind() else zlib.crc32

    async def _accept(self, reader, writer) -> None:
        peer = writer.get_extra_info("peername")[:2]
        task = asyncio.current_task()
        self._tasks.add(task)
        try:
            try:
                (peer_name, peer_type, cookie, lossless, auth_kind,
                 auth_entity_type, peer_ckind, ring_offered,
                 reader, writer) = await self._handshake_in(reader, writer)
            except (PermissionError, BadFrame, ConnectionError, json.JSONDecodeError,
                    asyncio.IncompleteReadError, ValueError):
                writer.close()
                return
            if ring_offered is not None:
                # colocated ring negotiated: the TCP socket's job is
                # done — serve the in-process ring instead
                ring_id, rx, tx = ring_offered
                rconn = RingConnection(self, peer, peer_name, rx, tx,
                                       outbound=False,
                                       auth_entity_type=auth_entity_type)
                self._ring_conns.append(rconn)
                rconn.start_pump()
                try:
                    writer.close()
                except Exception:
                    pass
                return
            evicted_conns = []
            if lossless and cookie:
                with self._sessions_lock:
                    conn = self._sessions.get(cookie)
                    if conn is not None:
                        self._sessions.move_to_end(cookie)
                    else:
                        conn = Connection(self, reader, writer, peer,
                                          Policy.lossless_peer(), peer_name)
                        self._sessions[cookie] = conn
                        while len(self._sessions) > MAX_SESSIONS:
                            _, ev = self._sessions.popitem(last=False)
                            evicted_conns.append(ev)
                for ev in evicted_conns:
                    await self._conn_close(ev)
                here = asyncio.get_running_loop()
                if conn.reader is not reader \
                        and conn.loop not in (None, here):
                    # session reconnect landed on a different reactor
                    # shard than the session's owner: migrate the fresh
                    # socket to the owning loop (transports and the
                    # session's replay machinery are loop-bound)
                    conn.auth_kind = auth_kind
                    conn.auth_entity_type = auth_entity_type
                    pair = await self._migrate_transport(reader, writer,
                                                         conn.loop)
                    if pair is None:
                        # unmigratable (secure stream / dead socket):
                        # forget the session — the initiator's next dial
                        # starts a fresh one (reqid dedupe above absorbs
                        # the at-least-once window, acceptor-restart rule)
                        with self._sessions_lock:
                            if self._sessions.get(cookie) is conn:
                                self._sessions.pop(cookie, None)
                        await self._conn_close(conn)
                        return
                    r2, w2 = pair
                    conn.crc_fn = self._negotiated_crc(peer_ckind)

                    async def _adopt_and_serve():
                        await conn.adopt_transport(r2, w2)
                        await self._serve(conn)

                    fut = asyncio.run_coroutine_threadsafe(
                        _adopt_and_serve(), conn.loop)
                    await asyncio.wrap_future(fut)
                    return
                if conn.reader is not reader:
                    # session reconnect: adopt the new socket, replay our
                    # un-acked frames (e.g. replies lost in the drop)
                    pair = None
                    if (self._delegatable() and conn.lane_group is not None
                            and conn.lane_idx >= 1):
                        # revived acceptor-side data lane: its byte work
                        # goes back to a worker process (pending replies
                        # replay through the ring inside adopt)
                        w = self.reactors.worker_for(conn.peer,
                                                     conn.lane_idx)
                        pair = self._delegate_transport(
                            reader, writer, w,
                            self._negotiated_crc(peer_ckind),
                            conn.crc_enabled)
                        if pair is not None:
                            reader, writer = pair
                            conn.shm_worker = w
                    try:
                        await conn.adopt_transport(reader, writer)
                    except BaseException:
                        if pair is not None:
                            pair[0].close()
                        raise
            else:
                conn = Connection(self, reader, writer, peer,
                                  Policy.lossy_client(), peer_name)
            # how the peer proved itself, for authorization decisions
            # (refreshed on every reconnect handshake)
            conn.auth_kind = auth_kind
            conn.auth_entity_type = auth_entity_type
            conn.crc_fn = self._negotiated_crc(peer_ckind)
            if conn.reactor is None and self.reactors is not None:
                try:
                    conn.reactor = next(
                        w for w in self.reactors.workers
                        if w.loop is asyncio.get_running_loop())
                    conn.reactor.sockets += 1
                except StopIteration:
                    pass
            await self._serve(conn)
        finally:
            self._tasks.discard(task)

    async def _migrate_transport(self, reader, writer, target_loop):
        """Move a freshly-accepted plaintext socket to another loop:
        dup the fd, close the local transport (the dup keeps the socket
        open), rebuild the stream pair on the target loop with any
        already-buffered bytes carried over.  Returns (reader, writer)
        on the target loop, or None when the socket can't be migrated."""
        if not isinstance(reader, asyncio.StreamReader):
            return None  # SecureStream: no raw transport to migrate
        transport = writer.transport
        try:
            transport.pause_reading()
        except Exception:
            pass
        leftover = bytes(reader._buffer)
        reader._buffer.clear()
        sock = transport.get_extra_info("socket")
        sock = getattr(sock, "_sock", sock)
        try:
            dup = sock.dup()
            dup.setblocking(False)
        except Exception:
            return None
        transport.close()

        async def _attach():
            r, w = await asyncio.open_connection(sock=dup)
            if leftover:
                # no await between open and feed: the new transport has
                # not had a chance to deliver socket bytes yet, so the
                # leftover keeps its position at the front of the stream
                r.feed_data(leftover)
            return r, w

        fut = asyncio.run_coroutine_threadsafe(_attach(), target_loop)
        try:
            return await asyncio.wait_for(asyncio.wrap_future(fut),
                                          timeout=2.0)
        except Exception:
            try:
                dup.close()
            except Exception:
                pass
            return None

    # rx batch budget: how many already-buffered frames one dispatch
    # round may drain before acking (bounds latency of the first ack and
    # the throttle bytes held across a group dispatch)
    RX_BATCH_MSGS = 32
    RX_BATCH_BYTES = 32 << 20

    @staticmethod
    def _buffered_frame_len(reader) -> Optional[int]:
        """Payload length of a COMPLETE frame (header + payload) already
        buffered on the reader, else None — the rx batching predicate:
        batch only what needs no further network wait, so a half-arrived
        frame never stalls dispatch of messages already in hand."""
        try:
            if isinstance(reader, FrameReceiver):
                buf, off = reader._pending, reader._off
            elif isinstance(reader, asyncio.StreamReader):
                buf, off = reader._buffer, 0
            else:  # SecureStream
                buf, off = reader._buf, 0
            avail = len(buf) - off
            if avail < _HDR.size:
                return None
            (length,) = struct.unpack_from("<I", buf, off)
            return length if avail >= _HDR.size + length else None
        except (AttributeError, struct.error):
            return None

    async def _serve(self, conn: Connection) -> None:
        gen = conn.transport_gen
        conn.enable_fast_read()
        try:
            while not conn.closed and conn.transport_gen == gen:
                # drain every frame ALREADY buffered into one batch: one
                # dispatch round, one cumulative ack — under a sub-write
                # burst or an op-reply flood the per-message standalone
                # ack (and its flush) collapses into one frame
                batch: list = []  # (seq, msg)
                costs: list = []
                top_seq = 0
                try:
                    while (len(batch) < self.RX_BATCH_MSGS
                           and sum(costs) < self.RX_BATCH_BYTES):
                        if batch:
                            nxt = conn.buffered_frame_len()
                            if nxt is None or not \
                                    conn.throttle.would_admit(nxt):
                                # nothing fully buffered, or the throttle
                                # would BLOCK — and its budget only
                                # returns after dispatch, which this
                                # batch still owes (self-deadlock)
                                break
                        (type_id, version, seq, payload, cost,
                         blob, fixed, verified) = await conn.read_frame()
                        if conn.transport_gen != gen:
                            conn.throttle.put(cost)
                            return  # transport replaced while suspended
                        if type_id == ACK_TYPE:
                            conn.handle_ack(struct.unpack("<Q", payload)[0])
                            conn.throttle.put(cost)
                            continue
                        if seq and seq <= conn.in_seq:
                            # replayed duplicate: re-ack (the original ack
                            # may have been lost) but don't re-dispatch
                            conn.queue_ack(seq)
                            conn.throttle.put(cost)
                            continue
                        try:
                            t_dec = time.monotonic()
                            msg = decode_message(type_id, version, payload,
                                                 blob, fixed)
                            if verified:
                                # the frame layer checked the blob's crc:
                                # handlers holding an app-level crc of the
                                # same bytes skip their own pass
                                msg._wire_verified = True
                            self._note_rx(type(msg).__name__,
                                          _HDR.size + cost,
                                          time.monotonic() - t_dec)
                            if conn.reactor is not None:
                                conn.reactor.rx_msgs += 1
                            log = self.log
                            if log is not None and log.wants("ms", 20):
                                # per-frame rx trace: debug_ms 20 only
                                # (the wants() guard keeps the hot path
                                # at one cached compare)
                                log.dout(
                                    "ms", 20,
                                    f"rx {type(msg).__name__} seq={seq} "
                                    f"{cost}B from {conn.peer[0]}:"
                                    f"{conn.peer[1]}")
                        except Exception as e:
                            # undecodable (type/version skew): poison-
                            # discard so replay can't redeliver it forever
                            print(f"messenger {self.name}: dropping "
                                  f"undecodable frame type={type_id} "
                                  f"v={version}: {e}")
                            if seq:
                                conn.in_seq = seq
                                conn.queue_ack(seq)
                            conn.throttle.put(cost)
                            continue
                        if isinstance(msg, MLaneHello):
                            # lane negotiation frame: messenger-internal
                            # — binds this connection into its lane
                            # group, never reaches the daemon
                            self._bind_lane(conn, msg)
                            if seq:
                                conn.in_seq = max(conn.in_seq, seq)
                                conn.queue_ack(seq)
                            conn.throttle.put(cost)
                            if msg.lane >= 1 and self._delegatable():
                                # process mode: a freshly bound DATA
                                # lane's socket moves to its worker
                                # process; this serve loop keeps
                                # running, now pulling records off the
                                # shm ring instead of the socket
                                await self._delegate_conn(conn, msg.lane)
                            continue
                        if conn.lane_group is not None:
                            # striped session: the LaneGroup restores
                            # gseq order, reassembles fragments, and
                            # dispatches through its single pump — ack
                            # per frame (the flush window coalesces)
                            if seq:
                                conn.in_seq = max(conn.in_seq, seq)
                                conn.queue_ack(seq)
                            conn.lane_group.rx_push(conn, msg, cost)
                            continue
                        batch.append((seq, msg))
                        costs.append(cost)
                        if seq:
                            top_seq = max(top_seq, seq)
                    if not batch:
                        continue
                    if len(batch) > 1:
                        self.perf.inc("rx_batches")
                        self.perf.hinc("rx_batch_msgs", len(batch))
                    try:
                        if self.group_dispatcher is not None \
                                and (len(batch) > 1
                                     or self.dispatcher is None):
                            # whole-group handoff: the daemon partitions
                            # the batch itself (stripe groups to the EC
                            # tier in one submit, coalesced replies).
                            # Singletons also route here when no plain
                            # dispatcher is installed — a group-only
                            # daemon must not have isolated frames
                            # consumed-and-acked undispatched.
                            await self._dispatch_group_home(
                                conn, [m for _, m in batch])
                        elif self.dispatcher is not None:
                            for _, msg in batch:
                                try:
                                    await self._dispatch_home(conn, msg)
                                except (asyncio.CancelledError,
                                        GeneratorExit):
                                    raise
                                except Exception:
                                    # a dispatcher bug must not wedge the
                                    # session into infinite redelivery
                                    traceback.print_exc()
                    except (asyncio.CancelledError, GeneratorExit):
                        raise
                    except Exception:
                        traceback.print_exc()
                    # ack AFTER dispatch: an ack'd frame is a consumed
                    # frame; one cumulative ack covers the whole batch
                    if top_seq:
                        conn.in_seq = max(conn.in_seq, top_seq)
                        conn.queue_ack(top_seq)
                finally:
                    for c in costs:
                        conn.throttle.put(c)
        except (asyncio.IncompleteReadError, ConnectionError, BadFrame):
            pass
        finally:
            await conn.close(gen)
            if conn.closed:
                self.dout(1, f"connection {conn.peer[0]}:{conn.peer[1]} "
                             f"({conn.peer_name or '?'}) closed"
                             + (" [lane]" if conn.lane_group is not None
                                else ""))
            group = conn.lane_group
            if group is not None:
                # lane death: a LOSSLESS lane revives in place (its
                # unacked frames — and only its — replay on the fresh
                # transport while the other lanes keep draining); a
                # lossy lane group dies wholesale, like a lossy conn
                if (conn.outbound and conn.closed and not self._shutdown
                        and not group.closed):
                    coro = (self._revive_lane(group, conn)
                            if conn.policy.replay
                            else self._group_fatal(group))
                    t = asyncio.get_running_loop().create_task(coro)
                    self._tasks.add(t)
                    t.add_done_callback(self._tasks.discard)
            # lossless sessions reconnect from the initiator side so queued
            # frames (ours AND the acceptor's pending replies) replay even
            # when no further application send would trigger it
            elif (conn.outbound and conn.policy.replay and conn.closed
                    and not self._shutdown):
                t = asyncio.get_running_loop().create_task(self._reconnect(conn))
                self._tasks.add(t)
                t.add_done_callback(self._tasks.discard)

    async def _reconnect(self, conn: Connection) -> None:
        delay = 0.02
        for _ in range(10):
            await asyncio.sleep(delay)
            delay = min(delay * 2, 1.0)
            if self._shutdown or self._conns.get(conn.peer) is not conn:
                return
            if not conn.closed:
                return  # something else already revived it
            try:
                await self.connect(conn.peer)
                return
            except (ConnectionError, OSError):
                continue
        # peer looks gone for good: forget the session (the cluster map's
        # failure detection is responsible for marking it down)
        if self._conns.get(conn.peer) is conn:
            self._conns.pop(conn.peer, None)

    # -- lane plane ----------------------------------------------------------

    def _bind_lane(self, conn: Connection, m: "MLaneHello") -> None:
        """Acceptor side of lane negotiation: an MLaneHello (first frame
        on every lane) attaches the carrying connection to its group,
        creating the group on lane 0's hello."""
        evicted = []
        with self._lane_lock:
            group = self._lane_groups.get(m.group)
            if group is None:
                group = LaneGroup(self, conn.peer, m.group,
                                  max(2, m.n_lanes), outbound=False,
                                  policy=conn.policy)
                self._lane_groups[m.group] = group
                while len(self._lane_groups) > MAX_SESSIONS:
                    _, old = self._lane_groups.popitem(last=False)
                    evicted.append(old)
            else:
                self._lane_groups.move_to_end(m.group)
        for old in evicted:
            # full close on the home loop (lanes + pump + queued
            # throttle costs), not just a flag — _bind_lane may run on
            # a reactor serve loop, so hop
            old.closed = True
            home = self.home_loop
            if home is not None and not home.is_closed():
                home.call_soon_threadsafe(
                    lambda g=old: home.create_task(g.close()))
        self.dout(4, f"lane {m.lane}/{m.n_lanes} bound for group "
                     f"{m.group[:8]} from {conn.peer[0]}:{conn.peer[1]}")
        group.bind_lane(conn, m.lane)

    async def _revive_lane(self, group: LaneGroup, conn: Connection) -> None:
        """Initiator-side failover for one dead lossless lane: redial on
        the lane's own loop (the stable worker hash put us here), adopt
        the fresh transport into the SAME lane session — its pinned
        unacked frames (and only its) replay; the gseq reorder buffer on
        the far side absorbs the refilled hole.  An acceptor that lost
        the lane session (restart/eviction) is group-fatal: per-lane
        dedupe floors can't be trusted across it, so the whole group is
        torn down and the next send dials a fresh one."""
        key = (id(conn),)
        if key in group._reviving:
            return
        group._reviving.add(key)
        try:
            delay = 0.02
            for _ in range(10):
                await asyncio.sleep(delay)
                delay = min(delay * 2, 1.0)
                if self._shutdown or group.closed:
                    return
                if not conn.closed:
                    return  # already revived
                try:
                    reader, writer = await asyncio.open_connection(
                        *group.peer)
                except (ConnectionError, OSError):
                    continue
                try:
                    (peer_name, resumed, peer_ckind, lanes_ok, ring_id,
                     reader, writer) = await self._handshake_out(
                        reader, writer, True, conn.session_id)
                    if ring_id:
                        ring_abandon(ring_id)
                except TRANSPORT_ERRORS:
                    try:
                        writer.close()
                    except Exception:
                        pass
                    continue
                if not resumed:
                    try:
                        writer.close()
                    except Exception:
                        pass
                    await self._group_fatal(group)
                    return
                conn.crc_fn = self._negotiated_crc(peer_ckind)
                pair = None
                if self._delegatable() and conn.lane_idx >= 1:
                    # the shard revives in a worker PROCESS (a fresh one
                    # if the old worker died — ensure_worker respawns
                    # the slot); the pinned unacked frames replay
                    # through the new shm ring inside adopt_transport
                    worker = self.reactors.worker_for(group.peer,
                                                      conn.lane_idx)
                    pair = self._delegate_transport(reader, writer,
                                                    worker, conn.crc_fn,
                                                    conn.crc_enabled)
                    if pair is not None:
                        reader, writer = pair
                        conn.shm_worker = worker
                try:
                    await conn.adopt_transport(reader, writer)
                except BaseException:
                    # adopt failed/cancelled AFTER the handoff: the shm
                    # pair must not outlive it (teardown returns parked
                    # budget + unlinks the shared memory)
                    if pair is not None:
                        pair[0].close()
                    raise
                self.perf.inc("lane_revivals")
                self.dout(1, f"lane revived in place for group "
                             f"{group.group_id[:8]} peer "
                             f"{group.peer[0]}:{group.peer[1]} (unacked "
                             f"frames replayed)")
                t = asyncio.get_running_loop().create_task(
                    self._serve(conn))
                self._tasks.add(t)
                t.add_done_callback(self._tasks.discard)
                return
            await self._group_fatal(group)
        finally:
            group._reviving.discard(key)

    async def _group_fatal(self, group: LaneGroup) -> None:
        """Tear a lane group down wholesale (lossy lane death, peer gone
        for good, acceptor session loss): the next send dials fresh."""
        if group.closed:
            return
        group.closed = True
        if self._conns.get(group.peer) is group:
            self._conns.pop(group.peer, None)
        await group.close()

    # -- outbound ------------------------------------------------------------

    async def connect(self, addr: Tuple[str, int],
                      peer_type: str = "osd") -> Connection:
        """Get (or create) an ordered session with a peer.  A cached dead
        lossless connection is revived in place (same session state, fresh
        transport, unacked replay); dead lossy connections are replaced.
        Serialized per addr so concurrent senders share one session.

        Wire-plane negotiation happens here: a colocated peer that
        matches our process token gets the in-process ring transport
        (RingConnection); a lanes-capable peer gets ``ms_lanes_per_peer``
        parallel lanes (LaneGroup) with data lanes bound to reactor
        workers by the stable hash; anything else falls back to the
        single TCP Connection — transparently, the caller just gets an
        object with ``send``."""
        addr = tuple(addr)
        if self.home_loop is None:
            self.home_loop = asyncio.get_running_loop()
        conn = self._conns.get(addr)
        if conn is not None and not conn.closed:
            return conn
        lock = self._conn_locks.setdefault(addr, asyncio.Lock())
        async with lock:
            conn = self._conns.get(addr)
            if conn is not None and not conn.closed:
                return conn
            policy = self.policy_for(peer_type)
            reviving = (isinstance(conn, Connection)
                        and conn.lane_group is None and conn.policy.replay)
            session_id = conn.session_id if reviving \
                else random.randbytes(8).hex()
            reader, writer = await asyncio.open_connection(*addr)
            try:
                (peer_name, resumed, peer_ckind, lanes_ok, ring_id,
                 reader, writer) = await self._handshake_out(
                    reader, writer, policy.replay, session_id,
                    want_ring=self._ring_ok,
                )
            except Exception:
                writer.close()
                raise
            if ring_id:
                pair = ring_claim(ring_id)
                if pair is not None:
                    # colocated ring negotiated: zero-serialization
                    # in-process transport; the TCP socket retires
                    self.dout(1, f"colocated ring negotiated with "
                                 f"{peer_name or '?'} at "
                                 f"{addr[0]}:{addr[1]}")
                    rx, tx = pair
                    rconn = RingConnection(self, addr, peer_name, rx, tx,
                                           outbound=True)
                    self._ring_conns.append(rconn)
                    rconn.start_pump()
                    try:
                        writer.close()
                    except Exception:
                        pass
                    self._conns[addr] = rconn
                    return rconn
                # offer vanished (shutdown race): TCP fallback, transparent
            crc_fn = self._negotiated_crc(peer_ckind)
            if reviving:
                if not resumed:
                    # acceptor lost the session (restart/eviction): its reply
                    # stream restarts at seq 1, so our dedupe floor must too.
                    # Replayed frames may re-dispatch there (at-least-once
                    # across an acceptor restart, as in the reference — PG
                    # reqid dedupe above absorbs it).
                    conn.in_seq = 0
                conn.crc_fn = crc_fn
                await conn.adopt_transport(reader, writer)
                task = asyncio.get_running_loop().create_task(
                    self._serve(conn))
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)
                return conn
            base = Connection(self, reader, writer, addr, policy,
                              peer_name, outbound=True)
            base.crc_fn = crc_fn
            base.session_id = session_id
            want_lanes = self.lanes_per_peer if lanes_ok else 1
            if want_lanes <= 1:
                self._conns[addr] = base
                task = asyncio.get_running_loop().create_task(
                    self._serve(base))
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)
                return base
            # multi-lane session: lane 0 (this conn) is the control
            # lane on the home loop; data lanes ride reactor shards
            group = LaneGroup(self, addr, random.randbytes(8).hex(),
                              want_lanes, outbound=True, policy=policy)
            group.bind_lane(base, 0)
            task = asyncio.get_running_loop().create_task(self._serve(base))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)
            await base.send(MLaneHello(group=group.group_id, lane=0,
                                       n_lanes=want_lanes,
                                       proc=PROC_TOKEN[:8]))
            results = await asyncio.gather(
                *[self._dial_lane(group, k)
                  for k in range(1, want_lanes)],
                return_exceptions=True)
            errs = [r for r in results if isinstance(r, BaseException)]
            if errs:
                await self._group_fatal(group)
                raise errs[0] if isinstance(errs[0], Exception) \
                    else ConnectionError("lane dial failed")
            self._conns[addr] = group
            return group

    async def _dial_lane(self, group: LaneGroup, lane_idx: int) -> None:
        """Open one data lane of a lane group, on the reactor worker the
        stable hash binds it to: in thread mode the dial runs ON the
        worker's loop; in process mode the handshake runs here and the
        socket is then DELEGATED to the worker process (home loop
        without a pool)."""
        worker = None
        proc_mode = self._delegatable()
        if self.reactors is not None:
            self.reactors.start()
            worker = self.reactors.worker_for(group.peer, lane_idx)

        async def _do():
            reader, writer = await asyncio.open_connection(*group.peer)
            session_id = random.randbytes(8).hex()
            try:
                (peer_name, _resumed, peer_ckind, _lanes_ok, ring_id,
                 reader, writer) = await self._handshake_out(
                    reader, writer, group.policy.replay, session_id)
                if ring_id:
                    ring_abandon(ring_id)
            except Exception:
                writer.close()
                raise
            crc_fn = self._negotiated_crc(peer_ckind)
            shm_worker = None
            if proc_mode:
                pair = self._delegate_transport(
                    reader, writer, worker, crc_fn,
                    bool(_cget(self.conf, "ms_crc_data", True)))
                if pair is not None:
                    reader, writer = pair
                    shm_worker = worker
            conn = Connection(self, reader, writer, group.peer,
                              group.policy, peer_name, outbound=True)
            conn.crc_fn = crc_fn
            conn.session_id = session_id
            if shm_worker is not None:
                conn.shm_worker = shm_worker
                worker.dialed += 1
            elif worker is not None and not proc_mode:
                conn.reactor = worker
                worker.sockets += 1
                worker.dialed += 1
            group.bind_lane(conn, lane_idx)
            # the lane's first frame binds it on the acceptor — before
            # any striped data can ride it
            await conn.send(MLaneHello(group=group.group_id,
                                       lane=lane_idx,
                                       n_lanes=group.n_lanes,
                                       proc=PROC_TOKEN[:8]))
            task = asyncio.get_running_loop().create_task(
                self._serve(conn))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

        if worker is not None and not proc_mode:
            await worker.submit(_do())
        else:
            await _do()

    async def send(self, addr: Tuple[str, int], msg: Any, retries: int = 3,
                   peer_type: str = "osd") -> None:
        if self._local_fastpath:
            addr_t = tuple(addr)
            for _ in range(2):  # one retry: the peer may have re-bound
                peer = _LOCAL_REGISTRY.get(addr_t)
                if (peer is None or peer._shutdown
                        or not peer._local_fastpath
                        or peer._loop is not asyncio.get_running_loop()):
                    break  # not colocated (or another loop): real wire
                conn = self._local_conns.get(addr_t)
                if conn is None or conn.closed \
                        or conn.peer_messenger is not peer:
                    conn = LocalConnection(self, peer)
                    self._local_conns[addr_t] = conn
                try:
                    await conn.send(msg)
                    return
                except ConnectionError:
                    self._local_conns.pop(addr_t, None)
        last: Optional[Exception] = None
        for _ in range(retries + 1):
            try:
                conn = await self.connect(addr, peer_type)
                await conn.send(msg)
                return
            except PermissionError:
                raise
            except (ConnectionError, OSError) as e:
                last = e
                conn = self._conns.get(tuple(addr))
                if conn is not None and not conn.policy.replay:
                    self._conns.pop(tuple(addr), None)
        raise last  # type: ignore[misc]

    async def shutdown(self) -> None:
        self._shutdown = True
        if self.addr is not None \
                and _LOCAL_REGISTRY.get(tuple(self.addr)) is self:
            _LOCAL_REGISTRY.pop(tuple(self.addr), None)
        for lconn in list(self._local_conns.values()):
            await lconn.close()
        self._local_conns.clear()
        # cancel serve loops FIRST: in py3.12 Server.wait_closed() waits for
        # all connection handlers, so live inbound loops would deadlock it.
        # Tasks living on reactor loops must be cancelled FROM their own
        # loop (Task.cancel is not thread-safe across loops).
        here = asyncio.get_running_loop()
        for t in list(self._tasks):
            t_loop = t.get_loop()
            if t_loop is here:
                t.cancel()
            elif not t_loop.is_closed():
                try:
                    t_loop.call_soon_threadsafe(t.cancel)
                except RuntimeError:
                    pass  # loop shut down under us
        for conn in list(self._conns.values()):
            if isinstance(conn, LaneGroup):
                await conn.close()
            else:
                await self._conn_close(conn)
        for rconn in list(self._ring_conns):
            await rconn.close()
        self._ring_conns.clear()
        with self._lane_lock:
            groups = list(self._lane_groups.values())
            self._lane_groups.clear()
        for g in groups:
            await g.close()
        with self._sessions_lock:
            sessions = list(self._sessions.values())
            self._sessions.clear()
        for conn in sessions:
            await self._conn_close(conn)
        if self.server is not None:
            self.server.close()
            try:
                await asyncio.wait_for(self.server.wait_closed(), timeout=1.0)
            except asyncio.TimeoutError:
                pass
        if self.reactors is not None:
            self.reactors.shutdown()

    # -- wire-plane introspection --------------------------------------------

    def dump_reactors(self) -> Dict[str, Any]:
        """asok ``dump_reactors`` payload: per-reactor socket shards and
        per-peer lane/ring state (rendered by ``ceph daemon``)."""
        peers = []
        rings = []
        seen = set()
        groups = [c for c in self._conns.values()
                  if isinstance(c, LaneGroup)]
        with self._lane_lock:
            for g in self._lane_groups.values():
                groups.append(g)
        for g in groups:
            if id(g) in seen:
                continue
            seen.add(id(g))
            peers.append(g.dump())
        for c in self._ring_conns:
            rings.append(c.dump())
        out = {
            "op_threads": (self.reactors.n_workers
                           if self.reactors is not None else 0),
            "reactor_mode": self.reactor_mode,
            "lanes_per_peer": self.lanes_per_peer,
            "colocated_ring": self._ring_ok,
            "wirepath": "native" if self.wirepath is not None else "python",
            "workers": (self.reactors.dump()
                        if self.reactors is not None else []),
            "peers": peers,
            "rings": rings,
        }
        if self._delegatable():
            # whole-plane view: worker pids + the shm aggregate the
            # perf presample folds into `perf dump`
            self._refresh_proc_perf()
            out["worker_pids"] = [w.pid for w in self.reactors.workers]
            out["proc_perf"] = self.reactors.counters_sum()
        return out
