"""EC stripe math and the queue encode/decode plans (reference
src/osd/ECUtil.{h,cc}).

Copy of ceph_tpu/rados/ecutil.py:33-715 at commit 645aba9, on the port's
modules; ``HashInfo`` (ecutil.py:90-131 at commit 4ac5bd2) chains the port's
checksum (``utils/checksum.py``, crc32c from its own build).

`StripeInfo` is the reference's ``ECUtil::stripe_info_t`` (ECUtil.h:27-80):
an object is logically striped in ``stripe_width = k * chunk_size`` units;
its helpers convert logical byte offsets and lengths to per-shard chunk
offsets and back, and round ranges out to stripe boundaries.

`batched_encode` inverts the reference's per-stripe loop (ECUtil.cc:123-160):
it re-interleaves a buffer into per-shard rows ``[k, n_stripes * chunk]``
and hands them ALL to the stripe-batching queue
(ceph_tpu_torch/parallel/service.py) as one request, so that many objects'
stripes share one kernel launch; the async variants let concurrent ops
coalesce.  `decode_object` reconstructs through the same queue: the codec
picks and inverts the decode matrix on the host, the device applies it to
the missing data rows only.  Without a queue, or for codecs the plans do
not take (packet layout, chunk remaps, sub-chunk codecs), both use the
codec's own calls.

The residency helpers at the end (`planar_encode_async`, `planar_rows`,
`planar_shard_bytes`, `planar_object_bytes`) leave an object's shard rows
resident on the device after a write, in a PlanarShardStore or a
PagedResidentStore, and serve reads and recovery rows from them.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ceph_tpu_torch.ec.matrices import matrix_to_bitmatrix
from ceph_tpu_torch.ops.gf2 import (bitmatrix_to_tensor, from_packedbit,
                                    from_planar, gf2_encode_packedbit_resident,
                                    gf2_encode_resident, packedbit_enabled)
from ceph_tpu_torch.rados.messenger import BufferList
from ceph_tpu_torch.utils.cudadev import DeviceLike, resolve_device


@dataclass(frozen=True)
class StripeInfo:
    """stripe_info_t role: k data chunks x chunk_size = stripe_width."""

    k: int
    stripe_width: int

    def __post_init__(self):
        assert self.stripe_width % self.k == 0, \
            "stripe_width must be a multiple of k"

    @property
    def chunk_size(self) -> int:
        return self.stripe_width // self.k

    # -- logical <-> chunk conversions (ECUtil.h:35-79) ----------------------

    def logical_to_prev_chunk_offset(self, offset: int) -> int:
        """Chunk offset of the stripe CONTAINING logical `offset`."""
        return (offset // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, offset: int) -> int:
        """Chunk offset just PAST logical `offset`, rounded up."""
        return -(-offset // self.stripe_width) * self.chunk_size

    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        return offset - (offset % self.stripe_width)

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        return -(-offset // self.stripe_width) * self.stripe_width

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        assert offset % self.stripe_width == 0
        return offset // self.k

    def aligned_chunk_offset_to_logical_offset(self, offset: int) -> int:
        assert offset % self.chunk_size == 0
        return offset * self.k

    def offset_len_to_stripe_bounds(self, offset: int,
                                    length: int) -> Tuple[int, int]:
        """Round a logical extent OUT to stripe boundaries (the RMW read
        set, ECUtil.h:55-60): returns (start, len)."""
        start = self.logical_to_prev_stripe_offset(offset)
        end = self.logical_to_next_stripe_offset(offset + length)
        return start, end - start

    def pad_to_stripe(self, data: bytes) -> bytes:
        want = self.logical_to_next_stripe_offset(len(data))
        if want == len(data):
            return data  # aligned: no copy on the hot path
        if not isinstance(data, (bytes, bytearray)):
            # a buffer view: materialize for the pad concat (only unaligned
            # tails pay this)
            data = bytes(data)
        return data + b"\x00" * (want - len(data))


class HashInfo:
    """Cumulative per-shard crc32s, chained across appends (ECUtil.h:101).

    ``dirty`` marks a record whose non-self entries went stale: a partial
    (spliced) overwrite rewrites one shard's bytes without the primary
    holding every other shard's blob, so each shard refreshes only its OWN
    crc entry.  Deep scrub always trusts the self entry; cross-shard
    comparison is only meaningful while the record is clean (the reference
    sidesteps this by disabling hinfo under ec_overwrites)."""

    XATTR_KEY = "hinfo_key"

    def __init__(self, n_shards: int, total_chunk_size: int = 0,
                 crcs: Optional[List[int]] = None, dirty: bool = False):
        self.total_chunk_size = total_chunk_size
        self.crcs = list(crcs) if crcs else [0] * n_shards
        self.dirty = dirty

    def append(self, shard_chunks: Dict[int, bytes]) -> None:
        """Fold the NEW chunk bytes of one append into each shard's
        running crc (crc32 chaining, as the reference's bufferlist crc32c
        cumulative update does)."""
        from ceph_tpu_torch.utils.checksum import checksum

        sizes = {len(c) for c in shard_chunks.values()}
        assert len(sizes) == 1, "appends must be chunk-aligned and equal"
        for shard, chunk in shard_chunks.items():
            self.crcs[shard] = checksum(chunk, self.crcs[shard])
        self.total_chunk_size += sizes.pop()

    def shard_crc(self, shard: int) -> int:
        return self.crcs[shard]

    def encode(self) -> bytes:
        return json.dumps({"total_chunk_size": self.total_chunk_size,
                           "crcs": self.crcs, "dirty": self.dirty}).encode()

    @classmethod
    def decode(cls, blob: bytes) -> "HashInfo":
        d = json.loads(blob)
        return cls(len(d["crcs"]), d["total_chunk_size"], d["crcs"],
                   d.get("dirty", False))


def concat_safe(codec) -> bool:
    """True when the codec transforms a chunk as independent aligned
    blocks, making the concatenation of per-stripe chunks itself a valid
    chunk set: byte-layout codecs operate column-wise per byte, and the
    packet (bitmatrix) family per w*packetsize block.  Only sub-chunk codecs
    (CLAY) derive intra-chunk structure from the TOTAL chunk size and must
    be driven stripe by stripe."""
    try:
        return codec.get_sub_chunk_count() == 1
    except Exception:
        return False


def _mapped_shard_list(codec, data_rows: np.ndarray,
                       coding_rows: np.ndarray) -> List[np.ndarray]:
    """Arrange logical data/coding rows into PHYSICAL shard order (the
    chunk_index remap base.encode applies for 'mapping' profiles)."""
    k = codec.get_data_chunk_count()
    n = codec.get_chunk_count()
    out: List[Optional[np.ndarray]] = [None] * n
    for logical in range(n):
        row = data_rows[logical] if logical < k else coding_rows[logical - k]
        out[codec.chunk_index(logical)] = row
    return out  # type: ignore[return-value]


def _packedbit_route(codec) -> bool:
    """Whether this codec's queue plans ride the packed-bit XOR-schedule
    lane (w=8, CEPH_TPU_PACKEDBIT unset or not 0) instead of the int8-plane
    lanes."""
    return packedbit_enabled() and getattr(codec, "w", 8) == 8


def _encode_plan_parts(codec, sinfo: StripeInfo, arr: np.ndarray,
                       n_stripes: int):
    """The submit-free half of the queue encode plan: when the codec is
    batchable (byte-layout bit seam, no chunk remap), returns (kind, mbits,
    flat, w, m, reassemble), the lane submission a caller hands to
    queue.submit/submit_packedbit, or with several buffers to
    BatchingQueue.submit_group.  None when the queue path does not apply."""
    mbits = codec.bit_generator()
    if (mbits is None or getattr(codec, "bit_layout", "byte") != "byte"
            or codec.get_chunk_mapping()):
        return None
    k = codec.get_data_chunk_count()
    n = codec.get_chunk_count()
    m = n - k
    w = getattr(codec, "w", 8)
    # columns = stripes concatenated; one submit -> one device call
    flat = np.ascontiguousarray(
        arr.transpose(1, 0, 2).reshape(k, n_stripes * sinfo.chunk_size))
    if _packedbit_route(codec):
        kind = "packedbit"
        mat = np.asarray(mbits).astype(np.uint8)
    else:
        kind = "packed"
        mat = np.asarray(mbits).astype(np.int8)

    def reassemble(parity: np.ndarray) -> List[np.ndarray]:
        p = np.asarray(parity).reshape(m, n_stripes * sinfo.chunk_size)
        # the flat rows ARE the per-shard data blobs, already contiguous
        return [flat[i] for i in range(k)] + [p[j] for j in range(m)]

    return kind, mat, flat, w, m, reassemble


def _queue_encode_plan(codec, sinfo: StripeInfo, arr: np.ndarray,
                       n_stripes: int, queue, span=None):
    """When the codec/queue combination is batchable, submit the whole
    buffer as ONE queue request and return (future, reassemble), where
    reassemble turns the parity rows into the per-shard blob list.  None
    when the queue path does not apply (packet-layout, mapped, or
    sub-chunk codecs)."""
    parts = _encode_plan_parts(codec, sinfo, arr, n_stripes)
    if parts is None:
        return None
    kind, mat, flat, w, m, reassemble = parts
    if kind == "packedbit":
        fut = queue.submit_packedbit(mat, flat, w, m, span=span)
    else:
        fut = queue.submit(mat, flat, w, m, span=span)
    return fut, reassemble


def batched_encode(codec, sinfo: StripeInfo, data: bytes,
                   queue=None, span=None) -> List[np.ndarray]:
    """Encode a multi-stripe buffer with ONE device dispatch.

    Every stripe rides one call: the buffer is re-interleaved into
    per-shard rows (`[k, n_stripes*chunk]`) and the codec transforms all
    stripes at once, through encode_chunks or through the shared
    BatchingQueue when one is given.  Byte-identical to the per-stripe
    loop for every concat-safe codec (see concat_safe); CLAY takes the
    per-stripe path.  Returns one concatenated buffer per shard,
    `[n_shards][n_stripes*chunk]`, in physical shard order.

    Blocking variant; code on an event loop uses batched_encode_async so
    that concurrent ops coalesce.
    """
    k = codec.get_data_chunk_count()
    n = codec.get_chunk_count()
    assert sinfo.k == k
    padded = sinfo.pad_to_stripe(data)
    n_stripes = max(1, len(padded) // sinfo.stripe_width)
    # stripe-major view (no copy): [n_stripes, k, chunk].  Empty objects
    # cannot take the queue path; the codec's own encode pads them
    arr = (np.frombuffer(padded, dtype=np.uint8).reshape(
               n_stripes, k, sinfo.chunk_size)
           if len(padded) else None)
    if queue is not None and arr is not None:
        # single-stripe objects ride the queue too: coalescing across
        # objects is the point
        planned = _queue_encode_plan(codec, sinfo, arr, n_stripes, queue,
                                     span=span)
        if planned is not None:
            fut, reassemble = planned
            return reassemble(fut.result())
    if n_stripes <= 1 or arr is None:
        # one stripe IS one dispatch: the codec encodes the whole buffer
        enc = codec.encode(set(range(n)), padded)
        return [np.asarray(enc[i]) for i in range(n)]
    if concat_safe(codec):
        # ONE encode_chunks call over all stripes: per-shard rows are the
        # stored blob layout
        rows = np.ascontiguousarray(
            arr.transpose(1, 0, 2).reshape(k, n_stripes * sinfo.chunk_size))
        coding = np.asarray(codec.encode_chunks(rows))
        return _mapped_shard_list(codec, rows, coding)
    # sub-chunk codecs: per-stripe loop (the reference's shape)
    shards: List[List[np.ndarray]] = [[] for _ in range(n)]
    for s in range(n_stripes):
        enc = codec.encode(set(range(n)), arr[s].tobytes())
        for i in range(n):
            shards[i].append(np.asarray(enc[i]))
    return [np.concatenate(chunks) for chunks in shards]


async def batched_encode_async(codec, sinfo: StripeInfo, data: bytes,
                               queue=None, span=None) -> List[np.ndarray]:
    """Event-loop-friendly batched_encode: the queue future is AWAITED,
    so concurrent ops keep submitting while this one waits, and the queue
    coalesces them into one dispatch."""
    if queue is not None:
        import asyncio

        k = codec.get_data_chunk_count()
        padded = sinfo.pad_to_stripe(data)
        if len(padded):
            n_stripes = max(1, len(padded) // sinfo.stripe_width)
            arr = np.frombuffer(padded, dtype=np.uint8).reshape(
                n_stripes, k, sinfo.chunk_size)
            planned = _queue_encode_plan(codec, sinfo, arr, n_stripes, queue,
                                         span=span)
            if planned is not None:
                fut, reassemble = planned
                return reassemble(await asyncio.wrap_future(fut))
    return batched_encode(codec, sinfo, data, queue=None)


async def batched_encode_group_async(codec, sinfo: StripeInfo, buffers,
                                     queue=None, span=None):
    """Encode SEVERAL objects' buffers with ONE group-aware queue submit
    (BatchingQueue.submit_group): a recovery round's re-encodes, or a batch
    of writes, reach the EC tier as one submission (one queue lock, one
    worker wakeup, one coalesced dispatch window).

    Returns the per-buffer shard lists, index-aligned with ``buffers``.
    Buffers the queue plan cannot take (packet-layout codecs, empty
    objects, no queue) go through plain batched_encode."""
    import asyncio

    out: List[Optional[List[np.ndarray]]] = [None] * len(buffers)
    items = []
    metas = []
    for i, data in enumerate(buffers):
        if queue is not None:
            padded = sinfo.pad_to_stripe(data)
            if len(padded):
                n_stripes = max(1, len(padded) // sinfo.stripe_width)
                arr = np.frombuffer(padded, dtype=np.uint8).reshape(
                    n_stripes, sinfo.k, sinfo.chunk_size)
                parts = _encode_plan_parts(codec, sinfo, arr, n_stripes)
                if parts is not None:
                    kind, mat, flat, w, m, reassemble = parts
                    items.append((mat, flat, w, m, kind))
                    metas.append((i, reassemble))
                    continue
        out[i] = batched_encode(codec, sinfo, data, queue=None)
    if items:
        futs = queue.submit_group(items, span=span)
        for (i, reassemble), fut in zip(metas, futs):
            out[i] = reassemble(await asyncio.wrap_future(fut))
    return out


def _queue_decode_plan(codec, sinfo: StripeInfo,
                       arrays: Dict[int, np.ndarray], object_size: int,
                       queue, span=None):
    """Queue submission for a reconstructing decode: the host picks and
    inverts the decode matrix by the codec's own selection rule (LRU-cached
    per erasure signature), the device applies it.  Returns (future,
    finish), finish(rows) -> the reconstructed logical bytes trimmed to
    object_size, or None when the queue path does not apply."""
    if (getattr(codec, "bit_layout", "byte") != "byte"
            or codec.get_chunk_mapping() or not concat_safe(codec)
            or not hasattr(codec, "decode_selection")):
        return None
    blob_len = len(next(iter(arrays.values())))
    if blob_len == 0 or blob_len % sinfo.chunk_size:
        return None  # degenerate/ragged blobs: codec paths handle them
    k = codec.get_data_chunk_count()
    cs = sinfo.chunk_size
    n_stripes = blob_len // cs
    if all(i in arrays for i in range(k)):
        return None  # nothing erased that matters: pure de-interleave
    try:
        chosen, inv = codec.decode_selection(set(range(k)), set(arrays))
    except Exception:
        return None
    if any(c not in arrays for c in chosen):
        return None
    # dispatch ONLY the missing data rows (available ones pass through)
    missing = sorted(c for c in range(k) if c not in arrays)
    inv_bm = matrix_to_bitmatrix(inv[missing], codec.w)
    src = np.ascontiguousarray(np.stack([arrays[c] for c in chosen]))
    if _packedbit_route(codec):
        # each decode signature compiles to its own schedule in the LRU
        fut = queue.submit_packedbit(
            inv_bm.astype(np.uint8), src, codec.w, len(missing), span=span)
    else:
        fut = queue.submit(inv_bm.astype(np.int8), src, codec.w,
                           len(missing), span=span)

    def finish(rows: np.ndarray) -> bytes:
        rebuilt = np.asarray(rows)
        full = np.empty((k, n_stripes * cs), dtype=np.uint8)
        for i, c in enumerate(missing):
            full[c] = rebuilt[i]
        for c in range(k):
            if c not in missing:
                full[c] = arrays[c]
        # de-interleave [k, S, cs] -> stripe-major logical bytes
        r = full.reshape(k, n_stripes, cs).transpose(1, 0, 2)
        return r.reshape(-1)[:object_size].tobytes()

    return fut, finish


def _all_data_fast(codec, arrays: Dict[int, np.ndarray], cs: int,
                   n_stripes: int, object_size: int,
                   scatter: bool = False) -> Optional[bytes]:
    """When every DATA shard is present (the normal read) reconstruction is
    pure de-interleave: one strided gather into the output buffer, no GF
    math, no device.  Identity-mapped, concat-safe codecs only; None
    otherwise.

    With ``scatter=True`` the gather copy disappears too: the result is a
    BufferList of per-stripe chunk VIEWS over the shard buffers in logical
    order, which a send path writes as one blob."""
    k = codec.get_data_chunk_count()
    if (n_stripes <= 1 or not concat_safe(codec)
            or codec.get_chunk_mapping()
            or any(c not in arrays for c in range(k))):
        return None
    want = n_stripes * cs
    for c in range(k):
        if len(arrays[c]) < want:
            return None  # short shard: let the codec's padding rules run
    if scatter:
        views = [memoryview(np.ascontiguousarray(arrays[c][:want]))
                 for c in range(k)]
        segs = []
        remaining = object_size
        base = 0
        for _ in range(n_stripes):
            for c in range(k):
                if remaining <= 0:
                    break
                n = cs if remaining >= cs else remaining
                segs.append(views[c][base:base + n])
                remaining -= n
            base += cs
        return BufferList(segs)
    out = np.empty(n_stripes * k * cs, dtype=np.uint8)
    view = out.reshape(n_stripes, k, cs)
    for c in range(k):
        view[:, c, :] = arrays[c][:want].reshape(n_stripes, cs)
    return out[:object_size].tobytes()


def decode_object(codec, sinfo: StripeInfo,
                  blobs: Dict[int, np.ndarray], object_size: int,
                  queue=None, span=None, scatter: bool = False) -> bytes:
    """Reconstruct a striped object from per-shard blobs (each the
    concatenation of that shard's per-stripe chunks) and de-interleave back
    to logical byte order, trimmed to `object_size`.

    Concat-safe codecs decode ALL stripes in one codec.decode call or one
    queue request: the reference's per-stripe objects_read_and_reconstruct
    loop (ECBackend.cc:2401, ECUtil.cc:25-60) in one dispatch.

    ``scatter=True`` permits a BufferList return on the all-data fast path
    (zero-copy stripe views; see _all_data_fast); everyone else gets
    bytes."""
    k = codec.get_data_chunk_count()
    cs = sinfo.chunk_size
    arrays = {s: np.asarray(b, dtype=np.uint8) for s, b in blobs.items()}
    blob_len = len(next(iter(arrays.values())))
    n_stripes = max(1, blob_len // cs)
    fast = _all_data_fast(codec, arrays, cs, n_stripes, object_size,
                          scatter=scatter)
    if fast is not None:
        return fast
    if queue is not None:
        planned = _queue_decode_plan(codec, sinfo, arrays, object_size, queue,
                                     span=span)
        if planned is not None:
            fut, finish = planned
            return finish(fut.result())
    if n_stripes <= 1 or not concat_safe(codec):
        if n_stripes <= 1:
            return bytes(codec.decode_concat(arrays)[:object_size])
        pieces: List[bytes] = []
        for s in range(n_stripes):
            stripe_chunks = {c: a[s * cs:(s + 1) * cs]
                             for c, a in arrays.items()}
            pieces.append(bytes(codec.decode_concat(stripe_chunks)))
        return b"".join(pieces)[:object_size]
    # decode_concat over whole blobs yields the data rows (shard-major);
    # de-interleave [k, S, cs] -> stripe-major logical bytes
    rows = np.frombuffer(codec.decode_concat(arrays), dtype=np.uint8)
    rows = rows.reshape(k, n_stripes, cs).transpose(1, 0, 2)
    return rows.reshape(-1)[:object_size].tobytes()


async def decode_object_async(codec, sinfo: StripeInfo,
                              blobs: Dict[int, np.ndarray],
                              object_size: int, queue=None,
                              span=None, scatter: bool = False) -> bytes:
    """Event-loop-friendly decode_object (see batched_encode_async)."""
    if queue is not None:
        import asyncio

        arrays = {s: np.asarray(b, dtype=np.uint8) for s, b in blobs.items()}
        blob_len = len(next(iter(arrays.values())))
        n_stripes = max(1, blob_len // sinfo.chunk_size)
        fast = _all_data_fast(codec, arrays, sinfo.chunk_size, n_stripes,
                              object_size, scatter=scatter)
        if fast is not None:
            return fast
        planned = _queue_decode_plan(codec, sinfo, arrays, object_size, queue,
                                     span=span)
        if planned is not None:
            fut, finish = planned
            return finish(await asyncio.wrap_future(fut))
    return decode_object(codec, sinfo, blobs, object_size, queue=None,
                         scatter=scatter)


# -- residency (PlanarShardStore, PagedResidentStore) ------------------------
#
# Shards stay on the device across encode -> decode -> recovery, and the
# conversion to and from bytes is paid once, when they enter or leave the
# device tier.  Byte-layout, unmapped, concat-safe codecs only: the same
# eligibility as the queue encode plan.  For w=8 codecs the resident layout
# is packed-bit plane words (int32 carrying the reference's uint32 bits, 1
# device byte per data byte); w=16 and w=4 pools keep int8 planes.  The
# helpers tell the layouts apart by the resident's dtype.


def planar_eligible(codec) -> bool:
    return (getattr(codec, "bit_layout", "byte") == "byte"
            and not codec.get_chunk_mapping()
            and concat_safe(codec)
            and codec.bit_generator() is not None)


async def planar_encode_async(codec, sinfo: StripeInfo, data: bytes,
                              queue=None, span=None,
                              device: DeviceLike = None):
    """Encode with residency: the data rows ride the queue's RESIDENT lanes
    (packedbit_resident, K4, for w=8; resident, K2, for w=16 and w=4), one
    batched device call shared with every concurrent op, and come back as
    (packed parity for persistence, data and parity rows to keep
    resident).  Returns (blobs, all_bits, n_rows, n_cols, w): blobs is the
    per-shard host list (as batched_encode), all_bits a tensor on the
    device; w MUST be recorded with the resident.  None when the codec is
    not planar-eligible.  Without a queue the lane function runs on
    `device` (the card unless the caller names the CPU), at the object's
    own width: the port's kernels take any B, so nothing is padded."""
    if not planar_eligible(codec):
        return None
    padded = sinfo.pad_to_stripe(data)
    if not len(padded):
        return None
    import asyncio

    k = codec.get_data_chunk_count()
    n = codec.get_chunk_count()
    m = n - k
    w = getattr(codec, "w", 8)
    n_stripes = max(1, len(padded) // sinfo.stripe_width)
    flat = np.ascontiguousarray(
        np.frombuffer(padded, dtype=np.uint8)
        .reshape(n_stripes, k, sinfo.chunk_size)
        .transpose(1, 0, 2).reshape(k, n_stripes * sinfo.chunk_size))
    L = flat.shape[1]
    # the packed-bit lane's residents are whole words a plane row (w=8
    # byte codecs guarantee it: chunk_size is a multiple of w*4=32)
    packedbit = _packedbit_route(codec) and L % 32 == 0
    mbits = np.asarray(codec.bit_generator()).astype(
        np.uint8 if packedbit else np.int8)
    if queue is not None:
        submit = (queue.submit_packedbit_resident if packedbit
                  else queue.submit_resident)
        parity, all_bits = await asyncio.wrap_future(
            submit(mbits, flat, w, m, span=span))
    else:
        dev = resolve_device(device)
        rows = torch.from_numpy(flat).to(dev)
        if packedbit:
            parity, all_bits = gf2_encode_packedbit_resident(mbits, rows)
        else:
            parity, all_bits = gf2_encode_resident(
                bitmatrix_to_tensor(mbits, dev), rows, w, m)
        parity = parity.cpu().numpy()
    blobs = [flat[i] for i in range(k)] + [parity[j] for j in range(m)]
    return blobs, all_bits, n, L, w


# the function that brings gathered slab bytes to the host in this module
# (a paged store's read_paged is its own exit)
SLAB_IO_BOUNDARY = ("_pack_rows",)


def _pack_rows(bits, w: int, n_rows: int, L: int, store) -> np.ndarray:
    """Resident bit-rows -> packed [n_rows, L] uint8 on the host: the one
    exit boundary, shared by every planar_* helper.  The conversion runs on
    the store's device (K6 on int32 words, from_planar on int8 planes;
    host-arm rows cross to it first), then the ONE device->host copy,
    counted on a paged store (``d2h_gathers``)."""
    if not isinstance(bits, torch.Tensor):
        a = np.ascontiguousarray(bits)
        bits = torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                else a).to(store.device)
    if bits.dtype == torch.int32:
        out = from_packedbit(bits, n_rows)
    else:
        out = from_planar(bits, w, n_rows)
    out = out[:, :L].cpu().numpy()
    note = getattr(store, "note_d2h", None)
    if note is not None:
        note()
    return out


def _read_paged(store, key, r0: int, r1: int, out_rows: int, L: int,
                **layout) -> Optional[np.ndarray]:
    """The rows' host bytes from a paged store's pages in one launch
    (PagedResidentStore.read_paged: packed-bit words on its device arm), or
    None where that store does not serve them: the caller then gathers and
    takes _pack_rows."""
    read = getattr(store, "read_paged", None)
    return None if read is None else read(key, r0, r1, out_rows, L, **layout)


def planar_rows(store, key, version) -> Optional[List[np.ndarray]]:
    """All n shard rows packed from the resident under `key`, or None when
    absent, at another version, or PARTIAL (a paged resident whose parity
    pages were shed serves object reads but not whole-stripe re-encodes).
    One pack serves recovery and repair re-encodes with no product at all:
    the resident IS the encoded object."""
    got = store.touch(key)
    if got is None:
        return None
    w, n_rows, meta = got
    if not meta or meta[0] != version:
        return None
    rows = _read_paged(store, key, 0, n_rows * w, n_rows, meta[1])
    if rows is None:
        bits = store.gather_rows(key, 0, n_rows * w)
        if bits is None:
            return None
        rows = _pack_rows(bits, w, n_rows, meta[1], store)
    return [rows[i] for i in range(n_rows)]


def planar_shard_bytes(store, key, version, shard: int) -> Optional[bytes]:
    """ONE shard's packed bytes from the resident's bit-rows: the writeback
    flush and sub-read shape, exactly the blob the write-through path would
    have stored."""
    got = store.entry_info(key)
    if got is None:
        return None
    w, _n_rows, meta = got
    if not meta or meta[0] != version:
        return None
    rows = _read_paged(store, key, shard * w, (shard + 1) * w, 1, meta[1])
    if rows is None:
        bits = store.gather_rows(key, shard * w, (shard + 1) * w)
        if bits is None:
            return None
        rows = _pack_rows(bits, w, 1, meta[1], store)
    return rows.reshape(-1).tobytes()


def planar_object_bytes(store, key, version, k: int, cs: int,
                        object_size: int) -> Optional[bytes]:
    """The logical object bytes packed from the resident's DATA rows (a
    read with zero shard reads and no decode), or None when absent or
    stale.  The result is memoized in the store's exit-boundary memo (it
    dies with the entry or on a version change), so a resident read many
    times pays the pack once.  Served through touch/gather_rows, so a paged
    resident whose parity pages were shed still answers from its data-row
    prefix."""
    got = store.touch(key)
    if got is None:
        return None
    w, _n_rows, meta = got
    if not meta or meta[0] != version:
        return None
    memo_get = getattr(store, "memo_get", None)
    if memo_get is not None:
        cached = memo_get(key, version)
        if cached is not None:
            return cached
    L = meta[1]
    # a paged store's packed-bit words go from its pages to the object's
    # stripe-major bytes in one launch
    out = _read_paged(store, key, 0, k * w, k, L, cs=cs,
                      object_size=object_size)
    if out is not None:
        result = out.tobytes()
    else:
        data_bits = store.gather_rows(key, 0, k * w)
        if data_bits is None:
            return None
        rows = _pack_rows(data_bits, w, k, L, store)
        n_stripes = max(1, L // cs)
        out = rows.reshape(k, n_stripes, cs).transpose(1, 0, 2)
        result = out.reshape(-1)[:object_size].tobytes()
    if memo_get is not None:
        store.memo_put(key, version, result)
    return result
