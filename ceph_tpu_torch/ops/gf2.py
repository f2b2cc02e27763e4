"""Bit-plane GF(2) lane of the port: the int8 bit-plane layout on tensors.

Counterpart of the int8-plane lane of ceph_tpu/ops/gf2.py.  A GF(2^w) linear
code is a GF(2) linear map on bit-planes, so encode, decode and recovery are
all

    out_bits[R, B] = (M_bits[R, C] @ data_bits[C, B]) & 1

with the matrix as an operand.  Two layouts feed it (ec/codecs.py):

  * byte layout   (reed_sol codes): bit-row j*w+x = bit x of chunk j's
    symbols (w=8 bytes; w=16 little-endian byte pairs; w=4 low nibble then
    high nibble as consecutive columns);
  * packet layout (cauchy/liberation codes): bit-row j*w+l = packet l of
    chunk j, each packet byte further expanded into 8 bit-columns.

Every function takes and returns tensors.  On CUDA tensors the products run
in the hand-written kernels of ops/cuda_gf2.py: w=8 byte layout in the fused
``apply_bytes_w8`` (no bit-plane reaches device memory), everything else in
``gf2_matmul`` between the unpack and pack below.  On CPU tensors the same
wrappers use their plain versions.  The kernels mask their own ragged edge,
so no column count is padded or bucketed here.

The second half is the packed-bit static-XOR-schedule lane, the production
lane for w=8 byte-layout codes and packet rows (``packedbit_enabled()``,
default on).  Shards are u32 plane words (1 bit a bit; int32 tensors carrying
the pattern), and a bit-matrix runs as the straight-line XOR program
``xor_schedule_program`` compiles from it, greedy pairwise CSE included
(``xor_cse_enabled()``).  Programs live in a process-global LRU keyed by
(tag, shape, matrix bytes, cse), the reference's ErasureCodeIsaTableCache
design, and run in the kernels of ops/cuda_packedbit.py with the program as
an operand.  Its `gf2_sched` counter set (schema below, same as the
reference's):

    hit            u64         schedule LRU hits
    miss           u64         LRU misses (a compile follows)
    evict          u64         entries dropped at capacity
    compile        u64         schedules compiled (program build + encoding)
    compile_s      longrunavg  seconds per schedule compile
    xor_ops_naive  u64         pre-CSE XOR op count, summed over compiles
    xor_ops_final  u64         post-CSE (as-configured) XOR op count
    entries        u64         live LRU entries (gauge)
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from typing import Tuple

import numpy as np
import torch

from ceph_tpu_torch.common.perf_counters import PerfCountersBuilder
from ceph_tpu_torch.common.tracing import span
from ceph_tpu_torch.ops import cuda_gf2, cuda_packedbit
from ceph_tpu_torch.utils.cudadev import DeviceLike, resolve_device


def bitmatrix_to_tensor(bitmatrix: np.ndarray,
                        device: DeviceLike = None) -> torch.Tensor:
    """A numpy GF(2) bit-matrix (0/1, any integer dtype) as the contiguous
    int8 operand the kernels take, on `device` (CUDA unless told "cpu")."""
    bm = np.ascontiguousarray(bitmatrix, dtype=np.int8)
    return torch.from_numpy(bm).to(resolve_device(device))


def _shifts(n: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=device)


def unpack_bits_bytes(data: torch.Tensor, w: int) -> torch.Tensor:
    """[n, B] uint8 byte chunks -> [n*w, Bcols] int8 bit-planes (byte layout):
    w=8 row n*8+x = bit x of every byte; w=16 row n*16+x = bit x of each
    little-endian uint16 (Bcols = B/2); w=4 row n*4+x = bit x of the low
    nibble then of the high nibble, as consecutive columns (Bcols = 2B)."""
    n, B = data.shape
    if w == 16:
        pairs = data.reshape(n, B // 2, 2).permute(0, 2, 1)  # [n, 2, B/2]
        s = _shifts(8, torch.uint8, data.device)
        bits = (pairs[:, :, None, :] >> s[None, None, :, None]) & 1
        return bits.reshape(n * 16, B // 2).to(torch.int8)
    if w == 4:
        s = _shifts(4, torch.uint8, data.device)
        lo = (data[:, None, :] >> s[None, :, None]) & 1  # [n, 4, B]
        hi = (data[:, None, :] >> (s + 4)[None, :, None]) & 1
        return torch.stack([lo, hi], dim=-1).reshape(n * 4, B * 2).to(torch.int8)
    s = _shifts(8, torch.uint8, data.device)
    bits = (data[:, None, :] >> s[None, :, None]) & 1  # [n, 8, B]
    return bits.reshape(n * 8, B).to(torch.int8)


def pack_bits_bytes(bits: torch.Tensor, w: int, out_rows: int) -> torch.Tensor:
    """Inverse of unpack_bits_bytes: [out_rows*w, Bcols] -> [out_rows, B]."""
    Bc = bits.shape[1]
    if w == 16:
        planes = bits.reshape(out_rows, 2, 8, Bc).to(torch.int32)
        s = _shifts(8, torch.int32, bits.device)
        halves = (planes << s[None, None, :, None]).sum(dim=2)  # [out, 2, Bc]
        return halves.permute(0, 2, 1).reshape(out_rows, Bc * 2).to(torch.uint8)
    if w == 4:
        planes = bits.reshape(out_rows, 4, Bc // 2, 2).to(torch.int32)
        s = _shifts(4, torch.int32, bits.device)
        lo = (planes[..., 0] << s[None, :, None]).sum(dim=1)
        hi = (planes[..., 1] << s[None, :, None]).sum(dim=1)
        return (lo | (hi << 4)).to(torch.uint8)
    planes = bits.reshape(out_rows, 8, Bc).to(torch.int32)
    s = _shifts(8, torch.int32, bits.device)
    return (planes << s[None, :, None]).sum(dim=1).to(torch.uint8)


def to_planar(data: torch.Tensor, w: int = 8) -> torch.Tensor:
    """Packed [rows, B] uint8 chunks -> planar [rows*w, Bcols] int8."""
    return unpack_bits_bytes(data, w)


def from_planar(bits: torch.Tensor, w: int, out_rows: int) -> torch.Tensor:
    """Planar [out_rows*w, Bcols] int8 -> packed [out_rows, B] uint8."""
    return pack_bits_bytes(bits, w, out_rows)


def gf2_matmul(mbits: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(M @ bits) & 1 -> int8 0/1.  Operands of any integer dtype are taken
    as int8, as the reference does; only their low bits matter."""
    return cuda_gf2.gf2_matmul(mbits.to(torch.int8).contiguous(),
                               bits.to(torch.int8).contiguous())


def gf2_encode_resident(mbits: torch.Tensor, data: torch.Tensor, w: int,
                        out_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unpack the packed [n, B] batch once, matmul for parity, pack the
    parity, and also return the full planar rows (data ‖ parity).
    Returns (packed_parity [out_rows, B], all_bits [(n+out_rows)*w, Bc])."""
    bits = unpack_bits_bytes(data, w)
    pbits = gf2_matmul(mbits, bits)
    return pack_bits_bytes(pbits, w, out_rows), torch.cat([bits, pbits], dim=0)


def gf2_apply_bytes(mbits: torch.Tensor, data: torch.Tensor, w: int,
                    out_rows: int) -> torch.Tensor:
    """Byte layout: apply a [out_rows*w, n*w] bit-matrix to [n, B] uint8
    chunks -> [out_rows, B] uint8.  w=8 takes the fused apply_bytes_w8."""
    if w == 8:
        if mbits.shape[0] != out_rows * 8:
            raise ValueError(f"bit-matrix has {mbits.shape[0]} rows, "
                             f"expected {out_rows * 8}")
        return cuda_gf2.apply_bytes_w8(mbits.to(torch.int8).contiguous(),
                                       data.contiguous())
    return pack_bits_bytes(gf2_matmul(mbits, unpack_bits_bytes(data, w)), w,
                           out_rows)


def gf2_apply_packets(mbits: torch.Tensor, data: torch.Tensor, w: int,
                      packetsize: int, out_rows: int) -> torch.Tensor:
    """Packet layout: [n, chunk] uint8 chunks, chunk = nb*w*packetsize; apply
    the [out_rows*w, n*w] bit-matrix over packet rows -> [out_rows, chunk]."""
    n, chunk = data.shape
    nb = chunk // (w * packetsize)
    rows = (data.reshape(n, nb, w, packetsize).permute(0, 2, 1, 3)
            .reshape(n * w, nb * packetsize))
    s = _shifts(8, torch.uint8, data.device)
    bits = ((rows[:, :, None] >> s[None, None, :]) & 1).reshape(
        n * w, nb * packetsize * 8)
    out = gf2_matmul(mbits, bits).reshape(out_rows * w, nb * packetsize, 8)
    packed = (out.to(torch.int32) << s.to(torch.int32)[None, None, :]).sum(
        dim=-1).to(torch.uint8)
    return (packed.reshape(out_rows, w, nb, packetsize).permute(0, 2, 1, 3)
            .reshape(out_rows, chunk))


# -- packed-bit static-schedule XOR: the production lane ---------------------

SCHED_PERF = (
    PerfCountersBuilder("gf2_sched")
    .add_u64_counter("hit", "compiled-schedule LRU hits")
    .add_u64_counter("miss", "compiled-schedule LRU misses")
    .add_u64_counter("evict", "compiled schedules evicted at capacity")
    .add_u64_counter("compile", "schedules compiled")
    .add_time_avg("compile_s", "schedule program build seconds per matrix")
    .add_u64_counter("xor_ops_naive",
                     "XOR ops before CSE, summed over compiled matrices")
    .add_u64_counter("xor_ops_final",
                     "XOR ops after the configured CSE pass")
    .add_u64("entries", "live compiled schedules (gauge)")
    .create_perf_counters())

_XOR_SCHEDULE_CAPACITY = 64
_XOR_SCHEDULES: "OrderedDict" = OrderedDict()
_XOR_LOCK = threading.Lock()


def _sched_resync() -> None:
    """`perf reset` re-reads the live LRU size into the entries gauge (under
    the cache lock, as _sched_cache_put writes it)."""
    with _XOR_LOCK:
        SCHED_PERF.set("entries", len(_XOR_SCHEDULES))


SCHED_PERF.resync = _sched_resync


def packedbit_enabled() -> bool:
    """Whether the packed-bit XOR-schedule lane serves w=8 byte-layout and
    packet-row dispatch.  Default on; CEPH_TPU_PACKEDBIT=0 pins the int8-plane
    lane.  Read at call time, the same variable as the reference's."""
    return os.environ.get("CEPH_TPU_PACKEDBIT", "1") != "0"


def xor_cse_enabled() -> bool:
    """Whether XOR schedules run the common-subexpression pass.  Default on;
    CEPH_TPU_XOR_CSE=0 pins the naive per-row schedules."""
    return os.environ.get("CEPH_TPU_XOR_CSE", "1") != "0"


def xor_schedule_program(bitmatrix: np.ndarray, cse: "bool | None" = None):
    """Compile a [R, C] GF(2) bit-matrix into a straight-line XOR program:
    returns (ops, outs, n_xors) where `ops` is a list of (a, b) pairs --
    op i computes temp C+i = term_a ^ term_b -- and `outs[r]` is the term
    list (inputs 0..C-1, temps C+...) XORed together for output row r.
    n_xors counts total XOR instructions.

    With cse=True the greedy pairwise pass factors the pair of terms
    co-occurring in the most rows into a shared temp, repeatedly.  Ties break
    to the smallest pair, so the output is deterministic and identical to
    the reference's, which the cache keys and counters rely on."""
    if cse is None:
        cse = xor_cse_enabled()
    bm = np.asarray(bitmatrix, dtype=np.uint8)
    R, C = bm.shape
    member = bm != 0
    naive = int(np.maximum(member.sum(axis=1) - 1, 0).sum())
    ops: list = []
    if cse and naive <= 4096:  # pathological profiles skip the greedy pass
        ops, member = _greedy_pairs(member)
    outs = [np.flatnonzero(member[r]).tolist() for r in range(R)]
    n_xors = len(ops) + sum(max(0, len(o) - 1) for o in outs)
    return ops, outs, n_xors


def _greedy_pairs(member: np.ndarray):
    """The greedy pass over [R, C] bool term membership: returns (ops,
    membership over the C inputs and len(ops) temps).  The pair histogram
    lives in a matrix, upper[i, j] for i < j, built once and updated by a
    few vector operations per factoring, with each row's maximum kept so
    that the next pair is found without a scan of every pair: the top
    count, then the smallest a, then the smallest b, as the reference's
    heap orders (count desc, a asc, b asc)."""
    R, C = member.shape
    cap = max(2 * C, 64)
    member = np.pad(member, ((0, 0), (0, cap - C)))
    m32 = member[:, :C].astype(np.int32)
    upper = np.zeros((cap, cap), dtype=np.int32)
    upper[:C, :C] = np.triu(m32.T @ m32, 1)
    rowmax = upper.max(axis=1)
    ops: list = []
    T = C  # terms so far: inputs, then temps
    while True:
        a = int(np.argmax(rowmax[:T]))  # the first of the top count
        if rowmax[a] < 2:
            return ops, member[:, :T]
        b = int(np.argmax(upper[a, :T]))
        if T == cap:  # room for the new temp
            cap *= 2
            grown = np.zeros((cap, cap), dtype=np.int32)
            grown[:T, :T] = upper
            upper = grown
            member = np.pad(member, ((0, 0), (0, cap - T)))
            rowmax = np.pad(rowmax, (0, cap - T))
        t = T
        ops.append((a, b))
        rows = np.flatnonzero(member[:, a] & member[:, b])
        # v[x]: the factored rows that also hold x; pairs (a, x) and (b, x)
        # lose them, and (x, t) gains them
        v = member[rows, :T].sum(axis=0, dtype=np.int32)
        v[a] = v[b] = 0
        for y in (a, b):
            upper[:y, y] -= v[:y]
            upper[y, y + 1:T] -= v[y + 1:T]
        upper[a, b] = 0
        upper[:T, t] += v
        member[rows, a] = member[rows, b] = False
        member[rows, t] = True
        T += 1
        touched = np.concatenate([np.flatnonzero(v), [a, b]])
        rowmax[touched] = upper[touched, :T].max(axis=1)


def _sched_cache_get(key):
    with _XOR_LOCK:
        prog = _XOR_SCHEDULES.get(key)
        if prog is not None:
            _XOR_SCHEDULES.move_to_end(key)  # true LRU: hits refresh
    SCHED_PERF.inc("hit" if prog is not None else "miss")
    return prog


def _sched_cache_put(key, prog) -> None:
    evicted = 0
    with _XOR_LOCK:
        _XOR_SCHEDULES[key] = prog
        _XOR_SCHEDULES.move_to_end(key)
        while len(_XOR_SCHEDULES) > _XOR_SCHEDULE_CAPACITY:
            _XOR_SCHEDULES.popitem(last=False)
            evicted += 1
        # the gauge is written under the cache lock, so a stale snapshot
        # never overwrites a newer one (lock order: cache, then perf)
        SCHED_PERF.set("entries", len(_XOR_SCHEDULES))
    if evicted:
        SCHED_PERF.inc("evict", evicted)


def _compiled_schedule(tag: str, bitmatrix, cse=None) -> cuda_packedbit.Program:
    """The LRU-cached Program per (tag, shape, matrix bytes, cse).
    Thread-safe."""
    bm = np.asarray(bitmatrix, dtype=np.uint8)
    if cse is None:
        cse = xor_cse_enabled()
    key = (tag, bm.shape, bm.tobytes(), cse)
    prog = _sched_cache_get(key)
    if prog is None:
        with span("gf2.sched_compile"), SCHED_PERF.time_avg("compile_s"):
            ops, outs, n_xors = xor_schedule_program(bm, cse=cse)
            prog = cuda_packedbit.Program(ops, outs, bm.shape[1])
        SCHED_PERF.inc("compile")
        naive = int(np.maximum(
            (bm != 0).sum(axis=1).astype(np.int64) - 1, 0).sum())
        SCHED_PERF.inc("xor_ops_naive", naive)
        SCHED_PERF.inc("xor_ops_final", int(n_xors))
        _sched_cache_put(key, prog)
    return prog


def gf2_xor_packed(bitmatrix: np.ndarray, planes: torch.Tensor,
                   cse=None) -> torch.Tensor:
    """[R, C] GF(2) bit-matrix applied by its XOR schedule to the first C
    rows of `planes`: [>= C, Wc] int32 plane words for byte-layout codes, or
    raw uint8 packet rows for the bitmatrix codec family -> [R, Wc] of the
    same dtype.  Rows beyond C are ignored (temps stay numbered from C)."""
    return cuda_packedbit.xor_schedule(
        _compiled_schedule("xor", bitmatrix, cse=cse), planes.contiguous())


def to_packedbit(data: torch.Tensor) -> torch.Tensor:
    """[n, B] uint8 chunks (w=8 byte layout) -> [n*8, ceil(B/32)] int32 plane
    words: the entry boundary of packed-bit residency."""
    return cuda_packedbit.to_packedbit(data.contiguous())


def from_packedbit(planes: torch.Tensor, out_rows: int) -> torch.Tensor:
    """[out_rows*8, Wc] int32 plane words -> [out_rows, Wc*32] uint8: the
    exit boundary."""
    return cuda_packedbit.from_packedbit(planes.contiguous(), out_rows)


def gf2_apply_packedbit(bitmatrix: np.ndarray,
                        data: torch.Tensor) -> torch.Tensor:
    """[out_rows*8, n*8] GF(2) bit-matrix applied to [n, B] uint8 chunks
    (w=8 byte layout) through the packed-bit lane in one launch -> [out_rows,
    B] uint8, byte-compatible with gf2_apply_bytes(bm, data, 8, out_rows)."""
    return cuda_packedbit.apply_packedbit(
        _compiled_schedule("apply", bitmatrix), data.contiguous())


def gf2_encode_packedbit_resident(bitmatrix: np.ndarray, data: torch.Tensor):
    """The packed-bit residency write path: [n, B] uint8 in, one launch ->
    (packed parity [out_rows, B] uint8, data ‖ parity plane words
    [(n+out_rows)*8, ceil(B/32)] int32)."""
    return cuda_packedbit.apply_packedbit(
        _compiled_schedule("resident", bitmatrix), data.contiguous(),
        resident=True)


def pack_bitplanes_u32(data: np.ndarray, w: int = 8) -> np.ndarray:
    """Host-side packed-bit layout: [n, B] uint8 chunks -> [n*w, ceil(B/32)]
    uint32 words (bit b of word i = bit-plane value at column 32i+b).
    Columns pad out with zero bits to whole words; w<8 packs the low w
    bit-planes."""
    n, B = data.shape
    if B % 32:
        data = np.pad(data, ((0, 0), (0, 32 - B % 32)))
    bits = ((data[:, None, :] >> np.arange(w, dtype=np.uint8)[None, :, None])
            & 1).reshape(n * w, data.shape[1])
    return np.packbits(bits, axis=1, bitorder="little").view(np.uint32)


def unpack_bitplanes_u32(planes: np.ndarray, w: int, out_rows: int,
                         B: int) -> np.ndarray:
    """Inverse of pack_bitplanes_u32 for the parity rows: [out_rows*w, Wc]
    u32 words -> [out_rows, B] uint8, trimming any pad columns."""
    bits = np.unpackbits(np.ascontiguousarray(planes).view(np.uint8), axis=1,
                         bitorder="little")[:, :B]
    out = np.zeros((out_rows, B), np.uint8)
    for x in range(w):
        out |= (bits[x::w].astype(np.uint8) << x)
    return out
