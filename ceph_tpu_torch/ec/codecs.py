"""Shared codec cores: GF(2^w) matrix codes and GF(2) bit-matrix codes.

The reference's jerasure plugin has two encode machineries — byte-wise GF(2^w)
matrix encode (reed_sol_* via jerasure_matrix_encode) and packet-wise GF(2)
bit-matrix schedules (cauchy_*, liberation families via
jerasure_schedule_encode) — see reference
src/erasure-code/jerasure/ErasureCodeJerasure.cc:105-138.  Both are linear
maps over GF(2), which is the TPU design's core insight: encode, decode, and
recovery for every codec are the same bit-plane matmul with different
matrices and bit-row layouts.

Two bit-row layouts exist:
  * ``byte``  — bit-row j*w+x is bit x of every byte of data chunk j
    (reed_sol codes; B columns = chunk bytes);
  * ``packet`` — the chunk is a sequence of w*packetsize-byte blocks, each
    holding w packets; bit-row j*w+l is packet l of data chunk j
    (cauchy/liberation codes; columns = block x packet bytes).

Decode strategy (all codecs): pick k available chunks, stack their rows of
[I; G] (bit-level for packet codes, symbol-level for byte codes), invert, and
reconstruct — the inversion stays on CPU with an LRU signature cache exactly
like the reference isa plugin's ErasureCodeIsaTableCache
(ErasureCodeIsaTableCache.cc:234,273); the regeneration matmul is what the
TPU kernel accelerates.
"""

from __future__ import annotations

import errno
import threading
from collections import OrderedDict
from typing import Dict, List, Mapping, Optional, Set, Tuple

import numpy as np

from ceph_tpu_torch.common.tracing import span
from ceph_tpu_torch.ec.base import ErasureCode
from ceph_tpu_torch.ec.gf import gf
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.matrices import invert_bitmatrix, matrix_to_bitmatrix

LARGEST_VECTOR_WORDSIZE = 16
SIZEOF_INT = 4


class DecodeMatrixCache:
    """LRU cache keyed by erasure signature -> decode matrix (reference
    ErasureCodeIsaTableCache's role; that cache takes a guard mutex around
    every lookup/insert, ErasureCodeIsaTableCache.cc:234,273 — same here so
    codecs are safe under concurrent encode/decode threads)."""

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._cache: "OrderedDict[Tuple, np.ndarray]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key: Tuple) -> Optional[np.ndarray]:
        with self._lock:
            m = self._cache.get(key)
            if m is not None:
                self._cache.move_to_end(key)
            return m

    def put(self, key: Tuple, value: np.ndarray) -> None:
        with self._lock:
            self._cache[key] = value
            self._cache.move_to_end(key)
            while len(self._cache) > self.capacity:
                self._cache.popitem(last=False)


def gf2_combine(select: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """out[r] = XOR over j with select[r,j]==1 of rows[j].

    `rows` is [R, ...bytes...]; this is the CPU reference for the TPU
    bit-matmul (which does the same thing on the MXU after bit-unpacking)."""
    out = np.zeros((select.shape[0],) + rows.shape[1:], dtype=rows.dtype)
    for r in range(select.shape[0]):
        sel = np.nonzero(select[r])[0]
        if sel.size:
            out[r] = np.bitwise_xor.reduce(rows[sel], axis=0)
    return out


def _native_gf_apply():
    """The native core's gf_apply (native/bridge.py), whose library is built
    and loaded at its first call.  Unlike the reference, which falls back
    to the numpy oracle when the library cannot build or load, a failure
    raises with the compiler's message."""
    from ceph_tpu_torch.native import bridge

    return bridge.gf_apply


class MatrixErasureCode(ErasureCode):
    """Systematic GF(2^w) matrix code: parity = G[m,k] (x) data[k,B]."""

    technique = "matrix"

    def __init__(self) -> None:
        super().__init__()
        self.w = 8
        self.matrix: Optional[np.ndarray] = None
        self._decode_cache = DecodeMatrixCache()

    # subclasses: build self.matrix in init() and define get_alignment()

    def get_alignment(self) -> int:
        return self.k * self.w * SIZEOF_INT

    def get_chunk_size(self, stripe_width: int) -> int:
        """jerasure semantics: round the whole object up to the alignment,
        then divide by k (reference ErasureCodeJerasure.cc:80-103)."""
        alignment = self.get_alignment()
        padded = -(-stripe_width // alignment) * alignment if stripe_width else alignment
        assert padded % self.k == 0
        return padded // self.k

    def _apply(self, matrix: np.ndarray, regions: np.ndarray) -> np.ndarray:
        """Apply a GF(2^w) matrix to symbol regions — THE compute seam.

        CPU codecs route w=8 through the port's native vectorized region
        kernels (GFNI/AVX2, native/csrc) and every other w through the numpy
        GF(2^w) oracle; the cuda plugin overrides this one method to
        dispatch the bit-plane GF(2) kernels."""
        if self.w == 8 and regions.dtype == np.uint8:
            return _native_gf_apply()(np.asarray(matrix, dtype=np.uint8),
                                      regions)
        return gf(self.w).matmul(matrix, regions)

    def encode_chunks(self, data: np.ndarray) -> np.ndarray:
        if data.shape[0] != self.k:
            raise ErasureCodeError(-errno.EINVAL, "wrong data chunk count")
        return self._apply(self.matrix, data)

    def _decode_matrix(self, chosen: Tuple[int, ...]) -> np.ndarray:
        """Rows of [I; G] for `chosen` chunks, inverted: maps chosen-chunk
        symbols back to the k data-chunk symbols."""
        cached = self._decode_cache.get(chosen)
        if cached is not None:
            return cached
        f = gf(self.w)
        full = np.vstack([np.eye(self.k, dtype=np.int64), self.matrix])
        sub = full[list(chosen)]
        try:
            inv = f.invert_matrix(sub)
        except np.linalg.LinAlgError as e:
            raise ErasureCodeError(
                -errno.EIO, f"chunk set {chosen} not decodable: {e}"
            ) from e
        self._decode_cache.put(chosen, inv)
        return inv

    def decode_selection(self, want_to_read: Set[int],
                         available: Set[int]):
        """(chosen, inverted_matrix) for reconstructing from `available`
        — THE selection rule, shared by decode_chunks and the batching
        queue's decode path so they can never diverge."""
        with span("ec.decode_select"):
            plan = self.minimum_to_decode(
                set(range(self.k)) | set(want_to_read), available)
            chosen = tuple(sorted(plan))[: self.k]
            return chosen, self._decode_matrix(chosen)

    def decode_chunks(
        self, want_to_read: Set[int], chunks: Mapping[int, np.ndarray]
    ) -> Dict[int, np.ndarray]:
        chosen, inv = self.decode_selection(set(want_to_read), set(chunks))
        out: Dict[int, np.ndarray] = {}
        # reconstruct ONLY the missing rows (the reference decodes erased
        # chunks, not all k): available chunks pass through untouched, so
        # the matmul shrinks from k rows to n_lost rows — typically a
        # k/n_lost compute cut on every degraded read and recovery
        need_coding = sorted(c for c in want_to_read
                             if c >= self.k and c not in chunks)
        # rebuild only the data rows somebody needs: the requested ones,
        # plus ALL missing data rows when a coding chunk must be re-made
        # (its generator row spans every data row)
        missing_data = sorted(
            c for c in range(self.k) if c not in chunks
            and (need_coding or c in want_to_read))
        if missing_data:
            with span("ec.stack_survivors"):
                src = np.stack([np.asarray(chunks[c], dtype=np.uint8)
                                for c in chosen])
            rebuilt = self._apply(inv[missing_data], src)
            for i, c in enumerate(missing_data):
                out[c] = rebuilt[i]
        if need_coding:
            # coding rows = their generator rows applied to the full data
            # rows (reconstructed ones + pass-through survivors)
            data_rows = np.stack([
                out[c] if c in out
                else np.asarray(chunks[c], dtype=np.uint8)
                for c in range(self.k)])
            coding = self._apply(
                self.matrix[[c - self.k for c in need_coding]], data_rows)
            for i, c in enumerate(need_coding):
                out[c] = coding[i]
        for c in want_to_read:
            if c in chunks:
                out[c] = np.asarray(chunks[c], dtype=np.uint8)
        # contract (interface.py): return exactly the requested subset —
        # helper rows rebuilt for a coding reconstruction stay internal
        return {c: v for c, v in out.items() if c in want_to_read}

    def bit_generator(self) -> np.ndarray:
        return matrix_to_bitmatrix(self.matrix, self.w)

    bit_layout = "byte"


class BitmatrixErasureCode(ErasureCode):
    """Systematic GF(2) bit-matrix code over packet rows (cauchy/liberation
    machinery: reference jerasure_schedule_encode semantics, packetsize
    granularity)."""

    technique = "bitmatrix"
    bit_layout = "packet"

    def __init__(self) -> None:
        super().__init__()
        self.w = 8
        self.packetsize = 2048
        self.bitmatrix: Optional[np.ndarray] = None  # [m*w, k*w]
        self._decode_cache = DecodeMatrixCache()

    def get_alignment(self) -> int:
        return self.k * self.w * self.packetsize * SIZEOF_INT

    def get_chunk_size(self, stripe_width: int) -> int:
        alignment = self.get_alignment()
        padded = -(-stripe_width // alignment) * alignment if stripe_width else alignment
        assert padded % self.k == 0
        return padded // self.k

    # -- packet-row plumbing -------------------------------------------------

    def _to_rows(self, data: np.ndarray) -> np.ndarray:
        """[n, chunk] -> [n*w, nblocks, packetsize] packet bit-rows."""
        n, chunk = data.shape
        wp = self.w * self.packetsize
        if chunk % wp:
            raise ErasureCodeError(
                -errno.EINVAL, f"chunk size {chunk} not a multiple of w*packetsize={wp}"
            )
        nb = chunk // wp
        with span("ec.to_rows"):
            return (
                data.reshape(n, nb, self.w, self.packetsize)
                .transpose(0, 2, 1, 3)
                .reshape(n * self.w, nb, self.packetsize)
            )

    def _from_rows(self, rows: np.ndarray) -> np.ndarray:
        nw = rows.shape[0]
        n = nw // self.w
        nb = rows.shape[1]
        with span("ec.from_rows"):
            return (
                rows.reshape(n, self.w, nb, self.packetsize)
                .transpose(0, 2, 1, 3)
                .reshape(n, nb * self.w * self.packetsize)
            )

    def _apply_rows(self, bm: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """Apply a GF(2) bit-matrix to packet rows — the compute seam the
        tpu plugin overrides (same role as MatrixErasureCode._apply)."""
        return gf2_combine(bm, rows)

    def encode_chunks(self, data: np.ndarray) -> np.ndarray:
        if data.shape[0] != self.k:
            raise ErasureCodeError(-errno.EINVAL, "wrong data chunk count")
        rows = self._to_rows(np.ascontiguousarray(data, dtype=np.uint8))
        return self._from_rows(self._apply_rows(self.bitmatrix, rows))

    def _decode_bitmatrix(self, chosen: Tuple[int, ...]) -> np.ndarray:
        cached = self._decode_cache.get(chosen)
        if cached is not None:
            return cached
        kw = self.k * self.w
        full = np.vstack([np.eye(kw, dtype=np.uint8), self.bitmatrix])
        sub = np.vstack([full[c * self.w : (c + 1) * self.w] for c in chosen])
        try:
            inv = invert_bitmatrix(sub)
        except np.linalg.LinAlgError as e:
            raise ErasureCodeError(
                -errno.EIO, f"chunk set {chosen} not decodable: {e}"
            ) from e
        self._decode_cache.put(chosen, inv)
        return inv

    def decode_chunks(
        self, want_to_read: Set[int], chunks: Mapping[int, np.ndarray]
    ) -> Dict[int, np.ndarray]:
        available = set(chunks)
        with span("ec.decode_select"):
            plan = self.minimum_to_decode(
                set(range(self.k)) | set(want_to_read), available)
            chosen = tuple(sorted(plan))[: self.k]
            inv = self._decode_bitmatrix(chosen)
        with span("ec.stack_survivors"):
            src_rows = np.concatenate(
                [self._to_rows(np.asarray(chunks[c], dtype=np.uint8)[None, :])
                 for c in chosen]
            )
        data_rows = self._apply_rows(inv, src_rows)
        out: Dict[int, np.ndarray] = {}
        need_coding = [c for c in want_to_read if c >= self.k]
        coding_rows = self._apply_rows(self.bitmatrix, data_rows) if need_coding else None
        for c in want_to_read:
            if c in chunks:
                out[c] = np.asarray(chunks[c], dtype=np.uint8)
            elif c < self.k:
                out[c] = self._from_rows(data_rows[c * self.w : (c + 1) * self.w])[0]
            else:
                out[c] = self._from_rows(
                    coding_rows[(c - self.k) * self.w : (c - self.k + 1) * self.w]
                )[0]
        return out

    def bit_generator(self) -> np.ndarray:
        return self.bitmatrix
