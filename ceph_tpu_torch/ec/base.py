"""ErasureCode base class: padding, profile parsing, generic encode/decode.

Equivalent of the reference's ceph::ErasureCode (src/erasure-code/
ErasureCode.{h,cc}): profile parse helpers (to_int/to_bool, ErasureCode.h),
encode_prepare zero-padding semantics (ErasureCode.cc:187-203), greedy
first-k-available _minimum_to_decode (ErasureCode.cc:102-119), _decode
zero-fills missing buffers then delegates to decode_chunks
(ErasureCode.cc:205-241).
"""

from __future__ import annotations

import errno
from typing import Dict, List, Mapping, Set

import numpy as np

from ceph_tpu_torch.common.tracing import span
from ceph_tpu_torch.ec.interface import (
    ErasureCodeError,
    ErasureCodeInterface,
    ErasureCodeProfile,
    SubChunkPlan,
)

# The reference aligns carved buffers to SIMD_ALIGN=32 (ErasureCode.cc:42);
# numpy allocations are at least 16-byte aligned and chunk math below keeps
# chunk sizes multiples of the per-codec alignment, which is what byte
# layouts actually depend on.
SIMD_ALIGN = 32


def to_int(profile: ErasureCodeProfile, key: str, default: int) -> int:
    raw = profile.get(key)
    if raw in (None, ""):
        return default
    try:
        return int(raw)
    except ValueError:
        raise ErasureCodeError(-errno.EINVAL, f"{key}={raw!r} is not an int")


def to_bool(profile: ErasureCodeProfile, key: str, default: bool) -> bool:
    raw = profile.get(key)
    if raw in (None, ""):
        return default
    return str(raw).lower() in ("1", "true", "yes", "on")


class ErasureCode(ErasureCodeInterface):
    """Default implementations shared by all codecs."""

    def __init__(self) -> None:
        self._profile: ErasureCodeProfile = {}
        self.chunk_mapping: List[int] = []

    # subclasses set these in init()
    k: int = 0
    m: int = 0

    # id space decode_chunks speaks: "logical" codecs (everything except
    # lrc) index data 0..k-1 / coding k..k+m-1 and base.decode remaps
    # physical ids through chunk_mapping for them; "physical" codecs (lrc)
    # take mapped ids directly
    decode_chunks_id_space: str = "logical"

    def get_profile(self) -> ErasureCodeProfile:
        return self._profile

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_coding_chunk_count(self) -> int:
        return self.m

    def get_chunk_mapping(self) -> List[int]:
        return self.chunk_mapping

    def parse_chunk_mapping(self, profile: ErasureCodeProfile) -> None:
        """Reference ErasureCode::to_mapping (ErasureCode.cc:260-279):
        'mapping' is a string over physical positions; 'D' positions hold
        the data chunks in order, every other position holds coding chunks.
        chunk_mapping[logical id] = physical position."""
        mapping = profile.get("mapping")
        if not mapping:
            self.chunk_mapping = []
            return
        data_positions = [i for i, ch in enumerate(mapping) if ch == "D"]
        coding_positions = [i for i, ch in enumerate(mapping) if ch != "D"]
        self.chunk_mapping = data_positions + coding_positions

    def chunk_index(self, i: int) -> int:
        """Logical chunk id -> physical position (reference
        ErasureCode::chunk_index, ErasureCode.cc:97-100)."""
        return self.chunk_mapping[i] if i < len(self.chunk_mapping) else i

    # -- chunk selection ----------------------------------------------------

    def _full_chunk_plan(self, chunks: Set[int]) -> SubChunkPlan:
        sc = self.get_sub_chunk_count()
        return {c: [(0, sc)] for c in chunks}

    def minimum_to_decode(
        self, want_to_read: Set[int], available: Set[int]
    ) -> SubChunkPlan:
        if want_to_read <= available:
            return self._full_chunk_plan(set(want_to_read))
        k = self.get_data_chunk_count()
        if len(available) < k:
            raise ErasureCodeError(
                -errno.EIO,
                f"cannot decode: {len(available)} chunks available, need {k}",
            )
        return self._full_chunk_plan(set(sorted(available)[:k]))

    # -- full-object paths --------------------------------------------------

    def encode_prepare(self, data: bytes, blocksize: int) -> np.ndarray:
        """Zero-pad `data` to k*blocksize and carve into [k, blocksize]
        (reference encode_prepare: pad_len zero fill of the tail chunks)."""
        k = self.get_data_chunk_count()
        with span("ec.encode_prepare"):
            buf = np.zeros(k * blocksize, dtype=np.uint8)
            raw = np.frombuffer(data, dtype=np.uint8)
            buf[: raw.size] = raw
            return buf.reshape(k, blocksize)

    def encode(self, want_to_encode: Set[int], data: bytes) -> Dict[int, np.ndarray]:
        with span("ec.encode"):
            k, m = self.get_data_chunk_count(), self.get_coding_chunk_count()
            bad = {c for c in want_to_encode if c >= k + m}
            if bad:
                raise ErasureCodeError(-errno.EINVAL, f"invalid chunk ids {bad}")
            blocksize = self.get_chunk_size(len(data))
            chunks = self.encode_prepare(data, blocksize)
            coding = self.encode_chunks(chunks)
            # chunk ids in the result are physical positions (chunk_index remap,
            # identity for codecs without a 'mapping' profile)
            out: Dict[int, np.ndarray] = {}
            phys = {self.chunk_index(i): i for i in range(k + m)}
            for c in want_to_encode:
                logical = phys[c]
                out[c] = chunks[logical] if logical < k else coding[logical - k]
            return out

    def decode(
        self, want_to_read: Set[int], chunks: Mapping[int, np.ndarray], chunk_size: int
    ) -> Dict[int, np.ndarray]:
        with span("ec.decode"):
            for c, buf in chunks.items():
                if len(buf) != chunk_size:
                    raise ErasureCodeError(
                        -errno.EINVAL,
                        f"chunk {c} has size {len(buf)} != {chunk_size}",
                    )
            if want_to_read <= set(chunks):
                return {c: np.asarray(chunks[c]) for c in want_to_read}
            # ensure decodability before delegating
            self.minimum_to_decode(set(want_to_read), set(chunks))
            if not self.chunk_mapping or self.decode_chunks_id_space == "physical":
                return self.decode_chunks(set(want_to_read), chunks)
            # chunk ids at this boundary are physical; decode_chunks is logical
            logical_of = {
                self.chunk_index(i): i for i in range(self.get_chunk_count())
            }
            log_chunks = {logical_of[c]: buf for c, buf in chunks.items()}
            log_want = {logical_of[c] for c in want_to_read}
            decoded = self.decode_chunks(log_want, log_chunks)
            return {self.chunk_index(c): buf for c, buf in decoded.items()}

    # -- default create_rule -------------------------------------------------

    def create_rule(self, name: str, crush) -> int:
        """Simple indep rule over k+m distinct devices (reference
        ErasureCode::create_rule uses add_simple_rule(..., "indep",
        TYPE_ERASURE), ErasureCode.cc:64-82)."""
        return crush.add_simple_rule(
            name, root="default", failure_domain="host", mode="indep"
        )
