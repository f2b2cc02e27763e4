# Copy of ceph_tpu/ec/plugins/shec.py at commit 6e1c6d1, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""SHEC plugin: Shingled Erasure Code (multiple/single variants).

Equivalent of the reference's shec plugin (reference
src/erasure-code/shec/ErasureCodeShec.{h,cc}): a non-MDS code trading extra
parity for cheaper single-failure recovery.  Each of the m parity rows
covers only a contiguous wrap-around window of the k data chunks ("shingle"),
so recovering one lost data chunk reads only the chunks in one window
instead of k.

Construction (ErasureCodeShec.cc:465-533): start from the jerasure
Vandermonde coding matrix, then zero the entries outside each row's window.
The MULTIPLE (default) variant splits the m rows into two shingle groups
(m1, c1) / (m2, c2), chosen by exhaustive search minimizing the
recovery-efficiency metric r_e1 (ErasureCodeShec.cc:424-462); SINGLE uses
one group (m1=c1=0).

Recovery (ErasureCodeShec.cc:535-765): brute-force over all 2^m parity
subsets for the smallest square solvable system covering the wanted missing
chunks — this is minimum_to_decode, and the found plan (rows, columns,
inverted submatrix) is LRU-cached per (want, avail) signature like the
reference's ErasureCodeShecTableCache.  minimum_to_decode_with_cost
delegates to the same search (ErasureCodeShec.cc:125-137).

Device note: the solve produces a small GF(2^w) matrix; the regeneration
is the same symbol-region matmul every other codec uses, so the OSD's queue
drives SHEC through the packed-bit kernels via ``bit_generator``.
"""

from __future__ import annotations

import errno
from typing import Dict, List, Mapping, Optional, Set, Tuple

import numpy as np

from ceph_tpu_torch import PLUGIN_ABI_VERSION
from ceph_tpu_torch.ec.base import to_int
from ceph_tpu_torch.ec.codecs import (
    SIZEOF_INT,
    DecodeMatrixCache,
    MatrixErasureCode,
)
from ceph_tpu_torch.ec.gf import gf
from ceph_tpu_torch.ec.interface import ErasureCodeError, ErasureCodeProfile, SubChunkPlan
from ceph_tpu_torch.ec.matrices import vandermonde_coding_matrix
from ceph_tpu_torch.ec.registry import ErasureCodePlugin

DEFAULT_K, DEFAULT_M, DEFAULT_C, DEFAULT_W = 4, 3, 2, 8

MULTIPLE, SINGLE = 0, 1  # reference ErasureCodeShec.h:31-32


def _window(rr: int, rows: int, c: int, k: int) -> Tuple[int, int]:
    """The zeroed span of shingle row rr out of `rows` with overlap c:
    entries from start (inclusive) walking forward with wraparound to end
    (exclusive) are zeroed (reference ErasureCodeShec.cc:515-530)."""
    end = ((rr * k) // rows) % k
    start = (((rr + c) * k) // rows) % k
    return start, end


def shec_calc_recovery_efficiency1(k: int, m1: int, m2: int, c1: int, c2: int) -> float:
    """Reference ErasureCodeShec.cc:424-462: total window width over all
    shingle rows (lower = cheaper recovery)."""
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    r_e1 = 0.0
    for rows, c in ((m1, c1), (m2, c2)):
        for rr in range(rows):
            r_e1 += ((rr + c) * k) // rows - (rr * k) // rows
    return r_e1


def shec_coding_matrix(k: int, m: int, c: int, w: int, single: bool) -> np.ndarray:
    """Reference shec_reedsolomon_coding_matrix (ErasureCodeShec.cc:465-533):
    Vandermonde coding matrix with per-row windows zeroed out."""
    if single:
        m1, c1, m2, c2 = 0, 0, m, c
    else:
        best = None
        for c1 in range(c // 2 + 1):
            for m1 in range(m + 1):
                c2, m2 = c - c1, m - m1
                if m1 < c1 or m2 < c2:
                    continue
                if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
                    continue
                if (m1 != 0 and c1 == 0) or (m2 != 0 and c2 == 0):
                    continue
                r = shec_calc_recovery_efficiency1(k, m1, m2, c1, c2)
                if best is None or r < best[0] - np.finfo(float).eps:
                    best = (r, c1, m1)
        if best is None:
            raise ErasureCodeError(
                -errno.EINVAL, f"no valid shec shingle split for k={k} m={m} c={c}"
            )
        _, c1, m1 = best
        c2, m2 = c - c1, m - m1

    matrix = vandermonde_coding_matrix(k, m, w)
    for base, rows, cc_ in ((0, m1, c1), (m1, m2, c2)):
        for rr in range(rows):
            start, end = _window(rr, rows, cc_, k)
            col = start
            while col != end:
                matrix[base + rr, col] = 0
                col = (col + 1) % k
    return matrix


class ErasureCodeShec(MatrixErasureCode):
    """technique SINGLE/MULTIPLE selected by the plugin name suffix
    (reference registers shec as MULTIPLE by default)."""

    plugin_name = "shec"
    technique = "multiple"

    def __init__(self, single: bool = False) -> None:
        super().__init__()
        self.single = single
        self.c = DEFAULT_C
        self._plan_cache = DecodeMatrixCache(capacity=256)

    # -- lifecycle ----------------------------------------------------------

    def init(self, profile: ErasureCodeProfile) -> None:
        profile = dict(profile)
        has = [x in profile for x in ("k", "m", "c")]
        if not any(has):
            self.k, self.m, self.c = DEFAULT_K, DEFAULT_M, DEFAULT_C
        elif not all(has):
            raise ErasureCodeError(-errno.EINVAL, "(k, m, c) must be chosen together")
        else:
            self.k = to_int(profile, "k", DEFAULT_K)
            self.m = to_int(profile, "m", DEFAULT_M)
            self.c = to_int(profile, "c", DEFAULT_C)
        self.w = to_int(profile, "w", DEFAULT_W)
        # parameter envelope: reference ErasureCodeShec.cc:280-346
        if self.k <= 0 or self.m <= 0 or self.c <= 0:
            raise ErasureCodeError(-errno.EINVAL, "k, m, c must be positive")
        if self.m < self.c:
            raise ErasureCodeError(
                -errno.EINVAL, f"c={self.c} must be <= m={self.m}"
            )
        if self.k > 12:
            raise ErasureCodeError(-errno.EINVAL, f"k={self.k} must be <= 12")
        if self.k + self.m > 20:
            raise ErasureCodeError(-errno.EINVAL, "k+m must be <= 20")
        if self.k < self.m:
            raise ErasureCodeError(
                -errno.EINVAL, f"m={self.m} must be <= k={self.k}"
            )
        if self.w not in (8, 16):
            # reference allows 32 too; uint32 symbol regions not supported here
            self.w = DEFAULT_W
        self.parse_chunk_mapping(profile)
        self.matrix = shec_coding_matrix(self.k, self.m, self.c, self.w, self.single)
        profile["plugin"] = self.plugin_name
        profile.setdefault("technique", self.technique)
        profile.setdefault("k", str(self.k))
        profile.setdefault("m", str(self.m))
        profile.setdefault("c", str(self.c))
        profile.setdefault("w", str(self.w))
        self._profile = profile

    def get_alignment(self) -> int:
        return self.k * self.w * SIZEOF_INT

    # -- recovery-plan search ----------------------------------------------

    def _make_decoding_plan(
        self, want: np.ndarray, avails: np.ndarray
    ) -> Tuple[List[int], List[int], np.ndarray, Set[int]]:
        """Port of shec_make_decoding_matrix (ErasureCodeShec.cc:535-763).

        Returns (dm_row chunk-ids, dm_column data-ids, inverted submatrix,
        minimum chunk set).  Raises ErasureCodeError(EIO) when no parity
        subset solves the erasure pattern (shec is not MDS)."""
        k, m = self.k, self.m
        want = want.copy()
        # wanting a missing parity implies wanting its data support
        for i in range(m):
            if want[k + i] and not avails[k + i]:
                for j in range(k):
                    if self.matrix[i, j]:
                        want[j] = 1

        key = ("plan", bytes(want.tolist()), bytes(avails.tolist()))
        cached = self._plan_cache.get(key)
        if cached is not None:
            return cached

        f = gf(self.w)
        mindup = k + 1
        minp = k + 1
        best: Optional[Tuple[List[int], List[int]]] = None
        for pp in range(1 << m):
            parities = [i for i in range(m) if pp & (1 << i)]
            if len(parities) > minp:
                continue
            if any(not avails[k + p] for p in parities):
                continue
            tmprow = np.zeros(k + m, dtype=np.int8)
            tmpcol = np.zeros(k, dtype=np.int8)
            for i in range(k):
                if want[i] and not avails[i]:
                    tmpcol[i] = 1
            for p in parities:
                tmprow[k + p] = 1
                for j in range(k):
                    if self.matrix[p, j]:
                        tmpcol[j] = 1
                        if avails[j]:
                            tmprow[j] = 1
            dup_row = int(tmprow.sum())
            dup_col = int(tmpcol.sum())
            if dup_row != dup_col:
                continue
            if dup_row == 0:
                mindup = 0
                best = ([], [])
                break
            if dup_row < mindup:
                rows = [i for i in range(k + m) if tmprow[i]]
                cols = [j for j in range(k) if tmpcol[j]]
                sub = np.zeros((dup_row, dup_row), dtype=np.int64)
                for i, r in enumerate(rows):
                    for j, ccol in enumerate(cols):
                        sub[i, j] = 1 if (r < k and r == ccol) else (
                            0 if r < k else int(self.matrix[r - k, ccol])
                        )
                try:
                    f.invert_matrix(sub)  # det != 0 check
                except np.linalg.LinAlgError:
                    continue
                mindup = dup_row
                best = (rows, cols)
                minp = len(parities)

        if best is None:
            raise ErasureCodeError(
                -errno.EIO,
                f"shec: no recovery set for want={np.flatnonzero(want).tolist()} "
                f"avail={np.flatnonzero(avails).tolist()}",
            )
        rows, cols = best
        if mindup:
            sub = np.zeros((mindup, mindup), dtype=np.int64)
            for i, r in enumerate(rows):
                for j, ccol in enumerate(cols):
                    sub[i, j] = 1 if (r < k and r == ccol) else (
                        0 if r < k else int(self.matrix[r - k, ccol])
                    )
            inv = f.invert_matrix(sub)
        else:
            inv = np.zeros((0, 0), dtype=np.int64)

        # minimum chunk set (reference ErasureCodeShec.cc:704-727)
        minimum: Set[int] = set(rows)
        for i in range(k):
            if want[i] and avails[i]:
                minimum.add(i)
        for i in range(m):
            if want[k + i] and avails[k + i] and (k + i) not in minimum:
                if any(self.matrix[i, j] and not want[j] for j in range(k)):
                    minimum.add(k + i)
        result = (rows, cols, inv, minimum)
        self._plan_cache.put(key, result)
        return result

    def _vectors(self, want_to_read: Set[int], available: Set[int]):
        want = np.zeros(self.k + self.m, dtype=np.int8)
        avails = np.zeros(self.k + self.m, dtype=np.int8)
        for i in want_to_read:
            if not 0 <= i < self.k + self.m:
                raise ErasureCodeError(-errno.EINVAL, f"bad chunk id {i}")
            want[i] = 1
        for i in available:
            if not 0 <= i < self.k + self.m:
                raise ErasureCodeError(-errno.EINVAL, f"bad chunk id {i}")
            avails[i] = 1
        return want, avails

    def minimum_to_decode(
        self, want_to_read: Set[int], available: Set[int]
    ) -> SubChunkPlan:
        want, avails = self._vectors(want_to_read, available)
        _, _, _, minimum = self._make_decoding_plan(want, avails)
        return self._full_chunk_plan(minimum)

    def minimum_to_decode_with_cost(
        self, want_to_read: Set[int], available: Mapping[int, int]
    ) -> Set[int]:
        """Reference delegates to the same search regardless of cost
        (ErasureCodeShec.cc:125-137) — the shingle structure itself is the
        cost optimization."""
        return set(self.minimum_to_decode(want_to_read, set(available)).keys())

    # -- decode -------------------------------------------------------------

    def decode_chunks(
        self, want_to_read: Set[int], chunks: Mapping[int, np.ndarray]
    ) -> Dict[int, np.ndarray]:
        k = self.k
        want, avails = self._vectors(set(want_to_read), set(chunks))
        rows, cols, inv, _ = self._make_decoding_plan(want, avails)

        values: Dict[int, np.ndarray] = {
            c: np.asarray(v, dtype=np.uint8) for c, v in chunks.items()
        }
        if rows:
            src = np.stack([values[r] for r in rows])
            solved = self._apply(inv, src)
            for j, ccol in enumerate(cols):
                if ccol not in values:
                    values[ccol] = solved[j]
        # re-encode wanted missing parities from their (now present) support
        for i in range(self.m):
            cid = k + i
            if want[cid] and cid not in values:
                support = [j for j in range(k) if self.matrix[i, j]]
                sub = self.matrix[i : i + 1, support]
                stackin = np.stack([values[j] for j in support])
                values[cid] = self._apply(sub, stackin)[0]
        return {c: values[c] for c in want_to_read}


class ShecPlugin(ErasureCodePlugin):
    def factory(self, profile: ErasureCodeProfile, device=None):
        technique = profile.get("technique", "multiple")
        if technique not in ("single", "multiple"):
            raise ErasureCodeError(
                -errno.ENOENT,
                f"technique={technique} is not a valid shec technique "
                "(have ['multiple', 'single'])",
            )
        codec = ErasureCodeShec(single=technique == "single")
        codec.technique = technique
        codec.init(dict(profile, technique=technique))
        return codec


def __erasure_code_version__() -> str:
    return PLUGIN_ABI_VERSION


def __erasure_code_init__(name: str, registry) -> int:
    registry.add(name, ShecPlugin())
    return 0
