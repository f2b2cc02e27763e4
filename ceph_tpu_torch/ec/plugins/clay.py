# Copy of ceph_tpu/ec/plugins/clay.py at commit 6e1c6d1, with its ceph_tpu
# import statements rebound to ceph_tpu_torch, the codec's device passed on
# to the mds and pft factories (ec/registry.py), and scalar_mds=cuda in
# place of the reference's scalar_mds=tpu.
"""CLAY plugin: Coupled-LAYer MSR regenerating code.

Equivalent of the reference's clay plugin (reference
src/erasure-code/clay/ErasureCodeClay.{h,cc}; Vajha et al., "Clay Codes:
Moulding MDS Codes to Yield an MSR Code", FAST 2018).

Geometry: nodes live on a (x, y) grid with x in [0,q), y in [0,t) where
q = d - k + 1 and q*t = k + m + nu (nu virtual zero chunks shorten the code
when q does not divide k+m).  Every chunk is divided into sub_chunk_no =
q^t sub-chunks ("planes"), a plane indexed by its base-q digit vector
z_vec[t].  Within plane z, node (x, y) is *coupled* with node (z_vec[y], y)
of plane z_sw = z + (x - z_vec[y])*q^(t-1-y); a 2+2 inner MDS code (the
"pairwise forward transform", pft) converts between the coupled pair
(C1, C2) and the uncoupled pair (U1, U2).  A second inner MDS code over
k+nu data + m parities (mds) decodes each uncoupled plane.  Both inner
codecs are instantiated THROUGH THE REGISTRY from the scalar_mds profile
key (jerasure | isa | shec), reference ErasureCodeClay.cc:72-86.

Repair of one lost chunk reads only sub_chunk_no/q sub-chunks from each of
d helpers (the MSR property): minimum_to_decode returns per-chunk
(sub-chunk offset, count) runs — this is why ErasureCodeInterface has
sub-chunk semantics and why the OSD read path supports fragmented shard
reads (reference ECBackend.cc:1049-1071).

Device note: every pft/mds application is a GF(2^8) matmul over
sc_size-byte regions; planes with equal erasure signature share matrices, so
plane loops could batch into one packed-bit kernel launch (not done: with
scalar_mds=cuda each plane's call is its own launch through the inner
codecs' _apply seam).
"""

from __future__ import annotations

import errno
from typing import Dict, List, Mapping, Optional, Set, Tuple

import numpy as np

from ceph_tpu_torch import PLUGIN_ABI_VERSION
from ceph_tpu_torch.ec.base import ErasureCode, to_int
from ceph_tpu_torch.ec.interface import ErasureCodeError, ErasureCodeProfile, SubChunkPlan
from ceph_tpu_torch.ec.registry import ErasureCodePlugin

DEFAULT_K, DEFAULT_M, DEFAULT_W = 4, 2, 8


class ErasureCodeClay(ErasureCode):
    plugin_name = "clay"

    def __init__(self, directory: str = "", device=None):
        super().__init__()
        self.directory = directory
        self.device = device  # passed on to the mds and pft factories
        self.d = 0
        self.q = 0
        self.t = 0
        self.nu = 0
        self.sub_chunk_no = 0
        self.mds = None  # inner MDS codec over k+nu data, m coding
        self.pft = None  # inner 2+2 pairwise transform codec

    # -- lifecycle -----------------------------------------------------------

    def init(self, profile: ErasureCodeProfile) -> None:
        profile = dict(profile)
        self.k = to_int(profile, "k", DEFAULT_K)
        self.m = to_int(profile, "m", DEFAULT_M)
        self.w = to_int(profile, "w", DEFAULT_W)
        if self.k < 1 or self.m < 1:
            raise ErasureCodeError(-errno.EINVAL, "k and m must be >= 1")
        self.d = to_int(profile, "d", self.k + self.m - 1)
        if not self.k <= self.d <= self.k + self.m - 1:
            raise ErasureCodeError(
                -errno.EINVAL,
                f"value of d {self.d} must be within [{self.k}, {self.k + self.m - 1}]",
            )
        scalar_mds = profile.get("scalar_mds", "") or "jerasure"
        # 'cuda' is an extension over the reference's jerasure|isa|shec (it
        # takes the place of ceph_tpu's 'tpu'): the inner codecs then
        # dispatch through the port's packed-bit kernels
        if scalar_mds not in ("jerasure", "isa", "shec", "cuda"):
            raise ErasureCodeError(
                -errno.EINVAL,
                f"scalar_mds {scalar_mds} is not currently supported, "
                "use one of 'jerasure', 'isa', 'shec', 'cuda'",
            )
        technique = profile.get("technique", "") or (
            "single" if scalar_mds == "shec" else "reed_sol_van"
        )
        allowed = {
            "jerasure": (
                "reed_sol_van", "reed_sol_r6_op", "cauchy_orig",
                "cauchy_good", "liber8tion",
            ),
            "isa": ("reed_sol_van", "cauchy"),
            "shec": ("single", "multiple"),
            "cuda": (
                "reed_sol_van", "reed_sol_r6_op", "cauchy_orig",
                "cauchy_good", "liber8tion",
            ),
        }[scalar_mds]
        if technique not in allowed:
            raise ErasureCodeError(
                -errno.EINVAL,
                f"technique {technique} is not supported with {scalar_mds}, "
                f"use one of {allowed}",
            )

        self.q = self.d - self.k + 1
        rem = (self.k + self.m) % self.q
        self.nu = self.q - rem if rem else 0
        if self.k + self.m + self.nu > 254:
            raise ErasureCodeError(-errno.EINVAL, "k+m+nu must be <= 254")
        self.t = (self.k + self.m + self.nu) // self.q
        self.sub_chunk_no = self.q ** self.t

        from ceph_tpu_torch.ec.registry import registry

        mds_profile = {
            "plugin": scalar_mds, "technique": technique,
            "k": str(self.k + self.nu), "m": str(self.m), "w": "8",
        }
        pft_profile = {
            "plugin": scalar_mds, "technique": technique,
            "k": "2", "m": "2", "w": "8",
        }
        if scalar_mds == "shec":
            mds_profile["c"] = "2"
            pft_profile["c"] = "2"
        self.mds = registry.factory(scalar_mds, self.directory, mds_profile,
                                    device=self.device)
        self.pft = registry.factory(scalar_mds, self.directory, pft_profile,
                                    device=self.device)

        profile["plugin"] = self.plugin_name
        profile.setdefault("k", str(self.k))
        profile.setdefault("m", str(self.m))
        profile.setdefault("d", str(self.d))
        profile.setdefault("w", str(self.w))
        self._profile = profile

    # -- geometry ------------------------------------------------------------

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_no

    def get_chunk_size(self, stripe_width: int) -> int:
        """Reference ErasureCodeClay::get_chunk_size: align the object to
        sub_chunk_no * k * (pft chunk alignment) then divide by k."""
        scalar_align = self.pft.get_chunk_size(1)
        alignment = self.sub_chunk_no * self.k * scalar_align
        padded = (
            -(-stripe_width // alignment) * alignment if stripe_width else alignment
        )
        return padded // self.k

    # -- node/plane index helpers -------------------------------------------

    def _node_id(self, chunk: int) -> int:
        """Chunk id -> internal node id (parities shift past the nu
        virtual chunks)."""
        return chunk if chunk < self.k else chunk + self.nu

    def _chunk_id(self, node: int) -> Optional[int]:
        """Internal node id -> chunk id; None for virtual nodes."""
        if node < self.k:
            return node
        if node < self.k + self.nu:
            return None
        return node - self.nu

    def _plane_vector(self, z: int) -> np.ndarray:
        """Base-q digits of plane z (get_plane_vector)."""
        z_vec = np.zeros(self.t, dtype=np.int64)
        for i in range(self.t):
            z_vec[self.t - 1 - i] = z % self.q
            z //= self.q
        return z_vec

    def _z_sw(self, z: int, x: int, y: int, z_vec) -> int:
        return z + (x - int(z_vec[y])) * self.q ** (self.t - 1 - y)

    # -- repair eligibility / planning --------------------------------------

    def is_repair(self, want_to_read: Set[int], available: Set[int]) -> bool:
        """One lost chunk, its whole y-row otherwise intact, >= d helpers
        (reference ErasureCodeClay.cc:305-324)."""
        if want_to_read <= available:
            return False
        if len(want_to_read) > 1:
            return False
        lost = next(iter(want_to_read))
        lost_node = self._node_id(lost)
        y = lost_node // self.q
        for x in range(self.q):
            node = y * self.q + x
            chunk = node if node < self.k else node - self.nu
            if node >= self.k and node < self.k + self.nu:
                continue  # virtual node, always "available" (zeros)
            if chunk != lost and chunk not in available:
                return False
        return len(available) >= self.d

    def get_repair_subchunks(self, lost_node: int) -> List[Tuple[int, int]]:
        """(offset, count) runs of the sub-chunks needed to repair
        lost_node (reference ErasureCodeClay.cc:365-380): the planes whose
        y_lost digit equals x_lost."""
        y_lost, x_lost = lost_node // self.q, lost_node % self.q
        seq_sc_count = self.q ** (self.t - 1 - y_lost)
        num_seq = self.q ** y_lost
        runs = []
        index = x_lost * seq_sc_count
        for _ in range(num_seq):
            runs.append((index, seq_sc_count))
            index += self.q * seq_sc_count
        return runs

    def get_repair_sub_chunk_count(self, want_to_read: Set[int]) -> int:
        weight = np.zeros(self.t, dtype=np.int64)
        for chunk in want_to_read:
            weight[self._node_id(chunk) // self.q] += 1
        remaining = 1
        for y in range(self.t):
            remaining *= self.q - int(weight[y])
        return self.sub_chunk_no - remaining

    def minimum_to_decode(
        self, want_to_read: Set[int], available: Set[int]
    ) -> SubChunkPlan:
        if self.is_repair(want_to_read, available):
            return self._minimum_to_repair(want_to_read, available)
        return super().minimum_to_decode(want_to_read, available)

    def _minimum_to_repair(
        self, want_to_read: Set[int], available: Set[int]
    ) -> SubChunkPlan:
        """Reference minimum_to_repair (ErasureCodeClay.cc:326-363): the
        q-1 same-row nodes plus enough other helpers to reach d, each
        contributing only the repair sub-chunk runs."""
        lost = next(iter(want_to_read))
        lost_node = self._node_id(lost)
        runs = self.get_repair_subchunks(lost_node)
        minimum: SubChunkPlan = {}
        y = lost_node // self.q
        for x in range(self.q):
            node = y * self.q + x
            if node == lost_node:
                continue
            chunk = self._chunk_id(node)
            if chunk is not None:
                minimum[chunk] = list(runs)
        for chunk in sorted(available):
            if len(minimum) >= self.d:
                break
            if chunk not in minimum and chunk != lost:
                minimum[chunk] = list(runs)
        if len(minimum) != self.d:
            raise ErasureCodeError(-errno.EIO, "not enough helpers for repair")
        return minimum

    # -- coupled/uncoupled pair solves ---------------------------------------

    def _pft_solve(
        self, known: Dict[int, np.ndarray], want: Set[int]
    ) -> Dict[int, np.ndarray]:
        """Solve the 2+2 pairwise transform: ids 0,1 = coupled pair (in
        x-ascending order), 2,3 = uncoupled pair.  Any two known values
        determine the rest via the inner MDS code."""
        return self.pft.decode_chunks(want, known)

    # -- full decode (decode_layered machinery) ------------------------------

    def encode_chunks(self, data: np.ndarray) -> np.ndarray:
        """[k, chunk] -> [m, chunk]: treat the m parity nodes as erasures
        and run the layered decode (reference encode_chunks,
        ErasureCodeClay.cc:127-156)."""
        if data.shape[0] != self.k:
            raise ErasureCodeError(-errno.EINVAL, "wrong data chunk count")
        chunk_size = data.shape[1]
        nodes = self._make_node_buffers(chunk_size)
        for i in range(self.k):
            nodes[i] = self._carve(data[i])
        erasures = {self.k + self.nu + j for j in range(self.m)}
        self._decode_layered(set(erasures), nodes, chunk_size)
        return np.stack(
            [self._flatten(nodes[self.k + self.nu + j]) for j in range(self.m)]
        )

    def decode_chunks(
        self, want_to_read: Set[int], chunks: Mapping[int, np.ndarray]
    ) -> Dict[int, np.ndarray]:
        chunk_size = len(next(iter(chunks.values())))
        nodes = self._make_node_buffers(chunk_size)
        erasures: Set[int] = set()
        for chunk in range(self.k + self.m):
            node = self._node_id(chunk)
            if chunk in chunks:
                nodes[node] = self._carve(np.asarray(chunks[chunk], dtype=np.uint8))
            else:
                erasures.add(node)
        self._decode_layered(erasures, nodes, chunk_size)
        return {
            c: self._flatten(nodes[self._node_id(c)]) for c in want_to_read
        }

    def _carve(self, chunk: np.ndarray) -> np.ndarray:
        """[chunk_size] -> [sub_chunk_no, sc_size] plane view."""
        size = chunk.shape[-1]
        if size % self.sub_chunk_no:
            raise ErasureCodeError(
                -errno.EINVAL,
                f"chunk size {size} not a multiple of sub_chunk_no "
                f"{self.sub_chunk_no}",
            )
        return chunk.reshape(self.sub_chunk_no, size // self.sub_chunk_no).copy()

    def _flatten(self, planes: np.ndarray) -> np.ndarray:
        return planes.reshape(-1)

    def _make_node_buffers(self, chunk_size: int) -> Dict[int, np.ndarray]:
        sc = chunk_size // self.sub_chunk_no
        return {
            node: np.zeros((self.sub_chunk_no, sc), dtype=np.uint8)
            for node in range(self.q * self.t)
        }

    def _decode_layered(
        self, erased_chunks: Set[int], nodes: Dict[int, np.ndarray], chunk_size: int
    ) -> None:
        """Reference decode_layered (ErasureCodeClay.cc:645-710): process
        planes in increasing intersection-score order; per plane compute
        uncoupled values for intact nodes, MDS-decode the uncoupled plane,
        then convert erased nodes back to coupled."""
        if not erased_chunks:
            return
        sc_size = chunk_size // self.sub_chunk_no
        # pad erasures to exactly m with virtual nodes
        num = len(erased_chunks)
        if num > self.m:
            raise ErasureCodeError(
                -errno.EIO, f"{num} erasures exceed m={self.m}"
            )
        for i in range(self.k + self.nu, self.q * self.t):
            if num >= self.m:
                break
            if i not in erased_chunks:
                erased_chunks.add(i)
                num += 1
        # intersection score per plane
        order = np.zeros(self.sub_chunk_no, dtype=np.int64)
        for z in range(self.sub_chunk_no):
            z_vec = self._plane_vector(z)
            order[z] = sum(
                1 for i in erased_chunks if i % self.q == z_vec[i // self.q]
            )
        U: Dict[int, np.ndarray] = {
            node: np.zeros((self.sub_chunk_no, sc_size), dtype=np.uint8)
            for node in range(self.q * self.t)
        }
        max_iscore = int(order.max())
        for iscore in range(max_iscore + 1):
            for z in np.flatnonzero(order == iscore):
                self._decode_erasures(erased_chunks, int(z), nodes, U)
            for z in np.flatnonzero(order == iscore):
                z = int(z)
                z_vec = self._plane_vector(z)
                for node_xy in erased_chunks:
                    x, y = node_xy % self.q, node_xy // self.q
                    node_sw = y * self.q + int(z_vec[y])
                    if int(z_vec[y]) != x:
                        if node_sw not in erased_chunks:
                            self._recover_type1(nodes, U, x, y, z, z_vec)
                        elif int(z_vec[y]) < x:
                            self._coupled_from_uncoupled(nodes, U, x, y, z, z_vec)
                    else:  # hole-dot: C = U
                        nodes[node_xy][z] = U[node_xy][z]

    def _decode_erasures(
        self,
        erased_chunks: Set[int],
        z: int,
        nodes: Dict[int, np.ndarray],
        U: Dict[int, np.ndarray],
    ) -> None:
        """Reference decode_erasures (ErasureCodeClay.cc:712-749): fill in
        the uncoupled values of intact nodes for plane z, then MDS-decode
        the uncoupled plane across nodes."""
        z_vec = self._plane_vector(z)
        for x in range(self.q):
            for y in range(self.t):
                node_xy = self.q * y + x
                node_sw = self.q * y + int(z_vec[y])
                if node_xy in erased_chunks:
                    continue
                if int(z_vec[y]) < x:
                    self._uncoupled_from_coupled(nodes, U, x, y, z, z_vec)
                elif int(z_vec[y]) == x:
                    U[node_xy][z] = nodes[node_xy][z]
                elif node_sw in erased_chunks:
                    self._uncoupled_from_coupled(nodes, U, x, y, z, z_vec)
        # MDS decode of the uncoupled plane
        known = {
            node: U[node][z]
            for node in range(self.q * self.t)
            if node not in erased_chunks
        }
        decoded = self.mds.decode_chunks(set(erased_chunks), known)
        for node in erased_chunks:
            U[node][z] = decoded[node]

    # pair-solve wrappers; ids (i0, i1) = coupled in x order, (i2, i3) =
    # matching uncoupled (reference's index swap when z_vec[y] > x)

    def _pair_ids(self, x: int, zy: int) -> Tuple[int, int, int, int]:
        if zy > x:
            return 1, 0, 3, 2
        return 0, 1, 2, 3

    def _uncoupled_from_coupled(self, nodes, U, x, y, z, z_vec) -> None:
        """(C1, C2) known -> (U1, U2) (reference ErasureCodeClay.cc:838-866)."""
        i0, i1, i2, i3 = self._pair_ids(x, int(z_vec[y]))
        node_xy = y * self.q + x
        node_sw = y * self.q + int(z_vec[y])
        z_sw = self._z_sw(z, x, y, z_vec)
        known = {i0: nodes[node_xy][z], i1: nodes[node_sw][z_sw]}
        out = self._pft_solve(known, {i2, i3})
        U[node_xy][z] = out[i2]
        U[node_sw][z_sw] = out[i3]

    def _coupled_from_uncoupled(self, nodes, U, x, y, z, z_vec) -> None:
        """(U1, U2) known -> (C1, C2) (reference ErasureCodeClay.cc:812-836)."""
        node_xy = y * self.q + x
        node_sw = y * self.q + int(z_vec[y])
        z_sw = self._z_sw(z, x, y, z_vec)
        known = {2: U[node_xy][z], 3: U[node_sw][z_sw]}
        out = self._pft_solve(known, {0, 1})
        nodes[node_xy][z] = out[0]
        nodes[node_sw][z_sw] = out[1]

    def _recover_type1(self, nodes, U, x, y, z, z_vec) -> None:
        """Erased node whose pair partner is intact: solve from partner's
        coupled value + own uncoupled value (reference
        ErasureCodeClay.cc:775-810)."""
        i0, i1, i2, i3 = self._pair_ids(x, int(z_vec[y]))
        node_xy = y * self.q + x
        node_sw = y * self.q + int(z_vec[y])
        z_sw = self._z_sw(z, x, y, z_vec)
        known = {i1: nodes[node_sw][z_sw], i2: U[node_xy][z]}
        out = self._pft_solve(known, {i0})
        nodes[node_xy][z] = out[i0]

    # -- the bandwidth-efficient single-chunk repair -------------------------

    def decode(
        self, want_to_read: Set[int], chunks: Mapping[int, np.ndarray], chunk_size: int
    ) -> Dict[int, np.ndarray]:
        avail = set(chunks)
        sizes = {len(v) for v in chunks.values()}
        # repair dispatch (reference ErasureCodeClay::decode,
        # ErasureCodeClay.cc:108-124): helpers sent only the repair
        # sub-chunks, so their buffers are shorter than a full chunk
        if (
            self.is_repair(want_to_read, avail)
            and len(sizes) == 1
            and next(iter(sizes)) < chunk_size
        ):
            return self._repair(want_to_read, chunks, chunk_size)
        return super().decode(want_to_read, chunks, chunk_size)

    def _repair(
        self, want_to_read: Set[int], chunks: Mapping[int, np.ndarray], chunk_size: int
    ) -> Dict[int, np.ndarray]:
        """Reference repair + repair_one_lost_chunk
        (ErasureCodeClay.cc:396-641): rebuild one chunk from d helpers that
        each sent only the repair-plane sub-chunks."""
        if len(want_to_read) != 1 or len(chunks) != self.d:
            raise ErasureCodeError(
                -errno.EINVAL, "repair needs exactly 1 target and d helpers"
            )
        lost = next(iter(want_to_read))
        lost_node = self._node_id(lost)
        repair_subchunks = self.sub_chunk_no // self.q
        repair_blocksize = len(next(iter(chunks.values())))
        if repair_blocksize % repair_subchunks:
            raise ErasureCodeError(-errno.EINVAL, "bad repair block size")
        sc_size = repair_blocksize // repair_subchunks
        if sc_size * self.sub_chunk_no != chunk_size:
            raise ErasureCodeError(-errno.EINVAL, "chunk size mismatch")

        runs = self.get_repair_subchunks(lost_node)
        repair_planes: List[int] = []
        for index, count in runs:
            repair_planes.extend(range(index, index + count))
        plane_ind = {z: i for i, z in enumerate(repair_planes)}

        helper: Dict[int, np.ndarray] = {}
        aloof: Set[int] = set()
        for chunk in range(self.k + self.m):
            node = self._node_id(chunk)
            if chunk in chunks:
                helper[node] = (
                    np.asarray(chunks[chunk], dtype=np.uint8)
                    .reshape(repair_subchunks, sc_size)
                )
            elif chunk != lost:
                aloof.add(node)
        for node in range(self.k, self.k + self.nu):
            helper[node] = np.zeros((repair_subchunks, sc_size), dtype=np.uint8)

        recovered = np.zeros((self.sub_chunk_no, sc_size), dtype=np.uint8)
        U: Dict[int, np.ndarray] = {
            node: np.zeros((self.sub_chunk_no, sc_size), dtype=np.uint8)
            for node in range(self.q * self.t)
        }

        # order repair planes by intersection score with erasures+aloof
        ordered: Dict[int, List[int]] = {}
        for z in repair_planes:
            z_vec = self._plane_vector(z)
            score = 0
            if lost_node % self.q == z_vec[lost_node // self.q]:
                score += 1
            for node in aloof:
                if node % self.q == z_vec[node // self.q]:
                    score += 1
            ordered.setdefault(score, []).append(z)

        erasures = {
            lost_node - lost_node % self.q + i for i in range(self.q)
        } | aloof

        for score in sorted(ordered):
            for z in ordered[score]:
                z_vec = self._plane_vector(z)
                # fill uncoupled values for intact nodes of this plane
                for y in range(self.t):
                    for x in range(self.q):
                        node_xy = y * self.q + x
                        if node_xy in erasures:
                            continue
                        zy = int(z_vec[y])
                        node_sw = y * self.q + zy
                        z_sw = self._z_sw(z, x, y, z_vec)
                        i0, i1, i2, i3 = self._pair_ids(x, zy)
                        if node_sw in aloof:
                            # partner coupled unavailable; its uncoupled for
                            # plane z_sw is known from an earlier pass
                            known = {
                                i0: helper[node_xy][plane_ind[z]],
                                i3: U[node_sw][z_sw],
                            }
                            out = self._pft_solve(known, {i2})
                            U[node_xy][z] = out[i2]
                        elif zy != x:
                            known = {
                                i0: helper[node_xy][plane_ind[z]],
                                i1: helper[node_sw][plane_ind[z_sw]],
                            }
                            out = self._pft_solve(known, {i2})
                            U[node_xy][z] = out[i2]
                        else:
                            U[node_xy][z] = helper[node_xy][plane_ind[z]]
                # MDS-decode the uncoupled plane
                if len(erasures) > self.m:
                    raise ErasureCodeError(
                        -errno.EIO, "too many erasures during repair"
                    )
                known = {
                    node: U[node][z]
                    for node in range(self.q * self.t)
                    if node not in erasures
                }
                decoded = self.mds.decode_chunks(set(erasures), known)
                for node in erasures:
                    U[node][z] = decoded[node]
                # convert the lost node back to coupled
                for node in erasures:
                    if node in aloof:
                        continue
                    x, y = node % self.q, node // self.q
                    zy = int(z_vec[y])
                    node_sw = y * self.q + zy
                    z_sw = self._z_sw(z, x, y, z_vec)
                    if x == zy:  # hole-dot
                        recovered[z] = U[node][z]
                    else:
                        # partner column is the lost node's own column
                        i0, i1, i2, i3 = self._pair_ids(x, zy)
                        known = {
                            i0: helper[node][plane_ind[z]],
                            i2: U[node][z],
                        }
                        out = self._pft_solve(known, {i1})
                        recovered[z_sw] = out[i1]

        return {lost: recovered.reshape(-1)}


class ClayPlugin(ErasureCodePlugin):
    def factory(self, profile: ErasureCodeProfile, device=None):
        codec = ErasureCodeClay(directory=profile.get("directory", ""),
                                device=device)
        codec.init(dict(profile))
        return codec


def __erasure_code_version__() -> str:
    return PLUGIN_ABI_VERSION


def __erasure_code_init__(name: str, registry) -> int:
    registry.add(name, ClayPlugin())
    return 0
