# Copy of ceph_tpu/ec/plugins/isa.py at commit 6e1c6d1, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""isa-equivalent plugin (the reference's Intel ISA-L backed codec).

Techniques reed_sol_van (default) and cauchy, using isa-l's matrix
constructions (gf_gen_rs_matrix / gf_gen_cauchy1_matrix semantics — see
ceph_tpu_torch/ec/matrices.py) in the same 0x11D field.  Reproduces the reference's
behaviors (src/erasure-code/isa/ErasureCodeIsa.cc):

  * chunk size rounds the per-chunk size up to a 32-byte alignment
    (EC_ISA_ADDRESS_ALIGNMENT; ErasureCodeIsa.cc:65-79) — note this differs
    from jerasure's round-the-object rule;
  * m=1 short-circuits encode to a pure XOR of the data chunks
    (ErasureCodeIsa.cc:119-131); single-erasure decode under Vandermonde
    uses the same XOR fast path (:206-216) — fast paths are bit-identical
    to the general matmul because row 0 of both matrices is all-ones;
  * decode matrices are LRU-cached per erasure signature
    (ErasureCodeIsaTableCache) — provided by DecodeMatrixCache;
  * MDS safety envelope for Vandermonde: k<=32, m<=4, and m=4 => k<=21
    (ErasureCodeIsa.cc:331-361).
"""

from __future__ import annotations

import errno

import numpy as np

from ceph_tpu_torch import PLUGIN_ABI_VERSION
from ceph_tpu_torch.ec import matrices as M
from ceph_tpu_torch.ec.base import to_int
from ceph_tpu_torch.ec.codecs import MatrixErasureCode
from ceph_tpu_torch.ec.interface import ErasureCodeError, ErasureCodeProfile
from ceph_tpu_torch.ec.registry import ErasureCodePlugin

DEFAULT_K = 7
DEFAULT_M = 3
EC_ISA_ADDRESS_ALIGNMENT = 32


class ErasureCodeIsa(MatrixErasureCode):
    plugin_name = "isa"

    def __init__(self, technique: str = "reed_sol_van") -> None:
        super().__init__()
        self.technique = technique

    def init(self, profile: ErasureCodeProfile) -> None:
        self.k = to_int(profile, "k", DEFAULT_K)
        self.m = to_int(profile, "m", DEFAULT_M)
        self.w = 8  # isa-l is GF(2^8) only
        if self.k < 1 or self.m < 1:
            raise ErasureCodeError(-errno.EINVAL, "k and m must be >= 1")
        if self.technique == "reed_sol_van":
            # benchmark-verified MDS envelope (ErasureCodeIsa.cc:331-361)
            if self.k > 32 or self.m > 4 or (self.m == 4 and self.k > 21):
                raise ErasureCodeError(
                    -errno.EINVAL,
                    "isa reed_sol_van outside verified MDS envelope "
                    "(k<=32, m<=4, m=4 => k<=21)",
                )
            self.matrix = M.isa_vandermonde_matrix(self.k, self.m, self.w)
        elif self.technique == "cauchy":
            if self.k + self.m > (1 << self.w):
                raise ErasureCodeError(
                    -errno.EINVAL, f"k+m={self.k + self.m} exceeds GF(2^8) field size"
                )
            self.matrix = M.isa_cauchy_matrix(self.k, self.m, self.w)
        else:
            raise ErasureCodeError(
                -errno.ENOENT, f"technique={self.technique} not in (reed_sol_van, cauchy)"
            )
        self.parse_chunk_mapping(profile)
        prof = dict(profile)
        prof["plugin"] = "isa"
        prof.setdefault("technique", self.technique)
        prof.setdefault("k", str(self.k))
        prof.setdefault("m", str(self.m))
        self._profile = prof

    def get_alignment(self) -> int:
        return EC_ISA_ADDRESS_ALIGNMENT

    def get_chunk_size(self, stripe_width: int) -> int:
        """isa semantics: ceil(object/k) rounded up to the 32 B alignment
        (reference ErasureCodeIsa.cc:65-79) — chunk-level, not object-level."""
        alignment = self.get_alignment()
        chunk = -(-stripe_width // self.k) if stripe_width else 1
        return -(-chunk // alignment) * alignment

    def encode_chunks(self, data: np.ndarray) -> np.ndarray:
        # region_xor fast path (ErasureCodeIsa.cc:119-131) — only valid when
        # the single parity row is all-ones (true for reed_sol_van row 0;
        # NOT for cauchy, whose m=1 row has non-unit coefficients).
        if self.m == 1 and np.all(self.matrix[0] == 1):
            return np.bitwise_xor.reduce(data, axis=0)[None, :]
        return super().encode_chunks(data)


class IsaPlugin(ErasureCodePlugin):
    def factory(self, profile: ErasureCodeProfile, device=None):
        codec = ErasureCodeIsa(profile.get("technique", "reed_sol_van"))
        codec.init(profile)
        return codec


def __erasure_code_version__() -> str:
    return PLUGIN_ABI_VERSION


def __erasure_code_init__(name: str, registry) -> int:
    registry.add(name, IsaPlugin())
    return 0
