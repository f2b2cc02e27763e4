"""jerasure-equivalent plugin: the reference's default codec family.

Seven techniques dispatched by the ``technique`` profile key (reference
src/erasure-code/jerasure/ErasureCodePluginJerasure.cc:42-62):
reed_sol_van, reed_sol_r6_op (GF(2^w) matrix codes) and cauchy_orig,
cauchy_good, liberation, blaum_roth, liber8tion (GF(2) bit-matrix codes).
Matrix constructions reproduce jerasure's algorithms (see
ceph_tpu/ec/matrices.py); w=8 uses gf-complete's default 0x11D field.

This implementation supports w in {4, 8, 16} (log-table fields); the
reference additionally allows w=32 for reed_sol, which no shipped Ceph
profile uses by default.
"""

from __future__ import annotations

import errno

from ceph_tpu_torch import PLUGIN_ABI_VERSION
from ceph_tpu_torch.ec import matrices as M
from ceph_tpu_torch.ec.base import to_bool, to_int
from ceph_tpu_torch.ec.codecs import (
    LARGEST_VECTOR_WORDSIZE,
    SIZEOF_INT,
    BitmatrixErasureCode,
    MatrixErasureCode,
)
from ceph_tpu_torch.ec.interface import ErasureCodeError, ErasureCodeProfile
from ceph_tpu_torch.ec.registry import ErasureCodePlugin

DEFAULT_K = 2
DEFAULT_M = 1
DEFAULT_W = 8
DEFAULT_PACKETSIZE = 2048


class JerasureMixin:
    """Shared profile parsing for all jerasure techniques (reference
    ErasureCodeJerasure::init/parse)."""

    plugin_name = "jerasure"

    def _parse_common(
        self, profile: ErasureCodeProfile, allowed_w=(4, 8, 16)
    ) -> None:
        self.k = to_int(profile, "k", DEFAULT_K)
        self.m = to_int(profile, "m", DEFAULT_M)
        self.w = to_int(profile, "w", DEFAULT_W)
        self.per_chunk_alignment = to_bool(profile, "jerasure-per-chunk-alignment", False)
        if self.k < 1 or self.m < 1:
            raise ErasureCodeError(-errno.EINVAL, f"k={self.k} m={self.m} must be >= 1")
        if allowed_w is not None and self.w not in allowed_w:
            raise ErasureCodeError(
                -errno.EINVAL, f"w={self.w} unsupported (use one of {allowed_w})"
            )
        self.parse_chunk_mapping(profile)
        profile = dict(profile)
        profile["plugin"] = self.plugin_name
        profile["technique"] = self.technique
        profile.setdefault("k", str(self.k))
        profile.setdefault("m", str(self.m))
        profile.setdefault("w", str(self.w))
        self._profile = profile


class ReedSolomonVandermonde(JerasureMixin, MatrixErasureCode):
    technique = "reed_sol_van"

    def init(self, profile: ErasureCodeProfile) -> None:
        self._parse_common(profile)
        if self.k + self.m > (1 << self.w):
            raise ErasureCodeError(-errno.EINVAL, "k+m exceeds field size")
        self.matrix = M.vandermonde_coding_matrix(self.k, self.m, self.w)

    def get_alignment(self) -> int:
        """Reference ErasureCodeJerasureReedSolomonVandermonde::get_alignment:
        k*w*sizeof(int), bumped to k*w*LARGEST_VECTOR_WORDSIZE when w*4 is
        not a vector-word multiple (ErasureCodeJerasure.cc:174-184)."""
        if self.per_chunk_alignment:
            return self.w * LARGEST_VECTOR_WORDSIZE
        alignment = self.k * self.w * SIZEOF_INT
        if (self.w * SIZEOF_INT) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * LARGEST_VECTOR_WORDSIZE
        return alignment

    def get_chunk_size(self, stripe_width: int) -> int:
        if self.per_chunk_alignment:
            chunk = -(-stripe_width // self.k) if stripe_width else 1
            a = self.get_alignment()
            return -(-chunk // a) * a
        return super().get_chunk_size(stripe_width)


class ReedSolomonR6Op(JerasureMixin, MatrixErasureCode):
    technique = "reed_sol_r6_op"

    def init(self, profile: ErasureCodeProfile) -> None:
        profile = dict(profile)
        profile.setdefault("m", "2")
        self._parse_common(profile)
        if self.m != 2:
            raise ErasureCodeError(-errno.EINVAL, "reed_sol_r6_op requires m=2")
        if self.k + self.m > (1 << self.w):
            raise ErasureCodeError(-errno.EINVAL, "k+m exceeds field size")
        self.matrix = M.r6_coding_matrix(self.k, self.w)

    def get_alignment(self) -> int:
        if self.per_chunk_alignment:
            return self.w * LARGEST_VECTOR_WORDSIZE
        alignment = self.k * self.w * SIZEOF_INT
        if (self.w * SIZEOF_INT) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * LARGEST_VECTOR_WORDSIZE
        return alignment


class CauchyBase(JerasureMixin, BitmatrixErasureCode):
    def _parse_cauchy(self, profile: ErasureCodeProfile) -> None:
        self._parse_common(profile)
        self.packetsize = to_int(profile, "packetsize", DEFAULT_PACKETSIZE)
        if self.packetsize < 1:
            raise ErasureCodeError(-errno.EINVAL, "packetsize must be >= 1")
        self._profile.setdefault("packetsize", str(self.packetsize))
        if self.k + self.m > (1 << self.w):
            raise ErasureCodeError(-errno.EINVAL, "k+m exceeds field size")


class CauchyOrig(CauchyBase):
    technique = "cauchy_orig"

    def init(self, profile: ErasureCodeProfile) -> None:
        self._parse_cauchy(profile)
        self.bitmatrix = M.matrix_to_bitmatrix(
            M.cauchy_orig_matrix(self.k, self.m, self.w), self.w
        )


class CauchyGood(CauchyBase):
    technique = "cauchy_good"

    def init(self, profile: ErasureCodeProfile) -> None:
        self._parse_cauchy(profile)
        self.bitmatrix = M.matrix_to_bitmatrix(
            M.cauchy_good_matrix(self.k, self.m, self.w), self.w
        )


class Liberation(JerasureMixin, BitmatrixErasureCode):
    """Liberation codes: m=2, w prime > 2, k <= w (reference
    ErasureCodeJerasureLiberation, ErasureCodeJerasure.cc:339-456; defaults
    k=2 m=2 w=7 per ErasureCodeJerasure.h:204-206)."""

    technique = "liberation"
    default_w = 7

    def _check_w(self) -> None:
        if self.w <= 2 or not M.is_prime(self.w):
            raise ErasureCodeError(
                -errno.EINVAL, f"w={self.w} must be greater than two and be prime"
            )

    def _build(self) -> None:
        self.bitmatrix = M.liberation_bitmatrix(self.k, self.w)

    def init(self, profile: ErasureCodeProfile) -> None:
        profile = dict(profile)
        profile.setdefault("m", "2")
        profile.setdefault("w", str(self.default_w))
        self._parse_common(profile, allowed_w=None)
        self.packetsize = to_int(profile, "packetsize", DEFAULT_PACKETSIZE)
        if self.m != 2:
            raise ErasureCodeError(-errno.EINVAL, f"{self.technique} requires m=2")
        if self.k > self.w:
            raise ErasureCodeError(
                -errno.EINVAL, f"k={self.k} must be less than or equal to w={self.w}"
            )
        self._check_w()
        if self.packetsize < 1 or self.packetsize % SIZEOF_INT:
            raise ErasureCodeError(
                -errno.EINVAL,
                f"packetsize={self.packetsize} must be a positive multiple of "
                f"sizeof(int) = {SIZEOF_INT}",
            )
        self._profile.setdefault("packetsize", str(self.packetsize))
        self._build()


class BlaumRoth(Liberation):
    """Blaum-Roth codes: m=2, w+1 prime (reference ErasureCodeJerasureBlaumRoth,
    ErasureCodeJerasure.cc:459-478)."""

    technique = "blaum_roth"
    default_w = 6

    def _check_w(self) -> None:
        # w=7 tolerated for backward compat in the reference despite 8 not
        # being prime (ErasureCodeJerasure.cc:461-464); we reject it since
        # the construction genuinely needs w+1 prime.
        if self.w <= 2 or not M.is_prime(self.w + 1):
            raise ErasureCodeError(
                -errno.EINVAL,
                f"w={self.w} must be greater than two and w+1 must be prime",
            )

    def _build(self) -> None:
        self.bitmatrix = M.blaum_roth_bitmatrix(self.k, self.w)


class Liber8tion(Liberation):
    """Liber8tion codes: m=2, w=8 fixed (reference ErasureCodeJerasureLiber8tion,
    ErasureCodeJerasure.cc:481-516; defaults k=2 m=2 w=8)."""

    technique = "liber8tion"
    default_w = 8

    def _check_w(self) -> None:
        if self.w != 8:
            raise ErasureCodeError(-errno.EINVAL, "liber8tion requires w=8")

    def _build(self) -> None:
        self.bitmatrix = M.liber8tion_bitmatrix(self.k)


TECHNIQUES = {
    cls.technique: cls
    for cls in (
        ReedSolomonVandermonde,
        ReedSolomonR6Op,
        CauchyOrig,
        CauchyGood,
        Liberation,
        BlaumRoth,
        Liber8tion,
    )
}


class JerasurePlugin(ErasureCodePlugin):
    def factory(self, profile: ErasureCodeProfile, device=None):
        technique = profile.get("technique", "reed_sol_van")
        cls = TECHNIQUES.get(technique)
        if cls is None:
            raise ErasureCodeError(
                -errno.ENOENT,
                f"technique={technique} is not a valid jerasure technique "
                f"(have {sorted(TECHNIQUES)})",
            )
        codec = cls()
        codec.init(dict(profile, technique=technique))
        return codec


def __erasure_code_version__() -> str:
    return PLUGIN_ABI_VERSION


def __erasure_code_init__(name: str, registry) -> int:
    registry.add(name, JerasurePlugin())
    return 0
