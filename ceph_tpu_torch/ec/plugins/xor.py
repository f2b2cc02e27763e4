# Copy of ceph_tpu/ec/plugins/xor.py at commit 6e1c6d1, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Minimal example codec: k data chunks + 1 XOR parity chunk.

The equivalent of the reference's test-only ErasureCodeExample
(src/test/erasure-code/ErasureCodeExample.h:39) — a complete, trivially
auditable codec used as the registry/test reference implementation."""

from __future__ import annotations

import errno
from typing import Dict, Mapping, Set

import numpy as np

from ceph_tpu_torch import PLUGIN_ABI_VERSION
from ceph_tpu_torch.ec.base import ErasureCode, to_int
from ceph_tpu_torch.ec.interface import ErasureCodeError, ErasureCodeProfile
from ceph_tpu_torch.ec.registry import ErasureCodePlugin


class ErasureCodeXor(ErasureCode):
    technique = "xor"
    bit_layout = "byte"

    def init(self, profile: ErasureCodeProfile) -> None:
        self.k = to_int(profile, "k", 2)
        self.m = 1
        prof = dict(profile)
        prof["plugin"] = "xor"
        prof.setdefault("k", str(self.k))
        prof["m"] = "1"
        self._profile = prof

    def get_chunk_size(self, stripe_width: int) -> int:
        align = self.k * 16
        padded = -(-stripe_width // align) * align if stripe_width else align
        return padded // self.k

    def encode_chunks(self, data: np.ndarray) -> np.ndarray:
        return np.bitwise_xor.reduce(data, axis=0)[None, :]

    def decode_chunks(
        self, want_to_read: Set[int], chunks: Mapping[int, np.ndarray]
    ) -> Dict[int, np.ndarray]:
        missing = [c for c in range(self.k + 1) if c not in chunks]
        if len(missing) > 1:
            raise ErasureCodeError(-errno.EIO, "xor can repair one erasure")
        out = {c: np.asarray(v, dtype=np.uint8) for c, v in chunks.items()}
        if missing:
            out[missing[0]] = np.bitwise_xor.reduce(
                np.stack([out[c] for c in range(self.k + 1) if c != missing[0]]), axis=0
            )
        return {c: out[c] for c in want_to_read}

    def bit_generator(self) -> np.ndarray:
        return np.ones((1, self.k), dtype=np.uint8)  # w=1 bit rows


class XorPlugin(ErasureCodePlugin):
    def factory(self, profile: ErasureCodeProfile, device=None):
        codec = ErasureCodeXor()
        codec.init(profile)
        return codec


def __erasure_code_version__() -> str:
    return PLUGIN_ABI_VERSION


def __erasure_code_init__(name: str, registry) -> int:
    registry.add(name, XorPlugin())
    return 0
