"""Full-object writes: ``codec.encode(want, object)``, as an OSD's write and
``ceph_erasure_code_benchmark --workload encode`` call it.

Every write wants all k+m chunks.  Mix parameter: ``callers`` (each writes
its own share of the objects).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

FAMILY = "encode"


class Plan:
    def __init__(self, codec, objects: List, config: dict, mix: dict,
                 rng: np.random.Generator) -> None:
        self.codec, self.objects = codec, objects
        self.k = codec.get_data_chunk_count()
        self.m = codec.get_coding_chunk_count()
        self.want = set(range(self.k + self.m))
        callers = int(mix["callers"])
        order = rng.permutation(len(objects)).tolist()
        #: each caller's cycle of ops: indices of the objects it writes
        self.callers = [order[c::callers] for c in range(callers)]
        #: ops that set-up runs once each: every shape this traffic uses
        self.warm = [self.callers[0][0]]
        self.chunk_size = codec.get_chunk_size(len(objects[0]))

    def call(self, op: int) -> Dict[int, np.ndarray]:
        return self.codec.encode(self.want, self.objects[op])

    def object_bytes(self, op: int) -> int:
        return len(self.objects[op])

    def kernel_chunks(self, op: int):
        """(chunks the kernel reads, chunks it writes) for one op."""
        return self.k, self.m

    def expected(self, ref, op: int) -> Dict[int, np.ndarray]:
        chunks = ref.encode(self.objects[op])
        return {c: chunks[c] for c in self.want}

    def setup_answers(self, ref, sampled_ops: List[int]):
        """(what, got, expected) for answers of set-up that the window's
        ops stand on: none, since each write stands alone."""
        return []
