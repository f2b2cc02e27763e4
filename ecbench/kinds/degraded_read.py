"""Degraded reads: ``codec.decode(want, survivors, chunk_size)`` for whole
objects with shards lost, as an OSD reads a PG whose OSD is down.

Set-up encodes every object through the same codec and keeps its chunks.
Each read wants the k data chunks, loses ``lost`` of the k data shards
(reads that lose only parity need no decode) and hands the decode the
survivors.  Every (object, lost shards) pair occurs once in a cycle, in an
order drawn from the seed, so every seed does the same work.

Mix parameters: ``callers`` and ``lost``.
"""

from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np

FAMILY = "decode"


class Plan:
    def __init__(self, codec, objects: List, config: dict, mix: dict,
                 rng: np.random.Generator) -> None:
        self.codec, self.objects = codec, objects
        k, m = codec.get_data_chunk_count(), codec.get_coding_chunk_count()
        self.k, self.n = k, k + m
        self.want = set(range(k))
        self.lost = int(mix["lost"])
        self.chunk_size = codec.get_chunk_size(len(objects[0]))
        everything = set(range(self.n))
        self.stored = [codec.encode(everything, obj) for obj in objects]
        losses = list(itertools.combinations(range(k), self.lost))
        pairs = [(i, lost) for i in range(len(objects)) for lost in losses]
        pairs = [pairs[j] for j in rng.permutation(len(pairs))]
        self.survivors = {
            (i, lost): {c: self.stored[i][c] for c in range(self.n)
                        if c not in lost} for i, lost in pairs}
        callers = int(mix["callers"])
        self.callers = [pairs[c::callers] for c in range(callers)]
        #: one read of each loss, so every decode signature is warm
        self.warm = [(pairs[0][0], lost) for lost in losses]

    def call(self, op) -> Dict[int, np.ndarray]:
        return self.codec.decode(self.want, self.survivors[op],
                                 self.chunk_size)

    def object_bytes(self, op) -> int:
        return len(self.objects[op[0]])

    def kernel_chunks(self, op):
        """(chunks the kernel reads, chunks it writes) for one op."""
        return self.k, len(op[1])

    def expected(self, ref, op) -> Dict[int, np.ndarray]:
        data = ref.data_chunks(self.objects[op[0]])
        return {c: data[c] for c in self.want}

    def setup_answers(self, ref, sampled_ops: List):
        """(what, got, expected) for the stored chunks of every sampled
        read's object: the survivors that the reads decode from."""
        out = []
        for i in sorted({op[0] for op in sampled_ops}):
            chunks = ref.encode(self.objects[i])
            out.append((f"stored chunks of object {i}", self.stored[i],
                        {c: chunks[c] for c in range(self.n)}))
        return out
