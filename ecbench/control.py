"""The control: the plain reference put in the program's place, with one of
the configuration's guarantees broken, run through a cell as the program is.

The configurations state no precision; what they guarantee is chunks
byte-identical to jerasure's.  The control computes the same code over
GF(2^8) with another primitive polynomial (0x12b for jerasure's 0x11d): still
an MDS code that decodes its own chunks, the step a faster field would
tempt a change to take, but not jerasure's chunks.  A check that lets the
control through cannot tell the program's chunks from wrong ones.

    python3 -m ecbench.control --workload <cell> --seeds 1,2,3 --seconds 3
    python3 -m ecbench.control --workload <cell> --seeds 1,2,3 --arm program

prints one line a run with the numbers compared (``--arm program`` runs
the program instead, in the same process, to read many seeds at one
set-up's cost).  Needs a CUDA device, as a run of the cell does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Mapping, Set

import numpy as np

from ecbench import harness, spec

#: the polynomial the control computes over, in place of jerasure's 0x11d
CONTROL_POLY = 0x12B


def _invert(field, a: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse of a square matrix over GF(2^8)."""
    n = a.shape[0]
    m = np.concatenate([a.astype(np.int64), np.eye(n, dtype=np.int64)], 1)
    for c in range(n):
        r = next(r for r in range(c, n) if m[r, c])
        m[[c, r]] = m[[r, c]]
        m[c] = field.mul[field.divide(1, int(m[c, c])), m[c]]
        for r in range(n):
            if r != c and m[r, c]:
                m[r] ^= field.mul[int(m[r, c]), m[c]]
    return m[:, n:].astype(np.uint8)


def _invert_bits(a: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse of a square matrix over GF(2)."""
    n = a.shape[0]
    m = np.concatenate([a.astype(np.uint8) & 1, np.eye(n, dtype=np.uint8)], 1)
    for c in range(n):
        r = next(r for r in range(c, n) if m[r, c])
        m[[c, r]] = m[[r, c]]
        for r in np.flatnonzero(m[:, c]):
            if r != c:
                m[r] ^= m[c]
    return m[:, n:]


class ControlCodec:
    """The reference behind the codec interface the kinds call."""

    def __init__(self, profile: Dict[str, str], poly: int = CONTROL_POLY):
        self.ref = spec.load_module("references", "jerasure").Code(
            profile, poly=poly)
        self.k, self.m = self.ref.k, self.ref.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_coding_chunk_count(self) -> int:
        return self.m

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_chunk_size(self, object_size: int) -> int:
        return self.ref.chunk_size(object_size)

    def encode(self, want: Set[int], data) -> Dict[int, np.ndarray]:
        chunks = self.ref.encode(data)
        return {c: chunks[c] for c in want}

    def decode(self, want: Set[int], chunks: Mapping[int, np.ndarray],
               chunk_size: int) -> Dict[int, np.ndarray]:
        ref, k = self.ref, self.k
        chosen = sorted(chunks)[:k]
        src = np.stack([np.asarray(chunks[c], dtype=np.uint8)
                        for c in chosen])
        if ref.technique == "reed_sol_van":
            full = np.vstack([np.eye(k, dtype=np.uint8), ref.matrix])
            inv = _invert(ref.field, full[chosen])
            data = np.zeros_like(src)
            for i in range(k):
                for j in range(k):
                    data[i] ^= ref.field.mul[inv[i, j]][src[j]]
        else:
            ps = ref.packetsize
            full = np.vstack([np.eye(k * 8, dtype=np.uint8), ref.bits])
            sub = np.vstack([full[c * 8:(c + 1) * 8] for c in chosen])
            inv = _invert_bits(sub)
            nb = chunk_size // (8 * ps)
            rows = src.reshape(k, nb, 8, ps).transpose(0, 2, 1, 3).reshape(
                k * 8, nb, ps)
            out = np.zeros_like(rows)
            for r in range(k * 8):
                for c in np.flatnonzero(inv[r]):
                    out[r] ^= rows[c]
            data = out.reshape(k, 8, nb, ps).transpose(0, 2, 1, 3).reshape(
                k, chunk_size)
        if any(c >= k for c in want):
            data = np.concatenate([data, ref.coding_chunks(data)])
        return {c: data[c] for c in want}


def make_control(config: dict, device: str) -> ControlCodec:
    return ControlCodec(config["profile"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m ecbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, one run each")
    p.add_argument("--seconds", type=int, default=3)
    p.add_argument("--arm", choices=("control", "program"), default="control")
    args = p.parse_args(argv)
    make = make_control if args.arm == "control" else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        result = harness.run_cell(args.workload, seed, args.seconds, False,
                                  t_start=t, make_codec=make)
        print(json.dumps({"arm": args.arm, "workload": args.workload,
                          "seed": seed, "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": result["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
