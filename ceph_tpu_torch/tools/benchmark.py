"""Reference-compatible erasure-code benchmark CLI, on the port.

Counterpart of ceph_tpu/tools/benchmark.py, with the same flags and output
protocol as the reference's ceph_erasure_code_benchmark: it prints
"<seconds>\t<KB processed>" on stdout, where KB = iterations * size/1024.

    python -m ceph_tpu_torch.tools.benchmark --plugin cuda \\
        -P technique=reed_sol_van -P k=8 -P m=3 --size 4194304 \\
        --iterations 16 --workload encode

Workloads: encode (timed encode loop), decode (encode once, then timed
decode with random | --erased | exhaustive erasure generation).  Every
decode mode verifies recovered content: exhaustive checks inline; random and
--erased collect the erasure signatures the timed loop exercised and
re-decode each distinct one AFTER the loop (outside the timed window), so
the CLI cannot report a fast-but-wrong decode.

One flag more than the reference: ``--device`` (default ``cuda``) is where
plugin=cuda runs; ``--device cpu`` runs its lane on the host.  lrc and clay
pass it on to the plugin=cuda codecs they build (a layer's plugin=cuda,
scalar_mds=cuda); plugins that compute on the host (jerasure, isa, shec)
ignore it.
"""

from __future__ import annotations

import argparse
import itertools
import json
import random
import sys
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="erasure code benchmark")
    p.add_argument("--verbose", "-v", action="store_true")
    p.add_argument("--size", "-s", type=int, default=1024 * 1024,
                   help="size of the buffer to be encoded")
    p.add_argument("--iterations", "-i", type=int, default=1,
                   help="number of encode/decode runs")
    p.add_argument("--plugin", "-p", default="jerasure",
                   help="erasure code plugin name")
    p.add_argument("--workload", "-w", default="encode",
                   choices=("encode", "decode"))
    p.add_argument("--erasures", "-e", type=int, default=1,
                   help="number of erasures when decoding")
    p.add_argument("--erased", type=int, action="append", default=None,
                   help="erased chunk (repeat for more)")
    p.add_argument("--erasures-generation", "-E", default="random",
                   choices=("random", "exhaustive"))
    p.add_argument("--parameter", "-P", action="append", default=[],
                   help="add a parameter to the erasure code profile (k=v)")
    p.add_argument("--directory", default="",
                   help="plugin directory (ec_<name>.py files)")
    p.add_argument("--device", default="cuda",
                   help="device plugin=cuda runs on: cuda, cuda:N or cpu")
    p.add_argument("--perf-dump", action="store_true",
                   help="after the run, print the gf2_sched/ec_plugin "
                        "perf counter snapshot as JSON on stderr (stdout "
                        "keeps the reference '<seconds>\\t<KB>' protocol)")
    return p.parse_args(argv)


def perf_dump_json() -> str:
    """The counter sets this CLI exercises, as one JSON object: `gf2_sched`
    (schedule LRU hit/miss/compile/CSE) and `ec_plugin` (device dispatches
    vs CPU-served calls through the cuda plugin seams)."""
    from ceph_tpu_torch.ec.plugins.cuda import PLUGIN_PERF
    from ceph_tpu_torch.ops.gf2 import SCHED_PERF

    return json.dumps({"gf2_sched": SCHED_PERF.dump(),
                       "ec_plugin": PLUGIN_PERF.dump()})


def build_profile(args):
    from ceph_tpu_torch.tools import parse_parameters

    profile = {"plugin": args.plugin}
    profile.update(parse_parameters(args.parameter))
    return profile


def make_codec(args, profile):
    """Resolve the codec through the registry on --device: plugin=cuda
    codecs, including the ones lrc's layers and clay's scalar_mds=cuda
    build, compute there; host plugins ignore it."""
    from ceph_tpu_torch.ec.registry import registry

    return registry.factory(args.plugin, args.directory, dict(profile),
                            device=args.device)


def bench_encode(codec, args) -> int:
    n = codec.get_chunk_count()
    data = b"X" * args.size
    want = set(range(n))
    begin = time.perf_counter()
    for _ in range(args.iterations):
        codec.encode(want, data)
    elapsed = time.perf_counter() - begin
    print(f"{elapsed:f}\t{args.iterations * (args.size // 1024)}")
    return 0


def _recovered(codec, encoded, combo, chunk_size) -> bool:
    available = {c: b for c, b in encoded.items() if c not in combo}
    decoded = codec.decode(set(combo), available, chunk_size)
    for c in combo:
        if not np.array_equal(decoded[c], encoded[c]):
            print(f"chunk {c} content and recovered content are different",
                  file=sys.stderr)
            return False
    return True


def decode_exhaustive(codec, encoded, erasures: int) -> int:
    """All erasure combinations up to `erasures` over the chunks present in
    `encoded` (chunks pre-erased via --erased are simply never available),
    verifying content."""
    present = sorted(encoded)
    chunk_size = len(encoded[present[0]])
    for combo in itertools.combinations(present, erasures):
        if not _recovered(codec, encoded, combo, chunk_size):
            return 1
    return 0


#: post-loop verification re-decodes at most this many distinct erasure
#: signatures (random mode can touch many over a long run; the content
#: check must stay O(signatures), not O(iterations))
VERIFY_SIGNATURE_CAP = 64


def verify_signatures(codec, encoded_full, signatures, chunk_size) -> int:
    """Re-decode each erasure signature outside the timed window and compare
    recovered content against the originally encoded chunks."""
    for combo in signatures:
        if not _recovered(codec, encoded_full, combo, chunk_size):
            return 1
    return 0


def bench_decode(codec, args) -> int:
    n = codec.get_chunk_count()
    data = b"X" * args.size
    encoded = codec.encode(set(range(n)), data)
    chunk_size = len(next(iter(encoded.values())))
    want = set(range(n))
    erased = args.erased or []
    encoded_full = dict(encoded)  # pre-erasure originals for verification
    for c in erased:
        encoded.pop(c, None)

    seen_signatures = set()
    begin = time.perf_counter()
    for _ in range(args.iterations):
        if args.erasures_generation == "exhaustive":
            code = decode_exhaustive(codec, encoded, args.erasures)
            if code:
                return code
        elif erased:
            codec.decode(want, encoded, chunk_size)
            seen_signatures.add(tuple(sorted(erased)))
        else:
            chunks = dict(encoded)
            for _ in range(args.erasures):
                while True:
                    erasure = random.randrange(n)
                    if erasure in chunks:
                        break
                del chunks[erasure]
            seen_signatures.add(tuple(sorted(set(encoded) - set(chunks))))
            codec.decode(want, chunks, chunk_size)
    elapsed = time.perf_counter() - begin
    code = verify_signatures(
        codec, encoded_full,
        sorted(seen_signatures)[:VERIFY_SIGNATURE_CAP], chunk_size)
    if code:
        return code
    print(f"{elapsed:f}\t{args.iterations * (args.size // 1024)}")
    return 0


def main(argv=None) -> int:
    args = parse_args(argv)
    profile = build_profile(args)
    try:
        codec = make_codec(args, profile)
    except Exception as e:
        print(f"factory({args.plugin}) failed: {e}", file=sys.stderr)
        return 1
    try:
        if args.workload == "encode":
            code = bench_encode(codec, args)
        else:
            code = bench_decode(codec, args)
        if args.perf_dump:
            print(perf_dump_json(), file=sys.stderr)
        return code
    except Exception as e:
        print(f"{type(e).__name__}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
