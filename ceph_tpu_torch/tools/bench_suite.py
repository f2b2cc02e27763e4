# Copy of ceph_tpu/tools/bench_suite.py at commit 38c1795, with its ceph_tpu
# references rebound to ceph_tpu_torch.  Where the two differ: the device
# plugin is ``cuda`` (the reference's is ``tpu``), and ``--device`` (default
# ``cuda``; ``cpu`` must be named) is passed on to every benchmark run.
"""Benchmark sweep: plugins x techniques x (k, m), the qa bench.sh
equivalent (reference qa/workunits/erasure-code/bench.sh:52-174).

Emits one JSON line per cell:
  {"plugin":..., "technique":..., "k":..., "m":..., "workload":...,
   "seconds":..., "kb":..., "mbps":...}

    python -m ceph_tpu_torch.tools.bench_suite --size 1048576 --iterations 4
"""

from __future__ import annotations

import argparse
import io
import json
import sys
from contextlib import redirect_stdout

# bench.sh's k -> [m...] map (bench.sh:52-56)
K2MS = {2: [1, 2], 3: [2, 3], 4: [2, 3], 6: [2, 3, 4], 10: [3, 4]}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="erasure code benchmark sweep")
    p.add_argument("--size", type=int, default=1024 * 1024)
    p.add_argument("--iterations", type=int, default=4)
    p.add_argument("--plugins", default="jerasure,isa,cuda",
                   help="comma list of plugins to sweep")
    p.add_argument("--workloads", default="encode,decode")
    p.add_argument("--ks", default=",".join(str(k) for k in K2MS))
    p.add_argument("--device", default="cuda",
                   help="device plugin=cuda runs on: cuda, cuda:N or cpu")
    return p.parse_args(argv)


TECHNIQUES = {
    "jerasure": ["reed_sol_van", "cauchy_good"],
    "isa": ["reed_sol_van", "cauchy"],
    "cuda": ["reed_sol_van", "cauchy_good"],
}


def main(argv=None) -> int:
    from ceph_tpu_torch.tools import benchmark

    args = parse_args(argv)
    failures = 0
    for plugin in args.plugins.split(","):
        for technique in TECHNIQUES.get(plugin, ["reed_sol_van"]):
            for k in (int(x) for x in args.ks.split(",")):
                for m in K2MS.get(k, [2]):
                    for workload in args.workloads.split(","):
                        argv_b = [
                            "--plugin", plugin, "--workload", workload,
                            "--size", str(args.size),
                            "--iterations", str(args.iterations),
                            "-P", f"k={k}", "-P", f"m={m}",
                            "-P", f"technique={technique}",
                            "--device", args.device,
                        ]
                        buf = io.StringIO()
                        try:
                            with redirect_stdout(buf):
                                code = benchmark.main(argv_b)
                        except Exception as e:
                            print(f"# {plugin}/{technique} k={k} m={m} "
                                  f"{workload}: {e}", file=sys.stderr)
                            failures += 1
                            continue
                        if code:
                            failures += 1
                            continue
                        seconds_s, kb_s = buf.getvalue().strip().split("\t")
                        seconds, kb = float(seconds_s), int(kb_s)
                        print(json.dumps({
                            "plugin": plugin, "technique": technique,
                            "k": k, "m": m, "workload": workload,
                            "seconds": seconds, "kb": kb,
                            "mbps": (kb / 1024) / seconds if seconds else None,
                        }))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
