"""Operator CLIs and offline tools of the port: benchmark
(ceph_erasure_code_benchmark) and bench_suite (qa's bench.sh sweep),
non_regression (the erasure-code corpus and the cluster gates), rados and
rbd (pool I/O and images), radosgw_admin (rgw users, quotas and usage),
cephfs_shell (one-shot file access over the cap-aware client), ceph (the
status and admin CLI), cephadm and ceph_volume (deployment), traffic (the
gates' tenant load), wire_corpus and dencoder (the wire format's archive
and round trips), objectstore_tool and monstore_tool (offline stores),
trace_export (Jaeger JSON of a stitched trace) and lint (the tree's static
checks)."""

import sys
from typing import Dict, List


def parse_parameters(params: List[str], warn: bool = True) -> Dict[str, str]:
    """-P k=v list -> profile dict.  Values may themselves contain '='
    (lrc layers profiles embed per-layer k=v strings), so split once."""
    profile: Dict[str, str] = {}
    for kv in params:
        if "=" not in kv:
            if warn:
                print(f"--parameter {kv} ignored because it does not "
                      "contain a =", file=sys.stderr)
            continue
        key, value = kv.split("=", 1)
        profile[key] = value
    return profile
