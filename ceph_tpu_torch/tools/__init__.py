"""Operator CLIs of the port: benchmark (ceph_erasure_code_benchmark),
rados and rbd (pool I/O and images), radosgw_admin (rgw users, quotas and
usage) and cephfs_shell (one-shot file access over the cap-aware
client)."""

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
