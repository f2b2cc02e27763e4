# Copy of ceph_tpu/tools/monstore_tool.py at commit 38c1795, with its ceph_tpu
# references rebound to ceph_tpu_torch.
"""Offline mon-store inspection/repair (reference
src/tools/ceph_monstore_tool.cc).

Dumps a stopped monitor's MonitorDBStore: paxos versions, the committed
cluster state (map epoch, pools, OSDs, config), and can rewrite the store
to a chosen version (the get/rewrite workflow used for disaster recovery).

    python -m ceph_tpu_torch.tools.monstore_tool PATH dump
    python -m ceph_tpu_torch.tools.monstore_tool PATH get-state [VERSION]
    python -m ceph_tpu_torch.tools.monstore_tool PATH rewrite VERSION
"""

from __future__ import annotations

import json
import pickle
import sys

from ceph_tpu_torch.rados.paxos import MonitorDBStore


def dump(store: MonitorDBStore) -> int:
    print(json.dumps({
        "first_committed": store.first_committed,
        "last_committed": store.last_committed,
        "versions": sorted(store.committed),
        "meta": {k: repr(v) for k, v in store.meta.items()},
    }, indent=2))
    return 0


def get_state(store: MonitorDBStore, version: int = 0) -> int:
    v = version or store.last_committed
    blob = store.get(v)
    if blob is None:
        print(f"version {v} not in store", file=sys.stderr)
        return 1
    state = pickle.loads(blob)
    osdmap = state["osdmap"]
    print(json.dumps({
        "paxos_version": v,
        "map_epoch": osdmap.epoch,
        "osds": {i: {"up": o.up, "in": o.in_cluster, "addr": list(o.addr)}
                 for i, o in osdmap.osds.items()},
        "pools": {i: {"name": p.name, "type": p.pool_type, "pg_num": p.pg_num,
                      "profile": p.profile}
                  for i, p in osdmap.pools.items()},
        "cluster_conf": state["cluster_conf"],
    }, indent=2))
    return 0


def rewrite(store: MonitorDBStore, version: int) -> int:
    """Truncate history after `version` (disaster rollback)."""
    blob = store.get(version)
    if blob is None:
        print(f"version {version} not in store", file=sys.stderr)
        return 1
    for v in list(store.committed):
        if v > version:
            del store.committed[v]
    store.last_committed = version
    store._persist()
    print(f"store rewound to version {version}")
    return 0


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    path, cmd = argv[0], argv[1]
    store = MonitorDBStore(path)
    if cmd == "dump":
        return dump(store)
    if cmd == "get-state":
        return get_state(store, int(argv[2]) if len(argv) > 2 else 0)
    if cmd == "rewrite":
        return rewrite(store, int(argv[2]))
    print(f"unknown command {cmd}", file=sys.stderr)
    return 2


if __name__ == "__main__":
    import signal

    signal.signal(signal.SIGPIPE, signal.SIG_DFL)  # behave under | head
    sys.exit(main())
