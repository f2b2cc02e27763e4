# Copy of ceph_tpu/tools/objectstore_tool.py at commit 38c1795, with its ceph_tpu
# references rebound to ceph_tpu_torch.
"""Offline object-store surgery (reference src/tools/ceph_objectstore_tool.cc).

Operates on a stopped OSD's BlueStore directory — list objects, dump one
object's data/metadata/xattrs/omap, export/import objects as portable
blobs, remove objects — the recovery-of-last-resort workflow the reference
tool provides.

    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR --op list
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR --op info \\
        --pool 1 --oid obj --shard 0
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR --op export \\
        --pool 1 --oid obj --shard 0 --file out.bin
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR --op import \\
        --file out.bin
    python -m ceph_tpu_torch.tools.objectstore_tool --data-path DIR --op remove \\
        --pool 1 --oid obj --shard 0
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys
from typing import Optional

from ceph_tpu_torch.rados.bluestore import BlueStore
from ceph_tpu_torch.rados.store import ShardMeta, Transaction


def op_list(store: BlueStore, pool: Optional[int]) -> int:
    for key in sorted(store._onodes):
        pid, oid, shard = key
        if pool is not None and pid != pool:
            continue
        print(json.dumps({"pool": pid, "oid": oid, "shard": shard}))
    return 0


def op_info(store: BlueStore, pool: int, oid: str, shard: int) -> int:
    key = (pool, oid, shard)
    got = store.read(key)
    if got is None:
        print("object not found", file=sys.stderr)
        return 1
    data, meta = got
    print(json.dumps({
        "pool": pool, "oid": oid, "shard": shard,
        "stored_bytes": len(data),
        "meta": meta.__dict__,
        "xattrs": sorted(store.getattrs(key)),
        "omap_keys": sorted(store.omap_get(key)),
    }, indent=2))
    return 0


def op_export(store: BlueStore, pool: int, oid: str, shard: int,
              path: str) -> int:
    key = (pool, oid, shard)
    got = store.read(key)
    if got is None:
        print("object not found", file=sys.stderr)
        return 1
    data, meta = got
    blob = pickle.dumps({
        "key": key, "data": data, "meta": meta.__dict__,
        "xattrs": store.getattrs(key), "omap": store.omap_get(key),
    }, protocol=5)
    with open(path, "wb") as f:
        f.write(blob)
    print(f"exported {len(data)} bytes to {path}")
    return 0


def op_import(store: BlueStore, path: str) -> int:
    with open(path, "rb") as f:
        blob = pickle.load(f)
    key = tuple(blob["key"])
    txn = Transaction()
    txn.write(key, blob["data"], ShardMeta(**blob["meta"]))
    if blob.get("omap"):
        txn.omap_set(key, blob["omap"])
    store.queue_transaction(txn)
    for name, value in blob.get("xattrs", {}).items():
        store.setattr(key, name, value)
    print(f"imported {key}")
    return 0


def op_remove(store: BlueStore, pool: int, oid: str, shard: int) -> int:
    txn = Transaction()
    txn.delete((pool, oid, shard))
    store.queue_transaction(txn)
    print(f"removed ({pool}, {oid!r}, {shard})")
    return 0


def op_statfs(store: BlueStore) -> int:
    print(json.dumps(store.statfs(), indent=2))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="objectstore-tool")
    p.add_argument("--data-path", required=True)
    p.add_argument("--op", required=True,
                   choices=["list", "info", "export", "import", "remove",
                            "statfs"])
    p.add_argument("--pool", type=int, default=None)
    p.add_argument("--oid")
    p.add_argument("--shard", type=int, default=0)
    p.add_argument("--file")
    args = p.parse_args(argv)
    store = BlueStore(args.data_path)
    try:
        if args.op == "list":
            return op_list(store, args.pool)
        if args.op == "statfs":
            return op_statfs(store)
        if args.op == "import":
            return op_import(store, args.file)
        if args.pool is None or args.oid is None:
            print("--pool and --oid required", file=sys.stderr)
            return 2
        if args.op == "info":
            return op_info(store, args.pool, args.oid, args.shard)
        if args.op == "export":
            return op_export(store, args.pool, args.oid, args.shard, args.file)
        if args.op == "remove":
            return op_remove(store, args.pool, args.oid, args.shard)
        return 2
    finally:
        store.close()


if __name__ == "__main__":
    import signal

    signal.signal(signal.SIGPIPE, signal.SIG_DFL)  # behave under | head
    sys.exit(main())
