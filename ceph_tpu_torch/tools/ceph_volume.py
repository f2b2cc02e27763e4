# Copy of ceph_tpu/tools/ceph_volume.py at commit 38c1795, with its ceph_tpu
# references rebound to ceph_tpu_torch.
"""ceph-volume-lite: OSD data-directory preparation and inventory
(reference src/ceph-volume: `ceph-volume lvm prepare/activate/list` and
`ceph-volume inventory`, translated from LVM/block devices to the
directory-backed BlueStore this framework's daemons mount).

    python -m ceph_tpu_torch.tools.ceph_volume inventory --base DIR
    python -m ceph_tpu_torch.tools.ceph_volume prepare --base DIR --osd-id N
    python -m ceph_tpu_torch.tools.ceph_volume list --base DIR
    python -m ceph_tpu_torch.tools.ceph_volume zap --base DIR --osd-id N --yes

prepare lays down the BlueStore on-disk shape (block file + KV WAL dir)
plus the osd_fsid/whoami stamp files the reference writes, so a daemon
host (tools/cephadm.py) can adopt the directory; activate is implicit in
daemon start, exactly as cephadm drives it.  list/inventory read the
stamps back; zap destroys a prepared directory (name + --yes guard)."""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import uuid

STAMP = "osd_stamp.json"


def _osd_dir(base: str, osd_id: int) -> str:
    return os.path.join(base, f"osd.{osd_id}")


def prepare(args) -> int:
    path = _osd_dir(args.base, args.osd_id)
    if os.path.exists(os.path.join(path, STAMP)):
        print(f"osd.{args.osd_id} already prepared at {path}",
              file=sys.stderr)
        return 1
    # the BlueStore on-disk shape (bluestore.py expects block + db/)
    from ceph_tpu_torch.rados.bluestore import BlueStore

    store = BlueStore(path, conf={})
    store.close()
    stamp = {"osd_id": args.osd_id, "osd_fsid": uuid.uuid4().hex,
             "type": "bluestore", "objectstore": "bluestore-lite"}
    with open(os.path.join(path, STAMP), "w") as f:
        json.dump(stamp, f, indent=1)
    print(f"prepared osd.{args.osd_id} fsid {stamp['osd_fsid']} at {path}")
    return 0


def _entries(base: str):
    if not os.path.isdir(base):
        return
    for name in sorted(os.listdir(base)):
        spath = os.path.join(base, name, STAMP)
        if name.startswith("osd.") and os.path.exists(spath):
            with open(spath) as f:
                stamp = json.load(f)
            stamp["path"] = os.path.join(base, name)
            yield stamp


def list_osds(args) -> int:
    out = list(_entries(args.base))
    print(json.dumps(out, indent=1))
    return 0


def inventory(args) -> int:
    """Directory inventory (ceph-volume inventory role): every candidate
    subdirectory, whether it holds a prepared OSD, and its usage."""
    rows = []
    prepared = {e["path"]: e for e in _entries(args.base)}
    if os.path.isdir(args.base):
        for name in sorted(os.listdir(args.base)):
            path = os.path.join(args.base, name)
            if not os.path.isdir(path):
                continue
            stamp = prepared.get(path)
            size = 0
            for root, _dirs, files in os.walk(path):
                size += sum(os.path.getsize(os.path.join(root, fn))
                            for fn in files)
            rows.append({
                "path": path,
                "available": stamp is None,
                "osd_id": stamp["osd_id"] if stamp else None,
                "osd_fsid": stamp["osd_fsid"] if stamp else None,
                "bytes_used": size,
            })
    print(json.dumps(rows, indent=1))
    return 0


def zap(args) -> int:
    path = _osd_dir(args.base, args.osd_id)
    if not os.path.exists(os.path.join(path, STAMP)):
        print(f"no prepared osd.{args.osd_id} at {path}", file=sys.stderr)
        return 1
    if not args.yes:
        print("zap destroys the OSD's data; pass --yes to confirm",
              file=sys.stderr)
        return 1
    shutil.rmtree(path)
    print(f"zapped osd.{args.osd_id} at {path}")
    return 0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ceph-volume-lite")
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("prepare", "zap"):
        s = sub.add_parser(name)
        s.add_argument("--base", required=True)
        s.add_argument("--osd-id", type=int, required=True)
        if name == "zap":
            s.add_argument("--yes", action="store_true")
    for name in ("list", "inventory"):
        s = sub.add_parser(name)
        s.add_argument("--base", required=True)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        return {"prepare": prepare, "list": list_osds,
                "inventory": inventory, "zap": zap}[args.cmd](args)
    except BrokenPipeError:
        return 0  # downstream pager/head closed the pipe mid-print


if __name__ == "__main__":
    sys.exit(main())
