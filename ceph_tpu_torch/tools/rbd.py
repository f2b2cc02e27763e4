# Copy of ceph_tpu/tools/rbd.py at commit 484e351, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""rbd CLI: image lifecycle, snapshots, and export/import/diff backup
workflows (reference src/tools/rbd minimal surface).

    python -m ceph_tpu_torch.tools.rbd --mon HOST:PORT --pool p create img --size 64M
    ... ls | info img | resize img --size 128M | rm img
    ... snap create img@s1 | snap ls img
    ... export img ./img.full            # sparse-preserving full export
    ... import ./img.full img2
    ... export-diff img --from-snap s1 ./img.delta
    ... import-diff ./img.delta img2
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys


def _parse_size(s: str) -> int:
    s = s.strip().upper()
    mult = 1
    for suffix, m in (("K", 1 << 10), ("M", 1 << 20), ("G", 1 << 30)):
        if s.endswith(suffix):
            s, mult = s[:-1], m
            break
    return int(float(s) * mult)


def _split_at(spec: str):
    """img or img@snap -> (img, snap|None)."""
    name, _, snap = spec.partition("@")
    return name, (snap or None)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="rbd image tool")
    p.add_argument("--mon", required=True, help="mon address host:port")
    p.add_argument("--pool", required=True)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("create")
    c.add_argument("image")
    c.add_argument("--size", required=True, help="e.g. 64M, 1G")
    c.add_argument("--order", type=int, default=22)

    sub.add_parser("ls")

    du = sub.add_parser("du", help="provisioned vs USED bytes per image "
                                   "(fast-diff object-map accounting)")
    du.add_argument("image", nargs="?", help="one image (default: all)")

    i = sub.add_parser("info")
    i.add_argument("image")

    r = sub.add_parser("resize")
    r.add_argument("image")
    r.add_argument("--size", required=True)

    d = sub.add_parser("rm")
    d.add_argument("image")

    sn = sub.add_parser("snap")
    sn.add_argument("action", choices=("create", "ls", "rm"))
    sn.add_argument("spec", help="img@snap (ls: img)")

    tr = sub.add_parser("trash")
    tr.add_argument("action", choices=("mv", "ls", "restore", "purge"))
    tr.add_argument("target", nargs="?", default=None,
                    help="mv: image name; restore: trash id")
    tr.add_argument("--delay", type=float, default=0.0,
                    help="mv: deferment seconds before purge may reclaim")
    tr.add_argument("--image", default=None,
                    help="restore: optional new image name")
    tr.add_argument("--force", action="store_true",
                    help="purge: ignore deferment windows")

    e = sub.add_parser("export")
    e.add_argument("spec", help="img or img@snap")
    e.add_argument("path")

    im = sub.add_parser("import")
    im.add_argument("path")
    im.add_argument("image")
    im.add_argument("--order", type=int, default=22)

    ed = sub.add_parser("export-diff")
    ed.add_argument("spec", help="img or img@snap (the TO side)")
    ed.add_argument("path")
    ed.add_argument("--from-snap", default=None)

    idf = sub.add_parser("import-diff")
    idf.add_argument("path")
    idf.add_argument("image")

    return p.parse_args(argv)


async def run(args) -> int:
    from ceph_tpu_torch.rados.librados import Rados
    from ceph_tpu_torch.services.rbd import RBD
    from ceph_tpu_torch.services import rbd_export

    host, port = args.mon.rsplit(":", 1)
    rados = await Rados((host, int(port))).connect()
    try:
        ioctx = await rados.open_ioctx(args.pool)
        rbd = RBD(ioctx)
        if args.cmd == "create":
            await rbd.create(args.image, _parse_size(args.size),
                             order=args.order)
            print(f"created {args.image}")
        elif args.cmd == "ls":
            for name in await rbd.list():
                print(name)
        elif args.cmd == "du":
            # reference `rbd du`: USED = allocated blocks from the
            # object map (the fast-diff accounting), no data reads;
            # snapshots add their own pinned allocations
            names = [args.image] if args.image else await rbd.list()
            rows = []
            for name in names:
                img = await rbd.open(name)
                used = len(img._hdr.get("object_map", ())) \
                    * img.object_size
                snap_used = 0
                for info in img._snaps().values():
                    snap_used += len(info.get("object_map", ())) \
                        * img.object_size
                rows.append({"NAME": name, "PROVISIONED": img.size,
                             "USED": used, "SNAP_USED": snap_used})
            print(f"{'NAME':<20} {'PROVISIONED':>14} {'USED':>14} "
                  f"{'SNAP_USED':>14}")
            for r in rows:
                print(f"{r['NAME']:<20} {r['PROVISIONED']:>14} "
                      f"{r['USED']:>14} {r['SNAP_USED']:>14}")
            if not args.image:
                print(f"{'TOTAL':<20} "
                      f"{sum(r['PROVISIONED'] for r in rows):>14} "
                      f"{sum(r['USED'] for r in rows):>14} "
                      f"{sum(r['SNAP_USED'] for r in rows):>14}")
        elif args.cmd == "info":
            img = await rbd.open(args.image)
            print(json.dumps(await img.stat(), indent=2, sort_keys=True))
        elif args.cmd == "resize":
            img = await rbd.open(args.image)
            await img.resize(_parse_size(args.size))
            print(f"resized {args.image} to {args.size}")
        elif args.cmd == "rm":
            await rbd.remove(args.image)
            print(f"removed {args.image}")
        elif args.cmd == "snap":
            name, snap = _split_at(args.spec)
            img = await rbd.open(name)
            if args.action == "create":
                if not snap:
                    raise SystemExit("snap create needs img@snap")
                await img.snap_create(snap)
                print(f"created {args.spec}")
            elif args.action == "rm":
                if not snap:
                    raise SystemExit("snap rm needs img@snap")
                await img.snap_remove(snap)
                print(f"removed {args.spec}")
            else:
                for s in img.snap_list():
                    print(s)
        elif args.cmd == "trash":
            if args.action == "mv":
                if not args.target:
                    raise SystemExit("trash mv needs an image name")
                tid = await rbd.trash_mv(args.target, delay=args.delay)
                print(json.dumps({"id": tid}))
            elif args.action == "ls":
                print(json.dumps(await rbd.trash_ls(), indent=2))
            elif args.action == "restore":
                if not args.target:
                    raise SystemExit("trash restore needs a trash id")
                img = await rbd.trash_restore(args.target,
                                              new_name=args.image)
                print(f"restored {img.name}")
            else:
                n = await rbd.trash_purge(force=args.force)
                print(json.dumps({"purged": n}))
        elif args.cmd == "export":
            name, snap = _split_at(args.spec)
            img = await rbd.open(name)
            with open(args.path, "wb") as f:
                stats = await rbd_export.export_image(img, f, snap=snap)
            print(json.dumps(stats))
        elif args.cmd == "import":
            with open(args.path, "rb") as f:
                await rbd_export.import_image(rbd, args.image, f,
                                              order=args.order)
            print(f"imported {args.image}")
        elif args.cmd == "export-diff":
            name, snap = _split_at(args.spec)
            img = await rbd.open(name)
            with open(args.path, "wb") as f:
                stats = await rbd_export.export_diff(
                    img, f, from_snap=args.from_snap, to_snap=snap)
            print(json.dumps(stats))
        elif args.cmd == "import-diff":
            img = await rbd.open(args.image)
            with open(args.path, "rb") as f:
                stats = await rbd_export.apply_diff(img, f)
            print(json.dumps({"writes": stats["writes"],
                              "trims": stats["trims"]}))
        return 0
    finally:
        await rados.shutdown()


def main(argv=None) -> int:
    try:
        return asyncio.run(run(parse_args(argv)))
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
