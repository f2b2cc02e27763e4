# Copy of ceph_tpu/tools/radosgw_admin.py at commit ac6dced, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""radosgw-admin CLI: user/quota/usage administration for a gateway's
pool (the reference's src/rgw/rgw_admin.cc minimal surface).

    python -m ceph_tpu_torch.tools.radosgw_admin --mon HOST:PORT --pool rgw \\
        user create --uid alice --display-name "Alice"
    ... user list | user info --uid alice | user rm --uid alice
    ... user suspend --uid alice | user enable --uid alice
    ... quota set --uid alice --scope user --max-size 1048576
    ... quota enable --uid alice --scope user
    ... usage --uid alice

Prints one JSON document per command (machine-parseable, like the
reference's --format=json)."""

from __future__ import annotations

import argparse
import asyncio
import json
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="rgw admin tool")
    p.add_argument("--mon", required=True, help="mon address host:port")
    p.add_argument("--pool", required=True, help="gateway pool name")
    sub = p.add_subparsers(dest="cmd", required=True)

    user = sub.add_parser("user")
    usub = user.add_subparsers(dest="action", required=True)
    for action in ("create", "rm", "info", "suspend", "enable"):
        sp = usub.add_parser(action)
        sp.add_argument("--uid", required=True)
        if action == "create":
            sp.add_argument("--display-name", default="")
            sp.add_argument("--access-key")
            sp.add_argument("--secret-key")
    usub.add_parser("list")

    quota = sub.add_parser("quota")
    qsub = quota.add_subparsers(dest="action", required=True)
    for action in ("set", "enable", "disable"):
        sp = qsub.add_parser(action)
        sp.add_argument("--uid", required=True)
        sp.add_argument("--scope", choices=("user", "bucket"),
                        default="user")
        if action == "set":
            sp.add_argument("--max-size", type=int, default=-1)
            sp.add_argument("--max-objects", type=int, default=-1)

    usage = sub.add_parser("usage")
    usage.add_argument("--uid", required=True)

    return p.parse_args(argv)


async def run(args) -> int:
    from ceph_tpu_torch.rados.librados import Rados
    from ceph_tpu_torch.services.rgw import RgwAdmin, RgwService

    host, port = args.mon.rsplit(":", 1)
    rados = await Rados((host, int(port))).connect()
    try:
        ioctx = await rados.open_ioctx(args.pool)
        admin = RgwAdmin(RgwService(ioctx))
        if args.cmd == "user":
            if args.action == "create":
                out = await admin.user_create(
                    args.uid, args.display_name,
                    access_key=args.access_key,
                    secret_key=args.secret_key)
            elif args.action == "rm":
                await admin.user_rm(args.uid)
                out = {"removed": args.uid}
            elif args.action == "info":
                out = await admin.user_info(args.uid)
            elif args.action == "suspend":
                await admin.user_suspend(args.uid)
                out = {"uid": args.uid, "suspended": True}
            elif args.action == "enable":
                await admin.user_enable(args.uid)
                out = {"uid": args.uid, "suspended": False}
            else:
                out = await admin.user_list()
        elif args.cmd == "quota":
            if args.action == "set":
                await admin.quota_set(args.uid, args.scope,
                                      args.max_size, args.max_objects)
            elif args.action == "enable":
                await admin.quota_enable(args.uid, args.scope)
            else:
                await admin.quota_disable(args.uid, args.scope)
            out = (await admin.user_info(args.uid)).get(
                "quota" if args.scope == "user" else "bucket_quota")
        else:
            out = await admin.usage(args.uid)
        print(json.dumps(out, indent=2, sort_keys=True))
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
