# Copy of ceph_tpu/tools/rados.py at commit 484e351, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""rados CLI: put/get/rm/ls against a running vstart cluster
(the reference's src/tools/rados minimal surface).

    python -m ceph_tpu_torch.rados.vstart --osds 5          # terminal 1
    python -m ceph_tpu_torch.tools.rados --mon HOST:PORT mkpool data k=4 m=2
    python -m ceph_tpu_torch.tools.rados --mon HOST:PORT put data obj1 ./file
    python -m ceph_tpu_torch.tools.rados --mon HOST:PORT get data obj1 ./out
"""

from __future__ import annotations

import argparse
import asyncio
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="rados object tool")
    p.add_argument("--mon", required=True, help="mon address host:port")
    p.add_argument("-N", "--namespace", default="",
                   help="rados namespace for object ops (reference "
                        "rados -N; --all-namespaces for ls)")
    p.add_argument("--all-namespaces", action="store_true",
                   help="ls spans every namespace (prints ns/name)")
    sub = p.add_subparsers(dest="cmd", required=True)

    mk = sub.add_parser("mkpool")
    mk.add_argument("pool")
    mk.add_argument("profile", nargs="*", help="profile k=v pairs")

    put = sub.add_parser("put")
    put.add_argument("pool")
    put.add_argument("obj")
    put.add_argument("path")

    get = sub.add_parser("get")
    get.add_argument("pool")
    get.add_argument("obj")
    get.add_argument("path")

    rm = sub.add_parser("rm")
    rm.add_argument("pool")
    rm.add_argument("obj")

    ls = sub.add_parser("ls")
    ls.add_argument("pool")

    mks = sub.add_parser("mksnap", help="create a pool snapshot")
    mks.add_argument("pool")
    mks.add_argument("snap")

    rms = sub.add_parser("rmsnap", help="remove a pool snapshot")
    rms.add_argument("pool")
    rms.add_argument("snap")

    lss = sub.add_parser("lssnap", help="list pool snapshots")
    lss.add_argument("pool")

    rb = sub.add_parser("rollback",
                        help="roll one object back to a pool snapshot")
    rb.add_argument("pool")
    rb.add_argument("obj")
    rb.add_argument("snap")

    be = sub.add_parser("bench", help="reference `rados bench` role")
    be.add_argument("pool")
    be.add_argument("seconds", type=float)
    be.add_argument("mode", choices=("write", "seq"))
    be.add_argument("--object-size", type=int, default=1 << 22)
    be.add_argument("--concurrency", type=int, default=16)
    be.add_argument("--no-cleanup", action="store_true",
                    help="keep written objects (needed before a seq run)")
    be.add_argument("--run-name", default="benchmark_data",
                    help="object name prefix (ties write and seq runs)")

    return p.parse_args(argv)


async def _bench(client, pool_id: int, args) -> int:
    """Timed write/seq workload (reference rados bench: bounded
    concurrency, per-op latency tracking, MB/s summary)."""
    import json
    import os
    import time

    oid = lambda i: f"{args.run_name}_{i:08d}"  # noqa: E731
    payload = os.urandom(args.object_size) if args.mode == "write" else b""
    deadline = time.monotonic() + args.seconds
    lats = []
    issued = 0
    done = 0
    total_bytes = 0
    names: list = []
    sem = asyncio.Semaphore(max(1, args.concurrency))

    async def one(i: int):
        nonlocal done, total_bytes
        t0 = time.monotonic()
        try:
            if args.mode == "write":
                await client.put(pool_id, oid(i), payload)
                nbytes = len(payload)
            else:
                # read the DISCOVERED names, not a regenerated counter:
                # gaps from a partially failed write run must not shift
                # every later read onto a missing object
                nbytes = len(await client.get(pool_id, names[i]))
        except Exception:
            return
        finally:
            sem.release()
        lats.append(time.monotonic() - t0)
        done += 1
        total_bytes += nbytes

    if args.mode == "seq":
        names = sorted(n for n in await client.list_objects(pool_id)
                       if n.startswith(args.run_name + "_"))
        if not names:
            print("no benchmark objects; run "
                  "`bench ... write --no-cleanup` first", file=sys.stderr)
            return 1
    t_start = time.monotonic()
    tasks = []
    # issuance is BOUNDED by the concurrency window (a slot must free
    # before the next op is issued, the reference's in-flight cap): at
    # the deadline at most `concurrency` ops remain to drain
    while time.monotonic() < deadline:
        if args.mode == "seq" and issued >= len(names):
            break
        await sem.acquire()
        if time.monotonic() >= deadline:
            sem.release()
            break
        tasks.append(asyncio.ensure_future(one(issued)))
        issued += 1
        tasks = [t for t in tasks if not t.done()]
    if tasks:
        await asyncio.gather(*tasks, return_exceptions=True)
    dt = max(time.monotonic() - t_start, 1e-9)
    total_mb = total_bytes / (1 << 20)  # bytes actually moved
    out = {
        "mode": args.mode,
        "ops": done,
        "seconds": round(dt, 3),
        "bandwidth_MBps": round(total_mb / dt, 3),
        "avg_lat_s": round(sum(lats) / len(lats), 5) if lats else None,
        "max_lat_s": round(max(lats), 5) if lats else None,
    }
    print(json.dumps(out))
    if args.mode == "write" and not args.no_cleanup:
        for i in range(issued):
            try:
                await client.delete(pool_id, oid(i))
            except Exception:
                pass
    return 0


async def run(args) -> int:
    from ceph_tpu_torch.rados.client import RadosClient

    host, port = args.mon.rsplit(":", 1)
    client = RadosClient((host, int(port)))
    await client.start()
    try:
        await client.refresh_map()
        pools = {p.name: p.pool_id for p in client.osdmap.pools.values()}
        if args.cmd == "mkpool":
            from ceph_tpu_torch.tools import parse_parameters

            profile = parse_parameters(args.profile)
            profile.setdefault("plugin", "jerasure")
            pool_id = await client.create_pool(args.pool, profile=profile)
            print(f"pool {args.pool} created (id {pool_id})")
            return 0
        if args.pool not in pools:
            print(f"pool {args.pool} does not exist", file=sys.stderr)
            return 1
        pool_id = pools[args.pool]
        from ceph_tpu_torch.rados.types import (ALL_NSPACES, NS_SEP, SNAP_SEP,
                                          make_oid, split_ns)

        ns = getattr(args, "namespace", "") or ""
        if ns == ALL_NSPACES or NS_SEP in ns or SNAP_SEP in ns:
            # same boundary validation as IoCtx.set_namespace: the
            # reserved separator and the all-namespaces sentinel are
            # not valid I/O namespaces
            print("invalid namespace", file=sys.stderr)
            return 2
        if args.cmd == "put":
            with open(args.path, "rb") as f:
                data = f.read()
            await client.put(pool_id, make_oid(ns, args.obj), data)
        elif args.cmd == "get":
            data = await client.get(pool_id, make_oid(ns, args.obj))
            with open(args.path, "wb") as f:
                f.write(data)
        elif args.cmd == "rm":
            await client.delete(pool_id, make_oid(ns, args.obj))
        elif args.cmd == "ls":
            if args.all_namespaces:
                for wire in await client.list_objects(
                        pool_id, nspace=ALL_NSPACES):
                    w_ns, name = split_ns(wire)
                    print(f"{w_ns}/{name}" if w_ns else name)
            else:
                for wire in await client.list_objects(pool_id, nspace=ns):
                    print(split_ns(wire)[1])
        elif args.cmd == "mksnap":
            sid = await client.pool_snap_create(pool_id, args.snap)
            print(f"created pool {args.pool} snap {args.snap} (id {sid})")
        elif args.cmd == "rmsnap":
            await client.pool_snap_remove(pool_id, args.snap)
            print(f"removed pool {args.pool} snap {args.snap}")
        elif args.cmd == "lssnap":
            snaps = await client.pool_snap_list(pool_id)
            for name, sid in sorted(snaps.items(), key=lambda kv: kv[1]):
                print(f"{sid}\t{name}")
            print(f"{len(snaps)} snaps")
        elif args.cmd == "rollback":
            snaps = await client.pool_snap_list(pool_id)
            if args.snap not in snaps:
                print(f"no snap {args.snap}", file=sys.stderr)
                return 1
            await client.rollback_object(pool_id, make_oid(ns, args.obj),
                                         snaps[args.snap])
            print(f"rolled back {args.obj} to {args.snap}")
        elif args.cmd == "bench":
            return await _bench(client, pool_id, args)
        return 0
    finally:
        await client.stop()


def main(argv=None) -> int:
    return asyncio.run(run(parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
