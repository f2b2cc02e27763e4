# Copy of ceph_tpu/tools/cephfs_shell.py at commit ac6dced, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""cephfs-shell-lite: operator file access to a CephFS namespace
(reference src/tools/cephfs/shell/cephfs-shell: the non-FUSE client
surface).  One-shot commands over the cap-aware client:

    python -m ceph_tpu_torch.tools.cephfs_shell --mon H:P --pool P ls /
    ... mkdir /dir | put LOCAL /remote | get /remote LOCAL | cat /f
    ... stat /f | chmod 600 /f | rm /f | mv /a /b | du /

The shell mounts (journal replay), runs the command through a
CephFSClient session, and unmounts (flushing write-behind) — so every
invocation observes and leaves a consistent namespace."""

from __future__ import annotations

import argparse
import asyncio
import json
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="cephfs shell")
    p.add_argument("--mon", required=True, help="mon address host:port")
    p.add_argument("--pool", required=True, help="metadata/data pool")
    p.add_argument("--client", default="shell", help="client identity")
    sub = p.add_subparsers(dest="cmd", required=True)
    ls = sub.add_parser("ls")
    ls.add_argument("path", nargs="?", default="/")
    mk = sub.add_parser("mkdir")
    mk.add_argument("path")
    put = sub.add_parser("put")
    put.add_argument("local")
    put.add_argument("remote")
    get = sub.add_parser("get")
    get.add_argument("remote")
    get.add_argument("local")
    cat = sub.add_parser("cat")
    cat.add_argument("path")
    st = sub.add_parser("stat")
    st.add_argument("path")
    ch = sub.add_parser("chmod")
    ch.add_argument("mode", help="octal, e.g. 600")
    ch.add_argument("path")
    rm = sub.add_parser("rm")
    rm.add_argument("path")
    mv = sub.add_parser("mv")
    mv.add_argument("src")
    mv.add_argument("dst")
    du = sub.add_parser("du")
    du.add_argument("path", nargs="?", default="/")
    return p.parse_args(argv)


async def _du(client, path: str) -> int:
    """Recursive byte total (file sizes from dentries, no data reads)."""
    total = 0
    st = await client.stat(path)
    if st.get("type") != "dir":
        return int(st.get("size", 0))
    for name in await client.listdir(path):
        child = path.rstrip("/") + "/" + name
        total += await _du(client, child)
    return total


async def run(args) -> int:
    from ceph_tpu_torch.rados.librados import Rados
    from ceph_tpu_torch.services.mds import (CephFSClient, FileSystem, FsError,
                                       MDSServer)

    host, port = args.mon.rsplit(":", 1)
    rados = await Rados((host, int(port))).connect()
    try:
        io = await rados.open_ioctx(args.pool)
        fs = FileSystem(io)
        await fs.mount()  # journal replay: the up:replay stage
        client = CephFSClient(MDSServer(fs), args.client)
        try:
            if args.cmd == "ls":
                for name in await client.listdir(args.path):
                    print(name)
            elif args.cmd == "mkdir":
                await client.mkdir(args.path)
            elif args.cmd == "put":
                with open(args.local, "rb") as f:
                    data = f.read()
                async with await client.open(args.remote, "w") as fh:
                    await fh.write(data)
                print(f"wrote {len(data)} bytes to {args.remote}")
            elif args.cmd == "get":
                async with await client.open(args.remote, "r") as fh:
                    data = await fh.read()
                with open(args.local, "wb") as f:
                    f.write(data)
                print(f"read {len(data)} bytes from {args.remote}")
            elif args.cmd == "cat":
                async with await client.open(args.path, "r") as fh:
                    sys.stdout.buffer.write(await fh.read())
            elif args.cmd == "stat":
                st = await client.stat(args.path)
                if "mode" in st:
                    st = dict(st, mode=oct(st["mode"]))
                print(json.dumps(st, indent=1, sort_keys=True))
            elif args.cmd == "chmod":
                await client.chmod(args.path, int(args.mode, 8))
            elif args.cmd == "rm":
                await client.unlink(args.path)
            elif args.cmd == "mv":
                await client.rename(args.src, args.dst)
            elif args.cmd == "du":
                print(await _du(client, args.path))
            return 0
        except (FsError, OSError, ValueError) as e:
            # one error contract: message + exit 1, never a traceback
            # (OSError: local file I/O; ValueError: e.g. a bad octal)
            print(str(e), file=sys.stderr)
            return 1
        finally:
            await client.unmount()  # flush write-behind, drop caps
    finally:
        await rados.shutdown()


def main(argv=None) -> int:
    return asyncio.run(run(parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
