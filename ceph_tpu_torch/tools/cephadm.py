# Copy of ceph_tpu/tools/cephadm.py at commit 38c1795, with its ceph_tpu
# references rebound to ceph_tpu_torch.  Where the two differ: ``bootstrap``
# takes ``--device`` (default ``cuda``; ``cpu`` must be named) and passes it
# to the daemon host, which starts its OSDs with it as ``osd_ec_device``;
# the daemon host inherits this process's environment (the reference
# scrubs its accelerator variables to keep the child off libtpu's
# lockfile, which a CUDA host does not have).
"""cephadm-lite: the deploy/orchestration plane (reference src/cephadm/).

The reference's cephadm bootstraps and manages cluster daemons as
supervised containers; the role here is the same life-cycle surface over
real OS processes — each cluster is a detached daemon-host process
(``python -m ceph_tpu_torch.rados.vstart``) with durable stores under its data
directory, registered in a spec file the other subcommands read:

    python -m ceph_tpu_torch.tools.cephadm bootstrap --name c1 --osds 3 \
        --data-root /tmp/clusters
    python -m ceph_tpu_torch.tools.cephadm ls --data-root /tmp/clusters
    python -m ceph_tpu_torch.tools.cephadm stop --name c1 --data-root ...
    python -m ceph_tpu_torch.tools.cephadm rm-cluster --name c1 --data-root ...

``bootstrap`` waits for the daemon host to publish its mon quorum (the
addr file), then records {name, pid, mons, osds, data} — the registry
``ls`` reports with per-cluster liveness (pid probe), like ``cephadm ls``
reports daemon state.  ``rm-cluster`` stops the daemons and deletes the
cluster's data, the reference's destructive teardown (guarded by the same
--force acknowledgement).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional


def _spec_path(root: str, name: str) -> str:
    return os.path.join(root, name, "cluster.json")


def _load_spec(root: str, name: str) -> Optional[Dict]:
    try:
        with open(_spec_path(root, name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        # reap if it is OUR child (the CLI that bootstrapped may still be
        # the parent): a zombie answers kill(pid, 0) but is not alive
        os.waitpid(pid, os.WNOHANG)
    except (ChildProcessError, PermissionError):
        pass
    try:
        os.kill(pid, 0)
    except (ProcessLookupError, PermissionError):
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            if f.read().split(")")[-1].split()[0] == "Z":
                return False  # zombie: dead, awaiting reap elsewhere
    except OSError:
        pass
    return True


def bootstrap(args) -> int:
    cdir = os.path.join(args.data_root, args.name)
    if _load_spec(args.data_root, args.name) is not None:
        print(f"cluster {args.name!r} already exists", file=sys.stderr)
        return 1
    os.makedirs(cdir, exist_ok=True)
    addr_file = os.path.join(cdir, "mons.json")
    try:
        os.unlink(addr_file)  # a stale file from a failed bootstrap
    except FileNotFoundError:
        pass
    log_path = os.path.join(cdir, "daemon.log")
    cmd = [sys.executable, "-m", "ceph_tpu_torch.rados.vstart",
           "--osds", str(args.osds), "--mons", str(args.mons),
           "--data-dir", os.path.join(cdir, "data"),
           "--addr-file", addr_file,
           "--control-file", os.path.join(cdir, "orch_spec.json")]
    if args.mgr:
        cmd.append("--mgr")
    cmd += ["--device", args.device]
    # detached daemon host (start_new_session: survives this CLI's exit,
    # the reference's systemd-unit role in miniature)
    with open(log_path, "ab") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=log,
                                start_new_session=True,
                                cwd=os.path.dirname(os.path.dirname(
                                    os.path.dirname(
                                        os.path.abspath(__file__)))))
    deadline = time.monotonic() + args.timeout
    info = None
    while time.monotonic() < deadline:
        try:
            with open(addr_file) as f:
                info = json.load(f)
            break
        except (OSError, ValueError):
            if proc.poll() is not None:
                print(f"daemon host exited rc={proc.returncode}; "
                      f"see {log_path}", file=sys.stderr)
                return 1
            time.sleep(0.2)
    if info is None:
        # the clean-shutdown path (SIGINT -> cluster.stop()), with the
        # same kill fallback and a reap so no zombie outlives the CLI
        try:
            proc.send_signal(signal.SIGINT)
            proc.wait(timeout=10)
        except (subprocess.TimeoutExpired, ProcessLookupError):
            proc.kill()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
        print(f"bootstrap timed out after {args.timeout}s", file=sys.stderr)
        return 1
    spec = {"name": args.name, "pid": proc.pid,
            "mons": info["mons"], "osds": args.osds,
            "data": cdir, "created": time.time()}
    with open(_spec_path(args.data_root, args.name), "w") as f:
        json.dump(spec, f)
    mon = info["mons"][0]
    print(f"cluster {args.name!r} up: mon {mon[0]}:{mon[1]}, "
          f"{args.osds} osds (pid {proc.pid})")
    print(f"  ceph: python -m ceph_tpu_torch.tools.ceph --mon "
          f"{mon[0]}:{mon[1]} status")
    return 0


def ls(args) -> int:
    rows: List[Dict] = []
    if os.path.isdir(args.data_root):
        for name in sorted(os.listdir(args.data_root)):
            spec = _load_spec(args.data_root, name)
            if spec is None:
                continue
            spec["state"] = ("running" if _alive(spec.get("pid", -1))
                             else "stopped")
            rows.append(spec)
    if args.format == "json":
        print(json.dumps(rows))
    else:
        for s in rows:
            mon = s["mons"][0] if s.get("mons") else ("?", 0)
            print(f"{s['name']:<16} {s['state']:<8} pid {s['pid']:<8} "
                  f"mon {mon[0]}:{mon[1]} osds {s['osds']}")
    return 0


def _stop_daemons(spec: Dict, grace: float = 10.0) -> None:
    pid = spec.get("pid", -1)
    if pid > 0 and _alive(pid):
        os.kill(pid, signal.SIGINT)  # vstart's clean-shutdown path
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline and _alive(pid):
            time.sleep(0.1)
        if _alive(pid):
            os.kill(pid, signal.SIGKILL)


def stop(args) -> int:
    spec = _load_spec(args.data_root, args.name)
    if spec is None:
        print(f"no cluster {args.name!r}", file=sys.stderr)
        return 1
    _stop_daemons(spec)
    spec["pid"] = -1
    with open(_spec_path(args.data_root, args.name), "w") as f:
        json.dump(spec, f)
    print(f"cluster {args.name!r} stopped (data retained)")
    return 0


def rm_cluster(args) -> int:
    spec = _load_spec(args.data_root, args.name)
    if spec is None:
        print(f"no cluster {args.name!r}", file=sys.stderr)
        return 1
    if not args.force:
        print("rm-cluster deletes the cluster's DATA; re-run with "
              "--force to confirm", file=sys.stderr)
        return 1
    _stop_daemons(spec)
    shutil.rmtree(os.path.join(args.data_root, args.name),
                  ignore_errors=True)
    print(f"cluster {args.name!r} removed")
    return 0


def orch_apply(args) -> int:
    """`ceph orch apply osd` role: write the service spec; the daemon
    host's reconciliation loop converges the live daemon set to it."""
    if args.osds < 1:
        # the reconcile loop never drains below one OSD (a clusterless
        # cluster is rm-cluster's job) — reject rather than publish a
        # spec that can never converge
        print("--osds must be >= 1", file=sys.stderr)
        return 1
    spec = _load_spec(args.data_root, args.name)
    if spec is None:
        print(f"no cluster {args.name!r}", file=sys.stderr)
        return 1
    cdir = os.path.join(args.data_root, args.name)
    control = os.path.join(cdir, "orch_spec.json")
    tmp = control + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"target_osds": args.osds}, f)
    os.replace(tmp, control)
    print(f"scheduled: {args.name} -> {args.osds} osds "
          f"(daemon host converges within its poll interval)")
    return 0


def orch_ps(args) -> int:
    """`ceph orch ps` role: live per-daemon table — registry liveness
    for the host process plus the mon's osd up/in states."""
    spec = _load_spec(args.data_root, args.name)
    if spec is None:
        print(f"no cluster {args.name!r}", file=sys.stderr)
        return 1
    # re-read the addr file: reconciliation republishes osd counts
    addr_file = os.path.join(args.data_root, args.name, "mons.json")
    try:
        with open(addr_file) as f:
            info = json.load(f)
    except (OSError, ValueError):
        info = {"mons": spec["mons"], "osds": spec["osds"]}
    rows: List[Dict] = [{"daemon": "host", "id": spec["name"],
                         "status": "running" if _alive(spec["pid"])
                         else "stopped", "pid": spec["pid"]}]
    import asyncio as _asyncio

    async def probe():
        from ceph_tpu_torch.rados.client import RadosClient

        mon = info["mons"][0]
        c = RadosClient((mon[0], int(mon[1])))
        await c.start()
        try:
            await c.refresh_map()
            for osd_id in sorted(c.osdmap.osds):
                st = c.osdmap.osds[osd_id]
                rows.append({
                    "daemon": "osd", "id": osd_id,
                    "status": "running" if st.up else "stopped",
                    "addr": f"{st.addr[0]}:{st.addr[1]}" if st.addr
                    else ""})
            for rank, mon_addr in enumerate(info["mons"]):
                rows.append({"daemon": "mon", "id": rank,
                             "status": "running",
                             "addr": f"{mon_addr[0]}:{mon_addr[1]}"})
        finally:
            await c.stop()

    try:
        _asyncio.run(probe())
    except Exception as e:
        rows.append({"daemon": "mon", "id": "?",
                     "status": f"unreachable ({type(e).__name__})"})
    if args.format == "json":
        print(json.dumps(rows, indent=2))
    else:
        for r in rows:
            print(f"{r['daemon']:>5}.{r['id']:<8} {r['status']:<10} "
                  f"{r.get('addr', '')}")
    return 0


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="cluster deploy tool")
    p.add_argument("--data-root", default="./ceph-clusters",
                   help="registry directory holding one subdir per cluster")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("bootstrap")
    b.add_argument("--name", required=True)
    b.add_argument("--osds", type=int, default=3)
    b.add_argument("--mons", type=int, default=1)
    b.add_argument("--mgr", action="store_true")
    b.add_argument("--timeout", type=float, default=120.0)
    b.add_argument("--device", default="cuda",
                   help="device the OSDs' codecs run on: cuda, cuda:N "
                        "or cpu")

    l = sub.add_parser("ls")
    l.add_argument("--format", choices=("plain", "json"), default="plain")

    s = sub.add_parser("stop")
    s.add_argument("--name", required=True)

    r = sub.add_parser("rm-cluster")
    r.add_argument("--name", required=True)
    r.add_argument("--force", action="store_true")

    oa = sub.add_parser("orch-apply",
                        help="converge a cluster's OSD count to a spec")
    oa.add_argument("--name", required=True)
    oa.add_argument("--osds", type=int, required=True)

    op = sub.add_parser("orch-ps",
                        help="live per-daemon status table")
    op.add_argument("--name", required=True)
    op.add_argument("--format", choices=("plain", "json"),
                    default="plain")

    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    return {"bootstrap": bootstrap, "ls": ls, "stop": stop,
            "rm-cluster": rm_cluster, "orch-apply": orch_apply,
            "orch-ps": orch_ps}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
