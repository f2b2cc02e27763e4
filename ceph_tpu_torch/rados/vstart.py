# Copy of ceph_tpu/rados/vstart.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.  Where the two differ: the
# command line takes ``--device`` (default ``cuda``; ``cpu`` must be named),
# the OSDs' ``osd_ec_device``, which OSDs added later inherit.
"""vstart: a whole cluster on loopback, in one event loop.

The reference's developer/test workflow (src/vstart.sh and
qa/standalone/ceph-helpers.sh): real daemon topology — one mon, N OSDs,
real messenger connections over 127.0.0.1 — sharing only hardware.  Used
in-process by the integration tests and runnable standalone:

    python -m ceph_tpu_torch.rados.vstart --osds 5   # on the card
    python -m ceph_tpu_torch.rados.vstart --osds 5 --device cpu
"""

from __future__ import annotations

import argparse
import asyncio
from typing import Dict, List, Optional

from ceph_tpu_torch.rados.bluestore import BlueStore
from ceph_tpu_torch.rados.client import RadosClient
from ceph_tpu_torch.rados.mon import Monitor
from ceph_tpu_torch.rados.osd import OSD
from ceph_tpu_torch.rados.store import MemStore


class Cluster:
    def __init__(self, n_osds: int = 5, conf: Optional[dict] = None,
                 data_dir: Optional[str] = None, n_mons: int = 1,
                 with_mgr: bool = False):
        self.conf = conf or {}
        # colocated-daemon fast dispatch (messenger LocalConnection):
        # every daemon of an in-process cluster shares this process, so
        # frames skip the TCP stack by default — UNLESS the conf
        # exercises the wire itself (auth/secure/fault injection), where
        # real sockets are the point of the test
        wire_keys = ("ms_auth_secret", "auth_cephx", "ms_secure_mode",
                     "ms_inject_socket_failures", "ms_inject_delay_max",
                     "ms_inject_dup_frames",
                     "ms_compress_min_size", "ms_dispatch_throttle_bytes")
        if "ms_local_fastpath" not in self.conf \
                and not any(self.conf.get(k) for k in wire_keys):
            self.conf["ms_local_fastpath"] = True
        # colocated ring transport (messenger/reactor negotiation): the
        # connect-time fallback for anything the fastpath's send-time
        # registry check misses.  Follows the SAME decision as the
        # fastpath: a conf that explicitly turned the fastpath off is
        # asking for the real wire (rx batching, sheds, traces over
        # TCP), so the ring must not silently replace it either.
        if "ms_colocated_ring" not in self.conf \
                and self.conf.get("ms_local_fastpath"):
            self.conf["ms_colocated_ring"] = True
        # crash telemetry: a disk-backed cluster gets a crash spool dir
        # by default (cephadm /var/lib/ceph/crash role) so daemon deaths
        # while the mon is down still leave collectable reports
        if data_dir and "crash_dir" not in self.conf:
            self.conf["crash_dir"] = f"{data_dir}/crash"
        self.n_osds = n_osds
        self.n_mons = n_mons
        self.with_mgr = with_mgr
        self.data_dir = data_dir
        self.mons: List[Monitor] = []
        self.mgr = None
        self.osds: Dict[int, OSD] = {}
        self._next_store = 0  # monotonic: store dirs never reused after kills

    @property
    def mon(self) -> Monitor:
        """First still-running mon (single-mon clusters: the mon)."""
        return self.mons[0]

    @property
    def mon_addrs(self) -> List:
        return [m.addr for m in self.mons if m.addr]

    @staticmethod
    def _free_ports(n: int) -> List[int]:
        import socket

        socks, ports = [], []
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
        for s in socks:
            s.close()
        return ports

    async def start(self) -> None:
        if self.n_mons == 1:
            mon = Monitor(self.conf,
                          data_path=(f"{self.data_dir}/mon.0/store.db"
                                     if self.data_dir else None))
            await mon.start()
            self.mons = [mon]
        else:
            monmap = [("127.0.0.1", p) for p in self._free_ports(self.n_mons)]
            self.mons = [
                Monitor(self.conf, rank=r, monmap=monmap,
                        data_path=(f"{self.data_dir}/mon.{r}/store.db"
                                   if self.data_dir else None))
                for r in range(self.n_mons)
            ]
            for mon in self.mons:
                await mon.start()
            await self.wait_for_quorum()
        if self.with_mgr:
            from ceph_tpu_torch.mgr.daemon import MgrDaemon

            self.mgr = MgrDaemon(self.conf, mon_addrs=self.mon_addrs)
            addr = await self.mgr.start()
            # daemons discover the mgr through config (mgrmap role)
            self.conf["mgr_addr"] = f"{addr[0]}:{addr[1]}"
        for i in range(self.n_osds):
            await self.add_osd()

    async def wait_for_quorum(self, timeout: float = 10.0) -> None:
        deadline = asyncio.get_running_loop().time() + timeout
        while asyncio.get_running_loop().time() < deadline:
            if any(m.is_leader for m in self.mons):
                return
            await asyncio.sleep(0.05)
        raise TimeoutError("mon quorum did not form")

    async def add_osd(self) -> OSD:
        # capacity seeding (the fullness plane's byte ceiling): BlueStore
        # reads osd_store_capacity_bytes from the conf itself; the RAM
        # store gets it passed explicitly.  0 = unlimited (default).
        capacity = int(self.conf.get("osd_store_capacity_bytes", 0) or 0)
        failsafe = float(self.conf.get("osd_failsafe_full_ratio", 0.97)
                         or 0.97)
        store = (
            BlueStore(f"{self.data_dir}/osd.{self._next_store}", self.conf)
            if self.data_dir
            else MemStore(capacity_bytes=capacity, failsafe_ratio=failsafe)
        )
        self._next_store += 1
        osd = OSD(self.mon_addrs, store=store, conf=self.conf)
        osd_id = await osd.start()
        self.osds[osd_id] = osd
        return osd

    async def kill_osd(self, osd_id: int) -> None:
        """Hard-stop an OSD (no goodbye) — the thrasher primitive."""
        osd = self.osds.pop(osd_id, None)
        if osd is not None:
            await osd.stop()

    async def kill_mon(self, rank: int) -> None:
        """Hard-stop a monitor and drop it from the cluster's view
        (leader-failover exercise)."""
        for m in list(self.mons):
            if m.rank == rank:
                await m.stop()
                self.mons.remove(m)

    async def client(self) -> RadosClient:
        c = RadosClient(self.mon_addrs, self.conf)
        await c.start()
        await c.refresh_map()
        return c

    async def stop(self) -> None:
        for osd in list(self.osds.values()):
            await osd.stop()
        if self.mgr is not None:
            await self.mgr.stop()
        for mon in self.mons:
            await mon.stop()


def _write_addr_file(path: str, cluster: Cluster, n_osds: int) -> None:
    """Machine-readable endpoint dump for the deploy tool (cephadm
    bootstrap polls this to learn the mon quorum; the orchestrator
    re-reads it after reconciliation)."""
    import json as _json
    import os as _os

    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        _json.dump({"mons": [list(a) for a in cluster.mon_addrs],
                    "osds": n_osds, "pid": _os.getpid()}, f)
    _os.replace(tmp, path)


async def _reconcile(cluster: Cluster, control_file: str,
                     addr_file: Optional[str]) -> None:
    """Orchestrator reconciliation (reference mgr/cephadm serve loop):
    converge the live daemon set to the spec in the control file —
    `cephadm orch apply` writes {"target_osds": N}, this loop adds or
    stops OSDs until reality matches, then republishes the addr file."""
    import json as _json

    try:
        with open(control_file) as f:
            spec = _json.load(f)
        target = int(spec.get("target_osds", -1))
    except (OSError, ValueError, TypeError):
        # unreadable or malformed spec must never take the daemon host
        # down — skip this cycle, the operator can rewrite the file
        return
    if target < 0:
        return
    changed = False
    while len(cluster.osds) < target:
        await cluster.add_osd()
        changed = True
    while len(cluster.osds) > max(target, 1):
        # scale-down drains the HIGHEST id first (deterministic,
        # mirrors `ceph orch apply osd` converging by removal)
        await cluster.kill_osd(max(cluster.osds))
        changed = True
    if changed and addr_file:
        _write_addr_file(addr_file, cluster, len(cluster.osds))


async def _main(args) -> None:
    cluster = Cluster(n_osds=args.osds, data_dir=args.data_dir,
                      n_mons=args.mons, with_mgr=args.mgr,
                      conf={"osd_ec_device": args.device})
    await cluster.start()
    print(f"mons at {cluster.mon_addrs}; {args.osds} OSDs up. "
          + ("Ctrl-C to stop." if args.run_for <= 0
             else f"Running {args.run_for}s."), flush=True)
    if args.addr_file:
        _write_addr_file(args.addr_file, cluster, args.osds)
    try:
        import time as _time

        deadline = (_time.monotonic() + args.run_for
                    if args.run_for > 0 else None)
        # only orchestrated hosts poll; a plain vstart idles at the old
        # long interval instead of waking every second for nothing
        interval = 1.0 if args.control_file else 3600.0
        while deadline is None or _time.monotonic() < deadline:
            nap = interval
            if deadline is not None:
                nap = min(nap, max(0.05, deadline - _time.monotonic()))
            await asyncio.sleep(nap)
            if args.control_file:
                await _reconcile(cluster, args.control_file,
                                 args.addr_file)
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        await cluster.stop()


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--osds", type=int, default=5)
    p.add_argument("--mons", type=int, default=1)
    p.add_argument("--data-dir", default=None)
    p.add_argument("--run-for", type=float, default=0.0,
                   help="seconds to run before clean shutdown (0 = forever)")
    p.add_argument("--mgr", action="store_true",
                   help="start a mgr daemon (balancer/autoscaler/metrics)")
    p.add_argument("--addr-file", default=None,
                   help="write the mon quorum addresses here once up")
    p.add_argument("--control-file", default=None,
                   help="poll this spec file and converge daemons to it "
                        "(orchestrator reconciliation)")
    p.add_argument("--device", default="cuda",
                   help="device the OSDs' codecs run on: cuda, cuda:N "
                        "or cpu")
    asyncio.run(_main(p.parse_args()))
