# Copy of ceph_tpu/mgr/daemon.py at commit 484e351, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Mgr daemon: perf aggregation + prometheus exporter + crash registry.

Role-equivalent of the reference's ceph-mgr (reference src/mgr/,
src/pybind/mgr/prometheus, src/pybind/mgr/crash): daemons push MMgrReport
(perf counter dumps + status) on their heartbeat cadence; the mgr keeps the
latest report per daemon and serves:

- ``/metrics`` — prometheus text format over HTTP (the prometheus module),
  with per-daemon labels, counters, longrunavg sum/count pairs, and
  HISTOGRAM-kind counters as cumulative ``_bucket{le="..."}``/``_sum``/
  ``_count`` series (power-of-2 upper bounds, trailing empty run elided);
- crash reports — daemons post crash dumps (the ceph-crash agent +
  mgr/crash module flow), listed/inspected via mgr commands.

Daemons discover the mgr through the centralized config key ``mgr_addr``
(set by whoever starts the mgr — vstart does), the role the mgrmap plays
in the reference.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Any, Dict, List, Optional, Tuple

from ceph_tpu_torch.common.context import Context
from ceph_tpu_torch.common.perf_counters import PerfCountersCollection
from ceph_tpu_torch.rados.clog import LogClient
from ceph_tpu_torch.rados.messenger import Messenger, message
from ceph_tpu_torch.rados.monclient import MonTargets
from ceph_tpu_torch.rados.types import (  # noqa: F401 — re-export (old import site)
    MCommand,
    MCommandReply,
    MCrashReport,
    MLogAck,
)


@message(50)
class MMgrReport:
    """Daemon -> mgr perf/status push (reference MMgrReport.h)."""

    name: str = ""
    perf: Dict = None
    status: Dict = None
    stamp: float = 0.0


class MgrDaemon:
    def __init__(self, conf: Optional[dict] = None, mon_addrs=None):
        self.conf = conf or {}
        self.messenger = Messenger("mgr", self.conf, entity_type="mgr")
        # observability bundle (CephContext role): config proxy + local
        # log + admin socket, like every other daemon
        self.ctx = Context("mgr", conf if isinstance(conf, dict) else None)
        self.messenger.log = self.ctx.log
        # cluster-log client: mgr module failures and lifecycle events
        # land in the mon's cluster log, not just local stderr
        self.clog: Optional[LogClient] = (
            LogClient(self.messenger, MonTargets(mon_addrs), "mgr",
                      self.conf, local_log=self.ctx.log)
            if mon_addrs else None)
        self.reports: Dict[str, MMgrReport] = {}
        self.crashes: Dict[str, Dict] = {}
        self.addr: Optional[Tuple[str, int]] = None
        self._http: Optional[asyncio.AbstractServer] = None
        self.http_addr: Optional[Tuple[str, int]] = None
        # active modules (reference mgr/balancer + mgr/pg_autoscaler):
        # enabled when the mgr knows the mons and conf turns them on
        self.mon_addrs = mon_addrs
        self._modules_task: Optional[asyncio.Task] = None
        self._health_task: Optional[asyncio.Task] = None
        # the mon's latest aggregated health document (polled when
        # mon_addrs is known): /metrics renders it as
        # ceph_health_status + per-check ceph_health_check series.
        # _health_stamp gates staleness: a mon outage must surface as
        # HEALTH_ERR/MON_UNREACHABLE, never as the last-known OK frozen
        # in the exporter
        self.latest_health: Dict = {}
        self._health_stamp = 0.0
        self.balancer_rounds = 0
        self.autoscaler_changes = 0
        # the mgr's OWN perf sets, rendered into /metrics under
        # daemon="mgr" — the module client's `objecter` + `wire` sets
        # land here, so client-side resilience telemetry (resends,
        # backoffs, paused ops) is scrapeable like any daemon set
        self.extra_perf = PerfCountersCollection()

    async def start(self) -> Tuple[str, int]:
        self.messenger.dispatcher = self._dispatch
        self.addr = await self.messenger.bind()
        self._http = await asyncio.start_server(self._serve_http,
                                                "127.0.0.1", 0)
        self.http_addr = self._http.sockets[0].getsockname()[:2]
        if self.mon_addrs and (self.conf.get("mgr_balancer", False)
                               or self.conf.get("mgr_pg_autoscaler", False)):
            self._modules_task = asyncio.get_running_loop().create_task(
                self._run_modules())
        if self.mon_addrs:
            self._health_task = asyncio.get_running_loop().create_task(
                self._poll_health())
        if self.clog is not None:
            self.clog.start()
            self.clog.info("mgr daemon started")
        asok_dir = self.conf.get("admin_socket_dir")
        if asok_dir:
            await self.ctx.asok.start(f"{asok_dir}/mgr.asok")
        return self.addr

    async def stop(self) -> None:
        if self.clog is not None:
            await self.clog.stop()
        await self.ctx.shutdown()
        if self._modules_task:
            self._modules_task.cancel()
        if self._health_task:
            self._health_task.cancel()
        if self._http:
            self._http.close()
            try:
                await asyncio.wait_for(self._http.wait_closed(), timeout=1)
            except asyncio.TimeoutError:
                pass
        await self.messenger.shutdown()

    async def _run_modules(self) -> None:
        """Periodic active-module tick: read the map, compute proposals,
        apply them through mon commands."""
        from ceph_tpu_torch.mgr.modules import Balancer, PgAutoscaler
        from ceph_tpu_torch.rados.client import RadosClient
        from ceph_tpu_torch.rados.types import ALL_NSPACES, MPoolSet, MSetUpmap

        interval = float(self.conf.get("mgr_module_interval", 5.0))
        balancer = Balancer()
        scaler = PgAutoscaler(
            target_objects_per_pg=int(
                self.conf.get("mgr_target_objects_per_pg", 32)))
        client = RadosClient(self.mon_addrs, self.conf)
        await client.start()
        self.extra_perf.add(client.perf)
        self.extra_perf.add(client.messenger.perf)
        try:
            while True:
                await asyncio.sleep(interval)
                try:
                    osdmap = await client.refresh_map()
                    if self.conf.get("mgr_balancer", False):
                        for pool_id, pg, seats in balancer.compute(osdmap):
                            await client._mon_rpc(MSetUpmap(
                                pool_id=pool_id, pg=pg, acting=seats))
                            self.balancer_rounds += 1
                    if self.conf.get("mgr_pg_autoscaler", False):
                        for pool in list(osdmap.pools.values()):
                            try:
                                # pool-WIDE count: namespaced objects
                                # must size pg_num too
                                oids = await client.list_objects(
                                    pool.pool_id, nspace=ALL_NSPACES)
                            except Exception:
                                continue
                            want = scaler.compute(pool, len(oids))
                            if want is not None:
                                await client._mon_rpc(MPoolSet(
                                    pool_id=pool.pool_id, key="pg_num",
                                    value=str(want)))
                                self.autoscaler_changes += 1
                except asyncio.CancelledError:
                    raise
                except Exception:
                    continue  # mon unreachable this tick: try again
        finally:
            await client.stop()

    async def _poll_health(self) -> None:
        """Poll the mon's aggregated health (HealthMonitor answer) on
        the report cadence so /metrics carries cluster health alongside
        the per-daemon perf sets."""
        from ceph_tpu_torch.rados.client import RadosClient

        interval = float(self.conf.get("mgr_health_interval", 1.0) or 1.0)
        # start the staleness clock NOW: a mon that is down from mgr
        # startup must surface as MON_UNREACHABLE, not as an absent
        # health series no alert rule ever matches
        if not self._health_stamp:
            self._health_stamp = time.monotonic()
        # client bring-up retries too: a mon down AT MGR STARTUP must
        # not kill the poll task for good (the exporter would freeze on
        # MON_UNREACHABLE even after the mons recover)
        client = None
        try:
            while True:
                await asyncio.sleep(interval)
                try:
                    if client is None:
                        client = RadosClient(self.mon_addrs, self.conf)
                        await client.start()
                    self.latest_health = await client.get_health()
                    self._health_stamp = time.monotonic()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    if client is not None:
                        try:
                            await client.stop()
                        except Exception:
                            pass
                        client = None
                    continue  # unreachable: staleness gate handles it
        finally:
            if client is not None:
                await client.stop()

    _HEALTH_STATUS = {"HEALTH_OK": 0, "HEALTH_WARN": 1, "HEALTH_ERR": 2}

    async def _dispatch(self, conn, msg) -> None:
        if isinstance(msg, MMgrReport):
            self.reports[msg.name] = msg
        elif isinstance(msg, MCrashReport):
            # daemons report crashes to the MON (the authority behind
            # `ceph crash` and RECENT_CRASH); the mgr keeps accepting
            # directly posted reports for its /crash endpoints
            self.crashes[msg.crash_id] = {
                "name": msg.entity, "entity": msg.entity,
                "crash_id": msg.crash_id, "timestamp": msg.stamp,
                "exception": msg.exception, "backtrace": msg.backtrace}
        elif isinstance(msg, MLogAck):
            if self.clog is not None:
                self.clog.handle_ack(msg)
        elif isinstance(msg, MCommand):
            # `ceph tell mgr ...`: run the admin-socket command
            # in-process (same auth gate as the OSD/mon handlers)
            if self.conf.get("auth_cephx", False) and \
                    getattr(conn, "auth_kind", "none") == "none":
                reply = MCommandReply(tid=msg.tid, ok=False,
                                      error="EPERM: unauthenticated tell")
            else:
                try:
                    result = self.ctx.asok.execute(msg.prefix,
                                                   **(msg.args or {}))
                    reply = MCommandReply(tid=msg.tid, ok=True,
                                          result=result)
                except Exception as e:
                    reply = MCommandReply(tid=msg.tid, ok=False,
                                          error=f"{type(e).__name__}: {e}")
            try:
                await conn.send(reply)
            except (ConnectionError, OSError):
                pass

    # -- queries -------------------------------------------------------------

    def daemon_status(self) -> Dict[str, Any]:
        now = time.time()
        return {
            name: {"age": now - r.stamp, "status": r.status}
            for name, r in self.reports.items()
        }

    def crash_ls(self) -> List[str]:
        return sorted(self.crashes)

    def crash_info(self, crash_id: str) -> Optional[Dict]:
        return self.crashes.get(crash_id)

    # -- prometheus text format (mgr/prometheus role) ------------------------

    def cluster_status(self) -> Dict:
        """Aggregated cluster view from the daemons' pushed reports (the
        dashboard/REST role of reference src/pybind/mgr/dashboard in
        miniature): per-daemon freshness + headline counters."""
        now = time.time()
        daemons = {}
        for name, r in self.reports.items():
            # perf is {set_name: {counter: value}} (the collection dump)
            flat = {}
            for set_name, counters in (r.perf or {}).items():
                if not isinstance(counters, dict):
                    continue
                for k, v in counters.items():
                    if isinstance(v, (int, float)):
                        flat[f"{set_name}.{k}"] = v
            daemons[name] = {
                "stale_s": round(max(0.0, now - r.stamp), 1),
                "status": dict(r.status or {}),
                "perf": flat,
            }
        return {"daemons": daemons,
                "num_daemons": len(daemons),
                "crashes": len(self.crash_ls())}

    def dashboard_html(self) -> str:
        """Read-only status dashboard (reference mgr/dashboard role —
        the operator's one-glance page; mutations stay with the CLI)."""
        import html as _html

        st = self.cluster_status()
        # escape EVERYTHING daemon-supplied: reports arrive over the
        # cluster messenger, and a poisoned name/status must not become
        # stored XSS in the operator's browser
        rows = "".join(
            f"<tr><td>{_html.escape(str(name))}</td>"
            f"<td>{d['stale_s']}s</td>"
            f"<td>{_html.escape(json.dumps(d['status']))}</td></tr>"
            for name, d in sorted(st["daemons"].items()))
        return (
            "<!doctype html><html><head><title>ceph_tpu mgr</title>"
            "<style>body{font-family:monospace;margin:2em}"
            "table{border-collapse:collapse}"
            "td,th{border:1px solid #999;padding:4px 8px}</style></head>"
            f"<body><h1>ceph_tpu cluster</h1>"
            f"<p>{st['num_daemons']} reporting daemons, "
            f"{st['crashes']} crash reports</p>"
            f"<table><tr><th>daemon</th><th>report age</th>"
            f"<th>status</th></tr>{rows}</table>"
            "<p><a href=/metrics>prometheus metrics</a> | "
            "<a href=/status>status json</a> | "
            "<a href=/crash>crash reports</a></p></body></html>")

    def prometheus_text(self) -> str:
        lines: List[str] = []
        seen_help = set()

        def typed(metric: str, kind: str = "counter") -> None:
            if metric not in seen_help:
                lines.append(f"# TYPE {metric} {kind}")
                seen_help.add(metric)

        sources = [(name, report.perf or {})
                   for name, report in sorted(self.reports.items())]
        own = self.extra_perf.dump()
        if own:
            sources.append(("mgr", own))
        for name, perf_sets in sources:
            for set_name, counters in perf_sets.items():
                for cname, value in counters.items():
                    metric = f"ceph_{set_name}_{cname}"
                    if isinstance(value, dict) and "avgcount" in value:
                        for suffix, v in (("_sum", value["sum"]),
                                          ("_count", value["avgcount"])):
                            typed(metric + suffix)
                            lines.append(
                                f'{metric + suffix}{{daemon="{name}"}} {v}')
                    elif isinstance(value, dict) and "buckets" in value:
                        # HISTOGRAM kind (power-of-2 buckets: slot i holds
                        # observations with bit_length == i, i.e. values
                        # in [2^(i-1), 2^i - 1]) rendered cumulative: the
                        # le bound for slot i is its LARGEST member,
                        # 2^i - 1 (le="2^i" would exclude exact powers of
                        # two — the common case for batch sizes — from
                        # their own bucket, breaking the prometheus
                        # invariant that bucket{le=x} counts all obs <= x)
                        typed(metric, "histogram")
                        buckets = value["buckets"]
                        last = max((i for i, c in enumerate(buckets) if c),
                                   default=-1)
                        # the final slot is hinc's CLAMP (bit_length >=
                        # len-1 all land there): no finite le bound is
                        # true for it, so its counts surface via +Inf only
                        last = min(last, len(buckets) - 2)
                        cum = 0
                        for i in range(last + 1):
                            cum += buckets[i]
                            if not cum:
                                continue  # skip the leading empty run
                            lines.append(
                                f'{metric}_bucket{{daemon="{name}",'
                                f'le="{(1 << i) - 1}"}} {cum}')
                        lines.append(
                            f'{metric}_bucket{{daemon="{name}",'
                            f'le="+Inf"}} {value["count"]}')
                        # _sum/_count belong to the histogram family
                        # declared above: no separate TYPE lines
                        lines.append(
                            f'{metric}_sum{{daemon="{name}"}} '
                            f'{value["sum"]}')
                        lines.append(
                            f'{metric}_count{{daemon="{name}"}} '
                            f'{value["count"]}')
                    elif isinstance(value, (int, float)):
                        typed(metric)
                        lines.append(f'{metric}{{daemon="{name}"}} {value}')
        # cluster health (mon HealthMonitor aggregation): status gauge
        # (0 OK / 1 WARN / 2 ERR) + one series per raised check, so
        # SLOW_OPS & co. alert straight off the exporter.  A poll that
        # has not succeeded for several intervals means the MON is
        # unreachable — export THAT, not a frozen last-known HEALTH_OK.
        health = self.latest_health
        if self._health_stamp:
            interval = float(self.conf.get("mgr_health_interval", 1.0)
                             or 1.0)
            if time.monotonic() - self._health_stamp > 5 * interval:
                health = {"status": "HEALTH_ERR",
                          "checks": {"MON_UNREACHABLE": {
                              "severity": "error", "count": 1}}}
        if health:
            typed("ceph_health_status", "gauge")
            lines.append(f"ceph_health_status "
                         f"{self._HEALTH_STATUS.get(health.get('status'), 0)}")
            for name, c in sorted((health.get("checks") or {}).items()):
                typed("ceph_health_check", "gauge")
                sev = c.get("severity", "warning")
                lines.append(
                    f'ceph_health_check{{check="{name}",'
                    f'severity="{sev}"}} {int(c.get("count", 1) or 1)}')
            for name in sorted(health.get("muted") or {}):
                typed("ceph_health_check_muted", "gauge")
                lines.append(
                    f'ceph_health_check_muted{{check="{name}"}} 1')
            # per-OSD utilization + fullness state (the mon's aggregated
            # `osd df` view riding the health document): the capacity
            # plane's alerting surface — dashboards graph utilization,
            # alert rules match state != ""
            util = health.get("osd_utilization") or {}
            if util:
                typed("ceph_osd_utilization_ratio", "gauge")
                typed("ceph_osd_used_bytes", "gauge")
                typed("ceph_osd_total_bytes", "gauge")
                typed("ceph_osd_full_state", "gauge")
                state_code = {"": 0, "nearfull": 1, "backfillfull": 2,
                              "full": 3}
                for osd_id, row in sorted(util.items()):
                    st = row.get("state", "") or ""
                    lines.append(
                        f'ceph_osd_utilization_ratio{{osd="{osd_id}"}} '
                        f'{row.get("ratio", 0.0)}')
                    lines.append(f'ceph_osd_used_bytes{{osd="{osd_id}"}} '
                                 f'{row.get("used", 0)}')
                    lines.append(
                        f'ceph_osd_total_bytes{{osd="{osd_id}"}} '
                        f'{row.get("total", 0)}')
                    lines.append(
                        f'ceph_osd_full_state{{osd="{osd_id}",'
                        f'state="{st or "ok"}"}} '
                        f'{state_code.get(st, 0)}')
        lines.append(f"ceph_mgr_daemons_reporting {len(self.reports)}")
        return "\n".join(lines) + "\n"

    async def _serve_http(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        try:
            request = await reader.readline()
            while (await reader.readline()) not in (b"\r\n", b"\n", b""):
                pass
            path = request.decode().split(" ")[1] if b" " in request else "/"
            if path == "/metrics":
                body = self.prometheus_text().encode()
                status = "200 OK"
            elif path in ("/", "/dashboard"):
                body = self.dashboard_html().encode()
                status = "200 OK"
            elif path == "/status":
                body = json.dumps(self.cluster_status()).encode()
                status = "200 OK"
            elif path == "/crash":
                body = json.dumps(self.crash_ls()).encode()
                status = "200 OK"
            elif path.startswith("/crash/"):
                info = self.crash_info(path[len("/crash/"):])
                body = json.dumps(info).encode() if info else b"{}"
                status = "200 OK" if info else "404 Not Found"
            else:
                body, status = b"ceph_tpu mgr\n", "200 OK"
            writer.write(f"HTTP/1.1 {status}\r\nContent-Length: "
                         f"{len(body)}\r\n\r\n".encode() + body)
            await writer.drain()
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()


def crash_dump(exc: BaseException, name: str) -> Dict:
    """Legacy dict shape of a crash payload; the wire plane now uses
    clog.build_crash_report -> MCrashReport (fixed layout, spooled +
    mon-collected).  Kept for callers that want a JSON-ish record."""
    from ceph_tpu_torch.rados.clog import build_crash_report

    r = build_crash_report(exc, name)
    return {
        "crash_id": r.crash_id,
        "timestamp": r.stamp,
        "entity_name": r.entity,
        "exception": r.exception,
        "backtrace": r.backtrace.splitlines(keepends=True),
    }
