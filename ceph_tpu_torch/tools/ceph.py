# Copy of ceph_tpu/tools/ceph.py at commit 38c1795, with its ceph_tpu
# references rebound to ceph_tpu_torch.
"""The ``ceph`` status command (reference src/ceph.in): cluster-state
queries over the mon-distributed maps and the client's admin fan-outs.

    python -m ceph_tpu_torch.tools.ceph --mon HOST:PORT status
    python -m ceph_tpu_torch.tools.ceph --mon HOST:PORT health
    python -m ceph_tpu_torch.tools.ceph --mon HOST:PORT osd tree
    python -m ceph_tpu_torch.tools.ceph --mon HOST:PORT pg dump
    python -m ceph_tpu_torch.tools.ceph --mon HOST:PORT df

Everything derives from the same sources the reference CLI reads: the
OSDMap (epoch, OSD up/in states, pools, crush) fetched from the mon
quorum, per-PG acting sets computed client-side exactly as the data path
computes them (holes = degraded), and object counts via the paginated
per-PG listing fan-out (`pgls`, the scalable listing discipline).
``--format json`` emits machine-readable output; default is the
reference's human layout in miniature.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from typing import Dict, List


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ceph cluster status tool")
    p.add_argument("--mon", help="mon address host:port (not needed for "
                                 "`daemon ASOK CMD`)")
    p.add_argument("--format", choices=("plain", "json"), default="plain")
    p.add_argument("--yes-i-really-really-mean-it", action="store_true",
                   dest="confirm_destroy",
                   help="required acknowledgement for `osd pool rm`")
    p.add_argument("-w", "--watch", action="store_true",
                   help="subscribe to the cluster log and stream new "
                        "entries (the `ceph -w` follow mode)")
    p.add_argument("--watch-channel", default="",
                   help="-w: only this channel (cluster, audit, ...)")
    p.add_argument("--watch-level", default="",
                   help="-w: minimum priority (debug/info/warn/error)")
    p.add_argument("--run-for", type=float, default=0.0,
                   help="-w: stop after this many seconds (0 = forever)")
    p.add_argument("words", nargs="*",
                   help="status | health [detail] | "
                        "health mute CHECK [TTL] | health unmute CHECK | "
                        "log last [N] [LEVEL] [CHANNEL] | "
                        "crash ls | crash info ID | crash archive ID | "
                        "crash archive-all | crash prune KEEP_DAYS | "
                        "tell TARGET CMD [k=v...] | "
                        "df | osd df | osd tree | pg dump | "
                        "pg scrub PGID | pg repair PGID | "
                        "osd out ID... | osd in ID... | "
                        "osd reweight ID W | osd crush reweight osd.ID W | "
                        "osd crush add-bucket NAME TYPE [ROOT] | "
                        "osd crush add|set osd.N W [BUCKET] | "
                        "osd crush move NAME BUCKET | osd crush rm NAME | "
                        "osd safe-to-destroy ID... | osd ok-to-stop ID... | "
                        "osd purge ID | "
                        "osd set-nearfull-ratio R | "
                        "osd set-backfillfull-ratio R | "
                        "osd set-full-ratio R | "
                        "osd pool ls | osd pool create NAME [k=v...] | "
                        "osd pool set NAME KEY VALUE | "
                        "osd pool rm NAME NAME --yes-i-really-really-mean-it"
                        " | daemon ASOK_PATH CMD [k=v...]")
    args = p.parse_args(argv)
    if not args.words and not args.watch:
        p.error("a command (or -w) is required")
    return args


def render_op_queue(dump: Dict) -> List[str]:
    """Render a daemon's ``dump_op_queue`` answer (scheduler.py
    ShardedOpQueue.dump + the OSD's admission-tracker view): per-shard
    per-class/per-client depths and current dmClock tags, then the
    over-limit ranking the saturation shed uses.  Pure so tests can pin
    the layout."""
    lines = [f"{dump.get('scheduler', '?')}: depth {dump.get('depth', 0)}"
             f", {dump.get('qos_clients', 0)} client states"]

    def tag(v) -> str:
        return "-" if v is None else f"{v:+.3f}"

    for sh in dump.get("shards", []):
        lines.append(f"  shard {sh.get('shard')}: depth {sh.get('depth', 0)}"
                     f" (strict {sh.get('strict', 0)})")
        for kind in ("classes", "clients"):
            for name, c in sorted((sh.get(kind) or {}).items()):
                lines.append(
                    f"    {'client ' if kind == 'clients' else ''}"
                    f"{name:<24} depth {c['depth']:<4} "
                    f"r/w/l {c['reservation']:g}/{c['weight']:g}/"
                    f"{c['limit']:g}  tags r {tag(c['r_tag'])} "
                    f"p {tag(c['p_tag'])} l {tag(c['l_tag'])}")
    admission = dump.get("admission") or {}
    if admission:
        lines.append("  admission (over-limit ranking):")
        ranked = sorted(admission.items(),
                        key=lambda kv: -kv[1].get("excess_s", 0.0))
        for name, st in ranked[:16]:
            lines.append(f"    {name:<24} limit {st.get('limit', 0):g}  "
                         f"excess {st.get('excess_s', 0.0):+.3f}s  "
                         f"idle {st.get('idle_s', 0.0):.1f}s")
        if len(ranked) > 16:
            lines.append(f"    ... {len(ranked) - 16} more clients")
    return lines


def render_reactors(dump: Dict) -> List[str]:
    """Render a daemon's ``dump_reactors`` answer (messenger
    dump_reactors: reactor worker shards, per-peer lane groups, and
    colocated rings).  Pure so tests can pin the layout."""
    mode = dump.get("reactor_mode", "thread")
    lines = [f"wire plane: {dump.get('op_threads', 0)} reactor workers "
             f"({mode} mode), "
             f"{dump.get('lanes_per_peer', 1)} lanes/peer, colocated ring "
             f"{'on' if dump.get('colocated_ring') else 'off'}"]
    workers = dump.get("workers") or []
    if workers:
        lines.append("  reactors:")
        for w in workers:
            if w.get("mode") == "process":
                # process-sharded worker: pid + the shm counter block
                lines.append(
                    f"    worker {w.get('id')} pid {w.get('pid')} "
                    f"{'up' if w.get('alive') else 'DEAD'}: conns "
                    f"{w.get('conns', 0)} (accepted "
                    f"{w.get('accepted', 0)}), rx_frames "
                    f"{w.get('rx_frames', 0)}, tx {w.get('tx_bytes', 0)}B"
                    + (f", respawns {w.get('respawns')}"
                       if w.get("respawns") else ""))
                continue
            lines.append(
                f"    worker {w.get('id')}: sockets {w.get('sockets', 0)} "
                f"(accepted {w.get('accepted', 0)}, dialed "
                f"{w.get('dialed', 0)})  rx_msgs {w.get('rx_msgs', 0)}")
    for peer in dump.get("peers") or []:
        host, port = (peer.get("peer") or ["?", 0])[:2]
        lines.append(
            f"  peer {host}:{port} group {peer.get('group', '')[:8]} "
            f"({'out' if peer.get('outbound') else 'in'}): "
            f"{peer.get('n_lanes', 0)} lanes, tx_gseq "
            f"{peer.get('tx_gseq', 0)}, rx parked {peer.get('rx_parked', 0)}"
            f", reassembling {peer.get('reassembling', 0)}")
        for ln in peer.get("lanes") or []:
            if ln.get("state") == "absent":
                lines.append(f"    lane {ln.get('lane')}: absent")
                continue
            role = "ctl " if ln.get("control") else "data"
            reactor = ln.get("reactor")
            shm = ln.get("shm")
            lines.append(
                f"    lane {ln.get('lane')} [{role}] {ln.get('state')}: "
                f"outbox {ln.get('outbox_frames', 0)}f/"
                f"{ln.get('outbox_bytes', 0)}B  unacked "
                f"{ln.get('unacked', 0)}  seq {ln.get('out_seq', 0)}/"
                f"{ln.get('in_seq', 0)}"
                + (f"  reactor {reactor}" if reactor is not None else "")
                + (f"  shm worker pid {shm.get('worker_pid')} ring "
                   f"tx {shm.get('tx_ring_fill', 0)}B/"
                   f"rx {shm.get('rx_ring_fill', 0)}B"
                   if shm else ""))
    for ring in dump.get("rings") or []:
        host, port = (ring.get("peer") or ["?", 0])[:2]
        lines.append(f"  ring {host}:{port} ({ring.get('peer_name', '')}): "
                     f"depth rx {ring.get('rx_depth', 0)} / tx "
                     f"{ring.get('tx_depth', 0)}"
                     + (" closed" if ring.get("closed") else ""))
    return lines


def render_log_dump(entries: List[Dict]) -> List[str]:
    """Render an asok ``log dump`` / ``log dump_recent`` answer (the
    daemon's in-memory ring incl. pinned errors).  Pure so tests can pin
    the layout."""
    out = []
    for e in entries:
        out.append(f"{e.get('stamp', 0.0):.6f} {e.get('level', 0):3d} "
                   f"{e.get('subsys', '?')}: {e.get('message', '')}")
    return out


def render_crash_info(info: Dict) -> List[str]:
    """Render `ceph crash info` (reference layout in miniature): the
    report header, the backtrace, then the captured dump_recent ring."""
    import time as _time

    lines = [
        f"crash_id: {info.get('crash_id', '')}",
        f"entity:   {info.get('entity', '')}",
        f"stamp:    "
        f"{_time.strftime('%Y-%m-%dT%H:%M:%S', _time.localtime(info.get('stamp', 0.0)))}",
        f"version:  {info.get('version', '')}",
        f"archived: {bool(info.get('archived'))}",
        f"exception: {info.get('exception', '')}",
        "backtrace:",
    ]
    for ln in str(info.get("backtrace", "")).splitlines():
        lines.append(f"    {ln}")
    recent = info.get("recent") or []
    lines.append(f"recent events ({len(recent)}):")
    for e in recent:
        lines.append(f"    {e.get('stamp', 0.0):.6f} "
                     f"{e.get('level', 0):3d} {e.get('subsys', '?')}: "
                     f"{e.get('message', '')}")
    return lines


def render_tier_status(status: Dict) -> List[str]:
    """Render an asok ``tier status`` answer: residency totals, page
    occupancy, dirty bytes, and per-pool cache_mode.  Pure so tests can
    pin the layout."""
    lines = [
        f"tier: {'enabled' if status.get('enabled') else 'disabled'}"
        f" residency={'on' if status.get('device_residency') else 'off'}",
        f"  resident: {status.get('resident_entries', 0)} entries / "
        f"{status.get('resident_bytes', 0)} B (memo "
        f"{status.get('memo_bytes', 0)} B) target "
        f"{status.get('target_max_bytes', 0)} B "
        f"full_ratio {status.get('cache_target_full_ratio', 0)} "
        f"dirty_ratio {status.get('cache_target_dirty_ratio', 0)}",
    ]
    modes = status.get("cache_mode") or {}
    if modes:
        lines.append("  cache_mode: " + "  ".join(
            f"{pool}={mode}" for pool, mode in sorted(modes.items())))
    ps = status.get("pagestore")
    if ps:
        lines.append(
            f"  pages: {ps.get('pages_used', 0)}/{ps.get('pages_total', 0)}"
            f" x {ps.get('page_bytes', 0)} B  dirty "
            f"{ps.get('dirty_pages', 0)}p/{ps.get('dirty_bytes', 0)}B "
            f"({ps.get('dirty_entries', 0)} entries)  partial "
            f"{ps.get('partial_residents', 0)}  frag_saved "
            f"{ps.get('frag_saved_bytes', 0)}B")
    else:
        lines.append("  pages: (monolithic resident store)")
    lines.append(f"  hit_set_archives: "
                 f"{status.get('hit_set_archives', 0)}")
    return lines


# admin-command renderers, shared by `ceph daemon ASOK CMD` and
# `ceph tell TARGET CMD` (same command surface, two transports)
ASOK_RENDERERS = {"dump_op_queue": render_op_queue,
                  "dump_reactors": render_reactors,
                  "log dump": render_log_dump,
                  "log dump_recent": render_log_dump,
                  "tier status": render_tier_status}


def print_asok_result(prefix: str, result, fmt: str) -> None:
    renderer = ASOK_RENDERERS.get(prefix)
    if fmt == "json" or renderer is None:
        print(json.dumps(result, indent=1, default=repr))
    else:
        for line in renderer(result):
            print(line)


def _pg_states(osdmap) -> List[Dict]:
    """Per-PG rows derived from the map: acting set, primary, state
    (active+clean, or degraded when acting has holes) — the map-derived
    half of the reference's `pg dump` (per-OSD runtime stats live behind
    each daemon's admin socket)."""
    from ceph_tpu_torch.rados.crush import CRUSH_ITEM_NONE

    rows = []
    for pool in osdmap.pools.values():
        for pg in range(pool.pg_num):
            acting = osdmap.pg_to_acting(pool, pg)
            holes = sum(1 for a in acting if a == CRUSH_ITEM_NONE)
            live = [a for a in acting if a != CRUSH_ITEM_NONE]
            primary = osdmap.primary_of(
                acting, seed=(pool.pool_id << 20) | pg) if live else -1
            if holes == 0:
                state = "active+clean"
            elif len(live) >= pool.min_size:
                state = "active+degraded"
            else:
                state = "incomplete"
            rows.append({"pgid": f"{pool.pool_id}.{pg:x}", "state": state,
                         "acting": acting, "primary": primary})
    return rows


def render_health(health: Dict, detail: bool = False) -> List[str]:
    """Render the mon's aggregated health document (the server-side
    HealthMonitor answer — map-derived checks PLUS daemon-reported
    SLOW_OPS / BREAKER_OPEN / TIER_OVER_TARGET, mutes applied) in the
    reference `ceph health [detail]` layout.  Pure so tests can pin the
    rendering of every check type."""
    lines = [health.get("status", "HEALTH_OK")]
    for name, c in sorted((health.get("checks") or {}).items()):
        sev = c.get("severity", "warning").upper()
        lines.append(f"  [{'ERR' if sev == 'ERROR' else 'WRN'}] {name}: "
                     f"{c.get('summary', '')}")
        if detail:
            for d in c.get("detail") or []:
                lines.append(f"      {d}")
    muted = health.get("muted") or {}
    for name, c in sorted(muted.items()):
        extra = (f" (expires in {c['expires_in']:g}s)"
                 if c.get("expires_in") else "")
        lines.append(f"  (muted) {name}: {c.get('summary', '')}{extra}")
    return lines


def render_osd_df(rows: List[Dict], osdmap=None) -> List[str]:
    """Render `ceph osd df` from the mon's aggregated utilization view
    (client.osd_df rows): crush WEIGHT and the 0..1 REWEIGHT overlay
    (the `osd out/in/reweight` plane), size/use/avail, %USE, and the
    fullness STATE with nearfull/backfillfull/FULL highlighting.  Pure
    so tests can pin the layout."""
    lines = [f"{'ID':<4} {'STATUS':<7} {'WEIGHT':>7} {'REWEIGHT':>8} "
             f"{'SIZE':>12} {'USE':>12} {'AVAIL':>12} {'%USE':>7} "
             f"{'OBJECTS':>8}  STATE"]
    total_bytes = used_bytes = 0
    for r in rows:
        status = "up" if r.get("up", True) else "down"
        if r.get("error"):
            status = "error"
        if not r.get("in", True):
            status += "/out"
        total = int(r.get("total", 0) or 0)
        used = int(r.get("used", 0) or 0)
        if total:  # TOTAL %USE only over capacity-bearing OSDs
            total_bytes += total
            used_bytes += used
        pct = f"{100.0 * used / total:6.2f}%" if total else "      -"
        state = r.get("state", "") or "-"
        if state == "full":
            state = "FULL"  # the one that blocks writes stands out
        # WEIGHT = crush weight; REWEIGHT = the 0..1 overlay (rows from
        # a pre-r18 mon carry only the historic "weight" = overlay)
        reweight = float(r.get("reweight", r.get("weight", 1.0)))
        crush_w = float(r.get("crush_weight", 1.0))
        lines.append(
            f"{r.get('id', '?'):<4} {status:<7} "
            f"{crush_w:>7.4f} {reweight:>8.4f} {total:>12} "
            f"{used:>12} {int(r.get('avail', 0) or 0):>12} {pct:>7} "
            f"{int(r.get('num_objects', 0) or 0):>8}  {state}")
    if total_bytes:
        pct = f"{100.0 * used_bytes / total_bytes:6.2f}%"
        lines.append(f"TOTAL {'':<22} {total_bytes:>12} {used_bytes:>12} "
                     f"{max(0, total_bytes - used_bytes):>12} {pct:>7}")
    if osdmap is not None:
        nf, bf, fl = osdmap.fullness_ratios()
        lines.append(f"ratios: nearfull {nf:g}  backfillfull {bf:g}  "
                     f"full {fl:g}")
    return lines


def _osd_tree(osdmap) -> List[Dict]:
    """Flattened crush tree rows (reference `ceph osd tree` layout):
    buckets depth-first, devices with up/in status, crush WEIGHT and
    the 0..1 REWEIGHT overlay."""
    from ceph_tpu_torch.rados.types import osd_crush_weight

    crush = osdmap.crush
    rows: List[Dict] = []
    seen = set()

    def device_row(osd_id: int, depth: int) -> Dict:
        info = osdmap.osds.get(osd_id)
        return {
            "id": osd_id, "name": f"osd.{osd_id}", "type": "osd",
            "depth": depth,
            # WEIGHT = crush weight (the OsdInfo record is authoritative
            # — bucket weights reset on crush rebuilds); REWEIGHT = the
            # admin overlay
            "weight": osd_crush_weight(info) if info else 1.0,
            "reweight": info.weight if info else 1.0,
            "status": "up" if info and info.up else "down",
            "in": bool(info and info.in_cluster),
        }

    def subtree_weight(bid: int) -> float:
        # a bucket's placement weight IS its subtree sum (stored parent
        # edge weights are informational) — same rule the straw2 draw
        # applies via _effective_weight
        total = 0.0
        for d in crush.subtree_devices(bid):
            info = osdmap.osds.get(d)
            total += osd_crush_weight(info) if info \
                else crush.device_weights.get(d, 1.0)
        return total

    def walk(bid: int, depth: int) -> None:
        b = crush.buckets.get(bid)
        if b is None or bid in seen:
            return
        seen.add(bid)
        rows.append({"id": b.id, "name": b.name, "type": b.type,
                     "depth": depth, "weight": subtree_weight(bid)})
        for item in b.items:
            if item < 0:
                walk(item, depth + 1)
            else:
                rows.append(device_row(item, depth + 1))
    walk(crush.root_id, 0)
    # stray devices not in any bucket (flat maps place all under root)
    for osd_id in sorted(osdmap.osds):
        if not any(r.get("name") == f"osd.{osd_id}" for r in rows):
            rows.append(device_row(osd_id, 1))
    return rows


def render_osd_tree(rows: List[Dict]) -> List[str]:
    """Render `ceph osd tree` rows (_osd_tree): bucket lines, then
    device lines with WEIGHT / REWEIGHT / status and the (out) marker.
    Pure so tests can pin the layout."""
    lines = [f"{'ID':>4} {'WEIGHT':>8} {'REWEIGHT':>8}  NAME/STATUS"]
    for r in rows:
        pad = "  " * r.get("depth", 0)
        if r["type"] == "osd":
            lines.append(
                f"{r['id']:>4} {r.get('weight', 1.0):>8.4f} "
                f"{r.get('reweight', 1.0):>8.4f}  {pad}{r['name']:<12}"
                f"{r['status']}"
                f"{'' if r.get('in', True) else ' (out)'}")
        else:
            lines.append(f"{r['id']:>4} {r.get('weight', 0.0):>8.4f} "
                         f"{'':>8}  {pad}{r['type']} {r['name']}")
    return lines


def render_predicate_reply(reply) -> List[str]:
    """Render an MOsdPredicateReply (`osd safe-to-destroy` /
    `osd ok-to-stop`).  Pure so tests can pin the layout."""
    lines = [f"{reply.op}: {'SAFE' if reply.safe else 'NOT SAFE'} "
             f"({reply.pgs_checked} pgs checked)"]
    if reply.unsafe_ids:
        lines.append("  unsafe: "
                     + ", ".join(f"osd.{i}" for i in reply.unsafe_ids))
    for r in reply.reasons:
        lines.append(f"  - {r}")
    if getattr(reply, "dirty_blocked", 0):
        lines.append(f"  unflushed dirty objects at risk: "
                     f"{reply.dirty_blocked}")
        for k in getattr(reply, "dirty_keys", ()) or ():
            lines.append(f"    * {k}")
    return lines


async def _df(client) -> List[Dict]:
    from ceph_tpu_torch.rados.types import ALL_NSPACES

    rows = []
    for pool in client.osdmap.pools.values():
        # df is a pool-wide stat: include every namespace
        objects = await client.list_objects(pool.pool_id,
                                            nspace=ALL_NSPACES)
        rows.append({"pool": pool.name, "id": pool.pool_id,
                     "type": pool.pool_type, "objects": len(objects)})
    return rows


async def run(args) -> int:
    from ceph_tpu_torch.rados.client import RadosClient

    if args.words and args.words[0] == "daemon":
        # `ceph daemon ASOK CMD [k=v...]` role: one admin-socket command
        # against a running daemon — no mon needed
        if len(args.words) < 3:
            print("usage: daemon ASOK_PATH COMMAND [k=v...]",
                  file=sys.stderr)
            return 2
        from ceph_tpu_torch.common.admin_socket import asok_command

        path, prefix = args.words[1], " ".join(args.words[2:3])
        # multi-word asok prefixes ("perf dump", "tier status") and
        # k=v arguments after them
        rest = args.words[3:]
        while rest and "=" not in rest[0]:
            prefix += " " + rest.pop(0)
        kwargs = dict(kv.split("=", 1) for kv in rest)
        result = await asok_command(path, prefix, **kwargs)
        print_asok_result(prefix, result, args.format)
        return 0
    if not args.mon:
        print("--mon is required for cluster commands", file=sys.stderr)
        return 2
    host, port = args.mon.rsplit(":", 1)
    client = RadosClient((host, int(port)))
    await client.start()
    try:
        await client.refresh_map()
        m = client.osdmap
        cmd = " ".join(args.words)
        if args.watch:
            # `ceph -w`: print the retained tail, then follow the stream
            from ceph_tpu_torch.rados.clog import PRIO_BY_NAME

            level = PRIO_BY_NAME.get(args.watch_level.lower(), 0) \
                if args.watch_level else 0

            def _print(entry):
                print(entry.render(), flush=True)

            tail = await client.watch_cluster_log(
                _print, level=level, channel=args.watch_channel)
            for e in tail:
                print(e.render())
            try:
                if args.run_for > 0:
                    await asyncio.sleep(args.run_for)
                else:
                    while True:
                        await asyncio.sleep(3600)
            except (KeyboardInterrupt, asyncio.CancelledError):
                pass
            return 0
        if args.words[:2] == ["log", "last"]:
            from ceph_tpu_torch.rados.clog import PRIO_BY_NAME

            rest = args.words[2:]
            n = int(rest.pop(0)) if rest and rest[0].isdigit() else 0
            level = 0
            if rest and rest[0].lower() in PRIO_BY_NAME:
                level = PRIO_BY_NAME[rest.pop(0).lower()]
            channel = rest.pop(0) if rest else ""
            entries = await client.log_last(n=n, level=level,
                                            channel=channel)
            if args.format == "json":
                print(json.dumps([vars(e) for e in entries]))
            else:
                for e in entries:
                    print(e.render())
            return 0
        if args.words and args.words[0] == "crash":
            sub = args.words[1] if len(args.words) > 1 else "ls"
            if sub == "ls":
                rows = await client.crash_ls()
                if args.format == "json":
                    print(json.dumps(rows))
                else:
                    import time as _time

                    for r in rows:
                        ts = _time.strftime(
                            "%Y-%m-%dT%H:%M:%S",
                            _time.localtime(r.get("stamp", 0.0)))
                        print(f"{r['crash_id']:<44} {r['entity']:<10} "
                              f"{ts}"
                              + ("  (archived)" if r.get("archived")
                                 else ""))
                return 0
            if sub == "info" and len(args.words) == 3:
                info = await client.crash_info(args.words[2])
                if args.format == "json":
                    print(json.dumps(info, default=repr))
                else:
                    for line in render_crash_info(info):
                        print(line)
                return 0
            if sub == "archive" and len(args.words) == 3:
                await client.crash_archive(args.words[2])
                print(f"archived {args.words[2]}")
                return 0
            if sub == "archive-all":
                rows = await client.crash_archive()
                print(f"archived {len(rows)} crash reports")
                return 0
            if sub == "prune" and len(args.words) == 3:
                rows = await client.crash_prune(
                    float(args.words[2]) * 24 * 3600.0)
                print(f"{len(rows)} crash reports remain")
                return 0
            print("usage: crash ls | info ID | archive ID | archive-all"
                  " | prune KEEP_DAYS", file=sys.stderr)
            return 2
        if args.words and args.words[0] == "tell":
            # `ceph tell TARGET CMD [k=v...]`: remote asok command —
            # `tell osd.0 config set key=debug_ms value=10` is the
            # runtime-verbosity workflow
            if len(args.words) < 3:
                print("usage: tell TARGET COMMAND [k=v...]",
                      file=sys.stderr)
                return 2
            target, prefix = args.words[1], args.words[2]
            rest = args.words[3:]
            while rest and "=" not in rest[0]:
                prefix += " " + rest.pop(0)
            kwargs = dict(kv.split("=", 1) for kv in rest)
            result = await client.tell(target, prefix, **kwargs)
            print_asok_result(prefix, result, args.format)
            return 0
        pg_rows = _pg_states(m)
        if cmd == "status":
            # health comes from the MON's aggregation (HealthMonitor
            # role) — the authority that also sees daemon-reported
            # checks, not client-side osdmap math
            health = await client.get_health()
            up = sum(1 for o in m.osds.values() if o.up)
            inc = sum(1 for o in m.osds.values() if o.in_cluster)
            clean = sum(1 for r in pg_rows if r["state"] == "active+clean")
            out = {
                "health": health["status"],
                "checks": sorted(health.get("checks") or {}),
                "osdmap": {"epoch": m.epoch, "num_osds": len(m.osds),
                           "num_up_osds": up, "num_in_osds": inc},
                "pgmap": {"num_pgs": len(pg_rows),
                          "active_clean": clean},
                "pools": len(m.pools),
            }
            if args.format == "json":
                print(json.dumps(out))
            else:
                print(f"  health: {out['health']}")
                for line in render_health(health)[1:]:
                    print(f"  {line.strip()}")
                print(f"  osdmap: e{m.epoch}: {len(m.osds)} osds: "
                      f"{up} up, {inc} in")
                print(f"  pgmap: {len(pg_rows)} pgs, {clean} active+clean"
                      f", {len(m.pools)} pools")
            return 0
        if cmd in ("health", "health detail"):
            detail = cmd == "health detail"
            health = await client.get_health(detail=detail)
            if args.format == "json":
                print(json.dumps(health))
            else:
                for line in render_health(health, detail=detail):
                    print(line)
            return 0
        if args.words[:2] == ["health", "mute"] and len(args.words) >= 3:
            try:
                ttl = float(args.words[3]) if len(args.words) > 3 else 0.0
            except ValueError:
                print("usage: health mute CHECK [TTL_SECONDS]",
                      file=sys.stderr)
                return 2
            health = await client.health_mute(args.words[2], ttl=ttl)
            print(f"muted {args.words[2]}"
                  + (f" for {ttl:g}s" if ttl else ""))
            for line in render_health(health):
                print(line)
            return 0
        if args.words[:2] == ["health", "unmute"] and len(args.words) == 3:
            health = await client.health_mute(args.words[2], unmute=True)
            print(f"unmuted {args.words[2]}")
            for line in render_health(health):
                print(line)
            return 0
        if cmd == "osd tree":
            rows = _osd_tree(m)
            if args.format == "json":
                print(json.dumps(rows))
            else:
                for line in render_osd_tree(rows):
                    print(line)
            return 0
        if cmd == "pg dump":
            if args.format == "json":
                print(json.dumps(pg_rows))
            else:
                for r in pg_rows:
                    print(f"{r['pgid']:<10} {r['state']:<18} "
                          f"acting {r['acting']} primary {r['primary']}")
            return 0
        if cmd == "df":
            rows = await _df(client)
            if args.format == "json":
                print(json.dumps(rows))
            else:
                for r in rows:
                    print(f"{r['pool']:<20} id {r['id']:<4} "
                          f"{r['type']:<12} {r['objects']} objects")
            return 0
        if args.words[:3] == ["osd", "pool", "ls"]:
            rows = [{"id": p.pool_id, "name": p.name,
                     "type": p.pool_type, "pg_num": p.pg_num,
                     "size": p.size}
                    for p in sorted(m.pools.values(),
                                    key=lambda x: x.pool_id)]
            if args.format == "json":
                print(json.dumps(rows))
            else:
                for r in rows:
                    print(f"{r['id']:>3} {r['name']:<20} {r['type']:<11} "
                          f"pg_num {r['pg_num']} size {r['size']}")
            return 0
        if args.words[:3] == ["osd", "pool", "create"]:
            rest = args.words[3:]
            if not rest:
                print("usage: osd pool create NAME [replicated|k=v ...]",
                      file=sys.stderr)
                return 2
            name, params = rest[0], rest[1:]
            if params and params[0] == "replicated":
                extra = params[1:]
                pg_num = 8
                if extra and extra[0].isdigit():
                    pg_num = int(extra.pop(0))
                if extra:
                    print(f"unrecognized arguments: {extra}",
                          file=sys.stderr)
                    return 2
                pool_id = await client.create_pool(
                    name, pool_type="replicated", pg_num=pg_num)
            else:
                bad = [kv for kv in params if "=" not in kv]
                if bad:
                    # silently dropping tokens here could turn a typo'd
                    # `replicated` request into an EC pool
                    print(f"unrecognized arguments: {bad}",
                          file=sys.stderr)
                    return 2
                profile = dict(kv.split("=", 1) for kv in params)
                pool_id = await client.create_pool(
                    name, profile=profile or None)
            print(f"pool '{name}' created (id {pool_id})")
            return 0
        if args.words[:3] == ["osd", "pool", "set"]:
            rest = args.words[3:]
            if len(rest) != 3:
                print("usage: osd pool set NAME KEY VALUE",
                      file=sys.stderr)
                return 2
            name, key, value = rest
            pool = m.pool_by_name(name)
            if pool is None:
                print(f"no pool {name!r}", file=sys.stderr)
                return 2
            await client.pool_set(pool.pool_id, key, value)
            print(f"set pool {name} {key} = {value}")
            return 0
        if cmd == "osd df":
            # per-OSD utilization + fullness (reference `ceph osd df`):
            # ONE aggregated query against the mon (the view its
            # fullness derivation runs on) instead of N direct per-OSD
            # statfs ops; client.osd_df falls back to direct polling
            # when the mon is old
            util = await client.osd_df()
            rows = [{"id": osd_id, **r}
                    for osd_id, r in sorted(util.items())]
            if args.format == "json":
                print(json.dumps(rows))
            else:
                for line in render_osd_df(rows, m):
                    print(line)
            return 0
        if len(args.words) == 3 and args.words[0] == "osd" \
                and args.words[1] in ("set-nearfull-ratio",
                                      "set-backfillfull-ratio",
                                      "set-full-ratio"):
            which = args.words[1][len("set-"):-len("-ratio")]
            try:
                ratio = float(args.words[2])
            except ValueError:
                print(f"bad ratio {args.words[2]!r}", file=sys.stderr)
                return 2
            try:
                await client.osd_set_full_ratio(which, ratio)
            except Exception as e:
                print(f"Error: {e}", file=sys.stderr)
                return 1
            print(f"osd set-{which}-ratio {ratio:g}")
            return 0
        if args.words[:2] in (["osd", "out"], ["osd", "in"]) \
                and len(args.words) >= 3:
            # `ceph osd out/in ID [ID...]` — elastic membership
            verb = args.words[1]
            ids = []
            for raw in args.words[2:]:
                # validate the WHOLE list before mutating anything: a
                # typo mid-list must not leave the first ids draining
                try:
                    osd_id = int(raw.split(".")[-1])
                except ValueError:
                    print(f"bad osd id {raw!r}", file=sys.stderr)
                    return 2
                if osd_id not in m.osds:
                    print(f"no osd.{osd_id}", file=sys.stderr)
                    return 2
                ids.append(osd_id)
            for osd_id in ids:
                if verb == "out":
                    await client.osd_out(osd_id)
                else:
                    await client.osd_in(osd_id)
                print(f"marked {verb} osd.{osd_id}")
            return 0
        if args.words[:2] == ["osd", "reweight"] and len(args.words) == 4:
            try:
                osd_id = int(args.words[2].split(".")[-1])
                weight = float(args.words[3])
            except ValueError:
                print("usage: osd reweight ID WEIGHT(0..1)",
                      file=sys.stderr)
                return 2
            if osd_id not in m.osds or not (0.0 <= weight <= 1.0):
                print(f"need an existing osd id and weight in [0,1]",
                      file=sys.stderr)
                return 2
            await client.osd_reweight(osd_id, weight)
            print(f"reweighted osd.{osd_id} to {weight:g}")
            return 0
        if args.words[:3] == ["osd", "crush", "reweight"] \
                and len(args.words) == 5:
            try:
                osd_id = int(args.words[3].split(".")[-1])
                weight = float(args.words[4])
            except ValueError:
                print("usage: osd crush reweight osd.ID WEIGHT",
                      file=sys.stderr)
                return 2
            if osd_id not in m.osds or weight < 0:
                print("need an existing osd id and weight >= 0",
                      file=sys.stderr)
                return 2
            await client.osd_crush_reweight(osd_id, weight)
            print(f"crush reweighted osd.{osd_id} to {weight:g}")
            return 0
        if args.words[:2] == ["osd", "crush"] and len(args.words) >= 3 \
                and args.words[2] in ("add-bucket", "add", "set",
                                      "move", "rm"):
            # `ceph osd crush add-bucket NAME TYPE [ROOT]`
            # `ceph osd crush add|set osd.N WEIGHT [BUCKET]`
            # `ceph osd crush move NAME BUCKET`
            # `ceph osd crush rm NAME [--force via confirm flag]`
            op, rest = args.words[2], args.words[3:]
            kw = {}
            try:
                if op == "add-bucket":
                    if len(rest) not in (2, 3):
                        raise ValueError(
                            "usage: osd crush add-bucket NAME TYPE [ROOT]")
                    kw = dict(name=rest[0], bucket_type=rest[1],
                              dest=rest[2] if len(rest) == 3 else "")
                elif op in ("add", "set"):
                    if len(rest) not in (2, 3):
                        raise ValueError(
                            f"usage: osd crush {op} osd.N WEIGHT [BUCKET]")
                    kw = dict(name=rest[0], weight=float(rest[1]),
                              dest=rest[2] if len(rest) == 3 else "")
                elif op == "move":
                    if len(rest) != 2:
                        raise ValueError(
                            "usage: osd crush move NAME BUCKET")
                    kw = dict(name=rest[0], dest=rest[1])
                else:  # rm
                    if len(rest) != 1:
                        raise ValueError("usage: osd crush rm NAME")
                    kw = dict(name=rest[0],
                              force=bool(args.confirm_destroy))
            except ValueError as e:
                print(str(e), file=sys.stderr)
                return 2
            try:
                epoch = await client.osd_crush_op(op, **kw)
            except Exception as e:
                print(f"Error: {e}", file=sys.stderr)
                return 1
            print(f"crush {op} {kw['name']} done (epoch {epoch})")
            return 0
        if args.words[:2] in (["osd", "safe-to-destroy"],
                              ["osd", "ok-to-stop"]) \
                and len(args.words) >= 3:
            try:
                ids = [int(w.split(".")[-1]) for w in args.words[2:]]
            except ValueError:
                print(f"usage: osd {args.words[1]} ID [ID...]",
                      file=sys.stderr)
                return 2
            reply = await client.osd_predicate(args.words[1], ids)
            if args.format == "json":
                print(json.dumps({
                    "op": reply.op, "safe": reply.safe,
                    "unsafe_ids": reply.unsafe_ids,
                    "reasons": reply.reasons,
                    "pgs_checked": reply.pgs_checked,
                    "dirty_blocked": reply.dirty_blocked,
                    "dirty_keys": reply.dirty_keys}))
            else:
                for line in render_predicate_reply(reply):
                    print(line)
            return 0 if reply.safe else 1
        if args.words[:2] == ["osd", "purge"] and len(args.words) == 3:
            try:
                osd_id = int(args.words[2].split(".")[-1])
            except ValueError:
                print("usage: osd purge ID [--yes-i-really-really-"
                      "mean-it to force]", file=sys.stderr)
                return 2
            try:
                await client.osd_purge(osd_id,
                                       force=bool(args.confirm_destroy))
            except Exception as e:
                print(f"Error: {e}", file=sys.stderr)
                return 1
            print(f"purged osd.{osd_id}")
            return 0
        if args.words[:2] in (["pg", "scrub"], ["pg", "repair"]) \
                and len(args.words) == 3:
            # `ceph pg scrub/repair PGID` — MCommand tell at the primary
            try:
                if args.words[1] == "scrub":
                    result = await client.pg_scrub(args.words[2])
                else:
                    result = await client.pg_repair(args.words[2])
            except Exception as e:
                print(f"Error: {e}", file=sys.stderr)
                return 1
            if args.format == "json":
                print(json.dumps(result, default=repr))
            else:
                extra = ""
                if "verified_clean" in result:
                    extra = (", verified clean"
                             if result["verified_clean"]
                             else f", {result.get('errors_after_repair')}"
                                  f" errors REMAIN after repair")
                print(f"pg {result.get('pgid', args.words[2])} "
                      f"{args.words[1]}: "
                      f"{result.get('scrubbed', 0)} objects, "
                      f"{result.get('errors', 0)} errors, "
                      f"{result.get('repaired', 0)} repaired{extra}")
            return 0
        if args.words[:3] in (["osd", "pool", "mksnap"],
                              ["osd", "pool", "rmsnap"]):
            rest = args.words[3:]
            if len(rest) != 2:
                print(f"usage: osd pool {args.words[2]} POOL SNAP",
                      file=sys.stderr)
                return 2
            pool = m.pool_by_name(rest[0])
            if pool is None:
                print(f"no pool {rest[0]!r}", file=sys.stderr)
                return 2
            if args.words[2] == "mksnap":
                await client.pool_snap_create(pool.pool_id, rest[1])
                print(f"created pool {rest[0]} snap {rest[1]}")
            else:
                await client.pool_snap_remove(pool.pool_id, rest[1])
                print(f"removed pool {rest[0]} snap {rest[1]}")
            return 0
        if args.words[:3] == ["osd", "pool", "rm"]:
            rest = args.words[3:]
            confirmed = args.confirm_destroy
            if len(rest) != 2 or rest[0] != rest[1] or not confirmed:
                # reference guard: the name twice AND the flag
                print("Error EPERM: pool removal requires the pool name "
                      "TWICE plus --yes-i-really-really-mean-it",
                      file=sys.stderr)
                return 1
            pool = m.pool_by_name(rest[0])
            if pool is None:
                print(f"no pool {rest[0]!r}", file=sys.stderr)
                return 2
            await client.delete_pool(pool.pool_id, rest[0])
            print(f"pool '{rest[0]}' removed")
            return 0
        print(f"unknown command: {cmd}", file=sys.stderr)
        return 2
    finally:
        await client.stop()


def main(argv=None) -> int:
    return asyncio.run(run(parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
