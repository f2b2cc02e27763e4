# Copy of ceph_tpu/tools/traffic.py at commit 38c1795, with its ceph_tpu
# references rebound to ceph_tpu_torch.
"""Macro traffic harness: thousands of simulated tenants, zipfian object
popularity, mixed op phases.

The workload shape of a production EC cluster — "Understanding System
Characteristics of Online Erasure Coding on SSD Array Systems"
(PAPERS.md, arXiv:1709.05365) characterizes the mix this harness
reproduces: write-heavy ingest, read-heavy serving with a skewed
(zipfian) popularity curve, degraded reads under a downed OSD, and
client traffic concurrent with repair.  bench.py --macro and
tools/non_regression.py --qos drive it against an in-process cluster;
the per-tenant-class latency records it produces land in the BENCH
record next to wire_perf/objecter_perf/tier_perf.

Shape: thousands of simulated TENANTS ride a handful of client
PROCESSES (RadosClient instances) — each op is stamped with its tenant's
entity name (``client.<class>.<id>``, the MOSDOp v6 ``client`` field),
so the OSD's per-client dmClock QoS sees thousands of identities through
a few connections, exactly the production multiplexing shape.  Each
tenant class gets its OWN client process: an MOSDBackoff aimed at a
flooding class parks that class's connection, never its neighbors'.

Latency accounting is end-to-end client-side per (tenant class, op
kind), reduced by the same nearest-rank percentile_summary the optracker
path uses; OSD-side per-phase per-class percentiles come from the
tracker's ``cls:<name>|<phase>`` sample rings (tracked_op.py) and are
merged by the caller.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ceph_tpu_torch.common.tracked_op import percentile_summary


@dataclass
class TenantClass:
    """One declared tenant class driving load through one client
    process.

    ``tenants`` simulated identities share the class's QoS profile
    (pool opt ``qos_class:<name>``); ``workers`` concurrent op loops
    model the class's parallelism; ``rate`` > 0 paces the class's
    offered load to that many ops/sec total (0 = flat out — the
    flooding shape)."""

    name: str  # tenant class ("" = the pool's default client profile)
    client: object  # RadosClient carrying this class's connections
    tenants: int = 100
    workers: int = 4
    rate: float = 0.0  # offered ops/sec (0 = unpaced)
    write_frac: Optional[float] = None  # override the phase's mix


@dataclass
class PhaseStats:
    """Per-(class, op-kind) latency samples + failure counts for one
    phase run."""

    name: str
    seconds: float = 0.0
    samples: Dict[str, Dict[str, List[float]]] = field(default_factory=dict)
    failures: Dict[str, int] = field(default_factory=dict)
    ops: Dict[str, int] = field(default_factory=dict)

    def record(self, cls: str, kind: str, dt: float, ok: bool) -> None:
        key = cls or "default"
        self.ops[key] = self.ops.get(key, 0) + 1
        if ok:
            self.samples.setdefault(key, {}).setdefault(kind, []).append(dt)
        else:
            self.failures[key] = self.failures.get(key, 0) + 1

    def summary(self) -> Dict[str, Dict]:
        """{class: {op: {p50_us,p99_us,p999_us,count}, ops, failures,
        ops_per_sec}} — the per-tenant-class shape the BENCH record
        embeds."""
        out: Dict[str, Dict] = {}
        for cls in sorted(set(self.ops) | set(self.samples)):
            kinds = self.samples.get(cls, {})
            out[cls] = {k: percentile_summary(v) for k, v in kinds.items()}
            out[cls]["ops"] = self.ops.get(cls, 0)
            out[cls]["failures"] = self.failures.get(cls, 0)
            if self.seconds > 0:
                out[cls]["ops_per_sec"] = round(
                    self.ops.get(cls, 0) / self.seconds, 1)
        return out


def zipf_weights(n: int, s: float = 1.1) -> np.ndarray:
    """Rank-weighted zipfian popularity over n objects (rank r gets
    1/(r+1)^s), normalized."""
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), s)
    return w / w.sum()


class TrafficHarness:
    """Drive mixed-phase multi-tenant traffic at one pool.

    The object namespace is shared (``o0..o<n>``) with zipfian
    popularity — the skew that makes a handful of objects carry most of
    the read load.  ``preload()`` writes every object once so reads
    always resolve; writes rewrite an object's deterministic content, so
    any read can verify byte-identity against the expected blob
    (``verify=True``)."""

    def __init__(self, classes: Sequence[TenantClass], pool_id: int,
                 n_objects: int = 48, obj_size: int = 32 << 10,
                 zipf_s: float = 1.1, seed: int = 0,
                 verify: bool = False):
        self.classes = list(classes)
        self.pool_id = pool_id
        self.n_objects = int(n_objects)
        self.obj_size = int(obj_size)
        self.verify = verify
        self.seed = int(seed)
        self._rng = np.random.default_rng(seed)
        self._weights = zipf_weights(self.n_objects, zipf_s)
        blob_rng = np.random.default_rng(seed + 1)
        self.blobs = {
            f"o{i}": blob_rng.integers(
                0, 256, self.obj_size, dtype=np.uint8).tobytes()
            for i in range(self.n_objects)}
        # tenant identity pool per class: client.<class>.<i> (or the
        # plain client.t<i> default-profile shape for the "" class)
        self.tenant_names: Dict[str, List[str]] = {}
        for tc in self.classes:
            self.tenant_names[tc.name] = [
                f"client.{tc.name}.{i}" if tc.name else f"client.t{i}"
                for i in range(max(1, tc.tenants))]

    async def preload(self) -> None:
        """Write every object once (any client) so read phases resolve."""
        c = self.classes[0].client
        for oid, blob in self.blobs.items():
            await c.put(self.pool_id, oid, blob)

    def _pick_oid(self, rng: np.random.Generator) -> str:
        # draws ride the CALLER's generator: workers use their own
        # per-(class, worker) stream, so runs reproduce regardless of
        # task interleaving (the shared self._rng would not)
        return f"o{rng.choice(self.n_objects, p=self._weights)}"

    async def _worker(self, tc: TenantClass, write_frac: float,
                      deadline: float, stats: PhaseStats,
                      worker_idx: int) -> None:
        # deterministic per-(class, worker) stream: hash() is randomized
        # per process and would make runs irreproducible
        ci = self.classes.index(tc) if tc in self.classes else 0
        rng = np.random.default_rng(
            self.seed * 1_000_003 + ci * 1000 + worker_idx)
        names = self.tenant_names[tc.name]
        per_worker_rate = tc.rate / max(1, tc.workers) if tc.rate else 0.0
        next_t = time.monotonic()
        wf = tc.write_frac if tc.write_frac is not None else write_frac
        while time.monotonic() < deadline:
            if per_worker_rate:
                # paced class: hold the offered rate (sleep to the slot)
                next_t += 1.0 / per_worker_rate
                pause = next_t - time.monotonic()
                if pause > 0:
                    await asyncio.sleep(pause)
                    if time.monotonic() >= deadline:
                        return
            tenant = names[int(rng.integers(len(names)))]
            oid = self._pick_oid(rng)
            is_write = rng.random() < wf
            t0 = time.monotonic()
            ok = True
            try:
                if is_write:
                    await tc.client.put(self.pool_id, oid,
                                        self.blobs[oid], client=tenant)
                else:
                    got = await tc.client.get(self.pool_id, oid,
                                              client=tenant)
                    if self.verify and bytes(got) != self.blobs[oid]:
                        ok = False
            except Exception:
                ok = False
            stats.record(tc.name, "put" if is_write else "get",
                         time.monotonic() - t0, ok)

    async def run_phase(self, name: str, seconds: float,
                        write_frac: float,
                        classes: Optional[Sequence[TenantClass]] = None
                        ) -> PhaseStats:
        """One mixed phase: every class's workers drive ops until the
        deadline; returns the per-class latency/failure record.
        ``classes`` restricts the phase to a subset (the solo arm of the
        isolation experiment)."""
        stats = PhaseStats(name=name)
        deadline = time.monotonic() + seconds
        t0 = time.monotonic()
        tasks = []
        loop = asyncio.get_running_loop()
        for tc in (classes if classes is not None else self.classes):
            for w in range(max(1, tc.workers)):
                tasks.append(loop.create_task(
                    self._worker(tc, write_frac, deadline, stats, w)))
        await asyncio.gather(*tasks)
        stats.seconds = time.monotonic() - t0
        return stats


def merge_osd_class_phases(osds) -> Dict[str, Dict[str, Dict]]:
    """Reduce the OSDs' per-tenant-class optracker rings
    (``cls:<name>|<phase>`` keys, tracked_op.py) to
    {class: {phase: {p50_us,p99_us,p999_us,count}}} — the OSD-side half
    of the per-tenant-class BENCH record."""
    merged: Dict[str, Dict[str, List[float]]] = {}
    for o in osds:
        for key, samples in o.ctx.op_tracker.phase_samples().items():
            if not key.startswith("cls:"):
                continue
            cls, phase = key[4:].split("|", 1)
            merged.setdefault(cls, {}).setdefault(phase, []).extend(samples)
    return {cls: {ph: percentile_summary(ss) for ph, ss in phases.items()}
            for cls, phases in merged.items()}
