# Copy of ceph_tpu/rados/types.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Cluster map types and wire messages for the mini-RADOS slice.

OSDMap: the epoch-versioned cluster map every party computes placement from
(reference src/osd/OSDMap.{h,cc}): OSD states (up/in, address, weight),
pools (type, pg_num, EC profile), and the crush map.  Placement is
object -> PG (stable hash) -> acting set (crush indep with holes), as in
_pg_to_up_acting_osds (OSDMap.cc:2673).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ceph_tpu_torch.rados.crush import CRUSH_ITEM_NONE, CrushMap
from ceph_tpu_torch.rados.crush import _mix as _crush_mix
from ceph_tpu_torch.rados.messenger import BufferList, message


# -- snapshot naming ----------------------------------------------------------

# clone objects are named <head><SNAP_SEP><snapid>; the separator cannot
# appear in user oids (rejected at the client), so head-name recovery is
# unambiguous (reference: clones are the same hobject with a snap field)
SNAP_SEP = "\x00snap\x00"


def snap_clone_oid(oid: str, snapid: int) -> str:
    return f"{oid}{SNAP_SEP}{snapid:016d}"


def snap_head(oid: str) -> str:
    """The head object's name for any oid (identity for non-clones)."""
    i = oid.find(SNAP_SEP)
    return oid if i < 0 else oid[:i]


def is_snap_clone(oid: str) -> bool:
    return SNAP_SEP in oid


# fullness-state severity order (shared by the mon's derivation, the
# OSD's local lead, and the hysteresis demotion rule)
FULL_SEVERITY = {"": 0, "nearfull": 1, "backfillfull": 2, "full": 3}


def is_delete_only_multi(op: "MOSDOp") -> bool:
    """Is this compound op purely space-freeing (remove / rm-class
    sub-ops)?  Such multis ride the delete exemption through every
    fullness gate — client pause flags, the OSD's QoS shed, and the
    full check itself."""
    ops = getattr(op, "ops", None) or []
    return bool(ops) and all(
        name == "remove" or name.startswith("rm")
        or name.startswith("omap_rm")
        for name, _kw in ops)


# read-class multi sub-ops (asserts included: they observe state, they
# never add bytes) — a compound of ONLY these is a read for the
# fullness gate ("reads are untouched"); plain `call` stays gated like
# the reference's CEPH_OSD_OP_CALL WR classification (a class method's
# writes are invisible from the outside)
_READ_MULTI_OPS = frozenset({
    "read", "stat", "getxattr", "getxattrs",
    "assert_exists", "assert_version", "cmpxattr",
})


def is_read_only_multi(op: "MOSDOp") -> bool:
    """Is this compound op purely observational (read/stat/getxattr/
    assert sub-ops)?  Such multis must pass the fullness write gate —
    reads are untouched by full."""
    ops = getattr(op, "ops", None) or []
    return bool(ops) and all(
        name in _READ_MULTI_OPS or name.startswith("omap_get")
        for name, _kw in ops)


# -- rados namespaces ---------------------------------------------------------

# object identity is (nspace, name) (reference object_locator_t nspace,
# src/librados/IoCtxImpl.cc oloc plumbing): composed here into one wire
# name <nspace><NS_SEP><name> so the SAME string flows through placement
# hashing, OSD store keys, PG logs and scrub untouched — the namespace
# participates in the placement hash exactly like the reference's
# pg_pool_t::hash_key (ns + '\\037' + key).  The separator cannot appear
# in user oids or namespace names (rejected at the IoCtx boundary).
NS_SEP = "\x00ns\x00"

# listing sentinel (reference LIBRADOS_ALL_NSPACES): an IoCtx whose
# namespace is set to this lists every namespace; it is not a valid
# namespace for I/O
ALL_NSPACES = "\x01all\x01"


def make_oid(nspace: str, name: str) -> str:
    """Compose the wire object name for (nspace, name); the default
    namespace '' keeps bare names (and full wire compatibility with
    pre-namespace data)."""
    return f"{nspace}{NS_SEP}{name}" if nspace else name


def split_ns(oid: str) -> Tuple[str, str]:
    """(nspace, name) for any wire object name."""
    i = oid.find(NS_SEP)
    return ("", oid) if i < 0 else (oid[:i], oid[i + len(NS_SEP):])


class IntervalSet:
    """Sorted disjoint half-open [start, end) runs of snap ids (reference
    interval_set<snapid_t>, src/include/interval_set.h).  pg_pool_t ships
    removed_snaps inside EVERY OSDMap, so a long-lived pool that has
    removed many snapshots must coalesce — map size and membership tests
    scale with the number of RUNS, not the number of removed ids
    (contiguous removals, the common case, collapse to one run)."""

    __slots__ = ("_runs",)

    def __init__(self, ids=()):
        self._runs: List[List[int]] = []  # [[start, end), ...] sorted
        for i in ids:
            self.add(i)

    def add(self, snapid: int) -> None:
        runs = self._runs
        lo, hi = 0, len(runs)
        while lo < hi:  # bisect by run start
            mid = (lo + hi) // 2
            if runs[mid][0] <= snapid:
                lo = mid + 1
            else:
                hi = mid
        # runs[lo-1].start <= snapid < runs[lo].start
        if lo > 0 and snapid < runs[lo - 1][1]:
            return  # already present
        if lo > 0 and snapid == runs[lo - 1][1]:
            runs[lo - 1][1] += 1
            if lo < len(runs) and runs[lo][0] == runs[lo - 1][1]:
                runs[lo - 1][1] = runs[lo][1]
                del runs[lo]
            return
        if lo < len(runs) and snapid + 1 == runs[lo][0]:
            runs[lo][0] = snapid
            return
        runs.insert(lo, [snapid, snapid + 1])

    def __contains__(self, snapid: int) -> bool:
        runs = self._runs
        lo, hi = 0, len(runs)
        while lo < hi:
            mid = (lo + hi) // 2
            if runs[mid][0] <= snapid:
                lo = mid + 1
            else:
                hi = mid
        return lo > 0 and snapid < runs[lo - 1][1]

    def __iter__(self):
        for start, end in self._runs:
            yield from range(start, end)

    def __len__(self) -> int:
        return sum(end - start for start, end in self._runs)

    def num_intervals(self) -> int:
        return len(self._runs)

    def __bool__(self) -> bool:
        return bool(self._runs)

    def __eq__(self, other) -> bool:
        return (isinstance(other, IntervalSet)
                and self._runs == other._runs)

    def __repr__(self) -> str:
        return f"IntervalSet({self._runs!r})"

    # pickle support for a __slots__ class (OSDMap rides the messenger)
    def __getstate__(self):
        return self._runs

    def __setstate__(self, state):
        self._runs = state


@dataclass
class PoolInfo:
    pool_id: int
    name: str
    pool_type: str  # "ec" | "replicated"
    pg_num: int
    size: int  # k+m for ec, replica count otherwise
    min_size: int
    profile: Dict[str, str] = field(default_factory=dict)
    rule: str = ""
    stripe_width: int = 0
    # epoch the pool first appeared in the map (0 = unknown/pre-field):
    # an OSD whose map jumps from before this epoch to after it missed
    # the pool's whole lifetime so far — its PGs may carry history the
    # local logs never saw (the _on_map catch-up peering trigger)
    created_epoch: int = 0
    # self-managed snapshot state (reference pg_pool_t snap_seq /
    # removed_snaps, src/osd/osd_types.h): the mon allocates monotonically
    # increasing snap ids; removed ids are recorded (as coalesced
    # intervals, like the reference's interval_set) so lazy trimming and
    # snap-read resolution can skip them without bloating the map
    snap_seq: int = 0
    removed_snaps: IntervalSet = field(default_factory=IntervalSet)
    # pool-managed snapshots (reference pg_pool_t::snaps + the
    # POOL_SNAPS/SELFMANAGED_SNAPS mode latch, src/osd/osd_types.h
    # is_pool_snaps_mode/is_unmanaged_snaps_mode): a pool commits to ONE
    # snapshot discipline at first use — mon pool ops (mksnap/rmsnap)
    # or client-allocated self-managed ids — and mixing is a typed
    # -EINVAL, because the two disagree about who owns the SnapContext
    snap_mode: str = "none"  # none | pool | selfmanaged
    pool_snaps: Dict[str, int] = field(default_factory=dict)  # name -> id
    # per-pool store options (reference pool opts, pg_pool_t::opts:
    # compression_mode/algorithm ride the OSDMap so every OSD applies
    # them at its own ObjectStore blob boundary)
    opts: Dict[str, str] = field(default_factory=dict)

    def pool_snapc(self) -> Tuple[int, List[int]]:
        """The pool's SnapContext (seq, live snap ids DESCENDING) that
        every write to a pool-snaps-mode pool carries (reference
        IoCtxImpl picks the pool snapc when the ioctx has none)."""
        live = sorted((s for s in self.pool_snaps.values()
                       if s not in self.removed_snaps), reverse=True)
        return (self.snap_seq, live)


@dataclass
class OsdInfo:
    osd_id: int
    addr: Tuple[str, int]
    up: bool = True
    in_cluster: bool = True
    # the REWEIGHT overlay (reference osd_weight_t, `ceph osd reweight`):
    # a 0..1 multiplier on the crush weight; 0 behaves like out.  Admin
    # `osd out` drops in_cluster instead (weight is preserved for `in`).
    weight: float = 1.0
    # the CRUSH weight (reference `ceph osd crush reweight`, nominally
    # device capacity in TiB-ish units): the device's share of the straw2
    # draw.  Effective placement weight = crush_weight * weight.  Read
    # with osd_crush_weight() — pre-r18 pickles lack the attribute.
    crush_weight: float = 1.0


def osd_crush_weight(info: "OsdInfo") -> float:
    """Crush weight of an OsdInfo, tolerant of pre-crush_weight pickles
    (maps snapshotted by older builds restore without the attribute)."""
    return float(getattr(info, "crush_weight", 1.0))


@dataclass
class OSDMap:
    """Epoch-versioned cluster map (reference src/osd/OSDMap.{h,cc}):
    OSD states, pools, crush, plus pg_temp overrides (temporary acting sets
    installed during recovery, _pg_to_up_acting_osds OSDMap.cc:2673) and
    per-OSD primary affinity (probabilistic primary demotion)."""

    epoch: int = 0
    osds: Dict[int, OsdInfo] = field(default_factory=dict)
    pools: Dict[int, PoolInfo] = field(default_factory=dict)
    crush: CrushMap = field(default_factory=lambda: CrushMap.flat([]))
    # cluster-wide op gates (reference OSDMap flags CEPH_OSDMAP_PAUSEWR/
    # PAUSERD/FULL): clients QUEUE matching ops while a flag is set
    # instead of failing them (the Objecter's pauserd/pausewr handling).
    # Read with getattr(map, "flags", []) — maps pickled before this
    # field existed have no attribute.
    flags: List[str] = field(default_factory=list)
    # per-OSD fullness states derived by the mon from ping-piggybacked
    # statfs (reference OSDMap full/backfillfull/nearfull sets +
    # mon_osd_*_ratio in the map): osd_id -> "nearfull" | "backfillfull"
    # | "full".  Read via full_state()/fullness_ratios() — maps pickled
    # before these fields have no attributes.
    full_osds: Dict[int, str] = field(default_factory=dict)
    nearfull_ratio: float = 0.85
    backfillfull_ratio: float = 0.90
    full_ratio: float = 0.95
    pg_temp: Dict[Tuple[int, int], List[int]] = field(default_factory=dict)
    # persistent placement overrides installed by the balancer (reference
    # pg_upmap_items): applied over the crush result, NOT auto-cleared by
    # recovery (unlike pg_temp, which is a transient serving override)
    pg_upmap: Dict[Tuple[int, int], List[int]] = field(default_factory=dict)
    primary_affinity: Dict[int, float] = field(default_factory=dict)

    def pool_by_name(self, name: str) -> Optional[PoolInfo]:
        for p in self.pools.values():
            if p.name == name:
                return p
        return None

    def full_state(self, osd_id: int) -> str:
        """This OSD's mon-derived fullness state: "" | "nearfull" |
        "backfillfull" | "full" (getattr-safe for pre-fullness pickles)."""
        return (getattr(self, "full_osds", None) or {}).get(osd_id, "")

    def fullness_ratios(self) -> Tuple[float, float, float]:
        """(nearfull, backfillfull, full) thresholds, getattr-safe."""
        return (float(getattr(self, "nearfull_ratio", 0.85)),
                float(getattr(self, "backfillfull_ratio", 0.90)),
                float(getattr(self, "full_ratio", 0.95)))

    def state_for_ratio(self, ratio: float) -> str:
        """The fullness state a utilization ratio lands in under THIS
        map's thresholds — the ONE copy of the ladder cascade (the mon's
        derivation and the OSD's local lead both call it, so they can
        never disagree about where the lines are)."""
        nf, bf, fl = self.fullness_ratios()
        if ratio >= fl:
            return "full"
        if ratio >= bf:
            return "backfillfull"
        if ratio >= nf:
            return "nearfull"
        return ""

    def object_to_pg(self, pool: PoolInfo, oid: str) -> int:
        # snapshot clones hash by their HEAD name so every clone lives in
        # the head's PG (the reference keeps clones in the head's PG via
        # the ghobject snap field; co-location is what lets the primary
        # resolve snap reads and trim locally)
        h = hashlib.blake2s(snap_head(oid).encode(), digest_size=4).digest()
        return int.from_bytes(h, "little") % pool.pg_num

    def pg_to_placed(self, pool: PoolInfo, pg: int) -> List[int]:
        """The PG's intended placement: crush adjusted by pg_upmap (the
        up set before liveness filtering and pg_temp serving overrides)."""
        upmap = self.pg_upmap.get((pool.pool_id, pg))
        return list(upmap) if upmap is not None else self.pg_to_raw(pool, pg)

    def osd_effective_weights(self) -> Dict[int, float]:
        """The straw2 weight overlay placement runs on: per-OSD
        crush_weight x reweight, zero for out members (reference
        _pg_to_osds applying osd_weight over the crush map).  This is
        the ONE place the two weight planes compose, so `osd out`,
        `osd reweight` and `osd crush reweight` all move placement
        through the same minimal-movement straw2 draw."""
        return {
            o.osd_id: (osd_crush_weight(o) * o.weight
                       if o.in_cluster else 0.0)
            for o in self.osds.values()
        }

    def pg_to_raw(self, pool: PoolInfo, pg: int) -> List[int]:
        """CRUSH output before up/pg_temp filtering (_pg_to_raw_osds)."""
        x = (pool.pool_id << 20) | pg
        return self.crush.do_rule(pool.rule or "default-ec", x, pool.size,
                                  self.osd_effective_weights())

    def pg_to_acting(self, pool: PoolInfo, pg: int) -> List[int]:
        """Acting set for a PG: crush indep over in+weighted OSDs; up=false
        members become holes (EC positions are stable; holes stay holes).
        A pg_temp entry overrides the (upmap-adjusted) crush result
        wholesale (_pg_to_up_acting_osds applying pg_upmap then pg_temp,
        OSDMap.cc:2673)."""
        temp = self.pg_temp.get((pool.pool_id, pg))
        if temp is not None:
            acting = list(temp)
        else:
            upmap = self.pg_upmap.get((pool.pool_id, pg))
            acting = list(upmap) if upmap is not None \
                else self.pg_to_raw(pool, pg)
        return [
            a if a != CRUSH_ITEM_NONE and self.osds.get(a) and self.osds[a].up
            else CRUSH_ITEM_NONE
            for a in acting
        ]

    def primary_of(self, acting: List[int], seed: int = 0) -> Optional[int]:
        """First non-hole, demoted past low-affinity OSDs when a later
        candidate exists (primary-affinity semantics, OSDMap.cc
        _apply_primary_affinity).  `seed` is the PG id so affinity demotes
        a FRACTION of PGs, with a process-independent hash."""
        candidates = [a for a in acting if a != CRUSH_ITEM_NONE]
        if not candidates:
            return None
        for a in candidates:
            aff = self.primary_affinity.get(a, 1.0)
            if aff >= 1.0:
                return a
            draw = (_crush_mix(seed, a) & 0xFFFF) / 65536.0
            if draw < aff:
                return a
        return candidates[0]

    def addr_of(self, osd_id: int) -> Tuple[str, int]:
        return self.osds[osd_id].addr

    def apply_incremental(self, inc: "OSDMapIncremental") -> bool:
        """Apply a delta (reference OSDMap::Incremental): returns False if
        the delta doesn't chain onto our epoch (caller must fetch full)."""
        if inc.base_epoch != self.epoch:
            return False
        for osd_id, info in inc.new_osds.items():
            self.osds[osd_id] = info
        for osd_id, (up, in_cluster) in inc.osd_states.items():
            if osd_id in self.osds:
                self.osds[osd_id].up = up
                self.osds[osd_id].in_cluster = in_cluster
        for osd_id in getattr(inc, "removed_osds", None) or []:
            # `osd purge` removes the record entirely (not just a state
            # flip); subscribers applying the delta must drop it too
            self.osds.pop(osd_id, None)
        for pool_id, pool in inc.new_pools.items():
            self.pools[pool_id] = pool
        for pool_id in inc.removed_pools:
            self.pools.pop(pool_id, None)
        for key, acting in inc.new_pg_temp.items():
            if acting:
                self.pg_temp[key] = acting
            else:
                self.pg_temp.pop(key, None)
        for key, acting in getattr(inc, "new_pg_upmap", {}).items():
            if acting:
                self.pg_upmap[key] = acting
            else:
                self.pg_upmap.pop(key, None)
        for osd_id, aff in inc.new_primary_affinity.items():
            self.primary_affinity[osd_id] = aff
        if inc.crush is not None:
            self.crush = inc.crush
        new_flags = getattr(inc, "new_flags", None)
        if new_flags is not None:
            self.flags = list(new_flags)
        new_full = getattr(inc, "new_full_osds", None)
        if new_full is not None:
            self.full_osds = dict(new_full)
        new_ratios = getattr(inc, "new_full_ratios", None)
        if new_ratios is not None:
            (self.nearfull_ratio, self.backfillfull_ratio,
             self.full_ratio) = new_ratios
        self.epoch = inc.epoch
        return True


@dataclass
class OSDMapIncremental:
    """Delta between consecutive epochs (reference OSDMap::Incremental,
    OSDMap.h) — what the mon publishes to subscribers instead of full maps
    when the gap is small."""

    epoch: int = 0
    base_epoch: int = 0
    new_osds: Dict[int, OsdInfo] = field(default_factory=dict)
    osd_states: Dict[int, Tuple[bool, bool]] = field(default_factory=dict)
    removed_osds: List[int] = field(default_factory=list)  # `osd purge`
    new_pools: Dict[int, PoolInfo] = field(default_factory=dict)
    removed_pools: List[int] = field(default_factory=list)
    new_pg_temp: Dict[Tuple[int, int], List[int]] = field(default_factory=dict)
    new_pg_upmap: Dict[Tuple[int, int], List[int]] = field(default_factory=dict)
    new_primary_affinity: Dict[int, float] = field(default_factory=dict)
    crush: Optional[CrushMap] = None
    # None = flags unchanged; a list (possibly empty) replaces them
    new_flags: Optional[List[str]] = None
    # None = unchanged; a dict (possibly empty) / tuple replaces them
    new_full_osds: Optional[Dict[int, str]] = None
    new_full_ratios: Optional[Tuple[float, float, float]] = None

    @classmethod
    def diff(cls, old: "OSDMap", new: "OSDMap") -> "OSDMapIncremental":
        inc = cls(epoch=new.epoch, base_epoch=old.epoch)
        for osd_id, info in new.osds.items():
            if osd_id not in old.osds:
                inc.new_osds[osd_id] = info
            else:
                o = old.osds[osd_id]
                if (o.addr, o.weight, osd_crush_weight(o)) != (
                        info.addr, info.weight, osd_crush_weight(info)):
                    # addr/weight/crush-weight change (restart on a new
                    # port, `osd reweight`, `osd crush reweight`) ships
                    # the whole record — state-only deltas stay compact
                    inc.new_osds[osd_id] = info
                elif (o.up, o.in_cluster) != (info.up, info.in_cluster):
                    inc.osd_states[osd_id] = (info.up, info.in_cluster)
        inc.removed_osds = [o for o in old.osds if o not in new.osds]
        for pool_id, pool in new.pools.items():
            if pool_id not in old.pools or old.pools[pool_id] != pool:
                inc.new_pools[pool_id] = pool
        inc.removed_pools = [p for p in old.pools if p not in new.pools]
        for key, acting in new.pg_temp.items():
            if old.pg_temp.get(key) != acting:
                inc.new_pg_temp[key] = acting
        for key in old.pg_temp:
            if key not in new.pg_temp:
                inc.new_pg_temp[key] = []
        for key, acting in new.pg_upmap.items():
            if old.pg_upmap.get(key) != acting:
                inc.new_pg_upmap[key] = acting
        for key in old.pg_upmap:
            if key not in new.pg_upmap:
                inc.new_pg_upmap[key] = []
        if list(getattr(old, "flags", []) or []) \
                != list(getattr(new, "flags", []) or []):
            inc.new_flags = list(getattr(new, "flags", []) or [])
        if dict(getattr(old, "full_osds", None) or {}) \
                != dict(getattr(new, "full_osds", None) or {}):
            inc.new_full_osds = dict(getattr(new, "full_osds", None) or {})
        if old.fullness_ratios() != new.fullness_ratios():
            inc.new_full_ratios = new.fullness_ratios()
        for osd_id, aff in new.primary_affinity.items():
            if old.primary_affinity.get(osd_id) != aff:
                inc.new_primary_affinity[osd_id] = aff
        # full topology signature, not just the device/rule sets: a
        # bucket-only edit (`crush move` of a host, `crush add-bucket`)
        # changes placement and MUST ship, or incremental subscribers
        # would keep mapping with the old tree (sig() is the canonical
        # form; getattr guards maps pickled before it existed)
        old_sig = getattr(old.crush, "sig", None)
        new_sig = getattr(new.crush, "sig", None)
        if (old_sig is None or new_sig is None
                or old_sig() != new_sig()):
            inc.crush = new.crush
        return inc


# -- wire messages -----------------------------------------------------------
# Client <-> mon


@message(1)
class MGetMap:
    min_epoch: int = 0
    tid: str = ""


@message(2, version=3)
class MMapReply:
    # either a full map or a chain of incrementals from the requester's
    # epoch.  v3: the embedded OsdInfo records (full map and incremental
    # new_osds alike) grew a crush_weight tail — decoded getattr-safe via
    # osd_crush_weight(), with the pre-change layout replay-guarded by
    # corpus/wire/golden/MMapReply.v2_precrushweight.frame
    osdmap: OSDMap = None
    incrementals: List["OSDMapIncremental"] = field(default_factory=list)
    tid: str = ""


@message(3, version=2)
class MOsdBoot:
    osd_id: int = -1  # -1: allocate
    addr: Tuple[int, int] = (0, 0)
    tid: str = ""


@message(4, version=2)
class MBootReply:
    osd_id: int = 0
    osdmap: OSDMap = None
    tid: str = ""
    cluster_conf: Dict[str, str] = field(default_factory=dict)


@message(5)
class MCreatePool:
    tid: str = ""
    name: str = ""
    pool_type: str = "ec"
    pg_num: int = 8
    profile: Dict[str, str] = field(default_factory=dict)


@message(6)
class MCreatePoolReply:
    tid: str = ""
    ok: bool = True
    error: str = ""
    pool_id: int = -1


@message(64)
class MDeletePool:
    """`ceph osd pool rm` (reference OSDMonitor::prepare_pool_op
    delete): the mon drops the pool from the map; every OSD purges the
    pool's objects when it sees the pool gone (PG deletion role).
    Requires the double-confirmation name echo, like the reference's
    --yes-i-really-really-mean-it discipline."""

    tid: str = ""
    pool_id: int = -1
    confirm_name: str = ""  # must equal the pool's name


@message(7, version=5)
class MPing:
    osd_id: int = 0
    epoch: int = 0
    addr: Tuple[str, int] = ("", 0)  # for direct map pushes from the leader
    # daemon-observed health checks riding the liveness ping (the mon's
    # HealthMonitor feed, reference MMonHealthChecks): {check_name:
    # {"severity", "summary", "detail": [...], ...}}.  Empty = healthy;
    # the mon drops a check the next ping omits it (raise/clear follows
    # the ping cadence).  Read with getattr — v2 pickles lack the field.
    health: Dict[str, Dict] = field(default_factory=dict)
    # v4: store utilization piggybacked on the liveness ping (reference
    # osd_stat_t riding MOSDBeacon/pg stats): {total, used, avail,
    # num_objects}, total == 0 meaning no configured capacity.  The mon
    # derives per-OSD NEARFULL/BACKFILLFULL/FULL states from it.  Read
    # with getattr — v3 pickles lack the field (truncated-tail rule).
    statfs: Dict[str, int] = field(default_factory=dict)
    # v5: unflushed-dirt summary for the safe-to-destroy predicate —
    # [("pool_id:oid", [holder osd ids...]), ...] naming every raw dirty
    # copy this OSD pins (fast-ack CacheDirtyRecord adoptions AND local
    # writeback dirt, whose only durable copy is the dirty page set).
    # The mon refuses `osd safe-to-destroy` while the target holds the
    # LAST live copy of any entry.  Read with getattr — v4 pickles lack
    # the field (truncated-tail rule).
    cache_dirty: List[Tuple[str, List[int]]] = field(default_factory=list)


@message(8)
class MMarkDown:
    osd_id: int = 0
    tid: str = ""


@message(83)
class MOsdMembership:
    """Admin membership mutation (reference OSDMonitor `osd out` /
    `osd in` / `osd reweight` / `osd crush reweight`): audited,
    osdmap-replicated, answered with an MMapReply carrying the bumped
    map.  ``out`` drops in_cluster (weight preserved, the OSD stays up
    and drains through backfill); ``in`` restores it; ``reweight`` sets
    the 0..1 overlay; ``crush-reweight`` sets the straw2 crush weight.
    An admin ``out`` is sticky across reboots (the mon remembers it;
    a booting OSD is auto-marked in only when not admin-out)."""

    op: str = "out"  # out | in | reweight | crush-reweight | purge | purge-force
    osd_id: int = 0
    weight: float = 1.0  # reweight / crush-reweight operand
    tid: str = ""


@message(86, version=2)
class MCrushOp:
    """Runtime CRUSH topology mutation (reference OSDMonitor `osd crush
    add-bucket/add/set/move/rm`): audited, mon-validated, replicated
    through the osdmap — bucket-only edits ship via the incremental's
    crush-signature diff.  Operand meaning by op:

    - ``add-bucket``: create bucket `name` of `bucket_type`; attached
      under `dest` when given (else left detached until a `move`).
    - ``add`` / ``set``: place device `name` ("osd.N") under bucket
      `dest` with crush weight `weight` (`add` refuses an existing
      placement, `set` upserts — reference semantics).
    - ``move``: re-parent `name` (device or bucket) under `dest`;
      refused when it would create a cycle.
    - ``rm``: detach `name` from the hierarchy (buckets must be empty
      unless `force`)."""

    op: str = ""        # add-bucket | add | set | move | rm
    name: str = ""      # "osd.N" or a bucket name
    bucket_type: str = ""  # add-bucket operand (host/rack/...)
    dest: str = ""      # destination bucket name
    weight: float = 1.0
    tid: str = ""
    # v2 tail: `rm` of a non-empty bucket needs an explicit override
    # (decoders default a truncated v1 frame to False — append-only rule)
    force: bool = False


@message(87)
class MCrushOpReply:
    """Typed verdict for MCrushOp: ok + the epoch the edit landed in, or
    a validation error with the map untouched."""

    tid: str = ""
    ok: bool = True
    error: str = ""
    epoch: int = 0


@message(88)
class MOsdPredicate:
    """Data-safety predicate query (reference OSDMonitor `osd
    safe-to-destroy` / `osd ok-to-stop`): a READ served at any mon —
    computed from PG acting sets, min_size margins, and the unflushed
    dirty-copy roster riding MPing v5."""

    op: str = "safe-to-destroy"  # safe-to-destroy | ok-to-stop
    osd_ids: List[int] = field(default_factory=list)
    tid: str = ""


@message(89, version=2)
class MOsdPredicateReply:
    """Render-friendly predicate verdict: safe/unsafe plus the blocking
    reasons (capped), the per-osd unsafe subset, and the sweep size."""

    tid: str = ""
    op: str = ""
    safe: bool = False
    unsafe_ids: List[int] = field(default_factory=list)
    reasons: List[str] = field(default_factory=list)
    pgs_checked: int = 0
    # v2 tail: the cache-dirt clause (r22 fast-ack raised the stakes —
    # a v1 reply was map-only; truncated v1 frames default these)
    dirty_blocked: int = 0
    dirty_keys: List[str] = field(default_factory=list)


# OSD <-> OSD heartbeats + failure reports (reference MOSDPing.h,
# MOSDFailure.h; OSD::heartbeat OSD.cc:5837, handle_osd_ping :5417)


@message(17)
class MOSDPing:
    op: str = "ping"  # ping | reply
    from_osd: int = 0
    stamp: float = 0.0
    epoch: int = 0


@message(18)
class MOSDFailure:
    """OSD-observed peer failure reported to the mon (failure detection
    path that beats the mon's own laggard grace)."""

    target_osd: int = 0
    from_osd: int = 0
    failed_for: float = 0.0
    tid: str = ""


# Mon <-> mon (consensus; reference src/messages/MMonElection.h, MMonPaxos.h)


@message(10)
class MMonElection:
    op: str = "propose"  # propose | ack | victory
    epoch: int = 0
    rank: int = 0
    quorum: List[int] = field(default_factory=list)
    # candidate's connectivity score (reference ConnectionTracker.h:80 /
    # ElectionLogic CONNECTIVITY strategy): mean peer-reachability EMA in
    # [0,1]; -1 = not reported (rank-based fallback)
    score: float = -1.0


@message(11)
class MMonPaxos:
    rank: int = 0
    payload: Dict = field(default_factory=dict)  # op/version/value/...


@message(12, version=2)
class MForward:
    """Peon -> leader relay of a client request (reference MForward)."""

    tid: str = ""
    from_rank: int = 0
    inner: bytes = b""  # pickled client message
    # v2: the originating connection's peer identity, so the leader's
    # audit-channel entry names the actual requester, not the peon
    # (read with getattr — v1 pickles lack the field)
    who: str = ""


@message(13)
class MForwardReply:
    tid: str = ""
    inner: bytes = b""  # pickled reply message


# Centralized config (reference src/mon/ConfigMonitor.cc)


@message(14)
class MConfigSet:
    tid: str = ""
    key: str = ""
    value: str = ""
    remove: bool = False


@message(56)
class MAuthTicket:
    """Request a service ticket from the mon (reference CEPHX_GET_AUTH_
    SESSION_KEY): the requester's identity was proven by the mon-
    connection handshake; the reply carries the sealed ticket plus the
    session key for the requester's own use."""

    entity: str = ""
    entity_type: str = "client"
    tid: str = ""


@message(57)
class MAuthTicketReply:
    tid: str = ""
    ticket: str = ""  # hex blob, sealed under the rotating service secret
    session_key: str = ""  # hex
    # daemon-type tickets are refused to non-daemon-authenticated
    # connections (they would pass the rotating-key gate)
    denied: bool = False


@message(58)
class MAuthRotating:
    """OSD fetch of the rotating service secrets (reference
    CEPHX_GET_ROTATING_KEY) — only daemons holding the cluster bootstrap
    secret reach this handler (messenger handshake gates it)."""

    tid: str = ""


@message(59)
class MAuthRotatingReply:
    tid: str = ""
    keys: Dict[int, str] = field(default_factory=dict)
    # the connection's auth level does not entitle it to the rotating
    # secrets (ticket-authenticated client): distinct from an empty
    # keyring so the requester logs a refusal, not a mystery
    denied: bool = False


@message(60)
class MSetUpmap:
    """Balancer-installed placement override (reference pg-upmap): empty
    acting clears the entry.  A mon write op; replicated via the map."""

    pool_id: int = 0
    pg: int = 0
    acting: List[int] = field(default_factory=list)
    tid: str = ""


@message(66)
class MOSDSetFlag:
    """`ceph osd set/unset <flag>` role (reference OSDMonitor
    prepare_set_flag): toggle a cluster-wide op gate — "pausewr",
    "pauserd", "full" — in the OSDMap.  Clients QUEUE matching ops while
    a flag is set (Objecter pause handling) instead of failing them."""

    flag: str = ""
    set: bool = True
    tid: str = ""


@message(82)
class MSetFullRatio:
    """`ceph osd set-nearfull-ratio / set-backfillfull-ratio /
    set-full-ratio` (reference OSDMonitor prepare_command_impl
    "osd set-*full-ratio"): install a fullness threshold in the OSDMap.
    The mon validates the ORDERING (nearfull <= backfillfull <= full
    < the OSDs' failsafe) so a typo can never invert the ladder."""

    which: str = ""  # nearfull | backfillfull | full
    ratio: float = 0.0
    tid: str = ""


@message(61)
class MPoolSet:
    """Adjust a pool parameter (reference `ceph osd pool set`); the
    pg_autoscaler drives pg_num through this."""

    pool_id: int = 0
    key: str = ""
    value: str = ""
    tid: str = ""


@message(62)
class MSnapOp:
    """Self-managed snapshot id allocation / removal (reference
    IoCtxImpl::selfmanaged_snap_create/remove via the OSDMonitor): the
    mon is the allocator so ids are cluster-unique and monotonic."""

    pool_id: int = 0
    # create | remove: self-managed id allocation/retirement
    # mksnap | rmsnap: mon-managed POOL snapshots (reference
    #   OSDMonitor pool-op SNAP_CREATE/SNAP_RM handlers)
    op: str = "create"
    snap_id: int = 0  # for remove
    name: str = ""  # for mksnap/rmsnap
    tid: str = ""


@message(63)
class MSnapOpReply:
    tid: str = ""
    ok: bool = True
    error: str = ""
    # typed 0/-errno result (same discipline as MOSDOpReply.code): callers
    # distinguish definitive failures (-ENOENT no such pool, -EINVAL bad
    # snap id) from transient ones instead of matching on `error` text
    code: int = 0
    snap_id: int = 0  # the allocated id (create)


@message(15)
class MConfigGet:
    tid: str = ""
    key: str = ""  # empty: dump all


@message(16)
class MConfigReply:
    tid: str = ""
    ok: bool = True
    error: str = ""
    values: Dict[str, str] = field(default_factory=dict)


# Client <-> primary OSD


@message(20, version=7)
class MOSDOp:
    op: str = "read"  # write | read | delete | list | repair | deep-scrub | call | multi
    pool_id: int = 0
    oid: str = ""
    data: bytes = b""
    epoch: int = 0
    reqid: str = ""
    # offset >= 0: partial overwrite at that byte offset (RMW path,
    # reference ECBackend try_state_to_reads); -1: full-object write
    offset: int = -1
    # op == "call": in-OSD object class execution (reference src/cls/;
    # EC pools answer ENOTSUP, doc/dev/osd_internals/erasure_coding)
    cls: str = ""
    method: str = ""
    # self-managed snap context riding every write (reference SnapContext,
    # IoCtxImpl selfmanaged snap ops): seq = newest snap the writer knows,
    # snaps = existing snap ids DESCENDING.  The primary clones the head
    # before the first write past a new snap (make_writeable role).
    snapc_seq: int = 0
    snapc_snaps: List[int] = field(default_factory=list)
    # op == "read"/"stat": read AT this snap id (0 = head); resolution
    # walks the object's SnapSet clone list
    snap_read: int = 0
    # op == "snap-trim": the snap id being removed pool-wide
    snap_id: int = 0
    # op == "pgls": paginated per-PG listing (reference do_pgnls,
    # PrimaryLogPG.cc) — admin fan-outs scale with PGs, not cluster size
    pg: int = -1
    cursor: str = ""  # resume after this oid ("" = start)
    max_entries: int = 0  # 0 = server default
    # op == "pgls"/"list": namespace filter — "" = default namespace
    # only, ALL_NSPACES sentinel = every namespace (reference
    # object_locator_t nspace on the list op)
    nspace: str = ""
    # op == "multi": compound atomic operation — an ORDERED vector of
    # (name, kwargs) sub-ops executed on one object under the object's
    # critical section, all-or-nothing (reference MOSDOp's vector<OSDOp>
    # driving ObjectWriteOperation/neorados WriteOp semantics,
    # PrimaryLogPG::do_osd_ops).  Reads inside the vector observe the
    # effects of earlier sub-ops; any failing sub-op aborts the whole op
    # with nothing applied.
    ops: List[Tuple[str, Dict]] = field(default_factory=list)
    # cache-tier advice riding reads (reference librados
    # LIBRADOS_OP_FLAG_FADVISE_DONTNEED/_WILLNEED gating cache-tier
    # promotion, src/osd/PrimaryLogPG.cc maybe_promote): "" = default
    # policy (hit recording + recency-gated promotion), "dontneed" =
    # neither record nor promote (scan/backup traffic must not heat the
    # working set), "willneed" = promote on this read regardless of
    # recency (still promotion-throttled)
    fadvise: str = ""
    # distributed-trace propagation (reference: jaeger trace context on
    # MOSDOp, src/messages/MOSDOp.h otel trace riding the wire): the
    # client's trace id and its root span's id; the primary JOINS as a
    # child span, so client->primary->peer spans stitch into one tree.
    # Empty when ms_trace_propagation is off; v4 frames lack the fields
    # entirely (truncated-tail fixed decode leaves the defaults).
    trace_id: str = ""
    span_id: str = ""
    # v6: the sender's entity name (reference MOSDOp's osd_reqid_t
    # carries entity_name_t) — the identity the OSD's per-client dmClock
    # QoS keys on.  "client.<class>.<id>" names a tenant class (the
    # middle token selects a pool's qos_class:<name> profile override);
    # "" = anonymous (pre-v6 frames, admin fan-outs) rides the pool's
    # default client profile.
    client: str = ""
    # multi-lane striping order key (messenger LaneGroup): stamped by the
    # sender's lane group when this message stripes across data lanes;
    # the receiver reassembles dispatch order from it.  0 = not striped
    # (single-lane sessions, control lane, pre-lane frames — the
    # truncated-tail fixed decode defaults it).
    gseq: int = 0


@message(21, version=3)
class MOSDOpReply:
    ok: bool = True
    error: str = ""
    # typed result, reference 0/-errno contract (ErasureCodeInterface.h:155
    # and MOSDOpReply's result field): 0 on success, else a NEGATIVE errno.
    # The client classifies definitive / placement-moved / retryable by
    # code — the human-readable `error` string is never matched on.
    #   definitive  : -ENOENT -EOPNOTSUPP -EINVAL -EPERM -EBADMSG -ENXIO
    #   moved       : -ESTALE  (not primary: re-target past the reply epoch)
    #   retryable   : -EAGAIN  (degraded / below min_size / shards
    #                 transiently unavailable), -EIO and anything else
    code: int = 0
    data: bytes = b""
    oids: List[str] = field(default_factory=list)
    # pgls pagination: resume cursor ("" = listing exhausted)
    cursor: str = ""
    # MOSDBackoff role (reference src/messages/MOSDBackoff.h:20): a busy/
    # degraded PG tells the client how long to pause before the resend,
    # instead of eating a blind retry storm
    backoff: float = 0.0
    reqid: str = ""
    version: int = 0  # object version the data was read at
    # the replying OSD's map epoch: on a retryable error (not primary,
    # degraded) the client fetches AT LEAST this epoch before
    # re-targeting (the Objecter's epoch barrier, Objecter.cc:2764)
    map_epoch: int = 0
    gseq: int = 0  # lane striping order key (see MOSDOp.gseq)


@message(65, version=2)
class MOSDBackoff:
    """OSD -> client flow control for one PG (reference
    src/messages/MOSDBackoff.h, BACKOFF_OP_BLOCK/BACKOFF_OP_UNBLOCK): a
    PG that cannot serve an op right now (mid-peering below min_size, or
    a saturated dispatch queue) BLOCKS the client instead of eating a
    blind retry storm — the op is dropped server-side and the client
    parks everything targeting that PG until the matching unblock (or
    until ``duration`` expires, the liveness bound for a primary that
    dies holding blocks).  ``id`` names the block so a late unblock of a
    previous interval cannot release a newer block; ``epoch`` lets the
    client drop the backoff when a map change moves the primary."""

    op: str = "block"  # block | unblock
    pool_id: int = 0
    pg: int = 0
    id: str = ""
    epoch: int = 0
    # client-side park ceiling in seconds (0 = client default): the
    # resend-anyway bound when the unblock is lost
    duration: float = 0.0
    # trace propagation: the op whose arrival triggered this block, so
    # the park shows up inside the op's stitched trace
    trace_id: str = ""
    span_id: str = ""

    FIXED_FIELDS = [("op", "s"), ("pool_id", "q"), ("pg", "q"),
                    ("id", "s"), ("epoch", "q"), ("duration", "d"),
                    ("trace_id", "s"), ("span_id", "s")]


@message(67, version=2)
class MOSDPGHitSet:
    """Primary -> acting peers: one PG's encoded HitSetArchive, pushed
    at every hit-set rotation (reference: the primary PERSISTS HitSets
    as PG objects so hit history survives primary changes,
    PrimaryLogPG::hit_set_persist; here the archive rides the wire to
    the acting set instead).  A peer that later becomes primary seeds
    its temperature estimator from the freshest received archive, so a
    failover does not reset every object to cold.  ``archive`` is the
    HitSetArchive binary encoding (ceph_tpu/rados/tiering.py), whose
    layout the wire corpus pins alongside this message's."""

    pool_id: int = 0
    pg: int = 0
    from_osd: int = -1
    epoch: int = 0
    archive: bytes = b""
    # trace propagation: the rotation push is a tracked op on the
    # primary; peers join its span so tier replication traces stitch
    trace_id: str = ""
    span_id: str = ""

    FIXED_FIELDS = [("pool_id", "q"), ("pg", "q"), ("from_osd", "q"),
                    ("epoch", "q"), ("archive", "y"),
                    ("trace_id", "s"), ("span_id", "s")]


@message(68)
class MGetHealth:
    """Cluster health query (reference `ceph health [detail]` hitting
    the mon's HealthMonitor): forwarded to the LEADER (only it holds the
    daemons' pushed health reports) and answered with the aggregated
    check set — map-derived checks (OSD_DOWN, PG_DEGRADED, OSDMAP_FLAGS)
    plus daemon-reported ones (SLOW_OPS, BREAKER_OPEN,
    TIER_OVER_TARGET), with the mute lifecycle applied."""

    tid: str = ""
    detail: bool = False


@message(69)
class MHealthReply:
    tid: str = ""
    # {"status": HEALTH_OK|HEALTH_WARN|HEALTH_ERR,
    #  "checks": {name: {"severity", "summary", "detail", ...}},
    #  "muted": {name: {"expires_in", ...}}}
    health: Dict = field(default_factory=dict)


@message(70)
class MHealthMute:
    """`ceph health mute/unmute <check> [ttl]` (reference
    HealthMonitor mute lifecycle): a muted check keeps being tracked and
    listed under "muted" but no longer degrades the health status; the
    mute expires after ``ttl`` seconds (0 = until unmuted or the check
    clears)."""

    check: str = ""
    ttl: float = 0.0
    unmute: bool = False
    tid: str = ""


# Cluster log + crash telemetry plane (reference src/messages/MLog.h,
# MLogAck.h; the crash module's report flow).  Entry blobs use the
# append-only ClogEntry codec (ceph_tpu/rados/clog.py), corpus-pinned.


@message(73)
class MLog:
    """Daemon -> mon cluster-log batch (LogClient flush), and mon ->
    subscriber stream frame (`ceph -w`).  ``entries`` is the ClogEntry
    binary blob; ``who`` is the submitting entity (the mon's per-sender
    seq-dedupe key — resent batches after a lost ack are idempotent)."""

    who: str = ""
    entries: bytes = b""

    FIXED_FIELDS = [("who", "s"), ("entries", "y")]


@message(74)
class MLogAck:
    """Mon -> daemon: everything from ``who`` up to ``last_seq`` is
    durably in the cluster log (reference MLogAck); the LogClient drops
    acked entries and resends the rest."""

    who: str = ""
    last_seq: int = 0

    FIXED_FIELDS = [("who", "s"), ("last_seq", "Q")]


@message(75)
class MLogSubscribe:
    """`ceph log last` / `ceph -w` query: the reply is an MLogReply
    carrying the newest ``last_n`` retained entries at prio >= ``level``
    on ``channel`` ('' = all).  With ``sub`` the serving mon ALSO
    registers the connection as a log watcher and streams every newly
    committed matching entry as MLog frames until the conn dies."""

    tid: str = ""
    channel: str = ""
    level: int = 0
    last_n: int = 0
    sub: bool = False

    FIXED_FIELDS = [("tid", "s"), ("channel", "s"), ("level", "q"),
                    ("last_n", "q"), ("sub", "?")]


@message(76)
class MLogReply:
    tid: str = ""
    entries: bytes = b""

    FIXED_FIELDS = [("tid", "s"), ("entries", "y")]


@message(51, version=2)
class MCrashReport:
    """Daemon -> mon crash report (the ceph-crash meta file as a wire
    frame; v1 was the mgr-plane pickled prototype): identity + version,
    the exception and its backtrace, and the daemon's full
    ``dump_recent`` ring at max verbosity (``recent``, ClogEntry-coded).
    Spooled to the crash dir when the mon is unreachable and replayed at
    next boot; the mon's LogMonitor registers it for `ceph crash ls/
    info` and the RECENT_CRASH health check."""

    entity: str = ""
    crash_id: str = ""
    stamp: float = 0.0
    version: str = ""
    exception: str = ""
    backtrace: str = ""
    recent: bytes = b""
    tid: str = ""

    FIXED_FIELDS = [("entity", "s"), ("crash_id", "s"), ("stamp", "d"),
                    ("version", "s"), ("exception", "s"),
                    ("backtrace", "s"), ("recent", "y"), ("tid", "s")]


@message(77)
class MCrashReportAck:
    tid: str = ""
    ok: bool = True

    FIXED_FIELDS = [("tid", "s"), ("ok", "?")]


@message(78)
class MCrashQuery:
    """`ceph crash ls|info|archive|archive-all|prune` (reference
    mgr/crash commands, served here by the mon's LogMonitor).  ``keep``
    is seconds for prune; archive/prune are replicated writes."""

    tid: str = ""
    op: str = "ls"  # ls | info | archive | archive-all | prune
    crash_id: str = ""
    keep: float = 0.0

    FIXED_FIELDS = [("tid", "s"), ("op", "s"), ("crash_id", "s"),
                    ("keep", "d")]


@message(79)
class MCrashQueryReply:
    """Control-plane reply (pickled, like MHealthReply): ``crashes`` is
    a list of crash summary/info dicts."""

    tid: str = ""
    ok: bool = True
    error: str = ""
    crashes: List[Dict] = field(default_factory=list)


@message(80)
class MCommand:
    """`ceph tell <daemon> <cmd>` (reference MCommand.h): execute one
    admin-socket command on a remote daemon over the cluster messenger —
    the runtime-reconfiguration path (`tell osd.0 config set debug_ms
    10`) and remote introspection without unix-socket access."""

    tid: str = ""
    target: str = ""
    prefix: str = ""
    args: Dict = field(default_factory=dict)


@message(81)
class MCommandReply:
    tid: str = ""
    ok: bool = True
    error: str = ""
    result: Any = None


# Primary OSD <-> shard OSDs (ECSubWrite/ECSubRead equivalents,
# reference src/osd/ECMsgTypes.h:23,105)


@message(30, version=6)
class MECSubWrite:
    pool_id: int = 0
    pg: int = 0
    # interval fence (reference same_interval_since): the sender's osd id
    # and map epoch; a replica whose map shows a DIFFERENT primary for
    # this pg refuses the sub-write, so a deposed primary cannot complete
    # a write concurrently with its successor
    from_osd: int = -1
    epoch: int = 0
    oid: str = ""
    shard: int = 0
    chunk: bytes = b""
    version: int = 0
    object_size: int = 0
    chunk_crc: int = 0
    tid: str = ""
    reply_to: Tuple[str, int] = ("", 0)
    # pickled pglog.LogEntry: the replica appends it to its PG log in the
    # SAME store transaction as the shard write (log_operation coupling,
    # reference ECBackend::handle_sub_write ECBackend.cc:992)
    log_entry: bytes = b""
    # chunk_off >= 0: splice `chunk` into the shard blob at that offset
    # (the per-stripe RMW write plan, reference ECTransaction.cc:37-95)
    # instead of replacing the blob; the blob zero-extends to at least
    # `shard_size` (zero chunks ARE the parity of zero stripes, so gap
    # stripes created by a sparse write need no extra encode)
    chunk_off: int = -1
    shard_size: int = 0
    # splice precondition: the shard version the primary's RMW base was
    # read at.  A shard that missed an intermediate write must NOT have
    # the delta spliced into its stale blob (it would stamp corrupt bytes
    # as newest); it rejects and lets recovery re-push the full blob.
    prior_version: int = 0
    # ecutil.HashInfo blob (hinfo_key xattr, reference ECUtil.h:101-160);
    # empty on splice writes — the shard then self-updates its own entry
    hinfo: bytes = b""
    # trace propagation: the primary's `ec write` span context; the
    # shard peer joins a child `ec_sub_write` span under it
    trace_id: str = ""
    span_id: str = ""
    gseq: int = 0  # lane striping order key (see MOSDOp.gseq)


@message(31, version=3)
class MECSubWriteReply:
    tid: str = ""
    shard: int = 0
    ok: bool = True
    # echo of the request's trace context: the primary can correlate a
    # straggler reply with the op's trace without a tid lookup
    trace_id: str = ""
    span_id: str = ""
    gseq: int = 0  # lane striping order key (see MOSDOp.gseq)


@message(84)
class MCacheDirty:
    """Writeback fast-ack replication (cache-tier durability quorum,
    reference cache-tier/primary-log idiom): the primary ships the RAW
    dirty object — no EC encode happened yet — to the first
    ``osd_cache_min_size - 1`` acting peers, who pin it dirty in their
    pagestores and append the cache-committed log entry; the client is
    acked when the quorum commits and the k+m encode moves wholesale to
    the flush path.  op="install" carries the bytes; op="clear" is the
    post-flush broadcast releasing the replicas' copies (version-fenced,
    no ack).  On primary failover a surviving replica re-sends its copy
    to the new primary as op="install" (from_osd then names the sender,
    not the pg primary — the recovery push)."""

    pool_id: int = 0
    pg: int = 0
    # interval fence, as MECSubWrite: sender osd id + map epoch; a peer
    # whose map shows a different primary refuses a deposed primary's
    # install
    from_osd: int = -1
    epoch: int = 0
    oid: str = ""
    op: str = "install"  # install | clear
    data: bytes = b""    # raw object bytes (empty on clear)
    version: int = 0
    object_size: int = 0
    tid: str = ""
    reply_to: Tuple[str, int] = ("", 0)
    # pickled pglog.LogEntry (cache-committed, cache_peers stamped): the
    # replica appends it in the same breath as the dirty install, so a
    # failover primary's log already names the write and its replica set
    log_entry: bytes = b""
    # the full cache replica set, primary first — the adopted record's
    # replay roster
    peers: List[int] = field(default_factory=list)
    gseq: int = 0  # lane striping order key (see MOSDOp.gseq)


@message(85)
class MCacheDirtyAck:
    tid: str = ""
    osd: int = 0
    ok: bool = True
    gseq: int = 0  # lane striping order key (see MOSDOp.gseq)


@message(32, version=4)
class MECSubRead:
    pool_id: int = 0
    pg: int = 0
    oid: str = ""
    shard: int = 0
    tid: str = ""
    reply_to: Tuple[str, int] = ("", 0)
    # (offset, length) byte ranges WITHIN the shard blob; empty = whole
    # blob.  Serves both the per-stripe RMW read plan and fragmented
    # sub-chunk recovery reads (reference ECMsgTypes.h:105 to_read lists,
    # ECBackend.cc:1049-1071 CLAY helper reads).
    extents: List[Tuple[int, int]] = field(default_factory=list)
    # attach the stored hinfo record to the reply (recovery stat probes
    # only — hot-path sub-reads skip the xattr lookup + wire bytes)
    want_hinfo: bool = False
    gseq: int = 0  # lane striping order key (see MOSDOp.gseq)


@message(33, version=4)
class MECSubReadReply:
    tid: str = ""
    shard: int = 0
    ok: bool = True
    chunk: bytes = b""  # whole blob, or the requested extents concatenated
    version: int = 0
    object_size: int = 0
    # stored hinfo_key record (all-shard cumulative crcs): lets sub-chunk
    # recovery ship a correct HashInfo with its push instead of leaving the
    # target's stale record to fail the next deep scrub
    hinfo: bytes = b""
    # SENDER-LOCAL (not a wire field — absent from FIXED_FIELDS): the
    # stored shard's meta crc when `chunk` is the whole blob; the
    # messenger reuses it as the frame's blob crc (BLOB_CRC_ATTR) so a
    # full-blob sub-read reply ships without a checksum pass
    chunk_crc: int = 0
    gseq: int = 0  # lane striping order key (see MOSDOp.gseq)


@message(34, version=3)
class MECSubDelete:
    pool_id: int = 0
    pg: int = 0
    oid: str = ""
    shard: int = 0
    tid: str = ""
    reply_to: Tuple[str, int] = ("", 0)
    # pickled LogEntry: acting-set members log the delete (empty for the
    # stray-sweep broadcast to non-acting peers)
    log_entry: bytes = b""
    gseq: int = 0  # lane striping order key (see MOSDOp.gseq)


@message(35, version=4)
class MPushShard:
    """Recovery push of a reconstructed shard (reference PushOp).  Carries
    the object's cls xattr state so a backfilled OSD can serve class calls
    (reference pushes attrs alongside data), and the recomputed HashInfo
    so the hinfo_key xattr survives recovery."""

    pool_id: int = 0
    pg: int = 0
    oid: str = ""
    shard: int = 0
    chunk: bytes = b""
    version: int = 0
    object_size: int = 0
    xattrs: Dict[str, bytes] = field(default_factory=dict)
    hinfo: bytes = b""
    gseq: int = 0  # lane striping order key (see MOSDOp.gseq)


@message(36, version=2)
class MListShards:
    pool_id: int = 0
    tid: str = ""
    reply_to: Tuple[str, int] = ("", 0)
    # scope the listing to one PG (-1 = whole pool): per-PG backfill asks
    # only for the objects it can act on instead of O(pool) listings
    pg: int = -1


@message(55)
class MECSubRollback:
    """Primary-ordered revert of one shard to its rollback slot: the
    newer version it holds was confirmed unrecoverable (fewer than k
    shards survive anywhere, over two complete listings), so the durable
    state of the object is the PREV version (the automated equivalent of
    the reference's `mark_unfound_lost revert`)."""

    pool_id: int = 0
    pg: int = 0
    oid: str = ""
    shard: int = 0
    bad_version: int = 0
    reply_to: Tuple[str, int] = ("", 0)


@message(53)
class MBackfillReserve:
    """Remote recovery reservation (reference MBackfillReserve +
    AsyncReserver): the primary takes a slot on every backfill target
    before bulk pushes so osd_max_backfills bounds cluster-wide recovery
    concurrency.  op: "request" | "release"."""

    op: str = "request"
    pool_id: int = 0
    pg: int = 0
    from_osd: int = -1
    tid: str = ""
    reply_to: Tuple[str, int] = ("", 0)


@message(54, version=2)
class MBackfillReserveReply:
    tid: str = ""
    osd_id: int = 0
    ok: bool = False
    # v2: why a reservation was refused ("toofull" = target past its
    # backfillfull ratio — the primary parks the PG as backfill_toofull
    # and retries with backoff).  Read with getattr: v1 pickles lack it.
    reason: str = ""


@message(37, version=2)
class MListShardsReply:
    tid: str = ""
    osd_id: int = 0
    # (oid, shard, version) — versions let repair spot stale shards
    entries: List[Tuple[str, int, int]] = field(default_factory=list)


@message(38)
class MFetchShards:
    """Shard hunt: return every shard of oid this OSD holds (degraded reads
    survive placement drift because shards carry their id — the role the
    reference's peering/missing-set machinery plays)."""

    pool_id: int = 0
    oid: str = ""
    tid: str = ""
    reply_to: Tuple[str, int] = ("", 0)


@message(39)
class MFetchShardsReply:
    tid: str = ""
    osd_id: int = 0
    # (shard, chunk, version, object_size)
    shards: List[Tuple[int, bytes, int, int]] = field(default_factory=list)


# Peering + scrub (reference MOSDPGQuery/MOSDPGLog, scrub messages)


@message(40)
class MPGInfoReq:
    pool_id: int = 0
    pg: int = 0
    tid: str = ""
    reply_to: Tuple[str, int] = ("", 0)


@message(41, version=2)
class MPGInfoReply:
    tid: str = ""
    osd_id: int = 0
    last_update: Tuple[int, int] = (0, 0)
    log_tail: Tuple[int, int] = (0, 0)
    # the peer's view of this PG's interval membership since it was last
    # clean (past_intervals role): a failover primary that missed those
    # intervals (down, or newly added) unions these so its scope set —
    # deletes, shard hunts, backfill sources — still reaches old holders
    past_members: List[int] = field(default_factory=list)


@message(42)
class MPGLogReq:
    """Pull log entries after `since` from a peer (MOSDPGLog role)."""

    pool_id: int = 0
    pg: int = 0
    since: Tuple[int, int] = (0, 0)
    tid: str = ""
    reply_to: Tuple[str, int] = ("", 0)


@message(43, version=2)
class MPGLogReply:
    """Log entries in answer to MPGLogReq, or (tid='') an unsolicited
    authoritative push from the primary after recovery."""

    tid: str = ""
    osd_id: int = 0
    pool_id: int = 0
    pg: int = 0
    backfill: bool = False  # since predates my tail: log can't catch you up
    entries: List[bytes] = field(default_factory=list)  # pickled LogEntry


@message(44)
class MScrubShard:
    """Deep-scrub probe: recompute the stored chunk's crc and compare with
    the persisted meta (be_deep_scrub role, ECBackend.cc:2530)."""

    pool_id: int = 0
    oid: str = ""
    shard: int = 0
    tid: str = ""
    reply_to: Tuple[str, int] = ("", 0)


@message(46, version=3)
class MSetXattrs:
    """Primary -> acting peers: replicate object-class xattr state so a
    failover primary still sees locks/refcounts (cls durability)."""

    pool_id: int = 0
    oid: str = ""
    shard: int = 0
    xattrs: Dict[str, bytes] = field(default_factory=dict)
    removals: List[str] = field(default_factory=list)
    gseq: int = 0  # lane striping order key (see MOSDOp.gseq)


# watch/notify (reference src/osd/Watch.{h,cc}, librados watch2/notify2)


@message(49, version=2)
class MSetOmap:
    """Primary -> acting peers: replicate object omap mutations applied by
    a compound (multi) op, so a failover primary serves the same omap
    (the replicated-pool omap durability the reference gets from each
    replica applying the full ObjectStore::Transaction)."""

    pool_id: int = 0
    oid: str = ""
    shard: int = 0
    clear: bool = False  # applied before entries/removals
    entries: Dict[str, bytes] = field(default_factory=dict)
    removals: List[str] = field(default_factory=list)
    gseq: int = 0  # lane striping order key (see MOSDOp.gseq)


@message(47)
class MWatchNotify:
    """Primary -> watcher delivery of a notify (MWatchNotify.h role)."""

    pool_id: int = 0
    oid: str = ""
    notify_id: str = ""
    payload: bytes = b""
    reply_to: Tuple[str, int] = ("", 0)  # primary gathering the acks


@message(48)
class MNotifyAck:
    notify_id: str = ""
    watcher: Tuple[str, int] = ("", 0)


@message(45, version=2)
class MScrubShardReply:
    tid: str = ""
    osd_id: int = 0
    shard: int = 0
    present: bool = False
    crc_ok: bool = False
    version: int = 0
    # the recomputed blob crc: the scrubbing primary cross-checks it
    # against its OWN stored (clean) HashInfo record of that shard, so a
    # shard whose blob+meta+hinfo were consistently rewritten still fails
    # scrub (the reference compares all shards' hinfo copies)
    crc: int = 0


@message(52)
class MOSDPGTemp:
    """Primary-requested temporary acting set (reference MOSDPGTemp +
    OSDMonitor::prepare_pgtemp; applied in _pg_to_up_acting_osds,
    OSDMap.cc:2673): while a remapped PG backfills, the prior
    (data-holding) interval's set keeps serving IO.  Empty `acting`
    clears the override once backfill completes."""

    pool_id: int = 0
    pg: int = 0
    acting: List[int] = field(default_factory=list)
    from_osd: int = -1
    tid: str = ""


# bulk-payload fields that ride the messenger's zero-copy blob
# channel (FLAG_BLOB scatter-gather framing, messenger.py)
MOSDOp.BLOB_ATTR = "data"
MOSDOpReply.BLOB_ATTR = "data"
MECSubWrite.BLOB_ATTR = "chunk"
MECSubReadReply.BLOB_ATTR = "chunk"
MPushShard.BLOB_ATTR = "chunk"
MCacheDirty.BLOB_ATTR = "data"

# BLOB_CRC_ATTR: this field holds a crc32c the sender ALREADY computed
# over exactly the blob bytes (the primary's per-shard pass, a stored
# shard's meta crc) — the messenger reuses it as the frame's blob crc
# instead of a second checksum pass over the same bytes (the reference's
# bufferlist cached-crc discipline).  A handler must only set it to a
# crc of the CURRENT field bytes; 0 means "compute on the wire".
MECSubWrite.BLOB_CRC_ATTR = "chunk_crc"
MECSubReadReply.BLOB_CRC_ATTR = "chunk_crc"

# BLOB_VIEW_OK: every consumer of this blob field treats it as a
# read-only BUFFER (store ownership transfer, np.frombuffer decode,
# as_bytes-normalized recovery paths) — so the messenger may land it in
# an uninitialized np buffer and hand over a memoryview, skipping the
# bytearray(n) memset over the whole data volume.  Fields whose
# consumers expect bytes/bytearray semantics (MOSDOp.data into object
# classes, MOSDOpReply.data to client code) must NOT set this.
MECSubWrite.BLOB_VIEW_OK = True
MECSubReadReply.BLOB_VIEW_OK = True
# MCacheDirty.data: consumers are put_raw (np.frombuffer) and bytes()
# normalization on the adopt path — buffer-safe end to end
MCacheDirty.BLOB_VIEW_OK = True
# MOSDOp.data: the WRITE path is buffer-safe end to end (pad_to_stripe,
# splice slicing, np.frombuffer encode, bytes() cache copy); the OSD
# dispatcher normalizes data to bytes for every OTHER op (multi/call/...)
# whose handlers — object classes especially — expect bytes semantics
MOSDOp.BLOB_VIEW_OK = True

# -- fixed binary wire layouts (messenger FLAG_FIXED) ------------------------
# The DATA-PLANE message set encodes as a flat struct-packed field list
# instead of pickle (reference: ECSubWrite/MOSDOp are fixed-layout
# dencoder structs, src/osd/ECMsgTypes.h, src/messages/MOSDOp.h) — a
# malformed hot-path frame cannot execute code on decode, and
# pack/unpack is struct-speed.  Control-plane types (maps, peering,
# mon/paxos) keep the pickled internal format; the per-type version in
# every frame header still gates cross-version decode.
MOSDOp.FIXED_FIELDS = [
    ("op", "s"), ("pool_id", "q"), ("oid", "s"), ("data", "y"),
    ("epoch", "q"), ("reqid", "s"), ("offset", "q"), ("cls", "s"),
    ("method", "s"), ("snapc_seq", "Q"), ("snapc_snaps", "Q*"),
    ("snap_read", "Q"), ("snap_id", "Q"), ("pg", "q"), ("cursor", "s"),
    ("max_entries", "q"), ("nspace", "s"), ("fadvise", "s"),
    # v5 tail: trace context.  NEW FIXED FIELDS MUST APPEND — a v4 frame
    # simply ends here and the decoder's truncated-tail rule defaults
    # them (golden-replay-guarded in tests/test_op_tracking.py)
    ("trace_id", "s"), ("span_id", "s"),
    # v6 tail: client entity name (golden pre-v6 frames replayed by the
    # corpus check and tests/test_qos.py decode with the "" default)
    ("client", "s"),
    # v7 tail: lane striping order key (golden pre-lane frames under
    # corpus/wire/golden decode with the 0 default)
    ("gseq", "Q"),
]
# a compound op vector (multi) carries arbitrary typed kwargs: pickle
MOSDOp.FIXED_WHEN = staticmethod(lambda m: not m.ops)
MOSDOpReply.FIXED_FIELDS = [
    ("ok", "?"), ("error", "s"), ("code", "q"), ("data", "y"),
    ("oids", "s*"), ("cursor", "s"), ("backoff", "d"), ("reqid", "s"),
    ("version", "Q"), ("map_epoch", "q"),
    ("gseq", "Q"),  # v3 tail (append-only rule)
]
MOSDOpReply.FIXED_WHEN = staticmethod(
    lambda m: isinstance(m.data, (bytes, bytearray, memoryview, BufferList)))
MECSubWrite.FIXED_FIELDS = [
    ("pool_id", "q"), ("pg", "q"), ("from_osd", "q"), ("epoch", "q"),
    ("oid", "s"), ("shard", "q"), ("chunk", "y"), ("version", "Q"),
    ("object_size", "q"), ("chunk_crc", "Q"), ("tid", "s"),
    ("reply_to", "addr"), ("log_entry", "y"), ("chunk_off", "q"),
    ("shard_size", "q"), ("prior_version", "Q"), ("hinfo", "y"),
    ("trace_id", "s"), ("span_id", "s"),  # v5 tail (append-only rule)
    ("gseq", "Q"),  # v6 tail (append-only rule)
]
MECSubWriteReply.FIXED_FIELDS = [
    ("tid", "s"), ("shard", "q"), ("ok", "?"),
    ("trace_id", "s"), ("span_id", "s"),  # v2 tail (append-only rule)
    ("gseq", "Q"),  # v3 tail (append-only rule)
]
MECSubRead.FIXED_FIELDS = [
    ("pool_id", "q"), ("pg", "q"), ("oid", "s"), ("shard", "q"),
    ("tid", "s"), ("reply_to", "addr"), ("extents", "qq*"),
    ("want_hinfo", "?"),
    ("gseq", "Q"),  # v4 tail (append-only rule)
]
MECSubReadReply.FIXED_FIELDS = [
    ("tid", "s"), ("shard", "q"), ("ok", "?"), ("chunk", "y"),
    ("version", "Q"), ("object_size", "q"), ("hinfo", "y"),
    ("gseq", "Q"),  # v4 tail (append-only rule)
]
MCacheDirty.FIXED_FIELDS = [
    ("pool_id", "q"), ("pg", "q"), ("from_osd", "q"), ("epoch", "q"),
    ("oid", "s"), ("op", "s"), ("data", "y"), ("version", "Q"),
    ("object_size", "q"), ("tid", "s"), ("reply_to", "addr"),
    ("log_entry", "y"), ("peers", "Q*"), ("gseq", "Q"),
]
MCacheDirtyAck.FIXED_FIELDS = [
    ("tid", "s"), ("osd", "q"), ("ok", "?"),
    ("gseq", "Q"),
]
# membership-lifecycle control frames: typed fixed layouts (a malformed
# admin frame must not execute code on decode), control lane, no stripe
MCrushOp.FIXED_FIELDS = [
    ("op", "s"), ("name", "s"), ("bucket_type", "s"), ("dest", "s"),
    ("weight", "d"), ("tid", "s"),
    ("force", "?"),  # v2 tail (append-only rule; v1 frames default False)
]
MCrushOpReply.FIXED_FIELDS = [
    ("tid", "s"), ("ok", "?"), ("error", "s"), ("epoch", "q"),
]
MOsdPredicate.FIXED_FIELDS = [
    ("op", "s"), ("osd_ids", "Q*"), ("tid", "s"),
]
MOsdPredicateReply.FIXED_FIELDS = [
    ("tid", "s"), ("op", "s"), ("safe", "?"), ("unsafe_ids", "Q*"),
    ("reasons", "s*"), ("pgs_checked", "q"),
    # v2 tail: cache-dirt clause (truncated v1 frames default to 0/[])
    ("dirty_blocked", "q"), ("dirty_keys", "s*"),
]
MPushShard.FIXED_FIELDS = [
    ("pool_id", "q"), ("pg", "q"), ("oid", "s"), ("shard", "q"),
    ("chunk", "y"), ("version", "Q"), ("object_size", "q"),
    ("hinfo", "y"),
    ("gseq", "Q"),  # v4 tail (append-only rule)
]
# xattr pushes carry an arbitrary dict: pickle those
MPushShard.FIXED_WHEN = staticmethod(lambda m: not m.xattrs)

# LANE_STRIPE: the data-plane set a multi-lane peer session stripes
# across its data lanes (messenger LaneGroup): stamped with the
# connection-global `gseq` order key, round-robined over lanes 1..N-1,
# fragmented when the blob is large.  Control-plane types stay on lane 0
# and are never queued behind data.
# The full OBJECT-MUTATION plane stripes — a delete or xattr/omap
# replication overtaking a parked striped write on the control lane
# would reorder mutations to the same object (these three are pickled
# payloads, so gseq rides the dict; old frames decode without it and
# getattr defaults to 0)
MECSubDelete.LANE_STRIPE = True
MSetXattrs.LANE_STRIPE = True
MSetOmap.LANE_STRIPE = True
MOSDOp.LANE_STRIPE = True
MOSDOpReply.LANE_STRIPE = True
MECSubWrite.LANE_STRIPE = True
MECSubWriteReply.LANE_STRIPE = True
MECSubRead.LANE_STRIPE = True
MECSubReadReply.LANE_STRIPE = True
MPushShard.LANE_STRIPE = True
MCacheDirty.LANE_STRIPE = True
MCacheDirtyAck.LANE_STRIPE = True
