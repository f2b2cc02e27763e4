# Copy of ceph_tpu/rados/crush.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""CRUSH-style placement: hierarchical straw2 buckets, rule steps with
firstn and indep modes, chooseleaf failure domains.

Functional equivalent of the reference's crush core + wrapper (reference
src/crush/mapper.c, src/crush/CrushWrapper.h): deterministic pseudo-random
placement computed identically by every party from the map alone.  The map
is a tree of typed buckets (root/rack/host/...) holding devices (ids >= 0)
or child buckets (ids < 0); rules are step programs
``take <root> -> choose/chooseleaf <mode> <n> <type> -> emit`` compiled by
``add_simple_rule`` exactly as the reference's
``ErasureCode::create_rule -> add_simple_rule(..., "indep")`` path does.

The property EC pools depend on is ``indep`` (crush_choose_indep,
mapper.c:630): positions in the acting set are *stable* — when a device
fails, surviving positions keep their shard index and the hole stays a hole
(CRUSH_ITEM_NONE) — because an EC chunk id is positional, unlike replica
copies (firstn, mapper.c:438, which fills forward).

Straw2 selection (mapper.c bucket_straw2_choose semantics): each item draws
ln(u)/weight and the maximum wins — exact weighted subset sampling with
minimal movement on weight change.  Bucket weights are the live sum of
descendant device weights, so marking a device out reweights its whole
subtree, as reweight-compat straw2 does.

Hash: 64-bit FNV-1a-folded mix rather than rjenkins1 — placement quality
and determinism are equivalent; byte-level parity with the reference's
mapping is NOT a goal of this layer (documented divergence; the EC chunk
bytes themselves are the byte-exact contract, not device selection).
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

CRUSH_ITEM_NONE = -1 << 30  # hole marker in indep mode (reference CRUSH_ITEM_NONE)

CHOOSE_TRIES = 19  # bounded retries per position (reference choose_total_tries=50)


def _mix(*vals: int) -> int:
    """Deterministic 64-bit hash of integers (placement draw)."""
    h = 0xCBF29CE484222325
    for v in vals:
        for b in struct.pack("<q", v & 0x7FFFFFFFFFFFFFFF):
            h ^= b
            h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & 0xFFFFFFFFFFFFFFFF
    h ^= h >> 33
    return h


@dataclass
class Bucket:
    """A straw2 bucket: items are device ids (>=0) or child buckets (<0)."""

    id: int
    type: str = "root"
    name: str = ""
    items: List[int] = field(default_factory=list)
    weights: Dict[int, float] = field(default_factory=dict)  # item -> weight


class CrushMap:
    DEVICE_TYPE = "osd"

    def __init__(self):
        self.buckets: Dict[int, Bucket] = {}
        self.rules: Dict[str, dict] = {}
        self.root_id: int = 0
        self._next_bucket_id = -1
        self._next_rule_id = 0
        # device -> stored crush weight (the caller's overlay overrides it,
        # the reference's crush-weight vs reweight split)
        self.device_weights: Dict[int, float] = {}

    # -- construction / editing (CrushWrapper role) --------------------------

    @classmethod
    def flat(cls, osd_ids: List[int]) -> "CrushMap":
        """One root bucket containing all OSDs (the vstart topology)."""
        m = cls()
        root = m.add_bucket("root", "default")
        for i in osd_ids:
            m.add_item(root, i, 1.0)
        return m

    @classmethod
    def with_hosts(cls, osd_ids: List[int], n_hosts: int) -> "CrushMap":
        """root -> host buckets -> OSDs (osd i on host i % n_hosts)."""
        m = cls()
        root = m.add_bucket("root", "default")
        hosts = []
        for h in range(n_hosts):
            hid = m.add_bucket("host", f"host{h}")
            m.add_item(root, hid, 0.0)
            hosts.append(hid)
        for i in osd_ids:
            m.add_item(hosts[i % n_hosts], i, 1.0)
        return m

    def add_bucket(self, type_: str, name: str) -> int:
        bid = self._next_bucket_id
        self._next_bucket_id -= 1
        self.buckets[bid] = Bucket(id=bid, type=type_, name=name)
        if type_ == "root" and self.root_id == 0:
            self.root_id = bid
        return bid

    def bucket_by_name(self, name: str) -> Optional[Bucket]:
        for b in self.buckets.values():
            if b.name == name:
                return b
        return None

    def add_item(self, bucket_id: int, item: int, weight: float = 1.0) -> None:
        b = self.buckets[bucket_id]
        if item not in b.items:
            b.items.append(item)
        b.weights[item] = weight
        if item >= 0:
            self.device_weights[item] = weight

    def remove_item(self, item: int) -> None:
        for b in self.buckets.values():
            if item in b.items:
                b.items.remove(item)
                b.weights.pop(item, None)
        self.device_weights.pop(item, None)

    def move_item(self, item: int, to_bucket: int, weight: float = 1.0) -> None:
        self.remove_item(item)
        self.add_item(to_bucket, item, weight)

    def set_weight(self, osd: int, weight: float) -> None:
        for b in self.buckets.values():
            if osd in b.weights and osd >= 0:
                b.weights[osd] = weight
        if osd >= 0:
            self.device_weights[osd] = weight

    def devices(self) -> List[int]:
        return sorted(
            i for b in self.buckets.values() for i in b.items if i >= 0
        )

    def parent_of(self, item: int) -> Optional[int]:
        """Containing bucket id, or None for the root / detached items."""
        for b in self.buckets.values():
            if item in b.items:
                return b.id
        return None

    def in_subtree(self, root: int, item: int) -> bool:
        """True when `item` sits anywhere under bucket `root` (the cycle
        guard for `crush move`: a bucket must never move under its own
        descendant)."""
        seen: Set[int] = set()
        stack = [root]
        while stack:
            bid = stack.pop()
            if bid >= 0 or bid in seen:
                continue
            seen.add(bid)
            b = self.buckets.get(bid)
            if b is None:
                continue
            if item in b.items:
                return True
            stack.extend(i for i in b.items if i < 0)
        return False

    def subtree_devices(self, item: int) -> List[int]:
        """Every device id under `item` (a device is its own subtree)."""
        if item >= 0:
            return [item]
        out: List[int] = []
        seen: Set[int] = set()
        stack = [item]
        while stack:
            bid = stack.pop()
            if bid in seen:
                continue
            seen.add(bid)
            b = self.buckets.get(bid)
            if b is None:
                continue
            for i in b.items:
                if i >= 0:
                    out.append(i)
                else:
                    stack.append(i)
        return sorted(out)

    def sig(self) -> Tuple:
        """Canonical topology signature — buckets (type/name/membership/
        stored weights), device weights, rule names.  OSDMapIncremental
        compares signatures so bucket-only edits (`crush move`,
        `crush add-bucket`) ship the crush map even when the device set
        itself did not change."""
        return (
            tuple(sorted(
                (bid, b.type, b.name, tuple(b.items),
                 tuple(sorted(b.weights.items())))
                for bid, b in self.buckets.items())),
            tuple(sorted(self.device_weights.items())),
            tuple(sorted(self.rules)),
        )

    # -- rules ---------------------------------------------------------------

    def add_simple_rule(
        self, name: str, root: str = "default", failure_domain: str = "osd",
        mode: str = "indep",
    ) -> int:
        """Reference CrushWrapper::add_simple_rule: compiles
        take/chooseleaf/emit steps; EC uses mode=indep
        (ErasureCode::create_rule, ErasureCode.cc:64)."""
        rule_id = self._next_rule_id
        self._next_rule_id += 1
        root_bucket = self.bucket_by_name(root)
        root_id = root_bucket.id if root_bucket else self.root_id
        if failure_domain == self.DEVICE_TYPE:
            steps = [("take", root_id), ("choose", mode, 0, self.DEVICE_TYPE),
                     ("emit",)]
        else:
            steps = [("take", root_id),
                     ("chooseleaf", mode, 0, failure_domain), ("emit",)]
        self.rules[name] = {"id": rule_id, "mode": mode, "steps": steps}
        return rule_id

    # -- the mapper ----------------------------------------------------------

    def _effective_weight(self, item: int, overlay: Dict[int, float],
                          memo: Dict[int, float]) -> float:
        """Device: overlay weight if given (down/out = 0), else the stored
        crush weight.  Bucket: sum of subtree."""
        if item >= 0:
            return overlay.get(item, self.device_weights.get(item, 1.0))
        if item in memo:
            return memo[item]
        memo[item] = 0.0  # cycle guard
        b = self.buckets.get(item)
        if b is not None:
            memo[item] = sum(
                self._effective_weight(i, overlay, memo) for i in b.items
            )
        return memo[item]

    def _straw2(self, bucket: Bucket, x: int, r: int, exclude: Set[int],
                overlay: Dict[int, float], memo: Dict[int, float]) -> Optional[int]:
        best, best_draw = None, -math.inf
        for item in bucket.items:
            if item in exclude:
                continue
            w = self._effective_weight(item, overlay, memo)
            if w <= 0:
                continue
            u = (_mix(x, item, r) & 0xFFFF) / 65536.0
            draw = math.log(u + 1.0 / 65536.0) / w
            if draw > best_draw:
                best, best_draw = item, draw
        return best

    def _descend(self, bucket: Bucket, x: int, r: int, want_type: str,
                 exclude: Set[int], overlay: Dict[int, float],
                 memo: Dict[int, float]) -> Optional[int]:
        """Walk down from bucket to an item of want_type via straw2 at each
        level (the recursive heart of crush_choose_*)."""
        node = bucket
        for _depth in range(16):
            c = self._straw2(node, x, r, exclude, overlay, memo)
            if c is None:
                return None
            if c >= 0:
                return c if want_type == self.DEVICE_TYPE else None
            child = self.buckets[c]
            if child.type == want_type:
                return c
            node = child
        return None

    def _leaf_of(self, bucket_id: int, x: int, r: int, exclude: Set[int],
                 overlay: Dict[int, float], memo: Dict[int, float]) -> Optional[int]:
        """Descend from a failure-domain bucket to one device."""
        if bucket_id >= 0:
            return bucket_id
        return self._descend(self.buckets[bucket_id], x, r,
                             self.DEVICE_TYPE, exclude, overlay, memo)

    def do_rule(self, rule_name: str, x: int, num_rep: int,
                weights: Dict[int, float]) -> List[int]:
        """Map input x (PG seed) to num_rep devices.

        indep mode (EC): each position r draws independently with bounded
        retries; an unplaceable position stays CRUSH_ITEM_NONE — holes are
        holes (mapper.c:630 crush_choose_indep).
        firstn mode (replication): forward-filled distinct choices
        (mapper.c:438 crush_choose_firstn)."""
        rule = self.rules.get(rule_name)
        if rule is None:
            rule = {"mode": "indep",
                    "steps": [("take", self.root_id),
                              ("choose", "indep", 0, self.DEVICE_TYPE),
                              ("emit",)]}
        overlay = dict(weights)
        memo: Dict[int, float] = {}
        working: List[int] = [self.root_id]
        out: List[int] = []
        for step in rule["steps"]:
            if step[0] == "take":
                working = [step[1]]
            elif step[0] in ("choose", "chooseleaf"):
                _, mode, n, want_type = step
                n = n or num_rep
                chooseleaf = step[0] == "chooseleaf"
                result: List[int] = []
                for take in working:
                    bucket = self.buckets[take]
                    if mode == "firstn":
                        result.extend(self._choose_firstn(
                            bucket, x, n, want_type, chooseleaf, overlay, memo))
                    else:
                        result.extend(self._choose_indep(
                            bucket, x, n, want_type, chooseleaf, overlay, memo))
                working = result
            elif step[0] == "emit":
                out.extend(working)
                working = [self.root_id]
        return out[:num_rep] if rule["mode"] == "firstn" else (
            out + [CRUSH_ITEM_NONE] * num_rep)[:num_rep]

    def _choose_firstn(self, bucket: Bucket, x: int, n: int, want_type: str,
                       chooseleaf: bool, overlay: Dict[int, float],
                       memo: Dict[int, float]) -> List[int]:
        out: List[int] = []
        chosen: Set[int] = set()
        leaves: Set[int] = set()
        for r in range(n * CHOOSE_TRIES):
            if len(out) == n:
                break
            c = self._descend(bucket, x, r, want_type, chosen, overlay, memo)
            if c is None:
                continue
            if chooseleaf:
                leaf = self._leaf_of(c, x, r, leaves, overlay, memo)
                if leaf is None:
                    continue
                chosen.add(c)
                leaves.add(leaf)
                out.append(leaf)
            else:
                chosen.add(c)
                out.append(c)
        return out

    def _choose_indep(self, bucket: Bucket, x: int, n: int, want_type: str,
                      chooseleaf: bool, overlay: Dict[int, float],
                      memo: Dict[int, float]) -> List[int]:
        """Multi-pass with per-position collision retry (mapper.c:630): each
        position's draw sequence r = pos + attempt*97 is independent of
        other positions' outcomes; a collision or dead device bumps only
        THAT position to its next attempt.  Unfilled positions stay
        CRUSH_ITEM_NONE — holes are holes, never compacted."""
        out = [CRUSH_ITEM_NONE] * n
        leaves_out = [CRUSH_ITEM_NONE] * n
        taken: Set[int] = set()
        taken_leaves: Set[int] = set()
        for attempt in range(CHOOSE_TRIES):
            undone = [p for p in range(n) if out[p] == CRUSH_ITEM_NONE]
            if not undone:
                break
            for pos in undone:
                r = pos + attempt * 97
                c = self._descend(bucket, x, r, want_type, taken, overlay, memo)
                if c is None:
                    continue
                if chooseleaf:
                    leaf = self._leaf_of(c, x, r, taken_leaves, overlay, memo)
                    if leaf is None:
                        continue
                    taken.add(c)
                    taken_leaves.add(leaf)
                    out[pos] = c
                    leaves_out[pos] = leaf
                else:
                    taken.add(c)
                    out[pos] = c
        return leaves_out if chooseleaf else out


class CrushTester:
    """Reference src/crush/CrushTester.cc role: statistical validation of a
    rule — coverage, balance, and (for indep) positional stability."""

    def __init__(self, crush: CrushMap):
        self.crush = crush

    def test(self, rule: str, num_rep: int, n_inputs: int = 1024,
             weights: Optional[Dict[int, float]] = None) -> Dict:
        weights = weights if weights is not None else {
            d: 1.0 for d in self.crush.devices()
        }
        per_device: Dict[int, int] = {}
        holes = 0
        for x in range(n_inputs):
            acting = self.crush.do_rule(rule, x, num_rep, weights)
            for a in acting:
                if a == CRUSH_ITEM_NONE:
                    holes += 1
                else:
                    per_device[a] = per_device.get(a, 0) + 1
        placed = sum(per_device.values())
        expected = placed / max(1, len(per_device))
        worst = max(
            (abs(c - expected) / expected for c in per_device.values()),
            default=0.0,
        )
        return {"per_device": per_device, "holes": holes,
                "placed": placed, "max_deviation": worst}

    def indep_stability(self, rule: str, num_rep: int, kill: int,
                        n_inputs: int = 256) -> Dict:
        """After killing a device, indep must not compact (positions that
        lost their device become holes or get a fresh device IN PLACE) and
        collateral movement of unaffected positions must be minimal
        (collision-retry cascades move a small fraction; CRUSH minimizes,
        not zeroes, movement)."""
        alive = {d: 1.0 for d in self.crush.devices()}
        moved = affected = total = 0
        for x in range(n_inputs):
            before = self.crush.do_rule(rule, x, num_rep, alive)
            after = self.crush.do_rule(rule, x, num_rep, {**alive, kill: 0.0})
            assert len(after) == len(before) == num_rep
            for pos, dev in enumerate(before):
                if dev == CRUSH_ITEM_NONE:
                    continue
                total += 1
                if dev == kill:
                    affected += 1
                    assert after[pos] != kill
                elif after[pos] != dev:
                    moved += 1
        return {"total": total, "affected": affected, "moved": moved,
                "collateral_ratio": moved / max(1, total - affected)}
