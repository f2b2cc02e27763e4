# Copy of ceph_tpu/mgr/modules.py at commit 484e351, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Active mgr modules: balancer and pg_autoscaler.

Role-equivalents of the reference's mgr python modules
(src/pybind/mgr/balancer, src/pybind/mgr/pg_autoscaler): periodic
observers of the OSDMap that act on the cluster through mon commands —
the balancer evens PG seats across OSDs by installing persistent
pg-upmap overrides (MSetUpmap), the autoscaler resizes a pool's pg_num
(MPoolSet) when its object count is far from the target PGs-per-OSD
band.  Both compute functions are pure (map in, proposals out) so they
unit-test without a cluster; MgrDaemon runs them on a tick when
configured with mon addresses.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.rados.crush import CRUSH_ITEM_NONE
from ceph_tpu_torch.rados.types import OSDMap, PoolInfo


class Balancer:
    """Upmap balancer (reference mgr/balancer upmap mode): move single
    seats from the most-loaded OSD to the least-loaded until the spread
    is within one, a bounded number of changes per round."""

    def __init__(self, max_changes_per_round: int = 4):
        self.max_changes = max_changes_per_round

    @staticmethod
    def seat_counts(osdmap: OSDMap) -> Dict[int, int]:
        counts = {o.osd_id: 0 for o in osdmap.osds.values()
                  if o.up and o.in_cluster}
        for pool in osdmap.pools.values():
            for pg in range(pool.pg_num):
                for osd in osdmap.pg_to_placed(pool, pg):
                    if osd in counts:
                        counts[osd] += 1
        return counts

    def compute(self, osdmap: OSDMap
                ) -> List[Tuple[int, int, List[int]]]:
        """Returns [(pool_id, pg, new_placed)] proposals.  Pure function
        of the map."""
        counts = self.seat_counts(osdmap)
        if len(counts) < 2:
            return []
        proposals: List[Tuple[int, int, List[int]]] = []
        # working copy of placements we can mutate as we propose
        placed: Dict[Tuple[int, int], List[int]] = {}
        for pool in osdmap.pools.values():
            for pg in range(pool.pg_num):
                placed[(pool.pool_id, pg)] = osdmap.pg_to_placed(pool, pg)
        for _ in range(self.max_changes):
            hot = max(counts, key=counts.get)
            cold = min(counts, key=counts.get)
            if counts[hot] - counts[cold] <= 1:
                break
            moved = False
            for (pool_id, pg), seats in placed.items():
                if hot in seats and cold not in seats:
                    new_seats = [cold if s == hot else s for s in seats]
                    proposals.append((pool_id, pg, new_seats))
                    placed[(pool_id, pg)] = new_seats
                    counts[hot] -= 1
                    counts[cold] += 1
                    moved = True
                    break
            if not moved:
                break
        return proposals


class PgAutoscaler:
    """pg_num autoscaler (reference mgr/pg_autoscaler): propose the
    power-of-two pg count that puts the pool near the target objects-
    per-PG band; act only when the current count is off by the
    threshold factor (hysteresis, the reference's threshold=3 idea)."""

    def __init__(self, target_objects_per_pg: int = 32, threshold: float = 2.0,
                 pg_min: int = 4, pg_max: int = 256):
        self.target = max(1, target_objects_per_pg)
        self.threshold = threshold
        self.pg_min = pg_min
        self.pg_max = pg_max

    def compute(self, pool: PoolInfo, n_objects: int) -> Optional[int]:
        """Returns the proposed pg_num or None when within band."""
        want = max(self.pg_min, min(self.pg_max,
                                    -(-n_objects // self.target)))
        # round to the next power of two (the reference only picks pow2)
        p = 1
        while p < want:
            p <<= 1
        if p >= pool.pg_num * self.threshold or \
                p * self.threshold <= pool.pg_num:
            return p
        return None
