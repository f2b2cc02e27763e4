# Copy of ceph_tpu/rados/paxos.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch; what it reads back from the
# wire or a store unpickles through rados/unpickle.py.
"""Mon consensus: elections, Paxos-replicated state, persistent store.

Role-equivalent of the reference's mon consensus stack (reference
src/mon/Paxos.h:174, src/mon/Elector.cc, src/mon/ElectionLogic.cc,
src/mon/MonitorDBStore.h):

- :class:`MonitorDBStore` — each mon's local durable store.  The reference
  uses RocksDB through MonitorDBStore; here it is an atomically-rewritten
  pickle file (tiny state), with the same recovery contract: committed
  versions survive restart.
- :class:`ElectionLogic` — rank-based leader election: a candidate
  proposes with a monotonically increasing epoch; peers defer to the
  lowest-ranked live proposer; the winner declares victory with the
  acked quorum (the reference's CLASSIC strategy).
- :class:`Paxos` — the single consensus log all mon state rides
  (reference: one Paxos instance, PaxosService machines layered on it).
  Leader-driven: collect (on election) brings the quorum to the newest
  committed version, then each proposal is begin -> majority accept ->
  commit, fanned to peons.  Values are opaque bytes (the mon pickles its
  replicated state-machine delta).

Network send/receive is injected by the Monitor daemon; these classes hold
the protocol state so they can be unit-tested without sockets.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from ceph_tpu_torch.rados import unpickle


class MonitorDBStore:
    """Durable committed-version store; file-backed when path given."""

    def __init__(self, path: Optional[str] = None, keep_versions: int = 500):
        self.path = path
        self.keep_versions = keep_versions
        self.committed: Dict[int, bytes] = {}
        self.last_committed = 0
        self.first_committed = 0
        self.meta: Dict[str, Any] = {}  # election epoch, monmap, ...
        if path and os.path.exists(path):
            self._load()

    def _load(self) -> None:
        with open(self.path, "rb") as f:
            blob = unpickle.load(f)
        self.committed = blob["committed"]
        self.last_committed = blob["last_committed"]
        self.first_committed = blob["first_committed"]
        self.meta = blob.get("meta", {})

    def _persist(self) -> None:
        if not self.path:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path) or ".")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(
                    {
                        "committed": self.committed,
                        "last_committed": self.last_committed,
                        "first_committed": self.first_committed,
                        "meta": self.meta,
                    },
                    f,
                    protocol=5,
                )
            os.replace(tmp, self.path)  # atomic: torn writes can't corrupt
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def commit(self, version: int, value: bytes) -> None:
        if version <= self.last_committed:
            return
        self.committed[version] = value
        self.last_committed = version
        if not self.first_committed:
            self.first_committed = version
        # trim old versions (reference paxos_trim)
        while self.last_committed - self.first_committed >= self.keep_versions:
            self.committed.pop(self.first_committed, None)
            self.first_committed += 1
        self._persist()

    def set_meta(self, key: str, value: Any) -> None:
        self.meta[key] = value
        self._persist()

    def get(self, version: int) -> Optional[bytes]:
        return self.committed.get(version)

    def latest(self) -> Tuple[int, Optional[bytes]]:
        return self.last_committed, self.committed.get(self.last_committed)


class ElectionLogic:
    """Rank-based election state; the Monitor wires sends/timeouts."""

    # scores are QUANTIZED into buckets before comparison (tie -> lowest
    # rank): a mon must be meaningfully better connected to displace a
    # lower rank, or jittery measurements would flap leadership.
    # Quantization (unlike a pairwise margin) keeps the ordering
    # TRANSITIVE — pairwise margins let a chain of within-margin wins
    # hand victory to the worst-connected candidate.
    SCORE_BUCKET = 0.2

    def __init__(self, rank: int, n_mons: int):
        self.rank = rank
        self.n_mons = n_mons
        self.epoch = 1
        self.electing = False
        self.acked_by: Set[int] = set()
        self.leader: Optional[int] = None
        self.quorum: Set[int] = set()
        # this mon's own connectivity score (mean peer-reachability EMA,
        # reference ConnectionTracker); the Monitor refreshes it before
        # each election round
        self.score = 1.0

    @classmethod
    def _bucket(cls, score: float) -> int:
        return int(round(score / cls.SCORE_BUCKET))

    def _beats(self, their_score: float, their_rank: int) -> bool:
        """Does the remote candidate beat US (we should ack them)?"""
        if their_score >= 0:
            theirs, ours = self._bucket(their_score), self._bucket(self.score)
            if theirs != ours:
                return theirs > ours
        return their_rank < self.rank

    @property
    def majority(self) -> int:
        return self.n_mons // 2 + 1

    def start(self) -> int:
        """Begin (or restart) an election; returns the new election epoch."""
        self.electing = True
        self.leader = None
        self.quorum = set()
        self.acked_by = {self.rank}
        if self.epoch % 2 == 0:
            self.epoch += 1  # odd epoch = election in progress (reference)
        else:
            self.epoch += 2
        return self.epoch

    def receive_propose(self, from_rank: int, epoch: int,
                        from_score: float = -1.0) -> str:
        """Any propose pulls us into the election (reference: an election
        message bumps everyone into electing).  Returns 'ack' (defer to a
        better candidate), 'ignore', or 'counter' (we are the better
        candidate: propose ourselves).  "Better" is connectivity score
        first (a well-connected mon routes around partial network
        failure), rank as the tiebreak — the reference's CONNECTIVITY
        election strategy (ElectionLogic.cc, ConnectionTracker.h:80)."""
        if epoch > self.epoch:
            self.epoch = epoch
        if from_rank == self.rank:
            return "ignore"
        # entering election: any standing quorum/leadership is suspended
        # until a victory re-establishes it (so a rejoining mon can win a
        # seat even when a stable quorum existed)
        self.electing = True
        self.leader = None
        self.quorum = set()
        if self._beats(from_score, from_rank):
            return "ack"
        return "counter"

    def receive_ack(self, from_rank: int, epoch: int) -> bool:
        """Returns True when this ack completes a majority.  An ack carrying
        a NEWER epoch teaches a restarted candidate the cluster's epoch (its
        next proposal round uses it)."""
        if epoch > self.epoch:
            self.epoch = epoch
            return False
        if not self.electing or epoch != self.epoch:
            return False
        self.acked_by.add(from_rank)
        return len(self.acked_by) >= self.majority

    def declare_victory(self) -> Tuple[int, Set[int]]:
        self.electing = False
        self.leader = self.rank
        self.quorum = set(self.acked_by)
        if self.epoch % 2 == 1:
            self.epoch += 1  # even epoch = stable quorum
        return self.epoch, self.quorum

    def receive_victory(self, from_rank: int, epoch: int,
                        quorum: Set[int]) -> bool:
        if epoch < self.epoch:
            return False
        self.epoch = epoch
        self.electing = False
        self.leader = from_rank
        self.quorum = set(quorum)
        return True

    @property
    def is_leader(self) -> bool:
        return self.leader == self.rank and not self.electing

    @property
    def in_quorum(self) -> bool:
        return self.leader is not None and self.rank in self.quorum


class Paxos:
    """Leader-driven single-log Paxos over an injected transport.

    The Monitor provides ``send(rank, payload_dict)``; payloads come back
    through the ``handle_*`` methods.  Proposals are serialized: one
    in-flight proposal at a time (the reference's is_updating gate).
    """

    def __init__(self, store: MonitorDBStore, rank: int,
                 send: Callable[[int, Dict[str, Any]], Any]):
        self.store = store
        self.rank = rank
        self.send = send
        self.on_commit: Optional[Callable[[int, bytes], None]] = None
        # leader proposal state
        self.proposing: Optional[Tuple[int, bytes]] = None
        self.accepts: Set[int] = set()
        self.quorum: Set[int] = set()
        # pending (uncommitted) value seen by a peon
        self.pending: Optional[Tuple[int, bytes]] = None
        # epoch fencing (the reference's proposal-number machinery,
        # Paxos.h accepted_pn/last_pn): peons promise the election epoch
        # at collect/victory and reject begin/commit from lower epochs, so
        # a deposed leader that still believes it leads cannot commit a
        # divergent value against the same peons
        self.epoch = 0  # leader: the epoch current proposals carry
        self.promised_epoch = 0  # peon: floor for begin/commit acceptance
        self.nacked = False  # leader: a peer refused our epoch

    # -- collect phase (leader, after election) ------------------------------

    def collect_state(self) -> Dict[str, Any]:
        v, val = self.store.latest()
        return {"op": "last", "version": v, "value": val,
                "pending": self.pending}

    def absorb_last(self, last: Dict[str, Any]) -> None:
        """Leader folds a peon's state into its own (newest version wins;
        an uncommitted pending from a dead leader's round is re-committed —
        the reference's uncommitted-value recovery)."""
        v, val = last.get("version", 0), last.get("value")
        if v > self.store.last_committed and val is not None:
            self.store.commit(v, val)
            if self.on_commit:
                self.on_commit(v, val)
        pend = last.get("pending")
        if pend is not None:
            pv, pval = pend
            if pv == self.store.last_committed + 1:
                self.store.commit(pv, pval)
                if self.on_commit:
                    self.on_commit(pv, pval)

    # -- proposals (leader) --------------------------------------------------

    async def propose(self, value: bytes, quorum: Set[int],
                      epoch: Optional[int] = None) -> int:
        """Replicate one value; returns the committed version.  The caller
        (Monitor) awaits acceptance via handle_accept -> _check_commit."""
        assert self.proposing is None, "one in-flight proposal at a time"
        if epoch is not None:
            self.epoch = epoch
        self.nacked = False
        version = self.store.last_committed + 1
        self.proposing = (version, value)
        self.accepts = {self.rank}
        self.quorum = set(quorum)
        for peer in quorum:
            if peer != self.rank:
                await self.send(peer, {"op": "begin", "version": version,
                                       "value": value, "epoch": self.epoch})
        return version

    def handle_accept(self, from_rank: int, version: int,
                      epoch: Optional[int] = None) -> bool:
        """Returns True when the proposal just reached majority."""
        if self.proposing is None or self.proposing[0] != version:
            return False
        if epoch is not None and epoch != self.epoch:
            return False  # accept for some other leadership's round
        self.accepts.add(from_rank)
        need = len(self.quorum) // 2 + 1
        return len(self.accepts) >= need

    def handle_nack(self, epoch: int) -> bool:
        """A peer promised a newer epoch: we are deposed.  Abandon the
        in-flight proposal (the reference leader bootstraps on seeing a
        higher pn).  A nack at or below our CURRENT proposal epoch is a
        stale packet from an older round — a single delayed frame must not
        tear down a healthy re-elected leadership — and is ignored.  The
        floor includes promised_epoch: a leadership we already promised
        (e.g. the election we just won, before the first propose() stamps
        self.epoch) is not news and must not depose us either.
        Returns True when the nack actually deposed us."""
        if epoch <= max(self.epoch, self.promised_epoch):
            return False
        self.nacked = True
        self.promised_epoch = max(self.promised_epoch, epoch)
        self.proposing = None
        return True

    async def commit_current(self) -> Tuple[int, bytes]:
        version, value = self.proposing  # type: ignore[misc]
        self.proposing = None
        self.store.commit(version, value)
        if self.on_commit:
            self.on_commit(version, value)
        for peer in self.quorum:
            if peer != self.rank:
                await self.send(peer, {"op": "commit", "version": version,
                                       "value": value, "epoch": self.epoch})
        return version, value

    # -- peon side -----------------------------------------------------------

    def promise(self, epoch: int) -> bool:
        """Record the election epoch at collect/victory time; returns False
        for a stale (lower-epoch) overture."""
        if epoch < self.promised_epoch:
            return False
        self.promised_epoch = epoch
        # Promising a NEWER leadership while our own proposal is in flight
        # means we were deposed mid-round: abandon it, or the commit we
        # send after gathering the remaining accepts would carry the new
        # leader's epoch and land on its peons as a divergent value.
        if self.proposing is not None and epoch > self.epoch:
            self.proposing = None
            self.nacked = True
        return True

    async def handle_begin(self, from_rank: int, version: int,
                           value: bytes, epoch: Optional[int] = None) -> None:
        if epoch is not None and epoch < self.promised_epoch:
            # stale leader (healed partition / lost lease): refuse, teach
            await self.send(from_rank, {"op": "nack", "version": version,
                                        "epoch": self.promised_epoch})
            return
        if epoch is not None:
            # route through promise(): a begin from a NEWER leadership must
            # also abandon any proposal WE have in flight (collect/victory
            # frames can be lost; the begin may be the first we hear of it)
            self.promise(epoch)
        self.pending = (version, value)
        await self.send(from_rank, {"op": "accept", "version": version,
                                    "epoch": epoch if epoch is not None
                                    else self.promised_epoch})

    def handle_commit(self, version: int, value: bytes,
                      epoch: Optional[int] = None) -> None:
        if epoch is not None and epoch < self.promised_epoch:
            return  # a deposed leader's commit must not land
        if epoch is not None:
            self.promise(epoch)  # same deposition semantics as handle_begin
        if self.pending and self.pending[0] == version:
            self.pending = None
        if version > self.store.last_committed:
            self.store.commit(version, value)
            if self.on_commit:
                self.on_commit(version, value)
