"""Proposal drift safety: generation stamps, topology fingerprints, and
pre-dispatch revalidation.

A proposal batch is computed against monitor generation N and a topology
snapshot; nothing in the reference protects the window between model build
and dispatch — brokers can die, topics can vanish, replicas can move at
generation N+k and the executor would actuate the stale plan blindly.
Stream-reconfiguration work treats reconfiguration as continuous rather than
episodic (PAPERS.md, arxiv 1602.03770); this module gives the executor the
tools to treat every batch boundary as a revalidation point:

  * `TopologyFingerprint` — a compact structural digest (broker set + alive
    mask + per-topic partition counts) stamped onto every `OptimizerResult`
    at model-build time by the facade;
  * `validate_proposal` / `validate_proposals` — per-proposal checks of a
    stamped plan against FRESH `ClusterTopology`: the partition must still
    exist and still mean the same topic-partition, destinations must be
    alive and in range, the replica set must still match the plan's view,
    and the replication factor must be unchanged. Invalid proposals are
    *trimmed* with a reason code, never dispatched and never raised
    (docs/RESILIENCE.md never-raise contract).

Reason codes (the `trimmedByReason` vocabulary in the execution summary,
`/state`, and the `Executor.proposal-trimmed.*` meters):

  TOPIC_GONE          the proposal's topic no longer has any partitions
  PARTITION_GONE      the dense partition index is out of range / the
                      topic's partition index vanished
  PARTITION_REMAPPED  the dense index now addresses a DIFFERENT
                      topic-partition (rows shifted under the plan)
  DEST_INVALID        a destination broker index is out of range
  DEST_DEAD           a destination broker (added replica or new leader)
                      is dead
  RF_CHANGED          the partition's replication factor changed since the
                      plan was built
  REPLICA_MOVED       the current replica set no longer matches the plan's
                      old set (a concurrent reassignment won)
  GENERATION_SKEW     batch-level: monitor generation drifted past
                      `executor.proposal.max.generation.skew`; the whole
                      batch aborts and the detector is asked to recompute
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from cruise_control_torch.analyzer.proposals import ExecutionProposal
from cruise_control_torch.common.resources import BrokerState

# -- reason codes --------------------------------------------------------------

TOPIC_GONE = "TOPIC_GONE"
PARTITION_GONE = "PARTITION_GONE"
PARTITION_REMAPPED = "PARTITION_REMAPPED"
DEST_INVALID = "DEST_INVALID"
DEST_DEAD = "DEST_DEAD"
RF_CHANGED = "RF_CHANGED"
REPLICA_MOVED = "REPLICA_MOVED"
GENERATION_SKEW = "GENERATION_SKEW"

REASON_CODES = (
    TOPIC_GONE, PARTITION_GONE, PARTITION_REMAPPED, DEST_INVALID,
    DEST_DEAD, RF_CHANGED, REPLICA_MOVED, GENERATION_SKEW,
)


# -- topology fingerprint ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopologyFingerprint:
    """Compact structural snapshot of the cluster at model-build time.

    Deliberately load-free: a fingerprint changes exactly when something a
    proposal references can have changed meaning — the broker set, broker
    liveness, or the per-topic partition layout. Load drift is the
    optimizer's business, not admission's."""

    num_brokers: int
    #: per-broker liveness (True = not DEAD); index-aligned with the model
    alive: Tuple[bool, ...]
    #: (topic name, partition count), sorted by name; topics with zero
    #: partitions are absent (a deleted topic drops out)
    topic_partitions: Tuple[Tuple[str, int], ...]

    @classmethod
    def from_topology(cls, topo) -> "TopologyFingerprint":
        """Build from a monitor.metadata.ClusterTopology."""
        state = np.asarray(topo.broker_state)
        tids, counts = np.unique(np.asarray(topo.topic_id), return_counts=True)
        tp = tuple(sorted(
            (topo.topic_names[int(t)], int(c)) for t, c in zip(tids, counts)
        ))
        return cls(
            num_brokers=int(state.shape[0]),
            alive=tuple((state != BrokerState.DEAD).tolist()),
            topic_partitions=tp,
        )

    @property
    def num_alive(self) -> int:
        return sum(self.alive)

    @property
    def num_partitions(self) -> int:
        return sum(c for _, c in self.topic_partitions)

    @property
    def digest(self) -> str:
        """Stable short hex digest for logs/summaries."""
        h = hashlib.sha1(repr(
            (self.num_brokers, self.alive, self.topic_partitions)
        ).encode())
        return h.hexdigest()[:12]

    def diff(self, other: "TopologyFingerprint") -> Dict:
        """Human-attributable drift summary (self = at build, other = now)."""
        before = dict(self.topic_partitions)
        after = dict(other.topic_partitions)
        died = [
            i for i in range(min(self.num_brokers, other.num_brokers))
            if self.alive[i] and not other.alive[i]
        ]
        revived = [
            i for i in range(min(self.num_brokers, other.num_brokers))
            if not self.alive[i] and other.alive[i]
        ]
        return {
            "brokerCountDelta": other.num_brokers - self.num_brokers,
            "brokersDied": died,
            "brokersRevived": revived,
            "topicsGone": sorted(set(before) - set(after)),
            "topicsAdded": sorted(set(after) - set(before)),
            "partitionCountChanged": sorted(
                t for t in set(before) & set(after) if before[t] != after[t]
            ),
        }

    def to_dict(self) -> Dict:
        return {
            "digest": self.digest,
            "numBrokers": self.num_brokers,
            "numAlive": self.num_alive,
            "numPartitions": self.num_partitions,
            "numTopics": len(self.topic_partitions),
        }


# -- fresh-topology view -------------------------------------------------------


class TopologyView:
    """Lookup-friendly wrapper over one fresh ClusterTopology snapshot.

    Built once per revalidation round and consulted per proposal. The fast
    path is O(T) to build (per-topic partition counts via one bincount) and
    O(1) per proposal; the O(P) name scan runs only on the error path (a
    proposal whose dense row shifted), so revalidating a batch stays a
    rounding error next to one driver dispatch even at 200k partitions."""

    def __init__(self, topo):
        self._topo = topo
        self._assignment = np.asarray(topo.assignment)
        self._state = np.asarray(topo.broker_state)
        self.num_brokers = int(self._state.shape[0])
        self.num_partitions = int(self._assignment.shape[0])
        self._topic_id = np.asarray(topo.topic_id)
        self._pindex = np.asarray(topo.partition_index)
        self._names = topo.topic_names
        self._topic_index: Dict[str, int] = {
            n: i for i, n in enumerate(self._names)
        }
        counts = (
            np.bincount(self._topic_id, minlength=len(self._names))
            if self.num_partitions else np.zeros(len(self._names), dtype=np.int64)
        )
        #: topic name -> partition count; topics with zero partitions absent
        self.partitions_of_topic: Dict[str, int] = {
            n: int(counts[i]) for i, n in enumerate(self._names) if counts[i]
        }

    def replicas(self, row: int) -> Tuple[int, ...]:
        return tuple(int(b) for b in self._assignment[row] if b >= 0)

    def broker_dead(self, b: int) -> bool:
        return bool(self._state[b] == BrokerState.DEAD)

    def name_of(self, row: int) -> str:
        """'topic-partitionIndex' rendering of a dense row."""
        return f"{self._names[int(self._topic_id[row])]}-{int(self._pindex[row])}"

    def row_of(self, name: str) -> Optional[int]:
        """Dense row of a topic-partition name in THIS snapshot, or None.
        Vectorized O(P) scan — error/remap path only, never the batch loop."""
        topic, _, pi = name.rpartition("-")
        t = self._topic_index.get(topic)
        if t is None or not pi.isdigit():
            return None
        hits = np.nonzero((self._topic_id == t) & (self._pindex == int(pi)))[0]
        return int(hits[0]) if hits.size else None

    def items(self):
        """Iterate (topic-partition name, dense row) pairs of this snapshot."""
        return ((self.name_of(r), r) for r in range(self.num_partitions))

    def resolve(self, p: ExecutionProposal) -> Tuple[Optional[int], Optional[str]]:
        """-> (dense row the DRIVER would address, reason code or None).

        Drivers address partitions by the proposal's dense index, so the
        check anchors there; the topic-partition name (when stamped) is the
        identity cross-check that catches rows shifting underneath the plan
        (e.g. a topic deleted mid-batch renumbers everything after it)."""
        if p.topic_partition is not None:
            topic, _, _ = p.topic_partition.rpartition("-")
            if topic and topic not in self.partitions_of_topic:
                return None, TOPIC_GONE
            if (
                p.partition >= self.num_partitions
                or self.name_of(p.partition) != p.topic_partition
            ):
                # the named partition may survive at another row, but the
                # executor's dense addressing is stale either way
                if self.row_of(p.topic_partition) is None:
                    return None, PARTITION_GONE
                return None, PARTITION_REMAPPED
            return p.partition, None
        if p.partition >= self.num_partitions:
            return None, PARTITION_GONE
        return p.partition, None


def validate_proposal(p: ExecutionProposal, view: TopologyView) -> Optional[str]:
    """Reason code if the proposal must be trimmed, None when still valid."""
    row, err = view.resolve(p)
    if err is not None:
        return err
    for b in p.replicas_to_add:
        if b < 0 or b >= view.num_brokers:
            return DEST_INVALID
        if view.broker_dead(b):
            return DEST_DEAD
    current = view.replicas(row)
    if p.has_replica_action:
        if len(current) != len(p.old_replicas):
            return RF_CHANGED
        if set(current) != set(p.old_replicas):
            return REPLICA_MOVED
    else:  # leadership-only movement
        if p.new_leader not in current:
            return REPLICA_MOVED
    if p.new_leader >= view.num_brokers:
        return DEST_INVALID
    if p.new_leader >= 0 and view.broker_dead(p.new_leader):
        return DEST_DEAD
    return None


def validate_proposals(
    proposals, topo
) -> Tuple[List[ExecutionProposal], List[Tuple[ExecutionProposal, str]]]:
    """Split proposals into (still valid, [(stale, reason), ...]) against a
    fresh topology snapshot."""
    view = TopologyView(topo)
    valid: List[ExecutionProposal] = []
    trimmed: List[Tuple[ExecutionProposal, str]] = []
    for p in proposals:
        reason = validate_proposal(p, view)
        if reason is None:
            valid.append(p)
        else:
            trimmed.append((p, reason))
    return valid, trimmed
