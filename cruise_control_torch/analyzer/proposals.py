"""Execution proposals: the diff between two replica placements.

The analog of AnalyzerUtils.getDiff (cc/analyzer/AnalyzerUtils.java:54,:70)
producing ExecutionProposal records (cc/executor/ExecutionProposal.java:
old/new replica lists, replicasToAdd/Remove :156-163, dataToMoveInMB :184).
Host-side NumPy: proposals leave the device exactly once, at the end of an
optimization run.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from cruise_control_torch.common.resources import PartMetric


@dataclasses.dataclass(frozen=True)
class ExecutionProposal:
    """One partition's reassignment. new_replicas[0] is the new leader
    (matching Partition semantics: cc/model/Partition.java:95)."""

    partition: int
    old_replicas: Tuple[int, ...]
    new_replicas: Tuple[int, ...]
    data_to_move_mb: float = 0.0
    topic_partition: Optional[str] = None  # "topic-3" rendering when metadata given

    @property
    def old_leader(self) -> int:
        return self.old_replicas[0] if self.old_replicas else -1

    @property
    def new_leader(self) -> int:
        return self.new_replicas[0] if self.new_replicas else -1

    @property
    def replicas_to_add(self) -> Tuple[int, ...]:
        return tuple(sorted(set(self.new_replicas) - set(self.old_replicas)))

    @property
    def replicas_to_remove(self) -> Tuple[int, ...]:
        return tuple(sorted(set(self.old_replicas) - set(self.new_replicas)))

    @property
    def has_replica_action(self) -> bool:
        return bool(self.replicas_to_add or self.replicas_to_remove)

    @property
    def has_leader_action(self) -> bool:
        return self.old_leader != self.new_leader

    def is_completed(self, current_replicas: Tuple[int, ...]) -> bool:
        """Replica-set completion predicate (ExecutionProposal.isCompleted)."""
        return tuple(current_replicas) == self.new_replicas

    def to_dict(self) -> dict:
        return {
            "partition": self.partition,
            "topicPartition": self.topic_partition,
            "oldLeader": self.old_leader,
            "oldReplicas": list(self.old_replicas),
            "newReplicas": list(self.new_replicas),
            "dataToMoveMB": round(self.data_to_move_mb, 3),
        }


def proposal_diff(
    init_assignment: np.ndarray,
    final_assignment: np.ndarray,
    part_load: Optional[np.ndarray] = None,
    metadata=None,
) -> List[ExecutionProposal]:
    """Diff two i32[P, R] placements into proposals, vectorized prefilter.

    A partition yields a proposal when its replica *set* or its leader (slot 0)
    changed — same contract as AnalyzerUtils.getDiff.
    """
    init = np.asarray(init_assignment)
    final = np.asarray(final_assignment)
    if init.shape != final.shape:
        raise ValueError("assignment shapes differ")
    changed = np.nonzero((init != final).any(axis=1))[0]
    proposals: List[ExecutionProposal] = []
    for p in changed:
        old = tuple(int(x) for x in init[p] if x >= 0)
        new = tuple(int(x) for x in final[p] if x >= 0)
        if set(old) == set(new) and (not old or old[0] == new[0]):
            continue  # slot shuffle without semantic change
        added = set(new) - set(old)
        mb = 0.0
        if part_load is not None and added:
            mb = float(part_load[p, PartMetric.DISK]) * len(added)
        proposals.append(
            ExecutionProposal(
                partition=int(p),
                old_replicas=old,
                new_replicas=new,
                data_to_move_mb=mb,
                topic_partition=metadata.topic_partition(int(p)) if metadata else None,
            )
        )
    return proposals
