"""Execution task planner.

Analog of ExecutionTaskPlanner (cc/executor/ExecutionTaskPlanner.java:48):
turns proposals into tasks (skipping no-ops against the current cluster
state), orders each broker's replica movements through the strategy chain,
and hands out executable batches respecting per-broker in-flight limits.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from cruise_control_torch.analyzer.proposals import ExecutionProposal
from cruise_control_torch.executor.strategy import (
    BaseReplicaMovementStrategy,
    ReplicaMovementStrategy,
)
from cruise_control_torch.executor.task import ExecutionTask, TaskState, TaskType


class ExecutionTaskPlanner:
    def __init__(self, default_strategy: Optional[ReplicaMovementStrategy] = None):
        import time

        self._strategy = default_strategy or BaseReplicaMovementStrategy()
        # ids are epoch-seeded so they are unique ACROSS process restarts:
        # external drivers (ReassignmentJournalDriver) key completion acks by
        # execution id on shared storage, and a restarted process reusing id
        # 0 could be spuriously "completed" by an ack written for its
        # predecessor. Microsecond granularity: supervisors restart within
        # the same second, which a seconds-based seed would collide on.
        self._execution_id = time.time_ns() // 1_000
        self._remaining_moves: List[ExecutionTask] = []
        self._remaining_leaderships: List[ExecutionTask] = []

    def add_execution_proposals(
        self,
        proposals: Sequence[ExecutionProposal],
        current_assignment=None,
        strategy: Optional[ReplicaMovementStrategy] = None,
        urp: Optional[Set[int]] = None,
        provenance_run: Optional[str] = None,
    ) -> None:
        """Register proposals, dropping no-ops against `current_assignment`
        (a dict partition -> tuple of current replicas, or None to trust the
        proposals' old state). `provenance_run` is the MoveLedger run id the
        batch was computed under; each task is stamped with its proposal's
        provenance id (`<run>/p<partition>`) so terminal events and drift
        trims join back to GET /explain."""
        def pid(p: ExecutionProposal) -> str:
            return f"{provenance_run}/p{p.partition}" if provenance_run else ""

        for p in proposals:
            current = (
                tuple(current_assignment[p.partition])
                if current_assignment is not None and p.partition in current_assignment
                else p.old_replicas
            )
            if p.has_replica_action and not p.is_completed(current):
                self._remaining_moves.append(
                    ExecutionTask(
                        self._next_id(), p, TaskType.INTER_BROKER_REPLICA_ACTION,
                        provenance_id=pid(p),
                    )
                )
            elif p.has_leader_action and (not current or current[0] != p.new_leader):
                self._remaining_leaderships.append(
                    ExecutionTask(
                        self._next_id(), p, TaskType.LEADER_ACTION,
                        provenance_id=pid(p),
                    )
                )
        use = strategy or self._strategy
        self._remaining_moves = use.apply(self._remaining_moves, urp)

    def _next_id(self) -> int:
        i = self._execution_id
        self._execution_id += 1
        return i

    @property
    def remaining_inter_broker_replica_movements(self) -> List[ExecutionTask]:
        return [t for t in self._remaining_moves if t.state == TaskState.PENDING]

    @property
    def remaining_leadership_movements(self) -> List[ExecutionTask]:
        return [t for t in self._remaining_leaderships if t.state == TaskState.PENDING]

    def get_inter_broker_replica_movement_tasks(
        self, available_slots_by_broker: Dict[int, int], max_tasks: int = 1 << 30
    ) -> List[ExecutionTask]:
        """Drain pending movement tasks whose involved brokers all have
        in-flight budget (ExecutionTaskPlanner.getInterBrokerReplicaMovementTasks).
        Mutates the passed availability map as it assigns."""
        out: List[ExecutionTask] = []
        for task in self._remaining_moves:
            if len(out) >= max_tasks:
                break
            if task.state != TaskState.PENDING:
                continue
            brokers = task.involved_brokers
            if all(available_slots_by_broker.get(b, 0) > 0 for b in brokers):
                for b in brokers:
                    available_slots_by_broker[b] -= 1
                out.append(task)
        return out

    def get_leadership_movement_tasks(self, max_tasks: int) -> List[ExecutionTask]:
        out = []
        for task in self._remaining_leaderships:
            if len(out) >= max_tasks:
                break
            if task.state == TaskState.PENDING:
                out.append(task)
        return out

    def clear(self) -> None:
        self._remaining_moves.clear()
        self._remaining_leaderships.clear()
