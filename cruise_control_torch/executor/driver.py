"""Cluster driver SPI — the ZK/admin bridge boundary.

Analog of the Scala ExecutorUtils shim (scala/executor/ExecutorUtils.scala:22:
write reassignment JSON to ZK, trigger preferred leader election, poll
progress). Anything that can start a replica movement and report its
completion can drive the executor; the simulator-backed driver closes the
loop in-process, with configurable completion latency to exercise the
executor's polling."""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

from cruise_control_torch.executor.task import ExecutionTask, TaskType


class ClusterDriver:
    def start_replica_movement(self, task: ExecutionTask) -> None:
        """Begin moving replicas for the task's proposal (async)."""
        raise NotImplementedError

    def start_leadership_movement(self, task: ExecutionTask) -> None:
        raise NotImplementedError

    def poll(self) -> None:
        """Advance/refresh driver state (one reassignment-znode poll round)."""

    def is_finished(self, task: ExecutionTask) -> bool:
        raise NotImplementedError

    def has_ongoing_reassignment(self) -> bool:
        """Executor refuses to start over an in-progress external
        reassignment (cc/executor/Executor.java:494)."""
        return False


class SimulatorClusterDriver(ClusterDriver):
    """Drives a cruise_control_torch.testing.SimulatedCluster.

    `latency_polls` simulates data-movement time: a movement completes only
    after that many poll() rounds, forcing the executor through its
    wait-for-finish loop."""

    def __init__(self, sim, latency_polls: int = 0):
        self._sim = sim
        self._latency = latency_polls
        self._pending: Dict[int, Tuple[ExecutionTask, int]] = {}
        self._lock = threading.Lock()

    def start_replica_movement(self, task: ExecutionTask) -> None:
        with self._lock:
            self._pending[task.execution_id] = (task, self._latency)

    def start_leadership_movement(self, task: ExecutionTask) -> None:
        with self._lock:
            self._pending[task.execution_id] = (task, self._latency)

    def poll(self) -> None:
        with self._lock:
            for eid, (task, remaining) in list(self._pending.items()):
                if remaining > 0:
                    self._pending[eid] = (task, remaining - 1)
                    continue
                self._apply(task)
                del self._pending[eid]

    def _apply(self, task: ExecutionTask) -> None:
        p = task.proposal
        if task.task_type == TaskType.INTER_BROKER_REPLICA_ACTION:
            removed = list(p.replicas_to_remove)
            adds = list(p.replicas_to_add)
            for i, dst in enumerate(adds):
                if i < len(removed):
                    self._sim.apply_movement(p.partition, removed[i], dst)
                else:
                    self._sim.add_replica(p.partition, dst)  # RF increase
            for src in removed[len(adds):]:  # RF decrease
                self._sim.remove_replica(p.partition, src)
            if p.has_leader_action:
                self._sim.apply_leadership(p.partition, p.new_leader)
        else:
            self._sim.apply_leadership(p.partition, p.new_leader)

    def is_finished(self, task: ExecutionTask) -> bool:
        with self._lock:
            if task.execution_id in self._pending:
                return False
        p = task.proposal
        if task.task_type == TaskType.LEADER_ACTION:
            return self._sim.leader_of(p.partition) == p.new_leader
        return all(self._sim.has_partition(p.partition, b) for b in p.replicas_to_add) and not any(
            self._sim.has_partition(p.partition, b) for b in p.replicas_to_remove
        )

    def has_ongoing_reassignment(self) -> bool:
        with self._lock:
            return bool(self._pending)


class ReassignmentJournalDriver(ClusterDriver):
    """File-journal driver: the direct analog of the reference's Scala shim
    writing reassignment JSON for the Kafka controller to act on
    (scala/executor/ExecutorUtils.scala:32 writes
    /admin/reassign_partitions; controller performs the movement and deletes
    the node).

    `journal_dir/reassign_partitions.json` holds the in-flight reassignment
    in the controller wire format
    ({"version": 1, "partitions": [{"topic", "partition", "replicas"}]});
    an external controller-side agent applies it and writes per-task acks
    into `journal_dir/completed/<execution_id>.json`. `poll()` merges new
    tasks into the journal (the reference merges with in-progress
    reassignments) and `is_finished` CONSUMES the ack file (reads and
    deletes) — the same write-then-watch contract as the ZK node, over a
    shared filesystem.

    Execution ids are epoch-seeded (ExecutionTaskPlanner starts at
    time_ns//1000 and counts up), so ids never recur across processes and an
    ack file is unambiguous evidence that its journal entry completed.
    Construction RECONCILES rather than sweeps: journal entries whose ack
    already exists are removed (their ack is consumed — the movement finished
    while no driver was watching); journal entries without an ack are KEPT as
    ongoing — `has_ongoing_reassignment` reports them and the executor
    refuses to start over them, mirroring the reference's
    ongoing-reassignment guard (cc/executor/Executor.java:494). Ack files
    matching no journal entry are orphans (their task was already consumed)
    and are deleted."""

    def __init__(self, journal_dir: str):
        import os

        self._dir = journal_dir
        self._completed_dir = os.path.join(journal_dir, "completed")
        os.makedirs(self._completed_dir, exist_ok=True)
        self._journal = os.path.join(journal_dir, "reassign_partitions.json")
        self._lock = threading.Lock()
        acked = set()
        for name in os.listdir(self._completed_dir):
            if name.endswith(".json") and name[:-5].isdigit():
                acked.add(int(name[:-5]))
        entries = self._read_journal()
        remaining = [e for e in entries if e.get("executionId") not in acked]
        if len(remaining) != len(entries):
            self._write_journal(remaining)
        live_ids = {e.get("executionId") for e in remaining}
        for eid in acked:
            if eid not in live_ids:
                try:
                    os.unlink(os.path.join(self._completed_dir, f"{eid}.json"))
                except OSError:
                    pass

    def _read_journal(self) -> List[Dict]:
        import json
        import os

        if not os.path.exists(self._journal):
            return []
        try:
            with open(self._journal) as f:
                return json.load(f).get("partitions", [])
        except (OSError, ValueError):
            return []

    def _write_journal(self, partitions: List[Dict]) -> None:
        import json
        import os

        tmp = self._journal + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "partitions": partitions}, f)
        os.replace(tmp, self._journal)  # atomic, like a ZK setData

    def _entry(self, task: ExecutionTask) -> Dict:
        p = task.proposal
        topic, _, part = (p.topic_partition or f"p-{p.partition}").rpartition("-")
        return {
            "topic": topic or f"p{p.partition}",
            "partition": int(part) if part.isdigit() else p.partition,
            "replicas": list(p.new_replicas),
            "executionId": task.execution_id,
        }

    def start_replica_movement(self, task: ExecutionTask) -> None:
        with self._lock:
            entries = self._read_journal()
            # merge with in-progress reassignments (ExecutorUtils :32 merges
            # into the existing znode content rather than replacing it)
            entries = [
                e for e in entries if e.get("executionId") != task.execution_id
            ] + [self._entry(task)]
            self._write_journal(entries)

    def start_leadership_movement(self, task: ExecutionTask) -> None:
        self.start_replica_movement(task)

    def is_finished(self, task: ExecutionTask) -> bool:
        import os

        ack = os.path.join(self._completed_dir, f"{task.execution_id}.json")
        if not os.path.exists(ack):
            return False
        with self._lock:
            remaining = [
                e
                for e in self._read_journal()
                if e.get("executionId") != task.execution_id
            ]
            self._write_journal(remaining)
            # consume the ack: the journal entry is gone, so the ack has
            # served its purpose and would otherwise accumulate forever
            try:
                os.unlink(ack)
            except OSError:
                pass
        return True

    def has_ongoing_reassignment(self) -> bool:
        return bool(self._read_journal())
