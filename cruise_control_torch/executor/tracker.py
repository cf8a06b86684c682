"""Task-state aggregation for observability.

Analog of ExecutionTaskTracker (cc/executor/ExecutionTaskTracker.java):
counts by (type, state) for the /state endpoint and sensors, plus a
per-execution terminal-event log (executionId, state, start/end times,
reason) so the summary and op_log can attribute WHICH tasks died and why.

Thread-safety: the executor's poll loop mutates this tracker while REST
server threads render `/state` from it, so all aggregate state is guarded
by the tracker's own lock (the `#: guarded_by(_lock)` contract is enforced
by cclint's `conc-guarded-by` rule — docs/LINTING.md)."""

from __future__ import annotations

import threading
from typing import Dict, List

from cruise_control_torch.executor.task import ExecutionTask, TaskState, TaskType

#: terminal events kept per execution (ABORTED/DEAD first, so failures are
#: never truncated away by a large completed count)
_MAX_TERMINAL_EVENTS = 200


class ExecutionTaskTracker:
    def __init__(self):
        self._lock = threading.Lock()
        self._latest: Dict[int, ExecutionTask] = {}  #: guarded_by(_lock)
        self._terminal_events: List[Dict] = []  #: guarded_by(_lock)

    def observe(self, task: ExecutionTask) -> None:
        with self._lock:
            self._latest[task.execution_id] = task

    def record_terminal(self, task: ExecutionTask) -> None:
        """One terminal transition (COMPLETED/ABORTED/DEAD), with timing and
        reason — wired from the ExecutionTask listener."""
        with self._lock:
            self._latest[task.execution_id] = task
            if len(self._terminal_events) < _MAX_TERMINAL_EVENTS:
                self._terminal_events.append({
                    "executionId": task.execution_id,
                    "type": task.task_type.name,
                    "state": task.state.name,
                    "startTimeMs": task.start_time_ms,
                    "endTimeMs": task.end_time_ms,
                    "reason": task.terminal_reason,
                    # GET /explain join key (empty when the batch carried no
                    # recorded decision ledger)
                    "provenanceId": task.provenance_id,
                })

    def terminal_events(self, only_failures: bool = False) -> List[Dict]:
        with self._lock:
            events = list(self._terminal_events)
        if only_failures:
            return [e for e in events if e["state"] != TaskState.COMPLETED.name]
        return events

    def reset(self) -> None:
        """Drop prior-execution tasks (summaries are per execution; without
        this, a long-lived service accumulates every task ever run)."""
        with self._lock:
            self._latest.clear()
            self._terminal_events.clear()

    def counts(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            tasks = list(self._latest.values())
        out = {
            t.name: {s.name: 0 for s in TaskState} for t in TaskType
        }
        for task in tasks:
            out[task.task_type.name][task.state.name] += 1
        return out

    def summary(self) -> Dict:
        c = self.counts()
        by_state = {
            s.name: sum(v[s.name] for v in c.values()) for s in TaskState
        }
        return {
            "numTotalMovements": sum(sum(v.values()) for v in c.values()),
            "numFinishedMovements": sum(
                v[TaskState.COMPLETED.name] + v[TaskState.ABORTED.name] + v[TaskState.DEAD.name]
                for v in c.values()
            ),
            "numInProgressMovements": sum(v[TaskState.IN_PROGRESS.name] for v in c.values()),
            "numAbortedOrDead": sum(
                v[TaskState.ABORTED.name] + v[TaskState.DEAD.name] for v in c.values()
            ),
            "byState": by_state,
        }
