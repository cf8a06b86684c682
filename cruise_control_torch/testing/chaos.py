"""Seeded chaos replay harness: perturbations streamed mid-execution.

A load-replay harness that streams perturbations while the executor is
mid-batch, for the drift layer (executor/validation.py). It composes three
pieces:

  * `ChaosPlan` — a deterministic schedule of `Perturbation`s (broker
    death/revival, topic delete, partition-count change, hot-load spike,
    synthetic generation bumps) keyed by driver poll count, applied to the
    SimulatedCluster from inside the driver's poll loop — i.e. exactly
    between the executor's batch boundaries, never concurrently with a
    dispatch;
  * `InvariantChecker` — consulted at every dispatch: no task may go to a
    dead or out-of-range broker, no task may reference a vanished
    partition/replica, and end-to-end the replication factor of every
    surviving partition must be preserved. Violations are RECORDED (not
    raised) so a test can assert the full picture;
  * `ChaosReplayDriver` — a SimulatorClusterDriver that advances the plan on
    every poll, checks invariants on every dispatch, and resolves in-flight
    movements by topic-partition NAME when topology rows shift underneath
    them (a deleted topic renumbers the dense axis; a real controller keys
    on names, so the harness must too).

Protocol-level faults (the JAX package's testing/faults.py, which this
package takes with the cluster agent's wire) compose with this: a FaultPlan
drives the wire, a ChaosPlan drives the cluster.

Typical use (tests/test_torch_chaos.py runs it beside the JAX package's):

    sim = SimulatedCluster(random_cluster(...))
    plan = ChaosPlan([Perturbation(at_poll=2, action="kill_broker", broker=3)])
    harness = ChaosHarness(sim, plan)
    summary = harness.execute(harness.stamped_proposals(seed=7, count=40))
    assert harness.checker.violations == []
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from cruise_control_torch.analyzer.proposals import ExecutionProposal
from cruise_control_torch.common.resources import BrokerState
from cruise_control_torch.executor.driver import SimulatorClusterDriver
from cruise_control_torch.executor.executor import Executor, ExecutorConfig
from cruise_control_torch.executor.task import ExecutionTask, TaskType
from cruise_control_torch.executor.validation import TopologyFingerprint, TopologyView
from cruise_control_torch.monitor.metadata import MetadataClient

ACTIONS = (
    "kill_broker", "restore_broker", "revive_broker", "delete_topic",
    "add_partitions", "spike_load", "bump_generation",
)


@dataclasses.dataclass
class Perturbation:
    """One scheduled cluster mutation. `at_poll` is the driver poll count at
    (or after) which it fires; rows with the same at_poll fire in order."""

    at_poll: int
    action: str
    broker: int = -1
    topic: int = -1
    count: int = 1
    factor: float = 4.0

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown perturbation action {self.action!r}")

    def apply(self, sim, plan: "ChaosPlan") -> None:
        if self.action == "kill_broker":
            sim.kill_broker(self.broker)
        elif self.action == "restore_broker":
            sim.restore_broker(self.broker)
        elif self.action == "revive_broker":
            sim.revive_broker(self.broker)
        elif self.action == "delete_topic":
            sim.delete_topic(self.topic)
        elif self.action == "add_partitions":
            sim.add_partitions(self.topic, self.count)
        elif self.action == "spike_load":
            sim.spike_load(self.topic, self.factor)
        else:  # bump_generation: pure monitor-side drift, no cluster change
            plan.generation_bumps += self.count


class ChaosPlan:
    """Ordered, deterministic perturbation schedule."""

    def __init__(self, perturbations=()):
        self._pending: List[Perturbation] = sorted(
            perturbations, key=lambda p: p.at_poll
        )
        #: every perturbation actually applied, in order (for assertions)
        self.applied: List[Dict] = []
        #: synthetic monitor-generation drift (bump_generation actions)
        self.generation_bumps = 0

    def add(self, p: Perturbation) -> "ChaosPlan":
        self._pending.append(p)
        self._pending.sort(key=lambda x: x.at_poll)
        return self

    def advance(self, sim, poll: int) -> int:
        """Apply every perturbation due at `poll`; returns how many fired."""
        fired = 0
        while self._pending and self._pending[0].at_poll <= poll:
            p = self._pending.pop(0)
            p.apply(sim, self)
            self.applied.append({**dataclasses.asdict(p), "firedAtPoll": poll})
            fired += 1
        return fired

    @property
    def exhausted(self) -> bool:
        return not self._pending


class InvariantChecker:
    """Dispatch-time + end-to-end safety assertions, recorded not raised."""

    def __init__(self, sim):
        self._sim = sim
        self.violations: List[Dict] = []
        self.dispatches = 0
        #: pre-execution RF keyed by topic-partition name
        view = TopologyView(sim.fetch_topology())
        self._initial_rf: Dict[str, int] = {
            name: len(view.replicas(row)) for name, row in view.items()
        }

    def _violate(self, kind: str, task: ExecutionTask, detail: str) -> None:
        self.violations.append({
            "kind": kind,
            "executionId": task.execution_id,
            "partition": task.proposal.partition,
            "topicPartition": task.proposal.topic_partition,
            "detail": detail,
        })

    def check_dispatch(self, task: ExecutionTask,
                       view: Optional[TopologyView] = None) -> None:
        """No dispatch to a dead/invalid broker; no dispatch referencing a
        vanished partition or replica — checked against the cluster's
        CURRENT ground truth, not the executor's view (`view`, when the
        caller holds the current one; else fetched)."""
        self.dispatches += 1
        if view is None:
            view = TopologyView(self._sim.fetch_topology())
        p = task.proposal
        for b in p.replicas_to_add:
            if b < 0 or b >= view.num_brokers:
                self._violate("DISPATCH_TO_INVALID_BROKER", task, f"dest {b}")
            elif view.broker_dead(b):
                self._violate("DISPATCH_TO_DEAD_BROKER", task, f"dest {b}")
        row, err = view.resolve(p)
        if err is not None:
            self._violate("DISPATCH_TO_VANISHED_PARTITION", task, err)
            return
        current = view.replicas(row)
        for b in p.replicas_to_remove:
            if b not in current:
                self._violate("DISPATCH_REFERENCES_VANISHED_REPLICA", task,
                              f"source {b} not in {current}")
        if task.task_type == TaskType.LEADER_ACTION:
            if p.new_leader not in current:
                self._violate("DISPATCH_REFERENCES_VANISHED_REPLICA", task,
                              f"leader {p.new_leader} not in {current}")
            elif view.broker_dead(p.new_leader):
                self._violate("DISPATCH_TO_DEAD_BROKER", task,
                              f"leader {p.new_leader}")

    def check_dense_masks(self) -> List[Dict]:
        """The simulator's dense arrays must stay mutually consistent after
        every perturbation — the same alignment contract build_static_ctx
        and the incremental delta kernel (analyzer/incremental.py) assume
        when they derive alive/valid masks from these arrays. Checked after
        each poll; violations are recorded under DENSE_MASK_INCONSISTENT."""
        topo = self._sim.fetch_topology()
        a = np.asarray(topo.assignment)
        tid = np.asarray(topo.topic_id)
        pidx = np.asarray(topo.partition_index)
        state = np.asarray(topo.broker_state)
        rack = np.asarray(topo.broker_rack)
        host = np.asarray(topo.broker_host)
        num_brokers = int(state.shape[0])

        def bad(detail: str) -> None:
            self.violations.append({
                "kind": "DENSE_MASK_INCONSISTENT", "detail": detail,
            })

        if not (a.shape[0] == tid.shape[0] == pidx.shape[0]):
            bad(f"partition axes diverge: assignment {a.shape[0]}, "
                f"topic_id {tid.shape[0]}, partition_index {pidx.shape[0]}")
        if not (rack.shape[0] == host.shape[0] == num_brokers):
            bad(f"broker axes diverge: state {num_brokers}, "
                f"rack {rack.shape[0]}, host {host.shape[0]}")
        if tid.size and (tid.min() < 0 or tid.max() >= len(topo.topic_names)):
            bad(f"topic_id out of range [0, {len(topo.topic_names)}): "
                f"[{tid.min()}, {tid.max()}]")
        if a.size and (a.min() < -1 or a.max() >= num_brokers):
            bad(f"assignment broker index out of range [-1, {num_brokers}): "
                f"[{a.min()}, {a.max()}]")
        if a.size and (a[:, 0] < 0).any():
            rows = np.nonzero(a[:, 0] < 0)[0][:8]
            bad(f"leaderless partitions (slot 0 empty): rows {rows.tolist()}")
        valid_states = {int(s) for s in (
            BrokerState.ALIVE, BrokerState.NEW, BrokerState.DEMOTED,
            BrokerState.DEAD,
        )}
        unknown = sorted(set(int(s) for s in state) - valid_states)
        if unknown:
            bad(f"unknown broker states {unknown}")
        return self.violations

    def check_final(self) -> List[Dict]:
        """Replication factor preserved end-to-end for every partition that
        survived the run (deleted topics are exempt; added partitions have
        no baseline). Appends to (and returns) the violation list."""
        view = TopologyView(self._sim.fetch_topology())
        for name, row in view.items():
            initial = self._initial_rf.get(name)
            if initial is None:
                continue
            rf = len(view.replicas(row))
            if rf != initial:
                self.violations.append({
                    "kind": "RF_NOT_PRESERVED",
                    "topicPartition": name,
                    "detail": f"rf {initial} -> {rf}",
                })
        return self.violations


class ChaosReplayDriver(SimulatorClusterDriver):
    """SimulatorClusterDriver that advances a ChaosPlan on every poll, runs
    the InvariantChecker on every dispatch, and keys in-flight movements by
    topic-partition name so a mid-flight dense-index shift (topic delete)
    lands on the right partition — or evaporates with its topic — exactly
    like a name-keyed controller."""

    def __init__(self, sim, plan: ChaosPlan, checker: InvariantChecker,
                 latency_polls: int = 1):
        super().__init__(sim, latency_polls=latency_polls)
        self._plan = plan
        self._checker = checker
        self.polls = 0
        #: in-flight movements whose partition vanished mid-flight
        self.evaporated: List[int] = []
        #: the current topology, built at first use after each poll. The
        #: harness changes the simulator only inside poll() (the plan's
        #: perturbations, then the movements it applies), so between two
        #: polls one view serves every dispatch check and re-addressing,
        #: where building one a call costs O(partitions) each time (~3 a
        #: task: 484 s of a 55,884-task run on 199,518 partitions)
        self._view: Optional[TopologyView] = None

    def _topology(self) -> TopologyView:
        if self._view is None:
            self._view = TopologyView(self._sim.fetch_topology())
        return self._view

    # -- chaos injection -------------------------------------------------------

    def poll(self) -> None:
        self.polls += 1
        fired = self._plan.advance(self._sim, self.polls)
        self._view = None
        if fired:
            # only perturbations can break dense-array alignment, so the
            # mask audit rides the polls where something actually fired
            self._checker.check_dense_masks()
        # the movements applied here change replica sets, never the rows and
        # names that _current reads, so its view holds through this poll
        super().poll()
        self._view = None

    # -- name-keyed addressing -------------------------------------------------

    def _current(self, task: ExecutionTask) -> Optional[ExecutionTask]:
        """The task re-addressed against CURRENT topology (dense rows may
        have shifted); None when its partition no longer exists."""
        view = self._topology()
        name = task.proposal.topic_partition
        if name is None:
            return task if task.proposal.partition < view.num_partitions else None
        row = view.row_of(name)
        if row is None:
            return None
        if row == task.proposal.partition:
            return task
        return ExecutionTask(
            task.execution_id,
            dataclasses.replace(task.proposal, partition=row),
            task.task_type,
        )

    def _apply(self, task: ExecutionTask) -> None:
        current = self._current(task)
        if current is None:
            self.evaporated.append(task.execution_id)
            return
        super()._apply(current)

    def is_finished(self, task: ExecutionTask) -> bool:
        with self._lock:
            if task.execution_id in self._pending:
                return False
        current = self._current(task)
        if current is None:
            return True  # partition vanished: nothing left to wait for
        return super().is_finished(current)

    # -- invariant checks ------------------------------------------------------

    def start_replica_movement(self, task: ExecutionTask) -> None:
        self._checker.check_dispatch(task, self._topology())
        super().start_replica_movement(task)

    def start_leadership_movement(self, task: ExecutionTask) -> None:
        self._checker.check_dispatch(task, self._topology())
        super().start_leadership_movement(task)


class ChaosHarness:
    """One-stop wiring: simulator + chaos driver + drift-validating executor.

    The executor revalidates against a zero-TTL MetadataClient over the
    simulator (always fresh) and reads its generation through the plan (so
    `bump_generation` perturbations model pure monitor-side drift)."""

    def __init__(self, sim, plan: ChaosPlan, latency_polls: int = 2,
                 config: Optional[ExecutorConfig] = None):
        self.sim = sim
        self.plan = plan
        self.metadata = MetadataClient(sim.fetch_topology, ttl_s=0.0)
        self.checker = InvariantChecker(sim)
        self.driver = ChaosReplayDriver(sim, plan, self.checker,
                                        latency_polls=latency_polls)
        # per-broker concurrency 1 + multi-poll movement latency force MANY
        # batch boundaries, so perturbations land mid-batch by construction;
        # the 5ms progress interval keeps revalidation overhead honest
        # (<2% of batch wall) without making the suite slow
        self.executor = Executor(
            self.driver,
            config=config or ExecutorConfig(
                num_concurrent_partition_movements_per_broker=1,
                execution_progress_check_interval_s=0.005,
            ),
            topology_source=lambda: self.metadata.refresh_metadata(force=True),
            generation_source=self._generation,
        )

    def _generation(self) -> int:
        self.metadata.refresh_metadata(force=True)
        return self.metadata.generation + self.plan.generation_bumps

    def stamped_proposals(self, seed: int, count: int) -> Tuple[
        List[ExecutionProposal], int, TopologyFingerprint
    ]:
        """Deterministic movement proposals against the CURRENT topology
        (compile-free: hand-diffed, not optimizer output), plus the
        generation/fingerprint stamps the facade would attach."""
        rng = np.random.default_rng(seed)
        topo = self.metadata.refresh_metadata(force=True)
        view = TopologyView(topo)
        a = np.asarray(topo.assignment)
        proposals: List[ExecutionProposal] = []
        rows = rng.permutation(view.num_partitions)
        for row in rows:
            if len(proposals) >= count:
                break
            old = view.replicas(int(row))
            if not old:
                continue
            candidates = [b for b in range(view.num_brokers)
                          if b not in old and not view.broker_dead(b)]
            if not candidates:
                continue
            name = view.name_of(int(row))
            if rng.random() < 0.25 and len(old) > 1:
                # leadership-only movement to an existing follower
                new = (old[1],) + (old[0],) + tuple(old[2:])
            else:
                src_slot = int(rng.integers(len(old)))
                dst = candidates[int(rng.integers(len(candidates)))]
                new = tuple(dst if i == src_slot else b
                            for i, b in enumerate(old))
            proposals.append(ExecutionProposal(
                partition=int(row), old_replicas=old, new_replicas=new,
                topic_partition=name,
            ))
        generation = self._generation()
        fingerprint = TopologyFingerprint.from_topology(topo)
        return proposals, generation, fingerprint

    def execute(self, stamped) -> Dict:
        """Run the batch through the executor, then the end-to-end RF check;
        returns the execution summary."""
        proposals, generation, fingerprint = stamped
        summary = self.executor.execute_proposals(
            proposals, generation=generation, fingerprint=fingerprint
        )
        self.checker.check_final()
        return summary
