"""The Executor: proposal execution lifecycle.

Analog of cc/executor/Executor.java:58. `execute_proposals` (:288) registers
tasks and runs the execution loop (ProposalExecutionRunnable.execute
:546-626): pause metric sampling, drive inter-broker replica movements in
throttled batches through the ClusterDriver, then leadership movements, poll
until finished, resume sampling. Supports dynamic concurrency changes,
user-triggered graceful stop (:433), an ExecutorNotifier hook, and the
recently-removed/demoted broker history (:234-267).

Resilience contract (docs/RESILIENCE.md): once an execution has started,
`execute_proposals` never raises and never leaves a task in a non-terminal
state. A dispatch failure kills only the failed task (the already-dispatched
remainder keeps draining); a task that outlives `task_deadline_s` is aborted
through the real state machine (IN_PROGRESS → ABORTING → ABORTED) and the
batch continues; a driver that fails `max_consecutive_driver_failures` poll
rounds in a row is declared unreachable and every in-flight task dies. The
returned summary carries per-state counts plus the terminal-event log for
failure attribution.

Drift safety (executor/validation.py): a proposal batch stamped with the
monitor generation and a topology fingerprint is revalidated against FRESH
metadata at admission and again before every dispatch batch. Stale proposals
are trimmed with per-proposal reason codes into the summary's
`proposalValidation` block instead of being dispatched (or raising); when
the monitor generation has drifted past `executor.proposal.max.generation.skew`
the whole batch aborts through the same never-raise contract and the drift
listener (wired by the anomaly detector) is asked to recompute."""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Set

from cruise_control_torch.analyzer.proposals import ExecutionProposal
from cruise_control_torch.executor.driver import ClusterDriver
from cruise_control_torch.executor.manager import ExecutionTaskManager
from cruise_control_torch.executor.planner import ExecutionTaskPlanner
from cruise_control_torch.executor.strategy import ReplicaMovementStrategy
from cruise_control_torch.executor.task import ExecutionTask, TaskState, TaskType
from cruise_control_torch.executor.validation import (
    GENERATION_SKEW,
    TopologyFingerprint,
    TopologyView,
    validate_proposal,
)


@dataclasses.dataclass(frozen=True)
class ExecutorConfig:
    """Defaults mirror config/cruisecontrol.properties."""

    num_concurrent_partition_movements_per_broker: int = 10
    num_concurrent_leader_movements: int = 1000
    execution_progress_check_interval_s: float = 0.01
    max_execution_polls: int = 100_000
    #: how long removed/demoted broker ids stay in history
    removal_history_retention_s: float = 3600.0
    #: per-task wall-clock deadline (`executor.task.deadline.s`): a task
    #: IN_PROGRESS longer than this is aborted (→ ABORTING → ABORTED) and
    #: its broker slots released; 0 disables (the poll cap still bounds the
    #: whole phase)
    task_deadline_s: float = 0.0
    #: consecutive failed driver poll rounds before the driver is declared
    #: unreachable and every in-flight task is killed DEAD
    max_consecutive_driver_failures: int = 10
    #: `executor.proposal.revalidate`: revalidate stamped proposals against
    #: fresh metadata at admission and before every dispatch batch, trimming
    #: stale ones with reason codes instead of dispatching them
    proposal_revalidate: bool = True
    #: `executor.proposal.max.generation.skew`: abort the whole batch (and
    #: ask the detector to recompute) when the monitor generation has moved
    #: more than this past the batch's stamp; 0 disables the abort
    max_generation_skew: int = 8

    @classmethod
    def from_config(cls, config) -> "ExecutorConfig":
        """Map `executor.*` / `num.concurrent.*` keys (config/cruise_config.py)."""
        return cls(
            num_concurrent_partition_movements_per_broker=config.get_int(
                "num.concurrent.partition.movements.per.broker"
            ),
            num_concurrent_leader_movements=config.get_int(
                "num.concurrent.leader.movements"
            ),
            execution_progress_check_interval_s=config.get_long(
                "execution.progress.check.interval.ms"
            ) / 1000.0,
            removal_history_retention_s=config.get_long(
                "removed.broker.history.retention.ms"
            ) / 1000.0,
            task_deadline_s=config.get_double("executor.task.deadline.s"),
            proposal_revalidate=config.get_boolean("executor.proposal.revalidate"),
            max_generation_skew=config.get_int(
                "executor.proposal.max.generation.skew"
            ),
        )


class ExecutorState:
    NO_TASK_IN_PROGRESS = "NO_TASK_IN_PROGRESS"
    STARTING_EXECUTION = "STARTING_EXECUTION"
    INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS = "INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS"
    LEADER_MOVEMENT_TASK_IN_PROGRESS = "LEADER_MOVEMENT_TASK_IN_PROGRESS"
    STOPPING_EXECUTION = "STOPPING_EXECUTION"


class ExecutionStoppedException(Exception):
    pass


class Executor:
    def __init__(
        self,
        driver: ClusterDriver,
        config: ExecutorConfig = ExecutorConfig(),
        load_monitor=None,
        notifier: Optional[Callable[[str, Dict], None]] = None,
        clock: Callable[[], float] = time.time,
        topology_source: Optional[Callable[[], object]] = None,
        generation_source: Optional[Callable[[], int]] = None,
    ):
        """`topology_source`: returns a FRESH monitor.metadata.ClusterTopology
        for proposal revalidation (defaults to a forced metadata refresh
        through `load_monitor` when one is given); `generation_source`:
        returns the current monitor generation for the skew check (defaults
        to `load_monitor.generation`)."""
        self._driver = driver
        self._config = config
        self._monitor = load_monitor
        self._notifier = notifier or (lambda event, info: None)
        self._clock = clock
        self._lock = threading.RLock()
        self._state = ExecutorState.NO_TASK_IN_PROGRESS
        self._stop_requested = threading.Event()
        self._manager = ExecutionTaskManager(
            config.num_concurrent_partition_movements_per_broker,
            config.num_concurrent_leader_movements,
        )
        self._planner = ExecutionTaskPlanner()
        self._removed_brokers: Dict[int, float] = {}
        self._demoted_brokers: Dict[int, float] = {}
        #: consecutive failed driver poll rounds (reset on success)
        self._driver_failures = 0
        if topology_source is None and load_monitor is not None:
            metadata = getattr(load_monitor, "_metadata", None)
            if metadata is not None:
                topology_source = lambda: metadata.refresh_metadata(force=True)
                if generation_source is None:
                    # sampling is paused during execution, so nothing else
                    # refreshes metadata: the generation probe must force a
                    # refresh or drift would go unseen until resume
                    def generation_source(_metadata=metadata, _mon=load_monitor):
                        _metadata.refresh_metadata(force=True)
                        return _mon.generation
        self._topology_source = topology_source
        self._generation_source = generation_source
        #: generation of the last FULL per-proposal validation pass; while it
        #: matches the current generation, batch boundaries can skip the
        #: per-task rechecks (unchanged generation ⟹ unchanged topology ⟹
        #: identical validation outcome) — the <2% overhead contract
        self._validated_gen: Optional[int] = None
        #: skew accounting across one execution (see _skew_exceeded)
        self._skew_base = 0
        self._structural_steps = 0
        self._last_structural_fp: Optional[TopologyFingerprint] = None
        #: called with a drift-abort info dict when a batch aborts for
        #: generation skew; the anomaly detector wires itself here so a
        #: recompute rides the normal self-healing path
        self._drift_listener: Optional[Callable[[Dict], None]] = None
        #: the current/last execution's proposalValidation record (/state)
        self._validation: Dict = {}
        #: (generation, TopologyView) from the last revalidation round
        self._reval_cache: Optional[tuple] = None
        self._register_skew_gauge()

    def _register_skew_gauge(self) -> None:
        """`Executor.generation-skew` gauge: last observed build-vs-now
        generation distance (weakref-guarded like the breaker gauge)."""
        import weakref

        from cruise_control_torch.common.sensors import REGISTRY

        ref = weakref.ref(self)

        def skew():
            ex = ref()
            if ex is None:
                return {}
            v = ex._validation.get("generationSkew")
            return v if v is not None else 0

        REGISTRY.gauge("Executor.generation-skew", skew)

    def set_drift_listener(self, listener: Callable[[Dict], None]) -> None:
        self._drift_listener = listener

    # -- state -----------------------------------------------------------------

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def has_ongoing_execution(self) -> bool:
        with self._lock:
            return self._state not in (ExecutorState.NO_TASK_IN_PROGRESS,)

    def state_summary(self) -> Dict:
        return {
            "state": self.state,
            **self._manager.tracker.summary(),
            "recentlyRemovedBrokers": sorted(self.recently_removed_brokers),
            "recentlyDemotedBrokers": sorted(self.recently_demoted_brokers),
            "proposalValidation": dict(self._validation),
        }

    def user_triggered_stop_execution(self) -> None:
        """Graceful stop (Executor.userTriggeredStopExecution :433)."""
        from cruise_control_torch.common.oplog import op_log

        with self._lock:
            stopping = self._state != ExecutorState.NO_TASK_IN_PROGRESS
            if stopping:
                self._state = ExecutorState.STOPPING_EXECUTION
        if stopping:
            op_log("User requested execution stop")
        self._stop_requested.set()

    def set_concurrency(self, per_broker: int = None, leadership: int = None) -> None:
        self._manager.set_concurrency(per_broker, leadership)

    # -- broker history --------------------------------------------------------

    def _gc_history(self, history: Dict[int, float]) -> None:
        cutoff = self._clock() - self._config.removal_history_retention_s
        for b in [b for b, t in history.items() if t < cutoff]:
            del history[b]

    @property
    def recently_removed_brokers(self) -> Set[int]:
        with self._lock:
            self._gc_history(self._removed_brokers)
            return set(self._removed_brokers)

    @property
    def recently_demoted_brokers(self) -> Set[int]:
        with self._lock:
            self._gc_history(self._demoted_brokers)
            return set(self._demoted_brokers)

    # -- execution -------------------------------------------------------------

    def execute_proposals(
        self,
        proposals: Sequence[ExecutionProposal],
        strategy: Optional[ReplicaMovementStrategy] = None,
        urp: Optional[Set[int]] = None,
        removed_brokers: Optional[Set[int]] = None,
        demoted_brokers: Optional[Set[int]] = None,
        generation: Optional[int] = None,
        fingerprint: Optional[TopologyFingerprint] = None,
        provenance_run: Optional[str] = None,
    ) -> Dict:
        """Synchronous execution loop; the async layer wraps this in an
        OperationFuture thread. Returns the execution summary.

        `generation`/`fingerprint` are the batch's model-build stamps (the
        facade fills them from the OptimizerResult); when given, admission
        and every batch boundary revalidate against them. `provenance_run`
        is the MoveLedger run id the proposals were computed under
        (OptimizerResult.provenance): every task carries its proposal's
        provenance id into terminal events and drift-trim records, so a
        failed or trimmed task joins back to the decision that proposed it
        (GET /explain)."""
        from cruise_control_torch.common.oplog import op_log as _op_log

        with self._lock:
            if self._state != ExecutorState.NO_TASK_IN_PROGRESS:
                raise RuntimeError("an execution is already in progress")
            try:
                ongoing = self._driver.has_ongoing_reassignment()
            except Exception as e:
                # an unreachable driver cannot veto the start; the dispatch
                # path has its own failure handling (tasks die DEAD there)
                _op_log("Ongoing-reassignment check failed (%r); proceeding", e)
                ongoing = False
            if ongoing:
                raise RuntimeError("ongoing partition reassignment detected; refusing to start")
            self._state = ExecutorState.STARTING_EXECUTION
            self._stop_requested.clear()
            self._driver_failures = 0
            now = self._clock()
            for b in removed_brokers or ():
                self._removed_brokers[b] = now
            for b in demoted_brokers or ():
                self._demoted_brokers[b] = now

        from cruise_control_torch.common.oplog import op_log
        from cruise_control_torch.common.sensors import REGISTRY
        from cruise_control_torch.common.tracing import TRACER

        with TRACER.span(
            "proposal-execution", kind="executor", numProposals=len(proposals)
        ) as span, REGISTRY.histogram("Executor.execution-timer"):
            self._notifier("execution_started", {"numProposals": len(proposals)})
            op_log(
                "Execution started: %d proposal(s), removed=%s demoted=%s",
                len(proposals), sorted(removed_brokers or ()), sorted(demoted_brokers or ()),
            )
            if self._monitor is not None:
                self._monitor.pause_metric_sampling("proposal execution")
            exec_t0 = time.monotonic()
            try:
                self._manager.tracker.reset()  # summaries are per execution
                self._planner.clear()
                self._provenance_run = provenance_run
                try:
                    admitted = self._admit_proposals(proposals, generation, fingerprint)
                    self._planner.add_execution_proposals(
                        admitted, strategy=strategy, urp=urp,
                        provenance_run=provenance_run,
                    )
                    if not self._validation.get("aborted"):
                        self._run_replica_movements()
                        self._run_leadership_movements()
                except Exception as e:
                    # resilience contract: once started, execution never
                    # raises — anything that slipped past the per-task
                    # handling kills the in-flight remainder and falls
                    # through to the summary
                    span.attributes["error"] = f"{type(e).__name__}: {e}"
                    op_log("Execution phase FAILED unexpectedly: %r", e)
                    REGISTRY.meter("Executor.execution-phase-failures").mark()
                    now_ms = int(self._clock() * 1000)
                    for t in self._manager.in_flight_tasks:
                        self._kill_task(t, now_ms, f"execution failure: {e}")
                summary = self._manager.tracker.summary()
                stopped = self._stop_requested.is_set()
                span.attributes["stopped"] = stopped
                span.attributes["byState"] = dict(summary["byState"])
                wall = max(time.monotonic() - exec_t0, 1e-9)
                self._validation["overheadPct"] = round(
                    100.0 * self._validation.get("overheadS", 0.0) / wall, 4
                )
                if self._validation.get("numTrimmed") or self._validation.get("aborted"):
                    span.attributes["proposalValidation"] = {
                        "numTrimmed": self._validation.get("numTrimmed", 0),
                        "aborted": self._validation.get("aborted", False),
                    }
                self._notifier(
                    "execution_stopped" if stopped else "execution_finished", summary
                )
                op_log(
                    "Execution %s: %s",
                    "stopped by user" if stopped else "finished", summary,
                )
                return {
                    **summary,
                    "stopped": stopped,
                    "failedTasks": self._manager.tracker.terminal_events(
                        only_failures=True
                    ),
                    "proposalValidation": dict(self._validation),
                }
            finally:
                if self._monitor is not None:
                    self._monitor.resume_metric_sampling()
                with self._lock:
                    self._state = ExecutorState.NO_TASK_IN_PROGRESS
                # sensor time-series point at the execution boundary
                # (rate-limited; docs/OBSERVABILITY.md history section)
                from cruise_control_torch.common.history import HISTORY

                HISTORY.record_boundary("execution")

    # -- proposal drift validation ---------------------------------------------

    def _current_generation(self) -> Optional[int]:
        try:
            if self._generation_source is not None:
                return int(self._generation_source())
            if self._monitor is not None:
                return int(self._monitor.generation)
        except Exception:
            return None
        return None

    def _fresh_topology(self):
        """Fresh ClusterTopology for revalidation, or None (a metadata outage
        must never block execution — the batch passes unvalidated and the
        failure is metered)."""
        if self._topology_source is None:
            return None
        try:
            return self._topology_source()
        except Exception as e:
            from cruise_control_torch.common.oplog import op_log
            from cruise_control_torch.common.sensors import REGISTRY

            REGISTRY.meter("Executor.revalidation-failures").mark()
            op_log("Revalidation topology fetch FAILED (%r); batch passes unvalidated", e)
            return None

    def _record_trim(self, proposal: ExecutionProposal, reason: str, phase: str) -> None:
        from cruise_control_torch.common.sensors import REGISTRY

        REGISTRY.meter("Executor.proposal-trimmed").mark()
        REGISTRY.meter(f"Executor.proposal-trimmed.{reason}").mark()
        v = self._validation
        v["numTrimmed"] = v.get("numTrimmed", 0) + 1
        v["trimmedByReason"][reason] = v["trimmedByReason"].get(reason, 0) + 1
        if len(v["trimmed"]) < 200:  # failures are never truncated silently:
            # numTrimmed/trimmedByReason always carry the full tally
            run = getattr(self, "_provenance_run", None)
            v["trimmed"].append({
                "partition": proposal.partition,
                "topicPartition": proposal.topic_partition,
                "reason": reason,
                "phase": phase,
                # GET /explain join key ("" when the batch carried no ledger)
                "provenanceId": f"{run}/p{proposal.partition}" if run else "",
            })

    def _trim_task(self, task: ExecutionTask, reason: str, now_ms: int) -> None:
        """Retire a stale (not yet dispatched) task through the real state
        machine: PENDING → IN_PROGRESS → ABORTING → ABORTED, listener fired,
        tracker/notifier informed — drift trims are attributable terminal
        events, not silently vanished tasks."""
        task.listener = self._on_task_terminal
        try:
            if task.state == TaskState.PENDING:
                task.in_progress(now_ms)
            if task.state == TaskState.IN_PROGRESS:
                task.abort(reason=reason)
            if task.state == TaskState.ABORTING:
                task.aborted(now_ms)
        except ValueError:
            pass  # already terminal (a racing completion won)
        self._manager.mark_done(task)

    def _abort_for_skew(self, skew: int, pending: List[ExecutionTask]) -> None:
        """Generation drifted too far: abort the whole remaining batch (the
        in-flight tasks keep draining — they were validly dispatched) and
        hand the drift listener the recompute request."""
        from cruise_control_torch.common.oplog import op_log
        from cruise_control_torch.common.sensors import REGISTRY
        from cruise_control_torch.common.tracing import TRACER

        v = self._validation
        v["aborted"] = True
        v["abortReason"] = (
            f"generation skew {skew} > {self._config.max_generation_skew}"
        )
        REGISTRY.meter("Executor.batch-aborts").mark()
        now_ms = int(self._clock() * 1000)
        seen = set()
        for t in pending:
            if id(t) in seen:
                continue
            seen.add(id(t))
            self._record_trim(t.proposal, GENERATION_SKEW, phase="batch")
            self._trim_task(t, f"stale proposal: {GENERATION_SKEW}", now_ms)
        info = {
            "reason": GENERATION_SKEW,
            "generationSkew": skew,
            "maxGenerationSkew": self._config.max_generation_skew,
            "generationAtBuild": v.get("generationAtBuild"),
            "fingerprintDrift": v.get("fingerprintDrift"),
            "numAborted": len(seen),
        }
        with TRACER.span("proposal-drift-abort", kind="drift", **{
            k: info[k] for k in ("generationSkew", "numAborted")
        }):
            op_log("Proposal batch ABORTED for drift: %s", info)
            self._notifier("proposal_batch_aborted", info)
            if self._drift_listener is not None:
                try:
                    self._drift_listener(info)
                except Exception as e:
                    op_log("Drift listener failed: %r", e)

    def _skew_exceeded(self, skew: Optional[int]) -> Optional[int]:
        """`skew` back when it exceeds the configured threshold (updating the
        record either way); None when within bounds or unknowable.

        Skew accounting: at admission it is the raw monitor-generation delta
        between model build and execution start — the window the drift layer
        exists for. During execution the executor's OWN movements churn the
        metadata generation (every applied reassignment is a topology
        change), so raw deltas would self-inflate; batch boundaries instead
        add one step per observed STRUCTURAL change (broker liveness,
        per-topic partition layout — `_structural_steps`), which the
        execution never causes itself."""
        v = self._validation
        if v.get("generationAtBuild") is None or skew is None:
            return None
        v["generationSkew"] = skew
        if 0 < self._config.max_generation_skew < skew:
            return skew
        return None

    def _topology_view(self, now_gen: Optional[int]) -> Optional[TopologyView]:
        """Fresh-topology view for one revalidation round. Cached keyed on
        the monitor generation: an unchanged generation guarantees unchanged
        topology, so back-to-back batch boundaries in a quiet cluster pay
        one metadata fetch, not one per batch (the <2% overhead contract)."""
        if now_gen is not None and self._reval_cache is not None:
            cached_gen, cached_view = self._reval_cache
            if cached_gen == now_gen:
                return cached_view
        topo = self._fresh_topology()
        if topo is None:
            return None
        view = TopologyView(topo)
        if now_gen is not None:
            self._reval_cache = (now_gen, view)
        return view

    def _admit_proposals(
        self,
        proposals: Sequence[ExecutionProposal],
        generation: Optional[int],
        fingerprint: Optional[TopologyFingerprint],
    ) -> List[ExecutionProposal]:
        """Admission: stamp bookkeeping + the first revalidation pass, before
        any task exists. Returns the proposals that may become tasks."""
        from cruise_control_torch.common.sensors import REGISTRY
        from cruise_control_torch.common.tracing import TRACER

        self._validation = v = {
            "enabled": bool(self._config.proposal_revalidate),
            "provenanceRun": getattr(self, "_provenance_run", None),
            "generationAtBuild": generation,
            "generationAtStart": None,
            "generationSkew": None,
            "maxGenerationSkew": self._config.max_generation_skew,
            "fingerprintAtBuild": fingerprint.to_dict() if fingerprint else None,
            "fingerprintDrift": None,
            "admitted": len(proposals),
            "numTrimmed": 0,
            "trimmed": [],
            "trimmedByReason": {},
            "batchRevalidations": 0,
            "aborted": False,
            "abortReason": None,
            "overheadS": 0.0,
        }
        if not self._config.proposal_revalidate:
            return list(proposals)
        # never carry validation state across executions
        self._reval_cache = None
        self._validated_gen = None
        self._skew_base = 0
        self._structural_steps = 0
        self._last_structural_fp = None
        t0 = time.monotonic()
        with TRACER.span(
            "proposal-admission", kind="validation", numProposals=len(proposals)
        ) as vspan:
            now_gen = self._current_generation()
            v["generationAtStart"] = now_gen
            if generation is not None and now_gen is not None:
                self._skew_base = max(0, now_gen - generation)
            skew = self._skew_exceeded(
                self._skew_base if generation is not None and now_gen is not None
                else None
            )
            if skew is not None:
                v["admitted"] = 0
                for p in proposals:
                    self._record_trim(p, GENERATION_SKEW, phase="admission")
                self._abort_for_skew(skew, [])
                vspan.attributes["aborted"] = True
                v["overheadS"] += time.monotonic() - t0
                return []
            view = self._topology_view(now_gen)
            if view is None:
                v["overheadS"] += time.monotonic() - t0
                return list(proposals)
            now_fp = TopologyFingerprint.from_topology(view._topo)
            self._last_structural_fp = now_fp
            if fingerprint is not None and now_fp != fingerprint:
                v["fingerprintDrift"] = fingerprint.diff(now_fp)
            valid: List[ExecutionProposal] = []
            for p in proposals:
                reason = validate_proposal(p, view)
                if reason is None:
                    valid.append(p)
                else:
                    self._record_trim(p, reason, phase="admission")
            self._validated_gen = now_gen
            v["admitted"] = len(valid)
            vspan.attributes.update(
                admitted=len(valid), trimmed=len(proposals) - len(valid)
            )
            dt = time.monotonic() - t0
            v["overheadS"] += dt
            REGISTRY.histogram("Executor.revalidation-timer").record(dt)
            return valid

    def _revalidate_batch(
        self, batch: List[ExecutionTask], phase: str
    ) -> List[ExecutionTask]:
        """Batch-boundary revalidation. While the monitor generation matches
        the last full pass, the batch is provably still valid (unchanged
        generation ⟹ unchanged topology ⟹ identical validation outcome) and
        the boundary costs one generation probe. On a generation change,
        EVERY pending task — this batch and the planner's remainder — is
        re-checked against fresh topology, so the skip stays sound for the
        batches drawn later at the same generation; stale tasks are trimmed
        (ABORTED with a reason code), and excessive skew aborts everything
        pending."""
        if not batch or not self._config.proposal_revalidate:
            return batch
        from cruise_control_torch.common.sensors import REGISTRY
        from cruise_control_torch.common.tracing import TRACER

        v = self._validation
        t0 = time.monotonic()
        now_gen = self._current_generation()
        if now_gen is not None and now_gen == self._validated_gen:
            # the generation probe above still forced a metadata refresh, so
            # real drift cannot hide behind this fast path
            v["overheadS"] += time.monotonic() - t0
            return batch
        pending = list(batch)
        batch_ids = {id(t) for t in batch}
        seen = set(batch_ids)
        for t in (
            self._planner.remaining_inter_broker_replica_movements
            + self._planner.remaining_leadership_movements
        ):
            if id(t) not in seen:
                pending.append(t)
                seen.add(id(t))
        with TRACER.span(
            "batch-revalidation", kind="validation", tasks=len(pending), phase=phase
        ) as vspan:
            view = self._topology_view(now_gen)
            if view is None:
                v["overheadS"] += time.monotonic() - t0
                return batch
            now_fp = TopologyFingerprint.from_topology(view._topo)
            if (
                self._last_structural_fp is not None
                and now_fp != self._last_structural_fp
            ):
                self._structural_steps += 1
            self._last_structural_fp = now_fp
            skew = self._skew_exceeded(self._skew_base + self._structural_steps)
            if skew is not None:
                self._abort_for_skew(skew, pending)
                vspan.attributes["aborted"] = True
                v["overheadS"] += time.monotonic() - t0
                return []
            now_ms = int(self._clock() * 1000)
            live: List[ExecutionTask] = []
            trimmed = 0
            for t in pending:
                reason = validate_proposal(t.proposal, view)
                if reason is None:
                    if id(t) in batch_ids:
                        live.append(t)
                else:
                    trimmed += 1
                    self._record_trim(t.proposal, reason, phase=phase)
                    self._trim_task(t, f"stale proposal: {reason}", now_ms)
            self._validated_gen = now_gen
            v["batchRevalidations"] += 1
            vspan.attributes.update(live=len(live), trimmed=trimmed)
            dt = time.monotonic() - t0
            v["overheadS"] += dt
            REGISTRY.histogram("Executor.revalidation-timer").record(dt)
            return live

    # -- per-task terminal handling --------------------------------------------

    def _on_task_terminal(self, task: ExecutionTask) -> None:
        """ExecutionTask listener: every terminal transition lands in the
        tracker's terminal log, the sensors, and the ExecutorNotifier
        (`task_completed` / `task_aborted` / `task_dead`)."""
        from cruise_control_torch.common.oplog import op_log
        from cruise_control_torch.common.sensors import REGISTRY

        state = task.state.name.lower()
        REGISTRY.meter(f"Executor.task-{state}").mark()
        self._manager.tracker.record_terminal(task)
        info = {
            "executionId": task.execution_id,
            "type": task.task_type.name,
            "startTimeMs": task.start_time_ms,
            "endTimeMs": task.end_time_ms,
            "reason": task.terminal_reason,
            "provenanceId": task.provenance_id,
        }
        self._notifier(f"task_{state}", info)
        if task.state != TaskState.COMPLETED:
            op_log(
                "Task %d %s: %s", task.execution_id, task.state.name,
                task.terminal_reason or "unattributed",
            )

    def _kill_task(self, task: ExecutionTask, now_ms: int, reason: str) -> None:
        """Force a task to DEAD through the state machine and free its slots."""
        try:
            if task.state == TaskState.PENDING:
                task.in_progress(now_ms)
            if task.state == TaskState.IN_PROGRESS or task.state == TaskState.ABORTING:
                task.kill(now_ms, reason=reason)
        except ValueError:
            pass  # already terminal (a racing completion won)
        self._manager.mark_done(task)

    def _expire_deadlines(
        self, pending: List[ExecutionTask], now_ms: int
    ) -> List[ExecutionTask]:
        """Abort tasks whose wall-clock deadline expired (IN_PROGRESS →
        ABORTING → ABORTED); the agent may still finish the movement later —
        the executor just stops holding broker slots for it."""
        deadline_ms = self._config.task_deadline_s * 1000.0
        if deadline_ms <= 0:
            return pending
        from cruise_control_torch.common.sensors import REGISTRY

        still = []
        for t in pending:
            if now_ms - (t.start_time_ms or 0) >= deadline_ms:
                REGISTRY.meter("Executor.task-deadline-expired").mark()
                t.abort(reason=f"deadline ({self._config.task_deadline_s:g}s) expired")
                t.aborted(now_ms)
                self._manager.mark_done(t)
            else:
                still.append(t)
        return still

    def _reap_finished(self, pending: List[ExecutionTask]) -> List[ExecutionTask]:
        """Poll the driver once: complete finished tasks, expire deadlines,
        and — after `max_consecutive_driver_failures` failed poll rounds —
        declare the driver unreachable and kill everything in flight."""
        from cruise_control_torch.common.oplog import op_log
        from cruise_control_torch.common.sensors import REGISTRY

        now_ms = int(self._clock() * 1000)
        try:
            self._driver.poll()
            self._driver_failures = 0
        except Exception as e:
            self._driver_failures += 1
            REGISTRY.meter("Executor.driver-poll-failures").mark()
            if self._driver_failures >= self._config.max_consecutive_driver_failures:
                op_log(
                    "Cluster driver unreachable after %d consecutive poll "
                    "failures (%r); killing %d in-flight task(s)",
                    self._driver_failures, e, len(pending),
                )
                for t in pending:
                    self._kill_task(t, now_ms, f"driver unreachable: {e}")
                return []
            return self._expire_deadlines(list(pending), now_ms)
        still = []
        for t in pending:
            try:
                finished = self._driver.is_finished(t)
            except Exception:
                finished = False
            if finished:
                t.completed(now_ms)
                self._manager.mark_done(t)
            else:
                still.append(t)
        return self._expire_deadlines(still, now_ms)

    def _dispatch_batch(
        self,
        batch: List[ExecutionTask],
        start_fn: Callable[[ExecutionTask], None],
    ) -> List[ExecutionTask]:
        """Mark a batch IN_PROGRESS and dispatch each task, isolating
        per-task dispatch failures: a task whose dispatch raises dies DEAD
        and releases its slots; the rest of the batch proceeds."""
        from cruise_control_torch.common.oplog import op_log
        from cruise_control_torch.common.sensors import REGISTRY

        now_ms = int(self._clock() * 1000)
        for t in batch:
            t.listener = self._on_task_terminal
        self._manager.mark_in_progress(batch, now_ms)
        live = []
        for t in batch:
            try:
                start_fn(t)
                live.append(t)
            except Exception as e:
                REGISTRY.meter("Executor.dispatch-failures").mark()
                op_log("Dispatch FAILED for task %d: %r", t.execution_id, e)
                self._kill_task(t, now_ms, f"dispatch failure: {e}")
        return live

    def _wait_for_tasks(self, tasks: List[ExecutionTask]) -> None:
        polls = 0
        pending = [t for t in tasks if not t.done]
        while pending:
            pending = self._reap_finished(pending)
            if not pending:
                break
            polls += 1
            if polls > self._config.max_execution_polls:
                now_ms = int(self._clock() * 1000)
                for t in pending:
                    self._kill_task(
                        t, now_ms,
                        f"poll cap ({self._config.max_execution_polls}) exhausted",
                    )
                break
            # graceful stop still waits for in-flight work — at normal pace,
            # not a busy spin
            time.sleep(self._config.execution_progress_check_interval_s)

    def _run_replica_movements(self) -> None:
        """Pipelined execution: broker slots refill as individual tasks
        finish, so one slow movement never stalls unrelated brokers
        (the reference refills per poll round the same way)."""
        from cruise_control_torch.common.oplog import op_log
        from cruise_control_torch.common.sensors import REGISTRY
        from cruise_control_torch.common.tracing import TRACER

        with self._lock:
            self._state = ExecutorState.INTER_BROKER_REPLICA_MOVEMENT_TASK_IN_PROGRESS
        op_log(
            "Execution phase: inter-broker replica movement (%d task(s))",
            len(self._planner.remaining_inter_broker_replica_movements),
        )
        with TRACER.span(
            "executor.replica-movement-phase", kind="executor",
            tasks=len(self._planner.remaining_inter_broker_replica_movements),
        ) as span:
            batches = 0
            in_flight: List[ExecutionTask] = []
            polls = 0
            while True:
                in_flight = self._reap_finished(in_flight)
                remaining = self._planner.remaining_inter_broker_replica_movements
                if self._stop_requested.is_set():
                    if not in_flight:
                        break  # graceful: nothing new once stop is requested
                elif remaining:
                    brokers = set()
                    for t in remaining:
                        brokers |= t.involved_brokers
                    slots = self._manager.available_slots(brokers)
                    batch = self._planner.get_inter_broker_replica_movement_tasks(slots)
                    batch = self._revalidate_batch(batch, "replica")
                    if self._validation.get("aborted"):
                        batch = []
                    if batch:
                        # per-batch dispatch span: batch sizes and dispatch
                        # latency are where throttling problems show first
                        with TRACER.span(
                            "executor.batch-dispatch", kind="executor",
                            tasks=len(batch), type="replica",
                        ), REGISTRY.histogram("Executor.batch-dispatch-timer"):
                            live = self._dispatch_batch(
                                batch, self._driver.start_replica_movement
                            )
                        batches += 1
                        in_flight.extend(live)
                elif not in_flight:
                    break
                if in_flight:
                    polls += 1
                    if polls > self._config.max_execution_polls:
                        now_ms = int(self._clock() * 1000)
                        for t in in_flight:
                            self._kill_task(
                                t, now_ms,
                                f"poll cap ({self._config.max_execution_polls}) exhausted",
                            )
                        in_flight = []
                        continue
                    time.sleep(self._config.execution_progress_check_interval_s)
            span.attributes["batches"] = batches

    def _run_leadership_movements(self) -> None:
        from cruise_control_torch.common.oplog import op_log
        from cruise_control_torch.common.sensors import REGISTRY
        from cruise_control_torch.common.tracing import TRACER

        with self._lock:
            self._state = ExecutorState.LEADER_MOVEMENT_TASK_IN_PROGRESS
        op_log(
            "Execution phase: leadership movement (%d task(s))",
            len(self._planner.remaining_leadership_movements),
        )
        with TRACER.span(
            "executor.leadership-movement-phase", kind="executor",
            tasks=len(self._planner.remaining_leadership_movements),
        ):
            while not self._stop_requested.is_set():
                batch = self._planner.get_leadership_movement_tasks(self._manager.leadership_cap)
                if not batch:
                    break
                batch = self._revalidate_batch(batch, "leadership")
                if self._validation.get("aborted"):
                    break
                if not batch:
                    continue
                with TRACER.span(
                    "executor.batch-dispatch", kind="executor",
                    tasks=len(batch), type="leadership",
                ), REGISTRY.histogram("Executor.batch-dispatch-timer"):
                    live = self._dispatch_batch(
                        batch, self._driver.start_leadership_movement
                    )
                self._wait_for_tasks(live)
