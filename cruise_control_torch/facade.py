"""CruiseControl facade: wires monitor + analyzer + executor (+ detector).

Analog of KafkaCruiseControl (cc/KafkaCruiseControl.java:70): the operation
surface the REST layer and detectors call — rebalance (:375),
decommission_brokers (:187), add_brokers (:277), demote_brokers (:434) — plus
the proposal cache with expiration and the cache-bypass rules
(ignoreProposalCache :675-691) and hard-goal presence check
(sanityCheckHardGoalPresence :1238).

The JAX package's facade.py, copied: its solves run on the optimizer's
device (the card unless the caller built the optimizer for the CPU), and a
broker-state edit clones the model's tensor where the JAX code copies an
array."""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from cruise_control_torch.analyzer.context import OptimizationOptions
from cruise_control_torch.analyzer.goals import DEFAULT_GOAL_ORDER, GOAL_REGISTRY, HARD_GOAL_NAMES
from cruise_control_torch.analyzer.incremental import IncrementalConfig, IncrementalLane
from cruise_control_torch.analyzer.optimizer import (
    GoalOptimizer,
    OptimizerResult,
    OptimizerSettings,
)
from cruise_control_torch.common.resources import BrokerState
from cruise_control_torch.executor.executor import Executor
from cruise_control_torch.models.flat_model import FlatClusterModel
from cruise_control_torch.monitor.completeness import ModelCompletenessRequirements
from cruise_control_torch.monitor.load_monitor import LoadMonitor


class IllegalRequestException(Exception):
    """Bad operator input (missing hard goals, unknown goal names...)."""


def _with_state(model: FlatClusterModel, broker_indices: Set[int], state: BrokerState):
    """`model` with the brokers `broker_indices` in `state`."""
    broker_state = model.broker_state.clone()
    broker_state[torch.tensor(sorted(broker_indices), dtype=torch.long)] = int(state)
    return model._replace(broker_state=broker_state)


@dataclasses.dataclass
class _CachedProposals:
    result: OptimizerResult
    generation: int
    computed_at: float
    requirements: ModelCompletenessRequirements


@dataclasses.dataclass(frozen=True)
class FacadeConfig:
    proposal_expiration_s: float = 60.0  # proposal.expiration.ms
    default_requirements: ModelCompletenessRequirements = ModelCompletenessRequirements(
        min_required_num_windows=1, min_monitored_partitions_percentage=0.5
    )
    #: goals used when a request names none — the reference's `default.goals`
    #: key (operators commonly trim the stack); None = the full priority order
    default_goal_names: Optional[Tuple[str, ...]] = None
    #: incremental re-proposal lane knobs (`optimizer.incremental.*` keys,
    #: analyzer/incremental.py)
    incremental: IncrementalConfig = IncrementalConfig()


class CruiseControl:
    def __init__(
        self,
        load_monitor: LoadMonitor,
        executor: Executor,
        optimizer: Optional[GoalOptimizer] = None,
        config: FacadeConfig = FacadeConfig(),
        clock=time.monotonic,
    ):
        self._monitor = load_monitor
        self._executor = executor
        self._optimizer = optimizer or GoalOptimizer(settings=OptimizerSettings())
        self._config = config
        self._clock = clock
        self._cache_lock = threading.Lock()
        self._cached: Optional[_CachedProposals] = None
        #: the incremental re-proposal lane, armed after every stamped full
        #: solve and consulted by incremental_reproposal() (the detector's
        #: ProposalDriftAnomaly recovery path)
        self._incremental = IncrementalLane(self._optimizer, config.incremental)

    # -- goal resolution -------------------------------------------------------

    @staticmethod
    def goals_by_priority(goal_names: Optional[Sequence[str]]) -> List[str]:
        """Resolve requested names in default priority order
        (KafkaCruiseControl.goalsByPriority :1218). Validation lives here;
        the ordering is the analyzer registry's, so the two cannot drift."""
        from cruise_control_torch.analyzer.goals import goals_by_priority as resolve

        if goal_names:
            unknown = [n for n in goal_names if n not in GOAL_REGISTRY]
            if unknown:
                raise IllegalRequestException(f"unknown goals: {unknown}")
        return [g.name for g in resolve(goal_names)]

    @staticmethod
    def sanity_check_hard_goal_presence(goal_names: Optional[Sequence[str]],
                                        skip_hard_goal_check: bool = False) -> None:
        """All hard goals must be included unless explicitly skipped
        (sanityCheckHardGoalPresence :1238)."""
        if skip_hard_goal_check or not goal_names:
            return
        missing = [h for h in HARD_GOAL_NAMES if h not in set(goal_names)]
        if missing:
            raise IllegalRequestException(
                f"missing hard goals {missing}; pass skip_hard_goal_check=True to override"
            )

    # -- proposal cache --------------------------------------------------------

    def _ignore_proposal_cache(
        self,
        goal_names,
        options: OptimizationOptions,
        ignore_proposal_cache: bool,
    ) -> bool:
        """The bypass rules of KafkaCruiseControl.ignoreProposalCache (:675)."""
        return (
            ignore_proposal_cache
            or self._executor.has_ongoing_execution
            or bool(goal_names)
            or options.excluded_partitions is not None
            or options.excluded_brokers_for_leadership is not None
            or options.excluded_brokers_for_replica_move is not None
            or options.requested_destination_brokers is not None
            or options.excluded_topic_pattern is not None
            or options.destination_broker_ids is not None
            or options.only_move_immigrants
            or options.is_triggered_by_goal_violation
        )

    @staticmethod
    def _stamp_result(result: OptimizerResult, generation: int, topo) -> OptimizerResult:
        """Drift-safety stamps (executor/validation.py): the monitor
        generation and the topology fingerprint at model-build time ride the
        result so the executor can revalidate the batch against fresh
        metadata before (and while) dispatching."""
        from cruise_control_torch.executor.validation import TopologyFingerprint

        result.generation = generation
        result.fingerprint = TopologyFingerprint.from_topology(topo)
        return result

    def _execute_result(self, result: OptimizerResult, **kwargs) -> Dict:
        """Dispatch an optimizer result with its drift stamps and decision
        provenance attached (tasks carry `<run>/p<partition>` ids into
        terminal events and trim records — GET /explain's execution join)."""
        return self._executor.execute_proposals(
            result.proposals,
            generation=result.generation,
            fingerprint=result.fingerprint,
            provenance_run=(
                result.provenance.run_id if result.provenance is not None else None
            ),
            **kwargs,
        )

    @staticmethod
    def _attach_topic_names(result: OptimizerResult, meta) -> OptimizerResult:
        """Fill each proposal's topicPartition from the model metadata: the
        reference's proposals are topic-partition keyed (ExecutionProposal),
        and clients match on names, not dense partition indices."""
        import dataclasses as _dc

        result.proposals = [
            _dc.replace(p, topic_partition=meta.topic_partition(p.partition))
            for p in result.proposals
        ]
        return result

    def _effective_goals(self, goal_names: Optional[Sequence[str]]):
        """Requested goals in priority order; falls back to the configured
        default.goals list, then to the full stack (None)."""
        if goal_names:
            return self.goals_by_priority(goal_names)
        if self._config.default_goal_names:
            # the configured default goes through the same validation +
            # priority ordering as any request (a verbatim list would run in
            # operator order, changing acceptance-table semantics)
            return self.goals_by_priority(self._config.default_goal_names)
        return None

    def get_proposals(
        self,
        goal_names: Optional[Sequence[str]] = None,
        requirements: Optional[ModelCompletenessRequirements] = None,
        options: OptimizationOptions = OptimizationOptions(),
        ignore_proposal_cache: bool = False,
        model: Optional[FlatClusterModel] = None,
    ) -> OptimizerResult:
        """Cached default-goal proposals, or a fresh optimization
        (KafkaCruiseControl.getProposals :710)."""
        from cruise_control_torch.common.tracing import TRACER

        with TRACER.span("get-proposals", kind="facade", cache="miss") as span:
            return self._get_proposals(
                goal_names, requirements, options, ignore_proposal_cache, model, span
            )

    def _get_proposals(
        self, goal_names, requirements, options, ignore_proposal_cache, model, span
    ) -> OptimizerResult:
        req = requirements or self._config.default_requirements
        use_cache = not self._ignore_proposal_cache(goal_names, options, ignore_proposal_cache)
        if use_cache and model is None:
            with self._cache_lock:
                c = self._cached
                # the cached result is reusable only if it was computed under
                # requirements at least as strong as the caller's
                # (ignoreProposalCache's hasWeakerRequirement, :682-686)
                strong_enough = c is not None and (
                    c.requirements.min_required_num_windows >= req.min_required_num_windows
                    and c.requirements.min_monitored_partitions_percentage
                    >= req.min_monitored_partitions_percentage
                    and (c.requirements.include_all_topics or not req.include_all_topics)
                )
                fresh = (
                    strong_enough
                    and c.generation == self._monitor.generation
                    and self._clock() - c.computed_at < self._config.proposal_expiration_s
                )
                if fresh:
                    span.attributes["cache"] = "hit"
                    return c.result

        if model is None:
            with self._monitor.acquire_for_model_generation():
                generation = self._monitor.generation
                model, _meta = self._monitor.cluster_model(req)
                _topo = self._monitor._metadata.refresh_metadata()
            from cruise_control_torch.analyzer.context import resolve_options

            options = resolve_options(options, model, _meta.topic_names)
        else:
            generation = -1
        result = self._optimizer.optimizations(
            model,
            goal_names=self._effective_goals(goal_names),
            options=options,
            raise_on_hard_failure=not options.is_triggered_by_goal_violation,
        )
        if generation >= 0:
            result = self._attach_topic_names(result, _meta)
            result = self._stamp_result(result, generation, _topo)
            # arm the incremental lane on the SAME (model, options) objects
            # this solve prepared — the prep-cache seam keys by identity, so
            # the lane captures the device-resident padded context of the
            # solve that just ran (analyzer/incremental.py)
            self._incremental.arm(
                model, options,
                tuple(g.name for g in result.goal_results),
                generation=generation,
            )
        if use_cache and generation >= 0:
            with self._cache_lock:
                self._cached = _CachedProposals(result, generation, self._clock(), req)
        return result

    # -- operations ------------------------------------------------------------

    def rebalance(
        self,
        goal_names: Optional[Sequence[str]] = None,
        dryrun: bool = True,
        requirements: Optional[ModelCompletenessRequirements] = None,
        options: OptimizationOptions = OptimizationOptions(),
        skip_hard_goal_check: bool = False,
        ignore_proposal_cache: bool = False,
    ) -> OptimizerResult:
        """KafkaCruiseControl.rebalance (:375)."""
        self.sanity_check_hard_goal_presence(goal_names, skip_hard_goal_check)
        self._sanity_check_dry_run(dryrun)
        result = self.get_proposals(goal_names, requirements, options, ignore_proposal_cache)
        if not dryrun:
            self._execute_result(result)
        return result

    def incremental_reproposal(
        self,
        dryrun: bool = True,
        requirements: Optional[ModelCompletenessRequirements] = None,
    ) -> OptimizerResult:
        """The recovery lane: fresh monitor model → typed delta stream →
        in-place scatter into the device-resident padded context →
        goal-scoped re-solve seeded from the surviving placement
        (analyzer/incremental.py).

        The detector's `ProposalDriftAnomaly` recompute (which the executor's
        batch-abort path also queues) routes here instead of the full
        rebalance. Any lane ineligibility — unarmed, stale generation, delta
        out of the shape bucket, sensitivity map says all — falls back to
        the full goal-violation re-solve when
        `optimizer.incremental.fallback.full` is on, and raises otherwise
        (the operator asked for incremental-or-nothing)."""
        if not dryrun:
            self._sanity_check_dry_run(dryrun)
        req = requirements or self._config.default_requirements
        with self._monitor.acquire_for_model_generation():
            generation = self._monitor.generation
            model, _meta = self._monitor.cluster_model(req)
            _topo = self._monitor._metadata.refresh_metadata()
        outcome = self._incremental.propose(model, generation=generation)
        if outcome.ok:
            result = outcome.result
            result = self._attach_topic_names(result, _meta)
            result = self._stamp_result(result, generation, _topo)
            if not dryrun:
                self._execute_result(result)
            return result
        if self._incremental.config.fallback_full:
            return self.rebalance(
                dryrun=dryrun,
                options=OptimizationOptions(is_triggered_by_goal_violation=True),
                ignore_proposal_cache=True,
            )
        raise RuntimeError(
            f"incremental re-proposal unavailable: {outcome.fallback_reason} "
            "(optimizer.incremental.fallback.full is off)"
        )

    def decommission_brokers(
        self,
        broker_indices: Set[int],
        goal_names: Optional[Sequence[str]] = None,
        dryrun: bool = True,
        skip_hard_goal_check: bool = False,
        options: OptimizationOptions = OptimizationOptions(),
    ) -> OptimizerResult:
        """Drain brokers: mark DEAD then optimize so replicas move off them
        (KafkaCruiseControl.decommissionBrokers :187)."""
        from cruise_control_torch.analyzer.context import resolve_options

        self.sanity_check_hard_goal_presence(goal_names, skip_hard_goal_check)
        self._sanity_check_dry_run(dryrun)
        with self._monitor.acquire_for_model_generation():
            generation = self._monitor.generation
            model, _meta = self._monitor.cluster_model(
                self._config.default_requirements
            )
            _topo = self._monitor._metadata.refresh_metadata()
        model = _with_state(model, broker_indices, BrokerState.DEAD)
        result = self._optimizer.optimizations(
            model,
            goal_names=self._effective_goals(goal_names),
            options=resolve_options(options, model, _meta.topic_names),
        )
        result = self._attach_topic_names(result, _meta)
        result = self._stamp_result(result, generation, _topo)
        if not dryrun:
            self._execute_result(result, removed_brokers=broker_indices)
        return result

    def add_brokers(
        self,
        broker_indices: Set[int],
        goal_names: Optional[Sequence[str]] = None,
        dryrun: bool = True,
        skip_hard_goal_check: bool = False,
    ) -> OptimizerResult:
        """Move load onto NEW brokers (KafkaCruiseControl.addBrokers :277)."""
        self.sanity_check_hard_goal_presence(goal_names, skip_hard_goal_check)
        self._sanity_check_dry_run(dryrun)
        with self._monitor.acquire_for_model_generation():
            generation = self._monitor.generation
            model, _meta = self._monitor.cluster_model(self._config.default_requirements)
            _topo = self._monitor._metadata.refresh_metadata()
        model = _with_state(model, broker_indices, BrokerState.NEW)
        result = self._optimizer.optimizations(
            model, goal_names=self._effective_goals(goal_names)
        )
        result = self._attach_topic_names(result, _meta)
        result = self._stamp_result(result, generation, _topo)
        if not dryrun:
            self._execute_result(result)
        return result

    def demote_brokers(self, broker_indices: Set[int], dryrun: bool = True) -> OptimizerResult:
        """Move leadership (and preferred position) off brokers
        (KafkaCruiseControl.demoteBrokers :434): mark DEMOTED, then run the
        preferred-leader-election pass with demoted brokers excluded from
        leadership."""
        self._sanity_check_dry_run(dryrun)
        with self._monitor.acquire_for_model_generation():
            generation = self._monitor.generation
            model, _meta = self._monitor.cluster_model(self._config.default_requirements)
            _topo = self._monitor._metadata.refresh_metadata()
        model = _with_state(model, broker_indices, BrokerState.DEMOTED)
        mask = np.zeros(model.num_brokers, dtype=bool)
        mask[list(broker_indices)] = True
        result = self._optimizer.optimizations(
            model,
            goal_names=["LeaderReplicaDistributionGoal"],
            options=OptimizationOptions(excluded_brokers_for_leadership=mask),
        )
        result = self._attach_topic_names(result, _meta)
        result = self._stamp_result(result, generation, _topo)
        if not dryrun:
            self._execute_result(result, demoted_brokers=broker_indices)
        return result

    def update_topic_replication_factor(
        self, topic_pattern: str, replication_factor: int, dryrun: bool = True
    ) -> Dict:
        """Change RF for topics matching the pattern
        (KafkaCruiseControl.updateTopicConfiguration :949): new replicas go to
        alive brokers on under-represented racks with the fewest replicas;
        RF reduction drops trailing followers (never the leader)."""
        import re as _re

        from cruise_control_torch.analyzer.proposals import ExecutionProposal
        from cruise_control_torch.models.flat_model import replica_counts

        if replication_factor < 1:
            raise IllegalRequestException("replication_factor must be >= 1")
        self._sanity_check_dry_run(dryrun)
        with self._monitor.acquire_for_model_generation():
            generation = self._monitor.generation
            model, meta = self._monitor.cluster_model(self._config.default_requirements)
            _topo = self._monitor._metadata.refresh_metadata()
        pattern = _re.compile(topic_pattern)
        topic_ids = {
            t for t, name in enumerate(meta.topic_names) if pattern.fullmatch(name)
        }
        if not topic_ids:
            raise IllegalRequestException(f"no topics match {topic_pattern!r}")
        a = np.asarray(model.assignment)
        state = np.asarray(model.broker_state)
        rack = np.asarray(model.broker_rack)
        counts = np.asarray(replica_counts(model)).copy()
        proposals: List[ExecutionProposal] = []
        for p in np.nonzero(np.isin(np.asarray(model.topic_id), list(topic_ids)))[0]:
            old = [int(b) for b in a[p] if b >= 0]
            new = list(old)
            while len(new) > replication_factor:
                new.pop()  # drop trailing followers, keep the leader
            while len(new) < replication_factor:
                used_racks = {int(rack[b]) for b in new}
                eligible = [
                    b
                    for b in range(model.num_brokers)
                    if state[b] != BrokerState.DEAD and b not in new
                ]
                if not eligible:
                    raise IllegalRequestException(
                        f"not enough alive brokers for RF {replication_factor}"
                    )
                fresh_rack = [b for b in eligible if int(rack[b]) not in used_racks]
                pool = fresh_rack or eligible
                pick = min(pool, key=lambda b: counts[b])
                counts[pick] += 1
                new.append(pick)
            if new != old:
                proposals.append(
                    ExecutionProposal(
                        partition=int(p),
                        old_replicas=tuple(old),
                        new_replicas=tuple(new),
                        topic_partition=meta.topic_partition(int(p)),
                    )
                )
        if not dryrun and proposals:
            from cruise_control_torch.executor.validation import TopologyFingerprint

            self._executor.execute_proposals(
                proposals,
                generation=generation,
                fingerprint=TopologyFingerprint.from_topology(_topo),
            )
        return {
            "topics": sorted(meta.topic_names[t] for t in topic_ids),
            "replicationFactor": replication_factor,
            "numProposals": len(proposals),
            "proposals": [pr.to_dict() for pr in proposals[:1000]],
            "dryrun": dryrun,
        }

    def _sanity_check_dry_run(self, dryrun: bool) -> None:
        """No non-dryrun op may start over an ongoing execution
        (sanityCheckDryRun :337)."""
        if not dryrun and self._executor.has_ongoing_execution:
            raise RuntimeError("cannot start execution: another execution is in progress")

    # -- state -----------------------------------------------------------------

    def state(self) -> Dict:
        """Aggregated sub-states (/state endpoint; KafkaCruiseControl :1148)."""
        from cruise_control_torch.common.sensors import REGISTRY

        monitor_state = {
            "state": self._monitor.state,
            # active exclusive mode (BOOTSTRAPPING/TRAINING) + progress, the
            # reference's LoadMonitorTaskRunner state reporting
            "activeTask": self._monitor.active_task,
            "generation": self._monitor.generation,
            "sensors": dict(self._monitor.sensors),
        }
        fetcher = getattr(self._monitor._sampler, "sensors", None)
        if fetcher is not None:  # N-way MetricFetcherManager in place
            monitor_state["fetchers"] = {
                k: (list(v) if isinstance(v, list) else v) for k, v in fetcher.items()
            }
        return {
            "MonitorState": monitor_state,
            "ExecutorState": self._executor.state_summary(),
            "AnalyzerState": {
                "goals": [g.name for g in DEFAULT_GOAL_ORDER],
                "cachedProposals": self._cached is not None,
            },
            "IncrementalState": self._incremental.state(),
            # named timers/meters (Sensors.md; JMX domain kafka.cruisecontrol)
            "Sensors": REGISTRY.snapshot(),
        }
