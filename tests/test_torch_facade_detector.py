"""The self-healing loop in the port against the JAX package: the facade
(goal resolution, the hard-goal check, the proposal cache, rebalance,
decommission and the incremental re-proposal), the async operations, and the
detector (the broker-failure detector's persisted times, the notifier's
ladder and circuit breakers, the webhook notifier, the percentile metric
finder, the goal-violation detector, the executor's drift channel and the
end-to-end fix of a killed broker). Every case of tests/test_facade_detector.py
runs on the same 6-broker stack built in both packages (a simulated
cluster's metrics through the load monitor, the executor on the simulator,
the facade on a trimmed default stack), as do the drift cases of
test_drift_validation.py and the breaker cases of test_resilience.py. The
proposals, decision digests, notifier decisions, anomaly descriptions,
detector states and the clusters' assignments after each fix must be equal.
chip_smoke.py's phase 20 (`self_healing`: the service built from the
default configuration, a broker killed, detected, decommissioned through
the facade and executed over the TCP wire to the fake agent) runs on the
stack's simulator and monitor in both packages too. Durations, run ids and
execution ids are left out. Tolerance: exact.
"""

import importlib
import logging
import re
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

JAX, PORT = "cruise_control_tpu", "cruise_control_torch"
#: the trimmed default stack of the JAX tests: each distinct goal stack is
#: an XLA compile on the JAX side
DEFAULT_GOALS = ("RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
                 "ReplicaDistributionGoal", "LeaderReplicaDistributionGoal")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors, several test processes: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _stack(pkg, facade_config=None, optimizer=None, seed=9, num_topics=6, executor_config=None,
           latency_polls=0):
    """The JAX tests' stack in the package: a 6-broker simulated cluster
    sampled for four 1 s windows by a LoadMonitor on a scripted clock, an
    Executor on the simulator, and the facade on the trimmed default stack
    (the optimizer on the CPU in the port)."""
    gen, opt = _m(pkg, "models.generators"), _m(pkg, "analyzer.optimizer")
    lm, fac, ex = _m(pkg, "monitor.load_monitor"), _m(pkg, "facade"), _m(pkg, "executor")
    sim = _m(pkg, "testing.simulator").SimulatedCluster(gen.random_cluster(
        seed, gen.ClusterProperty(num_racks=3, num_brokers=6, num_topics=num_topics,
                                  replication_factor=2)))
    transport = _m(pkg, "reporter.transport").InMemoryTransport()
    clock = {"now": 0.0}
    monitor = lm.LoadMonitor(
        _m(pkg, "monitor.metadata").MetadataClient(sim.fetch_topology, ttl_s=0.0),
        _m(pkg, "monitor.sampler").TransportMetricSampler(transport),
        config=lm.LoadMonitorConfig(window_ms=1000, num_windows=3, min_samples_per_window=1),
        clock=lambda: clock["now"])
    monitor.start_up()
    for r in range(4):
        transport.publish(sim.all_metrics(r * 1000 + 500))
        clock["now"] = r + 0.8
        monitor.sample_once()
    executor = ex.Executor(ex.SimulatorClusterDriver(sim, latency_polls=latency_polls),
                           load_monitor=monitor,
                           **({"config": ex.ExecutorConfig(**executor_config)}
                              if executor_config else {}))
    if optimizer is None:
        fast = opt.OptimizerSettings(batch_k=16, max_rounds_per_goal=8, num_dst_candidates=3)
        optimizer = opt.GoalOptimizer(settings=fast, **({"device": "cpu"} if pkg == PORT
                                                          else {}))
    config = facade_config or dict(
        default_requirements=_m(pkg, "monitor.completeness").ModelCompletenessRequirements(
            1, 0.5, False),
        default_goal_names=DEFAULT_GOALS)
    facade = fac.CruiseControl(monitor, executor, optimizer=optimizer,
                               config=fac.FacadeConfig(**config))
    return types.SimpleNamespace(pkg=pkg, sim=sim, monitor=monitor, executor=executor,
                                 facade=facade, transport=transport, clock=clock)


def _both(fn, *args):
    """fn(package name, *args) in the JAX package, then in the port: the two
    results must be equal; returns the port's."""
    want = fn(JAX, *args)
    got = fn(PORT, *args)
    assert got == want
    return got


def _assignment(s):
    return np.asarray(s.sim.model().assignment).tolist()


def _decisions(result):
    """What a solve decided: its proposals and its decision digest."""
    names = [g.name for g in result.goal_results]
    return ([p.to_dict() for p in result.proposals],
            result.provenance.digest(goals=names) if result.provenance is not None else None)


def _sample(s, window):
    """Publish the simulator's metrics for another 1 s window and sample it."""
    s.transport.publish(s.sim.all_metrics(window * 1000 + 500))
    s.clock["now"] = window + 0.8
    s.monitor.sample_once()


# -- the facade ------------------------------------------------------------------


def test_goal_resolution_and_hard_goal_check():
    def run(pkg):
        s = _stack(pkg)
        fac = _m(pkg, "facade")
        out = [s.facade.goals_by_priority(None),
               s.facade.goals_by_priority(["ReplicaCapacityGoal", "RackAwareGoal"])]
        with pytest.raises(fac.IllegalRequestException, match="unknown") as unknown:
            s.facade.goals_by_priority(["NoSuchGoal"])
        with pytest.raises(fac.IllegalRequestException, match="hard") as hard:
            s.facade.sanity_check_hard_goal_presence(["ReplicaDistributionGoal"])
        s.facade.sanity_check_hard_goal_presence(["ReplicaDistributionGoal"],
                                                 skip_hard_goal_check=True)
        return out + [str(unknown.value), str(hard.value)]

    out = _both(run)
    assert out[0][0] == "RackAwareGoal" and out[1] == ["RackAwareGoal", "ReplicaCapacityGoal"]


def test_proposal_cache_hit_and_invalidation():
    def run(pkg):
        s = _stack(pkg)
        r1 = s.facade.get_proposals()
        r2 = s.facade.get_proposals()
        _sample(s, 5)  # a new generation: recompute
        r3 = s.facade.get_proposals()
        r4 = s.facade.get_proposals(goal_names=["RackAwareGoal", "ReplicaCapacityGoal"])
        return ((r2 is r1, r3 is not r1, r4 is not r3),
                [_decisions(r) for r in (r1, r3, r4)], (r1.generation, r3.generation))

    identity, _, _ = _both(run)
    assert identity == (True, True, True)


def test_rebalance_executes_on_cluster():
    def run(pkg):
        s = _stack(pkg)
        before = _assignment(s)
        result = s.facade.rebalance(dryrun=False)
        after = np.asarray(s.sim.model().assignment)
        want = np.asarray(result.final_assignment)
        for p in range(after.shape[0]):
            assert set(after[p][after[p] >= 0]) == set(want[p][want[p] >= 0])
        return _decisions(result), before, after.tolist()

    (proposals, _), before, after = _both(run)
    assert (before != after) == bool(proposals)


def test_decommission_moves_replicas_off_broker():
    def run(pkg):
        s = _stack(pkg)
        result = s.facade.decommission_brokers({2}, dryrun=False)
        return (_decisions(result), _assignment(s),
                sorted(s.executor.recently_removed_brokers))

    _, after, removed = _both(run)
    assert not (np.asarray(after) == 2).any() and 2 in removed


def test_add_demote_and_replication_factor_flows_equal_jax():
    """The facade's other operations: brokers added (marked NEW, load moved
    onto them), a broker demoted (leadership off it, LeaderReplica
    DistributionGoal alone), a topic's replication factor raised and
    executed, and the facade's state blocks."""

    def run(pkg):
        s = _stack(pkg)
        added = s.facade.add_brokers({5}, dryrun=True)
        demoted = s.facade.demote_brokers({1}, dryrun=True)
        rf = s.facade.update_topic_replication_factor("topic-[01]", 3, dryrun=False)
        state = s.facade.state()
        return (_decisions(added), _decisions(demoted), [g.name for g in demoted.goal_results],
                rf, _assignment(s), sorted(state), state["AnalyzerState"],
                state["IncrementalState"])

    added, demoted, goals, rf, after, blocks, analyzer, _ = _both(run)
    assert added[0] and goals == ["LeaderReplicaDistributionGoal"]
    assert all(p["newReplicas"][0] != 1 for p in demoted[0] if p["newReplicas"])
    assert rf["numProposals"] > 0 and not rf["dryrun"]
    assert all(len(p["newReplicas"]) == 3 for p in rf["proposals"])
    rows = {p["partition"] for p in rf["proposals"]}
    assert all(len([b for b in after[r] if b >= 0]) == 3 for r in rows)
    assert blocks == ["AnalyzerState", "ExecutorState", "IncrementalState", "MonitorState",
                      "Sensors"] and not analyzer["cachedProposals"]


def test_async_operations_and_precompute():
    def run(pkg):
        s = _stack(pkg)
        acc = _m(pkg, "async_ops").AsyncCruiseControl(s.facade)
        fut = acc.get_proposals()
        res = fut.result(timeout=300)
        steps = [st["step"] for st in fut.progress.to_list()]
        # precompute keeps the cache warm, so a plain get_proposals is a hit
        acc.start_proposal_precompute(interval_s=0.05)
        time.sleep(0.4)
        acc.shutdown()
        return (fut.done(), bool(res.goal_results), steps, _decisions(res),
                s.facade._cached is not None, fut.describe()["operation"])

    done, solved, steps, _, warm, operation = _both(run)
    assert done and solved and warm and operation == "PROPOSALS"
    assert any("Running" in st for st in steps)


def test_facade_stamps_and_hands_stamps_to_executor(monkeypatch):
    """A stub optimizer's result (test_drift_validation.py:349): the facade
    stamps it with the monitor's generation and the topology's fingerprint
    and hands both to the executor, which admits it against them."""

    def run(pkg):
        opt = _m(pkg, "analyzer.optimizer")
        monkeypatch.setattr(opt, "stats_to_dict", lambda s: {})
        ex = _m(pkg, "executor")
        sims = []

        class StubOptimizer:
            def optimizations(self, model, **kwargs):
                view = ex.TopologyView(sims[0].fetch_topology())
                old = view.replicas(0)
                dst = next(b for b in range(view.num_brokers) if b not in old)
                return opt.OptimizerResult(
                    proposals=[_m(pkg, "analyzer.proposals").ExecutionProposal(
                        partition=0, old_replicas=old, new_replicas=(dst,) + tuple(old[1:]))],
                    goal_results=[], stats_before=None, stats_after=None,
                    final_assignment=np.asarray(model.assignment), num_replica_moves=1,
                    num_leadership_moves=0, data_to_move_mb=0.0, duration_s=0.0)

        s = _stack(pkg, facade_config=dict(
            default_requirements=_m(pkg, "monitor.completeness").ModelCompletenessRequirements(
                1, 0.5, False)), optimizer=StubOptimizer(), seed=7, num_topics=4,
            executor_config=dict(execution_progress_check_interval_s=0.002), latency_polls=1)
        sims.append(s.sim)
        result = s.facade.rebalance(dryrun=False, skip_hard_goal_check=True)
        v = s.executor.state_summary()["proposalValidation"]
        return (result.generation, result.fingerprint.to_dict(),
                result.summary()["proposalStamp"], v["generationAtBuild"],
                v["fingerprintAtBuild"], v["admitted"], v["aborted"])

    generation, fingerprint, stamp, at_build, fp_at_build, admitted, aborted = _both(run)
    assert generation is not None and generation >= 0
    assert stamp["generation"] == at_build == generation
    assert fp_at_build["digest"] == fingerprint["digest"]
    assert admitted == 1 and not aborted


def test_incremental_reproposal_through_the_facade():
    """The facade arms its incremental lane after a stamped solve: a load
    spike re-proposes through the lane (K10 and the scoped solve), equal to
    the JAX facade's proposal; a topic delete is a typed fallback, with the
    same reason in both packages, refused where the full fallback is off."""

    def run(pkg):
        inc = _m(pkg, "analyzer.incremental")
        s = _stack(pkg, facade_config=dict(
            default_requirements=_m(pkg, "monitor.completeness").ModelCompletenessRequirements(
                1, 0.5, False),
            default_goal_names=DEFAULT_GOALS,
            incremental=inc.IncrementalConfig(fallback_full=False)))
        full = s.facade.rebalance(dryrun=True)
        armed = s.facade.state()["IncrementalState"]
        s.sim.spike_load(0, 8.0)
        _sample(s, 4)
        _sample(s, 5)  # the spiked window completes
        lane = s.facade.incremental_reproposal(dryrun=True)
        spiked = {k: v for k, v in s.facade.state()["IncrementalState"]["lastOutcome"].items()
                  if k != "durationS"}
        # the monitor's partition universe only grows (load_monitor.py
        # _ensure_universe, in both packages), so the topic delete reaches
        # the lane as the monitor's model less topic 1's partitions
        build = s.monitor.cluster_model

        def without_topic_1(*args, **kwargs):
            model, meta = build(*args, **kwargs)
            keep = np.asarray(model.topic_id) != 1
            rows = keep if pkg == JAX else torch.from_numpy(keep)
            return model._replace(**{k: getattr(model, k)[rows]
                                     for k in ("assignment", "part_load", "topic_id")}), meta

        s.monitor.cluster_model = without_topic_1
        with pytest.raises(RuntimeError, match="incremental re-proposal unavailable") as err:
            s.facade.incremental_reproposal(dryrun=True)
        deleted = s.facade.state()["IncrementalState"]["lastOutcome"]
        return (_decisions(full), armed, _decisions(lane), lane.generation, spiked,
                str(err.value), deleted["fallbackReason"], deleted["deltas"])

    _, armed, (proposals, _), _, spiked, _, reason, _ = _both(run)
    assert armed["armed"] and spiked["fallbackReason"] is None and spiked["affectedGoals"]
    assert reason == "SENSITIVITY_ALL"


# -- the detector ------------------------------------------------------------------


def test_broker_failure_detector_persists(tmp_path):
    def run(pkg):
        s = _stack(pkg)
        det_cls = _m(pkg, "detector").BrokerFailureDetector
        path = str(tmp_path / f"{pkg}_failed_brokers.json")
        det = det_cls(s.monitor._metadata, persist_path=path, clock=lambda: s.clock["now"])
        first = det.detect()
        s.sim.kill_broker(1)
        s.clock["now"] = 100.0
        found = det.detect()
        # the failure time survives a detector restart
        det2 = det_cls(s.monitor._metadata, persist_path=path, clock=lambda: s.clock["now"])
        found2 = det2.detect()
        s.sim.restore_broker(1)
        return first, found.describe(), found2.describe(), det2.detect()

    first, found, found2, recovered = _both(run)
    assert first is None and recovered is None
    assert found == found2 == {"anomalyType": "BROKER_FAILURE", "failedBrokers": {"1": 100000}}


def test_self_healing_notifier_ladder():
    def run(pkg):
        d = _m(pkg, "detector")
        alerts = []
        notifier = d.SelfHealingNotifier(broker_failure_alert_threshold_s=10.0,
                                         self_healing_threshold_s=30.0,
                                         alert_sink=alerts.append)
        failure = d.BrokerFailures(failed_brokers={3: 0})
        out = [notifier.on_anomaly(failure, now_ms=t) for t in (5_000, 15_000, 31_000)]
        off = d.SelfHealingNotifier(self_healing_broker_failure_enabled=False)
        out.append(off.on_anomaly(failure, now_ms=10**10))
        return [(r.name, delay) for r, delay in out], alerts

    decisions, alerts = _both(run)
    assert [r for r, _ in decisions] == ["CHECK", "CHECK", "FIX", "IGNORE"]
    assert decisions[0][1] > 0 and len(alerts) == 2 and alerts[1]["autoFixTriggered"]


def test_webhook_notifier_posts_text():
    def run(pkg):
        d = _m(pkg, "detector")
        posts = []
        n = d.WebhookNotifier(posts.append, broker_failure_alert_threshold_s=0.0,
                              self_healing_threshold_s=1e9)
        decision = n.on_anomaly(d.BrokerFailures(failed_brokers={0: 0}), now_ms=1000)
        return posts, (decision[0].name, decision[1])

    posts, _ = _both(run)
    assert posts and "BROKER_FAILURE" in posts[0]


def test_percentile_metric_anomaly_finder():
    def run(pkg):
        finder = _m(pkg, "detector").PercentileMetricAnomalyFinder(min_history_windows=3)
        rng = np.random.default_rng(5)
        history = rng.uniform(1.0, 2.0, (4, 5, 56)).astype(np.float32)
        current = rng.uniform(1.0, 2.0, (4, 56)).astype(np.float32)
        metrics = finder.interested_metrics
        current[1, metrics[0]] = 100.0  # broker 1 spikes
        current[2, metrics[1]] = 0.01  # broker 2 drops
        history[3, :2, metrics[2]] = 0.0  # too little history to judge broker 3
        current[3, metrics[2]] = 100.0
        return [a.describe() for a in finder.find(history, current)]

    found = _both(run)
    assert {(a["broker"], a["metric"]) for a in found} >= {
        (1, "BROKER_PRODUCE_LOCAL_TIME_MS_MEAN"), (2, "BROKER_CONSUMER_FETCH_LOCAL_TIME_MS_MEAN")}


def _healing_detector(pkg, s, **notifier):
    d = _m(pkg, "detector")
    return d.AnomalyDetector(s.facade, notifier=d.SelfHealingNotifier(
        broker_failure_alert_threshold_s=0.0, self_healing_threshold_s=0.0, **notifier),
        clock=lambda: s.clock["now"])


def test_self_healing_end_to_end():
    """Kill a broker: the detector and the handler decommission it through
    the facade and its replicas leave it."""

    def run(pkg):
        s = _stack(pkg)
        det = _healing_detector(pkg, s)
        s.sim.kill_broker(0)
        s.clock["now"] = 60.0
        queued = det.detect_once()
        action = det.handle_once()
        return queued, action, det.state(), _assignment(s)

    queued, action, state, after = _both(run)
    assert queued >= 1 and action == "FIX"
    assert not (np.asarray(after) == 0).any()
    assert state["fixesTriggered"]["BROKER_FAILURE"] == 1
    assert state["recentAnomalies"][0] == {"anomalyType": "BROKER_FAILURE",
                                           "failedBrokers": {"0": 60000}}


_TRACE = re.compile(r"\s*\[trace=[0-9a-f]+\]")


def test_operation_log_covers_rebalance_and_self_healing(caplog):
    """One rebalance and one self-healing fix leave the same audit trail on
    the operation logger in both packages: the execution's start, phases
    and finish, the notifier's decision and the fix's outcome."""

    def run(pkg):
        s = _stack(pkg)
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="operationLogger"):
            s.facade.rebalance(dryrun=False)
            det = _healing_detector(pkg, s)
            s.sim.kill_broker(0)
            s.clock["now"] = 60.0
            det.detect_once()
            action = det.handle_once()
        lines = [_TRACE.sub("", r.getMessage()) for r in caplog.records
                 if r.name == "operationLogger"]
        return action, [re.sub(r"\d+(\.\d+)?", "#", line) for line in lines]

    action, lines = _both(run)
    text = "\n".join(lines)
    assert action == "FIX"
    for want in ("Execution started", "Execution phase: inter-broker replica movement",
                 "Execution phase: leadership movement", "Execution finished",
                 "notifier decided FIX", "Self-healing fix completed"):
        assert want in text, want


def test_goal_violation_detector_finds_and_fixes():
    def run(pkg):
        s = _stack(pkg)
        det = _m(pkg, "detector").GoalViolationDetector(
            s.facade, detection_goals=["ReplicaDistributionGoal"])
        found = det.detect()
        if found is not None:
            found.fix(s.facade)  # relaxed thresholds, executed
        return (None if found is None else found.describe(), s.executor.state, _assignment(s))

    found, state, _ = _both(run)
    assert found is not None and found["fixableViolatedGoals"] == ["ReplicaDistributionGoal"]
    assert state == "NO_TASK_IN_PROGRESS"


def test_goal_violation_detector_waits_while_a_broker_is_dead():
    """A dead broker is the broker-failure detector's to report: the goal
    violation detector returns nothing (detectors.py:45-46)."""

    def run(pkg):
        s = _stack(pkg)
        s.sim.kill_broker(4)
        _sample(s, 4)
        det = _m(pkg, "detector").GoalViolationDetector(s.facade)
        return det.detect()

    assert _both(run) is None


class _StubDetector:
    def detect(self):
        return None


def test_drift_abort_queues_detector_recompute():
    """The executor aborts a batch for generation skew and queues a
    ProposalDriftAnomaly on the detector, whose handler runs the fix as a
    cache-bypassing goal-violation rebalance (test_drift_validation.py:309)."""

    def run(pkg):
        gen, ex, d = _m(pkg, "models.generators"), _m(pkg, "executor"), _m(pkg, "detector")
        sim = _m(pkg, "testing.simulator").SimulatedCluster(gen.random_cluster(
            7, gen.ClusterProperty(num_racks=3, num_brokers=6, num_topics=4,
                                   replication_factor=2)))
        mc = _m(pkg, "monitor.metadata").MetadataClient(sim.fetch_topology, ttl_s=0.0)
        extra = {"n": 0}
        execu = ex.Executor(ex.SimulatorClusterDriver(sim, latency_polls=1),
                            config=ex.ExecutorConfig(execution_progress_check_interval_s=0.002,
                                                     max_generation_skew=1),
                            topology_source=lambda: mc.refresh_metadata(force=True),
                            generation_source=lambda: mc.generation + extra["n"])

        class Facade:
            def __init__(self):
                self._executor = execu
                self.rebalances = []

            def rebalance(self, **kwargs):
                self.rebalances.append(kwargs)
                return "recomputed"

        facade = Facade()
        det = d.AnomalyDetector(facade, notifier=d.SelfHealingNotifier(),
                                goal_violation_detector=_StubDetector(),
                                broker_failure_detector=_StubDetector(),
                                metric_anomaly_detector=_StubDetector())
        view = ex.TopologyView(mc.refresh_metadata(force=True))
        old = view.replicas(0)
        dst = next(b for b in range(view.num_brokers) if b not in old and not view.broker_dead(b))
        extra["n"] = 10
        summary = execu.execute_proposals([_m(pkg, "analyzer.proposals").ExecutionProposal(
            partition=0, old_replicas=old, new_replicas=(dst,) + tuple(old[1:]),
            topic_partition=view.name_of(0))], generation=mc.generation)
        queued = det._queue.queue[0]
        notifications = det.state()["proposalDriftNotifications"]
        action = det.handle_once()
        (kwargs,) = facade.rebalances
        return (type(queued).__name__, queued.describe(), notifications, action,
                kwargs["dryrun"], kwargs["ignore_proposal_cache"],
                kwargs["options"].is_triggered_by_goal_violation,
                summary["proposalValidation"]["aborted"])

    name, describe, notifications, action, dryrun, bypass, triggered, aborted = _both(run)
    assert name == "ProposalDriftAnomaly" and describe["kind"] == "PROPOSAL_DRIFT"
    assert notifications == 1 and action == "FIX" and aborted
    assert dryrun is False and bypass is True and triggered


# -- the self-healing circuit breakers (test_resilience.py:346, :391) ------------


class _FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class _StubFacade:
    class _StubExecutor:
        has_ongoing_execution = False

    def __init__(self):
        self._executor = self._StubExecutor()


def test_selfhealing_breaker_opens_degrades_and_recovers():
    def run(pkg):
        d, sensors = _m(pkg, "detector"), _m(pkg, "common.sensors")

        class FlakyFixAnomaly(d.Anomaly):
            anomaly_type = d.AnomalyType.GOAL_VIOLATION

            def __init__(self, controller):
                self._controller = controller

            def fix(self, facade):
                self._controller["attempts"] += 1
                if self._controller["failing"]:
                    raise RuntimeError("fix wedged")
                return "fixed"

            def describe(self):
                return {"anomalyType": self.anomaly_type.name}

        clock = _FakeClock()
        det = d.AnomalyDetector(
            _StubFacade(), notifier=d.SelfHealingNotifier(breaker_threshold=2,
                                                          breaker_cooldown_s=60.0,
                                                          breaker_clock=clock),
            goal_violation_detector=_StubDetector(), broker_failure_detector=_StubDetector(),
            metric_anomaly_detector=_StubDetector(), clock=clock)
        controller = {"failing": True, "attempts": 0}

        def handle():
            det._queue.put(FlakyFixAnomaly(controller))
            return det.handle_once()

        fails_before = sensors.REGISTRY.meter("AnomalyDetector.fix-failures").count
        actions = [handle(), handle()]  # the second failure trips the breaker
        opened = det.state()
        actions.append(handle())  # degraded: a delayed CHECK, no fix attempted
        attempts = controller["attempts"]
        gauge = ('cruise_control_gauge{sensor="AnomalyDetector.breaker-state",'
                 'field="GOAL_VIOLATION"} 2' in sensors.REGISTRY.prometheus_text())
        clock.t += 61.0  # the cooldown elapses: one half-open probe, which succeeds
        controller["failing"] = False
        actions.append(handle())
        return (actions, opened["selfHealingBreakers"]["GOAL_VIOLATION"]["state"],
                opened["fixFailures"], attempts, gauge,
                sensors.REGISTRY.meter("AnomalyDetector.fix-failures").count - fails_before,
                det.state()["selfHealingBreakers"]["GOAL_VIOLATION"]["state"],
                det.state()["fixesTriggered"])

    actions, opened, failures, attempts, gauge, meter, closed, fixes = _both(run)
    assert actions == ["FIX", "FIX", "CHECK", "FIX"] and opened == "open" and gauge
    assert failures["GOAL_VIOLATION"] == meter == attempts == 2
    assert closed == "closed" and fixes["GOAL_VIOLATION"] == 1


def test_selfhealing_breaker_reopens_on_failed_probe():
    def run(pkg):
        d, retry = _m(pkg, "detector"), _m(pkg, "common.retry")
        clock = _FakeClock()
        notifier = d.SelfHealingNotifier(breaker_threshold=1, breaker_cooldown_s=10.0,
                                         breaker_clock=clock)
        notifier.record_fix_result(d.AnomalyType.BROKER_FAILURE, False)
        br = notifier.breaker(d.AnomalyType.BROKER_FAILURE)
        states = [br.state == retry.CircuitBreaker.OPEN]
        clock.t += 11.0
        probe = notifier._gate_fix(d.AnomalyType.BROKER_FAILURE)[0].name
        notifier.record_fix_result(d.AnomalyType.BROKER_FAILURE, False)
        states.append(br.state == retry.CircuitBreaker.OPEN)
        decision, delay = notifier._gate_fix(d.AnomalyType.BROKER_FAILURE)
        return states, probe, decision.name, delay

    states, probe, decision, delay = _both(run)
    assert states == [True, True] and probe == "FIX"
    assert decision == "CHECK" and delay == pytest.approx(10.0)


def test_chip_smoke_self_healing_phase_equals_jax_on_a_small_cluster():
    """chip_smoke.self_healing on the 6-broker stack: the same victim,
    anomalies, decision, decommission decisions and execution over the wire
    (counts, trims, dispatch order, the cluster afterwards) in both
    packages; the victim keeps no replica."""

    def run(pkg):
        s = _stack(pkg)
        ns = chip_smoke.package_classes(pkg, chip_smoke.SELF_HEALING_CLASSES)
        out = chip_smoke.self_healing(s.sim, s.monitor, ns,
                                      **({"device": "cpu"} if pkg == PORT else {}))
        res = out["result"]
        rows = [(g.name, g.violated_brokers_before, g.violated_brokers_after, g.rounds,
                 g.converged) for g in res.goal_results]
        return (chip_smoke.self_healing_record(out, s.sim), _decisions(res), rows,
                np.asarray(out["model"].broker_state).tolist(), _assignment(s),
                sorted(out["seconds"]))

    rec, _, _, state, after, steps = _both(run)
    assert rec["action"] == "FIX" and rec["fixesTriggered"]["BROKER_FAILURE"] == 1
    assert [a["anomalyType"] for a in rec["detected"]] == ["BROKER_FAILURE"]
    assert state[rec["victim"]] == 3 and not (np.asarray(after) == rec["victim"]).any()
    by = rec["executed"]["byState"]
    assert by["COMPLETED"] == rec["executed"]["numTotalMovements"] > 0
    assert steps == ["detection", "execution", "model build", "solve", "stamping"]
