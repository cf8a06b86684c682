"""The port's executor against the JAX package's, on the same inputs.

Each case runs the same seeded inputs through both packages: the task state
machine, the movement strategies, the planner, the manager, execution on
the simulated cluster (sampling paused and resumed, the broker history, the
refusals), the file-journal driver, every drift-validation reason code with
the admission trims, the generation-skew abort and its listener, the
retry policy and circuit breaker under a scripted clock and sleep, and the
sensor history under a scripted clock. Then the slice end to end: a
12-broker simulated cluster's metrics through each package's load monitor,
the service solve on the CPU, the facade's stamps, execution on each
package's simulator (chip_smoke's phase 19 recipe at a small size) and a
chaos run of the same proposals. Compared: states, counts, trims, reasons,
the dispatch order and the assignments afterwards, never execution ids
(seeded from the clock) or durations. Tolerance: exact, since all of this
is integers and host floats computed the same way; no assertion reads a
clock.
"""

import dataclasses
import importlib
import json
import os
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

JAX, PORT = "cruise_control_tpu", "cruise_control_torch"
PKGS = (JAX, PORT)
#: the JAX side of the port's SERVICE_SETTINGS (bucketed), on the pinned
#: schedule chip_smoke's solves run
JAX_SERVICE = dict(batch_k=16, max_rounds_per_goal=64, drain_src=512, drain_per_broker=8,
                   drain_dst=64, apply_waves=8, bulk_waves=16, bulk_min_brokers=32,
                   num_swap_pairs=8, swap_candidates=8, swaps_per_broker=4, polish_rounds=0,
                   chunk_rounds=32, bucket_partitions=True, bucket_brokers=True,
                   ledger=True, num_dst_candidates=8, chunk_target_s=1e9)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path runs on small tensors, where torch's intra-op
    threads buy nothing, and the suite runs in several worker processes at
    once: threads that outnumber the cores wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _ns(pkg):
    """The package's classes chip_smoke's recipes take."""
    ex = _m(pkg, "executor")
    chaos = _m(pkg, "testing.chaos")
    lm = _m(pkg, "monitor.load_monitor")
    return types.SimpleNamespace(
        SimulatedCluster=_m(pkg, "testing.simulator").SimulatedCluster,
        InMemoryTransport=_m(pkg, "reporter.transport").InMemoryTransport,
        MetadataClient=_m(pkg, "monitor.metadata").MetadataClient,
        TransportMetricSampler=_m(pkg, "monitor.sampler").TransportMetricSampler,
        LoadMonitor=lm.LoadMonitor, LoadMonitorConfig=lm.LoadMonitorConfig,
        ModelCompletenessRequirements=_m(pkg, "monitor.completeness")
        .ModelCompletenessRequirements,
        Executor=ex.Executor, ExecutorConfig=ex.ExecutorConfig,
        SimulatorClusterDriver=ex.SimulatorClusterDriver,
        TopologyFingerprint=ex.TopologyFingerprint,
        CruiseControlConfig=_m(pkg, "config").CruiseControlConfig,
        ChaosHarness=chaos.ChaosHarness, ChaosPlan=chaos.ChaosPlan,
        Perturbation=chaos.Perturbation)


def _proposal(pkg, p, old, new, mb=0.0, tp=None):
    return _m(pkg, "analyzer.proposals").ExecutionProposal(
        partition=p, old_replicas=old, new_replicas=new, data_to_move_mb=mb, topic_partition=tp)


def _both(fn):
    """fn(pkg) on each package; the port's result must equal the JAX one's."""
    j, t = fn(JAX), fn(PORT)
    assert t == j
    return t


def _assignment(sim):
    return np.asarray(sim.fetch_topology().assignment)


def _record(summary, sim):
    """An execution summary without ids, times and run ids (chip_smoke's
    execution_record), and the simulator's assignment afterwards."""
    return chip_smoke.execution_record(summary, _assignment(sim))


# -- task state machine, strategies, planner, manager ----------------------------


def test_task_state_machine_valid_and_invalid():
    def run(pkg):
        task = _m(pkg, "executor.task")
        t = task.ExecutionTask(0, _proposal(pkg, 0, (0, 1), (2, 1)),
                               task.TaskType.INTER_BROKER_REPLICA_ACTION)
        seen = [t.state.name]
        errors = []
        for step in ("completed", "in_progress", "abort", "aborted", "in_progress", "kill"):
            try:
                getattr(t, step)()
            except ValueError as e:
                errors.append(str(e))
            seen.append(t.state.name)
        return seen, errors, t.done, sorted(t.involved_brokers)

    seen, errors, done, brokers = _both(run)
    assert seen[-1] == "ABORTED" and done and len(errors) == 3 and brokers == [0, 2]


def _sized_tasks(pkg):
    task = _m(pkg, "executor.task")
    return [task.ExecutionTask(i, _proposal(pkg, i, (0,), (1,), mb=mb),
                               task.TaskType.INTER_BROKER_REPLICA_ACTION)
            for i, mb in enumerate((10.0, 99.0, 50.0, 99.0, 0.5))]


@pytest.mark.parametrize("chain", ["base", "large", "small", "urp+large", "urp+small+base"])
def test_strategies_order_and_chain_equal_jax(chain):
    def run(pkg):
        s = _m(pkg, "executor.strategy")
        names = {"base": s.BaseReplicaMovementStrategy, "large":
                 s.PrioritizeLargeReplicaMovementStrategy,
                 "small": s.PrioritizeSmallReplicaMovementStrategy,
                 "urp": s.PostponeUrpReplicaMovementStrategy}
        parts = [names[n]() for n in chain.split("+")]
        strat = parts[0]
        for nxt in parts[1:]:
            strat = strat.chain(nxt)
        return [t.proposal.partition for t in strat.apply(_sized_tasks(pkg), urp={2, 4})]

    order = _both(run)
    assert sorted(order) == [0, 1, 2, 3, 4]


def test_planner_skips_noops_and_caps_concurrency_equal_jax():
    def run(pkg):
        planner = _m(pkg, "executor.planner").ExecutionTaskPlanner()
        planner.add_execution_proposals([
            _proposal(pkg, 0, (0, 1), (2, 1)), _proposal(pkg, 1, (0, 1), (0, 1)),
            _proposal(pkg, 2, (3, 4), (4, 3)), _proposal(pkg, 3, (5, 6), (7, 5)),
            _proposal(pkg, 4, (0, 1), (2, 3)), _proposal(pkg, 5, (1, 2), (1, 2, 4)),
            _proposal(pkg, 6, (0, 6), (2, 6)),
        ], current_assignment={4: (2, 3)}, provenance_run="run-x")
        moves = [(t.proposal.partition, t.task_type.name, t.provenance_id)
                 for t in planner.remaining_inter_broker_replica_movements]
        leads = [t.proposal.partition for t in planner.remaining_leadership_movements]
        slots = {b: 1 for b in range(8)}
        batch = [t.proposal.partition
                 for t in planner.get_inter_broker_replica_movement_tasks(slots)]
        capped = [t.proposal.partition for t in planner.get_leadership_movement_tasks(1)]
        return moves, leads, batch, slots, capped

    moves, leads, batch, _, _ = _both(run)
    assert [m[0] for m in moves] == [0, 3, 5, 6] and leads == [2]
    assert batch == [0, 3, 5]  # 6 needs brokers 0 and 2, whose one slot 0 took


def test_manager_tracks_in_flight_and_slots_equal_jax():
    def run(pkg):
        task = _m(pkg, "executor.task")
        mgr = _m(pkg, "executor.manager").ExecutionTaskManager(
            concurrent_partition_movements_per_broker=2, max_leadership_movements=5)
        t1 = task.ExecutionTask(0, _proposal(pkg, 0, (0,), (1,)),
                                task.TaskType.INTER_BROKER_REPLICA_ACTION)
        t2 = task.ExecutionTask(1, _proposal(pkg, 1, (0, 2), (2, 0)), task.TaskType.LEADER_ACTION)
        mgr.mark_in_progress([t1, t2], now_ms=1)
        out = [mgr.available_slots([0, 1, 2]), len(mgr.in_flight_tasks)]
        t1.completed(2)
        mgr.mark_done(t1)
        mgr.set_concurrency(per_broker=3, leadership=7)
        out += [mgr.available_slots([0, 1, 2]), mgr.leadership_cap,
                {k: v for k, v in mgr.tracker.summary().items()}]
        return out

    out = _both(run)
    assert out[0] == {0: 1, 1: 1, 2: 2} and out[4]["numFinishedMovements"] == 1


# -- execution on the simulator ----------------------------------------------------


def _unbalanced_sim(pkg):
    return _m(pkg, "testing.simulator").SimulatedCluster(_m(pkg, "models.generators").unbalanced())


def test_executor_end_to_end_on_simulator_equal_jax():
    def run(pkg):
        ex = _m(pkg, "executor")
        sim = _unbalanced_sim(pkg)
        props = [_proposal(pkg, 0, (0, 1), (2, 1), mb=5.0), _proposal(pkg, 2, (0, 2), (2, 0))]
        execu = ex.Executor(ex.SimulatorClusterDriver(sim, latency_polls=3),
                            config=ex.ExecutorConfig(execution_progress_check_interval_s=0.001))
        summary = execu.execute_proposals(props)
        return _record(summary, sim), execu.state, sim.leader_of(2)

    rec, state, leader = _both(run)
    assert rec["numFinishedMovements"] == 2 and not rec["stopped"]
    assert state == "NO_TASK_IN_PROGRESS" and leader == 2


def test_executor_pauses_sampling_and_records_history_equal_jax():
    class FakeMonitor:
        def __init__(self):
            self.events = []

        def pause_metric_sampling(self, reason=""):
            self.events.append(("pause", reason))

        def resume_metric_sampling(self):
            self.events.append(("resume", ""))

    def run(pkg):
        ex = _m(pkg, "executor")
        history = _m(pkg, "common.history").HISTORY
        history.reset()  # the boundary's rate limit starts afresh
        snapshots = history.state()["snapshots"]
        mon = FakeMonitor()
        execu = ex.Executor(ex.SimulatorClusterDriver(_unbalanced_sim(pkg)), load_monitor=mon,
                            config=ex.ExecutorConfig(execution_progress_check_interval_s=0.001))
        execu.execute_proposals([_proposal(pkg, 0, (0, 1), (2, 1))], removed_brokers={0},
                                demoted_brokers={1})
        return (mon.events, execu.recently_removed_brokers, execu.recently_demoted_brokers,
                history.state()["snapshots"] - snapshots,
                sorted(execu.state_summary()))

    events, removed, demoted, snaps, keys = _both(run)
    assert events == [("pause", "proposal execution"), ("resume", "")]
    assert (removed, demoted, snaps) == ({0}, {1}, 1)


def test_executor_refuses_concurrent_and_ongoing_equal_jax():
    def run(pkg):
        ex = _m(pkg, "executor")
        task = _m(pkg, "executor.task")
        driver = ex.SimulatorClusterDriver(_unbalanced_sim(pkg), latency_polls=1)
        driver.start_replica_movement(task.ExecutionTask(
            99, _proposal(pkg, 1, (0, 2), (1, 2)), task.TaskType.INTER_BROKER_REPLICA_ACTION))
        with pytest.raises(RuntimeError) as e:
            ex.Executor(driver).execute_proposals([_proposal(pkg, 0, (0, 1), (2, 1))])
        return str(e.value)

    assert "ongoing" in _both(run)


def test_reassignment_journal_driver_equal_jax(tmp_path):
    """The file journal an external controller agent acts on: both packages
    write the same journal entries and drain it once the agent acks."""
    def run(pkg):
        ex = _m(pkg, "executor")
        journal_dir = str(tmp_path / pkg)
        driver = _m(pkg, "executor.driver").ReassignmentJournalDriver(journal_dir)
        props = [_proposal(pkg, 0, (0, 1), (2, 1), tp="topic-0"),
                 _proposal(pkg, 2, (0, 2), (2, 0), tp="topic-2")]
        written = []
        stop = threading.Event()

        def controller_agent():
            path = os.path.join(journal_dir, "reassign_partitions.json")
            while not stop.wait(0.005):
                try:
                    with open(path) as f:
                        entries = json.load(f)["partitions"]
                except (OSError, ValueError):
                    continue
                for e in entries:
                    key = (e["topic"], e["partition"], tuple(e["replicas"]))
                    if key not in written:
                        written.append(key)
                    with open(os.path.join(journal_dir, "completed",
                                           f"{e['executionId']}.json"), "w") as f:
                        json.dump({"done": True}, f)

        th = threading.Thread(target=controller_agent, daemon=True)
        th.start()
        try:
            result = ex.Executor(driver, config=ex.ExecutorConfig(
                execution_progress_check_interval_s=0.005)).execute_proposals(props)
        finally:
            stop.set()
            th.join(timeout=2)
        return (result["numFinishedMovements"], sorted(written),
                driver.has_ongoing_reassignment(), os.listdir(os.path.join(journal_dir,
                                                                            "completed")))

    finished, written, ongoing, acks = _both(run)
    assert finished == 2 and not ongoing and acks == []
    assert written == [("topic", 0, (2, 1)), ("topic", 2, (2, 0))]


# -- drift validation: every reason code -------------------------------------------


def _small_sim(pkg, seed=7):
    gen = _m(pkg, "models.generators")
    return _m(pkg, "testing.simulator").SimulatedCluster(gen.random_cluster(
        seed, gen.ClusterProperty(num_racks=3, num_brokers=6, num_topics=4,
                                  replication_factor=2)))


def _view(pkg, sim):
    return _m(pkg, "executor.validation").TopologyView(sim.fetch_topology())


def _movement_for(pkg, sim, row):
    view = _view(pkg, sim)
    old = view.replicas(row)
    dst = next(b for b in range(view.num_brokers) if b not in old and not view.broker_dead(b))
    return _proposal(pkg, row, old, (dst,) + tuple(old[1:]), tp=view.name_of(row))


def _fp(pkg, sim):
    return _m(pkg, "executor.validation").TopologyFingerprint.from_topology(sim.fetch_topology())


def test_fingerprint_and_its_drift_equal_jax():
    def run(pkg):
        sim = _small_sim(pkg)
        base = _fp(pkg, sim)
        out = [base.to_dict(), base.digest, base.num_alive]
        sim.spike_load(0, 8.0)
        out.append(_fp(pkg, sim) == base)
        sim.kill_broker(2)
        out.append(base.diff(_fp(pkg, sim)))
        sim.restore_broker(2)
        sim.delete_topic(1)
        gone = _fp(pkg, sim)
        sim.add_partitions(0, 2)
        out += [base.diff(gone), gone.diff(_fp(pkg, sim)), _fp(pkg, sim).digest]
        return out

    out = _both(run)
    assert out[3] is True and out[4]["brokersDied"] == [2]
    assert out[5]["topicsGone"] == ["topic-1"] and "topic-0" in out[6]["partitionCountChanged"]


def _reason_cases(pkg):
    """(case, reason code) of every validator outcome on fresh simulators."""
    V = _m(pkg, "executor.validation")
    out = []
    sim = _small_sim(pkg)
    out.append(("fresh", V.validate_proposal(_movement_for(pkg, sim, 0), _view(pkg, sim))))
    p = _movement_for(pkg, sim, 0)
    sim.kill_broker(p.replicas_to_add[0])
    out.append(("dest dead", V.validate_proposal(p, _view(pkg, sim))))
    bad = dataclasses.replace(p, new_replicas=(99,) + p.new_replicas[1:])
    out.append(("dest invalid", V.validate_proposal(bad, _view(pkg, sim))))
    sim = _small_sim(pkg)
    view = _view(pkg, sim)
    row_t1 = next(r for _, r in view.items() if view.name_of(r).startswith("topic-1-"))
    row_t3 = next(r for _, r in view.items() if view.name_of(r).startswith("topic-3-"))
    gone, shifted = _movement_for(pkg, sim, row_t1), _movement_for(pkg, sim, row_t3)
    sim.delete_topic(1)
    out.append(("topic gone", V.validate_proposal(gone, _view(pkg, sim))))
    out.append(("remapped", V.validate_proposal(shifted, _view(pkg, sim))))
    sim = _small_sim(pkg)
    view = _view(pkg, sim)
    p = _movement_for(pkg, sim, view.num_partitions - 1)
    missing = dataclasses.replace(p, topic_partition=p.topic_partition.rsplit("-", 1)[0] + "-9999")
    out.append(("partition gone", V.validate_proposal(missing, view)))
    out.append(("past the rows", V.validate_proposal(
        dataclasses.replace(p, partition=10_000, topic_partition=None), view)))
    p = _movement_for(pkg, sim, 0)
    other = next(b for b in range(6) if not sim.has_partition(0, b) and b != p.replicas_to_add[0])
    sim.apply_movement(0, p.replicas_to_remove[0], other)
    out.append(("replica moved", V.validate_proposal(p, _view(pkg, sim))))
    sim = _small_sim(pkg)
    p = _movement_for(pkg, sim, 0)
    sim.add_replica(0, next(b for b in range(6) if b not in _view(pkg, sim).replicas(0)))
    out.append(("rf changed", V.validate_proposal(p, _view(pkg, sim))))
    sim = _small_sim(pkg)
    view = _view(pkg, sim)
    old = view.replicas(0)
    lead = _proposal(pkg, 0, old, (old[1], old[0]) + tuple(old[2:]), tp=view.name_of(0))
    out.append(("leadership", V.validate_proposal(lead, view)))
    sim.kill_broker(old[1])
    out.append(("leadership dest dead", V.validate_proposal(lead, _view(pkg, sim))))
    return out


def test_every_reason_code_equal_jax():
    cases = _both(_reason_cases)
    V = _m(PORT, "executor.validation")
    got = {reason for _, reason in cases}
    assert set(V.REASON_CODES) - {V.GENERATION_SKEW} <= got and None in got
    assert _m(JAX, "executor.validation").REASON_CODES == V.REASON_CODES


def test_validate_proposals_splits_valid_and_trimmed_equal_jax():
    def run(pkg):
        sim = _small_sim(pkg)
        props = [_movement_for(pkg, sim, r) for r in range(6)]
        sim.kill_broker(props[1].replicas_to_add[0])
        valid, trimmed = _m(pkg, "executor.validation").validate_proposals(
            props, sim.fetch_topology())
        return ([p.partition for p in valid], [(p.partition, r) for p, r in trimmed])

    valid, trimmed = _both(run)
    assert trimmed and {r for _, r in trimmed} == {"DEST_DEAD"}


def _executor_over(pkg, sim, **config):
    ex = _m(pkg, "executor")
    mc = _m(pkg, "monitor.metadata").MetadataClient(sim.fetch_topology, ttl_s=0.0)
    gen = {"extra": 0}
    execu = ex.Executor(
        ex.SimulatorClusterDriver(sim, latency_polls=1),
        config=ex.ExecutorConfig(execution_progress_check_interval_s=0.001, **config),
        topology_source=lambda: mc.refresh_metadata(force=True),
        generation_source=lambda: mc.generation + gen["extra"])
    return execu, mc, gen


def test_admission_trims_stale_proposals_and_executes_rest_equal_jax():
    def run(pkg):
        sim = _small_sim(pkg)
        execu, mc, _ = _executor_over(pkg, sim)
        props = [_movement_for(pkg, sim, r) for r in range(4)]
        stamp_gen = mc.generation
        fp = _m(pkg, "executor.validation").TopologyFingerprint.from_topology(
            mc.refresh_metadata(force=True))
        sim.kill_broker(props[1].replicas_to_add[0])
        summary = execu.execute_proposals(props, generation=stamp_gen, fingerprint=fp,
                                          provenance_run="run-1")
        v = summary["proposalValidation"]
        return (_record(summary, sim), v["fingerprintDrift"], v["fingerprintAtBuild"],
                [t["provenanceId"] for t in v["trimmed"]], execu.state)

    rec, drift, _, ids, state = _both(run)
    assert rec["trimmedByReason"] == {"DEST_DEAD": rec["numTrimmed"]} and rec["numTrimmed"] >= 1
    assert drift["brokersDied"] and all(i.startswith("run-1/p") for i in ids)
    assert state == "NO_TASK_IN_PROGRESS"


def test_generation_skew_abort_never_raises_and_notifies_equal_jax():
    def run(pkg):
        sim = _small_sim(pkg)
        execu, mc, gen = _executor_over(pkg, sim, max_generation_skew=2)
        events, drift = [], []
        execu._notifier = lambda e, info: events.append(e)
        execu.set_drift_listener(drift.append)
        stamp_gen = mc.generation
        gen["extra"] = 5
        summary = execu.execute_proposals(
            [_movement_for(pkg, sim, 0), _movement_for(pkg, sim, 1)], generation=stamp_gen,
            fingerprint=_fp(pkg, sim))
        v = summary["proposalValidation"]
        return (_record(summary, sim), v["abortReason"], events, drift,
                execu.state_summary()["proposalValidation"]["aborted"])

    rec, reason, events, drift, aborted = _both(run)
    assert rec["aborted"] and "generation skew" in reason and aborted
    assert rec["trimmedByReason"] == {"GENERATION_SKEW": 2} and rec["numTotalMovements"] == 0
    assert "proposal_batch_aborted" in events and drift[0]["generationSkew"] == 5


@pytest.mark.parametrize("case", ["revalidation off", "unstamped", "no topology source"])
def test_validation_switches_equal_jax(case):
    def run(pkg):
        sim = _small_sim(pkg)
        stale = _movement_for(pkg, sim, 0)
        if case == "no topology source":
            ex = _m(pkg, "executor")
            execu = ex.Executor(ex.SimulatorClusterDriver(sim), config=ex.ExecutorConfig(
                execution_progress_check_interval_s=0.001))
            sim.kill_broker(stale.replicas_to_add[0])
            return _record(execu.execute_proposals([stale]), sim)
        execu, mc, gen = _executor_over(pkg, sim, proposal_revalidate=case == "unstamped",
                                        max_generation_skew=1)
        sim.kill_broker(stale.replicas_to_add[0])
        if case == "unstamped":
            return _record(execu.execute_proposals([stale]), sim)
        gen["extra"] = 50
        return _record(execu.execute_proposals([stale], generation=mc.generation - 50,
                                               fingerprint=_fp(pkg, sim)), sim)

    rec = _both(run)
    if case == "unstamped":
        assert rec["trimmedByReason"] == {"DEST_DEAD": 1}
    else:  # nothing validates: the stale task is dispatched and applied blindly
        assert rec["numTrimmed"] == 0 and rec["byState"]["COMPLETED"] == 1


# -- retry policy, circuit breaker and sensor history under scripted clocks --------


def test_retry_policy_under_a_scripted_sleep_equal_jax():
    def run(pkg):
        retry = _m(pkg, "common.retry")
        now = {"t": 0.0}
        sleeps = []

        def sleep(s):
            sleeps.append(s)
            now["t"] += s

        out = []
        for fails, kwargs in ((2, {}), (9, {}), (9, {"deadline_s": 0.5}), (0, {})):
            calls = {"n": 0}

            def fn(fails=fails):
                calls["n"] += 1
                if calls["n"] <= fails:
                    raise ConnectionError(f"attempt {calls['n']}")
                return calls["n"]

            policy = retry.RetryPolicy(max_attempts=5, backoff_s=0.1, max_backoff_s=0.3,
                                       clock=lambda: now["t"], sleep=sleep, **kwargs)
            try:
                out.append(("ok", policy.call(fn, name="torch-port-test")))
            except retry.RetryExhaustedError as e:
                out.append(("exhausted", str(e), str(e.__cause__)))
        with pytest.raises(ValueError, match="not retried"):
            retry.RetryPolicy(sleep=sleep).call(
                lambda: (_ for _ in ()).throw(ValueError("not retried")))
        return out, sleeps

    out, sleeps = _both(run)
    assert out[0] == ("ok", 3) and out[1][0] == "exhausted" and out[3] == ("ok", 1)
    assert sleeps[:2] == [0.1, 0.2]


def test_circuit_breaker_under_a_scripted_clock_equal_jax():
    def run(pkg):
        retry = _m(pkg, "common.retry")
        now = {"t": 0.0}
        br = retry.CircuitBreaker("torch-port-test", failure_threshold=2, cooldown_s=30.0,
                                  clock=lambda: now["t"])
        trail = []
        for step in ("fail", "fail", "allow", "t+31", "allow", "allow", "fail", "t+31",
                     "allow", "ok", "allow"):
            if step == "fail":
                br.record_failure()
            elif step == "ok":
                br.record_success()
            elif step == "allow":
                trail.append(br.allow())
            else:
                now["t"] += 31.0
            trail.append((br.state, br.remaining_cooldown_s()))
        return trail, br.snapshot()

    trail, snap = _both(run)
    assert snap["state"] == "closed" and snap["opens"] == 2


def test_sensor_history_under_a_scripted_clock_equal_jax():
    def run(pkg):
        h = _m(pkg, "common.history")
        reg = _m(pkg, "common.sensors").REGISTRY
        now = {"t": 100.0}
        store = h.TimeSeriesStore(ring_size=32, clock=lambda: now["t"],
                                  boundary_min_spacing_s=0.0)
        meter = reg.meter("TorchPortHistoryTest.events")
        base = meter.count
        for i in range(6):
            meter.mark(i + 1)
            now["t"] += 10.0
            (store.record_boundary if i % 2 else store.snapshot_now)(
                "proposal" if i % 2 else "tick")
        q = store.query(pattern="TorchPortHistoryTest.*")
        for v in q.values():
            for k in ("first", "last", "min", "max", "p50", "p95"):
                v[k] -= base
        series = [[t, v - base] for t, v in store.series(
            "TorchPortHistoryTest.events.count", step_s=20.0)]
        state = {k: v for k, v in store.state().items() if k != "overheadS"}
        return (q, series, state, h.flatten_snapshot({"a": 1, "b": {"c": 2.5, "d": "x"},
                                                      "e": True, "f": "s"}))

    q, series, state, flat = _both(run)
    assert q["TorchPortHistoryTest.events.count"]["delta"] == 20.0
    assert state["snapshots"] == 6 and flat == {"a": 1.0, "b.c": 2.5, "e": 1.0}


# -- the slice end to end: metrics -> monitor -> solve -> stamps -> execution --------


WINDOWS = 2


def _cluster(pkg):
    gen = _m(pkg, "models.generators")
    return gen.random_cluster(17, gen.ClusterProperty(
        num_racks=3, num_brokers=12, num_topics=30, mean_partitions_per_topic=8.0,
        replication_factor=3, num_dead_brokers=1, load_distribution="pareto",
        mean_utilization=0.5))


def _solve(pkg, model):
    o = _m(pkg, "analyzer.optimizer")
    if pkg == JAX:
        return o.GoalOptimizer(settings=o.OptimizerSettings(**JAX_SERVICE)).optimizations(
            model, None, raise_on_hard_failure=False)
    settings = dataclasses.replace(o.SERVICE_SETTINGS, chunk_target_s=1e9)
    return o.GoalOptimizer(device="cpu", settings=settings).optimizations(
        model, None, raise_on_hard_failure=False)


@pytest.fixture(scope="module")
def slice_runs():
    """Each package: chip_smoke.monitored_model on the 12-broker cluster, the
    service solve, chip_smoke.stamp, chip_smoke.execute_monitored on the
    simulator that emitted the metrics, a second model build, then
    chip_smoke.chaos_run of the same proposals on a fresh simulator."""
    out = {}
    for pkg in PKGS:
        ns = _ns(pkg)
        model, meta, _, _, sim, monitor = chip_smoke.monitored_model(_cluster(pkg), ns)
        res = chip_smoke.stamp(_solve(pkg, model), monitor, meta, ns)
        summary, batches, paused, _ = chip_smoke.execute_monitored(res, sim, monitor, ns)
        rebuilt, _ = monitor.cluster_model(ns.ModelCompletenessRequirements(
            min_required_num_windows=1, min_monitored_partitions_percentage=0.5))
        victim, csummary, harness, _ = chip_smoke.chaos_run(model, res, ns)
        out[pkg] = dict(res=res, summary=summary, batches=batches, paused=paused,
                        sampling_paused=monitor.sampling_paused, after=_assignment(sim),
                        rebuilt=np.asarray(rebuilt.assignment), victim=victim,
                        chaos=csummary, harness=harness)
    return out


def test_slice_proposals_and_stamps_equal_jax(slice_runs):
    rj, rt = slice_runs[JAX]["res"], slice_runs[PORT]["res"]
    assert [p.to_dict() for p in rt.proposals] == [p.to_dict() for p in rj.proposals]
    assert all(p.topic_partition for p in rt.proposals)
    assert rt.generation == rj.generation and rt.generation > 0
    assert rt.fingerprint.to_dict() == rj.fingerprint.to_dict()
    assert rt.summary()["proposalStamp"] == rj.summary()["proposalStamp"]


def test_slice_execution_equals_jax(slice_runs):
    recs = {pkg: chip_smoke.execution_record(r["summary"], r["after"], r["batches"])
            for pkg, r in slice_runs.items()}
    assert recs[PORT] == recs[JAX]
    rec = recs[PORT]
    by = rec["byState"]
    assert by["PENDING"] == by["IN_PROGRESS"] == by["ABORTING"] == 0
    assert by["COMPLETED"] == rec["numTotalMovements"] > 0 and rec["numTrimmed"] == 0
    assert slice_runs[PORT]["batches"] == slice_runs[JAX]["batches"]
    v = slice_runs[PORT]["summary"]["proposalValidation"]
    assert v["provenanceRun"] == slice_runs[PORT]["res"].provenance.run_id


def test_slice_execution_reaches_the_solve_and_the_monitor(slice_runs):
    for r in slice_runs.values():
        want = np.asarray(r["res"].final_assignment)
        after = r["after"]
        assert all(set(a[a >= 0]) == set(w[w >= 0]) for a, w in zip(after, want))
        assert (after[:, 0] == want[:, 0]).all()
        assert np.array_equal(r["rebuilt"], after)
        assert r["paused"] and all(r["paused"]) and not r["sampling_paused"]
    assert np.array_equal(slice_runs[PORT]["after"], slice_runs[JAX]["after"])


def test_slice_chaos_run_equals_jax(slice_runs):
    recs = {pkg: chip_smoke.execution_record(r["chaos"], _assignment(r["harness"].sim))
            for pkg, r in slice_runs.items()}
    assert recs[PORT] == recs[JAX]
    assert slice_runs[PORT]["victim"] == slice_runs[JAX]["victim"]
    for r in slice_runs.values():
        h = r["harness"]
        assert h.checker.violations == [] and h.checker.check_final() == []
        assert h.plan.applied and h.plan.applied[0]["broker"] == r["victim"]
    by = recs[PORT]["byState"]
    assert by["PENDING"] == by["IN_PROGRESS"] == by["ABORTING"] == 0
    assert recs[PORT]["trimmedByReason"].get("DEST_DEAD", 0) >= 1
