"""The port's chaos replay harness against the JAX package's.

Every scenario of the JAX package's chaos suite (tests/test_chaos_replay.py:
broker deaths and revivals, topic deletes, partition adds, load spikes,
generation bumps) streams the same seeded perturbations into a fresh
simulated cluster of each package while its executor is mid-batch, on the
same hand-diffed stamped proposals. Both sides must hold every invariant
(no violation, the replication factor preserved, every task terminal) and
agree on everything a run decides: the proposals, the perturbations fired
and when, the per-state counts, the trims by reason and phase, the abort
and the cluster's assignment afterwards. Execution ids (seeded from the
clock) and durations are left out. The wire-level fault plans
(testing/faults.py) come with the cluster agent's wire, and the JAX suite's
wall-clock overhead share is not mirrored. Tolerance: exact.
"""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

JAX, PORT = "cruise_control_tpu", "cruise_control_torch"

#: the JAX suite's scenario matrix as (at_poll, action, keyword) rows, plus
#: synthetic monitor-generation drift
SCENARIOS = {
    "broker_death": [(2, "kill_broker", {"broker": 3})],
    "broker_death_then_revival": [(2, "kill_broker", {"broker": 3}),
                                  (8, "restore_broker", {"broker": 3})],
    "broker_death_then_rejoin_as_new": [(2, "kill_broker", {"broker": 3}),
                                        (6, "revive_broker", {"broker": 3})],
    "double_broker_death": [(2, "kill_broker", {"broker": 1}),
                            (5, "kill_broker", {"broker": 6})],
    "topic_delete": [(3, "delete_topic", {"topic": 2})],
    "partition_count_change": [(3, "add_partitions", {"topic": 1, "count": 4})],
    "hot_load_spike": [(2, "spike_load", {"topic": 0, "factor": 16.0}),
                       (5, "spike_load", {"topic": 3, "factor": 16.0})],
    "death_plus_topic_delete": [(2, "kill_broker", {"broker": 3}),
                                (6, "delete_topic", {"topic": 1})],
    "combined_everything": [(2, "kill_broker", {"broker": 3}),
                            (4, "delete_topic", {"topic": 4}),
                            (7, "add_partitions", {"topic": 2, "count": 2}),
                            (9, "spike_load", {"topic": 0, "factor": 8.0})],
    "early_death_mass_trim": [(1, "kill_broker", {"broker": 0}),
                              (1, "kill_broker", {"broker": 4})],
    "generation_bumps": [(2, "bump_generation", {"count": 3}),
                         (5, "bump_generation", {"count": 3})],
}


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _run(pkg, rows, seed, count=40, sim_seed=7, config=None, latency_polls=2):
    """One chaos run on the package; returns its comparable record and the
    harness."""
    gen = _m(pkg, "models.generators")
    chaos = _m(pkg, "testing.chaos")
    ex = _m(pkg, "executor.executor")
    sim = _m(pkg, "testing.simulator").SimulatedCluster(gen.random_cluster(
        sim_seed, gen.ClusterProperty(num_racks=3, num_brokers=8, num_topics=6,
                                      replication_factor=2)))
    plan = chaos.ChaosPlan([chaos.Perturbation(at_poll=at, action=a, **kw) for at, a, kw in rows])
    cfg = ex.ExecutorConfig(**config) if config is not None else None
    h = chaos.ChaosHarness(sim, plan, latency_polls=latency_polls, config=cfg)
    stamped = h.stamped_proposals(seed=seed, count=count)
    summary = h.execute(stamped)
    record = chip_smoke.execution_record(summary, np.asarray(sim.fetch_topology().assignment))
    v = summary["proposalValidation"]
    return dict(
        record=record,
        proposals=[p.to_dict() for p in stamped[0]],
        stamp=(stamped[1], stamped[2].to_dict()),
        applied=plan.applied,
        exhausted=plan.exhausted,
        violations=h.checker.violations,
        dispatches=h.checker.dispatches,
        evaporated=len(h.driver.evaporated),
        polls=h.driver.polls,
        drift=(v["fingerprintDrift"], v["abortReason"], v["generationAtStart"]),
        trimmed=[(t["partition"], t["topicPartition"], t["reason"], t["phase"])
                 for t in v["trimmed"]],
        state=h.executor.state,
    ), h


def _both(*args, **kwargs):
    j, _ = _run(JAX, *args, **kwargs)
    t, h = _run(PORT, *args, **kwargs)
    assert t == j
    return t, h


def _assert_invariants(out):
    assert out["violations"] == []
    by = out["record"]["byState"]
    assert by["PENDING"] == by["IN_PROGRESS"] == by["ABORTING"] == 0
    assert out["state"] == "NO_TASK_IN_PROGRESS"
    reasons = _m(PORT, "executor.validation").REASON_CODES
    assert all(t[2] in reasons for t in out["trimmed"])
    assert sum(out["record"]["trimmedByReason"].values()) == out["record"]["numTrimmed"]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_chaos_scenario_equals_jax_and_holds_invariants(name):
    out, _ = _both(SCENARIOS[name], seed=11 + len(name))
    _assert_invariants(out)
    assert out["exhausted"] and len(out["applied"]) == len(SCENARIOS[name])
    assert not out["record"]["aborted"]


def test_broker_death_trims_dest_dead_equal_jax():
    out, _ = _both(SCENARIOS["broker_death"], seed=13)
    _assert_invariants(out)
    assert out["record"]["trimmedByReason"].get("DEST_DEAD", 0) >= 1
    assert all(t[2] == "DEST_DEAD" for t in out["trimmed"])


def test_topic_delete_trims_gone_and_remapped_equal_jax():
    out, _ = _both([(3, "delete_topic", {"topic": 1})], seed=17)
    _assert_invariants(out)
    assert {"TOPIC_GONE", "PARTITION_REMAPPED"} <= set(out["record"]["trimmedByReason"])


def test_benign_perturbations_do_not_overtrim_equal_jax():
    out, _ = _both([(2, "add_partitions", {"topic": 1, "count": 4}),
                    (5, "spike_load", {"topic": 0, "factor": 32.0})], seed=19)
    _assert_invariants(out)
    rec = out["record"]
    assert rec["numTrimmed"] == 0 and rec["byState"]["COMPLETED"] == rec["numTotalMovements"]


def test_self_churn_never_trips_skew_abort_equal_jax():
    out, _ = _both([], seed=5, count=50, config=dict(
        num_concurrent_partition_movements_per_broker=1,
        execution_progress_check_interval_s=0.001, max_generation_skew=1))
    _assert_invariants(out)
    rec = out["record"]
    assert not rec["aborted"] and rec["numTrimmed"] == 0
    assert rec["byState"]["COMPLETED"] == rec["numTotalMovements"] > 0


def test_structural_drift_past_skew_aborts_mid_batch_equal_jax():
    """Widely spaced structural changes step the effective skew past its
    threshold (a generation bump alone does not: during execution only
    structural changes count, the generation_bumps scenario above)."""
    rows = [(2, "kill_broker", {"broker": 1}), (8, "kill_broker", {"broker": 2}),
            (14, "kill_broker", {"broker": 6})]
    out, _ = _both(rows, seed=29, count=60, config=dict(
        num_concurrent_partition_movements_per_broker=1,
        execution_progress_check_interval_s=0.001, max_generation_skew=1))
    _assert_invariants(out)
    rec = out["record"]
    assert rec["aborted"] and "generation skew" in out["drift"][1]
    assert rec["trimmedByReason"].get("GENERATION_SKEW", 0) >= 1
    assert rec["byState"]["ABORTED"] >= 1


def test_chaos_metrics_and_spans_visible_in_the_port():
    out, _ = _both(SCENARIOS["broker_death"], seed=41)
    assert out["record"]["numTrimmed"] >= 1
    text = _m(PORT, "common.sensors").REGISTRY.prometheus_text()
    for sensor in ("Executor.proposal-trimmed", "Executor.proposal-trimmed.DEST_DEAD",
                   "Executor.generation-skew", "Executor.revalidation-timer"):
        assert f'sensor="{sensor}' in text, sensor
    kinds = {s["kind"] for s in _m(PORT, "common.tracing").TRACER.recent(limit=512)}
    assert {"validation", "executor"} <= kinds


def test_dense_masks_and_name_keyed_addressing_equal_jax():
    """A topic delete mid-flight shifts rows under in-flight movements: the
    chaos driver resolves them by name, or lets them evaporate with their
    topic, the same way in both packages; the dense-mask audit stays clean."""
    out, h = _both([(2, "delete_topic", {"topic": 0}), (2, "add_partitions",
                                                       {"topic": 5, "count": 3})],
                   seed=23, latency_polls=4)
    _assert_invariants(out)
    assert h.checker.check_dense_masks() == []
    assert out["dispatches"] > 0
