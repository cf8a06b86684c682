"""The service's proposal path: the port's chunked goal machine with the
provenance ledger and the cluster statistics (`SERVICE_EXACT_SETTINGS`) against
the JAX package's chunked ledger run of the same settings, on fixture C
(32 brokers in 4 racks, 80 topics, 766 partitions at RF 3, pareto load,
2 dead brokers), at chunk budgets of 32 and 3 rounds (with 3, goals pause
and resume in the middle). Compared exactly: the final assignment, touch
tags, proposals, the StackMetrics integers with the state fingerprints, the
statistics before and after, and the decision digest. The port's chunked
run equals its fused run, a hard-goal subset through the machine equals a
fused run of the subset, and the port's ledger JSON reads back through the
JAX package's RunLedger and the unchanged scripts/diff_runs.py. The JAX
machine compiles once for the module (its programs ignore the chunk
budget). No assertion reads a clock.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cruise_control_tpu.analyzer import optimizer as jopt
from cruise_control_tpu.analyzer.provenance import RunLedger as JRunLedger
from cruise_control_tpu.analyzer.stats import stats_to_dict as jstats_to_dict
from cruise_control_tpu.models import generators as jgen
from cruise_control_torch.analyzer import optimizer as topt
from cruise_control_torch.analyzer.goals import HARD_GOAL_NAMES
from cruise_control_torch.analyzer.provenance import RunLedger
from cruise_control_torch.analyzer.stats import stats_to_dict
from cruise_control_torch.models.flat_model import from_numpy


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU path runs on small tensors, where torch's intra-op
    threads buy nothing, and the suite runs in several worker processes at
    once: threads that outnumber the cores wait on each other (six 8-thread
    processes on 8 cores ran a solve 30x slower than single-thread ones)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parents[1]
FIXTURE_C = jgen.ClusterProperty(num_racks=4, num_brokers=32, num_topics=80,
                                 mean_partitions_per_topic=10, replication_factor=3,
                                 num_dead_brokers=2, load_distribution="pareto",
                                 mean_utilization=0.5)
#: the JAX side of SERVICE_EXACT_SETTINGS (with another batch_k=1 grid width,
#: num_dst_candidates, which batch_k = 16 never reads)
JAX_SERVICE = dict(batch_k=16, max_rounds_per_goal=64, drain_src=512, drain_per_broker=8,
                   drain_dst=64, apply_waves=8, bulk_waves=16, bulk_min_brokers=32,
                   num_swap_pairs=8, swap_candidates=8, swaps_per_broker=4, polish_rounds=0,
                   chunk_rounds=32, bucket_partitions=False, bucket_brokers=False,
                   ledger=True, num_dst_candidates=8)
INT_METRICS = ("violated_before", "violated_after", "rounds", "converged", "state_fp")
CHUNKS = (32, 3)


def _capturing(opt):
    """Wrap `opt._run_chunked` to keep what it returns (agg, metrics, ...)."""
    seen = []
    inner = opt._run_chunked

    def run(*args, **kwargs):
        out = inner(*args, **kwargs)
        seen.append(out)
        return out

    opt._run_chunked = run
    return seen


def _port_run(settings, goal_names=None):
    tmodel = from_numpy({k: np.asarray(v) for k, v in _model()._asdict().items()})
    opt = topt.GoalOptimizer(settings=settings, device="cpu")
    seen = _capturing(opt)
    res = opt.optimizations(tmodel, goal_names, raise_on_hard_failure=False)
    return res, (seen[0][1] if seen else None)


def _model():
    return jgen.random_cluster(42, FIXTURE_C)


@pytest.fixture(scope="module")
def runs():
    """{chunk: (jax result, jax metrics, jax touch tags, port result, port
    metrics)} plus the port's fused run."""
    out = {}
    for chunk in CHUNKS:
        jo = jopt.GoalOptimizer(settings=jopt.OptimizerSettings(**dict(JAX_SERVICE,
                                                                       chunk_rounds=chunk)))
        seen = _capturing(jo)
        jres = jo.optimizations(_model(), None, raise_on_hard_failure=False)
        jagg, jmetrics = seen[0][0], jax.device_get(seen[0][1])
        tres, tmetrics = _port_run(dataclasses.replace(topt.SERVICE_EXACT_SETTINGS,
                                                       chunk_rounds=chunk))
        out[chunk] = (jres, jmetrics, np.asarray(jax.device_get(jagg.touch_tag)), tres, tmetrics)
    out["fused"] = _port_run(dataclasses.replace(topt.STACK_SETTINGS, ledger=True))[0]
    return out


def _all_goals(res):
    return [g.name for g in res.goal_results]


def test_service_settings_are_the_service_defaults_but_bucketing():
    """SERVICE_EXACT_SETTINGS are the service defaults but bucketing;
    SERVICE_SETTINGS, the service's own, add it (tests/test_torch_bucketing.py
    holds the bucketed run)."""
    s = topt.SERVICE_EXACT_SETTINGS
    assert (s.chunk_rounds, s.ledger, s.polish_rounds, s.batch_k) == (32, True, 0, 16)
    assert not s.bucket_partitions and not s.bucket_brokers
    assert topt.SERVICE_SETTINGS == dataclasses.replace(s, bucket_partitions=True,
                                                        bucket_brokers=True)
    assert dataclasses.replace(s, chunk_rounds=0, ledger=False) == topt.STACK_SETTINGS
    for k, v in JAX_SERVICE.items():
        if k != "num_dst_candidates":
            assert getattr(s, k) == v, k


@pytest.mark.parametrize("chunk", CHUNKS)
def test_final_assignment_and_touch_tags_equal_jax(runs, chunk):
    jres, _, jtouch, tres, _ = runs[chunk]
    assert np.array_equal(np.asarray(jres.final_assignment), tres.final_assignment)
    assert np.array_equal(jtouch, tres.touch_tag)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_proposals_equal_jax(runs, chunk):
    jres, _, _, tres, _ = runs[chunk]
    assert (tres.num_replica_moves, tres.num_leadership_moves) == (
        jres.num_replica_moves, jres.num_leadership_moves)

    def key(prs):
        return [(p.partition, p.old_replicas, p.new_replicas, p.data_to_move_mb) for p in prs]

    assert key(jres.proposals) == key(tres.proposals)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_stack_metrics_integers_equal_jax(runs, chunk):
    _, jm, _, _, tm = runs[chunk]
    for field in INT_METRICS:
        assert np.array_equal(np.asarray(getattr(jm, field)).astype(np.int64),
                              np.asarray(getattr(tm, field)).astype(np.int64)), field
    # the goals' costs: float32 sums in XLA:CPU's order, a fused cost's
    # vectorized one included (kernels/window_sum.py FusedOrder), bit for bit
    for field in ("cost_before", "cost_after"):
        want = np.asarray(getattr(jm, field), dtype=np.float32)
        got = np.asarray(getattr(tm, field), dtype=np.float32)
        assert np.array_equal(want.view(np.int32), got.view(np.int32)), field


@pytest.mark.parametrize("chunk", CHUNKS)
def test_stats_before_and_after_equal_jax(runs, chunk):
    jres, _, _, tres, _ = runs[chunk]
    assert stats_to_dict(tres.stats_before) == jstats_to_dict(jres.stats_before)
    assert stats_to_dict(tres.stats_after) == jstats_to_dict(jres.stats_after)
    assert stats_to_dict(tres.stats_after) != stats_to_dict(tres.stats_before)


def _without_durations(summary):
    """A result summary less what a run cannot repeat: durations and the
    provenance run id."""
    out = {k: v for k, v in summary.items() if k != "durationS"}
    out["goals"] = [{k: v for k, v in g.items() if k != "durationS"} for g in out["goals"]]
    if "provenance" in out:
        out["provenance"] = {k: v for k, v in out["provenance"].items() if k != "runId"}
    return out


def test_result_summary_and_stamps_equal_jax(runs):
    """The port's OptimizerResult carries the JAX class's drift-safety stamps
    and its summary(): each result named and stamped as the JAX facade does
    it (facade.py:133-141 and :158-167) against its package's simulated
    topology of fixture C, then summarized, equal key for key less durations
    and run ids."""
    from cruise_control_tpu.facade import CruiseControl
    from cruise_control_tpu.testing.simulator import SimulatedCluster as JSim
    from cruise_control_torch.executor.validation import TopologyFingerprint
    from cruise_control_torch.models import generators as tgen
    from cruise_control_torch.testing.simulator import SimulatedCluster as TSim

    jres, tres = dataclasses.replace(runs[32][0]), dataclasses.replace(runs[32][3])
    assert (tres.generation, tres.fingerprint) == (jres.generation, jres.fingerprint) == \
        (None, None)
    assert "proposalStamp" not in tres.summary()
    jmodel = _model()
    jres = CruiseControl._stamp_result(
        CruiseControl._attach_topic_names(jres, jgen.metadata_for(jmodel)), 7,
        JSim(jmodel).fetch_topology())
    tmodel = from_numpy({k: np.asarray(v) for k, v in jmodel._asdict().items()})
    meta = tgen.metadata_for(tmodel)
    tres.proposals = [dataclasses.replace(p, topic_partition=meta.topic_partition(p.partition))
                      for p in tres.proposals]
    tres.generation = 7
    tres.fingerprint = TopologyFingerprint.from_topology(TSim(tmodel).fetch_topology())
    js, ts = jres.summary(), tres.summary()
    assert list(ts) == list(js)
    # the goals' costs and the ledger's cost deltas and checksum included,
    # exactly (fault F4)
    assert _without_durations(ts) == _without_durations(js)
    assert ts["proposalStamp"]["generation"] == 7
    assert ts["proposalStamp"]["fingerprint"]["numBrokers"] == 32
    assert ts["provenance"]["runId"] == tres.provenance.run_id
    assert [p.to_dict() for p in tres.proposals] == [p.to_dict() for p in jres.proposals]


@pytest.mark.parametrize("chunk", CHUNKS)
def test_decision_digest_equals_jax(runs, chunk):
    jres, _, _, tres, _ = runs[chunk]
    names = _all_goals(tres)
    assert tres.provenance.digest(goals=names) == jres.provenance.digest(goals=names)
    assert [(s.goal, s.index, s.num_moves, s.num_leadership, s.rounds) for s in
            tres.provenance.segments] == [
        (s.goal, s.index, s.num_moves, s.num_leadership, s.rounds) for s in
        jres.provenance.segments]


def test_chunk_budget_changes_no_decision(runs):
    a, b = runs[32][3], runs[3][3]
    assert np.array_equal(a.final_assignment, b.final_assignment)
    assert np.array_equal(a.touch_tag, b.touch_tag)
    assert np.array_equal(runs[32][4].state_fp, runs[3][4].state_fp)


def test_chunked_run_equals_fused_run(runs):
    chunked, fused = runs[32][3], runs["fused"]
    assert np.array_equal(chunked.final_assignment, fused.final_assignment)
    assert np.array_equal(chunked.touch_tag, fused.touch_tag)
    names = _all_goals(fused)
    assert chunked.provenance.digest(goals=names) == fused.provenance.digest(goals=names)
    assert [(g.name, g.violated_brokers_before, g.violated_brokers_after, g.rounds, g.converged)
            for g in chunked.goal_results] == [
        (g.name, g.violated_brokers_before, g.violated_brokers_after, g.rounds, g.converged)
        for g in fused.goal_results]


def test_hard_goal_subset_through_the_machine_equals_its_fused_run():
    machine, _ = _port_run(topt.SERVICE_EXACT_SETTINGS, HARD_GOAL_NAMES)
    fused, _ = _port_run(dataclasses.replace(topt.STACK_SETTINGS, ledger=True), HARD_GOAL_NAMES)
    assert [g.name for g in machine.goal_results] == list(HARD_GOAL_NAMES)
    assert np.array_equal(machine.final_assignment, fused.final_assignment)
    assert np.array_equal(machine.touch_tag, fused.touch_tag)
    assert machine.provenance.digest(goals=HARD_GOAL_NAMES) == fused.provenance.digest(
        goals=HARD_GOAL_NAMES)
    # the disabled phases are dropped and the kept ones renumbered
    assert [(s.goal, s.index) for s in machine.provenance.segments] == [
        (n, i) for i, n in enumerate(HARD_GOAL_NAMES)]
    assert machine.provenance.meta["goals"] == [g.name for g in topt.DEFAULT_GOAL_ORDER]


def test_machine_goal_plan_matches_jax():
    for names in (HARD_GOAL_NAMES, ["TopicReplicaDistributionGoal", "RackAwareGoal"],
                  [g.name for g in topt.DEFAULT_GOAL_ORDER]):
        req = tuple(g.name for g in topt.goals_by_priority(names))
        j, t = jopt._machine_goal_plan(req), topt._machine_goal_plan(req)
        assert j[0] == t[0]
        assert np.array_equal(j[1], t[1]) and np.array_equal(j[2], t[2])


def test_ledger_json_reads_back_through_the_jax_package(runs, tmp_path):
    """The port's ledger JSON reads back through both packages' RunLedger to
    the digest the JAX package reads back from its own run's JSON, and its
    decisions survive. The JSON rounds each cost to 1e-6, so a cost delta
    recomputed from it can differ by 1e-6 from the run's own: on fixture C
    CpuUsageDistributionGoal's does, in the JAX package's round trip too."""
    jres, _, _, tres, _ = runs[32]
    doc = json.loads(json.dumps(tres.provenance.to_dict()))
    back = JRunLedger.from_dict(doc)
    want = JRunLedger.from_dict(json.loads(json.dumps(jres.provenance.to_dict()))).digest()
    assert back.digest() == RunLedger.from_dict(doc).digest() == want
    names = _all_goals(tres)
    assert back.digest(goals=names) == tres.provenance.digest(goals=names)
    port_file, jax_file = tmp_path / "port.json", tmp_path / "jax.json"
    port_file.write_text(json.dumps(doc))
    jax_file.write_text(json.dumps(jres.provenance.to_dict()))
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / "diff_runs.py"), str(port_file),
                           str(jax_file)], capture_output=True, text=True, cwd=REPO,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_fused_run_keeps_its_ledger_off_by_default():
    res, _ = _port_run(topt.STACK_SETTINGS, HARD_GOAL_NAMES)
    assert res.provenance is None
    assert res.stats_before is not None and res.stats_after is not None


@pytest.mark.parametrize("field,value", [("bucket_partitions", True), ("bucket_brokers", True)])
def test_what_the_slice_leaves_out_is_refused(field, value):
    """Shape bucketing is ported (tests/test_torch_bucketing.py), as are the
    polish pass and the batch_k=1 grid (tests/test_torch_polish.py,
    tests/test_torch_grid.py) and the options (tests/test_torch_options.py):
    an option other than the defaults under bucketing is accepted, and the
    prepared context carries it (padded partitions excluded)."""
    from cruise_control_torch.analyzer.context import OptimizationOptions

    settings = dataclasses.replace(topt.SERVICE_EXACT_SETTINGS, **{field: value})
    topt.check_supported(topt.goals_by_priority(None), settings, OptimizationOptions())
    tmodel = from_numpy({k: np.asarray(v) for k, v in _model()._asdict().items()})
    p = tmodel.num_partitions
    options = OptimizationOptions(only_move_immigrants=True,
                                  excluded_partitions=np.arange(p) % 7 == 0)
    static = topt.GoalOptimizer(settings=settings, device="cpu")._prepare(
        tmodel, None, options)[4]
    assert bool(static.only_move_immigrants)
    movable = static.movable_partition.numpy()
    assert np.array_equal(movable[:p], np.arange(p) % 7 != 0) and not movable[p:].any()


@pytest.mark.slow
def test_chip_smoke_jax_references_are_current():
    """chip_smoke.py's JAX references, recomputed: the JAX package's CPU runs
    of the smoke recipe (2,600 brokers, 199,518 partitions; minutes and a few
    GB of memory), of BASELINE config 5 under the bench's batched settings and
    of the bench's config-5 parity model under its greedy and batched
    settings (bench.py:215-248), each at the exact shape and, for the service
    and the bench, bucketed, and the greedy one also on a mesh of 4 virtual
    devices (phase 23); then the JAX lane armed on the bucketed service
    solve and its two proposals (chip_smoke.lane_perturbations): each solve's
    decision digest, per-goal move counts, final assignment hash and goal
    rows, and the bucketed service solve's bucket record; then the option
    flows; then the JAX monitor's model of the smoke recipe's metrics
    (chip_smoke.monitored_model, each array's SHA-256) and its bucketed
    service solve; then phase 19: that solve stamped (chip_smoke.stamp) and
    executed by the JAX executor on the simulator that emitted the metrics
    (chip_smoke.execute_monitored), and a chaos run of the same proposals
    (chip_smoke.chaos_run), each held to its record
    (chip_smoke.execution_record); then phase 20: a broker of that simulator
    killed, detected, decommissioned through the JAX facade and executed over
    the TCP wire (chip_smoke.self_healing), held to its record
    (chip_smoke.self_healing_record), digest and goal rows; then phase 21: the
    JAX service on that cluster, served by aiohttp and driven by its client
    (chip_smoke.served), held to its record (chip_smoke.served_record), the
    three solves' digests and goal rows and K11 on the demote's
    assignments."""
    import hashlib

    sys.path.insert(0, str(REPO))
    import chip_smoke
    from cruise_control_tpu.analyzer import incremental as jinc
    from cruise_control_tpu.analyzer.goals import HARD_GOAL_NAMES as JHARD

    prop = dataclasses.replace(jgen.BASELINE_CONFIGS[5], num_dead_brokers=26,
                               load_distribution="pareto", mean_utilization=0.5)
    model = jgen.random_cluster(42, prop)
    bench_model = jgen.random_cluster(42, jgen.BASELINE_CONFIGS[5])
    parity_model = jgen.random_cluster(47, jgen.ClusterProperty(
        num_racks=52, num_brokers=520, num_topics=800, mean_partitions_per_topic=50.0,
        replication_factor=3, load_distribution="exponential"))
    grid = dict(num_dst_candidates=16, num_swap_pairs=16, swap_candidates=16, swaps_per_broker=4,
                bucket_partitions=False, bucket_brokers=False)
    bucketed = dict(bucket_partitions=True, bucket_brokers=True)
    bench = dict(grid, batch_k=1024, max_rounds_per_goal=128, chunk_rounds=16, polish_rounds=48)
    greedy = dict(grid, batch_k=1, max_rounds_per_goal=512, chunk_rounds=64,
                  cost_scaled_rounds=1.5, rounds_ceiling=4096)
    base = dict(JAX_SERVICE, chunk_rounds=0)
    stack_ref = chip_smoke.JAX_CPU_STACK_REFERENCE
    recipes = {"hard goals": (model, dict(base, bulk_waves=0), JHARD, stack_ref),
               "stack": (model, base, None, stack_ref),
               "service": (model, dict(base, chunk_rounds=32), None, stack_ref),
               "service hard goals": (model, dict(base, chunk_rounds=32), JHARD, stack_ref),
               "bench batched": (bench_model, bench, None, chip_smoke.JAX_CPU_BENCH_REFERENCE),
               "parity greedy": (parity_model, greedy, None,
                                 chip_smoke.JAX_CPU_PARITY_GREEDY_REFERENCE),
               "parity batched": (parity_model, bench, None,
                                  chip_smoke.JAX_CPU_PARITY_BATCHED_REFERENCE),
               # the service's and bench.py's defaults, shape bucketing on:
               # JAX decides otherwise than at the exact shape on both models
               "service bucketed": (model, dict(base, chunk_rounds=32, **bucketed), None,
                                    chip_smoke.JAX_CPU_SERVICE_BUCKETED_REFERENCE),
               "bench bucketed": (bench_model, dict(bench, **bucketed), None,
                                  chip_smoke.JAX_CPU_BENCH_BUCKETED_REFERENCE)}

    def check(label, res, ref):
        goals = [g.name for g in res.goal_results]
        dg = res.provenance.digest(goals=goals)
        sha = hashlib.sha256(np.ascontiguousarray(res.final_assignment, dtype=np.int32)
                             .tobytes()).hexdigest()
        assert (dg["checksum"], dg["byGoal"], sha) == chip_smoke.JAX_CPU_DIGESTS[label], label
        for g in res.goal_results:
            assert (g.violated_brokers_before, g.violated_brokers_after, g.rounds,
                    g.converged) == ref[g.name][:4], (label, g.name)

    for label, (m, settings, names, ref) in recipes.items():
        # `_run_chunked`'s call schedule follows the clock, and can move
        # decisions (ROADMAP.md Queue 3): every recipe runs chip_smoke's pinned
        # schedule
        opt = jopt.GoalOptimizer(settings=jopt.OptimizerSettings(
            **settings, chunk_target_s=chip_smoke.PINNED_TARGET_S))
        res = opt.optimizations(m, names, raise_on_hard_failure=False)
        check(label, res, ref)
        if label == "service bucketed":
            assert res.bucketed == chip_smoke.JAX_CPU_SERVICE_BUCKETED_BLOCK
            service_opt, goals = opt, [g.name for g in res.goal_results]
    # phase 23's reference: the greedy pass of the parity model on a mesh of
    # 4 of the conftest's virtual CPU devices (nothing padded) makes phase 9's
    # decisions
    from cruise_control_tpu.parallel.sharding import make_mesh as jmake_mesh

    res = jopt.GoalOptimizer(settings=jopt.OptimizerSettings(
        **greedy, chunk_target_s=chip_smoke.PINNED_TARGET_S), mesh=jmake_mesh(4)).optimizations(
        parity_model, None, raise_on_hard_failure=False)
    check("mesh parity greedy", res, chip_smoke.JAX_CPU_PARITY_GREEDY_REFERENCE)
    lane = jinc.IncrementalLane(service_opt)
    assert lane.arm(model, jopt.OptimizationOptions(), goals, generation=1)
    lane_a, lane_b = chip_smoke.lane_perturbations(
        {k: np.asarray(v) for k, v in model._asdict().items()})
    for label, fields, gen, ref in (("lane a", lane_a, 2, chip_smoke.JAX_CPU_LANE_A_REFERENCE),
                                    ("lane b", lane_b, 3, chip_smoke.JAX_CPU_LANE_B_REFERENCE)):
        out = lane.propose(model._replace(**fields), generation=gen)
        assert out.ok and list(out.affected) == goals, (label, out.fallback_reason)
        check(label, out.result, ref)
    # the option phases: each facade flow of chip_smoke.option_recipes under
    # the bucketed service settings, the options resolved against the
    # generator's topic names; the demote flow's K11 on its initial and final
    # assignments
    from cruise_control_tpu.analyzer.context import build_static_ctx, dims_of, resolve_options
    from cruise_control_tpu.analyzer.goals.preferred import elect_preferred_leaders
    from cruise_control_tpu.config.balancing import BalancingConstraint as JConstraint

    names = jgen.metadata_for(model).topic_names
    recipes = chip_smoke.option_recipes({k: np.asarray(v) for k, v in model._asdict().items()})
    for label, (fields, goal_names, okw, mult) in recipes.items():
        m = model._replace(**fields)
        constraint = dataclasses.replace(JConstraint.default(),
                                         goal_violation_distribution_threshold_multiplier=mult)
        opt = jopt.GoalOptimizer(constraint=constraint, settings=jopt.OptimizerSettings(
            **dict(base, chunk_rounds=32, **bucketed), chunk_target_s=chip_smoke.PINNED_TARGET_S))
        res = opt.optimizations(m, goal_names,
                                resolve_options(jopt.OptimizationOptions(**okw), m, names),
                                raise_on_hard_failure=False)
        check(label, res, chip_smoke.JAX_CPU_OPTION_REFERENCE[label])
        assert res.bucketed == chip_smoke.JAX_CPU_SERVICE_BUCKETED_BLOCK, label
        assert {"replica": res.num_replica_moves, "leadership": res.num_leadership_moves} == \
            chip_smoke.JAX_CPU_OPTION_MOVES[label], label
        if label == "demote":
            st = build_static_ctx(m, constraint, dims_of(m))
            for which, a in (("initial", m.assignment), ("final", res.final_assignment)):
                out = np.asarray(jax.jit(elect_preferred_leaders)(st, np.asarray(a)))
                assert hashlib.sha256(np.ascontiguousarray(out, dtype=np.int32).tobytes()) \
                    .hexdigest() == chip_smoke.JAX_CPU_K11_SHA256[which], which
    # phase 18: the JAX monitor on the smoke recipe (chip_smoke.monitored_model),
    # each array of its model, then the bucketed service solve of that model
    from types import SimpleNamespace

    from cruise_control_tpu.monitor.completeness import ModelCompletenessRequirements
    from cruise_control_tpu.monitor.load_monitor import LoadMonitor, LoadMonitorConfig
    from cruise_control_tpu.monitor.metadata import MetadataClient
    from cruise_control_tpu.monitor.sampler import TransportMetricSampler
    from cruise_control_tpu.reporter.transport import InMemoryTransport
    from cruise_control_tpu.testing.simulator import SimulatedCluster

    ns = SimpleNamespace(
        SimulatedCluster=SimulatedCluster, InMemoryTransport=InMemoryTransport,
        MetadataClient=MetadataClient, TransportMetricSampler=TransportMetricSampler,
        LoadMonitor=LoadMonitor, LoadMonitorConfig=LoadMonitorConfig,
        ModelCompletenessRequirements=ModelCompletenessRequirements)
    monitored, meta, _, _, sim, monitor = chip_smoke.monitored_model(model, ns)
    assert chip_smoke.model_sha256({k: np.asarray(v) for k, v in monitored._asdict().items()}) \
        == chip_smoke.JAX_CPU_MONITORED_MODEL_SHA256
    opt = jopt.GoalOptimizer(settings=jopt.OptimizerSettings(
        **dict(base, chunk_rounds=32, **bucketed), chunk_target_s=chip_smoke.PINNED_TARGET_S))
    res = opt.optimizations(monitored, None, raise_on_hard_failure=False)
    check("monitored", res, chip_smoke.JAX_CPU_MONITORED_REFERENCE)
    assert res.bucketed == chip_smoke.JAX_CPU_SERVICE_BUCKETED_BLOCK
    assert {"replica": res.num_replica_moves, "leadership": res.num_leadership_moves} == \
        chip_smoke.JAX_CPU_MONITORED_MOVES
    # phase 19: the stamped solve through the JAX executor on the simulator
    # that emitted the metrics, the model rebuilt after it, then the chaos run
    from cruise_control_tpu.config import CruiseControlConfig
    from cruise_control_tpu.executor import (
        Executor,
        ExecutorConfig,
        SimulatorClusterDriver,
        TopologyFingerprint,
    )
    from cruise_control_tpu.testing.chaos import ChaosHarness, ChaosPlan, Perturbation

    ns = SimpleNamespace(
        SimulatedCluster=SimulatedCluster, Executor=Executor, ExecutorConfig=ExecutorConfig,
        SimulatorClusterDriver=SimulatorClusterDriver, TopologyFingerprint=TopologyFingerprint,
        CruiseControlConfig=CruiseControlConfig, ChaosHarness=ChaosHarness, ChaosPlan=ChaosPlan,
        Perturbation=Perturbation)
    chip_smoke.stamp(res, monitor, meta, ns)
    summary, batches, paused, _ = chip_smoke.execute_monitored(res, sim, monitor, ns)
    after = np.asarray(sim.fetch_topology().assignment)
    assert chip_smoke.execution_record(summary, after, batches) == chip_smoke.JAX_CPU_EXECUTED
    assert all(paused) and not monitor.sampling_paused
    rebuilt, _ = monitor.cluster_model(ModelCompletenessRequirements(
        min_required_num_windows=1, min_monitored_partitions_percentage=0.5))
    assert np.array_equal(np.asarray(rebuilt.assignment), after)
    _, summary, harness, _ = chip_smoke.chaos_run(monitored, res, ns)
    assert harness.checker.violations == [] and harness.checker.check_final() == []
    assert chip_smoke.execution_record(
        summary, np.asarray(harness.sim.fetch_topology().assignment)) == chip_smoke.JAX_CPU_CHAOS
    # phase 20: the self-healing loop on the executed simulator and its monitor
    healed = chip_smoke.self_healing(sim, monitor, chip_smoke.package_classes(
        "cruise_control_tpu", chip_smoke.SELF_HEALING_CLASSES))
    assert chip_smoke.self_healing_record(healed, sim) == chip_smoke.JAX_CPU_SELF_HEALING
    check("broker failure", healed["result"], chip_smoke.JAX_CPU_SELF_HEALING_REFERENCE)
    # phase 21: the JAX service on that cluster, served by its aiohttp server
    # and driven by its client (scripts/executor_references.py --served)
    sys.path.insert(0, str(REPO / "scripts"))
    import executor_references

    served = executor_references.served_references(sim, monitor)
    assert served["served"] == chip_smoke.JAX_CPU_SERVED
    for label, row in served["served_solves"].items():
        assert tuple(row["digest"]) == chip_smoke.JAX_CPU_DIGESTS[label], label
        assert row["moves"] == chip_smoke.JAX_CPU_SERVED_MOVES[label], label
        assert {g: tuple(r[:4]) for g, r in row["reference"].items()} == {
            g: r[:4] for g, r in chip_smoke.JAX_CPU_SERVED_REFERENCE[label].items()}, label
    assert served["served_k11_sha256"] == chip_smoke.JAX_CPU_SERVED_K11_SHA256
