"""The slice as a whole: a proposal from sampled metrics.

A 12-broker simulated cluster (3 racks, pareto load, one dead broker)
publishes its brokers' metrics; the JAX package's load monitor builds its
model from two windows of them and the JAX optimizer solves it under the
service's bucketed settings, and the port's monitor and the port's
optimizer (on the CPU) do the same from the same metrics. The models must be
equal array for array, the proposals' decision digests and final
assignments equal, and the sensor names and span kinds each side used
during the run equal, less the JAX package's compile and device-telemetry
sensors and compile spans, which the port leaves out (they are tied to XLA
compilation), and its sensor history's (which comes with the executor). The
port also replays a sample store that the JAX monitor
wrote, and proposes the same from it. One JAX machine compile; no
assertion reads a clock.
"""

import importlib

import numpy as np
import pytest
import torch

JAX, PORT = "cruise_control_tpu", "cruise_control_torch"
#: the JAX side of the port's SERVICE_SETTINGS (bucketed), on the pinned
#: schedule chip_smoke's solves run
JAX_SERVICE = dict(batch_k=16, max_rounds_per_goal=64, drain_src=512, drain_per_broker=8,
                   drain_dst=64, apply_waves=8, bulk_waves=16, bulk_min_brokers=32,
                   num_swap_pairs=8, swap_candidates=8, swaps_per_broker=4, polish_rounds=0,
                   chunk_rounds=32, bucket_partitions=True, bucket_brokers=True,
                   ledger=True, num_dst_candidates=8, chunk_target_s=1e9)
#: what the port leaves out: the JAX optimizer's program-cache meters and
#: stack-compile timers, the device telemetry's sensors (XLA compilation and
#: its cost analysis) and its compile spans; the sensor history's points
#: and spans (common/history.py, which comes with the executor)
LEFT_OUT_PREFIXES = ("GoalOptimizer.program-cache-", "GoalOptimizer.stack-compile-timer",
                     "DeviceTelemetry.", "History.")
LEFT_OUT_KINDS = {"compile", "history"}
WINDOW_MS = 60_000
WINDOWS = 2


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


def _cluster(pkg):
    gen = _m(pkg, "models.generators")
    return gen.random_cluster(17, gen.ClusterProperty(
        num_racks=3, num_brokers=12, num_topics=30, mean_partitions_per_topic=8.0,
        replication_factor=3, num_dead_brokers=1, load_distribution="pareto",
        mean_utilization=0.5))


def _monitor(pkg, store_dir):
    """The cluster's metrics through the package's monitor, pumped as
    chip_smoke's phase 18 pumps them (LoadMonitorConfig()'s windows, the
    facade's default requirements); the model and its metadata."""
    sim = _m(pkg, "testing.simulator").SimulatedCluster(_cluster(pkg))
    transport = _m(pkg, "reporter.transport").InMemoryTransport()
    lm = _m(pkg, "monitor.load_monitor")
    clock = {"now": 0.0}
    monitor = lm.LoadMonitor(
        _m(pkg, "monitor.metadata").MetadataClient(sim.fetch_topology, ttl_s=0.0),
        _m(pkg, "monitor.sampler").TransportMetricSampler(transport),
        sample_store=_m(pkg, "monitor.sample_store").FileSampleStore(str(store_dir)),
        config=lm.LoadMonitorConfig(), clock=lambda: clock["now"])
    monitor.start_up()
    for r in range(WINDOWS):
        t_ms = r * WINDOW_MS + WINDOW_MS // 2
        transport.publish(sim.all_metrics(t_ms))
        clock["now"] = (t_ms + WINDOW_MS // 4) / 1000.0
        monitor.sample_once()
    return monitor.cluster_model(_m(pkg, "monitor.completeness").ModelCompletenessRequirements(
        min_required_num_windows=1, min_monitored_partitions_percentage=0.5))


def _solve(pkg, model):
    if pkg == JAX:
        o = _m(JAX, "analyzer.optimizer")
        return o.GoalOptimizer(settings=o.OptimizerSettings(**JAX_SERVICE)).optimizations(
            model, None, raise_on_hard_failure=False)
    import dataclasses

    o = _m(PORT, "analyzer.optimizer")
    settings = dataclasses.replace(o.SERVICE_SETTINGS, chunk_target_s=1e9)
    return o.GoalOptimizer(device="cpu", settings=settings).optimizations(
        model, None, raise_on_hard_failure=False)


def _run(pkg, store_dir, monkeypatch):
    """Monitor and solve, recording every sensor name the package's
    REGISTRY hands out and every span its TRACER records meanwhile."""
    reg = _m(pkg, "common.sensors").REGISTRY
    tracer = _m(pkg, "common.tracing").TRACER
    names = set()
    for kind in ("meter", "histogram", "timer", "gauge"):
        inner = getattr(reg, kind)

        def named(name, *args, _inner=inner, **kw):
            names.add(name)
            return _inner(name, *args, **kw)

        monkeypatch.setattr(reg, kind, named)
    before = tracer.spans_recorded
    model, meta = _monitor(pkg, store_dir)
    res = _solve(pkg, model)
    spans = tracer.recent(limit=tracer.spans_recorded - before)
    monkeypatch.undo()
    return dict(model=model, meta=meta, res=res, names=names,
                kinds={s["kind"] for s in spans}, span_names={s["name"] for s in spans})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        return {pkg: _run(pkg, tmp_path_factory.mktemp(pkg.split("_")[-1]), mp)
                for pkg in (JAX, PORT)}
    finally:
        mp.undo()


def _fields(model):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in model._asdict().items()}


def _assert_models_equal(a, b):
    fa, fb = _fields(a), _fields(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].tobytes() == fb[k].tobytes(), k


def test_monitored_models_equal(runs):
    _assert_models_equal(runs[JAX]["model"], runs[PORT]["model"])
    mj, mp = runs[JAX]["meta"], runs[PORT]["meta"]
    assert mj.topic_names == mp.topic_names
    for f in ("partition_index", "broker_ids", "topic_of_partition"):
        assert np.array_equal(getattr(mj, f), getattr(mp, f)), f
    # the dead broker reports nothing: the partitions it led carry no load
    led = _fields(runs[PORT]["model"])
    dead = np.nonzero(led["broker_state"] == 3)[0]
    assert (led["part_load"][np.isin(led["assignment"][:, 0], dead)] == 0).all()


def test_monitored_proposals_equal(runs):
    rj, rp = runs[JAX]["res"], runs[PORT]["res"]
    names = [g.name for g in rj.goal_results]
    assert [g.name for g in rp.goal_results] == names
    dj, dp = rj.provenance.digest(goals=names), rp.provenance.digest(goals=names)
    assert dj["checksum"] == dp["checksum"] and dj["byGoal"] == dp["byGoal"]
    assert np.array_equal(np.asarray(rj.final_assignment), rp.final_assignment)
    assert (rj.num_replica_moves, rj.num_leadership_moves) == \
        (rp.num_replica_moves, rp.num_leadership_moves)
    assert rj.bucketed == rp.bucketed
    for gj, gp in zip(rj.goal_results, rp.goal_results):
        assert (gj.violated_brokers_before, gj.violated_brokers_after, gj.rounds,
                gj.converged) == (gp.violated_brokers_before, gp.violated_brokers_after,
                                  gp.rounds, gp.converged), gj.name


def test_sensor_names_equal_less_the_left_out(runs):
    jax_names = {n for n in runs[JAX]["names"] if not n.startswith(LEFT_OUT_PREFIXES)}
    assert runs[PORT]["names"] == jax_names
    assert "LoadMonitor.cluster-model-creation-timer" in jax_names
    assert "MoveLedger.build-timer" in jax_names


def test_span_kinds_equal_less_compile(runs):
    assert runs[PORT]["kinds"] == runs[JAX]["kinds"] - LEFT_OUT_KINDS
    assert {"monitor", "proposal", "device-call", "goal", "provenance"} <= runs[PORT]["kinds"]
    assert runs[PORT]["span_names"] <= runs[JAX]["span_names"]


def test_port_replays_the_jax_monitors_store(runs, tmp_path_factory):
    """The JAX monitor's FileSampleStore, replayed by a fresh port monitor
    (no new metrics), gives the same model, and the port proposes from it
    what the JAX package proposed."""
    store_dir = next(p for p in tmp_path_factory.getbasetemp().iterdir()
                     if p.name.startswith("tpu"))
    sim = _m(PORT, "testing.simulator").SimulatedCluster(_cluster(PORT))
    lm = _m(PORT, "monitor.load_monitor")
    monitor = lm.LoadMonitor(
        _m(PORT, "monitor.metadata").MetadataClient(sim.fetch_topology, ttl_s=0.0),
        _m(PORT, "monitor.sampler").TransportMetricSampler(
            _m(PORT, "reporter.transport").InMemoryTransport()),
        sample_store=_m(PORT, "monitor.sample_store").FileSampleStore(str(store_dir)),
        config=lm.LoadMonitorConfig(), clock=lambda: 0.0)
    monitor.start_up()
    model, _ = monitor.cluster_model(_m(PORT, "monitor.completeness")
                                     .ModelCompletenessRequirements(1, 0.5))
    _assert_models_equal(runs[JAX]["model"], model)
    res = _solve(PORT, model)
    names = [g.name for g in res.goal_results]
    assert res.provenance.digest(goals=names)["checksum"] == \
        runs[JAX]["res"].provenance.digest(goals=names)["checksum"]
