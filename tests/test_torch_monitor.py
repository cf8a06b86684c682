"""The port's load monitor (monitor/, models/model_utils.py,
testing/simulator.py) against the JAX package's, on the same seeded inputs.

Each case of tests/test_monitor.py, test_aggregator.py and
test_completeness.py runs on both packages, and the two results must be
exactly equal: models array for array and byte for byte, aggregator windows,
extrapolations and completeness, samples, sensors and errors. The monitor is
host numpy in both packages; the port's model is the port's
FlatClusterModel, built on the CPU. The JAX package's wall-clock assertions
are not copied. Host-only: no JAX program is compiled."""

import dataclasses
import enum
import importlib
import itertools
import json
import os
import threading

import numpy as np
import pytest
import torch

JAX, PORT = PACKAGES = ("cruise_control_tpu", "cruise_control_torch")


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _host(x):
    """A package-neutral, exactly comparable form of a result: arrays as
    (dtype, shape, bytes), floats by their bits, named tuples and dataclasses
    by field, enums by name and value."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    if isinstance(x, np.ndarray) or type(x).__module__.startswith("jax"):
        x = np.asarray(x)
        return ("array", str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return _host(np.asarray(x))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, x.value)
    if isinstance(x, float):
        return ("float", x.hex())
    if isinstance(x, tuple) and hasattr(x, "_asdict"):
        return (type(x).__name__, _host(x._asdict()))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: _host(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    return x


def _both(case, *args):
    """case(pkg, *args) on each package; the results must be exactly equal."""
    jax_out, port_out = (_host(case(pkg, *args)) for pkg in PACKAGES)
    assert jax_out == port_out
    return port_out


def _truth(pkg):
    gen = _m(pkg, "models.generators")
    return gen.random_cluster(3, gen.ClusterProperty(num_racks=3, num_brokers=6, num_topics=8,
                                                     replication_factor=2))


def _make_monitor(pkg, sim, transport, store=None, window_ms=1000, num_windows=3):
    lm = _m(pkg, "monitor.load_monitor")
    clock = {"now": 0.0}
    monitor = lm.LoadMonitor(
        metadata_client=_m(pkg, "monitor.metadata").MetadataClient(sim.fetch_topology,
                                                                    ttl_s=0.0),
        sampler=_m(pkg, "monitor.sampler").TransportMetricSampler(transport),
        sample_store=store,
        config=lm.LoadMonitorConfig(window_ms=window_ms, num_windows=num_windows,
                                    min_samples_per_window=1),
        clock=lambda: clock["now"],
    )
    return monitor, clock


def _pump(sim, transport, monitor, clock, rounds, window_ms=1000):
    for r in range(rounds):
        t_ms = r * window_ms + window_ms // 2
        transport.publish(sim.all_metrics(t_ms))
        clock["now"] = (t_ms + window_ms // 4) / 1000.0
        monitor.sample_once()


def _setup(pkg, store=None):
    sim = _m(pkg, "testing.simulator").SimulatedCluster(_truth(pkg))
    transport = _m(pkg, "reporter.transport").InMemoryTransport()
    monitor, clock = _make_monitor(pkg, sim, transport, store=store)
    return sim, transport, monitor, clock


def _req(pkg, *args):
    return _m(pkg, "monitor.completeness").ModelCompletenessRequirements(*args)


def _store(pkg, path, **kw):
    return _m(pkg, "monitor.sample_store").FileSampleStore(str(path), **kw)


# -- the monitor (tests/test_monitor.py) ---------------------------------------


def _reconstructs(pkg):
    sim, transport, monitor, clock = _setup(pkg)
    monitor.start_up()
    _pump(sim, transport, monitor, clock, rounds=4)
    meets = monitor.meet_completeness_requirements(_req(pkg, 3, 0.99))
    model, meta = monitor.cluster_model()
    _m(pkg, "models.flat_model").sanity_check(model)
    return meets, model, meta, sim.model(), monitor.generation, monitor.state


def _generation_and_pause(pkg):
    sim, transport, monitor, clock = _setup(pkg)
    monitor.start_up()
    _pump(sim, transport, monitor, clock, rounds=2)
    g = monitor.generation
    monitor.pause_metric_sampling("test")
    transport.publish(sim.all_metrics(10_000))
    paused = monitor.sample_once(), monitor.state
    monitor.resume_metric_sampling()
    _pump(sim, transport, monitor, clock, rounds=1)
    with monitor.acquire_for_model_generation():
        model, _ = monitor.cluster_model(_req(pkg, 1, 0.5, False))
    return g, paused, monitor.generation, model


def _store_replay(pkg, tmp):
    store = _store(pkg, tmp / pkg)
    sim, transport, monitor, clock = _setup(pkg, store=store)
    monitor.start_up()
    _pump(sim, transport, monitor, clock, rounds=3)
    model_a, _ = monitor.cluster_model(_req(pkg, 1, 0.5, False))
    transport2 = _m(pkg, "reporter.transport").InMemoryTransport()
    monitor2, _ = _make_monitor(pkg, sim, transport2, store=_store(pkg, tmp / pkg))
    monitor2.start_up()
    model_b, _ = monitor2.cluster_model(_req(pkg, 1, 0.5, False))
    return model_a, model_b, sorted(os.listdir(tmp / pkg))


def _sample_serde(pkg):
    s = _m(pkg, "monitor.samples")
    md = _m(pkg, "monitor.metricdef")
    p = s.PartitionMetricSample(17, 12345, np.arange(md.NUM_COMMON_METRICS, dtype=np.float32))
    b = s.BrokerMetricSample(3, 999, np.arange(md.NUM_BROKER_METRICS, dtype=np.float32))
    raw_p, raw_b = s.serialize_sample(p), s.serialize_sample(b)
    return raw_p, raw_b, s.deserialize_sample(raw_p), s.deserialize_sample(raw_b)


def _cpu_attribution(pkg):
    mu = _m(pkg, "models.model_utils")
    return [mu.estimate_leader_cpu_util(50.0, 1000.0, 2000.0, 500.0, 100.0, 200.0),
            mu.estimate_leader_cpu_util(50.0, 0.0, 100.0, 0.0, 10.0, 10.0),
            mu.estimate_leader_cpu_util(50.0, 100.0, 100.0, 0.0, 200.0, 10.0),
            mu.follower_cpu_util_from_leader_load(1000.0, 2000.0, 30.0),
            mu.follower_cpu_util_from_leader_load(0.0, 0.0, 30.0),
            mu.estimate_leader_cpu_util(np.float32(40.0), np.float32(900.0),
                                        np.float32(300.0), np.float32(100.0),
                                        np.arange(5, dtype=np.float32) * 100,
                                        np.arange(5, dtype=np.float32) * 30)]


def _linear_regression(pkg):
    params = _m(pkg, "models.model_utils").LinearRegressionModelParameters()
    rng = np.random.default_rng(0)
    true_coef = np.array([0.0007, 0.0002, 0.0001])
    for _ in range(200):
        rates = rng.uniform(0, 1000, size=3)
        params.add_observation(float(rates @ true_coef), *rates)
    return params.train(), params.estimate_leader_cpu_util(100.0, 50.0), params.num_observations


def _processor_skips(pkg):
    sim = _m(pkg, "testing.simulator").SimulatedCluster(_truth(pkg))
    topo = sim.fetch_topology()
    raw = _m(pkg, "reporter.metrics").RawMetricType
    bid0 = int(topo.broker_ids[0])
    metrics = [m for m in sim.all_metrics(1000)
               if not (m.broker_id == bid0 and m.metric_type == raw.BROKER_CPU_UTIL)]
    res = _m(pkg, "monitor.processor").MetricsProcessor().process(metrics, topo)
    return (res.skipped_partitions, res.skipped_brokers,
            [(s.partition_id, s.time_ms, s.metrics) for s in res.partition_samples],
            [(s.broker_id, s.time_ms, s.metrics) for s in res.broker_samples])


def _torn_tail(pkg, tmp):
    s = _m(pkg, "monitor.samples")
    md = _m(pkg, "monitor.metricdef")
    store = _store(pkg, tmp / pkg)
    store.store_samples([s.PartitionMetricSample(1, 100, np.ones(md.NUM_COMMON_METRICS,
                                                                 dtype=np.float32))], [])
    with open(str(tmp / pkg / "partition-samples.bin"), "ab") as f:
        f.write((50).to_bytes(4, "big") + b"\x02\x03")
    part, brok = _store(pkg, tmp / pkg).load_samples()
    return [(x.partition_id, x.time_ms, x.metrics) for x in part], brok


def _sampler_carries_ahead(pkg):
    sim = _m(pkg, "testing.simulator").SimulatedCluster(_truth(pkg))
    transport = _m(pkg, "reporter.transport").InMemoryTransport()
    sampler = _m(pkg, "monitor.sampler").TransportMetricSampler(transport)
    topo = sim.fetch_topology()
    transport.publish(sim.all_metrics(5000))
    got = sampler.get_samples(topo, 0, 1000)
    got2 = sampler.get_samples(topo, 1000, 10_000)
    return (len(got.partition_samples), [(x.partition_id, x.time_ms, x.metrics)
                                         for x in got2.partition_samples])


def _before_first_window(pkg):
    sim, transport, monitor, clock = _setup(pkg)
    monitor.start_up()
    transport.publish(sim.all_metrics(500))
    clock["now"] = 0.8
    monitor.sample_once()
    meets = monitor.meet_completeness_requirements(_req(pkg, 1, 0.5, False))
    with pytest.raises(ValueError) as e:
        monitor.cluster_model()
    return meets, type(e.value).__name__, str(e.value), e.value.completeness


def _assignor(pkg):
    sim = _m(pkg, "testing.simulator").SimulatedCluster(_truth(pkg))
    return _m(pkg, "monitor.fetcher").DefaultMetricSamplerPartitionAssignor().assign(
        sim.fetch_topology(), 3)


class _ShardSampler:
    """Records its shards and emits one zero sample a partition; optionally
    waits on an event that is never set (a slow fetcher) or raises."""

    def __init__(self, pkg, wait=None, fail=False):
        self.pkg, self.wait, self.fail, self.shards = pkg, wait, fail, []

    def get_samples(self, topology, start_ms, end_ms, partitions=None):
        self.shards.append(np.asarray(partitions))
        if self.wait is not None:
            self.wait.wait(timeout=2.0)
        if self.fail:
            raise RuntimeError("sampler down")
        s = _m(self.pkg, "monitor.samples")
        n = _m(self.pkg, "monitor.metricdef").NUM_COMMON_METRICS
        out = [s.PartitionMetricSample(int(p), start_ms, np.zeros(n, np.float32))
               for p in partitions]
        return _m(self.pkg, "monitor.sampler").Samples(out, [])

    def close(self):
        pass


def _counts(sensors):
    """A sensor table without its measured times."""
    return {k: v for k, v in json.loads(json.dumps(sensors)).items() if "time" not in k}


def _fetcher_rounds(pkg):
    sim = _m(pkg, "testing.simulator").SimulatedCluster(_truth(pkg))
    topo = sim.fetch_topology()
    samplers = [_ShardSampler(pkg) for _ in range(3)]
    mgr = _m(pkg, "monitor.fetcher").MetricFetcherManager(samplers, round_timeout_s=5.0)
    out = mgr.get_samples(topo, 0, 1000)
    mgr.get_samples(topo, 1000, 2000)
    sensors = _counts(mgr.sensors)
    mgr.close()
    return (sorted(x.partition_id for x in out.partition_samples),
            [s.shards for s in samplers], sensors)


def _fetcher_slow_and_failing(pkg):
    sim = _m(pkg, "testing.simulator").SimulatedCluster(_truth(pkg))
    topo = sim.fetch_topology()
    hold = threading.Event()
    samplers = [_ShardSampler(pkg), _ShardSampler(pkg, wait=hold), _ShardSampler(pkg, fail=True)]
    mgr = _m(pkg, "monitor.fetcher").MetricFetcherManager(samplers, round_timeout_s=0.4)
    out = mgr.get_samples(topo, 0, 1000)
    out2 = mgr.get_samples(topo, 1000, 2000)
    sensors = _counts(mgr.sensors)
    hold.set()
    mgr.close()
    return (sorted(x.partition_id for x in out.partition_samples),
            sorted(x.partition_id for x in out2.partition_samples),
            [len(s.shards) for s in samplers], sensors)


def _monitor_with_fetcher(pkg):
    sim = _m(pkg, "testing.simulator").SimulatedCluster(_truth(pkg))
    transport = _m(pkg, "reporter.transport").InMemoryTransport()
    lm = _m(pkg, "monitor.load_monitor")
    clock = {"now": 0.0}
    mgr = _m(pkg, "monitor.fetcher").MetricFetcherManager(
        [_m(pkg, "monitor.sampler").TransportMetricSampler(transport) for _ in range(2)],
        round_timeout_s=5.0)
    monitor = lm.LoadMonitor(
        metadata_client=_m(pkg, "monitor.metadata").MetadataClient(sim.fetch_topology,
                                                                    ttl_s=0.0),
        sampler=mgr,
        config=lm.LoadMonitorConfig(window_ms=1000, num_windows=3, min_samples_per_window=1),
        clock=lambda: clock["now"])
    _pump(sim, transport, monitor, clock, rounds=4)
    model, meta = monitor.cluster_model(_req(pkg, 1))
    mgr.close()
    return model, meta


def _capacity_resolver(pkg, tmp):
    doc = {"brokerCapacities": [
        {"brokerId": "-1", "capacity": {
            "DISK": {"/tmp/kafka-logs-1": "50000", "/tmp/kafka-logs-2": "50000"},
            "CPU": "100", "NW_IN": "10000", "NW_OUT": "10000"}},
        {"brokerId": "0", "capacity": {
            "DISK": {"/tmp/kafka-logs-1": "250000", "/tmp/kafka-logs-2": "250000"},
            "CPU": "100", "NW_IN": "50000", "NW_OUT": "50000"}},
        {"brokerId": "1", "capacity": {"DISK": "750000", "CPU": "150", "NW_IN": "50000",
                                       "NW_OUT": "50000"}},
    ]}
    path = tmp / f"{pkg}.capacity.JBOD.json"
    path.write_text(json.dumps(doc))
    r = _m(pkg, "monitor.metadata").BrokerCapacityConfigFileResolver(str(path))
    return [(r.capacity_for_broker(b), r.logdirs_for_broker(b)) for b in (0, 1, 7)]


def _store_retention(pkg, tmp):
    s = _m(pkg, "monitor.samples")
    md = _m(pkg, "monitor.metricdef")
    d = tmp / pkg
    store = _store(pkg, d, retention_ms=10_000, segment_ms=1_000)
    metrics = np.ones(md.NUM_COMMON_METRICS, dtype=np.float32)
    bmetrics = np.ones(md.NUM_BROKER_METRICS, dtype=np.float32)
    sizes = []
    for t in range(0, 50_000, 500):
        store.store_samples([s.PartitionMetricSample(1, t, metrics)],
                            [s.BrokerMetricSample(0, t, bmetrics)])
        files = sorted(f for f in os.listdir(d) if f.endswith(".bin"))
        sizes.append((files, sum(os.path.getsize(d / f) for f in files)))
    part, brok = store.load_samples()
    part2, _ = _store(pkg, d, retention_ms=10_000, segment_ms=1_000).load_samples()
    return sizes, [x.time_ms for x in part], [x.time_ms for x in brok], \
        [x.time_ms for x in part2]


def _segment_width_shrink(pkg, tmp):
    s = _m(pkg, "monitor.samples")
    md = _m(pkg, "monitor.metricdef")
    d = tmp / pkg
    wide = _store(pkg, d, retention_ms=60_000, segment_ms=10_000)
    for t in (1_000, 9_000):
        wide.store_samples([s.PartitionMetricSample(1, t, np.ones(md.NUM_COMMON_METRICS,
                                                                  np.float32))],
                           [s.BrokerMetricSample(0, t, np.ones(md.NUM_BROKER_METRICS,
                                                               np.float32))])
    part, _ = _store(pkg, d, retention_ms=5_000, segment_ms=1_000).load_samples()
    return sorted(x.time_ms for x in part), sorted(os.listdir(d))


def _bootstrap_and_train(pkg, tmp):
    store = _store(pkg, tmp / pkg / "samples.bin")
    sim, transport, monitor, clock = _setup(pkg, store=store)
    _pump(sim, transport, monitor, clock, rounds=3)
    monitor2, _ = _make_monitor(pkg, sim, transport, store=store)
    n = monitor2.bootstrap_range(start_ms=1000, end_ms=2000)
    trained = monitor.train_range(0)
    return n, monitor2.state, monitor.state, trained, monitor.lr_params.num_observations, \
        monitor.cluster_model(_req(pkg, 1, 0.0, False))[0]


def _exclusive_modes(pkg, tmp):
    lm = _m(pkg, "monitor.load_monitor")
    samples_t = _m(pkg, "monitor.sampler").Samples
    store = _store(pkg, tmp / pkg)
    sim, transport, monitor, clock = _setup(pkg, store=store)
    _pump(sim, transport, monitor, clock, rounds=2)
    entered, release = threading.Event(), threading.Event()

    class SlowSamples(list):
        def __iter__(self):
            entered.set()
            release.wait(timeout=10)
            return super().__iter__()

    part, brok = store.load_samples()
    result = {}
    t = threading.Thread(target=lambda: result.update(
        n=monitor.bootstrap(samples_t(SlowSamples(part), brok))))
    t.start()
    assert entered.wait(timeout=10)
    during = monitor.state, dict(monitor.active_task)
    rejected = []
    for call in (lambda: monitor.train_range(0), lambda: monitor.bootstrap(samples_t([], []))):
        with pytest.raises(lm.IllegalMonitorStateError) as e:
            call()
        rejected.append(str(e.value))
    release.set()
    t.join(timeout=10)
    assert not t.is_alive()
    return during, rejected, result["n"], monitor.state, monitor.active_task, \
        monitor.train_range(0)


def _task_runner(pkg, tmp):
    store = _store(pkg, tmp / pkg / "samples.bin")
    sim, transport, monitor, clock = _setup(pkg, store=store)
    runner = _m(pkg, "monitor.task_runner").LoadMonitorTaskRunner(monitor,
                                                                  sampling_interval_s=3600)
    states = [runner.state]
    runner.start()
    states.append(runner.state)
    _pump(sim, transport, monitor, clock, rounds=2)
    runner.bootstrap_range(0)
    runner.train(0)
    sensors = _counts(runner.sensors)
    runner.pause_sampling("test")
    states.append(runner.state)
    runner.resume_sampling()
    states.append(runner.state)
    runner.shutdown()
    return states, sensors


MONITOR_CASES = [_reconstructs, _generation_and_pause, _sample_serde, _cpu_attribution,
                 _linear_regression, _processor_skips, _sampler_carries_ahead,
                 _before_first_window, _assignor, _fetcher_rounds, _fetcher_slow_and_failing,
                 _monitor_with_fetcher]
MONITOR_CASES_ON_DISK = [_store_replay, _torn_tail, _capacity_resolver, _store_retention,
                         _segment_width_shrink, _bootstrap_and_train, _exclusive_modes,
                         _task_runner]


@pytest.mark.parametrize("case", MONITOR_CASES, ids=lambda c: c.__name__.strip("_"))
def test_monitor_equals_the_jax_package(case):
    _both(case)


@pytest.mark.parametrize("case", MONITOR_CASES_ON_DISK, ids=lambda c: c.__name__.strip("_"))
def test_monitor_on_disk_equals_the_jax_package(case, tmp_path):
    _both(case, tmp_path)


def test_port_replays_a_store_the_jax_monitor_wrote(tmp_path):
    """The sample store is the monitor's state: a FileSampleStore the JAX
    monitor wrote, replayed by the port's monitor, gives the same aggregator
    windows and the same model (the format is byte for byte the same)."""
    def write(pkg):
        sim, transport, monitor, clock = _setup(pkg, store=_store(pkg, tmp_path / pkg))
        monitor.start_up()
        _pump(sim, transport, monitor, clock, rounds=3)
        return monitor.cluster_model(_req(pkg, 1, 0.5, False))[0]

    model_jax = write(JAX)
    write(PORT)
    for name in sorted(os.listdir(tmp_path / JAX)):
        assert (tmp_path / JAX / name).read_bytes() == (tmp_path / PORT / name).read_bytes()
    sim = _m(PORT, "testing.simulator").SimulatedCluster(_truth(PORT))
    monitor, _ = _make_monitor(PORT, sim, _m(PORT, "reporter.transport").InMemoryTransport(),
                               store=_store(PORT, tmp_path / JAX))
    monitor.start_up()
    replayed = monitor.cluster_model(_req(PORT, 1, 0.5, False))[0]
    assert _host(replayed) == _host(model_jax)


# -- the aggregator (tests/test_aggregator.py) ----------------------------------


def _agg(pkg, num_entities=2, num_windows=4, min_samples=2, group=None, metrics=3):
    a = _m(pkg, "monitor.aggregator")
    fn = _m(pkg, "monitor.metricdef").AggregationFunction
    fns = [fn.AVG, fn.MAX, fn.LATEST][:metrics]
    return a.WindowedAggregator(num_entities=num_entities, num_metrics=metrics,
                                aggregation_functions=fns, window_ms=1000,
                                num_windows=num_windows, min_samples_per_window=min_samples,
                                entity_group=group)


def _add(agg, entity, t_ms, vals):
    return agg.add_samples(np.array([entity]), np.array([t_ms]), np.array([vals], np.float32))


def _result(res):
    return res.values, res.extrapolations, res.valid_entities, res.windows, res.completeness


def _strategies(pkg):
    agg = _agg(pkg)
    _add(agg, 0, 100, [1.0, 5.0, 10.0])
    _add(agg, 0, 200, [3.0, 2.0, 20.0])
    return _result(agg.aggregate(windows=[0]))


def _latest_order(pkg):
    agg = _agg(pkg)
    agg.add_samples(np.array([0, 0]), np.array([900, 300]),
                    np.array([[1, 1, 99.0], [1, 1, 11.0]], np.float32))
    return _result(agg.aggregate(windows=[0]))


def _ladder(pkg):
    agg = _agg(pkg, num_entities=4, num_windows=3, min_samples=4)
    for t in (1100, 1200, 1300, 1400):
        _add(agg, 0, t, [1, 1, 1])
    _add(agg, 1, 1100, [2, 2, 2])
    _add(agg, 1, 1200, [4, 4, 4])
    for t in (100, 200, 300, 400):
        _add(agg, 2, t, [8, 8, 8])
    for t in (2100, 2200, 2300, 2400):
        _add(agg, 2, t, [16, 16, 16])
    _add(agg, 3, 1100, [7, 7, 7])
    return _result(agg.aggregate(windows=[0, 1, 2]))


def _window_roll(pkg):
    agg = _agg(pkg, num_windows=3)
    _add(agg, 0, 500, [1, 1, 1])
    first = agg.current_window()
    _add(agg, 0, 5500, [2, 2, 2])
    with pytest.raises(ValueError) as e:
        agg.aggregate(windows=[0])
    return first, agg.current_window(), str(e.value), _result(agg.aggregate())


def _generations(pkg):
    agg = _agg(pkg)
    gens = [agg.generation]
    for t in (100, 5000, 4100):
        _add(agg, 0, t, [1, 1, 1])
        gens.append(agg.generation)
    return gens


def _completeness(pkg):
    a = _m(pkg, "monitor.aggregator")
    agg = _agg(pkg, num_entities=3, num_windows=2, min_samples=1,
               group=np.array([0, 0, 1], dtype=np.int64), metrics=1)
    for e in (0, 2):
        for t in (100, 1100, 2100):
            _add(agg, e, t, [1.0])
    return (_result(agg.aggregate(windows=[0, 1])),
            _result(agg.aggregate(windows=[0, 1], options=a.AggregationOptions(
                granularity=a.Granularity.ENTITY_GROUP))),
            agg.meets(a.AggregationOptions(min_valid_entity_ratio=0.5, min_valid_windows=2)),
            agg.meets(a.AggregationOptions(min_valid_entity_ratio=0.9)))


def _resize(pkg):
    agg = _agg(pkg, num_entities=1)
    _add(agg, 0, 100, [5, 5, 5])
    agg.resize(3)
    _add(agg, 2, 200, [7, 7, 7])
    return _result(agg.aggregate(windows=[0]))


def _random_stream(pkg):
    """A seeded stream of 2,000 samples over 50 entities and 8 windows, in
    batches out of time order: every strategy and extrapolation at once."""
    rng = np.random.default_rng(11)
    agg = _agg(pkg, num_entities=50, num_windows=6, min_samples=3,
               group=np.arange(50, dtype=np.int64) // 7)
    for _ in range(20):
        ids = rng.integers(0, 50, 100)
        times = rng.integers(0, 8_000, 100)
        agg.add_samples(ids, times, rng.random((100, 3), dtype=np.float32) * 100)
    return _result(agg.aggregate()), agg.generation


@pytest.mark.parametrize("case", [_strategies, _latest_order, _ladder, _window_roll,
                                  _generations, _completeness, _resize, _random_stream],
                         ids=lambda c: c.__name__.strip("_"))
def test_aggregator_equals_the_jax_package(case):
    _both(case)


# -- completeness (tests/test_completeness.py) ----------------------------------

SAMPLES = [(1, 0.5, False), (3, 0.995, True), (8, 0.2, False), (1, 1.0, True), (5, 0.5, True)]


def _combinators(pkg):
    reqs = [_req(pkg, *s) for s in SAMPLES]
    out = []
    for a, b in itertools.combinations(reqs, 2):
        out.append((a.weaker(b), a.stronger(b), b.weaker(a), b.stronger(a)))
    for a, b, c in itertools.combinations(reqs, 3):
        out.append((a.weaker(b).weaker(c), a.stronger(b).stronger(c)))
    return out


def _typed_errors(pkg):
    c = _m(pkg, "monitor.completeness")
    e = c.NotEnoughValidWindowsError("nope", {"validWindows": 1, "requiredWindows": 5})
    return (isinstance(e, ValueError), isinstance(e, c.ModelCompletenessError), e.completeness,
            str(e), issubclass(c.NotEnoughValidPartitionsError, c.ModelCompletenessError))


def _monitor_typed_errors(pkg):
    gen = _m(pkg, "models.generators")
    sim = _m(pkg, "testing.simulator").SimulatedCluster(gen.random_cluster(
        3, gen.ClusterProperty(num_racks=2, num_brokers=4, num_topics=3, replication_factor=2)))
    transport = _m(pkg, "reporter.transport").InMemoryTransport()
    monitor, clock = _make_monitor(pkg, sim, transport)
    monitor.start_up()
    c = _m(pkg, "monitor.completeness")
    out = []
    with pytest.raises(c.NotEnoughValidWindowsError) as ei:
        monitor.cluster_model(_req(pkg, 1, 0.0, False))
    out.append(ei.value.completeness)
    for r in range(3):
        transport.publish(sim.all_metrics(r * 1000 + 500))
        clock["now"] = r + 0.8
        monitor.sample_once()
    for req, err in (((99, 0.0, False), c.NotEnoughValidWindowsError),
                     ((1, 1.1, False), c.NotEnoughValidPartitionsError)):
        with pytest.raises(err) as ei:
            monitor.cluster_model(_req(pkg, *req))
        out.append((str(ei.value), ei.value.completeness))
    out.append(monitor.cluster_model(_req(pkg, 1, 0.5, False)))
    return out


@pytest.mark.parametrize("case", [_combinators, _typed_errors, _monitor_typed_errors],
                         ids=lambda c: c.__name__.strip("_"))
def test_completeness_equals_the_jax_package(case):
    _both(case)
