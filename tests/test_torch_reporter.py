"""The port's reporter (reporter/metrics.py, transport.py, reporter.py)
against the JAX package's on the same inputs: the cases of
tests/test_reporter.py run on both packages with equal results, the wire
bytes of every metric scope equal (each package reads the other's), and the
TCP transport's typed refusal until the executor is ported. Host-only."""

import importlib

import pytest

PACKAGES = ("cruise_control_tpu", "cruise_control_torch")


def _rep(pkg):
    return importlib.import_module(f"{pkg}.reporter")


def _metrics(pkg):
    r = _rep(pkg)
    return [
        r.BrokerMetric(r.RawMetricType.BROKER_CPU_UTIL, 123456, 7, 42.5),
        r.TopicMetric(r.RawMetricType.TOPIC_BYTES_IN, 1, 0, "topic-a", 1e6),
        r.PartitionMetric(r.RawMetricType.PARTITION_SIZE, 99, 3, "topic-b", 12, 2.5e9),
    ]


def _plain(m):
    """A metric as plain values (enum members by name and value)."""
    return (type(m).__name__, m.metric_type.name, int(m.metric_type), m.time_ms, m.broker_id,
            getattr(m, "topic", None), getattr(m, "partition", None), m.value)


def _both(case):
    jax_out, port_out = (case(pkg) for pkg in PACKAGES)
    assert jax_out == port_out
    return port_out


def _taxonomy(pkg):
    r = _rep(pkg)
    by_scope = {s.name: 0 for s in r.MetricScope}
    for t in r.RawMetricType:
        by_scope[t.scope.name] += 1
    return len(r.RawMetricType), by_scope, [(t.name, int(t), t.scope.name)
                                            for t in r.RawMetricType]


def _serde(pkg):
    r = _rep(pkg)
    out = []
    for m in _metrics(pkg):
        raw = r.serialize_metric(m)
        back = r.deserialize_metric(raw)
        out.append((raw, back == m, _plain(back)))
    return out


def _partition_needs_topic(pkg):
    r = _rep(pkg)
    with pytest.raises(ValueError) as e:
        r.BrokerMetric(r.RawMetricType.PARTITION_SIZE, 0, 0, 1.0)
    return str(e.value)


def _fifo(pkg):
    r = _rep(pkg)
    tr = r.InMemoryTransport()
    tr.publish([r.BrokerMetric(r.RawMetricType.BROKER_CPU_UTIL, i, 0, float(i))
                for i in range(10)])
    return ([m.time_ms for m in tr.poll(max_records=4)], len(tr.poll()), tr.poll())


def _jsonl(pkg, tmp):
    r = _rep(pkg)
    tr = r.JsonlFileTransport(str(tmp / f"{pkg}.jsonl"))
    b1 = [r.BrokerMetric(r.RawMetricType.BROKER_CPU_UTIL, 1, 0, 1.0)]
    b2 = [r.TopicMetric(r.RawMetricType.TOPIC_BYTES_IN, 2, 0, "t", 2.0)]
    tr.publish(b1)
    first = tr.poll()
    tr.publish(b2)
    second = tr.poll()
    third = tr.poll()
    with open(tmp / f"{pkg}.jsonl") as f:
        text = f.read()
    return ([_plain(m) for m in first], [_plain(m) for m in second], third,
            [_plain(m) for m in tr.replay_all()], first == b1 and second == b2, text)


def _reporter_round(pkg):
    r = _rep(pkg)
    tr = r.InMemoryTransport()

    def source(now_ms):
        return [r.BrokerMetric(r.RawMetricType.BROKER_CPU_UTIL, now_ms, 5, 0.3)]

    rep = r.MetricsReporter(5, source, tr, clock=lambda: 100.0)
    return rep.report_once(), [_plain(m) for m in tr.poll()]


@pytest.mark.parametrize("case", [_taxonomy, _serde, _partition_needs_topic, _fifo,
                                  _reporter_round], ids=lambda c: c.__name__.strip("_"))
def test_reporter_equals_the_jax_package(case):
    _both(case)


def test_jsonl_transport_equals_the_jax_package(tmp_path):
    _both(lambda pkg: _jsonl(pkg, tmp_path))


@pytest.mark.parametrize("writer,reader", [PACKAGES, PACKAGES[::-1]])
def test_each_package_reads_the_others_wire_bytes(writer, reader):
    """The serde is the wire format: a metric either package wrote reads back
    in the other as the same metric."""
    wr, rd = _rep(writer), _rep(reader)
    for m_w, m_r in zip(_metrics(writer), _metrics(reader)):
        assert rd.deserialize_metric(wr.serialize_metric(m_w)) == m_r


def test_tcp_transport_is_refused_until_the_executor_is_ported():
    from cruise_control_torch.reporter.transport import NotPortedError, TcpMetricsTransport

    with pytest.raises(NotPortedError, match="tcp_driver"):
        TcpMetricsTransport("localhost", 1)
