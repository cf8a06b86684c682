"""The port's sensors and tracer (common/sensors.py, common/tracing.py)
against the JAX package's, on the same inputs: the unit cases of
tests/test_observability.py (histogram percentiles, the span tree, the
synthetic spans, the ring, the JSONL sink, concurrent spans), each run on
both packages, their outputs equal (span and trace ids, which are random,
and wall-clock durations aside). Host-only; no JAX program is compiled."""

import importlib
import json
import os
import threading

import pytest

PACKAGES = ("cruise_control_tpu", "cruise_control_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.common.{name}")


def _both(case):
    """case(pkg) on each package; the two results must be equal."""
    jax_out, port_out = (case(pkg) for pkg in PACKAGES)
    assert jax_out == port_out
    return port_out


def _stable(span: dict) -> dict:
    """A span's dict without its random ids and its measured duration."""
    return {k: v for k, v in span.items()
            if k not in ("traceId", "spanId", "parentId", "startUnixS", "durationS")}


# -- Histogram -----------------------------------------------------------------


def _hist_counts(pkg):
    h = _mod(pkg, "sensors").Histogram()
    for v in (0.001, 0.002, 0.004, 10.0):
        h.record(v)
    return h.snapshot()


def _hist_percentiles(pkg):
    h = _mod(pkg, "sensors").Histogram()
    for _ in range(90):
        h.record(0.001)
    for _ in range(10):
        h.record(1.0)
    return h.snapshot(), h.bucket_counts()


def _hist_overflow(pkg):
    h = _mod(pkg, "sensors").Histogram(bounds=(0.1, 1.0))
    for _ in range(10):
        h.record(50.0)
    return h.quantile(0.5), h.quantile(1.0), h.bucket_counts()


def _hist_empty_negative(pkg):
    h = _mod(pkg, "sensors").Histogram()
    empty = h.snapshot()
    h.record(-5.0)
    return empty, h.snapshot()


def _hist_context(pkg):
    h = _mod(pkg, "sensors").Histogram()
    with h:
        pass
    return h.count


def _registry(pkg):
    """A registry's snapshot and Prometheus text over one sensor of each type."""
    reg = _mod(pkg, "sensors").SensorRegistry()
    reg.meter("A.meter").mark(3)
    reg.histogram("A.hist").record(0.25)
    reg.gauge("A.gauge", lambda: 7)
    with reg.timer("A.timer"):
        pass
    snap = reg.snapshot()
    snap["A.timer"] = {k: v for k, v in snap["A.timer"].items() if not k.endswith("S")}
    text = [ln for ln in reg.prometheus_text().splitlines() if "timer" not in ln]
    return {k: snap[k] for k in sorted(snap) if k.startswith("A.")}, sorted(text)


@pytest.mark.parametrize("case", [_hist_counts, _hist_percentiles, _hist_overflow,
                                  _hist_empty_negative, _hist_context, _registry],
                         ids=lambda c: c.__name__.strip("_"))
def test_sensors_equal_the_jax_package(case):
    _both(case)


# -- Tracer --------------------------------------------------------------------


def _span_nesting(pkg):
    tr = _mod(pkg, "tracing").Tracer(ring_size=64)
    with tr.span("parent", kind="a") as p:
        cur = tr.current() is p
        with tr.span("child", kind="b") as c:
            lineage = (c.trace_id == p.trace_id, c.parent_id == p.span_id)
        tr.add_attributes(marked=True)
    spans = tr.recent()
    return cur, lineage, tr.current(), [_stable(s) for s in spans], \
        spans[0]["durationS"] is not None


def _span_error(pkg):
    tr = _mod(pkg, "tracing").Tracer(ring_size=8)
    with pytest.raises(ValueError):
        with tr.span("boom"):
            raise ValueError("no")
    return tr.recent()[0]["error"], tr.current()


def _synthetic(pkg):
    tr = _mod(pkg, "tracing").Tracer(ring_size=8)
    with tr.span("root") as root:
        tr.record_span("goal:X", kind="goal", duration_s=1.5, rounds=7)
    spans = {s["name"]: s for s in tr.recent()}
    g = spans["goal:X"]
    return (g["traceId"] == root.trace_id, g["parentId"] == root.span_id, g["durationS"],
            _stable(g))


def _threads(pkg):
    tr = _mod(pkg, "tracing").Tracer(ring_size=10_000)
    n_threads, per_thread = 8, 100
    errors = []

    def work(t):
        try:
            for i in range(per_thread):
                with tr.span(f"outer-{t}-{i}", kind="outer") as o:
                    with tr.span(f"inner-{t}-{i}", kind="inner") as inner:
                        assert inner.trace_id == o.trace_id
                        assert inner.parent_id == o.span_id
        except AssertionError as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    spans = tr.recent(limit=10_000)
    by_id = {s["spanId"]: s for s in spans}
    own_outer = all(by_id[s["parentId"]]["name"].split("-")[1] == s["name"].split("-")[1]
                    for s in spans if s["kind"] == "inner")
    return (errors, len(spans), len(by_id), own_outer, tr.spans_recorded,
            tr.overhead_s > 0.0, sorted(s["name"] for s in spans))


def _ring(pkg):
    tr = _mod(pkg, "tracing").Tracer(ring_size=16)
    for i in range(100):
        tr.record_span(f"s{i}", kind="k", duration_s=0.0)
    first = [s["name"] for s in tr.recent(limit=1000)]
    tr.configure(ring_size=32)
    return first, tr.ring_size, len(tr.recent(limit=1000)), list(tr.summarize())


def _jsonl(pkg, tmp):
    path = os.path.join(tmp, f"{pkg}.jsonl")
    tr = _mod(pkg, "tracing").Tracer(ring_size=8, jsonl_path=path)
    with tr.span("a", kind="x", n=1):
        pass
    tr.record_span("b", kind="y", duration_s=0.5)
    with open(path) as f:
        lines = [json.loads(ln) for ln in f.read().splitlines()]
    return [_stable(ln) for ln in lines], lines[1]["durationS"]


def _filters(pkg):
    tr = _mod(pkg, "tracing").Tracer(ring_size=32)
    with tr.span("p", kind="proposal") as p:
        tr.record_span("g1", kind="goal", duration_s=0.25)
        tr.record_span("g2", kind="goal", duration_s=0.75)
    tr.record_span("other", kind="goal", duration_s=1.0)
    by_kind = [s["name"] for s in tr.recent(kind="goal")]
    by_trace = [s["name"] for s in tr.recent(trace_id=p.trace_id)]
    summary = tr.summarize()["goal"]
    return by_kind, by_trace, summary


@pytest.mark.parametrize("case", [_span_nesting, _span_error, _synthetic, _threads, _ring,
                                  _filters], ids=lambda c: c.__name__.strip("_"))
def test_tracer_equals_the_jax_package(case):
    _both(case)


def test_tracer_jsonl_sink_equals_the_jax_package(tmp_path):
    _both(lambda pkg: _jsonl(pkg, str(tmp_path)))


def test_process_registry_and_tracer_names():
    """The process-wide REGISTRY and TRACER, and the gauges the tracer
    registers on import, under the JAX package's names."""
    def names(pkg):
        snap = _mod(pkg, "sensors").REGISTRY.snapshot()
        return sorted(k for k in snap if k.startswith("Tracer."))

    assert _both(names) == ["Tracer.overhead-seconds", "Tracer.ring-size",
                            "Tracer.spans-recorded"]


def test_maybe_profile_captures_one_operation_with_the_torch_profiler(tmp_path):
    """An armed profile dir captures ONE operation (a Chrome trace of the
    torch profiler holding the `cc:` range), then disarms; unarmed it is a
    no-op."""
    import torch

    from cruise_control_torch.common import tracing

    with tracing.maybe_profile() as on:
        assert on is False
    tracing.set_profile_dir(str(tmp_path))
    try:
        with tracing.maybe_profile() as on:
            with torch.profiler.record_function("cc:probe"):
                torch.ones(4).sum()
        with tracing.maybe_profile() as again:
            pass
    finally:
        tracing.set_profile_dir(None)
    assert on is True and again is False
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert any(e.get("name") == "cc:probe" for e in trace["traceEvents"])
