"""Process-wide sensor registry: named timers, meters, histograms, gauges.

The analog of the reference's Dropwizard MetricRegistry + JmxReporter under
the `kafka.cruisecontrol` domain (cc/KafkaCruiseControlMain.java:67-69) and
the sensor table in docs/wiki "User Guide/Sensors.md": well-known names like
`GoalOptimizer.proposal-computation-timer` (cc/analyzer/GoalOptimizer.java
:123) and `LoadMonitor.cluster-model-creation-timer` (cc/monitor/LoadMonitor
.java:157). Instead of JMX, the registry snapshot is served through `/state`
and rendered in Prometheus text exposition format through `/metrics`
(`prometheus_text`); docs/OBSERVABILITY.md carries the sensor name table.

Hot timers are `Histogram`s (fixed exponential buckets, p50/p95/p99 in
snapshots — the Dropwizard Timer's reservoir percentiles, but mergeable and
constant-memory); `Timer` remains for low-rate counters where percentiles
add nothing.
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Callable, Dict, List, Sequence, Tuple


class Timer:
    """Count + total/max/last seconds; use as a context manager."""

    def __init__(self) -> None:
        self.count = 0  #: guarded_by(_lock)
        self.total_s = 0.0  #: guarded_by(_lock)
        self.max_s = 0.0  #: guarded_by(_lock)
        self.last_s = 0.0  #: guarded_by(_lock)
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self.count += 1
            self.total_s += seconds
            self.max_s = max(self.max_s, seconds)
            self.last_s = seconds

    def __enter__(self) -> "Timer":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.record(time.monotonic() - self._t0)

    def snapshot(self) -> Dict:
        with self._lock:
            mean = self.total_s / self.count if self.count else 0.0
            return {
                "count": self.count,
                "totalS": round(self.total_s, 6),
                "meanS": round(mean, 6),
                "maxS": round(self.max_s, 6),
                "lastS": round(self.last_s, 6),
            }


class Meter:
    """Monotonic event counter."""

    def __init__(self) -> None:
        self.count = 0  #: guarded_by(_lock)
        self._lock = threading.Lock()

    def mark(self, n: int = 1) -> None:
        with self._lock:
            self.count += n

    def snapshot(self) -> Dict:
        with self._lock:
            return {"count": self.count}


#: default latency buckets: 100us .. ~105s, geometric x2 (21 finite bounds
#: + overflow). Wide enough for both a 0.2ms device dispatch and a
#: north-star-scale stack compile; fixed bounds keep snapshots mergeable
#: across processes (the Prometheus histogram contract).
DEFAULT_BUCKETS: Tuple[float, ...] = tuple(1e-4 * (2.0 ** i) for i in range(21))


class Histogram:
    """Fixed-bucket latency histogram with interpolated percentiles.

    Constant memory, lock-guarded, mergeable by bucket (unlike a reservoir):
    `snapshot()` reports p50/p95/p99 interpolated within the owning bucket
    (the overflow bucket interpolates toward the observed max), and
    `bucket_counts()` returns the cumulative counts `/metrics` renders as a
    Prometheus histogram."""

    def __init__(self, bounds: Sequence[float] = DEFAULT_BUCKETS) -> None:
        self.bounds: Tuple[float, ...] = tuple(sorted(float(b) for b in bounds))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.bounds) + 1)  #: guarded_by(_lock) — last = overflow (+inf)
        self.count = 0  #: guarded_by(_lock)
        self.total_s = 0.0  #: guarded_by(_lock)
        self.max_s = 0.0  #: guarded_by(_lock)
        self.last_s = 0.0  #: guarded_by(_lock)
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        s = max(0.0, float(seconds))
        i = bisect.bisect_left(self.bounds, s)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.total_s += s
            self.max_s = max(self.max_s, s)
            self.last_s = s

    def __enter__(self) -> "Histogram":
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc) -> None:
        self.record(time.monotonic() - self._t0)

    def _quantile_locked(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        # rank of the q-th observation (1-based), then linear interpolation
        # inside the owning bucket (uniform-within-bucket assumption)
        rank = max(1.0, q * self.count)
        cum = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.max_s
                hi = max(hi, lo)
                frac = (rank - cum) / c
                # clamp: interpolation cannot exceed the observed maximum
                return min(lo + (hi - lo) * frac, self.max_s)
            cum += c
        return self.max_s

    def quantile(self, q: float) -> float:
        with self._lock:
            return self._quantile_locked(q)

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """[(upper_bound, cumulative_count)] with a final (+inf, count)."""
        with self._lock:
            out = []
            cum = 0
            for b, c in zip(self.bounds, self._counts):
                cum += c
                out.append((b, cum))
            out.append((float("inf"), self.count))
            return out

    def snapshot(self) -> Dict:
        with self._lock:
            mean = self.total_s / self.count if self.count else 0.0
            return {
                "count": self.count,
                "totalS": round(self.total_s, 6),
                "meanS": round(mean, 6),
                "maxS": round(self.max_s, 6),
                "lastS": round(self.last_s, 6),
                "p50S": round(self._quantile_locked(0.50), 6),
                "p95S": round(self._quantile_locked(0.95), 6),
                "p99S": round(self._quantile_locked(0.99), 6),
            }


class SensorRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._timers: Dict[str, Timer] = {}  #: guarded_by(_lock)
        self._meters: Dict[str, Meter] = {}  #: guarded_by(_lock)
        self._hists: Dict[str, Histogram] = {}  #: guarded_by(_lock)
        self._gauges: Dict[str, Callable[[], object]] = {}  #: guarded_by(_lock)

    def timer(self, name: str) -> Timer:
        with self._lock:
            return self._timers.setdefault(name, Timer())

    def meter(self, name: str) -> Meter:
        with self._lock:
            return self._meters.setdefault(name, Meter())

    def histogram(self, name: str, bounds: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        with self._lock:
            return self._hists.setdefault(name, Histogram(bounds))

    def gauge(self, name: str, fn: Callable[[], object]) -> None:
        with self._lock:
            self._gauges[name] = fn

    def _collect(self):
        with self._lock:
            return (
                dict(self._timers),
                dict(self._meters),
                dict(self._hists),
                dict(self._gauges),
            )

    def snapshot(self) -> Dict:
        timers, meters, hists, gauges = self._collect()
        out: Dict[str, object] = {}
        for name, t in timers.items():
            out[name] = t.snapshot()
        for name, m in meters.items():
            out[name] = m.snapshot()
        for name, h in hists.items():
            out[name] = h.snapshot()
        for name, fn in gauges.items():
            # per-gauge isolation: one raising gauge callable must not poison
            # the whole /state sensors block — report the failure in place
            try:
                out[name] = fn()
            except Exception as e:
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    # -- Prometheus text exposition (/metrics) ---------------------------------

    def prometheus_text(self) -> str:
        """Render the registry in Prometheus text exposition format 0.0.4.

        Sensor names carry dots and dashes, so each sensor becomes a label
        (`sensor="GoalOptimizer.proposal-computation-timer"`) on a small set
        of metric families rather than a mangled metric name:

          cruise_control_timer_seconds{_count,_sum,_max}   Timer
          cruise_control_meter_total                        Meter (counter)
          cruise_control_latency_seconds{_bucket,_sum,_count}  Histogram
          cruise_control_latency_quantile_seconds{quantile=} Histogram p50/95/99
          cruise_control_gauge                              numeric gauges
                                                            (dict gauges flatten
                                                            into a `field` label)
        """
        timers, meters, hists, gauges = self._collect()
        lines: List[str] = []

        def label(**kv) -> str:
            parts = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in kv.items())
            return "{" + parts + "}"

        lines.append("# HELP cruise_control_timer_seconds Named timers (count/sum/max seconds).")
        lines.append("# TYPE cruise_control_timer_seconds summary")
        for name in sorted(timers):
            s = timers[name].snapshot()
            lines.append(f"cruise_control_timer_seconds_count{label(sensor=name)} {s['count']}")
            lines.append(f"cruise_control_timer_seconds_sum{label(sensor=name)} {s['totalS']}")
            lines.append(f"cruise_control_timer_seconds_max{label(sensor=name)} {s['maxS']}")

        lines.append("# HELP cruise_control_meter_total Named monotonic event counters.")
        lines.append("# TYPE cruise_control_meter_total counter")
        for name in sorted(meters):
            lines.append(f"cruise_control_meter_total{label(sensor=name)} {meters[name].snapshot()['count']}")

        lines.append("# HELP cruise_control_latency_seconds Fixed-bucket latency histograms.")
        lines.append("# TYPE cruise_control_latency_seconds histogram")
        quantile_lines: List[str] = []
        for name in sorted(hists):
            h = hists[name]
            for bound, cum in h.bucket_counts():
                le = "+Inf" if bound == float("inf") else repr(bound)
                lines.append(
                    f"cruise_control_latency_seconds_bucket{label(sensor=name, le=le)} {cum}"
                )
            s = h.snapshot()
            lines.append(f"cruise_control_latency_seconds_sum{label(sensor=name)} {s['totalS']}")
            lines.append(f"cruise_control_latency_seconds_count{label(sensor=name)} {s['count']}")
            for q, key in (("0.5", "p50S"), ("0.95", "p95S"), ("0.99", "p99S")):
                quantile_lines.append(
                    f"cruise_control_latency_quantile_seconds{label(sensor=name, quantile=q)} {s[key]}"
                )
        lines.append(
            "# HELP cruise_control_latency_quantile_seconds "
            "Interpolated histogram percentiles (p50/p95/p99)."
        )
        lines.append("# TYPE cruise_control_latency_quantile_seconds gauge")
        lines.extend(quantile_lines)

        lines.append("# HELP cruise_control_gauge Named gauges (numeric values only).")
        lines.append("# TYPE cruise_control_gauge gauge")
        for name in sorted(gauges):
            try:
                value = gauges[name]()
            except Exception:
                continue  # raising gauges are visible in /state, not here
            for labels, num in _numeric_items(name, value):
                lines.append(f"cruise_control_gauge{label(**labels)} {num}")
        return "\n".join(lines) + "\n"


def _escape_label(value: str) -> str:
    """Prometheus label-value escaping: backslash, double-quote, newline."""
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _numeric_items(sensor: str, value):
    """Flatten a gauge value into [(labels, number)]: numbers pass through,
    bools become 0/1, flat dicts of numbers get a `field` label; anything
    else (strings, nested structures) is /state-only."""
    if isinstance(value, bool):
        return [({"sensor": sensor}, int(value))]
    if isinstance(value, (int, float)):
        return [({"sensor": sensor}, value)]
    if isinstance(value, dict):
        out = []
        for k, v in sorted(value.items()):
            if isinstance(v, bool):
                out.append(({"sensor": sensor, "field": str(k)}, int(v)))
            elif isinstance(v, (int, float)):
                out.append(({"sensor": sensor, "field": str(k)}, v))
        return out
    return []


#: the process-wide registry (the `kafka.cruisecontrol` JMX domain analog)
REGISTRY = SensorRegistry()
