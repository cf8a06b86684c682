"""Sensor time-series history: trajectories, not snapshots.

Every observability surface (`/state` sensors, `/metrics`, `/trace`) is
point-in-time: it can say what a counter reads *now*, but not how fast it is
moving, whether a latency percentile is drifting, or what a sensor looked
like before the last proposal ran. Continuous-reconfiguration systems drive
decisions off *monitored trajectories* (PAPERS.md, arxiv 1602.03770), and
the ROADMAP perf items need trustworthy before/after evidence — so this
module keeps one: a bounded, thread-safe ring of flattened sensor-registry
snapshots, taken

  * on a configurable cadence (`observability.history.interval.s`; 0 —
    the default, and the tier-1 posture — disables the sampler thread),
  * at proposal / execution span boundaries (`record_boundary`, rate-limited
    so a burst of computations costs one snapshot), and
  * on demand (`GET /timeseries` scrapes snapshot when no sampler runs, so
    a scrape-driven deployment still accumulates history).

Queries are windowed: per-sensor first/last/delta/rate and in-window
percentiles (`query`), plus step-downsampled series (`series`) for plotting.
Snapshots optionally persist as JSONL next to the tracer's JSONL sink
(`observability.history.jsonl.path`). Each snapshot records a synthetic
`history` span, and the store self-measures its overhead
(`History.overhead-seconds`) for the <2% bench contract.
"""

from __future__ import annotations

import collections
import fnmatch
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from cruise_control_torch.common.sensors import REGISTRY


def flatten_snapshot(snapshot: Dict) -> Dict[str, float]:
    """Numeric time-series points from one registry snapshot: scalars keep
    their sensor name, one-level numeric dict fields become `name.field`;
    strings, errors, and deeper nesting are /state-only."""
    out: Dict[str, float] = {}
    for name, value in snapshot.items():
        if isinstance(value, bool):
            out[name] = float(value)
        elif isinstance(value, (int, float)):
            out[name] = float(value)
        elif isinstance(value, dict):
            for k, v in value.items():
                if isinstance(v, bool):
                    out[f"{name}.{k}"] = float(v)
                elif isinstance(v, (int, float)):
                    out[f"{name}.{k}"] = float(v)
    return out


def _percentile(sorted_vals: List[float], q: float) -> float:
    n = len(sorted_vals)
    return sorted_vals[min(n - 1, int(q * n))]


class TimeSeriesStore:
    """Bounded ring of (time, reason, {sensor: value}) snapshots."""

    def __init__(
        self,
        ring_size: int = 512,
        jsonl_path: Optional[str] = None,
        interval_s: float = 0.0,
        boundary_min_spacing_s: float = 2.0,
        clock=time.time,
    ):
        self._lock = threading.Lock()
        self._ring: "collections.deque" = collections.deque(maxlen=ring_size)  #: guarded_by(_lock)
        self._jsonl_path = jsonl_path  #: guarded_by(_lock)
        self._jsonl_file = None  #: guarded_by(_lock)
        self._interval_s = float(interval_s)  #: guarded_by(_lock)
        self._boundary_min_spacing_s = float(boundary_min_spacing_s)  #: guarded_by(_lock)
        self._last_boundary_mono = 0.0  #: guarded_by(_lock)
        self._snapshots = 0  #: guarded_by(_lock)
        self._overhead_s = 0.0  #: guarded_by(_lock)
        self._clock = clock
        self._thread: Optional[threading.Thread] = None  #: guarded_by(_lock)
        self._stop = threading.Event()

    # -- configuration ---------------------------------------------------------

    def configure(
        self,
        ring_size: Optional[int] = None,
        jsonl_path: Optional[str] = None,
        interval_s: Optional[float] = None,
        boundary_min_spacing_s: Optional[float] = None,
    ) -> None:
        """Resize the ring / point the JSONL sink / set the sampler cadence.
        Existing points are kept up to the new capacity; a cadence change
        takes effect at the next `start()`."""
        with self._lock:
            if ring_size is not None and ring_size != self._ring.maxlen:
                self._ring = collections.deque(
                    self._ring, maxlen=max(16, int(ring_size))
                )
            if jsonl_path is not None and jsonl_path != self._jsonl_path:
                if self._jsonl_file is not None:
                    try:
                        self._jsonl_file.close()
                    except OSError:
                        pass
                    self._jsonl_file = None
                self._jsonl_path = jsonl_path or None
            if interval_s is not None:
                self._interval_s = float(interval_s)
            if boundary_min_spacing_s is not None:
                self._boundary_min_spacing_s = float(boundary_min_spacing_s)

    @property
    def interval_s(self) -> float:
        with self._lock:
            return self._interval_s

    @property
    def overhead_s(self) -> float:
        """Cumulative seconds spent taking/persisting snapshots."""
        with self._lock:
            return self._overhead_s

    @property
    def sampler_running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    def start(self) -> bool:
        """Start the background sampler when a cadence is configured; no-op
        (returns False) at the default `interval_s=0` so tests and cold
        deployments pay nothing."""
        with self._lock:
            interval = self._interval_s
            if interval <= 0 or (self._thread is not None and self._thread.is_alive()):
                return False
            self._stop.clear()

            def run():
                while not self._stop.wait(interval):
                    try:
                        self.snapshot_now(reason="interval")
                    except Exception:  # the sampler must outlive one bad gauge
                        pass

            self._thread = threading.Thread(
                target=run, name="history-sampler", daemon=True
            )
            self._thread.start()
            return True

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)

    # -- writes ----------------------------------------------------------------

    def snapshot_now(self, reason: str = "tick") -> int:
        """Flatten the sensor registry into one timestamped point set; returns
        the number of series touched. Emits a synthetic `history` span so the
        snapshot cadence itself is visible on /trace."""
        t0 = time.monotonic()
        # registry gauges may take other locks (tracer, telemetry, this
        # store's own point-count gauge): flatten BEFORE taking our lock
        values = flatten_snapshot(REGISTRY.snapshot())
        t = self._clock()
        line = None
        with self._lock:
            self._ring.append((t, reason, values))
            self._snapshots += 1
            if self._jsonl_path:
                try:
                    if self._jsonl_file is None:
                        self._jsonl_file = open(self._jsonl_path, "a")
                    line = {"t": round(t, 3), "reason": reason, "values": values}
                    self._jsonl_file.write(json.dumps(line) + "\n")
                    self._jsonl_file.flush()
                except OSError:
                    # the sink is best-effort; a full disk must not take
                    # down the sampled operation
                    self._jsonl_file = None
            cost = time.monotonic() - t0
            self._overhead_s += cost
        from cruise_control_torch.common.tracing import TRACER

        TRACER.record_span(
            "history.snapshot", kind="history", duration_s=cost,
            reason=reason, series=len(values),
        )
        return len(values)

    def record_boundary(self, kind: str) -> bool:
        """Snapshot at a pipeline boundary (proposal / execution), rate-limited
        to one per `boundary_min_spacing_s` so bursts stay coarse."""
        now = time.monotonic()
        with self._lock:
            if now - self._last_boundary_mono < self._boundary_min_spacing_s:
                return False
            self._last_boundary_mono = now
        self.snapshot_now(reason=kind)
        return True

    # -- reads -----------------------------------------------------------------

    def _points_locked(self, window_s: Optional[float]) -> List[Tuple]:
        pts = list(self._ring)
        if window_s is not None and pts:
            cutoff = self._clock() - window_s
            pts = [p for p in pts if p[0] >= cutoff]
        return pts

    def names(self) -> List[str]:
        with self._lock:
            pts = list(self._ring)
        seen: Dict[str, None] = {}
        for _, _, values in pts:
            for name in values:
                seen.setdefault(name)
        return sorted(seen)

    def series(
        self,
        name: str,
        window_s: Optional[float] = None,
        step_s: Optional[float] = None,
    ) -> List[List[float]]:
        """[[t, value], ...] for one sensor, oldest first; `step_s` keeps the
        last point per step bucket (downsampling for plots)."""
        with self._lock:
            pts = self._points_locked(window_s)
        out = [[t, values[name]] for t, _, values in pts if name in values]
        if step_s and step_s > 0 and out:
            by_bucket: Dict[int, List[float]] = {}
            for t, v in out:
                by_bucket[int(t // step_s)] = [t, v]
            out = [by_bucket[b] for b in sorted(by_bucket)]
        return out

    def query(
        self,
        pattern: Optional[str] = None,
        window_s: Optional[float] = None,
    ) -> Dict[str, Dict]:
        """Windowed per-sensor statistics: first/last/delta, rate per second,
        and in-window percentiles. `pattern` is an fnmatch over sensor names."""
        with self._lock:
            pts = self._points_locked(window_s)
        by_name: Dict[str, List[Tuple[float, float]]] = {}
        for t, _, values in pts:
            for name, v in values.items():
                if pattern is not None and not fnmatch.fnmatchcase(name, pattern):
                    continue
                by_name.setdefault(name, []).append((t, v))
        out: Dict[str, Dict] = {}
        for name, tv in by_name.items():
            ts = [t for t, _ in tv]
            vs = [v for _, v in tv]
            dt = ts[-1] - ts[0]
            delta = vs[-1] - vs[0]
            sv = sorted(vs)
            out[name] = {
                "n": len(vs),
                "first": vs[0],
                "last": vs[-1],
                "delta": round(delta, 9),
                "ratePerS": round(delta / dt, 9) if dt > 0 else 0.0,
                "min": sv[0],
                "max": sv[-1],
                "p50": _percentile(sv, 0.50),
                "p95": _percentile(sv, 0.95),
            }
        return out

    def state(self) -> Dict:
        """The store watching itself (the /timeseries + /perf `history` block)."""
        with self._lock:
            return {
                "points": len(self._ring),
                "capacity": self._ring.maxlen or 0,
                "snapshots": self._snapshots,
                "intervalS": self._interval_s,
                "samplerRunning": self._thread is not None and self._thread.is_alive(),
                "jsonlPath": self._jsonl_path,
                "overheadS": round(self._overhead_s, 6),
            }

    def reset(self) -> None:
        """Drop retained points and counters (tests/bench isolation)."""
        with self._lock:
            self._ring.clear()
            self._snapshots = 0
            self._overhead_s = 0.0
            self._last_boundary_mono = 0.0


#: the process-wide store (`/timeseries`, the optimizer/executor boundaries)
HISTORY = TimeSeriesStore(
    ring_size=int(os.environ.get("CRUISE_CONTROL_HISTORY_RING", "512")),
    jsonl_path=os.environ.get("CRUISE_CONTROL_HISTORY_JSONL") or None,
)


def _register_history_gauges() -> None:
    REGISTRY.gauge("History.points", lambda: HISTORY.state()["points"])
    REGISTRY.gauge("History.snapshots", lambda: HISTORY.state()["snapshots"])
    REGISTRY.gauge("History.overhead-seconds", lambda: round(HISTORY.overhead_s, 6))


_register_history_gauges()
