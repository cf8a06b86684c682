"""Structured span tracer: the end-to-end story of one operation.

The reference's operability rests on two pillars: the Dropwizard sensor
table (common/sensors.py) and the operation log (common/oplog.py). Both are
aggregates — neither can answer "where did THIS proposal computation spend
its 9 seconds?". This module adds the missing pillar: a thread-safe span
tracer in the spirit of OpenTelemetry (trace-id/span-id/parent-id,
attributes, wall + monotonic clocks) with

  * a bounded in-memory ring (`/trace` serves from it; oldest spans drop),
  * an optional JSONL sink for durable traces,
  * thread-local span stacks, so nested `with TRACER.span(...)` blocks form
    a tree per thread and concurrent request threads never share lineage,
  * synthetic spans (`record_span`) for work that is only observable after
    the fact — per-goal segments inside one chunked machine call come back
    as rows of StackMetrics, not host-visible intervals,
  * self-measured bookkeeping overhead (`overhead_s`), so the bench can
    assert tracing costs <2% of proposal wall time instead of guessing.

Span kinds used across the pipeline (as the JAX package's docs/OBSERVABILITY.md):
  proposal   GoalOptimizer.optimizations, end to end
  goal       one goal's optimization (synthetic; engine/rounds/cost attrs)
  device-call one bounded call of the chunked goal machine
  monitor    LoadMonitor.cluster_model
  executor   execution lifecycle + per-phase/batch spans
  detector   anomaly-detector sweeps
  facade     get_proposals (cache hit/miss)
  validation proposal admission + batch-boundary revalidation
             (executor/validation.py; trimmed/admitted counts as attrs)
  drift      proposal-batch aborts on generation skew (recompute handoff)

Correlation with torch profiler captures: the optimizer wraps its machine
calls in torch.profiler.record_function("cc:...") under the tracer spans'
names, so a capture (set_profile_dir / `observability.profile.dir`) lines
up with tracer spans by name. The capture itself is gated here
(`maybe_profile`) and fires for ONE proposal computation only — profiling
every request would dwarf the work.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import threading
import time
import uuid
from typing import Dict, List, Optional


@dataclasses.dataclass
class Span:
    """One timed operation. `start_unix_s` is wall time (for humans and log
    correlation); durations come from the monotonic clock."""

    name: str
    kind: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start_unix_s: float
    start_mono: float
    end_mono: Optional[float] = None
    duration_s: Optional[float] = None
    attributes: Dict = dataclasses.field(default_factory=dict)
    error: Optional[str] = None

    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "startUnixS": round(self.start_unix_s, 6),
            "durationS": None if self.duration_s is None else round(self.duration_s, 6),
            "attributes": self.attributes,
            "error": self.error,
        }


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class Tracer:
    """Thread-safe bounded tracer; one process-wide instance (`TRACER`)."""

    def __init__(self, ring_size: int = 4096, jsonl_path: Optional[str] = None):
        self._lock = threading.Lock()
        self._ring: "collections.deque[Span]" = collections.deque(maxlen=ring_size)  #: guarded_by(_lock)
        self._local = threading.local()
        self._jsonl_path = jsonl_path  #: guarded_by(_lock)
        self._jsonl_file = None  #: guarded_by(_lock)
        self._overhead_s = 0.0  #: guarded_by(_lock)
        self._completed = 0  #: guarded_by(_lock)

    # -- configuration ---------------------------------------------------------

    def configure(self, ring_size: Optional[int] = None,
                  jsonl_path: Optional[str] = None) -> None:
        """Resize the ring and/or (re)point the JSONL sink. Existing spans are
        kept up to the new capacity; an empty/None path disables the sink."""
        with self._lock:
            if ring_size is not None and ring_size != self._ring.maxlen:
                self._ring = collections.deque(self._ring, maxlen=max(16, ring_size))
            if jsonl_path != self._jsonl_path:
                if self._jsonl_file is not None:
                    try:
                        self._jsonl_file.close()
                    except OSError:
                        pass
                    self._jsonl_file = None
                self._jsonl_path = jsonl_path or None

    @property
    def ring_size(self) -> int:
        # under the lock: `configure` swaps the ring object out from other
        # threads (the /state gauge reads this concurrently)
        with self._lock:
            return self._ring.maxlen or 0

    @property
    def overhead_s(self) -> float:
        """Cumulative seconds spent inside tracer bookkeeping."""
        with self._lock:
            return self._overhead_s

    @property
    def spans_recorded(self) -> int:
        """Completed spans ever recorded (not bounded by the ring)."""
        with self._lock:
            return self._completed

    # -- span lifecycle --------------------------------------------------------

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> Optional[Span]:
        stack = self._stack()
        return stack[-1] if stack else None

    def current_trace_id(self) -> Optional[str]:
        cur = self.current()
        return cur.trace_id if cur is not None else None

    def add_attributes(self, **attributes) -> None:
        """Attach attributes to the innermost open span (no-op outside one)."""
        cur = self.current()
        if cur is not None:
            cur.attributes.update(attributes)

    @contextlib.contextmanager
    def span(self, name: str, kind: str = "internal", **attributes):
        """Open a span; nests under the thread's current span."""
        t_in = time.monotonic()
        parent = self.current()
        sp = Span(
            name=name,
            kind=kind,
            trace_id=parent.trace_id if parent else _new_id(),
            span_id=_new_id(),
            parent_id=parent.span_id if parent else None,
            start_unix_s=time.time(),
            start_mono=0.0,
            attributes=dict(attributes),
        )
        stack = self._stack()
        stack.append(sp)
        t0 = time.monotonic()
        sp.start_mono = t0
        entry_cost = t0 - t_in
        try:
            yield sp
        except BaseException as e:
            sp.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            t1 = time.monotonic()
            sp.end_mono = t1
            sp.duration_s = t1 - sp.start_mono
            if stack and stack[-1] is sp:
                stack.pop()
            else:  # a child leaked past its parent; drop up to this span
                while stack and stack[-1] is not sp:
                    stack.pop()
                if stack:
                    stack.pop()
            self._finish(sp, entry_cost + (time.monotonic() - t1))

    def record_span(
        self,
        name: str,
        kind: str,
        duration_s: float,
        trace_id: Optional[str] = None,
        parent_id: Optional[str] = None,
        start_unix_s: Optional[float] = None,
        **attributes,
    ) -> Span:
        """Record an already-finished span (synthetic): work whose timing is
        only known after the fact — e.g. per-goal segments inside one
        machine call, attributed from its round counters. Inherits the
        calling thread's current trace/parent unless given explicitly."""
        t_in = time.monotonic()
        cur = self.current()
        sp = Span(
            name=name,
            kind=kind,
            trace_id=trace_id or (cur.trace_id if cur else _new_id()),
            span_id=_new_id(),
            parent_id=parent_id or (cur.span_id if cur else None),
            start_unix_s=time.time() if start_unix_s is None else start_unix_s,
            start_mono=t_in,
            end_mono=t_in,
            duration_s=float(duration_s),
            attributes=dict(attributes),
        )
        sp.attributes.setdefault("synthetic", True)
        self._finish(sp, time.monotonic() - t_in)
        return sp

    def _finish(self, sp: Span, cost_so_far: float) -> None:
        t0 = time.monotonic()
        line = None
        with self._lock:
            self._ring.append(sp)
            self._completed += 1
            if self._jsonl_path:
                try:
                    if self._jsonl_file is None:
                        self._jsonl_file = open(self._jsonl_path, "a")
                    line = self._jsonl_file
                    line.write(json.dumps(sp.to_dict(), default=str) + "\n")
                    line.flush()
                except OSError:
                    # the sink is best-effort; never let a full disk take
                    # down the traced operation
                    self._jsonl_file = None
            self._overhead_s += cost_so_far + (time.monotonic() - t0)

    # -- reads -----------------------------------------------------------------

    def recent(self, limit: int = 256, kind: Optional[str] = None,
               trace_id: Optional[str] = None) -> List[Dict]:
        """Newest-first completed spans, optionally filtered."""
        with self._lock:
            spans = list(self._ring)
        out = []
        for sp in reversed(spans):
            if kind is not None and sp.kind != kind:
                continue
            if trace_id is not None and sp.trace_id != trace_id:
                continue
            out.append(sp.to_dict())
            if len(out) >= limit:
                break
        return out

    def summarize(self) -> Dict[str, Dict]:
        """Per-kind latency table over the ring: count/total/mean/max +
        p50/p95/p99 (exact over the retained spans)."""
        with self._lock:
            spans = list(self._ring)
        by_kind: Dict[str, List[float]] = {}
        for sp in spans:
            if sp.duration_s is not None:
                by_kind.setdefault(sp.kind, []).append(sp.duration_s)
        out = {}
        for kind, durs in sorted(by_kind.items()):
            durs.sort()
            n = len(durs)

            def pct(q: float) -> float:
                return durs[min(n - 1, int(q * n))]

            out[kind] = {
                "count": n,
                "totalS": round(sum(durs), 6),
                "meanS": round(sum(durs) / n, 6),
                "maxS": round(durs[-1], 6),
                "p50S": round(pct(0.50), 6),
                "p95S": round(pct(0.95), 6),
                "p99S": round(pct(0.99), 6),
            }
        return out

    def reset(self) -> None:
        """Drop retained spans and overhead counters (tests/bench isolation).
        Open spans on other threads keep their lineage."""
        with self._lock:
            self._ring.clear()
            self._overhead_s = 0.0
            self._completed = 0


#: the process-wide tracer (`/trace` and every instrumented component)
TRACER = Tracer(
    ring_size=int(os.environ.get("CRUISE_CONTROL_TRACE_RING", "4096")),
    jsonl_path=os.environ.get("CRUISE_CONTROL_TRACE_JSONL") or None,
)


# -- config-gated one-shot profiler capture ------------------------------------

_profile_dir: Optional[str] = os.environ.get("CRUISE_CONTROL_PROFILE_DIR") or None
_profile_done = False
_profile_lock = threading.Lock()


def set_profile_dir(path: Optional[str]) -> None:
    """Arm (or disarm) the one-shot profiler capture
    (`observability.profile.dir`). The next proposal computation that enters
    `maybe_profile` writes a Chrome trace there (`trace.json`, host and CUDA
    activity); its `cc:`-prefixed record_function ranges correlate with
    tracer spans by name."""
    global _profile_dir, _profile_done
    with _profile_lock:
        _profile_dir = path or None
        _profile_done = False


@contextlib.contextmanager
def maybe_profile():
    """Wrap ONE operation in torch.profiler.profile when a profile dir is
    armed; afterwards (and otherwise) a no-op. Yields True when capturing."""
    global _profile_done
    with _profile_lock:
        target = None
        if _profile_dir and not _profile_done:
            _profile_done = True  # claim before capture: one shot even on races
            target = _profile_dir
    if target is None:
        yield False
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield True
    os.makedirs(target, exist_ok=True)
    prof.export_chrome_trace(os.path.join(target, "trace.json"))


# -- registry self-reporting ---------------------------------------------------

def _register_tracer_gauges() -> None:
    from cruise_control_torch.common.sensors import REGISTRY

    REGISTRY.gauge("Tracer.spans-recorded", lambda: TRACER.spans_recorded)
    REGISTRY.gauge("Tracer.overhead-seconds", lambda: round(TRACER.overhead_s, 6))
    REGISTRY.gauge("Tracer.ring-size", lambda: TRACER.ring_size)


_register_tracer_gauges()
