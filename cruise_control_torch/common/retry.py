"""Execution resilience primitives: retry policies and circuit breakers.

The reference executor rides on the Kafka admin client's own retry/backoff
machinery (NetworkClient reconnect.backoff.ms, request.timeout.ms); this
build's cluster I/O is the agent wire protocol, so the resilience layer
lives here instead. Two primitives, both deterministic under an injected
clock so every behavior is testable without wall-clock sleeps:

  * RetryPolicy — bounded exponential backoff around one callable:
    max attempts, per-call deadline, and a retryable-error classification
    (a ConnectionError is worth re-sending; an AgentProtocolError means the
    agent UNDERSTOOD the request and said no — retrying cannot help).
  * CircuitBreaker — the classic closed → open → half-open ladder: after
    `failure_threshold` consecutive failures the breaker opens and `allow()`
    answers False until `cooldown_s` elapses; the first call after cooldown
    runs as a half-open probe whose outcome closes or re-opens the breaker.

Both report through the process sensor registry (meters per policy/breaker
name) and the span tracer (synthetic `resilience` spans on retry sequences
and breaker transitions) — docs/RESILIENCE.md carries the failure matrix,
docs/OBSERVABILITY.md the sensor rows.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional, Tuple, Type


#: errors worth re-sending by default: transport failures and timeouts.
#: Protocol-level rejections (the agent parsed the request and refused) are
#: deliberately NOT here — see tcp_driver.AgentProtocolError.
DEFAULT_RETRYABLE: Tuple[Type[BaseException], ...] = (ConnectionError, OSError, TimeoutError)


class RetryExhaustedError(RuntimeError):
    """All attempts failed; `__cause__` is the last underlying error."""


class RetryPolicy:
    """Bounded exponential backoff around a callable.

    `call(fn)` runs `fn` up to `max_attempts` times, sleeping
    `backoff_s * 2**attempt` (capped at `max_backoff_s`) between attempts,
    stopping early when `deadline_s` of wall clock has elapsed since the
    first attempt. Only errors matching `retryable` are retried; anything
    else propagates immediately. Exhaustion raises RetryExhaustedError with
    the last error as `__cause__`.

    `clock`/`sleep` are injectable for deterministic tests; instances are
    immutable and safe to share across threads.
    """

    def __init__(
        self,
        max_attempts: int = 4,
        backoff_s: float = 0.05,
        max_backoff_s: float = 2.0,
        deadline_s: Optional[float] = None,
        retryable: Tuple[Type[BaseException], ...] = DEFAULT_RETRYABLE,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.backoff_s = backoff_s
        self.max_backoff_s = max_backoff_s
        self.deadline_s = deadline_s
        self.retryable = retryable
        self._clock = clock
        self._sleep = sleep

    @classmethod
    def from_config(cls, config, **overrides) -> "RetryPolicy":
        """Build from the `executor.retry.*` keys (config/cruise_config.py)."""
        kwargs = dict(
            max_attempts=config.get_int("executor.retry.attempts"),
            backoff_s=config.get_double("executor.retry.backoff.s"),
            max_backoff_s=config.get_double("executor.retry.max.backoff.s"),
        )
        kwargs.update(overrides)
        return cls(**kwargs)

    def backoff_for(self, attempt: int) -> float:
        """Sleep before attempt `attempt+1` (attempt is 0-based)."""
        return min(self.max_backoff_s, self.backoff_s * (2.0 ** attempt))

    def call(self, fn: Callable[[], object], name: str = "op"):
        """Run `fn` under this policy; `name` labels sensors and spans."""
        from cruise_control_torch.common.sensors import REGISTRY
        from cruise_control_torch.common.tracing import TRACER

        start = self._clock()
        last_error: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            try:
                result = fn()
                if attempt:  # a retry sequence that recovered is a story worth telling
                    REGISTRY.meter(f"Retry.{name}.recoveries").mark()
                    TRACER.record_span(
                        f"retry.{name}", kind="resilience",
                        duration_s=self._clock() - start,
                        attempts=attempt + 1, outcome="recovered",
                    )
                return result
            except self.retryable as e:
                last_error = e
                REGISTRY.meter(f"Retry.{name}.failures").mark()
                if attempt + 1 >= self.max_attempts:
                    break
                pause = self.backoff_for(attempt)
                if self.deadline_s is not None and (
                    self._clock() - start + pause >= self.deadline_s
                ):
                    break
                REGISTRY.meter(f"Retry.{name}.retries").mark()
                self._sleep(pause)
        REGISTRY.meter(f"Retry.{name}.exhausted").mark()
        TRACER.record_span(
            f"retry.{name}", kind="resilience", duration_s=self._clock() - start,
            attempts=self.max_attempts, outcome="exhausted",
            error=f"{type(last_error).__name__}: {last_error}",
        )
        raise RetryExhaustedError(
            f"{name}: {self.max_attempts} attempt(s) failed"
        ) from last_error


class CircuitBreaker:
    """closed → open → half-open breaker with cooldown.

    `allow()` answers whether a protected call may run right now: always in
    CLOSED; in OPEN only once the cooldown elapsed, which transitions to
    HALF_OPEN and admits exactly one probe; further `allow()` calls in
    HALF_OPEN are refused until the probe reports via `record_success()`
    (→ CLOSED) or `record_failure()` (→ OPEN, cooldown restarts).
    Thread-safe; `clock` injectable for deterministic tests.
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    #: numeric encoding for /metrics gauges (strings don't render there)
    STATE_CODES = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

    def __init__(
        self,
        name: str,
        failure_threshold: int = 3,
        cooldown_s: float = 300.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.name = name
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED  #: guarded_by(_lock)
        self._consecutive_failures = 0  #: guarded_by(_lock)
        self._opened_at: Optional[float] = None  #: guarded_by(_lock)
        self._probe_in_flight = False  #: guarded_by(_lock)
        self._opens = 0  #: guarded_by(_lock)

    def _record_transition_locked(self, target: str) -> None:
        from cruise_control_torch.common.sensors import REGISTRY
        from cruise_control_torch.common.tracing import TRACER

        REGISTRY.meter(f"CircuitBreaker.{self.name}.{target}").mark()
        TRACER.record_span(
            f"breaker.{self.name}", kind="resilience", duration_s=0.0,
            state=target, consecutiveFailures=self._consecutive_failures,
        )

    @property
    def state(self) -> str:
        with self._lock:
            return self._effective_state_locked()

    def _effective_state_locked(self) -> str:
        if self._state == self.OPEN and self._opened_at is not None:
            if self._clock() - self._opened_at >= self.cooldown_s:
                return self.HALF_OPEN
        return self._state

    def allow(self) -> bool:
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN and self._opened_at is not None:
                if self._clock() - self._opened_at >= self.cooldown_s:
                    self._state = self.HALF_OPEN
                    self._probe_in_flight = True
                    self._record_transition_locked(self.HALF_OPEN)
                    return True
                return False
            # HALF_OPEN: one probe at a time
            if not self._probe_in_flight:
                self._probe_in_flight = True
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probe_in_flight = False
            if self._state != self.CLOSED:
                self._state = self.CLOSED
                self._opened_at = None
                self._record_transition_locked(self.CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            trip = (
                self._state == self.HALF_OPEN  # a failed probe re-opens at once
                or self._consecutive_failures >= self.failure_threshold
            )
            self._probe_in_flight = False
            if trip:
                already_open = self._state == self.OPEN
                self._state = self.OPEN
                self._opened_at = self._clock()
                if not already_open:
                    self._opens += 1
                    self._record_transition_locked(self.OPEN)

    def remaining_cooldown_s(self) -> float:
        with self._lock:
            if self._state != self.OPEN or self._opened_at is None:
                return 0.0
            return max(0.0, self.cooldown_s - (self._clock() - self._opened_at))

    def snapshot(self) -> dict:
        with self._lock:
            state = self._effective_state_locked()
            remaining = 0.0
            if self._state == self.OPEN and self._opened_at is not None:
                remaining = max(0.0, self.cooldown_s - (self._clock() - self._opened_at))
            return {
                "state": state,
                "consecutiveFailures": self._consecutive_failures,
                "failureThreshold": self.failure_threshold,
                "cooldownS": self.cooldown_s,
                "cooldownRemainingS": round(remaining, 3),
                "opens": self._opens,
            }
