"""Deterministic fault injection for the cluster-agent protocol.

A FaultPlan is an ordered list of FaultRules consulted on every request, on
either side of the wire:

  * server-side — FakeClusterAgent passes each decoded request through
    `server_intercept` before dispatching it, so a rule can fail the op,
    delay it, sever the connection unanswered, or mark a movement as
    never-finishing;
  * client-side — `_LineClient(fault_hook=plan.client_intercept)` consults
    the plan before each send, so a rule can simulate the client's OWN
    socket dying mid-exchange (drop) or a slow network (delay).

Rules are consumed deterministically: a rule matches its op pattern at most
`times` times (-1 = forever), in plan order, first match wins. Every
integration test in tests/test_resilience.py is driven through this plan —
the retry, deadline, and breaker behaviors are exercised against the real
socket protocol, not mocks.

Protocol faults compose with CLUSTER faults: testing/chaos.py streams
seeded topology perturbations (broker death, topic delete, partition-count
change, load spikes) into the simulator while the executor is mid-batch —
a FaultPlan drives the wire, a ChaosPlan drives the cluster
(tests/test_chaos_replay.py runs both at once).

Actions:
  fail          answer {"ok": false, "error": ...} without dispatching
  drop          sever the connection without answering (DropConnection
                server-side, ConnectionError client-side)
  delay         sleep `delay_s` then pass through (drive client timeouts)
  never_finish  the matched reassign/leader execution never completes
                (its "finished" probe never reports it) — the hung-
                controller case the task deadline exists for
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

from cruise_control_torch.common.lineserver import DropConnection

_ACTIONS = ("fail", "drop", "delay", "never_finish")


@dataclasses.dataclass
class FaultRule:
    """One injectable fault. `op` matches the request's op field ("*" = any);
    `partition`, when set, additionally matches the request's partition."""

    op: str
    action: str
    times: int = 1  # matches consumed before the rule retires; -1 = forever
    delay_s: float = 0.0
    partition: Optional[int] = None
    error: str = "injected fault"

    def __post_init__(self):
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}")

    def matches(self, req: Dict) -> bool:
        if self.op != "*" and req.get("op") != self.op:
            return False
        if self.partition is not None and req.get("partition") != self.partition:
            return False
        return True


class FaultPlan:
    """Thread-safe, order-preserving fault schedule over FaultRules."""

    def __init__(self, rules: Sequence[FaultRule] = (),
                 sleep=time.sleep):
        self._rules: List[FaultRule] = list(rules)
        self._lock = threading.Lock()
        self._sleep = sleep
        #: (rule index, op) log of every fault actually fired, for assertions
        self.fired: List[Dict] = []

    def add(self, rule: FaultRule) -> "FaultPlan":
        with self._lock:
            self._rules.append(rule)
        return self

    def _take(self, req: Dict, actions: Sequence[str]) -> Optional[FaultRule]:
        """First live rule matching `req` with one of `actions`, consuming
        one of its `times`."""
        with self._lock:
            for i, rule in enumerate(self._rules):
                if rule.action not in actions or rule.times == 0:
                    continue
                if not rule.matches(req):
                    continue
                if rule.times > 0:
                    rule.times -= 1
                self.fired.append({"rule": i, "action": rule.action,
                                   "op": req.get("op")})
                return rule
        return None

    # -- server side (FakeClusterAgent) ----------------------------------------

    def server_intercept(self, req: Dict) -> Optional[Dict]:
        """Consult the plan for one decoded request. Returns an error
        response to send instead of dispatching, raises DropConnection to
        sever, sleeps for delay rules, or returns None to pass through
        (never_finish rules pass through here — the agent consults
        `never_finishes` when it records the movement)."""
        rule = self._take(req, ("fail", "drop", "delay"))
        if rule is None:
            return None
        if rule.action == "fail":
            return {"ok": False, "error": rule.error}
        if rule.action == "drop":
            raise DropConnection(rule.error)
        self._sleep(rule.delay_s)
        return None

    def never_finishes(self, req: Dict) -> bool:
        """Whether a never_finish rule covers this reassign/leader request
        (checked by the agent when it records the pending movement; `times`
        counts movements, not completion probes)."""
        return self._take(req, ("never_finish",)) is not None

    # -- client side (_LineClient fault_hook) ----------------------------------

    def client_intercept(self, payload: Dict) -> None:
        """fault_hook contract: called with the payload before each send.
        drop → ConnectionError (the client treats it like a dead socket and
        reconnects on the next attempt); delay → sleep; fail/never_finish
        are server-side-only and pass through here."""
        rule = self._take(payload, ("drop", "delay"))
        if rule is None:
            return
        if rule.action == "drop":
            raise ConnectionError(rule.error)
        self._sleep(rule.delay_s)
