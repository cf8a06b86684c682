"""Protocol-level fake cluster agent: the controller side of the TCP driver.

Implements the cluster-agent wire protocol (executor.tcp_driver module
docstring) against a SimulatedCluster — the analog of the reference's
embedded-ZK/Kafka integration harness (cct/executor/ExecutorTest.java boots a
real broker; here the protocol surface is real and the cluster behind it is
the simulator). Movements complete after `latency_polls` "finished" probes,
exercising the executor's poll loop exactly like a controller that takes time
to move data.

Runs in-process (`FakeClusterAgent(...).start()`), which keeps the
integration test deterministic while every byte still crosses a real socket.
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

from cruise_control_torch.common.lineserver import JsonLinesServer


class FakeClusterAgent:
    """JSON-lines TCP server applying reassignments to a SimulatedCluster.

    Transport (threaded socket loop, TLS termination — the SslTest analog)
    is the SHARED JsonLinesServer, the same scaffolding the production
    Kafka agent serves on; only the dispatch differs."""

    def __init__(self, sim, latency_polls: int = 0, host: str = "127.0.0.1",
                 ssl_context=None, fault_plan=None):
        """`fault_plan` (testing.faults.FaultPlan): injected faults consulted
        before dispatch (fail/drop/delay) and when recording movements
        (never_finish)."""
        self._sim = sim
        self._latency = latency_polls
        self._faults = fault_plan
        self._lock = threading.Lock()
        #: executionId -> (kind, payload, remaining_probes); remaining < 0
        #: means the movement NEVER completes (injected hung controller)
        self._pending: Dict[int, Tuple[str, Dict, int]] = {}
        self._finished: set = set()
        self._metrics: list = []  # hex-encoded records, consumed by poll
        self._server = JsonLinesServer(
            self._dispatch, host=host, ssl_context=ssl_context,
            name="fake-cluster-agent",
        )

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.address

    def start(self) -> "FakeClusterAgent":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop()

    # -- protocol ops ----------------------------------------------------------

    def _dispatch(self, req: Dict) -> Dict:
        if self._faults is not None:
            injected = self._faults.server_intercept(req)
            if injected is not None:
                return injected
        op = req.get("op")
        if op == "ping":
            return {"ok": True}
        if op in ("reassign", "leader"):
            latency = self._latency
            if self._faults is not None and self._faults.never_finishes(req):
                latency = -1
            with self._lock:
                self._pending[int(req["executionId"])] = (op, req, latency)
            return {"ok": True}
        if op == "finished":
            done = []
            with self._lock:
                for eid in req.get("executionIds", ()):
                    eid = int(eid)
                    if eid in self._finished:
                        done.append(eid)
                        continue
                    entry = self._pending.get(eid)
                    if entry is None:
                        continue  # unknown id (restarted driver): unfinished
                    kind, payload, remaining = entry
                    if remaining < 0:
                        continue  # injected never-finishing movement
                    if remaining > 0:
                        self._pending[eid] = (kind, payload, remaining - 1)
                        continue
                    self._apply(kind, payload)
                    del self._pending[eid]
                    self._finished.add(eid)
                    done.append(eid)
            return {"ok": True, "finished": done}
        if op == "ongoing":
            with self._lock:
                return {"ok": True, "ongoing": bool(self._pending)}
        if op == "metrics_publish":
            with self._lock:
                self._metrics.extend(req.get("records", ()))
            return {"ok": True}
        if op == "metrics_poll":
            n = int(req.get("max", 10000))
            with self._lock:
                out, self._metrics = self._metrics[:n], self._metrics[n:]
            return {"ok": True, "records": out}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _apply(self, kind: str, req: Dict) -> None:
        partition = int(req["partition"])
        if kind == "leader":
            self._sim.apply_leadership(partition, int(req["leader"]))
            return
        new = list(req["replicas"])
        current = [
            b for b in range(self._sim.model().num_brokers)
            if self._sim.has_partition(partition, b)
        ]
        removed = [b for b in current if b not in new]
        added = [b for b in new if b not in current]
        for i, dst in enumerate(added):
            if i < len(removed):
                self._sim.apply_movement(partition, removed[i], dst)
            else:
                self._sim.add_replica(partition, dst)
        for src in removed[len(added):]:
            self._sim.remove_replica(partition, src)
        if new and self._sim.leader_of(partition) != new[0]:
            self._sim.apply_leadership(partition, new[0])
