"""TCP cluster-agent driver: a live-cluster binding for the executor.

The reference executes movements by writing reassignment JSON into ZooKeeper
for the Kafka controller to act on and polling the znode until it clears
(scala/executor/ExecutorUtils.scala:32, cc/executor/Executor.java poll loop).
This driver speaks to a controller-side agent over a socket instead — the
deployment story for clusters where the controller surface is an agent/proxy
rather than direct ZK access. `testing.fake_agent` implements the agent side
of the protocol against a simulated cluster (the protocol-level fake the
integration tests run against); a production agent implements the same five
ops against the real admin API.

## Wire protocol (the adapter contract)

JSON objects, one per line (UTF-8, '\\n'-terminated), strict request/response
over a persistent connection. Requests carry `op`; responses carry
`ok: true` or `ok: false, error: str`.

  {"op": "reassign", "executionId": int, "topic": str, "partition": int,
   "replicas": [int, ...]}
      -> {"ok": true}
      Begin moving the partition to the given replica list (first entry =
      target leader if the proposal carries a leader action). Asynchronous:
      completion is observed via "finished".

  {"op": "leader", "executionId": int, "topic": str, "partition": int,
   "leader": int}
      -> {"ok": true}
      Trigger preferred-leader election to the given broker.

  {"op": "finished", "executionIds": [int, ...]}
      -> {"ok": true, "finished": [int, ...]}
      Which of the given executions have completed. Completion is sticky
      until consumed ONCE (the driver deletes its record after reading, the
      ZK-node contract); agents must tolerate ids they never saw (restarted
      driver) by reporting them unfinished.

  {"op": "ongoing"}
      -> {"ok": true, "ongoing": bool}
      Whether any reassignment is in flight agent-side — the executor
      refuses to start over one (cc/executor/Executor.java:494).

  {"op": "ping"} -> {"ok": true}
"""

from __future__ import annotations

import json
import socket
import threading
from typing import Callable, Dict, List, Optional, Set

from cruise_control_torch.common.retry import RetryPolicy
from cruise_control_torch.executor.driver import ClusterDriver
from cruise_control_torch.executor.task import ExecutionTask


class AgentProtocolError(RuntimeError):
    """The agent rejected a request or broke the line protocol.

    Deliberately NOT in the retryable set: the agent parsed the request and
    refused it, so re-sending the same bytes cannot change the answer."""


class _LineClient:
    """Blocking JSON-lines client over one persistent socket.

    `ssl_context` wraps the connection in TLS (the SslTest analog for the
    agent path, mr/CruiseControlMetricsReporter.java:110-128 configures
    producer SSL); `server_hostname` is what the certificate is verified
    against when the context checks hostnames (cert pinning: build the
    context with load_verify_locations on the agent's own cert)."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0,
                 ssl_context=None, server_hostname: Optional[str] = None,
                 fault_hook: Optional[Callable[[Dict], None]] = None):
        self._addr = (host, port)
        self._timeout = timeout_s
        self._ssl_context = ssl_context
        self._server_hostname = server_hostname or host
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        self._lock = threading.Lock()
        #: test-only client-side fault injection (testing/faults.py): called
        #: with the payload before each send; may raise ConnectionError/delay
        self._fault_hook = fault_hook

    def _connect(self) -> None:
        sock = socket.create_connection(self._addr, timeout=self._timeout)
        sock.settimeout(self._timeout)
        if self._ssl_context is not None:
            sock = self._ssl_context.wrap_socket(
                sock, server_hostname=self._server_hostname
            )
        self._sock = sock
        self._rfile = sock.makefile("rb")

    def request(self, payload: Dict, idempotent: bool = True) -> Dict:
        """One request/response exchange. A mid-exchange connection drop is
        retried ONCE only for `idempotent` requests — after a send, the agent
        may have processed the request even though the response was lost, so
        re-sending a non-idempotent payload (e.g. metrics_publish) would
        duplicate its effect; those surface the error to the caller instead."""
        with self._lock:
            for attempt in (0, 1):
                try:
                    if self._fault_hook is not None:
                        self._fault_hook(payload)
                    if self._sock is None:
                        self._connect()
                    self._sock.sendall(json.dumps(payload).encode() + b"\n")
                    line = self._rfile.readline()
                    if not line:
                        raise ConnectionError("agent closed the connection")
                    break
                except (OSError, ConnectionError):
                    self.close()
                    if attempt or not idempotent:
                        raise
        resp = json.loads(line)
        if not resp.get("ok"):
            raise AgentProtocolError(resp.get("error", "agent rejected request"))
        return resp

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._rfile = None


class TcpClusterDriver(ClusterDriver):
    """Executor binding over the cluster-agent wire protocol above.

    Every op runs under `retry_policy` with reconnect-on-failure: the
    _LineClient drops its socket on any transport error, so the next attempt
    re-dials from scratch. ALL five ops are safely retryable — `finished`/
    `ongoing`/`ping` are pure reads, and `reassign`/`leader` are idempotent
    by protocol because they are keyed on executionId (re-sending the same
    executionId overwrites the agent's pending entry for it, it does not
    start a second movement)."""

    def __init__(self, host: str, port: int, timeout_s: float = 10.0,
                 ssl_context=None, server_hostname: Optional[str] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 fault_hook: Optional[Callable[[Dict], None]] = None):
        self._client = _LineClient(host, port, timeout_s, ssl_context=ssl_context,
                                   server_hostname=server_hostname,
                                   fault_hook=fault_hook)
        self._retry = retry_policy or RetryPolicy()
        self._finished: Set[int] = set()
        self._in_flight: Dict[int, ExecutionTask] = {}
        self._lock = threading.Lock()

    def _request(self, payload: Dict) -> Dict:
        op = payload.get("op", "op")
        return self._retry.call(
            lambda: self._client.request(payload), name=f"TcpDriver.{op}"
        )

    def _entry(self, task: ExecutionTask) -> Dict:
        p = task.proposal
        topic, _, part = (p.topic_partition or f"p-{p.partition}").rpartition("-")
        return {
            "executionId": task.execution_id,
            "topic": topic or f"p{p.partition}",
            "partition": int(part) if part.isdigit() else p.partition,
        }

    def start_replica_movement(self, task: ExecutionTask) -> None:
        req = {
            "op": "reassign",
            **self._entry(task),
            "replicas": list(task.proposal.new_replicas),
        }
        self._request(req)
        with self._lock:
            self._in_flight[task.execution_id] = task

    def start_leadership_movement(self, task: ExecutionTask) -> None:
        req = {
            "op": "leader",
            **self._entry(task),
            "leader": task.proposal.new_leader,
        }
        self._request(req)
        with self._lock:
            self._in_flight[task.execution_id] = task

    def poll(self) -> None:
        """One agent round-trip covering every in-flight task (the executor
        calls this once per progress-check interval; batching keeps it one
        RPC regardless of in-flight count)."""
        with self._lock:
            ids = list(self._in_flight)
        if not ids:
            return
        resp = self._request({"op": "finished", "executionIds": ids})
        done = set(resp.get("finished", ()))
        with self._lock:
            self._finished |= done
            for eid in done:
                self._in_flight.pop(eid, None)

    def is_finished(self, task: ExecutionTask) -> bool:
        with self._lock:
            if task.execution_id in self._finished:
                self._finished.discard(task.execution_id)  # consume once
                return True
        return False

    def has_ongoing_reassignment(self) -> bool:
        resp = self._request({"op": "ongoing"})
        return bool(resp.get("ongoing"))

    def close(self) -> None:
        self._client.close()
