"""Production cluster agent: the wire protocol served against a REAL Kafka.

The executor's live-cluster binding ends at the JSON-lines agent protocol
(executor/tcp_driver.py module docstring: reassign / leader / finished /
ongoing / ping, plus the metrics transport's metrics_publish / metrics_poll).
`testing.fake_agent.FakeClusterAgent` implements that protocol against the
in-process simulator for tests; THIS module is the reference production
implementation, mapping the same ops onto a Kafka admin client — the analog
of the reference's ZK bridge and Kafka-backed sample store:

  reassign   -> AdminClient.alter_partition_reassignments, the KIP-455
                successor of writing reassignment JSON into ZooKeeper
                (scala/executor/ExecutorUtils.scala:32)
  leader     -> preferred-leader election
                (scala PreferredReplicaLeaderElectionCommand wrapper)
  finished   -> list_partition_reassignments: a topic-partition absent from
                the in-flight set has completed (the reference polls the
                reassignment znode until it clears, cc/executor/Executor.java)
  ongoing    -> list_partition_reassignments non-empty
                (cc/executor/Executor.java:494 refuses to start over one)
  metrics_*  -> produce/consume on a metrics topic, the deployment shape of
                CruiseControlMetricsReporter + KafkaSampleStore
                (mr/CruiseControlMetricsReporter.java:128,
                cc/monitor/sampling/KafkaSampleStore.java:294)

Layering: `ClusterAgentServer` owns the protocol bookkeeping (executionId
tracking, sticky-until-consumed completion, unknown-id tolerance) against an
`AdminAdapter` SPI; `KafkaAdminAdapter` is the kafka-python binding. The
split keeps the protocol logic unit-testable without a broker (the sandbox
has none), while the adapter stays a thin, auditable mapping. kafka-python
is imported lazily and guarded — constructing `KafkaAdminAdapter` without it
raises a clear error, and nothing in this module runs at package import.

Run standalone:
  python -m cruise_control_torch.executor.kafka_agent \
      --bootstrap localhost:9092 --port 9500 [--metrics-topic __CCMetrics]
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple


class AdminAdapter:
    """What the agent needs from a cluster admin client.

    Implementations must be thread-safe (the agent server handles each
    connection on its own thread)."""

    def begin_reassignment(self, topic: str, partition: int, replicas: List[int]) -> None:
        """Start moving the partition to `replicas` (async)."""
        raise NotImplementedError

    def elect_leader(self, topic: str, partition: int, leader: int) -> None:
        """Make `leader` the partition's leader (preferred election)."""
        raise NotImplementedError

    def reassignment_done(self, topic: str, partition: int) -> bool:
        """True when no reassignment is in flight for the partition."""
        raise NotImplementedError

    def pending_reassignments(self) -> Optional[set]:
        """The set of (topic, partition) still moving, or None when the
        client has no bulk listing — the agent then falls back to per-
        partition reassignment_done probes. Implementations with a bulk API
        should override: a 'finished' request probes every in-flight
        executionId, and one listing answers all of them in one round-trip."""
        return None

    def any_ongoing(self) -> bool:
        """True when ANY reassignment is in flight cluster-wide."""
        raise NotImplementedError

    def publish_metrics(self, records: List[str]) -> None:
        """Durably accept reporter records (hex-encoded serde payloads)."""
        raise NotImplementedError

    def poll_metrics(self, max_records: int) -> List[str]:
        """Return up to max_records pending records, consuming them."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class KafkaAdminAdapter(AdminAdapter):
    """kafka-python binding of the AdminAdapter SPI.

    Requires kafka-python >= 2.0 (KIP-455 reassignment APIs). The import is
    deferred to construction so the module stays importable in environments
    without a Kafka client (this sandbox); integration tests run against the
    protocol-level fake instead (tests/test_cluster_binding.py).
    """

    def __init__(self, bootstrap_servers: str, metrics_topic: str = "__CruiseControlMetrics",
                 client_id: str = "cruise-control-torch-agent"):
        try:
            from kafka import KafkaConsumer, KafkaProducer, TopicPartition
            from kafka.admin import KafkaAdminClient
        except ImportError as e:  # pragma: no cover - no broker in CI
            raise RuntimeError(
                "KafkaAdminAdapter requires kafka-python (pip install kafka-python); "
                "use testing.fake_agent.FakeClusterAgent for tests"
            ) from e
        # the admin APIs take TYPED arguments (TopicPartition keys,
        # NewPartitionReassignment values, an ElectionType member) — plain
        # tuples/strings raise AttributeError inside the client's encoder.
        # Resolved here, guarded, so an older client fails at construction
        # with a clear message instead of mid-rebalance.
        self._TopicPartition = TopicPartition
        try:  # pragma: no cover - needs kafka-python
            from kafka.admin import NewPartitionReassignment

            self._NewPartitionReassignment = NewPartitionReassignment
        except ImportError:
            self._NewPartitionReassignment = None
        try:  # pragma: no cover - needs kafka-python
            from kafka.admin import ElectionType

            self._preferred_election = ElectionType.PREFERRED
        except ImportError:
            self._preferred_election = None
        self._admin = KafkaAdminClient(
            bootstrap_servers=bootstrap_servers, client_id=client_id
        )
        self._producer = KafkaProducer(bootstrap_servers=bootstrap_servers)
        self._consumer = KafkaConsumer(
            metrics_topic,
            bootstrap_servers=bootstrap_servers,
            group_id=client_id,
            enable_auto_commit=True,
            consumer_timeout_ms=500,
        )
        self._metrics_topic = metrics_topic
        # per-client locks: the admin and consumer clients each need
        # serialization against THEMSELVES only (KafkaConsumer forbids
        # concurrent use; admin ops share one connection), while
        # KafkaProducer is documented thread-safe — one shared lock would
        # make every status RPC queue behind a 500 ms consumer poll window
        self._admin_lock = threading.Lock()
        self._consumer_lock = threading.Lock()

    def begin_reassignment(self, topic: str, partition: int, replicas: List[int]) -> None:
        # KIP-455 AlterPartitionReassignments — the post-ZK form of
        # ExecutorUtils.executeReplicaReassignmentTasks (scala :32). Newer
        # kafka-python exposes it as alter_partition_reassignments; guard so
        # an older client fails loudly rather than silently no-oping.
        alter = getattr(self._admin, "alter_partition_reassignments", None)
        if alter is None or self._NewPartitionReassignment is None:  # pragma: no cover
            raise RuntimeError(
                "kafka-python too old: alter_partition_reassignments / "
                "NewPartitionReassignment missing (need the KIP-455 admin API)"
            )
        with self._admin_lock:
            alter({
                self._TopicPartition(topic, partition):
                    self._NewPartitionReassignment(list(replicas))
            })

    def elect_leader(self, topic: str, partition: int, leader: int) -> None:
        # Preferred-leader election: KIP-460 ElectLeaders
        # (PreferredReplicaLeaderElectionCommand semantics). Requires a
        # client that exposes it — re-ordering the replica list via a
        # reassignment does NOT elect by itself (the leader only changes on
        # an unrelated auto.leader.rebalance cycle), so faking it here would
        # let the agent report leadership movements complete that never
        # happened. Fail loudly instead.
        elect = getattr(self._admin, "perform_leader_election", None)
        if elect is None or self._preferred_election is None:  # pragma: no cover
            raise RuntimeError(
                "kafka-python does not expose perform_leader_election / "
                "ElectionType (KIP-460); upgrade the client — leadership "
                "movements cannot be executed correctly without it"
            )
        with self._admin_lock:
            elect(
                self._preferred_election,
                [self._TopicPartition(topic, partition)],
            )

    def _in_flight(self) -> Dict[Tuple[str, int], List[int]]:
        lister = getattr(self._admin, "list_partition_reassignments", None)
        if lister is None:  # pragma: no cover - version-dependent
            raise RuntimeError(
                "kafka-python too old: list_partition_reassignments missing"
            )
        with self._admin_lock:
            return dict(lister() or {})

    def reassignment_done(self, topic: str, partition: int) -> bool:
        return (topic, partition) not in self._in_flight()

    def pending_reassignments(self) -> Optional[set]:
        # one list_partition_reassignments round-trip answers every
        # executionId in a 'finished' request
        return set(self._in_flight())

    def any_ongoing(self) -> bool:
        return bool(self._in_flight())

    def publish_metrics(self, records: List[str]) -> None:
        # KafkaProducer is thread-safe; no lock needed
        for rec in records:
            self._producer.send(self._metrics_topic, bytes.fromhex(rec))
        self._producer.flush()

    def poll_metrics(self, max_records: int) -> List[str]:
        # KafkaConsumer forbids concurrent use (a reconnecting transport
        # plus its stale connection would otherwise interleave on it)
        out: List[str] = []
        with self._consumer_lock:
            for msg in self._consumer:
                out.append(bytes(msg.value).hex())
                if len(out) >= max_records:
                    break
        return out

    def close(self) -> None:
        for c in (self._consumer, self._producer, self._admin):
            try:
                c.close()
            except Exception:
                pass


class ClusterAgentServer:
    """JSON-lines TCP server speaking the cluster-agent protocol against any
    AdminAdapter.

    Protocol bookkeeping matches the contract in executor/tcp_driver.py:
    completion is sticky until consumed once via "finished"; executionIds the
    agent never saw (a restarted driver) report unfinished; `leader` ops
    complete on their next "finished" probe (elections are synchronous at the
    admin API). `ssl_context` wraps accepted connections in TLS (the
    metrics-path security story; see reporter/transport.py).
    """

    #: completed executionIds remembered for late probes; bounded — the
    #: driver consumes completion exactly once (tcp_driver.is_finished), so
    #: old entries only serve duplicate probes and a production agent that
    #: rebalances continuously must not leak one entry per movement forever
    FINISHED_CAP = 65536

    def __init__(self, adapter: AdminAdapter, host: str = "127.0.0.1",
                 port: int = 0, ssl_context=None):
        import collections

        from cruise_control_torch.common.lineserver import JsonLinesServer

        self._adapter = adapter
        self._lock = threading.Lock()
        #: executionId -> (topic, partition) still moving; None = leader op
        self._pending: Dict[int, Optional[Tuple[str, int]]] = {}
        self._finished: "collections.OrderedDict" = collections.OrderedDict()
        # transport is the SAME JsonLinesServer the protocol-level test fake
        # serves on (testing.fake_agent) — framing/TLS changes land once
        self._server = JsonLinesServer(
            self._dispatch, host=host, port=port, ssl_context=ssl_context,
            name="cluster-agent",
        )

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.address

    def start(self) -> "ClusterAgentServer":
        self._server.start()
        return self

    def stop(self) -> None:
        self._server.stop()
        self._adapter.close()

    def _dispatch(self, req: Dict) -> Dict:
        op = req.get("op")
        if op == "ping":
            return {"ok": True}
        if op == "reassign":
            topic, part = str(req["topic"]), int(req["partition"])
            self._adapter.begin_reassignment(
                topic, part, [int(b) for b in req["replicas"]]
            )
            with self._lock:
                self._pending[int(req["executionId"])] = (topic, part)
            return {"ok": True}
        if op == "leader":
            self._adapter.elect_leader(
                str(req["topic"]), int(req["partition"]), int(req["leader"])
            )
            with self._lock:
                # elections are synchronous at the admin API: done on the
                # next probe
                self._pending[int(req["executionId"])] = None
            return {"ok": True}
        if op == "finished":
            done = []
            with self._lock:
                pending = dict(self._pending)
                finished = set(self._finished)
            # one bulk listing when the adapter has one (the driver batches
            # every in-flight id into one request — tcp_driver.poll — so the
            # per-id fallback would cost one cluster RPC per id); fetched
            # lazily so requests probing only leader ops / stale ids cost
            # zero admin round-trips
            moving: Optional[set] = None
            moving_fetched = False
            for eid in req.get("executionIds", ()):
                eid = int(eid)
                if eid in finished:
                    done.append(eid)
                    continue
                if eid not in pending:
                    continue  # unknown id (restarted driver): unfinished
                tp = pending[eid]
                if tp is not None and not moving_fetched:
                    moving = self._adapter.pending_reassignments()
                    moving_fetched = True
                if tp is None or (
                    tp not in moving
                    if moving is not None
                    else self._adapter.reassignment_done(*tp)
                ):
                    done.append(eid)
            with self._lock:
                for eid in done:
                    self._pending.pop(eid, None)
                    self._finished[eid] = True
                    self._finished.move_to_end(eid)
                while len(self._finished) > self.FINISHED_CAP:
                    self._finished.popitem(last=False)
            return {"ok": True, "finished": done}
        if op == "ongoing":
            return {"ok": True, "ongoing": self._adapter.any_ongoing()}
        if op == "metrics_publish":
            self._adapter.publish_metrics(list(req.get("records", ())))
            return {"ok": True}
        if op == "metrics_poll":
            records = self._adapter.poll_metrics(int(req.get("max", 10000)))
            return {"ok": True, "records": records}
        return {"ok": False, "error": f"unknown op {op!r}"}


def main(argv: Optional[List[str]] = None) -> None:  # pragma: no cover - needs a broker
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--bootstrap", required=True, help="Kafka bootstrap servers")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=9500)
    parser.add_argument("--metrics-topic", default="__CruiseControlMetrics")
    parser.add_argument("--tls-cert", help="PEM cert; enables TLS with --tls-key")
    parser.add_argument("--tls-key", help="PEM private key")
    args = parser.parse_args(argv)
    ssl_context = None
    if args.tls_cert:
        import ssl

        ssl_context = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ssl_context.load_cert_chain(args.tls_cert, args.tls_key)
    adapter = KafkaAdminAdapter(args.bootstrap, metrics_topic=args.metrics_topic)
    server = ClusterAgentServer(
        adapter, host=args.host, port=args.port, ssl_context=ssl_context
    )
    server.start()
    print(f"cluster agent serving on {server.address}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":  # pragma: no cover
    main()
