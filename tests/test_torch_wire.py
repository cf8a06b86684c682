"""The cluster agent's wire in the port against the JAX package's: the TCP
driver and the metrics transport over a real socket to the fake agent (with
TLS, pinned certificates, and plaintext and untrusted clients refused), the
production agent's protocol bookkeeping on a recording adapter, the
executor's lifecycle over the wire, and the resilience cases that inject
faults through a FaultPlan (a flaky agent, a rejection, a dead agent, a
movement that never finishes) and the plan's own contract. Each case runs in
both packages on the same inputs; what a run decides (the execution
summary's counts, states, reasons and trims, the cluster afterwards, the
protocol's responses, the faults fired) must be equal. Execution ids and
times are left out. Tolerance: exact.
"""

import importlib
import socket
import ssl
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

JAX, PORT = "cruise_control_tpu", "cruise_control_torch"
MODULES = {"gen": "models.generators", "proposals": "analyzer.proposals",
           "executor": "executor", "tcp": "executor.tcp_driver",
           "agent": "testing.fake_agent", "faults": "testing.faults",
           "sim": "testing.simulator", "retry": "common.retry", "sensors": "common.sensors",
           "kafka_agent": "executor.kafka_agent", "transport": "reporter.transport"}


def _pkg(pkg):
    return types.SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{m}")
                                    for k, m in MODULES.items()})


def _both(fn, *args):
    """fn(package namespace, *args) in the JAX package, then in the port:
    the two results must be equal; returns the port's."""
    want = fn(_pkg(JAX), *args)
    got = fn(_pkg(PORT), *args)
    assert got == want
    return got


def _proposal(ns, p, old, new, mb=0.0):
    return ns.proposals.ExecutionProposal(partition=p, old_replicas=old, new_replicas=new,
                                          data_to_move_mb=mb)


def _record(summary, sim):
    return chip_smoke.execution_record(summary, np.asarray(sim.fetch_topology().assignment))


def _meter(ns, name):
    return ns.sensors.REGISTRY.meter(name).count


# -- TLS on the agent socket ---------------------------------------------------


def _self_signed(d: Path, stem: str):
    cert, key = str(d / f"{stem}.pem"), str(d / f"{stem}.key")
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes", "-keyout", key,
                    "-out", cert, "-days", "1", "-subj", "/CN=localhost", "-addext",
                    "subjectAltName=IP:127.0.0.1,DNS:localhost"], check=True,
                   capture_output=True)
    return cert, key


@pytest.fixture(scope="module")
def cert_pair(tmp_path_factory):
    """A self-signed server certificate and key (its SAN covers 127.0.0.1)."""
    return _self_signed(tmp_path_factory.mktemp("tls"), "cert")


def _server_ctx(cert_pair):
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(*cert_pair)
    return ctx


def _pinned_client_ctx(cert_pair):
    """Trusts exactly the agent's own certificate."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.load_verify_locations(cert_pair[0])
    ctx.verify_mode = ssl.CERT_REQUIRED
    ctx.check_hostname = True
    return ctx


def test_executor_and_metrics_over_tls(cert_pair):
    def run(ns):
        sim = ns.sim.SimulatedCluster(ns.gen.unbalanced())
        agent = ns.agent.FakeClusterAgent(sim, latency_polls=1,
                                          ssl_context=_server_ctx(cert_pair)).start()
        try:
            driver = ns.tcp.TcpClusterDriver(*agent.address,
                                             ssl_context=_pinned_client_ctx(cert_pair))
            summary = ns.executor.Executor(driver).execute_proposals(
                [_proposal(ns, 0, (0, 1), (2, 1), mb=5.0)])
            transport = ns.transport.TcpMetricsTransport(
                *agent.address, ssl_context=_pinned_client_ctx(cert_pair))
            metrics = sim.all_metrics(1000)
            transport.publish(metrics)
            polled = transport.poll()
            transport.close()
            driver.close()
        finally:
            agent.stop()
        return (_record(summary, sim), sim.has_partition(0, 2), sim.has_partition(0, 0),
                len(polled), len(metrics))

    rec, on_dst, on_src, polled, sent = _both(run)
    assert rec["numFinishedMovements"] == 1 and on_dst and not on_src
    assert polled == sent > 0


def test_plaintext_client_rejected_by_tls_agent(cert_pair):
    def run(ns):
        agent = ns.agent.FakeClusterAgent(ns.sim.SimulatedCluster(ns.gen.unbalanced()),
                                          ssl_context=_server_ctx(cert_pair)).start()
        try:
            client = ns.tcp._LineClient(*agent.address, timeout_s=2.0)
            with pytest.raises((OSError, ConnectionError)):
                client.request({"op": "ping"})
            client.close()
        finally:
            agent.stop()
        return True

    _both(run)


def test_untrusted_cert_rejected(cert_pair, tmp_path):
    """A client pinned to another certificate refuses the handshake."""
    other = _self_signed(tmp_path, "other")

    def run(ns):
        agent = ns.agent.FakeClusterAgent(ns.sim.SimulatedCluster(ns.gen.unbalanced()),
                                          ssl_context=_server_ctx(cert_pair)).start()
        try:
            client = ns.tcp._LineClient(*agent.address, timeout_s=2.0,
                                        ssl_context=_pinned_client_ctx(other))
            with pytest.raises((ssl.SSLError, OSError)):
                client.request({"op": "ping"})
            client.close()
        finally:
            agent.stop()
        return True

    _both(run)


# -- the production agent's protocol bookkeeping (no broker needed) -----------


def _recording_adapter(ns, latency=1):
    """An in-memory AdminAdapter of the package: a reassignment completes
    after `latency` done-probes."""

    class RecordingAdapter(ns.kafka_agent.AdminAdapter):
        def __init__(self):
            self.calls = []
            self._probes = {}
            self._records = []

        def begin_reassignment(self, topic, partition, replicas):
            self.calls.append(("reassign", topic, partition, tuple(replicas)))
            self._probes[(topic, partition)] = latency

        def elect_leader(self, topic, partition, leader):
            self.calls.append(("leader", topic, partition, leader))

        def reassignment_done(self, topic, partition):
            left = self._probes.get((topic, partition), 0)
            if left > 0:
                self._probes[(topic, partition)] = left - 1
                return False
            self._probes.pop((topic, partition), None)
            return True

        def any_ongoing(self):
            return bool(self._probes)

        def publish_metrics(self, records):
            self._records.extend(records)

        def poll_metrics(self, max_records):
            out, self._records = self._records[:max_records], self._records[max_records:]
            return out

    return RecordingAdapter()


def _agent_server_exchange(ns, requests):
    """The responses of a ClusterAgentServer on a recording adapter to
    `requests`, and the adapter's calls."""
    adapter = _recording_adapter(ns)
    server = ns.kafka_agent.ClusterAgentServer(adapter).start()
    client = ns.tcp._LineClient(*server.address)
    try:
        responses = [client.request(r) for r in requests]
    finally:
        client.close()
        server.stop()
    return responses, adapter.calls


def test_cluster_agent_server_protocol():
    requests = [{"op": "ping"},
                {"op": "reassign", "executionId": 7, "topic": "t", "partition": 3,
                 "replicas": [2, 1]},
                {"op": "ongoing"}] + [{"op": "finished", "executionIds": [7]}] * 3 + [
                {"op": "finished", "executionIds": [99]}]
    responses, calls = _both(_agent_server_exchange, requests)
    assert calls == [("reassign", "t", 3, (2, 1))]
    assert responses[0]["ok"] and responses[2]["ongoing"]
    # still moving, then done and sticky until read; an unknown id never is
    assert [r["finished"] for r in responses[3:]] == [[], [7], [7], []]


def test_cluster_agent_server_leader_and_metrics():
    requests = [{"op": "leader", "executionId": 11, "topic": "t", "partition": 0, "leader": 4},
                {"op": "finished", "executionIds": [11]},
                {"op": "metrics_publish", "records": ["0a0b", "0c"]},
                {"op": "metrics_poll", "max": 10}, {"op": "metrics_poll", "max": 10}]
    responses, calls = _both(_agent_server_exchange, requests)
    assert calls == [("leader", "t", 0, 4)]
    assert responses[1]["finished"] == [11]
    assert responses[3]["records"] == ["0a0b", "0c"] and responses[4]["records"] == []


# -- the executor over a real socket to the fake agent -------------------------


def _agent_stack(ns, latency_polls=2):
    sim = ns.sim.SimulatedCluster(ns.gen.unbalanced())
    agent = ns.agent.FakeClusterAgent(sim, latency_polls=latency_polls).start()
    return sim, agent, ns.tcp.TcpClusterDriver(*agent.address)


def test_executor_end_to_end_over_tcp():
    def run(ns):
        sim, agent, driver = _agent_stack(ns)
        try:
            execu = ns.executor.Executor(driver)
            summary = execu.execute_proposals([_proposal(ns, 0, (0, 1), (2, 1), mb=5.0),
                                               _proposal(ns, 2, (0, 2), (2, 0))])
            ongoing = driver.has_ongoing_reassignment()
        finally:
            driver.close()
            agent.stop()
        return (_record(summary, sim), sim.has_partition(0, 2), sim.has_partition(0, 0),
                sim.leader_of(2), execu.state, ongoing)

    rec, on_dst, on_src, leader, state, ongoing = _both(run)
    assert rec["numFinishedMovements"] == 2 and not rec["stopped"]
    assert on_dst and not on_src and leader == 2
    assert state == "NO_TASK_IN_PROGRESS" and not ongoing


def test_executor_refuses_over_ongoing_agent_reassignment():
    def run(ns):
        sim, agent, driver = _agent_stack(ns)
        try:
            task = ns.executor.ExecutionTask(999, _proposal(ns, 1, (0, 1), (2, 1)),
                                             ns.executor.TaskType.INTER_BROKER_REPLICA_ACTION)
            driver.start_replica_movement(task)
            ongoing = driver.has_ongoing_reassignment()
            with pytest.raises(RuntimeError, match="ongoing") as err:
                ns.executor.Executor(driver).execute_proposals(
                    [_proposal(ns, 0, (0, 1), (2, 1))])
        finally:
            driver.close()
            agent.stop()
        return ongoing, str(err.value)

    ongoing, _ = _both(run)
    assert ongoing


def test_metrics_transport_over_tcp():
    """The reporter publishes through the agent's socket and the sampler
    polls the same stream back, consumed at most once."""
    def run(ns):
        sim, agent, driver = _agent_stack(ns)
        try:
            transport = ns.transport.TcpMetricsTransport(*agent.address)
            metrics = sim.all_metrics(1000)
            transport.publish(metrics)
            got, again = transport.poll(), transport.poll()
            transport.close()
        finally:
            driver.close()
            agent.stop()
        return ([(int(m.metric_type), m.broker_id, m.time_ms, m.value) for m in got],
                [(int(m.metric_type), m.broker_id, m.time_ms, m.value) for m in metrics],
                again)

    got, sent, again = _both(run)
    assert got == sent and len(got) > 0 and again == []


def test_driver_protocol_errors_and_unknown_ids():
    def run(ns):
        sim, agent, driver = _agent_stack(ns)
        try:
            ghost = ns.executor.ExecutionTask(123456, _proposal(ns, 0, (0, 1), (2, 1)),
                                              ns.executor.TaskType.INTER_BROKER_REPLICA_ACTION)
            finished = driver.is_finished(ghost)
            with pytest.raises(ns.tcp.AgentProtocolError) as err:
                driver._client.request({"op": "definitely-not-an-op"})
        finally:
            driver.close()
            agent.stop()
        return finished, str(err.value)

    finished, error = _both(run)
    assert not finished and "unknown op" in error


# -- resilience: faults injected on the wire -----------------------------------


def _tcp_setup(ns, faults=None, latency_polls=1, attempts=4, deadline_s=0.0):
    sim = ns.sim.SimulatedCluster(ns.gen.unbalanced())
    agent = ns.agent.FakeClusterAgent(sim, latency_polls=latency_polls,
                                      fault_plan=faults).start()
    driver = ns.tcp.TcpClusterDriver(*agent.address, timeout_s=2.0,
                                     retry_policy=ns.retry.RetryPolicy(
                                         max_attempts=attempts, backoff_s=0.001,
                                         max_backoff_s=0.005))
    events = []
    execu = ns.executor.Executor(
        driver, config=ns.executor.ExecutorConfig(execution_progress_check_interval_s=0.01,
                                                  task_deadline_s=deadline_s,
                                                  max_execution_polls=100_000),
        notifier=lambda event, info: events.append(event))
    return sim, agent, execu, events


def _faulted_run(ns, rules, proposals, deadline_s=0.0):
    """An execution over the wire under a FaultPlan of `rules`: (the
    record, the faults fired, the failed tasks' states and reasons, the
    events by name, the executor's state afterwards)."""
    faults = ns.faults.FaultPlan([ns.faults.FaultRule(**r) for r in rules])
    sim, agent, execu, events = _tcp_setup(ns, faults=faults, deadline_s=deadline_s)
    try:
        summary = execu.execute_proposals([_proposal(ns, *p) for p in proposals])
    finally:
        agent.stop()
    failed = [(f["state"], f["reason"]) for f in summary["failedTasks"]]
    return (_record(summary, sim), faults.fired, failed, sorted(set(events)), execu.state,
            sim.has_partition(0, 2), sim.has_partition(0, 0))


def test_flaky_agent_execution_completes_with_retries():
    rules = [dict(op="reassign", action="drop", times=2),
             dict(op="finished", action="drop", times=1)]
    retries = {}

    def run(ns):
        before = _meter(ns, "Retry.TcpDriver.reassign.retries")
        out = _faulted_run(ns, rules, [(0, (0, 1), (2, 1)), (2, (0, 2), (2, 0))])
        retries[ns.gen.__name__] = _meter(ns, "Retry.TcpDriver.reassign.retries") - before
        return out

    rec, fired, failed, _, state, on_dst, on_src = _both(run)
    assert rec["byState"]["COMPLETED"] == 2 and rec["byState"]["DEAD"] == 0 and failed == []
    assert on_dst and not on_src and state == "NO_TASK_IN_PROGRESS"
    assert any(f["action"] == "drop" for f in fired)
    assert retries[f"{PORT}.models.generators"] == retries[f"{JAX}.models.generators"] > 0


def test_agent_rejection_kills_only_that_task():
    """A rejection is not retried and kills only the rejected task."""
    rules = [dict(op="reassign", action="fail", times=1, error="quota exceeded")]
    rec, _, failed, events, state, _, _ = _both(
        _faulted_run, rules, [(0, (0, 1), (2, 1)), (1, (0, 2), (1, 2))])
    assert rec["byState"]["DEAD"] == 1 and rec["byState"]["COMPLETED"] == 1
    ((fstate, reason),) = failed
    assert fstate == "DEAD" and "dispatch failure" in reason
    assert state == "NO_TASK_IN_PROGRESS" and "task_dead" in events


def test_dead_agent_returns_all_dead_summary():
    """No agent listens: execute_proposals never raises, every task dies."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    def run(ns):
        driver = ns.tcp.TcpClusterDriver("127.0.0.1", port, timeout_s=0.2,
                                         retry_policy=ns.retry.RetryPolicy(max_attempts=2,
                                                                           backoff_s=0.001))
        events = []
        execu = ns.executor.Executor(
            driver, config=ns.executor.ExecutorConfig(execution_progress_check_interval_s=0.005,
                                                      max_consecutive_driver_failures=2),
            notifier=lambda event, info: events.append(event))
        summary = execu.execute_proposals([_proposal(ns, 0, (0, 1), (2, 1)),
                                           _proposal(ns, 2, (0, 2), (2, 0))])
        return ({k: summary[k] for k in ("byState", "numFinishedMovements",
                                         "numTotalMovements")},
                [f["state"] for f in summary["failedTasks"]], events.count("task_dead"),
                execu.state)

    counts, states, dead_events, state = _both(run)
    assert counts["byState"]["DEAD"] == 2
    assert counts["numFinishedMovements"] == counts["numTotalMovements"] == 2
    assert states == ["DEAD", "DEAD"] and dead_events == 2 and state == "NO_TASK_IN_PROGRESS"


def test_never_finishing_task_hits_deadline_others_complete():
    rules = [dict(op="reassign", action="never_finish", times=1, partition=0)]
    rec, _, failed, events, state, _, _ = _both(
        _faulted_run, rules, [(0, (0, 1), (2, 1)), (1, (0, 2), (1, 2)), (2, (0, 2), (2, 0))],
        0.15)
    assert rec["byState"]["ABORTED"] == 1 and rec["byState"]["COMPLETED"] == 2
    ((fstate, reason),) = failed
    assert fstate == "ABORTED" and "deadline" in reason
    assert "task_aborted" in events and state == "NO_TASK_IN_PROGRESS"


def test_fault_plan_rules_consume_deterministically():
    def run(ns):
        plan = ns.faults.FaultPlan([ns.faults.FaultRule(op="reassign", action="fail", times=2)])
        out = [plan.server_intercept({"op": op})
               for op in ("reassign", "finished", "reassign", "reassign")]
        return out, plan.fired

    out, fired = _both(run)
    assert [o if o is None else o["ok"] for o in out] == [False, None, False, None]
    assert [f["action"] for f in fired] == ["fail", "fail"]


def test_fault_plan_client_drop_and_partition_match():
    def run(ns):
        plan = ns.faults.FaultPlan([
            ns.faults.FaultRule(op="reassign", action="never_finish", partition=3, times=-1),
            ns.faults.FaultRule(op="*", action="drop", times=1)])
        hung = [plan.never_finishes({"op": "reassign", "partition": p}) for p in (1, 3, 3)]
        with pytest.raises(ConnectionError):
            plan.client_intercept({"op": "ping"})
        plan.client_intercept({"op": "ping"})  # the drop is used up
        return hung, plan.fired

    hung, _ = _both(run)
    assert hung == [False, True, True]
