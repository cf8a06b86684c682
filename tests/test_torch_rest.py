"""The port's REST front end against the JAX package's: every case of
tests/test_rest.py and the server cases of tests/test_observability.py.

Both services are built from test_rest.py's recipe (a 6-broker simulated
cluster from seed 13, sampled for four 1 s windows on a scripted clock, the
executor on the simulator, the facade on the trimmed 5-goal default stack,
the port's optimizer on the CPU). The JAX service is served by its aiohttp
server, the port's by its standard-library server, and each is driven by its
own package's client through the same request sequence. Status codes,
`User-Task-ID` behaviour and the JSON bodies must be equal once
chip_smoke.py's `SERVED_VOLATILE` keys are taken out (`served_normalized`):
task ids, clock readings, durations, run ids and the sensor registry's
snapshots (process-wide timers and counts, which other tests in the same
process move). Tolerance: exact.

The unit cases of the user task manager, the session manager and the
purgatory run on both packages. The JAX stack compiles once for the module:
the replication-factor change, which makes a new shape, is the last case
that solves.
"""

import asyncio
import importlib
import json
import re
import socket
import sys
import threading
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import served_normalized as normalized  # noqa: E402

JAX, PORT = "cruise_control_tpu", "cruise_control_torch"
PACKAGES = (JAX, PORT)
DEFAULT_GOALS = ("RackAwareGoal", "ReplicaCapacityGoal", "DiskCapacityGoal",
                 "ReplicaDistributionGoal", "LeaderReplicaDistributionGoal")
@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors, several test processes: one intra-op thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _serve(pkg, app):
    """Serve `app` on loopback in the background: (url, stop)."""
    if pkg == PORT:
        handle = _m(PORT, "servlet.server").serve(app, "127.0.0.1", 0)
        return handle.url, handle.shutdown
    from aiohttp import web

    port = _free_port()
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(app.build_app())
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
        started.set()
        loop.run_forever()
        loop.run_until_complete(runner.cleanup())

    th = threading.Thread(target=run, daemon=True)
    th.start()
    assert started.wait(10)

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        th.join(timeout=5)

    return f"http://127.0.0.1:{port}", stop


#: test_rest.py's cluster: seed and generators.ClusterProperty fields
REST_CLUSTER = (13, dict(num_racks=3, num_brokers=6, num_topics=6, replication_factor=2))


def _stack(pkg, cluster=REST_CLUSTER, windows=4, optimizer=True, goals=DEFAULT_GOALS):
    """test_rest.py's stack in the package: a simulated cluster sampled for
    `windows` 1 s windows, the executor on the simulator, the facade (on the
    CPU in the port)."""
    gen, lm, fac, ex = (_m(pkg, n) for n in ("models.generators", "monitor.load_monitor",
                                              "facade", "executor"))
    truth = gen.random_cluster(cluster[0], gen.ClusterProperty(**cluster[1]))
    sim = _m(pkg, "testing.simulator").SimulatedCluster(truth)
    transport = _m(pkg, "reporter.transport").InMemoryTransport()
    clock = {"now": 0.0}
    monitor = lm.LoadMonitor(
        _m(pkg, "monitor.metadata").MetadataClient(sim.fetch_topology, ttl_s=0.0),
        _m(pkg, "monitor.sampler").TransportMetricSampler(transport),
        config=lm.LoadMonitorConfig(window_ms=1000, num_windows=3 if windows else 2,
                                    min_samples_per_window=1),
        clock=lambda: clock["now"])
    monitor.start_up()
    for r in range(windows):
        transport.publish(sim.all_metrics(r * 1000 + 500))
        clock["now"] = r + 0.8
        monitor.sample_once()
    executor = ex.Executor(ex.SimulatorClusterDriver(sim), load_monitor=monitor)
    opt = _m(pkg, "analyzer.optimizer")
    kw = {}
    if optimizer:
        fast = opt.OptimizerSettings(batch_k=16, max_rounds_per_goal=8, num_dst_candidates=3)
        kw["optimizer"] = opt.GoalOptimizer(settings=fast, **({"device": "cpu"} if pkg == PORT
                                                               else {}))
    config = dict(default_requirements=_m(pkg, "monitor.completeness")
                  .ModelCompletenessRequirements(1, 0.5, False))
    if goals:
        config["default_goal_names"] = goals
    facade = fac.CruiseControl(monitor, executor, config=fac.FacadeConfig(**config), **kw)
    return types.SimpleNamespace(pkg=pkg, sim=sim, monitor=monitor, facade=facade, clock=clock,
                                 acc=_m(pkg, "async_ops").AsyncCruiseControl(facade))


@pytest.fixture(scope="module")
def servers():
    out = {}
    for pkg in PACKAGES:
        s = _stack(pkg)
        s.detector = _m(pkg, "detector").AnomalyDetector(
            s.facade, notifier=_m(pkg, "detector").SelfHealingNotifier(),
            clock=lambda s=s: s.clock["now"])
        s.app = _m(pkg, "servlet.server").CruiseControlApp(s.acc, anomaly_detector=s.detector,
                                                           response_wait_s=0.2)
        s.url, s.stop = _serve(pkg, s.app)
        s.client = _m(pkg, "client.cccli").CruiseControlClient(s.url, poll_interval_s=0.1,
                                                               timeout_s=600)
        out[pkg] = s
    yield out
    for s in out.values():
        s.stop()
        s.acc.shutdown()


def _both(servers, fn):
    """fn(the package's server namespace) on the JAX service, then on the
    port's: the normalized results must be equal; returns the port's."""
    want = normalized(fn(servers[JAX]))
    got = normalized(fn(servers[PORT]))
    assert got == want
    return got


def _http(url, method="GET", headers=None):
    """(status, headers, body) of one request, errors included."""
    req = urllib.request.Request(url, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


def _assignment(s):
    return np.asarray(s.sim.model().assignment).tolist()


# -- test_rest.py's cases ------------------------------------------------------


def test_state_and_load_endpoints(servers):
    def run(s):
        c = s.client
        load = c.request("load")
        state = c.request("state")
        assert "LoadMonitor.cluster-model-creation-timer" in state["Sensors"]
        return [load, state, c.request("partition_load", {"resource": "NW_OUT", "entries": 5}),
                c.request("state", {"substates": "monitor,executor"})]

    load, state, pl, only = _both(servers, run)
    assert len(load["brokers"]) == 6 and load["version"] == 1 and "hosts" in load
    assert {"MonitorState", "ExecutorState", "AnalyzerState", "AnomalyDetectorState"} <= set(state)
    assert len(pl["records"]) == 5 and "topicPartition" in pl["records"][0]
    assert set(only) == {"MonitorState", "ExecutorState"}


def test_load_floats_equal_jax_bit_for_bit(servers):
    """/load's floats come from the JAX package's eager segment_sum and the
    port's K1 plain version: the JSON text itself must be equal."""
    bodies = [_http(servers[pkg].url + "/kafkacruisecontrol/load")[2] for pkg in PACKAGES]
    assert bodies[0] == bodies[1]


def test_rebalance_excluded_topics_and_destinations(servers):
    def run(s):
        c = s.client
        all_moves = c.request("rebalance", {"dryrun": "true", "ignore_proposal_cache": "true"})
        moved = sorted({p["topicPartition"].rpartition("-")[0] for p in all_moves["proposals"]})
        excluded = c.request("rebalance", {"dryrun": "true", "excluded_topics": moved[0]})
        dst = c.request("rebalance", {"dryrun": "true", "destination_broker_ids": "0,1"})
        return all_moves, moved, excluded, dst

    _, moved, excluded, dst = _both(servers, run)
    assert moved, "the fixture must produce at least one proposal"
    assert all(p["topicPartition"].rpartition("-")[0] != moved[0]
               for p in excluded["proposals"])
    for p in dst["proposals"]:
        assert set(p["newReplicas"]) - set(p["oldReplicas"]) <= {0, 1}, p


def test_kafka_cluster_state(servers):
    out = _both(servers, lambda s: s.client.request("kafka_cluster_state", {"verbose": "true"}))
    assert len(out["KafkaBrokerState"]) == 6 and out["KafkaPartitionState"]


def test_proposals_and_user_task_flow(servers):
    def run(s):
        out = s.client.request("proposals")
        tasks = s.client.request("user_tasks")["userTasks"]
        return out, sorted((t["RequestURL"], t["Status"], t["ClientIdentity"]) for t in tasks)

    out, tasks = _both(servers, run)
    assert {"goalSummary", "proposals", "summary"} <= set(out)
    assert any(t[0] == "proposals" for t in tasks)


def test_user_task_id_header_and_status_codes(servers):
    """The async contract on the wire: a long operation answers 202 with a
    User-Task-ID and its progress, polling with that id attaches to it and
    ends in 200 with the same id, an unknown id is a 404, a task over the
    manager's capacity a 429, a bad parameter a 400, an unknown path a 404
    and a known path under another method a 405 (aiohttp's own bodies)."""

    def run(s):
        app = s.app
        saved = app._wait_s
        app._wait_s = 0.0
        try:
            base = s.url + "/kafkacruisecontrol"
            status, headers, body = _http(base + "/rebalance?dryrun=true&ignore_proposal_cache="
                                          "true", "POST")
            tid = headers["User-Task-ID"]
            first = (status, sorted(json.loads(body)["progress"]))
            app._wait_s = 0.2
            while True:
                status, headers, body = _http(base + "/rebalance", "POST",
                                              {"User-Task-ID": tid})
                assert headers["User-Task-ID"] == tid
                if status != 202:
                    break
            done = (status, json.loads(body)["summary"]["numReplicaMovements"])
            unknown = _http(base + "/proposals", headers={"User-Task-ID": "no-such-task"})
            bad = _http(base + "/proposals?destination_broker_ids=a", "GET")
            trace = _http(s.url + "/trace?limit=nope")
            wrong_method = _http(base + "/rebalance", "GET")
            no_route = _http(base + "/no_such_endpoint")
            tasks_before = app._tasks
            app._tasks = _m(s.pkg, "servlet.user_tasks").UserTaskManager(max_active_tasks=0)
            try:
                full = _http(base + "/proposals")
            finally:
                app._tasks = tasks_before
        finally:
            app._wait_s = saved
        return [first, done] + [(st, b.decode(), h.get("Content-Type"))
                                for st, h, b in (unknown, bad, trace, wrong_method, no_route,
                                                 full)]

    out = _both(servers, run)
    assert out[0][0] == 202 and out[1][0] == 200
    assert [row[0] for row in out[2:]] == [404, 400, 400, 405, 404, 429]


def test_rebalance_dryrun_and_execute(servers):
    def run(s):
        c = s.client
        before = _assignment(s)
        dry = c.request("rebalance", {"dryrun": "true"})
        assert _assignment(s) == before
        out = c.request("rebalance", {"dryrun": "false", "ignore_proposal_cache": "true"})
        return dry, out, _assignment(s)

    dry, out, _ = _both(servers, run)
    assert "numReplicaMovements" in dry["summary"] and dry["version"] == 1
    assert {g["status"] for g in dry["goalSummary"]} <= {"VIOLATED", "FIXED", "NO-ACTION"}
    assert {"Host", "Broker", "BrokerState", "DiskMB", "CpuPct"} <= set(
        dry["loadBeforeOptimization"]["brokers"][0])
    assert "numReplicaMovements" in out["summary"]


def test_sampling_pause_resume_and_admin(servers):
    def run(s):
        c = s.client
        out = [c.request("pause_sampling", {"reason": "test"}), s.facade._monitor.sampling_paused]
        out += [c.request("resume_sampling"), s.facade._monitor.sampling_paused]
        out += [c.request("admin", {"concurrent_partition_movements_per_broker": "3"}),
                c.request("admin", {"disable_self_healing_for": "goal_violation"}),
                c.request("admin")]
        return out

    out = _both(servers, run)
    assert out[1] is True and out[3] is False
    assert out[4]["concurrencyUpdated"] and out[5]["selfHealing:goal_violation"] is False


def test_train_and_bootstrap(servers):
    def run(s):
        c = s.client
        return [c.request("train"), c.request("bootstrap"),
                c.request("bootstrap", {"start": "0", "end": "1"})]

    train, boot, ranged = _both(servers, run)
    assert train["observations_added"] > 0 and train["state"] == "RUNNING"
    assert "bootstrappedSamples" in boot and ranged["bootstrappedSamples"] == 0


def test_cli_main_and_errors(servers, capsys):
    def run(s):
        main = _m(s.pkg, "client.cccli").main
        rc = main(["-a", s.url, "state"])
        state_out = capsys.readouterr().out
        bad = main(["-a", s.url, "proposals", "--goals", "NoSuchGoal"])
        bad_out = capsys.readouterr().out
        return rc, "MonitorState" in state_out, bad, bad_out

    assert _both(servers, run)[:3] == [0, True, 1]


def test_two_step_verification_gate(servers):
    """A reviewable POST parks in purgatory until approved."""

    def run(s):
        acc = _m(s.pkg, "async_ops").AsyncCruiseControl(s.facade)
        app = _m(s.pkg, "servlet.server").CruiseControlApp(acc, two_step_verification=True,
                                                           response_wait_s=0.2)
        url, stop = _serve(s.pkg, app)
        try:
            c = _m(s.pkg, "client.cccli").CruiseControlClient(url, poll_interval_s=0.1)
            parked = c.request("rebalance", {"dryrun": "true"})
            board = c.request("review_board")
            reviewed = c.request("review", {"approve": str(parked["reviewId"])})
            out = c.request("rebalance", {"dryrun": "true", "review_id": str(parked["reviewId"])})
            again = c.request("rebalance", {"dryrun": "true",
                                            "review_id": str(parked["reviewId"])})
            return parked, board, reviewed, out, again
        finally:
            stop()
            acc.shutdown()

    parked, board, _, out, again = _both(servers, run)
    assert parked["status"] == "PENDING_REVIEW"
    assert board["RequestInfo"][0]["Status"] == "PENDING_REVIEW"
    assert "numReplicaMovements" in out["summary"] and "errorMessage" in again


def test_topic_configuration_rf_change(servers):
    """The last case that solves: raising topic-0's replication factor makes
    a new shape (a second JAX compile for anything after it)."""

    def run(s):
        out = s.client.request("topic_configuration", {"topic": "topic-0",
                                                       "replication_factor": "3",
                                                       "dryrun": "false"})
        return out, _assignment(s)

    out, after = _both(servers, run)
    assert out["replicationFactor"] == 3
    topo = servers[PORT].sim.fetch_topology()
    for p in range(topo.num_partitions):
        if topo.topic_id[p] == 0:
            assert (np.asarray(after[p]) >= 0).sum() == 3


def test_static_webui_serving(tmp_path):
    """webserver.ui.diskpath: static files next to the API prefix, with the
    index at "/", traversal and missing files refused, and the same files
    under a non-root prefix."""
    (tmp_path / "index.html").write_text("<html>cc-ui</html>")
    (tmp_path / "app.js").write_text("console.log('ui')")

    class _Stub:
        facade = None

    def run(pkg, prefix):
        app = _m(pkg, "servlet.server").CruiseControlApp(_Stub(), webui_dir=str(tmp_path),
                                                         webui_prefix=prefix)
        url, stop = _serve(pkg, app)
        try:
            paths = (["/", "/app.js", "/missing.css"] if prefix == "/" else
                     ["/ui/app.js", "/ui/index.html", "/ui/missing.css"])
            out = [(p, *_http(url + p)[::2]) for p in paths]
            traversal = _http(url + "/../etc/passwd")[0]
        finally:
            stop()
        return out, traversal

    for prefix in ("/", "/ui"):
        (rows, traversal), (jrows, jtraversal) = run(PORT, prefix), run(JAX, prefix)
        assert [(p, st) for p, st, _ in rows] == [(p, st) for p, st, _ in jrows]
        assert [b for _, st, b in rows if st == 200] == [b for _, st, b in jrows if st == 200]
        assert traversal in (403, 404) and jtraversal in (403, 404)
    assert b"cc-ui" in rows[1][2]


def test_model_completeness_failure_is_typed_503_over_live_server():
    """A monitor short on windows answers a typed 503 with a `completeness`
    block, on the async path (/proposals) and the direct path (/load)."""

    def run(pkg):
        s = _stack(pkg, (5, dict(num_racks=2, num_brokers=4, num_topics=3, replication_factor=2)),
                   windows=0, optimizer=False, goals=None)
        app = _m(pkg, "servlet.server").CruiseControlApp(s.acc, response_wait_s=2.0)
        url, stop = _serve(pkg, app)
        try:
            out = []
            for endpoint in ("proposals", "load"):
                status, headers, body = _http(f"{url}/kafkacruisecontrol/{endpoint}")
                out.append((status, json.loads(body), headers.get("Content-Type")))
            return normalized(out)
        finally:
            stop()
            s.acc.shutdown()

    out = run(PORT)
    assert out == run(JAX)
    for status, body, _ in out:
        assert status == 503 and body["errorClass"] == "NotEnoughValidWindowsError"
        assert body["completeness"]["validWindows"] == 0 and "errorMessage" in body


# -- the user task manager, the session manager and the purgatory --------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_user_task_manager_semantics(pkg):
    ut, OperationFuture = _m(pkg, "servlet.user_tasks"), _m(pkg, "async_ops").OperationFuture
    now = {"t": 0.0}
    ids = iter(f"id-{i}" for i in range(100))
    mgr = ut.UserTaskManager(max_active_tasks=2, completed_retention_s=10.0,
                             clock=lambda: now["t"], uuid_factory=lambda: next(ids))

    def make():
        return OperationFuture("op")

    t1, f1 = mgr.get_or_create_task("proposals", make, session_key="s1")
    t2, f2 = mgr.get_or_create_task("proposals", make, session_key="s1")
    assert t1 == t2 and f1 is f2
    assert mgr.get_or_create_task("proposals", make, user_task_id=t1)[1] is f1
    with pytest.raises(KeyError):
        mgr.get_or_create_task("proposals", make, user_task_id="nope")
    mgr.get_or_create_task("rebalance", make, session_key="s2")
    with pytest.raises(RuntimeError, match="active"):
        mgr.get_or_create_task("load", make, session_key="s3")
    f1.set_result(1)
    now["t"] = 100.0
    mgr.get_or_create_task("load", make, session_key="s3")
    assert all(t["UserTaskId"] != t1 for t in mgr.describe_all())
    assert [t["UserTaskId"] for t in mgr.describe_all()] == ["id-1", "id-2"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_session_manager_capacity_checked_before_launch(pkg):
    ut, OperationFuture = _m(pkg, "servlet.user_tasks"), _m(pkg, "async_ops").OperationFuture
    now = {"t": 0.0}
    sessions = ut.SessionManager(max_sessions=2, session_expiry_s=50.0, clock=lambda: now["t"])
    launched = []

    def make():
        launched.append(1)
        return OperationFuture("op")

    mgr = ut.UserTaskManager(clock=lambda: now["t"], session_manager=sessions)
    _, f1 = mgr.get_or_create_task("proposals", make, session_key="c1")
    _, f2 = mgr.get_or_create_task("proposals", make, session_key="c2")
    with pytest.raises(RuntimeError, match="sessions"):
        mgr.get_or_create_task("proposals", make, session_key="c3")
    assert len(launched) == 2, "a rejected request must start no work"
    now["t"] = 100.0
    with pytest.raises(RuntimeError, match="sessions"):
        mgr.get_or_create_task("proposals", make, session_key="c3")
    f1.set_result(1)
    f2.set_result(1)
    mgr.get_or_create_task("proposals", make, session_key="c3")
    assert len(launched) == 3


@pytest.mark.parametrize("pkg", PACKAGES)
def test_purgatory_two_step_flow(pkg):
    pg = _m(pkg, "servlet.purgatory")
    purgatory = pg.Purgatory(clock=lambda: 1000.0)
    rid = purgatory.add_request("rebalance", {"dryrun": "false"})
    assert purgatory.review_board()["RequestInfo"][0]["Status"] == "PENDING_REVIEW"
    with pytest.raises(ValueError, match="not APPROVED"):
        purgatory.submit(rid)
    purgatory.apply_review([rid], [])
    assert purgatory.submit(rid)["status"] == pg.ReviewStatus.SUBMITTED
    with pytest.raises(ValueError):
        purgatory.submit(rid)
    rid2 = purgatory.add_request("admin", {})
    board = purgatory.apply_review([], [rid2], reason="nope")
    assert board["RequestInfo"][-1]["Status"] == "DISCARDED"
    assert board == _m(JAX, "servlet.purgatory").Purgatory.review_board(purgatory)


# -- test_observability.py's server cases ---------------------------------------


def _parse_prometheus(text):
    """{metric: type}, [(metric, labels, value)] of a Prometheus text page."""
    types_, samples = {}, []
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            types_[name] = kind
        elif line and not line.startswith("#"):
            m = re.match(r"^([a-zA-Z_:][\w:]*)(\{(.*)\})? (\S+)$", line)
            assert m, line
            labels = dict(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"', m.group(3) or ""))
            samples.append((m.group(1), labels, float(m.group(4))))
    return types_, samples


def test_metrics_endpoint_serves_prometheus(servers):
    s = servers[PORT]
    s.monitor.cluster_model()
    for path in ("/metrics", "/kafkacruisecontrol/metrics"):
        status, headers, body = _http(s.url + path)
        jstatus, jheaders, _ = _http(servers[JAX].url + path)
        assert (status, headers["Content-Type"]) == (jstatus, jheaders["Content-Type"]) == (
            200, "text/plain; version=0.0.4; charset=utf-8")
        kinds, samples = _parse_prometheus(body.decode())
        assert kinds["cruise_control_latency_seconds"] == "histogram"
        sensors = {labels.get("sensor") for _, labels, _ in samples}
        assert {"LoadMonitor.cluster-model-creation-timer", "GoalOptimizer.program-cache-size",
                "DeviceTelemetry.device-memory", "DeviceTelemetry.overhead-seconds"} <= sensors


def test_trace_endpoint_shape_and_filters(servers):
    s = servers[PORT]
    s.monitor.cluster_model()
    status, _, body = _http(s.url + "/trace?limit=50")
    payload = json.loads(body)
    jpayload = json.loads(_http(servers[JAX].url + "/trace?limit=50")[2])
    assert status == 200 and set(payload) == set(jpayload)
    assert isinstance(payload["overheadS"], float) and payload["version"] == 1
    assert set(payload["spans"][0]) == set(jpayload["spans"][0]) >= {
        "name", "kind", "traceId", "spanId", "parentId", "startUnixS", "durationS",
        "attributes", "error"}
    assert set(payload["summary"]["monitor"]) == set(jpayload["summary"]["monitor"])
    filtered = json.loads(_http(s.url + "/trace?kind=monitor&limit=5")[2])["spans"]
    assert filtered and all(sp["kind"] == "monitor" for sp in filtered)
    tid = filtered[0]["traceId"]
    spans = json.loads(_http(s.url + f"/trace?trace_id={tid}&limit=50")[2])["spans"]
    assert spans and all(sp["traceId"] == tid for sp in spans)


def test_state_survives_raising_gauge(servers):
    from cruise_control_torch.common.sensors import REGISTRY

    REGISTRY.gauge("test.raising-gauge", lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    try:
        status, _, body = _http(servers[PORT].url + "/kafkacruisecontrol/state")
        sensors = json.loads(body)["Sensors"]
        assert status == 200 and sensors["test.raising-gauge"] == {"error": "RuntimeError: boom"}
        assert "Tracer.spans-recorded" in sensors
    finally:
        REGISTRY._gauges.pop("test.raising-gauge", None)


def test_timeseries_endpoint_serves_real_data(servers):
    s = servers[PORT]
    s.monitor.cluster_model()
    for path in ("/timeseries", "/kafkacruisecontrol/timeseries"):
        status, _, body = _http(s.url + path)
        payload = json.loads(body)
        assert status == 200 and payload["version"] == 1
        assert payload["history"]["points"] >= 1 and payload["query"]
    payload = json.loads(_http(s.url + "/timeseries?name=LoadMonitor.*&window=3600&limit=5")[2])
    assert payload["query"] and all(n.startswith("LoadMonitor.") for n in payload["query"])
    name, stats = next(iter(payload["query"].items()))
    assert {"n", "first", "last", "delta", "ratePerS", "p50", "p95"} <= set(stats)
    assert stats["n"] >= 2 and len(payload["series"][name][0]) == 2
    payload = json.loads(_http(s.url + "/timeseries?kind=Tracer&limit=3")[2])
    assert all(n.startswith("Tracer.") for n in payload["query"])
    assert _http(s.url + "/timeseries?window=nope")[0] == 400


def test_perf_endpoint_joins_telemetry(servers):
    """/perf on the CPU: the fingerprint (torch and CUDA in place of jax and
    jaxlib), the RSS memory watermark, the transfer meters the solves above
    marked, and a program row joined with its bucket's build histogram; the
    top-level keys are the JAX endpoint's."""
    from cruise_control_torch.common.sensors import REGISTRY
    from cruise_control_torch.common.telemetry import TELEMETRY
    from cruise_control_torch.kernels.build import BuildRecord

    TELEMETRY.record_program("test-join", "Ptest-B1-T1-RF1", BuildRecord("k", 0.5, True))
    REGISTRY.histogram("GoalOptimizer.stack-compile-timer.bucket.Ptest-B1-T1-RF1").record(0.5)
    jpayload = json.loads(_http(servers[JAX].url + "/perf")[2])
    for path in ("/perf", "/kafkacruisecontrol/perf"):
        status, _, body = _http(servers[PORT].url + path)
        payload = json.loads(body)
        assert status == 200 and set(payload) == set(jpayload)
        fp = payload["fingerprint"]
        assert set(fp) - {"torch", "cuda"} == set(jpayload["fingerprint"]) - {"jax", "jaxlib"}
        assert fp["platform"] == "cpu" and fp["probeFallback"] is False
        assert fp["torch"] == torch.__version__
        assert payload["memory"]["bytesInUse"] > 0 and payload["memory"]["fallback"] == 1
        assert set(payload["transfers"]) == set(jpayload["transfers"])
        assert payload["transfers"]["hostToDeviceBytes"] > 0
        assert payload["transfers"]["deviceToHostBytes"] > 0
        [row] = [p for p in payload["programs"] if p["program"] == "test-join"]
        assert row["costAvailable"] is False and row["built"] is True
        assert row["compile"]["count"] >= 1
        assert set(payload["timers"]) == set(jpayload["timers"])
    from cruise_control_torch.common.tracing import TRACER

    assert {"perf", "timeseries"} <= {sp["kind"] for sp in TRACER.recent(limit=50)}


def test_detector_sweep_emits_span(servers):
    from cruise_control_torch.common.tracing import TRACER
    from cruise_control_torch.detector import AnomalyDetector, SelfHealingNotifier

    class _Quiet:
        def detect(self):
            return None

    class _QuietList:
        def detect(self):
            return []

    det = AnomalyDetector(servers[PORT].facade, notifier=SelfHealingNotifier(),
                          goal_violation_detector=_Quiet(), broker_failure_detector=_Quiet(),
                          metric_anomaly_detector=_QuietList())
    det.detect_once()
    sweeps = [sp for sp in TRACER.recent(limit=20, kind="detector")
              if sp["name"] == "anomaly-sweep"]
    assert sweeps and sweeps[0]["attributes"]["anomalies"] == 0
