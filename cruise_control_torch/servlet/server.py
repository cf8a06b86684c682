"""HTTP server: the 19-endpoint REST surface, on the standard library.

The JAX package's servlet/server.py (the analog of KafkaCruiseControlServlet,
cc/servlet/KafkaCruiseControlServlet.java:76, and KafkaCruiseControlMain's
Jetty bootstrap) serves on aiohttp. The port serves the same wire contract on
`http.server.ThreadingHTTPServer`, one thread a connection, so it needs no
package beyond the standard library:

  GET  state, load, partition_load, proposals, kafka_cluster_state,
       user_tasks, review_board, bootstrap, train,
       metrics, trace, timeseries, perf, explain
       (also at root /metrics, /trace, /timeseries, /perf and /explain)
  POST rebalance, add_broker, remove_broker, demote_broker,
       stop_proposal_execution, pause_sampling, resume_sampling,
       topic_configuration, admin, review

The routes, status codes (200; 202 with the `User-Task-ID` header and
`progress`; 400, 404, 429, the typed 503 for model completeness, 500),
the `response_wait_s` budget, two-step verification, static web-UI serving,
the NCSA access log and the JSON bodies are the JAX server's. What aiohttp
answers by itself is answered the same way: an unknown path is a 404 and a
known path under another method a 405, each with aiohttp's text body.
Handlers that run on aiohttp's event loop, or off it in a worker thread,
run here on the connection's thread. A solve behind /load's broker loads
runs on the service's device (the facade's optimizer's: the card unless the
service was built for the CPU).
"""

from __future__ import annotations

import datetime
import http.server
import json
import logging
import os
import threading
import time
import urllib.parse
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from cruise_control_torch.async_ops import AsyncCruiseControl
from cruise_control_torch.common.resources import BrokerState, PartMetric, Resource
from cruise_control_torch.facade import IllegalRequestException
from cruise_control_torch.servlet.purgatory import Purgatory
from cruise_control_torch.servlet.user_tasks import UserTaskManager

PREFIX = "/kafkacruisecontrol"

#: POST endpoints subject to 2-step verification when enabled
REVIEWABLE = {
    "rebalance", "add_broker", "remove_broker", "demote_broker",
    "topic_configuration", "admin",
}

#: the JSON content type aiohttp's json_response sends
JSON_TYPE = "application/json; charset=utf-8"


class Request:
    """What a handler reads of an HTTP request (the part of aiohttp's
    `web.Request` the handlers use): the query's first value per name, the
    headers, the client's address and the path's match."""

    def __init__(self, method: str, path: str, query_string: str, headers, remote: str,
                 match_info: Optional[Dict] = None):
        self.method = method
        self.path = path
        pairs = urllib.parse.parse_qsl(query_string, keep_blank_values=True)
        self.query_items: List[Tuple[str, str]] = pairs
        self.query: Dict[str, str] = {}
        for k, v in pairs:
            self.query.setdefault(k, v)
        self.headers = headers
        self.remote = remote
        self.match_info = match_info or {}

    def query_dict(self) -> Dict[str, str]:
        """The query as a dict, the last value of a repeated name winning
        (`dict()` of aiohttp's multidict)."""
        return dict(self.query_items)


class Response:
    """A response: status, body bytes, headers."""

    def __init__(self, body: bytes, status: int = 200, content_type: str = JSON_TYPE,
                 headers: Optional[Dict] = None):
        self.body = body
        self.status = status
        self.headers = {"Content-Type": content_type, **(headers or {})}


def _text(status: int, reason: str, headers: Optional[Dict] = None) -> Response:
    """aiohttp's own error body (`<status>: <reason>`)."""
    return Response(f"{status}: {reason}".encode(), status,
                    "text/plain; charset=utf-8", headers)


def _bool(request, name: str, default: bool = False) -> bool:
    v = request.query.get(name)
    if v is None:
        return default
    return v.lower() in ("true", "1", "yes")


def _goals(request) -> Optional[list]:
    g = request.query.get("goals")
    return [s for s in g.split(",") if s] if g else None


def _brokerids(request) -> set:
    raw = request.query.get("brokerid", "")
    if not raw:
        raise IllegalRequestException("brokerid parameter is required")
    return {int(b) for b in raw.split(",")}


def _request_options(request):
    """Symbolic OptimizationOptions from query params: `excluded_topics`
    (regex; matching topics' replicas may not move) and
    `destination_broker_ids` (comma ids; the only valid destinations) —
    resolved to masks by the facade once the model exists (where ids are
    range-checked against the model's broker count)."""
    from cruise_control_torch.analyzer.context import OptimizationOptions

    pattern = request.query.get("excluded_topics")
    if pattern:
        import re

        try:
            re.compile(pattern)
        except re.error as e:
            raise IllegalRequestException(f"excluded_topics: bad regex: {e}")
    dst = request.query.get("destination_broker_ids")
    ids = None
    if dst:
        try:
            ids = tuple(int(b) for b in dst.split(",") if b)
        except ValueError:
            raise IllegalRequestException(
                f"destination_broker_ids: expected comma-separated ids, got {dst!r}"
            )
        if not ids:
            raise IllegalRequestException("destination_broker_ids: empty list")
        if any(b < 0 for b in ids):
            raise IllegalRequestException("destination_broker_ids: ids must be >= 0")
    return OptimizationOptions(
        excluded_topic_pattern=pattern or None,
        destination_broker_ids=ids,
    )


class CruiseControlApp:
    """Wires the facade + async layer + task manager into the HTTP routes."""

    def __init__(
        self,
        async_cc: AsyncCruiseControl,
        anomaly_detector=None,
        two_step_verification: bool = False,
        response_wait_s: float = 1.0,
        webui_dir: Optional[str] = None,
        webui_prefix: str = "/",
    ):
        """`webui_dir`: directory of static web-UI files served under
        `webui_prefix` (webserver.ui.diskpath / webserver.ui.urlprefix — the
        optional Jetty web-UI dir, KafkaCruiseControlMain.java:75-111)."""
        self._acc = async_cc
        self._facade = async_cc.facade
        self._detector = anomaly_detector
        self._tasks = UserTaskManager()
        self._purgatory = Purgatory() if two_step_verification else None
        self._two_step = two_step_verification
        self._wait_s = response_wait_s
        self._webui_dir = webui_dir
        self._webui_prefix = "/" + (webui_prefix or "/").strip("/*").strip("/")

    # -- helpers ---------------------------------------------------------------

    def _json(self, payload, status: int = 200, headers: Optional[Dict] = None) -> Response:
        return Response(json.dumps(payload, default=str).encode("utf-8"), status,
                        headers=headers)

    def _device(self):
        """The service's device: its optimizer's (None without a facade)."""
        return getattr(getattr(self._facade, "_optimizer", None), "_device", None)

    @staticmethod
    def _completeness_payload(exc: BaseException) -> Optional[Dict]:
        """Typed JSON body for model-completeness failures
        (monitor/completeness.py): the error class plus the
        observed-vs-required numbers, so clients can back off instead of
        treating "not enough windows yet" as a server bug."""
        from cruise_control_torch.monitor.completeness import ModelCompletenessError

        if not isinstance(exc, ModelCompletenessError):
            return None
        return {
            "errorMessage": str(exc),
            "errorClass": type(exc).__name__,
            "completeness": exc.completeness,
        }

    def _async_op(self, request, endpoint: str, factory) -> Response:
        """Run/attach a long op; 200 + result when done within the wait
        budget, else 202 + progress with the User-Task-ID header."""
        user_task_id = request.headers.get("User-Task-ID") or request.query.get("user_task_id")
        session_key = request.headers.get("X-Session") or request.remote or ""
        try:
            tid, future = self._tasks.get_or_create_task(
                endpoint, factory, user_task_id, session_key
            )
        except KeyError as e:
            return self._json({"errorMessage": str(e)}, status=404)
        except RuntimeError as e:  # task/session capacity (nothing launched)
            return self._json({"errorMessage": str(e)}, status=429)
        deadline = time.monotonic() + self._wait_s
        while not future.done() and time.monotonic() < deadline:
            time.sleep(0.02)
        headers = {"User-Task-ID": tid}
        if not future.done():
            return self._json(
                {"progress": future.describe()}, status=202, headers=headers
            )
        exc = future.exception()
        if exc is not None:
            payload = self._completeness_payload(exc)
            if payload is not None:  # typed 503: retryable "not enough data"
                return self._json(payload, status=503, headers=headers)
            status = 400 if isinstance(exc, IllegalRequestException) else 500
            return self._json({"errorMessage": str(exc)}, status=status, headers=headers)
        return self._json(self._render_result(future.result()), headers=headers)

    def _render_result(self, result) -> Dict:
        if hasattr(result, "goal_results"):  # an OptimizerResult
            # rendering rebuilds the cluster model for the before/after load
            # sections — memoize on the result so repeat polls of a finished
            # task reuse it
            cached = getattr(result, "_rendered_response", None)
            if cached is not None:
                return cached
            from cruise_control_torch.servlet.responses import (
                broker_stats_response,
                optimization_result_response,
            )

            load_before = load_after = None
            try:
                model, meta = self._facade._monitor.cluster_model()
                load_before = broker_stats_response(model, meta, self._device())
                load_after = broker_stats_response(
                    model._replace(assignment=_tensor_like(result.final_assignment,
                                                           model.assignment)),
                    meta, self._device(),
                )
            except Exception:
                pass  # load sections are best-effort (windows may be gone)
            payload = optimization_result_response(result, load_before, load_after)
            try:
                result._rendered_response = payload
            except AttributeError:
                pass
            return payload
        if hasattr(result, "summary"):
            out = result.summary()
            out["proposals"] = [p.to_dict() for p in result.proposals[:10_000]]
            return out
        return result if isinstance(result, dict) else {"result": str(result)}

    def _maybe_park(self, request, endpoint: str) -> Optional[Response]:
        """2-step verification gate for reviewable POSTs."""
        if not self._two_step or endpoint not in REVIEWABLE:
            return None
        if request.headers.get("User-Task-ID") or request.query.get("user_task_id"):
            return None  # polling an already-submitted task, not a new request
        rid = request.query.get("review_id")
        if rid is None:
            review_id = self._purgatory.add_request(endpoint, request.query_dict())
            return self._json(
                {"reviewId": review_id, "status": "PENDING_REVIEW",
                 "message": "approve via POST /review and re-submit with review_id"}
            )
        try:
            self._purgatory.submit(int(rid))
        except (KeyError, ValueError) as e:
            return self._json({"errorMessage": str(e)}, status=400)
        return None

    # -- GET endpoints ---------------------------------------------------------

    def state(self, request) -> Response:
        out = self._facade.state()
        if self._detector is not None:
            out["AnomalyDetectorState"] = self._detector.state()
        # substates filter (CruiseControlStateParameters): e.g.
        # ?substates=monitor,executor (also the reference's spelling,
        # anomaly_detector). Unknown names are a 400, not a silent {}.
        wanted = request.query.get("substates")
        if wanted:
            def norm(s: str) -> str:
                return s.strip().lower().replace("_", "").removesuffix("state")

            available = {norm(k): k for k in out}
            keys = [w for w in wanted.split(",") if w.strip()]
            unknown = [w for w in keys if norm(w) not in available]
            if unknown:
                return self._json(
                    {"errorMessage": f"unknown substates {unknown}; "
                                     f"available: {sorted(available.values())}"},
                    status=400,
                )
            chosen = {available[norm(w)] for w in keys}
            out = {k: v for k, v in out.items() if k in chosen}
        return self._json(out)

    def load(self, request) -> Response:
        from cruise_control_torch.monitor.completeness import ModelCompletenessRequirements
        from cruise_control_torch.servlet.responses import broker_stats_response

        try:
            model, meta = self._facade._monitor.cluster_model(
                ModelCompletenessRequirements(0, 0.0, False)
            )
            payload = broker_stats_response(model, meta, self._device()).to_dict()
        except ValueError as e:
            return self._json(
                self._completeness_payload(e) or {"errorMessage": str(e)}, status=503
            )
        return self._json(payload)

    def partition_load(self, request) -> Response:
        resource = request.query.get("resource", "DISK").upper()
        try:
            res = Resource[resource]
        except KeyError:
            return self._json({"errorMessage": f"unknown resource {resource}"}, status=400)
        entries = int(request.query.get("entries", "100"))

        def build():
            model, meta = self._facade._monitor.cluster_model()
            pl = np.asarray(model.part_load)
            col = {
                Resource.CPU: pl[:, PartMetric.CPU_LEADER],
                Resource.NW_IN: pl[:, PartMetric.NW_IN_LEADER],
                Resource.NW_OUT: pl[:, PartMetric.NW_OUT_LEADER],
                Resource.DISK: pl[:, PartMetric.DISK],
            }[res]
            n = min(entries, col.shape[0])
            order = np.argsort(-col)[:n]
            a = np.asarray(model.assignment)
            # PartitionLoadState.java record shape: topic/partition/leader/followers
            return {
                "records": [
                    {
                        "topic": meta.topic_names[int(model.topic_id[p])],
                        "partition": int(meta.partition_index[p]),
                        "topicPartition": meta.topic_partition(int(p)),
                        "leader": int(a[p, 0]),
                        "followers": [int(b) for b in a[p, 1:] if b >= 0],
                        resource: float(col[p]),
                    }
                    for p in order
                ],
                "version": 1,
            }

        try:
            payload = build()
        except ValueError as e:
            return self._json(
                self._completeness_payload(e) or {"errorMessage": str(e)}, status=503
            )
        return self._json(payload)

    def proposals(self, request) -> Response:
        goals = _goals(request)
        ignore_cache = _bool(request, "ignore_proposal_cache")
        try:
            options = _request_options(request)
        except IllegalRequestException as e:
            return self._json({"errorMessage": str(e)}, status=400)
        return self._async_op(
            request, "proposals",
            lambda: self._acc.get_proposals(
                goal_names=goals, ignore_proposal_cache=ignore_cache, options=options
            ),
        )

    def kafka_cluster_state(self, request) -> Response:
        topo = self._facade._monitor._metadata.refresh_metadata()
        a = np.asarray(topo.assignment)
        leaders = a[:, 0]
        out_brokers = []
        for i in range(topo.num_brokers):
            out_brokers.append(
                {
                    "Broker": int(topo.broker_ids[i]),
                    "BrokerState": BrokerState(int(topo.broker_state[i])).name,
                    "Rack": int(topo.broker_rack[i]),
                    "Leaders": int((leaders == i).sum()),
                    "Replicas": int((a == i).sum()),
                }
            )
        verbose = _bool(request, "verbose")
        out = {"KafkaBrokerState": out_brokers}
        if verbose:
            out["KafkaPartitionState"] = [
                {
                    "topicPartition": f"{topo.topic_names[topo.topic_id[p]]}-{int(topo.partition_index[p])}",
                    "leader": int(a[p, 0]),
                    "replicas": [int(b) for b in a[p] if b >= 0],
                }
                for p in range(topo.num_partitions)
            ]
        return self._json(out)

    def user_tasks(self, request) -> Response:
        return self._json({"userTasks": self._tasks.describe_all(), "version": 1})

    def metrics(self, request) -> Response:
        """Prometheus text exposition of the sensor registry (timers, meters,
        histograms with p50/p95/p99 quantile gauges, numeric gauges); also
        mounted at `/metrics` for stock Prometheus scrape configs."""
        from cruise_control_torch.common.sensors import REGISTRY

        return Response(REGISTRY.prometheus_text().encode("utf-8"),
                        content_type="text/plain; version=0.0.4; charset=utf-8")

    def trace(self, request) -> Response:
        """Recent tracer spans (newest first) + per-kind latency summary.
        `kind` filters by span kind (proposal/goal/device-call/monitor/
        executor/detector), `trace_id` by trace, `limit` bounds the list."""
        from cruise_control_torch.common.tracing import TRACER

        try:
            limit = int(request.query.get("limit", "256"))
        except ValueError:
            return self._json({"errorMessage": "limit must be an integer"}, status=400)
        return self._json(
            {
                "spans": TRACER.recent(
                    limit=max(1, min(limit, 10_000)),
                    kind=request.query.get("kind") or None,
                    trace_id=request.query.get("trace_id") or None,
                ),
                "summary": TRACER.summarize(),
                "overheadS": round(TRACER.overhead_s, 6),
                "version": 1,
            }
        )

    def timeseries(self, request) -> Response:
        """Windowed sensor time-series from the history store: per-sensor
        first/last/delta/rate stats plus step-downsampled series for the top
        movers. `name` (fnmatch pattern) or `kind` (sensor-name prefix, e.g.
        `GoalOptimizer`) filter the series set; `window`/`step` are seconds;
        `limit` bounds how many series come back (ranked by |delta|). When
        no background sampler is running, each scrape records one snapshot
        (scrape-driven sampling); `snapshot=true|false` forces/suppresses
        that."""
        from cruise_control_torch.common.history import HISTORY
        from cruise_control_torch.common.tracing import TRACER

        with TRACER.span("GET /timeseries", kind="timeseries"):
            try:
                window = request.query.get("window")
                window_s = float(window) if window else None
                step = request.query.get("step")
                step_s = float(step) if step else None
                limit = int(request.query.get("limit", "25"))
            except ValueError:
                return self._json(
                    {"errorMessage": "window/step/limit must be numeric"},
                    status=400,
                )
            pattern = request.query.get("name")
            if pattern is None and request.query.get("kind"):
                pattern = request.query["kind"] + ".*"
            snap = request.query.get("snapshot", "auto").lower()
            if snap in ("1", "true", "yes") or (
                snap == "auto" and not HISTORY.sampler_running
            ):
                HISTORY.snapshot_now(reason="scrape")
            query = HISTORY.query(pattern=pattern, window_s=window_s)
            movers = sorted(
                query, key=lambda n: -abs(query[n]["delta"])
            )[: max(0, limit)]
            return self._json(
                {
                    "query": query,
                    "series": {
                        n: HISTORY.series(n, window_s=window_s, step_s=step_s)
                        for n in movers
                    },
                    "history": HISTORY.state(),
                    "version": 1,
                }
            )

    def explain(self, request) -> Response:
        """Decision provenance: which goal/engine proposed each accepted move
        of a recorded optimization run, in which round and apply wave, under
        what cost/violated deltas (`analyzer/provenance.py`). `run` selects a
        recorded run id (default: the latest); `partition`, `broker`, `goal`,
        `round`, `kind` (move/leadership), `phase` (main/polish) filter the
        move list; `view=proposal` groups moves by partition; `limit` bounds
        the rows returned."""
        from cruise_control_torch.analyzer.provenance import LEDGER
        from cruise_control_torch.common.tracing import TRACER

        with TRACER.span("GET /explain", kind="explain"):
            run_id = request.query.get("run")
            ledger = LEDGER.get(run_id) if run_id else LEDGER.latest()
            if ledger is None:
                msg = (
                    f"unknown run {run_id!r}" if run_id
                    else "no optimization run recorded yet"
                )
                return self._json(
                    {"errorMessage": msg, "ledger": LEDGER.state()}, status=404
                )
            try:
                partition = request.query.get("partition")
                partition = int(partition) if partition is not None else None
                broker = request.query.get("broker")
                broker = int(broker) if broker is not None else None
                rnd = request.query.get("round")
                rnd = int(rnd) if rnd is not None else None
                limit = int(request.query.get("limit", "1000"))
            except ValueError:
                return self._json(
                    {"errorMessage": "partition/broker/round/limit must be integers"},
                    status=400,
                )
            view = request.query.get("view", "move")
            if view not in ("move", "proposal"):
                return self._json(
                    {"errorMessage": f"unknown view {view!r} (move|proposal)"},
                    status=400,
                )
            out = {
                "run": ledger.summary(),
                "view": view,
                "ledger": LEDGER.state(),
                "version": 1,
            }
            if view == "proposal":
                proposals = ledger.proposal_view(partition)
                out["proposals"] = proposals[: max(0, limit)]
            else:
                out["moves"] = [
                    m.to_dict()
                    for m in ledger.query(
                        partition=partition, broker=broker,
                        goal=request.query.get("goal") or None,
                        round=rnd,
                        kind=request.query.get("kind") or None,
                        phase=request.query.get("phase") or None,
                        limit=max(0, limit),
                    )
                ]
            return self._json(out)

    def perf(self, request) -> Response:
        """The perf observatory join: the kernel libraries' build records
        (joined with their bucket's build histogram), device memory
        watermarks, host<->device transfer totals, the hot optimizer timers,
        the environment fingerprint, and the history store's state."""
        from cruise_control_torch.common.history import HISTORY
        from cruise_control_torch.common.sensors import REGISTRY
        from cruise_control_torch.common.telemetry import TELEMETRY
        from cruise_control_torch.common.tracing import TRACER

        with TRACER.span("GET /perf", kind="perf"):
            TELEMETRY.update_memory()
            snap = REGISTRY.snapshot()
            programs = []
            for rec in TELEMETRY.programs():
                row = dict(rec)
                row["compile"] = snap.get(
                    "GoalOptimizer.stack-compile-timer.bucket." + rec["bucket"]
                )
                programs.append(row)
            try:
                fingerprint = TELEMETRY.fingerprint()
            except Exception as e:  # a dead card must not 500 the join
                fingerprint = {"error": f"{type(e).__name__}: {e}"}
            return self._json(
                {
                    "fingerprint": fingerprint,
                    "programs": programs,
                    "memory": TELEMETRY.memory(),
                    "transfers": TELEMETRY.transfer_totals(),
                    "timers": {
                        "proposalTimer": snap.get(
                            "GoalOptimizer.proposal-computation-timer"
                        ),
                        "roundTimer": snap.get("GoalOptimizer.optimizer-round-timer"),
                        "deviceCallTimer": snap.get("GoalOptimizer.device-call-timer"),
                        "compileTimer": snap.get("GoalOptimizer.stack-compile-timer"),
                    },
                    "telemetryOverheadS": round(TELEMETRY.overhead_s, 6),
                    "history": HISTORY.state(),
                    "version": 1,
                }
            )

    def review_board(self, request) -> Response:
        if self._purgatory is None:
            return self._json({"errorMessage": "2-step verification is disabled"}, status=400)
        return self._json(self._purgatory.review_board())

    def bootstrap(self, request) -> Response:
        """Replay the sample store into the aggregators (BootstrapTask analog).

        `start`/`end` (epoch ms) select the RANGE / SINCE bootstrap modes of
        LoadMonitorTaskRunner.bootstrap (:127-177); with neither, the whole
        store history replays."""
        monitor = self._facade._monitor
        start = request.query.get("start")
        end = request.query.get("end")
        if start is not None or end is not None:
            n = monitor.bootstrap_range(
                int(start) if start is not None else 0,
                int(end) if end is not None else None,
            )
        else:
            from cruise_control_torch.monitor.sampler import Samples

            part, brok = monitor._store.load_samples()
            n = monitor.bootstrap(Samples(part, brok))
        return self._json({"bootstrappedSamples": n, "state": monitor.state})

    def train(self, request) -> Response:
        """Train the linear-regression CPU model from the range's broker
        samples (LoadMonitorTaskRunner.train :205). `start`/`end` epoch ms;
        defaults to the whole store history."""
        monitor = self._facade._monitor
        start = int(request.query.get("start", "0"))
        end = request.query.get("end")
        result = monitor.train_range(start, int(end) if end is not None else None)
        result["state"] = monitor.state
        return self._json(result)

    # -- POST endpoints --------------------------------------------------------

    def rebalance(self, request) -> Response:
        parked = self._maybe_park(request, "rebalance")
        if parked is not None:
            return parked
        goals = _goals(request)
        dryrun = _bool(request, "dryrun", True)
        skip_hard = _bool(request, "skip_hard_goal_check")
        ignore_cache = _bool(request, "ignore_proposal_cache")
        try:
            options = _request_options(request)
        except IllegalRequestException as e:
            return self._json({"errorMessage": str(e)}, status=400)
        return self._async_op(
            request, "rebalance",
            lambda: self._acc.rebalance(
                goal_names=goals, dryrun=dryrun, skip_hard_goal_check=skip_hard,
                options=options, ignore_proposal_cache=ignore_cache,
            ),
        )

    def add_broker(self, request) -> Response:
        parked = self._maybe_park(request, "add_broker")
        if parked is not None:
            return parked
        try:
            brokers = _brokerids(request)
        except IllegalRequestException as e:
            return self._json({"errorMessage": str(e)}, status=400)
        dryrun = _bool(request, "dryrun", True)
        return self._async_op(
            request, "add_broker", lambda: self._acc.add_brokers(brokers, dryrun=dryrun)
        )

    def remove_broker(self, request) -> Response:
        parked = self._maybe_park(request, "remove_broker")
        if parked is not None:
            return parked
        try:
            brokers = _brokerids(request)
        except IllegalRequestException as e:
            return self._json({"errorMessage": str(e)}, status=400)
        dryrun = _bool(request, "dryrun", True)
        try:
            options = _request_options(request)
        except IllegalRequestException as e:
            return self._json({"errorMessage": str(e)}, status=400)
        return self._async_op(
            request, "remove_broker",
            lambda: self._acc.decommission_brokers(brokers, dryrun=dryrun, options=options),
        )

    def demote_broker(self, request) -> Response:
        parked = self._maybe_park(request, "demote_broker")
        if parked is not None:
            return parked
        try:
            brokers = _brokerids(request)
        except IllegalRequestException as e:
            return self._json({"errorMessage": str(e)}, status=400)
        dryrun = _bool(request, "dryrun", True)
        return self._async_op(
            request, "demote_broker",
            lambda: self._acc.demote_brokers(brokers, dryrun=dryrun),
        )

    def stop_proposal_execution(self, request) -> Response:
        self._facade._executor.user_triggered_stop_execution()
        return self._json({"message": "execution stop requested"})

    def pause_sampling(self, request) -> Response:
        self._facade._monitor.pause_metric_sampling(request.query.get("reason", "user request"))
        return self._json({"message": "sampling paused"})

    def resume_sampling(self, request) -> Response:
        self._facade._monitor.resume_metric_sampling()
        return self._json({"message": "sampling resumed"})

    def topic_configuration(self, request) -> Response:
        parked = self._maybe_park(request, "topic_configuration")
        if parked is not None:
            return parked
        pattern = request.query.get("topic")
        rf = request.query.get("replication_factor")
        if not pattern or not rf:
            return self._json(
                {"errorMessage": "topic and replication_factor are required"}, status=400
            )
        dryrun = _bool(request, "dryrun", True)
        return self._async_op(
            request, "topic_configuration",
            lambda: self._acc.submit(
                "TOPIC_CONFIGURATION",
                self._facade.update_topic_replication_factor,
                pattern, int(rf), dryrun,
            ),
        )

    def admin(self, request) -> Response:
        parked = self._maybe_park(request, "admin")
        if parked is not None:
            return parked
        out = {}
        pb = request.query.get("concurrent_partition_movements_per_broker")
        lm = request.query.get("concurrent_leader_movements")
        if pb or lm:
            self._facade._executor.set_concurrency(
                per_broker=int(pb) if pb else None, leadership=int(lm) if lm else None
            )
            out["concurrencyUpdated"] = True
        if self._detector is not None:
            enable = request.query.get("enable_self_healing_for")
            disable = request.query.get("disable_self_healing_for")
            notifier = self._detector._notifier
            for name, value in ((enable, True), (disable, False)):
                if name:
                    attr = f"self_healing_{name.lower()}_enabled"
                    if hasattr(notifier, attr):
                        object.__setattr__(notifier, attr, value)
                        out[f"selfHealing:{name}"] = value
        return self._json(out or {"message": "no admin action taken"})

    def review(self, request) -> Response:
        if self._purgatory is None:
            return self._json({"errorMessage": "2-step verification is disabled"}, status=400)
        approve = [int(x) for x in request.query.get("approve", "").split(",") if x]
        discard = [int(x) for x in request.query.get("discard", "").split(",") if x]
        try:
            return self._json(
                self._purgatory.apply_review(approve, discard, request.query.get("reason", ""))
            )
        except (KeyError, ValueError) as e:
            return self._json({"errorMessage": str(e)}, status=400)

    # -- routing ---------------------------------------------------------------

    def build_app(self) -> "Router":
        """The routes: every endpoint under PREFIX, the root scrape aliases,
        then the web UI's static files (the JAX server's build_app)."""
        g = [
            ("state", self.state), ("load", self.load),
            ("partition_load", self.partition_load), ("proposals", self.proposals),
            ("kafka_cluster_state", self.kafka_cluster_state),
            ("user_tasks", self.user_tasks), ("review_board", self.review_board),
            ("bootstrap", self.bootstrap), ("train", self.train),
            ("metrics", self.metrics), ("trace", self.trace),
            ("timeseries", self.timeseries), ("perf", self.perf),
            ("explain", self.explain),
        ]
        p = [
            ("rebalance", self.rebalance), ("add_broker", self.add_broker),
            ("remove_broker", self.remove_broker), ("demote_broker", self.demote_broker),
            ("stop_proposal_execution", self.stop_proposal_execution),
            ("pause_sampling", self.pause_sampling), ("resume_sampling", self.resume_sampling),
            ("topic_configuration", self.topic_configuration), ("admin", self.admin),
            ("review", self.review),
        ]
        router = Router()
        for name, handler in g:
            router.add("GET", f"{PREFIX}/{name}", handler)
        for name, handler in p:
            router.add("POST", f"{PREFIX}/{name}", handler)
        # root-level scrape aliases (matched before the web-UI catch-all so
        # a mounted UI cannot shadow the Prometheus convention paths)
        for name in ("metrics", "trace", "timeseries", "perf", "explain"):
            router.add("GET", f"/{name}", getattr(self, name))
        if self._webui_dir:
            if os.path.isdir(self._webui_dir):
                router.static = _StaticFiles(self._webui_dir, self._webui_prefix or "/")
            else:
                logging.getLogger(__name__).warning(
                    "webserver.ui.diskpath %r is not a directory; web-UI "
                    "serving disabled", self._webui_dir,
                )
        return router


def _tensor_like(array, like):
    """`array` (numpy) as a tensor of `like`'s dtype on its device."""
    import torch

    return torch.as_tensor(np.asarray(array), dtype=like.dtype).to(like.device)


class _StaticFiles:
    """The web UI's files under a prefix. At "/" it serves index.html at "/"
    and any other path outside the API prefix; elsewhere the files under
    the prefix, with no directory listing. A path that escapes the
    directory (symlinks resolved) is a 403, a missing file a 404."""

    def __init__(self, directory: str, prefix: str):
        self.base = os.path.realpath(directory)
        self.prefix = prefix

    def match(self, path: str) -> Optional[str]:
        """The path relative to the UI directory, or None if not the UI's."""
        if self.prefix == "/":
            if path == "/":
                return "index.html"
            if path.startswith(PREFIX):
                return None
            return path[1:]
        if path.startswith(self.prefix + "/"):
            return path[len(self.prefix) + 1:]
        return None

    def serve(self, rel: str) -> Response:
        full = os.path.realpath(os.path.join(self.base, urllib.parse.unquote(rel)))
        if not full.startswith(self.base + os.sep):
            return _text(403, "Forbidden")
        if os.path.isdir(full):
            return _text(403, "Forbidden")
        if not os.path.isfile(full):
            return _text(404, "Not Found")
        import mimetypes

        with open(full, "rb") as f:
            body = f.read()
        ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
        if ctype.startswith("text/") or ctype in ("application/javascript", "application/json"):
            ctype += "; charset=utf-8"
        return Response(body, content_type=ctype)


class Router:
    """Method + path -> handler, then the static files."""

    def __init__(self):
        self.routes: Dict[str, Dict[str, Callable]] = {}
        self.static: Optional[_StaticFiles] = None

    def add(self, method: str, path: str, handler: Callable) -> None:
        self.routes.setdefault(path, {})[method] = handler

    def handle(self, request: Request) -> Response:
        methods = self.routes.get(request.path)
        if methods is not None:
            handler = methods.get(request.method)
            if handler is None:
                return _text(405, "Method Not Allowed",
                             {"Allow": ",".join(sorted(methods))})
            return handler(request)
        if self.static is not None and request.method == "GET":
            rel = self.static.match(request.path)
            if rel is not None:
                return self.static.serve(rel)
        return _text(404, "Not Found")


#: NCSA combined log format (KafkaCruiseControlMain.java:78-89 wires Jetty's
#: NCSARequestLog; the JAX server passes it to aiohttp)
NCSA_LOG_FORMAT = '%a - - %t "%r" %s %b "%{Referer}i" "%{User-Agent}i"'


def _ncsa_line(remote: str, start: float, request_line: str, status: int, size: int,
               headers) -> str:
    """One NCSA_LOG_FORMAT line."""
    tz = datetime.timezone(datetime.timedelta(seconds=-time.timezone))
    stamp = datetime.datetime.fromtimestamp(start, tz).strftime("[%d/%b/%Y:%H:%M:%S %z]")
    return (f'{remote} - - {stamp} "{request_line}" {status} {size} '
            f'"{headers.get("Referer", "-")}" "{headers.get("User-Agent", "-")}"')


def _handler_class(router: Router, access_logger: Optional[logging.Logger]):
    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "cruise-control-torch"

        def _dispatch(self, method: str) -> None:
            start = time.time()
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                self.rfile.read(length)  # the handlers read no body
            url = urllib.parse.urlsplit(self.path)
            request = Request(method, urllib.parse.unquote(url.path) or "/", url.query,
                              self.headers, self.client_address[0])
            try:
                response = router.handle(request)
            except Exception:
                logging.getLogger(__name__).exception("error handling %s %s", method,
                                                      self.path)
                response = _text(500, "Internal Server Error")
            self.send_response(response.status)
            for k, v in response.headers.items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(response.body)))
            self.end_headers()
            self.wfile.write(response.body)
            if access_logger is not None:
                access_logger.info(_ncsa_line(self.client_address[0], start,
                                              self.requestline, response.status,
                                              len(response.body), self.headers))

        def do_GET(self):  # noqa: N802 - http.server's names
            self._dispatch("GET")

        def do_POST(self):  # noqa: N802
            self._dispatch("POST")

        def log_message(self, format, *args):  # noqa: A002 - the access log is ours
            pass

    return Handler


class _Server(http.server.ThreadingHTTPServer):
    daemon_threads = True


class ServerHandle:
    """A server started by `serve`: its address and how to stop it."""

    def __init__(self, server: _Server, thread: Optional[threading.Thread]):
        self._server = server
        self._thread = thread

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def serve_forever(self) -> None:
        self._server.serve_forever()

    def shutdown(self) -> None:
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=5)
        self._server.server_close()


def serve(app: CruiseControlApp, host: str = "127.0.0.1", port: int = 9090,
          access_log_path: Optional[str] = None, background: bool = True) -> ServerHandle:
    """Bind the app's routes at (host, port); with `background`, serve on a
    daemon thread (port 0 picks a free port: see `.address`). When
    `access_log_path` is given, requests are appended there in NCSA
    combined format (the reference's optional Jetty access log)."""
    access_logger = None
    if access_log_path:
        access_logger = logging.getLogger("cruise_control_torch.access")
        access_logger.setLevel(logging.INFO)
        access_logger.propagate = False
        access_logger.addHandler(logging.FileHandler(access_log_path))
    server = _Server((host, port), _handler_class(app.build_app(), access_logger))
    thread = None
    if background:
        thread = threading.Thread(target=server.serve_forever, name="cc-http", daemon=True)
        thread.start()
    return ServerHandle(server, thread)


def run_server(
    app: CruiseControlApp,
    host: str = "127.0.0.1",
    port: int = 9090,
    access_log_path: str = None,
) -> None:
    """Serve until interrupted (SIGINT); when `access_log_path` is given,
    HTTP requests are appended there in NCSA combined format."""
    handle = serve(app, host, port, access_log_path, background=False)
    try:
        handle.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        handle.shutdown()
