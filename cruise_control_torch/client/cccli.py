"""cccli: command-line client for the REST API.

Analog of cruise-control-client (cruisecontrolclient/client/cccli.py +
Endpoint.py/Responder.py/Display.py, SURVEY.md §2i): one subcommand per
endpoint, typed CCParameter validation client-side (client.endpoint), table
rendering for the well-known payloads (client.display, `--json` for raw), and
User-Task-ID polling for long operations — stdlib urllib only, so the CLI
works anywhere the service does."""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.parse
import urllib.request
from typing import Dict, Optional

GET_ENDPOINTS = {
    "state", "load", "partition_load", "proposals", "kafka_cluster_state",
    "user_tasks", "review_board", "bootstrap", "train",
}
POST_ENDPOINTS = {
    "rebalance", "add_broker", "remove_broker", "demote_broker",
    "stop_proposal_execution", "pause_sampling", "resume_sampling",
    "topic_configuration", "admin", "review",
}


class CruiseControlClient:
    """Responder.py analog: HTTP + User-Task-ID polling."""

    def __init__(self, base_url: str, poll_interval_s: float = 1.0, timeout_s: float = 600.0):
        self._base = base_url.rstrip("/")
        self._poll = poll_interval_s
        self._timeout = timeout_s

    def request(self, endpoint: str, params: Optional[Dict] = None, wait: bool = True) -> Dict:
        method = "GET" if endpoint in GET_ENDPOINTS else "POST"
        query = urllib.parse.urlencode(params or {})
        url = f"{self._base}/kafkacruisecontrol/{endpoint}"
        if query:
            url += f"?{query}"
        task_id = None
        deadline = time.monotonic() + self._timeout
        while True:
            req = urllib.request.Request(url, method=method)
            if task_id:
                req.add_header("User-Task-ID", task_id)
            try:
                with urllib.request.urlopen(req) as resp:
                    body = json.loads(resp.read().decode())
                    status = resp.status
                    task_id = resp.headers.get("User-Task-ID", task_id)
            except urllib.error.HTTPError as e:
                return {"errorMessage": e.read().decode(), "status": e.code}
            if status != 202 or not wait:
                return body
            if time.monotonic() > deadline:
                return {"errorMessage": "timed out waiting for task", "userTaskId": task_id}
            time.sleep(self._poll)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="cccli", description="cruise_control_torch REST client"
    )
    parser.add_argument("-a", "--address", default="http://127.0.0.1:9090",
                        help="server base URL")
    parser.add_argument("--no-wait", action="store_true",
                        help="do not poll async operations to completion")
    parser.add_argument("--json", action="store_true", dest="raw_json",
                        help="print raw JSON instead of tables")
    sub = parser.add_subparsers(dest="endpoint", required=True)

    def add(name, *flags):
        p = sub.add_parser(name)
        for flag, kw in flags:
            p.add_argument(flag, **kw)
        return p

    bools = {"action": "store_true"}
    add("state", ("--substates", {}))
    add("load")
    add("partition_load", ("--resource", {"default": "DISK"}), ("--entries", {"type": int, "default": 20}))
    add("proposals", ("--goals", {}), ("--ignore-proposal-cache", bools),
        ("--excluded-topics", {}), ("--destination-broker-ids", {}))
    add("kafka_cluster_state", ("--verbose", bools))
    add("user_tasks")
    add("review_board")
    add("bootstrap", ("--start", {"type": int}), ("--end", {"type": int}))
    add("train", ("--start", {"type": int}), ("--end", {"type": int}))
    add("rebalance", ("--goals", {}), ("--dryrun", {"default": "true"}),
        ("--skip-hard-goal-check", bools), ("--review-id", {}),
        ("--excluded-topics", {}), ("--destination-broker-ids", {}))
    add("add_broker", ("brokerid", {}), ("--dryrun", {"default": "true"}), ("--review-id", {}))
    add("remove_broker", ("brokerid", {}), ("--dryrun", {"default": "true"}), ("--review-id", {}),
        ("--excluded-topics", {}), ("--destination-broker-ids", {}))
    add("demote_broker", ("brokerid", {}), ("--dryrun", {"default": "true"}), ("--review-id", {}))
    add("stop_proposal_execution")
    add("pause_sampling", ("--reason", {"default": "cccli"}))
    add("resume_sampling")
    add("topic_configuration", ("--topic", {"required": True}),
        ("--replication-factor", {"type": int, "required": True}),
        ("--dryrun", {"default": "true"}), ("--review-id", {}))
    add("admin", ("--concurrent-partition-movements-per-broker", {"type": int}),
        ("--concurrent-leader-movements", {"type": int}),
        ("--enable-self-healing-for", {}), ("--disable-self-healing-for", {}))
    add("review", ("--approve", {}), ("--discard", {}), ("--reason", {"default": ""}))
    return parser


def main(argv=None) -> int:
    from cruise_control_torch.client.display import render
    from cruise_control_torch.client.endpoint import validate_params

    args = build_parser().parse_args(argv)
    params = {
        k: v
        for k, v in vars(args).items()
        if k not in ("address", "endpoint", "no_wait", "raw_json")
        # `is` comparisons: 0 is a legitimate value (e.g. --start 0) and
        # compares equal to False under `in`
        and v is not None and v is not False
    }
    params = {k: ("true" if v is True else str(v)) for k, v in params.items()}
    try:
        params = validate_params(args.endpoint, params)
    except ValueError as e:
        print(f"invalid parameter: {e}", file=sys.stderr)
        return 2
    client = CruiseControlClient(args.address)
    out = client.request(args.endpoint, params, wait=not args.no_wait)
    if args.raw_json or not isinstance(out, dict):
        json.dump(out, sys.stdout, indent=2, default=str)
        print()
    else:
        print(render(args.endpoint, out))
    return 0 if "errorMessage" not in out else 1


if __name__ == "__main__":
    sys.exit(main())
