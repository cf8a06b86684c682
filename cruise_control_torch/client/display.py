"""Human-readable rendering of REST responses.

Analog of cruise-control-client's Display.py / util/print.py: well-known
payload shapes (broker load, proposals, state, user tasks) render as aligned
tables; everything else falls back to pretty JSON. `--json` on the CLI forces
raw JSON.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence


def _table(headers: Sequence[str], rows: List[Sequence]) -> str:
    cols = [[str(h)] + [str(r[i]) for r in rows] for i, h in enumerate(headers)]
    widths = [max(len(v) for v in col) for col in cols]
    def fmt(row):
        return "  ".join(str(v).ljust(w) for v, w in zip(row, widths))
    lines = [fmt(headers), fmt(["-" * w for w in widths])]
    lines.extend(fmt(r) for r in rows)
    return "\n".join(lines)


def render(endpoint: str, payload: Dict) -> str:
    if not isinstance(payload, dict):
        return json.dumps(payload, indent=2, default=str)
    if "errorMessage" in payload:
        return f"ERROR: {payload['errorMessage']}"
    if endpoint == "load" and "brokers" in payload:
        headers = ["Broker", "Host", "State", "DiskMB", "DiskPct", "CpuPct",
                   "LeaderNwIn", "FollowerNwIn", "NwOut", "PnwOut", "Replicas", "Leaders"]
        rows = [
            [b["Broker"], b["Host"], b["BrokerState"], b["DiskMB"], b["DiskPct"],
             b["CpuPct"], b["LeaderNwInRate"], b["FollowerNwInRate"],
             b["NwOutRate"], b["PnwOutRate"], b["Replicas"], b["Leaders"]]
            for b in payload["brokers"]
        ]
        return _table(headers, rows)
    if "summary" in payload and "goalSummary" in payload:  # OptimizationResult
        out = [json.dumps(payload["summary"], indent=2, default=str), ""]
        rows = [
            [g["goal"], g["status"],
             g["clusterModelStats"]["violatedBrokersBefore"],
             g["clusterModelStats"]["violatedBrokersAfter"]]
            for g in payload["goalSummary"]
        ]
        out.append(_table(["Goal", "Status", "ViolatedBefore", "ViolatedAfter"], rows))
        n = len(payload.get("proposals", []))
        out.append(f"\n{n} proposal(s)")
        return "\n".join(out)
    if endpoint == "user_tasks" and "userTasks" in payload:
        rows = [
            [t["UserTaskId"], t["RequestURL"], t["Status"], t["StartMs"],
             t.get("ClientIdentity", "")]
            for t in payload["userTasks"]
        ]
        return _table(["UserTaskId", "RequestURL", "Status", "StartMs", "Client"], rows)
    if endpoint == "partition_load" and "records" in payload:
        if not payload["records"]:
            return "(no records)"
        keys = list(payload["records"][0].keys())
        rows = [[r.get(k, "") for k in keys] for r in payload["records"]]
        return _table(keys, rows)
    return json.dumps(payload, indent=2, default=str)
