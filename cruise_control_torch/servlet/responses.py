"""Typed REST response schemas pinning the reference wire format.

The JAX package's servlet/responses.py, on the port's models (torch
tensors).

Each class mirrors one of the reference's response classes
(cc/servlet/response/*, 17 files) with the exact JSON field names, so a
client written against LinkedIn Cruise Control's REST API parses our
responses unchanged:

  BasicStats / SingleBrokerStats / BrokerStats
      cc/servlet/response/stats/{BasicStats,SingleBrokerStats,BrokerStats}.java
  OptimizationResult                cc/servlet/response/OptimizationResult.java
  PartitionLoadState                cc/servlet/response/PartitionLoadState.java
  UserTaskState                     cc/servlet/response/UserTaskState.java

Every top-level response carries `version` (ResponseUtils.VERSION).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from cruise_control_torch.common.resources import (
    BrokerState,
    PartMetric,
    Resource,
)

JSON_VERSION = 1


@dataclasses.dataclass(frozen=True)
class BasicStats:
    """stats/BasicStats.java: one entity's load vector."""

    disk_mb: float
    disk_pct: float
    cpu_pct: float
    leader_nw_in_rate: float
    follower_nw_in_rate: float
    nw_out_rate: float
    pnw_out_rate: float
    replicas: int
    leaders: int

    def to_dict(self) -> Dict:
        return {
            "DiskMB": round(self.disk_mb, 3),
            "DiskPct": round(self.disk_pct, 3),
            "CpuPct": round(self.cpu_pct, 3),
            "LeaderNwInRate": round(self.leader_nw_in_rate, 3),
            "FollowerNwInRate": round(self.follower_nw_in_rate, 3),
            "NwOutRate": round(self.nw_out_rate, 3),
            "PnwOutRate": round(self.pnw_out_rate, 3),
            "Replicas": self.replicas,
            "Leaders": self.leaders,
        }


@dataclasses.dataclass(frozen=True)
class SingleBrokerStats:
    """stats/SingleBrokerStats.java."""

    host: str
    broker: int
    broker_state: str
    stats: BasicStats

    def to_dict(self) -> Dict:
        out = {"Host": self.host, "Broker": self.broker, "BrokerState": self.broker_state}
        out.update(self.stats.to_dict())
        return out


@dataclasses.dataclass(frozen=True)
class BrokerStats:
    """stats/BrokerStats.java: the /load payload (hosts + brokers)."""

    hosts: List[Dict]
    brokers: List[SingleBrokerStats]

    def to_dict(self) -> Dict:
        return {
            "hosts": self.hosts,
            "brokers": [b.to_dict() for b in self.brokers],
            "version": JSON_VERSION,
        }


def broker_stats_response(model, meta, device=None) -> BrokerStats:
    """Build BrokerStats from a flat model (ClusterModel.brokerStats :1072).
    The broker loads are K1's sums on `device` (the model's own when None),
    in the order of the JAX package's segment_sum."""
    from cruise_control_torch.models.flat_model import broker_loads

    a = model.assignment.cpu().numpy()
    pl = model.part_load.cpu().numpy()
    b = model.num_brokers
    on = model if device is None else model.to(device)
    loads = broker_loads(on).cpu().numpy()  # [B, 4] CPU/NW_IN/NW_OUT/DISK
    cap = model.broker_capacity.cpu().numpy()

    valid = a >= 0
    seg = np.where(valid, a, b).reshape(-1)
    ones = np.ones(seg.shape, dtype=np.int64)
    replicas = np.bincount(seg, weights=ones, minlength=b + 1)[:b].astype(int)
    leader_seg = np.where(a[:, 0] >= 0, a[:, 0], b)
    leaders = np.bincount(leader_seg, minlength=b + 1)[:b].astype(int)
    leader_nw_in = np.bincount(
        leader_seg, weights=pl[:, PartMetric.NW_IN_LEADER], minlength=b + 1
    )[:b]
    follower_nw_in = loads[:, Resource.NW_IN] - leader_nw_in
    pnw = np.bincount(
        seg,
        weights=np.broadcast_to(
            pl[:, PartMetric.NW_OUT_LEADER, None], a.shape
        ).reshape(-1),
        minlength=b + 1,
    )[:b]

    host_of = model.broker_host.cpu().numpy()
    state = model.broker_state.cpu().numpy()
    brokers = []
    host_agg: Dict[int, Dict] = {}
    for i in range(b):
        stats = BasicStats(
            disk_mb=float(loads[i, Resource.DISK]),
            disk_pct=float(100.0 * loads[i, Resource.DISK] / max(cap[i, Resource.DISK], 1e-9)),
            cpu_pct=float(100.0 * loads[i, Resource.CPU] / max(cap[i, Resource.CPU], 1e-9)),
            leader_nw_in_rate=float(leader_nw_in[i]),
            follower_nw_in_rate=float(follower_nw_in[i]),
            nw_out_rate=float(loads[i, Resource.NW_OUT]),
            pnw_out_rate=float(pnw[i]),
            replicas=int(replicas[i]),
            leaders=int(leaders[i]),
        )
        h = int(host_of[i])
        brokers.append(
            SingleBrokerStats(
                host=f"host-{h}",
                broker=int(meta.broker_ids[i]) if meta is not None else i,
                broker_state=BrokerState(int(state[i])).name,
                stats=stats,
            )
        )
        agg = host_agg.setdefault(
            h,
            {"Host": f"host-{h}", "DiskMB": 0.0, "CpuPct": 0.0, "LeaderNwInRate": 0.0,
             "FollowerNwInRate": 0.0, "NwOutRate": 0.0, "PnwOutRate": 0.0,
             "Replicas": 0, "Leaders": 0, "_n": 0},
        )
        agg["DiskMB"] += stats.disk_mb
        agg["CpuPct"] += stats.cpu_pct
        agg["LeaderNwInRate"] += stats.leader_nw_in_rate
        agg["FollowerNwInRate"] += stats.follower_nw_in_rate
        agg["NwOutRate"] += stats.nw_out_rate
        agg["PnwOutRate"] += stats.pnw_out_rate
        agg["Replicas"] += stats.replicas
        agg["Leaders"] += stats.leaders
        agg["_n"] += 1
    hosts = []
    for h in sorted(host_agg):
        entry = dict(host_agg[h])
        n = entry.pop("_n")
        entry["CpuPct"] = round(entry["CpuPct"] / max(n, 1), 3)  # host CPU = mean of brokers
        for k in ("DiskMB", "LeaderNwInRate", "FollowerNwInRate", "NwOutRate", "PnwOutRate"):
            entry[k] = round(entry[k], 3)
        hosts.append(entry)
    return BrokerStats(hosts=hosts, brokers=brokers)


def optimization_result_response(result, load_before: Optional[BrokerStats],
                                 load_after: Optional[BrokerStats],
                                 max_proposals: int = 10_000) -> Dict:
    """OptimizationResult.java (:32-42): summary + per-goal status
    (VIOLATED / FIXED / NO-ACTION) + proposals + before/after load."""
    from cruise_control_torch.analyzer.stats import stats_to_dict

    goal_summaries = []
    for g in result.goal_results:
        if g.violated_brokers_after > 0:
            status = "VIOLATED"
        elif g.violated_brokers_before > 0:
            status = "FIXED"
        else:
            status = "NO-ACTION"
        goal_summaries.append(
            {
                "goal": g.name,
                "status": status,
                "clusterModelStats": {
                    "violatedBrokersBefore": g.violated_brokers_before,
                    "violatedBrokersAfter": g.violated_brokers_after,
                    "costBefore": g.cost_before,
                    "costAfter": g.cost_after,
                    "rounds": g.rounds,
                },
            }
        )
    out = {
        "summary": {
            "numReplicaMovements": result.num_replica_moves,
            "numLeaderMovements": result.num_leadership_moves,
            "dataToMoveMB": round(result.data_to_move_mb, 3),
            "violatedGoalsBefore": result.violated_goals_before,
            "violatedGoalsAfter": result.violated_goals_after,
            "onDemandBalancednessScoreBefore": stats_to_dict(result.stats_before),
            "onDemandBalancednessScoreAfter": stats_to_dict(result.stats_after),
            "durationS": round(result.duration_s, 4),
            # GET /explain join key: every proposal in this response is
            # answerable as /explain?run=<id>&partition=<p>
            **(
                {"provenanceRun": result.provenance.run_id}
                if getattr(result, "provenance", None) is not None
                else {}
            ),
        },
        "goalSummary": goal_summaries,
        "proposals": [p.to_dict() for p in result.proposals[:max_proposals]],
        "version": JSON_VERSION,
    }
    if load_before is not None:
        out["loadBeforeOptimization"] = load_before.to_dict()
    if load_after is not None:
        out["loadAfterOptimization"] = load_after.to_dict()
    return out


# PartitionLoadState.java records are built inline by the /partition_load
# handler (servlet.server) with the same topic/partition/leader/followers keys.
