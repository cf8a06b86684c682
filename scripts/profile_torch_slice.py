"""Where the time of the PyTorch port's solves goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_slice.py [--path hard|stack|service|bench|greedy|all]
                                           [--out build/profile_torch_slice.json]

Builds the CUDA kernels and, for each solve asked for (on the smoke model of
chip_smoke.py: the six hard goals with SLICE_SETTINGS, the full 15-goal
stack with STACK_SETTINGS, the same stack as the service runs it with
SERVICE_SETTINGS: the chunked goal machine, the provenance ledger and the
cluster statistics on the model padded to its shape bucket (the second
solve reuses the first's prep-cache entry); and chip_smoke.py's phases 8
and 9: BASELINE config 5
with the bench's batched pass, BENCH_SETTINGS, and the bench's 520-broker
parity model with its faithful-greedy pass, GREEDY_SETTINGS; all five by
default), solves once as a warm-up, then:
  1. once more with a synchronize after every goal, for each goal's wall time
     (the chunked solves: their per-goal times as `_run_chunked` measures
     them, each call's wall shared out by the goals' rounds);
  2. once under torch.profiler (CPU and CUDA activities), for the device's
     busy time by kernel, the idle share of the solve's wall time, the number
     of kernel launches and of host reads of device values, each hand kernel
     wrapper's host time (every wrapper the analyzer calls runs inside a
     `torch.profiler.record_function` span named after it, put around it by
     this script alone) and K3's and K5's launches by path;
and times the set-up before the goal loops and the proposal diff after them.
Prints a summary and writes the numbers as JSON to --out. Needs a GPU; exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

#: our kernels' __global__ functions (csrc/*.cu), by kernel
OWN_KERNELS = {
    "k_seg_runs": "K1 segment_aggregates", "k_seg_sums": "K1 segment_aggregates",
    "k_seg_host": "K1 segment_aggregates", "k_seg_racks": "K1 segment_aggregates",
    "k_topk_runs": "K2 broker_topk",
    "k_topk_select": "K2 broker_topk",
    "k_score_cells": "K3 score_candidates", "k_score_tiles": "K3 score_candidates",
    "k_score_flat": "K3 score_candidates",
    "k_apply_wave": "K4 apply_wave", "k_apply_wave_wide": "K4 apply_wave",
    "k_score_swaps": "K5 score_swaps", "k_swap_staged": "K5 score_swaps",
    "k_pair_rows": "K6 pair_picks", "k_pair_pass": "K6 pair_picks",
    "k_pair_take": "K6 pair_picks", "k_window_sum": "window_sum",
    "k_state_fingerprint": "K7 state_fingerprint", "k_cluster_stats": "K8 cluster_stats",
    "k_grid_bid": "K9 grid_shortlist",
    "k_grid_take": "K9 grid_shortlist", "k_delta_scatter": "K10 delta_scatter",
    "k_elect_preferred": "K11 elect_preferred", "k_elect_wide": "K11 elect_preferred",
    "k_merge_bits": "K11 elect_preferred", "k_shard_merge": "K12 shard_merge",
    "k_partition_stats": "K13 partition_stats",
}
#: the chunked solves, whose per-goal times come from the solve itself
CHUNKED = ("service", "bench", "greedy")
#: the record_function span around a hand kernel wrapper
SPAN = "wrapper::"


def wrap_wrappers() -> list:
    """Run every hand kernel wrapper that a module of the port calls inside a
    record_function span named after it; returns what `unwrap` puts back.
    The wrappers count their launches on themselves, so the counts stay where
    they were."""
    from cruise_control_torch import kernels

    def spanned(name, fn):
        def call(*args, **kw):
            with torch.profiler.record_function(SPAN + name):
                return fn(*args, **kw)
        call.spanned = fn
        return call

    wrappers = kernels.wrappers()
    done = []
    for mod in [m for n, m in sys.modules.items() if n.startswith("cruise_control_torch.")]:
        if mod is None or mod.__name__.startswith("cruise_control_torch.kernels"):
            continue
        for name, fn in wrappers.items():
            if getattr(mod, name, None) is fn:
                setattr(mod, name, spanned(name, fn))
                done.append((mod, name, fn))
    return done


def unwrap(done: list) -> None:
    for mod, name, fn in done:
        setattr(mod, name, fn)


def _is_device_event(evt) -> bool:
    """A kernel, memset or memcpy on the card (CPU-side ops also report the
    device time of what they launched; counting those would count twice)."""
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def _short(name: str) -> str:
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].split("<")[0]


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile(path: str, model, opt) -> dict:
    """The numbers of one solve (`path` "hard", "stack", "service", "bench"
    or "greedy") of `model`."""
    from cruise_control_torch.analyzer.acceptance import empty_tables
    from cruise_control_torch.analyzer.context import build_static_ctx, compute_aggregates, dims_of
    from cruise_control_torch.analyzer.goals import HARD_GOAL_NAMES, goals_by_priority
    from cruise_control_torch.analyzer.proposals import proposal_diff
    from cruise_control_torch.config.balancing import BalancingConstraint

    settings = {"hard": opt.SLICE_SETTINGS, "stack": opt.STACK_SETTINGS,
                "service": opt.SERVICE_SETTINGS, "bench": opt.BENCH_SETTINGS,
                "greedy": opt.GREEDY_SETTINGS}[path]
    names = HARD_GOAL_NAMES if path == "hard" else None
    optimizer = opt.GoalOptimizer(device="cuda", settings=settings)

    def solve():
        t0 = time.monotonic()
        res = optimizer.optimizations(model, names, raise_on_hard_failure=False)
        torch.cuda.synchronize()
        return res, time.monotonic() - t0

    res, warm_s = solve()
    _, wall_s = solve()

    # the host-side parts of a solve around the goal loops
    t0 = time.monotonic()
    proposal_diff(model.assignment.numpy(), res.final_assignment, model.part_load.numpy())
    diff_s = time.monotonic() - t0

    # 1. per-goal wall time, synchronizing at each goal boundary
    torch.cuda.synchronize()
    t0 = time.monotonic()
    gpu = model.to("cuda")
    dims = dims_of(gpu)
    static = build_static_ctx(gpu, BalancingConstraint.default(), dims)
    agg = compute_aggregates(static, gpu.assignment, dims)
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    tables = empty_tables(dims, gpu.device)
    per_goal = {}
    if path in CHUNKED:
        per_goal = {g.name: {"wall_s": g.duration_s, "rounds": g.rounds,
                             "engine": opt.goal_engine(goals_by_priority([g.name])[0], dims,
                                                       settings)}
                    for g in res.goal_results}
    for goal in goals_by_priority(names) if path not in CHUNKED else ():
        loop = opt._make_goal_loop(goal, dims, settings)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        agg, rounds, _ = loop(static, agg, tables)
        torch.cuda.synchronize()
        per_goal[goal.name] = {"wall_s": time.monotonic() - t0, "rounds": rounds,
                               "engine": opt.goal_engine(goal, dims, settings)}
        tables = goal.contribute_acceptance(static, goal.prepare(static, agg, dims), tables)

    # 2. one traced solve
    from cruise_control_torch.kernels import score_candidates as k3
    from cruise_control_torch.kernels import score_swaps as k5

    paths = getattr(k3.score_candidates, "paths", None)
    k5_counts = getattr(k5.score_swaps, "paths", None)
    for counter in (paths, k5_counts):
        if counter is not None:
            counter.clear()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    spans = wrap_wrappers()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            _, traced_s = solve()
    finally:
        unwrap(spans)
    k3_paths = dict(paths) if paths is not None else None
    k5_paths = dict(k5_counts) if k5_counts is not None else None
    by_kernel = collections.Counter()
    launches = collections.Counter()
    busy_us = 0.0
    host = {}
    glue = collections.Counter()
    wrapper_host = {}
    for evt in prof.key_averages():
        if evt.key.startswith(SPAN):
            # a span has a host entry and, where it launched work, a device
            # one of the same name; the host one is the wrapper's host time
            if not _is_device_event(evt):
                wrapper_host[evt.key[len(SPAN):]] = {
                    "calls": evt.count, "host_s": float(evt.cpu_time_total) / 1e6,
                    "host_us_per_call": float(evt.cpu_time_total) / max(evt.count, 1)}
            continue
        us = _device_us(evt)
        if _is_device_event(evt):
            busy_us += us
            group = OWN_KERNELS.get(_short(evt.key), "PyTorch glue kernels")
            by_kernel[group] += us
            launches[group] += evt.count
            if group == "PyTorch glue kernels":
                glue[_short(evt.key)] += us
        if evt.key in ("cudaLaunchKernel", "aten::_local_scalar_dense", "cudaStreamSynchronize",
                       "cudaMemcpyAsync", "cudaMemsetAsync"):
            host[evt.key] = {"count": evt.count, "cpu_us": float(evt.cpu_time_total)}
    out = {
        "warmup_solve_s": warm_s, "solve_s": wall_s, "traced_solve_s": traced_s,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": (1.0 - busy_us / 1e6 / traced_s) if traced_s > 0 else None,
        "device_s_by_group": {k: v / 1e6 for k, v in by_kernel.most_common()},
        "device_launches_by_group": dict(launches),
        "host_calls": host, "per_goal": per_goal,
        "replica_moves": res.num_replica_moves, "leadership_moves": res.num_leadership_moves,
        "glue_device_s_by_kernel": {k: v / 1e6 for k, v in glue.most_common(15)},
        "setup_s": setup_s, "proposal_diff_s": diff_s,
        "wrapper_host": wrapper_host, "k3_launches_by_path": k3_paths,
        "k5_launches_by_path": k5_paths,
    }
    print(f"[{path}] solve {wall_s:.3f} s (warm-up {warm_s:.3f} s, traced {traced_s:.3f} s); "
          f"device busy {out['device_busy_s']:.3f} s, idle share {out['device_idle_share']:.3f}")
    for k, v in out["device_s_by_group"].items():
        print(f"  {k:36s} {v:9.4f} s  {launches[k]:7d} launches")
    for k, v in out["glue_device_s_by_kernel"].items():
        print(f"    glue {k[:60]:60s} {v:9.4f} s")
    for k, v in sorted(wrapper_host.items(), key=lambda kv: -kv[1]["host_s"]):
        print(f"  wrapper {k:30s} {v['calls']:7d} calls  {v['host_s']:8.4f} s host "
              f"({v['host_us_per_call']:.2f} us a call, traced)")
    print(f"  K3 launches by path {k3_paths}, K5 {k5_paths}")
    print(f"  set-up (model to the card, static context, K1) {setup_s:.3f} s; "
          f"proposal diff {diff_s:.3f} s")
    for k, v in per_goal.items():
        print(f"  goal {k:36s} {v['wall_s']:8.3f} s  {v['rounds']:3d} rounds  {v['engine']}")
    for k, v in host.items():
        print(f"  host {k:30s} {v['count']:8d} calls  {v['cpu_us'] / 1e6:8.3f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--path", choices=("hard", "stack", "service", "bench", "greedy", "all"),
                    default="all")
    ap.add_argument("--out", default=str(ROOT / "build" / "profile_torch_slice.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_slice: needs an NVIDIA GPU")
    from cruise_control_torch.analyzer import optimizer as opt
    from cruise_control_torch.kernels import build
    from cruise_control_torch.models import generators

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    build.build_all()
    prop = dataclasses.replace(generators.BASELINE_CONFIGS[5], num_dead_brokers=26,
                               load_distribution="pareto", mean_utilization=0.5)
    models = {"smoke": generators.random_cluster(42, prop),
              "bench": generators.random_cluster(42, generators.BASELINE_CONFIGS[5]),
              # bench.py:596-604, the config-5 parity model
              "greedy": generators.random_cluster(47, generators.ClusterProperty(
                  num_racks=52, num_brokers=520, num_topics=800, mean_partitions_per_topic=50.0,
                  replication_factor=3, load_distribution="exponential"))}
    paths = ("hard", "stack", "service", "bench", "greedy") if args.path == "all" else (
        args.path,)
    out = {"card": card}
    for path in paths:
        out[path] = profile(path, models.get(path, models["smoke"]), opt)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(json.dumps({p: {"device_busy_s": out[p]["device_busy_s"],
                          "device_idle_share": out[p]["device_idle_share"],
                          "solve_s": out[p]["solve_s"]} for p in paths}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
