"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU fallback):
  1. device: the card's name and power limit, torch and CUDA versions;
  2. build: compile the seven CUDA kernels from cruise_control_torch/csrc,
     one nvcc per source, all at once;
  3. kernels: run each kernel on the card at the shapes the two solves give
     it, on the smoke model's own state, and hold it against its plain
     PyTorch version run on a CPU copy of the same inputs (integers exact,
     floats bit-equal, finite masks exact); time each on the card over a run
     of back-to-back calls, as device time from a profiler trace and as time
     per call from CUDA events, and its plain version from CUDA events:
       K1 segment_aggregates, K2 broker_topk, K3 score_candidates (a hard
       goal's [512, 8, 64] drain grid, the [P, 2] promotion grid and a soft
       goal's drain grid), K4 apply_wave (a 1,024-entry drain wave and a
       2,600-entry two-leg relay wave), K5 score_swaps (the [128, 128, 8, 8]
       replica-swap grid and the [512, 4, 2, 8, 2] relay grid), K6 pair_picks
       (512 surplus pairs), window_sum (the brokers' leader bytes-in);
  4. hard goals: the self-healing proposal of the six hard goals through
     GoalOptimizer(device="cuda", settings=SLICE_SETTINGS);
  5. stack: the full 15-goal rebalance proposal through
     GoalOptimizer(device="cuda", settings=STACK_SETTINGS).
  Around each solve every kernel's launch count is set to 0 and read after;
  each kernel of the solve's path must have launched, and the result must
  hold: no replica left on a dead broker, no goal worse than before,
  sanity_check, the proposals replay to the final assignment. The solves'
  per-goal tables are printed beside the JAX package's CPU run of the same
  recipe; a difference is printed, not failed on.
The smoke model is BASELINE config 5's cluster (2,600 brokers, 52 racks,
4,000 topics, ~200k partitions at RF 3) with config 3's pareto load at mean
utilisation 0.5 and 26 dead brokers, from seed 42.

The last two lines are a JSON object of per-kernel numbers and the final
`{"ok": true, "device": {...}}` line.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

#: The card's memory rate and float32 rate outside the tensor cores (H100
#: SXM data sheet), for the bound. Integer and compare operations are
#: counted at the float32 rate too.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
SEED = 42
#: calls before a timed run, and calls in it
WARMUP, REPS = 3, 30

#: The JAX package's run of the same recipe and settings on a CPU, printed
#: beside the card's numbers as the reference the port should reproduce:
#: goal -> (violated before, after, rounds, converged, cost before, after).
JAX_CPU_REFERENCE = {
    "RackAwareGoal": (0, 0, 37, True, 0.0, 0.0),
    "ReplicaCapacityGoal": (0, 0, 1, True, 0.0, 0.0),
    "DiskCapacityGoal": (108, 30, 40, True, 5.69e7, 3.20e7),
    "NetworkInboundCapacityGoal": (143, 28, 64, False, 6.85e6, 3.83e6),
    "NetworkOutboundCapacityGoal": (11, 8, 13, True, 1.79e6, 1.66e6),
    "CpuCapacityGoal": (144, 42, 64, False, 12253.0, 5751.0),
}
JAX_CPU_MOVES = {"replica": 27630, "leadership": 1577}
#: The same for the full default stack with the stack settings.
JAX_CPU_STACK_REFERENCE = {
    **JAX_CPU_REFERENCE,
    "ReplicaDistributionGoal": (759, 258, 64, False, 2.506e4, 1.948e4),
    "PotentialNwOutGoal": (133, 41, 64, False, 7.651e6, 5.661e6),
    "DiskUsageDistributionGoal": (1881, 512, 64, False, 186.8, 81.56),
    "NetworkInboundUsageDistributionGoal": (1856, 905, 64, False, 191.2, 121.8),
    "NetworkOutboundUsageDistributionGoal": (2108, 188, 64, False, 130.0, 46.37),
    "CpuUsageDistributionGoal": (1847, 400, 64, False, 196.7, 84.93),
    "TopicReplicaDistributionGoal": (2496, 1318, 64, False, 1.764e4, 6986.0),
    "LeaderReplicaDistributionGoal": (1430, 978, 38, True, 2.678e4, 2.273e4),
    "LeaderBytesInDistributionGoal": (798, 600, 64, False, 7.063e6, 6.047e6),
}
JAX_CPU_STACK_MOVES = {"replica": 50949, "leadership": 19618}
#: the kernels of each solve's path
HARD_PATH = ("segment_aggregates", "broker_topk", "score_candidates", "apply_wave")
STACK_PATH = HARD_PATH + ("score_swaps", "pair_picks", "window_sum")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else ""


def time_ms(call, reps: int = REPS) -> float:
    """Milliseconds per call: one CUDA event pair around `reps` back-to-back
    calls, after WARMUP calls. `call(i)` is given the call's number (0 ..
    WARMUP + reps - 1). A call whose host work outlasts its device work is
    timed at its host rate: this is what a caller pays per call."""
    for i in range(WARMUP):
        call(i)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(reps):
        call(WARMUP + i)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(call, reps: int = REPS):
    """Device milliseconds per call of everything `call` launches (kernels,
    copies, memsets), summed from a torch.profiler trace of `reps` calls
    after WARMUP calls; the host's share of a call is left out. None when the
    trace holds no device time."""
    for i in range(WARMUP):
        call(i)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(reps):
            call(WARMUP + i)
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        # CPU-side ops also report the device time of what they launched
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us += float(getattr(evt, "self_device_time_total",
                                getattr(evt, "self_cuda_time_total", 0.0)))
    return us / reps / 1e3 if us > 0 else None


def bits_equal(x: torch.Tensor, y: torch.Tensor) -> bool:
    x, y = x.detach().cpu().contiguous(), y.detach().cpu().contiguous()
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if x.dtype == torch.float32:
        return torch.equal(x.view(torch.int32), y.view(torch.int32))
    return torch.equal(x, y)


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> float:
    """Largest |x - y| where both are finite (integers and flags included)."""
    x, y = x.detach().cpu().double(), y.detach().cpu().double()
    both = torch.isfinite(x) & torch.isfinite(y)
    if not both.any():
        return 0.0
    return float((x[both] - y[both]).abs().max())


def main() -> int:
    t_start = time.monotonic()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    from cruise_control_torch import kernels
    from cruise_control_torch.analyzer import optimizer as opt
    from cruise_control_torch.analyzer.acceptance import build_tables
    from cruise_control_torch.analyzer.actions import KIND_MOVE, leadership_grid
    from cruise_control_torch.analyzer.context import (
        build_static_ctx,
        compute_aggregates,
        dims_of,
        replicas_on_dead,
    )
    from cruise_control_torch.analyzer.drain import (
        heavy_picks,
        rack_diverse_cold,
        relay_grid,
        select_surplus_pairs,
        top_k,
    )
    from cruise_control_torch.analyzer.goals import HARD_GOAL_NAMES, goals_by_priority
    from cruise_control_torch.analyzer.swaps import swap_grid
    from cruise_control_torch.config.balancing import BalancingConstraint
    from cruise_control_torch.kernels import build
    from cruise_control_torch.kernels.apply_wave import apply_wave, apply_wave_plain
    from cruise_control_torch.kernels.broker_topk import broker_topk, broker_topk_plain
    from cruise_control_torch.kernels.pair_picks import pair_picks, pair_picks_plain
    from cruise_control_torch.kernels.score_swaps import (
        LEADERSHIP_RELAY,
        REPLICA_SWAP,
        score_swaps,
        score_swaps_plain,
    )
    from cruise_control_torch.kernels.window_sum import window_sum, window_sum_plain
    from cruise_control_torch.kernels.score_candidates import (
        score_candidates,
        score_candidates_plain,
    )
    from cruise_control_torch.kernels.segment_aggregates import (
        segment_aggregates,
        segment_aggregates_plain,
    )
    from cruise_control_torch.models import generators
    from cruise_control_torch.models.flat_model import sanity_check

    # -- 1. device -----------------------------------------------------------
    smi = nvidia_smi_line()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"device: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # -- 2. build --------------------------------------------------------------
    build_s = build.build_all()
    print(f"build: {len(build.KERNEL_SOURCES)} kernels in {build_s:.2f} s (set-up time)")

    # -- 3. kernels at the slice's shapes --------------------------------------
    prop = dataclasses.replace(generators.BASELINE_CONFIGS[5], num_dead_brokers=26,
                               load_distribution="pareto", mean_utilization=0.5)
    t0 = time.monotonic()
    model_cpu = generators.random_cluster(SEED, prop)
    print(f"model: {model_cpu.num_brokers} brokers, {model_cpu.num_partitions} partitions, "
          f"RF {model_cpu.max_replication_factor}, "
          f"{int((model_cpu.broker_state == 3).sum())} dead "
          f"(generated in {time.monotonic() - t0:.1f} s)")
    model = model_cpu.to(dev)
    dims = dims_of(model_cpu)
    constraint = BalancingConstraint.default()
    st_g = build_static_ctx(model, constraint, dims)
    st_c = build_static_ctx(model_cpu, constraint, dims)
    p_count, r = dims.num_partitions, dims.max_rf
    rows = {}

    def bound(nbytes, nops):
        """(ms, by): the larger of the byte time and the operation time."""
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def row(key, route_src, replaces, out_cmp, call, plain, nbytes, nops, note, library=None):
        """The kernel's JSON row. `ms` is the device time per call of what
        the wrapper launches; `call_ms` the time per call of back-to-back
        wrapper calls, host work included; `plain_ms` the same for the plain
        version on the card; `library_ms` the same for the one PyTorch call
        that computes the same function, where there is one."""
        ms, call_ms, plain_ms = device_ms(call), time_ms(call), time_ms(plain)
        library_ms = time_ms(library) if library is not None else None
        if ms is None:
            print(f"{key}: the profiler trace holds no device time; ms is the CUDA-event time")
            ms = call_ms
        bound_ms, bound_by = bound(nbytes, nops)
        rows[key] = {
            "name": key, "route": "cuda", "source": f"cruise_control_torch/csrc/{route_src}",
            "replaces": replaces, "launches": 0, "max_abs_err": out_cmp, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "call_ms": call_ms, "note": note,
        }
        return rows[key]

    # K1
    k1_args_g = (model.assignment, st_g.part_load, st_g.topic_id, st_g.broker_rack,
                 st_g.broker_host, dims.num_brokers, dims.num_racks, dims.num_hosts,
                 dims.num_topics)
    k1_args_c = (model_cpu.assignment, st_c.part_load, st_c.topic_id, st_c.broker_rack,
                 st_c.broker_host, dims.num_brokers, dims.num_racks, dims.num_hosts,
                 dims.num_topics)
    out_g = segment_aggregates(*k1_args_g)
    torch.cuda.synchronize()
    out_c = segment_aggregates_plain(*k1_args_c)
    names = ("broker_load", "replica_count", "leader_count", "potential_nw_out",
             "leader_nw_in", "rack_replica_count", "topic_replica_count", "host_cpu_load")
    for n_, a_, b_ in zip(names, out_g, out_c):
        if not bits_equal(a_, b_):
            fail(f"K1 segment_aggregates: {n_} differs from the plain version")
    k1_bytes = (model_cpu.assignment.numel() * 4 + model_cpu.part_load.numel() * 4
                + p_count * 4 + dims.num_brokers * 8 + sum(t.numel() * 4 for t in out_c))
    # per slot: 4 load adds, potential NW_OUT, leader NW_IN, 4 counts
    row("segment_aggregates", "segment_aggregates.cu", "cruise_control_tpu/analyzer/context.py:276",
        max(max_abs_err(a_, b_) for a_, b_ in zip(out_g, out_c)),
        lambda i: segment_aggregates(*k1_args_g), lambda i: segment_aggregates_plain(*k1_args_g),
        k1_bytes, p_count * r * 10 + dims.num_brokers,
        "one thread per broker sums its stable-sorted slots in order; the wrapper's sort included")
    print("K1 segment_aggregates: bit-equal to the plain version")

    agg_g = compute_aggregates(st_g, model.assignment, dims)
    agg_c = compute_aggregates(st_c, model_cpu.assignment, dims)
    goals = goals_by_priority(None)
    by_name = {g.name: g for g in goals}
    disk_goal, cpu_goal = by_name["DiskCapacityGoal"], by_name["CpuCapacityGoal"]

    def priors(goal, st, agg):
        """The merged tables of the goals before `goal` in the stack."""
        return build_tables(goals[:goals.index(goal)], st, agg, dims)

    def drain_contrib(goal, st, agg):
        gs = goal.prepare(st, agg, dims)
        c = goal.drain_contrib(st, gs, agg)
        return torch.where(replicas_on_dead(st, agg.assignment),
                           torch.tensor(1e9, dtype=torch.float32, device=c.device), c).contiguous()

    # K2 on DiskCapacityGoal's first-round drain priorities
    def disk_contrib(st, agg):
        return drain_contrib(disk_goal, st, agg)

    con_g, con_c = disk_contrib(st_g, agg_g), disk_contrib(st_c, agg_c)
    k2_g = broker_topk(con_g, agg_g.assignment, st_g.movable_partition, 8, dims.num_brokers)
    k2_c = broker_topk_plain(con_c, agg_c.assignment, st_c.movable_partition, 8, dims.num_brokers)
    for n_, a_, b_ in zip(("p", "slot", "valid"), k2_g, k2_c):
        if not bits_equal(a_, b_):
            fail(f"K2 broker_topk: {n_} differs from the plain version")
    # per pass and slot: one compare and one select
    row("broker_topk", "broker_topk.cu", "cruise_control_tpu/analyzer/drain.py:74",
        max(max_abs_err(a_, b_) for a_, b_ in zip(k2_g, k2_c)),
        lambda i: broker_topk(con_g, agg_g.assignment, st_g.movable_partition, 8,
                              dims.num_brokers),
        lambda i: broker_topk_plain(con_g, agg_g.assignment, st_g.movable_partition, 8,
                                    dims.num_brokers),
        p_count * r * 8 + p_count + dims.num_brokers * 8 * 9, 8 * p_count * r * 2,
        "k = 8 passes, each an atomicMax bid per slot and a decode per broker")
    print("K2 broker_topk: exact")

    # K3 on DiskCapacityGoal's first-round [512, 8, 64] move grid and the
    # [P, 2] promotion grid under CpuCapacityGoal
    def drain_grid(goal, st, agg):
        """The goal's first-round [512, 8, 64] drain grid (drain.make_drain_round)."""
        gs = goal.prepare(st, agg, dims)
        tables = priors(goal, st, agg)
        rank = goal.src_rank(st, gs, agg)
        rank = torch.where(st.dead, torch.tensor(torch.inf, device=rank.device), rank)
        _, hot = top_k(rank, 512)
        cp, cs, _ = heavy_picks(st, agg, drain_contrib(goal, st, agg), hot, 8, dims.num_brokers)
        cold = rack_diverse_cold(st, gs, agg, goal, tables, dims, 64)
        kind = torch.tensor(KIND_MOVE, dtype=torch.int32, device=rank.device)
        return (st, agg, tables, goal, gs, cp[:, :, None], kind, cs[:, :, None],
                cold[None, None, :].to(torch.int32))

    def disk_grid(st, agg):
        return drain_grid(disk_goal, st, agg)

    def soft_grid(st, agg):
        return drain_grid(by_name["CpuUsageDistributionGoal"], st, agg)

    def lead_grid(st, agg):
        tables = priors(cpu_goal, st, agg)
        gs = cpu_goal.prepare(st, agg, dims)
        return (st, agg, tables, cpu_goal, gs, *leadership_grid(agg.assignment))

    k3_rows = []
    for label, make, grid_goal in (("move grid", disk_grid, disk_goal),
                                   ("promotion grid", lead_grid, cpu_goal),
                                   ("soft move grid", soft_grid,
                                    by_name["CpuUsageDistributionGoal"])):
        args_g, args_c = make(st_g, agg_g), make(st_c, agg_c)
        s_g = score_candidates(*args_g)
        s_c = score_candidates_plain(*args_c)
        torch.cuda.synchronize()
        s_g_c = s_g.cpu()
        if not torch.equal(torch.isfinite(s_g_c), torch.isfinite(s_c)):
            fail(f"K3 score_candidates ({label}): finite masks differ")
        fin = torch.isfinite(s_c)
        if not bits_equal(s_g_c[fin], s_c[fin]):
            fail(f"K3 score_candidates ({label}): scores differ")
        idx = args_c[5:]
        shape = s_c.shape
        parts = torch.unique(idx[0].expand(shape).reshape(-1)).numel()
        brokers = dims.num_brokers if label == "promotion grid" else min(
            dims.num_brokers, 512 + 64)
        if label == "soft move grid" and not bool(args_c[2].band_on.any()):
            fail("K3 score_candidates (soft move grid): the priors' usage bands are off")
        nbytes = (sum(t.numel() * 4 for t in idx if t.dim()) + s_c.numel() * 4
                  + parts * (r * 4 + 24 + 4 + 8) + brokers * 168)
        # ~100 operations per candidate (csrc/score_candidates.cu)
        k3_rows.append(dict(label=label, err=max_abs_err(s_g_c, s_c),
                            call=lambda i, a=args_g: score_candidates(*a),
                            plain=lambda i, a=args_g: score_candidates_plain(*a),
                            nbytes=nbytes, nops=100 * s_c.numel(), cells=s_c.numel()))
        print(f"K3 score_candidates ({label}, {tuple(shape)}): {int(fin.sum())} finite of "
              f"{s_c.numel()}, masks exact")
    # the JSON row carries the hard goal's move grid; the others are printed
    err3 = max(x["err"] for x in k3_rows)
    for x, key in zip(k3_rows, ("score_candidates", "score_candidates promotion grid",
                                "score_candidates soft move grid")):
        rw = row(key, "score_candidates.cu", "cruise_control_tpu/analyzer/acceptance.py:330",
                 err3, x["call"], x["plain"], x["nbytes"], x["nops"],
                 f"one thread per candidate, {x['label']} of {x['cells']} cells")
        if key != "score_candidates":
            rows.pop(key)
            print(f"K3 score_candidates on the {x['label']}: {rw['ms']:.4f} ms on the device, "
                  f"{rw['call_ms']:.4f} ms per call, plain {rw['plain_ms']:.4f} ms, bound "
                  f"{rw['bound_ms']:.6f} ms by {rw['bound_by']}")

    # K4 on a 1,024-entry wave: each move-grid row's best cell (512) and the
    # 512 best promotions of the CPU grid
    def wave(st, agg):
        a = disk_grid(st, agg)
        s = score_candidates_plain(*a) if agg.assignment.device.type == "cpu" else score_candidates(*a)
        v, k, c = s.shape
        cells = s.reshape(v, k * c)
        # a first wave's nominations: each row's best candidate toward its
        # own rotated destination column (drain.make_drain_round)
        rows0 = torch.arange(v, device=s.device)
        c_i = rows0 % c
        ci = torch.argmax(s[rows0, :, c_i], dim=1) * c + c_i
        cp, cs, dst = a[5][:, :, 0], a[7][:, :, 0], a[8].reshape(-1)
        l = lead_grid(st, agg)
        ls = score_candidates_plain(*l) if agg.assignment.device.type == "cpu" else score_candidates(*l)
        ls0, li = top_k(ls.reshape(-1), 1024 - v)
        lp = (li // (r - 1)).to(torch.int32)
        lslot = (li % (r - 1)).to(torch.int32) + 1
        ldst = agg.assignment[lp.long(), lslot.long()]
        p_ = torch.cat([cp[rows0, ci // c], lp])
        kind = torch.cat([torch.zeros(v, dtype=torch.int32, device=ci.device),
                          torch.ones(1024 - v, dtype=torch.int32, device=ci.device)])
        slot = torch.cat([cs[rows0, ci // c], lslot])
        d_ = torch.cat([dst[ci % c], ldst])
        score = torch.cat([cells[rows0, ci], ls0])
        return p_, kind, slot, d_, score, torch.isfinite(score)

    w_g, w_c = wave(st_g, agg_g), wave(st_c, agg_c)
    for n_, a_, b_ in zip(("p", "kind", "slot", "dst", "ok"), w_g[:4] + w_g[5:], w_c[:4] + w_c[5:]):
        if not bits_equal(a_, b_):
            fail(f"K4 inputs: {n_} differs between the card and the CPU")

    def clone(agg):
        return type(agg)(*(t.clone() for t in agg))

    a4_g, a4_c = clone(agg_g), clone(agg_c)
    sel_g = apply_wave(st_g, a4_g, *w_g[:4], w_c[4].to(dev), w_g[5], 7)
    sel_c = apply_wave_plain(st_c, a4_c, *w_c, 7)
    torch.cuda.synchronize()
    if not bits_equal(sel_g, sel_c):
        fail("K4 apply_wave: selection differs from the plain version")
    for n_, a_, b_ in zip(a4_c._fields, a4_g, a4_c):
        if not bits_equal(a_, b_):
            fail(f"K4 apply_wave: applied {n_} differs from the plain version")
    n_sel = int(sel_c.sum())
    k4_err = max([max_abs_err(sel_g, sel_c)] + [max_abs_err(a_, b_) for a_, b_ in zip(a4_g, a4_c)])
    score_g = w_c[4].to(dev)
    # each call applies the wave to a fresh copy of the aggregates: a pool of
    # copies is made before each timed run, outside it
    pool = []

    def k4_call(fn):
        def call(i):
            if i == 0:
                pool[:] = [clone(agg_g) for _ in range(WARMUP + REPS)]
                torch.cuda.synchronize()
            return fn(st_g, pool[i], *w_g[:4], score_g, w_g[5], 7)
        return call

    k4_bytes = 1024 * (4 * 4 + 4 + 1 + 1) + 1024 * (r * 4 * 2 + 24) + n_sel * (2 * r * 4 * 2 + 2 * 56)
    # per entry: the four selection stages' scatter-max / scatter-min and
    # group claims, and its share of the applies
    rw = row("apply_wave drain wave", "apply_wave.cu", "cruise_control_tpu/analyzer/context.py:425",
             k4_err, k4_call(apply_wave), k4_call(apply_wave_plain), k4_bytes, 1024 * 60,
             "one block of 1,024 threads: dependent O(N^2) stages with barriers")
    rows.pop("apply_wave drain wave")
    pool.clear()
    print(f"K4 apply_wave: 1,024-entry drain wave, {n_sel} selected, selection and every "
          f"aggregate bit-equal; {rw['ms']:.4f} ms on the device, {rw['call_ms']:.4f} ms per "
          f"call, plain {rw['plain_ms']:.4f} ms, bound {rw['bound_ms']:.6f} ms")

    # K4 on a 2,600-entry two-leg wave in the relay form (two promotions per
    # entry, three brokers, two hosts and two partitions claimed), seeded on
    # the smoke state with integer scores to force ties. As in every relay,
    # leg 2 promotes a partition led by leg 1's destination d.
    rng = np.random.default_rng(SEED)
    a_np = model_cpu.assignment.numpy()
    n4 = 2600
    led_by = np.argsort(a_np[:, 0], kind="stable")
    first = np.searchsorted(a_np[led_by, 0], np.arange(dims.num_brokers + 1))
    lp1, ls1 = rng.integers(0, p_count, n4), rng.integers(1, r, n4)
    d_np = a_np[lp1, ls1]
    d0 = np.maximum(d_np, 0)
    n_led = first[d0 + 1] - first[d0]
    lp2 = led_by[np.minimum(first[d0] + (rng.random(n4) * n_led).astype(np.int64), p_count - 1)]
    ls2 = rng.integers(1, r, n4)
    e_np = a_np[lp2, ls2]
    ok_np = ((d_np >= 0) & (n_led > 0) & (a_np[lp2, 0] == d_np) & (e_np >= 0)
             & (a_np[lp1, 0] >= 0) & (a_np[lp1, 0] != d_np) & (lp1 != lp2)
             & (rng.random(n4) < 0.9))
    lead = np.full(n4, 1, dtype=np.int32)
    relay_c = [torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32))
               for x in (lp1, lead, ls1, d_np, lp2, lead, ls2, e_np)]
    relay_c += [torch.from_numpy(rng.integers(0, 8, n4).astype(np.float32)),
                torch.from_numpy(ok_np)]
    relay_g = [t.to(dev) for t in relay_c]

    def relay_wave(fn, st, agg, w):
        return fn(st, agg, *w[:4], w[8], w[9], 7, leg2=tuple(w[4:8]), brokers3=True)

    a4_g, a4_c = clone(agg_g), clone(agg_c)
    sel_g = relay_wave(apply_wave, st_g, a4_g, relay_g)
    sel_c = relay_wave(apply_wave_plain, st_c, a4_c, relay_c)
    torch.cuda.synchronize()
    if not bits_equal(sel_g, sel_c):
        fail("K4 apply_wave (two-leg): selection differs from the plain version")
    for n_, a_, b_ in zip(a4_c._fields, a4_g, a4_c):
        if not bits_equal(a_, b_):
            fail(f"K4 apply_wave (two-leg): applied {n_} differs from the plain version")
    n_sel = int(sel_c.sum())
    k4_err = max([max_abs_err(sel_g, sel_c)] + [max_abs_err(a_, b_) for a_, b_ in zip(a4_g, a4_c)])

    def k4_relay_call(fn):
        def call(i):
            if i == 0:
                pool[:] = [clone(agg_g) for _ in range(WARMUP + REPS)]
                torch.cuda.synchronize()
            return relay_wave(fn, st_g, pool[i], relay_g)
        return call

    # entries: 8 index words, a score and two flags; per selected entry both
    # legs' rows and the aggregate words of three brokers and two hosts
    k4_bytes = n4 * (8 * 4 + 4 + 1 + 1) + n4 * 2 * (r * 4 + 24) + n_sel * 2 * (
        2 * r * 4 * 2 + 2 * 56)
    row("apply_wave", "apply_wave.cu", "cruise_control_tpu/analyzer/context.py:425", k4_err,
        k4_relay_call(apply_wave), k4_relay_call(apply_wave_plain), k4_bytes, n4 * 90,
        "2,600-entry two-leg relay wave: one block of 1,024 threads, each owning up to three "
        "entries, dependent O(N^2) stages with barriers; latency, not bytes or operations, "
        "sets its time")
    pool.clear()
    print(f"K4 apply_wave: 2,600-entry two-leg relay wave, {n_sel} selected, selection and every "
          f"aggregate bit-equal")
    del a4_g, a4_c

    # K5 on DiskUsageDistributionGoal's [128, 128, 8, 8] replica-swap grid and
    # LeaderBytesInDistributionGoal's [512, 4, 2, 8, 2] relay grid, each
    # under its priors' tables
    disk_use, lbi = by_name["DiskUsageDistributionGoal"], by_name["LeaderBytesInDistributionGoal"]

    def swap_args(st, agg):
        gs = disk_use.prepare(st, agg, dims)
        grid = swap_grid(st, agg, disk_use.resource, disk_use.drain_contrib(st, gs, agg).contiguous(),
                         128, 8, dims.num_brokers)[-1]
        return (REPLICA_SWAP, st, agg, priors(disk_use, st, agg), gs, *grid)

    def relay_args(st, agg):
        gs = lbi.prepare(st, agg, dims)
        grid = relay_grid(st, agg, gs, lbi, 0, 512, 4, 8, dims.num_brokers)[-1]
        return (LEADERSHIP_RELAY, st, agg, priors(lbi, st, agg), gs, *grid)

    k5_rows = []
    for label, make, kw in (("replica-swap grid", swap_args, dict(resource=disk_use.resource)),
                            ("relay grid", relay_args, {})):
        args_g, args_c = make(st_g, agg_g), make(st_c, agg_c)
        for i_, (x_, y_) in enumerate(zip(args_g[5:], args_c[5:])):
            if not bits_equal(x_, y_):
                fail(f"K5 score_swaps ({label}): index tensor {i_} differs between card and CPU")
        o_g = score_swaps(*args_g, **kw)
        torch.cuda.synchronize()
        o_c = score_swaps_plain(*args_c, **kw)
        o_g_c = o_g.cpu()
        fin = torch.isfinite(o_c)
        if not torch.equal(fin, torch.isfinite(o_g_c)) or not bits_equal(o_g_c[fin], o_c[fin]):
            fail(f"K5 score_swaps ({label}): differs from the plain version")
        cells = o_c.numel()
        # distinct inputs: the index tensors, each picked partition's rows
        # (assignment, load, rack counts) and each broker's aggregate and
        # table words; the output once
        idx_bytes = sum(t.numel() * 4 for t in args_c[5:])
        parts = torch.unique(torch.cat([args_c[5].reshape(-1), args_c[8].reshape(-1)])).numel()
        brokers = torch.unique(torch.cat([args_c[7].reshape(-1), args_c[10].reshape(-1)])).numel()
        nbytes = idx_bytes + cells * 4 + parts * (r * 4 + 24 + dims.num_racks * 4 + 4) + brokers * 200
        k5_rows.append(dict(label=label, err=max_abs_err(o_g_c, o_c), cells=cells,
                            finite=int(fin.sum()), nbytes=nbytes,
                            call=lambda i, a=args_g, k=kw: score_swaps(*a, **k),
                            plain=lambda i, a=args_g, k=kw: score_swaps_plain(*a, **k)))
        print(f"K5 score_swaps ({label}, {tuple(o_c.shape)}): {int(fin.sum())} finite of {cells}, "
              f"masks and improvements bit-equal")
    err5 = max(x["err"] for x in k5_rows)
    for x, key in zip(k5_rows, ("score_swaps", "score_swaps relay grid")):
        # ~200 operations per cell (csrc/score_swaps.cu)
        rw = row(key, "score_swaps.cu", "cruise_control_tpu/analyzer/swaps.py:98", err5, x["call"],
                 x["plain"], x["nbytes"], 200 * x["cells"],
                 f"one thread per cell, {x['label']} of {x['cells']} cells")
        if key != "score_swaps":
            rows.pop(key)
            print(f"K5 score_swaps on the {x['label']}: {rw['ms']:.4f} ms on the device, "
                  f"{rw['call_ms']:.4f} ms per call, plain {rw['plain_ms']:.4f} ms, bound "
                  f"{rw['bound_ms']:.6f} ms by {rw['bound_by']}")

    # K6 on TopicReplicaDistributionGoal's first-round 512 surplus pairs
    topic_goal = by_name["TopicReplicaDistributionGoal"]

    def pairs(st, agg):
        gs = topic_goal.prepare(st, agg, dims)
        pt, pb, _ = select_surplus_pairs(st, agg, priors(topic_goal, st, agg), gs, 0, 512,
                                         dims.num_topics, dims.num_brokers)
        return (agg.assignment, st.topic_id, st.movable_partition, pt, pb, 4, dims.num_brokers)

    k6_g, k6_c = pairs(st_g, agg_g), pairs(st_c, agg_c)
    for i_ in (3, 4):
        if not bits_equal(k6_g[i_], k6_c[i_]):
            fail("K6 pair_picks: the surplus pairs differ between card and CPU")
    o6_g = pair_picks(*k6_g)
    torch.cuda.synchronize()
    o6_c = pair_picks_plain(*k6_c)
    for n_, a_, b_ in zip(("p", "slot", "found"), o6_g, o6_c):
        if not bits_equal(a_, b_):
            fail(f"K6 pair_picks: {n_} differs from the plain version")
    # per pass: the assignment, each slot's topic and movable flag, each
    # broker's pair row; the [512, 4] outputs once
    row("pair_picks", "pair_picks.cu", "cruise_control_tpu/analyzer/drain.py:235",
        max(max_abs_err(a_, b_) for a_, b_ in zip(o6_g, o6_c)),
        lambda i: pair_picks(*k6_g), lambda i: pair_picks_plain(*k6_g),
        p_count * r * 4 + p_count * 5 + dims.num_brokers * 4 + 512 * 8 + 512 * 4 * 9,
        4 * p_count * r * 6,
        "k = 4 passes, each an atomicMin bid per slot on its pair's row and a decode per row")
    print(f"K6 pair_picks: 512 pairs x 4, {int(o6_c[2].sum())} found, exact")

    # window_sum on the brokers' leader bytes-in (LeaderBytesInDistributionGoal's window)
    ws_g = window_sum(agg_g.leader_nw_in)
    torch.cuda.synchronize()
    ws_c = window_sum_plain(agg_c.leader_nw_in)
    if not bits_equal(ws_g.cpu().reshape(1), ws_c.reshape(1)):
        fail("window_sum differs from the plain version")
    row("window_sum", "window_sum.cu", "cruise_control_tpu/analyzer/goals/soft.py:462",
        max_abs_err(ws_g, ws_c), lambda i: window_sum(agg_g.leader_nw_in),
        lambda i: window_sum_plain(agg_g.leader_nw_in), dims.num_brokers * 4 + 4,
        dims.num_brokers, "one thread adds 2,600 values in index order",
        library=lambda i: torch.sum(agg_g.leader_nw_in))
    print("window_sum: bit-equal to the sequential float32 sum")
    del agg_g, agg_c

    # -- 4., 5. the two solves -------------------------------------------------------
    dead_ids = np.nonzero(model_cpu.broker_state.numpy() == 3)[0]
    solves = {}
    for label, settings, goal_names, path, ref, ref_moves in (
            ("hard goals", opt.SLICE_SETTINGS, HARD_GOAL_NAMES, HARD_PATH, JAX_CPU_REFERENCE,
             JAX_CPU_MOVES),
            ("stack", opt.STACK_SETTINGS, None, STACK_PATH, JAX_CPU_STACK_REFERENCE,
             JAX_CPU_STACK_MOVES)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.monotonic()
        res = opt.GoalOptimizer(device="cuda", settings=settings).optimizations(
            model_cpu, goal_names, raise_on_hard_failure=False)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = kernels.launches()
        peak = torch.cuda.max_memory_allocated()
        for key in path:
            if counts[key] == 0:
                fail(f"{label}: the solve never launched kernel {key}")
        print(f"{label}: {wall:.2f} s wall (kernel builds excluded), peak device memory "
              f"{peak / 2**20:.1f} MiB, launches {counts}")
        print(f"{label}: {res.num_replica_moves} replica moves, {res.num_leadership_moves} "
              f"leadership moves (JAX on a CPU: {ref_moves['replica']}, {ref_moves['leadership']})")
        print(f"{'goal':36s} {'viol':>11s} {'rounds':>6s} {'conv':>5s} "
              f"{'cost before -> after':>28s}   | JAX on a CPU")
        final = res.final_assignment
        for g in res.goal_results:
            rf = ref[g.name]
            same = (g.violated_brokers_before, g.violated_brokers_after, g.rounds,
                    g.converged) == rf[:4]
            print(f"{g.name:36s} {g.violated_brokers_before:5d}->{g.violated_brokers_after:<5d} "
                  f"{g.rounds:6d} {str(g.converged):>5s} {g.cost_before:13.6g} -> "
                  f"{g.cost_after:<12.6g}   | {rf[0]}->{rf[1]} r{rf[2]} {rf[3]} {rf[4]:.6g} -> "
                  f"{rf[5]:.6g}{'' if same else '   DIFFERS'}")
            if g.violated_brokers_after > g.violated_brokers_before:
                fail(f"{label}: {g.name}: violated brokers grew")
            if g.cost_after > g.cost_before * (1 + 1e-6):
                fail(f"{label}: {g.name}: cost grew")
        on_dead = int(np.isin(final[final >= 0], dead_ids).sum())
        if on_dead:
            fail(f"{label}: {on_dead} replicas left on dead brokers")
        sanity_check(model_cpu._replace(assignment=torch.from_numpy(final)))
        replay = model_cpu.assignment.numpy().copy()
        for pr in res.proposals:
            rrow = np.full(replay.shape[1], -1, dtype=replay.dtype)
            rrow[: len(pr.new_replicas)] = pr.new_replicas
            replay[pr.partition] = rrow
        if [set(x[x >= 0]) for x in replay] != [set(x[x >= 0]) for x in final] or not (
                replay[:, 0] == final[:, 0]).all():
            fail(f"{label}: proposals do not replay to the final assignment")
        print(f"{label}: 0 replicas on dead brokers, no goal worse, sanity_check passed, "
              "proposals replay to the final assignment")
        digest = hashlib.sha256(np.ascontiguousarray(final, dtype=np.int32).tobytes()).hexdigest()
        tags = hashlib.sha256(np.ascontiguousarray(res.touch_tag).tobytes()).hexdigest()
        solves[label] = {"wall_s": wall, "replica_moves": res.num_replica_moves,
                         "leadership_moves": res.num_leadership_moves, "peak_bytes": peak,
                         "final_assignment_sha256": digest, "touch_tag_sha256": tags,
                         "launches": counts,
                         "goals": [[g.name, g.violated_brokers_before, g.violated_brokers_after,
                                    g.rounds, g.converged, g.cost_before, g.cost_after]
                                   for g in res.goal_results]}
        del res

    # `launches` is the stack solve's count; the hard-goal solve's is kept beside it
    for key, v in rows.items():
        v["launches"] = solves["stack"]["launches"][key]
        v["launches_hard_goals"] = solves["hard goals"]["launches"][key]
    print(json.dumps({"solves": solves, "build_s": build_s,
                      "chip_smoke_s": time.monotonic() - t_start}))
    for k, v in rows.items():
        print(f"{k:20s} {v['ms']:9.4f} ms on the device per call, {v['call_ms']:9.4f} ms per "
              f"call (plain {v['plain_ms']:9.4f} ms, bound {v['bound_ms']:.6f} ms by "
              f"{v['bound_by']}), {v['launches']} launches in the stack solve")
    print(nvidia_smi_line())
    print(json.dumps({"kernels": [rows[k] for k in STACK_PATH]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
