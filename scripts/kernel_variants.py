"""Where K2 broker_topk, window_sum and K3 score_candidates spend their time, on one NVIDIA GPU.

    python3 scripts/kernel_variants.py [--out build/kernel_variants.json]

Builds variants of cruise_control_torch/csrc/broker_topk.cu and window_sum.cu
into build/kernel_variants/ with the package's nvcc flags, each the source
with one step taken out (their results are wrong by design: only their times
count), and times each variant's kernels: device microseconds per launch,
kernel by kernel, from a torch.profiler trace of 50 back-to-back launches
after 5 warm-up ones. The inputs are synthetic, at chip_smoke.py's shapes:
K2 on 199,518 x 3 slots over 2,600 brokers, k = 8 (pareto contributions, 5%
of the partitions immovable); window_sum on 2,600, [2,600, 4] and 199,518
terms. The variants:

  K2          full; no insertion (the select's per-lane keep of its 8
              largest keys is an xor); no key loads (the select loads no
              run's first keys, reading the runs table instead); no key
              write-out (the runs kernel keeps its sorted keys in shared
              memory)
  window_sum  full; empty (it returns at once: the floor of a launch)

Then K2 on skewed brokers, through the wrapper (a broker with more than
2,048 eligible slots is selected by its whole block, which takes the
block's heavy brokers one at a time): tests/topk_cases.py's
`skewed_broker` at the card's size (20,000 x 3 slots over 24 brokers,
broker 0 leads every partition, k = 33) and `heavy_brokers` (7 brokers each
leading a seventh of 199,518 partitions, k = 20), and at the disk-drain
shape with broker 0 leading every partition (199,518 of its slots; k = 8
and 33) or holding every slot (598,554; k = 8).

Then the host's share of a call: microseconds per call of the window_sum
wrapper, torch.sum, the wrapper's C entry alone (its output made once),
torch.empty and Tensor.new_empty on the 2,600-term input; and of K3's
wrapper on a drain wave's 512 single cells (DiskCapacityGoal on BASELINE
config 2, with a round's context) beside its steps: the C entry alone,
the cached launch layout, Tensor.new_empty, binding the context (host clock
around 20,000 calls). Then K3's kernels on one layout each, the path
forced in the packed layout (device microseconds, outputs held equal), on
chip_smoke's model: its two per-cell kernels on the [P, 2] promotion grid
of CpuCapacityGoal and on a wave's 512 cells of DiskCapacityGoal, and all
three (the factored tiles, the promotion path's thread a cell and the
general path's two threads a cell) on DiskCapacityGoal's drain grids
[V, 8, C] (V 64 to 512, C 2 to 64), its all-broker re-score of 16, 64 and
256 entries and the pair drain's per-row grids [512 and 64, 4, 64]: where
the tiles win sets `score_candidates.FACTORED_MIN_CELLS`. Prints the card's name
and power limit and every number; writes them as JSON to --out. Needs a
GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

K2_VARIANTS = {
    "no insertion": [("  if (key <= t[K2_LANE_KEYS - 1]) return;\n",
                      "  t[0] ^= key;\n  return;\n")],
    "no key loads": [("unsigned long long kv = s[min(e, max(cnt - 1, 0))];",
                      "unsigned long long kv = (unsigned long long)(size_t)(s + e);")],
    "no key write-out": [
        ("for (unsigned int e = tid; e < carry; e += K2_THREADS) out[e] = s_keys[e];",
         "if (carry == 0xffffffffu) out[tid] = s_keys[tid];")],
}
WS_VARIANTS = {
    "empty": [("  const int tid = threadIdx.x;\n",
               "  const int tid = threadIdx.x;\n  if (cols > 0) return;\n")],
}


def variant(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"kernel_variants: the source has no {old!r}")
        src = src.replace(old, new, 1)
    return src


def build_variants(build, out_dir: pathlib.Path) -> dict:
    """{(kernel, variant): .so path}, compiled in parallel."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for h in build.CSRC.glob("*.cuh"):
        (out_dir / h.name).write_text(h.read_text())
    jobs = {}
    for name, variants in (("broker_topk", K2_VARIANTS), ("window_sum", WS_VARIANTS)):
        src = (build.CSRC / f"{name}.cu").read_text()
        for label, edits in {"full": [], **variants}.items():
            cu = out_dir / f"{name}-{label.replace(' ', '_')}.cu"
            cu.write_text(variant(src, edits))
            so = cu.with_suffix(".so")
            jobs[(name, label)] = (so, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"kernel_variants: nvcc failed for {key}:\n{log}")
        libs[key] = so
    return libs


def device_us(call, reps: int = 50) -> dict:
    """{kernel: device microseconds per call} from a profiler trace."""
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).endswith("CUDA"):
            us = float(getattr(evt, "self_device_time_total", 0.0))
            out[evt.key.split("(")[0].split(" ")[-1]] = us / reps
    return out


def host_us(call, n: int = 20000) -> float:
    for _ in range(200):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def entry(so: pathlib.Path, name: str, argtypes):
    fn = getattr(ctypes.PyDLL(str(so)), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "kernel_variants.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs an NVIDIA GPU")
    from cruise_control_torch.kernels import broker_topk as k2
    from cruise_control_torch.kernels import build
    from cruise_control_torch.kernels import window_sum as ws

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    libs = build_variants(build, ROOT / "build" / "kernel_variants")
    rng = np.random.default_rng(0)
    res = {"card": card, "broker_topk": {}, "window_sum": {}, "host_us": {}}

    p, r, b, k = 199_518, 3, 2_600, 8
    a = torch.from_numpy(rng.integers(0, b, (p, r)).astype(np.int32)).cuda()
    c = torch.from_numpy(rng.pareto(1.5, (p, r)).astype(np.float32)).cuda()
    mov = torch.from_numpy(rng.random(p) > 0.05).cuda()
    blocks = max(1, -(-p * r // k2.CHUNK))
    runs, keys = k2._scratch(0, b, blocks)
    o = torch.empty((2, b, k), dtype=torch.int32, device="cuda")
    ok = torch.empty((b, k), dtype=torch.bool, device="cuda")
    for label in ("full", *K2_VARIANTS):
        fn = entry(libs[("broker_topk", label)], "broker_topk", k2._ARGTYPES)
        res["broker_topk"][label] = device_us(lambda: fn(
            c.data_ptr(), a.data_ptr(), mov.data_ptr(), runs.data_ptr(), keys.data_ptr(),
            o.data_ptr(), o.data_ptr() + 4 * b * k, ok.data_ptr(), p, r, b, k, 1, blocks,
            build.raw_stream(0)))
        print(f"K2 {label:18s} {json.dumps(res['broker_topk'][label])}")

    import topk_cases

    skewed = {}
    for name, label in (("skewed_broker", "20,000 x 3, 24 brokers, k = 33"),
                        ("heavy_brokers", "199,518 x 3, 7 of 2,600 brokers heavy, k = 20")):
        sk = topk_cases.case(name, full=True)
        skewed[f"{name}, {label}"] = (
            torch.from_numpy(sk["contrib"]).cuda(), torch.from_numpy(sk["assignment"]).cuda(),
            torch.from_numpy(sk["movable"]).cuda(), sk["k"], sk["num_brokers"])
    lead = a.clone()
    lead[:, 0] = 0
    everything = torch.zeros_like(a)
    every = torch.ones_like(mov)
    for kk in (8, 33):
        skewed[f"broker 0 leads every partition, k = {kk}"] = (c, lead, every, kk, b)
    skewed["broker 0 holds every slot, k = 8"] = (c, everything, every, 8, b)
    res["broker_topk skewed"] = {}
    for label, (sc, sa, sm, kk, bb) in skewed.items():
        us = device_us(lambda: k2.broker_topk(sc, sa, sm, kk, bb))
        res["broker_topk skewed"][label] = us
        print(f"K2 skewed: {label:62s} {json.dumps(us)}")

    for shape in ((2_600,), (2_600, 4), (199_518,)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
        cols = shape[1] if len(shape) == 2 else 1
        scratch, tickets, _, _ = ws._scratch(0, (shape[0] // 16 + 8) * cols, 64)
        y = torch.empty(cols, device="cuda")
        for label in ("full", *WS_VARIANTS):
            fn = entry(libs[("window_sum", label)], "window_sum", ws._ARGTYPES)
            us = device_us(lambda: fn(x.data_ptr(), y.data_ptr(), scratch.data_ptr(),
                                      tickets.data_ptr(), shape[0], cols, build.raw_stream(0)))
            res["window_sum"][f"{shape} {label}"] = us
            print(f"window_sum {str(shape):12s} {label:6s} {json.dumps(us)}")

    x = torch.from_numpy(rng.standard_normal(2_600).astype(np.float32)).cuda()
    y = x.new_empty(())
    fn = build.entry("window_sum", ws._ARGTYPES)
    scratch = ws._scratch(0, 2_600 // 16 + 8, 1)
    for label, call in (("window_sum wrapper", lambda: ws.window_sum(x)),
                        ("torch.sum", lambda: torch.sum(x, dim=0)),
                        ("C entry, output made once", lambda: fn(
                            x.data_ptr(), y.data_ptr(), scratch[2], scratch[3], 2_600, 1,
                            build.raw_stream(0))),
                        ("torch.empty", lambda: torch.empty((), device=x.device)),
                        ("Tensor.new_empty", lambda: x.new_empty(()))):
        res["host_us"][label] = host_us(call)
        print(f"host {label:20s} {res['host_us'][label]:.2f} us per call")

    from cruise_control_torch.analyzer.acceptance import build_tables
    from cruise_control_torch.analyzer.context import (
        build_static_ctx,
        compute_aggregates,
        dims_of,
    )
    from cruise_control_torch.analyzer.goals import goals_by_priority
    from cruise_control_torch.config.balancing import BalancingConstraint
    from cruise_control_torch.kernels import score_candidates as k3
    from cruise_control_torch.models import generators

    m = generators.random_cluster(42, generators.BASELINE_CONFIGS[2]).to("cuda")
    dims = dims_of(m)
    st = build_static_ctx(m, BalancingConstraint.default(), dims)
    ag = compute_aggregates(st, m.assignment, dims)
    goals = goals_by_priority(None)
    goal = goals[2]
    tables = build_tables(goals[:2], st, ag, dims)
    gs = goal.prepare(st, ag, dims)
    n = 512
    wp = torch.from_numpy(rng.integers(0, dims.num_partitions, n).astype(np.int32)).cuda()
    wk = torch.zeros(n, dtype=torch.int32, device="cuda")
    ws_ = torch.from_numpy(rng.integers(0, dims.max_rf, n).astype(np.int32)).cuda()
    wd = torch.from_numpy(rng.integers(0, dims.num_brokers, n).astype(np.int32)).cuda()
    idx = (wp, wk, ws_, wd)
    ctx = k3.ScoreContext(st, ag, tables, goal, gs)
    address = ctx.pack("kernel_variants")
    lay = k3._launch_layout(idx, ag.assignment)
    out = ag.assignment.new_empty(lay.shape, dtype=torch.float32)
    fn3 = build.entry("score_candidates", k3._ARGTYPES)
    for label, call in (
            ("K3 wrapper, 512 cells", lambda: k3.score_candidates(st, ag, tables, goal, gs, *idx,
                                                                  ctx=ctx)),
            ("K3 C entry, output made once", lambda: fn3(
                address, out.data_ptr(), wp.data_ptr(), wk.data_ptr(), ws_.data_ptr(),
                wd.data_ptr(), lay.address, build.raw_stream(0))),
            ("K3 launch layout (cached)", lambda: k3._launch_layout(idx, ag.assignment)),
            ("K3 output, new_empty", lambda: ag.assignment.new_empty(lay.shape,
                                                                     dtype=torch.float32)),
            ("K3 context bind and pack", lambda: k3.bound_context(
                ctx, st, ag, tables, goal, gs).pack("kernel_variants"))):
        res["host_us"][label] = host_us(call)
        print(f"host {label:30s} {res['host_us'][label]:.2f} us per call")

    import dataclasses

    from cruise_control_torch.analyzer.actions import KIND_MOVE, leadership_grid

    prop = dataclasses.replace(generators.BASELINE_CONFIGS[5], num_dead_brokers=26,
                               load_distribution="pareto", mean_utilization=0.5)
    sm = generators.random_cluster(42, prop).to("cuda")
    sdims = dims_of(sm)
    sst = build_static_ctx(sm, BalancingConstraint.default(), sdims)
    sag = compute_aggregates(sst, sm.assignment, sdims)
    res["K3 paths"] = {}
    nb = sdims.num_brokers

    def cuda_i32(*xs):
        return tuple(torch.from_numpy(np.asarray(x, dtype=np.int32)).cuda() for x in xs)

    def drain_grid(c, v=512):
        """The drain round's move grid [v, 8, c] toward c distinct brokers."""
        return cuda_i32(rng.integers(0, sdims.num_partitions, (v, 8, 1)), KIND_MOVE,
                        rng.integers(0, sdims.max_rf, (v, 8, 1)),
                        rng.choice(nb, (1, 1, c), replace=False))

    def all_brokers(k):
        """The grid round's all-broker re-score [k, nb]."""
        return cuda_i32(rng.integers(0, sdims.num_partitions, (k, 1)), np.full((k, 1), KIND_MOVE),
                        rng.integers(0, sdims.max_rf, (k, 1)), np.arange(nb)[None, :])

    def pair_grid(v, k, c):
        """The pair drain's grid [v, k, c], a destination list per row."""
        return cuda_i32(rng.integers(0, sdims.num_partitions, (v, k, 1)), KIND_MOVE,
                        rng.integers(0, sdims.max_rf, (v, k, 1)),
                        rng.integers(0, nb, (v, 1, c)))

    factored_paths = (k3.PATH_FACTORED, k3.PATH_PROMOTION, k3.PATH_GENERAL)
    for gi, label, idx3, paths in (
            (5, "promotion grid [P, 2]", leadership_grid(sag.assignment),
             (k3.PATH_GENERAL, k3.PATH_PROMOTION)),
            (2, "wave of 512 cells", cuda_i32(
                rng.integers(0, sdims.num_partitions, n), np.zeros(n),
                rng.integers(0, sdims.max_rf, n), rng.integers(0, nb, n)),
             (k3.PATH_GENERAL, k3.PATH_PROMOTION)),
            (2, "drain grid [512, 8, 64]", drain_grid(64), factored_paths),
            (2, "drain grid [512, 8, 2]", drain_grid(2), factored_paths),
            (2, f"all-broker grid [16, {nb}]", all_brokers(16), factored_paths),
            *((2, f"drain grid [{v}, 8, {c}]", drain_grid(c, v), factored_paths)
              for v, c in ((64, 64), (128, 64), (512, 16), (512, 8), (512, 32))),
            *((2, f"all-broker grid [{k}, {nb}]", all_brokers(k), factored_paths)
              for k in (64, 256)),
            *((2, f"pair drain grid [{v}, {k}, {c}]", pair_grid(v, k, c), factored_paths)
              for v, k, c in ((512, 4, 64), (64, 4, 64)))):
        g3 = goals[gi]
        t3 = build_tables(goals[:gi], sst, sag, sdims)
        c3 = k3.ScoreContext(sst, sag, t3, g3, g3.prepare(sst, sag, sdims))
        a3 = c3.pack("kernel_variants")
        lay3 = k3._launch_layout(idx3, sag.assignment)
        outs = []
        for path in paths:
            packed = (ctypes.c_longlong * 16)(*list(lay3.packed)[:15], path)
            o3 = sag.assignment.new_empty(lay3.shape, dtype=torch.float32)
            us = device_us(lambda: fn3(a3, o3.data_ptr(), *(t.data_ptr() for t in idx3),
                                       ctypes.addressof(packed), build.raw_stream(0)))
            outs.append(o3)
            res["K3 paths"][f"{label}, {k3.PATH_NAMES[path]} kernel"] = us
            print(f"K3 {label:30s} {k3.PATH_NAMES[path]:9s} kernel {json.dumps(us)}")
        if not all(torch.equal(outs[0].view(torch.int32), o.view(torch.int32)) for o in outs):
            raise SystemExit(f"kernel_variants: K3's kernels disagree on the {label}")
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
