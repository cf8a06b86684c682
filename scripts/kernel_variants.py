"""Where K1, K2, window_sum, K3, K5, K6, K7, K8, K10, K11, K12 and K13 spend their time, on one NVIDIA GPU.

    python3 scripts/kernel_variants.py [--only K7,K10 | --only K11 [--parent DIR] |
                                        --only K12,K13 --parent DIR] [--out build/kernel_variants.json]

Builds variants of cruise_control_torch/csrc/broker_topk.cu and window_sum.cu
into build/kernel_variants/ with the package's nvcc flags, each the source
with one step taken out (their results are wrong by design: only their times
count), and times each variant's kernels: device microseconds per launch,
kernel by kernel, from a torch.profiler trace of 50 back-to-back launches
after 5 warm-up ones. The inputs are synthetic, at chip_smoke.py's shapes:
K2 on 199,518 x 3 slots over 2,600 brokers, k = 8 (pareto contributions, 5%
of the partitions immovable); window_sum on 2,600, [2,600, 4] and 199,518
terms. The variants:

  K5          full; its staged kernel at 1 or 3 blocks an SM (2 in full),
              loading 8 hot picks' cross words at once (4), one, two or four
              cold picks a thread (full: two where one would make more blocks
              than run at once), and with its cells' checks as short-circuit
              branches
  K2          full; no insertion (the select's per-lane keep of its 8
              largest keys is an xor); no key loads (the select loads no
              run's first keys, reading the runs table instead); no key
              write-out (the runs kernel keeps its sorted keys in shared
              memory)
  window_sum  full; empty (it returns at once: the floor of a launch)
  K1          full; no topic atomics (the walk counts no member in the
              topic table); the runs kernel at one block an SM (two in full);
              the sums at one or four members a lane at a time (two in
              full); no block for a heavy broker (its warp walks it); two
              runs a thread of the walk (one in full) -- on
              199,518 x 3 slots over 2,600 brokers, 52 racks, 4,000 topics,
              and with broker 0 holding half the slots, kernel by kernel
  K8          full; registers bound for 8 or 6 blocks an SM (no bound in
              full); the topics' sums 16 loads a lane at a time (32 in
              full); the topics' first pass unrolled 32 or 8 deep (16 in
              full); the topics' warps idle; the series' warps idle; a
              clock64() stage split -- on a [4,000, 2,600] topic table and
              its first 20 topics

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
the tiles win sets `score_candidates.FACTORED_MIN_CELLS`. Then K5 on the
same model: DiskUsageDistributionGoal's replica-swap grids [N, N, K, K] (N
8 to 128, K 4 to 16) on both of its paths, forced in the packed layout
(the staged tiles and a thread a cell; outputs held equal): where the
staged path wins sets `score_swaps.STAGED_MIN_CELLS`; its topic-swap and
relay grids and a wave's 128-swap re-validation (a thread a cell); K6 on
512 surplus pairs at k = 1, 4 and 8; and the host's share of a K5 wave
call and a K6 call beside their C entries alone. Then K7 and K10 (alone
with `--only K7,K10`):

  K7          its layouts at the bucketed main path's 3,072 brokers (and at
              2,600 and 300,001): blocks of 256 threads, 2 vectors a thread
              (full: 11 blocks at 3,072, the last adding their partial sums
              after an atomic ticket); one block of 1,024 x 6; blocks of
              1,024, 512 or 128 threads, 1, 2 or 4 vectors each; at most
              1,056 blocks (264 in full); 64-bit indices at every size; the
              vectors read through the read-only path (__ldg);
              empty (each block returns at once: a launch's floor)
  K10         a 64-row batch into [212,992, 6] partition rows and 3,072
              brokers: tiles of 512 rows, 4 vectors a thread (full), of 256
              or 1,024; 128 threads a block (256 in full); the copy a word at
              a time (no 16-byte vectors); empty (a launch's floor)

and the host's share of a K7 and a K10 call beside their C entries alone.
Then K11 (alone with `--only K11`), on [199,518, 3] assignments over 2,600
brokers (26 demoted and 26 dead, as the demote phase; then half of them
demoted) and over 300,001 brokers:

  K11         tiles of 512 rows, 256 threads (full); tiles of 1,024, 256 or
              2,048 rows; 128 threads; the masks read in place (no staged flags);
              each under every flag layout the broker count allows, forced
              at the C entry (bytes, global); empty (a launch's floor)

and the host's share of a K11 call beside its C entry alone. With `--parent
DIR` (another checkout of the repo, such as the parent commit unpacked by
`git archive` into build/parent), K11's wrapper is then timed in each tree
in turns, DIR, this one, this one, DIR, each in a process of its own
importing its own package: device microseconds and the call's host
microseconds on the same cases.

K12 and K13 (alone with `--only K12,K13`, which needs `--parent DIR`: their
previous designs are DIR's csrc/shard_merge.cu and partition_stats.cu,
built with this checkout's nvcc flags and called through their C entries),
in one process, each design timed in turns (previous, this, this,
previous), each turn as device microseconds a call from a profiler trace
and microseconds a call from CUDA events around 200 back-to-back launches:

  K12         the mesh's record sets: 4 shards x 1 record (the parity
              model's greedy pass, k_sel 1), 8 x 16 (k_sel 16), and the
              new design's path edges, 2 x 16 = 32 (one warp), 3 x 11 = 33,
              8 x 512 = 4,096 (shared memory) and 17 x 241 = 4,097 (device
              memory), k_sel = k_loc; the previous design with the glue
              launch the mesh ran before it (each record's global row
              added, `g_rec[:, :, 0] += offsets`) and alone, on records
              made global beforehand; the new design's variants: no warp
              path (every size staged), the block paths comparing one or
              four records at a time (eight in full), empty (a launch's
              floor)
  K13         the smoke model's shape padded for 8 shards, [199,520, 3]
              slots and 199,520 flags, whole and as shard 1 of 8 ([24,940,
              3] at row 24,940: its flags 12 bytes past a 16-byte
              boundary); the new design's variants: the card's whole grid
              at every size, 1, 4 and 8 vectors a thread loaded at once (2
              in full); a stage split, each taking a step out (its counts
              wrong by design): no loads (the reductions and the last
              block's pass alone), a relaxed ticket (no ordering), no
              ticket (every block writes its counts and ends: no last
              block); the previous ordering, a fence on each side of a
              relaxed ticket (right counts), in place of the full design's
              release-acquire ticket;
              empty (a launch's floor)

Prints the card's name and power limit and every number; writes them as
JSON to --out. Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: the checkout whose cruise_control_torch is imported: this one, or the one
#: that `--k11-turn DIR` names
TREE = (pathlib.Path(sys.argv[sys.argv.index("--k11-turn") + 1]).resolve()
        if "--k11-turn" in sys.argv else ROOT)
sys.path.insert(0, str(TREE))
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
#: K5's staged kernel: more or fewer blocks an SM, the hot picks a thread's
#: cross words load at once, and the cell's checks written as a chain of
#: short-circuit branches (loads behind each) instead of independent compares
K5_LAZY = r"""
__device__ __forceinline__ float grid_cell_lazy(STAGED_CELL, int res, float lo, float hi,
                                                bool active_ok, int rack_on, int band_on) {
  if (H.p < 0 || C.p < 0 || BH.b < 0 || BC.b < 0) return -INFINITY;
  const float delta = at4(H.dload, res) - at4(C.dload, res);
  const float h1 = imbalance(BH.u - delta / BH.cap, lo, hi);
  const float c1 = imbalance(BC.u + delta / BC.cap, lo, hi);
  bool ok = delta > 1e-6f && BH.b != BC.b && H.p != C.p && active_ok &&
            h1 <= BH.imb0 + 1e-6f && c1 <= BC.imb0 + 1e-6f && !x1.holds && !x2.holds;
  const int same = BH.rack == BC.rack ? 1 : 0;
  ok = ok && (!rack_on || (x1.rack - same == 0 && x2.rack - same == 0));
  ok = ok && (H.s != 0 || BC.lead_ok) && (C.s != 0 || BH.lead_ok);
  ok = ok && staged_tables_ok(band_on, H, BH, C, BC, x1.tc, x2.tc);
  for (int r = 0; ok && r < 4; ++r) {
    const float net = H.dload[r] - C.dload[r];
    ok = BH.load[r] - net <= BH.lim[r] && BC.load[r] + net <= BC.lim[r];
  }
  ok = ok && BC.pot + H.dpnw - C.dpnw <= BC.pot_lim && BH.pot - H.dpnw + C.dpnw <= BH.pot_lim;
  return ok ? BH.imb0 + BC.imb0 - h1 - c1 : -INFINITY;
}

// hot picks whose cross words a thread loads at once"""
K5_VARIANTS = {
    "1 block an SM": [("__launch_bounds__(SW_THREADS, 2) k_swap_staged",
                       "__launch_bounds__(SW_THREADS, 1) k_swap_staged")],
    "3 blocks an SM": [("__launch_bounds__(SW_THREADS, 2) k_swap_staged",
                        "__launch_bounds__(SW_THREADS, 3) k_swap_staged")],
    "chunk of 8": [("constexpr int SW_CHUNK = 4;", "constexpr int SW_CHUNK = 8;")],
    "one cold pick a thread": [("? 2 * T1 : T1;", "? T1 : T1;")],
    "two cold picks a thread": [("? 2 * T1 : T1;", "? 2 * T1 : 2 * T1;")],
    "four cold picks a thread": [("? 2 * T1 : T1;", "? 4 * T1 : 4 * T1;")],
    "lazy checks": [("\n// hot picks whose cross words a thread loads at once", K5_LAZY),
                    ("          v = grid_cell(H, *sBH,", "          v = grid_cell_lazy(H, *sBH,")],
}
#: K1: the walk's topic atomics taken out, one block of the runs an SM (two
#: in full), one or four members a lane of the sums at a time (two in
#: full), no block for a heavy broker, and two runs a thread of the walk at
#: a time (one in full)
K1_VARIANTS = {
    "no topic atomics": [("          atomicAdd(&g.topic_count[",
                          "          if (g.B < 0) atomicAdd(&g.topic_count[")],
    "runs: 1 block an SM": [("__launch_bounds__(K1_THREADS, 2) k_seg_runs",
                             "__launch_bounds__(K1_THREADS) k_seg_runs")],
    "sums: 1 member a lane": [("constexpr int K1_WARP_PER = 2;",
                               "constexpr int K1_WARP_PER = 1;")],
    "sums: 4 members a lane": [("constexpr int K1_WARP_PER = 2;",
                                "constexpr int K1_WARP_PER = 4;")],
    "no heavy block": [("constexpr int K1_HEAVY = 2048;",
                        "constexpr int K1_HEAVY = 0x7fffffff;")],
    "sums: 2 runs a thread": [("constexpr int K1_RUNS = 1;", "constexpr int K1_RUNS = 2;")],
}
#: K8's stage split: clock64() cycles of one launch (the last one run) by
#: stage, read back through k8_clocks(): series 0 (block 0; 0-2: its first
#: pass, its mean, its variance) and series 4 (block 4; 3-5), topic 0 (8-9:
#: its first pass, its sum) and topic 100 (10-11), the last block's topic
#: mean (16), and in block 0's warp 0, the level-1 loads and staging, the
#: lanes' window sums and lane 0's sum of a chunk (24-26 in the mean, 20-22
#: in the variance)
K8_CLOCKS = [
    ("struct Levels {", "__device__ long long k8_clk[64];\n\nstruct Levels {"),
    ("  const int lane = threadIdx.x & 31;\n#pragma unroll\n"
     "  for (int h = 0; h < 32; h += BATCH) {",
     "  const int lane = threadIdx.x & 31;\n  const long long ck0 = clock64();\n#pragma unroll\n"
     "  for (int h = 0; h < 32; h += BATCH) {"),
    ("  __syncwarp();\n  float s = 0.0f;",
     "  __syncwarp();\n  const long long ck1 = clock64();\n  float s = 0.0f;"),
    ("  stage[lane] = s;\n  __syncwarp();\n  float w2 = 0.0f;\n",
     "  stage[lane] = s;\n  __syncwarp();\n  const long long ck2 = clock64();\n"
     "  float w2 = 0.0f;\n"),
    ("  __syncwarp();\n  return w2;\n}",
     "  __syncwarp();\n  if (threadIdx.x == 0 && blockIdx.x == 0)\n"
     "    k8_clk[20] = ck1 - ck0, k8_clk[21] = ck2 - ck1, k8_clk[22] = clock64() - ck2;\n"
     "  return w2;\n}"),
    ("  Moments m;\n", "  Moments m;\n  const long long c0 = clock64();\n"),
    ("  const float n = fmaxf((float)m.alive_n, 1.0f);\n",
     "  const long long c1 = clock64();\n  const float n = fmaxf((float)m.alive_n, 1.0f);\n"),
    ("  m.mean = mean;\n", "  m.mean = mean;\n  const long long c2 = clock64();\n"
     "  if (threadIdx.x == 0 && blockIdx.x == 0)\n"
     "    k8_clk[24] = k8_clk[20], k8_clk[25] = k8_clk[21], k8_clk[26] = k8_clk[22];\n"),
    ("  return m;\n}", "  if (threadIdx.x == 0 && (blockIdx.x == 0 || blockIdx.x == 4)) {\n"
     "    const int o = blockIdx.x == 0 ? 0 : 3;\n"
     "    k8_clk[o] = c1 - c0, k8_clk[o + 1] = c2 - c1, k8_clk[o + 2] = clock64() - c2;\n  }\n"
     "  return m;\n}"),
    ("  const int* row = g.topic_count + (long long)t * b;\n",
     "  const int* row = g.topic_count + (long long)t * b;\n  const long long c0 = clock64();\n"),
    ("  // counts are integers, so their sums are exact in any order\n",
     "  const long long c1 = clock64();\n"),
    ("  if (lane == 0) {\n    const bool nonempty = all_sum > 0;",
     "  if (lane == 0 && (t == 0 || t == 100)) {\n    const int o = t == 0 ? 8 : 10;\n"
     "    k8_clk[o] = c1 - c0, k8_clk[o + 1] = clock64() - c1;\n  }\n"
     "  if (lane == 0) {\n    const bool nonempty = all_sum > 0;"),
    ("  if (!s_last) return;\n", "  if (!s_last) return;\n  const long long e0 = clock64();\n"),
    ("    g.counters[0] = 0u;\n", "    k8_clk[16] = clock64() - e0;\n    g.counters[0] = 0u;\n"),
    ("CC_EXPORT int cluster_stats(",
     "CC_EXPORT int k8_clocks(long long* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, k8_clk, sizeof(k8_clk));\n}\n\n"
     "CC_EXPORT int cluster_stats("),
]
#: K8's topic pass at an unroll depth
TOPIC_PASS = "#pragma unroll %d\n  for (int i = lane; i < b; i += 32) {\n    const int c"
#: K8: registers bound for 8 or 6 blocks an SM (no bound in full), the
#: topics' sums 16 loads a lane at a time (32 in full), the topics' first
#: pass unrolled 32 or 8 deep (16 in full), the topics' warps or the
#: series' warps idle
K8_VARIANTS = {
    "8 blocks an SM": [("__launch_bounds__(K8_THREADS) k_cluster_stats",
                        "__launch_bounds__(K8_THREADS, 8) k_cluster_stats")],
    "topic sums 16 loads a lane": [("  const float ss = group_xla_sum<1, 32>(",
                                    "  const float ss = group_xla_sum<1, 16>(")],
    "topic pass unrolled 32": [(TOPIC_PASS % 16, TOPIC_PASS % 32)],
    "topic pass unrolled 8": [(TOPIC_PASS % 16, TOPIC_PASS % 8)],
    "6 blocks an SM": [("__launch_bounds__(K8_THREADS) k_cluster_stats",
                        "__launch_bounds__(K8_THREADS, 6) k_cluster_stats")],
    "no topics": [("    if (t < g.t) topic_spread(",
                   "    if (t < g.t && g.b < 0) topic_spread(")],
    "no series": [("    series(g, blockIdx.x, s_stage[warp], s_w, s_i);",
                   "    if (g.b < 0) series(g, blockIdx.x, s_stage[warp], s_w, s_i);")],
    "stage clocks": K8_CLOCKS,
}
#: K7's layouts (csrc/state_fingerprint.cu): threads a block and vectors a
#: thread, so one block or several cover 3,072 brokers; the most blocks; its
#: 64-bit configuration at every size
K7_LAYOUT = ("constexpr int FP_THREADS = 256;\nconstexpr int FP_UNROLL = 2;",
             "constexpr int FP_THREADS = %d;\nconstexpr int FP_UNROLL = %d;")
K7_VARIANTS = {
    **{f"{'one block' if t * u >= 5376 else 'blocks'} of {t} x {u}": [
        (K7_LAYOUT[0], K7_LAYOUT[1] % (t, u))]
       for t, u in ((1024, 6), (1024, 2), (1024, 1), (512, 4), (512, 2), (512, 1), (256, 4),
                    (256, 1), (128, 4), (128, 2), (128, 1))},
    "at most 1,056 blocks": [("constexpr int FP_MAX_BLOCKS = 264;",
                              "constexpr int FP_MAX_BLOCKS = 1056;")],
    "64-bit indices": [("  if (4 * b + FP_MAX_BLOCKS * FP_BLOCK_VECTORS < 0x7FFFFFFFLL)",
                        "  if (b < 0)")],
    "read-only loads": [("      x[u] = *reinterpret_cast<const uint4*>(FP_FIELD(g, s, p) + word);",
                         "      x[u] = __ldg(reinterpret_cast<const uint4*>(FP_FIELD(g, s, p) + word));")],
    "empty": [("  const int tid = threadIdx.x;\n  uint32_t acc = 0u;",
               "  const int tid = threadIdx.x;\n  if (g.v >= 0) return;\n  uint32_t acc = 0u;")],
}
#: K10: tiles of 256 or 1,024 rows (512 in full, 4 vectors a thread), 128
#: threads a block (256 in full), the copy a word at a time
K10_TILE = ("constexpr int DS_TILE = 512;  // partition rows (and brokers) a block owns\n"
            "constexpr int DS_VEC = 4;", "constexpr int DS_TILE = %d;\nconstexpr int DS_VEC = %d;")
K10_VARIANTS = {
    "tiles of 256": [(K10_TILE[0], K10_TILE[1] % (256, 2))],
    "tiles of 1024": [(K10_TILE[0], K10_TILE[1] % (1024, 8))],
    "128 threads": [(K10_TILE[0], K10_TILE[1] % (512, 8)),
                    ("constexpr int DS_THREADS = 256;", "constexpr int DS_THREADS = 128;")],
    "no vectors": [("  a.vec_rows = aligned16(part_load_in) && aligned16(part_load_out);\n"
                    "  a.vec_topic = aligned16(topic_in) && aligned16(topic_out);",
                    "  a.vec_rows = a.vec_topic = false;")],
    "empty": [("  const int tid = threadIdx.x;\n  const long long r0",
               "  const int tid = threadIdx.x;\n  if (a.d >= 0) return;\n  const long long r0")],
}
#: K11: tiles of 1,024, 256 or 2,048 rows (512 in full); 128 threads a block (256
#: in full); the two masks read in place with no staged flags; an empty
#: kernel (a launch's floor). The flag layouts are forced at the C entry
#: (its `flags` argument), not in the source
K11_VARIANTS = {
    "tiles of 1024": [("constexpr int EP_TILE = 512; ", "constexpr int EP_TILE = 1024;")],
    "tiles of 256": [("constexpr int EP_TILE = 512; ", "constexpr int EP_TILE = 256; ")],
    "tiles of 2048": [("constexpr int EP_TILE = 512; ", "constexpr int EP_TILE = 2048;")],
    "128 threads": [("constexpr int EP_THREADS = 256;", "constexpr int EP_THREADS = 128;")],
    "masks in place": [
        ("  if (MODE == FLAGS_BYTES) return s_flags[h] != 0;",
         "  if (MODE == FLAGS_BYTES) return (__ldg(g.demoted + h) | __ldg(g.dead + h)) != 0;"),
        ("  if (MODE == FLAGS_BYTES) {\n    const I b", "  if (MODE == FLAGS_BYTES && g.b < 0) {\n    const I b")],
    "empty": [("  const int r = (int)g.r;\n  const I span",
               "  if (g.p >= 0) return;\n  const int r = (int)g.r;\n  const I span")],
}
#: K12 and K13's variants of this checkout's sources
K12_VARIANTS = {
    "no warp path": [("  if (n <= SM_WARP)\n", "  if (n < 0)\n")],
    "no unrolling": [("constexpr int MERGE_UNROLL = 8;", "constexpr int MERGE_UNROLL = 1;")],
    "unrolled 4": [("constexpr int MERGE_UNROLL = 8;", "constexpr int MERGE_UNROLL = 4;")],
    "empty": [("  const int i = threadIdx.x;\n  const bool live",
               "  const int i = threadIdx.x;\n  if (a.n > 0) return;\n  const bool live"),
              ("  extern __shared__ float s_score[];\n",
               "  extern __shared__ float s_score[];\n  if (a.n > 0) return;\n")],
}
K13_VARIANTS = {
    "the card's whole grid": [("  blocks = blocks < 1 ? 1 : blocks > grid ? grid : blocks;",
                               "  blocks = grid;")],
    "1 vector a thread": [("constexpr int PS_VECTORS = 2;", "constexpr int PS_VECTORS = 1;")],
    "4 vectors a thread": [("constexpr int PS_VECTORS = 2;", "constexpr int PS_VECTORS = 4;")],
    "8 vectors a thread": [("constexpr int PS_VECTORS = 2;", "constexpr int PS_VECTORS = 8;")],
    "no loads": [("  for (long long v0 = t; v0 < g.m_vecs || v0 < g.s_vecs;",
                  "  for (long long v0 = t; v0 < 0;")],
    "full fences": [
        ("      s_last = cuda::atomic_ref<unsigned, cuda::thread_scope_device>(*g.ticket)\n"
         "                   .fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;",
         "      __threadfence();\n      s_last = atomicAdd(g.ticket, 1u) == gridDim.x - 1;"),
        ("  if (!s_last) return;  // the barrier passes thread 0's acquire to the block\n",
         "  if (!s_last) return;\n  __threadfence();\n")],
    "relaxed ticket": [("cuda::memory_order_acq_rel", "cuda::memory_order_relaxed")],
    "no ticket": [("      s_last = cuda::atomic_ref<unsigned, cuda::thread_scope_device>(*g.ticket)\n"
                   "                   .fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;",
                   "      s_last = false;")],
    "empty": [("  const int tid = threadIdx.x;\n  const long long t",
               "  if (g.n >= 0) return;\n  const int tid = threadIdx.x;\n  const long long t")],
}
#: K13's variants whose counts are right (the others take a step out)
K13_CHECKED = ("full", "the card's whole grid", "1 vector a thread", "4 vectors a thread",
               "8 vectors a thread", "full fences")
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


VARIANTS = {"broker_topk": K2_VARIANTS, "window_sum": WS_VARIANTS, "score_swaps": K5_VARIANTS,
            "segment_aggregates": K1_VARIANTS, "cluster_stats": K8_VARIANTS,
            "state_fingerprint": K7_VARIANTS, "delta_scatter": K10_VARIANTS,
            "elect_preferred": K11_VARIANTS, "shard_merge": K12_VARIANTS,
            "partition_stats": K13_VARIANTS}


def build_variants(build, out_dir: pathlib.Path, names=tuple(VARIANTS)) -> dict:
    """{(kernel, variant): .so path} of the sources `names`, compiled in
    parallel."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for h in build.CSRC.glob("*.cuh"):
        (out_dir / h.name).write_text(h.read_text())
    jobs = {}
    for name in names:
        variants = VARIANTS[name]
        src = (build.CSRC / f"{name}.cu").read_text()
        for label, edits in {"full": [], **variants}.items():
            cu = out_dir / f"{name}-{re.sub(r'[^A-Za-z0-9]+', '_', label)}.cu"
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


def launched(code: int) -> None:
    """Raise if a C entry point refused its launch."""
    if code:
        raise SystemExit(f"kernel_variants: a launch returned CUDA error {code}")


def entry(so: pathlib.Path, name: str, argtypes):
    fn = getattr(ctypes.PyDLL(str(so)), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def k7_k10(build, libs, res: dict) -> None:
    """K7's layouts and K10's variants, device microseconds a launch, and
    the host's share of a call of each wrapper beside its C entry alone."""
    from cruise_control_torch.analyzer.context import StaticCtx
    from cruise_control_torch.analyzer.incremental import DeltaBatch
    from cruise_control_torch.kernels import delta_scatter as k10
    from cruise_control_torch.kernels import state_fingerprint as k7

    rng = np.random.default_rng(13)
    res["K7"], res["K10"] = {}, {}
    fp_args = {}
    for b in (3_072, 2_600, 300_001):
        w = torch.from_numpy(rng.integers(-2**31, 2**31, 7 * b, dtype=np.int64).astype(np.int32))
        w = w.cuda()
        fp_args[b] = (w[:4 * b].view(torch.float32).view(b, 4), w[4 * b:5 * b].view(torch.float32),
                      w[5 * b:6 * b], w[6 * b:])
    want = {b: int(k7.state_fingerprint_plain(k7_agg(*a))) for b, a in fp_args.items()}
    scratch = k7._scratch(0)
    out = torch.empty((), dtype=torch.int64, device="cuda")
    for label in ("full", *K7_VARIANTS):
        so = libs[("state_fingerprint", label)]
        fn = entry(so, "state_fingerprint", k7._ARGTYPES)
        words = torch.zeros(k7.scratch_words(ctypes.CDLL(str(so))), dtype=torch.int32,
                            device="cuda")  # the variant's own: its block count may differ
        for b, a in fp_args.items():
            def call(a=a, b=b):
                launched(fn(*(t.data_ptr() for t in a), out.data_ptr(), words.data_ptr(), b,
                            build.raw_stream(0)))
            out.fill_(-1)
            call()
            if int(out) != want[b] and label != "empty":
                raise SystemExit(f"kernel_variants: K7 {label} at {b} brokers differs from the "
                                 "plain version")
            res["K7"][f"{label}, {b} brokers"] = device_us(call)
            print(f"K7 {label:22s} {b:7d} brokers {json.dumps(res['K7'][f'{label}, {b} brokers'])}")

    p, m, b, d = 212_992, 6, 3_072, 64
    st = {"part_load": torch.from_numpy(rng.random((p, m), dtype=np.float32)).cuda(),
          "topic_id": torch.from_numpy(rng.integers(0, 4000, p).astype(np.int32)).cuda(),
          "broker_state": torch.from_numpy(rng.integers(0, 4, b).astype(np.int32)).cuda(),
          "broker_valid": torch.from_numpy(rng.random(b) < 0.9).cuda(),
          "num_valid_partitions": torch.tensor(float(p - 8), device="cuda")}
    kinds = np.zeros(d, np.int32)
    kinds[:40] = rng.integers(1, 4, 40)
    batch = [torch.from_numpy(x).cuda() for x in (
        kinds, rng.integers(0, b, d).astype(np.int32), rng.integers(0, 4, d).astype(np.int32),
        rng.integers(0, p, d).astype(np.int32), rng.integers(0, 4000, d).astype(np.int32),
        rng.random((d, m), dtype=np.float32))]
    base = torch.from_numpy(rng.random(b) < 0.9).cuda()
    outs = (torch.empty(b, dtype=torch.int32, device="cuda"),
            torch.empty((6, b), dtype=torch.bool, device="cuda"), torch.empty_like(st["part_load"]),
            torch.empty_like(st["topic_id"]), torch.empty((), device="cuda"))
    ptrs10 = (*(t.data_ptr() for t in batch), st["broker_state"].data_ptr(),
              st["broker_valid"].data_ptr(), base.data_ptr(), base.data_ptr(),
              st["part_load"].data_ptr(), st["topic_id"].data_ptr(),
              st["num_valid_partitions"].data_ptr(), *(t.data_ptr() for t in outs))
    for label in ("full", *K10_VARIANTS):
        fn = entry(libs[("delta_scatter", label)], "delta_scatter", k10._ARGTYPES)
        res["K10"][label] = device_us(lambda: launched(fn(*ptrs10, d, m, b, p,
                                                          build.raw_stream(0))))
        print(f"K10 {label:14s} {json.dumps(res['K10'][label])}")

    agg = k7_agg(*fp_args[3_072])
    fn7 = build.entry("state_fingerprint", k7._ARGTYPES)
    fn10 = build.entry("delta_scatter", k10._ARGTYPES)
    spare = torch.zeros(1, device="cuda")  # the fields K10 does not read
    static = StaticCtx(**{f: st.get(f, spare) for f in StaticCtx._fields})
    db = DeltaBatch(*batch)
    for label, call in (
            ("K7 wrapper, 3,072 brokers", lambda: k7.state_fingerprint(agg)),
            ("K7 C entry, output made once", lambda: fn7(
                *(t.data_ptr() for t in fp_args[3_072]), out.data_ptr(), scratch, 3_072,
                build.raw_stream(0))),
            ("K10 wrapper, 64-row batch", lambda: k10.delta_scatter(static, db, base, base)),
            ("K10 C entry, outputs made once", lambda: fn10(*ptrs10, d, m, b, p,
                                                            build.raw_stream(0)))):
        res["host_us"][label] = host_us(call, 5000)
        print(f"host {label:30s} {res['host_us'][label]:.2f} us per call")


def k11_cases(p: int = 199_518, r: int = 3) -> dict:
    """{label: (assignment, demoted, dead)} on the card: [p, r] assignments
    over 2,600 brokers with 26 demoted and 26 dead (the demote phase's
    counts), half of them demoted, and 300,001 brokers (past the byte
    flags), from seed 11."""
    rng = np.random.default_rng(11)
    cases = {}
    for label, b, n_dem, n_dead in (("2,600 brokers, 26 + 26", 2_600, 26, 26),
                                    ("2,600 brokers, half demoted", 2_600, 1_300, 26),
                                    ("300,001 brokers, 1% + 1%", 300_001, 3_000, 3_000)):
        a = torch.from_numpy(np.stack([rng.choice(b, r, replace=False) for _ in range(64)]
                                      )[rng.integers(0, 64, p)].astype(np.int32))
        a = (a + torch.from_numpy(rng.integers(0, b, (p, 1)).astype(np.int32))) % b
        flags = rng.permutation(b)
        dem = np.zeros(b, bool)
        dead = np.zeros(b, bool)
        dem[flags[:n_dem]] = True
        dead[flags[n_dem:n_dem + n_dead]] = True
        cases[label] = (a.cuda(), torch.from_numpy(dem).cuda(), torch.from_numpy(dead).cuda())
    return cases


def k11_turn() -> int:
    """K11's wrapper in this process's checkout (TREE) on `k11_cases`:
    device microseconds a call by kernel, and the call's host microseconds,
    held equal to the plain version first; one JSON line."""
    from cruise_control_torch.kernels import elect_preferred as k11m

    out = {"tree": str(TREE)}
    for case, (a, dem, dead) in k11_cases().items():
        if not torch.equal(k11m.elect_preferred(a, dem, dead),
                           k11m.elect_preferred_plain(a, dem, dead)):
            raise SystemExit(f"kernel_variants: K11 in {TREE} ({case}) differs from the plain "
                             "version")
        us = device_us(lambda: k11m.elect_preferred(a, dem, dead))
        out[case] = {"device_us": dict(us, total=sum(us.values())),
                     "call_us": host_us(lambda: k11m.elect_preferred(a, dem, dead), 5000)}
    print(json.dumps(out))
    return 0


def k11_turns(parent: pathlib.Path, res: dict) -> None:
    """K11's wrapper timed in `parent` and in this checkout in turns
    (parent, this, this, parent), each in a process of its own."""
    res["K11 turns"] = []
    for tree in (parent, ROOT, ROOT, parent):
        proc = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                               "--k11-turn", str(tree)], cwd=tree, capture_output=True,
                              text=True, timeout=600)
        if proc.returncode:
            raise SystemExit(f"kernel_variants: the K11 turn in {tree} failed:\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        turn["tree"] = "parent" if tree == parent else "this"
        res["K11 turns"].append(turn)
        print(f"K11 turn {json.dumps(turn)}")


def k11(build, libs, res: dict) -> None:
    """K11's layouts, device microseconds a call (the bits merge launch
    included where a layout has one), on `k11_cases`; each variant held
    equal to the plain version first."""
    from cruise_control_torch.kernels import elect_preferred as k11m

    p, r = 199_518, 3
    cases = k11_cases(p, r)
    res["K11"] = {}
    out = torch.empty((p, r), dtype=torch.int32, device="cuda")
    for label in ("full", *K11_VARIANTS):
        fn = entry(libs[("elect_preferred", label)], "elect_preferred", k11m._ARGTYPES)
        for case, (a, dem, dead) in cases.items():
            b = dem.shape[0]
            ws = k11m._workspace(0, b)
            want = k11m.elect_preferred_plain(a, dem, dead)
            for flags in (("bytes", "global") if b <= k11m.BYTE_FLAGS else ("global",)):
                def call(a=a, dem=dem, dead=dead, b=b, ws=ws, flags=flags):
                    launched(fn(a.data_ptr(), dem.data_ptr(), dead.data_ptr(), out.data_ptr(),
                                ws, p, r, b, k11m.FLAGS[flags], build.raw_stream(0)))
                out.fill_(-2)
                call()
                if label != "empty" and not torch.equal(out, want):
                    raise SystemExit(f"kernel_variants: K11 {label} ({case}, {flags}) differs "
                                     "from the plain version")
                key = f"{label}, {case}, {flags}"
                us = device_us(call)
                res["K11"][key] = dict(us, total=sum(us.values()))
                print(f"K11 {key:50s} {json.dumps(res['K11'][key])}")
    a, dem, dead = cases["2,600 brokers, 26 + 26"]
    fn11 = build.entry("elect_preferred", k11m._ARGTYPES)
    for label, call in (
            ("K11 wrapper, [199,518, 3]", lambda: k11m.elect_preferred(a, dem, dead)),
            ("K11 C entry, output made once", lambda: fn11(
                a.data_ptr(), dem.data_ptr(), dead.data_ptr(), out.data_ptr(), None, p, r,
                2_600, 0, build.raw_stream(0)))):
        res["host_us"][label] = host_us(call, 5000)
        print(f"host {label:30s} {res['host_us'][label]:.2f} us per call")


#: K12's record sets: (shards, records a shard, k_sel)
K12_SHAPES = ((4, 1, 1), (8, 16, 16), (2, 16, 16), (3, 11, 11), (8, 512, 512), (17, 241, 241))
#: K13's rows: the smoke model's 199,518 partitions padded for 8 shards
K13_ROWS, K13_SHARDS = 199_520, 8


def events_us(call, reps: int = 200) -> float:
    """Microseconds a call: CUDA events around `reps` back-to-back calls."""
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        call()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e3 / reps


def build_parent(build, parent: pathlib.Path, out_dir: pathlib.Path, names) -> dict:
    """{name: .so} of `parent`'s csrc/<name>.cu, built with this checkout's
    nvcc flags beside `parent`'s headers."""
    out_dir.mkdir(parents=True, exist_ok=True)
    csrc = parent / "cruise_control_torch" / "csrc"
    for h in csrc.glob("*.cuh"):
        (out_dir / h.name).write_text(h.read_text())
    jobs = {}
    for name in names:
        cu = out_dir / f"{name}.cu"
        cu.write_text((csrc / f"{name}.cu").read_text())
        jobs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"kernel_variants: nvcc failed for the parent's {name}:\n{log}")
        libs[name] = so
    return libs


def in_turns(old: dict, new: dict) -> dict:
    """{label: [{device_us, events_us}, ...]}: each call of `old` and `new`
    timed in turns, old, new, new, old."""
    out = {label: [] for label in (*old, *new)}
    for side in (old, new, new, old):
        for label, call in side.items():
            us = device_us(call)
            out[label].append({"device_us": sum(us.values()), "kernels": us,
                               "events_us": events_us(call)})
    return out


def k12_k13(build, parent: pathlib.Path, res: dict) -> None:
    """K12's and K13's previous designs (`parent`'s sources) and this
    checkout's, in turns, at the mesh's shapes; each output held to the plain
    version first."""
    import merge_cases

    from cruise_control_torch.kernels import partition_stats as k13
    from cruise_control_torch.kernels import shard_merge as k12

    libs = build_variants(build, ROOT / "build" / "kernel_variants",
                          ("shard_merge", "partition_stats"))
    old = build_parent(build, parent, ROOT / "build" / "kernel_variants" / "parent",
                       ("shard_merge", "partition_stats"))
    stream = build.raw_stream(0)
    res["K12"], res["K13"] = {}, {}

    old12 = entry(old["shard_merge"], "shard_merge", (build.PTR,) * 4 + (build.INT,) * 2 +
                  (build.PTR,))
    rng = np.random.default_rng(12)
    for n_dev, k_loc, k_sel in K12_SHAPES:
        n = n_dev * k_loc
        s_np, rec_np = merge_cases.records("random", n_dev, k_loc, rng)
        s, rec = torch.from_numpy(s_np).cuda(), torch.from_numpy(rec_np).cuda()
        g_rec = k12.global_records(rec, k_loc, merge_cases.ROWS)
        offsets = torch.arange(n_dev, dtype=torch.int32, device="cuda")[:, None] * merge_cases.ROWS
        work = rec.clone()
        out_s = torch.empty(k_sel, device="cuda")
        out_r = torch.empty((4, k_sel), dtype=torch.int32, device="cuda")
        want = k12.shard_merge_plain(s.cpu(), rec.cpu(), k_sel, k_loc, merge_cases.ROWS)
        fns = {label: entry(libs[("shard_merge", label)], "shard_merge", k12._ARGTYPES)
               for label in ("full", *K12_VARIANTS)}

        def new_call(fn, s=s, rec=rec, n=n, k_sel=k_sel, k_loc=k_loc):
            launched(fn(s.data_ptr(), rec.data_ptr(), out_s.data_ptr(), out_r.data_ptr(), n,
                        k_sel, k_loc, merge_cases.ROWS, stream))

        def old_alone(s=s, g_rec=g_rec, n=n, k_sel=k_sel):
            launched(old12(s.data_ptr(), g_rec.data_ptr(), out_s.data_ptr(), out_r.data_ptr(), n,
                           k_sel, stream))

        def old_glued(s=s, rec=rec, n=n, k_sel=k_sel, k_loc=k_loc, n_dev=n_dev):
            # the gather buffer's one add (a single launch, from the shards' rows)
            torch.add(rec.view(n_dev, k_loc, 4)[:, :, 0], offsets,
                      out=work.view(n_dev, k_loc, 4)[:, :, 0])
            launched(old12(s.data_ptr(), work.data_ptr(), out_s.data_ptr(), out_r.data_ptr(), n,
                           k_sel, stream))

        for label, call in (("previous, alone", old_alone),
                            *((f"this, {v}", lambda fn=fns[v]: new_call(fn))
                              for v in ("full", "no warp path", "no unrolling",
                                        "unrolled 4"))):
            out_s.fill_(-7.0)
            call()
            if not (torch.equal(out_s.cpu().view(torch.int32), want[0].view(torch.int32)) and
                    torch.equal(out_r.cpu(), want[1])):
                raise SystemExit(f"kernel_variants: K12 {label} at {n_dev} x {k_loc} differs "
                                 "from the plain version")
        key = f"{n_dev} x {k_loc} records, k_sel {k_sel}"
        res["K12"][key] = in_turns(
            {"previous: offset add + K12": old_glued, "previous: K12 alone": old_alone},
            {"this: K12": lambda: new_call(fns["full"]),
             "this: no warp path": lambda: new_call(fns["no warp path"]),
             "this: no unrolling": lambda: new_call(fns["no unrolling"]),
             "this: unrolled 4": lambda: new_call(fns["unrolled 4"]),
             "this: empty (floor)": lambda: new_call(fns["empty"])})
        print(f"K12 {key}: " + json.dumps({k: [round(t["device_us"], 3) for t in v]
                                           for k, v in res["K12"][key].items()}))

    old13 = entry(old["partition_stats"], "partition_stats", (build.PTR,) * 4 +
                  (build.INT,) * 2 + (build.PTR,))
    old_scratch = torch.zeros(3, dtype=torch.int32, device="cuda")
    grid = k13._scratch(0)[2]
    r = 3
    flags = torch.from_numpy(rng.random(K13_ROWS) < 0.9).cuda()
    slots = torch.from_numpy(rng.integers(-1, 2_600, (K13_ROWS, r)).astype(np.int32)).cuda()
    rows = K13_ROWS // K13_SHARDS
    out = torch.empty(3, dtype=torch.int32, device="cuda")
    for case, (mov, a) in {"whole, [199,520, 3]": (flags, slots),
                           "shard 1 of 8, [24,940, 3]": (flags[rows:2 * rows],
                                                          slots[rows:2 * rows])}.items():
        want = k13.partition_stats_plain(mov.cpu(), a.cpu())
        n = mov.shape[0]
        fns = {}
        for label in ("full", *K13_VARIANTS):
            so = libs[("partition_stats", label)]
            lib = ctypes.CDLL(str(so))
            lib.partition_stats_scratch_words.argtypes = [ctypes.c_longlong]
            lib.partition_stats_scratch_words.restype = ctypes.c_longlong
            ws = torch.zeros(lib.partition_stats_scratch_words(grid), dtype=torch.int32,
                             device="cuda")
            fns[label] = (entry(so, "partition_stats", k13._ARGTYPES), ws)

        def new_call(label, mov=mov, a=a, n=n):
            fn, ws = fns[label]
            launched(fn(mov.data_ptr(), a.data_ptr(), out.data_ptr(), ws.data_ptr(), n, r, grid,
                        stream))

        def old_call(mov=mov, a=a, n=n):
            launched(old13(mov.data_ptr(), a.data_ptr(), out.data_ptr(), old_scratch.data_ptr(),
                           n, r, stream))

        for label, call in (("previous", old_call),
                            *((f"this, {v}", lambda v=v: new_call(v))
                              for v in K13_CHECKED)):
            out.fill_(-7)
            call()
            if not torch.equal(out.cpu(), want):
                raise SystemExit(f"kernel_variants: K13 {label} ({case}) differs from the plain "
                                 "version")
        res["K13"][case] = in_turns(
            {"previous": old_call},
            {"this": lambda: new_call("full"),
             **{f"this: {v}": lambda v=v: new_call(v) for v in K13_VARIANTS}})
        res["K13"][case]["flags' offset from 16 bytes"] = mov.data_ptr() % 16
        print(f"K13 {case}: " + json.dumps({k: [round(t["device_us"], 3) for t in v]
                                            for k, v in res["K13"][case].items()
                                            if isinstance(v, list)}))
    res["K13 grid"] = grid


def k7_agg(load, lnw, lc, rc):
    return collections.namedtuple("FpAgg", "broker_load leader_nw_in leader_count replica_count")(
        load, lnw, lc, rc)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "kernel_variants.json"))
    ap.add_argument("--only", choices=("K7,K10", "K11", "K12,K13"), default=None,
                    help="time K7's and K10's variants, K11's, or K12's and K13's, alone")
    ap.add_argument("--parent", default=None,
                    help="with --only K11: another checkout whose K11 wrapper is timed in "
                         "turns with this one's; with --only K12,K13 (needed): the checkout "
                         "whose K12 and K13 sources are the previous designs")
    ap.add_argument("--k11-turn", default=None, metavar="DIR",
                    help="time K11's wrapper in the checkout DIR alone (one JSON line)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs an NVIDIA GPU")
    if args.k11_turn:
        return k11_turn()
    from cruise_control_torch.kernels import broker_topk as k2
    from cruise_control_torch.kernels import build
    from cruise_control_torch.kernels import window_sum as ws

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card)
    res = {"card": card, "broker_topk": {}, "window_sum": {}, "host_us": {}}
    if args.only == "K12,K13":
        if not args.parent:
            raise SystemExit("kernel_variants: --only K12,K13 needs --parent DIR")
        k12_k13(build, pathlib.Path(args.parent).resolve(), res)
        return write(args.out, res)
    if args.only == "K11":
        k11(build, build_variants(build, ROOT / "build" / "kernel_variants",
                                  ("elect_preferred",)), res)
        if args.parent:
            k11_turns(pathlib.Path(args.parent).resolve(), res)
        return write(args.out, res)
    if args.only:
        libs = build_variants(build, ROOT / "build" / "kernel_variants",
                              ("state_fingerprint", "delta_scatter"))
        k7_k10(build, libs, res)
        return write(args.out, res)
    libs = build_variants(build, ROOT / "build" / "kernel_variants")
    rng = np.random.default_rng(0)

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
                                      tickets.data_ptr(), shape[0], cols, 0,
                                      build.raw_stream(0)))
            res["window_sum"][f"{shape} {label}"] = us
            print(f"window_sum {str(shape):12s} {label:6s} {json.dumps(us)}")

    x = torch.from_numpy(rng.standard_normal(2_600).astype(np.float32)).cuda()
    y = x.new_empty(())
    fn = build.entry("window_sum", ws._ARGTYPES)
    scratch = ws._scratch(0, 2_600 // 16 + 8, 1)
    for label, call in (("window_sum wrapper", lambda: ws.window_sum(x)),
                        ("torch.sum", lambda: torch.sum(x, dim=0)),
                        ("C entry, output made once", lambda: fn(
                            x.data_ptr(), y.data_ptr(), scratch[2], scratch[3], 2_600, 1, 0,
                            build.raw_stream(0))),
                        ("torch.empty", lambda: torch.empty((), device=x.device)),
                        ("Tensor.new_empty", lambda: x.new_empty(()))):
        res["host_us"][label] = host_us(call)
        print(f"host {label:20s} {res['host_us'][label]:.2f} us per call")

    # K1 on the smoke model's shape (199,518 x 3 slots, 2,600 brokers, 52
    # racks, 2,600 hosts, 4,000 topics) and with broker 0 holding half the
    # slots; K8 on a [4,000, 2,600] topic table and its first 20 topics
    from cruise_control_torch.kernels import cluster_stats as k8
    from cruise_control_torch.kernels import segment_aggregates as k1

    nr, h, t = 52, 2_600, 4_000
    k1_in = [torch.from_numpy(x).cuda() for x in (
        rng.integers(0, b, (p, r)).astype(np.int32), rng.pareto(1.5, (p, 6)).astype(np.float32),
        rng.integers(0, t, p).astype(np.int32), (np.arange(b) % nr).astype(np.int32),
        np.arange(b, dtype=np.int32))]
    skew = k1_in[0].clone()
    skew[torch.rand(skew.shape, device="cuda") < 0.5] = 0
    ws1 = k1._scratch(0, p, r, b, h)
    o1 = k1.segment_aggregates(*k1_in, b, nr, h, t)
    res["segment_aggregates"] = {}
    for label in ("full", *K1_VARIANTS):
        fn = entry(libs[("segment_aggregates", label)], "segment_aggregates", k1._ARGTYPES)
        for case, a1 in (("smoke shape", k1_in[0]), ("broker 0 holds half", skew)):
            us = device_us(lambda: launched(fn(
                a1.data_ptr(), *(x.data_ptr() for x in k1_in[1:]), *(o.data_ptr() for o in o1),
                ws1[1], p, r, b, nr, h, t, build.raw_stream(0))))
            res["segment_aggregates"][f"{case}, {label}"] = us
            print(f"K1 {case:20s} {label:24s} {json.dumps(us)}")
    counts = torch.from_numpy(rng.integers(0, 4, (t, b)).astype(np.int32)).cuda()
    load8 = torch.from_numpy(rng.pareto(1.5, (b, 4)).astype(np.float32)).cuda()
    k8_in = (load8, torch.full((b, 4), 100.0, device="cuda"),
             torch.from_numpy(rng.random(b) < 0.99).cuda(), counts.sum(0, dtype=torch.int32),
             counts.sum(0, dtype=torch.int32) // 2, load8[:, 2].contiguous())
    o8 = torch.empty(k8.NUM_F32, device="cuda")
    o8i = torch.empty(3, dtype=torch.int32, device="cuda")
    res["cluster_stats"] = {}
    for label in ("full", *K8_VARIANTS):
        fn = entry(libs[("cluster_stats", label)], "cluster_stats", k8._ARGTYPES)
        for tt in (t, 20):
            ws8 = k8._scratch(0, tt)
            table = counts[:tt].contiguous()
            lanes = k8.TOPIC_LANES[True][tt - 1] if tt <= 32 else -1
            us = device_us(lambda: launched(fn(
                *(x.data_ptr() for x in k8_in), table.data_ptr(), ws8[2], ws8[3], o8.data_ptr(),
                o8i.data_ptr(), b, tt, lanes, build.raw_stream(0))))
            res["cluster_stats"][f"{tt} topics, {label}"] = us
            print(f"K8 {tt:5d} topics {label:20s} {json.dumps(us)}")
            if label == "stage clocks":
                torch.cuda.synchronize()
                clk = (ctypes.c_longlong * 64)()
                lib = ctypes.CDLL(str(libs[("cluster_stats", label)]))
                launched(lib.k8_clocks(clk))
                res["cluster_stats"][f"{tt} topics, stage cycles"] = list(clk)
                print(f"K8 {tt:5d} topics stage cycles {list(clk)[:27]}")
    for label, call in (("K1 wrapper, smoke shape", lambda: k1.segment_aggregates(
                            *k1_in, b, nr, h, t)),
                        ("K8 wrapper, 4,000 topics", lambda: k8.cluster_stats(*k8_in, counts))):
        res["host_us"][label] = host_us(call, 2000)
        print(f"host {label:30s} {res['host_us'][label]:.2f} us per call")

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
            # a destination list per row: the factored tiles refuse the layout
            *((2, f"pair drain grid [{v}, {k}, {c}]", pair_grid(v, k, c),
               (k3.PATH_PROMOTION, k3.PATH_GENERAL))
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
            us = device_us(lambda: launched(fn3(a3, o3.data_ptr(), *(t.data_ptr() for t in idx3),
                                                ctypes.addressof(packed), build.raw_stream(0))))
            outs.append(o3)
            res["K3 paths"][f"{label}, {k3.PATH_NAMES[path]} kernel"] = us
            print(f"K3 {label:30s} {k3.PATH_NAMES[path]:9s} kernel {json.dumps(us)}")
        if not all(torch.equal(outs[0].view(torch.int32), o.view(torch.int32)) for o in outs):
            raise SystemExit(f"kernel_variants: K3's kernels disagree on the {label}")

    # K5: the replica-swap grid [N, N, K, K] of DiskUsageDistributionGoal on
    # both paths, forced in the packed layout; the topic-swap and relay grids
    # (a thread a cell); then the host's share of a K5 and a K6 call
    from cruise_control_torch.analyzer import drain, swaps
    from cruise_control_torch.kernels import pair_picks as k6
    from cruise_control_torch.kernels import score_swaps as k5

    res["K5 paths"] = {}
    disk_use, topic_goal, lbi = goals[8], goals[12], goals[14]
    t5 = build_tables(goals[:8], sst, sag, sdims)
    gs5 = disk_use.prepare(sst, sag, sdims)
    contrib5 = disk_use.drain_contrib(sst, gs5, sag).contiguous()
    c5 = k5.swap_context(None, sst, sag, t5, gs5)
    a5 = c5.pack("kernel_variants")
    fn5 = build.entry("score_swaps", k5._ARGTYPES)
    for nn, kk in ((128, 8), (64, 8), (48, 8), (40, 8), (32, 8), (16, 8), (8, 8), (128, 4),
                   (64, 4), (128, 16), (32, 16)):
        grid = swaps.swap_grid(sst, sag, disk_use.resource, contrib5, nn, kk, nb)[-1]
        lay5 = k5._launch_layout(k5.REPLICA_SWAP, disk_use.resource, False, grid, sag.assignment)
        outs = []
        for path in (k5.PATH_STAGED, k5.PATH_CELLS):
            packed = (ctypes.c_longlong * 39)(*list(lay5.packed)[:38], path)
            o5 = sag.assignment.new_empty(lay5.shape, dtype=torch.float32)
            us = device_us(lambda: launched(fn5(a5, o5.data_ptr(), *(t.data_ptr() for t in grid),
                                                ctypes.addressof(packed), build.raw_stream(0))))
            outs.append(o5)
            label = f"replica-swap grid [{nn}, {nn}, {kk}, {kk}], {k5.PATH_NAMES[path]}"
            res["K5 paths"][label] = us
            print(f"K5 {label:42s} {json.dumps(us)}")
        if not torch.equal(outs[0].view(torch.int32), outs[1].view(torch.int32)):
            raise SystemExit(f"kernel_variants: K5's paths disagree on [{nn}, {nn}, {kk}, {kk}]")
    for nn, kk in ((128, 8), (48, 8), (32, 8)):
        grid = swaps.swap_grid(sst, sag, disk_use.resource, contrib5, nn, kk, nb)[-1]
        lay5 = k5._launch_layout(k5.REPLICA_SWAP, disk_use.resource, False, grid, sag.assignment)
        staged = (ctypes.c_longlong * 39)(*list(lay5.packed)[:38], k5.PATH_STAGED)
        o5 = sag.assignment.new_empty(lay5.shape, dtype=torch.float32)
        for label in ("full", *K5_VARIANTS):
            fn = entry(libs[("score_swaps", label)], "score_swaps", k5._ARGTYPES)
            us = device_us(lambda: launched(fn(a5, o5.data_ptr(), *(t.data_ptr() for t in grid),
                                                ctypes.addressof(staged), build.raw_stream(0))))
            key = f"replica-swap grid [{nn}, {nn}, {kk}, {kk}], staged, {label}"
            res["K5 paths"][key] = us
            print(f"K5 {key:58s} {json.dumps(us)}")
    t12 = build_tables(goals[:12], sst, sag, sdims)
    gs12 = topic_goal.prepare(sst, sag, sdims)
    gs14 = lbi.prepare(sst, sag, sdims)
    for label, kind, tables_, gs_, grid in (
            ("topic-swap grid [512, 16, 8]", k5.TOPIC_SWAP, t12, gs12, drain.topic_swap_grid(
                sst, sag, t12, gs12, 0, 512, 16, 8, sdims.num_topics, nb)[-1]),
            ("relay grid [512, 4, 2, 8, 2]", k5.LEADERSHIP_RELAY, build_tables(
                goals[:14], sst, sag, sdims), gs14, drain.relay_grid(
                sst, sag, gs14, lbi, 0, 512, 4, 8, nb)[-1])):
        cx = k5.swap_context(None, sst, sag, tables_, gs_)
        us = device_us(lambda: k5.score_swaps(kind, sst, sag, tables_, gs_, *grid, ctx=cx))
        res["K5 paths"][f"{label}, cells"] = us
        print(f"K5 {label:42s} {json.dumps(us)}")
    hot, cold, hp, hs, cp, cs, _ = swaps.swap_grid(sst, sag, disk_use.resource, contrib5, 128, 8,
                                                   nb)
    wave = (hp[:, 0].contiguous(), hs[:, 0].contiguous(), hot, cp[:, 0].contiguous(),
            cs[:, 0].contiguous(), cold)
    lay_w = k5._launch_layout(k5.REPLICA_SWAP, disk_use.resource, True, wave, sag.assignment)
    o_w = sag.assignment.new_empty(lay_w.shape, dtype=torch.float32)
    res["K5 paths"]["replica-swap wave [128], cells"] = device_us(
        lambda: k5.score_swaps(k5.REPLICA_SWAP, sst, sag, t5, gs5, *wave,
                               resource=disk_use.resource, wave=True, ctx=c5))
    pt, pb, _ = drain.select_surplus_pairs(sst, sag, t12, gs12, 0, 512, sdims.num_topics, nb)
    k6_args = (sag.assignment, sst.topic_id, sst.movable_partition, pt, pb, 4, nb)
    row_of, lists, ticket = k6._scratch(0, nb, 512 * 4)
    o6 = torch.empty((2, 512, 4), dtype=torch.int32, device="cuda")
    ok6 = torch.empty((512, 4), dtype=torch.bool, device="cuda")
    fn6 = build.entry("pair_picks", k6._ARGTYPES)
    res["K6"] = {k: device_us(lambda k=k: k6.pair_picks(*k6_args[:5], k, nb)) for k in (1, 4, 8)}
    print(f"K6 pair_picks, 512 pairs, k = 1 / 4 / 8: {json.dumps(res['K6'])}")
    for label, call in (
            ("K5 wrapper, wave of 128 swaps", lambda: k5.score_swaps(
                k5.REPLICA_SWAP, sst, sag, t5, gs5, *wave, resource=disk_use.resource, wave=True,
                ctx=c5)),
            ("K5 C entry, output made once", lambda: fn5(
                a5, o_w.data_ptr(), *(t.data_ptr() for t in wave), lay_w.address,
                build.raw_stream(0))),
            ("K5 launch layout (cached)", lambda: k5._launch_layout(
                k5.REPLICA_SWAP, disk_use.resource, True, wave, sag.assignment)),
            ("K5 context bind and pack", lambda: k5.swap_context(
                c5, sst, sag, t5, gs5).pack("kernel_variants")),
            ("K6 wrapper, 512 pairs x 4", lambda: k6.pair_picks(*k6_args)),
            ("K6 C entry, outputs made once", lambda: fn6(
                sag.assignment.data_ptr(), sst.topic_id.data_ptr(),
                sst.movable_partition.data_ptr(), pt.data_ptr(), pb.data_ptr(),
                row_of.data_ptr(), lists.data_ptr(), ticket.data_ptr(), o6.data_ptr(),
                o6.data_ptr() + 4 * 512 * 4, ok6.data_ptr(), sdims.num_partitions, sdims.max_rf,
                nb, 512, 4, build.raw_stream(0)))):
        res["host_us"][label] = host_us(call)
        print(f"host {label:30s} {res['host_us'][label]:.2f} us per call")
    k7_k10(build, libs, res)
    k11(build, libs, res)
    return write(args.out, res)


def write(out: str, res: dict) -> int:
    path = pathlib.Path(out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
