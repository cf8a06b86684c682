// K3 score_candidates: the masked score of every candidate action under one
// goal of the default stack and the merged acceptance tables of the goals
// before it.
//
// Replaces: cruise_control_tpu/analyzer/acceptance.py score_batch (:330) with
// structural_mask (:314), tables_acceptance (:164), band_move_acceptance
// (:116), the goal's acceptance / action_score (goals/hard.py, goals/soft.py),
// fed by actions.build_selected (:189).
//
// Bound on this card: bytes, and in practice latency. Per candidate the
// kernel gathers one assignment row, one part_load row and a few dozen
// per-broker / per-host / per-topic / per-rack aggregate and table words,
// and does ~100 flops. The drain round's [512, 8, 64] move grid (262,144
// cells) touches at most 4,096 partitions and the 64 destination brokers;
// the [P, R-1] promotion grid (399,036 cells) reads every partition's row
// once. Both are a few MB of distinct bytes. The bulk planner's [B, 8] and
// [B, 8, 2] grids and the pair drain's [512, 4, 64] grid are smaller still.
//
// Design: one thread per candidate, scored by score_action (score_goal.cuh,
// shared with K9 grid_shortlist). The (p, kind, slot, dst) index tensors are
// read through broadcast strides, so the lazy [V,K,1] x [1,1,C] grid of
// drain.py:960-971 and the strided assignment[:, 1:] view of the promotion
// grid are never materialised.
#include "score_goal.cuh"

struct ScoreArgs {
  float* out;
  const int *p, *kind, *slot, *dst;
  long long sp[3], sk[3], ss[3], sd[3];
  long long d1, d2, numel;
  ScoreCtx c;
};

__global__ void k_score(ScoreArgs g) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= g.numel) return;
  long long i0 = e / (g.d1 * g.d2), rem = e % (g.d1 * g.d2);
  long long i1 = rem / g.d2, i2 = rem % g.d2;
  int p = g.p[i0 * g.sp[0] + i1 * g.sp[1] + i2 * g.sp[2]];
  int kind = g.kind[i0 * g.sk[0] + i1 * g.sk[1] + i2 * g.sk[2]];
  int slot = g.slot[i0 * g.ss[0] + i1 * g.ss[1] + i2 * g.ss[2]];
  int dst = g.dst[i0 * g.sd[0] + i1 * g.sd[1] + i2 * g.sd[2]];
  g.out[e] = score_action(g.c, p, kind, slot, dst);
}

// ptrs (in this order): out, p, kind, slot, dst, then the score context
//   (read_score_ctx, score_goal.cuh)
// ints: d0, d1, d2, strides of p (3), kind (3), slot (3), dst (3), R, NR, B,
//   goal
CC_EXPORT int score_candidates(const long long* ptrs, const long long* ints, cudaStream_t stream) {
  ScoreArgs g;
  g.out = (float*)ptrs[0];
  g.p = (const int*)ptrs[1];
  g.kind = (const int*)ptrs[2];
  g.slot = (const int*)ptrs[3];
  g.dst = (const int*)ptrs[4];
  read_score_ctx(g.c, ptrs, 5, ints + 15);
  long long d0 = ints[0];
  g.d1 = ints[1];
  g.d2 = ints[2];
  for (int j = 0; j < 3; ++j) {
    g.sp[j] = ints[3 + j];
    g.sk[j] = ints[6 + j];
    g.ss[j] = ints[9 + j];
    g.sd[j] = ints[12 + j];
  }
  g.numel = d0 * g.d1 * g.d2;
  if (g.numel == 0) return cudaSuccess;
  k_score<<<(unsigned)((g.numel + 255) / 256), 256, 0, stream>>>(g);
  return cudaGetLastError();
}
