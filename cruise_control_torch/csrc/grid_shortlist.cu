// K9 grid_shortlist: the greedy round's shortlist, in one pass over its whole
// candidate space.
//
// Replaces: cruise_control_tpu/analyzer/optimizer.py one_round (:357), its
// shortlist at :371-409: the [P, R, K] move grid (actions.make_move_batch x
// acceptance.score_batch), the first-occurrence argmax of each partition's
// R*K move cells (flattened slot*K + k), the [P, R-1] leadership grid, whose
// argmax wins only when strictly greater (:395), and lax.top_k(best, 1): the
// best partition, the lowest p among equal scores.
//
// Bound on this card: operations. Every cell is one score_action (the body of
// K3, ~100 operations, score_goal.cuh) and the distinct bytes are the
// model's rows once (assignment, part_load, rack counts) plus the per-broker
// words. The smoke model's grid has 199,518 x 3 x 16 move cells and
// 199,518 x 2 promotions, 10M scores; none of them is written to memory.
//
// Design: one thread per partition runs its R*K move cells and R-1
// promotions in the reference's order, keeping the first maximum, and bids a
// 64-bit key (order-preserving bits of the score, ~p) with atomicMax, as K2
// does; -0.0 bids as +0.0, because jnp.argmax and lax.top_k count them
// equal. Then one thread decodes the winning p and scores that partition
// again with the same function, which gives the winner's score, kind, slot
// and destination without a per-partition buffer. With every cell -inf the
// winner is p 0, slot 0, and the first destination candidate (kind MOVE), or
// broker 0 for a goal without moves, as the reference's initial values give.
#include "score_goal.cuh"

struct GridArgs {
  ScoreCtx c;
  const int* dst_cands;  // i32[K]
  int P, K;
  bool uses_moves, use_leadership;
  unsigned long long* key;  // u64[1] scratch, zeroed before the bid
  float* out_score;         // f32[1]
  int* out_idx;             // i32[4]: p, kind, slot, dst
};

struct Best {
  float score;
  int kind, slot, dst;
};

__device__ __forceinline__ Best partition_best(const GridArgs& g, int p) {
  Best b{-INFINITY, KIND_MOVE, 0, 0};
  const int R = g.c.R;
  if (g.uses_moves) {
    b.dst = g.dst_cands[0];
    bool first = true;
    for (int s = 0; s < R; ++s)
      for (int k = 0; k < g.K; ++k) {
        const int d = g.dst_cands[k];
        const float v = score_action(g.c, p, KIND_MOVE, s, d);
        if (first || v > b.score) {
          b.score = v;
          b.slot = s;
          b.dst = d;
          first = false;
        }
      }
  }
  if (g.use_leadership) {
    float lb = -INFINITY;
    int ls = 1;
    for (int s = 1; s < R; ++s) {
      const float v = score_action(g.c, p, KIND_LEADERSHIP, s, g.c.assignment[(long long)p * R + s]);
      if (s == 1 || v > lb) {
        lb = v;
        ls = s;
      }
    }
    if (lb > b.score) {
      b.score = lb;
      b.kind = KIND_LEADERSHIP;
      b.slot = ls;
      b.dst = g.c.assignment[(long long)p * R + ls];
    }
  }
  return b;
}

__device__ __forceinline__ unsigned int order_bits(float v) {
  unsigned int u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void k_grid_bid(GridArgs g) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= g.P) return;
  const Best b = partition_best(g, p);
  const unsigned long long key =
      ((unsigned long long)order_bits(b.score) << 32) | (unsigned long long)(~(unsigned int)p);
  atomicMax(g.key, key);
}

__global__ void k_grid_take(GridArgs g) {
  const int p = (int)~(unsigned int)(g.key[0] & 0xffffffffull);
  const Best b = partition_best(g, p);
  g.out_score[0] = b.score;
  g.out_idx[0] = p;
  g.out_idx[1] = b.kind;
  g.out_idx[2] = b.slot;
  g.out_idx[3] = b.dst;
}

// ptrs (in this order): out_score f32[1], out_idx i32[4], key u64[1]
//   (scratch), dst_cands i32[K], then the score context (read_score_ctx,
//   score_goal.cuh)
// ints: P, K, uses_moves, use_leadership, R, NR, B, goal
CC_EXPORT int grid_shortlist(const long long* ptrs, const long long* ints, cudaStream_t stream) {
  GridArgs g;
  g.out_score = (float*)ptrs[0];
  g.out_idx = (int*)ptrs[1];
  g.key = (unsigned long long*)ptrs[2];
  g.dst_cands = (const int*)ptrs[3];
  read_score_ctx(g.c, ptrs, 4, ints + 4);
  g.P = (int)ints[0];
  g.K = (int)ints[1];
  g.uses_moves = ints[2] != 0;
  g.use_leadership = ints[3] != 0;
  if (g.P <= 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(g.key, 0, sizeof(unsigned long long), stream);
  if (e != cudaSuccess) return e;
  k_grid_bid<<<(g.P + 127) / 128, 128, 0, stream>>>(g);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  k_grid_take<<<1, 1, 0, stream>>>(g);
  return cudaGetLastError();
}
