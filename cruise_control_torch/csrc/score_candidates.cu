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
// reference gathers one assignment row, one part_load row and a few dozen
// per-broker / per-host / per-topic / per-rack aggregate and table words,
// and does ~100 flops. The drain round's [512, 8, 64] move grid (262,144
// cells) touches at most 4,096 partitions and the 64 destination brokers;
// the [P, R-1] promotion grid (399,036 cells) reads every partition's row
// once. Both are a few MB of distinct bytes.
//
// Design: the score is split into a source half, a destination half and a
// combine step (score_goal.cuh), and the (p, kind, slot, dst) index tensors
// are read through broadcast strides, so a lazy [V,K,1] x [1,1,C] grid is
// never materialised. The host picks one of three paths from the strides
// (kernels/score_candidates.py choose_path), with no device read:
//   - factored (k_score_tiles): p, kind and slot constant along the last
//     axis, dst along the first two, from 131,072 cells (below that, and
//     where dst depends on the first axis, a tile loses to a thread a cell
//     on this card: PERF.md). A block takes a tile of up to
//     1,024 cells, TR rows (one (p, kind, slot) each) by TC columns (one dst
//     each; TR as many as 48 KB of shared memory holds, at TC = 2 and 4),
//     stages each row's source half and each column's destination half in
//     shared memory once, then each thread loads the pair words of its four
//     cells together and combines them. A destination's words are read once
//     per 1,024-cell tile, not once per cell. The drain round's [512, 8, 64]
//     move grids take it. Any size: an assignment row too wide to stage
//     (R of about 12,000) is read in device memory instead, and past 65,535
//     column tiles a block loops over its grid row's tiles.
//   - general (k_score_cells): two threads a cell, one loading its source
//     half, the other its destination half and pair words, every load at a
//     clamped address, so that each follows one chain of dependent gathers;
//     blocks of 32 cells, so that a short launch (a wave's 512 cells) runs on
//     as many SMs as it can: its cost is that chain, not the card's
//     bandwidth.
//   - promotion (k_score_flat): p and kind constant along a last axis of at
//     most R-1 cells ([P, R-1] leadership grids, 400,000 cells and more), and
//     the factored layouts the tiles do not take (the pair drain's per-row
//     lists, the all-broker re-score [16, B]). A thread a cell loads both
//     halves, a leadership transfer's without the words only a move reads:
//     on this card the grid is bound by the gathers each cell issues.
//     (Loading the leader's half once a row, in shared memory or one thread
//     a row, measured slower: PERF.md.)
#include "score_goal.cuh"

enum ScorePath { PATH_GENERAL = 0, PATH_FACTORED = 1, PATH_PROMOTION = 2 };

constexpr int TILE_THREADS = 256;
constexpr int TILE_CELLS_PER_THREAD = 4;
constexpr int TILE_CELLS = TILE_THREADS * TILE_CELLS_PER_THREAD;

struct ScoreArgs {
  ScoreCtx c;
  float* out;
  const int *p, *kind, *slot, *dst;
  long long sp[3], sk[3], ss[3], sd[3];
  long long d0, d1, d2;
};

__device__ __forceinline__ long long at(const long long* s, long long i0, long long i1,
                                        long long i2) {
  return i0 * s[0] + i1 * s[1] + i2 * s[2];
}

// The general path: 32 cells a block of 64 threads. Thread t of the first
// warp stages cell t's source half, thread t of the second its destination
// half and the pair's two words (read through the partition's topic), so
// that each thread follows one chain of dependent loads; then the first warp
// combines.
__global__ void __launch_bounds__(64) k_score_cells(ScoreArgs g) {
  __shared__ SrcHalf s_src[32];
  __shared__ DstHalf s_dst[32];
  __shared__ PairWords s_pw[32];
  const int t = threadIdx.x & 31;
  const bool dst_side = threadIdx.x >= 32;
  const long long e = (long long)blockIdx.x * 32 + t;
  const bool live = e < g.d0 * g.d1 * g.d2;
  const long long i0 = live ? e / (g.d1 * g.d2) : 0, rem = live ? e % (g.d1 * g.d2) : 0;
  const long long i1 = rem / g.d2, i2 = rem % g.d2;
  const int p = live ? ld(g.p + at(g.sp, i0, i1, i2)) : 0;
  const int kind = live ? ld(g.kind + at(g.sk, i0, i1, i2)) : KIND_LEADERSHIP;
  if (live && !dst_side) {
    s_src[t] = src_half(g.c, p, kind, ld(g.slot + at(g.ss, i0, i1, i2)));
  } else if (live) {
    const int dst = ld(g.dst + at(g.sd, i0, i1, i2));
    const DstHalf d = dst_half(g.c, dst, kind == KIND_MOVE);
    s_dst[t] = d;
    // the pair words through the partition's topic: only a move reads them
    const bool move = kind == KIND_MOVE;
    s_pw[t] = pair_words(g.c, move, move ? ld(g.c.topic_id + p) : 0, p, dst, d.rack);
  }
  __syncthreads();
  if (dst_side || !live) return;
  g.out[e] = combine(g.c, load_scalars(g.c), s_src[t], s_dst[t],
                     g.c.assignment + (long long)p * g.c.R, s_pw[t]);
}

// The promotion path: a thread a cell, both halves loaded by the thread
// with no shared memory and no barrier, a leadership transfer's halves
// without the words only a move reads. On the [P, R-1] grids the cost is the
// gathers a cell issues, not their latency.
__global__ void __launch_bounds__(256) k_score_flat(ScoreArgs g) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= g.d0 * g.d1 * g.d2) return;
  const long long i0 = e / (g.d1 * g.d2), rem = e % (g.d1 * g.d2);
  const long long i1 = rem / g.d2, i2 = rem % g.d2;
  const int p = ld(g.p + at(g.sp, i0, i1, i2));
  const int kind = ld(g.kind + at(g.sk, i0, i1, i2));
  const SrcHalf s = src_half(g.c, p, kind, ld(g.slot + at(g.ss, i0, i1, i2)));
  const DstHalf d = dst_half(g.c, ld(g.dst + at(g.sd, i0, i1, i2)), kind == KIND_MOVE);
  g.out[e] = combine(g.c, load_scalars(g.c), s, d, g.c.assignment + (long long)p * g.c.R,
                     pair_words(g.c, s, d));
}

// Rows are the flattened (i0, i1) pairs, columns i2 (dst depends on i2
// alone). Launched with TILE_THREADS threads, tr * tc <= TILE_CELLS, and
// dynamic shared memory for tr SrcHalfs, tc DstHalfs and, where ROWS, tr
// assignment rows (without ROWS, a row wider than the static shared memory
// holds, the cells read the partition's row in device memory). Grid row y
// takes the column tiles y, y + gridDim.y, ... in turn, its rows staged once.
template <bool ROWS>
__global__ void __launch_bounds__(TILE_THREADS, 2)
    k_score_tiles(ScoreArgs g, int tr, int tc, long long col_tiles) {
  extern __shared__ int smem[];
  SrcHalf* s_src = reinterpret_cast<SrcHalf*>(smem);
  DstHalf* s_dst = reinterpret_cast<DstHalf*>(s_src + tr);
  int* s_row = reinterpret_cast<int*>(s_dst + tc);
  const int R = g.c.R;
  const long long row0 = (long long)blockIdx.x * tr, row_end = g.d0 * g.d1;
  const int tid = threadIdx.x;
  // stage: thread j < tr loads row j's source half and assignment row, the
  // next tc threads the first column tile's destination halves
  for (int j = tid; j < tr + tc; j += TILE_THREADS) {
    if (j < tr) {
      const long long row = row0 + j;
      if (row < row_end) {
        const long long i0 = row / g.d1, i1 = row % g.d1;
        const int p = ld(g.p + at(g.sp, i0, i1, 0));
        const int kind = ld(g.kind + at(g.sk, i0, i1, 0));
        const int slot = ld(g.slot + at(g.ss, i0, i1, 0));
        s_src[j] = src_half(g.c, p, kind, slot);
        if (ROWS)
          for (int k = 0; k < R; ++k) s_row[j * R + k] = ld(g.c.assignment + (long long)p * R + k);
      }
    } else {
      const long long col = (long long)blockIdx.y * tc + (j - tr);
      if (col < g.d2) s_dst[j - tr] = dst_half(g.c, ld(g.dst + at(g.sd, 0, 0, col)));
    }
  }
  __syncthreads();
  const Scalars sc = load_scalars(g.c);
  for (long long ct = blockIdx.y; ct < col_tiles; ct += gridDim.y) {
    const long long col0 = ct * tc;
    if (ct != blockIdx.y) {  // the next tile's destination halves
      __syncthreads();
      for (int j = tid; j < tc; j += TILE_THREADS)
        if (col0 + j < g.d2) s_dst[j] = dst_half(g.c, ld(g.dst + at(g.sd, 0, 0, col0 + j)));
      __syncthreads();
    }
    // each thread's cells: first every pair word, then every combine
    PairWords w[TILE_CELLS_PER_THREAD];
    bool live[TILE_CELLS_PER_THREAD];
#pragma unroll
    for (int i = 0; i < TILE_CELLS_PER_THREAD; ++i) {
      const int cell = tid + i * TILE_THREADS, jr = cell / tc, jc = cell % tc;
      live[i] = jr < tr && row0 + jr < row_end && col0 + jc < g.d2;
      if (live[i]) w[i] = pair_words(g.c, s_src[jr], s_dst[jc]);
    }
#pragma unroll
    for (int i = 0; i < TILE_CELLS_PER_THREAD; ++i) {
      const int cell = tid + i * TILE_THREADS, jr = cell / tc, jc = cell % tc;
      if (live[i])
        g.out[(row0 + jr) * g.d2 + col0 + jc] =
            combine(g.c, sc, s_src[jr], s_dst[jc],
                    ROWS ? s_row + jr * R : g.c.assignment + (long long)s_src[jr].p * R, w[i]);
    }
  }
}

// ctx: the score context (host memory, read here). out f32[d0, d1, d2]; p,
// kind, slot, dst i32 read through their element strides (0 on broadcast
// axes). layout (host memory): d0, d1, d2, the strides of p, kind, slot and
// dst (three each), and the ScorePath the caller chose from them.
CC_EXPORT int score_candidates(const ScoreCtx* ctx, float* out, const int* p, const int* kind,
                               const int* slot, const int* dst, const long long* layout,
                               cudaStream_t stream) {
  ScoreArgs g;
  g.c = *ctx;
  g.out = out;
  g.p = p;
  g.kind = kind;
  g.slot = slot;
  g.dst = dst;
  const long long d0 = layout[0], d1 = layout[1], d2 = layout[2], path = layout[15];
  for (int j = 0; j < 3; ++j) {
    g.sp[j] = layout[3 + j];
    g.sk[j] = layout[6 + j];
    g.ss[j] = layout[9 + j];
    g.sd[j] = layout[12 + j];
  }
  g.d0 = d0;
  g.d1 = d1;
  g.d2 = d2;
  const long long numel = d0 * d1 * d2;
  if (numel == 0) return cudaSuccess;
  if (path == PATH_FACTORED) {
    if (g.sp[2] != 0 || g.sk[2] != 0 || g.ss[2] != 0 || g.sd[0] != 0 || g.sd[1] != 0)
      return cudaErrorInvalidValue;
    int tc = 1;
    while (tc < d2 && tc < 128) tc *= 2;
    // as many rows as make a tile of TILE_CELLS, and no more than the
    // static shared-memory limit holds: narrow tiles (tc = 2, 4) are bound
    // by the rows' source halves, not by the cells. A row too wide for that
    // limit stays in device memory (the second configuration).
    const size_t smem_max = 48 * 1024, dst_bytes = tc * sizeof(DstHalf);
    const bool rows = dst_bytes + sizeof(SrcHalf) + (size_t)ctx->R * 4 <= smem_max;
    const size_t row_bytes = sizeof(SrcHalf) + (rows ? (size_t)ctx->R * 4 : 0);
    int tr = TILE_CELLS / tc;
    if ((size_t)tr > (smem_max - dst_bytes) / row_bytes)
      tr = (int)((smem_max - dst_bytes) / row_bytes);
    const long long row_tiles = (d0 * d1 + tr - 1) / tr;
    const long long col_tiles = (d2 + tc - 1) / tc;
    if (row_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
    const size_t smem = dst_bytes + (size_t)tr * row_bytes;
    const dim3 grid((unsigned)row_tiles, (unsigned)(col_tiles < 65535 ? col_tiles : 65535));
    if (rows)
      k_score_tiles<true><<<grid, TILE_THREADS, smem, stream>>>(g, tr, tc, col_tiles);
    else
      k_score_tiles<false><<<grid, TILE_THREADS, smem, stream>>>(g, tr, tc, col_tiles);
  } else if (path == PATH_PROMOTION) {
    if ((numel + 255) / 256 > 0x7fffffffLL) return cudaErrorInvalidValue;
    k_score_flat<<<(unsigned)((numel + 255) / 256), 256, 0, stream>>>(g);
  } else {
    if ((numel + 31) / 32 > 0x7fffffffLL) return cudaErrorInvalidValue;
    k_score_cells<<<(unsigned)((numel + 31) / 32), 64, 0, stream>>>(g);
  }
  return cudaGetLastError();
}
