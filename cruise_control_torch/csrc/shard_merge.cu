// K12 shard_merge: the mesh's merge of the shards' shortlist records.
//
// Replaces: cruise_control_tpu/parallel/spmd.py make_grid_shortlist, its
// global offset (:170-171: a shard's local row + axis_index * p_local) and
// its merge (:185-189): `jnp.lexsort((g_p, -g_score))` over the
// all-gathered [D * k_loc] winner records (score, global partition, kind,
// slot, dst), then the first k_sel. That order is `lax.top_k`'s over the
// whole partition axis: score descending, ties to the lowest global
// partition.
//
// The records come as the shards wrote them: record j is shard j / k_loc's,
// its partition field the shard's local row. The kernel forms the global
// partition itself, (j / k_loc) * p_local + local in int32 arithmetic that
// wraps as JAX's does, so no launch runs between the shards' K9 and this one.
//
// Record j comes before record i when (merge_before):
//   - i's score is NaN and j's is not (JAX's sort puts NaN last);
//   - else, both scores are numbers and j's is larger, compared as floats
//     (so -0.0 ties +0.0, as JAX's sort treats them);
//   - else (equal scores, or both NaN), j's global partition is lower, and
//     at an equal partition j's position (a total order whatever the input).
// A record's rank is the count of records before it; ranks are a
// permutation of 0..n-1, so each record below k_sel has its own output slot
// and no two threads write one place. A shard whose every score is -inf
// still competes by index: a round with no finite cell picks global row 0.
//
// Bound on this card: the records, 20 bytes each, read once and k_sel of
// them written (100 bytes at the greedy grid's 4 shards and k_sel = 1:
// 0.00000003 ms at 3.35 TB/s). n^2 comparisons; at the mesh's sizes (n = D *
// k_loc, 2-128 records) a call is one launch's latency, so the design is
// about what a launch waits on, not arithmetic.
//
// Design, by size (a thread a record, its rank counted over every record):
//   n <= 32       one warp: each lane holds its record in registers and
//                 reads the others' with __shfl_sync (no shared memory, no
//                 barrier);
//   n <= SM_STAGE ceil(n / SM_THREADS) blocks, each staging every record's
//                 score and global partition in shared memory;
//   beyond        the same blocks reading the records from device memory,
//                 shard by shard (no division a comparison), so no size the
//                 plain version takes is refused.
// The block paths compare MERGE_UNROLL records at a time, so that their reads
// overlap, and stop once the rank reaches k_sel.
#include "common.cuh"

constexpr int SM_THREADS = 256;
constexpr int SM_STAGE = 4096;  // records staged: 32 KB of (score, partition)
constexpr int SM_WARP = 32;

struct MergeArgs {
  const float* score;
  const int* rec;  // [n, 4]: local partition, kind, slot, dst
  int n, k, k_loc, p_local;
  float* out_score;  // [k]
  int* out_rec;      // [4, k]: global partition, kind, slot, dst
};

__device__ __forceinline__ bool merge_before(float sj, int pj, int j, float si, int pi, int i) {
  const bool nj = sj != sj, ni = si != si;
  if (nj != ni) return ni;
  if (!ni && sj != si) return sj > si;
  return pj < pi || (pj == pi && j < i);
}

// shard d's offset plus a local row, wrapping at 2**32 as JAX's int32 does
__device__ __forceinline__ int global_row(unsigned d, const MergeArgs& a, int local) {
  return (int)(d * (unsigned)a.p_local + (unsigned)local);
}

__device__ __forceinline__ void write_rank(const MergeArgs& a, int i, int rank, float s, int p) {
  if (rank >= a.k) return;
  a.out_score[rank] = s;
  a.out_rec[rank] = p;
#pragma unroll
  for (int f = 1; f < 4; ++f) a.out_rec[f * a.k + rank] = a.rec[4 * i + f];
}

// MERGE_UNROLL comparisons issued together in the block paths: their
// reads overlap instead of waiting on each other (the warp path's at most
// 32 shuffles gain nothing from it on an H100)
constexpr int MERGE_UNROLL = 8;

__global__ void __launch_bounds__(SM_WARP) k_shard_merge_warp(MergeArgs a) {
  const int i = threadIdx.x;
  const bool live = i < a.n;
  const float si = live ? a.score[i] : 0.0f;
  const int pi = live ? global_row((unsigned)(i / a.k_loc), a, a.rec[4 * i]) : 0;
  int rank = 0;
  for (int j = 0; j < a.n; ++j) {  // a.n is the warp's: no divergence
    const float sj = __shfl_sync(0xffffffffu, si, j);
    const int pj = __shfl_sync(0xffffffffu, pi, j);
    rank += merge_before(sj, pj, j, si, pi, i);
  }
  if (live) write_rank(a, i, rank, si, pi);
}

template <bool STAGED>
__global__ void __launch_bounds__(SM_THREADS) k_shard_merge(MergeArgs a) {
  extern __shared__ float s_score[];
  int* s_p = reinterpret_cast<int*>(s_score + (STAGED ? a.n : 0));
  if (STAGED) {
    for (int j = threadIdx.x; j < a.n; j += SM_THREADS) {
      s_score[j] = a.score[j];
      s_p[j] = global_row((unsigned)(j / a.k_loc), a, a.rec[4 * j]);
    }
    __syncthreads();
  }
  const int i = blockIdx.x * SM_THREADS + threadIdx.x;
  if (i >= a.n) return;
  const float si = a.score[i];
  const int pi = STAGED ? s_p[i] : global_row((unsigned)(i / a.k_loc), a, a.rec[4 * i]);
  int rank = 0;
  if (STAGED) {
    // the early exit is checked once a group: a rank past k_sel writes nothing
    int j = 0;
    for (; j <= a.n - MERGE_UNROLL && rank < a.k; j += MERGE_UNROLL) {
#pragma unroll
      for (int u = 0; u < MERGE_UNROLL; ++u)
        rank += merge_before(s_score[j + u], s_p[j + u], j + u, si, pi, i);
    }
    for (; j < a.n && rank < a.k; ++j) rank += merge_before(s_score[j], s_p[j], j, si, pi, i);
  } else {
    unsigned d = 0;
    for (int j = 0; j < a.n && rank < a.k; ++d) {
      const int end = (int)min((long long)j + a.k_loc, (long long)a.n);
      for (; j <= end - MERGE_UNROLL && rank < a.k; j += MERGE_UNROLL) {
#pragma unroll
        for (int u = 0; u < MERGE_UNROLL; ++u)
          rank += merge_before(a.score[j + u], global_row(d, a, a.rec[4 * (j + u)]), j + u, si,
                               pi, i);
      }
      for (; j < end && rank < a.k; ++j)
        rank += merge_before(a.score[j], global_row(d, a, a.rec[4 * j]), j, si, pi, i);
    }
  }
  write_rank(a, i, rank, si, pi);
}

// score f32[n], rec i32[n, 4] (local partition, kind, slot, dst), both
// contiguous, record j from shard j / k_loc of p_local rows; out_score
// f32[k], out_rec i32[4, k] with global partitions; 1 <= k <= n < 2**31,
// 1 <= k_loc < 2**31, 0 <= p_local < 2**31.
CC_EXPORT int shard_merge(const void* score, const void* rec, void* out_score, void* out_rec,
                          long long n, long long k, long long k_loc, long long p_local,
                          cudaStream_t stream) {
  if (n < 1 || k < 1 || k > n || n > 0x7FFFFFFFLL || k_loc < 1 || k_loc > 0x7FFFFFFFLL ||
      p_local < 0 || p_local > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  const MergeArgs a{(const float*)score, (const int*)rec, (int)n, (int)k, (int)k_loc,
                    (int)p_local, (float*)out_score, (int*)out_rec};
  const unsigned blocks = (unsigned)((n + SM_THREADS - 1) / SM_THREADS);
  if (n <= SM_WARP)
    k_shard_merge_warp<<<1, SM_WARP, 0, stream>>>(a);
  else if (n <= SM_STAGE)
    k_shard_merge<true><<<blocks, SM_THREADS, (size_t)n * 8, stream>>>(a);
  else
    k_shard_merge<false><<<blocks, SM_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}
