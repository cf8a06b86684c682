// K12 shard_merge: the mesh's merge of the shards' shortlist records.
//
// Replaces: cruise_control_tpu/parallel/spmd.py make_grid_shortlist, its
// merge (:183-190): `jnp.lexsort((g_p, -g_score))` over the all-gathered
// [D * k_loc] winner records (score, global partition, kind, slot, dst),
// then the first k_sel. That order is `lax.top_k`'s over the whole
// partition axis: score descending, ties to the lowest global partition.
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
// k_loc, 2-128 records) a call is one launch's latency.
//
// Design: a thread a record, its rank counted over every record, scores and
// partitions staged in shared memory up to SM_STAGE records (read from
// device memory beyond). ceil(n / SM_THREADS) blocks, so no size is refused.
#include "common.cuh"

constexpr int SM_THREADS = 256;
constexpr int SM_STAGE = 4096;  // records staged: 32 KB of (score, partition)

__device__ __forceinline__ bool merge_before(float sj, int pj, int j, float si, int pi, int i) {
  const bool nj = sj != sj, ni = si != si;
  if (nj != ni) return ni;
  if (!ni && sj != si) return sj > si;
  return pj < pi || (pj == pi && j < i);
}

template <bool STAGED>
__global__ void __launch_bounds__(SM_THREADS)
    k_shard_merge(const float* __restrict__ score, const int* __restrict__ rec, int n, int k,
                  float* __restrict__ out_score, int* __restrict__ out_rec) {
  extern __shared__ float s_score[];
  int* s_p = reinterpret_cast<int*>(s_score + (STAGED ? n : 0));
  if (STAGED) {
    for (int j = threadIdx.x; j < n; j += SM_THREADS) {
      s_score[j] = score[j];
      s_p[j] = rec[4 * j];
    }
    __syncthreads();
  }
  const int i = blockIdx.x * SM_THREADS + threadIdx.x;
  if (i >= n) return;
  const float si = score[i];
  const int pi = rec[4 * i];
  int rank = 0;
  for (int j = 0; j < n && rank < k; ++j) {
    const float sj = STAGED ? s_score[j] : score[j];
    const int pj = STAGED ? s_p[j] : rec[4 * j];
    rank += merge_before(sj, pj, j, si, pi, i);
  }
  if (rank < k) {
    out_score[rank] = si;
#pragma unroll
    for (int f = 0; f < 4; ++f) out_rec[f * k + rank] = rec[4 * i + f];
  }
}

// score f32[n], rec i32[n, 4] (global partition, kind, slot, dst), both
// contiguous; out_score f32[k], out_rec i32[4, k]; 1 <= k <= n < 2**31.
CC_EXPORT int shard_merge(const void* score, const void* rec, void* out_score, void* out_rec,
                          long long n, long long k, cudaStream_t stream) {
  if (n < 1 || k < 1 || k > n || n > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + SM_THREADS - 1) / SM_THREADS);
  if (n <= SM_STAGE)
    k_shard_merge<true><<<blocks, SM_THREADS, (size_t)n * 8, stream>>>(
        (const float*)score, (const int*)rec, (int)n, (int)k, (float*)out_score, (int*)out_rec);
  else
    k_shard_merge<false><<<blocks, SM_THREADS, 0, stream>>>(
        (const float*)score, (const int*)rec, (int)n, (int)k, (float*)out_score, (int*)out_rec);
  return cudaGetLastError();
}
