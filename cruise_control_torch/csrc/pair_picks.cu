// K6 pair_picks: the first k movable slots (lowest flat index p * R + slot)
// of each of V (topic, broker) pairs.
//
// Replaces: cruise_control_tpu/analyzer/drain.py pair_replica_picks (:235),
// k segment_min passes of the flat slot index over T * B + 1 group ids.
//
// Bound on this card: bytes. The call reads the P * R assignment (2.4 MB on
// the bucketed smoke model), each partition's topic and movable flag and
// each broker's pair row once: about 3.4 MB, ~1 us at the card's rate.
//
// Design: no T * B group table (10.4M groups on the smoke model), and one
// read of the slots. The V pairs' brokers are distinct, so a table
// row_of[B] names the one row a slot can belong to. Every slot of its row's
// topic inserts its flat index into the row's k-entry list with an
// atomicMin cascade: v = index; for j in 0..k-1, old = atomicMin(&list[j],
// v), v = max(old, v), until v is the sentinel. Each level is a
// linearizable atomicMin, so level j ends holding the row's j-th smallest
// index whatever the order of arrival: exactly the reference's k segment
// minima. The lists are per-device scratch that every call leaves at the
// sentinel. A row with fewer than k slots reports the last slot with found
// = 0, as the reference does. Two launches, in one of two configurations
// chosen by the broker count:
//   - up to 12,288 brokers (48 KB): k_pair_pass<true> builds row_of in each
//     block's shared memory while its slots' loads are in flight, then the
//     pass; k_pair_take, a thread a list entry, writes (p, slot, found) and
//     puts the entry back at the sentinel;
//   - above: k_pair_rows writes row_of into a per-device table kept at -1,
//     and k_pair_pass<false>'s last block to finish (an atomic ticket after
//     __threadfence) writes the picks and puts row_of, the lists and the
//     ticket back.
#include "common.cuh"

constexpr int K6_THREADS = 256;
constexpr int K6_ITEMS = 4;  // slots a thread takes
constexpr int K6_NONE = 0x7FFFFFFF;
constexpr long long K6_SHARED_ROWS = 12288;  // brokers whose rows fit 48 KB of shared memory

__global__ void k_pair_rows(const int* __restrict__ pair_b, int v, int B, int* __restrict__ row_of) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= v) return;
  const int b = pair_b[i];
  if (b >= 0 && b < B) row_of[b] = i;
}

// (p, slot, found) of list entry o, which goes back to the sentinel
__device__ __forceinline__ void take(int* lists, long long o, long long n, int R, int* out_p,
                                     int* out_s, unsigned char* out_ok) {
  const int idx = __ldcg(lists + o);
  const bool found = idx != K6_NONE;
  const long long sel = found ? idx : n - 1;
  out_p[o] = (int)(sel / R);
  out_s[o] = (int)(sel % R);
  out_ok[o] = found ? 1 : 0;
  lists[o] = K6_NONE;
}

template <bool SHARED_ROWS>
__global__ void __launch_bounds__(K6_THREADS)
    k_pair_pass(const int* __restrict__ assignment, const int* __restrict__ topic_id,
                const unsigned char* __restrict__ movable, const int* __restrict__ pair_t,
                const int* __restrict__ pair_b, int* row_of, int* lists, unsigned int* ticket,
                long long n, int R, int B, int v, int k, int* __restrict__ out_p,
                int* __restrict__ out_s, unsigned char* __restrict__ out_ok) {
  extern __shared__ int s_row[];  // SHARED_ROWS: row_of[B]
  __shared__ bool s_last;
  const long long base = (long long)blockIdx.x * K6_THREADS * K6_ITEMS + threadIdx.x;
  // every load issued, at a clamped index, before any is used
  int b[K6_ITEMS];
#pragma unroll
  for (int j = 0; j < K6_ITEMS; ++j) b[j] = assignment[min(base + j * K6_THREADS, n - 1)];
  int t[K6_ITEMS];
  unsigned char mv[K6_ITEMS];
#pragma unroll
  for (int j = 0; j < K6_ITEMS; ++j) {
    const long long p = min(base + j * K6_THREADS, n - 1) / R;
    t[j] = topic_id[p];
    mv[j] = movable[p];
  }
  const int* rows = row_of;
  if constexpr (SHARED_ROWS) {
    for (int x = threadIdx.x; x < B; x += K6_THREADS) s_row[x] = -1;
    __syncthreads();
    for (int r = threadIdx.x; r < v; r += K6_THREADS) {
      const int bb = pair_b[r];
      if (bb >= 0 && bb < B) s_row[bb] = r;
    }
    __syncthreads();
    rows = s_row;
  }
  int row[K6_ITEMS];
#pragma unroll
  for (int j = 0; j < K6_ITEMS; ++j) row[j] = rows[b[j] >= 0 && b[j] < B ? b[j] : 0];
#pragma unroll
  for (int j = 0; j < K6_ITEMS; ++j) {
    const long long i = base + j * K6_THREADS;
    bool mine = i < n && b[j] >= 0 && b[j] < B && mv[j] && row[j] >= 0;
    mine = mine && t[j] == pair_t[mine ? row[j] : 0];
    if (!mine) continue;
    int* list = lists + (long long)row[j] * k;
    int x = (int)i;
    for (int q = 0; q < k && x != K6_NONE; ++q) {
      const int old = atomicMin(list + q, x);
      x = old > x ? old : x;
    }
  }
  if constexpr (!SHARED_ROWS) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    // the last block: every row's picks, then the scratch back at its state
    __threadfence();
    for (long long o = threadIdx.x; o < (long long)v * k; o += K6_THREADS)
      take(lists, o, n, R, out_p, out_s, out_ok);
    for (int r = threadIdx.x; r < v; r += K6_THREADS) {
      const int bb = pair_b[r];
      if (bb >= 0 && bb < B) row_of[bb] = -1;
    }
    if (threadIdx.x == 0) *ticket = 0u;
  }
}

__global__ void k_pair_take(int* lists, long long vk, long long n, int R, int* __restrict__ out_p,
                            int* __restrict__ out_s, unsigned char* __restrict__ out_ok) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o < vk) take(lists, o, n, R, out_p, out_s, out_ok);
}

// assignment i32[P*R], topic_id i32[P], movable u8[P], pair_t, pair_b i32[V];
// row_of i32[>= B] (scratch at -1), lists i32[>= V*k] (scratch at
// INT32_MAX), ticket u32 (scratch at 0), each left so; out_p, out_s i32[V,
// k], out_ok u8[V, k]. P * R < 2**31 - 1.
CC_EXPORT int pair_picks(const int* assignment, const int* topic_id, const unsigned char* movable,
                         const int* pair_t, const int* pair_b, int* row_of, int* lists,
                         unsigned int* ticket, int* out_p, int* out_s, unsigned char* out_ok,
                         long long P, long long R, long long B, long long V, long long k,
                         cudaStream_t stream) {
  const long long n = P * R;
  if (V <= 0 || k <= 0) return cudaSuccess;
  if (n <= 0 || R <= 0 || n >= 0x7FFFFFFFLL || B <= 0 || B > 0x7FFFFFFFLL || V * k > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  const long long per_block = (long long)K6_THREADS * K6_ITEMS;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  cudaError_t e;
  if (B <= K6_SHARED_ROWS) {
    k_pair_pass<true><<<blocks, K6_THREADS, B * sizeof(int), stream>>>(
        assignment, topic_id, movable, pair_t, pair_b, row_of, lists, ticket, n, (int)R, (int)B,
        (int)V, (int)k, out_p, out_s, out_ok);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    k_pair_take<<<(unsigned)((V * k + 255) / 256), 256, 0, stream>>>(lists, V * k, n, (int)R,
                                                                     out_p, out_s, out_ok);
    return cudaGetLastError();
  }
  k_pair_rows<<<(unsigned)((V + 255) / 256), 256, 0, stream>>>(pair_b, (int)V, (int)B, row_of);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  k_pair_pass<false><<<blocks, K6_THREADS, 0, stream>>>(
      assignment, topic_id, movable, pair_t, pair_b, row_of, lists, ticket, n, (int)R, (int)B,
      (int)V, (int)k, out_p, out_s, out_ok);
  return cudaGetLastError();
}
