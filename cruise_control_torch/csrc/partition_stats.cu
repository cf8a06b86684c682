// K13 partition_stats: a shard's exact coverage counts.
//
// Replaces: the per-shard body of cruise_control_tpu/parallel/spmd.py
// make_partition_stats (:218-227): over one shard's rows, the count of
// movable partitions (`static.movable_partition`), the count of populated
// assignment slots (`agg.assignment >= 0`) and the row count, each an
// int32 (JAX's sums wrap at 2**32 as these do). The mesh then sums the
// shards' counts (parallel/spmd.py): integer sums do not depend on their
// order, so the mesh total equals the unsharded count exactly.
//
// Bound on this card: bytes, each movable flag (1 byte) and each slot (4
// bytes) read once: 199,520 x (1 + 3 x 4) bytes = 2.6 MB at the smoke
// model padded for 8 shards, 0.00077 ms at 3.35 TB/s.
//
// Design: one launch, no memset. A grid-stride loop of int32 counts a
// thread, a warp-shuffle and shared-memory block reduction, one atomicAdd a
// block and count into a per-device accumulator; the last block to finish
// (an atomic ticket) moves the totals to the output with atomicExch, which
// leaves the accumulator and the ticket at 0 for the next launch. A grid of
// one block writes its counts directly.
#include "common.cuh"

constexpr int PS_THREADS = 256;
constexpr int PS_MAX_BLOCKS = 264;
constexpr int PS_PER_THREAD = 8;  // slots a thread counts before the grid grows

__device__ __forceinline__ int ps_warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(PS_THREADS)
    k_partition_stats(const unsigned char* __restrict__ movable, const int* __restrict__ slots,
                      long long n, long long n_slots, int* acc, unsigned int* ticket, int* out) {
  __shared__ int s_m[PS_THREADS / 32], s_a[PS_THREADS / 32];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const long long stride = (long long)gridDim.x * PS_THREADS;
  const long long first = (long long)blockIdx.x * PS_THREADS + tid;
  int m = 0, a = 0;
  for (long long i = first; i < n; i += stride) m += movable[i] != 0;
  for (long long i = first; i < n_slots; i += stride) a += slots[i] >= 0;
  m = ps_warp_sum(m);
  a = ps_warp_sum(a);
  if ((tid & 31) == 0) {
    s_m[tid >> 5] = m;
    s_a[tid >> 5] = a;
  }
  __syncthreads();
  if (tid < 32) {
    m = ps_warp_sum(tid < PS_THREADS / 32 ? s_m[tid] : 0);
    a = ps_warp_sum(tid < PS_THREADS / 32 ? s_a[tid] : 0);
    if (tid == 0) {
      if (gridDim.x == 1) {
        out[0] = m;
        out[1] = a;
        out[2] = (int)n;
      } else {
        atomicAdd(acc, m);
        atomicAdd(acc + 1, a);
        __threadfence();
        s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
      }
    }
  }
  if (gridDim.x == 1) return;
  __syncthreads();
  if (!s_last || tid != 0) return;
  __threadfence();
  out[0] = atomicExch(acc, 0);
  out[1] = atomicExch(acc + 1, 0);
  out[2] = (int)n;
  *ticket = 0u;
}

// The 32-bit words of a launch's scratch: two accumulators and the ticket.
CC_EXPORT long long partition_stats_scratch_words() { return 3; }

// movable bool[n] (one byte a flag), assignment i32[n, r], both contiguous;
// out i32[3] (movable, populated slots, rows); scratch of
// partition_stats_scratch_words(), all 0 (every launch leaves them 0);
// 0 <= n < 2**31, r >= 0.
CC_EXPORT int partition_stats(const void* movable, const void* assignment, void* out,
                              void* scratch, long long n, long long r, cudaStream_t stream) {
  if (n < 0 || r < 0 || n > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  const long long n_slots = n * r;
  const long long work = n_slots > n ? n_slots : n;
  long long blocks = (work + (long long)PS_THREADS * PS_PER_THREAD - 1) /
                     ((long long)PS_THREADS * PS_PER_THREAD);
  blocks = blocks < 1 ? 1 : blocks > PS_MAX_BLOCKS ? PS_MAX_BLOCKS : blocks;
  int* acc = (int*)scratch;
  k_partition_stats<<<(unsigned)blocks, PS_THREADS, 0, stream>>>(
      (const unsigned char*)movable, (const int*)assignment, n, n_slots, acc,
      (unsigned int*)(acc + 2), (int*)out);
  return cudaGetLastError();
}
