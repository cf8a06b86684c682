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
// model padded for 8 shards, 0.00077 ms at 3.35 TB/s; a launch takes about
// 1 us, so the design is about loads in flight and what a launch waits on.
//
// Design: one launch, no memset.
//   - The flags are read 16 at a time as uint4 and counted with byte SIMD
//     (__vcmpne4 marks each non-zero byte, __popc counts the marks); the
//     slots as int4 over the flat n x r words (a count of populated slots
//     does not care where a row ends). A shard's inputs are row-block views
//     at any address: the bytes before the first 16-byte boundary (the
//     head) and those after the last whole vector (the tail), fewer than 16
//     flags and 4 words each, are counted one by one by the first threads.
//   - Each thread loads PS_VECTORS vectors of each input before it counts
//     any, so a pass waits on one memory round trip, not one a vector.
//   - The grid is sized to the card: its SM count times the blocks of
//     PS_THREADS an SM holds at once (read once a device by
//     partition_stats_grid and kept beside the scratch), or fewer where the
//     input gives each thread fewer than PS_VECTORS vectors; a grid-stride
//     loop covers the rest. Every block adds to the chain the last block
//     waits on (its reduction and ticket): on an H100 the card's whole grid
//     at every size took 1.4-1.6x the time of the grid cut to the input at
//     the mesh's shapes (scripts/kernel_variants.py --only K12,K13).
//   - Each block reduces its counts (warp shuffles, then one warp over the
//     warps' sums) and writes them to its own pair of scratch words; the
//     last block to take the atomic ticket adds the blocks' pairs, writes
//     the totals and leaves every scratch word 0 (the pairs and the
//     ticket), so the scratch needs no memset. A grid of one block writes
//     its counts directly. The ticket is a release-acquire atomic, which
//     orders the counts before it without a full fence on either side:
//     that chain, not the loads, is most of a launch's time (on an H100 a
//     launch without the ticket took about half as long, one without loads
//     four fifths; scripts/kernel_variants.py --only K12,K13).
// Counts accumulate as unsigned and are written as int32, wrapping as JAX's.
#include "common.cuh"

#include <cuda/atomic>

constexpr int PS_THREADS = 256;
constexpr int PS_VECTORS = 2;  // 16-byte vectors of each input a thread loads at once

struct PsArgs {
  const unsigned char* movable;
  const int* slots;
  long long n, n_slots;
  long long m_head, m_vecs;  // flags before the first 16-byte boundary; whole uint4 after it
  long long s_head, s_vecs;  // slots before the first 16-byte boundary; whole int4 after it
  unsigned int* partial;     // [2 * grid]: each block's two counts
  unsigned int* ticket;
  int* out;
};

__device__ __forceinline__ unsigned ps_warp_sum(unsigned x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The block's sums of (m, a), valid in thread 0; s_m and s_a hold a warp's
// sum each.
__device__ __forceinline__ void ps_block_sum(unsigned& m, unsigned& a, unsigned* s_m,
                                             unsigned* s_a) {
  const int tid = threadIdx.x;
  m = ps_warp_sum(m);
  a = ps_warp_sum(a);
  if ((tid & 31) == 0) {
    s_m[tid >> 5] = m;
    s_a[tid >> 5] = a;
  }
  __syncthreads();
  if (tid < 32) {
    m = ps_warp_sum(tid < PS_THREADS / 32 ? s_m[tid] : 0u);
    a = ps_warp_sum(tid < PS_THREADS / 32 ? s_a[tid] : 0u);
  }
}

// the non-zero bytes of a 16-byte vector
__device__ __forceinline__ unsigned nonzero_bytes(uint4 v) {
  return (__popc(__vcmpne4(v.x, 0u)) + __popc(__vcmpne4(v.y, 0u)) + __popc(__vcmpne4(v.z, 0u)) +
          __popc(__vcmpne4(v.w, 0u))) >> 3;
}

__global__ void __launch_bounds__(PS_THREADS) k_partition_stats(PsArgs g) {
  __shared__ unsigned s_m[PS_THREADS / 32], s_a[PS_THREADS / 32];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  const long long t = (long long)blockIdx.x * PS_THREADS + tid;
  const long long stride = (long long)gridDim.x * PS_THREADS;
  unsigned m = 0u, a = 0u;
  const uint4* mv = reinterpret_cast<const uint4*>(g.movable + g.m_head);
  const int4* sv = reinterpret_cast<const int4*>(g.slots + g.s_head);
  // every load of a pass is issued before any is counted, flags and slots
  // together: one memory round trip a pass (a grid sized to the input makes
  // one pass)
  for (long long v0 = t; v0 < g.m_vecs || v0 < g.s_vecs; v0 += stride * PS_VECTORS) {
    uint4 f[PS_VECTORS];
    int4 x[PS_VECTORS];
#pragma unroll
    for (int u = 0; u < PS_VECTORS; ++u) {
      const long long v = v0 + u * stride;
      f[u] = v < g.m_vecs ? mv[v] : make_uint4(0u, 0u, 0u, 0u);
      x[u] = v < g.s_vecs ? sv[v] : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < PS_VECTORS; ++u) {
      m += nonzero_bytes(f[u]);
      a += (unsigned)(x[u].x >= 0) + (unsigned)(x[u].y >= 0) + (unsigned)(x[u].z >= 0) +
           (unsigned)(x[u].w >= 0);
    }
  }
  if (t < 16) {  // the heads and the tails
    const long long m_tail = g.m_head + 16 * g.m_vecs + t;
    const long long s_tail = g.s_head + 4 * g.s_vecs + t;
    if (t < g.m_head) m += g.movable[t] != 0;
    if (m_tail < g.n) m += g.movable[m_tail] != 0;
    if (t < g.s_head) a += g.slots[t] >= 0;
    if (t < 4 && s_tail < g.n_slots) a += g.slots[s_tail] >= 0;
  }
  ps_block_sum(m, a, s_m, s_a);
  if (tid == 0) {
    if (gridDim.x == 1) {
      g.out[0] = (int)m;
      g.out[1] = (int)a;
      g.out[2] = (int)g.n;
    } else {
      g.partial[2 * blockIdx.x] = m;
      g.partial[2 * blockIdx.x + 1] = a;
      // release: this block's counts before its ticket; acquire: the last
      // block sees every count an earlier ticket released
      s_last = cuda::atomic_ref<unsigned, cuda::thread_scope_device>(*g.ticket)
                   .fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
    }
  }
  if (gridDim.x == 1) return;
  __syncthreads();
  if (!s_last) return;  // the barrier passes thread 0's acquire to the block
  volatile unsigned* partial = g.partial;
  m = a = 0u;
  for (unsigned b = tid; b < gridDim.x; b += PS_THREADS) {
    m += partial[2 * b];
    a += partial[2 * b + 1];
    partial[2 * b] = partial[2 * b + 1] = 0u;
  }
  ps_block_sum(m, a, s_m, s_a);
  if (tid == 0) {
    g.out[0] = (int)m;
    g.out[1] = (int)a;
    g.out[2] = (int)g.n;
    *g.ticket = 0u;
  }
}

// The most blocks a launch on `device` takes: its SM count times the blocks
// of k_partition_stats an SM holds at once; 0 if the device cannot say.
CC_EXPORT long long partition_stats_grid(long long device) {
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, (int)device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_partition_stats, PS_THREADS, 0) !=
          cudaSuccess)
    return 0;
  return (long long)sms * per_sm;
}

// The 32-bit words of a launch's scratch for grids of up to `grid` blocks:
// two counts a block and the ticket.
CC_EXPORT long long partition_stats_scratch_words(long long grid) { return 2 * grid + 1; }

// movable bool[n] (one byte a flag), assignment i32[n, r], each contiguous
// at any address (the assignment's 4-byte aligned, as every int32 tensor's
// is); out i32[3] (movable, populated slots, rows); scratch of
// partition_stats_scratch_words(grid) words, all 0 (every launch leaves
// them 0); grid from partition_stats_grid;
// 0 <= n < 2**31, r >= 0.
CC_EXPORT int partition_stats(const void* movable, const void* assignment, void* out,
                              void* scratch, long long n, long long r, long long grid,
                              cudaStream_t stream) {
  if (n < 0 || r < 0 || n > 0x7FFFFFFFLL || grid < 1 || ((uintptr_t)assignment & 3u))
    return cudaErrorInvalidValue;
  PsArgs g;
  g.movable = (const unsigned char*)movable;
  g.slots = (const int*)assignment;
  g.n = n;
  g.n_slots = n * r;
  const long long m_skip = (long long)((16u - ((uintptr_t)movable & 15u)) & 15u);
  g.m_head = m_skip < n ? m_skip : n;
  g.m_vecs = (n - g.m_head) / 16;
  const long long s_skip = (long long)(((16u - ((uintptr_t)assignment & 15u)) & 15u) / 4u);
  g.s_head = s_skip < g.n_slots ? s_skip : g.n_slots;
  g.s_vecs = (g.n_slots - g.s_head) / 4;
  g.partial = (unsigned int*)scratch;
  g.ticket = g.partial + 2 * grid;
  g.out = (int*)out;
  const long long vecs = g.m_vecs > g.s_vecs ? g.m_vecs : g.s_vecs;
  long long blocks = (vecs + (long long)PS_THREADS * PS_VECTORS - 1) /
                     ((long long)PS_THREADS * PS_VECTORS);
  blocks = blocks < 1 ? 1 : blocks > grid ? grid : blocks;
  k_partition_stats<<<(unsigned)blocks, PS_THREADS, 0, stream>>>(g);
  return cudaGetLastError();
}
