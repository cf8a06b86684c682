// K7 state_fingerprint: a uint32 hash of the per-broker aggregates' bit
// patterns, each element weighted by an odd multiplier of its position.
//
// Replaces: cruise_control_tpu/analyzer/optimizer.py _state_fingerprint
// (:1199), which the chunked goal machine evaluates at every goal pause or
// exit to fill StackMetrics.state_fp (the polish pass's skip test).
//
//   fp = sum over the four arrays, each with its salt, of
//        bits(x_i) * (((i + 1) * 2654435761 + salt) | 1)      (mod 2^32)
//
// in the order broker_load f32[B, 4] (row-major), leader_nw_in f32[B],
// leader_count i32[B], replica_count i32[B]. Floats contribute their bit
// patterns, so -0.0 and 0.0 differ. Addition mod 2^32 does not depend on the
// order, so any reduction tree gives the reference's value exactly; a
// weight needs i only mod 2^32, so it is computed from the low word of i.
//
// Bound on this card: bytes, 7 * B words read (86 KB at the bucketed main
// path's 3,072 brokers: 0.0000257 ms at 3.35 TB/s); what a call takes is
// launch latency and a few dependent memory round trips.
//
// Design: one launch, no memset. Each array is read as whole 16-byte
// vectors (uint4) from its first 16-byte boundary; the up to 3 words before
// it (a view need not be aligned) and after its last vector are taken as
// scalars by block 0's first 24 threads. The four arrays' vectors form one
// index space: a thread issues its FP_UNROLL loads (at an index clamped into
// the space) before any multiply, then adds the products of those in range.
// Each warp reduces with __shfl_xor_sync, then one shared word a warp. The
// grid is ceil(vectors / (FP_THREADS * FP_UNROLL)) blocks (11 at 3,072
// brokers), at most FP_MAX_BLOCKS, each looping over the space; a grid of
// one block writes its total, a larger one's last block to finish adds the
// blocks' partial sums (an atomic ticket it resets, so no memset is needed
// and back-to-back launches on one stream stay exact). Indices are 32-bit
// where 4 * B words and the loop's last step fit, 64-bit past that (a
// second instantiation chosen by size): any B the plain version takes.
//
// Measured (scripts/kernel_variants.py, NVIDIA H100 80GB HBM3, 700 W):
// 0.0030 ms at 3,072 brokers, 0.0054 ms at 300,001; an empty launch
// 0.00085 ms. Fewer loads a thread ran faster: blocks of 256 x 4 vectors
// 0.0037, one block of 1,024 x 6 0.0035-0.0039; 64-bit indices 0.0031.
#include "common.cuh"

constexpr int FP_THREADS = 256;
constexpr int FP_UNROLL = 2;  // vectors a thread loads at once
constexpr int FP_MAX_BLOCKS = 264;
constexpr long long FP_BLOCK_VECTORS = (long long)FP_THREADS * FP_UNROLL;
constexpr uint32_t FP_MUL = 2654435761u;

// One input array: `n` 32-bit words from `p`; `head` words (0-3) before its
// first 16-byte boundary, then `vec` whole vectors, then the tail.
struct FpArray {
  const uint32_t* p;
  long long n, vec;
  int head;
  uint32_t salt;
};

// The four arrays in the reference's order; array s's vectors start at
// start[s] of the common vector space (start[0] = 0), which ends at v.
struct FpArgs {
  FpArray a0, a1, a2, a3;
  long long start1, start2, start3, v;
};

// Field f of array s, selected by value (no address of the kernel argument
// is taken, so it is never copied to local memory).
#define FP_FIELD(g, s, f) \
  ((s) == 0 ? (g).a0.f : (s) == 1 ? (g).a1.f : (s) == 2 ? (g).a2.f : (g).a3.f)

__device__ __forceinline__ uint32_t warp_sum(uint32_t x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The array of vector j and the word index of its first element there.
template <typename I>
__device__ __forceinline__ int fp_locate(const FpArgs& g, I j, I& word) {
  const int s = (j >= (I)g.start1) + (j >= (I)g.start2) + (j >= (I)g.start3);
  const I start = s == 0 ? (I)0 : s == 1 ? (I)g.start1 : s == 2 ? (I)g.start2 : (I)g.start3;
  word = (I)FP_FIELD(g, s, head) + (j - start) * 4;
  return s;
}

template <typename I>
__global__ void __launch_bounds__(FP_THREADS)
    k_state_fingerprint(FpArgs g, uint32_t* partials, unsigned int* ticket, long long* out) {
  __shared__ uint32_t s_warp[FP_THREADS / 32];
  __shared__ bool s_last;
  const int tid = threadIdx.x;
  uint32_t acc = 0u;
  if (blockIdx.x == 0 && tid < 24) {  // heads and tails, 3 + 3 words an array at most
    const int s = tid / 6, k = tid % 6, head = FP_FIELD(g, s, head);
    const long long i = k < 3 ? k : head + 4 * FP_FIELD(g, s, vec) + (k - 3);
    if (k < 3 ? k < head : i < FP_FIELD(g, s, n))
      acc = FP_FIELD(g, s, p)[i] * ((((uint32_t)i + 1u) * FP_MUL + FP_FIELD(g, s, salt)) | 1u);
  }
  const I v = (I)g.v;
  for (I base = (I)blockIdx.x * (I)FP_BLOCK_VECTORS; base < v;
       base += (I)gridDim.x * (I)FP_BLOCK_VECTORS) {
    uint4 x[FP_UNROLL];
#pragma unroll
    for (int u = 0; u < FP_UNROLL; ++u) {
      const I j = min(base + (I)(u * FP_THREADS + tid), v - 1);
      I word;
      const int s = fp_locate(g, j, word);
      x[u] = *reinterpret_cast<const uint4*>(FP_FIELD(g, s, p) + word);
    }
#pragma unroll
    for (int u = 0; u < FP_UNROLL; ++u) {
      const I j = base + (I)(u * FP_THREADS + tid);
      I word;
      const int s = fp_locate(g, j < v ? j : v - 1, word);
      const uint32_t w = ((uint32_t)word + 1u) * FP_MUL + FP_FIELD(g, s, salt);
      const uint32_t t = x[u].x * (w | 1u) + x[u].y * ((w + FP_MUL) | 1u) +
                         x[u].z * ((w + 2u * FP_MUL) | 1u) + x[u].w * ((w + 3u * FP_MUL) | 1u);
      acc += j < v ? t : 0u;
    }
  }
  acc = warp_sum(acc);
  if ((tid & 31) == 0) s_warp[tid >> 5] = acc;
  __syncthreads();
  if (tid < 32) {
    uint32_t t = warp_sum(tid < FP_THREADS / 32 ? s_warp[tid] : 0u);
    if (tid == 0) {
      if (gridDim.x == 1) {
        out[0] = (long long)t;
      } else {
        partials[blockIdx.x] = t;
        __threadfence();
        s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
      }
    }
  }
  if (gridDim.x == 1) return;
  __syncthreads();
  if (!s_last || tid >= 32) return;
  __threadfence();
  uint32_t t = 0u;
  for (int b = tid; b < (int)gridDim.x; b += 32) t += __ldcg(partials + b);
  t = warp_sum(t);
  if (tid == 0) {
    out[0] = (long long)t;
    *ticket = 0u;
  }
}

static FpArray fp_array_of(const void* p, long long n, uint32_t salt) {
  FpArray a;
  a.p = (const uint32_t*)p;
  a.n = n;
  a.salt = salt;
  const long long head = (long long)(((16 - ((uintptr_t)p & 15)) & 15) / 4);
  a.head = (int)(head < n ? head : n);
  a.vec = (n - a.head) / 4;
  return a;
}

// The u32 words of a launch's scratch: the ticket, then a partial sum a block.
CC_EXPORT long long state_fingerprint_scratch_words() { return 1 + FP_MAX_BLOCKS; }

// broker_load f32[B, 4], leader_nw_in f32[B], leader_count i32[B],
// replica_count i32[B] (contiguous, each at least 4-byte aligned); out
// i64[1]; scratch of state_fingerprint_scratch_words(), its first word 0
// (the ticket; every launch leaves it 0); B >= 0.
CC_EXPORT int state_fingerprint(const void* load, const void* lnw, const void* lcount,
                                const void* rcount, void* out, void* scratch, long long b,
                                cudaStream_t stream) {
  if (b < 0) return cudaErrorInvalidValue;
  FpArgs g;
  g.a0 = fp_array_of(load, 4 * b, 0x9E3779B9u);
  g.a1 = fp_array_of(lnw, b, 0x85EBCA6Bu);
  g.a2 = fp_array_of(lcount, b, 0xC2B2AE35u);
  g.a3 = fp_array_of(rcount, b, 0x27D4EB2Fu);
  g.start1 = g.a0.vec;
  g.start2 = g.start1 + g.a1.vec;
  g.start3 = g.start2 + g.a2.vec;
  g.v = g.start3 + g.a3.vec;
  long long blocks = (g.v + FP_BLOCK_VECTORS - 1) / FP_BLOCK_VECTORS;
  blocks = blocks < 1 ? 1 : blocks > FP_MAX_BLOCKS ? FP_MAX_BLOCKS : blocks;
  unsigned int* ticket = (unsigned int*)scratch;
  uint32_t* partials = (uint32_t*)scratch + 1;
  // 32-bit indices while every word index and the loop's last step fit
  if (4 * b + FP_MAX_BLOCKS * FP_BLOCK_VECTORS < 0x7FFFFFFFLL)
    k_state_fingerprint<int><<<(unsigned)blocks, FP_THREADS, 0, stream>>>(g, partials, ticket,
                                                                          (long long*)out);
  else
    k_state_fingerprint<long long><<<(unsigned)blocks, FP_THREADS, 0, stream>>>(
        g, partials, ticket, (long long*)out);
  return cudaGetLastError();
}
