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
// order, so any reduction tree gives the reference's value exactly.
//
// Bound on this card: launch latency. A call reads 7 * B words (73 KB at
// 2,600 brokers) and does a few integer operations on each.
//
// Design: one block of 1,024 threads; each thread accumulates its strided
// elements in a uint32 register, the block adds the partial sums in shared
// memory, and thread 0 writes the total as a 64-bit integer (no memset, no
// atomics, one launch).
#include "common.cuh"

__device__ __forceinline__ uint32_t fp_weight(long long i, uint32_t salt) {
  return ((uint32_t)(i + 1) * 2654435761u + salt) | 1u;
}

__global__ void k_state_fingerprint(const uint32_t* load, const uint32_t* lnw,
                                    const uint32_t* lcount, const uint32_t* rcount, int b,
                                    long long* out) {
  __shared__ uint32_t part[1024];
  uint32_t acc = 0u;
  for (int i = threadIdx.x; i < 4 * b; i += blockDim.x) acc += load[i] * fp_weight(i, 0x9E3779B9u);
  for (int i = threadIdx.x; i < b; i += blockDim.x) {
    acc += lnw[i] * fp_weight(i, 0x85EBCA6Bu);
    acc += lcount[i] * fp_weight(i, 0xC2B2AE35u);
    acc += rcount[i] * fp_weight(i, 0x27D4EB2Fu);
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (long long)part[0];
}

// ptrs: broker_load f32[B, 4], leader_nw_in f32[B], leader_count i32[B],
//       replica_count i32[B], out i64[1]
// ints: B
CC_EXPORT int state_fingerprint(const long long* ptrs, const long long* ints, cudaStream_t stream) {
  int b = (int)ints[0];
  k_state_fingerprint<<<1, 1024, 0, stream>>>(
      (const uint32_t*)ptrs[0], (const uint32_t*)ptrs[1], (const uint32_t*)ptrs[2],
      (const uint32_t*)ptrs[3], b, (long long*)ptrs[4]);
  return cudaGetLastError();
}
