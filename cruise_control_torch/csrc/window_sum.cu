// window_sum: column sums of a small float32 matrix, each taken in ascending
// row order with one float32 rounding per add.
//
// Replaces: the jnp.sum reductions behind the soft goals' balance windows and
// costs (cruise_control_tpu/analyzer/goals/soft.py ResourceDistributionGoal
// .prepare :63-64, LeaderBytesInDistributionGoal.prepare :462 and
// .bulk_counts :516, the goals' `cost`), and the per-resource means of
// analyzer/drain.py :214 and :278. XLA:CPU sums up to 32 terms in ascending
// order; a tree sum (torch.sum) rounds elsewhere, and the windows decide
// which brokers are out of bounds, so the port fixes one order on every
// device: the sequential one.
//
// Bound on this card: latency. The inputs are a few thousand floats (one per
// broker), or 199,518 (one per partition, the mean leader weight, summed once
// per goal window); one thread per column walks its rows, so a call costs
// the launch plus n dependent adds.
//
// Design: one block, one thread per column, a plain loop, unrolled so that
// the loads of the next rows are in flight while the adds wait on each
// other. Nothing is gained from parallel adds that would round differently.
#include "common.cuh"

__global__ void k_window_sum(const float* x, long long n, int cols, float* out) {
  int c = threadIdx.x;
  if (c >= cols) return;
  float acc = 0.0f;
#pragma unroll 16
  for (long long i = 0; i < n; ++i) acc = __fadd_rn(acc, x[i * cols + c]);
  out[c] = acc;
}

// ptrs: x f32[n, cols] (row-major, contiguous), out f32[cols]
// ints: n, cols
CC_EXPORT int window_sum(const long long* ptrs, const long long* ints, cudaStream_t stream) {
  const float* x = (const float*)ptrs[0];
  float* out = (float*)ptrs[1];
  long long n = ints[0];
  int cols = (int)ints[1];
  if (cols <= 0) return cudaSuccess;
  if (cols > 1024) return cudaErrorInvalidValue;
  k_window_sum<<<1, cols, 0, stream>>>(x, n, cols, out);
  return cudaGetLastError();
}
