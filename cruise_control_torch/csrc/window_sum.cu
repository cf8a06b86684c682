// window_sum: column sums of a float32 matrix, each taken in XLA:CPU's order
// (block_xla_sum in common.cuh: windows of 32 in index order, then the
// window sums the same way).
//
// Replaces: the jnp.sum reductions behind the soft goals' balance windows and
// costs (cruise_control_tpu/analyzer/goals/soft.py ResourceDistributionGoal
// .prepare :63-64, LeaderBytesInDistributionGoal.prepare :462 and
// .bulk_counts :516, the goals' `cost`), the capacity goals' costs
// (goals/hard.py :198, :206) and the per-resource means of analyzer/drain.py
// :214 and :278. The windows decide which brokers are out of bounds, so the
// port sums in the order the reference's compiler does, on every device.
//
// Bound on this card: latency. The inputs are a few thousand floats (one per
// broker) or 199,518 (one per partition, the mean leader weight, summed once
// per goal window): a call costs the launch plus a few levels of 32
// dependent adds.
//
// Design: one block per column. Level 1 reads the column from device memory,
// one thread per window of 32; the window sums stay in shared memory for the
// later levels, so a column of n values needs ceil(n / 32) + ceil(n / 1024)
// floats of it.
#include "common.cuh"

__global__ void k_window_sum(const float* x, int n, int cols, float* out) {
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  const int n1 = (n + 31) / 32;
  float* s_a = smem;
  float* s_b = smem + n1;
  float total = block_xla_sum([&](int i) { return x[(long long)i * cols + c]; }, n, s_a, s_b);
  if (threadIdx.x == 0) out[c] = total;
}

// ptrs: x f32[n, cols] (row-major, contiguous), out f32[cols]
// ints: n, cols
CC_EXPORT int window_sum(const long long* ptrs, const long long* ints, cudaStream_t stream) {
  const float* x = (const float*)ptrs[0];
  float* out = (float*)ptrs[1];
  long long n = ints[0];
  int cols = (int)ints[1];
  if (cols <= 0) return cudaSuccess;
  if (n < 0 || n > (1LL << 30)) return cudaErrorInvalidValue;
  size_t smem = (size_t)((n + 31) / 32 + (n + 1023) / 1024 + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(k_window_sum, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  k_window_sum<<<cols, 256, smem, stream>>>(x, (int)n, cols, out);
  return cudaGetLastError();
}
