// K8 cluster_stats: every field of ClusterModelStats from the segment
// helpers' outputs.
//
// Replaces: cruise_control_tpu/analyzer/stats.py compute_stats (:69), with
// _masked_stats (:58), jitted at analyzer/optimizer.py:105 and run for
// stats_before and stats_after of every proposal (:2065, :2103).
//
// Every float sum is taken in XLA:CPU's order (block_xla_sum, common.cuh):
// the masked sums over the B brokers, the per-topic sums along the broker
// axis of the [T, B] count table and the sum over the T topics, so the
// result is bit-equal to the jitted reference. Over 32 or fewer topics the
// reference's sum is a loop that LLVM vectorizes: the wrapper passes the
// lane count it chose (kernels/cluster_stats.py TOPIC_LANES), and
// topic_lane_sum adds in that order. The squared deviations are
// rounded before they are added (XLA:CPU does not contract them into an FMA
// there; -fmad=false keeps it so). Integer sums, min and max do not depend
// on the order.
//
// Bound on this card: bytes. The [T, B] i32 table (41.6 MB at 4,000 topics
// and 2,600 brokers) is read once: ~12.4 us at 3.35 TB/s. The rest is a few
// [B] vectors.
//
// Design: two launches. k_topic_spread runs one block per topic: an exact
// integer block sum gives the topic's alive-broker mean, then block_xla_sum
// takes the masked squared deviations along the broker axis; the block
// writes the topic's standard deviation (0 for an empty topic) and whether
// it is non-empty. k_broker_stats, one block, takes the seven per-broker
// series (four utilisations, replica and leader counts, potential NW_OUT)
// and the mean over the topics.
#include "common.cuh"

// f32 outputs, in ClusterModelStats order
enum StatSlot {
  S_RES_MEAN = 0, S_RES_STD = 4, S_RES_MIN = 8, S_RES_MAX = 12,
  S_REP_MEAN = 16, S_REP_STD, S_REP_MIN, S_REP_MAX, S_LEAD_MEAN, S_LEAD_STD,
  S_TOPIC_STD, S_PNW_MEAN, S_PNW_MAX, NUM_F32_SLOTS
};

__device__ int block_sum_int(int v) {
  __shared__ int s_int;
  if (threadIdx.x == 0) s_int = 0;
  __syncthreads();
  atomicAdd(&s_int, v);
  __syncthreads();
  int r = s_int;
  __syncthreads();
  return r;
}

__device__ float block_min_max(float v, bool is_max) {
  __shared__ float s_v[1024];
  s_v[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      float o = s_v[threadIdx.x + s];
      s_v[threadIdx.x] = is_max ? fmaxf(s_v[threadIdx.x], o) : fminf(s_v[threadIdx.x], o);
    }
    __syncthreads();
  }
  float r = s_v[0];
  __syncthreads();
  return r;
}

__global__ void k_topic_spread(const int* topic_count, const bool* alive, int b,
                               float* topic_std, int* topic_nonempty) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int* row = topic_count + (long long)t * b;
  int alive_n = 0, alive_sum = 0, all_sum = 0;
  for (int i = threadIdx.x; i < b; i += blockDim.x) {
    int c = row[i];
    all_sum += c;
    if (alive[i]) {
      alive_n += 1;
      alive_sum += c;
    }
  }
  alive_n = block_sum_int(alive_n);
  alive_sum = block_sum_int(alive_sum);
  all_sum = block_sum_int(all_sum);
  // stats.py :93-96: counts are integers, so their sums are exact in any order
  const float n_alive = fmaxf((float)alive_n, 1.0f);
  const float mean = __fdiv_rn((float)alive_sum, n_alive);
  float* s_a = smem;
  float* s_b = smem + (b + 31) / 32;
  float ss = block_xla_sum(
      [&](int i) {
        float d = __fsub_rn((float)row[i], mean);
        return alive[i] ? __fmul_rn(d, d) : 0.0f;
      },
      b, s_a, s_b);
  if (threadIdx.x == 0) {
    bool nonempty = all_sum > 0;
    topic_std[t] = nonempty ? __fsqrt_rn(__fdiv_rn(ss, n_alive)) : 0.0f;
    topic_nonempty[t] = nonempty ? 1 : 0;
  }
}

// mean, std, min, max of v(i) over the alive brokers (stats.py _masked_stats)
template <typename V>
__device__ void masked_stats(V v, const bool* alive, int b, float n, float* s_a, float* s_b,
                             float* mean_out, float* std_out, float* min_out, float* max_out) {
  float mean = __fdiv_rn(block_xla_sum([&](int i) { return alive[i] ? v(i) : 0.0f; }, b, s_a, s_b), n);
  float var = __fdiv_rn(block_xla_sum(
                            [&](int i) {
                              float d = __fsub_rn(v(i), mean);
                              return alive[i] ? __fmul_rn(d, d) : 0.0f;
                            },
                            b, s_a, s_b),
                        n);
  float lo = INFINITY, hi = -INFINITY;
  for (int i = threadIdx.x; i < b; i += blockDim.x) {
    if (alive[i]) {
      lo = fminf(lo, v(i));
      hi = fmaxf(hi, v(i));
    }
  }
  lo = block_min_max(lo, false);
  hi = block_min_max(hi, true);
  if (threadIdx.x == 0) {
    if (mean_out) *mean_out = mean;
    if (std_out) *std_out = __fsqrt_rn(var);
    if (min_out) *min_out = lo;
    if (max_out) *max_out = hi;
  }
}

// The sum of v[0..t) with `lanes` vector lanes (t <= 32): lane j adds the
// topics j, j + lanes, ... of the whole vectors in order, the lanes are added
// by halves, then the remaining topics one by one; 0 lanes adds in index
// order (kernels/cluster_stats.py topic_sum).
__device__ float topic_lane_sum(const float* v, int t, int lanes) {
  float acc[32];
  const int width = lanes > 0 ? lanes : 1;
  const int whole = lanes > 0 ? t - t % lanes : 0;
  for (int j = 0; j < width; ++j) acc[j] = 0.0f;
  for (int i = 0; i < whole; ++i) acc[i % lanes] = __fadd_rn(acc[i % lanes], v[i]);
  for (int h = width / 2; h >= 1; h /= 2)
    for (int j = 0; j < h; ++j) acc[j] = __fadd_rn(acc[j], acc[j + h]);
  float s = acc[0];
  for (int i = whole; i < t; ++i) s = __fadd_rn(s, v[i]);
  return s;
}

__global__ void k_broker_stats(const float* load, const float* capacity, const bool* alive,
                               const int* replica_count, const int* leader_count,
                               const float* pnw, const float* topic_std,
                               const int* topic_nonempty, int b, int t, int lanes,
                               float* out, int* out_i) {
  extern __shared__ float smem[];
  const int nmax = b > t ? b : t;
  float* s_a = smem;
  float* s_b = smem + (nmax + 31) / 32;
  int alive_n = 0, reps = 0, leads = 0, nonempty = 0;
  for (int i = threadIdx.x; i < b; i += blockDim.x) {
    alive_n += alive[i] ? 1 : 0;
    reps += replica_count[i];
    leads += leader_count[i];
  }
  for (int i = threadIdx.x; i < t; i += blockDim.x) nonempty += topic_nonempty[i];
  alive_n = block_sum_int(alive_n);
  reps = block_sum_int(reps);
  leads = block_sum_int(leads);
  nonempty = block_sum_int(nonempty);
  const float n = fmaxf((float)alive_n, 1.0f);
  for (int r = 0; r < 4; ++r) {
    masked_stats(
        [&](int i) { return __fdiv_rn(load[i * 4 + r], fmaxf(capacity[i * 4 + r], 1e-9f)); },
        alive, b, n, s_a, s_b, out + S_RES_MEAN + r, out + S_RES_STD + r, out + S_RES_MIN + r,
        out + S_RES_MAX + r);
  }
  masked_stats([&](int i) { return (float)replica_count[i]; }, alive, b, n, s_a, s_b,
               out + S_REP_MEAN, out + S_REP_STD, out + S_REP_MIN, out + S_REP_MAX);
  masked_stats([&](int i) { return (float)leader_count[i]; }, alive, b, n, s_a, s_b,
               out + S_LEAD_MEAN, out + S_LEAD_STD, nullptr, nullptr);
  masked_stats([&](int i) { return pnw[i]; }, alive, b, n, s_a, s_b, out + S_PNW_MEAN, nullptr,
               nullptr, out + S_PNW_MAX);
  float topic_sum = lanes < 0 ? block_xla_sum([&](int i) { return topic_std[i]; }, t, s_a, s_b)
                              : 0.0f;
  if (threadIdx.x == 0) {
    if (lanes >= 0) topic_sum = topic_lane_sum(topic_std, t, lanes);
    out[S_TOPIC_STD] = __fdiv_rn(topic_sum, fmaxf((float)nonempty, 1.0f));
    out_i[0] = alive_n;
    out_i[1] = reps;
    out_i[2] = leads;
  }
}

// ptrs: broker_load f32[B, 4], capacity f32[B, 4], alive bool[B],
//       replica_count i32[B], leader_count i32[B], potential_nw_out f32[B],
//       topic_replica_count i32[T, B], scratch topic_std f32[T],
//       scratch topic_nonempty i32[T], out f32[25], out_i i32[3]
// ints: B, T, lanes (-1: XLA:CPU's windows, else the lanes of the sum over
//   T <= 32 topics, 0..32)
CC_EXPORT int cluster_stats(const long long* ptrs, const long long* ints, cudaStream_t stream) {
  int b = (int)ints[0], t = (int)ints[1], lanes = (int)ints[2];
  if (b <= 0 || lanes > 32 || (lanes >= 0 && t > 32)) return cudaErrorInvalidValue;
  float* topic_std = (float*)ptrs[7];
  int* topic_nonempty = (int*)ptrs[8];
  if (t > 0) {
    size_t smem_t = (size_t)((b + 31) / 32 + (b + 1023) / 1024 + 1) * sizeof(float);
    k_topic_spread<<<t, 256, smem_t, stream>>>((const int*)ptrs[6], (const bool*)ptrs[2], b,
                                               topic_std, topic_nonempty);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  int nmax = b > t ? b : t;
  size_t smem_b = (size_t)((nmax + 31) / 32 + (nmax + 1023) / 1024 + 1) * sizeof(float);
  if (smem_b > 40 * 1024) return cudaErrorInvalidValue;
  k_broker_stats<<<1, 1024, smem_b, stream>>>(
      (const float*)ptrs[0], (const float*)ptrs[1], (const bool*)ptrs[2], (const int*)ptrs[3],
      (const int*)ptrs[4], (const float*)ptrs[5], topic_std, topic_nonempty, b, t,
      lanes, (float*)ptrs[9], (int*)ptrs[10]);
  return cudaGetLastError();
}
