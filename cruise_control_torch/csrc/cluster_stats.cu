// K8 cluster_stats: every field of ClusterModelStats from the segment
// helpers' outputs.
//
// Replaces: cruise_control_tpu/analyzer/stats.py compute_stats (:69), with
// _masked_stats (:58), jitted at analyzer/optimizer.py:105 and run for
// stats_before and stats_after of every proposal (:2065, :2103).
//
// Every float sum is taken in XLA:CPU's order (warp_xla_sum below; the
// order is kernels/window_sum.py's): the masked sums over the B brokers, the
// per-topic sums along the broker axis of the [T, B] count table and the sum
// over the T topics, so the result is bit-equal to the jitted reference.
// Over 32 or fewer topics the reference's sum is a loop that LLVM
// vectorizes: the wrapper passes the lane count it chose
// (kernels/cluster_stats.py TOPIC_LANES), and topic_lane_sum adds in that
// order. The squared deviations are rounded before they are added (XLA:CPU
// does not contract them into an FMA there; -fmad=false keeps it so).
// Integer sums, min and max do not depend on the order.
//
// Bound on this card: bytes. The [T, B] i32 table (41.6 MB at 4,000 topics
// and 2,600 brokers) is read once: ~12.4 us at 3.35 TB/s. The rest is a few
// [B] vectors. Measured on an H100 80GB HBM3 at 700 W (PERF.md §6): 0.045
// ms at that shape (0.184 ms before this design), 0.019 ms at 20 topics;
// latency-bound: ~11 dependent load rounds a topic, its warps in three
// waves at 168 registers.
//
// Design: one launch of blocks of four warps. Blocks 0-6 take the seven
// per-broker series (four utilisations, the replica and the leader counts,
// the potential NW_OUT), a block each, side by side: one pass for the alive
// count, the integer sums and min / max (warp reductions on
// order-preserving bits), then the XLA-ordered sums of the masked values and
// of their squared deviations, the four warps taking a level-2 window of
// the sum each. Each further block takes four topics, a warp each: a pass
// of exact integer sums (__reduce_add_sync) gives the
// topic's alive-broker mean, then the XLA-ordered sum of the masked squared
// deviations; the warp writes the topic's standard deviation to a
// per-device scratch and counts it if it is non-empty. The last block to
// finish (an atomic ticket after __threadfence, reset by that block) adds
// the topics' deviations, its four warps a level-2 window each, and writes
// their mean.
//
// The sums keep no table that grows with n: a warp sums 32 level-1 windows
// (one level-2 window) at a time from a 32 x 33 staging tile (coalesced
// loads, 16 of a lane's issued before any term is computed, no bank
// conflict), lane 0 adds the 32 window sums, and one thread adds the
// level-2 sums in order, past 32,768 terms streaming them into running sums
// of the higher levels, one a level. So any B and T take this one
// configuration.
#include "common.cuh"

constexpr int K8_THREADS = 128;
constexpr int K8_WARPS = K8_THREADS / 32;
constexpr int K8_SERIES = 7;
constexpr int K8_STAGE = 32 * 33;  // a warp's staging tile, floats
constexpr int K8_LEVELS = 8;       // window levels of n < 2**31 terms, and two more

// f32 outputs, in ClusterModelStats order
enum StatSlot {
  S_RES_MEAN = 0, S_RES_STD = 4, S_RES_MIN = 8, S_RES_MAX = 12,
  S_REP_MEAN = 16, S_REP_STD, S_REP_MIN, S_REP_MAX, S_LEAD_MEAN, S_LEAD_STD,
  S_TOPIC_STD, S_PNW_MEAN, S_PNW_MAX, NUM_F32_SLOTS
};

__device__ __forceinline__ unsigned int order_bits(float v) {
  unsigned int u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// XLA:CPU's order for n > 32 terms: level k adds the n[k - 1] sums of level
// k - 1 (level 0: the terms) in windows of 32 with lo[k] zeros in front;
// after L levels the final sum adds the 32 or fewer left in index order.
// Level 2's windows are the units of work (chunks): chunk c is level-1
// windows c * 32 - lo[2] .. + 31 (the whole of level 1 where L = 1). One
// thread consumes the chunks' sums in order: the final sum where L <= 2,
// else a stream through running sums of levels 3 .. L, a finished window
// carried up a level as the next one starts. Padding windows and terms are
// added as +0.0, which changes no sum that starts at +0.0.
struct Levels {
  int L, lo[K8_LEVELS];
  long long n2;  // chunks
  long long q[K8_LEVELS], cur[K8_LEVELS];
  float acc[K8_LEVELS], fin;

  __device__ __forceinline__ explicit Levels(long long n) : L(0), n2(1), fin(0.0f) {
    long long len = n;
    while (len > 32) {
      const long long m = (len + 31) / 32 * 32;
      lo[++L] = (int)((m - len) / 2);
      len = m / 32;
      if (L == 2) n2 = len;
    }
    for (int k = 0; k < K8_LEVELS; ++k) q[k] = 0, cur[k] = -1, acc[k] = 0.0f;
  }
  // the next chunk's sum
  __device__ __forceinline__ void take(float w2) {
    if (L <= 2)
      fin = L == 1 ? w2 : __fadd_rn(fin, w2);
    else
      push(3, w2);
  }
  // after the last chunk: the final sum
  __device__ __forceinline__ float finish() {
    for (int k = 3; k <= L; ++k) push(k + 1, acc[k]);  // each level's last window
    return fin;
  }
  // v, the next term of level k (level k - 1's next sum), into level k
  __device__ void push(int k, float v) {
    while (k <= L) {
      const long long w = (q[k] + lo[k]) >> 5;
      ++q[k];
      if (w == cur[k]) {
        acc[k] = __fadd_rn(acc[k], v);
        return;
      }
      const float done = acc[k];
      const bool had = cur[k] >= 0;
      acc[k] = __fadd_rn(0.0f, v);
      cur[k] = w;
      if (!had) return;
      v = done;  // level k's finished window is level k + 1's next term
      ++k;
    }
    fin = __fadd_rn(fin, v);
  }
};

// Chunk q0 (level-1 windows q0 .. q0 + 31) of the sum of term(load(i)),
// i in [0, n), by one warp: the level-2 window's sum, in lane 0. load(i)
// returns the raw values term reads, at 0 <= i < n; a lane issues the loads
// of BATCH terms before it computes any (a division's slow path is a
// branch), at addresses without a clamp where all of them lie inside [0, n).
template <int BATCH, typename Load, typename Term>
__device__ __forceinline__ float chunk_sum(Load load, Term term, long long n, int lo1,
                                          long long q0, float* stage) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 32; h += BATCH) {
    const long long i0 = (q0 + h) * 32 - lo1;  // lane 0's element of window q0 + h
    decltype(load(0LL)) raw[BATCH];
    if (i0 >= 0 && i0 + BATCH * 32 <= n) {
#pragma unroll
      for (int r = 0; r < BATCH; ++r) raw[r] = load(i0 + lane + r * 32);
#pragma unroll
      for (int r = 0; r < BATCH; ++r) stage[(h + r) * 33 + lane] = term(raw[r]);
    } else {
#pragma unroll
      for (int r = 0; r < BATCH; ++r) raw[r] = load(min(max(i0 + lane + r * 32, 0LL), n - 1));
#pragma unroll
      for (int r = 0; r < BATCH; ++r) {
        const long long i = i0 + lane + r * 32;
        stage[(h + r) * 33 + lane] = i >= 0 && i < n ? term(raw[r]) : 0.0f;
      }
    }
  }
  __syncwarp();
  float s = 0.0f;  // lane j: level-1 window q0 + j
#pragma unroll
  for (int e = 0; e < 32; ++e) s = __fadd_rn(s, stage[lane * 33 + e]);
  __syncwarp();
  stage[lane] = s;
  __syncwarp();
  float w2 = 0.0f;
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < 32; ++j) w2 = __fadd_rn(w2, stage[j]);
  __syncwarp();
  return w2;
}

// The sum of term(load(i)), i in [0, n), in XLA:CPU's order, by NW warps:
// the calling warp alone (NW = 1), or every warp of the block (NW =
// K8_WARPS; then every thread calls it), BATCH loads a lane at a time.
// Every calling thread gets the sum. stage: the calling warp's K8_STAGE
// floats of shared memory; s_w: K8_WARPS + 1 floats of the block's.
template <int NW, int BATCH, typename Load, typename Term>
__device__ float group_xla_sum(Load load, Term term, long long n, float* stage, float* s_w) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = NW == 1 ? 0 : threadIdx.x / 32;
  if (n <= 32) {  // index order from +0.0; one term is returned as it is
    const float v = lane < n ? term(load(lane)) : 0.0f;
    float acc = 0.0f;
    for (int k = 0; k < n; ++k) acc = __fadd_rn(acc, __shfl_sync(full, v, k));
    return n == 1 ? __shfl_sync(full, v, 0) : acc;
  }
  Levels lv(n);
  const int lo1 = lv.lo[1], lo2 = lv.L >= 2 ? lv.lo[2] : 0;
  for (long long c0 = 0; c0 < lv.n2; c0 += NW) {
    const long long c = c0 + warp;
    float w2 = 0.0f;
    if (c < lv.n2) w2 = chunk_sum<BATCH>(load, term, n, lo1, c * 32 - lo2, stage);
    if (NW == 1) {
      if (lane == 0) lv.take(w2);
    } else {
      if (lane == 0) s_w[warp] = w2;
      __syncthreads();
      if (threadIdx.x == 0)
        for (int w = 0; w < NW && c0 + w < lv.n2; ++w) lv.take(s_w[w]);
      __syncthreads();
    }
  }
  if (NW == 1) return __shfl_sync(full, lane == 0 ? lv.finish() : 0.0f, 0);
  if (threadIdx.x == 0) s_w[K8_WARPS] = lv.finish();
  __syncthreads();
  const float r = s_w[K8_WARPS];
  __syncthreads();
  return r;
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
  for (int i = 0; i < whole; ++i) acc[i % lanes] = __fadd_rn(acc[i % lanes], __ldcg(v + i));
  for (int h = width / 2; h >= 1; h /= 2)
    for (int j = 0; j < h; ++j) acc[j] = __fadd_rn(acc[j], acc[j + h]);
  float s = acc[0];
  for (int i = whole; i < t; ++i) s = __fadd_rn(s, __ldcg(v + i));
  return s;
}

struct StatsArgs {
  const float *load, *capacity;
  const bool* alive;
  const int *replica_count, *leader_count;
  const float* pnw;
  const int* topic_count;
  float* topic_std;         // scratch f32[T]
  unsigned int* counters;   // scratch: the ticket, the non-empty topics; 0 between launches
  float* out;
  int* out_i;
  int b, t, lanes;
};

struct Moments {
  float mean, sd, lo, hi;
  int alive_n, isum;
};

// A broker's raw values of a series: x (and y, a utilisation's capacity)
// and whether it is alive; of a topic: its count there and whether it is
// alive.
struct Raw {
  float x, y;
  bool a;
};
struct RawCount {
  float x;
  bool a;
};

// Mean, std (where `sd`), min and max of val(ld(i)) over the alive brokers
// (stats.py _masked_stats), the alive count and, where INT, the sum of
// ints[i] over every broker, by the whole block. The first pass loads 4 of
// a thread's brokers before it computes on any; the sums 8 a lane.
template <bool INT, typename Ld, typename Val>
__device__ __forceinline__ Moments masked_stats(const StatsArgs& g, Ld ld, Val val, const int* ints,
                                                bool sd, float* stage, float* s_w, int* s_i) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32, b = g.b;
  Moments m;
  int alive_n = 0, isum = 0;
  unsigned int lo = order_bits(INFINITY), hi = order_bits(-INFINITY);
  for (int i0 = threadIdx.x; i0 < b; i0 += K8_THREADS * 4) {
    Raw raw[4];
    int iv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = min(i0 + K8_THREADS * u, b - 1);
      raw[u] = ld(i);
      iv[u] = INT ? __ldg(ints + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i0 + K8_THREADS * u >= b) continue;
      const unsigned int k = order_bits(val(raw[u]));
      alive_n += raw[u].a ? 1 : 0;
      isum += iv[u];
      lo = raw[u].a ? min(lo, k) : lo;
      hi = raw[u].a ? max(hi, k) : hi;
    }
  }
  alive_n = __reduce_add_sync(full, alive_n);
  isum = __reduce_add_sync(full, isum);
  lo = __reduce_min_sync(full, lo);
  hi = __reduce_max_sync(full, hi);
  if (lane == 0) {
    s_i[warp * 4] = alive_n;
    s_i[warp * 4 + 1] = isum;
    s_i[warp * 4 + 2] = (int)lo;
    s_i[warp * 4 + 3] = (int)hi;
  }
  __syncthreads();
  m.alive_n = m.isum = 0;
  lo = order_bits(INFINITY);
  hi = order_bits(-INFINITY);
#pragma unroll
  for (int w = 0; w < K8_WARPS; ++w) {
    m.alive_n += s_i[w * 4];
    m.isum += s_i[w * 4 + 1];
    lo = min(lo, (unsigned int)s_i[w * 4 + 2]);
    hi = max(hi, (unsigned int)s_i[w * 4 + 3]);
  }
  __syncthreads();
  m.lo = from_order_bits(lo);
  m.hi = from_order_bits(hi);
  const float n = fmaxf((float)m.alive_n, 1.0f);
  const float mean = __fdiv_rn(group_xla_sum<K8_WARPS, 8>(
                                   ld,
                                   [=](const Raw& r) {
                                     const float x = val(r);
                                     return r.a ? x : 0.0f;
                                   },
                                   b, stage, s_w),
                               n);
  m.mean = mean;
  m.sd = 0.0f;
  if (sd)
    m.sd = __fsqrt_rn(__fdiv_rn(group_xla_sum<K8_WARPS, 8>(
                                    ld,
                                    [=](const Raw& r) {
                                      const float d = __fsub_rn(val(r), mean);
                                      return r.a ? __fmul_rn(d, d) : 0.0f;
                                    },
                                    b, stage, s_w),
                                n));
  return m;
}

// Series s of the broker axis (0-3 a resource's utilisation, 4 replicas,
// 5 leaders, 6 potential NW_OUT) into the outputs that take it, by the
// whole block.
__device__ __forceinline__ void series(const StatsArgs& g, int s, float* stage, float* s_w,
                                       int* s_i) {
  const bool first = threadIdx.x == 0;
  const unsigned char* alive = reinterpret_cast<const unsigned char*>(g.alive);
  if (s < 4) {
    const float *ld = g.load + s, *cap = g.capacity + s;
    const Moments m = masked_stats<false>(
        g,
        [=](long long i) {
          return Raw{__ldg(ld + i * 4), __ldg(cap + i * 4), __ldg(alive + i) != 0};
        },
        [](const Raw& r) { return __fdiv_rn(r.x, fmaxf(r.y, 1e-9f)); }, nullptr, true, stage,
        s_w, s_i);
    if (first) {
      g.out[S_RES_MEAN + s] = m.mean;
      g.out[S_RES_STD + s] = m.sd;
      g.out[S_RES_MIN + s] = m.lo;
      g.out[S_RES_MAX + s] = m.hi;
    }
  } else if (s < 6) {
    const int* c = s == 4 ? g.replica_count : g.leader_count;
    const Moments m = masked_stats<true>(
        g, [=](long long i) { return Raw{(float)__ldg(c + i), 0.0f, __ldg(alive + i) != 0}; },
        [](const Raw& r) { return r.x; }, c, true, stage, s_w, s_i);
    if (first && s == 4) {
      g.out[S_REP_MEAN] = m.mean;
      g.out[S_REP_STD] = m.sd;
      g.out[S_REP_MIN] = m.lo;
      g.out[S_REP_MAX] = m.hi;
      g.out_i[0] = m.alive_n;
      g.out_i[1] = m.isum;
    } else if (first) {
      g.out[S_LEAD_MEAN] = m.mean;
      g.out[S_LEAD_STD] = m.sd;
      g.out_i[2] = m.isum;
    }
  } else {  // potential NW_OUT's std is not an output
    const float* pnw = g.pnw;
    const Moments m = masked_stats<false>(
        g, [=](long long i) { return Raw{__ldg(pnw + i), 0.0f, __ldg(alive + i) != 0}; },
        [](const Raw& r) { return r.x; }, nullptr, false, stage, s_w, s_i);
    if (first) {
      g.out[S_PNW_MEAN] = m.mean;
      g.out[S_PNW_MAX] = m.hi;
    }
  }
}

// Topic t (stats.py :93-100): the standard deviation of its replica counts
// over the alive brokers, 0 for an empty topic, by one warp.
__device__ __forceinline__ void topic_spread(const StatsArgs& g, int t, float* stage) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, b = g.b;
  const int* row = g.topic_count + (long long)t * b;
  const unsigned char* alive = reinterpret_cast<const unsigned char*>(g.alive);
  int alive_n = 0, alive_sum = 0, all_sum = 0;
#pragma unroll 16
  for (int i = lane; i < b; i += 32) {
    const int c = __ldg(row + i);
    const bool a = __ldg(alive + i);
    all_sum += c;
    alive_sum += a ? c : 0;
    alive_n += a ? 1 : 0;
  }
  // counts are integers, so their sums are exact in any order
  alive_n = __reduce_add_sync(full, alive_n);
  alive_sum = __reduce_add_sync(full, alive_sum);
  all_sum = __reduce_add_sync(full, all_sum);
  const float n = fmaxf((float)alive_n, 1.0f);
  const float mean = __fdiv_rn((float)alive_sum, n);
  const float ss = group_xla_sum<1, 32>(
      [=](long long i) { return RawCount{(float)__ldg(row + i), __ldg(alive + i) != 0}; },
      [=](const RawCount& r) {
        const float d = __fsub_rn(r.x, mean);
        return r.a ? __fmul_rn(d, d) : 0.0f;
      },
      b, stage, nullptr);
  if (lane == 0) {
    const bool nonempty = all_sum > 0;
    g.topic_std[t] = nonempty ? __fsqrt_rn(__fdiv_rn(ss, n)) : 0.0f;
    if (nonempty) atomicAdd(g.counters + 1, 1u);
  }
}

__global__ void __launch_bounds__(K8_THREADS) k_cluster_stats(StatsArgs g) {
  __shared__ float s_stage[K8_WARPS][K8_STAGE];
  __shared__ float s_w[K8_WARPS + 1];
  __shared__ int s_i[K8_WARPS * 4];
  __shared__ bool s_last;
  const int warp = threadIdx.x / 32;
  if (blockIdx.x < K8_SERIES) {
    series(g, blockIdx.x, s_stage[warp], s_w, s_i);
  } else {
    const long long t = (long long)(blockIdx.x - K8_SERIES) * K8_WARPS + warp;
    if (t < g.t) topic_spread(g, (int)t, s_stage[warp]);
  }

  // the last block to finish takes the mean over the topics
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(g.counters, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float sum;
  if (g.lanes < 0)
    sum = group_xla_sum<K8_WARPS, 16>([&](long long i) { return __ldcg(g.topic_std + i); },
                                  [](float x) { return x; }, g.t, s_stage[warp], s_w);
  else
    sum = threadIdx.x == 0 ? topic_lane_sum(g.topic_std, g.t, g.lanes) : 0.0f;
  if (threadIdx.x == 0) {
    const unsigned int nonempty = __ldcg(g.counters + 1);
    g.out[S_TOPIC_STD] = __fdiv_rn(sum, fmaxf((float)nonempty, 1.0f));
    g.counters[0] = 0u;
    g.counters[1] = 0u;
  }
}

// broker_load f32[B, 4], capacity f32[B, 4], alive bool[B], replica_count
// i32[B], leader_count i32[B], potential_nw_out f32[B], topic_replica_count
// i32[T, B]; scratch: topic_std f32[T], counters u32[2] (0 between launches:
// every launch leaves them at 0); out f32[25], out_i i32[3]. lanes: -1 for
// XLA:CPU's windows over the topics, else the lanes of the sum over
// T <= 32 topics (0..32).
CC_EXPORT int cluster_stats(const float* load, const float* capacity, const bool* alive,
                            const int* replica_count, const int* leader_count, const float* pnw,
                            const int* topic_count, float* topic_std, unsigned int* counters,
                            float* out, int* out_i, long long b, long long t, long long lanes,
                            cudaStream_t stream) {
  if (b < 0 || b > 0x7fffffffLL || t < 0 || t > 0x7fffffffLL - K8_SERIES || lanes > 32 ||
      (lanes >= 0 && t > 32))
    return cudaErrorInvalidValue;
  StatsArgs g{load, capacity, alive, replica_count, leader_count, pnw, topic_count, topic_std,
              counters, out, out_i, (int)b, (int)t, (int)lanes};
  const long long blocks = K8_SERIES + (t + K8_WARPS - 1) / K8_WARPS;
  k_cluster_stats<<<(unsigned)blocks, K8_THREADS, 0, stream>>>(g);
  return cudaGetLastError();
}
