// K10 delta_scatter: write a NOOP-padded batch of model deltas into a copy of
// the static context and recompute the broker masks derived from the state.
//
// Replaces: cruise_control_tpu/analyzer/incremental.py apply_delta_batch
// (:162), the incremental lane's scatter (entry point
// `incremental-delta-apply`). For each batch row k of kind
//   KIND_STATE     broker_state[broker[k]] = state[k]
//   KIND_LOAD      part_load[row[k]]      = load[k]
//   KIND_PART_ADD  part_load[row[k]]      = load[k], topic_id[row[k]] = topic[k]
// and num_valid_partitions += the count of KIND_PART_ADD rows (one f32 add of
// a small integer, exact). Then, with build_static_ctx's expressions:
//   alive = (state != DEAD) & valid,   dead = (state == DEAD) & valid,
//   new = (state == NEW) & valid,      demoted = (state == DEMOTED) & valid,
//   replica_dst_ok = alive & base_replica_dst,
//   leadership_dst_ok = alive & ~demoted & base_leadership_dst.
// The reference's scatters are `.at[].set(mode="drop")`, jitted on XLA:CPU:
// a negative index counts from the end, an index still outside the axis is
// dropped, rows of another kind write nowhere, and of two rows naming one
// target the later one lands. The kernel does the same.
//
// Bound on this card: bytes. The outputs are fresh tensors (the inputs stay
// as they were: the optimizer's prep cache holds them), so the part_load and
// topic_id columns are read once and written once: 212,992 x (24 + 4) bytes
// each way at the smoke model's bucket, about 3.6 us at 3.35 TB/s. The batch
// is 64 rows.
//
// Design: one launch, no grid-wide step. Block t owns the tile of DS_TILE
// partition rows [t * DS_TILE, (t + 1) * DS_TILE) and the brokers of the same
// index range. It reads the batch once, a word a thread and coalesced, and
// resolves its tile's last writers in shared memory: one table a target kind
// (the state's, the load row's, the topic's), -1 where no row lands, each
// landing row k taking its target's entry by atomicMax(k), so the later row
// wins in any order; a batch of any size takes the same loop. The block then
// copies its tile flat, as DS_TILE * M consecutive floats in 16-byte vectors
// (every load of a thread issued before any store) where the columns are
// aligned, a word at a time otherwise: an element takes the winner's `load`
// word where its row has a winner (a tile without any winner copies with no
// per-element division), the input otherwise; `topic_id` likewise. Block 0
// counts the KIND_PART_ADD rows with __ballot_sync / __popc as it reads the
// batch and writes num_valid_partitions.
//
// Measured (scripts/kernel_variants.py, NVIDIA H100 80GB HBM3, 700 W), a
// 64-row batch into [212,992, 6] x 3,072: 0.0051 ms (1.43x the
// bound); tiles of 256 rows 0.0051, of 1,024 0.0058; the copy a word at a
// time 0.0056; an empty launch 0.0011.
#include "common.cuh"

constexpr int DS_THREADS = 256;
constexpr int DS_TILE = 512;  // partition rows (and brokers) a block owns
constexpr int DS_VEC = 4;     // 16-byte vectors a thread loads at once
#define STATE_NEW 1
#define STATE_DEMOTED 2
#define STATE_DEAD 3
#define K_STATE 1
#define K_LOAD 2
#define K_PART_ADD 3

struct ScatterArgs {
  const int *kind, *broker, *state, *row, *topic;
  const float* load;
  const int* state_in;
  const bool *valid, *base_rep, *base_lead;
  const float* part_load_in;
  const int* topic_in;
  const float* nvp_in;
  int* state_out;
  bool* masks;  // [6, B]: alive, dead, new, demoted, replica_dst_ok, leadership_dst_ok
  float* part_load_out;
  int* topic_out;
  float* nvp_out;
  long long d, m, b, p;
  bool vec_rows, vec_topic;  // the columns are 16-byte aligned
};

// The target of a write to `idx` on an axis of n: negative indices count from
// the end; what is still outside [0, n) is dropped (-1).
__device__ __forceinline__ long long landing(bool kind_ok, int idx, long long n) {
  long long t = idx < 0 ? (long long)idx + n : (long long)idx;
  return (kind_ok && t >= 0 && t < n) ? t : -1;
}

// Copy elements [e0, e1) of a row-major [*, m] array from `in`, each element
// whose row (counted from e0's) has a winner w >= 0 in `win` taking
// src[w * m + column] instead; `any`: some row has one. VEC: 16-byte vectors
// from e0 (aligned).
template <typename T, bool VEC>
__device__ __forceinline__ void copy_tile(const T* __restrict__ in, T* __restrict__ out,
                                          const T* __restrict__ src, const int* win, bool any,
                                          long long e0, long long e1, int m) {
  const int n = (int)(e1 - e0);
  auto take = [&](int le, T v) -> T {
    if (!any) return v;
    const int lr = le / m;
    const int w = win[lr];
    return w >= 0 ? src[(long long)w * m + (le - lr * m)] : v;
  };
  if (VEC) {
    const int nv = n / 4;
    const uint4* vin = reinterpret_cast<const uint4*>(in + e0);
    uint4* vout = reinterpret_cast<uint4*>(out + e0);
    for (int q0 = 0; q0 < nv; q0 += DS_THREADS * DS_VEC) {
      uint4 x[DS_VEC];
#pragma unroll
      for (int u = 0; u < DS_VEC; ++u) {
        const int q = min(q0 + u * DS_THREADS + (int)threadIdx.x, nv - 1);
        x[u] = vin[q];
      }
#pragma unroll
      for (int u = 0; u < DS_VEC; ++u) {
        const int q = q0 + u * DS_THREADS + (int)threadIdx.x;
        if (q < nv) {
          T* t = reinterpret_cast<T*>(&x[u]);
#pragma unroll
          for (int c = 0; c < 4; ++c) t[c] = take(4 * q + c, t[c]);
          vout[q] = x[u];
        }
      }
    }
    for (int le = nv * 4 + (int)threadIdx.x; le < n; le += DS_THREADS)
      out[e0 + le] = take(le, in[e0 + le]);
  } else {
    for (int le = threadIdx.x; le < n; le += DS_THREADS) out[e0 + le] = take(le, in[e0 + le]);
  }
}

__global__ void __launch_bounds__(DS_THREADS) k_delta_scatter(ScatterArgs a) {
  __shared__ int s_state[DS_TILE];  // the last KIND_STATE row naming each broker
  __shared__ int s_load[DS_TILE];   // the last KIND_LOAD / KIND_PART_ADD row naming each row
  __shared__ int s_topic[DS_TILE];  // the last KIND_PART_ADD row naming each row
  __shared__ int s_any[2];          // a load / topic winner in the tile
  __shared__ int s_adds;
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * DS_TILE;
  for (int i = tid; i < DS_TILE; i += DS_THREADS) s_state[i] = s_load[i] = s_topic[i] = -1;
  if (tid < 2) s_any[tid] = 0;
  if (tid == 0) s_adds = 0;
  __syncthreads();
  int adds = 0;
  for (long long k0 = 0; k0 < a.d; k0 += DS_THREADS) {
    const long long k = k0 + tid;
    const bool in = k < a.d;
    const long long kc = in ? k : a.d - 1;  // load at a clamped index, select after
    const int kd = a.kind[kc], br = a.broker[kc], rw = a.row[kc];
    const int kind = in ? kd : 0;
    const long long ts = landing(kind == K_STATE, br, a.b) - r0;
    const long long tl = landing(kind == K_LOAD || kind == K_PART_ADD, rw, a.p) - r0;
    const long long tt = landing(kind == K_PART_ADD, rw, a.p) - r0;
    if (ts >= 0 && ts < DS_TILE) atomicMax(&s_state[ts], (int)k);
    if (tl >= 0 && tl < DS_TILE) {
      atomicMax(&s_load[tl], (int)k);
      s_any[0] = 1;
    }
    if (tt >= 0 && tt < DS_TILE) {
      atomicMax(&s_topic[tt], (int)k);
      s_any[1] = 1;
    }
    if (blockIdx.x == 0) adds += __popc(__ballot_sync(0xffffffffu, kind == K_PART_ADD));
  }
  if (blockIdx.x == 0 && (tid & 31) == 0 && adds) atomicAdd(&s_adds, adds);
  __syncthreads();

  // the brokers of this index range: state and the six masks
  for (int i = tid; i < DS_TILE; i += DS_THREADS) {
    const long long bi = r0 + i;
    if (bi >= a.b) break;
    const int w = s_state[i];
    const int st = w >= 0 ? a.state[w] : a.state_in[bi];
    const bool v = a.valid[bi];
    const bool alive = (st != STATE_DEAD) && v;
    const bool demoted = (st == STATE_DEMOTED) && v;
    a.state_out[bi] = st;
    a.masks[bi] = alive;
    a.masks[a.b + bi] = (st == STATE_DEAD) && v;
    a.masks[2 * a.b + bi] = (st == STATE_NEW) && v;
    a.masks[3 * a.b + bi] = demoted;
    a.masks[4 * a.b + bi] = alive && a.base_rep[bi];
    a.masks[5 * a.b + bi] = alive && !demoted && a.base_lead[bi];
  }
  // the partition rows of the tile, flat
  if (r0 < a.p) {
    const long long r1 = min(r0 + DS_TILE, a.p);
    const int m = (int)a.m;
    if (a.vec_rows)
      copy_tile<float, true>(a.part_load_in, a.part_load_out, a.load, s_load, s_any[0], r0 * m,
                             r1 * m, m);
    else
      copy_tile<float, false>(a.part_load_in, a.part_load_out, a.load, s_load, s_any[0], r0 * m,
                              r1 * m, m);
    if (a.vec_topic)
      copy_tile<int, true>(a.topic_in, a.topic_out, a.topic, s_topic, s_any[1], r0, r1, 1);
    else
      copy_tile<int, false>(a.topic_in, a.topic_out, a.topic, s_topic, s_any[1], r0, r1, 1);
  }
  if (blockIdx.x == 0 && tid == 0) a.nvp_out[0] = a.nvp_in[0] + (float)s_adds;
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// batch kind, broker, state, row, topic i32[D], load f32[D, M];
// broker_state i32[B], broker_valid bool[B], base_replica_dst bool[B],
// base_leadership_dst bool[B], part_load f32[P, M], topic_id i32[P],
// num_valid_partitions f32[1]; out broker_state i32[B], masks bool[6, B]
// (alive, dead, new, demoted, replica_dst_ok, leadership_dst_ok),
// part_load f32[P, M], topic_id i32[P], num_valid_partitions f32[1];
// D < 2**31, M >= 1.
CC_EXPORT int delta_scatter(const void* kind, const void* broker, const void* state,
                            const void* row, const void* topic, const void* load,
                            const void* state_in, const void* valid, const void* base_rep,
                            const void* base_lead, const void* part_load_in,
                            const void* topic_in, const void* nvp_in, void* state_out,
                            void* masks, void* part_load_out, void* topic_out, void* nvp_out,
                            long long d, long long m, long long b, long long p,
                            cudaStream_t stream) {
  if (d < 0 || d >= 0x7FFFFFFFLL || m <= 0 || m >= 0x7FFFFFFFLL / DS_TILE || b < 0 || p < 0)
    return cudaErrorInvalidValue;
  ScatterArgs a;
  a.kind = (const int*)kind;
  a.broker = (const int*)broker;
  a.state = (const int*)state;
  a.row = (const int*)row;
  a.topic = (const int*)topic;
  a.load = (const float*)load;
  a.state_in = (const int*)state_in;
  a.valid = (const bool*)valid;
  a.base_rep = (const bool*)base_rep;
  a.base_lead = (const bool*)base_lead;
  a.part_load_in = (const float*)part_load_in;
  a.topic_in = (const int*)topic_in;
  a.nvp_in = (const float*)nvp_in;
  a.state_out = (int*)state_out;
  a.masks = (bool*)masks;
  a.part_load_out = (float*)part_load_out;
  a.topic_out = (int*)topic_out;
  a.nvp_out = (float*)nvp_out;
  a.d = d;
  a.m = m;
  a.b = b;
  a.p = p;
  // a tile starts DS_TILE * M floats (a multiple of 4) past the last one
  a.vec_rows = aligned16(part_load_in) && aligned16(part_load_out);
  a.vec_topic = aligned16(topic_in) && aligned16(topic_out);
  const long long n = b > p ? b : p;
  const long long blocks = n > 0 ? (n + DS_TILE - 1) / DS_TILE : 1;
  k_delta_scatter<<<(unsigned)blocks, DS_THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}
