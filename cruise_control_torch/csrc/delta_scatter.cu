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
// Design: one launch, no grid-wide step. The block stages the batch's
// normalized targets in shared memory (-1 where the row writes nothing), a
// tile of D_TILE rows at a time, so a batch of any size takes the same
// kernel. Thread i owns partition row i and broker i: it scans the tiles in
// order, so the last landing row wins, and then writes the row (the delta's
// or the input's) and the broker's state and six masks. Thread 0 also
// writes the partition count. Every thread of a warp reads the same shared
// word in a scan step (a broadcast).
#include "common.cuh"

#define D_TILE 2048
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
  bool *alive, *dead, *is_new, *demoted, *rep_ok, *lead_ok;
  float* part_load_out;
  int* topic_out;
  float* nvp_out;
  int d, m, b, p;
};

// The target of a write to `idx` on an axis of n: negative indices count from
// the end; what is still outside [0, n) is dropped (-1).
__device__ __forceinline__ int landing(bool kind_ok, int idx, int n) {
  if (!kind_ok) return -1;
  if (idx < 0) idx += n;
  return (idx >= 0 && idx < n) ? idx : -1;
}

__global__ void k_delta_scatter(ScatterArgs a) {
  __shared__ int s_b[D_TILE];  // broker target of a KIND_STATE row
  __shared__ int s_r[D_TILE];  // load-row target of a KIND_LOAD / KIND_PART_ADD row
  __shared__ int s_t[D_TILE];  // topic target of a KIND_PART_ADD row
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // the last landing row of each target: the state's, the load row's, the topic's
  int wb = -1, wl = -1, wt = -1;
  for (int k0 = 0; k0 < a.d; k0 += D_TILE) {
    const int nk = min(D_TILE, a.d - k0);
    for (int k = threadIdx.x; k < nk; k += blockDim.x) {
      int kd = a.kind[k0 + k];
      s_b[k] = landing(kd == K_STATE, a.broker[k0 + k], a.b);
      s_r[k] = landing(kd == K_LOAD || kd == K_PART_ADD, a.row[k0 + k], a.p);
      s_t[k] = landing(kd == K_PART_ADD, a.row[k0 + k], a.p);
    }
    __syncthreads();
    for (int k = 0; k < nk; ++k) {
      if (s_b[k] == i) wb = k0 + k;
      if (s_r[k] == i) wl = k0 + k;
      if (s_t[k] == i) wt = k0 + k;
    }
    __syncthreads();
  }
  if (i < a.b) {
    const int st = wb >= 0 ? a.state[wb] : a.state_in[i];
    const bool v = a.valid[i];
    const bool alive = (st != STATE_DEAD) && v;
    const bool demoted = (st == STATE_DEMOTED) && v;
    a.state_out[i] = st;
    a.alive[i] = alive;
    a.dead[i] = (st == STATE_DEAD) && v;
    a.is_new[i] = (st == STATE_NEW) && v;
    a.demoted[i] = demoted;
    a.rep_ok[i] = alive && a.base_rep[i];
    a.lead_ok[i] = alive && !demoted && a.base_lead[i];
  }
  if (i < a.p) {
    const float* src = wl >= 0 ? a.load + (long long)wl * a.m : a.part_load_in + i * a.m;
    float* dst = a.part_load_out + i * a.m;
    for (int j = 0; j < a.m; ++j) dst[j] = src[j];
    a.topic_out[i] = wt >= 0 ? a.topic[wt] : a.topic_in[i];
  }
  if (i == 0) {
    int adds = 0;
    for (int k = 0; k < a.d; ++k) adds += a.kind[k] == K_PART_ADD;
    a.nvp_out[0] = a.nvp_in[0] + (float)adds;
  }
}

// ptrs: batch kind, broker, state, row, topic i32[D], load f32[D, M];
//       broker_state i32[B], broker_valid bool[B], base_replica_dst bool[B],
//       base_leadership_dst bool[B], part_load f32[P, M], topic_id i32[P],
//       num_valid_partitions f32[1];
//       out broker_state i32[B], alive, dead, new, demoted, replica_dst_ok,
//       leadership_dst_ok bool[B], part_load f32[P, M], topic_id i32[P],
//       num_valid_partitions f32[1]
// ints: D, M, B, P
CC_EXPORT int delta_scatter(const long long* ptrs, const long long* ints, cudaStream_t stream) {
  ScatterArgs a;
  a.kind = (const int*)ptrs[0];
  a.broker = (const int*)ptrs[1];
  a.state = (const int*)ptrs[2];
  a.row = (const int*)ptrs[3];
  a.topic = (const int*)ptrs[4];
  a.load = (const float*)ptrs[5];
  a.state_in = (const int*)ptrs[6];
  a.valid = (const bool*)ptrs[7];
  a.base_rep = (const bool*)ptrs[8];
  a.base_lead = (const bool*)ptrs[9];
  a.part_load_in = (const float*)ptrs[10];
  a.topic_in = (const int*)ptrs[11];
  a.nvp_in = (const float*)ptrs[12];
  a.state_out = (int*)ptrs[13];
  a.alive = (bool*)ptrs[14];
  a.dead = (bool*)ptrs[15];
  a.is_new = (bool*)ptrs[16];
  a.demoted = (bool*)ptrs[17];
  a.rep_ok = (bool*)ptrs[18];
  a.lead_ok = (bool*)ptrs[19];
  a.part_load_out = (float*)ptrs[20];
  a.topic_out = (int*)ptrs[21];
  a.nvp_out = (float*)ptrs[22];
  a.d = (int)ints[0];
  a.m = (int)ints[1];
  a.b = (int)ints[2];
  a.p = (int)ints[3];
  if (a.d < 0 || a.m <= 0 || a.b < 0 || a.p < 0) return cudaErrorInvalidValue;
  const int threads = 256;
  const long long n = a.b > a.p ? a.b : a.p;
  const long long blocks = n > 0 ? (n + threads - 1) / threads : 1;
  k_delta_scatter<<<(unsigned)blocks, threads, 0, stream>>>(a);
  return cudaGetLastError();
}
