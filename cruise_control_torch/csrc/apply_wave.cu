// K4 apply_wave: select a conflict-free subset of one wave of scored actions
// and apply it to the assignment, every aggregate and the touch tags.
//
// Replaces: cruise_control_tpu/analyzer/context.py wave_select (:425) followed
// by apply_actions_batch (:525), with the actions materialized as
// actions.build_selected (:189) does.
//
// Bound on this card: latency. A wave holds at most 1,024 entries (512 drain
// nominations + 512 promotions); the bytes are a few tens of KB and the
// pairwise selection about 4 x N^2 = 4M shared-memory compares, far under a
// microsecond of the card's bandwidth or compute. What costs is the launch
// and the four block-wide barriers.
//
// Design: one block, one thread per entry; N > 1,024 is refused by the
// wrapper. The four stages of wave_select run in order with __syncthreads()
// between them, each as O(N^2) pairwise compares over shared memory instead
// of per-broker / per-host / per-partition tables (so no table is sized by B,
// H or P):
//   1. an entry is a candidate iff its score is >= that of every valid entry
//      sharing a broker endpoint with it (the per-broker scatter-max);
//   2. it survives iff no lower-index candidate shares a broker (the
//      scatter-min of the index);
//   3. unique_per_group over the destination host: best score, ties to the
//      lowest index;
//   4. the same over the partition.
// The selected entries are then broker-, host- and partition-disjoint, so
// each thread applies its own entry with plain loads and stores, no atomics.
// The one exception is host_cpu_load, whose SOURCE hosts may repeat: one
// thread applies those updates sequentially in the reference's order (all
// source subtractions in entry order, then all destination additions).
// Entries whose flag is set but whose action is not valid (an empty slot or
// src == dst) are treated as unflagged; score_batch never gives such an entry
// a finite score, so the reference never flags one.
#include "common.cuh"

#define MAX_N 1024

struct WaveArgs {
  const int *p, *kind, *slot, *dst;
  const float* score;
  const unsigned char* ok;
  unsigned char* sel_out;
  int* assignment;
  const float* part_load;
  const int *topic_id, *broker_rack, *broker_host;
  float* broker_load;
  int *replica_count, *leader_count;
  float *potential, *leader_nw_in;
  int *rack_count, *topic_count;
  float* host_cpu;
  int* touch_tag;
  int n, R, NR, B, tag;
};

__global__ void __launch_bounds__(MAX_N) k_apply_wave(WaveArgs w) {
  __shared__ int s_src[MAX_N], s_dst[MAX_N], s_host[MAX_N], s_part[MAX_N], s_dhost_src[MAX_N];
  __shared__ float s_score[MAX_N], s_dcpu[MAX_N];
  __shared__ unsigned char s_fa[MAX_N], s_fb[MAX_N];
  const int i = threadIdx.x;
  const int n = w.n;
  Action act;
  bool v = false;
  float s = -INFINITY;
  if (i < n) {
    act = build_action(w.assignment, w.R, w.part_load, w.p[i], w.kind[i], w.slot[i], w.dst[i]);
    v = w.ok[i] && act.valid;
    s = v ? w.score[i] : -INFINITY;
    s_src[i] = v ? act.src : -1;
    s_dst[i] = v ? act.dst : -1;
    s_host[i] = v ? w.broker_host[act.dst] : -1;
    s_dhost_src[i] = v ? w.broker_host[act.src] : -1;
    s_part[i] = v ? act.p : -1;
    s_score[i] = s;
    s_dcpu[i] = v ? act.dload[RES_CPU] : 0.0f;
  }
  __syncthreads();

  // 1. max score on each of the entry's broker endpoints
  bool cand = v;
  if (v) {
    for (int j = 0; j < n; ++j) {
      int a = s_src[j], b = s_dst[j];
      if (a < 0) continue;
      bool share = a == act.src || b == act.src || a == act.dst || b == act.dst;
      if (share && !(s >= s_score[j])) { cand = false; break; }
    }
  }
  if (i < n) s_fa[i] = cand;
  __syncthreads();
  // 2. lowest index among the maxima
  bool sel = cand;
  if (cand) {
    for (int j = 0; j < i; ++j) {
      if (!s_fa[j]) continue;
      int a = s_src[j], b = s_dst[j];
      if (a == act.src || b == act.src || a == act.dst || b == act.dst) { sel = false; break; }
    }
  }
  if (i < n) s_fb[i] = sel;
  __syncthreads();
  // 3. unique_per_group over the destination host
  bool c_and = sel;
  if (sel) {
    for (int j = 0; j < n; ++j)
      if (s_fb[j] && s_host[j] == s_host[i] && !(s >= s_score[j])) { c_and = false; break; }
  }
  if (i < n) s_fa[i] = c_and;
  __syncthreads();
  sel = c_and;
  if (c_and) {
    for (int j = 0; j < i; ++j)
      if (s_fa[j] && s_host[j] == s_host[i]) { sel = false; break; }
  }
  if (i < n) s_fb[i] = sel;
  __syncthreads();
  // 4. unique_per_group over the partition
  c_and = sel;
  if (sel) {
    for (int j = 0; j < n; ++j)
      if (s_fb[j] && s_part[j] == s_part[i] && !(s >= s_score[j])) { c_and = false; break; }
  }
  if (i < n) s_fa[i] = c_and;
  __syncthreads();
  sel = c_and;
  if (c_and) {
    for (int j = 0; j < i; ++j)
      if (s_fa[j] && s_part[j] == s_part[i]) { sel = false; break; }
  }
  if (i < n) {
    s_fb[i] = sel;
    w.sel_out[i] = sel;
  }
  __syncthreads();

  if (sel) {
    const long long row = (long long)act.p * w.R;
    if (act.is_move) {
      w.assignment[row + act.slot] = act.dst;
    } else {
      int old_holder = w.assignment[row + act.slot];
      w.assignment[row + act.slot] = act.src;  // the old leader
      w.assignment[row] = old_holder;
      w.touch_tag[row] = w.tag;
    }
    w.touch_tag[row + act.slot] = w.tag;
    for (int r = 0; r < 4; ++r) {
      w.broker_load[(long long)act.src * 4 + r] = w.broker_load[(long long)act.src * 4 + r] - act.dload[r];
      w.broker_load[(long long)act.dst * 4 + r] = w.broker_load[(long long)act.dst * 4 + r] + act.dload[r];
    }
    w.replica_count[act.src] -= act.drep;
    w.replica_count[act.dst] += act.drep;
    w.leader_count[act.src] -= act.dleader;
    w.leader_count[act.dst] += act.dleader;
    w.potential[act.src] = w.potential[act.src] - act.dpnw;
    w.potential[act.dst] = w.potential[act.dst] + act.dpnw;
    w.leader_nw_in[act.src] = w.leader_nw_in[act.src] - act.dleader_nw_in;
    w.leader_nw_in[act.dst] = w.leader_nw_in[act.dst] + act.dleader_nw_in;
    if (act.is_move) {
      long long prow = (long long)act.p * w.NR;
      w.rack_count[prow + w.broker_rack[act.src]] -= 1;
      w.rack_count[prow + w.broker_rack[act.dst]] += 1;
      long long trow = (long long)w.topic_id[act.p] * w.B;
      w.topic_count[trow + act.src] -= 1;
      w.topic_count[trow + act.dst] += 1;
    }
  }
  if (i == 0) {
    for (int j = 0; j < n; ++j)
      if (s_fb[j]) w.host_cpu[s_dhost_src[j]] = w.host_cpu[s_dhost_src[j]] - s_dcpu[j];
    for (int j = 0; j < n; ++j)
      if (s_fb[j]) w.host_cpu[s_host[j]] = w.host_cpu[s_host[j]] + s_dcpu[j];
  }
}

// ptrs: p, kind, slot, dst (i32[N]), score f32[N], ok u8[N], sel_out u8[N],
//       assignment, part_load, topic_id, broker_rack, broker_host, broker_load,
//       replica_count, leader_count, potential, leader_nw_in, rack_count,
//       topic_count, host_cpu, touch_tag
// ints: N, R, NR, B, tag
CC_EXPORT int apply_wave(const long long* ptrs, const long long* ints, cudaStream_t stream) {
  WaveArgs w;
  w.p = (const int*)ptrs[0];
  w.kind = (const int*)ptrs[1];
  w.slot = (const int*)ptrs[2];
  w.dst = (const int*)ptrs[3];
  w.score = (const float*)ptrs[4];
  w.ok = (const unsigned char*)ptrs[5];
  w.sel_out = (unsigned char*)ptrs[6];
  w.assignment = (int*)ptrs[7];
  w.part_load = (const float*)ptrs[8];
  w.topic_id = (const int*)ptrs[9];
  w.broker_rack = (const int*)ptrs[10];
  w.broker_host = (const int*)ptrs[11];
  w.broker_load = (float*)ptrs[12];
  w.replica_count = (int*)ptrs[13];
  w.leader_count = (int*)ptrs[14];
  w.potential = (float*)ptrs[15];
  w.leader_nw_in = (float*)ptrs[16];
  w.rack_count = (int*)ptrs[17];
  w.topic_count = (int*)ptrs[18];
  w.host_cpu = (float*)ptrs[19];
  w.touch_tag = (int*)ptrs[20];
  w.n = (int)ints[0];
  w.R = (int)ints[1];
  w.NR = (int)ints[2];
  w.B = (int)ints[3];
  w.tag = (int)ints[4];
  if (w.n <= 0) return cudaSuccess;
  if (w.n > MAX_N) return cudaErrorInvalidValue;
  int threads = ((w.n + 31) / 32) * 32;
  k_apply_wave<<<1, threads, 0, stream>>>(w);
  return cudaGetLastError();
}
