// K3 score_candidates: the masked score of every candidate action under one
// hard goal and the merged acceptance tables of the goals before it.
//
// Replaces: cruise_control_tpu/analyzer/acceptance.py score_batch (:330) with
// structural_mask (:314), tables_acceptance (:164), band_move_acceptance
// (:116), the goal's acceptance / action_score (goals/hard.py), fed by
// actions.build_selected (:189).
//
// Bound on this card: bytes, and in practice latency. Per candidate the
// kernel gathers one assignment row, one part_load row and a few dozen
// per-broker / per-host / per-topic / per-rack aggregate and table words,
// and does ~100 flops. The drain round's [512, 8, 64] move grid (262,144
// cells) touches at most 4,096 partitions and the 64 destination brokers;
// the [P, R-1] promotion grid (399,036 cells) reads every partition's row
// once. Both are a few MB of distinct bytes.
//
// Design: one thread per candidate, a switch over the six hard goals' ids.
// The (p, kind, slot, dst) index tensors are read through broadcast strides,
// so the lazy [V,K,1] x [1,1,C] grid of drain.py:960-971 and the strided
// assignment[:, 1:] view of the promotion grid are never materialised. Every
// float operation is the reference's, in its order (built with -fmad=false,
// no fast math), so the only intended difference from the plain version is
// tanhf. A candidate whose action is not valid (empty slot, src == dst, a -1
// destination) is -inf before anything is gathered with its indices: the
// reference's values there are masked by the same `valid` bit.
#include "common.cuh"

struct ScoreArgs {
  float* out;
  const int *p, *kind, *slot, *dst;
  long long sp[3], sk[3], ss[3], sd[3];
  long long d1, d2, numel;
  const int* assignment;
  const float* part_load;
  const int* topic_id;
  const float* capacity;
  const int *broker_rack, *broker_host;
  const unsigned char *dead, *replica_dst_ok, *leadership_dst_ok, *movable;
  const float* host_cpu_cap_limit;
  const float* broker_load;
  const int *replica_count, *leader_count;
  const float *potential, *leader_nw_in;
  const int *rack_count, *topic_count;
  const float* host_cpu;
  const float *hi_load, *lo_load, *band_hi, *band_lo;
  const unsigned char* band_on;
  const float *hi_rep, *lo_rep, *hi_lead, *lo_lead, *hi_pnw, *hi_lnw;
  const unsigned char* waive_dead;
  const float *hi_topic, *lo_topic, *hi_host_cpu;
  const unsigned char* rack_enabled;
  const float* limit;  // the capacity goal's usable capacity f32[B]
  const int* max_replicas;
  int R, NR, B, goal;
};

// resource of each capacity-goal id (2..5), as goals/hard.py _CAPACITY_KERNEL_ID
__device__ __forceinline__ int capacity_resource(int goal) {
  switch (goal) {
    case 2: return RES_DISK;
    case 3: return RES_NW_IN;
    case 4: return RES_NW_OUT;
    default: return RES_CPU;
  }
}

__global__ void k_score(ScoreArgs g) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= g.numel) return;
  long long i0 = e / (g.d1 * g.d2), rem = e % (g.d1 * g.d2);
  long long i1 = rem / g.d2, i2 = rem % g.d2;
  int p = g.p[i0 * g.sp[0] + i1 * g.sp[1] + i2 * g.sp[2]];
  int kind = g.kind[i0 * g.sk[0] + i1 * g.sk[1] + i2 * g.sk[2]];
  int slot = g.slot[i0 * g.ss[0] + i1 * g.ss[1] + i2 * g.ss[2]];
  int dst = g.dst[i0 * g.sd[0] + i1 * g.sd[1] + i2 * g.sd[2]];
  Action a = build_action(g.assignment, g.R, g.part_load, p, kind, slot, dst);
  if (!a.valid) {
    g.out[e] = -INFINITY;
    return;
  }
  const int src = a.src;
  const bool is_move = a.is_move;
  const long long ps = (long long)src * 4, pd = (long long)dst * 4;

  // structural_mask
  bool ok = g.movable[p] && (is_move ? g.replica_dst_ok[dst] : g.leadership_dst_ok[dst]);
  if (is_move)
    for (int s = 0; s < g.R; ++s)
      if (g.assignment[(long long)p * g.R + s] == dst) ok = false;
  const bool dead_src = g.dead[src];

  // tables_acceptance: hard load box
  for (int r = 0; r < 4; ++r) {
    float d = a.dload[r];
    if (d > 0.0f) {
      if (!(g.broker_load[pd + r] + d <= g.hi_load[pd + r])) ok = false;
      if (!dead_src && !(g.broker_load[ps + r] - d >= g.lo_load[ps + r])) ok = false;
    }
  }
  // two-case distribution band
  for (int r = 0; r < 4; ++r) {
    float d = a.dload[r];
    float s = g.broker_load[ps + r], dd = g.broker_load[pd + r];
    float lo_s = g.band_lo[ps + r], hi_s = g.band_hi[ps + r];
    float lo_d = g.band_lo[pd + r], hi_d = g.band_hi[pd + r];
    bool pos = d >= 0.0f;
    bool case1 = pos ? (s >= lo_s && dd <= hi_d) : (dd >= lo_d && s <= hi_s);
    bool acc1 = pos ? (dd + d <= hi_d && (s - d >= lo_s || dead_src))
                    : (s - d <= hi_s && dd + d >= lo_d);
    float prev = s - dd;
    bool acc2 = fabsf(prev - 2.0f * d) < fabsf(prev);
    bool ok_r = case1 ? acc1 : (acc2 || dead_src);
    ok_r = ok_r || d == 0.0f || !g.band_on[r];
    if (!ok_r) ok = false;
  }
  // replica and leader counts
  const float drep = (float)a.drep, dlead = (float)a.dleader;
  if (drep > 0.0f) {
    if (!((float)g.replica_count[dst] + drep <= g.hi_rep[dst])) ok = false;
    if (!dead_src && !((float)g.replica_count[src] - drep >= g.lo_rep[src])) ok = false;
  }
  if (dlead > 0.0f) {
    if (!((float)g.leader_count[dst] + dlead <= g.hi_lead[dst])) ok = false;
    if (!dead_src && !((float)g.leader_count[src] - dlead >= g.lo_lead[src])) ok = false;
  }
  // potential NW_OUT, leader bytes-in
  if (a.dpnw > 0.0f && !(g.potential[dst] + a.dpnw <= g.hi_pnw[dst])) ok = false;
  if (a.dleader_nw_in > 0.0f) {
    bool lnw_ok = g.leader_nw_in[dst] + a.dleader_nw_in <= g.hi_lnw[dst];
    if (!(lnw_ok || (g.waive_dead[0] && dead_src))) ok = false;
  }
  // per-topic replica count
  const long long t = g.topic_id[p];
  if (drep > 0.0f) {
    if (!((float)(g.topic_count[t * g.B + dst] + a.drep) <= g.hi_topic[t])) ok = false;
    if (!dead_src && !((float)(g.topic_count[t * g.B + src] - a.drep) >= g.lo_topic[t])) ok = false;
  }
  // host-level CPU
  const int hs = g.broker_host[src], hd = g.broker_host[dst];
  const float dcpu = a.dload[RES_CPU];
  const float host_after = g.host_cpu[hd] + (hs == hd ? 0.0f : dcpu);
  if (!(dcpu <= 0.0f || host_after <= g.hi_host_cpu[hd])) ok = false;
  // rack safety
  const int rs = g.broker_rack[src], rd = g.broker_rack[dst];
  const int count_dst = g.rack_count[(long long)p * g.NR + rd] - (rs == rd ? 1 : 0);
  if (g.rack_enabled[0] && drep > 0.0f && count_dst != 0) ok = false;

  // the goal's own acceptance and score
  float score = 0.0f;
  switch (g.goal) {
    case 0: {  // RackAwareGoal
      if (is_move && count_dst != 0) ok = false;
      bool dup = g.rack_count[(long long)p * g.NR + rs] > 1;
      float m = -INFINITY;
      for (int r = 0; r < 4; ++r) m = fmaxf(m, g.broker_load[pd + r] / fmaxf(g.capacity[pd + r], 1e-9f));
      float tiebreak = 1e-3f * (1.0f - tanhf(m));
      score = (is_move && dup) ? 1.0f + tiebreak : 0.0f;
      break;
    }
    case 1: {  // ReplicaCapacityGoal
      int cap = g.max_replicas[0];
      if (is_move && !(g.replica_count[dst] + 1 <= cap)) ok = false;
      bool over = g.replica_count[src] > cap;
      float headroom = (float)(cap - g.replica_count[dst]);
      score = (is_move && over) ? 1.0f + 1e-3f * tanhf(headroom * 1e-3f) : 0.0f;
      break;
    }
    default: {  // CapacityGoal(resource)
      int res = capacity_resource(g.goal);
      float dres = a.dload[res];
      float after = g.broker_load[pd + res] + dres;
      bool acc = after <= g.limit[dst] || dres <= 0.0f;
      bool src_over = g.broker_load[ps + res] > g.limit[src];
      if (res == RES_CPU) {
        float h_after = g.host_cpu[hd] + (hs == hd ? 0.0f : dres);
        acc = acc && (h_after <= g.host_cpu_cap_limit[hd] || dres <= 0.0f);
        src_over = src_over || g.host_cpu[hs] > g.host_cpu_cap_limit[hs];
      }
      if (!acc) ok = false;
      score = (src_over && dres > 1e-6f) ? dres : 0.0f;
      break;
    }
  }
  const bool evac = dead_src && (is_move || a.dleader > 0);
  score = score + (evac ? 1.0e6f : 0.0f);
  g.out[e] = (ok && score > 1e-6f) ? score : -INFINITY;
}

// ptrs (in this order): out, p, kind, slot, dst, assignment, part_load, topic_id,
//   broker_capacity, broker_rack, broker_host, dead, replica_dst_ok,
//   leadership_dst_ok, movable_partition, host_cpu_capacity_limit,
//   broker_load, replica_count, leader_count, potential_nw_out, leader_nw_in,
//   rack_replica_count, topic_replica_count, host_cpu_load,
//   hi_load, lo_load, band_hi, band_lo, band_on, hi_rep, lo_rep, hi_lead,
//   lo_lead, hi_pnw, hi_lnw, hi_lnw_waive_dead, hi_topic, lo_topic,
//   hi_host_cpu, rack_enabled, limit, max_replicas_per_broker
// ints: d0, d1, d2, strides of p (3), kind (3), slot (3), dst (3), R, NR, B, goal
CC_EXPORT int score_candidates(const long long* ptrs, const long long* ints, cudaStream_t stream) {
  ScoreArgs g;
  int k = 0;
  g.out = (float*)ptrs[k++];
  g.p = (const int*)ptrs[k++];
  g.kind = (const int*)ptrs[k++];
  g.slot = (const int*)ptrs[k++];
  g.dst = (const int*)ptrs[k++];
  g.assignment = (const int*)ptrs[k++];
  g.part_load = (const float*)ptrs[k++];
  g.topic_id = (const int*)ptrs[k++];
  g.capacity = (const float*)ptrs[k++];
  g.broker_rack = (const int*)ptrs[k++];
  g.broker_host = (const int*)ptrs[k++];
  g.dead = (const unsigned char*)ptrs[k++];
  g.replica_dst_ok = (const unsigned char*)ptrs[k++];
  g.leadership_dst_ok = (const unsigned char*)ptrs[k++];
  g.movable = (const unsigned char*)ptrs[k++];
  g.host_cpu_cap_limit = (const float*)ptrs[k++];
  g.broker_load = (const float*)ptrs[k++];
  g.replica_count = (const int*)ptrs[k++];
  g.leader_count = (const int*)ptrs[k++];
  g.potential = (const float*)ptrs[k++];
  g.leader_nw_in = (const float*)ptrs[k++];
  g.rack_count = (const int*)ptrs[k++];
  g.topic_count = (const int*)ptrs[k++];
  g.host_cpu = (const float*)ptrs[k++];
  g.hi_load = (const float*)ptrs[k++];
  g.lo_load = (const float*)ptrs[k++];
  g.band_hi = (const float*)ptrs[k++];
  g.band_lo = (const float*)ptrs[k++];
  g.band_on = (const unsigned char*)ptrs[k++];
  g.hi_rep = (const float*)ptrs[k++];
  g.lo_rep = (const float*)ptrs[k++];
  g.hi_lead = (const float*)ptrs[k++];
  g.lo_lead = (const float*)ptrs[k++];
  g.hi_pnw = (const float*)ptrs[k++];
  g.hi_lnw = (const float*)ptrs[k++];
  g.waive_dead = (const unsigned char*)ptrs[k++];
  g.hi_topic = (const float*)ptrs[k++];
  g.lo_topic = (const float*)ptrs[k++];
  g.hi_host_cpu = (const float*)ptrs[k++];
  g.rack_enabled = (const unsigned char*)ptrs[k++];
  g.limit = (const float*)ptrs[k++];
  g.max_replicas = (const int*)ptrs[k++];
  long long d0 = ints[0];
  g.d1 = ints[1];
  g.d2 = ints[2];
  for (int j = 0; j < 3; ++j) {
    g.sp[j] = ints[3 + j];
    g.sk[j] = ints[6 + j];
    g.ss[j] = ints[9 + j];
    g.sd[j] = ints[12 + j];
  }
  g.R = (int)ints[15];
  g.NR = (int)ints[16];
  g.B = (int)ints[17];
  g.goal = (int)ints[18];
  g.numel = d0 * g.d1 * g.d2;
  if (g.numel == 0) return cudaSuccess;
  k_score<<<(unsigned)((g.numel + 255) / 256), 256, 0, stream>>>(g);
  return cudaGetLastError();
}
