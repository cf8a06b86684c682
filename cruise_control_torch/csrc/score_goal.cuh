// The score of one candidate action under one goal of the default stack and
// the merged acceptance tables of the goals before it: the per-candidate body
// of K3 score_candidates, shared with K9 grid_shortlist so that both score
// every cell bit for bit alike.
//
// Replaces: cruise_control_tpu/analyzer/acceptance.py score_batch (:330) with
// structural_mask (:314), tables_acceptance (:164), band_move_acceptance
// (:116), the goal's acceptance / action_score (goals/hard.py, goals/soft.py,
// goals/kafka_assigner.py), for one action built as actions.build_selected
// (:189) builds it.
//
// A switch over the goals' ids (goal.kernel_id: 0-5 the hard goals, 6-14
// the soft goals, whose window scalars, or per-topic arrays, come in as
// `w_lower`, `w_upper`, `w_active`, and 15 KafkaAssignerEvenRackAwareGoal,
// goals/kafka_assigner.py; KafkaAssignerDiskUsageDistributionGoal is case
// 11). The structural block reads `only_immigrants`, the run's
// only_move_immigrants flag, on the device. Every float operation is the
// reference's, in its order (built with -fmad=false, no fast math). Where XLA
// fuses a multiply into an add the code calls fmaf, and every tanh is
// xla_tanhf (common/xla_math.py). An action that is not valid (empty slot,
// src == dst, a -1 destination) scores -inf before anything is gathered with
// its indices: the reference's values there are masked by the same `valid`
// bit.
#pragma once

#include "common.cuh"

// The context every score reads: the model, the aggregates, the tables, the
// goal's limit and window. Pointers are device addresses.
struct ScoreCtx {
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
  const float *w_lower, *w_upper;  // the soft goal's window: f32[] or f32[T]
  const unsigned char* w_active;
  const unsigned char* only_immigrants;  // bool[]: only replicas on dead brokers move
  int R, NR, B, goal;
};


// Fill `c` from the C interface's pointer array, starting at ptrs[k], in the
// order: assignment, part_load, topic_id, broker_capacity, broker_rack,
//   broker_host, dead, replica_dst_ok, leadership_dst_ok, movable_partition,
//   host_cpu_capacity_limit, broker_load, replica_count, leader_count,
//   potential_nw_out, leader_nw_in, rack_replica_count, topic_replica_count,
//   host_cpu_load, hi_load, lo_load, band_hi, band_lo, band_on, hi_rep,
//   lo_rep, hi_lead, lo_lead, hi_pnw, hi_lnw, hi_lnw_waive_dead, hi_topic,
//   lo_topic, hi_host_cpu, rack_enabled, limit, max_replicas_per_broker,
//   w_lower, w_upper, w_active, only_move_immigrants
// and from `ints`: R, NR, B, goal. Returns the index past the last pointer.
static inline int read_score_ctx(ScoreCtx& g, const long long* ptrs, int k, const long long* ints) {
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
  g.w_lower = (const float*)ptrs[k++];
  g.w_upper = (const float*)ptrs[k++];
  g.w_active = (const unsigned char*)ptrs[k++];
  g.only_immigrants = (const unsigned char*)ptrs[k++];
  g.R = (int)ints[0];
  g.NR = (int)ints[1];
  g.B = (int)ints[2];
  g.goal = (int)ints[3];
  return k;
}

// distribution_score (goals/base.py): the imbalance removed on the two
// brokers plus 1e-3 * tanh(tiebreak), fused as XLA fuses it
__device__ __forceinline__ float distribution_score(float b_src, float b_dst, float a_src,
                                                    float a_dst, float lo, float hi, float tb) {
  const float i_s0 = imbalance(b_src, lo, hi), i_d0 = imbalance(b_dst, lo, hi);
  const float i_s1 = imbalance(a_src, lo, hi), i_d1 = imbalance(a_dst, lo, hi);
  const float red = i_s0 + i_d0 - i_s1 - i_d1;
  const bool endpoint_ok = i_s1 <= i_s0 + 1e-6f && i_d1 <= i_d0 + 1e-6f;
  return (red > 1e-6f && endpoint_ok) ? fmaf(1e-3f, xla_tanhf(tb), red) : 0.0f;
}

// resource of each capacity-goal id (2..5), as goals/hard.py _CAPACITY_KERNEL_ID
__device__ __forceinline__ int capacity_resource(int goal) {
  switch (goal) {
    case 2: return RES_DISK;
    case 3: return RES_NW_IN;
    case 4: return RES_NW_OUT;
    default: return RES_CPU;
  }
}

// The masked score of the action (p, kind, slot, dst): its score where the
// structure, the tables and the goal accept it and it improves by more than
// SCORE_EPS, else -inf.
__device__ __forceinline__ float score_action(const ScoreCtx& g, int p, int kind, int slot,
                                              int dst) {
  Action a = build_action(g.assignment, g.R, g.part_load, p, kind, slot, dst);
  if (!a.valid) return -INFINITY;
  const int src = a.src;
  const bool is_move = a.is_move;
  const long long ps = (long long)src * 4, pd = (long long)dst * 4;

  // structural_mask
  bool ok = g.movable[p] && (is_move ? g.replica_dst_ok[dst] : g.leadership_dst_ok[dst]);
  if (is_move)
    for (int s = 0; s < g.R; ++s)
      if (g.assignment[(long long)p * g.R + s] == dst) ok = false;
  const bool dead_src = g.dead[src];
  // only_move_immigrants: the source must be dead (acceptance.py:323)
  if (g.only_immigrants[0] && !dead_src) ok = false;

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
    case 0:     // RackAwareGoal
    case 15: {  // KafkaAssignerEvenRackAwareGoal: the rack-aware case, plus
                // the even window [floor(avg), ceil(avg)] on replica counts
      if (is_move && count_dst != 0) ok = false;
      bool dup = g.rack_count[(long long)p * g.NR + rs] > 1;
      float m = -INFINITY;
      for (int r = 0; r < 4; ++r) m = fmaxf(m, g.broker_load[pd + r] / fmaxf(g.capacity[pd + r], 1e-9f));
      float tiebreak = 1e-3f * (1.0f - xla_tanhf(m));
      score = (is_move && dup) ? 1.0f + tiebreak : 0.0f;
      if (g.goal == 15) {
        const float lo = g.w_lower[0], hi = g.w_upper[0];
        if (is_move && !((float)(g.replica_count[dst] + 1) <= hi)) ok = false;
        const float cs = (float)g.replica_count[src], cd = (float)g.replica_count[dst];
        score = score + (is_move ? distribution_score(cs, cd, cs - 1.0f, cd + 1.0f, lo, hi,
                                                      (cs - cd) * 1e-2f)
                                 : 0.0f);
      }
      break;
    }
    case 1: {  // ReplicaCapacityGoal
      int cap = g.max_replicas[0];
      if (is_move && !(g.replica_count[dst] + 1 <= cap)) ok = false;
      bool over = g.replica_count[src] > cap;
      float headroom = (float)(cap - g.replica_count[dst]);
      score = (is_move && over) ? fmaf(1e-3f, xla_tanhf(headroom * 1e-3f), 1.0f) : 0.0f;
      break;
    }
    case 2: case 3: case 4: case 5: {  // CapacityGoal(resource)
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
    case 6: {  // ReplicaDistributionGoal
      const float lo = g.w_lower[0], hi = g.w_upper[0];
      if (is_move && !(((float)(g.replica_count[src] - 1) >= lo || dead_src) &&
                       (float)(g.replica_count[dst] + 1) <= hi))
        ok = false;
      const float cs = (float)g.replica_count[src], cd = (float)g.replica_count[dst];
      score = is_move ? distribution_score(cs, cd, cs - 1.0f, cd + 1.0f, lo, hi, (cs - cd) * 1e-2f)
                      : 0.0f;
      break;
    }
    case 7: {  // PotentialNwOutGoal: `limit` is capacity_limit[:, NW_OUT]
      if (!(a.dpnw <= 0.0f || g.potential[dst] + a.dpnw <= g.limit[dst])) ok = false;
      score = (g.potential[src] > g.limit[src] && a.dpnw > 1e-6f) ? a.dpnw : 0.0f;
      break;
    }
    case 8: case 9: case 10: case 11: {  // ResourceDistributionGoal(resource)
      const int res = g.goal - 8;
      const float lo = g.w_lower[0], hi = g.w_upper[0];
      const bool active = g.w_active[0];
      const float dres = a.dload[res];
      const float cap_s = fmaxf(g.capacity[ps + res], 1e-9f), cap_d = fmaxf(g.capacity[pd + res], 1e-9f);
      const float u_s = g.broker_load[ps + res] / cap_s, u_d = g.broker_load[pd + res] / cap_d;
      const float u_s1 = u_s - dres / cap_s, u_d1 = u_d + dres / cap_d;
      const bool case1 = u_s >= lo && u_d <= hi;
      const bool acc1 = u_d1 <= hi && (u_s1 >= lo || dead_src);
      const bool acc2 = fabsf(u_s1 - u_d1) < fabsf(u_s - u_d);
      const bool acc = case1 ? acc1 : (acc2 || dead_src);
      if (active && fabsf(dres) > 0.0f && !acc) ok = false;
      score = active ? distribution_score(u_s, u_d, u_s1, u_d1, lo, hi, u_s - u_d) : 0.0f;
      break;
    }
    case 12: {  // TopicReplicaDistributionGoal: per-topic windows
      const float lo = g.w_lower[t], hi = g.w_upper[t];
      const int c_s = g.topic_count[t * g.B + src], c_d = g.topic_count[t * g.B + dst];
      if (is_move && !(((float)(c_s - 1) >= lo || dead_src) && (float)(c_d + 1) <= hi)) ok = false;
      const float cs = (float)c_s, cd = (float)c_d;
      score = is_move ? distribution_score(cs, cd, cs - 1.0f, cd + 1.0f, lo, hi, (cs - cd) * 1e-2f)
                      : 0.0f;
      break;
    }
    case 13: {  // LeaderReplicaDistributionGoal
      const float lo = g.w_lower[0], hi = g.w_upper[0];
      const bool transfers = a.dleader > 0;
      if (transfers && !(((float)(g.leader_count[src] - 1) >= lo || dead_src) &&
                         (float)(g.leader_count[dst] + 1) <= hi))
        ok = false;
      const float cs = (float)g.leader_count[src], cd = (float)g.leader_count[dst];
      score = transfers
                  ? distribution_score(cs, cd, cs - 1.0f, cd + 1.0f, lo, hi, (cs - cd) * 1e-2f)
                  : 0.0f;
      break;
    }
    default: {  // 14: LeaderBytesInDistributionGoal
      const float lo = g.w_lower[0], hi = g.w_upper[0];
      const float d = a.dleader_nw_in;
      if (d > 0.0f && !(g.leader_nw_in[dst] + d <= hi || dead_src)) ok = false;
      const float bs = g.leader_nw_in[src], bd = g.leader_nw_in[dst];
      score = d > 0.0f ? distribution_score(bs, bd, bs - d, bd + d, lo, hi, (bs - bd) * 1e-6f)
                       : 0.0f;
      break;
    }
  }
  const bool evac = dead_src && (is_move || a.dleader > 0);
  score = score + (evac ? 1.0e6f : 0.0f);
  return (ok && score > 1e-6f) ? score : -INFINITY;
}
