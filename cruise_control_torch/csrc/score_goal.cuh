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
// src == dst, a -1 destination) scores -inf: the reference's values there are
// masked by the same `valid` bit.
//
// The score is taken in three parts, so that a caller can load what a row
// or a column of a grid shares once:
//   - SrcHalf, once per (p, kind, slot): the action's deltas, the
//     partition's flags and topic, and the source broker's words, with every
//     check that reads the source side alone already folded into `ok`;
//   - DstHalf, once per destination broker: its words and flags;
//   - combine(), per cell: both halves and the two words that depend on the
//     pair, topic_count[t * B + dst] and rack_count[p * NR + rack(dst)].
// The halves load every word at a clamped address, with no load behind a
// branch, so the loads of one level go out together; a word that the action's
// kind or the goal never reads is loaded at index 0 (one transaction a warp).
#pragma once

#include "common.cuh"

// The context every score reads: the model, the aggregates, the tables, the
// goal's limit and window. Pointers are device addresses. The host packs it
// once a round (kernels/score_candidates.py ScoreContext, a ctypes Structure
// with these fields in this order) and passes its address.
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
  const float* capacity_limit;           // f32[B, 4]: K5's capacity and potential bounds
  int R, NR, B, goal;                    // goal: -1 in a context of K5's, which reads none
};

template <typename T>
__device__ __forceinline__ T ld(const T* p) {
  return __ldg(p);
}
__device__ __forceinline__ bool ldb(const unsigned char* p) { return __ldg(p) != 0; }

// Row b of a [*, 4] float table as one 16-byte load (the context's [*, 4]
// tables are 16-byte aligned: kernels/score_candidates.py checks it).
__device__ __forceinline__ void ld4(const float* t, long long b, float (&out)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(t) + b);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// a[i] for a runtime i in 0..3, by selects, so that `a` stays in registers
__device__ __forceinline__ float at4(const float (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// SrcHalf.flags / DstHalf.flags
enum HalfFlags {
  H_VALID = 1,       // src (dst) >= 0
  H_MOVE = 2,        // src: a replica move (else a leadership transfer)
  H_DEAD = 4,        // src: the source broker is dead
  H_OK = 8,          // src: every source-side check passed
  H_DUP = 16,        // src: a sibling shares the source's rack (goals 0, 15)
  H_SRC_OVER = 32,   // src: the source is over its limit (goals 2-5, 7)
  H_REPLICA_OK = 64, // dst: replica_dst_ok
  H_LEAD_OK = 128,   // dst: leadership_dst_ok
};

// What a score reads of (p, kind, slot) and its source broker. An odd number
// of 4-byte words, so that threads reading consecutive halves in shared
// memory hit distinct banks.
struct SrcHalf {
  int p, src, t, flags;  // src as the assignment holds it (-1: empty slot)
  int drep, dleader;
  float dload[4], dpnw, dlnw;
  float load[4], band_lo[4], band_hi[4];  // the source broker's
  int rep, lead, host, rack, topic_src;   // topic_src = topic_count[t * B + src]
  float lnw, hi_topic;
  float g0, g1;  // goals 8-11: capacity (floored) and utilization; 12: the topic's window
};

// What a score reads of the destination broker; `dst` as given.
struct DstHalf {
  int dst, flags;
  float load[4], hi_load[4], band_lo[4], band_hi[4];
  int rep, lead;
  float hi_rep, hi_lead, potential, hi_pnw, lnw, hi_lnw;
  int host, rack;
  float host_cpu, hi_host_cpu, limit;
  float g0, g1;  // goals 0, 15: the tiebreak; 5: the host's CPU limit; 8-11: capacity, utilization
};

static_assert(sizeof(SrcHalf) % 8 == 4, "SrcHalf must be an odd number of words");
static_assert(sizeof(DstHalf) % 8 == 4, "DstHalf must be an odd number of words");

// resource of each capacity-goal id (2..5), as goals/hard.py _CAPACITY_KERNEL_ID
__device__ __forceinline__ int capacity_resource(int goal) {
  switch (goal) {
    case 2: return RES_DISK;
    case 3: return RES_NW_IN;
    case 4: return RES_NW_OUT;
    default: return RES_CPU;
  }
}

// The source half of (p, kind, slot). p must be a partition index. No load
// sits behind a branch: a word that this action or goal never reads is
// loaded at index 0 instead (one transaction a warp), so that the loads of
// one level go out together.
__device__ __forceinline__ SrcHalf src_half(const ScoreCtx& g, int p, int kind, int slot) {
  SrcHalf h;
  const int goal = g.goal;
  const bool is_move = kind == KIND_MOVE;
  const bool cap_goal = goal >= 2 && goal <= 5, lim_goal = cap_goal || goal == 7;
  const bool dist_goal = goal >= 8 && goal <= 11, rack_goal = goal == 0 || goal == 15;
  const int res = dist_goal ? goal - 8 : capacity_resource(goal);
  const long long pr = (long long)p * g.R;
  // level 0: the partition's words
  const int src = ld(g.assignment + pr + (is_move ? slot : 0));
  // the part_load row, 24 bytes at an 8-byte boundary: three 8-byte loads
  const float2* pl = reinterpret_cast<const float2*>(g.part_load) + (long long)p * 3;
  float plv[NUM_PART_METRICS];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float2 v = __ldg(pl + m);
    plv[2 * m] = v.x;
    plv[2 * m + 1] = v.y;
  }
  const int t = ld(g.topic_id + p);
  const bool movable = ldb(g.movable + p);
  const bool only_imm = ldb(g.only_immigrants);
  // level 1: the source broker's and the topic's words; sm and tm index the
  // words only a move reads
  const int sc = src < 0 ? 0 : src, sm = is_move ? sc : 0, tm = is_move ? t : 0;
  const bool dead_src = ldb(g.dead + sc);
  float lo_load[4];
  ld4(g.broker_load, sc, h.load);
  ld4(g.lo_load, sc, lo_load);
  ld4(g.band_lo, sc, h.band_lo);
  ld4(g.band_hi, sc, h.band_hi);
  h.rep = ld(g.replica_count + sm);
  h.lead = ld(g.leader_count + sc);
  const float lo_rep = ld(g.lo_rep + sm), lo_lead = ld(g.lo_lead + sc);
  h.lnw = ld(g.leader_nw_in + (goal == 14 ? sc : 0));
  h.host = ld(g.broker_host + sc);
  h.rack = ld(g.broker_rack + sm);
  h.hi_topic = ld(g.hi_topic + tm);
  const float lo_topic = ld(g.lo_topic + tm);
  const float lim_s = ld(g.limit + (lim_goal ? sc : 0));
  const float pot_s = ld(g.potential + (goal == 7 ? sc : 0));
  const float cap_s = ld(g.capacity + (dist_goal ? (long long)sc * 4 + res : 0));
  const float w_lo_t = ld(g.w_lower + (goal == 12 ? t : 0));
  const float w_hi_t = ld(g.w_upper + (goal == 12 ? t : 0));
  // level 2: the topic's count on the source (a move's topic check, case
  // 12), the source's rack count (cases 0, 15), its host's CPU (case 5)
  const int topic_src = ld(g.topic_count + (long long)tm * g.B + sm);
  h.topic_src = is_move ? topic_src : 0;
  const int rack_dup =
      ld(g.rack_count + (rack_goal && is_move ? (long long)p * g.NR + h.rack : 0));
  const int hs5 = goal == 5 ? h.host : 0;
  const float host_cpu_s = ld(g.host_cpu + hs5), host_cap_s = ld(g.host_cpu_cap_limit + hs5);

  // build_action (common.cuh), from the loaded row
  float lead[4], foll[4];
  leader_vec(plv, lead);
  follower_vec(plv, foll);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float move_load = slot == 0 ? lead[r] : foll[r];
    h.dload[r] = is_move ? move_load : lead[r] - foll[r];
  }
  const bool leader_transfer = !is_move || slot == 0;
  h.drep = is_move ? 1 : 0;
  h.dleader = leader_transfer ? 1 : 0;
  h.dpnw = is_move ? plv[NW_OUT_LEADER] : 0.0f;
  h.dlnw = leader_transfer ? plv[NW_IN_LEADER] : 0.0f;
  h.p = p;
  h.src = src;
  h.t = t;

  // the checks that read the source side alone
  bool ok = movable;
  if (only_imm && !dead_src) ok = false;  // acceptance.py:323
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float d = h.dload[r];
    if (d > 0.0f && !dead_src && !(h.load[r] - d >= lo_load[r])) ok = false;
  }
  const float drep = (float)h.drep, dlead = (float)h.dleader;
  if (drep > 0.0f && !dead_src && !((float)h.rep - drep >= lo_rep)) ok = false;
  if (dlead > 0.0f && !dead_src && !((float)h.lead - dlead >= lo_lead)) ok = false;
  if (drep > 0.0f && !dead_src && !((float)(h.topic_src - h.drep) >= lo_topic)) ok = false;

  // the goal's own source words: whether the source is over its limit
  // (cases 2-5, 7), its floored capacity and utilization (8-11), the
  // topic's window (12)
  bool src_over = false;
  if (cap_goal) {
    src_over = at4(h.load, res) > lim_s;
    if (res == RES_CPU) src_over = src_over || host_cpu_s > host_cap_s;
  } else if (goal == 7) {
    src_over = pot_s > lim_s;
  }
  const float cap_f = fmaxf(cap_s, 1e-9f);
  h.g0 = dist_goal ? cap_f : goal == 12 ? w_lo_t : 0.0f;
  h.g1 = dist_goal ? at4(h.load, res) / cap_f : goal == 12 ? w_hi_t : 0.0f;
  h.flags = (src >= 0 ? H_VALID : 0) | (is_move ? H_MOVE : 0) | (dead_src ? H_DEAD : 0) |
            (ok ? H_OK : 0) | (rack_dup > 1 ? H_DUP : 0) | (src_over ? H_SRC_OVER : 0);
  return h;
}

// The destination half of broker `dst` (any int; -1 gives an invalid half)
// for moves and leadership transfers, or, with `move` false, for leadership
// transfers alone (the words only a move reads are loaded at index 0). No
// load sits behind a branch, as in src_half.
__device__ __forceinline__ DstHalf dst_half(const ScoreCtx& g, int dst, bool move = true) {
  DstHalf h;
  const int goal = g.goal;
  const bool lim_goal = (goal >= 2 && goal <= 5) || goal == 7;
  const bool dist_goal = goal >= 8 && goal <= 11, rack_goal = goal == 0 || goal == 15;
  const int dc = dst < 0 ? 0 : dst, dm = move ? dc : 0;
  const bool rep_ok = ldb(g.replica_dst_ok + dc), lead_ok = ldb(g.leadership_dst_ok + dc);
  float cap[4];
  ld4(g.broker_load, dc, h.load);
  ld4(g.hi_load, dc, h.hi_load);
  ld4(g.band_lo, dc, h.band_lo);
  ld4(g.band_hi, dc, h.band_hi);
  ld4(g.capacity, rack_goal || dist_goal ? dc : 0, cap);
  h.rep = ld(g.replica_count + dm);
  h.lead = ld(g.leader_count + dc);
  h.hi_rep = ld(g.hi_rep + dm);
  h.hi_lead = ld(g.hi_lead + dc);
  h.potential = ld(g.potential + dm);
  h.hi_pnw = ld(g.hi_pnw + dm);
  h.lnw = ld(g.leader_nw_in + dc);
  h.hi_lnw = ld(g.hi_lnw + dc);
  h.host = ld(g.broker_host + dc);
  h.rack = ld(g.broker_rack + dm);
  h.limit = ld(g.limit + (lim_goal ? dc : 0));
  // level 2: the host's words
  h.host_cpu = ld(g.host_cpu + h.host);
  h.hi_host_cpu = ld(g.hi_host_cpu + h.host);
  const float host_cap = ld(g.host_cpu_cap_limit + (goal == 5 ? h.host : 0));
  // the goal's own: the rack goals' tiebreak (0, 15), the host's CPU limit
  // (5), the floored capacity and utilization (8-11)
  h.g0 = 0.0f;
  h.g1 = 0.0f;
  if (rack_goal) {
    float m = -INFINITY;
    for (int r = 0; r < 4; ++r) m = fmaxf(m, h.load[r] / fmaxf(cap[r], 1e-9f));
    h.g0 = 1e-3f * (1.0f - xla_tanhf(m));
  } else if (goal == 5) {
    h.g0 = host_cap;
  } else if (dist_goal) {
    const int res = goal - 8;
    h.g0 = fmaxf(at4(cap, res), 1e-9f);
    h.g1 = at4(h.load, res) / h.g0;
  }
  h.dst = dst;
  h.flags = (dst >= 0 ? H_VALID : 0) | (rep_ok ? H_REPLICA_OK : 0) | (lead_ok ? H_LEAD_OK : 0);
  return h;
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

// The run's and the goal's scalars that combine() reads: loaded once per
// thread (load_scalars), not once per cell.
struct Scalars {
  int flags;          // bits 0-3 band_on[r], 4 waive_dead, 5 rack_enabled, 6 w_active
  float w_lo, w_hi;   // the window's first entries (the scalar windows)
  int max_replicas;
};

__device__ __forceinline__ Scalars load_scalars(const ScoreCtx& g) {
  Scalars k;
  k.flags = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) k.flags |= ldb(g.band_on + r) ? 1 << r : 0;
  k.flags |= (ldb(g.waive_dead) ? 16 : 0) | (ldb(g.rack_enabled) ? 32 : 0) |
             (ldb(g.w_active) ? 64 : 0);
  k.w_lo = ld(g.w_lower);
  k.w_hi = ld(g.w_upper);
  k.max_replicas = ld(g.max_replicas);
  return k;
}

// The pair's two words: topic_count[t * B + dst] and rack_count[p * NR +
// rack(dst)], at clamped addresses. combine() reads them only for a move
// (the topic check, the rack checks and case 12 all need one), so a
// leadership transfer loads neither.
struct PairWords {
  int topic_dst, rack_dst;
};

__device__ __forceinline__ PairWords pair_words(const ScoreCtx& g, bool move, int t, int p,
                                                int dst, int rack_dst) {
  if (!move) return {0, 0};
  return {ld(g.topic_count + (long long)t * g.B + (dst < 0 ? 0 : dst)),
          ld(g.rack_count + (long long)p * g.NR + rack_dst)};
}

__device__ __forceinline__ PairWords pair_words(const ScoreCtx& g, const SrcHalf& s,
                                                const DstHalf& d) {
  return pair_words(g, s.flags & H_MOVE, s.t, s.p, d.dst, d.rack);
}

// The masked score of the action of `s` toward `d`: its score where the
// structure, the tables and the goal accept it and it improves by more than
// SCORE_EPS, else -inf. `row` is the partition's assignment row (R words).
__device__ __forceinline__ float combine(const ScoreCtx& g, const Scalars& k, const SrcHalf& s,
                                         const DstHalf& d, const int* row, PairWords w) {
  const int sflags = s.flags, dflags = d.flags;
  const int src = s.src, dst = d.dst;
  if (!(sflags & H_VALID) || !(dflags & H_VALID) || src == dst) return -INFINITY;
  const bool is_move = sflags & H_MOVE;
  const bool dead_src = sflags & H_DEAD;

  // structural_mask (the source side is in H_OK)
  bool ok = (sflags & H_OK) && (is_move ? (dflags & H_REPLICA_OK) : (dflags & H_LEAD_OK));
  if (is_move)
    for (int i = 0; i < g.R; ++i)
      if (row[i] == dst) ok = false;

  // tables_acceptance: hard load box, destination side
  float dload[4], ls[4], dl_[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    dload[r] = s.dload[r];
    ls[r] = s.load[r];
    dl_[r] = d.load[r];
    if (dload[r] > 0.0f && !(dl_[r] + dload[r] <= d.hi_load[r])) ok = false;
  }
  // two-case distribution band
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float dd_ = dload[r];
    float sl = ls[r], dl = dl_[r];
    float lo_s = s.band_lo[r], hi_s = s.band_hi[r];
    float lo_d = d.band_lo[r], hi_d = d.band_hi[r];
    bool pos = dd_ >= 0.0f;
    bool case1 = pos ? (sl >= lo_s && dl <= hi_d) : (dl >= lo_d && sl <= hi_s);
    bool acc1 = pos ? (dl + dd_ <= hi_d && (sl - dd_ >= lo_s || dead_src))
                    : (sl - dd_ <= hi_s && dl + dd_ >= lo_d);
    float prev = sl - dl;
    bool acc2 = fabsf(prev - 2.0f * dd_) < fabsf(prev);
    bool ok_r = case1 ? acc1 : (acc2 || dead_src);
    ok_r = ok_r || dd_ == 0.0f || !(k.flags & (1 << r));
    if (!ok_r) ok = false;
  }
  // replica and leader counts, destination side
  const int drep_i = s.drep, dleader_i = s.dleader;
  const float drep = (float)drep_i, dlead = (float)dleader_i;
  const int rep_d = d.rep, lead_d = d.lead;
  if (drep > 0.0f && !((float)rep_d + drep <= d.hi_rep)) ok = false;
  if (dlead > 0.0f && !((float)lead_d + dlead <= d.hi_lead)) ok = false;
  // potential NW_OUT, leader bytes-in
  const float dpnw = s.dpnw, dlnw = s.dlnw;
  if (dpnw > 0.0f && !(d.potential + dpnw <= d.hi_pnw)) ok = false;
  if (dlnw > 0.0f) {
    bool lnw_ok = d.lnw + dlnw <= d.hi_lnw;
    if (!(lnw_ok || ((k.flags & 16) && dead_src))) ok = false;
  }
  // per-topic replica count, destination side
  if (drep > 0.0f && !((float)(w.topic_dst + drep_i) <= s.hi_topic)) ok = false;
  // host-level CPU
  const int hs = s.host, hd = d.host;
  const float dcpu = dload[RES_CPU];
  const float host_after = d.host_cpu + (hs == hd ? 0.0f : dcpu);
  if (!(dcpu <= 0.0f || host_after <= d.hi_host_cpu)) ok = false;
  // rack safety
  const int count_dst = w.rack_dst - (s.rack == d.rack ? 1 : 0);
  if ((k.flags & 32) && drep > 0.0f && count_dst != 0) ok = false;

  // the goal's own acceptance and score
  float score = 0.0f;
  switch (g.goal) {
    case 0:     // RackAwareGoal
    case 15: {  // KafkaAssignerEvenRackAwareGoal: the rack-aware case, plus
                // the even window [floor(avg), ceil(avg)] on replica counts
      if (is_move && count_dst != 0) ok = false;
      const bool dup = sflags & H_DUP;
      score = (is_move && dup) ? 1.0f + d.g0 : 0.0f;
      if (g.goal == 15) {
        const float lo = k.w_lo, hi = k.w_hi;
        if (is_move && !((float)(rep_d + 1) <= hi)) ok = false;
        const float cs = (float)s.rep, cd = (float)rep_d;
        score = score + (is_move ? distribution_score(cs, cd, cs - 1.0f, cd + 1.0f, lo, hi,
                                                      (cs - cd) * 1e-2f)
                                 : 0.0f);
      }
      break;
    }
    case 1: {  // ReplicaCapacityGoal
      int cap = k.max_replicas;
      if (is_move && !(rep_d + 1 <= cap)) ok = false;
      bool over = s.rep > cap;
      float headroom = (float)(cap - rep_d);
      score = (is_move && over) ? fmaf(1e-3f, xla_tanhf(headroom * 1e-3f), 1.0f) : 0.0f;
      break;
    }
    case 2: case 3: case 4: case 5: {  // CapacityGoal(resource)
      int res = capacity_resource(g.goal);
      float dres = at4(dload, res);
      float after = at4(dl_, res) + dres;
      bool acc = after <= d.limit || dres <= 0.0f;
      if (res == RES_CPU) {
        float h_after = d.host_cpu + (hs == hd ? 0.0f : dres);
        acc = acc && (h_after <= d.g0 || dres <= 0.0f);
      }
      if (!acc) ok = false;
      score = ((sflags & H_SRC_OVER) && dres > 1e-6f) ? dres : 0.0f;
      break;
    }
    case 6: {  // ReplicaDistributionGoal
      const float lo = k.w_lo, hi = k.w_hi;
      if (is_move && !(((float)(s.rep - 1) >= lo || dead_src) && (float)(rep_d + 1) <= hi))
        ok = false;
      const float cs = (float)s.rep, cd = (float)rep_d;
      score = is_move ? distribution_score(cs, cd, cs - 1.0f, cd + 1.0f, lo, hi, (cs - cd) * 1e-2f)
                      : 0.0f;
      break;
    }
    case 7: {  // PotentialNwOutGoal: `limit` is capacity_limit[:, NW_OUT]
      if (!(dpnw <= 0.0f || d.potential + dpnw <= d.limit)) ok = false;
      score = ((sflags & H_SRC_OVER) && dpnw > 1e-6f) ? dpnw : 0.0f;
      break;
    }
    case 8: case 9: case 10: case 11: {  // ResourceDistributionGoal(resource)
      const int res = g.goal - 8;
      const float lo = k.w_lo, hi = k.w_hi;
      const bool active = k.flags & 64;
      const float dres = at4(dload, res);
      const float cap_s = s.g0, cap_d = d.g0;
      const float u_s = s.g1, u_d = d.g1;
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
      const float lo = s.g0, hi = s.g1;
      const int c_s = s.topic_src, c_d = w.topic_dst;
      if (is_move && !(((float)(c_s - 1) >= lo || dead_src) && (float)(c_d + 1) <= hi)) ok = false;
      const float cs = (float)c_s, cd = (float)c_d;
      score = is_move ? distribution_score(cs, cd, cs - 1.0f, cd + 1.0f, lo, hi, (cs - cd) * 1e-2f)
                      : 0.0f;
      break;
    }
    case 13: {  // LeaderReplicaDistributionGoal
      const float lo = k.w_lo, hi = k.w_hi;
      const bool transfers = dleader_i > 0;
      if (transfers && !(((float)(s.lead - 1) >= lo || dead_src) && (float)(lead_d + 1) <= hi))
        ok = false;
      const float cs = (float)s.lead, cd = (float)lead_d;
      score = transfers
                  ? distribution_score(cs, cd, cs - 1.0f, cd + 1.0f, lo, hi, (cs - cd) * 1e-2f)
                  : 0.0f;
      break;
    }
    default: {  // 14: LeaderBytesInDistributionGoal
      const float lo = k.w_lo, hi = k.w_hi;
      const float dl = dlnw;
      if (dl > 0.0f && !(d.lnw + dl <= hi || dead_src)) ok = false;
      const float bs = s.lnw, bd = d.lnw;
      score = dl > 0.0f ? distribution_score(bs, bd, bs - dl, bd + dl, lo, hi, (bs - bd) * 1e-6f)
                        : 0.0f;
      break;
    }
  }
  const bool evac = dead_src && (is_move || dleader_i > 0);
  score = score + (evac ? 1.0e6f : 0.0f);
  return (ok && score > 1e-6f) ? score : -INFINITY;
}
