// K5 score_swaps: validation and improvement of coupled two-leg actions, one
// thread per cell, -inf where the cell is not ok.
//
// Replaces: cruise_control_tpu/analyzer/swaps.py make_swap_round's grid
// (:98-194) and per-wave re-validation (:255-282), drain.py
// make_topic_swap_round.validate (:485) and make_leadership_relay_round
// .validate (:692), all through acceptance.swap_tables_acceptance (:234).
//
// Bound on this card: bytes, and in practice latency. The largest grid is
// the replica swap's [128, 128, 8, 8] = 1,048,576 cells at 2,600 brokers;
// its distinct inputs are the 2 x 128 x 8 picked replicas' rows and a few
// hundred brokers' aggregate and table words (tens of KB), and its output
// 4 MB. A cell costs ~200 operations, ~0.2 G operations a grid: a few
// microseconds at the card's float32 rate. The topic-swap grid [512, 16, 8]
// and the relay grid [512, 4, 2, 8, 2] are 65,536 cells each; a wave's
// re-validation is 128 or 512 cells.
//
// Design: a switch over the three kinds. The six index tensors (p1, s1, b,
// p2, s2, d) broadcast to one shape of rank <= 5 and are read through their
// strides, so the lazily broadcast grids and the [..., 4] net-load
// intermediate of swaps.py:162 are never materialised: each thread gathers
// its two rows and brokers and keeps the net in registers. A negative p1,
// p2, b or d marks a cell the caller masked (a missing pick, a stale
// nomination); it is -inf before anything is gathered with its indices.
// Under only_move_immigrants (a device flag) no swap or relay is ok, where
// the JAX package puts the term: the replica-swap grid and both validates.
// Every float operation is the reference's, in its order (-fmad=false, no
// fast math), so the results are bit-equal to the plain versions.
#include "common.cuh"

enum SwapKind { REPLICA_SWAP = 0, TOPIC_SWAP = 1, LEADERSHIP_RELAY = 2 };

struct SwapArgs {
  float* out;
  const int *p1, *s1, *b, *p2, *s2, *d;
  long long st[6][5];
  long long dims[5], numel;
  const int* assignment;
  const float* part_load;
  const int* topic_id;
  const float *capacity, *capacity_limit;
  const int *broker_rack, *broker_host;
  const unsigned char *movable, *replica_dst_ok, *leadership_dst_ok;
  const float* broker_load;
  const int* leader_count;
  const float *potential, *leader_nw_in;
  const int *rack_count, *topic_count;
  const float* host_cpu;
  const float *hi_load, *lo_load, *band_hi, *band_lo;
  const unsigned char* band_on;
  const float *hi_lead, *lo_lead, *hi_pnw, *hi_lnw, *hi_topic, *lo_topic, *hi_host_cpu;
  const unsigned char* rack_enabled;
  const float *w_lower, *w_upper;  // the goal's window: f32[] or f32[T]
  const unsigned char* w_active;
  const unsigned char* only_immigrants;  // bool[]: only replicas on dead brokers move
  int R, NR, B, kind, res, wave;
};

// acceptance.band_move_acceptance (:116) for a signed transfer src -> dst
__device__ bool band_ok(const SwapArgs& g, int src, int dst, const float dl[4], bool dead) {
  for (int r = 0; r < 4; ++r) {
    const float d = dl[r];
    const long long ps = (long long)src * 4 + r, pd = (long long)dst * 4 + r;
    const float s = g.broker_load[ps], dd = g.broker_load[pd];
    const bool pos = d >= 0.0f;
    const bool case1 = pos ? (s >= g.band_lo[ps] && dd <= g.band_hi[pd])
                           : (dd >= g.band_lo[pd] && s <= g.band_hi[ps]);
    const bool acc1 = pos ? (dd + d <= g.band_hi[pd] && (s - d >= g.band_lo[ps] || dead))
                          : (s - d <= g.band_hi[ps] && dd + d >= g.band_lo[pd]);
    const float prev = s - dd;
    const bool acc2 = fabsf(prev - 2.0f * d) < fabsf(prev);
    bool ok = case1 ? acc1 : (acc2 || dead);
    ok = ok || d == 0.0f || !g.band_on[r];
    if (!ok) return false;
  }
  return true;
}

// acceptance.swap_tables_acceptance (:234): mv1 moves a replica hot -> cold,
// mv2 one cold -> hot; the merged bounds hold on the net effect
__device__ bool swap_tables_ok(const SwapArgs& g, const Action& m1, const Action& m2) {
  const int hot = m1.src, cold = m2.src;
  float d[4];
  for (int r = 0; r < 4; ++r) d[r] = m1.dload[r] - m2.dload[r];
  for (int r = 0; r < 4; ++r) {
    const long long pc = (long long)cold * 4 + r, ph = (long long)hot * 4 + r;
    const float dc = d[r], dh = -d[r];
    const float ac = g.broker_load[pc] + dc, ah = g.broker_load[ph] + dh;
    if (!(!(dc > 0.0f) || ac <= g.hi_load[pc])) return false;
    if (!((dc > 0.0f) || ac >= g.lo_load[pc])) return false;
    if (!(!(dh > 0.0f) || ah <= g.hi_load[ph])) return false;
    if (!((dh > 0.0f) || ah >= g.lo_load[ph])) return false;
  }
  if (!band_ok(g, hot, cold, d, false)) return false;
  const float dl = (float)(m1.dleader - m2.dleader);
  const float lc = (float)g.leader_count[cold], lh = (float)g.leader_count[hot];
  if (!(dl <= 0.0f || (lc + dl <= g.hi_lead[cold] && lh - dl >= g.lo_lead[hot]))) return false;
  if (!(dl >= 0.0f || (lh - dl <= g.hi_lead[hot] && lc + dl >= g.lo_lead[cold]))) return false;
  const float dpnw = m1.dpnw - m2.dpnw;
  if (!(dpnw <= 0.0f || g.potential[cold] + dpnw <= g.hi_pnw[cold])) return false;
  if (!(dpnw >= 0.0f || g.potential[hot] - dpnw <= g.hi_pnw[hot])) return false;
  const float dlnw = m1.dleader_nw_in - m2.dleader_nw_in;
  if (!(dlnw <= 0.0f || g.leader_nw_in[cold] + dlnw <= g.hi_lnw[cold])) return false;
  if (!(dlnw >= 0.0f || g.leader_nw_in[hot] - dlnw <= g.hi_lnw[hot])) return false;
  const long long t1 = g.topic_id[m1.p], t2 = g.topic_id[m2.p];
  if (t1 != t2) {
    const int* tc = g.topic_count;
    const bool topic_ok = (float)(tc[t1 * g.B + cold] + 1) <= g.hi_topic[t1] &&
                          (float)(tc[t1 * g.B + hot] - 1) >= g.lo_topic[t1] &&
                          (float)(tc[t2 * g.B + hot] + 1) <= g.hi_topic[t2] &&
                          (float)(tc[t2 * g.B + cold] - 1) >= g.lo_topic[t2];
    if (!topic_ok) return false;
  }
  const float dcpu = d[RES_CPU];
  const int hh = g.broker_host[hot], hc = g.broker_host[cold];
  if (hh != hc) {
    if (!(dcpu <= 0.0f || g.host_cpu[hc] + dcpu <= g.hi_host_cpu[hc])) return false;
    if (!(dcpu >= 0.0f || g.host_cpu[hh] - dcpu <= g.hi_host_cpu[hh])) return false;
  }
  return true;
}

__device__ __forceinline__ bool row_holds(const SwapArgs& g, int p, int broker) {
  for (int s = 0; s < g.R; ++s)
    if (g.assignment[(long long)p * g.R + s] == broker) return true;
  return false;
}

// rack safety both ways (minus the departing replica on a shared rack), or
// no rack goal among the priors
__device__ __forceinline__ bool rack_safe_or_off(const SwapArgs& g, int p1, int b, int p2, int d) {
  if (!g.rack_enabled[0]) return true;
  const int rb = g.broker_rack[b], rd = g.broker_rack[d];
  const int same = rb == rd ? 1 : 0;
  return g.rack_count[(long long)p1 * g.NR + rd] - same == 0 &&
         g.rack_count[(long long)p2 * g.NR + rb] - same == 0;
}

__device__ __forceinline__ float slot_load(const SwapArgs& g, int p, int slot, int res) {
  float v[4];
  const float* pl = g.part_load + (long long)p * NUM_PART_METRICS;
  if (slot == 0) leader_vec(pl, v);
  else follower_vec(pl, v);
  return v[res];
}

// swaps.py: the round-start grid cell (wave == 0) or a wave's re-validation
__device__ float replica_swap(const SwapArgs& g, int p1, int s1, int hot, int p2, int s2,
                              int cold) {
  const int res = g.res;
  const float lo = g.w_lower[0], hi = g.w_upper[0];
  const float cap_h = fmaxf(g.capacity[(long long)hot * 4 + res], 1e-9f);
  const float cap_c = fmaxf(g.capacity[(long long)cold * 4 + res], 1e-9f);
  const float u_h = g.broker_load[(long long)hot * 4 + res] / cap_h;
  const float u_c = g.broker_load[(long long)cold * 4 + res] / cap_c;
  const float delta = slot_load(g, p1, s1, res) - slot_load(g, p2, s2, res);
  const float h0 = imbalance(u_h, lo, hi), h1 = imbalance(u_h - delta / cap_h, lo, hi);
  const float c0 = imbalance(u_c, lo, hi), c1 = imbalance(u_c + delta / cap_c, lo, hi);
  const bool endpoint_ok = h1 <= h0 + 1e-6f && c1 <= c0 + 1e-6f;
  const Action m1 = build_action(g.assignment, g.R, g.part_load, p1, KIND_MOVE, s1, cold);
  const Action m2 = build_action(g.assignment, g.R, g.part_load, p2, KIND_MOVE, s2, hot);
  if (g.wave) {
    const float improve = h0 + c0 - h1 - c1;
    bool ok = g.assignment[(long long)p1 * g.R + s1] == hot &&
              g.assignment[(long long)p2 * g.R + s2] == cold;
    ok = ok && !row_holds(g, p1, cold) && !row_holds(g, p2, hot);
    ok = ok && rack_safe_or_off(g, p1, hot, p2, cold);
    ok = ok && endpoint_ok && improve > 1e-6f;
    // the legs' sources are live brokers only where the rows still hold
    // them: the table check reads aggregates at those brokers
    ok = ok && swap_tables_ok(g, m1, m2);
    return ok ? improve : -INFINITY;
  }
  // the round-start grid is off under only_move_immigrants (swaps.py:98-103)
  bool ok = delta > 1e-6f && hot != cold && p1 != p2 && g.w_active[0] && !g.only_immigrants[0];
  // the picks come from these brokers, so the legs' sources are hot / cold
  ok = ok && m1.src >= 0 && m2.src >= 0 && swap_tables_ok(g, m1, m2);
  ok = ok && !row_holds(g, p1, cold) && !row_holds(g, p2, hot);
  ok = ok && rack_safe_or_off(g, p1, hot, p2, cold);
  ok = ok && (s1 != 0 || g.leadership_dst_ok[cold]) && (s2 != 0 || g.leadership_dst_ok[hot]);
  for (int r = 0; ok && r < 4; ++r) {
    const long long ph = (long long)hot * 4 + r, pc = (long long)cold * 4 + r;
    const float net = m1.dload[r] - m2.dload[r];
    const float hb = g.broker_load[ph], cb = g.broker_load[pc];
    const float hl = fmaxf(g.capacity_limit[ph], hb), cl = fmaxf(g.capacity_limit[pc], cb);
    if (!(hb - net <= hl + 1e-6f)) ok = false;
    if (!(cb + net <= cl + 1e-6f)) ok = false;
  }
  if (ok) {
    const float pnw1 = g.part_load[(long long)p1 * NUM_PART_METRICS + NW_OUT_LEADER];
    const float pnw2 = g.part_load[(long long)p2 * NUM_PART_METRICS + NW_OUT_LEADER];
    const float lim_c = g.capacity_limit[(long long)cold * 4 + RES_NW_OUT];
    const float lim_h = g.capacity_limit[(long long)hot * 4 + RES_NW_OUT];
    const float pc0 = g.potential[cold], ph0 = g.potential[hot];
    ok = pc0 + pnw1 - pnw2 <= fmaxf(lim_c, pc0) + 1e-6f && ph0 - pnw1 + pnw2 <= fmaxf(lim_h, ph0) + 1e-6f;
  }
  ok = ok && endpoint_ok;
  return ok ? h0 + c0 - h1 - c1 : -INFINITY;
}

// drain.py make_topic_swap_round.validate (:485)
__device__ float topic_swap(const SwapArgs& g, int p1, int s1, int b, int p2, int s2, int d) {
  const int* a = g.assignment;
  bool still = a[(long long)p1 * g.R + s1] == b && a[(long long)p2 * g.R + s2] == d && b != d &&
               p1 != p2;
  still = still && g.movable[p1] && g.movable[p2] && g.replica_dst_ok[d] && g.replica_dst_ok[b];
  still = still && !g.only_immigrants[0];
  still = still && !row_holds(g, p1, d) && !row_holds(g, p2, b);
  still = still && rack_safe_or_off(g, p1, b, p2, d);
  still = still && (s1 != 0 || g.leadership_dst_ok[d]) && (s2 != 0 || g.leadership_dst_ok[b]);
  if (!still) return -INFINITY;
  const Action m1 = build_action(a, g.R, g.part_load, p1, KIND_MOVE, s1, d);
  const Action m2 = build_action(a, g.R, g.part_load, p2, KIND_MOVE, s2, b);
  if (!swap_tables_ok(g, m1, m2)) return -INFINITY;
  const long long t1 = g.topic_id[p1], t2 = g.topic_id[p2];
  if (t1 == t2) return -INFINITY;  // topic-neutral: improvement -0.0
  const int* tc = g.topic_count;
  const int c1b = tc[t1 * g.B + b], c1d = tc[t1 * g.B + d];
  const int c2d = tc[t2 * g.B + d], c2b = tc[t2 * g.B + b];
  const float l1 = g.w_lower[t1], u1 = g.w_upper[t1], l2 = g.w_lower[t2], u2 = g.w_upper[t2];
  const float delta = imbalance((float)(c1b - 1), l1, u1) - imbalance((float)c1b, l1, u1) +
                      imbalance((float)(c1d + 1), l1, u1) - imbalance((float)c1d, l1, u1) +
                      imbalance((float)(c2d - 1), l2, u2) - imbalance((float)c2d, l2, u2) +
                      imbalance((float)(c2b + 1), l2, u2) - imbalance((float)c2b, l2, u2);
  const float improvement = -delta;
  return improvement > 1e-6f ? improvement : -INFINITY;
}

// drain.py make_leadership_relay_round.endpoint_ok (:672)
__device__ bool relay_endpoint_ok(const SwapArgs& g, int x, const float dl[4], float dlnw,
                                  int dcnt) {
  for (int r = 0; r < 4; ++r) {
    const long long px = (long long)x * 4 + r;
    const bool inc = dl[r] > 0.0f;
    const float after = g.broker_load[px] + dl[r];
    if (inc && !(after <= g.hi_load[px])) return false;
    const bool band = inc ? after <= g.band_hi[px] : after >= g.band_lo[px];
    if (!(dl[r] == 0.0f || !g.band_on[r] || band)) return false;
  }
  if (!(dlnw <= 0.0f || g.leader_nw_in[x] + dlnw <= g.hi_lnw[x])) return false;
  const float cnt_after = (float)(g.leader_count[x] + dcnt);
  if (!(dcnt <= 0 || cnt_after <= g.hi_lead[x])) return false;
  if (!(dcnt >= 0 || cnt_after >= g.lo_lead[x])) return false;
  return true;
}

// drain.py make_leadership_relay_round.validate (:692): leadership of p1
// b -> d (promote slot s1), leadership of p2 d -> e = assignment[p2, s2]
__device__ float relay(const SwapArgs& g, int p1, int s1, int b, int p2, int s2, int d) {
  const int* a = g.assignment;
  const int e_raw = a[(long long)p2 * g.R + s2];
  const int e = e_raw > 0 ? e_raw : 0;
  bool still = a[(long long)p1 * g.R] == b && a[(long long)p1 * g.R + s1] == d &&
               a[(long long)p2 * g.R] == d && e_raw >= 0;
  still = still && b != d && d != e && p1 != p2 && s1 >= 1 && s2 >= 1;
  still = still && g.movable[p1] && g.movable[p2] && g.leadership_dst_ok[d] &&
          g.leadership_dst_ok[e];
  still = still && !g.only_immigrants[0];
  if (!still) return -INFINITY;
  const Action a1 = build_action(a, g.R, g.part_load, p1, KIND_LEADERSHIP, s1, d);
  const Action a2 = build_action(a, g.R, g.part_load, p2, KIND_LEADERSHIP, s2, e);
  const bool eb = e == b;
  float db[4], dd[4], de[4];
  for (int r = 0; r < 4; ++r) {
    db[r] = -a1.dload[r] + (eb ? a2.dload[r] : 0.0f);
    dd[r] = a1.dload[r] - a2.dload[r];
    de[r] = eb ? 0.0f : a2.dload[r];
  }
  const float w1 = a1.dleader_nw_in, w2 = a2.dleader_nw_in;
  const float lnw_b = -w1 + (eb ? w2 : 0.0f), lnw_d = w1 - w2, lnw_e = eb ? 0.0f : w2;
  if (!relay_endpoint_ok(g, b, db, lnw_b, eb ? 0 : -1)) return -INFINITY;
  if (!relay_endpoint_ok(g, d, dd, lnw_d, 0)) return -INFINITY;
  if (!relay_endpoint_ok(g, e, de, lnw_e, eb ? 0 : 1)) return -INFINITY;
  // host CPU combined per touched host (the endpoints may share hosts)
  const int hb = g.broker_host[b], hd = g.broker_host[d], he = g.broker_host[e];
  const float cb = db[RES_CPU], cd = dd[RES_CPU], ce = de[RES_CPU];
  const int hosts[3] = {hb, hd, he};
  for (int i = 0; i < 3; ++i) {
    const int h = hosts[i];
    const float tot = (hb == h ? cb : 0.0f) + (hd == h ? cd : 0.0f) + (he == h ? ce : 0.0f);
    if (!(tot <= 0.0f || g.host_cpu[h] + tot <= g.hi_host_cpu[h])) return -INFINITY;
  }
  const float lo = g.w_lower[0], hi = g.w_upper[0];
  const float xb = g.leader_nw_in[b], xd = g.leader_nw_in[d], xe = g.leader_nw_in[e];
  const float before = imbalance(xb, lo, hi) + imbalance(xd, lo, hi) + (eb ? 0.0f : imbalance(xe, lo, hi));
  const float after = imbalance(xb + lnw_b, lo, hi) + imbalance(xd + lnw_d, lo, hi) +
                      (eb ? 0.0f : imbalance(xe + lnw_e, lo, hi));
  const float improvement = before - after;
  return improvement > 1e-6f ? improvement : -INFINITY;
}

__device__ __forceinline__ int at(const int* t, const long long st[5], const long long i[5]) {
  return t[i[0] * st[0] + i[1] * st[1] + i[2] * st[2] + i[3] * st[3] + i[4] * st[4]];
}

__global__ void k_score_swaps(SwapArgs g) {
  long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= g.numel) return;
  long long i[5], rem = e;
  for (int k = 4; k >= 0; --k) {
    i[k] = rem % g.dims[k];
    rem /= g.dims[k];
  }
  const int p1 = at(g.p1, g.st[0], i), s1 = at(g.s1, g.st[1], i), b = at(g.b, g.st[2], i);
  const int p2 = at(g.p2, g.st[3], i), s2 = at(g.s2, g.st[4], i), d = at(g.d, g.st[5], i);
  float out = -INFINITY;
  if (p1 >= 0 && p2 >= 0 && b >= 0 && d >= 0) {
    switch (g.kind) {
      case REPLICA_SWAP: out = replica_swap(g, p1, s1, b, p2, s2, d); break;
      case TOPIC_SWAP: out = topic_swap(g, p1, s1, b, p2, s2, d); break;
      default: out = relay(g, p1, s1, b, p2, s2, d); break;
    }
  }
  g.out[e] = out;
}

// ptrs (in this order): out, p1, s1, b, p2, s2, d, assignment, part_load,
//   topic_id, broker_capacity, capacity_limit, broker_rack, broker_host,
//   movable_partition, replica_dst_ok, leadership_dst_ok, broker_load,
//   leader_count, potential_nw_out, leader_nw_in, rack_replica_count,
//   topic_replica_count, host_cpu_load, hi_load, lo_load, band_hi, band_lo,
//   band_on, hi_lead, lo_lead, hi_pnw, hi_lnw, hi_topic, lo_topic,
//   hi_host_cpu, rack_enabled, w_lower, w_upper, w_active,
//   only_move_immigrants
// ints: d0..d4, strides of p1, s1, b, p2, s2, d (5 each), R, NR, B, kind,
//   resource, wave, per_topic
CC_EXPORT int score_swaps(const long long* ptrs, const long long* ints, cudaStream_t stream) {
  SwapArgs g;
  int k = 0;
  g.out = (float*)ptrs[k++];
  g.p1 = (const int*)ptrs[k++];
  g.s1 = (const int*)ptrs[k++];
  g.b = (const int*)ptrs[k++];
  g.p2 = (const int*)ptrs[k++];
  g.s2 = (const int*)ptrs[k++];
  g.d = (const int*)ptrs[k++];
  g.assignment = (const int*)ptrs[k++];
  g.part_load = (const float*)ptrs[k++];
  g.topic_id = (const int*)ptrs[k++];
  g.capacity = (const float*)ptrs[k++];
  g.capacity_limit = (const float*)ptrs[k++];
  g.broker_rack = (const int*)ptrs[k++];
  g.broker_host = (const int*)ptrs[k++];
  g.movable = (const unsigned char*)ptrs[k++];
  g.replica_dst_ok = (const unsigned char*)ptrs[k++];
  g.leadership_dst_ok = (const unsigned char*)ptrs[k++];
  g.broker_load = (const float*)ptrs[k++];
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
  g.hi_lead = (const float*)ptrs[k++];
  g.lo_lead = (const float*)ptrs[k++];
  g.hi_pnw = (const float*)ptrs[k++];
  g.hi_lnw = (const float*)ptrs[k++];
  g.hi_topic = (const float*)ptrs[k++];
  g.lo_topic = (const float*)ptrs[k++];
  g.hi_host_cpu = (const float*)ptrs[k++];
  g.rack_enabled = (const unsigned char*)ptrs[k++];
  g.w_lower = (const float*)ptrs[k++];
  g.w_upper = (const float*)ptrs[k++];
  g.w_active = (const unsigned char*)ptrs[k++];
  g.only_immigrants = (const unsigned char*)ptrs[k++];
  int q = 0;
  g.numel = 1;
  for (int j = 0; j < 5; ++j) {
    g.dims[j] = ints[q++];
    g.numel *= g.dims[j];
  }
  for (int t = 0; t < 6; ++t)
    for (int j = 0; j < 5; ++j) g.st[t][j] = ints[q++];
  g.R = (int)ints[q++];
  g.NR = (int)ints[q++];
  g.B = (int)ints[q++];
  g.kind = (int)ints[q++];
  g.res = (int)ints[q++];
  g.wave = (int)ints[q++];
  if (g.numel == 0) return cudaSuccess;
  if (g.kind < REPLICA_SWAP || g.kind > LEADERSHIP_RELAY) return cudaErrorInvalidValue;
  k_score_swaps<<<(unsigned)((g.numel + 255) / 256), 256, 0, stream>>>(g);
  return cudaGetLastError();
}
