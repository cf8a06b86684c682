// K5 score_swaps: validation and improvement of coupled two-leg actions,
// -inf where the cell is not ok.
//
// Replaces: cruise_control_tpu/analyzer/swaps.py make_swap_round's grid
// (:98-194) and per-wave re-validation (:255-282), drain.py
// make_topic_swap_round.validate (:485) and make_leadership_relay_round
// .validate (:692), all through acceptance.swap_tables_acceptance (:234).
//
// Bound on this card: operations, and in practice latency. The largest grid
// is the replica swap's [128, 128, 8, 8] = 1,048,576 cells at 2,600 brokers;
// its distinct inputs are the 2 x 128 x 8 picked replicas' rows and a few
// hundred brokers' aggregate and table words (tens of KB), and its output
// 4 MB. A cell costs ~200 operations, ~0.2 G operations a grid: a few
// microseconds at the card's float32 rate. The topic-swap grid [512, 16, 8]
// and the relay grid [512, 4, 2, 8, 2] are 65,536 cells each; a wave's
// re-validation is 128 or 512 cells.
//
// Every launch reads the round's tensors from the ScoreCtx the host packs
// once a round (score_goal.cuh; K5's context carries no goal). The six
// index tensors (p1, s1, b, p2, s2, d) broadcast to one shape of rank <= 5
// and are read through their strides, so the lazily broadcast grids are
// never materialised. A negative p1, p2, b or d marks a cell the caller
// masked (a missing pick, a stale nomination): it is -inf. Under
// only_move_immigrants (a device flag) no swap or relay is ok, where the JAX
// package puts the term. Every float operation is the reference's, in its
// order (-fmad=false, no fast math), so the results are bit-equal to the
// plain versions. Two paths, chosen on the host from the strides
// (kernels/score_swaps.py `choose_path`):
//   - cells (k_score_swaps): one thread a cell, every kind and form. A
//     replica swap's cell loads all its words at once, at clamped indices
//     (its picks' halves, its brokers' words, the cross words), then runs
//     every check as independent compares (a wave's re-validation of 128
//     cells is a few dependent loads deep, not dozens); the topic swaps and
//     relays keep the reference's form;
//   - staged (k_swap_staged): the replica-swap grid [I hot, J cold, A, B],
//     whose cell (i, j, a, b) pairs hot pick (i, a) with cold pick (j, b).
//     A block takes hot broker i and a tile of cold brokers, a thread a cold
//     pick at a time (two each where one would make more blocks than run at
//     once). The hot side is staged once a block in shared memory: the hot
//     broker's words and each hot pick's half (its row, slot loads, topic
//     and the topic's count on its broker). Each thread loads its cold
//     pick's half and its broker's words into registers at the same time,
//     then the words that depend on a pick and the other side's broker
//     (topic_count[t, other], rack_count[p, rack(other)], whether the pick's
//     row holds the other broker), and combines its A cells, reading only
//     the hot pick's half and the hot broker's words (the same for the whole
//     warp) from shared memory. The staged words assume each valid pick sits
//     on its grid broker, as swap_grid's picks do; a cell whose pick does not
//     is scored as a thread a cell scores it.
#include "score_goal.cuh"

enum SwapKind { REPLICA_SWAP = 0, TOPIC_SWAP = 1, LEADERSHIP_RELAY = 2 };
enum SwapPath { PATH_CELLS = 0, PATH_STAGED = 1 };

struct SwapArgs {
  ScoreCtx c;
  float* out;
  const int *p1, *s1, *b, *p2, *s2, *d;
  long long st[6][5];
  long long dims[5], numel;
  int kind, res, wave;
  int tile;  // staged: cold brokers a block takes
};

// acceptance.band_move_acceptance (:116) for a signed transfer src -> dst
__device__ bool band_ok(const ScoreCtx& g, int src, int dst, const float dl[4], bool dead) {
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
__device__ bool swap_tables_ok(const ScoreCtx& g, const Action& m1, const Action& m2) {
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

__device__ __forceinline__ bool row_holds(const ScoreCtx& g, int p, int broker) {
  for (int s = 0; s < g.R; ++s)
    if (g.assignment[(long long)p * g.R + s] == broker) return true;
  return false;
}

// rack safety both ways (minus the departing replica on a shared rack), or
// no rack goal among the priors
__device__ __forceinline__ bool rack_safe_or_off(const ScoreCtx& g, int p1, int b, int p2, int d) {
  if (!g.rack_enabled[0]) return true;
  const int rb = g.broker_rack[b], rd = g.broker_rack[d];
  const int same = rb == rd ? 1 : 0;
  return g.rack_count[(long long)p1 * g.NR + rd] - same == 0 &&
         g.rack_count[(long long)p2 * g.NR + rb] - same == 0;
}

__device__ __forceinline__ float slot_load(const ScoreCtx& g, int p, int slot, int res) {
  float v[4];
  const float* pl = g.part_load + (long long)p * NUM_PART_METRICS;
  if (slot == 0) leader_vec(pl, v);
  else follower_vec(pl, v);
  return v[res];
}

// swaps.py: the round-start grid cell (wave == 0) or a wave's re-validation,
// loads behind its checks: the form a cell takes when its picks are not on
// the brokers the grid names (no grid the rounds build has such a cell)
__device__ float replica_swap(const ScoreCtx& g, int res, int wave, int p1, int s1, int hot,
                              int p2, int s2, int cold) {
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
  if (wave) {
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
__device__ float topic_swap(const ScoreCtx& g, int p1, int s1, int b, int p2, int s2, int d) {
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
__device__ bool relay_endpoint_ok(const ScoreCtx& g, int x, const float dl[4], float dlnw,
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
__device__ float relay(const ScoreCtx& g, int p1, int s1, int b, int p2, int s2, int d) {
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

// -- the staged replica-swap grid ---------------------------------------------

constexpr int SW_THREADS = 256;

// What a cell reads of a pick (p, s) moving to the other side: the move's
// deltas (build_action's, for a move of slot s), its topic and the topic's
// count on its own broker. An odd number of words, so that threads reading
// consecutive picks hit distinct banks.
struct PickHalf {
  int p, s, t, dleader;
  float dload[4], dpnw, dlnw;
  int topic_own;             // topic_count[t * B + its broker]
  float hi_topic, lo_topic;  // the topic's bounds
};

// What a cell reads of a grid broker (b = -1: masked). lim[r] is
// fmaxf(capacity_limit[r], load[r]) + 1e-6f, pot_lim fmaxf(capacity_limit
// [NW_OUT], potential) + 1e-6f: the capacity and potential bounds of the
// grid's checks, the same values the plain version computes per cell.
struct BrokerWords {
  int b, host, rack, lead_ok;
  float load[4], hi_load[4], lo_load[4], band_lo[4], band_hi[4], lim[4];
  float cap, u, imb0;  // fmaxf(capacity[res], 1e-9f), load[res] / cap, imbalance(u, window)
  float lead, hi_lead, lo_lead;
  float pot, hi_pnw, pot_lim, lnw, hi_lnw;
  float host_cpu, hi_host_cpu;
};

// The words of a pick and the other side's broker: topic_count[t, other],
// rack_count[p, rack(other)], and whether the pick's row holds the other.
struct Cross {
  int tc, rack, holds;
};

static_assert(sizeof(PickHalf) % 8 == 4, "PickHalf must be an odd number of words");
static_assert(sizeof(BrokerWords) % 8 == 4, "BrokerWords must be an odd number of words");
static_assert(sizeof(Cross) % 8 == 4, "Cross must be an odd number of words");

// A staged block's shared memory: the hot broker's words, its A picks'
// halves, their rows and whether each is stray (not on the hot broker).
__host__ __device__ __forceinline__ size_t staged_bytes(int A, int R) {
  return sizeof(BrokerWords) + (size_t)A * (sizeof(PickHalf) + R * sizeof(int) + sizeof(int));
}

__device__ __forceinline__ void load_broker(const ScoreCtx& g, int b, int res, float lo, float hi,
                                            BrokerWords& w) {
  const int bc = b < 0 ? 0 : b;
  ld4(g.broker_load, bc, w.load);
  ld4(g.hi_load, bc, w.hi_load);
  ld4(g.lo_load, bc, w.lo_load);
  ld4(g.band_lo, bc, w.band_lo);
  ld4(g.band_hi, bc, w.band_hi);
  float lim[4], cap[4];
  ld4(g.capacity_limit, bc, lim);
  ld4(g.capacity, bc, cap);
  const int lead = ld(g.leader_count + bc);
  w.hi_lead = ld(g.hi_lead + bc);
  w.lo_lead = ld(g.lo_lead + bc);
  w.pot = ld(g.potential + bc);
  w.hi_pnw = ld(g.hi_pnw + bc);
  w.lnw = ld(g.leader_nw_in + bc);
  w.hi_lnw = ld(g.hi_lnw + bc);
  const int host = ld(g.broker_host + bc);
  w.rack = ld(g.broker_rack + bc);
  w.lead_ok = ldb(g.leadership_dst_ok + bc) ? 1 : 0;
  w.host_cpu = ld(g.host_cpu + host);
  w.hi_host_cpu = ld(g.hi_host_cpu + host);
  w.b = b;
  w.host = host;
  w.lead = (float)lead;
#pragma unroll
  for (int r = 0; r < 4; ++r) w.lim[r] = fmaxf(lim[r], w.load[r]) + 1e-6f;
  w.pot_lim = fmaxf(lim[RES_NW_OUT], w.pot) + 1e-6f;
  w.cap = fmaxf(at4(cap, res), 1e-9f);
  w.u = at4(w.load, res) / w.cap;
  w.imb0 = imbalance(w.u, lo, hi);
}

// The half of pick (p, s) on grid broker `broker`, its row into `row` where
// given; `holds` whether that row holds broker `other`. Returns whether the
// pick is where the grid says (p masked, its broker masked, or its slot
// holds it).
__device__ __forceinline__ bool load_pick(const ScoreCtx& g, int p, int s, int broker, int other,
                                          PickHalf& h, int* row, int& holds) {
  const int pc = p < 0 ? 0 : p;
  const long long pr = (long long)pc * g.R;
  int src = -1;
  holds = 0;
  for (int q = 0; q < g.R; ++q) {
    const int x = ld(g.assignment + pr + q);
    if (row != nullptr) row[q] = x;
    src = q == s ? x : src;
    holds |= x == other ? 1 : 0;
  }
  const float2* pl = reinterpret_cast<const float2*>(g.part_load) + (long long)pc * 3;
  float plv[NUM_PART_METRICS];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float2 v = __ldg(pl + m);
    plv[2 * m] = v.x;
    plv[2 * m + 1] = v.y;
  }
  const int t = ld(g.topic_id + pc);
  const int own = ld(g.topic_count + (long long)t * g.B + (src < 0 ? 0 : src));
  h.hi_topic = ld(g.hi_topic + t);
  h.lo_topic = ld(g.lo_topic + t);
  // build_action (common.cuh) of a move of slot s
  float v[4];
  if (s == 0) leader_vec(plv, v);
  else follower_vec(plv, v);
#pragma unroll
  for (int r = 0; r < 4; ++r) h.dload[r] = v[r];
  h.p = p;
  h.s = s;
  h.t = t;
  h.dleader = s == 0 ? 1 : 0;
  h.dpnw = plv[NW_OUT_LEADER];
  h.dlnw = s == 0 ? plv[NW_IN_LEADER] : 0.0f;
  h.topic_own = own;
  return p < 0 || broker < 0 || src == broker;
}

// acceptance.swap_tables_acceptance on the staged words: hot pick H leaving
// broker BH for BC, cold pick C the other way; tc1 = topic_count[t(H), BC],
// tc2 = topic_count[t(C), BH]. Every check is evaluated (the words are all
// loaded), so a cell is a chain of independent compares, not of branches.
__device__ __forceinline__ bool staged_tables_ok(int band_on, const PickHalf& H,
                                                 const BrokerWords& BH, const PickHalf& C,
                                                 const BrokerWords& BC, int tc1, int tc2) {
  bool ok = true;
  float d[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) d[r] = H.dload[r] - C.dload[r];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float dc = d[r], dh = -d[r];
    const float ac = BC.load[r] + dc, ah = BH.load[r] + dh;
    ok &= (!(dc > 0.0f) | (ac <= BC.hi_load[r])) & ((dc > 0.0f) | (ac >= BC.lo_load[r]));
    ok &= (!(dh > 0.0f) | (ah <= BH.hi_load[r])) & ((dh > 0.0f) | (ah >= BH.lo_load[r]));
    // band_move_acceptance, hot -> cold, no dead source
    const float s = BH.load[r], dd = BC.load[r], dr = d[r];
    const bool pos = dr >= 0.0f;
    const bool case1 = pos ? (s >= BH.band_lo[r]) & (dd <= BC.band_hi[r])
                           : (dd >= BC.band_lo[r]) & (s <= BH.band_hi[r]);
    const bool acc1 = pos ? (dd + dr <= BC.band_hi[r]) & (s - dr >= BH.band_lo[r])
                          : (s - dr <= BH.band_hi[r]) & (dd + dr >= BC.band_lo[r]);
    const float prev = s - dd;
    const bool acc2 = fabsf(prev - 2.0f * dr) < fabsf(prev);
    ok &= (case1 ? acc1 : acc2) | (dr == 0.0f) | !((band_on >> r) & 1);
  }
  const float dl = (float)(H.dleader - C.dleader);
  ok &= (dl <= 0.0f) | ((BC.lead + dl <= BC.hi_lead) & (BH.lead - dl >= BH.lo_lead));
  ok &= (dl >= 0.0f) | ((BH.lead - dl <= BH.hi_lead) & (BC.lead + dl >= BC.lo_lead));
  const float dpnw = H.dpnw - C.dpnw;
  ok &= (dpnw <= 0.0f) | (BC.pot + dpnw <= BC.hi_pnw);
  ok &= (dpnw >= 0.0f) | (BH.pot - dpnw <= BH.hi_pnw);
  const float dlnw = H.dlnw - C.dlnw;
  ok &= (dlnw <= 0.0f) | (BC.lnw + dlnw <= BC.hi_lnw);
  ok &= (dlnw >= 0.0f) | (BH.lnw - dlnw <= BH.hi_lnw);
  ok &= (H.t == C.t) | (((float)(tc1 + 1) <= H.hi_topic) & ((float)(H.topic_own - 1) >= H.lo_topic) &
                        ((float)(tc2 + 1) <= C.hi_topic) & ((float)(C.topic_own - 1) >= C.lo_topic));
  const float dcpu = d[RES_CPU];
  ok &= (BH.host == BC.host) | (((dcpu <= 0.0f) | (BC.host_cpu + dcpu <= BC.hi_host_cpu)) &
                                ((dcpu >= 0.0f) | (BH.host_cpu - dcpu <= BH.hi_host_cpu)));
  return ok;
}

// The staged words of a cell: hot pick H on broker BH against cold pick C on
// broker BC; x1 = (H, BC), x2 = (C, BH).
#define STAGED_CELL                                                                   \
  const PickHalf &H, const BrokerWords &BH, const PickHalf &C, const BrokerWords &BC, \
      const Cross &x1, const Cross &x2

// the masks, the rack check both ways and the end points' imbalance after
// the swap
__device__ __forceinline__ bool staged_common(STAGED_CELL, int res, float lo, float hi,
                                              int rack_on, float& h1, float& c1, float& delta) {
  delta = at4(H.dload, res) - at4(C.dload, res);
  h1 = imbalance(BH.u - delta / BH.cap, lo, hi);
  c1 = imbalance(BC.u + delta / BC.cap, lo, hi);
  const int same = BH.rack == BC.rack ? 1 : 0;
  bool ok = (H.p >= 0) & (C.p >= 0) & (BH.b >= 0) & (BC.b >= 0);
  ok &= (x1.holds == 0) & (x2.holds == 0);
  ok &= (!rack_on) | ((x1.rack - same == 0) & (x2.rack - same == 0));
  return ok;
}

// replica_swap's grid form (wave 0) from the staged words, its picks on BH
// and BC
__device__ __forceinline__ float grid_cell(STAGED_CELL, int res, float lo, float hi,
                                           bool active_ok, int rack_on, int band_on) {
  float h1, c1, delta;
  bool ok = staged_common(H, BH, C, BC, x1, x2, res, lo, hi, rack_on, h1, c1, delta);
  ok &= (h1 <= BH.imb0 + 1e-6f) & (c1 <= BC.imb0 + 1e-6f);
  ok &= (delta > 1e-6f) & (BH.b != BC.b) & (H.p != C.p) & active_ok;
  ok &= ((H.s != 0) | (BC.lead_ok != 0)) & ((C.s != 0) | (BH.lead_ok != 0));
  ok &= staged_tables_ok(band_on, H, BH, C, BC, x1.tc, x2.tc);
  // capacity and potential NW_OUT on both ends
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float net = H.dload[r] - C.dload[r];
    ok &= (BH.load[r] - net <= BH.lim[r]) & (BC.load[r] + net <= BC.lim[r]);
  }
  ok &= (BC.pot + H.dpnw - C.dpnw <= BC.pot_lim) & (BH.pot - H.dpnw + C.dpnw <= BH.pot_lim);
  return ok ? BH.imb0 + BC.imb0 - h1 - c1 : -INFINITY;
}

// replica_swap's wave form (wave 1): `cons` whether both picks are still on
// BH and BC, without which the cell is not ok (and the tables' words, read
// at BH and BC, would not be the legs' sources')
__device__ __forceinline__ float wave_cell(STAGED_CELL, bool cons, int res, float lo, float hi,
                                           int rack_on, int band_on) {
  float h1, c1, delta;
  bool ok = staged_common(H, BH, C, BC, x1, x2, res, lo, hi, rack_on, h1, c1, delta) & cons;
  const float improve = BH.imb0 + BC.imb0 - h1 - c1;
  ok &= (h1 <= BH.imb0 + 1e-6f) & (c1 <= BC.imb0 + 1e-6f) & (improve > 1e-6f);
  ok &= staged_tables_ok(band_on, H, BH, C, BC, x1.tc, x2.tc);
  return ok ? improve : -INFINITY;
}

// The cross words of pick h against broker words w (its row's hold of w
// comes with the pick)
__device__ __forceinline__ Cross cross(const ScoreCtx& c, int rack_on, const PickHalf& h,
                                       const BrokerWords& w, int holds) {
  const int pc = h.p < 0 ? 0 : h.p, oc = w.b < 0 ? 0 : w.b;
  return Cross{ld(c.topic_count + (long long)h.t * c.B + oc),
               ld(c.rack_count + (rack_on ? (long long)pc * c.NR + w.rack : 0)), holds};
}

__device__ __forceinline__ int at(const int* t, const long long st[5], const long long i[5]) {
  return t[i[0] * st[0] + i[1] * st[1] + i[2] * st[2] + i[3] * st[3] + i[4] * st[4]];
}

// One thread a cell. REPLICA: the replica swaps (the grid and the waves),
// every word loaded at once into registers, then the staged checks; else
// the topic swaps and the relays, in the reference's form.
template <bool REPLICA>
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
    if constexpr (REPLICA) {
      const ScoreCtx& c = g.c;
      const float lo = ld(c.w_lower), hi = ld(c.w_upper);
      const bool rack_on = ldb(c.rack_enabled);
      int band_on = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) band_on |= ldb(c.band_on + r) ? 1 << r : 0;
      BrokerWords BH, BC;
      PickHalf H, C;
      int holds1, holds2;
      load_broker(c, b, g.res, lo, hi, BH);
      load_broker(c, d, g.res, lo, hi, BC);
      const bool cons = load_pick(c, p1, s1, b, d, H, nullptr, holds1) &
                        load_pick(c, p2, s2, d, b, C, nullptr, holds2);
      const Cross x1 = cross(c, rack_on, H, BC, holds1), x2 = cross(c, rack_on, C, BH, holds2);
      if (g.wave) {
        out = wave_cell(H, BH, C, BC, x1, x2, cons, g.res, lo, hi, rack_on, band_on);
      } else if (cons) {
        out = grid_cell(H, BH, C, BC, x1, x2, g.res, lo, hi,
                        ldb(c.w_active) && !ldb(c.only_immigrants), rack_on, band_on);
      } else {
        out = replica_swap(c, g.res, 0, p1, s1, b, p2, s2, d);
      }
    } else if (g.kind == TOPIC_SWAP) {
      out = topic_swap(g.c, p1, s1, b, p2, s2, d);
    } else {
      out = relay(g.c, p1, s1, b, p2, s2, d);
    }
  }
  g.out[e] = out;
}

// hot picks whose cross words a thread loads at once
constexpr int SW_CHUNK = 4;

// The replica-swap grid [1, I, J, A, Bk]: block i * tiles + tile takes hot
// broker i against cold brokers tile * T .. + T - 1, a thread a cold pick at
// a time.
__global__ void __launch_bounds__(SW_THREADS, 2) k_swap_staged(SwapArgs g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ScoreCtx& c = g.c;
  const int J = (int)g.dims[2], A = (int)g.dims[3], Bk = (int)g.dims[4];
  const int T = g.tile, R = c.R, tid = threadIdx.x, tiles = (J + T - 1) / T;
  const int i = (int)(blockIdx.x / tiles), j0 = (int)(blockIdx.x % tiles) * T;
  const int n_cold = min(T, J - j0) * Bk;
  BrokerWords* sBH = reinterpret_cast<BrokerWords*>(smem);
  PickHalf* sH = reinterpret_cast<PickHalf*>(sBH + 1);  // [A]
  int* sRow = reinterpret_cast<int*>(sH + A);            // [A][R]
  int* sStray = sRow + A * R;                            // [A]
  const float lo = ld(c.w_lower), hi = ld(c.w_upper);
  const int hot = ld(g.b + i * g.st[2][1]);
  const bool rack_on = ldb(c.rack_enabled);
  int band_on = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) band_on |= ldb(c.band_on + r) ? 1 << r : 0;
  const bool active_ok = ldb(c.w_active) && !ldb(c.only_immigrants);

  // the thread's first cold pick, loaded while the hot side is staged
  PickHalf C;
  BrokerWords BC;
  int holds2 = 0;
  bool stray_c = false;
  auto load_cold = [&](int cp) {
    const int j = j0 + cp / Bk, b = cp % Bk;
    const int p = ld(g.p2 + j * g.st[3][2] + b * g.st[3][4]);
    const int s = ld(g.s2 + j * g.st[4][2] + b * g.st[4][4]);
    const int cold = ld(g.d + j * g.st[5][2]);
    load_broker(c, cold, g.res, lo, hi, BC);
    stray_c = !load_pick(c, p, s, cold, hot, C, nullptr, holds2);
  };
  if (tid < n_cold) load_cold(tid);
  // 1. the hot side, once a block
  for (int q = tid; q <= A; q += SW_THREADS) {
    if (q == A) {
      load_broker(c, hot, g.res, lo, hi, *sBH);
    } else {
      const int p = ld(g.p1 + i * g.st[0][1] + q * g.st[0][3]);
      const int s = ld(g.s1 + i * g.st[1][1] + q * g.st[1][3]);
      int unused;
      sStray[q] = load_pick(c, p, s, hot, -2, sH[q], sRow + q * R, unused) ? 0 : 1;
    }
  }
  __syncthreads();

  // 2. each thread's cold pick against every hot pick
  for (int cp = tid; cp < n_cold; cp += SW_THREADS) {
    if (cp != tid) load_cold(cp);
    const int j = j0 + cp / Bk, b = cp % Bk, cold_c = BC.b < 0 ? 0 : BC.b;
    const int pc = C.p < 0 ? 0 : C.p;
    const Cross x2{ld(c.topic_count + (long long)C.t * c.B + (hot < 0 ? 0 : hot)),
                   ld(c.rack_count + (rack_on ? (long long)pc * c.NR + sBH->rack : 0)), holds2};
    float* out = g.out + ((long long)i * J + j) * A * Bk + b;
    for (int a0 = 0; a0 < A; a0 += SW_CHUNK) {
      int tc1[SW_CHUNK], rk1[SW_CHUNK];
#pragma unroll
      for (int u = 0; u < SW_CHUNK; ++u) {
        const PickHalf& H = sH[min(a0 + u, A - 1)];
        const int hp = H.p < 0 ? 0 : H.p;
        tc1[u] = ld(c.topic_count + (long long)H.t * c.B + cold_c);
        rk1[u] = ld(c.rack_count + (rack_on ? (long long)hp * c.NR + BC.rack : 0));
      }
#pragma unroll
      for (int u = 0; u < SW_CHUNK; ++u) {
        const int a = a0 + u;
        if (a >= A) break;
        const PickHalf& H = sH[a];
        float v;
        if (sStray[a] || stray_c) {
          v = -INFINITY;
          if (H.p >= 0 && C.p >= 0 && hot >= 0 && BC.b >= 0)
            v = replica_swap(c, g.res, 0, H.p, H.s, hot, C.p, C.s, BC.b);
        } else {
          int holds1 = 0;
          for (int q = 0; q < R; ++q) holds1 |= sRow[a * R + q] == BC.b ? 1 : 0;
          v = grid_cell(H, *sBH, C, BC, Cross{tc1[u], rk1[u], holds1}, x2, g.res, lo, hi,
                        active_ok, rack_on, band_on);
        }
        out[(long long)a * Bk] = v;
      }
    }
  }
}

constexpr int SW_MAX_DEVICES = 64;

// ctx: the round's score context (host memory, read here); out f32[numel];
// the six index tensors i32; layout (host): d0..d4, the strides of p1, s1,
// b, p2, s2, d (5 each), kind, resource, wave, path. The staged path needs
// the replica-swap grid's layout (kernels/score_swaps.py choose_path).
CC_EXPORT int score_swaps(const ScoreCtx* ctx, float* out, const int* p1, const int* s1,
                          const int* b, const int* p2, const int* s2, const int* d,
                          const long long* layout, cudaStream_t stream) {
  SwapArgs g;
  g.c = *ctx;
  g.out = out;
  g.p1 = p1;
  g.s1 = s1;
  g.b = b;
  g.p2 = p2;
  g.s2 = s2;
  g.d = d;
  int q = 0;
  g.numel = 1;
  for (int j = 0; j < 5; ++j) {
    g.dims[j] = layout[q++];
    g.numel *= g.dims[j];
  }
  for (int t = 0; t < 6; ++t)
    for (int j = 0; j < 5; ++j) g.st[t][j] = layout[q++];
  g.kind = (int)layout[q++];
  g.res = (int)layout[q++];
  g.wave = (int)layout[q++];
  const int path = (int)layout[q++];
  if (g.numel == 0) return cudaSuccess;
  if (g.kind < REPLICA_SWAP || g.kind > LEADERSHIP_RELAY || g.res < 0 || g.res > 3)
    return cudaErrorInvalidValue;
  if (path == PATH_STAGED) {
    const long long A = g.dims[3], Bk = g.dims[4], J = g.dims[2];
    if (g.kind != REPLICA_SWAP || g.wave || g.dims[0] != 1 || g.dims[1] > 0x7fffffffLL)
      return cudaErrorInvalidValue;
    // the current device's SM count and shared-memory attribute
    static int sms[SW_MAX_DEVICES];
    static size_t smem_set[SW_MAX_DEVICES];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= SW_MAX_DEVICES) return cudaErrorInvalidDevice;
    if (sms[dev] == 0) {
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return e;
    }
    // a tile of as many cold brokers as give each thread a cold pick; two
    // where that makes more blocks than run at once (two an SM): fewer,
    // larger blocks then (scripts/kernel_variants.py measured one, two and
    // four on an H100)
    const long long T1 = SW_THREADS / Bk > 0 ? SW_THREADS / Bk : 1;
    long long T = g.dims[1] * ((J + T1 - 1) / T1) > 2LL * sms[dev] ? 2 * T1 : T1;
    if (T > J) T = J;
    g.tile = (int)T;
    const size_t smem = staged_bytes((int)A, g.c.R);
    if (smem > 48 * 1024) {
      if (smem_set[dev] < smem) {
        e = cudaFuncSetAttribute(k_swap_staged, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
        if (e != cudaSuccess) return e;
        smem_set[dev] = smem;
      }
    }
    const long long blocks = g.dims[1] * ((J + T - 1) / T);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    k_swap_staged<<<(unsigned)blocks, SW_THREADS, smem, stream>>>(g);
    return cudaGetLastError();
  }
  if (path != PATH_CELLS) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((g.numel + 255) / 256);
  if (g.kind == REPLICA_SWAP) k_score_swaps<true><<<blocks, 256, 0, stream>>>(g);
  else k_score_swaps<false><<<blocks, 256, 0, stream>>>(g);
  return cudaGetLastError();
}
