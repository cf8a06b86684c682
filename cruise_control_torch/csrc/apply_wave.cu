// K4 apply_wave: select a conflict-free subset of one wave of scored actions
// and apply it to the assignment, every aggregate and the touch tags. An
// entry is one action, or a coupled pair of actions (a swap or a leadership
// relay) applied as two legs.
//
// Replaces: cruise_control_tpu/analyzer/context.py wave_select (:425) followed
// by apply_actions_batch (:525), with the actions materialized as
// actions.build_selected (:189) does; for swaps and relays, the two
// apply_actions_batch calls of swaps.py:293-298, drain.py:610-615 and
// drain.py:862-867.
//
// Bound on this card: latency. A wave on the main path holds at most a few
// thousand entries (the bulk planner's waves hold one per broker, 3,072 on
// the bucketed smoke model; a drain wave 512 nominations + 512 promotions);
// its bytes are a few hundred KB at most. What costs is the launch and the
// chain of dependent stages, each a round of shared-memory atomics ended by a
// barrier.
//
// The first design ran every selection stage as an O(N^2) pairwise
// scan over shared memory in one block, and one thread applied the host-CPU
// updates of the whole wave: 4.0 ms for a 2,600-entry two-leg relay wave and
// 0.33 ms for a 1,024-entry drain wave on an H100, 48% of the device's busy
// time in the service solve. Stamped with clock64() (scripts/k4_stage_split.py),
// the relay wave's 4.0 ms went 89% to the five pairwise stages, 10% to
// thread 0's serial host-CPU passes and 1% to the claims and the apply
// (PERF.md). This design keeps one block of 1,024 threads (each stage is a
// few shared-memory atomics per entry at N <= 4,096, about a microsecond:
// too little work to spread over a cluster) and makes every stage O(N).
// Two launch configurations of it, chosen by size:
//   - block (k_apply_wave): N <= 4,096 entries (up to four a thread, in
//     registers) and max(B, H) <= 8,192 groups: entries and the broker and
//     host tables in shared memory, as below;
//   - wide (k_apply_wave_wide): any other size. The same stages in the same
//     order, each thread looping over entries i = tid, tid + 1,024, ...
//     whose per-entry words live in a global scratch; every table (brokers,
//     hosts, partitions) in the global workspace, reset slot by slot; the
//     host-CPU subtractions always through the sort, tile by tile of 4,096
//     entries (64-bit keys of (source host, entry in the tile)), the tiles
//     in entry order, so a host's run still subtracts in entry order.
// The block configuration:
//   - Each stage of wave_select is one unique_per_group (context.py:460) over
//     a per-group table: an atomicMax of an order-preserving uint32 key of
//     the entry's score into every group it claims, a barrier, the float
//     compare s >= max at each claim (so -0.0 and +0.0 tie, and a NaN score
//     poisons its groups as the reference's scatter-max does), an atomicMin
//     of the index of the entries that pass, a barrier, and the entry
//     survives iff it holds the minimum at every claim. The stages run in the
//     reference's order: brokers over (src, dst) among the valid entries
//     (its gmax / imin stages), brokers over (src, dst, third broker) for
//     relays, destination hosts, partitions. The max and the min are not
//     folded into one 64-bit (score, ~index) max: an equal-score entry of a
//     lower index that is not a candidate (it loses its other broker) would
//     then shadow the one the reference selects.
//   - Broker and host tables live in shared memory (max(B, H) <= 8,192 slots
//     of two words). The partition table does not fit (212,992 partitions on
//     the bucketed smoke model): it is a global workspace of [2, P] words that
//     the wrapper allocates once at the sentinels, and each stage resets
//     exactly the slots its entries touched before the block moves on, so no
//     table costs an O(B) or O(P) clear from the host.
//   - The selected entries are then broker-, host- and partition-disjoint, so
//     each thread applies its own entries with plain loads and stores (for
//     two legs this needs leg 2 to leave the broker leg 1 enters, as every
//     swap and relay does; the claims cover no other broker): leg 1, then
//     leg 2, both built from the pre-wave assignment (an entry's two rows are
//     its own). A broker shared by an entry's two legs (a swap's ends, a
//     relay's e == b) thus takes (x + leg1) + leg2, rounded twice as in the
//     reference.
//   - host_cpu_load is the one aggregate whose source hosts may repeat in a
//     wave. The phases run as the reference's scatter-adds do, with a
//     barrier between them: leg 1's subtractions, leg 1's additions
//     (destination hosts are unique in a wave), then leg 2's likewise. Where
//     no source host repeats within a leg (one broker a host, as on the
//     generated clusters), each entry subtracts its own; else a stable block
//     radix sort (CUB) orders the selected entries by (leg, source host) and
//     one thread per run subtracts its run in entry order. Hosts run in
//     parallel; the bits equal the sequential order.
// Entries whose flag is set but whose action is not valid (an empty slot, src
// == dst, or a destination outside the brokers) are treated as unflagged; the
// scoring kernels never give such an entry a finite score, so the reference
// never flags one.
#include <cub/block/block_radix_sort.cuh>

#include "common.cuh"

// the block configuration's most entries and groups (brokers or hosts)
#define BLOCK_N 4096
#define BLOCK_GROUPS 8192
#define THREADS 1024
// the entries a thread owns: i = threadIdx.x + k * THREADS
#define PER_THREAD (BLOCK_N / THREADS)
#define SMEM_LIMIT 232448
// a u16 claim that is not there (one leg, no third broker)
#define NO_CLAIM 0xFFFFu
// table sentinels: below every score's key, above every index
#define KEY_NONE 0u
#define IDX_NONE 0x7FFFFFFF
// host_cpu sort keys: leg << 26 | source host << 12 | entry; the sort orders
// bits 12-26 (stable, so entries stay in index order within a run)
#define SORT_ITEMS (2 * BLOCK_N / THREADS)
#define HOST_NONE 0x3FFFu
#define RUN(key) ((key) >> 12)

typedef cub::BlockRadixSort<unsigned, THREADS, SORT_ITEMS> HostSort;

struct WaveArgs {
  const int *p, *kind, *slot, *dst;
  const int *p2, *kind2, *slot2, *dst2;
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
  unsigned* part_key;  // the partition workspace: [P] score keys, then [P] indices
  int* part_idx;
  int n, R, NR, B, tag, legs, brokers3, groups;
};

// Dynamic shared memory, three regions:
//   selection (dead once the selection is made; the host sort's storage and
//     its sorted keys reuse it): score, q1, q2, src, dst, b3;
//   tables: [groups] score keys and [groups] indices;
//   apply: dc1, dc2, h1, h2, hs1, hs2, sel.
struct Shared {
  float* score;
  int *q1, *q2;
  unsigned short *src, *dst, *b3;
  unsigned char* sort_storage;
  unsigned* sorted;
  unsigned* tkey;
  int* tidx;
  float *dc1, *dc2;
  unsigned short *h1, *h2, *hs1, *hs2;
  unsigned char* sel;
};

__host__ __device__ __forceinline__ size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

__host__ __device__ __forceinline__ size_t selection_bytes(int n) {
  size_t entries = (size_t)n * (3 * 4 + 3 * 2);
  size_t sort = sizeof(HostSort::TempStorage);
  return align16(entries > sort ? entries : sort);
}

__host__ __device__ __forceinline__ size_t smem_bytes(int n, int groups) {
  return selection_bytes(n) + align16((size_t)groups * 8) + align16((size_t)n * (2 * 4 + 4 * 2 + 1));
}

__device__ __forceinline__ Shared carve(unsigned char* base, int n, int groups) {
  Shared s;
  s.score = (float*)base;
  s.q1 = (int*)(s.score + n);
  s.q2 = s.q1 + n;
  s.src = (unsigned short*)(s.q2 + n);
  s.dst = s.src + n;
  s.b3 = s.dst + n;
  s.sort_storage = base;
  s.sorted = (unsigned*)base;
  unsigned char* t = base + selection_bytes(n);
  s.tkey = (unsigned*)t;
  s.tidx = (int*)(s.tkey + groups);
  unsigned char* a = t + align16((size_t)groups * 8);
  s.dc1 = (float*)a;
  s.dc2 = s.dc1 + n;
  s.h1 = (unsigned short*)(s.dc2 + n);
  s.h2 = s.h1 + n;
  s.hs1 = s.h2 + n;
  s.hs2 = s.hs1 + n;
  s.sel = (unsigned char*)(s.hs2 + n);
  return s;
}

// order-preserving key of a float (a NaN above every other value)
__device__ __forceinline__ unsigned score_key(float f) {
  if (f != f) return 0xFFFFFFFFu;
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned k) {
  if (k == 0xFFFFFFFFu) return __uint_as_float(0x7FC00000u);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// the partition table is read past L1, where its atomics land
template <bool GLOBAL, typename T>
__device__ __forceinline__ T read_slot(const T* p) {
  if constexpr (GLOBAL) return __ldcg(p);
  else return *p;
}

// unique_per_group (context.py:460) over the C claims claim(i, c) (-1 = none)
// of the entries in `keep`, which it narrows: an entry survives iff its score
// is >= the best score in every group it claims and its index is the lowest
// among the entries that pass that test in every group. The tables are at
// their sentinels on entry and again on return.
template <int C, bool GLOBAL, typename Claim>
__device__ __forceinline__ void unique_per_group(bool keep[PER_THREAD], const float* score, Claim claim, int n,
                                 unsigned* tkey, int* tidx) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = tid + k * THREADS;
    if (i >= n || !keep[k]) continue;
    const unsigned key = score_key(score[i]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int g = claim(i, c);
      if (g >= 0) atomicMax(&tkey[g], key);
    }
  }
  __syncthreads();
  bool best[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = tid + k * THREADS;
    best[k] = i < n && keep[k];
    if (!best[k]) continue;
    const float s = score[i];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int g = claim(i, c);
      if (g >= 0 && !(s >= key_score(read_slot<GLOBAL>(&tkey[g])))) best[k] = false;
    }
    if (!best[k]) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int g = claim(i, c);
      if (g >= 0) atomicMin(&tidx[g], i);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = tid + k * THREADS;
    if (!best[k]) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int g = claim(i, c);
      if (g >= 0 && read_slot<GLOBAL>(&tidx[g]) != i) best[k] = false;
    }
  }
  __syncthreads();
  // reset exactly the slots this stage touched
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = tid + k * THREADS;
    if (i < n && keep[k]) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int g = claim(i, c);
        if (g < 0) continue;
        if constexpr (GLOBAL) {
          __stcg(&tkey[g], KEY_NONE);
          __stcg(&tidx[g], IDX_NONE);
        } else {
          tkey[g] = KEY_NONE;
          tidx[g] = IDX_NONE;
        }
      }
    }
    keep[k] = best[k];
  }
  __syncthreads();
}

__device__ __forceinline__ int claim16(const unsigned short* a, int i) {
  return a[i] == NO_CLAIM ? -1 : (int)a[i];
}

__device__ void apply_action(const WaveArgs& w, const Action& act) {
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

// One leg's subtractions of the selected entries' CPU loads from their
// source hosts: each entry its own where no host repeats, else one thread
// per run of the sorted (leg, source host) keys, in entry order.
__device__ __forceinline__ void subtract_sources(const WaveArgs& w, const Shared& s,
                                                 const bool keep[PER_THREAD], unsigned leg,
                                                 const unsigned short* hs, const float* dc,
                                                 bool sorted) {
  if (!sorted) {
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int i = threadIdx.x + k * THREADS;
      if (i < w.n && keep[k]) w.host_cpu[hs[i]] = w.host_cpu[hs[i]] - dc[i];
    }
    return;
  }
  const int m = 2 * w.n;
  for (int r = threadIdx.x; r < m; r += THREADS) {
    const unsigned key = s.sorted[r];
    const unsigned host = (key >> 12) & HOST_NONE;
    if ((key >> 26) != leg || host == HOST_NONE) continue;
    if (r > 0 && RUN(s.sorted[r - 1]) == RUN(key)) continue;
    float x = w.host_cpu[host];
    for (int q = r; q < m && RUN(s.sorted[q]) == RUN(key); ++q) x = x - dc[s.sorted[q] & 0xFFFu];
    w.host_cpu[host] = x;
  }
}

__global__ void __launch_bounds__(THREADS) k_apply_wave(WaveArgs w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = w.n, tid = threadIdx.x;
  const bool two = w.legs == 2;
  Shared s = carve(smem, n, w.groups);

  for (int g = tid; g < w.groups; g += THREADS) {
    s.tkey[g] = KEY_NONE;
    s.tidx[g] = IDX_NONE;
  }
  // claims of every entry, from the pre-wave assignment
  bool keep[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = tid + k * THREADS;
    keep[k] = false;
    if (i >= n) continue;
    bool v = w.ok[i] && w.p[i] >= 0 && (!two || w.p2[i] >= 0);
    Action a1, a2;
    if (v) {
      a1 = build_action(w.assignment, w.R, w.part_load, w.p[i], w.kind[i], w.slot[i], w.dst[i]);
      v = a1.valid && a1.dst < w.B;
    }
    if (v && two) {
      a2 = build_action(w.assignment, w.R, w.part_load, w.p2[i], w.kind2[i], w.slot2[i], w.dst2[i]);
      v = a2.valid && a2.dst < w.B;
    }
    keep[k] = v;
    if (!v) continue;
    s.score[i] = w.score[i];
    s.src[i] = (unsigned short)a1.src;
    s.dst[i] = (unsigned short)a1.dst;
    s.b3[i] = w.brokers3 ? (unsigned short)a2.dst : NO_CLAIM;
    s.h1[i] = (unsigned short)w.broker_host[a1.dst];
    s.h2[i] = two ? (unsigned short)w.broker_host[a2.dst] : NO_CLAIM;
    s.hs1[i] = (unsigned short)w.broker_host[a1.src];
    s.hs2[i] = two ? (unsigned short)w.broker_host[a2.src] : NO_CLAIM;
    s.q1[i] = a1.p;
    s.q2[i] = two ? a2.p : -1;
    s.dc1[i] = a1.dload[RES_CPU];
    s.dc2[i] = two ? a2.dload[RES_CPU] : 0.0f;
  }
  __syncthreads();

  // the stages of wave_select, in the reference's order
  unique_per_group<2, false>(keep, s.score, [&](int i, int c) {
    return (int)(c == 0 ? s.src[i] : s.dst[i]); }, n, s.tkey, s.tidx);
  if (w.brokers3)
    unique_per_group<3, false>(keep, s.score, [&](int i, int c) {
      return (int)(c == 0 ? s.src[i] : (c == 1 ? s.dst[i] : s.b3[i])); }, n, s.tkey, s.tidx);
  unique_per_group<2, false>(keep, s.score, [&](int i, int c) {
    return claim16(c == 0 ? s.h1 : s.h2, i); }, n, s.tkey, s.tidx);
  unique_per_group<2, true>(keep, s.score, [&](int i, int c) {
    return c == 0 ? s.q1[i] : s.q2[i]; }, n, w.part_key, w.part_idx);

  // apply the selected entries, and count them by source host (leg 1 in
  // the low half of the word, leg 2 in the high half; the table is at 0)
  bool any = false;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = tid + k * THREADS;
    if (i >= n) continue;
    w.sel_out[i] = keep[k];
    s.sel[i] = keep[k];
    if (!keep[k]) continue;
    any = true;
    // an entry's rows are its own (partition claims), so rebuilding its
    // legs now reads the pre-wave rows even while other entries apply
    Action a1 = build_action(w.assignment, w.R, w.part_load, w.p[i], w.kind[i], w.slot[i], w.dst[i]);
    Action a2;
    if (two)
      a2 = build_action(w.assignment, w.R, w.part_load, w.p2[i], w.kind2[i], w.slot2[i], w.dst2[i]);
    apply_action(w, a1);
    if (two) apply_action(w, a2);
    atomicAdd(&s.tkey[s.hs1[i]], 1u);
    if (two) atomicAdd(&s.tkey[s.hs2[i]], 1u << 16);
  }
  if (!__syncthreads_or(any)) return;

  // host_cpu_load. Where no source host repeats within a leg (one broker a
  // host, as the generated clusters have), each entry subtracts its own;
  // else the selected entries are sorted by (leg, source host) and one
  // thread per run subtracts the run in entry order.
  bool repeat = false;
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = tid + k * THREADS;
    if (i < n && keep[k])
      repeat = repeat || (s.tkey[s.hs1[i]] & 0xFFFFu) > 1 || (two && (s.tkey[s.hs2[i]] >> 16) > 1);
  }
  const bool sorted = __syncthreads_or(repeat);
  if (sorted) {
    unsigned keys[SORT_ITEMS];
#pragma unroll
    for (int j = 0; j < SORT_ITEMS; ++j) {
      const int r = tid * SORT_ITEMS + j;
      const unsigned leg = r >= n ? 1u : 0u;
      const int i = r - (int)leg * n;
      unsigned host = HOST_NONE;
      if (r < 2 * n && (!leg || two) && s.sel[i]) host = leg ? s.hs2[i] : s.hs1[i];
      keys[j] = r < 2 * n ? (leg << 26) | (host << 12) | (unsigned)i : 0xFFFFFFFFu;
    }
    HostSort(*reinterpret_cast<HostSort::TempStorage*>(s.sort_storage)).Sort(keys, 12, 27);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < SORT_ITEMS; ++j) {
      const int r = tid * SORT_ITEMS + j;
      if (r < 2 * n) s.sorted[r] = keys[j];
    }
    __syncthreads();
  }
  subtract_sources(w, s, keep, 0, s.hs1, s.dc1, sorted);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = tid + k * THREADS;
    if (i < n && keep[k]) w.host_cpu[s.h1[i]] = w.host_cpu[s.h1[i]] + s.dc1[i];
  }
  if (!two) return;
  __syncthreads();
  subtract_sources(w, s, keep, 1, s.hs2, s.dc2, sorted);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = tid + k * THREADS;
    if (i < n && keep[k]) w.host_cpu[s.h2[i]] = w.host_cpu[s.h2[i]] + s.dc2[i];
  }
}

// -- the wide configuration ----------------------------------------------------

// entries of one host-sort tile, and the keys a thread sorts
#define WIDE_TILE 4096
#define WIDE_ITEMS (WIDE_TILE / THREADS)
typedef cub::BlockRadixSort<unsigned long long, THREADS, WIDE_ITEMS> WideSort;

// The wide configuration's per-entry words, in the global scratch (claims
// -1 where there is none; keep and best the per-stage flags, each entry's
// own thread the only one to touch them).
struct WideEntries {
  float *score, *dc1, *dc2;
  int *q1, *q2, *src, *dst, *b3, *h1, *h2, *hs1, *hs2;
  unsigned char *keep, *best;
};

__host__ __device__ __forceinline__ size_t wide_scratch_bytes(long long n) {
  return (size_t)n * (12 * 4 + 2);
}

__device__ __forceinline__ WideEntries wide_carve(unsigned char* base, int n) {
  WideEntries e;
  float* f = reinterpret_cast<float*>(base);
  e.score = f;
  e.dc1 = f + n;
  e.dc2 = f + 2 * (size_t)n;
  int* q = reinterpret_cast<int*>(f + 3 * (size_t)n);
  e.q1 = q;
  e.q2 = q + n;
  e.src = q + 2 * (size_t)n;
  e.dst = q + 3 * (size_t)n;
  e.b3 = q + 4 * (size_t)n;
  e.h1 = q + 5 * (size_t)n;
  e.h2 = q + 6 * (size_t)n;
  e.hs1 = q + 7 * (size_t)n;
  e.hs2 = q + 8 * (size_t)n;
  e.keep = reinterpret_cast<unsigned char*>(q + 9 * (size_t)n);
  e.best = e.keep + n;
  return e;
}

// unique_per_group over the global tables, each thread looping over its
// entries; the same three phases, the same compares, the same resets
template <int C, typename Claim>
__device__ __forceinline__ void unique_per_group_wide(const WideEntries& e, Claim claim, int n,
                                                      unsigned* tkey, int* tidx) {
  const int tid = threadIdx.x;
  for (int i = tid; i < n; i += THREADS) {
    if (!e.keep[i]) continue;
    const unsigned key = score_key(e.score[i]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int g = claim(i, c);
      if (g >= 0) atomicMax(&tkey[g], key);
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += THREADS) {
    bool best = e.keep[i];
    if (best) {
      const float s = e.score[i];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int g = claim(i, c);
        if (g >= 0 && !(s >= key_score(__ldcg(&tkey[g])))) best = false;
      }
      if (best) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int g = claim(i, c);
          if (g >= 0) atomicMin(&tidx[g], i);
        }
      }
    }
    e.best[i] = best;
  }
  __syncthreads();
  for (int i = tid; i < n; i += THREADS) {
    if (!e.best[i]) continue;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int g = claim(i, c);
      if (g >= 0 && __ldcg(&tidx[g]) != i) e.best[i] = false;
    }
  }
  __syncthreads();
  for (int i = tid; i < n; i += THREADS) {
    if (e.keep[i]) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int g = claim(i, c);
        if (g < 0) continue;
        __stcg(&tkey[g], KEY_NONE);
        __stcg(&tidx[g], IDX_NONE);
      }
    }
    e.keep[i] = e.best[i];
  }
  __syncthreads();
}

// One leg's subtractions of the selected entries' CPU loads from their
// source hosts, tile by tile of WIDE_TILE entries: the tile's entries sorted
// by source host (stable), one thread per run subtracting it in entry order.
// `none` (the host count) marks an entry of no run; `bits` holds it.
__device__ void subtract_sources_wide(const WaveArgs& w, const WideEntries& e, const int* hs,
                                      const float* dc, unsigned long long none, int bits,
                                      unsigned char* smem) {
  WideSort::TempStorage& tmp = *reinterpret_cast<WideSort::TempStorage*>(smem);
  unsigned long long* sorted =
      reinterpret_cast<unsigned long long*>(smem + align16(sizeof(WideSort::TempStorage)));
  for (int t0 = 0; t0 < w.n; t0 += WIDE_TILE) {
    unsigned long long keys[WIDE_ITEMS];
#pragma unroll
    for (int j = 0; j < WIDE_ITEMS; ++j) {
      const int r = threadIdx.x * WIDE_ITEMS + j, i = t0 + r;
      const unsigned long long host = i < w.n && e.keep[i] ? (unsigned long long)hs[i] : none;
      keys[j] = (host << 12) | (unsigned long long)r;
    }
    WideSort(tmp).Sort(keys, 12, 12 + bits);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < WIDE_ITEMS; ++j) sorted[threadIdx.x * WIDE_ITEMS + j] = keys[j];
    __syncthreads();
    for (int r = threadIdx.x; r < WIDE_TILE; r += THREADS) {
      const unsigned long long host = sorted[r] >> 12;
      if (host == none || (r > 0 && (sorted[r - 1] >> 12) == host)) continue;
      float x = w.host_cpu[host];
      for (int q = r; q < WIDE_TILE && (sorted[q] >> 12) == host; ++q)
        x = x - dc[t0 + (int)(sorted[q] & 0xFFFull)];
      w.host_cpu[host] = x;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS) k_apply_wave_wide(WaveArgs w, unsigned char* scratch,
                                                             int hosts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = w.n, tid = threadIdx.x;
  const bool two = w.legs == 2;
  const WideEntries e = wide_carve(scratch, n);
  unsigned* tkey = w.part_key;
  int* tidx = w.part_idx;

  // claims of every entry, from the pre-wave assignment
  for (int i = tid; i < n; i += THREADS) {
    bool v = w.ok[i] && w.p[i] >= 0 && (!two || w.p2[i] >= 0);
    Action a1, a2;
    if (v) {
      a1 = build_action(w.assignment, w.R, w.part_load, w.p[i], w.kind[i], w.slot[i], w.dst[i]);
      v = a1.valid && a1.dst < w.B;
    }
    if (v && two) {
      a2 = build_action(w.assignment, w.R, w.part_load, w.p2[i], w.kind2[i], w.slot2[i], w.dst2[i]);
      v = a2.valid && a2.dst < w.B;
    }
    e.keep[i] = v;
    if (!v) continue;
    e.score[i] = w.score[i];
    e.src[i] = a1.src;
    e.dst[i] = a1.dst;
    e.b3[i] = w.brokers3 ? a2.dst : -1;
    e.h1[i] = w.broker_host[a1.dst];
    e.h2[i] = two ? w.broker_host[a2.dst] : -1;
    e.hs1[i] = w.broker_host[a1.src];
    e.hs2[i] = two ? w.broker_host[a2.src] : -1;
    e.q1[i] = a1.p;
    e.q2[i] = two ? a2.p : -1;
    e.dc1[i] = a1.dload[RES_CPU];
    e.dc2[i] = two ? a2.dload[RES_CPU] : 0.0f;
  }
  __syncthreads();

  // the stages of wave_select, in the reference's order
  unique_per_group_wide<2>(e, [&](int i, int c) { return c == 0 ? e.src[i] : e.dst[i]; }, n,
                           tkey, tidx);
  if (w.brokers3)
    unique_per_group_wide<3>(e, [&](int i, int c) {
      return c == 0 ? e.src[i] : (c == 1 ? e.dst[i] : e.b3[i]); }, n, tkey, tidx);
  unique_per_group_wide<2>(e, [&](int i, int c) { return c == 0 ? e.h1[i] : e.h2[i]; }, n,
                           tkey, tidx);
  unique_per_group_wide<2>(e, [&](int i, int c) { return c == 0 ? e.q1[i] : e.q2[i]; }, n,
                           tkey, tidx);

  // apply the selected entries
  bool any = false;
  for (int i = tid; i < n; i += THREADS) {
    w.sel_out[i] = e.keep[i];
    if (!e.keep[i]) continue;
    any = true;
    Action a1 = build_action(w.assignment, w.R, w.part_load, w.p[i], w.kind[i], w.slot[i], w.dst[i]);
    Action a2;
    if (two)
      a2 = build_action(w.assignment, w.R, w.part_load, w.p2[i], w.kind2[i], w.slot2[i], w.dst2[i]);
    apply_action(w, a1);
    if (two) apply_action(w, a2);
  }
  if (!__syncthreads_or(any)) return;

  // host_cpu_load: leg 1's subtractions, leg 1's additions, then leg 2's
  int bits = 1;
  while (bits < 52 && (1ull << bits) <= (unsigned long long)hosts) ++bits;
  const unsigned long long none = (unsigned long long)hosts;
  subtract_sources_wide(w, e, e.hs1, e.dc1, none, bits, smem);
  for (int i = tid; i < n; i += THREADS)
    if (e.keep[i]) w.host_cpu[e.h1[i]] = w.host_cpu[e.h1[i]] + e.dc1[i];
  if (!two) return;
  __syncthreads();
  subtract_sources_wide(w, e, e.hs2, e.dc2, none, bits, smem);
  for (int i = tid; i < n; i += THREADS)
    if (e.keep[i]) w.host_cpu[e.h2[i]] = w.host_cpu[e.h2[i]] + e.dc2[i];
}

// p, kind, slot, dst, p2, kind2, slot2, dst2 (i32[N]; leg 2 ignored when
// legs == 1), score f32[N], ok u8[N], sel_out u8[N], assignment, part_load,
// topic_id, broker_rack, broker_host, broker_load, replica_count,
// leader_count, potential, leader_nw_in, rack_count, topic_count, host_cpu,
// touch_tag, workspace i32[2, ws_row >= max(P, B, H)] (score keys, then
// indices; at 0 and INT32_MAX, as the kernel leaves it), scratch (the wide
// configuration's, wide_scratch_bytes(N) bytes; unused by the block
// configuration: kernels/apply_wave.py sizes it from the same limits,
// BLOCK_ENTRIES and BLOCK_GROUPS); then N, R, NR, B, tag, legs (1 or 2),
// brokers3 (0 or 1), H and ws_row
CC_EXPORT int apply_wave(const void* p, const void* kind, const void* slot, const void* dst,
                         const void* p2, const void* kind2, const void* slot2, const void* dst2,
                         const void* score, const void* ok, void* sel_out, void* assignment,
                         const void* part_load, const void* topic_id, const void* broker_rack,
                         const void* broker_host, void* broker_load, void* replica_count,
                         void* leader_count, void* potential, void* leader_nw_in,
                         void* rack_count, void* topic_count, void* host_cpu, void* touch_tag,
                         void* workspace, void* scratch_ptr, long long n, long long R,
                         long long NR, long long B, long long tag, long long legs,
                         long long brokers3, long long hosts, long long ws_row,
                         cudaStream_t stream) {
  WaveArgs w;
  w.p = (const int*)p;
  w.kind = (const int*)kind;
  w.slot = (const int*)slot;
  w.dst = (const int*)dst;
  w.p2 = (const int*)p2;
  w.kind2 = (const int*)kind2;
  w.slot2 = (const int*)slot2;
  w.dst2 = (const int*)dst2;
  w.score = (const float*)score;
  w.ok = (const unsigned char*)ok;
  w.sel_out = (unsigned char*)sel_out;
  w.assignment = (int*)assignment;
  w.part_load = (const float*)part_load;
  w.topic_id = (const int*)topic_id;
  w.broker_rack = (const int*)broker_rack;
  w.broker_host = (const int*)broker_host;
  w.broker_load = (float*)broker_load;
  w.replica_count = (int*)replica_count;
  w.leader_count = (int*)leader_count;
  w.potential = (float*)potential;
  w.leader_nw_in = (float*)leader_nw_in;
  w.rack_count = (int*)rack_count;
  w.topic_count = (int*)topic_count;
  w.host_cpu = (float*)host_cpu;
  w.touch_tag = (int*)touch_tag;
  w.part_key = (unsigned*)workspace;
  unsigned char* scratch = (unsigned char*)scratch_ptr;
  w.R = (int)R;
  w.NR = (int)NR;
  w.B = (int)B;
  w.tag = (int)tag;
  w.legs = (int)legs;
  w.brokers3 = (int)brokers3;
  w.part_idx = (int*)(w.part_key + ws_row);
  const long long groups = w.B > hosts ? w.B : hosts;
  if (n <= 0) return cudaSuccess;
  if (n >= 0x7FFFFFFFLL || w.legs < 1 || w.legs > 2 || (w.brokers3 && w.legs != 2) ||
      groups > ws_row || hosts > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  w.n = (int)n;
  w.groups = (int)groups;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e =
        cudaFuncSetAttribute(k_apply_wave, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(k_apply_wave_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  if (n <= BLOCK_N && groups <= BLOCK_GROUPS) {
    const size_t smem = smem_bytes(w.n, w.groups);
    if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
    k_apply_wave<<<1, THREADS, smem, stream>>>(w);
    return cudaGetLastError();
  }
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const size_t smem = align16(sizeof(WideSort::TempStorage)) + WIDE_TILE * sizeof(unsigned long long);
  k_apply_wave_wide<<<1, THREADS, smem, stream>>>(w, scratch, (int)hosts);
  return cudaGetLastError();
}
