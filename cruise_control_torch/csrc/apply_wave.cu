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
// Bound on this card: latency. A wave holds at most 4,096 entries (the bulk
// planner's waves hold one per broker, 2,600 on the smoke model; a drain wave
// 512 nominations + 512 promotions); the bytes are a few hundred KB at most
// and the pairwise selection about 6 x N^2 = 40M shared-memory compares at
// N = 2,600, tens of microseconds spread over one block. What costs is the
// launch, the dependent stages with their barriers, and the one thread that
// applies the host-CPU updates in order.
//
// Design: one block of up to 1,024 threads; each thread owns entries i,
// i + blockDim, ... (up to four). The entries' claims live in dynamic shared
// memory (50 bytes an entry, 200 KB at 4,096), and the stages of wave_select
// run in the reference's order with __syncthreads() between them, each as
// O(N^2) pairwise compares: no table sized by B, H or P, nothing to clear
// between waves, and no atomics whose order would matter. Per-group tables
// with order-preserving atomics (scatter-max of the score bits, scatter-min of
// the index) would be O(N); at these N the pairwise form is simpler and its
// time is not what bounds the round.
//   1. an entry is a candidate iff its score is >= that of every valid entry
//      sharing a broker endpoint with it (the per-broker scatter-max);
//   2. it survives iff no lower-index candidate shares a broker (the
//      scatter-min of the index);
//   3. relays only: unique_per_group over the union of (src, dst, third
//      broker): best score among the selected entries sharing any of them,
//      ties to the lowest index;
//   4. the same over the destination hosts (leg 1's, and leg 2's);
//   5. the same over the partitions (leg 1's, and leg 2's).
// The selected entries are then broker-, host- and partition-disjoint, so
// each thread applies its own entries with plain loads and stores (for two
// legs this needs leg 2 to leave the broker leg 1 enters, as every swap and
// relay does; the claims cover no other broker): leg 1,
// then leg 2, both built from the pre-wave assignment (an entry's two rows
// are its own). A broker shared by an entry's two legs (a swap's ends, a
// relay's e == b) thus takes (x + leg1) + leg2, rounded twice as in the
// reference. The one shared aggregate is host_cpu_load, whose source hosts
// may repeat: one thread applies it in the reference's order (leg 1's source
// subtractions in entry order, then its destination additions, then leg 2's
// likewise). Entries whose flag is set but whose action is not valid (an
// empty slot or src == dst) are treated as unflagged; the scoring kernels
// never give such an entry a finite score, so the reference never flags one.
#include "common.cuh"

#define MAX_N 4096
#define MAX_THREADS 1024
// bytes of dynamic shared memory per entry: 9 ints, 3 floats, 2 flags
#define SMEM_PER_ENTRY (9 * 4 + 3 * 4 + 2)

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
  int n, R, NR, B, tag, legs, brokers3;
};

struct Shared {
  int *src, *dst, *b3, *h1, *h2, *q1, *q2, *hs1, *hs2;
  float *score, *dc1, *dc2;
  unsigned char *fa, *fb;
};

__device__ __forceinline__ Shared carve(unsigned char* base, int n) {
  Shared s;
  int* ip = (int*)base;
  s.src = ip;
  s.dst = ip + n;
  s.b3 = ip + 2 * n;
  s.h1 = ip + 3 * n;
  s.h2 = ip + 4 * n;
  s.q1 = ip + 5 * n;
  s.q2 = ip + 6 * n;
  s.hs1 = ip + 7 * n;
  s.hs2 = ip + 8 * n;
  float* fp = (float*)(ip + 9 * n);
  s.score = fp;
  s.dc1 = fp + n;
  s.dc2 = fp + 2 * n;
  s.fa = (unsigned char*)(fp + 3 * n);
  s.fb = s.fa + n;
  return s;
}

// does any non-negative claim of x equal any claim of y?
__device__ __forceinline__ bool shares(int x0, int x1, int x2, int y0, int y1, int y2) {
  return (x0 >= 0 && (x0 == y0 || x0 == y1 || x0 == y2)) ||
         (x1 >= 0 && (x1 == y0 || x1 == y1 || x1 == y2)) ||
         (x2 >= 0 && (x2 == y0 || x2 == y1 || x2 == y2));
}

// unique_per_group (context.py:460) over the claims c0/c1/c2 (-1 = none):
// reads the selection from fb, leaves it in fb; fa is scratch.
__device__ void unique_per_group(const Shared& s, const int* c0, const int* c1, const int* c2,
                                 int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    bool keep = s.fb[i];
    if (keep) {
      const int x0 = c0[i], x1 = c1 ? c1[i] : -1, x2 = c2 ? c2[i] : -1;
      for (int j = 0; j < n; ++j) {
        if (!s.fb[j]) continue;
        if (shares(x0, x1, x2, c0[j], c1 ? c1[j] : -1, c2 ? c2[j] : -1) &&
            !(s.score[i] >= s.score[j])) {
          keep = false;
          break;
        }
      }
    }
    s.fa[i] = keep;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    bool keep = s.fa[i];
    if (keep) {
      const int x0 = c0[i], x1 = c1 ? c1[i] : -1, x2 = c2 ? c2[i] : -1;
      for (int j = 0; j < i; ++j)
        if (s.fa[j] && shares(x0, x1, x2, c0[j], c1 ? c1[j] : -1, c2 ? c2[j] : -1)) {
          keep = false;
          break;
        }
    }
    s.fb[i] = keep;
  }
  __syncthreads();
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

__global__ void __launch_bounds__(MAX_THREADS) k_apply_wave(WaveArgs w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = w.n;
  const bool two = w.legs == 2;
  Shared s = carve(smem, n);

  // claims of every entry, from the pre-wave assignment
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    bool v = w.ok[i] && w.p[i] >= 0 && (!two || w.p2[i] >= 0);
    Action a1, a2;
    if (v) {
      a1 = build_action(w.assignment, w.R, w.part_load, w.p[i], w.kind[i], w.slot[i], w.dst[i]);
      v = a1.valid;
    }
    if (v && two) {
      a2 = build_action(w.assignment, w.R, w.part_load, w.p2[i], w.kind2[i], w.slot2[i], w.dst2[i]);
      v = a2.valid;
    }
    s.score[i] = v ? w.score[i] : -INFINITY;
    s.src[i] = v ? a1.src : -1;
    s.dst[i] = v ? a1.dst : -1;
    s.b3[i] = (v && w.brokers3) ? a2.dst : -1;
    s.h1[i] = v ? w.broker_host[a1.dst] : -1;
    s.h2[i] = (v && two) ? w.broker_host[a2.dst] : -1;
    s.q1[i] = v ? a1.p : -1;
    s.q2[i] = (v && two) ? a2.p : -1;
    s.hs1[i] = v ? w.broker_host[a1.src] : -1;
    s.hs2[i] = (v && two) ? w.broker_host[a2.src] : -1;
    s.dc1[i] = v ? a1.dload[RES_CPU] : 0.0f;
    s.dc2[i] = (v && two) ? a2.dload[RES_CPU] : 0.0f;
  }
  __syncthreads();

  // 1. max score on each of the entry's broker endpoints
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int a = s.src[i], b = s.dst[i];
    bool cand = a >= 0;
    if (cand) {
      for (int j = 0; j < n; ++j) {
        const int x = s.src[j], y = s.dst[j];
        if (x < 0) continue;
        if ((x == a || y == a || x == b || y == b) && !(s.score[i] >= s.score[j])) {
          cand = false;
          break;
        }
      }
    }
    s.fa[i] = cand;
  }
  __syncthreads();
  // 2. lowest index among the maxima
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    bool sel = s.fa[i];
    if (sel) {
      const int a = s.src[i], b = s.dst[i];
      for (int j = 0; j < i; ++j) {
        if (!s.fa[j]) continue;
        const int x = s.src[j], y = s.dst[j];
        if (x == a || y == a || x == b || y == b) {
          sel = false;
          break;
        }
      }
    }
    s.fb[i] = sel;
  }
  __syncthreads();
  // 3.-5. the group claims, in the reference's order
  if (w.brokers3) unique_per_group(s, s.src, s.dst, s.b3, n);
  unique_per_group(s, s.h1, two ? s.h2 : nullptr, nullptr, n);
  unique_per_group(s, s.q1, two ? s.q2 : nullptr, nullptr, n);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    w.sel_out[i] = s.fb[i];
    if (!s.fb[i]) continue;
    // an entry's rows are its own (partition claims), so rebuilding its
    // legs now reads the pre-wave rows even while other entries apply
    Action a1 = build_action(w.assignment, w.R, w.part_load, w.p[i], w.kind[i], w.slot[i], w.dst[i]);
    Action a2;
    if (two)
      a2 = build_action(w.assignment, w.R, w.part_load, w.p2[i], w.kind2[i], w.slot2[i], w.dst2[i]);
    apply_action(w, a1);
    if (two) apply_action(w, a2);
  }
  if (threadIdx.x == 0) {
    for (int j = 0; j < n; ++j)
      if (s.fb[j]) w.host_cpu[s.hs1[j]] = w.host_cpu[s.hs1[j]] - s.dc1[j];
    for (int j = 0; j < n; ++j)
      if (s.fb[j]) w.host_cpu[s.h1[j]] = w.host_cpu[s.h1[j]] + s.dc1[j];
    if (two) {
      for (int j = 0; j < n; ++j)
        if (s.fb[j]) w.host_cpu[s.hs2[j]] = w.host_cpu[s.hs2[j]] - s.dc2[j];
      for (int j = 0; j < n; ++j)
        if (s.fb[j]) w.host_cpu[s.h2[j]] = w.host_cpu[s.h2[j]] + s.dc2[j];
    }
  }
}

// ptrs: p, kind, slot, dst, p2, kind2, slot2, dst2 (i32[N]; leg 2 ignored
//       when legs == 1), score f32[N], ok u8[N], sel_out u8[N],
//       assignment, part_load, topic_id, broker_rack, broker_host, broker_load,
//       replica_count, leader_count, potential, leader_nw_in, rack_count,
//       topic_count, host_cpu, touch_tag
// ints: N, R, NR, B, tag, legs (1 or 2), brokers3 (0 or 1)
CC_EXPORT int apply_wave(const long long* ptrs, const long long* ints, cudaStream_t stream) {
  WaveArgs w;
  int k = 0;
  w.p = (const int*)ptrs[k++];
  w.kind = (const int*)ptrs[k++];
  w.slot = (const int*)ptrs[k++];
  w.dst = (const int*)ptrs[k++];
  w.p2 = (const int*)ptrs[k++];
  w.kind2 = (const int*)ptrs[k++];
  w.slot2 = (const int*)ptrs[k++];
  w.dst2 = (const int*)ptrs[k++];
  w.score = (const float*)ptrs[k++];
  w.ok = (const unsigned char*)ptrs[k++];
  w.sel_out = (unsigned char*)ptrs[k++];
  w.assignment = (int*)ptrs[k++];
  w.part_load = (const float*)ptrs[k++];
  w.topic_id = (const int*)ptrs[k++];
  w.broker_rack = (const int*)ptrs[k++];
  w.broker_host = (const int*)ptrs[k++];
  w.broker_load = (float*)ptrs[k++];
  w.replica_count = (int*)ptrs[k++];
  w.leader_count = (int*)ptrs[k++];
  w.potential = (float*)ptrs[k++];
  w.leader_nw_in = (float*)ptrs[k++];
  w.rack_count = (int*)ptrs[k++];
  w.topic_count = (int*)ptrs[k++];
  w.host_cpu = (float*)ptrs[k++];
  w.touch_tag = (int*)ptrs[k++];
  w.n = (int)ints[0];
  w.R = (int)ints[1];
  w.NR = (int)ints[2];
  w.B = (int)ints[3];
  w.tag = (int)ints[4];
  w.legs = (int)ints[5];
  w.brokers3 = (int)ints[6];
  if (w.n <= 0) return cudaSuccess;
  if (w.n > MAX_N || w.legs < 1 || w.legs > 2 || (w.brokers3 && w.legs != 2))
    return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(k_apply_wave, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         MAX_N * SMEM_PER_ENTRY);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  int threads = ((w.n + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  size_t smem = (size_t)w.n * SMEM_PER_ENTRY;
  k_apply_wave<<<1, threads, smem, stream>>>(w);
  return cudaGetLastError();
}
