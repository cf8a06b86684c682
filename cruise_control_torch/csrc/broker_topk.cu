// K2 broker_topk: every broker's top-k replica slots by drain priority.
//
// Replaces: cruise_control_tpu/analyzer/drain.py broker_top_replicas (:74),
// k segment_max -> segment_min-of-index passes over the flat slot axis.
//
// Bound on this card: bytes. The call reads the P*R contrib and assignment
// entries and the P movable flags (about 5 MB at 199,518 x 3 slots) and
// writes B * k outputs; the bound the caller states counts each input once.
//
// The order: a slot's 64-bit key holds the order-preserving bits of its value
// (negated when heaviest == 0) in the high word and ~index in the low word,
// so a larger key is a higher value, ties to the lower flat index, exactly
// drain.py:103-108. -0.0 is canonicalised to +0.0 first because the JAX code
// compares with ==, which treats them as equal. Slots that are empty (-1),
// immovable or non-finite never compete, as at drain.py:94-97; a slot on a
// broker >= B does not either. Every real key has a nonzero high word, so 0
// means "none". Keys are unique, so a broker's top k keys are its k passes'
// winners in order, whatever order its slots are gathered in.
//
// Design: each slot is read once, and nothing is contended: no global atomic
// at all. Two launches:
//   k_topk_runs    G blocks of 512 threads, each a chunk of at most 4,096
//                  slots (8 a thread, every load issued before any is used),
//                  sort their eligible keys by broker in shared memory (a
//                  histogram whose atomics give each key its rank among its
//                  broker's, a block scan, the keys placed) and write them
//                  out coalesced: block g's keys of broker b are the run
//                  keys[g * chunk + start, + count), and runs[g * B + b] holds
//                  (start << 16) | count. Up to 32,768 brokers the histogram
//                  lives in shared memory; above, in the block's own row of
//                  `runs`, which the scan then overwrites (a second launch
//                  configuration of the same kernel, for any B < 2**31);
//   k_topk_select  one warp per broker: lane l takes the broker's runs of
//                  blocks l, l + 32, ...; each pass, a lane keeps the 8
//                  largest keys below the last winner among its runs,
//                  sorted in registers, and 8 rounds of a warp max
//                  (__reduce_max_sync on the high words, then on the low
//                  words) pop the next 8 winners (a key among the broker's
//                  8 largest is among its lane's 8 largest). A run's tail
//                  longer than 32 keys is walked by the whole warp in
//                  coalesced loads. A broker with more than 2,048 eligible
//                  slots is taken by its whole block of 4 warps instead,
//                  after the block's other brokers: its runs dealt out
//                  across the warps, each warp's 8 best merged by warp 0.
//                  k > 8 takes ceil(k / 8) passes; a broker with fewer
//                  than k eligible slots gets (p, s) of slot n - 1 and
//                  valid = 0.
#include <cub/block/block_scan.cuh>

#include "common.cuh"

constexpr int K2_THREADS = 512;
constexpr int K2_ITEMS = 8;                       // slots a thread loads at once
constexpr int K2_CHUNK = K2_THREADS * K2_ITEMS;  // slots a block takes, at most
constexpr int K2_SELECT_THREADS = 128;
constexpr int K2_SELECT_WARPS = K2_SELECT_THREADS / 32;
// 5 blocks an SM: 2,600 brokers' warps fit the card at once (<= 102 registers)
constexpr int K2_SELECT_MIN_BLOCKS = 5;
constexpr int K2_LANE_KEYS = 8;
constexpr int K2_LANE_RUNS = 5;    // runs a lane of the select loads at once
constexpr int K2_RUN_HEAD = 4;     // and the keys of each
constexpr int K2_TAIL_LOADS = 2;   // a tail's keys a lane loads at once
constexpr int K2_LONG = 32;        // a longer tail is walked by the whole warp
constexpr unsigned int K2_HEAVY = 2048;  // a broker with more keys gets the block
typedef cub::BlockScan<unsigned int, K2_THREADS> K2Scan;

__device__ __forceinline__ unsigned int order_bits(float v) {
  unsigned int u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the most brokers whose counters k_topk_runs keeps in shared memory
constexpr long long K2_SHARED_BINS = 32768;

// dynamic shared memory of k_topk_runs: K2_CHUNK keys, then B counters
// (GLOBAL_BINS: the counters in the block's row of `runs` instead)
template <bool GLOBAL_BINS>
__global__ void __launch_bounds__(K2_THREADS)
    k_topk_runs(const float* __restrict__ contrib, const int* __restrict__ assignment,
                const unsigned char* __restrict__ movable, long long n, int R, int B,
                int heaviest, int chunk, unsigned int* __restrict__ runs,
                unsigned long long* __restrict__ keys) {
  extern __shared__ unsigned long long s_keys[];
  unsigned int* row = runs + (long long)blockIdx.x * B;
  unsigned int* s_bin = GLOBAL_BINS ? row : (unsigned int*)(s_keys + K2_CHUNK);
  __shared__ K2Scan::TempStorage scan_tmp;
  const int tid = threadIdx.x;
  for (int b = tid; b < B; b += K2_THREADS) s_bin[b] = 0u;

  // this thread's slots lo + tid + j * K2_THREADS: every load issued, at a
  // clamped index, before any is used (n < 2**32: 32-bit indices)
  const unsigned int lo = blockIdx.x * (unsigned int)chunk;
  const unsigned int hi = (unsigned int)min(n, (long long)lo + chunk), last = hi - 1u;
  int bk[K2_ITEMS];
  float c[K2_ITEMS];
  unsigned char mv[K2_ITEMS];
  if (hi > lo) {
#pragma unroll
    for (int j = 0; j < K2_ITEMS; ++j) {
      unsigned int i = min(lo + tid + j * K2_THREADS, last);
      bk[j] = assignment[i];
      c[j] = contrib[i];
    }
#pragma unroll
    for (int j = 0; j < K2_ITEMS; ++j)
      mv[j] = movable[min(lo + tid + j * K2_THREADS, last) / (unsigned int)R];
  } else {  // no slot at all (P * R == 0)
#pragma unroll
    for (int j = 0; j < K2_ITEMS; ++j) bk[j] = -1, c[j] = 0.0f, mv[j] = 0;
  }
  unsigned long long key[K2_ITEMS];
#pragma unroll
  for (int j = 0; j < K2_ITEMS; ++j) {
    unsigned int i = lo + tid + j * K2_THREADS;
    float v = heaviest ? c[j] : -c[j];
    if (v == 0.0f) v = 0.0f;  // -0.0 == +0.0 in the reference's compare
    bool in = tid + j * K2_THREADS < chunk && i < hi && bk[j] >= 0 && bk[j] < B;
    key[j] = in && mv[j] && isfinite(c[j])
                 ? ((unsigned long long)order_bits(v) << 32) | (unsigned long long)(~i)
                 : 0ull;
  }
  __syncthreads();
  unsigned int rank[K2_ITEMS];
#pragma unroll
  for (int j = 0; j < K2_ITEMS; ++j) rank[j] = key[j] ? atomicAdd(&s_bin[bk[j]], 1u) : 0u;
  __syncthreads();

  // the block's runs: an exclusive scan of the counts, bins base + tid (the
  // global counters read past L1, where their atomics land)
  unsigned int carry = 0u;
  for (int base = 0; base < B; base += K2_THREADS) {
    int b = base + tid;
    unsigned int cnt = b < B ? (GLOBAL_BINS ? __ldcg(s_bin + b) : s_bin[b]) : 0u, start, total;
    K2Scan(scan_tmp).ExclusiveSum(cnt, start, total);
    start += carry;
    if (b < B) {
      if (!GLOBAL_BINS) s_bin[b] = start;
      row[b] = (start << 16) | cnt;
    }
    carry += total;
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < K2_ITEMS; ++j)
    if (key[j])
      s_keys[(GLOBAL_BINS ? __ldcg(row + bk[j]) >> 16 : s_bin[bk[j]]) + rank[j]] = key[j];
  __syncthreads();
  unsigned long long* out = keys + (long long)blockIdx.x * chunk;
  for (unsigned int e = tid; e < carry; e += K2_THREADS) out[e] = s_keys[e];
}

// The warp's largest key (one instruction per word: the high words, then the
// low words of the lanes that hold the largest high word).
__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
  unsigned int hi = __reduce_max_sync(0xffffffffu, (unsigned int)(v >> 32));
  unsigned int lo =
      __reduce_max_sync(0xffffffffu, (unsigned int)(v >> 32) == hi ? (unsigned int)v : 0u);
  return ((unsigned long long)hi << 32) | lo;
}

// Keep `key` among the K2_LANE_KEYS largest of t, sorted descending (a key
// no larger than the smallest kept, 0 among them, costs one compare).
__device__ __forceinline__ void keep(unsigned long long t[K2_LANE_KEYS], unsigned long long key) {
  if (key <= t[K2_LANE_KEYS - 1]) return;
  t[K2_LANE_KEYS - 1] = key;
#pragma unroll
  for (int q = K2_LANE_KEYS - 1; q > 0; --q) {
    unsigned long long hi = t[q] > t[q - 1] ? t[q] : t[q - 1];
    t[q] = t[q] > t[q - 1] ? t[q - 1] : t[q];
    t[q - 1] = hi;
  }
}

// Keep in t the K2_LANE_KEYS largest keys below thr of broker b's runs
// g = rank, rank + N, rank + 2N, ... (every lane of the warp calls it, with
// N a multiple of 32). A run's first K2_RUN_HEAD keys are loaded with the
// others' (K2_LANE_RUNS runs at a time, at clamped addresses); its tail, by
// its own lane in loads of K2_TAIL_LOADS where it is short, by the whole
// warp in coalesced loads where it is longer than K2_LONG. With `probe` (a
// warp's own broker, N = 32), it first counts the broker's keys while the
// first heads load, and returns true, keeping nothing, above K2_HEAVY.
__device__ __forceinline__ bool collect(unsigned long long t[K2_LANE_KEYS],
                                        const unsigned long long* __restrict__ keys,
                                        const unsigned int* __restrict__ runs, int G, int chunk,
                                        int B, int b, unsigned long long thr, int rank, int N,
                                        bool probe) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < K2_LANE_KEYS; ++q) t[q] = 0ull;
  for (int g0 = 0; g0 < G; g0 += N * K2_LANE_RUNS) {
    unsigned int run[K2_LANE_RUNS];
#pragma unroll
    for (int q = 0; q < K2_LANE_RUNS; ++q) {
      int g = g0 + rank + N * q;
      unsigned int rv = runs[(long long)min(g, G - 1) * B + b];
      run[q] = g < G ? rv : 0u;
    }
    unsigned long long v[K2_LANE_RUNS][K2_RUN_HEAD];
#pragma unroll
    for (int q = 0; q < K2_LANE_RUNS; ++q) {
      const int cnt = run[q] & 0xffffu;
      const unsigned long long* s =
          cnt ? keys + (long long)(g0 + rank + N * q) * chunk + (run[q] >> 16) : keys;
#pragma unroll
      for (int e = 0; e < K2_RUN_HEAD; ++e) {
        unsigned long long kv = s[min(e, max(cnt - 1, 0))];
        v[q][e] = e < cnt ? kv : 0ull;
      }
    }
    if (probe && g0 == 0) {
      unsigned int total = 0u;
#pragma unroll
      for (int q = 0; q < K2_LANE_RUNS; ++q) total += run[q] & 0xffffu;
      for (int g = rank + N * K2_LANE_RUNS; g < G; g += N)
        total += runs[(long long)g * B + b] & 0xffffu;
      if (__reduce_add_sync(0xffffffffu, total) > K2_HEAVY) return true;
    }
#pragma unroll
    for (int q = 0; q < K2_LANE_RUNS; ++q)
#pragma unroll
      for (int e = 0; e < K2_RUN_HEAD; ++e)
        if (v[q][e] < thr) keep(t, v[q][e]);
    // the tails, once the heads' registers are free
    bool longer_any = false;
#pragma unroll
    for (int q = 0; q < K2_LANE_RUNS; ++q)
      longer_any |= (run[q] & 0xffffu) > K2_RUN_HEAD + K2_LONG;
    longer_any = __any_sync(0xffffffffu, longer_any);
#pragma unroll
    for (int q = 0; q < K2_LANE_RUNS; ++q) {
      const int cnt = run[q] & 0xffffu;
      const unsigned long long* s =
          cnt ? keys + (long long)(g0 + rank + N * q) * chunk + (run[q] >> 16) : keys;
      if (cnt <= K2_RUN_HEAD + K2_LONG) {
        for (int e0 = K2_RUN_HEAD; e0 < cnt; e0 += K2_TAIL_LOADS) {
          unsigned long long w[K2_TAIL_LOADS];
#pragma unroll
          for (int u = 0; u < K2_TAIL_LOADS; ++u) {
            unsigned long long kv = s[min(e0 + u, cnt - 1)];
            w[u] = e0 + u < cnt ? kv : 0ull;
          }
#pragma unroll
          for (int u = 0; u < K2_TAIL_LOADS; ++u)
            if (w[u] < thr) keep(t, w[u]);
        }
      }
      unsigned int longer =
          longer_any ? __ballot_sync(0xffffffffu, cnt > K2_RUN_HEAD + K2_LONG) : 0u;
      while (longer) {  // the same for every lane
        const int src = __ffs(longer) - 1;
        longer &= longer - 1u;
        const int c2 = __shfl_sync(0xffffffffu, cnt, src);
        const unsigned long long* s2 = (const unsigned long long*)__shfl_sync(
            0xffffffffu, (unsigned long long)(size_t)s, src);
        for (int e0 = K2_RUN_HEAD; e0 < c2; e0 += 32 * K2_TAIL_LOADS) {
          unsigned long long w[K2_TAIL_LOADS];
#pragma unroll
          for (int u = 0; u < K2_TAIL_LOADS; ++u) {
            const int e = e0 + lane + 32 * u;
            unsigned long long kv = s2[min(e, c2 - 1)];
            w[u] = e < c2 ? kv : 0ull;
          }
#pragma unroll
          for (int u = 0; u < K2_TAIL_LOADS; ++u)
            if (w[u] < thr) keep(t, w[u]);
        }
      }
    }
  }
  return false;
}

// Pop the warp's largest key from t, which it leaves sorted: the one lane
// that holds it (keys are unique) shifts its list. Returns 0 when no lane
// holds a key.
__device__ __forceinline__ unsigned long long pop_max(unsigned long long t[K2_LANE_KEYS]) {
  const unsigned long long m = warp_max(t[0]);
  if (m != 0ull && t[0] == m) {
#pragma unroll
    for (int q = 0; q < K2_LANE_KEYS - 1; ++q) t[q] = t[q + 1];
    t[K2_LANE_KEYS - 1] = 0ull;
  }
  return m;
}

__device__ __forceinline__ void put(int* out_p, int* out_s, unsigned char* out_ok, long long o,
                                    unsigned long long m, int R) {
  const long long idx = (long long)(~(unsigned int)(m & 0xffffffffull));
  out_p[o] = (int)(idx / R);
  out_s[o] = (int)(idx % R);
  out_ok[o] = 1;
}

__global__ void __launch_bounds__(K2_SELECT_THREADS, K2_SELECT_MIN_BLOCKS)
    k_topk_select(const unsigned long long* __restrict__ keys,
                  const unsigned int* __restrict__ runs, int G, int chunk, int B, int k,
                  long long n, int R, int* __restrict__ out_p, int* __restrict__ out_s,
                  unsigned char* __restrict__ out_ok) {
  __shared__ int s_heavy[K2_SELECT_WARPS];
  __shared__ unsigned long long s_cand[K2_SELECT_WARPS][K2_LANE_KEYS];
  __shared__ unsigned long long s_thr;
  __shared__ int s_j, s_more;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * K2_SELECT_WARPS + warp;
  // fewer than k: (p, s) of slot n - 1 (floor division, as the plain version)
  const long long last = n - 1;
  const int np = (int)(last >= 0 ? last / R : -1), ns = (int)(last >= 0 ? last % R : R - 1);
  unsigned long long t[K2_LANE_KEYS];

  bool heavy = false;
  if (b < B) {  // the warp's own broker, unless it is heavy
    const long long o = (long long)b * k;
    unsigned long long thr = ~0ull;  // every key is below: +inf never competes
    int j = 0;
    bool more = true;  // keys below thr may be left
    while (j < k && more) {
      heavy = collect(t, keys, runs, G, chunk, B, b, thr, lane, 32, j == 0);
      if (heavy) break;
      const int take = min(K2_LANE_KEYS, k - j);
      for (int r = 0; r < take; ++r) {
        const unsigned long long m = pop_max(t);
        if (m == 0ull) {  // the broker has no key left
          more = false;
          break;
        }
        if (lane == 0) put(out_p, out_s, out_ok, o + j, m, R);
        thr = m;
        ++j;
      }
    }
    for (int q = heavy ? k : j + lane; q < k; q += 32) {
      out_p[o + q] = np;
      out_s[o + q] = ns;
      out_ok[o + q] = 0;
    }
  }

  // a heavy broker: the whole block, each pass every warp's best below the
  // last winner, merged by warp 0 (a key among the broker's largest is
  // among its warp's); its runs dealt out across the warps first
  if (lane == 0) s_heavy[warp] = heavy ? b : -1;
  __syncthreads();
  for (int w = 0; w < K2_SELECT_WARPS; ++w) {
    const int hb = s_heavy[w];
    if (hb < 0) continue;  // the same for every thread
    const long long o = (long long)hb * k;
    unsigned long long thr = ~0ull;
    int j = 0;
    bool more = true;
    while (j < k && more) {
      collect(t, keys, runs, G, chunk, B, hb, thr, lane * K2_SELECT_WARPS + warp,
              K2_SELECT_THREADS, false);
      const int take = min(K2_LANE_KEYS, k - j);
      for (int r = 0; r < take; ++r) {
        const unsigned long long m = pop_max(t);
        if (lane == 0) s_cand[warp][r] = m;
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int q = 0; q < K2_LANE_KEYS; ++q)
          t[q] = lane < K2_SELECT_WARPS && q < take ? s_cand[lane][q] : 0ull;
        int r = 0;
        for (; r < take; ++r) {
          const unsigned long long m = pop_max(t);
          if (m == 0ull) break;
          if (lane == 0) put(out_p, out_s, out_ok, o + j + r, m, R);
          thr = m;
        }
        if (lane == 0) {
          s_thr = thr;
          s_j = j + r;
          s_more = r == take;
        }
      }
      __syncthreads();
      thr = s_thr;
      j = s_j;
      more = s_more != 0;
    }
    for (int q = j + (int)threadIdx.x; q < k; q += K2_SELECT_THREADS) {
      out_p[o + q] = np;
      out_s[o + q] = ns;
      out_ok[o + q] = 0;
    }
  }
}

// contrib f32[P*R], assignment i32[P*R], movable u8[P]; runs u32[blocks * B];
// keys u64[blocks * chunk]; out_p, out_s i32[B, k], out_ok u8[B, k]. The
// slots are cut into `blocks` chunks of ceil(P*R / blocks) <= 4,096; P*R <
// 2**32; B < 2**31 (the block's counters in shared memory up to
// K2_SHARED_BINS brokers, in its row of `runs` above).
CC_EXPORT int broker_topk(const float* contrib, const int* assignment, const unsigned char* movable,
                          unsigned int* runs, unsigned long long* keys, int* out_p, int* out_s,
                          unsigned char* out_ok, long long P, long long R, long long B, long long k,
                          long long heaviest, long long blocks, cudaStream_t stream) {
  if (B <= 0 || k <= 0) return cudaSuccess;
  long long n = P * R, chunk = blocks > 0 ? (n + blocks - 1) / blocks : 0;
  if (R <= 0 || blocks <= 0 || n >= (1LL << 32) || chunk > K2_CHUNK || B > 0x7fffffffLL ||
      blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (chunk == 0) chunk = 1;
  cudaError_t e;
  if (B > K2_SHARED_BINS) {
    k_topk_runs<true><<<(unsigned)blocks, K2_THREADS, K2_CHUNK * sizeof(unsigned long long),
                        stream>>>(contrib, assignment, movable, n, (int)R, (int)B,
                                  (int)heaviest, (int)chunk, runs, keys);
  } else {
    size_t smem = (size_t)K2_CHUNK * sizeof(unsigned long long) + (size_t)B * sizeof(unsigned int);
    static size_t smem_set[64];  // per device: the largest size allowed so far
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= 64 || smem_set[dev] < smem) {
      e = cudaFuncSetAttribute(k_topk_runs<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return e;
      if (dev >= 0 && dev < 64) smem_set[dev] = smem;
    }
    k_topk_runs<false><<<(unsigned)blocks, K2_THREADS, smem, stream>>>(
        contrib, assignment, movable, n, (int)R, (int)B, (int)heaviest, (int)chunk, runs, keys);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  k_topk_select<<<(unsigned)((B + K2_SELECT_WARPS - 1) / K2_SELECT_WARPS), K2_SELECT_THREADS, 0,
                  stream>>>(
      keys, runs, (int)blocks, (int)chunk, (int)B, (int)k, n, (int)R, out_p, out_s, out_ok);
  return cudaGetLastError();
}
