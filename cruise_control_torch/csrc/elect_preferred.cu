// K11 elect_preferred: leadership off demoted and dead brokers, to the
// first replica on an eligible broker.
//
// Replaces: cruise_control_tpu/analyzer/goals/preferred.py
// elect_preferred_leaders (:22). For each partition whose slot-0 broker is
// demoted or dead, slot 0 is exchanged with the lowest slot whose broker is
// alive and not demoted (the first true of a bool argmax); a partition with
// no such replica, or whose leader is eligible, keeps its row. A -1 slot is
// empty: its broker is read as broker 0's and the result masked by the
// slot's validity, as the reference does (holder = where(valid, a, 0)); a
// broker id past the masks reads the last broker's flags (a clamped gather,
// as XLA's).
//
// Bound on this card: bytes. The [P, R] i32 assignment is read once and a
// fresh [P, R] written once (4.8 MB at 199,518 partitions and RF 3, about
// 1.4 us at 3.35 TB/s); the two [B] masks are read once more.
//
// Design: one launch (two past EP_BYTE_FLAGS brokers). The flags are merged
// once into one ineligible flag a broker, where every row's decision reads
// it without two dependent gathers from the masks:
//   bytes    B <= EP_BYTE_FLAGS: each block ORs the two masks into a byte a
//            broker in shared memory, 16 bytes a load;
//   global   past that, a first launch ORs them into a bit a broker in a
//            device workspace (a thread a word of 32 brokers, from 16-byte
//            loads), which the blocks read in place.
// A block takes tiles of EP_TILE rows (fewer past EP_TILE_WORDS words, a
// multiple of 4 rows, so a tile's byte span is a whole number of 16-byte
// vectors). It reads a tile flat into shared memory with coalesced 16-byte
// loads (the first tile's loads issued before the flags are staged), each
// thread resolves its rows there (the leader's flag first; only a row whose
// leader is ineligible scans its other slots), and the block writes the tile
// out flat with 16-byte stores. A view that does not start on a 16-byte
// boundary takes up to 3 words before its first vector and after its last
// as scalars, and the shared tile is offset so its vectors stay aligned.
// The grid is the tiles, at most EP_BLOCKS_PER_SM blocks an SM, each
// striding over the tiles. Indices are 32-bit where the words fit and 64-bit
// past that. A row too wide for a 4-row tile (R > EP_TILE_WORDS / 4) takes
// a block: its threads find the first eligible slot with a shared atomicMin
// and copy the row. The input is never written.
//
// Measured (scripts/kernel_variants.py --only K11, NVIDIA H100 80GB HBM3,
// 700 W; PERF.md section 6): tiles of 512 rows ran fastest at the demote
// phase's shape, ahead of 1,024, 256 and 2,048, of 128 threads a block, of
// the masks read in place and of a thread a quad of rows held in registers.
// What is left over an empty launch is about one load round trip and the
// stores: the 2.4 MB read and written sit in the 50 MB L2 when calls run
// back to back.
#include "common.cuh"

constexpr int EP_THREADS = 256;
constexpr int EP_TILE = 512;    // partition rows a tile (a multiple of 4)
constexpr int EP_VEC = 4;       // 16-byte vectors a thread loads at once
constexpr long long EP_TILE_WORDS = 12288;  // the most words a tile stages (48 KB)
constexpr long long EP_BYTE_FLAGS = 49152;  // brokers staged as bytes (48 KB)
constexpr int EP_BLOCKS_PER_SM = 4;
constexpr int EP_MAX_DEVICES = 64;
constexpr int EP_SMEM_MAX = (int)(EP_BYTE_FLAGS + 4 * EP_TILE_WORDS + 16);

enum FlagMode { FLAGS_AUTO = 0, FLAGS_BYTES = 1, FLAGS_GLOBAL = 2 };

struct EpArgs {
  const int* in;
  int* out;
  const unsigned char* demoted;
  const unsigned char* dead;
  const unsigned int* bits;  // ceil(B / 32) words
  long long p, r, b, n;      // n = p * r words
  long long rows, tiles;     // rows a tile, tiles
  int head_in, head_out;     // words before the first 16-byte boundary (0-3)
  int flag_bytes;            // shared bytes of flags, in front of the tile
  bool vec_flags;            // demoted and dead on 16-byte boundaries
};

// The merged ineligible flag of broker h (0 <= h < B).
template <int MODE>
__device__ __forceinline__ bool ineligible(const EpArgs& g, const unsigned char* s_flags, int h) {
  if (MODE == FLAGS_BYTES) return s_flags[h] != 0;
  return (__ldg(g.bits + (h >> 5)) >> (h & 31)) & 1u;
}

__device__ __forceinline__ int clamp_broker(int a, long long b) {
  return a < b ? a : (int)(b - 1);
}

// The 0/1 bytes of x as 4 bits (byte k -> bit k): the four products land on
// bits 24-27 and no carry reaches them.
__device__ __forceinline__ unsigned pack4(unsigned x) {
  return ((x & 0x01010101u) * 0x01020408u) >> 24;
}

// demoted | dead, a bit a broker: bits[i / 32] bit i % 32. A thread a word
// of 32 brokers, from two 16-byte loads of each mask where both masks are on
// 16-byte boundaries and the word is whole, a byte at a time otherwise.
__global__ void __launch_bounds__(EP_THREADS)
    k_merge_bits(const unsigned char* demoted, const unsigned char* dead, unsigned int* bits,
                 long long b, bool vec) {
  const long long w = (long long)blockIdx.x * EP_THREADS + threadIdx.x, i0 = 32 * w;
  if (i0 >= b) return;
  unsigned out = 0u;
  if (vec && i0 + 32 <= b) {
    const uint4* d0 = reinterpret_cast<const uint4*>(demoted + i0);
    const uint4* d1 = reinterpret_cast<const uint4*>(dead + i0);
    const uint4 a0 = d0[0], a1 = d0[1], c0 = d1[0], c1 = d1[1];
    const unsigned x[8] = {a0.x | c0.x, a0.y | c0.y, a0.z | c0.z, a0.w | c0.w,
                           a1.x | c1.x, a1.y | c1.y, a1.z | c1.z, a1.w | c1.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) out |= pack4(x[k]) << (4 * k);
  } else {
    for (int k = 0; k < 32 && i0 + k < b; ++k)
      out |= (unsigned)((demoted[i0 + k] | dead[i0 + k]) != 0) << k;
  }
  bits[w] = out;
}

// The block's flags in shared memory: a byte a broker from the two masks.
template <typename I, int MODE>
__device__ __forceinline__ void stage_flags(const EpArgs& g, unsigned char* s) {
  const I tid = threadIdx.x;
  if (MODE == FLAGS_BYTES) {
    const I b = (I)g.b;
    I done = 0;
    if (g.vec_flags) {
      const I nv = b / 16;
      const uint4* d0 = reinterpret_cast<const uint4*>(g.demoted);
      const uint4* d1 = reinterpret_cast<const uint4*>(g.dead);
      uint4* sv = reinterpret_cast<uint4*>(s);
      for (I q = tid; q < nv; q += EP_THREADS) {
        const uint4 x = d0[q], y = d1[q];
        sv[q] = make_uint4(x.x | y.x, x.y | y.y, x.z | y.z, x.w | y.w);
      }
      done = nv * 16;
    }
    for (I i = done + tid; i < b; i += EP_THREADS) s[i] = g.demoted[i] | g.dead[i];
  }
}

// Copy `cnt` words from `src` (its first 16-byte boundary `head` words in)
// to t[0, cnt), where t + head is 16-byte aligned; `hook` runs between the
// first chunk's loads and their stores.
template <typename I, typename Hook>
__device__ __forceinline__ void load_tile(const int* __restrict__ src, int* t, I cnt, int head,
                                          Hook hook) {
  const I tid = threadIdx.x;
  const I h = min((I)head, cnt);
  const I nv = (cnt - h) / 4;
  const uint4* v = reinterpret_cast<const uint4*>(src + h);
  uint4* sv = reinterpret_cast<uint4*>(t + h);
  uint4 x[EP_VEC];
  for (I q0 = 0; q0 == 0 || q0 < nv; q0 += EP_THREADS * EP_VEC) {
    if (nv > 0) {
#pragma unroll
      for (int u = 0; u < EP_VEC; ++u) x[u] = v[min(q0 + (I)(u * EP_THREADS) + tid, nv - 1)];
    }
    if (q0 == 0) hook();
#pragma unroll
    for (int u = 0; u < EP_VEC; ++u) {
      const I q = q0 + (I)(u * EP_THREADS) + tid;
      if (q < nv) sv[q] = x[u];
    }
  }
  if (tid < h) t[tid] = src[tid];
  const I tail = h + 4 * nv;
  if (tid < cnt - tail) t[tail + tid] = src[tail + tid];
}

// Write t[0, cnt) to `dst` (its first 16-byte boundary `head` words in);
// `aligned`: t + head is 16-byte aligned too.
template <typename I>
__device__ __forceinline__ void store_tile(const int* t, int* __restrict__ dst, I cnt, int head,
                                           bool aligned) {
  const I tid = threadIdx.x;
  const I h = min((I)head, cnt);
  const I nv = (cnt - h) / 4;
  uint4* v = reinterpret_cast<uint4*>(dst + h);
  const int* th = t + h;
  for (I q = tid; q < nv; q += EP_THREADS)
    v[q] = aligned ? reinterpret_cast<const uint4*>(th)[q]
                   : make_uint4(th[4 * q], th[4 * q + 1], th[4 * q + 2], th[4 * q + 3]);
  if (tid < h) dst[tid] = t[tid];
  const I tail = h + 4 * nv;
  if (tid < cnt - tail) dst[tail + tid] = t[tail + tid];
}

template <typename I, int MODE>
__global__ void __launch_bounds__(EP_THREADS) k_elect_preferred(EpArgs g) {
  extern __shared__ uint4 s_raw[];
  unsigned char* s_flags = reinterpret_cast<unsigned char*>(s_raw);
  // tile word j at t[j], with t + head_in on a 16-byte boundary
  int* t = reinterpret_cast<int*>(s_flags + g.flag_bytes) + ((4 - g.head_in) & 3);
  const I tid = threadIdx.x;
  const int r = (int)g.r;
  const I span = (I)g.rows * r;
  bool first = true;
  for (I tile = blockIdx.x; tile < (I)g.tiles; tile += gridDim.x) {
    const I w0 = tile * span;
    const I cnt = min(span, (I)g.n - w0);
    load_tile<I>(g.in + w0, t, cnt, g.head_in, [&] {
      if (first) stage_flags<I, MODE>(g, s_flags);
    });
    first = false;
    __syncthreads();
    const I nrows = cnt / r;
    for (I lr = tid; lr < nrows; lr += EP_THREADS) {
      int* row = t + lr * r;
      const int a0 = row[0];
      if (a0 < 0 || !ineligible<MODE>(g, s_flags, clamp_broker(a0, g.b))) continue;
      for (int s = 1; s < r; ++s) {
        const int a = row[s];
        if (a >= 0 && !ineligible<MODE>(g, s_flags, clamp_broker(a, g.b))) {
          row[0] = a;
          row[s] = a0;
          break;
        }
      }
    }
    __syncthreads();
    store_tile<I>(t, g.out + w0, cnt, g.head_out, g.head_out == g.head_in);
    __syncthreads();
  }
}

// A block a row, for rows too wide for a 4-row tile; flags from the bits.
template <typename I>
__global__ void __launch_bounds__(EP_THREADS) k_elect_wide(EpArgs g) {
  __shared__ unsigned long long s_best;
  const I tid = threadIdx.x, r = (I)g.r;
  for (I p = blockIdx.x; p < (I)g.p; p += gridDim.x) {
    const int* row = g.in + p * r;
    int* dst = g.out + p * r;
    const int a0 = row[0];
    const bool bad = a0 >= 0 && ineligible<FLAGS_GLOBAL>(g, nullptr, clamp_broker(a0, g.b));
    if (tid == 0) s_best = ~0ull;
    __syncthreads();
    if (bad) {
      for (I s = 1 + tid; s < r; s += EP_THREADS) {
        const int a = row[s];
        if (a >= 0 && !ineligible<FLAGS_GLOBAL>(g, nullptr, clamp_broker(a, g.b))) {
          atomicMin(&s_best, (unsigned long long)s);
          break;
        }
      }
    }
    __syncthreads();
    const unsigned long long best = s_best;
    const bool swap = best != ~0ull;
    for (I s = tid; s < r; s += EP_THREADS)
      dst[s] = !swap ? row[s] : s == 0 ? row[best] : (unsigned long long)s == best ? a0 : row[s];
    __syncthreads();
  }
}

static int head_words(const void* p) { return (int)(((16 - ((uintptr_t)p & 15)) & 15) / 4); }

// The current device's SM count, with every configuration's shared-memory
// attribute set, once a device.
static cudaError_t device_sms(int* sms) {
  static int sm_count[EP_MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= EP_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    const void* fns[] = {(const void*)k_elect_preferred<int, FLAGS_BYTES>,
                         (const void*)k_elect_preferred<int, FLAGS_GLOBAL>,
                         (const void*)k_elect_preferred<long long, FLAGS_BYTES>,
                         (const void*)k_elect_preferred<long long, FLAGS_GLOBAL>};
    for (const void* f : fns) {
      e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, EP_SMEM_MAX);
      if (e != cudaSuccess) return e;
    }
    int n = 0;
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    sm_count[dev] = n;
  }
  *sms = sm_count[dev];
  return cudaSuccess;
}

#define EP_LAUNCH(I, MODE) \
  k_elect_preferred<I, MODE><<<(unsigned)blocks, EP_THREADS, smem, stream>>>(g)

// The u32 words of the bits workspace for B brokers.
CC_EXPORT long long elect_preferred_workspace_words(long long b) { return (b + 31) / 32; }

// assignment i32[P, R] (4-byte aligned), demoted bool[B], dead bool[B], out
// i32[P, R] (not overlapping the assignment), bits: a workspace of
// elect_preferred_workspace_words(B) u32, read only past EP_BYTE_FLAGS
// brokers or EP_TILE_WORDS / 4 slots a row (null otherwise); flags: 0 to
// choose by B, else FLAGS_BYTES (B <= EP_BYTE_FLAGS) or FLAGS_GLOBAL. B >= 1
// when P >= 1.
CC_EXPORT int elect_preferred(const void* assignment, const void* demoted, const void* dead,
                              void* out, void* bits, long long p, long long r, long long b,
                              long long flags, cudaStream_t stream) {
  if (p < 0 || r <= 0 || b < 0 || flags < FLAGS_AUTO || flags > FLAGS_GLOBAL ||
      p > 0x7FFFFFFFFFFFFFFFLL / r)
    return cudaErrorInvalidValue;
  if (p == 0) return cudaSuccess;
  if (b == 0) return cudaErrorInvalidValue;  // every row reads broker 0's flags
  if (b > 0x80000000LL) b = 0x80000000LL;    // brokers past any i32 id are never read
  const int mode = flags != FLAGS_AUTO ? (int)flags
                   : b <= EP_BYTE_FLAGS ? FLAGS_BYTES
                                        : FLAGS_GLOBAL;
  if (mode == FLAGS_BYTES && b > EP_BYTE_FLAGS) return cudaErrorInvalidValue;
  EpArgs g;
  g.in = (const int*)assignment;
  g.out = (int*)out;
  g.demoted = (const unsigned char*)demoted;
  g.dead = (const unsigned char*)dead;
  g.bits = (const unsigned int*)bits;
  g.p = p;
  g.r = r;
  g.b = b;
  g.n = p * r;
  g.rows = EP_TILE * r <= EP_TILE_WORDS ? EP_TILE : (EP_TILE_WORDS / r) & ~3LL;
  const bool wide = g.rows < 4;
  g.tiles = wide ? 0 : (p + g.rows - 1) / g.rows;
  g.head_in = head_words(assignment);
  g.head_out = head_words(out);
  g.vec_flags = ((uintptr_t)demoted & 15) == 0 && ((uintptr_t)dead & 15) == 0;
  g.flag_bytes = mode == FLAGS_BYTES ? (int)((b + 15) / 16 * 16) : 0;
  if (wide || mode != FLAGS_BYTES) {
    if (bits == nullptr) return cudaErrorInvalidValue;
    k_merge_bits<<<(unsigned)((b + 32 * EP_THREADS - 1) / (32 * EP_THREADS)), EP_THREADS, 0,
                   stream>>>(g.demoted, g.dead, (unsigned int*)bits, b, g.vec_flags);
  }
  int sms = 0;
  cudaError_t e = device_sms(&sms);
  if (e != cudaSuccess) return e;
  const long long most = (long long)sms * EP_BLOCKS_PER_SM;
  const bool small = g.n + EP_TILE_WORDS < 0x7FFFFFFFLL;
  if (wide) {
    const long long blocks = p < most ? p : most;
    if (small) k_elect_wide<int><<<(unsigned)blocks, EP_THREADS, 0, stream>>>(g);
    else k_elect_wide<long long><<<(unsigned)blocks, EP_THREADS, 0, stream>>>(g);
    return cudaGetLastError();
  }
  const long long blocks = g.tiles < most ? g.tiles : most;
  const size_t smem = (size_t)g.flag_bytes + 4 * (size_t)(g.rows * r) + 16;
  if (small) {
    if (mode == FLAGS_BYTES) EP_LAUNCH(int, FLAGS_BYTES);
    else EP_LAUNCH(int, FLAGS_GLOBAL);
  } else {
    if (mode == FLAGS_BYTES) EP_LAUNCH(long long, FLAGS_BYTES);
    else EP_LAUNCH(long long, FLAGS_GLOBAL);
  }
  return cudaGetLastError();
}
