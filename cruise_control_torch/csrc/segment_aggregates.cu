// K1 segment_aggregates: every per-broker / per-rack / per-topic summary of
// an assignment, from the P*R replica slots.
//
// Replaces: cruise_control_tpu/analyzer/context.py compute_aggregates (:276),
// the segment sums XLA runs over the flat slot axis.
//
// Bound on this card: bytes. The work is one pass over the slots (assignment,
// part_load rows) plus writing the outputs, of which the dense count tables
// rack_replica_count i32[P, NR] and topic_replica_count i32[T, B] are almost
// all the bytes (about 84 MB at 199,518 partitions, 52 racks, 4,000 topics,
// 2,600 brokers: ~0.027 ms at 3.35 TB/s). Arithmetic is a few adds per slot.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md §6): 0.081-0.089 ms at
// that shape (the two library sorts and a thread per broker before it took
// 0.481 ms): rack rows ~18 us, runs ~19, memset ~14, the walk ~38 (14 of it
// the topic atomics), hosts ~2; a broker holding half the slots 2.86 ms.
//
// The order: each float sum equals the CPU reference bit for bit, so each
// broker's members are added in ascending flat slot index p * R + s (the
// order of XLA:CPU's segment_sum and of index_add_ on the CPU), from +0.0;
// its leaders (s == 0) are its members' subsequence, so leader_count and
// leader_nw_in come from the same walk (a follower adds +0.0 to the leader
// NW_IN column, which changes no sum that starts at +0.0). host_cpu_load
// adds broker_load[:, CPU] over each host's brokers in broker order.
//
// Design: four launches and a memset, no sort outside the kernels.
//   k_seg_racks  a warp takes up to 32 partitions at a time: its lanes
//                count their slots' racks into a zeroed tile of the rows in
//                shared memory, and the warp writes the rows of
//                rack_replica_count whole, 16 bytes a lane: no memset and
//                no atomic in device memory.
//   k_seg_runs   buckets the slots by broker and the brokers by host: a
//                block takes a chunk of 4,096 slots (or brokers), sorts
//                (broker, offset) pairs by broker with CUB's block radix
//                sort, which is stable, so each broker's run keeps slot
//                order, and writes the offsets sorted and its row of the
//                [chunks, B] runs table, (start << 16) | count by binary
//                search of the sorted keys: no global atomic. Empty slots
//                (-1) sort past every broker and start no run. Two blocks
//                an SM.
//   (memset)     zeroes topic_replica_count for the walk's atomics.
//   k_seg_sums   a warp per broker: the lanes load 32 runs at once, scan
//                their counts, then load the members 64 at a time (each
//                lane finds its member's run by binary search in shared
//                memory and loads the part_load row at once) and stage six
//                columns (four loads, potential NW_OUT, leader NW_IN) in
//                shared memory; lanes 0-5 then add their column's terms in
//                order; each member counts in the topic table with an
//                integer atomic (exact in any order). A broker
//                with more than 2,048 members takes the whole block of four
//                warps, 1,024 members at a time, after the block's other
//                brokers.
//   k_seg_host   a thread per host adds its brokers' CPU loads from the
//                hosts' runs, in broker order.
#include <cub/block/block_radix_sort.cuh>

#include "common.cuh"

constexpr int K1_THREADS = 512;
constexpr int K1_ITEMS = 8;
constexpr int K1_CHUNK = K1_THREADS * K1_ITEMS;  // slots (or brokers) a runs block sorts
constexpr int K1_RACK_THREADS = 128;
constexpr int K1_RACK_BLOCKS = 1056;  // the most blocks that write rack rows
constexpr int K1_RACK_TILE = 2048;    // a warp's tile of rack cells, ints
typedef cub::BlockRadixSort<unsigned int, K1_THREADS, K1_ITEMS, unsigned short> K1Sort;

constexpr int K1_SUM_THREADS = 128;
constexpr int K1_SUM_WARPS = K1_SUM_THREADS / 32;
constexpr int K1_WARP_PER = 2;    // members a lane loads at a time
constexpr int K1_BLOCK_PER = 8;   // members a thread loads at a time, for a heavy broker
constexpr int K1_HEAVY = 2048;    // a broker with more members takes the block
constexpr int K1_COLS = 6;        // cpu, nw_in, nw_out, disk, potential nw_out, leader nw_in
constexpr int K1_RUNS = 1;        // runs a thread of the walk loads at a time

struct RunsArgs {
  const int *assignment, *broker_host;
  long long n_slots, slot_blocks, host_blocks;
  int R, B, H;
  unsigned int *runs_s, *runs_h;    // [slot_blocks, B], [host_blocks, H]
  unsigned short *idx_s, *idx_h;    // [blocks * K1_CHUNK]: offsets in the chunk, sorted
};

__device__ __forceinline__ int lower_bound(const unsigned int* a, int n, unsigned int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int key_bits(unsigned int sentinel) {
  return 32 - __clz(sentinel);
}

// rack_replica_count row by row: a warp takes a group of rows at a time (as
// many as make K1_RACK_TILE cells, at most 32). It zeroes the group's cells
// in a shared-memory tile, each lane counts its slots' racks into it
// (shared-memory atomics, exact in any order), and the warp writes the tile
// whole, 16 bytes a lane where the rows are 16-byte aligned: no memset and
// no atomic in device memory. A row wider than the tile is counted cell by
// cell from its slots.
__global__ void __launch_bounds__(K1_RACK_THREADS)
    k_seg_racks(const int* __restrict__ assignment, const int* __restrict__ broker_rack,
                long long P, int R, int B, int NR, int* __restrict__ rack_count) {
  constexpr int WARPS = K1_RACK_THREADS / 32;
  __shared__ __align__(16) int s_tile[WARPS][K1_RACK_TILE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* tile = s_tile[warp];
  const bool tiled = NR <= K1_RACK_TILE;
  const int rows = tiled ? min(32, K1_RACK_TILE / NR) : 1;
  const bool vec = (reinterpret_cast<uintptr_t>(rack_count) & 15) == 0;
  for (long long p0 = ((long long)blockIdx.x * WARPS + warp) * rows; p0 < P;
       p0 += (long long)gridDim.x * WARPS * rows) {
    const int nrows = (int)min((long long)rows, P - p0);
    const int cells = nrows * NR;
    const int* a0 = assignment + p0 * R;
    int* out = rack_count + p0 * NR;
    if (!tiled) {
      for (int k = lane; k < NR; k += 32) {
        int cnt = 0;
        for (int s2 = 0; s2 < R; ++s2) {
          const int a = __ldg(a0 + s2);
          cnt += a >= 0 && a < B && __ldg(broker_rack + a) == k ? 1 : 0;
        }
        out[k] = cnt;
      }
      continue;
    }
    for (int c = lane * 4; c < cells; c += 128)
      *reinterpret_cast<int4*>(tile + c) = make_int4(0, 0, 0, 0);
    __syncwarp();
    for (int j = lane; j < nrows * R; j += 32) {
      const int a = __ldg(a0 + j);
      if (a >= 0 && a < B) {
        const int rk = __ldg(broker_rack + a);
        if (rk >= 0 && rk < NR) atomicAdd(tile + (j / R) * NR + rk, 1);
      }
    }
    __syncwarp();
    int c = lane;
    if (vec && ((p0 * NR) & 3) == 0) {
      for (int c4 = lane; c4 < cells / 4; c4 += 32)
        reinterpret_cast<int4*>(out)[c4] = reinterpret_cast<const int4*>(tile)[c4];
      c = cells / 4 * 4 + lane;
    }
    for (; c < cells; c += 32) out[c] = tile[c];
    __syncwarp();  // the tile is free again
  }
}

__global__ void __launch_bounds__(K1_THREADS, 2) k_seg_runs(RunsArgs g) {
  __shared__ union {
    K1Sort::TempStorage sort;
    unsigned int keys[K1_CHUNK];
  } s;
  const int tid = threadIdx.x;
  const long long blk = blockIdx.x;
  const bool slots = blk < g.slot_blocks;
  const long long chunk = slots ? blk : blk - g.slot_blocks;
  const long long n = slots ? g.n_slots : g.B;
  const unsigned int sentinel = (unsigned int)(slots ? g.B : g.H);
  const long long i0 = chunk * K1_CHUNK + (long long)tid * K1_ITEMS;
  // this thread's items i0 .. i0 + 7 (a blocked arrangement: the sort keeps
  // their order among equal keys)
  unsigned int key[K1_ITEMS];
  unsigned short off[K1_ITEMS];
#pragma unroll
  for (int j = 0; j < K1_ITEMS; ++j) {
    const long long i = i0 + j;
    const int k = i < n ? (slots ? g.assignment[i] : g.broker_host[i]) : -1;
    const bool ok = k >= 0 && (unsigned int)k < sentinel;
    key[j] = ok ? (unsigned int)k : sentinel;
    off[j] = (unsigned short)(tid * K1_ITEMS + j);
  }
  K1Sort(s.sort).SortBlockedToStriped(key, off, 0, key_bits(sentinel));
  __syncthreads();  // the sort's storage becomes the sorted keys
  unsigned short* idx = (slots ? g.idx_s : g.idx_h) + chunk * K1_CHUNK;
#pragma unroll
  for (int j = 0; j < K1_ITEMS; ++j) {
    s.keys[j * K1_THREADS + tid] = key[j];
    idx[j * K1_THREADS + tid] = off[j];
  }
  __syncthreads();
  unsigned int* row = (slots ? g.runs_s : g.runs_h) + chunk * sentinel;
  for (unsigned int b = tid; b < sentinel; b += K1_THREADS) {
    const int lo = lower_bound(s.keys, K1_CHUNK, b), hi = lower_bound(s.keys, K1_CHUNK, b + 1);
    row[b] = ((unsigned int)lo << 16) | (unsigned int)(hi - lo);
  }
}

struct SumArgs {
  const float* part_load;
  const int* topic_id;
  int* topic_count;           // [T, B], zero: the walk counts each member in it
  const unsigned int* runs;    // [G, B]
  const unsigned short* idx;   // [G * K1_CHUNK]
  long long G;
  int B, R;
  float *broker_load, *potential, *leader_nw_in;
  int *replica_count, *leader_count;
};

template <int NT>
__device__ __forceinline__ void group_sync() {
  if (NT == 32) __syncwarp(); else __syncthreads();
}

// An exclusive scan of v over the group's NT threads (t: the thread's rank),
// with the group's total
template <int NT>
__device__ __forceinline__ int group_scan(int v, int t, int* s_tot, int& total) {
  const unsigned full = 0xffffffffu;
  const int lane = t & 31;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(full, x, o);
    if (lane >= o) x += y;
  }
  if (NT == 32) {
    total = __shfl_sync(full, x, 31);
    return x - v;
  }
  const int w = t >> 5;
  if (lane == 31) s_tot[w] = x;
  __syncthreads();
  int base = 0;
  total = 0;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) {
    const int u = s_tot[i];
    base += i < w ? u : 0;
    total += u;
  }
  __syncthreads();  // s_tot is free again
  return base + x - v;
}

// Broker b's sums by a group of NT threads (a warp, or the block), PER
// members a thread at a time. s_col: K1_COLS columns of NT * PER + 1 floats
// (the odd stride keeps the six adding lanes on six banks); s_e, s_pos: NT *
// K1_RUNS entries; s_tot: a word a warp.
template <int NT, int PER>
__device__ __forceinline__ void walk(const SumArgs& g, int b, int t, float* s_col, int* s_e,
                                     long long* s_pos, int* s_tot) {
  constexpr int CAP = NT * PER, STRIDE = CAP + 1, WIN = NT * K1_RUNS;
  float acc = 0.0f;  // thread t < K1_COLS: column t's sum
  long long members = 0;
  int leads = 0;
  for (long long g0 = 0; g0 < g.G; g0 += WIN) {
    // runs g0 .. g0 + WIN - 1, K1_RUNS a thread; member j of run u is at
    // s_pos[u] + j of the sorted offsets
    unsigned int r[K1_RUNS];
    int mine = 0;
#pragma unroll
    for (int q = 0; q < K1_RUNS; ++q) {
      const long long gi = g0 + t * K1_RUNS + q;
      r[q] = gi < g.G ? __ldg(g.runs + gi * g.B + b) : 0u;
      mine += (int)(r[q] & 0xffffu);
    }
    int total;
    int e = group_scan<NT>(mine, t, s_tot, total);
#pragma unroll
    for (int q = 0; q < K1_RUNS; ++q) {
      const long long gi = g0 + t * K1_RUNS + q;
      s_e[t * K1_RUNS + q] = e;
      s_pos[t * K1_RUNS + q] = gi * K1_CHUNK + (long long)(r[q] >> 16) - e;
      e += (int)(r[q] & 0xffffu);
    }
    group_sync<NT>();
    for (int j0 = 0; j0 < total; j0 += CAP) {
      float v[PER][K1_COLS];
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int j = min(j0 + q * NT + t, total - 1);
        int lo = 0;  // the last run whose first member is <= j (s_e[0] = 0)
#pragma unroll
        for (int step = WIN / 2; step > 0; step >>= 1) lo = s_e[lo + step] <= j ? lo + step : lo;
        const long long pos = s_pos[lo] + j;
        const long long slot = (pos & ~(long long)(K1_CHUNK - 1)) + __ldg(g.idx + pos);
        const long long p = slot / g.R;
        const bool lead = slot == p * g.R;
        const float* pl = g.part_load + p * NUM_PART_METRICS;
        const int tp = __ldg(g.topic_id + p);
        const float cl = __ldg(pl + CPU_LEADER), cf = __ldg(pl + CPU_FOLLOWER);
        const float il = __ldg(pl + NW_IN_LEADER), inf_ = __ldg(pl + NW_IN_FOLLOWER);
        const float ol = __ldg(pl + NW_OUT_LEADER), dk = __ldg(pl + DISK);
        v[q][RES_CPU] = lead ? cl : cf;
        v[q][RES_NW_IN] = lead ? il : inf_;
        v[q][RES_NW_OUT] = lead ? ol : 0.0f;
        v[q][RES_DISK] = dk;
        v[q][4] = ol;
        v[q][5] = lead ? il : 0.0f;
        if (j0 + q * NT + t < total) {
          leads += lead ? 1 : 0;
          atomicAdd(&g.topic_count[(long long)tp * g.B + b], 1);
        }
      }
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int j = j0 + q * NT + t;
        if (j < total)
#pragma unroll
          for (int c = 0; c < K1_COLS; ++c) s_col[c * STRIDE + j - j0] = v[q][c];
      }
      group_sync<NT>();
      if (t < K1_COLS) {  // the chain, 16 terms loaded ahead of the 16 being added
        const float* col = s_col + t * STRIDE;
        const int m = min(CAP, total - j0);
        int k = 0;
        if (m >= 16) {
          float x[16];
#pragma unroll
          for (int u = 0; u < 16; ++u) x[u] = col[u];
          for (k = 16; k + 16 <= m; k += 16) {
            float y[16];
#pragma unroll
            for (int u = 0; u < 16; ++u) y[u] = col[k + u];
#pragma unroll
            for (int u = 0; u < 16; ++u) acc = __fadd_rn(acc, x[u]);
#pragma unroll
            for (int u = 0; u < 16; ++u) x[u] = y[u];
          }
#pragma unroll
          for (int u = 0; u < 16; ++u) acc = __fadd_rn(acc, x[u]);
        }
        for (; k < m; ++k) acc = __fadd_rn(acc, col[k]);
      }
      group_sync<NT>();
    }
    members += total;
  }
  int lead_total;
  group_scan<NT>(leads, t, s_tot, lead_total);
  if (t < 4) g.broker_load[(long long)b * 4 + t] = acc;
  if (t == 4) g.potential[b] = acc;
  if (t == 5) g.leader_nw_in[b] = acc;
  if (t == 0) {
    g.replica_count[b] = (int)members;
    g.leader_count[b] = lead_total;
  }
}

__global__ void __launch_bounds__(K1_SUM_THREADS) k_seg_sums(SumArgs g) {
  __shared__ float s_col[K1_COLS * (K1_SUM_THREADS * K1_BLOCK_PER + 1)];
  __shared__ int s_e[K1_SUM_THREADS * K1_RUNS];
  __shared__ long long s_pos[K1_SUM_THREADS * K1_RUNS];
  __shared__ int s_tot[K1_SUM_WARPS];
  __shared__ int s_heavy[K1_SUM_WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * K1_SUM_WARPS + warp;
  bool heavy = false;
  if (b < g.B) {
    // the broker's member count, to find a heavy one
    long long n = 0;
    for (long long gi = lane; gi < g.G; gi += 32) n += __ldg(g.runs + gi * g.B + b) & 0xffffu;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
    heavy = n > K1_HEAVY;
    if (!heavy)
      walk<32, K1_WARP_PER>(g, (int)b, lane, s_col + warp * K1_COLS * (32 * K1_WARP_PER + 1),
                            s_e + warp * 32 * K1_RUNS, s_pos + warp * 32 * K1_RUNS, nullptr);
  }
  if (lane == 0) s_heavy[warp] = heavy ? (int)b : -1;
  __syncthreads();
  for (int w = 0; w < K1_SUM_WARPS; ++w) {
    const int hb = s_heavy[w];
    if (hb >= 0) walk<K1_SUM_THREADS, K1_BLOCK_PER>(g, hb, threadIdx.x, s_col, s_e, s_pos, s_tot);
  }
}

// host_cpu_load: host h adds the CPU loads of its brokers (its runs over the
// brokers' chunks) in broker order, from +0.0
__global__ void __launch_bounds__(128) k_seg_host(const unsigned int* runs_h,
                                                  const unsigned short* idx_h, long long Gh,
                                                  int H, const float* broker_load,
                                                  float* host_cpu) {
  const long long h = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float acc = 0.0f;
  for (long long gi = 0; gi < Gh; ++gi) {
    const unsigned int r = runs_h[gi * H + h];
    const long long base = gi * K1_CHUNK;
    const unsigned short* run = idx_h + base + (r >> 16);
    for (unsigned int k = 0; k < (r & 0xffffu); ++k)
      acc = __fadd_rn(acc, broker_load[(base + run[k]) * 4 + RES_CPU]);
  }
  host_cpu[h] = acc;
}

// The scratch layout: the slots' and the brokers' runs tables (u32), then
// their sorted offsets (u16).
struct K1Scratch {
  long long G, Gh, runs_s, runs_h, idx_s, idx_h, bytes;  // offsets in bytes
};

static K1Scratch k1_scratch(long long P, long long R, long long B, long long H) {
  K1Scratch k;
  k.G = (P * R + K1_CHUNK - 1) / K1_CHUNK;
  k.Gh = (B + K1_CHUNK - 1) / K1_CHUNK;
  k.runs_s = 0;
  k.runs_h = k.runs_s + 4 * k.G * B;
  k.idx_s = k.runs_h + 4 * k.Gh * H;
  k.idx_h = k.idx_s + 2 * k.G * K1_CHUNK;
  k.bytes = k.idx_h + 2 * k.Gh * K1_CHUNK;
  return k;
}

// The scratch bytes a call on these sizes needs.
CC_EXPORT long long segment_aggregates_scratch_bytes(long long P, long long R, long long B,
                                                     long long H) {
  return k1_scratch(P, R, B, H).bytes;
}

// assignment i32[P, R], part_load f32[P, 6], topic_id i32[P], broker_rack
// i32[B], broker_host i32[B]; outputs broker_load f32[B, 4], replica_count
// i32[B], leader_count i32[B], potential f32[B], leader_nw_in f32[B],
// rack_count i32[P, NR], topic_count i32[T, B], host_cpu f32[H]; scratch of
// segment_aggregates_scratch_bytes(P, R, B, H) bytes (every word the
// kernels read, they write first).
CC_EXPORT int segment_aggregates(const int* assignment, const float* part_load,
                                 const int* topic_id, const int* broker_rack,
                                 const int* broker_host, float* broker_load, int* replica_count,
                                 int* leader_count, float* potential, float* leader_nw_in,
                                 int* rack_count, int* topic_count, float* host_cpu,
                                 void* scratch, long long P, long long R, long long B,
                                 long long NR, long long H, long long T, cudaStream_t stream) {
  if (P < 0 || R < 1 || R > 0x7fffffffLL || B < 0 || B >= 0x7fffffffLL || NR < 1 ||
      NR > 0x7fffffffLL || H < 0 || H >= 0x7fffffffLL || T < 0)
    return cudaErrorInvalidValue;
  const K1Scratch k = k1_scratch(P, R, B, H);
  char* base = static_cast<char*>(scratch);
  RunsArgs ra;
  ra.assignment = assignment;
  ra.broker_host = broker_host;
  ra.n_slots = P * R;
  ra.R = (int)R;
  ra.B = (int)B;
  ra.H = (int)H;
  ra.slot_blocks = B > 0 ? k.G : 0;
  ra.host_blocks = H > 0 ? k.Gh : 0;
  ra.runs_s = reinterpret_cast<unsigned int*>(base + k.runs_s);
  ra.runs_h = reinterpret_cast<unsigned int*>(base + k.runs_h);
  ra.idx_s = reinterpret_cast<unsigned short*>(base + k.idx_s);
  ra.idx_h = reinterpret_cast<unsigned short*>(base + k.idx_h);
  cudaError_t e;
  if (P > 0) {
    const long long rows =
        NR <= K1_RACK_TILE ? (K1_RACK_TILE / NR < 32 ? K1_RACK_TILE / NR : 32) : 1;
    const long long groups = (P + rows - 1) / rows, per_block = K1_RACK_THREADS / 32;
    const long long blocks = (groups + per_block - 1) / per_block;
    k_seg_racks<<<(unsigned)(blocks < K1_RACK_BLOCKS ? blocks : K1_RACK_BLOCKS), K1_RACK_THREADS,
                  0, stream>>>(assignment, broker_rack, P, (int)R, (int)B, (int)NR, rack_count);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (ra.slot_blocks + ra.host_blocks > 0) {
    k_seg_runs<<<(unsigned)(ra.slot_blocks + ra.host_blocks), K1_THREADS, 0, stream>>>(ra);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  // the topic table last before the walk that counts in it
  if (T * B > 0 &&
      (e = cudaMemsetAsync(topic_count, 0, sizeof(int) * T * B, stream)) != cudaSuccess)
    return e;
  if (B > 0) {
    SumArgs sa;
    sa.part_load = part_load;
    sa.topic_id = topic_id;
    sa.topic_count = topic_count;
    sa.runs = ra.runs_s;
    sa.idx = ra.idx_s;
    sa.G = k.G;
    sa.B = (int)B;
    sa.R = (int)R;
    sa.broker_load = broker_load;
    sa.potential = potential;
    sa.leader_nw_in = leader_nw_in;
    sa.replica_count = replica_count;
    sa.leader_count = leader_count;
    k_seg_sums<<<(unsigned)((B + K1_SUM_WARPS - 1) / K1_SUM_WARPS), K1_SUM_THREADS, 0, stream>>>(
        sa);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (H > 0) {
    k_seg_host<<<(unsigned)((H + 127) / 128), 128, 0, stream>>>(ra.runs_h, ra.idx_h, k.Gh,
                                                              (int)H, broker_load, host_cpu);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}
