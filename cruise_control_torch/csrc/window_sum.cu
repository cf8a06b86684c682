// window_sum: column sums of a float32 matrix, each taken in XLA:CPU's order
// (windows of 32 in index order from +0.0, then the window sums the same way;
// kernels/window_sum.py states the order).
//
// Replaces: the jnp.sum reductions behind the soft goals' balance windows and
// costs (cruise_control_tpu/analyzer/goals/soft.py ResourceDistributionGoal
// .prepare :63-64, LeaderBytesInDistributionGoal.prepare :462 and
// .bulk_counts :516, the goals' `cost`), the capacity goals' costs
// (goals/hard.py :198, :206) and the per-resource means of analyzer/drain.py
// :214 and :278. The windows decide which brokers are out of bounds, so the
// port sums in the order the reference's compiler does, on every device.
//
// Bound on this card: latency. The inputs are a few thousand floats (one per
// broker) or 199,518 (one per partition, the mean leader weight): a call
// costs the launch plus one round of loads and one chain of 32 dependent
// adds per level.
//
// Design: one launch for the whole tree. Level 1 is spread over the card: a
// block takes up to 256 (window, column) pairs, CT columns (a power of two,
// at most 32) by 256 / CT windows. Each thread loads its up to 32 terms of
// the block's tile at once (coalesced along the contiguous column axis) and
// stores them to shared memory, each window's 32 terms at a stride of 33
// words (CT words to a term) so that neither the staging nor the summing
// threads meet a bank conflict; each thread then sums its window from shared
// memory. The zero padding is staged as +0.0 and added: a sum that starts at
// +0.0 is never -0.0, so adding +0.0 changes nothing (NaN and infinities
// stay as they are). With one block the level-1 sums stay in shared memory.
// With several, they go to a global scratch [nw, cols], and the last block
// of a column tile to finish (an atomic ticket after __threadfence, reset by
// that block) copies them back into shared memory where they fit. The later
// levels run there (over the scratch where they do not fit), then the final
// add of 32 or fewer terms. Columns of 32 or fewer terms are added in index
// order by one thread each, or, for a reduce that XLA fuses with its
// producers (a goal's cost), in the vectorized loop's order: the first
// `lanes` terms in 8 lanes, the lanes added by halves, then the rest one by
// one (kernels/window_sum.py `FusedOrder`). Any n < 2**31 and any column
// count: past 65,535 column tiles each row of the grid takes its tiles in
// turn.
#include "common.cuh"

constexpr int WS_THREADS = 256;
constexpr int WS_STRIDE = 33;                    // words per window in the tile
constexpr int WS_TILE = WS_THREADS * WS_STRIDE;  // floats of the staging tile
constexpr int WS_GROUP = 32;                     // loads a thread issues at once
constexpr int WS_SMALL = WS_THREADS + 8;         // a level of at most 256 sums, padded

template <bool L2>
__device__ __forceinline__ float ld(const float* p) {
  return L2 ? __ldcg(p) : *p;
}

// The index type: 32-bit where every element index n * cols fits, else 64
template <bool WIDE>
struct IndexOf {
  typedef int T;
};
template <>
struct IndexOf<true> {
  typedef long long T;
};

// One window: terms base .. base + 31 of column c (term i at src[pos(i) *
// stride + c], pos(i) = i, or i + i / 32 where PAD, zero outside [0, len))
// added in index order from +0.0. Every load is issued, at a clamped
// address, before the first add. L2: the scratch that other blocks wrote,
// read at L2 past this SM's L1. PAD: one word of padding every 32 terms, so
// that the threads of a warp, each on its own window, meet no bank conflict.
template <bool L2, bool PAD, typename Ix>
__device__ __forceinline__ float window(const float* src, int base, Ix stride, int len, Ix c) {
  float v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    int i = base + k, ic = min(max(i, 0), len - 1);
    float t = ld<L2>(src + (PAD ? ic + (ic >> 5) : ic) * stride + c);
    v[k] = i >= 0 && i < len ? t : 0.0f;
  }
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < 32; ++k) acc = __fadd_rn(acc, v[k]);
  return acc;
}

// Terms 0 .. n - 1 (n <= 32) of column c in the vectorized loop's order: the
// first `lanes` (a multiple of 8) in 8 lanes, lane j adding the terms j, j +
// 8, ... from +0.0, the lanes added by halves (j and j + 4, j + 2, j + 1),
// then the terms from `lanes` on one by one. Every load is issued first.
template <typename Ix>
__device__ __forceinline__ float lane_sum(const float* src, int n, int lanes, Ix stride, Ix c) {
  float v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    float t = src[(Ix)min(k, n - 1) * stride + c];
    v[k] = k < n ? t : 0.0f;
  }
  float acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < 32; ++k)
    if (k < lanes) acc[k & 7] = __fadd_rn(acc[k & 7], v[k]);
#pragma unroll
  for (int h = 4; h >= 1; h >>= 1)
#pragma unroll
    for (int j = 0; j < h; ++j) acc[j] = __fadd_rn(acc[j], acc[j + h]);
  float s = acc[0];
#pragma unroll
  for (int k = 0; k < 32; ++k)
    if (k >= lanes && k < n) s = __fadd_rn(s, v[k]);
  return s;
}

// Windows [w0, w0 + nwl) (nwl <= 256 / CT) of the terms src[i * stride + col],
// i = w * 32 + k - lo, zero outside [0, len), for the block's CT columns
// c0 + c < cols: staged through the tile, coalesced along the columns, 33
// words a window, then summed; returns the sum of the calling thread's
// (window tid / CT, column tid % CT), 0 where it has none. Block-wide.
template <bool L2, typename Ix>
__device__ float stage_sum(const float* src, Ix stride, int len, int lo, int w0, int nwl, Ix c0,
                          Ix cols, int ct_shift, float* tile) {
  const int ct = 1 << ct_shift, tid = threadIdx.x, c = tid & (ct - 1);
  const Ix col = min(c0 + c, cols - 1);
  const int r0 = tid >> ct_shift, step = WS_THREADS >> ct_shift;
  const bool col_ok = c0 + c < cols;
  const int rows = nwl * 32;
  for (int j0 = 0; j0 * step < rows; j0 += WS_GROUP) {
    float v[WS_GROUP];
#pragma unroll
    for (int q = 0; q < WS_GROUP; ++q) {
      const int r = r0 + (j0 + q) * step;
      const Ix i = (Ix)w0 * 32 + r - lo;
      float t = ld<L2>(src + min(max(i, (Ix)0), (Ix)len - 1) * stride + col);
      v[q] = r < rows && i >= 0 && i < len && col_ok ? t : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < WS_GROUP; ++q) {
      int r = r0 + (j0 + q) * step;
      if (r < rows) tile[ct * (r + (r >> 5)) + c] = v[q];
    }
  }
  __syncthreads();
  float acc = 0.0f;
  if (r0 < nwl && col_ok) acc = window<false, false, Ix>(tile + ct * r0 * WS_STRIDE, 0, ct, 32, c);
  __syncthreads();  // the tile is free again
  return acc;
}

// Column tile ty of CT columns (c0 = ty * CT), by the blocks of one grid
// row. WIDE: 64-bit element indices, where n * cols does not fit 32 bits or
// the tiles outnumber the grid's rows.
template <bool WIDE>
__device__ __forceinline__ void column_tile(const float* __restrict__ x, int n,
                                            typename IndexOf<WIDE>::T cols, int ct_shift,
                                            int lanes, long long ty, float* __restrict__ scratch,
                                            unsigned int* tickets, float* __restrict__ out,
                                            float* tile, float (*small)[WS_SMALL], bool* s_last) {
  typedef typename IndexOf<WIDE>::T Ix;
  const int tid = threadIdx.x;
  const int ct = 1 << ct_shift, wb = WS_THREADS >> ct_shift;
  const int c = tid & (ct - 1), wl = tid >> ct_shift;
  // level 1: this block's windows [w0, w0 + nwl) (n < 2**31)
  const int nw = (int)(((long long)n + 31) >> 5), lo = (int)(((long long)nw * 32 - n) / 2);
  const int w0 = blockIdx.x * wb, nwl = min(wb, nw - w0);
  const bool one_block = gridDim.x == 1;
  const Ix c0 = (Ix)ty * ct;
  const bool mine = c0 + c < cols;  // this thread's column exists

  if (n <= 32) {  // index order from +0.0 (one term is returned as it is), or the lanes'
    const Ix col = c0 + tid;
    if (tid < ct && col < cols)
      out[col] = n == 0    ? 0.0f
                 : lanes   ? lane_sum<Ix>(x, n, lanes, cols, col)
                 : n == 1  ? x[col]
                           : window<false, false, Ix>(x, 0, cols, n, col);
    return;
  }

  float acc = stage_sum<false, Ix>(x, cols, n, lo, w0, nwl, c0, cols, ct_shift, tile);
  if (wl < nwl && mine) {
    if (one_block)
      small[0][ct * (wl + (wl >> 5)) + c] = acc;
    else
      scratch[(long long)(w0 + wl) * cols + c0 + c] = acc;
  }
  if (!one_block) {  // the last block of this column tile runs the later levels
    __threadfence();
    __syncthreads();
    if (tid == 0) *s_last = atomicAdd(&tickets[ty], 1u) == gridDim.x - 1;
    __syncthreads();
    if (!*s_last) return;
    __threadfence();
    if (tid == 0) tickets[ty] = 0u;
  }
  __syncthreads();

  // the current level's sums: in small[buf] (padded, stride CT) or in the
  // scratch from offset gsrc (stride cols, read at L2)
  int len = nw, buf = 0;
  bool global = !one_block;
  long long gsrc = 0, gofs = (long long)nw * cols;  // the scratch past the sums written
  while (len > 32) {
    int m2 = (len + 31) / 32 * 32, lo2 = (m2 - len) / 2, nw2 = m2 / 32;
    bool to_small = nw2 * ct <= WS_THREADS;
    float* dst_small = small[buf ^ 1];
    if (global) {  // staged in passes of 256 / CT windows, as level 1
      for (int cw0 = 0; cw0 < nw2; cw0 += wb) {
        int cnwl = min(wb, nw2 - cw0), w = cw0 + wl;
        float a = stage_sum<true, Ix>(scratch + gsrc, cols, len, lo2, cw0, cnwl, c0, cols,
                                      ct_shift, tile);
        if (wl < cnwl && mine) {
          if (to_small)
            dst_small[ct * (w + (w >> 5)) + c] = a;
          else
            scratch[gofs + (long long)w * cols + c0 + c] = a;
        }
      }
    } else {  // from shared memory, one (window, column) a thread
      for (int t = tid; t < nw2 * ct; t += WS_THREADS) {
        int w = t >> ct_shift;
        if (!mine) continue;
        float a = window<false, true, Ix>(small[buf], w * 32 - lo2, ct, len, c);
        if (to_small)
          dst_small[ct * (w + (w >> 5)) + c] = a;
        else
          scratch[gofs + (long long)w * cols + c0 + c] = a;
      }
    }
    __syncthreads();
    if (to_small) {
      buf ^= 1;
      global = false;
    } else {
      gsrc = gofs;
      gofs += (long long)nw2 * cols;
      global = true;
    }
    len = nw2;
  }
  if (tid < ct && mine)
    out[c0 + c] = global ? window<true, false, Ix>(scratch + gsrc, 0, cols, len, c0 + c)
                         : window<false, true, Ix>(small[buf], 0, ct, len, c);
}

// Column tiles: grid row y takes the tiles y, y + gridDim.y, ... in turn
// (gridDim.y <= 65,535; only WIDE launches have more tiles than rows).
template <bool WIDE>
__global__ void __launch_bounds__(WS_THREADS)
    k_window_sum(const float* __restrict__ x, int n, long long cols, int ct_shift, int lanes,
                 long long tiles, float* __restrict__ scratch, unsigned int* tickets,
                 float* __restrict__ out) {
  __shared__ float tile[WS_TILE];
  __shared__ float small[2][WS_SMALL];
  __shared__ bool s_last;
  if (!WIDE) {
    column_tile<false>(x, n, (int)cols, ct_shift, lanes, blockIdx.y, scratch, tickets, out, tile,
                       small, &s_last);
    return;
  }
  for (long long ty = blockIdx.y; ty < tiles; ty += gridDim.y) {
    column_tile<true>(x, n, cols, ct_shift, lanes, ty, scratch, tickets, out, tile, small, &s_last);
    __syncthreads();  // the shared memory is free again for the next tile
  }
}

// x f32[n, cols] (row-major, contiguous, n < 2**31, any cols), out
// f32[cols]; scratch f32 of at least (n / 16 + 8) * cols floats (every
// level's sums); tickets u32 of at least ceil(cols / 32), all 0 (every
// launch leaves them at 0); lanes: 0, or the terms of a fused sum of n <= 32
// that the vectorized loop takes, a multiple of 8 up to n.
CC_EXPORT int window_sum(const float* x, float* out, float* scratch, unsigned int* tickets,
                         long long n, long long cols, long long lanes, cudaStream_t stream) {
  if (cols <= 0) return cudaSuccess;
  if (n < 0 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (lanes < 0 || lanes % 8 || lanes > n || (lanes && n > 32)) return cudaErrorInvalidValue;
  // CT: the columns a block takes, a power of two up to 32 that covers
  // cols, but no more than lets one block hold a short column's windows
  long long nw = (n + 31) / 32, wb;
  int ct_shift = 0;
  while ((1LL << ct_shift) < cols && ct_shift < 5 && nw << (ct_shift + 1) <= WS_THREADS) ++ct_shift;
  if (nw << ct_shift > WS_THREADS)
    while ((1LL << ct_shift) < cols && ct_shift < 5) ++ct_shift;
  long long tiles = (cols + (1LL << ct_shift) - 1) >> ct_shift;
  while (tiles > 65535 && ct_shift < 5) tiles = (cols + (2LL << ct_shift) - 1) >> ++ct_shift;
  wb = WS_THREADS >> ct_shift;
  // more than 65,535 column tiles: each grid row loops over its tiles
  dim3 grid(n <= 32 ? 1u : (unsigned)((nw + wb - 1) / wb),
            (unsigned)(tiles < 65535 ? tiles : 65535));
  if (tiles > 65535 || cols > 0x7fffffffLL || n * cols > 0x7fffffffLL - 64)
    k_window_sum<true><<<grid, WS_THREADS, 0, stream>>>(x, (int)n, cols, ct_shift, (int)lanes,
                                                       tiles, scratch, tickets, out);
  else
    k_window_sum<false><<<grid, WS_THREADS, 0, stream>>>(x, (int)n, cols, ct_shift, (int)lanes,
                                                        tiles, scratch, tickets, out);
  return cudaGetLastError();
}
