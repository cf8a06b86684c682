// K9 grid_shortlist: the greedy round's shortlist, in one pass over its whole
// candidate space.
//
// Replaces: cruise_control_tpu/analyzer/optimizer.py one_round (:357), its
// shortlist at :371-409: the [P, R, K] move grid (actions.make_move_batch x
// acceptance.score_batch), the first-occurrence argmax of each partition's
// R*K move cells (flattened slot*K + k), the [P, R-1] leadership grid, whose
// argmax wins only when strictly greater (:395), and lax.top_k(best, 1): the
// best partition, the lowest p among equal scores.
//
// Bound on this card: operations. Every cell is one combine of K3's source
// and destination halves (~100 operations, score_goal.cuh) and the distinct
// bytes are the model's rows once (assignment, part_load, rack counts) plus
// the per-broker words. The smoke model's grid has 199,518 x 3 x 16 move
// cells and 199,518 x 2 promotions, 10M scores; none of them is written to
// memory.
//
// Design: a warp takes a group of G = 32 / (2R) partitions at a time (5 at
// R = 3; one where 2R > 32). The block first stages the K destination
// candidates' halves in shared memory. Then, for the group, 2R lanes a
// partition (above R = 16, each lane ceil(2R / 32) of the roles in turn)
// load at once every half its cells share: R lanes the move source halves (one a slot)
// and the assignment row, R - 1 lanes the followers' destination halves,
// one lane the leader's source half; every lane then loads the move cells'
// pair words, one per (partition, candidate); and the lanes combine the
// group's R*K moves and R-1 promotions a partition (~8 cells a lane) into a
// score table in shared memory. Lane g then walks partition g's row of the
// table in the reference's order: the first maximum of the moves (cell =
// slot*K + k), the first maximum of the promotions, which wins only when
// strictly greater (a promotion's pair words are never read: combine()
// reads them only for moves). Each partition's best becomes a 64-bit key
// (the order-preserving bits of the score, ~p): -0.0 keys as +0.0, because
// jnp.argmax and lax.top_k count them equal, and the lowest p wins a tie.
// The warp keeps its best key over its groups, the block one record (key
// and the winner's score, kind, slot, destination): no atomic. Blocks walk
// the groups grid-stride, one wave of blocks on the card; a second launch
// of one block reduces the records and writes the winner. With every cell
// -inf the winner is p 0, slot 0, and the first destination candidate (kind
// MOVE), or broker 0 for a goal without moves, as the reference's initial
// values give. A block has K9_WARPS warps, fewer where a wide R and K would
// not fit their shared memory; where one warp's would not fit either (R of
// about 800 at K = 16, or thousands of candidates), a second configuration
// keeps every block's halves, pair words and score table in its own part of
// a device-memory workspace instead, K9_GLOBAL_BLOCKS blocks at most.
#include "score_goal.cuh"

constexpr int K9_WARPS = 4;  // a block's warps, at most
// the most dynamic shared memory a block of k_grid_bid takes
constexpr size_t K9_SMEM_MAX = 200 * 1024;
// the most blocks a launch uses (the size of the caller's record scratch)
constexpr int K9_MAX_BLOCKS = 4096;
// the most blocks of the device-memory configuration (the workspace's size)
constexpr int K9_GLOBAL_BLOCKS = 264;

struct GridArgs {
  ScoreCtx c;
  const int* dst_cands;  // i32[K]
  int P, K, G;           // G: partitions a warp takes at a time
  bool uses_moves, use_leadership;
  float* out_score;  // f32[1]
  int* out_idx;      // i32[4]: p, kind, slot, dst
};

// One partition's (or block's) best action; key as described above.
struct BlockBest {
  unsigned long long key;
  float score;
  int kind, slot, dst;
};

__device__ __forceinline__ unsigned int order_bits(float v) {
  unsigned int u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A warp's shared memory for a group of G partitions: the move source
// halves [G][R], the leader's source halves [G], the followers' destination
// halves [G][R-1], the move pair words [G][K], the rows [G][R] and the
// score table [G][R*K + R-1]; every part a multiple of 4 bytes.
__host__ __device__ __forceinline__ size_t warp_bytes(int R, int K, int G) {
  return (size_t)G * ((R + 1) * sizeof(SrcHalf) + (R - 1) * sizeof(DstHalf) +
                      K * sizeof(PairWords) + R * sizeof(int) + (R * K + R - 1) * sizeof(float));
}

// The bytes of a block's part: K DstHalfs and `warps` warps' parts (in the
// workspace, each block's part starts 16-byte aligned).
__host__ __device__ __forceinline__ size_t block_bytes(int R, int K, int G, int warps) {
  return (size_t)K * sizeof(DstHalf) + (size_t)warps * warp_bytes(R, K, G);
}
__host__ __device__ __forceinline__ size_t work_bytes(int R, int K, int G, int warps) {
  return (block_bytes(R, K, G, warps) + 15) / 16 * 16;
}

// WORK: the device-memory configuration, each block's part of `work`
// (block_bytes() a block) in place of its shared memory.
template <bool WORK>
__global__ void __launch_bounds__(K9_WARPS * 32)
    k_grid_bid(GridArgs g, BlockBest* blocks, char* work) {
  extern __shared__ int smem[];
  const int R = g.c.R, K = g.K, G = g.G, RK = R * K, C = RK + R - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  DstHalf* s_dst = reinterpret_cast<DstHalf*>(
      WORK ? work + blockIdx.x * work_bytes(R, K, G, warps) : reinterpret_cast<char*>(smem));
  char* w = reinterpret_cast<char*>(s_dst + K) + (size_t)warp * warp_bytes(R, K, G);
  SrcHalf* mv = reinterpret_cast<SrcHalf*>(w);
  SrcHalf* lead = mv + G * R;
  DstHalf* fol = reinterpret_cast<DstHalf*>(lead + G);
  PairWords* pw = reinterpret_cast<PairWords*>(fol + G * (R - 1));
  int* row = reinterpret_cast<int*>(pw + G * K);
  float* score = reinterpret_cast<float*>(row + G * R);
  __shared__ BlockBest s_best[K9_WARPS];
  if (g.uses_moves)
    for (int k = threadIdx.x; k < K; k += blockDim.x) s_dst[k] = dst_half(g.c, g.dst_cands[k]);
  __syncthreads();

  const unsigned full = 0xffffffffu;
  const Scalars sc = load_scalars(g.c);
  const int first_dst = g.uses_moves ? g.dst_cands[0] : 0;
  BlockBest wb{0ull, -INFINITY, KIND_MOVE, 0, 0};
  const long long stride = (long long)gridDim.x * warps * G;
  for (long long p0 = ((long long)blockIdx.x * warps + warp) * G; p0 < g.P; p0 += stride) {
    // 1. the halves, all of the group's at once (a lane a role; roles past
    //    the warp's 32 lanes in further turns)
    for (int j = lane; j < G * 2 * R; j += 32) {
      const int gi = j / (2 * R), role = j % (2 * R);
      if (p0 + gi >= g.P) continue;
      const int p = (int)(p0 + gi);
      const int* arow = g.c.assignment + (long long)p * R;
      if (role < R) {
        row[gi * R + role] = ld(arow + role);
        if (g.uses_moves) mv[gi * R + role] = src_half(g.c, p, KIND_MOVE, role);
      } else if (g.use_leadership) {
        if (role < 2 * R - 1)
          fol[gi * (R - 1) + role - R] = dst_half(g.c, ld(arow + role - R + 1), false);
        else
          lead[gi] = src_half(g.c, p, KIND_LEADERSHIP, 1);
      }
    }
    __syncwarp();
    // 2. the move cells' pair words, by (partition, candidate)
    if (g.uses_moves)
      for (int j = lane; j < G * K; j += 32)
        if (p0 + j / K < g.P) pw[j] = pair_words(g.c, mv[(j / K) * R], s_dst[j % K]);
    __syncwarp();
    // 3. every cell's score
    for (int j = lane; j < G * C; j += 32) {
      const int gj = j / C, c = j % C;
      if (p0 + gj >= g.P || (c < RK ? !g.uses_moves : !g.use_leadership)) continue;
      const SrcHalf* sh;
      const DstHalf* dh;
      PairWords pair{0, 0};
      if (c < RK) {
        sh = mv + gj * R + c / K;
        dh = s_dst + c % K;
        pair = pw[gj * K + c % K];
      } else {
        sh = lead + gj;
        dh = fol + gj * (R - 1) + (c - RK);
      }
      score[j] = combine(g.c, sc, *sh, *dh, row + gj * R, pair);
    }
    __syncwarp();
    // 4. each partition's best, in the reference's order, as a key
    unsigned long long key = 0ull;
    float best = -INFINITY;
    int kind = KIND_MOVE, slot = 0, dst = first_dst;
    if (lane < G && p0 + lane < g.P) {
      const float* sc = score + lane * C;
      if (g.uses_moves) {
        int bc = 0;
        for (int c = 1; c < RK; ++c)
          if (sc[c] > sc[bc]) bc = c;
        best = sc[bc];
        slot = bc / K;
        dst = s_dst[bc % K].dst;
      }
      if (g.use_leadership) {
        int ls = 1;
        for (int s = 2; s < R; ++s)
          if (sc[RK + s - 1] > sc[RK + ls - 1]) ls = s;
        if (sc[RK + ls - 1] > best) {
          best = sc[RK + ls - 1];
          kind = KIND_LEADERSHIP;
          slot = ls;
          dst = row[lane * R + ls];
        }
      }
      key = ((unsigned long long)order_bits(best) << 32) |
            (unsigned long long)(~(unsigned int)(p0 + lane));
    }
    unsigned long long top = key;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(full, top, off);
      if (o > top) top = o;
    }
    if (top > wb.key) {  // uniform: every lane holds the same top and wb
      const int at = __ffs(__ballot_sync(full, key == top)) - 1;
      wb.key = top;
      wb.score = __shfl_sync(full, best, at);
      wb.kind = __shfl_sync(full, kind, at);
      wb.slot = __shfl_sync(full, slot, at);
      wb.dst = __shfl_sync(full, dst, at);
    }
    __syncwarp();
  }
  if (lane == 0) s_best[warp] = wb;
  __syncthreads();
  if (threadIdx.x == 0) {
    BlockBest b = s_best[0];
    for (int i = 1; i < warps; ++i)
      if (s_best[i].key > b.key) b = s_best[i];
    blocks[blockIdx.x] = b;
  }
}

// One block: the best of the n block records.
__global__ void __launch_bounds__(256) k_grid_take(GridArgs g, const BlockBest* blocks, int n) {
  __shared__ unsigned long long s_key[256];
  __shared__ int s_at[256];
  unsigned long long key = 0;
  int at = 0;
  for (int i = threadIdx.x; i < n; i += 256) {
    const unsigned long long k = blocks[i].key;
    if (k > key) {
      key = k;
      at = i;
    }
  }
  s_key[threadIdx.x] = key;
  s_at[threadIdx.x] = at;
  __syncthreads();
  for (int half = 128; half > 0; half >>= 1) {
    if (threadIdx.x < half && s_key[threadIdx.x + half] > s_key[threadIdx.x]) {
      s_key[threadIdx.x] = s_key[threadIdx.x + half];
      s_at[threadIdx.x] = s_at[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const BlockBest b = blocks[s_at[0]];
    g.out_score[0] = b.score;
    g.out_idx[0] = (int)~(unsigned int)(b.key & 0xffffffffull);
    g.out_idx[1] = b.kind;
    g.out_idx[2] = b.slot;
    g.out_idx[3] = b.dst;
  }
}

// A device's launch state, set at its first launch of k_grid_bid.
constexpr int K9_MAX_DEVICES = 64;
struct K9Launch {
  size_t smem_set = 48 * 1024;  // k_grid_bid's dynamic shared-memory limit
  int sms = 0, per_sm = 0;      // SMs; blocks an SM at per_sm_smem bytes and per_sm_warps
  size_t per_sm_smem = (size_t)-1;
  int per_sm_warps = 0;
};

// The launch shape: G, warps, the dynamic shared memory (0 in the
// device-memory configuration) and the workspace bytes (0 in the
// shared-memory one).
struct K9Shape {
  int G, warps;
  size_t smem, work;
};

static K9Shape k9_shape(long long R, long long K, long long P) {
  K9Shape s;
  s.G = 32 / (2 * R) > 0 ? (int)(32 / (2 * R)) : 1;
  // as many warps as fit the block's shared memory, up to K9_WARPS
  s.warps = K9_WARPS;
  while (s.warps > 1 && block_bytes((int)R, (int)K, s.G, s.warps) > K9_SMEM_MAX) --s.warps;
  s.smem = block_bytes((int)R, (int)K, s.G, s.warps);
  s.work = 0;
  if (s.smem > K9_SMEM_MAX) {  // not even one warp's: the device-memory configuration
    s.warps = K9_WARPS;
    long long n = (P + (long long)s.warps * s.G - 1) / ((long long)s.warps * s.G);
    if (n > K9_GLOBAL_BLOCKS) n = K9_GLOBAL_BLOCKS;
    s.work = (size_t)n * work_bytes((int)R, (int)K, s.G, s.warps);
    s.smem = 0;
  }
  return s;
}

// The device-memory workspace a launch on these sizes needs (0: none).
CC_EXPORT long long grid_shortlist_work_bytes(long long R, long long K, long long P) {
  return R < 1 || P <= 0 ? 0 : (long long)k9_shape(R, K, P).work;
}

// ctx: the score context (host memory, read here); out_score f32[1], out_idx
// i32[4] (p, kind, slot, dst); blocks: scratch of K9_MAX_BLOCKS records
// (grid_shortlist_scratch_bytes() bytes); work: grid_shortlist_work_bytes()
// bytes (null where that is 0); dst_cands i32[K].
CC_EXPORT int grid_shortlist(const ScoreCtx* ctx, float* out_score, int* out_idx, void* blocks,
                             void* work, const int* dst_cands, long long P, long long K,
                             long long uses_moves, long long use_leadership,
                             cudaStream_t stream) {
  GridArgs g;
  g.c = *ctx;
  g.out_score = out_score;
  g.out_idx = out_idx;
  g.dst_cands = dst_cands;
  g.P = (int)P;
  g.K = (int)K;
  g.uses_moves = uses_moves != 0 && K > 0;
  g.use_leadership = use_leadership != 0 && ctx->R >= 2;
  if (P <= 0 || P > 0x7fffffffLL || ctx->R < 1) return cudaErrorInvalidValue;
  const K9Shape shape = k9_shape(ctx->R, K, P);
  if (shape.work > 0 && work == nullptr) return cudaErrorInvalidValue;
  g.G = shape.G;
  const int warps = shape.warps;
  const size_t smem = shape.smem;
  // the launch state of the current device (the one `stream` belongs to):
  // the shared-memory attribute, the SM count and the occupancy are each a
  // device's own
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= K9_MAX_DEVICES) return cudaErrorInvalidDevice;
  static K9Launch launch_state[K9_MAX_DEVICES];
  K9Launch& st = launch_state[dev];
  if (smem > st.smem_set) {
    e = cudaFuncSetAttribute(k_grid_bid<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    st.smem_set = smem;
  }
  // one wave of blocks: as many as fit on the card at once, no more than
  // there are warps' worth of partitions
  if (st.sms == 0) {
    e = cudaDeviceGetAttribute(&st.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  if (st.per_sm_smem != smem || st.per_sm_warps != warps) {
    e = shape.work > 0
            ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&st.per_sm, k_grid_bid<true>,
                                                            warps * 32, smem)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&st.per_sm, k_grid_bid<false>,
                                                            warps * 32, smem);
    if (e != cudaSuccess) return e;
    st.per_sm_smem = smem;
    st.per_sm_warps = warps;
  }
  long long n = (P + (long long)warps * g.G - 1) / ((long long)warps * g.G);
  const long long wave = (long long)st.sms * (st.per_sm > 0 ? st.per_sm : 1);
  if (n > wave) n = wave;
  if (n > K9_MAX_BLOCKS) n = K9_MAX_BLOCKS;
  if (shape.work > 0 && n > K9_GLOBAL_BLOCKS) n = K9_GLOBAL_BLOCKS;
  BlockBest* rec = static_cast<BlockBest*>(blocks);
  if (shape.work > 0)
    k_grid_bid<true><<<(unsigned)n, warps * 32, 0, stream>>>(g, rec, static_cast<char*>(work));
  else
    k_grid_bid<false><<<(unsigned)n, warps * 32, smem, stream>>>(g, rec, nullptr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  k_grid_take<<<1, 256, 0, stream>>>(g, rec, (int)n);
  return cudaGetLastError();
}

CC_EXPORT long long grid_shortlist_scratch_bytes() {
  return (long long)K9_MAX_BLOCKS * sizeof(BlockBest);
}
