// K6 pair_picks: the first k movable slots (lowest flat index p * R + slot)
// of each of V (topic, broker) pairs.
//
// Replaces: cruise_control_tpu/analyzer/drain.py pair_replica_picks (:235),
// k segment_min passes of the flat slot index over T * B + 1 group ids.
//
// Bound on this card: bytes. Each pass reads the P * R assignment (2.4 MB on
// the smoke model), the partition's topic and movable flag and the broker's
// pair row: about 3.4 MB a pass, 4 passes, ~4 us at the card's rate.
//
// Design: no T * B group table (10.4M groups on the smoke model). The V pairs'
// brokers are distinct, so the wrapper's pair_row_of_broker i32[B] names the
// one row a slot can belong to. Pass j: every slot of its row's topic whose
// index exceeds the row's previous pick bids with atomicMin on a per-row i32;
// a second small kernel records the winner, which is the reference's j-th
// segment minimum. atomicMin on an integer is exact in any order. A row with
// no more slots reports the last slot with found = 0, as the reference does.
#include "common.cuh"

__global__ void k_pair_init(int* best, int v, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < v) best[i] = n;
}

__global__ void k_pair_bid(const int* assignment, const int* topic_id, const unsigned char* movable,
                           const int* pair_t, const int* row_of, const int* out_p,
                           const int* out_s, const unsigned char* out_ok, long long n, int R,
                           int k, int pass, int* best) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int b = assignment[i];
  if (b < 0) return;
  long long p = i / R;
  if (!movable[p]) return;
  int row = row_of[b];
  if (row < 0 || topic_id[p] != pair_t[row]) return;
  if (pass > 0) {
    long long prev = (long long)row * k + pass - 1;
    if (!out_ok[prev]) return;
    if (i <= (long long)out_p[prev] * R + out_s[prev]) return;
  }
  atomicMin(&best[row], (int)i);
}

__global__ void k_pair_take(int* best, int v, long long n, int R, int k, int pass, int* out_p,
                            int* out_s, unsigned char* out_ok) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= v) return;
  long long idx = best[row];
  bool found = idx < n;
  if (!found) idx = n - 1;
  long long o = (long long)row * k + pass;
  out_p[o] = (int)(idx / R);
  out_s[o] = (int)(idx % R);
  out_ok[o] = found ? 1 : 0;
  best[row] = (int)n;  // reset for the next pass
}

// ptrs: assignment i32[P*R], topic_id i32[P], movable u8[P], pair_t i32[V],
//       row_of i32[B], best i32[V] (scratch), out_p i32[V,k], out_s i32[V,k],
//       out_ok u8[V,k]
// ints: P, R, B, V, k
CC_EXPORT int pair_picks(const long long* ptrs, const long long* ints, cudaStream_t stream) {
  const int* assignment = (const int*)ptrs[0];
  const int* topic_id = (const int*)ptrs[1];
  const unsigned char* movable = (const unsigned char*)ptrs[2];
  const int* pair_t = (const int*)ptrs[3];
  const int* row_of = (const int*)ptrs[4];
  int* best = (int*)ptrs[5];
  int* out_p = (int*)ptrs[6];
  int* out_s = (int*)ptrs[7];
  unsigned char* out_ok = (unsigned char*)ptrs[8];
  long long P = ints[0];
  int R = (int)ints[1];
  int v = (int)ints[3], k = (int)ints[4];
  long long n = P * R;
  if (v == 0 || n == 0) return cudaSuccess;
  cudaError_t e;
  k_pair_init<<<(v + 255) / 256, 256, 0, stream>>>(best, v, (int)n);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  for (int pass = 0; pass < k; ++pass) {
    k_pair_bid<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        assignment, topic_id, movable, pair_t, row_of, out_p, out_s, out_ok, n, R, k, pass, best);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    k_pair_take<<<(v + 255) / 256, 256, 0, stream>>>(best, v, n, R, k, pass, out_p, out_s,
                                                     out_ok);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}
