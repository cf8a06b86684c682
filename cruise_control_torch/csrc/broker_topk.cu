// K2 broker_topk: every broker's top-k replica slots by drain priority.
//
// Replaces: cruise_control_tpu/analyzer/drain.py broker_top_replicas (:74),
// k segment_max -> segment_min-of-index passes over the flat slot axis.
//
// Bound on this card: bytes. Each of the k passes reads the P*R contrib and
// assignment entries (about 4.8 MB at 199,518 x 3 slots) and the per-broker
// keys; the bound the caller states counts each input once.
//
// Design: one pass = one atomicMax per eligible slot onto a per-broker
// uint64 key, then one thread per broker decodes its winner. The key holds
// the order-preserving bits of the value (negated when heaviest == 0) in the
// high word and ~index in the low word, so the maximum key is the highest
// value with ties to the lowest flat index, exactly drain.py:103-108. -0.0 is
// canonicalised to +0.0 first because the JAX code compares with ==, which
// treats them as equal. Slots that are empty (-1), immovable or non-finite
// never compete, as at drain.py:94-97. A key of 0 means "no candidate" (every
// real key has a nonzero high word). Winners are marked taken in a byte
// scratch so the next pass skips them.
#include "common.cuh"

__device__ __forceinline__ unsigned int order_bits(float v) {
  unsigned int u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__global__ void k_bid(const float* contrib, const int* assignment, const unsigned char* movable,
                      const unsigned char* taken, long long n, int R, int heaviest,
                      unsigned long long* keys) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int a = assignment[i];
  float c = contrib[i];
  if (a < 0 || taken[i] || !movable[i / R] || !isfinite(c)) return;
  float v = heaviest ? c : -c;
  if (v == 0.0f) v = 0.0f;  // -0.0 == +0.0 in the reference's compare
  unsigned long long key = ((unsigned long long)order_bits(v) << 32) |
                           (unsigned long long)(~(unsigned int)i);
  atomicMax(&keys[a], key);
}

__global__ void k_take(const unsigned long long* keys, int B, long long n, int R, int k, int pass,
                       unsigned char* taken, int* out_p, int* out_s, unsigned char* out_ok) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  unsigned long long key = keys[b];
  bool found = key != 0ull;
  long long idx = found ? (long long)(~(unsigned int)(key & 0xffffffffull)) : n - 1;
  if (found) taken[idx] = 1;
  long long o = (long long)b * k + pass;
  out_p[o] = (int)(idx / R);
  out_s[o] = (int)(idx % R);
  out_ok[o] = found ? 1 : 0;
}

// ptrs: contrib f32[P*R], assignment i32[P*R], movable u8[P], keys u64[B] (scratch),
//       taken u8[P*R] (scratch), out_p i32[B,k], out_s i32[B,k], out_ok u8[B,k]
// ints: P, R, B, k, heaviest
CC_EXPORT int broker_topk(const long long* ptrs, const long long* ints, cudaStream_t stream) {
  const float* contrib = (const float*)ptrs[0];
  const int* assignment = (const int*)ptrs[1];
  const unsigned char* movable = (const unsigned char*)ptrs[2];
  unsigned long long* keys = (unsigned long long*)ptrs[3];
  unsigned char* taken = (unsigned char*)ptrs[4];
  int* out_p = (int*)ptrs[5];
  int* out_s = (int*)ptrs[6];
  unsigned char* out_ok = (unsigned char*)ptrs[7];
  long long P = ints[0];
  int R = (int)ints[1], B = (int)ints[2], k = (int)ints[3], heaviest = (int)ints[4];
  long long n = P * R;
  if (B == 0) return cudaSuccess;
  cudaError_t e = cudaMemsetAsync(taken, 0, n, stream);
  if (e != cudaSuccess) return e;
  for (int pass = 0; pass < k; ++pass) {
    if ((e = cudaMemsetAsync(keys, 0, sizeof(unsigned long long) * B, stream)) != cudaSuccess)
      return e;
    if (n > 0) {
      k_bid<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(contrib, assignment, movable, taken,
                                                            n, R, heaviest, keys);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    k_take<<<(B + 127) / 128, 128, 0, stream>>>(keys, B, n, R, k, pass, taken, out_p, out_s,
                                               out_ok);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}
