// K11 elect_preferred: leadership off demoted and dead brokers, to the
// first replica on an eligible broker.
//
// Replaces: cruise_control_tpu/analyzer/goals/preferred.py
// elect_preferred_leaders (:22). For each partition whose slot-0 broker is
// demoted or dead, slot 0 is exchanged with the lowest slot whose broker is
// alive and not demoted (the first true of a bool argmax); a partition with
// no such replica, or whose leader is eligible, keeps its row. A -1 slot is
// empty: its broker is read as broker 0's and the result masked by the
// slot's validity, as the reference does (holder = where(valid, a, 0)).
//
// Bound on this card: bytes. The [P, R] i32 assignment is read once and a
// fresh [P, R] written once (4.8 MB at 199,518 partitions and RF 3, about
// 1.4 us at 3.35 TB/s); the two [B] masks stay in L1/L2.
//
// Design: one thread per partition reads its R slots and the masks, finds
// the first eligible slot and writes its row of the output; the input is
// never written (a fresh output, no scatter in place).
#include "common.cuh"

__global__ void k_elect_preferred(const int* assignment, const unsigned char* demoted,
                                  const unsigned char* dead, long long p_count, long long r,
                                  int* out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= p_count) return;
  const int* row = assignment + p * r;
  int* dst = out + p * r;
  long long best = 0;
  bool found = false;
  for (long long s = 0; s < r; ++s) {
    const int a = row[s];
    const bool valid = a >= 0;
    const int holder = valid ? a : 0;
    const bool ok = valid && !(demoted[holder] || dead[holder]);
    if (ok && !found) {
      best = s;
      found = true;
    }
  }
  const int a0 = row[0];
  const int h0 = a0 >= 0 ? a0 : 0;
  const bool leader_bad = (demoted[h0] || dead[h0]) && a0 >= 0;
  const bool swap = leader_bad && found && best != 0;
  for (long long s = 0; s < r; ++s) dst[s] = row[s];
  if (swap) {
    dst[0] = row[best];
    dst[best] = a0;
  }
}

// assignment i32[P, R], demoted bool[B], dead bool[B], out i32[P, R]
CC_EXPORT int elect_preferred(const void* assignment, const void* demoted, const void* dead,
                              void* out, long long p_count, long long r, cudaStream_t stream) {
  if (p_count < 0 || r <= 0) return cudaErrorInvalidValue;
  if (p_count == 0) return cudaSuccess;
  k_elect_preferred<<<(unsigned)((p_count + 255) / 256), 256, 0, stream>>>(
      (const int*)assignment, (const unsigned char*)demoted, (const unsigned char*)dead,
      p_count, r, (int*)out);
  return cudaGetLastError();
}
