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
// 2,600 brokers). Arithmetic is a few adds per slot.
//
// Design: the float sums must equal the CPU reference bit for bit, so each
// broker's members are summed in ascending flat slot index (the order
// XLA:CPU segment_sum and index_add_ on the CPU both use). The wrapper lays
// the members out with a stable torch.sort of the segment ids; here one
// thread per broker binary-searches its run and sums it sequentially. Integer
// counts go through atomicAdd, which is exact in any order. host_cpu_load
// sums broker_load[:, CPU] over each host's brokers in broker order. Simple,
// not fast: the per-broker threads walk ~230 slots each with scattered reads
// and 2,600 threads leave most of the card idle.
#include "common.cuh"

__device__ __forceinline__ long long lower_bound(const int* a, long long n, int key) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if (a[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void k_broker_sums(const int* seg_sorted, const long long* order, long long n_slots,
                              const int* lseg_sorted, const long long* lorder, long long n_parts,
                              const float* part_load, int R, int B, float* broker_load,
                              int* replica_count, int* leader_count, float* potential,
                              float* leader_nw_in) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  long long lo = lower_bound(seg_sorted, n_slots, b);
  long long hi = lower_bound(seg_sorted, n_slots, b + 1);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float pnw = 0.0f;
  for (long long j = lo; j < hi; ++j) {
    long long idx = order[j];
    long long p = idx / R;
    int s = (int)(idx % R);
    const float* pl = part_load + p * NUM_PART_METRICS;
    float c[4];
    if (s == 0) leader_vec(pl, c); else follower_vec(pl, c);
    for (int r = 0; r < 4; ++r) acc[r] = acc[r] + c[r];
    pnw = pnw + pl[NW_OUT_LEADER];
  }
  for (int r = 0; r < 4; ++r) broker_load[(long long)b * 4 + r] = acc[r];
  potential[b] = pnw;
  replica_count[b] = (int)(hi - lo);

  long long llo = lower_bound(lseg_sorted, n_parts, b);
  long long lhi = lower_bound(lseg_sorted, n_parts, b + 1);
  float lnw = 0.0f;
  for (long long j = llo; j < lhi; ++j) lnw = lnw + part_load[lorder[j] * NUM_PART_METRICS + NW_IN_LEADER];
  leader_nw_in[b] = lnw;
  leader_count[b] = (int)(lhi - llo);
}

__global__ void k_counts(const int* assignment, long long n_slots, int R, const int* topic_id,
                         const int* broker_rack, int NR, int B, int* rack_count, int* topic_count) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  int a = assignment[i];
  if (a < 0) return;
  long long p = i / R;
  atomicAdd(&rack_count[p * NR + broker_rack[a]], 1);
  atomicAdd(&topic_count[(long long)topic_id[p] * B + a], 1);
}

__global__ void k_host_cpu(const int* broker_host, const float* broker_load, int B, int H,
                           float* host_cpu) {
  int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b)
    if (broker_host[b] == h) acc = acc + broker_load[(long long)b * 4 + RES_CPU];
  host_cpu[h] = acc;
}

// ptrs: assignment, part_load, topic_id, broker_rack, broker_host,
//       seg_sorted, order, lseg_sorted, lorder,
//       broker_load, replica_count, leader_count, potential, leader_nw_in,
//       rack_count, topic_count, host_cpu
// ints: P, R, B, NR, H, T
CC_EXPORT int segment_aggregates(const long long* ptrs, const long long* ints, cudaStream_t stream) {
  const int* assignment = (const int*)ptrs[0];
  const float* part_load = (const float*)ptrs[1];
  const int* topic_id = (const int*)ptrs[2];
  const int* broker_rack = (const int*)ptrs[3];
  const int* broker_host = (const int*)ptrs[4];
  const int* seg_sorted = (const int*)ptrs[5];
  const long long* order = (const long long*)ptrs[6];
  const int* lseg_sorted = (const int*)ptrs[7];
  const long long* lorder = (const long long*)ptrs[8];
  float* broker_load = (float*)ptrs[9];
  int* replica_count = (int*)ptrs[10];
  int* leader_count = (int*)ptrs[11];
  float* potential = (float*)ptrs[12];
  float* leader_nw_in = (float*)ptrs[13];
  int* rack_count = (int*)ptrs[14];
  int* topic_count = (int*)ptrs[15];
  float* host_cpu = (float*)ptrs[16];
  long long P = ints[0];
  int R = (int)ints[1], B = (int)ints[2], NR = (int)ints[3], H = (int)ints[4];
  long long T = ints[5];
  long long n_slots = P * R;

  cudaError_t e = cudaMemsetAsync(rack_count, 0, sizeof(int) * P * NR, stream);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(topic_count, 0, sizeof(int) * T * B, stream);
  if (e != cudaSuccess) return e;
  if (B > 0) {
    k_broker_sums<<<(B + 127) / 128, 128, 0, stream>>>(
        seg_sorted, order, n_slots, lseg_sorted, lorder, P, part_load, R, B, broker_load,
        replica_count, leader_count, potential, leader_nw_in);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (n_slots > 0) {
    k_counts<<<(unsigned)((n_slots + 255) / 256), 256, 0, stream>>>(
        assignment, n_slots, R, topic_id, broker_rack, NR, B, rack_count, topic_count);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (H > 0) {
    k_host_cpu<<<(H + 127) / 128, 128, 0, stream>>>(broker_host, broker_load, B, H, host_cpu);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}
