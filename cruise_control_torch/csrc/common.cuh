// Shared definitions of the cruise_control_torch kernels.
//
// Every entry point has a plain C interface for ctypes:
//   int <name>(const long long* ptrs, const long long* ints, cudaStream_t stream)
// `ptrs` holds device addresses, `ints` sizes, strides and flags, both host
// arrays read before the launch. The return value is the cudaError_t of the
// launch (0 on success); cc_error_string names it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define CC_EXPORT extern "C" __attribute__((visibility("default")))

// Column ids of part_load f32[P, 6] (common/resources.py PartMetric).
enum PartMetric {
  CPU_LEADER = 0,
  CPU_FOLLOWER = 1,
  NW_IN_LEADER = 2,
  NW_IN_FOLLOWER = 3,
  NW_OUT_LEADER = 4,
  DISK = 5,
  NUM_PART_METRICS = 6,
};

// Resource ids of the [*, 4] load vectors.
enum Resource { RES_CPU = 0, RES_NW_IN = 1, RES_NW_OUT = 2, RES_DISK = 3 };

enum ActionKind { KIND_MOVE = 0, KIND_LEADERSHIP = 1 };

// The per-Resource load a partition places on a leader / follower replica
// (actions._leader_vec / _follower_vec).
__device__ __forceinline__ void leader_vec(const float* pl, float out[4]) {
  out[RES_CPU] = pl[CPU_LEADER];
  out[RES_NW_IN] = pl[NW_IN_LEADER];
  out[RES_NW_OUT] = pl[NW_OUT_LEADER];
  out[RES_DISK] = pl[DISK];
}

__device__ __forceinline__ void follower_vec(const float* pl, float out[4]) {
  out[RES_CPU] = pl[CPU_FOLLOWER];
  out[RES_NW_IN] = pl[NW_IN_FOLLOWER];
  out[RES_NW_OUT] = 0.0f;
  out[RES_DISK] = pl[DISK];
}

// One action materialized from (p, kind, slot, dst), as actions.build_selected.
struct Action {
  int p, slot, src, dst;
  bool is_move, valid;
  float dload[4];
  int drep, dleader;
  float dpnw, dleader_nw_in;
};

// `valid` is False whenever src or dst is -1; every other field is then
// unspecified and must not be read (callers mask such actions out, as the
// JAX code's -inf / flag masks do).
__device__ __forceinline__ Action build_action(const int* assignment, int R, const float* part_load,
                                               int p, int kind, int slot, int dst) {
  Action a;
  a.p = p;
  a.slot = slot;
  a.dst = dst;
  a.is_move = kind == KIND_MOVE;
  a.src = a.is_move ? assignment[(long long)p * R + slot] : assignment[(long long)p * R];
  a.valid = (a.src >= 0) && (dst >= 0) && (a.src != dst);
  const float* pl = part_load + (long long)p * NUM_PART_METRICS;
  float lead[4], foll[4];
  leader_vec(pl, lead);
  follower_vec(pl, foll);
  for (int r = 0; r < 4; ++r) {
    float move_load = slot == 0 ? lead[r] : foll[r];
    a.dload[r] = a.is_move ? move_load : lead[r] - foll[r];
  }
  bool leader_transfer = !a.is_move || slot == 0;
  a.drep = a.is_move ? 1 : 0;
  a.dleader = leader_transfer ? 1 : 0;
  a.dpnw = a.is_move ? pl[NW_OUT_LEADER] : 0.0f;
  a.dleader_nw_in = leader_transfer ? pl[NW_IN_LEADER] : 0.0f;
  return a;
}

CC_EXPORT const char* cc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
