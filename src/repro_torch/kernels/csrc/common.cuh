// Shared helpers of the port's CUDA kernels (sm_90a).
//
// The (distance, key) order is the one every top-k in the port uses: ascending
// distance, ties toward the smaller key, where a pad lane (id < 0) carries the
// key PAD_ID_KEY = INT32_MAX.  block_topk's round kernel (k > 32) selects by k
// rounds of "lex-min among the pairs lex-greater than the last one picked",
// which needs no retired-lane state: within a row real keys are distinct, and
// pad lanes (all (INF, PAD)) collapse into one pick, after which a round
// finds nothing and emits (INF, -1) — the same output as the plain
// two-stable-sort top-k.
#pragma once

#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <cstdint>

#define REPRO_INF FLT_MAX                 // the port's INF: float32 max, finite
#define PAD_ID_KEY INT_MAX                // sort key of an id < 0

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Asynchronous copies from device to shared memory (cp.async): 4 bytes
// (any aligned float or int) or 16 bytes (both addresses 16-byte aligned),
// committed as a group and waited for with cp_async_wait<groups left>.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// (da, ka) < (db, kb) lexicographically
__device__ __forceinline__ bool lex_less(float da, int ka, float db, int kb) {
  return da < db || (da == db && ka < kb);
}

// "nothing left" marker of a selection round: above every candidate pair,
// because candidates carry finite distances (INF is float32 max)
__device__ __forceinline__ bool is_none(float d, int k) {
  return d == pos_inf() && k == INT_MAX;
}

__device__ __forceinline__ void warp_lex_min(float& d, int& k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float od = __shfl_xor_sync(0xffffffffu, d, off);
    int ok = __shfl_xor_sync(0xffffffffu, k, off);
    if (lex_less(od, ok, d, k)) { d = od; k = ok; }
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block-wide lex-min of one (d, k) pair per thread; every thread gets the
// result.  s_d / s_k hold NT/32 + 1 entries.  All NT threads must call it.
template <int NT>
__device__ __forceinline__ void block_lex_min(float& d, int& k, float* s_d, int* s_k) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_lex_min(d, k);
  if (lane == 0) { s_d[warp] = d; s_k[warp] = k; }
  __syncthreads();
  if (warp == 0) {
    d = lane < NW ? s_d[lane] : pos_inf();
    k = lane < NW ? s_k[lane] : INT_MAX;
    warp_lex_min(d, k);
    if (lane == 0) { s_d[NW] = d; s_k[NW] = k; }
  }
  __syncthreads();
  d = s_d[NW];
  k = s_k[NW];
}
