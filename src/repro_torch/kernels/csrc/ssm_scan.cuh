// Shared pieces of the selective-scan kernels: ssm_scan.cu (the forward)
// and ssm_scan_bwd.cu (its reverse, for training).
#pragma once

#include <cuda_runtime.h>

// The forward stores the state before every kSsmCkpt steps when asked
// (its training launch); the backward recomputes each span of kSsmCkpt
// steps from that state.  Both kernels walk tiles of this many steps.
constexpr int kSsmCkpt = 32;
constexpr float kLog2e = 1.4426950408889634f;

// exp(x) = ex2(x * log2 e): the callers scale A by log2 e once.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Reduce-scatter of T partial sums over a group of lanes: the lanes that
// differ only in the bits LO, 2 LO, ..., HI / 2 of their lane index (xor
// partners, from the highest bit down).  In round i a lane keeps the half
// of its values that its bit HI >> (i + 1) selects and adds its partner's
// copy of that half; past T values a round is a plain all-reduce (T = 1).
// After the rounds, with M = HI / LO lanes in the group and u = (lane / LO)
// % M a lane's place in it, the lane holds max(1, T / M) sums in p[0 ...],
// of the steps (u / max(1, M / T)) * max(1, T / M) + e, shared by the
// max(1, M / T) lanes of the same u / max(1, M / T); over the G lanes of a
// channel (LO = 1, HI = G, T >= G) lane g holds the sums of steps
// g T / G ... (g + 1) T / G - 1.  The rounds are unrolled at compile time,
// so p stays in registers.
template <int LO, int HI, int T, int I = 0>
__device__ __forceinline__ void reduce_scatter(float (&p)[T], int lane) {
  constexpr int o = HI >> (I + 1);
  if constexpr (o >= LO && o > 0) {
    constexpr int len = (T >> I) > 1 ? (T >> I) : 1;
    const bool up = (lane & o) != 0;
    if constexpr (len > 1) {
#pragma unroll
      for (int e = 0; e < len / 2; ++e) {
        const float lo = p[e], hi = p[e + len / 2];
        p[e] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, o);
      }
    } else {
      p[0] += __shfl_xor_sync(0xffffffffu, p[0], o);
    }
    reduce_scatter<LO, HI, T, I + 1>(p, lane);
  }
}
