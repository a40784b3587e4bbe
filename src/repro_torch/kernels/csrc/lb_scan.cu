// lb_scan: squared MINDIST lower bounds of Q query PAAs against N planar
// region bounds, out[q, j] = (n/w) * sum_s max(0, lo[s, j] - q[s], q[s] - hi[s, j])^2.
// Replaces the TPU kernel src/repro/kernels/lb_scan.py (lb_scan).
//
// Bound on the H100: bytes.  lo/hi (w, N) are read once and the (Q, N)
// result written once; the arithmetic is ~6 operations per (q, j, s).
// Design: threads run over the N axis, so each planar row load and each
// output row store is coalesced; a thread keeps its column's w bounds in
// registers and sweeps a tile of queries whose PAAs sit in shared memory.
// The w terms are summed in registers without FMA contraction, then scaled
// by n/w, as the plain version does.  The ragged N edge is masked here; no
// SENTINEL padding copy is made.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxW = 32;
constexpr int kQueryTile = 16;

__global__ void __launch_bounds__(kThreads)
lb_scan_kernel(const float* __restrict__ q_paa, const float* __restrict__ lo,
               const float* __restrict__ hi, float* __restrict__ out, int Q,
               long long N, int w, float scale) {
  __shared__ float s_q[kQueryTile * kMaxW];
  const int q0 = blockIdx.y * kQueryTile;
  const int qn = min(kQueryTile, Q - q0);
  for (int i = threadIdx.x; i < qn * w; i += kThreads) s_q[i] = q_paa[q0 * w + i];
  __syncthreads();
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= N) return;

  float l[kMaxW], h[kMaxW];
#pragma unroll
  for (int s = 0; s < kMaxW; ++s) {
    if (s < w) {
      l[s] = lo[s * N + j];
      h[s] = hi[s * N + j];
    }
  }
  for (int qi = 0; qi < qn; ++qi) {
    const float* qp = s_q + qi * w;
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxW; ++s) {
      if (s < w) {
        const float qv = qp[s];
        const float dv = fmaxf(fmaxf(l[s] - qv, qv - h[s]), 0.f);
        acc = __fadd_rn(acc, __fmul_rn(dv, dv));
      }
    }
    out[static_cast<long long>(q0 + qi) * N + j] = __fmul_rn(scale, acc);
  }
}

}  // namespace

extern "C" int lb_scan_launch(const void* q_paa, const void* lo, const void* hi, void* out,
                              int Q, long long N, int w, float scale, void* stream) {
  if (w > kMaxW) return static_cast<int>(cudaErrorInvalidValue);
  if (Q > 0 && N > 0) {
    const dim3 grid(static_cast<unsigned>((N + kThreads - 1) / kThreads),
                    static_cast<unsigned>((Q + kQueryTile - 1) / kQueryTile));
    lb_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q_paa), static_cast<const float*>(lo),
        static_cast<const float*>(hi), static_cast<float*>(out), Q, N, w, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
