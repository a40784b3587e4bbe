// dtw_band_panel: Sakoe-Chiba banded squared DTW of each query against a
// panel of candidate series: the cost of the corner cell (n-1, n-1).
// Shared form: x (C, n), out[q, c] = DTW_r(q, x[c]).  Gathered form:
// x (Q, M, n), out[q, m] = DTW_r(q, x[q, m]).
// Replaces the TPU kernel src/repro/kernels/dtw_band.py (dtw_band_panel).
//
// Bound on the H100: fp32 operations, about 6 per band cell (a sub, a mul,
// three mins and an add) and n(2r+1) band cells a pair.  The TPU kernel
// sweeps all n cells of each of the 2n-1 anti-diagonals and masks; here
// only the band is computed, about 20x less work at n = 256, r = 12.  The
// TPU's planar diagonal-extraction buffer is a VMEM layout device and is not
// carried over: the panels are read as they lie.
// Design: one thread per (query, candidate) pair.  The block's query sits in
// shared memory; each thread keeps one band row of 2r+2 floats in shared
// memory, laid out [offset][thread] so that a warp's accesses fall on
// distinct banks, and updates it in place row by row.  With cell (i, j) at
// offset o = j - i + r, the previous row's (i-1, j) sits at o+1 and
// (i-1, j-1) at o, and (i, j-1) is the value just written.  Off-band and
// off-matrix neighbours read float32 max, as in the plain anti-diagonal
// version, and every cell is min(c + min(three neighbours), float32 max)
// with c = (a - b) * (a - b).  min is exact, so the order in which cells are
// evaluated changes no value, and the rounding intrinsics keep nvcc from
// contracting into FMA: the result is bitwise the plain version's.
#include "common.cuh"

namespace {

constexpr int kMaxSmem = 227 * 1024;      // dynamic shared memory a block may use

__global__ void dtw_band_kernel(const float* __restrict__ q, const float* __restrict__ x,
                                float* __restrict__ out, int M, int n, int r,
                                int gathered) {
  extern __shared__ float smem[];
  const int T = blockDim.x;
  float* s_q = smem;                        // n
  float* band = smem + n;                   // (2r + 2) * T, [offset][thread]
  const int qi = blockIdx.y;
  for (int i = threadIdx.x; i < n; i += T) s_q[i] = q[static_cast<size_t>(qi) * n + i];
  __syncthreads();
  const long long m = static_cast<long long>(blockIdx.x) * T + threadIdx.x;
  if (m >= M) return;
  const float* b =
      x + (static_cast<size_t>(gathered ? qi : 0) * M + static_cast<size_t>(m)) * n;

  float* B = band + threadIdx.x;
  for (int o = 0; o < 2 * r + 2; ++o) B[o * T] = REPRO_INF;
  B[r * T] = 0.f;                           // cell (0, 0) costs c + 0
  for (int i = 0; i < n; ++i) {
    const float a = s_q[i];
    const int j_lo = max(0, i - r), j_hi = min(n - 1, i + r);
    float left = REPRO_INF;                 // (i, j_lo - 1): off band or off matrix
    float* p = B + (j_lo - i + r) * T;
    for (int j = j_lo; j <= j_hi; ++j, p += T) {
      const float d = __fsub_rn(a, __ldg(b + j));
      const float c = __fmul_rn(d, d);
      const float best = fminf(fminf(p[0], p[T]), left);   // (i-1,j-1), (i-1,j), (i,j-1)
      const float v = fminf(__fadd_rn(c, best), REPRO_INF);
      p[0] = v;
      left = v;
    }
  }
  out[static_cast<size_t>(qi) * M + m] = B[r * T];
}

}  // namespace

extern "C" int dtw_band_panel_launch(const void* q, const void* x, void* out, int Q,
                                     int M, int n, int r, int gathered, void* stream) {
  if (n < 1 || r < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (Q > 0 && M > 0) {
    r = min(r, n - 1);                      // a wider band holds the same cells
    int threads = 64;
    size_t smem = (static_cast<size_t>(n) + static_cast<size_t>(2 * r + 2) * threads) * 4;
    while (smem > 64 * 1024 && threads > 32) {
      threads /= 2;
      smem = (static_cast<size_t>(n) + static_cast<size_t>(2 * r + 2) * threads) * 4;
    }
    if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          dtw_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid(static_cast<unsigned>((M + threads - 1) / threads),
                    static_cast<unsigned>(Q));
    dtw_band_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(x),
        static_cast<float*>(out), M, n, r, gathered);
  }
  return static_cast<int>(cudaGetLastError());
}
