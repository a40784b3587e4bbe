// batch_l2: squared Euclidean distances of Q queries to N series,
// out[q, j] = max(||q||^2 + ||x_j||^2 - 2 q.x_j, 0), all in fp32.
// Replaces the TPU kernel src/repro/kernels/batch_l2.py (batch_l2).
//
// Bound on the H100: fp32 operations (2QNn for the cross term, outside the
// tensor cores) once Q reaches a few dozen, bytes (4(Qn + Nn + QN)) for a
// single query.  Never TF32: its 10-bit mantissa would take distances far
// outside the 1e-5 relative tolerance the port holds them to.
// Design: a shared-memory tiled product.  A block of 256 threads owns a
// 64 x 64 output tile; each thread accumulates a 4 x 4 register tile with
// FFMA over slices of 16 coordinates, staged transposed in shared memory.
// While a slice is staged, 128 of the threads also accumulate the tile's 64
// query and 64 series squared norms, so the norms cost no second pass over
// device memory.  Ragged Q, N and n are masked with zeros on load and on
// store; RAW_PAD rows (|x|^2 ~ 2.56e10) stay finite.  The epilogue forms
// (qq + xx) - 2 q.x with rounding intrinsics, in the plain version's order,
// and clamps at 0.
#include "common.cuh"

namespace {

constexpr int kTile = 64;                 // output tile is kTile x kTile
constexpr int kSlice = 16;                // coordinates staged per step
constexpr int kThreads = 256;             // 16 x 16 threads
constexpr int kMicro = 4;                 // each thread: kMicro x kMicro outputs
constexpr int kStride = kTile + 4;        // padded shared row

__global__ void __launch_bounds__(kThreads)
batch_l2_kernel(const float* __restrict__ q, const float* __restrict__ x,
                float* __restrict__ out, int Q, long long N, int n) {
  __shared__ float s_q[kSlice * kStride];
  __shared__ float s_x[kSlice * kStride];
  __shared__ float s_qq[kTile];
  __shared__ float s_xx[kTile];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long j0 = static_cast<long long>(blockIdx.x) * kTile;
  const int q0 = blockIdx.y * kTile;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.f;
  // tid < 64: squared norm of query row q0 + tid; 64 <= tid < 128: of
  // series row j0 + tid - 64
  float norm = 0.f;

  for (int k0 = 0; k0 < n; k0 += kSlice) {
    for (int e = tid; e < kTile * kSlice; e += kThreads) {
      const int row = e / kSlice, col = e % kSlice;
      const int kk = k0 + col;
      const int qr = q0 + row;
      const long long xr = j0 + row;
      s_q[col * kStride + row] =
          (qr < Q && kk < n) ? q[static_cast<size_t>(qr) * n + kk] : 0.f;
      s_x[col * kStride + row] =
          (xr < N && kk < n) ? x[static_cast<size_t>(xr) * n + kk] : 0.f;
    }
    __syncthreads();
    if (tid < 2 * kTile) {
      const float* col0 = tid < kTile ? s_q + tid : s_x + (tid - kTile);
#pragma unroll
      for (int c = 0; c < kSlice; ++c) {
        const float v = col0[c * kStride];
        norm = fmaf(v, v, norm);
      }
    }
#pragma unroll
    for (int c = 0; c < kSlice; ++c) {
      float a[kMicro], b[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) a[i] = s_q[c * kStride + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) b[j] = s_x[c * kStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < kTile) {
    s_qq[tid] = norm;
  } else if (tid < 2 * kTile) {
    s_xx[tid - kTile] = norm;
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= Q) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const long long xr = j0 + tx + 16 * j;
      if (xr >= N) continue;
      const float d = __fsub_rn(__fadd_rn(s_qq[ty + 16 * i], s_xx[tx + 16 * j]),
                                __fmul_rn(2.f, acc[i][j]));
      out[static_cast<size_t>(qr) * N + xr] = fmaxf(d, 0.f);
    }
  }
}

}  // namespace

extern "C" int batch_l2_launch(const void* q, const void* x, void* out, int Q,
                               long long N, int n, void* stream) {
  if (Q > 0 && N > 0) {
    const dim3 grid(static_cast<unsigned>((N + kTile - 1) / kTile),
                    static_cast<unsigned>((Q + kTile - 1) / kTile));
    batch_l2_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(x),
        static_cast<float*>(out), Q, N, n);
  }
  return static_cast<int>(cudaGetLastError());
}
