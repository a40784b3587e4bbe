// ssm_scan: the fused selective-SSM forward scan of Hymba's Mamba heads.
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py (ssm_scan).
//
//   h_t[d, n] = exp(dt_t[d] * A[d, n]) * h_{t-1}[d, n] + dt_t[d] * xc_t[d] * B_t[n]
//   y_t[d]    = sum_n h_t[d, n] * C_t[n]
//
// for xc, dt (B, S, D), B, C (B, S, N), A (D, N) (A = -exp(a_log), negative),
// from h_0 = h0 (B, D, N) or zeros; writes y (B, S, D) and the last state
// h_last (B, D, N), which the served path keeps in its cache.  The TPU
// kernel keeps the state in VMEM and never writes it (its h0 is zero).
//
// Bound on the H100: bytes at the prefill shape (xc, dt and y are each
// B*S*D floats; B, C add 2N/D of that), with one expf per (b, t, d, n) on
// the special-function units close behind.  The (B, S, D, N) coefficients
// that the plain recurrence materialises never leave the SM.  The
// recurrence is sequential in t, so the design puts many independent
// chains in flight instead:
//   * one channel (b, d) per group of N lanes, one state element h[d, n]
//     per lane, in a register for the whole scan: B*D*N threads (102,400
//     at B 4, D 1600, N 16) where the TPU kernel runs B * D/128 programs;
//   * the block stages a tile of kTile time steps: the rows B_t and C_t,
//     and xc and dt of its channels, loaded with consecutive threads on
//     consecutive d (coalesced), masked at a ragged D with no padding copy;
//   * y_t is a shuffle reduction across the N lanes of a channel, parked in
//     shared memory and stored per tile, again coalesced along d;
//   * accurate expf (no --use_fast_math, no __expf).  nvcc may contract
//     a * h + b into one FMA, so the kernel and the plain version
//     (ref.ssm_scan_ref) agree within a tolerance, not bitwise.
// The S-long dependent chain per thread (one FMA a step) is short next to
// the work in flight; what the kernel does not do yet is amortise the
// reduction (log2 N shuffles per step per lane).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;

template <int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ xc, const float* __restrict__ dt,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_last, int S, int D) {
  constexpr int kChan = kThreads / N;                   // channels per block
  __shared__ float s_b[kTile][N];
  __shared__ float s_c[kTile][N];
  __shared__ float s_x[kTile][kChan];
  __shared__ float s_dt[kTile][kChan];
  __shared__ float s_y[kTile][kChan];

  const int b = blockIdx.y;
  const int ch = threadIdx.x / N;                       // channel within the block
  const int n = threadIdx.x % N;                        // state element
  const int d0 = blockIdx.x * kChan;
  const int d = d0 + ch;
  const bool live = d < D;
  const long long row0 = static_cast<long long>(b) * S;  // (b, t = 0) row

  const float A = live ? a[static_cast<long long>(d) * N + n] : 0.f;
  float h = 0.f;
  if (h0 != nullptr && live) h = h0[(static_cast<long long>(b) * D + d) * N + n];

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int tn = min(kTile, S - t0);
    for (int i = threadIdx.x; i < tn * N; i += kThreads) {
      const long long off = (row0 + t0) * N + i;
      s_b[i / N][i % N] = bm[off];
      s_c[i / N][i % N] = cm[off];
    }
    for (int i = threadIdx.x; i < tn * kChan; i += kThreads) {
      const int tt = i / kChan, cc = i % kChan, dd = d0 + cc;
      float xv = 0.f, dv = 0.f;
      if (dd < D) {
        const long long off = (row0 + t0 + tt) * D + dd;
        xv = xc[off];
        dv = dt[off];
      }
      s_x[tt][cc] = xv;
      s_dt[tt][cc] = dv;
    }
    __syncthreads();

    for (int tt = 0; tt < tn; ++tt) {
      const float dtv = s_dt[tt][ch];
      const float at = expf(dtv * A);
      const float bt = (dtv * s_x[tt][ch]) * s_b[tt][n];
      h = at * h + bt;
      float p = h * s_c[tt][n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (n == 0) s_y[tt][ch] = p;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < tn * kChan; i += kThreads) {
      const int tt = i / kChan, cc = i % kChan, dd = d0 + cc;
      if (dd < D) y[(row0 + t0 + tt) * D + dd] = s_y[tt][cc];
    }
    // the next tile's staging overwrites s_b .. s_dt only after every
    // thread has read them, and s_y only after these stores
    __syncthreads();
  }
  if (live) h_last[(static_cast<long long>(b) * D + d) * N + n] = h;
}

template <int N>
cudaError_t launch(const float* xc, const float* dt, const float* bm, const float* cm,
                   const float* a, const float* h0, float* y, float* h_last, int B, int S,
                   int D, cudaStream_t stream) {
  constexpr int kChan = kThreads / N;
  const dim3 grid(static_cast<unsigned>((D + kChan - 1) / kChan), static_cast<unsigned>(B));
  ssm_scan_kernel<N><<<grid, kThreads, 0, stream>>>(xc, dt, bm, cm, a, h0, y, h_last, S, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssm_scan_launch(const void* xc, const void* dt, const void* bm, const void* cm,
                               const void* a, const void* h0, void* y, void* h_last, int B,
                               int S, int D, int N, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  const auto* xc_ = static_cast<const float*>(xc);
  const auto* dt_ = static_cast<const float*>(dt);
  const auto* bm_ = static_cast<const float*>(bm);
  const auto* cm_ = static_cast<const float*>(cm);
  const auto* a_ = static_cast<const float*>(a);
  const auto* h0_ = static_cast<const float*>(h0);
  auto* y_ = static_cast<float*>(y);
  auto* hl_ = static_cast<float*>(h_last);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (N) {
    case 4: e = launch<4>(xc_, dt_, bm_, cm_, a_, h0_, y_, hl_, B, S, D, st); break;
    case 8: e = launch<8>(xc_, dt_, bm_, cm_, a_, h0_, y_, hl_, B, S, D, st); break;
    case 16: e = launch<16>(xc_, dt_, bm_, cm_, a_, h0_, y_, hl_, B, S, D, st); break;
    case 32: e = launch<32>(xc_, dt_, bm_, cm_, a_, h0_, y_, hl_, B, S, D, st); break;
    default: e = cudaErrorInvalidValue; break;
  }
  return static_cast<int>(e);
}
