// isax_summarize: optional z-normalization, PAA over w equal segments, and
// the iSAX symbol of each segment (the count of breakpoints <= the PAA value).
// Replaces the TPU kernel src/repro/kernels/isax_summarize.py (isax_summarize).
//
// Bound on the H100: bytes.  The (N, n) series are read once (4 bytes a
// point) and (N, w) PAA values and symbols written; the arithmetic is a
// few operations a point.  Design: one warp per series, lanes on
// consecutive points so every load is coalesced.  The warp stages its
// series in shared memory; lane s then averages segment s and finds its
// symbol by binary search over the ascending breakpoint table, which the
// caller passes in (scipy's float32 values).
//
// The card's symbols are bitwise those of the plain version
// (ref.isax_summarize_ref), because both evaluate the same float64
// operations in the same order and round the PAA to float32 once:
//   * the mean and the variance about it: lane l sums points l, l + 32,
//     ... in order, then the 32 lane sums meet in an xor butterfly
//     (offsets 16, 8, 4, 2, 1);
//   * each point z-normed as (x - mean) / max(sqrt(var), 1e-8);
//   * each window summed point by point in order, divided by its length.
// Every operation is a correctly rounded intrinsic (__dadd_rn, __dsub_rn,
// __dmul_rn, __ddiv_rn, __dsqrt_rn), so nvcc contracts nothing into an
// FMA and no approximate reciprocal or rsqrt enters.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ double warp_sum_rn(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(kThreads)
isax_summarize_kernel(const float* __restrict__ x, const float* __restrict__ bps,
                      float* __restrict__ paa, int* __restrict__ sax, long long N, int n,
                      int w, int nbp, int normalize) {
  extern __shared__ float smem[];
  float* s_bp = smem;                                   // nbp
  float* s_x = smem + nbp + (threadIdx.x >> 5) * n;     // n per warp
  for (int i = threadIdx.x; i < nbp; i += kThreads) s_bp[i] = bps[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long series = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (series >= N) return;                              // no block barrier below
  const float* xr = x + series * n;
  const double dn = static_cast<double>(n);

  double sum = 0.0;
  for (int j = lane; j < n; j += 32) {
    const float v = xr[j];
    s_x[j] = v;
    sum = __dadd_rn(sum, static_cast<double>(v));
  }
  double mu = 0.0, den = 1.0;
  if (normalize) {
    mu = __ddiv_rn(warp_sum_rn(sum), dn);
    double ss = 0.0;
    for (int j = lane; j < n; j += 32) {
      const double c = __dsub_rn(static_cast<double>(s_x[j]), mu);
      ss = __dadd_rn(ss, __dmul_rn(c, c));
    }
    den = fmax(__dsqrt_rn(__ddiv_rn(warp_sum_rn(ss), dn)), 1e-8);
  }
  __syncwarp();

  const int seg = n / w;
  for (int s = lane; s < w; s += 32) {
    const float* xs = s_x + s * seg;
    double acc = 0.0;
    for (int t = 0; t < seg; ++t) {
      double v = static_cast<double>(xs[t]);
      if (normalize) v = __ddiv_rn(__dsub_rn(v, mu), den);
      acc = __dadd_rn(acc, v);
    }
    const float p = __double2float_rn(__ddiv_rn(acc, static_cast<double>(seg)));
    int lo = 0, hi = nbp;                               // upper bound of p
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_bp[mid] <= p) lo = mid + 1; else hi = mid;
    }
    paa[series * w + s] = p;
    sax[series * w + s] = lo;
  }
}

}  // namespace

extern "C" int isax_summarize_launch(const void* x, const void* bps, void* paa, void* sax,
                                     long long N, int n, int w, int nbp, int normalize,
                                     void* stream) {
  const size_t smem = (static_cast<size_t>(nbp) + static_cast<size_t>(kWarps) * n) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        isax_summarize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (N > 0) {
    const unsigned blocks = static_cast<unsigned>((N + kWarps - 1) / kWarps);
    isax_summarize_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(bps), static_cast<float*>(paa),
        static_cast<int*>(sax), N, n, w, nbp, normalize);
  }
  return static_cast<int>(cudaGetLastError());
}
