// isax_summarize: optional z-normalization, PAA over w equal segments, and
// the iSAX symbol of each segment (the count of breakpoints <= the PAA value).
// Replaces the TPU kernel src/repro/kernels/isax_summarize.py (isax_summarize).
//
// Bound on the H100: bytes.  The (N, n) series are read once (4 bytes a
// point) and (N, w) PAA values and symbols written; the arithmetic is a
// few operations a point.  Design: one warp per series, lanes on
// consecutive points so every load is coalesced.  The warp stages its
// series in shared memory; with normalization on, warp reductions give the
// mean and then the population variance about it (two passes over the
// staged copy, as the plain z-norm does — E[x^2] - mean^2 loses digits on
// random walks whose offset is large against their spread).  Lane s then
// averages segment s, and finds its symbol by binary search over the
// ascending breakpoint table, which the caller passes in (scipy's float32
// values), so the symbols quantize against the same bits as the plain
// version's compare.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

  float sum = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float v = xr[j];
    s_x[j] = v;
    sum += v;
  }
  if (normalize) {
    const float mu = warp_sum(sum) / static_cast<float>(n);
    float ss = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float c = s_x[j] - mu;
      ss += c * c;
    }
    const float sd = sqrtf(warp_sum(ss) / static_cast<float>(n));
    const float den = fmaxf(sd, 1e-8f);
    for (int j = lane; j < n; j += 32) s_x[j] = (s_x[j] - mu) / den;
  }
  __syncwarp();

  const int seg = n / w;
  for (int s = lane; s < w; s += 32) {
    const float* xs = s_x + s * seg;
    float acc = 0.f;
    for (int t = 0; t < seg; ++t) acc += xs[t];
    const float p = acc / static_cast<float>(seg);
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
