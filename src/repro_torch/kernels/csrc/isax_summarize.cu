// isax_summarize: optional z-normalization, PAA over w equal segments, and
// the iSAX symbol of each segment (the count of breakpoints <= the PAA value).
// Replaces the TPU kernel src/repro/kernels/isax_summarize.py (isax_summarize).
//
// Bound on the H100: bytes.  The (N, n) series are read once (4 bytes a
// point) and (N, w) PAA values and symbols written; without z-norm the
// arithmetic is one float64 add a point, with it about seven, and even
// then the float64 rate (34 TFLOP/s) leaves bytes the bound.  Design: every
// lane works on one (series, segment) pair, L lanes a series (L = w rounded
// up to a power of two, 4 to 32; a lane takes segments s, s + L, ... when
// w > 32), so at w = 16 a warp holds two series.
//   * normalize off (the build's mode): each lane reads its segment straight
//     from device memory, 16 bytes a load where n / w is a multiple of 4
//     (so a warp reads 2 KB that lie together), 4 bytes a load otherwise;
//     with one group of series a warp and many warps an SM, some warps'
//     loads are in flight while others sum and search (loading a second
//     group ahead in each warp measured no faster);
//   * normalize on: each lane loads its segments the same way and stages
//     them in shared memory as float64 (one conversion a point), a pad
//     word after every segment so that the segment walks and the
//     lane-order sums both fall on distinct banks; then the mean, the
//     variance and the PAA, all lanes busy, with no integer division in
//     the loops;
//   * the symbol is a binary search over the ascending breakpoint table
//     (scipy's float32 values, passed in by the caller) in shared memory.
//
// The card's symbols are bitwise those of the plain version
// (ref.isax_summarize_ref), because both evaluate the same float64
// operations in the same order and round the PAA to float32 once:
//   * the mean and the variance about it in the order of a warp that holds
//     point j on lane j % 32 (ref._lane_sum): each of those 32 "virtual
//     lanes" sums its points in order, then the 32 sums meet in an xor
//     butterfly (offsets 16, 8, 4, 2, 1).  A physical lane p of a series
//     holds the virtual lanes p, p + L, ...; the butterfly's offsets >= L
//     combine them in its registers, the rest are shuffles.  a + b == b + a
//     bitwise, so every lane of the butterfly ends with the same value;
//   * each point z-normed as (x - mean) / max(sqrt(var), 1e-8);
//   * each window summed point by point in order, divided by its length (a
//     power-of-two length multiplies by its exact reciprocal: both are the
//     correctly rounded value of the same quotient).
// Every operation is a correctly rounded intrinsic (__dadd_rn, __dsub_rn,
// __dmul_rn, __ddiv_rn, __dsqrt_rn), so nvcc contracts nothing into an
// FMA and no approximate reciprocal or rsqrt enters.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 16;         // points a lane loads at once
constexpr int kZnormSmem = 96 * 1024;   // shared memory a z-norm block aims for

__device__ __forceinline__ int symbol_of(const float* s_bp, int nbp, float p) {
  int lo = 0, hi = nbp;                                 // upper bound of p
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_bp[mid] <= p) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ float window_mean(double acc, int seg, bool pow2, double inv) {
  return __double2float_rn(pow2 ? __dmul_rn(acc, inv) : __ddiv_rn(acc, static_cast<double>(seg)));
}

// the first m <= kBatch points at src into v, by float4 when vec
__device__ __forceinline__ void load_batch(float (&v)[kBatch], const float* src, int m, bool vec) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kBatch / 4; ++q) {
      if (4 * q < m) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(src) + q);
        v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (i < m) v[i] = __ldg(src + i);
  }
}

__device__ __forceinline__ void add_batch(double& acc, const float (&v)[kBatch], int m) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i)
    if (i < m) acc = __dadd_rn(acc, static_cast<double>(v[i]));
}

// normalize off.  L lanes a series, 32 / L series a warp ("a group").
template <int L>
__global__ void __launch_bounds__(kThreads)
isax_summarize_kernel(const float* __restrict__ x, const float* __restrict__ bps,
                      float* __restrict__ paa, int* __restrict__ sax, long long N, int n, int w,
                      int nbp, int vec) {
  constexpr int SPW = 32 / L;
  extern __shared__ float s_bp[];                        // nbp
  for (int i = threadIdx.x; i < nbp; i += kThreads) s_bp[i] = bps[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, p = lane % L, h = lane / L;
  const int seg = n / w;
  const bool pow2 = (seg & (seg - 1)) == 0;
  const double inv = 1.0 / static_cast<double>(seg);
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long series = warp * SPW + h;
  if (series >= N) return;                              // no block barrier below
  for (int s = p; s < w; s += L) {
    const float* src = x + series * n + static_cast<long long>(s) * seg;
    double acc = 0.0;
    for (int j = 0; j < seg; j += kBatch) {
      const int m = min(seg - j, kBatch);
      float v[kBatch];
      load_batch(v, src + j, m, vec);
      add_batch(acc, v, m);
    }
    const float pv = window_mean(acc, seg, pow2, inv);
    paa[series * w + s] = pv;
    sax[series * w + s] = symbol_of(s_bp, nbp, pv);
  }
}

// The lane-order sum of a series' values f(index of point j), j < n, where
// point j is stored at j + j / seg: this lane holds the virtual lanes
// p + k L (k < 32 / L); see the header.  j / seg is stepped along with j.
template <int L, typename F>
__device__ __forceinline__ double lane_order_sum(int p, int n, int seg, F f) {
  constexpr int KV = 32 / L;
  const int q32 = 32 / seg, r32 = 32 % seg;
  double v[KV];
#pragma unroll
  for (int k = 0; k < KV; ++k) {
    v[k] = 0.0;
    int j = p + k * L, q = j / seg, r = j - q * seg;
    for (; j < n; j += 32) {
      v[k] = __dadd_rn(v[k], f(j + q));
      q += q32;
      r += r32;
      if (r >= seg) { r -= seg; ++q; }
    }
  }
#pragma unroll
  for (int off = 16; off >= L; off >>= 1) {             // offsets held in registers
    const int jk = off / L;
#pragma unroll
    for (int k = 0; k < jk; ++k) v[k] = __dadd_rn(v[k], v[k + jk]);
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)             // offsets across lanes
    v[0] = __dadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], off));
  return v[0];
}

// normalize on.  Each warp stages a group of 32 / L series in shared
// memory as float64, each lane its own segments (loaded as above), segment
// s of series h at h * stride + s * (seg + 1): a pad word after each
// segment keeps both the segment walks and the lane-order sums on
// distinct banks.
template <int L>
__global__ void __launch_bounds__(kThreads)
isax_summarize_znorm_kernel(const float* __restrict__ x, const float* __restrict__ bps,
                            float* __restrict__ paa, int* __restrict__ sax, long long N, int n,
                            int w, int nbp, int vec, int stride) {
  constexpr int SPW = 32 / L;
  extern __shared__ double smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  float* s_bp = reinterpret_cast<float*>(smem + warps * SPW * stride);   // nbp
  for (int i = threadIdx.x; i < nbp; i += blockDim.x) s_bp[i] = bps[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, p = lane % L, h = lane / L;
  const int seg = n / w;
  const bool pow2 = (seg & (seg - 1)) == 0;
  const double inv = 1.0 / static_cast<double>(seg);
  const double dn = static_cast<double>(n);
  double* sx = smem + (warp * SPW + h) * stride;
  const long long g0 = static_cast<long long>(blockIdx.x) * warps + warp;   // this warp's group
  if (g0 * SPW >= N) return;                            // no block barrier below
  const long long series = g0 * SPW + h;
  const bool on = series < N;
  if (on) {
    for (int s = p; s < w; s += L) {
      const float* src = x + series * n + static_cast<long long>(s) * seg;
      double* dst = sx + s * (seg + 1);
      for (int j = 0; j < seg; j += kBatch) {
        const int m = min(seg - j, kBatch);
        float v[kBatch];
        load_batch(v, src + j, m, vec);
#pragma unroll
        for (int i = 0; i < kBatch; ++i)
          if (i < m) dst[j + i] = static_cast<double>(v[i]);
      }
    }
  }
  __syncwarp();

  // every lane takes part in the shuffles; a series past N sums stale
  // shared memory and stores nothing
  const double mu = __ddiv_rn(lane_order_sum<L>(p, n, seg, [&](int i) { return sx[i]; }), dn);
  const double var = __ddiv_rn(lane_order_sum<L>(p, n, seg, [&](int i) {
    const double c = __dsub_rn(sx[i], mu);
    return __dmul_rn(c, c);
  }), dn);
  const double den = fmax(__dsqrt_rn(var), 1e-8);
  if (on) {
    for (int s = p; s < w; s += L) {
      const double* xs = sx + s * (seg + 1);
      double acc = 0.0;
      for (int t = 0; t < seg; ++t)
        acc = __dadd_rn(acc, __ddiv_rn(__dsub_rn(xs[t], mu), den));
      const float pv = window_mean(acc, seg, pow2, inv);
      paa[series * w + s] = pv;
      sax[series * w + s] = symbol_of(s_bp, nbp, pv);
    }
  }
}

template <int L>
cudaError_t launch(const float* x, const float* bps, float* paa, int* sax, long long N, int n,
                   int w, int nbp, bool normalize, cudaStream_t stream) {
  constexpr int SPW = 32 / L;
  const long long groups = (N + SPW - 1) / SPW;
  // 16-byte loads where every segment starts 16-byte aligned
  const int vec = (reinterpret_cast<uintptr_t>(x) & 15u) == 0 && (n / w) % 4 == 0;
  if (!normalize) {
    const size_t smem = static_cast<size_t>(nbp) * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          isax_summarize_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    const unsigned blocks = static_cast<unsigned>((groups + kWarps - 1) / kWarps);
    isax_summarize_kernel<L><<<blocks, kThreads, smem, stream>>>(x, bps, paa, sax, N, n, w, nbp,
                                                                 vec);
    return cudaGetLastError();
  }
  const int stride = n + w;                             // a pad word after every segment
  const size_t warp_bytes = static_cast<size_t>(SPW) * stride * sizeof(double);
  const size_t bp_bytes = static_cast<size_t>(nbp) * sizeof(float);
  const int warps = static_cast<int>(
      std::max<size_t>(1, std::min<size_t>(kWarps, (kZnormSmem - bp_bytes) / warp_bytes)));
  const size_t smem = warps * warp_bytes + bp_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        isax_summarize_znorm_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }

  const unsigned blocks = static_cast<unsigned>((groups + warps - 1) / warps);
  isax_summarize_znorm_kernel<L><<<blocks, 32 * warps, smem, stream>>>(x, bps, paa, sax, N, n, w,
                                                                       nbp, vec, stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" int isax_summarize_launch(const void* x, const void* bps, void* paa, void* sax,
                                     long long N, int n, int w, int nbp, int normalize,
                                     void* stream) {
  if (N <= 0) return static_cast<int>(cudaGetLastError());
  if (w <= 0 || n % w != 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* x_ = static_cast<const float*>(x);
  const auto* b_ = static_cast<const float*>(bps);
  auto* p_ = static_cast<float*>(paa);
  auto* s_ = static_cast<int*>(sax);
  const auto st = static_cast<cudaStream_t>(stream);
  const bool nz = normalize != 0;
  cudaError_t e;
  if (w <= 4) e = launch<4>(x_, b_, p_, s_, N, n, w, nbp, nz, st);
  else if (w <= 8) e = launch<8>(x_, b_, p_, s_, N, n, w, nbp, nz, st);
  else if (w <= 16) e = launch<16>(x_, b_, p_, s_, N, n, w, nbp, nz, st);
  else e = launch<32>(x_, b_, p_, s_, N, n, w, nbp, nz, st);
  return static_cast<int>(e);
}
