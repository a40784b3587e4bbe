// batch_l2: squared Euclidean distances of Q queries to N series,
// out[q, j] = max(||q||^2 + ||x_j||^2 - 2 q.x_j, 0), fp32 in and out.
// Replaces the TPU kernel src/repro/kernels/batch_l2.py (batch_l2).
//
// Bound on the H100: at the flat scan's (100, 4096, 256) the cross term is
// 2QNn = 210 MFLOP, 3.13 us at the 67 TFLOP/s fp32 rate but 1.27 us as
// three TF32 products at 495 TFLOP/s, so bytes bound it (5.94 MB, 1.77 us
// at 3.35 TB/s); bytes at every smaller Q.
//
// Design: the cross term on the tensor cores at full fp32 accuracy, as a
// split-TF32 ("3xTF32") product.  Each operand a is split into
// hi = tf32(a) and lo = tf32(a - hi) (cvt.rna; the subtraction is exact),
// and q.x = hi_q.hi_x + (lo_q.hi_x + hi_q.lo_x), the lo.lo term (2^-22 of
// the product) dropped; each of the three products has its own fp32
// accumulators, summed once at the end, the small terms first.  Products
// are Hopper warpgroup MMAs, wgmma m64n32k8 TF32: the query fragment from
// registers, the series from shared memory, both K-major as they lie in
// memory (q (Q, n) and x (N, n), row-major).
//   * A block owns 32 series (wgmma N) and up to 128 query rows (two
//     warpgroups of 64), so each series row is read from device memory
//     once and N = 4096 gives 128 blocks.
//   * The block's series rows, 256 coordinates at a time, arrive in shared
//     memory by cp.async, every load in flight at once, and one pass splits
//     them into hi and lo planes laid out as wgmma's no-swizzle K-major
//     core matrices (8 rows x 16 bytes), summing ||x||^2 on the way.
//   * Each thread reads its two query rows' fragments straight from device
//     memory, 32 coordinates a step, the next step in flight, and splits
//     them in registers.  Within 32 coordinates the four k8 steps take
//     coordinates {8t + s, 8t + 4 + s} (t = the lane's fragment column,
//     s = the step): the same permutation for both operands (the planes
//     are written in that order), so a thread's coordinates of a row are
//     one 32-byte run.  ||q||^2 is summed from the same registers.
//   * The epilogue forms (qq + xx) - 2 q.x with rounding intrinsics, in the
//     plain version's order, and clamps at 0.  Ragged Q, N and n are
//     zero-filled on load and masked on store; RAW_PAD rows (1e4 splits
//     exactly, ||x||^2 ~ 2.56e10) stay finite.
// Single-pass TF32 (10-bit mantissa) would leave the 1e-5 *
// (||q||^2 + ||x||^2) tolerance; the split product does not.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 128;                  // query rows a block holds: two warpgroups of 64
constexpr int kBN = 32;                   // series a block holds (wgmma N)
constexpr int kKC = 256;                  // coordinates staged at a time
constexpr int kLd = kKC + 4;              // raw staging row stride (words)
constexpr int kPlane = kBN * kKC;         // words of one split plane
constexpr int kSmemBytes = 4 * (kBN * kLd + 2 * kPlane);
using u64 = unsigned long long;

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// wgmma's shared-memory descriptor of a no-swizzle K-major plane from p:
// the leading offset steps to the next 4 coordinates (one 128-byte core
// matrix), the stride offset to the next 8 rows (kKC / 4 core matrices)
__device__ __forceinline__ u64 make_desc(const unsigned* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  const u64 lbo = 128 >> 4, sbo = (kKC / 4) * 128 >> 4;
  return static_cast<u64>((addr >> 4) & 0x3FFF) | (lbo << 16) | (sbo << 32);
}

// wgmma's ordering: fence before products that read freshly written
// registers, commit the issued products as a group, wait for the groups
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += a . b over 8 coordinates: a the warp's 16 x 8 TF32 fragment (the
// m16n8k8 A layout, warp w of the group rows 16w..16w+15), b a 32 x 8
// plane slice; d the m64n32 accumulator fragment
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], unsigned a0, unsigned a1, unsigned a2,
                                           unsigned a3, u64 desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(1));
}

// 8 contiguous coordinates [c, c + 8) of query row r, zero past Q and n
__device__ __forceinline__ void load_q8(float (&v)[8], const float* __restrict__ q, int r,
                                        int Q, int n, int c, bool vec16) {
  if (r >= Q) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.f;
    return;
  }
  const float* p = q + static_cast<size_t>(r) * n + c;
  if (vec16) {                            // n % 4 == 0: a float4 is whole or past n
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 a = c < n ? __ldg(reinterpret_cast<const float4*>(p)) : zero;
    const float4 b = c + 4 < n ? __ldg(reinterpret_cast<const float4*>(p + 4)) : zero;
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = c + i < n ? __ldg(p + i) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
batch_l2_kernel(const float* __restrict__ q, const float* __restrict__ x,
                float* __restrict__ out, int Q, long long N, int n, int vec16) {
  extern __shared__ __align__(128) unsigned smem[];
  unsigned* s_hi = smem;                  // split planes, core-matrix order
  unsigned* s_lo = s_hi + kPlane;
  unsigned* s_raw = s_lo + kPlane;        // kBN x kLd raw series
  __shared__ float s_xx[kBN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2;
  const long long j0 = static_cast<long long>(blockIdx.x) * kBN;
  const int r0 = blockIdx.y * kBM + warp * 16 + g, r1 = r0 + 8;
  const bool active = blockIdx.y * kBM + wg * 64 < Q;    // warpgroup-uniform

  float acc[3][16];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[a][c] = 0.f;
  float qq0 = 0.f, qq1 = 0.f;             // rows r0, r1 over this lane's coordinates
  float xx = 0.f;                         // series row tid / 8 over its coordinates

  for (int kc = 0; kc < n; kc += kKC) {
    const int len = min(kKC, n - kc), len32 = (len + 31) & ~31;
    if (kc > 0) __syncthreads();          // the previous slice is consumed
    // 1. the block's series rows, coordinates [kc, kc + len32), zero-filled
    if (vec16) {
      const int per_row = len32 / 4;
      for (int e = tid; e < kBN * per_row; e += kThreads) {
        const int r = e / per_row, c = 4 * (e % per_row);
        unsigned* dst = s_raw + r * kLd + c;
        if (j0 + r < N && c < len)
          cp_async16(dst, x + static_cast<size_t>(j0 + r) * n + kc + c);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int e = tid; e < kBN * len32; e += kThreads) {
        const int r = e / len32, c = e % len32;
        unsigned* dst = s_raw + r * kLd + c;
        if (j0 + r < N && c < len)
          cp_async4(dst, x + static_cast<size_t>(j0 + r) * n + kc + c);
        else
          *dst = 0u;
      }
    }
    cp_async_commit();
    // the first query coordinates load while the series arrive
    float qa0[8], qa1[8];
    if (active) {
      load_q8(qa0, q, r0, Q, n, kc + 8 * t, vec16);
      load_q8(qa1, q, r1, Q, n, kc + 8 * t, vec16);
    }
    cp_async_wait<0>();
    __syncthreads();
    // 2. split into the planes, in wgmma's order: coordinate sc + pp of a
    // 32-run goes to k8 step s = pp % 4, fragment column c = pp / 8 (+ 4
    // where pp % 8 >= 4)
    {
      const int r = tid >> 3;
      for (int p = 4 * (tid & 7); p < len32; p += 32) {
        const uint4 raw = *reinterpret_cast<const uint4*>(s_raw + r * kLd + p);
        const float v[4] = {__uint_as_float(raw.x), __uint_as_float(raw.y),
                            __uint_as_float(raw.z), __uint_as_float(raw.w)};
        const int sc = p & ~31, pp = p & 31;
        const int c = (pp >> 3) + ((pp & 4) ? 4 : 0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          unsigned h, l;
          split(v[e], h, l);
          xx = fmaf(v[e], v[e], xx);
          const int k = sc + 8 * e + c;   // position in wgmma's K order
          const int w = ((r >> 3) * (kKC / 4) + (k >> 2)) * 32 + (r & 7) * 4 + (k & 3);
          s_hi[w] = h;
          s_lo[w] = l;
        }
      }
    }
    // the planes were written by ordinary stores; wgmma reads them through
    // the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    // 3. the warpgroup's 64 rows against the 32 series, 32 coordinates a step
    if (active) {
#pragma unroll
      for (int i = 0; i < kKC / 32; ++i) {
        const int sc = 32 * i;
        if (sc >= len32) break;
        float na0[8], na1[8];
        const bool more = sc + 32 < len32;
        if (more) {
          load_q8(na0, q, r0, Q, n, kc + sc + 32 + 8 * t, vec16);
          load_q8(na1, q, r1, Q, n, kc + sc + 32 + 8 * t, vec16);
        }
        unsigned ah0[8], al0[8], ah1[8], al1[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          split(qa0[e], ah0[e], al0[e]);
          split(qa1[e], ah1[e], al1[e]);
          qq0 = fmaf(qa0[e], qa0[e], qq0);
          qq1 = fmaf(qa1[e], qa1[e], qq1);
        }
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const u64 dh = make_desc(s_hi + (sc / 4 + 2 * s) * 32);
          const u64 dl = make_desc(s_lo + (sc / 4 + 2 * s) * 32);
          wgmma_tf32(acc[1], al0[s], al1[s], al0[4 + s], al1[4 + s], dh);
          wgmma_tf32(acc[2], ah0[s], ah1[s], ah0[4 + s], ah1[4 + s], dl);
          wgmma_tf32(acc[0], ah0[s], ah1[s], ah0[4 + s], ah1[4 + s], dh);
        }
        wgmma_commit();
        wgmma_wait<0>();                  // the fragments' registers are reused
        if (more) {
#pragma unroll
          for (int e = 0; e < 8; ++e) { qa0[e] = na0[e]; qa1[e] = na1[e]; }
        }
      }
    }
  }

  // ||x||^2 over the 8 threads of a series row, ||q||^2 over the 4 lanes of
  // a fragment row
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) xx += __shfl_xor_sync(0xffffffffu, xx, off);
  if ((tid & 7) == 0) s_xx[tid >> 3] = xx;
  float qq[2] = {qq0, qq1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qq[h] += __shfl_xor_sync(0xffffffffu, qq[h], 1);
    qq[h] += __shfl_xor_sync(0xffffffffu, qq[h], 2);
  }
  __syncthreads();
  if (!active) return;
  const bool pairs = (N % 2) == 0;        // float2 stores stay 8-byte aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qr = h ? r1 : r0;
    if (qr >= Q) continue;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = j * 8 + 2 * t;
      const long long jj = j0 + col;
      float dv[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 4 * j + 2 * h + c;  // the m16n8 C layout, tile j
        const float cross = acc[0][e] + (acc[1][e] + acc[2][e]);
        const float d = __fsub_rn(__fadd_rn(qq[h], s_xx[col + c]), __fmul_rn(2.f, cross));
        dv[c] = fmaxf(d, 0.f);
      }
      float* o = out + static_cast<size_t>(qr) * N + jj;
      if (pairs && jj + 1 < N) {
        *reinterpret_cast<float2*>(o) = make_float2(dv[0], dv[1]);
      } else {
        if (jj < N) o[0] = dv[0];
        if (jj + 1 < N) o[1] = dv[1];
      }
    }
  }
}

}  // namespace

extern "C" int batch_l2_launch(const void* q, const void* x, void* out, int Q,
                               long long N, int n, void* stream) {
  if (Q <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(
      batch_l2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int vec16 = n % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0
      && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(static_cast<unsigned>((N + kBN - 1) / kBN),
                  static_cast<unsigned>((Q + kBM - 1) / kBM));
  batch_l2_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(x),
      static_cast<float*>(out), Q, N, n, vec16);
  return static_cast<int>(cudaGetLastError());
}
