// lb_scan: squared MINDIST lower bounds of Q query PAAs against N planar
// region bounds, out[q, j] = (n/w) * sum_s max(0, lo[s, j] - q[s], q[s] - hi[s, j])^2.
// Replaces the TPU kernel src/repro/kernels/lb_scan.py (lb_scan).
//
// Where it runs: the flat ParIS schedule scans every series with it once a
// batch (engine.run_flat over flat_view's (w, Np) bounds: (100, 16, 10M) at
// 10M series), and block ranking runs it over the (w, B) block envelopes
// (engine.prepare, frontier stage A, and DTW's two passes against planes of
// +-SENTINEL in engine.interval_planar_lb).
//
// Bound on the H100.  Bytes: lo/hi read once and the (Q, N) result written
// once, 5.28 GB at the flat shape, 1.576 ms at 3.35 TB/s.  Issue: the term
// takes four fp32 instructions here (two FMNMX, one FADD, one FFMA; five in
// its literal form), 6.4e10 at the flat shape, which at one warp
// instruction a clock on each of the 528 schedulers (1.98 GHz) is 1.91 ms;
// with the shared loads and the loop the SASS holds ~4.3 instructions a
// term, ~2.06 ms: the kernel is bounded by instruction issue, not bytes.
//
// Design:
//   * a block owns a slice of columns and stages its lo/hi rows in shared
//     memory once (cp.async, 16 bytes where the rows are 16-byte aligned,
//     else 4 bytes with a warp on 32 neighbouring columns; columns past N
//     are 0), then sweeps every query of its range against them, so a wide
//     N reads lo/hi from device memory once whatever Q is (the queries'
//     PAAs are staged transposed, kQChunk at a time, so Q is unbounded);
//   * a thread holds a 4-query x 4-column register tile: 16 independent
//     accumulators, and per segment one broadcast 16-byte shared load of 4
//     query values and two 16-byte loads of lo and hi, at compile-time
//     strides, for 64 instructions of arithmetic;
//   * the warps of a block are CW column-warps x rows query-rows; the rows
//     take the query groups of 4 in turn.  The launcher picks by shape: a
//     wide N (the flat scan) 256-column slices, 4 rows, every query in one
//     block; a narrow N (the envelopes, 9,766 columns) 128-column slices and
//     the queries split over grid.y until the card holds ~16 warps an SM;
//   * the term is max(max(lo - q, q - hi), 0), squared and added with one
//     FMA, the segments in order, the sum scaled by n/w once.  A slice whose
//     columns all have lo <= hi (every bound of the index) evaluates it as
//     q - min(max(q, lo), hi), bitwise the same square (see term4);
//   * results go out as 16-byte streaming stores (__stcs: the flat scan
//     reads them back chunk by chunk much later) where a row is 16-byte
//     aligned (N % 4 == 0), 4-byte ones otherwise; the ragged N and Q edges
//     are masked here; no SENTINEL padding copy is made.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxW = 32;
constexpr int kThreads = 256;      // most threads a block
constexpr int kQT = 4;             // queries a thread
constexpr int kCT = 4;             // columns a thread
constexpr int kWarpCols = 32 * kCT;
constexpr int kQChunk = 128;       // queries staged at once

// One query against 4 columns, each term max(max(lo - q, q - hi), 0)
// squared into acc with one FMA.  kClamp evaluates the term as
// q - min(max(q, lo), hi), one instruction fewer: where lo <= hi that is
// the same float up to its sign (q < lo gives q - lo, the same rounded
// subtraction as lo - q negated; q > hi gives q - hi; between, exactly 0),
// so its square is bitwise the literal form's.  A slice that holds a
// column with lo > hi takes the literal form.
template <bool kClamp>
__device__ __forceinline__ void term4(float (&acc)[kCT], float q, const float4& l,
                                      const float4& h) {
  const float lv[kCT] = {l.x, l.y, l.z, l.w};
  const float hv[kCT] = {h.x, h.y, h.z, h.w};
#pragma unroll
  for (int b = 0; b < kCT; ++b) {
    const float d = kClamp ? q - fminf(fmaxf(q, lv[b]), hv[b])
                           : fmaxf(fmaxf(lv[b] - q, q - hv[b]), 0.f);
    acc[b] = fmaf(d, d, acc[b]);
  }
}

// A warp row's query groups of the staged chunk against its 4 columns.
// The strides are compile-time, so every shared load takes an immediate
// offset and the segment loop carries no address arithmetic.
template <int CW, bool kClamp>
__device__ __forceinline__ void sweep(const float* s_q, int qn, const float* s_col,
                                      int w, int row, int rows, float* out, long long N,
                                      long long jt, int qc, float scale, int vec_out) {
  constexpr int kCols = CW * kWarpCols;
  const float4* lp = reinterpret_cast<const float4*>(s_col);
  const float4* hp = reinterpret_cast<const float4*>(s_col + w * kCols);
  for (int g = row; kQT * g < qn; g += rows) {
    const float4* qp = reinterpret_cast<const float4*>(s_q) + g;
    float acc[kQT][kCT];
#pragma unroll
    for (int a = 0; a < kQT; ++a)
#pragma unroll
      for (int b = 0; b < kCT; ++b) acc[a][b] = 0.f;
#pragma unroll 4
    for (int s = 0; s < w; ++s) {
      const float4 qv = qp[s * (kQChunk / 4)];
      const float4 l = lp[s * (kCols / 4)];
      const float4 h = hp[s * (kCols / 4)];
      term4<kClamp>(acc[0], qv.x, l, h);
      term4<kClamp>(acc[1], qv.y, l, h);
      term4<kClamp>(acc[2], qv.z, l, h);
      term4<kClamp>(acc[3], qv.w, l, h);
    }
    // the ragged Q and N edges masked; 4-byte stores where rows are unaligned
#pragma unroll
    for (int a = 0; a < kQT; ++a) {
      if (kQT * g + a >= qn) break;
      float* dst = out + static_cast<long long>(qc + kQT * g + a) * N + jt;
      if (vec_out && jt + 3 < N) {
        __stcs(reinterpret_cast<float4*>(dst),
               make_float4(scale * acc[a][0], scale * acc[a][1], scale * acc[a][2],
                           scale * acc[a][3]));
      } else {
#pragma unroll
        for (int b = 0; b < kCT; ++b)
          if (jt + b < N) __stcs(dst + b, scale * acc[a][b]);
      }
    }
  }
}

// A block: a slice of CW * 128 columns (blockIdx.x) against the queries
// [blockIdx.y * q_per_block, ...) of Q.  Shared memory: s_lo, s_hi
// [w][CW * 128], then s_q [w][kQChunk], the chunk's PAAs transposed.
template <int CW>
__global__ void __launch_bounds__(kThreads)
lb_scan_kernel(const float* __restrict__ q_paa, const float* __restrict__ lo,
               const float* __restrict__ hi, float* __restrict__ out, int Q,
               long long N, int w, float scale, int q_per_block, int vec_in, int vec_out) {
  constexpr int kCols = CW * kWarpCols;
  extern __shared__ float4 smem4[];
  float* s_lo = reinterpret_cast<float*>(smem4);
  float* s_hi = s_lo + w * kCols;
  float* s_q = s_hi + w * kCols;
  const long long j0 = static_cast<long long>(blockIdx.x) * kCols;

  // the slice's lo/hi rows, once: 16-byte copies where rows are aligned,
  // else 4-byte copies with a warp on 32 neighbouring columns
  if (vec_in) {
    for (int i = threadIdx.x; i < w * kCols / 4; i += blockDim.x) {
      const int s = i / (kCols / 4), c = 4 * (i % (kCols / 4));
      const long long j = j0 + c;
      float* dl = s_lo + s * kCols + c;
      float* dh = s_hi + s * kCols + c;
      if (j + 3 < N) {
        cp_async16(dl, lo + s * N + j);
        cp_async16(dh, hi + s * N + j);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j + e < N) {
            cp_async4(dl + e, lo + s * N + j + e);
            cp_async4(dh + e, hi + s * N + j + e);
          } else {
            dl[e] = 0.f;
            dh[e] = 0.f;
          }
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < w * kCols; i += blockDim.x) {
      const int s = i / kCols, c = i % kCols;
      const long long j = j0 + c;
      if (j < N) {
        cp_async4(s_lo + i, lo + s * N + j);
        cp_async4(s_hi + i, hi + s * N + j);
      } else {
        s_lo[i] = 0.f;
        s_hi[i] = 0.f;
      }
    }
  }
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = blockDim.x / 32 / CW;
  const int row = warp / CW;
  const int c0 = (warp % CW) * kWarpCols + lane * kCT;
  const long long jt = j0 + c0;
  const int qb0 = static_cast<int>(blockIdx.y) * q_per_block;
  const int qb1 = Q - qb0 < q_per_block ? Q : qb0 + q_per_block;
  bool literal = false;

  for (int qc = qb0; qc < qb1; qc += kQChunk) {
    const int qn = min(kQChunk, qb1 - qc);
    __syncthreads();                          // the last chunk's s_q is read
    for (int i = threadIdx.x; i < w * qn; i += blockDim.x) {   // transposed
      const int q = i / w, s = i - q * w;
      s_q[s * kQChunk + q] = q_paa[static_cast<long long>(qc) * w + i];
    }
    cp_async_wait<0>();
    __syncthreads();
    if (qc == qb0) {                          // does the slice hold lo > hi?
      bool inverted = false;
      for (int i = threadIdx.x; i < w * kCols / 4; i += blockDim.x) {
        const float4 l = smem4[i], h = smem4[w * kCols / 4 + i];
        inverted |= (l.x > h.x) | (l.y > h.y) | (l.z > h.z) | (l.w > h.w);
      }
      literal = __syncthreads_or(inverted);
    }
    if (literal)
      sweep<CW, false>(s_q, qn, s_lo + c0, w, row, rows, out, N, jt, qc, scale, vec_out);
    else
      sweep<CW, true>(s_q, qn, s_lo + c0, w, row, rows, out, N, jt, qc, scale, vec_out);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int CW>
cudaError_t launch(const float* q_paa, const float* lo, const float* hi, float* out, int Q,
                   long long N, int w, float scale, int rows, int q_per_block, long long by,
                   cudaStream_t stream) {
  constexpr int kCols = CW * kWarpCols;
  const size_t smem = sizeof(float) * static_cast<size_t>(w) * (2 * kCols + kQChunk);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lb_scan_kernel<CW>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int vec_in = (N % 4 == 0) && aligned16(lo) && aligned16(hi);
  const int vec_out = (N % 4 == 0) && aligned16(out);
  const dim3 grid(static_cast<unsigned>((N + kCols - 1) / kCols), static_cast<unsigned>(by));
  lb_scan_kernel<CW><<<grid, 32 * CW * rows, smem, stream>>>(q_paa, lo, hi, out, Q, N, w, scale,
                                                            q_per_block, vec_in, vec_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lb_scan_launch(const void* q_paa, const void* lo, const void* hi, void* out,
                              int Q, long long N, int w, float scale, void* stream) {
  if (w < 1 || w > kMaxW) return static_cast<int>(cudaErrorInvalidValue);
  if (Q <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // A wide N (more than 8 slices of 256 columns an SM): 256-column slices,
  // 4 warp rows, every query in one block, so lo/hi are read once.  A
  // narrow N (the block envelopes): 128-column slices, up to 8 warp rows,
  // and the queries split over grid.y until the card holds ~16 warps an SM.
  const bool wide = N > 2048LL * sms;
  const int cw = wide ? 2 : 1;
  const long long bx = (N + cw * kWarpCols - 1) / (cw * kWarpCols);
  const long long groups = (Q + kQT - 1) / kQT;
  int rows = kThreads / 32 / cw;
  long long split = (16LL * sms + bx * cw * rows - 1) / (bx * cw * rows);
  split = std::max(1LL, std::min({split, (groups + rows - 1) / rows, 65535LL}));
  const long long g_per_block = (groups + split - 1) / split;
  const int q_per_block = static_cast<int>(g_per_block * kQT);
  const long long by = (Q + q_per_block - 1) / q_per_block;
  rows = static_cast<int>(std::min<long long>(rows, g_per_block));
  const float* qp = static_cast<const float*>(q_paa);
  const float* l = static_cast<const float*>(lo);
  const float* h = static_cast<const float*>(hi);
  float* o = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cw == 2 ? launch<2>(qp, l, h, o, Q, N, w, scale, rows, q_per_block, by, st)
              : launch<1>(qp, l, h, o, Q, N, w, scale, rows, q_per_block, by, st);
  return static_cast<int>(e);
}
