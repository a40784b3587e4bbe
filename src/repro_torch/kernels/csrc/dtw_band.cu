// dtw_band_panel: Sakoe-Chiba banded squared DTW of each query against a
// panel of candidate series: the cost of the corner cell (n-1, n-1).
// Shared form: x (C, n), out[q, c] = DTW_r(q, x[c]).  Gathered form:
// x (Q, M, n), out[q, m] = DTW_r(q, x[q, m]).
// Replaces the TPU kernel src/repro/kernels/dtw_band.py (dtw_band_panel).
//
// Bound on the H100: fp32 operations, about 6 per band cell (a sub, a mul,
// three mins and an add) and n(2r+1) - r(r+1) band cells a pair.  The TPU
// kernel sweeps all n cells of each of the 2n-1 anti-diagonals and masks;
// here only the band is computed.  The TPU's planar diagonal-extraction
// buffer is a VMEM layout device and is not carried over.
//
// Two variants of one thread per (query, candidate) pair, chosen by the
// band alone (after r = min(r, n - 1)):
//
// * r <= kMaxRegR (16): dtw_band_reg_kernel<R>, R = r at compile time.
//   The band row (2R+1 costs) and the candidate window b[i-R .. i+R] live
//   in registers, so a cell costs no memory access; the window moves by
//   one point a row, read from shared memory, and the costs of row i
//   overwrite those of row i-1 in place (cell (i, j) at offset
//   o = j - i + R reads (i-1, j-1) at o and (i-1, j) at o+1 before they
//   are overwritten, and (i, j-1) is the value just computed).  Rows go
//   in chunks of kRows, unrolled, so the window is a register array with
//   compile-time indices and the compiler interleaves the chains of
//   neighbouring rows.  The block's candidate rows are staged through
//   shared memory in tiles of kTile points x kThreads rows with 4-byte
//   cp.async (a warp copies 32 consecutive points of one row: whole
//   128-byte lines), laid out [row][point] with a stride of kTile + 1 so
//   that each thread's read of its own row hits its own bank; the next
//   tile is copied while this one is computed.  Each value of b is read
//   from device memory once.
// * r > kMaxRegR: dtw_band_wide_kernel, one band row per thread in shared
//   memory, [offset][thread] (the first design).
//
// Bitwise equal to the plain anti-diagonal version in both variants: every
// cell is c + min(three neighbours) with c = (a - b) * (a - b) through the
// rounding intrinsics (no FMA contraction), and min is exact, so the order
// of evaluation changes no bit.  The register variant keeps the costs
// unclamped, off-band and off-matrix cells at +inf, and clamps the corner
// to float32 max once: by induction every cell is then the plain version's
// clamped cell, or +inf where that one is float32 max, because
// min(clamp(x), clamp(y)) = clamp(min(x, y)) and c + float32 max and
// c + inf both clamp to float32 max for c >= 0.
#include "common.cuh"

namespace {

constexpr int kMaxSmem = 227 * 1024;      // dynamic shared memory a block may use
constexpr int kMaxRegR = 16;              // widest band held in registers
constexpr int kThreads = 128;             // pairs per block, register variant
constexpr int kTile = 32;                 // points per staged tile
constexpr int kRows = 8;                  // rows per unrolled chunk
constexpr int kStride = kTile + 1;        // smem row stride: conflict-free reads

// Tile t holds points [t * kTile + R, (t + 1) * kTile + R) of the block's
// rows: the window values that rows [t * kTile, (t + 1) * kTile) bring in.
template <int R>
__device__ __forceinline__ void stage_tile(float* dst, const float* rows, int t,
                                           int n_rows, int n) {
  const int p0 = t * kTile + R;
  for (int e = threadIdx.x; e < kThreads * kTile; e += kThreads) {
    const int row = e / kTile, p = e % kTile;
    if (row < n_rows && p0 + p < n)
      cp_async4(dst + row * kStride + p, rows + static_cast<size_t>(row) * n + p0 + p);
  }
  cp_async_commit();
}

// Rows i0 .. i0 + rows - 1 of the band, rows <= kRows; a = the query from
// row i0, win[u + o] = b[i0 + u - R + o].  With rows == kRows (a constant
// after inlining) the chunk is straight-line code, and the scheduler
// overlaps the dependency chains of neighbouring rows.
template <int R>
__device__ __forceinline__ void band_rows(const float* a, const float (&win)[2 * R + kRows],
                                          float (&band)[2 * R + 1], int rows) {
  constexpr int W = 2 * R + 1;
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    if (u < rows) {
      const float av = a[u];
      float left = pos_inf();                      // (i, i - R - 1): off band
#pragma unroll
      for (int o = 0; o < W; ++o) {
        const float d = __fsub_rn(av, win[u + o]);
        const float c = __fmul_rn(d, d);
        // (i-1, j-1) at o, (i-1, j) at o+1 (off band past 2R), (i, j-1)
        const float up = o + 1 < W ? fminf(band[o], band[o + 1]) : band[o];
        left = __fadd_rn(c, fminf(up, left));
        band[o] = left;
      }
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
dtw_band_reg_kernel(const float* __restrict__ q, const float* __restrict__ x,
                    float* __restrict__ out, int M, int n, int gathered) {
  constexpr int W = 2 * R + 1;            // band cells a row
  extern __shared__ float smem[];
  float* s_q = smem;                                   // n
  float* s_b = smem + ((n + 3) & ~3);                  // 2 x kThreads x kStride
  const int qi = blockIdx.y;
  const long long m0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int n_rows = static_cast<int>(min(static_cast<long long>(kThreads), M - m0));
  const float* rows =
      x + (static_cast<size_t>(gathered ? qi : 0) * M + static_cast<size_t>(m0)) * n;
  const int n_tiles = (n + kTile - 1) / kTile;

  stage_tile<R>(s_b, rows, 0, n_rows, n);
  for (int i = threadIdx.x; i < n; i += kThreads) s_q[i] = q[static_cast<size_t>(qi) * n + i];

  const int t_row = threadIdx.x;
  const bool real = t_row < n_rows;
  const float* b = rows + static_cast<size_t>(real ? t_row : 0) * n;
  // win[u + o] = b[i0 - R + u + o] for the rows i0 + u of a chunk
  float win[2 * R + kRows];
#pragma unroll
  for (int e = 0; e < 2 * R; ++e) {
    const int j = e - R;
    win[e] = (real && j >= 0 && j < n) ? __ldg(b + j) : pos_inf();
  }
  float band[W];
#pragma unroll
  for (int o = 0; o < W; ++o) band[o] = pos_inf();
  band[R] = 0.f;                          // so that cell (0, 0) costs c + 0

  for (int t = 0; t < n_tiles; ++t) {
    const float* tile = s_b + (t & 1) * kThreads * kStride;
    if (t + 1 < n_tiles) {
      stage_tile<R>(s_b + ((t + 1) & 1) * kThreads * kStride, rows, t + 1, n_rows, n);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* mine = tile + t_row * kStride;
    const int i_end = min(n, (t + 1) * kTile);
    for (int i0 = t * kTile; i0 < i_end; i0 += kRows) {
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int p = i0 - t * kTile + u;          // window point i0 + u + R
        win[2 * R + u] = (i0 + u + R < n) ? mine[p] : pos_inf();
      }
      if (i0 + kRows <= i_end) {
        band_rows<R>(s_q + i0, win, band, kRows);   // one basic block: rows overlap
      } else {
        band_rows<R>(s_q + i0, win, band, i_end - i0);
      }
#pragma unroll
      for (int e = 0; e < 2 * R; ++e) win[e] = win[e + kRows];
    }
    __syncthreads();                                 // the tile may be restaged
  }
  if (real)
    out[static_cast<size_t>(qi) * M + m0 + t_row] = fminf(band[R], REPRO_INF);
}

__global__ void dtw_band_wide_kernel(const float* __restrict__ q,
                                     const float* __restrict__ x,
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

template <int R>
cudaError_t launch_reg(const float* q, const float* x, float* out, int Q, int M,
                       int n, int gathered, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>((n + 3) & ~3) + 2 * kThreads * kStride) * 4;
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dtw_band_reg_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>((M + kThreads - 1) / kThreads),
                  static_cast<unsigned>(Q));
  dtw_band_reg_kernel<R><<<grid, kThreads, smem, stream>>>(q, x, out, M, n, gathered);
  return cudaSuccess;
}

template <int R>
cudaError_t dispatch_reg(int r, const float* q, const float* x, float* out, int Q,
                         int M, int n, int gathered, cudaStream_t stream) {
  if constexpr (R > kMaxRegR) {
    return cudaErrorInvalidValue;
  } else {
    if (r == R) return launch_reg<R>(q, x, out, Q, M, n, gathered, stream);
    return dispatch_reg<R + 1>(r, q, x, out, Q, M, n, gathered, stream);
  }
}

cudaError_t launch_wide(const float* q, const float* x, float* out, int Q, int M,
                        int n, int r, int gathered, cudaStream_t stream) {
  int threads = 64;
  size_t smem = (static_cast<size_t>(n) + static_cast<size_t>(2 * r + 2) * threads) * 4;
  while (smem > 64 * 1024 && threads > 32) {
    threads /= 2;
    smem = (static_cast<size_t>(n) + static_cast<size_t>(2 * r + 2) * threads) * 4;
  }
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dtw_band_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>((M + threads - 1) / threads),
                  static_cast<unsigned>(Q));
  dtw_band_wide_kernel<<<grid, threads, smem, stream>>>(q, x, out, M, n, r, gathered);
  return cudaSuccess;
}

}  // namespace

extern "C" int dtw_band_panel_launch(const void* q, const void* x, void* out, int Q,
                                     int M, int n, int r, int gathered, void* stream) {
  if (n < 1 || r < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (Q > 0 && M > 0) {
    r = min(r, n - 1);                      // a wider band holds the same cells
    const auto* qp = static_cast<const float*>(q);
    const auto* xp = static_cast<const float*>(x);
    auto* op = static_cast<float*>(out);
    const auto s = static_cast<cudaStream_t>(stream);
    const cudaError_t e = r <= kMaxRegR
        ? dispatch_reg<0>(r, qp, xp, op, Q, M, n, gathered, s)
        : launch_wide(qp, xp, op, Q, M, n, r, gathered, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
