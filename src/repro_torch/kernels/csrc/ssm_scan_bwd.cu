// ssm_scan_bwd: the reverse (adjoint) scan of ssm_scan.cu, for training.
// It replaces no TPU kernel: the reference's Pallas ssm_scan is forward
// only, and the reference trains Hymba by autodiff of a jnp chunked
// associative scan (src/repro/models/mamba.py:71).  The port's training
// path runs the forward kernel, so its gradient needs this kernel.
//
// Forward, per channel (b, d) and state n:
//   h_t = a_t h_{t-1} + b_t,  a_t = exp(dt_t A),  b_t = dt_t x_t B_t,
//   y_t = sum_n h_t C_t.
// With dy (B, S, D) and dh_last (B, D, N) (or zeros), the adjoint
//   g_t = dy_t C_t + a_{t+1} g_{t+1}   (g_S seeded with dh_last)
// gives
//   dx_t  = dt_t sum_n g_t B_t             ddt_t = sum_n g_t (x_t B_t + A a_t h_{t-1})
//   dB_t  = sum_d g_t dt_t x_t             dC_t  = sum_d dy_t h_t
//   dA    = sum_{b,t} g_t a_t dt_t h_{t-1} dh0   = a_1 g_1.
//
// Design, simple first: the forward's training launch stored the state
// before every kSsmCkpt (32) steps, ckpt (B, ceil(S / 32), D, N).  A block
// holds kChanB = 16 channels of one batch row, G lanes a channel and R
// states a lane as the forward does (N padded in registers to a power of
// two, N > 32 in passes of 32 states), and walks the tiles of 32 steps
// from the last to the first.  For each tile it stages x, dt, dy, B and C
// in shared memory, recomputes the tile's 32 states from the checkpoint
// (each lane keeps its own in shared memory), then runs the adjoint
// backwards through the tile with g in registers:
//   * dx and ddt are summed over the lane's states, reduce-scattered over
//     the channel's G lanes as the forward's y is, and stored by their
//     owners (the passes of N > 32 add to what the earlier passes stored);
//   * dB and dC reduce over d: each lane writes its terms into shared
//     memory, and after the tile the block sums its 16 channels in order
//     into partials (B, D / 16, S, N), which a second kernel sums over the
//     blocks in order;
//   * dA is kept a lane in registers over the whole walk, stored as
//     partials (B, D, N), and summed over b in order by the same second
//     kernel.
// No atomics: every sum has one fixed order, so two runs give the same
// bits.  Work: two exps per (b, t, d, n) (the recompute and the adjoint),
// about 18 other fp32 instructions; the bound is the exps on the
// special-function units at Hymba's training shape (PERF.md).  Steps past
// S are padded with x = dt = dy = B = C = 0, which leaves h and g as they
// are; their ddt terms are never stored.
#include "common.cuh"
#include "ssm_scan.cuh"

namespace {

constexpr int kChanB = 16;           // channels a block
constexpr int kTileB = kSsmCkpt;     // steps a tile: one checkpoint's span
constexpr int kMaxPassB = 32;        // states a pass, N > 32
constexpr int kSumThreads = 256;

template <int R, int G>
constexpr int smem_floats() {
  // x, dt, dy [T][kChanB]; B, C [T][NP]; the states and the dB terms,
  // each [T][R][threads]
  return 3 * kTileB * kChanB + 2 * kTileB * R * G + 2 * kTileB * R * kChanB * G;
}

template <int R, int G>
__global__ void __launch_bounds__(kChanB * G)
ssm_scan_bwd_kernel(const float* __restrict__ xc, const float* __restrict__ dt,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ a, const float* __restrict__ ckpt,
                    const float* __restrict__ dy, const float* __restrict__ dh_last,
                    float* __restrict__ dxc, float* __restrict__ ddt, float* __restrict__ dh0,
                    float* __restrict__ part_b, float* __restrict__ part_c,
                    float* __restrict__ part_a, int S, int D, int N) {
  constexpr int NP = R * G;
  constexpr int NT = kChanB * G;
  constexpr int T = kTileB;
  constexpr int TL = T / G;                 // dx, ddt values a lane stores a tile
  static_assert(G <= 8 && (G & (G - 1)) == 0 && T >= G, "variant");
  extern __shared__ __align__(16) float smem[];
  float* s_x = smem;                        // [T][kChanB]
  float* s_dt = s_x + T * kChanB;
  float* s_dy = s_dt + T * kChanB;
  float* s_b = s_dy + T * kChanB;           // [T][NP]
  float* s_c = s_b + T * NP;
  float* s_h = s_c + T * NP;                // [T][R][NT]: h_t, then dy_t h_t
  float* s_g = s_h + T * R * NT;            // [T][R][NT]: g_t dt_t x_t

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int c = tid / G;                    // channel within the block
  const int g = tid % G;                    // lane within the channel
  const int d0 = blockIdx.x * kChanB;
  const int d = d0 + c;
  const bool live = d < D;
  const long long row0 = static_cast<long long>(b) * S;
  const int nck = (S + T - 1) / T;
  const int passes = (N + NP - 1) / NP;
  const int start = g * TL;                 // first step of the tile it stores

  for (int pass = 0; pass < passes; ++pass) {
    const int n0 = pass * NP + g * R;
    float av[R], a2[R], gr[R], da[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = n0 + r;
      const bool on = live && n < N;
      av[r] = on ? a[static_cast<long long>(d) * N + n] : 0.f;
      a2[r] = av[r] * kLog2e;
      gr[r] = on && dh_last != nullptr ? dh_last[(static_cast<long long>(b) * D + d) * N + n]
                                       : 0.f;
      da[r] = 0.f;
    }

    for (int j = nck - 1; j >= 0; --j) {
      const int t0 = j * T;
      const int tn = min(T, S - t0);
      __syncthreads();                      // everyone is done with the last tile
      for (int i = tid; i < T * kChanB; i += NT) {
        const int tt = i / kChanB, dd = d0 + i % kChanB;
        const bool in = tt < tn && dd < D;
        const long long off = (row0 + t0 + tt) * D + dd;
        s_x[i] = in ? xc[off] : 0.f;
        s_dt[i] = in ? dt[off] : 0.f;
        s_dy[i] = in ? dy[off] : 0.f;
      }
      for (int i = tid; i < T * NP; i += NT) {
        const int tt = i / NP, n = pass * NP + i % NP;
        const bool in = tt < tn && n < N;
        const long long off = (row0 + t0 + tt) * N + n;
        s_b[i] = in ? bm[off] : 0.f;
        s_c[i] = in ? cm[off] : 0.f;
      }
      __syncthreads();

      // the tile's states, recomputed from the state before it
      float h[R], hst[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int n = n0 + r;
        h[r] = live && n < N ? ckpt[((static_cast<long long>(b) * nck + j) * D + d) * N + n]
                             : 0.f;
        hst[r] = h[r];
      }
#pragma unroll 4
      for (int tt = 0; tt < T; ++tt) {
        const float dtv = s_dt[tt * kChanB + c];
        const float dx = dtv * s_x[tt * kChanB + c];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float at = ex2(dtv * a2[r]);
          h[r] = at * h[r] + dx * s_b[tt * NP + g * R + r];
          s_h[(tt * R + r) * NT + tid] = h[r];
        }
      }

      // the adjoint, from the tile's last step to its first
      float px[T], pd[T];
#pragma unroll
      for (int tt = T - 1; tt >= 0; --tt) {
        const float dtv = s_dt[tt * kChanB + c];
        const float xv = s_x[tt * kChanB + c];
        const float dyv = s_dy[tt * kChanB + c];
        float sx = 0.f, sd = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float bv = s_b[tt * NP + g * R + r];
          const float cv = s_c[tt * NP + g * R + r];
          const float ht = s_h[(tt * R + r) * NT + tid];
          const float hp = tt > 0 ? s_h[((tt - 1) * R + r) * NT + tid] : hst[r];
          const float at = ex2(dtv * a2[r]);
          gr[r] += dyv * cv;
          sx += gr[r] * bv;
          sd += gr[r] * (xv * bv + av[r] * at * hp);
          da[r] += gr[r] * at * dtv * hp;
          s_h[(tt * R + r) * NT + tid] = dyv * ht;       // step tt's state is read no more
          s_g[(tt * R + r) * NT + tid] = gr[r] * dtv * xv;
          gr[r] *= at;
        }
        px[tt] = sx * dtv;
        pd[tt] = sd;
      }
      reduce_scatter<G, T>(px, g);
      reduce_scatter<G, T>(pd, g);
      if (live) {
#pragma unroll
        for (int e = 0; e < TL; ++e) {
          const int t = t0 + start + e;
          if (t < S) {
            const long long off = (row0 + t) * D + d;
            dxc[off] = pass == 0 ? px[e] : dxc[off] + px[e];
            ddt[off] = pass == 0 ? pd[e] : ddt[off] + pd[e];
          }
        }
      }
      __syncthreads();

      // this block's dB and dC terms: its channels summed in order
      for (int i = tid; i < T * NP; i += NT) {
        const int tt = i / NP, q = i % NP, n = pass * NP + q;
        if (tt < tn && n < N) {
          const int gq = q / R, rq = q % R;
          float sb = 0.f, sc = 0.f;
          for (int cc = 0; cc < kChanB; ++cc) {
            const int th = cc * G + gq;
            sb += s_g[(tt * R + rq) * NT + th];
            sc += s_h[(tt * R + rq) * NT + th];
          }
          const long long off =
              ((static_cast<long long>(b) * gridDim.x + blockIdx.x) * S + t0 + tt) * N + n;
          part_b[off] = sb;
          part_c[off] = sc;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = n0 + r;
      if (live && n < N) {
        const long long off = (static_cast<long long>(b) * D + d) * N + n;
        dh0[off] = gr[r];
        part_a[off] = da[r];
      }
    }
  }
}

// out[o, m] = sum_p part[o, p, m], p in order
__global__ void __launch_bounds__(kSumThreads)
ssm_scan_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int O, int P,
                        long long M) {
  const long long total = static_cast<long long>(O) * M;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long o = i / M, m = i % M;
    const float* p = part + o * P * M + m;
    float s = 0.f;
    for (int k = 0; k < P; ++k) s += p[k * M];
    out[i] = s;
  }
}

cudaError_t sum_partials(const float* part, float* out, int O, int P, long long M,
                         cudaStream_t stream) {
  const long long total = static_cast<long long>(O) * M;
  const long long want = (total + kSumThreads - 1) / kSumThreads;
  const unsigned grid = static_cast<unsigned>(want < 132 * 16 ? want : 132 * 16);
  ssm_scan_bwd_sum_kernel<<<grid, kSumThreads, 0, stream>>>(part, out, O, P, M);
  return cudaGetLastError();
}

template <int R, int G>
cudaError_t launch_bwd(const float* xc, const float* dt, const float* bm, const float* cm,
                       const float* a, const float* ckpt, const float* dy, const float* dh_last,
                       float* dxc, float* ddt, float* dh0, float* part_b, float* part_c,
                       float* part_a, int B, int S, int D, int N, cudaStream_t stream) {
  constexpr int bytes = smem_floats<R, G>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(ssm_scan_bwd_kernel<R, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((D + kChanB - 1) / kChanB), static_cast<unsigned>(B));
  ssm_scan_bwd_kernel<R, G><<<grid, kChanB * G, bytes, stream>>>(
      xc, dt, bm, cm, a, ckpt, dy, dh_last, dxc, ddt, dh0, part_b, part_c, part_a, S, D, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssm_scan_bwd_channels_per_block() { return kChanB; }

// ckpt (B, ceil(S / 32), D, N) from ssm_scan_launch; dh_last may be null;
// part_b, part_c (B, ceil(D / 16), S, N) and part_a (B, D, N) are scratch.
extern "C" int ssm_scan_bwd_launch(const void* xc, const void* dt, const void* bm,
                                   const void* cm, const void* a, const void* ckpt,
                                   const void* dy, const void* dh_last, void* dxc, void* ddt,
                                   void* dbm, void* dcm, void* da, void* dh0, void* part_b,
                                   void* part_c, void* part_a, int B, int S, int D, int N,
                                   void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xc_ = static_cast<const float*>(xc);
  const auto* dt_ = static_cast<const float*>(dt);
  const auto* bm_ = static_cast<const float*>(bm);
  const auto* cm_ = static_cast<const float*>(cm);
  const auto* a_ = static_cast<const float*>(a);
  const auto* ck_ = static_cast<const float*>(ckpt);
  const auto* dy_ = static_cast<const float*>(dy);
  const auto* dhl_ = static_cast<const float*>(dh_last);
  auto* dxc_ = static_cast<float*>(dxc);
  auto* ddt_ = static_cast<float*>(ddt);
  auto* dh0_ = static_cast<float*>(dh0);
  auto* pb_ = static_cast<float*>(part_b);
  auto* pc_ = static_cast<float*>(part_c);
  auto* pa_ = static_cast<float*>(part_a);
  int np = 1;                                   // states a pass, as the forward picks it
  while (np < N && np < kMaxPassB) np <<= 1;
  using Launch = cudaError_t (*)(const float*, const float*, const float*, const float*,
                                 const float*, const float*, const float*, const float*, float*,
                                 float*, float*, float*, float*, float*, int, int, int, int,
                                 cudaStream_t);
  Launch run;
  switch (np) {                                 // (R, G): R states a lane, G lanes a channel
    case 1: run = launch_bwd<1, 1>; break;
    case 2: run = launch_bwd<2, 1>; break;
    case 4: run = launch_bwd<4, 1>; break;
    case 8: run = launch_bwd<4, 2>; break;
    case 16: run = launch_bwd<4, 4>; break;
    default: run = launch_bwd<4, 8>; break;
  }
  cudaError_t err = run(xc_, dt_, bm_, cm_, a_, ck_, dy_, dhl_, dxc_, ddt_, dh0_, pb_, pc_, pa_,
                        B, S, D, N, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nblk = (D + kChanB - 1) / kChanB;
  const long long sn = static_cast<long long>(S) * N;
  if ((err = sum_partials(pb_, static_cast<float*>(dbm), B, nblk, sn, st)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = sum_partials(pc_, static_cast<float*>(dcm), B, nblk, sn, st)) != cudaSuccess)
    return static_cast<int>(err);
  return static_cast<int>(
      sum_partials(pa_, static_cast<float*>(da), 1, B, static_cast<long long>(D) * N, st));
}
