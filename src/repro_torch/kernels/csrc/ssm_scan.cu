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
// The training launch also writes ckpt (B, ceil(S / 32), D, N), the state
// before every 32 steps, from which ssm_scan_bwd.cu recomputes a span;
// serving and decode pass a null ckpt and store nothing more.
// Any state size N >= 1 runs here.
//
// Bound on the H100, at Hymba's prefill (4, 2176, 1600, 16): one exp per
// (b, t, d, n), 222.8 M of them, on the special-function units (16 a clock
// an SM: 0.053 ms at 1.98 GHz), just above the bytes (xc, dt and y, 167 MB:
// 0.050 ms).  The design spends one ex2 and four other fp32 instructions
// on each (b, t, d, n) and keeps the loads off the critical path:
//   * a channel (b, d) belongs to G lanes, each holding R = 4 of its states
//     in registers (N = 16: G = 4), so dt * xc is formed once for R states
//     and B_t, C_t come as one float4 broadcast each from shared memory;
//   * exp(dt * A) is ex2.approx of dt * (A * log2 e), A scaled once;
//   * a block holds 32 channels of one batch row and walks the time axis in
//     tiles of 32 steps, double-buffered: cp.async brings tile j + 1 into
//     shared memory while tile j is scanned, one barrier a tile, each
//     thread copying a set of 16-byte chunks fixed at compile time;
//   * each lane keeps its partial y of all 32 steps of a tile in registers,
//     then the G lanes of a channel reduce-scatter them (each round halves
//     the values a lane holds: 32 (1 - 1/G) shuffles a lane a tile rather
//     than 32 log2 G) and each lane stores 32 / G finished y values,
//     32-byte runs along d;
//   * N that is no power of two is padded in registers to the next one
//     (pad states have A = B = C = 0, so they stay 0, add exactly 0 to y
//     and are never stored); N > 32 runs as passes of 32 states, each pass
//     adding its part of y to what the earlier passes stored;
//   * a tile past the end of S is padded with dt = xc = B = C = 0, which
//     leaves h exactly as it is (ex2(0) = 1); a decode step (S = 1) runs
//     an instantiation with one step a tile.
// The recurrence stays sequential in t within a channel, in the plain
// version's order of factors; nvcc may contract a * h + b into one FMA and
// ex2.approx is within 2 ulp, so the kernel and ref.ssm_scan_ref agree
// within a tolerance, not bitwise.  At Hymba's shape 6,400 channels make
// 800 warps, 200 blocks, all resident at once: the busiest of the 528
// schedulers hold two warps, four independent state chains each.  On the
// card the scan is latency-bound rather than SFU- or byte-bound (PERF.md):
// more lanes a channel (G = 8) or more channels a lane measured slower,
// and so did 16- and 64-step tiles and a third stage.
#include "common.cuh"
#include "ssm_scan.cuh"

namespace {

constexpr int kChan = 32;            // channels a block
constexpr int kTile = kSsmCkpt;      // time steps a tile, S > 1
constexpr int kStages = 2;           // tiles in shared memory
constexpr int kMaxPass = 32;         // states a pass, N > 32

template <int NP, int T>
struct Tiles {
  float x[kStages][T][kChan];
  float dt[kStages][T][kChan];
  float b[kStages][T][NP];
  float c[kStages][T][NP];
};

// R states a lane, G lanes a channel (R * G = NP states a pass), T steps a tile
template <int R, int G, int T>
__global__ void __launch_bounds__(kChan * G)
ssm_scan_kernel(const float* __restrict__ xc, const float* __restrict__ dt,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ h_last,
                float* __restrict__ ckpt, int S, int D, int N, int vec_x, int vec_bc) {
  constexpr int NP = R * G;
  constexpr int NT = kChan * G;
  constexpr int SPLIT = T >= G ? G : 1;     // lanes a tile's y is scattered over
  constexpr int TL = T / SPLIT;             // y values a lane stores a tile
  static_assert(G <= 8 && (G & (G - 1)) == 0 && (T == 1 || T >= G), "variant");
  static_assert(kSsmCkpt % T == 0, "a checkpoint falls at the start of a tile");
  __shared__ __align__(16) Tiles<NP, T> s;

  const int b = blockIdx.y;
  const int c = threadIdx.x / G;                          // channel within the block
  const int g = threadIdx.x % G;                          // lane within the channel
  const int d0 = blockIdx.x * kChan;
  const int d = d0 + c;
  const bool live = d < D;
  const long long row0 = static_cast<long long>(b) * S;  // (b, t = 0) row
  const int ntiles = (S + T - 1) / T;
  const int nck = (S + kSsmCkpt - 1) / kSsmCkpt;          // checkpoints a row
  const int passes = (N + NP - 1) / NP;
  const bool owner = g % (G / SPLIT) == 0;
  const int start = (g / (G / SPLIT)) * TL;               // first step of the tile it stores

  for (int pass = 0; pass < passes; ++pass) {
    const int n0 = pass * NP + g * R;
    float a2[R], h[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = n0 + r;
      const bool on = live && n < N;
      a2[r] = on ? a[static_cast<long long>(d) * N + n] * kLog2e : 0.f;
      h[r] = on && h0 != nullptr ? h0[(static_cast<long long>(b) * D + d) * N + n] : 0.f;
    }

    // stage tile j into buffer j % kStages; rows past S and channels past D
    // are zero-filled, and so are the pad states' columns.  Each thread
    // copies a fixed set of chunks, counted at compile time.
    auto stage = [&](int j) {
      const int buf = j % kStages;
      const int t0 = j * T;
      const int tn = min(T, S - t0);
      if (vec_x) {
        constexpr int QR = kChan / 4;                     // 16-byte chunks a row
#pragma unroll
        for (int u = 0; u < (T * QR + NT - 1) / NT; ++u) {
          const int i = threadIdx.x + u * NT;
          if (i >= T * QR) break;
          const int tt = i / QR, q = 4 * (i % QR), dd = d0 + q;
          float* sx = &s.x[buf][tt][q];
          float* sd = &s.dt[buf][tt][q];
          if (tt < tn && dd < D) {
            const long long off = (row0 + t0 + tt) * D + dd;
            cp_async16(sx, xc + off);
            cp_async16(sd, dt + off);
          } else {
            *reinterpret_cast<float4*>(sx) = make_float4(0.f, 0.f, 0.f, 0.f);
            *reinterpret_cast<float4*>(sd) = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < (T * kChan + NT - 1) / NT; ++u) {
          const int i = threadIdx.x + u * NT;
          if (i >= T * kChan) break;
          const int tt = i / kChan, q = i % kChan, dd = d0 + q;
          if (tt < tn && dd < D) {
            const long long off = (row0 + t0 + tt) * D + dd;
            cp_async4(&s.x[buf][tt][q], xc + off);
            cp_async4(&s.dt[buf][tt][q], dt + off);
          } else {
            s.x[buf][tt][q] = 0.f;
            s.dt[buf][tt][q] = 0.f;
          }
        }
      }
      bool staged = false;
      if constexpr (NP >= 4) {
        if (vec_bc) {                                     // N % 4 == 0
          staged = true;
          constexpr int QR = NP / 4;
#pragma unroll
          for (int u = 0; u < (T * QR + NT - 1) / NT; ++u) {
            const int i = threadIdx.x + u * NT;
            if (i >= T * QR) break;
            const int tt = i / QR, q = 4 * (i % QR), n = pass * NP + q;
            float* sb = &s.b[buf][tt][q];
            float* sc = &s.c[buf][tt][q];
            if (tt < tn && n < N) {
              const long long off = (row0 + t0 + tt) * N + n;
              cp_async16(sb, bm + off);
              cp_async16(sc, cm + off);
            } else {
              *reinterpret_cast<float4*>(sb) = make_float4(0.f, 0.f, 0.f, 0.f);
              *reinterpret_cast<float4*>(sc) = make_float4(0.f, 0.f, 0.f, 0.f);
            }
          }
        }
      }
      if (!staged) {
#pragma unroll
        for (int u = 0; u < (T * NP + NT - 1) / NT; ++u) {
          const int i = threadIdx.x + u * NT;
          if (i >= T * NP) break;
          const int tt = i / NP, q = i % NP, n = pass * NP + q;
          if (tt < tn && n < N) {
            const long long off = (row0 + t0 + tt) * N + n;
            cp_async4(&s.b[buf][tt][q], bm + off);
            cp_async4(&s.c[buf][tt][q], cm + off);
          } else {
            s.b[buf][tt][q] = 0.f;
            s.c[buf][tt][q] = 0.f;
          }
        }
      }
    };

#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) {
      if (j < ntiles) stage(j);
      cp_async_commit();
    }
    for (int j = 0; j < ntiles; ++j) {
      cp_async_wait<kStages - 2>();
      // tile j is visible to every thread, and every thread is done with
      // tile j - 1, whose buffer the next stage overwrites
      __syncthreads();
      if (j + kStages - 1 < ntiles) stage(j + kStages - 1);
      cp_async_commit();

      // the training launch keeps the state before every kSsmCkpt steps
      if (ckpt != nullptr && live && (j * T) % kSsmCkpt == 0) {
        float* dst = ckpt + ((static_cast<long long>(b) * nck + j * T / kSsmCkpt) * D + d) * N;
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (n0 + r < N) dst[n0 + r] = h[r];
      }

      const int buf = j % kStages;
      float p[T];
#pragma unroll
      for (int tt = 0; tt < T; ++tt) {
        float bv[R], cv[R];
        if constexpr (R % 4 == 0) {
#pragma unroll
          for (int q = 0; q < R; q += 4) {
            const float4 b4 = *reinterpret_cast<const float4*>(&s.b[buf][tt][g * R + q]);
            const float4 c4 = *reinterpret_cast<const float4*>(&s.c[buf][tt][g * R + q]);
            bv[q] = b4.x; bv[q + 1] = b4.y; bv[q + 2] = b4.z; bv[q + 3] = b4.w;
            cv[q] = c4.x; cv[q + 1] = c4.y; cv[q + 2] = c4.z; cv[q + 3] = c4.w;
          }
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            bv[r] = s.b[buf][tt][g * R + r];
            cv[r] = s.c[buf][tt][g * R + r];
          }
        }
        const float dtv = s.dt[buf][tt][c];
        const float dx = dtv * s.x[buf][tt][c];
        float acc = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float at = ex2(dtv * a2[r]);
          h[r] = at * h[r] + dx * bv[r];
          acc += h[r] * cv[r];
        }
        p[tt] = acc;
      }

      reduce_scatter<1, G, T>(p, g);
      if (owner && live) {
        const int t0 = j * T + start;
#pragma unroll
        for (int e = 0; e < TL; ++e) {
          if (t0 + e < S) {
            float* dst = y + (row0 + t0 + e) * D + d;
            *dst = pass == 0 ? p[e] : *dst + p[e];
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int n = n0 + r;
      if (live && n < N) h_last[(static_cast<long long>(b) * D + d) * N + n] = h[r];
    }
    // the next pass stages into buffers that every thread has finished with
    __syncthreads();
  }
}

template <int R, int G, int T>
cudaError_t launch(const float* xc, const float* dt, const float* bm, const float* cm,
                   const float* a, const float* h0, float* y, float* h_last, float* ckpt,
                   int B, int S, int D, int N, int vec_x, int vec_bc, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((D + kChan - 1) / kChan), static_cast<unsigned>(B));
  ssm_scan_kernel<R, G, T><<<grid, kChan * G, 0, stream>>>(xc, dt, bm, cm, a, h0, y, h_last,
                                                           ckpt, S, D, N, vec_x, vec_bc);
  return cudaGetLastError();
}

template <int R, int G>
cudaError_t launch_by_s(const float* xc, const float* dt, const float* bm, const float* cm,
                        const float* a, const float* h0, float* y, float* h_last, float* ckpt,
                        int B, int S, int D, int N, int vec_x, int vec_bc, cudaStream_t stream) {
  if (S == 1)
    return launch<R, G, 1>(xc, dt, bm, cm, a, h0, y, h_last, ckpt, B, S, D, N, vec_x, vec_bc,
                           stream);
  return launch<R, G, kTile>(xc, dt, bm, cm, a, h0, y, h_last, ckpt, B, S, D, N, vec_x, vec_bc,
                             stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" int ssm_scan_ckpt_steps() { return kSsmCkpt; }

extern "C" int ssm_scan_launch(const void* xc, const void* dt, const void* bm, const void* cm,
                               const void* a, const void* h0, void* y, void* h_last,
                               void* ckpt, int B, int S, int D, int N, void* stream) {
  if (B <= 0 || S <= 0 || D <= 0) return static_cast<int>(cudaGetLastError());
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xc_ = static_cast<const float*>(xc);
  const auto* dt_ = static_cast<const float*>(dt);
  const auto* bm_ = static_cast<const float*>(bm);
  const auto* cm_ = static_cast<const float*>(cm);
  const auto* a_ = static_cast<const float*>(a);
  const auto* h0_ = static_cast<const float*>(h0);
  auto* y_ = static_cast<float*>(y);
  auto* hl_ = static_cast<float*>(h_last);
  auto* ck_ = static_cast<float*>(ckpt);
  const auto st = static_cast<cudaStream_t>(stream);
  const int vec_x = D % 4 == 0 && aligned16(xc) && aligned16(dt);
  const int vec_bc = N % 4 == 0 && aligned16(bm) && aligned16(cm);
  int np = 1;                                   // states a pass: N rounded up to a power of two
  while (np < N && np < kMaxPass) np <<= 1;
  using Launch = cudaError_t (*)(const float*, const float*, const float*, const float*,
                                 const float*, const float*, float*, float*, float*, int, int,
                                 int, int, int, int, cudaStream_t);
  Launch run;
  switch (np) {                                 // (R, G): R states a lane, G lanes a channel
    case 1: run = launch_by_s<1, 1>; break;
    case 2: run = launch_by_s<2, 1>; break;
    case 4: run = launch_by_s<4, 1>; break;
    case 8: run = launch_by_s<4, 2>; break;
    case 16: run = launch_by_s<4, 4>; break;
    default: run = launch_by_s<4, 8>; break;
  }
  return static_cast<int>(run(xc_, dt_, bm_, cm_, a_, h0_, y_, hl_, ck_, B, S, D, N, vec_x,
                              vec_bc, st));
}
