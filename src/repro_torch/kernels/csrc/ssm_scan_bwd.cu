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
// Bound on the H100: the bytes it must move (xc, dt, dy in and dxc, ddt out,
// B, C in and dB, dC out, the checkpoints; 82.1 MB at Hymba's training shape
// (2, 1152, 1600, 16): 0.0245 ms at 3.35 TB/s), above its one exp a
// (b, t, d, n) on the special-function units (0.0141 ms).
//
// Design: span-parallel.  The forward's training launch stored the state
// before every kSsmCkpt (32) steps, ckpt (B, ceil(S / 32), D, N), so every
// span of 32 steps can recompute its states on its own, and the adjoint is
// a linear recurrence: the adjoint e_{j-1} leaving span j downwards is an
// affine function of the adjoint e_j entering it from above,
//   e_{j-1} = P_j e_j + L_j,   P_j = prod_span a_t,
//   L_j = sum_{t in span} (prod_{s = t0 .. t} a_s) dy_t C_t,
// both of which the span's own forward recompute gives.  One block is one
// span of K channels of one batch row (K = 16 at N = 16), each thread one
// (channel, state); a cluster is kCluster blocks, neighbours along d:
//   1. the cluster takes a ticket, atomically, which names its span, from
//      the last; a block only ever waits for a block of an earlier ticket,
//      which has started, so no wait can deadlock.  The ticket orders the
//      starts only: no value depends on it;
//   2. the block stages its span by cp.async: x, dt, dy (per channel) and
//      B, C (per state), transposed so a thread reads four steps as one
//      float4, the checkpoint row and A; meanwhile it looks at the two
//      chains below, and where span j + 1 is already done it loads their
//      values under the recompute;
//   3. it recomputes the 32 states from the checkpoint, keeping a_t and
//      a_t h_{t-1} in registers (one exp a (b, t, d, n): the adjoint
//      reuses a_t), with the dC terms dy_t h_t, P_j and L_j;
//   4. the e chain: once span j + 1 has published e_j, the block publishes
//      e_{j-1} = P_j e_j + L_j in its place (one buffer, the dh0 output,
//      which holds e_{-1} = dh0 at the end); a hop is a flag through L2;
//   5. the adjoint runs down the span from e_j in registers, in chunks of 8
//      steps: dx and ddt are reduced over a channel's states by a
//      reduce-scatter of shuffles and staged for a coalesced store; dB and
//      dC are reduced over the warp's channels by shuffles, over the block's
//      warps in shared memory, over the cluster's blocks through distributed
//      shared memory (each block sums a slice in rank order), and written as
//      one partial a cluster, (2, B, ceil(D / (K kCluster)), S, N);
//   6. the dA chain, while the cluster's barrier gathers: the span adds its
//      dA terms to the running sum of the spans above it, in one (B, D, N)
//      buffer;
//   7. a second kernel sums the clusters' dB, dC partials and dA over b.
// N that is no power of two is padded to the next (A = B = C = 0 there);
// N > 32 runs in passes of 32 states, each with its own chains.  Steps past
// S are padded with x = dt = dy = B = C = 0, which leaves h and g as they
// are.  No atomics in any sum: every value comes from one fixed order of
// operations, so two launches give the same bits.  Traffic beyond the work's
// bytes: the partials (written and read once) and the dA chain's (B, D, N)
// buffer; the chains' hops stay in L2.
//
// What sets its time (PERF.md): instructions and latency, not bytes.  The
// N = 16 kernel is ~3,000 SASS instructions a thread a span, 93 an element
// (15 of them arithmetic; the rest the reduce-scatters' selects and
// shuffles, addressing, staging and the chains), and 64 of a thread's 128
// registers hold a_t and a_t h_{t-1}, so an SM holds two blocks (16
// warps), too few to hide each span's staging, chain hops and cluster
// barriers.  Larger clusters, smaller blocks with a_t in shared memory and
// resident clusters that walk many spans measured no faster on the card.
#include <cooperative_groups.h>

#include "common.cuh"
#include "ssm_scan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSpan = kSsmCkpt;      // steps a block: one checkpoint's span
constexpr int kChunk = 8;            // steps reduced together
constexpr int kCluster = 4;          // blocks a cluster, neighbours along d
constexpr int kMaxPassB = 32;        // states a pass, N > 32
constexpr int kStride = kSpan + 4;   // a staged row: float4-aligned, banks shifted
constexpr int kSumThreads = 256;
constexpr unsigned kMaxSpins = 1u << 24;   // a chain that never comes: trap, not hang

constexpr int block_channels(int np) { return 256 / np < 64 ? 256 / np : 64; }

// NP states a pass (a power of two), one thread a (channel, state)
template <int NP>
struct Shape {
  static constexpr int K = block_channels(NP);              // channels a block
  static constexpr int NT = K * NP;                         // threads a block
  static constexpr int NW = NT / 32;                        // warps a block
  static constexpr int CW = 32 / NP;                        // channels a warp
  // the staged span: dt, x, dt x, dy [K][kStride]; B, C [NP][kStride];
  // the checkpoint row and A, a thread each
  static constexpr int STG = 4 * K * kStride + 2 * NP * kStride + 2 * NT;
  // shared floats: the staged span; the warps' dB, dC partials
  // [2][NW][kSpan][NP]; the block's sums [2][kSpan][NP]; dx, ddt
  // [2][kSpan][K]; the ticket and the chains' early looks
  static constexpr int floats =
      STG + 2 * NW * kSpan * NP + 2 * kSpan * NP + 2 * kSpan * K + 4;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// The cluster barrier in two halves: work between them overlaps the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Block-wide: wait until *cnt >= want, then every thread may read what the
// publishing block stored before it raised *cnt (read it with __ldcg).
__device__ __forceinline__ void wait_for(const unsigned* cnt, unsigned want) {
  if (threadIdx.x == 0) {
    unsigned spins = 0;
    while (ld_acquire(cnt) < want) {
      __nanosleep(64);
      if (++spins == kMaxSpins) __trap();
    }
  }
  __syncthreads();
}

// Block-wide: every thread's stores so far are visible before *cnt = v.
__device__ __forceinline__ void publish(unsigned* cnt, unsigned v) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    st_release(cnt, v);
  }
}

// After reduce_scatter<LO, HI, kChunk>: a lane of group index u (of M =
// HI / LO) holds max(1, kChunk / M) sums, of the chunk's steps
// (u / max(1, M / kChunk)) * max(1, kChunk / M) + e; one lane of each
// duplicate set owns them.
template <int M>
struct Scatter {
  static constexpr int per = kChunk / M > 1 ? kChunk / M : 1;
  static constexpr int grp = M / kChunk > 1 ? M / kChunk : 1;
  __device__ static bool owner(int u) { return u % grp == 0; }
  __device__ static int step(int u, int e) { return (u / grp) * per + e; }
};

// A ticket's place: span j (from the last), batch row b, the cluster's
// place along d.
struct Place {
  int j, b, cdg;
};

__device__ __forceinline__ Place place_of(int ticket, int B, int nspan, int ncd) {
  const int per_span = B * ncd;
  return {nspan - 1 - ticket / per_span, ticket % per_span / ncd, ticket % ncd};
}

template <int NP>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(Shape<NP>::NT, 2)
ssm_scan_bwd_kernel(const float* __restrict__ xc, const float* __restrict__ dt,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ a, const float* __restrict__ ckpt,
                    const float* __restrict__ dy, const float* __restrict__ dh_last,
                    float* __restrict__ dxc, float* __restrict__ ddt, float* dh0,
                    float* __restrict__ part, float* ra, unsigned* ctrl, int B, int S, int D,
                    int N, int nspan, int ncd) {
  using Sh = Shape<NP>;
  constexpr int K = Sh::K, NT = Sh::NT, NW = Sh::NW, CW = Sh::CW, STG = Sh::STG;
  constexpr int T = kSpan, TS = kStride;
  using OverN = Scatter<NP>;    // dx, ddt: summed over a channel's NP lanes
  using OverD = Scatter<CW>;    // dB, dC: summed over a warp's CW channels
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem + STG;                  // [2][NW][T][NP]: dB, dC of each warp
  float* s_blk = s_w + 2 * NW * T * NP;     // [2][T][NP]: the block's sums
  float* s_out = s_blk + 2 * T * NP;        // [2][T][K]: dx, ddt
  unsigned* s_tk = reinterpret_cast<unsigned*>(s_out + 2 * T * K);
  unsigned* s_ready = s_tk + 2;             // the chains' early looks

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nl = lane % NP, cw = lane / NP;
  const int c = warp * CW + cw;                      // channel within the block
  const int passes = (N + NP - 1) / NP;

  if (rank == 0 && tid == 0) *s_tk = atomicAdd(ctrl, 1u);
  cluster.sync();
  const int ticket = static_cast<int>(*cluster.map_shared_rank(s_tk, 0));
  const Place p = place_of(ticket, B, nspan, ncd);
  const int j = p.j, b = p.b, cdg = p.cdg;
  const int dg = cdg * kCluster + rank;
  const int d0 = dg * K;
  const bool blk_live = d0 < D;                      // past D: zeros to the cluster
  const int d = d0 + c;
  const bool live = d < D;
  const int t0 = j * T;
  const int tn = min(T, S - t0);
  const long long row0 = static_cast<long long>(b) * S;
  const bool top = j == nspan - 1;
  const unsigned want = static_cast<unsigned>(nspan - 1 - j);   // spans above
  // per pass: the e chain's and the dA chain's count of spans done
  unsigned* cnt = ctrl + 1 + 2LL * (static_cast<long long>(b) * ncd * kCluster + dg) * passes;
  float* s_dt = smem;                        // [K][TS]
  float* s_x = s_dt + K * TS;
  float* s_dtx = s_x + K * TS;
  float* s_dy = s_dtx + K * TS;
  float* s_b = s_dy + K * TS;                // [NP][TS]
  float* s_c = s_b + NP * TS;
  float* s_h0 = s_c + NP * TS;               // [NT]
  float* s_a = s_h0 + NT;

  // Stage pass `pass` of the span by cp.async: the channel rows (pass 0
  // only), B, C, the checkpoint row and A; zeros past S, D and N.
  auto stage = [&](int pass) {
    auto put = [](float* dst, const float* src, bool in) {
      if (in) cp_async4(dst, src);
      else *dst = 0.f;
    };
    if (pass == 0) {
      for (int i = tid; i < T * K; i += NT) {
        const int tt = i / K, cc = i % K, dd = d0 + cc;
        const bool in = tt < tn && dd < D;
        const long long off = in ? (row0 + t0 + tt) * D + dd : 0;
        put(s_dt + cc * TS + tt, dt + off, in);
        put(s_x + cc * TS + tt, xc + off, in);
        put(s_dy + cc * TS + tt, dy + off, in);
      }
    }
    for (int i = tid; i < T * NP; i += NT) {
      const int tt = i / NP, q = i % NP, n = pass * NP + q;
      const bool in = tt < tn && n < N;
      const long long off = in ? (row0 + t0 + tt) * N + n : 0;
      put(s_b + q * TS + tt, bm + off, in);
      put(s_c + q * TS + tt, cm + off, in);
    }
    const int n = pass * NP + nl;
    const bool on = live && n < N;
    put(s_h0 + tid,
        ckpt + (on ? ((static_cast<long long>(b) * nspan + j) * D + d) * N + n : 0), on);
    put(s_a + tid, a + (on ? static_cast<long long>(d) * N + n : 0), on);
  };

  for (int pass = 0; pass < passes; ++pass) {
    const int n = pass * NP + nl;
    const bool on = live && n < N;
    const long long dn = (static_cast<long long>(b) * D + d) * N + n;
    unsigned* cnt_e = cnt + 2 * pass;
    unsigned* cnt_a = cnt_e + 1;
    float da = 0.f, run = 0.f;
    bool a_ready = true;
    if (blk_live) {
      if (pass > 0) __syncthreads();        // the last pass is done with B, C
      stage(pass);
      cp_async_commit();
      // a look at the chains while the span loads: a span above that is
      // done lets its values load under the recompute
      if (tid == 0) {
        s_ready[0] = top || ld_acquire(cnt_e) >= want;
        s_ready[1] = top || ld_acquire(cnt_a) >= want;
      }
      cp_async_wait<0>();
      __syncthreads();
      if (pass == 0)
        for (int i = tid; i < T * K; i += NT) {
          const int cc = i / T, tt = i % T;
          s_dtx[cc * TS + tt] = s_dt[cc * TS + tt] * s_x[cc * TS + tt];
        }
      const bool e_ready = s_ready[0] != 0;
      a_ready = s_ready[1] != 0;
      float g = 0.f;
      if (top) {
        if (on && dh_last != nullptr) g = dh_last[dn];
      } else {
        if (e_ready && on) g = __ldcg(dh0 + dn);
        if (a_ready && on) run = __ldcg(ra + dn);
      }
      const float av = s_a[tid];
      const float a2 = av * kLog2e;
      const float* r_dt = s_dt + c * TS;
      const float* r_dtx = s_dtx + c * TS;
      const float* r_dy = s_dy + c * TS;
      const float* r_b = s_b + nl * TS;
      const float* r_c = s_c + nl * TS;
      __syncthreads();                      // dt x staged

      // the span's states from its checkpoint; P and L of the chain
      float h = s_h0[tid];
      float pr = 1.f, lsum = 0.f;
      float at_r[T], ah_r[T];
#pragma unroll
      for (int k = 0; k < T / kChunk; ++k) {
        float pc[kChunk];
#pragma unroll
        for (int q4 = 0; q4 < kChunk / 4; ++q4) {
          const int tb = k * kChunk + q4 * 4;
          const float4 dt4 = ld4(r_dt + tb), dx4 = ld4(r_dtx + tb), dy4 = ld4(r_dy + tb);
          const float4 b4 = ld4(r_b + tb), c4 = ld4(r_c + tb);
          const float dtv[4] = {dt4.x, dt4.y, dt4.z, dt4.w};
          const float dxv[4] = {dx4.x, dx4.y, dx4.z, dx4.w};
          const float dyv[4] = {dy4.x, dy4.y, dy4.z, dy4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int t = tb + u;
            const float at = ex2(dtv[u] * a2);
            const float ah = at * h;
            at_r[t] = at;
            ah_r[t] = ah;
            h = fmaf(dxv[u], bv[u], ah);
            pc[q4 * 4 + u] = dyv[u] * h;
            pr *= at;
            lsum = fmaf(pr, dyv[u] * cv[u], lsum);
          }
        }
        reduce_scatter<NP, 32, kChunk>(pc, lane);
        if (OverD::owner(cw)) {
          float* w = s_w + ((NW + warp) * T + k * kChunk) * NP + nl;
#pragma unroll
          for (int e = 0; e < OverD::per; ++e) w[OverD::step(cw, e) * NP] = pc[e];
        }
      }

      // the chain: e_j from span j + 1, e_{j-1} = P e_j + L in its place
      if (!e_ready) {
        wait_for(cnt_e, want);
        if (on) g = __ldcg(dh0 + dn);
      }
      if (on) __stcg(dh0 + dn, fmaf(pr, g, lsum));
      publish(cnt_e, want + 1);

      // the adjoint, from the span's last step to its first
#pragma unroll
      for (int k = T / kChunk - 1; k >= 0; --k) {
        float p1[kChunk], p2[kChunk], pb[kChunk];
#pragma unroll
        for (int q4 = kChunk / 4 - 1; q4 >= 0; --q4) {
          const int tb = k * kChunk + q4 * 4;
          const float4 dt4 = ld4(r_dt + tb), dx4 = ld4(r_dtx + tb), dy4 = ld4(r_dy + tb);
          const float4 b4 = ld4(r_b + tb), c4 = ld4(r_c + tb);
          const float dtv[4] = {dt4.x, dt4.y, dt4.z, dt4.w};
          const float dxv[4] = {dx4.x, dx4.y, dx4.z, dx4.w};
          const float dyv[4] = {dy4.x, dy4.y, dy4.z, dy4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int u = 3; u >= 0; --u) {
            const int t = tb + u, e = q4 * 4 + u;
            g = fmaf(dyv[u], cv[u], g);
            p1[e] = g * bv[u];
            const float q = g * ah_r[t];
            p2[e] = av * q;
            da = fmaf(dtv[u], q, da);
            pb[e] = g * dxv[u];
            g = at_r[t] * g;
          }
        }
        // dx = dt sum_n g B, ddt = x sum_n g B + sum_n A g a h
        reduce_scatter<1, NP, kChunk>(p1, lane);
        reduce_scatter<1, NP, kChunk>(p2, lane);
        if (OverN::owner(nl)) {
#pragma unroll
          for (int e = 0; e < OverN::per; ++e) {
            const int tt = k * kChunk + OverN::step(nl, e);
            const float vx = r_dt[tt] * p1[e];
            const float vd = fmaf(s_x[c * TS + tt], p1[e], p2[e]);
            float* ox = s_out + tt * K + c;
            float* od = s_out + (T + tt) * K + c;
            *ox = pass == 0 ? vx : *ox + vx;
            *od = pass == 0 ? vd : *od + vd;
          }
        }
        reduce_scatter<NP, 32, kChunk>(pb, lane);
        if (OverD::owner(cw)) {
          float* w = s_w + (warp * T + k * kChunk) * NP + nl;
#pragma unroll
          for (int e = 0; e < OverD::per; ++e) w[OverD::step(cw, e) * NP] = pb[e];
        }
      }
      __syncthreads();

      // the block's dB, dC: its warps summed in order
      for (int i = tid; i < 2 * T * NP; i += NT) {
        const int arr = i / (T * NP), r = i % (T * NP);
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) s += s_w[(arr * NW + w) * T * NP + r];
        s_blk[i] = s;
      }
    } else {
      for (int i = tid; i < 2 * T * NP; i += NT) s_blk[i] = 0.f;
    }
    cluster_arrive();
    // dA, while the cluster gathers: the spans above summed first
    if (blk_live) {
      if (!a_ready) {
        wait_for(cnt_a, want);
        if (on) run = __ldcg(ra + dn);
      }
      if (on) __stcg(ra + dn, top ? da : run + da);
      publish(cnt_a, want + 1);
    }
    cluster_wait();

    // the cluster's dB, dC: each block sums a slice over the ranks in order
    constexpr int kSlice = 2 * T * NP / kCluster;
    for (int i = tid; i < kSlice; i += NT) {
      const int o = rank * kSlice + i;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) s += cluster.map_shared_rank(s_blk, q)[o];
      const int arr = o / (T * NP), r = o % (T * NP), tt = r / NP, nn = pass * NP + r % NP;
      if (tt < tn && nn < N)
        part[((static_cast<long long>(arr) * B + b) * ncd + cdg) * S * N +
             static_cast<long long>(t0 + tt) * N + nn] = s;
    }
    cluster_arrive();                       // no block leaves while another reads it
    if (pass == passes - 1 && blk_live) {
      for (int i = tid; i < T * K; i += NT) {
        const int tt = i / K, cc = i % K, dd = d0 + cc;
        if (tt < tn && dd < D) {
          const long long off = (row0 + t0 + tt) * D + dd;
          dxc[off] = s_out[tt * K + cc];
          ddt[off] = s_out[(T + tt) * K + cc];
        }
      }
    }
    cluster_wait();
  }
}

// dB, dC: the clusters' partials summed in order; dA: the rows' sums over b
__global__ void __launch_bounds__(kSumThreads)
ssm_scan_bwd_sum_kernel(const float* __restrict__ part, const float* __restrict__ ra,
                        float* __restrict__ dbm, float* __restrict__ dcm,
                        float* __restrict__ da, int B, int S, int D, int N, int ncd) {
  const long long sn = static_cast<long long>(S) * N;
  const long long bsn = B * sn, dn = static_cast<long long>(D) * N;
  const long long total = 2 * bsn + dn;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    if (i < 2 * bsn) {
      const long long arr = i / bsn, r = i % bsn, bb = r / sn, m = r % sn;
      const float* p = part + (arr * B + bb) * ncd * sn + m;
      for (int k = 0; k < ncd; ++k) s += p[k * sn];
      (arr == 0 ? dbm : dcm)[r] = s;
    } else {
      const long long m = i - 2 * bsn;
      for (int bb = 0; bb < B; ++bb) s += ra[bb * dn + m];
      da[m] = s;
    }
  }
}

int pass_states(int N) {                       // as the forward picks them
  int np = 1;
  while (np < N && np < kMaxPassB) np <<= 1;
  return np;
}

struct Grid {
  int nspan, ncd, passes;
};

Grid grid_of(int S, int D, int N) {
  const int np = pass_states(N);
  const int ndg = (D + block_channels(np) - 1) / block_channels(np);
  return {(S + kSpan - 1) / kSpan, (ndg + kCluster - 1) / kCluster, (N + np - 1) / np};
}

template <int NP>
cudaError_t launch_bwd(const float* xc, const float* dt, const float* bm, const float* cm,
                       const float* a, const float* ckpt, const float* dy, const float* dh_last,
                       float* dxc, float* ddt, float* dh0, float* part, float* ra,
                       unsigned* ctrl, int B, int S, int D, int N, cudaStream_t stream) {
  constexpr int bytes = Shape<NP>::floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(ssm_scan_bwd_kernel<NP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const Grid g = grid_of(S, D, N);
  const dim3 grid(static_cast<unsigned>(g.ncd * kCluster), static_cast<unsigned>(B * g.nspan));
  ssm_scan_bwd_kernel<NP><<<grid, Shape<NP>::NT, bytes, stream>>>(
      xc, dt, bm, cm, a, ckpt, dy, dh_last, dxc, ddt, dh0, part, ra, ctrl, B, S, D, N,
      g.nspan, g.ncd);
  return cudaGetLastError();
}

}  // namespace

// Scratch of a launch at (B, S, D, N): which 0, the floats of the dB, dC
// partials (2, B, clusters along d, S, N); 1, the 32-bit words of the
// ticket and the chains' counts, zeroed by the launch.  The dA chain's
// buffer is (B, D, N) floats.
extern "C" long long ssm_scan_bwd_scratch(int B, int S, int D, int N, int which) {
  if (B <= 0 || S <= 0 || D <= 0 || N <= 0) return 1;
  const Grid g = grid_of(S, D, N);
  if (which == 0) return 2LL * B * g.ncd * S * N;
  return 1 + 2LL * B * g.ncd * kCluster * g.passes;
}

// ckpt (B, ceil(S / 32), D, N) from ssm_scan_launch; dh_last may be null;
// part, ra (B, D, N) and ctrl are scratch of ssm_scan_bwd_scratch's sizes.
extern "C" int ssm_scan_bwd_launch(const void* xc, const void* dt, const void* bm,
                                   const void* cm, const void* a, const void* ckpt,
                                   const void* dy, const void* dh_last, void* dxc, void* ddt,
                                   void* dbm, void* dcm, void* da, void* dh0, void* part,
                                   void* ra, void* ctrl, int B, int S, int D, int N,
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
  auto* part_ = static_cast<float*>(part);
  auto* ra_ = static_cast<float*>(ra);
  auto* ctrl_ = static_cast<unsigned*>(ctrl);
  cudaError_t err = cudaMemsetAsync(
      ctrl_, 0, static_cast<size_t>(ssm_scan_bwd_scratch(B, S, D, N, 1)) * sizeof(unsigned), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  using Launch = cudaError_t (*)(const float*, const float*, const float*, const float*,
                                 const float*, const float*, const float*, const float*, float*,
                                 float*, float*, float*, float*, unsigned*, int, int, int, int,
                                 cudaStream_t);
  Launch run;
  switch (pass_states(N)) {
    case 1: run = launch_bwd<1>; break;
    case 2: run = launch_bwd<2>; break;
    case 4: run = launch_bwd<4>; break;
    case 8: run = launch_bwd<8>; break;
    case 16: run = launch_bwd<16>; break;
    default: run = launch_bwd<32>; break;
  }
  if ((err = run(xc_, dt_, bm_, cm_, a_, ck_, dy_, dhl_, dxc_, ddt_, dh0_, part_, ra_, ctrl_, B,
                 S, D, N, st)) != cudaSuccess)
    return static_cast<int>(err);
  const Grid g = grid_of(S, D, N);
  const long long total = 2LL * B * S * N + static_cast<long long>(D) * N;
  const long long want = (total + kSumThreads - 1) / kSumThreads;
  const unsigned grid = static_cast<unsigned>(want < 132 * 16 ? want : 132 * 16);
  ssm_scan_bwd_sum_kernel<<<grid, kSumThreads, 0, st>>>(part_, ra_, static_cast<float*>(dbm),
                                                        static_cast<float*>(dcm),
                                                        static_cast<float*>(da), B, S, D, N,
                                                        g.ncd);
  return static_cast<int>(cudaGetLastError());
}
