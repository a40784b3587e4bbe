// fused_panel_topk: per-series MINDIST filter + exact squared L2 + (dist, id)
// top-k over one raw (C, n) block, for every query.  Replaces the TPU kernel
// src/repro/kernels/fused_refine.py (fused_panel_topk).
//
// Bound on the H100: bytes (the queries, the planar (w, C) bounds, the ids,
// each row that some query keeps alive read once, and the (Q, k) results)
// when the filter prunes hard; fp32 operations (2n per live (query, series)
// pair, outside the tensor cores) when it does not.
//
// Design: the TPU kernel's (Q, C) tiling, sized for 132 SMs.  Block
// (s, t) takes the kQT = 8 queries of tile t and the kCT = 64 lanes of
// slice s of C: at (100, 1024) that is 13 x 16 = 208 blocks.
//   1. Filter.  The slice's planar bounds and ids and the tile's PAA and
//      thresholds are copied to shared memory with cp.async, all in flight
//      at once (each bound is read once per block for the whole query
//      tile, coalesced along C); each (query, lane) pair's MINDIST and the
//      live test (lb < thr) & (id >= 0) become one warp ballot per query
//      and 32 lanes.  A query whose bound is -inf (inactive) keeps no lane.
//   2. Distances.  Only the rows that some query of the tile keeps are
//      staged, with the tile's queries, up to kChunk points at a time
//      (16-byte cp.async; 4-byte and zero-padded to whole float4s where
//      n % 4 != 0); a block with none skips the step.  A thread takes one
//      row and a quarter of its points and forms ||x||^2 and the dot
//      products with all 8 queries (fp32 FMAs, never TF32), so each row
//      is read from shared memory once and each query point is a
//      broadcast; the quarters' sums meet in shared memory, and
//      d = max(||q||^2 + ||x||^2 - 2 q.x, 0) for the live pairs, with
//      ||q||^2 from the staged query (warp w for query w).
//   3. Select.  Each live pair becomes one 64-bit order key (the bits of
//      d >= 0, then the id).  Warp w owns query w of the tile: a lane
//      ranks its two slots against all 64 in one pass of shared-memory
//      broadcasts, with no barrier, and the first kp = min(k, kCT) keys
//      go to a scratch list, with the slice's live count.
//   4. Merge, in the same launch.  Each block bumps its tile's counter in
//      a scratch buffer after a fence; the block that finishes a tile last
//      merges its slices' sorted lists (warp w for query w: each lane holds
//      the smallest head of its lists in registers, a round is two warp
//      reductions and only the winning lane moves on), writes the (Q, k)
//      pairs with (INF, -1) tails and n_live, and resets the counter to 0
//      for the next launch.
// Only (Q, k) pairs and (Q,) counts reach the outputs.  Sums run in
// another order than the plain version's matmul, so distances agree within
// a tolerance, not bitwise; n_live is an exact per-pair count.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = kWarps;               // queries per block: one warp each
constexpr int kCT = 64;                   // lanes of C per block
constexpr int kChunk = 256;               // points staged at a time
constexpr int kMaxSmem = 227 * 1024;

static_assert(kThreads == 4 * kCT && kQT == 8, "thread maps below assume this");

int chunk_for(int n) { return min((n + 3) & ~3, kChunk); }
int slices_for(int C) { return max(1, (C + kCT - 1) / kCT); }
int kp_for(int k) { return min(k, kCT); }

constexpr int kPartWords = 4 * (kQT + 1) * kCT;   // the quarters' partial sums
// phase 1's shared memory, in words: the query and row tiles (stride
// cs = chunk + 4), the (query, slot) order keys, the partial sums, the
// slice's bounds, the tile's PAA and the slice's ids
size_t phase1_words(int n, int w) {
  const int cs = chunk_for(n) + 4;
  return static_cast<size_t>(kQT + kCT) * cs + 2 * kQT * kCT + kPartWords
      + 2 * static_cast<size_t>(w) * kCT + static_cast<size_t>(kQT) * w + kCT;
}
// per-warp merge region, in words: the slices' lists (order keys), their
// heads and ends
__host__ __device__ inline size_t merge_words(int S, int kp) {
  return 2 * static_cast<size_t>(S) * kp + 2 * S;
}

__global__ void __launch_bounds__(kThreads)
fused_panel_topk_kernel(const float* __restrict__ q, const float* __restrict__ q_paa,
                        const float* __restrict__ block, const float* __restrict__ lo,
                        const float* __restrict__ hi, const int* __restrict__ ids,
                        const float* __restrict__ thr, float* __restrict__ out_d,
                        int* __restrict__ out_i, int* __restrict__ n_live,
                        unsigned long long* __restrict__ part_key,
                        int* __restrict__ part_n, unsigned* __restrict__ counters,
                        int Q, int C, int n, int w, int k, int kp, int chunk,
                        int merge_warps, int vec16, int bounds16, float scale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned s_live[kQT][kCT / 32];   // live bits per query, 32 lanes a word
  __shared__ float s_qq[kQT];
  __shared__ float s_thr[kQT];
  __shared__ int s_last;

  const int S = gridDim.x, s = blockIdx.x, tile = blockIdx.y;
  const int q0 = tile * kQT, j0 = s * kCT;
  const int nq = min(kQT, Q - q0), nc = min(kCT, C - j0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cs = chunk + 4;                   // smem row stride, a multiple of 4
  float* s_q = smem;                          // kQT x cs
  float* s_x = s_q + kQT * cs;                // kCT x cs: the kept rows
  // kQT x kCT (query, slot) order keys, ~0 where dead (aligned:
  // (kQT + kCT) * cs is a multiple of 4, so every region below is
  // 16-byte aligned)
  auto* s_key = reinterpret_cast<unsigned long long*>(s_x + kCT * cs);
  float* s_part = reinterpret_cast<float*>(s_key + kQT * kCT);   // 4 x (kQT + 1) x kCT
  float* s_lo = s_part + kPartWords;          // w x kCT
  float* s_hi = s_lo + w * kCT;               // w x kCT
  float* s_qp = s_hi + w * kCT;               // kQT x w
  int* s_ids = reinterpret_cast<int*>(s_qp + kQT * w);   // kCT

  // A. the slice's region bounds and ids and the tile's PAA and
  // thresholds, in flight together
  if (bounds16) {                             // C % 4 == 0, 16-byte aligned planes
    for (int e = threadIdx.x; e < w * (kCT / 4); e += kThreads) {
      const int r = e / (kCT / 4), jj = 4 * (e % (kCT / 4));
      if (jj < nc) {
        cp_async16(s_lo + r * kCT + jj, lo + static_cast<size_t>(r) * C + j0 + jj);
        cp_async16(s_hi + r * kCT + jj, hi + static_cast<size_t>(r) * C + j0 + jj);
      }
    }
  } else {
    for (int e = threadIdx.x; e < w * kCT; e += kThreads) {
      const int r = e / kCT, jj = e % kCT;
      if (jj < nc) {
        cp_async4(s_lo + e, lo + static_cast<size_t>(r) * C + j0 + jj);
        cp_async4(s_hi + e, hi + static_cast<size_t>(r) * C + j0 + jj);
      }
    }
  }
  for (int e = threadIdx.x; e < nq * w; e += kThreads)
    cp_async4(s_qp + e, q_paa + static_cast<size_t>(q0) * w + e);
  if (threadIdx.x < nc) cp_async4(s_ids + threadIdx.x, ids + j0 + threadIdx.x);
  if (threadIdx.x < nq) cp_async4(s_thr + threadIdx.x, thr + q0 + threadIdx.x);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 1. filter: thread -> lane jj of the slice, queries qg and qg + 4,
  // both bounds in one pass (two independent chains)
  {
    const int jj = threadIdx.x % kCT, qg = threadIdx.x / kCT;
    const bool lane_ok = jj < nc && s_ids[jj] >= 0;
    const float t0 = qg < nq ? s_thr[qg] : neg_inf();
    const float t1 = qg + 4 < nq ? s_thr[qg + 4] : neg_inf();
    const float* qp0 = s_qp + qg * w;
    const float* qp1 = s_qp + (qg + 4) * w;
    float acc0 = 0.f, acc1 = 0.f;
    if (lane_ok && (t0 > neg_inf() || t1 > neg_inf())) {
      for (int e = 0; e < w; ++e) {
        const float l = s_lo[e * kCT + jj], u = s_hi[e * kCT + jj];
        const float v0 = qp0[e], v1 = qp1[e];     // rows past nq: never used
        const float d0 = fmaxf(fmaxf(l - v0, v0 - u), 0.f);
        const float d1 = fmaxf(fmaxf(l - v1, v1 - u), 0.f);
        acc0 = __fadd_rn(acc0, __fmul_rn(d0, d0));
        acc1 = __fadd_rn(acc1, __fmul_rn(d1, d1));
      }
    }
    // an inactive query (t = -inf) and a dead lane keep nothing
    const bool live0 = lane_ok && t0 > neg_inf() && __fmul_rn(scale, acc0) < t0;
    const bool live1 = lane_ok && t1 > neg_inf() && __fmul_rn(scale, acc1) < t1;
    const unsigned bits0 = __ballot_sync(0xffffffffu, live0);
    const unsigned bits1 = __ballot_sync(0xffffffffu, live1);
    if (lane == 0) {
      s_live[qg][jj / 32] = bits0;
      s_live[qg + 4][jj / 32] = bits1;
    }
  }
  __syncthreads();

  // the slice's lanes that some query of the tile keeps: lane jj's row
  // goes to slot popc(any below jj), so the kept rows are compacted with
  // no further barrier
  unsigned long long any = 0;
#pragma unroll
  for (int qq = 0; qq < kQT; ++qq)
    any |= static_cast<unsigned long long>(s_live[qq][0])
        | (static_cast<unsigned long long>(s_live[qq][1]) << 32);
  const int nrows = __popcll(any);
  auto slot_of = [any](int jj) { return __popcll(any & ((1ull << jj) - 1ull)); };

  // 2. distances of the kept rows.  Thread -> slot (t % 64) and a quarter
  // of the points (t / 64, interleaved by float4): each row is read from
  // shared memory once, the queries as broadcasts, and a thread forms the
  // row's ||x||^2 and its dot products with all 8 queries of the tile.
  for (int e = threadIdx.x; e < kQT * kCT; e += kThreads) s_key[e] = ~0ull;
  if (nrows > 0) {
    const int slot = threadIdx.x % kCT, quarter = threadIdx.x / kCT;
    float xx = 0.f, dot[kQT];
#pragma unroll
    for (int qq = 0; qq < kQT; ++qq) dot[qq] = 0.f;
    float qsq = 0.f;                          // warp w: ||q||^2 of query w
    for (int p0 = 0; p0 < n; p0 += chunk) {
      const int len = min(chunk, n - p0), len4 = (len + 3) & ~3, nv = len4 / 4;
      if (vec16) {                            // n % 4 == 0, 16-byte aligned rows
        for (int r = warp; r < nq; r += kWarps)
          for (int v = lane; v < nv; v += 32)
            cp_async16(s_q + r * cs + 4 * v, q + static_cast<size_t>(q0 + r) * n + p0 + 4 * v);
        for (int jj = warp; jj < kCT; jj += kWarps) {
          if (!((any >> jj) & 1ull)) continue;
          float* dst = s_x + slot_of(jj) * cs;
          const float* src = block + static_cast<size_t>(j0 + jj) * n + p0;
          for (int v = lane; v < nv; v += 32) cp_async16(dst + 4 * v, src + 4 * v);
        }
      } else {                                // 4-byte copies, zero-padded to len4
        for (int r = warp; r < nq; r += kWarps)
          for (int p = lane; p < len4; p += 32) {
            if (p < len)
              cp_async4(s_q + r * cs + p, q + static_cast<size_t>(q0 + r) * n + p0 + p);
            else
              s_q[r * cs + p] = 0.f;
          }
        for (int jj = warp; jj < kCT; jj += kWarps) {
          if (!((any >> jj) & 1ull)) continue;
          float* dst = s_x + slot_of(jj) * cs;
          const float* src = block + static_cast<size_t>(j0 + jj) * n + p0;
          for (int p = lane; p < len4; p += 32) {
            if (p < len)
              cp_async4(dst + p, src + p);
            else
              dst[p] = 0.f;
          }
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (warp < nq) {
        const float* qr = s_q + warp * cs;
        for (int p = lane; p < len; p += 32) qsq = fmaf(qr[p], qr[p], qsq);
      }
      if (slot < nrows) {
        const float4* xr = reinterpret_cast<const float4*>(s_x + slot * cs);
        for (int v = quarter; v < nv; v += 4) {
          const float4 xv = xr[v];
          xx = fmaf(xv.x, xv.x, fmaf(xv.y, xv.y, fmaf(xv.z, xv.z, fmaf(xv.w, xv.w, xx))));
#pragma unroll
          for (int qq = 0; qq < kQT; ++qq) {    // rows past nq: never used
            const float4 qv = reinterpret_cast<const float4*>(s_q + qq * cs)[v];
            dot[qq] = fmaf(qv.x, xv.x, fmaf(qv.y, xv.y, fmaf(qv.z, xv.z,
                                                             fmaf(qv.w, xv.w, dot[qq]))));
          }
        }
      }
      if (p0 + chunk < n) __syncthreads();    // before the next chunk overwrites
    }
    qsq = warp_sum(qsq);
    if (lane == 0 && warp < nq) s_qq[warp] = qsq;
    // the quarters' partial sums meet in shared memory
    if (slot < nrows) {
#pragma unroll
      for (int qq = 0; qq < kQT; ++qq) s_part[(quarter * (kQT + 1) + qq) * kCT + slot] = dot[qq];
      s_part[(quarter * (kQT + 1) + kQT) * kCT + slot] = xx;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kQT * kCT; e += kThreads) {
      const int qq = e / kCT, jj = e % kCT;
      if (!((s_live[qq][jj / 32] >> (jj % 32)) & 1u)) continue;
      const int sl = slot_of(jj);
      auto sum4 = [&](int row) {
        const float* pp = s_part + row * kCT + sl;
        const int stride = (kQT + 1) * kCT;
        return (pp[0] + pp[stride]) + (pp[2 * stride] + pp[3 * stride]);
      };
      const float cr = sum4(qq), x2 = sum4(kQT);
      const float d = fmaxf(__fsub_rn(__fadd_rn(s_qq[qq], x2), __fmul_rn(2.f, cr)), 0.f);
      // order key: d >= 0, so its bits (sign cleared: -0 is 0) order as an
      // unsigned integer, then the id (>= 0 for a live lane)
      s_key[qq * kCT + sl] = (static_cast<unsigned long long>(__float_as_uint(d) & 0x7fffffffu)
                              << 32) | static_cast<unsigned>(s_ids[jj]);
    }
  }
  __syncthreads();

  // 3. warp w: query w's live pairs of the slice in (dist, id) order, the
  // first kp to the scratch list.  A lane ranks its two slots against all
  // slots in one pass (dead keys ~0 rank after every live one).
  if (warp < nq) {
    const size_t list = static_cast<size_t>(q0 + warp) * S + s;
    const unsigned long long* kq = s_key + warp * kCT;
    const unsigned long long k0 = kq[lane], k1 = kq[lane + 32];
    int r0 = 0, r1 = 0;
    for (int f = 0; f < nrows; ++f) {
      const unsigned long long kf = kq[f];
      r0 += kf < k0;
      r1 += kf < k1;
    }
    if (k0 != ~0ull && r0 < kp) part_key[list * kp + r0] = k0;
    if (k1 != ~0ull && r1 < kp) part_key[list * kp + r1] = k1;
    const int live = __popc(__ballot_sync(0xffffffffu, k0 != ~0ull))
        + __popc(__ballot_sync(0xffffffffu, k1 != ~0ull));
    if (lane == 0) {
      part_n[2 * list] = min(live, kp);
      part_n[2 * list + 1] = live;
    }
  }

  // 4. the block that finishes this query tile last merges its slices.
  // The barrier orders the block's list writes before thread 0's fence,
  // which (fences are cumulative) publishes them before the counter; the
  // last block's fence after the counter orders its reads after them.
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned done = atomicAdd(&counters[tile], 1u);
    s_last = done == static_cast<unsigned>(S - 1);
    if (s_last) {
      counters[tile] = 0u;                    // every slice has arrived
      __threadfence();
    }
  }
  __syncthreads();
  if (!s_last) return;

  const size_t per = merge_words(S, kp);      // words a merging warp holds
  for (int g = 0; g * merge_warps < kQT; ++g) {
    const int mw = warp - g * merge_warps;
    if (mw >= 0 && mw < merge_warps && warp < nq) {
      auto* m_key = reinterpret_cast<unsigned long long*>(smem + mw * per);   // S x kp
      int* m_head = reinterpret_cast<int*>(m_key + static_cast<size_t>(S) * kp);   // S
      int* m_end = m_head + S;                                                  // S
      const int qi = q0 + warp;
      const size_t list0 = static_cast<size_t>(qi) * S;
      // the counts and the lists in one pass (past a list's count the
      // copy is never read)
      int live = 0, total = 0;
      for (int ss = lane; ss < S; ss += 32) {
        const int cnt = __ldcg(part_n + 2 * (list0 + ss));
        live += __ldcg(part_n + 2 * (list0 + ss) + 1);
        total += cnt;
        m_head[ss] = ss * kp;
        m_end[ss] = ss * kp + cnt;
      }
#pragma unroll 4
      for (int e = lane; e < S * kp; e += 32) m_key[e] = __ldcg(part_key + list0 * kp + e);
      live = warp_sum(live);
      total = warp_sum(total);
      __syncwarp();
      // k rounds: each lane holds the smallest head of its lists (ss = lane
      // mod 32), a round takes the warp's minimum key in two reductions
      // (distance bits, then id), and only the winning lane moves on
      unsigned long long cur, nxt = ~0ull;
      int cur_list = -1;
      auto next_head = [&]() {                // lists ss = lane + 32 i
        cur = ~0ull;
        for (int ss = lane; ss < S; ss += 32) {
          const int h = m_head[ss];
          if (h < m_end[ss] && m_key[h] < cur) {
            cur = m_key[h];
            cur_list = ss;
          }
        }
      };
      // S <= 32: one list a lane, its head and the entry after it in registers
      const bool one_list = S <= 32;
      if (one_list) {
        cur_list = lane;
        cur = lane < S && m_end[lane] > lane * kp ? m_key[lane * kp] : ~0ull;
        nxt = lane < S && m_end[lane] > lane * kp + 1 ? m_key[lane * kp + 1] : ~0ull;
      } else {
        next_head();
      }
      float* od = out_d + static_cast<size_t>(qi) * k;
      int* oi = out_i + static_cast<size_t>(qi) * k;
      const int rounds = min(k, total);
      for (int r = 0; r < rounds; ++r) {
        const unsigned hd = static_cast<unsigned>(cur >> 32);
        const unsigned bd = __reduce_min_sync(0xffffffffu, hd);
        const unsigned bk = __reduce_min_sync(
            0xffffffffu, hd == bd ? static_cast<unsigned>(cur) : 0xffffffffu);
        if (lane == 0) {
          od[r] = __uint_as_float(bd);
          oi[r] = static_cast<int>(bk);
        }
        if (cur == ((static_cast<unsigned long long>(bd) << 32) | bk)) {   // one lane
          const int h = ++m_head[cur_list];
          if (one_list) {
            cur = nxt;
            nxt = h + 1 < m_end[cur_list] ? m_key[h + 1] : ~0ull;
          } else {
            next_head();
          }
        }
      }
      for (int r = rounds + lane; r < k; r += 32) {
        od[r] = REPRO_INF;
        oi[r] = -1;
      }
      if (lane == 0) n_live[qi] = live;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" long long fused_panel_topk_scratch_words(int Q, int C, int k) {
  // part_key (Q x S x kp order keys, 2 words each), then part_n (Q x S x 2)
  const long long qs = static_cast<long long>(Q) * slices_for(C);
  return qs * (2LL * kp_for(k) + 2);
}

extern "C" int fused_panel_topk_tiles(int Q) { return (Q + kQT - 1) / kQT; }

extern "C" int fused_panel_topk_launch(const void* q, const void* q_paa, const void* block,
                                       const void* lo, const void* hi, const void* ids,
                                       const void* thr, void* out_d, void* out_i,
                                       void* n_live, void* scratch, void* counters,
                                       int Q, int C, int n, int w, int k, float scale,
                                       void* stream) {
  if (Q <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  if (n < 1 || w < 1 || C < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int S = slices_for(C), kp = kp_for(k);
  const size_t per = 4 * merge_words(S, kp);
  const size_t budget = kMaxSmem - 1024;      // the static shared arrays
  const int merge_warps = static_cast<int>(std::min<size_t>(kQT, budget / per));
  if (merge_warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = std::max(4 * phase1_words(n, w), merge_warps * per);
  if (smem > budget) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_panel_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int vec16 = n % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0
      && reinterpret_cast<uintptr_t>(block) % 16 == 0;
  const int bounds16 = C % 4 == 0 && reinterpret_cast<uintptr_t>(lo) % 16 == 0
      && reinterpret_cast<uintptr_t>(hi) % 16 == 0;
  const long long qs = static_cast<long long>(Q) * S;
  auto* part_key = static_cast<unsigned long long*>(scratch);
  auto* part_n = reinterpret_cast<int*>(part_key + qs * kp);
  const dim3 grid(static_cast<unsigned>(S), static_cast<unsigned>((Q + kQT - 1) / kQT));
  fused_panel_topk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(q_paa),
      static_cast<const float*>(block), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<const int*>(ids),
      static_cast<const float*>(thr), static_cast<float*>(out_d),
      static_cast<int*>(out_i), static_cast<int*>(n_live), part_key, part_n,
      static_cast<unsigned*>(counters), Q, C, n, w, k, kp, chunk_for(n), merge_warps,
      vec16, bounds16, scale);
  return static_cast<int>(cudaGetLastError());
}
