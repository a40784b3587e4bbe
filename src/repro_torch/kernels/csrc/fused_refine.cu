// fused_panel_topk: per-series MINDIST filter + exact squared L2 + (dist, id)
// top-k over one raw (C, n) block, for every query.  Replaces the TPU kernel
// src/repro/kernels/fused_refine.py (fused_panel_topk).
//
// Bound on the H100: bytes of the live rows when few series survive the
// filter (each surviving row is read once, 4n bytes), fp32 operations
// (2n per live (query, series) pair, outside the tensor cores) when many
// do.  Design: one thread block per query.  The query and its PAA sit in
// shared memory; a query whose bound is -inf (inactive) writes (INF, -1)
// and n_live = 0 and returns at once.  The block walks C in chunks of 256
// lanes: a thread computes its lane's MINDIST from the planar (w, C) bounds
// (coalesced) and the live test (lb < thr) & (id >= 0), and a live lane
// appends itself to a shared list.  One warp per live lane then reads the
// row coalesced and forms ||x||^2 and q.x with fp32 FMAs (never TF32), and
// d = max(qq + xx - 2 q.x, 0).  Dead lanes cost no distance: the paper's
// "fewer real distance calculations".  The chunk's live pairs and the
// running top-k are re-selected together by k rounds of the lex-min
// extraction of common.cuh, so only (Q, k) pairs and (Q,) counts reach
// device memory.  Sums run in another order than the plain version's
// matmul, so distances agree within a tolerance, not bitwise.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
fused_panel_topk_kernel(const float* __restrict__ q, const float* __restrict__ q_paa,
                        const float* __restrict__ block, const float* __restrict__ lo,
                        const float* __restrict__ hi, const int* __restrict__ ids,
                        const float* __restrict__ thr, float* __restrict__ out_d,
                        int* __restrict__ out_i, int* __restrict__ n_live, int C, int n,
                        int w, int k, float scale) {
  extern __shared__ float smem[];
  float* s_q = smem;                          // n
  float* s_qp = s_q + n;                      // w
  float* c_d = s_qp + w;                      // k running + kThreads chunk
  int* c_k = reinterpret_cast<int*>(c_d + k + kThreads);
  float* n_d = reinterpret_cast<float*>(c_k + k + kThreads);   // k: next running
  int* n_k = reinterpret_cast<int*>(n_d + k);                  // k
  int* c_j = n_k + k;                                          // kThreads: live lanes
  __shared__ float r_d[kWarps + 1];
  __shared__ int r_k[kWarps + 1];
  __shared__ float r_f[kWarps + 1];
  __shared__ int r_i[kWarps + 1];
  __shared__ int s_cnt;

  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* od = out_d + static_cast<size_t>(qi) * k;
  int* oi = out_i + static_cast<size_t>(qi) * k;
  const float t = thr[qi];
  if (!(t > neg_inf())) {                     // inactive query: nothing is live
    for (int r = threadIdx.x; r < k; r += kThreads) {
      od[r] = REPRO_INF;
      oi[r] = -1;
    }
    if (threadIdx.x == 0) n_live[qi] = 0;
    return;
  }

  for (int i = threadIdx.x; i < n; i += kThreads) s_q[i] = q[static_cast<size_t>(qi) * n + i];
  for (int i = threadIdx.x; i < w; i += kThreads) s_qp[i] = q_paa[static_cast<size_t>(qi) * w + i];
  for (int r = threadIdx.x; r < k; r += kThreads) {
    c_d[r] = REPRO_INF;
    c_k[r] = PAD_ID_KEY;
  }
  __syncthreads();
  float part = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) part = fmaf(s_q[i], s_q[i], part);
  const float qq = block_sum<kThreads>(part, r_f);

  int my_live = 0;
  for (int c0 = 0; c0 < C; c0 += kThreads) {
    if (threadIdx.x == 0) s_cnt = 0;
    __syncthreads();
    const int j = c0 + threadIdx.x;
    if (j < C) {
      float acc = 0.f;
      for (int s = 0; s < w; ++s) {
        const float qv = s_qp[s];
        const float dv = fmaxf(fmaxf(lo[static_cast<size_t>(s) * C + j] - qv,
                                     qv - hi[static_cast<size_t>(s) * C + j]), 0.f);
        acc = __fadd_rn(acc, __fmul_rn(dv, dv));
      }
      if (__fmul_rn(scale, acc) < t && ids[j] >= 0) {
        ++my_live;
        c_j[atomicAdd(&s_cnt, 1)] = j;
      }
    }
    __syncthreads();
    const int m = s_cnt;
    __syncthreads();                          // every thread has read s_cnt
    if (m == 0) continue;

    for (int e = warp; e < m; e += kWarps) {
      const int jj = c_j[e];
      const float* xr = block + static_cast<size_t>(jj) * n;
      float xx = 0.f, cr = 0.f;
      for (int i = lane; i < n; i += 32) {
        const float xv = xr[i];
        xx = fmaf(xv, xv, xx);
        cr = fmaf(s_q[i], xv, cr);
      }
      xx = warp_sum(xx);
      cr = warp_sum(cr);
      if (lane == 0) {
        c_d[k + e] = fmaxf(__fsub_rn(__fadd_rn(qq, xx), __fmul_rn(2.f, cr)), 0.f);
        c_k[k + e] = ids[jj];
      }
    }
    __syncthreads();

    // re-select the running top-k together with this chunk's live pairs
    float pd = neg_inf();
    int pk = INT_MIN;
    for (int r = 0; r < k; ++r) {
      float bd;
      int bk;
      select_next<kThreads>(c_d, c_k, k + m, pd, pk, bd, bk, r_d, r_k);
      if (is_none(bd, bk)) {                  // uniform across the block
        for (int u = r + threadIdx.x; u < k; u += kThreads) {
          n_d[u] = REPRO_INF;
          n_k[u] = PAD_ID_KEY;
        }
        break;
      }
      if (threadIdx.x == 0) {
        n_d[r] = bd;
        n_k[r] = bk;
      }
      pd = bd;
      pk = bk;
    }
    __syncthreads();
    for (int r = threadIdx.x; r < k; r += kThreads) {
      c_d[r] = n_d[r];
      c_k[r] = n_k[r];
    }
    __syncthreads();
  }

  const int live = block_sum<kThreads>(my_live, r_i);
  for (int r = threadIdx.x; r < k; r += kThreads) {
    od[r] = c_d[r];
    oi[r] = c_k[r] == PAD_ID_KEY ? -1 : c_k[r];
  }
  if (threadIdx.x == 0) n_live[qi] = live;
}

}  // namespace

extern "C" int fused_panel_topk_launch(const void* q, const void* q_paa, const void* block,
                                       const void* lo, const void* hi, const void* ids,
                                       const void* thr, void* out_d, void* out_i,
                                       void* n_live, int Q, int C, int n, int w, int k,
                                       float scale, void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(n) + w)
      + (sizeof(float) + sizeof(int)) * (2 * static_cast<size_t>(k) + kThreads)
      + sizeof(int) * kThreads;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_panel_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (Q > 0 && k > 0) {
    fused_panel_topk_kernel<<<Q, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(q_paa),
        static_cast<const float*>(block), static_cast<const float*>(lo),
        static_cast<const float*>(hi), static_cast<const int*>(ids),
        static_cast<const float*>(thr), static_cast<float*>(out_d),
        static_cast<int*>(out_i), static_cast<int*>(n_live), C, n, w, k, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
