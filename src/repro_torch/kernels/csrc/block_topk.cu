// block_topk: (distance, id)-lexicographic top-k of each row of a masked
// (Q, C) panel.  Replaces the TPU kernel src/repro/kernels/block_topk.py
// (block_topk, select_topk).
//
// Bound on the H100: bytes.  The panel is read from device memory once
// (8 bytes a lane) and only (Q, k) pairs are written: 0.98 us at the flat
// and query-major walks' (100, 4096), 0.05 us at DTW's (10, 2048), where a
// launch and a few dependent memory round trips set the time.
//
// Design, k <= 32 and C <= 4,096 (every panel the walks hand it): one block
// per row, one pass, no selection rounds, one block barrier (two for k > 1).
//   * Keys.  Each lane becomes one 64-bit order key: the high word is the
//     distance's bits mapped to an unsigned order (-0.0 taken as +0.0,
//     negative values below positive ones), the low word is the id, any
//     id from 0 to INT32_MAX - 1 (INT32_MAX is the pad lanes' tie key).  Keys order as the plain two-stable-sort
//     top-k does (ties by id, -0.0 and +0.0 equal).  A pad lane (id < 0,
//     d == INF) becomes the empty key ~0, which sorts last; so every other
//     key of a row is distinct.  The keys only rank: the output is the
//     chosen lane's own distance bits (kept in registers at k = 1, read
//     back from the panel above) and its id.
//   * A thread holds M in {4, 8, 16} lanes' keys in registers, all loads in
//     flight at once, 16 bytes each where the row fills the block and is
//     aligned (M by C).
//   * Bound.  Each warp ranks its 32 lanes' minimum keys against each other
//     (31 independent shuffles a lane) and takes the k-th smallest as its
//     bound: the warp alone holds k keys at or below it.  The block's
//     bound t is the least of the warps' (k = 1: t is the row's minimum,
//     by two warp min-reductions, and the thread that holds it writes its
//     distance from registers).
//   * Select.  The keys at or below t (at least k, on random data about
//     k to 2k, at most 8 warps x k threads x M) go to shared memory with
//     their lanes through one shared atomic a thread; each is ranked by
//     counting the candidates below it, and the first k ranks are read
//     from the panel and written; empty slots (k > C) are (INF, -1).
// k > 32 or C > 4,096 runs the round kernel: one block per row, k rounds
// of a strided lex-min scan above the previous pick and a block reduction.
// No path of the engine sends it such a panel but the tests' and the
// smoke's k > 32 cases.  The launcher picks the kernel by k and C.  Both
// are integer-exact selections: bitwise the plain ref.block_topk_ref,
// under the panel contract (ids >= 0 distinct in a row, pad lanes at INF,
// no distance +inf or NaN).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 16;
constexpr int kStep = kThreads * kMaxPerThread;    // lanes a block takes: 4,096
constexpr int kMaxK = 32;
constexpr unsigned long long kEmpty = ~0ull;       // a pad lane
constexpr unsigned kFull = 0xffffffffu;

using u64 = unsigned long long;

__device__ __forceinline__ u64 order_key(float d, int id) {
  if (id < 0) return kEmpty;
  const unsigned u = __float_as_uint(d);
  // negative values negated (-0.0 lands on +0.0), the others above them
  const unsigned hi = static_cast<int>(u) < 0 ? 0u - u : (u | 0x80000000u);
  return (static_cast<u64>(hi) << 32) | static_cast<unsigned>(id);
}

template <int M>
__device__ __forceinline__ u64 tree_min(const u64 (&v)[M]) {
  static_assert(M >= 2 && (M & (M - 1)) == 0, "a power of two");
  u64 t[M / 2];
#pragma unroll
  for (int i = 0; i < M / 2; ++i) t[i] = min(v[i], v[i + M / 2]);
#pragma unroll
  for (int h = 1; (M >> h) > 1; ++h)      // constant bounds: t stays in registers
#pragma unroll
    for (int i = 0; i < (M >> (h + 1)); ++i) t[i] = min(t[i], t[i + (M >> (h + 1))]);
  return t[0];
}

__device__ __forceinline__ u64 warp_min(u64 m) {
  const unsigned hi = static_cast<unsigned>(m >> 32);
  const unsigned bh = __reduce_min_sync(kFull, hi);
  const unsigned bl = __reduce_min_sync(kFull, hi == bh ? static_cast<unsigned>(m) : kFull);
  return (static_cast<u64>(bh) << 32) | bl;
}

// The lane of the row that key i of thread tid came from.
template <int M>
__device__ __forceinline__ int lane_of(int tid, int i, bool vec4) {
  return vec4 ? 4 * tid + (i / 4) * 4 * kThreads + (i % 4) : tid + i * kThreads;
}

// One block per row; K1: k == 1.  vec4: the row is kThreads * M lanes, on
// 16-byte boundaries.
template <int M, bool K1>
__global__ void __launch_bounds__(kThreads)
block_topk_select_kernel(const float* __restrict__ d, const int* __restrict__ ids,
                         float* __restrict__ out_d, int* __restrict__ out_i, int C,
                         int k, int vec4) {
  __shared__ u64 s_cand[K1 ? 1 : kThreads * M];
  __shared__ unsigned short s_lane[K1 ? 1 : kThreads * M];
  __shared__ u64 s_tau[kWarps];
  __shared__ int s_count;
  const size_t row = blockIdx.x;
  const float* dr = d + row * C;
  const int* ir = ids + row * C;
  float* od = out_d + row * k;
  int* oi = out_i + row * k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  u64 v[M];
  float dv[M];                             // kept for k = 1's output
  if (vec4) {                              // a whole row: 16-byte loads
#pragma unroll
    for (int i = 0; i < M / 4; ++i) {
      const int j = 4 * tid + i * 4 * kThreads;
      const float4 dd = __ldg(reinterpret_cast<const float4*>(dr + j));
      const int4 ii = __ldg(reinterpret_cast<const int4*>(ir + j));
      dv[4 * i] = dd.x;
      dv[4 * i + 1] = dd.y;
      dv[4 * i + 2] = dd.z;
      dv[4 * i + 3] = dd.w;
      v[4 * i] = order_key(dd.x, ii.x);
      v[4 * i + 1] = order_key(dd.y, ii.y);
      v[4 * i + 2] = order_key(dd.z, ii.z);
      v[4 * i + 3] = order_key(dd.w, ii.w);
    }
  } else {
    int iv[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {          // every load in flight at once
      const int j = tid + i * kThreads;
      dv[i] = j < C ? __ldg(dr + j) : 0.f;
      iv[i] = j < C ? __ldg(ir + j) : -1;
    }
#pragma unroll
    for (int i = 0; i < M; ++i) v[i] = order_key(dv[i], iv[i]);
  }

  const u64 m = tree_min(v);
  u64 tau;
  if (K1) {
    tau = warp_min(m);
  } else {                                 // the warp's k-th smallest lane minimum
    int rank = 0;
#pragma unroll
    for (int off = 1; off < 32; ++off) {
      const u64 o = __shfl_xor_sync(kFull, m, off);
      rank += o < m || (o == m && (lane ^ off) < lane);   // copies: only kEmpty
    }
    const unsigned at = __ballot_sync(kFull, rank == k - 1);
    tau = __shfl_sync(kFull, m, __ffs(at) - 1);
  }
  if (lane == 0) s_tau[warp] = tau;
  if (tid == 0) s_count = 0;
  __syncthreads();
  u64 t = s_tau[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) t = min(t, s_tau[w]);

  if (K1) {                                // t is the row's minimum: one holder
    if (t == kEmpty) {
      if (tid == 0) {
        *od = REPRO_INF;
        *oi = -1;
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (v[i] == t) {                     // the lane's own bits, from registers
        *od = dv[i];
        *oi = static_cast<int>(static_cast<unsigned>(t));
      }
    return;
  }
  int c = 0;
#pragma unroll
  for (int i = 0; i < M; ++i) c += v[i] <= t && v[i] != kEmpty;
  if (c > 0) {
    int pos = atomicAdd(&s_count, c);
#pragma unroll
    for (int i = 0; i < M; ++i)
      if (v[i] <= t && v[i] != kEmpty) {
        s_cand[pos] = v[i];
        s_lane[pos++] = static_cast<unsigned short>(lane_of<M>(tid, i, vec4));
      }
  }
  __syncthreads();
  const int total = s_count;               // >= k unless the row has fewer keys
  for (int i = tid; i < total; i += kThreads) {
    const u64 key = s_cand[i];
    int rank = 0;
    for (int j = 0; j < total; ++j) rank += s_cand[j] < key;   // keys are distinct
    if (rank < k) {
      const int j = s_lane[i];
      od[rank] = dr[j];
      oi[rank] = ir[j];
    }
  }
  for (int r = total + tid; r < k; r += kThreads) {
    od[r] = REPRO_INF;
    oi[r] = -1;
  }
}

// k > 32 or C > 4,096: one block per row, k rounds of "lex-min above the
// last pick"
__global__ void __launch_bounds__(kThreads)
block_topk_round_kernel(const float* __restrict__ d, const int* __restrict__ ids,
                        float* __restrict__ out_d, int* __restrict__ out_i, int C, int k) {
  __shared__ float s_d[kThreads / 32 + 1];
  __shared__ int s_k[kThreads / 32 + 1];
  const size_t row = blockIdx.x;
  const float* dr = d + row * C;
  const int* ir = ids + row * C;
  float* od = out_d + row * k;
  int* oi = out_i + row * k;

  float pd = neg_inf();
  int pk = INT_MIN;
  for (int r = 0; r < k; ++r) {
    float bd = pos_inf();
    int bk = INT_MAX;
    for (int j = threadIdx.x; j < C; j += kThreads) {
      const float dj = dr[j];
      const int idj = ir[j];
      const int kj = idj >= 0 ? idj : PAD_ID_KEY;
      if (lex_less(pd, pk, dj, kj) && lex_less(dj, kj, bd, bk)) { bd = dj; bk = kj; }
    }
    block_lex_min<kThreads>(bd, bk, s_d, s_k);
    if (is_none(bd, bk)) {                 // uniform across the block
      for (int t = r + threadIdx.x; t < k; t += kThreads) {
        od[t] = REPRO_INF;
        oi[t] = -1;
      }
      return;
    }
    if (threadIdx.x == 0) {
      od[r] = bd;
      oi[r] = bk == PAD_ID_KEY ? -1 : bk;
    }
    pd = bd;
    pk = bk;
  }
}

template <int M>
void launch_select(int Q, cudaStream_t st, const float* d, const int* ids, float* od,
                   int* oi, int C, int k, int vec4) {
  if (k == 1) {
    block_topk_select_kernel<M, true><<<Q, kThreads, 0, st>>>(d, ids, od, oi, C, k, vec4);
  } else {
    block_topk_select_kernel<M, false><<<Q, kThreads, 0, st>>>(d, ids, od, oi, C, k, vec4);
  }
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

extern "C" int block_topk_launch(const void* d, const void* ids, void* out_d, void* out_i,
                                 int Q, int C, int k, void* stream) {
  if (Q <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  if (C < 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* dp = static_cast<const float*>(d);
  const auto* ip = static_cast<const int*>(ids);
  auto* odp = static_cast<float*>(out_d);
  auto* oip = static_cast<int*>(out_i);
  if (k > kMaxK || C > kStep) {
    block_topk_round_kernel<<<Q, kThreads, 0, st>>>(dp, ip, odp, oip, C, k);
    return static_cast<int>(cudaGetLastError());
  }
  const int M = C <= 4 * kThreads ? 4 : (C <= 8 * kThreads ? 8 : kMaxPerThread);
  // 16-byte loads: a row of exactly kThreads * M lanes, aligned panels
  const int vec4 = C == kThreads * M && reinterpret_cast<uintptr_t>(d) % 16 == 0
      && reinterpret_cast<uintptr_t>(ids) % 16 == 0;
  if (M == 4) {
    launch_select<4>(Q, st, dp, ip, odp, oip, C, k, vec4);
  } else if (M == 8) {
    launch_select<8>(Q, st, dp, ip, odp, oip, C, k, vec4);
  } else {
    launch_select<kMaxPerThread>(Q, st, dp, ip, odp, oip, C, k, vec4);
  }
  return static_cast<int>(cudaGetLastError());
}
