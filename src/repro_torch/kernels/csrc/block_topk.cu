// block_topk: (distance, id)-lexicographic top-k of each row of a masked
// (Q, C) panel.  Replaces the TPU kernel src/repro/kernels/block_topk.py
// (block_topk, select_topk).
//
// Bound on the H100: bytes.  The panel is read from device memory once
// (8 bytes a lane) and only (Q, k) pairs are written.  Design: one thread
// block per query row; each of k rounds is a strided scan of the row for the
// lex-min pair above the previous pick, then a block reduction with warp
// shuffles on the pair.  Rounds after the first re-read the row from L1/L2,
// not from device memory.  Rounds past the row's lanes emit (INF, -1), so
// k > C needs no fallback.  Selection is integer-exact: the result is
// bitwise the plain two-stable-sort top-k.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
block_topk_kernel(const float* __restrict__ d, const int* __restrict__ ids,
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

}  // namespace

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

extern "C" int block_topk_launch(const void* d, const void* ids, void* out_d, void* out_i,
                                 int Q, int C, int k, void* stream) {
  if (Q > 0 && k > 0) {
    block_topk_kernel<<<Q, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(d), static_cast<const int*>(ids),
        static_cast<float*>(out_d), static_cast<int*>(out_i), C, k);
  }
  return static_cast<int>(cudaGetLastError());
}
