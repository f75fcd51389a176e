// K5a and the first stage of K6: the whole-ensemble E-step of the large-G
// routes, writing the three position-marginal streams instead of
// scattering into theta_hat.  Hand-written for Hopper (sm_90a).
//
// Replaces: trigenicinteractionpredictor_tpu/ops/pallas_em_bd.py,
//   _bd_estep (_em_tile_kernel_bd), and the first pallas_call of
//   trigenicinteractionpredictor_tpu/ops/pallas_em_large.py,
//   _pallas_stats_large (_em_tile_kernel_pregathered).  Both TPU kernels
//   compute the same contract: per row and restart the marginals
//   s_pos[b, (s,k)] = th_pos * A_pos * w/D (streams [3, B, S*K]), the p
//   cross-stats (p_hat = p * cross [S,K,K,K,R]) and loglik [S].  The TPU
//   kernels took XLA-gathered theta tiles and ran one-hot / block-diagonal
//   matmuls (the bd kernel computes all S^2 restart pairs of the cross
//   matmul and keeps the diagonal); here a block gathers its rows' theta
//   itself with plain loads and computes only its own restart's stats.
//   theta_hat comes from plan_scatter.cu, which segment-sums the streams
//   along the host plan (ops/em_large_g.py make_scatter_plan).
//
// Supported shapes: K1's (1 <= K <= 20 for R <= 3, as ops/em_bdr.py
// sweep_plan admits); any G; S <= 65535; any B >= 1.
//
// What bounds it on the H100: the E-step algebra is K1's (~3 K^3
// multiply-adds per row and restart, register-tiled over the tile's rows in
// rating order from shared memory: csrc/em_tile.cuh; 80 registers, 3
// blocks per SM, 70,304 bytes at K = 10, R = 2); instead of K1's
// 3 K scattered atomics into a G-sized theta_hat per row and restart it
// writes 3 K floats of stream (40 B runs at K = 10: 157 MB a sweep at
// B = 131,072, S = 10), which the scatter then reads back.
//
// Design: K1's (grid (row blocks, S); p[s] and the cross-stats staged in
// shared memory for the block's run of rows; the tile algebra of
// em_tile.cuh); the theta_hat atomics become stream stores, k fastest.

#include "em_tile.cuh"

namespace {

__global__ void __launch_bounds__(tip::kThreads, 3) em_streams_kernel(
    const float* __restrict__ theta,  // [S, G, K]
    const float* __restrict__ p,      // [S, K, K, K, R]
    const int* __restrict__ trip,     // [B, 3]
    const int* __restrict__ rat,      // [B]
    const float* __restrict__ w,      // [B]
    float* __restrict__ streams,      // [3, B, S*K]
    float* __restrict__ p_hat,        // [S, K, K, K, R], zeroed by the caller
    float* __restrict__ ll,           // [S], zeroed by the caller
    int B, int G, int K, int R, int tile, int rows_per_block) {
  const int s = blockIdx.y, S = gridDim.y;
  const int K3 = K * K * K, SK = S * K;
  const int tid = threadIdx.x, nt = blockDim.x;
  extern __shared__ float smem[];
  const tip::Tile t = tip::carve(smem, K, R, tile);

  tip::stage_p(t, p + (size_t)s * K3 * R);
  const float* th_s = theta + (size_t)s * G * K;
  float ll_acc = 0.f;
  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(B, row_begin + rows_per_block);
  __syncthreads();

  for (int row0 = row_begin; row0 < row_end; row0 += tile) {
    const int n = min(tile, row_end - row0);

    tip::load_rows(t, trip, rat, w, th_s, row0, n, G);
    ll_acc += tip::estep(t, n);

    // streams[pos, b, s*K + k]; inert rows write 0 (scale is 0).
    for (int i = tid; i < 3 * K * n; i += nt) {
      const int k = i % K, rest = i / K;
      const int row = rest % n, pos = rest / n;
      streams[((size_t)pos * B + row0 + row) * SK + s * K + k] =
          tip::marginal(t, pos, k, row);
    }
    tip::cross_acc(t, n);
  }
  tip::flush(t, p_hat + (size_t)s * K3 * R, ll_acc, ll + s);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller zeroes p_hat and ll and sizes smem_bytes from K1's host plan
// (ops/em_bdr.py sweep_plan).
extern "C" int tip_em_streams(const void* theta, const void* p, const void* trip,
                              const void* rat, const void* w, void* streams,
                              void* p_hat, void* ll, int S, int B, int G, int K,
                              int R, int tile, int rows_per_block, int threads,
                              int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        em_streams_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + rows_per_block - 1) / rows_per_block, S);
  em_streams_kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)p, (const int*)trip, (const int*)rat,
      (const float*)w, (float*)streams, (float*)p_hat, (float*)ll, B, G, K, R,
      tile, rows_per_block);
  return (int)cudaGetLastError();
}
