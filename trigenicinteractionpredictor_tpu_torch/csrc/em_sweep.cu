// K1: the whole-ensemble EM sweep (E-step + M-accumulate) for the trigenic
// MMSBM, hand-written for Hopper (sm_90a).
//
// Replaces: trigenicinteractionpredictor_tpu/ops/pallas_em_bdr.py,
//   _em_tile_kernel_bdr (launched by _pallas_stats_bdr).  Same contract:
//   theta_hat [S,G,K], p_hat = p * cross [S,K,K,K,R] and loglik [S] of the
//   pre-update state, equal to the batched plain sweep of ops/em.py.  The
//   TPU kernel's one-hot gather/scatter matmuls and block-diagonal operands
//   served only the TPU's matrix unit and are not carried over; this kernel
//   reads each row's rating itself, so rows need no rating sort.
//
// Supported shapes: 1 <= K <= 20 for R <= 3 (the host plan in
// ops/em_bdr.py checks the shared-memory budget and refuses anything
// larger); any G (no cap: theta rows are read from global memory); any
// S <= 65535; any B >= 1.
//
// What bounds it on the H100: per row and restart the sweep does ~3 K^3
// multiply-adds (T, A3 and the p cross-stats) against K^3 R values of
// p[s], plus 3 K scattered atomic adds into theta_hat.  At K = 10 that is
// far below the card's float32 rate and its HBM bandwidth: theta (400 KB
// at G = 1000, S = 10) and p stay L2-resident, so the limits are shared-
// memory traffic of the K^3 loops and the L2 atomics of the theta_hat
// scatter.
//
// Design:
// - grid (row blocks, S): a block owns one restart s and a contiguous run
//   of rows, walked in tiles of `tile` rows;
// - p[s] is staged once in shared memory, laid out [r][m][(k,l)] so the
//   row-parallel loops read it as a broadcast;
// - per-row vectors live in shared memory as [component][row] with a row
//   stride of tile + 1, so row-parallel loops are conflict-free and the
//   cell-parallel cross-stat loop reads distinct banks;
// - T, A1, A2, A3, D and scale are computed with one thread per
//   (row, component); the p cross-stats with one thread per (r, k, l, m)
//   cell looping over the tile's rows (no shared-memory atomics), held in
//   shared memory for the block's whole run and flushed once per block as
//   p * cross with atomicAdd (this tile algebra is em_tile.cuh, which the
//   large-G kernels share);
// - theta_hat gets one atomicAdd per (row, position, k) with nonzero
//   weight; loglik is reduced per block, then one atomicAdd per block.
// Weight-0 rows are inert: their scale is 0 and they add nothing.

#include "em_tile.cuh"

namespace {

__global__ void em_sweep_kernel(
    const float* __restrict__ theta,  // [S, G, K]
    const float* __restrict__ p,      // [S, K, K, K, R]
    const int* __restrict__ trip,     // [B, 3]
    const int* __restrict__ rat,      // [B]
    const float* __restrict__ w,      // [B]
    float* __restrict__ theta_hat,    // [S, G, K], zeroed by the caller
    float* __restrict__ p_hat,        // [S, K, K, K, R], zeroed by the caller
    float* __restrict__ ll,           // [S], zeroed by the caller
    int B, int G, int K, int R, int tile, int rows_per_block) {
  const int s = blockIdx.y;
  const int K3 = K * K * K;
  const int tid = threadIdx.x, nt = blockDim.x;
  extern __shared__ float smem[];
  const tip::Tile t = tip::carve(smem, K, R, tile);
  const int RS = t.RS;

  tip::stage_p(t, p + (size_t)s * K3 * R);
  const float* th_s = theta + (size_t)s * G * K;
  float* thh_s = theta_hat + (size_t)s * G * K;
  float ll_acc = 0.f;
  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(B, row_begin + rows_per_block);
  __syncthreads();

  for (int row0 = row_begin; row0 < row_end; row0 += tile) {
    const int n = min(tile, row_end - row0);

    tip::load_rows(t, trip, rat, w, th_s, row0, n, G);
    ll_acc += tip::estep(t, n);

    // theta_hat[gene_pos] += th_pos * A_pos * scale
    for (int i = tid; i < 3 * K * n; i += nt) {
      const int row = i % n, j = i / n;
      if (t.wv[row] != 0.f) {
        const int k = j % K, pos = j / K;
        atomicAdd(&thh_s[(size_t)t.gene[pos * RS + row] * K + k],
                  tip::marginal(t, pos, k, row));
      }
    }
    tip::cross_acc(t, n);
  }
  tip::flush(t, p_hat + (size_t)s * K3 * R, ll_acc, ll + s);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).  The
// caller zeroes theta_hat, p_hat and ll and sizes smem_bytes from the
// host plan (ops/em_bdr.py sweep_plan).
extern "C" int tip_em_sweep(const void* theta, const void* p, const void* trip,
                            const void* rat, const void* w, void* theta_hat,
                            void* p_hat, void* ll, int S, int B, int G, int K,
                            int R, int tile, int rows_per_block, int threads,
                            int smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        em_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((B + rows_per_block - 1) / rows_per_block, S);
  em_sweep_kernel<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)p, (const int*)trip, (const int*)rat,
      (const float*)w, (float*)theta_hat, (float*)p_hat, (float*)ll, B, G, K,
      R, tile, rows_per_block);
  return (int)cudaGetLastError();
}
